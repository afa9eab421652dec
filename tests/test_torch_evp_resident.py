"""The tile plan and the schedule of the SM-resident EVP kernel
(``cice5_tpu_torch/csrc/evp_resident.cu``), on the CPU.

The kernel cuts the U points into tiles (``ops/evp_resident.py:tile_plan``),
computes on each tile the stress of its region points and of the one-point
ring north and east of them, runs stepu on the tile's own U points, and
exchanges (u, v) through two global planes between subcycles, reading a
tile's window back through the ghost and fold index arithmetic.
``tiled_sweep`` below runs that schedule tile by tile in plain PyTorch,
with the window gathered by the same index arithmetic as the kernel's
``ghost_ref``/``ghost_value``; it must equal ``evp.subcycle_sweep`` bit for
bit, and the
JAX package's Pallas ``sweep_resident`` (interpret mode) to the port's
EVP tolerance. The kernel itself is held against the plain sweep on the
card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu import ModelConfig as JModelConfig
from cice5_tpu.config import GridConfig as JGridConfig
from cice5_tpu.grid import rectgrid as jrectgrid
from cice5_tpu.models.dynamics import evp as jevp
from cice5_tpu.models.dynamics import shared as jdyn
from cice5_tpu.models.dynamics.strength import strength_hibler as jhibler
from cice5_tpu.ops.pallas.evp_resident import sweep_resident
from cice5_tpu.parallel import Topology as JTopology
from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.config import rect_config
from cice5_tpu_torch.grid import rectgrid
from cice5_tpu_torch.models.dynamics import evp as tevp
from cice5_tpu_torch.models.dynamics import shared as tdyn
from cice5_tpu_torch.models.dynamics.strength import strength_hibler
from cice5_tpu_torch.ops import kernels
from cice5_tpu_torch.ops.evp_resident import (BRANCHES, PLANE, smem_bytes,
                                              tile_plan)
from cice5_tpu_torch.parallel import Topology
from torch_port_util import assert_close

H100 = dict(n_sm=132, smem_optin=232448)
U_PLANES = ("aiu", "uocn", "vocn", "waterx", "watery", "forcex", "forcey",
            "umassdti", "fm", "uarear", "uvel_init", "vvel_init")


def _owned(plan, t):
    """The region rows and columns tile ``t`` owns: its U rows and
    columns, plus row ny / column nx on the top row / right column."""
    j0, j1, i0, i1 = plan.tile(t)
    return (range(j0, j1 + (j1 == plan.ny)), range(i0, i1 + (i1 == plan.nx)))


@pytest.mark.parametrize("ny,nx,dtype,n_sm,branch", [
    (384, 320, torch.float32, 132, None),
    (384, 320, torch.float64, 132, None),
    (384, 320, torch.float32, 44, "device"),
    (1080, 1440, torch.float32, 132, None),
    (37, 53, torch.float64, 132, None),
    (37, 53, torch.float32, 6, None),
    (37, 53, torch.float64, 5, "device"),
    (2, 3, torch.float64, 132, None)])
def test_tile_plan_owns_every_point_once(ny, nx, dtype, n_sm, branch):
    plan = tile_plan(ny, nx, dtype, n_sm, H100["smem_optin"], branch)
    u_own = np.zeros((ny, nx), int)
    r_own = np.zeros((ny + 1, nx + 1), int)
    assert (plan.tym + 1) * (plan.txm + 1) <= PLANE
    for t in range(plan.ntiles):
        j0, j1, i0, i1 = plan.tile(t)
        assert 1 <= j1 - j0 <= plan.tym and 1 <= i1 - i0 <= plan.txm
        u_own[j0:j1, i0:i1] += 1
        rows, cols = _owned(plan, t)
        r_own[rows.start:rows.stop, cols.start:cols.stop] += 1
        # the computed ring north and east is the region's row ny /
        # column nx exactly on the top / right tiles
        assert (j1 == ny) == (rows.stop == ny + 1)
        assert (i1 == nx) == (cols.stop == nx + 1)
    assert (u_own == 1).all() and (r_own == 1).all()
    assert plan.blocks <= min(n_sm, plan.ntiles)
    assert plan.smem == smem_bytes(plan.branch, plan.tym, plan.txm,
                                   plan.itemsize) <= H100["smem_optin"]
    assert plan.branch in BRANCHES and (branch is None
                                        or plan.branch == branch)
    if plan.branch != "device":
        assert plan.blocks == plan.ntiles


def test_tile_plan_branches_at_the_main_path_and_beyond():
    """At 384x320 on 132 SMs float32 keeps every plane in shared memory and
    float64 the state, one tile per SM; the 0.25-degree 1080x1440 grid
    needs the device branch, its blocks walking several tiles."""
    f32 = tile_plan(384, 320, torch.float32, **H100)
    f64 = tile_plan(384, 320, torch.float64, **H100)
    assert (f32.branch, f64.branch) == ("shared+ro", "shared")
    assert f32.ntiles == f64.ntiles == 132 == f32.blocks
    q = tile_plan(1080, 1440, torch.float32, **H100)
    assert q.branch == "device" and q.blocks == 132 < q.ntiles
    assert q.scratch_values() == 4 * 1080 * 1440 + q.ntiles * 12 * PLANE
    assert f32.scratch_values() == 4 * 384 * 320
    assert f32.barriers(120, in_place=True) == 120
    assert f32.barriers(10, in_place=False) == 9
    with pytest.raises(ValueError, match="does not fit"):
        tile_plan(1080, 1440, torch.float32, branch="shared", **H100)


def test_kernel_plan_must_fit_the_grid():
    """A caller's plan for another grid or type is refused before any
    launch; both EVP kernels come from one source."""
    plan = tile_plan(16, 32, torch.float64, **H100)
    dev = torch.device("cpu")
    assert kernels.evp_plan(16, 32, torch.float64, dev, plan) is plan
    for args in ((16, 33, torch.float64), (16, 32, torch.float32)):
        with pytest.raises(ValueError, match="tile plan"):
            kernels.evp_plan(*args, dev, plan)
    assert kernels.KERNELS["evp_sweep"].library == \
        kernels.KERNELS["evp_fused"].library
    assert kernels.KERNELS["evp_sweep"].source.name == "evp_resident.cu"


def _window_maps(j0, j1, i0, i1, ny, nx, cyc_x, cyc_y, fold):
    """The kernel's ghost_ref for the window of rows j0-1..j1 and columns
    i0-1..i1, point by point: (kind, a, b) with kind 0 zero, 1 f[a], 2
    -f[a] (the fold ghost row), 3 0.5*(f[a] + -f[b]) (the U-fold's
    symmetrized top row; ghost_value), a and b flat indices of (ny, nx).
    fold: 0 none, 1 the U-fold, 2 the T-fold (``evp.fold_mode``)."""
    kind, ia, ib = [], [], []
    for j in range(j0 - 1, j1 + 1):
        for i in range(i0 - 1, i1 + 1):
            k, a, b = 0, 0, 0
            if fold and j == ny:
                ii = i + nx if i < 0 else (i - nx if i >= nx else i)
                src = (nx - 2 if fold == 1 else nx - 1) - ii
                k, a = 2, (ny - 2) * nx + src % nx
            else:
                ok, jj, ii = True, j % ny, i % nx
                if i < 0 or i >= nx:
                    ok = cyc_x
                if ok and (j < 0 or j >= ny):
                    ok = cyc_y
                if ok and fold == 1 and jj == ny - 1:
                    k, a, b = 3, jj * nx + ii, jj * nx + (nx - 2 - ii) % nx
                elif ok:
                    k, a = 1, jj * nx + ii
            kind.append(k)
            ia.append(a)
            ib.append(b)
    shape = (j1 - j0 + 2, i1 - i0 + 2)
    return tuple(torch.tensor(x).reshape(shape) for x in (kind, ia, ib))


def _gather(f, maps):
    kind, a, b = maps
    x, y = f.reshape(-1)[a], f.reshape(-1)[b]
    return torch.where(kind == 1, x, torch.where(
        kind == 2, -x, torch.where(kind == 3, 0.5 * (x + -y),
                                   torch.zeros((), dtype=f.dtype))))


def tiled_sweep(p, ndte, topo, plan, *, uvel, vvel, stressR, maskR,
                strengthR, gR, icem_u, Cw, **planes):
    """``evp.subcycle_sweep`` on the kernel's schedule: every tile keeps its
    own stress state on its region points and ring, gathers its (u, v)
    window from the previous subcycle's planes, and writes stepu of its U
    points into the next ones; the diagnostics and the stress come from
    the owners."""
    ny, nx = uvel.shape
    flags = (topo.ew == "cyclic", topo.ns == "cyclic", tevp.fold_mode(topo))
    cw_plane = torch.is_tensor(Cw) and Cw.dim() > 0
    tiles = [plan.tile(t) for t in range(plan.ntiles)]
    maps = [_window_maps(*tl, ny, nx, *flags) for tl in tiles]
    st = [stressR[:, j0:j1 + 1, i0:i1 + 1] for j0, j1, i0, i1 in tiles]
    src = (uvel, vvel)
    stress = torch.empty_like(stressR)
    diag = torch.empty((5, ny + 1, nx + 1), dtype=uvel.dtype)
    strint = torch.empty((2, ny, nx), dtype=uvel.dtype)
    for it in range(ndte):
        dst = (torch.empty_like(uvel), torch.empty_like(vvel))
        for t, (j0, j1, i0, i1) in enumerate(tiles):
            R = (slice(j0, j1 + 1), slice(i0, i1 + 1))
            U = (slice(j0, j1), slice(i0, i1))
            r = tevp.stress_kernel(
                p, _gather(src[0], maps[t]), _gather(src[1], maps[t]), st[t],
                maskR=maskR[R], strengthR=strengthR[R],
                gR={k: g[R] for k, g in gR.items()})
            st[t] = r.stress
            s = tdyn.stepu(p, icemask=icem_u[U], strE=r.str8,
                           uvel=src[0][U], vvel=src[1][U],
                           Cw=Cw[U] if cw_plane else Cw,
                           **{k: planes[k][U] for k in U_PLANES})
            dst[0][U], dst[1][U] = s.uvel, s.vvel
            if it == ndte - 1:
                rows, cols = _owned(plan, t)
                O = (slice(rows.start, rows.stop),
                     slice(cols.start, cols.stop))
                own = (slice(None), slice(0, len(rows)), slice(0, len(cols)))
                diag[(slice(None),) + O] = torch.stack(
                    [r.divu, r.shear, r.rdg_conv, r.rdg_shear,
                     r.prs_sig])[own]
                stress[(slice(None),) + O] = r.stress[own]
                strint[(slice(None),) + U] = torch.stack([s.strintx,
                                                          s.strinty])
        src = dst
    return src[0], src[1], stress, (diag[0], diag[1], diag[2], diag[3],
                                    diag[4], strint[0], strint[1])


def _sweep_inputs(ny, nx, ew, ns, dtype, seed=11, cw_plane=False):
    """The sweep inputs of ``evp.evp_prep`` on a rectangular grid with
    scattered land and open water, from a numpy seed."""
    cfg = rect_config(ny, nx, dtype=dtype)
    cfg = cfg.replace(grid=dataclasses.replace(
        cfg.grid, ew_boundary=ew, ns_boundary=ns, dx_const=20000.0,
        dy_const=20000.0))
    rng = np.random.RandomState(seed)
    land = np.ones((ny, nx))
    land[0] = 0.0
    land[1:ny - 2][rng.uniform(size=(ny - 3, nx)) < 0.05] = 0.0
    grid = rectgrid(cfg, land, device="cpu")
    tdt = cfg.xp_dtype
    t = lambda a: torch.as_tensor(a, dtype=tdt)
    aice = np.where(rng.uniform(size=(ny, nx)) < 0.1, 0.0,
                    rng.uniform(0.3, 1.0, (ny, nx))) * land
    f = dict(aice=t(aice), vice=t(aice * 1.5), vsno=t(aice * 0.1),
             strairxT=t(np.full((ny, nx), 0.12) * land),
             strairyT=t(np.full((ny, nx), -0.05) * land),
             uocn=t(np.full((ny, nx), 0.02)), vocn=t(np.zeros((ny, nx))),
             uvel=t(rng.uniform(-0.1, 0.1, (ny, nx))),
             vvel=t(rng.uniform(-0.1, 0.1, (ny, nx))),
             stressp=t(rng.uniform(-500, 500, (4, ny, nx))),
             stressm=t(rng.uniform(-500, 500, (4, ny, nx))),
             stress12=t(rng.uniform(-500, 500, (4, ny, nx))),
             iceumask=t((rng.uniform(size=(ny, nx)) > 0.5).astype(float)))
    f["strength"] = strength_hibler(f["aice"], f["vice"])
    if cw_plane:
        f["Cw"] = t(rng.uniform(0.004, 0.006, (ny, nx)))
    topo = Topology(ew=ew, ns=ns)
    p = tdyn.EVPParams.classic(3600.0, ndte=3)
    sweep, _ = tevp.evp_prep(3600.0, p, grid, topo, **f)
    return p, topo, sweep


def _flat(out):
    return list(out[:3]) + list(out[3])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ew,ns,n_sm,branch,cw_plane", [
    ("cyclic", "open", 6, None, False),
    ("open", "open", 6, "device", True),
    ("cyclic", "cyclic", 5, None, False),
    ("closed", "closed", 7, "device", False),
    ("cyclic", "tripole", 6, None, True),
    ("cyclic", "tripole", 9, "device", False),
    ("cyclic", "tripoleT", 6, None, True),
    ("cyclic", "tripoleT", 9, "device", False)])
def test_tiled_schedule_equals_subcycle_sweep(dtype, ew, ns, n_sm, branch,
                                              cw_plane):
    """Bit for bit on a 37x53 grid cut into ragged tiles (a few blocks'
    worth, or the device branch's 2x2 tiles of at most 30x32), ndte=3;
    the U-fold and the T-fold seams included."""
    p, topo, kw = _sweep_inputs(37, 53, ew, ns, dtype, cw_plane=cw_plane)
    tdtype = kw["uvel"].dtype
    plan = tile_plan(37, 53, tdtype, n_sm, H100["smem_optin"], branch)
    assert plan.ntiles > 1 and (37 % plan.ntj or 53 % plan.nti)
    ref = tevp.subcycle_sweep(p, 3, topo, **kw)
    got = tiled_sweep(p, 3, topo, plan, **kw)
    for name, a, b in zip(("u", "v", "stress", "divu", "shear", "rdg_conv",
                           "rdg_shear", "prs_sig", "strintx", "strinty"),
                          _flat(ref), _flat(got)):
        assert torch.equal(a, b), name
    assert float(ref[0].abs().max()) > 0.0


def _jax_tripole_capture(ndte):
    """The 16x32 tripole sweep inputs of tests/test_evp_resident.py, captured
    from a JAX ``evp`` run, and JAX ``sweep_resident`` on them in interpret
    mode."""
    ny, nx = 16, 32
    cfg = JModelConfig(grid=JGridConfig(nx=nx, ny=ny, dx_const=20000.0,
                                        dy_const=20000.0), dtype="float64")
    g = jrectgrid(cfg)
    topo = JTopology(ew="cyclic", ns="tripole")
    rng = np.random.RandomState(7)
    aice = np.where(np.asarray(g.tmask), rng.uniform(0.3, 1.0, (ny, nx)),
                    0.0)
    z = np.zeros((ny, nx))
    f = dict(aice=aice, vice=aice * 1.5, vsno=aice * 0.1,
             strength=np.asarray(jhibler(jnp.asarray(aice),
                                         jnp.asarray(aice * 1.5))),
             strairxT=np.where(np.asarray(g.tmask), 0.12, 0.0),
             strairyT=np.where(np.asarray(g.tmask), -0.05, 0.0),
             uocn=z + 0.02, vocn=z,
             uvel=rng.uniform(-0.1, 0.1, (ny, nx)),
             vvel=rng.uniform(-0.1, 0.1, (ny, nx)),
             stressp=np.zeros((4, ny, nx)), stressm=np.zeros((4, ny, nx)),
             stress12=np.zeros((4, ny, nx)), iceumask=z)
    p = jdyn.EVPParams.classic(3600.0, ndte=ndte)
    captured = {}
    orig = jevp.subcycle_sweep

    def capture(pp, nd, tp, **kw):
        captured["kw"] = kw
        return orig(pp, nd, tp, **kw)

    jevp.subcycle_sweep = capture
    try:
        jevp.evp(3600.0, p, g, topo, **{k: jnp.asarray(v)
                                         for k, v in f.items()})
    finally:
        jevp.subcycle_sweep = orig
    kw = captured["kw"]
    ref = sweep_resident(p, ndte, topo, **kw, interpret=True)
    return p, kw, ref


def test_tiled_schedule_matches_jax_sweep_resident():
    """The kernel's schedule against the Pallas kernel it replaces, in
    interpret mode, on the tripole inputs of tests/test_evp_resident.py,
    and bit for bit against the port's plain sweep on the same inputs.
    Those inputs start from zero stress, where c0 = strength / max(Delta,
    tinyarea) turns the two backends' last-bit differences into stress
    (ROADMAP section C): 3e-11 of u's scale after 4 subcycles, held to
    1e-9 (from a random stress the port's sweep agrees with JAX to 1e-11,
    tests/test_torch_evp.py)."""
    ndte = 4
    p, kw, ref = _jax_tripole_capture(ndte)
    tkw = {k: ({kk: torch.as_tensor(np.array(vv)) for kk, vv in v.items()}
               if isinstance(v, dict) else
               v if isinstance(v, float) else torch.as_tensor(np.array(v)))
           for k, v in kw.items()}
    tp = tdyn.EVPParams(**dataclasses.asdict(p))
    plan = tile_plan(16, 32, torch.float64, 6, H100["smem_optin"])
    assert plan.ntiles > 1
    topo = Topology(ew="cyclic", ns="tripole")
    got = tiled_sweep(tp, ndte, topo, plan, **tkw)
    plain = tevp.subcycle_sweep(tp, ndte, topo, **tkw)
    for name, a, b, c in zip(("u", "v", "stress", "divu", "shear",
                              "rdg_conv", "rdg_shear", "prs_sig", "strintx",
                              "strinty"),
                             _flat(ref), _flat(got), _flat(plain)):
        assert torch.equal(b, c), name
        assert_close(a, b, 1e-9, name, floor=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tiled_schedule_device_branch_with_fold_and_cw_plane(dtype):
    """The plan the 0.25-degree coupled path takes (the device branch,
    more tiles than blocks, so each block walks several tiles per
    subcycle), on a 64x70 tripole grid whose fold crosses three tile
    columns, with the form-drag Cw plane: bit for bit against
    ``subcycle_sweep``, and the plane changes the result."""
    ny, nx = 64, 70
    p, topo, kw = _sweep_inputs(ny, nx, "cyclic", "tripole", dtype,
                                cw_plane=True)
    plan = tile_plan(ny, nx, kw["uvel"].dtype, 2, H100["smem_optin"],
                     "device")
    assert (plan.branch, plan.ntj, plan.nti, plan.blocks) == ("device", 3,
                                                              3, 2)
    ref = tevp.subcycle_sweep(p, 3, topo, **kw)
    got = tiled_sweep(p, 3, topo, plan, **kw)
    for name, a, b in zip(("u", "v", "stress", "divu", "shear", "rdg_conv",
                           "rdg_shear", "prs_sig", "strintx", "strinty"),
                          _flat(ref), _flat(got)):
        assert torch.equal(a, b), name
    const = tevp.subcycle_sweep(p, 3, topo, **dict(kw, Cw=ct.dragio))
    assert not torch.equal(const[0], ref[0])
    # the seam rows move
    assert float(ref[0][-2:].abs().max()) > 0.0


def test_tiled_schedule_matches_jax_sweep_resident_on_the_tfold():
    """The T-fold seam: the kernel's schedule against the Pallas kernel it
    replaces (interpret mode, on a T-fold topology) on the port's sweep
    inputs of a 16x32 T-fold grid with a random stress, and bit for bit
    against the port's plain sweep; the T-fold ghost row differs from the
    U-fold's."""
    ndte = 3
    p, topo, kw = _sweep_inputs(16, 32, "cyclic", "tripoleT", "float64",
                                seed=5)
    jkw = {k: ({kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
               if isinstance(v, dict) else
               v if isinstance(v, float) else jnp.asarray(v.numpy()))
           for k, v in kw.items()}
    jp = jdyn.EVPParams(**dataclasses.asdict(p))
    ref = sweep_resident(jp, ndte, JTopology(ew="cyclic", ns="tripoleT"),
                         **jkw, interpret=True)
    plan = tile_plan(16, 32, torch.float64, 6, H100["smem_optin"])
    got = tiled_sweep(p, ndte, topo, plan, **kw)
    plain = tevp.subcycle_sweep(p, ndte, topo, **kw)
    for name, a, b, c in zip(("u", "v", "stress", "divu", "shear",
                              "rdg_conv", "rdg_shear", "prs_sig", "strintx",
                              "strinty"),
                             _flat(ref), _flat(got), _flat(plain)):
        assert torch.equal(b, c), name
        assert_close(a, b, 1e-11, name, floor=1e-12)
    ufold = tevp.subcycle_sweep(p, ndte, Topology(ew="cyclic", ns="tripole"),
                                **kw)
    assert not torch.equal(ufold[0][-2:], plain[0][-2:])
    assert float(plain[0][-2:].abs().max()) > 0.0


def _revised():
    """The revised EVP's parameters (Bouillon et al. 2013) for the sweep
    inputs of ``_sweep_inputs``: dt 3600 s, ndte=3, xmin the grid's 20 km
    spacing."""
    p = tdyn.EVPParams.revised(3600.0, 3, 20000.0)
    assert p.revp == 1.0 and p.brlx > 100.0 * 3
    return p


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ns,n_sm,branch", [
    ("open", 6, None),
    ("tripole", 6, None),
    ("tripole", 9, "device"),
    ("tripoleT", 6, None)])
def test_tiled_schedule_with_the_revised_evp_equals_subcycle_sweep(
        dtype, ns, n_sm, branch):
    """The revised EVP's parameters (brlx from the smallest spacing, ~700
    times the classic dt/dte here, and revp=1, which adds the step's
    initial velocity to the momentum update) through the kernel's
    schedule: bit for bit the plain sweep on a 37x53 grid in ragged tiles,
    ndte=3, on an open north and on both seams; and they change the
    result."""
    classic, topo, kw = _sweep_inputs(37, 53, "cyclic", ns, dtype)
    p = _revised()
    plan = tile_plan(37, 53, kw["uvel"].dtype, n_sm, H100["smem_optin"],
                     branch)
    assert plan.ntiles > 1
    ref = tevp.subcycle_sweep(p, 3, topo, **kw)
    got = tiled_sweep(p, 3, topo, plan, **kw)
    for name, a, b in zip(("u", "v", "stress", "divu", "shear", "rdg_conv",
                           "rdg_shear", "prs_sig", "strintx", "strinty"),
                          _flat(ref), _flat(got)):
        assert torch.equal(a, b), name
    old = tevp.subcycle_sweep(classic, 3, topo, **kw)
    assert float((old[0] - ref[0]).abs().max()) > 1e-3 * float(
        ref[0].abs().max())


def test_tiled_schedule_matches_jax_sweep_resident_with_the_revised_evp():
    """The revised EVP on the tripole seam: the kernel's schedule against
    the Pallas kernel it replaces (interpret mode) on the port's sweep
    inputs of a 16x32 grid with a random stress, and bit for bit against
    the port's plain sweep."""
    ndte = 3
    _, topo, kw = _sweep_inputs(16, 32, "cyclic", "tripole", "float64",
                                seed=5)
    p = _revised()
    jkw = {k: ({kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
               if isinstance(v, dict) else
               v if isinstance(v, float) else jnp.asarray(v.numpy()))
           for k, v in kw.items()}
    jp = jdyn.EVPParams.revised(3600.0, ndte, 20000.0)
    assert dataclasses.asdict(jp) == dataclasses.asdict(p)
    ref = sweep_resident(jp, ndte, JTopology(ew="cyclic", ns="tripole"),
                         **jkw, interpret=True)
    plan = tile_plan(16, 32, torch.float64, 6, H100["smem_optin"])
    got = tiled_sweep(p, ndte, topo, plan, **kw)
    plain = tevp.subcycle_sweep(p, ndte, topo, **kw)
    for name, a, b, c in zip(("u", "v", "stress", "divu", "shear",
                              "rdg_conv", "rdg_shear", "prs_sig", "strintx",
                              "strinty"),
                             _flat(ref), _flat(got), _flat(plain)):
        assert torch.equal(b, c), name
        assert_close(a, b, 1e-11, name, floor=1e-12)
