"""The port's CUDA kernels against their plain PyTorch versions.

The tests marked ``gpu`` need a CUDA card and skip elsewhere; this file
imports no JAX, so on the GPU machine it runs without the repository's
conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels.py

Inputs come from one step of a small port ``Model`` on the device (the
kernel wrappers' arguments captured there): the BL99 model on a
rectangular grid, and the gx1-parity model (tripole seam with land on
it, 19 remap tracers with the pond chains, dEdd shortwave). The unmarked
tests check on the CPU that the wrappers take the plain versions for CPU
tensors and count no launch.
"""
import dataclasses

import pytest
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.config import bench_easy_config, gx1_parity_config
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.models.dynamics import evp as tevp
from cice5_tpu_torch.models.radiation import dedd
from cice5_tpu_torch.models.transport import remap as trm
from cice5_tpu_torch.ops import check, evp_fused, kernels
from cice5_tpu_torch.ops.evp_resident import tile_plan
from test_torch_dedd_lanes import dedd_case
from test_torch_remap_tiles import POND_TABLE, remap_case
from torch_port_util import (PARITY_ISTEP, cuda_device,  # noqa: F401
                             parity_grid_arrays)


def _captured(device, dtype, ndte=8, ew="cyclic", ns="open"):
    """Arguments of evp_sweep and remap_flux_both in the second step of a
    16x32 model (velocities and stresses non-zero by then)."""
    cfg = bench_easy_config(ny=16, nx=32, ndte=ndte, dtype=dtype)
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ew_boundary=ew,
                                               ns_boundary=ns))
    m = Model(cfg, device=device)
    st = m.init_state(ice_mask=m.grid.tmask)
    f = m.forcing_at(0)
    st, _ = m.step(st, f)
    return check.capture_kernel_args(m, st, f)[1]


def _parity_model(device, dtype, ndte=8, ns="tripole"):
    cfg = gx1_parity_config(dtype=dtype, accum_dtype=dtype)
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=24, nx=16,
                                               ns_boundary=ns),
                      dyn=dataclasses.replace(cfg.dyn, ndte=ndte))
    grid = popgrid_np(cfg, *parity_grid_arrays(), device=device)
    return Model(cfg, grid=grid, device=device)


def _captured_parity(device, dtype, ndte=8, ns="tripole"):
    """Kernel arguments in the second step of the 24x16 gx1-parity model
    on a tripole grid (U-fold, or ``ns="tripoleT"`` the T-fold) with land
    on the seam, at a northern-summer noon."""
    m = _parity_model(device, dtype, ndte, ns)
    st = m.init_state()
    f = m.forcing_at(PARITY_ISTEP)
    st, _ = m.step(st, f)
    return check.capture_kernel_args(m, st, f)[1]


def _evp_rel(got):
    """Worst relative difference of the EVP kernel from its plain version,
    each output against its own scale."""
    p, nd, topo, kw = got["evp"]
    ref = check.evp_outputs(tevp.subcycle_sweep(p, nd, topo, **kw))
    out = check.evp_outputs(tevp.evp_sweep(p, nd, topo, **kw))
    return check.worst(check.field_errors(ref, out))[1]


def _fused_rel(got, kchunk):
    """Worst relative differences of kernel D (evp_fused, ndte/kchunk
    launches) from its plain version and from kernel A on the same
    inputs, each output against its own scale."""
    p, nd, topo, kw = got["evp"]
    sweep = dict(kchunk=kchunk, nwin=4, **kw)
    out = check.evp_outputs(evp_fused.fused_sweep(p, nd, topo, **sweep))
    plain = check.evp_outputs(evp_fused.fused_sweep_plain(p, nd, topo,
                                                          **sweep))
    a = check.evp_outputs(tevp.evp_sweep(p, nd, topo, **kw))
    return (check.worst(check.field_errors(plain, out))[1],
            check.worst(check.field_errors(a, out))[1])


def _edge_rel(args, edge):
    """Worst relative differences of kernel E (remap_flux_edge) from its
    plain version and from the matching half of kernel B."""
    geomN, geomE, mmE2, tmE2, hmE2, tt, par, ny, nx = args
    geom = geomN if edge == "north" else geomE
    names = ("mflx", "mtflx")
    out = dict(zip(names, trm.remap_flux_edge(edge, geom, mmE2, tmE2, hmE2,
                                              tt, par, ny, nx)))
    plain = dict(zip(names, trm.remap_flux_edge_plain(
        edge, geom, mmE2, tmE2, hmE2, tt, par, ny, nx)))
    both = trm.remap_flux_both(*args)
    b = dict(zip(names, both[:2] if edge == "north" else both[2:]))
    axes = {"mtflx": 1}
    return (check.worst(check.field_errors(plain, out, axes))[1],
            check.worst(check.field_errors(b, out, axes))[1])


def _remap_rel(args):
    ref = check.remap_outputs(trm.remap_flux_plain(*args))
    out = check.remap_outputs(trm.remap_flux_both(*args))
    return check.worst(check.field_errors(ref, out))[1]


def _dedd_rel(kw):
    ref = dedd.shortwave_dEdd_plain(**kw)._asdict()
    out = dedd.shortwave_dEdd_ncat(**kw)._asdict()
    return check.worst(check.field_errors(ref, out))[1]


def test_field_errors_scale_each_field_on_its_own():
    """A wrong small field is not hidden by a large one: each field, and
    each entry of a stacked field, is held against its own scale."""
    ref = {"uvel": torch.full((3, 4), 0.1),
           "stress": torch.stack([torch.full((3, 4), 3e4),
                                  torch.full((3, 4), 1.0)])}
    got = {"uvel": ref["uvel"] + 0.05, "stress": ref["stress"].clone()}
    errs = check.field_errors(ref, got)
    assert errs["uvel"][1] == pytest.approx(0.5)
    assert errs["stress[0]"] == (0.0, 0.0)
    got["stress"][1] += 0.5
    assert check.worst(check.field_errors(ref, got))[:2] == \
        ("uvel", pytest.approx(0.5))
    assert check.field_errors(ref, got)["stress[1]"][1] == pytest.approx(0.5)
    zero = {"x": torch.zeros(2, dtype=torch.float64)}
    assert check.field_errors(zero, {"x": torch.tensor([0.0, 1e-30],
                                                     dtype=torch.float64)}) \
        == {"x": (1e-30, float("inf"))}


@pytest.mark.parametrize("kernel", ["evp", "remap", "dedd", "evp_fused",
                                    "remap_edge"])
def test_wrappers_take_plain_version_on_cpu(kernel):
    got = (_captured_parity if kernel == "dedd" else _captured)(
        "cpu", "float64", ndte=2)
    kernels.reset_launch_counts()
    if kernel == "evp_fused":
        p, nd, topo, kw = got["evp"]
        a = evp_fused.fused_sweep(p, nd, topo, kchunk=1, nwin=2, **kw)
        b = evp_fused.fused_sweep_plain(p, nd, topo, kchunk=1, nwin=2, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    elif kernel == "remap_edge":
        geomN, _, *rest = got["remap"]
        a = trm.remap_flux_edge("north", geomN, *rest)
        b = trm.remap_flux_edge_plain("north", geomN, *rest)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    elif kernel == "dedd":
        a = dedd.shortwave_dEdd_ncat(**got["dedd"])
        b = dedd.shortwave_dEdd_plain(**got["dedd"])
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    elif kernel == "evp":
        p, nd, topo, kw = got["evp"]
        a = tevp.evp_sweep(p, nd, topo, **kw)
        b = tevp.subcycle_sweep(p, nd, topo, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    else:
        a = trm.remap_flux_both(*got["remap"])
        b = trm.remap_flux_plain(*got["remap"])
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ndte,tol", [("float64", 1, 1e-12),
                                            ("float64", 12, 3e-8),
                                            ("float32", 12, 1e-5)])
def test_evp_sweep_kernel_matches_plain(cuda_device, dtype, ndte, tol):
    """Built without FMA contraction, the kernel rounds as its plain
    version does, so float32 is held nearly as tightly as float64."""
    assert _evp_rel(_captured(cuda_device, dtype, ndte=ndte)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("ew,ns", [("open", "open"), ("cyclic", "cyclic"),
                                   ("closed", "closed")])
def test_kernels_match_plain_on_other_boundaries(cuda_device, ew, ns):
    """Both kernels on the other boundary types the halo supports (the
    ghost cells of the EVP kernel come from index arithmetic)."""
    got = _captured(cuda_device, "float64", ndte=12, ew=ew, ns=ns)
    assert _remap_rel(got["remap"]) <= 1e-12
    assert _evp_rel(got) <= 3e-8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
def test_remap_flux_kernel_matches_plain(cuda_device, dtype, tol):
    """With the mass field zeroed over the southern rows, so whole tiles
    take the kernel's skip path and must write exact zeros."""
    got = _captured(cuda_device, dtype)
    args = list(got["remap"])
    args[2] = args[2].clone()
    args[2][:, :14] = 0.0
    assert _remap_rel(args) <= tol
    out = trm.remap_flux_both(*args)
    assert bool((out[0][:, :8] == 0).all()) and \
        bool((out[1][:, :, :8] == 0).all())


@pytest.mark.gpu
def test_main_path_launches_each_kernel_once_per_step(cuda_device):
    m = Model(bench_easy_config(ny=16, nx=32, ndte=4), device=cuda_device)
    st = m.init_state(ice_mask=m.grid.tmask)
    kernels.reset_launch_counts()
    st, d = m.rollout(st, m.forcing_at(0), 3)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"evp_sweep": 3, "remap_flux_both": 3,
                                       "shortwave_dedd": 0, "evp_fused": 0,
                                       "remap_flux_edge": 0}
    assert int(d.state_bad) == 0 and bool(torch.isfinite(st.vicen).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 5e-5)])
def test_dedd_kernel_matches_plain(cuda_device, dtype, tol):
    """Kernel C against its plain version, every field and layer on its
    own scale, with an ice-free and a dark band that must be exact
    zeros."""
    kw = dict(_captured_parity(cuda_device, dtype)["dedd"])
    kw["aicen"] = kw["aicen"].clone()
    kw["aicen"][:, :, :2] = 0.0
    kw["coszen"] = kw["coszen"].clone()
    kw["coszen"][:, 2:4] = -0.1
    assert _dedd_rel(kw) <= tol
    out = dedd.shortwave_dEdd_ncat(**kw)
    assert all(bool((x[..., :4] == 0).all()) for x in out)
    netsw = kw["swvdr"] + kw["swvdf"] + kw["swidr"] + kw["swidf"]
    lit = (kw["aicen"] > ct.puny) & (netsw > ct.puny) & (kw["coszen"]
                                                         > ct.puny)
    assert bool(lit.any()) and float(out.fswsfcn.abs().max()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["lvl", "cesm", "topo"])
def test_dedd_kernel_pond_setups_match_plain(cuda_device, scheme):
    """Each pond setup of the kernel (the model sends level ponds) on the
    captured inputs with seeded ponds on every ice column, in float64."""
    kw = dict(_captured_parity(cuda_device, "float64")["dedd"],
              pond_scheme=scheme)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    a = kw["aicen"]
    u = lambda lo, hi: torch.where(a > 0, lo + (hi - lo) * torch.rand(
        a.shape, generator=gen, device=a.device, dtype=a.dtype), 0.0)
    kw["apnd"], kw["hpnd"] = u(0.05, 0.6), u(0.0, 0.4)
    assert _dedd_rel(kw) <= 1e-12
    assert float(dedd.shortwave_dEdd_plain(**kw).albpndn.max()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ndte,tol", [("float64", 1, 1e-12),
                                            ("float64", 12, 3e-8),
                                            ("float32", 12, 1e-5)])
def test_evp_kernel_on_the_tripole_matches_plain(cuda_device, dtype, ndte,
                                                 tol):
    """Kernel A with the U-fold of the north seam (land on the seam)."""
    got = _captured_parity(cuda_device, dtype, ndte=ndte)
    assert got["evp"][2].ns == "tripole"
    assert _evp_rel(got) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ndte,tol", [("float64", 1, 1e-12),
                                            ("float64", 12, 3e-8),
                                            ("float32", 12, 1e-5)])
def test_evp_kernel_on_the_tfold_matches_plain(cuda_device, dtype, ndte,
                                               tol):
    """Kernel A with the T-fold of the north seam (fold mode 2), and
    kernel B on the same step's T-fold inputs."""
    got = _captured_parity(cuda_device, dtype, ndte=ndte, ns="tripoleT")
    topo = got["evp"][2]
    assert topo.ns == "tripoleT" and tevp.fold_mode(topo) == 2
    assert _evp_rel(got) <= tol
    assert _remap_rel(got["remap"]) <= (1e-12 if dtype == "float64"
                                        else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
def test_remap_kernel_with_pond_chains_matches_plain(cuda_device, dtype,
                                                     tol):
    """Kernel B with the gx1-parity tracer table: type-3 pond depth and
    lid on the type-2 pond area on the type-1 level-ice area."""
    args = _captured_parity(cuda_device, dtype)["remap"]
    assert 3 in args[5] and len(args[5]) == 19
    assert _remap_rel(args) <= tol


@pytest.mark.gpu
def test_parity_path_launches_each_kernel_once_per_step(cuda_device):
    m = _parity_model(cuda_device, "float32", ndte=4)
    st = m.init_state()
    kernels.reset_launch_counts()
    st, d = m.rollout(st, m.forcing_at(PARITY_ISTEP), 3)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"evp_sweep": 3, "remap_flux_both": 3,
                                       "shortwave_dedd": 3, "evp_fused": 0,
                                       "remap_flux_edge": 0}
    assert int(d.state_bad) == 0 and bool(torch.isfinite(st.vicen).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ndte,kchunk,tol", [
    ("float64", 1, 1, 1e-12), ("float64", 20, 10, 3e-8),
    ("float32", 1, 1, 1e-6), ("float32", 20, 10, 1e-5)])
def test_evp_fused_kernel_matches_plain_and_evp_sweep(cuda_device, dtype,
                                                      ndte, kchunk, tol):
    """Kernel D against its plain version and against kernel A on the same
    captured inputs: the same function, the same per-point code
    (csrc/evp_point.cuh), so bit for bit when the build rounds alike."""
    got = _captured(cuda_device, dtype, ndte=ndte)
    rel_plain, rel_a = _fused_rel(got, kchunk)
    assert rel_plain <= tol and rel_a <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
@pytest.mark.parametrize("edge", ["north", "east"])
def test_remap_flux_edge_kernel_matches_plain_and_both(cuda_device, dtype,
                                                       tol, edge):
    """Kernel E against its plain version, and against the same edge set
    of kernel B (the same device code), with an ice-free band."""
    args = list(_captured(cuda_device, dtype)["remap"])
    args[2] = args[2].clone()
    args[2][:, :14] = 0.0
    rel_plain, rel_b = _edge_rel(args, edge)
    assert rel_plain <= tol and rel_b == 0.0


@pytest.mark.gpu
def test_fused_path_launches_evp_fused_per_chunk(cuda_device):
    cfg = bench_easy_config(ny=16, nx=32, ndte=20)
    cfg = cfg.replace(dyn=dataclasses.replace(cfg.dyn,
                                              evp_algorithm="pallas"))
    m = Model(cfg, device=cuda_device)
    st = m.init_state(ice_mask=m.grid.tmask)
    kernels.reset_launch_counts()
    st, d = m.rollout(st, m.forcing_at(0), 3)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "evp_sweep": 0, "remap_flux_both": 3, "shortwave_dedd": 0,
        "evp_fused": 6, "remap_flux_edge": 0}
    assert int(d.state_bad) == 0 and bool(torch.isfinite(st.vicen).all())


def _plan(kw, branch):
    """A tile plan of the EVP kernels for the captured inputs: the card's
    own ("auto"), the shared branch with the read-only planes in L1/L2,
    or the device branch (chip_smoke.py runs it at 384x320, where each
    block walks several tiles)."""
    if branch == "auto":
        return None
    (ny, nx), dtype = kw["uvel"].shape, kw["uvel"].dtype
    n_sm, smem = kernels.device_limits(kw["uvel"].device)
    if branch == "shared":
        return tile_plan(ny, nx, dtype, n_sm, smem, "shared")
    return tile_plan(ny, nx, dtype, n_sm, smem, "device")


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["auto", "shared", "device"])
@pytest.mark.parametrize("model", ["bl99", "tripole", "tfold"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_evp_sweep_kernel_branches_equal_plain(cuda_device, branch, model,
                                               dtype):
    """Kernel A in each branch of its tile plan equals subcycle_sweep bit
    for bit, on the BL99 grid and on the U-fold and T-fold seams with land
    on them."""
    got = (_captured(cuda_device, dtype, ndte=12) if model == "bl99" else
           _captured_parity(cuda_device, dtype, ndte=12,
                            ns="tripoleT" if model == "tfold"
                            else "tripole"))
    p, nd, topo, kw = got["evp"]
    ref = check.evp_outputs(tevp.subcycle_sweep(p, nd, topo, **kw))
    out = check.evp_outputs(check.evp_on_plan(p, nd, topo, _plan(kw, branch),
                                              **kw))
    assert check.worst(check.field_errors(ref, out))[2] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["auto", "device"])
@pytest.mark.parametrize("dtype,ndte,kchunk", [("float64", 1, 1),
                                               ("float64", 20, 10),
                                               ("float32", 20, 10)])
def test_evp_fused_kernel_branches_equal_plain_and_a(cuda_device, branch,
                                                     dtype, ndte, kchunk):
    """Kernel D in each branch equals its plain version and kernel A bit
    for bit (the same engine, csrc/evp_resident.cu)."""
    p, nd, topo, kw = _captured(cuda_device, dtype, ndte=ndte)["evp"]
    plan = _plan(kw, branch)
    out = check.evp_outputs(check.evp_on_plan(p, nd, topo, plan,
                                              kchunk=kchunk, **kw))
    plain = check.evp_outputs(evp_fused.fused_sweep_plain(
        p, nd, topo, kchunk=kchunk, nwin=4, **kw))
    a = check.evp_outputs(check.evp_on_plan(p, nd, topo, plan, **kw))
    assert check.worst(check.field_errors(plain, out))[2] == 0.0
    assert check.worst(check.field_errors(a, out))[2] == 0.0


def _to(args, device):
    """remap_flux_both's arguments on a device."""
    mv = lambda t: t.to(device) if torch.is_tensor(t) else t
    return tuple(tuple(mv(t) for t in a) if isinstance(a, tuple)
                 and a and torch.is_tensor(a[0]) else mv(a) for a in args)


def _edge_halves(args):
    geomN, geomE, mm, tm, hm, tt, par, ny, nx = args
    return (trm.remap_flux_edge("north", geomN, mm, tm, hm, tt, par, ny, nx)
            + trm.remap_flux_edge("east", geomE, mm, tm, hm, tt, par, ny,
                                  nx))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["bl99", "tripole"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_remap_tiles_equal_edge_kernel_halves(cuda_device, model, dtype):
    """Kernel B (csrc/remap_tiles.cu) repeats the arithmetic of kernel E
    (the first version's device code) in the same order: its north and
    east fluxes equal E's bit for bit, on captured model inputs with an
    ice-free band."""
    args = list((_captured if model == "bl99" else _captured_parity)(
        cuda_device, dtype)["remap"])
    args[2] = args[2].clone()
    args[2][:, :10] = 0.0
    got = trm.remap_flux_both(*args)
    for b, e in zip(got, _edge_halves(args)):
        assert torch.equal(b, e)


@pytest.mark.gpu
@pytest.mark.parametrize("grid_kind", ["open", "tripole"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_remap_tiles_pond_chain_matches_plain(cuda_device, grid_kind, dtype,
                                              tol):
    """Kernel B on the CPU schedule test's inputs (a pond chain of types
    1, 2 and 3, an ice-free band and an ice-free category) within the
    plain version's bounds, each flux on its own scale; the tiles out of
    reach of ice exact zeros."""
    args = _to(remap_case(grid_kind, dtype), cuda_device)
    assert args[5] == POND_TABLE[0]
    ref = check.remap_outputs(trm.remap_flux_plain(*args))
    out = trm.remap_flux_both(*args)
    assert check.worst(check.field_errors(
        ref, check.remap_outputs(out)))[1] <= tol
    assert all(bool((x[-1] == 0).all()) for x in out)   # no ice there


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_remap_tiles_skip_writes_exact_zeros(cuda_device, dtype):
    """With no ice anywhere every block skips: all fluxes exact zeros,
    whatever the tracers hold."""
    args = list(_to(remap_case("open", dtype), cuda_device))
    args[2] = torch.zeros_like(args[2])
    for x in trm.remap_flux_both(*args):
        assert bool((x == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("nilyr,nslyr", [pytest.param(4, 1, id="4"),
                                         pytest.param(7, 1, id="7"),
                                         pytest.param(8, 3, id="8-3")])
@pytest.mark.parametrize("scheme", ["lvl", "cesm", "topo"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 5e-5)])
def test_dedd_lanes_match_plain(cuda_device, nilyr, nslyr, scheme, dtype,
                                tol):
    """Kernel C (compacted lit columns, three lanes per column) within the
    plain version's bounds for (nilyr, nslyr) 4/1, 7/1 (the default
    library) and CESM2's 8/3 (a library of its own) and each pond setup,
    every field and layer on its own scale, with exact zeros off the lit
    columns."""
    kw = {k: v.to(cuda_device) for k, v in dedd_case(dtype=dtype).items()}
    kw.update(nilyr=nilyr, nslyr=nslyr, pond_scheme=scheme)
    assert _dedd_rel(kw) <= tol
    out = dedd.shortwave_dEdd_ncat(**kw)
    netsw = kw["swvdr"] + kw["swvdf"] + kw["swidr"] + kw["swidf"]
    lit = (kw["aicen"] > ct.puny) & (netsw > ct.puny) & (kw["coszen"]
                                                         > ct.puny)
    assert 0 < int(lit.sum()) < lit.numel()
    for x in out:
        assert bool(((x if x.dim() == 3 else x.movedim(1, 0))[..., ~lit]
                     == 0).all())


@pytest.mark.gpu
def test_dedd_layers_beyond_shared_memory_are_refused(cuda_device):
    """20 ice and 5 snow layers need more shared memory per block than the
    card has in float64: the wrapper raises, naming the limit, before any
    build or launch; it never takes the plain version."""
    kw = {k: v.to(cuda_device)
          for k, v in dedd_case(dtype=torch.float64).items()}
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="a block may use on this card"):
        dedd.shortwave_dEdd_ncat(nilyr=20, nslyr=5, pond_scheme="lvl", **kw)
    assert kernels.launch_counts()["shortwave_dedd"] == 0
