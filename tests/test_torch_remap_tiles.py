"""The tile plan and the schedule of the remap flux kernels B and E
(``cice5_tpu_torch/csrc/remap_tiles.cu``), on the CPU.

The kernel cuts the edge points into tiles (``ops/remap_tiles.py:plan``),
one block per (category, tile): it skips a tile whose raw mass window
holds no ice, rebuilds the reconstruction of one tracer after another on
the tile's one-ring window from its raw window, keeps the reconstruction
of every parent in a slot until its dependents are done, and integrates
each tracer's north and east fluxes from the window; kernel E, its
one-edge mode, integrates one of the two sets on the same blocks.
``tiled_flux`` below runs that schedule block by block in plain PyTorch,
with the plain version's own formulas; it must equal
``remap.remap_flux_plain`` bit for bit, and in the one-edge mode
``remap.remap_flux_edge_plain``. The kernels themselves are held against
the plain versions, and E against B's half, on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.config import gx1_parity_config, rect_config
from cice5_tpu_torch.grid import popgrid_np, rectgrid
from cice5_tpu_torch.models.transport import remap as trm
from cice5_tpu_torch.ops import remap_tiles as rt
from cice5_tpu_torch.parallel import Topology, extend_wide
from torch_port_util import parity_grid_arrays

# a pond chain as in the gx1-parity table: four type-1 tracers, type-2
# classes on three of them, and two type-3 tracers on the type-2 tracer 7
# (whose parent is the type-1 tracer 3)
POND_TABLE = ((1, 1, 1, 1, 2, 2, 2, 2, 3, 3),
              (-1, -1, -1, -1, 0, 0, 1, 3, 7, 7))


def remap_case(grid_kind, dtype, seed=3, table=POND_TABLE, ncat=3):
    """remap_flux_both's arguments on a small grid: "open" (20x40
    rectangular, open on every side) or "tripole" (the 24x16 gx1-parity
    mesh with land on the seam); random ice in every category but the
    last, which holds none, and an ice-free band across the south."""
    dt = {torch.float64: "float64", torch.float32: "float32"}[dtype]
    if grid_kind == "tripole":
        cfg = gx1_parity_config(dtype=dt)
        cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=24, nx=16))
        grid = popgrid_np(cfg, *parity_grid_arrays(), device="cpu")
        topo = Topology(ew="cyclic", ns="tripole")
    else:
        cfg = rect_config(ny=20, nx=40, dtype=dt)
        cfg = cfg.replace(grid=dataclasses.replace(cfg.grid,
                                                   ew_boundary="open"))
        grid = rectgrid(cfg, device="cpu")
        topo = Topology(ew="open", ns="open")
    ny, nx = grid.tmask.shape
    tt, par = table
    rng = np.random.default_rng(seed)
    tmask = grid.tmask.numpy()
    mm = rng.uniform(0.0, 0.3, (ncat, ny, nx)) * tmask
    mm[-1] = 0.0
    mm[:, : ny // 3] = 0.0
    tm = rng.uniform(0.0, 1.0, (ncat, len(tt), ny, nx))
    tm[rng.uniform(size=tm.shape) < 0.1] = 0.0     # parents with gaps
    u = 0.3 * (rng.uniform(size=(ny, nx)) - 0.5)
    v = 0.3 * (rng.uniform(size=(ny, nx)) - 0.5)
    T = lambda a: torch.as_tensor(a, dtype=dtype)
    geo = trm.remap_geometry(3600.0, grid, topo, uvel=T(u), vvel=T(v))
    qn, qe = (trm._triangle_midpoints(geo.north),
              trm._triangle_midpoints(geo.east))
    return ((geo.north.donor, geo.north.triarea, *qn),
            (geo.east.donor, geo.east.triarea, *qe),
            extend_wide(T(mm), topo, 2), extend_wide(T(tm), topo, 2),
            extend_wide(grid.hm, topo, 2), tt, par, ny, nx)


def _window(F, j0, i0, h, w):
    """F[..., j0:j0+h, i0:i0+w], zero past the array's end (the kernel's
    window outside the ringed field)."""
    out = torch.zeros(F.shape[:-2] + (h, w), dtype=F.dtype)
    part = F[..., j0:j0 + h, i0:i0 + w]
    out[..., :part.shape[-2], :part.shape[-1]] = part
    return out


def _class_maps(ta, donor, gs, parent_rc=None, grand_rc=None, views=None):
    """The six views' weight maps (Wc, Wx, Wy) of one class from the group
    sums ``gs`` (msum..myysum), as remap._integrals builds them: the
    type-1 class (no parent), a class on a type-1 parent (its (tc, tx, ty)
    at the donor cells), or on a type-2 parent (and its type-1 parent)."""
    msum, mxsum, mysum, mxxsum, mxysum, myysum = gs
    onehot = {v: (donor == v)[:, None] for v in views}
    maps = lambda cg, xg, yg: tuple(
        None if g is None else {v: (ta * g * onehot[v]).sum(0)
                                for v in views} for g in (cg, xg, yg))
    if parent_rc is None:
        return maps(msum, mxsum, mysum)
    sel = lambda rc: [trm._donor_select(donor, {v: f[v] for v in views})
                      for f in rc]
    tc_p, tx_p, ty_p = sel(parent_rc)
    if grand_rc is None:
        return maps(msum * tc_p + mxsum * tx_p + mysum * ty_p,
                    mxsum * tc_p + mxxsum * tx_p + mxysum * ty_p,
                    mysum * tc_p + mxysum * tx_p + myysum * ty_p)
    ga, gb, gd = sel(grand_rc)
    pts = msum * ga + mxsum * gb + mysum * gd
    ptx = mxsum * ga + mxxsum * gb + mxysum * gd
    pty = mysum * ga + mxysum * gb + myysum * gd
    return maps(pts * tc_p + ptx * tx_p + pty * ty_p, None, None)


def tiled_flux(args, plan=None, edge=None):
    """remap_flux_both's function run as csrc/remap_tiles.cu schedules it,
    block by block in plain PyTorch: the skip on the raw mass window, the
    mass reconstruction, then one tracer after another rebuilt on the
    tile's one-ring window from its raw window (a parent's reconstruction
    kept in its slot for its dependents) and integrated over the tile's
    north and east edges, or with ``edge`` ("north" or "east") over that
    set's alone (the one-edge mode, kernel E). Returns the four flux
    arrays (with ``edge``, that set's two) and the number of blocks that
    skipped."""
    geomN, geomE, mmE2, tmE2, hmE2, tt, par, ny, nx = args
    ncat, ntrace = tmE2.shape[:2]
    dtype = mmE2.dtype
    plan = plan or rt.plan(ny, nx, ncat, tt, par, dtype.itemsize)
    slot = rt.slots(tt, par)
    out = [torch.zeros((ncat, ny + 1, nx), dtype=dtype),
           torch.zeros((ncat, ntrace, ny + 1, nx), dtype=dtype),
           torch.zeros((ncat, ny, nx + 1), dtype=dtype),
           torch.zeros((ncat, ntrace, ny, nx + 1), dtype=dtype)]
    inner = lambda F: F[..., 1:-1, 1:-1]
    skipped = 0
    for b in range(plan.blocks):
        c, j0, i0 = plan.block(b)
        win = lambda F: _window(F, j0, i0, rt.WY, rt.WX)
        mmw = win(mmE2[c])
        if not bool((mmw != 0).any()):
            skipped += 1                 # the zeros are already there
            continue
        hmw = win(hmE2)
        # the mass reconstruction on the one-ring window
        mE = (mmw > 0.0).to(dtype)
        mm = inner(mmw)
        mx, my = trm._limited_gradient_core(mm, mmw, hmw, inner(hmw), 0.0,
                                            0.0)
        denom = torch.where(mm > 0.0, mm, 1.0)
        mxav = torch.where(mm > 0.0, mx * trm.XXAV / denom, 0.0)
        myav = torch.where(mm > 0.0, my * trm.YYAV / denom, 0.0)
        # each edge set: its edges in the tile, their donor views of the
        # window, geometry and group sums. The views sit at their edges' and
        # their category's places in planes of the whole edge set (zero
        # elsewhere), so every value takes the plain version's path through
        # PyTorch's reductions (whose order depends on the position).
        sets = []
        for east, geom, fo, to in ((False, geomN, 0, 1), (True, geomE, 2, 3)):
            if edge is not None and east != (edge == "east"):
                continue
            rows, cols = plan.edges(b, east)
            if not rows or not cols:
                continue
            h, w = len(rows), len(cols)
            nbr = (partial(trm._nbr_views_east, ny=rt.TY, nx=rt.TX - 1)
                   if east else
                   partial(trm._nbr_views_north, ny=rt.TY - 1, nx=rt.TX))
            shape = geom[1].shape[1:]

            def vfun(f, nbr=nbr, h=h, w=w, rows=rows, cols=cols,
                     shape=shape):
                out = {}
                for v, a in nbr(f).items():
                    plane = torch.zeros((ncat,) + shape, dtype=dtype)
                    plane[c, rows.start:rows.stop, cols.start:cols.stop] = \
                        a[:h, :w]
                    out[v] = plane
                return out
            dn, ta, qx, qy = geom
            mc_d, mx_d, my_d = (trm._donor_select(dn, vfun(f))
                                for f in (mm, mx, my))
            qxb, qyb = qx[:, :, None], qy[:, :, None]
            mq = (1.0 / 3.0) * (mc_d[:, None] + qxb * mx_d[:, None]
                                + qyb * my_d[:, None])
            gs = (mq.sum(1), (mq * qxb).sum(1), (mq * qyb).sum(1),
                  (mq * qxb * qxb).sum(1), (mq * qxb * qyb).sum(1),
                  (mq * qyb * qyb).sum(1))
            ta = ta[:, None]
            tile = (slice(rows.start, rows.stop), slice(cols.start, cols.stop))
            out[fo][c][tile] = (ta * gs[0]).sum(0)[c][tile]
            views = list(vfun(mm).keys())
            sets.append(dict(tile=tile, vfun=vfun, dn=dn, ta=ta, gs=gs,
                             W1=_class_maps(ta, dn, gs, views=views),
                             Wp=None, cur=-1, to=to, views=views))
        # tracer by tracer: rebuild, then integrate
        kept, kept_mask = {}, {}
        for t in range(ntrace):
            raw = win(tmE2[c, t])
            if slot[t] >= 0 and tt[t] == 1:
                kept_mask[t] = (torch.abs(raw) > 0.0).to(dtype)
            if tt[t] == 1:
                tx, ty = trm._limited_gradient_core(inner(raw), raw, mE,
                                                    inner(mE), mxav, myav)
                tc = inner(raw) - tx * mxav - ty * myav
                if slot[t] >= 0:
                    w2 = mm * tx + mx * tc
                    w3 = mm * ty + my * tc
                    mt = mm * inner(raw)
                    d2 = torch.where(torch.abs(mt) > 0.0, mt, 1.0)
                    ok = torch.abs(mt) > ct.puny
                    mtx = torch.where(ok, (w2 * trm.XXAV) / d2, 0.0)
                    mty = torch.where(ok, (w3 * trm.YYAV) / d2, 0.0)
            elif tt[t] == 2:
                p = par[t]
                kmask = kept_mask[p] * mE
                tx, ty = trm._limited_gradient_core(
                    inner(raw), raw, kmask, inner(kmask), kept[p][3],
                    kept[p][4])
                tc = inner(raw) - tx * kept[p][3] - ty * kept[p][4]
            else:
                tc = inner(raw)
                tx = ty = torch.zeros_like(tc)
            if slot[t] >= 0:
                kept[t] = (tc, tx, ty) + ((mtx, mty) if tt[t] == 1 else ())
            for s in sets:
                views, vfun = s["views"], s["vfun"]
                if tt[t] >= 2 and par[t] != s["cur"]:
                    p = s["cur"] = par[t]
                    g = par[p] if tt[p] == 2 else None
                    s["Wp"] = _class_maps(
                        s["ta"], s["dn"], s["gs"],
                        [vfun(f) for f in kept[p][:3]],
                        None if g is None else [vfun(f) for f in kept[g][:3]],
                        views=views)
                Wc, Wx, Wy = s["W1"] if tt[t] == 1 else s["Wp"]
                rcv = [vfun(f) for f in (tc, tx, ty)]
                acc = None
                for v in views:
                    term = Wc[v] * rcv[0][v]
                    if tt[t] <= 2 and Wx is not None:
                        term = term + Wx[v] * rcv[1][v]
                        term = term + Wy[v] * rcv[2][v]
                    acc = term if acc is None else acc + term
                out[s["to"]][c, t][s["tile"]] = acc[c][s["tile"]]
            if slot[t] < 0:
                del tc, tx, ty           # only the slots outlive a tracer
    if edge is not None:
        return tuple(out[2:] if edge == "east" else out[:2]), skipped
    return tuple(out), skipped


@pytest.mark.parametrize("ny,nx,ntile", [(384, 320, 49 * 11),
                                         (1080, 1440, 136 * 46),
                                         (16, 32, 3 * 2)])
def test_plan_covers_every_edge_once(ny, nx, ntile):
    """Every north and every east edge belongs to exactly one tile, every
    category of a tile runs in consecutive blocks, and a block's shared
    memory fits the H100's opt-in limit in float32 and float64 with the
    gx1-parity table's four parent slots."""
    tt, par = POND_TABLE
    for itemsize in (4, 8):
        p = rt.plan(ny, nx, 5, tt, par, itemsize)
        assert p.nty * p.ntx == ntile and p.blocks == 5 * ntile
        assert p.nslot == 4 and p.smem <= rt.SMEM_OPTIN_H100
        for east, shape in ((False, (ny + 1, nx)), (True, (ny, nx + 1))):
            count = np.zeros(shape, np.int32)
            for b in range(0, p.blocks, 5):
                rows, cols = p.edges(b, east)
                count[rows.start:rows.stop, cols.start:cols.stop] += 1
                assert [p.block(b + c)[0] for c in range(5)] == \
                    list(range(5))
                assert len({p.block(b + c)[1:] for c in range(5)}) == 1
            assert (count == 1).all()


def test_plan_shared_memory():
    """The kernel's shared memory per block: 55,984 B (float32) and
    111,968 B (float64) with four parent slots (gx1-parity), 38,928 /
    77,856 B with two (BL99); too many slots are refused, not run."""
    assert rt.plan(384, 320, 5, *POND_TABLE, 4).smem == 55984
    assert rt.plan(384, 320, 5, *POND_TABLE, 8).smem == 111968
    bl99 = ((1, 1, 1) + (2,) * 15, (-1, -1, -1) + (0,) * 12 + (1,) * 3)
    assert rt.plan(384, 320, 5, *bl99, 4).smem == 38928
    assert rt.plan(384, 320, 5, *bl99, 8).smem == 77856
    many = ((1,) * 32 + (2,) * 32, (-1,) * 32 + tuple(range(32)))
    with pytest.raises(ValueError, match="shared memory"):
        rt.plan(384, 320, 5, *many, 8)


def test_slots_follow_the_stack():
    assert rt.slots(*POND_TABLE) == (0, 1, -1, 2, -1, -1, -1, 3, -1, -1)


@pytest.mark.parametrize("grid_kind", ["open", "tripole"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_schedule_equals_plain(grid_kind, dtype):
    """The kernel's schedule in plain PyTorch equals remap_flux_plain bit
    for bit, with a pond chain (types 1, 2, 3), an ice-free band and an
    ice-free category (blocks that skip), on an open and on a tripole
    grid."""
    args = remap_case(grid_kind, dtype)
    ref = trm.remap_flux_plain(*args)
    got, skipped = tiled_flux(args)
    assert skipped > 0
    for r, g in zip(ref, got):
        assert torch.equal(r, g)
    assert float(ref[1].abs().max()) > 0.0


@pytest.mark.parametrize("edge", ["north", "east"])
@pytest.mark.parametrize("grid_kind", ["open", "tripole"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_one_edge_schedule_equals_plain(edge, grid_kind, dtype):
    """Kernel E's schedule (the one-edge mode of remap_tiles.cu: B's blocks
    and pipeline, one edge set integrated) in plain PyTorch equals
    remap_flux_edge_plain bit for bit, and so the half of that set of
    remap_flux_plain (which B's schedule equals), with the pond chain, the
    skipped blocks and both grids."""
    args = remap_case(grid_kind, dtype)
    geom = args[0] if edge == "north" else args[1]
    ref = trm.remap_flux_edge_plain(edge, geom, *args[2:])
    got, skipped = tiled_flux(args, edge=edge)
    assert skipped > 0
    both = trm.remap_flux_plain(*args)
    half = both[:2] if edge == "north" else both[2:]
    for r, g, h in zip(ref, got, half):
        assert torch.equal(r, g) and torch.equal(g, h)
    assert float(ref[1].abs().max()) > 0.0
