"""PyTorch port of incremental-remap transport vs the JAX package.

The same inputs, made with NumPy from a fixed seed, go through the JAX
functions (jitted once each with torch_port_util.jit_fast; the Pallas
remap kernel in interpret mode where it is reached) and their
counterparts in ``cice5_tpu_torch`` on the CPU in float64. Single
components agree to ~1e-11 relative: both sides run the same
formulas, and only the rounding of the two backends differs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.config import rect_config as jrect_config
from cice5_tpu.grid import rectgrid as jrectgrid
from cice5_tpu.models.transport import remap as jrm
from cice5_tpu.parallel import Topology as JTopology
from cice5_tpu.state import build_tracer_registry as jbuild_registry
from cice5_tpu_torch import convert
from cice5_tpu_torch.models.transport import remap as trm
from cice5_tpu_torch.parallel import Topology
from cice5_tpu_torch.state import build_tracer_registry
from torch_port_util import assert_close, jit_fast

RTOL = 1e-11


def _grid(ny, nx, ew="cyclic"):
    jcfg = jrect_config(ny=ny, nx=nx, dtype="float64")
    jcfg = jcfg.replace(grid=dataclasses.replace(jcfg.grid, ew_boundary=ew))
    jg = jrectgrid(jcfg)
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg)}
    return jcfg, jg, convert.grid_from_arrays(arrays, device="cpu")


def _close(a, b, rtol=RTOL, name=""):
    assert_close(a, b, rtol, name)


@pytest.mark.parametrize("ew", ["cyclic", "open"])
def test_remap_geometry_matches(ew):
    ny, nx = 16, 16
    jcfg, jg, tg = _grid(ny, nx, ew)
    rng = np.random.default_rng(3)
    u = 0.3 * (rng.uniform(size=(ny, nx)) - 0.5)
    v = 0.3 * (rng.uniform(size=(ny, nx)) - 0.5)
    jtopo = JTopology(ew=ew, ns="open")
    jgeo = jit_fast(lambda g, u, v: jrm.remap_geometry(
        3600.0, g, jtopo, uvel=u, vvel=v))(jg, jnp.asarray(u), jnp.asarray(v))
    tgeo = trm.remap_geometry(3600.0, tg, Topology(ew=ew, ns="open"),
                              uvel=torch.as_tensor(u), vvel=torch.as_tensor(v))
    for edge in ("north", "east"):
        a, b = getattr(jgeo, edge), getattr(tgeo, edge)
        np.testing.assert_array_equal(np.asarray(a.donor), b.donor.numpy())
        for k in ("xp", "yp", "triarea"):
            _close(getattr(a, k), getattr(b, k), name=f"{edge}.{k}")


def test_remap_fields_batch_matches_pallas_interpret():
    """The plain version of the remap_flux_both kernel against the JAX
    package's merged Pallas kernel (interpret mode), including blocks the
    kernel skips: an ice-free category and an ice-free southern band."""
    ny, nx = 16, 16
    jcfg, jg, tg = _grid(ny, nx)
    rng = np.random.default_rng(1)
    ncat, ntrace = 2, 6
    mm = rng.uniform(0, 1, (ncat, ny, nx))
    tm = rng.uniform(0, 1, (ncat, ntrace, ny, nx))
    mm[0] = 0.0
    mm[-1, :14] = 0.0
    tracer_type = (1, 1, 1, 2, 3, 2)
    parent = (-1, -1, -1, 0, 3, 1)
    u = 0.2 * (rng.uniform(size=(ny, nx)) - 0.5)
    v = 0.2 * (rng.uniform(size=(ny, nx)) - 0.5)
    jtopo = JTopology(ew="cyclic", ns="open")

    def jref(g, u, v, mm, tm):
        geo = jrm.remap_geometry(3600.0, g, jtopo, uvel=u, vvel=v)
        return jrm.remap_fields_batch(g, jtopo, geo, mm=mm, tm=tm,
                                      tracer_type=tracer_type, parent=parent,
                                      interpret=True)
    ref = jit_fast(jref)(jg, jnp.asarray(u), jnp.asarray(v), jnp.asarray(mm),
                         jnp.asarray(tm))
    topo = Topology(ew="cyclic", ns="open")
    tgeo = trm.remap_geometry(3600.0, tg, topo, uvel=torch.as_tensor(u),
                              vvel=torch.as_tensor(v))
    out = trm.remap_fields_batch(tg, topo, tgeo, mm=torch.as_tensor(mm),
                                 tm=torch.as_tensor(tm),
                                 tracer_type=tracer_type, parent=parent)
    _close(ref[0], out[0], name="mm")
    _close(ref[1], out[1], name="tm")
    assert np.all(out[0].numpy()[0] == 0.0)
    assert np.all(out[0].numpy()[-1, :6] == 0.0)


@pytest.mark.parametrize("edge", ["north", "east"])
def test_remap_flux_edge_plain_matches_integrals_tiled_interpret(edge):
    """The plain version of the single-edge kernel (remap_flux_edge) against
    the JAX package's integrals_tiled (interpret mode) on the inputs of
    test_remap_fields_batch_matches_pallas_interpret, each flux on its own
    scale; and against the matching half of remap_flux_plain, bit for
    bit."""
    from cice5_tpu.ops.pallas.remap_flux import integrals_tiled
    from cice5_tpu_torch.parallel import extend_wide
    ny, nx = 16, 16
    _, _, tg = _grid(ny, nx)
    rng = np.random.default_rng(1)
    ncat, ntrace = 2, 6
    mm = rng.uniform(0, 1, (ncat, ny, nx))
    tm = rng.uniform(0, 1, (ncat, ntrace, ny, nx))
    mm[0] = 0.0
    mm[-1, :14] = 0.0
    tracer_type = (1, 1, 1, 2, 3, 2)
    parent = (-1, -1, -1, 0, 3, 1)
    u = 0.2 * (rng.uniform(size=(ny, nx)) - 0.5)
    v = 0.2 * (rng.uniform(size=(ny, nx)) - 0.5)
    topo = Topology(ew="cyclic", ns="open")
    geo = trm.remap_geometry(3600.0, tg, topo, uvel=torch.as_tensor(u),
                             vvel=torch.as_tensor(v))
    fields = (extend_wide(torch.as_tensor(mm), topo, 2),
              extend_wide(torch.as_tensor(tm), topo, 2),
              extend_wide(tg.hm, topo, 2))
    geoms = {k: (g.donor, g.triarea, *trm._triangle_midpoints(g))
             for k, g in geo._asdict().items()}
    J = lambda t: jnp.asarray(t.numpy())
    ref = integrals_tiled(edge, *map(J, geoms[edge]), *map(J, fields),
                          tracer_type, parent, ny, nx, interpret=True)
    got = trm.remap_flux_edge_plain(edge, geoms[edge], *fields, tracer_type,
                                    parent, ny, nx)
    assert_close(ref[0], got[0], 1e-12, "mflx")
    for k in range(ntrace):
        assert_close(np.asarray(ref[1])[:, k], got[1][:, k], 1e-12,
                     f"mtflx[{k}]")
    both = trm.remap_flux_plain(geoms["north"], geoms["east"], *fields,
                                tracer_type, parent, ny, nx)
    half = both[:2] if edge == "north" else both[2:]
    assert all(torch.equal(a, b) for a, b in zip(half, got))
    assert float(got[0].abs().max()) > 0.0


def test_remap_flux_plain_zero_where_no_ice():
    """The plain flux function gives exact zeros wherever the window holds
    no ice: the kernel's skip writes the same values."""
    ny, nx = 16, 16
    _, _, tg = _grid(ny, nx)
    rng = np.random.default_rng(5)
    mm = rng.uniform(0, 1, (1, ny + 4, nx + 4))
    mm[:, :9] = 0.0
    tm = rng.uniform(0, 1, (1, 3, ny + 4, nx + 4))
    u = torch.as_tensor(0.2 * (rng.uniform(size=(ny, nx)) - 0.5))
    geo = trm.remap_geometry(3600.0, tg, Topology(), uvel=u, vvel=-u)
    qn, qe = trm._triangle_midpoints(geo.north), trm._triangle_midpoints(
        geo.east)
    fn_m, fn_t, fe_m, fe_t = trm.remap_flux_plain(
        (geo.north.donor, geo.north.triarea, *qn),
        (geo.east.donor, geo.east.triarea, *qe),
        torch.as_tensor(mm), torch.as_tensor(tm),
        torch.ones((ny + 4, nx + 4), dtype=torch.float64), (1, 2, 2),
        (-1, 0, 0), ny, nx)
    # north edge row j reads one-ring rows j..j+1 -> raw rows j..j+3
    assert torch.all(fn_m[:, :5] == 0) and torch.all(fn_t[:, :, :5] == 0)
    assert torch.all(fe_m[:, :4] == 0) and torch.all(fe_t[:, :, :4] == 0)
    assert torch.any(fn_m != 0)


@pytest.mark.parametrize("ew", ["cyclic", "open"])
def test_transport_remap_matches(ew):
    """Whole transport_remap on a BL99-configuration state (5 categories,
    the class-sorted 18-tracer table) against the JAX XLA path."""
    ny, nx = 16, 16
    jcfg, jg, tg = _grid(ny, nx, ew)
    jtr = jbuild_registry(jcfg)
    tr = build_tracer_registry(convert.config_from_dict(
        dataclasses.asdict(jcfg)))
    rng = np.random.default_rng(11)
    ncat = jcfg.ncat
    tmask = np.asarray(jg.tmask)
    aicen = rng.uniform(0.0, 0.2, (ncat, ny, nx)) * tmask
    aicen[:, :, :3] = 0.0                       # an ice-free band
    vicen = aicen * rng.uniform(0.5, 3.0, (ncat, ny, nx))
    vsnon = aicen * rng.uniform(0.0, 0.3, (ncat, ny, nx))
    trcrn = rng.uniform(-3e8, -1e8, (ncat, tr.ntrcr, ny, nx))
    trcrn[:, tr.nt_Tsfc] = rng.uniform(-20.0, 0.0, (ncat, ny, nx))
    u = 0.3 * (rng.uniform(size=(ny, nx)) - 0.5)
    v = 0.3 * (rng.uniform(size=(ny, nx)) - 0.5)
    jtopo = JTopology(ew=ew, ns="open")
    ref = jit_fast(lambda g, u, v, a, vi, vs, tr: jrm.transport_remap(
        3600.0, g, jtopo, jtr, uvel=u, vvel=v, aicen=a, vicen=vi, vsnon=vs,
        trcrn=tr, kernel="xla"))(
        jg, *(jnp.asarray(x) for x in (u, v, aicen, vicen, vsnon, trcrn)))
    T = torch.as_tensor
    out = trm.transport_remap(
        3600.0, tg, Topology(ew=ew, ns="open"), tr, uvel=T(u), vvel=T(v),
        aicen=T(aicen), vicen=T(vicen), vsnon=T(vsnon), trcrn=T(trcrn))
    for name, a, b in zip(("aicen", "vicen", "vsnon", "trcrn"), ref, out):
        _close(a, b, name=name)


def test_tracer_table_class_sorted():
    cfg = convert.config_from_dict(dataclasses.asdict(jrect_config()))
    tt, par, order, inv = trm.tracer_table(build_tracer_registry(cfg))
    assert len(tt) == 18
    assert tt[:3] == (1, 1, 1) and set(tt[3:]) == {2}
    assert all(tt[p] == 1 for t, p in zip(tt, par) if t == 2)
    assert [order[i] for i in inv] == list(range(18))


def test_parity_tracer_table_on_tripole_matches_pallas_interpret():
    """The gx1-parity tracer table (19 tracers: the level-ice area as a
    type-1 parent, the pond area apnd as type 2 on it, the pond depth and
    lid as type 3 on apnd) through the plain version of remap_flux_both
    against the JAX package's merged Pallas kernel in interpret mode, on a
    tripole grid whose land touches the seam, with ice across the fold."""
    from cice5_tpu.config import gx1_parity_config as jparity
    from cice5_tpu.grid import popgrid_np as jpopgrid
    from cice5_tpu_torch.grid import popgrid_np as tpopgrid
    from torch_port_util import parity_grid_arrays
    jcfg = jparity()
    jcfg = jcfg.replace(grid=dataclasses.replace(jcfg.grid, ny=24, nx=16),
                        dtype="float64")
    jg = jpopgrid(jcfg, *parity_grid_arrays())
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    tg = tpopgrid(tcfg, *parity_grid_arrays(), device="cpu")
    tracer_type, parent, _, _ = trm.tracer_table(build_tracer_registry(tcfg))
    assert len(tracer_type) == 19 and 3 in tracer_type
    assert all(tracer_type[parent[t]] == 2 for t in range(19)
               if tracer_type[t] == 3)
    ny, nx, ncat = 24, 16, 5
    rng = np.random.default_rng(21)
    tmask = np.asarray(jg.tmask)
    mm = rng.uniform(0.0, 0.2, (ncat, ny, nx)) * tmask
    mm[:, :12] = 0.0                            # ice-free southern half
    tm = rng.uniform(0.0, 1.0, (ncat, 19, ny, nx))
    u = 0.3 * (rng.uniform(size=(ny, nx)) - 0.5)
    v = 0.3 * (rng.uniform(size=(ny, nx)) - 0.5)
    jtopo = JTopology(ew="cyclic", ns="tripole")

    def jref(g, u, v, mm, tm):
        geo = jrm.remap_geometry(3600.0, g, jtopo, uvel=u, vvel=v)
        return jrm.remap_fields_batch(g, jtopo, geo, mm=mm, tm=tm,
                                      tracer_type=tracer_type, parent=parent,
                                      interpret=True)
    ref = jit_fast(jref)(jg, jnp.asarray(u), jnp.asarray(v), jnp.asarray(mm),
                         jnp.asarray(tm))
    topo = Topology(ew="cyclic", ns="tripole")
    tgeo = trm.remap_geometry(3600.0, tg, topo, uvel=torch.as_tensor(u),
                              vvel=torch.as_tensor(v))
    out = trm.remap_fields_batch(tg, topo, tgeo, mm=torch.as_tensor(mm),
                                 tm=torch.as_tensor(tm),
                                 tracer_type=tracer_type, parent=parent)
    _close(ref[0], out[0], name="mm")
    for k in range(19):
        assert_close(np.asarray(ref[1])[:, k], out[1][:, k], RTOL,
                     f"tm[{k}] type {tracer_type[k]}", floor=1e-12)
    assert float(out[0][:, -1].max()) > 0.0     # ice reaches the seam row
