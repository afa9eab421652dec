"""The CESM and topographic melt ponds of the port
(``cice5_tpu_torch/models/tracers/ponds.py``: compute_ponds_cesm,
_calc_hpond, _pond_area, compute_ponds_topo) against the JAX package's
functions, op by op in float64 on seeded columns (1e-11 relative), and
the physical properties of tests/test_ponds_topo.py on the port: liquid
water conservation through the fpond flux, the lowest categories filling
first, thin-ice removal, overflow drainage, lid growth, nucleation and
melt. ``_calc_hpond``'s sort network and its volume scan run over a batch
of cells with no host read (under the strict dispatch mode of
test_torch_graph.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cice5_tpu import constants as jct
from cice5_tpu.models.thermo import shared as jshared
from cice5_tpu.models.tracers import ponds as jponds
from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.driver import graph
from cice5_tpu_torch.models.thermo import shared as tshared
from cice5_tpu_torch.models.tracers import ponds as tponds
from torch_port_util import assert_close

NCAT, NILYR = 5, 7
B = (6, 9)
RTOL = 1e-11


def _columns(seed, hs=0.1, cold=True, ncat=NCAT):
    """Seeded per-category columns (NumPy float64): a random ITD with
    distinct thicknesses, snow, enthalpies and salinities, ponds and lids;
    some cells with thin or no ice."""
    rng = np.random.default_rng(seed)
    shp = (ncat,) + B
    a = rng.uniform(0.02, 0.3, shp)
    a[:, 0, :2] = 0.0                         # open water
    a[:, 1, 0] = 0.005                        # sparse ice
    h = np.sort(rng.uniform(0.2, 4.0, shp), axis=0)
    h[:, 2, 0] = 0.05                         # thin ice
    v = a * h
    s = a * rng.uniform(0.0, hs, shp)
    Ti = rng.uniform(-12.0, -3.0 if cold else -0.4, (NILYR,) + shp)
    sal = rng.uniform(2.0, 4.0, (NILYR,) + shp)
    q = np.array(jshared.ice_enthalpy(jnp.asarray(Ti),
                                      jnp.asarray(-sal * jct.depressT)))
    Tsfcn = rng.uniform(-15.0, -0.01 if cold else 0.0, shp)
    has = a > 0
    apnd = np.where(has, rng.uniform(0.0, 0.6, shp), 0.0)
    hpnd = np.where(has, rng.uniform(0.0, 0.4, shp), 0.0)
    ipnd = np.where(has, rng.uniform(0.0, 0.03, shp), 0.0)
    return dict(aicen=a, vicen=v, vsnon=s, qicen=q, sicen=sal, Tsfcn=Tsfcn,
                apnd=apnd, hpnd=hpnd, ipnd=ipnd)


def _both(fn_j, fn_t, kw):
    """(JAX result, port result) of the same keyword arrays."""
    rj = fn_j(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                 for k, v in kw.items()})
    rt = fn_t(**{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                 for k, v in kw.items()})
    return rj, rt


def _topo_kw(c, meltt=0.0, fsurf=0.0, ktherm=1, heat_capacity=True,
             rng_melt=None):
    aice = c["aicen"].sum(0)
    kw = dict(aice=aice, aicen=c["aicen"], vice=c["vicen"].sum(0),
              vicen=c["vicen"], vsno=c["vsnon"].sum(0), vsnon=c["vsnon"],
              meltt=np.full(B, meltt) if rng_melt is None else rng_melt,
              fsurf=np.full(B, fsurf), Tsfcn=c["Tsfcn"], Tf=np.full(B, -1.8),
              qicen=c["qicen"], sicen=c["sicen"], apnd=c["apnd"],
              hpnd=c["hpnd"], ipnd=c["ipnd"], ktherm=ktherm,
              heat_capacity=heat_capacity)
    return kw


def _topo(kw):
    return _both(lambda **k: jponds.compute_ponds_topo(3600.0, **k),
                 lambda **k: tponds.compute_ponds_topo(3600.0, **k), kw)


# ---------------------------------------------------------------------
# op by op against JAX
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_ponds_cesm_matches(seed):
    c = _columns(seed)
    rng = np.random.default_rng(100 + seed)
    kw = dict(aicen=c["aicen"], vicen=c["vicen"], vsnon=c["vsnon"],
              Tsfcn=c["Tsfcn"] * (seed != 1), apnd=c["apnd"],
              hpnd=c["hpnd"], meltt=rng.uniform(0, 0.02, c["aicen"].shape),
              melts=rng.uniform(0, 0.01, c["aicen"].shape),
              frain=np.full(B, 2e-5), rfrac=rng.uniform(0.15, 1.0, B)[None],
              pndaspect=0.8)
    (ja, jh), (ta, th) = _both(
        lambda **k: jponds.compute_ponds_cesm(3600.0, **k),
        lambda **k: tponds.compute_ponds_cesm(3600.0, **k), kw)
    assert_close(ja, ta, RTOL, "apnd")
    assert_close(jh, th, RTOL, "hpnd")
    assert float(ta.max()) > 0.0


def _hypsometry(c, ncat=NCAT):
    """_pond_area's inputs of _calc_hpond for columns c."""
    a, v, s = c["aicen"], c["vicen"], c["vsnon"]
    has = a > jct.puny
    hi = np.where(has, v / np.maximum(a, jct.puny), 0.0)
    hs = np.where(has, s / np.maximum(a, jct.puny), 0.0)
    red = np.where(has, a * np.maximum(0.2, -0.024 * hi + 0.832), 0.0)
    red[ncat - 1] = np.where(has[ncat - 1], 1.0, 0.0)
    alfan = 0.6 * hi
    cums, prev = [], np.zeros(B)
    for n in range(ncat - 1):
        cond = (alfan[n + 1] >= alfan[n]) & (alfan[n + 1] > 0.0)
        val = prev + (alfan[n + 1] - alfan[n]) * red[:n + 1].sum(0)
        for m in range(n + 1):
            val = val - (jct.rhos / jct.rhow) * red[m] * np.maximum(
                np.minimum(hs[m] + alfan[m] - alfan[n],
                           alfan[n + 1] - alfan[n]), 0.0)
        prev = np.where(cond, val, prev)
        cums.append(prev)
    cums.append(prev)
    return red, red, hs, alfan, np.stack(cums)


@pytest.mark.parametrize("ncat", [3, 5, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_calc_hpond_matches(seed, ncat):
    """The pond level and the highest covered category for volumes from
    empty to beyond the hypsometry's capacity, with snow (which lifts the
    levels out of their order, so the sort network works)."""
    c = _columns(seed, hs=0.6, ncat=ncat)
    red, asn, hs, alfan, cum = _hypsometry(c, ncat)
    rng = np.random.default_rng(seed)
    volp = rng.uniform(0.0, 1.2, B) * cum[-1]
    volp[0, 0] = 0.0
    volp[3, 3] = 1e-14
    hj, mj = jponds._calc_hpond(ncat, *map(jnp.asarray, (red, asn, hs,
                                                         alfan, volp, cum)))
    ht, mt = tponds._calc_hpond(ncat, *map(torch.as_tensor, (red, asn, hs,
                                                             alfan, volp,
                                                             cum)))
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    assert_close(hj, ht, RTOL, "hpond")
    assert len(set(mt.flatten().tolist())) >= 3


def test_calc_hpond_reads_nothing_on_the_host():
    """The sort network and the scan run under the strict dispatch mode
    that refuses any host read of a device value."""
    c = _columns(4, hs=0.6)
    args = _hypsometry(c)
    t = [torch.as_tensor(a) for a in args[:4]]
    volp, cum = torch.as_tensor(0.5 * args[4][-1]), torch.as_tensor(args[4])
    with graph.HostSyncs(strict=True):
        tponds._calc_hpond(NCAT, *t, volp, cum)


@pytest.mark.parametrize("ktherm", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_pond_area_matches(seed, ktherm):
    c = _columns(seed, hs=0.3, cold=seed == 0)
    aice = c["aicen"].sum(0)
    volp = (c["apnd"] * c["hpnd"] * c["aicen"]).sum(0)
    kw = dict(aice=aice, vice=c["vicen"].sum(0), vsno=c["vsnon"].sum(0),
              aicen=c["aicen"], vicen=c["vicen"], vsnon=c["vsnon"],
              qicen=c["qicen"], sicen=c["sicen"], volp=volp,
              Tsfcn=c["Tsfcn"], Tf=np.full(B, -1.8), ktherm=ktherm,
              heat_capacity=ktherm != 0)
    rj, rt = _both(lambda **k: jponds._pond_area(3600.0, NCAT, **k),
                   lambda **k: tponds._pond_area(3600.0, NCAT, **k), kw)
    for name, a, b in zip(("volpn", "apondn", "hpondn", "volp", "dvolp"),
                          rj, rt):
        assert_close(a, b, RTOL, name)


@pytest.mark.parametrize("case", ["cold", "warm_melt", "nucleate",
                                  "bl99", "zerolayer"])
def test_compute_ponds_topo_matches(case):
    c = _columns({"cold": 0, "warm_melt": 1, "nucleate": 2, "bl99": 3,
                  "zerolayer": 4}[case], hs=0.2, cold=case != "warm_melt")
    rng = np.random.default_rng(9)
    kw = _topo_kw(c, ktherm={"bl99": 1, "zerolayer": 0}.get(case, 2),
                  heat_capacity=case != "zerolayer",
                  fsurf=-150.0 if case == "nucleate" else 0.0,
                  rng_melt=rng.uniform(0.0, 0.02, B))
    if case == "nucleate":
        kw["ipnd"] = np.zeros_like(kw["ipnd"])
    if case == "warm_melt":
        kw["Tsfcn"] = np.full_like(kw["Tsfcn"], -0.05)
    rj, rt = _topo(kw)
    for name in ("apnd", "hpnd", "ipnd", "dfpond", "vuin"):
        assert_close(getattr(rj, name), getattr(rt, name), RTOL, name)
    assert float(rt.apnd.max()) > 0.0


# ---------------------------------------------------------------------
# physical properties (tests/test_ponds_topo.py) on the port
# ---------------------------------------------------------------------

def _itd_state(hs=0.0, cold=True):
    """Every cell the same full ITD of distinct thicknesses."""
    hcat = torch.tensor([0.3, 0.8, 1.5, 2.5, 4.0], dtype=torch.float64)
    acat = torch.tensor([0.15, 0.25, 0.25, 0.2, 0.1], dtype=torch.float64)
    aicen = acat[:, None, None].expand((NCAT,) + B).clone()
    vicen = aicen * hcat[:, None, None]
    vsnon = aicen * hs
    Ti = -10.0 if cold else -0.5
    q = tshared.ice_enthalpy(torch.full((NILYR, NCAT) + B, Ti,
                                        dtype=torch.float64),
                             torch.tensor(-3.2 * ct.depressT))
    s = torch.full((NILYR, NCAT) + B, 3.2, dtype=torch.float64)
    Tsfcn = torch.full((NCAT,) + B, Ti, dtype=torch.float64)
    return aicen, vicen, vsnon, q, s, Tsfcn


def _call(aicen, vicen, vsnon, q, s, Tsfcn, apnd, hpnd, ipnd, meltt=0.0,
          fsurf=0.0, ktherm=2):
    aice = aicen.sum(0)
    full = lambda x: torch.full(B, x, dtype=torch.float64)
    return tponds.compute_ponds_topo(
        3600.0, aice=aice, aicen=aicen, vice=vicen.sum(0), vicen=vicen,
        vsno=vsnon.sum(0), vsnon=vsnon, meltt=full(meltt), fsurf=full(fsurf),
        Tsfcn=Tsfcn, Tf=full(-1.8), qicen=q, sicen=s, apnd=apnd, hpnd=hpnd,
        ipnd=ipnd, ktherm=ktherm)


def _const(x):
    return torch.full((NCAT,) + B, x, dtype=torch.float64)


def test_water_fills_lowest_categories():
    """Water ponds on the thinnest ice first, the thickest category never
    ponds, and the pond depth falls with the category's thickness."""
    aicen, vicen, vsnon, q, s, Tsfcn = _itd_state()
    r = _call(aicen, vicen, vsnon, q, s, Tsfcn, _const(0.3), _const(0.05),
              _const(0.0))
    ap, hp = r.apnd.numpy(), r.hpnd.numpy()
    assert ap[0].min() > 0.0
    assert ap[-1].max() == 0.0
    ponded = ap[:, 0, 0] > 0
    assert (np.diff(hp[ponded, 0, 0]) <= 1e-12).all()


def test_liquid_water_conservation():
    """volp_new == volp_old + dfpond: every source and sink of liquid pond
    water shows in the fpond flux."""
    aicen, vicen, vsnon, q, s, Tsfcn = _itd_state()
    rng = np.random.default_rng(7)
    u = lambda hi: torch.as_tensor(rng.uniform(0, hi, (NCAT,) + B))
    apnd, hpnd, ipnd = u(0.5), u(0.3), u(0.02)
    volp0 = (hpnd * apnd * aicen).sum(0)
    for ktherm, meltt in ((2, 0.0), (1, 0.0), (2, 0.01)):
        r = _call(aicen, vicen, vsnon, q, s, Tsfcn, apnd, hpnd, ipnd,
                  meltt=meltt, ktherm=ktherm)
        volp1 = (r.hpnd * r.apnd * aicen).sum(0)
        np.testing.assert_allclose(volp1, volp0 + r.dfpond, atol=1e-12)


def test_thin_ice_ponds_removed():
    """Ponds on ice thinner than 0.1 m go, their water to the ocean."""
    aicen, vicen, vsnon, q, s, Tsfcn = _itd_state()
    vicen = vicen * 0.02
    apnd, hpnd = _const(0.4), _const(0.1)
    volp0 = (hpnd * apnd * aicen).sum(0)
    r = _call(aicen, vicen, vsnon, q, s, Tsfcn, apnd, hpnd, _const(0.0))
    assert float(r.apnd.max()) == 0.0
    np.testing.assert_allclose(r.dfpond, -volp0, atol=1e-12)


def test_overflow_drains():
    """More water than the hypsometry holds drains to the ocean."""
    aicen, vicen, vsnon, q, s, Tsfcn = _itd_state()
    r = _call(aicen, vicen, vsnon, q, s, Tsfcn, _const(1.0), _const(10.0),
              _const(0.0))
    assert float(r.dfpond.max()) < 0.0
    volp1 = (r.hpnd * r.apnd * aicen).sum(0)
    assert torch.isfinite(volp1).all() and bool((volp1 < 10.0).all())


def test_cold_surface_grows_lid():
    aicen, vicen, vsnon, q, s, Tsfcn = _itd_state()
    r = _call(aicen, vicen, vsnon, q, s, Tsfcn - 5.0, _const(0.4),
              _const(0.1), _const(0.01))
    wet = r.hpnd > 1e-6
    assert bool(wet.any()) and bool((r.ipnd[wet] > 0.0).all())
    assert float(r.dfpond.sum()) < 0.0


def test_new_lid_forms_from_negative_fsurf():
    aicen, vicen, vsnon, q, s, Tsfcn = _itd_state()
    r = _call(aicen, vicen, vsnon, q, s, Tsfcn, _const(0.4), _const(0.1),
              _const(0.0), fsurf=-200.0)
    ponded = r.apnd[:-1] > 0
    assert float(r.ipnd[:-1][ponded].max()) > 0.0


def test_warm_surface_melts_lid():
    aicen, vicen, vsnon, q, s, Tsfcn = _itd_state(cold=False)
    Tsfcn = torch.full_like(Tsfcn, -0.05)
    apnd, hpnd, ipnd = _const(0.4), _const(0.1), _const(0.05)
    vuin0 = (ipnd * apnd * aicen).sum(0)
    r0 = _call(aicen, vicen, vsnon, q, s, Tsfcn, apnd, hpnd, ipnd, meltt=0.0)
    r1 = _call(aicen, vicen, vsnon, q, s, Tsfcn, apnd, hpnd, ipnd,
               meltt=0.02)
    assert float((r1.vuin.sum(0) - vuin0).max()) <= 1e-12
    assert float(r1.dfpond.sum()) > float(r0.dfpond.sum())


def test_topo_step_ponds_stay_bounded():
    """Three steps of a rectangular mushy model with topo ponds (the JAX
    TestTopoInStep run): the pond tracers stay finite and in range."""
    import dataclasses
    from cice5_tpu_torch.config import rect_config
    from cice5_tpu_torch.driver.model import Model
    cfg = rect_config(dtype="float64", accum_dtype="float64")
    cfg = cfg.replace(
        grid=dataclasses.replace(cfg.grid, ny=16, nx=24),
        thermo=dataclasses.replace(cfg.thermo, ktherm=2),
        tracers=dataclasses.replace(cfg.tracers, tr_pond_topo=True),
        dyn=dataclasses.replace(cfg.dyn, ndte=10))
    m = Model(cfg, device="cpu")
    st = m.init_state(ice_mask=m.grid.tmask)
    tr = m.tr
    trc = st.trcrn.clone()
    trc[:, tr.nt_apnd] = 0.3 * (st.aicen > 0)
    trc[:, tr.nt_hpnd] = 0.08 * (st.aicen > 0)
    st = st.replace(trcrn=trc)
    for k in range(3):
        st, d = m.step(st, m.forcing_at(k))
    ap, hp, ip = (st.trcrn[:, i] for i in (tr.nt_apnd, tr.nt_hpnd,
                                           tr.nt_ipnd))
    assert all(bool(torch.isfinite(x).all()) for x in (ap, hp, ip))
    assert float(ap.min()) >= 0.0 and float(ap.max()) <= 1.0 + 1e-6
    assert float(hp.min()) >= 0.0
    assert int(d.state_bad) == 0
