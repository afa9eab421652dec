"""PyTorch port of the level-ice melt ponds and the age / first-year
tracers vs the JAX package (models/tracers/ponds.py compute_ponds_lvl,
brine_permeability, permeability_phi; models/tracers/simple.py), on the
same float64 NumPy inputs made from a seed. Both lid schemes (cesm,
hlid) and both thermo branches (drainage with BL99, none with mushy).
Tolerance 1e-11 x scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.models.tracers import ponds as jponds
from cice5_tpu.models.tracers import simple as jsimple
from cice5_tpu_torch.models.tracers import ponds as tponds
from cice5_tpu_torch.models.tracers import simple as tsimple
from torch_port_util import assert_close

RTOL = 1e-11
NCAT, NY, NX, NILYR = 3, 6, 8, 4


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or (NCAT, NY, NX))
    aicen = u(0.0, 0.4)
    aicen[0, :, :2] = 0.0                         # ice-free columns
    vicen = aicen * u(0.05, 3.0)
    vsnon = aicen * u(0.0, 0.3)
    meltt = u(0.0, 0.02)
    meltt[:, :2] = 0.0                            # no melt: lids freeze
    melts = np.where(meltt > 0, u(0.0, 0.01), 0.0)
    d = dict(aicen=aicen, vicen=vicen, vsnon=vsnon, Tsfcn=u(-20.0, 0.0),
             alvl=u(0.3, 1.0), apnd=u(0.0, 0.6), hpnd=u(0.0, 0.4),
             ipnd=u(0.0, 0.05), meltt=meltt, melts=melts,
             frain=u(0.0, 1e-5, NY, NX), rfrac=u(0.15, 1.0),
             Tair=u(250.0, 280.0, NY, NX), fsurfn=u(-50.0, 100.0),
             dhs=u(-0.01, 0.01),
             qicen=-u(2.5e8, 3.3e8, NILYR, NCAT, NY, NX),
             sicen=u(0.5, 8.0, NILYR, NCAT, NY, NX))
    return d


@pytest.mark.parametrize("frzpnd", ["cesm", "hlid"])
@pytest.mark.parametrize("ktherm", [1, 2])
def test_compute_ponds_lvl_matches(frzpnd, ktherm):
    d = _inputs()
    kw = dict(pndaspect=0.8, frzpnd=frzpnd, dpscale=1e-3, ktherm=ktherm)
    ref = jponds.compute_ponds_lvl(3600.0, **{k: jnp.asarray(v)
                                              for k, v in d.items()}, **kw)
    got = tponds.compute_ponds_lvl(3600.0, **{k: torch.as_tensor(v)
                                              for k, v in d.items()}, **kw)
    for name in ref._fields:
        assert_close(getattr(ref, name), getattr(got, name), RTOL, name,
                     floor=1e-3)
    assert float(np.asarray(ref.apnd).max()) > 0.05


def test_permeability_helpers_match():
    d = _inputs(5)
    q, s = d["qicen"], d["sicen"]
    Tmlt = -s * 0.054
    assert_close(jponds.brine_permeability(jnp.asarray(q), jnp.asarray(s),
                                           jnp.asarray(Tmlt)),
                 tponds.brine_permeability(torch.as_tensor(q),
                                           torch.as_tensor(s),
                                           torch.as_tensor(Tmlt)),
                 RTOL, "brine_permeability", floor=1e-20)
    Tf = np.full((NY, NX), -1.8)
    for hc in (True, False):
        ref = jponds.permeability_phi(jnp.asarray(q), jnp.asarray(s),
                                      jnp.asarray(d["Tsfcn"]),
                                      jnp.asarray(Tf), heat_capacity=hc)
        got = tponds.permeability_phi(torch.as_tensor(q), torch.as_tensor(s),
                                      torch.as_tensor(d["Tsfcn"]),
                                      torch.as_tensor(Tf), heat_capacity=hc)
        assert_close(ref, got, RTOL, f"permeability_phi[{hc}]", floor=1e-20)


@pytest.mark.parametrize("yday", [100.0, 259.01, 75.02])
def test_age_and_first_year_area_match(yday):
    d = _inputs(7)
    rng = np.random.default_rng(8)
    iage = rng.uniform(0.0, 3e7, (NCAT, NY, NX))
    FY = rng.uniform(0.0, 1.0, (NCAT, NY, NX))
    nh = np.zeros((NY, NX), bool)
    nh[NY // 2:] = True
    assert_close(jsimple.increment_age(3600.0, jnp.asarray(iage),
                                       jnp.asarray(d["aicen"])),
                 tsimple.increment_age(3600.0, torch.as_tensor(iage),
                                       torch.as_tensor(d["aicen"])),
                 1e-15, "iage")
    ref = jsimple.update_FYarea(3600.0, jnp.asarray(yday), jnp.asarray(FY),
                                jnp.asarray(d["aicen"]), jnp.asarray(nh)[None])
    got = tsimple.update_FYarea(3600.0, torch.tensor(yday),
                                torch.as_tensor(FY),
                                torch.as_tensor(d["aicen"]),
                                torch.as_tensor(nh)[None])
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
