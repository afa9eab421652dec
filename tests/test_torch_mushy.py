"""PyTorch port of the mushy-layer thermodynamics (ktherm=2) vs the JAX
package, on the same float64 NumPy inputs made from a seed:
``temperature_changes_salinity`` (the two-stage Picard solve with gravity
drainage, pond flushing and snow-ice flooding) and ``add_new_ice`` with
mushy frazil and the age / first-year / level-ice tracers. The JAX side
runs op by op (each jit of these functions compiles for tens of seconds).
Tolerance 1e-11 x scale; the pass counts of the Picard loops agree."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.config import gx1_parity_config
from cice5_tpu.models.thermo import itd as jitd
from cice5_tpu.models.thermo import mushy as jmushy
from cice5_tpu.state import build_tracer_registry as jbuild
from cice5_tpu_torch import convert
from cice5_tpu_torch.models.thermo import itd as titd
from cice5_tpu_torch.models.thermo import mushy as tmushy
from cice5_tpu_torch.state import build_tracer_registry as tbuild
from torch_port_util import assert_close

RTOL = 1e-11
NCAT, NY, NX, NILYR, NSLYR = 2, 6, 8, 4, 1


def _column(seed=4):
    """Layer-first mushy columns: cold and melting surfaces, heavy snow on
    thin ice (negative freeboard: flooding), ponds (flushing), warm and
    cold bottoms (drainage)."""
    rng = np.random.default_rng(seed)
    B = (NCAT, NY, NX)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or B)
    hin = u(0.3, 2.5)
    hin[0, :2] = u(0.1, 0.2, 2, NX)
    hsn = u(0.0, 0.4)
    hsn[0, :2] = u(0.3, 0.5, 2, NX)           # flooded: snow on thin ice
    hsn[1, 4:] = 0.0                          # snow-free columns
    Tsf = u(-25.0, -1.0)
    Tsf[1, 3] = 0.0                           # melting surfaces
    Tbot = np.full(B, -1.8)
    zfrac = (np.arange(NILYR) + 0.5)[:, None, None, None] / NILYR
    Tin = Tsf[None] + (Tbot[None] - Tsf[None]) * zfrac
    zSin = u(2.0, 10.0, NILYR, *B)
    zqin = tmushy.enthalpy_mush(torch.as_tensor(np.minimum(Tin, -0.2)),
                                torch.as_tensor(zSin)).numpy()
    Tsn = np.minimum(Tsf, -0.5)[None]
    zqsn = -330.0 * (2.106e3 * -Tsn + 3.34e5) * np.ones((NSLYR,) + B)
    Sswabs = u(0.0, 10.0, NSLYR, *B)
    Iswabs = u(0.0, 5.0, NILYR, *B)
    return dict(
        rhoa=u(1.2, 1.4), flw=u(150.0, 320.0), potT=u(250.0, 275.0),
        Qa=u(5e-4, 3e-3), shcoef=u(1.0, 3.0), lhcoef=u(1.0, 4.0),
        fswsfc=u(0.0, 200.0),
        # the interior absorption is the sum of the layer absorptions, as
        # the radiation hands it over (energy closes)
        fswint=Sswabs.sum(0) + Iswabs.sum(0), Sswabs=Sswabs, Iswabs=Iswabs,
        hilyr=hin / NILYR, hslyr=hsn / NSLYR, zqin=zqin, zSin=zSin,
        zqsn=zqsn, hpond=u(0.0, 0.3), apond=u(0.0, 0.5), Tsf=Tsf, Tbot=Tbot,
        sss=u(30.0, 35.0), mask=u(0.0, 1.0) > 0.1)


def test_temperature_changes_salinity_matches():
    c = _column()
    kw = dict(nilyr=NILYR, nslyr=NSLYR, dSdt_slow_mode=-5.0e-8)
    ref = jmushy.temperature_changes_salinity(
        3600.0, **{k: jnp.asarray(v) for k, v in c.items()}, **kw)
    got = tmushy.temperature_changes_salinity(
        3600.0, **{k: torch.as_tensor(v) for k, v in c.items()}, **kw)
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
        else:
            assert_close(a, b, RTOL, name, floor=1e-6)
    assert bool(got.converged.any()) and got.niter >= 2
    # flooding, flushing and drainage all act on these columns
    assert float(got.snoice.max()) > 1e-3
    assert float((got.hpond - torch.as_tensor(c["hpond"])).abs().max()) > 0
    assert float((got.zSin - torch.as_tensor(c["zSin"])).abs().max()) > 1e-3


def test_picard_solver_counts_passes():
    """The Picard loop of each stage stops when every cell has converged
    or after nit_max passes, and reports the passes of both stages; in
    float32 it runs against the f32 convergence floor."""
    T = {k: torch.as_tensor(v) for k, v in _column(6).items()}
    capped = tmushy.temperature_changes_salinity(3600.0, nilyr=NILYR,
                                                 nslyr=NSLYR, nit_max=2, **T)
    assert 1 <= capped.niter <= 4
    full = tmushy.temperature_changes_salinity(3600.0, nilyr=NILYR,
                                               nslyr=NSLYR, **T)
    assert full.niter >= capped.niter
    assert int(full.converged.sum()) >= int(capped.converged.sum())
    T32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in T.items()}
    r32 = tmushy.temperature_changes_salinity(3600.0, nilyr=NILYR,
                                              nslyr=NSLYR, **T32)
    assert r32.Tsf.dtype == torch.float32
    assert int(r32.converged.sum()) >= int(full.converged.sum())


@pytest.mark.parametrize("sss", [34.0, 4.0])
def test_add_new_ice_mushy_matches(sss):
    """Mushy frazil (salinity sss - dSin0_frazil, or the fresh-water taper)
    with the age, first-year and level-ice tracers mixed into the grown
    ice; open water, thick-frazil spreading and no-open-water cells."""
    jcfg = gx1_parity_config()
    jtr = jbuild(jcfg)
    ttr = tbuild(convert.config_from_dict(dataclasses.asdict(jcfg)))
    hin_max = jitd.category_bounds(5, 1, 0)
    rng = np.random.default_rng(2)
    B = (5, NY, NX)
    aicen = rng.uniform(0.0, 0.25, B)
    aicen[:, 0] = 0.2                           # no open water
    vicen = aicen * rng.uniform(0.2, 3.0, B)
    trcrn = rng.uniform(0.0, 1.0, (5, jtr.ntrcr) + B[1:])
    trcrn[:, jtr.nt_Tsfc] = rng.uniform(-10.0, 0.0, B)
    trcrn[:, jtr.nt_qice:jtr.nt_qice + NILYR] = rng.uniform(
        -3.2e8, -2.5e8, (5, NILYR) + B[1:])
    trcrn[:, jtr.nt_iage] = rng.uniform(0.0, 3e7, B)
    aice = aicen.sum(0)
    frzmlt = rng.uniform(-20.0, 300.0, B[1:])
    frzmlt[1] = 2000.0                          # frazil thicker than hi0max
    cell = dict(aice=aice, aice0=np.clip(1.0 - aice, 0.0, None),
                frzmlt=frzmlt, Tf=np.full(B[1:], -1.8),
                sss=np.full(B[1:], sss))
    kw = dict(tr_FY=True, tr_lvl=True, tr_iage=True, ktherm=2,
              phi_init=0.75, dSin0_frazil=3.0)
    salinz = np.linspace(1.0, 3.0, NILYR)
    ref = jitd.add_new_ice(3600.0, jtr, hin_max, NILYR,
                           aicen=jnp.asarray(aicen), vicen=jnp.asarray(vicen),
                           trcrn=jnp.asarray(trcrn), salinz=salinz,
                           **{k: jnp.asarray(v) for k, v in cell.items()},
                           **kw)
    got = titd.add_new_ice(3600.0, ttr, hin_max, NILYR,
                           aicen=torch.as_tensor(aicen),
                           vicen=torch.as_tensor(vicen),
                           trcrn=torch.as_tensor(trcrn), salinz=salinz,
                           **{k: torch.as_tensor(v) for k, v in cell.items()},
                           **kw)
    for name in got._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name)
        if name == "trcrn":
            for it in range(a.shape[1]):
                assert_close(a[:, it], b[:, it], RTOL, f"trcrn[{it}]",
                             floor=1e-6)
        else:
            assert_close(a, b, RTOL, name, floor=1e-6)
    assert float(got.frazil.max()) > 0.0


def test_linear_itd_runs_with_one_category():
    """One category has no boundary to remap across: the state passes
    through (the JAX function fails there on an empty stack)."""
    cfg = convert.config_from_dict(dataclasses.asdict(
        gx1_parity_config(ncat=1)))
    tr = tbuild(cfg)
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.uniform(0.1, 0.9, (1, 3, 4)))
    v = a * 1.5
    trc = torch.as_tensor(rng.uniform(0.0, 1.0, (1, tr.ntrcr, 3, 4)))
    out = titd.linear_itd(tr, titd.category_bounds(1, 1, 0), 1,
                          aicen_init=a, vicen_init=v * 0.9, aicen=a,
                          vicen=v, vsnon=v * 0.1, trcrn=trc)
    assert torch.equal(out[1], v) and torch.allclose(out[3], trc)
