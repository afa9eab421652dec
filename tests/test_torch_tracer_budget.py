"""The global aerosol budget of whole steps of the port's ``Model`` on the
CPU in float64, as tests/test_conservation_aux.py holds the JAX package's
(test_full_step_aerosol_budget): with deposition zeroed, the change of
the aerosol mass in snow and ice over a step equals -faero_ocn * dt, to
rtol 1e-9, under forced melt-out (warm ocean and air on thin ice:
scavenging, lateral melt and the zaps) and under forced frazil growth
(cold, frzmlt > 0: the new ice dilutes the ice aerosols). No JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from cice5_tpu_torch.config import rect_config
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.models.thermo import itd

NA = 2


def _budget_model(frzmlt_val, Tair_val, sst_val, hi=None):
    """Full ice cover on a rectangular basin, no motion (winds and
    currents zeroed), aerosols on, float64, uniform forcing."""
    cfg = rect_config(ny=16, nx=24)
    cfg = cfg.replace(
        tracers=dataclasses.replace(cfg.tracers, tr_aero=True, n_aero=NA),
        dyn=dataclasses.replace(cfg.dyn, ndte=12),
        dtype="float64", accum_dtype="float64")
    m = Model(cfg, device="cpu")
    f = m.forcing_at(0)
    z = torch.zeros(m.grid.shape, dtype=torch.float64)
    f = f.replace(uatm=z, vatm=z, wind=z, uocn=z, vocn=z, ss_tltx=z,
                  ss_tlty=z, fsnow=z + 1e-6, frain=z, Tair=z + Tair_val,
                  potT=z + Tair_val, sst=z + sst_val, frzmlt=z + frzmlt_val,
                  faero_atm=torch.zeros((NA,) + m.grid.shape,
                                        dtype=torch.float64))
    st = m.init_state(ice_mask=m.grid.tmask)
    if hi is not None:     # thin ice, for a fast melt-out
        st = st.replace(vicen=st.aicen * hi, vsnon=st.aicen * 0.02)
    a0 = m.tr.nt_aero
    trcrn = st.trcrn.clone()
    trcrn[:, a0:a0 + 4 * NA] = 1.0e-8
    return m, st.replace(trcrn=trcrn), f


def _global_aero_mass(m, st):
    return itd._aero_mass_per_cat(m.tr, st.vicen, st.vsnon,
                                  st.trcrn).sum((1, 2, 3)).numpy()


@pytest.mark.parametrize("scenario", ["meltout", "frazil"])
def test_full_step_aerosol_budget(scenario):
    if scenario == "meltout":
        m, st, f = _budget_model(frzmlt_val=-400.0, Tair_val=278.0,
                                 sst_val=1.0, hi=0.06)
    else:
        m, st, f = _budget_model(frzmlt_val=400.0, Tair_val=250.0,
                                 sst_val=-1.8)
    melted = False
    m_init = _global_aero_mass(m, st)
    for _ in range(4):
        m0 = _global_aero_mass(m, st)
        st, diag = m.step(st, f)
        m1 = _global_aero_mass(m, st)
        sink = diag.faero_ocn.sum((1, 2)).numpy() * m.cfg.time.dt
        np.testing.assert_allclose(m1 - m0, -sink, rtol=1e-9,
                                   atol=1e-13 * max(1.0, m0.max() * 1e8))
        melted = melted or sink.max() > 0.0
    if scenario == "meltout":
        assert melted          # the scenario exercised the sink
        assert _global_aero_mass(m, st).sum() < m_init.sum()
    else:
        assert float(diag.frazil.max()) > 0.0
