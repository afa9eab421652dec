"""The default initial state (a frozen copy of the port's
``driver/model.py`` ``initial_itd`` and ``init_state``: ice_init.F90:1475-1813
set_state_var, ice at cold high latitudes with a parabolic ITD centred
on hbar=3 m)."""
from __future__ import annotations

import numpy as np
import torch

from reference.cice import constants as ct
from reference.cice.config import ModelConfig
from reference.cice.grid import Grid
from reference.cice.models.thermo import shared as thshared
from reference.cice.state import zeros_state

EDGE_INIT_NH = 70.0
EDGE_INIT_SH = -60.0
HSNO_INIT = 0.20


def initial_itd(cfg: ModelConfig, hin_max):
    """Parabolic initial category areas/thicknesses
    (ice_init.F90:1617-1635)."""
    hbar = 3.0
    hinit = np.zeros(cfg.ncat)
    ainit = np.zeros(cfg.ncat)
    for n in range(cfg.ncat):
        if n < cfg.ncat - 1:
            hinit[n] = 0.5 * (hin_max[n] + hin_max[n + 1])
        else:
            hinit[n] = hin_max[n] + 1.0
        ainit[n] = max(0.0, 2.0 * hbar * hinit[n] - hinit[n] ** 2)
    ainit /= ainit.sum() + ct.puny / cfg.ncat
    return ainit, hinit


def init_state(cfg: ModelConfig, grid: Grid, tr, hin_max, salinz,
               Tair=None, sst=None, ice_mask=None) -> State:
    """Default initial state (ice_init.F90:1475-1813 set_state_var).
    ice_mask: boolean (ny, nx) array or tensor; default ice poleward of
    70N / 60S on ocean cells."""
    device = grid.hm.device
    kw = dict(dtype=cfg.xp_dtype, device=device)
    st = zeros_state(cfg, tr, device=device)
    sss = 34.0
    Tf = -ct.depressT * sss

    tmask = grid.tmask
    if ice_mask is None:
        ulat_deg = torch.rad2deg(grid.ULAT)
        ice_mask = tmask & ((ulat_deg > EDGE_INIT_NH)
                            | (ulat_deg < EDGE_INIT_SH))
    msk = torch.as_tensor(np.asarray(ice_mask) if not torch.is_tensor(
        ice_mask) else ice_mask, device=device).to(torch.bool)

    ainit, hinit = initial_itd(cfg, hin_max)
    a0 = torch.as_tensor(ainit, **kw)[:, None, None]
    v0 = torch.as_tensor(ainit * hinit, **kw)[:, None, None]
    aicen = torch.where(msk[None], a0, 0.0)
    vicen = torch.where(msk[None], v0, 0.0)
    vsnon = torch.minimum(aicen * HSNO_INIT, 0.2 * vicen)

    TairC = (Tair - ct.Tffresh) if Tair is not None else \
        torch.tensor(-15.0, **kw)
    Tsfc0 = torch.clamp(TairC, max=ct.Tsmelt)
    trcrn = st.trcrn.clone()
    trcrn[:, tr.nt_Tsfc] = torch.where(msk[None], Tsfc0, Tf)
    sal = torch.as_tensor(salinz, **kw)
    Tmltz = -sal * ct.depressT
    zero_layer = cfg.thermo.ktherm == 0     # latent heat only
    for k in range(cfg.nilyr):
        zfrac = (k + 0.5) / cfg.nilyr
        Ti = torch.minimum(Tsfc0 + (Tf - Tsfc0) * zfrac, Tmltz[k] - 0.1)
        qk = thshared.ice_enthalpy(Ti, Tmltz[k])
        if zero_layer:
            qk = torch.full_like(qk, -ct.rhoi * ct.Lfresh)
        trcrn[:, tr.nt_qice + k] = torch.where(msk[None], qk, 0.0)
        trcrn[:, tr.nt_sice + k] = torch.where(msk[None], sal[k], 0.0)
    qs = thshared.snow_enthalpy(torch.clamp(Tsfc0, max=-1.0))
    if zero_layer:
        qs = torch.full_like(qs, -ct.rhos * ct.Lfresh)
    for k in range(cfg.nslyr):
        trcrn[:, tr.nt_qsno + k] = torch.where(msk[None], qs,
                                               -ct.rhos * ct.Lfresh)
    if tr.nt_alvl >= 0:
        trcrn[:, tr.nt_alvl] = torch.where(msk[None], 1.0, 0.0)
        trcrn[:, tr.nt_vlvl] = torch.where(msk[None], 1.0, 0.0)
    if tr.nt_fbri >= 0:
        trcrn[:, tr.nt_fbri] = 1.0
    sst0 = torch.full(grid.shape, Tf, **kw) if sst is None else sst
    return st.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                      sst=sst0 * tmask.to(cfg.xp_dtype))
