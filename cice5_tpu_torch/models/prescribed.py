"""Prescribed-ice mode (PyTorch port of ``cice5_tpu/models/prescribed.py``;
reference drivers/cesm/ice_prescribed_mod.F90).

For AMIP-style runs the ice concentration is read from data instead of
being prognostic: each coupling step ``ice_prescribed_phys`` (:377-520)
overwrites the state so the category containing the prescribed hemispheric
thickness (2 m NH / 1 m SH) carries the data concentration, freshly formed
cells get a linear temperature/BL99-salinity profile, and cells where the
data says ice-free are zeroed. Dynamics and ridging are turned off by the
caller (kdyn=0); thermodynamics still runs so surface fluxes respond to
the prescribed cover. No step calls it: it is a library function between
steps.

The salinity profile's scalars stay Python floats, so every value is
computed in the state's dtype (the JAX function computes the enthalpy
profile in float64 and scatters it into a float32 state).
"""
from __future__ import annotations

import numpy as np
import torch

from cice5_tpu_torch import constants as ct

EPS04 = 1.0e-4
HI_NH = 2.0       # prescribed ice thickness north of 40N (m)
HI_SH = 1.0       # prescribed south of 40S


def prescribe_ice(state, ice_cov, grid, tr, cfg, hin_max, Tf):
    """Overwrite the prognostic state with the prescribed concentration
    (ice_prescribed_phys :377-520). ice_cov: (ny, nx) data concentration,
    Tf: (ny, nx) freezing temperature, both tensors on the state's device.
    Returns the updated State."""
    nilyr, nslyr, ncat = cfg.nilyr, cfg.nslyr, cfg.ncat
    dtype = state.aicen.dtype
    tmask = grid.tmask
    cov = torch.where(tmask, torch.clamp(ice_cov, 0.0, 1.0), 0.0)
    cov = torch.where(cov < EPS04, 0.0, cov)

    tlat_deg = torch.rad2deg(grid.TLAT)
    zero = torch.zeros((), dtype=dtype, device=cov.device)
    hi = torch.where(tlat_deg > 40.0, HI_NH,
                     torch.where(tlat_deg < -40.0, HI_SH, zero)).to(dtype)
    has = cov >= EPS04

    aicen, vicen, vsnon = state.aicen, state.vicen, state.vsnon
    trcrn = state.trcrn.clone()
    aice_old = aicen.sum(0)
    Tsfc = trcrn[:, tr.nt_Tsfc]

    new_a, new_v, new_s = [], [], []
    for n in range(ncat):
        incat = has & (float(hin_max[n]) < hi) & (hi < float(hin_max[n + 1]))
        hs = torch.where(aicen[n] > 0.0,
                         vsnon[n] / torch.clamp(aicen[n], min=ct.puny), 0.0)
        new_a.append(torch.where(incat, cov,
                                 torch.where(has, aicen[n], 0.0)))
        new_v.append(torch.where(incat, hi * cov,
                                 torch.where(has, vicen[n], 0.0)))
        new_s.append(torch.where(incat, hs * cov,
                                 torch.where(has, vsnon[n], 0.0)))
    aicen_n = torch.stack(new_a)
    vicen_n = torch.stack(new_v)
    vsnon_n = torch.stack(new_s)

    # freshly covered cells (no prior ice): initialize thermodynamic
    # profile (:473-520)
    fresh_cell = has & (aice_old < ct.puny)
    Tsfc_n = torch.where(fresh_cell[None], Tf[None], Tsfc)
    Tsfc_n = torch.where(has[None], Tsfc_n, Tf[None])
    trcrn[:, tr.nt_Tsfc] = Tsfc_n

    slope = Tf[None] - Tsfc_n
    init_cols = fresh_cell[None] & (aicen_n > 0.0)
    for k in range(nilyr):
        zn = (k + 0.5) / nilyr
        Ti = Tsfc_n + slope * zn
        salin = (3.2 / 2.0) * (1.0 - float(np.cos(
            np.pi * zn ** (0.407 / (0.573 + zn)))))
        Tmlt = -salin * ct.depressT
        # a tensor numerator: PyTorch computes number / tensor as
        # number * reciprocal(tensor), 1 ulp off the quotient
        qin = -(ct.rhoi * (ct.cp_ice * (Tmlt - Ti)
                           + ct.Lfresh * (1.0 - torch.full_like(Ti, Tmlt)
                                          / torch.clamp(Ti, max=-ct.puny))
                           - ct.cp_ocn * Tmlt))
        ks, kq = tr.nt_sice + k, tr.nt_qice + k
        trcrn[:, ks] = torch.where(
            init_cols, salin, torch.where(has[None], trcrn[:, ks], zero))
        trcrn[:, kq] = torch.where(
            init_cols, qin, torch.where(has[None], trcrn[:, kq], zero))
    qsn = -ct.rhos * (ct.Lfresh - ct.cp_ice * Tsfc_n)
    empty = torch.full((), -ct.rhos * ct.Lfresh, dtype=dtype,
                       device=cov.device)
    for k in range(nslyr):
        kq = tr.nt_qsno + k
        trcrn[:, kq] = torch.where(
            init_cols, qsn, torch.where(has[None], trcrn[:, kq], empty))

    return state.replace(aicen=aicen_n, vicen=vicen_n, vsnon=vsnon_n,
                         trcrn=trcrn, frzmlt=torch.zeros_like(state.frzmlt))
