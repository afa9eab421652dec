"""Shared thermodynamic relations (PyTorch port of
``cice5_tpu/models/thermo/shared.py``; ice_therm_shared.F90 and the
enthalpy relations of ice_therm_bl99/vertical). Elementwise over any batch
shape. Temperatures in deg C, enthalpies J/m^3 (negative: energy needed to
melt), salinities ppt.
"""
from __future__ import annotations

import numpy as np
import torch

from reference.cice import constants as ct

ferrmax = 1.0e-3      # max allowed energy flux error, W/m^2 (ice_therm_shared.F90:31)
min_salin = 0.1       # threshold bulk salinity for brine effects (ppt)
betak = 0.13          # MU71 conductivity constant (ice_therm_bl99.F90:27)
kimin = 0.10          # min saline-ice conductivity (ice_therm_bl99.F90:28)


def snow_enthalpy(Tsn):
    """q_snow(T) = -rhos (Lfresh - cp_ice T)   [J/m^3]."""
    return -ct.rhos * (ct.Lfresh - ct.cp_ice * Tsn)


def snow_temperature(qsn):
    """Inverse of snow_enthalpy."""
    return (ct.Lfresh + qsn / ct.rhos) / ct.cp_ice


def ice_enthalpy(Tin, Tmlt, l_brine: bool = True):
    """BL99 sea-ice enthalpy:
    q = -rhoi [cp_ice (Tmlt - T) + Lfresh (1 - Tmlt/T) - cp_ocn Tmlt]."""
    if not l_brine:
        return -ct.rhoi * (-ct.cp_ice * Tin + ct.Lfresh)
    T = torch.clamp(Tin, max=-ct.puny)
    return -ct.rhoi * (ct.cp_ice * (Tmlt - T)
                       + ct.Lfresh * (1.0 - Tmlt / T)
                       - ct.cp_ocn * Tmlt)


def calculate_Tin_from_qin(qin, Tmlt, l_brine: bool = True):
    """Invert the enthalpy relation via the quadratic formula
    (ice_therm_shared.F90:62-90)."""
    if not l_brine:
        return (ct.Lfresh + qin / ct.rhoi) / ct.cp_ice
    aa1 = ct.cp_ice
    bb1 = (ct.cp_ocn - ct.cp_ice) * Tmlt - qin / ct.rhoi - ct.Lfresh
    cc1 = ct.Lfresh * Tmlt
    disc = torch.clamp(bb1 * bb1 - 4.0 * aa1 * cc1, min=0.0)
    return torch.minimum((-bb1 - torch.sqrt(disc)) / (2.0 * aa1), Tmlt)


def surface_heat_flux(Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef):
    """Net surface flux and its components (ice_therm_shared.F90:98-158).
    Returns (flwoutn, fsensn, flatn, fsurfn)."""
    TsfK = Tsf + ct.Tffresh
    inv = 1.0 / TsfK
    qsat = ct.qqqice * torch.exp(-ct.TTTice * inv)
    Qsfc = qsat / rhoa
    flwdabs = ct.emissivity * flw
    flwoutn = -ct.emissivity * ct.stefan_boltzmann * TsfK ** 4
    fsensn = shcoef * (potT - TsfK)
    flatn = lhcoef * (Qa - Qsfc)
    fsurfn = fswsfc + flwdabs + flwoutn + fsensn + flatn
    return flwoutn, fsensn, flatn, fsurfn


def dsurface_heat_flux_dTsf(Tsf, rhoa, shcoef, lhcoef):
    """d(fluxes)/dTsf (ice_therm_shared.F90:163-226).
    Returns (dfsurf_dT, dflwout_dT, dfsens_dT, dflat_dT)."""
    TsfK = Tsf + ct.Tffresh
    inv = 1.0 / TsfK
    qsat = ct.qqqice * torch.exp(-ct.TTTice * inv)
    dQsfc_dTsf = ct.TTTice * inv * inv * (qsat / rhoa)
    dflwout = -ct.emissivity * ct.stefan_boltzmann * 4.0 * TsfK ** 3
    dfsens = -shcoef
    dflat = -lhcoef * dQsfc_dTsf
    return dflwout + dfsens + dflat, dflwout, dfsens, dflat


def salinity_profile(nilyr: int, saltmax: float, nsal: float = 0.407,
                     msal: float = 0.573) -> np.ndarray:
    """BL99 fixed salinity profile at layer midpoints
    (ice_therm_vertical.F90:577-586), float64 NumPy on the host."""
    k = np.arange(1, nilyr + 1)
    z = (k - 0.5) / nilyr
    sal = 0.5 * saltmax * (1.0 - np.cos(np.pi * z ** (nsal / (msal + z))))
    return np.maximum(sal, min_salin)
