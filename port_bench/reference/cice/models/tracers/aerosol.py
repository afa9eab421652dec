"""Aerosol tracers in snow and ice (PyTorch port of
``cice5_tpu/models/tracers/aerosol.py``; reference ice_aerosol.F90).

Each aerosol species carries four mass tracers per category: snow surface
scattering layer (SSL), snow interior, ice SSL, ice interior (kg/m^3 of
vsno/vice; ice_aerosol.F90:303-312). ``update_aerosol``
(ice_aerosol.F90:366-604) replays the thermodynamic thickness changes of
the step (evaporation, congelation, surface/basal melt, snowfall,
snow-ice) on the four-layer column, scavenges aerosol into the ocean with
the melt water and re-grids the SSL/interior split to the new
thicknesses. Every stage is masked arithmetic over all cells; the n_aero
species ride a leading axis. The surface-layer thicknesses of an empty
column are zero: every division by a thickness is guarded by its own
``> puny`` mask and a clamped denominator.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.utils import device_values

# scavenging fractions per species (ice_aerosol.F90:250-253)
KSCAV = (0.03, 0.20, 0.02, 0.02, 0.01, 0.01)
# surface scattering layer thicknesses (ice_shortwave.F90:139-140)
HI_SSL = 0.050
HS_SSL = 0.040


def faero_default(n_aero: int, shape, dtype=torch.float32, device=None):
    """Constant atmospheric deposition rates (ice_aerosol.F90:55-63):
    1e-15 / 1e-13 / 1e-11 kg/m^2/s for species 1..3 (then repeating)."""
    return torch.stack([torch.full(tuple(shape), 10.0 ** (-15 + 2 * (k % 3)),
                                   dtype=dtype, device=device)
                        for k in range(n_aero)])


class AerosolResult(NamedTuple):
    aerosno: torch.Tensor    # (n_aero, 2, ...) kg/m^3 snow tracers
    aeroice: torch.Tensor    # (n_aero, 2, ...) kg/m^3 ice tracers
    faero_ocn: torch.Tensor  # (n_aero, ...) flux to the ocean (kg/m^2/s)


def _pd(x):
    return torch.clamp(x, min=ct.puny)


def _layers(a, b):
    """(n_aero, 2, ...) from the two layer stacks (n_aero, ...)."""
    return torch.stack([a, b], dim=1)


def _scav_melt(aero, dz_ssl, dz_int, dmelt, kscav, active):
    """Melt-water scavenging from a 2-layer stack (ice_aerosol.F90:330-346,
    surface-melt form): fractional loss kscav * melted fraction per layer.
    Returns (new aero, mass lost to the ocean)."""
    loss1 = torch.where((dz_ssl > ct.puny) & active,
                        kscav * aero[:, 0] * torch.minimum(dmelt, dz_ssl)
                        / _pd(dz_ssl), 0.0)
    loss2 = torch.where((dz_int > ct.puny) & active,
                        kscav * aero[:, 1]
                        * torch.clamp(dmelt - dz_ssl, min=0.0)
                        / _pd(dz_int), 0.0)
    return _layers(aero[:, 0] - loss1, aero[:, 1] - loss2), loss1 + loss2


def update_aerosol(dt, meltt, melts, meltb, congel, snoice, fsnow,
                   aerosno, aeroice, aice_old, vice_old, vsno_old,
                   aicen, vicen, vsnon, faero_atm, nilyr: int,
                   nslyr: int) -> AerosolResult:
    """Per-category aerosol column update (ice_aerosol.F90:366-604).

    aerosno/aeroice: (n_aero, 2, ...) tracer concentrations (kg/m^3).
    faero_atm: (n_aero, ...) deposition rate. The melt/growth arguments
    are this step's per-category diagnostics (m)."""
    n_aero = aerosno.shape[0]
    kscav = device_values(KSCAV[:n_aero], dtype=aerosno.dtype,
                          device=aerosno.device)
    kscav = kscav.reshape((n_aero,) + (1,) * (aerosno.ndim - 2))
    active = aice_old > ct.puny
    sm = active.to(aerosno.dtype)

    ar_old = 1.0 / _pd(aice_old)
    hs_old = vsno_old * ar_old
    hi_old = vice_old * ar_old
    dzssl = torch.clamp(hs_old / (2.0 * nslyr), max=HS_SSL)
    dzssli = torch.clamp(hi_old / (2.0 * nilyr), max=HI_SSL)
    dzint = hs_old - dzssl
    dzinti = hi_old - dzssli

    # new thicknesses; a vanished category is normalized by its old area
    # (ice_aerosol.F90:280-287)
    ar = torch.where(aicen > 0.0, 1.0 / _pd(aicen), ar_old)
    hs = vsnon * ar
    hi = vicen * ar

    dhs_melts = -melts
    dhi_snoice = snoice
    dhs_snoice = dhi_snoice * ct.rhoi / ct.rhos
    dhi_meltt = -meltt
    dhi_meltb = -meltb
    dhi_congel = congel
    dhs_evap = hs - (hs_old + dhs_melts - dhs_snoice + fsnow / ct.rhos * dt)
    dhi_evap = hi - (hi_old + dhi_meltt + dhi_meltb + dhi_congel
                     + dhi_snoice)

    # tracers -> masses (kg/m^2 of grid-cell area), ice_aerosol.F90:303-310
    aerosno = aerosno * vsno_old[None, None]
    aeroice = aeroice * vice_old[None, None]

    # evaporation (ice_aerosol.F90:315-319)
    dzint = dzint + torch.clamp(dzssl + dhs_evap, max=0.0)
    dzinti = dzinti + torch.clamp(dzssli + dhi_evap, max=0.0)
    dzssl = torch.clamp(dzssl + dhs_evap, min=0.0)
    dzssli = torch.clamp(dzssli + dhi_evap, min=0.0)

    # basal ice growth (ice_aerosol.F90:324)
    dzinti = dzinti + dhi_congel

    # surface snow melt (ice_aerosol.F90:329-360)
    melting = (-dhs_melts > ct.puny) & active
    new_sno, lost = _scav_melt(aerosno, dzssl, dzint, -dhs_melts, kscav,
                               melting)
    aerosno = torch.where(melting[None, None], new_sno, aerosno)
    focn = torch.where(melting[None], lost / dt, 0.0)
    dzint_m = dzint + torch.clamp(dzssl + dhs_melts, max=0.0)
    dzssl_m = torch.clamp(dzssl + dhs_melts, min=0.0)
    dzint = torch.where(melting, dzint_m, dzint)
    dzssl = torch.where(melting, dzssl_m, dzssl)
    # the SSL melts away: it merges into the interior
    gone_ssl = melting & (dzssl <= ct.puny)
    aerosno = torch.where(gone_ssl[None, None], _layers(
        torch.zeros_like(aerosno[:, 0]), aerosno[:, 0] + aerosno[:, 1]),
        aerosno)
    # all the snow melts away: into the ice SSL
    gone_sno = melting & (dzint <= ct.puny)
    aeroice = torch.where(gone_sno[None, None], _layers(
        aeroice[:, 0] + aerosno[:, 0] + aerosno[:, 1], aeroice[:, 1]),
        aeroice)
    aerosno = torch.where(gone_sno[None, None], 0.0, aerosno)
    dzssl = torch.clamp(dzssl, min=0.0)
    dzint = torch.clamp(dzint, min=0.0)

    # surface ice melt (ice_aerosol.F90:365-395)
    imelt = (-dhi_meltt > ct.puny) & active
    new_ice, lost = _scav_melt(aeroice, dzssli, dzinti, -dhi_meltt, kscav,
                               imelt)
    aeroice = torch.where(imelt[None, None], new_ice, aeroice)
    focn = focn + torch.where(imelt[None], lost / dt, 0.0)
    dzinti_m = dzinti + torch.clamp(dzssli + dhi_meltt, max=0.0)
    dzssli_m = torch.clamp(dzssli + dhi_meltt, min=0.0)
    dzinti = torch.where(imelt, dzinti_m, dzinti)
    dzssli = torch.where(imelt, dzssli_m, dzssli)
    gone_issl = imelt & (dzssli <= ct.puny)
    aeroice = torch.where(gone_issl[None, None], _layers(
        torch.zeros_like(aeroice[:, 0]), aeroice[:, 0] + aeroice[:, 1]),
        aeroice)
    gone_ice = imelt & (dzinti <= ct.puny)
    focn = focn + torch.where(gone_ice[None],
                              (aeroice[:, 0] + aeroice[:, 1]) / dt, 0.0)
    aeroice = torch.where(gone_ice[None, None], 0.0, aeroice)
    dzssli = torch.clamp(dzssli, min=0.0)
    dzinti = torch.clamp(dzinti, min=0.0)

    # basal ice melt: all the aerosol of the melted ice is lost
    # (ice_aerosol.F90:400-419)
    bmelt = (-dhi_meltb > ct.puny) & active
    loss1 = torch.where((dzssli > ct.puny) & bmelt,
                        torch.clamp(-dhi_meltb - dzinti, min=0.0)
                        * aeroice[:, 0] / _pd(dzssli), 0.0)
    loss2 = torch.where((dzinti > ct.puny) & bmelt,
                        torch.minimum(-dhi_meltb, dzinti)
                        * aeroice[:, 1] / _pd(dzinti), 0.0)
    aeroice = _layers(aeroice[:, 0] - loss1, aeroice[:, 1] - loss2)
    focn = focn + (loss1 + loss2) / dt
    dzssli = torch.where(bmelt, dzssli + torch.clamp(dzinti + dhi_meltb,
                                                     max=0.0), dzssli)
    dzinti = torch.where(bmelt, torch.clamp(dzinti + dhi_meltb, min=0.0),
                         dzinti)

    # snowfall adds to the snow SSL (ice_aerosol.F90:424)
    dzssl = dzssl + torch.where(fsnow > 0.0, fsnow / ct.rhos * dt,
                                0.0) * sm

    # snow-ice formation (ice_aerosol.F90:429-449)
    sif = (dhs_snoice > ct.puny) & active
    loss2 = torch.where((dzint > ct.puny) & sif,
                        torch.minimum(dhs_snoice, dzint)
                        * aerosno[:, 1] / _pd(dzint), 0.0)
    loss1 = torch.where((dzssl > ct.puny) & sif,
                        torch.clamp(dhs_snoice - dzint, min=0.0)
                        * aerosno[:, 0] / _pd(dzssl), 0.0)
    aerosno = _layers(aerosno[:, 0] - loss1, aerosno[:, 1] - loss2)
    aeroice = _layers(aeroice[:, 0] + (1.0 - kscav) * (loss1 + loss2),
                      aeroice[:, 1])
    focn = focn + kscav * (loss1 + loss2) / dt
    dzssl = torch.where(sif, dzssl - torch.clamp(dhs_snoice - dzint,
                                                 min=0.0), dzssl)
    dzint = torch.where(sif, torch.clamp(dzint - dhs_snoice, min=0.0), dzint)
    dzssli = torch.where(sif, dzssli + dhi_snoice, dzssli)

    # atmospheric deposition (ice_aerosol.F90:454-468): into the snow SSL
    # when there is snow, else the ice SSL
    hs_dep = torch.where(aicen > 0.0, vsnon * ar, 0.0)
    dep = faero_atm * (dt * aicen)[None] * sm[None]
    to_snow = (hs_dep > ct.hs_min)[None]
    aerosno = _layers(aerosno[:, 0] + torch.where(to_snow, dep, 0.0),
                      aerosno[:, 1])
    aeroice = _layers(aeroice[:, 0] + torch.where(to_snow, 0.0, dep),
                      aeroice[:, 1])

    # re-grid to the new SSL/interior split (ice_aerosol.F90:473-548)
    hs_new = torch.where(aicen > 0.0, vsnon * ar, 0.0)
    hi_new = torch.where(aicen > 0.0, vicen * ar, 0.0)
    # collapse empty layers downward
    e1 = active & (dzssl <= ct.puny)
    aerosno = torch.where(e1[None, None], _layers(
        torch.zeros_like(aerosno[:, 0]), aerosno[:, 0] + aerosno[:, 1]),
        aerosno)
    e2 = active & (dzint <= ct.puny)
    aeroice = torch.where(e2[None, None], _layers(
        aeroice[:, 0] + aerosno[:, 1], aeroice[:, 1]), aeroice)
    aerosno = torch.where(e2[None, None], _layers(
        aerosno[:, 0], torch.zeros_like(aerosno[:, 1])), aerosno)
    e3 = active & (dzssli <= ct.puny)
    aeroice = torch.where(e3[None, None], _layers(
        torch.zeros_like(aeroice[:, 0]), aeroice[:, 0] + aeroice[:, 1]),
        aeroice)
    e4 = active & (dzinti <= ct.puny)
    focn = focn + torch.where(e4[None], (aeroice[:, 0] + aeroice[:, 1]) / dt,
                              0.0)
    aeroice = torch.where(e4[None, None], 0.0, aeroice)

    dzssl_new = torch.clamp(hs_new / (2.0 * nslyr), max=HS_SSL)
    dzssli_new = torch.clamp(hi_new / (2.0 * nilyr), max=HI_SSL)

    # snow: move mass across the new SSL boundary
    snow_ok = active & (hs_new > ct.hs_min)
    sl = (torch.where(dzssl > ct.puny,
                      torch.clamp(dzssl_new - dzssl, max=0.0)
                      * aerosno[:, 0] / _pd(dzssl), 0.0)
          + torch.where(dzint > ct.puny,
                        torch.clamp(dzssl_new - dzssl, min=0.0)
                        * aerosno[:, 1] / _pd(dzint), 0.0))
    aerosno = torch.where(snow_ok[None, None], _layers(
        aerosno[:, 0] + sl, aerosno[:, 1] - sl), aerosno)
    no_snow = active & ~(hs_new > ct.hs_min)
    aeroice = torch.where(no_snow[None, None], _layers(
        aeroice[:, 0] + aerosno[:, 0] + aerosno[:, 1], aeroice[:, 1]),
        aeroice)
    aerosno = torch.where(no_snow[None, None], 0.0, aerosno)

    # ice: move mass across the new SSL boundary
    ice_ok = active & (vicen > ct.puny)
    sl = (torch.where(dzssli > ct.puny,
                      torch.clamp(dzssli_new - dzssli, max=0.0)
                      * aeroice[:, 0] / _pd(dzssli), 0.0)
          + torch.where(dzinti > ct.puny,
                        torch.clamp(dzssli_new - dzssli, min=0.0)
                        * aeroice[:, 1] / _pd(dzinti), 0.0))
    aeroice = torch.where(ice_ok[None, None], _layers(
        aeroice[:, 0] + sl, aeroice[:, 1] - sl), aeroice)
    no_ice = active & ~(vicen > ct.puny)
    focn = focn + torch.where(no_ice[None],
                              (aeroice[:, 0] + aeroice[:, 1]) / dt, 0.0)
    aeroice = torch.where(no_ice[None, None], 0.0, aeroice)

    # masses back to concentrations (ice_aerosol.F90:568-578)
    aerosno = torch.where((vsnon > ct.puny)[None, None],
                          aerosno / _pd(vsnon)[None, None], aerosno)
    aeroice = torch.where((vicen > ct.puny)[None, None],
                          aeroice / _pd(vicen)[None, None], aeroice)
    return AerosolResult(aerosno=aerosno, aeroice=aeroice, faero_ocn=focn)
