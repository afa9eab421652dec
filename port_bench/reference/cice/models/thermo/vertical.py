"""Vertical thermodynamics driver: growth, melt and state update (PyTorch
port of ``cice5_tpu/models/thermo/vertical.py``: the zero-layer
(ktherm=0), BL99 (ktherm=1) and mushy (ktherm=2) branches, and the
coupler's prescribed surface fluxes of calc_Tsfc=False).

ice_therm_vertical.F90: thermo_vertical :73, frzmlt_bottom_lateral :611,
thickness_changes :1283, freeboard :2031, adjust_enthalpy :2177,
update_state_vthermo :2417. Dense over any batch shape *B (here all
categories at once, B = (ncat, ny, nx)), layer axis first, with masked
no-ops for ice-free cells. The layer repartition is a branch-free
overlap matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.models.thermo import bl99, mushy, shared, zerolayer
from reference.cice.utils import with_index

# lateral melt parameters (ice_therm_vertical.F90:1352-1360)
FLOEDIAM = 300.0
FLOESHAPE = 0.66
M1 = 1.6e-6
M2 = 1.36
QBOTMAX = -0.5 * ct.rhoi * ct.Lfresh



def frzmlt_bottom_lateral(dt, aice, frzmlt, vicen, vsnon, qicen_tot,
                          qsnon_tot, sst, Tf, strocnxT, strocnyT,
                          ustar_min=0.0005, Cdn_ocn=None):
    """Ocean-ice bottom heat flux, bottom temperature and lateral-melt
    fraction (ice_therm_vertical.F90:611-837). qicen_tot/qsnon_tot:
    per-category column energies (ncat, *B). Cdn_ocn: the form-drag ocean
    exchange coefficient replacing the 0.006 McPhee/Maykut constant when
    fbot_xfer_type='Cdn_ocn' (ice_therm_vertical.F90:741-746). Returns
    (Tbot, fbot, rside).
    """
    Tbot = Tf
    melt = (aice > ct.puny) & (frzmlt < 0.0)
    deltaT = torch.clamp(sst - Tbot, min=0.0)
    ustar = torch.sqrt(torch.sqrt(strocnxT ** 2 + strocnyT ** 2) / ct.rhow)
    ustar = torch.clamp(ustar, min=ustar_min)
    chio = 0.006 if Cdn_ocn is None else Cdn_ocn
    cpchr = -ct.cp_ocn * ct.rhow * chio
    fbot = cpchr * deltaT * ustar
    fbot = torch.maximum(fbot, frzmlt)          # frzmlt < fbot < 0

    wlat = M1 * deltaT ** M2
    rside = torch.clamp(wlat * dt * ct.pi / (FLOESHAPE * FLOEDIAM), 0.0, 1.0)

    etot = (qsnon_tot + qicen_tot).sum(0)
    fside = rside * etot / dt

    xtmp = torch.clamp(frzmlt / (fbot + fside + ct.puny), max=1.0)
    fbot = torch.where(melt, fbot * xtmp, 0.0)
    rside = torch.where(melt, rside * xtmp, 0.0)
    return Tbot, fbot, rside


def adjust_enthalpy(z1, z2, hlyr, hn, qn):
    """Conservative repartition onto equal layers
    (ice_therm_vertical.F90:2177-2281). z1, z2: (nlyr+1, *B) old/new
    interface depths; qn: (nlyr, *B)."""
    rhlyr = torch.where(hn > ct.puny, 1.0 / torch.clamp(hlyr, min=1e-30),
                        0.0)
    z1_lo = z1[:-1][None, :]
    z1_hi = z1[1:][None, :]
    z2_lo = z2[:-1][:, None]
    z2_hi = z2[1:][:, None]
    hovlp = torch.clamp(torch.minimum(z1_hi, z2_hi)
                        - torch.maximum(z1_lo, z2_lo), min=0.0)
    hq = (hovlp * qn[None, :]).sum(1)
    return hq * rhlyr[None]


def _interface_depths(dz):
    """(nlyr, *B) layer thicknesses -> (nlyr+1, *B) interface depths."""
    return torch.cat([torch.zeros_like(dz[:1]), torch.cumsum(dz, dim=0)],
                     dim=0)


class ThicknessResult(NamedTuple):
    hin: torch.Tensor
    hsn: torch.Tensor
    hilyr: torch.Tensor
    hslyr: torch.Tensor
    zqin: torch.Tensor
    zqsn: torch.Tensor
    zSin: torch.Tensor
    efinal: torch.Tensor
    fhocnn: torch.Tensor
    evapn: torch.Tensor
    hsn_new: torch.Tensor
    meltt: torch.Tensor
    melts: torch.Tensor
    meltb: torch.Tensor
    congel: torch.Tensor
    snoice: torch.Tensor
    dsnow: torch.Tensor


def thickness_changes(dt, *, nilyr, nslyr, l_brine, hilyr, hslyr, zqin,
                      zqsn, zSin, fbot, Tbot, flatn, fsurfn, fcondtopn,
                      fcondbot, fsnow, ktherm=1, sss=None,
                      phi_i_mushy=0.85) -> ThicknessResult:
    """Growth/melt at all surfaces + snowfall + freeboard + repartition
    (ice_therm_vertical.F90:1283-2028), zero-layer (ktherm=0: new ice
    carries the latent enthalpy only), BL99 (ktherm=1) or mushy (ktherm=2:
    melting enthalpy of the salty ice, prognostic salinity, freeboard
    handled by the mushy solver's flood_ice)."""
    mushy_on = ktherm == 2
    B = tuple(hilyr.shape)
    dzi = torch.broadcast_to(hilyr, (nilyr,) + B).clone()
    dzs = torch.broadcast_to(hslyr, (nslyr,) + B).clone()
    zero = torch.zeros(B, dtype=zqin.dtype, device=zqin.device)
    meltt = melts = meltb = congel = snoice = evapn = zero
    emlt_atm = emlt_ocn = zero
    if mushy_on:
        qmlt = mushy.enthalpy_of_melting(zSin)
        qm = zqin - qmlt
    else:
        qm = zqin

    # fresh-ice overshoot removal (:1467-1502)
    if not l_brine:
        Ts = shared.snow_temperature(zqsn)
        dhs_f = torch.where(Ts > 0.0, ct.cp_ice * Ts * dzs / ct.Lfresh, 0.0)
        dzs = dzs - dhs_f
        zqsn = torch.where(Ts > 0.0, -ct.rhos * ct.Lfresh, zqsn)
        Ti = (ct.Lfresh + zqin / ct.rhoi) / ct.cp_ice
        dhi_f = torch.where(Ti > 0.0, ct.cp_ice * Ti * dzi / ct.Lfresh, 0.0)
        dzi = dzi - dhi_f
        zqin = torch.where(Ti > 0.0, -ct.rhoi * ct.Lfresh, zqin)
        qm = zqin

    # energy budgets (:1506-1520)
    wk1 = -flatn * dt
    esub = torch.clamp(wk1, min=0.0)
    econ = torch.clamp(wk1, max=0.0)
    etop_mlt = torch.clamp((fsurfn - fcondtopn) * dt, min=0.0)
    wk2 = (fcondbot - fbot) * dt
    ebot_mlt = torch.clamp(wk2, min=0.0)
    ebot_gro = torch.clamp(wk2, max=0.0)

    # condensation (:1528-1546)
    hsn0 = dzs.sum(0)
    has_snow = hsn0 > ct.puny
    dhs_c = torch.where(has_snow, econ / (zqsn[0] - ct.rhos * ct.Lvap), 0.0)
    dhi_c = torch.where(has_snow, 0.0, econ / (qm[0] - ct.rhoi * ct.Lvap))
    dzs = with_index(dzs, 0, dzs[0] + dhs_c)
    dzi = with_index(dzi, 0, dzi[0] + dhi_c)
    evapn = evapn + dhs_c * ct.rhos + dhi_c * ct.rhoi
    if mushy_on:
        emlt_atm = emlt_atm - qmlt[0] * dhi_c

    # bottom growth (:1552-1624)
    if mushy_on:
        qbotm = mushy.enthalpy_mush(Tbot, sss)
        qbotp = -ct.Lfresh * ct.rhoi * (1.0 - phi_i_mushy)
        dhi_g = ebot_gro / qbotp                  # > 0
        hqtot = dzi[nilyr - 1] * zqin[nilyr - 1] + dhi_g * qbotm
        hstot_s = dzi[nilyr - 1] * zSin[nilyr - 1] + dhi_g * sss
        emlt_ocn = emlt_ocn - (qbotm - qbotp) * dhi_g
        dzi = with_index(dzi, nilyr - 1, dzi[nilyr - 1] + dhi_g)
        ok = dzi[nilyr - 1] > ct.puny
        den = torch.clamp(dzi[nilyr - 1], min=1e-30)
        newq = torch.where(ok, hqtot / den, zqin[nilyr - 1])
        newS = torch.where(ok, hstot_s / den, zSin[nilyr - 1])
        zqin = with_index(zqin, nilyr - 1, newq)
        zSin = with_index(zSin, nilyr - 1, newS)
        qmlt = with_index(qmlt, nilyr - 1,
                          torch.where(ok, mushy.enthalpy_of_melting(newS),
                                      qmlt[nilyr - 1]))
        qm = with_index(qm, nilyr - 1, newq - qmlt[nilyr - 1])
    else:
        Tmlts_b = -zSin[nilyr - 1] * ct.depressT
        if ktherm == 0:
            # the latent placeholder only (:1575-1577, heat_capacity=F):
            # a sensible part would fail zerolayer_check
            qbot = torch.full_like(Tbot, -ct.rhoi * ct.Lfresh)
        elif l_brine:
            Tb = torch.clamp(Tbot, max=-ct.puny)
            qbot = -ct.rhoi * (ct.cp_ice * (Tmlts_b - Tb)
                               + ct.Lfresh * (1.0 - Tmlts_b / Tb)
                               - ct.cp_ocn * Tmlts_b)
            qbot = torch.clamp(qbot, max=QBOTMAX)
        else:
            qbot = -ct.rhoi * (-ct.cp_ice * Tbot + ct.Lfresh)
        dhi_g = ebot_gro / qbot                   # > 0
        hqtot = dzi[nilyr - 1] * zqin[nilyr - 1] + dhi_g * qbot
        dzi = with_index(dzi, nilyr - 1, dzi[nilyr - 1] + dhi_g)
        newq = torch.where(dzi[nilyr - 1] > ct.puny,
                           hqtot / torch.clamp(dzi[nilyr - 1], min=1e-30),
                           zqin[nilyr - 1])
        zqin = with_index(zqin, nilyr - 1, newq)
        qm = with_index(qm, nilyr - 1, newq)
    congel = congel + dhi_g

    # snow: sublimation + top melt, top-down (:1629-1690)
    for k in range(nslyr):
        if mushy_on:
            # remove internal snow melt (:1633-1645)
            warm = zqsn[k] > -ct.rhos * ct.Lfresh
            dhs_m = torch.where(
                warm, torch.maximum(-dzs[k], -((zqsn[k] + ct.rhos * ct.Lfresh)
                                               / (ct.rhos * ct.Lfresh))
                                    * dzs[k]), 0.0)
            dzs = with_index(dzs, k, dzs[k] + dhs_m)
            zqsn = with_index(zqsn, k, torch.where(warm, -ct.rhos * ct.Lfresh,
                                                   zqsn[k]))
            melts = melts - dhs_m
        qsub = zqsn[k] - ct.rhos * ct.Lvap
        dhs = torch.maximum(-dzs[k], esub / qsub)
        dzs = with_index(dzs, k, dzs[k] + dhs)
        esub = torch.clamp(esub - dhs * qsub, min=0.0)
        evapn = evapn + dhs * ct.rhos

        qk = torch.clamp(zqsn[k], max=-ct.puny)
        dhs2 = torch.maximum(-dzs[k], etop_mlt / qk)
        dzs = with_index(dzs, k, dzs[k] + dhs2)
        etop_mlt = torch.clamp(etop_mlt - dhs2 * qk, min=0.0)
        melts = melts - dhs2

    # ice: sublimation + top melt, top-down (:1692-1733)
    for k in range(nilyr):
        qsub = qm[k] - ct.rhoi * ct.Lvap
        dhi = torch.maximum(-dzi[k], esub / qsub)
        dzi = with_index(dzi, k, dzi[k] + dhi)
        esub = torch.clamp(esub - dhi * qsub, min=0.0)
        evapn = evapn + dhi * ct.rhoi

        qneg = qm[k] < 0.0
        qmk = torch.where(qneg, qm[k], 0.0)
        dhi2 = torch.where(qneg,
                           torch.maximum(-dzi[k], etop_mlt
                                         / torch.clamp(qmk, max=-1e-30)),
                           -dzi[k])
        if mushy_on:
            emlt_ocn = emlt_ocn - qmlt[k] * dhi \
                - torch.maximum(zqin[k], qmlt[k]) * dhi2
        dzi = with_index(dzi, k, dzi[k] + dhi2)
        etop_mlt = torch.clamp(etop_mlt - dhi2 * qmk, min=0.0)
        meltt = meltt - dhi2
        qm = with_index(qm, k, qmk)
    # ice: bottom melt, bottom-up (:1735-1760)
    for k in reversed(range(nilyr)):
        qneg = qm[k] < 0.0
        qmk = torch.where(qneg, qm[k], 0.0)
        dhi = torch.where(qneg,
                          torch.maximum(-dzi[k], ebot_mlt
                                        / torch.clamp(qmk, max=-1e-30)),
                          -dzi[k])
        if mushy_on:
            emlt_ocn = emlt_ocn - torch.maximum(zqin[k], qmlt[k]) * dhi
        dzi = with_index(dzi, k, dzi[k] + dhi)
        ebot_mlt = torch.clamp(ebot_mlt - dhi * qmk, min=0.0)
        meltb = meltb - dhi
        qm = with_index(qm, k, qmk)
    # snow: bottom melt (only once the ice is gone)
    for k in reversed(range(nslyr)):
        qk = torch.clamp(zqsn[k], max=-ct.puny)
        dhs = torch.maximum(-dzs[k], ebot_mlt / qk)
        dzs = with_index(dzs, k, dzs[k] + dhs)
        ebot_mlt = torch.clamp(ebot_mlt - dhs * qk, min=0.0)
        melts = melts - dhs

    fhocnn = fbot + (esub + etop_mlt + ebot_mlt) / dt

    # snowfall (:1764-1795)
    hsn_new = torch.where(fsnow > 0.0, fsnow / ct.rhos * dt, 0.0)
    hstot = dzs[0] + hsn_new
    q0 = torch.where(hstot > 0.0,
                     torch.clamp((dzs[0] * zqsn[0]
                                  + hsn_new * (-ct.rhos * ct.Lfresh))
                                 / torch.clamp(hstot, min=1e-30),
                                 max=-ct.rhos * ct.Lfresh),
                     zqsn[0])
    zqsn = with_index(zqsn, 0, q0)
    dzs = with_index(dzs, 0, torch.where(hstot > 0.0, hstot, dzs[0]))
    hin = dzi.sum(0)
    hsn = dzs.sum(0)
    dsnow = hsn - hslyr * nslyr

    # freeboard: snow-to-ice conversion (:2031-2174); the mushy solver
    # floods the ice itself (flood_ice)
    if not mushy_on:
        wk1 = hsn - hin * (ct.rhow - ct.rhoi) / ct.rhos
        below = (wk1 > ct.puny) & (hsn > ct.puny)
        dhsn_tot = torch.where(below, torch.minimum(wk1 * ct.rhoi / ct.rhow,
                                                    hsn), 0.0)
        dhin = dhsn_tot * ct.rhos / ct.rhoi
        active_fb = dhin > ct.puny
        hqs = torch.zeros_like(hin)
        dhsn_rem = dhsn_tot
        for k in reversed(range(nslyr)):
            dhs = torch.where(active_fb, torch.minimum(dhsn_rem, dzs[k]), 0.0)
            hsn = hsn - dhs
            dsnow = dsnow - dhs
            dzs = with_index(dzs, k, dzs[k] + (-dhs))
            dhsn_rem = torch.clamp(dhsn_rem - dhs, min=0.0)
            hqs = hqs + dhs * zqsn[k]
        wk2 = dzi[0] + dhin
        hin = torch.where(active_fb, hin + dhin, hin)
        zqin = with_index(zqin, 0, torch.where(
            active_fb, (dzi[0] * zqin[0] + hqs) / torch.clamp(wk2, min=1e-30),
            zqin[0]))
        dzi = with_index(dzi, 0, torch.where(active_fb, wk2, dzi[0]))
        snoice = snoice + torch.where(active_fb, dhin, 0.0)

    # repartition into equal layers (:1845-1957)
    hin = torch.clamp(hin, min=0.0)
    hsn = torch.clamp(hsn, min=0.0)
    hilyr_new = hin / nilyr
    hslyr_new = hsn / nslyr

    zi1 = with_index(_interface_depths(torch.clamp(dzi, min=0.0)), nilyr, hin)
    zi2 = with_index(_interface_depths(
        torch.broadcast_to(hilyr_new, (nilyr,) + B)), nilyr, hin)
    zqin = adjust_enthalpy(zi1, zi2, hilyr_new, hin, zqin)
    if mushy_on:
        zSin = adjust_enthalpy(zi1, zi2, hilyr_new, hin, zSin)
    if nslyr > 1:
        zs1 = with_index(_interface_depths(torch.clamp(dzs, min=0.0)), nslyr,
                         hsn)
        zs2 = with_index(_interface_depths(
            torch.broadcast_to(hslyr_new, (nslyr,) + B)), nslyr, hsn)
        zqsn = adjust_enthalpy(zs1, zs2, hslyr_new, hsn, zqsn)

    if mushy_on:
        # remove very thin snow layers (:1959-1974)
        thin = hsn <= ct.puny
        fhocnn = fhocnn + torch.where(
            thin, zqsn.sum(0) * hsn / (nslyr * dt), 0.0)
        zqsn = torch.where(thin[None], -ct.rhos * ct.Lfresh, zqsn)
        hslyr_new = torch.where(thin, 0.0, hslyr_new)

    # final energy (:1977-2006)
    efinal = -evapn * ct.Lvap
    efinal = efinal + (hslyr_new[None] * zqsn).sum(0)
    efinal = efinal + (hilyr_new[None] * zqin).sum(0)
    evapn = evapn / dt
    if mushy_on:
        fhocnn = fhocnn + emlt_ocn / dt
        efinal = efinal + emlt_atm
    return ThicknessResult(
        hin=hin, hsn=hsn, hilyr=hilyr_new, hslyr=hslyr_new, zqin=zqin,
        zqsn=zqsn, zSin=zSin, efinal=efinal, fhocnn=fhocnn, evapn=evapn,
        hsn_new=hsn_new, meltt=meltt, melts=melts, meltb=meltb,
        congel=congel, snoice=snoice, dsnow=dsnow)


class ThermoVerticalResult(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    Tsf: torch.Tensor
    zqin: torch.Tensor
    zqsn: torch.Tensor
    zSin: torch.Tensor
    fsensn: torch.Tensor
    flatn: torch.Tensor
    flwoutn: torch.Tensor
    fsurfn: torch.Tensor
    fcondtopn: torch.Tensor
    fswsfc: torch.Tensor
    evapn: torch.Tensor
    freshn: torch.Tensor
    fsaltn: torch.Tensor
    fhocnn: torch.Tensor
    meltt: torch.Tensor
    melts: torch.Tensor
    meltb: torch.Tensor
    congel: torch.Tensor
    snoice: torch.Tensor
    dsnow: torch.Tensor
    ferr: torch.Tensor
    converged: torch.Tensor
    niter: int


def thermo_vertical(dt, cfg, *, aicen, vicen, vsnon, Tsfcn, zqin, zqsn,
                    zSin, flw, potT, Qa, rhoa, fsnow, shcoef, lhcoef,
                    fswsfc, fswint, Sswabs, Iswabs, fbot, Tbot, sss=None,
                    hpond=None, apond=None, fsurfn_f=None, fcondtopn_f=None,
                    flatn_f=None, fsensn_f=None) -> ThermoVerticalResult:
    """Full vertical thermo update (ice_therm_vertical.F90:73-536
    thermo_vertical) over batch *B with layer-first zqin/zSin (nilyr, *B)
    and zqsn (nslyr, *B): the zero-layer surface balance (ktherm=0), the
    BL99 solver (ktherm=1) or the mushy solver with prognostic salinity
    (ktherm=2, which also reads the sea-surface salinity ``sss`` and the
    pond depth/fraction ``hpond``/``apond``). With cfg.thermo.calc_Tsfc
    False the BL99 solver takes the coupler's fluxes fsurfn_f,
    fcondtopn_f, flatn_f and fsensn_f; the mushy solver has no such
    variant in the reference and solves its own surface, ignoring them
    (ice_therm_vertical.F90:316-343), as the JAX package does."""
    nilyr, nslyr = cfg.nilyr, cfg.nslyr
    th = cfg.thermo
    l_brine = th.saltmax > shared.min_salin and th.ktherm != 0
    mask = aicen > ct.puny

    ai = torch.clamp(aicen, min=ct.puny)
    hin = torch.where(mask, vicen / ai, 0.0)
    hsn = torch.where(mask, vsnon / ai, 0.0)
    hilyr = hin / nilyr
    hslyr = hsn / nslyr

    Tmlts = -zSin * ct.depressT
    zTin = shared.calculate_Tin_from_qin(zqin, Tmlts, l_brine)
    l_snow = hsn > ct.hs_min
    zTsn = torch.where(l_snow[None], shared.snow_temperature(zqsn), 0.0)
    zTsn = torch.clamp(zTsn, max=0.0)
    Tsf = Tsfcn

    einit = ((hslyr[None] * torch.where(l_snow[None], zqsn,
                                        shared.snow_enthalpy(zTsn))).sum(0)
             + (hilyr[None] * zqin).sum(0))
    worki, works = hin, hsn

    if th.ktherm == 2:
        if hpond is None:
            hpond = torch.zeros_like(Tsf)
            apond = torch.zeros_like(Tsf)
        r = mushy.temperature_changes_salinity(
            dt, nilyr=nilyr, nslyr=nslyr, mask=mask, rhoa=rhoa, flw=flw,
            potT=potT, Qa=Qa, shcoef=shcoef, lhcoef=lhcoef, fswsfc=fswsfc,
            fswint=fswint, Sswabs=Sswabs, Iswabs=Iswabs, hilyr=hilyr,
            hslyr=hslyr, zqin=zqin, zSin=zSin, zqsn=zqsn, hpond=hpond,
            apond=apond, Tsf=Tsf, Tbot=Tbot, sss=sss,
            dSdt_slow_mode=th.dSdt_slow_mode,
            phi_c_slow_mode=th.phi_c_slow_mode,
            a_rapid_mode=th.a_rapid_mode,
            Rac_rapid_mode=th.Rac_rapid_mode,
            aspect_rapid_mode=th.aspect_rapid_mode,
            dtemp_errmax=th.dTemp_errmax, nit_max=th.nit_max_picard)
        zSin_cur = r.zSin
        hilyr, hslyr = r.hilyr, r.hslyr   # flood_ice may change them
        snoice_m, fadvocn = r.snoice, r.fadvocn
        r_fswsfc, r_fswint = fswsfc, fswint
        r_zqin, r_zqsn = r.zqin, r.zqsn
    elif th.ktherm == 0:
        # the surface balance alone; enthalpies stay latent-only
        # (ice_therm_vertical.F90:369-400)
        r = zerolayer.zerolayer_temperature(
            dt, mask=mask, rhoa=rhoa, flw=flw, potT=potT, Qa=Qa,
            shcoef=shcoef, lhcoef=lhcoef, fswsfc=fswsfc, hilyr=hilyr,
            hslyr=hslyr, nilyr=nilyr, nslyr=nslyr, Tsf=Tsf, Tbot=Tbot,
            ksno=th.ksno)
        r_zqin = torch.full_like(zqin, -ct.rhoi * ct.Lfresh)
        r_zqsn = torch.full_like(zqsn, -ct.rhos * ct.Lfresh)
        zSin_cur = zSin
        snoice_m = fadvocn = None
        r_fswsfc, r_fswint = fswsfc, torch.zeros_like(fswsfc)
        einit = ((hslyr[None] * r_zqsn).sum(0)
                 + (hilyr[None] * r_zqin).sum(0))
    else:
        r = bl99.temperature_changes(
            dt, nilyr=nilyr, nslyr=nslyr, conduct=th.conduct, ksno=th.ksno,
            l_brine=l_brine, mask=mask, rhoa=rhoa, flw=flw, potT=potT, Qa=Qa,
            shcoef=shcoef, lhcoef=lhcoef, fswsfc=fswsfc, fswint=fswint,
            Sswabs=Sswabs, Iswabs=Iswabs, hilyr=hilyr, hslyr=hslyr,
            zTin=zTin, zSin=zSin, zTsn=zTsn, Tsf=Tsf, Tbot=Tbot,
            einit=einit, calc_Tsfc=th.calc_Tsfc, fsurfn_f=fsurfn_f,
            fcondtopn_f=fcondtopn_f, flatn_f=flatn_f, fsensn_f=fsensn_f)
        zSin_cur = zSin
        snoice_m = fadvocn = None
        r_fswsfc, r_fswint = r.fswsfc, r.fswint
        r_zqin, r_zqsn = r.zqin, r.zqsn

    tc = thickness_changes(
        dt, nilyr=nilyr, nslyr=nslyr, l_brine=l_brine, hilyr=hilyr,
        hslyr=hslyr, zqin=r_zqin, zqsn=r_zqsn, zSin=zSin_cur, fbot=fbot,
        Tbot=Tbot, flatn=r.flatn, fsurfn=r.fsurfn, fcondtopn=r.fcondtopn,
        fcondbot=r.fcondbot, fsnow=fsnow, ktherm=th.ktherm, sss=sss,
        phi_i_mushy=th.phi_i_mushy)

    # conservation check (ice_therm_vertical.F90:2283-2400)
    einp = (r.fsurfn - r.flatn + r_fswint - tc.fhocnn
            - fsnow * ct.Lfresh)
    fhocnn, snoice = tc.fhocnn, tc.snoice
    if fadvocn is not None:
        einp = einp - fadvocn
        fhocnn = fhocnn + fadvocn
        snoice = snoice + snoice_m
    einp = einp * dt
    ferr = torch.where(mask, torch.abs(tc.efinal - einit - einp) / dt, 0.0)

    # water/salt fluxes (:447-476)
    dhi = tc.hin - worki
    dhs = tc.hsn - works - tc.hsn_new
    freshn = tc.evapn - (ct.rhoi * dhi + ct.rhos * dhs) / dt
    fsaltn = -ct.rhoi * dhi * ct.ice_ref_salinity * 0.001 / dt

    # update_state_vthermo (:2417-2530): zero everything if melted out
    gone = ~mask | (tc.hin <= 0.0)
    aicen_new = torch.where(gone & mask, 0.0, aicen)
    vicen_new = torch.where(mask, torch.where(gone, 0.0, aicen * tc.hin),
                            vicen)
    vsnon_new = torch.where(mask, torch.where(gone, 0.0, aicen * tc.hsn),
                            vsnon)
    Tsf_new = torch.where(mask, torch.where(gone, Tbot, r.Tsf), Tsfcn)
    zqin_new = torch.where(mask[None],
                           torch.where(gone[None], 0.0, tc.zqin), zqin)
    zqsn_new = torch.where(mask[None],
                           torch.where(gone[None], 0.0, tc.zqsn), zqsn)
    zSin_new = torch.where(mask[None],
                           torch.where(gone[None], 0.0, tc.zSin), zSin)

    msk = lambda x: torch.where(mask, x, 0.0)
    return ThermoVerticalResult(
        aicen=aicen_new, vicen=vicen_new, vsnon=vsnon_new, Tsf=Tsf_new,
        zqin=zqin_new, zqsn=zqsn_new, zSin=zSin_new,
        fsensn=msk(r.fsensn), flatn=msk(r.flatn), flwoutn=msk(r.flwoutn),
        fsurfn=msk(r.fsurfn), fcondtopn=msk(r.fcondtopn),
        fswsfc=msk(r_fswsfc),
        evapn=msk(tc.evapn), freshn=msk(freshn), fsaltn=msk(fsaltn),
        fhocnn=msk(fhocnn),
        meltt=msk(tc.meltt), melts=msk(tc.melts), meltb=msk(tc.meltb),
        congel=msk(tc.congel), snoice=msk(snoice), dsnow=msk(tc.dsnow),
        ferr=ferr, converged=r.converged, niter=r.niter)
