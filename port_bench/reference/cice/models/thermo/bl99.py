"""Bitz & Lipscomb (1999) vertical heat-conduction solver (PyTorch port of
``cice5_tpu/models/thermo/bl99.py``; ice_therm_bl99.F90
temperature_changes :51, conductivity :940,
get_matrix_elements_calc_Tsfc :1172, get_matrix_elements_know_Tsfc
:1484).

Every cell of the batch is solved at once; cells that have converged are
frozen by a mask while the others iterate. The loop (``ops/loop.py``)
ends when every cell has converged or after NITERMAX passes: eagerly one
host read of that condition per pass, in a captured step one per block of
passes.

Array convention: layer axis first after any leading batch axes of the
scalars: zTin (nilyr, *B), zTsn (nslyr, *B), kh (nilyr+nslyr+1, *B). With
calc_Tsfc=False the coupler prescribes the surface fluxes per category
(set_sfcflux, ice_flux.F90:1015) and the surface temperature is not
solved for.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.models.thermo import shared
from reference.cice.ops.loop import while_loop
from reference.cice.ops.tridiag import tridiag_solve

NITERMAX = 100          # reference uses 500; 100 suffices in practice
TSF_ERRMAX = 5.0e-4


class BL99Result(NamedTuple):
    Tsf: torch.Tensor
    zqsn: torch.Tensor
    zTsn: torch.Tensor
    zqin: torch.Tensor
    zTin: torch.Tensor
    fsensn: torch.Tensor
    flatn: torch.Tensor
    flwoutn: torch.Tensor
    fsurfn: torch.Tensor
    fcondtopn: torch.Tensor
    fcondbot: torch.Tensor
    fswsfc: torch.Tensor
    fswint: torch.Tensor
    Sswabs: torch.Tensor
    Iswabs: torch.Tensor
    converged: torch.Tensor
    niter: torch.Tensor         # solver passes used (0-d int64)


def conductivity(l_snow, hilyr, hslyr, zTin, zSin, *, nilyr, nslyr,
                 conduct="bubbly", ksno=ct.ksno):
    """Effective conductivities at the nilyr+nslyr+1 interfaces
    (ice_therm_bl99.F90:940-1064)."""
    kslyr = torch.full((nslyr,) + tuple(zTin.shape[1:]), ksno,
                       dtype=zTin.dtype, device=zTin.device)
    Tneg = torch.clamp(zTin, max=-ct.puny)
    if conduct == "MU71":
        kilyr = ct.kice + shared.betak * zSin / Tneg
    else:  # Pringle et al. 2007 'bubbly brine'
        kilyr = (2.11 - 0.011 * zTin + 0.09 * zSin / Tneg) \
            * (ct.rhoi / 917.0)
    kilyr = torch.clamp(kilyr, min=shared.kimin)

    hs = torch.clamp(hslyr, min=ct.puny)
    hi = torch.clamp(hilyr, min=ct.puny)

    rows = [torch.where(l_snow, 2.0 * kslyr[0] / hs, 0.0)]
    for k in range(1, nslyr):
        v = 2.0 * kslyr[k - 1] * kslyr[k] / ((kslyr[k - 1] + kslyr[k]) * hs)
        rows.append(torch.where(l_snow, v, 0.0))
    rows.append(torch.where(
        l_snow,
        2.0 * kslyr[nslyr - 1] * kilyr[0]
        / (kslyr[nslyr - 1] * hi + kilyr[0] * hs),
        2.0 * kilyr[0] / hi))
    for k in range(1, nilyr):
        rows.append(2.0 * kilyr[k - 1] * kilyr[k]
                    / ((kilyr[k - 1] + kilyr[k]) * hi))
    rows.append(2.0 * kilyr[nilyr - 1] / hi)
    return torch.stack(rows, dim=0)


def _assemble_matrix(*, nilyr, nslyr, l_snow, l_cold, Tsf, Tbot, fsurfn,
                     dfsurf_dT, Tin_init, Tsn_init, kh, Sswabs, Iswabs,
                     etai, etas):
    """Tridiagonal rows for the calc_Tsfc case
    (ice_therm_bl99.F90:1172-1471). Row layout: surface equation at row 0
    (snow) or row nslyr (no snow); snow layer k at row k+1; ice layer k
    at row k+nslyr+1; unused rows are identity dummies."""
    nmat = nilyr + nslyr + 1
    one = torch.ones_like(Tsf)
    zero = torch.zeros_like(Tsf)
    false = torch.zeros_like(l_cold)
    sb, dg, sp, rh = [], [], [], []
    kh_sfc = torch.where(l_snow, kh[0], kh[nslyr])
    sfc = (zero, dfsurf_dT - kh_sfc, kh_sfc, dfsurf_dT * Tsf - fsurfn)
    for r in range(nmat):
        if r >= nslyr + 1:
            ki = r - nslyr - 1
            kt, kb = kh[r - 1], kh[r]
            sb_i = -etai[ki] * kt
            sp_i = -etai[ki] * kb
            dg_i = 1.0 + etai[ki] * (kt + kb)
            rh_i = Tin_init[ki] + etai[ki] * Iswabs[ki]
            if ki == 0:
                # no snow & melting surface: Tsf known, drop top coupling
                warm_nosnow = (~l_snow) & (~l_cold)
                sb_i = torch.where(warm_nosnow, zero, sb_i)
                rh_i = torch.where(warm_nosnow,
                                   rh_i + etai[0] * kt * Tsf, rh_i)
            if ki == nilyr - 1:
                sp_i = zero
                rh_i = rh_i + etai[ki] * kb * Tbot
            sb.append(sb_i)
            dg.append(dg_i)
            sp.append(sp_i)
            rh.append(rh_i)
            continue
        is_sfc = l_cold & (l_snow if r == 0 else
                           (~l_snow if r == nslyr else false))
        if 1 <= r <= nslyr:
            ks = r - 1
            sb_s = -etas[ks] * kh[r - 1]
            sp_s = -etas[ks] * kh[r]
            dg_s = 1.0 + etas[ks] * (kh[r - 1] + kh[r])
            rh_s = Tsn_init[ks] + etas[ks] * Sswabs[ks]
            if ks == 0:
                # melting surface: drop kh[0] coupling into rhs
                sb_s = torch.where(l_cold, sb_s, zero)
                rh_s = torch.where(l_cold, rh_s,
                                   rh_s + etas[0] * kh[0] * Tsf)
            is_snow_row = l_snow
        else:
            sb_s = sp_s = rh_s = zero
            dg_s = one
            is_snow_row = false
        sb.append(torch.where(is_sfc, sfc[0],
                              torch.where(is_snow_row, sb_s, zero)))
        dg.append(torch.where(is_sfc, sfc[1],
                              torch.where(is_snow_row, dg_s, one)))
        sp.append(torch.where(is_sfc, sfc[2],
                              torch.where(is_snow_row, sp_s, zero)))
        rh.append(torch.where(is_sfc, sfc[3],
                              torch.where(is_snow_row, rh_s, zero)))
    return (torch.stack(sb), torch.stack(dg), torch.stack(sp),
            torch.stack(rh))


def _assemble_matrix_know(*, nilyr, nslyr, l_snow, Tbot, fcondtopn,
                          Tin_init, Tsn_init, kh, Sswabs, Iswabs, etai,
                          etas):
    """Tridiagonal rows when the coupler prescribes the conductive top flux
    (ice_therm_bl99.F90:1484-1761 get_matrix_elements_know_Tsfc). Row 0
    is a dummy; the top snow row (or the top ice row, without snow) takes
    fcondtopn into its right-hand side."""
    nmat = nilyr + nslyr + 1
    one = torch.ones_like(Tin_init[0])
    zero = torch.zeros_like(Tin_init[0])
    sb, dg, sp, rh = [zero], [one], [zero], [zero]
    for r in range(1, nmat):
        if r <= nslyr:
            ks = r - 1
            sb_s = zero if ks == 0 else -etas[ks] * kh[r - 1]
            sp_s = -etas[ks] * kh[r]
            dg_s = 1.0 + etas[ks] * ((0.0 if ks == 0 else kh[r - 1])
                                     + kh[r])
            rh_s = Tsn_init[ks] + etas[ks] * Sswabs[ks]
            if ks == 0:
                rh_s = rh_s + etas[0] * fcondtopn
            sb.append(torch.where(l_snow, sb_s, zero))
            dg.append(torch.where(l_snow, dg_s, one))
            sp.append(torch.where(l_snow, sp_s, zero))
            rh.append(torch.where(l_snow, rh_s, zero))
            continue
        ki = r - nslyr - 1
        kt, kb = kh[r - 1], kh[r]
        sb_i = -etai[ki] * kt
        sp_i = -etai[ki] * kb
        dg_i = 1.0 + etai[ki] * (kt + kb)
        rh_i = Tin_init[ki] + etai[ki] * Iswabs[ki]
        if ki == 0:
            # no snow: the prescribed flux enters the top ice layer
            sb_i = torch.where(l_snow, sb_i, zero)
            dg_i = torch.where(l_snow, dg_i, 1.0 + etai[0] * kb)
            rh_i = torch.where(l_snow, rh_i, rh_i + etai[0] * fcondtopn)
        if ki == nilyr - 1:
            sp_i = zero
            rh_i = rh_i + etai[ki] * kb * Tbot
        sb.append(sb_i)
        dg.append(dg_i)
        sp.append(sp_i)
        rh.append(rh_i)
    return (torch.stack(sb), torch.stack(dg), torch.stack(sp),
            torch.stack(rh))


def temperature_changes(dt, *, nilyr, nslyr, conduct, ksno, l_brine,
                        mask, rhoa, flw, potT, Qa, shcoef, lhcoef,
                        fswsfc, fswint, Sswabs, Iswabs,
                        hilyr, hslyr, zTin, zSin, zTsn, Tsf, Tbot,
                        einit, calc_Tsfc=True, fsurfn_f=None,
                        fcondtopn_f=None, flatn_f=None,
                        fsensn_f=None) -> BL99Result:
    """BL99 temperature update. mask: bool (*B), True where aicen > puny;
    masked-out cells pass through. With calc_Tsfc=False the surface
    fluxes fsurfn_f, fcondtopn_f, flatn_f and fsensn_f (*B) come from the
    coupler, Tsf stays as it is, and the oscillation control moves to the
    top ice layer (condition 2b, ice_therm_bl99.F90:721-735)."""
    dtype = zTin.dtype
    nmat = nilyr + nslyr + 1
    B = Tsf.shape
    fzero = torch.zeros_like(Tsf)

    hilyr = torch.clamp(hilyr, min=ct.puny)
    l_snow = hslyr > (ct.hs_min / nslyr)
    dt_rhoi_hlyr = dt / (ct.rhoi * hilyr)
    etas = torch.where(l_snow, dt / (ct.rhos * ct.cp_ice
                                     * torch.clamp(hslyr, min=ct.puny)), 0.0)
    etas = torch.broadcast_to(etas, (nslyr,) + tuple(B))

    Tin_init = zTin
    Tsn_init = zTsn
    Tmlts = -zSin * ct.depressT

    # f32 tolerances (ice_therm_bl99.F90:117-123 documented ranges): the
    # energy check's noise floor scales with the column enthalpy, and the
    # surface-temperature target is 5e-3 K
    if dtype == torch.float64:
        ferrmax_eff = shared.ferrmax
    else:
        eps32 = 1.2e-7
        ferrmax_eff = 1.0e-2 + 8.0 * eps32 * torch.abs(einit) / dt
    tsf_errmax_eff = TSF_ERRMAX if dtype == torch.float64 else 5.0e-3
    qsn_init0 = shared.snow_enthalpy(Tsn_init)
    qin_init0 = shared.ice_enthalpy(Tin_init, Tmlts, l_brine)

    kh = conductivity(l_snow, hilyr, hslyr, zTin, zSin, nilyr=nilyr,
                      nslyr=nslyr, conduct=conduct, ksno=ksno)

    # shortwave overshoot guard (ice_therm_bl99.F90:296-364)
    frac, dTemp = 0.9, 0.02
    if l_brine:
        ci0 = ct.cp_ice - ct.Lfresh * Tmlts \
            / torch.clamp(Tin_init, max=-ct.puny) ** 2
        cap = frac * (Tmlts - Tin_init) * ci0 / dt_rhoi_hlyr
        cold = Tin_init <= Tmlts - dTemp
    else:
        cap = frac * (-Tin_init) * ct.cp_ice / dt_rhoi_hlyr
        cold = Tin_init <= -dTemp
    Isw_tmp = torch.where(cold, torch.minimum(Iswabs, cap), 0.0)
    Isw_tmp = torch.where(Isw_tmp < ct.puny, 0.0, Isw_tmp)
    for k in range(nilyr):
        dsw = torch.minimum(Iswabs[k] - Isw_tmp[k], fswint)
        fswsfc = fswsfc + dsw
        fswint = fswint - dsw
    Iswabs = Isw_tmp

    Ssw_cap = torch.where(Tsn_init <= -dTemp,
                          -frac * Tsn_init / torch.clamp(etas, min=ct.puny),
                          0.0)
    Ssw_tmp = torch.where(l_snow, torch.minimum(Sswabs, Ssw_cap), 0.0)
    Ssw_tmp = torch.where(Ssw_tmp < ct.puny, 0.0, Ssw_tmp)
    for k in range(nslyr):
        dsw = torch.where(l_snow,
                          torch.minimum(Sswabs[k] - Ssw_tmp[k], fswint), 0.0)
        fswsfc = fswsfc + dsw
        fswint = fswint - dsw
    Sswabs = Ssw_tmp

    def brine_ci(T_new, T_old):
        if l_brine:
            return ct.cp_ice - ct.Lfresh * Tmlts / (
                torch.clamp(T_new, max=-ct.puny)
                * torch.clamp(T_old, max=-ct.puny))
        return torch.full_like(T_new, ct.cp_ice)

    def pending(c):
        return (c["niter"] < NITERMAX) & (~c["converged"]).any()

    def body(c, go):
        """One solver pass (ops/loop.py): the cells not yet converged
        move, and none when ``go`` is False."""
        converged, niter = c["converged"], c["niter"] + go
        c_Tsf, c_zTsn, c_zTin, c_kh = c["Tsf"], c["zTsn"], c["zTin"], c["kh"]
        active = ~converged & go
        ci = brine_ci(c_zTin, Tin_init)
        etai = dt_rhoi_hlyr / ci

        if calc_Tsfc:
            flwo, fsen, flat, fsur = shared.surface_heat_flux(
                c_Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef)
            dfsurf, dflwo, dfsen, dflat = shared.dsurface_heat_flux_dTsf(
                c_Tsf, rhoa, shcoef, lhcoef)
        else:
            # prescribed coupler fluxes (set_sfcflux, ice_flux.F90:1015)
            flwo = dfsurf = dflwo = dfsen = dflat = fzero
            fsen = fsensn_f if fsensn_f is not None else fzero
            flat, fsur = flatn_f, fsurfn_f
        flwoutn = torch.where(active, flwo, c["flwoutn"])
        fsensn = torch.where(active, fsen, c["fsensn"])
        flatn = torch.where(active, flat, c["flatn"])
        fsurfn = torch.where(active, fsur, c["fsurfn"])
        dflwout_dT = torch.where(active, dflwo, c["dflwout_dT"])
        dfsens_dT = torch.where(active, dfsen, c["dfsens_dT"])
        dflat_dT = torch.where(active, dflat, c["dflat_dT"])

        dTsf_prev = c["dTsf_prev"]
        if calc_Tsfc:
            fct = torch.where(l_snow, c_kh[0] * (c_Tsf - c_zTsn[0]),
                              c_kh[nslyr] * (c_Tsf - c_zTin[0]))
            fcondtopn = torch.where(active, fct, c["fcondtopn"])
            Tsf_start = torch.where(
                active & (c_Tsf >= 0.0) & (fsurfn < fcondtopn), -ct.puny,
                c_Tsf)
            l_cold = Tsf_start < 0.0
            sb, dg, sp, rh = _assemble_matrix(
                nilyr=nilyr, nslyr=nslyr, l_snow=l_snow, l_cold=l_cold,
                Tsf=Tsf_start, Tbot=Tbot, fsurfn=fsurfn, dfsurf_dT=dfsurf,
                Tin_init=Tin_init, Tsn_init=Tsn_init, kh=c_kh,
                Sswabs=Sswabs, Iswabs=Iswabs, etai=etai, etas=etas)
        else:
            fcondtopn = torch.where(active, fcondtopn_f, c["fcondtopn"])
            sb, dg, sp, rh = _assemble_matrix_know(
                nilyr=nilyr, nslyr=nslyr, l_snow=l_snow, Tbot=Tbot,
                fcondtopn=fcondtopn, Tin_init=Tin_init, Tsn_init=Tsn_init,
                kh=c_kh, Sswabs=Sswabs, Iswabs=Iswabs, etai=etai,
                etas=etas)
        Tmat = tridiag_solve(sb, dg, sp, rh)

        if calc_Tsfc:
            # surface temperature update + conditions 1 & 2
            Tsf_new = torch.where(l_cold,
                                  torch.where(l_snow, Tmat[0], Tmat[nslyr]),
                                  0.0)
            dTsf = Tsf_new - Tsf_start
            cond1 = Tsf_new > ct.puny
            cond2 = ((niter > 1) & (Tsf_start <= -ct.puny)
                     & (torch.abs(dTsf) > ct.puny)
                     & (torch.abs(dTsf_prev) > ct.puny)
                     & (-dTsf / (dTsf_prev + ct.puny * ct.puny) > 0.5)
                     & ~cond1)
            Tsf_new = torch.where(cond1, 0.0, Tsf_new)
            dTsf = torch.where(cond1, -Tsf_start,
                               torch.where(cond2, 0.5 * dTsf, dTsf))
            avg_Tsf = (cond2 & l_brine).to(dtype)
            avg_Tsi = ((cond1 | cond2) & l_brine).to(dtype)
            conv = ~cond1 & ~cond2
            Tsf_new = Tsf_new + avg_Tsf * 0.5 * (Tsf_start - Tsf_new)
        else:
            # Tsf is not solved for; the oscillation control watches the
            # top ice layer (condition 2b), and dTsf_prev carries its dT
            Tsf_new = c_Tsf
            dTsf = Tmat[1 + nslyr] - c_zTin[0]
            cond2 = ((niter > 1) & (torch.abs(dTsf) > ct.puny)
                     & (torch.abs(dTsf_prev) > ct.puny)
                     & (-dTsf / (dTsf_prev + ct.puny * ct.puny) > 0.5))
            avg_Tsi = (cond2 & l_brine).to(dtype)
            conv = ~cond2

        # snow layers
        zTsn_new = torch.where(l_snow, Tmat[1:1 + nslyr], 0.0)
        if l_brine:
            zTsn_new = torch.clamp(zTsn_new, max=0.0)
        zTsn_new = zTsn_new + avg_Tsi * 0.5 * (c_zTsn - zTsn_new)
        zqsn_new = shared.snow_enthalpy(zTsn_new)
        dener = (hslyr * (zqsn_new - qsn_init0)).sum(0)

        # ice layers
        zTin_mat = Tmat[1 + nslyr:]
        if l_brine:
            over = zTin_mat > Tmlts - ct.puny
            dTmat = torch.where(over, zTin_mat - Tmlts, 0.0)
            dqmat = torch.where(
                over,
                ct.rhoi * dTmat * (ct.cp_ice - ct.Lfresh * Tmlts
                                   / torch.clamp(zTin_mat,
                                                 max=-ct.puny) ** 2),
                0.0)
            zTin_new = torch.where(over, Tmlts, zTin_mat)
            reduce_kh = over
        else:
            dqmat = torch.zeros_like(zTin_mat)
            zTin_new = zTin_mat
            reduce_kh = torch.zeros_like(zTin_mat, dtype=torch.bool)
        zTin_new = zTin_new + avg_Tsi * 0.5 * (c_zTin - zTin_new)
        zqin_new = shared.ice_enthalpy(zTin_new, Tmlts, l_brine)
        dener = dener + (hilyr * (zqin_new - qin_init0)).sum(0)
        einex = (hilyr * dqmat).sum(0)

        if calc_Tsfc:
            # conditions 3 & 4
            conv = conv & (torch.abs(dTsf) <= tsf_errmax_eff)
            fsurfn = torch.where(active, fsurfn + dTsf * dfsurf, fsurfn)
            fct2 = torch.where(l_snow, c_kh[0] * (Tsf_new - zTsn_new[0]),
                               c_kh[nslyr] * (Tsf_new - zTin_new[0]))
            fcondtopn = torch.where(active, fct2, fcondtopn)
            conv = conv & ~((Tsf_new >= 0.0) & (fsurfn < fcondtopn))

        # condition 5: energy conservation
        fcb = c_kh[nmat - 1] * (zTin_new[nilyr - 1] - Tbot) + einex / dt
        ferr = torch.abs(dener / dt - (fcondtopn - fcb + fswint))
        bad_energy = ferr > 0.9 * ferrmax_eff
        conv = conv & ~bad_energy

        # conductivity reduction where the energy check failed
        # (ice_therm_bl99.F90:836-849), as the vectorized fixed point of
        # the reference's ascending layer loop
        red = reduce_kh & (dqmat > 0.0) & bad_energy & active
        fr = torch.clamp(0.5 * (1.0 - ferr / torch.clamp(
            torch.abs(fcondtopn - fcb), min=ct.puny)), min=0.1)
        scale = torch.where(red, fr, 1.0)
        iface = c_kh[nslyr:]
        scaled_bot = c_kh[nslyr + 1:] * scale
        fb = torch.zeros_like(red[:1])
        red_below = torch.cat([red, fb], dim=0)
        red_above = torch.cat([fb, red], dim=0)
        sb_below = torch.cat([scaled_bot, scaled_bot[-1:]], dim=0)
        sb_above = torch.cat([iface[:1], scaled_bot], dim=0)
        iface_new = torch.where(red_below, sb_below,
                                torch.where(red_above, sb_above, iface))
        kh_new = torch.cat([c_kh[:nslyr], iface_new], dim=0)

        # frozen cells keep their previous values
        upd = lambda new, old: torch.where(active, new, old)
        updk = lambda new, old: torch.where(active[None], new, old)
        return dict(
            Tsf=upd(Tsf_new, c_Tsf), zTsn=updk(zTsn_new, c_zTsn),
            zTin=updk(zTin_new, c_zTin), zqsn=updk(zqsn_new, c["zqsn"]),
            zqin=updk(zqin_new, c["zqin"]), kh=updk(kh_new, c_kh),
            dTsf_prev=upd(dTsf, dTsf_prev),
            converged=converged | (conv & active),
            fcondbot=upd(fcb, c["fcondbot"]),
            flwoutn=flwoutn, fsensn=fsensn, flatn=flatn, fsurfn=fsurfn,
            fcondtopn=fcondtopn, dflwout_dT=dflwout_dT, dfsens_dT=dfsens_dT,
            dflat_dT=dflat_dT, niter=niter)

    c = while_loop(body, pending, dict(
        Tsf=Tsf, zTsn=zTsn, zTin=zTin, zqsn=shared.snow_enthalpy(zTsn),
        zqin=shared.ice_enthalpy(zTin, Tmlts, l_brine), kh=kh,
        dTsf_prev=fzero, converged=~mask, fcondbot=fzero,
        flwoutn=fzero, fsensn=fzero, flatn=fzero, fsurfn=fzero,
        fcondtopn=fzero, dflwout_dT=fzero, dfsens_dT=fzero, dflat_dT=fzero,
        niter=torch.zeros((), dtype=torch.int64, device=Tsf.device)))

    # post-loop flux correction (ice_therm_bl99.F90:905-918)
    dTsf_prev = c["dTsf_prev"]
    flwoutn = c["flwoutn"] + dTsf_prev * c["dflwout_dT"]
    fsensn = c["fsensn"] + dTsf_prev * c["dfsens_dT"]
    flatn = c["flatn"] + dTsf_prev * c["dflat_dT"]

    m = mask
    return BL99Result(
        Tsf=torch.where(m, c["Tsf"], Tsf),
        zqsn=torch.where(m[None], c["zqsn"], shared.snow_enthalpy(zTsn)),
        zTsn=torch.where(m[None], c["zTsn"], zTsn),
        zqin=torch.where(m[None], c["zqin"],
                         shared.ice_enthalpy(zTin, Tmlts, l_brine)),
        zTin=torch.where(m[None], c["zTin"], zTin),
        fsensn=torch.where(m, fsensn, 0.0),
        flatn=torch.where(m, flatn, 0.0),
        flwoutn=torch.where(m, flwoutn, 0.0),
        fsurfn=torch.where(m, c["fsurfn"], 0.0),
        fcondtopn=torch.where(m, c["fcondtopn"], 0.0),
        fcondbot=torch.where(m, c["fcondbot"], 0.0),
        fswsfc=torch.where(m, fswsfc, 0.0),
        fswint=torch.where(m, fswint, 0.0),
        Sswabs=torch.where(m[None], Sswabs, 0.0),
        Iswabs=torch.where(m[None], Iswabs, 0.0),
        converged=c["converged"] | ~m,
        niter=c["niter"])
