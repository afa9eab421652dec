"""Mushy-layer thermodynamics (ktherm=2) with prognostic salinity (PyTorch
port of ``cice5_tpu/models/thermo/mushy.py``).

ice_therm_mushy.F90: temperature_changes_salinity (:151) /
temperature_changes_column (:305), two_stage_solver_{snow,nosnow}
(:601/:899), picard_solver (:1324), solve_heat_conduction (:2093),
solve_salinity (:2810), explicit_flow_velocities (:2953),
flushing_velocity (:3123), flush_pond (:3230), flood_ice (:3265) and the
Assur-liquidus constitutive relations (:3580-3924).

Dense over any batch shape *B (here all categories at once), layer axis
first. The four matrix layouts of the reference (snow x cold) are one
padded (1+nslyr+nilyr) tridiagonal system per cell with masked dummy
rows. The Picard iteration runs over the whole batch with per-cell
convergence freezing (``ops/loop.py``); it ends when every cell has
converged or after ``nit_max`` passes, and reports its passes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.models.thermo import shared as thsh
from reference.cice.ops.loop import while_loop
from reference.cice.ops.tridiag import tridiag_solve

# Assur (1958) liquidus constants (ice_therm_mushy.F90:38-130)
az1, bz1 = -18.48, 0.0
az2, bz2 = -10.3085, 62.4
Tb_liq = -7.6362968855167352
Sb_liq = 123.66702800276086
az1p, bz1p = az1 / 1000.0, bz1 / 1000.0
az2p, bz2p = az2 / 1000.0, bz2 / 1000.0

_crw = ct.cp_ocn * ct.rhow
_cri = ct.cp_ice * ct.rhoi

AS1 = az1p * (_crw - _cri)
AC1 = _cri * az1
BS1 = (1 + bz1p) * (_crw - _cri) + ct.rhoi * ct.Lfresh * az1p
BQ1 = -az1
BC1 = _cri * bz1 - ct.rhoi * ct.Lfresh * az1
CS1 = ct.rhoi * ct.Lfresh * (1 + bz1p)
CQ1 = -bz1
CC1 = -ct.rhoi * ct.Lfresh * bz1

AS2 = az2p * (_crw - _cri)
AC2 = _cri * az2
BS2 = (1 + bz2p) * (_crw - _cri) + ct.rhoi * ct.Lfresh * az2p
BQ2 = -az2
BC2 = _cri * bz2 - ct.rhoi * ct.Lfresh * az2
CS2 = ct.rhoi * ct.Lfresh * (1 + bz2p)
CQ2 = -bz2
CC2 = -ct.rhoi * ct.Lfresh * bz2

D_liq = (((1 + az1p * Tb_liq + bz1p) / (az1 * Tb_liq + bz1))
         * ((_crw - _cri) * Tb_liq + ct.Lfresh * ct.rhoi))
E_liq = _cri * Tb_liq - ct.Lfresh * ct.rhoi

F1, G1, H1 = (-1000.0 * _crw) / az1, -1000.0, (-bz1 * _crw) / az1
F2, G2, H2 = (-1000.0 * _crw) / az2, -1000.0, (-bz2 * _crw) / az2
I_liq = 1.0 / _crw

J1, K1, L1 = bz1 / az1, 1.0 / 1000.0, (1 + bz1p) / az1
J2, K2, L2 = bz2 / az2, 1.0 / 1000.0, (1 + bz2p) / az2
M1, N1, O1 = az1, -az1p, -bz1 / az1
M2, N2, O2 = az2, -az2p, -bz2 / az2

KI = 2.3        # fresh ice conductivity (W/m/K)
KB = 0.5375     # brine conductivity

# drainage parameters (ice_init.F90:386-390 defaults)
A_RAPID = 0.5e-3
RAC_RAPID = 10.0
ASPECT_RAPID = 1.0
DSDT_SLOW = -1.5e-7
PHI_C_SLOW = 0.05

DTEMP_ERRMAX = 5.0e-4
NIT_MAX = 100


# constitutive relations (elementwise)

def liquidus_brine_salinity(zTin):
    Sbr = torch.where(zTin > Tb_liq, (zTin + J1) / (K1 * zTin + L1),
                      (zTin + J2) / (K2 * zTin + L2))
    return torch.where(zTin <= 0.0, Sbr, 0.0)


def liquidus_temperature(Sbr):
    return torch.where(Sbr <= Sb_liq, Sbr / (M1 + N1 * Sbr) + O1,
                       Sbr / (M2 + N2 * Sbr) + O2)


def liquid_fraction(zTin, zSin):
    Sbr = torch.clamp(liquidus_brine_salinity(zTin), min=ct.puny)
    return zSin / torch.maximum(Sbr, zSin)


def enthalpy_mush(zTin, zSin):
    return enthalpy_mush_liquid_fraction(zTin, liquid_fraction(zTin, zSin))


def enthalpy_mush_liquid_fraction(zTin, phi):
    return (phi * (_crw - _cri) * zTin + _cri * zTin
            - (1.0 - phi) * ct.rhoi * ct.Lfresh)


def enthalpy_of_melting(zSin):
    return _crw * liquidus_temperature(zSin)


def enthalpy_brine(zTin):
    return _crw * zTin


def enthalpy_snow(zTsn):
    return -ct.rhos * (-ct.cp_ice * zTsn + ct.Lfresh)


def temperature_snow(zqsn):
    return zqsn / (ct.rhos * ct.cp_ice) + ct.Lfresh / ct.cp_ice


def temperature_mush(zqin, zSin):
    """Invert the mush enthalpy (ice_therm_mushy.F90 temperature_mush)."""
    S_low = zSin < Sb_liq
    q0 = torch.where(S_low, (F1 * zSin) / (G1 + zSin) + H1,
                     (F2 * zSin) / (G2 + zSin) + H2)
    qb = D_liq * zSin + E_liq
    t_high = zqin > qb
    A = torch.where(t_high, AS1 * zSin + AC1, AS2 * zSin + AC2)
    B = torch.where(t_high, BS1 * zSin + BQ1 * zqin + BC1,
                    BS2 * zSin + BQ2 * zqin + BC2)
    C = torch.where(t_high, CS1 * zSin + CQ1 * zqin + CC1,
                    CS2 * zSin + CQ2 * zqin + CC2)
    disc = torch.clamp(B * B - 4.0 * A * C, min=ct.puny)
    zTin = (-B + torch.sqrt(disc)) / (2.0 * A)
    return torch.where(zqin > q0, zqin * I_liq, zTin)


def temperature_mush_liquid_fraction(zqin, phi):
    return (zqin + (1.0 - phi) * ct.rhoi * ct.Lfresh) \
        / (phi * (_crw - _cri) + _cri)


def conductivity_mush(zTin, zSin):
    return liquid_fraction(zTin, zSin) * (KB - KI) + KI


def density_brine(Sbr):
    return 1000.3 + 0.78237 * Sbr + 2.8008e-4 * Sbr ** 2


def permeability(phi):
    """Golden et al. 2007 (ice_therm_mushy.F90:2933)."""
    return 3.0e-8 * torch.clamp(phi - 0.05, min=0.0) ** 3


# drainage and flushing velocities

def flushing_velocity(dt, zTin, zSin, phi, hin, hsn, hilyr, hpond, apond):
    """Downward Darcy flushing velocity (ice_therm_mushy.F90:3123-3228)."""
    nilyr = zTin.shape[0]
    adv_limit = 0.005
    phi_min = phi.amin(0)
    perm = permeability(phi)
    rho_br = density_brine(liquidus_brine_salinity(zTin))
    ice_mass = (phi * rho_br + (1.0 - phi) * ct.rhoi).sum(0) * hilyr
    perm_harm = nilyr / (1.0 / (perm + 1e-30)).sum(0)
    hocn = (ice_mass + hpond * apond * ct.rhow + hsn * ct.rhos) / ct.rhow
    hbrine = hin + hpond
    dhhead = torch.clamp(hbrine - hocn, min=0.0)
    w = (perm_harm * ct.rhow * ct.gravit
         * (dhhead / torch.clamp(hin, min=ct.puny))) / ct.viscosity_dyn
    w = torch.minimum(w, hpond * apond / dt)
    wlimit = adv_limit * phi_min * hilyr / dt
    big = torch.abs(w) > ct.puny
    w = torch.where(big, w * torch.clamp(torch.abs(
        wlimit / torch.where(big, w, 1.0)), 0.0, 1.0), 0.0)
    return torch.clamp(w, min=0.0)


def explicit_flow_velocities(dt, zSin, zTin, Tsf, Tbot, sss, qocn, hilyr,
                             hin, dSdt_slow=DSDT_SLOW, phi_c=PHI_C_SLOW,
                             a_rapid=A_RAPID, Rac_rapid=RAC_RAPID,
                             aspect_rapid=ASPECT_RAPID):
    """Rapid-mode Darcy flow q and slow-mode drainage dSdt
    (ice_therm_mushy.F90:2953-3120). Returns (q (nilyr,*B), dSdt, Sbr,
    qbr)."""
    nilyr = zTin.shape[0]
    kappal = 8.824e-8
    ra_const = ct.gravit / (ct.viscosity_dyn * kappal)
    fracmax = 0.2
    zSin_min = 0.1
    safety = 10.0

    Sbr = liquidus_brine_salinity(zTin)
    phi = liquid_fraction(zTin, zSin)
    qbr = enthalpy_brine(zTin)
    rho = density_brine(Sbr)
    rho_up = torch.cat([rho[:1], rho[:-1]], dim=0)  # rho(k-1), rho(0)=rho(1)
    rho_ocn = density_brine(sss)
    qlimit = fracmax * hilyr / dt

    # upward sweep accumulators, bottom-up
    qs = [None] * nilyr
    dSdts = [None] * nilyr
    perm_min = torch.full_like(Tsf, ct.bignum)
    perm_harm = torch.zeros_like(Tsf)
    rho_sum = torch.zeros_like(Tsf)
    for idx, k in enumerate(range(nilyr - 1, -1, -1)):
        z = ((k + 0.5) / nilyr) * hin
        perm = permeability(phi[k])
        perm_min = torch.minimum(perm_min, perm)
        perm_harm = perm_harm + 1.0 / torch.clamp(perm, min=1.0e-30)
        rho_sum = rho_sum + rho[k]
        rho_pipe = 0.5 * (rho[k] + rho_up[k])
        drho = torch.clamp(rho[k] - rho_ocn, min=0.0)
        Ra = drho * (hin - z) * perm_min * ra_const
        rn = float(idx + 1)
        L = rn * hilyr
        dx = L * 2.0 * aspect_rapid
        dx2 = dx * dx
        Am = (dx2 * rn) / (ct.viscosity_dyn * perm_harm)
        Bm = (-ct.gravit * rho_sum) / rn
        Ap = (ct.pi * a_rapid ** 4) / (8.0 * ct.viscosity_dyn)
        Bp = -rho_pipe * ct.gravit
        qk = torch.clamp((Am / dx2) * ((-Ap * Bp - Am * Bm) / (Am + Ap) + Bm),
                         min=1.0e-30)
        qk = torch.minimum(qk * (torch.clamp(Ra - Rac_rapid, min=0.0)
                                 / (Ra + ct.puny)), qlimit)
        dS = dSdt_slow * (torch.clamp(zSin[k] - phi_c * Sbr[k], min=0.0)
                          * torch.clamp(Tbot - Tsf, min=0.0)) / (hin + 0.001)
        dS = torch.maximum(dS, -zSin[k] * 0.5 / dt)
        # restrict flows to prevent too much salt loss
        Sbr_kp = Sbr[k + 1] if k + 1 < nilyr else sss
        dS_guess = ((qk * (Sbr_kp - Sbr[k])) / hilyr + dS) * dt * safety
        tiny = torch.abs(dS_guess) < ct.puny
        alpha = torch.where(tiny, 1.0, (zSin_min - zSin[k])
                            / torch.where(tiny, 1.0, dS_guess))
        alpha = torch.where((alpha < 0.0) | (alpha > 1.0), 1.0, alpha)
        qs[k] = qk * alpha
        dSdts[k] = dS * alpha
    return torch.stack(qs), torch.stack(dSdts), Sbr, qbr


def solve_salinity(dt, zSin, Sbr, Spond, sss, q, dSdt, w, hilyr):
    """Explicit salinity update (ice_therm_mushy.F90:2810-2885)."""
    S_min = 0.01
    Sbr_up = torch.cat([torch.broadcast_to(Spond[None], Sbr[:1].shape),
                        Sbr[:-1]], dim=0)      # Sbr(k-1); k=0 -> Spond
    Sbr_dn = torch.cat([Sbr[1:],
                        torch.broadcast_to(sss[None], Sbr[:1].shape)],
                       dim=0)                  # Sbr(k+1); bottom -> sss
    dS = ((q * (Sbr_dn - Sbr)) / hilyr + dSdt
          + (w[None] * (Sbr_up - Sbr)) / hilyr) * dt
    return zSin + torch.maximum(S_min - zSin, dS)


# Picard heat solver

def _intercell(lsnow, hilyr, hslyr, km, ks, nilyr, nslyr):
    """dxp/kcstar per unified interface (calc_intercell_thickness /
    -conductivity), the snow and no-snow layouts selected per cell.
    Interface i = 0..nslyr+nilyr: 0 the surface, nslyr the snow/ice
    interface (or, without snow, the top of the ice), nslyr+nilyr the
    bottom."""
    dxp_s, kc_s = [hslyr / 2.0], [ks[0]]
    for k in range(1, nslyr):
        dxp_s.append(hslyr)
        kc_s.append(2.0 * ks[k] * ks[k - 1] / (ks[k] + ks[k - 1]))
    dxp_s.append((hilyr + hslyr) / 2.0)
    fe = hilyr / (hilyr + hslyr)
    kc_s.append(1.0 / ((1.0 - fe) / ks[nslyr - 1] + fe / km[0]))
    for k in range(1, nilyr):
        dxp_s.append(hilyr)
        kc_s.append(2.0 * km[k] * km[k - 1] / (km[k] + km[k - 1]))
    dxp_s.append(hilyr / 2.0)
    kc_s.append(km[nilyr - 1])

    # no-snow layout, padded so ice layer k still couples interfaces
    # (nslyr+k, nslyr+k+1)
    dxp_n = [hilyr] * (nslyr + nilyr + 1)
    kc_n = [torch.zeros_like(hilyr)] * (nslyr + nilyr + 1)
    dxp_n[nslyr] = hilyr / 2.0
    kc_n[nslyr] = km[0]
    for k in range(1, nilyr):
        dxp_n[nslyr + k] = hilyr
        kc_n[nslyr + k] = 2.0 * km[k] * km[k - 1] / (km[k] + km[k - 1])
    dxp_n[nslyr + nilyr] = hilyr / 2.0
    kc_n[nslyr + nilyr] = km[nilyr - 1]

    dxp = [torch.where(lsnow, a, b) for a, b in zip(dxp_s, dxp_n)]
    kc = [torch.where(lsnow, a, b) for a, b in zip(kc_s, kc_n)]
    return dxp, kc


class PicardResult(NamedTuple):
    Tsf: torch.Tensor
    zqin: torch.Tensor
    zqsn: torch.Tensor
    zTin: torch.Tensor
    zTsn: torch.Tensor
    zSin: torch.Tensor
    fcondtop: torch.Tensor
    fcondbot: torch.Tensor
    fadvheat: torch.Tensor
    flwoutn: torch.Tensor
    fsensn: torch.Tensor
    flatn: torch.Tensor
    fsurfn: torch.Tensor
    converged: torch.Tensor
    niter: torch.Tensor         # Picard passes (0-d int64)


def _drainage_heat(zTin, q, w, qocn, qpond, nilyr):
    """Advective heat of the drainage flows (ice_therm_mushy.F90:
    1740-1764)."""
    qbr = enthalpy_brine(zTin)
    qbr_dn = torch.cat([qbr[1:], torch.broadcast_to(qocn[None],
                                                    qbr[:1].shape)], dim=0)
    fadv = -(q * (qbr_dn - qbr)).sum(0)
    return fadv + w * (qbr[nilyr - 1] - qpond)


def _conductive_fluxes(Tsf, zTsn, zTin, lsnow, km, ks, hilyr, hslyr, Tbot,
                       nilyr):
    fcb = 2.0 * km[nilyr - 1] * (zTin[nilyr - 1] - Tbot) \
        / torch.clamp(hilyr, min=ct.puny)
    fct = torch.where(
        lsnow,
        2.0 * ks[0] * (Tsf - zTsn[0]) / torch.clamp(hslyr, min=ct.puny),
        2.0 * km[0] * (Tsf - zTin[0]) / torch.clamp(hilyr, min=ct.puny))
    return fct, fcb


def picard_solver(dt, *, nilyr, nslyr, mask, lsnow, lcold,
                  Tsf, zqsn0, zqin0, zSin0, phi, km, ks,
                  Iswabs, Sswabs, Tbot, fswint, fswsfc,
                  rhoa, flw, potT, Qa, shcoef, lhcoef,
                  qpond, qocn, Spond, sss, q, dSdt, w,
                  hilyr, hslyr, dtemp_errmax=DTEMP_ERRMAX,
                  nit_max=NIT_MAX) -> PicardResult:
    """Batched Picard iteration (ice_therm_mushy.F90:1324-1620)."""
    nmat = 1 + nslyr + nilyr
    B = tuple(Tsf.shape)
    dtype = Tsf.dtype
    kw = dict(dtype=dtype, device=Tsf.device)
    crw = _crw

    zTin = temperature_mush(zqin0, zSin0)
    zTsn = torch.where(lsnow[None], temperature_snow(zqsn0), 0.0)
    dxp, kc = _intercell(lsnow, hilyr, hslyr, km, ks, nilyr, nslyr)
    if dtype == torch.float64:
        ferrmax_eff = thsh.ferrmax
    else:
        # f32: scale-aware energy tolerance; the residual is measured from
        # enthalpies that only resolve ~eps32*|q| (einit0: the initial
        # column energy)
        eps32 = 1.2e-7
        einit0 = (torch.where(lsnow, (hslyr[None] * zqsn0).sum(0), 0.0)
                  + (hilyr[None] * zqin0).sum(0))
        ferrmax_eff = 1.0e-2 + 8.0 * eps32 * torch.abs(einit0) / dt
    # f32: marginal cells oscillate against 5e-4 K at the tridiag noise
    # floor; 5e-3 K stays inside the reference's acceptable < 0.01 K
    dtemp_errmax_eff = (dtemp_errmax if dtype == torch.float64
                        else max(float(dtemp_errmax) * 10.0, 5.0e-3))

    one = torch.ones(B, **kw)
    zero = torch.zeros(B, **kw)
    kc_sfc = torch.where(lsnow, kc[0], kc[nslyr])
    dx_sfc = torch.where(lsnow, dxp[0], dxp[nslyr])

    def assemble(Tsf_c):
        """The unified padded matrix: the surface row sits at 0 under
        snow and at nslyr without it (cold surfaces only); rows 1..nslyr
        are snow, nslyr+1.. ice."""
        sb, dg, sp, rh = [], [], [], []
        dfsurf = thsh.dsurface_heat_flux_dTsf(Tsf_c, rhoa, shcoef, lhcoef)[0]
        fsurf = thsh.surface_heat_flux(Tsf_c, fswsfc, rhoa, flw, potT, Qa,
                                       shcoef, lhcoef)[3]
        sfc_dg = dfsurf - kc_sfc / dx_sfc
        sfc_sp = kc_sfc / dx_sfc
        sfc_rh = dfsurf * Tsf_c - fsurf
        for r in range(nmat):
            if r >= nslyr + 1:
                k = r - nslyr - 1
                kct, dxt = kc[r - 1], dxp[r - 1]
                kcb, dxb = kc[r], dxp[r]
                cap = (phi[k] * (crw - _cri) + _cri) / dt * hilyr
                qk = q[k]
                dg_i = cap + kcb / dxb + kct / dxt + qk * crw + w * crw
                sp_i = -kcb / dxb - qk * crw
                sb_i = -kct / dxt - w * crw
                rh_i = (((1.0 - phi[k]) * ct.rhoi * ct.Lfresh + zqin0[k])
                        / dt) * hilyr + Iswabs[k]
                if k == 0:
                    rh_i = rh_i + w * qpond
                    # top ice layer: under snow the row above is snow;
                    # without snow it is the surface row (cold) or a known
                    # Tsf that moves into the rhs (melting)
                    sb_keep = torch.where(lsnow, sb_i, -kct / dxt)
                    known = ~lsnow & ~lcold
                    rh_i = torch.where(known, rh_i + (kct * Tsf_c) / dxt,
                                       rh_i)
                    sb_i = torch.where(known, zero, sb_keep)
                if k == nilyr - 1:
                    sp_i = zero
                    rh_i = rh_i + (kcb * Tbot) / dxb + qk * qocn
                sb.append(sb_i)
                dg.append(dg_i)
                sp.append(sp_i)
                rh.append(rh_i)
                continue
            is_sfc = lcold & ((lsnow & (r == 0)) | (~lsnow & (r == nslyr)))
            if 1 <= r <= nslyr:
                k = r - 1
                kct, dxt = kc[r - 1], dxp[r - 1]
                kcb, dxb = kc[r], dxp[r]
                dg_s = (ct.rhos * ct.cp_ice / dt) * hslyr \
                    + kcb / dxb + kct / dxt
                sp_s = -kcb / dxb
                sb_s = -kct / dxt
                rh_s = ((ct.rhos * ct.Lfresh + zqsn0[k]) / dt) * hslyr \
                    + Sswabs[k]
                if k == 0:
                    rh_s = torch.where(lcold, rh_s,
                                       rh_s + (kct * Tsf_c) / dxt)
                    sb_s = torch.where(lcold, sb_s, zero)
                row_on = lsnow
            else:
                sb_s = sp_s = rh_s = zero
                dg_s = one
                row_on = torch.zeros_like(lsnow)
            sb.append(torch.where(is_sfc, zero,
                                  torch.where(row_on, sb_s, zero)))
            dg.append(torch.where(is_sfc, sfc_dg,
                                  torch.where(row_on, dg_s, one)))
            sp.append(torch.where(is_sfc, sfc_sp,
                                  torch.where(row_on, sp_s, zero)))
            rh.append(torch.where(is_sfc, sfc_rh,
                                  torch.where(row_on, rh_s, zero)))
        return (torch.stack(sb), torch.stack(dg), torch.stack(sp),
                torch.stack(rh))

    def pending(c):
        return (c["niter"] < nit_max) & (~c["converged"]).any()

    def body(c, go):
        """One Picard pass (ops/loop.py): the cells not yet converged
        move, and none when ``go`` is False."""
        c_Tsf, c_zTsn, c_zTin = c["Tsf"], c["zTsn"], c["zTin"]
        active = ~c["converged"] & go
        T = tridiag_solve(*assemble(c_Tsf))
        Tsf_new = torch.where(lcold, torch.where(lsnow, T[0], T[nslyr]), 0.0)
        zTsn_new = torch.where(lsnow[None], T[1:1 + nslyr], 0.0)
        zTin_new = T[1 + nslyr:]
        fadv = _drainage_heat(zTin_new, q, w, qocn, qpond, nilyr)

        # convergence (check_picard_convergence :1700-1722)
        dTsf = torch.abs(Tsf_new - c_Tsf)
        dzTsn = torch.where(lsnow, torch.abs(zTsn_new - c_zTsn).amax(0), 0.0)
        dzTin = torch.abs(zTin_new - c_zTin).amax(0)
        zqin_new = enthalpy_mush_liquid_fraction(zTin_new, phi)
        zqsn_new = enthalpy_snow(zTsn_new)
        # energy change in difference form (cancellation-safe in f32)
        dener = (torch.where(lsnow, (hslyr[None] * (zqsn_new - zqsn0)).sum(0),
                             0.0)
                 + (hilyr[None] * (zqin_new - zqin0)).sum(0))
        fct, fcb = _conductive_fluxes(Tsf_new, zTsn_new, zTin_new, lsnow,
                                      km, ks, hilyr, hslyr, Tbot, nilyr)
        ferr = dener / dt - (fct - fcb + fswint - fadv)
        conv = ((dTsf < dtemp_errmax_eff) & (dzTsn < dtemp_errmax_eff)
                & (dzTin < dtemp_errmax_eff)
                & (torch.abs(ferr) < 0.9 * ferrmax_eff))
        return dict(Tsf=torch.where(active, Tsf_new, c_Tsf),
                    zTsn=torch.where(active[None], zTsn_new, c_zTsn),
                    zTin=torch.where(active[None], zTin_new, c_zTin),
                    converged=c["converged"] | (conv & active),
                    niter=c["niter"] + go)

    # the loop carries only the unknowns; every flux of the result is a
    # function of the frozen Tsf/zTsn/zTin and is computed after the loop
    c = while_loop(body, pending, dict(
        Tsf=torch.where(lcold, Tsf, 0.0), zTsn=zTsn, zTin=zTin,
        converged=~mask,
        niter=torch.zeros((), dtype=torch.int64, device=Tsf.device)))
    c_Tsf, c_zTsn, c_zTin = c["Tsf"], c["zTsn"], c["zTin"]

    zqin = enthalpy_mush_liquid_fraction(c_zTin, phi)
    zqsn = torch.where(lsnow[None], enthalpy_snow(c_zTsn), zqsn0)
    zSin = solve_salinity(dt, zSin0, liquidus_brine_salinity(c_zTin), Spond,
                          sss, q, dSdt, w, hilyr)
    flwo, fsen, flat_, fsur = thsh.surface_heat_flux(
        c_Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef)
    # diagnostic fluxes from the frozen solution (the values each cell saw
    # at its converging pass; masked cells -> 0)
    fadv = _drainage_heat(c_zTin, q, w, qocn, qpond, nilyr)
    fct, fcb = _conductive_fluxes(c_Tsf, c_zTsn, c_zTin, lsnow, km, ks,
                                  hilyr, hslyr, Tbot, nilyr)
    return PicardResult(
        Tsf=c_Tsf, zqin=zqin, zqsn=zqsn, zTin=c_zTin, zTsn=c_zTsn,
        zSin=zSin, fcondtop=torch.where(mask, fct, zero),
        fcondbot=torch.where(mask, fcb, zero),
        fadvheat=torch.where(mask, fadv, zero), flwoutn=flwo, fsensn=fsen,
        flatn=flat_, fsurfn=fsur, converged=c["converged"],
        niter=c["niter"])


# flood ice (snow-ice formation) + pond flushing

def _regrid_ice(trc, hlyr1, hlyr2, h1, h2, trc0):
    """Conservative regrid with new material added at the top
    (update_vertical_tracers_ice, ice_therm_mushy.F90:3490-3560)."""
    nilyr = trc.shape[0]
    hl2 = torch.clamp(hlyr2, min=1e-30)
    dh = h2 - h1
    outs = []
    for k2 in range(nilyr):
        z2a = k2 * hlyr2
        z2b = (k2 + 1) * hlyr2
        acc = torch.clamp(torch.minimum(dh, z2b) - torch.clamp(z2a, min=0.0),
                          min=0.0) * trc0
        for k1 in range(nilyr):
            z1a = k1 * hlyr1 + dh
            z1b = (k1 + 1) * hlyr1 + dh
            ov = torch.clamp(torch.minimum(z1b, z2b) - torch.maximum(z1a, z2a),
                             min=0.0)
            acc = acc + ov * trc[k1]
        outs.append(acc / hl2)
    return torch.stack(outs)


def _regrid_snow(trc, hlyr1, hlyr2):
    nslyr = trc.shape[0]
    hl2 = torch.clamp(hlyr2, min=1e-30)
    outs = []
    for k2 in range(nslyr):
        z2a = k2 * hlyr2
        z2b = (k2 + 1) * hlyr2
        acc = torch.zeros_like(trc[0])
        for k1 in range(nslyr):
            z1a = k1 * hlyr1
            z1b = (k1 + 1) * hlyr1
            ov = torch.clamp(torch.minimum(z1b, z2b) - torch.maximum(z1a, z2a),
                             min=0.0)
            acc = acc + ov * trc[k1]
        outs.append(acc / hl2)
    return torch.stack(outs)


def flush_pond(dt, w, hpond, apond):
    """Drain ponds by flushing + exponential decay
    (ice_therm_mushy.F90:3230-3263)."""
    lam = 1.0 / (10.0 * 86400.0)
    hpond0 = 0.01
    on = (apond > 0.0) & (hpond > 0.0)
    hp = torch.clamp(hpond - w * dt / torch.clamp(apond, min=ct.puny),
                     min=0.0)
    hp = torch.clamp(hp - lam * dt * (hp + hpond0), min=0.0)
    return torch.where(on, hp, hpond)


def flood_ice(dt, *, nilyr, nslyr, hsn, hin, hslyr, hilyr, zqsn, zqin,
              phi, zSin, Sbr, sss, qocn):
    """Snow-ice formation from negative freeboard
    (ice_therm_mushy.F90:3265-3460 flood_ice).

    Returns (hslyr, hilyr, zqsn, zqin, zSin, phi, snoice, fadvheat_add)."""
    rho_ocn = density_brine(sss)
    ice_density = torch.minimum(phi * density_brine(Sbr)
                                + (1.0 - phi) * ct.rhoi, rho_ocn[None])
    ice_mass = ice_density.sum(0) * hilyr
    fb_density = torch.clamp(ice_mass + hsn * ct.rhos - hin * rho_ocn,
                             min=0.0)
    fl = (hsn > ct.puny) & (fb_density > 0.0)

    phi_si = 1.0 - ct.rhos / ct.rhoi
    rho_si = phi_si * rho_ocn + (1.0 - phi_si) * ct.rhoi
    dh = fb_density / torch.clamp(rho_ocn - rho_si + ct.rhos, min=ct.puny)
    dh = torch.where(fl, torch.minimum(torch.clamp(dh, min=0.0), hsn), 0.0)

    # mean enthalpy of the converted bottom dh of snow (snow layer k spans
    # [k, k+1]*hslyr from the top; the bottom dh spans [hsn-dh, hsn])
    acc = torch.zeros_like(dh)
    for k in range(nslyr):
        lo = torch.maximum(k * hslyr, hsn - dh)
        hi = torch.minimum((k + 1) * hslyr, hsn)
        acc = acc + torch.clamp(hi - lo, min=0.0) * zqsn[k]
    zqsn_si = torch.where(fl, acc / torch.clamp(dh, min=1e-30), 0.0)

    hin2 = hin + dh
    hsn2 = hsn - dh
    hilyr2 = hin2 / nilyr
    hslyr2 = hsn2 / nslyr
    zSin_si = phi_si * sss
    zqin_si = phi_si * qocn + zqsn_si

    zqsn_new = _regrid_snow(zqsn, hslyr, hslyr2)
    zqin_new = _regrid_ice(zqin, hilyr, hilyr2, hin, hin2, zqin_si)
    zSin_new = _regrid_ice(zSin, hilyr, hilyr2, hin, hin2, zSin_si)
    phi_new = _regrid_ice(phi, hilyr, hilyr2, hin, hin2, phi_si)

    fadv_add = torch.where(fl, -(dh * phi_si / dt) * qocn, 0.0)
    sel = lambda new, old: torch.where(fl, new, old)
    selk = lambda new, old: torch.where(fl[None], new, old)
    return (sel(hslyr2, hslyr), sel(hilyr2, hilyr),
            selk(zqsn_new, zqsn), selk(zqin_new, zqin),
            selk(zSin_new, zSin), selk(phi_new, phi),
            torch.where(fl, dh, 0.0), fadv_add)


# top-level driver

class MushyResult(NamedTuple):
    Tsf: torch.Tensor
    zqin: torch.Tensor
    zqsn: torch.Tensor
    zTin: torch.Tensor
    zTsn: torch.Tensor
    zSin: torch.Tensor
    hilyr: torch.Tensor
    hslyr: torch.Tensor
    hpond: torch.Tensor
    fsensn: torch.Tensor
    flatn: torch.Tensor
    flwoutn: torch.Tensor
    fsurfn: torch.Tensor
    fcondtopn: torch.Tensor
    fcondbot: torch.Tensor
    fadvocn: torch.Tensor
    snoice: torch.Tensor
    converged: torch.Tensor
    niter: torch.Tensor         # Picard passes of both stages (0-d)


def temperature_changes_salinity(dt, *, nilyr, nslyr, mask,
                                 rhoa, flw, potT, Qa, shcoef, lhcoef,
                                 fswsfc, fswint, Sswabs, Iswabs,
                                 hilyr, hslyr, zqin, zSin, zqsn,
                                 hpond, apond, Tsf, Tbot, sss,
                                 dSdt_slow_mode=DSDT_SLOW,
                                 phi_c_slow_mode=PHI_C_SLOW,
                                 a_rapid_mode=A_RAPID,
                                 Rac_rapid_mode=RAC_RAPID,
                                 aspect_rapid_mode=ASPECT_RAPID,
                                 dtemp_errmax=DTEMP_ERRMAX,
                                 nit_max=NIT_MAX) -> MushyResult:
    """Full mushy temperature/salinity update
    (temperature_changes_column, ice_therm_mushy.F90:305-599)."""
    lsnow = hslyr > (ct.hs_min / nslyr)
    hilyr = torch.clamp(hilyr, min=ct.puny)
    hin = hilyr * nilyr
    hsn = torch.where(lsnow, hslyr * nslyr, 0.0)
    qocn = enthalpy_brine(Tbot)
    qpond = torch.zeros_like(Tsf)     # enthalpy_brine(0) = 0
    Spond = torch.zeros_like(Tsf)

    zTin0 = temperature_mush(zqin, zSin)
    phi = liquid_fraction(zTin0, zSin)
    w = flushing_velocity(dt, zTin0, zSin, phi, hin, hsn, hilyr, hpond,
                          apond)
    q, dSdt, _, _ = explicit_flow_velocities(
        dt, zSin, zTin0, Tsf, Tbot, sss, qocn, hilyr, hin,
        dSdt_slow=dSdt_slow_mode, phi_c=phi_c_slow_mode,
        a_rapid=a_rapid_mode, Rac_rapid=Rac_rapid_mode,
        aspect_rapid=aspect_rapid_mode)
    km = conductivity_mush(temperature_mush(zqin, zSin), zSin)
    ks = torch.full((nslyr,) + tuple(Tsf.shape), ct.ksno, dtype=zqin.dtype,
                    device=zqin.device)

    common = dict(nilyr=nilyr, nslyr=nslyr, lsnow=lsnow, Tsf=Tsf,
                  zqsn0=zqsn, zqin0=zqin, zSin0=zSin, phi=phi, km=km, ks=ks,
                  Iswabs=Iswabs, Sswabs=Sswabs, Tbot=Tbot, fswint=fswint,
                  fswsfc=fswsfc, rhoa=rhoa, flw=flw, potT=potT, Qa=Qa,
                  shcoef=shcoef, lhcoef=lhcoef, qpond=qpond, qocn=qocn,
                  Spond=Spond, sss=sss, q=q, dSdt=dSdt, w=w, hilyr=hilyr,
                  hslyr=torch.clamp(hslyr, min=ct.puny),
                  dtemp_errmax=dtemp_errmax, nit_max=nit_max)

    # two-stage: solve with the initial surface condition, then re-solve
    # the cells whose surface flipped (two_stage_solver_{snow,nosnow},
    # :601-1320); stage 2 starts with every consistent cell converged, so
    # it runs no pass at all when nothing flipped
    lcold1 = Tsf < 0.0
    s1 = picard_solver(dt, mask=mask, lcold=lcold1, **common)
    ok1 = torch.where(lcold1, s1.Tsf < DTEMP_ERRMAX,
                      s1.fcondtop - s1.fsurfn < thsh.ferrmax)
    s2 = picard_solver(dt, mask=mask & ~ok1, lcold=~lcold1, **common)

    pick = lambda a, b: torch.where(ok1, a, b)
    pickk = lambda a, b: torch.where(ok1[None], a, b)
    Tsf_f = pick(s1.Tsf, s2.Tsf)
    zqin_f = pickk(s1.zqin, s2.zqin)
    zqsn_f = pickk(s1.zqsn, s2.zqsn)
    zTin_f = pickk(s1.zTin, s2.zTin)
    zTsn_f = pickk(s1.zTsn, s2.zTsn)
    zSin_f = pickk(s1.zSin, s2.zSin)
    fct = pick(s1.fcondtop, s2.fcondtop)
    fcb = pick(s1.fcondbot, s2.fcondbot)
    fadv = pick(s1.fadvheat, s2.fadvheat)
    flwo = pick(s1.flwoutn, s2.flwoutn)
    fsen = pick(s1.fsensn, s2.fsensn)
    flat_ = pick(s1.flatn, s2.flatn)
    fsur = pick(s1.fsurfn, s2.fsurfn)
    convd = pick(s1.converged, s2.converged)

    phi_f = liquid_fraction(zTin_f, zSin_f)
    Sbr_f = liquidus_brine_salinity(zTin_f)

    # pond flushing + snow-ice flooding (:560-597)
    hpond_f = flush_pond(dt, w, hpond, apond)
    hslyr_f, hilyr_f, zqsn_f, zqin_f, zSin_f, phi_f, snoice, fadv_add = \
        flood_ice(dt, nilyr=nilyr, nslyr=nslyr, hsn=hsn, hin=hin,
                  hslyr=torch.clamp(hslyr, min=ct.puny), hilyr=hilyr,
                  zqsn=zqsn_f, zqin=zqin_f, phi=phi_f, zSin=zSin_f,
                  Sbr=Sbr_f, sss=sss, qocn=qocn)
    fadv = fadv + fadv_add
    zTin_f = temperature_mush_liquid_fraction(zqin_f, phi_f)

    m = mask
    msk = lambda x, orig: torch.where(m, x, orig)
    mskk = lambda x, orig: torch.where(m[None], x, orig)
    return MushyResult(
        Tsf=msk(Tsf_f, Tsf), zqin=mskk(zqin_f, zqin),
        zqsn=mskk(zqsn_f, zqsn), zTin=mskk(zTin_f, zTin0),
        zTsn=mskk(zTsn_f, torch.zeros_like(zqsn)),
        zSin=mskk(zSin_f, zSin),
        hilyr=msk(hilyr_f, hilyr), hslyr=msk(hslyr_f, hslyr),
        hpond=msk(hpond_f, hpond),
        fsensn=torch.where(m, fsen, 0.0), flatn=torch.where(m, flat_, 0.0),
        flwoutn=torch.where(m, flwo, 0.0), fsurfn=torch.where(m, fsur, 0.0),
        fcondtopn=torch.where(m, fct, 0.0), fcondbot=torch.where(m, fcb, 0.0),
        fadvocn=torch.where(m, fadv, 0.0),
        snoice=torch.where(m, snoice, 0.0),
        converged=convd | ~m, niter=s1.niter + s2.niter)
