"""Skeletal-layer biogeochemistry (PyTorch port of
``cice5_tpu/models/tracers/algae.py``; reference ice_algae.F90).

A single 3-cm porous skeletal layer at the ice bottom carries algal
nitrogen and the optional nutrient and sulfur-cycle tracers (mmol per m^2
of the layer, i.e. concentration * sk_l). Each step: seed new ice from the
ocean concentrations, exchange with the ocean through a growth/melt
piston velocity (Jin et al. 2006, or constant), run the NPZD-style
chemistry ``algal_dyn`` (ice_algae.F90:458-800), and flux the remainder to
the ocean. The nbtrcr tracers ride a leading axis in the registry's order;
the per-tracer flags are written on the device by fills.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.models.tracers.brine import PHI_SK, SK_L
from reference.cice.utils import device_values

# stoichiometry + fractions (ice_zbgc_shared.F90:84-89)
R_C2N = 7.0          # algal C : N (mole/mole)
R_chl2N = 3.0        # chlorophyll : N (mg/mmol)
R_S2N = 0.03         # algal S : N (mole/mole)
R_Si2N = 1.5         # algal Si : N (mole/mole; ice_algae.F90:33)
FR_RESP = 0.05       # respiration fraction
R_gC2molC = 12.01    # g carbon per mol (ice_zbgc.F90 PP_net)

# piston-velocity parameters (ice_algae.F90:292-302)
PVC = 1.0e-6
PV_SCALE_GROWTH = 0.5
PV_SCALE_MELT = 0.05
MJ1, MJ2, MJ3 = 9.667e-9, 38.8, 1.04e7
PV_FRAC_MAX = 0.9

# ocean default concentrations (ice_zbgc.F90:385-390)
OCEAN_BIO_DEFAULT = {"N": 0.15, "NO": 5.0, "C": R_C2N * 0.15,
                     "chl": R_chl2N * 0.15, "NH": 1.0, "Sil": 10.0,
                     "DMSPp": R_S2N * 0.15, "DMSPd": R_S2N * 0.15,
                     "DMS": 0.0}


def default_ocean_bio(tr, shape, dtype=torch.float32, device=None):
    """(nbtrcr, *shape) ocean concentrations in the registry's order."""
    return torch.stack([torch.full(tuple(shape), OCEAN_BIO_DEFAULT[n],
                                   dtype=dtype, device=device)
                        for n in tr.bgc_names])


class AlgalDynResult(NamedTuple):
    react: torch.Tensor    # (nbtrcr, ...) reaction increments (mmol/m^3)
    grow_N: torch.Tensor   # specific growth rate (1/s)


def algal_dyn(dt, tr, fswthru, conc) -> AlgalDynResult:
    """Algal N / nutrient / sulfur source-sink chemistry
    (ice_algae.F90:458-800 algal_dyn). conc: (nbtrcr, ...) layer
    concentrations * sk_l (mmol/m^2)."""
    # parameters (ice_algae.F90:516-545)
    T_bot = -1.8
    chlabs = 9.0e-4
    mu_max = 1.5
    T_max = -1.8
    op_dep_min = 0.1
    grow_Tdep = 0.0633
    fr_graze = 0.1
    fr_graze_s = 0.5
    fr_graze_a = 0.5
    fr_graze_e = 0.5
    alpha2max = 0.8
    K_Nit, K_Am, K_Sil = 1.0, 1.0, 4.0
    mort_pre = 0.0208
    mort_Tdep = 0.03
    fr_mort2min = 1.0
    max_loss = 0.9
    fr_excrt_2S = 1.0
    y_sk_DMS = 1.0
    t_sk_conv = 10.0
    t_sk_ox = 10.0
    secday = 86400.0

    name2i = {n: i for i, n in enumerate(tr.bgc_names)}

    def get(n):
        return (conc[name2i[n]] / SK_L if n in name2i
                else torch.zeros_like(fswthru))

    Nin = get("N")
    NOin = get("NO")
    NHin = get("NH")
    Silin = get("Sil")
    DMSPdin = get("DMSPd")
    DMSin = get("DMS")
    chlin = R_chl2N * Nin

    # light limitation through self-shading chlorophyll (:669-689)
    op_dep = chlabs * chlin
    Iavg = torch.where(op_dep > op_dep_min,
                       fswthru * (1.0 - torch.exp(-op_dep))
                       / torch.clamp(op_dep, min=ct.puny), fswthru)
    L_lim = 1.0 - torch.exp(-alpha2max * Iavg)

    # nutrient limitation (:695-705)
    has_NH, has_Sil = "NH" in name2i, "Sil" in name2i
    Nit_lim = NOin / (NOin + K_Nit)
    Am_lim = NHin / (NHin + K_Am) if has_NH else 0.0
    N_lim = torch.clamp(Nit_lim + Am_lim, max=1.0) if has_NH else Nit_lim
    Sil_lim = Silin / (Silin + K_Sil) if has_Sil else 1.0

    # growth and uptake (:707-733)
    growmax_N = mu_max / secday * math.exp(grow_Tdep * (T_bot - T_max)) \
        * Nin
    lim = torch.minimum(L_lim, N_lim)
    lim = torch.minimum(lim, Sil_lim) if has_Sil else \
        torch.clamp(lim, max=Sil_lim)
    grow_N = lim * growmax_N
    potU_Am = Am_lim * growmax_N
    U_Am = torch.minimum(grow_N, potU_Am) if has_NH \
        else torch.clamp(grow_N, max=0.0)
    U_Nit = grow_N - U_Am
    U_Sil = R_Si2N * grow_N
    if has_Sil:
        U_Sil = torch.minimum(U_Sil, max_loss * Silin / dt)
    U_Nit = torch.minimum(U_Nit, max_loss * NOin / dt)
    U_Am = torch.minimum(U_Am, max_loss * NHin / dt)
    grow_N = torch.minimum(U_Sil / R_Si2N, U_Nit + U_Am)
    if has_NH:
        fr_Am = torch.where(grow_N > 0.0, torch.clamp(
            U_Am / torch.clamp(grow_N, min=ct.puny), max=1.0), 0.5)
    else:
        fr_Am = torch.zeros_like(grow_N)
    fr_Nit = 1.0 - fr_Am
    U_Nit = fr_Nit * grow_N
    U_Am = fr_Am * grow_N
    U_Sil = R_Si2N * grow_N

    resp = FR_RESP * grow_N
    graze = fr_graze * grow_N
    mort = mort_pre * math.exp(mort_Tdep * (T_bot - T_max)) * Nin / secday
    nitrif = 0.0

    specific_growth = torch.where(Nin > 0.0,
                                  grow_N / torch.clamp(Nin, min=ct.puny),
                                  grow_N)

    # source/removal terms (:757-800)
    N_s = grow_N * dt
    N_r_g = graze * dt
    N_r_r = resp * dt
    N_r_mo = mort * dt
    N_r = N_r_g + N_r_r + N_r_mo

    NO_s = nitrif * dt
    NO_r = U_Nit * dt
    NH_s = N_r_r + fr_graze_e * fr_graze_a * N_r_g + fr_mort2min * N_r_mo
    NH_r = U_Am * dt + nitrif * dt
    Sil_r = U_Sil * dt

    DMSPd_s = (fr_graze_s * R_S2N * N_r_g
               + fr_excrt_2S * fr_graze_e * fr_graze_a * R_S2N * N_r_g
               + fr_mort2min * R_S2N * N_r_mo)
    DMSPd_r_c = DMSPdin * dt / (t_sk_conv * secday)
    DMS_s = y_sk_DMS * DMSPd_r_c
    DMS_r = DMSin * dt / (t_sk_ox * secday)

    terms = {"N": lambda: N_s - N_r, "NO": lambda: NO_s - NO_r,
             "C": lambda: R_C2N * (N_s - N_r),
             "chl": lambda: torch.zeros_like(N_s),
             "NH": lambda: NH_s - NH_r, "Sil": lambda: -Sil_r,
             "DMSPp": lambda: torch.zeros_like(N_s),
             "DMSPd": lambda: DMSPd_s - DMSPd_r_c,
             "DMS": lambda: DMS_s - DMS_r}
    react = torch.stack([terms[n]() for n in tr.bgc_names])
    return AlgalDynResult(react=react, grow_N=specific_growth)


class SklBgcResult(NamedTuple):
    conc: torch.Tensor       # (nbtrcr, ...) updated layer concentrations
    flux_bio: torch.Tensor   # (nbtrcr, ...) flux to the ocean (mmol/m^2/s)
    grow_N: torch.Tensor     # specific growth rate (1/s)


def skl_biogeochemistry(dt, tr, *, conc, ocean_bio, aicen, meltb, congel,
                        fswthru, first_ice,
                        flux_type: str = "Jin2006") -> SklBgcResult:
    """Skeletal-layer BGC update (ice_algae.F90:196-455
    skl_biogeochemistry). conc: (nbtrcr, ...) tracers; ocean_bio:
    (nbtrcr, ...) ocean concentrations; first_ice: 1.0 seeds from the
    ocean."""
    nb = tr.nbtrcr
    kw = dict(dtype=conc.dtype, device=conc.device)
    active = (aicen > ct.puny)[None]
    rphi = 1.0 / PHI_SK
    name2i = {n: i for i, n in enumerate(tr.bgc_names)}
    iN = name2i["N"]

    # seed newly formed ice from the ocean (:305-335)
    conc = torch.where(active & (first_ice > 0.5)[None],
                       ocean_bio * SK_L * rphi, conc)
    conc = torch.where(active, conc, 0.0)

    # piston velocity (:356-408)
    ice_growth = (congel - meltb) / dt
    if flux_type == "Jin2006":
        pv_grow = -torch.clamp(torch.abs(
            PV_SCALE_GROWTH * (MJ1 + MJ2 * ice_growth
                               - MJ3 * ice_growth ** 2)),
            max=PV_FRAC_MAX * SK_L / dt)
        pv_melt = torch.clamp(torch.abs(
            PV_SCALE_MELT * (MJ2 * ice_growth - MJ3 * ice_growth ** 2)),
            max=PV_FRAC_MAX * SK_L / dt)
        PVt = torch.where(ice_growth > 0.0, pv_grow, pv_melt)
        f_meltn = torch.where(ice_growth < 0.0, PVt * conc[iN] / SK_L, 0.0)
        congel_alg = torch.where(
            (ice_growth > 0.0) & (conc[iN] < ocean_bio[iN] * SK_L / PHI_SK),
            (ocean_bio[iN] * SK_L / PHI_SK - conc[iN]) / dt, 0.0)
    else:   # constant
        PVt = torch.where(ice_growth > 0.0,
                          torch.full_like(ice_growth, -PVC), 0.0)
        congel_alg = torch.where(
            (ice_growth >= 0.0)
            & (conc[iN] / SK_L < ocean_bio[iN] / PHI_SK),
            (ocean_bio[iN] * SK_L / PHI_SK - conc[iN]) / dt, 0.0)
        f_meltn = torch.where(
            ice_growth < 0.0,
            torch.clamp(meltb / SK_L, max=1.0) * conc[iN] / dt, 0.0)

    # chemistry
    dyn = algal_dyn(dt, tr, fswthru, conc)

    # combine the boundary fluxes (:410-440)
    shape1 = (nb,) + (1,) * (conc.ndim - 1)
    pvflag = device_values(tr.bgc_type, **kw).reshape(shape1)
    cling = device_values([1.0 if n == "N" else 0.0 for n in tr.bgc_names],
                          **kw).reshape(shape1)
    pvsgn = torch.sign(PVt)[None] * pvflag
    cinit_tmp = torch.clamp(conc + dyn.react * SK_L, min=0.0)
    flux = (pvsgn * PVt[None] * cinit_tmp / SK_L
            - pvsgn * torch.clamp(PVt, max=0.0)[None] * ocean_bio) \
        + f_meltn[None] * cling
    flux = torch.cat([flux[:iN], (flux[iN] - congel_alg)[None],
                      flux[iN + 1:]])
    flux = torch.where(cinit_tmp < flux * dt,
                       cinit_tmp / dt * (1.0 - ct.puny), flux)
    conc_new = cinit_tmp - flux * dt
    flux_bio = torch.where(active, flux * PHI_SK, 0.0)

    # the derived tracers track algal N (:445-452)
    derived = {"C": R_C2N, "chl": R_chl2N}
    conc_new = torch.stack([conc_new[iN] * derived[n] if n in derived
                            else conc_new[k]
                            for k, n in enumerate(tr.bgc_names)])
    conc_new = torch.where(active, conc_new, conc)
    return SklBgcResult(conc=conc_new, flux_bio=flux_bio,
                        grow_N=torch.where(active[0], dyn.grow_N, 0.0))
