"""Level-ice melt ponds (PyTorch port of the level-pond part of
``cice5_tpu/models/tracers/ponds.py``; ice_meltpond_lvl.F90
compute_ponds_lvl :79, brine_permeability :351, and the column
permeability of ice_meltpond_topo.F90 permeability_phi :812). Dense
elementwise per-category updates over any batch *B."""
from __future__ import annotations

from typing import NamedTuple

import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.models.thermo.shared import calculate_Tin_from_qin

HI_MIN = 0.1      # min ice thickness carrying ponds (hi_min for kitd=0 scale)
TD = 2.0          # freeze-up temperature difference (C)
REXP = 0.01       # pond contraction scaling


def brine_permeability(qicen, sicen, Tmlt):
    """Minimum-liquid-fraction permeability (ice_meltpond_lvl.F90:351-404):
    Sbr from Notz (2005) eq 3.6, phi = S/Sbr, perm = 3e-8 min(phi)^3.
    qicen/sicen/Tmlt: (nilyr, *B). Returns perm (*B)."""
    Tin = calculate_Tin_from_qin(qicen, Tmlt)
    Sbr = 1.0 / (1.0e-3 - ct.depressT / torch.clamp(Tin, max=-ct.puny))
    phi = sicen / torch.clamp(Sbr, min=ct.puny)
    phi = torch.where(phi < 0.05, 0.0, phi)
    return 3.0e-8 * phi.amin(0) ** 3


def permeability_phi(qicen, sicen, Tsfcn, Tf, heat_capacity=True):
    """Liquid fraction + permeability of the ice column
    (ice_meltpond_topo.F90:812-919 permeability_phi): 3e-8 * min_k(phi)^3
    with phi from the Assur-1958 brine salinity for cold ice (max Tin <=
    -2 C) and Notz-2005 (eq 3.2) otherwise. qicen/sicen: (nilyr, *B)."""
    if heat_capacity:
        Tin = calculate_Tin_from_qin(qicen, -sicen * ct.depressT)
    else:
        Tin = torch.broadcast_to(0.5 * (Tsfcn + Tf), qicen.shape)
    cold = Tin.amax(0) <= -2.0
    Sbr_assur = (-1.2 - 21.8 * Tin - 0.919 * Tin ** 2
                 - 0.01878 * Tin ** 3)
    Sbr_notz = -17.6 * Tin - 0.389 * Tin ** 2 - 0.00362 * Tin ** 3
    Sbr = torch.where(cold[None], Sbr_assur, Sbr_notz)
    sref = sicen if heat_capacity else ct.ice_ref_salinity
    phi = sref / torch.clamp(Sbr, min=ct.puny)
    return 3.0e-8 * phi.amin(0) ** 3


class PondsLvlResult(NamedTuple):
    apnd: torch.Tensor
    hpnd: torch.Tensor
    ipnd: torch.Tensor


def compute_ponds_lvl(dt, *, aicen, vicen, vsnon, Tsfcn, alvl, apnd, hpnd,
                      ipnd, meltt, melts, frain, rfrac, Tair, fsurfn, dhs,
                      qicen, sicen, pndaspect=0.8, frzpnd="cesm",
                      dpscale=0.001, ktherm=1) -> PondsLvlResult:
    """Level-ice pond scheme (ice_meltpond_lvl.F90:79-349).

    apnd is the pond fraction of level ice area (aicen*alvl); ipnd the
    refrozen-lid thickness (frzpnd='hlid'). qicen/sicen: (nilyr, *B)."""
    lvl_area = aicen * alvl
    has = lvl_area > ct.puny ** 2
    ai = torch.clamp(aicen, min=ct.puny)
    hi = torch.where(aicen > ct.puny, vicen / ai, 0.0)
    hs = torch.where(aicen > ct.puny, vsnon / ai, 0.0)

    volpn = hpnd * lvl_area * apnd
    apondn = apnd * alvl                       # fraction of ice area

    dvn = rfrac / ct.rhofresh * (meltt * ct.rhoi + melts * ct.rhos
                                 + frain * dt) * aicen
    if frzpnd == "cesm":
        Tp = ct.Timelt - TD
        dTs = torch.clamp(Tp - Tsfcn, min=0.0)
        dvn = dvn - volpn * (1.0 - torch.exp(REXP * dTs / Tp))
        hlid = torch.zeros_like(hi)
    else:   # 'hlid' Stefan refreezing lid
        hlid = ipnd
        Ts = Tair - ct.Tffresh
        freezing = (dvn == 0.0) & (Ts < 0.0)
        bdt = -2.0 * Ts * ct.kice * dt / (ct.rhoi * ct.Lfresh)
        dhlid_new = 0.5 * torch.sqrt(torch.clamp(bdt, min=0.0))
        dhlid_ice = 0.5 * bdt / torch.clamp(hlid, min=ct.puny)
        dhlid_f = torch.where(hlid > dhlid_new, dhlid_ice, dhlid_new)
        dhlid_f = torch.minimum(dhlid_f, hpnd * ct.rhofresh / ct.rhoi)
        # melting of the lid
        dhlid_m = -torch.minimum(
            torch.clamp(fsurfn * dt / (ct.rhoi * ct.Lfresh), min=0.0), hlid)
        dhlid = torch.where(freezing, dhlid_f,
                            torch.where(dvn == 0.0, 0.0, dhlid_m))
        hlid = torch.clamp(hlid + dhlid, min=0.0)
        alid = apondn * aicen
        dvn = dvn - dhlid * alid * ct.rhoi / ct.rhofresh

    volpn = volpn + dvn
    apondn = torch.where(volpn <= 0.0, 0.0, apondn)
    volpn = torch.clamp(volpn, min=0.0)

    existing = apondn * aicen > ct.puny
    ap_ex = torch.minimum(torch.clamp(
        apondn + 0.5 * dvn / torch.clamp(pndaspect * apondn * aicen,
                                         min=ct.puny), min=0.0), alvl)
    hp_ex = torch.where(ap_ex > ct.puny,
                        volpn / torch.clamp(ap_ex * aicen, min=ct.puny), 0.0)
    newp = lvl_area > 10.0 * ct.puny
    ap_new = torch.minimum(torch.sqrt(volpn / (pndaspect * ai)), alvl)
    hp_new = pndaspect * ap_new
    apondn = torch.where(existing, ap_ex, torch.where(newp, ap_new, 0.0))
    hpondn = torch.where(existing, hp_ex, torch.where(newp, hp_new, 0.0))
    apondn = torch.clamp(apondn, min=0.0)

    # nonnegative freeboard limit
    hpondn = torch.minimum(hpondn, ((ct.rhow - ct.rhoi) * hi - ct.rhos * hs)
                           / ct.rhofresh)
    hpondn = torch.clamp(hpondn, min=0.0)
    apondn = apondn * aicen                      # grid-cell fraction
    volpn = hpondn * apondn
    dead = volpn <= 0.0
    apondn = torch.where(dead, 0.0, apondn)
    hpondn = torch.where(dead, 0.0, hpondn)
    hlid = torch.where(dead, 0.0, hlid)

    # permeability drainage (BL99 only; mushy ice drains by flushing)
    if ktherm != 2 and dpscale > ct.puny:
        draft = (ct.rhos * hs + ct.rhoi * hi) / ct.rhow + hpondn
        deltah = hpondn + hi - draft
        head = ct.gravit * ct.rhow * torch.clamp(deltah, min=0.0)
        perm = brine_permeability(qicen, sicen, -sicen * ct.depressT)
        drain = perm * head * dt / (ct.viscosity_dyn
                                    * torch.clamp(hi, min=ct.puny)) * dpscale
        deltah2 = torch.minimum(drain, hpondn)
        do_drain = hpondn > 0.0
        dvn2 = torch.where(do_drain, -deltah2 * apondn, 0.0)
        volpn = volpn + dvn2
        apondn2 = torch.minimum(torch.clamp(
            apondn + 0.5 * dvn2 / torch.clamp(pndaspect * apondn,
                                              min=ct.puny), min=0.0),
            lvl_area)
        apondn = torch.where(do_drain, apondn2, apondn)
        hpondn = torch.where(apondn > ct.puny,
                             volpn / torch.clamp(apondn, min=ct.puny), 0.0)

    thin = (hi < HI_MIN) | ~has
    apondn = torch.where(thin, 0.0, apondn)
    hpondn = torch.where(thin, 0.0, hpondn)
    hlid = torch.where(thin, 0.0, hlid)

    apnd_out = torch.where(has, apondn / torch.clamp(lvl_area, min=ct.puny),
                           0.0)
    return PondsLvlResult(apnd=apnd_out, hpnd=hpondn, ipnd=hlid)
