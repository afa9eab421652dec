"""Melt pond tracers: the CESM, level-ice and topographic schemes (PyTorch
port of ``cice5_tpu/models/tracers/ponds.py``; ice_meltpond_cesm.F90
compute_ponds_cesm :61, ice_meltpond_lvl.F90 compute_ponds_lvl :79 and
brine_permeability :351, ice_meltpond_topo.F90 compute_ponds_topo :69,
pond_area :379, calc_hpond :651 and permeability_phi :812). Dense
elementwise per-category updates over any batch *B.

The reference's topographic scheme gathers pond cells into index lists
and runs data-dependent loops (a category search, a bubble sort of the
snow levels, a break-out volume scan). Here ncat is a small static axis,
so each becomes a dense masked equivalent over every cell at once: the
category search a first-true argmax, the sort a fixed compare-swap
network, the scan a masked running sum. Nothing reads a device value on
the host, so the step captures as CUDA graphs."""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.models.thermo.shared import calculate_Tin_from_qin

HI_MIN = 0.1      # min ice thickness carrying ponds (hi_min for kitd=0 scale)
TD = 2.0          # freeze-up temperature difference (C)
REXP = 0.01       # pond contraction scaling


def compute_ponds_cesm(dt, *, aicen, vicen, vsnon, Tsfcn, apnd, hpnd,
                       meltt, melts, frain, rfrac, pndaspect=0.8):
    """CESM pond scheme (ice_meltpond_cesm.F90:61-261). apnd is the pond
    fraction of ice area, hpnd the pond depth (m); meltt/melts the
    per-category melt of this step (m). Returns (apnd, hpnd)."""
    has = aicen > ct.puny
    ai = torch.clamp(aicen, min=ct.puny)
    hi = torch.where(has, vicen / ai, 0.0)

    volpn = hpnd * apnd * aicen
    volpn = volpn + rfrac / ct.rhofresh * (
        meltt * ct.rhoi + melts * ct.rhos + frain * dt) * aicen
    Tp = ct.Timelt - TD
    dTs = torch.clamp(Tp - Tsfcn, min=0.0)
    volpn = torch.clamp(volpn * torch.exp(REXP * dTs / Tp), min=0.0)

    apondn = torch.clamp(torch.sqrt(volpn / (pndaspect * ai)), max=1.0)
    hpondn = torch.minimum(pndaspect * apondn, 0.9 * hi)
    apondn = apondn * aicen

    off = (hi < HI_MIN) | ~has
    apondn = torch.where(off, 0.0, apondn)
    hpondn = torch.where(off, 0.0, hpondn)
    return torch.where(has, apondn / ai, 0.0), hpondn


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


# ---------------------------------------------------------------------------
# topographic melt ponds (Flocco & Feltham 2007 / Flocco et al. 2010)
# ---------------------------------------------------------------------------

TD_TOPO = 0.15        # freeze-up temperature difference for topo ponds (p15)
HICEMIN_TOPO = 0.1    # minimum ice thickness carrying topo ponds (m)
MIN_VOLP = 1.0e-4     # minimum pond volume (m)
BIG = 1.0e30          # sort sentinel above every level


def _calc_hpond(ncat, reduced_aicen, asnon, hsnon, alfan, volp, cum_max_vol):
    """Pond depth from hypsometry (ice_meltpond_topo.F90:651-806
    calc_hpond). All inputs (ncat, *B) except volp (*B). Returns (hpond
    (*B), m_index (*B int64: 0-based highest pond-covered category, -1
    where there is no pond)).

    The pond fills the categories up to m_index = the first n with volp <=
    cum_max_vol[n] (clamped to ncat-2). Every candidate m = 0..ncat-2 is
    solved at once along a leading axis, and m_index picks one: for each,
    the levels of the bare ice and of the snow on categories 0..m within
    layer m (ncat+2 slots, the unused ones +BIG sentinels) are sorted by
    a fixed compare-swap network with their areas, and the pond rises
    through the sub-layers until it holds the volume left."""
    B = tuple(volp.shape)
    M, L = ncat - 1, ncat + 2
    filled = (volp[None] <= cum_max_vol).to(torch.int8)
    m_index = torch.clamp(torch.argmax(filled, dim=0), max=ncat - 2)
    cum_below = torch.cat([torch.zeros_like(volp)[None], cum_max_vol[:-1]])
    rem_vol0 = volp - torch.gather(cum_below, 0, m_index[None])[0]

    zero = torch.zeros_like(volp)
    big = torch.full_like(volp, BIG)
    alf_m = alfan[:M]                                  # (M, *B)
    # slot 0: the bare level with the area under no snow; slots 1..m+1:
    # the snow tops of categories 0..m; slot m+2: the top of the layer
    hitl, aicetl = [zero.expand((M,) + B)], []
    a0 = []
    acc = zero
    for n in range(M):
        acc = acc + (reduced_aicen[n] - asnon[n])
        a0.append(acc)
    aicetl.append(torch.stack(a0))
    for slot in range(1, L):
        h_m, a_m = [], []
        for m in range(M):
            n = slot - 1
            if n <= m:
                h_m.append(torch.clamp(torch.minimum(
                    hsnon[n] + alfan[n] - alfan[m],
                    alfan[m + 1] - alfan[m]), min=0.0))
                a_m.append(asnon[n])
            elif n == m + 1:
                h_m.append(alfan[m + 1] - alfan[m])
                a_m.append(zero)
            else:
                h_m.append(big)
                a_m.append(zero)
        hitl.append(torch.stack(h_m))
        aicetl.append(torch.stack(a_m))

    # bubble-sort network, ascending in hitl with the areas alongside
    for _ in range(L - 1):
        for i in range(L - 1):
            swap = hitl[i] > hitl[i + 1]
            lo = torch.where(swap, hitl[i + 1], hitl[i])
            hi = torch.where(swap, hitl[i], hitl[i + 1])
            alo = torch.where(swap, aicetl[i + 1], aicetl[i])
            ahi = torch.where(swap, aicetl[i], aicetl[i + 1])
            hitl[i], hitl[i + 1] = lo, hi
            aicetl[i], aicetl[i + 1] = alo, ahi

    # rise through the sub-layers until rem_vol fits; candidate m has its
    # m+2 live slots 0..m+1
    cand = torch.arange(M, device=volp.device).view((M,) + (1,) * len(B))
    atot = torch.stack(aicetl).sum(0)
    cum = torch.zeros_like(atot)
    found = torch.zeros(atot.shape, dtype=torch.bool, device=volp.device)
    hp_m = torch.zeros_like(atot)
    for n in range(1, M + 1):
        suffix = torch.stack(aicetl[n:]).sum(0)
        area = torch.clamp(atot - (ct.rhos / ct.rhow) * suffix, min=ct.puny)
        vol = (hitl[n] - hitl[n - 1]) * area
        reach = cum + vol >= rem_vol0
        hit = reach & ~found
        hval = (rem_vol0 - cum) / area + hitl[n - 1] + alf_m - alfan[0]
        # fall-through (should not happen): the top of the last sub-layer
        new = torch.where(hit, hval, torch.where(
            found, hp_m, hitl[n] + alf_m - alfan[0]))
        use = n <= cand + 1                   # slot n live for candidate m
        hp_m = torch.where(use, new, hp_m)
        found = torch.where(use, found | reach, found)
        cum = torch.where(use, cum + vol, cum)

    hpond = torch.gather(hp_m, 0, m_index[None])[0]
    empty = volp < ct.puny
    return torch.where(empty, 0.0, hpond), torch.where(empty, -1, m_index)


def _pond_area(dt, ncat, *, aice, vice, vsno, aicen, vicen, vsnon,
               qicen, sicen, volp, Tsfcn, Tf, ktherm, heat_capacity=True):
    """Pond area/depth + drainage (ice_meltpond_topo.F90:379-647
    pond_area), dense over batch *B. qicen/sicen: (nilyr, ncat, *B).
    Returns (volpn, apondn, hpondn (ncat, *B), volp, dvolp (*B))."""
    B = tuple(aice.shape)
    has_n = aicen > ct.puny
    ai_n = torch.clamp(aicen, min=ct.puny)
    hicen = torch.where(has_n, vicen / ai_n, 0.0)
    hsnon = torch.where(has_n, vsnon / ai_n, 0.0)
    red = torch.where(has_n, aicen * torch.clamp(-0.024 * hicen + 0.832,
                                                 min=0.2), 0.0)
    reduced_aicen = red.clone()                   # n=ncat (:481)
    reduced_aicen[ncat - 1] = torch.where(has_n[ncat - 1], 1.0, 0.0)
    asnon = reduced_aicen
    alfan = 0.6 * hicen
    betan = 0.4 * hicen

    # cumulative maximum water volume up to each category (:499-534)
    cums = []
    prev = torch.zeros_like(aice)
    for n in range(ncat - 1):
        cond = (alfan[n + 1] >= alfan[n]) & (alfan[n + 1] > 0.0)
        val = prev + (alfan[n + 1] - alfan[n]) * reduced_aicen[:n + 1].sum(0)
        for ns in range(n + 1):
            val = val - (ct.rhos / ct.rhow) * asnon[ns] * torch.clamp(
                torch.minimum(hsnon[ns] + alfan[ns] - alfan[n],
                              alfan[n + 1] - alfan[n]), min=0.0)
        prev = torch.where(cond, val, prev)
        cums.append(prev)
    cums.append(prev)                             # the last holds none
    cum_max_vol = torch.stack(cums)

    # overflow drainage (:539-549)
    over = volp >= cum_max_vol[ncat - 1]
    drain = torch.where(over, volp - cum_max_vol[ncat - 1] + ct.puny, 0.0)
    volp = volp - drain
    dvolp = drain
    dump = volp < ct.puny
    dvolp = torch.where(dump, dvolp + volp, dvolp)
    volp = torch.where(dump, 0.0, volp)

    hpond, m_index = _calc_hpond(ncat, reduced_aicen, asnon, hsnon, alfan,
                                 volp, cum_max_vol)
    narng = torch.arange(ncat, device=aice.device).view(
        (ncat,) + (1,) * len(B))
    in_pond = narng <= m_index[None]
    apondn = torch.where(in_pond, reduced_aicen, 0.0)
    hpondn = torch.where(in_pond, torch.clamp(
        hpond[None] - alfan + alfan[0][None], min=0.0), 0.0)

    # Darcy drainage through permeable ice (:560-600); not for mushy ice,
    # which drains by its own flushing (:571)
    if ktherm != 2:
        ai = torch.clamp(aice, min=ct.puny)
        floe_weight = torch.where(
            aice > ct.puny,
            (vsno * ct.rhos + ct.rhoi * vice + ct.rhow * volp) / ai, 0.0)
        hsl_rel = floe_weight / ct.rhow             - ((betan * aicen).sum(0) / ai + alfan[0])
        pressure_head = ct.gravit * ct.rhow * torch.clamp(hpond - hsl_rel,
                                                          min=0.0)
        do_drain = pressure_head > 0.0
        permflag = torch.zeros_like(do_drain)
        for n in range(ncat - 1):
            perm = permeability_phi(qicen[:, n], sicen[:, n], Tsfcn[n], Tf,
                                    heat_capacity=heat_capacity)
            live = do_drain & (hicen[n] > 0.0)
            permflag = permflag | (live & (perm > 0.0))
            dr = torch.where(live, perm * apondn[n] * pressure_head * dt
                             / (ct.viscosity_dyn
                                * torch.clamp(hicen[n], min=ct.puny)), 0.0)
            dvolp = dvolp + torch.minimum(dr, volp)
            volp = torch.clamp(volp - dr, min=0.0)
            dump = live & (volp < ct.puny)
            dvolp = torch.where(dump, dvolp + volp, dvolp)
            volp = torch.where(dump, 0.0, volp)

        # pond dimensions again where anything drained (:585-597)
        hpond2, m_index2 = _calc_hpond(ncat, reduced_aicen, asnon, hsnon,
                                       alfan, volp, cum_max_vol)
        hpond = torch.where(permflag, hpond2, hpond)
        m_index = torch.where(permflag, m_index2, m_index)
        in_pond = narng <= m_index[None]
        apondn = torch.where(permflag[None],
                             torch.where(in_pond, reduced_aicen, 0.0), apondn)
        hpondn = torch.where(permflag[None], torch.where(
            in_pond, hpond[None] - alfan + alfan[0][None], 0.0), hpondn)

    # pond volume per category; snow in ponds does not melt (:602-637)
    volpn_low = apondn * hpondn \
        - (ct.rhos / ct.rhow) * asnon * torch.minimum(hsnon, hpondn)
    volpn = torch.where(narng < m_index[None], volpn_low, 0.0)
    sum_low = volpn.sum(0)
    is_last = narng == m_index[None]
    top_vol = volp - sum_low
    ok = volp > sum_low
    volpn = torch.where(is_last, torch.where(ok[None], top_vol[None], 0.0),
                        volpn)
    hpondn = torch.where(is_last & ~ok[None], 0.0, hpondn)
    apondn = torch.where(is_last & ~ok[None], 0.0, apondn)
    # a negative remainder reduces the category below (:629-633)
    neg = volp + ct.puny < sum_low
    is_prev = narng == (m_index - 1)[None]
    volpn = torch.where(is_prev & (neg & (m_index > 0))[None],
                        volpn + top_vol[None], volpn)

    live = apondn > ct.puny
    hpondn = torch.where(live, volpn / torch.clamp(apondn, min=ct.puny), 0.0)
    dvolp = dvolp + torch.where(live, 0.0, volpn).sum(0)
    volpn = torch.where(live, volpn, 0.0)
    apondn = torch.where(live, apondn, 0.0)
    return volpn, apondn, hpondn, volp, dvolp


class PondsTopoResult(NamedTuple):
    apnd: torch.Tensor
    hpnd: torch.Tensor
    ipnd: torch.Tensor
    dfpond: torch.Tensor   # net fresh water flux change to ponds (m)
    vuin: torch.Tensor     # lid ice volume (diagnostic)


def compute_ponds_topo(dt, *, aice, aicen, vice, vicen, vsno, vsnon,
                       meltt, fsurf, Tsfcn, Tf, qicen, sicen, apnd, hpnd,
                       ipnd, ktherm=1, heat_capacity=True) -> PondsTopoResult:
    """Topographic melt ponds (ice_meltpond_topo.F90:69-377
    compute_ponds_topo): the cell's meltwater spread over the lowest-lying
    categories by hypsometry, the refrozen lid's growth and melt, and
    Darcy drainage. Cell aggregates: aice, vice, vsno, meltt (surface
    melt, m), fsurf (surface heat flux, W/m^2), Tf; per category: aicen,
    vicen, vsnon, Tsfcn and the apnd/hpnd/ipnd tracers; qicen/sicen:
    (nilyr, ncat, *B)."""
    ncat = aicen.shape[0]
    B = tuple(aice.shape)
    volp = (hpnd * apnd * aicen).sum(0)
    vuin = ipnd * apnd * aicen
    Tp = ct.Timelt - TD_TOPO

    # pond cells; ponds on thin or sparse ice go (:203-224)
    hi = torch.where(aice > ct.puny,
                     vice / torch.clamp(aice, min=ct.puny), 0.0)
    haspond = (aice > 0.01) & (hi > HICEMIN_TOPO) & (volp > MIN_VOLP * aice)
    dfpond = torch.where(haspond, 0.0, -volp)
    vuin = torch.where(haspond[None], vuin, 0.0)
    volp = torch.where(haspond, volp, 0.0)

    volpn, apondn, hpondn, volp, dvolp = _pond_area(
        dt, ncat, aice=aice, vice=vice, vsno=vsno, aicen=aicen,
        vicen=vicen, vsnon=vsnon, qicen=qicen, sicen=sicen, volp=volp,
        Tsfcn=Tsfcn, Tf=Tf, ktherm=ktherm, heat_capacity=heat_capacity)
    volpn = torch.where(haspond[None], volpn, 0.0)
    apondn = torch.where(haspond[None], apondn, 0.0)
    hpondn = torch.where(haspond[None], hpondn, 0.0)
    dfpond = dfpond - torch.where(haspond, dvolp, 0.0)

    # the refrozen lid, categories 0..ncat-2 (:240-320)
    act = haspond[None] & (torch.arange(ncat, device=aice.device) < ncat - 1
                           ).view((ncat,) + (1,) * len(B))
    rhoi_L = ct.Lfresh * ct.rhoi
    has_lid = vuin > ct.puny
    # (a) the lid melts (Tsfcn > Tp)
    melt_br = act & has_lid & (Tsfcn > Tp)
    dvice_m = torch.minimum(meltt[None] * apondn, vuin)
    apply_m = melt_br & (dvice_m > ct.puny)
    vuin_m = vuin - dvice_m
    volpn_m = volpn + dvice_m
    dfp_m = dvice_m
    gone = apply_m & (vuin_m < ct.puny) & (volpn_m > ct.puny)
    volpn_m = torch.where(gone, volpn_m + vuin_m, volpn_m)
    dfp_m = torch.where(gone, dfp_m + vuin_m, dfp_m)
    vuin_m = torch.where(gone, 0.0, vuin_m)
    # (b) an existing lid grows (Tsfcn <= Tp, pond water left)
    frz_br = act & has_lid & ~(Tsfcn > Tp) & (volpn > ct.puny)
    dTice = torch.clamp(-Tsfcn - TD_TOPO, min=0.0)
    omega = ct.kice * dTice / rhoi_L
    vv = vuin / torch.clamp(aicen, min=ct.puny)
    dHui = torch.sqrt(2.0 * omega * dt + vv * vv) - vv
    dvice_f = torch.minimum(dHui * apondn, volpn)
    apply_f = frz_br & (dvice_f > ct.puny)
    # (c) a new lid forms (no lid yet)
    new_br = act & ~has_lid
    dHui_n = torch.clamp(-fsurf[None] * dt / rhoi_L, min=0.0)
    dvice_n = torch.minimum(dHui_n * apondn, volpn)
    apply_n = new_br & (dvice_n > ct.puny)

    vuin = torch.where(apply_m, vuin_m, torch.where(
        apply_f, vuin + dvice_f, torch.where(apply_n, dvice_n, vuin)))
    volpn = torch.where(apply_m, volpn_m, torch.where(
        apply_f, volpn - dvice_f, torch.where(apply_n, volpn - dvice_n,
                                              volpn)))
    dfpond = dfpond + torch.where(apply_m, dfp_m, torch.where(
        apply_f, -dvice_f, torch.where(apply_n, -dvice_n, 0.0))).sum(0)
    changed = apply_m | apply_f | apply_n
    hpondn = torch.where(changed, volpn / torch.clamp(apondn, min=ct.puny),
                         hpondn)

    # a lid with no liquid pond goes (:322-344)
    vuin = torch.where((aicen > ct.puny) & (volpn < ct.puny)
                       & (vuin > ct.puny), 0.0, vuin)

    # reload the tracers (:346-369)
    live = apondn > ct.puny
    ipnd_out = torch.where(live, vuin / torch.clamp(apondn, min=ct.puny), 0.0)
    vuin = torch.where(live, vuin, 0.0)
    has_n = aicen > ct.puny
    return PondsTopoResult(
        apnd=torch.where(has_n, apondn / torch.clamp(aicen, min=ct.puny),
                         0.0),
        hpnd=torch.where(has_n, hpondn, 0.0),
        ipnd=torch.where(has_n, ipnd_out, 0.0), dfpond=dfpond, vuin=vuin)
