"""Ice thickness distribution (ITD) machinery (PyTorch port of the parts of
``cice5_tpu/models/thermo/itd.py`` the configurations of the port run).

ice_itd.F90: category bounds :83-237, aggregate :246, rebin :516,
shift_ice :815, compute_tracers :1359, cleanup_itd :1514, zap_small_areas
:1778; ice_therm_itd.F90: linear_itd :69, fit_line :871, lateral_melt
:1043, add_new_ice :1239. State layout: aicen/vicen/vsnon (ncat, *B),
trcrn (ncat, ntrcr, *B). The sequential loop over the ncat-1 category
boundaries stays a Python loop, each step vectorized over the grid.

Tracer conservation uses the dependency weights: every tracer slot has a
weight in {aicen, vicen, vsnon, weight(parent)*trcrn[parent]} and the
conserved amount is weight*trcrn, so the iage, FY, lvl and pond tracers
ride through the shifts, rebinning and zapping as they are; the topo-pond
water that lateral melt and the zaps remove is returned as ``dfpond``
(ice_therm_itd.F90:1146-1152, ice_itd.F90:1905-1913), and
``zerolayer_check`` (ice_itd.F90:2428) counts the zero-layer columns whose
enthalpy left its latent value. The aerosol and skeletal-BGC loads that
lateral melt, the zaps and the aice > 1 renormalization remove go to the
ocean (``dfaero``, ``dflux_bio``: the JAX package's conservation
completions of ice_therm_itd.F90:1196-1212 and ice_itd.F90:1918-1927,
2221-2236); frazil growth dilutes the ice aerosols, carries the brine
volume and takes up ocean BGC (``add_new_ice``, ice_zbgc.F90:866-1060).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.cice import constants as ct
from reference.cice.models.thermo import mushy
from reference.cice.models.tracers.brine import PHI_SK
from reference.cice.state import (DEP_AICE, DEP_TRCR, DEP_VICE, DEP_VSNO,
                                   TracerRegistry)
from reference.cice.utils import with_index


def category_bounds(ncat: int, kitd: int = 1, kcatbound: int = 1,
                    hi_min: float = 0.01) -> tuple:
    """hin_max(0:ncat) category thickness limits, as Python floats."""
    hin_max = np.zeros(ncat + 1)
    if kcatbound == -1:
        hin_max[1] = 100.0
    elif kcatbound == 0:
        if kitd == 1:
            cc1 = 3.0 / ncat
            cc2 = 15.0 * cc1
            cc3 = 3.0
            hin_max[0] = 0.0
        else:
            hi_min = 0.1
            cc1 = max(1.1 / ncat, hi_min)
            cc2 = 25.0 * cc1
            cc3 = 2.25
            hin_max[0] = hi_min
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            hin_max[n] = hin_max[n - 1] + cc1 + cc2 * (
                1.0 + np.tanh(cc3 * (x1 - 1.0)))
    elif kcatbound == 1:
        d1, d2 = 3.0 / ncat, 0.5 / ncat
        for n in range(1, ncat + 1):
            hin_max[n] = n * (d1 + (n - 1) * d2)
    elif kcatbound == 2:
        wmo = {5: [0.30, 0.70, 1.20, 2.00, 999.0],
               6: [0.15, 0.30, 0.70, 1.20, 2.00, 999.0],
               7: [0.10, 0.15, 0.30, 0.70, 1.20, 2.00, 999.0]}
        hin_max[1:] = wmo[ncat]
    return tuple(float(h) for h in hin_max)


def tracer_weights(tr: TracerRegistry, aicen, vicen, vsnon, trcrn):
    """Per-slot conservation weights w, (ncat, ntrcr, *B), so that
    w * trcrn is conserved (parents precede children in the registry)."""
    ws = []
    for it in range(tr.ntrcr):
        d = tr.depend[it]
        if d == DEP_AICE:
            w = aicen
        elif d == DEP_VICE:
            w = vicen
        elif d == DEP_VSNO:
            w = vsnon
        else:
            p = d - DEP_TRCR
            w = ws[p] * trcrn[:, p]
        ws.append(w)
    return torch.stack(ws, dim=1)


def compute_tracers(tr: TracerRegistry, atrcrn, aicen, vicen, vsnon):
    """Invert conserved amounts back to tracer values
    (ice_itd.F90:1359-1501 compute_tracers)."""
    outs = []
    for it in range(tr.ntrcr):
        d = tr.depend[it]
        if d == DEP_AICE:
            w, ok = aicen, aicen > ct.puny
        elif d == DEP_VICE:
            w, ok = vicen, vicen > 0.0
        elif d == DEP_VSNO:
            w, ok = vsnon, vsnon > 0.0
        else:
            w = None
            q = it
            while tr.depend[q] >= DEP_TRCR:
                q = tr.depend[q] - DEP_TRCR
                w = outs[q] if w is None else w * outs[q]
            base = {DEP_AICE: aicen, DEP_VICE: vicen,
                    DEP_VSNO: vsnon}[tr.depend[q]]
            w = base * w
            ok = w > 0.0
        val = torch.where(ok, atrcrn[:, it] / torch.where(ok, w, 1.0), 0.0)
        if it == tr.nt_Tsfc:
            val = torch.where(ok, val, ct.Tocnfrz)
        if it == tr.nt_fbri:
            val = torch.where(ok, val, 1.0)
        outs.append(val)
    return torch.stack(outs, dim=1)


class Aggregate(NamedTuple):
    aice: torch.Tensor
    vice: torch.Tensor
    vsno: torch.Tensor
    trcr: torch.Tensor   # (ntrcr, *B) cell-mean tracers
    aice0: torch.Tensor


def aggregate(tr: TracerRegistry, aicen, vicen, vsnon, trcrn) -> Aggregate:
    """Category -> cell aggregates incl. dependency-weighted tracer means
    (ice_itd.F90:246-508)."""
    aice = aicen.sum(0)
    vice = vicen.sum(0)
    vsno = vsnon.sum(0)
    w = tracer_weights(tr, aicen, vicen, vsnon, trcrn)
    atrcr = (w * trcrn).sum(0)
    wtot = w.sum(0)
    ok = wtot > ct.puny
    trcr = torch.where(ok, atrcr / torch.where(ok, wtot, 1.0), 0.0)
    aice0 = torch.clamp(1.0 - aice, min=0.0)
    return Aggregate(aice=aice, vice=vice, vsno=vsno, trcr=trcr, aice0=aice0)


def zerolayer_check(tr: TracerRegistry, nilyr, nslyr, aicen, vicen, vsnon,
                    trcrn):
    """ktherm=0 consistency check (ice_itd.F90:2428 zerolayer_check): with
    zero heat capacity every enthalpy slot holds the latent placeholder,
    eicen + rhoi*Lfresh*vicen == 0 and esnon + rhos*Lfresh*vsnon == 0 to
    within puny*Lfresh*rhos (plus the rounding floor of the q*v products
    in the dtype). Returns the count of failing (cell, category) pairs as
    a 0-d int32 tensor."""
    eps = torch.finfo(vicen.dtype).eps
    max_error_i = ct.puny * ct.Lfresh * ct.rhos \
        + 16.0 * eps * ct.rhoi * ct.Lfresh * vicen
    max_error_s = ct.puny * ct.Lfresh * ct.rhos \
        + 16.0 * eps * ct.rhos * ct.Lfresh * vsnon
    eicen = trcrn[:, tr.nt_qice:tr.nt_qice + nilyr].sum(1) * vicen / nilyr
    esnon = trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr].sum(1) * vsnon / nslyr
    bad_i = torch.abs(eicen + ct.rhoi * ct.Lfresh * vicen) > max_error_i
    bad_s = torch.abs(esnon + ct.rhos * ct.Lfresh * vsnon) > max_error_s
    return (bad_i | bad_s).sum().to(torch.int32)


def column_conservation_check(x1, x2, max_err):
    """Per-cell conservation check |x2 - x1| <= max_err
    (ice_itd.F90:1299 column_conservation_check), the reference's l_stop
    abort as a count: returns (nbad 0-d int32, max_abs_err). The
    reference's tolerance is for float64; a term of the dtype's rounding
    of the column sums is added (16 eps |x1|)."""
    err = torch.abs(x2 - x1)
    tol = max_err + 16.0 * torch.finfo(x1.dtype).eps * torch.abs(x1)
    return (err > tol).sum().to(torch.int32), err.max()


def itd_conservation_sums(tr: TracerRegistry, nilyr, nslyr, aicen, vicen,
                          vsnon, trcrn):
    """Column sums of the five fields linear_itd checks for conservation:
    vice, vsno, eice, esno, sice (ice_therm_itd.F90:700-860); eicen =
    sum_k qice_k * vicen/nilyr per category, likewise esnon and sicen."""
    eicen = trcrn[:, tr.nt_qice:tr.nt_qice + nilyr].sum(1) * vicen / nilyr
    esnon = trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr].sum(1) * vsnon / nslyr
    sicen = trcrn[:, tr.nt_sice:tr.nt_sice + nilyr].sum(1) * vicen / nilyr
    return (vicen.sum(0), vsnon.sum(0), eicen.sum(0), esnon.sum(0),
            sicen.sum(0))


def itd_conservation_check(pre, post):
    """The five linear_itd column sums against the reference's per-field
    tolerances (ice_therm_itd.F90:783-860: puny for volumes and salt,
    puny*Lfresh*rho for energies). Returns the count of failing (cell,
    field) pairs, 0-d int32, 0 when conserved."""
    tols = (ct.puny, ct.puny, ct.puny * ct.Lfresh * ct.rhoi,
            ct.puny * ct.Lfresh * ct.rhos, ct.puny)
    nbad = torch.zeros((), dtype=torch.int32, device=pre[0].device)
    for x1, x2, tol in zip(pre, post, tols):
        nbad = nbad + column_conservation_check(x1, x2, tol)[0]
    return nbad


def _pond_volume_per_cat(tr: TracerRegistry, aicen, trcrn):
    """Per-category topo-pond water volume aicen*apnd*hpnd (m)
    (ice_itd.F90:1910-1913)."""
    return aicen * trcrn[:, tr.nt_apnd] * trcrn[:, tr.nt_hpnd]


def _aero_mass_per_cat(tr: TracerRegistry, vicen, vsnon, trcrn,
                       snow=True, ice=True):
    """Per-(species, category) aerosol mass (kg/m^2): vsnon * (snow-layer
    concentrations) + vicen * (ice-layer concentrations), slots
    [sno ssl, sno int, ice ssl, ice int] per species (ice_state.F90:118).
    (n_aero, ncat, *B); (0, ncat, *B) without aerosols."""
    a0 = tr.nt_aero
    out = []
    for it in range(tr.n_aero):
        m = torch.zeros_like(vicen)
        if snow:
            m = m + vsnon * (trcrn[:, a0 + 4 * it] + trcrn[:, a0 + 4 * it + 1])
        if ice:
            m = m + vicen * (trcrn[:, a0 + 4 * it + 2]
                             + trcrn[:, a0 + 4 * it + 3])
        out.append(m)
    return torch.stack(out) if out else vicen.new_zeros((0,) + vicen.shape)


def _bgc_mass_per_cat(tr: TracerRegistry, aicen, trcrn):
    """Per-(BGC tracer, category) physical skeletal-BGC mass per grid area
    aicen * conc * phi_sk (mmol/m^2), the unit of flux_bio
    (ice_algae.F90:464). (nbtrcr, ncat, *B)."""
    if not tr.nbtrcr:
        return aicen.new_zeros((0,) + aicen.shape)
    return torch.stack([aicen * trcrn[:, s] * PHI_SK for s in tr.nt_bgc])


def _shift_boundary(tr: TracerRegistry, pair, t_lo, t_hi, lo_is_donor,
                    active, da, dv):
    """One category-boundary transfer (ice_itd.F90:905-1130 core).

    pair: (a_lo, a_hi, v_lo, v_hi, s_lo, s_hi, at_lo, at_hi) area, ice
    volume, snow volume and conserved tracer amounts (ntrcr, *B) of the
    lower/upper category; t_lo/t_hi: tracer VALUES for the transferred
    amounts. Returns the updated 8-tuple."""
    a_lo, a_hi, v_lo, v_hi, s_lo, s_hi, at_lo, at_hi = pair
    a_nd = torch.where(lo_is_donor, a_lo, a_hi)
    v_nd = torch.where(lo_is_donor, v_lo, v_hi)

    # range snapping: tiny -> zero, near-full -> whole category
    tiny = (da < -ct.puny * a_nd) | (dv < -ct.puny * v_nd)
    da = torch.where((da < 0) & ~tiny, 0.0, da)
    dv = torch.where((dv < 0) & ~tiny, 0.0, dv)
    whole = (da > a_nd * (1.0 - ct.puny)) | (dv > v_nd * (1.0 - ct.puny))
    da = torch.where(whole, a_nd, da)
    dv = torch.where(whole, v_nd, dv)
    active = active & (da > 0.0)
    da = torch.where(active, da, 0.0)
    dv = torch.where(active, dv, 0.0)

    frac = torch.where(active, da / torch.clamp(a_nd, min=ct.puny), 0.0)
    s_nd = torch.where(lo_is_donor, s_lo, s_hi)
    dvs = s_nd * frac

    sgn_lo = torch.where(lo_is_donor, -1.0, 1.0).to(a_lo.dtype)
    a_lo = a_lo + sgn_lo * da
    a_hi = a_hi - sgn_lo * da
    v_lo = v_lo + sgn_lo * dv
    v_hi = v_hi - sgn_lo * dv
    s_lo = s_lo + sgn_lo * dvs
    s_hi = s_hi - sgn_lo * dvs

    t_nd = torch.where(lo_is_donor[None], t_lo, t_hi)
    dats = []
    for it in range(tr.ntrcr):
        amt = t_nd[it]
        q = it
        while tr.depend[q] >= DEP_TRCR:
            q = tr.depend[q] - DEP_TRCR
            amt = amt * t_nd[q]
        base = {DEP_AICE: da, DEP_VICE: dv, DEP_VSNO: dvs}[tr.depend[q]]
        dats.append(base * amt)
    dat = torch.stack(dats, dim=0)
    at_lo = at_lo + sgn_lo[None] * dat
    at_hi = at_hi - sgn_lo[None] * dat
    return a_lo, a_hi, v_lo, v_hi, s_lo, s_hi, at_lo, at_hi


def shift_ice(tr: TracerRegistry, aicen, vicen, vsnon, trcrn, donor, daice,
              dvice):
    """Transfer area/volume/tracers across category boundaries.

    donor: (ncat-1, *B) int, -1 = no transfer, else the 0-based donor
    category (b or b+1 for boundary b); daice/dvice: (ncat-1, *B)."""
    ncat = aicen.shape[0]
    atrcrn = tracer_weights(tr, aicen, vicen, vsnon, trcrn) * trcrn
    aiL = [aicen[n] for n in range(ncat)]
    viL = [vicen[n] for n in range(ncat)]
    vsL = [vsnon[n] for n in range(ncat)]
    atL = [atrcrn[n] for n in range(ncat)]
    for b in range(ncat - 1):
        db = donor[b]
        pair = (aiL[b], aiL[b + 1], viL[b], viL[b + 1], vsL[b], vsL[b + 1],
                atL[b], atL[b + 1])
        (aiL[b], aiL[b + 1], viL[b], viL[b + 1], vsL[b], vsL[b + 1],
         atL[b], atL[b + 1]) = _shift_boundary(
            tr, pair, trcrn[b], trcrn[b + 1], db == b, db >= 0,
            daice[b], dvice[b])
    aicen = torch.stack(aiL)
    vicen = torch.stack(viL)
    vsnon = torch.stack(vsL)
    trcrn = compute_tracers(tr, torch.stack(atL), aicen, vicen, vsnon)
    return aicen, vicen, vsnon, trcrn


def rebin(tr: TracerRegistry, hin_max, aicen, vicen, vsnon, trcrn):
    """Enforce category bounds by whole-category shifts
    (ice_itd.F90:516-729), one category pair per boundary pass."""
    ncat = aicen.shape[0]
    hicen = torch.where(aicen > ct.puny,
                        vicen / torch.clamp(aicen, min=ct.puny), 0.0)
    if hin_max[0] > 0.0:
        thin = (aicen[0] > ct.puny) & (hicen[0] <= hin_max[0])
        aicen = with_index(aicen, 0, torch.where(thin, vicen[0] / hin_max[0],
                                            aicen[0]))

    atrcrn = tracer_weights(tr, aicen, vicen, vsnon, trcrn) * trcrn
    aiL = [aicen[n] for n in range(ncat)]
    viL = [vicen[n] for n in range(ncat)]
    vsL = [vsnon[n] for n in range(ncat)]
    atL = [atrcrn[n] for n in range(ncat)]

    def boundary_shift(b, donor_cat):
        h = torch.where(aiL[donor_cat] > ct.puny,
                        viL[donor_cat] / torch.clamp(aiL[donor_cat],
                                                     min=ct.puny), 0.0)
        if donor_cat == b:            # too thick -> move up
            move = (aiL[b] > ct.puny) & (h > hin_max[b + 1])
        else:                         # too thin -> move down
            move = (aiL[b + 1] > ct.puny) & (h <= hin_max[b + 1])
        # amounts -> values -> amounts of the pair, as each full
        # shift_ice call of the reference does
        a2 = torch.stack([aiL[b], aiL[b + 1]])
        v2 = torch.stack([viL[b], viL[b + 1]])
        s2 = torch.stack([vsL[b], vsL[b + 1]])
        t2 = compute_tracers(tr, torch.stack([atL[b], atL[b + 1]]),
                             a2, v2, s2)
        at2 = tracer_weights(tr, a2, v2, s2, t2) * t2
        da = torch.where(move, aiL[donor_cat], 0.0)
        dv = torch.where(move, viL[donor_cat], 0.0)
        lo_is_donor = torch.full(move.shape, donor_cat == b,
                                 device=move.device)
        pair = (aiL[b], aiL[b + 1], viL[b], viL[b + 1], vsL[b],
                vsL[b + 1], at2[0], at2[1])
        (aiL[b], aiL[b + 1], viL[b], viL[b + 1], vsL[b], vsL[b + 1],
         atL[b], atL[b + 1]) = _shift_boundary(
            tr, pair, t2[0], t2[1], lo_is_donor, move, da, dv)

    for b in range(ncat - 1):             # move thin categories up
        boundary_shift(b, b)
    for b in reversed(range(ncat - 1)):   # move thick categories down
        boundary_shift(b, b + 1)

    aicen = torch.stack(aiL)
    vicen = torch.stack(viL)
    vsnon = torch.stack(vsL)
    trcrn = compute_tracers(tr, torch.stack(atL), aicen, vicen, vsnon)
    return aicen, vicen, vsnon, trcrn


def _fit_line(aicen, hice, hbL, hbR):
    """g(eta) = g0 + g1*eta over [hL, hR] (ice_therm_itd.F90:871-958)."""
    ok = (aicen > ct.puny) & (hbR - hbL > ct.puny)
    hL, hR = hbL, hbR
    h13 = (2.0 * hL + hR) / 3.0
    h23 = (hL + 2.0 * hR) / 3.0
    hR = torch.where(hice < h13, 3.0 * hice - 2.0 * hL, hR)
    hL = torch.where(hice > h23, 3.0 * hice - 2.0 * hR, hL)
    dhr = 1.0 / torch.clamp(hR - hL, min=1e-30)
    wk1 = 6.0 * aicen * dhr
    wk2 = (hice - hL) * dhr
    g0 = torch.where(ok, wk1 * (2.0 / 3.0 - wk2), 0.0)
    g1 = torch.where(ok, 2.0 * dhr * wk1 * (wk2 - 0.5), 0.0)
    hL = torch.where(ok, hL, 0.0)
    hR = torch.where(ok, hR, 0.0)
    return g0, g1, hL, hR


def linear_itd(tr: TracerRegistry, hin_max, nslyr, *, aicen_init,
               vicen_init, aicen, vicen, vsnon, trcrn, hi_min=0.01):
    """Linear-remapping transport in thickness space after thermo growth
    (ice_therm_itd.F90:69-868 linear_itd). Cells whose boundary shift is
    out of range are left to rebin."""
    ncat = aicen.shape[0]
    B = aicen.shape[1:]
    kw = dict(dtype=aicen.dtype, device=aicen.device)
    hmax = [float(h) for h in hin_max]
    hmax[ncat] = 999.9

    safe = lambda v, a: torch.where(a > ct.puny,
                                    v / torch.clamp(a, min=ct.puny), 0.0)
    hicen_init = safe(vicen_init, aicen_init)
    hicen = safe(vicen, aicen)
    dhicen = torch.where(aicen > ct.puny, hicen - hicen_init, 0.0)

    # new boundaries hbnew (:282-350)
    hbnew = [torch.full(B, hmax[0], **kw)]
    remap = torch.ones(B, dtype=torch.bool, device=aicen.device)
    for n in range(ncat - 1):
        hi_n, hi_n1 = hicen_init[n], hicen_init[n + 1]
        both = (hi_n > ct.puny) & (hi_n1 > ct.puny)
        slope = torch.where(both, (dhicen[n + 1] - dhicen[n])
                            / torch.where(both, hi_n1 - hi_n, 1.0), 0.0)
        hb = torch.where(
            both, hmax[n + 1] + dhicen[n] + slope * (hmax[n + 1] - hi_n),
            torch.where(hi_n > ct.puny, hmax[n + 1] + dhicen[n],
                        torch.where(hi_n1 > ct.puny,
                                    hmax[n + 1] + dhicen[n + 1],
                                    hmax[n + 1])))
        remap = remap & ~((aicen[n] > ct.puny) & (hicen[n] >= hb))
        remap = remap & ~((aicen[n + 1] > ct.puny) & (hicen[n + 1] <= hb))
        remap = remap & (hb <= hmax[n + 2]) & (hb >= hmax[n])
        hbnew.append(hb)
    hb_last = torch.where(aicen[ncat - 1] > ct.puny,
                          3.0 * hicen[ncat - 1] - 2.0 * hbnew[ncat - 1],
                          hmax[ncat])
    hbnew.append(torch.clamp(hb_last, min=hmax[ncat - 1]))

    # category-1 open-water melt (:469-540)
    g0, g1, hL, hR = _fit_line(aicen[0], hicen_init[0], hbnew[0],
                               torch.full(B, hmax[1], **kw))
    dh0 = dhicen[0]
    melt1 = remap & (aicen[0] > ct.puny) & (dh0 < 0.0)
    dh0m = torch.clamp(-dh0, max=hmax[1])
    etamax = torch.minimum(dh0m, hR) - hL
    x1 = etamax
    x2 = 0.5 * etamax * etamax
    da0 = g1 * x2 + g0 * x1
    damax = aicen[0] * (1.0 - hicen[0] / torch.clamp(hicen_init[0],
                                                     min=ct.puny))
    da0 = torch.minimum(da0, damax)
    do_melt = melt1 & (etamax > 0.0)
    new_a1 = torch.where(do_melt, aicen[0] - da0, aicen[0])
    hicen0 = torch.where(do_melt,
                         hicen[0] * aicen[0] / torch.clamp(new_a1,
                                                           min=ct.puny),
                         hicen[0])
    aicen = with_index(aicen, 0, new_a1)
    hicen = with_index(hicen, 0, hicen0)
    # dh0 >= 0: shift the lower bound right
    hbnew[0] = torch.where(remap & (aicen[0] > ct.puny) & (dh0 >= 0.0),
                           torch.clamp(dh0, max=hmax[1]), hbnew[0])

    # fit g(h) in every category with the new boundaries (:545-560)
    g0s, g1s, hLs, hRs = [], [], [], []
    for n in range(ncat):
        g0, g1, hL, hR = _fit_line(aicen[n], hicen[n], hbnew[n],
                                   hbnew[n + 1])
        g0s.append(g0)
        g1s.append(g1)
        hLs.append(hL)
        hRs.append(hR)

    # boundary transfers (:565-648)
    donorL, daiceL, dviceL = [], [], []
    for n in range(ncat - 1):
        up = hbnew[n + 1] > hmax[n + 1]         # transfer n -> n+1
        etamin = torch.where(
            up, torch.clamp(hLs[n], min=hmax[n + 1]) - hLs[n], 0.0)
        etamax = torch.where(
            up, torch.minimum(hbnew[n + 1], hRs[n]) - hLs[n],
            torch.clamp(hRs[n + 1], max=hmax[n + 1]) - hLs[n + 1])
        g0d = torch.where(up, g0s[n], g0s[n + 1])
        g1d = torch.where(up, g1s[n], g1s[n + 1])
        hLd = torch.where(up, hLs[n], hLs[n + 1])
        a_nd = torch.where(up, aicen[n], aicen[n + 1])
        v_nd = torch.where(up, vicen[n], vicen[n + 1])

        has = remap & (etamax > etamin)
        x1 = etamax - etamin
        wk1 = etamin * etamin
        wk2 = etamax * etamax
        x2 = 0.5 * (wk2 - wk1)
        x3 = (wk2 * etamax - wk1 * etamin) / 3.0
        da = torch.where(has, g1d * x2 + g0d * x1, 0.0)
        dv = torch.where(has, g1d * x3 + g0d * x2 + da * hLd, 0.0)

        small = (da < a_nd * ct.puny) | (dv < v_nd * ct.puny)
        da = torch.where(small, 0.0, da)
        dv = torch.where(small, 0.0, dv)
        has = has & ~small
        whole = (da > a_nd * (1.0 - ct.puny)) | \
            (dv > v_nd * (1.0 - ct.puny))
        da = torch.where(has & whole, a_nd, da)
        dv = torch.where(has & whole, v_nd, dv)

        dc = torch.where(has, torch.where(up, n, n + 1), -1)
        donorL.append(dc)
        daiceL.append(da)
        dviceL.append(dv)
    # keep qsno negative definite across the weighted shift (:655-690).
    # One category has no boundary to shift across (the JAX function fails
    # there: it stacks an empty list).
    if ncat > 1:
        qs0, qs1 = tr.nt_qsno, tr.nt_qsno + nslyr
        trcrn = trcrn.clone()
        trcrn[:, qs0:qs1] = trcrn[:, qs0:qs1] + ct.rhos * ct.Lfresh
        aicen, vicen, vsnon, trcrn = shift_ice(
            tr, aicen, vicen, vsnon, trcrn, torch.stack(donorL),
            torch.stack(daiceL), torch.stack(dviceL))
        trcrn = trcrn.clone()
        trcrn[:, qs0:qs1] = trcrn[:, qs0:qs1] + (-ct.rhos * ct.Lfresh)

    # enforce the cat-1 minimum thickness (:697-715)
    h1 = safe(vicen[0], aicen[0])
    thin = remap & (aicen[0] > ct.puny) & (h1 < hi_min) & (hi_min > 0)
    da0 = torch.where(thin, aicen[0] * (1.0 - h1 / hi_min), 0.0)
    aicen = with_index(aicen, 0, aicen[0] - da0)
    return aicen, vicen, vsnon, trcrn


class LateralMelt(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    fresh: torch.Tensor
    fsalt: torch.Tensor
    fhocn: torch.Tensor
    meltl: torch.Tensor
    dfpond: torch.Tensor | None   # topo-pond water removed (m); None
                                  # without topo ponds
    dfaero: torch.Tensor     # (n_aero, *B) aerosol flux to the ocean
    dflux_bio: torch.Tensor  # (nbtrcr, *B) BGC flux to the ocean


def lateral_melt(dt, tr: TracerRegistry, nilyr, nslyr, *, aicen, vicen,
                 vsnon, trcrn, rside, tr_pond_topo=False) -> LateralMelt:
    """Melt fraction rside of every category laterally; tracers unchanged
    (ice_therm_itd.F90:1043-1235). The melted fraction's topo-pond water
    leaves the ponds (:1146-1152 dfpond), and its aerosol and skeletal-BGC
    loads go to the ocean (:1196-1212), from the pre-melt volumes so that
    the budget closes (the JAX package's completion)."""
    r = rside[None]
    dfresh = ((ct.rhos * vsnon + ct.rhoi * vicen) * r).sum(0) / dt
    dfsalt = (ct.rhoi * vicen * r).sum(0) * ct.ice_ref_salinity * 0.001 / dt
    meltl = (vicen * r).sum(0)
    dfpond = ((_pond_volume_per_cat(tr, aicen, trcrn) * r).sum(0)
              if tr_pond_topo else None)
    dfaero = (_aero_mass_per_cat(tr, vicen, vsnon, trcrn)
              * r[None]).sum(1) / dt
    dflux_bio = (_bgc_mass_per_cat(tr, aicen, trcrn) * r[None]).sum(1) / dt
    aicen_new = aicen * (1.0 - r)
    vicen_new = vicen * (1.0 - r)
    vsnon_new = vsnon * (1.0 - r)
    qice = trcrn[:, tr.nt_qice:tr.nt_qice + nilyr]
    qsno = trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr]
    # the reference uses post-melt volumes here
    fhocn = ((qice.sum(1) * vicen_new / nilyr * r).sum(0)
             + (qsno.sum(1) * vsnon_new / nslyr * r).sum(0)) / dt
    return LateralMelt(aicen=aicen_new, vicen=vicen_new, vsnon=vsnon_new,
                       fresh=dfresh, fsalt=dfsalt, fhocn=fhocn, meltl=meltl,
                       dfpond=dfpond, dfaero=dfaero, dflux_bio=dflux_bio)


class NewIce(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    trcrn: torch.Tensor
    frazil: torch.Tensor
    dfresh: torch.Tensor   # frazil fresh-water flux to the ocean
    dfsalt: torch.Tensor   # frazil salt flux to the ocean
    flux_bio: torch.Tensor  # (nbtrcr, *B) BGC uptake from the ocean into
    # the new frazil ice (mmol/m^2/s, negative: the ocean loses;
    # ice_zbgc.F90:988-999 add_new_ice_bgc)


def add_new_ice(dt, tr: TracerRegistry, hin_max, nilyr, *, aicen, vicen,
                trcrn, aice, aice0, frzmlt, Tf, salinz,
                tr_FY=False, tr_lvl=False, tr_iage=False,
                update_ocn_f=False, ktherm=1, sss=None, phi_init=0.75,
                dSin0_frazil=3.0, hfrazilmin=ct.hfrazilmin,
                tr_brine=False, ocean_bio=None,
                initbio_frac=1.0) -> NewIce:
    """Frazil formation (ice_therm_itd.F90:1239-1860): new ice in category
    1, or spread over all categories when open water is scarce.

    ktherm=2 frazil (:1460-1492) forms as mush at bulk salinity
    Si0 = sss - dSin0_frazil (a quadratic taper for fresh water) with
    liquid fraction phi_init and the mush enthalpy; otherwise it is fresh
    latent-heat ice with the salinz profile. The iage, FY and lvl tracers
    of the grown ice are mixed in (:1612-1800). The new ice carries no
    aerosol: the ice-aerosol concentrations are diluted so that the
    amount is unchanged. With tr_brine the brine volume fbri*vicen grows
    with the new ice volume and fbri is re-derived; with ocean_bio
    (nbtrcr, *B) the frazil volume takes up ocean BGC tracer (dissolved
    tracers at initbio_frac, the rest fully) into the skeletal layer as a
    negative flux_bio (add_new_ice_bgc, ice_zbgc.F90:866-1060, with the
    JAX package's conservation completions)."""
    ncat = aicen.shape[0]
    B = aicen.shape[1:]
    hi0max = float(hin_max[1]) * 0.9 if ncat > 1 else ct.bignum
    nb = (1,) * len(B)

    if ktherm == 2:
        if sss is None:
            sss = -Tf / ct.depressT
        Si0new = torch.where(sss > 2.0 * dSin0_frazil, sss - dSin0_frazil,
                             sss ** 2 / (4.0 * dSin0_frazil))
        Ti0 = torch.clamp(mushy.liquidus_temperature(Si0new / phi_init),
                          max=-0.1)
        qi0new = mushy.enthalpy_mush(Ti0, Si0new)     # (B), < 0
        salz_hs, salz_c1 = Si0new[None, None], Si0new[None]
        qi0_hs, qi0_c1 = qi0new[None, None], qi0new[None]
    else:
        # a tensor (the model's) is cast in place; host data is copied
        salinz = torch.as_tensor(
            salinz if torch.is_tensor(salinz) else np.array(salinz),
            dtype=aicen.dtype, device=aicen.device)
        qi0new = -ct.rhoi * ct.Lfresh
        salz_hs = salinz.reshape((1, nilyr) + nb)
        salz_c1 = salinz.reshape((nilyr,) + nb)
        qi0_hs = qi0_c1 = qi0new
    fnew = torch.clamp(frzmlt, min=0.0)
    vi0new = -fnew * dt / qi0new
    frazil = vi0new

    # frazil fresh/salt fluxes to the ocean (:1524-1546)
    if update_ocn_f:
        dfresh = -ct.rhoi * vi0new / dt
        dfsalt = ct.ice_ref_salinity * 1e-3 * dfresh
    elif ktherm == 2:
        # the mushy frazil-enthalpy difference goes back to the ocean
        vi0tmp = fnew * dt / (ct.rhoi * ct.Lfresh)
        dfresh = -ct.rhoi * (vi0new - vi0tmp) / dt
        dfsalt = ct.ice_ref_salinity * 1e-3 * dfresh
    else:
        dfresh = torch.zeros_like(vi0new)
        dfsalt = torch.zeros_like(vi0new)

    # brine volume before any new-ice addition (add_new_ice_bgc,
    # ice_zbgc.F90:966-976: vbrin = fbri*vicen_init per category)
    brine = tr_brine and tr.nt_fbri >= 0
    if brine:
        vbrin = trcrn[:, tr.nt_fbri] * vicen

    grow = vi0new > 0.0
    open_w = aice0 > ct.puny
    hi0new = torch.clamp(vi0new / torch.clamp(aice0, min=ct.puny),
                         min=hfrazilmin)
    too_thick = (hi0new > hi0max) & (aice0 + ct.puny < 1.0)

    ai_A = vi0new / torch.clamp(hi0new, min=ct.puny)
    ai_B = aice0
    vi_B = ai_B * hi0max
    hsurp_B = (vi0new - vi_B) / torch.clamp(aice, min=ct.puny)
    hsurp_C = vi0new / torch.clamp(aice, min=ct.puny)

    ai0new = torch.where(grow & open_w, torch.where(too_thick, ai_B, ai_A),
                         0.0)
    vi0n = torch.where(grow & open_w, torch.where(too_thick, vi_B, vi0new),
                       0.0)
    hsurp = torch.where(grow,
                        torch.where(open_w,
                                    torch.where(too_thick, hsurp_B, 0.0),
                                    hsurp_C), 0.0)

    # distribute hsurp over all categories, area unchanged (:1612-1690)
    has_surp = hsurp > ct.puny
    vsurp = hsurp[None] * aicen
    vtmp = vicen + torch.where(has_surp[None], vsurp, 0.0)
    ratio_old = torch.where(vtmp > 0.0,
                            vicen / torch.clamp(vtmp, min=1e-30), 1.0)
    ratio_new = torch.where(vtmp > 0.0,
                            vsurp / torch.clamp(vtmp, min=1e-30), 0.0)
    q0, s0 = tr.nt_qice, tr.nt_sice
    hsm = has_surp[None, None]
    ro, rn = ratio_old[:, None], ratio_new[:, None]
    qblk = trcrn[:, q0:q0 + nilyr]
    sblk = trcrn[:, s0:s0 + nilyr]
    trcrn = trcrn.clone()
    trcrn[:, q0:q0 + nilyr] = torch.where(hsm, qblk * ro + qi0_hs * rn, qblk)
    trcrn[:, s0:s0 + nilyr] = torch.where(hsm, sblk * ro + salz_hs * rn,
                                          sblk)
    if tr_iage:
        ia = trcrn[:, tr.nt_iage]
        trcrn[:, tr.nt_iage] = torch.where(
            has_surp[None] & (vtmp > ct.puny),
            (ia * vicen + dt * vsurp) / torch.clamp(vtmp, min=ct.puny), ia)
    if tr_lvl:
        vl = trcrn[:, tr.nt_vlvl]
        trcrn[:, tr.nt_vlvl] = torch.where(
            has_surp[None] & (vicen > ct.puny),
            (vl * vicen + trcrn[:, tr.nt_alvl] * vsurp)
            / torch.clamp(vtmp, min=ct.puny), vl)
    # the new ice carries no aerosol: the ice-aerosol concentrations scale
    # by vicen/vtmp, keeping the amount (the JAX package's conservation
    # completion; ice_therm_itd.F90:1612-1690 leaves them as they are)
    for it in range(tr.n_aero):
        i0 = tr.nt_aero + 4 * it + 2
        ai = trcrn[:, i0:i0 + 2]
        trcrn[:, i0:i0 + 2] = torch.where(hsm, ai * ro, ai)
    vicen = torch.where(has_surp[None], vtmp, vicen)

    # add vi0n/ai0new to category 1 (:1697-1800)
    add1 = vi0n > 0.0
    area1 = aicen[0]
    vice1 = vicen[0]
    a1new = torch.where(add1, area1 + ai0new, area1)
    v1new = torch.where(add1, vice1 + vi0n, vice1)
    aicen = with_index(aicen, 0, a1new)
    vicen = with_index(vicen, 0, v1new)

    def mixA(val, newval):   # area-weighted mix into category 1
        return torch.where(add1, (val * area1 + newval * ai0new)
                           / torch.clamp(a1new, min=ct.puny), val)

    def mixV(val, newval):   # volume-weighted mix into category 1
        return torch.where(add1 & (v1new > ct.puny),
                           (val * vice1 + newval * vi0n)
                           / torch.clamp(v1new, min=ct.puny), val)

    trcrn[0, tr.nt_Tsfc] = torch.clamp(mixA(trcrn[0, tr.nt_Tsfc], Tf),
                                       max=0.0)
    if tr_FY:
        trcrn[0, tr.nt_FY] = torch.clamp(mixA(trcrn[0, tr.nt_FY], 1.0),
                                         max=1.0)
    if tr_iage:
        trcrn[0, tr.nt_iage] = mixV(trcrn[0, tr.nt_iage], dt)
    if tr_lvl:
        trcrn[0, tr.nt_alvl] = mixA(trcrn[0, tr.nt_alvl], 1.0)
        trcrn[0, tr.nt_vlvl] = mixV(trcrn[0, tr.nt_vlvl], 1.0)
    mixm = (add1 & (v1new > ct.puny))[None]
    v1s = torch.clamp(v1new, min=ct.puny)
    qb = trcrn[0, q0:q0 + nilyr].clone()
    sb = trcrn[0, s0:s0 + nilyr].clone()
    trcrn[0, q0:q0 + nilyr] = torch.where(
        mixm, (qb * vice1 + qi0_c1 * vi0n) / v1s, qb)
    trcrn[0, s0:s0 + nilyr] = torch.where(
        mixm, (sb * vice1 + salz_c1 * vi0n) / v1s, sb)
    # aerosol-free new ice in category 1 (see the hsurp dilution above)
    for it in range(tr.n_aero):
        i0 = tr.nt_aero + 4 * it + 2
        ai = trcrn[0, i0:i0 + 2].clone()
        trcrn[0, i0:i0 + 2] = torch.where(mixm, ai * vice1 / v1s, ai)

    # add_new_ice_bgc (ice_zbgc.F90:866-1060)
    if brine:
        # hsurp thickening grows vbrin by vsurp, the category-1 frazil by
        # vi0n
        vbrin = torch.where(has_surp[None], vbrin + vsurp, vbrin)
        vbrin = with_index(vbrin, 0, torch.where(add1, vbrin[0] + vi0n,
                                                 vbrin[0]))
        touched = has_surp[None] | torch.cat(
            [add1[None], torch.zeros_like(has_surp[None]).expand(
                (ncat - 1,) + tuple(B))])
        fbri_new = torch.where(vicen > 0.0,
                               vbrin / torch.clamp(vicen, min=1e-30), 1.0)
        trcrn[:, tr.nt_fbri] = torch.where(touched, fbri_new,
                                           trcrn[:, tr.nt_fbri])
    if tr.nbtrcr and ocean_bio is not None:
        # the ocean loses tracer into the full frazil volume: dissolved
        # tracers at initbio_frac, particulate fully (ice_zbgc.F90:
        # 988-999; negative flux_bio). The uptake U seeds the skeletal
        # concentrations (the category-1 share vi0n/vi0new area-mixed into
        # category 1, the hsurp share spread over all categories), so that
        # the ice + ocean budget closes (the JAX package's completion)
        fac = [t * initbio_frac + (1.0 - t) for t in tr.bgc_type]
        U = torch.stack([torch.where(grow, vi0new, 0.0) * ocean_bio[k]
                         * fac[k] for k in range(tr.nbtrcr)])
        flux_bio = -U / dt
        vi0_safe = torch.clamp(vi0new, min=ct.puny)
        for k, slot in enumerate(tr.nt_bgc):
            ck = trcrn[:, slot]
            gain_h = torch.where(has_surp,
                                 U[k] * hsurp / (vi0_safe * PHI_SK), 0.0)
            cn = torch.where(has_surp[None] & (aicen > ct.puny),
                             ck + gain_h[None], ck)
            u1 = torch.where(add1, U[k] * vi0n / vi0_safe, 0.0)
            c1 = torch.where(add1, (cn[0] * area1 + u1 / PHI_SK)
                             / torch.clamp(a1new, min=ct.puny), cn[0])
            trcrn[:, slot] = with_index(cn, 0, c1)
    else:
        flux_bio = aicen.new_zeros((tr.nbtrcr,) + tuple(B))
    return NewIce(aicen=aicen, vicen=vicen, trcrn=trcrn, frazil=frazil,
                  dfresh=dfresh, dfsalt=dfsalt, flux_bio=flux_bio)


class Cleanup(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    trcrn: torch.Tensor
    dfresh: torch.Tensor
    dfsalt: torch.Tensor
    dfhocn: torch.Tensor
    dfpond: torch.Tensor | None   # topo-pond water removed (m); None
                                  # without topo ponds
    dfaero: torch.Tensor     # (n_aero, *B) aerosol flux to the ocean
    dflux_bio: torch.Tensor  # (nbtrcr, *B) BGC flux to the ocean
    zapped: torch.Tensor     # (ncat, *B) bool: category fully zapped


def zap_small_areas(dt, tr: TracerRegistry, nilyr, nslyr, *, aicen, vicen,
                    vsnon, trcrn, tr_pond_topo=False) -> Cleanup:
    """Zap categories with 0 < aicen <= puny, returning melt water, salt
    and heat to the ocean (ice_itd.F90:1778-2166), and renormalize
    aice > 1 (:2028-2160); the zapped and scaled-away topo-pond water
    leaves the ponds (:1905-1913), their aerosol (:1918-1927) and
    skeletal-BGC loads go to the ocean (the BGC routing is the JAX
    package's completion: 5.1.2 drops that mass)."""
    zap = (torch.abs(aicen) <= ct.puny) & (torch.abs(aicen) != 0.0)
    qice = trcrn[:, tr.nt_qice:tr.nt_qice + nilyr]
    qsno = trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr]

    dfhocn = torch.where(zap[:, None], qice * vicen[:, None] / nilyr,
                         0.0).sum((0, 1)) / dt
    dfhocn = dfhocn + torch.where(zap[:, None],
                                  qsno * vsnon[:, None] / nslyr,
                                  0.0).sum((0, 1)) / dt
    dfresh = torch.where(zap, ct.rhoi * vicen + ct.rhos * vsnon,
                         0.0).sum(0) / dt
    dfsalt = torch.where(zap, ct.rhoi * vicen, 0.0).sum(0) \
        * ct.ice_ref_salinity * 0.001 / dt
    dfpond = (torch.where(zap, _pond_volume_per_cat(tr, aicen, trcrn),
                          0.0).sum(0) if tr_pond_topo else None)
    dfaero = torch.where(zap[None], _aero_mass_per_cat(tr, vicen, vsnon,
                                                       trcrn), 0.0).sum(1) / dt
    dflux_bio = torch.where(zap[None], _bgc_mass_per_cat(tr, aicen, trcrn),
                            0.0).sum(1) / dt

    aicen = torch.where(zap, 0.0, aicen)
    vicen = torch.where(zap, 0.0, vicen)
    vsnon = torch.where(zap, 0.0, vsnon)
    # the zapped categories' tracers reset: Tsfc to freezing, fbri to 1,
    # the rest to 0, in one select over the tracer axis
    fill = trcrn.new_zeros(tr.ntrcr)
    fill[tr.nt_Tsfc].fill_(ct.Tocnfrz)
    if tr.nt_fbri >= 0:
        fill[tr.nt_fbri].fill_(1.0)
    trcrn = torch.where(zap[:, None], fill[:, None, None], trcrn)

    aice = aicen.sum(0)
    over = aice > 1.0
    scale = torch.where(over, 1.0 / torch.clamp(aice, min=1.0), 1.0)
    excess = 1.0 - scale
    dfresh = dfresh + ((ct.rhoi * vicen + ct.rhos * vsnon)
                       * excess[None]).sum(0) / dt
    dfsalt = dfsalt + (ct.rhoi * vicen * excess[None]).sum(0) \
        * ct.ice_ref_salinity * 0.001 / dt
    dfhocn = dfhocn + ((qice.sum(1) * vicen / nilyr).sum(0)
                       + (qsno.sum(1) * vsnon / nslyr).sum(0)) * excess / dt
    if tr_pond_topo:
        dfpond = dfpond + (_pond_volume_per_cat(tr, aicen, trcrn)
                           * excess[None]).sum(0)
    dfaero = dfaero + (_aero_mass_per_cat(tr, vicen, vsnon, trcrn)
                       * excess[None, None]).sum(1) / dt
    dflux_bio = dflux_bio + (_bgc_mass_per_cat(tr, aicen, trcrn)
                             * excess[None, None]).sum(1) / dt
    aicen = aicen * scale[None]
    vicen = vicen * scale[None]
    vsnon = vsnon * scale[None]
    return Cleanup(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                   dfresh=dfresh, dfsalt=dfsalt, dfhocn=dfhocn,
                   dfpond=dfpond, dfaero=dfaero, dflux_bio=dflux_bio,
                   zapped=zap)


def zap_snow_temperature(dt, tr: TracerRegistry, nslyr, *, aicen, vsnon,
                         trcrn):
    """Remove snow whose diagnosed temperature is out of bounds
    (ice_itd.F90:2274-2420); its aerosol load goes to the ocean and its
    weightless snow-aerosol concentrations are zeroed (zap_snow,
    :2221-2236). Returns (vsnon, trcrn, dfresh, dfhocn, dfaero)."""
    TMIN = -100.0
    hsn = torch.where(aicen > ct.puny,
                      vsnon / torch.clamp(aicen, min=ct.puny), 0.0)
    qsno = trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr]
    thick = (hsn > ct.hs_min)[:, None]
    zqsn = torch.where(thick, qsno, -ct.rhos * ct.Lfresh)
    Tmax = torch.where(thick,
                       -zqsn * ct.puny * nslyr
                       / (ct.rhos * ct.cp_ice
                          * torch.clamp(vsnon, min=ct.puny)[:, None]),
                       ct.puny)
    zTsn = (ct.Lfresh + zqsn / ct.rhos) / ct.cp_ice
    bad = ((zTsn < TMIN) | (zTsn > Tmax)).any(1) & (aicen > ct.puny)
    dfresh = torch.where(bad, ct.rhos * vsnon / dt, 0.0).sum(0)
    dfhocn = torch.where(bad[:, None], qsno * vsnon[:, None] / nslyr,
                         0.0).sum((0, 1)) / dt
    dfaero = torch.where(bad[None], _aero_mass_per_cat(
        tr, vsnon, vsnon, trcrn, ice=False), 0.0).sum(1) / dt
    vsnon = torch.where(bad, 0.0, vsnon)
    trcrn = trcrn.clone()
    trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr] = torch.where(
        bad[:, None], -ct.rhos * ct.Lfresh, qsno)
    for it in range(tr.n_aero):
        s0 = tr.nt_aero + 4 * it
        trcrn[:, s0:s0 + 2] = torch.where(bad[:, None], 0.0,
                                          trcrn[:, s0:s0 + 2])
    return vsnon, trcrn, dfresh, dfhocn, dfaero


def cleanup_itd(dt, tr: TracerRegistry, hin_max, nilyr, nslyr, *, aicen,
                vicen, vsnon, trcrn, tr_pond_topo=False) -> Cleanup:
    """rebin + snow-temperature zap + small-area zap
    (ice_itd.F90:1514-1769 cleanup_itd; the small-area zap runs last so
    its aice>1 renormalization sees the final volumes)."""
    aicen, vicen, vsnon, trcrn = rebin(tr, hin_max, aicen, vicen, vsnon,
                                       trcrn)
    vsnon, trcrn, dfresh_s, dfhocn_s, dfaero_s = zap_snow_temperature(
        dt, tr, nslyr, aicen=aicen, vsnon=vsnon, trcrn=trcrn)
    out = zap_small_areas(dt, tr, nilyr, nslyr, aicen=aicen, vicen=vicen,
                          vsnon=vsnon, trcrn=trcrn,
                          tr_pond_topo=tr_pond_topo)
    return out._replace(dfresh=out.dfresh + dfresh_s,
                        dfhocn=out.dfhocn + dfhocn_s,
                        dfaero=out.dfaero + dfaero_s)
