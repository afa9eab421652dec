"""Form drag from ridges, keels, floe edges and melt ponds (PyTorch port of
``cice5_tpu/models/formdrag.py``; ice_atmo.F90:644-1023
neutral_drag_coeffs; Tsamados et al. 2014).

Partitions the neutral atmospheric and oceanic drag coefficients into skin
drag plus form-drag contributions from sails/keels (from the level-ice
tracers), floe edges (Lupkes floe-size parameterization) and pond edges.
Dense masked arithmetic over the grid; the reference's per-cell branches
are ``torch.where`` with guarded denominators.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference.cice import constants as ct

# tunable parameters (ice_atmo.F90:709-744)
CSW = 0.002        # ice-ocean skin drag coefficient
CSA = 0.0005       # ice-air skin drag coefficient
MRDG = 20.0        # atmospheric screening effect (Lu 2011)
MRDGO = 10.0       # oceanic screening effect
BETA = 0.5         # floe-length exponent
LMIN = 8.0         # min floe length (m)
LMAX = 300.0       # max floe length (m)
CFA = 0.2          # floe-edge atmo form-drag ratio
CFW = 0.2          # floe-edge ocean form-drag ratio
CPA = 0.2          # pond-edge form-drag ratio
CRA = 0.2          # ridge local form drag
CRW = 0.2          # keel local form drag
SL = 22.0          # sheltering parameter (Lupkes 2012)
LPMIN = 2.26       # min pond length (m)
LPMAX = 24.63      # max pond length (m)
TANAR = 0.4        # sail slope
TANAK = 0.4        # keel slope
PHIR = 0.8         # ridge porosity
PHIK = 0.8         # keel porosity
HKOVERHR = 4.0     # keel depth / ridge height
DKOVERDR = 1.0     # keel spacing / ridge spacing
SHGB = 0.18        # sheltering (Hanssen/Steele)
ALPHA2 = 0.0       # ridged-area weight
BETA2 = 0.75
OCNRUF = 0.000327  # ocean surface roughness (m)
CAMAX = 0.02       # max atmospheric drag
CWMAX = 0.06       # max oceanic drag


class FormDrag(NamedTuple):
    Cdn_atm: torch.Tensor
    Cdn_ocn: torch.Tensor
    Cdn_atm_skin: torch.Tensor
    Cdn_atm_floe: torch.Tensor
    Cdn_atm_pond: torch.Tensor
    Cdn_atm_rdg: torch.Tensor
    Cdn_ocn_skin: torch.Tensor
    Cdn_ocn_floe: torch.Tensor
    Cdn_ocn_keel: torch.Tensor
    hfreebd: torch.Tensor
    hdraft: torch.Tensor
    hridge: torch.Tensor
    distrdg: torch.Tensor
    hkeel: torch.Tensor
    dkeel: torch.Tensor
    lfloe: torch.Tensor
    dfloe: torch.Tensor


def neutral_drag_coeffs(*, aice, vice, vsno, aicen, vicen,
                        apnd=None, hpnd=None, ipnd=None, alvl=None,
                        vlvl=None) -> FormDrag:
    """Neutral drag partition (ice_atmo.F90:644-1023).

    aicen/vicen (ncat, ...); the pond and level-ice tracers are optional
    (None: no pond contribution, no ridged ice). hpnd and ipnd are
    accepted as the JAX function accepts them and, as there, unused."""
    act = aice > 0.001
    ai = torch.clamp(aice, min=0.001)
    aii = 1.0 / ai
    z = torch.zeros_like(aice)

    astar = 1.0 / (1.0 - (LMIN / LMAX) ** (1.0 / BETA))
    icerufi = 1.0 / ct.iceruf
    ocnrufi = 1.0 / OCNRUF
    cd_neutral = (ct.vonkar / math.log(ct.zref / ct.iceruf)) ** 2

    # pond aggregates (per unit grid-cell area)
    apond = (apnd * aicen).sum(0) if apnd is not None else z

    # draft and freeboard (Eq. 27-28)
    hdraft = (ct.rhoi * vice + ct.rhos * vsno) * aii / ct.rhow
    hfreebd = (vice + vsno) * aii - hdraft
    hi = vice * aii
    over = hdraft >= hi
    hfree_alt = (hdraft * ai * (1.0 - ct.rhoi / ct.rhow)
                 + (vsno - (vice - hdraft * ai) * ct.rhoi / ct.rhos)
                 * (1.0 - ct.rhos / ct.rhow)) * aii
    hfreebd = torch.where(over, hfree_alt, hfreebd)

    # floe length / spacing (Eq. 13-14)
    lfloe = LMIN * (astar / torch.clamp(astar - ai, min=ct.puny)) ** BETA
    dfloe = lfloe * (1.0 / torch.sqrt(ai) - 1.0)

    # ridged-ice geometry (Eq. 25-26)
    if alvl is not None:
        ardg = ((1.0 - alvl) * aicen).sum(0)
        vrdg = ((1.0 - vlvl) * vicen).sum(0)
    else:
        ardg = z
        vrdg = z
    has_rdg = act & (ardg > 0.001)
    ardg_s = torch.clamp(ardg, min=0.001)
    hridge = (vrdg / ardg_s * 2.0
              * (ALPHA2 + BETA2 * HKOVERHR / DKOVERDR * TANAR / TANAK)
              / (PHIR + PHIK * TANAR / TANAK * HKOVERHR ** 2 / DKOVERDR))
    distrdg = (2.0 * hridge * ai / ardg_s
               * (ALPHA2 / TANAR + BETA2 / TANAK * HKOVERHR / DKOVERDR))
    hkeel = HKOVERHR * hridge
    dkeel = DKOVERDR * distrdg

    # --- atmo: skin + ridge drag ---
    sail = torch.clamp(hridge - hfreebd, min=0.0)
    distrdg_s = torch.clamp(distrdg, min=ct.puny)
    cda_skin = torch.clamp(CSA * (1.0 - MRDG * sail / distrdg_s), 0.0, CAMAX)
    cda_skin = torch.where(has_rdg, cda_skin, CSA)

    sail_ok = has_rdg & (sail > ct.puny)
    sail_s = torch.clamp(sail, min=ct.puny)
    sca = 1.0 - torch.exp(-SHGB * distrdg_s / sail_s)
    cda_rdg = (ai * (CRA * 0.5) * sail / distrdg_s * sca
               * (torch.log(sail_s * icerufi)
                  / math.log(ct.zref * icerufi)) ** 2)
    cda_rdg = torch.where(sail_ok, torch.clamp(cda_rdg, max=CAMAX), 0.0)

    # --- ocean: skin + keel drag ---
    keel = torch.clamp(hkeel - hdraft, min=0.0)
    dkeel_s = torch.clamp(dkeel, min=ct.puny)
    cdw_skin = torch.clamp(CSW * (1.0 - MRDGO * keel / dkeel_s), 0.0, CWMAX)
    cdw_skin = torch.where(has_rdg, cdw_skin, CSW)

    keel_ok = has_rdg & (keel > ct.puny)
    keel_s = torch.clamp(keel, min=ct.puny)
    scw = 1.0 - torch.exp(-SHGB * dkeel_s / keel_s)
    cdw_keel = ((CRW * 0.5) * ai * keel / dkeel_s * scw
                * (torch.log(keel_s * icerufi)
                   / math.log(ct.zref * icerufi)) ** 2)
    cdw_keel = torch.where(keel_ok, torch.clamp(cdw_keel, 0.0, CWMAX), 0.0)

    # --- floe edge drag ---
    fb_ok = act & (hfreebd > ct.puny)
    fb_s = torch.clamp(hfreebd, min=ct.puny)
    sca_f = 1.0 - torch.exp(-SL * BETA * (1.0 - ai))
    cda_floe = (CFA * 0.5
                * (torch.log(fb_s * ocnrufi)
                   / math.log(ct.zref * ocnrufi)) ** 2
                * sca_f * hfreebd / lfloe)
    cda_floe = torch.where(fb_ok, torch.clamp(cda_floe, 0.0, CAMAX), 0.0)

    dr_ok = act & (hdraft > ct.puny)
    dr_s = torch.clamp(hdraft, min=ct.puny)
    cdw_floe = (CFW * 0.5
                * (torch.log(dr_s * ocnrufi)
                   / math.log(ct.zref * ocnrufi)) ** 2
                * sca_f * hdraft / lfloe)
    cdw_floe = torch.where(dr_ok, torch.clamp(cdw_floe, 0.0, CWMAX), 0.0)

    # --- pond edge drag ---
    sca_p = torch.clamp(apond, min=0.0) ** (1.0 / (ct.zref * BETA))
    lp = LPMIN * (1.0 - apond) + LPMAX * apond
    cda_pond = (CPA * 0.5 * sca_p * apond * hfreebd / lp
                * (torch.log(fb_s * ocnrufi)
                   / math.log(ct.zref * ocnrufi)) ** 2)
    cda_pond = torch.where(fb_ok, torch.clamp(cda_pond, max=CAMAX), 0.0)

    # --- totals, with ice-free defaults ---
    cda = torch.clamp(cda_skin + cda_floe + cda_pond + cda_rdg, max=CAMAX)
    cdw = torch.clamp(cdw_skin + cdw_floe + cdw_keel, max=CWMAX)

    w = lambda x, default: torch.where(act, x, default)
    return FormDrag(
        Cdn_atm=w(cda, cd_neutral), Cdn_ocn=w(cdw, ct.dragio),
        Cdn_atm_skin=w(cda_skin, 0.0), Cdn_atm_floe=w(cda_floe, 0.0),
        Cdn_atm_pond=w(cda_pond, 0.0), Cdn_atm_rdg=w(cda_rdg, 0.0),
        Cdn_ocn_skin=w(cdw_skin, 0.0), Cdn_ocn_floe=w(cdw_floe, 0.0),
        Cdn_ocn_keel=w(cdw_keel, 0.0),
        hfreebd=w(hfreebd, 0.0), hdraft=w(hdraft, 0.0),
        hridge=w(torch.where(has_rdg, hridge, 0.0), 0.0),
        distrdg=w(torch.where(has_rdg, distrdg, 0.0), 0.0),
        hkeel=w(torch.where(has_rdg, hkeel, 0.0), 0.0),
        dkeel=w(torch.where(has_rdg, dkeel, 0.0), 0.0),
        lfloe=w(lfloe, 0.0), dfloe=w(dfloe, 0.0))
