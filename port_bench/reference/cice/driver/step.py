"""One model time step (PyTorch port of ``cice5_tpu/driver/step.py``).

ice_step_mod.F90 and the standalone driver loop (CICE_RunMod.F90:107-267):
radiation (CCSM3 or delta-Eddington), form drag, per-category vertical
thermodynamics (zero-layer, BL99 or mushy; the coupler's surface fluxes
with calc_Tsfc=False), the ice age, first-year area, aerosol and the CESM,
level-ice and topographic pond tracers, the dynamic brine height and the
skeletal-layer biogeochemistry (CICE_RunMod.F90:179), ITD evolution
(linear remap, frazil, lateral melt, cleanup, with the aerosol and BGC
loads they remove sent to the ocean), EVP or EAP dynamics + remap or upwind
transport (or none) + ridging, with the optional transport and ITD
conservation checks and the per-category mechred diagnostics, the slab
ocean, and the flux aggregation for diagnostics, as one
function ``step(state, forcing, grid, ...) -> (state, diag)``.

Categories are an explicit leading batch axis: per-category fields are
(ncat, ny, nx) and layer stacks are layer-first (nlyr, ncat, ny, nx), the
JAX package's vmap written out. Radiation runs at the start of the step
(the standalone ordering of the JAX package), or with
``cfg.coupled_radiation`` at its end, on the state after dynamics, with
the thermo of the next step reading it rescaled (the reference's coupled
prep_radiation / step_radiation ordering, ice_step_mod.F90:33-154, :1364).
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.config import ModelConfig
from reference.cice.forcing import Forcing
from reference.cice.grid import Grid
from reference.cice.models import atmo, ocean
from reference.cice.models.formdrag import neutral_drag_coeffs
from reference.cice.models.dynamics import shared as dyn
from reference.cice.models.dynamics.eap import eap
from reference.cice.models.dynamics.evp import evp, evp_chunked
from reference.cice.models.dynamics.ridge import ridge_ice
from reference.cice.models.dynamics.strength import (strength_hibler,
                                                      strength_rothrock)
from reference.cice.models.radiation import dedd
from reference.cice.models.radiation.ccsm3 import (AbsorbedSolar, Albedos,
                                                   shortwave_ccsm3)
from reference.cice.models.thermo import itd, vertical
from reference.cice.models.tracers import aerosol, algae, brine, ponds
from reference.cice.models.tracers import simple
from reference.cice.models.transport.remap import transport_remap
from reference.cice.models.transport.upwind import transport_upwind
from reference.cice.ops.evp_fused import evp_fused
from reference.cice.parallel import Topology, global_min, global_sum
from reference.cice.state import State, TracerRegistry


class StepDiag(NamedTuple):
    """Cell-mean fluxes and diagnostics of one step (the merge_fluxes /
    runtime_diags surface, ice_flux.F90:681). The fields are the JAX
    package's that this configuration computes, plus the pass counts of
    the two data-dependent loops."""
    aice: torch.Tensor
    vice: torch.Tensor
    vsno: torch.Tensor
    fsens: torch.Tensor
    flat: torch.Tensor
    flwout: torch.Tensor
    evap: torch.Tensor
    fresh: torch.Tensor
    fsalt: torch.Tensor
    fhocn: torch.Tensor
    fswthru: torch.Tensor
    fswabs: torch.Tensor
    strairxT: torch.Tensor
    strairyT: torch.Tensor
    meltt: torch.Tensor
    melts: torch.Tensor
    meltb: torch.Tensor
    meltl: torch.Tensor
    congel: torch.Tensor
    snoice: torch.Tensor
    frazil: torch.Tensor
    frzmlt: torch.Tensor
    dardg1dt: torch.Tensor
    dardg2dt: torch.Tensor
    dvirdgdt: torch.Tensor
    divu: torch.Tensor
    shear: torch.Tensor
    alvdr: torch.Tensor    # cell-mean albedos (incl. open water), 4 bands
    alvdf: torch.Tensor
    alidr: torch.Tensor
    alidf: torch.Tensor
    Tsfc: torch.Tensor     # cell-mean surface temperature
    therm_converged: torch.Tensor
    ferr_max: torch.Tensor
    fpond: torch.Tensor         # net meltwater flux into ponds (m/step)
    transport_conserv_err: torch.Tensor  # 0 unless conserv_check (0-d)
    transport_mono_bad: torch.Tensor     # 0 unless monotonicity_check
    fsurfn_ai: torch.Tensor
    flatn_ai: torch.Tensor
    fsensn_ai: torch.Tensor
    fmelttn_ai: torch.Tensor
    snowfracn: torch.Tensor
    fcondtopn_ai: torch.Tensor
    fsurf: torch.Tensor
    fcondtop: torch.Tensor
    Tref: torch.Tensor
    Qref: torch.Tensor
    Uref: torch.Tensor
    strength: torch.Tensor
    prs_sig: torch.Tensor
    state_bad: torch.Tensor     # count of NaN/out-of-bounds state values
    strintx: torch.Tensor
    strinty: torch.Tensor
    strtltx: torch.Tensor
    strtlty: torch.Tensor
    strcorx: torch.Tensor
    strcory: torch.Tensor
    e11: torch.Tensor           # strain-rate tensor, EAP diagnostics
    e12: torch.Tensor           # (zero under EVP; ice_dyn_eap.F90:1278)
    e22: torch.Tensor
    yieldstress11: torch.Tensor  # anisotropic yield-stress tensor
    yieldstress12: torch.Tensor  # (ice_dyn_eap.F90:1330-1339)
    yieldstress22: torch.Tensor
    albice: torch.Tensor
    albsno: torch.Tensor
    albpnd: torch.Tensor        # broadband pond albedo (dEdd only)
    dsnow: torch.Tensor
    fswint: torch.Tensor
    daidtt: torch.Tensor
    dvidtt: torch.Tensor
    daidtd: torch.Tensor
    dvidtd: torch.Tensor
    dagedtt: torch.Tensor       # age tendency from thermo (s/s)
    dagedtd: torch.Tensor       # age tendency from dynamics (s/s)
    faero_ocn: torch.Tensor     # (n_aero, ny, nx) aerosol flux to the
    # ocean (kg/m^2/s); (0, ny, nx) when tr_aero is off
    flux_bio: torch.Tensor      # (nbtrcr, ny, nx) BGC flux to the ocean
    # (mmol/m^2/s); (0, ny, nx) when skl_bgc is off
    PP_net: torch.Tensor        # net primary production (mg C/m^2/s)
    grow_net: torch.Tensor      # net specific algal growth (1/s)
    opening: torch.Tensor
    niter_thermo: torch.Tensor  # BL99 or mushy Picard passes (0-d int64)
    niter_ridge: torch.Tensor   # ridging passes (0-d int64)
    # form-drag diagnostics stacked in DRAG_KEYS order (ice_history_drag
    # .F90 f_drag/f_Cdn_atm/f_Cdn_ocn); (len(DRAG_KEYS), ny, nx) when
    # cfg.forcing.formdrag else (0, ny, nx)
    drag: torch.Tensor
    # per-category mechred diagnostics stacked in RDGN_KEYS order
    # (ice_history_mechred.F90); (9, ncat, ny, nx) when
    # cfg.dyn.diag_mechred else (0, ncat, ny, nx)
    rdgn: torch.Tensor


DRAG_KEYS = ("Cdn_atm", "Cdn_ocn", "Cdn_atm_skin", "Cdn_atm_floe",
             "Cdn_atm_pond", "Cdn_atm_rdg", "Cdn_ocn_skin", "Cdn_ocn_floe",
             "Cdn_ocn_keel", "hfreebd", "hdraft", "hridge", "distrdg",
             "hkeel", "dkeel", "lfloe", "dfloe")
RDGN_KEYS = ("dardg1ndt", "dardg2ndt", "dvirdgndt", "araftn", "vraftn",
             "aparticn", "krdgn", "aredistn", "vredistn")


# the smallest ocean-cell spacing of each grid, read from the device once
# per grid: a captured step may read nothing from the device
_MIN_SPACING: dict[int, tuple[weakref.ref, float]] = {}


def _min_spacing(grid: Grid, topo: Topology) -> float:
    """min(dxt, dyt) over the ocean (the revised EVP's xmin)."""
    hit = _MIN_SPACING.get(id(grid.dxt))
    if hit is None or hit[0]() is not grid.dxt:
        xmin = float(global_min(torch.where(
            grid.tmask, torch.minimum(grid.dxt, grid.dyt), float("inf")),
            topo))
        hit = _MIN_SPACING[id(grid.dxt)] = (weakref.ref(grid.dxt), xmin)
    return hit[1]


def evp_params(cfg: ModelConfig, grid: Grid,
               topo: Topology) -> dyn.EVPParams:
    """The EVP parameters of one dynamics subcycle of dt/ndtd: the revised
    EVP's (brlx from the grid's smallest ocean spacing, revp=1) with
    ``revised_evp``, else the classic ones."""
    dt_dyn = cfg.time.dt / cfg.time.ndtd
    kw = dict(cosw=cfg.dyn.cosw, sinw=cfg.dyn.sinw, e_ratio=cfg.dyn.e_ratio)
    if cfg.dyn.revised_evp:
        return dyn.EVPParams.revised(dt_dyn, cfg.dyn.ndte,
                                     _min_spacing(grid, topo), **kw)
    return dyn.EVPParams.classic(dt_dyn, cfg.dyn.ndte, **kw)


def _layers(trcrn, i0, n):
    """trcrn[:, i0:i0+n] as a layer-first (n, ncat, ...) stack."""
    return trcrn[:, i0:i0 + n].movedim(1, 0)


def _step_radiation(aicen, vicen, vsnon, trcrn, forcing: Forcing,
                    cfg: ModelConfig, tr: TracerRegistry):
    """One radiation pass over all categories (step_radiation,
    ice_step_mod.F90:1364: run_dEdd | shortwave_ccsm3). Returns (alb,
    absr, Sswabsn (nslyr, ncat, ...), albpndn, snowfracn) with the layer
    stacks layer-first. dEdd runs the shortwave_dedd kernel on the GPU
    and its plain version on the CPU (dedd.shortwave_dEdd_ncat)."""
    nilyr, nslyr = cfg.nilyr, cfg.nslyr
    Tsfcn = trcrn[:, tr.nt_Tsfc]
    sw = cfg.shortwave
    if sw.shortwave == "dEdd":
        tcfg = cfg.tracers
        swid_tot = forcing.swidr + forcing.swidf
        fnidr = torch.where(swid_tot > ct.puny, forcing.swidr
                            / torch.clamp(swid_tot, min=ct.puny), 0.0)
        if tcfg.tr_pond:
            apnd_r = trcrn[:, tr.nt_apnd]
            hpnd_r = trcrn[:, tr.nt_hpnd]
            if tcfg.tr_pond_lvl:
                apnd_r = apnd_r * trcrn[:, tr.nt_alvl]
            elif tcfg.tr_pond_topo:
                # a topo pond counts for radiation only while its refrozen
                # lid is thinner than hp1 (ice_shortwave.F90:1516-1537)
                eff = ((apnd_r * aicen > ct.puny)
                       & (trcrn[:, tr.nt_ipnd] < tcfg.hp1))
                apnd_r = torch.where(eff, apnd_r, 0.0)
        else:
            apnd_r = hpnd_r = torch.zeros_like(aicen)
        de = dedd.shortwave_dEdd_ncat(
            nilyr=nilyr, nslyr=nslyr, aicen=aicen.contiguous(),
            vicen=vicen.contiguous(), vsnon=vsnon.contiguous(),
            Tsfcn=Tsfcn.contiguous(), apnd=apnd_r.contiguous(),
            hpnd=hpnd_r.contiguous(), coszen=forcing.coszen, fnidr=fnidr,
            swvdr=forcing.swvdr, swvdf=forcing.swvdf, swidr=forcing.swidr,
            swidf=forcing.swidf, R_ice=sw.R_ice, R_pnd=sw.R_pnd,
            R_snw=sw.R_snw, dT_mlt=sw.dT_mlt, rsnw_mlt=sw.rsnw_mlt,
            kalg=sw.kalg, hs0=tcfg.hs0, hs1=tcfg.hs1,
            pndaspect=tcfg.pndaspect,
            pond_scheme=("topo" if tcfg.tr_pond_topo else
                         "lvl" if tcfg.tr_pond_lvl else "cesm"))
        zc = torch.zeros_like(aicen)
        alb = Albedos(alvdrn=de.alvdrn, alidrn=de.alidrn, alvdfn=de.alvdfn,
                      alidfn=de.alidfn, alvdrni=de.alvdrn,
                      alidrni=de.alidrn, alvdfni=de.alvdfn,
                      alidfni=de.alidfn, alvdrns=zc, alidrns=zc,
                      alvdfns=zc, alidfns=zc, albin=de.albicen,
                      albsn=de.albsnon)
        absr = AbsorbedSolar(fswsfc=de.fswsfcn, fswint=de.fswintn,
                             fswthru=de.fswthrun,
                             Iswabs=de.Iswabsn.movedim(1, 0),
                             fswpenl=de.fswpenln.movedim(1, 0))
        return (alb, absr, de.Sswabsn.movedim(1, 0), de.albpndn,
                de.snowfracn)
    alb, absr = shortwave_ccsm3(
        aicen, vicen, vsnon, Tsfcn, forcing.swvdr, forcing.swvdf,
        forcing.swidr, forcing.swidf, nilyr=nilyr,
        albedo_type=sw.albedo_type, albicev=sw.albicev, albicei=sw.albicei,
        albsnowv=sw.albsnowv, albsnowi=sw.albsnowi, ahmax=sw.ahmax,
        heat_capacity=cfg.thermo.ktherm != 0)
    Sswabsn = torch.zeros((nslyr,) + tuple(aicen.shape), dtype=aicen.dtype,
                          device=aicen.device)
    hs_r = torch.where(aicen > ct.puny,
                       vsnon / torch.clamp(aicen, min=ct.puny), 0.0)
    snowfracn = torch.where(aicen > ct.puny, hs_r / (hs_r + ct.snowpatch),
                            0.0)
    return alb, absr, Sswabsn, torch.zeros_like(aicen), snowfracn


def _radiation_memory(aicen, alb, absr, Sswabsn, forcing: Forcing):
    """(rad_prev, rad_alb, scale_factor) of a radiation pass, the memory of
    the coupled ordering: the per-category absorption stack (ncat, 3 +
    nslyr + nilyr, ...) [fswsfc, fswint, fswthru, Sswabs, Iswabs], the
    ai-weighted ice-only band albedos (4, ...) (prep_radiation reads
    alvdr_ai, ice_step_mod.F90:86-97) and the net SW they absorb."""
    rad_prev = torch.cat(
        [absr.fswsfc[:, None], absr.fswint[:, None], absr.fswthru[:, None],
         Sswabsn.movedim(0, 1), absr.Iswabs.movedim(0, 1)], dim=1)
    rad_alb = torch.stack([(aicen * a).sum(0) for a in (
        alb.alvdrn, alb.alvdfn, alb.alidrn, alb.alidfn)])
    return rad_prev, rad_alb, _net_sw(forcing, rad_alb)


def _net_sw(forcing: Forcing, al):
    """The 4-band shortwave absorbed under band albedos ``al``."""
    return (forcing.swvdr * (1.0 - al[0]) + forcing.swvdf * (1.0 - al[1])
            + forcing.swidr * (1.0 - al[2]) + forcing.swidf * (1.0 - al[3]))


def prefill_radiation(state: State, forcing: Forcing, cfg: ModelConfig,
                      tr: TracerRegistry) -> State:
    """Seed the coupled-ordering radiation memory from the initial state
    (init_shortwave, ice_shortwave.F90:164, called from cice_init:
    without it the first coupled step would run thermo with zero SW)."""
    alb, absr, Sswabsn, _, _ = _step_radiation(
        state.aicen, state.vicen, state.vsnon, state.trcrn, forcing, cfg, tr)
    rad_prev, rad_alb, scale_factor = _radiation_memory(
        state.aicen, alb, absr, Sswabsn, forcing)
    return state.replace(rad_prev=rad_prev, rad_alb=rad_alb,
                         scale_factor=scale_factor)


def _aerosol(dt, trcrn, tres, aicen0, vicen0, vsnon0, forcing: Forcing,
             tr: TracerRegistry, nilyr, nslyr):
    """The aerosol column update of every category (ice_step_mod.F90:
    576-600 -> update_aerosol), in place on ``trcrn``. aicen0/vicen0/
    vsnon0: the state before thermo. Returns the flux to the ocean summed
    over the categories (n_aero, ny, nx)."""
    na, a0 = tr.n_aero, tr.nt_aero
    ncat, B = trcrn.shape[0], tuple(trcrn.shape[2:])
    # (ncat, na, 4, ...) -> the snow and ice pairs (na, 2, ncat, ...)
    blk = trcrn[:, a0:a0 + 4 * na].reshape((ncat, na, 4) + B).movedim(0, 2)
    faero_atm = forcing.faero_atm
    if faero_atm is None:
        faero_atm = aerosol.faero_default(na, B, dtype=trcrn.dtype,
                                          device=trcrn.device)
    ares = aerosol.update_aerosol(
        dt, meltt=tres.meltt, melts=tres.melts, meltb=tres.meltb,
        congel=tres.congel, snoice=tres.snoice, fsnow=forcing.fsnow[None],
        aerosno=blk[:, 0:2], aeroice=blk[:, 2:4], aice_old=aicen0,
        vice_old=vicen0, vsno_old=vsnon0, aicen=tres.aicen,
        vicen=tres.vicen, vsnon=tres.vsnon, faero_atm=faero_atm[:, None],
        nilyr=nilyr, nslyr=nslyr)
    trcrn[:, a0:a0 + 4 * na] = torch.cat(
        [ares.aerosno, ares.aeroice], dim=1).movedim(2, 0).reshape(
        (ncat, 4 * na) + B)
    return ares.faero_ocn.sum(1)


def _brine_bgc(dt, trcrn, tres, absr, aicen0, vicen0, first_ice, sst,
               forcing: Forcing, cfg: ModelConfig, tr: TracerRegistry,
               ob_flat):
    """The brine height and skeletal-BGC updates (CICE_RunMod.F90:179;
    ice_brine.F90, ice_algae.F90), in place on ``trcrn``. aicen0/vicen0:
    the state before thermo; ob_flat: the ocean BGC concentrations.
    Returns (first_ice after the update, flux_bio, PP_net, grow_net), the
    last three None without skl_bgc."""
    tcfg = cfg.tracers
    nilyr = cfg.nilyr
    aicen = tres.aicen
    dtype = trcrn.dtype
    had = aicen0 > ct.puny
    hin_old = torch.where(had, vicen0 / torch.clamp(aicen0, min=ct.puny),
                          0.0)
    first_ice = torch.where(had, first_ice, 1.0)
    if tcfg.tr_brine:
        pf = brine.preflushing_changes(
            aicen=aicen, vicen=tres.vicen, vsnon=tres.vsnon,
            meltb=tres.meltb, meltt=tres.meltt, congel=tres.congel,
            snoice=tres.snoice, hice_old=hin_old,
            fbri=torch.where(had, trcrn[:, tr.nt_fbri], 1.0),
            first_ice=first_ice)
        ms = brine.compute_microS_mushy(
            trcrn[:, tr.nt_sice:tr.nt_sice + nilyr].movedim(1, -1),
            trcrn[:, tr.nt_qice:tr.nt_qice + nilyr].movedim(1, -1),
            pf.hin_old, pf.hbr_old, forcing.sss.expand_as(aicen),
            sst.expand_as(aicen), nblyr=nilyr)
        hb = brine.update_hbrine(
            dt, meltb=tres.meltb, meltt=tres.meltt, melts=tres.melts,
            hin=pf.hin, hsn=pf.hsn, hin_old=pf.hin_old,
            hbr_old=torch.minimum(pf.hbr_old, brine.MAXHBR * pf.hin_old),
            dhS_top=pf.dhbr_top, dhS_bottom=pf.dhbr_bot, kperm=ms.kperm,
            zphi_min=ms.zphi_min)
        trcrn[:, tr.nt_fbri] = torch.where(aicen > ct.puny, hb.fbri,
                                           pf.fbri)
    flux_bio = PP_net = grow_net = None
    if tcfg.skl_bgc:
        b0, nb = tr.nt_bgc[0], tr.nbtrcr
        sk = algae.skl_biogeochemistry(
            dt, tr, conc=trcrn[:, b0:b0 + nb].movedim(1, 0),
            ocean_bio=ob_flat[:, None], aicen=aicen, meltb=tres.meltb,
            congel=tres.congel, fswthru=absr.fswthru, first_ice=first_ice,
            flux_type=tcfg.bgc_flux_type)
        trcrn[:, b0:b0 + nb] = sk.conc.movedim(0, 1)
        # merged to cell means (ice_zbgc.F90:770-840)
        flux_bio = (sk.flux_bio * aicen[None]).sum(1)
        iN = tr.bgc_names.index("N")
        PP_net = (sk.conc[iN] * algae.PHI_SK * sk.grow_N
                  * (1.0 - algae.FR_RESP) * algae.R_C2N * algae.R_gC2molC
                  * aicen).sum(0)
        grow_net = (sk.grow_N * algae.PHI_SK * aicen).sum(0)
    return ((~(aicen > ct.puny)).to(dtype), flux_bio, PP_net, grow_net)


def _column_physics(aicen, vicen, vsnon, trcrn, strocnxT, strocnyT,
                    forcing: Forcing, *, sst, frzmlt, tmask, ULAT, salinz,
                    cfg: ModelConfig, tr: TracerRegistry, hin_max,
                    first_ice, uice_T=None, vice_T=None, scale_factor=None,
                    rad_prev=None, rad_alb=None):
    """Pre-dynamics column physics: form drag, radiation (or, in the
    coupled ordering, last step's rescaled), ABL + vertical thermo, the
    age/FY/aerosol/pond tracers, the brine height and skeletal BGC, and
    the step_therm2 ITD evolution (ice_step_mod.F90 step_therm1/2).
    uice_T/vice_T: the ice velocity on the T grid (highfreq);
    scale_factor/rad_prev/rad_alb: the coupled ordering's radiation
    memory. Returns (state dict, diagnostics dict, scalars dict)."""
    dt = cfg.time.dt
    nilyr, nslyr = cfg.nilyr, cfg.nslyr
    tcfg = cfg.tracers
    mushy_on = cfg.thermo.ktherm == 2
    aicen0, vicen0, vsnon0 = aicen, vicen, vsnon
    Tsfcn = trcrn[:, tr.nt_Tsfc]
    zqin = _layers(trcrn, tr.nt_qice, nilyr)
    zSin = _layers(trcrn, tr.nt_sice, nilyr)
    zqsn = _layers(trcrn, tr.nt_qsno, nslyr)

    agg0 = itd.aggregate(tr, aicen, vicen, vsnon, trcrn)
    aice = agg0.aice
    Tf = forcing.Tf

    # form drag (ice_atmo.F90:644 neutral_drag_coeffs; formdrag namelist)
    Cdn_atm, Cw_ocn = None, ct.dragio
    drag_stack = aice.new_zeros((0,) + tuple(aice.shape))
    if cfg.forcing.formdrag:
        fdkw = {}
        if tr.nt_apnd >= 0:
            fdkw.update(apnd=trcrn[:, tr.nt_apnd], hpnd=trcrn[:, tr.nt_hpnd])
            if tr.nt_ipnd >= 0:
                fdkw.update(ipnd=trcrn[:, tr.nt_ipnd])
        if tr.nt_alvl >= 0:
            fdkw.update(alvl=trcrn[:, tr.nt_alvl], vlvl=trcrn[:, tr.nt_vlvl])
        fd = neutral_drag_coeffs(aice=aice, vice=agg0.vice, vsno=agg0.vsno,
                                 aicen=aicen, vicen=vicen, **fdkw)
        Cdn_atm, Cw_ocn = fd.Cdn_atm, fd.Cdn_ocn
        drag_stack = torch.stack([getattr(fd, k) for k in DRAG_KEYS])

    if cfg.coupled_radiation:
        # prep_radiation ordering (ice_step_mod.F90:33-154): thermo runs on
        # LAST step's per-category SW absorption, rescaled by the ratio of
        # this step's net SW under last step's ice albedos to last step's
        # (scale_factor); the radiation proper runs at the end of the step
        # (``step``), which also fills the albedos and snow fraction
        sfac = torch.where((aice > 0.0) & (scale_factor > ct.puny),
                           _net_sw(forcing, rad_alb)
                           / torch.clamp(scale_factor, min=ct.puny), 1.0)
        rp = rad_prev * sfac[None, None]
        absr = AbsorbedSolar(
            fswsfc=rp[:, 0], fswint=rp[:, 1], fswthru=rp[:, 2],
            Iswabs=rp[:, 3 + nslyr:3 + nslyr + nilyr].movedim(1, 0),
            fswpenl=None)
        Sswabsn = rp[:, 3:3 + nslyr].movedim(1, 0)
        zc = torch.zeros_like(aicen)
        alb = Albedos(alvdrn=zc, alidrn=zc, alvdfn=zc, alidfn=zc,
                      alvdrni=zc, alidrni=zc, alvdfni=zc, alidfni=zc,
                      alvdrns=zc, alidrns=zc, alvdfns=zc, alidfns=zc,
                      albin=zc, albsn=zc)
        albpndn = snowfracn = zc
    else:
        # radiation, all categories at once
        alb, absr, Sswabsn, albpndn, snowfracn = _step_radiation(
            aicen, vicen, vsnon, trcrn, forcing, cfg, tr)

    # bottom flux & lateral melt potential
    qicen_tot = trcrn[:, tr.nt_qice:tr.nt_qice + nilyr].sum(1) * vicen \
        / nilyr
    qsnon_tot = trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr].sum(1) * vsnon \
        / nslyr
    Tbot, fbot, rside = vertical.frzmlt_bottom_lateral(
        dt, aice, frzmlt, vicen, vsnon, qicen_tot, qsnon_tot, sst, Tf,
        strocnxT, strocnyT, ustar_min=cfg.thermo.ustar_min,
        Cdn_ocn=(Cw_ocn if cfg.thermo.fbot_xfer_type == "Cdn_ocn"
                 else None))

    # ABL + vertical thermo, all categories at once
    if cfg.forcing.atmbndy == "constant":
        abl = atmo.atmo_boundary_const(
            sfctype="ice", Tsf=Tsfcn, potT=forcing.potT, uatm=forcing.uatm,
            vatm=forcing.vatm, wind=forcing.wind, Qa=forcing.Qa,
            rhoa=forcing.rhoa)
    else:
        abl = atmo.atmo_boundary_layer(
            sfctype="ice", Tsf=Tsfcn, potT=forcing.potT, uatm=forcing.uatm,
            vatm=forcing.vatm, wind=forcing.wind, zlvl=forcing.zlvl,
            Qa=forcing.Qa, rhoa=forcing.rhoa,
            natmiter=cfg.forcing.natmiter, Cdn_atm=Cdn_atm,
            highfreq=cfg.forcing.highfreq, uice=uice_T, vice=vice_T)
    thermo_kw = {}
    if tcfg.tr_pond and mushy_on:
        apnd_all = trcrn[:, tr.nt_apnd]
        if tcfg.tr_pond_lvl:
            apnd_all = apnd_all * trcrn[:, tr.nt_alvl]
        thermo_kw.update(hpond=trcrn[:, tr.nt_hpnd], apond=apnd_all)
    if not cfg.thermo.calc_Tsfc:
        # coupled mode: per-category surface fluxes from the coupler
        # (set_sfcflux, ice_flux.F90:1015)
        if forcing.fsurfn_f is None or forcing.fcondtopn_f is None \
                or forcing.flatn_f is None:
            raise ValueError(
                "calc_Tsfc=False needs the coupler's per-category fluxes "
                "Forcing.fsurfn_f, fcondtopn_f and flatn_f (fsensn_f "
                "optional), each (ncat, ny, nx)")
        thermo_kw.update(fsurfn_f=forcing.fsurfn_f,
                         fcondtopn_f=forcing.fcondtopn_f,
                         flatn_f=forcing.flatn_f,
                         fsensn_f=forcing.fsensn_f)
    tres = vertical.thermo_vertical(
        dt, cfg, aicen=aicen, vicen=vicen, vsnon=vsnon, Tsfcn=Tsfcn,
        zqin=zqin, zqsn=zqsn, zSin=zSin, flw=forcing.flw, potT=forcing.potT,
        Qa=forcing.Qa, rhoa=forcing.rhoa, fsnow=forcing.fsnow,
        shcoef=abl.shcoef, lhcoef=abl.lhcoef, fswsfc=absr.fswsfc,
        fswint=absr.fswint, Sswabs=Sswabsn, Iswabs=absr.Iswabs, fbot=fbot,
        Tbot=Tbot, sss=forcing.sss, **thermo_kw)

    # merge per-category fluxes with pre-thermo areas (merge_fluxes)
    w = aicen
    mrg = lambda x: (w * x).sum(0)
    dg = dict(
        fsens=mrg(tres.fsensn), flat=mrg(tres.flatn),
        flwout=mrg(tres.flwoutn), evap=mrg(tres.evapn),
        fresh=mrg(tres.freshn), fsalt=mrg(tres.fsaltn),
        fhocn=mrg(tres.fhocnn), fswthru=mrg(absr.fswthru),
        fswabs=mrg(absr.fswsfc + absr.fswint + absr.fswthru),
        strairxT=mrg(abl.strx), strairyT=mrg(abl.stry),
        meltt=mrg(tres.meltt), melts=mrg(tres.melts),
        meltb=mrg(tres.meltb), congel=mrg(tres.congel),
        snoice=mrg(tres.snoice), fsurf=mrg(tres.fsurfn),
        fcondtop=mrg(tres.fcondtopn), Tref=mrg(abl.Tref),
        Qref=mrg(abl.Qref), Uref=mrg(abl.Uref), albice=mrg(alb.albin),
        albsno=mrg(alb.albsn), albpnd=mrg(albpndn), fswint=mrg(absr.fswint),
        dsnow=mrg(tres.dsnow), aice_pre=agg0.aice, vice_pre=agg0.vice,
        alvdrn=alb.alvdrn, alvdfn=alb.alvdfn, alidrn=alb.alidrn,
        alidfn=alb.alidfn, snowfracn=snowfracn,
        fsurfn_ai=w * tres.fsurfn, flatn_ai=w * tres.flatn,
        fsensn_ai=w * tres.fsensn,
        fmelttn_ai=w * torch.clamp(tres.fsurfn - tres.fcondtopn, min=0.0),
        fcondtopn_ai=w * tres.fcondtopn, Cw_ocn=Cw_ocn, drag=drag_stack)

    aicen, vicen, vsnon = tres.aicen, tres.vicen, tres.vsnon
    trcrn = trcrn.clone()
    trcrn[:, tr.nt_Tsfc] = tres.Tsf
    trcrn[:, tr.nt_qice:tr.nt_qice + nilyr] = tres.zqin.movedim(0, 1)
    trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr] = tres.zqsn.movedim(0, 1)
    if mushy_on:
        trcrn[:, tr.nt_sice:tr.nt_sice + nilyr] = tres.zSin.movedim(0, 1)

    # optional tracers (step_therm1 tail)
    if tcfg.tr_iage:
        trcrn[:, tr.nt_iage] = simple.increment_age(
            dt, trcrn[:, tr.nt_iage], aicen)
    if tcfg.tr_FY:
        trcrn[:, tr.nt_FY] = simple.update_FYarea(
            dt, forcing.yday, trcrn[:, tr.nt_FY], aicen, (ULAT >= 0.0)[None])
    if tr.n_aero:
        dg["faero_ocn"] = _aerosol(dt, trcrn, tres, aicen0, vicen0, vsnon0,
                                   forcing, tr, nilyr, nslyr)
    fpond = torch.zeros_like(aice)      # pond water volume change (m)
    if tcfg.tr_pond:
        def _pond_volume(tc, an):
            v = tc[:, tr.nt_apnd] * tc[:, tr.nt_hpnd] * an
            if tcfg.tr_pond_lvl:
                v = v * tc[:, tr.nt_alvl]
            return v.sum(0)
        fpond = -_pond_volume(trcrn, aicen)
        rfrac = tcfg.rfracmin + (tcfg.rfracmax - tcfg.rfracmin) * aice
        if tcfg.tr_pond_cesm:
            trcrn[:, tr.nt_apnd], trcrn[:, tr.nt_hpnd] = \
                ponds.compute_ponds_cesm(
                    dt, aicen=aicen, vicen=vicen, vsnon=vsnon,
                    Tsfcn=tres.Tsf, apnd=trcrn[:, tr.nt_apnd],
                    hpnd=trcrn[:, tr.nt_hpnd], meltt=tres.meltt,
                    melts=tres.melts, frain=forcing.frain,
                    rfrac=rfrac[None], pndaspect=tcfg.pndaspect)
        else:
            if tcfg.tr_pond_lvl:
                pr = ponds.compute_ponds_lvl(
                    dt, aicen=aicen, vicen=vicen, vsnon=vsnon,
                    Tsfcn=tres.Tsf, alvl=trcrn[:, tr.nt_alvl],
                    apnd=trcrn[:, tr.nt_apnd], hpnd=trcrn[:, tr.nt_hpnd],
                    ipnd=trcrn[:, tr.nt_ipnd], meltt=tres.meltt,
                    melts=tres.melts, frain=forcing.frain,
                    rfrac=rfrac[None], Tair=forcing.Tair,
                    fsurfn=tres.fsurfn, dhs=tres.dsnow, qicen=tres.zqin,
                    sicen=zSin, pndaspect=tcfg.pndaspect,
                    frzpnd=tcfg.frzpnd, dpscale=tcfg.dpscale,
                    ktherm=cfg.thermo.ktherm)
            else:
                # the cell's meltwater over the lowest-lying categories
                # (ice_step_mod.F90:713-731 compute_ponds_topo)
                pr = ponds.compute_ponds_topo(
                    dt, aice=agg0.aice, aicen=aicen, vice=agg0.vice,
                    vicen=vicen, vsno=agg0.vsno, vsnon=vsnon,
                    meltt=dg["meltt"], fsurf=dg["fsurf"], Tsfcn=tres.Tsf,
                    Tf=Tf, qicen=tres.zqin,
                    sicen=tres.zSin if mushy_on else zSin,
                    apnd=trcrn[:, tr.nt_apnd], hpnd=trcrn[:, tr.nt_hpnd],
                    ipnd=trcrn[:, tr.nt_ipnd], ktherm=cfg.thermo.ktherm,
                    heat_capacity=cfg.thermo.ktherm != 0)
            trcrn[:, tr.nt_apnd] = pr.apnd
            trcrn[:, tr.nt_hpnd] = pr.hpnd
            trcrn[:, tr.nt_ipnd] = pr.ipnd
        fpond = fpond + _pond_volume(trcrn, aicen)

    # brine height and skeletal BGC (CICE_RunMod.F90:179)
    ob_flat = None
    if tcfg.skl_bgc:
        ob_flat = forcing.ocean_bio
        if ob_flat is None:
            ob_flat = algae.default_ocean_bio(tr, aice.shape,
                                              dtype=aice.dtype,
                                              device=aice.device)
    if tcfg.tr_brine or tcfg.skl_bgc:
        first_ice, flux_bio, PP_net, grow_net = _brine_bgc(
            dt, trcrn, tres, absr, aicen0, vicen0, first_ice, sst, forcing,
            cfg, tr, ob_flat)
        if tcfg.skl_bgc:
            dg.update(flux_bio=flux_bio, PP_net=PP_net, grow_net=grow_net)

    # step_therm2: ITD evolution
    itd_bad = None
    if cfg.kitd == 1:
        if cfg.dyn.conserv_check:
            pre_sums = itd.itd_conservation_sums(tr, nilyr, nslyr, aicen,
                                                 vicen, vsnon, trcrn)
        aicen, vicen, vsnon, trcrn = itd.linear_itd(
            tr, hin_max, nslyr, aicen_init=aicen0, vicen_init=vicen0,
            aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn)
        if cfg.dyn.conserv_check:
            # the reference's l_stop abort on a linear_itd conservation
            # violation (ice_therm_itd.F90:783-860), counted into the
            # step's state_bad
            itd_bad = itd.itd_conservation_check(
                pre_sums, itd.itd_conservation_sums(tr, nilyr, nslyr, aicen,
                                                    vicen, vsnon, trcrn))

    agg1 = itd.aggregate(tr, aicen, vicen, vsnon, trcrn)
    nir = itd.add_new_ice(dt, tr, hin_max, nilyr, aicen=aicen, vicen=vicen,
                          trcrn=trcrn, aice=agg1.aice, aice0=agg1.aice0,
                          frzmlt=frzmlt, Tf=Tf, salinz=salinz,
                          tr_FY=tcfg.tr_FY, tr_lvl=tcfg.tr_lvl,
                          tr_iage=tcfg.tr_iage,
                          update_ocn_f=cfg.forcing.update_ocn_f,
                          ktherm=cfg.thermo.ktherm, sss=forcing.sss,
                          phi_init=cfg.thermo.phi_init,
                          dSin0_frazil=cfg.thermo.dSin0_frazil,
                          hfrazilmin=cfg.thermo.hfrazilmin,
                          tr_brine=tcfg.tr_brine, ocean_bio=ob_flat,
                          initbio_frac=tcfg.initbio_frac)
    aicen, vicen, trcrn = nir.aicen, nir.vicen, nir.trcrn
    dg["frazil"] = nir.frazil
    dg["fresh"] = dg["fresh"] + nir.dfresh
    dg["fsalt"] = dg["fsalt"] + nir.dfsalt
    if tcfg.skl_bgc:
        # frazil BGC uptake from the ocean (add_new_ice_bgc,
        # ice_zbgc.F90:988-999)
        dg["flux_bio"] = dg["flux_bio"] + nir.flux_bio

    lm = itd.lateral_melt(dt, tr, nilyr, nslyr, aicen=aicen, vicen=vicen,
                          vsnon=vsnon, trcrn=trcrn, rside=rside,
                          tr_pond_topo=tcfg.tr_pond_topo)
    aicen, vicen, vsnon = lm.aicen, lm.vicen, lm.vsnon
    dg["fresh"] = dg["fresh"] + lm.fresh
    dg["fsalt"] = dg["fsalt"] + lm.fsalt
    dg["fhocn"] = dg["fhocn"] + lm.fhocn
    dg["meltl"] = lm.meltl

    cl = itd.cleanup_itd(dt, tr, hin_max, nilyr, nslyr, aicen=aicen,
                         vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                         tr_pond_topo=tcfg.tr_pond_topo)
    aicen, vicen, vsnon, trcrn = cl.aicen, cl.vicen, cl.vsnon, cl.trcrn
    dg["fresh"] = dg["fresh"] + cl.dfresh
    dg["fsalt"] = dg["fsalt"] + cl.dfsalt
    dg["fhocn"] = dg["fhocn"] + cl.dfhocn
    if tcfg.tr_pond_topo:
        # topo-pond water that lateral melt and the zap removed
        # (ice_itd.F90:1741-1750, ice_therm_itd.F90:1146-1212)
        fpond = fpond - lm.dfpond - cl.dfpond
    dg["fpond"] = fpond
    # the aerosol and BGC loads of the melted and zapped ice
    # (ice_itd.F90:1741-1750, ice_therm_itd.F90:1146-1212)
    if tr.n_aero:
        dg["faero_ocn"] = dg["faero_ocn"] + lm.dfaero + cl.dfaero
    if tcfg.skl_bgc:
        dg["flux_bio"] = dg["flux_bio"] + lm.dflux_bio + cl.dflux_bio
    if tcfg.tr_brine or tcfg.skl_bgc:
        # zapped categories restart as first ice, so brine and BGC re-seed
        # (ice_itd.F90:2013-2017)
        first_ice = torch.where(cl.zapped, 1.0, first_ice)

    # land mask enforcement
    aicen = torch.where(tmask[None], aicen, 0.0)
    vicen = torch.where(tmask[None], vicen, 0.0)
    vsnon = torch.where(tmask[None], vsnon, 0.0)

    stout = dict(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                 first_ice=first_ice)
    sc = dict(therm_converged=tres.converged.all(), ferr_max=tres.ferr.max(),
              niter_thermo=tres.niter, itd_bad=itd_bad)
    return stout, dg, sc


def step(state: State, forcing: Forcing, grid: Grid, cfg: ModelConfig,
         tr: TracerRegistry, topo: Topology, hin_max,
         salinz) -> tuple[State, StepDiag]:
    """Advance the sea-ice state by one thermo step (cfg.time.dt)."""
    dt = cfg.time.dt
    nilyr, nslyr = cfg.nilyr, cfg.nslyr
    ny, nx = grid.shape
    kw = dict(dtype=state.aicen.dtype, device=state.aicen.device)
    dtype = kw["dtype"]
    tmask = grid.tmask

    sst = state.sst if cfg.forcing.oceanmixed_ice else forcing.sst
    sst = torch.maximum(sst, forcing.Tf)
    frzmlt = state.frzmlt if cfg.forcing.oceanmixed_ice else forcing.frzmlt
    # high-frequency (RASM) coupling uses winds relative to the ice drift
    # at T points (ice_atmo.F90:220-227; Roberts et al 2014)
    uice_T = vice_T = None
    if cfg.forcing.highfreq:
        uice_T = dyn.to_tgrid(state.uvel, grid, topo)
        vice_T = dyn.to_tgrid(state.vvel, grid, topo)

    stout, dg, sc = _column_physics(
        state.aicen, state.vicen, state.vsnon, state.trcrn, state.strocnxT,
        state.strocnyT, forcing, sst=sst, frzmlt=frzmlt, tmask=tmask,
        ULAT=grid.ULAT, salinz=salinz, cfg=cfg, tr=tr, hin_max=hin_max,
        first_ice=state.first_ice, uice_T=uice_T, vice_T=vice_T,
        scale_factor=state.scale_factor,
        rad_prev=state.rad_prev, rad_alb=state.rad_alb)
    aicen, vicen, vsnon = stout["aicen"], stout["vicen"], stout["vsnon"]
    trcrn, first_ice = stout["trcrn"], stout["first_ice"]
    fresh, fsalt, fhocn = dg["fresh"], dg["fsalt"], dg["fhocn"]
    fpond = dg["fpond"]
    tcfg = cfg.tracers
    faero_ocn = dg.get("faero_ocn", torch.zeros((0, ny, nx), **kw))
    flux_bio = dg.get("flux_bio", torch.zeros((0, ny, nx), **kw))

    # dynamics: EVP + transport + ridging
    uvel, vvel = state.uvel, state.vvel
    stressp, stressm, stress12 = state.stressp, state.stressm, state.stress12
    iceumask = state.iceumask
    a11n, a12n = state.a11n, state.a12n
    strocnxT, strocnyT = state.strocnxT, state.strocnyT
    z2 = lambda: torch.zeros((ny, nx), **kw)
    divu, shear_d, opening_d = z2(), z2(), z2()
    dardg1dt, dardg2dt, dvirdgdt = z2(), z2(), z2()
    strength_d, prs_sig_d = z2(), z2()
    strintx_d, strinty_d, strtltx_d, strtlty_d = z2(), z2(), z2(), z2()
    strcorx_d, strcory_d = z2(), z2()
    e11_d, e12_d, e22_d = z2(), z2(), z2()
    ys11_d, ys12_d, ys22_d = z2(), z2(), z2()
    rdgn_d = torch.zeros((9 if cfg.dyn.diag_mechred else 0, cfg.ncat, ny,
                          nx), **kw)
    conserv_err = torch.zeros((), **kw)
    mono_bad = torch.zeros((), dtype=torch.int32, device=kw["device"])
    niter_ridge = torch.zeros((), dtype=torch.int64, device=kw["device"])

    def _mean_age(an, tc):
        if not cfg.tracers.tr_iage:
            return torch.zeros((ny, nx), **kw)
        return (an * tc[:, tr.nt_iage]).sum(0) \
            / torch.clamp(an.sum(0), min=ct.puny)

    # thermodynamic tendencies (ice_step_mod.F90 step_therm2 tail)
    aice_mid = aicen.sum(0)
    vice_mid = vicen.sum(0)
    age_mid = _mean_age(aicen, trcrn)
    daidtt = (aice_mid - dg["aice_pre"]) / dt
    dvidtt = (vice_mid - dg["vice_pre"]) / dt
    dagedtt = (age_mid - _mean_age(state.aicen, state.trcrn)) / dt
    if cfg.dyn.kdyn >= 1:
        dt_dyn = dt / cfg.time.ndtd
        p = evp_params(cfg, grid, topo)
        for _ in range(cfg.time.ndtd):
            agg = itd.aggregate(tr, aicen, vicen, vsnon, trcrn)
            if cfg.dyn.kstrength == 1:
                strength = strength_rothrock(
                    aicen, vicen, agg.aice0, hin_max=hin_max,
                    krdg_partic=cfg.dyn.krdg_partic,
                    krdg_redist=cfg.dyn.krdg_redist, mu_rdg=cfg.dyn.mu_rdg,
                    Cf=cfg.dyn.Cf)
            else:
                strength = strength_hibler(agg.aice, agg.vice,
                                           Pstar=cfg.dyn.Pstar,
                                           Cstar=cfg.dyn.Cstar)
            strength_d = strength
            dyn_kw = dict(aice=agg.aice, vice=agg.vice, vsno=agg.vsno,
                          strength=strength, strairxT=dg["strairxT"],
                          strairyT=dg["strairyT"], uocn=forcing.uocn,
                          vocn=forcing.vocn, uvel=uvel, vvel=vvel,
                          stressp=stressp, stressm=stressm,
                          stress12=stress12, iceumask=iceumask,
                          Cw=dg["Cw_ocn"])
            if cfg.dyn.kdyn == 2:
                er = eap(dt_dyn, p, grid, topo, a11n=a11n, a12n=a12n,
                         **dyn_kw)
                ev = er.evp
                a11n, a12n = er.a11n, er.a12n
                e11_d, e12_d, e22_d = er.e11, er.e12, er.e22
                ys11_d, ys12_d, ys22_d = er.ys11, er.ys12, er.ys22
            elif (cfg.dyn.evp_algorithm == "pallas" and not topo.sharded
                    and topo.ns not in ("tripole", "tripoleT")):
                # the fused subcycle sweep where the JAX step takes it
                # (cice5_tpu/driver/step.py:1010-1014): one device, not on
                # a seam
                ev = evp_fused(dt_dyn, p, grid, topo, **dyn_kw)
            elif (cfg.dyn.evp_algorithm == "chunked"
                    and topo.ns != "tripoleT"):
                # K subcycles per margin exchange (:1021-1027)
                ev = evp_chunked(dt_dyn, p, grid, topo,
                                 K=cfg.dyn.evp_chunk, **dyn_kw)
            else:
                # kernel A on one device, the loop with one exchange per
                # subcycle on a mesh of ranks (evp.evp)
                ev = evp(dt_dyn, p, grid, topo, **dyn_kw)
            uvel, vvel = ev.uvel, ev.vvel
            prs_sig_d = ev.prs_sig
            strintx_d, strinty_d = ev.strintx, ev.strinty
            strtltx_d, strtlty_d = ev.strtltx, ev.strtlty
            strcorx_d = ev.fm * ev.vvel       # ice_history.F90:1473-1476
            strcory_d = -ev.fm * ev.uvel
            stressp, stressm, stress12 = ev.stressp, ev.stressm, ev.stress12
            iceumask = ev.iceumask
            strocnxT, strocnyT = ev.strocnxT, ev.strocnyT
            divu, shear_d = ev.divu, ev.shear

            if cfg.dyn.advection == "upwind":
                aice0_t = torch.clamp(1.0 - aicen.sum(0), min=0.0) * grid.hm
                aicen, vicen, vsnon, trcrn, _ = transport_upwind(
                    dt_dyn, grid, topo, tr, uvel=uvel, vvel=vvel,
                    aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                    aice0=aice0_t)
            elif cfg.dyn.advection == "remap":
                chk = (cfg.dyn.conserv_check, cfg.dyn.monotonicity_check)
                out = transport_remap(
                    dt_dyn, grid, topo, tr, uvel=uvel, vvel=vvel,
                    aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                    conserv_check=chk[0], monotonicity_check=chk[1])
                aicen, vicen, vsnon, trcrn = out[:4]
                if any(chk):
                    conserv_err = torch.maximum(conserv_err,
                                                out[4].conserv_err)
                    mono_bad = mono_bad + out[4].mono_violations

            aice0_r = torch.clamp(1.0 - aicen.sum(0), min=0.0) * grid.hm
            rr = ridge_ice(dt_dyn, tr, hin_max, nilyr, nslyr, aicen=aicen,
                           vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                           aice0=aice0_r, rdg_conv=ev.rdg_conv,
                           rdg_shear=ev.rdg_shear,
                           krdg_partic=cfg.dyn.krdg_partic,
                           krdg_redist=cfg.dyn.krdg_redist,
                           mu_rdg=cfg.dyn.mu_rdg, ndtd=cfg.time.ndtd,
                           tr_pond_topo=cfg.tracers.tr_pond_topo,
                           cat_diags=cfg.dyn.diag_mechred)
            aicen, vicen, vsnon, trcrn = rr.aicen, rr.vicen, rr.vsnon, rr.trcrn
            niter_ridge += rr.niter
            fresh = fresh + rr.fresh
            fhocn = fhocn + rr.fhocn
            dardg1dt = dardg1dt + rr.dardg1dt
            dardg2dt = dardg2dt + rr.dardg2dt
            dvirdgdt = dvirdgdt + rr.dvirdgdt
            opening_d = opening_d + rr.opening
            if cfg.dyn.diag_mechred:
                rdgn_d = rdgn_d + rr.catdiag

            cl2 = itd.cleanup_itd(dt_dyn, tr, hin_max, nilyr, nslyr,
                                  aicen=aicen, vicen=vicen, vsnon=vsnon,
                                  trcrn=trcrn,
                                  tr_pond_topo=cfg.tracers.tr_pond_topo)
            aicen, vicen, vsnon, trcrn = (cl2.aicen, cl2.vicen, cl2.vsnon,
                                          cl2.trcrn)
            fresh = fresh + cl2.dfresh
            fsalt = fsalt + cl2.dfsalt
            fhocn = fhocn + cl2.dfhocn
            if cfg.tracers.tr_pond_topo:
                # ridged and zapped topo-pond water
                # (ice_mechred.F90:707-718)
                fpond = fpond - rr.dfpond - cl2.dfpond
            # the ridged and zapped aerosol and BGC loads
            # (ice_mechred.F90:1704-1711, ice_itd.F90:1741-1750)
            if tr.n_aero:
                faero_ocn = faero_ocn + rr.faero_ocn + cl2.dfaero
            if tcfg.skl_bgc:
                flux_bio = flux_bio + rr.dflux_bio + cl2.dflux_bio
            if tcfg.tr_brine or tcfg.skl_bgc:
                first_ice = torch.where(cl2.zapped, 1.0, first_ice)

    # coupling prep: slab ocean update
    aggf = itd.aggregate(tr, aicen, vicen, vsnon, trcrn)
    daidtd = (aggf.aice - aice_mid) / dt
    dvidtd = (aggf.vice - vice_mid) / dt
    dagedtd = (_mean_age(aicen, trcrn) - age_mid) / dt

    # melt/freeze onset dates, reset on the first step of the year
    new_year = forcing.yday <= dt / 86400.0 + 1.0e-6
    mlt_onset = torch.where(new_year, 0.0, state.mlt_onset)
    frz_onset = torch.where(new_year, 0.0, state.frz_onset)
    mlt_onset = torch.where((dg["meltt"] > 0.0) & (mlt_onset <= 0.0),
                            forcing.yday, mlt_onset)
    frz_onset = torch.where((dg["frazil"] + dg["congel"] > 0.0)
                            & (frz_onset <= 0.0), forcing.yday, frz_onset)
    # meltwater retained in ponds does not reach the ocean
    # (CICE_RunMod.F90:384-387 coupling_prep, l_mpond_fresh)
    if cfg.forcing.l_mpond_fresh and cfg.tracers.tr_pond:
        fresh = fresh - fpond * ct.rhofresh / dt
    if cfg.forcing.oceanmixed_ice:
        ml = ocean.ocean_mixed_layer(
            dt, sst=sst, Tf=forcing.Tf, hmix=forcing.hmix, qdp=forcing.qdp,
            aice=aggf.aice, fhocn=fhocn, fswthru=dg["fswthru"],
            uatm=forcing.uatm, vatm=forcing.vatm, wind=forcing.wind,
            zlvl=forcing.zlvl, potT=forcing.potT, Qa=forcing.Qa,
            rhoa=forcing.rhoa, flw=forcing.flw, swvdr=forcing.swvdr,
            swvdf=forcing.swvdf, swidr=forcing.swidr, swidf=forcing.swidf,
            tmask=tmask, atmbndy=cfg.forcing.atmbndy,
            natmiter=cfg.forcing.natmiter)
        sst_new = ml.sst
        frzmlt_out = ml.frzmlt
        if cfg.forcing.restore_sst:
            trest = (cfg.forcing.trestore * ct.secday
                     if cfg.forcing.trestore > 0 else dt)
            sst_new = sst_new + (forcing.sst - sst_new) * dt / trest
    else:
        sst_new = sst
        frzmlt_out = forcing.frzmlt

    # end-of-step radiation under the coupled ordering (step_radiation,
    # ice_step_mod.F90:1364, runs after dynamics; its outputs feed the
    # coupler now and next step's prep_radiation rescale)
    rad_prev, rad_alb = state.rad_prev, state.rad_alb
    if cfg.coupled_radiation:
        alb, absr, Sswabsn, albpndn, snowfracn = _step_radiation(
            aicen, vicen, vsnon, trcrn, forcing, cfg, tr)
        dg.update(alvdrn=alb.alvdrn, alvdfn=alb.alvdfn, alidrn=alb.alidrn,
                  alidfn=alb.alidfn, snowfracn=snowfracn,
                  albice=(aicen * alb.albin).sum(0),
                  albsno=(aicen * alb.albsn).sum(0),
                  albpnd=(aicen * albpndn).sum(0))
        # next step's rescale inputs, and (the reference's coupling_prep
        # pairing with prep_radiation's netsw) the ICE-ONLY albedos' net
        # SW as scale_factor
        rad_prev, rad_alb, scale_factor = _radiation_memory(
            aicen, alb, absr, Sswabsn, forcing)

    # cell-mean albedos incl. open water (coupling_prep)
    alb4 = [(aicen * dg[k]).sum(0) + aggf.aice0 * ct.albocn
            for k in ("alvdrn", "alvdfn", "alidrn", "alidfn")]
    alvdr, alvdf, alidr, alidf = alb4
    if not cfg.coupled_radiation:
        scale_factor = _net_sw(forcing, alb4)

    # in-step failure count (the l_stop analog, ice_step_mod.F90:858-867)
    def _nbad(x, lo, hi, mask=None):
        bad = ~torch.isfinite(x) | (x < lo) | (x > hi)
        if mask is not None:
            bad = bad & mask
        return global_sum(bad.to(torch.int32), topo)

    Tsfc_tol = 1e-6 if dtype == torch.float64 else 5e-3
    state_bad = (_nbad(aicen, -1e-6, 1.0 + 1e-6)
                 + _nbad(vicen, -1e-6, 100.0)
                 + _nbad(vsnon, -1e-6, 50.0)
                 + _nbad(uvel, -5.0, 5.0) + _nbad(vvel, -5.0, 5.0)
                 + _nbad(trcrn[:, tr.nt_Tsfc], -100.0, Tsfc_tol,
                         mask=aicen > ct.puny))
    if sc["itd_bad"] is not None:
        state_bad = state_bad + global_sum(sc["itd_bad"], topo)
    if cfg.thermo.ktherm == 0:
        # zero-layer enthalpies after every ITD operation
        # (ice_itd.F90:2428 zerolayer_check, from cleanup_itd when
        # heat_capacity=F)
        state_bad = state_bad + global_sum(itd.zerolayer_check(
            tr, nilyr, nslyr, aicen, vicen, vsnon, trcrn), topo)
    state_bad = state_bad.to(torch.int32)

    new_state = state.replace(
        aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
        first_ice=first_ice,
        uvel=uvel, vvel=vvel, a11n=a11n, a12n=a12n, stressp=stressp,
        stressm=stressm, stress12=stress12, iceumask=iceumask,
        strocnxT=strocnxT,
        strocnyT=strocnyT, frzmlt=frzmlt_out, scale_factor=scale_factor,
        rad_prev=rad_prev, rad_alb=rad_alb,
        sst=sst_new, mlt_onset=mlt_onset, frz_onset=frz_onset)

    diag = StepDiag(
        aice=aggf.aice, vice=aggf.vice, vsno=aggf.vsno,
        fsens=dg["fsens"], flat=dg["flat"], flwout=dg["flwout"],
        evap=dg["evap"], fresh=fresh, fsalt=fsalt, fhocn=fhocn,
        fswthru=dg["fswthru"], fswabs=dg["fswabs"],
        strairxT=dg["strairxT"], strairyT=dg["strairyT"],
        meltt=dg["meltt"], melts=dg["melts"], meltb=dg["meltb"],
        meltl=dg["meltl"], congel=dg["congel"], snoice=dg["snoice"],
        frazil=dg["frazil"], frzmlt=frzmlt_out,
        dardg1dt=dardg1dt, dardg2dt=dardg2dt, dvirdgdt=dvirdgdt,
        divu=divu, shear=shear_d,
        alvdr=alvdr, alvdf=alvdf, alidr=alidr, alidf=alidf,
        Tsfc=aggf.trcr[tr.nt_Tsfc],
        therm_converged=sc["therm_converged"], ferr_max=sc["ferr_max"],
        fpond=fpond, transport_conserv_err=conserv_err,
        transport_mono_bad=mono_bad,
        fsurfn_ai=dg["fsurfn_ai"], flatn_ai=dg["flatn_ai"],
        fsensn_ai=dg["fsensn_ai"], fmelttn_ai=dg["fmelttn_ai"],
        snowfracn=dg["snowfracn"], fcondtopn_ai=dg["fcondtopn_ai"],
        fsurf=dg["fsurf"], fcondtop=dg["fcondtop"],
        Tref=dg["Tref"], Qref=dg["Qref"], Uref=dg["Uref"],
        strength=strength_d, prs_sig=prs_sig_d, state_bad=state_bad,
        strintx=strintx_d, strinty=strinty_d,
        strtltx=strtltx_d, strtlty=strtlty_d,
        strcorx=strcorx_d, strcory=strcory_d,
        e11=e11_d, e12=e12_d, e22=e22_d,
        yieldstress11=ys11_d, yieldstress12=ys12_d, yieldstress22=ys22_d,
        albice=dg["albice"], albsno=dg["albsno"], albpnd=dg["albpnd"],
        dsnow=dg["dsnow"], fswint=dg["fswint"],
        daidtt=daidtt, dvidtt=dvidtt, daidtd=daidtd, dvidtd=dvidtd,
        dagedtt=dagedtt, dagedtd=dagedtd,
        faero_ocn=faero_ocn, flux_bio=flux_bio,
        PP_net=dg.get("PP_net", torch.zeros((ny, nx), **kw)),
        grow_net=dg.get("grow_net", torch.zeros((ny, nx), **kw)),
        opening=opening_d,
        niter_thermo=sc["niter_thermo"], niter_ridge=niter_ridge,
        drag=dg["drag"], rdgn=rdgn_d)
    return new_state, diag
