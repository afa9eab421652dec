"""History output: field registry, time-averaged accumulation, netCDF
writer (PyTorch port of ``cice5_tpu/io/history.py``).

ice_history_shared.F90 (registry `define_hist_field`/`accum_hist_field`
:559/:667, avail_hist_fields type :77-90, icefields_nml f_* flags) +
ice_history.F90 (init_hist :55, accum_hist :1149, up to 5 output streams
with independent frequencies) + the netCDF backend
io_netcdf/ice_history_write.F90.

The registry is a plain list of HistField descriptors; a stream
accumulates on the device, one stacked buffer per dims class, and copies
to the host only when it writes (``averages``), as classic netCDF-3 via
scipy with CF-style time/units/cell coordinates: the JAX package's files,
variable for variable, with the EAP, per-category mechred, form-drag,
pond, aerosol, brine and skeletal-BGC field sets of the configurations
that have them (the brine structure on the bio grid is the ``3Db``
class). ``HistoryStreams.write_ready`` accepts ``use_async`` as the JAX
package's does and writes the same files; the native asynchronous
netCDF writer is ``io/fastwriter.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.state import DEP_TRCR
from cice5_tpu_torch.utils import to_host as _host

FREQ_CODES = ("1", "h", "d", "m", "y")   # every step, hourly, daily, ...


@dataclass(frozen=True)
class HistField:
    name: str
    units: str
    long_name: str
    cell_measure: str = "area: tarea"
    scale: float = 1.0          # unit conversion on output (cmday etc.)
    instantaneous: bool = False
    # "2D" (ny,nx) | "3Dc" (ncat,ny,nx) | "3Db" (nblyr+2,ny,nx) |
    # "4Di" (nilyr,ncat,ny,nx) | "4Ds" (nslyr,ncat,ny,nx) — the a2D/a3Dc/
    # a3Db/a4Di/a4Ds accumulation classes of
    # ice_history_shared.F90:137-139,741,805
    dims: str = "2D"


# the standard field catalog (subset of the reference's 163 f_* flags;
# ice_history_shared.F90:186-358) — extended as physics lands
STANDARD_FIELDS = [
    HistField("aice", "1", "ice area  (aggregate)"),
    HistField("hi", "m", "grid cell mean ice thickness"),
    HistField("hs", "m", "grid cell mean snow thickness"),
    HistField("Tsfc", "C", "snow/ice surface temperature"),
    HistField("uvel", "m/s", "ice velocity (x)"),
    HistField("vvel", "m/s", "ice velocity (y)"),
    # flux pairs: the plain name is the per-ice-area flux (the post-
    # scale_fluxes view the reference accumulates, ice_flux.F90:840);
    # `*_ai` is weighted by ice area (what the full cell exchanges),
    # accum_hist_field(... fsens*workb) ice_history.F90:1411-1414
    HistField("fswabs", "W/m^2", "snow/ice/ocn absorbed solar flux"),
    HistField("fswabs_ai", "W/m^2", "snow/ice/ocn absorbed solar flux"
              " (*aice)"),
    HistField("fswint_ai", "W/m^2", "SW absorbed in ice interior (*aice)"),
    HistField("flwup", "W/m^2", "upward longwave flux"),
    HistField("flwup_ai", "W/m^2", "upward longwave flux (*aice)"),
    HistField("fsens", "W/m^2", "sensible heat flux"),
    HistField("fsens_ai", "W/m^2", "sensible heat flux (*aice)"),
    HistField("flat", "W/m^2", "latent heat flux"),
    HistField("flat_ai", "W/m^2", "latent heat flux (*aice)"),
    HistField("fhocn", "W/m^2", "heat flux ice to ocean"),
    HistField("fhocn_ai", "W/m^2", "heat flux ice to ocean (*aice)"),
    HistField("fresh", "kg/m^2/s", "freshwater flux ice to ocean"),
    HistField("fresh_ai", "kg/m^2/s", "freshwater flux ice to ocean"
              " (*aice)"),
    HistField("fsalt", "kg/m^2/s", "salt flux ice to ocean"),
    HistField("fsalt_ai", "kg/m^2/s", "salt flux ice to ocean (*aice)"),
    HistField("evap_ai", "kg/m^2/s", "evaporative water flux (*aice)"),
    HistField("fswthru_ai", "W/m^2", "SW through ice to ocean (*aice)"),
    HistField("fmeltt_ai", "W/m^2", "net surface-melt heat flux (*aice)"),
    HistField("snowfrac", "1", "radiation snow fraction (cell mean)"),
    HistField("meltt", "cm/day", "top ice melt", scale=ct.mps_to_cmpdy / 86400.0 * 86400.0),
    HistField("meltb", "cm/day", "basal ice melt"),
    HistField("meltl", "cm/day", "lateral ice melt"),
    HistField("congel", "cm/day", "congelation ice growth"),
    HistField("frazil", "cm/day", "frazil ice growth"),
    HistField("snoice", "cm/day", "snow-ice formation"),
    HistField("divu", "%/day", "strain rate (divergence)"),
    HistField("shear", "1/day", "strain rate (shear)"),
    HistField("strairx", "N/m^2", "atm/ice stress (x)"),
    HistField("strocnx", "N/m^2", "ocean/ice stress (x)"),
    HistField("dardg1dt", "1/s", "ice area ridging rate"),
    HistField("dardg2dt", "1/s", "ridge area formation rate"),
    HistField("dvirdgdt", "m/s", "ice volume ridging rate"),
    HistField("frzmlt", "W/m^2", "freeze/melt potential",
              instantaneous=True),
    HistField("sst", "C", "sea surface temperature", instantaneous=True),
    HistField("albsni", "1", "snow/ice broadband albedo"),
    HistField("evap", "kg/m^2/s", "evaporative water flux"),
    HistField("fswthru", "W/m^2", "SW through ice to ocean"),
    HistField("strairy", "N/m^2", "atm/ice stress (y)"),
    HistField("strocny", "N/m^2", "ocean/ice stress (y)"),
    HistField("alvdr", "1", "visible direct albedo"),
    HistField("alvdf", "1", "visible diffuse albedo"),
    HistField("alidr", "1", "near-IR direct albedo"),
    HistField("alidf", "1", "near-IR diffuse albedo"),
    HistField("fpond", "m/step", "meltwater flux into ponds"),
    HistField("Tair", "C", "air temperature", instantaneous=True),
    HistField("uatm", "m/s", "atm velocity (x)", instantaneous=True),
    HistField("vatm", "m/s", "atm velocity (y)", instantaneous=True),
    HistField("fswdn", "W/m^2", "downward solar flux", instantaneous=True),
    HistField("flwdn", "W/m^2", "downward longwave flux",
              instantaneous=True),
    HistField("snow", "kg/m^2/s", "snowfall rate", instantaneous=True),
    HistField("snow_ai", "kg/m^2/s", "snowfall rate (*aice)"),
    HistField("rain", "kg/m^2/s", "rainfall rate", instantaneous=True),
    HistField("rain_ai", "kg/m^2/s", "rainfall rate (*aice)"),
    HistField("sss", "ppt", "sea surface salinity", instantaneous=True),
    HistField("uocn", "m/s", "ocean current (x)", instantaneous=True),
    HistField("vocn", "m/s", "ocean current (y)", instantaneous=True),
    HistField("melts", "cm/day", "top snow melt"),
    HistField("fsurf_ai", "W/m^2", "net surface heat flux"),
    HistField("fcondtop_ai", "W/m^2", "top surface conductive heat flux"),
    HistField("Tref", "C", "2m reference air temperature"),
    HistField("Qref", "g/kg", "2m reference specific humidity"),
    HistField("Uref", "m/s", "10m reference wind speed"),
    HistField("strength", "N/m", "compressive ice strength",
              instantaneous=True),
    HistField("sig1", "1", "normalized principal stress component 1",
              instantaneous=True),
    HistField("sig2", "1", "normalized principal stress component 2",
              instantaneous=True),
    HistField("trsig", "N/m", "internal stress tensor trace",
              instantaneous=True),
    HistField("s11", "N/m", "internal stress tensor sigma_11",
              instantaneous=True),
    HistField("s12", "N/m", "internal stress tensor sigma_12",
              instantaneous=True),
    HistField("s22", "N/m", "internal stress tensor sigma_22",
              instantaneous=True),
    HistField("icepresent", "1", "fraction of time-avg interval with ice"),
    # albedo set (f_albice/f_albsno/f_albpnd + ai-weighted band albedos,
    # ice_history.F90:1395-1402)
    HistField("albice", "1", "bare ice albedo (broadband)"),
    HistField("albsno", "1", "snow albedo (broadband)"),
    HistField("albpnd", "1", "melt pond albedo (broadband)"),
    HistField("alvdr_ai", "1", "visible direct albedo (*aice, ice only)"),
    HistField("alvdf_ai", "1", "visible diffuse albedo (*aice, ice only)"),
    HistField("alidr_ai", "1", "near-IR direct albedo (*aice, ice only)"),
    HistField("alidf_ai", "1", "near-IR diffuse albedo (*aice, ice only)"),
    # radiation extras
    HistField("coszen", "radian", "cosine of the zenith angle",
              instantaneous=True),
    HistField("fswup", "W/m^2", "upward reflected solar flux"),
    HistField("fswfac", "1", "shortwave scaling factor",
              instantaneous=True),
    # instantaneous snapshots (f_aisnap/f_hisnap)
    HistField("aisnap", "1", "ice area snapshot", instantaneous=True),
    HistField("hisnap", "m", "ice volume snapshot", instantaneous=True),
    # internal-stress / tilt force terms (f_strintx.../f_strtltx...)
    HistField("strintx", "N/m^2", "internal ice stress divergence (x)"),
    HistField("strinty", "N/m^2", "internal ice stress divergence (y)"),
    HistField("strtltx", "N/m^2", "sea-surface tilt stress (x)"),
    HistField("strtlty", "N/m^2", "sea-surface tilt stress (y)"),
    HistField("strcorx", "N/m^2", "Coriolis stress (x)"),
    HistField("strcory", "N/m^2", "Coriolis stress (y)"),
    # state tendencies (f_daidtt/f_dvidtt/f_daidtd/f_dvidtd/f_dagedt*)
    HistField("daidtt", "%/day", "area tendency from thermodynamics"),
    HistField("dvidtt", "cm/day", "volume tendency from thermodynamics"),
    HistField("daidtd", "%/day", "area tendency from dynamics"),
    HistField("dvidtd", "cm/day", "volume tendency from dynamics"),
    HistField("dagedtt", "day/day", "age tendency from thermodynamics"),
    HistField("dagedtd", "day/day", "age tendency from dynamics"),
    HistField("dsnow", "cm/day", "snow depth change from thermo"),
    # season onset dates (f_mlt_onset/f_frz_onset; carried in State)
    HistField("mlt_onset", "day of year", "melt season onset date",
              instantaneous=True),
    HistField("frz_onset", "day of year", "freeze-up onset date",
              instantaneous=True),
]

# tracer-derived cell means (f_iage/f_FY/f_sice)
TRACER_MEAN_FIELDS = [
    HistField("iage", "years", "mean ice age"),
    HistField("FY", "1", "first-year ice area fraction"),
    HistField("sice", "ppt", "bulk ice salinity"),
]

# per-category fields (a3Dc class; f_aicen/f_vicen/... flags,
# ice_history_shared.F90:248-260 + pond/mechred category fields)
# EAP structure tensor + strain/yield tensors (f_a11/f_a12/f_e11/
# f_yieldstress11..., ice_history.F90 eap block)
EAP_FIELDS = [
    HistField("a11", "1", "structure tensor component a11",
              instantaneous=True),
    HistField("a12", "1", "structure tensor component a12",
              instantaneous=True),
    HistField("e11", "1/s", "strain-rate tensor component e11"),
    HistField("e12", "1/s", "strain-rate tensor component e12"),
    HistField("e22", "1/s", "strain-rate tensor component e22"),
    HistField("yieldstress11", "N/m", "yield stress tensor component 11"),
    HistField("yieldstress12", "N/m", "yield stress tensor component 12"),
    HistField("yieldstress22", "N/m", "yield stress tensor component 22"),
]

CAT_FIELDS = [
    HistField("aicen", "1", "ice area, categories", dims="3Dc"),
    HistField("vicen", "m", "ice volume, categories", dims="3Dc"),
    HistField("vsnon", "m", "snow volume, categories", dims="3Dc"),
    HistField("Tsfcn", "C", "surface temperature, categories", dims="3Dc"),
    HistField("fsurfn_ai", "W/m^2", "net surface heat flux, categories",
              dims="3Dc"),
    HistField("flatn_ai", "W/m^2", "latent heat flux, categories",
              dims="3Dc"),
    HistField("fcondtopn_ai", "W/m^2",
              "top conductive heat flux, categories", dims="3Dc"),
    HistField("fsensn_ai", "W/m^2", "sensible heat flux, categories",
              dims="3Dc"),
    HistField("fmelttn_ai", "W/m^2", "surface-melt heat flux, categories",
              dims="3Dc"),
    HistField("snowfracn", "1", "radiation snow fraction, categories",
              dims="3Dc"),
    HistField("apondn", "1", "melt pond fraction, categories", dims="3Dc"),
    HistField("hpondn", "m", "melt pond depth, categories", dims="3Dc"),
    HistField("ipondn", "m", "pond lid thickness, categories", dims="3Dc"),
    HistField("ardgn", "1", "ridged ice area fraction, categories",
              dims="3Dc"),
    HistField("vrdgn", "m", "ridged ice volume, categories", dims="3Dc"),
    # effective conductivity of the top ice layer (f_keffn_top; declared
    # in ice_flux.F90:235 — never filled in the 5.1.2 reference; here
    # derived as 2*k(T1,S1)/hilyr from the MU71 conductivity)
    HistField("keffn_top", "W/m^2/K",
              "effective top-layer thermal conductivity, categories",
              dims="3Dc"),
]

# vertical profile fields (a4Di/a4Ds classes; f_Tinz/f_Sinz/f_Tsnz,
# ice_history_shared.F90:350-358, accum_hist_field_4D :805)
VERT_FIELDS = [
    HistField("Tinz", "C", "ice internal temperatures", dims="4Di"),
    HistField("Sinz", "ppt", "ice internal bulk salinity", dims="4Di"),
    HistField("qinz", "J/m^3", "ice layer enthalpy", dims="4Di"),
    HistField("Tsnz", "C", "snow internal temperatures", dims="4Ds"),
]

# mechanical-redistribution field set (ice_history_mechred.F90)
MECHRED_FIELDS = [
    HistField("ardg", "1", "ridged ice area fraction"),
    HistField("vrdg", "m", "ridged ice volume per area"),
    HistField("alvl", "1", "level ice area fraction"),
    HistField("vlvl", "m", "level ice volume per area"),
    HistField("opening", "%/day", "lead opening rate"),
]

# melt-pond field set (ice_history_pond.F90: f_apond/f_apond_ai/
# f_hpond/.../f_apeff/f_apeffn; plain = per ice area, _ai = per cell)
POND_FIELDS = [
    HistField("apond", "1", "melt pond fraction of sea ice"),
    HistField("apond_ai", "1", "melt pond fraction of grid cell"),
    HistField("hpond", "m", "mean melt pond depth (per ice area)"),
    HistField("hpond_ai", "m", "mean melt pond depth (per cell)"),
    HistField("ipond", "m", "mean pond ice lid thickness (per ice area)"),
    HistField("ipond_ai", "m", "mean pond ice lid thickness (per cell)"),
    HistField("apeff", "1", "radiation-effective pond fraction of ice"),
    HistField("apeff_ai", "1", "radiation-effective pond fraction of cell"),
    HistField("apeffn", "1", "radiation-effective pond fraction, "
              "categories", dims="3Dc"),
]

# per-category mechanical-redistribution diagnostics (3Dc; with
# cfg.dyn.diag_mechred and the level-ice tracers: f_dardg1ndt ...
# f_vredistn, ice_history_mechred.F90), in driver.step.RDGN_KEYS order
MECHRED_CAT_FIELDS = [
    HistField("dardg1ndt", "1/s", "ridging area rate, categories",
              dims="3Dc"),
    HistField("dardg2ndt", "1/s", "ridge area formation rate, categories",
              dims="3Dc"),
    HistField("dvirdgndt", "m/s", "ridging volume rate, categories",
              dims="3Dc"),
    HistField("araftn", "1", "rafted ice area, categories", dims="3Dc"),
    HistField("vraftn", "m", "rafted ice volume, categories", dims="3Dc"),
    HistField("aparticn", "1", "ridging participation function, categories",
              dims="3Dc"),
    HistField("krdgn", "1", "mean ridge thickness over thickness of "
              "ridging ice, categories", dims="3Dc"),
    HistField("aredistn", "1", "ridge area redistribution function, "
              "categories", dims="3Dc"),
    HistField("vredistn", "m", "ridge volume redistribution function, "
              "categories", dims="3Dc"),
]

# form-drag field set (ice_history_drag.F90 f_drag/f_Cdn_atm/f_Cdn_ocn:
# total + skin/floe-edge/pond/ridge components and the sail/keel geometry)
DRAG_FIELDS = [
    HistField("Cdn_atm", "1", "atmospheric neutral drag coefficient",
              instantaneous=True),
    HistField("Cdn_ocn", "1", "oceanic neutral drag coefficient",
              instantaneous=True),
    HistField("Cdn_atm_skin", "1", "atm drag, skin component",
              instantaneous=True),
    HistField("Cdn_atm_floe", "1", "atm drag, floe-edge component",
              instantaneous=True),
    HistField("Cdn_atm_pond", "1", "atm drag, pond-edge component",
              instantaneous=True),
    HistField("Cdn_atm_rdg", "1", "atm drag, ridge component",
              instantaneous=True),
    HistField("Cdn_ocn_skin", "1", "ocean drag, skin component",
              instantaneous=True),
    HistField("Cdn_ocn_floe", "1", "ocean drag, floe-edge component",
              instantaneous=True),
    HistField("Cdn_ocn_keel", "1", "ocean drag, keel component",
              instantaneous=True),
    HistField("hfreebd", "m", "mean freeboard", instantaneous=True),
    HistField("hdraft", "m", "mean draft", instantaneous=True),
    HistField("hridge", "m", "mean ridge sail height", instantaneous=True),
    HistField("distrdg", "m", "mean ridge spacing", instantaneous=True),
    HistField("hkeel", "m", "mean keel depth", instantaneous=True),
    HistField("dkeel", "m", "mean keel spacing", instantaneous=True),
    HistField("lfloe", "m", "mean floe length", instantaneous=True),
    HistField("dfloe", "m", "mean floe spacing", instantaneous=True),
]

# BGC field set (ice_history_bgc.F90)
BGC_FIELDS = [
    HistField("PP_net", "mg C/m^2/s", "net primary production"),
    HistField("grow_net", "1/s", "net specific algal growth"),
    HistField("fbri", "1", "brine height ratio"),
    HistField("hbri", "m", "brine volume per grid area (f_hbri)"),
]

# brine vertical structure on the bio grid (nblyr+2 levels) — the a3Db
# accumulation class (ice_history_shared.F90:137-139; f_bTin/f_bphi,
# ice_history_bgc.F90)
BGC_3DB_FIELDS = [
    HistField("bTizn", "C", "ice internal temperature on the bio grid",
              dims="3Db"),
    HistField("bphizn", "1", "porosity on the bio grid", dims="3Db"),
]


def aero_fields(n_aero: int) -> list:
    """Aerosol history fields (ice_history_bgc.F90 f_faero_atm/f_faero_ocn
    /f_aero/f_aeron): per-species deposition + ocean fluxes, cell-mean
    mass concentrations in the 4 layers, and per-category (3Dc) snow/ice
    loads."""
    out = []
    for it in range(n_aero):
        s = f"{it + 1:03d}"
        out += [
            HistField(f"faero_atm{s}", "kg/m^2/s",
                      f"aerosol {it + 1} deposition rate",
                      instantaneous=True),
            HistField(f"faero_ocn{s}", "kg/m^2/s",
                      f"aerosol {it + 1} flux to ocean"),
            HistField(f"aerosnossl{s}", "kg/kg",
                      f"aerosol {it + 1} concentration, snow surface"),
            HistField(f"aerosnoint{s}", "kg/kg",
                      f"aerosol {it + 1} concentration, snow interior"),
            HistField(f"aeroicessl{s}", "kg/kg",
                      f"aerosol {it + 1} concentration, ice surface"),
            HistField(f"aeroiceint{s}", "kg/kg",
                      f"aerosol {it + 1} concentration, ice interior"),
            HistField(f"aerosnon{s}", "kg/m^2",
                      f"aerosol {it + 1} snow mass, categories",
                      dims="3Dc"),
            HistField(f"aeroicen{s}", "kg/m^2",
                      f"aerosol {it + 1} ice mass, categories",
                      dims="3Dc"),
        ]
    return out


# ocean-mixed-layer concentration fields per skl tracer (f_bgc_Nit_ml,
# f_bgc_Am_ml, f_bgc_Sil_ml, f_bgc_DMSP_ml, f_bgc_DMS_ml)
_ML_NAMES = {"NO": "Nit_ml", "NH": "Am_ml", "Sil": "Sil_ml",
             "DMSPd": "DMSP_ml", "DMS": "DMS_ml", "N": "N_ml"}
# ocean-flux fields per skl tracer (f_fNO/f_fNO_ai/f_fNH/.../f_fN/f_fSil)
_FLUX_NAMES = {"N": "fN", "NO": "fNO", "NH": "fNH", "Sil": "fSil"}


def skl_bgc_fields(bgc_names) -> list:
    """Skeletal-BGC history fields (ice_history_bgc.F90): skeletal-layer
    concentrations (f_bgc_*_sk), mixed-layer concentrations (f_bgc_*_ml),
    and ice-ocean fluxes (f_f* / f_f*_ai)."""
    out = []
    for nm in bgc_names:
        out.append(HistField(f"bgc_{nm}_sk", "mmol/m^3",
                             f"skeletal-layer {nm} concentration"))
        if nm in _ML_NAMES:
            out.append(HistField(f"bgc_{_ML_NAMES[nm]}", "mmol/m^3",
                                 f"mixed-layer {nm} concentration",
                                 instantaneous=True))
        if nm in _FLUX_NAMES:
            f = _FLUX_NAMES[nm]
            out.append(HistField(f, "mmol/m^2/s",
                                 f"{nm} flux ice to ocean"))
            out.append(HistField(f"{f}_ai", "mmol/m^2/s",
                                 f"{nm} flux ice to ocean (*aice)"))
    return out

MAX_NSTRM = 5     # ice_domain_size.F90:50

# f_* flags that select static grid/coordinate variables — these are
# written unconditionally by write_netcdf/write_coord_grid_vars, so the
# flags are recognized but expand to no accumulation field
# (ice_history_shared.F90:186-210 grid-variable block)
GRID_FLAGS = frozenset((
    "f_tmask", "f_blkmask", "f_tarea", "f_uarea", "f_dxt", "f_dyt",
    "f_dxu", "f_dyu", "f_HTN", "f_HTE", "f_ANGLE", "f_ANGLET",
    "f_bounds", "f_NCAT", "f_VGRDi", "f_VGRDs", "f_VGRDb"))

# flags whose catalog names differ from the f_ stem, or that expand to a
# field family (everything else maps by stripping the f_ prefix)
_FLAG_RENAME = {
    "f_PPnet": ("PP_net",), "f_grownet": ("grow_net",),
    "f_bTin": ("bTizn",), "f_bphi": ("bphizn",),
    "f_Cdn_atm": ("Cdn_atm", "Cdn_atm_skin", "Cdn_atm_floe",
                  "Cdn_atm_pond", "Cdn_atm_rdg"),
    "f_Cdn_ocn": ("Cdn_ocn", "Cdn_ocn_skin", "Cdn_ocn_floe",
                  "Cdn_ocn_keel"),
    "f_drag": ("hfreebd", "hdraft", "hridge", "distrdg", "hkeel",
               "dkeel", "lfloe", "dfloe"),
}


def fields_for_icefields(icefields: dict, cfg=None, tr=None) -> tuple:
    """Map parsed icefields_nml `f_*` selections (namelist.config_from_
    ice_in run_controls['icefields']) onto catalog HistFields.

    A flag is selected when its value is not 'x' (the reference's
    per-stream frequency letters, ice_history_shared.F90:186-358; 'md'
    etc. select streams — stream assignment is the caller's choice here).
    Returns (fields, unmapped): the selected HistField list from
    available_fields(cfg, tr) (catalog order, deduplicated), and any
    selected flags with no catalog backing for this configuration (e.g.
    f_bgc_* with skl_bgc off, f_aparticn without cfg.dyn.diag_mechred)."""
    # the namelist parser lowercases entry names and strips the f_
    # prefix; match case-insensitively against the catalog
    catalog = {f.name.lower(): f for f in available_fields(cfg, tr)}
    grid_lc = {g.lower() for g in GRID_FLAGS}
    rename_lc = {k.lower(): v for k, v in _FLAG_RENAME.items()}
    per_species = {"f_aero": ("aerosnossl{s}", "aerosnoint{s}",
                              "aeroicessl{s}", "aeroiceint{s}"),
                   "f_aeron": ("aerosnon{s}", "aeroicen{s}"),
                   "f_faero_atm": ("faero_atm{s}",),
                   "f_faero_ocn": ("faero_ocn{s}",)}
    na = tr.n_aero if tr is not None else 0
    want: list = []
    unmapped: list = []
    for flag, val in icefields.items():
        flag = flag.lower()
        if not flag.startswith("f_"):
            flag = "f_" + flag
        if isinstance(val, (list, tuple)):
            val = val[0] if val else "x"
        if str(val).strip().lower().strip("'\"") in ("x", ""):
            continue
        if flag in grid_lc:
            continue
        if flag in per_species:
            names = [t.format(s=f"{k + 1:03d}") for t in per_species[flag]
                     for k in range(na)]
        elif flag in rename_lc:
            names = list(rename_lc[flag])
        else:
            names = [flag[2:]]
        hit = [n.lower() for n in names if n.lower() in catalog]
        if hit:
            want.extend(hit)
        else:
            unmapped.append(flag)
    seen = set()
    fields = []
    for n in want:
        if n not in seen:
            seen.add(n)
            fields.append(catalog[n])
    return fields, unmapped


def available_fields(cfg=None, tr=None, include_3d=True) -> list:
    """The full field catalog available for a given configuration (the
    f_* availability filtering of init_hist, ice_history.F90:55-460)."""
    fields = list(STANDARD_FIELDS)
    has_pond = tr is not None and tr.nt_apnd >= 0
    has_lvl = tr is not None and tr.nt_alvl >= 0
    has_lid = tr is not None and tr.nt_ipnd >= 0
    if tr is not None:
        fields += [f for f in TRACER_MEAN_FIELDS
                   if (f.name != "iage" or tr.nt_iage >= 0)
                   and (f.name != "FY" or tr.nt_FY >= 0)]
    if cfg is not None and cfg.dyn.kdyn == 2:
        fields += EAP_FIELDS
    if has_lvl:
        fields += MECHRED_FIELDS
    if has_pond:
        fields += POND_FIELDS
    if tr is not None and tr.nt_fbri >= 0:
        fields += BGC_FIELDS
    if tr is not None and tr.nbtrcr:
        fields += skl_bgc_fields(tr.bgc_names)
    if include_3d and tr is not None:
        for f in CAT_FIELDS:
            if f.name in ("apondn", "hpondn") and not has_pond:
                continue
            if f.name == "ipondn" and not has_lid:
                continue
            if f.name in ("ardgn", "vrdgn") and not has_lvl:
                continue
            fields.append(f)
        fields += [f for f in VERT_FIELDS
                   if cfg is None or f.dims != "4Ds" or cfg.nslyr >= 1]
        if tr.nt_fbri >= 0:
            fields += BGC_3DB_FIELDS
    if tr is not None and tr.n_aero:
        fields += aero_fields(tr.n_aero)
    if cfg is not None and cfg.dyn.diag_mechred and has_lvl:
        fields += MECHRED_CAT_FIELDS
    if cfg is not None and cfg.forcing.formdrag:
        fields += [f for f in DRAG_FIELDS if f.name not in
                   {g.name for g in fields}]
    if not include_3d:
        fields = [f for f in fields if f.dims == "2D"]
    return fields


class HistoryStreams:
    """Up to MAX_NSTRM independent output streams with their own field sets
    and frequencies (ice_history.F90 multi-stream support): accum() feeds
    every stream; ready/write are per stream."""

    def __init__(self, streams):
        if len(streams) > MAX_NSTRM:
            raise ValueError(f"at most {MAX_NSTRM} history streams")
        self.streams = list(streams)

    def accum(self, values: dict, time: float):
        for st in self.streams:
            st.accum(values, time)

    def write_ready(self, grid, info, out_dir: str,
                    case_name: str = "cice5_tpu", use_async: bool = False):
        """Write every stream whose output window closed; returns paths.
        ``use_async`` is accepted as the JAX package's write_ready accepts
        it: the files are the same, written before this returns (the
        native asynchronous writer is ``io/fastwriter.py``)."""
        paths = []
        for st in self.streams:
            if st.ready(info):
                fn = os.path.join(
                    out_dir,
                    f"iceh_{st.suffix}.{info.year:04d}-{info.month:02d}-"
                    f"{info.mday:02d}-{info.sec:05d}.nc")
                write_netcdf(st, grid, info, fn, case_name=case_name)
                paths.append(fn)
        return paths


class HistoryStream:
    """One output stream: registered fields + accumulation + writer
    (the reference supports max_nstrm=5 of these).

    Fields of different accumulation classes (2D / 3Dc / 4Di / 4Ds,
    ice_history_shared.F90 a2D/a3Dc/a4Di/a4Ds buffers) are grouped into
    separate stacked buffers on the device of the values; ``accum`` reads
    nothing back to the host."""

    def __init__(self, fields: list[HistField], freq: str = "d",
                 freq_n: int = 1, suffix: str = "h"):
        if freq not in FREQ_CODES:
            raise ValueError(f"history freq {freq!r} not in {FREQ_CODES}")
        self.fields = list(fields)
        self.index = {f.name: k for k, f in enumerate(self.fields)}
        self.groups = {}                      # dims -> [HistField...]
        for f in self.fields:
            self.groups.setdefault(f.dims, []).append(f)
        self.freq = freq
        self.freq_n = freq_n
        self.suffix = suffix
        self.buf = {}                         # dims -> stacked buffer
        self._inst = {}                       # dims -> instantaneous mask
        self.nsamples = 0
        self.time0 = None

    def accum(self, values: dict, time: float):
        """Accumulate one step's fields (accum_hist, ice_history.F90:1149).
        values: name -> tensor of the field's dims class; missing 2D fields
        accumulate 0; missing 3D/4D fields are an error (register only
        fields the model produces)."""
        for dims, fl in self.groups.items():
            present = [f.name for f in fl if f.name in values]
            missing = [f.name for f in fl if f.name not in values]
            if missing:
                if dims != "2D" or not present:
                    raise KeyError(f"history {dims} fields not in values: "
                                   f"{missing}")
                tmpl = torch.zeros_like(torch.as_tensor(values[present[0]]))
            else:
                tmpl = None
            stack = torch.stack([
                torch.as_tensor(values[f.name]) if f.name in values else tmpl
                for f in fl])
            if self.buf.get(dims) is None:
                self.buf[dims] = stack
            else:
                inst = self._inst.get(dims)
                if inst is None or inst.device != stack.device:
                    # built once per stream: no host data per step
                    inst = self._inst[dims] = torch.tensor(
                        [f.instantaneous for f in fl],
                        device=stack.device).reshape(
                            (len(fl),) + (1,) * (stack.dim() - 1))
                self.buf[dims] = torch.where(inst, stack,
                                             self.buf[dims] + stack)
        if self.nsamples == 0:
            self.time0 = time
        self.nsamples += 1

    def ready(self, info) -> bool:
        """Is this an output step? (construct_filename/write logic)."""
        if self.nsamples == 0:
            return False
        if self.freq == "1":
            return self.nsamples >= self.freq_n
        if self.freq == "h":
            return info.sec % (3600 * self.freq_n) == 0
        if self.freq == "d":
            return info.sec == 0 and (info.elapsed_days % self.freq_n == 0)
        if self.freq == "m":
            return info.mday == 1 and info.sec == 0
        if self.freq == "y":
            return info.month == 1 and info.mday == 1 and info.sec == 0
        return False

    def averages(self, dims="2D"):
        """The time means of one dims class as a host NumPy array (the
        instantaneous fields as last accumulated): the one copy of the
        buffer to the host."""
        fl = self.groups.get(dims, [])
        if not fl:
            return None
        inst = np.asarray([f.instantaneous for f in fl])
        buf = _host(self.buf[dims])
        avg = buf / max(self.nsamples, 1)
        ishape = (len(fl),) + (1,) * (buf.ndim - 1)
        return np.where(inst.reshape(ishape), buf, avg)

    def reset(self):
        self.buf = {}
        self.nsamples = 0


def write_coord_grid_vars(f, grid):
    """Coordinate + static grid variables of a history file; keyed off
    the dimensions already created on ``f``.

    NCAT/VGRDi/VGRDs axis variables, T-cell corner bounds from the U
    points (gridbox_corners, ice_grid.F90:1972-2092; corner order NE, NW,
    SW, SE), and the f_tmask/f_tarea/f_uarea/f_dxt.../f_HTN/f_ANGLE grid
    block (ice_history_shared.F90:186-210 + io_netcdf writer)."""
    if "nc" in f.dimensions:
        ncv = f.createVariable("NCAT", "f", ("nc",))
        ncv.long_name = "category maximum thickness index"
        ncv[:] = np.arange(1, f.dimensions["nc"] + 1, dtype=np.float32)
    for dim, nm in (("nkice", "VGRDi"), ("nksnow", "VGRDs")):
        if dim in f.dimensions:
            vv = f.createVariable(nm, "f", (dim,))
            vv.long_name = "vertical level midpoints (fraction)"
            nk = f.dimensions[dim]
            vv[:] = ((np.arange(nk) + 0.5) / nk).astype(np.float32)
    f.createDimension("nvertices", 4)
    ulat = np.rad2deg(_host(grid.ULAT))
    ulon = np.rad2deg(_host(grid.ULON))
    for nm, u in (("latt_bounds", ulat), ("lont_bounds", ulon)):
        w = np.roll(u, 1, axis=1)                   # i-1 (cyclic ew)
        south = lambda a: np.concatenate(
            [2 * a[:1] - a[1:2], a[:-1]], axis=0)   # j-1, extrapolated
        corners = np.stack([u, w, south(w), south(u)])
        v = f.createVariable(nm, "f", ("nvertices", "nj", "ni"))
        v[:] = corners.astype(np.float32)
    for name, arr in (("TLAT", grid.TLAT), ("TLON", grid.TLON),
                      ("ULAT", grid.ULAT), ("ULON", grid.ULON),
                      ("tarea", grid.tarea), ("uarea", grid.uarea),
                      ("tmask", grid.hm), ("umask", grid.uvm),
                      ("dxt", grid.dxt), ("dyt", grid.dyt),
                      ("dxu", grid.dxu), ("dyu", grid.dyu),
                      ("HTN", grid.HTN), ("HTE", grid.HTE),
                      ("ANGLE", grid.ANGLE), ("ANGLET", grid.ANGLET)):
        v = f.createVariable(name, "f", ("nj", "ni"))
        v[:] = _host(arr).astype(np.float32)


def write_netcdf(stream: HistoryStream, grid, info, path: str,
                 case_name: str = "cice5_tpu"):
    """Write one history file as classic netCDF-3 via scipy (the
    io_netcdf/ice_history_write.F90 equivalent), incl. per-category (nc),
    vertical (nkice/nksnow) and bio-grid (nkbio) variables, and reset the
    stream."""
    from scipy.io import netcdf_file
    ny, nx = grid.hm.shape
    data = {dims: stream.averages(dims) for dims in stream.groups}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with netcdf_file(path, "w", version=2) as f:
        f.createDimension("time", None)
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        if "3Dc" in data or "4Di" in data or "4Ds" in data:
            ncat = next(d.shape[-3] for k, d in data.items()
                        if k in ("3Dc", "4Di", "4Ds"))
            f.createDimension("nc", ncat)
        if "4Di" in data:
            f.createDimension("nkice", data["4Di"].shape[1])
        if "4Ds" in data:
            f.createDimension("nksnow", data["4Ds"].shape[1])
        if "3Db" in data:
            f.createDimension("nkbio", data["3Db"].shape[1])
        tv = f.createVariable("time", "d", ("time",))
        tv.units = "days since 0001-01-01 00:00:00"
        tv[0] = info.time / 86400.0
        write_coord_grid_vars(f, grid)
        dimmap = {"2D": ("time", "nj", "ni"),
                  "3Dc": ("time", "nc", "nj", "ni"),
                  "3Db": ("time", "nkbio", "nj", "ni"),
                  "4Di": ("time", "nkice", "nc", "nj", "ni"),
                  "4Ds": ("time", "nksnow", "nc", "nj", "ni")}
        for dims, fl in stream.groups.items():
            arr = data[dims]
            for k, hf in enumerate(fl):
                v = f.createVariable(hf.name, "f", dimmap[dims])
                v.units = hf.units
                v.long_name = hf.long_name
                v[0] = (arr[k] * hf.scale).astype(np.float32)
        f.history = f"{case_name} history, nsamples={stream.nsamples}"
    stream.reset()
    return path


def diag_to_values(diag, state, grid, tr=None, forcing=None,
                   nilyr=None, nslyr=None) -> dict:
    """Map a StepDiag + state into the standard history field names
    (+ mechred/pond/category/vertical fields when the tracer registry is
    given, + forcing fields when forcing is given, + the form-drag fields
    when the diag holds their stack, + the per-category mechred fields
    under diag_mechred): the JAX package's keys and values. The state's
    a11n/a12n give a11/a12 and the step's EAP diagnostics the strain-rate
    and yield-stress tensors (zeros under EVP, as the JAX step fills
    them), with the aerosol, brine and skeletal-BGC fields of a
    configuration that carries those tracers. Elementwise tensor
    expressions: nothing is read back to the host."""
    aice = diag.aice
    has_ice = aice > ct.puny
    safe = torch.clamp(aice, min=ct.puny)

    def per_ice(x):
        """Per-ice-area view of an ai-merged flux — the post-scale_fluxes
        semantics the reference history accumulates for the plain flux
        names (ice_flux.F90:840 scale_fluxes; zero where no ice)."""
        return torch.where(has_ice, x / safe, 0.0)

    secday = 86400.0
    m_to_cmday = 100.0 * secday   # m/step already per-step; caller scales
    extra = {}
    if forcing is not None:
        fswdn = (forcing.swvdr + forcing.swvdf + forcing.swidr
                 + forcing.swidf)
        extra.update({
            "Tair": forcing.Tair - ct.Tffresh, "uatm": forcing.uatm,
            "vatm": forcing.vatm, "fswdn": fswdn,
            "flwdn": forcing.flw,
            "snow": forcing.fsnow, "snow_ai": forcing.fsnow * aice,
            "rain": forcing.frain, "rain_ai": forcing.frain * aice,
            "sss": forcing.sss,
            "uocn": forcing.uocn, "vocn": forcing.vocn,
            "coszen": forcing.coszen,
            # cell-mean reflected SW from the 4-band cell albedos
            "fswup": (forcing.swvdr * diag.alvdr
                      + forcing.swvdf * diag.alvdf
                      + forcing.swidr * diag.alidr
                      + forcing.swidf * diag.alidf)})
    stacks = {}
    if diag.drag.shape[0]:
        from cice5_tpu_torch.driver.step import DRAG_KEYS
        stacks.update({k: diag.drag[i] for i, k in enumerate(DRAG_KEYS)})
    if diag.rdgn.shape[0]:
        from cice5_tpu_torch.driver.step import RDGN_KEYS
        stacks.update({k: diag.rdgn[i] for i, k in enumerate(RDGN_KEYS)})
    eap = {"a11": state.a11n[0], "a12": state.a12n[0],
           "e11": diag.e11, "e12": diag.e12, "e22": diag.e22,
           "yieldstress11": diag.yieldstress11,
           "yieldstress12": diag.yieldstress12,
           "yieldstress22": diag.yieldstress22}
    return extra | eap | stacks | {
        "opening": diag.opening * secday * 100.0,
        "aice": aice, "hi": diag.vice, "hs": diag.vsno, "Tsfc": diag.Tsfc,
        "uvel": state.uvel, "vvel": state.vvel,
        "aisnap": aice, "hisnap": diag.vice,
        "fswabs": per_ice(diag.fswabs), "fswabs_ai": diag.fswabs,
        "fswint_ai": diag.fswint,
        "flwup": per_ice(diag.flwout), "flwup_ai": diag.flwout,
        "fsens": per_ice(diag.fsens), "fsens_ai": diag.fsens,
        "flat": per_ice(diag.flat), "flat_ai": diag.flat,
        "fhocn": per_ice(diag.fhocn), "fhocn_ai": diag.fhocn,
        "fresh": per_ice(diag.fresh), "fresh_ai": diag.fresh,
        "fsalt": per_ice(diag.fsalt), "fsalt_ai": diag.fsalt,
        "meltt": diag.meltt * m_to_cmday, "meltb": diag.meltb * m_to_cmday,
        "meltl": diag.meltl * m_to_cmday, "congel": diag.congel * m_to_cmday,
        "frazil": diag.frazil * m_to_cmday,
        "snoice": diag.snoice * m_to_cmday,
        "dsnow": diag.dsnow * m_to_cmday,
        "divu": diag.divu * secday * 100.0, "shear": diag.shear * secday,
        "strairx": diag.strairxT, "strocnx": state.strocnxT,
        "strintx": diag.strintx, "strinty": diag.strinty,
        "strtltx": diag.strtltx, "strtlty": diag.strtlty,
        "strcorx": diag.strcorx, "strcory": diag.strcory,
        "dardg1dt": diag.dardg1dt, "dardg2dt": diag.dardg2dt,
        "dvirdgdt": diag.dvirdgdt,
        "daidtt": diag.daidtt * secday * 100.0,
        "dvidtt": diag.dvidtt * m_to_cmday,
        "daidtd": diag.daidtd * secday * 100.0,
        "dvidtd": diag.dvidtd * m_to_cmday,
        "dagedtt": diag.dagedtt * secday, "dagedtd": diag.dagedtd * secday,
        "frzmlt": diag.frzmlt, "sst": state.sst,
        "albsni": (ct.awtvdr * diag.alvdr + ct.awtvdf * diag.alvdf
                   + ct.awtidr * diag.alidr + ct.awtidf * diag.alidf),
        "alvdr": diag.alvdr, "alvdf": diag.alvdf,
        "alidr": diag.alidr, "alidf": diag.alidf,
        # ice-only weighted band albedos (the reference's alvdr_ai etc.
        # exclude the open-water contribution, CICE_RunMod.F90
        # coupling_prep albedo block)
        "alvdr_ai": diag.alvdr - (1.0 - aice) * ct.albocn,
        "alvdf_ai": diag.alvdf - (1.0 - aice) * ct.albocn,
        "alidr_ai": diag.alidr - (1.0 - aice) * ct.albocn,
        "alidf_ai": diag.alidf - (1.0 - aice) * ct.albocn,
        "albice": diag.albice, "albsno": diag.albsno,
        "albpnd": diag.albpnd,
        "evap": per_ice(diag.evap), "evap_ai": diag.evap,
        "fswthru": per_ice(diag.fswthru), "fswthru_ai": diag.fswthru,
        "strairy": diag.strairyT, "strocny": state.strocnyT,
        "fpond": diag.fpond,
        "PP_net": diag.PP_net, "grow_net": diag.grow_net,
        "melts": diag.melts * m_to_cmday,
        "fsurf_ai": diag.fsurf, "fcondtop_ai": diag.fcondtop,
        "fmeltt_ai": diag.fmelttn_ai.sum(0),
        "snowfrac": (diag.snowfracn * state.aicen).sum(0),
        "fswfac": state.scale_factor,
        # Tref is the ai-weighted sum of Kelvin 2m temperatures
        # (sum aicen*Trefn); subtracting Tffresh*aice yields the
        # ai-weighted CELSIUS temperature without an aice<1 bias
        "Tref": diag.Tref - ct.Tffresh * aice,
        "Qref": diag.Qref * 1000.0,
        "Uref": diag.Uref,
        "strength": diag.strength,
        "icepresent": (aice > ct.puny).to(aice.dtype),
        "mlt_onset": state.mlt_onset, "frz_onset": state.frz_onset,
    } | _principal_stress(state, diag) | _tracer_values(state, tr) \
      | _category_values(diag, state, tr, nilyr, nslyr) \
      | _bgc_aero_values(diag, state, tr, forcing, nilyr)


def _principal_stress(state, diag) -> dict:
    """Normalized principal stresses + stress trace from the corner-1
    stress state (principal_stress, ice_dyn_shared.F90:611-659; f_sig1/
    f_sig2/f_trsig accumulation, ice_history.F90 dynamic-fields block)."""
    sp, sm, s12 = state.stressp[0], state.stressm[0], state.stress12[0]
    prs = diag.prs_sig
    root = torch.sqrt(sm * sm + 4.0 * s12 * s12)
    safe = torch.where(prs > ct.puny, prs, 1.0)
    ok = prs > ct.puny
    return {
        "sig1": torch.where(ok, 0.5 * (sp + root) / safe, 0.0),
        "sig2": torch.where(ok, 0.5 * (sp - root) / safe, 0.0),
        "trsig": 0.25 * state.stressp.sum(0),
        # stress tensor components from the corner-1 state
        # (f_s11/f_s12/f_s22: sig11 = (sigP+sigM)/2, sig22 = (sigP-sigM)/2)
        "s11": 0.5 * (sp + sm),
        "s22": 0.5 * (sp - sm),
        "s12": s12,
    }


def _category_values(diag, state, tr, nilyr, nslyr) -> dict:
    """Per-category (3Dc) and vertical-profile (4Di/4Ds) history values
    (the a3Dc/a4Di/a4Ds accumulation classes,
    ice_history_shared.F90:741,805)."""
    if tr is None or nilyr is None:
        return {}
    from cice5_tpu_torch.models.thermo import shared as thshared
    trcrn = state.trcrn
    out = {
        "aicen": state.aicen, "vicen": state.vicen, "vsnon": state.vsnon,
        "Tsfcn": trcrn[:, tr.nt_Tsfc],
        "fsurfn_ai": diag.fsurfn_ai, "flatn_ai": diag.flatn_ai,
        "fcondtopn_ai": diag.fcondtopn_ai, "fsensn_ai": diag.fsensn_ai,
        "fmelttn_ai": diag.fmelttn_ai, "snowfracn": diag.snowfracn,
    }
    # vertical profiles: (ncat, nk, ny, nx) -> (nk, ncat, ny, nx)
    zqin = trcrn[:, tr.nt_qice:tr.nt_qice + nilyr]
    zSin = trcrn[:, tr.nt_sice:tr.nt_sice + nilyr]
    Tmlt = -zSin * ct.depressT
    out["Tinz"] = thshared.calculate_Tin_from_qin(zqin, Tmlt).movedim(1, 0)
    out["Sinz"] = zSin.movedim(1, 0)
    out["qinz"] = zqin.movedim(1, 0)
    if nslyr is not None:
        zqsn = trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr]
        out["Tsnz"] = thshared.snow_temperature(zqsn).movedim(1, 0)
    if tr.nt_apnd >= 0:
        out["apondn"] = trcrn[:, tr.nt_apnd] * state.aicen
        out["hpondn"] = trcrn[:, tr.nt_hpnd]
        if tr.nt_ipnd >= 0:
            out["ipondn"] = trcrn[:, tr.nt_ipnd]
    if tr.nt_alvl >= 0:
        out["ardgn"] = (1.0 - trcrn[:, tr.nt_alvl]) * state.aicen
        out["vrdgn"] = (1.0 - trcrn[:, tr.nt_vlvl]) * state.vicen
    # effective top-layer conductivity (f_keffn_top; the ice_flux.F90:235
    # array — never filled in the 5.1.2 reference — here derived from the
    # MU71 conductivity k = 2.03 + 0.13*S1/T1 of the top ice layer:
    # keff = k/(hilyr/2), the surface<->layer-1-midpoint conductance)
    hin = torch.where(state.aicen > ct.puny,
                      state.vicen / torch.clamp(state.aicen, min=ct.puny),
                      0.0)
    S1 = trcrn[:, tr.nt_sice]
    T1 = thshared.calculate_Tin_from_qin(trcrn[:, tr.nt_qice],
                                         -S1 * ct.depressT)
    kice = 2.03 + 0.13 * S1 / torch.clamp(T1, max=-ct.puny)
    out["keffn_top"] = torch.where(
        state.aicen > ct.puny,
        2.0 * torch.clamp(kice, min=0.0) * nilyr
        / torch.clamp(hin, min=ct.puny), 0.0)
    return out


def _tracer_values(state, tr) -> dict:
    if tr is None:
        return {}
    out = {}
    aicen, vicen = state.aicen, state.vicen
    aice = aicen.sum(0)
    vice = vicen.sum(0)
    year_sec = 86400.0 * 365.0
    if tr.nt_iage >= 0:
        out["iage"] = (aicen * state.trcrn[:, tr.nt_iage]).sum(0) \
            / torch.clamp(aice, min=ct.puny) / year_sec
    if tr.nt_FY >= 0:
        out["FY"] = (aicen * state.trcrn[:, tr.nt_FY]).sum(0)
    # bulk ice salinity (f_sice): layer-mean salinity, volume-weighted;
    # the registry lays slots out as [Tsfc | qice | sice | qsno], so
    # nilyr = nt_sice - nt_qice
    nil = tr.nt_sice - tr.nt_qice
    sal_mean = state.trcrn[:, tr.nt_sice:tr.nt_sice + nil].mean(1)
    out["sice"] = (sal_mean * vicen).sum(0) / torch.clamp(vice, min=ct.puny)
    if tr.nt_alvl >= 0:
        out["alvl"] = (state.trcrn[:, tr.nt_alvl] * aicen).sum(0)
        out["vlvl"] = (state.trcrn[:, tr.nt_vlvl] * vicen).sum(0)
        out["ardg"] = ((1.0 - state.trcrn[:, tr.nt_alvl]) * aicen).sum(0)
        out["vrdg"] = ((1.0 - state.trcrn[:, tr.nt_vlvl]) * vicen).sum(0)
    if tr.nt_apnd >= 0:
        # per-category pond fraction of category area: apnd (cesm/topo)
        # or apnd*alvl (level-ice ponds, where apnd is a fraction of the
        # level-ice area — inferred from the registry dependency chain)
        ap = state.trcrn[:, tr.nt_apnd]
        if tr.nt_alvl >= 0 and \
                tr.depend[tr.nt_apnd] == DEP_TRCR + tr.nt_alvl:
            ap = ap * state.trcrn[:, tr.nt_alvl]
        safe_ai = torch.clamp(aice, min=ct.puny)
        out["apond_ai"] = (ap * aicen).sum(0)
        out["apond"] = out["apond_ai"] / safe_ai
        out["hpond_ai"] = (ap * state.trcrn[:, tr.nt_hpnd] * aicen).sum(0)
        out["hpond"] = out["hpond_ai"] / safe_ai
        # radiation-effective pond fraction (f_apeff/f_apeffn): ponds
        # under a frozen lid do not darken the surface (run_dEdd pond
        # setup, ice_shortwave.F90:1300-1420; lid gate approximated as
        # ipnd <= puny)
        apeffn = ap
        if tr.nt_ipnd >= 0:
            out["ipond_ai"] = (ap * state.trcrn[:, tr.nt_ipnd]
                               * aicen).sum(0)
            out["ipond"] = out["ipond_ai"] / safe_ai
            apeffn = ap * (state.trcrn[:, tr.nt_ipnd]
                           <= ct.puny).to(ap.dtype)
        out["apeff_ai"] = (apeffn * aicen).sum(0)
        out["apeff"] = out["apeff_ai"] / safe_ai
        out["apeffn"] = apeffn
    if tr.nt_fbri >= 0:
        # volume-weighted mean brine ratio (the brine volume is f_hbri)
        out["fbri"] = (state.trcrn[:, tr.nt_fbri] * vicen).sum(0) \
            / torch.clamp(vice, min=ct.puny)
    return out


def _bgc_aero_values(diag, state, tr, forcing, nilyr) -> dict:
    """Aerosol / skeletal-BGC / brine-structure history values
    (ice_history_bgc.F90 accumulation blocks: f_faero_atm/f_faero_ocn/
    f_aero/f_aeron, f_bgc_*_sk/_ml, f_f*/_ai, f_bTin/f_bphi, f_hbri)."""
    if tr is None:
        return {}
    out = {}
    aicen, vicen, vsnon = state.aicen, state.vicen, state.vsnon
    trcrn = state.trcrn
    aice = aicen.sum(0)
    has_ice = aice > ct.puny
    safe_a = torch.clamp(aice, min=ct.puny)
    kw = dict(dtype=aice.dtype, device=aice.device)

    if tr.n_aero:
        from cice5_tpu_torch.models.tracers.aerosol import faero_default
        fa = forcing.faero_atm if (forcing is not None
                                   and forcing.faero_atm is not None) \
            else faero_default(tr.n_aero, aice.shape, **kw)
        sno_safe = torch.clamp(vsnon.sum(0), min=ct.puny)
        ice_safe = torch.clamp(vicen.sum(0), min=ct.puny)
        for it in range(tr.n_aero):
            s = f"{it + 1:03d}"
            a0 = tr.nt_aero + 4 * it
            out[f"faero_atm{s}"] = fa[it]
            out[f"faero_ocn{s}"] = diag.faero_ocn[it]
            # mass concentrations (kg aerosol / kg medium), cell means
            out[f"aerosnossl{s}"] = (vsnon * trcrn[:, a0]).sum(0) \
                / sno_safe / ct.rhos
            out[f"aerosnoint{s}"] = (vsnon * trcrn[:, a0 + 1]).sum(0) \
                / sno_safe / ct.rhos
            out[f"aeroicessl{s}"] = (vicen * trcrn[:, a0 + 2]).sum(0) \
                / ice_safe / ct.rhoi
            out[f"aeroiceint{s}"] = (vicen * trcrn[:, a0 + 3]).sum(0) \
                / ice_safe / ct.rhoi
            # per-category loads (f_aeron)
            out[f"aerosnon{s}"] = vsnon * (trcrn[:, a0] + trcrn[:, a0 + 1])
            out[f"aeroicen{s}"] = vicen * (trcrn[:, a0 + 2]
                                           + trcrn[:, a0 + 3])

    if tr.nbtrcr:
        from cice5_tpu_torch.models.tracers.algae import default_ocean_bio
        from cice5_tpu_torch.models.tracers.brine import SK_L
        ob = forcing.ocean_bio if (forcing is not None
                                   and forcing.ocean_bio is not None) \
            else default_ocean_bio(tr, aice.shape, **kw)
        for k, nm in enumerate(tr.bgc_names):
            out[f"bgc_{nm}_sk"] = (aicen * trcrn[:, tr.nt_bgc[k]]).sum(0) \
                / safe_a / SK_L
            if nm in _ML_NAMES:
                out[f"bgc_{_ML_NAMES[nm]}"] = ob[k]
            if nm in _FLUX_NAMES:
                f = _FLUX_NAMES[nm]
                fb = diag.flux_bio[k]
                out[f"{f}_ai"] = fb
                out[f] = torch.where(has_ice, fb / safe_a, 0.0)

    if tr.nt_fbri >= 0:
        out["hbri"] = (trcrn[:, tr.nt_fbri] * vicen).sum(0)
        if nilyr is not None and forcing is not None:
            # brine vertical structure on the bio grid (f_bTin/f_bphi):
            # the per-category microstructure, area-weighted to a
            # (nblyr+2, ny, nx) profile (a3Db class)
            from cice5_tpu_torch.models.tracers import brine
            hin = torch.where(aicen > ct.puny,
                              vicen / torch.clamp(aicen, min=ct.puny), 0.0)
            ms = brine.compute_microS_mushy(
                trcrn[:, tr.nt_sice:tr.nt_sice + nilyr].movedim(1, -1),
                trcrn[:, tr.nt_qice:tr.nt_qice + nilyr].movedim(1, -1),
                hin, trcrn[:, tr.nt_fbri] * hin,
                forcing.sss.expand_as(aicen), state.sst.expand_as(aicen),
                nblyr=nilyr)
            w = aicen[..., None]
            wsum = torch.clamp(w.sum(0), min=ct.puny)
            out["bTizn"] = ((ms.bTin * w).sum(0) / wsum).movedim(-1, 0)
            out["bphizn"] = ((ms.bphin * w).sum(0) / wsum).movedim(-1, 0)
    return out
