"""Fortran-namelist (`ice_in`) ingestion (a copy of
``cice5_tpu/namelist.py`` that builds the port's ModelConfig).

The reference is configured entirely through the Fortran namelist file
`ice_in` (9 groups read in source/ice_init.F90:135-199,
domain_nml in ice_domain.F90:109-118, icefields_nml in
ice_history_shared.F90:35; exemplars at input_templates/{col,gx3,gx1,tp1}/
ice_in). A user switching from the reference keeps their ice_in:
``config_from_ice_in(path, nx=..., ny=...)`` parses it and builds the
equivalent :class:`~cice5_tpu_torch.config.ModelConfig` plus a run-control
dict (output dirs/frequencies, restart pointers, diagnostic points, forcing
dataset locations, f_* history selections) for the driver layer.

nx/ny are arguments because the reference fixes them at COMPILE time
(NXGLOB/NYGLOB CPP macros, ice_domain_size.F90:23-37, bld/build.sh:100-121)
— they never appear in ice_in.
"""
from __future__ import annotations

import re

from cice5_tpu_torch.config import (DynConfig, ForcingConfig, GridConfig,
                                    ModelConfig, ShortwaveConfig,
                                    ThermoConfig, TimeConfig, TracerConfig)

# ----------------------------------------------------------------------
# parser
# ----------------------------------------------------------------------

_TOK = re.compile(
    r"""'(?:[^']*)'|"(?:[^"]*)"|\.true\.|\.false\.|[^\s,]+""",
    re.IGNORECASE)


def _coerce(tok: str):
    t = tok.strip()
    low = t.lower()
    if low == ".true.":
        return True
    if low == ".false.":
        return False
    if (t.startswith("'") and t.endswith("'")) or \
       (t.startswith('"') and t.endswith('"')):
        return t[1:-1]
    try:
        return int(t)
    except ValueError:
        pass
    try:
        # Fortran exponents: 1.e-3, 5.0e-4, 1.d-11
        return float(low.replace("d", "e"))
    except ValueError:
        return t


def parse_namelist(path: str) -> dict[str, dict]:
    """Parse a Fortran namelist file into {group: {name: value}}.

    Handles .true./.false., quoted strings, Fortran float spellings
    (`17.`, `1.e-3`, `1.d-11`), per-entry arrays (`histfreq = 'm','x'`
    become lists), indexed entries (`latpnt(1) = 90.` collect into a
    list under 'latpnt'), leading-comma continuation style, and `!`
    comments — the ice_in grammar (ice_init.F90:152-166 read pattern).
    """
    groups: dict[str, dict] = {}
    cur: dict | None = None
    pending: str | None = None      # name awaiting (more) values
    with open(path) as f:
        lines = f.readlines()
    for raw in lines:
        line = raw.split("!", 1)[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            cur = groups.setdefault(line[1:].strip().lower(), {})
            pending = None
            continue
        if line.startswith("/"):
            cur = None
            pending = None
            continue
        if cur is None:
            continue
        # split into `name = values` segments; a line may carry several
        for seg in _split_assignments(line):
            name, vals = seg
            if name is None:        # continuation values for `pending`
                if pending is not None:
                    _store(cur, pending, vals, append=True)
                continue
            pending = name
            _store(cur, name, vals)
    return groups


def _split_assignments(line: str):
    """Yield (name | None, [values]) for each assignment on the line."""
    line = line.lstrip(",").strip()
    parts = re.split(r"(\b[A-Za-z_]\w*(?:\(\d+\))?\s*=)", line)
    # parts: [prefix, 'name =', tail, 'name2 =', tail2, ...]
    if parts[0].strip():
        toks = [_coerce(t) for t in _TOK.findall(parts[0])]
        if toks:
            yield None, toks
    for k in range(1, len(parts), 2):
        name = parts[k].rstrip("=").strip()
        tail = parts[k + 1] if k + 1 < len(parts) else ""
        toks = [_coerce(t) for t in _TOK.findall(tail)]
        yield name, toks


def _store(group: dict, name: str, vals: list, append: bool = False):
    m = re.match(r"(\w+)\((\d+)\)$", name)
    if m:                           # indexed: latpnt(1) = ...
        base = m.group(1).lower()
        idx = int(m.group(2)) - 1
        lst = group.setdefault(base, [])
        while len(lst) <= idx:
            lst.append(None)
        if vals:
            lst[idx] = vals[0] if len(vals) == 1 else vals
        return
    key = name.lower()
    if append and key in group:
        old = group[key]
        group[key] = (old if isinstance(old, list) else [old]) + vals
        return
    if not vals:
        return
    group[key] = vals[0] if len(vals) == 1 else vals


# ----------------------------------------------------------------------
# mapping ice_in -> ModelConfig
# ----------------------------------------------------------------------

# namelist name -> (config sub-dataclass attr, field name) for the direct
# one-to-one entries; None attr = top-level ModelConfig field
_DIRECT = {
    # setup_nml -> TimeConfig
    "dt": ("time", "dt"), "npt": ("time", "npt"), "ndtd": ("time", "ndtd"),
    "year_init": ("time", "year_init"), "istep0": ("time", "istep0"),
    "days_per_year": ("time", "days_per_year"),
    "use_leap_years": ("time", "use_leap_years"),
    # grid_nml
    "grid_format": ("grid", "grid_format"),
    "grid_type": ("grid", "grid_type"),
    "grid_file": ("grid", "grid_file"), "kmt_file": ("grid", "kmt_file"),
    "kcatbound": (None, "kcatbound"),
    # domain_nml
    "ew_boundary_type": ("grid", "ew_boundary"),
    "ns_boundary_type": ("grid", "ns_boundary"),
    # tracer_nml / zbgc_nml
    "tr_iage": ("tracers", "tr_iage"), "tr_fy": ("tracers", "tr_FY"),
    "tr_lvl": ("tracers", "tr_lvl"),
    "tr_pond_cesm": ("tracers", "tr_pond_cesm"),
    "tr_pond_lvl": ("tracers", "tr_pond_lvl"),
    "tr_pond_topo": ("tracers", "tr_pond_topo"),
    "tr_aero": ("tracers", "tr_aero"),
    "tr_brine": ("tracers", "tr_brine"),
    "skl_bgc": ("tracers", "skl_bgc"),
    "bgc_flux_type": ("tracers", "bgc_flux_type"),
    "tr_bgc_c_sk": ("tracers", "tr_bgc_C_sk"),
    "tr_bgc_chl_sk": ("tracers", "tr_bgc_chl_sk"),
    "tr_bgc_am_sk": ("tracers", "tr_bgc_Am_sk"),
    "tr_bgc_sil_sk": ("tracers", "tr_bgc_Sil_sk"),
    "tr_bgc_dmspp_sk": ("tracers", "tr_bgc_DMSPp_sk"),
    "tr_bgc_dmspd_sk": ("tracers", "tr_bgc_DMSPd_sk"),
    "tr_bgc_dms_sk": ("tracers", "tr_bgc_DMS_sk"),
    # thermo_nml
    "kitd": (None, "kitd"), "ktherm": ("thermo", "ktherm"),
    "conduct": ("thermo", "conduct"),
    "dsdt_slow_mode": ("thermo", "dSdt_slow_mode"),
    "a_rapid_mode": ("thermo", "a_rapid_mode"),
    "rac_rapid_mode": ("thermo", "Rac_rapid_mode"),
    "aspect_rapid_mode": ("thermo", "aspect_rapid_mode"),
    "phi_c_slow_mode": ("thermo", "phi_c_slow_mode"),
    "phi_i_mushy": ("thermo", "phi_i_mushy"),
    # dynamics_nml
    "kdyn": ("dyn", "kdyn"), "ndte": ("dyn", "ndte"),
    "revised_evp": ("dyn", "revised_evp"),
    "advection": ("dyn", "advection"),
    "kstrength": ("dyn", "kstrength"),
    "krdg_partic": ("dyn", "krdg_partic"),
    "krdg_redist": ("dyn", "krdg_redist"),
    "mu_rdg": ("dyn", "mu_rdg"), "cf": ("dyn", "Cf"),
    # shortwave_nml
    "albicev": ("shortwave", "albicev"),
    "albicei": ("shortwave", "albicei"),
    "albsnowv": ("shortwave", "albsnowv"),
    "albsnowi": ("shortwave", "albsnowi"),
    "ahmax": ("shortwave", "ahmax"),
    "r_ice": ("shortwave", "R_ice"), "r_pnd": ("shortwave", "R_pnd"),
    "r_snw": ("shortwave", "R_snw"), "dt_mlt": ("shortwave", "dT_mlt"),
    "rsnw_mlt": ("shortwave", "rsnw_mlt"), "kalg": ("shortwave", "kalg"),
    # ponds_nml
    "hp1": ("tracers", "hp1"), "hs0": ("tracers", "hs0"),
    "hs1": ("tracers", "hs1"), "dpscale": ("tracers", "dpscale"),
    "frzpnd": ("tracers", "frzpnd"),
    "rfracmin": ("tracers", "rfracmin"),
    "rfracmax": ("tracers", "rfracmax"),
    "pndaspect": ("tracers", "pndaspect"),
    # forcing_nml
    "formdrag": ("forcing", "formdrag"),
    "atmbndy": ("forcing", "atmbndy"),
    "highfreq": ("forcing", "highfreq"),
    "natmiter": ("forcing", "natmiter"),
    "calc_strair": ("forcing", "calc_strair"),
    "precip_units": ("forcing", "precip_units"),
    "update_ocn_f": ("forcing", "update_ocn_f"),
    "l_mpond_fresh": ("forcing", "l_mpond_fresh"),
    "oceanmixed_ice": ("forcing", "oceanmixed_ice"),
    "restore_sst": ("forcing", "restore_sst"),
    "restore_ice": ("forcing", "restore_ice"),
    "trestore": ("forcing", "trestore"),
    "atm_data_type": ("forcing", "atm_data_type"),
    "calc_tsfc": ("thermo", "calc_Tsfc"),
    "ustar_min": ("thermo", "ustar_min"),
    "fbot_xfer_type": ("thermo", "fbot_xfer_type"),
}

# entries that configure the RUN (drivers/IO), not the jitted model step —
# passed through in the run-control dict
_RUN_KEYS = {
    "runtype", "ice_ic", "restart", "restart_ext", "use_restart_time",
    "restart_format", "lcdf64", "restart_dir", "restart_file",
    "pointer_file", "dumpfreq", "dumpfreq_n", "dump_last", "bfbflag",
    "diagfreq", "diag_type", "diag_file", "print_global", "print_points",
    "latpnt", "lonpnt", "dbug", "histfreq", "histfreq_n", "hist_avg",
    "history_dir", "history_file", "write_ic", "incond_dir", "incond_file",
    "nprocs", "processor_shape", "distribution_type", "distribution_wght",
    "maskhalo_dyn", "maskhalo_remap", "maskhalo_bound", "gridcpl_file",
    "fyear_init", "ycycle", "atm_data_format", "atm_data_dir",
    "ocn_data_format", "sss_data_type", "sst_data_type", "ocn_data_dir",
    "oceanmixed_file", "bgc_data_dir", "sil_data_type", "nit_data_type",
    "restore_bgc", "restart_age", "restart_fy", "restart_lvl",
    "restart_pond_cesm", "restart_pond_lvl", "restart_pond_topo",
    "restart_aero", "restart_hbrine", "restart_bgc", "tfrz_option",
    "ocn_data_type",
}

# accepted but intentionally without a ModelConfig home (documented
# unsupported/no-op options — e.g. mushy rapid-mode drainage constants the
# solver fixes at reference defaults, ice_therm_mushy.F90:67-80)
_KNOWN_UNMAPPED = {"albedo_type", "shortwave", "atmbndy", "phi_snow",
                   "n_aero"}


def config_from_ice_in(path: str, *, nx: int, ny: int,
                       strict: bool = False, **overrides):
    """Build (ModelConfig, run_controls) from a reference `ice_in` file.

    run_controls carries the driver-level entries (restart/history dirs &
    frequencies, diagnostic points, forcing dataset paths, f_* history
    selections under 'icefields') plus 'unmapped': any entry this
    framework has no equivalent for (strict=True raises instead — the
    honest-config contract: nothing is silently dropped).
    """
    g = parse_namelist(path)
    sub: dict[str, dict] = {"grid": {}, "thermo": {}, "dyn": {},
                            "shortwave": {}, "tracers": {}, "forcing": {},
                            "time": {}}
    top: dict = {}
    run: dict = {}
    unmapped: dict = {}

    for group, entries in g.items():
        # icefields_nml + the per-module icefields_{mechred,pond,bgc,
        # drag}_nml groups (ice_history_{mechred,pond,bgc,drag}.F90)
        if group.startswith("icefields"):
            run.setdefault("icefields", {}).update(
                {k[2:]: v for k, v in entries.items()
                 if k.startswith("f_")})
            continue
        for key, val in entries.items():
            if key in _DIRECT:
                attr, fld = _DIRECT[key]
                if attr is None:
                    top[fld] = val
                else:
                    sub[attr][fld] = val
            elif key == "shortwave":
                sub["shortwave"]["shortwave"] = \
                    "dEdd" if str(val) == "dEdd" else "ccsm3"
            elif key == "albedo_type":
                sub["shortwave"]["albedo_type"] = \
                    "constant" if val == "constant" else "ccsm3"
            elif key in _RUN_KEYS:
                run[key] = val
            elif key in _KNOWN_UNMAPPED:
                unmapped[key] = val
            else:
                unmapped[key] = val
    if unmapped and strict:
        raise ValueError(f"ice_in entries without an equivalent: "
                         f"{sorted(unmapped)}")
    run["unmapped"] = unmapped

    # tfrz_option='mushy' etc. rides in run controls; the thermo scheme
    # already implies the freezing-point formulation (ktherm=2 -> mushy
    # liquidus, ice_therm_shared.F90).
    cfg = ModelConfig(
        grid=GridConfig(nx=nx, ny=ny, **sub["grid"]),
        thermo=ThermoConfig(**sub["thermo"]),
        dyn=DynConfig(**{k: (float(v) if k in ("mu_rdg", "Cf") else v)
                         for k, v in sub["dyn"].items()}),
        shortwave=ShortwaveConfig(**{k: (float(v) if isinstance(v, int)
                                         and k[0] in "Rdar" else v)
                                     for k, v in sub["shortwave"].items()}),
        tracers=TracerConfig(**{k: (float(v) if isinstance(v, int)
                                    and k in ("hs0", "hs1", "hp1",
                                              "dpscale", "rfracmin",
                                              "rfracmax", "pndaspect")
                                    else v)
                                for k, v in sub["tracers"].items()}),
        forcing=ForcingConfig(**sub["forcing"]),
        time=TimeConfig(**{k: (float(v) if k == "dt" else v)
                           for k, v in sub["time"].items()}),
        **top,
    )
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg, run
