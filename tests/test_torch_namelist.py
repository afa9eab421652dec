"""The port's ``ice_in`` reader (``cice5_tpu_torch/namelist.py``) against
the JAX package's (``cice5_tpu/namelist.py``) on namelist text this test
writes (the reference's input templates are not in the repository): the
parsed groups, the ModelConfig (``dataclasses.asdict``) and the
run-control dict (``unmapped`` included) equal; ``strict`` raises in both;
options outside the port's ``check_supported`` parse and raise only when
a Model is built; a tripole namelist with the gx1-parity physics builds
the port's Model, which steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.io.history import fields_for_icefields
from cice5_tpu_torch.namelist import config_from_ice_in, parse_namelist
from cice5_tpu_torch.state import build_tracer_registry
import torch_port_util as U

from cice5_tpu import namelist as jnamelist
from cice5_tpu.io.history import fields_for_icefields as jfields_for
from cice5_tpu.state import build_tracer_registry as jbuild

# the groups and spellings of a CICE 5 ice_in (setup, grid, domain,
# tracer, thermo, dynamics, shortwave, ponds, zbgc, forcing and the
# icefields groups), with a tripole grid and the gx1-parity physics
TRIPOLE_ICE_IN = """\
&setup_nml
    days_per_year  = 365
  , use_leap_years = .false.
  , year_init      = 1997
  , istep0         = 0
  , dt             = 3600.0
  , npt            = 8760
  , ndtd           = 1
  , runtype        = 'initial'
  , ice_ic         = 'default'
  , restart        = .false.
  , restart_ext    = .false.
  , use_restart_time = .true.
  , restart_format = 'nc'
  , lcdf64         = .false.
  , restart_dir    = './restart/'
  , restart_file   = 'iced'
  , pointer_file   = './restart/ice.restart_file'
  , dumpfreq       = 'm'
  , dumpfreq_n     = 1
  , dump_last      = .false.
  , bfbflag        = .false.
  , diagfreq       = 24
  , diag_type      = 'stdout'
  , diag_file      = 'ice_diag.d'
  , print_global   = .true.
  , print_points   = .true.
  , latpnt(1)      =  90.
  , lonpnt(1)      =   0.
  , latpnt(2)      = -65.
  , lonpnt(2)      = -45.
  , dbug           = .false.
  , histfreq       = 'm','x','x','x','x'
  , histfreq_n     =  1 , 1 , 1 , 1 , 1
  , hist_avg       = .true.
  , history_dir    = './history/'
  , history_file   = 'iceh'
  , write_ic       = .true.
  , incond_dir     = './history/'
  , incond_file    = 'iceh_ic'
/

&grid_nml
    grid_format  = 'bin'
  , grid_type    = 'tripole'
  , grid_file    = 'grid'
  , kmt_file     = 'kmt'
  , gridcpl_file = 'unknown_gridcpl_file'
  , kcatbound    = 0
/

&domain_nml
    nprocs = 4
  , processor_shape   = 'slenderX2'
  , distribution_type = 'cartesian'
  , distribution_wght = 'latitude'
  , ew_boundary_type  = 'cyclic'
  , ns_boundary_type  = 'tripole'
  , maskhalo_dyn      = .false.
  , maskhalo_remap    = .false.
  , maskhalo_bound    = .false.
/

&tracer_nml
    tr_iage      = .true.
  , restart_age  = .false.
  , tr_FY        = .true.
  , restart_FY   = .false.
  , tr_lvl       = .true.
  , restart_lvl  = .false.
  , tr_pond_cesm = .false.
  , restart_pond_cesm = .false.
  , tr_pond_topo = .false.
  , restart_pond_topo = .false.
  , tr_pond_lvl  = .true.
  , restart_pond_lvl  = .false.
  , tr_aero      = .false.
  , restart_aero = .false.
/

&thermo_nml
    kitd              = 1
  , ktherm            = 2
  , conduct           = 'bubbly'
  , a_rapid_mode      =  0.5e-3
  , Rac_rapid_mode    =    10.0
  , aspect_rapid_mode =     1.0
  , dSdt_slow_mode    = -5.0e-8
  , phi_c_slow_mode   =    0.05
  , phi_i_mushy       =    0.85
/

&dynamics_nml
    kdyn            = 1
  , ndte            = 120
  , revised_evp     = .false.
  , advection       = 'remap'
  , kstrength       = 1
  , krdg_partic     = 1
  , krdg_redist     = 1
  , mu_rdg          = 3
  , Cf              = 17.
/

&shortwave_nml
    shortwave       = 'dEdd'
  , albedo_type     = 'default'
  , albicev         = 0.78
  , albicei         = 0.36
  , albsnowv        = 0.98
  , albsnowi        = 0.70
  , ahmax           = 0.3
  , R_ice           = 0.
  , R_pnd           = 0.
  , R_snw           = 1.5
  , dT_mlt          = 1.5
  , rsnw_mlt        = 1500.
  , kalg            = 0.6
/

&ponds_nml
    hp1             = 0.01
  , hs0             = 0.
  , hs1             = 0.03
  , dpscale         = 1.e-3
  , frzpnd          = 'hlid'
  , rfracmin        = 0.15
  , rfracmax        = 1.
  , pndaspect       = 0.8
/

&zbgc_nml
    tr_brine        = .false.
  , restart_hbrine  = .false.
  , skl_bgc         = .false.
  , bgc_flux_type   = 'Jin2006'
  , restart_bgc     = .false.
  , restore_bgc     = .false.
  , bgc_data_dir    = 'unknown_bgc_data_dir'
  , sil_data_type   = 'default'
  , nit_data_type   = 'default'
  , tr_bgc_C_sk     = .false.
  , tr_bgc_chl_sk   = .false.
  , tr_bgc_Am_sk    = .false.
  , tr_bgc_Sil_sk   = .false.
  , tr_bgc_DMSPp_sk = .false.
  , tr_bgc_DMSPd_sk = .false.
  , tr_bgc_DMS_sk   = .false.
  , phi_snow        = 0.5
/

&forcing_nml
    formdrag        = .false.
  , atmbndy         = 'default'
  , fyear_init      = 1997
  , ycycle          = 1
  , atm_data_format = 'bin'
  , atm_data_type   = 'LYq'
  , atm_data_dir    = '/forcing/gx1/LargeYeager/'
  , calc_strair     = .true.
  , highfreq        = .false.
  , natmiter        = 5
  , calc_Tsfc       = .true.
  , precip_units    = 'mm_per_sec'
  , ustar_min       = 0.0005
  , fbot_xfer_type  = 'constant'
  , update_ocn_f    = .false.
  , l_mpond_fresh   = .false.
  , tfrz_option     = 'mushy'
  , oceanmixed_ice  = .true.
  , ocn_data_format = 'bin'
  , sss_data_type   = 'default'
  , sst_data_type   = 'default'
  , ocn_data_dir    = 'unknown_ocn_data_dir'
  , oceanmixed_file = 'unknown_oceanmixed_file'
  , restore_sst     = .false.
  , trestore        =  90
  , restore_ice     = .false.
/

&icefields_nml
    f_tmask        = .true.
  , f_tarea        = .true.
  , f_hi           = 'm'
  , f_hs           = 'm'
  , f_Tsfc         = 'm'
  , f_aice         = 'm'
  , f_uvel         = 'm'
  , f_vvel         = 'm'
  , f_fswdn        = 'm'
  , f_flwdn        = 'm'
  , f_snow         = 'x'
  , f_snow_ai      = 'm'
  , f_rain_ai      = 'm'
  , f_sst          = 'm'
  , f_fswabs_ai    = 'm'
  , f_albsni       = 'md'
  , f_congel       = 'm'
  , f_frazil       = 'm'
  , f_meltt        = 'm'
  , f_divu         = 'm'
  , f_sig1         = 'm'
  , f_aicen        = 'x'
  , f_vicen        = 'm'
  , f_Tinz         = 'm'
  , f_iage         = 'm'
  , f_FY           = 'm'
  , f_keffn_top    = 'm'
/

&icefields_mechred_nml
    f_alvl         = 'm'
  , f_vlvl         = 'm'
  , f_ardg         = 'm'
  , f_vrdg         = 'm'
  , f_aparticn     = 'm'
/

&icefields_pond_nml
    f_apondn       = 'm'
  , f_apeff        = 'm'
  , f_hpond_ai     = 'm'
  , f_ipond        = 'm'
/

&icefields_bgc_nml
    f_fbri         = 'm'
  , f_PPnet        = 'x'
/

&icefields_drag_nml
    f_drag         = 'x'
  , f_Cdn_atm      = 'm'
/
"""


@pytest.fixture
def ice_in(tmp_path):
    p = tmp_path / "ice_in"
    p.write_text(TRIPOLE_ICE_IN)
    return str(p)


def test_parse_matches_jax(ice_in):
    g = parse_namelist(ice_in)
    assert g == jnamelist.parse_namelist(ice_in)
    s = g["setup_nml"]
    assert s["dt"] == 3600.0 and s["npt"] == 8760
    assert s["use_leap_years"] is False
    assert s["histfreq"] == ["m", "x", "x", "x", "x"]
    assert s["latpnt"] == [90.0, -65.0]
    assert g["thermo_nml"]["dsdt_slow_mode"] == -5.0e-8
    assert g["ponds_nml"]["dpscale"] == 1.0e-3


def test_fortran_spellings_match_jax(tmp_path):
    p = tmp_path / "nl"
    p.write_text("! a comment line\n&g\n x = 17.\n , y = 1.d-11 ! note\n"
                 " , z = 'a b'\n , w = .TRUE.\n , v = \"q\", u = 3\n"
                 " , arr = 1, 2,\n   3\n , e(3) = 2.5\n/\n&empty\n/\n")
    g = parse_namelist(str(p))
    assert g == jnamelist.parse_namelist(str(p))
    assert g["g"]["x"] == 17.0 and g["g"]["y"] == 1.0e-11
    assert g["g"]["z"] == "a b" and g["g"]["w"] is True
    assert g["g"]["arr"] == [1, 2, 3] and g["g"]["e"] == [None, None, 2.5]
    assert g["empty"] == {}


@pytest.mark.parametrize("strict", [False, True])
def test_config_and_run_controls_match_jax(ice_in, strict):
    kw = dict(nx=16, ny=24, strict=strict)
    if strict:
        # the documented leftover: phi_snow has no ModelConfig home
        with pytest.raises(ValueError, match="phi_snow"):
            config_from_ice_in(ice_in, **kw)
        with pytest.raises(ValueError, match="phi_snow"):
            jnamelist.config_from_ice_in(ice_in, **kw)
        return
    cfg, run = config_from_ice_in(ice_in, **kw)
    jcfg, jrun = jnamelist.config_from_ice_in(ice_in, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert run == jrun
    assert run["unmapped"] == {"phi_snow": 0.5}
    assert run["diagfreq"] == 24 and run["tfrz_option"] == "mushy"
    assert len(run["icefields"]) == 40
    assert cfg.grid.ns_boundary == "tripole" and cfg.dyn.mu_rdg == 3.0
    assert cfg.tracers.frzpnd == "hlid" and cfg.thermo.ktherm == 2
    # the f_* selections map onto the same catalog fields
    got, un = fields_for_icefields(run["icefields"], cfg,
                                   build_tracer_registry(cfg))
    ref, jun = jfields_for(jrun["icefields"], jcfg, jbuild(jcfg))
    assert [f.name for f in got] == [f.name for f in ref]
    assert un == jun


def test_overrides_and_unknown_entries_match_jax(tmp_path):
    p = tmp_path / "ice_in"
    p.write_text("&thermo_nml\n ktherm = 2\n , made_up_option = 3\n/\n")
    for fn in (config_from_ice_in, jnamelist.config_from_ice_in):
        with pytest.raises(ValueError, match="made_up_option"):
            fn(str(p), nx=4, ny=4, strict=True)
    cfg, run = config_from_ice_in(str(p), nx=4, ny=4, dtype="float64")
    jcfg, jrun = jnamelist.config_from_ice_in(str(p), nx=4, ny=4,
                                              dtype="float64")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert run == jrun == {"unmapped": {"made_up_option": 3}}
    assert cfg.dtype == "float64"


@pytest.mark.parametrize("text,what", [
    ("&grid_nml\n grid_type = 'bipolar'\n/\n", "grid_type"),
    ("&domain_nml\n ew_boundary_type = 'tripole'\n/\n", "east-west"),
])
def test_options_outside_the_port_raise_at_model_not_at_parse(tmp_path,
                                                              text, what):
    p = tmp_path / "ice_in"
    p.write_text(text)
    cfg, _ = config_from_ice_in(str(p), nx=8, ny=8)
    with pytest.raises(NotImplementedError, match=what):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("text,flags", [
    ("&zbgc_nml\n skl_bgc = .true.\n/\n", ("skl_bgc",)),
    ("&tracer_nml\n tr_brine = .true.\n tr_aero = .true.\n/\n",
     ("tr_brine", "tr_aero")),
    ("&tracer_nml\n tr_brine = .true.\n/\n", ("tr_brine",)),
    ("&tracer_nml\n tr_aero = .true.\n/\n", ("tr_aero",)),
])
def test_tracer_options_build_the_model(tmp_path, text, flags):
    """The aerosol, brine and skeletal-BGC switches of an ice_in build the
    port's Model (they parse as the JAX package parses them); n_aero is a
    build-time size the namelist does not carry, so tr_aero alone keeps
    no species."""
    p = tmp_path / "ice_in"
    p.write_text(text)
    cfg, _ = config_from_ice_in(str(p), nx=8, ny=8)
    jcfg, _ = jnamelist.config_from_ice_in(str(p), nx=8, ny=8)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert all(getattr(cfg.tracers, k) for k in flags)
    m = Model(cfg, device="cpu")
    assert (m.tr.nt_fbri >= 0) == cfg.tracers.tr_brine
    assert bool(m.tr.nbtrcr) == cfg.tracers.skl_bgc


def test_tripole_namelist_builds_the_parity_model(ice_in):
    """The namelist's physics is the gx1-parity set: the port's Model
    takes it (on the parity test grid, float64, ndte cut to 8) and a step
    from its initial state is healthy."""
    cfg, _ = config_from_ice_in(ice_in, nx=U.PARITY_NX, ny=U.PARITY_NY,
                                dtype="float64", accum_dtype="float64")
    cfg = cfg.replace(dyn=dataclasses.replace(cfg.dyn, ndte=8))
    m = Model(cfg, grid=popgrid_np(cfg, *U.parity_grid_arrays(),
                                   device="cpu"), device="cpu")
    st, d = m.step(m.init_state(), m.forcing_at(0))
    assert int(d.state_bad) == 0 and bool(d.therm_converged)
    assert torch.isfinite(st.vicen).all()
    assert float(np.asarray(st.vicen.sum())) > 0.0


@pytest.mark.parametrize("text", [
    "&tracer_nml\n tr_pond_cesm = .true.\n/\n",
    "&tracer_nml\n tr_lvl = .true.\n , tr_pond_topo = .true.\n/\n",
    "&tracer_nml\n tr_lvl = .true.\n , tr_pond_lvl = .true.\n/\n"
    "&ponds_nml\n frzpnd = 'cesm'\n/\n",
    "&thermo_nml\n ktherm = 0\n/\n",
    "&thermo_nml\n ktherm = 2\n/\n",
    "&thermo_nml\n calc_Tsfc = .false.\n/\n",
], ids=["tr_pond_cesm", "tr_pond_topo", "frzpnd_cesm", "ktherm0",
        "ktherm2", "calc_tsfc_off"])
def test_column_options_build_a_model_that_steps(tmp_path, text):
    """An ice_in that sets one of the column options of the port (cesm or
    topo ponds, the cesm pond refreezing, zero-layer or mushy thermo, the
    coupler's surface fluxes) parses as the JAX reader parses it, builds
    the port's Model on a small rectangular grid, and a step from its
    initial state is healthy."""
    p = tmp_path / "ice_in"
    p.write_text(text)
    cfg, _ = config_from_ice_in(str(p), nx=8, ny=8, dtype="float64",
                                accum_dtype="float64")
    jcfg, _ = jnamelist.config_from_ice_in(str(p), nx=8, ny=8,
                                           dtype="float64",
                                           accum_dtype="float64")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg = cfg.replace(dyn=dataclasses.replace(cfg.dyn, ndte=4))
    m = Model(cfg, device="cpu")
    f = m.forcing_at(0)
    if not cfg.thermo.calc_Tsfc:
        fc = lambda v: torch.full((cfg.ncat, 8, 8), v, dtype=torch.float64)
        f = f.replace(fsurfn_f=fc(-30.0), fcondtopn_f=fc(-30.0),
                      flatn_f=fc(-2.0), fsensn_f=fc(-10.0))
    st, d = m.step(m.init_state(ice_mask=m.grid.tmask), f)
    assert int(d.state_bad) == 0 and bool(d.therm_converged)
    assert torch.isfinite(st.vicen).all()
    assert float(st.vicen.sum()) > 0.0
