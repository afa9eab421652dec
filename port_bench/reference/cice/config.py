"""Typed, hashable model configuration of the PyTorch port.

A copy of the dataclasses of ``cice5_tpu/config.py`` (the reference's
compile-time CPP macros plus runtime namelists, ice_domain_size.F90:23-67
and ice_init.F90:135-199, collapsed into one frozen dataclass tree). The
fields and defaults are the JAX package's, so one set of keyword arguments
builds the same configuration in both packages. Dtype strings map to
torch dtypes through ``ModelConfig.xp_dtype``.

Every option outside the slice this port runs raises NotImplementedError
when a ``Model`` is built (``driver.model.check_supported``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass(frozen=True)
class GridConfig:
    """Grid shape & type (ice_domain_size.F90:23-37, ice_grid.F90:309-324)."""
    nx: int = 100                # global grid columns (gx3: 100)
    ny: int = 116                # global grid rows (gx3: 116)
    grid_type: str = "rectangular"   # rectangular | displaced_pole | tripole | latlon | column
    ew_boundary: str = "cyclic"      # cyclic | open | closed
    ns_boundary: str = "open"        # open | closed | cyclic | tripole | tripoleT
    dx_const: float = 30000.0        # rectgrid cell size (m)  (ice_grid.F90:1145)
    dy_const: float = 30000.0
    lat0: float = 71.35              # rectgrid lower-left latitude (deg);
    # Barrow AK origin (ice_grid.F90:1208) keeps the whole rectangular
    # domain above set_state_var's 70N ice-edge threshold
    lon0: float = -156.5
    # POP grid file inputs (ice_grid.F90:543 popgrid / :659 popgrid_nc),
    # used when grid_type is displaced_pole/tripole
    grid_format: str = "nc"          # nc | bin  (grid_format namelist)
    grid_file: str | None = None
    kmt_file: str | None = None
    # ocean-column packing for the column physics (the reference's
    # compressed cell lists, ice_therm_vertical.F90:186-200). The port
    # runs dense masked columns: "auto" and "off" mean unpacked, "on" is
    # refused.
    compact_columns: str = "auto"    # auto | on | off


@dataclass(frozen=True)
class ThermoConfig:
    """Vertical thermodynamics options (ice_init.F90 thermo_nml)."""
    ktherm: int = 1                  # 0=zero-layer, 1=BL99, 2=mushy
    conduct: str = "bubbly"          # bubbly | MU71 (ice_therm_bl99.F90:940)
    calc_Tsfc: bool = True
    heat_capacity: bool = True
    ustar_min: float = 0.0005        # min friction velocity under ice
    fbot_xfer_type: str = "constant"
    saltmax: float = 3.2             # max bulk salinity, BL99 profile
    nsal: float = 0.407              # salinity profile shape params
    msal: float = 0.573
    # mushy gravity-drainage parameters (ice_init.F90:386-390 defaults;
    # the gx templates override dSdt_slow_mode to -5.0e-8)
    a_rapid_mode: float = 0.5e-3     # channel radius, rapid mode (m)
    Rac_rapid_mode: float = 10.0     # critical Rayleigh number
    aspect_rapid_mode: float = 1.0   # convection aspect ratio
    dSdt_slow_mode: float = -1.5e-7  # slow-mode drainage strength (m/s/K)
    phi_c_slow_mode: float = 0.05
    phi_i_mushy: float = 0.85        # solid fraction of frozen mush
    phi_init: float = 0.75           # initial liquid fraction of frazil
    dSin0_frazil: float = 3.0        # frazil bulk-salinity offset from sss
    ksno: float = 0.30
    hfrazilmin: float = 0.05         # min thickness of new frazil ice (m)
    # mushy solver controls (ice_therm_mushy.F90)
    dTemp_errmax: float = 5.0e-4    # Picard convergence (K); f32 floors
    # at max(10x this, 5e-3) — see mushy.picard_solver
    nit_max_picard: int = 100


@dataclass(frozen=True)
class DynConfig:
    """Dynamics / ridging options (ice_init.F90 dynamics_nml; ice_dyn_shared.F90:31-81)."""
    kdyn: int = 1                    # 0=off, 1=EVP, 2=EAP
    ndte: int = 120                  # EVP subcycles per dynamics step
    # the JAX package's EVP execution switch. The port always runs its
    # one sweep (the evp_sweep kernel on the GPU, its plain version on
    # the CPU) and ignores the value.
    evp_algorithm: str = "auto"
    evp_chunk: int = 10              # subcycles per margin exchange (chunked)
    revised_evp: bool = False        # Bouillon-13 revised EVP (ice_dyn_shared.F90:230)
    yield_curve: str = "ellipse"     # only 'ellipse' exists (ice_dyn_shared.F90:41)
    e_ratio: float = 2.0             # yield-curve axis ratio e (ecci = 1/e^2)
    Pstar: float = 2.75e4            # Hibler strength P* (N/m^2)
    Cstar: float = 20.0              # Hibler strength C*
    kstrength: int = 1               # 0=Hibler79, 1=Rothrock75
    krdg_partic: int = 1             # 0=linear, 1=exponential participation
    krdg_redist: int = 1             # 0=Hibler, 1=exponential redistribution
    mu_rdg: float = 4.0              # e-folding scale of ridged ice (kr_redist=1)
    Cf: float = 17.0                 # ratio of ridging work to PE change
    cosw: float = 1.0                # cos/sin of ocean turning angle
    sinw: float = 0.0
    # EAP
    a11_0: float = 0.5
    # transport
    advection: str = "remap"         # remap | upwind | none
    conserv_check: bool = False      # transport global conservation check
    monotonicity_check: bool = False # transport monotone-remap check
    # the JAX package's remap-integrals switch; the port always runs the
    # remap_flux_both kernel on the GPU and its plain version on the CPU
    remap_kernel: str = "auto"
    # per-category mechanical-redistribution history diagnostics
    # (ice_history_mechred.F90)
    diag_mechred: bool = False


@dataclass(frozen=True)
class ShortwaveConfig:
    """Radiation options (ice_init.F90 shortwave_nml; ice_shortwave.F90)."""
    shortwave: str = "ccsm3"         # ccsm3 | dEdd
    albedo_type: str = "ccsm3"       # ccsm3 | constant
    albicev: float = 0.78            # visible ice albedo, h > ahmax
    albicei: float = 0.36            # near-IR ice albedo
    albsnowv: float = 0.98           # visible cold-snow albedo
    albsnowi: float = 0.70           # near-IR cold-snow albedo
    ahmax: float = 0.3               # albedo-thickness transition (m)
    # delta-Eddington tuning (ice_shortwave.F90 dEdd knobs)
    R_ice: float = 0.0
    R_pnd: float = 0.0
    R_snw: float = 1.5
    dT_mlt: float = 1.5
    rsnw_mlt: float = 1500.0
    kalg: float = 0.6
    # constant albedos (albedo_type=constant)
    albedo_const: float = 0.78
    # orbital-parameter source (ice_orbital.F90:46 init_orbit default year;
    # csm_share/shr_orb_mod.F90 shr_orb_params): Berger-1978 series year,
    # or iyear_orb=None + explicit (eccen, obliq deg, mvelp deg) — the
    # SHR_ORB_UNDEF_INT branch. Evaluated on the host once per Model.
    iyear_orb: int | None = 1950
    orb_eccen: float | None = None
    orb_obliq: float | None = None
    orb_mvelp: float | None = None
    # the JAX package's dEdd execution switch; the port always runs the
    # shortwave_dedd kernel on the GPU and its plain version on the CPU
    sw_kernel: str = "auto"


@dataclass(frozen=True)
class TracerConfig:
    """Optional tracer switches (ice_init.F90 tracer_nml; ice_state.F90:126-135)."""
    tr_iage: bool = False
    tr_FY: bool = False
    tr_lvl: bool = False
    tr_pond_cesm: bool = False
    tr_pond_lvl: bool = False
    tr_pond_topo: bool = False
    tr_aero: bool = False
    tr_brine: bool = False
    n_aero: int = 0
    skl_bgc: bool = False
    # skeletal-layer BGC tracer switches (ice_zbgc.F90 zbgc_nml; algal N is
    # always carried when skl_bgc is on)
    tr_bgc_Nit_sk: bool = True
    tr_bgc_C_sk: bool = True
    tr_bgc_chl_sk: bool = True
    tr_bgc_Am_sk: bool = True
    tr_bgc_Sil_sk: bool = True
    tr_bgc_DMSPp_sk: bool = True
    tr_bgc_DMSPd_sk: bool = True
    tr_bgc_DMS_sk: bool = True
    bgc_flux_type: str = "Jin2006"   # Jin2006 | constant
    # fraction of ocean dissolved-tracer concentration taken up by new
    # frazil ice (ice_zbgc_shared.F90:83 initbio_frac, zbgc_nml)
    initbio_frac: float = 1.0
    # pond params (ice_init.F90 ponds_nml)
    hs0: float = 0.03
    hs1: float = 0.03
    hp1: float = 0.01
    dpscale: float = 0.001
    frzpnd: str = "cesm"             # cesm | hlid
    rfracmin: float = 0.15
    rfracmax: float = 1.0
    pndaspect: float = 0.8

    @property
    def tr_pond(self) -> bool:
        return self.tr_pond_cesm or self.tr_pond_lvl or self.tr_pond_topo


@dataclass(frozen=True)
class ForcingConfig:
    """Atmo/ocean boundary & forcing options (ice_init.F90 forcing_nml)."""
    atmbndy: str = "default"         # default (stability iteration) | constant
    formdrag: bool = False
    highfreq: bool = False
    natmiter: int = 5                # stability iterations
    oceanmixed_ice: bool = False     # prognostic slab-ocean SST
    calc_strair: bool = True
    atm_data_type: str = "default"
    ocn_data_type: str = "default"
    precip_units: str = "mks"
    update_ocn_f: bool = False
    l_mpond_fresh: bool = False
    restore_sst: bool = False
    restore_ice: bool = False        # nudge open-boundary cells (regional)
    trestore: int = 90


@dataclass(frozen=True)
class TimeConfig:
    """Timestepping (ice_init.F90 setup_nml; ice_calendar.F90)."""
    dt: float = 3600.0               # thermo timestep (s)
    ndtd: int = 1                    # dynamics subcycles per thermo step
    npt: int = 24                    # number of steps to run
    year_init: int = 1997
    istep0: int = 0
    days_per_year: int = 365
    use_leap_years: bool = False
    sec_init: int = 0


@dataclass(frozen=True)
class ModelConfig:
    """Root configuration (the full "namelist")."""
    grid: GridConfig = field(default_factory=GridConfig)
    thermo: ThermoConfig = field(default_factory=ThermoConfig)
    dyn: DynConfig = field(default_factory=DynConfig)
    shortwave: ShortwaveConfig = field(default_factory=ShortwaveConfig)
    tracers: TracerConfig = field(default_factory=TracerConfig)
    forcing: ForcingConfig = field(default_factory=ForcingConfig)
    time: TimeConfig = field(default_factory=TimeConfig)

    ncat: int = 5                    # ice thickness categories (NICECAT)
    nilyr: int = 7                   # ice layers (NICELYR)
    nslyr: int = 1                   # snow layers (NSNWLYR)
    kitd: int = 1                    # 0=delta-function, 1=linear remap ITD
    kcatbound: int = 1               # category-bound scheme (ice_itd.F90:41-64)

    dtype: str = "float32"           # state dtype ("float32" | "float64")
    accum_dtype: str = "float32"     # reduction/accumulation dtype

    # reference coupled-mode radiation ordering: thermo consumes LAST
    # step's per-category SW absorption rescaled by prep_radiation
    # (ice_step_mod.F90:33-154); radiation proper runs at the END of the
    # step on the post-dynamics state (step_radiation, :1364), feeding
    # the coupler and the next step. False = standalone ordering
    # (radiation at step start from current forcing; equivalent up to the
    # one-step albedo lag the reference accepts for coupler symmetry).
    coupled_radiation: bool = False

    @property
    def xp_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def np_accum_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.accum_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
