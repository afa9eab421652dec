"""Prognostic model state and runtime tracer registry of the PyTorch port.

``TracerRegistry`` and ``build_tracer_registry`` are copies of
``cice5_tpu/state.py`` (index pointers nt_* of ice_state.F90:97-135, the
dependency encoding of ice_init.F90:1361-1392): ``depend`` is 0
(area-weighted), 1 (ice-volume), 2 (snow-volume) or ``3 + parent_index``.
``State`` holds the same fields as the JAX pytree, as tensors with layout
``(ncat, ny, nx)`` / ``(ncat, ntrcr, ny, nx)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from reference.cice.config import ModelConfig
from reference.cice.utils import tensorclass

# depend codes
DEP_AICE = 0
DEP_VICE = 1
DEP_VSNO = 2
DEP_TRCR = 3  # depend >= 3 means 'depends on tracer (depend - 3)'


@dataclass(frozen=True)
class TracerRegistry:
    """Static tracer layout: names, index ranges, dependencies.

    Built once from config; hashable. Index attributes are 0-based offsets into the trcrn axis.
    """
    ntrcr: int
    names: tuple[str, ...]          # one name per tracer slot
    depend: tuple[int, ...]         # per-slot dependency code
    nt_Tsfc: int
    nt_qice: int                    # first of nilyr enthalpy layers
    nt_sice: int                    # first of nilyr salinity layers
    nt_qsno: int                    # first of nslyr snow-enthalpy layers
    nt_iage: int = -1
    nt_FY: int = -1
    nt_alvl: int = -1
    nt_vlvl: int = -1
    nt_apnd: int = -1
    nt_hpnd: int = -1
    nt_ipnd: int = -1
    nt_aero: int = -1
    nt_fbri: int = -1
    # skeletal-layer BGC (ice_zbgc.F90:226-276): bgc_names in nlt order,
    # nt_bgc aligned trcrn slots, bgc_type 1.0=dissolved (flows with brine)
    # / 0.0=mobile-phase (algae etc.; ice_zbgc.F90:321-329)
    bgc_names: tuple[str, ...] = ()
    nt_bgc: tuple[int, ...] = ()
    bgc_type: tuple[float, ...] = ()

    @property
    def nbtrcr(self) -> int:
        return len(self.nt_bgc)

    @property
    def n_aero(self) -> int:
        """Number of aerosol species (4 trcrn slots each: 2 snow + 2 ice
        layers, the reference's nt_aero+4*(it-1) layout,
        ice_state.F90:118)."""
        return sum(1 for n in self.names if n.startswith("aerosno1_"))


def build_tracer_registry(cfg: ModelConfig) -> TracerRegistry:
    """Assign tracer slots in the reference's canonical order
    (ice_state.F90:97-123, ice_init.F90:1361-1392)."""
    names: list[str] = []
    depend: list[int] = []
    idx: dict[str, int] = {}

    def add(name: str, n: int, dep) -> int:
        start = len(names)
        idx[name] = start
        for k in range(n):
            names.append(name if n == 1 else f"{name}{k:03d}")
            depend.append(dep if isinstance(dep, int) else dep[k])
        return start

    nilyr, nslyr = cfg.nilyr, cfg.nslyr
    t = cfg.tracers
    add("Tsfc", 1, DEP_AICE)
    add("qice", nilyr, DEP_VICE)
    add("sice", nilyr, DEP_VICE)
    add("qsno", nslyr, DEP_VSNO)
    if t.tr_iage:
        add("iage", 1, DEP_VICE)
    if t.tr_FY:
        add("FY", 1, DEP_AICE)
    if t.tr_lvl:
        add("alvl", 1, DEP_AICE)
        add("vlvl", 1, DEP_VICE)
    if t.tr_pond_cesm:
        a = add("apnd", 1, DEP_AICE)
        add("hpnd", 1, DEP_TRCR + a)
    elif t.tr_pond_lvl:
        a = add("apnd", 1, DEP_TRCR + idx["alvl"])
        add("hpnd", 1, DEP_TRCR + a)
        add("ipnd", 1, DEP_TRCR + a)
    elif t.tr_pond_topo:
        a = add("apnd", 1, DEP_AICE)
        add("hpnd", 1, DEP_TRCR + a)
        add("ipnd", 1, DEP_TRCR + a)
    if t.tr_aero:
        for it in range(t.n_aero):
            add(f"aerosno1_{it}", 1, DEP_VSNO)
            add(f"aerosno2_{it}", 1, DEP_VSNO)
            add(f"aeroice1_{it}", 1, DEP_VICE)
            add(f"aeroice2_{it}", 1, DEP_VICE)
    if t.tr_brine:
        add("fbri", 1, DEP_VICE)

    # skeletal-layer BGC tracers, nlt assignment order of
    # ice_zbgc.F90:226-276 (algal N is unconditional under skl_bgc);
    # all depend on area (trcr_depend = 0, ice_zbgc.F90:311-319)
    bgc_names: list[str] = []
    bgc_type: list[float] = []
    if t.skl_bgc:
        def addb(name: str, on: bool, typ: float):
            if on:
                add(f"bgc_{name}", 1, DEP_AICE)
                bgc_names.append(name)
                bgc_type.append(typ)
        addb("N", True, 0.0)
        addb("NO", t.tr_bgc_Nit_sk, 1.0)
        addb("C", t.tr_bgc_C_sk, 0.0)
        addb("chl", t.tr_bgc_chl_sk, 0.0)
        addb("NH", t.tr_bgc_Am_sk, 1.0)
        addb("Sil", t.tr_bgc_Sil_sk, 1.0)
        addb("DMSPp", t.tr_bgc_DMSPp_sk, 0.0)
        addb("DMSPd", t.tr_bgc_DMSPd_sk, 1.0)
        addb("DMS", t.tr_bgc_DMS_sk, 1.0)

    first_aero = idx.get(f"aerosno1_0", -1)
    return TracerRegistry(
        ntrcr=len(names), names=tuple(names), depend=tuple(depend),
        nt_Tsfc=idx["Tsfc"], nt_qice=idx["qice"], nt_sice=idx["sice"],
        nt_qsno=idx["qsno"],
        nt_iage=idx.get("iage", -1), nt_FY=idx.get("FY", -1),
        nt_alvl=idx.get("alvl", -1), nt_vlvl=idx.get("vlvl", -1),
        nt_apnd=idx.get("apnd", -1), nt_hpnd=idx.get("hpnd", -1),
        nt_ipnd=idx.get("ipnd", -1), nt_aero=first_aero,
        nt_fbri=idx.get("fbri", -1),
        bgc_names=tuple(bgc_names),
        nt_bgc=tuple(idx[f"bgc_{n}"] for n in bgc_names),
        bgc_type=tuple(bgc_type),
    )


@tensorclass
class State:
    """Full prognostic state (ice_state.F90:53-147 plus the EVP stress
    state carried for exact restart, ice_restart_driver.F90:101-121).

    Shapes: aicen/vicen/vsnon (ncat, ny, nx); trcrn (ncat, ntrcr, ny, nx);
    uvel/vvel (ny, nx) on U (NE-corner) points; stress* (4, ny, nx) holding
    the 4 per-cell corner values (NE, NW, SW, SE). The field list is the
    JAX package's, so states convert one to one (``convert.py``)."""
    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    trcrn: torch.Tensor
    uvel: torch.Tensor
    vvel: torch.Tensor
    stressp: torch.Tensor
    stressm: torch.Tensor
    stress12: torch.Tensor
    scale_factor: torch.Tensor  # shortwave scaling accumulator (ny, nx)
    iceumask: torch.Tensor      # U-cell ice mask of the last dynamics step
    strocnxT: torch.Tensor      # ice-ocean stress on the T grid from the
    strocnyT: torch.Tensor      # last dynamics step (feeds ustar)
    frzmlt: torch.Tensor        # slab-ocean freezing/melting potential
    sst: torch.Tensor           # slab-ocean SST
    a11n: torch.Tensor          # EAP structure tensor (inert under EVP)
    a12n: torch.Tensor
    first_ice: torch.Tensor     # (ncat, ny, nx) "first ice" flag
    mlt_onset: torch.Tensor     # melt / freeze onset day of year
    frz_onset: torch.Tensor
    rad_prev: torch.Tensor      # coupled-ordering radiation memory
    rad_alb: torch.Tensor       # (empty in the standalone ordering)

    @property
    def aice(self):
        return self.aicen.sum(0)

    @property
    def vice(self):
        return self.vicen.sum(0)

    @property
    def vsno(self):
        return self.vsnon.sum(0)


def zeros_state(cfg: ModelConfig, tr: TracerRegistry, *,
                device) -> State:
    ny, nx = cfg.grid.ny, cfg.grid.nx
    kw = dict(dtype=cfg.xp_dtype, device=device)
    z2 = lambda: torch.zeros((ny, nx), **kw)
    zc = lambda: torch.zeros((cfg.ncat, ny, nx), **kw)
    nrad = (3 + cfg.nslyr + cfg.nilyr) if cfg.coupled_radiation else 0
    return State(
        aicen=zc(), vicen=zc(), vsnon=zc(),
        trcrn=torch.zeros((cfg.ncat, tr.ntrcr, ny, nx), **kw),
        uvel=z2(), vvel=z2(),
        stressp=torch.zeros((4, ny, nx), **kw),
        stressm=torch.zeros((4, ny, nx), **kw),
        stress12=torch.zeros((4, ny, nx), **kw),
        scale_factor=z2(), iceumask=z2(), strocnxT=z2(), strocnyT=z2(),
        frzmlt=z2(), sst=z2(),
        a11n=torch.full((4, ny, nx), 0.5, **kw),
        a12n=torch.zeros((4, ny, nx), **kw),
        first_ice=torch.ones((cfg.ncat, ny, nx), **kw),
        mlt_onset=z2(), frz_onset=z2(),
        rad_prev=torch.zeros((cfg.ncat, nrad, ny, nx), **kw),
        rad_alb=torch.zeros((4 if cfg.coupled_radiation else 0, ny, nx),
                            **kw),
    )
