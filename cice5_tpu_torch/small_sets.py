"""Small float64 configurations of the dynamics, transport and tracer
options, one definition for every check that runs them.

Each runs the BL99 + CCSM3 model (gx3's dynamics and slab ocean) on a
24x16 global mesh, ndte=8, with one option on; the layer sets run the
gx1-parity physics there with CESM2's 8 ice and 3 snow layers. The tests
hold the port's step on them against the JAX package's
(``tests/torch_option_sets.py``), and ``chip_smoke.py`` holds the card
against the CPU on the same configurations.
"""
from __future__ import annotations

import dataclasses

from cice5_tpu_torch import config as C

NY, NX, NDTE = 24, 16, 8

DEDD = dict(shortwave="dEdd", R_ice=0.0, R_pnd=0.0, R_snw=1.5, dT_mlt=1.5,
            rsnw_mlt=1500.0)
MUSHY = dict(ktherm=2, dSdt_slow_mode=-5.0e-8)
PONDS = dict(hs0=0.0, hs1=0.03, hp1=0.01, dpscale=1e-3, rfracmin=0.15,
             rfracmax=1.0, pndaspect=0.8)
# the skeletal-BGC tracers that bgc_constant leaves out, so that the
# registry's subset ordering is held
BGC_SUBSET_OFF = dict(tr_bgc_C_sk=False, tr_bgc_DMSPp_sk=False,
                      tr_bgc_DMSPd_sk=False, tr_bgc_DMS_sk=False)
# the fields a dynamics set adds to the state, and a tracer set to the
# state and to StepDiag
DYN_STATE = ("a11n", "a12n")
TRACER_STATE = ("first_ice",)
TRACER_DIAG = ("faero_ocn", "flux_bio", "PP_net", "grow_net")


def grid(ns) -> C.GridConfig:
    """The mesh with an open north (displaced pole) or a tripole seam
    (U-fold "tripole" or T-fold "tripoleT")."""
    return C.GridConfig(nx=NX, ny=NY, ew_boundary="cyclic", ns_boundary=ns,
                        grid_type="displaced_pole" if ns == "open"
                        else "tripole")


def bl99(ns="open") -> C.ModelConfig:
    """BL99 + CCSM3 with gx3's dynamics and slab ocean, no tracers."""
    return C.ModelConfig(
        grid=grid(ns),
        dyn=C.DynConfig(kdyn=1, ndte=NDTE, advection="remap", kstrength=1,
                        krdg_partic=1, krdg_redist=1, mu_rdg=3.0, Cf=17.0),
        forcing=C.ForcingConfig(oceanmixed_ice=True, natmiter=5),
        time=C.TimeConfig(dt=3600.0), dtype="float64",
        accum_dtype="float64")


def with_(cfg, **sections):
    """``cfg`` with the named sections' fields replaced."""
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in sections.items()})


def dyn_option_sets() -> dict:
    """{name: ModelConfig} of the dynamics and transport options, each on
    the BL99 model: a T-fold seam, EAP alone, on a T-fold seam and with
    the per-category mechred diagnostics on a U-fold seam, upwind
    transport, the transport conservation and monotonicity checks, and
    dynamics without transport."""
    b = bl99()
    return {
        # remap_kernel="pallas": the JAX reference runs the Pallas remap
        # kernel, which the port's kernel B replaces (ROADMAP C)
        "tfold": with_(bl99("tripoleT"), dyn=dict(remap_kernel="pallas")),
        "eap": with_(b, dyn=dict(kdyn=2)),
        "eap_mechred": with_(bl99("tripole"),
                             dyn=dict(kdyn=2, diag_mechred=True),
                             tracers=dict(tr_lvl=True)),
        "upwind": with_(b, dyn=dict(advection="upwind"),
                        tracers=dict(tr_iage=True)),
        "transport_checks": with_(b, dyn=dict(conserv_check=True,
                                              monotonicity_check=True),
                                  tracers=dict(tr_iage=True)),
        "dyn_no_transport": with_(b, dyn=dict(advection="none")),
        "eap_tfold": with_(bl99("tripoleT"),
                           dyn=dict(kdyn=2, remap_kernel="pallas")),
    }


def tracer_option_sets() -> dict:
    """{name: ModelConfig} of the aerosol, brine and skeletal-BGC tracers:
    aerosols under BL99, brine + BGC under mushy thermo, the constant
    piston velocity with a subset of the BGC tracers, and every auxiliary
    tracer at once on a U-fold seam (aerosols, brine, BGC, topo ponds,
    iage, FY and lvl)."""
    b = bl99()
    return {
        "aero": with_(b, tracers=dict(tr_aero=True, n_aero=3)),
        "brine_bgc": with_(b, thermo=MUSHY,
                           tracers=dict(tr_brine=True, skl_bgc=True)),
        "bgc_constant": with_(b, tracers=dict(
            skl_bgc=True, bgc_flux_type="constant", **BGC_SUBSET_OFF)),
        "tracers_all": with_(bl99("tripole"), shortwave=DEDD,
                             tracers=dict(tr_aero=True, n_aero=2,
                                          tr_iage=True, tr_FY=True,
                                          tr_lvl=True, tr_pond_topo=True,
                                          tr_brine=True, skl_bgc=True,
                                          **PONDS)),
    }


def layer_option_sets() -> dict:
    """{name: ModelConfig} of the sea-ice column of CESM2 (CICE 5.1.2 with
    8 ice and 3 snow layers; Bailey et al. 2020, JAMES): the gx1-parity
    physics (mushy thermo, dEdd, level ponds, iage/FY/lvl) at
    ``nilyr=8, nslyr=3`` on the tripole mesh, and the same under BL99
    thermo, whose snow rows differ."""
    cfg = with_(C.gx1_parity_config(nilyr=8, nslyr=3, dtype="float64",
                                    accum_dtype="float64"),
                dyn=dict(ndte=NDTE)).replace(grid=grid("tripole"))
    return {"cesm2_layers": cfg,
            "cesm2_layers_bl99": with_(cfg, thermo=dict(ktherm=1))}
