"""Small float64 configurations of the port's options, one definition
for every check that runs them.

Each runs on a 24x16 global mesh, ndte=8: gx3's and tp1's physics, and
the BL99 + CCSM3 model (gx3's dynamics and slab ocean) with one column,
dynamics, transport, tracer or namelist option on; the layer sets run
the gx1-parity physics there with CESM2's 8 ice and 3 snow layers. The
tests hold the port's step on them against the JAX package's
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


def column_option_sets() -> dict:
    """{name: ModelConfig} of the standalone configurations and the column
    options: gx3's and tp1's physics on a displaced-pole and a tripole
    grid, the BL99 model on a tripole seam, mushy thermo without dEdd,
    dEdd without ponds, each of iage, FY and lvl alone, CESM and
    topographic ponds under BL99 and mushy thermo, the CESM refreezing of
    level ponds, zero-layer thermo, and the coupler's surface fluxes
    (calc_Tsfc=False) under BL99 and mushy thermo."""
    f64 = dict(dtype="float64", accum_dtype="float64")
    gx3 = with_(C.gx3_config(**f64), dyn=dict(ndte=NDTE))
    tp1 = with_(C.tp1_config(**f64), dyn=dict(ndte=NDTE))
    b = bl99()
    return {
        "gx3": gx3.replace(grid=grid("open")),
        "tp1": tp1.replace(grid=grid("tripole")),
        "bl99_ccsm3_tripole": bl99("tripole"),
        "mushy_ccsm3": with_(b, thermo=MUSHY),
        "dedd_no_ponds": with_(b, shortwave=DEDD),
        "iage": with_(b, tracers=dict(tr_iage=True)),
        "FY": with_(b, tracers=dict(tr_FY=True)),
        "lvl": with_(b, tracers=dict(tr_lvl=True)),
        "cesm_ponds_bl99": with_(b, shortwave=DEDD,
                                 tracers=dict(tr_pond_cesm=True, **PONDS)),
        "cesm_ponds_mushy": with_(b, thermo=MUSHY, shortwave=DEDD,
                                  tracers=dict(tr_pond_cesm=True, **PONDS)),
        "topo_ponds_bl99": with_(b, shortwave=DEDD,
                                 tracers=dict(tr_pond_topo=True, **PONDS)),
        "topo_ponds_mushy": with_(b, thermo=MUSHY, shortwave=DEDD,
                                  tracers=dict(tr_pond_topo=True, **PONDS)),
        "frzpnd_cesm": level_ponds(),
        "zerolayer": with_(b, thermo=dict(ktherm=0)),
        "calc_tsfc_off_bl99": with_(b, thermo=dict(calc_Tsfc=False)),
        "calc_tsfc_off_mushy": with_(b, thermo=dict(calc_Tsfc=False,
                                                    **MUSHY)),
    }


def level_ponds() -> C.ModelConfig:
    """The BL99 model with dEdd and level ponds refreezing as CESM does
    (``frzpnd="cesm"``)."""
    return with_(bl99(), shortwave=DEDD, tracers=dict(
        tr_lvl=True, tr_pond_lvl=True, frzpnd="cesm", **PONDS))


def flag_option_sets() -> dict:
    """{name: ModelConfig} of the namelist options that ``check_supported``
    accepts and no other set turns on, each on the BL99 model (the
    ``bl99`` set) with one option changed: MU71 conductivity, the
    delta-function ITD, Hibler strength, two dynamics subcycles per step,
    the constant-coefficient boundary layer, the revised EVP, an ellipse
    aspect ratio of 1.5, a 25-degree ocean turning angle, the WMO category
    bounds, linear ridging participation and Hibler redistribution,
    constant albedos, the frazil's ocean fluxes, SST restoring with a
    one-day time scale, closed east-west and north-south boundaries, and
    the pond water kept from the ocean on the level-pond model
    (``frzpnd_cesm``)."""
    b = bl99()
    return {
        "bl99": b,
        "mu71": with_(b, thermo=dict(conduct="MU71")),
        "kitd0": b.replace(kitd=0),
        "hibler_strength": with_(b, dyn=dict(kstrength=0)),
        "ndtd2": with_(b, time=dict(ndtd=2)),
        "atmbndy_const": with_(b, forcing=dict(atmbndy="constant")),
        "revised_evp": with_(b, dyn=dict(revised_evp=True)),
        "e_ratio": with_(b, dyn=dict(e_ratio=1.5)),
        # an ocean turning angle of 25 degrees
        "turning_angle": with_(b, dyn=dict(cosw=0.9063, sinw=0.4226)),
        "kcatbound2": b.replace(kcatbound=2),
        "rdg_linear": with_(b, dyn=dict(krdg_partic=0, krdg_redist=0)),
        "albedo_const": with_(b, shortwave=dict(albedo_type="constant")),
        "update_ocn_f": with_(b, forcing=dict(update_ocn_f=True)),
        "mpond_fresh": with_(level_ponds(), forcing=dict(l_mpond_fresh=True)),
        "restore_sst": with_(b, forcing=dict(restore_sst=True, trestore=1)),
        # the global mesh as a closed basin: the halo gives an open
        # boundary the same zero ghosts, in both packages
        "closed_basin": with_(b, grid=dict(ew_boundary="closed",
                                           ns_boundary="closed")),
    }


# each flag set's base set, and the fields that its option drives (the
# State's "out/<name>" and StepDiag's "diag/<name>"): the option's JAX
# reference differs from its base's in one of them, and the card is held
# against the CPU on them
FLAG_BASE = {name: "frzpnd_cesm" if name == "mpond_fresh" else "bl99"
             for name in flag_option_sets() if name != "bl99"}
FLAG_DRIVES = {
    "mu71": ("diag/fcondtop", "diag/congel", "diag/Tsfc"),
    "kitd0": ("out/aicen", "out/vicen"),
    "hibler_strength": ("diag/strength",),
    "ndtd2": ("out/uvel", "out/vvel", "diag/dardg1dt"),
    "atmbndy_const": ("diag/fsens", "diag/flat", "diag/Tref"),
    "revised_evp": ("out/uvel", "out/vvel"),
    "e_ratio": ("out/stressm", "out/stress12"),
    "turning_angle": ("out/uvel", "out/vvel", "out/strocnxT"),
    "kcatbound2": ("out/aicen", "out/vicen"),
    "rdg_linear": ("diag/dardg1dt", "diag/opening", "out/aicen"),
    "albedo_const": ("diag/albice", "diag/alvdr"),
    "update_ocn_f": ("diag/fresh", "diag/fsalt"),
    "mpond_fresh": ("diag/fresh",),
    "restore_sst": ("out/sst",),
    "closed_basin": ("out/uvel", "out/vvel", "out/aicen"),
}
assert set(FLAG_DRIVES) == set(FLAG_BASE)
# the flag sets on the BL99 model start with the open ocean under air
# below freezing at its freezing point: the 24x16 mesh otherwise forms no
# frazil in three steps, and update_ocn_f acts on the frazil alone
FROZEN_SEA = tuple(n for n in flag_option_sets()
                   if n == "bl99" or FLAG_BASE.get(n) == "bl99")


def dyn_option_sets() -> dict:
    """{name: ModelConfig} of the dynamics and transport options, each on
    the BL99 model: a T-fold seam, EAP alone, on a T-fold seam and with
    the per-category mechred diagnostics on a U-fold seam, upwind
    transport, the transport conservation and monotonicity checks,
    dynamics without transport, and the chunked EVP on one device."""
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
        # K=4 subcycles per margin exchange: two chunks of ndte=8
        "evp_chunked": with_(b, dyn=dict(evp_algorithm="chunked",
                                         evp_chunk=4)),
        "eap_tfold": with_(bl99("tripoleT"),
                           dyn=dict(kdyn=2, remap_kernel="pallas")),
    }


def tracer_option_sets() -> dict:
    """{name: ModelConfig} of the aerosol, brine and skeletal-BGC tracers:
    aerosols under BL99, brine + BGC under mushy thermo, the constant
    piston velocity with a subset of the BGC tracers, the nutrient
    subsets (growth on ammonium alone without silicate, and without
    ammonium or chlorophyll), and every auxiliary tracer at once on a
    U-fold seam (aerosols, brine, BGC, topo ponds, iage, FY and lvl)."""
    b = bl99()
    return {
        "aero": with_(b, tracers=dict(tr_aero=True, n_aero=3)),
        "brine_bgc": with_(b, thermo=MUSHY,
                           tracers=dict(tr_brine=True, skl_bgc=True)),
        "bgc_constant": with_(b, tracers=dict(
            skl_bgc=True, bgc_flux_type="constant", **BGC_SUBSET_OFF)),
        "bgc_ammonium_only": with_(b, tracers=dict(
            skl_bgc=True, tr_bgc_Nit_sk=False, tr_bgc_Sil_sk=False)),
        "bgc_no_ammonium": with_(b, tracers=dict(
            skl_bgc=True, tr_bgc_Am_sk=False, tr_bgc_chl_sk=False)),
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


def option_sets() -> dict:
    """{name: ModelConfig} of every small set."""
    return {**column_option_sets(), **dyn_option_sets(),
            **tracer_option_sets(), **layer_option_sets(),
            **flag_option_sets()}
