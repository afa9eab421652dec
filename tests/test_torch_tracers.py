"""The aerosol, brine and skeletal-BGC tracers of the port against the JAX
package, function by function, in float64 on the CPU (~1e-11 of each
field's scale), with a float32 case per module whose inputs have their
subnormals flushed (XLA's CPU backend reads them as zero, PyTorch does
not).

Inputs are random NumPy arrays from fixed seeds on small batches (6x8
cells, 5 categories) of a registry with every auxiliary tracer:
``update_aerosol``; ``preflushing_changes``, ``remap_to_bio_grid``,
``compute_microS_mushy`` and ``update_hbrine``; ``algal_dyn`` and
``skl_biogeochemistry`` under both piston velocities and with a subset
of the BGC tracers; ``lateral_melt``, ``add_new_ice`` (brine and ocean
BGC), ``zap_small_areas``, ``zap_snow_temperature``, ``cleanup_itd`` and
ridging with the tracers on; the registry and the point diagnostics. The
step-level sets are in tests/test_torch_options.py; the aerosol budget of
whole steps is tests/test_torch_tracer_budget.py.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.config import rect_config as jrect_config
from cice5_tpu.models.dynamics import ridge as jridge
from cice5_tpu.models.thermo import itd as jitd
from cice5_tpu.models.thermo import mushy as jmushy
from cice5_tpu.models.tracers import aerosol as jaero
from cice5_tpu.models.tracers import algae as jalgae
from cice5_tpu.models.tracers import brine as jbrine
from cice5_tpu.state import build_tracer_registry as jbuild
from cice5_tpu_torch import constants as ct
from cice5_tpu_torch import convert
from cice5_tpu_torch.models.dynamics import ridge as tridge
from cice5_tpu_torch.models.thermo import itd as titd
from cice5_tpu_torch.models.tracers import aerosol as taero
from cice5_tpu_torch.models.tracers import algae as talgae
from cice5_tpu_torch.models.tracers import brine as tbrine
from cice5_tpu_torch.state import build_tracer_registry as tbuild
from torch_port_util import assert_close, jit_fast

RTOL = 1e-11
RTOL32 = 2e-5
NY, NX, NCAT, NA = 6, 8, 5, 2
DT = 3600.0
BGC_SUBSET = dict(tr_bgc_C_sk=False, tr_bgc_DMSPp_sk=False,
                  tr_bgc_DMSPd_sk=False, tr_bgc_DMS_sk=False)


def _registries(**tracers):
    """(JAX config, JAX registry, port registry) with every auxiliary
    tracer on (tests/test_conservation_aux.py:32-36), or as overridden."""
    jcfg = jrect_config(ny=NY, nx=NX, dtype="float64")
    on = dict(tr_aero=True, n_aero=NA, tr_iage=True, tr_FY=True,
              tr_lvl=True, tr_pond_topo=True, tr_brine=True, skl_bgc=True)
    jcfg = jcfg.replace(tracers=dataclasses.replace(
        jcfg.tracers, **(on | tracers)))
    ttr = tbuild(convert.config_from_dict(dataclasses.asdict(jcfg)))
    return jcfg, jbuild(jcfg), ttr


def _flush32(a):
    a = np.asarray(a, np.float32)
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, 0.0, a).astype(
        np.float32)


def _pair(d, dtype="float64"):
    """The same NumPy inputs for both packages, in ``dtype`` (float32:
    subnormals flushed)."""
    if dtype == "float32":
        d = {k: _flush32(v) if np.asarray(v).dtype.kind == "f" else v
             for k, v in d.items()}
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in d.items()})


def _cmp(ref, got, names, rtol=RTOL, floor=1e-300):
    for k in names:
        a, b = getattr(ref, k), getattr(got, k)
        if np.asarray(a).dtype == bool:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), k)
        else:
            assert str(b.dtype) == f"torch.{np.asarray(a).dtype}", k
            assert_close(a, b, rtol, k, floor=floor)


def _state(tr, rng, tiny_cat=None):
    """(ncat, ny, nx) state with thermo tracers and every auxiliary tracer
    seeded; a row of empty cells, and category ``tiny_cat`` at puny/2
    where given (a zap candidate)."""
    shp = (NCAT, NY, NX)
    aicen = 0.05 + 0.15 * rng.random(shp)
    aicen[:, 0, :3] = 0.0
    hicen = 0.3 + 2.5 * rng.random(shp)
    if tiny_cat is not None:
        aicen[tiny_cat, 1] = ct.puny / 2.0
    vicen = aicen * hicen
    vsnon = aicen * 0.3 * rng.random(shp)
    trcrn = np.zeros((NCAT, tr.ntrcr, NY, NX))
    trcrn[:, tr.nt_Tsfc] = -20.0 + 19.0 * rng.random(shp)
    nil = tr.nt_sice - tr.nt_qice
    trcrn[:, tr.nt_qice:tr.nt_qice + nil] = \
        -3.2e8 + 0.6e8 * rng.random((NCAT, nil, NY, NX))
    trcrn[:, tr.nt_sice:tr.nt_sice + nil] = \
        1.0 + 8.0 * rng.random((NCAT, nil, NY, NX))
    trcrn[:, tr.nt_qsno] = -1.2e8 + 0.1e8 * rng.random(shp)
    if tr.nt_iage >= 0:
        trcrn[:, tr.nt_iage] = 3e7 * rng.random(shp)
    if tr.nt_FY >= 0:
        trcrn[:, tr.nt_FY] = rng.random(shp)
    if tr.nt_alvl >= 0:
        trcrn[:, tr.nt_alvl] = 0.5 + 0.5 * rng.random(shp)
        trcrn[:, tr.nt_vlvl] = 0.5 + 0.5 * rng.random(shp)
    if tr.nt_apnd >= 0:
        trcrn[:, tr.nt_apnd] = 0.4 * rng.random(shp)
        trcrn[:, tr.nt_hpnd] = 0.3 * rng.random(shp)
        trcrn[:, tr.nt_ipnd] = 0.02 * rng.random(shp)
    if tr.nt_fbri >= 0:
        trcrn[:, tr.nt_fbri] = 0.8 + 0.4 * rng.random(shp)
    for it in range(tr.n_aero):
        a0 = tr.nt_aero + 4 * it
        trcrn[:, a0:a0 + 4] = 1e-8 * rng.random((NCAT, 4, NY, NX))
    for s in tr.nt_bgc:
        trcrn[:, s] = 0.5 + rng.random(shp)
    return dict(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn)


# ------------------------------------------------------------- aerosols

def _aero_inputs(seed):
    """One step's thickness changes on (ncat, ny, nx): snow and ice melt
    (some columns melt out), congelation, snow-ice, snowfall and
    evaporation noise, categories that vanish and empty cells."""
    rng = np.random.default_rng(seed)
    shp = (NCAT, NY, NX)
    u = lambda lo, hi: lo + (hi - lo) * rng.random(shp)
    on = lambda p: rng.random(shp) < p
    aice_old = u(0.0, 0.3) * on(0.85)
    hs_old = u(0.0, 0.4) * on(0.8)
    hi_old = u(0.01, 2.5)
    melts = np.where(on(0.5), hs_old * u(0.0, 1.3), 0.0)
    meltt = np.where(on(0.5), u(0.0, 0.06), 0.0)
    meltt = np.where(on(0.1), hi_old * 1.2, meltt)       # melt-out
    meltb = np.where(on(0.5), u(0.0, 0.05), 0.0)
    congel = np.where(on(0.4), u(0.0, 0.03), 0.0)
    snoice = np.where(on(0.3), np.minimum(u(0.0, 0.02), hs_old * 0.3), 0.0)
    fsnow = np.where(rng.random((NY, NX)) < 0.6,
                     1e-5 * rng.random((NY, NX)), 0.0)
    hs_new = np.maximum(hs_old - melts - snoice * ct.rhoi / ct.rhos
                        + fsnow / ct.rhos * DT + u(-1e-4, 1e-4), 0.0)
    hi_new = np.maximum(hi_old - meltt - meltb + congel + snoice
                        + u(-1e-4, 1e-4), 0.0)
    aicen = np.where(hi_new > 0.0, aice_old * np.where(on(0.1), 0.0, 1.0),
                     0.0)
    return dict(
        dt=DT, meltt=meltt, melts=melts, meltb=meltb, congel=congel,
        snoice=snoice, fsnow=fsnow[None],
        aerosno=1e-8 * rng.random((NA, 2) + shp),
        aeroice=1e-8 * rng.random((NA, 2) + shp),
        aice_old=aice_old, vice_old=aice_old * hi_old,
        vsno_old=aice_old * hs_old, aicen=aicen, vicen=aicen * hi_new,
        vsnon=aicen * hs_new,
        faero_atm=np.stack([np.full((1, NY, NX), 10.0 ** (-13 + k))
                            for k in range(NA)]))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [1, 2])
def test_update_aerosol_matches(seed, dtype):
    kw = _aero_inputs(seed)
    dt = kw.pop("dt")
    J, T = _pair(kw, dtype)
    ref = jaero.update_aerosol(dt, **J, nilyr=4, nslyr=1)
    got = taero.update_aerosol(dt, **T, nilyr=4, nslyr=1)
    _cmp(ref, got, ("aerosno", "aeroice", "faero_ocn"),
         RTOL if dtype == "float64" else RTOL32)
    assert float(got.faero_ocn.max()) > 0.0


def test_faero_default_matches():
    for n in (1, 3, 6):
        np.testing.assert_array_equal(
            np.asarray(jaero.faero_default(n, (NY, NX), jnp.float64)),
            taero.faero_default(n, (NY, NX), torch.float64).numpy())


# ---------------------------------------------------------------- brine

def _brine_thermo(rng):
    shp = (NCAT, NY, NX)
    return dict(aicen=0.05 + 0.2 * rng.random(shp) * (rng.random(shp) > .1),
                meltb=0.02 * rng.random(shp) * (rng.random(shp) > .5),
                meltt=0.03 * rng.random(shp) * (rng.random(shp) > .5),
                congel=0.02 * rng.random(shp) * (rng.random(shp) > .5),
                snoice=0.01 * rng.random(shp) * (rng.random(shp) > .7))


def test_preflushing_changes_matches():
    rng = np.random.default_rng(3)
    shp = (NCAT, NY, NX)
    th = _brine_thermo(rng)
    hin = 0.02 + 2.0 * rng.random(shp)
    kw = dict(th, vicen=th["aicen"] * hin,
              vsnon=th["aicen"] * 0.2 * rng.random(shp),
              hice_old=np.where(rng.random(shp) > 0.1,
                                hin * (0.9 + 0.2 * rng.random(shp)), 0.0),
              fbri=0.8 + 0.4 * rng.random(shp),
              first_ice=(rng.random(shp) > 0.7).astype(np.float64))
    J, T = _pair(kw)
    _cmp(jbrine.preflushing_changes(**J), tbrine.preflushing_changes(**T),
         jbrine.Preflush._fields)


def _profile(rng):
    """Salinity and enthalpy layer profiles (..., nilyr) of mushy ice."""
    shp = (NCAT, NY, NX, 4)
    zSin = 1.0 + 9.0 * rng.random(shp)
    zTin = -15.0 + 13.0 * rng.random(shp)
    zqin = np.array(jmushy.enthalpy_mush(jnp.asarray(zTin),
                                         jnp.asarray(zSin)))
    return zSin, zqin


@pytest.mark.parametrize("case", ["brine_below", "brine_above", "mixed"])
def test_remap_to_bio_grid_matches(case):
    rng = np.random.default_rng(4)
    zSin, _ = _profile(rng)
    shp = (NCAT, NY, NX)
    hice = 0.1 + 2.0 * rng.random(shp)
    f = {"brine_below": 0.7 + 0.25 * rng.random(shp),
         "brine_above": 1.05 + 0.2 * rng.random(shp),
         "mixed": 0.7 + 0.6 * rng.random(shp)}[case]
    bgrid, _, cgrid = jbrine.bio_grids(4, 4)
    J, T = _pair(dict(tr_lyr=zSin, hice=hice, hbr=hice * f))
    ref = jbrine.remap_to_bio_grid(**J, cgrid=cgrid, bgrid_pts=bgrid[:5])
    got = tbrine.remap_to_bio_grid(**T, cgrid=cgrid, bgrid_pts=bgrid[:5])
    assert_close(ref, got, RTOL, case)
    # a linear profile comes back linear on the bio grid
    lin = np.broadcast_to(cgrid, zSin.shape).copy()
    ones = np.ones(shp)
    got = tbrine.remap_to_bio_grid(torch.as_tensor(lin),
                                   torch.as_tensor(ones),
                                   torch.as_tensor(ones), cgrid, bgrid[:5])
    np.testing.assert_allclose(got[..., 1:].numpy(),
                               np.broadcast_to(bgrid[1:5], got[..., 1:]
                                               .shape), atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compute_microS_mushy_matches(dtype):
    rng = np.random.default_rng(5)
    zSin, zqin = _profile(rng)
    shp = (NCAT, NY, NX)
    hice = 0.1 + 2.0 * rng.random(shp)
    # a cold, fresh column: porosity at its floor
    zSin[0, 0, 0] = 0.2
    zqin[0, 0, 0] = np.asarray(jmushy.enthalpy_mush(
        jnp.full(4, -25.0), jnp.full(4, 0.2)))
    kw = dict(zSin=zSin, zqin=zqin, hice_old=hice,
              hbr_old=hice * (0.7 + 0.6 * rng.random(shp)),
              sss=np.full(shp, 34.0), sst=np.full(shp, -1.8))
    J, T = _pair(kw, dtype)
    ref = jbrine.compute_microS_mushy(**J, nblyr=4)
    got = tbrine.compute_microS_mushy(**T, nblyr=4)
    rtol = RTOL if dtype == "float64" else RTOL32
    # kperm (m^2) on its own scale; float32's permeability power law
    # reaches subnormals that only PyTorch keeps: an absolute floor of
    # the smallest normal permeability there
    _cmp(ref, got, [k for k in jbrine.MicroS._fields if k != "kperm"],
         rtol)
    assert_close(ref.kperm, got.kperm, rtol, "kperm",
                 floor=1.0 if dtype == "float64" else 1e-10)
    assert float(got.kperm[0, 0, 0]) < 1e-4 * float(got.kperm.max())


def test_update_hbrine_matches():
    rng = np.random.default_rng(6)
    shp = (NCAT, NY, NX)
    hin = np.where(rng.random(shp) > 0.2, 0.1 + 2.0 * rng.random(shp),
                   0.01 + 0.04 * rng.random(shp))          # thin branch
    hbr = hin * (0.7 + 0.6 * rng.random(shp))
    kw = dict(meltb=0.01 * rng.random(shp), meltt=0.02 * rng.random(shp),
              melts=0.01 * rng.random(shp) * (rng.random(shp) > 0.5),
              hin=hin, hsn=0.3 * rng.random(shp),
              hin_old=hin * (0.95 + 0.1 * rng.random(shp)), hbr_old=hbr,
              dhS_top=0.01 * rng.random(shp),
              dhS_bottom=0.02 * (rng.random(shp) - 0.5),
              kperm=1e-10 * rng.random(shp) * (rng.random(shp) > 0.2),
              zphi_min=0.05 + 0.3 * rng.random(shp))
    J, T = _pair(kw)
    _cmp(jbrine.update_hbrine(DT, **J), tbrine.update_hbrine(DT, **T),
         jbrine.HbrineResult._fields)


# ------------------------------------------------------------------ BGC

def _bgc_inputs(tr, seed):
    rng = np.random.default_rng(seed)
    shp = (NCAT, NY, NX)
    ob = np.stack([np.full((NY, NX), jalgae.OCEAN_BIO_DEFAULT[n])
                   * (0.5 + rng.random((NY, NX))) for n in tr.bgc_names])
    conc = ob[:, None] * jalgae.SK_L / jalgae.PHI_SK \
        * (0.3 + 2.0 * rng.random((tr.nbtrcr,) + shp))
    growth = 0.02 * (rng.random(shp) - 0.5)
    return dict(conc=conc, ocean_bio=ob[:, None],
                aicen=0.2 * rng.random(shp) * (rng.random(shp) > 0.1),
                meltb=np.maximum(-growth, 0.0) * (rng.random(shp) > 0.2),
                congel=np.maximum(growth, 0.0),
                fswthru=np.where(rng.random(shp) > 0.3,
                                 60.0 * rng.random(shp), 0.0),
                first_ice=(rng.random(shp) > 0.8).astype(np.float64))


@pytest.mark.parametrize("subset", [False, True])
def test_algal_dyn_matches(subset):
    _, jtr, ttr = _registries(**(BGC_SUBSET if subset else {}))
    kw = _bgc_inputs(jtr, 7)
    J, T = _pair(dict(fswthru=kw["fswthru"], conc=kw["conc"]))
    _cmp(jalgae.algal_dyn(DT, jtr, **J), talgae.algal_dyn(DT, ttr, **T),
         ("react", "grow_N"))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("flux_type", ["Jin2006", "constant"])
def test_skl_biogeochemistry_matches(flux_type, subset, dtype):
    _, jtr, ttr = _registries(**(BGC_SUBSET if subset else {}))
    J, T = _pair(_bgc_inputs(jtr, 8), dtype)
    ref = jalgae.skl_biogeochemistry(DT, jtr, **J, flux_type=flux_type)
    got = talgae.skl_biogeochemistry(DT, ttr, **T, flux_type=flux_type)
    _cmp(ref, got, ("conc", "flux_bio", "grow_N"),
         RTOL if dtype == "float64" else RTOL32)
    assert float(got.grow_N.max()) > 0.0


def test_default_ocean_bio_matches():
    for sub in ({}, BGC_SUBSET):
        _, jtr, ttr = _registries(**sub)
        np.testing.assert_array_equal(
            np.asarray(jalgae.default_ocean_bio(jtr, (NY, NX), jnp.float64)),
            talgae.default_ocean_bio(ttr, (NY, NX), torch.float64).numpy())


# ------------------------------------------------ ITD and ridging bookkeeping

@pytest.fixture(scope="module")
def reg():
    jcfg, jtr, ttr = _registries()
    hin_max = jitd.category_bounds(jcfg.ncat, jcfg.kitd, jcfg.kcatbound)
    return dict(jcfg=jcfg, jtr=jtr, ttr=ttr, hin_max=hin_max)


def test_registry_matches(reg):
    for sub in ({}, BGC_SUBSET, dict(tr_aero=False), dict(n_aero=6)):
        _, jtr, ttr = _registries(**sub)
        assert dataclasses.asdict(jtr) == dataclasses.asdict(ttr)
        assert (jtr.nbtrcr, jtr.n_aero) == (ttr.nbtrcr, ttr.n_aero)


def test_lateral_melt_with_tracers_matches(reg):
    s = _state(reg["jtr"], np.random.default_rng(9))
    rside = np.random.default_rng(10).uniform(0.0, 0.1, (NY, NX))
    J, T = _pair(dict(s, rside=rside))
    ref = jitd.lateral_melt(DT, reg["jtr"], 7, 1, **J, tr_pond_topo=True)
    got = titd.lateral_melt(DT, reg["ttr"], 7, 1, **T, tr_pond_topo=True)
    _cmp(ref, got, ("aicen", "vicen", "vsnon", "fresh", "fsalt", "fhocn",
                    "meltl", "dfpond", "dfaero", "dflux_bio"))
    assert got.dfaero.shape == (NA, NY, NX)
    assert float(got.dflux_bio.min()) > 0.0 or float(
        got.dflux_bio.max()) > 0.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("frz", [5.0, 400.0])
def test_add_new_ice_with_tracers_matches(reg, frz, dtype):
    """Frazil into category 1 (open water) and spread over the categories
    (400 W/m^2 on nearly closed ice): the brine volume, the ice-aerosol
    dilution and the BGC uptake from the ocean."""
    s = _state(reg["jtr"], np.random.default_rng(11))
    jtr, ttr = reg["jtr"], reg["ttr"]
    rng = np.random.default_rng(12)
    aicen = s["aicen"] * (1.0 if frz < 100 else 1.2)
    aice = aicen.sum(0)
    frzmlt = np.full((NY, NX), frz)
    frzmlt[:, ::3] = -20.0
    ob = np.stack([np.full((NY, NX), jalgae.OCEAN_BIO_DEFAULT[n])
                   * (0.5 + rng.random((NY, NX))) for n in jtr.bgc_names])
    kw = dict(aicen=aicen, vicen=s["vicen"], trcrn=s["trcrn"], aice=aice,
              aice0=np.clip(1.0 - aice, 0.0, None), frzmlt=frzmlt,
              Tf=np.full((NY, NX), -1.836), sss=np.full((NY, NX), 34.0),
              ocean_bio=ob)
    J, T = _pair(kw, dtype)
    opts = dict(tr_FY=True, tr_lvl=True, tr_iage=True, ktherm=2,
                tr_brine=True, initbio_frac=0.8)
    ref = jitd.add_new_ice(DT, jtr, reg["hin_max"], 7, **J,
                           salinz=np.zeros(7), **opts)
    got = titd.add_new_ice(DT, ttr, reg["hin_max"], 7, **T,
                           salinz=np.zeros(7), **opts)
    _cmp(ref, got, ("aicen", "vicen", "trcrn", "frazil", "dfresh",
                    "dfsalt", "flux_bio"),
         RTOL if dtype == "float64" else RTOL32, floor=1e-10)
    assert float(got.flux_bio.min()) < 0.0


def test_zap_small_areas_with_tracers_matches(reg):
    """A zapped category and aice > 1 renormalized: the aerosol, BGC and
    pond loads leave for the ocean."""
    s = _state(reg["jtr"], np.random.default_rng(13), tiny_cat=2)
    s["aicen"][:, 3, 4] = 0.26                     # aice = 1.3
    J, T = _pair(s)
    ref = jitd.zap_small_areas(DT, reg["jtr"], 7, 1, **J, tr_pond_topo=True)
    got = titd.zap_small_areas(DT, reg["ttr"], 7, 1, **T, tr_pond_topo=True)
    _cmp(ref, got, ("aicen", "vicen", "vsnon", "trcrn", "dfresh", "dfsalt",
                    "dfhocn", "dfpond", "dfaero", "dflux_bio", "zapped"))
    assert float(got.dfaero.max()) > 0.0 and float(got.dflux_bio.max()) > 0


def test_zap_snow_temperature_with_tracers_matches(reg):
    s = _state(reg["jtr"], np.random.default_rng(14))
    trcrn = s["trcrn"].copy()
    trcrn[1, reg["jtr"].nt_qsno, 3, 2] = -1.0e6       # warm snow to zap
    trcrn[3, reg["jtr"].nt_qsno, 4, 5] = -1.0e6
    J, T = _pair(dict(aicen=s["aicen"], vsnon=s["vsnon"], trcrn=trcrn))
    ref = jitd.zap_snow_temperature(DT, reg["jtr"], 1, **J)
    got = titd.zap_snow_temperature(DT, reg["ttr"], 1, **T)
    for k, a, b in zip(("vsnon", "trcrn", "dfresh", "dfhocn", "dfaero"),
                       ref, got):
        assert_close(a, b, RTOL, k)
    assert float(got[4].max()) > 0.0


def test_cleanup_itd_with_tracers_matches(reg):
    """rebin across the category bounds, the snow-temperature zap and the
    small-area zap with the tracers on."""
    s = _state(reg["jtr"], np.random.default_rng(15), tiny_cat=1)
    vicen = s["vicen"] * np.array([2.5, 0.3, 1.0, 1.7, 1.0])[:, None, None]
    trcrn = s["trcrn"].copy()
    trcrn[1, reg["jtr"].nt_qsno, 3, 2] = -1.0e6
    J, T = _pair(dict(s, vicen=vicen, trcrn=trcrn))
    ref = jitd.cleanup_itd(DT, reg["jtr"], reg["hin_max"], 7, 1, **J,
                           tr_pond_topo=True)
    got = titd.cleanup_itd(DT, reg["ttr"], reg["hin_max"], 7, 1, **T,
                           tr_pond_topo=True)
    _cmp(ref, got, ("aicen", "vicen", "vsnon", "trcrn", "dfresh", "dfsalt",
                    "dfhocn", "dfpond", "dfaero", "dflux_bio", "zapped"),
         floor=1e-6)


@pytest.mark.parametrize("closing", ["convergent", "shear"])
def test_ridge_with_aerosols_and_bgc_matches(reg, closing):
    s = _state(reg["jtr"], np.random.default_rng(16))
    s["aicen"][:, 0, :3] = 0.01
    aice0 = np.clip(1.0 - s["aicen"].sum(0), 0.0, None)
    conv = np.full((NY, NX), 2e-6 if closing == "convergent" else 0.0)
    J, T = _pair(dict(s, aice0=aice0, rdg_conv=conv,
                      rdg_shear=np.full((NY, NX), 4e-6)))
    if "jridge" not in reg:
        reg["jridge"] = jit_fast(functools.partial(
            jridge.ridge_ice, DT, reg["jtr"], reg["hin_max"], 7, 1,
            tr_pond_topo=True))
    ref = reg["jridge"](**J)
    got = tridge.ridge_ice(DT, reg["ttr"], reg["hin_max"], 7, 1, **T,
                           tr_pond_topo=True)
    _cmp(ref, got, ("aicen", "vicen", "vsnon", "trcrn", "fresh", "fhocn",
                    "dfpond", "faero_ocn", "dflux_bio"), floor=1e-10)
    assert float(got.faero_ocn.max()) > 0.0
    assert float(got.dflux_bio.max()) > 0.0


# ------------------------------------------------------ point diagnostics

def test_point_diagnostics_match():
    """hbrine_diags and bgc_diags print the JAX package's lines."""
    import torch_option_sets as O
    from cice5_tpu.io import diagnostics as jdiag
    from cice5_tpu.state import State as JState
    from cice5_tpu_torch.io import diagnostics as tdiag
    from cice5_tpu_torch.grid import popgrid_np
    from test_torch_options import port_inputs
    import torch_port_util as U
    from cice5_tpu.grid import popgrid_np as jpopgrid
    name = "tracers_all"
    cfg = O.option_sets()[name]
    st, _ = port_inputs(O.load_reference(name))
    tr = tbuild(cfg)
    jcfg = U.jax_config(cfg)
    grid = popgrid_np(cfg, *O.grid_arrays(), device="cpu")
    jgrid = jpopgrid(jcfg, *O.grid_arrays())
    js = U.jax_obj(JState, st)
    pts = ([80.0, 70.0], [10.0, 200.0])
    assert tdiag.hbrine_diags(st, grid, tr, cfg.nilyr, *pts) == \
        jdiag.hbrine_diags(js, jgrid, jbuild(jcfg), cfg.nilyr, *pts)
    ob = {n: torch.full((O.NY, O.NX), 0.5) for n in tr.bgc_names}
    assert tdiag.bgc_diags(st, grid, tr, *pts, ocean_bio=ob,
                           flux_bio=ob) == \
        jdiag.bgc_diags(js, jgrid, jbuild(jcfg), *pts,
                        ocean_bio={k: v.numpy() for k, v in ob.items()},
                        flux_bio={k: v.numpy() for k, v in ob.items()})
    assert "inactive" in tdiag.bgc_diags(
        st, grid, tbuild(O.option_sets()["gx3"]), *pts)


def test_deposition_and_ocean_bio_reach_the_step():
    """A JAX Forcing's faero_atm and ocean_bio come through convert into
    the port's Forcing, and the step reads them: the aerosol and BGC sets
    step the same as the JAX package with them given (here the defaults,
    written out) and differently with them changed."""
    import torch_option_sets as O
    from test_torch_options import port_inputs, port_model
    name = "tracers_all"
    ref = O.load_reference(name)
    m = port_model(name)
    st, f = port_inputs(ref)
    tr = m.tr
    arrays = O.part(ref, "forcing")
    fa = np.asarray(jaero.faero_default(tr.n_aero, (O.NY, O.NX),
                                        jnp.float64))
    ob = np.asarray(jalgae.default_ocean_bio(tr, (O.NY, O.NX), jnp.float64))
    given = convert.forcing_from_arrays(
        dict(arrays, faero_atm=fa, ocean_bio=ob), device="cpu")
    assert given.faero_atm.shape == (tr.n_aero, O.NY, O.NX)
    assert given.ocean_bio.shape == (tr.nbtrcr, O.NY, O.NX)
    assert given.to("cpu", dtype=torch.float32).ocean_bio.dtype == \
        torch.float32
    s0, d0 = m.step(st, f)
    s1, d1 = m.step(st, given)
    assert torch.equal(s0.trcrn, s1.trcrn)
    assert torch.equal(d0.flux_bio, d1.flux_bio)
    s2, d2 = m.step(st, given.replace(faero_atm=given.faero_atm * 10.0,
                                      ocean_bio=given.ocean_bio * 2.0))
    a0 = tr.nt_aero
    assert not torch.equal(s2.trcrn[:, a0], s0.trcrn[:, a0])
    assert not torch.equal(d2.flux_bio, d0.flux_bio)
