"""The option sets of tests/test_torch_options.py and their JAX reference.

Each set is one configuration of the column physics or the grid that the
port runs apart from the others (``driver/model.py:check_supported``):
gx3's and tp1's physics on a displaced-pole and a tripole grid, the BL99
+ CCSM3 model on a tripole seam, mushy thermo without dEdd, dEdd without
ponds, each of iage, FY and lvl alone, CESM and topographic ponds under
BL99 and mushy thermo, the CESM refreezing of level ponds, zero-layer
thermo, and the coupler's surface fluxes (calc_Tsfc=False) under BL99
and mushy thermo; and the dynamics and transport options (``DYN_SETS``):
the BL99 model on a T-fold seam, EAP rheology alone, on a T-fold seam
and with the per-category mechred diagnostics on a U-fold seam, upwind
transport, the transport conservation and monotonicity checks,
dynamics without transport, and the chunked EVP on one device; and the
aerosol, brine and skeletal-BGC
tracers (``TRACER_SETS``); and CESM2's column of 8 ice and 3 snow
layers under mushy and under BL99 thermo (``LAYER_SETS``); and the
namelist options no other set turns on, each the BL99 model (the
``bl99`` set) with one option changed (``FLAG_SETS``: MU71
conductivity, the delta-function ITD, Hibler strength, ndtd=2, the
constant boundary layer, the revised EVP, e_ratio, the ocean turning
angle, kcatbound=2, linear ridging, constant albedos, update_ocn_f,
l_mpond_fresh on the level ponds, SST restoring, closed boundaries in
place of the cyclic east-west and the open north one; those on the
BL99 model start with the open ocean under air below freezing at its
freezing point, ``make_reference_flags``, so that frazil forms). The
definitions are ``cice5_tpu_torch/small_sets.py``'s, which
chip_smoke.py runs too. All run on the 24x16 synthetic global mesh of
test_torch_parity_step.py, ndte=8, float64, with rain on the ice (a
pond's "no fresh water" branch then never rests on rounding noise).

The reference is the JAX package's step: the initial state with ponds
and ages seeded from a fixed generator, one warm-up step, then two steps,
recorded in OPTIONS_REFERENCE under a SHA-256 of what it depends on (one
jitted JAX step costs 20-60 s to compile on a CPU). The dynamics sets
also record the EAP structure tensor, the EAP, check and mechred
diagnostics, and run the JAX step with the port's T-fold metric ghosts
(``tfold_region_metrics``: the JAX package's own raise there); the
tracer sets seed the aerosol concentrations too and record first_ice and
the aerosol and BGC fluxes, primary production and algal growth
(``make_reference_tracers``):
``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_option_sets.py
[set ...]`` rewrites it (every set, or the sets named). Importing this
module imports no JAX, so the GPU tests read the same states.
"""
import dataclasses
from pathlib import Path

import numpy as np

from cice5_tpu_torch import small_sets as S
from cice5_tpu_torch.small_sets import (
    DYN_STATE, FLAG_BASE, FLAG_DRIVES, FROZEN_SEA, TRACER_DIAG, TRACER_STATE,
    dyn_option_sets, flag_option_sets, layer_option_sets, tracer_option_sets)
import torch_port_util as U

OPTIONS_REFERENCE = Path(__file__).with_name("test_torch_options.npz")
NY, NX, NDTE = U.PARITY_NY, U.PARITY_NX, U.PARITY_NDTE
assert (NY, NX, NDTE) == (S.NY, S.NX, S.NDTE)
ISTEP = U.PARITY_ISTEP
NSTEPS = 2
SEED = 23
# the coupler's per-category surface fluxes of the calc_Tsfc=False sets
# (W/m^2): fsurfn_f = fcondtopn_f, a surface in conductive balance
CPL_FLUX = dict(fsurf=(-40.0, -5.0), flat=(-6.0, 0.0), fsens=(-15.0, 5.0))

STATE = ("aicen", "vicen", "vsnon", "uvel", "vvel", "sst", "frzmlt",
         "strocnxT", "strocnyT", "iceumask", "scale_factor")
STRESS = ("stressp", "stressm", "stress12")
DIAG = ("aice", "vice", "vsno", "fsens", "flat", "flwout", "evap", "fresh",
        "fsalt", "fhocn", "fswthru", "fswabs", "strairxT", "meltt", "melts",
        "meltb", "congel", "snoice", "frazil", "meltl", "dardg1dt",
        "dvirdgdt", "divu", "shear", "alvdr", "alidf", "Tsfc", "strength",
        "Tref", "opening", "daidtd", "dvidtd", "albice", "albsno", "albpnd",
        "fswint", "fpond", "dagedtt", "dagedtd", "snowfracn", "fsurf",
        "fcondtop", "strintx", "strinty", "prs_sig", "state_bad",
        "therm_converged")
DIAG_EVP = ("strintx", "strinty", "prs_sig")
DIAG_FLAGS = ("state_bad", "therm_converged")


# {name: the port's ModelConfig of the set}
option_sets = S.option_sets


# the extra fields the dynamics sets record (make_reference_dyn): the
# state's DYN_STATE and these
DYN_DIAG = ("e11", "e12", "e22", "yieldstress11", "yieldstress12",
            "yieldstress22", "rdgn", "transport_conserv_err",
            "transport_mono_bad")
DYN_SETS = tuple(dyn_option_sets())

# the tracer sets record TRACER_STATE and TRACER_DIAG too
# (make_reference_tracers)
TRACER_SETS = tuple(tracer_option_sets())

# the sets with more than one snow layer
LAYER_SETS = tuple(layer_option_sets())

# the namelist options, each set with one option changed from its base
# set (FLAG_BASE), the recorded fields that option drives (FLAG_DRIVES):
# its reference must differ from the base's in one of them
# (test_flag_reference_shows_its_option_at_work), and the sets that start
# from the frozen open sea (FROZEN_SEA, ``make_reference_flags``)
FLAG_SETS = tuple(flag_option_sets())


def grid_arrays():
    """(ULAT, ULON, HTN, HTE, ANGLE, KMT): the parity test mesh, whose
    land touches the tripole seam."""
    return U.parity_grid_arrays()


def seed_state(arrays: dict, cfg, tr) -> dict:
    """The initial State's arrays with the ponds, ages and first-year area
    seeded where there is ice; zero-layer columns keep their latent
    enthalpies."""
    rng = np.random.default_rng(SEED)
    trc = np.array(arrays["trcrn"])
    has = np.asarray(arrays["aicen"]) > 0
    u = lambda lo, hi: np.where(has, rng.uniform(lo, hi, has.shape), 0.0)
    if tr.nt_apnd >= 0:
        trc[:, tr.nt_apnd] = u(0.1, 0.5)
        trc[:, tr.nt_hpnd] = u(0.02, 0.3)
    if tr.nt_ipnd >= 0:
        trc[:, tr.nt_ipnd] = u(0.0, 0.02)
    if tr.nt_iage >= 0:
        trc[:, tr.nt_iage] = u(0.0, 3e7)
    if tr.nt_FY >= 0:
        trc[:, tr.nt_FY] = np.where(has, 1.0, 0.0)
    return dict(arrays, trcrn=trc)


def coupler_fluxes(cfg) -> dict:
    """The per-category surface fluxes of a calc_Tsfc=False set
    (ncat, ny, nx), from a fixed generator; {} for the other sets."""
    if cfg.thermo.calc_Tsfc:
        return {}
    rng = np.random.default_rng(SEED + 1)
    shp = (cfg.ncat, NY, NX)
    fs = rng.uniform(*CPL_FLUX["fsurf"], shp)
    return dict(fsurfn_f=fs, fcondtopn_f=fs.copy(),
                flatn_f=rng.uniform(*CPL_FLUX["flat"], shp),
                fsensn_f=rng.uniform(*CPL_FLUX["fsens"], shp))


def make_reference(name) -> dict:
    """Run the JAX package on set ``name``: {"in/<field>": the warmed-up
    state, "forcing/<field>", "out/<field>": the state after NSTEPS steps,
    "diag/<field>": the last step's diagnostics}."""
    from functools import partial
    import jax.numpy as jnp
    from cice5_tpu.driver.model import Model as JModel
    from cice5_tpu.driver.step import step as jstep_fn
    from cice5_tpu.grid import popgrid_np as jpopgrid

    cfg = U.jax_config(option_sets()[name])
    jm = JModel(cfg, grid=jpopgrid(cfg, *grid_arrays()))
    st0 = jm.init_state()
    arrays = seed_state({f.name: np.asarray(getattr(st0, f.name))
                         for f in dataclasses.fields(st0)}, cfg, jm.tr)
    st0 = st0.replace(trcrn=jnp.asarray(arrays["trcrn"]))
    f0 = jm.forcing_at(ISTEP)
    f0 = f0.replace(frain=jnp.full_like(f0.frain, U.RAIN), **{
        k: jnp.asarray(v) for k, v in coupler_fluxes(cfg).items()})
    jstep = U.jit_fast(partial(jstep_fn, cfg=jm.cfg, tr=jm.tr, topo=jm.topo,
                               hin_max=jm.hin_max, salinz=jm.salinz))
    s = jstep(st0, f0, jm.grid)[0]
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if v is not None:
            out[f"in/{f.name}"] = np.asarray(v)
    for f in dataclasses.fields(f0):
        v = getattr(f0, f.name)
        if v is not None:
            out[f"forcing/{f.name}"] = np.asarray(v)
    for _ in range(NSTEPS):
        s, d = jstep(s, f0, jm.grid)
    for k in STATE + STRESS + ("trcrn",):
        out[f"out/{k}"] = np.asarray(getattr(s, k))
    for k in DIAG:
        out[f"diag/{k}"] = np.asarray(getattr(d, k))
    return out


def tfold_region_metrics(jevp_module):
    """The JAX package's ``_region_metrics`` with the T-fold ghosts the
    port defines (``cice5_tpu_torch/models/dynamics/evp.py``): on
    ``tripoleT`` the ghost row of a one-sided coefficient is the partner's
    fold image of the top row, sign flipped, the top row as it is; the
    JAX package's ``extend`` raises there (no partner on an on-fold
    staggering). Every other topology and metric as the JAX package."""
    import jax.numpy as jnp
    from cice5_tpu.parallel import Topology as JTopology, extend as jextend
    orig = jevp_module._region_metrics

    def region_metrics(grid, topo, names):
        if topo.ns != "tripoleT":
            return orig(grid, topo, names)
        out = orig(grid, topo, [k for k in names
                                if k not in jevp_module._METRIC_FOLD])
        for k in names:
            if k not in jevp_module._METRIC_FOLD:
                continue
            pname, sgn = jevp_module._METRIC_FOLD[k]
            E = jextend(getattr(grid, k), JTopology(ew=topo.ew, ns="open"))
            # ghost(i) = sgn * partner(ny-1, (nx - i) mod nx)
            g = sgn * jnp.roll(getattr(grid, pname)[-1, ::-1], 1)
            E = E.at[-1].set(jnp.concatenate([g[-1:], g, g[:1]]))
            out[k] = E[1:, 1:]
        return {k: out[k] for k in names}
    return region_metrics


def make_reference_dyn(name) -> dict:
    """``make_reference`` of a dynamics set: the same recipe with
    DYN_STATE and DYN_DIAG recorded too, run with the T-fold metric ghosts
    of ``tfold_region_metrics`` and the Pallas remap kernel in interpret
    mode (the CPU has no TPU)."""
    global STATE, DIAG
    from functools import partial
    from cice5_tpu.models.dynamics import eap as jeap, evp as jevp
    from cice5_tpu.models.transport import remap as jremap
    saved = (STATE, DIAG, jevp._region_metrics, jeap._region_metrics,
             jremap.remap_fields_batch)
    patched = tfold_region_metrics(jevp)
    STATE, DIAG = STATE + DYN_STATE, DIAG + DYN_DIAG
    jevp._region_metrics = jeap._region_metrics = patched
    jremap.remap_fields_batch = partial(saved[-1], interpret=True)
    try:
        return make_reference(name)
    finally:
        (STATE, DIAG, jevp._region_metrics, jeap._region_metrics,
         jremap.remap_fields_batch) = saved


def seed_tracer_state(arrays: dict, cfg, tr, base=None) -> dict:
    """``seed_state`` (or ``base``) with the aerosol concentrations of
    every layer also seeded where there is ice (kg/m^3), so that melt has
    aerosol to scavenge into the ocean from the first step."""
    arrays = (base or seed_state)(arrays, cfg, tr)
    rng = np.random.default_rng(SEED + 2)
    trc = np.array(arrays["trcrn"])
    has = np.asarray(arrays["aicen"]) > 0
    for it in range(cfg.tracers.n_aero if cfg.tracers.tr_aero else 0):
        for k in range(4):
            trc[:, tr.nt_aero + 4 * it + k] = np.where(
                has, rng.uniform(1e-9, 1e-8, has.shape), 0.0)
    return dict(arrays, trcrn=trc)


def make_reference_tracers(name) -> dict:
    """``make_reference`` of a tracer set: the same recipe from
    ``seed_tracer_state``, with TRACER_STATE and TRACER_DIAG recorded
    too."""
    global STATE, DIAG, seed_state
    from functools import partial
    saved = (STATE, DIAG, seed_state)
    STATE, DIAG = STATE + TRACER_STATE, DIAG + TRACER_DIAG
    seed_state = partial(seed_tracer_state, base=saved[2])
    try:
        return make_reference(name)
    finally:
        STATE, DIAG, seed_state = saved


def freeze_open_sea(st, forcing, grid):
    """The JAX State ``st`` with the SST at the freezing point in the
    ocean cells whose air is below it."""
    import jax.numpy as jnp
    cold = (forcing.Tair < 273.15 + forcing.Tf) & grid.tmask
    return st.replace(sst=jnp.where(cold, forcing.Tf, st.sst))


def make_reference_flags(name) -> dict:
    """``make_reference`` of a flag set: the same recipe, from an initial
    state whose open ocean under air below freezing starts at its
    freezing point for the sets of FROZEN_SEA."""
    from cice5_tpu.driver.model import Model as JModel
    orig = JModel.init_state

    def init_state(self, *args, **kw):
        st = orig(self, *args, **kw)
        if name not in FROZEN_SEA:
            return st
        return freeze_open_sea(st, self.forcing_at(ISTEP), self.grid)

    JModel.init_state = init_state
    try:
        return make_reference(name)
    finally:
        JModel.init_state = orig


def record(name) -> dict:
    """The reference of any set, as ``__main__`` records it."""
    if name in DYN_SETS:
        return make_reference_dyn(name)
    if name in TRACER_SETS:
        return make_reference_tracers(name)
    if name in FLAG_SETS:
        return make_reference_flags(name)
    return make_reference(name)


def reference_key(name) -> str:
    """SHA-256 of what set ``name``'s reference depends on: every source
    file of the JAX package, the set's configuration and the recipe."""
    import hashlib
    import inspect
    import json
    import pathlib
    from cice5_tpu_torch import grid as tgrid
    h = hashlib.sha256()
    root = pathlib.Path(__file__).resolve().parents[1] / "cice5_tpu"
    for path in sorted(root.rglob("*.py")):
        h.update(path.relative_to(root).as_posix().encode())
        h.update(path.read_bytes())
    h.update(json.dumps(dataclasses.asdict(option_sets()[name]),
                        sort_keys=True, default=repr).encode())
    for fn in (grid_arrays, U.parity_grid_arrays, tgrid.synth_global_arrays,
               seed_state, coupler_fluxes, make_reference):
        h.update(inspect.getsource(fn).encode())
    h.update(repr((NY, NX, NDTE, ISTEP, NSTEPS, SEED, CPL_FLUX, U.RAIN,
                   STATE, STRESS, DIAG)).encode())
    if name in DYN_SETS:
        for fn in (tfold_region_metrics, make_reference_dyn):
            h.update(inspect.getsource(fn).encode())
        h.update(repr((DYN_STATE, DYN_DIAG)).encode())
    if name in TRACER_SETS:
        for fn in (seed_tracer_state, make_reference_tracers):
            h.update(inspect.getsource(fn).encode())
        h.update(repr((TRACER_STATE, TRACER_DIAG)).encode())
    if name in FLAG_SETS:
        for fn in (freeze_open_sea, make_reference_flags):
            h.update(inspect.getsource(fn).encode())
        h.update(repr(name in FROZEN_SEA).encode())
    return h.hexdigest()


def load_reference(name) -> dict:
    """The recorded arrays of set ``name`` (prefix stripped), with its key
    under "key"."""
    with np.load(OPTIONS_REFERENCE) as z:
        n = len(name) + 1
        return {k[n:]: z[k] for k in z.files if k.startswith(name + "/")}


def part(ref: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


if __name__ == "__main__":
    # python tests/torch_option_sets.py [set ...]: rewrite the reference of
    # every set, or of the sets named, from the JAX package in float64
    import sys
    import jax
    jax.config.update("jax_enable_x64", True)
    names = sys.argv[1:] or sorted(option_sets())
    old = {}
    if OPTIONS_REFERENCE.exists():
        with np.load(OPTIONS_REFERENCE) as z:
            old = {k: z[k] for k in z.files
                   if k.split("/", 1)[0] in option_sets()}
    for name in names:
        old = {k: v for k, v in old.items()
               if k.split("/", 1)[0] != name}
        old[f"{name}/key"] = np.array(reference_key(name))
        old.update({f"{name}/{k}": v for k, v in record(name).items()})
        print(f"recorded {name}", flush=True)
    np.savez_compressed(OPTIONS_REFERENCE, **old)
    print(f"wrote {OPTIONS_REFERENCE}")
