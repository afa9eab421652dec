"""The ported slice as a whole vs the JAX package: two steps of ``Model``
(the BL99 + CCSM3 configuration on a 12x16 rectangular grid, ndte=8,
float64) from one state carried across by ``convert.py``.

The JAX steps are recorded in test_torch_step.npz (``make_reference``,
under a SHA-256 of the JAX package's sources, the configuration and the
recipe): one jitted JAX step compiles for ~20 s here even with XLA's
backend optimisations off (torch_port_util.jit_fast), and beside other
test workers such a compile passes 2 minutes and XLA's slow-compile
alarm writes into the test log. The test marked slow recomputes it:
``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_step.py``
rewrites it. Tolerances: the prognostic state and the diagnostics agree
to 3e-8 x scale (EVP subcycling from the zero-stress start amplifies
last-bit differences of the two backends by ~1e3-1e6); the stress state
and the stress divergence, one amplification further (c0 = strength /
max(Delta, tinyarea)), to 1e-5 x scale. A float32 run of the port from
the same state is held to dtype-aware bounds.
"""
import dataclasses
import hashlib
import inspect
import json
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from cice5_tpu.config import (DynConfig, ForcingConfig, GridConfig,
                              ModelConfig, TimeConfig)
from cice5_tpu_torch import convert
from cice5_tpu_torch.driver.model import Model
from torch_port_util import assert_close, jit_fast

NY, NX, NDTE = 12, 16, 8
REFERENCE = Path(__file__).with_name("test_torch_step.npz")


def _jcfg(dtype="float64"):
    return ModelConfig(
        grid=GridConfig(nx=NX, ny=NY, dx_const=40000.0, dy_const=40000.0,
                        lat0=55.0),
        dyn=DynConfig(kdyn=1, ndte=NDTE, advection="remap", kstrength=1),
        forcing=ForcingConfig(oceanmixed_ice=True, natmiter=5),
        time=TimeConfig(dt=3600.0), dtype=dtype, accum_dtype=dtype)


def _arrays(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.array(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def make_reference() -> dict:
    """Run the JAX package under ``_jcfg``: the initial state (ice on every
    ocean cell) and two jitted steps. Returns {"st0/<field>": the initial
    state, "f0/<field>": the forcing, "grid/<field>": the grid,
    "js2/<field>": the state after two steps, "jd2/<field>": the
    diagnostics of the second}."""
    import jax
    from cice5_tpu.driver.model import Model as JModel
    from cice5_tpu.driver.step import step as jstep_fn
    jm = JModel(_jcfg())
    st0 = jm.init_state(ice_mask=np.asarray(jm.grid.tmask))
    f0 = jm.forcing_at(0)
    jstep = jit_fast(partial(jstep_fn, cfg=jm.cfg, tr=jm.tr, topo=jm.topo,
                             hin_max=jm.hin_max, salinz=jm.salinz))
    js1, _ = jstep(st0, f0, jm.grid)
    js2, jd2 = jstep(js1, f0, jm.grid)
    jax.block_until_ready(js2.vicen)
    out = {}
    for prefix, arrays in (("st0", _arrays(st0)), ("f0", _arrays(f0)),
                           ("grid", _arrays(jm.grid)), ("js2", _arrays(js2)),
                           ("jd2", {k: np.asarray(v) for k, v in
                                    jd2._asdict().items()})):
        out.update({f"{prefix}/{k}": v for k, v in arrays.items()
                    if v is not None})
    return out


def reference_key() -> str:
    """SHA-256 of what the recorded reference depends on: every source
    file of the JAX package, the configuration and the recipe."""
    h = hashlib.sha256()
    root = Path(__file__).resolve().parents[1] / "cice5_tpu"
    for path in sorted(root.rglob("*.py")):
        h.update(path.relative_to(root).as_posix().encode())
        h.update(path.read_bytes())
    h.update(json.dumps(dataclasses.asdict(_jcfg()), sort_keys=True,
                        default=repr).encode())
    for fn in (make_reference, _arrays):
        h.update(inspect.getsource(fn).encode())
    return h.hexdigest()


def _part(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def runs():
    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files if k != "key"}
    st0, f0 = _part(ref, "st0"), _part(ref, "f0")
    cfg = convert.config_from_dict(dataclasses.asdict(_jcfg()))
    m = Model(cfg, device="cpu")
    ts0 = convert.state_from_arrays(st0, device="cpu")
    tf0 = convert.forcing_from_arrays(f0, device="cpu")
    ts2, td2 = m.rollout(ts0, tf0, 2)
    return dict(grid=_part(ref, "grid"), st0=st0, f0=f0,
                js2=_part(ref, "js2"), jd2=_part(ref, "jd2"), m=m,
                ts2=convert.to_numpy(ts2), td2=convert.to_numpy(td2))


STATE = ("aicen", "vicen", "vsnon", "trcrn", "uvel", "vvel", "sst",
         "frzmlt", "strocnxT", "strocnyT", "iceumask", "scale_factor")
DIAG = ("aice", "vice", "vsno", "fsens", "flat", "flwout", "evap", "fresh",
        "fsalt", "fhocn", "fswthru", "fswabs", "strairxT", "meltt", "meltb",
        "congel", "snoice", "frazil", "meltl", "dardg1dt", "dvirdgdt",
        "divu", "shear", "alvdr", "Tsfc", "strength", "Tref", "opening",
        "daidtd", "dvidtd")


@pytest.mark.parametrize("name", STATE)
def test_state_after_two_steps_matches(runs, name):
    assert_close(runs["js2"][name], runs["ts2"][name], 3e-8, name, floor=1.0)


@pytest.mark.parametrize("name", ("stressp", "stressm", "stress12"))
def test_stress_after_two_steps_matches(runs, name):
    assert_close(runs["js2"][name], runs["ts2"][name], 1e-5, name, floor=1.0)


@pytest.mark.parametrize("name", DIAG)
def test_diag_of_last_step_matches(runs, name):
    assert_close(runs["jd2"][name], runs["td2"][name], 3e-8, name, floor=1.0)


def test_onset_dates_match(runs):
    """Melt/freeze onset dates switch on any positive melt or growth, so
    they are compared where that signal is well above rounding."""
    jd, js, ts = runs["jd2"], runs["js2"], runs["ts2"]
    melt = np.asarray(jd["meltt"]) > 1e-12
    frz = np.asarray(jd["frazil"]) + np.asarray(jd["congel"]) > 1e-12
    np.testing.assert_array_equal(js["mlt_onset"][melt], ts["mlt_onset"][melt])
    np.testing.assert_array_equal(js["frz_onset"][frz], ts["frz_onset"][frz])
    assert frz.any()


def test_stress_divergence_and_health_match(runs):
    for k in ("strintx", "strinty", "prs_sig"):
        assert_close(runs["jd2"][k], runs["td2"][k], 1e-5, k, floor=1.0)
    assert int(runs["jd2"]["state_bad"]) == int(runs["td2"]["state_bad"]) == 0
    assert bool(runs["td2"]["therm_converged"])
    assert runs["td2"]["niter_thermo"] >= 1
    assert runs["td2"]["niter_ridge"] >= 1


def test_init_state_forcing_and_grid_match(runs):
    """The port's own builders give the JAX package's grid, initial state
    and forcing."""
    m = runs["m"]
    st = convert.to_numpy(m.init_state(ice_mask=m.grid.tmask))
    for k, a in runs["st0"].items():
        assert_close(a, st[k], 1e-13, k, floor=1.0)
    fo = convert.to_numpy(m.forcing_at(0))
    for k, a in runs["f0"].items():
        if a is not None:
            assert_close(a, fo[k], 1e-12, k, floor=1.0)
    tg = convert.to_numpy(m.grid)
    for k, a in runs["grid"].items():
        assert_close(a.astype(np.float64), tg[k].astype(np.float64), 1e-14,
                     k, floor=1.0)


def test_float32_steps_stay_close(runs):
    """The port in float32 from the same state: two steps run healthy and
    stay within dtype-aware bounds of the JAX float64 result (the EVP
    start-up amplifies float32 rounding ~1e5 as it does float64's)."""
    cfg = convert.config_from_dict(dataclasses.asdict(_jcfg("float32")))
    m = Model(cfg, device="cpu")
    st = convert.state_from_arrays(runs["st0"], device="cpu",
                                   dtype=torch.float32)
    f = convert.forcing_from_arrays(runs["f0"], device="cpu",
                                   dtype=torch.float32)
    st2, d2 = m.rollout(st, [f, f], 2)
    assert st2.aicen.dtype == torch.float32
    assert int(d2.state_bad) == 0 and bool(d2.therm_converged)
    got = convert.to_numpy(st2)
    for k in ("aicen", "vicen", "vsnon", "trcrn", "sst"):
        assert_close(runs["js2"][k], got[k], 1e-2, k, floor=1.0)
    for k in ("uvel", "vvel"):
        assert_close(runs["js2"][k], got[k], 5e-2, k, floor=1.0)


def test_recorded_reference_matches_its_inputs():
    """The recorded JAX steps were made from the JAX package, the
    configuration and the recipe as they are now."""
    with np.load(REFERENCE) as z:
        assert str(z["key"]) == reference_key(), (
            "test_torch_step.npz is stale: rewrite it with "
            "JAX_PLATFORMS=cpu PYTHONPATH=.:tests python "
            "tests/test_torch_step.py")


@pytest.mark.slow
def test_recorded_reference_is_current():
    """Recompute the JAX steps (~20 s of compile) and hold the recorded
    arrays to them."""
    fresh = make_reference()
    with np.load(REFERENCE) as z:
        assert sorted(fresh) == sorted(k for k in z.files if k != "key")
        for k, a in fresh.items():
            assert_close(a.astype(np.float64), z[k].astype(np.float64),
                         1e-12, k, floor=1.0)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(REFERENCE, key=np.array(reference_key()),
                        **make_reference())
    print(f"wrote {REFERENCE}")
