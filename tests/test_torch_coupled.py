"""The coupled model of the port (``driver/coupled.py``) and the step's
coupled-mode options against the JAX package, in float64 on the CPU.

- ``scale_fluxes`` on the same diagnostics; the field merge (the ``fsw``
  split, ``Tf`` from ``sss``, ``potT`` from ``Tair``, ``wind`` from
  ``uatm``/``vatm``); an unknown field raises KeyError.
- ``CoupledModel.run`` against the JAX ``CoupledModel.run``: a 12x16
  rectangular BL99 model with the coupled radiation ordering (ndte=10),
  from a state warmed up by one JAX step, 4 steps with ``num_cpl_ai=2``,
  ``num_cpl_io=3`` and the same callbacks (seeded NumPy fields that vary
  in time); every State field, every ``put_ocn`` payload, the last
  step's diagnostics and the boundary checksums.
- The coupled radiation ordering on the gx1-parity model of
  test_torch_parity_step.py (24x16 tripole grid, ndte=8, dEdd): prefill
  from its warmed-up state, then 2 steps under forcings an hour apart.
- Form drag + highfreq + ``fbot_xfer_type="Cdn_ocn"`` on the same model,
  2 steps.
- Form drag on the fused-EVP path (the 12x16 BL99 model of
  test_torch_evp_fused.py): the port's fused step against the JAX ``evp``
  step, because the JAX fused kernel runs its subcycles with
  ``ct.dragio`` whatever ``Cw`` the caller passes
  (cice5_tpu/ops/pallas/evp_fused.py:81-84); the test asserts that JAX
  defect instead of copying it.
- A coupled run restarted after 2 steps equals the continuous run at 0.0;
  its restart files (``rad_prev``/``rad_alb`` included) load bit for bit
  in either package; a history stream with the form-drag fields equals
  the JAX writer's file to 1 float32 ulp.

Tolerances: every State field, outbound field and diagnostic within 3e-8
x its scale (at least 1), the stress state and stress divergence
included (these runs start warmed up, where the EVP does not amplify
last-bit differences); tracers as conserved amounts, as in
test_torch_parity_step.py. The JAX steps are recorded in test_torch_coupled.npz under
a hash of their inputs (rewrite: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_coupled.py``, ~6 min); a test marked slow recomputes
them.
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

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch import convert
from cice5_tpu_torch.config import rect_config
from cice5_tpu_torch.driver import coupled as tcpl
from cice5_tpu_torch.driver.model import Model, check_supported
from cice5_tpu_torch.driver.step import DRAG_KEYS, prefill_radiation
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.io import history as thist
from cice5_tpu_torch.io import restart as trestart
from cice5_tpu_torch.models.thermo.itd import tracer_weights
import test_torch_evp_fused as FUSED
import torch_port_util as U
from torch_port_util import assert_close, jit_fast

REFERENCE = Path(__file__).with_name("test_torch_coupled.npz")

# the CoupledModel run
CPL_NY, CPL_NX, CPL_NDTE = 12, 16, 10
CPL_START, CPL_NSTEPS, CPL_AI, CPL_IO = 24 * 180, 4, 2, 3
# the gx1-parity runs: forcings of PARITY_ISTEP + k, k = 0 (prefill), 1, 2
PARITY_STEPS = 2

STATE = ("aicen", "vicen", "vsnon", "uvel", "vvel", "sst", "frzmlt",
         "strocnxT", "strocnyT", "iceumask", "scale_factor", "rad_alb",
         "frz_onset", "first_ice", "a11n", "a12n")
STRESS = ("stressp", "stressm", "stress12")
DIAG_SKIP = ("niter_thermo", "niter_ridge", "therm_converged", "state_bad")


def cpl_config():
    """The port's config of the CoupledModel run: JAX tests/test_coupled.py
    TestCoupledRadiationOrdering's rectangular basin."""
    cfg = rect_config(CPL_NY, CPL_NX)
    return cfg.replace(dyn=dataclasses.replace(cfg.dyn, ndte=CPL_NDTE),
                       dtype="float64", accum_dtype="float64",
                       coupled_radiation=True)


def atm_fields(t, shape=(CPL_NY, CPL_NX)):
    """The atmosphere's fields at time ``t`` (s): seeded by the hour, so
    they vary in time and are the same in every run."""
    rng = np.random.default_rng(1000 + int(t) // 3600)
    u = lambda lo, hi: rng.uniform(lo, hi, shape)
    return {"fsw": u(50.0, 300.0), "flw": u(180.0, 260.0),
            "Tair": u(250.0, 272.0), "Qa": u(5e-4, 2e-3),
            "uatm": u(-8.0, 8.0), "vatm": u(-8.0, 8.0),
            "fsnow": u(0.0, 2e-6), "frain": u(0.0, 1e-5),
            "rhoa": u(1.2, 1.35), "zlvl": np.full(shape, 10.0)}


def ocn_fields(t, shape=(CPL_NY, CPL_NX)):
    """The ocean's fields at time ``t`` (s), seeded as atm_fields."""
    rng = np.random.default_rng(2000 + int(t) // 3600)
    u = lambda lo, hi: rng.uniform(lo, hi, shape)
    return {"sst": u(-1.9, -1.5), "sss": u(30.0, 34.5),
            "uocn": u(-0.1, 0.1), "vocn": u(-0.1, 0.1),
            "frzmlt": u(-20.0, 20.0), "hmix": u(10.0, 30.0),
            "qdp": u(-5.0, 5.0), "ss_tltx": u(-1e-6, 1e-6),
            "ss_tlty": u(-1e-6, 1e-6)}


def parity_variant(name, dtype="float64"):
    """The port's gx1-parity test config with the coupled radiation
    ordering ("crad") or form drag + highfreq + fbot_xfer_type="Cdn_ocn"
    ("fdrag")."""
    cfg = convert.config_from_dict(U.parity_config_dict(dtype))
    if name == "crad":
        return cfg.replace(coupled_radiation=True)
    return cfg.replace(
        forcing=dataclasses.replace(cfg.forcing, formdrag=True,
                                    highfreq=True),
        thermo=dataclasses.replace(cfg.thermo, fbot_xfer_type="Cdn_ocn"))


def fused_config(algorithm):
    """The fused-EVP test config of test_torch_evp_fused.py with form drag,
    on the fused path ("pallas") or the evp path ("auto")."""
    cfg = convert.config_from_dict(dataclasses.asdict(FUSED._jcfg()))
    return cfg.replace(
        forcing=dataclasses.replace(cfg.forcing, formdrag=True),
        dyn=dataclasses.replace(cfg.dyn, evp_algorithm=algorithm))


def _arrays(prefix, obj, out):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is not None:
            out[f"{prefix}/{f.name}"] = np.asarray(v)


def _jax_model(cfg, grid=None):
    """The JAX package's Model for a port config, its step compiled with
    XLA_FAST_COMPILE."""
    from cice5_tpu.driver.model import Model as JModel
    from cice5_tpu.driver.step import step as jstep_fn
    jm = JModel(U.jax_config(cfg), grid=grid)
    jm._jstep = jit_fast(partial(jstep_fn, cfg=jm.cfg, tr=jm.tr,
                                 topo=jm.topo, hin_max=jm.hin_max,
                                 salinz=jm.salinz))
    return jm


def make_reference() -> dict:
    """Run the JAX package: {"cpl_*": the CoupledModel run, "crad_*": the
    coupled radiation ordering, "fdrag_*": form drag + highfreq +
    Cdn_ocn, "fdevp_*" / "fdfused_*": form drag on the evp and fused
    paths}, each with its inputs, its final state and its last step's
    diagnostics."""
    import jax.numpy as jnp
    from cice5_tpu.driver.coupled import CoupledModel as JCoupled
    from cice5_tpu.driver.step import prefill_radiation as jprefill
    from cice5_tpu.grid import popgrid_np as jpopgrid
    from cice5_tpu.state import State as JState
    out = {}

    # the CoupledModel run, from a state warmed up by one step
    jm = _jax_model(cpl_config())
    st = jm.init_state(ice_mask=np.asarray(jm.grid.tmask))
    st, _ = jm.step(st, jm.forcing_at(CPL_START - 1))
    _arrays("cpl_in", st, out)
    puts = []
    cm = JCoupled(model=jm, get_atm=atm_fields, get_ocn=ocn_fields,
                  put_ocn=lambda t, o: puts.append((t, o)),
                  num_cpl_ai=CPL_AI, num_cpl_io=CPL_IO)
    st, d = cm.run(st, CPL_NSTEPS, start_step=CPL_START)
    for j, (t, o) in enumerate(puts):
        out[f"cpl_put{j}/time"] = np.array(t)
        for k, v in o.items():
            out[f"cpl_put{j}/{k}"] = np.asarray(v)
    _arrays("cpl_out", st, out)
    for k in d._fields:
        out[f"cpl_diag/{k}"] = np.asarray(getattr(d, k))
    final = cm.into_ocn(st, d)
    sums = cm.boundary_checksums(CPL_START * 3600.0, final)
    out["cpl_sum_keys"] = np.array(list(sums))
    out["cpl_sums"] = np.array(list(sums.values()))

    # the gx1-parity variants, from the parity reference's warmed state
    ref = U.load_parity_reference()
    st0 = JState(**{f.name: jnp.asarray(ref[f"in/{f.name}"])
                    for f in dataclasses.fields(JState)})
    for name in ("crad", "fdrag"):
        cfg = parity_variant(name)
        jm = _jax_model(cfg, grid=jpopgrid(U.jax_config(cfg),
                                           *U.parity_grid_arrays()))
        fs = [jm.forcing_at(U.PARITY_ISTEP + k).replace(
            frain=jnp.full(jm.grid.shape, U.RAIN))
            for k in range(PARITY_STEPS + 1)]
        st = st0
        if name == "crad":
            st = jprefill(st, fs[0], jm.cfg, jm.tr)
            _arrays("crad_pre", st, out)
        for k, f in enumerate(fs):
            _arrays(f"{name}_forcing{k}", f, out)
        for f in fs[1:]:
            st, d = jm.step(st, f)
        _arrays(f"{name}_out", st, out)
        for k in d._fields:
            out[f"{name}_diag/{k}"] = np.asarray(getattr(d, k))

    # form drag on the evp and the fused paths, from the fused test's
    # warmed state
    with np.load(FUSED.REFERENCE) as z:
        fref = {k: z[k] for k in z.files if k != "key"}
    st0 = JState(**{f.name: jnp.asarray(fref[f"in/{f.name}"])
                    for f in dataclasses.fields(JState)})
    from cice5_tpu.forcing import Forcing as JForcing
    f0 = JForcing(**{f.name: jnp.asarray(fref[f"forcing/{f.name}"])
                     for f in dataclasses.fields(JForcing)
                     if f"forcing/{f.name}" in fref})
    for name, algo in (("fdevp", "auto"), ("fdfused", "pallas")):
        jm = _jax_model(fused_config(algo))
        st = st0
        for _ in range(2):
            st, d = jm.step(st, f0)
        _arrays(f"{name}_out", st, out)
        for k in d._fields:
            out[f"{name}_diag/{k}"] = np.asarray(getattr(d, k))
    return out


def reference_key() -> str:
    """SHA-256 of what the recorded reference depends on: every source
    file of the JAX package, the configurations, the starting states of
    the parity and fused references, and this recipe."""
    h = hashlib.sha256()
    root = Path(__file__).resolve().parents[1] / "cice5_tpu"
    for path in sorted(root.rglob("*.py")):
        h.update(path.relative_to(root).as_posix().encode())
        h.update(path.read_bytes())
    cfgs = [cpl_config(), parity_variant("crad"), parity_variant("fdrag"),
            fused_config("auto"), fused_config("pallas")]
    for cfg in cfgs:
        h.update(json.dumps(dataclasses.asdict(cfg), sort_keys=True,
                            default=repr).encode())
    h.update(U.parity_reference_key().encode())
    h.update(FUSED.reference_key().encode())
    for fn in (make_reference, atm_fields, ocn_fields, _jax_model, _arrays):
        h.update(inspect.getsource(fn).encode())
    h.update(repr((CPL_NY, CPL_NX, CPL_NDTE, CPL_START, CPL_NSTEPS, CPL_AI,
                   CPL_IO, PARITY_STEPS, U.RAIN)).encode())
    return h.hexdigest()


def _part(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def ref():
    with np.load(REFERENCE) as z:
        return {k: z[k] for k in z.files if k != "key"}


def _state(arrays):
    return convert.state_from_arrays(arrays, device="cpu")


def _assert_state_close(js, ts, tr, label):
    """Every State field of the port (``ts``, a State) against the JAX
    arrays ``js``: 3e-8 x scale, tracers as conserved amounts, the
    radiation memory per component on its own scale, the melt onset date
    only where both runs set it."""
    tn = convert.to_numpy(ts)
    for k in STATE:
        assert_close(js[k], tn[k], 3e-8, f"{label} {k}", floor=1.0)
    for k in STRESS:
        assert_close(js[k], tn[k], 3e-8, f"{label} {k}", floor=1.0)
    for i in range(js["rad_prev"].shape[1]):
        assert_close(js["rad_prev"][:, i], tn["rad_prev"][:, i], 3e-8,
                     f"{label} rad_prev[{i}]", floor=1.0)
    t = lambda k: torch.as_tensor(js[k])
    w_ref = tracer_weights(tr, t("aicen"), t("vicen"), t("vsnon"),
                           t("trcrn")) * t("trcrn")
    w_got = tracer_weights(tr, ts.aicen, ts.vicen, ts.vsnon,
                           ts.trcrn) * ts.trcrn
    for it in range(tr.ntrcr):
        assert_close(w_ref[:, it], w_got[:, it], 3e-8,
                     f"{label} trcrn[{it}]", floor=1e-6)
    both = (js["mlt_onset"] > 0) & (tn["mlt_onset"] > 0)
    np.testing.assert_allclose(tn["mlt_onset"][both], js["mlt_onset"][both],
                               rtol=1e-12)


def _assert_diag_close(jd, td, label):
    """Every StepDiag field of the port against the JAX diag's."""
    tn = convert.to_numpy(td)
    for k in td._fields:
        if k in DIAG_SKIP:
            continue
        assert_close(jd[k], tn[k], 3e-8, f"{label} {k}", floor=1.0)
    assert int(jd["state_bad"]) == int(tn["state_bad"]) == 0
    assert bool(tn["therm_converged"])


# ---------------------------------------------------------------------
# scale_fluxes and the field merge
# ---------------------------------------------------------------------

def _small_run():
    """(model, state, diag) of one port step of the CoupledModel config
    from its recorded warmed state."""
    with np.load(REFERENCE) as z:
        arrays = {k[7:]: z[k] for k in z.files if k.startswith("cpl_in/")}
    m = Model(cpl_config(), device="cpu")
    st = _state(arrays)
    st, d = m.step(st, m.forcing_at(CPL_START))
    return m, st, d


def test_scale_fluxes_matches_jax():
    from cice5_tpu.driver.coupled import scale_fluxes as jscale
    m, st, d = _small_run()
    f = m.forcing_at(CPL_START)
    d = d._replace(aice=torch.where(m.grid.ULAT > 1.26, d.aice, 0.0))
    got = tcpl.scale_fluxes(d, aice=d.aice, tmask=m.grid.tmask, Tf=f.Tf,
                            Tair=f.Tair, Qa=f.Qa)
    jd = U.jax_diag(d)
    import jax.numpy as jnp
    want = jscale(jd, aice=jd.aice, tmask=jnp.asarray(m.grid.tmask.numpy()),
                  Tf=jnp.asarray(f.Tf.numpy()),
                  Tair=jnp.asarray(f.Tair.numpy()),
                  Qa=jnp.asarray(f.Qa.numpy()))
    assert tcpl.ScaledFluxes._fields == type(want)._fields
    for k, a, b in zip(got._fields, want, got):
        assert_close(np.asarray(a), b, 1e-14, k, floor=1e-300)
    assert bool((d.aice == 0).any()) and bool((d.aice > 0.5).any())


def test_field_merge():
    """The fsw split, Tf from sss, potT from Tair, wind from uatm/vatm;
    NumPy arrays, scalars and tensors all land on the model's device in
    its dtype at the grid's shape; an unknown field raises KeyError."""
    m = Model(cpl_config(), device="cpu")
    cm = tcpl.CoupledModel(model=m)
    shape = m.grid.shape
    buf = np.full(shape, 260.0)
    cm.from_atm({"fsw": np.full(shape, 200.0), "Tair": buf,
                 "uatm": 3.0, "vatm": torch.full(shape, 4.0)})
    buf[:] = 0.0                 # the model copied the caller's buffer
    f = cm._forcing
    for x in (f.swvdr, f.potT, f.Tair, f.wind, f.uatm):
        assert x.shape == shape and x.dtype == torch.float64
    np.testing.assert_allclose(
        (f.swvdr + f.swvdf + f.swidr + f.swidf).numpy(), 200.0, rtol=1e-12)
    np.testing.assert_allclose(f.potT.numpy(), 260.0)
    np.testing.assert_allclose(f.wind.numpy(), 5.0, rtol=1e-12)
    cm.from_ocn({"sss": np.full(shape, 30.0)})
    np.testing.assert_allclose(cm._forcing.Tf.numpy(), -ct.depressT * 30.0,
                               rtol=1e-12)
    with pytest.raises(KeyError, match="bogus"):
        cm.from_atm({"bogus": np.zeros(shape)})
    with pytest.raises(KeyError, match="sst"):
        cm.from_atm({"sst": np.zeros(shape)})


# ---------------------------------------------------------------------
# CoupledModel.run against the JAX CoupledModel.run
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpl_run(ref):
    m = Model(cpl_config(), device="cpu")
    puts = []
    cm = tcpl.CoupledModel(model=m, get_atm=atm_fields, get_ocn=ocn_fields,
                           put_ocn=lambda t, o: puts.append((t, o)),
                           num_cpl_ai=CPL_AI, num_cpl_io=CPL_IO)
    st, d = cm.run(_state(_part(ref, "cpl_in")), CPL_NSTEPS,
                   start_step=CPL_START)
    return dict(m=m, cm=cm, st=st, d=d, puts=puts)


def test_coupled_run_state_matches_jax(ref, cpl_run):
    _assert_state_close(_part(ref, "cpl_out"), cpl_run["st"],
                        cpl_run["m"].tr, "cpl")
    assert float(cpl_run["st"].rad_prev.abs().max()) > 1.0


def test_coupled_run_diag_matches_jax(ref, cpl_run):
    _assert_diag_close(_part(ref, "cpl_diag"), cpl_run["d"], "cpl")


def test_coupled_run_put_ocn_matches_jax(ref, cpl_run):
    """The same exchanges at the same times (one put after step 3 of 4
    at num_cpl_io=3), each outbound field within 3e-8 x scale."""
    puts = cpl_run["puts"]
    n = len({k.split("/")[0] for k in ref if k.startswith("cpl_put")})
    assert len(puts) == n == 1
    for j, (t, o) in enumerate(puts):
        want = _part(ref, f"cpl_put{j}")
        assert t == float(want.pop("time"))
        assert sorted(o) == sorted(want)
        for k, v in o.items():
            assert v.device.type == "cpu" and v.dtype == torch.float64
            assert_close(want[k], v, 3e-8, k, floor=1.0)


def test_coupled_run_checksums_match_jax(ref, cpl_run):
    cm = cpl_run["cm"]
    final = cm.into_ocn(cpl_run["st"], cpl_run["d"])
    sums = cm.boundary_checksums(CPL_START * 3600.0, final)
    keys = [str(k) for k in ref["cpl_sum_keys"]]
    assert list(sums) == keys
    for k, want in zip(keys, ref["cpl_sums"]):
        if k.startswith("out_"):
            # each outbound value within 3e-8 of its field's scale
            bound = 3e-8 * max(float(final[k[4:]].abs().sum()), 1.0)
        else:
            bound = 1e-12 * max(abs(want), 1.0)
        assert abs(sums[k] - want) <= bound, k


def test_coupled_run_cadence():
    """The exchanges fall on the num_cpl_ai / num_cpl_io cadence
    (CICE_RunMod.F90:128-240), and the outbound fields stay on the model's
    device."""
    m = Model(cpl_config(), device="cpu")
    calls = {"atm": [], "ocn": [], "put": []}
    cm = tcpl.CoupledModel(
        model=m, get_atm=lambda t: calls["atm"].append(t) or atm_fields(t),
        get_ocn=lambda t: calls["ocn"].append(t) or ocn_fields(t),
        put_ocn=lambda t, o: calls["put"].append((t, o)),
        num_cpl_ai=2, num_cpl_io=3)
    st, d = cm.run(m.init_state(ice_mask=m.grid.tmask), 6)
    dt = m.cfg.time.dt
    assert calls["atm"] == [0.0, 2 * dt, 4 * dt]
    assert calls["ocn"] == [0.0, 3 * dt]
    assert [t for t, _ in calls["put"]] == [3 * dt, 6 * dt]
    out = calls["put"][-1][1]
    assert set(out) >= {"strocnxT", "fresh", "fsalt", "fhocn", "fswthru",
                        "aice"}
    assert all(torch.is_tensor(v) and torch.isfinite(v).all()
               for v in out.values())
    assert float(out["aice"].max()) > 0.5 and int(d.state_bad) == 0


# ---------------------------------------------------------------------
# the coupled radiation ordering and form drag on the gx1-parity model
# ---------------------------------------------------------------------

def _parity_model(name, dtype="float64"):
    cfg = parity_variant(name, dtype)
    return Model(cfg, grid=popgrid_np(cfg, *U.parity_grid_arrays(),
                                      device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def parity_runs(ref):
    runs = {}
    st0 = _state({k[3:]: v for k, v in U.load_parity_reference().items()
                  if k.startswith("in/")})
    for name in ("crad", "fdrag"):
        m = _parity_model(name)
        fs = [convert.forcing_from_arrays(_part(ref, f"{name}_forcing{k}"),
                                          device="cpu")
              for k in range(PARITY_STEPS + 1)]
        st = st0
        pre = None
        if name == "crad":
            st = pre = prefill_radiation(st, fs[0], m.cfg, m.tr)
        st, d = m.rollout(st, fs[1:], PARITY_STEPS)
        runs[name] = dict(m=m, pre=pre, st=st, d=d)
    return runs


def test_prefill_radiation_matches_jax(ref, parity_runs):
    want = _part(ref, "crad_pre")
    got = convert.to_numpy(parity_runs["crad"]["pre"])
    for k in ("scale_factor", "rad_alb"):
        assert_close(want[k], got[k], 1e-12, k, floor=1.0)
    for i in range(want["rad_prev"].shape[1]):
        assert_close(want["rad_prev"][:, i], got["rad_prev"][:, i], 1e-12,
                     f"rad_prev[{i}]", floor=1.0)
    assert float(np.abs(want["rad_prev"][:, 0]).max()) > 1.0


@pytest.mark.parametrize("name", ["crad", "fdrag"])
def test_parity_variant_two_steps_match_jax(ref, parity_runs, name):
    r = parity_runs[name]
    _assert_state_close(_part(ref, f"{name}_out"), r["st"], r["m"].tr, name)
    _assert_diag_close(_part(ref, f"{name}_diag"), r["d"], name)


def test_coupled_ordering_lags_one_step(ref, parity_runs):
    """The coupled step's thermo reads last step's absorbed shortwave,
    rescaled to this step's incoming shortwave: its fswabs differs from
    the standalone ordering's on the same state and forcing, and equals
    rad_prev rescaled (JAX tests/test_coupled.py
    test_varying_forcing_one_step_sw_lag)."""
    m = parity_runs["crad"]["m"]
    st = parity_runs["crad"]["pre"]
    f1 = convert.forcing_from_arrays(_part(ref, "crad_forcing1"),
                                     device="cpu")
    _, d = m.step(st, f1)
    al = st.rad_alb
    net = (f1.swvdr * (1 - al[0]) + f1.swvdf * (1 - al[1])
           + f1.swidr * (1 - al[2]) + f1.swidf * (1 - al[3]))
    sfac = torch.where((st.aicen.sum(0) > 0) & (st.scale_factor > ct.puny),
                       net / torch.clamp(st.scale_factor, min=ct.puny), 1.0)
    want = (st.aicen * st.rad_prev[:, :3].sum(1)).sum(0) * sfac
    assert_close(want, d.fswabs, 1e-12, "fswabs", floor=1.0)
    ms = Model(m.cfg.replace(coupled_radiation=False), grid=m.grid,
               device="cpu")
    _, ds = ms.step(st, f1)
    assert float((ds.fswabs - d.fswabs).abs().max()) > 1e-3


def test_form_drag_reaches_the_step(parity_runs):
    """The drag stack is the diag's; over the ice the ocean drag is the
    skin drag plus the floe-edge drag, which varies with the ice, far from
    the constant ct.dragio of the standalone step."""
    d = parity_runs["fdrag"]["d"]
    assert d.drag.shape == (len(DRAG_KEYS),) + d.aice.shape
    cdn_ocn = d.drag[DRAG_KEYS.index("Cdn_ocn")]
    ice = d.aice > 0.1
    assert float(cdn_ocn[ice].max() - cdn_ocn[ice].min()) > 0.0
    assert float((cdn_ocn[ice] - ct.dragio).abs().min()) > 1e-3
    assert float(d.drag[DRAG_KEYS.index("Cdn_ocn_floe")][ice].max()) > 0.0


# ---------------------------------------------------------------------
# form drag on the fused-EVP path
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_run():
    with np.load(FUSED.REFERENCE) as z:
        fref = {k: z[k] for k in z.files if k != "key"}
    m = Model(fused_config("pallas"), device="cpu")
    st = _state(_part(fref, "in"))
    f = convert.forcing_from_arrays(_part(fref, "forcing"), device="cpu")
    st, d = m.rollout(st, f, 2)
    return dict(m=m, st=st, d=d)


def test_fused_path_with_form_drag_matches_jax_evp(ref, fused_run):
    """The port's fused step passes the form-drag Cw plane into every
    subcycle, so it agrees with the JAX evp path."""
    _assert_state_close(_part(ref, "fdevp_out"), fused_run["st"],
                        fused_run["m"].tr, "fused formdrag")
    _assert_diag_close(_part(ref, "fdevp_diag"), fused_run["d"],
                       "fused formdrag")


def test_jax_fused_kernel_ignores_cw_and_the_port_does_not(ref, fused_run):
    """The JAX fused kernel's subcycles use ct.dragio
    (cice5_tpu/ops/pallas/evp_fused.py:81-84): its velocities part from
    the JAX evp path's by far more than the port's do."""
    evp_u = ref["fdevp_out/uvel"]
    fused_u = ref["fdfused_out/uvel"]
    scale = np.abs(evp_u).max()
    jax_gap = np.abs(fused_u - evp_u).max() / scale
    port_gap = np.abs(fused_run["st"].uvel.numpy() - evp_u).max() / scale
    assert jax_gap > 1e-4, jax_gap
    assert port_gap < 3e-8 < jax_gap


# ---------------------------------------------------------------------
# restart and history of the coupled model
# ---------------------------------------------------------------------

def _coupled(m, **kw):
    return tcpl.CoupledModel(model=m, get_atm=atm_fields,
                             get_ocn=ocn_fields, **kw)


def test_coupled_restart_is_exact(ref, tmp_path):
    """4 coupled steps against 2, a restart, a fresh model and 2 more: every
    State field equal at 0.0 (the exchanges at every step)."""
    st0 = _state(_part(ref, "cpl_in"))
    m = Model(cpl_config(), device="cpu")
    full, _ = _coupled(m).run(st0, 4, start_step=CPL_START)
    half, _ = _coupled(m).run(st0, 2, start_step=CPL_START)
    trestart.dump(half, str(tmp_path / "iced.npz"), istep=CPL_START + 2,
                  time=(CPL_START + 2) * 3600.0)
    st2, meta = trestart.restore(pointer_dir=str(tmp_path), device="cpu")
    m2 = Model(cpl_config(), device="cpu")
    out, _ = _coupled(m2).run(st2, 2, start_step=meta["istep"])
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(out, f.name), getattr(full, f.name)), \
            f.name
    assert out.rad_prev.shape[1] == 3 + m.cfg.nslyr + m.cfg.nilyr


def test_coupled_restart_interchanges_with_jax(parity_runs, tmp_path):
    """The restart of the coupled-ordering parity run, rad_prev and rad_alb
    included, read by the JAX package and back, bit for bit."""
    from cice5_tpu.io import restart as jrestart
    st = parity_runs["crad"]["st"]
    trestart.dump(st, str(tmp_path / "port" / "iced.npz"), istep=2,
                  time=7200.0)
    js, meta = jrestart.restore(pointer_dir=str(tmp_path / "port"))
    jrestart.dump(js, str(tmp_path / "jax" / "iced.npz"), istep=2,
                  time=7200.0)
    back, meta2 = trestart.restore(pointer_dir=str(tmp_path / "jax"),
                                   device="cpu")
    assert meta == meta2
    for f in dataclasses.fields(st):
        a = getattr(st, f.name).numpy()
        np.testing.assert_array_equal(np.asarray(getattr(js, f.name)), a,
                                      err_msg=f.name)
        assert torch.equal(getattr(back, f.name), getattr(st, f.name)), \
            f.name
    assert st.rad_prev.shape[1] == 3 + 1 + 4 and st.rad_alb.shape[0] == 4


def test_history_with_form_drag_matches_jax_writer(ref, tmp_path):
    """The coupled-ordering, form-drag parity model (every option of this
    slice on): two steps, a stream of every available field (the f_drag,
    f_Cdn_atm and f_Cdn_ocn sets and the coupled ordering's albedos
    among them) written by both packages' writers, equal to 1 float32
    ulp."""
    from cice5_tpu.forcing import Forcing as JForcing
    from cice5_tpu.grid import popgrid_np as jpopgrid
    from cice5_tpu.io import history as jhist
    from cice5_tpu.state import State as JState
    from cice5_tpu.state import build_tracer_registry as jbuild
    cfg = parity_variant("fdrag").replace(coupled_radiation=True)
    m = Model(cfg, grid=popgrid_np(cfg, *U.parity_grid_arrays(),
                                   device="cpu"), device="cpu")
    jcfg = U.jax_config(cfg)
    st = _state({k[3:]: v for k, v in U.load_parity_reference().items()
                 if k.startswith("in/")})
    f0 = convert.forcing_from_arrays(_part(ref, "crad_forcing0"),
                                     device="cpu")
    st = prefill_radiation(st, f0, cfg, m.tr)
    fields = thist.available_fields(cfg, m.tr)
    jfields = jhist.available_fields(jcfg, jbuild(jcfg))
    assert [f.name for f in fields] == [f.name for f in jfields]
    assert {"Cdn_atm", "Cdn_ocn", "hfreebd", "lfloe"} <= {
        f.name for f in fields}
    ts = thist.HistoryStream(fields, freq="1", freq_n=2)
    js = jhist.HistoryStream(jfields, freq="1", freq_n=2)
    jgrid = jpopgrid(jcfg, *U.parity_grid_arrays())
    for k in (1, 2):
        f = convert.forcing_from_arrays(_part(ref, f"crad_forcing{k}"),
                                        device="cpu")
        st, d = m.step(st, f)
        info = m.calendar.info(U.PARITY_ISTEP + k, cfg.time.dt)
        ts.accum(thist.diag_to_values(d, st, m.grid, m.tr, f, 4, 1),
                 info.time)
        js.accum(jhist.diag_to_values(
            U.jax_diag(d), U.jax_obj(JState, st), jgrid, jbuild(jcfg),
            U.jax_obj(JForcing, f), 4, 1), info.time)
    tp = thist.write_netcdf(ts, m.grid, info, str(tmp_path / "port.nc"))
    jp = jhist.write_netcdf(js, jgrid, info, str(tmp_path / "jax.nc"))
    U.assert_same_history_file(jp, tp)
    assert float(d.drag.abs().max()) > 0.0


# ---------------------------------------------------------------------
# the options, and the recorded reference
# ---------------------------------------------------------------------

def test_check_supported_opens_the_coupled_options():
    from cice5_tpu_torch.config import auscom_025_config, tx01_config
    for cfg in (parity_variant("crad"), parity_variant("fdrag"),
                auscom_025_config(coupled_radiation=True), tx01_config(),
                cpl_config(), fused_config("pallas")):
        check_supported(cfg)
    bad = cpl_config().replace(thermo=dataclasses.replace(
        cpl_config().thermo, fbot_xfer_type="bogus"))
    with pytest.raises(ValueError, match="Cdn_ocn"):
        check_supported(bad)
    q = auscom_025_config()
    assert (q.grid.ny, q.grid.nx, q.dyn.ndte, q.nilyr) == (1080, 1440, 120,
                                                           4)


def test_recorded_reference_matches_its_inputs():
    """The recorded JAX reference was made from the JAX package, the
    configurations, the starting states and the recipe as they are now."""
    with np.load(REFERENCE) as z:
        assert str(z["key"]) == reference_key(), (
            "test_torch_coupled.npz is stale: rewrite it with "
            "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_coupled.py")


@pytest.mark.slow
def test_recorded_reference_is_current():
    """Recompute the JAX reference and hold the recorded arrays to it."""
    fresh = make_reference()
    with np.load(REFERENCE) as z:
        assert sorted(fresh) == sorted(k for k in z.files if k != "key")
        for k, a in fresh.items():
            if a.dtype.kind in "US":
                assert (a == z[k]).all(), k
            else:
                assert_close(a, z[k], 1e-12, k, floor=1.0)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(REFERENCE, key=np.array(reference_key()),
                        **make_reference())
    print(f"wrote {REFERENCE}")
