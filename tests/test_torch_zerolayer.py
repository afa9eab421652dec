"""Zero-layer thermodynamics (ktherm=0) of the port against the JAX
package, in float64 on the CPU.

- ``zerolayer_temperature`` on the cases of tests/test_zerolayer.py
  (winter columns with and without snow, thin and thick ice, a warm
  melting surface) against JAX (1e-11 of each output's scale), and their
  properties on the port: the cold-surface closure fcondtop == fsurf, the
  effective conductivity, thick ice colder, a melting surface with
  fsurf >= fcondtop.
- Its Newton loop (``ops/loop.py``) run as the CUDA graphs run it, one
  pass or a block of three after each host read of its flag, under the
  strict dispatch mode of test_torch_graph.py (no other host sync, no
  tensor made from host data): bit for bit the eager loop, and passes
  after convergence change nothing.
- ``thermo_vertical`` and ``thickness_changes`` with ktherm=0 (latent-only
  new ice), and ``itd.zerolayer_check``, against JAX.
- Three steps of a zero-layer rectangular model in winter grow ice, and
  the whole step under the strict dispatch mode equals the eager step.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cice5_tpu import constants as jct
from cice5_tpu.models.thermo import itd as jitd
from cice5_tpu.models.thermo import vertical as jvert
from cice5_tpu.models.thermo import zerolayer as jzl
from cice5_tpu.state import build_tracer_registry as jbuild
from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.config import rect_config
from cice5_tpu_torch.driver import graph
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.driver.step import step as step_fn
from cice5_tpu_torch.models.thermo import itd as titd
from cice5_tpu_torch.models.thermo import vertical as tvert
from cice5_tpu_torch.models.thermo import zerolayer as tzl
from cice5_tpu_torch.ops import loop
from cice5_tpu_torch.state import build_tracer_registry
from torch_port_util import assert_close, jax_config

B = (8,)
RTOL = 1e-11
OUT = ("Tsf", "fsensn", "flatn", "flwoutn", "fsurfn", "fcondtopn",
       "fcondbot")


def _inputs(hi=1.5, hs=0.2, TairC=-20.0, fsw=0.0, spread=True):
    """tests/test_zerolayer.py's column inputs, with a spread of air
    temperatures and surface temperatures across the batch."""
    n = B[0]
    ramp = np.linspace(-1.0, 1.0, n) if spread else np.zeros(n)
    f = lambda v, d=0.0: np.full(B, float(v)) + d * ramp
    return dict(mask=np.ones(B, bool), rhoa=f(1.3), flw=f(180.0, 20.0),
                potT=f(TairC + jct.Tffresh, 5.0), Qa=f(0.0002),
                shcoef=f(10.0), lhcoef=f(15.0), fswsfc=f(fsw),
                hilyr=f(hi / 7, 0.05), hslyr=f(hs), nilyr=7, nslyr=1,
                Tsf=f(-10.0, 3.0), Tbot=f(-1.8))


def _run_both(kw, **extra):
    jr = jzl.zerolayer_temperature(
        3600.0, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()}, **extra)
    tr = tzl.zerolayer_temperature(
        3600.0, **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()}, **extra)
    return jr, tr


CASES = {"winter": {}, "no_snow": dict(hs=0.0), "thin": dict(hi=0.5),
         "thick": dict(hi=3.0), "warm_melt": dict(TairC=5.0, fsw=300.0),
         "ksno": dict(hs=0.1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_zerolayer_temperature_matches(case):
    extra = dict(ksno=0.30) if case == "ksno" else {}
    jr, tr = _run_both(_inputs(**CASES[case]), **extra)
    for k in OUT:
        assert_close(getattr(jr, k), getattr(tr, k), RTOL, k, floor=1.0)
    assert bool(np.asarray(jr.converged).all()) and bool(tr.converged.all())
    assert int(tr.niter) >= 1


def test_converges_and_balances():
    _, r = _run_both(_inputs())
    Tsf = r.Tsf.numpy()
    assert (Tsf <= 0.0).all()
    cold = Tsf < -ct.puny
    np.testing.assert_allclose(r.fcondtopn.numpy()[cold],
                               r.fsurfn.numpy()[cold], atol=1e-6)
    assert torch.equal(r.fcondbot, r.fcondtopn)


def test_effective_conductivity():
    """fcondtop = kh (Tsf - Tbot), kh = kseaice / (hi + hs kseaice/ksno)."""
    kw = _inputs(hs=0.1, spread=False)
    _, r = _run_both(kw, ksno=0.30)
    kh = tzl.KSEAICE / (1.5 + 0.1 * tzl.KSEAICE / 0.30)
    np.testing.assert_allclose(r.fcondtopn.numpy(),
                               kh * (r.Tsf.numpy() + 1.8), rtol=1e-6)


def test_thicker_ice_colder_surface():
    _, thin = _run_both(_inputs(hi=0.5))
    _, thick = _run_both(_inputs(hi=3.0))
    assert float(thick.Tsf.mean()) < float(thin.Tsf.mean())


def test_warm_forcing_melting_surface():
    _, r = _run_both(_inputs(TairC=5.0, fsw=300.0))
    assert bool(r.converged.all()) and float(r.Tsf.max()) <= 0.0
    melt = r.Tsf.numpy() > -ct.puny
    assert melt.any()
    assert (r.fsurfn.numpy()[melt] >= r.fcondtopn.numpy()[melt] - 1e-6).all()


def test_masked_cells_pass_through():
    kw = _inputs()
    kw["mask"] = np.arange(B[0]) % 2 == 0
    jr, tr = _run_both(kw)
    off = ~kw["mask"]
    np.testing.assert_array_equal(tr.Tsf.numpy()[off], kw["Tsf"][off])
    for k in OUT:
        assert_close(getattr(jr, k), getattr(tr, k), RTOL, k, floor=1.0)


def _as_captured(fn, k):
    """fn() with its loop run as the captured graphs run it: a host read
    of the pending flag (the only read the strict guard allows), then k
    passes; returns (result, passes)."""
    guard = graph.HostSyncs(strict=True)
    made = []

    def driver(body, pending, carry):
        n0 = carry["niter"]
        while True:
            with guard.allowed():
                if not bool(pending(carry)):
                    break
            for _ in range(k):
                carry = body(carry, pending(carry))
        made.append(carry["niter"] - n0)
        return carry

    with loop.driven_by(driver), guard:
        out = fn()
    return out, [int(n) for n in made]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case", ["winter", "warm_melt"])
def test_loop_as_captured_equals_eager(case, k):
    kw = {key: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for key, v in _inputs(**CASES[case]).items()}
    ref = tzl.zerolayer_temperature(3600.0, **kw)
    got, made = _as_captured(
        lambda: tzl.zerolayer_temperature(3600.0, **kw), k)
    assert made == [int(ref.niter)]
    for name, a, b in zip(ref._fields, ref, got):
        assert torch.equal(a, b), name


def test_loop_body_is_over_run_invariant():
    kw = {key: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for key, v in _inputs().items()}
    seen = []

    def driver(body, pending, carry):
        go = pending(carry)
        while bool(go):
            carry = body(carry, go)
            go = pending(carry)
        more = carry
        for _ in range(3):
            more = body(more, pending(more))
        seen.append([key for key in carry
                     if not torch.equal(carry[key], more[key])])
        return more

    ref = tzl.zerolayer_temperature(3600.0, **kw)
    with loop.driven_by(driver):
        got = tzl.zerolayer_temperature(3600.0, **kw)
    assert seen == [[]]
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def _vertical_inputs(seed, n=24):
    """A batch of zero-layer columns (latent-only enthalpies) with snow,
    bottom freezing and melting, and some ice-free cells."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.9, n)
    a[:2] = 0.0
    h = rng.uniform(0.2, 3.0, n)
    v, s = a * h, a * rng.uniform(0.0, 0.4, n)
    nilyr, nslyr = 7, 1
    return dict(
        aicen=a, vicen=v, vsnon=s, Tsfcn=rng.uniform(-20.0, -0.5, n),
        zqin=np.full((nilyr, n), -jct.rhoi * jct.Lfresh),
        zqsn=np.full((nslyr, n), -jct.rhos * jct.Lfresh),
        zSin=np.tile(np.linspace(0.5, 3.2, nilyr)[:, None], (1, n)),
        flw=rng.uniform(150.0, 320.0, n), potT=rng.uniform(245.0, 276.0, n),
        Qa=np.full(n, 2e-4), rhoa=np.full(n, 1.3),
        fsnow=rng.uniform(0.0, 3e-5, n), shcoef=np.full(n, 10.0),
        lhcoef=np.full(n, 15.0), fswsfc=rng.uniform(0.0, 150.0, n),
        fswint=np.zeros(n), Sswabs=np.zeros((nslyr, n)),
        Iswabs=np.zeros((nilyr, n)), fbot=rng.uniform(-40.0, 20.0, n),
        Tbot=np.full(n, -1.8), sss=np.full(n, 34.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_thermo_vertical_matches(seed):
    cfg = rect_config(dtype="float64", accum_dtype="float64")
    cfg = cfg.replace(thermo=dataclasses.replace(cfg.thermo, ktherm=0))
    kw = _vertical_inputs(seed)
    jr = jvert.thermo_vertical(3600.0, jax_config(cfg), **{
        k: jnp.asarray(v) for k, v in kw.items()})
    tr = tvert.thermo_vertical(3600.0, cfg, **{
        k: torch.as_tensor(v) for k, v in kw.items()})
    for name in jr._fields:
        if name != "ferr":
            assert_close(np.asarray(getattr(jr, name), np.float64),
                         getattr(tr, name), RTOL, name, floor=1.0)
    # the energy error is rounding noise of enthalpies ~3e8 J/m^3 in both
    assert float(np.asarray(jr.ferr).max()) < 1e-9
    assert float(tr.ferr.max()) < 1e-9
    # new ice keeps the latent enthalpy only; the energy closes
    mask = kw["aicen"] > 0
    np.testing.assert_allclose(tr.zqin.numpy()[:, mask & (tr.vicen.numpy()
                                                          > 0)],
                               -ct.rhoi * ct.Lfresh, rtol=1e-12)
    assert float(tr.congel.max()) > 0.0 and float(tr.meltb.max()) > 0.0


def test_zerolayer_check_matches():
    cfg = rect_config(dtype="float64", accum_dtype="float64")
    cfg = cfg.replace(thermo=dataclasses.replace(cfg.thermo, ktherm=0))
    tr, jtr = build_tracer_registry(cfg), jbuild(jax_config(cfg))
    rng = np.random.default_rng(3)
    ncat, shp = cfg.ncat, (cfg.ncat, 4, 5)
    a = rng.uniform(0.0, 0.5, shp)
    v = a * rng.uniform(0.1, 3.0, shp)
    s = a * rng.uniform(0.0, 0.3, shp)
    trc = np.zeros((ncat, tr.ntrcr, 4, 5))
    trc[:, tr.nt_qice:tr.nt_qice + cfg.nilyr] = -ct.rhoi * ct.Lfresh
    trc[:, tr.nt_qsno:tr.nt_qsno + cfg.nslyr] = -ct.rhos * ct.Lfresh
    trc[1, tr.nt_qice, 2, 3] *= 0.9          # a sensible part: fails
    trc[3, tr.nt_qsno, 0, 0] *= 1.01
    args = (a, v, s, trc)
    jn = jitd.zerolayer_check(jtr, cfg.nilyr, cfg.nslyr,
                              *map(jnp.asarray, args))
    tn = titd.zerolayer_check(tr, cfg.nilyr, cfg.nslyr,
                              *map(torch.as_tensor, args))
    assert int(jn) == int(tn) == 2


def _zero_layer_model():
    cfg = rect_config(dtype="float64", accum_dtype="float64")
    cfg = cfg.replace(
        grid=dataclasses.replace(cfg.grid, ny=16, nx=12),
        thermo=dataclasses.replace(cfg.thermo, ktherm=0),
        dyn=dataclasses.replace(cfg.dyn, ndte=10))
    m = Model(cfg, device="cpu")
    return m, m.init_state(ice_mask=m.grid.tmask)


def test_full_step_grows_ice_in_winter():
    """tests/test_zerolayer.py's full-step run: three winter steps grow
    ice, converged, with every enthalpy at its latent value
    (zerolayer_check, counted in state_bad)."""
    m, st = _zero_layer_model()
    v0 = float(st.vicen.sum())
    for k in range(3):
        st, d = m.step(st, m.forcing_at(k))
    assert torch.isfinite(st.vicen).all()
    assert bool(d.therm_converged) and int(d.state_bad) == 0
    assert float(st.vicen.sum()) > v0
    tr = m.tr
    assert int(titd.zerolayer_check(tr, m.cfg.nilyr, m.cfg.nslyr, st.aicen,
                                    st.vicen, st.vsnon, st.trcrn)) == 0


def test_step_as_captured_equals_eager():
    """The zero-layer step with every loop run as the captured graphs run
    it, under the strict dispatch mode, equals the eager step bit for
    bit."""
    m, st = _zero_layer_model()
    f = m.forcing_at(0)
    st, _ = step_fn(st, f, *m.step_args)
    ref = step_fn(st, f, *m.step_args)
    got, made = _as_captured(lambda: step_fn(st, f, *m.step_args), 1)
    assert len(made) == 2 and made[0] == int(ref[1].niter_thermo)
    for a, b in ((ref[0], got[0]), (ref[1], got[1])):
        items = (a._asdict().items() if hasattr(a, "_asdict") else
                 ((fl.name, getattr(a, fl.name))
                  for fl in dataclasses.fields(a)))
        for name, x in items:
            y = getattr(b, name)
            if torch.is_tensor(x):
                assert torch.equal(torch.nan_to_num(x),
                                   torch.nan_to_num(y)), name
