"""The port's prescribed-ice mode (``cice5_tpu_torch/models/
prescribed.py``) against the JAX package's ``prescribe_ice`` on the same
State and data concentration, made from a seed with NumPy, on the 24x16
global mesh of test_torch_parity_step.py (both hemispheres' prescribed
thicknesses and the ice-free band between 40S and 40N): bit for bit in
float64; in float32 within 1e-6 of each field's scale, since the JAX
function computes the enthalpy profile in float64 and casts it into the
float32 state where the port computes in float32 (no subnormal inputs).
Then a step of the port's model on the prescribed state."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from cice5_tpu_torch.models.prescribed import prescribe_ice
import torch_port_util as U
from torch_port_util import assert_close

import jax.numpy as jnp
from cice5_tpu.grid import Grid as JGrid
from cice5_tpu.models.prescribed import prescribe_ice as jprescribe
from cice5_tpu.state import State as JState

FIELDS = ("aicen", "vicen", "vsnon", "trcrn", "frzmlt")


def _inputs(dtype, seed, ice=True):
    """(port model, state, cov, Tf) with the state's tracers and snow set
    from a seed; ``ice=False`` empties the state."""
    m = U.port_parity_model(dtype)
    rng = np.random.default_rng(seed)
    st = m.init_state()
    if not ice:
        st = st.replace(aicen=torch.zeros_like(st.aicen),
                        vicen=torch.zeros_like(st.vicen),
                        vsnon=torch.zeros_like(st.vsnon))
    shape = m.grid.shape
    cov = rng.uniform(-0.1, 1.1, shape)
    cov[rng.uniform(size=shape) < 0.2] = 5e-5          # below EPS04
    tf = rng.uniform(-1.9, -1.7, shape)
    t = lambda a: torch.from_numpy(a).to(m.cfg.xp_dtype)
    st = st.replace(frzmlt=t(rng.uniform(-5.0, 5.0, shape)),
                    trcrn=st.trcrn + t(rng.uniform(
                        0.0, 1e-3, tuple(st.trcrn.shape))))
    return m, st, t(cov), t(tf)


def _run_both(m, st, cov, tf):
    got = prescribe_ice(st, cov, m.grid, m.tr, m.cfg, m.hin_max, tf)
    with warnings.catch_warnings():
        # the JAX function's float64 scatter into a float32 state warns
        warnings.simplefilter("ignore", FutureWarning)
        ref = jprescribe(U.jax_obj(JState, st), jnp.asarray(cov.numpy()),
                         U.jax_obj(JGrid, m.grid), m.tr, m.cfg, m.hin_max,
                         jnp.asarray(tf.numpy()))
    return ref, got


@pytest.mark.parametrize("seed,ice", [(1, True), (2, False), (3, True)])
def test_prescribe_ice_float64_bit_for_bit(seed, ice):
    m, st, cov, tf = _inputs("float64", seed, ice)
    ref, got = _run_both(m, st, cov, tf)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f.name)),
                                      getattr(got, f.name).numpy(), f.name)
    assert float(got.aicen.sum()) > 0.0


@pytest.mark.parametrize("seed,ice", [(4, True), (5, False)])
def test_prescribe_ice_float32(seed, ice):
    m, st, cov, tf = _inputs("float32", seed, ice)
    ref, got = _run_both(m, st, cov, tf)
    for name in FIELDS:
        assert getattr(got, name).dtype == torch.float32
        assert_close(np.asarray(getattr(ref, name)), getattr(got, name),
                     1e-6, name)


def test_prescribed_cover_by_hemisphere_and_a_step():
    """The data's concentration in the category bracketing 2 m north of
    40N and 1 m south of 40S, no ice between, fresh cells with an
    enthalpy profile; the port's step runs on the prescribed state."""
    m, st, cov, tf = _inputs("float64", 6, ice=False)
    cov = torch.where(m.grid.tmask, torch.full_like(cov, 0.8), 0.0)
    out = prescribe_ice(st, cov, m.grid, m.tr, m.cfg, m.hin_max, tf)
    lat = torch.rad2deg(m.grid.TLAT)
    for hi, band in ((2.0, lat > 40.0), (1.0, lat < -40.0)):
        n = next(n for n in range(m.cfg.ncat)
                 if m.hin_max[n] < hi < m.hin_max[n + 1])
        sel = band & m.grid.tmask
        assert torch.equal(out.aicen[n][sel], cov[sel])
        assert_close(hi * cov[sel], out.vicen[n][sel], 1e-15, "vicen")
        assert bool((out.trcrn[n, m.tr.nt_qice][sel] < 0.0).all())
    assert float(out.aicen[:, (lat.abs() < 40.0)].abs().max()) == 0.0
    st2, diag = m.step(out, m.forcing_at(U.RUN_START))
    assert bool(torch.isfinite(st2.vicen).all())
    assert int(diag.state_bad) == 0
