"""The gx1-parity slice as a whole vs the JAX package: two steps of
``Model`` under ``gx1_parity_config`` (mushy thermo, delta-Eddington
shortwave, the iage/FY/lvl/pond tracers, EVP + remap on a tripole seam) on
a 24x16 synthetic global grid whose land touches the seam, ndte=8,
float64, from a state warmed up by one JAX step.

The JAX side is recorded in test_torch_parity_step.npz by
``torch_port_util.make_parity_reference`` (one jitted JAX parity step
costs ~2 min to trace and compile on a CPU) under a hash of its inputs,
which ``test_recorded_reference_matches_its_inputs`` checks;
``test_recorded_reference_is_current`` (marked slow) recomputes it. Tolerances as in
test_torch_step.py: state and diagnostics 3e-8 x scale, the stress state
and stress divergence 1e-5 x scale (the EVP amplifies last-bit
differences); tracers as conserved amounts (weight x value: a tracer value
in a cell of vanishing area is as uncertain as that area); a float32 run
of the port stays within dtype-aware bounds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cice5_tpu_torch import convert
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.models.thermo.itd import tracer_weights
import torch_port_util as U
from torch_port_util import assert_close

STATE = ("aicen", "vicen", "vsnon", "uvel", "vvel", "sst", "frzmlt",
         "strocnxT", "strocnyT", "iceumask", "scale_factor")
STRESS = ("stressp", "stressm", "stress12")
DIAG = tuple(k for k in U.PARITY_DIAG
             if k not in ("strintx", "strinty", "prs_sig", "state_bad",
                          "therm_converged"))


def _model(dtype="float64"):
    cfg = convert.config_from_dict(U.parity_config_dict(dtype))
    grid = popgrid_np(cfg, *U.parity_grid_arrays(), device="cpu")
    return Model(cfg, grid=grid, device="cpu")


def _part(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def runs():
    ref = U.load_parity_reference()
    m = _model()
    st = convert.state_from_arrays(_part(ref, "in"), device="cpu")
    f = convert.forcing_from_arrays(_part(ref, "forcing"), device="cpu")
    ts2, td2 = m.rollout(st, f, 2)
    return dict(ref=ref, js2=_part(ref, "out"), jd2=_part(ref, "diag"), m=m,
                ts2=ts2, tn2=convert.to_numpy(ts2), td2=convert.to_numpy(td2))


@pytest.mark.parametrize("name", STATE)
def test_state_after_two_steps_matches(runs, name):
    assert_close(runs["js2"][name], runs["tn2"][name], 3e-8, name, floor=1.0)


def test_tracers_after_two_steps_match(runs):
    """Every tracer of trcrn (enthalpies, salinities, Tsfc, age, FY, level
    ice and ponds) as its conserved amount, each on its own scale."""
    tr = runs["m"].tr
    js2 = runs["js2"]
    t = lambda k: torch.as_tensor(js2[k])
    w_ref = tracer_weights(tr, t("aicen"), t("vicen"), t("vsnon"),
                           t("trcrn")) * t("trcrn")
    s = runs["ts2"]
    w_got = tracer_weights(tr, s.aicen, s.vicen, s.vsnon, s.trcrn) * s.trcrn
    names = {tr.nt_Tsfc: "Tsfc", tr.nt_iage: "iage", tr.nt_FY: "FY",
             tr.nt_alvl: "alvl", tr.nt_vlvl: "vlvl", tr.nt_apnd: "apnd",
             tr.nt_hpnd: "hpnd", tr.nt_ipnd: "ipnd"}
    for it in range(tr.ntrcr):
        assert_close(w_ref[:, it], w_got[:, it], 3e-8,
                     names.get(it, f"trcrn[{it}]"), floor=1e-6)
    # the pond and level-ice tracers are live in this run
    assert float(w_ref[:, tr.nt_hpnd].abs().max()) > 1e-4
    assert float(w_ref[:, tr.nt_alvl].abs().max()) > 0.1


@pytest.mark.parametrize("name", STRESS)
def test_stress_after_two_steps_matches(runs, name):
    assert_close(runs["js2"][name], runs["tn2"][name], 1e-5, name, floor=1.0)


@pytest.mark.parametrize("name", DIAG)
def test_diag_of_last_step_matches(runs, name):
    assert_close(runs["jd2"][name], runs["td2"][name], 3e-8, name, floor=1.0)


def test_stress_divergence_and_health_match(runs):
    for k in ("strintx", "strinty", "prs_sig"):
        assert_close(runs["jd2"][k], runs["td2"][k], 1e-5, k, floor=1.0)
    assert int(runs["jd2"]["state_bad"]) == int(runs["td2"]["state_bad"]) == 0
    assert bool(runs["jd2"]["therm_converged"])
    assert bool(runs["td2"]["therm_converged"])
    assert runs["td2"]["niter_thermo"] >= 1
    assert runs["td2"]["niter_ridge"] >= 1
    # the run reaches the seam: ice moves in the top rows
    assert np.abs(runs["tn2"]["uvel"][-2:]).max() > 0.0
    assert float(np.asarray(runs["jd2"]["fswabs"]).max()) > 1.0


def test_init_state_and_grid_match(runs):
    """The port's initial state and tripole grid (the seam umask from the
    fold image) against the JAX package's."""
    from cice5_tpu.driver.model import Model as JModel
    from cice5_tpu.grid import popgrid_np as jpopgrid
    from cice5_tpu import config as jconfig
    jc = jconfig.gx1_parity_config()
    d = U.parity_config_dict()
    jc = jc.replace(grid=jconfig.GridConfig(**d["grid"]),
                    dyn=jconfig.DynConfig(**d["dyn"]), dtype="float64",
                    accum_dtype="float64")
    jm = JModel(jc, grid=jpopgrid(jc, *U.parity_grid_arrays()))
    m = runs["m"]
    jst = jm.init_state()
    tst = m.init_state()
    for f in dataclasses.fields(jst):
        assert_close(np.asarray(getattr(jst, f.name)),
                     getattr(tst, f.name), 1e-13, f.name, floor=1.0)
    for f in dataclasses.fields(jm.grid):
        a = np.asarray(getattr(jm.grid, f.name)).astype(np.float64)
        assert_close(a, getattr(m.grid, f.name).double(), 1e-14, f.name,
                     floor=1.0)
    # land on the seam: the fold-image umask differs from a replicate one
    assert not bool(m.grid.umask[-1].all())


def test_float32_steps_stay_close(runs):
    """The port in float32 from the same warmed-up state: two steps run
    healthy (the f32 Picard floor of mushy.picard_solver) and stay within
    dtype-aware bounds of the JAX float64 result."""
    m = _model("float32")
    st = convert.state_from_arrays(_part(runs["ref"], "in"), device="cpu",
                                   dtype=torch.float32)
    f = convert.forcing_from_arrays(_part(runs["ref"], "forcing"),
                                    device="cpu", dtype=torch.float32)
    st2, d2 = m.rollout(st, [f, f], 2)
    assert st2.aicen.dtype == torch.float32
    assert int(d2.state_bad) == 0 and bool(d2.therm_converged)
    got = convert.to_numpy(st2)
    for k in ("aicen", "vicen", "vsnon", "sst"):
        assert_close(runs["js2"][k], got[k], 1e-2, k, floor=1.0)
    for k in ("uvel", "vvel"):
        assert_close(runs["js2"][k], got[k], 5e-2, k, floor=1.0)


def test_recorded_reference_matches_its_inputs():
    """The reference was recorded from the JAX package, configuration, grid
    and recipe as they stand; after a change to any of them, rewrite it
    (python tests/torch_port_util.py) and run the slow test below."""
    assert U.recorded_parity_key() == U.parity_reference_key(), (
        "tests/test_torch_parity_step.npz is stale: rewrite it with "
        "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_util.py")


@pytest.mark.slow
def test_recorded_reference_is_current():
    """The recorded reference is what the JAX package computes now."""
    new = U.make_parity_reference()
    old = U.load_parity_reference()
    assert sorted(new) == sorted(old)
    for k, a in new.items():
        assert_close(a, old[k], 1e-12, k, floor=1.0)
