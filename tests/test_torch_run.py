"""The port's standalone run loop (``Model.run`` / ``run_loop``,
CICE_RunMod.F90:37-90) against the JAX package's, on the gx1-parity model
of test_torch_parity_step.py (24x16 tripole grid with land on the seam,
ndte=8, float64), from its recorded warmed-up state: 4 steps with rain on
the ice (a ``forcing_provider``), a state check every step, the runtime
diagnostics every 2 steps, a history stream of every available field
written every 2 steps and a restart every 2 steps.

- Against the JAX run_loop recorded in test_torch_run.npz
  (``torch_port_util.make_run_reference``, under a hash of its inputs;
  the test marked slow recomputes it): the final state within 3e-8 x
  scale (the stress state 1e-5 x scale; tracers as conserved amounts), as
  test_torch_parity_step.py holds two steps; the history averages and the
  global diagnostics within the same bounds, each field on its own scale;
  the log lines equal. The surface melt of this run's cold surfaces is
  rounding noise, and the melt onset date that tests it for > 0 is
  compared where the melt is real.
- Against the JAX run_loop on the same steps: the JAX run_loop drives the
  port's step outputs (a stand-in model), so everything after the step is
  compared on identical inputs: history averages within 1e-12 of each
  field's scale, history files to 1 float32 ulp of each variable's scale
  with the same variables, dimensions, units and long names, restart
  files bit for bit, the log lines equal.
- Exact continuation: 3 steps from the run's first restart, restored
  into a fresh Model, equal the run's last 3 steps at 0.0 in every State
  field.
- The loop's other branches on a small BL99 model: boundary restoring,
  the state check that stops a run, dump_last, the dtype guard and a JAX
  float64 restart restored into a float32 model.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from cice5_tpu_torch import convert
from cice5_tpu_torch.config import bench_easy_config
from cice5_tpu_torch.driver.model import Model, run_loop
from cice5_tpu_torch.forcing import idealized_polar_forcing
from cice5_tpu_torch.io import diagnostics as tdiag
from cice5_tpu_torch.io import history as thist
from cice5_tpu_torch.io import restart as trestart
from cice5_tpu_torch.models.thermo.itd import tracer_weights
from cice5_tpu_torch.state import State
import torch_port_util as U
from torch_port_util import assert_close

STATE = ("aicen", "vicen", "vsnon", "uvel", "vvel", "sst", "frzmlt",
         "strocnxT", "strocnyT", "iceumask", "scale_factor", "frz_onset")
ONSET = U.ONSET
STRESS = ("stressp", "stressm", "stress12")
# history fields that carry the EVP stress state or the replacement
# pressure: held as the stress state is (1e-5 x scale)
STRESS_FIELDS = {"sig1", "sig2", "trsig", "s11", "s12", "s22", "strintx",
                 "strinty"}



@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's run loop as the recorded JAX run ran, with every step's
    input and output kept."""
    tmp = tmp_path_factory.mktemp("run")
    ref = U.load_parity_reference()
    m = U.port_parity_model()
    st = convert.state_from_arrays(
        {k[3:]: v for k, v in ref.items() if k.startswith("in/")},
        device="cpu")
    steps = []
    step = m.step

    def recording_step(state, forcing):
        out = step(state, forcing)
        steps.append((state, forcing) + out)
        return out
    m.step = recording_step
    gds = {}

    def diag_fn(istep, state, diag):
        gds[istep] = tdiag.compute_diags(state, m.grid, m.tr, m.cfg.nilyr,
                                         m.cfg.nslyr)
    stream = U.recording_stream(thist.HistoryStream)(
        thist.available_fields(m.cfg, m.tr), **U.RUN_HISTORY)
    lines = []
    final = run_loop(m, st, U.RUN_NSTEPS, start_step=U.RUN_START,
                     diag_fn=diag_fn, history=stream,
                     history_dir=str(tmp / "history"),
                     restart_dir=str(tmp / "restart"), log=lines.append,
                     **U.RUN_KW)
    return dict(m=m, start=st, final=final, steps=steps, gds=gds,
                files=stream.files, lines=lines, dir=tmp,
                fields=stream.groups, jref=U.load_run_reference())


@pytest.mark.parametrize("name", STATE + STRESS)
def test_final_state_matches_the_jax_run_loop(run, name):
    tol = 1e-5 if name in STRESS else 3e-8
    assert_close(run["jref"][f"out/{name}"], getattr(run["final"], name),
                 tol, name, floor=1.0)


def test_final_tracers_match_the_jax_run_loop(run):
    """Every tracer as its conserved amount, each on its own scale."""
    tr = run["m"].tr
    t = lambda k: torch.as_tensor(run["jref"][f"out/{k}"])
    w_ref = tracer_weights(tr, t("aicen"), t("vicen"), t("vsnon"),
                           t("trcrn")) * t("trcrn")
    s = run["final"]
    w_got = tracer_weights(tr, s.aicen, s.vicen, s.vsnon, s.trcrn) * s.trcrn
    for it in range(tr.ntrcr):
        assert_close(w_ref[:, it], w_got[:, it], 3e-8, tr.names[it],
                     floor=1e-6)


@pytest.mark.parametrize("k", [0, 1])
def test_history_averages_match_the_jax_run_loop(run, k):
    """Each field of each written file, against its own scale (the
    stress-state fields 1e-5, the rest 3e-8; the surface-melt noise
    against a scale of at least 1; the onset dates below)."""
    assert len(run["files"]) == 2
    for dims, fl in run["fields"].items():
        ref, got = run["jref"][f"hist{k}/{dims}"], run["files"][k][dims]
        for i, f in enumerate(fl):
            if f.name == ONSET:
                continue
            tol = 1e-5 if f.name in STRESS_FIELDS else 3e-8
            assert_close(ref[i], got[i], tol, f"file {k} {f.name}",
                         floor=1.0 if f.name in U.MELT_NOISE else 1e-300)


def test_onset_dates_differ_only_where_the_melt_is_rounding_noise(run):
    """Where the final melt onset date differs from the JAX run's, the
    port's top melt was at most 1e-30 m in every step of the run: the
    reference's "meltt > 0" gate (cice5_tpu/driver/step.py:1135) on
    rounding noise, as the pond lid's "no fresh water" gate."""
    differ = run["jref"]["out/mlt_onset"] != run["final"].mlt_onset.numpy()
    melt = max(float(d.meltt[torch.from_numpy(differ)].abs().max(
        ).item() if differ.any() else 0.0) for *_, d in run["steps"])
    assert melt <= 1e-30, melt


def test_diagnostics_and_log_match_the_jax_run_loop(run):
    assert sorted(run["gds"]) == [U.RUN_START + 1, U.RUN_START + 3]
    for istep, gd in run["gds"].items():
        for name, v in gd._asdict().items():
            assert_close(run["jref"][f"gd{istep}/{name}"], v, 3e-8,
                         f"istep {istep} {name}")
    got = "\n".join(U.run_log_key(x) for x in run["lines"])
    assert got == str(run["jref"]["log"])


class _PortStepsForJax:
    """A model for the JAX run_loop whose steps are the port's recorded
    steps, handed over through NumPy: the JAX loop then runs its
    diagnostics, history and restarts on the port's step outputs."""

    def __init__(self, run):
        from cice5_tpu.calendar import Calendar
        from cice5_tpu.grid import popgrid_np as jpopgrid
        from cice5_tpu.parallel import Topology
        from cice5_tpu.state import build_tracer_registry
        m = run["m"]
        self.cfg = U.jax_config(m.cfg)
        self.grid = jpopgrid(self.cfg, *U.parity_grid_arrays())
        self.tr = build_tracer_registry(self.cfg)
        self.topo = Topology(ew=m.topo.ew, ns=m.topo.ns)
        self.calendar = Calendar(m.cfg.time.year_init,
                                 m.cfg.time.days_per_year,
                                 m.cfg.time.use_leap_years)
        self.steps = list(run["steps"])

    def forcing_at(self, istep):
        from cice5_tpu.forcing import Forcing as JForcing
        return U.jax_obj(JForcing, self.steps[0][1])

    def step(self, state, forcing):
        from cice5_tpu.state import State as JState
        sin, _, sout, diag = self.steps.pop(0)
        for f in dataclasses.fields(sin):     # the same input state
            np.testing.assert_array_equal(np.asarray(getattr(state, f.name)),
                                          getattr(sin, f.name).numpy())
        return U.jax_obj(JState, sout), U.jax_diag(diag)


def test_run_loop_matches_the_jax_run_loop_on_the_same_steps(run, tmp_path):
    from cice5_tpu.driver.model import run_loop as jrun_loop
    from cice5_tpu.io import history as jhist
    from cice5_tpu.state import State as JState
    jm = _PortStepsForJax(run)
    stream = U.recording_stream(jhist.HistoryStream)(
        jhist.available_fields(jm.cfg, jm.tr), **U.RUN_HISTORY)
    lines = []
    jrun_loop(jm, U.jax_obj(JState, run["start"]), U.RUN_NSTEPS, start_step=U.RUN_START, history=stream,
              history_dir=str(tmp_path / "history"),
              restart_dir=str(tmp_path / "restart"), log=lines.append,
              **U.RUN_KW)
    assert not jm.steps
    assert [U.run_log_key(x) for x in lines] == \
        [U.run_log_key(x) for x in run["lines"]]
    # history: the f64 averages, then the files
    assert [f.name for f in stream.fields] == \
        [f.name for fl in run["fields"].values() for f in fl]
    for k, (ref, got) in enumerate(zip(stream.files, run["files"])):
        for dims, fl in run["fields"].items():
            for i, f in enumerate(fl):
                assert_close(ref[dims][i], got[dims][i], 1e-12,
                             f"file {k} {f.name}", floor=1e-300)
    names = sorted(os.listdir(tmp_path / "history"))
    assert names == sorted(os.listdir(run["dir"] / "history"))
    for n in names:
        U.assert_same_history_file(tmp_path / "history" / n,
                                 run["dir"] / "history" / n)
    # restarts: bit for bit, pointer file included
    names = sorted(os.listdir(tmp_path / "restart"))
    assert names == sorted(os.listdir(run["dir"] / "restart"))
    for n in names:
        if n == trestart.POINTER_NAME:
            continue
        with np.load(tmp_path / "restart" / n) as a, \
                np.load(run["dir"] / "restart" / n) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{n} {k}")
                assert a[k].dtype == b[k].dtype


def test_restored_run_equals_the_continuous_run(run):
    """Exact restart (ice_restart_driver.F90's contract, tests/test_io.py
    TestRestart): the run's first restart (after its first step, at an
    even step number), restored into a fresh Model, then the run's other
    3 steps, equals the run's end at 0.0 in every field."""
    rdir = run["dir"] / "restart"
    first = sorted(n for n in os.listdir(rdir) if n.startswith("iced."))[0]
    st, meta = trestart.restore(str(rdir / first), device="cpu")
    assert meta["istep"] == U.RUN_START + 1
    m = U.port_parity_model()
    out = m.run(st, U.RUN_START + U.RUN_NSTEPS - meta["istep"],
                start_step=meta["istep"], log=lambda *a: None)
    for f in dataclasses.fields(State):
        assert torch.equal(getattr(out, f.name),
                           getattr(run["final"], f.name)), f.name


def test_recorded_reference_matches_its_inputs():
    """After a change to the JAX package, the parity reference or the
    recipe, rewrite test_torch_run.npz (python tests/torch_port_util.py
    run) and run the slow test below."""
    assert U.recorded_run_key() == U.run_reference_key(), (
        "tests/test_torch_run.npz is stale: rewrite it with "
        "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_util.py run")


@pytest.mark.slow
def test_recorded_reference_is_current():
    new = U.make_run_reference()
    old = U.load_run_reference()
    assert sorted(new) == sorted(old)
    assert str(new.pop("log")) == str(old.pop("log"))
    for k, a in new.items():
        assert_close(a, old[k], 1e-12, k, floor=1.0)


# ---------------------------------------------------------------------
# the loop's other branches, on a small BL99 model
# ---------------------------------------------------------------------

def bl99_model(dtype="float64", **forcing):
    cfg = bench_easy_config(ny=12, nx=16, ndte=10, dtype=dtype)
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ew_boundary="open"),
                      forcing=dataclasses.replace(cfg.forcing, **forcing))
    m = Model(cfg, device="cpu")
    return m, m.init_state(ice_mask=m.grid.tmask)


def test_run_loop_restores_the_open_boundaries():
    """restore_ice with trestore=0 holds the boundary cells at the initial
    state (tests/test_restoring.py:test_run_loop_restores); the interior
    moves."""
    m, st = bl99_model(restore_ice=True, trestore=0)
    out = m.run(st, 2, log=lambda *a: None)
    for name in ("aicen", "vicen", "vsnon", "trcrn"):
        a, b = getattr(out, name), getattr(st, name)
        assert torch.equal(a[..., :, 0], b[..., :, 0]), name
        assert torch.equal(a[..., :, -1], b[..., :, -1]), name
        assert torch.equal(a[..., 0, :], b[..., 0, :]), name
    assert not torch.equal(out.vicen[:, 1:-1, 1:-1], st.vicen[:, 1:-1, 1:-1])


def test_check_state_stops_the_run():
    m, st = bl99_model()
    step = m.step

    def bad_step(state, forcing):
        s, d = step(state, forcing)
        uvel = s.uvel.clone()
        uvel[3, 4] = float("nan")
        return s.replace(uvel=uvel), d
    m.step = bad_step
    lines = []
    with pytest.raises(RuntimeError, match="check_state failed at istep 0"):
        m.run(st, 2, check_every=5, log=lines.append)
    assert "uvel[3,4] = nan" in lines[0]
    assert "print_state bad cell (3,4)" in lines[1]


def test_run_split_times_the_run_without_changing_it(tmp_path):
    """profile_step.run_split runs Model.run as it is: the same final
    state and history file as the plain run, every part of the loop timed
    (the parts and the rest add up to the total), and the wrapped
    functions restored afterwards."""
    from cice5_tpu_torch.driver import model as model_mod
    from cice5_tpu_torch.profile_step import run_split
    m, st = bl99_model()
    fields = thist.available_fields(m.cfg, m.tr)
    kw = dict(check_every=1, log=lambda *a: None)
    want = m.run(st, 4, history=thist.HistoryStream(fields, "1", 4),
                 history_dir=str(tmp_path / "plain"), **kw)
    saved = (m.step, model_mod.diag_mod.check_state,
             model_mod.hist_mod.diag_to_values,
             model_mod.hist_mod.write_netcdf)
    got, split = run_split(m, st, 4, history=thist.HistoryStream(
        fields, "1", 4), history_dir=str(tmp_path / "split"), **kw)
    for f in dataclasses.fields(State):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    U.assert_same_history_file(
        str(tmp_path / "plain" / os.listdir(tmp_path / "plain")[0]),
        str(tmp_path / "split" / os.listdir(tmp_path / "split")[0]))
    assert set(split) == {"step", "check_state", "history_values",
                          "history_accum", "history_write", "rest", "total"}
    assert all(v > 0.0 for k, v in split.items() if k != "rest")
    assert split["rest"] >= 0.0
    parts = sum(v for k, v in split.items() if k != "total")
    assert abs(parts - split["total"]) <= 1e-9 * split["total"]
    assert (m.step, model_mod.diag_mod.check_state,
            model_mod.hist_mod.diag_to_values,
            model_mod.hist_mod.write_netcdf) == saved
    assert "step" not in vars(m)


def test_dump_last_writes_a_restart_off_the_schedule(tmp_path):
    m, st = bl99_model()
    m.run(st, nsteps=3, restart_every=2, restart_dir=str(tmp_path),
          dump_last=True, log=lambda *a: None)
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("iced."))
    assert len(files) == 2
    _, meta = trestart.restore(pointer_dir=str(tmp_path), device="cpu")
    assert meta["istep"] == 3


def test_a_jax_float64_restart_runs_in_a_float32_model(tmp_path):
    """restore(dtype=...) casts as the JAX package does: a float64 restart
    that the JAX package wrote runs in the port's float32 model; a state
    of the wrong dtype is refused."""
    from cice5_tpu.io import restart as jrestart
    from cice5_tpu.state import State as JState
    m64, st = bl99_model()
    path = str(tmp_path / "iced.npz")
    jrestart.dump(U.jax_obj(JState, st), path, istep=0, time=0.0)
    m32, _ = bl99_model("float32")
    with pytest.raises(ValueError, match="restore"):
        m32.run(st, 1)
    st32, meta = trestart.restore(path, dtype=torch.float32, device="cpu")
    assert all(getattr(st32, f.name).dtype == torch.float32
               for f in dataclasses.fields(State))
    out = m32.run(st32, 2, check_every=1, log=lambda *a: None)
    assert torch.isfinite(out.vicen).all() and out.vicen.sum() > 0


def test_forcing_provider_feeds_the_run():
    m, st = bl99_model(oceanmixed_ice=True)
    seen = []

    def provider(istep, info):
        seen.append((istep, info.istep))
        return idealized_polar_forcing(
            m.grid.shape, info.yday, dtype=m.cfg.xp_dtype, tlat=m.grid.TLAT,
            tlon=m.grid.TLON, orb=m.orb, device=m.device)
    m.forcing_provider = provider
    m.init_state(ice_mask=m.grid.tmask)     # no forcing call for sst
    assert not seen
    m.run(st, 2, start_step=5, log=lambda *a: None)
    assert seen == [(5, 5), (6, 6)]


def test_run_loop_has_the_jax_signature():
    import inspect
    from cice5_tpu.driver.model import Model as JModel
    from cice5_tpu.driver.model import run_loop as jrun_loop
    assert inspect.signature(run_loop) == inspect.signature(jrun_loop)
    assert inspect.signature(Model.run) == inspect.signature(JModel.run)
