"""The step as its CUDA graphs run it, rehearsed on the CPU.

``driver/graph.py`` captures the step's code between its data-dependent
loops as graphs, and each loop (``ops/loop.py``) as a graph of one pass
replayed after a host read of its pending flag. Checked here without a
GPU on small models (the BL99 model at 12x16 and the gx1-parity model at
24x16, ndte=4, float64 and float32):

- over-run invariance: passes of a loop body after every cell has
  converged change nothing, bit for bit, and leave the pass count as the
  eager loop left it (the BL99 solver, the two mushy Picard stages and
  ridging), so a loop may also run its passes in blocks;
- capture safety: the step with each loop run as its graphs run it (a
  flag read, then a block of k passes; k=1 is the captured program)
  under a strict ``graph.HostSyncs``, which raises at a host sync
  (``aten::_local_scalar_dense``, ``is_nonzero``, ``item``) or a tensor
  made from host data (``aten::lift_fresh``) anywhere but those flag
  reads, equals the eager step bit for bit over three steps.
"""
import dataclasses

import pytest
import torch

from cice5_tpu_torch.config import bench_easy_config, gx1_parity_config
from cice5_tpu_torch.driver import graph
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.driver.step import step as step_fn
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.ops import loop
from torch_port_util import PARITY_ISTEP, parity_grid_arrays

LOOPS = {"bl99": {"temperature_changes", "ridge_ice"},
         "parity": {"picard_solver", "ridge_ice"}}


def _model(name, dtype):
    """(model, state, forcing) of a small model on the CPU."""
    if name == "bl99":
        m = Model(bench_easy_config(ny=12, nx=16, ndte=4, dtype=dtype),
                  device="cpu")
        return m, m.init_state(ice_mask=m.grid.tmask), m.forcing_at(0)
    cfg = gx1_parity_config(dtype=dtype, accum_dtype=dtype)
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=24, nx=16),
                      dyn=dataclasses.replace(cfg.dyn, ndte=4))
    m = Model(cfg, grid=popgrid_np(cfg, *parity_grid_arrays(), device="cpu"),
              device="cpu")
    f = m.forcing_at(PARITY_ISTEP)
    return m, m.init_state(), f.replace(frain=torch.full_like(f.frain,
                                                              2.0e-5))


def _passes(body, pending, carry, k):
    """``k`` passes of a loop body with no host read."""
    for _ in range(k):
        carry = body(carry, pending(carry))
    return carry


def _as_captured(fn, *args, k, guard):
    """``fn(*args)`` under ``guard`` with each loop run as its captured
    graphs run it, in blocks of ``k`` passes, each after a host read of
    the pending flag (the only reads ``guard`` allows). Returns (fn's
    result, the passes each loop made)."""
    made = []

    def driver(body, pending, carry):
        n0 = carry["niter"]
        while True:
            with guard.allowed():
                if not bool(pending(carry)):
                    break
            carry = _passes(body, pending, carry, k)
        made.append(carry["niter"] - n0)
        return carry

    with loop.driven_by(driver), guard:
        out = fn(*args)
    return out, [int(n) for n in made]


def _equal(a, b):
    """Bit-for-bit equality of two states or diags (NaN equal to NaN)."""
    if isinstance(a, tuple):
        pairs = zip(a._fields, a, b)
    else:
        pairs = ((f.name, getattr(a, f.name), getattr(b, f.name))
                 for f in dataclasses.fields(a))
    return [n for n, x, y in pairs if torch.is_tensor(x)
            and not torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["bl99", "parity"])
def test_loop_bodies_are_over_run_invariant(name, dtype):
    """Each loop runs eagerly to its end, then three more passes: they
    change no entry of its carry and the step's result stays the eager
    step's, pass counts included."""
    m, st, f = _model(name, dtype)
    st, _ = step_fn(st, f, *m.step_args)            # a moving state
    ref = step_fn(st, f, *m.step_args)
    seen = []

    def driver(body, pending, carry):
        go = pending(carry)
        while bool(go):
            carry = body(carry, go)
            go = pending(carry)
        more = _passes(body, pending, carry, 3)
        changed = [k for k in carry if not torch.equal(carry[k], more[k])]
        seen.append((body.__qualname__.split(".")[0], int(carry["niter"]),
                     changed))
        return more

    with loop.driven_by(driver):
        got = step_fn(st, f, *m.step_args)
    assert {s[0] for s in seen} == LOOPS[name]
    assert all(n >= 1 for s, n, _ in seen if s != "picard_solver")
    assert [c for *_, c in seen] == [[]] * len(seen)
    assert _equal(ref[0], got[0]) == [] and _equal(ref[1], got[1]) == []
    assert int(got[1].niter_thermo) == sum(
        n for s, n, _ in seen if s != "ridge_ice")


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["bl99", "parity"])
def test_step_as_captured_equals_eager_and_makes_no_host_sync(name, dtype,
                                                              k):
    """Three steps with the loops in blocks of k passes, each after a read
    of the pending flag (k=1: as the captured graphs run them), under a
    strict HostSyncs equal three eager steps bit for bit, and each loop
    reports the eager passes."""
    m, st, f = _model(name, dtype)
    ref = got = st
    for _ in range(3):
        ref, dref = step_fn(ref, f, *m.step_args)
        guard = graph.HostSyncs(strict=True)
        (got, dgot), passes = _as_captured(step_fn, got, f, *m.step_args,
                                           k=k, guard=guard)
        assert _equal(ref, got) == [] and _equal(dref, dgot) == []
        assert guard.host_made == 0
        # the only syncs: a flag read before each block and one more per
        # loop
        assert guard.syncs == sum(-(-n // k) + 1 for n in passes)
        assert dgot.niter_thermo.dim() == 0 and dgot.niter_ridge.dim() == 0
        # ridging's first pass runs before its loop
        assert int(dgot.niter_thermo) + int(dgot.niter_ridge) \
            == sum(passes) + 1


def test_host_sync_guard_raises_on_a_read_and_a_host_tensor():
    x = torch.ones(3)
    with pytest.raises(graph.HostSyncError, match="_local_scalar_dense"):
        with graph.HostSyncs(strict=True):
            bool((x > 0).any())
    with pytest.raises(graph.HostSyncError, match="lift_fresh"):
        with graph.HostSyncs(strict=True):
            x + torch.tensor([1.0, 2.0, 3.0])
    counter = graph.HostSyncs()
    with counter:
        float(x.sum())
        with counter.allowed():
            int(x[0])
    assert counter.syncs == 2 and counter.host_made == 0


def test_model_on_the_cpu_stays_eager():
    """``device="cpu"``: step and rollout run the eager step, capture
    nothing, and give the module function's result."""
    m, st, f = _model("bl99", "float64")
    s1, d1 = m.rollout(st, f, 2)
    s2, d2 = step_fn(*step_fn(st, f, *m.step_args)[:1], f, *m.step_args)
    assert m.graphs == {}
    assert _equal(s1, s2) == [] and _equal(d1, d2) == []


COUPLED_OPTIONS = {
    "coupled_radiation": lambda c: c.replace(coupled_radiation=True),
    "formdrag": lambda c: c.replace(forcing=dataclasses.replace(
        c.forcing, formdrag=True)),
    "highfreq": lambda c: c.replace(forcing=dataclasses.replace(
        c.forcing, highfreq=True)),
    "Cdn_ocn": lambda c: c.replace(thermo=dataclasses.replace(
        c.thermo, fbot_xfer_type="Cdn_ocn")),
}


@pytest.mark.parametrize("option", list(COUPLED_OPTIONS) + ["all"])
def test_coupled_options_as_captured_equal_eager(option):
    """The gx1-parity step with each coupled-mode option (and with all
    four) run as its graphs run it, under a strict HostSyncs: two steps
    equal the eager steps bit for bit, with no host read but the loops'
    flag reads and no tensor made from host data (float32, from the
    initial state, which ``init_state`` prefills under
    coupled_radiation)."""
    m0, _, f = _model("parity", "float32")
    cfg = m0.cfg
    for name, on in COUPLED_OPTIONS.items():
        if option in (name, "all"):
            cfg = on(cfg)
    m = Model(cfg, grid=m0.grid, device="cpu")
    st = m.init_state()
    if cfg.coupled_radiation:
        assert float(st.rad_prev.abs().max()) > 0.0
    ref = got = st
    for _ in range(2):
        ref, dref = step_fn(ref, f, *m.step_args)
        guard = graph.HostSyncs(strict=True)
        (got, dgot), passes = _as_captured(step_fn, got, f, *m.step_args,
                                           k=1, guard=guard)
        assert _equal(ref, got) == [] and _equal(dref, dgot) == []
        assert guard.host_made == 0
        assert guard.syncs == sum(n + 1 for n in passes)
    assert dgot.drag.shape[0] == (17 if cfg.forcing.formdrag else 0)
