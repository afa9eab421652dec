"""The step of every option set of tests/test_torch_options.py as its CUDA
graphs run it, rehearsed on the CPU: each loop (the BL99, mushy or
zero-layer solver, ridging) run one pass at a time after a host read of
its pending flag, under the strict dispatch mode of test_torch_graph.py
that refuses any other host sync or tensor made from host data, from the
recorded warmed-up state in float64: bit for bit the eager step. So the
cesm and topo pond schemes (the `_calc_hpond` sort network), zero-layer
thermo, the coupler's fluxes, EAP on the T-fold and the aerosol, brine and
skeletal-BGC tracers capture as the earlier paths do.
"""
import pytest

from cice5_tpu_torch.driver import graph
from cice5_tpu_torch.driver.step import step as step_fn
import torch_option_sets as O
from test_torch_graph import _as_captured, _equal
from test_torch_options import port_inputs, port_model


@pytest.mark.parametrize("name", sorted(O.option_sets()))
def test_set_step_as_captured_equals_eager(name):
    ref = O.load_reference(name)
    m = port_model(name)
    st, f = port_inputs(ref)
    want = step_fn(st, f, *m.step_args)
    got, passes = _as_captured(step_fn, st, f, *m.step_args, k=1,
                               guard=graph.HostSyncs(strict=True))
    assert _equal(want[0], got[0]) == [] and _equal(want[1], got[1]) == []
    assert len(passes) >= 2 and sum(passes) >= 1


def test_revised_evp_reads_its_xmin_once_per_grid_before_any_capture():
    """The revised EVP's xmin (the ocean minimum of dxt and dyt) is read
    from the device once per grid (``step._min_spacing``). On a fresh
    grid the step as captured refuses that read; after one eager step,
    as ``StepGraph`` runs before it captures, the step as captured reads
    nothing and equals the eager step."""
    from cice5_tpu_torch.driver import step as step_mod
    ref = O.load_reference("revised_evp")
    m = port_model("revised_evp")
    st, f = port_inputs(ref)
    with pytest.raises(graph.HostSyncError) as e:
        _as_captured(step_fn, st, f, *m.step_args, k=1,
                     guard=graph.HostSyncs(strict=True))
    assert any(t.name == "_min_spacing" for t in e.traceback)
    want = step_fn(st, f, *m.step_args)
    assert step_mod._MIN_SPACING[id(m.grid.dxt)][1] == float(
        m.grid.dxt[m.grid.tmask].min().minimum(
            m.grid.dyt[m.grid.tmask].min()))
    got, _ = _as_captured(step_fn, st, f, *m.step_args, k=1,
                          guard=graph.HostSyncs(strict=True))
    assert _equal(want[0], got[0]) == [] and _equal(want[1], got[1]) == []
