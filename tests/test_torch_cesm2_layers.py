"""CESM2's sea-ice column (CICE 5.1.2 with mushy thermodynamics, 8 ice
and 3 snow layers; Bailey et al. 2020, JAMES) in the port, module by
module, against the JAX package on the CPU in float64.

The ``cesm2_layers`` sets of tests/torch_option_sets.py (the gx1-parity
physics at ``nilyr=8, nslyr=3`` on the 24x16 tripole mesh, under mushy
and under BL99 thermo) hold the whole step in test_torch_options.py,
_graph.py and _gpu.py; kernel C's lane schedule at 8/3 is in
test_torch_dedd_lanes.py, the dEdd column in test_torch_dedd.py, and the
CICE 5 restart in test_torch_restart_v5.py. Here, on the sets' recorded
warmed-up states: the configuration and its tracer registry (27 tracers
against 17 at 4/1), the initial state of ``Model.init_state``, the state
and forcing carried across by ``convert``, the global diagnostics and the
state check, and the history catalog, values and file with the layered
4Di (8 levels) and 4Ds (3 levels) fields and the npz restarts, each
against the JAX package's function.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from cice5_tpu_torch import config as tconfig
from cice5_tpu_torch import convert
from cice5_tpu_torch.io import diagnostics as tdiag
from cice5_tpu_torch.state import build_tracer_registry
import torch_option_sets as O
import torch_port_util as U
from torch_port_util import assert_close
from test_torch_options import check_history_and_restarts, port_inputs, \
    port_model

from cice5_tpu import config as jconfig
from cice5_tpu.driver.model import Model as JModel
from cice5_tpu.grid import popgrid_np as jpopgrid
from cice5_tpu.io import diagnostics as jdiag
from cice5_tpu.state import State as JState
from cice5_tpu.state import build_tracer_registry as jbuild

SETS = list(O.LAYER_SETS)


def test_config_is_gx1_parity_at_cesm2_layers():
    """The path's configuration is gx1_parity_config with CESM2's
    layer counts, in both packages; the sets are it on the test mesh."""
    t = tconfig.gx1_parity_config(nilyr=8, nslyr=3)
    j = jconfig.gx1_parity_config(nilyr=8, nslyr=3)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.nilyr, t.nslyr, t.thermo.ktherm) == (8, 3, 2)
    for name in SETS:
        cfg = O.option_sets()[name]
        assert (cfg.nilyr, cfg.nslyr) == (8, 3)
        assert cfg.tracers == t.tracers and cfg.shortwave == t.shortwave


@pytest.mark.parametrize("name", SETS)
def test_tracer_registry_matches_jax(name):
    """27 tracers at 8/3 (17 at 4/1): every index of the registry as the
    JAX package's, the 3 snow enthalpies after the 8 enthalpies and 8
    salinities of the ice layers."""
    cfg = O.option_sets()[name]
    tr, jtr = build_tracer_registry(cfg), jbuild(U.jax_config(cfg))
    assert tr.ntrcr == jtr.ntrcr == 27
    assert build_tracer_registry(cfg.replace(nilyr=4, nslyr=1)).ntrcr == 17
    for f in dataclasses.fields(jtr):
        assert getattr(tr, f.name) == getattr(jtr, f.name), f.name
    assert tr.nt_sice == tr.nt_qice + 8 and tr.nt_qsno == tr.nt_sice + 8
    assert tr.nt_qsno + 3 <= tr.nt_iage


def test_init_state_matches_jax():
    """``Model.init_state`` of the cesm2_layers set against the JAX
    package's: the profiles of 8 ice and 3 snow layers bit for bit."""
    name = "cesm2_layers"
    m = port_model(name)
    cfg = U.jax_config(m.cfg)
    jm = JModel(cfg, grid=jpopgrid(cfg, *O.grid_arrays()))
    got, ref = m.init_state(), jm.init_state()
    for f in dataclasses.fields(JState):
        a = getattr(ref, f.name)
        if a is not None:
            assert_close(np.asarray(a), getattr(got, f.name), 1e-14, f.name,
                         floor=1.0)
    q = got.trcrn[:, m.tr.nt_qsno:m.tr.nt_qsno + 3]
    has = got.vsnon > 0
    assert bool(has.any()) and bool((q[:, 0][has] < 0).all())


@pytest.mark.parametrize("name", SETS)
def test_convert_carries_state_and_forcing(name):
    """The recorded JAX state and forcing through ``convert`` and back:
    bit for bit, the layer tracers in their slots."""
    ref = O.load_reference(name)
    st, f = port_inputs(ref)
    back = convert.to_numpy(st)
    for k, v in O.part(ref, "in").items():
        np.testing.assert_array_equal(back[k], v, k)
    fb = convert.to_numpy(f)
    for k, v in O.part(ref, "forcing").items():
        np.testing.assert_array_equal(fb[k], v, k)
    assert st.trcrn.shape[1] == 27


@pytest.mark.parametrize("name", SETS)
def test_diagnostics_match_jax(name):
    """The global diagnostics and the state check of the port's step at
    8/3 against the JAX package's on the same state (1e-12 of each
    budget's scale; the same verdict and text)."""
    ref = O.load_reference(name)
    m = port_model(name)
    st, f = port_inputs(ref)
    s, _ = m.step(st, f)
    jcfg = U.jax_config(m.cfg)
    js = U.jax_obj(JState, s)
    jgrid = jpopgrid(jcfg, *O.grid_arrays())
    jtr = jbuild(jcfg)
    got = tdiag.compute_diags(s, m.grid, m.tr, 8, 3)
    want = jdiag.compute_diags(js, jgrid, jtr, 8, 3)
    for k, v in got._asdict().items():
        assert_close(np.asarray(getattr(want, k)), v, 1e-12, k)
    logs, jlogs = [], []
    assert tdiag.check_state(s, m.grid, m.tr, 8, 3, log=logs.append) == \
        bool(jdiag.check_state(js, jgrid, jtr, 8, 3, log=jlogs.append))
    assert logs == jlogs


@pytest.mark.parametrize("name", SETS)
def test_layered_history_and_restarts_interchange(name, tmp_path):
    """The history catalog, the values of a step and the file at 8/3
    against the JAX package's (test_torch_options.py's
    ``check_history_and_restarts``), with the layered fields on 8 ice and
    3 snow levels, each snow level its own values; npz restarts both
    ways bit for bit."""
    path, values = check_history_and_restarts(name, tmp_path)
    assert values["Tinz"].shape[0] == 8 and values["Tsnz"].shape[0] == 3
    with netcdf_file(path, "r", mmap=False) as nc:
        assert nc.dimensions["nkice"] == 8 and nc.dimensions["nksnow"] == 3
        tsnz = np.asarray(nc.variables["Tsnz"][0])
    assert tsnz.shape[0] == 3
    assert not np.array_equal(tsnz[0], tsnz[2])
