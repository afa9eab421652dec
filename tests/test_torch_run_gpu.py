"""The port's run loop on the card: ``Model.run`` replaying the step's
CUDA graphs, with restarts, history and the timers.

Marked ``gpu``: they skip without a CUDA device. This file imports no
JAX, so on the GPU machine it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_run_gpu.py

On the small gx1-parity model (24x16 tripole grid with land on the seam,
ndte=8), float32 unless named: a run of 8 steps equals, at 0.0 in every
State field, 4 steps, a restart, a fresh Model restored from the pointer
file and 4 more steps (whose first step is an eager capture step where
the continuous run replays); the history averages are the means of the
steps' values; a float64 restart runs in a float32 model; ``restore`` and
``Timers`` work on the card; a float64 run on the card writes the history
file of the same run on the CPU within 3e-8 of each variable's scale.
"""
import dataclasses
import gc
import os

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from cice5_tpu_torch.config import gx1_parity_config
from cice5_tpu_torch.driver import graph
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.io import history as thist
from cice5_tpu_torch.io import restart as trestart
from cice5_tpu_torch.io import timers as ttimers
from cice5_tpu_torch.state import State
from torch_port_util import (MELT_NOISE, ONSET, PARITY_ISTEP,  # noqa: F401
                             cuda_device, parity_grid_arrays, rainy_forcing)

pytestmark = pytest.mark.gpu


def _model(device, dtype="float32"):
    cfg = gx1_parity_config(dtype=dtype, accum_dtype=dtype)
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=24, nx=16),
                      dyn=dataclasses.replace(cfg.dyn, ndte=8))
    m = Model(cfg, grid=popgrid_np(cfg, *parity_grid_arrays(),
                                   device="cpu"), device=device)
    m.forcing_provider = rainy_forcing(m)
    return m


class Recording(thist.HistoryStream):
    """A stream that keeps each step's aice and the averages of the last
    file it wrote."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.aice, self.last = [], {}

    def accum(self, values, time):
        self.aice.append(values["aice"].clone())
        super().accum(values, time)

    def averages(self, dims="2D"):
        self.last[dims] = super().averages(dims)
        return self.last[dims]


def test_restored_run_equals_the_continuous_run(cuda_device, tmp_path):
    quiet = lambda *a: None
    m = _model(cuda_device)
    st0 = m.init_state()
    full = m.run(st0, 8, start_step=PARITY_ISTEP, check_every=1, log=quiet)
    m.run(st0, 4, start_step=PARITY_ISTEP, restart_every=4,
          restart_dir=str(tmp_path), log=quiet)
    (g,) = m.graphs.values()
    assert g.replays > 0
    st, meta = trestart.restore(pointer_dir=str(tmp_path))
    assert st.aicen.device.type == "cuda"
    assert meta["istep"] == PARITY_ISTEP + 4
    m2 = _model(cuda_device)
    out = m2.run(st, 4, start_step=meta["istep"], log=quiet)
    differ = [f.name for f in dataclasses.fields(State)
              if not torch.equal(getattr(out, f.name),
                                 getattr(full, f.name))]
    assert not differ


def test_a_fresh_model_captures_while_a_dead_one_awaits_collection(
        cuda_device):
    """A model with graphs that is garbage in a reference cycle (here
    through its forcing_provider) is collected before the next capture,
    not during it: a collection inside the capture destroyed the dead
    model's graphs there and the capture failed ("operation not permitted
    when stream is capturing")."""
    m = _model(cuda_device)
    st = m.init_state()
    m.step(st, m.forcing_at(PARITY_ISTEP))
    assert m.graphs
    del m
    m2 = _model(cuda_device)
    eager, calls = m2._eager, []

    def collecting(state, forcing):
        calls.append(1)
        if len(calls) == 2:       # the capture's call, not the eager one
            gc.collect()
        return eager(state, forcing)
    m2._eager = collecting
    out = m2.run(st, 2, start_step=PARITY_ISTEP, log=lambda *a: None)
    assert len(calls) == 2 and m2.graphs
    assert torch.isfinite(out.vicen).all()


def test_history_on_the_card(cuda_device, tmp_path):
    m = _model(cuda_device)
    s = Recording(thist.available_fields(m.cfg, m.tr), freq="1", freq_n=2)
    m.run(m.init_state(), 4, start_step=PARITY_ISTEP, history=s,
          history_dir=str(tmp_path), log=lambda *a: None)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2
    with netcdf_file(str(tmp_path / files[1]), "r", mmap=False) as f:
        for name, v in f.variables.items():
            assert np.isfinite(np.asarray(v[:])).all(), name
        got = np.asarray(f.variables["aice"][0])
    a = [x.cpu().numpy() for x in s.aice[2:]]
    np.testing.assert_array_equal(got, (a[0] + a[1]) / np.float32(2))
    # accumulation reads nothing back from the card
    n, nc, ni, ns = 24, m.cfg.ncat, m.cfg.nilyr, m.cfg.nslyr
    shapes = {"2D": (n, 16), "3Dc": (nc, n, 16), "4Di": (ni, nc, n, 16),
              "4Ds": (ns, nc, n, 16)}
    values = {f.name: torch.ones(shapes[f.dims], device=cuda_device)
              for f in s.fields}
    s.accum(values, 0.0)
    s.accum(values, 1.0)
    with graph.HostSyncs() as hs:
        s.accum(values, 2.0)
    assert hs.syncs == 0 and hs.host_made == 0


def test_a_float64_restart_runs_in_a_float32_model(cuda_device, tmp_path):
    m64 = _model("cpu", "float64")
    path = str(tmp_path / "iced.npz")
    trestart.dump(m64.init_state(), path, istep=0, time=0.0)
    st, _ = trestart.restore(path, dtype=torch.float32)
    m = _model(cuda_device)
    out = m.run(st, 3, start_step=PARITY_ISTEP, check_every=1,
                log=lambda *a: None)
    assert out.aicen.dtype == torch.float32
    assert torch.isfinite(out.vicen).all()
    (key,) = m.graphs
    assert {d for _, d, *_ in key} == {torch.float32}


def test_timer_block_synchronizes_the_card(cuda_device, monkeypatch):
    calls = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (calls.append(device),
                                             sync(device)))
    t = ttimers.Timers()
    x = torch.ones(1000, device=cuda_device)
    with t.timer("Thermo", block=(x, {"y": x * 2})):
        x = x * 3
    assert calls == [x.device]
    with t.timer("Dynamics", block=torch.ones(2)):
        pass
    assert calls == [x.device]


def test_a_float64_run_on_the_card_writes_the_cpu_history(cuda_device,
                                                          tmp_path):
    """From one warmed-up state (a step on the CPU), 2 steps on each
    device, one history file each: every average within 3e-8 of its
    field's scale (the surface-melt noise and the melt onset date as
    tests/test_torch_run.py holds them), every float32 variable of the
    files within that plus 1 float32 ulp of its scale."""
    mc, mg = _model("cpu", "float64"), _model(cuda_device, "float64")
    st, _ = mc.step(mc.init_state(), mc.forcing_at(PARITY_ISTEP))
    streams = {}
    for m, d, s in ((mc, "cpu", st), (mg, "gpu", st.to(cuda_device))):
        streams[d] = Recording(thist.available_fields(m.cfg, m.tr),
                               freq="1", freq_n=2)
        m.run(s, 2, start_step=PARITY_ISTEP + 1, log=lambda *a: None,
              history=streams[d], history_dir=str(tmp_path / d))
    for dims, fl in streams["cpu"].groups.items():
        a, b = streams["cpu"].last[dims], streams["gpu"].last[dims]
        for i, f in enumerate(fl):
            if f.name == ONSET:
                continue
            scale = max(float(np.abs(a[i]).max(initial=0.0)),
                        1.0 if f.name in MELT_NOISE else 1e-300)
            assert np.abs(a[i] - b[i]).max(initial=0.0) <= 3e-8 * scale, \
                f.name
    (name,) = os.listdir(tmp_path / "cpu")
    with netcdf_file(str(tmp_path / "cpu" / name), "r", mmap=False) as a, \
            netcdf_file(str(tmp_path / "gpu" / name), "r", mmap=False) as b:
        assert list(a.variables) == list(b.variables)
        # a file holds each average times its field's output scale
        out = {f.name: f.scale for f in streams["cpu"].fields}
        for k, va in a.variables.items():
            if k == ONSET:
                continue
            x = np.asarray(va[:], np.float64)
            y = np.asarray(b.variables[k][:], np.float64)
            scale = max(float(np.abs(x).max(initial=0.0)),
                        out[k] if k in MELT_NOISE else 1e-300)
            ulp = float(np.spacing(np.float32(scale)))
            assert np.abs(x - y).max(initial=0.0) <= 3e-8 * scale + ulp, k
