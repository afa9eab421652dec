"""The model step as CUDA graphs: the port's ``jax.jit`` of ``Model.step``
and ``lax.scan`` of ``Model.rollout`` (``cice5_tpu/driver/model.py:142,
192-237``).

``StepGraph`` captures one step function once, for one set of input shapes
and dtypes, and replays it. A step has data-dependent loops (the BL99 or
mushy solver and ridging, ``ops/loop.py``), so it is captured as a
program of graphs in the order the step runs them:

- a *segment*: the step's code from one loop to the next; the segment
  before a loop ends by copying the loop's carry into buffers of its own
  and writing the loop's pending flag;
- a *pass* graph for each loop: one pass of the loop body, which updates
  those buffers in place and writes the flag again. A replay reads the
  flag and replays the pass while it is set, as the eager loop does: one
  host read per pass and one more per loop.

A pass graph could hold several passes, which the loops' over-run
invariance allows, for fewer host reads; on the H100 a read cost less
than the passes that such blocks run beyond those needed (PERF.md §6,
``tools/loop_blocks.py``), so a graph holds one pass. A replayed step equals the eager step
bit for bit, pass counts included.

All graphs of one step share one memory pool and replay in the order of
their capture, so a tensor freed early in the step lends its memory to a
later one as in the eager step. The inputs are static buffers
(``StepGraph.state``, ``StepGraph.forcing``) that the caller fills with
``load``. The last segment copies the new state into the state buffers,
so replays in a row chain steps on the device (the rollout) with no host
round trip; the diagnostics of the last replay stay in graph-owned
memory, which the next replay overwrites. ``result`` returns clones of
both, which no later replay touches.

Replays call no kernel wrapper, so each graph records the launches its
capture made (``kernels.launch_counts``) and every replay adds them to
the counters.

Inside a captured step nothing may read a device value on the host or
make a tensor from host data: a capture refuses both. ``HostSyncs`` is a
dispatch mode that counts them, or with ``strict`` raises at the first,
so that a CPU run finds one without a GPU (``tests/test_torch_graph.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cice5_tpu_torch.ops import kernels, loop

# ops that read a device value on the host (the host waits for the device)
SYNC_OPS = frozenset({"aten::_local_scalar_dense", "aten::is_nonzero",
                      "aten::item", "aten::nonzero", "aten::masked_select"})
# ops that make a tensor from host data (``torch.tensor``, ``as_tensor``):
# on the GPU a copy from host memory, which a capture refuses
HOST_MADE_OPS = frozenset({"aten::lift_fresh"})


class HostSyncError(RuntimeError):
    """A host sync or a host-made tensor where a captured step allows
    none."""


class HostSyncs(TorchDispatchMode):
    """Counts the host syncs (``SYNC_OPS``) and host-made tensors
    (``HOST_MADE_OPS``) of the PyTorch operations run under it, in
    ``syncs`` and ``host_made``; with ``strict`` it raises HostSyncError at
    the first one, unless inside ``allowed()``."""

    def __init__(self, strict: bool = False):
        super().__init__()
        self.strict = strict
        self.syncs = self.host_made = 0
        self._allowed = False

    @contextlib.contextmanager
    def allowed(self):
        self._allowed = True
        try:
            yield
        finally:
            self._allowed = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in SYNC_OPS or name in HOST_MADE_OPS:
            if name in SYNC_OPS:
                self.syncs += 1
            else:
                self.host_made += 1
            if self.strict and not self._allowed:
                what = ("a host sync" if name in SYNC_OPS
                        else "a tensor made from host data")
                raise HostSyncError(f"{name}: {what} inside a step that a "
                                    "CUDA graph captures")
        return func(*args, **(kwargs or {}))


def _tensor_fields(obj):
    """(name, tensor) of every tensor field of a State or Forcing."""
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if torch.is_tensor(getattr(obj, f.name))]


def clone_fields(obj):
    """A copy of a State or Forcing (dataclass) or StepDiag (NamedTuple)
    whose tensors own their memory."""
    if isinstance(obj, tuple):
        return type(obj)(*(t.clone() for t in obj))
    return dataclasses.replace(obj, **{n: t.clone()
                                       for n, t in _tensor_fields(obj)})


def signature(*objs) -> tuple:
    """(field, dtype, shape, device) of every tensor field: what a capture
    fixes."""
    return tuple((n, t.dtype, tuple(t.shape), t.device)
                 for obj in objs for n, t in _tensor_fields(obj))


class _Captured:
    """One graph of a step's program, the kernel launches its capture
    recorded, and for a loop's pass the pending flag that asks for a
    replay."""

    def __init__(self, graph, launches, flag):
        self.graph, self.launches, self.flag = graph, launches, flag

    def replay(self):
        self.graph.replay()
        kernels.add_launches(self.launches)


class StepGraph:
    """``fn(state, forcing) -> (state, diag)`` captured as CUDA graphs
    for inputs shaped as ``state`` and ``forcing``, after an eager call
    of ``fn`` on such inputs (which initialises what a capture may not:
    libraries, kernel builds, cached tables). A capture that fails
    raises."""

    def __init__(self, fn, state, forcing):
        t0 = time.perf_counter()
        self.state = clone_fields(state)
        self.forcing = clone_fields(forcing)
        self.replays = 0       # graph launches
        self.flag_reads = 0    # host reads of a loop's pending flag
        self.program: list[_Captured] = []
        self._pool = torch.cuda.graph_pool_handle()
        self._open = None
        torch.cuda.synchronize()
        # destroy the graphs of dead models now: a model in a reference
        # cycle (e.g. through its forcing_provider) waits for the cycle
        # collector, and a collection during the capture would destroy
        # its graphs there, which the capture refuses (torch.cuda.graph
        # collects first for the same reason)
        gc.collect()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(stream), loop.driven_by(self._loop):
                self._begin()
                new_state, self.diag = fn(self.state, self.forcing)
                # the new state goes to the input buffers: replays chain
                outs = dict(_tensor_fields(new_state))
                _check_no_cross_alias(outs, dict(_tensor_fields(self.state)))
                for name, buf in _tensor_fields(self.state):
                    buf.copy_(outs[name])
                self._end(None)
        finally:
            if self._open is not None:      # a failed capture: close it
                graph, self._open = self._open[0], None
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0   # host wall time

    def _begin(self):
        graph = torch.cuda.CUDAGraph()
        self._open = (graph, kernels.launch_counts())
        graph.capture_begin(pool=self._pool)

    def _end(self, flag):
        graph, before = self._open
        graph.capture_end()
        self._open = None
        # the capture launched nothing: its wrapper calls count at replay
        launches = {k: n - before[k] for k, n in
                    kernels.launch_counts().items() if n != before[k]}
        kernels.add_launches({k: -n for k, n in launches.items()})
        self.program.append(_Captured(graph, launches, flag))

    def _loop(self, body, pending, carry):
        """The loop driver under capture (``ops/loop.py``): ends the open
        segment, captures the loop's pass graph, opens the next segment."""
        # buffers of the loop's own, which the pass updates in place
        bufs = {name: t.clone() for name, t in carry.items()}
        flag = pending(bufs)
        self._end(None)
        self._begin()
        out = body(bufs, flag)
        _check_no_cross_alias(out, bufs)
        for name, t in out.items():
            bufs[name].copy_(t)
        flag.copy_(pending(bufs))
        self._end(flag)
        self._begin()
        return bufs

    def load(self, state=None, forcing=None):
        """Copy the given inputs into the static buffers (device to
        device)."""
        for obj, bufs in ((state, self.state), (forcing, self.forcing)):
            if obj is not None:
                for name, buf in _tensor_fields(bufs):
                    buf.copy_(getattr(obj, name))

    def replay(self):
        """One step: the state buffers advance, ``diag`` is the step's."""
        for item in self.program:
            if item.flag is None:
                self._replay(item)
            else:
                while self._read(item.flag):
                    self._replay(item)

    def _replay(self, item: _Captured):
        item.replay()
        self.replays += 1

    def _read(self, flag) -> bool:
        """A host read of a loop's pending flag: waits for the device."""
        self.flag_reads += 1
        return bool(flag)

    def result(self):
        """(state, diag) of the last replay, in memory of their own."""
        return clone_fields(self.state), clone_fields(self.diag)


def _check_no_cross_alias(outs: dict, bufs: dict):
    """Copying ``outs`` into ``bufs`` one by one must not overwrite an
    output not yet copied: no output may share memory with another key's
    buffer."""
    where = {b.untyped_storage().data_ptr(): n for n, b in bufs.items()
             if b.numel()}
    for name, t in outs.items():
        other = where.get(t.untyped_storage().data_ptr(), name) \
            if t.numel() else name
        if other != name:
            raise RuntimeError(f"captured output {name!r} shares memory "
                               f"with the input buffer of {other!r}")
