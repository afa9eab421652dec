"""Hierarchical named timers (PyTorch port of ``cice5_tpu/io/timers.py``).

Equivalent of mpi/ice_timers.F90 (:85-120 type, :324 start/stop, :665
print_all): named accumulating timers with a report table. PyTorch returns
before the GPU has finished, so a wall-clock timer means something only if
it waits for the device: ``timer(..., block=x)`` synchronizes every CUDA
device that holds a tensor of ``x`` before it stops. For kernel-level
profiling use ``torch.profiler`` (``python -m cice5_tpu_torch.profile_step``).
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch


@dataclass
class Timer:
    name: str
    total: float = 0.0
    count: int = 0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        self.total += time.perf_counter() - self._t0
        self.count += 1


def _tensors(obj):
    """Every tensor in ``obj``: a tensor, or a dataclass, NamedTuple,
    tuple, list or dict that holds tensors."""
    if torch.is_tensor(obj):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def block_until_ready(obj):
    """Wait until the device work that produces the tensors of ``obj`` is
    done (``jax.block_until_ready``): synchronize each CUDA device that
    holds one of them. CPU tensors are computed when they are returned."""
    for device in {t.device for t in _tensors(obj) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return obj


class Timers:
    # the ~15 standard timer names (mpi/ice_timers.F90:172-178)
    STANDARD = ("Total", "TimeLoop", "Dynamics", "Advection", "Column",
                "Thermo", "Shortwave", "Ridging", "CatConv", "Couple",
                "ReadWrite", "Diags", "Bound", "BGC", "Forcing")

    def __init__(self):
        self._timers: dict[str, Timer] = {}

    def get(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
        return self._timers[name]

    @contextmanager
    def timer(self, name: str, block=None):
        t = self.get(name)
        t.start()
        try:
            yield
        finally:
            if block is not None:
                block_until_ready(block)
            t.stop()

    def report(self) -> str:
        lines = ["Timer                    total(s)    count   mean(ms)"]
        for t in sorted(self._timers.values(), key=lambda x: -x.total):
            mean = t.total / t.count * 1e3 if t.count else 0.0
            lines.append(f"{t.name:<22} {t.total:10.3f} {t.count:8d} "
                         f"{mean:10.2f}")
        return "\n".join(lines)
