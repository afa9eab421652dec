"""Reading a ``torch.profiler`` trace of a short window.

``profiled(fn)`` runs ``fn`` under the profiler (host and device
activities), synchronized before and after, and returns its result with
a summary of the trace: the device operations (kernels, copies and
fills) and their count; the busy time as the union of their intervals;
the window's length on the host clock; the device time of each operation
name; and the idle gaps between device operations, each named by what
the host was doing at its middle (the innermost host event there, under
the outermost of the benchmark's own spans).
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from common import sync

TOP = 10
# gaps named one by one by the host event at their middle; the shorter
# rest are summed under one name
LABELLED = 4000


def _name(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def summarize(events, window_s: float) -> dict:
    dev, host = [], []
    for e in events:
        iv = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(iv)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith("bench.")):
            # the benchmark's own spans also appear on the device's
            # timeline; they are no device operation
            dev.append(iv)
    dev.sort(key=lambda x: x[0])
    by_name = defaultdict(lambda: [0, 0.0])
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, name in dev:
        rec = by_name[name]
        rec[0] += 1
        rec[1] += (e - s) * 1e-6
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    idle = defaultdict(float)
    gaps.sort(reverse=True)
    if host:
        h0 = np.array([h[0] for h in host], dtype=np.float64)
        h1 = np.array([h[1] for h in host], dtype=np.float64)
        names = [h[2] for h in host]
        span = np.array([n.startswith("bench.") for n in names])
    short = "shorter gaps"
    for k, (length, g0, g1) in enumerate(gaps):
        if k >= LABELLED or not host:
            if k == LABELLED:
                short = f"gaps under {length:.1f} us, not named"
            idle[short] += length * 1e-6
            continue
        mid = 0.5 * (g0 + g1)
        over = np.nonzero((h0 <= mid) & (h1 >= mid))[0]
        if len(over) == 0:
            idle["no host event"] += length * 1e-6
            continue
        inner = names[over[np.argmin(h1[over] - h0[over])]]
        outer = [names[i] for i in over[span[over]]]
        label = f"{outer[0]} > {inner}" if outer and outer[0] != inner \
            else inner
        idle[label] += length * 1e-6
    ops = sorted(((_name(n), v[1]) for n, v in by_name.items()),
                 key=lambda x: -x[1])
    return {
        "device_events": len(dev),
        "busy_s": busy * 1e-6,
        "window_s": window_s,
        "by_name": {k: (v[0], v[1]) for k, v in by_name.items()},
        "device_ops": [[n, t] for n, t in ops[:TOP]],
        "idle_gaps": [[k, v] for k, v in sorted(
            idle.items(), key=lambda x: -x[1])[:TOP]],
    }


def profiled(fn, device):
    """(fn(), summary of its trace)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        window_s = time.perf_counter() - t0
    return out, summarize(prof.events(), window_s)


def kernel_launches(summary: dict, key: str) -> tuple[int, float]:
    """(launches, total device seconds) of the device operations whose
    name holds ``key``."""
    n, s = 0, 0.0
    for name, (c, t) in summary["by_name"].items():
        if key in name:
            n += c
            s += t
    return n, s
