"""Entry ``rollout``: the port standalone, ``Model.rollout`` in chunks.

Each chunk is ``chunk_steps`` steps whose forcings the benchmark makes on
the device inside the window (``ForcingGen``); the chunk runs as one
rollout of all but its last step and one rollout of the last, so that
the state the last step started from is at hand for the check. Set-up
builds everything and runs ``warmup_chunks`` chunks (the first call runs
the eager step and captures the step's CUDA graphs). The window runs
whole chunks until ``--seconds`` have passed and every chunk sampled
from the seed for the check has run. With ``--trace 1`` the chunk after
the window runs twice from the same state: untraced, for its wall time,
and under the profiler; the state it starts from is kept for the
kernels' bounds. Each chunk keeps its last step's convergence readings
(``check.DIAG_LOOPS``) on the device, one small copy a chunk, for the
health check after the window.
"""
from __future__ import annotations

import random
import time

import torch

from common import fields_of, port_forcing, sync, to_host
from check import DIAG_COMPARED, DIAG_LOOPS


def run(ctx):
    t = ctx.traffic
    m, n = ctx.m, t["chunk_steps"]
    s0 = t["start_day"] * ctx.steps_per_day

    def chunk(st, c):
        i0 = s0 + c * n
        with torch.profiler.record_function("bench.forcing"):
            fs = [port_forcing(ctx.gen.fields(i0 + k)) for k in range(n)]
        with torch.profiler.record_function("bench.rollout"):
            st, _ = m.rollout(st, fs[:n - 1], n - 1)
            pre = st
            st, diag = m.rollout(st, fs[n - 1:], 1)
            ctx.loops.append(torch.stack(
                [getattr(diag, k).to(torch.int64) for k in DIAG_LOOPS]))
        return pre, st, diag, i0 + n - 1

    st = ctx.state
    warm = t["warmup_chunks"]
    for c in range(warm):
        _, st, _, _ = chunk(st, c)
    rng = random.Random(ctx.args.seed)
    chk = t["check"]
    sampled = sorted(warm + c for c in rng.sample(
        range(chk["sample_span_chunks"]), chk["sampled_chunks"]))
    sync(ctx.device)
    t0 = time.perf_counter()
    ctx.setup_s = t0 - ctx.t_start
    c, steps = warm, 0
    while True:
        pre, st, diag, ilast = chunk(st, c)
        if c in sampled:
            ctx.samples.append(dict(
                istep=ilast, pre=to_host(fields_of(pre)),
                post=to_host(fields_of(st)),
                diag=to_host(fields_of(diag), DIAG_COMPARED)))
        steps += n
        c += 1
        if time.perf_counter() - t0 >= ctx.args.seconds \
                and c > sampled[-1]:
            break
    sync(ctx.device)
    wall = time.perf_counter() - t0
    ctx.counters.update(steps=steps, wall_s=wall)
    if ctx.args.trace:
        # the chunk after the window twice from the same state: untraced
        # for its wall time, then under the profiler
        from devtrace import profiled
        ctx.trace_sample = dict(istep=s0 + c * n,
                                pre=to_host(fields_of(st)))
        a = time.perf_counter()
        chunk(st, c)
        sync(ctx.device)
        untraced = time.perf_counter() - a
        (_, st, _, _), ctx.trace = profiled(lambda: chunk(st, c),
                                            ctx.device)
        ctx.trace.update(steps=n, untraced_s=untraced)
    ctx.state = st
