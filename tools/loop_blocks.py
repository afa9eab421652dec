"""Time the captured step with each loop in blocks of several passes
against the port's one pass per loop graph, on one GPU.

    python tools/loop_blocks.py

For each main path of ``chip_smoke.py`` (gx1-parity, BL99 + CCSM3, the
fused EVP; 320x384, float32, ndte=120) it warms a model up, counts the
passes each loop makes in one eager step, and captures the step twice:
as ``driver/graph.py:StepGraph`` does (each loop a graph of one pass,
replayed after a host read of its pending flag) and with each loop a
graph of as many passes as that eager step made (at least one; blocks
run past a loop's end as no-op passes, which the loops' over-run
invariance allows). It replays each 10 steps from the same state, in the
order one, blocks, blocks, one, and prints per run the ms/step (host
clock around work that ends in a synchronize), the graph replays and
flag reads per step, and whether the two final states agree bit for bit.
Needs a CUDA card; the block variant reaches into StepGraph's capture
hooks (``_begin``, ``_end``, ``_loop``).
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def blocks_graph(k_per_loop):
    from cice5_tpu_torch.driver import graph

    class Blocks(graph.StepGraph):
        """StepGraph with loop i captured as k_per_loop[i] passes."""

        def __init__(self, *args):
            self._k = iter(k_per_loop)
            super().__init__(*args)

        def _loop(self, body, pending, carry):
            k = next(self._k)
            bufs = {n: t.clone() for n, t in carry.items()}
            flag = pending(bufs)
            self._end(None)
            self._begin()
            out = bufs
            for _ in range(k):
                out = body(out, pending(out))
            for n, t in out.items():
                bufs[n].copy_(t)
            flag.copy_(pending(bufs))
            self._end(flag)
            self._begin()
            return bufs
    return Blocks


def eager_passes(m, st, f):
    """The passes each loop makes in one eager step, in order."""
    from cice5_tpu_torch.driver.step import step
    from cice5_tpu_torch.ops import loop
    made = []

    def driver(body, pending, carry):
        n0 = carry["niter"]
        go = pending(carry)
        while bool(go):
            carry = body(carry, go)
            go = pending(carry)
        made.append(int(carry["niter"] - n0))
        return carry

    with loop.driven_by(driver):
        step(st, f, *m.step_args)
    return made


def timed(g, st, f, nsteps=10):
    import torch
    g.load(st, f)
    r0, f0 = g.replays, g.flag_reads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(nsteps):
        g.replay()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / nsteps * 1e3
    return (ms, (g.replays - r0) / nsteps, (g.flag_reads - f0) / nsteps,
            g.result()[0])


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("loop_blocks: no CUDA device")
    from chip_smoke import (build_bl99, build_bl99_fused, build_parity,
                            card_line, state_and_diag_differences)
    from cice5_tpu_torch.driver import graph
    from cice5_tpu_torch.driver.step import step
    print(card_line(), flush=True)
    for label, build in (("gx1-parity", build_parity), ("BL99", build_bl99),
                         ("fused", build_bl99_fused)):
        m, st, f = build()
        for _ in range(2):
            st, _ = step(st, f, *m.step_args)
        k = [max(1, n) for n in eager_passes(m, st, f)]
        fn = lambda s, g: step(s, g, *m.step_args)
        graphs = {"one pass": graph.StepGraph(fn, st, f),
                  "blocks": blocks_graph(k)(fn, st, f)}
        ends = {}
        for name in ("one pass", "blocks", "blocks", "one pass"):
            ms, replays, reads, ends[name] = timed(graphs[name], st, f)
            print(json.dumps(dict(path=label, loops=name, blocks=k,
                                  ms_per_step=ms, replays_per_step=replays,
                                  flag_reads_per_step=reads)), flush=True)
        diff = state_and_diag_differences(
            (ends["one pass"], graphs["one pass"].diag),
            (ends["blocks"], graphs["blocks"].diag))
        print(f"{label}: the two captures' final states and diags differ "
              f"in {diff or 'no field'}", flush=True)
        del m, st, graphs, ends
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
