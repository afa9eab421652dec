"""Time the remap and delta-Eddington kernels (B, C and E) of the
PyTorch/CUDA port on one GPU, on inputs captured from one step of each
model at 384x320, float32.

    PYTHONPATH=<checkout> python tools/kernel_times.py [--label NAME]

The ``cice5_tpu_torch`` package comes from PYTHONPATH, so the same script
times two checkouts (for example a parent commit unpacked beside the
working tree) in one run on one card. For each kernel it prints one JSON
line: the eager time of one call and the device time of one call replayed
from a CUDA graph (CUDA events over many calls), the CUDA kernels one
call launches (torch.profiler), and the lit columns of the dEdd inputs
(the dEdd kernel at the model's nilyr=4 and at 7 on the same inputs).
Needs a CUDA card; builds the checkout's kernels at first use.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def cuda_time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Device ms of one call replayed from a CUDA graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_time_ms(graph.replay, reps)


def cuda_kernels_per_call(fn) -> int:
    """CUDA kernels one call launches, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "emcpy" not in e.name and "emset" not in e.name)


def captured(model: str):
    """The kernel arguments of one step after a warm-up step."""
    from cice5_tpu_torch.config import bench_easy_config, gx1_parity_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import synth_gx1_grid
    from cice5_tpu_torch.ops import check
    if model == "gx1-parity":
        cfg = gx1_parity_config(dtype="float32", accum_dtype="float32")
        m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
        st = m.init_state()
    else:
        m = Model(bench_easy_config(dtype="float32"))
        st = m.init_state(ice_mask=m.grid.tmask)
    f = m.forcing_at(0)
    st, _ = m.step(st, f)
    return check.capture_kernel_args(m, st, f)[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    import cice5_tpu_torch
    from cice5_tpu_torch.models.radiation import dedd
    from cice5_tpu_torch.models.transport import remap as trm
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    base = dict(label=args.label, package=cice5_tpu_torch.__file__,
                card=card)
    for model in ("gx1-parity", "BL99"):
        cap = captured(model)
        rm = cap["remap"]
        geomN, _, mm, tm, hm, tt, par, ny, nx = rm
        calls = {
            "remap_flux_both": lambda: trm.remap_flux_both(*rm),
            "remap_flux_edge": lambda: trm.remap_flux_edge(
                "north", geomN, mm, tm, hm, tt, par, ny, nx),
        }
        if model == "gx1-parity":
            kw = cap["dedd"]
            calls["shortwave_dedd"] = lambda: dedd.shortwave_dEdd_ncat(**kw)
            kw7 = dict(kw, nilyr=7)
            calls["shortwave_dedd nilyr=7"] = \
                lambda: dedd.shortwave_dEdd_ncat(**kw7)
            netsw = kw["swvdr"] + kw["swvdf"] + kw["swidr"] + kw["swidf"]
            lit = int(((kw["aicen"] > 1e-11) & (netsw > 1e-11)[None]
                       & (kw["coszen"] > 1e-11)[None]).sum())
        for name, fn in calls.items():
            row = dict(base, model=model, kernel=name,
                       eager_ms=cuda_time_ms(fn, 20),
                       graph_ms=graph_ms(fn, 50),
                       cuda_kernels_per_call=cuda_kernels_per_call(fn))
            if name.startswith("shortwave_dedd"):
                row["lit_columns"] = lit
            print(json.dumps(row), flush=True)
        del cap


if __name__ == "__main__":
    main()
