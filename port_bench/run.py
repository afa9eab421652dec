"""Run one cell of the benchmark of the PyTorch/CUDA sea-ice port once.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. The cell
(``workloads`` in ``BENCHMARK.json``) names a configuration
(``port_bench/configs/<config>.json``: every ModelConfig field, and the
grid's inputs) and a traffic mix (``port_bench/traffic/<traffic>.json``:
the entry that drives the port, found as ``port_bench/entries/<entry>.py``,
and its parameters); each metric is read by ``port_bench/metrics/
<name>.py``. The run builds the port's model and the benchmark's inputs
(grid arrays, initial state, forcing) from the seed, warms up
every shape the window uses, measures for ``--seconds``, and then, with
the port's state freed, holds sampled steps of the window against the
plain reference (``port_bench/reference``) in the configuration's
precision. With ``--trace 1``
it also traces a short window under ``torch.profiler`` and prints the
per-layer metrics in place of the end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each number compared with its
limit); the numbers compared are also the last lines of standard error.
``--control 1`` also puts the control (the reference one precision
below the configuration's, ``check.CONTROL``) and the unchanged state in
the port's place on the same samples and prints their numbers.

Without a CUDA card, or with fewer cards than the cell asks for, the run
exits with code 2 and prints no result. It also fails if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``cice5_tpu`` is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402


HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the benchmark's own modules, then the checkout's root, which holds the
# port (cice5_tpu_torch)
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from common import (fields_of, load_json, load_module, merged,  # noqa: E402
                    port_config, port_state, sync)

FORBIDDEN = ("jax", "jaxlib", "flax", "cice5_tpu")


class Refused(SystemExit):
    """A run that prints no result: exit code 2 and the reason on
    standard error."""

    def __init__(self, msg: str):
        print(f"port_bench: {msg}", file=sys.stderr, flush=True)
        super().__init__(2)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_files(manifest: dict, workload: str) -> dict:
    """The cell, its configuration entry and the paths of its
    configuration, traffic and metric files."""
    cell = next((w for w in manifest["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"]
                  if c["name"] == cell["config"])
    in_cell = lambda m: workload in m.get("workloads", [workload])
    return dict(
        cell=cell, config=config,
        config_file=ROOT / config["file"],
        traffic_file=HERE / "traffic" / f"{cell['traffic']}.json",
        end_to_end=[m for m in manifest["end_to_end"] if in_cell(m)],
        per_layer=[m for m in manifest["per_layer"] if in_cell(m)],
        metric_file=lambda name: HERE / "metrics" / f"{name}.py",
        limits_file=HERE / "limits" / f"{workload}.json")


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only the first run of a cell in a checkout builds."""
    build = ROOT / "build"
    os.environ.setdefault("CICE5_TORCH_BUILD_DIR", str(build / "kernels"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build(files: dict, args, device, overrides=None) -> SimpleNamespace:
    """The port's model and the benchmark's inputs for the cell."""
    import torch
    from forcing_gen import ForcingGen
    from gridgen import pop_arrays
    from reference import Reference
    spec = load_json(files["config_file"])
    traffic = load_json(files["traffic_file"])
    overrides = overrides or {}
    model = merged(spec["model"], overrides.get("model"))
    traffic = merged(traffic, overrides.get("traffic"))
    ny, nx = model["grid"]["ny"], model["grid"]["nx"]
    arrays = pop_arrays(spec["grid_inputs"], ny, nx)
    # the benchmark's own inputs, made by the reference's code in the
    # configuration's precision on the run's device
    inputs = Reference(model, arrays, dtype=model["dtype"], device=device)
    steps_per_day = int(round(86400.0 / model["time"]["dt"]))
    gen = ForcingGen(traffic["forcing"], args.seed, grid=inputs.grid,
                     yday=inputs.yday, orb=inputs.orb,
                     steps_per_day=steps_per_day, dtype=inputs.dtype,
                     device=device)
    state0 = inputs.initial_state()
    if torch.device(device).type == "cuda":
        # the peak counts the port's set-up and window, and the inputs
        # held through them, not the temporaries of making the inputs
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import popgrid_np
    cfg = port_config(model)
    m = Model(cfg, grid=popgrid_np(cfg, *arrays, device=device),
              device=device)
    return SimpleNamespace(
        args=args, files=files, spec=spec, model_spec=model,
        traffic=traffic, arrays=arrays, device=torch.device(device),
        inputs=inputs, gen=gen, steps_per_day=steps_per_day, m=m,
        state=port_state(state0), samples=[], loops=[],
        trace=None, counters={})


def run_cell(files: dict, args, device, overrides=None) -> dict:
    """Set up, warm up, measure, trace, check; returns the result dict
    (without printing it)."""
    import torch
    import check
    ctx = build(files, args, device, overrides)
    entry = load_module(HERE / "entries" / f"{ctx.traffic['entry']}.py",
                        f"entry_{ctx.traffic['entry']}")
    ctx.t_start = T_START
    entry.run(ctx)           # set-up, warm-up, window (and traced window)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    ctx.memory_peak_bytes = peak
    final = fields_of(ctx.state)
    loops = [tuple(int(x) for x in t.tolist()) for t in ctx.loops]
    health = check.health(final, ctx.inputs, loops)
    ctx.state_numel = {k: int(v.numel()) for k, v in final.items()
                       if torch.is_tensor(v)}
    # free the port's state and graphs before the reference runs
    del final
    ctx.m = ctx.state = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package loaded: {found}")
    limits = load_json(files["limits_file"])
    readings, kernel_args = check.judge(ctx, limits,
                                        control=bool(args.control))
    ctx.kernel_args = kernel_args
    correct = check.passes(readings, health, limits)
    names = files["per_layer"] if args.trace else files["end_to_end"]
    metrics = {}
    for mdef in names:
        mod = load_module(files["metric_file"](mdef["name"]),
                          "metric_" + mdef["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}
    dev = {"platform": "gpu" if cuda else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if cuda
           else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": ctx.counters["steps"],
           "failed": 0 if correct else ctx.counters["steps"],
           "metrics": metrics, "device": dev}
    if args.trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace["busy_s"]
        dev["window_s"] = ctx.trace["window_s"]
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
    out["checks"] = check.report(readings, health, limits)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest_path = ROOT / "BENCHMARK.json"
    if not manifest_path.exists():
        raise Refused(f"{manifest_path} not found")
    files = cell_files(load_json(manifest_path), args.workload)
    set_cache_dirs()
    try:
        import torch
    except ImportError as e:
        raise Refused(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the port on "
                      "the card and never falls back to the CPU")
    chips = files["cell"]["chips"]
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} CUDA devices and "
                      f"{torch.cuda.device_count()} are visible")
    try:
        import cice5_tpu_torch  # noqa: F401
    except ImportError as e:
        raise Refused(f"the port (cice5_tpu_torch) is not importable: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(files, args, "cuda:0")
    import check
    for line in check.lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
