"""Paths, cells and the tiny CPU run shared by the benchmark's tests."""
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]

# a cell cut to a few seconds on the CPU: a 24x16 grid, 8 EVP subcycles,
# chunks of 3 steps, one sampled chunk
TINY = {"model": {"grid": {"ny": 24, "nx": 16}, "dyn": {"ndte": 8}},
        "traffic": {"chunk_steps": 3,
                    "check": {"sample_span_chunks": 2, "sampled_chunks": 1}}}


def run_tiny(workload, seed=3000000007, control=0, trace=0,
             overrides=TINY):
    """run_cell of ``workload`` on the CPU at the tiny size."""
    import run
    args = run.parse_args(["--workload", workload, "--seed", str(seed),
                           "--seconds", "0.2", "--trace", str(trace),
                           "--control", str(control)])
    files = run.cell_files(run.load_json(ROOT / "BENCHMARK.json"),
                           workload)
    return run.run_cell(files, args, "cpu", overrides)
