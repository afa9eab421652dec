"""run.py refuses to run without a card, in a checkout without the port,
and never loads JAX or the JAX package."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_testutil import BENCH, CELLS, ROOT

ARGS = ["--workload", CELLS[0], "--seed", "5", "--seconds", "1"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py"] + ARGS,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, env)
    assert r.returncode == 2 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.parametrize("names,found", [
    (["cice5_tpu_torch", "cice5_tpu_torch.driver", "jax_extra"], []),
    (["cice5_tpu.grid"], ["cice5_tpu"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib"]),
])
def test_forbidden_names_compared_whole(monkeypatch, names, found):
    import run
    for n in names:
        monkeypatch.setitem(sys.modules, n, object())
    got = run.forbidden_modules()
    assert [g for g in got if g in {n.split(".")[0] for n in names}] == found


DRIVE = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
from bench_testutil import run_tiny
run_tiny({cell!r})
import reference.cice.models.dynamics.eap, reference.cice.ops.evp_fused
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    code = DRIVE.format(root=str(ROOT), bench=str(BENCH),
                        tests=str(BENCH / "tests"), cell=cell)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "cice5_tpu"}
    assert "cice5_tpu_torch" in top


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, pkgutil, importlib; sys.path.insert(0, %r)\n"
            "import reference\n"
            "for m in pkgutil.walk_packages(reference.__path__, "
            "'reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=BENCH)
    assert r.returncode == 0, r.stderr[-2000:]
    for bad in ("cice5_tpu_torch", "cice5_tpu", "jax", "jaxlib"):
        assert f"'{bad}'" not in r.stdout
