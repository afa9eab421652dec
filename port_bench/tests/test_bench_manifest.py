"""BENCHMARK.json keeps to the benchmark's contract, and every file a
cell names is found by its name."""
import json
import re

import pytest

from bench_testutil import BENCH, CELLS, MANIFEST, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["port_bench"]
    assert MANIFEST["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_keys_names_and_units():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    import run
    files = run.cell_files(MANIFEST, cell)
    assert files["config_file"].is_file()
    traffic = json.loads(files["traffic_file"].read_text())
    assert (BENCH / "entries" / f"{traffic['entry']}.py").is_file()
    limits = json.loads(files["limits_file"].read_text())
    assert {"state_gap", "flux_gap", "state_block_gap"} <= set(limits)
    for m in files["end_to_end"] + files["per_layer"]:
        mod = run.load_module(files["metric_file"](m["name"]), "m")
        assert callable(mod.read)
    e2e = {m["name"] for m in files["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and files["per_layer"]
