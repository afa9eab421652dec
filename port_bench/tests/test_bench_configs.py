"""Each configuration file spells out today's configuration function in
the port, and
the reference builds the same configuration from it."""
import dataclasses
import json

import pytest

from bench_testutil import BENCH


def port_configs():
    from cice5_tpu_torch.config import gx1_parity_config
    gx1 = gx1_parity_config(dtype="float64", accum_dtype="float64")
    return {"gx1_bl99_f64": gx1.replace(
        thermo=dataclasses.replace(gx1.thermo, ktherm=1),
        tracers=dataclasses.replace(gx1.tracers, tr_pond_lvl=False))}


# the keys departing from the configuration's source, by group, each with
# its reason under ``assumed``
DEPARTURES = {"gx1_bl99_f64": {"grid": ("grid_type", "ns_boundary"),
                               "thermo": ("ktherm",),
                               "tracers": ("tr_pond_lvl",)}}


@pytest.mark.parametrize("name", sorted(DEPARTURES))
def test_config_file_equals_the_ports_function(name):
    spec = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert spec["model"] == json.loads(json.dumps(
        dataclasses.asdict(port_configs()[name])))
    keys = [k for group in DEPARTURES[name].values() for k in group]
    assert spec["reduced"] == keys
    for group, names in DEPARTURES[name].items():
        assert set(names) <= set(spec["model"][group])
    assert all(any(k in a for a in spec["assumed"]) for k in keys)


@pytest.mark.parametrize("name", sorted(DEPARTURES))
def test_port_and_reference_build_the_same(name):
    import run
    from reference import model_config
    spec = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    port = dataclasses.asdict(run.port_config(spec["model"]))
    ref = dataclasses.asdict(model_config(spec["model"],
                                          spec["model"]["dtype"]))
    assert port == ref
