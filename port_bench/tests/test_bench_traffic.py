"""The traffic is made from the seed: the same seed gives the same
forcing, another seed the same weather in another place."""
import json

import pytest
import torch

from bench_testutil import BENCH, MANIFEST


def gen(seed, traffic="rollout"):
    from forcing_gen import ForcingGen
    from gridgen import pop_arrays
    from reference import Reference
    spec = json.loads((BENCH.parent / MANIFEST["configs"][0]["file"])
                      .read_text())
    p = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    model = dict(spec["model"], grid=dict(spec["model"]["grid"], ny=24,
                                          nx=16))
    ref = Reference(model, pop_arrays(spec["grid_inputs"], 24, 16),
                    dtype="float32", device="cpu")
    return ForcingGen(p["forcing"], seed, grid=ref.grid, yday=ref.yday,
                      orb=ref.orb, steps_per_day=24, dtype=torch.float32,
                      device="cpu")


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 33 + 5])
def test_same_seed_same_forcing(seed):
    a, b = gen(seed), gen(seed)
    for istep in (0, 2890, 2890 + 13):
        fa, fb = a.fields(istep), b.fields(istep)
        assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_other_seed_same_weather_elsewhere():
    a, b = gen(2 ** 31 + 11), gen(2 ** 31 + 12)
    assert a.offset != b.offset
    fa, fb = a.fields(2890), b.fields(2890)
    assert not torch.equal(fa["uatm"], fb["uatm"])
    shift = b.offset - a.offset
    for day in (120, 121, 127):
        assert torch.allclose(torch.roll(a._day_field(day), shift, dims=-1),
                              b._day_field(day))


def test_anomaly_periodic_in_longitude():
    f = gen(5)._day_field(130)
    seam = (f[..., 0] - f[..., -1]).abs().max()
    inner = (f[..., 1:] - f[..., :-1]).abs().max()
    assert seam <= 1.5 * inner
