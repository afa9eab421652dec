"""Model.step and Model.rollout replaying CUDA graphs on the card.

Marked ``gpu``: they skip without a CUDA device. This file imports no
JAX, so on the GPU machine it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_graph_gpu.py

On small grids of the three main paths (the BL99 model with the EVP sweep
kernel and with the fused EVP kernel, and the gx1-parity model on a
tripole grid with land on the seam), float32: a replayed step and a
replayed rollout equal the eager step (``driver.step.step``) at 0.0 in
every State and StepDiag field, pass counts included; a replay does not
overwrite what an earlier one returned; the launch counters count
replays.
"""
import dataclasses

import pytest
import torch

from cice5_tpu_torch.config import bench_easy_config, gx1_parity_config
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.driver.step import step as step_fn
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.ops import kernels
from torch_port_util import (PARITY_ISTEP, cuda_device,  # noqa: F401
                             parity_grid_arrays)

PATHS = ("bl99", "fused", "parity")
# launches per step of each kernel on each path
PER_STEP = {"bl99": dict(evp_sweep=1, remap_flux_both=1),
            "fused": dict(remap_flux_both=1, evp_fused=2),
            "parity": dict(evp_sweep=1, remap_flux_both=1, shortwave_dedd=1)}


def _build(name, device):
    """(model, a moving state, forcing) on a small grid."""
    if name == "parity":
        cfg = gx1_parity_config(dtype="float32", accum_dtype="float32")
        cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=24, nx=16),
                          dyn=dataclasses.replace(cfg.dyn, ndte=8))
        m = Model(cfg, grid=popgrid_np(cfg, *parity_grid_arrays(),
                                       device="cpu"), device=device)
        st, f = m.init_state(), m.forcing_at(PARITY_ISTEP)
        f = f.replace(frain=torch.full_like(f.frain, 2.0e-5))
    else:
        cfg = bench_easy_config(ny=16, nx=32, ndte=20)
        if name == "fused":
            cfg = cfg.replace(dyn=dataclasses.replace(
                cfg.dyn, evp_algorithm="pallas"))
        m = Model(cfg, device=device)
        st, f = m.init_state(ice_mask=m.grid.tmask), m.forcing_at(0)
    st, _ = step_fn(st, f, *m.step_args)
    return m, st, f


def _differ(a, b):
    """Names of the fields of two states or diags that differ at all."""
    if isinstance(a, tuple):
        pairs = zip(a._fields, a, b)
    else:
        pairs = ((f.name, getattr(a, f.name), getattr(b, f.name))
                 for f in dataclasses.fields(a))
    return [n for n, x, y in pairs
            if torch.is_tensor(x) and not torch.equal(x, y)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", PATHS)
def test_replayed_step_and_rollout_equal_the_eager_step(cuda_device, name):
    m, st, f = _build(name, cuda_device)
    m.step(st, f)                               # captures
    assert len(m.graphs) == 1
    ref = step_fn(st, f, *m.step_args)
    got = m.step(st, f)                         # replays
    assert _differ(ref[0], got[0]) == [] and _differ(ref[1], got[1]) == []
    s, d = st, None
    for _ in range(3):
        s, d = step_fn(s, f, *m.step_args)
    got = m.rollout(st, f, 3)
    torch.cuda.synchronize()
    assert _differ(s, got[0]) == [] and _differ(d, got[1]) == []
    assert int(d.niter_thermo) >= 1 and int(d.niter_ridge) >= 1
    assert len(m.graphs) == 1


@pytest.mark.gpu
def test_a_replay_does_not_overwrite_an_earlier_result(cuda_device):
    m, st, f = _build("bl99", cuda_device)
    m.step(st, f)
    s1, d1 = m.step(st, f)
    keep = (s1.aicen.clone(), s1.uvel.clone(), d1.fresh.clone())
    s2, d2 = m.step(s1, f)
    torch.cuda.synchronize()
    assert s2.aicen.data_ptr() != s1.aicen.data_ptr()
    assert torch.equal(keep[0], s1.aicen) and torch.equal(keep[1], s1.uvel)
    assert torch.equal(keep[2], d1.fresh)
    assert not torch.equal(s1.uvel, s2.uvel)


@pytest.mark.gpu
@pytest.mark.parametrize("name", PATHS)
def test_launch_counts_count_replays(cuda_device, name):
    m, st, f = _build(name, cuda_device)
    m.step(st, f)
    kernels.reset_launch_counts()
    m.rollout(st, f, 3)
    m.step(st, f)
    want = {k: 0 for k in kernels.KERNELS}
    want.update({k: 4 * n for k, n in PER_STEP[name].items()})
    assert kernels.launch_counts() == want
