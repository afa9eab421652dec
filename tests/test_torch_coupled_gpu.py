"""The coupled model (``driver/coupled.py``) on the card.

Marked ``gpu``: they skip without a CUDA device. This file imports no
JAX, so on the GPU machine it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_coupled_gpu.py

On the gx1-parity model at 24x16 (tripole grid with land on the seam,
ndte=8, float32) with every coupled-mode option (coupled_radiation,
formdrag, highfreq, fbot_xfer_type="Cdn_ocn"): ``CoupledModel.run``, whose
steps replay the step's CUDA graphs, equals the same exchanges stepped
through the eager step (``driver.step.step``) at 0.0 in every State and
StepDiag field and every outbound field; the inbound NumPy fields land on
the card; each coupled step launches kernels A, B and C once.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cice5_tpu_torch.config import gx1_parity_config
from cice5_tpu_torch.driver.coupled import CoupledModel
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.driver.step import step as step_fn
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.ops import kernels
from torch_port_util import (PARITY_ISTEP, RAIN, cuda_device,  # noqa: F401
                             parity_grid_arrays)

ATM = ("swvdr", "swvdf", "swidr", "swidf", "flw", "Tair", "Qa", "rhoa",
       "uatm", "vatm", "zlvl", "fsnow", "frain")
OCN = ("sst", "sss", "uocn", "vocn", "frzmlt", "qdp", "hmix")


def _model(device):
    cfg = gx1_parity_config(coupled_radiation=True, dtype="float32",
                            accum_dtype="float32")
    r = dataclasses.replace
    cfg = cfg.replace(grid=r(cfg.grid, ny=24, nx=16), dyn=r(cfg.dyn, ndte=8),
                      forcing=r(cfg.forcing, formdrag=True, highfreq=True),
                      thermo=r(cfg.thermo, fbot_xfer_type="Cdn_ocn"))
    return Model(cfg, grid=popgrid_np(cfg, *parity_grid_arrays(),
                                      device="cpu"), device=device)


def _exchanges(m, steps):
    """The model's forcing of each step, with rain on the ice, as NumPy."""
    out = {}
    for k in steps:
        f = m.forcing_at(k)
        f = f.replace(frain=torch.full_like(f.frain, RAIN))
        out[k] = ({n: getattr(f, n).cpu().numpy() for n in ATM},
                  {n: getattr(f, n).cpu().numpy() for n in OCN})
    return out


def _differ(a, b):
    if isinstance(a, tuple):
        pairs = zip(a._fields, a, b)
    else:
        pairs = ((f.name, getattr(a, f.name), getattr(b, f.name))
                 for f in dataclasses.fields(a))
    return [n for n, x, y in pairs
            if torch.is_tensor(x) and not torch.equal(x, y)]


@pytest.mark.gpu
def test_coupled_graph_run_equals_eager(cuda_device):
    m = _model(cuda_device)
    dt = m.cfg.time.dt
    steps = range(PARITY_ISTEP, PARITY_ISTEP + 4)
    ex = _exchanges(m, steps)
    puts = []

    def coupled(**kw):
        return CoupledModel(
            model=m, get_atm=lambda t: ex[int(round(t / dt))][0],
            get_ocn=lambda t: ex[int(round(t / dt))][1], **kw)

    st0, _ = coupled().run(m.init_state(), 1, start_step=PARITY_ISTEP)
    assert st0.aicen.device.type == "cuda" and len(m.graphs) == 1
    cm = coupled(put_ocn=lambda t, o: puts.append(
        {k: v.clone() for k, v in o.items()}))
    kernels.reset_launch_counts()
    got, dgot = cm.run(st0, 3, start_step=PARITY_ISTEP + 1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert {k: counts[k] for k in ("evp_sweep", "remap_flux_both",
                                   "shortwave_dedd")} == dict(
        evp_sweep=3, remap_flux_both=3, shortwave_dedd=3)
    # the same exchanges through the eager step
    ref = coupled()
    st, outs = st0, []
    for k in range(PARITY_ISTEP + 1, PARITY_ISTEP + 4):
        ref.from_atm(ex[k][0])
        ref.from_ocn(ex[k][1])
        st, d = step_fn(st, ref._forcing, *m.step_args)
        outs.append(ref.into_ocn(st, d))
    assert _differ(st, got) == [] and _differ(d, dgot) == []
    assert len(puts) == len(outs) == 3
    for a, b in zip(outs, puts):
        assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert all(v.device.type == "cuda" for v in puts[-1].values())
    assert int(dgot.state_bad) == 0 and dgot.drag.shape[0] == 17
    assert float(np.abs(puts[-1]["aice"].cpu().numpy()).max()) > 0.5
