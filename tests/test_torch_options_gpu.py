"""The option sets of tests/test_torch_options.py on the card.

Marked ``gpu``: they skip without a CUDA device. This file imports no
JAX, so on the GPU machine it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_options_gpu.py

For every set (gx3's and tp1's physics, BL99 + CCSM3 on a tripole seam,
mushy without dEdd, dEdd without ponds, iage, FY and lvl alone, CESM and
topographic ponds under BL99 and mushy, the CESM pond refreezing,
zero-layer thermo, calc_Tsfc=False under BL99 and mushy; the T-fold
seam, EAP alone, on the T-fold and with the mechred diagnostics, upwind
transport, the transport checks, dynamics without transport, the
chunked EVP on one device (its plain loop, no kernel A); the
aerosol, brine and skeletal-BGC tracers, with their fluxes to the
ocean; CESM2's 8 ice and 3 snow layers under mushy and BL99 thermo, C
from its own library; each namelist option of ``O.FLAG_SETS`` on the
BL99 model, the revised EVP and ndtd=2 through kernel A), from the recorded
warmed-up state in float64: two steps through the kernels on the card
within 3e-8 of each field's scale of the plain versions on the CPU
(tracers as conserved amounts, stresses 1e-5; with the StepDiag fields
that a flag set's option drives), the graph rollout equal to
the eager step at 0.0, and kernel A (EVP sets) and B (remap sets)
launched once per dynamics subcycle (ndtd per step) and C (dEdd sets)
once per step.
"""
import dataclasses

import pytest
import torch

from cice5_tpu_torch.driver.step import step as step_fn
from cice5_tpu_torch.models.thermo.itd import tracer_weights
from cice5_tpu_torch.ops import kernels
import torch_option_sets as O
from test_torch_options import port_inputs, port_model
from torch_port_util import assert_close, cuda_device  # noqa: F401

SETS = sorted(O.option_sets())


def _differ(a, b):
    pairs = (zip(a._fields, a, b) if isinstance(a, tuple) else
             ((f.name, getattr(a, f.name), getattr(b, f.name))
              for f in dataclasses.fields(a)))
    return [n for n, x, y in pairs
            if torch.is_tensor(x) and not torch.equal(x, y)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", SETS)
def test_set_on_the_card_matches_the_cpu(cuda_device, name):
    ref = O.load_reference(name)
    mc, mg = port_model(name), port_model(name, device=cuda_device)
    st, f = port_inputs(ref)
    sc, dc = mc.rollout(st, f, O.NSTEPS)
    kernels.reset_launch_counts()
    sg, dg = mg.rollout(st.to(cuda_device), f.to(cuda_device), O.NSTEPS)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    dedd = mc.cfg.shortwave.shortwave == "dEdd"
    # EAP has no hand-written kernel, and the chunked EVP is the plain loop
    evp = mc.cfg.dyn.kdyn == 1 and mc.cfg.dyn.evp_algorithm != "chunked"
    remap = mc.cfg.dyn.advection == "remap"
    ndyn = O.NSTEPS * mc.cfg.time.ndtd   # dynamics subcycles of the run
    assert counts == dict(evp_sweep=ndyn if evp else 0,
                          remap_flux_both=ndyn if remap else 0,
                          shortwave_dedd=O.NSTEPS if dedd else 0,
                          evp_fused=0, remap_flux_edge=0)
    sg = sg.to("cpu")
    for k in O.STATE + (O.DYN_STATE if name in O.DYN_SETS else ()) + (
            O.TRACER_STATE if name in O.TRACER_SETS else ()):
        assert_close(getattr(sc, k), getattr(sg, k), 3e-8, k, floor=1.0)
    for k in O.STRESS:
        assert_close(getattr(sc, k), getattr(sg, k), 1e-5, k, floor=1.0)
    tr = mc.tr
    amount = lambda s: tracer_weights(tr, s.aicen, s.vicen, s.vsnon,
                                      s.trcrn) * s.trcrn
    wc, wg = amount(sc), amount(sg)
    for it in range(tr.ntrcr):
        assert_close(wc[:, it], wg[:, it], 3e-8, f"trcrn[{it}]", floor=1e-6)
    for k in O.TRACER_DIAG if name in O.TRACER_SETS else ():
        assert_close(getattr(dc, k), getattr(dg, k).cpu(), 3e-8, k)
    # the StepDiag fields that a flag set's option drives
    for k in O.FLAG_DRIVES.get(name, ()):
        if k.startswith("diag/"):
            k = k[len("diag/"):]
            assert_close(getattr(dc, k), getattr(dg, k).cpu(), 3e-8, k)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SETS)
def test_set_graph_rollout_equals_eager(cuda_device, name):
    ref = O.load_reference(name)
    m = port_model(name, device=cuda_device)
    st, f = port_inputs(ref, device=cuda_device)
    got = m.rollout(st, f, 3)
    eager = (st, None)
    for _ in range(3):
        eager = step_fn(eager[0], f, *m.step_args)
    torch.cuda.synchronize()
    assert len(m.graphs) == 1
    assert _differ(eager[0], got[0]) == [] and _differ(eager[1], got[1]) \
        == []
