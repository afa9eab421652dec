"""The fused-EVP slice of the port (``evp_algorithm="pallas"``) vs the JAX
package, in float64 on the CPU.

- The port's ``evp_fused`` (its plain windowed sweep) against the JAX
  ``evp_fused`` (the Pallas kernel in interpret mode) on the seeded,
  warmed-up inputs of test_torch_evp.py, for several (kchunk, nwin), to
  that file's 1e-11 relative.
- ``fused_sweep_plain`` against ``subcycle_sweep``: the same function,
  bit for bit, with the caller's ``Cw`` in every subcycle.
- The JAX kernel's cyclic north-south defect, and the port's refusal.
- Two steps of the port's ``Model`` under a 12x16 rectangular BL99
  configuration with ``evp_algorithm="pallas"`` (ndte=10) against the JAX
  step, from a state warmed up by one JAX step. One jitted JAX step with the interpret-mode kernel costs ~65 s to
  compile on a CPU, so the JAX side is recorded in test_torch_evp_fused.npz
  under a hash of its inputs (rewrite: ``JAX_PLATFORMS=cpu PYTHONPATH=.
  python tests/test_torch_evp_fused.py``), and a test marked slow
  recomputes it. Tolerances as test_torch_step.py: state and diagnostics
  3e-8 x scale, stresses and the stress divergence 1e-5 x scale.
"""
import dataclasses
import hashlib
import inspect
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.config import (DynConfig, ForcingConfig, GridConfig,
                              ModelConfig, TimeConfig)
from cice5_tpu.grid import rectgrid as jrectgrid
from cice5_tpu.models.dynamics import evp as jevp
from cice5_tpu.models.dynamics import shared as jdyn
from cice5_tpu.models.dynamics.strength import strength_hibler
from cice5_tpu.ops.pallas.evp_fused import evp_fused as jevp_fused
from cice5_tpu.parallel import Topology as JTopology
from cice5_tpu_torch import constants as ct
from cice5_tpu_torch import config as tconfig
from cice5_tpu_torch import convert
from cice5_tpu_torch.driver import step as step_mod
from cice5_tpu_torch.driver.model import Model, check_supported
from cice5_tpu_torch.models.dynamics import evp as tevp
from cice5_tpu_torch.ops import evp_fused as tfused
from cice5_tpu_torch.parallel import Topology
from test_torch_evp import RTOL, _setup, _tparams
from torch_port_util import assert_close, jit_fast

REFERENCE = Path(__file__).with_name("test_torch_evp_fused.npz")
NY, NX, NDTE = 12, 16, 10
OPEN = dict(ew="cyclic", ns="open")


def _sweep_inputs(ndte, seed=7):
    """(params, the port's sweep inputs) from test_torch_evp's inputs."""
    _, tg, f = _setup(seed=seed)
    p = _tparams(jdyn.EVPParams.classic(3600.0, ndte=ndte))
    kw, _ = tevp.evp_prep(3600.0, p, tg, Topology(**OPEN),
                          **{k: torch.as_tensor(v) for k, v in f.items()})
    return p, kw


def _flat(out):
    u, v, stress, diags = out
    return [u, v, stress, *diags]


@pytest.mark.parametrize("kchunk,nwin,ndte", [(1, 1, 2), (2, 2, 4),
                                              (4, 4, 4)])
def test_evp_fused_matches_jax_fused(kchunk, nwin, ndte):
    jg, tg, f = _setup()
    p = jdyn.EVPParams.classic(3600.0, ndte=ndte)
    ref = jevp_fused(3600.0, p, jg, JTopology(**OPEN),
                     **{k: jnp.asarray(v) for k, v in f.items()},
                     kchunk=kchunk, nwin=nwin)
    got = tfused.evp_fused(3600.0, _tparams(p), tg, Topology(**OPEN),
                           **{k: torch.as_tensor(v) for k, v in f.items()},
                           kchunk=kchunk, nwin=nwin)
    for name in ref._fields:
        assert_close(getattr(ref, name), getattr(got, name), RTOL, name,
                     floor=1e-12)


@pytest.mark.parametrize("kchunk,nwin", [(1, 1), (2, 2), (4, 4), (8, 3)])
def test_fused_sweep_plain_equals_subcycle_sweep(kchunk, nwin):
    """The windowed sweep is the subcycle loop computed with temporal
    blocking: every output equal bit for bit."""
    p, kw = _sweep_inputs(8)
    ref = tevp.subcycle_sweep(p, 8, Topology(**OPEN), **kw)
    got = tfused.fused_sweep_plain(p, 8, Topology(**OPEN), kchunk=kchunk,
                                   nwin=nwin, **kw)
    assert all(torch.equal(a, b) for a, b in zip(_flat(ref), _flat(got)))


def test_fused_sweep_uses_the_callers_cw_in_every_subcycle():
    """A drag coefficient plane reaches every subcycle, as in the subcycle
    loop (the JAX kernel's subcycles use ct.dragio whatever the caller
    passes)."""
    p, kw = _sweep_inputs(4)
    kw["Cw"] = torch.full_like(kw["uvel"], 3.0 * ct.dragio)
    topo = Topology(**OPEN)
    ref = tevp.subcycle_sweep(p, 4, topo, **kw)
    got = tfused.fused_sweep_plain(p, 4, topo, kchunk=2, nwin=2, **kw)
    dflt = tfused.fused_sweep_plain(p, 4, topo, kchunk=2, nwin=2,
                                    **dict(kw, Cw=ct.dragio))
    assert all(torch.equal(a, b) for a, b in zip(_flat(ref), _flat(got)))
    assert not torch.equal(got[0], dflt[0])


def test_cyclic_north_south_is_open_in_jax_and_refused_in_port():
    """The JAX fused kernel pads every window with zero rows, so on a
    north-south cyclic grid it computes open-boundary dynamics: after one
    subcycle it differs from the JAX evp by O(0.1) in the velocities. The
    port refuses that configuration."""
    ny, nx = 16, 32
    cfg = ModelConfig(grid=GridConfig(nx=nx, ny=ny, dx_const=20000.0,
                                      dy_const=20000.0), dtype="float64")
    g = jrectgrid(cfg, land_mask=np.ones((ny, nx)))
    aice = jnp.full((ny, nx), 0.9)
    z = jnp.zeros((ny, nx))
    f = dict(aice=aice, vice=aice * 1.5, vsno=aice * 0.1,
             strength=strength_hibler(aice, aice * 1.5),
             strairxT=z + 0.12, strairyT=z - 0.05, uocn=z + 0.02, vocn=z,
             uvel=z, vvel=z, stressp=jnp.zeros((4, ny, nx)),
             stressm=jnp.zeros((4, ny, nx)),
             stress12=jnp.zeros((4, ny, nx)), iceumask=z)
    p = jdyn.EVPParams.classic(3600.0, ndte=1)
    topo = JTopology(ew="cyclic", ns="cyclic")
    ref = jevp.evp(3600.0, p, g, topo, **f)
    fus = jevp_fused(3600.0, p, g, topo, **f, kchunk=1, nwin=1)
    du = float(jnp.abs(ref.uvel - fus.uvel).max())
    dv = float(jnp.abs(ref.vvel - fus.vvel).max())
    assert du > 1e-2 and dv > 1e-2, (du, dv)

    tcfg = tconfig.rect_config(ny=8, nx=8)
    tcfg = tcfg.replace(
        grid=dataclasses.replace(tcfg.grid, ns_boundary="cyclic"),
        dyn=dataclasses.replace(tcfg.dyn, evp_algorithm="pallas"))
    with pytest.raises(NotImplementedError, match="evp_fused.py"):
        check_supported(tcfg)
    tg = convert.grid_from_arrays({k.name: np.asarray(getattr(g, k.name))
                                   for k in dataclasses.fields(g)},
                                  device="cpu")
    with pytest.raises(ValueError, match="cyclic"):
        tfused.evp_fused(3600.0, _tparams(p), tg,
                         Topology(ew="cyclic", ns="cyclic"), kchunk=1,
                         nwin=1, **{k: torch.as_tensor(np.array(v))
                                    for k, v in f.items()})


def test_ndte_not_a_multiple_of_kchunk_raises():
    p, kw = _sweep_inputs(5)
    with pytest.raises(ValueError, match="multiple"):
        tfused.fused_sweep_plain(p, 5, Topology(**OPEN), kchunk=2, nwin=2,
                                 **kw)


def test_step_dispatches_like_the_jax_step(monkeypatch):
    """``evp_algorithm="pallas"`` takes the fused sweep on the open BL99
    grid and evp on the gx1-parity tripole seam, as the JAX step does
    (cice5_tpu/driver/step.py:1010-1014); "auto" takes evp."""
    from cice5_tpu_torch.grid import synth_gx1_grid
    calls = []
    for name in ("evp", "evp_fused"):
        fn = getattr(step_mod, name)
        monkeypatch.setattr(step_mod, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    easy = tconfig.bench_easy_config(ny=8, nx=8, ndte=10, dtype="float64")
    parity = tconfig.gx1_parity_config(dtype="float64",
                                       accum_dtype="float64")
    parity = parity.replace(grid=dataclasses.replace(parity.grid, ny=24,
                                                     nx=16))
    for cfg, algo, want in ((easy, "pallas", "evp_fused"),
                            (easy, "auto", "evp"),
                            (parity, "pallas", "evp")):
        cfg = cfg.replace(dyn=dataclasses.replace(cfg.dyn, ndte=10,
                                                  evp_algorithm=algo))
        grid = synth_gx1_grid(cfg, device="cpu") \
            if cfg.grid.ns_boundary == "tripole" else None
        m = Model(cfg, grid=grid, device="cpu")
        st = m.init_state(ice_mask=m.grid.tmask)
        calls.clear()
        m.step(st, m.forcing_at(0))
        assert calls == [want], (algo, cfg.grid.ns_boundary)


# --- two steps of the fused path against the recorded JAX step ----------

STATE = ("aicen", "vicen", "vsnon", "trcrn", "uvel", "vvel", "sst",
         "frzmlt", "strocnxT", "strocnyT", "iceumask", "scale_factor")
STRESS = ("stressp", "stressm", "stress12")
DIAG = ("aice", "vice", "vsno", "fsens", "flat", "flwout", "evap", "fresh",
        "fsalt", "fhocn", "fswthru", "fswabs", "strairxT", "meltt", "meltb",
        "congel", "snoice", "frazil", "meltl", "dardg1dt", "dvirdgdt",
        "divu", "shear", "alvdr", "Tsfc", "strength", "Tref", "opening",
        "daidtd", "dvidtd")
DIAG_STRESS = ("strintx", "strinty", "prs_sig")


def _jcfg():
    return ModelConfig(
        grid=GridConfig(nx=NX, ny=NY, dx_const=40000.0, dy_const=40000.0,
                        lat0=55.0),
        dyn=DynConfig(kdyn=1, ndte=NDTE, advection="remap", kstrength=1,
                      evp_algorithm="pallas"),
        forcing=ForcingConfig(oceanmixed_ice=True, natmiter=5),
        time=TimeConfig(dt=3600.0), dtype="float64", accum_dtype="float64")


def make_reference() -> dict:
    """Run the JAX package under ``_jcfg``: the initial state (ice on every
    ocean cell), one warm-up step (from rest the first EVP step turns
    rounding noise into stress, so two backends part by ~1e-8 there), then
    two jitted steps. Returns {"in/<field>": the warmed-up state,
    "forcing/<field>", "out/<field>": state after two steps, "diag/<field>":
    diagnostics of the last step}."""
    from cice5_tpu.driver.model import Model as JModel
    from cice5_tpu.driver.step import step as jstep_fn
    jm = JModel(_jcfg())
    st0 = jm.init_state(ice_mask=np.asarray(jm.grid.tmask))
    f0 = jm.forcing_at(0)
    jstep = jit_fast(partial(jstep_fn, cfg=jm.cfg, tr=jm.tr, topo=jm.topo,
                             hin_max=jm.hin_max, salinz=jm.salinz))
    sw, _ = jstep(st0, f0, jm.grid)
    s1, _ = jstep(sw, f0, jm.grid)
    s2, d2 = jstep(s1, f0, jm.grid)
    out = {}
    for prefix, obj in (("in", sw), ("forcing", f0), ("out", s2)):
        for fld in dataclasses.fields(obj):
            v = getattr(obj, fld.name)
            if v is not None and (prefix != "out"
                                  or fld.name in STATE + STRESS):
                out[f"{prefix}/{fld.name}"] = np.asarray(v)
    for k in DIAG + DIAG_STRESS + ("state_bad",):
        out[f"diag/{k}"] = np.asarray(getattr(d2, k))
    return out


def reference_key() -> str:
    """SHA-256 of what the recorded reference depends on: every source
    file of the JAX package, the configuration and this recipe."""
    h = hashlib.sha256()
    root = Path(__file__).resolve().parents[1] / "cice5_tpu"
    for path in sorted(root.rglob("*.py")):
        h.update(path.relative_to(root).as_posix().encode())
        h.update(path.read_bytes())
    h.update(json.dumps(dataclasses.asdict(_jcfg()), sort_keys=True,
                        default=repr).encode())
    h.update(inspect.getsource(make_reference).encode())
    h.update(repr((STATE, STRESS, DIAG, DIAG_STRESS)).encode())
    return h.hexdigest()


def _part(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def runs():
    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files if k != "key"}
    cfg = convert.config_from_dict(dataclasses.asdict(_jcfg()))
    m = Model(cfg, device="cpu")
    st = convert.state_from_arrays(_part(ref, "in"), device="cpu")
    f = convert.forcing_from_arrays(_part(ref, "forcing"), device="cpu")
    ts2, td2 = m.rollout(st, f, 2)
    return dict(js2=_part(ref, "out"), jd2=_part(ref, "diag"),
                ts2=convert.to_numpy(ts2), td2=convert.to_numpy(td2))


@pytest.mark.parametrize("group", ["state", "stress", "diag"])
def test_fused_path_two_steps_match_jax(runs, group):
    js2, ts2, jd2, td2 = runs["js2"], runs["ts2"], runs["jd2"], runs["td2"]
    if group == "state":
        for k in STATE:
            assert_close(js2[k], ts2[k], 3e-8, k, floor=1.0)
    elif group == "stress":
        for k in STRESS:
            assert_close(js2[k], ts2[k], 1e-5, k, floor=1.0)
        for k in DIAG_STRESS:
            assert_close(jd2[k], td2[k], 1e-5, k, floor=1.0)
    else:
        for k in DIAG:
            assert_close(jd2[k], td2[k], 3e-8, k, floor=1.0)
        assert int(jd2["state_bad"]) == int(td2["state_bad"]) == 0


def test_recorded_reference_matches_its_inputs():
    """The recorded JAX reference was made from the JAX package, the
    configuration and the recipe as they are now."""
    with np.load(REFERENCE) as z:
        assert str(z["key"]) == reference_key(), (
            "test_torch_evp_fused.npz is stale: rewrite it with "
            "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_evp_fused.py")


@pytest.mark.slow
def test_recorded_reference_is_current():
    """Recompute the JAX reference (~65 s of compile) and hold the recorded
    arrays to it."""
    fresh = make_reference()
    with np.load(REFERENCE) as z:
        for k, a in fresh.items():
            assert_close(a, z[k], 1e-12, k, floor=1.0)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(REFERENCE, key=np.array(reference_key()),
                        **make_reference())
    print(f"wrote {REFERENCE}")
