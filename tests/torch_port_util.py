"""Shared helpers of the tests/test_torch_*.py files: the CUDA-device
fixture of the tests marked ``gpu``, the scale-aware comparison, and a
cheap compile of the JAX reference. Importing this module imports no
JAX, so the GPU-marked tests run where JAX is not installed."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine")
    return torch.device("cuda", 0)


def assert_close(ref, got, rtol, name="", floor=1e-300):
    """max |ref - got| <= rtol * max(max|ref|, floor)."""
    a = np.asarray(ref, dtype=np.float64)
    b = (got.detach().cpu().numpy() if torch.is_tensor(got)
         else np.asarray(got)).astype(np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.size == 0:
        return
    scale = max(float(np.abs(a).max()), floor)
    err = float(np.abs(a - b).max())
    assert err <= rtol * scale, f"{name}: max err {err:.3e} > " \
        f"{rtol:.1e} * {scale:.3e}"


# XLA:CPU options for a reference that runs once per test: compiling is
# most of its cost, and the backend's optimisations only move its last
# bits, far inside every tolerance of these tests
XLA_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                    "xla_llvm_disable_expensive_passes": True}


def jit_fast(fn):
    """``fn`` jitted and compiled once, at its first call, with
    XLA_FAST_COMPILE. Static arguments are closed over by ``fn``."""
    import jax
    compiled = []

    def call(*args, **kw):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args, **kw).compile(
                XLA_FAST_COMPILE))
        return compiled[0](*args, **kw)
    return call


# The gx1-parity reference of tests/test_torch_parity_step.py: the JAX
# package's parity step on a 24x16 synthetic global grid whose land touches
# the tripole seam, ndte=8, float64, recorded in PARITY_REFERENCE. One
# jitted JAX parity step costs ~15 s to trace and ~100 s to compile on a
# CPU (and ~45 s to run with XLA_FAST_COMPILE), so the tier-1 test reads
# the recorded arrays and a test marked slow recomputes them.
PARITY_NY, PARITY_NX, PARITY_NDTE = 24, 16, 8
PARITY_ISTEP = 172 * 24 + 12      # a northern-summer noon: sun and melt
PARITY_REFERENCE = __import__("pathlib").Path(__file__).with_name(
    "test_torch_parity_step.npz")
PARITY_STATE = ("aicen", "vicen", "vsnon", "trcrn", "uvel", "vvel", "sst",
                "frzmlt", "strocnxT", "strocnyT", "iceumask",
                "scale_factor", "stressp", "stressm", "stress12")
PARITY_DIAG = ("aice", "vice", "vsno", "fsens", "flat", "flwout", "evap",
               "fresh", "fsalt", "fhocn", "fswthru", "fswabs", "strairxT",
               "meltt", "melts", "meltb", "congel", "snoice", "frazil",
               "meltl", "dardg1dt", "dvirdgdt", "divu", "shear", "alvdr",
               "alidf", "Tsfc", "strength", "Tref", "opening", "daidtd",
               "dvidtd", "albice", "albsno", "albpnd", "fswint", "fpond",
               "dagedtt", "dagedtd", "snowfracn", "fsurf", "strintx",
               "strinty", "prs_sig", "state_bad", "therm_converged")


def parity_grid_arrays():
    """(ULAT, ULON, HTN, HTE, ANGLE, KMT) of the parity test grid: the
    synthetic global mesh of synth_gx1_grid at 24x16, with a land mask
    that touches the tripole seam off its fold symmetry."""
    from cice5_tpu_torch.grid import synth_global_arrays
    kmt = np.ones((PARITY_NY, PARITY_NX), np.int32)
    kmt[:2] = 0
    kmt[-1, 3:6] = 0          # land on the seam row
    kmt[-2, 4] = 0
    kmt[-1, 11] = 0
    return synth_global_arrays(kmt)


def parity_config_dict(dtype="float64") -> dict:
    """dataclasses.asdict of the JAX package's gx1_parity_config cut to
    the test grid: the same keyword set builds the port's config."""
    import dataclasses
    from cice5_tpu.config import gx1_parity_config
    c = gx1_parity_config()
    c = c.replace(grid=dataclasses.replace(c.grid, ny=PARITY_NY,
                                           nx=PARITY_NX),
                  dyn=dataclasses.replace(c.dyn, ndte=PARITY_NDTE),
                  dtype=dtype, accum_dtype=dtype)
    return dataclasses.asdict(c)


def make_parity_reference() -> dict:
    """Run the JAX package: initial state with ponds, ages and first-year
    area seeded from a fixed generator, one warm-up step, then two steps.
    Returns {"in/<field>": warmed-up state, "forcing/<field>",
    "out/<field>": state after two steps, "diag/<field>": diagnostics of
    the last step}."""
    import dataclasses
    from functools import partial
    import jax
    import jax.numpy as jnp
    from cice5_tpu import config as jconfig
    from cice5_tpu.driver.model import Model as JModel
    from cice5_tpu.driver.step import step as jstep_fn
    from cice5_tpu.grid import popgrid_np

    d = parity_config_dict()
    cfg = jconfig.ModelConfig(**{
        k: (getattr(jconfig, type(getattr(jconfig.ModelConfig(), k))
                    .__name__)(**v) if isinstance(v, dict) else v)
        for k, v in d.items()})
    jm = JModel(cfg, grid=popgrid_np(cfg, *parity_grid_arrays()))
    st0 = jm.init_state()
    tr = jm.tr
    rng = np.random.default_rng(11)
    trc = np.array(st0.trcrn)
    has = np.array(st0.aicen) > 0
    u = lambda lo, hi: np.where(has, rng.uniform(lo, hi, has.shape), 0.0)
    trc[:, tr.nt_apnd] = u(0.1, 0.5)
    trc[:, tr.nt_hpnd] = u(0.02, 0.3)
    trc[:, tr.nt_ipnd] = u(0.0, 0.02)
    trc[:, tr.nt_iage] = u(0.0, 3e7)
    trc[:, tr.nt_FY] = np.where(has, 1.0, 0.0)
    st0 = st0.replace(trcrn=jnp.asarray(trc))
    # summer rain on the ice: the pond lid's "no fresh water" branch
    # (compute_ponds_lvl: dvn == 0) then never rests on rounding noise
    f0 = jm.forcing_at(PARITY_ISTEP)
    f0 = f0.replace(frain=jnp.full_like(f0.frain, 2.0e-5))
    jstep = jax.jit(partial(jstep_fn, cfg=jm.cfg, tr=tr, topo=jm.topo,
                            hin_max=jm.hin_max, salinz=jm.salinz))
    sw, _ = jstep(st0, f0, jm.grid)
    s1, _ = jstep(sw, f0, jm.grid)
    s2, d2 = jstep(s1, f0, jm.grid)
    out = {}
    for prefix, obj in (("in", sw), ("forcing", f0), ("out", s2)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is not None and (prefix != "out" or f.name in PARITY_STATE):
                out[f"{prefix}/{f.name}"] = np.asarray(v)
    for k in PARITY_DIAG:
        out[f"diag/{k}"] = np.asarray(getattr(d2, k))
    return out


def parity_reference_key() -> str:
    """SHA-256 of what the recorded reference depends on: every source
    file of the JAX package, the configuration, the code that builds the
    grid arrays and the recipe of make_parity_reference. Sources are
    hashed rather than the arrays, whose last bits may differ between
    CPUs."""
    import hashlib
    import inspect
    import json
    import pathlib
    from cice5_tpu_torch import grid as tgrid
    h = hashlib.sha256()
    root = pathlib.Path(__file__).resolve().parents[1] / "cice5_tpu"
    for path in sorted(root.rglob("*.py")):
        h.update(path.relative_to(root).as_posix().encode())
        h.update(path.read_bytes())
    h.update(json.dumps(parity_config_dict(), sort_keys=True,
                        default=repr).encode())
    for fn in (parity_grid_arrays, tgrid.synth_global_arrays,
               make_parity_reference):
        h.update(inspect.getsource(fn).encode())
    h.update(repr((tgrid.REARTH, PARITY_NY, PARITY_NX, PARITY_NDTE,
                   PARITY_ISTEP, PARITY_STATE, PARITY_DIAG)).encode())
    return h.hexdigest()


def load_parity_reference() -> dict:
    """The recorded arrays, without the key they were recorded under."""
    with np.load(PARITY_REFERENCE) as z:
        return {k: z[k] for k in z.files if k != "key"}


def recorded_parity_key() -> str:
    with np.load(PARITY_REFERENCE) as z:
        return str(z["key"]) if "key" in z.files else ""


if __name__ == "__main__":
    # python tests/torch_port_util.py: rewrite PARITY_REFERENCE from the
    # JAX package (needs JAX with float64: JAX_ENABLE_X64=1)
    import jax
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(PARITY_REFERENCE, key=np.array(parity_reference_key()),
                        **make_parity_reference())
    print(f"wrote {PARITY_REFERENCE}")
