"""The chunked EVP (K subcycles per halo exchange; the port's
``evp.evp_chunked``) against the JAX package's ``evp_chunked`` and against
the port's loop with one exchange per subcycle.

Inputs as tests/test_evp_chunked.py builds them (a 32x48 float64 basin,
cyclic east-west, an open or U-fold north, ice of 0.8-0.95 from a seeded
generator, wind and ocean stress), on the JAX package's grid; ndte=8. One
device: the port's ``evp_chunked`` equals the JAX function within 2e-11
for K = 2, 4, 8 (tests/test_evp_chunked.py:67-76), and the port's
per-subcycle ``evp`` within the same bound. On the 2x2 and 1x4 meshes of 4
gloo ranks (tests/torch_sharded_worker.py): the per-subcycle loop and
``evp_chunked`` against the one-device ``evp``, velocities within 1e-10
and stress within 1e-7 (:108-122, :222-238), in ndte/K margin exchanges
per chunk loop against one per subcycle. Each bound is absolute for a
field below 1 in magnitude and relative to the field's largest magnitude
above it: the stress (~2e3 N/m) of the two packages parts by 1.5e-12 of
its scale, 3.5e-9 absolute.
"""
import numpy as np
import pytest
import torch

import torch_sharded_worker as worker
from cice5_tpu_torch import convert
from cice5_tpu_torch.models.dynamics import shared as tdyn
from cice5_tpu_torch.models.dynamics.evp import evp, evp_chunked
from cice5_tpu_torch.parallel import Topology
from torch_port_util import assert_close, jit_fast

NY, NX, NDTE = 32, 48, 8
FIELDS = ("uvel", "vvel", "stressp", "stressm", "stress12", "divu",
          "rdg_conv", "strocnxT")


@pytest.fixture(scope="module")
def inputs():
    """(JAX grid, JAX fields, the same as NumPy arrays)."""
    import jax.numpy as jnp
    from cice5_tpu.config import rect_config
    from cice5_tpu.grid import rectgrid
    from cice5_tpu.models.dynamics.strength import strength_hibler
    rng = np.random.default_rng(1234)
    g = rectgrid(rect_config(ny=NY, nx=NX, dtype="float64",
                             accum_dtype="float64"))
    aice = jnp.where(g.tmask, 0.8 + 0.15 * jnp.asarray(
        rng.random((NY, NX))), 0.0)
    z = jnp.zeros((NY, NX), jnp.float64)
    f = dict(aice=aice, vice=aice * 2.0, vsno=aice * 0.1,
             strength=strength_hibler(aice, aice * 2.0),
             strairxT=jnp.where(g.tmask, 0.12, 0.0),
             strairyT=jnp.where(g.tmask, -0.05, 0.0),
             uocn=z + 0.02, vocn=z - 0.01, uvel=z, vvel=z,
             stressp=jnp.zeros((4, NY, NX)), stressm=jnp.zeros((4, NY, NX)),
             stress12=jnp.zeros((4, NY, NX)), iceumask=z)
    grid_np = {k: np.asarray(getattr(g, k)) for k in g.__dataclass_fields__}
    return g, f, grid_np, {k: np.asarray(v) for k, v in f.items()}


def _port(inputs):
    _, _, grid_np, f_np = inputs
    grid = convert.grid_from_arrays(grid_np, device="cpu")
    return grid, {k: torch.from_numpy(v.copy()) for k, v in f_np.items()}


def _close(ref, got, tol, what):
    """Every field within ``tol`` (per field if a dict) x max(its largest
    magnitude, 1): absolute for the velocities (|u| < 1 m/s), relative
    for the stress (~2e3 N/m)."""
    for k in FIELDS:
        a = np.asarray(getattr(ref, k)) if not isinstance(ref, dict) \
            else ref[k]
        b = getattr(got, k).numpy() if not isinstance(got, dict) else got[k]
        assert_close(a, b, tol[k] if isinstance(tol, dict) else tol,
                     f"{what} {k}", floor=1.0)


@pytest.mark.parametrize("ns", ["open", "tripole"])
@pytest.mark.parametrize("K", [2, 4, 8])
def test_matches_jax_evp_chunked(inputs, ns, K):
    from cice5_tpu.models.dynamics import shared as jdyn
    from cice5_tpu.models.dynamics.evp import evp_chunked as jchunked
    from cice5_tpu.parallel import Topology as JTopology
    g, f, _, _ = inputs
    jp = jdyn.EVPParams.classic(3600.0, ndte=NDTE)
    ref = jit_fast(lambda ff: jchunked(3600.0, jp, g, JTopology(
        ew="cyclic", ns=ns), K=K, **ff))(f)
    grid, tf = _port(inputs)
    p = tdyn.EVPParams.classic(3600.0, ndte=NDTE)
    got = evp_chunked(3600.0, p, grid, Topology(ew="cyclic", ns=ns), K=K,
                      **tf)
    assert float(np.abs(got.uvel.numpy()).max()) > 1e-3
    _close(ref, got, 2e-11, f"{ns} K={K}")


@pytest.mark.parametrize("ns", ["open", "tripole"])
def test_matches_per_subcycle_on_one_device(inputs, ns):
    grid, tf = _port(inputs)
    p = tdyn.EVPParams.classic(3600.0, ndte=NDTE)
    topo = Topology(ew="cyclic", ns=ns)
    ref = evp(3600.0, p, grid, topo, **tf)
    for K in (2, 4):
        _close(ref, evp_chunked(3600.0, p, grid, topo, K=K, **tf), 2e-11,
               f"{ns} K={K}")


def test_refusals(inputs):
    grid, tf = _port(inputs)
    p = tdyn.EVPParams.classic(3600.0, ndte=NDTE)
    with pytest.raises(ValueError, match="divisible"):
        evp_chunked(3600.0, p, grid, Topology(), K=3, **tf)
    with pytest.raises(NotImplementedError, match="T-fold"):
        evp_chunked(3600.0, p, grid, Topology(ns="tripoleT"), K=4, **tf)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_on_a_mesh_matches_one_device(inputs, tmp_path, mesh):
    """The per-subcycle loop and evp_chunked over 4 ranks against the
    one-device loop, on the open and the U-fold north; the chunk loop's
    margin exchanges against the subcycle loop's."""
    _, _, grid_np, f_np = inputs
    arrays = tmp_path / "evp_inputs.npz"
    np.savez(arrays, **{f"grid/{k}": v for k, v in grid_np.items()},
             **{f"f/{k}": v for k, v in f_np.items()})
    out = worker.launch(tmp_path / "ranks", dict(
        mesh=list(mesh), tasks=["evp"], evp=dict(
            arrays=str(arrays), ns=["open", "tripole"], ndte=NDTE,
            K=[2, 4], fields=list(FIELDS))))["evp"]
    grid, tf = _port(inputs)
    p = tdyn.EVPParams.classic(3600.0, ndte=NDTE)
    tol = dict.fromkeys(FIELDS, 1e-10)
    tol.update(stressp=1e-7, stressm=1e-7, stress12=1e-7)
    for ns in ("open", "tripole"):
        ref = evp(3600.0, p, grid, Topology(ew="cyclic", ns=ns), **tf)
        for label in ("evp", "chunked2", "chunked4"):
            got = {k: out[0][f"{ns}/{label}/{k}"] for k in FIELDS}
            _close(ref, got, tol, f"{mesh} {ns} {label}")
        loop = int(out[0][f"{ns}/evp/exchanges"])
        for K in (2, 4):
            chunked = int(out[0][f"{ns}/chunked{K}/exchanges"])
            # the subcycle loop: 2 axes per subcycle (a 1-rank axis
            # exchanges nothing); the chunk loop: 2 per chunk
            assert chunked < loop, (ns, K, chunked, loop)
            assert loop - chunked >= (NDTE - NDTE // K) * (
                (mesh[0] > 1) + (mesh[1] > 1)), (ns, K, chunked, loop)
