"""PyTorch port of the single-device halo (parallel/halo.py) vs the JAX
package: ghost rings on cyclic, open and closed boundaries, with the
staggering/parity arguments and the W=1/W=2 rings of extend_wide. Exact.
(The tripole folds: tests/test_torch_tripole.py.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.constants import FieldLoc as JLoc, FieldType as JKind
from cice5_tpu.parallel import halo as jhalo
from cice5_tpu_torch.constants import FieldLoc, FieldType
from cice5_tpu_torch.parallel import halo

BOUNDS = ["cyclic", "open", "closed"]


def _field(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("ew", BOUNDS)
@pytest.mark.parametrize("ns", BOUNDS)
@pytest.mark.parametrize("loc,kind", [("CENTER", "SCALAR"),
                                      ("NECORNER", "VECTOR")])
def test_extend_matches(ew, ns, loc, kind):
    f = _field((2, 6, 9))
    ref = jhalo.extend(jnp.asarray(f), jhalo.Topology(ew=ew, ns=ns),
                       loc=JLoc[loc], kind=JKind[kind])
    got = halo.extend(torch.as_tensor(f), halo.Topology(ew=ew, ns=ns),
                      loc=FieldLoc[loc], kind=FieldType[kind])
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("ew", BOUNDS)
@pytest.mark.parametrize("ns", BOUNDS)
@pytest.mark.parametrize("W", [1, 2])
def test_extend_wide_matches(ew, ns, W):
    f = _field((3, 2, 6, 8), 2)
    ref = jhalo.extend_wide(jnp.asarray(f), jhalo.Topology(ew=ew, ns=ns), W)
    got = halo.extend_wide(torch.as_tensor(f), halo.Topology(ew=ew, ns=ns),
                           W)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_shifted_interior_and_sums():
    f = _field((6, 9), 3)
    E = jhalo.extend(jnp.asarray(f), jhalo.Topology())
    T = halo.extend(torch.as_tensor(f), halo.Topology())
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            np.testing.assert_array_equal(np.asarray(jhalo.shifted(E, di, dj)),
                                          halo.shifted(T, di, dj).numpy())
    np.testing.assert_array_equal(f, halo.interior(T).numpy())
    assert float(halo.global_sum(torch.as_tensor(f), halo.Topology())) == \
        pytest.approx(float(f.sum()), rel=1e-14)
    assert float(halo.global_min(torch.as_tensor(f), halo.Topology())) == \
        float(f.min())


@pytest.mark.parametrize("ns", ["tripole", "tripoleT"])
def test_tripole_raises(ns):
    """The fold is a north seam (tests/test_torch_tripole.py holds it
    against the JAX package); an east-west fold does not exist."""
    with pytest.raises(NotImplementedError, match="north seam"):
        halo.extend(torch.zeros(4, 6), halo.Topology(ew=ns))
    assert halo.extend(torch.zeros(4, 6), halo.Topology(ns=ns)).shape == \
        (6, 8)
