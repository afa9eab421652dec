"""The tripole fold of the PyTorch port vs the JAX package: the U-fold
(``tripole``) and T-fold (``tripoleT``) ghost rows of ``extend``,
``extend_wide`` and ``extend_wide_groups`` for every staggering and
parity (the degenerate on-fold rows included) and with fold partners
(exact); the seam umask of the POP grid builder on a grid whose land
touches the seam (exact); and the EVP on a tripole seam: the port's
``subcycle_sweep`` against the JAX package's Pallas ``sweep_resident`` in
interpret mode on inputs captured from a JAX ``evp`` run, and the whole
``evp`` driver (metric partner ghosts, the stress partner permutation),
at 1e-11 x scale."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu import ModelConfig
from cice5_tpu.config import GridConfig
from cice5_tpu.constants import FieldLoc as JLoc, FieldType as JKind
from cice5_tpu.grid import popgrid_np as jpopgrid, rectgrid as jrectgrid
from cice5_tpu.models.dynamics import evp as jevp
from cice5_tpu.models.dynamics import shared as jdyn
from cice5_tpu.models.dynamics.strength import strength_hibler
from cice5_tpu.ops.pallas.evp_resident import sweep_resident
from cice5_tpu.parallel import halo as jhalo
from cice5_tpu_torch import convert
from cice5_tpu_torch.constants import FieldLoc, FieldType
from cice5_tpu_torch.grid import popgrid_np as tpopgrid
from cice5_tpu_torch.models.dynamics import evp as tevp
from cice5_tpu_torch.models.dynamics import shared as tdyn
from cice5_tpu_torch.parallel import halo
from torch_port_util import assert_close, parity_grid_arrays

LOCS = ["CENTER", "NECORNER", "EFACE", "NFACE"]
KINDS = ["SCALAR", "VECTOR"]
FOLDS = ["tripole", "tripoleT"]


def _field(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("ns", FOLDS)
@pytest.mark.parametrize("loc", LOCS)
@pytest.mark.parametrize("kind", KINDS)
def test_extend_fold_matches(ns, loc, kind):
    f = _field((2, 6, 10), 1)
    for ew in ("cyclic", "open"):
        ref = jhalo.extend(jnp.asarray(f), jhalo.Topology(ew=ew, ns=ns),
                           loc=JLoc[loc], kind=JKind[kind])
        got = halo.extend(torch.as_tensor(f), halo.Topology(ew=ew, ns=ns),
                          loc=FieldLoc[loc], kind=FieldType[kind])
        _eq(ref, got)


@pytest.mark.parametrize("ns", FOLDS)
@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("loc", LOCS)
def test_extend_wide_fold_matches(ns, W, loc):
    f = _field((3, 7, 12), 2)
    for kind in KINDS:
        ref = jhalo.extend_wide(jnp.asarray(f), jhalo.Topology(ns=ns), W,
                                loc=JLoc[loc], kind=JKind[kind])
        got = halo.extend_wide(torch.as_tensor(f), halo.Topology(ns=ns), W,
                               loc=FieldLoc[loc], kind=FieldType[kind])
        _eq(ref, got)


# staggerings that lie off the fold row and so take a fold partner
_PARTNER_LOCS = {"tripole": ["CENTER", "EFACE"],
                 "tripoleT": ["NECORNER", "NFACE"]}


@pytest.mark.parametrize("ns", FOLDS)
@pytest.mark.parametrize("W", [1, 2])
def test_fold_partner_matches(ns, W):
    f, p = _field((6, 10), 3), _field((6, 10), 4)
    for loc in _PARTNER_LOCS[ns]:
        kw = dict(loc=JLoc[loc], fold_partner=jnp.asarray(p), fold_sign=-1.0)
        tkw = dict(loc=FieldLoc[loc], fold_partner=torch.as_tensor(p),
                   fold_sign=-1.0)
        ref = jhalo.extend_wide(jnp.asarray(f), jhalo.Topology(ns=ns), W,
                                **kw)
        got = halo.extend_wide(torch.as_tensor(f), halo.Topology(ns=ns), W,
                               **tkw)
        _eq(ref, got)
        if W == 1:
            _eq(jhalo.extend(jnp.asarray(f), jhalo.Topology(ns=ns), **kw),
                halo.extend(torch.as_tensor(f), halo.Topology(ns=ns), **tkw))
    # an on-fold staggering: the JAX package takes no partner there; the
    # port's ghost row is the partner's fold image of the source row and
    # the field's own top row stays as it is (the T-fold's EVP metrics)
    dloc = "NECORNER" if ns == "tripole" else "CENTER"
    with pytest.raises(NotImplementedError):
        jhalo.extend(jnp.asarray(f), jhalo.Topology(ns=ns), loc=JLoc[dloc],
                     fold_partner=jnp.asarray(p), fold_sign=-1.0)
    got = halo.extend(torch.as_tensor(f), halo.Topology(ns=ns),
                      loc=FieldLoc[dloc], fold_partner=torch.as_tensor(p),
                      fold_sign=-1.0)
    ioff, joff = (1, 1) if ns == "tripole" else (-1, 0)
    src = p[-1 - joff]
    ghost = -src[(10 - 1 - np.arange(10) - ioff) % 10]
    np.testing.assert_array_equal(got[-1, 1:-1].numpy(), ghost)
    np.testing.assert_array_equal(got[1:-1, 1:-1].numpy(), f)


@pytest.mark.parametrize("W", [1, 2])
def test_extend_wide_groups_matches(W):
    """(u, v) as NECORNER vectors and 12 stress components through their
    partner permutation, in one ring (the chunked-EVP grouping)."""
    f = _field((14, 6, 10), 5)
    perm = jevp._TRIPOLE_STRESS_PERM
    jf = jnp.asarray(f)
    tf = torch.as_tensor(f)
    jg = [(slice(0, 2), JLoc.NECORNER, JKind.VECTOR, None, 1.0),
          (slice(2, 14), JLoc.CENTER, JKind.SCALAR,
           jf[2:][jnp.asarray(perm)], 1.0)]
    tg = [(slice(0, 2), FieldLoc.NECORNER, FieldType.VECTOR, None, 1.0),
          (slice(2, 14), FieldLoc.CENTER, FieldType.SCALAR,
           tf[2:][list(perm)], 1.0)]
    ref = jhalo.extend_wide_groups(jf, jhalo.Topology(ns="tripole"), W, jg)
    got = halo.extend_wide_groups(tf, halo.Topology(ns="tripole"), W, tg)
    _eq(ref, got)
    _eq(jhalo.extend_wide_groups(jf, jhalo.Topology(), W, jg),
        halo.extend_wide_groups(tf, halo.Topology(), W, tg))
    with pytest.raises(NotImplementedError):
        halo.extend_wide_groups(tf, halo.Topology(ns="tripoleT"), W, tg)


def test_seam_umask_with_land_on_the_seam():
    """The tripole umask takes the north neighbour from the fold image:
    the POP grid builder gives the JAX package's masks and metrics."""
    jc = ModelConfig(grid=GridConfig(nx=16, ny=24, grid_type="tripole",
                                     ns_boundary="tripole"), dtype="float64")
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    arrays = parity_grid_arrays()
    jg = jpopgrid(jc, *arrays)
    tg = tpopgrid(tc, *arrays, device="cpu")
    for f in dataclasses.fields(jg):
        a = np.asarray(getattr(jg, f.name))
        b = getattr(tg, f.name)
        if a.dtype == bool:
            _eq(a, b)
        else:
            assert_close(a, b, 1e-15, f.name, floor=1.0)
    um = tg.umask.numpy()
    nx = um.shape[1]
    # fold self-conjugacy of the seam row: umask(i) == umask(nx-2-i)
    assert all(um[-1, i] == um[-1, (nx - 2 - i) % nx] for i in range(nx))
    assert not um[-1].all()


def _evp_setup(ny=16, nx=32, seed=7):
    """A rectangular tripole domain with random ice, as
    tests/test_evp_resident.py sets it up."""
    cfg = ModelConfig(grid=GridConfig(nx=nx, ny=ny, dx_const=20000.0,
                                      dy_const=20000.0), dtype="float64")
    jg = jrectgrid(cfg)
    tg = convert.grid_from_arrays({f.name: np.asarray(getattr(jg, f.name))
                                   for f in dataclasses.fields(jg)},
                                  device="cpu")
    rng = np.random.RandomState(seed)
    tmask = np.asarray(jg.tmask)
    aice = np.where(tmask, rng.uniform(0.3, 1.0, (ny, nx)), 0.0)
    vice = aice * 1.5
    f = dict(
        aice=aice, vice=vice, vsno=aice * 0.1,
        strength=np.array(strength_hibler(jnp.asarray(aice),
                                          jnp.asarray(vice))),
        strairxT=np.where(tmask, 0.12, 0.0),
        strairyT=np.where(tmask, -0.05, 0.0),
        uocn=np.full((ny, nx), 0.02), vocn=np.zeros((ny, nx)),
        uvel=rng.uniform(-0.1, 0.1, (ny, nx)),
        vvel=rng.uniform(-0.1, 0.1, (ny, nx)),
        stressp=rng.uniform(-500, 500, (4, ny, nx)),
        stressm=rng.uniform(-500, 500, (4, ny, nx)),
        stress12=rng.uniform(-500, 500, (4, ny, nx)),
        iceumask=(rng.uniform(size=(ny, nx)) > 0.5).astype(float))
    return jg, tg, f


def _tparams(p):
    return tdyn.EVPParams(**dataclasses.asdict(p))


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, float):
        return x
    return torch.as_tensor(np.array(x))


def test_subcycle_sweep_tripole_matches_resident(monkeypatch):
    jg, _, f = _evp_setup()
    topo = jhalo.Topology(ew="cyclic", ns="tripole")
    p = jdyn.EVPParams.classic(3600.0, ndte=12)
    captured = {}
    orig = jevp.subcycle_sweep

    def capture(pp, nd, tp, **kw):
        captured["kw"] = kw
        return orig(pp, nd, tp, **kw)

    monkeypatch.setattr(jevp, "subcycle_sweep", capture)
    jevp.evp(3600.0, p, jg, topo, **{k: jnp.asarray(v) for k, v in f.items()})
    monkeypatch.setattr(jevp, "subcycle_sweep", orig)
    ref = sweep_resident(p, 12, topo, **captured["kw"], interpret=True)
    got = tevp.subcycle_sweep(_tparams(p), 12,
                              halo.Topology(ew="cyclic", ns="tripole"),
                              **_to_torch(captured["kw"]))
    names = ("u", "v", "stress", "divu", "shear", "rdg_conv", "rdg_shear",
             "prs_sig", "strintx", "strinty")
    for name, a, b in zip(names, list(ref[:3]) + list(ref[3]),
                          list(got[:3]) + list(got[3])):
        assert_close(a, b, 1e-11, name, floor=1e-12)


def test_evp_tripole_matches():
    """The whole EVP driver on a tripole seam: the fold-partner metric
    ghosts, the stress partner permutation and the vector folds of the
    staggering helpers."""
    jg, tg, f = _evp_setup(seed=3)
    p = jdyn.EVPParams.classic(3600.0, ndte=12)
    ref = jevp.evp(3600.0, p, jg, jhalo.Topology(ew="cyclic", ns="tripole"),
                   **{k: jnp.asarray(v) for k, v in f.items()})
    got = tevp.evp(3600.0, _tparams(p), tg,
                   halo.Topology(ew="cyclic", ns="tripole"),
                   **{k: torch.as_tensor(v) for k, v in f.items()})
    for name in ref._fields:
        assert_close(getattr(ref, name), getattr(got, name), 1e-11, name,
                     floor=1e-12)
    a = f["strairxT"]
    for kind in (JKind.SCALAR, JKind.VECTOR):
        assert_close(jdyn.to_ugrid(jnp.asarray(a), jg,
                                   jhalo.Topology(ns="tripole"), kind=kind),
                     tdyn.to_ugrid(torch.as_tensor(a), tg,
                                   halo.Topology(ns="tripole"),
                                   kind=FieldType(int(kind))), 1e-14, "ugrid")
    assert_close(jdyn.to_tgrid(jnp.asarray(a), jg,
                               jhalo.Topology(ns="tripole")),
                 tdyn.to_tgrid(torch.as_tensor(a), tg,
                               halo.Topology(ns="tripole")), 1e-14, "tgrid")
