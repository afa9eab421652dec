"""PyTorch port of the delta-Eddington shortwave vs the JAX package.

The port's plain version (``dedd.shortwave_dEdd_plain``, all categories
at once: the reference the CUDA kernel ``shortwave_dedd`` is held against
on the GPU) against the JAX package's vmapped ``shortwave_dEdd`` (run op
by op: its jit compile alone takes ~35 s on a CPU), at (nilyr, nslyr) =
(4, 1), (7, 1), CESM2's (8, 3) and (4, 3) with level ponds, on inputs
that hold lit and unlit columns (ice-free cells, coszen <= 0, no
sunlight) and bare, snow and pond surfaces. Each output
field, and each layer of the layered ones, agrees on its own scale to
1e-11. The JAX Pallas kernel ``shortwave_dEdd_tiled`` in interpret mode
(block_rows=4) computes the same function; that comparison is marked slow
(~40 s of compile per layer count) and holds to 1e-9, the JAX paths'
own difference. At 8/3 the port's generic one-surface path
(``dedd.compute_dEdd``, which the JAX package's tests use as the oracle of
``shortwave_dEdd``) is the per-surface oracle of the plain version, and
is itself held against the JAX ``compute_dEdd``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.models.radiation import dedd as jdedd
from cice5_tpu.ops.pallas.dedd_fused import shortwave_dEdd_tiled
from cice5_tpu_torch.models.radiation import dedd as tdedd
from cice5_tpu_torch.ops import kernels
from torch_port_util import assert_close

RTOL = 1e-11
NCAT, NY, NX = 3, 8, 8
PARAMS = dict(R_ice=0.0, R_pnd=0.0, R_snw=1.5, dT_mlt=1.5, rsnw_mlt=1500.0,
              kalg=0.6, hs0=0.0, hs1=0.03, pndaspect=0.8)


def _inputs(seed=7):
    """Category fields (ncat, ny, nx) and forcing planes (ny, nx): rows
    0-1 ice-free, rows 6-7 in polar night, column 0 without sunlight;
    category 0 snow-free (bare and ponded ice), category 2 snow-covered
    with no ponds, and some ponds too shallow to count."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or (NCAT, NY, NX))
    aicen = u(0.05, 0.6)
    aicen[:, :2] = 0.0
    vicen = aicen * u(0.1, 3.0)
    vsnon = aicen * u(0.0, 0.3)
    vsnon[0] = 0.0
    vsnon[1, :, ::2] = aicen[1, :, ::2] * 0.01
    apnd = u(0.0, 0.6)
    apnd[2] = 0.0
    hpnd = u(0.0, 0.4)
    hpnd[1, 3] = 0.003
    coszen = u(0.05, 0.9, NY, NX)
    coszen[6:] = -0.2
    sw = [u(0.0, 200.0, NY, NX) for _ in range(4)]
    for s in sw:
        s[:, 0] = 0.0
    cat = dict(aicen=aicen, vicen=vicen, vsnon=vsnon, Tsfcn=u(-15.0, 0.0),
               apnd=apnd, hpnd=hpnd)
    frc = dict(coszen=coszen, fnidr=u(0.3, 0.7, NY, NX), swvdr=sw[0],
               swvdf=sw[1], swidr=sw[2], swidf=sw[3])
    return cat, frc


def _jax_vmapped(cat, frc, nilyr, scheme, nslyr=1):
    kw = dict(nilyr=nilyr, nslyr=nslyr, pond_scheme=scheme, **PARAMS,
              **{k: jnp.asarray(v) for k, v in frc.items()})
    return jax.vmap(lambda a, v, s, t, p, h: jdedd.shortwave_dEdd(
        aicen=a, vicen=v, vsnon=s, Tsfcn=t, apnd=p, hpnd=h, **kw))(
        *(jnp.asarray(cat[k]) for k in ("aicen", "vicen", "vsnon", "Tsfcn",
                                        "apnd", "hpnd")))


def _port(cat, frc, nilyr, scheme, nslyr=1):
    return tdedd.shortwave_dEdd_ncat(
        nilyr=nilyr, nslyr=nslyr, pond_scheme=scheme, **PARAMS,
        **{k: torch.as_tensor(v) for k, v in {**cat, **frc}.items()})


def _compare(ref, got, rtol=RTOL):
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name)
        if a.ndim == 4:                       # (ncat, layer, ny, nx)
            for k in range(a.shape[1]):
                assert_close(a[:, k], b[:, k], rtol, f"{name}[{k}]",
                             floor=1e-12)
        else:
            assert_close(a, b, rtol, name, floor=1e-12)


# (nilyr, nslyr): the kernel's default build, CESM2's column and more snow
# layers than a thin ice column's ice layers
LAYERS = [pytest.param(4, 1, id="4"), pytest.param(7, 1, id="7"),
          pytest.param(8, 3, id="8-3"), pytest.param(4, 3, id="4-3")]


@pytest.mark.parametrize("nilyr,nslyr", LAYERS)
def test_shortwave_dEdd_matches_jax(nilyr, nslyr):
    cat, frc = _inputs()
    kernels.reset_launch_counts()
    got = _port(cat, frc, nilyr, "lvl", nslyr)
    assert kernels.launch_counts()["shortwave_dedd"] == 0
    assert got.Sswabsn.shape[1] == nslyr and got.Iswabsn.shape[1] == nilyr
    ref = _jax_vmapped(cat, frc, nilyr, "lvl", nslyr)
    _compare(ref, got)
    # the unlit columns are exact zeros; the lit ones carry sunlight
    for x in got:
        assert torch.all(x[..., :2, :] == 0) and torch.all(x[..., 6:, :] == 0)
        assert torch.all(x[..., 0] == 0)
    assert float(got.fswsfcn.max()) > 1.0 and float(got.albpndn.max()) > 0.1
    assert float(got.Sswabsn.max()) > 0.0


def test_shortwave_dEdd_cesm_ponds_match_jax():
    cat, frc = _inputs(9)
    _compare(_jax_vmapped(cat, frc, 4, "cesm"), _port(cat, frc, 4, "cesm"))


def test_kernel_tables_hold_the_plain_versions_numbers():
    """The kernel's tables: the snow tables, each band's optical constants,
    and the segment constants of the snow-table lookups, the very doubles
    dedd._interp_table computes (fp[k+1] - fp[k] and 1 / (xp[k+1] -
    xp[k]))."""
    tab = tdedd.kernel_tables(0.0, 0.0, torch.device("cpu")).numpy()
    niop = 3 * len(tdedd.IOP_KEYS)
    assert tab.shape == (32 + 3 * 96 + niop + 3 * 93 + 31,)
    np.testing.assert_array_equal(tab[:32], jdedd.RSNW_TAB)
    np.testing.assert_array_equal(tab[32:128].reshape(32, 3), jdedd.QS_TAB)
    seg = tab[320 + niop:]
    xp = np.asarray(jdedd.RSNW_TAB, np.float64)
    for n, fp in enumerate((jdedd.QS_TAB, jdedd.WS_TAB, jdedd.GS_TAB)):
        fp = np.asarray(fp, np.float64)
        steps = seg[93 * n:93 * (n + 1)].reshape(31, 3)
        for k in range(31):
            for ns in range(3):
                assert steps[k, ns] == float(fp[k + 1, ns] - fp[k, ns])
    for k in range(31):
        assert seg[279 + k] == 1.0 / float(xp[k + 1] - xp[k])
    iops = tab[320:320 + niop].reshape(3, -1)
    for ns in range(3):
        k, w = jdedd._tune(jdedd.KI_DL_MN[ns], jdedd.WI_DL_MN[ns], 0.0, 0.15,
                           0.15)
        assert iops[ns, tdedd.IOP_KEYS.index("k_dl")] == k
        assert iops[ns, tdedd.IOP_KEYS.index("w_dl")] == w
        assert iops[ns, tdedd.IOP_KEYS.index("kw")] == jdedd.KW[ns]


@pytest.mark.slow
@pytest.mark.parametrize("nilyr", [4, 7])
def test_shortwave_dEdd_matches_pallas_interpret(nilyr):
    """1e-9: the interpret-mode kernel rounds the differences of large net
    fluxes (the layer absorptions Iswabsn) otherwise than the vmapped XLA
    path: at nilyr=7 the two JAX paths differ from each other by up to
    3.0e-10 of Iswabsn[6]'s scale, and the port (within 7e-14 of the
    vmapped path) by as much from the kernel."""
    cat, frc = _inputs()
    ref = shortwave_dEdd_tiled(
        nilyr=nilyr, nslyr=1, pond_scheme="lvl", interpret=True,
        block_rows=4, **PARAMS,
        **{k: jnp.asarray(v) for k, v in {**cat, **frc}.items()})
    _compare(ref, _port(cat, frc, nilyr, "lvl"), rtol=1e-9)


@pytest.mark.parametrize("srftyp", [0, 1, 2])
def test_compute_dEdd_matches_jax(srftyp):
    """The generic one-surface path (layer optics, the case-batched
    adding method with the Fresnel layer, the per-band partition)."""
    rng = np.random.default_rng(13)
    u = lambda lo, hi: rng.uniform(lo, hi, (NY, NX))
    d = dict(coszen=u(0.05, 0.9), fnidr=u(0.3, 0.7), swvdr=u(0, 200),
             swvdf=u(0, 200), swidr=u(0, 200), swidf=u(0, 200),
             hs=u(0.0, 0.3) if srftyp == 1 else np.zeros((NY, NX)),
             rsnw=u(100.0, 1500.0), hi=u(0.1, 3.0), hp=u(0.0, 0.4))
    kw = dict(nilyr=4, nslyr=1, srftyp=srftyp)
    ref = jdedd.compute_dEdd(**kw, **{k: jnp.asarray(v) for k, v in d.items()})
    got = tdedd.compute_dEdd(**kw, **{k: torch.as_tensor(v)
                                      for k, v in d.items()})
    for name in ref._fields:
        assert_close(getattr(ref, name), getattr(got, name), RTOL, name,
                     floor=1e-12)


def _pure_surface(case, nilyr, nslyr):
    """Inputs on which every lit column is one surface ("bare": no snow or
    ponds, "snow": deep cold snow, "pond": deep ponds on bare ice), and
    the port's compute_dEdd of that surface on them, as
    tests/test_dedd.py's TestDedupFastPathEquivalence builds it."""
    cat, frc = _inputs(11)
    if case == "snow":
        cat["vsnon"] = cat["aicen"] * 0.3
        cat["Tsfcn"] = np.full_like(cat["aicen"], -15.0)
    else:
        cat["vsnon"] = np.zeros_like(cat["aicen"])
    cat["apnd"] = np.full_like(cat["aicen"], 1.0 if case == "pond" else 0.0)
    cat["hpnd"] = np.full_like(cat["aicen"], 0.3 if case == "pond" else 0.0)
    srf = ("bare", "snow", "pond").index(case)
    T = {k: torch.as_tensor(v) for k, v in {**cat, **frc}.items()}
    fs, hs, rsnw = tdedd.set_snow(T["aicen"], T["vsnon"], T["Tsfcn"],
                                  R_snw=1.5, rsnw_mlt=1500.0, dT_mlt=1.5,
                                  hs0=0.0)
    hs_eff = (torch.clamp(hs, min=1e-4) if srf == 1
              else torch.zeros_like(hs))
    hp = T["hpnd"] if srf == 2 else torch.zeros_like(hs)
    hi = torch.clamp(T["vicen"] / torch.clamp(T["aicen"], min=1e-11),
                     min=1e-11)
    one = dict(nilyr=nilyr, nslyr=nslyr, srftyp=srf, kalg=PARAMS["kalg"],
               **{k: torch.broadcast_to(T[k], hs.shape) for k in (
                   "coszen", "fnidr", "swvdr", "swvdf", "swidr", "swidf")})
    return cat, frc, one, dict(hs=hs_eff, rsnw=rsnw, hi=hi, hp=hp)


@pytest.mark.parametrize("case", ["bare", "snow", "pond"])
def test_compute_dEdd_is_the_per_surface_oracle(case):
    """At CESM2's 8 ice and 3 snow layers, on columns of one surface, the
    plain version (shared layer properties, the three surfaces mixed)
    equals the port's generic one-surface path (``compute_dEdd``) on
    every lit column, to 1e-11 of each field's scale; and that path
    equals the JAX package's ``compute_dEdd`` on the same inputs."""
    nilyr, nslyr = 8, 3
    cat, frc, one, col = _pure_surface(case, nilyr, nslyr)
    got = _port(cat, frc, nilyr, "lvl", nslyr)
    lit = got.fswsfcn != 0
    assert int(lit.sum()) > 10
    fs = got.snowfracn[lit]
    assert bool((fs == (1.0 if case == "snow" else 0.0)).all())
    ref = tdedd.compute_dEdd(**one, **col)
    pairs = (("alvdrn", ref.avdr), ("alidfn", ref.aidf),
             ("fswsfcn", ref.fsfc), ("fswintn", ref.fint),
             ("fswthrun", ref.fthru))
    for name, want in pairs:
        assert_close(want[lit], getattr(got, name)[lit], RTOL, name,
                     floor=1e-12)
    for name, want in (("Iswabsn", ref.Iabs), ("fswpenln", ref.fthrul),
                       ("Sswabsn", ref.Sabs)):
        mine = getattr(got, name)
        for k in range(want.shape[0]):
            assert_close(want[k][lit], mine[:, k][lit], RTOL,
                         f"{name}[{k}]", floor=1e-12)
    if case == "snow":
        assert float(ref.Sabs.abs().max()) > 0.0
    jref = jdedd.compute_dEdd(**{
        k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
        for k, v in {**one, **col}.items()})
    for name in jref._fields:
        assert_close(getattr(jref, name), getattr(ref, name), RTOL, name,
                     floor=1e-12)
