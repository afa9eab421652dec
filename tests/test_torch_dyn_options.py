"""The dynamics and transport options of the port against the JAX package,
in float64 on the CPU.

Step level: the six sets of ``torch_option_sets.DYN_SETS`` (the BL99 model
on a T-fold seam, EAP alone and with the per-category mechred
diagnostics, upwind transport, the transport checks, dynamics without
transport) run in tests/test_torch_options.py like every set; here the
fields only they record: the EAP structure tensor (3e-8 of scale), the
strain-rate and yield-stress tensors (3e-8 and 1e-5, as velocities and
stresses), the mechred stack (3e-8), the conservation error and the
monotonicity count. The T-fold set's reference runs the JAX package's
Pallas remap kernel, which the port's kernel B replaces; the slow test
below shows that the JAX XLA remap differs on the fold rows there.

Op by op at 1e-11: the EAP yield tables, ``update_stress_rdg``, ``stepa``;
``upwind_field`` and ``transport_upwind``; the transport checks; the ITD
conservation checks; ridging's per-category diagnostics (also over-run
invariant). The T-fold grid, metric ghosts and stress seed; the EAP and
mechred history fields and the EAP restart.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.config import rect_config as jrect_config
from cice5_tpu.models.dynamics import eap as jeap
from cice5_tpu.models.dynamics import evp as jevp
from cice5_tpu.models.dynamics import ridge as jridge
from cice5_tpu.models.thermo import itd as jitd
from cice5_tpu.models.transport import remap as jremap
from cice5_tpu.models.transport import upwind as jupwind
from cice5_tpu.parallel import Topology as JTopology
from cice5_tpu.state import build_tracer_registry as jbuild
from cice5_tpu_torch import convert
from cice5_tpu_torch.models.dynamics import eap as teap
from cice5_tpu_torch.models.dynamics import evp as tevp
from cice5_tpu_torch.models.dynamics import ridge as tridge
from cice5_tpu_torch.models.thermo import itd as titd
from cice5_tpu_torch.models.transport import remap as tremap
from cice5_tpu_torch.models.transport import upwind as tupwind
from cice5_tpu_torch.parallel import Topology
from cice5_tpu_torch.state import build_tracer_registry as tbuild
import torch_option_sets as O
import torch_port_util as U
from torch_port_util import assert_close
from test_torch_options import port_inputs, port_model, run

RTOL = 1e-11
NY, NX = 12, 16


def _pair(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in d.items()})


# ---------------------------------------------------------------- step level

@pytest.mark.parametrize("name", O.DYN_SETS)
def test_dynamics_outputs_after_two_steps_match(name):
    r = run(name)
    js, jd = O.part(r["ref"], "out"), O.part(r["ref"], "diag")
    for k in O.DYN_STATE:
        assert_close(js[k], r["tn2"][k], 3e-8, f"{name}: {k}", floor=1.0)
    # strain rates (1/s) on their own scale, as velocities; the yield
    # stresses as stresses
    for k in ("e11", "e12", "e22"):
        assert_close(jd[k], r["td2"][k], 3e-8, f"{name}: {k}", floor=1e-12)
    for k in ("yieldstress11", "yieldstress12", "yieldstress22"):
        assert_close(jd[k], r["td2"][k], 1e-5, f"{name}: {k}", floor=1.0)
    for i, k in enumerate(("dardg1ndt", "dardg2ndt", "dvirdgndt", "araftn",
                           "vraftn", "aparticn", "krdgn", "aredistn",
                           "vredistn")[:jd["rdgn"].shape[0]]):
        assert_close(jd["rdgn"][i], r["td2"]["rdgn"][i], 3e-8,
                     f"{name}: {k}", floor=1e-6 if i < 3 else 1.0)
    assert r["td2"]["rdgn"].shape == jd["rdgn"].shape
    assert float(r["td2"]["transport_conserv_err"]) <= 1e-13
    assert float(jd["transport_conserv_err"]) <= 1e-13
    # the same count of cells outside the local bounds (16 on the
    # transport_checks set in both packages, ROADMAP section C)
    assert int(r["td2"]["transport_mono_bad"]) == \
        int(jd["transport_mono_bad"])


def test_each_dynamics_option_is_live():
    """EAP moves the structure tensor off its isotropic start and fills the
    tensors; the mechred stack holds ridging; upwind, no transport and
    remap move the ice differently from one step's state."""
    eap = run("eap")["tn2"]
    assert np.abs(eap["a11n"] - 0.5).max() > 1e-3
    d = run("eap")["td2"]
    assert np.abs(d["e11"]).max() > 0 and np.abs(d["yieldstress11"]).max() > 0
    rd = run("eap_mechred")["td2"]["rdgn"]
    assert rd.shape[0] == 9 and rd[0].max() > 0 and rd[6].max() > 1.0
    a = {n: run(n)["tn2"]["aicen"] for n in ("upwind", "dyn_no_transport",
                                             "transport_checks")}
    assert np.abs(a["upwind"] - a["transport_checks"]).max() > 1e-6
    assert np.abs(a["dyn_no_transport"] - a["transport_checks"]).max() > 1e-6


# ------------------------------------------------------------ EAP op by op

def test_yield_tables_match_jax():
    ref = jeap.build_yield_tables()
    got = teap.build_yield_tables()
    np.testing.assert_array_equal(ref, got)
    t = teap.yield_tables(torch.float32, torch.device("cpu"))
    assert t.dtype == torch.float32 and t.shape == (6, 41, 41, 21)
    assert teap.yield_tables(torch.float32, torch.device("cpu")) is t


def _rdg_inputs(seed=3):
    """Random strain rates, structure tensors and strengths; where a11 >=
    0.8 the strain rates are +0.0 (the leng <= puny branch; a -0.0 would
    turn atan2's angle by pi there, ROADMAP section C)."""
    rng = np.random.default_rng(seed)
    shp = (4, NY, NX)
    a11 = rng.uniform(0.1, 0.9, shp)
    strain = lambda: np.where(a11 < 0.8, rng.normal(0, 1e-6, shp), 0.0)
    return dict(divu=strain(), tension=strain(), shear=strain(), a11=a11,
                a12=rng.uniform(-0.3, 0.3, shp),
                strength=rng.uniform(1e3, 3e4, shp))


def test_update_stress_rdg_matches_jax():
    J, T = _pair(_rdg_inputs())
    ref = jeap.update_stress_rdg(**J, tables=jnp.asarray(
        jeap.build_yield_tables()))
    got = teap.update_stress_rdg(**T, tables=teap.yield_tables(
        torch.float64, torch.device("cpu")))
    for k in ref._fields:
        assert_close(getattr(ref, k), getattr(got, k), RTOL, k)


def test_stepa_matches_jax():
    rng = np.random.default_rng(4)
    stress = rng.uniform(-2e4, 2e4, (12, NY, NX))
    a11 = rng.uniform(0.1, 0.9, (4, NY, NX))
    a12 = rng.uniform(-0.3, 0.3, (4, NY, NX))
    ref = jeap.stepa(120.0 / 3600.0, jnp.asarray(stress), jnp.asarray(a11),
                     jnp.asarray(a12))
    got = teap.stepa(120.0 / 3600.0, torch.as_tensor(stress),
                     torch.as_tensor(a11), torch.as_tensor(a12))
    for a, b in zip(ref, got):
        assert_close(a, b, RTOL, "stepa")
    assert float((got[0] - torch.as_tensor(a11)).abs().max()) > 0.0


# ------------------------------------------------------- transport op by op

def _itd_state(seed=21, ny=NY, nx=NX):
    """A random float64 BL99 state (5 categories) with land, the JAX and
    port tracer registries and configs."""
    jcfg = jrect_config(ny=ny, nx=nx, dtype="float64")
    jcfg = jcfg.replace(tracers=dataclasses.replace(jcfg.tracers,
                                                    tr_iage=True))
    jtr = jbuild(jcfg)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    ttr = tbuild(tcfg)
    rng = np.random.default_rng(seed)
    ncat = jcfg.ncat
    aicen = rng.uniform(0.0, 0.2, (ncat, ny, nx))
    aicen[:, 0, :] = 0.0
    aicen[:, 3, 2:5] = 0.0
    vicen = aicen * rng.uniform(0.2, 3.0, (ncat, ny, nx))
    vsnon = aicen * rng.uniform(0.0, 0.4, (ncat, ny, nx))
    trcrn = np.zeros((ncat, jtr.ntrcr, ny, nx))
    trcrn[:, jtr.nt_Tsfc] = rng.uniform(-20.0, -0.5, (ncat, ny, nx))
    trcrn[:, jtr.nt_qice:jtr.nt_qice + jcfg.nilyr] = rng.uniform(
        -3.2e8, -2.5e8, (ncat, jcfg.nilyr, ny, nx))
    trcrn[:, jtr.nt_sice:jtr.nt_sice + jcfg.nilyr] = rng.uniform(
        0.5, 4.0, (ncat, jcfg.nilyr, ny, nx))
    trcrn[:, jtr.nt_qsno] = rng.uniform(-1.2e8, -1.1e8, (ncat, ny, nx))
    trcrn[:, jtr.nt_iage] = rng.uniform(0.0, 3e7, (ncat, ny, nx))
    return dict(jcfg=jcfg, tcfg=tcfg, jtr=jtr, ttr=ttr, aicen=aicen,
                vicen=vicen, vsnon=vsnon, trcrn=trcrn, rng=rng)


def _grids(jcfg, ns):
    """(JAX grid, port grid) of the 24x16 test mesh with boundary ``ns``."""
    from cice5_tpu.grid import popgrid_np as jpopgrid
    from cice5_tpu_torch.grid import popgrid_np as tpopgrid
    jc = jcfg.replace(grid=dataclasses.replace(
        jcfg.grid, ny=O.NY, nx=O.NX, ew_boundary="cyclic", ns_boundary=ns,
        grid_type="tripole" if ns.startswith("tripole") else
        "displaced_pole"))
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    return (jpopgrid(jc, *O.grid_arrays()),
            tpopgrid(tc, *O.grid_arrays(), device="cpu"))


@pytest.mark.parametrize("ns", ["open", "tripole", "tripoleT"])
def test_upwind_transport_matches_jax(ns):
    s = _itd_state(ny=O.NY, nx=O.NX)
    jg, tg = _grids(s["jcfg"], ns)
    rng = s["rng"]
    hm = np.asarray(jg.hm)
    uv = dict(uvel=rng.uniform(-0.3, 0.3, (O.NY, O.NX)) * hm,
              vvel=rng.uniform(-0.3, 0.3, (O.NY, O.NX)) * hm)
    st = {k: s[k] * hm for k in ("aicen", "vicen", "vsnon")}
    aice0 = np.clip(1.0 - st["aicen"].sum(0), 0.0, None) * hm
    J, T = _pair(dict(uv, trcrn=s["trcrn"], aice0=aice0, **st))
    jt, tt = JTopology(ew="cyclic", ns=ns), Topology(ew="cyclic", ns=ns)
    ref = jupwind.transport_upwind(3600.0, jg, jt, s["jtr"], **J)
    got = tupwind.transport_upwind(3600.0, tg, tt, s["ttr"], **T)
    for name, a, b in zip(("aicen", "vicen", "vsnon", "trcrn", "aice0"),
                          ref, got):
        assert_close(a, b, RTOL, name, floor=1e-12)
    assert float((got[0] - T["aicen"]).abs().max()) > 1e-6
    phi = rng.normal(size=(3, O.NY, O.NX))
    uee, vnn = (rng.normal(0, 0.2, (O.NY + 2, O.NX + 2)) for _ in range(2))
    assert_close(jupwind.upwind_field(3600.0, jnp.asarray(phi),
                                      jnp.asarray(uee), jnp.asarray(vnn), jg,
                                      jt),
                 tupwind.upwind_field(3600.0, torch.as_tensor(phi),
                                      torch.as_tensor(uee),
                                      torch.as_tensor(vnn), tg, tt),
                 RTOL, "upwind_field")


def test_transport_checks_match_jax():
    """``transport_remap`` with both checks, the port's plain kernel B
    against the JAX XLA remap on an open grid; the bounds, the violation
    mask (a perturbed field has violations) and the global sums on their
    own."""
    s = _itd_state(ny=O.NY, nx=O.NX)
    jg, tg = _grids(s["jcfg"], "open")
    rng = s["rng"]
    hm = np.asarray(jg.hm)
    st = {k: s[k] * hm for k in ("aicen", "vicen", "vsnon")}
    uv = dict(uvel=rng.uniform(-0.2, 0.2, (O.NY, O.NX)) * hm,
              vvel=rng.uniform(-0.2, 0.2, (O.NY, O.NX)) * hm)
    J, T = _pair(dict(uv, trcrn=s["trcrn"], **st))
    topo = dict(ew="cyclic", ns="open")
    ref = jremap.transport_remap(1800.0, jg, JTopology(**topo), s["jtr"],
                                 conserv_check=True, monotonicity_check=True,
                                 **J)
    got = tremap.transport_remap(1800.0, tg, Topology(**topo), s["ttr"],
                                 conserv_check=True, monotonicity_check=True,
                                 **T)
    for name, a, b in zip(("aicen", "vicen", "vsnon", "trcrn"), ref, got):
        assert_close(a, b, 1e-10, name, floor=1e-12)
    # ice leaves through the open boundary: a conservation "error"
    assert int(ref[4].mono_violations) == int(got[4].mono_violations)
    assert_close(ref[4].conserv_err, got[4].conserv_err, 1e-8, "conserv")
    assert float(got[4].conserv_err) > 1e-10

    tt, par = tremap.tracer_table(s["ttr"])[:2]
    tm = rng.uniform(0.0, 1.0, (5, len(tt), O.NY, O.NX))
    mm = rng.uniform(0.0, 0.3, (5, O.NY, O.NX)) * (rng.uniform(
        size=(5, O.NY, O.NX)) > 0.2)
    aim = (mm > 0).astype(float)
    jb = [jremap.monotonicity_bounds(jnp.asarray(tm[n]), jnp.asarray(aim[n]),
                                     tuple(tt), tuple(par),
                                     JTopology(**topo)) for n in range(5)]
    tmin, tmax = tremap.monotonicity_bounds(
        torch.as_tensor(tm), torch.as_tensor(aim), tt, par, Topology(**topo))
    assert_close(np.stack([b[0] for b in jb]), tmin, 0.0, "tmin")
    assert_close(np.stack([b[1] for b in jb]), tmax, 0.0, "tmax")
    tm_new = tm * rng.uniform(0.9, 1.3, tm.shape)
    jbad = np.stack([np.asarray(jremap.check_monotonicity(
        jb[n][0], jb[n][1], jnp.asarray(mm[n]), jnp.asarray(tm_new[n]),
        tuple(tt), tuple(par))) for n in range(5)])
    tbad = tremap.check_monotonicity(tmin, tmax, torch.as_tensor(mm),
                                     torch.as_tensor(tm_new), tt, par)
    np.testing.assert_array_equal(jbad, tbad.numpy())
    assert jbad.sum() > 0
    assert_close(jremap.global_conservation(jnp.asarray(mm[0]), jg.tarea,
                                            JTopology(**topo)),
                 tremap.global_conservation(torch.as_tensor(mm[0]), tg.tarea,
                                            Topology(**topo)), RTOL, "sum")


def test_itd_conservation_checks_match_jax():
    s = _itd_state()
    J, T = _pair({k: s[k] for k in ("aicen", "vicen", "vsnon", "trcrn")})
    pre_j = jitd.itd_conservation_sums(s["jtr"], 7, 1, **J)
    pre_t = titd.itd_conservation_sums(s["ttr"], 7, 1, **T)
    for a, b in zip(pre_j, pre_t):
        assert_close(a, b, RTOL, "sums")
    # a shifted volume and heat content: violations in some cells
    bump = np.where(s["rng"].uniform(size=(NY, NX)) < 0.3, 1e-6, 0.0)
    post = [x + bump * (1.0 if i != 2 else 1e6)
            for i, x in enumerate(np.asarray(p) for p in pre_j)]
    nj = int(jitd.itd_conservation_check(pre_j, [jnp.asarray(p)
                                                 for p in post]))
    nt = int(titd.itd_conservation_check(pre_t, [torch.as_tensor(p)
                                                 for p in post]))
    assert nj == nt > 0
    assert int(titd.itd_conservation_check(pre_t, pre_t)) == 0
    cj = jitd.column_conservation_check(pre_j[0], jnp.asarray(post[0]), 1e-9)
    ct_ = titd.column_conservation_check(pre_t[0], torch.as_tensor(post[0]),
                                         1e-9)
    assert int(cj[0]) == int(ct_[0]) and float(cj[1]) == float(ct_[1])


# ------------------------------------------------ ridging's category stack

def _ridge_inputs(s):
    aice0 = np.clip(1.0 - s["aicen"].sum(0), 0.0, None)
    return _pair(dict(aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
                      trcrn=s["trcrn"], aice0=aice0,
                      rdg_conv=np.full((NY, NX), 2e-6),
                      rdg_shear=np.full((NY, NX), 4e-6)))


def test_ridge_cat_diags_match_jax():
    s = _itd_state()
    hin_max = jitd.category_bounds(5, 1, 1)
    J, T = _ridge_inputs(s)
    ref = jridge.ridge_ice(3600.0, s["jtr"], hin_max, 7, 1, cat_diags=True,
                           **J)
    got = tridge.ridge_ice(3600.0, s["ttr"], hin_max, 7, 1, cat_diags=True,
                           **T)
    assert got.catdiag.shape == (9, 5, NY, NX)
    for i in range(9):
        assert_close(ref.catdiag[i], got.catdiag[i], RTOL, f"catdiag[{i}]",
                     floor=1e-10)
    off = tridge.ridge_ice(3600.0, s["ttr"], hin_max, 7, 1, **T)
    assert off.catdiag.shape == (0, 5, NY, NX)
    assert torch.equal(off.aicen, got.aicen)
    assert float(got.catdiag[0].max()) > 0.0


def test_ridge_cat_diags_are_over_run_invariant():
    """Ridging with its category stack run to its end, then three more
    passes (as the graphs may run them): they change no entry of the
    carry, the participation and ridge-thickness planes of the last pass
    that ran included."""
    from cice5_tpu_torch.ops import loop
    s = _itd_state()
    hin_max = jitd.category_bounds(5, 1, 1)
    _, T = _ridge_inputs(s)
    changed = []

    def driver(body, pending, carry):
        go = pending(carry)
        while bool(go):
            carry = body(carry, go)
            go = pending(carry)
        more = carry
        for _ in range(3):
            more = body(more, pending(more))
        changed.extend(k for k in carry if not torch.equal(carry[k],
                                                           more[k]))
        return more

    with loop.driven_by(driver):
        got = tridge.ridge_ice(3600.0, s["ttr"], hin_max, 7, 1,
                               cat_diags=True, **T)
    assert changed == [] and float(got.catdiag[5].max()) > 0.0


# --------------------------------------------------------------- the T-fold

def test_tfold_grid_matches_jax():
    """The POP grid builder on a T-fold seam takes the replicate ghost for
    the umask's north neighbour, as the JAX package does
    (cice5_tpu/grid.py:156-161: the fold image only on the U-fold), and
    synth_gx1_grid builds the same T-fold grid."""
    from cice5_tpu.grid import popgrid_np as jpopgrid
    from cice5_tpu_torch import grid as tgrid
    s = _itd_state()
    jg, tg = _grids(s["jcfg"], "tripoleT")
    ju, _ = _grids(s["jcfg"], "tripole")
    for k in ("umask", "tmask", "hm", "dxt", "cxp", "cym", "tarear",
              "uarear", "ANGLET"):
        assert_close(np.asarray(getattr(jg, k)), getattr(tg, k), 1e-14, k)
    assert not np.array_equal(np.asarray(jg.umask), np.asarray(ju.umask))
    jc = s["jcfg"].replace(grid=dataclasses.replace(
        s["jcfg"].grid, ny=40, nx=32, ns_boundary="tripoleT",
        grid_type="tripole"))
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    kmt = tgrid._gx1_kmt()
    kmt = kmt[np.arange(40) * kmt.shape[0] // 40][:, np.arange(32)
                                                  * kmt.shape[1] // 32]
    a = jpopgrid(jc, *tgrid.synth_global_arrays(kmt))
    b = tgrid.synth_gx1_grid(tc, device="cpu")
    for k in ("umask", "hm", "dyt", "dxhy"):
        assert_close(np.asarray(getattr(a, k)), getattr(b, k), 1e-14, k)


def test_tfold_region_metrics_and_stress_seed():
    """The EVP region on the T-fold: the one-sided metrics' ghost row is
    the partner's fold image of the top row (the recipe's
    ``tfold_region_metrics``, where the JAX package raises), the others
    as the JAX package extends them; the stress ghost row is the plain
    centre fold, without the U-fold's partner permutation."""
    s = _itd_state()
    jg, tg = _grids(s["jcfg"], "tripoleT")
    jt, tt = JTopology(ew="cyclic", ns="tripoleT"), Topology(ew="cyclic",
                                                             ns="tripoleT")
    with pytest.raises(NotImplementedError):
        jevp._region_metrics(jg, jt, ("cxp",))
    ref = O.tfold_region_metrics(jevp)(jg, jt, tevp.GR_NAMES)
    got = tevp._region_metrics(tg, tt, tevp.GR_NAMES)
    for k in tevp.GR_NAMES:
        assert_close(np.asarray(ref[k]), got[k], 0.0, k)
    stress = s["rng"].normal(size=(12, O.NY, O.NX))
    assert_close(np.asarray(jevp._extend_stress(jnp.asarray(stress), jt)),
                 tevp._extend_stress(torch.as_tensor(stress), tt), 0.0,
                 "stress")
    ufold = tevp._extend_stress(torch.as_tensor(stress),
                                Topology(ew="cyclic", ns="tripole"))
    assert not torch.equal(ufold[:, -1], tevp._extend_stress(
        torch.as_tensor(stress), tt)[:, -1])
    assert tevp.fold_mode(tt) == 2 and tevp.fold_mode(
        Topology(ns="tripole")) == 1 and tevp.fold_mode(Topology()) == 0


@pytest.mark.slow
def test_tfold_fold_rows_differ_from_the_jax_xla_remap():
    """The T-fold set against the JAX step with its XLA remap in place of
    the Pallas kernel: the port (kernel B's plain version) equals the
    Pallas reference to rounding, and the XLA step parts from both on the
    two fold rows only: B reconstructs the fold row from symmetrized raw
    values, the XLA path symmetrizes the reconstruction
    (cice5_tpu/models/transport/remap.py:707-713); the fold rows keep a
    7e-7 difference after two steps (ROADMAP section C)."""
    import functools
    import jax
    from cice5_tpu.driver.model import Model as JModel
    from cice5_tpu.driver.step import step as jstep_fn
    from cice5_tpu.grid import popgrid_np as jpopgrid
    name = "tfold"
    cfg = U.jax_config(O.option_sets()[name])
    cfg = cfg.replace(dyn=dataclasses.replace(cfg.dyn, remap_kernel="xla"))
    jm = JModel(cfg, grid=jpopgrid(cfg, *O.grid_arrays()))
    ref = O.load_reference(name)
    st = jm.init_state().replace(**{k: jnp.asarray(v) for k, v in
                                    O.part(ref, "in").items()})
    f = jm.forcing_at(O.ISTEP).replace(**{
        k: jnp.asarray(v) for k, v in O.part(ref, "forcing").items()})
    saved = jevp._region_metrics
    jevp._region_metrics = O.tfold_region_metrics(jevp)
    try:
        jstep = U.jit_fast(functools.partial(
            jstep_fn, cfg=jm.cfg, tr=jm.tr, topo=jm.topo,
            hin_max=jm.hin_max, salinz=jm.salinz))
        for _ in range(O.NSTEPS):
            st, _ = jstep(st, f, jm.grid)
        jax.block_until_ready(st.aicen)
    finally:
        jevp._region_metrics = saved
    r = run(name)
    pallas = O.part(ref, "out")
    for k in ("aicen", "vicen"):
        xla = np.asarray(getattr(st, k))
        assert_close(pallas[k], r["tn2"][k], 1e-14, k, floor=1.0)
        d = np.abs(xla - r["tn2"][k]).max(0)
        assert d[-2:].max() > 3e-8, k
        assert d[:-2].max() <= 3e-8, k


# ------------------------------------------------------ history and restart

def test_eap_and_mechred_history_and_restart_interchange(tmp_path):
    """The EAP fields (a11, a12, the strain-rate and yield-stress tensors)
    and the per-category mechred fields: the port's catalog,
    diag_to_values of a step and the history file equal the JAX
    package's; an npz restart of an EAP state, a11n/a12n included, loads
    in either package bit for bit."""
    from cice5_tpu.forcing import Forcing as JForcing
    from cice5_tpu.grid import popgrid_np as jpopgrid
    from cice5_tpu.io import history as jhist
    from cice5_tpu.io import restart as jrestart
    from cice5_tpu.state import State as JState
    from cice5_tpu_torch.io import history as thist
    from cice5_tpu_torch.io import restart as trestart
    name = "eap_mechred"
    ref = O.load_reference(name)
    m = port_model(name)
    st, f = port_inputs(ref)
    s, d = m.step(st, f)
    cfg, tr = m.cfg, m.tr
    jcfg = U.jax_config(cfg)
    jtr = jbuild(jcfg)
    fields = thist.available_fields(cfg, tr)
    jfields = jhist.available_fields(jcfg, jtr)
    assert [dataclasses.astuple(x) for x in fields] == \
        [dataclasses.astuple(x) for x in jfields]
    assert {"a11", "yieldstress12", "dardg1ndt", "vredistn"} <= \
        {x.name for x in fields}
    js, jf, jd = (U.jax_obj(JState, s), U.jax_obj(JForcing, f),
                  U.jax_diag(d))
    jgrid = jpopgrid(jcfg, *O.grid_arrays())
    got = thist.diag_to_values(d, s, m.grid, tr, f, cfg.nilyr, cfg.nslyr)
    want = jhist.diag_to_values(jd, js, jgrid, jtr, jf, cfg.nilyr,
                                cfg.nslyr)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert_close(np.asarray(want[k]), v, 1e-12, k)
    assert float(got["e11"].abs().max()) > 0.0
    info = m.calendar.info(O.ISTEP + 1, cfg.time.dt)
    ts = thist.HistoryStream(fields, freq="1", freq_n=1)
    jst = jhist.HistoryStream(jfields, freq="1", freq_n=1)
    ts.accum(got, info.time)
    jst.accum(want, info.time)
    tp = thist.write_netcdf(ts, m.grid, info, str(tmp_path / "port.nc"))
    jp = jhist.write_netcdf(jst, jgrid, info, str(tmp_path / "jax.nc"))
    U.assert_same_history_file(jp, tp)
    trestart.dump(s, str(tmp_path / "port" / "iced.a.npz"), istep=1,
                  time=3600.0)
    jrestart.dump(js, str(tmp_path / "jax" / "iced.a.npz"), istep=1,
                  time=3600.0)
    j2, _ = jrestart.restore(pointer_dir=str(tmp_path / "port"))
    t2, _ = trestart.restore(pointer_dir=str(tmp_path / "jax"),
                             device="cpu")
    for fl in dataclasses.fields(JState):
        np.testing.assert_array_equal(np.asarray(getattr(j2, fl.name)),
                                      getattr(s, fl.name).numpy())
        np.testing.assert_array_equal(getattr(t2, fl.name).numpy(),
                                      np.asarray(getattr(js, fl.name)))
    assert float((s.a11n - 0.5).abs().max()) > 0.0
