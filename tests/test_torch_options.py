"""The column options and standalone configurations of the port, each on
its own, against the JAX package's step in float64 on the CPU.

The sets (tests/torch_option_sets.py): gx3's physics on a displaced-pole
grid with an open north, tp1's on a tripole seam, BL99 + CCSM3 on a
tripole seam, mushy without dEdd, dEdd without ponds, each of iage, FY
and lvl alone, CESM and topographic ponds under BL99 and mushy thermo,
the CESM refreezing of level ponds, zero-layer thermo, and the coupler's
surface fluxes (calc_Tsfc=False) under BL99 and under mushy thermo, which
solves its own surface and ignores them (ice_therm_vertical.F90:316-343,
tests/test_calc_tsfc_off.py:104): the port copies that. And the
dynamics and transport options (``O.DYN_SETS``): the T-fold seam, EAP
alone, on the T-fold and with the mechred diagnostics, upwind transport,
the transport checks, dynamics without transport (their extra outputs:
tests/test_torch_dyn_options.py); and the tracer sets (``O.TRACER_SETS``):
aerosols, brine + skeletal BGC under mushy thermo, the constant piston
velocity with a subset of the BGC tracers, every auxiliary tracer at
once on a U-fold, with first_ice and the aerosol and BGC fluxes, primary
production and algal growth compared too, and each reference shown to
have its tracers at work; and CESM2's column (``O.LAYER_SETS``: the
gx1-parity physics with 8 ice and 3 snow layers, under mushy and under
BL99 thermo), the first sets with several snow layers; and the namelist
options no other set turns on (``O.FLAG_SETS``), each the BL99 model
with one option changed, whose references are shown to move from their
base set's in a field the option drives.

Each runs two steps of the port's ``Model`` on the 24x16 mesh, ndte=8,
from the state the JAX package warmed up by one step, with rain on the
ice; the JAX steps are recorded in test_torch_options.npz under a hash
of their inputs (``test_recorded_reference_matches_its_inputs``; a test
marked slow recomputes them). Tolerances as in test_torch_parity_step.py:
state and diagnostics 3e-8 x scale, the stress state and stress
divergence 1e-5 x scale; tracers as conserved amounts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch import convert
from cice5_tpu_torch.driver.model import Model, check_supported
from cice5_tpu_torch.grid import popgrid_np
from cice5_tpu_torch.models.thermo.itd import tracer_weights
from cice5_tpu_torch.state import build_tracer_registry
import torch_option_sets as O
from torch_port_util import assert_close

SETS = sorted(O.option_sets())
DIAG = tuple(k for k in O.DIAG if k not in O.DIAG_EVP + O.DIAG_FLAGS)


def port_model(name, device="cpu", dtype="float64"):
    cfg = O.option_sets()[name]
    if dtype != "float64":
        cfg = cfg.replace(dtype=dtype, accum_dtype=dtype)
    grid = popgrid_np(cfg, *O.grid_arrays(), device="cpu")
    return Model(cfg, grid=grid, device=device)


def port_inputs(ref, device="cpu", dtype=None):
    st = convert.state_from_arrays(O.part(ref, "in"), device=device,
                                   dtype=dtype)
    f = convert.forcing_from_arrays(O.part(ref, "forcing"), device=device,
                                    dtype=dtype)
    return st, f


_RUNS = {}


def run(name):
    """The port's two steps of set ``name`` from the recorded warmed-up
    state (cached per set)."""
    if name not in _RUNS:
        ref = O.load_reference(name)
        m = port_model(name)
        st, f = port_inputs(ref)
        s2, d2 = m.rollout(st, f, O.NSTEPS)
        _RUNS[name] = dict(ref=ref, m=m, s2=s2, tn2=convert.to_numpy(s2),
                           td2=convert.to_numpy(d2))
    return _RUNS[name]


@pytest.mark.parametrize("name", SETS)
def test_set_is_accepted(name):
    check_supported(O.option_sets()[name])


@pytest.mark.parametrize("name", SETS)
def test_state_after_two_steps_matches(name):
    r = run(name)
    js = O.part(r["ref"], "out")
    for k in O.STATE:
        assert_close(js[k], r["tn2"][k], 3e-8, f"{name}: {k}", floor=1.0)


@pytest.mark.parametrize("name", SETS)
def test_tracers_after_two_steps_match(name):
    """Every tracer of trcrn as its conserved amount, each on its own
    scale."""
    r = run(name)
    tr = r["m"].tr
    js = O.part(r["ref"], "out")
    t = lambda k: torch.as_tensor(js[k])
    w_ref = tracer_weights(tr, t("aicen"), t("vicen"), t("vsnon"),
                           t("trcrn")) * t("trcrn")
    s = r["s2"]
    w_got = tracer_weights(tr, s.aicen, s.vicen, s.vsnon, s.trcrn) * s.trcrn
    for it in range(tr.ntrcr):
        assert_close(w_ref[:, it], w_got[:, it], 3e-8,
                     f"{name}: trcrn[{it}]", floor=1e-6)


@pytest.mark.parametrize("name", SETS)
def test_stress_after_two_steps_matches(name):
    r = run(name)
    js = O.part(r["ref"], "out")
    for k in O.STRESS:
        assert_close(js[k], r["tn2"][k], 1e-5, f"{name}: {k}", floor=1.0)


@pytest.mark.parametrize("name", SETS)
def test_diag_of_last_step_matches(name):
    r = run(name)
    jd = O.part(r["ref"], "diag")
    for k in DIAG:
        assert_close(jd[k], r["td2"][k], 3e-8, f"{name}: {k}", floor=1.0)
    for k in O.DIAG_EVP:
        assert_close(jd[k], r["td2"][k], 1e-5, f"{name}: {k}", floor=1.0)
    assert int(jd["state_bad"]) == int(r["td2"]["state_bad"]) == 0
    assert bool(jd["therm_converged"]) and bool(r["td2"]["therm_converged"])


@pytest.mark.parametrize("name", O.TRACER_SETS)
def test_tracer_outputs_after_two_steps_match(name):
    """The first-ice flags bit for bit, and the aerosol and BGC fluxes to
    the ocean, the net primary production and the algal growth of the
    last step, each on its own scale."""
    r = run(name)
    js, jd = O.part(r["ref"], "out"), O.part(r["ref"], "diag")
    for k in O.TRACER_STATE:
        np.testing.assert_array_equal(js[k], r["tn2"][k], err_msg=k)
    for k in O.TRACER_DIAG:
        assert_close(jd[k], r["td2"][k], 3e-8, f"{name}: {k}")


@pytest.mark.parametrize("name", O.TRACER_SETS)
def test_tracer_reference_shows_its_tracers_at_work(name):
    """A set whose tracers sit at rest holds nothing: in the recorded JAX
    reference itself, aerosol reaches the ocean, the lit ice has net
    primary production, and the brine height has moved off the ice
    thickness somewhere."""
    ref = O.load_reference(name)
    cfg = O.option_sets()[name]
    tr = build_tracer_registry(cfg)
    jd, js = O.part(ref, "diag"), O.part(ref, "out")
    tc = cfg.tracers
    assert jd["faero_ocn"].shape[0] == (tc.n_aero if tc.tr_aero else 0)
    assert jd["flux_bio"].shape[0] == tr.nbtrcr
    if tc.tr_aero:
        assert np.abs(jd["faero_ocn"]).max() > 0.0
    if tc.skl_bgc:
        assert jd["PP_net"].max() > 0.0 and jd["grow_net"].max() > 0.0
        assert np.abs(jd["flux_bio"]).max() > 0.0
    if tc.tr_brine:
        fbri = js["trcrn"][:, tr.nt_fbri][js["aicen"] > ct.puny]
        assert np.abs(fbri - 1.0).max() > 1e-4
    if tc.tr_brine or tc.skl_bgc:
        assert set(np.unique(js["first_ice"])) == {0.0, 1.0}


@pytest.mark.parametrize("name", sorted(O.FLAG_BASE))
def test_flag_reference_shows_its_option_at_work(name):
    """A namelist option that moves nothing holds nothing: in the recorded
    JAX references, the set's fields that its option drives
    (``O.FLAG_DRIVES``) differ from its base set's by more than the
    comparison tolerance in at least one of them."""
    ref, base = O.load_reference(name), O.load_reference(O.FLAG_BASE[name])
    moved = {}
    for k in O.FLAG_DRIVES[name]:
        a, b = ref[k].astype(float), base[k].astype(float)
        tol = 1e-5 if k.split("/")[1] in O.STRESS + O.DIAG_EVP else 3e-8
        moved[k] = float(np.abs(a - b).max()) / max(
            float(np.abs(a).max()), 1.0) / tol
    assert max(moved.values()) > 1.0, moved


@pytest.mark.parametrize("name", SETS)
def test_set_exercises_its_option(name):
    """Each set's option is live in its run: ponds hold water, the ages
    and first-year area are set, the lids and zero-layer enthalpies are
    what they should be, and the ice moves."""
    r = run(name)
    cfg, tr, s = r["m"].cfg, r["m"].tr, r["s2"]
    assert float(s.aicen.sum(0).max()) > 0.5
    assert float(np.abs(r["tn2"]["uvel"]).max()) > 0.0
    has = s.aicen > 1e-3
    if tr.nt_apnd >= 0:
        vol = s.trcrn[:, tr.nt_apnd] * s.trcrn[:, tr.nt_hpnd] * s.aicen
        assert float(vol.max()) > 1e-4
    if tr.nt_iage >= 0:
        assert float(s.trcrn[:, tr.nt_iage].max()) > 1e6
    if tr.nt_FY >= 0:
        assert float(s.trcrn[:, tr.nt_FY][has].max()) > 0.5
    if cfg.thermo.ktherm == 0:
        latent = ct.rhoi * ct.Lfresh
        q = s.trcrn[:, tr.nt_qice:tr.nt_qice + cfg.nilyr].movedim(1, 0)
        assert float((q[:, has] + latent).abs().max()) <= 1e-9 * latent
    if cfg.tracers.tr_pond_topo:
        assert float(s.trcrn[:, tr.nt_ipnd].max()) > 0.0


def test_mushy_ignores_the_coupler_fluxes():
    """Under mushy thermo the coupler's surface fluxes change nothing: the
    calc_Tsfc=False step equals the calc_Tsfc=True one bit for bit (the
    reference's mushy solver has no prescribed-flux variant), while under
    BL99 they set the surface (and the state) apart."""
    for name, same in (("calc_tsfc_off_mushy", True),
                       ("calc_tsfc_off_bl99", False)):
        ref = O.load_reference(name)
        m_off = port_model(name)
        cfg_on = m_off.cfg.replace(thermo=dataclasses.replace(
            m_off.cfg.thermo, calc_Tsfc=True))
        m_on = Model(cfg_on, grid=m_off.grid, device="cpu")
        st, f = port_inputs(ref)
        s_off, _ = m_off.step(st, f)
        s_on, _ = m_on.step(st, f)
        eq = torch.equal(s_off.trcrn, s_on.trcrn) and torch.equal(
            s_off.vicen, s_on.vicen)
        assert eq == same, name


def test_calc_tsfc_off_needs_the_coupler_fluxes():
    ref = O.load_reference("calc_tsfc_off_bl99")
    m = port_model("calc_tsfc_off_bl99")
    st, f = port_inputs(ref)
    with pytest.raises(ValueError, match="fsurfn_f"):
        m.step(st, f.replace(fsurfn_f=None))


def test_coupled_model_takes_the_coupler_fluxes():
    """calc_Tsfc=False through ``CoupledModel``: the atmosphere sends the
    per-category surface fluxes as NumPy arrays (ncat, ny, nx) with its
    other fields; two coupled steps equal the JAX steps on the same
    forcing. A model that solves its own surface refuses them."""
    from cice5_tpu_torch.driver.coupled import CAT_FIELDS, CoupledModel
    name = "calc_tsfc_off_bl99"
    ref = O.load_reference(name)
    m = port_model(name)
    st, f = port_inputs(ref)
    base = f.replace(**{k: None for k in CAT_FIELDS})
    m.forcing_provider = lambda istep, info: base
    sent = {k: O.part(ref, "forcing")[k] for k in CAT_FIELDS}
    cm = CoupledModel(model=m, get_atm=lambda t: sent)
    s2, _ = cm.run(st, O.NSTEPS)
    js = O.part(ref, "out")
    for k in O.STATE:
        assert_close(js[k], getattr(s2, k), 3e-8, k, floor=1.0)
    on = port_model("bl99_ccsm3_tripole")
    with pytest.raises(KeyError, match="fsurfn_f"):
        CoupledModel(model=on).from_atm(sent)


@pytest.mark.parametrize("name", ["cesm_ponds_bl99", "topo_ponds_mushy",
                                  "frzpnd_cesm", "zerolayer"])
def test_history_and_restarts_interchange(name, tmp_path):
    """The pond fields of each scheme and the zero-layer columns in the
    history and restart files: the port's catalog, its diag_to_values of
    a step and the history file written from them equal the JAX
    package's on the same state, diagnostics and forcing (values 1e-12 of
    each field's scale, the file to 1 float32 ulp); an npz restart of
    either package loads in the other bit for bit."""
    check_history_and_restarts(name, tmp_path)


def check_history_and_restarts(name, tmp_path):
    """The body of test_history_and_restarts_interchange for set
    ``name``; returns the port's history file and values of the step."""
    import os
    from cice5_tpu.forcing import Forcing as JForcing
    from cice5_tpu.grid import popgrid_np as jpopgrid
    from cice5_tpu.io import history as jhist
    from cice5_tpu.io import restart as jrestart
    from cice5_tpu.state import State as JState
    from cice5_tpu.state import build_tracer_registry as jbuild
    from cice5_tpu_torch.io import history as thist
    from cice5_tpu_torch.io import restart as trestart
    import torch_port_util as U
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
    names = {x.name for x in fields}
    if tr.nt_apnd >= 0:
        assert {"apond", "hpond", "apondn", "hpondn"} <= names
    js, jf, jd = (U.jax_obj(JState, s), U.jax_obj(JForcing, f),
                  U.jax_diag(d))
    jgrid = jpopgrid(jcfg, *O.grid_arrays())
    got = thist.diag_to_values(d, s, m.grid, tr, f, cfg.nilyr, cfg.nslyr)
    want = jhist.diag_to_values(jd, js, jgrid, jtr, jf, cfg.nilyr,
                                cfg.nslyr)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert_close(np.asarray(want[k]), v, 1e-12, k)
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
        a = np.asarray(getattr(j2, fl.name))
        np.testing.assert_array_equal(a, getattr(s, fl.name).numpy())
        np.testing.assert_array_equal(getattr(t2, fl.name).numpy(),
                                      np.asarray(getattr(js, fl.name)))
    assert os.path.exists(tp)
    return tp, got


@pytest.mark.parametrize("name", SETS)
def test_recorded_reference_matches_its_inputs(name):
    """The reference of each set was recorded from the JAX package,
    configuration, grid and recipe as they stand; after a change to any
    of them, rewrite it (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
    tests/torch_option_sets.py NAME) and run the slow test below."""
    assert str(O.load_reference(name)["key"]) == O.reference_key(name), (
        f"{name} in tests/test_torch_options.npz is stale")


@pytest.mark.slow
@pytest.mark.parametrize("name", SETS)
def test_recorded_reference_is_current(name):
    """The recorded reference is what the JAX package computes now."""
    new = O.record(name)
    old = O.load_reference(name)
    old.pop("key")
    assert sorted(new) == sorted(old)
    for k, a in new.items():
        assert_close(a, old[k], 1e-12, f"{name}: {k}", floor=1.0)
