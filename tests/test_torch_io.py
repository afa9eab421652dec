"""The port's I/O modules (``cice5_tpu_torch/io/``) and boundary restoring
against the JAX package's functions on the same NumPy inputs: two steps
of the port's gx1-parity model of test_torch_parity_step.py (24x16
tripole grid, ndte=8) from its recorded warmed-up state, handed to both
packages through NumPy, in float64 and then float32.

- timers: the same report for the same totals.
- diagnostics: ``compute_diags`` within 1e-12 of each budget's scale in
  float64 (float32: 1e-5, the order of a 384-cell float32 sum),
  ``format_diags`` the same text, ``check_state`` / ``print_state`` /
  ``print_points_state`` / ``nearest_point`` the same verdicts and text.
- restart: files of either package restored by the other bit for bit,
  with the same casts; the CICE 4.1 binary files byte for byte.
- history: the catalog and the icefields mapping equal; ``diag_to_values``
  the same keys, each value within 1e-12 of its scale (float32: 2 ulp);
  two streams' averages within 1e-12 of each field's scale and their
  files within 1 float32 ulp; accumulation reads nothing to the host.
- ``write_ready(use_async=True)``: the JAX package's files, and byte for
  byte the port's files without it.
- xyt field I/O: the binary files byte for byte and every reader equal;
  the native asynchronous netCDF writer reads back bit for bit, and a
  build that fails raises.
- restoring: the edge masks and the nudged state bit for bit.
- the idealized forcing within 1e-12 of each field's scale, its snowfall
  bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from cice5_tpu_torch import convert
from cice5_tpu_torch.config import bench_easy_config
from cice5_tpu_torch.driver import graph
from cice5_tpu_torch.forcing import idealized_polar_forcing
from cice5_tpu_torch.io import diagnostics as tdiag
from cice5_tpu_torch.io import history as thist
from cice5_tpu_torch.io import restart as trestart
from cice5_tpu_torch.io import timers as ttimers
from cice5_tpu_torch.models import restoring as trestoring
from cice5_tpu_torch.parallel import Topology
from cice5_tpu_torch.small_sets import BGC_SUBSET_OFF
from cice5_tpu_torch.state import build_tracer_registry
import torch_option_sets as O
import torch_port_util as U
from torch_port_util import assert_close
from test_torch_options import check_history_and_restarts

import jax.numpy as jnp
from cice5_tpu.forcing import Forcing as JForcing
from cice5_tpu.forcing import idealized_polar_forcing as jforcing
from cice5_tpu.grid import popgrid_np as jpopgrid
from cice5_tpu.io import diagnostics as jdiag
from cice5_tpu.io import history as jhist
from cice5_tpu.io import restart as jrestart
from cice5_tpu.io import timers as jtimers
from cice5_tpu.models import restoring as jrestoring
from cice5_tpu.parallel import Topology as JTopology
from cice5_tpu.state import State as JState
from cice5_tpu.state import build_tracer_registry as jbuild


@pytest.fixture(scope="module")
def steps():
    """Two steps of the port's parity model from the recorded warmed-up
    state: [(state, forcing, diag) after each step], float64."""
    ref = U.load_parity_reference()
    m = U.port_parity_model()
    st = convert.state_from_arrays(
        {k[3:]: v for k, v in ref.items() if k.startswith("in/")},
        device="cpu")
    out = []
    for k in range(2):
        f = m.forcing_at(U.RUN_START + k)
        st, d = m.step(st, f)
        out.append((st, f, d))
    return dict(m=m, steps=out)


def _cast(obj, dtype):
    """A State, Forcing (dataclass) or StepDiag (NamedTuple) with its
    floating tensors cast, float32 subnormals flushed to zero (XLA's CPU
    backend reads them as zero; PyTorch's does not)."""
    tiny = torch.finfo(dtype).tiny

    def cast(t):
        if not t.is_floating_point():
            return t
        t = t.to(dtype)
        return torch.where(t.abs() < tiny, 0.0, t)
    if isinstance(obj, tuple):
        return type(obj)(*(cast(t) for t in obj))
    return dataclasses.replace(obj, **{
        f.name: cast(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})


@pytest.fixture(scope="module", params=["float64", "float32"])
def case(request, steps):
    """Both packages' views of the steps in one dtype: the port's grid,
    states, forcings and diags, and the JAX package's."""
    dt = request.param
    tdt = getattr(torch, dt)
    m = U.port_parity_model(dt)
    jcfg = U.jax_config(m.cfg)
    port = [tuple(_cast(x, tdt) for x in s) for s in steps["steps"]]
    jax_ = [(U.jax_obj(JState, s), U.jax_obj(JForcing, f), U.jax_diag(d))
            for s, f, d in port]
    return dict(dtype=dt, m=m, tr=m.tr, jtr=jbuild(jcfg), cfg=m.cfg,
                jcfg=jcfg, grid=m.grid,
                jgrid=jpopgrid(jcfg, *U.parity_grid_arrays()),
                port=port, jax=jax_, values={})


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------

def test_timers_report_as_the_jax_package_does():
    tt, jt = ttimers.Timers(), jtimers.Timers()
    with tt.timer("Thermo", block=torch.ones(3)):
        pass
    with tt.timer("Dynamics", block={"a": (torch.zeros(2),)}):
        pass
    for t in (tt, jt):
        for name, total, count in (("Thermo", 1.5, 3), ("Dynamics", 0.25, 2),
                                   ("Diags", 0.0, 0)):
            t.get(name).total, t.get(name).count = total, count
    assert tt.report() == jt.report()
    assert ttimers.Timers.STANDARD == jtimers.Timers.STANDARD


def test_block_until_ready_finds_every_tensor():
    s = U.port_parity_model().init_state()
    found = list(ttimers._tensors([s, {"x": torch.ones(1)}, 3]))
    assert len(found) == len(dataclasses.fields(s)) + 1
    assert ttimers.block_until_ready(s) is s


# ---------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------

def test_compute_and_format_diags_match_jax(case):
    tol = 1e-12 if case["dtype"] == "float64" else 1e-5
    for (s, _, _), (js, _, _) in zip(case["port"], case["jax"]):
        got = tdiag.compute_diags(s, case["grid"], case["tr"], 4, 1)
        ref = jdiag.compute_diags(js, case["jgrid"], case["jtr"], 4, 1)
        for name, v in got._asdict().items():
            assert v.dim() == 0 and v.dtype == s.aicen.dtype
            assert_close(np.asarray(getattr(ref, name)), v, tol, name)
        # the same text from the same numbers
        same = jdiag.GlobalDiags(*(jnp.asarray(_np(v)) for v in got))
        assert tdiag.format_diags(7, got) == jdiag.format_diags(7, same)


def _corrupt(state, name, idx, value):
    a = getattr(state, name).clone()
    a[idx] = value
    return state.replace(**{name: a})


@pytest.mark.parametrize("bad", [None, ("uvel", (5, 7), float("nan")),
                                 ("aicen", (1, 20, 3), 1.5),
                                 ("trcrn", (0, 0, 21, 5), 3.0)])
def test_check_state_matches_jax(case, bad):
    s = case["port"][1][0]
    if bad is not None:
        s = _corrupt(s, *bad)
    js = U.jax_obj(JState, s)
    tlog, jlog = [], []
    ok = tdiag.check_state(s, case["grid"], case["tr"], 4, 1, istep=3,
                           log=tlog.append)
    jok = jdiag.check_state(js, case["jgrid"], case["jtr"], 4, 1, istep=3,
                            log=jlog.append)
    assert ok == jok == (bad is None)
    assert tlog == jlog


def test_point_dumps_match_jax(case):
    s, js = case["port"][1][0], case["jax"][1][0]
    lats, lons = [85.0, -70.0, 60.0], [10.0, 200.0, -120.0]
    for lat, lon in zip(lats, lons):
        assert tdiag.nearest_point(case["grid"], lat, lon) == \
            jdiag.nearest_point(case["jgrid"], lat, lon)
    assert tdiag.print_points_state(s, case["grid"], case["tr"], 4, 1, lats,
                                    lons, label="p") == \
        jdiag.print_points_state(js, case["jgrid"], case["jtr"], 4, 1, lats,
                                 lons, label="p")


# ---------------------------------------------------------------------
# restart
# ---------------------------------------------------------------------

def _assert_same_state(a, b):
    for f in dataclasses.fields(JState):
        x, y = _np(getattr(a, f.name)), _np(getattr(b, f.name))
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_restarts_interchange_bit_for_bit(case, tmp_path):
    s, js = case["port"][1][0], case["jax"][1][0]
    trestart.dump(s, str(tmp_path / "port" / "iced.a.npz"), istep=7,
                  time=25200.0, extra={"note": "x"})
    jrestart.dump(js, str(tmp_path / "jax" / "iced.a.npz"), istep=7,
                  time=25200.0, extra={"note": "x"})
    for d in ("port", "jax"):
        with open(tmp_path / d / trestart.POINTER_NAME) as f:
            assert f.read() == str(tmp_path / d / "iced.a.npz") + "\n"
    # each package reads the other's file, through the pointer file
    js2, jmeta = jrestart.restore(pointer_dir=str(tmp_path / "port"))
    s2, meta = trestart.restore(pointer_dir=str(tmp_path / "jax"),
                                device="cpu")
    assert meta == jmeta == dict(istep=7, time=25200.0, version=1,
                                 note="x")
    _assert_same_state(js2, s)
    _assert_same_state(s2, js)
    # the same casts
    for dt in (np.float32, np.float64):
        j3, _ = jrestart.restore(str(tmp_path / "port" / "iced.a"),
                                 dtype=dt)
        t3, _ = trestart.restore(str(tmp_path / "jax" / "iced.a"),
                                 dtype=dt, device="cpu")
        _assert_same_state(j3, t3)
    t4, _ = trestart.restore(str(tmp_path / "jax" / "iced.a.npz"),
                             dtype=torch.float32, device="cpu")
    assert t4.uvel.dtype == torch.float32


def test_restore_runs_on_the_gpu_or_where_asked(tmp_path, monkeypatch):
    m = U.port_parity_model()
    path = str(tmp_path / "iced.npz")
    trestart.dump(m.init_state(), path, istep=0, time=0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trestart.restore(path)
    st, _ = trestart.restore(path, device="cpu")
    assert st.aicen.device.type == "cpu"


def test_restart_v4_files_match_jax_byte_for_byte(case, tmp_path):
    """The CICE 4.1 binary converter (tests/test_io.py TestRestartV4):
    both writers make the same bytes, both readers the same state."""
    cfg, tr = case["cfg"], case["tr"]
    s, js = case["port"][1][0], case["jax"][1][0]
    sw = {"swvdr": np.full((cfg.grid.ny, cfg.grid.nx), 11.0)}
    kw = dict(istep=2, time=7200.0, time_forc=3.5, nilyr=cfg.nilyr,
              nslyr=cfg.nslyr, tr=tr, oceanmixed=True, sw=sw)
    trestart.write_restart_v4(s, str(tmp_path / "t.v4"), **kw)
    jrestart.write_restart_v4(js, str(tmp_path / "j.v4"), **kw)
    assert (tmp_path / "t.v4").read_bytes() == \
        (tmp_path / "j.v4").read_bytes()
    got, meta = trestart.read_restart_v4(str(tmp_path / "j.v4"), cfg, tr,
                                         device="cpu")
    ref, jmeta = jrestart.read_restart_v4(str(tmp_path / "t.v4"),
                                          case["jcfg"], case["jtr"])
    _assert_same_state(ref, got)
    assert meta.keys() == jmeta.keys()
    for k, v in jmeta.items():
        np.testing.assert_array_equal(meta[k], v)
    np.testing.assert_array_equal(meta["swvdr"], sw["swvdr"])
    # what v4 carries round-trips exactly; the rest starts from zeros
    for name in ("aicen", "vicen", "vsnon", "uvel", "vvel", "stressp",
                 "stress12", "iceumask", "sst", "frzmlt"):
        assert torch.equal(getattr(got, name), getattr(s, name)), name
    got64, _ = trestart.read_restart_v4(str(tmp_path / "j.v4"), cfg, tr,
                                        dtype="float64", device="cpu")
    assert got64.aicen.dtype == torch.float64


def test_finished_file(tmp_path):
    d = str(tmp_path / "rst")
    assert not trestart.check_finished_file(d)
    p = trestart.writeout_finished_file(d)
    assert trestart.check_finished_file(d) and jrestart.check_finished_file(d)
    assert os.path.basename(p) == jrestart.FINISHED_NAME
    with open(p) as f:
        assert f.read() == "done\n"


# ---------------------------------------------------------------------
# history
# ---------------------------------------------------------------------

def _configs():
    parity = U.port_parity_model().cfg
    easy = bench_easy_config(ny=8, nx=8, ndte=2)
    # the coupled-mode options: the form-drag fields join the catalog
    coupled = parity.replace(
        coupled_radiation=True,
        forcing=dataclasses.replace(parity.forcing, formdrag=True,
                                    highfreq=True))
    return {"parity": parity, "bl99": easy, "coupled": coupled}


@pytest.mark.parametrize("name", ["parity", "bl99", "coupled"])
@pytest.mark.parametrize("include_3d", [True, False])
def test_catalog_matches_jax(name, include_3d):
    cfg = _configs()[name]
    jcfg = U.jax_config(cfg)
    got = thist.available_fields(cfg, build_tracer_registry(cfg),
                                 include_3d)
    ref = jhist.available_fields(jcfg, jbuild(jcfg), include_3d)
    assert [dataclasses.astuple(f) for f in got] == \
        [dataclasses.astuple(f) for f in ref]
    assert [dataclasses.astuple(f) for f in thist.available_fields()] == \
        [dataclasses.astuple(f) for f in jhist.available_fields()]


def test_icefields_mapping_matches_jax():
    cfg = _configs()["parity"]
    jcfg = U.jax_config(cfg)
    flags = {f"f_{f.name}": "m" for f in thist.available_fields(
        cfg, build_tracer_registry(cfg))}
    flags.update({"f_tmask": "m", "f_PPnet": "m", "f_aero": "m",
                  "f_Cdn_atm": "md", "f_aicen": ["x", "x"], "f_hi": "'x'",
                  "made_up": "d", "F_AICE": "h"})
    got, tun = thist.fields_for_icefields(flags, cfg,
                                          build_tracer_registry(cfg))
    ref, jun = jhist.fields_for_icefields(flags, jcfg, jbuild(jcfg))
    assert [f.name for f in got] == [f.name for f in ref]
    assert tun == jun and "f_made_up" in tun and "f_aero" in tun


@pytest.mark.parametrize("what", ["tr_aero", "tr_brine", "skl_bgc",
                                  "skl_bgc_subset", "gx1_bgc"])
def test_catalog_of_the_tracer_options_matches_jax(what):
    """The aerosol, brine (with the 3Db bio-grid structure) and
    skeletal-BGC fields, alone and together on the gx1-parity physics:
    the JAX package's catalog and icefields mapping."""
    cfg = bench_easy_config(ny=8, nx=8, ndte=2)
    r = dataclasses.replace
    parity = _configs()["parity"]
    cfg = {"tr_aero": cfg.replace(tracers=r(cfg.tracers, tr_aero=True,
                                            n_aero=3)),
           "tr_brine": cfg.replace(tracers=r(cfg.tracers, tr_brine=True)),
           "skl_bgc": cfg.replace(tracers=r(cfg.tracers, skl_bgc=True)),
           "skl_bgc_subset": cfg.replace(tracers=r(
               cfg.tracers, skl_bgc=True, bgc_flux_type="constant",
               **BGC_SUBSET_OFF)),
           "gx1_bgc": parity.replace(tracers=r(
               parity.tracers, tr_aero=True, n_aero=3, tr_brine=True,
               skl_bgc=True))}[what]
    jcfg = U.jax_config(cfg)
    tr, jtr = build_tracer_registry(cfg), jbuild(jcfg)
    for inc in (True, False):
        got = thist.available_fields(cfg, tr, inc)
        ref = jhist.available_fields(jcfg, jtr, inc)
        assert [dataclasses.astuple(f) for f in got] == \
            [dataclasses.astuple(f) for f in ref]
    names = {f.name for f in thist.available_fields(cfg, tr)}
    assert {"aerosnossl001", "faero_ocn003", "aeroicen002"} <= names \
        if cfg.tracers.tr_aero else True
    # PP_net and grow_net ride with the brine fields (the JAX catalog's
    # BGC_FIELDS)
    assert {"fbri", "hbri", "bTizn", "bphizn", "PP_net"} <= names \
        if cfg.tracers.tr_brine else True
    assert {"bgc_N_sk", "fN_ai"} <= names if cfg.tracers.skl_bgc else True
    flags = {"f_aero": "m", "f_aeron": "d", "f_faero_ocn": "m",
             "f_PPnet": "m", "f_bTin": "m", "f_fNO": "d", "f_hbri": "m"}
    got, tun = thist.fields_for_icefields(flags, cfg, tr)
    ref, jun = jhist.fields_for_icefields(flags, jcfg, jtr)
    assert [f.name for f in got] == [f.name for f in ref] and tun == jun


@pytest.mark.parametrize("name", O.TRACER_SETS)
def test_tracer_history_and_restarts_interchange(name, tmp_path):
    """A step of each tracer set: the catalog, diag_to_values (the
    aerosol, BGC and brine values of ``_bgc_aero_values``, 1e-12 of each
    field's scale) and the history file equal the JAX package's; an npz
    restart with the tracers and first_ice loads in either package bit
    for bit; the bio-grid (3Db) fields read back from the port's file
    as they were accumulated, on the nkbio axis of nilyr+2 levels."""
    from scipy.io import netcdf_file
    path, got = check_history_and_restarts(name, tmp_path)
    cfg = O.option_sets()[name]
    with netcdf_file(path, "r", mmap=False) as f:
        names = set(f.variables)
        if cfg.tracers.tr_brine:
            assert f.dimensions["nkbio"] == cfg.nilyr + 2
            for k in ("bTizn", "bphizn"):
                v = f.variables[k]
                assert v.dimensions == ("time", "nkbio", "nj", "ni")
                np.testing.assert_array_equal(
                    v[0], got[k].numpy().astype(np.float32))
    if cfg.tracers.tr_aero:
        assert {"faero_ocn001", "aerosnon001"} <= names
    if cfg.tracers.skl_bgc:
        assert {"bgc_N_sk", "fN"} <= names
    if cfg.tracers.skl_bgc and cfg.tracers.tr_brine:
        assert {"PP_net", "grow_net"} <= names


@pytest.mark.parametrize("what", ["diag_mechred", "kdyn"])
def test_catalog_of_the_dynamics_options_matches_jax(what):
    """The per-category mechred fields (diag_mechred with the level-ice
    tracers) and the EAP fields (kdyn=2): the JAX package's catalog."""
    cfg = bench_easy_config(ny=8, nx=8, ndte=2)
    r = dataclasses.replace
    cfg = {"diag_mechred": cfg.replace(dyn=r(cfg.dyn, diag_mechred=True),
                                       tracers=r(cfg.tracers, tr_lvl=True)),
           "kdyn": cfg.replace(dyn=r(cfg.dyn, kdyn=2))}[what]
    jcfg = U.jax_config(cfg)
    got = thist.available_fields(cfg, build_tracer_registry(cfg))
    ref = jhist.available_fields(jcfg, jbuild(jcfg))
    assert [dataclasses.astuple(f) for f in got] == \
        [dataclasses.astuple(f) for f in ref]
    names = {f.name for f in got}
    assert ({"dardg1ndt", "vredistn"} if what == "diag_mechred"
            else {"a11", "yieldstress22"}) <= names


def _port_values(case, k):
    s, f, d = case["port"][k]
    return thist.diag_to_values(d, s, case["grid"], case["tr"], f, 4, 1)


def _values(case, k):
    """(port, JAX) diag_to_values of step k."""
    if k not in case["values"]:
        js, jf, jd = case["jax"][k]
        case["values"][k] = (_port_values(case, k), jhist.diag_to_values(
            jd, js, case["jgrid"], case["jtr"], jf, 4, 1))
    return case["values"][k]


def test_diag_to_values_matches_jax(case):
    """The same keys (the EAP and BGC ones as the JAX step fills them:
    zeros under EVP without BGC), each value on its own scale."""
    got, ref = _values(case, 1)
    assert sorted(got) == sorted(ref)
    f64 = case["dtype"] == "float64"
    for name, v in got.items():
        r = np.asarray(ref[name])
        assert v.dtype == case["port"][1][0].aicen.dtype, name
        if f64:
            assert_close(r, v, 1e-12, name)
        else:
            ulp = float(np.spacing(np.float32(np.abs(r).max(initial=0.0))))
            assert np.abs(r - _np(v)).max(initial=0.0) <= 2 * ulp, name
    assert not got["e11"].any() and not got["PP_net"].any()


def _streams(fields, jfields):
    mk = lambda mod, fl: mod.HistoryStreams([
        mod.HistoryStream(fl[:20], freq="1", freq_n=1, suffix="inst"),
        mod.HistoryStream(fl, freq="1", freq_n=2, suffix="all")])
    return mk(thist, fields), mk(jhist, jfields)


def test_history_streams_match_jax(case, tmp_path):
    """Two streams of the two steps' values: the averages within 1e-12 of
    each field's scale (float32: 1e-6), then files within 1 float32 ulp
    of each variable's scale, the same variables, dimensions, units and
    long names."""
    ts, js = _streams(thist.available_fields(case["cfg"], case["tr"]),
                      jhist.available_fields(case["jcfg"], case["jtr"]))
    cal = case["m"].calendar
    tol = 1e-12 if case["dtype"] == "float64" else 1e-6
    for k in range(2):
        got, ref = _values(case, k)
        info = cal.info(U.RUN_START + k + 1, case["cfg"].time.dt)
        ts.accum(got, info.time)
        js.accum(ref, info.time)
        for t, j in zip(ts.streams, js.streams):
            assert t.nsamples == j.nsamples and t.ready(info) == j.ready(info)
            for dims, fl in t.groups.items():
                a, b = j.averages(dims), t.averages(dims)
                for i, f in enumerate(fl):
                    assert_close(a[i], b[i], tol, f.name)
        tp = ts.write_ready(case["grid"], info, str(tmp_path / "port"))
        jp = js.write_ready(case["jgrid"], info, str(tmp_path / "jax"))
        assert [os.path.basename(p) for p in tp] == \
            [os.path.basename(p) for p in jp]
        assert len(tp) == (1 if k == 0 else 2)
        for a, b in zip(jp, tp):
            U.assert_same_history_file(a, b)
    assert all(s.nsamples == 0 for s in ts.streams)


def test_accumulation_reads_nothing_back(case):
    """After the first accumulation a step's accum makes no tensor from
    host data and reads nothing from the device."""
    s = thist.HistoryStream(thist.available_fields(case["cfg"], case["tr"]))
    got = _port_values(case, 0)
    s.accum(got, 0.0)
    s.accum(got, 1.0)
    with graph.HostSyncs() as hs:
        s.accum(got, 2.0)
        _port_values(case, 1)
    assert hs.syncs == 0 and hs.host_made == 0


@pytest.mark.parametrize("name", O.TRACER_SETS)
def test_tracer_history_values_read_nothing_back(name):
    """diag_to_values of a tracer step (``_bgc_aero_values``, the
    bio-grid remaps of compute_microS_mushy) makes no tensor from host
    data and reads nothing from the device, so Model.run's history
    accumulation waits on no replay."""
    from test_torch_options import port_inputs, port_model
    m = port_model(name)
    st, f = port_inputs(O.load_reference(name))
    s, d = m.step(st, f)
    with graph.HostSyncs() as hs:
        thist.diag_to_values(d, s, m.grid, m.tr, f, m.cfg.nilyr,
                             m.cfg.nslyr)
    assert hs.syncs == 0 and hs.host_made == 0


def test_history_errors():
    s = thist.HistoryStream(thist.CAT_FIELDS[:1] + thist.STANDARD_FIELDS[:2])
    with pytest.raises(KeyError, match="3Dc"):
        s.accum({"aice": torch.zeros(2, 2)}, 0.0)
    s.accum({"aice": torch.ones(2, 2), "aicen": torch.ones(3, 2, 2)}, 0.0)
    assert float(s.averages("2D")[1].max()) == 0.0    # hi: missing, 0
    with pytest.raises(ValueError, match="freq"):
        thist.HistoryStream([], freq="w")
    with pytest.raises(ValueError, match="at most"):
        thist.HistoryStreams([s] * 6)


def test_write_ready_async_writes_the_jax_files(case, tmp_path):
    """``use_async=True``, which both packages accept: the port writes the
    files the JAX package writes with it (within 1 float32 ulp of each
    variable's scale, the same variables, dimensions, units and long
    names), byte for byte the files it writes without it."""
    fields = thist.available_fields(case["cfg"], case["tr"])
    ts, js = _streams(fields, jhist.available_fields(case["jcfg"],
                                                     case["jtr"]))
    sync, _ = _streams(fields, [])
    cal = case["m"].calendar
    for k in range(2):
        got, ref = _values(case, k)
        info = cal.info(U.RUN_START + k + 1, case["cfg"].time.dt)
        for streams, v in ((ts, got), (sync, got), (js, ref)):
            streams.accum(v, info.time)
        tp = ts.write_ready(case["grid"], info, str(tmp_path / "port"),
                            use_async=True)
        sp = sync.write_ready(case["grid"], info, str(tmp_path / "sync"))
        jp = js.write_ready(case["jgrid"], info, str(tmp_path / "jax"),
                            use_async=True)
        assert [os.path.basename(p) for p in tp] == \
            [os.path.basename(p) for p in jp] == \
            [os.path.basename(p) for p in sp]
        assert len(tp) == (1 if k == 0 else 2)
        for a, b, c in zip(jp, tp, sp):
            U.assert_same_history_file(a, b)
            with open(b, "rb") as fb, open(c, "rb") as fc:
                assert fb.read() == fc.read()


# ---------------------------------------------------------------------
# xyt field I/O and the native netCDF writer
# ---------------------------------------------------------------------

@pytest.mark.parametrize("atype", ["rda8", "rda4", "ida4"])
def test_xyt_files_and_reads_match_jax(tmp_path, atype):
    """write_xyt byte for byte (one record, a sequence, appended), and
    every reader (xyt with an offset and a count, xyzt, global, ext)
    equal to the JAX package's on the same file."""
    from cice5_tpu.io import xyt as jxyt
    from cice5_tpu_torch.io import xyt as txyt
    rng = np.random.default_rng(21)
    ny, nx, nz = 6, 8, 3
    recs = [rng.uniform(-50.0, 50.0, (ny, nx)) for _ in range(2 * nz)]
    t, j = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    txyt.write_xyt(t, torch.from_numpy(recs[0]), atype=atype)
    txyt.write_xyt(t, [torch.from_numpy(r) for r in recs[1:]],
                   atype=atype, append=True)
    jxyt.write_xyt(j, jnp.asarray(recs[0]), atype=atype)
    jxyt.write_xyt(j, [jnp.asarray(r) for r in recs[1:]], atype=atype,
                   append=True)
    with open(t, "rb") as ft, open(j, "rb") as fj:
        assert ft.read() == fj.read()
    for fn, args, kw in (("read_xyt", (nx, ny, 2), {}),
                         ("read_xyt", (nx, ny, 3), {"count": 2}),
                         ("read_xyzt", (nx, ny, nz, 2), {}),
                         ("read_global", (nx, ny, 6), {}),
                         ("read_ext", (nx - 2, ny - 2, 4), {})):
        a = getattr(jxyt, fn)(j, *args, atype=atype, **kw)
        b = getattr(txyt, fn)(t, *args, atype=atype, **kw)
        assert a.dtype == b.dtype, fn
        np.testing.assert_array_equal(a, b, fn)
    with pytest.raises(EOFError, match="t.bin"):
        txyt.read_xyt(t, nx, ny, 6, atype=atype, count=2)


def test_xyt_netcdf_matches_jax(tmp_path):
    from cice5_tpu.io import xyt as jxyt
    from cice5_tpu_torch.io import xyt as txyt
    rng = np.random.default_rng(22)
    f = {"aice": rng.uniform(size=(6, 8)), "hi": rng.uniform(size=(6, 8))}
    attrs = {"aice": {"units": "1", "long_name": "ice area"}}
    t, j = str(tmp_path / "t.nc"), str(tmp_path / "j.nc")
    txyt.write_xyt_nc(t, {k: torch.from_numpy(v) for k, v in f.items()},
                      attrs=attrs)
    jxyt.write_xyt_nc(j, {k: jnp.asarray(v) for k, v in f.items()},
                      attrs=attrs)
    with open(t, "rb") as ft, open(j, "rb") as fj:
        assert ft.read() == fj.read()
    for name in f:
        np.testing.assert_array_equal(jxyt.read_xyt_nc(j, name),
                                      txyt.read_xyt_nc(t, name))
    path = str(tmp_path / "recs.nc")
    from scipy.io import netcdf_file
    with netcdf_file(path, "w") as nc:
        nc.createDimension("time", 3)
        nc.createDimension("nj", 6)
        nc.createDimension("ni", 8)
        nc.createVariable("Tair", "d", ("time", "nj", "ni"))[:] = \
            rng.uniform(size=(3, 6, 8))
    for nrec in (None, 1, 3):
        np.testing.assert_array_equal(jxyt.read_xyt_nc(path, "Tair", nrec),
                                      txyt.read_xyt_nc(path, "Tair", nrec))


def test_native_writer_roundtrip(tmp_path):
    """Records appended from host arrays and tensors read back bit for
    bit, with their times; pending() counts the records not yet written,
    and is 0 after flush()."""
    from scipy.io import netcdf_file
    from cice5_tpu_torch.io.fastwriter import AsyncNetcdfWriter
    path = str(tmp_path / "async.nc")
    ny, nx = 5, 7
    rng = np.random.default_rng(3)
    recs = []
    with AsyncNetcdfWriter(path, ny, nx, ["aice", "hi", "hs"]) as w:
        for t in range(6):
            f = {k: rng.random((ny, nx)).astype(np.float32)
                 for k in ("aice", "hi", "hs")}
            recs.append((t * 3600.0, f))
            w.append(t * 3600.0, {k: torch.from_numpy(v) if t % 2 else v
                                  for k, v in f.items()})
            assert 0 <= w.pending() <= t + 1
        w.flush()
        assert w.pending() == 0
    with pytest.raises(ValueError, match="closed"):
        w.append(0.0, recs[0][1])
    with netcdf_file(path, "r", mmap=False) as f:
        np.testing.assert_array_equal(np.array(f.variables["time"][:]),
                                      [r[0] for r in recs])
        for name in ("aice", "hi", "hs"):
            arr = np.array(f.variables[name][:])
            for k, (_, fields) in enumerate(recs):
                np.testing.assert_array_equal(arr[k], fields[name], name)


def test_native_writer_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's output; no writer
    falls back to a synchronous one."""
    from cice5_tpu_torch.io import fastwriter
    bad = tmp_path / "ncwriter.cpp"
    bad.write_text("int ncw_create( {\n")
    monkeypatch.setattr(fastwriter, "SOURCE", bad)
    monkeypatch.setattr(fastwriter, "_LIB", None)
    monkeypatch.setenv("CICE5_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*ncwriter.cpp"):
        fastwriter.AsyncNetcdfWriter(str(tmp_path / "x.nc"), 2, 2, ["a"])
    assert not (tmp_path / "x.nc").exists()
    assert list((tmp_path / "build").iterdir()) == []


# ---------------------------------------------------------------------
# restoring and forcing
# ---------------------------------------------------------------------

@pytest.mark.parametrize("ew,ns", [("open", "open"), ("cyclic", "open"),
                                   ("cyclic", "tripole"), ("open", "cyclic"),
                                   ("cyclic", "tripoleT")])
def test_edge_mask_matches_jax(ew, ns):
    got = trestoring.edge_mask((5, 8), Topology(ew=ew, ns=ns),
                               torch.float64)
    ref = jrestoring.edge_mask((5, 8), JTopology(ew=ew, ns=ns), jnp.float64)
    np.testing.assert_array_equal(np.asarray(ref), _np(got))


@pytest.mark.parametrize("trestore", [0, 1, 0.01])
def test_restore_ice_matches_jax(case, trestore):
    s, js = case["port"][1][0], case["jax"][1][0]
    rest, jrest = case["port"][0][0], case["jax"][0][0]
    topo = Topology(ew="open", ns="open")
    got = trestoring.restore_ice(3600.0, trestore, s, rest, topo)
    ref = jrestoring.restore_ice(3600.0, trestore, js, jrest,
                                 JTopology(ew="open", ns="open"))
    _assert_same_state(ref, got)
    mask = trestoring.edge_mask(s.aicen.shape[-2:], topo, s.aicen.dtype)
    again = trestoring.restore_ice(3600.0, trestore, s, rest, topo, mask)
    _assert_same_state(got, again)


def test_idealized_forcing_matches_jax():
    """The port's forcing against the JAX package's on the parity grid in
    float64: every field within 1e-12 of its scale, the snowfall bit for
    bit (it once rounded 3e-6 through float32)."""
    m = U.port_parity_model()
    jcfg = U.jax_config(m.cfg)
    jgrid = jpopgrid(jcfg, *U.parity_grid_arrays())
    info = m.calendar.info(U.RUN_START, m.cfg.time.dt)
    got = idealized_polar_forcing(
        m.grid.shape, info.yday, dtype=torch.float64, tlat=m.grid.TLAT,
        tlon=m.grid.TLON, orb=m.orb, device="cpu")
    ref = jforcing(jgrid.shape, info.yday, dtype=jnp.float64,
                   tlat=jgrid.TLAT, tlon=jgrid.TLON, orb=m.orb)
    for f in dataclasses.fields(ref):
        r = getattr(ref, f.name)
        if r is not None:
            assert_close(np.asarray(r), getattr(got, f.name), 1e-12, f.name)
    assert float(ref.fsnow.max()) == 3e-6
    np.testing.assert_array_equal(np.asarray(ref.fsnow), _np(got.fsnow))
