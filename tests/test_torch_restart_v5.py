"""The port's CICE 5 restart interchange (``cice5_tpu_torch/io/
restart_v5.py``) against the JAX package's (``cice5_tpu/io/restart_v5.py``)
on the same State, made from a seed with NumPy (every tracer set of the
dump: iage, FY, lvl, level ponds, two aerosol species, brine, the
skeletal BGC; EVP and EAP; float64):

- the files the port writes equal the JAX package's byte for byte: the
  binary core dump and its supplemental files with and without coszen
  and the slab ocean's records, with ``restart_ext`` ghost rings (edge
  replication, and the halo image on open, cyclic, U-fold and T-fold
  seams), and the netCDF flavour;
- each package reads the other's dump to an equal State and meta, and
  the JAX reader's float32 cast equals the port's;
- a core dump whose record count is not the base plus 0..3, a dump read
  as oceanmixed without the slab-ocean records, and a tracer file that
  ends early raise;
- a dump of the gx1-parity model (24x16) after one step restored into a
  fresh Model continues bit for bit;
- at CESM2's 8 ice and 3 snow layers the dump carries sice001..008,
  qice001..008 and qsno001..003, its bytes equal the JAX package's, both
  read it back bit for bit, and a dump of the ``cesm2_layers`` set's
  model continues bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from cice5_tpu_torch import convert
from cice5_tpu_torch.config import rect_config
from cice5_tpu_torch.io import restart_v5 as T
from cice5_tpu_torch.parallel import Topology
from cice5_tpu_torch.state import State, build_tracer_registry, zeros_state
import torch_port_util as U

from cice5_tpu.io import restart_v5 as J
from cice5_tpu.parallel import Topology as JTopology
from cice5_tpu.state import State as JState
from cice5_tpu.state import build_tracer_registry as jbuild

NY, NX = 12, 16
CORE = "iced.1997-01-02-00000"


def _cfg(kdyn=1, dtype="float64", nilyr=7, nslyr=1):
    cfg = rect_config(ny=NY, nx=NX).replace(nilyr=nilyr, nslyr=nslyr)
    return cfg.replace(
        tracers=dataclasses.replace(
            cfg.tracers, tr_iage=True, tr_FY=True, tr_lvl=True,
            tr_pond_lvl=True, tr_aero=True, n_aero=2, tr_brine=True,
            skl_bgc=True),
        dyn=dataclasses.replace(cfg.dyn, ndte=10, kdyn=kdyn),
        forcing=dataclasses.replace(cfg.forcing, oceanmixed_ice=True),
        dtype=dtype, accum_dtype=dtype)


def _setup(kdyn=1, seed=3, **layers):
    """(port cfg, port tr, port State, JAX cfg, JAX tr, JAX State): a
    State with every field and tracer slot set from a seed (``layers``:
    nilyr, nslyr of the configuration)."""
    cfg = _cfg(kdyn, **layers)
    tr = build_tracer_registry(cfg)
    rng = np.random.default_rng(seed)
    z = zeros_state(cfg, tr, device="cpu")
    arrays = {}
    for f in dataclasses.fields(State):
        shape = tuple(getattr(z, f.name).shape)
        arrays[f.name] = rng.uniform(-1.0, 1.0, shape)
    arrays["aicen"] = np.abs(arrays["aicen"]) * 0.2
    arrays["iceumask"] = (arrays["iceumask"] > 0).astype(np.float64)
    arrays["first_ice"] = (arrays["first_ice"] > 0).astype(np.float64)
    for it in range(tr.ntrcr):
        arrays["trcrn"][:, it] += it + 1.0
    st = convert.state_from_arrays(arrays, device="cpu")
    jcfg = U.jax_config(cfg)
    return cfg, tr, st, jcfg, jbuild(jcfg), U.jax_obj(JState, st)


def _files(d):
    return sorted(os.listdir(d))


def _same_files(a, b):
    assert _files(a) == _files(b)
    for n in _files(a):
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def _state_equal(ref: dict, got, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(ref[f]),
                                      got[f] if isinstance(got, dict)
                                      else getattr(got, f).numpy(), f)


CORE_FIELDS = ("aicen", "vicen", "vsnon", "trcrn", "uvel", "vvel",
               "stressp", "stressm", "stress12", "scale_factor",
               "iceumask", "strocnxT", "strocnyT", "sst", "frzmlt",
               "frz_onset", "first_ice")


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("kdyn", [1, 2])
@pytest.mark.parametrize("coszen,oceanmixed", [(False, True), (True, True),
                                               (True, False),
                                               (False, False)])
def test_binary_dump_bytes_and_cross_read(tmp_path, kdyn, coszen,
                                          oceanmixed):
    cfg, tr, st, jcfg, jtr, jst = _setup(kdyn)
    extras = {"coszen": np.full((NY, NX), 0.3),
              "swvdr": np.linspace(0.0, 1.0, NY * NX).reshape(NY, NX)}
    kw = dict(istep=24, time=86400.0, time_forc=43200.0, coszen=coszen,
              oceanmixed=oceanmixed, extras=extras)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp = T.write_restart_v5(st, str(tmp_path / "t" / CORE), cfg, tr, **kw)
    jp = J.write_restart_v5(jst, str(tmp_path / "j" / CORE), jcfg, jtr,
                            **kw)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    _same_files(tmp_path / "t", tmp_path / "j")
    # each package reads the other's dump
    tst, tmeta = T.read_restart_v5(jp[0], cfg, tr, device="cpu")
    jst2, jmeta = J.read_restart_v5(tp[0], jcfg, jtr)
    fields = CORE_FIELDS + (("a11n", "a12n") if kdyn == 2 else ())
    fields = tuple(f for f in fields
                   if oceanmixed or f not in ("sst", "frzmlt"))
    _state_equal(_np(st), tst, fields)
    _state_equal(_np(jst2), tst, [f.name for f in
                                  dataclasses.fields(State)])
    assert sorted(tmeta) == sorted(jmeta)
    for k, v in jmeta.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(tmeta[k]),
                                      k)
    if coszen:
        np.testing.assert_array_equal(tmeta["coszen"], 0.3)


def test_float32_read_equals_jax(tmp_path):
    cfg, tr, st, jcfg, jtr, jst = _setup(seed=4)
    p = str(tmp_path / CORE)
    T.write_restart_v5(st, p, cfg, tr, istep=1, time=3600.0)
    tst, _ = T.read_restart_v5(p, cfg, tr, dtype=torch.float32,
                               device="cpu")
    jst2, _ = J.read_restart_v5(p, jcfg, jtr, dtype=np.float32)
    for f in dataclasses.fields(State):
        # the JAX reader leaves the fields the dump lacks (a11n, a12n,
        # mlt_onset) in the configuration's float64; the port casts them
        a = np.asarray(getattr(jst2, f.name)).astype(np.float32)
        assert getattr(tst, f.name).dtype == torch.float32, f.name
        np.testing.assert_array_equal(a, getattr(tst, f.name).numpy(),
                                      f.name)


@pytest.mark.parametrize("topo", [None, ("open", "open"),
                                  ("cyclic", "open"), ("cyclic", "tripole"),
                                  ("cyclic", "tripoleT")])
def test_restart_ext_bytes_and_read(tmp_path, topo):
    """Ghost-inclusive records: the halo image of each field (NE-corner
    vectors, the stress corner partners on the U-fold), or edge
    replication without a topology; the interior reads back exactly."""
    cfg, tr, st, jcfg, jtr, jst = _setup(kdyn=2, seed=11)
    t_topo = None if topo is None else Topology(*topo)
    j_topo = None if topo is None else JTopology(*topo)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp = T.write_restart_v5(st, str(tmp_path / "t" / CORE), cfg, tr,
                            istep=3, time=10800.0, restart_ext=True,
                            topo=t_topo)
    J.write_restart_v5(jst, str(tmp_path / "j" / CORE), jcfg, jtr,
                       istep=3, time=10800.0, restart_ext=True,
                       topo=j_topo)
    _same_files(tmp_path / "t", tmp_path / "j")
    recs = T._fseq_records(tp[0])
    next(recs)
    assert len(next(recs)) == (NY + 2) * (NX + 2) * 8
    got, meta = T.read_restart_v5(tp[0], cfg, tr, device="cpu")
    assert "missing_files" not in meta
    _state_equal(_np(st), got, CORE_FIELDS + ("a11n", "a12n"))


@pytest.mark.parametrize("oceanmixed", [True, False])
def test_netcdf_bytes_and_cross_read(tmp_path, oceanmixed):
    cfg, tr, st, jcfg, jtr, jst = _setup(kdyn=2, seed=5)
    kw = dict(istep=8760, time=3.15e7, time_forc=1.0,
              oceanmixed=oceanmixed)
    tp = T.write_restart_v5_nc(st, str(tmp_path / "t.nc"), cfg, tr, **kw)
    jp = J.write_restart_v5_nc(jst, str(tmp_path / "j.nc"), jcfg, jtr, **kw)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    tst, tmeta = T.read_restart_v5_nc(jp, cfg, tr, oceanmixed=oceanmixed,
                                      device="cpu")
    jst2, jmeta = J.read_restart_v5_nc(tp, jcfg, jtr, oceanmixed=oceanmixed)
    assert "missing_vars" not in tmeta
    assert sorted(tmeta) == sorted(jmeta)
    _state_equal(_np(jst2), tst, [f.name for f in
                                  dataclasses.fields(State)])
    fields = tuple(f for f in CORE_FIELDS + ("a11n", "a12n")
                   if oceanmixed or f not in ("sst", "frzmlt"))
    _state_equal(_np(st), tst, fields)


def _write_core(path, extra_records=0, drop_records=0):
    """A core dump (no coszen, with the slab ocean) with records added at
    its end or taken off it; returns its (cfg, tr)."""
    cfg, tr, st, *_ = _setup(seed=6)
    T.write_restart_v5(st, path, cfg, tr, istep=0, time=0.0)
    with open(path, "rb") as f:
        data = f.read()
    rec = 8 + NY * NX * 8
    if drop_records:
        data = data[:len(data) - drop_records * rec]
    for _ in range(extra_records):
        data += data[-rec:]
    with open(path, "wb") as f:
        f.write(data)
    return cfg, tr


@pytest.mark.parametrize("extra,drop", [(2, 0), (5, 0), (0, 3), (0, 7)])
def test_unexpected_record_count_raises(tmp_path, extra, drop):
    """The base records plus 0..3 only (the JAX reader reads any count at
    or above the base, inferring coszen and the slab ocean from it)."""
    p = str(tmp_path / CORE)
    cfg, tr = _write_core(p, extra, drop)
    with pytest.raises(ValueError, match="a CICE 5 core dump of this "
                       "configuration"):
        T.read_restart_v5(p, cfg, tr, device="cpu")


def test_layout_from_the_record_count(tmp_path):
    cfg, tr, st, *_ = _setup(seed=7)
    for coszen in (False, True):
        for om in (False, True):
            p = str(tmp_path / f"iced.{coszen}{om}")
            T.write_restart_v5(st, p, cfg, tr, istep=0, time=0.0,
                               coszen=coszen, oceanmixed=om)
            assert T.core_layout(p, cfg, tr) == (coszen, om)
    p = str(tmp_path / "iced.FalseFalse")
    with pytest.raises(ValueError, match="no sst/frzmlt"):
        T.read_restart_v5(p, cfg, tr, oceanmixed=True, device="cpu")
    # a dump with the slab ocean read without it skips its last records
    got, _ = T.read_restart_v5(str(tmp_path / "iced.FalseTrue"), cfg, tr,
                               oceanmixed=False, device="cpu")
    assert float(got.sst.abs().max()) == 0.0
    np.testing.assert_array_equal(got.aicen.numpy(), st.aicen.numpy())


def test_short_tracer_file_and_missing_files(tmp_path):
    cfg, tr, st, *_ = _setup(seed=8)
    paths = T.write_restart_v5(st, str(tmp_path / CORE), cfg, tr, istep=0,
                               time=0.0)
    aero = [p for p in paths if ".aero." in p][0]
    with open(aero, "r+b") as f:
        f.truncate(os.path.getsize(aero) - (8 + NY * NX * 8))
    with pytest.raises(ValueError, match=r"iced\.aero\..*ends before"):
        T.read_restart_v5(paths[0], cfg, tr, device="cpu")
    for p in paths[1:]:
        os.unlink(p)
    got, meta = T.read_restart_v5(paths[0], cfg, tr, device="cpu")
    assert len(meta["missing_files"]) == len(paths) - 1
    np.testing.assert_array_equal(got.aicen.numpy(), st.aicen.numpy())


def test_restore_needs_a_device(tmp_path, monkeypatch):
    cfg, tr, st, *_ = _setup(seed=9)
    p = str(tmp_path / CORE)
    T.write_restart_v5(st, p, cfg, tr, istep=0, time=0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.read_restart_v5(p, cfg, tr)


def test_a_v5_dump_continues_the_parity_run_exactly(tmp_path):
    """One step of the gx1-parity model, a v5 dump, a fresh Model restored
    from it: its next step equals the original's at 0.0 in every State
    field the dump carries (all but mlt_onset)."""
    ref = U.load_parity_reference()
    m = U.port_parity_model()
    st = convert.state_from_arrays(
        {k[3:]: v for k, v in ref.items() if k.startswith("in/")},
        device="cpu")
    st, _ = m.step(st, m.forcing_at(U.RUN_START))
    p = str(tmp_path / CORE)
    T.write_restart_v5(st, p, m.cfg, m.tr, istep=U.RUN_START + 1,
                       time=3600.0 * (U.RUN_START + 1))
    m2 = U.port_parity_model()
    st2, meta = T.read_restart_v5(p, m2.cfg, m2.tr, device="cpu")
    assert meta["istep"] == U.RUN_START + 1
    a, _ = m.step(st, m.forcing_at(meta["istep"]))
    b, _ = m2.step(st2, m2.forcing_at(meta["istep"]))
    for f in dataclasses.fields(State):
        if f.name != "mlt_onset":
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                f.name


def test_cesm2_layers_dump_bytes_and_round_trip(tmp_path):
    """CESM2's 8 ice and 3 snow layers: the core dump holds the layer
    records in CICE's order, the port's files equal the JAX package's
    byte for byte, and each package reads the dump back to the State it
    came from in every field the dump carries."""
    cfg, tr, st, jcfg, jtr, jst = _setup(nilyr=8, nslyr=3, seed=5)
    assert (cfg.nilyr, cfg.nslyr) == (8, 3)
    names = [n for n, _ in T._core_fields(cfg, tr, oceanmixed=True)]
    layer = [n for n in names if n[:4] in ("sice", "qice", "qsno")]
    assert layer == ([f"sice{k:03d}" for k in range(1, 9)]
                     + [f"qice{k:03d}" for k in range(1, 9)]
                     + ["qsno001", "qsno002", "qsno003"])
    kw = dict(istep=48, time=172800.0, oceanmixed=True)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp = T.write_restart_v5(st, str(tmp_path / "t" / CORE), cfg, tr, **kw)
    jp = J.write_restart_v5(jst, str(tmp_path / "j" / CORE), jcfg, jtr,
                            **kw)
    _same_files(tmp_path / "t", tmp_path / "j")
    tst, _ = T.read_restart_v5(tp[0], cfg, tr, device="cpu")
    jst2, _ = J.read_restart_v5(tp[0], jcfg, jtr)
    _state_equal(_np(st), tst, CORE_FIELDS)
    _state_equal(_np(jst2), tst, [f.name for f in
                                  dataclasses.fields(State)])


def test_a_v5_dump_continues_the_cesm2_layers_run_exactly(tmp_path):
    """The ``cesm2_layers`` set (gx1-parity physics at 8 ice and 3 snow
    layers, 24x16, float64): one step from its recorded warmed-up state,
    a v5 dump, a fresh Model restored from it; the next step equals the
    original's at 0.0 in every State field the dump carries."""
    import torch_option_sets as O
    from test_torch_options import port_inputs, port_model
    ref = O.load_reference("cesm2_layers")
    m = port_model("cesm2_layers")
    st, f = port_inputs(ref)
    st, _ = m.step(st, f)
    p = str(tmp_path / CORE)
    T.write_restart_v5(st, p, m.cfg, m.tr, istep=O.ISTEP + 2,
                       time=3600.0 * (O.ISTEP + 2))
    m2 = port_model("cesm2_layers")
    st2, meta = T.read_restart_v5(p, m2.cfg, m2.tr, device="cpu")
    assert meta["istep"] == O.ISTEP + 2
    a, _ = m.step(st, f)
    b, _ = m2.step(st2, f)
    for fl in dataclasses.fields(State):
        if fl.name != "mlt_onset":
            assert torch.equal(getattr(a, fl.name), getattr(b, fl.name)), \
                fl.name
