"""The port's file-driven forcing (``cice5_tpu_torch/forcing_data.py``)
against the JAX package's (``cice5_tpu/forcing_data.py``) on the same
files, which each test writes from a seed (``torch_file_forcing.py``):

- the raw fields of every reader (NCAR and Large-Yeager trees across the
  year seam and the cycle years, monthly climatologies, fixed-interval
  records, the ocean climatology, HadGEM netCDF, the aerosol and BGC
  records) bit for bit;
- each derived ``Forcing`` field within 1e-12 of its scale in float64, and
  in float32 within 1e-6 of its scale (a few float32 ulp; the inputs hold
  no subnormals, which XLA's CPU backend would flush);
- the layout helpers and the derivations (longwave, humidity fix,
  shortwave) the same;
- a missing or short record file raises, and a run driven by it stops;
- every Forcing of a run has the same fields, dtypes and device (one step
  graph);
- the gx1-parity model of test_torch_parity_step.py (24x16, ndte=8,
  float64) through ``Model.run`` driven by ``FileForcing.provider`` from
  its recorded warmed-up state, across the year seam, against the JAX
  run_loop recorded in test_torch_file_forcing.npz: the final state
  within 3e-8 x scale (the stress state 1e-5), each step's forcing within
  1e-12 of scale. The test marked slow recomputes the record.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from cice5_tpu_torch import convert
from cice5_tpu_torch import forcing_data as T
from cice5_tpu_torch.driver import graph
import torch_file_forcing as FF
import torch_port_util as U
from torch_port_util import assert_close

import jax.numpy as jnp
from cice5_tpu import forcing_data as J
from cice5_tpu.grid import popgrid_np as jpopgrid

NY, NX = U.PARITY_NY, U.PARITY_NX
FORCING_FIELDS = ("uatm", "vatm", "wind", "zlvl", "potT", "Tair", "Qa",
                  "rhoa", "flw", "fsnow", "frain", "swvdr", "swvdf",
                  "swidr", "swidf", "sss", "sst", "uocn", "vocn", "ss_tltx",
                  "ss_tlty", "frzmlt", "Tf", "qdp", "hmix", "yday", "coszen")
TOL = {"float64": 1e-12, "float32": 1e-6}


@pytest.fixture(scope="module")
def grids():
    """{dtype: (JAX grid, the port's grid with its arrays)} of the parity
    mesh."""
    from cice5_tpu_torch.convert import config_from_dict
    out = {}
    for dt in ("float64", "float32"):
        cfg = U.jax_config(config_from_dict(U.parity_config_dict(dt)))
        jg = jpopgrid(cfg, *U.parity_grid_arrays())
        tg = convert.grid_from_arrays(
            {f.name: np.asarray(getattr(jg, f.name))
             for f in dataclasses.fields(jg)}, device="cpu")
        out[dt] = (jg, tg)
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ncar")
    FF.write_ncar_tree(root, NY, NX, six_records=(0, 1, 2, 3, 1459))
    return str(root)


def _tdt(dt):
    return getattr(torch, dt)


def assert_forcing_close(jf, tf, rtol, fields=FORCING_FIELDS):
    for k in fields:
        a = np.asarray(getattr(jf, k))
        assert getattr(tf, k).dtype == _tdt(str(a.dtype)), k
        assert_close(a, getattr(tf, k), rtol, k)


def assert_raw_equal(jraw: dict, traw: dict):
    assert list(jraw) == list(traw)
    for k in jraw:
        np.testing.assert_array_equal(np.asarray(jraw[k]), traw[k], k)


# ---------------------------------------------------------------------
# layouts and derivations
# ---------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["ncar_files", "ly_files", "hadgem_files"])
def test_layouts_match_jax(fn):
    for yr in (1987, 1996, 2003):
        assert getattr(T, fn)("/data/x/", yr) == getattr(J, fn)("/data/x/",
                                                                 yr)
    for p in ("a/t_10.1996.dat", "b/rain.1996.nc", "c/x.1996.r", "short"):
        assert T.file_year(p, 2001) == J.file_year(p, 2001)
    assert (T.NCAR_MONTHLY, T.LY_MONTHLY) == (J.NCAR_MONTHLY, J.LY_MONTHLY)


def _fields(seed, shape=(NY, NX)):
    rng = np.random.default_rng(seed)
    return dict(Tair=rng.uniform(240.0, 280.0, shape),
                Qa=rng.uniform(1e-4, 6e-3, shape),
                cldf=rng.uniform(-0.1, 1.1, shape),
                fsw=rng.uniform(-5.0, 400.0, shape),
                rhoa=rng.uniform(1.2, 1.4, shape),
                uatm=rng.uniform(-8.0, 8.0, shape),
                vatm=rng.uniform(-8.0, 8.0, shape),
                fsnow=rng.uniform(-1.0, 60.0, shape),
                flw=rng.uniform(150.0, 320.0, shape),
                Tsfc=rng.uniform(-20.0, 0.0, shape),
                sst=rng.uniform(-1.8, 2.0, shape),
                aice=rng.uniform(0.0, 1.0, shape),
                hm=(rng.uniform(size=shape) > 0.2).astype(np.float64),
                ANGLET=rng.uniform(-0.5, 0.5, shape))


def test_derivations_match_jax():
    a = _fields(1)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    args = ("cldf", "Tsfc", "aice", "sst", "Qa", "Tair", "hm")
    assert_close(J.longwave_rosati_miyakoda(*(j[k] for k in args)),
                 T.longwave_rosati_miyakoda(*(t[k] for k in args)), 1e-12,
                 "flw")
    assert_close(J.Qa_fix_LY(j["Tair"], j["Qa"] * 3.0),
                 T.Qa_fix_LY(t["Tair"], t["Qa"] * 3.0), 1e-12, "Qa")
    lon = np.linspace(-np.pi, np.pi, NX)[None] * np.ones((NY, 1))
    lat = np.linspace(-1.4, 1.4, NY)[:, None] * np.ones((1, NX))
    for sec, yday in ((43200.0, 172.0), (0.0, 355.0), (20000.0, 80.5)):
        assert_close(J.compute_shortwave(
            jnp.asarray(lon), jnp.asarray(lat), j["Qa"], j["cldf"], j["hm"],
            sec, yday), T.compute_shortwave(
            torch.from_numpy(lon), torch.from_numpy(lat), t["Qa"],
            t["cldf"], t["hm"], sec, yday), 1e-12, f"fsw {yday}")


@pytest.mark.parametrize("atm,units,given", [
    ("ncar", "mm_per_month", ()), ("LYq", "mm_per_sec", ()),
    ("oned", "mm_per_day", ("flw",)), ("hadgem", "mks", ("flw", "frain")),
    ("ncar", "mks", ("fsnow",))])
def test_prepare_forcing_matches_jax(atm, units, given):
    a = _fields(2)
    a["frain"] = a["fsnow"] * 0.5
    keys = ("Tair", "fsw", "cldf", "Qa", "rhoa", "uatm", "vatm", "ANGLET",
            "hm")
    opt = ("flw", "fsnow", "frain")
    lyq = ("Tsfc", "sst", "aice") if atm == "LYq" else ()
    kw = dict(atm_data_type=atm, precip_units=units, days_per_year=365)
    ref = J.prepare_forcing(**{k: jnp.asarray(a[k]) for k in keys + lyq},
                            **{k: jnp.asarray(a[k]) for k in opt
                               if k in given}, **kw)
    got = T.prepare_forcing(**{k: torch.from_numpy(a[k])
                               for k in keys + lyq},
                            **{k: torch.from_numpy(a[k]) for k in opt
                               if k in given}, **kw)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert_close(ref[k], got[k], 1e-12, k)


def test_prepare_forcing_without_calc_strair_matches_jax():
    """calc_strair=False: the wind is taken as the dataset gives it, not
    rotated onto the grid (ice_forcing.F90:1653-1677), in both packages;
    on a grid with a rotation the two choices differ."""
    a = _fields(2)
    keys = ("Tair", "fsw", "cldf", "Qa", "rhoa", "uatm", "vatm", "ANGLET",
            "hm")
    kw = dict(atm_data_type="ncar", precip_units="mm_per_month",
              days_per_year=365)
    ref = J.prepare_forcing(**{k: jnp.asarray(a[k]) for k in keys},
                            calc_strair=False, **kw)
    got = T.prepare_forcing(**{k: torch.from_numpy(a[k]) for k in keys},
                            calc_strair=False, **kw)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert_close(ref[k], got[k], 1e-12, k)
    np.testing.assert_array_equal(got["uatm"].numpy(), a["uatm"])
    rotated = T.prepare_forcing(**{k: torch.from_numpy(a[k]) for k in keys},
                                **kw)
    assert not torch.equal(rotated["uatm"], got["uatm"])


# ---------------------------------------------------------------------
# the NCAR and Large-Yeager trees
# ---------------------------------------------------------------------

POINTS = [(1.0, 0.0, 1997), (1.0, 10800.0, 1997), (1.0, 21600.0, 1997),
          (1.0, 50000.0, 1998), (2.0, 0.0, 1996), (197.0, 3600.0, 1997),
          (365.0, 43200.0, 1997)]


@pytest.mark.parametrize("yday,sec,year", POINTS)
def test_ncar_raw_fields_bit_for_bit(tree, yday, sec, year):
    """The year seam (day 1 before 06:00 reads the previous cycle year's
    last record), both cycle years, mid-month and late December."""
    jds = J.FileForcing(tree, nx=NX, ny=NY, **FF.TREE)
    tds = T.FileForcing(tree, nx=NX, ny=NY, **FF.TREE)
    assert_raw_equal(jds.raw_at(yday, sec, year), tds.raw_at(yday, sec, year))
    assert tds.fyear(year) == jds.fyear(year)


def test_the_seam_reads_the_previous_cycle_years_last_record(tree):
    tds = T.FileForcing(tree, nx=NX, ny=NY, **FF.TREE)
    raw = tds.raw_at(1.0, 0.0, 1997)
    prev = tds._read("Tair", tds.fyear(1996), 1459)
    np.testing.assert_array_equal(raw["Tair"], prev)
    assert tds.fyear(1996) != tds.fyear(1997)
    assert prev.min() > 270.0      # a written record, not a hole


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("yday,sec,year", POINTS[:3] + POINTS[5:6])
def test_ncar_forcing_matches_jax(tree, grids, dt, yday, sec, year):
    jg, tg = grids[dt]
    jf = J.FileForcing(tree, nx=NX, ny=NY, **FF.TREE).forcing_at(
        yday, sec, year, jg, dtype=getattr(jnp, dt))
    tf = T.FileForcing(tree, nx=NX, ny=NY, **FF.TREE).forcing_at(
        yday, sec, year, tg, dtype=_tdt(dt))
    assert_forcing_close(jf, tf, TOL[dt])
    for k in ("Tair", "potT", "rhoa"):     # raw fields, cast once
        np.testing.assert_array_equal(np.asarray(getattr(jf, k)),
                                      getattr(tf, k).numpy(), k)


@pytest.fixture(scope="module")
def ly_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ly")
    rng = np.random.default_rng(7)
    vals = {"cldf": (0.2, 0.9), "fsnow": (1e-6, 5e-5), "Qa": (1e-3, 6e-3),
            "Tair": (255.0, 280.0), "uatm": (-5.0, 5.0),
            "vatm": (-5.0, 5.0)}
    for yr in (1996, 1997):
        for name, path in J.ly_files(str(root), yr).items():
            nrec = 12 if name in J.LY_MONTHLY else 1460
            recs = range(12) if nrec == 12 else (0, 1, 716, 717, 1459)
            FF.write_records(path, nrec, {
                r: rng.uniform(*vals[name], (NY, NX)) for r in recs})
    return str(root)


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("yday,sec", [(1.0, 3600.0), (180.0, 43200.0)])
def test_ly_forcing_matches_jax(ly_tree, grids, dt, yday, sec):
    """The AOMIP derivations: humidity fix, shortwave from clouds,
    Rosati-Miyakoda longwave over the given surface."""
    jg, tg = grids[dt]
    kw = dict(nx=NX, ny=NY, atm_data_type="LYq", fyear_init=1996,
              ycycle=2, year_init=1996, precip_units="mm_per_sec")
    rng = np.random.default_rng(3)
    surf = dict(Tsfc=rng.uniform(-15.0, 0.0, (NY, NX)),
                sst=rng.uniform(-1.8, 1.0, (NY, NX)),
                aice=rng.uniform(0.0, 1.0, (NY, NX)))
    jds, tds = J.FileForcing(ly_tree, **kw), T.FileForcing(ly_tree, **kw)
    assert_raw_equal(jds.raw_at(yday, sec, 1996), tds.raw_at(yday, sec,
                                                             1996))
    jf = jds.forcing_at(yday, sec, 1996, jg, dtype=getattr(jnp, dt),
                        **{k: jnp.asarray(v, dt) for k, v in surf.items()})
    tf = tds.forcing_at(yday, sec, 1996, tg, dtype=_tdt(dt), **{
        k: torch.from_numpy(v).to(_tdt(dt)) for k, v in surf.items()})
    assert_forcing_close(jf, tf, TOL[dt])
    assert float(tf.swvdr.max()) > 0.0 or yday == 1.0


# ---------------------------------------------------------------------
# the other readers
# ---------------------------------------------------------------------

def _monthly(seed, names=("Tair", "fsw", "cldf", "sss", "sst", "hmix")):
    rng = np.random.default_rng(seed)
    lo = dict(Tair=250.0, fsw=0.0, cldf=0.2, sss=32.0, sst=-1.8, hmix=10.0)
    return {k: lo[k] + rng.uniform(0.0, 20.0 if k != "cldf" else 0.7,
                                   (12, NY, NX)) for k in names}


@pytest.mark.parametrize("yday", [1.0, 15.0, 196.0, 364.5])
def test_monthly_forcing_matches_jax(grids, yday):
    jg, tg = grids["float64"]
    kw = dict(atm_data_type="ncar", defaults={"qdp": -2.0})
    jds = J.MonthlyForcing(fields=_monthly(4), **kw)
    tds = T.MonthlyForcing(fields=_monthly(4), **kw)
    assert_raw_equal(jds.raw_at(yday), tds.raw_at(yday))
    assert_forcing_close(jds.forcing_at(yday, jg, dtype=jnp.float64),
                         tds.forcing_at(yday, tg, dtype=torch.float64),
                         1e-12)


def test_monthly_forcing_from_netcdf(tmp_path):
    from scipy.io import netcdf_file
    path = str(tmp_path / "clim.nc")
    data = _monthly(5, ("Tair",))["Tair"]
    with netcdf_file(path, "w") as f:
        f.createDimension("time", 12)
        f.createDimension("y", NY)
        f.createDimension("x", NX)
        f.createVariable("airtmp", "d", ("time", "y", "x"))[:] = data
    jds = J.MonthlyForcing.from_netcdf(path, {"Tair": "airtmp"})
    tds = T.MonthlyForcing.from_netcdf(path, {"Tair": "airtmp"})
    assert_raw_equal(jds.raw_at(40.0), tds.raw_at(40.0))


@pytest.mark.parametrize("recslot,istep", [(1, 6), (1, 9), (2, 3),
                                           (2, 14)])
def test_record_forcing_matches_jax(grids, recslot, istep):
    jg, tg = grids["float64"]
    f = {k: v[:8] for k, v in _monthly(6, ("Tair", "fsw")).items()}
    kw = dict(fields=f, recslot=recslot, atm_data_type="oned")
    jds, tds = J.RecordForcing(**kw), T.RecordForcing(**kw)
    assert_raw_equal(jds.raw_at(istep, 3600.0), tds.raw_at(istep, 3600.0))
    assert_forcing_close(jds.forcing_at(istep, 3600.0, jg,
                                        dtype=jnp.float64),
                         tds.forcing_at(istep, 3600.0, tg,
                                        dtype=torch.float64), 1e-12)


def test_ocean_climatology_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    files = {}
    for k in ("sst", "sss"):
        files[k] = str(tmp_path / f"{k}_clim.dat")
        rng.uniform(-2.0, 35.0, (12, NY, NX)).astype(">f8").tofile(files[k])
    jds = J.OcnClimForcing(files=files, nx=NX, ny=NY)
    tds = T.OcnClimForcing(files=files, nx=NX, ny=NY)
    for yday in (3.0, 197.0):
        assert_raw_equal(jds.raw_at(yday), tds.raw_at(yday))


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_aerosol_and_bgc_records_match_jax(grids, dt):
    jg, tg = grids[dt]
    rng = np.random.default_rng(9)
    faero = rng.uniform(1e-12, 1e-9, (12, 2, NY, NX))
    ocean_bio = rng.uniform(0.0, 10.0, (12, 4, NY, NX))
    jds = J.AeroBgcForcing(faero=faero, ocean_bio=ocean_bio)
    tds = T.AeroBgcForcing(faero=faero, ocean_bio=ocean_bio)
    mf = dict(fields=_monthly(10, ("Tair",)))
    jf = jds.attach(J.MonthlyForcing(**mf).forcing_at(
        100.0, jg, dtype=getattr(jnp, dt)), 100.0, dtype=getattr(jnp, dt))
    tf = tds.attach(T.MonthlyForcing(**mf).forcing_at(
        100.0, tg, dtype=_tdt(dt)), 100.0, dtype=_tdt(dt))
    for k in ("faero_atm", "ocean_bio"):
        np.testing.assert_array_equal(np.asarray(getattr(jf, k)),
                                      getattr(tf, k).numpy(), k)
    assert T.AeroBgcForcing().attach(tf, 100.0) is tf


def test_hadgem_matches_jax(tmp_path, grids):
    from scipy.io import netcdf_file
    jg, tg = grids["float64"]
    rng = np.random.default_rng(12)
    os.makedirs(tmp_path / "MONTHLY")
    for yr in (1996, 1997):
        for name, (path, var) in J.hadgem_files(str(tmp_path), yr).items():
            with netcdf_file(path, "w") as f:
                f.createDimension("time", 12)
                f.createDimension("nj", NY)
                f.createDimension("ni", NX)
                f.createVariable(var, "d", ("time", "nj", "ni"))[:] = \
                    rng.uniform(0.5, 1.5, (12, NY, NX)) * (
                        260.0 if var in ("t_10", "LW_incoming") else 1e-3)
    kw = dict(fyear_init=1996, ycycle=2, year_init=1996)
    jds = J.HadgemForcing(str(tmp_path), **kw)
    tds = T.HadgemForcing(str(tmp_path), **kw)
    for yday, yr in ((5.0, 1997), (197.5, 1996), (360.0, 1996)):
        assert_raw_equal(jds.raw_at(yday, yr), tds.raw_at(yday, yr))
        assert_forcing_close(jds.forcing_at(yday, yr, jg, dtype=jnp.float64),
                             tds.forcing_at(yday, yr, tg,
                                            dtype=torch.float64), 1e-12)


# ---------------------------------------------------------------------
# no fallback, one graph
# ---------------------------------------------------------------------

def test_a_short_record_file_raises(tmp_path):
    FF.write_ncar_tree(tmp_path, NY, NX, years=(1997,), six_records=(0, 1))
    path = T.ncar_files(str(tmp_path), 1997)["Tair"]
    with open(path, "r+b") as f:
        f.truncate(NY * NX * 8 + 100)      # record 0 and a bit of 1
    ds = T.FileForcing(str(tmp_path), nx=NX, ny=NY, fyear_init=1997)
    with pytest.raises(EOFError, match=r"t_10\.1997\.dat: records 1\.\.1 "
                       r"of 3072 bytes each end at byte 6144, the file "
                       r"holds 3172 bytes"):
        ds.raw_at(1.0, 21600.0, 1997)
    clim = tmp_path / "sst.dat"
    np.zeros((11, NY, NX), ">f8").tofile(clim)
    with pytest.raises(EOFError, match="sst.dat"):
        T.OcnClimForcing(files={"sst": str(clim)}, nx=NX, ny=NY)


def test_a_missing_file_stops_the_run(tmp_path):
    """A provider whose files are missing raises out of Model.run: nothing
    carries on with another forcing."""
    m = U.port_parity_model()
    m.forcing_provider = T.FileForcing(str(tmp_path), nx=NX,
                                       ny=NY).provider(m)
    ref = U.load_parity_reference()
    st = convert.state_from_arrays(
        {k[3:]: v for k, v in ref.items() if k.startswith("in/")},
        device="cpu")
    with pytest.raises(FileNotFoundError, match="swdn.1997.dat"):
        m.run(st, 1, log=lambda *a: None)


def test_every_step_has_one_forcing_signature(tree, grids):
    """The same fields, dtypes and device at every step (one captured
    step graph), the aerosol records attached or not."""
    _, tg = grids["float32"]
    ds = T.FileForcing(tree, nx=NX, ny=NY, **FF.TREE)
    aero = T.AeroBgcForcing(faero=np.ones((12, 1, NY, NX)))
    for attach in (False, True):
        sigs = set()
        for yday, sec, year in POINTS:
            f = ds.forcing_at(yday, sec, year, tg, dtype=torch.float32)
            if attach:
                f = aero.attach(f, yday)
            sigs.add(graph.signature(f))
        assert len(sigs) == 1


# ---------------------------------------------------------------------
# the gx1-parity model driven by the files, against the recorded JAX run
# ---------------------------------------------------------------------

STATE = ("aicen", "vicen", "vsnon", "uvel", "vvel", "sst",
         "frzmlt", "strocnxT", "strocnyT", "iceumask", "scale_factor",
         "frz_onset", "a11n", "a12n", "first_ice")
STRESS = ("stressp", "stressm", "stress12")


@pytest.fixture(scope="module")
def file_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_tree")
    FF.write_ncar_tree(root, NY, NX)
    m = U.port_parity_model()
    ds = T.FileForcing(str(root), nx=NX, ny=NY, **FF.TREE)
    provider = ds.provider(m)
    forcings = {}

    def recording(istep, info):
        forcings[istep] = provider(istep, info)
        return forcings[istep]
    m.forcing_provider = recording
    ref = U.load_parity_reference()
    st = convert.state_from_arrays(
        {k[3:]: v for k, v in ref.items() if k.startswith("in/")},
        device="cpu")
    final = m.run(st, FF.FILE_NSTEPS, start_step=FF.FILE_START,
                  log=lambda *a: None)
    return dict(final=final, forcings=forcings,
                ref=FF.load_file_reference())


def test_recorded_file_reference_matches_its_inputs():
    assert str(FF.load_file_reference()["key"]) == FF.file_reference_key()


@pytest.mark.parametrize("name", STATE + STRESS)
def test_file_driven_run_matches_the_jax_run(file_run, name):
    tol = 1e-5 if name in STRESS else 3e-8
    assert_close(file_run["ref"][f"out/{name}"],
                 getattr(file_run["final"], name), tol, name, floor=1.0)


def test_file_driven_run_tracers_match_the_jax_run(file_run):
    """Every tracer as its conserved amount, each on its own scale."""
    from cice5_tpu_torch.models.thermo.itd import tracer_weights
    tr = U.port_parity_model().tr
    t = lambda k: torch.as_tensor(file_run["ref"][f"out/{k}"])
    w_ref = tracer_weights(tr, t("aicen"), t("vicen"), t("vsnon"),
                           t("trcrn")) * t("trcrn")
    s = file_run["final"]
    w_got = tracer_weights(tr, s.aicen, s.vicen, s.vsnon, s.trcrn) * s.trcrn
    for it in range(tr.ntrcr):
        assert_close(w_ref[:, it], w_got[:, it], 3e-8, tr.names[it],
                     floor=1e-6)


@pytest.mark.parametrize("k", range(FF.FILE_NSTEPS))
def test_file_driven_forcing_matches_the_jax_run(file_run, k):
    istep = FF.FILE_START + k
    f = file_run["forcings"][istep]
    for name in FORCING_FIELDS:
        assert_close(file_run["ref"][f"forcing{istep}/{name}"],
                     getattr(f, name), 1e-12, f"step {istep} {name}")
    assert float(f.frain.max()) > 0.0 and float(f.fsnow.max()) == 0.0


@pytest.mark.slow
def test_recorded_file_reference_recomputes():
    fresh = FF.make_file_reference()
    ref = FF.load_file_reference()
    assert sorted(fresh) == sorted(k for k in ref if k != "key")
    for k, v in fresh.items():
        tol = 1e-5 if k.split("/")[-1] in STRESS else 3e-8
        assert_close(ref[k], v, tol, k, floor=1.0)
