"""The port's grid readers and builders (``cice5_tpu_torch/io/readers.py``,
``grid.py``: popgrid, latlongrid, gridbox_corners, make_grid) against the
JAX package's, on files this test writes: a POP grid as netCDF3 and as
big-endian binary records, a CPOM binary grid, a CESM domain file (1-D and
2-D coordinates) and a forcing field with records. The reference's
global_gx3/global_tp1 files are not in the repository; the POP files here
hold the synthetic global mesh of ``synth_global_arrays`` with land.
Every field of every grid type equals the JAX one (1e-14 relative), and
gx3_config / tp1_config read such a pair and build a Model whose initial
state is the JAX package's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cice5_tpu_torch import config as tconfig
from cice5_tpu_torch import grid as tgrid
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.io import readers as treaders
from torch_port_util import assert_close, jax_config

from cice5_tpu import grid as jgrid
from cice5_tpu.io import readers as jreaders

NY, NX = 12, 10


def _pop_arrays(ny=NY, nx=NX):
    """(ULAT, ULON, HTN, HTE (m), ANGLE, KMT) of the synthetic global mesh
    with land in the south, a small island and a non-zero ANGLE."""
    kmt = np.full((ny, nx), 20, np.int32)
    kmt[:2] = 0
    kmt[5, 3:5] = 0
    ulat, ulon, htn, hte, _, kmt = tgrid.synth_global_arrays(kmt)
    angle = 0.05 * np.sin(ulon) * np.cos(ulat)
    return ulat, ulon, htn, hte, angle, kmt


def write_pop_nc(d, ny=NY, nx=NX):
    """A POP grid file pair as netCDF3: ulat/ulon/angle in radians,
    htn/hte in cm, kmt levels (popgrid_nc's names)."""
    from scipy.io import netcdf_file
    ulat, ulon, htn, hte, angle, kmt = _pop_arrays(ny, nx)
    gpath, kpath = str(d / "grid.nc"), str(d / "kmt.nc")
    with netcdf_file(gpath, "w") as f:
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        for name, a in (("ulat", ulat), ("ulon", ulon), ("htn", htn * 100.0),
                        ("hte", hte * 100.0), ("angle", angle)):
            f.createVariable(name, "d", ("nj", "ni"))[:] = a
    with netcdf_file(kpath, "w") as f:
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        f.createVariable("kmt", "i", ("nj", "ni"))[:] = kmt
    return gpath, kpath


def write_pop_bin(d, ny=NY, nx=NX, cpom=False):
    """A POP (or, with cpom, CPOM: degrees and metres) binary grid pair:
    7 big-endian float64 records ULAT, ULON, HTN, HTE, HUS, HUW, ANGLE and
    big-endian int32 KMT."""
    ulat, ulon, htn, hte, angle, kmt = _pop_arrays(ny, nx)
    if cpom:
        ulat, ulon = np.rad2deg(ulat), np.rad2deg(ulon)
    else:
        htn, hte = htn * 100.0, hte * 100.0
    recs = np.stack([ulat, ulon, htn, hte, hte, htn, angle])
    gpath = str(d / ("cpom.grid" if cpom else "pop.grid"))
    kpath = str(d / ("cpom.kmt" if cpom else "pop.kmt"))
    recs.astype(">f8").tofile(gpath)
    kmt.astype(">i4").tofile(kpath)
    return gpath, kpath


def write_domain(d, one_d):
    """A CESM domain file: xc/yc (1-D or 2-D, degrees), area (rad^2),
    mask."""
    from scipy.io import netcdf_file
    path = str(d / ("domain1d.nc" if one_d else "domain2d.nc"))
    xc = np.linspace(0.0, 324.0, NX)
    yc = np.linspace(-60.0, 80.0, NY)
    area = np.full((NY, NX), (2 * np.pi / NX) * (np.pi / NY))
    area[3, 4] *= 1.5
    mask = np.ones((NY, NX))
    mask[0, :] = 0
    mask[6, 2] = 0
    if not one_d:
        xc, yc = np.meshgrid(xc, yc)
    with netcdf_file(path, "w") as f:
        f.createDimension("nj", NY)
        f.createDimension("ni", NX)
        dims = {1: {"xc": ("ni",), "yc": ("nj",)}}
        for name, a in (("xc", xc), ("yc", yc), ("area", area),
                        ("mask", mask)):
            dd = dims[1][name] if (one_d and name in ("xc", "yc")) \
                else ("nj", "ni")
            f.createVariable(name, "d", dd)[:] = a
    return path


def _same_dict(ref, got):
    assert sorted(ref) == sorted(got)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _same_grid(jg, tg, rtol=1e-14):
    for f in dataclasses.fields(jg):
        a = np.asarray(getattr(jg, f.name))
        b = getattr(tg, f.name)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b.cpu().numpy(), f.name)
        else:
            assert_close(a.astype(np.float64), b.double(), rtol, f.name,
                         floor=1.0)


def _cfg(grid_type, ns="open", **grid):
    c = tconfig.rect_config(ny=NY, nx=NX, dtype="float64",
                            accum_dtype="float64")
    return c.replace(grid=dataclasses.replace(
        c.grid, grid_type=grid_type, ns_boundary=ns, **grid))


# ---------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------

def test_read_pop_grid_nc_matches(tmp_path):
    g, k = write_pop_nc(tmp_path)
    _same_dict(jreaders.read_pop_grid_nc(g, k),
               treaders.read_pop_grid_nc(g, k))
    got = treaders.read_pop_grid_nc(g, k)
    assert_close(_pop_arrays()[2], got["HTN"], 1e-15, "HTN in m")


def test_read_pop_grid_nc_varmap_and_one_file(tmp_path):
    """Other variable names (varmap) and the KMT in the grid file."""
    from scipy.io import netcdf_file
    ulat, ulon, htn, hte, angle, kmt = _pop_arrays()
    path = str(tmp_path / "one.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("y", NY)
        f.createDimension("x", NX)
        for name, a in (("ULAT", ulat), ("ULON", ulon), ("HTN", htn * 100),
                        ("HTE", hte * 100), ("ANGLE", angle)):
            f.createVariable(name, "d", ("y", "x"))[:] = a
        f.createVariable("KMT", "i", ("y", "x"))[:] = kmt
    vm = {"ULAT": "ULAT", "ULON": "ULON", "HTN": "HTN", "HTE": "HTE",
          "ANGLE": "ANGLE", "kmt": "KMT"}
    _same_dict(jreaders.read_pop_grid_nc(path, varmap=vm),
               treaders.read_pop_grid_nc(path, varmap=vm))


@pytest.mark.parametrize("cpom", [False, True], ids=["pop", "cpom"])
def test_read_binary_grids_match(tmp_path, cpom):
    g, k = write_pop_bin(tmp_path, cpom=cpom)
    jr = jreaders.read_cpom_grid_binary if cpom else \
        jreaders.read_pop_grid_binary
    tr = treaders.read_cpom_grid_binary if cpom else \
        treaders.read_pop_grid_binary
    _same_dict(jr(g, k, NX, NY), tr(g, k, NX, NY))
    got = tr(g, k, NX, NY)
    ref = _pop_arrays()
    assert_close(ref[0], got["ULAT"], 1e-14, "ULAT")
    assert_close(ref[2], got["HTN"], 1e-15, "HTN")
    np.testing.assert_array_equal(ref[5], got["kmt"])


def test_read_binary_grid_without_angle_record(tmp_path):
    """Four records only: ANGLE is zero in both packages."""
    ulat, ulon, htn, hte, _, kmt = _pop_arrays()
    g, k = str(tmp_path / "g4"), str(tmp_path / "k4")
    np.stack([ulat, ulon, htn, hte]).astype(">f8").tofile(g)
    kmt.astype(">i4").tofile(k)
    got = treaders.read_pop_grid_binary(g, k, NX, NY)
    _same_dict(jreaders.read_pop_grid_binary(g, k, NX, NY), got)
    assert not got["ANGLE"].any()


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_read_latlon_domain_matches(tmp_path, one_d):
    p = write_domain(tmp_path, one_d)
    _same_dict(jreaders.read_latlon_domain(p), treaders.read_latlon_domain(p))


def test_read_netcdf_field_records_match(tmp_path):
    from scipy.io import netcdf_file
    p = str(tmp_path / "forcing.nc")
    data = np.random.default_rng(5).normal(size=(4, NY, NX))
    with netcdf_file(p, "w") as f:
        f.createDimension("time", 4)
        f.createDimension("nj", NY)
        f.createDimension("ni", NX)
        f.createVariable("Tair", "d", ("time", "nj", "ni"))[:] = data
    for rec in (None, 0, 3):
        a = jreaders.read_netcdf_field(p, "Tair", rec)
        b = treaders.read_netcdf_field(p, "Tair", rec)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(treaders.read_netcdf_field(p, "Tair", 2),
                                  data[2])


@pytest.mark.parametrize("days", [365, 360])
def test_interp_coeff_monthly_matches(days):
    for yday in (1.0, 10.3, 15.5, 45.0, 180.25, 349.9, 364.0,
                 float(days)):
        assert jreaders.interp_coeff_monthly(yday, days) == \
            treaders.interp_coeff_monthly(yday, days)


@pytest.mark.parametrize("recslot", [1, 2])
def test_interp_coeff_matches(recslot):
    for istep in (0, 1, 5, 23, 24, 100):
        assert jreaders.interp_coeff(istep, 3600.0, recslot, 6 * 3600.0) == \
            treaders.interp_coeff(istep, 3600.0, recslot, 6 * 3600.0)


# ---------------------------------------------------------------------
# the grid builders
# ---------------------------------------------------------------------

def _grid_cases(d):
    gnc, knc = write_pop_nc(d)
    gbin, kbin = write_pop_bin(d)
    gcp, kcp = write_pop_bin(d, cpom=True)
    dom = write_domain(d, one_d=True)
    return {
        "rectangular": _cfg("rectangular"),
        "column": _cfg("column"),
        "displaced_pole_nc": _cfg("displaced_pole", grid_file=gnc,
                                  kmt_file=knc),
        "displaced_pole_bin": _cfg("displaced_pole", grid_format="bin",
                                   grid_file=gbin, kmt_file=kbin),
        "tripole_nc": _cfg("tripole", ns="tripole", grid_file=gnc,
                           kmt_file=knc),
        "latlon": _cfg("latlon", grid_file=dom),
        "cpom": _cfg("cpom", grid_format="bin", grid_file=gcp,
                     kmt_file=kcp),
    }


CASES = ("rectangular", "column", "displaced_pole_nc", "displaced_pole_bin",
         "tripole_nc", "latlon", "cpom")


@pytest.mark.parametrize("case", CASES)
def test_make_grid_matches(tmp_path, case):
    cfg = _grid_cases(tmp_path)[case]
    jg = jgrid.make_grid(jax_config(cfg))
    tg = tgrid.make_grid(cfg, device="cpu")
    _same_grid(jg, tg)
    lon_j, lat_j = jgrid.gridbox_corners(jg)
    lon_t, lat_t = tgrid.gridbox_corners(tg)
    np.testing.assert_allclose(lon_t, np.asarray(lon_j), rtol=1e-14)
    np.testing.assert_allclose(lat_t, np.asarray(lat_j), rtol=1e-14)


def test_float32_grid_matches(tmp_path):
    """A float32 configuration casts the float64 host arrays once, as the
    JAX package does."""
    cfg = _grid_cases(tmp_path)["displaced_pole_nc"]
    cfg = cfg.replace(dtype="float32", accum_dtype="float32")
    jg = jgrid.make_grid(jax_config(cfg))
    tg = tgrid.make_grid(cfg, device="cpu")
    for f in dataclasses.fields(jg):
        a = np.asarray(getattr(jg, f.name))
        b = getattr(tg, f.name).cpu().numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, f.name)


def test_popgrid_refuses_a_file_of_another_shape(tmp_path):
    g, k = write_pop_nc(tmp_path)
    cfg = _cfg("displaced_pole", grid_file=g, kmt_file=k)
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=NY + 1))
    for build in (lambda: jgrid.make_grid(jax_config(cfg)),
                  lambda: tgrid.make_grid(cfg, device="cpu")):
        with pytest.raises(ValueError, match="config says"):
            build()
    nofile = _cfg("displaced_pole")
    with pytest.raises(ValueError, match="grid_file/kmt_file"):
        tgrid.make_grid(nofile, device="cpu")


def test_latlon_grid_runs_a_thermo_only_step(tmp_path):
    """The lat-lon grid (dynamics off, sentinel metrics) steps healthily
    in the port, with the JAX package's initial state."""
    from cice5_tpu.driver.model import Model as JModel
    cfg = _grid_cases(tmp_path)["latlon"]
    cfg = cfg.replace(dyn=dataclasses.replace(cfg.dyn, kdyn=0,
                                              advection="none"))
    m = Model(cfg, device="cpu")
    jm = JModel(jax_config(cfg))
    ice = m.grid.tmask
    st = m.init_state(ice_mask=ice)
    jst = jm.init_state(ice_mask=np.asarray(ice))
    for f in dataclasses.fields(jst):
        assert_close(np.asarray(getattr(jst, f.name)), getattr(st, f.name),
                     1e-13, f.name, floor=1.0)
    st2, d = m.step(st, m.forcing_at(0))
    assert int(d.state_bad) == 0 and bool(d.therm_converged)
    assert float(m.grid.dxt[0, 0]) > 1e30


@pytest.mark.parametrize("builder", ["gx3", "tp1"])
def test_standalone_config_reads_its_grid_dir(tmp_path, builder):
    """gx3_config(grid_dir) / tp1_config(grid_dir) name the reference's
    file pair in grid_dir; the port's Model reads it through make_grid ->
    popgrid -> read_pop_grid_nc (here a 12x10 pair written under those
    names, the config cut to that size) and its grid and initial state
    equal the JAX package's."""
    from cice5_tpu import config as jconfig
    from cice5_tpu.driver.model import Model as JModel
    g, k = write_pop_nc(tmp_path)
    stem = "global_gx3" if builder == "gx3" else "global_tp1"
    (tmp_path / "grid.nc").rename(tmp_path / f"{stem}.grid.nc")
    (tmp_path / "kmt.nc").rename(tmp_path / f"{stem}.kmt.nc")
    build = {"gx3": tconfig.gx3_config, "tp1": tconfig.tp1_config}[builder]
    cfg = build(str(tmp_path), dtype="float64", accum_dtype="float64")
    jcfg = {"gx3": jconfig.gx3_config, "tp1": jconfig.tp1_config}[builder](
        str(tmp_path))
    jd = dataclasses.asdict(jcfg)
    jd.update(dtype="float64", accum_dtype="float64")
    assert dataclasses.asdict(cfg) == jd
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=NY, nx=NX),
                      dyn=dataclasses.replace(cfg.dyn, ndte=4))
    m = Model(cfg, device="cpu")
    jm = JModel(jax_config(cfg))
    _same_grid(jm.grid, m.grid)
    st = m.init_state()
    jst = jm.init_state()
    for f in dataclasses.fields(jst):
        assert_close(np.asarray(getattr(jst, f.name)), getattr(st, f.name),
                     1e-13, f.name, floor=1.0)
    assert float(st.aicen.sum()) > 0.0
    assert torch.isfinite(m.grid.tarea).all()


def test_column_config_matches():
    from cice5_tpu import config as jconfig
    assert dataclasses.asdict(tconfig.column_config()) == \
        dataclasses.asdict(jconfig.column_config())
    cfg = tconfig.column_config(dtype="float64", accum_dtype="float64")
    m = Model(cfg, device="cpu")
    st, d = m.step(m.init_state(ice_mask=m.grid.tmask), m.forcing_at(0))
    assert int(d.state_bad) == 0 and bool(d.therm_converged)
