"""Grid and forcing file readers (a copy of ``cice5_tpu/io/readers.py``;
NumPy/scipy code, no tensors).

The grid readers of ice_grid.F90 popgrid (:543, big-endian binary POP
records), popgrid_nc (:659), cpomgrid (:1313) and latlongrid's CESM domain
file (:876), and ice_read_write.F90's ice_read_nc: files are read on the
host and the builders of ``cice5_tpu_torch/grid.py`` put the results on
the model's device. netCDF files are classic (netCDF3), read with
``scipy.io.netcdf_file``. Forcing time series use the interpolation
weights of ice_forcing.F90 (interp_coeff_monthly :1296, interp_coeff
:1342).
"""
from __future__ import annotations

import os

import numpy as np


def read_pop_grid_binary(grid_file: str, kmt_file: str, nx: int, ny: int):
    """Read a POP displaced-pole/tripole binary grid (ice_grid.F90:543-657):
    records ULAT, ULON (radians), HTN, HTE (cm), [HUS, HUW], ANGLE (radians),
    big-endian float64; KMT file big-endian int32.

    Returns dict with ULAT, ULON, HTN, HTE (m), ANGLE, kmt — row-major
    (ny, nx) arrays ready for grid.popgrid_np."""
    n = nx * ny
    raw = np.fromfile(grid_file, dtype=">f8")
    nrec = raw.size // n
    rec = lambda k: raw[k * n:(k + 1) * n].reshape(ny, nx)
    out = {
        "ULAT": rec(0),
        "ULON": rec(1),
        "HTN": rec(2) * 0.01,   # cm -> m
        "HTE": rec(3) * 0.01,
    }
    out["ANGLE"] = rec(6) if nrec >= 7 else np.zeros((ny, nx))
    kraw = np.fromfile(kmt_file, dtype=">i4")
    out["kmt"] = kraw[:n].reshape(ny, nx)
    return out


def interp_coeff_monthly(yday: float, days_per_year: int = 365):
    """Linear-in-time weights between mid-month records
    (ice_forcing.F90:1296-1340). Returns (rec1, rec2, c1, c2) with 0-based
    month record indices."""
    daycal = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334, 365]
    if days_per_year == 360:
        daycal = [30 * i for i in range(13)]
    mid = [0.5 * (daycal[m] + daycal[m + 1]) for m in range(12)]
    t = yday - 1.0
    if t < mid[0]:
        m1, m2 = 11, 0
        span = (days_per_year - mid[11]) + mid[0]
        frac = (t + days_per_year - mid[11]) / span
    elif t >= mid[11]:
        m1, m2 = 11, 0
        span = (days_per_year - mid[11]) + mid[0]
        frac = (t - mid[11]) / span
    else:
        m1 = max(m for m in range(12) if mid[m] <= t)
        m2 = m1 + 1
        frac = (t - mid[m1]) / (mid[m2] - mid[m1])
    return m1, m2, 1.0 - frac, frac


def interp_coeff(istep: int, dt: float, recslot: int, sec_per_rec: float):
    """Weights between two consecutive forcing records
    (ice_forcing.F90:1342-1398). recslot=1: recs centered at end of
    interval; recslot=2: at the middle."""
    secyr = sec_per_rec
    tt = istep * dt
    if recslot == 1:
        t2 = (tt // secyr + 1) * secyr
        t1 = t2 - secyr
    else:
        t1 = (tt - secyr / 2) // secyr * secyr + secyr / 2
        t2 = t1 + secyr
    c2 = (tt - t1) / (t2 - t1)
    return 1.0 - c2, c2


def read_records(path: str, n: int, rec: int, count: int = 1,
                 dtype: str = ">f8") -> np.ndarray:
    """``count`` consecutive records of ``n`` values from 0-based record
    ``rec`` of a direct-access binary file, flat. A file too short for
    them raises EOFError naming the file, the records and its size (a
    plain ``np.fromfile`` returns a short array there)."""
    item = np.dtype(dtype).itemsize
    size = os.path.getsize(path)
    end = (rec + count) * n * item
    if size < end:
        raise EOFError(
            f"{path}: records {rec}..{rec + count - 1} of {n * item} bytes "
            f"each end at byte {end}, the file holds {size} bytes "
            f"({size // (n * item)} whole records)")
    return np.fromfile(path, dtype=dtype, count=n * count,
                       offset=rec * n * item)


def read_netcdf_field(path: str, varname: str, record: int | None = None):
    """Read one variable (optionally one record) from a classic netCDF file
    via scipy (ice_read_nc equivalent)."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        v = f.variables[varname]
        data = v[record] if record is not None else v[:]
        return np.array(data)


def read_cpom_grid_binary(grid_file: str, kmt_file: str, nx: int, ny: int):
    """CPOM regional grid (ice_grid.F90:1313-1396 cpomgrid): same record
    layout as POP binary but ULAT/ULON in DEGREES and HTN/HTE in METERS.
    Returns the read_pop_grid_binary dict layout (radians / meters)."""
    n = nx * ny
    raw = np.fromfile(grid_file, dtype=">f8")
    nrec = raw.size // n
    rec = lambda k: raw[k * n:(k + 1) * n].reshape(ny, nx)
    out = {
        "ULAT": np.deg2rad(rec(0)),
        "ULON": np.deg2rad(rec(1)),
        "HTN": rec(2),            # already meters
        "HTE": rec(3),
    }
    out["ANGLE"] = rec(6) if nrec >= 7 else np.zeros((ny, nx))
    kraw = np.fromfile(kmt_file, dtype=">i4")
    out["kmt"] = kraw[:n].reshape(ny, nx)
    return out


def read_latlon_domain(path: str):
    """CESM domain file for latlongrid (ice_grid.F90:876-1141): xc/yc cell
    centers (degrees), area (radians^2), mask (1=ocean). 1-D xc/yc are
    broadcast to 2-D."""
    out = {}
    for name in ("xc", "yc", "area", "mask"):
        out[name] = np.asarray(read_netcdf_field(path, name), np.float64)
    if out["xc"].ndim == 1:
        nx, ny = out["xc"].size, out["yc"].size
        out["xc"] = np.broadcast_to(out["xc"][None, :], (ny, nx)).copy()
        out["yc"] = np.broadcast_to(out["yc"][:, None], (ny, nx)).copy()
    return out


def read_pop_grid_nc(grid_file: str, kmt_file: str | None = None,
                     varmap: dict | None = None):
    """Read a POP grid from netCDF (ice_grid.F90:659-874 popgrid_nc).

    Default variable names follow the reference: ulat/ulon (radians),
    htn/hte (cm), angle (radians), kmt. Returns the same dict layout as
    read_pop_grid_binary (HTN/HTE converted to meters)."""
    names = {"ULAT": "ulat", "ULON": "ulon", "HTN": "htn", "HTE": "hte",
             "ANGLE": "angle", "kmt": "kmt"}
    if varmap:
        names.update(varmap)
    out = {}
    for key in ("ULAT", "ULON", "HTN", "HTE", "ANGLE"):
        arr = read_netcdf_field(grid_file, names[key])
        if key in ("HTN", "HTE"):
            arr = arr * 0.01          # cm -> m
        out[key] = np.asarray(arr, np.float64)
    kpath = kmt_file or grid_file
    out["kmt"] = np.asarray(read_netcdf_field(kpath, names["kmt"]))
    return out
