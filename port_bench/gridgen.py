"""The grid inputs the benchmark hands to the port and to the reference.

A frozen copy of the arithmetic of the port's ``grid.synth_global_arrays``
and ``synth_gx1_grid`` (bench.py's synthetic gx1 mesh): the POP arrays
(ULAT, ULON, HTN, HTE, ANGLE, KMT) of a global mesh with uniform latitudes
and cyclic longitudes, zonal cell widths shrinking poleward and clamped
at a floor, and a land mask of polar bands on a 384x320 KMT, resampled
nearest-neighbour to other shapes. Both sides derive every metric, mask
and coordinate from these arrays themselves.
"""
from __future__ import annotations

import numpy as np


def kmt(spec: dict, ny: int, nx: int) -> np.ndarray:
    """The KMT levels (ny, nx) that ``spec`` names."""
    if spec["kmt"] != "polar_land_bands":
        raise ValueError(f"unknown KMT {spec['kmt']!r}")
    ky, kx = spec["kmt_shape"]
    k = np.ones((ky, kx), np.int32)
    k[:spec["kmt_land_rows"]] = 0
    if (ky, kx) != (ny, nx):
        jj = np.arange(ny) * ky // ny
        ii = np.arange(nx) * kx // nx
        k = k[jj][:, ii]
    return k


def pop_arrays(spec: dict, ny: int, nx: int):
    """(ULAT, ULON, HTN, HTE, ANGLE, KMT): latitudes and longitudes in
    radians, edge lengths in metres, float64 host arrays."""
    if spec["mesh"] != "synth_global":
        raise ValueError(f"unknown mesh {spec['mesh']!r}")
    radius = spec["earth_radius_m"]
    lat = np.linspace(spec["lat_south_deg"], spec["lat_north_deg"], ny)
    dlat = lat[1] - lat[0]
    ulat = np.broadcast_to(lat[:, None], (ny, nx)).copy()
    ulon = np.broadcast_to(
        np.linspace(0.0, 2 * np.pi, nx, endpoint=False)[None, :],
        (ny, nx)).copy()
    htn = np.maximum(2 * np.pi * radius * np.cos(np.deg2rad(ulat)) / nx,
                     spec["min_dx_m"])
    hte = np.full((ny, nx), radius * np.deg2rad(dlat))
    return (np.deg2rad(ulat), ulon, htn, hte, np.zeros((ny, nx)),
            kmt(spec, ny, nx))
