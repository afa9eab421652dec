"""Runtime diagnostics: global conservation budgets (PyTorch port of
``cice5_tpu/io/diagnostics.py``).

ice_diagnostics.F90 runtime_diags (:103) + total_energy/total_salt
(:1038/:1124): hemispheric area/extent/volume/energy sums, printed every
diagfreq steps. ``compute_diags`` stays on the device and returns 0-d
tensors; ``format_diags``, ``check_state`` and the point dumps read the
device on the host, between steps, never inside a captured step; so do
the brine and skeletal-BGC point diagnostics (``hbrine_diags``,
``bgc_diags``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.utils import to_host as _g


class GlobalDiags(NamedTuple):
    arean: torch.Tensor     # total ice area N hemisphere (m^2)
    areas: torch.Tensor
    extentn: torch.Tensor   # area where aice > 0.15
    extents: torch.Tensor
    volumen: torch.Tensor   # ice volume (m^3)
    volumes: torch.Tensor
    snwvlmn: torch.Tensor
    snwvlms: torch.Tensor
    etotn: torch.Tensor     # total ice+snow energy (J)
    etots: torch.Tensor
    salt: torch.Tensor      # total salt content (kg)
    umax: torch.Tensor      # max ice speed (m/s)
    amax: torch.Tensor


def compute_diags(state, grid, tr, nilyr, nslyr) -> GlobalDiags:
    aice = state.aicen.sum(0)
    vice = state.vicen.sum(0)
    vsno = state.vsnon.sum(0)

    qice = state.trcrn[:, tr.nt_qice:tr.nt_qice + nilyr]
    qsno = state.trcrn[:, tr.nt_qsno:tr.nt_qsno + nslyr]
    sice = state.trcrn[:, tr.nt_sice:tr.nt_sice + nilyr]
    eice = (qice.sum(1) * state.vicen / nilyr).sum(0)
    esno = (qsno.sum(1) * state.vsnon / nslyr).sum(0)
    salt = (sice.sum(1) * state.vicen / nilyr).sum(0) * ct.rhoi * 0.001

    an, as_ = grid.tarean, grid.tareas
    ext = (aice > 0.15).to(aice.dtype)
    speed = torch.sqrt(state.uvel ** 2 + state.vvel ** 2)
    return GlobalDiags(
        arean=(aice * an).sum(), areas=(aice * as_).sum(),
        extentn=(ext * an).sum(), extents=(ext * as_).sum(),
        volumen=(vice * an).sum(), volumes=(vice * as_).sum(),
        snwvlmn=(vsno * an).sum(), snwvlms=(vsno * as_).sum(),
        etotn=((eice + esno) * an).sum(),
        etots=((eice + esno) * as_).sum(),
        salt=(salt * (an + as_)).sum(),
        umax=speed.max(), amax=aice.max())


def format_diags(istep: int, d: GlobalDiags) -> str:
    """Text block in the spirit of runtime_diags' log output; one copy of
    the 13 values to the host."""
    g = dict(zip(d._fields, _g(torch.stack(
        [x.to(torch.float64) for x in d])).tolist()))
    return (
        f"istep {istep:8d} "
        f"| area N/S {g['arean']:.4e}/{g['areas']:.4e} m^2 "
        f"| extent N/S {g['extentn']:.4e}/{g['extents']:.4e} m^2 "
        f"| volume N/S {g['volumen']:.4e}/{g['volumes']:.4e} m^3 "
        f"| snow N/S {g['snwvlmn']:.3e}/{g['snwvlms']:.3e} "
        f"| energy {g['etotn'] + g['etots']:.6e} J "
        f"| salt {g['salt']:.4e} kg "
        f"| max|u| {g['umax']:.3f} m/s | max aice {g['amax']:.3f}")


def print_state(state, grid, tr, nilyr, nslyr, j: int, i: int,
                label: str = "") -> str:
    """Full column dump at one grid point (print_state,
    ice_diagnostics.F90:1331 — the point-debug hook)."""
    col = lambda x: _g(x[..., j, i])
    aicen, vicen, vsnon = col(state.aicen), col(state.vicen), \
        col(state.vsnon)
    trcrn = col(state.trcrn)
    lines = [f"--- print_state {label} at (j={j}, i={i}) "
             f"lat={float(grid.TLAT[j, i]) * 57.29578:.2f} "
             f"lon={float(grid.TLON[j, i]) * 57.29578:.2f} ---"]
    for n in range(aicen.shape[0]):
        lines.append(f"cat {n}: aicen {float(aicen[n]):.5f} vicen "
                     f"{float(vicen[n]):.5f} vsnon {float(vsnon[n]):.5f} "
                     f"Tsfc {float(trcrn[n, tr.nt_Tsfc]):.3f}")
        qi = [float(trcrn[n, tr.nt_qice + k]) for k in range(nilyr)]
        lines.append("   qice: " + " ".join(f"{q:.3e}" for q in qi))
    lines.append(f"uvel {float(col(state.uvel)):.4f} "
                 f"vvel {float(col(state.vvel)):.4f} "
                 f"sst {float(col(state.sst)):.3f}")
    return "\n".join(lines)


def check_state(state, grid, tr, nilyr, nslyr, istep=None, log=print):
    """Failure detection (the debug_ice / print_points_state hook,
    ice_diagnostics.F90:1331-1601 + drivers/cice/CICE.F90:76): scan the
    state for NaN/Inf or physically impossible values; on failure print the
    full column state of the worst cell and return False.

    Host-side: call between steps."""
    checks = [
        ("aicen", _g(state.aicen), -1e-6, 1.0 + 1e-6),
        ("vicen", _g(state.vicen), -1e-6, 100.0),
        ("vsnon", _g(state.vsnon), -1e-6, 50.0),
        ("uvel", _g(state.uvel), -5.0, 5.0),
        ("vvel", _g(state.vvel), -5.0, 5.0),
        ("Tsfc", _g(state.trcrn[:, tr.nt_Tsfc]), -100.0, 1e-6),
    ]
    for name, arr, lo, hi in checks:
        bad = ~np.isfinite(arr) | (arr < lo) | (arr > hi)
        if bad.any():
            idx = np.argwhere(bad)[0]
            j, i = int(idx[-2]), int(idx[-1])
            pre = f"istep {istep}: " if istep is not None else ""
            log(f"{pre}check_state FAILED: {name}"
                f"[{','.join(map(str, idx))}] = {arr[tuple(idx)]}"
                f" outside [{lo}, {hi}]")
            log(print_state(state, grid, tr, nilyr, nslyr, j, i,
                            label=f"bad cell ({j},{i})"))
            return False
    return True


def nearest_point(grid, lat_deg: float, lon_deg: float):
    """(j, i) of the ocean T-cell nearest a (lat, lon) in degrees — the
    latpnt/lonpnt diagnostic-point lookup (init_diags,
    ice_diagnostics.F90:931-1020 region)."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg) % (2.0 * np.pi)
    TLAT = _g(grid.TLAT)
    TLON = _g(grid.TLON) % (2.0 * np.pi)
    dlon = np.abs(TLON - lon)
    dlon = np.minimum(dlon, 2.0 * np.pi - dlon)
    # chord distance on the sphere, land masked out
    d2 = (TLAT - lat) ** 2 + (np.cos(lat) * dlon) ** 2
    d2 = np.where(_g(grid.hm) > 0.5, d2, np.inf)
    j, i = np.unravel_index(int(np.argmin(d2)), d2.shape)
    return int(j), int(i)


def print_points_state(state, grid, tr, nilyr, nslyr, latpnts, lonpnts,
                       label: str = "") -> str:
    """Column dumps at the diagnostic points nearest each (lat, lon) pair
    (print_points_state, ice_diagnostics.F90:1466)."""
    blocks = []
    for lat, lon in zip(latpnts, lonpnts):
        j, i = nearest_point(grid, lat, lon)
        blocks.append(print_state(state, grid, tr, nilyr, nslyr, j, i,
                                  label=f"{label} pnt({lat},{lon})"))
    return "\n".join(blocks)


def hbrine_diags(state, grid, tr, nilyr, latpnts, lonpnts,
                 darcy_V=None) -> str:
    """Dynamic-brine-height point diagnostics (hbrine_diags,
    ice_brine.F90:730-828): cell-mean and category-1 brine fraction
    hbri/hice, the Darcy velocity (when given) and the salinity profile at
    each diagnostic point."""
    if tr.nt_fbri < 0:
        return "hbrine_diags: brine-height tracer inactive"
    aicen = _g(state.aicen)
    vicen = _g(state.vicen)
    trcrn = _g(state.trcrn)
    dv = None if darcy_V is None else _g(darcy_V)
    lines = []
    for lat, lon in zip(latpnts, lonpnts):
        j, i = nearest_point(grid, lat, lon)
        a = aicen[:, j, i]
        v = vicen[:, j, i]
        fbri = trcrn[:, tr.nt_fbri, j, i]
        vice = v.sum()
        # hbrine/hice ratios (the reference's phinS/phinS1)
        phinS = (fbri * v).sum() / vice if vice > 0 else 0.0
        phinS1 = fbri[0] if a[0] > 0 else 0.0
        sin = trcrn[:, tr.nt_sice:tr.nt_sice + nilyr, j, i]
        smean = (sin * v[:, None]).sum(0) / vice if vice > 0 else sin[0] * 0
        lines.append(
            f"hbrine pnt({lat},{lon}) (j,i)=({j},{i}): "
            f"hbri/hi cell {phinS:.4f} cat1 {phinS1:.4f}"
            + (f" darcy_V {dv[j, i]:.3e} m/s" if dv is not None else "")
            + " | Sin " + " ".join(f"{s:.3f}" for s in smean))
    return "\n".join(lines)


def bgc_diags(state, grid, tr, latpnts, lonpnts, ocean_bio=None,
              flux_bio=None) -> str:
    """Skeletal-BGC point diagnostics (bgc_diags, ice_algae.F90:937-1132):
    the area-mean skeletal concentration of each tracer and, when given,
    its ocean concentration and ice-ocean flux at each diagnostic point
    (``ocean_bio``/``flux_bio``: tracer name -> (ny, nx) array or
    tensor)."""
    if not tr.nt_bgc:
        return "bgc_diags: skeletal BGC inactive"
    aicen = _g(state.aicen)
    trcrn = _g(state.trcrn)
    lines = []
    for lat, lon in zip(latpnts, lonpnts):
        j, i = nearest_point(grid, lat, lon)
        a = aicen[:, j, i]
        asum = max(a.sum(), 1e-30)
        parts = []
        for name, slot in zip(tr.bgc_names, tr.nt_bgc):
            conc = (trcrn[:, slot, j, i] * a).sum() / asum
            s = f"{name} {conc:.4e}"
            if ocean_bio is not None:
                s += f"/{_g(ocean_bio[name])[j, i]:.4e}"
            if flux_bio is not None:
                s += f" flux {_g(flux_bio[name])[j, i]:.3e}"
            parts.append(s)
        lines.append(f"bgc pnt({lat},{lon}) (j,i)=({j},{i}): "
                     + " | ".join(parts))
    return "\n".join(lines)
