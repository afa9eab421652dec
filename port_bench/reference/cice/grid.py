"""Model grid: metrics, masks, staggering (PyTorch port).

The NumPy builders ``_shift``, ``_tlatlon``, ``_finish_grid`` and
``popgrid_np`` (ice_grid.F90:543-874 popgrid, :1408-1533 metric
derivation, the tripole seam umask from the fold image) build the grid
from POP arrays. They run once on the host in float64 NumPy, and ``Grid`` holds the results as tensors on
the model's device. Axis 0 = j/latitude rows, axis 1 = i/longitude columns; the U
point (i, j) is the NE corner of T cell (i, j):

    dxu(i,j) = 1/2 (HTN(i,j) + HTN(i+1,j))     dxt(i,j) = 1/2 (HTN(i,j) + HTN(i,j-1))
    dyu(i,j) = 1/2 (HTE(i,j) + HTE(i,j+1))     dyt(i,j) = 1/2 (HTE(i,j) + HTE(i-1,j))
"""
from __future__ import annotations

import numpy as np
import torch

from reference.cice.config import GridConfig, ModelConfig
from reference.cice.utils import tensorclass
from reference.cice import constants as ct


@tensorclass
class Grid:
    """Grid metric/mask pytree (all (ny, nx), model dtype unless noted)."""
    ULAT: torch.Tensor      # U-point latitude (radians)
    ULON: torch.Tensor
    TLAT: torch.Tensor      # T-point latitude (radians)
    TLON: torch.Tensor
    HTN: torch.Tensor       # T-cell north edge length (m)
    HTE: torch.Tensor       # T-cell east edge length (m)
    dxt: torch.Tensor
    dyt: torch.Tensor
    dxu: torch.Tensor
    dyu: torch.Tensor
    tarea: torch.Tensor
    uarea: torch.Tensor
    tarear: torch.Tensor
    uarear: torch.Tensor
    tinyarea: torch.Tensor
    dxhy: torch.Tensor
    dyhx: torch.Tensor
    cxp: torch.Tensor
    cyp: torch.Tensor
    cxm: torch.Tensor
    cym: torch.Tensor
    ANGLE: torch.Tensor     # U-point rotation to geographic (radians)
    ANGLET: torch.Tensor    # T-point rotation
    hm: torch.Tensor        # T-cell ocean mask (1=ocean, 0=land), float
    uvm: torch.Tensor       # U-cell ocean mask, float
    tmask: torch.Tensor     # bool
    umask: torch.Tensor     # bool
    tarean: torch.Tensor    # N-hemisphere masked T area (m^2)
    tareas: torch.Tensor    # S-hemisphere masked T area
    fcor: torch.Tensor      # Coriolis parameter at U points (1/s)

    @property
    def shape(self):
        return self.hm.shape


def _shift(a: np.ndarray, di: int, dj: int, cyclic_x: bool,
           edge: str = "replicate") -> np.ndarray:
    """a[j + dj, i + di] with edge replication (or linear extrapolation,
    the ice_HaloExtrapolate semantics) in y and (optionally) cyclic x."""
    out = np.roll(a, (-dj, -di), axis=(0, 1))
    ex = edge == "extrapolate"
    if dj > 0:
        out[-dj:, :] = (2.0 * a[-1:, :] - a[-2:-1, :]) if ex else a[-1:, :]
    elif dj < 0:
        out[:-dj, :] = (2.0 * a[:1, :] - a[1:2, :]) if ex else a[:1, :]
    if not cyclic_x:
        if di > 0:
            out[:, -di:] = (2.0 * a[:, -1:] - a[:, -2:-1]) if ex \
                else a[:, -1:]
        elif di < 0:
            out[:, :-di] = (2.0 * a[:, :1] - a[:, 1:2]) if ex else a[:, :1]
    return out


def _tlatlon(ulat: np.ndarray, ulon: np.ndarray, cyclic_x: bool):
    """T-point lat/lon as the Cartesian mean of the 4 surrounding U corners
    (ice_grid.F90 Tlatlon). Edge ghosts use the linear extrapolation the
    reference applies to ULAT/ULON before Tlatlon (ice_HaloExtrapolate,
    ice_grid.F90:780-816)."""
    z = np.sin(ulat)
    x = np.cos(ulon) * np.cos(ulat)
    y = np.sin(ulon) * np.cos(ulat)

    def corner_avg(q):
        return 0.25 * (q + _shift(q, -1, 0, cyclic_x, "extrapolate")
                       + _shift(q, 0, -1, cyclic_x, "extrapolate")
                       + _shift(q, -1, -1, cyclic_x, "extrapolate"))

    tx, ty, tz = corner_avg(x), corner_avg(y), corner_avg(z)
    da = np.sqrt(tx * tx + ty * ty + tz * tz)
    tz = np.where(da > 0, tz / np.maximum(da, 1e-300), 0.0)
    tlat = np.arcsin(np.clip(tz, -1.0, 1.0))
    tlon = np.arctan2(ty, tx)
    return tlat, tlon


def _finish_grid(gcfg: GridConfig, ulat, ulon, htn, hte, angle, hm,
                 dtype, device) -> Grid:
    """Derive all secondary metrics from (ULAT, ULON, HTN, HTE, ANGLE, hm)."""
    cyc = gcfg.ew_boundary == "cyclic"
    sh = lambda a, di, dj: _shift(a, di, dj, cyc)

    # primary_grid_lengths_HTN/HTE (ice_grid.F90:1409-1545): cyclic-x wrap for
    # dxu/dyt; dxt extrapolated along the south row and dyu along the north row
    dxu = 0.5 * (htn + sh(htn, 1, 0))
    dxt = 0.5 * (htn + sh(htn, 0, -1))
    dxt[0, :] = 2.0 * htn[1, :] - htn[2, :]          # j=1 extrap (:1462)
    dyu = 0.5 * (hte + sh(hte, 0, 1))
    dyu[-1, :] = 2.0 * hte[-2, :] - hte[-3, :]       # j=ny extrap (:1517)
    dyt = 0.5 * (hte + sh(hte, -1, 0))
    if not cyc:
        dyt[:, 0] = 0.5 * (hte[:, 0] + (2.0 * hte[:, 1] - hte[:, 2]))

    tarea = dxt * dyt
    uarea = dxu * dyu
    tarear = np.where(tarea > 0, 1.0 / np.maximum(tarea, 1e-300), 0.0)
    uarear = np.where(uarea > 0, 1.0 / np.maximum(uarea, 1e-300), 0.0)
    tinyarea = ct.puny * tarea

    dxhy = 0.5 * (hte - sh(hte, -1, 0))
    dyhx = 0.5 * (htn - sh(htn, 0, -1))
    cyp = 1.5 * hte - 0.5 * sh(hte, -1, 0)
    cxp = 1.5 * htn - 0.5 * sh(htn, 0, -1)
    cym = -(1.5 * sh(hte, -1, 0) - 0.5 * hte)
    cxm = -(1.5 * sh(htn, 0, -1) - 0.5 * htn)

    # U mask from the 4 surrounding T cells (ice_grid.F90:1589-1592).
    # Tripole north seam: the row-above ghost is the FOLD image
    # hm(nx-1-i, ny-1) (U-fold center mapping, mpi/ice_boundary.F90:1494;
    # the reference's makemask runs after bound() fills tripole ghosts).
    # With a replicate ghost the top-row umask violates the fold
    # self-conjugacy umask(i) == umask(nx-2-i) wherever land meets the
    # seam, which makes the seam ill-posed: the per-subcycle EVP re-
    # symmetrizes the seam row every exchange and hides it, while the
    # chunked (margin-decay) EVP evolves the inconsistency — they then
    # disagree at the seam next to land.
    hm_n = sh(hm, 0, 1)
    hm_ne = sh(hm, 1, 1)
    if gcfg.ns_boundary == "tripole":
        fold = hm[-1, ::-1]                     # ghost(i) = hm(nx-1-i)
        hm_n = hm_n.copy()
        hm_ne = hm_ne.copy()
        hm_n[-1, :] = fold
        hm_ne[-1, :] = np.roll(fold, -1)        # ghost(i+1)
    uvm = np.minimum.reduce([hm, sh(hm, 1, 0), hm_n, hm_ne])
    tmask = hm > 0.5
    umask = uvm > 0.5

    # ANGLET: 4-corner average of ANGLE with branch-cut handling
    # (ice_grid.F90:440-460); rectgrid has ANGLE=0 so this is exact there too.
    a0 = angle
    aw = sh(angle, -1, 0)
    as_ = sh(angle, 0, -1)
    asw = sh(angle, -1, -1)
    neg = a0 < 0.0
    fix = lambda q: np.where(neg & (np.abs(q - a0) > np.pi), q - 2 * np.pi, q)
    anglet = 0.25 * (a0 + fix(aw) + fix(as_) + fix(asw))

    tlat, tlon = _tlatlon(ulat, ulon, cyc)

    lmask_n = ulat >= -ct.puny
    tarean = np.where(lmask_n, tarea * hm, 0.0)
    tareas = np.where(~lmask_n, tarea * hm, 0.0)
    fcor = 2.0 * ct.omega * np.sin(ulat)

    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                     device=device)
    return Grid(
        ULAT=cast(ulat), ULON=cast(ulon), TLAT=cast(tlat), TLON=cast(tlon),
        HTN=cast(htn), HTE=cast(hte), dxt=cast(dxt), dyt=cast(dyt),
        dxu=cast(dxu), dyu=cast(dyu), tarea=cast(tarea), uarea=cast(uarea),
        tarear=cast(tarear), uarear=cast(uarear), tinyarea=cast(tinyarea),
        dxhy=cast(dxhy), dyhx=cast(dyhx), cxp=cast(cxp), cyp=cast(cyp),
        cxm=cast(cxm), cym=cast(cym), ANGLE=cast(angle), ANGLET=cast(anglet),
        hm=cast(hm), uvm=cast(uvm),
        tmask=torch.as_tensor(tmask, device=device),
        umask=torch.as_tensor(umask, device=device),
        tarean=cast(tarean), tareas=cast(tareas), fcor=cast(fcor),
    )


def popgrid_np(cfg: ModelConfig, ulat, ulon, htn, hte, angle, kmt, *,
               device) -> Grid:
    """Build a Grid from POP-style global arrays already on the host
    (the reader side of ice_grid.F90:543-874 popgrid/popgrid_nc: ULAT/ULON
    in radians, HTN/HTE in meters, ANGLE in radians, KMT levels)."""
    hm = (np.asarray(kmt) >= 1).astype(np.float64)
    # the reference clamps the file ANGLE into [-pi, pi] (:797-798)
    angle = np.clip(np.asarray(angle, np.float64), -np.pi, np.pi)
    return _finish_grid(cfg.grid, np.asarray(ulat), np.asarray(ulon),
                        np.asarray(htn), np.asarray(hte), angle, hm,
                        cfg.xp_dtype, device)
