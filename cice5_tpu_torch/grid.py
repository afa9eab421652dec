"""Model grid: metrics, masks, staggering (PyTorch port).

The NumPy builders ``_shift``, ``_tlatlon``, ``_finish_grid``,
``rectgrid``, ``popgrid_np``, ``popgrid``, ``latlongrid``,
``gridbox_corners`` and ``make_grid`` are copies of ``cice5_tpu/grid.py``
(ice_grid.F90:1145-1303 rectgrid, :543-874 popgrid, :876-1141 latlongrid,
:1313 cpomgrid, :1408-1533 metric derivation, the tripole seam umask from
the fold image, :1972 gridbox_corners); ``_gx1_kmt`` and
``synth_gx1_grid`` are copies of ``bench.py``'s gx1 grid. They run once on
the host in float64 NumPy, and ``Grid`` holds the results as tensors on
the model's device. Axis 0 = j/latitude rows, axis 1 = i/longitude columns; the U
point (i, j) is the NE corner of T cell (i, j):

    dxu(i,j) = 1/2 (HTN(i,j) + HTN(i+1,j))     dxt(i,j) = 1/2 (HTN(i,j) + HTN(i,j-1))
    dyu(i,j) = 1/2 (HTE(i,j) + HTE(i,j+1))     dyt(i,j) = 1/2 (HTE(i,j) + HTE(i-1,j))
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cice5_tpu_torch.config import GridConfig, ModelConfig
from cice5_tpu_torch.utils import tensorclass
from cice5_tpu_torch import constants as ct


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


def rectgrid(cfg: ModelConfig, land_mask: np.ndarray | None = None, *,
             device) -> Grid:
    """Regular rectangular grid (ice_grid.F90:1145-1303 rectgrid).

    Default land mask follows the reference: for cyclic-EW the top/bottom two
    rows are land and the rest ocean; ``land_mask`` (1=ocean) overrides.
    """
    g = cfg.grid
    ny, nx = g.ny, g.nx
    dlon = g.dx_const / ct.radius * ct.rad_to_deg
    dlat = g.dy_const / ct.radius * ct.rad_to_deg
    ulon = (g.lon0 + dlon * np.arange(nx))[None, :] * np.ones((ny, 1))
    ulat = (g.lat0 + dlat * np.arange(ny))[:, None] * np.ones((1, nx))
    # large test domains from the Barrow origin would march past the pole;
    # clamp (ULAT only feeds fcor, hemisphere masks, and coszen — the metric
    # arrays are constant on rectgrid)
    ulat = np.minimum(ulat, 89.99)
    ulon = np.deg2rad(ulon)
    ulat = np.deg2rad(ulat)

    htn = np.full((ny, nx), g.dx_const)
    hte = np.full((ny, nx), g.dy_const)
    angle = np.zeros((ny, nx))

    if land_mask is None:
        hm = np.zeros((ny, nx))
        if g.grid_type == "column":
            hm[:, :] = 1.0   # all ocean for single-column testing
        elif g.ew_boundary == "cyclic":
            hm[2:ny - 2, :] = 1.0
        else:
            hm[2:ny - 2, 2:nx - 2] = 1.0
    else:
        hm = np.asarray(land_mask, np.float64)

    return _finish_grid(g, ulat, ulon, htn, hte, angle, hm, cfg.xp_dtype,
                        device)


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


REARTH = 6.37e6
# the gx1 land mask (big-endian int32 KMT levels, 384x320) where the
# repository carries it; it does not yet, so synth_gx1_grid uses polar
# land bands instead
GX1_KMT = Path(__file__).resolve().parents[1] / "input_templates" / "gx1" \
    / "global_gx1.kmt"


def _gx1_kmt():
    if GX1_KMT.exists():
        return np.fromfile(GX1_KMT, dtype=">i4").reshape(384, 320)
    kmt = np.ones((384, 320), np.int32)   # fallback: polar land bands
    kmt[:8] = 0
    return kmt


def synth_global_arrays(kmt):
    """(ULAT, ULON, HTN, HTE, ANGLE, KMT) of bench.py's synthetic global
    mesh on the shape of ``kmt``: latitudes uniform from 79S to 89N,
    longitudes uniform and cyclic, zonal cell widths shrinking poleward
    (clamped at 3 km); ULAT/ULON in radians, as popgrid_np takes them."""
    ny, nx = kmt.shape
    lat = np.linspace(-79.0, 89.0, ny)
    dlat = lat[1] - lat[0]
    ulat = np.broadcast_to(lat[:, None], (ny, nx)).copy()
    ulon = np.broadcast_to(
        np.linspace(0.0, 2 * np.pi, nx, endpoint=False)[None, :],
        (ny, nx)).copy()
    htn = np.maximum(2 * np.pi * REARTH * np.cos(np.deg2rad(ulat)) / nx,
                     3.0e3)
    hte = np.full((ny, nx), REARTH * np.deg2rad(dlat))
    return np.deg2rad(ulat), ulon, htn, hte, np.zeros((ny, nx)), kmt


def synth_gx1_grid(cfg: ModelConfig, *, device) -> Grid:
    """The synthetic global mesh carrying the gx1 land mask (bench.py
    synth_gx1_grid); other shapes than 384x320 resample the KMT
    nearest-neighbour. The seam is the configuration's north boundary
    (tripole for gx1_parity_config)."""
    ny, nx = cfg.grid.ny, cfg.grid.nx
    kmt = _gx1_kmt()
    if kmt.shape != (ny, nx):
        jj = (np.arange(ny) * kmt.shape[0] // ny)
        ii = (np.arange(nx) * kmt.shape[1] // nx)
        kmt = kmt[jj][:, ii]
    return popgrid_np(cfg, *synth_global_arrays(kmt), device=device)


def popgrid(cfg: ModelConfig, *, device) -> Grid:
    """Read + build a POP displaced-pole/tripole grid from the files named
    in cfg.grid (ice_grid.F90:543 popgrid, :659 popgrid_nc)."""
    from cice5_tpu_torch.io import readers
    g = cfg.grid
    if not g.grid_file or not g.kmt_file:
        raise ValueError(
            f"grid_type={g.grid_type!r} needs grid_file/kmt_file in "
            "GridConfig")
    if g.grid_format == "nc":
        data = readers.read_pop_grid_nc(g.grid_file, g.kmt_file)
    else:
        data = readers.read_pop_grid_binary(g.grid_file, g.kmt_file,
                                            g.nx, g.ny)
    got = data["ULAT"].shape
    if got != (g.ny, g.nx):
        raise ValueError(f"grid file {g.grid_file} is {got[::-1]} (nx, ny) "
                         f"but config says ({g.nx}, {g.ny})")
    return popgrid_np(cfg, data["ULAT"], data["ULON"], data["HTN"],
                      data["HTE"], data["ANGLE"], data["kmt"], device=device)


SENTINEL = 1.0e36      # latlongrid metric sentinel (ice_grid.F90:1118-1131)


def latlongrid(cfg: ModelConfig, tlat_deg, tlon_deg, tarea_rad2, mask, *,
               device) -> Grid:
    """CESM/CAM latitude-longitude grid for thermodynamics-only runs
    (ice_grid.F90:876-1141 latlongrid): TLON/TLAT + cell areas from a CESM
    domain file; the U grid is unused (its metrics are 1e36 sentinels, so
    dynamics must be off, kdyn=0), and ULAT is TLAT shifted by half a row
    so that the default initialization finds ice."""
    ny, nx = np.asarray(tlat_deg).shape
    dtype = cfg.xp_dtype
    tlat = np.deg2rad(np.asarray(tlat_deg, np.float64))
    tlon = np.deg2rad(np.asarray(tlon_deg, np.float64))
    tarea = np.asarray(tarea_rad2, np.float64) * ct.radius ** 2
    hm = (np.asarray(mask) >= 0.5).astype(np.float64)

    sh = lambda a, di, dj: _shift(a, di, dj, False)
    if ny == 1:
        uarea = tarea.copy()
        ulat = tlat.copy()
    else:
        uarea = 0.25 * (tarea + sh(tarea, 1, 0) + sh(tarea, 0, 1)
                        + sh(tarea, 1, 1))
        ulat = tlat + np.pi / ny
    uvm = np.minimum.reduce([hm, sh(hm, 1, 0), sh(hm, 0, 1), sh(hm, 1, 1)])
    z = np.zeros((ny, nx))
    big = np.full((ny, nx), SENTINEL)
    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                     device=device)
    lmask_n = ulat >= -ct.puny
    return Grid(
        ULAT=cast(ulat), ULON=cast(z), TLAT=cast(tlat), TLON=cast(tlon),
        HTN=cast(big), HTE=cast(big), dxt=cast(big), dyt=cast(big),
        dxu=cast(big), dyu=cast(big), tarea=cast(tarea), uarea=cast(uarea),
        tarear=cast(1.0 / tarea), uarear=cast(1.0 / uarea),
        tinyarea=cast(ct.puny * tarea),
        dxhy=cast(big), dyhx=cast(big), cxp=cast(big), cyp=cast(big),
        cxm=cast(big), cym=cast(big), ANGLE=cast(z), ANGLET=cast(z),
        hm=cast(hm), uvm=cast(uvm),
        tmask=torch.as_tensor(hm > 0.5, device=device),
        umask=torch.as_tensor(uvm > 0.5, device=device),
        tarean=cast(np.where(lmask_n, tarea * hm, 0.0)),
        tareas=cast(np.where(~lmask_n, tarea * hm, 0.0)),
        fcor=cast(2.0 * ct.omega * np.sin(ulat)))


def gridbox_corners(grid: Grid) -> tuple:
    """Per-cell corner longitudes/latitudes for history cell bounds
    (ice_grid.F90:1972-2121 gridbox_corners): corner order NE, NW, SW, SE
    from the U (NE-corner) coordinates. Returns (lont_bounds,
    latt_bounds), each (4, ny, nx) NumPy arrays in degrees."""
    ulat = np.rad2deg(grid.ULAT.detach().cpu().numpy().astype(np.float64))
    ulon = np.rad2deg(grid.ULON.detach().cpu().numpy().astype(np.float64))
    sh = lambda a, di, dj: _shift(a, di, dj, True)
    latb = np.stack([ulat, sh(ulat, -1, 0), sh(ulat, -1, -1),
                     sh(ulat, 0, -1)])
    lonb = np.stack([ulon, sh(ulon, -1, 0), sh(ulon, -1, -1),
                     sh(ulon, 0, -1)])
    return lonb, latb


def make_grid(cfg: ModelConfig, *, device, **kw) -> Grid:
    """The grid of ``cfg.grid.grid_type``: rectangular and column grids
    built here; displaced_pole and tripole grids read from POP files
    (netCDF or binary), cpom from CPOM binary files, latlon from a CESM
    domain file (``io/readers.py``)."""
    t = cfg.grid.grid_type
    if t in ("rectangular", "column"):
        return rectgrid(cfg, device=device, **kw)
    if t in ("displaced_pole", "tripole"):
        return popgrid(cfg, device=device)
    from cice5_tpu_torch.io import readers
    g = cfg.grid
    if t == "latlon":
        d = readers.read_latlon_domain(g.grid_file or g.kmt_file)
        return latlongrid(cfg, d["yc"], d["xc"], d["area"], d["mask"],
                          device=device)
    if t == "cpom":
        data = readers.read_cpom_grid_binary(g.grid_file, g.kmt_file,
                                             g.nx, g.ny)
        return popgrid_np(cfg, data["ULAT"], data["ULON"], data["HTN"],
                          data["HTE"], data["ANGLE"], data["kmt"],
                          device=device)
    raise NotImplementedError(f"grid_type={t}")
