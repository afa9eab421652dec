"""Ghost rings on one device or a mesh of ranks (PyTorch port of
``cice5_tpu/parallel/halo.py``).

A field never stores ghost cells; ``extend(field, topo)`` returns the field
with a ghost ring filled by the global boundary conditions
(mpi/ice_boundary.F90 ice_HaloUpdate): cyclic boundaries wrap, open and
closed boundaries hold zeros (or, with ``open_fill="extrapolate"``, the
linear extrapolation of ice_HaloExtrapolate), and a tripole north seam
(``ns="tripole"`` U-fold, ``"tripoleT"`` T-fold) fills its ghost rows with
the fold image of the top rows (mpi/ice_boundary.F90:1494-1596), with the
staggering (``loc``) and parity (``kind``) of the field. The x-extension
happens first and whole extended rows are then added in y, so corners
follow the same rule as the JAX package.

On a mesh of ranks (``Topology.mesh``, ``parallel/mesh.py``) each rank
holds one tile, and the ring comes from its neighbours: one exchange per
mesh axis (``distributed.shift_pair``, the ppermute pairs of the JAX
package), zeros past a non-cyclic edge. The top row of ranks also
exchanges the top rows of its tiles within the row
(``distributed.row_gather``) and folds the global rows as one device
does, so a seam's ghosts and symmetrized top row equal the one-device
values bit for bit; the T-fold's self-image columns are global columns.
Every rank of the mesh must make the same calls in the same order.

All functions accept arbitrary leading batch axes: (..., ny, nx) ->
(..., ny+2W, nx+2W).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from reference.cice.constants import FieldLoc, FieldType
from reference.cice.parallel import distributed as pdist
from reference.cice.parallel.distributed import AXIS_X, AXIS_Y

_TRIPOLE = ("tripole", "tripoleT")


@dataclass(frozen=True)
class Topology:
    """How (ny, nx) arrays are laid out: the global boundary types
    ("cyclic" | "open" | "closed" | "tripole" | "tripoleT"), and the mesh
    of ranks whose tiles they are (None: one device holds the grid)."""
    ew: str = "cyclic"
    ns: str = "open"
    mesh: object = None

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def is_top(self) -> bool:
        """Does this device's array hold the global top row?"""
        return self.mesh is None or self.mesh.is_top


# fold (ioffset, joffset) per staggering (mpi/ice_boundary.F90:1494-1596):
# ghost(i, ny+1) = sign * field(nxGlobal+1-i-ioffset, ny-joffset)
_UFOLD_OFFSETS = {FieldLoc.CENTER: (0, 0), FieldLoc.NECORNER: (1, 1),
                  FieldLoc.EFACE: (1, 0), FieldLoc.NFACE: (0, 1)}
_TFOLD_OFFSETS = {FieldLoc.CENTER: (-1, 0), FieldLoc.NECORNER: (0, 1),
                  FieldLoc.EFACE: (0, 0), FieldLoc.NFACE: (-1, 1)}
# staggerings whose top physical row lies ON the fold (degenerate row that
# must be symmetrized with its own image)
_UFOLD_DEGEN = (FieldLoc.NECORNER, FieldLoc.NFACE)
_TFOLD_DEGEN = (FieldLoc.CENTER, FieldLoc.EFACE)


def _check(topo: Topology):
    if topo.ew in _TRIPOLE:
        raise NotImplementedError("a tripole east-west boundary does not "
                                  "exist (the fold is a north seam)")


def _fold_spec(topo: Topology, loc: FieldLoc, kind: FieldType):
    """(sign, ioff, joff, degenerate) of the fold for this staggering."""
    sign = -1.0 if kind in (FieldType.VECTOR, FieldType.ANGLE) else 1.0
    tfold = topo.ns == "tripoleT"
    ioff, joff = (_TFOLD_OFFSETS if tfold else _UFOLD_OFFSETS).get(loc,
                                                                   (0, 0))
    degen = loc in (_TFOLD_DEGEN if tfold else _UFOLD_DEGEN)
    return sign, ioff, joff, degen


def _fold_map(row, ioff: int):
    """Map column i -> nxGlobal+1-i-ioffset (1-based), i.e. 0-based
    i0 -> (nx-1-i0-ioff) mod nx."""
    g = torch.flip(row, dims=(-1,))
    return g if ioff == 0 else torch.roll(g, -ioff, dims=-1)


def _top_sym(f, ioff: int, sign: float):
    """Degenerate top row symmetrized with its own fold image. On the
    T-fold centre (ioff=-1) columns 0 and nx/2 are their own images; the
    reference loop (i=2..nx/2) leaves them untouched."""
    top = f[..., -1:, :]
    sym = 0.5 * (top + sign * _fold_map(top, ioff))
    if ioff == -1:
        nx = top.shape[-1]
        col = torch.arange(nx, device=f.device)
        selfmask = col == 0
        if nx % 2 == 0:
            selfmask = selfmask | (col == nx // 2)
        sym = torch.where(selfmask, top, sym)
    return sym


def _tripole_ghost_wide(f, topo: Topology, loc: FieldLoc, kind: FieldType,
                        W: int, fold_partner=None, fold_sign: float = 1.0):
    """W north ghost rows for the tripole fold: ghost row ny+k reads
    sign * field(nxGlobal+1-i-ioffset, ny-joffset-(k-1)).

    With ``fold_partner`` the caller supplies the ghost sources (sign
    ``fold_sign``) and a degenerate top row is used as it is. Returns
    (ghost (..., W, nx), symmetrized top row or None)."""
    sign, ioff, joff, degen = _fold_spec(topo, loc, kind)
    top_sym = None
    if degen and fold_partner is None:
        top_sym = _top_sym(f, ioff, sign)
    src = fold_partner if fold_partner is not None else f
    sgn = fold_sign if fold_partner is not None else sign
    ny = f.shape[-2]
    if ny < W + joff:
        raise ValueError(f"tripole wide fold needs ny >= W+joff "
                         f"({ny} < {W}+{joff})")
    rows = src[..., ny - joff - W:ny - joff, :]
    if top_sym is not None and joff == 0:
        # the k=1 source is the symmetrized top row (the reference
        # symmetrizes the tripole buffer before copy-out)
        rows = torch.cat([rows[..., :-1, :], top_sym], dim=-2)
    rows = torch.flip(rows, dims=(-2,))          # ghost order k = 1..W
    return sgn * _fold_map(rows, ioff), top_sym


def _fold_rows(f, topo: Topology, W: int, loc: FieldLoc, kind: FieldType,
               fold_partner=None, fold_sign: float = 1.0):
    """The tripole fold of a device's array: (the W north ghost rows,
    x-extended by W columns as the cyclic seam is, (..., W, nx+2W); the
    symmetrized top row or None). On a mesh only the top row of ranks
    calls it: it gathers the top rows of the row's tiles (and of the
    partner) and folds the global rows."""
    mesh = topo.mesh
    if mesh is not None:
        k = min(f.shape[-2], W + 1)        # rows ny-W-joff .. ny-1
        tops = [f[..., -k:, :]]
        if fold_partner is not None:
            tops.append(fold_partner[..., -k:, :])
        rows = pdist.row_gather(torch.stack(tops), mesh)
        f = rows[0]
        fold_partner = rows[1] if fold_partner is not None else None
    ghost, top_sym = _tripole_ghost_wide(f, topo, loc, kind, W,
                                         fold_partner=fold_partner,
                                         fold_sign=fold_sign)
    nx = ghost.shape[-1]
    i0, nt = 0, nx
    if mesh is not None:
        cols = mesh.slices()[1]
        i0, nt = cols.start, cols.stop - cols.start
        if top_sym is not None:
            top_sym = top_sym[..., i0:i0 + nt]
    ext = torch.cat([ghost, ghost, ghost], dim=-1)[
        ..., nx + i0 - W:nx + i0 + nt + W]
    return ext, top_sym


def _assemble(f, topo: Topology, W: int, tg_ext, open_fill: str = "zero"):
    """Ring of width W around f: x first, then whole extended rows in y
    (cyclic, zeros, or at W=1 the linear extrapolation of
    ``open_fill="extrapolate"`` at non-cyclic global edges); a tripole
    seam puts the x-extended fold rows ``tg_ext`` at the north edge of the
    top row of ranks."""
    mesh = topo.mesh
    cyc_x, cyc_y = topo.ew == "cyclic", topo.ns == "cyclic"
    extrap = open_fill == "extrapolate"
    if mesh is not None:
        wv, ev = pdist.shift_pair(f[..., :, :W], f[..., :, -W:], mesh,
                                  AXIS_X, cyc_x)
    elif cyc_x:
        wv, ev = f[..., :, -W:], f[..., :, :W]
    else:
        wv = torch.zeros_like(f[..., :, -W:])
        ev = torch.zeros_like(f[..., :, :W])
    if extrap and not cyc_x:
        if mesh is None or mesh.ix == 0:
            wv = 2.0 * f[..., :, :1] - f[..., :, 1:2]
        if mesh is None or mesh.ix == mesh.px - 1:
            ev = 2.0 * f[..., :, -1:] - f[..., :, -2:-1]
    fx = torch.cat([wv, f, ev], dim=-1)
    if mesh is not None:
        sv, nv = pdist.shift_pair(fx[..., :W, :], fx[..., -W:, :], mesh,
                                  AXIS_Y, cyc_y)
    elif cyc_y:
        sv, nv = fx[..., -W:, :], fx[..., :W, :]
    else:
        sv = torch.zeros_like(fx[..., -W:, :])
        nv = torch.zeros_like(fx[..., :W, :])
    if extrap and not cyc_y and topo.ns not in _TRIPOLE:
        if mesh is None or mesh.iy == 0:
            sv = 2.0 * fx[..., :1, :] - fx[..., 1:2, :]
        if topo.is_top:
            nv = 2.0 * fx[..., -1:, :] - fx[..., -2:-1, :]
    if tg_ext is not None:
        nv = tg_ext
    return torch.cat([sv, fx, nv], dim=-2)


def _with_top(f, top_sym):
    if top_sym is None:
        return f
    return torch.cat([f[..., :-1, :], top_sym], dim=-2)


def extend(f: torch.Tensor, topo: Topology,
           loc: FieldLoc = FieldLoc.CENTER,
           kind: FieldType = FieldType.SCALAR,
           open_fill: str = "zero",
           fold_partner: torch.Tensor | None = None,
           fold_sign: float = 1.0) -> torch.Tensor:
    """Add a 1-cell ghost ring: (..., ny, nx) -> (..., ny+2, nx+2).

    open_fill: what non-cyclic (open/closed) global-boundary ghosts hold:
    "zero" (the ice_HaloUpdate default fill) or "extrapolate" (ghost =
    2*edge - inner, ice_HaloExtrapolate, mpi/ice_boundary.F90:7070-7172;
    not at a tripole seam, whose north ghosts are the fold image).

    fold_partner/fold_sign: on tripole topologies, build the north ghost
    row from ``fold_sign * fold(fold_partner)`` instead of the field
    itself. The 180-degree fold maps one-sided metric coefficients onto
    their partners (ghost cyp = -cym of the image cell, cxp = -cxm,
    dxhy/dyhx negate; ice_grid.F90:356-367). On a degenerate (on-fold)
    staggering the ghost row is the partner's image of the top row and
    the field's own top row is kept as it is (the T-fold's CENTER metrics
    of the EVP region); the JAX package's ``extend`` raises there."""
    if open_fill not in ("zero", "extrapolate"):
        raise ValueError(f"open_fill={open_fill!r}: 'zero' or "
                         "'extrapolate'")
    return extend_wide(f, topo, 1, loc=loc, kind=kind,
                       fold_partner=fold_partner, fold_sign=fold_sign,
                       open_fill=open_fill)


def extend_wide(f: torch.Tensor, topo: Topology, W: int,
                loc: FieldLoc = FieldLoc.CENTER,
                kind: FieldType = FieldType.SCALAR,
                fold_partner: torch.Tensor | None = None,
                fold_sign: float = 1.0, open_fill: str = "zero"
                ) -> torch.Tensor:
    """Add a W-cell ghost ring: (..., ny, nx) -> (..., ny+2W, nx+2W) in one
    exchange per mesh axis (the remap kernel's W=2 window of raw fields,
    the chunked EVP's K-wide margin). A tripole seam fills the W ghost
    rows with the fold image of the top W rows. Extrapolation
    (``open_fill``) is defined at W=1 only."""
    _check(topo)
    if open_fill == "extrapolate" and W != 1:
        raise ValueError("open_fill='extrapolate' extends by one cell")
    tg_ext = None
    if topo.ns in _TRIPOLE and topo.is_top:
        tg_ext, top_sym = _fold_rows(f, topo, W, loc, kind,
                                     fold_partner=fold_partner,
                                     fold_sign=fold_sign)
        f = _with_top(f, top_sym)
    return _assemble(f, topo, W, tg_ext, open_fill)


def extend_wide_groups(f: torch.Tensor, topo: Topology, W: int,
                       groups) -> torch.Tensor:
    """extend_wide for a (C, ny, nx) stack whose entries need different
    tripole fold treatments but share one exchange per mesh axis.

    groups: list of (channel_slice, loc, kind, fold_partner, fold_sign)
    covering 0..C in order; fold_partner is a (len, ny, nx) stack or None.
    Non-tripole topologies ignore the groups (one extend_wide). The
    chunked EVP's caller: (u, v) fold as NECORNER vectors while the 12
    stress components fold through the corner-partner permutation
    (ice_HaloUpdate_stress, mpi/ice_boundary.F90:5564)."""
    if topo.ns not in _TRIPOLE:
        return extend_wide(f, topo, W)
    if topo.ns == "tripoleT":
        raise NotImplementedError("extend_wide_groups: T-fold grids")
    _check(topo)
    tg_ext = None
    if topo.is_top:
        ghosts, parts = [], []
        for sl, loc, kind, fpart, fsign in groups:
            sub = f[sl]
            g, top_sym = _fold_rows(sub, topo, W, loc, kind,
                                    fold_partner=fpart, fold_sign=fsign)
            ghosts.append(g)
            parts.append(_with_top(sub, top_sym))
        f, tg_ext = torch.cat(parts, dim=0), torch.cat(ghosts, dim=0)
    return _assemble(f, topo, W, tg_ext)


def interior(F):
    return F[..., 1:-1, 1:-1]


def shifted(F, di: int, dj: int):
    """For an array extended by one ring: F at (j + dj, i + di) over the
    interior; di/dj in {-1, 0, +1}."""
    j0, j1 = 1 + dj, F.shape[-2] - 1 + dj
    i0, i1 = 1 + di, F.shape[-1] - 1 + di
    return F[..., j0:j1, i0:i1]


def global_sum(x, topo: Topology):
    """Global sum (the global_sum analog, mpi/ice_global_reductions.F90).
    On a mesh every rank's partial sum is gathered and added in rank
    order, so the result is the same on every rank and from run to run,
    whatever the backend (the bfbflag ordered sum, :142-267)."""
    s = x.sum()
    if topo.mesh is None:
        return s
    parts = pdist.all_gather(s.reshape(1), topo.mesh)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.reshape(())


def global_min(x, topo: Topology):
    """Global minimum (mpi/ice_global_reductions.F90:1453 global_minval):
    an all-reduce with MIN on a mesh."""
    s = x.min()
    if topo.mesh is None:
        return s
    return pdist.all_reduce_min(s, topo.mesh)
