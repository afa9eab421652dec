"""Ice restoring at open boundaries (PyTorch port of
``cice5_tpu/models/restoring.py``; reference source/ice_restoring.F90).

For regional (non-cyclic) domains the reference saves the initial (or
restart) state of the cells surrounding the grid and nudges the boundary
cells toward it every step with timescale ``trestore`` days
(ice_HaloRestore, :527-705). Fields here carry no ghost cells, so the
equivalent is nudging the outermost physical row/column at each non-cyclic
global edge. On a mesh of ranks each tile takes its part of the global
edge mask.
"""
from __future__ import annotations

import torch

from cice5_tpu_torch.parallel import Topology


def edge_mask(shape, topo: Topology, dtype=torch.float32, device=None):
    """(ny, nx) mask of cells on non-cyclic global boundaries
    (1.0 on the outermost row/column); on a mesh, the tile's part of the
    global mask."""
    if topo.mesh is not None:
        rows, cols = topo.mesh.slices()
        full = edge_mask(topo.mesh.global_shape,
                         Topology(ew=topo.ew, ns=topo.ns), dtype, device)
        return full[rows, cols].contiguous()
    m = torch.zeros(shape, dtype=dtype, device=device)
    if topo.ew != "cyclic":
        m[:, 0] = 1.0
        m[:, -1] = 1.0
    if topo.ns not in ("cyclic", "tripole", "tripoleT"):
        m[0, :] = 1.0
        m[-1, :] = 1.0
    elif topo.ns in ("tripole", "tripoleT"):
        # only the southern edge is open on tripole grids
        m[0, :] = 1.0
    return m


def restore_ice(dt, trestore_days, state, rest, topo: Topology, mask=None):
    """Nudge boundary cells of (aicen, vicen, vsnon, trcrn) toward the
    stored restoring state ``rest`` (ice_restoring.F90:527-705).

    trestore_days == 0 applies the restoring state instantaneously.
    ``mask``: ``edge_mask`` of the grid, built once by a caller that
    restores every step; built here when it is not given."""
    trest = max(float(trestore_days), 0.0) * 86400.0
    ctime = 1.0 if trest <= 0.0 else min(1.0, dt / trest)
    if mask is None:
        mask = edge_mask(state.aicen.shape[-2:], topo, state.aicen.dtype,
                         state.aicen.device)

    def blend(cur, tgt):
        return cur + (tgt - cur) * ctime * mask
    return state.replace(
        aicen=blend(state.aicen, rest.aicen),
        vicen=blend(state.vicen, rest.vicen),
        vsnon=blend(state.vsnon, rest.vsnon),
        trcrn=blend(state.trcrn, rest.trcrn))
