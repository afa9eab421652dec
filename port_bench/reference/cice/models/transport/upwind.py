"""First-order upwind transport (PyTorch port of
``cice5_tpu/models/transport/upwind.py``).

ice_transport_driver.F90 transport_upwind (:634), state_to_work (:1380),
work_to_state and upwind_field (:1615). Every conserved quantity (open
water, per-category area and volumes, dependency-weighted tracer amounts)
is stacked into one (narr, ny, nx) tensor, advected with one ghost
exchange, and unpacked through the ITD tracer weights.
"""
from __future__ import annotations

import torch

from reference.cice.constants import FieldLoc, FieldType
from reference.cice.models.thermo.itd import compute_tracers, tracer_weights
from reference.cice.parallel import Topology, extend


def upwind_field(dt, phi, ueeE, vnnE, grid, topo: Topology):
    """Upwind-advect the stacked fields phi (n, ny, nx)
    (ice_transport_driver.F90:1615-1680 upwind_field). worka(i, j) is the
    flux across the east edge of T cell (i, j), computed on i in
    [-1, nx-1] so that its divergence is a slice."""
    phiE = extend(phi, topo)
    HTE_E = extend(grid.HTE, topo, loc=FieldLoc.EFACE)
    HTN_E = extend(grid.HTN, topo, loc=FieldLoc.NFACE)

    def upwind(y1, y2, a, h):
        return 0.5 * dt * h * ((a + torch.abs(a)) * y1
                               + (a - torch.abs(a)) * y2)

    # x fluxes at i = -1..nx-1, interior rows
    worka = upwind(phiE[..., 1:-1, :-1], phiE[..., 1:-1, 1:],
                   ueeE[..., 1:-1, :-1], HTE_E[..., 1:-1, :-1])
    # y fluxes at j = -1..ny-1, interior columns
    workb = upwind(phiE[..., :-1, 1:-1], phiE[..., 1:, 1:-1],
                   vnnE[..., :-1, 1:-1], HTN_E[..., :-1, 1:-1])
    div = (worka[..., :, 1:] - worka[..., :, :-1]
           + workb[..., 1:, :] - workb[..., :-1, :])
    return phi - div * grid.tarear


def transport_upwind(dt, grid, topo: Topology, tr, *, uvel, vvel, aicen,
                     vicen, vsnon, trcrn, aice0):
    """Upwind transport of the whole ice state
    (ice_transport_driver.F90:634-789). Returns (aicen, vicen, vsnon,
    trcrn, aice0)."""
    ncat = aicen.shape[0]
    ny, nx = aicen.shape[-2:]
    # edge velocities from the U-point corners (:689-693)
    uvE = extend(torch.stack([uvel, vvel]), topo, loc=FieldLoc.NECORNER,
                 kind=FieldType.VECTOR)
    uee = 0.5 * (uvE[0, 1:-1, 1:-1] + uvE[0, :-2, 1:-1])
    vnn = 0.5 * (uvE[1, 1:-1, 1:-1] + uvE[1, 1:-1, :-2])
    ueeE = extend(uee, topo)
    vnnE = extend(vnn, topo)

    atrcrn = tracer_weights(tr, aicen, vicen, vsnon, trcrn) * trcrn
    fields = torch.cat([aice0[None], aicen, vicen, vsnon,
                        atrcrn.reshape((ncat * tr.ntrcr, ny, nx))], dim=0)
    out = upwind_field(dt, fields, ueeE, vnnE, grid, topo)

    aice0n = torch.clamp(out[0], min=0.0)
    aicen_n = out[1:1 + ncat]
    vicen_n = out[1 + ncat:1 + 2 * ncat]
    vsnon_n = out[1 + 2 * ncat:1 + 3 * ncat]
    atrcrn_n = out[1 + 3 * ncat:].reshape((ncat, tr.ntrcr, ny, nx))
    trcrn_n = compute_tracers(tr, atrcrn_n, aicen_n, vicen_n, vsnon_n)
    land = ~grid.tmask[None]
    return (torch.where(land, 0.0, aicen_n), torch.where(land, 0.0, vicen_n),
            torch.where(land, 0.0, vsnon_n), trcrn_n, aice0n)
