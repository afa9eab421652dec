"""Shared EVP dynamics machinery: parameters, grid staggering, prep,
point-wise momentum solve, ocean-stress finish (PyTorch port of
``cice5_tpu/models/dynamics/shared.py``).

ice_dyn_shared.F90: set_evp_parameters :185, evp_prep1 :270, evp_prep2
:377, stepu :623, evp_finish :757; T<->U staggering of
ice_grid.F90:1799-1953. Dense (ny, nx) masked arithmetic; the reference's
gathered icellt/icellu lists become masks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.constants import FieldType
from reference.cice.parallel import Topology, extend

EYC = 0.36       # E_0: ratio of elastic damping timescale to dt
A_MIN = 0.001    # minimum ice area for dynamics
M_MIN = 0.01     # minimum ice mass (kg/m^2)


@dataclass(frozen=True)
class EVPParams:
    """set_evp_parameters (ice_dyn_shared.F90:185-268)."""
    ndte: int
    arlx1i: float
    brlx: float
    denom1: float
    revp: float
    ecci: float = 0.25
    cosw: float = 1.0
    sinw: float = 0.0

    @classmethod
    def classic(cls, dt: float, ndte: int, cosw=1.0, sinw=0.0,
                e_ratio=2.0) -> "EVPParams":
        dte = dt / ndte
        tdamp2 = 2.0 * EYC * dt
        arlx1i = dte / tdamp2
        brlx = dt / dte
        return cls(ndte=ndte, arlx1i=arlx1i, brlx=brlx,
                   denom1=1.0 / (1.0 + arlx1i), revp=0.0,
                   ecci=1.0 / e_ratio ** 2, cosw=cosw, sinw=sinw)

    @classmethod
    def revised(cls, dt: float, ndte: int, xmin: float,
                cosw=1.0, sinw=0.0, e_ratio=2.0) -> "EVPParams":
        """Bouillon et al 2013 revised EVP (ice_dyn_shared.F90:230-240);
        xmin is the global ocean minimum of (dxt, dyt)."""
        Se, xi = 0.86, 5.5e-3
        gamma = 0.25 * 1.0e11 * dt
        arlx1i = 2.0 * xi / Se
        brlx = 2.0 * Se * xi * gamma / xmin ** 2
        return cls(ndte=ndte, arlx1i=arlx1i, brlx=brlx,
                   denom1=1.0 / (1.0 + arlx1i), revp=1.0,
                   ecci=1.0 / e_ratio ** 2, cosw=cosw, sinw=sinw)


def to_ugrid(T, grid, topo: Topology, kind=FieldType.SCALAR):
    """Area-weighted T->U interpolation (ice_grid.F90:1834-1883)."""
    w = extend(T * grid.tarea, topo, kind=kind)
    s = w[..., 1:-1, 1:-1] + w[..., 1:-1, 2:] + w[..., 2:, 1:-1] \
        + w[..., 2:, 2:]
    return 0.25 * s * grid.uarear


def to_tgrid(U, grid, topo: Topology):
    """U->T interpolation (ice_grid.F90:1921-1953)."""
    w = extend(U * grid.uarea, topo)
    s = (w[..., 1:-1, 1:-1] + w[..., 1:-1, :-2]
         + w[..., :-2, 1:-1] + w[..., :-2, :-2])
    return 0.25 * s * grid.tarear


def icet_mask(aice, vice, vsno, tmask, topo: Topology):
    """tmass + the 9-point dilated ice-extent T mask (evp_prep1,
    ice_dyn_shared.F90:270)."""
    tmass = torch.where(tmask, ct.rhoi * vice + ct.rhos * vsno, 0.0)
    core = tmask & (aice > A_MIN) & (tmass > M_MIN)
    E = extend(core.to(aice.dtype), topo)
    dil = torch.zeros_like(aice)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            dil = dil + E[..., 1 + dj:E.shape[-2] - 1 + dj,
                          1 + di:E.shape[-1] - 1 + di]
    icetmask = (dil > 0.0) & tmask
    return tmass, icetmask


class StepUResult(NamedTuple):
    uvel: torch.Tensor
    vvel: torch.Tensor
    strintx: torch.Tensor
    strinty: torch.Tensor
    strocnx: torch.Tensor
    strocny: torch.Tensor


def stepu(p: EVPParams, *, icemask, aiu, strE, uocn, vocn, waterx, watery,
          forcex, forcey, umassdti, fm, uarear, uvel_init, vvel_init,
          uvel, vvel, Cw=ct.dragio) -> StepUResult:
    """Implicit point-wise momentum solve (ice_dyn_shared.F90:623-755).

    strE: stress-combination region array (8, ny+1, nx+1) covering T cells
    [0..ny] x [0..nx] (interior plus the N/E ghost row/column)."""
    uold, vold = uvel, vvel
    vrel = aiu * ct.rhow * Cw * torch.sqrt((uocn - uold) ** 2
                                           + (vocn - vold) ** 2)
    taux = vrel * waterx
    tauy = vrel * watery

    cca = (p.brlx + p.revp) * umassdti + vrel * p.cosw
    ccb = fm + torch.sign(fm) * vrel * p.sinw
    ab2 = cca * cca + ccb * ccb

    ny, nx = uvel.shape[-2], uvel.shape[-1]
    c = lambda k, di, dj: strE[k, dj:dj + ny, di:di + nx]
    strintx = uarear * (c(0, 0, 0) + c(1, 1, 0) + c(2, 0, 1) + c(3, 1, 1))
    strinty = uarear * (c(4, 0, 0) + c(5, 0, 1) + c(6, 1, 0) + c(7, 1, 1))

    cc1 = strintx + forcex + taux + umassdti * (p.brlx * uold
                                                + p.revp * uvel_init)
    cc2 = strinty + forcey + tauy + umassdti * (p.brlx * vold
                                                + p.revp * vvel_init)
    ab2 = torch.clamp(ab2, min=1e-30)
    unew = (cca * cc1 + ccb * cc2) / ab2
    vnew = (cca * cc2 - ccb * cc1) / ab2

    m = icemask
    return StepUResult(
        uvel=torch.where(m, unew, 0.0),
        vvel=torch.where(m, vnew, 0.0),
        strintx=torch.where(m, strintx, 0.0),
        strinty=torch.where(m, strinty, 0.0),
        strocnx=torch.where(m, taux, 0.0),
        strocny=torch.where(m, tauy, 0.0))


def evp_finish(p: EVPParams, *, icemask, uvel, vvel, uocn, vocn, aiu, fm,
               Cw=ct.dragio):
    """Final ice-ocean stress (ice_dyn_shared.F90:757-849).
    Returns (strocnx, strocny, strocnxT_u, strocnyT_u); the T-grid
    conversion is the caller's."""
    vrel = ct.rhow * Cw * torch.sqrt((uocn - uvel) ** 2 + (vocn - vvel) ** 2)
    vrel = vrel * aiu
    sgn = torch.sign(fm)
    strocnx = vrel * ((uocn - uvel) * p.cosw - (vocn - vvel) * p.sinw * sgn)
    strocny = vrel * ((vocn - vvel) * p.cosw + (uocn - uvel) * p.sinw * sgn)
    strocnx = torch.where(icemask, strocnx, 0.0)
    strocny = torch.where(icemask, strocny, 0.0)
    aiu_s = torch.clamp(aiu, min=ct.puny)
    return strocnx, strocny, strocnx / aiu_s, strocny / aiu_s
