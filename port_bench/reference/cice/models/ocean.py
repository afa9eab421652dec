"""Slab ocean mixed layer for standalone runs (PyTorch port of
``cice5_tpu/models/ocean.py``; ice_ocean.F90:52-233 ocean_mixed_layer):
prognostic SST forced by the atmosphere over open water plus the
ice-ocean fluxes, giving the freezing/melting potential frzmlt."""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.models.atmo import (atmo_boundary_const,
                                         atmo_boundary_layer)

CPRHO = ct.cp_ocn * ct.rhow
FRZMLT_MAX = 1000.0     # max magnitude of frzmlt (W/m^2)


class MixedLayerResult(NamedTuple):
    sst: torch.Tensor
    frzmlt: torch.Tensor
    flwout_ocn: torch.Tensor
    fsens_ocn: torch.Tensor
    flat_ocn: torch.Tensor
    evap_ocn: torch.Tensor
    strairx_ocn: torch.Tensor
    strairy_ocn: torch.Tensor


def ocean_mixed_layer(dt, *, sst, Tf, hmix, qdp, aice, fhocn, fswthru,
                      uatm, vatm, wind, zlvl, potT, Qa, rhoa, flw,
                      swvdr, swvdf, swidr, swidf, tmask,
                      atmbndy="default", natmiter=5) -> MixedLayerResult:
    """Prognostic slab-ocean SST + freezing/melting potential
    (ice_ocean.F90:52-233). fhocn/fswthru already include the aice
    factor."""
    if atmbndy == "constant":
        abl = atmo_boundary_const(sfctype="ocn", Tsf=sst, potT=potT,
                                  uatm=uatm, vatm=vatm, wind=wind, Qa=Qa,
                                  rhoa=rhoa)
    else:
        abl = atmo_boundary_layer(sfctype="ocn", Tsf=sst, potT=potT,
                                  uatm=uatm, vatm=vatm, wind=wind, zlvl=zlvl,
                                  Qa=Qa, rhoa=rhoa, natmiter=natmiter)

    swabs = (1.0 - ct.albocn) * (swvdr + swidr + swvdf + swidf)
    TsfK = sst + ct.Tffresh
    flwout_ocn = -ct.stefan_boltzmann * TsfK ** 4
    fsens_ocn = abl.shcoef * abl.delt
    flat_ocn = abl.lhcoef * abl.delq
    evap_ocn = -flat_ocn / ct.Lvap

    hm1 = torch.clamp(hmix, min=1.0)
    sst_new = sst + dt * (
        (fsens_ocn + flat_ocn + flwout_ocn + flw + swabs) * (1.0 - aice)
        + fhocn + fswthru) / (CPRHO * hm1)
    qdp = torch.where((sst_new <= Tf) & (qdp > 0.0), 0.0, qdp)
    sst_new = sst_new - qdp * dt / (CPRHO * hm1)

    frzmlt = (Tf - sst_new) * CPRHO * hm1 / dt
    frzmlt = torch.clamp(frzmlt, -FRZMLT_MAX, FRZMLT_MAX)
    sst_new = torch.maximum(sst_new, Tf)

    w = lambda x: torch.where(tmask, x, 0.0)
    return MixedLayerResult(
        sst=w(sst_new), frzmlt=w(frzmlt), flwout_ocn=w(flwout_ocn),
        fsens_ocn=w(fsens_ocn), flat_ocn=w(flat_ocn), evap_ocn=w(evap_ocn),
        strairx_ocn=w(abl.strx), strairy_ocn=w(abl.stry))
