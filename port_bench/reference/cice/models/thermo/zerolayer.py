"""Semtner zero-layer thermodynamics (PyTorch port of
``cice5_tpu/models/thermo/zerolayer.py``; ice_therm_0layer.F90).

ktherm=0: no internal heat capacity. The ice/snow slab conducts heat
linearly between the surface and the bottom through the effective
conductivity kh = kseaice / (hi + hs*kseaice/ksno), and the surface energy
balance fsurf(Tsf) = kh*(Tsf - Tbot) is solved by the masked Newton
iteration of the BL99 solver (zerolayer_temperature, :41-470). Enthalpies
stay at their latent-only values (-rhoi*Lfresh, -rhos*Lfresh), so
thickness_changes carries all growth and melt energetics.

The iteration goes through ``ops/loop.py:while_loop``: its body changes
nothing once ``go`` is False, so the step captures as CUDA graphs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.models.thermo import shared
from reference.cice.ops.loop import while_loop

NITERMAX = 50
TSF_ERRMAX = 5.0e-4
KSEAICE = 2.0          # fixed 0-layer ice conductivity (ice_constants)


class ZeroLayerResult(NamedTuple):
    Tsf: torch.Tensor
    fsensn: torch.Tensor
    flatn: torch.Tensor
    flwoutn: torch.Tensor
    fsurfn: torch.Tensor
    fcondtopn: torch.Tensor
    fcondbot: torch.Tensor
    converged: torch.Tensor
    niter: torch.Tensor         # solver passes used (0-d int64)


def zerolayer_temperature(dt, *, mask, rhoa, flw, potT, Qa, shcoef, lhcoef,
                          fswsfc, hilyr, hslyr, nilyr, nslyr, Tsf, Tbot,
                          ksno=0.30) -> ZeroLayerResult:
    """Surface-balance solve (ice_therm_0layer.F90:41-470) over batch *B;
    cells outside ``mask`` pass through."""
    heff = torch.clamp(hilyr * nilyr + (KSEAICE / ksno) * hslyr * nslyr,
                       min=ct.puny)
    kh = KSEAICE / heff

    def pending(c):
        return (c["niter"] < NITERMAX) & (~c["converged"]).any()

    def body(c, go):
        """One Newton pass (ops/loop.py): the cells of the mask not yet
        converged move, and none when ``go`` is False."""
        active = mask & ~c["converged"] & go
        c_Tsf, dTsf_prev = c["Tsf"], c["dTsf_prev"]
        flwoutn, fsensn, flatn, fsurfn = shared.surface_heat_flux(
            c_Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef)
        dfsurf, dflwout, dfsens, dflat = shared.dsurface_heat_flux_dTsf(
            c_Tsf, rhoa, shcoef, lhcoef)

        fcondtop = kh * (c_Tsf - Tbot)
        Tsf_start = torch.where(fsurfn < fcondtop,
                                torch.clamp(c_Tsf, max=-ct.puny), c_Tsf)
        diag = dfsurf - kh
        rhs = dfsurf * Tsf_start - fsurfn - kh * Tbot
        Tsf_new = rhs / torch.where(torch.abs(diag) > ct.puny, diag, -1.0)
        dTsf = Tsf_new - Tsf_start
        # condition 1: an above-melting solution is clamped to 0
        hot = Tsf_new > ct.puny
        Tsf_new = torch.where(hot, 0.0, Tsf_new)
        dTsf = torch.where(hot, -Tsf_start, dTsf)
        # condition 2: oscillation damping
        osc = ((c["niter"] > 0) & ~hot & (Tsf_start <= -ct.puny)
               & (torch.abs(dTsf) > ct.puny)
               & (torch.abs(dTsf_prev) > ct.puny)
               & (-dTsf / (dTsf_prev + ct.puny ** 2) > 0.5))
        dTsf = torch.where(osc, 0.5 * dTsf, dTsf)
        Tsf_new = torch.where(osc, Tsf_new + 0.5 * (Tsf_start - Tsf_new),
                              Tsf_new)
        # condition 3: the increment is small enough; condition 4: a
        # melting surface has fsurf >= fcondtop
        fsurf_upd = fsurfn + dTsf * dfsurf
        fcondtop_upd = kh * (Tsf_new - Tbot)
        conv = (~osc & (torch.abs(dTsf) <= TSF_ERRMAX)
                & ~((Tsf_new > -ct.puny) & (fsurf_upd < fcondtop_upd)))

        upd = lambda new, old: torch.where(active, new, old)
        return dict(
            niter=c["niter"] + go, Tsf=upd(Tsf_new, c_Tsf),
            dTsf_prev=upd(dTsf, dTsf_prev),
            fsensn=upd(fsensn, c["fsensn"]), flatn=upd(flatn, c["flatn"]),
            flwoutn=upd(flwoutn, c["flwoutn"]),
            fsurfn=upd(fsurf_upd, c["fsurfn"]),
            fcondtopn=upd(fcondtop_upd, c["fcondtopn"]),
            dfs_dT=upd(dfsens, c["dfs_dT"]), dfl_dT=upd(dflat, c["dfl_dT"]),
            dfw_dT=upd(dflwout, c["dfw_dT"]),
            converged=c["converged"] | (active & conv))

    z = torch.zeros_like(Tsf)
    c = while_loop(body, pending, dict(
        niter=torch.zeros((), dtype=torch.int64, device=Tsf.device),
        Tsf=Tsf, dTsf_prev=z, fsensn=z, flatn=z, flwoutn=z, fsurfn=z,
        fcondtopn=z, dfs_dT=z, dfl_dT=z, dfw_dT=z, converged=~mask))

    # final flux updates with the last dTsf (:455-465)
    dTsf = c["dTsf_prev"]
    return ZeroLayerResult(
        Tsf=c["Tsf"], fsensn=c["fsensn"] + dTsf * c["dfs_dT"],
        flatn=c["flatn"] + dTsf * c["dfl_dT"],
        flwoutn=c["flwoutn"] + dTsf * c["dfw_dT"], fsurfn=c["fsurfn"],
        fcondtopn=c["fcondtopn"],
        fcondbot=c["fcondtopn"],      # steady conduction through the slab
        converged=c["converged"] | ~mask, niter=c["niter"])
