"""Atmosphere-ice boundary layer (PyTorch port of
``cice5_tpu/models/atmo.py``; ice_atmo.F90 atmo_boundary_layer :82, the
Monin-Obukhov stability iteration of the NCAR CCSM scheme, and
atmo_boundary_const :492). Returns the transfer coefficients of the
implicit surface-flux solve, the wind stress and the 2-m diagnostics.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference.cice import constants as ct

CPVIR = ct.cp_wv / ct.cp_air - 1.0
ZTRF = 2.0          # reference height for 2-m diagnostics


class ABLResult(NamedTuple):
    strx: torch.Tensor
    stry: torch.Tensor
    Tref: torch.Tensor
    Qref: torch.Tensor
    Uref: torch.Tensor
    delt: torch.Tensor
    delq: torch.Tensor
    shcoef: torch.Tensor
    lhcoef: torch.Tensor


def _psimhu(x):
    return (torch.log((1.0 + x * (2.0 + x)) * (1.0 + x * x) / 8.0)
            - 2.0 * torch.atan(x) + ct.pih)


def _psixhu(x):
    return 2.0 * torch.log((1.0 + x * x) / 2.0)


def atmo_boundary_layer(*, sfctype: str, Tsf, potT, uatm, vatm, wind, zlvl,
                        Qa, rhoa, natmiter: int = 5, Cdn_atm=None,
                        highfreq: bool = False, uice=None,
                        vice=None) -> ABLResult:
    """Monin-Obukhov surface layer over 'ice' or 'ocn'
    (ice_atmo.F90:82-489).

    Cdn_atm: the form-drag neutral drag coefficient over ice (None: the
    constant roughness-length value). highfreq: RASM high-frequency
    coupling (Roberts et al 2014, ice_atmo.F90:220-227,272-277,398-417):
    winds relative to the ice velocity (uice/vice on the T grid) drive the
    turbulence scales and the wind stress."""
    umin = 1.0
    hf = highfreq and sfctype == "ice"
    if hf:
        if uice is None or vice is None:
            raise ValueError("highfreq coupling needs uice/vice")
        relu, relv = uatm - uice, vatm - vice
        relmag = torch.sqrt(relu ** 2 + relv ** 2)
        vmag = torch.clamp(relmag, min=umin)
    else:
        vmag = torch.clamp(wind, min=umin)
    if sfctype == "ice":
        qqq, TTT, Lheat = ct.qqqice, ct.TTTice, ct.Lsub
        rdn0 = ct.vonkar / math.log(ct.zref / ct.iceruf)
        if Cdn_atm is not None:
            rdn = torch.where(Cdn_atm > ct.puny, torch.sqrt(Cdn_atm), rdn0)
        else:
            rdn = torch.full_like(vmag, rdn0)
    else:
        qqq, TTT, Lheat = ct.qqqocn, ct.TTTocn, ct.Lvap
        rdn = torch.sqrt(0.0027 / vmag + 0.000142 + 0.0000764 * vmag)

    TsfK = Tsf + ct.Tffresh
    qsat = qqq * torch.exp(-TTT / TsfK)
    ssq = qsat / rhoa
    thva = potT * (1.0 + ct.zvir * Qa)
    delt = potT - TsfK
    delq = Qa - ssq
    alz = torch.log(zlvl / ct.zref)
    cp = ct.cp_air * (1.0 + CPVIR * ssq)

    rhn = ren = rdn
    ustar = rdn * vmag
    tstar = rhn * delt
    qstar = ren * delq

    rd = rh = re = rdn
    stable = torch.zeros_like(vmag)
    psixh = torch.zeros_like(vmag)
    hol = torch.zeros_like(vmag)
    for _ in range(natmiter):
        hol = (ct.vonkar * ct.gravit * zlvl
               * (tstar / thva + qstar / (1.0 / ct.zvir + Qa))
               / torch.clamp(ustar ** 2, min=1e-30))
        hol = torch.sign(hol) * torch.clamp(torch.abs(hol), max=10.0)
        stable = 0.5 + torch.sign(hol) * 0.5
        xqq = torch.sqrt(torch.clamp(torch.sqrt(torch.abs(1.0 - 16.0 * hol)),
                                     min=1.0))
        psimhs = -(0.7 * hol + 0.75 * (hol - 14.3)
                   * torch.exp(-0.35 * hol) + 10.7)
        psimh = psimhs * stable + (1.0 - stable) * _psimhu(xqq)
        psixh = psimhs * stable + (1.0 - stable) * _psixhu(xqq)

        rd = rdn / (1.0 + rdn / ct.vonkar * (alz - psimh))
        rh = rhn / (1.0 + rhn / ct.vonkar * (alz - psixh))
        re = ren / (1.0 + ren / ct.vonkar * (alz - psixh))

        ustar = rd * vmag
        tstar = rh * delt
        qstar = re * delq

    if hf:
        # stress on the relative wind (ice_atmo.F90:398-417)
        tau = rhoa * rd * rd
        strx = tau * relmag * relu
        stry = tau * relmag * relv
    else:
        tau = rhoa * ustar * rd
        strx = tau * uatm
        stry = tau * vatm

    shcoef = rhoa * ustar * cp * rh + 1.0   # windless coefficient, Jordan 99
    lhcoef = rhoa * ustar * Lheat * re

    # 2-m diagnostics
    al2 = math.log(ct.zref / ZTRF)
    hol2 = hol * ZTRF / zlvl
    xqq2 = torch.sqrt(torch.clamp(torch.sqrt(torch.abs(1.0 - 16.0 * hol2)),
                                  min=1.0))
    psix2 = -5.0 * hol2 * stable + (1.0 - stable) * _psixhu(xqq2)
    fac = (rh / ct.vonkar) * (alz + al2 - psixh + psix2)
    Tref = potT - delt * fac - 0.01 * ZTRF
    fac = (re / ct.vonkar) * (alz + al2 - psixh + psix2)
    Qref = Qa - delq * fac
    Uref = vmag * rd / rdn
    return ABLResult(strx=strx, stry=stry, Tref=Tref, Qref=Qref, Uref=Uref,
                     delt=delt, delq=delq, shcoef=shcoef, lhcoef=lhcoef)


def atmo_boundary_const(*, sfctype: str, Tsf, potT, uatm, vatm, wind, Qa,
                        rhoa) -> ABLResult:
    """Constant-coefficient boundary layer (ice_atmo.F90:492-641)."""
    cdn = 1.2e-3
    Lheat = ct.Lsub if sfctype == "ice" else ct.Lvap
    vmag = torch.clamp(wind, min=1.0)
    tau = rhoa * cdn * vmag
    TsfK = Tsf + ct.Tffresh
    qqq = ct.qqqice if sfctype == "ice" else ct.qqqocn
    TTT = ct.TTTice if sfctype == "ice" else ct.TTTocn
    ssq = qqq * torch.exp(-TTT / TsfK) / rhoa
    return ABLResult(strx=tau * uatm, stry=tau * vatm, Tref=potT, Qref=Qa,
                     Uref=vmag, delt=potT - TsfK, delq=Qa - ssq,
                     shcoef=tau * ct.cp_air, lhcoef=tau * Lheat)
