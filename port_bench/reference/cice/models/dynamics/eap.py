"""Elastic-anisotropic-plastic (EAP) sea-ice dynamics (PyTorch port of
``cice5_tpu/models/dynamics/eap.py``).

ice_dyn_eap.F90 (Tsamados, Feltham & Wilchinsky 2013): the anisotropic
rheology evolves a structure tensor A = [[a11, a12], [a12, 1-a11]] that
describes the orientation of the floes, and reads the yield stresses from
precomputed lookup tables (Appendix A1) in place of the elliptical yield
curve of EVP.

- ``update_stress_rdg`` (ice_dyn_eap.F90:1474-1658): eigen decomposition
  of A and of the strain-rate tensor, angle binning, table lookup and
  back-rotation, as dense masked arithmetic; the six (41, 41, 21) yield
  tables are one (6, 41, 41, 21) tensor, so the lookup is one gather.
- The tables (init_eap :556-621 and the integrands :660-1046) are built
  once in NumPy on the host (``build_yield_tables``) and copied to each
  device once (``yield_tables``), before any capture.
- The subcycles (stress, momentum, and the structure-tensor update on
  every 10th subcycle, :345-452) are a Python loop of ``ndte`` passes,
  as the EVP sweep's plain version is; ``k % 10`` is a Python int, so a
  captured step records exactly the passes that update the tensor.
  There is no hand-written kernel: the JAX package has no Pallas kernel
  for EAP (an XLA ``fori_loop``).
- Out-of-range angle bins are clamped to the table edge, as the JAX
  package clamps them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from reference.cice import constants as ct
from reference.cice.constants import FieldLoc, FieldType
from reference.cice.models.dynamics import shared as dyn
from reference.cice.models.dynamics.evp import (GR_NAMES, EVPResult,
                                                 _extend_stress, _region,
                                                 _region_metrics,
                                                 strain_rates,
                                                 stress_divergence)
from reference.cice.parallel import Topology, extend

NX_YIELD, NY_YIELD, NA_YIELD = 41, 41, 21
PHI = np.pi / 12.0            # diamond floe acute half-angle (30 deg)
KFRICTION = 0.45              # sliding friction coefficient
KTH = 0.2e-3                  # structure tensor relaxation (stepa :1713)
KFRAC = 0.001                 # fracture diffusion (calc_ffrac :1824)
FFRAC_THRESHOLD = 0.3         # sigma_1/sigma_2 shear-faulting bound

_PIH, _PIQ, _PI2 = np.pi / 2.0, np.pi / 4.0, 2.0 * np.pi
_DX = np.pi / (NX_YIELD - 1)
_DY = np.pi / (NY_YIELD - 1)
_DA = 0.5 / (NA_YIELD - 1)


def _w1(a):
    """Polynomial fit w1(a) of the Gaussian psi normalization
    (ice_dyn_eap.F90:624-641)."""
    return np.polyval([3495.82839237, -16789.98003081, 34397.72407466,
                       -38948.30444297, 26315.50025642, -10606.56079975,
                       2361.2198663, -223.87569446], a)


def _w2(a):
    """Polynomial fit w2(a) of the Gaussian psi width
    (ice_dyn_eap.F90:643-660)."""
    return np.polyval([102356.551518, -493379.44906738, 1013896.59464498,
                       -1151098.82436864, 779570.02793492, -314871.71525448,
                       70222.33061536, -6670.68911883], a)


def _stress_integrands(x, y, z, phi):
    """The six per-floe stress kernels s11kr..s22ks
    (ice_dyn_eap.F90:660-1046) on broadcastable x, y, z. Returns (r11,
    r12, r22, s11, s12, s22): the ridging and sliding parts."""
    p = phi
    n1t2i11 = np.cos(z + _PIH - p) * np.cos(z + p)
    n1t2i12 = np.cos(z + _PIH - p) * np.sin(z + p)
    n1t2i21 = np.sin(z + _PIH - p) * np.cos(z + p)
    n1t2i22 = np.sin(z + _PIH - p) * np.sin(z + p)
    n2t1i11 = np.cos(z - _PIH + p) * np.cos(z - p)
    n2t1i12 = np.cos(z - _PIH + p) * np.sin(z - p)
    n2t1i21 = np.sin(z - _PIH + p) * np.cos(z - p)
    n2t1i22 = np.sin(z - _PIH + p) * np.sin(z - p)
    t1t2i11 = np.cos(z - p) * np.cos(z + p)
    t1t2i12 = np.cos(z - p) * np.sin(z + p)
    t1t2i21 = np.sin(z - p) * np.cos(z + p)
    t1t2i22 = np.sin(z - p) * np.sin(z + p)
    t2t1i11 = t1t2i11
    t2t1i12 = np.cos(z + p) * np.sin(z - p)
    t2t1i21 = np.sin(z + p) * np.cos(z - p)
    t2t1i22 = t1t2i22

    cy2, ty = np.cos(y) ** 2, np.tan(y)
    d11 = cy2 * (np.cos(x) + np.sin(x) * ty * ty)
    d12 = cy2 * ty * (-np.cos(x) + np.sin(x))
    d22 = cy2 * (np.sin(x) + np.cos(x) * ty * ty)

    IIn1t2 = n1t2i11 * d11 + (n1t2i12 + n1t2i21) * d12 + n1t2i22 * d22
    IIn2t1 = n2t1i11 * d11 + (n2t1i12 + n2t1i21) * d12 + n2t1i22 * d22
    IIt1t2 = t1t2i11 * d11 + (t1t2i12 + t1t2i21) * d12 + t1t2i22 * d22

    Hen1t2 = (-IIn1t2 >= ct.puny).astype(np.float64)
    Hen2t1 = (-IIn2t1 >= ct.puny).astype(np.float64)
    sgn = np.sign(IIt1t2 + ct.puny)
    sgn = np.where(sgn == 0.0, 1.0, sgn)

    r11 = -Hen1t2 * n1t2i11 - Hen2t1 * n2t1i11
    r12 = 0.5 * ((-Hen1t2 * n1t2i12 - Hen2t1 * n2t1i12)
                 + (-Hen1t2 * n1t2i21 - Hen2t1 * n2t1i21))
    r22 = -Hen1t2 * n1t2i22 - Hen2t1 * n2t1i22
    s11 = sgn * (Hen1t2 * t1t2i11 + Hen2t1 * t2t1i11)
    s12 = 0.5 * (sgn * (Hen1t2 * t1t2i12 + Hen2t1 * t2t1i12)
                 + sgn * (Hen1t2 * t1t2i21 + Hen2t1 * t2t1i21))
    s22 = sgn * (Hen1t2 * t1t2i22 + Hen2t1 * t2t1i22)
    return r11, r12, r22, s11, s12, s22


@functools.lru_cache(maxsize=2)
def build_yield_tables(nz: int = 100) -> np.ndarray:
    """The (6, nx_yield, ny_yield, na_yield) yield-stress tables
    (ice_dyn_eap.F90:556-621), float64 on the host: Gaussian-weighted
    z-integrals of the floe stress kernels for a < 1, the isotropic
    delta-function limit at a = 1. Order [s11r, s12r, s22r, s11s, s12s,
    s22s]."""
    ia = np.arange(1, NA_YIELD + 1)
    a = (0.5 - _DA) + ia * _DA                     # in [0.5, 1.0]
    x = (np.pi + _PIQ - _DX) + np.arange(1, NX_YIELD + 1) * _DX
    y = -_DY + np.arange(1, NY_YIELD + 1) * _DY
    dz = np.pi / nz
    z = -_PIH + np.arange(1, nz + 1) * dz

    kernels = _stress_integrands(x[:, None, None], y[None, :, None],
                                 z[None, None, :], PHI)   # (nx, ny, nz)
    inv_sin2phi = 1.0 / np.sin(2.0 * PHI)
    tables = np.zeros((6, NX_YIELD, NY_YIELD, NA_YIELD))
    asub = a[:NA_YIELD - 1]
    wts = (_w1(asub)[None, :]
           * np.exp(-_w2(asub)[None, :] * (z ** 2)[:, None]))  # (nz, na-1)
    for k, kern in enumerate(kernels):
        tables[k, :, :, :NA_YIELD - 1] = np.einsum(
            "xyz,za->xya", kern, wts) * dz * inv_sin2phi
    k0 = _stress_integrands(x[:, None], y[None, :], 0.0, PHI)
    for k, kern in enumerate(k0):
        tables[k, :, :, NA_YIELD - 1] = 0.5 * kern * inv_sin2phi
    tables[np.abs(tables) < 1.0e-6] = 0.0
    return tables


@functools.lru_cache(maxsize=8)
def yield_tables(dtype: torch.dtype, device) -> torch.Tensor:
    """``build_yield_tables()`` as a tensor of ``dtype`` on ``device``,
    copied once per device (a captured step may make no tensor from host
    data)."""
    return torch.as_tensor(build_yield_tables(), dtype=torch.float64,
                           device=device).to(dtype)


class RdgStress(NamedTuple):
    stressp: torch.Tensor
    stressm: torch.Tensor
    stress12: torch.Tensor
    alphar: torch.Tensor    # ridging rate function
    alphas: torch.Tensor    # sliding rate function


def update_stress_rdg(divu, tension, shear, a11, a12, strength,
                      tables) -> RdgStress:
    """Yield stress from the structure tensor and the strain rate
    (ice_dyn_eap.F90:1474-1658 update_stress_rdg), dense over the grid.
    tables: (6, nx_yield, ny_yield, na_yield) of the fields' dtype."""
    invsin = float(1.0 / (np.sin(_PI2 / 12.0)
                          * (1.0 + KFRICTION * KFRICTION)))

    # 1) structure tensor eigen-angle
    a22 = 1.0 - a11
    gamma = 0.5 * torch.atan2(2.0 * a12, a11 - a22)
    Q11 = torch.cos(gamma)
    Q12 = torch.sin(gamma)
    Q11Q11, Q11Q12, Q12Q12 = Q11 * Q11, Q11 * Q12, Q12 * Q12
    atempprime = Q11Q11 * a11 + 2.0 * Q11Q12 * a12 + Q12Q12 * a22
    atempprime = torch.maximum(atempprime, 1.0 - atempprime)

    # 2) strain-rate principal values and angles
    dtemp11 = 0.5 * (divu + tension)
    dtemp12 = 0.5 * shear
    dtemp22 = 0.5 * (divu - tension)
    alpha = 0.5 * torch.atan2(2.0 * dtemp12, dtemp11 - dtemp22)
    alpha = torch.where(alpha > gamma, alpha - np.pi, alpha)
    alpha = torch.where(alpha < gamma - np.pi, alpha + np.pi, alpha)
    y = gamma - alpha

    Qd11 = torch.cos(alpha)
    Qd12 = torch.sin(alpha)
    dtemp1 = Qd11 * (Qd11 * dtemp11 + 2.0 * Qd12 * dtemp12) \
        + Qd12 * Qd12 * dtemp22
    dtemp2 = Qd12 * (Qd12 * dtemp11 - 2.0 * Qd11 * dtemp12) \
        + Qd11 * Qd11 * dtemp22
    leng = torch.sqrt(dtemp1 * dtemp1 + dtemp2 * dtemp2)
    nonzero = leng > ct.puny
    invleng = 1.0 / torch.clamp(leng, min=ct.puny)
    d1n = torch.where(nonzero, dtemp1 * invleng, 0.0)
    d2n = torch.where(nonzero, dtemp2 * invleng, 0.0)
    x = torch.where(nonzero, torch.atan2(d2n, d1n), 0.0)
    x = torch.where(x < _PIQ, x + _PI2, x)

    # 3) table lookup, clamped to the table
    kx = torch.floor((x - _PIQ - np.pi) / _DX).to(torch.int64).clamp(
        0, NX_YIELD - 1)
    ky = torch.floor(y / _DY).to(torch.int64).clamp(0, NY_YIELD - 1)
    ka = torch.floor((atempprime - 0.5) / _DA).to(torch.int64).clamp(
        0, NA_YIELD - 1)
    s11r, s12r, s22r, s11s, s12s, s22s = tables[:, kx, ky, ka]

    # 4) mean stress over the floe collection (Eq. 3), principal frame
    stressp = strength * (s11r + KFRICTION * s11s
                          + s22r + KFRICTION * s22s) * invsin
    stress12 = strength * (s12r + KFRICTION * s12s) * invsin
    stressm = strength * (s11r + KFRICTION * s11s
                          - s22r - KFRICTION * s22s) * invsin

    # 5) back-rotation into general coordinates
    sig11 = 0.5 * (stressp + stressm)
    sig12 = stress12
    sig22 = 0.5 * (stressp - stressm)
    sgprm11 = Q11Q11 * sig11 + Q12Q12 * sig22 - 2.0 * Q11Q12 * sig12
    sgprm12 = Q11Q12 * sig11 - Q11Q12 * sig22 + (Q11Q11 - Q12Q12) * sig12
    sgprm22 = Q12Q12 * sig11 + Q11Q11 * sig22 + 2.0 * Q11Q12 * sig12

    # 6) ridging/sliding rate functions in general coordinates (Eq. 11)
    rot11r = Q11Q11 * s11r - 2.0 * Q11Q12 * s12r + Q12Q12 * s22r
    rot12r = Q11Q11 * s12r + Q11Q12 * (s11r - s22r) - Q12Q12 * s12r
    rot22r = Q12Q12 * s11r + 2.0 * Q11Q12 * s12r + Q11Q11 * s22r
    rot11s = Q11Q11 * s11s - 2.0 * Q11Q12 * s12s + Q12Q12 * s22s
    rot12s = Q11Q11 * s12s + Q11Q12 * (s11s - s22s) - Q12Q12 * s12s
    rot22s = Q12Q12 * s11s + 2.0 * Q11Q12 * s12s + Q11Q11 * s22s
    alphar = rot11r * dtemp11 + 2.0 * rot12r * dtemp12 + rot22r * dtemp22
    alphas = rot11s * dtemp11 + 2.0 * rot12s * dtemp12 + rot22s * dtemp22

    return RdgStress(stressp=sgprm11 + sgprm22, stressm=sgprm11 - sgprm22,
                     stress12=sgprm12, alphar=alphar, alphas=alphas)


def _ffrac(stressp, stressm, stress12, a11x, a12x):
    """Fracture re-orientation term Ffrac = -kfrac (A - S)
    (ice_dyn_eap.F90:1795-1864 calc_ffrac), both components at once."""
    sigma11 = 0.5 * (stressp + stressm)
    sigma12 = stress12
    sigma22 = 0.5 * (stressp - stressm)
    gamma = 0.5 * torch.atan2(2.0 * sigma12, sigma11 - sigma22)
    Q11 = torch.cos(gamma)
    Q12 = torch.sin(gamma)
    Q11Q11, Q11Q12, Q12Q12 = Q11 * Q11, Q11 * Q12, Q12 * Q12
    sigma_1 = Q11Q11 * sigma11 + 2.0 * Q11Q12 * sigma12 + Q12Q12 * sigma22
    sigma_2 = Q12Q12 * sigma11 - 2.0 * Q11Q12 * sigma12 + Q11Q11 * sigma22

    # unconfined compression, or shear faulting
    ratio = sigma_1 / torch.where(torch.abs(sigma_2) > 0.0, sigma_2, 1.0)
    active = ((sigma_1 >= 0.0) & (sigma_2 < 0.0)) \
        | ((sigma_1 <= 0.0) & (sigma_2 < 0.0) & (ratio <= FFRAC_THRESHOLD))
    m11 = torch.where(active, KFRAC * (a11x - Q12Q12), 0.0)
    m12 = torch.where(active, KFRAC * (a12x + Q11Q12), 0.0)
    return m11, m12


def stepa(dtei, stress, a11_k, a12_k):
    """Implicit structure-tensor update (ice_dyn_eap.F90:1664-1787 stepa).
    stress: (12, ...) region components [sp1..4, sm1..4, s12_1..4];
    a11_k/a12_k: (4, ...) per corner. Returns (a11_k, a12_k, a11, a12)
    with the corner means."""
    dteikth = 1.0 / (dtei + KTH)
    p5kth = 0.5 * KTH
    m11, m12 = _ffrac(stress[0:4], stress[4:8], stress[8:12], a11_k, a12_k)
    a11_new = (a11_k * dtei + p5kth - m11) * dteikth
    a12_new = (a12_k * dtei - m12) * dteikth
    return a11_new, a12_new, a11_new.mean(0), a12_new.mean(0)


class EAPStressResult(NamedTuple):
    stress: torch.Tensor   # (12, nyr, nxr)
    str8: torch.Tensor
    divu: torch.Tensor
    shear: torch.Tensor
    rdg_conv: torch.Tensor
    prs_sig: torch.Tensor
    e11: torch.Tensor      # strain-rate tensor (f_e11/e12/e22 history)
    e12: torch.Tensor
    e22: torch.Tensor
    ys11: torch.Tensor     # anisotropic yield-stress tensor
    ys12: torch.Tensor     # (f_yieldstress11/12/22 history)
    ys22: torch.Tensor


def stress_eap_kernel(p: dyn.EVPParams, uvE, vvE, stress, a11_k, a12_k,
                      tables, *, maskR, strengthR, gR) -> EAPStressResult:
    """One EAP stress relaxation step on the region grid
    (ice_dyn_eap.F90:1052-1467 stress_eap)."""
    dxt, dyt = gR["dxt"], gR["dyt"]
    tarear = gR["tarear"]
    divs, tens, shears = strain_rates(uvE, vvE, gR)

    sp_t, sm_t, s12_t, alphar = [], [], [], []
    for c in range(4):
        r = update_stress_rdg(divs[c], tens[c], shears[c], a11_k[c],
                              a12_k[c], strengthR, tables)
        sp_t.append(r.stressp)
        sm_t.append(r.stressm)
        s12_t.append(r.stress12)
        alphar.append(r.alphar)

    # diagnostics (every subcycle; the caller keeps the last)
    P25 = 0.25
    shear_d = P25 * tarear * torch.sqrt(
        (tens[0] + tens[1] + tens[2] + tens[3]) ** 2
        + (shears[0] + shears[1] + shears[2] + shears[3]) ** 2)
    divu = P25 * (divs[0] + divs[1] + divs[2] + divs[3]) * tarear
    rdg_conv = -torch.clamp(
        P25 * (alphar[0] + alphar[1] + alphar[2] + alphar[3]),
        max=0.0) * tarear
    # strain-rate tensor (ice_dyn_eap.F90:1278-1284) and the anisotropic
    # yield-stress tensor (:1330-1339), corner means
    dsum = divs[0] + divs[1] + divs[2] + divs[3]
    tsum = tens[0] + tens[1] + tens[2] + tens[3]
    e11 = 0.5 * P25 * (dsum + tsum) * tarear
    e12 = 0.5 * P25 * (shears[0] + shears[1] + shears[2]
                       + shears[3]) * tarear
    e22 = 0.5 * P25 * (dsum - tsum) * tarear
    spsum = sp_t[0] + sp_t[1] + sp_t[2] + sp_t[3]
    smsum = sm_t[0] + sm_t[1] + sm_t[2] + sm_t[3]
    ys11 = 0.5 * P25 * (spsum + smsum)
    ys22 = 0.5 * P25 * (spsum - smsum)
    ys12 = P25 * (s12_t[0] + s12_t[1] + s12_t[2] + s12_t[3])

    # elastic relaxation (Eq. A12-A14)
    d1, a1 = p.denom1, p.arlx1i
    comps = [(stress[c] + sp_t[c] * a1) * d1 for c in range(4)]
    comps += [(stress[4 + c] + sm_t[c] * a1) * d1 for c in range(4)]
    comps += [(stress[8 + c] + s12_t[c] * a1) * d1 for c in range(4)]
    comps = [torch.where(maskR, s, 0.0) for s in comps]
    str8 = stress_divergence(comps, dxt, dyt, gR["dxhy"], gR["dyhx"], maskR)
    return EAPStressResult(stress=torch.stack(comps), str8=str8, divu=divu,
                           shear=shear_d, rdg_conv=rdg_conv,
                           prs_sig=torch.where(maskR, strengthR, 0.0),
                           e11=e11, e12=e12, e22=e22,
                           ys11=ys11, ys12=ys12, ys22=ys22)


class EAPResult(NamedTuple):
    evp: EVPResult        # the EVP driver's surface
    a11n: torch.Tensor    # (4, ny, nx) per-corner structure tensor
    a12n: torch.Tensor
    e11: torch.Tensor     # strain-rate / yield-stress tensor diagnostics
    e12: torch.Tensor     # of the last subcycle (ice_dyn_eap.F90:
    e22: torch.Tensor     # 1278-1284, 1330-1339)
    ys11: torch.Tensor
    ys12: torch.Tensor
    ys22: torch.Tensor


def eap(dt, p: dyn.EVPParams, grid, topo: Topology, *, aice, vice, vsno,
        strength, strairxT, strairyT, uocn, vocn, uvel, vvel,
        stressp, stressm, stress12, iceumask, a11n, a12n,
        ss_tltx=None, ss_tlty=None, Cw=ct.dragio) -> EAPResult:
    """EAP dynamics driver (ice_dyn_eap.F90:66-486 eap): the interface of
    ``evp`` plus the per-corner structure tensor a11n/a12n (4, ny, nx)
    (init 0.5 / 0.0, ice_dyn_eap.F90:529-555)."""
    ny, nx = aice.shape
    tables = yield_tables(aice.dtype, aice.device)

    tmass, icetmask = dyn.icet_mask(aice, vice, vsno, grid.tmask, topo)
    maskR = _region(icetmask.to(aice.dtype), topo) > 0.5

    aiu = dyn.to_ugrid(aice, grid, topo)
    umass = dyn.to_ugrid(tmass, grid, topo)
    strairx = dyn.to_ugrid(strairxT, grid, topo, kind=FieldType.VECTOR)
    strairy = dyn.to_ugrid(strairyT, grid, topo, kind=FieldType.VECTOR)

    icem_u = grid.umask & (aiu > dyn.A_MIN) & (umass > dyn.M_MIN)
    new_pts = icem_u & (iceumask < 0.5)
    uvel = torch.where(new_pts, uocn, uvel)
    vvel = torch.where(new_pts, vocn, vvel)
    uvel = torch.where(icem_u, uvel, 0.0)
    vvel = torch.where(icem_u, vvel, 0.0)
    uvel_init, vvel_init = uvel, vvel

    umassdti = torch.where(icem_u, umass / dt, 0.0)
    fm = grid.fcor * umass
    sgn = torch.sign(fm)
    waterx = uocn * p.cosw - vocn * p.sinw * sgn
    watery = vocn * p.cosw + uocn * p.sinw * sgn
    if ss_tltx is None:
        strtltx = -fm * vocn
        strtlty = fm * uocn
    else:
        strtltx = -ct.gravit * umass * ss_tltx
        strtlty = -ct.gravit * umass * ss_tlty
    forcex = torch.where(icem_u, strairx + strtltx, 0.0)
    forcey = torch.where(icem_u, strairy + strtlty, 0.0)

    gR = _region_metrics(grid, topo, GR_NAMES)
    strengthR = _region(strength, topo)

    stressR = _extend_stress(torch.cat([stressp, stressm, stress12], dim=0),
                             topo)
    stressR = torch.where(maskR[None], stressR, 0.0)
    aR = extend(torch.cat([a11n, a12n], dim=0), topo)[:, 1:, 1:]
    a11R, a12R = aR[0:4], aR[4:8]

    dtei = float(p.ndte) / dt              # 1/dte
    u, v = uvel, vvel
    for k in range(p.ndte):
        uvE = extend(torch.stack([u, v]), topo, loc=FieldLoc.NECORNER,
                     kind=FieldType.VECTOR)
        r = stress_eap_kernel(p, uvE[0], uvE[1], stressR, a11R, a12R,
                              tables, maskR=maskR, strengthR=strengthR,
                              gR=gR)
        s = dyn.stepu(p, icemask=icem_u, aiu=aiu, strE=r.str8, uocn=uocn,
                      vocn=vocn, waterx=waterx, watery=watery, forcex=forcex,
                      forcey=forcey, umassdti=umassdti, fm=fm,
                      uarear=grid.uarear, uvel_init=uvel_init,
                      vvel_init=vvel_init, uvel=u, vvel=v, Cw=Cw)
        # structure tensor update on every 10th subcycle
        # (ice_dyn_eap.F90:417 'mod(ksub,10) == 1', ksub = k+1)
        if k % 10 == 0:
            a11R, a12R, _, _ = stepa(dtei, r.stress, a11R, a12R)
        u, v, stressR = s.uvel, s.vvel, r.stress

    strocnx, strocny, sTx_u, sTy_u = dyn.evp_finish(
        p, icemask=icem_u, uvel=u, vvel=v, uocn=uocn, vocn=vocn, aiu=aiu,
        fm=fm, Cw=Cw)
    crop = lambda a: a[..., :ny, :nx]
    res = EVPResult(
        uvel=u, vvel=v,
        stressp=crop(stressR[0:4]), stressm=crop(stressR[4:8]),
        stress12=crop(stressR[8:12]),
        iceumask=icem_u.to(aice.dtype),
        strocnx=strocnx, strocny=strocny,
        strocnxT=dyn.to_tgrid(sTx_u, grid, topo),
        strocnyT=dyn.to_tgrid(sTy_u, grid, topo),
        strairx=strairx, strairy=strairy,
        strintx=s.strintx, strinty=s.strinty,
        strtltx=strtltx, strtlty=strtlty,
        divu=crop(r.divu), shear=crop(r.shear), rdg_conv=crop(r.rdg_conv),
        # rdg_shear = 0 for closing_net in ridge_prep
        # (ice_dyn_eap.F90:1262-1264)
        rdg_shear=torch.zeros((ny, nx), dtype=aice.dtype,
                              device=aice.device),
        prs_sig=crop(r.prs_sig), fm=fm)
    return EAPResult(evp=res, a11n=crop(a11R), a12n=crop(a12R),
                     e11=crop(r.e11), e12=crop(r.e12), e22=crop(r.e22),
                     ys11=crop(r.ys11), ys12=crop(r.ys12),
                     ys22=crop(r.ys22))
