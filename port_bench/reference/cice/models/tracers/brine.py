"""Dynamic brine height tracer (PyTorch port of
``cice5_tpu/models/tracers/brine.py``; reference ice_brine.F90).

The fbri tracer is the ratio hbr/hin of the brine surface height (from
the ice bottom) to the ice thickness. Each step the brine column is raised
by bottom congelation and lowered by top/bottom melt
(``preflushing_changes``, ice_brine.F90:115-210), the ice microstructure
(porosity, brine salinity/density, permeability) is diagnosed on the bio
grid from the mushy constitutive relations (``compute_microS_mushy``,
:218-545), and the brine surface relaxes toward sea level by Darcy flow
through the ice (``update_hbrine``, :546-633).

The reference's per-cell ``remap_layers_bgc`` (ice_zbgc_shared.F90:21)
becomes a dense sample of the piecewise-linear layer profile at the
receiver positions over all cells at once, each receiver on the first
donor segment that holds it (found by a count, as the positions are
monotone). The grid constants are written on the device by fills
(``utils.device_values``), so the step captures as a CUDA graph.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.cice import constants as ct
from reference.cice.models.thermo import mushy
from reference.cice.models.thermo import shared as thshared
from reference.cice.utils import device_values

# ice_brine.F90:31-40
MAXHBR = 1.25         # brine overflows if hbr > maxhbr * hin
VISCOS = 2.1e-6       # kinematic viscosity (m^2/s)
A1, A2, A3 = -21.4, -0.886, -0.012   # brine salinity cubic in T
B1, B2 = 1000.0, 0.8                  # brine density linear in S
# ice_zbgc_shared.F90:110-126
SK_L = 0.03           # skeletal layer thickness (m)
PHI_SK = 0.30         # skeletal layer porosity
EXP_H = 3.0           # hierarchical permeability exponent
K_O = 3.0e-8          # permeability scaling factor (m^2)
RHOSI = 940.0         # average sea-ice density (kg/m^3)
HBR_MIN = 0.01        # minimum brine thickness (m)
THINS = 0.05          # minimum ice thickness for dynamic brine (m)
PHI_SNOW = 0.5        # snow porosity (ice_zbgc.F90:81)
DH_MIN = 0.001        # brine stays within dh_min of sea level (thin ice)


def bio_grids(nilyr: int, nblyr: int):
    """Vertical grids, ice top (0) to bottom (1) (ice_brine.F90:62-91):
    bgrid (nblyr+2 incl. boundary points), igrid (nblyr+1 interfaces),
    cgrid (nilyr layer midpoints of the CICE grid), as NumPy arrays."""
    zspace = 1.0 / max(1, nblyr)
    bgrid = np.zeros(nblyr + 2)
    bgrid[-1] = 1.0
    for k in range(1, nblyr + 1):
        bgrid[k] = zspace * (k - 0.5)
    igrid = np.zeros(nblyr + 1)
    igrid[-1] = 1.0
    for k in range(1, nblyr):
        igrid[k] = 0.5 * (bgrid[k] + bgrid[k + 1])
    cgrid = (np.arange(1, nilyr + 1) - 0.5) / nilyr
    return bgrid, igrid, cgrid


def _const(values, like):
    """A 1-D tensor of the NumPy grid ``values`` in ``like``'s dtype, on
    its device."""
    return device_values([float(v) for v in values], dtype=like.dtype,
                         device=like.device)


class Preflush(NamedTuple):
    hin: torch.Tensor
    hsn: torch.Tensor
    hbr_old: torch.Tensor
    dhbr_top: torch.Tensor
    dhbr_bot: torch.Tensor
    fbri: torch.Tensor
    hin_old: torch.Tensor


def preflushing_changes(aicen, vicen, vsnon, meltb, meltt, congel, snoice,
                        hice_old, fbri, first_ice) -> Preflush:
    """Brine top/bottom boundary changes before flushing
    (ice_brine.F90:115-210). hice_old: the thickness before the step;
    first_ice: 1.0 where the initial values are used."""
    active = aicen > ct.puny
    ar = 1.0 / torch.clamp(aicen, min=ct.puny)
    hin = vicen * ar
    hsn = vsnon * ar
    hin_old = torch.clamp(hin + meltb + meltt - congel - snoice, min=0.0)
    dhice = hin_old - hice_old               # subl/cond contribution
    dhbr_top = meltt - dhice - snoice
    dhbr_bot = congel - meltb

    fresh = (hice_old < ct.puny) | (hin_old < ct.puny) | (first_ice > 0.5)
    hin_old = torch.where(fresh, hin, hin_old)
    dhbr_top = torch.where(fresh | ~active, 0.0, dhbr_top)
    dhbr_bot = torch.where(fresh | ~active, 0.0, dhbr_bot)
    fbri = torch.where(fresh & active, 1.0, fbri)
    hbr_old = torch.where(fresh, fbri * hin_old, fbri * hice_old)
    return Preflush(hin=hin, hsn=hsn, hbr_old=hbr_old, dhbr_top=dhbr_top,
                    dhbr_bot=dhbr_bot, fbri=fbri, hin_old=hin_old)


def remap_to_bio_grid(tr_lyr, hice, hbr, cgrid, bgrid_pts):
    """Sample the piecewise-linear donor profile through (position, value)
    points at the bio-grid positions (ice_zbgc_shared.F90:21-132,
    cice-to-bio branch). tr_lyr: (..., nilyr) CICE-layer values; returns
    (..., nblyr+1) values at bgrid[0:nblyr+1]. Where hice > hbr the ice
    column is shifted so that both start at the brine surface."""
    hmin = torch.minimum(hbr, hice)
    top = torch.clamp(torch.minimum(-hice + hbr, -hbr + hice),
                      max=0.0)[..., None]
    ice_deeper = (hice > hbr)[..., None]
    cg = _const(cgrid, tr_lyr)
    d_mid = torch.where(ice_deeper,
                        (cg - 1.0) * hice[..., None] + hbr[..., None],
                        cg * hice[..., None])
    dpos = torch.cat([top, d_mid, hmin[..., None]], dim=-1)
    dval = torch.cat([tr_lyr[..., :1], tr_lyr, tr_lyr[..., -1:]], dim=-1)

    # receiver points: bgrid[0..nblyr]*hbr (shifted when hbr > hice)
    bg = _const(bgrid_pts, tr_lyr)
    r = torch.where(ice_deeper, bg * hbr[..., None],
                    (bg - 1.0) * hbr[..., None] + hice[..., None])
    r0 = torch.where(hice > hbr, torch.zeros_like(hbr), -hbr + hice)
    r = torch.cat([r0[..., None], r[..., 1:]], dim=-1)

    # piecewise-linear sample. The donor positions are non-decreasing, so
    # the first segment [dpos[k], dpos[k+1]] that holds x is k = j - 1,
    # j the count of donor points strictly below x (segment 0 when x is
    # the top point): the reference's "first matching segment", taken by
    # a count and a gather in place of a one-hot over every (receiver,
    # segment) pair; the sample is the same arithmetic on that segment
    nd = dpos.shape[-1]
    j = (dpos[..., None, :] < r[..., :, None]).sum(-1)      # (..., nr)
    found = ((j >= 1) & (j <= nd - 1)) | ((j == 0) & (r == dpos[..., :1]))
    k = torch.clamp(j - 1, 0, nd - 2)
    xl, xr = dpos.gather(-1, k), dpos.gather(-1, k + 1)
    yl, yr = dval.gather(-1, k), dval.gather(-1, k + 1)
    denom = torch.clamp(xr - xl, min=1e-20)
    frac = torch.clamp((r - xl) / denom, 0.0, 1.0)
    seg_val = yl + frac * (yr - yl)
    # outside the profile, clamp to its ends
    below = r > dpos[..., -1:]
    above = r < dpos[..., :1]
    return torch.where(found, seg_val,
                       torch.where(below, dval[..., -1:],
                                   torch.where(above, dval[..., :1],
                                               torch.zeros_like(seg_val))))


class MicroS(NamedTuple):
    kperm: torch.Tensor       # harmonic-average permeability (m^2)
    zphi_min: torch.Tensor    # surface porosity
    bTin: torch.Tensor        # (..., nblyr+2) temperature on bgrid
    bphin: torch.Tensor       # (..., nblyr+2) porosity on bgrid
    bSin: torch.Tensor        # (..., nblyr+2) bulk salinity on bgrid
    iphin: torch.Tensor       # (..., nblyr+1) porosity on igrid
    ibrine_sal: torch.Tensor  # (..., nblyr+1)
    ibrine_rho: torch.Tensor  # (..., nblyr+1)


def compute_microS_mushy(zSin, zqin, hice_old, hbr_old, sss, sst,
                         nblyr: int) -> MicroS:
    """Ice microstructure on the bio grid from the mushy constitutive
    relations (ice_brine.F90:218-545 compute_microS_mushy +
    prepare_hbrine). zSin/zqin: (..., nilyr) salinity/enthalpy profiles.
    A float32 permeability power law can reach subnormals, which PyTorch
    keeps (XLA's CPU backend flushes them)."""
    nilyr = zSin.shape[-1]
    bgrid, igrid, cgrid = bio_grids(nilyr, nblyr)
    hbr_old = torch.minimum(hbr_old, MAXHBR * hice_old)

    bS = remap_to_bio_grid(zSin, hice_old, hbr_old, cgrid,
                           bgrid[:nblyr + 1])
    bq = remap_to_bio_grid(zqin, hice_old, hbr_old, cgrid,
                           bgrid[:nblyr + 1])
    bq = torch.clamp(bq, max=0.0)
    bS = torch.clamp(bS, min=thshared.min_salin)
    bT = mushy.temperature_mush(bq, bS)

    # append the ocean point (index nblyr+1)
    bSin = torch.cat([bS, sss[..., None]], dim=-1)
    bTin = torch.cat([bT, sst[..., None]], dim=-1)

    # equilibrium brine salinity/density and porosity
    # (ice_brine.F90:450-467)
    brine_sal = A1 * bTin + A2 * bTin ** 2 + A3 * bTin ** 3
    brine_rho = B1 + B2 * brine_sal
    bphin = torch.clamp(bSin * RHOSI
                        / torch.clamp(brine_sal * brine_rho, min=ct.puny),
                        ct.puny, 1.0)
    brine_sal = torch.cat([brine_sal[..., :-1], sss[..., None]], dim=-1)
    brine_rho = torch.cat([brine_rho[..., :-1],
                           torch.full_like(sss, ct.rhow)[..., None]], dim=-1)
    bphin = torch.cat([bphin[..., :-1], torch.ones_like(sss)[..., None]],
                      dim=-1)
    kin = K_O * bphin ** EXP_H               # (..., nblyr+2)

    # interface values by distance-weighted averaging (ice_brine.F90:492-520)
    ig = _const(igrid, zSin)
    igrp = ig[2:] - ig[1:-1]                 # (nblyr-1,)
    igrm = ig[1:-1] - ig[:-2]
    rigr = 1.0 / (ig[2:] - ig[:-2])

    def mid(f):
        return (f[..., 2:nblyr + 1] * igrp + f[..., 1:nblyr] * igrm) * rigr

    ibrine_sal = torch.cat([brine_sal[..., 1:2], mid(brine_sal),
                            brine_sal[..., -1:]], dim=-1)
    ibrine_rho = torch.cat([brine_rho[..., 1:2], mid(brine_rho),
                            brine_rho[..., -1:]], dim=-1)
    iphin = torch.cat([bphin[..., 1:2],
                       torch.clamp(mid(bphin), ct.puny, 1.0),
                       bphin[..., nblyr:nblyr + 1]], dim=-1)

    zphi_min = bphin[..., 1]
    # harmonic mean of kin over layers 2..nblyr+1 (1-based), zero where
    # any layer is impermeable (ice_brine.F90:487-531)
    kin_int = kin[..., 1:nblyr + 1]
    k_min = kin_int.amin(-1)
    ksum = (1.0 / torch.clamp(kin_int, min=1e-30)).sum(-1)
    kperm = torch.where(k_min > 0.0, nblyr / ksum, 0.0)
    return MicroS(kperm=kperm, zphi_min=zphi_min, bTin=bTin, bphin=bphin,
                  bSin=bSin, iphin=iphin, ibrine_sal=ibrine_sal,
                  ibrine_rho=ibrine_rho)


class HbrineResult(NamedTuple):
    hbr: torch.Tensor
    fbri: torch.Tensor
    darcy_V: torch.Tensor
    dhS_top: torch.Tensor


def update_hbrine(dt, meltb, meltt, melts, hin, hsn, hin_old, hbr_old,
                  dhS_top, dhS_bottom, kperm, zphi_min) -> HbrineResult:
    """Brine surface evolution with Darcy relaxation toward sea level
    (ice_brine.F90:546-633 update_hbrine), dense over all cells."""
    h_ocn = RHOSI / ct.rhow * hin + ct.rhos / ct.rhow * hsn
    thick = (hbr_old > THINS) & (hin_old > THINS)

    # thick branch
    dtop = -torch.clamp(torch.minimum(hin_old - hbr_old, meltt), min=0.0) \
        * ct.rhoi / ct.rhow
    dtop = dtop - torch.clamp(melts, min=0.0) * ct.rhos / ct.rhow
    dhbr = dhS_bottom - dtop
    hbr_t = torch.clamp(hbr_old + dhbr, min=HBR_MIN)
    hbrocn = hbr_t - h_ocn
    darcy_coeff = torch.clamp(kperm * ct.gravit
                              / (VISCOS * torch.clamp(hbr_old, min=ct.puny)),
                              min=0.0)
    phi_eff = torch.where((hbrocn < 0.0) & (hbr_t >= hin), PHI_SNOW,
                          zphi_min)
    decay = torch.exp(-darcy_coeff / torch.clamp(phi_eff, min=ct.puny) * dt)
    hbrocn_new = hbrocn * decay
    hbr_flushed = torch.where(
        hbrocn > 0.0,
        torch.where(hbr_t > THINS,
                    torch.clamp(h_ocn + hbrocn_new, min=THINS), hbr_t),
        torch.where(hbrocn < 0.0,
                    torch.clamp(h_ocn + hbrocn_new, min=HBR_MIN), hbr_t))
    hbrocn_fin = hbr_flushed - h_ocn
    darcy_V = -torch.sign(hbrocn) * (hbrocn - hbrocn_fin) / dt * phi_eff
    dtop_out = dtop + torch.sign(hbrocn) * (hbrocn - hbrocn_fin)

    # thin branch (ice_brine.F90:621-628)
    hbr_min_thin = torch.clamp(hin, max=THINS)
    hbr_thin = torch.maximum(hbr_min_thin, hbr_old + dhS_bottom - dhS_top)
    dhbr_hin = hbr_thin - h_ocn
    hbr_thin = torch.where(torch.abs(dhbr_hin) > DH_MIN,
                           torch.maximum(hbr_min_thin,
                                         h_ocn + torch.sign(dhbr_hin)
                                         * DH_MIN),
                           hbr_thin)

    hbr = torch.where(thick, hbr_flushed, hbr_thin)
    darcy = torch.where(thick, darcy_V, 0.0)
    dtop_fin = torch.where(thick, dtop_out, dhS_top)
    fbri = hbr / torch.clamp(hin, min=ct.puny)
    return HbrineResult(hbr=hbr, fbri=fbri, darcy_V=darcy, dhS_top=dtop_fin)
