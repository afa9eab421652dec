"""CCSM3 shortwave radiation: albedos and absorbed solar (PyTorch port of
``cice5_tpu/models/radiation/ccsm3.py``; ice_shortwave.F90
compute_albedos :652, constant_albedos :867, absorbed_solar :1020):
Beer's-law absorption of penetrating visible radiation with thickness-
and temperature-dependent albedos. Dense over any batch shape *B; ice-free
cells get the ocean albedo and zero absorption.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference.cice import constants as ct

I0VIS = 0.70      # fraction of visible SW penetrating the surface
DT_MELT = 1.0
DALB_MLT = -0.075
DALB_MLTV = -0.1
DALB_MLTI = -0.15


class Albedos(NamedTuple):
    alvdrn: torch.Tensor   # combined ice+snow albedos (coupler)
    alidrn: torch.Tensor
    alvdfn: torch.Tensor
    alidfn: torch.Tensor
    alvdrni: torch.Tensor  # bare ice
    alidrni: torch.Tensor
    alvdfni: torch.Tensor
    alidfni: torch.Tensor
    alvdrns: torch.Tensor  # snow
    alidrns: torch.Tensor
    alvdfns: torch.Tensor
    alidfns: torch.Tensor
    albin: torch.Tensor    # broadband diagnostics
    albsn: torch.Tensor


class AbsorbedSolar(NamedTuple):
    fswsfc: torch.Tensor
    fswint: torch.Tensor
    fswthru: torch.Tensor
    Iswabs: torch.Tensor      # (nilyr, *B)
    fswpenl: torch.Tensor     # (nilyr+1, *B) penetrating SW at interfaces


def compute_albedos(aicen, vicen, vsnon, Tsfcn, *, albicev, albicei,
                    albsnowv, albsnowi, ahmax) -> Albedos:
    """CCSM3 thickness/temperature-dependent albedos
    (ice_shortwave.F90:652-866)."""
    mask = aicen > ct.puny
    ai = torch.clamp(aicen, min=ct.puny)
    hi = torch.where(mask, vicen / ai, 0.0)
    hs = torch.where(mask, vsnon / ai, 0.0)

    fhtan = math.atan(ahmax * 4.0)
    fh = torch.clamp(torch.atan(hi * 4.0) / fhtan, max=1.0)
    albo = ct.albocn * (1.0 - fh)
    alvdfni = albicev * fh + albo
    alidfni = albicei * fh + albo

    dTs = ct.Timelt - Tsfcn
    fT = torch.clamp(dTs / DT_MELT - 1.0, max=0.0)
    alvdfni = torch.clamp(alvdfni - DALB_MLT * fT, min=ct.albocn)
    alidfni = torch.clamp(alidfni - DALB_MLT * fT, min=ct.albocn)

    has_snow = hs > ct.puny
    alvdfns = torch.where(has_snow, albsnowv - DALB_MLTV * fT, ct.albocn)
    alidfns = torch.where(has_snow, albsnowi - DALB_MLTI * fT, ct.albocn)

    # direct = diffuse in CCSM3
    alvdrni, alidrni = alvdfni, alidfni
    alvdrns, alidrns = alvdfns, alidfns

    asnow = torch.where(has_snow, hs / (hs + ct.snowpatch), 0.0)
    mix = lambda i, s: torch.where(mask, i * (1.0 - asnow) + s * asnow,
                                   ct.albocn)
    alvdfn = mix(alvdfni, alvdfns)
    alidfn = mix(alidfni, alidfns)
    alvdrn = mix(alvdrni, alvdrns)
    alidrn = mix(alidrni, alidrns)

    albin = torch.where(mask, ct.awtvdr * alvdrni + ct.awtidr * alidrni
                        + ct.awtvdf * alvdfni + ct.awtidf * alidfni, 0.0)
    albsn = torch.where(mask, ct.awtvdr * alvdrns + ct.awtidr * alidrns
                        + ct.awtvdf * alvdfns + ct.awtidf * alidfns, 0.0)

    w = lambda a: torch.where(mask, a, ct.albocn)
    return Albedos(alvdrn, alidrn, alvdfn, alidfn,
                   w(alvdrni), w(alidrni), w(alvdfni), w(alidfni),
                   w(alvdrns), w(alidrns), w(alvdfns), w(alidfns),
                   albin, albsn)


def constant_albedos(aicen, vsnon, Tsfcn) -> Albedos:
    """Four-constant albedo scheme (ice_shortwave.F90:867-1016)."""
    warmice, coldice = 0.68, 0.70
    warmsnow, coldsnow = 0.77, 0.81
    mask = aicen > ct.puny
    hs = torch.where(mask, vsnon / torch.clamp(aicen, min=ct.puny), 0.0)
    has_snow = hs > ct.puny
    warm = Tsfcn >= -2.0 * ct.puny
    f = lambda v: torch.full_like(aicen, v)
    alb_i = torch.where(warm, f(warmice), f(coldice))
    alb_s = torch.where(warm, f(warmsnow), f(coldsnow))
    albx = torch.where(has_snow, alb_s, alb_i)
    a = torch.where(mask, albx, ct.albocn)
    ai = torch.where(mask, alb_i, ct.albocn)
    as_ = torch.where(mask, alb_s, ct.albocn)
    albin = torch.where(mask, alb_i, 0.0)
    albsn = torch.where(mask, alb_s, 0.0)
    return Albedos(a, a, a, a, ai, ai, ai, ai, as_, as_, as_, as_,
                   albin, albsn)


def absorbed_solar(aicen, vicen, vsnon, swvdr, swvdf, swidr, swidf,
                   alb: Albedos, *, nilyr, heat_capacity=True) -> AbsorbedSolar:
    """Partition net SW into surface/interior/transmitted
    (ice_shortwave.F90:1020-1240): all IR absorbed at the surface,
    visible attenuated by Beer's law with kappav through the ice."""
    mask = aicen > ct.puny
    ai = torch.clamp(aicen, min=ct.puny)
    hs = torch.where(mask, vsnon / ai, 0.0)
    hi = torch.where(mask, vicen / ai, 0.0)
    asnow = torch.where(hs > ct.puny, hs / (hs + ct.snowpatch), 0.0)

    swabsv = (swvdr * ((1 - alb.alvdrni) * (1 - asnow)
                       + (1 - alb.alvdrns) * asnow)
              + swvdf * ((1 - alb.alvdfni) * (1 - asnow)
                         + (1 - alb.alvdfns) * asnow))
    swabsi = (swidr * ((1 - alb.alidrni) * (1 - asnow)
                       + (1 - alb.alidrns) * asnow)
              + swidf * ((1 - alb.alidfni) * (1 - asnow)
                         + (1 - alb.alidfns) * asnow))
    swabs = swabsv + swabsi

    fswpen = (swvdr * (1 - alb.alvdrni) * (1 - asnow) * I0VIS
              + swvdf * (1 - alb.alvdfni) * (1 - asnow) * I0VIS)
    fswsfc = swabs - fswpen

    hilyr = hi / nilyr
    ks = torch.arange(1, nilyr + 1, dtype=swvdr.dtype, device=swvdr.device)
    # transmittance at the bottom of each layer: exp(-kappav * hilyr * k)
    tran = torch.exp(-ct.kappav * hilyr[None]
                     * ks.reshape((nilyr,) + (1,) * hi.dim()))
    trantop = torch.cat([torch.ones_like(tran[:1]), tran[:-1]], dim=0)
    Iswabs = fswpen[None] * (trantop - tran)
    fswpenl = torch.cat([fswpen[None], fswpen[None] * tran], dim=0)

    fswthru = fswpen * tran[nilyr - 1]
    fswint = fswpen - fswthru

    if not heat_capacity:
        fswsfc = fswsfc + fswint
        fswint = torch.zeros_like(fswint)
        Iswabs = torch.zeros_like(Iswabs)

    m = mask
    return AbsorbedSolar(
        fswsfc=torch.where(m, fswsfc, 0.0),
        fswint=torch.where(m, fswint, 0.0),
        fswthru=torch.where(m, fswthru, 0.0),
        Iswabs=torch.where(m[None], Iswabs, 0.0),
        fswpenl=torch.where(m[None], fswpenl, 0.0))


def shortwave_ccsm3(aicen, vicen, vsnon, Tsfcn, swvdr, swvdf, swidr, swidf,
                    *, nilyr, albedo_type="ccsm3", albicev=0.78,
                    albicei=0.36, albsnowv=0.98, albsnowi=0.70, ahmax=0.3,
                    heat_capacity=True):
    """Full CCSM3 radiation (ice_shortwave.F90:425-650 shortwave_ccsm3):
    albedos then absorption. Returns (Albedos, AbsorbedSolar); the snow
    absorption Sswabs is identically zero in this scheme."""
    if albedo_type == "constant":
        alb = constant_albedos(aicen, vsnon, Tsfcn)
    else:
        alb = compute_albedos(aicen, vicen, vsnon, Tsfcn, albicev=albicev,
                              albicei=albicei, albsnowv=albsnowv,
                              albsnowi=albsnowi, ahmax=ahmax)
    absr = absorbed_solar(aicen, vicen, vsnon, swvdr, swvdf, swidr, swidf,
                          alb, nilyr=nilyr, heat_capacity=heat_capacity)
    return alb, absr
