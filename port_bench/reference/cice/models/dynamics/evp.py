"""Elastic-viscous-plastic (EVP) sea-ice dynamics (PyTorch port of
``cice5_tpu/models/dynamics/evp.py``).

ice_dyn_evp.F90: the ``evp(dt)`` driver (:68) and the 4-corner bilinear
``stress`` kernel (:520-849), with the momentum solve of
ice_dyn_shared.F90:623 (stepu). The stress kernel runs on the
(ny+1, nx+1) "region" covering the interior plus the N/E ghost row and
column, so stepu's stress divergence needs no second halo per subcycle.

The ndte-subcycle sweep has two implementations with one signature:
``subcycle_sweep`` (plain PyTorch, the CPU path and the reference for the
kernel) and ``evp_sweep``, which launches the hand-written CUDA kernel
(the ``evp_sweep`` entry of ``csrc/evp_resident.cu``: the whole sweep in
one persistent, SM-resident launch) for tensors on the GPU. ``evp`` always calls
``evp_sweep``; a CPU tensor takes the plain version there. Its prep
(``evp_prep``) and finish (``evp_result``) are shared with the fused
driver of ``evp_algorithm="pallas"`` (``reference.cice/ops/evp_fused.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.constants import FieldLoc, FieldType
from reference.cice.models.dynamics import shared as dyn
from reference.cice.parallel import (Topology, extend, extend_wide,
                                      extend_wide_groups)

P027, P055, P111, P166, P222, P25, P333, P5 = (
    0.027777777777777776, 0.05555555555555555, 0.1111111111111111,
    0.16666666666666666, 0.2222222222222222, 0.25, 0.3333333333333333, 0.5)

# region metric planes the sweep reads, in the kernel's stacking order
GR_NAMES = ("dxt", "dyt", "dxhy", "dyhx", "cxp", "cyp", "cxm", "cym",
            "tarear", "tinyarea")
# U-point planes the sweep reads, in the kernel's stacking order
U_NAMES = ("icem_u", "aiu", "uocn", "vocn", "waterx", "watery", "forcex",
           "forcey", "umassdti", "fm", "uarear", "uvel_init", "vvel_init")


class StressResult(NamedTuple):
    stress: torch.Tensor   # (12, nyr, nxr) updated stress components
    str8: torch.Tensor     # (8, nyr, nxr) stress-divergence combinations
    divu: torch.Tensor
    shear: torch.Tensor
    rdg_conv: torch.Tensor
    rdg_shear: torch.Tensor
    prs_sig: torch.Tensor


def stress_kernel(p: dyn.EVPParams, uvE, vvE, stress, *, maskR, strengthR,
                  gR) -> StressResult:
    """One EVP stress relaxation step on the region grid
    (ice_dyn_evp.F90:520-849 'stress').

    uvE/vvE: extended velocities (ny+2, nx+2). stress: (12, nyr, nxr) with
    component order [sp1..4, sm1..4, s12_1..4]. maskR: icetmask on region.
    gR: dict of region metric arrays (GR_NAMES)."""
    dxt, dyt = gR["dxt"], gR["dyt"]
    dxhy, dyhx = gR["dxhy"], gR["dyhx"]
    tarear, tinyarea = gR["tarear"], gR["tinyarea"]

    ((divune, divunw, divusw, divuse),
     (tensionne, tensionnw, tensionsw, tensionse),
     (shearne, shearnw, shearsw, shearse)) = strain_rates(uvE, vvE, gR)

    ecci = p.ecci
    Deltane = torch.sqrt(divune ** 2 + ecci * (tensionne ** 2
                                               + shearne ** 2))
    Deltanw = torch.sqrt(divunw ** 2 + ecci * (tensionnw ** 2
                                               + shearnw ** 2))
    Deltase = torch.sqrt(divuse ** 2 + ecci * (tensionse ** 2
                                               + shearse ** 2))
    Deltasw = torch.sqrt(divusw ** 2 + ecci * (tensionsw ** 2
                                               + shearsw ** 2))

    # ridging/diagnostic terms (:667-677); the caller keeps only the
    # last subcycle's values
    divu = P25 * (divune + divunw + divuse + divusw) * tarear
    Delta_avg = P25 * (Deltane + Deltanw + Deltase + Deltasw) * tarear
    rdg_conv = -torch.clamp(divu, max=0.0)
    rdg_shear = P5 * (Delta_avg - torch.abs(divu))
    shear = P25 * tarear * torch.sqrt(
        (tensionne + tensionnw + tensionse + tensionsw) ** 2
        + (shearne + shearnw + shearse + shearsw) ** 2)

    # replacement pressure / Delta (:683-699)
    tiny = torch.clamp(tinyarea, min=1e-30)
    c0ne = strengthR / torch.maximum(Deltane, tiny)
    c0nw = strengthR / torch.maximum(Deltanw, tiny)
    c0sw = strengthR / torch.maximum(Deltasw, tiny)
    c0se = strengthR / torch.maximum(Deltase, tiny)
    prs_sig = c0ne * Deltane

    c1ne, c1nw = c0ne * p.arlx1i, c0nw * p.arlx1i
    c1sw, c1se = c0sw * p.arlx1i, c0se * p.arlx1i
    c0ne, c0nw = c1ne * ecci, c1nw * ecci
    c0sw, c0se = c1sw * ecci, c1se * ecci

    d1 = p.denom1
    sp1 = (stress[0] + c1ne * (divune - Deltane)) * d1
    sp2 = (stress[1] + c1nw * (divunw - Deltanw)) * d1
    sp3 = (stress[2] + c1sw * (divusw - Deltasw)) * d1
    sp4 = (stress[3] + c1se * (divuse - Deltase)) * d1
    sm1 = (stress[4] + c0ne * tensionne) * d1
    sm2 = (stress[5] + c0nw * tensionnw) * d1
    sm3 = (stress[6] + c0sw * tensionsw) * d1
    sm4 = (stress[7] + c0se * tensionse) * d1
    s121 = (stress[8] + c0ne * shearne * P5) * d1
    s122 = (stress[9] + c0nw * shearnw * P5) * d1
    s123 = (stress[10] + c0sw * shearsw * P5) * d1
    s124 = (stress[11] + c0se * shearse * P5) * d1

    m = maskR
    comps = [torch.where(m, s, 0.0) for s in
             (sp1, sp2, sp3, sp4, sm1, sm2, sm3, sm4, s121, s122, s123,
              s124)]
    str8 = stress_divergence(comps, dxt, dyt, dxhy, dyhx, maskR)
    return StressResult(stress=torch.stack(comps), str8=str8, divu=divu,
                        shear=shear, rdg_conv=rdg_conv,
                        rdg_shear=rdg_shear, prs_sig=prs_sig)


def strain_rates(uvE, vvE, gR):
    """4-corner strain rates * area (ice_dyn_evp.F90:627-655). Returns
    (div, tension, shear) tuples in corner order (ne, nw, sw, se)."""
    u00, uW = uvE[1:, 1:], uvE[1:, :-1]
    uS, uSW = uvE[:-1, 1:], uvE[:-1, :-1]
    v00, vW = vvE[1:, 1:], vvE[1:, :-1]
    vS, vSW = vvE[:-1, 1:], vvE[:-1, :-1]
    dxt, dyt = gR["dxt"], gR["dyt"]
    cxp, cyp, cxm, cym = gR["cxp"], gR["cyp"], gR["cxm"], gR["cym"]

    divune = cyp * u00 - dyt * uW + cxp * v00 - dxt * vS
    divunw = cym * uW + dyt * u00 + cxp * vW - dxt * vSW
    divusw = cym * uSW + dyt * uS + cxm * vSW + dxt * vW
    divuse = cyp * uS - dyt * uSW + cxm * vS + dxt * v00

    tensionne = -cym * u00 - dyt * uW + cxm * v00 + dxt * vS
    tensionnw = -cyp * uW + dyt * u00 + cxm * vW + dxt * vSW
    tensionsw = -cyp * uSW + dyt * uS + cxp * vSW - dxt * vW
    tensionse = -cym * uS - dyt * uSW + cxp * vS - dxt * v00

    shearne = -cym * v00 - dyt * vW - cxm * u00 - dxt * uS
    shearnw = -cyp * vW + dyt * v00 - cxm * uW - dxt * uSW
    shearsw = -cyp * vSW + dyt * vS - cxp * uSW + dxt * uW
    shearse = -cym * vS - dyt * vSW - cxp * uS + dxt * u00

    return ((divune, divunw, divusw, divuse),
            (tensionne, tensionnw, tensionsw, tensionse),
            (shearne, shearnw, shearsw, shearse))


def stress_divergence(comps, dxt, dyt, dxhy, dyhx, maskR):
    """Stress-divergence combinations str1..str8 for the momentum
    equation (ice_dyn_evp.F90:722-849). comps: 12 region arrays
    [sp1..4, sm1..4, s12_1..4]."""
    sp1, sp2, sp3, sp4, sm1, sm2, sm3, sm4, s121, s122, s123, s124 = comps

    ssigpn = sp1 + sp2
    ssigps = sp3 + sp4
    ssigpe = sp1 + sp4
    ssigpw = sp2 + sp3
    ssigp1 = (sp1 + sp3) * P055
    ssigp2 = (sp2 + sp4) * P055

    ssigmn = sm1 + sm2
    ssigms = sm3 + sm4
    ssigme = sm1 + sm4
    ssigmw = sm2 + sm3
    ssigm1 = (sm1 + sm3) * P055
    ssigm2 = (sm2 + sm4) * P055

    ssig12n = s121 + s122
    ssig12s = s123 + s124
    ssig12e = s121 + s124
    ssig12w = s122 + s123
    ssig121 = (s121 + s123) * P111
    ssig122 = (s122 + s124) * P111

    csigpne = P111 * sp1 + ssigp2 + P027 * sp3
    csigpnw = P111 * sp2 + ssigp1 + P027 * sp4
    csigpsw = P111 * sp3 + ssigp2 + P027 * sp1
    csigpse = P111 * sp4 + ssigp1 + P027 * sp2

    csigmne = P111 * sm1 + ssigm2 + P027 * sm3
    csigmnw = P111 * sm2 + ssigm1 + P027 * sm4
    csigmsw = P111 * sm3 + ssigm2 + P027 * sm1
    csigmse = P111 * sm4 + ssigm1 + P027 * sm2

    csig12ne = P222 * s121 + ssig122 + P055 * s123
    csig12nw = P222 * s122 + ssig121 + P055 * s124
    csig12sw = P222 * s123 + ssig122 + P055 * s121
    csig12se = P222 * s124 + ssig121 + P055 * s122

    str12ew = P5 * dxt * (P333 * ssig12e + P166 * ssig12w)
    str12we = P5 * dxt * (P333 * ssig12w + P166 * ssig12e)
    str12ns = P5 * dyt * (P333 * ssig12n + P166 * ssig12s)
    str12sn = P5 * dyt * (P333 * ssig12s + P166 * ssig12n)

    strp_n = P25 * dyt * (P333 * ssigpn + P166 * ssigps)
    strm_n = P25 * dyt * (P333 * ssigmn + P166 * ssigms)
    str1 = -strp_n - strm_n - str12ew + dxhy * (-csigpne + csigmne) \
        + dyhx * csig12ne
    str2 = strp_n + strm_n - str12we + dxhy * (-csigpnw + csigmnw) \
        + dyhx * csig12nw

    strp_s = P25 * dyt * (P333 * ssigps + P166 * ssigpn)
    strm_s = P25 * dyt * (P333 * ssigms + P166 * ssigmn)
    str3 = -strp_s - strm_s + str12ew + dxhy * (-csigpse + csigmse) \
        + dyhx * csig12se
    str4 = strp_s + strm_s + str12we + dxhy * (-csigpsw + csigmsw) \
        + dyhx * csig12sw

    strp_e = P25 * dxt * (P333 * ssigpe + P166 * ssigpw)
    strm_e = P25 * dxt * (P333 * ssigme + P166 * ssigmw)
    str5 = -strp_e + strm_e - str12ns - dyhx * (csigpne + csigmne) \
        + dxhy * csig12ne
    str6 = strp_e - strm_e - str12sn - dyhx * (csigpse + csigmse) \
        + dxhy * csig12se

    strp_w = P25 * dxt * (P333 * ssigpw + P166 * ssigpe)
    strm_w = P25 * dxt * (P333 * ssigmw + P166 * ssigme)
    str7 = -strp_w + strm_w + str12ns - dyhx * (csigpnw + csigmnw) \
        + dxhy * csig12nw
    str8c = strp_w - strm_w + str12sn - dyhx * (csigpsw + csigmsw) \
        + dxhy * csig12sw

    return torch.stack([torch.where(maskR, s, 0.0) for s in
                        (str1, str2, str3, str4, str5, str6, str7, str8c)])


class EVPResult(NamedTuple):
    uvel: torch.Tensor
    vvel: torch.Tensor
    stressp: torch.Tensor
    stressm: torch.Tensor
    stress12: torch.Tensor
    iceumask: torch.Tensor
    strocnx: torch.Tensor
    strocny: torch.Tensor
    strocnxT: torch.Tensor   # on the T grid, for thermo/coupling
    strocnyT: torch.Tensor
    strairx: torch.Tensor
    strairy: torch.Tensor
    strintx: torch.Tensor
    strinty: torch.Tensor
    strtltx: torch.Tensor
    strtlty: torch.Tensor
    divu: torch.Tensor
    shear: torch.Tensor
    rdg_conv: torch.Tensor
    rdg_shear: torch.Tensor
    prs_sig: torch.Tensor
    fm: torch.Tensor         # mass-weighted Coriolis fcor*umass


def _region(field_2d, topo, loc=FieldLoc.CENTER, kind=FieldType.SCALAR):
    """(ny, nx) -> (ny+1, nx+1) region incl. the N/E ghost row/col."""
    return extend(field_2d, topo, loc=loc, kind=kind)[..., 1:, 1:]


# one-sided metric coefficients map onto their partners under the
# 180-degree tripole fold: ghost cyp = -cym(image) etc. (definitions
# ice_grid.F90:356-367)
_METRIC_FOLD = {"cxp": ("cxm", -1.0), "cxm": ("cxp", -1.0),
                "cyp": ("cym", -1.0), "cym": ("cyp", -1.0),
                "dxhy": ("dxhy", -1.0), "dyhx": ("dyhx", -1.0)}


def _region_metrics(grid, topo, names):
    """Ghost-extended region metrics, with the fold-partner ghosts of the
    one-sided coefficients on a tripole seam. On the T-fold a T point lies
    on the fold, and the ghost row of a one-sided coefficient is the
    partner's fold image of the top row, the top row kept as it is
    (``halo.extend`` with ``fold_partner``); the JAX package raises there
    (its ``extend`` takes no partner on an on-fold staggering)."""
    out = {}
    tri = topo.ns in ("tripole", "tripoleT")
    for k in names:
        f = getattr(grid, k)
        if tri and k in _METRIC_FOLD:
            pname, sgn = _METRIC_FOLD[k]
            out[k] = extend(f, topo, fold_partner=getattr(grid, pname),
                            fold_sign=sgn)[..., 1:, 1:]
        else:
            out[k] = _region(f, topo)
    return out


def _extend_stress(stress0, topo):
    """Seed the (12, ny+1, nx+1)-region ghost ring of the stress state; on
    a U-fold seam the north ghost row holds the folded partner-corner
    component (ice_HaloUpdate_stress, mpi/ice_boundary.F90:5564). On the
    T-fold the JAX package seeds the plain CENTER fold, without the
    partner permutation (cice5_tpu/models/dynamics/evp.py:299-316), and so
    does the port. On a mesh only the top row of ranks takes the partner
    row (``cice5_tpu/models/dynamics/evp.py:312-315``); every rank makes
    both exchanges."""
    E1 = extend(stress0, topo)
    if topo.ns != "tripole":
        return E1[:, 1:, 1:]
    E2 = extend(_fold_partner_stress(stress0), topo)
    if not topo.is_top:
        return E1[:, 1:, 1:]
    return torch.cat([E1[:, :-1, :], E2[:, -1:, :]], dim=1)[:, 1:, 1:]


def _fold_partner_stress(stress0):
    """The 12 stress components with the corner partners the tripole fold
    swaps, NE<->SW and NW<->SE of each of (stressp, stressm, stress12)
    (ice_dyn_evp.F90:416-481 ice_HaloUpdate_stress pairs): components
    (2, 3, 0, 1) of each four."""
    return stress0.unflatten(0, (3, 2, 2)).flip(1).flatten(0, 2)


def subcycle_sweep(p: dyn.EVPParams, ndte: int, topo: Topology, *, uvel,
                   vvel, stressR, maskR, strengthR, gR, icem_u, aiu, uocn,
                   vocn, waterx, watery, forcex, forcey, umassdti, fm,
                   uarear, uvel_init, vvel_init, Cw):
    """The ndte-iteration EVP stress/momentum subcycling
    (ice_dyn_evp.F90:336-410) in plain PyTorch: the CPU path and the
    reference the CUDA kernel is held against. Returns
    (u, v, stressR, diags) with diags = (divuR, shearR, rdg_convR,
    rdg_shearR, prs_sigR, strintx, strinty) of the last subcycle."""
    u, v, stress = uvel, vvel, stressR
    zR = torch.zeros(maskR.shape, dtype=uvel.dtype, device=uvel.device)
    z2 = torch.zeros_like(uvel)
    diags = (zR, zR, zR, zR, zR, z2, z2)
    for _ in range(ndte):
        uvE = extend(torch.stack([u, v]), topo, loc=FieldLoc.NECORNER,
                     kind=FieldType.VECTOR)
        r = stress_kernel(p, uvE[0], uvE[1], stress, maskR=maskR,
                          strengthR=strengthR, gR=gR)
        s = dyn.stepu(p, icemask=icem_u, aiu=aiu, strE=r.str8, uocn=uocn,
                      vocn=vocn, waterx=waterx, watery=watery,
                      forcex=forcex, forcey=forcey, umassdti=umassdti,
                      fm=fm, uarear=uarear, uvel_init=uvel_init,
                      vvel_init=vvel_init, uvel=u, vvel=v, Cw=Cw)
        u, v, stress = s.uvel, s.vvel, r.stress
        diags = (r.divu, r.shear, r.rdg_conv, r.rdg_shear, r.prs_sig,
                 s.strintx, s.strinty)
    return u, v, stress, diags


def kernel_args(*, uvel, vvel, stressR, maskR, strengthR, gR, icem_u,
                **planes):
    """The sweep inputs packed as the EVP kernels (``kernels.evp_sweep``,
    ``kernels.evp_fused``) take them: contiguous planes, the metrics stacked
    in GR_NAMES order, the U-point planes in U_NAMES order plus a Cw plane
    when ``Cw`` is one, masks as 0/1 floats."""
    dtype = uvel.dtype
    Cw = planes.pop("Cw")
    planes["icem_u"] = icem_u.to(dtype)
    uin = torch.stack([planes[k] for k in U_NAMES])
    cw_plane = torch.is_tensor(Cw) and Cw.dim() > 0
    if cw_plane:
        uin = torch.cat([uin, Cw.to(dtype)[None]])
    return dict(u=uvel.contiguous(), v=vvel.contiguous(),
                stress=stressR.contiguous(),
                maskR=maskR.to(dtype).contiguous(),
                strengthR=strengthR.contiguous(),
                gR=torch.stack([gR[k] for k in GR_NAMES]), uin=uin,
                cw_plane=cw_plane, Cw=0.0 if cw_plane else float(Cw))


def fold_mode(topo: Topology) -> int:
    """The EVP kernels' fold mode of a north seam: 0 none, 1 the U-fold
    (``tripole``), 2 the T-fold (``tripoleT``)."""
    return {"tripole": 1, "tripoleT": 2}.get(topo.ns, 0)


def evp_sweep(p: dyn.EVPParams, ndte: int, topo: Topology, *, uvel, vvel,
              stressR, maskR, strengthR, gR, icem_u, aiu, uocn, vocn,
              waterx, watery, forcex, forcey, umassdti, fm, uarear,
              uvel_init, vvel_init, Cw):
    """The reference's EVP sweep: ``subcycle_sweep``, the plain PyTorch
    subcycle loop, on whatever device the tensors are on."""
    return subcycle_sweep(
        p, ndte, topo, uvel=uvel, vvel=vvel, stressR=stressR,
        maskR=maskR, strengthR=strengthR, gR=gR, icem_u=icem_u,
        aiu=aiu, uocn=uocn, vocn=vocn, waterx=waterx, watery=watery,
        forcex=forcex, forcey=forcey, umassdti=umassdti, fm=fm,
        uarear=uarear, uvel_init=uvel_init, vvel_init=vvel_init, Cw=Cw)


def _prep_points(dt, p: dyn.EVPParams, grid, topo: Topology, *, aice, vice,
                 vsno, strairxT, strairyT, uocn, vocn, uvel, vvel, iceumask,
                 ss_tltx=None, ss_tlty=None):
    """The point fields of the EVP preparation (ice_dyn_evp.F90:68-330):
    masses and masks, T -> U interpolation and the forcing terms. Returns
    (fields, {strairx, strairy, strtltx, strtlty})."""
    # prep1: masses + masks
    tmass, icetmask = dyn.icet_mask(aice, vice, vsno, grid.tmask, topo)

    # T -> U interpolation
    aiu = dyn.to_ugrid(aice, grid, topo)
    umass = dyn.to_ugrid(tmass, grid, topo)
    strairx = dyn.to_ugrid(strairxT, grid, topo, kind=FieldType.VECTOR)
    strairy = dyn.to_ugrid(strairyT, grid, topo, kind=FieldType.VECTOR)

    # prep2
    icem_u = grid.umask & (aiu > dyn.A_MIN) & (umass > dyn.M_MIN)
    new_pts = icem_u & (iceumask < 0.5)
    uvel = torch.where(new_pts, uocn, uvel)
    vvel = torch.where(new_pts, vocn, vvel)
    uvel = torch.where(icem_u, uvel, 0.0)
    vvel = torch.where(icem_u, vvel, 0.0)

    umassdti = torch.where(icem_u, umass / dt, 0.0)
    fm = grid.fcor * umass
    sgn = torch.sign(fm)
    waterx = uocn * p.cosw - vocn * p.sinw * sgn
    watery = vocn * p.cosw + uocn * p.sinw * sgn
    if ss_tltx is None:
        strtltx = -fm * vocn          # geostrophic tilt (uncoupled default)
        strtlty = fm * uocn
    else:
        strtltx = -ct.gravit * umass * ss_tltx
        strtlty = -ct.gravit * umass * ss_tlty
    forcex = torch.where(icem_u, strairx + strtltx, 0.0)
    forcey = torch.where(icem_u, strairy + strtlty, 0.0)
    pts = dict(icetmask=icetmask, uvel=uvel, vvel=vvel, icem_u=icem_u,
               aiu=aiu, uocn=uocn, vocn=vocn, waterx=waterx, watery=watery,
               forcex=forcex, forcey=forcey, umassdti=umassdti, fm=fm)
    return pts, dict(strairx=strairx, strairy=strairy, strtltx=strtltx,
                     strtlty=strtlty)


def evp_prep(dt, p: dyn.EVPParams, grid, topo: Topology, *, aice, vice,
             vsno, strength, strairxT, strairyT, uocn, vocn, uvel, vvel,
             stressp, stressm, stress12, iceumask, ss_tltx=None,
             ss_tlty=None, Cw=ct.dragio):
    """The EVP driver's preparation (ice_dyn_evp.F90:68-330): masks, T -> U
    interpolation, forcing terms, region metrics and the stress ghost
    ring. Shared by ``evp`` and the fused driver
    (``reference.cice/ops/evp_fused.py``).

    stressp/stressm/stress12: (4, ny, nx) from State. strength: T-grid
    ice strength. uocn/vocn on the U grid. Returns (the keyword arguments
    of the subcycle sweep, {strairx, strairy, strtltx, strtlty})."""
    pts, forcing = _prep_points(
        dt, p, grid, topo, aice=aice, vice=vice, vsno=vsno,
        strairxT=strairxT, strairyT=strairyT, uocn=uocn, vocn=vocn,
        uvel=uvel, vvel=vvel, iceumask=iceumask, ss_tltx=ss_tltx,
        ss_tlty=ss_tlty)
    icetmask = pts.pop("icetmask")
    maskR = _region(icetmask.to(aice.dtype), topo) > 0.5
    gR = _region_metrics(grid, topo, GR_NAMES)
    strengthR = _region(strength, topo)

    stress0 = torch.cat([stressp, stressm, stress12], dim=0)
    stressR = _extend_stress(stress0, topo)
    stressR = torch.where(maskR[None], stressR, 0.0)
    sweep = dict(stressR=stressR, maskR=maskR, strengthR=strengthR, gR=gR,
                 uarear=grid.uarear, uvel_init=pts["uvel"],
                 vvel_init=pts["vvel"], Cw=Cw, **pts)
    return sweep, forcing


def evp_result(p: dyn.EVPParams, grid, topo: Topology, sweep: dict,
               forcing: dict, out) -> EVPResult:
    """The EVP driver's finish (ice_dyn_evp.F90:411-517): ocean stress on
    the U and T grids and the crop of the region fields. ``sweep`` and
    ``forcing`` are what ``evp_prep`` returned, ``out`` the sweep's
    (u, v, stressR, diags)."""
    u, v, stressR, diags = out
    divuR, shearR, rconvR, rshearR, prsR, strintx, strinty = diags
    icem_u, aiu, fm = sweep["icem_u"], sweep["aiu"], sweep["fm"]
    ny, nx = u.shape

    strocnx, strocny, sTx_u, sTy_u = dyn.evp_finish(
        p, icemask=icem_u, uvel=u, vvel=v, uocn=sweep["uocn"],
        vocn=sweep["vocn"], aiu=aiu, fm=fm, Cw=sweep["Cw"])
    strocnxT = dyn.to_tgrid(sTx_u, grid, topo)
    strocnyT = dyn.to_tgrid(sTy_u, grid, topo)

    crop = lambda a: a[..., :ny, :nx]
    return EVPResult(
        uvel=u, vvel=v,
        stressp=crop(stressR[0:4]), stressm=crop(stressR[4:8]),
        stress12=crop(stressR[8:12]),
        iceumask=icem_u.to(aiu.dtype),
        strocnx=strocnx, strocny=strocny,
        strocnxT=strocnxT, strocnyT=strocnyT,
        strintx=strintx, strinty=strinty,
        divu=crop(divuR), shear=crop(shearR), rdg_conv=crop(rconvR),
        rdg_shear=crop(rshearR), prs_sig=crop(prsR), fm=fm, **forcing)


def evp(dt, p: dyn.EVPParams, grid, topo: Topology, **fields) -> EVPResult:
    """EVP dynamics driver (ice_dyn_evp.F90:68-517 evp). ``fields``: the
    keyword arguments of ``evp_prep`` (aice, vice, vsno, strength,
    strairxT/strairyT, uocn/vocn, uvel/vvel, stressp/stressm/stress12,
    iceumask; optional ss_tltx/ss_tlty and Cw)."""
    sweep, forcing = evp_prep(dt, p, grid, topo, **fields)
    # subcycling loop (ice_dyn_evp.F90:336-410): on a mesh of ranks the
    # loop with one halo exchange per subcycle, as the JAX step runs it
    # there (cice5_tpu/driver/step.py:1010-1027); on one device kernel A
    sweep_fn = subcycle_sweep if topo.sharded else evp_sweep
    out = sweep_fn(p, p.ndte, topo, **sweep)
    return evp_result(p, grid, topo, sweep, forcing, out)


def evp_chunked(dt, p: dyn.EVPParams, grid, topo: Topology, *, K: int = 10,
                strength, stressp, stressm, stress12, Cw=ct.dragio,
                **fields) -> EVPResult:
    """EVP with K subcycles per halo exchange (PyTorch port of
    ``cice5_tpu/models/dynamics/evp.py:445`` evp_chunked).

    A K-wide margin of (u, v, 12 stress components) is exchanged once per
    K subcycles (``extend_wide`` / ``extend_wide_groups``, one exchange
    per mesh axis), the margin is recomputed redundantly and its validity
    decays one ring per subcycle, so the interior equals the loop with one
    exchange per subcycle (ice_dyn_evp.F90:336-410) in ndte/K exchanges.
    On a U-fold seam the K ghost rows above the fold hold the fold image:
    velocities as NECORNER vectors, stress through the corner-partner
    permutation, one-sided metric coefficients through their partners.
    Plain PyTorch on every device (kernel A runs all ndte subcycles of one
    device in one launch). ``fields``: the keyword arguments of
    ``evp_prep`` but the stress and Cw. A Cw plane (form drag) is carried
    in the margin as a U-point field; the JAX function takes a scalar.
    Refuses a T-fold seam, ndte not a multiple of K, and tiles narrower
    than K."""
    if topo.ns == "tripoleT":
        raise NotImplementedError("evp_chunked: T-fold grids; use evp()")
    if p.ndte % K != 0:
        raise ValueError(f"ndte={p.ndte} not divisible by K={K}")
    ny, nx = fields["aice"].shape
    if topo.sharded and (K > ny or K > nx):
        raise ValueError(f"evp_chunked: K={K} exceeds the ({ny}, {nx}) "
                         "tile (one hop per exchange)")
    W, nchunks, dtype = K, p.ndte // K, strength.dtype
    pts, forcing = _prep_points(dt, p, grid, topo, **fields)
    icem_u = pts["icem_u"]

    # static fields extended once per call (one wide exchange), grouped by
    # tripole fold treatment: T-centred scalars + partner metrics /
    # U-point scalars / U-point vectors
    g = grid
    centerA = [g.dxt, g.dyt, g.tarear, g.tinyarea, strength,
               pts["icetmask"].to(dtype)]
    centerM = [g.dxhy, g.dyhx, g.cxp, g.cyp, g.cxm, g.cym]
    centerM_partner = [-g.dxhy, -g.dyhx, -g.cxm, -g.cym, -g.cxp, -g.cyp]
    cw_plane = torch.is_tensor(Cw) and Cw.dim() > 0
    uscal = [pts["umassdti"], pts["fm"], g.uarear, icem_u.to(dtype),
             pts["aiu"]] + ([Cw.to(dtype)] if cw_plane else [])
    uvec = [pts[k] for k in ("uocn", "vocn", "waterx", "watery", "forcex",
                             "forcey", "uvel", "vvel")]
    nC, nM, nS = len(centerA), len(centerM), len(uscal)
    groups = [
        (slice(0, nC + nM), FieldLoc.CENTER, FieldType.SCALAR,
         torch.stack(centerA + centerM_partner), 1.0),
        (slice(nC + nM, nC + nM + nS), FieldLoc.NECORNER,
         FieldType.SCALAR, None, 1.0),
        (slice(nC + nM + nS, nC + nM + nS + len(uvec)),
         FieldLoc.NECORNER, FieldType.VECTOR, None, 1.0),
    ]
    SW = extend_wide_groups(torch.stack(centerA + centerM + uscal + uvec),
                            topo, W, groups)
    topoI = Topology(ew="open", ns="open")   # inner: no exchange, zero rims
    met_names = ("dxt", "dyt", "tarear", "tinyarea", None, None,
                 "dxhy", "dyhx", "cxp", "cyp", "cxm", "cym")
    gRw = {k: extend(SW[i], topoI)[1:, 1:]
           for i, k in enumerate(met_names) if k is not None}
    strengthRw = extend(SW[4], topoI)[1:, 1:]
    maskRw = extend(SW[5], topoI)[1:, 1:] > 0.5
    o = nC + nM
    umassdtiW, fmW, uarearW = SW[o], SW[o + 1], SW[o + 2]
    icem_uW = SW[o + 3] > 0.5
    aiuW = SW[o + 4]
    CwW = SW[o + 5] if cw_plane else Cw
    o += nS
    uocnW, vocnW = SW[o], SW[o + 1]
    waterxW, wateryW = SW[o + 2], SW[o + 3]
    forcexW, forceyW = SW[o + 4], SW[o + 5]
    uvel_initW, vvel_initW = SW[o + 6], SW[o + 7]

    def crop(a):
        return a[..., W:W + ny, W:W + nx]

    tri = topo.ns == "tripole"
    u, v = pts["uvel"], pts["vvel"]
    stress = torch.cat([stressp, stressm, stress12], dim=0)
    for _ in range(nchunks):
        S = torch.cat([u[None], v[None], stress])
        if tri:
            SE = extend_wide_groups(S, topo, W, [
                (slice(0, 2), FieldLoc.NECORNER, FieldType.VECTOR, None,
                 1.0),
                (slice(2, 14), FieldLoc.CENTER, FieldType.SCALAR,
                 _fold_partner_stress(stress), 1.0)])
        else:
            SE = extend_wide(S, topo, W)     # one exchange per chunk
        uW, vW = SE[0], SE[1]
        stressRW = torch.where(maskRw[None],
                               extend(SE[2:], topoI)[:, 1:, 1:], 0.0)
        for _ in range(K):
            uvE = extend(torch.stack([uW, vW]), topoI)
            r = stress_kernel(p, uvE[0], uvE[1], stressRW, maskR=maskRw,
                              strengthR=strengthRw, gR=gRw)
            st = dyn.stepu(p, icemask=icem_uW, aiu=aiuW, strE=r.str8,
                           uocn=uocnW, vocn=vocnW, waterx=waterxW,
                           watery=wateryW, forcex=forcexW, forcey=forceyW,
                           umassdti=umassdtiW, fm=fmW, uarear=uarearW,
                           uvel_init=uvel_initW, vvel_init=vvel_initW,
                           uvel=uW, vvel=vW, Cw=CwW)
            uW, vW, stressRW = st.uvel, st.vvel, r.stress
        u, v, stress = crop(uW), crop(vW), crop(stressRW)
        diags = [crop(d) for d in (r.divu, r.shear, r.rdg_conv,
                                   r.rdg_shear, r.prs_sig, st.strintx,
                                   st.strinty)]
    divu, shear, rconv, rshear, prs, strintx, strinty = diags

    strocnx, strocny, sTx_u, sTy_u = dyn.evp_finish(
        p, icemask=icem_u, uvel=u, vvel=v, uocn=pts["uocn"],
        vocn=pts["vocn"], aiu=pts["aiu"], fm=pts["fm"], Cw=Cw)
    return EVPResult(
        uvel=u, vvel=v, stressp=stress[0:4], stressm=stress[4:8],
        stress12=stress[8:12], iceumask=icem_u.to(dtype),
        strocnx=strocnx, strocny=strocny,
        strocnxT=dyn.to_tgrid(sTx_u, grid, topo),
        strocnyT=dyn.to_tgrid(sTy_u, grid, topo),
        strintx=strintx, strinty=strinty, divu=divu, shear=shear,
        rdg_conv=rconv, rdg_shear=rshear, prs_sig=prs, fm=pts["fm"],
        **forcing)
