"""Incremental remapping transport (Dukowicz-Baumgardner / Lipscomb-Hunke),
PyTorch port of ``cice5_tpu/models/transport/remap.py``.

ice_transport_remap.F90: construct_fields :1024, limited_gradient :1344,
departure_points :1493, locate_triangles :1680, triangle_coordinates
:3078, transport_integrals :3199, update_fields :3517; the tracer packing
of ice_transport_driver.F90 (state_to_tracers :789, tracers_to_state
:908). Every branch of the reference's triangle cases is a dense mask,
all triangle groups are computed for all edges at once, and the donor
cell of a triangle is a 6-way select over shifted views.

The reconstruction + transport integrals of all categories and both edge
sets are one function with two implementations of one signature:
``remap_flux_plain`` (plain PyTorch: the CPU path and the reference for
the kernel) and ``remap_flux_both``, which launches the hand-written CUDA
kernel ``csrc/remap_tiles.cu`` for tensors on the GPU. Categories
are an explicit leading batch axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.constants import FieldLoc, FieldType
from reference.cice.parallel import (Topology, extend, extend_wide,
                                      global_sum, shifted)
from reference.cice.state import (DEP_AICE, DEP_TRCR, DEP_VICE,
                                   TracerRegistry)

NGROUPS = 6
XXAV = 1.0 / 12.0   # mean value of x^2 over a unit cell
YYAV = 1.0 / 12.0

# donor-cell codes
TL, BL, TR, BR, TC, BC = range(6)


def limited_gradient(phi, phimask, cnx, cny, topo: Topology):
    """Van Leer-limited gradient in scaled coordinates
    (ice_transport_remap.F90:1344-1490). Returns (gx, gy)."""
    return _limited_gradient_core(phi, extend(phi, topo),
                                  extend(phimask, topo), phimask, cnx, cny)


def _limited_gradient_core(phi, pE, mE, phimask, cnx, cny):
    """limited_gradient on inputs extended by one ring (3-point stencil).
    phi/phimask: centre field and mask; pE/mE: the same with the ring."""

    def nbr(di, dj):
        j0, j1 = 1 + dj, pE.shape[-2] - 1 + dj
        i0, i1 = 1 + di, pE.shape[-1] - 1 + di
        p = pE[..., j0:j1, i0:i1]
        m = mE[..., j0:j1, i0:i1]
        return m * p + (1.0 - m) * phi

    phi_nw, phi_n, phi_ne = nbr(-1, 1), nbr(0, 1), nbr(1, 1)
    phi_w, phi_e = nbr(-1, 0), nbr(1, 0)
    phi_sw, phi_s, phi_se = nbr(-1, -1), nbr(0, -1), nbr(1, -1)

    gx = (phi_e - phi_w) * 0.5
    gy = (phi_n - phi_s) * 0.5

    phi_b = torch.broadcast_to(phi, phi_n.shape)
    allp = torch.stack([phi_nw, phi_n, phi_ne, phi_w, phi_b, phi_e,
                        phi_sw, phi_s, phi_se])
    pmn = allp.amin(0) - phi
    pmx = allp.amax(0) - phi

    w1 = (0.5 - cnx) * gx + (0.5 - cny) * gy
    w2 = (0.5 - cnx) * gx - (0.5 + cny) * gy
    w3 = -(0.5 + cnx) * gx - (0.5 + cny) * gy
    w4 = (0.5 - cny) * gy - (0.5 + cnx) * gx
    qmn = torch.minimum(torch.minimum(w1, w2), torch.minimum(w3, w4))
    qmx = torch.maximum(torch.maximum(w1, w2), torch.maximum(w3, w4))

    lim1 = torch.where(torch.abs(qmn) > torch.abs(pmn),
                       torch.clamp(pmn / torch.where(qmn != 0.0, qmn, 1.0),
                                   min=0.0), 1.0)
    lim2 = torch.where(torch.abs(qmx) > torch.abs(pmx),
                       torch.clamp(pmx / torch.where(qmx != 0.0, qmx, 1.0),
                                   min=0.0), 1.0)
    lim = torch.minimum(lim1, lim2)
    keep = phimask > ct.puny
    return torch.where(keep, lim * gx, 0.0), torch.where(keep, lim * gy, 0.0)


class Geometry(NamedTuple):
    """Triangle decomposition for one edge direction.
    xp/yp: (NGROUPS, 3, nyr, nxr); donor: (NGROUPS, nyr, nxr) int32 codes
    TL..BC; triarea: signed scaled area * areafac."""
    xp: torch.Tensor
    yp: torch.Tensor
    donor: torch.Tensor
    triarea: torch.Tensor


def _edge_geometry(edge: str, dx, dy, afl, afr):
    """Locate departure triangles for all edges at once
    (ice_transport_remap.F90:1680-3050 locate_triangles), free
    (geometric) departure areas.

    dx, dy: scaled departure displacements at the (left, right) corners
    of each edge: tuples (dxl, dxr), (dyl, dyr) of (nyr, nxr) tensors.
    afl/afr: left/right corner area factors."""
    (dxl, dxr), (dyl, dyr) = dx, dy
    afc = 0.5 * (afl + afr)
    shp = dxl.shape
    kw = dict(dtype=dxl.dtype, device=dxl.device)

    xcl, ycl = -0.5, 0.0
    xcr, ycr = 0.5, 0.0
    if edge == "north":
        xdl = xcl + dxl
        ydl = ycl + dyl
        xdr = xcr + dxr
        ydr = ycr + dyr
    else:   # east: rotate trajectory by pi/2
        xdl = xcl - dyl
        ydl = ycl + dxl
        xdr = xcr - dyr
        ydr = ycr + dxr

    xdm = 0.5 * (xdr + xdl)
    ydm = 0.5 * (ydr + ydl)

    def safe(num, den):
        tiny = torch.where(den >= 0, 1.0, -1.0).to(den.dtype) * 1e-30
        return num / torch.where(torch.abs(den) > 1e-30, den, tiny)

    xil = torch.full(shp, xcl, **kw)
    yil = safe(xcl * (ydm - ydl) + xdm * ydl - xdl * ydm, xdm - xdl)
    xir = torch.full(shp, xcr, **kw)
    yir = safe(xcr * (ydr - ydm) - xdm * ydr + xdr * ydm, xdr - xdm)

    md = safe(ydr - ydl, xdr - xdl)
    xic = torch.where(torch.abs(md) > ct.puny, xdl - safe(ydl, md), 0.0)

    zero3 = torch.zeros((3,) + tuple(shp), **kw)
    xp = [zero3] * NGROUPS
    yp = [zero3] * NGROUPS
    donor = [torch.zeros(shp, dtype=torch.int32, device=dxl.device)] \
        * NGROUPS
    afact = [torch.zeros(shp, **kw)] * NGROUPS

    def full(v):
        return v if torch.is_tensor(v) else torch.full(shp, v, **kw)

    def put(ng, mask, verts, dn, af):
        """Set the triangle of group ng where mask."""
        vx = torch.stack([full(v[0]) for v in verts])
        vy = torch.stack([full(v[1]) for v in verts])
        xp[ng] = torch.where(mask[None], vx, xp[ng])
        yp[ng] = torch.where(mask[None], vy, yp[ng])
        donor[ng] = torch.where(mask, dn, donor[ng])
        afact[ng] = torch.where(mask, af, afact[ng])

    CL = (xcl, ycl)
    CR = (xcr, ycr)
    DL = (xdl, ydl)
    DR = (xdr, ydr)
    IL = (xil, yil)
    IR = (xir, yir)
    IC = (xic, torch.zeros(shp, **kw))

    # TL/BL cells (left corner) (:2060-2165)
    left_out = xdl < xcl
    m_TL = (yil > 0) & left_out & (ydl >= 0)
    put(0, m_TL, [CL, IL, DL], TL, -afl)
    m_BL = (yil < 0) & left_out & (ydl < 0)
    put(0, m_BL, [CL, DL, IL], BL, afl)
    m_TL1 = (yil < 0) & left_out & (ydl >= 0)
    put(0, m_TL1, [CL, DL, IC], TL, afl)
    put(2, m_TL1, [CL, IC, IL], BL, afl)
    m_TL2 = (yil > 0) & left_out & (ydl < 0)
    put(2, m_TL2, [CL, IL, IC], TL, -afl)
    put(0, m_TL2, [CL, IC, DL], BL, -afl)

    # TR/BR cells (right corner) (:2168-2270)
    right_out = xdr >= xcr
    m_TR = (yir > 0) & right_out & (ydr >= 0)
    put(1, m_TR, [CR, DR, IR], TR, -afr)
    m_BR = (yir < 0) & right_out & (ydr < 0)
    put(1, m_BR, [CR, IR, DR], BR, afr)
    m_TR1 = (yir < 0) & right_out & (ydr >= 0)
    put(1, m_TR1, [CR, IC, DR], TR, afr)
    put(2, m_TR1, [CR, IR, IC], BR, afr)
    m_TR2 = (yir > 0) & right_out & (ydr < 0)
    put(2, m_TR2, [CR, IC, IR], TR, -afr)
    put(1, m_TR2, [CR, DR, IC], BR, -afr)

    # departure points clipped to the central cells (:2276-2285)
    xdl2 = torch.where(left_out, xil, xdl)
    ydl2 = torch.where(left_out, yil, ydl)
    xdr2 = torch.where(right_out, xir, xdr)
    ydr2 = torch.where(right_out, yir, ydr)
    xdm = 0.5 * (xdr2 + xdl2)
    ydm = 0.5 * (ydr2 + ydl2)
    DL2 = (xdl2, ydl2)
    DR2 = (xdr2, ydr2)
    DM = (xdm, ydm)
    ICL = IC
    ICR = IC

    # central TC/BC cells (:2395-3048)
    both_up = (ydl2 >= 0) & (ydr2 >= 0)
    both_dn = (ydl2 < 0) & (ydr2 < 0)
    mix_lr = (ydl2 >= 0) & (ydr2 < 0)     # left up, right down
    mix_rl = (ydl2 < 0) & (ydr2 >= 0)
    up_m = ydm >= 0
    xic_r = xic >= 0

    m = both_up & up_m
    put(3, m, [CL, CR, DL2], TC, -afc)
    put(4, m, [CR, DR2, DL2], TC, -afc)
    put(5, m, [DL2, DR2, DM], TC, -afc)
    m = both_up & ~up_m
    put(3, m, [CL, ICL, DL2], TC, -afc)
    put(4, m, [CR, DR2, ICR], TC, -afc)
    put(5, m, [ICR, ICL, DM], BC, afc)
    m = both_dn & ~up_m
    put(3, m, [CL, DL2, CR], BC, afc)
    put(4, m, [CR, DL2, DR2], BC, afc)
    put(5, m, [DL2, DM, DR2], BC, afc)
    m = both_dn & up_m
    put(3, m, [CL, DL2, ICL], BC, afc)
    put(4, m, [CR, ICR, DR2], BC, afc)
    put(5, m, [ICL, ICR, DM], TC, -afc)
    m = mix_lr & xic_r & up_m
    put(3, m, [CL, ICR, DL2], TC, -afc)
    put(4, m, [CR, ICR, DR2], BC, afr)
    put(5, m, [DL2, ICR, DM], TC, -afc)
    m = mix_lr & xic_r & ~up_m
    put(3, m, [CL, ICL, DL2], TC, -afc)
    put(4, m, [CR, ICR, DR2], BC, afr)
    put(5, m, [ICR, ICL, DM], BC, afc)
    m = mix_lr & ~xic_r & ~up_m
    put(3, m, [CL, ICL, DL2], TC, -afl)
    put(4, m, [CR, ICL, DR2], BC, afc)
    put(5, m, [DR2, ICL, DM], BC, afc)
    m = mix_lr & ~xic_r & up_m
    put(3, m, [CL, ICL, DL2], TC, -afl)
    put(4, m, [CR, ICR, DR2], BC, afc)
    put(5, m, [ICL, ICR, DM], TC, -afc)
    m = mix_rl & ~xic_r & up_m
    put(3, m, [CL, DL2, ICL], BC, afl)
    put(4, m, [CR, DR2, ICL], TC, -afc)
    put(5, m, [ICL, DR2, DM], TC, -afc)
    m = mix_rl & ~xic_r & ~up_m
    put(3, m, [CL, DL2, ICL], BC, afl)
    put(4, m, [CR, DR2, ICR], TC, -afc)
    put(5, m, [ICR, ICL, DM], BC, afc)
    m = mix_rl & xic_r & ~up_m
    put(3, m, [CL, DL2, ICR], BC, afc)
    put(4, m, [CR, DR2, ICR], TC, -afr)
    put(5, m, [ICR, DL2, DM], BC, afc)
    m = mix_rl & xic_r & up_m
    put(3, m, [CL, DL2, ICL], BC, afc)
    put(4, m, [CR, DR2, ICR], TC, -afr)
    put(5, m, [ICL, ICR, DM], TC, -afc)

    xp = torch.stack(xp)
    yp = torch.stack(yp)
    donor = torch.stack(donor)
    afact = torch.stack(afact)

    # triangle areas (:3052-3075): A = 1/2 cross * areafact
    x1, x2, x3 = xp[:, 0], xp[:, 1], xp[:, 2]
    y1, y2, y3 = yp[:, 0], yp[:, 1], yp[:, 2]
    tri = 0.5 * ((x2 - x1) * (y3 - y1) - (y2 - y1) * (x3 - x1)) * afact
    cutoff = 1.0e-16 * torch.clamp(afc, min=1e-30)
    tri = torch.where(torch.abs(tri) > cutoff[None], tri, 0.0)

    # vertices into the DONOR cell's centred frame (:2985-3018)
    if edge == "north":
        offs = {TL: (-1, 1), BL: (-1, 0), TR: (1, 1), BR: (1, 0),
                TC: (0, 1), BC: (0, 0)}
    else:
        offs = {TL: (1, 1), BL: (0, 1), TR: (1, -1), BR: (0, -1),
                TC: (1, 0), BC: (0, 0)}
    ish = torch.zeros(donor.shape, **kw)
    jsh = torch.zeros(donor.shape, **kw)
    for code, (di, dj) in offs.items():
        ish = torch.where(donor == code, float(di), ish)
        jsh = torch.where(donor == code, float(dj), jsh)
    if edge == "north":
        xp = xp - ish[:, None]
        yp = yp + 0.5 - jsh[:, None]
    else:
        xp_new = yp + (0.5 - ish)[:, None]
        yp_new = -xp - jsh[:, None]
        xp, yp = xp_new, yp_new
    return Geometry(xp=xp, yp=yp, donor=donor, triarea=tri)


def _triangle_midpoints(g: Geometry):
    """3-point degree-2 quadrature points: midpoints between each vertex
    and the centroid (triangle_coordinates :3078-3150)."""
    x0 = g.xp.mean(dim=1, keepdim=True)
    y0 = g.yp.mean(dim=1, keepdim=True)
    return 0.5 * g.xp + 0.5 * x0, 0.5 * g.yp + 0.5 * y0


def _nbr_views_north(fE, ny, nx):
    """Six donor-cell views for north edges, region (ny+1, nx)."""
    return {
        BC: fE[..., 0:ny + 1, 1:nx + 1],
        TC: fE[..., 1:ny + 2, 1:nx + 1],
        BL: fE[..., 0:ny + 1, 0:nx],
        TL: fE[..., 1:ny + 2, 0:nx],
        BR: fE[..., 0:ny + 1, 2:nx + 2],
        TR: fE[..., 1:ny + 2, 2:nx + 2],
    }


def _nbr_views_east(fE, ny, nx):
    """Six donor-cell views for east edges, region (ny, nx+1)."""
    return {
        BC: fE[..., 1:ny + 1, 0:nx + 1],
        TC: fE[..., 1:ny + 1, 1:nx + 2],
        BL: fE[..., 2:ny + 2, 0:nx + 1],
        TL: fE[..., 2:ny + 2, 1:nx + 2],
        BR: fE[..., 0:ny, 0:nx + 1],
        TR: fE[..., 0:ny, 1:nx + 2],
    }


def _donor_select(donor, views):
    """One-hot select of donor-cell values per group. donor:
    (NGROUPS, nyr, nxr); views: code -> (..., nyr, nxr). Returns
    (NGROUPS, ..., nyr, nxr)."""
    out = None
    for code, v in views.items():
        sel = donor == code
        m = sel.reshape(sel.shape[:1] + (1,) * (v.dim() - 2)
                        + sel.shape[1:])
        term = torch.where(m, v[None], 0.0)
        out = term if out is None else out + term
    return out


class RemapFluxes(NamedTuple):
    mflx: torch.Tensor      # (ncat, nyr, nxr) mass flux across each edge
    mtflx: torch.Tensor     # (ncat, ntrace, nyr, nxr)


def _integrals(donor, triarea, qx, qy, views_mc, views_mx, views_my,
               views_tc, views_tx, views_ty, tracer_type, parent):
    """Quadratic transport integrals over all triangles
    (transport_integrals :3199-3512, integral_order=2), factored into six
    per-view weight maps W_v = sum_g triarea_g * coeff_g * [donor_g=v]:
    each tracer flux is a 6-view weighted read of its reconstruction.

    Geometry (NGROUPS, ...) with qx/qy (NGROUPS, 3, nyr, nxr); mass views
    (ncat, nyr, nxr), tracer views (ncat, ntrace, nyr, nxr)."""
    ta = triarea[:, None]                              # (G, 1, nyr, nxr)
    mc_d = _donor_select(donor, views_mc)              # (G, C, nyr, nxr)
    mx_d = _donor_select(donor, views_mx)
    my_d = _donor_select(donor, views_my)

    P333 = 1.0 / 3.0
    qxb, qyb = qx[:, :, None], qy[:, :, None]          # (G, 3, 1, ...)
    mq = P333 * (mc_d[:, None] + qxb * mx_d[:, None] + qyb * my_d[:, None])
    msum = mq.sum(1)                                   # (G, C, nyr, nxr)
    mflx = (ta * msum).sum(0)

    mxsum = (mq * qxb).sum(1)
    mysum = (mq * qyb).sum(1)
    mxxsum = (mq * qxb * qxb).sum(1)
    mxysum = (mq * qxb * qyb).sum(1)
    myysum = (mq * qyb * qyb).sum(1)

    codes = list(views_tc.keys())
    onehot = {v: (donor == v)[:, None] for v in codes}

    def wmaps(cg, xg=None, yg=None):
        Wc = {v: (ta * cg * onehot[v]).sum(0) for v in codes}
        Wx = ({v: (ta * xg * onehot[v]).sum(0) for v in codes}
              if xg is not None else None)
        Wy = ({v: (ta * yg * onehot[v]).sum(0) for v in codes}
              if yg is not None else None)
        return Wc, Wx, Wy

    W1 = wmaps(msum, mxsum, mysum)                     # type-1 tracers

    def donor_one(views, nt):
        return _donor_select(donor, {v: a[:, nt] for v, a in views.items()})

    ntrace = next(iter(views_tc.values())).shape[1]
    needed = sorted({parent[nt] for nt in range(ntrace)
                     if tracer_type[nt] >= 2})
    gsum: dict = {}
    Wp: dict = {}
    for p in needed:                     # type-1 parents come first
        tc_p = donor_one(views_tc, p)
        if tracer_type[p] == 1:
            tx_p = donor_one(views_tx, p)
            ty_p = donor_one(views_ty, p)
            mts_g = msum * tc_p + mxsum * tx_p + mysum * ty_p
            mtx_g = mxsum * tc_p + mxxsum * tx_p + mxysum * ty_p
            mty_g = mysum * tc_p + mxysum * tx_p + myysum * ty_p
        else:                            # type-2 parent (pond chain)
            pts, ptx, pty = gsum[parent[p]]
            tx_p = donor_one(views_tx, p)
            ty_p = donor_one(views_ty, p)
            mts_g = pts * tc_p + ptx * tx_p + pty * ty_p
            mtx_g = mty_g = None
        gsum[p] = (mts_g, mtx_g, mty_g)
        Wp[p] = wmaps(mts_g, mtx_g, mty_g)

    flux = [None] * ntrace
    classes: dict = {}
    for nt in range(ntrace):
        key = ("1",) if tracer_type[nt] == 1 else (tracer_type[nt],
                                                   parent[nt])
        classes.setdefault(key, []).append(nt)
    for key, idxs in classes.items():
        Wc, Wx, Wy = W1 if key[0] == "1" else Wp[key[1]]
        use_grad = key[0] == "1" or key[0] == 2
        sel = _sel(idxs)
        acc = None
        for v in codes:
            term = Wc[v][:, None] * views_tc[v][:, sel]
            if use_grad and Wx is not None:
                term = term + Wx[v][:, None] * views_tx[v][:, sel]
                term = term + Wy[v][:, None] * views_ty[v][:, sel]
            acc = term if acc is None else acc + term
        for k, nt in enumerate(idxs):
            flux[nt] = acc[:, k]
    return RemapFluxes(mflx=mflx, mtflx=torch.stack(flux, dim=1))


def _sel(idxs):
    """Basic slice when contiguous, else an index list."""
    if idxs == list(range(idxs[0], idxs[-1] + 1)):
        return slice(idxs[0], idxs[-1] + 1)
    return list(idxs)


class RemapGeometry(NamedTuple):
    north: Geometry
    east: Geometry


def remap_geometry(dt, grid, topo: Topology, *, uvel,
                   vvel) -> RemapGeometry:
    """Departure points (departure_points :1493-1541) + triangle
    decomposition for both edge sets."""
    ny, nx = uvel.shape
    dpx = -dt * uvel
    dpy = -dt * vvel
    dxuE = extend(grid.dxu, topo, loc=FieldLoc.NECORNER)
    dyuE = extend(grid.dyu, topo, loc=FieldLoc.NECORNER)
    dpxE = extend(dpx, topo, loc=FieldLoc.NECORNER, kind=FieldType.VECTOR)
    dpyE = extend(dpy, topo, loc=FieldLoc.NECORNER, kind=FieldType.VECTOR)
    dxs = dpxE / torch.where(dxuE > 0, dxuE, 1.0)
    dys = dpyE / torch.where(dyuE > 0, dyuE, 1.0)
    A = dxuE * dyuE

    # north edges: region (ny+1, nx), edge (i,j) j=-1..ny-1 (jj=j+1)
    gn = _edge_geometry("north",
                        (dxs[0:ny + 1, 0:nx], dxs[0:ny + 1, 1:nx + 1]),
                        (dys[0:ny + 1, 0:nx], dys[0:ny + 1, 1:nx + 1]),
                        A[0:ny + 1, 0:nx], A[0:ny + 1, 1:nx + 1])
    # east edges: region (ny, nx+1), edge (i,j) i=-1..nx-1 (ii=i+1)
    ge = _edge_geometry("east",
                        (dxs[1:ny + 1, 0:nx + 1], dxs[0:ny, 0:nx + 1]),
                        (dys[1:ny + 1, 0:nx + 1], dys[0:ny, 0:nx + 1]),
                        A[1:ny + 1, 0:nx + 1], A[0:ny, 0:nx + 1])
    return RemapGeometry(north=gn, east=ge)


def _reconstruct_ext(mmE, tmE, hmE, tracer_type, parent):
    """Limited linear reconstructions (construct_fields :1024-1316) from
    RAW fields extended by one ring more than the result: mmE
    (ncat, nyE, nxE), tmE (ncat, ntrace, nyE, nxE), hmE (nyE, nxE).
    Returns (mc, mx, my, tc, tx, ty) on (nyE-2, nxE-2)."""
    inner = lambda F: F[..., 1:-1, 1:-1]
    dtype = mmE.dtype
    mm = inner(mmE)
    mE = (mmE > 0.0).to(dtype)
    mmask = inner(mE)
    mx, my = _limited_gradient_core(mm, mmE, hmE, inner(hmE), 0.0, 0.0)
    mc = mm
    denom = torch.where(mm > 0.0, mm, 1.0)
    mxav = torch.where(mm > 0.0, mx * XXAV / denom, 0.0)
    myav = torch.where(mm > 0.0, my * YYAV / denom, 0.0)

    ntrace = tmE.shape[1]
    tm = inner(tmE)
    tcs = [None] * ntrace
    txs = [None] * ntrace
    tys = [None] * ntrace
    mtx = [None] * ntrace
    mty = [None] * ntrace
    c_ = lambda a: a[:, None]

    idx1 = [nt for nt in range(ntrace) if tracer_type[nt] == 1]
    if idx1:
        sel = _sel(idx1)
        tx_b, ty_b = _limited_gradient_core(tm[:, sel], tmE[:, sel],
                                            c_(mE), c_(mmask), c_(mxav),
                                            c_(myav))
        tc_b = tm[:, sel] - tx_b * c_(mxav) - ty_b * c_(myav)
        w2 = c_(mc) * tx_b + c_(mx) * tc_b
        w3 = c_(mc) * ty_b + c_(my) * tc_b
        mt = c_(mm) * tm[:, sel]
        d2 = torch.where(torch.abs(mt) > 0.0, mt, 1.0)
        ok = torch.abs(mt) > ct.puny
        mtx_b = torch.where(ok, (w2 * XXAV) / d2, 0.0)
        mty_b = torch.where(ok, (w3 * YYAV) / d2, 0.0)
        for k, nt in enumerate(idx1):
            tcs[nt], txs[nt], tys[nt] = tc_b[:, k], tx_b[:, k], ty_b[:, k]
            mtx[nt], mty[nt] = mtx_b[:, k], mty_b[:, k]

    by_parent: dict = {}
    for nt in range(ntrace):
        if tracer_type[nt] == 2:
            by_parent.setdefault(parent[nt], []).append(nt)
    for p, idxs in by_parent.items():
        sel = _sel(idxs)
        tmask_pE = (torch.abs(tmE[:, p]) > 0.0).to(dtype) * mE
        tx_b, ty_b = _limited_gradient_core(
            tm[:, sel], tmE[:, sel], c_(tmask_pE), c_(inner(tmask_pE)),
            c_(mtx[p]), c_(mty[p]))
        tc_b = tm[:, sel] - tx_b * c_(mtx[p]) - ty_b * c_(mty[p])
        for k, nt in enumerate(idxs):
            tcs[nt], txs[nt], tys[nt] = tc_b[:, k], tx_b[:, k], ty_b[:, k]

    for nt in range(ntrace):
        if tracer_type[nt] == 3:
            tcs[nt] = tm[:, nt]
            txs[nt] = torch.zeros_like(mm)
            tys[nt] = torch.zeros_like(mm)
    return (mc, mx, my, torch.stack(tcs, 1), torch.stack(txs, 1),
            torch.stack(tys, 1))


def remap_flux_plain(geomN, geomE, mmE2, tmE2, hmE2, tracer_type, parent,
                     ny: int, nx: int):
    """Reconstruction + transport integrals of both edge sets for all
    categories in plain PyTorch (the function the Pallas kernel
    integrals_tiled_both computes, cice5_tpu/ops/pallas/remap_flux.py:163).

    geomN/geomE: (donor, triarea, qx, qy) of the north (ny+1, nx) and east
    (ny, nx+1) edges; mmE2/tmE2/hmE2: raw fields with a W=2 ring. Returns
    (fn_mflx (ncat, ny+1, nx), fn_mtflx (ncat, ntrace, ny+1, nx),
    fe_mflx (ncat, ny, nx+1), fe_mtflx (ncat, ntrace, ny, nx+1))."""
    mc, mx, my, tc, tx, ty = _reconstruct_ext(mmE2, tmE2, hmE2,
                                              tracer_type, parent)
    fn = _integrals(*geomN, *(_nbr_views_north(f, ny, nx)
                              for f in (mc, mx, my, tc, tx, ty)),
                    tracer_type, parent)
    fe = _integrals(*geomE, *(_nbr_views_east(f, ny, nx)
                              for f in (mc, mx, my, tc, tx, ty)),
                    tracer_type, parent)
    return fn.mflx, fn.mtflx, fe.mflx, fe.mtflx


def remap_flux_both(geomN, geomE, mmE2, tmE2, hmE2, tracer_type, parent,
                    ny: int, nx: int):
    """The reference's remap fluxes: ``remap_flux_plain`` on whatever
    device the tensors are on."""
    return remap_flux_plain(geomN, geomE, mmE2, tmE2, hmE2,
                            tracer_type, parent, ny, nx)


def remap_flux_edge_plain(edge: str, geom, mmE2, tmE2, hmE2, tracer_type,
                          parent, ny: int, nx: int):
    """Reconstruction + transport integrals of ONE edge set for all
    categories in plain PyTorch (the function the Pallas kernel
    integrals_tiled computes, cice5_tpu/ops/pallas/remap_flux.py:75): one
    half of ``remap_flux_plain``.

    edge: "north" (ny+1, nx edges) or "east" (ny, nx+1); geom: (donor,
    triarea, qx, qy) of that edge set. Returns (mflx (ncat, nyr, nxr),
    mtflx (ncat, ntrace, nyr, nxr))."""
    views = {"north": _nbr_views_north, "east": _nbr_views_east}[edge]
    recon = _reconstruct_ext(mmE2, tmE2, hmE2, tracer_type, parent)
    fl = _integrals(*geom, *(views(f, ny, nx) for f in recon), tracer_type,
                    parent)
    return fl.mflx, fl.mtflx


def remap_flux_edge(edge: str, geom, mmE2, tmE2, hmE2, tracer_type, parent,
                    ny: int, nx: int):
    """``remap_flux_edge_plain`` on whatever device the tensors are on."""
    return remap_flux_edge_plain(edge, geom, mmE2, tmE2, hmE2,
                                 tracer_type, parent, ny, nx)


def _update(grid, *, mm, tm, fe_mflx, fe_mtflx, fn_mflx, fn_mtflx,
            tracer_type, parent):
    """Divergence update of mass + tracers (update_fields :3517-3730),
    all categories: mm (ncat, ny, nx), tm (ncat, ntrace, ny, nx)."""
    ntrace = tm.shape[1]
    mtold = []
    for nt in range(ntrace):
        w = mm * tm[:, nt]
        p = parent[nt]
        if tracer_type[nt] >= 2:
            w = w * tm[:, p]
            if tracer_type[nt] == 3:
                w = w * tm[:, parent[p]]
        mtold.append(w)

    div_m = (fe_mflx[..., 1:] - fe_mflx[..., :-1]
             + fn_mflx[..., 1:, :] - fn_mflx[..., :-1, :])
    mm_new = torch.clamp(mm - div_m * grid.tarear, min=0.0)
    mm_new = torch.where(grid.tmask, mm_new, 0.0)

    tms = []
    pos = mm_new > 0.0
    for nt in range(ntrace):
        fe, fn = fe_mtflx[:, nt], fn_mtflx[:, nt]
        w1 = (fe[..., 1:] - fe[..., :-1] + fn[..., 1:, :] - fn[..., :-1, :])
        mt_new = mtold[nt] - w1 * grid.tarear
        if tracer_type[nt] == 1:
            den = mm_new
        elif tracer_type[nt] == 2:
            den = mm_new * tms[parent[nt]]
        else:
            den = mm_new * tms[parent[nt]] * tms[parent[parent[nt]]]
        ok = pos & (torch.abs(den) > 0.0)
        tms.append(torch.where(ok, mt_new / torch.where(ok, den, 1.0), 0.0))
    return mm_new, torch.stack(tms, dim=1)


def remap_fields_batch(grid, topo: Topology, geom: RemapGeometry, *, mm,
                       tm, tracer_type, parent):
    """Remap all categories: mm (ncat, ny, nx), tm (ncat, ntrace, ny, nx).
    One W=2 ghost ring of the raw fields feeds ``remap_flux_both``
    (ring 1 holds the donor cells the edge views read, ring 2 their
    gradient neighbourhoods); the divergence update follows."""
    ny, nx = mm.shape[-2:]
    mmE2 = extend_wide(mm, topo, 2)
    tmE2 = extend_wide(tm, topo, 2)
    hmE2 = extend_wide(grid.hm, topo, 2)
    qxn, qyn = _triangle_midpoints(geom.north)
    qxe, qye = _triangle_midpoints(geom.east)
    fn_mflx, fn_mtflx, fe_mflx, fe_mtflx = remap_flux_both(
        (geom.north.donor, geom.north.triarea, qxn, qyn),
        (geom.east.donor, geom.east.triarea, qxe, qye),
        mmE2, tmE2, hmE2, tracer_type, parent, ny, nx)
    return _update(grid, mm=mm, tm=tm, fe_mflx=fe_mflx, fe_mtflx=fe_mtflx,
                   fn_mflx=fn_mflx, fn_mtflx=fn_mtflx,
                   tracer_type=tracer_type, parent=parent)


def tracer_table(tr: TracerRegistry):
    """The remap tracer table [hice, hsno, trcrn...] with the reference's
    dependency types, class-sorted so every (type, parent) class is a
    contiguous block and parents precede dependents (remap.py:917-957 of
    the JAX package). Returns (tracer_type, parent, order, inv)."""
    tracer_type = [1, 1]
    parent = [-1, -1]
    for it in range(tr.ntrcr):
        d = tr.depend[it]
        if d == DEP_AICE:
            tracer_type.append(1)
            parent.append(-1)
        elif d == DEP_VICE:
            tracer_type.append(2)
            parent.append(0)
        elif d < DEP_TRCR:              # DEP_VSNO
            tracer_type.append(2)
            parent.append(1)
        else:
            p = d - DEP_TRCR
            tracer_type.append(2 if tr.depend[p] == DEP_AICE else 3)
            parent.append(2 + p)
    n_all = 2 + tr.ntrcr

    def _ckey(i):
        t = tracer_type[i]
        return (1, 0) if t == 1 else (t, parent[i])
    order = sorted(range(n_all), key=_ckey)
    inv = [0] * n_all
    for k, i in enumerate(order):
        inv[i] = k
    tracer_type = tuple(tracer_type[i] for i in order)
    parent = tuple(inv[parent[i]] if parent[i] >= 0 else -1 for i in order)
    return tracer_type, parent, order, inv


class TransportChecks(NamedTuple):
    conserv_err: torch.Tensor      # max relative global-sum drift (0-d)
    mono_violations: torch.Tensor  # count of monotone-bound violations


def transport_remap(dt, grid, topo: Topology, tr: TracerRegistry, *, uvel,
                    vvel, aicen, vicen, vsnon, trcrn, conserv_check=False,
                    monotonicity_check=False):
    """Full-state incremental remapping (transport_remap :198-630 +
    state_to_tracers/tracers_to_state): mass field = aicen per category,
    tracers = [hice, hsno, trcrn...] in class-sorted order.

    conserv_check / monotonicity_check (l_conservation_check /
    l_monotonicity_check, ice_transport_driver.F90:257-259): when either
    is on, a ``TransportChecks`` is returned as a fifth output: the
    relative global area/volume conservation error (global_conservation
    :1011) and the count of monotone-bound violations
    (local_max_min/check_monotonicity :1084, :1244). They wrap the
    kernel's fluxes; every sum is a plain reduction (no atomics)."""
    tracer_type, parent, order, inv = tracer_table(tr)
    safe_a = torch.clamp(aicen, min=ct.puny)
    has = aicen > 0.0
    hice = torch.where(has, vicen / safe_a, 0.0)
    hsno = torch.where(has, vsnon / safe_a, 0.0)
    src = lambda i: hice if i == 0 else (hsno if i == 1 else trcrn[:, i - 2])
    tm = torch.stack([src(i) for i in order], dim=1)

    geom = remap_geometry(dt, grid, topo, uvel=uvel, vvel=vvel)
    if monotonicity_check:
        tmin, tmax = monotonicity_bounds(tm, (aicen > 0.0).to(aicen.dtype),
                                         tracer_type, parent, topo)
    mm_new, tm_new = remap_fields_batch(grid, topo, geom, mm=aicen, tm=tm,
                                        tracer_type=tracer_type,
                                        parent=parent)
    aicen_n = mm_new
    hice_n = tm_new[:, inv[0]]
    hsno_n = tm_new[:, inv[1]]
    trcrn_n = torch.stack([tm_new[:, inv[2 + it]] for it in range(tr.ntrcr)],
                          dim=1)
    vicen_n, vsnon_n = aicen_n * hice_n, aicen_n * hsno_n
    if not (conserv_check or monotonicity_check):
        return aicen_n, vicen_n, vsnon_n, trcrn_n
    err = torch.zeros((), dtype=aicen.dtype, device=aicen.device)
    nbad = torch.zeros((), dtype=torch.int32, device=aicen.device)
    if conserv_check:
        for m0, m1 in ((aicen, aicen_n), (vicen, vicen_n),
                       (vsnon, vsnon_n)):
            s0 = global_conservation(m0.sum(0), grid.tarea, topo)
            s1 = global_conservation(m1.sum(0), grid.tarea, topo)
            err = torch.maximum(err, torch.abs(s1 - s0)
                                / torch.clamp(torch.abs(s0), min=1.0))
    if monotonicity_check:
        bad = check_monotonicity(tmin, tmax, mm_new, tm_new, tracer_type,
                                 parent)
        nbad = global_sum(bad.to(torch.int32), topo).to(torch.int32)
    return aicen_n, vicen_n, vsnon_n, trcrn_n, TransportChecks(
        conserv_err=err, mono_violations=nbad)


def monotonicity_bounds(tm, aimask, tracer_type, parent, topo: Topology):
    """Local pre-transport tracer min/max over the 9-point neighbourhood
    (ice_transport_driver.F90:1084-1190 local_max_min), over neighbours
    that carry the tracer (mass/parent mask): the monotone limits the
    remapped values must respect. tm: (..., ntrace, ny, nx); aimask:
    (..., ny, nx), 1.0 where mass > 0. Returns (tmin, tmax)."""
    masks = []
    for nt in range(tm.shape[-3]):
        if tracer_type[nt] == 1:
            masks.append(aimask)
        else:
            masks.append(aimask * (torch.abs(tm[..., parent[nt], :, :])
                                   > ct.puny))
    pm = torch.stack(masks, dim=-3)
    tmE = extend(tm, topo)
    pmE = extend(pm, topo)
    big = 1.0e30
    tmin = torch.where(pm > 0.0, tm, big)
    tmax = torch.where(pm > 0.0, tm, -big)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            v = shifted(tmE, di, dj)
            m = shifted(pmE, di, dj) > 0.0
            tmin = torch.minimum(tmin, torch.where(m, v, big))
            tmax = torch.maximum(tmax, torch.where(m, v, -big))
    return tmin, tmax


def check_monotonicity(tmin, tmax, mm_new, tm_new, tracer_type, parent):
    """Monotonicity violations after remap
    (ice_transport_driver.F90:1244-1330 check_monotonicity): new tracer
    values outside the pre-transport neighbourhood bounds. tm_new:
    (..., ntrace, ny, nx), mm_new (..., ny, nx). Returns a bool violation
    mask of tm_new's shape (all False when the scheme is monotone). The
    bound tolerance sits above float32's rounding of the remap itself."""
    eps_tol = max(ct.puny, 50.0 * torch.finfo(tm_new.dtype).eps)
    out = []
    for nt in range(tm_new.shape[-3]):
        lc = mm_new > ct.puny
        if tracer_type[nt] >= 2:
            lc = lc & (torch.abs(tm_new[..., parent[nt], :, :]) > ct.puny)
        if tracer_type[nt] == 3:
            lc = lc & (torch.abs(tm_new[..., parent[parent[nt]], :, :])
                       > ct.puny)
        span = torch.maximum(torch.abs(tmin[..., nt, :, :]),
                             torch.abs(tmax[..., nt, :, :]))
        tol = eps_tol * (1.0 + span)
        out.append(lc & ((tm_new[..., nt, :, :] < tmin[..., nt, :, :] - tol)
                         | (tm_new[..., nt, :, :]
                            > tmax[..., nt, :, :] + tol)))
    return torch.stack(out, dim=-3)


def global_conservation(mm, tarea, topo: Topology):
    """Global mass integral for the conservation check
    (ice_transport_driver.F90:1011-1082 global_conservation)."""
    return global_sum(mm * tarea, topo)
