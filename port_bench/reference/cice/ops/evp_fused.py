"""Fused multi-subcycle EVP (PyTorch port of
``cice5_tpu/ops/pallas/evp_fused.py``, ``evp_algorithm="pallas"``).

The EVP subcycles run in chunks of ``kchunk``. In the plain version each
chunk starts from the state of the whole domain, advances a set of
overlapping Y-windows by ``kchunk`` subcycles each, every window carrying
M = kchunk + 1 rows of margin, and keeps only their cores. With an open
or closed north-south boundary the zero rows beyond the domain are the
zero ghosts of ``extend``; a window's own edge spreads an error one row
per subcycle, which dies inside the margin. So the chunked sweep is the
same function as the plain subcycle loop (``evp.subcycle_sweep``),
computed with temporal blocking.

Two implementations with one signature:

- ``fused_sweep_plain``: the JAX package's windowing in plain PyTorch
  (pad by M zero rows, ``nwin`` overlapping Y-windows of the full width,
  ``kchunk`` subcycles of ``stress_kernel``/``stepu`` on each, cores
  reassembled, the stress re-padded with its north region row zeroed).
  The CPU path and the reference for the kernel.
- ``fused_sweep``: the plain version for CPU tensors, for CUDA tensors
  the ``evp_fused`` entry of ``csrc/evp_resident.cu``, the engine of the
  EVP sweep kernel: one cooperative launch per chunk, one tile per SM
  with its state in shared memory, no margins, one grid barrier between
  subcycles.

Unlike the JAX kernel, every subcycle here uses the caller's ``Cw`` (the
JAX ``_fused_window_call`` calls ``stepu`` without it, evp_fused.py:81-84,
so its subcycles use ``ct.dragio`` whatever the caller passes), and a
cyclic north-south boundary is refused rather than run as an open one
(evp_fused.py:165-173 pads every window with zero rows).
"""
from __future__ import annotations

import torch

from reference.cice.constants import FieldLoc, FieldType
from reference.cice.models.dynamics import evp as tevp
from reference.cice.models.dynamics import shared as dyn
from reference.cice.parallel import Topology, extend

def _check(ndte: int, topo: Topology, kchunk: int):
    if topo.ns in ("tripole", "tripoleT", "cyclic"):
        raise ValueError(
            f"the fused EVP sweep takes an open or closed north-south "
            f"boundary, not {topo.ns!r}: its zero margin rows are the "
            f"boundary's zero ghosts (the JAX kernel pads a cyclic grid the "
            f"same way and so computes open-boundary dynamics there)")
    if kchunk < 1 or ndte < kchunk or ndte % kchunk != 0:
        raise ValueError(f"ndte={ndte} must be a positive multiple of "
                         f"kchunk={kchunk}")


def fused_sweep_plain(p: dyn.EVPParams, ndte: int, topo: Topology, *,
                      kchunk: int, nwin: int, uvel, vvel, stressR, maskR,
                      strengthR, gR, icem_u, aiu, uocn, vocn, waterx,
                      watery, forcex, forcey, umassdti, fm, uarear,
                      uvel_init, vvel_init, Cw):
    """``ndte`` EVP subcycles in chunks of ``kchunk`` on ``nwin`` Y-windows
    (evp_fused.py:158-229 of the JAX package) in plain PyTorch. Takes and
    returns what ``evp.subcycle_sweep`` does: (u, v, stressR, diags) with
    diags = (divuR, shearR, rdg_convR, rdg_shearR, prs_sigR, strintx,
    strinty) of the last subcycle."""
    _check(ndte, topo, kchunk)
    ny, nx = uvel.shape
    K, M = kchunk, kchunk + 1
    BS = -(-ny // nwin)                     # interior rows per window
    H = BS + 2 * M
    extra = nwin * BS - ny
    pad = lambda f: torch.nn.functional.pad(f, (0, 0, M, M + extra))
    topo1 = Topology(ew=topo.ew, ns="open")

    planes = dict(aiu=aiu, uocn=uocn, vocn=vocn, waterx=waterx,
                  watery=watery, forcex=forcex, forcey=forcey,
                  umassdti=umassdti, fm=fm, uarear=uarear,
                  uvel_init=uvel_init, vvel_init=vvel_init)
    win_u = {k: pad(a) for k, a in planes.items()}
    if torch.is_tensor(Cw) and Cw.dim() > 0:     # a drag coefficient plane
        win_u["Cw"] = pad(Cw)
    icem_p = pad(icem_u)
    gR_p = {k: pad(a) for k, a in gR.items()}
    strength_p, mask_p = pad(strengthR), pad(maskR)
    u_p, v_p, stress_p = pad(uvel), pad(vvel), pad(stressR)

    for _ in range(ndte // K):
        cores = {k: [] for k in ("u", "v", "s", "d", "si")}
        for w in range(nwin):
            rows, rrows = slice(w * BS, w * BS + H), slice(w * BS,
                                                           w * BS + H + 1)
            u, v, stress = u_p[rows], v_p[rows], stress_p[:, rrows]
            wu = {k: a[rows] for k, a in win_u.items()}
            wu.setdefault("Cw", Cw)
            wg = {k: a[rrows] for k, a in gR_p.items()}
            for _ in range(K):
                uvE = extend(torch.stack([u, v]), topo1, loc=FieldLoc.NECORNER,
                             kind=FieldType.VECTOR)
                r = tevp.stress_kernel(p, uvE[0], uvE[1], stress,
                                       maskR=mask_p[rrows],
                                       strengthR=strength_p[rrows], gR=wg)
                s = dyn.stepu(p, icemask=icem_p[rows], strE=r.str8,
                              uvel=u, vvel=v, **wu)
                u, v, stress = s.uvel, s.vvel, r.stress
            core = slice(M, M + BS)
            cores["u"].append(u[core])
            cores["v"].append(v[core])
            cores["s"].append(stress[:, core])
            cores["d"].append(torch.stack([r.divu, r.shear, r.rdg_conv,
                                           r.rdg_shear, r.prs_sig])[:, core])
            cores["si"].append(torch.stack([s.strintx, s.strinty])[:, core])
        repad = lambda parts, dim, after: torch.nn.functional.pad(
            torch.cat(parts, dim=dim), (0, 0, M, M + after))
        u_p = repad(cores["u"], 0, 0)
        v_p = repad(cores["v"], 0, 0)
        # the stress's north region row is re-padded with zeros; the
        # margins recompute it from the zero-padded velocities, as the
        # single-device extend does
        stress_p = repad(cores["s"], 1, 1)
        diag_p = repad(cores["d"], 1, 1)
        strint = torch.cat(cores["si"], dim=1)[:, :ny]

    reg = slice(M, M + ny + 1)
    diag = diag_p[:, reg]
    return (u_p[M:M + ny], v_p[M:M + ny], stress_p[:, reg],
            (diag[0], diag[1], diag[2], diag[3], diag[4], strint[0],
             strint[1]))


def fused_sweep(p: dyn.EVPParams, ndte: int, topo: Topology, *, kchunk: int,
                nwin: int, **sweep):
    """The reference's fused EVP sweep: ``fused_sweep_plain`` on whatever
    device the tensors are on."""
    return fused_sweep_plain(p, ndte, topo, kchunk=kchunk, nwin=nwin,
                             **sweep)


def evp_fused(dt, p: dyn.EVPParams, grid, topo: Topology, *,
              kchunk: int = 10, nwin: int = 4, **fields) -> tevp.EVPResult:
    """EVP driver with the fused subcycle sweep: the surface of
    ``evp.evp`` (``fields`` are the keyword arguments of ``evp.evp_prep``,
    ``Cw`` among them) and the defaults of the JAX ``evp_fused``
    (kchunk=10, nwin=4), which the JAX step uses."""
    sweep, forcing = tevp.evp_prep(dt, p, grid, topo, **fields)
    out = fused_sweep(p, p.ndte, topo, kchunk=kchunk, nwin=nwin, **sweep)
    return tevp.evp_result(p, grid, topo, sweep, forcing, out)
