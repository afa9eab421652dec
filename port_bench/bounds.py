"""The least time each hand-written kernel could take on one H100.

Frozen copies of the bound functions with which the port's checks
measured its kernels (``evp_bound``, ``remap_bound``, ``dedd_bound``):
each counts from the kernel's inputs, each input byte read once and each
output byte written once, and only the operations those inputs need. The
least time is the larger of operations over the peak rate of the
inputs' floating type and bytes over the HBM bandwidth. They take the argument dicts that the
reference's plain kernels receive, whatever implements the kernel.
"""
from __future__ import annotations

import torch

# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet, dense,
# outside the tensor cores), by the bytes of the floating type
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
FLOP_PER_S = {4: FP32_FLOP_PER_S, 8: FP64_FLOP_PER_S}
PUNY = 1.0e-11
# hand count of the EVP sweep's arithmetic per subcycle: strain rates 84,
# Delta 28, replacement pressure 17, stress relaxation 44, stress
# divergence 196 per region point; the momentum solve 45 per U point
EVP_FLOP_REGION, EVP_FLOP_U = 369, 45
# remap_flux_both: reconstruction 60 + 70 per tracer per cell; integrals
# about 320 + 30 per tracer + 200 per parent class per edge, both counted
# only where the data needs them (cells and edges with ice within reach)
RM_FLOP_CELL, RM_FLOP_CELL_TRACER = 60, 70
RM_FLOP_EDGE, RM_FLOP_EDGE_TRACER, RM_FLOP_EDGE_PARENT = 320, 30, 200
# shortwave_dedd per lit column at 4 ice and 1 snow layer, counting exp and
# sqrt as one operation; each further layer adds ~450, and more than one
# snow layer a third snow property set per band (3 x 480)
DEDD_OPS_LIT_COLUMN, DEDD_OPS_LAYER, DEDD_OPS_PROPS = 20000, 450, 480


def _least(nbytes, flops, itemsize=4):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOP_PER_S[itemsize]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def evp_bound(ny: int, nx: int, ndte: int, itemsize: int = 4):
    """(least ms, what bounds it) of an ndte-subcycle EVP sweep on an
    (ny, nx) grid in a floating type of ``itemsize`` bytes."""
    nreg, nu = (ny + 1) * (nx + 1), ny * nx
    nbytes = itemsize * ((2 + 13) * nu + (12 + 2 + 10) * nreg
                         + (2 + 2) * nu + (12 + 5) * nreg)
    flops = ndte * (EVP_FLOP_REGION * nreg + EVP_FLOP_U * nu)
    return _least(nbytes, flops, itemsize)


def remap_bound(args, edges=("north", "east")):
    """(least ms, what bounds it) of the remap flux kernel on the
    arguments (geomN, geomE, mmE2, tmE2, hmE2, tracer_type, parent, ny,
    nx) of ``remap_flux_both``: the fluxes written once, the raw mass
    field read once, and where ice is within reach (a cell whose 5x5 raw
    neighbourhood holds ice in the category) the raw tracers and each
    edge set's geometry read once; the operations counted the same way."""
    geomN, geomE, mmE2, tmE2, hmE2, tt, par, ny, nx = args
    ncat, ntrace = tmE2.shape[:2]
    nedge = sum((ny + 1) * nx if e == "north" else ny * (nx + 1)
                for e in edges)
    lit = torch.nn.functional.max_pool2d(
        (mmE2 != 0).float()[:, None], 5, stride=1)[:, 0]
    nlit = float(lit.sum())
    nlit_any = float(lit.amax(0).sum())
    itemsize = mmE2.element_size()
    nbytes = itemsize * (mmE2.numel() + ntrace * nlit + nlit_any
                         + 48 * len(edges) * nlit_any
                         + ncat * (1 + ntrace) * nedge)
    nparent = len({q for q, t in zip(par, tt) if t == 2})
    flops = nlit * (RM_FLOP_CELL + RM_FLOP_CELL_TRACER * ntrace) \
        + len(edges) * nlit * (RM_FLOP_EDGE + RM_FLOP_EDGE_TRACER * ntrace
                               + RM_FLOP_EDGE_PARENT * nparent)
    return _least(nbytes, flops, itemsize)


def dedd_lit(kw):
    """The lit (category, cell) columns: aicen, net shortwave and coszen
    above puny."""
    netsw = kw["swvdr"] + kw["swvdf"] + kw["swidr"] + kw["swidf"]
    return ((kw["aicen"] > PUNY) & (netsw > PUNY)[None]
            & (kw["coszen"] > PUNY)[None])


def dedd_bound(kw):
    """(least ms, what bounds it) of the delta-Eddington kernel on the
    keyword arguments of ``shortwave_dEdd_ncat``: every column reads
    aicen and writes all its planes, every cell reads coszen and the four
    shortwave planes; only a lit column reads the other five category
    inputs, and only a cell with one reads fnidr."""
    ncat, ny, nx = kw["aicen"].shape
    nilyr, nslyr = kw["nilyr"], kw["nslyr"]
    nout = 11 + nslyr + 2 * nilyr + 1
    lit = dedd_lit(kw)
    nlit, nlit_cells = int(lit.sum()), int(lit.any(0).sum())
    itemsize = kw["aicen"].element_size()
    nbytes = itemsize * (ncat * ny * nx * (1 + nout) + 5 * ny * nx
                         + 5 * nlit + nlit_cells)
    ops = (DEDD_OPS_LIT_COLUMN + DEDD_OPS_LAYER * (nilyr + nslyr - 5)
           + (3 * DEDD_OPS_PROPS if nslyr > 1 else 0)) * nlit
    return _least(nbytes, ops, itemsize)
