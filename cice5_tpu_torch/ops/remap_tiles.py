"""Tile plan of the remap flux kernel (``csrc/remap_tiles.cu``).

The kernel computes the fluxes of both edge sets of all categories in one
launch. Edge point (j, i) of the (ny+1) x (nx+1) space is a north edge
when j <= ny and i < nx, an east edge when j < ny and i <= nx. The space
is cut into tiles of ``TY x TX`` edge points; block ``b`` takes category
``b % ncat`` of tile ``b // ncat`` (tiles row-major), so a tile's
categories run back to back. Its 512 threads hold the tile's north edges
(first half) and east edges (second half). A tile reads the raw W=2 window
of ``(TY+4) x (TX+4)`` cells from (j0, i0) of the ringed fields and
rebuilds the one-ring window of ``(TY+2) x (TX+2)`` cells in shared memory,
one tracer after another; every tracer that is the parent of another keeps
its reconstruction in a slot of its own (``slots``). This module only
plans, for the tests and the reports; the kernel computes the same
numbers itself.
"""
from __future__ import annotations

from typing import NamedTuple

TY, TX = 8, 32                  # edge points of a tile (csrc TY, TX)
RY, RX = TY + 2, TX + 2         # one-ring reconstruction window
WY, WX = TY + 4, TX + 4         # raw window
THREADS = 2 * TY * TX
SMEM_OPTIN_H100 = 232448        # shared memory a block may opt in to


def slots(tracer_type, parent) -> tuple[int, ...]:
    """The kernel's slot of each tracer (``make_table``): the parents of
    type-2 and type-3 tracers in stack order get 0, 1, ...; the others -1."""
    is_parent = {parent[t] for t in range(len(tracer_type))
                 if tracer_type[t] >= 2}
    out, n = [], 0
    for t in range(len(tracer_type)):
        out.append(n if t in is_parent else -1)
        n += t in is_parent
    return tuple(out)


def smem_values(nslot: int) -> int:
    """Shared memory of one block in values (``smem_values`` in the .cu):
    the mm and hm windows, two raw tracer windows and a raw mask per slot;
    the mass reconstruction (5 planes), two tracer reconstructions (3
    planes each) and 5 planes per slot on the one-ring window."""
    return WY * WX * (4 + nslot) + RY * RX * (5 + 6 + 5 * nslot)


class RemapPlan(NamedTuple):
    ny: int
    nx: int
    ncat: int
    nty: int          # tiles along y
    ntx: int          # tiles along x
    nslot: int
    itemsize: int

    @property
    def blocks(self) -> int:
        return self.ncat * self.nty * self.ntx

    @property
    def smem(self) -> int:
        return smem_values(self.nslot) * self.itemsize

    def block(self, b: int) -> tuple[int, int, int]:
        """(category, j0, i0) of block ``b``: its category and the first
        edge point of its tile."""
        tile = b // self.ncat
        return b % self.ncat, (tile // self.ntx) * TY, (tile % self.ntx) * TX

    def edges(self, b: int, east: bool) -> tuple[range, range]:
        """The rows and columns of the north (or east) edges block ``b``
        writes."""
        _, j0, i0 = self.block(b)
        nyr, nxr = (self.ny, self.nx + 1) if east else (self.ny + 1, self.nx)
        return (range(j0, min(j0 + TY, nyr)), range(i0, min(i0 + TX, nxr)))

    def describe(self) -> str:
        return (f"{self.nty}x{self.ntx} tiles of {TY}x{TX} edge points x "
                f"{self.ncat} categories = {self.blocks} blocks of {THREADS} "
                f"threads, {self.nslot} parent slots, {self.smem} B shared "
                f"per block")


def plan(ny: int, nx: int, ncat: int, tracer_type, parent, itemsize: int,
         smem_optin: int = SMEM_OPTIN_H100) -> RemapPlan:
    """The kernel's grid and shared memory for these shapes and this
    tracer table; raises where a block's shared memory exceeds
    ``smem_optin`` (many parent slots)."""
    nslot = sum(s >= 0 for s in slots(tracer_type, parent))
    p = RemapPlan(ny=ny, nx=nx, ncat=ncat, nty=-(-(ny + 1) // TY),
                  ntx=-(-(nx + 1) // TX), nslot=nslot, itemsize=itemsize)
    if p.smem > smem_optin:
        raise ValueError(f"remap_flux_both: {nslot} parent slots need "
                         f"{p.smem} B of shared memory per block, more than "
                         f"{smem_optin}")
    return p
