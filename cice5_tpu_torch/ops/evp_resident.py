"""Tile plan of the SM-resident EVP kernel (``csrc/evp_resident.cu``).

The kernel runs a whole EVP sweep (or a chunk of the fused sweep) in one
cooperative launch: the U points are cut into ``ntj x nti`` tiles, tile
``(tj, ti)`` holding rows ``tj*ny//ntj`` to ``(tj+1)*ny//ntj`` and columns
``ti*nx//nti`` to ``(ti+1)*nx//nti``; region point (j, i) belongs to the
tile of U point (j, i), and the tiles of the top row and right column also
own the region's extra row ``ny`` and column ``nx``. Each tile computes the
stress of its region points plus the one-point ring north and east of
them, so a subcycle needs one grid barrier. ``tile_plan`` chooses the
tiles and where the state lives:

- ``"shared+ro"``: one tile per block and one block per SM, the tile's
  stress state, str8, (u, v) window and every read-only plane in shared
  memory for the whole call;
- ``"shared"``: the same with the read-only planes read through L1/L2;
- ``"device"``: for grids whose state does not fit the card's shared
  memory (0.25 degree, 1080x1440): tiles of at most 30x32 U points, each
  block walking several of them per subcycle, a tile's stress state in a
  device scratch.

A shared branch takes the split with the fewest region points in its
largest tile (then the fewest tiles) among those with at most one tile per
SM whose shared memory fits. This module only plans; ``kernels.evp_sweep``
and ``kernels.evp_fused`` launch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# the kernel's enum Branch, in order
BRANCHES = ("device", "shared", "shared+ro")
THREADS = {4: 512, 8: 384}    # threads per block by value size (csrc
                              # Threads<T>)
NRO_R, NRO_U = 12, 14         # staged read-only planes: region, U point
PLANE = 1024                  # plane stride: the most region points of a
                              # tile, (tym+1)*(txm+1)
DEVICE_TILE = (30, 32)        # U points of a device-branch tile (31x33
                              # region points: two passes of 512 threads)


def smem_bytes(branch: str, tym: int, txm: int, itemsize: int) -> int:
    """Shared memory of one block (``smem_values`` in the .cu): the (u, v)
    window and a fold tile's raw top row, str8, then the stress state
    (shared branches) and the read-only planes ("shared+ro"), each plane
    PLANE values long."""
    n = 2 * (tym + 2) * (txm + 2) + 2 * txm + 8 * PLANE
    if branch != "device":
        n += 12 * PLANE
    if branch == "shared+ro":
        n += (NRO_R + NRO_U) * PLANE
    return n * itemsize


class TilePlan(NamedTuple):
    ny: int
    nx: int
    ntj: int          # tiles along y
    nti: int          # tiles along x
    tym: int          # U rows of the tallest tile
    txm: int          # U columns of the widest tile
    branch: str       # one of BRANCHES
    blocks: int       # cooperative grid (one block per SM at most)
    smem: int         # shared memory bytes per block
    itemsize: int

    @property
    def ntiles(self) -> int:
        return self.ntj * self.nti

    def as_ints(self) -> tuple[int, ...]:
        """The kernel's ``plan`` argument."""
        return (self.ntj, self.nti, self.tym, self.txm,
                BRANCHES.index(self.branch), self.blocks)

    def scratch_values(self) -> int:
        """Values of the kernel's device scratch: two exchange buffers of
        (u, v), and in the device branch 12 stress planes per tile."""
        n = 4 * self.ny * self.nx
        if self.branch == "device":
            n += self.ntiles * 12 * PLANE
        return n

    def tile(self, t: int) -> tuple[int, int, int, int]:
        """(j0, j1, i0, i1): the U rows and columns of tile ``t``."""
        tj, ti = divmod(t, self.nti)
        return (tj * self.ny // self.ntj, (tj + 1) * self.ny // self.ntj,
                ti * self.nx // self.nti, (ti + 1) * self.nx // self.nti)

    def barriers(self, nsub: int, in_place: bool) -> int:
        """Grid barriers of one launch of ``nsub`` subcycles: one after
        each but the last, and one after the last when the outputs alias
        the inputs (``evp_sweep``)."""
        return nsub if in_place else nsub - 1

    def describe(self) -> str:
        return (f"{self.ntj}x{self.nti} = {self.ntiles} tiles of at most "
                f"{self.tym}x{self.txm} U points, {self.blocks} blocks of "
                f"{THREADS[self.itemsize]} threads, branch {self.branch!r}, "
                f"{self.smem} B shared memory per block")


@functools.lru_cache(maxsize=None)
def tile_plan(ny: int, nx: int, dtype: torch.dtype, n_sm: int,
              smem_optin: int, branch: str | None = None) -> TilePlan:
    """The tiles and branch of the EVP kernel for a (ny, nx) grid of
    ``dtype`` (float32 or float64) on ``n_sm`` SMs (at most one block
    each) whose blocks may use ``smem_optin`` bytes of shared memory:
    "shared+ro" where it fits, else "shared", else "device" with tiles of
    at most DEVICE_TILE U points. ``branch`` forces one (ValueError if a
    shared branch does not fit)."""
    itemsize = {torch.float32: 4, torch.float64: 8}[dtype]
    if branch is not None and branch not in BRANCHES:
        raise ValueError(f"branch must be one of {BRANCHES}, not {branch!r}")
    if ny < 1 or nx < 1 or n_sm < 1:
        raise ValueError(f"tile_plan needs a grid and SMs, not ny={ny}, "
                         f"nx={nx}, n_sm={n_sm}")
    for br in ((branch,) if branch else ("shared+ro", "shared")):
        if br == "device":
            break
        best = None
        for ntj in range(1, min(ny, n_sm) + 1):
            tym = -(-ny // ntj)
            for nti in range(1, min(nx, n_sm // ntj) + 1):
                txm = -(-nx // nti)
                smem = smem_bytes(br, tym, txm, itemsize)
                if smem > smem_optin or (tym + 1) * (txm + 1) > PLANE:
                    continue
                key = ((tym + 1) * (txm + 1), ntj * nti, ntj)
                if best is None or key < best[0]:
                    best = (key, ntj, nti, tym, txm, smem)
        if best is not None:
            _, ntj, nti, tym, txm, smem = best
            return TilePlan(ny, nx, ntj, nti, tym, txm, br, ntj * nti, smem,
                            itemsize)
        if branch is not None:
            raise ValueError(f"the {br!r} branch does not fit {ny}x{nx} in "
                             f"{n_sm} blocks of {smem_optin} B")
    ntj, nti = -(-ny // DEVICE_TILE[0]), -(-nx // DEVICE_TILE[1])
    tym, txm = -(-ny // ntj), -(-nx // nti)
    smem = smem_bytes("device", tym, txm, itemsize)
    if smem > smem_optin or (tym + 1) * (txm + 1) > PLANE:
        raise ValueError(f"a {tym}x{txm} tile needs {smem} B of shared "
                         f"memory, more than the {smem_optin} B a block may "
                         "use")
    return TilePlan(ny, nx, ntj, nti, tym, txm, "device",
                    min(ntj * nti, n_sm), smem, itemsize)
