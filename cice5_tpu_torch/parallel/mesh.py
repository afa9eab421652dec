"""The 2-D mesh of ranks (PyTorch port of ``cice5_tpu/parallel/mesh.py``).

The reference decomposes its domain into blocks spread over MPI ranks
(ice_blocks.F90, ice_distribution.F90, ice_domain.F90). Here the (ny, nx)
grid is split into equal (ny/py, nx/px) tiles over a (py, px) mesh of
``torch.distributed`` ranks, one tile per rank, and every rank runs the
same step on its tile; the halo exchanges of ``parallel/halo.py`` and the
global reductions go through the process group. Rank ``ranks[iy * px +
ix]`` holds the tile in mesh row ``iy`` (south to north) and column ``ix``
(west to east).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from cice5_tpu_torch.parallel.distributed import AXIS_X, AXIS_Y
from cice5_tpu_torch.parallel.halo import Topology

__all__ = ["AXIS_X", "AXIS_Y", "Mesh", "best_mesh_shape", "make_mesh",
           "mesh_topology"]


def best_mesh_shape(n_devices: int, ny: int, nx: int) -> tuple[int, int]:
    """Pick (py, px) ~ the most-square factorization that divides the grid
    (the analog of proc_decomposition, ice_distribution.F90:199)."""
    best = (1, n_devices)
    best_score = None
    for py in range(1, n_devices + 1):
        if n_devices % py:
            continue
        px = n_devices // py
        if ny % py or nx % px:
            continue
        # prefer square-ish shards (minimize halo perimeter / area)
        score = (ny // py) + (nx // px)
        if best_score is None or score < best_score:
            best, best_score = (py, px), score
    if best_score is None:
        raise ValueError(f"no (py,px) with py*px={n_devices} divides "
                         f"({ny},{nx})")
    return best


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (py, px) mesh over a global (ny, nx) grid.

    ``ranks`` lists the ranks of the default process group in mesh order;
    ``staged``: the backend moves host tensors only (gloo), so CUDA tiles
    go through host memory."""
    shape: tuple[int, int]
    coords: tuple[int, int]
    global_shape: tuple[int, int]
    ranks: tuple[int, ...]
    staged: bool = False

    @property
    def py(self) -> int:
        return self.shape[0]

    @property
    def px(self) -> int:
        return self.shape[1]

    @property
    def iy(self) -> int:
        return self.coords[0]

    @property
    def ix(self) -> int:
        return self.coords[1]

    @property
    def tile(self) -> tuple[int, int]:
        """(ny, nx) of every tile."""
        return (self.global_shape[0] // self.py,
                self.global_shape[1] // self.px)

    def size(self, axis: str) -> int:
        return self.py if axis == AXIS_Y else self.px

    def index(self, axis: str) -> int:
        return self.iy if axis == AXIS_Y else self.ix

    def rank_of(self, iy: int, ix: int) -> int:
        return self.ranks[iy * self.px + ix]

    def neighbour(self, axis: str, step: int, cyclic: bool):
        """The rank ``step`` tiles along ``axis``, or None past a
        non-cyclic edge."""
        n, i = self.size(axis), self.index(axis) + step
        if not cyclic and not 0 <= i < n:
            return None
        i %= n
        return self.rank_of(i, self.ix) if axis == AXIS_Y \
            else self.rank_of(self.iy, i)

    def slices(self, iy: int | None = None, ix: int | None = None):
        """(row slice, column slice) of a tile in the global grid (this
        rank's by default)."""
        ty, tx = self.tile
        iy = self.iy if iy is None else iy
        ix = self.ix if ix is None else ix
        return slice(iy * ty, (iy + 1) * ty), slice(ix * tx, (ix + 1) * tx)

    @property
    def is_top(self) -> bool:
        """Does this tile hold the global top (north) row?"""
        return self.iy == self.py - 1


def make_mesh(ny: int, nx: int, shape: tuple[int, int] | None = None,
              device=None) -> Mesh:
    """The mesh of every rank of the initialized default process group
    over a (ny, nx) grid; ``shape`` defaults to ``best_mesh_shape``.
    ``device``: where the tiles live (a CUDA tile under gloo is staged
    through host memory)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.distributed.initialize_distributed "
                           "first")
    n = dist.get_world_size()
    if shape is None:
        shape = best_mesh_shape(n, ny, nx)
    py, px = shape
    if py * px != n:
        raise ValueError(f"mesh {shape} for {n} ranks")
    if ny % py or nx % px:
        raise ValueError(f"mesh {shape} does not divide the grid ({ny}, "
                         f"{nx})")
    me = dist.get_rank()
    staged = dist.get_backend() == "gloo" and device is not None and \
        str(device).startswith("cuda")
    return Mesh(shape=(py, px), coords=(me // px, me % px),
                global_shape=(ny, nx), ranks=tuple(range(n)),
                staged=staged)


def mesh_topology(mesh: Mesh, ew: str, ns: str) -> Topology:
    return Topology(ew=ew, ns=ns, mesh=mesh)
