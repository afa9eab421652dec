"""Several processes: start-up, point-to-point exchanges, gathers
(PyTorch port of ``cice5_tpu/parallel/distributed.py``).

The reference scales by MPI ranks (mpi/ice_communicate.F90:52
init_communicate). The port runs one ``torch.distributed`` process per
tile of a 2-D mesh (``parallel/mesh.py``): ``"nccl"`` with one card per
rank, or ``"gloo"`` for the CPU and for several ranks sharing one card,
where CUDA tensors are staged through host memory. The model code is the
same on any mesh; the halo exchanges (``parallel/halo.py``) go through
``shift_pair`` and ``row_gather`` here, and the I/O boundaries through
``gather`` / ``to_host``.

Launch (one process per rank)::

    torchrun --nproc-per-node=4 my_run.py       # in my_run.py:
    initialize_distributed("nccl")              # reads torchrun's env
    sm = ShardedModel(cfg)                      # mesh over every rank
    sm.run(sm.init_state(), nsteps)             # only rank 0 writes files

Every exchange and reduction adds to ``traffic()``: the halo exchanges
(one ``batch_isend_irecv`` each), the bytes this rank sent in them, and
the collectives (reductions and gathers).
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

AXIS_Y = "Y"     # mesh rows, south to north
AXIS_X = "X"     # mesh columns, west to east

_TRAFFIC = {"exchanges": 0, "bytes": 0, "collectives": 0}


def reset_traffic() -> None:
    for k in _TRAFFIC:
        _TRAFFIC[k] = 0


def traffic() -> dict:
    """Halo exchanges, bytes sent in them and collectives of this rank
    since ``reset_traffic``."""
    return dict(_TRAFFIC)


def initialize_distributed(backend: str, init_method: str | None = None,
                           rank: int | None = None,
                           world_size: int | None = None) -> None:
    """Start this process's ``torch.distributed`` group; a second call
    does nothing.

    With no ``init_method`` the rendezvous, rank and world size come from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); otherwise pass all three (e.g. a ``file://`` store).
    ``backend="nccl"`` needs one card per rank on this node
    (``LOCAL_WORLD_SIZE`` ranks, else ``world_size``) and makes card
    ``LOCAL_RANK`` (else ``rank``) the current device; several ranks on one
    card take ``backend="gloo"``."""
    if dist.is_initialized():
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' (one card per rank) "
                         "or 'gloo' (the CPU, or several ranks on a card)")
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    elif rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    if backend == "nccl":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        ncard = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if local_world > ncard:
            raise RuntimeError(
                f"backend 'nccl' needs one CUDA card per rank: {local_world} "
                f"ranks on this node and {ncard} card(s); run several ranks "
                "on one card with backend='gloo'")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def is_primary() -> bool:
    """True on the process that writes files (master_task analog)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _wire(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if mesh.staged else t


def _p2p(sends, recvs, mesh):
    """One ``batch_isend_irecv`` of ``sends`` [(peer, tensor, tag)] and
    ``recvs`` [(peer, template, tag)]; returns the received tensors on the
    templates' device. Messages between two ranks match in the order and
    with the tag they were posted."""
    ops, out, keep = [], [], []
    for peer, t, tag in sends:
        w = _wire(t, mesh)
        keep.append(w)
        ops.append(dist.P2POp(dist.isend, w, peer, tag=tag))
        _TRAFFIC["bytes"] += w.numel() * w.element_size()
    for peer, like, tag in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if mesh.staged else like.device)
        out.append((buf, like.device))
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
    if ops:
        _TRAFFIC["exchanges"] += 1
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(dev) for b, dev in out]


def shift_pair(lo: torch.Tensor, hi: torch.Tensor, mesh, axis: str,
               cyclic: bool):
    """The neighbour exchange along one mesh axis (the ppermute pair of
    ``cice5_tpu/parallel/halo.py:_pshift``): returns (the ``hi`` block of
    the previous rank, the ``lo`` block of the next rank) in one
    ``batch_isend_irecv``. Past a non-cyclic edge the block is zeros; an
    axis of one rank is served locally."""
    n = mesh.size(axis)
    if n == 1:
        if cyclic:
            return hi, lo
        return torch.zeros_like(hi), torch.zeros_like(lo)
    prev = mesh.neighbour(axis, -1, cyclic)
    nxt = mesh.neighbour(axis, +1, cyclic)
    sends = [(p, t, tag) for p, t, tag in ((nxt, hi, 0), (prev, lo, 1))
             if p is not None]
    recvs = [(p, t, tag) for p, t, tag in ((prev, hi, 0), (nxt, lo, 1))
             if p is not None]
    got = iter(_p2p(sends, recvs, mesh))
    from_prev = next(got) if prev is not None else torch.zeros_like(hi)
    from_next = next(got) if nxt is not None else torch.zeros_like(lo)
    return from_prev, from_next


def row_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """(..., k, nx_tile) blocks of every rank of this mesh row joined into
    the global (..., k, nx) in column order, on every rank of the row. On
    the top row this carries the tripole fold's rows: each rank sends its
    block to the other ranks of its row (for two columns of ranks, the
    mirror pair ix <-> px-1-ix)."""
    if mesh.px == 1:
        return x
    peers = [mesh.rank_of(mesh.iy, j) for j in range(mesh.px)]
    others = [p for j, p in enumerate(peers) if j != mesh.ix]
    got = iter(_p2p([(p, x, 2) for p in others],
                    [(p, x, 2) for p in others], mesh))
    parts = [x if j == mesh.ix else next(got) for j in range(mesh.px)]
    return torch.cat(parts, dim=-1)


def all_gather(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape everywhere), in mesh order, on every
    rank: one collective."""
    w = _wire(x, mesh)
    bufs = [torch.empty_like(w) for _ in mesh.ranks]
    _TRAFFIC["collectives"] += 1
    dist.all_gather(bufs, w)
    return [b.to(x.device) for b in bufs]


def all_reduce_min(x: torch.Tensor, mesh) -> torch.Tensor:
    w = _wire(x, mesh).clone()
    _TRAFFIC["collectives"] += 1
    dist.all_reduce(w, op=dist.ReduceOp.MIN)
    return w.to(x.device)


def _leaves(tree):
    """(leaves, rebuild) of a tensor, dataclass, NamedTuple, dict, list or
    tuple tree; None and Python scalars are leaves kept as they are."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        parts = [_leaves(getattr(tree, n)) for n in names]
        return _join(parts, lambda vals: dataclasses.replace(
            tree, **dict(zip(names, vals))))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [_leaves(v) for v in tree]
        return _join(parts, lambda vals: type(tree)(*vals))
    if isinstance(tree, (list, tuple)):
        parts = [_leaves(v) for v in tree]
        return _join(parts, lambda vals: type(tree)(vals))
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_leaves(tree[k]) for k in keys]
        return _join(parts, lambda vals: dict(zip(keys, vals)))
    return [tree], lambda vals: vals[0]


def _join(parts, build):
    leaves = [x for lv, _ in parts for x in lv]
    counts = [len(lv) for lv, _ in parts]

    def rebuild(vals):
        out, k = [], 0
        for (_, rb), c in zip(parts, counts):
            out.append(rb(vals[k:k + c]))
            k += c
        return build(out)
    return leaves, rebuild


def tree_map(fn, tree):
    leaves, rebuild = _leaves(tree)
    return rebuild([fn(x) for x in leaves])


def _spatial(x, shape) -> bool:
    return torch.is_tensor(x) and x.dim() >= 2 and \
        tuple(x.shape[-2:]) == tuple(shape)


def put(tree, mesh, device=None):
    """This rank's tile of every global (..., ny, nx) tensor of ``tree``,
    as a contiguous copy on ``device`` (default: where it is); other
    leaves are kept (the scatter_global analog,
    mpi/ice_gather_scatter.F90:968). No communication: every rank holds
    the global tree."""
    rows, cols = mesh.slices()

    def one(x):
        if torch.is_tensor(x) and x.dim() >= 2:
            if tuple(x.shape[-2:]) != tuple(mesh.global_shape):
                raise ValueError(f"a {tuple(x.shape)} tensor on a "
                                 f"{mesh.global_shape} mesh")
            return x[..., rows, cols].to(device=device).contiguous()
        return x.to(device) if torch.is_tensor(x) and device else x
    return tree_map(one, tree)


def gather(tree, mesh):
    """The global tensors of a tree of tiles, on the tiles' device and on
    every rank (the gather_global analog, mpi/ice_gather_scatter.F90:71):
    one all-gather per dtype of the tree's tiles. Leaves that are not
    (..., ny_tile, nx_tile) tensors are kept as this rank holds them."""
    leaves, rebuild = _leaves(tree)
    idx = [k for k, x in enumerate(leaves) if _spatial(x, mesh.tile)]
    out = list(leaves)
    by_dtype: dict = {}
    for k in idx:
        by_dtype.setdefault(leaves[k].dtype, []).append(k)
    for dtype, ks in by_dtype.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([leaves[k].reshape(-1).to(wire) for k in ks])
        parts = all_gather(flat, mesh)
        off = 0
        for k in ks:
            t = leaves[k]
            g = torch.empty(t.shape[:-2] + tuple(mesh.global_shape),
                            dtype=dtype, device=t.device)
            for r, part in enumerate(parts):
                rows, cols = mesh.slices(r // mesh.px, r % mesh.px)
                g[..., rows, cols] = part[off:off + t.numel()].reshape(
                    t.shape).to(dtype)
            out[k] = g
            off += t.numel()
    return rebuild(out)


def to_host(x, mesh=None):
    """A tile (or a tree of tiles) gathered into the global host NumPy
    array(s) on every rank; with no mesh, a plain copy to the host."""
    if mesh is not None:
        x = gather(x, mesh)
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if torch.is_tensor(t) else t, x)


__all__ = ["initialize_distributed", "is_primary", "shift_pair",
           "row_gather", "all_gather", "all_reduce_min", "put", "gather",
           "to_host", "tree_map", "traffic", "reset_traffic"]
