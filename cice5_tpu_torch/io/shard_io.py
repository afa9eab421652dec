"""Per-rank restart and history files (PyTorch port of
``cice5_tpu/io/shard_io.py``, the PIO box-rearranger analog).

The reference's parallel output paths (io_pio/ box rearranger,
io_netcdf/ice_history_write.F90:1508-1816 per-block parallel puts) avoid
funnelling the global state through one writer task. Here every rank of a
mesh writes its tile to its own file, with no communication, and a
restore reassembles the global arrays from all the files.

The files are the JAX package's: ``shards.pNNN.npz`` (keys
``<field>::<k>``, one per tile the process holds, and an ``__index__``
JSON of each tile's slices, each field's global shape and dtype) with a
``manifest.json`` written by the primary, and ``hist.pNNN.npz`` with
``hist_manifest.json``; NNN is the rank (the JAX process index). Each
package restores the other's dumps bit for bit, and
``assemble_history`` writes the same netCDF file as the JAX assembler.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from cice5_tpu_torch.io.history import write_coord_grid_vars
from cice5_tpu_torch.parallel.distributed import is_primary
from cice5_tpu_torch.state import State

_MANIFEST = "manifest.json"


def _rank_count() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _tile_entry(x: torch.Tensor, mesh):
    """(host array, [[start, stop] per axis], global shape) of a tile."""
    a = x.detach().cpu().numpy()
    shape = list(a.shape)
    index = [[0, d] for d in a.shape]
    if mesh is not None and a.ndim >= 2:
        rows, cols = mesh.slices()
        shape[-2:] = mesh.global_shape
        index[-2:] = [[rows.start, rows.stop], [cols.start, cols.stop]]
    return a, index, shape


def _write(path: str, entries: dict) -> None:
    """entries: key -> tensor tile; writes ``<key>::0`` and the index."""
    arrays, index = {}, {}
    for key, (a, idx, shape) in entries.items():
        arrays[f"{key}::0"] = a
        index[f"{key}::0"] = idx
        index[f"{key}::shape"] = shape
        index[f"{key}::dtype"] = str(a.dtype)
    np.savez_compressed(path, __index__=json.dumps(index), **arrays)


def _assemble(pattern: str) -> dict:
    """key -> global NumPy array, from every tile of the files."""
    out: dict = {}
    for path in sorted(glob.glob(pattern)):
        with np.load(path, allow_pickle=False) as z:
            index = json.loads(str(z["__index__"]))
            for key in z.files:
                if key == "__index__":
                    continue
                name = key.split("::")[0]
                if name not in out:
                    out[name] = np.zeros(tuple(index[f"{name}::shape"]),
                                         index[f"{name}::dtype"])
                sl = tuple(slice(a, b) for a, b in index[key])
                out[name][sl] = z[key]
    return out


def dump_sharded(state: State, dirpath: str, *, istep: int, time: float,
                 mesh=None, extra: dict | None = None) -> str:
    """Write this rank's tile of every State field to
    <dirpath>/shards.pNNN.npz (and the manifest on the primary). ``mesh``:
    the mesh whose tile ``state`` is (``ShardedModel.mesh``); None for a
    state that holds the whole grid."""
    os.makedirs(dirpath, exist_ok=True)
    rank, nproc = _rank_count()
    path = os.path.join(dirpath, f"shards.p{rank:03d}.npz")
    _write(path, {f.name: _tile_entry(getattr(state, f.name), mesh)
                  for f in dataclasses.fields(state)})
    if is_primary():
        meta = dict(istep=istep, time=time, version=1,
                    num_processes=nproc,
                    fields=[f.name for f in dataclasses.fields(state)],
                    **(extra or {}))
        with open(os.path.join(dirpath, _MANIFEST), "w") as fh:
            json.dump(meta, fh)
    return path


def restore_sharded(dirpath: str) -> tuple[State, dict]:
    """Reassemble the global State (host tensors) from every per-process
    file; ``ShardedModel.put`` takes a rank's tile of it."""
    with open(os.path.join(dirpath, _MANIFEST)) as fh:
        meta = json.load(fh)
    fields = _assemble(os.path.join(dirpath, "shards.p*.npz"))
    return State(**{n: torch.from_numpy(v) for n, v in fields.items()}), meta


def dump_history_sharded(stream, info, dirpath: str, mesh=None) -> str:
    """Write this rank's tiles of every accumulation buffer of one
    HistoryStream (accumulated on the rank's tile) to
    <dirpath>/hist.pNNN.npz (and hist_manifest.json on the primary), with
    no communication, and reset the stream."""
    os.makedirs(dirpath, exist_ok=True)
    rank, nproc = _rank_count()
    path = os.path.join(dirpath, f"hist.p{rank:03d}.npz")
    _write(path, {dims: _tile_entry(buf, mesh)
                  for dims, buf in stream.buf.items()})
    if is_primary():
        meta = dict(
            version=1, nsamples=stream.nsamples, time=info.time,
            year=info.year, month=info.month, mday=info.mday,
            sec=info.sec, suffix=stream.suffix, num_processes=nproc,
            groups={dims: [[f.name, f.units, f.long_name, f.scale,
                            bool(f.instantaneous)] for f in fl]
                    for dims, fl in stream.groups.items()})
        with open(os.path.join(dirpath, "hist_manifest.json"), "w") as fh:
            json.dump(meta, fh)
    stream.reset()
    return path


def assemble_history(dirpath: str, grid, out_path: str,
                     case_name: str = "cice5_tpu") -> str:
    """Merge the per-process history tiles into one classic netCDF-3 file
    with the layout of ``io.history.write_netcdf``; ``grid`` is the
    global grid."""
    from scipy.io import netcdf_file
    with open(os.path.join(dirpath, "hist_manifest.json")) as fh:
        meta = json.load(fh)
    bufs = _assemble(os.path.join(dirpath, "hist.p*.npz"))

    ns = max(meta["nsamples"], 1)
    ny, nx = grid.hm.shape
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with netcdf_file(out_path, "w", version=2) as f:
        f.createDimension("time", None)
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        if any(d in bufs for d in ("3Dc", "4Di", "4Ds")):
            ncat = next(bufs[d].shape[-3] for d in ("3Dc", "4Di", "4Ds")
                        if d in bufs)
            f.createDimension("nc", ncat)
        if "4Di" in bufs:
            f.createDimension("nkice", bufs["4Di"].shape[1])
        if "4Ds" in bufs:
            f.createDimension("nksnow", bufs["4Ds"].shape[1])
        if "3Db" in bufs:
            f.createDimension("nkbio", bufs["3Db"].shape[1])
        tv = f.createVariable("time", "d", ("time",))
        tv.units = "days since 0001-01-01 00:00:00"
        tv[0] = meta["time"] / 86400.0
        write_coord_grid_vars(f, grid)
        dimmap = {"2D": ("time", "nj", "ni"),
                  "3Dc": ("time", "nc", "nj", "ni"),
                  "3Db": ("time", "nkbio", "nj", "ni"),
                  "4Di": ("time", "nkice", "nc", "nj", "ni"),
                  "4Ds": ("time", "nksnow", "nc", "nj", "ni")}
        for dims, fl in meta["groups"].items():
            if dims not in bufs:
                continue
            for k, (name, units, long_name, scale, inst) in enumerate(fl):
                v = f.createVariable(name, "f", dimmap[dims])
                v.units = units
                v.long_name = long_name
                out = bufs[dims][k] if inst else bufs[dims][k] / ns
                v[0] = (out * scale).astype(np.float32)
        f.history = (f"{case_name} history, nsamples={meta['nsamples']}, "
                     f"assembled from {meta['num_processes']} process "
                     f"tile file(s)")
    return out_path
