"""2-D/3-D field read/write — the ice_read_write.F90 surface (PyTorch port
of ``cice5_tpu/io/xyt.py``).

Equivalents of the reference's ``ice_read_xyt`` (:150) / ``ice_read_xyzt``
(:294) record reads, ``ice_read_global`` (:445), ``ice_read_ext``
(ghost-inclusive, :554), ``ice_write_xyt`` (:690), and their ``_nc``
variants. Files are read on the host into NumPy arrays (the caller puts
them on its device); writes take tensors or arrays and copy them to the
host. Binary records are big-endian Fortran-ordered direct-access records
(the reference's ``ice_read`` unformatted layout); netCDF goes through
scipy (classic format). On a mesh of ranks ``scatter_xyt`` puts a rank's
tile of a field read on the host, and ``gather_xyt`` brings the tiles
back into the global array.
"""
from __future__ import annotations

import numpy as np

import torch

from cice5_tpu_torch.io.readers import read_records
from cice5_tpu_torch.parallel import distributed as pdist
from cice5_tpu_torch.utils import to_host

_DTYPES = {"rda8": ">f8", "rda4": ">f4", "ida4": ">i4"}


def read_xyt(path: str, nx: int, ny: int, nrec: int = 1, *,
             atype: str = "rda8", count: int = 1):
    """Read ``count`` consecutive (ny, nx) records starting at 1-based
    record ``nrec`` from a direct-access binary file
    (ice_read_write.F90:150 ice_read_xyt semantics); a file too short for
    them raises EOFError.

    Returns (ny, nx) for count=1 else (count, ny, nx), native f64/i32."""
    recs = read_records(path, nx * ny, nrec - 1, count,
                        dtype=_DTYPES[atype]).reshape(count, ny, nx)
    recs = recs.astype(np.int32 if atype == "ida4" else np.float64)
    return recs[0] if count == 1 else recs


def read_xyzt(path: str, nx: int, ny: int, nz: int, nrec: int = 1, *,
              atype: str = "rda8"):
    """Read one (nz, ny, nx) record block (ice_read_xyzt, :294)."""
    return read_xyt(path, nx, ny, nrec=1 + (nrec - 1) * nz, atype=atype,
                    count=nz)


def read_global(path: str, nx: int, ny: int, nrec: int = 1, *,
                atype: str = "rda8"):
    """The global-array read (ice_read_global, :445): one device holds
    the whole grid, so global == xyt."""
    return read_xyt(path, nx, ny, nrec, atype=atype)


def read_ext(path: str, nx: int, ny: int, nrec: int = 1, *,
             atype: str = "rda8"):
    """Ghost-inclusive read (ice_read_ext, :554): the file stores
    (ny+2, nx+2) including a 1-cell boundary ring."""
    return read_xyt(path, nx + 2, ny + 2, nrec, atype=atype)


def write_xyt(path: str, fields, *, atype: str = "rda8",
              append: bool = False) -> str:
    """Write (ny, nx) record(s) as big-endian direct-access binary
    (ice_write_xyt, :690). ``fields``: one array or tensor, or a
    sequence of them."""
    arrs = fields if isinstance(fields, (list, tuple)) else [fields]
    dt = np.dtype(_DTYPES[atype])
    with open(path, "ab" if append else "wb") as fh:
        for a in arrs:
            np.ascontiguousarray(to_host(a), dtype=dt).tofile(fh)
    return path


def read_xyt_nc(path: str, varname: str, nrec: int | None = None):
    """netCDF variant (ice_read_nc_xyt): read one 1-based record (or all)
    of a variable; scipy classic netCDF-3."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        data = np.asarray(f.variables[varname][:]).copy()
    if nrec is not None and data.ndim >= 3:
        return data[nrec - 1]
    return data


def write_xyt_nc(path: str, fields: dict, *, dims=("nj", "ni"),
                 attrs: dict | None = None) -> str:
    """netCDF variant of write_xyt: write named (ny, nx) fields (arrays or
    tensors) into one classic netCDF-3 file."""
    from scipy.io import netcdf_file
    host = {k: to_host(v) for k, v in fields.items()}
    with netcdf_file(path, "w", version=2) as f:
        ny, nx = next(iter(host.values())).shape[-2:]
        f.createDimension(dims[0], ny)
        f.createDimension(dims[1], nx)
        for name, arr in host.items():
            v = f.createVariable(name, "d", dims)
            v[:] = np.asarray(arr, np.float64)
            for ak, av in (attrs or {}).get(name, {}).items():
                setattr(v, ak, av)
    return path


def scatter_xyt(arr, mesh=None, device=None) -> torch.Tensor:
    """Host (global) array -> this rank's tile on ``device`` (the whole
    array with no mesh): the master-task scatter_global loop
    (ice_read_write.F90:188-236), with no communication, since every rank
    reads the file."""
    t = torch.as_tensor(np.asarray(arr))
    if mesh is None:
        return t.to(device)
    return pdist.put(t, mesh, device)


def gather_xyt(x, mesh=None) -> np.ndarray:
    """A rank's tile (or a whole-grid tensor with no mesh) -> the global
    host array on every rank: the gather_global analog (:690-758)."""
    return pdist.to_host(x, mesh)
