"""ctypes bridge to the native asynchronous netCDF writer (PyTorch port of
``cice5_tpu/io/fastwriter.py``): the equivalent of the reference's
PIO/parallel-write backends (io_pio/ice_history_write.F90). The caller
hands host arrays to a C++ worker thread and keeps stepping while records
are serialized.

The library is built from the port's copy of the source
(``cice5_tpu_torch/csrc/ncwriter.cpp``) by g++ at first use, into the
kernels' build directory (``ops/kernels.py:build_dir``), and rebuilt when
the source is newer. A failed build raises with the compiler's output;
nothing falls back to a synchronous writer.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from cice5_tpu_torch.ops.kernels import build_dir

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ncwriter.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LIB = None


def build() -> Path:
    """Compile the writer unless its library is newer than the source;
    returns the library's path. The library is written under a temporary
    name and renamed, so a process never loads a half-written one."""
    so = build_dir() / "libncwriter.so"
    if so.exists() and so.stat().st_mtime >= SOURCE.stat().st_mtime:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        p = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name} "
                               f"(exit {p.returncode}):\n{p.stdout}"
                               f"{p.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.ncw_create.restype = ctypes.c_int
        lib.ncw_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p]
        lib.ncw_append.restype = ctypes.c_int
        lib.ncw_append.argtypes = [ctypes.c_int, ctypes.c_double,
                                   ctypes.POINTER(ctypes.c_float)]
        for f in (lib.ncw_flush, lib.ncw_close, lib.ncw_pending):
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


class AsyncNetcdfWriter:
    """Append (time, {name: (ny, nx) array}) records to a netCDF file from
    a background C++ thread. Use as a context manager or call close().
    ``append`` copies the fields into a float32 buffer of its own before
    it returns, so the caller may reuse its arrays at once."""

    def __init__(self, path: str, ny: int, nx: int, varnames):
        self.varnames = tuple(varnames)
        if not self.varnames or any("," in v for v in self.varnames):
            raise ValueError(f"variable names {self.varnames!r}: at least "
                             "one, none with a comma")
        self.ny, self.nx = ny, nx
        self._h = None
        h = _lib().ncw_create(path.encode(), ny, nx, len(self.varnames),
                              ",".join(self.varnames).encode())
        if h < 0:
            raise OSError(f"ncw_create failed ({h}) for {path}")
        self._h = h

    def _handle(self) -> int:
        if self._h is None:
            raise ValueError("the writer is closed")
        return self._h

    def append(self, time: float, fields: dict) -> None:
        h = self._handle()
        buf = np.empty((len(self.varnames), self.ny, self.nx), np.float32)
        for k, name in enumerate(self.varnames):
            buf[k] = np.asarray(fields[name], np.float32)
        rc = _lib().ncw_append(
            h, float(time), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise OSError(f"ncw_append failed ({rc})")

    def pending(self) -> int:
        """Records queued or being written."""
        return _lib().ncw_pending(self._handle())

    def flush(self) -> None:
        """Wait until every appended record is written."""
        rc = _lib().ncw_flush(self._handle())
        if rc != 0:
            raise OSError(f"ncw_flush failed ({rc})")

    def close(self) -> None:
        if self._h is not None:
            rc = _lib().ncw_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"ncw_close failed ({rc})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
