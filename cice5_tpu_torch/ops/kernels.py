"""Hand-written CUDA kernels: build, load and launch.

Each kernel of ``cice5_tpu_torch/csrc/`` is one ``.cu`` file with a plain C
interface. At first use it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under the build directory (``build/kernels`` at the root
of the checkout, or ``$CICE5_TORCH_BUILD_DIR``) and loaded with ctypes.
Nothing here runs when the module is imported, so the CPU tests import it
on machines without CUDA.

A source may export more than one kernel (``evp_resident.cu`` holds both
EVP kernels, ``remap_tiles.cu`` both remap kernels), and a kernel's source
may have another name than the kernel (``remap_flux_both`` is
``remap_tiles.cu``); a kernel may be built in variants, each with its own
macros and library (kernel C per pair of layer counts); a library is
rebuilt when its source, or a ``csrc/*.cuh`` header the source includes,
is newer than it.

The launch functions take CUDA tensors only: they check device, dtype,
shape and contiguity, allocate their outputs with ``torch.empty``, launch
on ``torch.cuda.current_stream()``, raise if the C function returns a
CUDA error, and add one to their kernel's ``launches`` counter. The
choice between a kernel and its plain PyTorch version is made by the
callers (``evp.evp_sweep``, ``evp_fused.fused_sweep``,
``remap.remap_flux_both``, ``remap.remap_flux_edge``,
``dedd.shortwave_dEdd_ncat``) from the device of the tensors, never by
catching an error.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from cice5_tpu_torch.ops.evp_resident import TilePlan, tile_plan

_SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# --fmad=false: every multiply and add rounds on its own, as in the plain
# PyTorch versions, which run each operation as a separate kernel. The EVP
# start-up from rest amplifies a last-bit difference ~1e4 per subcycle
# (c0 = strength / max(Delta, tinyarea)), so a contracted a*b+c would make
# the kernel and its plain version disagree at the percent level after
# ndte=120 subcycles while both are right.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    d = os.environ.get("CICE5_TORCH_BUILD_DIR")
    return Path(d) if d else Path(__file__).resolve().parents[2] / \
        "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME or NVCC)")


_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    "evp_sweep": [_I] * 6 + [_VP] * 7 + [_I] + [_D] * 8 + [_VP] * 2
    + [_IP, _VP, _VP, _VP],
    "remap_flux_both": [_I, _I, _I, _I, _IP, _IP] + [_VP] * 16,
    "shortwave_dedd": [_I] * 5 + [_VP] * 13 + [_D] * 7 + [_I] + [_VP] * 3,
    "evp_fused": [_I] * 4 + [_VP] * 7 + [_I] + [_D] * 8 + [_VP] * 5
    + [_IP, _VP, _VP, _VP],
    "remap_flux_edge": [_I] * 5 + [_IP, _IP] + [_VP] * 10,
}


class CudaKernel:
    """One kernel, exported as ``<name>_f32``/``<name>_f64`` by the source
    ``csrc/<source>.cu`` (by default ``<name>.cu``): its build, its
    library, and the count of launches made through its wrapper.

    ``defines`` are preprocessor macros of the build (``-D<k>=<v>``); a
    kernel built with some has a library of its own, named after them
    (``variant``)."""

    def __init__(self, name: str, source: str | None = None,
                 defines: dict[str, int] | None = None):
        self.name = name
        self.source = _SRC_DIR / f"{source or name}.cu"
        self.defines = dict(defines or {})
        self.launches = 0
        self.build_log = ""      # ptxas's report of the last build
        self._lib = None
        self._counter = self     # the kernel whose launches this one counts
        self._variants: dict[tuple, CudaKernel] = {}

    def variant(self, **defines: int) -> "CudaKernel":
        """This kernel built with the macros ``defines`` into its own
        library, ``lib<source>_<k><v>...so`` with ``k`` the last part of
        each macro's name in lower case (``DEDD_NI=8, DEDD_NS=3``:
        ``libshortwave_dedd_ni8_ns3.so``). Its launches count on this
        kernel."""
        key = tuple(sorted(defines.items()))
        if key not in self._variants:
            v = CudaKernel(self.name, self.source.stem, dict(key))
            v._counter = self
            self._variants[key] = v
        return self._variants[key]

    def variants(self) -> list["CudaKernel"]:
        """The variants made so far."""
        return list(self._variants.values())

    @property
    def library(self) -> Path:
        tag = "".join(f"_{k.rsplit('_', 1)[-1].lower()}{v}"
                      for k, v in self.defines.items())
        return build_dir() / f"lib{self.source.stem}{tag}.so"

    def build_command(self, out: Path | None = None) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "--resource-usage",
                *(f"-D{k}={v}" for k, v in self.defines.items()), "-o",
                str(out or self.library), str(self.source)]

    def headers(self) -> list[Path]:
        """The ``csrc`` headers the source includes."""
        names = re.findall(r'^#include "([^"]+)"', self.source.read_text(),
                           re.M)
        return [_SRC_DIR / n for n in names]

    def needs_build(self) -> bool:
        lib = self.library
        if not lib.exists():
            return True
        built = lib.stat().st_mtime
        return any(built < f.stat().st_mtime
                   for f in (self.source, *self.headers()))

    def lib(self):
        if self._lib is None:
            with _build_lock():
                if self.needs_build():
                    build_all([self])
            lib = ctypes.CDLL(str(self.library))
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"{self.name}_{dt}")
                fn.argtypes = _ARGTYPES[self.name]
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, dtype: torch.dtype, *args):
        lib = self.lib()
        fn = getattr(lib, f"{self.name}_"
                     + {torch.float32: "f32", torch.float64: "f64"}[dtype])
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream()
                                        .cuda_stream))
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err)
            raise RuntimeError(f"{self.name}: CUDA error {err}: "
                               f"{msg.decode()}")
        self._counter.launches += 1


KERNELS = {k.name: k for k in (
    CudaKernel("evp_sweep", source="evp_resident"),
    CudaKernel("remap_flux_both", source="remap_tiles"),
    CudaKernel("shortwave_dedd"),
    CudaKernel("evp_fused", source="evp_resident"),
    CudaKernel("remap_flux_edge", source="remap_tiles"))}


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory, held while a process
    checks and builds its libraries: several ranks of a mesh on one
    machine load the kernels at once. The lock is a ``flock``, which the
    system drops when its process ends."""
    build_dir().mkdir(parents=True, exist_ok=True)
    with open(build_dir() / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build_all(kernels=None) -> float:
    """Compile every kernel (or the given ones), one nvcc process per
    source, all started together; each library is written under a name of
    this process and renamed into place, so a process that loads it never
    sees a part-written file. Returns the wall seconds taken."""
    ks = list(KERNELS.values()) if kernels is None else list(kernels)
    ks = list({k.library: k for k in ks}.values())    # one build per library
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = {k: k.library.with_name(f"{k.library.name}.{os.getpid()}.tmp")
           for k in ks}
    procs = [(k, subprocess.Popen(k.build_command(tmp[k]),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for k in ks]
    failed = []
    for k, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{k.source.name}:\n{out}")
            tmp[k].unlink(missing_ok=True)
        else:
            os.replace(tmp[k], k.library)
        for other in KERNELS.values():
            for o in (other, *other.variants()):
                if o.library == k.library:
                    o.build_log = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def resource_usage(sources) -> str:
    """ptxas's report (registers, stack, spills) for every kernel of the
    given .cu files, built with NVCC_FLAGS into a scratch library."""
    scratch = build_dir() / "resource_usage.so"
    build_dir().mkdir(parents=True, exist_ok=True)
    out = []
    for src in sources:
        p = subprocess.run([_nvcc(), *NVCC_FLAGS, "--resource-usage", "-o",
                            str(scratch), str(src)], capture_output=True,
                           text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{p.stderr}")
        out.append(f"== {src}\n{p.stdout}{p.stderr}")
    scratch.unlink(missing_ok=True)
    return "".join(out)


def ptxas_entries(log: str) -> list[dict]:
    """The entry functions of a ptxas report (``--resource-usage``): each
    one's mangled name, registers, and the largest stack frame and spill
    bytes of it and the functions it calls (reported with it)."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", part)
        regs = re.search(r"Used (\d+) registers", part)
        out.append(dict(
            name=part.split("'", 1)[0],
            registers=int(regs.group(1)) if regs else -1,
            stack=max((int(f[0]) for f in frames), default=0),
            spill_stores=max((int(f[1]) for f in frames), default=0),
            spill_loads=max((int(f[2]) for f in frames), default=0)))
    return out


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` to the kernels' launch counts: a CUDA graph replay
    launches the kernels its capture recorded (``driver/graph.py``)."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _check(name, t: torch.Tensor, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"CUDA kernels take float32 or float64, not "
                        f"{t.dtype}")
    return t.device, t.dtype


def _check_evp(u, v, stress, maskR, strengthR, gR, uin, cw_plane):
    """Check the inputs of the EVP kernels (see ``evp_sweep``); returns
    (device, dtype, ny, nx)."""
    device, dtype = _cuda_device(u)
    ny, nx = u.shape
    nyr, nxr = ny + 1, nx + 1
    for name, t, shp in (("u", u, (ny, nx)), ("v", v, (ny, nx)),
                         ("stress", stress, (12, nyr, nxr)),
                         ("maskR", maskR, (nyr, nxr)),
                         ("strengthR", strengthR, (nyr, nxr)),
                         ("gR", gR, (10, nyr, nxr)),
                         ("uin", uin, (14 if cw_plane else 13, ny, nx))):
        _check(name, t, shp, dtype, device)
    return device, dtype, ny, nx


def _check_geom(tag, geom, nyr, nxr, dtype, device):
    """Check one edge set's (donor, triarea, qx, qy) of the remap kernels."""
    dn, ta, qx, qy = geom
    _check(f"{tag} donor", dn, (6, nyr, nxr), torch.int32, device)
    _check(f"{tag} triarea", ta, (6, nyr, nxr), dtype, device)
    _check(f"{tag} qx", qx, (6, 3, nyr, nxr), dtype, device)
    _check(f"{tag} qy", qy, (6, 3, nyr, nxr), dtype, device)


def device_limits(device: torch.device) -> tuple[int, int]:
    """(SMs, shared memory bytes a block may opt in to) of a CUDA card,
    read through the EVP kernels' library."""
    return _device_limits(device.index if device.index is not None
                          else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple[int, int]:
    lib = KERNELS["evp_sweep"].lib()
    fn = lib.evp_resident_limits
    fn.argtypes, fn.restype = [_IP, _IP], ctypes.c_int
    n_sm, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = fn(ctypes.byref(n_sm), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"evp_resident_limits: CUDA error {err}: "
                           f"{lib.evp_sweep_error_string(err).decode()}")
    return n_sm.value, smem.value


def evp_barriers(blocks: int, nbar: int, split: bool = True) -> None:
    """Launch ``nbar`` grid barriers, and nothing else, on ``blocks`` blocks
    of 512 threads on the current stream: the EVP kernel's split barrier
    (arrive, then wait at once), or with ``split=False``
    cooperative_groups' ``grid.sync()``. A probe that times a barrier
    alone; it counts no launch of a kernel."""
    lib = KERNELS["evp_sweep"].lib()
    fn = lib.evp_resident_barriers
    fn.argtypes, fn.restype = [_I, _I, _I, _VP, _VP], ctypes.c_int
    sync = torch.zeros(1, dtype=torch.int32, device="cuda")
    err = fn(blocks, nbar, int(split), _ptr(sync),
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"evp_resident_barriers: CUDA error {err}: "
                           f"{lib.evp_sweep_error_string(err).decode()}")


def evp_plan(ny: int, nx: int, dtype: torch.dtype, device: torch.device,
             plan: TilePlan | None = None) -> TilePlan:
    """The EVP kernels' tile plan on this card (``evp_resident.tile_plan``),
    or the caller's, checked against the grid."""
    if plan is None:
        return tile_plan(ny, nx, dtype, *device_limits(device))
    if (plan.ny, plan.nx) != (ny, nx) or plan.itemsize != dtype.itemsize:
        raise ValueError(f"the tile plan is for {plan.ny}x{plan.nx} with "
                         f"{plan.itemsize}-byte values, not {ny}x{nx} "
                         f"{dtype}")
    return plan


def _plan_args(plan: TilePlan, dtype, device):
    """The plan, the scratch and the zeroed barrier counter of one launch
    of the EVP kernel (the caller keeps the tensors until the launch)."""
    return ((ctypes.c_int * 6)(*plan.as_ints()),
            torch.empty(plan.scratch_values(), dtype=dtype, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def evp_sweep(*, ndte: int, cyc_x: bool, cyc_y: bool, u, v, stress, maskR,
              strengthR, gR, uin, cw_plane: bool, Cw: float, p,
              fold: int = 0, plan: TilePlan | None = None):
    """Launch the ``evp_sweep`` entry of csrc/evp_resident.cu: ``ndte`` EVP
    subcycles in one cooperative launch; ``fold`` is the tripole fold of a
    north seam (0 none, 1 the U-fold, 2 the T-fold: ``evp.fold_mode``);
    ``plan`` (default: ``evp_plan``'s) the tiles and branch.

    u, v: (ny, nx); stress: (12, ny+1, nx+1); maskR/strengthR:
    (ny+1, nx+1) (mask as 0/1 floats); gR: (10, ny+1, nx+1) in
    evp.GR_NAMES order; uin: (13 or 14, ny, nx) in evp.U_NAMES order,
    plus the Cw plane when ``cw_plane``. Inputs are not modified. Returns
    (u, v, stress, diagR (5, ny+1, nx+1), strint (2, ny, nx))."""
    device, dtype, ny, nx = _check_evp(u, v, stress, maskR, strengthR, gR,
                                       uin, cw_plane)
    nyr, nxr = ny + 1, nx + 1
    if ndte < 1:
        raise ValueError("evp_sweep needs ndte >= 1")
    if fold not in (0, 1, 2):
        raise ValueError(f"fold={fold!r}: 0 (none), 1 (U-fold) or 2 (T-fold)")
    if fold and ny < 2:
        raise ValueError("the tripole fold needs ny >= 2")
    plan_i, scratch, sync = _plan_args(evp_plan(ny, nx, dtype, device, plan),
                                       dtype, device)
    u_o, v_o, s_o = u.clone(), v.clone(), stress.clone()
    diagR = torch.empty((5, nyr, nxr), dtype=dtype, device=device)
    strint = torch.empty((2, ny, nx), dtype=dtype, device=device)
    KERNELS["evp_sweep"].call(
        dtype, ny, nx, ndte, int(cyc_x), int(cyc_y), int(fold), _ptr(u_o),
        _ptr(v_o), _ptr(s_o), _ptr(maskR), _ptr(strengthR), _ptr(gR),
        _ptr(uin), int(cw_plane), float(Cw), p.arlx1i, p.denom1, p.ecci,
        p.brlx, p.revp, p.cosw, p.sinw, _ptr(diagR), _ptr(strint), plan_i,
        _ptr(scratch), _ptr(sync))
    return u_o, v_o, s_o, diagR, strint


def evp_fused(*, kchunk: int, cyc_x: bool, u, v, stress, maskR, strengthR,
              gR, uin, cw_plane: bool, Cw: float, p,
              plan: TilePlan | None = None):
    """Launch the ``evp_fused`` entry of csrc/evp_resident.cu: one chunk of
    ``kchunk`` EVP subcycles in one cooperative launch, for an open or
    closed north-south boundary (``cyc_x``: cyclic east-west, else open or
    closed).

    Takes what ``evp_sweep`` takes. Inputs are not modified. Returns
    (u, v, stress, diagR (5, ny+1, nx+1), strint (2, ny, nx)), the
    diagnostics of the chunk's last subcycle."""
    device, dtype, ny, nx = _check_evp(u, v, stress, maskR, strengthR, gR,
                                       uin, cw_plane)
    nyr, nxr = ny + 1, nx + 1
    if kchunk < 1:
        raise ValueError("evp_fused needs kchunk >= 1")
    plan_i, scratch, sync = _plan_args(evp_plan(ny, nx, dtype, device, plan),
                                       dtype, device)
    out = (torch.empty((ny, nx), dtype=dtype, device=device),
           torch.empty((ny, nx), dtype=dtype, device=device),
           torch.empty((12, nyr, nxr), dtype=dtype, device=device),
           torch.empty((5, nyr, nxr), dtype=dtype, device=device),
           torch.empty((2, ny, nx), dtype=dtype, device=device))
    KERNELS["evp_fused"].call(
        dtype, ny, nx, kchunk, int(cyc_x), _ptr(u), _ptr(v), _ptr(stress),
        _ptr(maskR), _ptr(strengthR), _ptr(gR), _ptr(uin), int(cw_plane),
        float(Cw), p.arlx1i, p.denom1, p.ecci, p.brlx, p.revp, p.cosw,
        p.sinw, *[_ptr(t) for t in out], plan_i, _ptr(scratch), _ptr(sync))
    return out


def _tracer_table(name, tracer_type, parent):
    ntrace = len(tracer_type)
    if ntrace > 64:
        raise ValueError(f"{name} takes at most 64 tracers")
    for nt in range(ntrace):
        t, q = tracer_type[nt], parent[nt]
        if (t == 2 and tracer_type[q] != 1) or \
                (t == 3 and tracer_type[q] != 2):
            raise ValueError(f"{name}: a type-2 tracer needs a type-1 parent "
                             "and a type-3 tracer a type-2 one")
    return ((ctypes.c_int * ntrace)(*[int(t) for t in tracer_type]),
            (ctypes.c_int * ntrace)(*[int(q) for q in parent]))


def _check_remap(name, mmE2, tmE2, hmE2, tracer_type, parent, ny, nx):
    """Check the fields and the tracer table of the remap kernels; returns
    (device, dtype, ncat, ntrace, the table's ctypes arrays)."""
    device, dtype = _cuda_device(mmE2)
    ncat, ntrace = tmE2.shape[0], tmE2.shape[1]
    _check("mmE2", mmE2, (ncat, ny + 4, nx + 4), dtype, device)
    _check("tmE2", tmE2, (ncat, ntrace, ny + 4, nx + 4), dtype, device)
    _check("hmE2", hmE2, (ny + 4, nx + 4), dtype, device)
    ttype, par = _tracer_table(name, tracer_type, parent)
    keys = [(t, q if t >= 2 else -1) for t, q in zip(tracer_type, parent)]
    if keys != sorted(keys) or any(t >= 2 and not 0 <= q < nt
                                   for nt, (t, q) in enumerate(keys)):
        raise ValueError(f"{name} takes a class-sorted stack, parents "
                         "first (remap.tracer_table)")
    return device, dtype, ncat, ntrace, ttype, par


def remap_flux_both(*, mmE2, tmE2, hmE2, geomN, geomE, tracer_type, parent,
                    ny: int, nx: int):
    """Launch csrc/remap_tiles.cu: reconstruction + transport integrals of
    both edge sets, all categories, in one launch (the grid and shared
    memory of ``remap_tiles.plan``; no reconstruction scratch).

    mmE2: (ncat, ny+4, nx+4); tmE2: (ncat, ntrace, ny+4, nx+4); hmE2:
    (ny+4, nx+4); geomN/geomE: (donor int32 (6, nyr, nxr), triarea
    (6, nyr, nxr), qx, qy (6, 3, nyr, nxr)) for the north (ny+1, nx) and
    east (ny, nx+1) edges. Returns (fn_mflx, fn_mtflx, fe_mflx,
    fe_mtflx)."""
    device, dtype, ncat, ntrace, ttype, par = _check_remap(
        "remap_flux_both", mmE2, tmE2, hmE2, tracer_type, parent, ny, nx)
    _check_geom("north", geomN, ny + 1, nx, dtype, device)
    _check_geom("east", geomE, ny, nx + 1, dtype, device)
    out = (torch.empty((ncat, ny + 1, nx), dtype=dtype, device=device),
           torch.empty((ncat, ntrace, ny + 1, nx), dtype=dtype,
                       device=device),
           torch.empty((ncat, ny, nx + 1), dtype=dtype, device=device),
           torch.empty((ncat, ntrace, ny, nx + 1), dtype=dtype,
                       device=device))
    KERNELS["remap_flux_both"].call(
        dtype, ncat, ntrace, ny, nx, ttype, par, _ptr(mmE2), _ptr(tmE2),
        _ptr(hmE2), *[_ptr(t) for t in geomN], *[_ptr(t) for t in geomE],
        *[_ptr(t) for t in out])
    return out


def remap_flux_edge(*, edge: str, mmE2, tmE2, hmE2, geom, tracer_type,
                    parent, ny: int, nx: int):
    """Launch the one-edge mode of csrc/remap_tiles.cu (entry
    ``remap_flux_edge``): reconstruction + transport integrals of ONE edge
    set (``edge`` "north": (ny+1, nx) edges; "east": (ny, nx+1)), all
    categories, in one launch on ``remap_flux_both``'s grid. Takes what
    ``remap_flux_both`` takes with one geometry set; its fluxes equal that
    set's half of ``remap_flux_both`` bit for bit. Returns (mflx
    (ncat, nyr, nxr), mtflx (ncat, ntrace, nyr, nxr))."""
    if edge not in ("north", "east"):
        raise ValueError(f"edge must be 'north' or 'east', not {edge!r}")
    device, dtype, ncat, ntrace, ttype, par = _check_remap(
        "remap_flux_edge", mmE2, tmE2, hmE2, tracer_type, parent, ny, nx)
    nyr, nxr = (ny + 1, nx) if edge == "north" else (ny, nx + 1)
    _check_geom(edge, geom, nyr, nxr, dtype, device)
    out = (torch.empty((ncat, nyr, nxr), dtype=dtype, device=device),
           torch.empty((ncat, ntrace, nyr, nxr), dtype=dtype, device=device))
    KERNELS["remap_flux_edge"].call(
        dtype, int(edge == "east"), ncat, ntrace, ny, nx, ttype, par,
        _ptr(mmE2), _ptr(tmE2), _ptr(hmE2), *[_ptr(t) for t in geom],
        *[_ptr(t) for t in out])
    return out


# kernel C's block (csrc/shortwave_dedd.cu): NT threads, the NTABV doubles
# of dedd.kernel_tables and one slot of lane_values<NI, NS>() per thread
DEDD_THREADS, DEDD_TABLE_VALUES = 128, 678
DEDD_DEFAULT_LAYERS = ((4, 1), (7, 1))


def dedd_lane_values(nilyr: int, nslyr: int) -> int:
    """Values of one lane's slot of kernel C: the adding arrays (6 x
    (klev+2)) and the outputs (11 + nslyr + 2 nilyr + 1)."""
    return 6 * (nslyr + nilyr + 3) + 11 + nslyr + 2 * nilyr + 1


def dedd_smem_bytes(nilyr: int, nslyr: int, itemsize: int,
                    smem_optin: int | None = None) -> int:
    """Shared memory of one block of kernel C for these layer counts and
    value size; raises where it exceeds ``smem_optin``, the bytes a block
    may use on the card."""
    smem = DEDD_TABLE_VALUES * 8 + \
        dedd_lane_values(nilyr, nslyr) * DEDD_THREADS * itemsize
    if smem_optin is not None and smem > smem_optin:
        raise ValueError(
            f"shortwave_dedd at nilyr={nilyr}, nslyr={nslyr} with "
            f"{itemsize}-byte values needs {smem} B of shared memory per "
            f"block (the table and {DEDD_THREADS} lanes of "
            f"{dedd_lane_values(nilyr, nslyr)} values), more than the "
            f"{smem_optin} B a block may use on this card")
    return smem


def dedd_kernel(nilyr: int, nslyr: int) -> CudaKernel:
    """Kernel C for these layer counts: the default library for (4, 1) and
    (7, 1), else the pair's own (``-DDEDD_NI=nilyr -DDEDD_NS=nslyr``,
    ``libshortwave_dedd_ni<nilyr>_ns<nslyr>.so``, built at first use)."""
    if nilyr < 1 or nslyr < 1:
        raise ValueError(f"shortwave_dedd needs nilyr >= 1 and nslyr >= 1, "
                         f"not nilyr={nilyr}, nslyr={nslyr}")
    base = KERNELS["shortwave_dedd"]
    if (nilyr, nslyr) in DEDD_DEFAULT_LAYERS:
        return base
    return base.variant(DEDD_NI=int(nilyr), DEDD_NS=int(nslyr))


def dedd_blocks_per_sm(nilyr: int, nslyr: int, dtype: torch.dtype) -> int:
    """Resident blocks per SM of kernel C for these layer counts and dtype
    on the current card (its cooperative grid is that times the SMs)."""
    lib = dedd_kernel(nilyr, nslyr).lib()
    fn = lib.shortwave_dedd_blocks_per_sm
    fn.argtypes, fn.restype = [_I, _I, _I, _IP], ctypes.c_int
    blocks = ctypes.c_int()
    err = fn(nilyr, nslyr, int(dtype == torch.float64), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"shortwave_dedd_blocks_per_sm: CUDA error {err}: "
                           f"{lib.shortwave_dedd_error_string(err).decode()}")
    return blocks.value


def shortwave_dedd(*, nilyr: int, nslyr: int, aicen, vicen, vsnon, Tsfcn,
                   apnd, hpnd, coszen, fnidr, swvdr, swvdf, swidr, swidf,
                   R_ice=0.0, R_pnd=0.0, R_snw=1.5, dT_mlt=1.5,
                   rsnw_mlt=1500.0, kalg=0.6, hs0=0.03, hs1=0.03,
                   pndaspect=0.8, pond_scheme="cesm"):
    """Launch csrc/shortwave_dedd.cu (built for this ``(nilyr, nslyr)``,
    ``dedd_kernel``; a pair whose block exceeds the card's shared memory is
    refused): the delta-Eddington column of every
    (category, cell), one cooperative launch (a scan that zero-fills the
    unlit columns and lists the lit ones, then the lit columns in groups of
    ten from the list). aicen..hpnd: (ncat, ny, nx); the forcing planes
    (ny, nx). Returns the 14 planes of dedd.DEddResult, category axis
    first (Sswabsn (ncat, nslyr, ny, nx), Iswabsn (ncat, nilyr, ...),
    fswpenln (ncat, nilyr+1, ...)): views of one output tensor."""
    import numpy as np
    from cice5_tpu_torch.models.radiation import dedd
    device, dtype = _cuda_device(aicen)
    ncat, ny, nx = aicen.shape
    kernel = dedd_kernel(nilyr, nslyr)
    dedd_smem_bytes(nilyr, nslyr, dtype.itemsize, device_limits(device)[1])
    cat = dict(aicen=aicen, vicen=vicen, vsnon=vsnon, Tsfcn=Tsfcn,
               apnd=apnd, hpnd=hpnd)
    frc = dict(coszen=coszen, fnidr=fnidr, swvdr=swvdr, swvdf=swvdf,
               swidr=swidr, swidf=swidf)
    for name, t in cat.items():
        _check(name, t, (ncat, ny, nx), dtype, device)
    for name, t in frc.items():
        _check(name, t, (ny, nx), dtype, device)
    tab = dedd.kernel_tables(R_ice, R_pnd, device)
    rsnw_nm = float(np.clip(500.0 - R_snw * 250.0, 100.0, rsnw_mlt))
    nout = 11 + nslyr + 2 * nilyr + 1
    out = torch.empty((ncat, nout, ny, nx), dtype=dtype, device=device)
    # the kernel's four counters (zeroed by the kernel's entry on the
    # stream) and its list of lit columns
    work = torch.empty(4 + ncat * ny * nx, dtype=torch.int32, device=device)
    kernel.call(
        dtype, ncat, ny, nx, nilyr, nslyr,
        *[_ptr(t) for t in cat.values()], *[_ptr(t) for t in frc.values()],
        _ptr(tab), rsnw_nm, float(rsnw_mlt), float(dT_mlt), float(kalg),
        float(hs0), float(hs1), float(pndaspect),
        dedd.POND_SCHEMES.index(pond_scheme), _ptr(out), _ptr(work))
    o = 7
    planes = [out[:, k] for k in range(o)]
    planes.append(out[:, o:o + nslyr])
    o += nslyr
    planes.append(out[:, o:o + nilyr])
    o += nilyr
    planes.append(out[:, o:o + nilyr + 1])
    o += nilyr + 1
    planes += [out[:, k] for k in range(o, o + 4)]
    return tuple(planes)


if __name__ == "__main__":
    # python -m cice5_tpu_torch.ops.kernels [file.cu ...]: ptxas's resource
    # report for the given sources (default: every kernel of the port)
    import sys
    print(resource_usage(sys.argv[1:] or sorted({k.source for k in
                                                 KERNELS.values()})))
