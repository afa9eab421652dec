"""Restart (checkpoint/resume) with exact round-trip (PyTorch port of
``cice5_tpu/io/restart.py``).

ice_restart_driver.F90 (dumpfile :45, restartfile :191) + the pointer-file
convention (input_templates/gx3/ice_in 'ice.restart_file'). The State is
the field set the reference writes for bit-exact continuation, so a
restart is one compressed npz with one raw array per State field plus the
``__meta__`` JSON (step, time): the JAX package's layout, so either
package reads the other's restarts bit for bit. ``restore`` puts the
state on the GPU and raises without one unless the caller passes
``device="cpu"``, as ``Model`` does.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from cice5_tpu_torch.state import State, zeros_state
from cice5_tpu_torch.utils import to_host as _host

POINTER_NAME = "ice.restart_file"
FINISHED_NAME = "ice.finished"


def _device(device) -> torch.device:
    """The device to restore onto: the GPU unless the caller names one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "restore puts the state on the GPU and no CUDA device is "
                "available; pass device='cpu' to restore it on the CPU")
        device = "cuda"
    return torch.device(device)


def _np_dtype(dtype):
    """A NumPy dtype from a torch dtype, a NumPy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def dump(state: State, path: str, *, istep: int, time: float,
         extra: dict | None = None, pointer_dir: str | None = None) -> str:
    """Write a restart file and update the pointer file."""
    fields = {f.name: _host(getattr(state, f.name))
              for f in dataclasses.fields(state)}
    meta = dict(istep=istep, time=time, version=1, **(extra or {}))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(meta), **fields)
    pdir = pointer_dir or os.path.dirname(os.path.abspath(path))
    with open(os.path.join(pdir, POINTER_NAME), "w") as f:
        f.write(os.path.abspath(path) + ("" if path.endswith(".npz")
                                         else ".npz") + "\n")
    return path


def restore(path: str | None = None, *, pointer_dir: str | None = None,
            dtype=None, device=None) -> tuple[State, dict]:
    """Read a restart (directly or via the pointer file) onto ``device``
    (default the GPU), each array cast to ``dtype`` (a torch or NumPy
    dtype) when one is given. Returns (state, meta)."""
    device = _device(device)
    if path is None:
        with open(os.path.join(pointer_dir, POINTER_NAME)) as f:
            path = f.read().strip()
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    cast = None if dtype is None else _np_dtype(dtype)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {}
        for f in dataclasses.fields(State):
            a = z[f.name]
            arrays[f.name] = torch.from_numpy(
                np.ascontiguousarray(a if cast is None else a.astype(cast))
            ).to(device)
    return State(**arrays), meta


# ----------------------------------------------------------------------
# CICE 4.1 binary restart converter (ice_restart_driver.F90:517-875
# restartfile_v4): reads the v4 Fortran sequential unformatted dump into a
# State so v4 runs can continue under this framework.
# ----------------------------------------------------------------------

def _fseq_records(path: str):
    """Iterate Fortran sequential unformatted records (big-endian length
    markers, the reference's 'ruf8' + -convert big_endian convention)."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + 4 <= len(data):
        n = int(np.frombuffer(data, ">i4", 1, off)[0])
        payload = data[off + 4:off + 4 + n]
        tail = int(np.frombuffer(data, ">i4", 1, off + 4 + n)[0])
        if tail != n:
            raise ValueError(f"corrupt record at offset {off}: {n} != {tail}")
        yield payload
        off += 8 + n


def read_restart_v4(path: str, cfg, tr, *, oceanmixed: bool | None = None,
                    dtype=None, device=None):
    """Read a CICE 4.1 restart dump into a State on ``device`` (default
    the GPU) (restartfile_v4, ice_restart_driver.F90:517: header record
    (istep0, time, time_forc); per category aicen/vicen/vsnon/Tsfc + nilyr
    sice + nilyr qice + nslyr qsno; uvel/vvel; scale_factor + 4 SW
    components; strocnT; the 12 stress components in tripole pair order
    (p1,p3)(p2,p4)(m1,m3)(m2,m4)(12_1,12_3)(12_2,12_4); iceumask; optional
    sst/frzmlt when oceanmixed_ice).

    v4 keeps Tsfc/sice/qice in the main file (v5 moved tracers to their
    own files) and carries no pond/age/level tracers — all other slots
    init to zeros_state defaults (the v4->v5 upgrade semantics).
    Returns (state, meta) with meta holding istep0/time/time_forc and the
    4 restart shortwave components (swvdr/swvdf/swidr/swidf, which this
    framework takes from forcing rather than state).
    """
    device = _device(device)
    ny, nx = cfg.grid.ny, cfg.grid.nx
    nilyr, nslyr, ncat = cfg.nilyr, cfg.nslyr, cfg.ncat
    cast = _np_dtype(cfg.xp_dtype if dtype is None else dtype)
    recs = _fseq_records(path)

    head = next(recs)
    istep0 = int(np.frombuffer(head, ">i4", 1)[0])
    time, time_forc = np.frombuffer(head, ">f8", 2, 4)

    def rd():
        a = np.frombuffer(next(recs), ">f8")
        if a.size != ny * nx:
            raise ValueError(f"record size {a.size} != {ny}x{nx}")
        return a.reshape(ny, nx)   # Fortran (nx,ny) i-fastest == C (ny,nx)

    st = zeros_state(cfg, tr, device=device)
    up = {}
    aicen = np.zeros((ncat, ny, nx))
    vicen = np.zeros((ncat, ny, nx))
    vsnon = np.zeros((ncat, ny, nx))
    trcrn = _host(st.trcrn).astype(np.float64)
    for n in range(ncat):
        aicen[n] = rd()
        vicen[n] = rd()
        vsnon[n] = rd()
        trcrn[n, tr.nt_Tsfc] = rd()
        for k in range(nilyr):
            trcrn[n, tr.nt_sice + k] = rd()
        for k in range(nilyr):
            trcrn[n, tr.nt_qice + k] = rd()
        for k in range(nslyr):
            trcrn[n, tr.nt_qsno + k] = rd()
    up["aicen"], up["vicen"], up["vsnon"], up["trcrn"] = (aicen, vicen,
                                                          vsnon, trcrn)
    up["uvel"] = rd()
    up["vvel"] = rd()
    up["scale_factor"] = rd()
    sw = {k: rd() for k in ("swvdr", "swvdf", "swidr", "swidf")}
    up["strocnxT"] = rd()
    up["strocnyT"] = rd()
    # stress pairs (ice_restart_driver.F90:706-747): file order
    # p1,p3,p2,p4, m1,m3,m2,m4, s1,s3,s2,s4 -> corner slots 0..3=1..4
    for name in ("stressp", "stressm", "stress12"):
        s = np.zeros((4, ny, nx))
        s[0], s[2], s[1], s[3] = rd(), rd(), rd(), rd()
        up[name] = s
    up["iceumask"] = (rd() > 0.5).astype(np.float64)
    if oceanmixed is None:
        oceanmixed = cfg.forcing.oceanmixed_ice
    if oceanmixed:
        up["sst"] = rd()
        up["frzmlt"] = rd()
    st = st.replace(**{k: torch.from_numpy(np.ascontiguousarray(
        v.astype(cast))).to(device) for k, v in up.items()})
    meta = dict(istep=istep0, time=float(time), time_forc=float(time_forc),
                version=4, **{k: v for k, v in sw.items()})
    return st, meta


def write_restart_v4(state: State, path: str, *, istep: int, time: float,
                     time_forc: float = 0.0, nilyr: int, nslyr: int, tr,
                     oceanmixed: bool = False,
                     sw: dict | None = None) -> str:
    """Write a CICE 4.1-format dump (the v4 `dumpfile` twin of
    read_restart_v4) — exercised by the converter round-trip test and
    usable to hand state back to a legacy v4 run."""
    sw = sw or {}

    def rec(f, arr):
        a = np.ascontiguousarray(np.asarray(arr, np.float64))
        payload = a.astype(">f8").tobytes()
        f.write(np.array([len(payload)], ">i4").tobytes())
        f.write(payload)
        f.write(np.array([len(payload)], ">i4").tobytes())

    s = {k: _host(getattr(state, k)) for k in
         ("aicen", "vicen", "vsnon", "trcrn", "uvel", "vvel",
          "scale_factor", "strocnxT", "strocnyT", "stressp", "stressm",
          "stress12", "iceumask", "sst", "frzmlt")}
    ny, nx = s["uvel"].shape
    z = np.zeros((ny, nx))
    with open(path, "wb") as f:
        head = (np.array([istep], ">i4").tobytes()
                + np.array([time, time_forc], ">f8").tobytes())
        f.write(np.array([len(head)], ">i4").tobytes())
        f.write(head)
        f.write(np.array([len(head)], ">i4").tobytes())
        for n in range(s["aicen"].shape[0]):
            rec(f, s["aicen"][n])
            rec(f, s["vicen"][n])
            rec(f, s["vsnon"][n])
            rec(f, s["trcrn"][n, tr.nt_Tsfc])
            for k in range(nilyr):
                rec(f, s["trcrn"][n, tr.nt_sice + k])
            for k in range(nilyr):
                rec(f, s["trcrn"][n, tr.nt_qice + k])
            for k in range(nslyr):
                rec(f, s["trcrn"][n, tr.nt_qsno + k])
        rec(f, s["uvel"])
        rec(f, s["vvel"])
        rec(f, s["scale_factor"])
        for k in ("swvdr", "swvdf", "swidr", "swidf"):
            rec(f, sw.get(k, z))
        rec(f, s["strocnxT"])
        rec(f, s["strocnyT"])
        for name in ("stressp", "stressm", "stress12"):
            for c in (0, 2, 1, 3):
                rec(f, s[name][c])
        rec(f, s["iceumask"])
        if oceanmixed:
            rec(f, s["sst"])
            rec(f, s["frzmlt"])
    return path


def check_finished_file(directory: str) -> bool:
    """True if a completed-run sentinel exists (check_finished_file,
    drivers/cice/CICE_InitMod.F90:322: job scripts resubmit blindly, so a
    finished run leaves 'ice.finished' in the restart dir and later
    submissions abort instead of re-running)."""
    return os.path.exists(os.path.join(directory, FINISHED_NAME))


def writeout_finished_file(directory: str) -> str:
    """Drop the completed-run sentinel (writeout_finished_file,
    drivers/cice/CICE_FinalMod.F90:69)."""
    p = os.path.join(directory, FINISHED_NAME)
    os.makedirs(directory, exist_ok=True)
    with open(p, "w") as f:
        f.write("done\n")
    return p
