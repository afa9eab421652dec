"""CICE 5 restart-file interchange, read and write, binary and netCDF
(PyTorch port of ``cice5_tpu/io/restart_v5.py``).

Lets a user of the reference bring ``iced.*`` dumps of a CICE 5.1.2 run
(e.g. the ACCESS/COSIMA production runs) into the port and hand state
back. The files this module writes equal the JAX package's byte for byte
for the same state, and each package reads the other's.

Format (reference sources):
- Core dump (ice_restart_driver.F90:45-190 dumpfile): Fortran sequential
  unformatted big-endian; header record (istep1:i4, time:f8, time_forc:f8)
  then ONE (nx_global, ny_global) f8 record per field in the order
  aicen*ncat, vicen*ncat, vsnon*ncat, Tsfcn*ncat, sice001..*ncat each,
  qice001.., qsno001.., uvel, vvel, [coszen in CESM builds], scale_factor,
  swvdr, swvdf, swidr, swidf, strocnxT, strocnyT, the 12 stress
  components in tripole-pair order (p1,p3,p2,p4 / m1,m3,m2,m4 /
  12_1,12_3,12_2,12_4), iceumask, [sst, frzmlt when oceanmixed_ice].
  Tsfc/sice/qice/qsno are field-major (all categories of one field
  consecutively); the other tracers live in supplemental files.
- Supplemental per-tracer files (io_binary/ice_restart.F90:100-310):
  same header, file name = core name with '.SUFFIX' inserted after the
  ``restart_file`` stem ('iced'): .eap (a11_1,a11_3,a11_2,a11_4,
  a12_1,a12_3,a12_2,a12_4 — ice_dyn_eap.F90 write_restart_eap), .iage
  (ice_age.F90:82), .FY (FY + frz_onset, ice_firstyear.F90:112), .lvl
  (alvl, vlvl), .pond_cesm (apnd, hpnd), .pond_lvl (apnd, hpnd, ipnd,
  fsnow, dhs, ffrac — ice_meltpond_lvl.F90:412), .pond_topo (apnd, hpnd,
  ipnd), .brine (fbrn, first_ice — ice_brine.F90:682), .aero
  (aerosnossl001.. 4 per species — ice_aerosol.F90:636), .bgc
  (bgc_*_sk per enabled tracer + ocean algalN/nit/amm/sil/dmsp/dms —
  ice_algae.F90:1118-1178).
- netCDF flavour (io_netcdf/ice_restart.F90:34-131,223-340): ONE file
  holding core + all tracer variables, dims (ncat, nj, ni)/(nj, ni),
  float64, named exactly as the binary records; istep1/time/time_forc as
  global attributes.

Fields the reference carries but the model derives each step are read
into ``meta`` (swvdr/swvdf/swidr/swidf, pond_lvl's fsnow/dhs/ffrac
refreezing memory, the bgc ocean concentrations) and written as zeros or
as the values given in ``extras``. The dump carries neither ``mlt_onset``
nor the EVP-inert ``a11n``/``a12n`` outside EAP runs.

A core dump holds the base records plus 0, 1, 2 or 3 (coszen, the slab
ocean's sst/frzmlt, or both); any other record count raises, where the
JAX reader would read the records it found with another layout.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cice5_tpu_torch.constants import FieldLoc, FieldType
from cice5_tpu_torch.io.restart import _device, _fseq_records, _np_dtype
from cice5_tpu_torch.parallel import halo as halo_mod
from cice5_tpu_torch.state import State, zeros_state
from cice5_tpu_torch.utils import to_host

# v5 bgc restart names in write order (ice_algae.F90:1118-1178) mapped to
# the registry's bgc short names
_BGC_V5 = [("bgc_N_sk", "N"), ("bgc_C_sk", "C"), ("bgc_chl_sk", "chl"),
           ("bgc_Nit_sk", "NO"), ("bgc_Am_sk", "NH"),
           ("bgc_Sil_sk", "Sil"), ("bgc_DMSPp_sk", "DMSPp"),
           ("bgc_DMSPd_sk", "DMSPd"), ("bgc_DMS_sk", "DMS")]
# ocean concentration records at the tail of the .bgc file, gated on the
# same flags as their tracers (ice_algae.F90:1160-1176)
_BGC_OCN = [("algalN", "N"), ("nit", "NO"), ("amm", "NH"),
            ("sil", "Sil"), ("dmsp", "DMSPp"), ("dms", "DMS")]


def _core_fields(cfg, tr, oceanmixed, coszen=False):
    """(vname, kind) in exact core-dump order; kind 'cat' or '2d'.

    coszen: CESM builds (#ifdef CCSMCOUPLED, ice_restart_driver.F90:128-130)
    insert a coszen record between vvel and scale_factor; ACCESS/AusCOM
    builds do not."""
    out = [("aicen", "cat"), ("vicen", "cat"), ("vsnon", "cat"),
           ("Tsfcn", "cat")]
    out += [(f"sice{k + 1:03d}", "cat") for k in range(cfg.nilyr)]
    out += [(f"qice{k + 1:03d}", "cat") for k in range(cfg.nilyr)]
    out += [(f"qsno{k + 1:03d}", "cat") for k in range(cfg.nslyr)]
    out += [("uvel", "2d"), ("vvel", "2d")]
    if coszen:
        out.append(("coszen", "2d"))
    out += [("scale_factor", "2d"),
            ("swvdr", "2d"), ("swvdf", "2d"), ("swidr", "2d"),
            ("swidf", "2d"), ("strocnxT", "2d"), ("strocnyT", "2d")]
    for stem in ("stressp", "stressm", "stress12"):
        # file order 1,3,2,4 (tripole partner pairs)
        out += [(f"{stem}_{c}", "2d") for c in (1, 3, 2, 4)]
    out.append(("iceumask", "2d"))
    if oceanmixed:
        out += [("sst", "2d"), ("frzmlt", "2d")]
    return out


def _tracer_files(cfg, tr, kdyn=None):
    """[(suffix, [(vname, kind), ...])] for the enabled tracer sets."""
    t = cfg.tracers
    files = []
    if (kdyn if kdyn is not None else cfg.dyn.kdyn) == 2:
        files.append((".eap", [(f"a11_{c}", "2d") for c in (1, 3, 2, 4)]
                      + [(f"a12_{c}", "2d") for c in (1, 3, 2, 4)]))
    if t.tr_iage:
        files.append((".iage", [("iage", "cat")]))
    if t.tr_FY:
        files.append((".FY", [("FY", "cat"), ("frz_onset", "2d")]))
    if t.tr_lvl:
        files.append((".lvl", [("alvl", "cat"), ("vlvl", "cat")]))
    if t.tr_pond_cesm:
        files.append((".pond_cesm", [("apnd", "cat"), ("hpnd", "cat")]))
    if t.tr_pond_lvl:
        files.append((".pond_lvl", [("apnd", "cat"), ("hpnd", "cat"),
                                    ("ipnd", "cat"), ("fsnow", "2d"),
                                    ("dhs", "cat"), ("ffrac", "cat")]))
    if t.tr_pond_topo:
        files.append((".pond_topo", [("apnd", "cat"), ("hpnd", "cat"),
                                     ("ipnd", "cat")]))
    if t.tr_brine:
        files.append((".brine", [("fbrn", "cat"), ("first_ice", "cat")]))
    if t.tr_aero:
        fl = []
        for k in range(t.n_aero):
            s = f"{k + 1:03d}"
            fl += [(f"aerosnossl{s}", "cat"), (f"aerosnoint{s}", "cat"),
                   (f"aeroicessl{s}", "cat"), (f"aeroiceint{s}", "cat")]
        files.append((".aero", fl))
    if t.skl_bgc:
        names = set(tr.bgc_names)
        fl = [(v5, "cat") for v5, nm in _BGC_V5 if nm in names]
        fl += [(v5, "2d") for v5, nm in _BGC_OCN if nm in names]
        files.append((".bgc", fl))
    return files


def _slot_map(tr, cfg):
    """vname -> ('trcrn', slot) | ('state', attr) | ('corner', attr, c)
    | ('meta',) for fields the model does not carry in State."""
    m = {"aicen": ("state", "aicen"), "vicen": ("state", "vicen"),
         "vsnon": ("state", "vsnon"), "uvel": ("state", "uvel"),
         "vvel": ("state", "vvel"),
         "scale_factor": ("state", "scale_factor"),
         "strocnxT": ("state", "strocnxT"),
         "strocnyT": ("state", "strocnyT"),
         "iceumask": ("state", "iceumask"), "sst": ("state", "sst"),
         "frzmlt": ("state", "frzmlt"),
         "frz_onset": ("state", "frz_onset"),
         "first_ice": ("state", "first_ice"),
         "Tsfcn": ("trcrn", tr.nt_Tsfc)}
    for k in range(cfg.nilyr):
        m[f"sice{k + 1:03d}"] = ("trcrn", tr.nt_sice + k)
        m[f"qice{k + 1:03d}"] = ("trcrn", tr.nt_qice + k)
    for k in range(cfg.nslyr):
        m[f"qsno{k + 1:03d}"] = ("trcrn", tr.nt_qsno + k)
    for i, c in enumerate((1, 2, 3, 4)):
        for stem, attr in (("stressp", "stressp"), ("stressm", "stressm"),
                           ("stress12", "stress12"), ("a11", "a11n"),
                           ("a12", "a12n")):
            m[f"{stem}_{c}"] = ("corner", attr, i)
    for nm, slot in (("iage", tr.nt_iage), ("FY", tr.nt_FY),
                     ("alvl", tr.nt_alvl), ("vlvl", tr.nt_vlvl),
                     ("apnd", tr.nt_apnd), ("hpnd", tr.nt_hpnd),
                     ("ipnd", tr.nt_ipnd), ("fbrn", tr.nt_fbri)):
        if slot >= 0:
            m[nm] = ("trcrn", slot)
    for k in range(tr.n_aero):
        s = f"{k + 1:03d}"
        a0 = tr.nt_aero + 4 * k
        m[f"aerosnossl{s}"] = ("trcrn", a0)
        m[f"aerosnoint{s}"] = ("trcrn", a0 + 1)
        m[f"aeroicessl{s}"] = ("trcrn", a0 + 2)
        m[f"aeroiceint{s}"] = ("trcrn", a0 + 3)
    name2slot = dict(zip(tr.bgc_names, tr.nt_bgc))
    for v5, nm in _BGC_V5:
        if nm in name2slot:
            m[v5] = ("trcrn", name2slot[nm])
    for v5, nm in _BGC_OCN:
        m.setdefault(v5, ("meta",))
    for nm in ("swvdr", "swvdf", "swidr", "swidf", "coszen", "fsnow",
               "dhs", "ffrac"):
        m[nm] = ("meta",)
    return m


def tracer_path(core_path: str, suffix: str, stem: str = "iced") -> str:
    """Supplemental-file name: insert suffix after the restart_file stem
    (io_binary/ice_restart.F90:110-118: iced.1997-01-02-00000 ->
    iced.iage.1997-01-02-00000)."""
    d, base = os.path.split(core_path)
    if stem in base:
        base = base.replace(stem, stem + suffix, 1)
    else:
        base = base + suffix
    return os.path.join(d, base)


# ----------------------------------------------------------------------
# binary flavour
# ----------------------------------------------------------------------

def _read_bin_file(path, fields, ny, nx, ncat, sink):
    recs = _fseq_records(path)
    head = next(recs)
    istep = int(np.frombuffer(head, ">i4", 1)[0])
    time, time_forc = np.frombuffer(head, ">f8", 2, 4)
    need = 1 + sum(ncat if kind == "cat" else 1 for _, kind in fields)

    def rd():
        payload = next(recs, None)
        if payload is None:
            raise ValueError(f"{path}: the file ends before its {need} "
                             f"records ({fields[-1][0]} last)")
        a = np.frombuffer(payload, ">f8")
        if a.size == (ny + 2) * (nx + 2):
            # restart_ext=true dump: ghost-inclusive records
            # (ice_read_write.F90:554 ice_read_ext, nghost=1); the
            # interior is authoritative, the model's halo rebuilds ghosts
            return a.reshape(ny + 2, nx + 2)[1:-1, 1:-1]
        if a.size != ny * nx:
            raise ValueError(f"{path}: record size {a.size} != {ny}x{nx}")
        return a.reshape(ny, nx)

    for vname, kind in fields:
        if kind == "cat":
            sink(vname, np.stack([rd() for _ in range(ncat)]))
        else:
            sink(vname, rd())
    return dict(istep=istep, time=float(time), time_forc=float(time_forc))


# restart records whose tripole ghost row is built from a PARTNER field
# (ice_HaloUpdate_stress pairs, ice_dyn_evp.F90:425-445 /
# ice_dyn_eap.F90 write path: _1<->_3, _2<->_4 for each stress/structure
# tensor component)
_HALO_PARTNER = {f"{s}_{a}": f"{s}_{b}"
                 for s in ("stressp", "stressm", "stress12", "a11", "a12")
                 for a, b in ((1, 3), (3, 1), (2, 4), (4, 2))}


def _halo_spec(vname):
    """(FieldLoc, FieldType) a record's ghost ring carries in a reference
    restart_ext dump — the loc/kind the reference's own restart driver
    declares per field (ice_restart_driver.F90:257-400: uvel/vvel
    NEcorner+vector, strocnxT/yT center+vector, everything else
    center+scalar; stress/a11/a12 additionally keep the partner-swapped
    tripole ghosts their last ice_HaloUpdate_stress left behind)."""
    if vname in ("uvel", "vvel"):
        return FieldLoc.NECORNER, FieldType.VECTOR
    if vname in ("strocnxT", "strocnyT"):
        return FieldLoc.CENTER, FieldType.VECTOR
    return FieldLoc.CENTER, FieldType.SCALAR


def _ghost_extend(arr, topo, vname=None, partner=None):
    """One ghost ring for restart_ext records (ice_write_ext,
    ice_read_write.F90:700+). With a Topology the ring is the field's
    halo image (cyclic wrap / tripole fold / land closure via
    parallel.halo, loc/kind from _halo_spec, and the stress corner-partner
    fold when ``partner`` is given on a U-fold); without one, edge
    replication (the ghosts only seed the reading model's halo cells,
    which its first halo update refreshes). The interior is the caller's
    array verbatim: extend()'s degenerate-row symmetrization must not
    rewrite interior data in an export."""
    a = np.asarray(arr, np.float64)
    if topo is None:
        return np.pad(a, 1, mode="edge")
    loc, kind = _halo_spec(vname if vname is not None else "")
    kwargs = {}
    if partner is not None and topo.ns == "tripole":
        # the partner fold is well-posed on non-degenerate staggerings
        # (stress records are CENTER, non-degenerate on the U-fold); on
        # the T-fold CENTER lies ON the fold, so the plain scalar ghost is
        # written (the reader's first stress halo update refreshes it)
        kwargs = dict(fold_partner=torch.from_numpy(
            np.asarray(partner, np.float64)), fold_sign=1.0)
    ext = halo_mod.extend(torch.from_numpy(a), topo, loc=loc, kind=kind,
                          **kwargs).numpy().copy()
    ext[1:-1, 1:-1] = a
    return ext


def _write_record(f, arr):
    payload = np.ascontiguousarray(
        np.asarray(arr, np.float64)).astype(">f8").tobytes()
    marker = np.array([len(payload)], ">i4").tobytes()
    f.write(marker + payload + marker)


def _write_bin_file(path, fields, source, istep, time, time_forc,
                    restart_ext=False, topo=None):
    def rec(f, arr, vname=None, partner=None):
        if restart_ext:
            arr = _ghost_extend(arr, topo, vname=vname, partner=partner)
        _write_record(f, arr)

    with open(path, "wb") as f:
        head = (np.array([istep], ">i4").tobytes()
                + np.array([time, time_forc], ">f8").tobytes())
        marker = np.array([len(head)], ">i4").tobytes()
        f.write(marker + head + marker)
        for vname, kind in fields:
            a = source(vname, kind)
            partner = None
            if restart_ext and vname in _HALO_PARTNER:
                partner = source(_HALO_PARTNER[vname], kind)
            if kind == "cat":
                for n in range(a.shape[0]):
                    rec(f, a[n], vname,
                        None if partner is None else partner[n])
            else:
                rec(f, a, vname, partner)
    return path


def _make_sink(cfg, tr, dtype, device):
    """Returns (sink(vname, arr), finish() -> (State, extra_meta)): the
    records gathered on the host in float64, cast in NumPy and put on
    ``device`` at the end; the fields the files lack keep zeros_state's
    values, in ``dtype`` too (the JAX reader leaves them in the
    configuration's dtype)."""
    cast = _np_dtype(dtype)
    st = zeros_state(cfg, tr, device=device).to(
        device, dtype=torch.from_numpy(np.empty(0, cast)).dtype)
    up: dict = {}
    trcrn = to_host(st.trcrn).astype(np.float64)
    corners: dict = {}
    meta: dict = {}
    smap = _slot_map(tr, cfg)

    def sink(vname, arr):
        kindspec = smap.get(vname, ("meta",))
        if kindspec[0] == "state":
            up[kindspec[1]] = arr
        elif kindspec[0] == "trcrn":
            trcrn[:, kindspec[1]] = arr
        elif kindspec[0] == "corner":
            corners.setdefault(kindspec[1],
                               np.zeros((4,) + arr.shape))[kindspec[2]] = arr
        else:
            meta[vname] = arr

    def finish():
        up["trcrn"] = trcrn
        up.update(corners)
        stf = st.replace(**{k: torch.from_numpy(np.ascontiguousarray(
            np.asarray(v).astype(cast))).to(device) for k, v in up.items()})
        return stf, meta

    return sink, finish


def _count_records(path: str) -> int:
    """Number of Fortran sequential records in a file (marker walk, no
    payload reads)."""
    n = 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        off = 0
        while off + 4 <= size:
            ln = int(np.frombuffer(f.read(4), ">i4", 1)[0])
            f.seek(ln + 4, 1)
            off += 8 + ln
            n += 1
    return n


def core_layout(path: str, cfg, tr) -> tuple[bool, bool]:
    """(coszen, oceanmixed) of a core dump from its record count: the
    base records plus 1 (coszen, ice_restart_driver.F90:128-130), 2 (the
    slab ocean's sst and frzmlt, :179-182) or 3 (both). Any other count
    raises."""
    base = 1 + sum(cfg.ncat if k == "cat" else 1 for _, k in
                   _core_fields(cfg, tr, False, coszen=False))
    extra = _count_records(path) - base
    if extra not in (0, 1, 2, 3):
        raise ValueError(
            f"{path}: {base + extra} records, where a CICE 5 core dump of "
            f"this configuration (ncat={cfg.ncat}, nilyr={cfg.nilyr}, "
            f"nslyr={cfg.nslyr}) holds {base} plus 0 (none), 1 (coszen), 2 "
            f"(sst, frzmlt) or 3 (both)")
    return extra in (1, 3), extra >= 2


def read_restart_v5(path: str, cfg, tr, *, oceanmixed: bool | None = None,
                    dtype=None, stem: str = "iced", device=None):
    """Read a CICE 5 core dump + its supplemental tracer files (those that
    exist) into a State on ``device`` (default the GPU; raises without one
    unless ``device="cpu"``), cast in NumPy to ``dtype`` (default the
    model's). Returns (state, meta); meta carries istep/time/time_forc,
    the restart SW components, and any fields the model derives per step.

    The two build-dependent record sets — oceanmixed_ice's sst/frzmlt
    tail and CCSMCOUPLED's coszen — are read from the record count
    (``core_layout``); ``oceanmixed=False`` skips a dump's sst/frzmlt,
    ``oceanmixed=True`` on a dump without them raises."""
    device = _device(device)
    ny, nx = cfg.grid.ny, cfg.grid.nx
    coszen, has_ocean = core_layout(path, cfg, tr)
    if oceanmixed is None:
        oceanmixed = has_ocean
    elif oceanmixed and not has_ocean:
        raise ValueError(f"{path}: oceanmixed=True, but the dump holds no "
                         "sst/frzmlt records")
    sink, finish = _make_sink(cfg, tr, dtype or cfg.xp_dtype, device)
    meta = _read_bin_file(path,
                          _core_fields(cfg, tr, oceanmixed, coszen=coszen),
                          ny, nx, cfg.ncat, sink)
    for suffix, fields in _tracer_files(cfg, tr):
        tp = tracer_path(path, suffix, stem)
        if os.path.exists(tp):
            _read_bin_file(tp, fields, ny, nx, cfg.ncat, sink)
        else:
            meta.setdefault("missing_files", []).append(tp)
    state, extra = finish()
    meta["version"] = 5
    meta.update(extra)
    return state, meta


def _source(state: State, tr, cfg, extras):
    """source(vname, kind) -> the host float64 array written for vname:
    the State's field or tracer slot, ``extras[vname]``, or zeros."""
    s = {f.name: to_host(getattr(state, f.name))
         for f in dataclasses.fields(state)}
    ncat, ny, nx = s["aicen"].shape
    smap = _slot_map(tr, cfg)
    extras = extras or {}

    def source(vname, kind):
        spec = smap.get(vname, ("meta",))
        if spec[0] == "state":
            return s[spec[1]]
        if spec[0] == "trcrn":
            return s["trcrn"][:, spec[1]]
        if spec[0] == "corner":
            return s[spec[1]][spec[2]]
        if vname in extras:
            return to_host(extras[vname])
        return np.zeros((ncat, ny, nx) if kind == "cat" else (ny, nx))
    return source


def write_restart_v5(state: State, path: str, cfg, tr, *, istep: int,
                     time: float, time_forc: float = 0.0,
                     oceanmixed: bool | None = None,
                     extras: dict | None = None,
                     stem: str = "iced", restart_ext: bool = False,
                     topo=None, coszen: bool = False) -> list[str]:
    """Write a CICE 5 core dump + supplemental tracer files from a State
    (the dumpfile twin of read_restart_v5; hands state back to a CICE
    5.1.2 run). extras may supply swvdr/swvdf/swidr/swidf etc.; anything
    not in State or extras writes zeros. Returns the paths.

    restart_ext=True writes ghost-inclusive (ny+2, nx+2) records (the
    reference's restart_ext namelist flag, io_binary/ice_restart.F90:87,
    ice_read_write.F90 ice_write_ext); pass the model's Topology so the
    ring is the field's halo image (edge replication without one)."""
    if oceanmixed is None:
        oceanmixed = cfg.forcing.oceanmixed_ice
    source = _source(state, tr, cfg, extras)
    paths = [path]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write_bin_file(path, _core_fields(cfg, tr, oceanmixed, coszen=coszen),
                    source, istep, time, time_forc,
                    restart_ext=restart_ext, topo=topo)
    for suffix, fields in _tracer_files(cfg, tr):
        tp = tracer_path(path, suffix, stem)
        _write_bin_file(tp, fields, source, istep, time, time_forc,
                        restart_ext=restart_ext, topo=topo)
        paths.append(tp)
    return paths


# ----------------------------------------------------------------------
# netCDF flavour (io_netcdf/ice_restart.F90: one file, all variables)
# ----------------------------------------------------------------------

def _all_fields(cfg, tr, oceanmixed):
    fields = list(_core_fields(cfg, tr, oceanmixed))
    for _sfx, fl in _tracer_files(cfg, tr):
        fields += fl
    return fields


def read_restart_v5_nc(path: str, cfg, tr, *,
                       oceanmixed: bool | None = None, dtype=None,
                       device=None):
    """Read a CICE 5 netCDF restart (single file, vars named as the
    binary records, dims (ncat, nj, ni)/(nj, ni), global attrs
    istep1/time/time_forc) onto ``device`` (as read_restart_v5)."""
    from scipy.io import netcdf_file
    device = _device(device)
    if oceanmixed is None:
        oceanmixed = cfg.forcing.oceanmixed_ice
    sink, finish = _make_sink(cfg, tr, dtype or cfg.xp_dtype, device)
    with netcdf_file(path, "r", mmap=False) as f:
        meta = dict(
            istep=int(getattr(f, "istep1", 0)),
            time=float(getattr(f, "time", 0.0)),
            time_forc=float(getattr(f, "time_forc", 0.0)), version=5)
        ny, nx = cfg.grid.ny, cfg.grid.nx
        for vname, _kind in _all_fields(cfg, tr, oceanmixed):
            if vname in f.variables:
                a = np.array(f.variables[vname][:])
                if a.shape[-2:] == (ny + 2, nx + 2):
                    a = a[..., 1:-1, 1:-1]   # restart_ext ghost ring
                sink(vname, a)
            else:
                meta.setdefault("missing_vars", []).append(vname)
        # CCSMCOUPLED builds carry coszen (ice_restart_driver.F90:128);
        # the netCDF flavour names it, so it is read when present
        if "coszen" in f.variables:
            sink("coszen", np.array(f.variables["coszen"][:]))
    state, extra = finish()
    meta.update(extra)
    return state, meta


def write_restart_v5_nc(state: State, path: str, cfg, tr, *, istep: int,
                        time: float, time_forc: float = 0.0,
                        oceanmixed: bool | None = None,
                        extras: dict | None = None) -> str:
    """Write the netCDF flavour (io_netcdf/ice_restart.F90:223-340)."""
    from scipy.io import netcdf_file
    if oceanmixed is None:
        oceanmixed = cfg.forcing.oceanmixed_ice
    source = _source(state, tr, cfg, extras)
    ncat, ny, nx = state.aicen.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with netcdf_file(path, "w", version=2) as f:
        f.createDimension("ni", nx)
        f.createDimension("nj", ny)
        f.createDimension("ncat", ncat)
        f.istep1 = np.int32(istep)
        f.time = np.float64(time)
        f.time_forc = np.float64(time_forc)
        for vname, kind in _all_fields(cfg, tr, oceanmixed):
            dims = ("ncat", "nj", "ni") if kind == "cat" else ("nj", "ni")
            v = f.createVariable(vname, "d", dims)
            v[:] = np.asarray(source(vname, kind), np.float64)
    return path
