"""File-driven atmospheric and oceanic forcing (PyTorch port of
``cice5_tpu/forcing_data.py``; reference source/ice_forcing.F90).

The reference's dataset drivers (ncar_data :1837, LY_data :2041,
monthly_data :2824, oned_data :2991, ocn_data_clim :3161) share one
structure: read the records bracketing the current time, interpolate
linearly, then derive the model's forcing fields in ``prepare_forcing``
(:1462-1697: shortwave spectral split, longwave parameterization,
precipitation units, rain/snow partition, wind rotation to the grid).

Records are read and interpolated on the host in float64 NumPy, in the JAX
package's order (``c1*a + c2*b``); ``build_forcing`` casts the raw fields
to the model's dtype in NumPy and copies them to the grid's device in one
transfer, so each raw field equals the JAX package's bit for bit, and
derives the rest there. Every ``Forcing`` it returns has the same fields,
dtypes and device, so a model's step graph is captured once. A missing
or short record file raises (``io/readers.py:read_records``); nothing
falls back to another forcing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.forcing import (Forcing, Tf_from_sss,
                                     longwave_parkinson_washington)
from cice5_tpu_torch.io.readers import (interp_coeff, interp_coeff_monthly,
                                        read_netcdf_field, read_records)
from cice5_tpu_torch.models.radiation.orbital import compute_coszen

# SW spectral fractions (ice_forcing.F90 frcvdr/frcvdf/frcidr/frcidf)
FRCVDR, FRCVDF, FRCIDR, FRCIDF = 0.28, 0.24, 0.31, 0.17


def longwave_rosati_miyakoda(cldf, Tsfc, aice, sst, Qa, Tair, hm):
    """Downward LW, Rosati & Miyakoda 1988 (ice_forcing.F90:1726-1770)."""
    fcc = 1.0 - 0.8 * cldf
    sstk = (Tsfc * aice + sst * (1.0 - aice)) + ct.Tffresh
    rtea = torch.sqrt(1000.0 * Qa / (0.622 + 0.378 * Qa))
    ptem = Tair
    qlwm = ptem ** 3 * (ptem * (0.39 - 0.05 * rtea) * fcc
                        + 4.0 * (sstk - ptem))
    return ct.emissivity * ct.stefan_boltzmann * (sstk ** 4 - qlwm) * hm


def prepare_forcing(*, Tair, fsw, cldf, Qa, rhoa, uatm, vatm, ANGLET, hm,
                    flw=None, fsnow=None, frain=None,
                    Tsfc=None, sst=None, aice=None,
                    atm_data_type="ncar", precip_units="mm_per_month",
                    days_per_year=365, calc_strair=True, zlvl0=10.0):
    """Derive the full atmospheric forcing set from raw dataset fields
    (ice_forcing.F90:1462-1697 prepare_forcing). Returns a dict of fields
    to build a Forcing with."""
    cldf = torch.clamp(cldf, 0.0, 1.0)
    fsw = torch.clamp(fsw, min=0.0)
    Qa = torch.clamp(Qa, min=0.0)
    rhoa = torch.clamp(rhoa, min=0.0)
    if fsnow is None:
        fsnow = torch.zeros_like(Tair)
    fsnow = torch.clamp(fsnow, min=0.0)

    # dataset-specific corrections (:1543-1601)
    if atm_data_type == "ncar":
        Qa = Qa * 0.94
        fsw = fsw * 0.92
        flw = longwave_parkinson_washington(Tair, cldf)
    elif atm_data_type == "LYq":
        if Tsfc is None or sst is None or aice is None:
            raise ValueError("atm_data_type='LYq' needs Tsfc, sst and aice "
                             "(the Rosati-Miyakoda longwave)")
        flw = longwave_rosati_miyakoda(cldf, Tsfc, aice, sst, Qa, Tair, hm)
    elif atm_data_type == "oned" or flw is None:
        flw = longwave_parkinson_washington(Tair, cldf)

    # precip unit conversion to kg/m^2/s (:1608-1616)
    if precip_units == "mm_per_month":
        pf = 12.0 / (86400.0 * days_per_year)
    elif precip_units == "mm_per_day":
        pf = 1.0 / 86400.0
    else:   # mm_per_sec | mks
        pf = 1.0
    fsnow = fsnow * pf

    # rain/snow partition (:1636-1650) unless dataset provides both
    if frain is None:
        warm = Tair >= ct.Tffresh
        frain = torch.where(warm, fsnow, 0.0)
        fsnow = torch.where(warm, 0.0, fsnow)

    out = dict(Tair=Tair, potT=Tair, Qa=Qa, rhoa=rhoa, flw=flw,
               fsnow=fsnow, frain=frain,
               swvdr=fsw * FRCVDR, swvdf=fsw * FRCVDF,
               swidr=fsw * FRCIDR, swidf=fsw * FRCIDF,
               zlvl=torch.full_like(Tair, zlvl0))
    if calc_strair:
        # rotate geographic wind onto the grid (:1653-1677)
        ca, sa = torch.cos(ANGLET), torch.sin(ANGLET)
        out["uatm"] = uatm * ca + vatm * sa
        out["vatm"] = vatm * ca - uatm * sa
    else:
        out["uatm"], out["vatm"] = uatm, vatm
    out["wind"] = torch.sqrt(uatm ** 2 + vatm ** 2)
    return out


def to_device(raw: Mapping, dtype, device) -> dict:
    """Raw fields on ``device`` in ``dtype``: NumPy arrays are cast on the
    host and copied in one transfer; tensors are moved as they are."""
    host = {k: np.asarray(v) for k, v in raw.items()
            if not torch.is_tensor(v)}
    out = {k: v.to(device=device, dtype=dtype) for k, v in raw.items()
           if torch.is_tensor(v)}
    if host:
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        flat = np.concatenate([a.astype(np_dtype).ravel()
                               for a in host.values()])
        dev = torch.from_numpy(flat).to(device)
        for (k, a), part in zip(host.items(),
                                dev.split([a.size for a in host.values()])):
            out[k] = part.view(a.shape)
    return {k: out[k] for k in raw}


def build_forcing(raw, yday, grid, *, dtype=torch.float32, defaults=None,
                  atm_data_type="ncar", precip_units="mks",
                  days_per_year=365, Tsfc=None, sst=None,
                  aice=None, orb=None) -> Forcing:
    """Assemble a full Forcing from raw interpolated dataset fields (NumPy
    arrays or tensors) on the grid's device (the get_forcing_atmo /
    get_forcing_ocn tail, ice_forcing.F90:462-620)."""
    defaults = defaults or {}
    shape, device = grid.shape, grid.hm.device
    raw = to_device(raw, dtype, device)
    f = lambda v: torch.full(shape, float(v), dtype=dtype, device=device)
    get = lambda k, d: raw[k] if k in raw else f(defaults.get(k, d))

    atm = prepare_forcing(
        Tair=get("Tair", 253.0), fsw=get("fsw", 0.0),
        cldf=get("cldf", 0.8), Qa=get("Qa", 0.0002),
        rhoa=get("rhoa", 1.3), uatm=get("uatm", 0.0),
        vatm=get("vatm", 0.0), ANGLET=grid.ANGLET.to(dtype),
        hm=grid.hm.to(dtype), flw=raw.get("flw"), fsnow=raw.get("fsnow"),
        frain=raw.get("frain"), Tsfc=Tsfc, sst=sst, aice=aice,
        atm_data_type=atm_data_type, precip_units=precip_units,
        days_per_year=days_per_year)

    sss = get("sss", 34.0)
    Tf = Tf_from_sss(sss)
    sst_o = get("sst", 0.0) if ("sst" in raw or "sst" in defaults) else Tf
    day = float(int(yday))
    coszen = compute_coszen(
        grid.TLAT, grid.TLON,
        torch.tensor(day, dtype=torch.float64, device=device),
        (yday - day) * 86400.0, orb).to(dtype)
    return Forcing(
        uatm=atm["uatm"], vatm=atm["vatm"], wind=atm["wind"],
        zlvl=atm["zlvl"], potT=atm["potT"], Tair=atm["Tair"],
        Qa=atm["Qa"], rhoa=atm["rhoa"], flw=atm["flw"],
        fsnow=atm["fsnow"], frain=atm["frain"],
        swvdr=atm["swvdr"], swvdf=atm["swvdf"], swidr=atm["swidr"],
        swidf=atm["swidf"], sss=sss, sst=sst_o,
        uocn=get("uocn", 0.0), vocn=get("vocn", 0.0),
        ss_tltx=get("ss_tltx", 0.0), ss_tlty=get("ss_tlty", 0.0),
        frzmlt=get("frzmlt", 0.0), Tf=Tf,
        qdp=get("qdp", 0.0), hmix=get("hmix", 20.0),
        yday=torch.tensor(yday, dtype=dtype, device=device), coszen=coszen)


@dataclasses.dataclass
class MonthlyForcing:
    """Monthly-climatology dataset driver (ice_forcing.F90:2824-2990
    monthly_data + faero_data style mid-month bracketing).

    fields: name -> (12, ny, nx) arrays. Ocean fields (sst, sss, uocn...)
    may be included; anything missing falls back to ``defaults``.
    """
    fields: Mapping[str, np.ndarray]
    days_per_year: int = 365
    atm_data_type: str = "ncar"
    precip_units: str = "mm_per_month"
    defaults: Mapping[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_netcdf(cls, path: str, varnames: Mapping[str, str], **kw):
        """Load 12-record variables from one netCDF file; varnames maps
        forcing name -> file variable name."""
        fields = {name: np.stack([read_netcdf_field(path, v, r)
                                  for r in range(12)])
                  for name, v in varnames.items()}
        return cls(fields=fields, **kw)

    def raw_at(self, yday: float):
        """Time-interpolated raw fields at year-day yday (mid-month
        bracketing, ice_forcing.F90:1296-1341 interp_coeff_monthly)."""
        m1, m2, c1, c2 = interp_coeff_monthly(yday, self.days_per_year)
        return {k: c1 * v[m1] + c2 * v[m2] for k, v in self.fields.items()}

    def forcing_at(self, yday: float, grid, dtype=torch.float32,
                   Tsfc=None, sst=None, aice=None) -> Forcing:
        return build_forcing(self.raw_at(yday), yday, grid, dtype=dtype,
                             defaults=self.defaults,
                             atm_data_type=self.atm_data_type,
                             precip_units=self.precip_units,
                             days_per_year=self.days_per_year,
                             Tsfc=Tsfc, sst=sst, aice=aice)


@dataclasses.dataclass
class RecordForcing:
    """Fixed-interval record dataset driver (the ncar_data/LY_data pattern,
    ice_forcing.F90:1837-2520): fields sampled every ``sec_per_rec``
    seconds through the year (e.g. 6-hourly = 1460 records), linearly
    interpolated between the two bracketing records.

    recslot=1: records valid at the END of their interval (ice_forcing
    default for 6-hourly fluxes); recslot=2: at the middle.
    """
    fields: Mapping[str, np.ndarray]      # name -> (nrec, ny, nx)
    sec_per_rec: float = 21600.0
    recslot: int = 1
    atm_data_type: str = "ncar"
    precip_units: str = "mks"
    days_per_year: int = 365
    defaults: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def raw_at(self, istep: int, dt: float):
        c1, c2 = interp_coeff(istep, dt, self.recslot, self.sec_per_rec)
        nrec = next(iter(self.fields.values())).shape[0]
        tt = istep * dt
        if self.recslot == 1:
            # t1 = floor(tt/sec)*sec is the END of record n1's interval
            n1 = int(tt // self.sec_per_rec) % nrec
        else:
            n1 = int((tt - self.sec_per_rec / 2) // self.sec_per_rec) % nrec
        n2 = (n1 + 1) % nrec
        return {k: c1 * v[n1] + c2 * v[n2] for k, v in self.fields.items()}

    def forcing_at(self, istep: int, dt: float, grid,
                   dtype=torch.float32) -> Forcing:
        yday = (istep * dt / 86400.0) % self.days_per_year + 1.0
        return build_forcing(self.raw_at(istep, dt), yday, grid,
                             dtype=dtype, defaults=self.defaults,
                             atm_data_type=self.atm_data_type,
                             precip_units=self.precip_units,
                             days_per_year=self.days_per_year)


# ---------------------------------------------------------------------------
# File-layout dataset drivers: NCAR bulk + Large-Yeager (CORE) with
# multi-year cycling (ice_forcing.F90: ncar_files :1777, ncar_data :1837,
# LY_files :1990, LY_data :2041, read_data :820, file_year :1434)
# ---------------------------------------------------------------------------

def compute_shortwave(TLON, TLAT, Qa, cldf, hm, sec, yday):
    """AOMIP downward shortwave from cloud fraction/humidity
    (ice_forcing.F90:2255-2317 compute_shortwave)."""
    deg2rad = ct.pi / 180.0
    solar_time = (sec % ct.secday) / 3600.0 + 12.0 * torch.sin(0.5 * TLON)
    hour_angle = (12.0 - solar_time) * ct.pi / 12.0
    declin = 23.44 * math.cos((172.0 - yday) * 2.0 * ct.pi / 365.0) * deg2rad
    cosZ = (torch.sin(TLAT) * math.sin(declin)
            + torch.cos(TLAT) * math.cos(declin) * torch.cos(hour_angle))
    cosZ = torch.clamp(cosZ, min=0.0)
    e = 1.0e5 * Qa / (0.622 + 0.378 * Qa)
    d = (cosZ + 2.7) * e * 1.0e-5 + 1.085 * cosZ + 0.1
    sw0 = torch.clamp(1353.0 * cosZ ** 2 / d, min=0.0)
    return sw0 * (1.0 - 0.6 * cldf ** 3) * hm


def Qa_fix_LY(Tair, Qa):
    """Clamp humidity at ice saturation (ice_forcing.F90:2319-2355
    Qa_fixLY — prevents supersaturation in the CORE data)."""
    w = Tair - ct.Tffresh
    w = 2.0 + (0.7859 + 0.03477 * w) / (1.0 + 0.00412 * w) + 0.00422 * w
    esat = torch.clamp(10.0 ** w, min=ct.puny)   # saturated vapor pressure
    qsat = 0.622 * esat / (1.0e5 - 0.378 * esat)
    return torch.minimum(Qa, qsat)


def file_year(path: str, yr: int) -> str:
    """Swap the 4-digit year before the extension
    (ice_forcing.F90:1434-1458 file_year)."""
    for ext in (".dat", ".nc", ".r"):
        i = path.rfind(ext)
        if i > 4:
            return path[:i - 4] + f"{yr:04d}" + path[i:]
    return path


def ncar_files(data_dir: str, yr: int) -> dict:
    """NCAR bulk dataset layout (ncar_files :1777-1835)."""
    d = data_dir.rstrip("/")
    return {
        "fsw": file_year(f"{d}/ISCCPM/MONTHLY/RADFLX/swdn.1996.dat", yr),
        "cldf": file_year(f"{d}/ISCCPM/MONTHLY/RADFLX/cldf.1996.dat", yr),
        "fsnow": file_year(f"{d}/MXA/MONTHLY/PRECIP/prec.1996.dat", yr),
        "uatm": file_year(f"{d}/NCEP/4XDAILY/STATES/u_10.1996.dat", yr),
        "vatm": file_year(f"{d}/NCEP/4XDAILY/STATES/v_10.1996.dat", yr),
        "Tair": file_year(f"{d}/NCEP/4XDAILY/STATES/t_10.1996.dat", yr),
        "Qa": file_year(f"{d}/NCEP/4XDAILY/STATES/q_10.1996.dat", yr),
        "rhoa": file_year(f"{d}/NCEP/4XDAILY/STATES/dn10.1996.dat", yr),
    }


def ly_files(data_dir: str, yr: int) -> dict:
    """Large-Yeager (CORE) dataset layout (LY_files :1990-2036):
    monthly climatology cloud/precip (no year in the name), 6-hourly
    states per year."""
    d = data_dir.rstrip("/")
    return {
        "cldf": f"{d}/MONTHLY/cldf.omip.dat",
        "fsnow": f"{d}/MONTHLY/prec.nmyr.dat",
        "uatm": file_year(f"{d}/4XDAILY/u_10.1996.dat", yr),
        "vatm": file_year(f"{d}/4XDAILY/v_10.1996.dat", yr),
        "Tair": file_year(f"{d}/4XDAILY/t_10.1996.dat", yr),
        "Qa": file_year(f"{d}/4XDAILY/q_10.1996.dat", yr),
    }


NCAR_MONTHLY = ("fsw", "cldf", "fsnow")
LY_MONTHLY = ("cldf", "fsnow")


def _cycle_years(fyear, yday: float, model_year: int, m1: int, m2: int):
    """The cycle years of the two bracketing months: across the
    December/January seam one of them comes from the previous or the next
    year (read_data :900-960)."""
    y1 = y2 = fyear(model_year)
    if m1 == 11 and m2 == 0:
        if yday < 31:          # early January: Dec of previous year
            y1 = fyear(model_year - 1)
        else:                  # late December: Jan of next year
            y2 = fyear(model_year + 1)
    return y1, y2


class _RecordCache:
    """Records cached by (field, year, record) in ``self._cache``, at most
    64 of them (the reference's oldrecnum pattern,
    ice_forcing.F90:1953-1975), and the cycle year of a model year."""

    def _cached(self, key, read):
        if key not in self._cache:
            self._cache[key] = read()
            if len(self._cache) > 64:
                self._cache.pop(next(iter(self._cache)))
        return self._cache[key]

    def fyear(self, model_year: int) -> int:
        return self.fyear_init + (model_year - self.year_init) % self.ycycle


@dataclasses.dataclass
class FileForcing(_RecordCache):
    """NCAR / Large-Yeager file-tree forcing with multi-year cycling and
    record caching (ncar_data :1837 / LY_data :2041; cycling fyear =
    fyear_init + mod(year - year_init, ycycle) per ice_forcing.F90:402-433;
    record re-reads avoided via the oldrecnum pattern :1953-1975).

    Binary layout: direct-access big-endian float64 records of (ny, nx),
    monthly files with 12 records, 6-hourly files with 4*days_per_year
    records located at the END of their interval (NCEP convention).
    ``yday`` is the day of the year (1..days_per_year), ``sec`` the
    seconds into it: a fractional yday would count ``sec`` twice.
    """
    data_dir: str
    nx: int
    ny: int
    atm_data_type: str = "ncar"        # ncar | LYq
    fyear_init: int = 1997
    ycycle: int = 1
    year_init: int = 1997              # model year of the first cycle year
    days_per_year: int = 365
    precip_units: str = "mm_per_month"
    data_format: str = "bin"
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    def __post_init__(self):
        if self.atm_data_type not in ("ncar", "LYq"):
            raise ValueError(f"atm_data_type={self.atm_data_type!r}: "
                             "'ncar' or 'LYq'")
        self.monthly = (NCAR_MONTHLY if self.atm_data_type == "ncar"
                        else LY_MONTHLY)
        self._files = (ncar_files if self.atm_data_type == "ncar"
                       else ly_files)

    def _read(self, name: str, yr: int, rec: int) -> np.ndarray:
        """One (ny, nx) record, cached by (field, year, record)."""
        path = self._files(self.data_dir, yr)[name]
        return self._cached((name, yr, rec), lambda: read_records(
            path, self.nx * self.ny, rec).reshape(self.ny, self.nx))

    def _monthly_raw(self, yday: float, model_year: int) -> dict:
        m1, m2, c1, c2 = interp_coeff_monthly(yday, self.days_per_year)
        y1, y2 = _cycle_years(self.fyear, yday, model_year, m1, m2)
        # LY climatology files have no year in the name: same file
        return {nm: c1 * self._read(nm, y1, m1) + c2 * self._read(nm, y2, m2)
                for nm in self.monthly}

    def _sixhourly_raw(self, yday: float, sec: float,
                       model_year: int) -> dict:
        sec6 = ct.secday / 4.0
        maxrec = 4 * self.days_per_year
        # record at END of 6h interval (NCEP convention, ncar_data :1925)
        recnum = 4 * int(yday) - 3 + int(sec / sec6)
        n1 = (recnum + maxrec - 2) % maxrec        # 0-based previous
        n2 = (recnum - 1) % maxrec                 # 0-based current
        # interpolation weights: t2 at end of current interval
        tt = ((yday - 1.0) * ct.secday + sec) % (self.days_per_year
                                                 * ct.secday)
        t2 = recnum * sec6
        c2 = min(max((tt - (t2 - sec6)) / sec6, 0.0), 1.0)
        y1 = y2 = self.fyear(model_year)
        if n1 > n2:                                # wrapped the year seam
            y1 = self.fyear(model_year - 1)
        names = [k for k in self._files(self.data_dir, y1)
                 if k not in self.monthly]
        return {nm: (1.0 - c2) * self._read(nm, y1, n1)
                + c2 * self._read(nm, y2, n2) for nm in names}

    def raw_at(self, yday: float, sec: float, model_year: int) -> dict:
        raw = self._monthly_raw(yday, model_year)
        raw.update(self._sixhourly_raw(yday, sec, model_year))
        return raw

    def forcing_at(self, yday: float, sec: float, model_year: int, grid,
                   dtype=torch.float32, Tsfc=None, sst=None,
                   aice=None) -> Forcing:
        raw = to_device(self.raw_at(yday, sec, model_year), dtype,
                        grid.hm.device)
        if self.atm_data_type == "LYq":
            # AOMIP protocol (LY_data :2150-2240): humidity saturation fix,
            # shortwave from clouds, Rosati-Miyakoda longwave (in
            # prepare_forcing via atm_data_type='LYq')
            hm = grid.hm.to(dtype)
            raw["Qa"] = Qa_fix_LY(raw["Tair"], raw["Qa"])
            raw["fsw"] = compute_shortwave(
                grid.TLON.to(dtype), grid.TLAT.to(dtype), raw["Qa"],
                raw["cldf"], hm, sec, yday)
            raw.setdefault("rhoa", torch.full(grid.shape, 1.3, dtype=dtype,
                                              device=grid.hm.device))
        return build_forcing(raw, yday + sec / ct.secday, grid, dtype=dtype,
                             atm_data_type=self.atm_data_type,
                             precip_units=self.precip_units,
                             days_per_year=self.days_per_year,
                             Tsfc=Tsfc, sst=sst, aice=aice)

    def provider(self, model):
        """A ``Model.forcing_provider``: the forcing of each step on the
        model's grid and dtype, from the calendar's day of the year, its
        seconds and its year."""
        def forcing(istep, info):
            return self.forcing_at(float(int(info.yday)), float(info.sec),
                                   info.year, model.grid,
                                   dtype=model.cfg.xp_dtype)
        return forcing


@dataclasses.dataclass
class OcnClimForcing:
    """Monthly ocean climatology driver (ice_forcing.F90:3161-3290
    ocn_data_clim): 12-record binary file(s) of sst/sss (+ optionally
    uocn/vocn/qdp/hmix), mid-month interpolated; pair with
    cfg.forcing.restore_sst for the SST nudging of the reference."""
    files: Mapping[str, str]            # field -> 12-record binary path
    nx: int = 0
    ny: int = 0
    days_per_year: int = 365

    def __post_init__(self):
        n = self.nx * self.ny
        self._fields = {k: read_records(p, n, 0, 12).reshape(
            12, self.ny, self.nx) for k, p in self.files.items()}

    def raw_at(self, yday: float) -> dict:
        m1, m2, c1, c2 = interp_coeff_monthly(yday, self.days_per_year)
        return {k: c1 * v[m1] + c2 * v[m2]
                for k, v in self._fields.items()}


@dataclasses.dataclass
class AeroBgcForcing:
    """Monthly aerosol deposition and ocean BGC concentration forcing
    (faero_data, ice_aerosol.F90:71-163; get_forcing_bgc + ocean nitrate
    climatology, ice_algae.F90:46-130): mid-month bracketed (12, n, ny, nx)
    records attached onto a Forcing via its faero_atm/ocean_bio fields
    (the step falls back to faero_default/default_ocean_bio when absent).
    """
    faero: np.ndarray | None = None       # (12, n_aero, ny, nx) kg/m^2/s
    ocean_bio: np.ndarray | None = None   # (12, nbtrcr, ny, nx) mmol/m^3
    days_per_year: int = 365

    def attach(self, forcing: Forcing, yday: float,
               dtype=torch.float32) -> Forcing:
        m1, m2, c1, c2 = interp_coeff_monthly(yday, self.days_per_year)
        raw = {}
        if self.faero is not None:
            raw["faero_atm"] = c1 * self.faero[m1] + c2 * self.faero[m2]
        if self.ocean_bio is not None:
            raw["ocean_bio"] = (c1 * self.ocean_bio[m1]
                                + c2 * self.ocean_bio[m2])
        if not raw:
            return forcing
        return forcing.replace(**to_device(raw, dtype, forcing.Tair.device))


def hadgem_files(data_dir: str, yr: int) -> dict:
    """HadGEM monthly netCDF layout (hadgem_files,
    ice_forcing.F90:2400-2520); field -> (path, netcdf variable)."""
    d = data_dir.rstrip("/")
    fy = lambda nm: file_year(f"{d}/MONTHLY/{nm}.1996.nc", yr)
    return {
        "frain": (fy("rainfall"), "rainfall"),
        "fsnow": (fy("snowfall"), "snowfall"),
        "uatm": (fy("u_10"), "u_10"),
        "vatm": (fy("v_10"), "v_10"),
        "fsw": (fy("SW_incoming"), "SW_incoming"),
        "flw": (fy("LW_incoming"), "LW_incoming"),
        "Tair": (fy("t_10"), "t_10"),
        "Qa": (fy("q_10"), "q_10"),
        "rhoa": (fy("rho_10"), "rho_10"),
    }


@dataclasses.dataclass
class HadgemForcing(_RecordCache):
    """HadGEM/HadGAM monthly netCDF forcing (hadgem_data,
    ice_forcing.F90:2528-2820): all fields monthly, mid-month bracketed,
    rain+snow provided separately, longwave read directly (no
    parameterization). Multi-year cycling as FileForcing."""
    data_dir: str
    fyear_init: int = 1997
    ycycle: int = 1
    year_init: int = 1997
    days_per_year: int = 365
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    def _read(self, name: str, yr: int, rec: int) -> np.ndarray:
        path, var = hadgem_files(self.data_dir, yr)[name]
        return self._cached((name, yr, rec), lambda: np.asarray(
            read_netcdf_field(path, var, rec), np.float64))

    def raw_at(self, yday: float, model_year: int) -> dict:
        m1, m2, c1, c2 = interp_coeff_monthly(yday, self.days_per_year)
        y1, y2 = _cycle_years(self.fyear, yday, model_year, m1, m2)
        return {nm: c1 * self._read(nm, y1, m1) + c2 * self._read(nm, y2, m2)
                for nm in hadgem_files(self.data_dir, y1)}

    def forcing_at(self, yday: float, model_year: int, grid,
                   dtype=torch.float32) -> Forcing:
        return build_forcing(self.raw_at(yday, model_year), yday, grid,
                             dtype=dtype, atm_data_type="hadgem",
                             precip_units="mks",
                             days_per_year=self.days_per_year)
