"""The benchmark's one traffic generator: the atmosphere and ocean a cell
drives the sea ice with, made from ``--seed`` and a traffic file's
parameters.

The base is a frozen copy of the port's analytic polar forcing
(``forcing.idealized_polar_forcing``: a seasonal air temperature, sunlight
and Parkinson-Washington longwave, blending into a mild ice-free
equator). Over it lie synoptic anomalies of the wind and the air
temperature. Model day ``d`` starts with pattern ``d %
anomaly_library_days`` of a library drawn once from
``anomaly_library_seed``: a coarse field of standard normal values,
periodic in longitude, bilinearly spread over the grid and scaled by the
traffic file; within the day the anomaly moves linearly to the next
day's pattern. The run's seed draws a zonal offset by which every
pattern is rolled. The grid, the land and the base forcing do not vary
with longitude (the sun's hour angle and the tripole fold aside), so
every seed drives the same weather, in another place, and the same work.
Precipitation falls as snow below 0 C and, with ``rain_when_warm``, as
rain above it.
"""
from __future__ import annotations

import torch

from reference.cice import constants as ct
from reference.cice.forcing import (Tf_from_sss,
                                    longwave_parkinson_washington,
                                    sw_partition)
from reference.cice.models.radiation.orbital import compute_coszen

def day_seed(seed: int, day: int) -> int:
    return (int(seed) * 1_000_003 + int(day)) % (2 ** 63)


class ForcingGen:
    """Forcing of any step of a run: ``fields(istep)`` is a dict of
    tensors on ``device`` in ``dtype`` named as the model's Forcing
    fields. ``grid`` gives TLAT and TLON (radians), ``yday(istep)`` the
    fractional day of the year, ``orb`` the orbital parameters."""

    def __init__(self, params: dict, seed: int, *, grid, yday, orb,
                 steps_per_day: int, dtype, device):
        self.p = params
        self.seed = int(seed)
        self.tlat, self.tlon = grid.TLAT, grid.TLON
        self.shape = tuple(grid.TLAT.shape)
        self.yday, self.orb = yday, orb
        self.steps_per_day = steps_per_day
        self.dtype, self.device = dtype, torch.device(device)
        self._days = {}
        gen = torch.Generator().manual_seed(day_seed(self.seed, 0))
        self.offset = int(torch.randint(self.shape[1], (1,),
                                        generator=gen))

    def _day_field(self, day: int) -> torch.Tensor:
        """(3, ny, nx): the u-wind, v-wind and air-temperature anomalies
        of the start of ``day``, in units of their amplitudes."""
        if day not in self._days:
            gy, gx = self.p["anomaly_cells"]
            ny, nx = self.shape
            gen = torch.Generator(device=self.device)
            pattern = day % self.p["anomaly_library_days"]
            gen.manual_seed(day_seed(self.p["anomaly_library_seed"],
                                     pattern))
            coarse = torch.randn((1, 3, gy, gx), generator=gen,
                                 device=self.device, dtype=torch.float32)
            # periodic in longitude: the first coarse column again at 360E
            coarse = torch.cat([coarse, coarse[..., :1]], dim=-1)
            fine = torch.nn.functional.interpolate(
                coarse, size=(ny, nx + 1), mode="bilinear",
                align_corners=True)[0, :, :, :nx]
            fine = torch.roll(fine, self.offset, dims=-1)
            self._days = {d: v for d, v in self._days.items()
                          if d >= day - 1}
            self._days[day] = fine.to(self.dtype)
        return self._days[day]

    def anomaly(self, istep: int) -> torch.Tensor:
        day, hour = divmod(istep, self.steps_per_day)
        w = hour / self.steps_per_day
        return (1.0 - w) * self._day_field(day) + w * self._day_field(day + 1)

    def fields(self, istep: int) -> dict:
        p, dtype, device, shape = self.p, self.dtype, self.device, self.shape
        an = self.anomaly(istep)
        f = lambda v: torch.full(shape, v, dtype=dtype, device=device)
        yd = torch.tensor(self.yday(istep), dtype=dtype, device=device)
        day = torch.floor(yd)
        sec = (yd - day) * 86400.0
        coszen = compute_coszen(self.tlat, self.tlon, day, sec,
                                self.orb).to(dtype)
        phase = 2.0 * ct.pi * (yd - 196.0) / 365.0
        latw = torch.abs(torch.sin(self.tlat)).to(dtype)
        season = torch.where(self.tlat >= 0, torch.cos(phase),
                             -torch.cos(phase)).to(dtype)
        TairC = (p["Tair_mean_C"] + p["Tair_amp_C"] * season) * latw \
            + 15.0 * (1.0 - latw) + p["Tair_anomaly_C"] * an[2]
        sst_open = (1.0 - latw) ** 2 * 24.0
        Tair = TairC + ct.Tffresh
        fsw = torch.clamp(280.0 * season, min=0.0)
        swvdr, swvdf, swidr, swidf = sw_partition(fsw)
        Qa = 0.0001 + 0.0003 * torch.clamp((TairC + 30.0) / 30.0, min=0.0)
        flw = longwave_parkinson_washington(Tair, p["cloud_fraction"])
        sss = f(p["sss"])
        cold = (TairC < 0).to(dtype)
        fsnow = cold * p["precip_kg_m2_s"]
        frain = (1.0 - cold) * p["precip_kg_m2_s"] if p["rain_when_warm"] \
            else f(0.0)
        uatm = p["wind_ms"] + p["wind_anomaly_ms"] * an[0]
        vatm = p["wind_anomaly_ms"] * an[1]
        return dict(
            uatm=uatm, vatm=vatm, wind=torch.sqrt(uatm * uatm + vatm * vatm),
            zlvl=f(10.0), potT=Tair, Tair=Tair, Qa=Qa, rhoa=f(1.3),
            flw=flw, fsnow=fsnow, frain=frain, swvdr=swvdr, swvdf=swvdf,
            swidr=swidr, swidf=swidf, sss=sss,
            sst=Tf_from_sss(sss) + sst_open, uocn=f(0.0), vocn=f(0.0),
            ss_tltx=f(0.0), ss_tlty=f(0.0), frzmlt=f(0.0),
            Tf=Tf_from_sss(sss), qdp=f(0.0), hmix=f(p["hmix_m"]),
            yday=yd, coszen=coszen)
