"""Forcing: atmosphere + ocean inputs for one step (PyTorch port of
``cice5_tpu/forcing.py``).

``Forcing`` carries the same fields as the JAX pytree (the ice_flux.F90
'in from atmos / ocean' groups); ``idealized_polar_forcing`` is the
analytic seasonal forcing the standalone model runs with
(ice_forcing.F90:2991 'oned'/'default' analog, derived fields as in
prepare_forcing :1462).
"""
from __future__ import annotations

import torch

from reference.cice import constants as ct
from reference.cice.utils import tensorclass


@tensorclass
class Forcing:
    """Per-step forcing fields, all (ny, nx) unless noted."""
    # atmosphere
    uatm: torch.Tensor      # wind velocity (m/s)
    vatm: torch.Tensor
    wind: torch.Tensor      # wind speed (m/s)
    zlvl: torch.Tensor      # atm level height (m)
    potT: torch.Tensor      # air potential temperature (K)
    Tair: torch.Tensor      # air temperature (K)
    Qa: torch.Tensor        # specific humidity (kg/kg)
    rhoa: torch.Tensor      # air density (kg/m^3)
    flw: torch.Tensor       # incoming longwave (W/m^2)
    fsnow: torch.Tensor     # snowfall rate (kg/m^2/s)
    frain: torch.Tensor     # rainfall rate (kg/m^2/s)
    swvdr: torch.Tensor     # shortwave components (W/m^2)
    swvdf: torch.Tensor
    swidr: torch.Tensor
    swidf: torch.Tensor
    # ocean
    sss: torch.Tensor       # sea surface salinity (ppt)
    sst: torch.Tensor       # SST used when not prognostic (deg C)
    uocn: torch.Tensor      # ocean current at U points (m/s)
    vocn: torch.Tensor
    ss_tltx: torch.Tensor   # sea surface slope (m/m)
    ss_tlty: torch.Tensor
    frzmlt: torch.Tensor    # freezing/melting potential if externally given
    Tf: torch.Tensor        # freezing temperature (deg C)
    qdp: torch.Tensor       # deep ocean heat flux (W/m^2)
    hmix: torch.Tensor      # mixed layer depth (m)
    yday: torch.Tensor      # fractional day of year (0-d)
    coszen: torch.Tensor    # cosine solar zenith angle
    # the coupler's per-category surface fluxes (ncat, ny, nx) of
    # calc_Tsfc=False
    fsurfn_f: torch.Tensor | None = None
    fcondtopn_f: torch.Tensor | None = None
    flatn_f: torch.Tensor | None = None
    fsensn_f: torch.Tensor | None = None
    # atmospheric aerosol deposition (n_aero, ny, nx), faero_data
    # (ice_aerosol.F90:71); None: the faero_default constants
    faero_atm: torch.Tensor | None = None
    # ocean biogeochemical concentrations (nbtrcr, ny, nx) in the
    # registry's order, get_forcing_bgc (ice_algae.F90:46); None: the
    # default_ocean_bio constants
    ocean_bio: torch.Tensor | None = None


def Tf_from_sss(sss):
    """Freezing temperature: linear liquidus (-depressT*sss)."""
    return -ct.depressT * sss


def sw_partition(fsw):
    """Split total downward SW into 4 components (ice_forcing.F90:1521-1528)."""
    return 0.28 * fsw, 0.24 * fsw, 0.31 * fsw, 0.17 * fsw


def longwave_parkinson_washington(Tair, cldf):
    """Downward LW (ice_forcing.F90:1700-1724): Parkinson & Washington 1979."""
    TK = Tair
    return (ct.stefan_boltzmann * TK ** 4
            * (1.0 - 0.261 * torch.exp(-7.77e-4 * (273.0 - TK) ** 2))
            * (1.0 + 0.275 * cldf))


def idealized_polar_forcing(shape, yday: float, *, Tair_mean=-15.0,
                            Tair_amp=18.0, wind_speed=5.0, cldf=0.8,
                            sss_val=34.0, hmix_val=20.0,
                            dtype=torch.float32, tlat=None, tlon=None,
                            orb=None, device) -> Forcing:
    """Analytic seasonal polar forcing: seasonal air temperature,
    daylight-dependent SW, P&W longwave. With a latitude map (tlat) the
    polar climate blends into a mild +15 C equator with open-water SST
    above freezing, so low latitudes stay ice-free."""
    from reference.cice.models.radiation.orbital import compute_coszen
    f = lambda v: torch.full(shape, v, dtype=dtype, device=device)
    yd = torch.tensor(yday, dtype=dtype, device=device)
    day = torch.floor(yd)
    sec = (yd - day) * 86400.0
    if tlat is not None:
        coszen = compute_coszen(tlat, tlon, day, sec, orb).to(dtype)
    else:
        coszen = f(0.3)
    phase = 2.0 * ct.pi * (yd - 196.0) / 365.0
    if tlat is not None:
        latw = torch.abs(torch.sin(tlat)).to(dtype)
        season = torch.where(tlat >= 0, torch.cos(phase),
                             -torch.cos(phase)).to(dtype)
        TairC = (Tair_mean + Tair_amp * season) * latw \
            + 15.0 * (1.0 - latw)
        sst_open = (1.0 - latw) ** 2 * 24.0
    else:
        season = torch.cos(phase)
        TairC = Tair_mean + Tair_amp * season
        sst_open = 0.0
    Tair = TairC + ct.Tffresh
    fsw = torch.clamp(280.0 * season, min=0.0)
    bc = lambda v: torch.broadcast_to(torch.as_tensor(v, dtype=dtype,
                                                      device=device),
                                      shape).contiguous()
    swvdr, swvdf, swidr, swidf = sw_partition(bc(fsw))
    Qa = 0.0001 + 0.0003 * torch.clamp((TairC + 30.0) / 30.0, min=0.0)
    flw = longwave_parkinson_washington(bc(Tair), cldf)
    sss = f(sss_val)
    # (a where() of two Python numbers would round 3e-6 through float32)
    fsnow = (TairC < 0).to(dtype) * 3.0e-6
    return Forcing(
        uatm=f(wind_speed), vatm=f(0.0), wind=f(wind_speed), zlvl=f(10.0),
        potT=bc(Tair), Tair=bc(Tair), Qa=bc(Qa), rhoa=f(1.3), flw=flw,
        fsnow=bc(fsnow), frain=f(0.0),
        swvdr=swvdr, swvdf=swvdf, swidr=swidr, swidf=swidf,
        sss=sss, sst=bc(Tf_from_sss(sss) + sst_open), uocn=f(0.0),
        vocn=f(0.0), ss_tltx=f(0.0), ss_tlty=f(0.0), frzmlt=f(0.0),
        Tf=Tf_from_sss(sss), qdp=f(0.0), hmix=f(hmix_val),
        yday=yd, coszen=coszen)
