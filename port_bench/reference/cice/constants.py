"""Physical and numerical constants of the PyTorch port.

A copy of ``cice5_tpu/constants.py``: values match the CICE 5.1.2
constants module (drivers/cice/ice_constants.F90:19-100). All constants
are plain Python floats, so they never promote a tensor's dtype.
Field-location / field-type enums mirror ice_constants.F90:163-181 and
drive staggering-aware halo semantics.
"""
from __future__ import annotations

import enum
import math

# --- physical constants (ice_constants.F90:19-58) ---
rhos = 330.0          # density of snow (kg/m^3)
rhoi = 917.0          # density of ice (kg/m^3)
rhow = 1026.0         # density of seawater (kg/m^3)
cp_air = 1005.0       # specific heat of air (J/kg/K)
emissivity = 0.95     # emissivity of snow and ice
cp_ice = 2106.0       # specific heat of fresh ice (J/kg/K)
cp_ocn = 4218.0       # specific heat of ocean / fresh water (J/kg/K)
depressT = 0.054      # freezing-point depression : brine salinity ratio (C/ppt)
dragio = 0.00536      # ice-ocean drag coefficient
albocn = 0.06         # ocean albedo

gravit = 9.80616      # gravitational acceleration (m/s^2)
omega = 7.292e-5      # angular velocity of earth (rad/s)
radius = 6.37e6       # earth radius (m)

secday = 86400.0      # seconds in a calendar day
viscosity_dyn = 1.79e-3  # dynamic viscosity of brine (kg/m/s)
Tocnfrz = -1.8        # freezing temp of seawater (C) used for open water Tsfc
rhofresh = 1000.0     # density of fresh water (kg/m^3)
zvir = 0.606          # rh2o/rair - 1
vonkar = 0.4          # von Karman constant
cp_wv = 1.81e3        # specific heat of water vapor (J/kg/K)
stefan_boltzmann = 567.0e-10  # W/m^2/K^4
Tffresh = 273.15      # freezing temp of fresh water (K)
Lsub = 2.835e6        # latent heat of sublimation, freshwater (J/kg)
Lvap = 2.501e6        # latent heat of vaporization, freshwater (J/kg)
Lfresh = Lsub - Lvap  # latent heat of melting of fresh ice (J/kg)
Timelt = 0.0          # melting temperature, ice top surface (C)
Tsmelt = 0.0          # melting temperature, snow top surface (C)
ice_ref_salinity = 4.0  # ppt
spval_dbl = 1.0e30

iceruf = 0.0005       # ice surface roughness (m)
kappav = 1.4          # visible extinction coefficient in ice (1/m)
kice = 2.03           # thermal conductivity of fresh ice (W/m/K)
kseaice = 2.00        # thermal conductivity of sea ice, 0-layer thermo (W/m/K)
ksno = 0.30           # thermal conductivity of snow (W/m/K)
zref = 10.0           # reference height for stability (m)
hs_min = 1.0e-4       # min snow thickness for computing zTsn (m)
snowpatch = 0.02      # parameter for fractional snow coverage (m)

# albedo spectral weights (ice_constants.F90:84-90)
awtvdr = 0.00318
awtidr = 0.00182
awtvdf = 0.63282
awtidf = 0.36218

# saturation humidity coefficients (ice_constants.F90:92-96)
qqqice = 11637800.0
TTTice = 5897.8
qqqocn = 627572.4
TTTocn = 5107.4

# --- numbers (ice_constants.F90:105-160) ---
puny = 1.0e-11
eps13 = 1.0e-13
eps16 = 1.0e-16
bignum = 1.0e30
pi = math.pi
pih = pi / 2.0
piq = pi / 4.0
pi2 = 2.0 * pi

p001 = 0.001
p01 = 0.01
p1 = 0.1
p15 = 0.15
p2 = 0.2
p25 = 0.25
p333 = 1.0 / 3.0
p4 = 0.4
p5 = 0.5
p6 = 0.6
p666 = 2.0 / 3.0

rad_to_deg = 180.0 / pi
deg_to_rad = pi / 180.0
m2_to_km2 = 1.0e-6
mps_to_cmpdy = 8.64e6

# derived, used pervasively in thermo
Lfresh_rhoi = Lfresh * rhoi
rhow_cpocn = rhow * cp_ocn
hfrazilmin = 0.05     # min thickness of new frazil ice, m (ice_therm_shared.F90:51)


class FieldLoc(enum.IntEnum):
    """Staggered-grid field location (ice_constants.F90:163-172)."""
    NOUPDATE = -1
    UNKNOWN = 0
    CENTER = 1
    NECORNER = 2
    NFACE = 3
    EFACE = 4
    WFACE = 5


class FieldType(enum.IntEnum):
    """Field tensor character for tripole sign flips (ice_constants.F90:175-181)."""
    NOUPDATE = -1
    UNKNOWN = 0
    SCALAR = 1
    VECTOR = 2
    ANGLE = 3
