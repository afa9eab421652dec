"""Orbital parameters and solar zenith angle (PyTorch port).

``shr_orb_params`` is a copy of ``cice5_tpu/models/radiation/orbital.py``
(csm_share/shr_orb_mod.F90 shr_orb_params :87-537): the secular-series
summation runs once on the host in plain Python floats.
``shr_orb_decl``, ``solar_declination`` and ``compute_coszen`` port
``cice5_tpu/models/radiation/dedd.py:145-181`` (shr_orb_decl :541-619,
ice_orbital.F90:63-143 compute_coszen) to tensors; they live here because
the rest of the delta-Eddington module belongs to the next slice.

Series coefficients are the published Berger (1978, "A Simple Algorithm to
Compute Long-Term Variations of Daily Insolation", Contribution 18,
Institute of Astronomy and Geophysics, Universite Catholique de Louvain)
amplitude/rate/phase tables: 47 obliquity cosine terms, 19
eccentricity/fvelp cosine-sine terms, 78 moving-vernal-equinox sine terms
(amplitudes & rates in arc seconds, phases in degrees).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference.cice import constants as ct


class OrbitalParams(NamedTuple):
    """What shr_orb_params returns (shr_orb_mod.F90:87-113)."""
    eccen: float    # orbital eccentricity
    obliq: float    # obliquity (degrees)
    mvelp: float    # moving vernal equinox longitude of perihelion (deg)
    obliqr: float   # obliquity (radians)
    lambm0: float   # mean longitude of perihelion at the vernal equinox (rad)
    mvelpp: float   # mvelp + 180 degrees, in radians


# ---- Berger-1978 secular series (data tables; see module docstring) ----

_OBAMP = (
    -2462.2214466, -857.3232075, -629.3231835, -414.2804924, -311.7632587,
    308.9408604, -162.5533601, -116.1077911, 101.1189923, -67.6856209,
    24.9079067, 22.5811241, -21.1648355, -15.6549876, 15.3936813,
    14.6660938, -11.7273029, 10.2742696, 6.4914588, 5.8539148, -5.4872205,
    -5.4290191, 5.160957, 5.0786314, -4.0735782, 3.7227167, 3.3971932,
    -2.8347004, -2.6550721, -2.5717867, -2.4712188, 2.462541, 2.2464112,
    -2.0755511, -1.9713669, -1.8813061, -1.8468785, 1.8186742, 1.7601888,
    -1.5428851, 1.4738838, -1.4593669, 1.4192259, -1.181898, 1.1756474,
    -1.1316126, 1.0896928,
)
_OBRATE = (
    31.609974, 32.620504, 24.172203, 31.983787, 44.828336, 30.973257,
    43.668246, 32.246691, 30.599444, 42.681324, 43.836462, 47.439436,
    63.219948, 64.230478, 1.01053, 7.437771, 55.782177, 0.373813, 13.218362,
    62.583231, 63.593761, 76.43831, 45.815258, 8.448301, 56.792707,
    49.747842, 12.058272, 75.27822, 65.241008, 64.604291, 1.647247,
    7.811584, 12.207832, 63.856665, 56.15599, 77.44884, 6.801054, 62.209418,
    20.656133, 48.344406, 55.14546, 69.000539, 11.07135, 74.291298,
    11.047742, 0.636717, 12.844549,
)
_OBPHAS = (
    251.9025, 280.8325, 128.3057, 292.7252, 15.3747, 263.7951, 308.4258,
    240.0099, 222.9725, 268.7809, 316.7998, 319.6024, 143.805, 172.7351,
    28.93, 123.5968, 20.2082, 40.8226, 123.4722, 155.6977, 184.6277,
    267.2772, 55.0196, 152.5268, 49.1382, 204.6609, 56.5233, 200.3284,
    201.6651, 213.5577, 17.0374, 164.4194, 94.5422, 131.9124, 61.0309,
    296.2073, 135.4894, 114.875, 247.0691, 256.6114, 32.1008, 143.6804,
    16.8784, 160.6835, 27.5932, 348.1074, 82.6496,
)
_ECAMP = (
    0.01860798, 0.01627522, -0.0130066, 0.00988829, -0.003367, 0.00333077,
    -0.002354, 0.00140015, 0.001007, 0.000857, 0.0006499, 0.000599,
    0.000378, -0.000337, 0.000276, 0.000182, -0.000174, -0.000124, 1.25e-05,
)
_ECRATE = (
    4.207205, 7.346091, 17.857263, 17.220546, 16.846733, 5.199079,
    18.231076, 26.216758, 6.359169, 16.210016, 3.065181, 16.583829,
    18.49398, 6.190953, 18.867793, 17.425567, 6.186001, 18.417441, 0.667863,
)
_ECPHAS = (
    28.620089, 193.788772, 308.307024, 320.199637, 279.376984, 87.195,
    349.129677, 128.443387, 154.14388, 291.269597, 114.860583, 332.092251,
    296.414411, 145.76991, 337.237063, 152.092288, 126.839891, 210.667199,
    72.108838,
)
_MVAMP = (
    7391.022589, 2555.1526947, 2022.7629188, -1973.6517951, 1240.2321818,
    953.8679112, -931.7537108, 872.3795383, 606.3544732, -496.0274038,
    456.9608039, 346.946232, -305.8412902, 249.6173246, -199.10272,
    191.0560889, -175.2936572, 165.9068833, 161.1285917, 139.7878093,
    -133.5228399, 117.0673811, 104.6907281, 95.3227476, 86.7824524,
    86.0857729, 70.5893698, -69.9719343, -62.5817473, 61.5450059,
    -57.9364011, 57.1899832, -57.0236109, -54.2119253, 53.2834147,
    52.1223575, -49.0059908, -48.3118757, -45.4191685, -42.235792,
    -34.7971099, 34.4623613, -33.8356643, 33.6689362, -31.2521586,
    -30.8798701, 28.4640769, -27.1960802, 27.0860736, -26.3437456,
    24.725374, 24.6732126, 24.4272733, 24.0127327, 21.7150294, -21.5375347,
    18.1148363, -16.9603104, -16.1765215, 15.5567653, 15.4846529,
    15.2150632, 14.5047426, -14.3873316, 13.1351419, 12.8776311, 11.9867234,
    11.9385578, 11.7030822, 11.6018181, -11.2617293, -10.4664199, 10.433397,
    -10.2377466, 10.1934446, -10.1280191, 10.0289441, -10.0034259,
)
_MVRATE = (
    31.609974, 32.620504, 24.172203, 0.636717, 31.983787, 3.138886,
    30.973257, 44.828336, 0.991874, 0.373813, 43.668246, 32.246691,
    30.599444, 2.147012, 10.511172, 42.681324, 13.650058, 0.986922,
    9.874455, 13.013341, 0.262904, 0.004952, 1.142024, 63.219948, 0.205021,
    2.151964, 64.230478, 43.836462, 47.439436, 1.384343, 7.437771,
    18.829299, 9.500642, 0.431696, 1.16009, 55.782177, 12.639528, 1.155138,
    0.168216, 1.647247, 10.884985, 5.610937, 12.658184, 1.01053, 1.983748,
    14.023871, 0.560178, 1.273434, 12.021467, 62.583231, 63.593761,
    76.43831, 4.28091, 13.218362, 17.818769, 8.359495, 56.792707, 8.448301,
    1.978796, 8.863925, 0.186365, 8.996212, 6.771027, 45.815258, 12.002811,
    75.27822, 65.241008, 18.870667, 22.009553, 64.604291, 11.498094,
    0.578834, 9.237738, 49.747842, 2.147012, 1.196895, 2.133898, 0.173168,
)
_MVPHAS = (
    251.9025, 280.8325, 128.3057, 348.1074, 292.7252, 165.1686, 263.7951,
    15.3747, 58.5749, 40.8226, 308.4258, 240.0099, 222.9725, 106.5937,
    114.5182, 268.7809, 279.6869, 39.6448, 126.4108, 291.5795, 307.2848,
    18.93, 273.7596, 143.805, 191.8927, 125.5237, 172.7351, 316.7998,
    319.6024, 69.7526, 123.5968, 217.6432, 85.5882, 156.2147, 66.9489,
    20.2082, 250.7568, 48.0188, 8.3739, 17.0374, 155.3409, 94.1709, 221.112,
    28.93, 117.1498, 320.5095, 262.3602, 336.2148, 233.0046, 155.6977,
    184.6277, 267.2772, 78.9281, 123.4722, 188.7132, 180.1364, 49.1382,
    152.5268, 98.2198, 97.4808, 221.5376, 168.2438, 161.1199, 55.0196,
    262.6495, 200.3284, 201.6651, 294.6547, 99.8233, 213.5577, 154.1631,
    232.7153, 138.3034, 204.6609, 106.5938, 250.4676, 332.3345, 27.3039,
)


# validity bounds (shr_orb_mod.F90:39-46 SHR_ORB_* parameters)
_ECCEN_MIN, _ECCEN_MAX = 0.0, 0.1
_OBLIQ_MIN, _OBLIQ_MAX = -90.0, 90.0
_MVELP_MIN, _MVELP_MAX = 0.0, 360.0

_PSECDEG = 1.0 / 3600.0       # arc seconds -> degrees
_DEGRAD = math.pi / 180.0


def shr_orb_params(iyear_AD: int | None = 1950, *,
                   eccen: float | None = None,
                   obliq: float | None = None,
                   mvelp: float | None = None) -> OrbitalParams:
    """Earth's orbital parameters for a given year (Berger 1978 secular
    series; shr_orb_mod.F90:87-537).  Either pass iyear_AD (the reference
    standalone default is 1950, ice_orbital.F90:46) to evaluate the series,
    or iyear_AD=None with explicit (eccen, obliq, mvelp) — e.g. the AMIP II
    1995 set (0.016715, 23.4441, 102.7) — mirroring the reference's
    SHR_ORB_UNDEF_INT branch (:336-369)."""
    if iyear_AD is None:
        if eccen is None or obliq is None or mvelp is None:
            raise ValueError(
                "need explicit eccen/obliq/mvelp when iyear_AD is None")
        if not (_ECCEN_MIN <= eccen <= _ECCEN_MAX):
            raise ValueError(f"unreasonable eccen {eccen}")
        if not (_OBLIQ_MIN <= obliq <= _OBLIQ_MAX):
            raise ValueError(f"unreasonable obliq {obliq}")
        if not (_MVELP_MIN <= mvelp <= _MVELP_MAX):
            raise ValueError(f"unreasonable mvelp {mvelp}")
    else:
        if abs(iyear_AD - 1950) > 1_000_000:
            raise ValueError("orbit only valid for years within 1e6 of 1950")
        # series arguments use years AFTER 1950 (future positive)
        years = float(iyear_AD) - 1950.0

        # obliquity: epsilon* + cosine series (degrees)
        obliq = 23.320556 + sum(
            a * _PSECDEG
            * math.cos((r * _PSECDEG * years + p) * _DEGRAD)
            for a, r, p in zip(_OBAMP, _OBRATE, _OBPHAS))

        # eccentricity and fixed vernal equinox long. of perihelion from
        # the cos/sin series pair
        cossum = sum(a * math.cos((r * _PSECDEG * years + p) * _DEGRAD)
                     for a, r, p in zip(_ECAMP, _ECRATE, _ECPHAS))
        sinsum = sum(a * math.sin((r * _PSECDEG * years + p) * _DEGRAD)
                     for a, r, p in zip(_ECAMP, _ECRATE, _ECPHAS))
        eccen = math.hypot(cossum, sinsum)
        # fvelp case ladder (:453-467): atan of the quadrant-resolved ratio,
        # normalized to [0, 2*pi)
        if abs(cossum) <= 1.0e-8:
            fvelp = (0.0 if sinsum == 0.0
                     else (1.5 * math.pi if sinsum < 0.0 else 0.5 * math.pi))
        else:
            fvelp = math.atan2(sinsum, cossum) % (2.0 * math.pi)

        # moving vernal equinox longitude of perihelion (degrees):
        # fvelp + general precession (linear + zeta + sine series)
        mvsum = sum(a * _PSECDEG
                    * math.sin((r * _PSECDEG * years + p) * _DEGRAD)
                    for a, r, p in zip(_MVAMP, _MVRATE, _MVPHAS))
        mvelp = (fvelp / _DEGRAD + 50.439273 * _PSECDEG * years
                 + 3.392506 + mvsum) % 360.0

    eccen2 = eccen * eccen
    eccen3 = eccen2 * eccen
    obliqr = obliq * _DEGRAD
    # +180 deg: observations are geocentric (Berger, Loutre & Tricot 1993
    # App. B) — shr_orb_mod.F90:507-513
    mvelpp = (mvelp + 180.0) * _DEGRAD
    beta = math.sqrt(1.0 - eccen2)
    # mean longitude at the vernal equinox (lambda_m0, radians; :520-526)
    lambm0 = 2.0 * (
        (0.5 * eccen + 0.125 * eccen3) * (1.0 + beta) * math.sin(mvelpp)
        - 0.25 * eccen2 * (0.5 + beta) * math.sin(2.0 * mvelpp)
        + 0.125 * eccen3 * (1.0 / 3.0 + beta) * math.sin(3.0 * mvelpp))
    return OrbitalParams(eccen=eccen, obliq=obliq, mvelp=mvelp,
                         obliqr=obliqr, lambm0=lambm0, mvelpp=mvelpp)


# present-epoch default orbital parameters (csm_share/shr_orb_mod.F90;
# CESM standard set), used when no OrbitalParams are given
ORB_ECCEN = 0.016715      # eccentricity
ORB_OBLIQR = 0.409215     # obliquity (radians)
ORB_LAMBM0 = -0.032437    # mean longitude of perihelion at v.e. (rad)
ORB_MVELPP = 4.937458     # moving vernal equinox long. of perihelion + pi

VE_DAY = 80.5             # calendar day of the vernal equinox (shr_orb)


def shr_orb_decl(calday, eccen=ORB_ECCEN, obliqr=ORB_OBLIQR,
                 lambm0=ORB_LAMBM0, mvelpp=ORB_MVELPP):
    """Solar declination + earth-sun distance factor for an elliptical
    orbit (shr_orb_mod.F90 shr_orb_decl). ``calday`` is a tensor.
    Returns (declin [rad], eccf = (r0/r)^2)."""
    lambm = lambm0 + (calday - VE_DAY) * 2.0 * ct.pi / 365.0
    lmm = lambm - mvelpp
    sinl = torch.sin(lmm)
    lamb = lambm + eccen * (
        2.0 * sinl + eccen * (1.25 * torch.sin(2.0 * lmm)
                              + eccen * ((13.0 / 12.0) * torch.sin(3.0 * lmm)
                                         - 0.25 * sinl)))
    invrho = (1.0 + eccen * torch.cos(lamb - mvelpp)) / (1.0 - eccen ** 2)
    declin = torch.asin(math.sin(obliqr) * torch.sin(lamb))
    return declin, invrho ** 2


def solar_declination(yday, orb=None):
    """Solar declination (radians); orb: optional OrbitalParams for a
    specific year, None for the present-epoch constants."""
    if orb is None:
        return shr_orb_decl(yday)[0]
    return shr_orb_decl(yday, eccen=orb.eccen, obliqr=orb.obliqr,
                        lambm0=orb.lambm0, mvelpp=orb.mvelpp)[0]


def compute_coszen(tlat, tlon, yday, sec, orb=None):
    """Cosine solar zenith angle (ice_orbital.F90:63-143 compute_coszen,
    declination from shr_orb_decl)."""
    delta = solar_declination(yday, orb)
    hour_angle = (sec / ct.secday - 0.5) * 2.0 * ct.pi + tlon
    return (torch.sin(tlat) * torch.sin(delta)
            + torch.cos(tlat) * torch.cos(delta) * torch.cos(hour_angle))
