"""Ice strength (PyTorch port of ``cice5_tpu/models/dynamics/strength.py``;
ice_mechred.F90 ice_strength :2111): kstrength=0 Hibler (1979),
kstrength=1 Rothrock (1975) from the ridging participation and
redistribution functions of ``ridge.ridge_itd``."""
from __future__ import annotations

import torch

from reference.cice import constants as ct

PSTAR = 2.75e4
CSTAR = 20.0
CF_DEFAULT = 17.0
CP = 0.5 * ct.gravit * (ct.rhow - ct.rhoi) * ct.rhoi / ct.rhow


def strength_hibler(aice, vice, Pstar=PSTAR, Cstar=CSTAR):
    """Hibler (1979): strength = Pstar * vice * exp(-Cstar (1 - aice))."""
    return Pstar * vice * torch.exp(-Cstar * (1.0 - aice))


def strength_rothrock(aicen, vicen, aice0, *, hin_max, krdg_partic,
                      krdg_redist, mu_rdg, Cf=CF_DEFAULT):
    """Rothrock (1975) energy-based strength (ice_mechred.F90:2177-2270):
    P = Cf * Cp * sum_n apartic(n)/aksum * [ -h_n^2 + mean(h_rdg^2) ]."""
    from reference.cice.models.dynamics.ridge import ridge_itd
    r = ridge_itd(aicen, vicen, aice0, krdg_partic=krdg_partic,
                  krdg_redist=krdg_redist, mu_rdg=mu_rdg)
    hi = torch.where(aicen > ct.puny,
                     vicen / torch.clamp(aicen, min=ct.puny), 0.0)
    if krdg_redist == 0:
        h2rdg = (r.hrmin ** 2 + r.hrmin * (r.hrmax - r.hrmin)
                 + (r.hrmax - r.hrmin) ** 2 / 3.0)
    else:
        h2rdg = (r.hrmin ** 2 + 2.0 * r.hrmin * r.hrexp
                 + 2.0 * r.hrexp ** 2)
    dh2rdg = -hi ** 2 + h2rdg / torch.clamp(r.krdg, min=ct.puny)
    contrib = torch.where(aicen > ct.puny, r.apartic * dh2rdg, 0.0)
    strength = CP * contrib.sum(0) / torch.clamp(r.aksum, min=ct.puny)
    return Cf * torch.clamp(strength, min=0.0)
