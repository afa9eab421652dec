"""Simple passive tracers: ice age and first-year ice area (PyTorch port
of ``cice5_tpu/models/tracers/simple.py``; ice_age.F90 increment_age :45,
ice_firstyear.F90 update_FYarea :57)."""
from __future__ import annotations

import torch

from reference.cice import constants as ct


def increment_age(dt, iage, aicen):
    """iage += dt where ice exists (ice_age.F90:45-80)."""
    return torch.where(aicen > ct.puny, iage + dt, iage)


def update_FYarea(dt, yday, FY, aicen, nhmask):
    """Reset first-year area on day 259 (NH) / 75 (SH)
    (ice_firstyear.F90:57-105). ``yday`` is a Python number or a 0-d
    tensor; ``nhmask`` marks the northern-hemisphere cells."""
    secday = 86400.0
    yday = torch.as_tensor(yday, dtype=FY.dtype, device=FY.device)
    reset_nh = (yday >= 259.0) & (yday < 259.0 + dt / secday)
    reset_sh = (yday >= 75.0) & (yday < 75.0 + dt / secday)
    has = aicen > ct.puny
    FY = torch.where(has & reset_nh & nhmask, 0.0, FY)
    return torch.where(has & reset_sh & ~nhmask, 0.0, FY)
