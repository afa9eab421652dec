"""Carry configurations, states, grids and forcings into the port.

The port's ``State``, ``Grid`` and ``Forcing`` have the JAX package's field
names, so any of them can be rebuilt from a dict of NumPy arrays, e.g.
``{f.name: np.asarray(getattr(jax_state, f.name)) for f in
dataclasses.fields(jax_state)}`` — the counterpart of loading weights.
Nothing here imports JAX: the caller turns its arrays into NumPy first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cice5_tpu_torch import config as cfgmod
from cice5_tpu_torch.forcing import Forcing
from cice5_tpu_torch.grid import Grid
from cice5_tpu_torch.state import State

_SECTIONS = {"grid": cfgmod.GridConfig, "thermo": cfgmod.ThermoConfig,
             "dyn": cfgmod.DynConfig, "shortwave": cfgmod.ShortwaveConfig,
             "tracers": cfgmod.TracerConfig, "forcing": cfgmod.ForcingConfig,
             "time": cfgmod.TimeConfig}


def config_from_dict(d: dict) -> cfgmod.ModelConfig:
    """ModelConfig from a nested dict such as ``dataclasses.asdict`` of a
    JAX ``ModelConfig``; the two packages share field names."""
    kw = {k: (_SECTIONS[k](**v) if k in _SECTIONS else v)
          for k, v in d.items()}
    return cfgmod.ModelConfig(**kw)


def _build(cls, arrays: dict, device, dtype):
    kw = {}
    for f in dataclasses.fields(cls):
        a = arrays.get(f.name)
        if a is None:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"{cls.__name__} needs {f.name!r}")
            kw[f.name] = None
            continue
        t = torch.as_tensor(np.array(a), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        kw[f.name] = t
    return cls(**kw)


def state_from_arrays(arrays: dict, *, device, dtype=None) -> State:
    """Port State from a dict of NumPy arrays keyed by field name."""
    return _build(State, arrays, device, dtype)


def grid_from_arrays(arrays: dict, *, device, dtype=None) -> Grid:
    """Port Grid from a dict of NumPy arrays keyed by field name."""
    return _build(Grid, arrays, device, dtype)


def forcing_from_arrays(arrays: dict, *, device,
                        dtype=None) -> Forcing:
    """Port Forcing from a dict of NumPy arrays keyed by field name; the
    optional fields (the coupler's fluxes, the aerosol deposition
    ``faero_atm`` and the ocean BGC ``ocean_bio``) may be missing or None,
    and are carried when given."""
    return _build(Forcing, arrays, device, dtype)


def to_numpy(obj) -> dict:
    """Dict of NumPy arrays of a State, Grid, Forcing or NamedTuple."""
    items = (obj._asdict().items() if hasattr(obj, "_asdict") else
             ((f.name, getattr(obj, f.name))
              for f in dataclasses.fields(obj)))
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in items}
