"""Helpers shared by the harness, its entries and its metric readers."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """A module of the benchmark's own found by its file name (metric,
    entry): each is a file of its own, named as BENCHMARK.json names it."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with the (nested) keys of ``over`` replaced."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def port_config(model: dict):
    """The port's ModelConfig of a configuration file's ``model``."""
    from cice5_tpu_torch import config as pc
    sections = {"grid": pc.GridConfig, "thermo": pc.ThermoConfig,
                "dyn": pc.DynConfig, "shortwave": pc.ShortwaveConfig,
                "tracers": pc.TracerConfig, "forcing": pc.ForcingConfig,
                "time": pc.TimeConfig}
    return pc.ModelConfig(**{k: (sections[k](**v) if k in sections else v)
                             for k, v in model.items()})


def port_state(fields: dict):
    from cice5_tpu_torch.state import State
    return State(**fields)


def port_forcing(fields: dict):
    from cice5_tpu_torch.forcing import Forcing
    return Forcing(**fields)


def fields_of(obj) -> dict:
    """The tensor fields of a State, Forcing or StepDiag by name."""
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def to_host(fields: dict, names=None) -> dict:
    import torch
    return {k: v.detach().cpu() for k, v in fields.items()
            if torch.is_tensor(v) and (names is None or k in names)}


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
