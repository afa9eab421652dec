"""Dataclasses of tensors.

The JAX package threads its state as immutable pytrees; the port keeps the
same field names in frozen dataclasses whose fields are tensors (or, for a
few diagnostics, Python scalars). ``replace`` returns a copy with some
fields swapped and ``to`` moves every tensor field to a device.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

import numpy as np
import torch

T = TypeVar("T")


def _replace(self, **kw):
    return dataclasses.replace(self, **kw)


def _to(self, device=None, dtype=None):
    """Copy with every tensor field on ``device``; floating tensors are
    also cast to ``dtype`` when one is given."""
    out = {}
    for f in dataclasses.fields(self):
        v = getattr(self, f.name)
        if isinstance(v, torch.Tensor):
            cast = dtype if (dtype is not None and v.is_floating_point()) \
                else v.dtype
            v = v.to(device=device, dtype=cast)
        out[f.name] = v
    return dataclasses.replace(self, **out)


def to_host(x) -> np.ndarray:
    """A tensor (or array) as a host NumPy array: one copy from the
    device."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def with_index(a: torch.Tensor, k, val) -> torch.Tensor:
    """Copy of ``a`` with ``a[k] = val`` (the functional update the JAX
    package writes as ``a.at[k].set(val)``)."""
    a = a.clone()
    a[k] = val
    return a


def device_values(values, *, dtype, device) -> torch.Tensor:
    """A 1-D tensor of Python numbers, each written on the device by a fill
    rather than copied from host memory, so that a CUDA graph capture
    records it (``torch.tensor(values, device=...)`` is a host copy, which
    a capture refuses)."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


def tensorclass(cls: type[T]) -> type[T]:
    """Decorator: frozen dataclass with ``.replace(**kw)`` and
    ``.to(device, dtype=None)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    cls.to = _to
    return cls
