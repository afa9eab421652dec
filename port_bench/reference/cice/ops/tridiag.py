"""Batched tridiagonal (Thomas) solver (PyTorch port of
``cice5_tpu/ops/tridiag.py``; ice_therm_bl99.F90:1763 tridiag_solver).
The recurrence runs over the layer axis (axis 0) while every column of
the batch is solved at once."""
from __future__ import annotations

import torch


def tridiag_solve(sbdiag, diag, spdiag, rhs):
    """Solve the batched tridiagonal system along axis 0.

    sbdiag: (n, ...) sub-diagonal a_k (a_0 unused); diag: (n, ...) main
    diagonal b_k; spdiag: (n, ...) super-diagonal c_k (c_{n-1} unused);
    rhs: (n, ...). Returns x: (n, ...)."""
    n = diag.shape[0]
    cps, dps = [], []
    cp = torch.zeros_like(diag[0])
    for k in range(n):
        w = 1.0 / (diag[k] - sbdiag[k] * cp)
        cp = spdiag[k] * w
        dp = (rhs[k] - sbdiag[k] * dps[-1]) * w if k else rhs[k] * w
        cps.append(cp)
        dps.append(dp)
    xs = [None] * n
    x = dps[n - 1]
    xs[n - 1] = x
    for k in range(n - 2, -1, -1):
        x = dps[k] - cps[k] * x
        xs[k] = x
    return torch.stack(xs)
