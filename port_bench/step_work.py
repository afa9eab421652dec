"""The least time of the work a step must do, counted from the
configuration's shapes and the inputs of the traced window's first step
(the arguments the reference's plain kernels received when it made that
step from the same state), whatever implements it: ``bounds`` per hand-written kernel's
function, and the model state read and written once."""
from __future__ import annotations

from bounds import HBM_BYTES_PER_S, dedd_bound, evp_bound, remap_bound


def least_ms(ctx) -> dict:
    """{function: least ms of one call} of the kernels' functions that the
    configuration runs, and ``state`` for the state's traffic."""
    if "least_ms" in ctx.__dict__:
        return ctx.least_ms
    m = ctx.model_spec
    out = {}
    itemsize = 8 if m["dtype"] == "float64" else 4
    if m["dyn"]["kdyn"] == 1:
        out["evp_sweep"] = evp_bound(m["grid"]["ny"], m["grid"]["nx"],
                                     m["dyn"]["ndte"], itemsize)[0]
    args = ctx.kernel_args
    if "remap" in args:
        out["remap_flux_both"] = remap_bound(args["remap"])[0]
    if "dedd" in args:
        out["shortwave_dedd"] = dedd_bound(args["dedd"])[0]
    out["state"] = 1e3 * 2 * itemsize * sum(ctx.state_numel.values()) \
        / HBM_BYTES_PER_S
    ctx.least_ms = out
    return out


def calls_per_step(m: dict) -> dict:
    ndtd = m["time"]["ndtd"]
    return {"evp_sweep": ndtd, "remap_flux_both": ndtd,
            "shortwave_dedd": 1, "state": 1}


def step_least_ms(ctx) -> float:
    per = calls_per_step(ctx.model_spec)
    return sum(per[k] * v for k, v in least_ms(ctx).items())


def roofline(ctx, kernel: str, function: str):
    """The share (%) of its roofline that kernel ``kernel`` (a substring of
    its device name) reached in the traced window: the least time of
    ``function`` on the traced window's first step's inputs over the
    kernel's mean device time per launch; None where it did not run."""
    from devtrace import kernel_launches
    if ctx.trace is None:
        return None
    n, seconds = kernel_launches(ctx.trace, kernel)
    least = least_ms(ctx).get(function)
    if n == 0 or least is None:
        return None
    return 100.0 * least / (1e3 * seconds / n)
