"""Hold the CUDA kernels against their plain PyTorch versions.

``capture_kernel_args`` runs one model step and returns the arguments the
kernel wrappers received there, so a kernel and its plain version can be
called again on the main path's own inputs. ``field_errors`` compares
their outputs field by field: each field (and each stress component or
tracer of a stacked field) against its own largest reference magnitude,
so a small field (a velocity, a ridging rate, a mass flux) is not hidden
behind a large one (a stress, an enthalpy flux).
"""
from __future__ import annotations

import torch

EVP_FIELDS = ("uvel", "vvel", "stress", "divu", "shear", "rdg_conv",
              "rdg_shear", "prs_sig", "strintx", "strinty")
REMAP_FIELDS = ("fn_mflx", "fn_mtflx", "fe_mflx", "fe_mtflx")
# stacked fields: the axis whose entries have scales of their own (the
# stress components, the tracers of the fluxes, the layers of the dEdd
# absorption profiles)
_COMPONENT_AXIS = {"stress": 0, "fn_mtflx": 1, "fe_mtflx": 1,
                   "Sswabsn": 1, "Iswabsn": 1, "fswpenln": 1}


def capture_kernel_args(model, state, forcing):
    """Run the eager step (``driver.step.step``) of ``model`` on
    (state, forcing) and return (new state, {"evp":
    (p, ndte, topo, kw), "remap": args, "dedd": kw}) with the arguments
    that ``evp.evp_sweep``, ``remap.remap_flux_both`` and (with dEdd
    shortwave) ``dedd.shortwave_dEdd_ncat`` received."""
    from cice5_tpu_torch.driver.step import step
    from cice5_tpu_torch.models.dynamics import evp
    from cice5_tpu_torch.models.radiation import dedd
    from cice5_tpu_torch.models.transport import remap
    got = {}
    orig = (evp.evp_sweep, remap.remap_flux_both, dedd.shortwave_dEdd_ncat)

    def evp_cap(p, ndte, topo, **kw):
        got["evp"] = (p, ndte, topo, kw)
        return orig[0](p, ndte, topo, **kw)

    def rm_cap(*args):
        got["remap"] = args
        return orig[1](*args)

    def sw_cap(**kw):
        got["dedd"] = kw
        return orig[2](**kw)

    evp.evp_sweep, remap.remap_flux_both = evp_cap, rm_cap
    dedd.shortwave_dEdd_ncat = sw_cap
    try:
        state, _ = step(state, forcing, *model.step_args)
    finally:
        evp.evp_sweep, remap.remap_flux_both, dedd.shortwave_dEdd_ncat = orig
    return state, got


def evp_outputs(out) -> dict:
    """Name the results (u, v, stress, diags) of evp_sweep/subcycle_sweep."""
    u, v, stress, diags = out
    return dict(zip(EVP_FIELDS, (u, v, stress, *diags)))


def remap_outputs(out) -> dict:
    """Name the results of remap_flux_both/remap_flux_plain."""
    return dict(zip(REMAP_FIELDS, out))



def field_errors(ref: dict, got: dict, axes: dict | None = None) -> dict:
    """{field: (max abs diff, max abs diff / max |ref|)} with each entry of
    a stacked field (``axes`` maps its name to the stacking axis; by
    default the stress components and the tracers of the fluxes) as a
    field of its own: ``stress[3]``, ``fn_mtflx[7]``. A field whose
    reference is all zero must match exactly."""
    axes = _COMPONENT_AXIS if axes is None else axes
    out = {}
    for name, a in ref.items():
        a, b = a.double(), got[name].double()
        ax = axes.get(name)
        parts = ([(name, a, b)] if ax is None else
                 [(f"{name}[{k}]", a.select(ax, k), b.select(ax, k))
                  for k in range(a.shape[ax])])
        for key, x, y in parts:
            err = float((x - y).abs().max())
            scale = float(x.abs().max())
            out[key] = (err, err / scale if scale > 0 else
                        (0.0 if err == 0 else float("inf")))
    return out


def worst(errors: dict):
    """(field with the largest relative difference, that difference, the
    largest absolute difference over all fields) of ``field_errors``."""
    key = max(errors, key=lambda k: errors[k][1])
    return key, errors[key][1], max(e for e, _ in errors.values())


def evp_on_plan(p, ndte, topo, plan, *, kchunk=None, **kw):
    """The EVP kernels on the sweep inputs ``kw`` (as ``evp.evp_sweep``
    takes them) with a tile plan of the caller's (``evp_resident.tile_plan``,
    e.g. a forced branch): kernel A in one launch of ``ndte`` subcycles, or
    with ``kchunk`` kernel D in ``ndte // kchunk`` launches. Returns what
    ``evp.evp_sweep`` returns."""
    from cice5_tpu_torch.models.dynamics import evp
    from cice5_tpu_torch.ops import kernels
    args = evp.kernel_args(**kw)
    if kchunk is None:
        u, v, s, d, si = kernels.evp_sweep(
            ndte=ndte, cyc_x=topo.ew == "cyclic", cyc_y=topo.ns == "cyclic",
            fold=evp.fold_mode(topo), p=p, plan=plan, **args)
    else:
        state = {k: args.pop(k) for k in ("u", "v", "stress")}
        for _ in range(ndte // kchunk):
            u, v, s, d, si = kernels.evp_fused(
                kchunk=kchunk, cyc_x=topo.ew == "cyclic", p=p, plan=plan,
                **state, **args)
            state = dict(u=u, v=v, stress=s)
    return u, v, s, (d[0], d[1], d[2], d[3], d[4], si[0], si[1])
