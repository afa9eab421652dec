"""The comparison that decides ``correct``.

The port is followed step by step from its own state: for each step of
the window that the entry sampled from the seed, the plain reference in
the configuration's precision (``reference.Reference``) takes the state
the port stepped from and the forcing the benchmark handed it, makes the
step once, and the port's state after the step, and its fluxes (the
step's diagnostics), are held against the reference's. A field is read
cell by cell, by the relative difference |got - ref| / max(|got|, |ref|)
over the cells where either side is nonzero (its live cells); tracers
are compared as conserved amounts (the reference's weight times the
value, for both sides), so that a tracer's value where its parent is
absent does not count. Four numbers are compared, each with its limit
from ``limits/<cell>.json``:

- ``state_gap``, ``flux_gap``: the widest field, of the state after the
  step and of the fluxes, by the upper quartile of its cells' gaps;
- ``state_block_gap``: the widest field of the state by its totals over
  blocks of cells (each category and tracer slot apart):
  the largest |sum got - sum ref| over a block, relative to the block's
  sum of max(|got|, |ref|), or to ``floor`` times the mean of that over
  the layer's live blocks where that is larger (``block_gap``).

Not a norm of the whole field: one step of this model meets discrete
events (a solver pass more or less in a cell, ice zapped in one cell and
kept in the other, a pond lid that freezes only where the melt water is
exactly 0) wherever two roundings of the same arithmetic differ by an
ulp, and the EVP's 120 subcycles spread such an event over its
neighbourhood, so a field's L2 gap swings over orders of magnitude from
seed to seed on sound runs. The quartile reads the bulk of the cells,
which such an event leaves alone and a lower precision moves. A block's
total reads a fault confined to a part of the field (one thickness
category, the rows by the fold, one tile of a kernel, one hemisphere),
which the quartile cannot see while it touches under a quarter of the
cells: the sound runs' cell by cell differences of an event are
redistributions that largely cancel over a block, and a fault's do not.

Health holds besides (the guards of the port's first benchmark): no
value of the final state is non-finite (a non-finite value in a sampled
step reads an infinite gap), the final ice area is between 0.5% and 105%
of the ocean's, and at the last step of every chunk of the window the
step's iterations converged: the mushy solver did not stop on its pass
cap with cells unconverged, and ridging stopped before CICE's 20 passes
(``ice_mechred.F90``'s ``nitermax``, at which CICE stops the run).

The control (``control=True``) puts stand-ins in the port's place on the
same samples: the reference computed from state and forcing rounded to
the precision below the configuration's, with its result rounded to it
(``CONTROL``: float32 for float64, bfloat16 for float32), and the state
left unchanged by the step; for a float32 configuration also the
reference in float64, which says how far float32 itself lies from it.
"""
from __future__ import annotations

import math

import torch

# flags, masks and dates: discrete by nature, not compared
STATE_SKIPPED = frozenset({"iceumask", "first_ice", "mlt_onset",
                           "frz_onset", "trcrn"})
DIAG_COMPARED = ("aice", "fsens", "flat", "flwout", "fswabs", "fhocn",
                 "fresh", "fsalt", "strairxT", "strairyT")
# the step's own convergence readings, taken at each chunk's last step
DIAG_LOOPS = ("therm_converged", "niter_thermo", "niter_ridge")
RIDGE_NITERMAX = 20
ICE_FRACTION = (0.005, 1.05)
GAPS = ("state_gap", "flux_gap", "state_block_gap")


def cell_gap(got, ref) -> float:
    """The upper quartile of the live cells' gaps, in float64 on the
    reference's device: a cell's gap is |got - ref| / max(|got|, |ref|),
    and a cell is live where either side is nonzero. A non-finite value
    reads infinite."""
    ref = ref.to(torch.float64).reshape(-1)
    got = torch.as_tensor(got).to(device=ref.device,
                                  dtype=torch.float64).reshape(-1)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    scale = torch.maximum(got.abs(), ref.abs())
    live = scale > 0
    n = int(live.sum())
    if n == 0:
        return 0.0
    rel = (got - ref).abs()[live] / scale[live]
    return float(torch.kthvalue(rel.cpu(), max(1, math.ceil(0.75 * n)))[0])


def block_gap(got, ref, block, floor: float) -> float:
    """The widest gap of a field's totals over blocks of ``block`` = (rows,
    columns) cells, each layer (the leading indices: category, tracer
    slot) apart: |sum got - sum ref| over the block's sum of max(|got|,
    |ref|), or over ``floor`` times that sum's mean over the layer's live
    blocks where that is larger. A non-finite value reads infinite."""
    ref = ref.to(torch.float64)
    got = torch.as_tensor(got).to(device=ref.device, dtype=torch.float64)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    ny, nx = ref.shape[-2:]
    by, bx = block
    pad = (0, -nx % bx, 0, -ny % by)

    def sums(x):
        x = torch.nn.functional.pad(x.reshape(-1, ny, nx), pad)
        n, h, w = x.shape
        return x.reshape(n, h // by, by, w // bx, bx).sum((2, 4))

    diff = sums(got - ref).abs()
    scale = sums(torch.maximum(got.abs(), ref.abs()))
    live = scale > 0
    if not bool(live.any()):
        return 0.0
    mean = (scale * live).sum((1, 2), keepdim=True) \
        / live.sum((1, 2), keepdim=True).clamp(min=1)
    den = torch.maximum(scale, floor * mean)
    return float((diff[live] / den[live]).max())


def field_gaps(got: dict, want: dict, block=None, floor=1.0) -> dict:
    """{field: (cell_gap, block_gap or None without ``block``)} of the
    fields of ``want``."""
    return {k: (cell_gap(got[k], want[k]),
                None if block is None
                else block_gap(got[k], want[k], block, floor))
            for k in want}


def state_gaps(ref, got: dict, want: dict, block, floor) -> dict:
    """``field_gaps`` of a state dict ``got`` against ``want``; the
    tracer slots as amounts, named by the reference's registry."""
    names = [k for k in want if k not in STATE_SKIPPED and want[k].numel()]
    out = field_gaps(got, {k: want[k] for k in names}, block, floor)
    a_got, a_want = ref.tracer_amounts(got), ref.tracer_amounts(want)
    amounts = {"trcrn." + n: i for i, n in enumerate(ref.tr.names)}
    out.update(field_gaps({k: a_got[:, i] for k, i in amounts.items()},
                          {k: a_want[:, i] for k, i in amounts.items()},
                          block, floor))
    return out


def widest(gaps: dict, prefix: str) -> dict:
    """{prefix_gap: (quartile, field)}, and with block gaps
    {prefix_block_gap: (gap, field)}, of the widest fields of ``gaps``."""
    out = {}
    for i, key in enumerate((f"{prefix}_gap", f"{prefix}_block_gap")):
        if any(v[i] is None for v in gaps.values()):
            continue
        name = max(gaps, key=lambda k: gaps[k][i])
        out[key] = (gaps[name][i], name)
    return out


# the control's precision: the one below each configuration's. It
# computes in float32, with its inputs and its result rounded to the lower
# type: float32 itself for a float64 configuration, bfloat16 for float32
CONTROL = {"float64": torch.float32, "float32": torch.bfloat16}


def rounded(fields: dict, dtype) -> dict:
    """Floating tensors rounded to ``dtype`` (and held in float32)."""
    return {k: (v.to(dtype).to(torch.float32)
                if torch.is_tensor(v) and v.is_floating_point() else v)
            for k, v in fields.items()}


def _fluxes(sample, diag) -> tuple[dict, dict]:
    """(the port's fluxes, the reference's) of one sample."""
    return sample["diag"], {k: getattr(diag, k) for k in DIAG_COMPARED}


def blocks_of(limits: dict) -> tuple:
    """(block, floor) of the state's block gap."""
    return (tuple(limits["state_block_gap"]["block"]),
            limits["state_block_gap"]["floor"])


def judge(ctx, limits: dict, control: bool = False):
    """(readings, the kernel arguments of the reference's step from the
    state the traced window started from, or else of its last sample's
    step): readings holds each of ``GAPS`` (the worst over the samples)
    with the field and step that set it, and with ``control`` the same
    numbers of the stand-ins."""
    from reference import Reference
    from reference.cice.models.radiation import dedd
    from reference.cice.models.transport import remap
    ref = Reference(ctx.model_spec, ctx.arrays,
                    dtype=ctx.model_spec["dtype"], device=ctx.device)
    blk = blocks_of(limits)
    captured = {}
    orig = (remap.remap_flux_both, dedd.shortwave_dEdd_ncat)

    def rm_cap(*args):
        captured["remap"] = args
        return orig[0](*args)

    def sw_cap(**kw):
        captured["dedd"] = kw
        return orig[1](**kw)

    readings = {k: 0.0 for k in GAPS}
    where = {}
    stand_ins = {}
    remap.remap_flux_both, dedd.shortwave_dEdd_ncat = rm_cap, sw_cap
    try:
        for s in ctx.samples:
            forcing = ctx.gen.fields(s["istep"])
            post, diag = ref.step(s["pre"], forcing)
            gsd = state_gaps(ref, s["post"], post, *blk)
            got_f, want_f = _fluxes(s, diag)
            gfd = field_gaps(got_f, want_f)
            _print_widest(f"step {s['istep']}", gsd, gfd)
            for key, (val, field) in {**widest(gsd, "state"),
                                      **widest(gfd, "flux")}.items():
                if key not in where or not val <= readings[key]:
                    readings[key] = val
                    where[key] = f"{field} (step {s['istep']})"
            if control:
                _stand_ins(ctx, ref, s, forcing, post, diag, blk,
                           stand_ins)
        t = ctx.__dict__.get("trace_sample")
        if t is not None:
            # the kernels' arguments of the traced window's first step
            ref.step(t["pre"], ctx.gen.fields(t["istep"]))
    finally:
        remap.remap_flux_both, dedd.shortwave_dEdd_ncat = orig
    readings["where"] = where
    if control:
        readings["stand_ins"] = stand_ins
    return readings, captured


def _print_widest(what, *gaps):
    """The widest field gaps of one comparison (quartile and block gap),
    on standard error."""
    import sys
    for g in gaps:
        top = sorted(g.items(), key=lambda kv: -kv[1][0])
        print(f"gaps {what}: " + ", ".join(
            f"{k} {q:.3e}" + ("" if b is None else f"/{b:.3e}")
            for k, (q, b) in top), file=sys.stderr)


def _stand_ins(ctx, ref, s, forcing, post, diag, blk, out):
    """The control's and the unchanged state's numbers on one sample, and
    for a float32 configuration the reference in float64's."""
    from reference import Reference
    dtype = ctx.model_spec["dtype"]
    low = CONTROL[dtype]
    others = [("control", ref if dtype == "float32" else None, low)]
    if dtype == "float32":
        others.append(("reference_float64", None, torch.float64))
    pre = {k: torch.as_tensor(v).to(ctx.device) for k, v in s["pre"].items()}
    _, want_f = _fluxes(s, diag)

    def stand_in(r, rounding):
        cpost, cdiag = r.step(rounding(pre), rounding(dict(forcing)))
        cpost = rounding(cpost)
        cflux = rounding({k: getattr(cdiag, k) for k in DIAG_COMPARED})
        return (state_gaps(ref, cpost, post, *blk),
                field_gaps(cflux, want_f))

    got = {}
    for name, r, rdtype in others:
        if r is None:
            key = "ref_" + name
            if key not in ctx.__dict__:
                setattr(ctx, key, Reference(
                    ctx.model_spec, ctx.arrays, device=ctx.device,
                    dtype="float64" if rdtype == torch.float64
                    else "float32"))
            r = getattr(ctx, key)
        rounding = (lambda d: d) if rdtype == torch.float64 else \
            (lambda d, t=rdtype: rounded(d, t))
        gsd, gfd = stand_in(r, rounding)
        _print_widest(f"{name} step {s['istep']}", gsd, gfd)
        got[name] = {**widest(gsd, "state"), **widest(gfd, "flux")}
    got["unchanged_state"] = widest(
        state_gaps(ref, pre, post, *blk), "state")
    for name, g in got.items():
        dst = out.setdefault(name, {})
        for key, (val, field) in g.items():
            if key not in dst or val < dst[key][0]:
                dst[key] = (val, field)


def health(final: dict, inputs, loops) -> dict:
    """{nonfinite values of the final state, its ice area as a share of
    the ocean's, the chunk-end steps whose iterations did not converge}.
    ``loops`` holds (therm_converged, niter_thermo, niter_ridge) of each
    chunk's last step, a row each."""
    bad = sum(int((~torch.isfinite(v)).sum()) for v in final.values()
              if torch.is_tensor(v) and v.is_floating_point())
    tarea = inputs.grid.tarea.double() * inputs.grid.tmask
    aice = final["aicen"].double().sum(0).to(tarea.device)
    ndtd = inputs.cfg.time.ndtd
    unconverged = sum(1 for conv, _, nrdg in loops
                      if not conv or nrdg >= RIDGE_NITERMAX * ndtd)
    return {"nonfinite_values": bad,
            "ice_area_fraction": float((aice * tarea).sum()
                                       / tarea.sum()),
            "unconverged_steps": unconverged,
            "chunk_end_steps": len(loops),
            "most_passes": [max((r[i] for r in loops), default=0)
                            for i in (1, 2)]}


def passes(readings: dict, hl: dict, limits: dict) -> bool:
    ok = hl["nonfinite_values"] == 0 and hl["unconverged_steps"] == 0 \
        and ICE_FRACTION[0] < hl["ice_area_fraction"] < ICE_FRACTION[1]
    for key in GAPS:
        ok = ok and readings[key] <= limits[key]["limit"]
    return bool(ok)


def report(readings: dict, hl: dict, limits: dict) -> dict:
    """Each number compared with its limit, short plain names."""
    out = {}
    for key in GAPS:
        out[key] = {"value": readings[key], "limit": limits[key]["limit"],
                    "at": readings["where"].get(key, "")}
    out["nonfinite_values"] = {"value": hl["nonfinite_values"], "limit": 0}
    out["ice_area_fraction"] = {"value": hl["ice_area_fraction"],
                                "limit": list(ICE_FRACTION)}
    out["unconverged_steps"] = {
        "value": hl["unconverged_steps"], "limit": 0,
        "at": f"of {hl['chunk_end_steps']} chunk ends; most passes "
              f"thermo {hl['most_passes'][0]}, ridging "
              f"{hl['most_passes'][1]}"}
    for name, got in readings.get("stand_ins", {}).items():
        for key, (val, field) in got.items():
            out[f"{name}.{key}"] = {"value": val,
                                    "limit": limits[key]["limit"],
                                    "at": field}
    return out


def lines(checks: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            + (f" at {v['at']}" if v.get("at") else "")
            for k, v in checks.items()]
