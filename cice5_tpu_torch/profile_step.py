"""Where the time of one model step goes on the GPU.

    python -m cice5_tpu_torch.profile_step [--config gx1_parity]
        [--evp-algorithm pallas] [--ny 384 --nx 320 --steps 3]

Runs the BL99 + CCSM3 configuration (``bench_easy``, the default), the
gx1-parity configuration (``gx1_parity``: mushy thermo, dEdd, tracers,
tripole seam, on ``synth_gx1_grid``), the same with topographic ponds
(``gx1_topo``), on a T-fold seam with the transport conservation and
monotonicity checks (``gx1_tfold``), with EAP rheology and the
per-category mechred diagnostics (``gx1_eap``), with the aerosol, brine
and skeletal-BGC tracers (``gx1_bgc``: 39 tracers), with CESM2's 8 ice
and 3 snow layers (``cesm2_layers``: 27 tracers), the BL99 model with
upwind transport (``bl99_upwind``), CICE's gx3 test configuration (``gx3``: 116x100, nilyr=7,
open north, on ``synth_gx1_grid``'s mesh at that shape, the arrays that
chip_smoke writes to its gx3 grid files), the ACCESS-OM 0.25-degree one
(``auscom_025``: the gx1-parity physics at 1080x1440 with the coupled
radiation ordering of the coupled model) or the 0.1-degree one (``tx01``:
the gx1-parity physics at 3600x2700, on one card), float32, ndte=120, on
the GPU; ``--ny``/``--nx`` default to the configuration's grid;
``--evp-algorithm pallas`` takes the fused EVP sweep (kernel evp_fused)
where the step does (not on the tripole seam). Prints one JSON line with

- ``eager`` and ``graph``: the eager step and ``Model.rollout``, whose
  steps replay the step's CUDA graphs, each over ``--steps`` steps:
  ``ms_per_step`` (host clock, no syncs inside), and from
  ``torch.profiler`` device kernel time and kernels per step for each
  hand-written kernel and for all other (PyTorch) kernels, the device
  busy share of the wall time and the host syncs
  (``aten::_local_scalar_dense``) per step; for ``graph`` also the graph
  replays and loop flag reads per step, the graphs of the step's program
  and the host seconds their capture took;
- ``phase_device``: the device time and kernels of one eager step split
  by its leaf phases (form drag, radiation, vertical thermo, the aerosol
  and brine/BGC updates, linear_itd, add_new_ice, lateral_melt,
  cleanup_itd, strength, EVP, fused EVP or EAP, transport, ridging, the
  slab ocean; ``other`` the rest), each call under its own
  ``torch.profiler``, and
  ``history_device``: the device time and kernels of one history
  accumulation of every available field (``diag_to_values`` +
  ``HistoryStream.accum``, as ``Model.run`` makes it after each step);
- ``run_split``: ``Model.run``'s ms per step split by part
  (``run_split``), over 4 steps with a history stream of every available
  field written once and the state checked every step;
- the thermo solver's passes (BL99 or mushy Picard, both stages) and the
  ridging passes of the last step;
- ``peak_memory_bytes``: the device memory peak
  (``torch.cuda.max_memory_allocated``) of the graph rollout and
  everything before it.

It needs a CUDA device and fails without one. A run that exhausts the
card's memory prints one JSON line with ``out_of_memory``: the stage it
stopped in, the bytes allocated and the peak there, and exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from collections import defaultdict

import torch

from cice5_tpu_torch.config import (auscom_025_config, bench_easy_config,
                                    gx1_parity_config, gx3_config,
                                    tx01_config)
from cice5_tpu_torch.driver import step as step_mod
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.grid import synth_gx1_grid

# device kernel name -> wrapper; the EVP engine (csrc/evp_resident.cu)
# runs evp_sweep, or evp_fused on the fused path; remap_tiles runs
# remap_flux_both on every path (its one-edge mode, remap_flux_edge, on
# none)
OWN_KERNELS = {"evp_resident": "evp_sweep",
               "remap_tiles": "remap_flux_both",
               "shortwave_dedd": "shortwave_dedd"}


def _with(cfg, **sections):
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in sections.items()})


def gx1_tfold_config():
    """gx1-parity on a T-fold seam with the transport conservation and
    monotonicity checks (chip_smoke's ``gx1_tfold`` path)."""
    cfg = gx1_parity_config()
    return _with(cfg, grid=dict(ns_boundary="tripoleT"),
                 dyn=dict(conserv_check=True, monotonicity_check=True))


def gx1_eap_config():
    """gx1-parity with EAP rheology and the per-category mechred
    diagnostics (chip_smoke's ``gx1_eap`` path)."""
    return _with(gx1_parity_config(), dyn=dict(kdyn=2, diag_mechred=True))


def gx1_bgc_config():
    """gx1-parity with the aerosol (n_aero=3), brine and skeletal-BGC
    tracers, all nine BGC tracers under the Jin2006 piston velocity: 39
    tracers (chip_smoke's ``gx1_bgc`` path)."""
    return _with(gx1_parity_config(), tracers=dict(
        tr_aero=True, n_aero=3, tr_brine=True, skl_bgc=True,
        bgc_flux_type="Jin2006"))


CONFIGS = {
    "bench_easy": bench_easy_config,
    "gx1_parity": gx1_parity_config,
    "gx1_topo": lambda: _with(gx1_parity_config(), tracers=dict(
        tr_pond_lvl=False, tr_pond_topo=True)),
    "gx1_tfold": gx1_tfold_config,
    "gx1_eap": gx1_eap_config,
    "gx1_bgc": gx1_bgc_config,
    "cesm2_layers": lambda: gx1_parity_config(nilyr=8, nslyr=3),
    "bl99_upwind": lambda: _with(bench_easy_config(),
                                 dyn=dict(advection="upwind")),
    "gx3": gx3_config,
    "auscom_025": lambda: auscom_025_config(coupled_radiation=True),
    "tx01": tx01_config,
}


# the leaf functions of one step whose device time ``phase_device``
# splits out: (owner module attribute path, label)
LEAF_PHASES = (("step", "neutral_drag_coeffs", "formdrag"),
               ("step", "_step_radiation", "radiation"),
               ("vertical", "thermo_vertical", "vertical_thermo"),
               ("step", "_aerosol", "aerosol"),
               ("step", "_brine_bgc", "brine_bgc"),
               ("itd", "linear_itd", "linear_itd"),
               ("itd", "add_new_ice", "add_new_ice"),
               ("itd", "lateral_melt", "lateral_melt"),
               ("itd", "cleanup_itd", "cleanup_itd"),
               ("step", "strength_rothrock", "strength"),
               ("step", "evp", "evp"), ("step", "evp_fused", "evp_fused"),
               ("step", "eap", "eap"),
               ("step", "transport_remap", "transport"),
               ("step", "transport_upwind", "transport"),
               ("step", "ridge_ice", "ridging"),
               ("ocean", "ocean_mixed_layer", "ocean"))


def _device(prof):
    """(kernels, device ms) of the CUDA events of a profile."""
    n, us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            us += e.time_range.elapsed_us()
    return n, us / 1e3


def _profiled(fn):
    """(fn's result, its kernels, their device ms) under torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return (out,) + _device(prof)


def phase_device(m, st, f) -> dict:
    """{label: [kernels, device ms]} of one eager step of ``m`` split by
    LEAF_PHASES (no leaf runs inside another), with the step's total and
    the rest as ``other``."""
    from cice5_tpu_torch.models.thermo import itd
    owners = {"step": step_mod, "vertical": step_mod.vertical, "itd": itd,
              "ocean": step_mod.ocean}
    acc = defaultdict(lambda: [0, 0.0])
    saved = []
    for owner, attr, label in LEAF_PHASES:
        mod = owners[owner]
        fn = getattr(mod, attr)

        def timed(*a, _fn=fn, _label=label, **k):
            out, n, ms = _profiled(lambda: _fn(*a, **k))
            acc[_label][0] += n
            acc[_label][1] += ms
            return out
        saved.append((mod, attr, fn))
        setattr(mod, attr, timed)
    try:
        step_mod.step(st, f, *m.step_args)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    _, n, ms = _profiled(lambda: step_mod.step(st, f, *m.step_args))
    out = {k: list(v) for k, v in acc.items()}
    out["other"] = [n - sum(v[0] for v in acc.values()),
                    ms - sum(v[1] for v in acc.values())]
    out["total"] = [n, ms]
    return out


def history_device(m, st, f) -> list:
    """[kernels, device ms] of one history accumulation of every available
    field after a step of ``m`` (``Model.run``'s per-step history work)."""
    from cice5_tpu_torch.io import history as hist
    st, diag = step_mod.step(st, f, *m.step_args)
    stream = hist.HistoryStream(hist.available_fields(m.cfg, m.tr),
                                freq="1", freq_n=4)

    def accum():
        stream.accum(hist.diag_to_values(diag, st, m.grid, m.tr, f,
                                         m.cfg.nilyr, m.cfg.nslyr), 0.0)
    accum()
    return list(_profiled(accum)[1:])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_split(m, st, nsteps, **run_kw):
    """``m.run(st, nsteps, **run_kw)`` with its ms per step split by part:
    ``step`` (``Model.step``: on CUDA the graph replay and the clones of
    its result), ``check_state``, ``history_values`` (``diag_to_values``),
    ``history_accum`` (``HistoryStream.accum``), ``history_write``
    (``write_netcdf``) and ``rest`` (the forcing, the calendar, the
    state_bad read, the diagnostics and the loop), with ``total``. Each
    part is bracketed by a device synchronization, so that its device work
    is inside it (the syncs add to ``total``). Returns (final state,
    split)."""
    from cice5_tpu_torch.driver import model as model_mod
    device = st.aicen.device
    acc = defaultdict(float)
    saved = []

    def wrap(owner, attr, label):
        fn = getattr(owner, attr)

        def timed(*a, **k):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync(device)
            acc[label] += time.perf_counter() - t0
            return out
        saved.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, timed)

    wrap(m, "step", "step")
    wrap(model_mod.diag_mod, "check_state", "check_state")
    wrap(model_mod.hist_mod, "diag_to_values", "history_values")
    wrap(model_mod.hist_mod, "write_netcdf", "history_write")
    if run_kw.get("history") is not None:
        wrap(run_kw["history"], "accum", "history_accum")
    _sync(device)
    t0 = time.perf_counter()
    try:
        st = m.run(st, nsteps, **run_kw)
        _sync(device)
    finally:
        for owner, attr, fn in reversed(saved):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
    total = time.perf_counter() - t0
    out = {k: 1e3 * v / nsteps for k, v in acc.items()}
    out["rest"] = 1e3 * (total - sum(acc.values())) / nsteps
    out["total"] = 1e3 * total / nsteps
    return st, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=tuple(CONFIGS),
                    default="bench_easy")
    ap.add_argument("--evp-algorithm", choices=("auto", "pallas"),
                    default="auto")
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    stage = ["setup"]
    try:
        profile(args, stage)
    except torch.cuda.OutOfMemoryError as e:
        print(json.dumps(dict(
            config=args.config, grid=[args.ny, args.nx],
            card=torch.cuda.get_device_name(0),
            out_of_memory=dict(
                stage=stage[0],
                allocated_bytes=torch.cuda.memory_allocated(),
                peak_bytes=torch.cuda.max_memory_allocated(),
                card_bytes=torch.cuda.get_device_properties(0).total_memory,
                message=str(e).splitlines()[0]))))
        raise SystemExit(1)


def profile(args, stage):
    """The measurements of ``main``; ``stage[0]`` names the one running."""
    cfg = CONFIGS[args.config]()
    args.ny = args.ny or cfg.grid.ny
    args.nx = args.nx or cfg.grid.nx
    cfg = cfg.replace(
        grid=dataclasses.replace(cfg.grid, ny=args.ny, nx=args.nx),
        dyn=dataclasses.replace(cfg.dyn, evp_algorithm=args.evp_algorithm))
    if cfg.grid.grid_type in ("tripole", "displaced_pole"):
        m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
        st = m.init_state()
    else:
        m = Model(cfg)
        st = m.init_state(ice_mask=m.grid.tmask)
    f = m.forcing_at(0)
    stage[0] = "first rollout (eager step, graph capture)"
    st, _ = m.rollout(st, f, 2)         # the first call captures the graphs
    torch.cuda.synchronize()
    (g,) = m.graphs.values()

    def eager(st, n):
        for _ in range(n):
            st, diag = step_mod.step(st, f, *m.step_args)
        return st, diag

    def profiled(run):
        """Unsynced ms/step of ``run(st, steps)``, then one more run of it
        under torch.profiler."""
        t0 = time.perf_counter()
        run(st, args.steps)
        torch.cuda.synchronize()
        ms_step = 1e3 * (time.perf_counter() - t0) / args.steps
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, diag = run(st, args.steps)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        dev = defaultdict(lambda: [0.0, 0])
        syncs = 0
        for e in prof.events():
            if e.name == "aten::_local_scalar_dense":
                syncs += 1
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = next((v for k, v in OWN_KERNELS.items()
                            if k in e.name), "pytorch")
                if key == "evp_sweep" and args.evp_algorithm == "pallas":
                    key = "evp_fused"
                dev[key][0] += e.time_range.elapsed_us() / 1e3   # us -> ms
                dev[key][1] += 1
        busy = sum(v[0] for v in dev.values())
        return diag, dict(
            ms_per_step=ms_step,
            device_ms_per_step={k: v[0] / args.steps
                                for k, v in dev.items()},
            launches_per_step={k: v[1] / args.steps for k, v in dev.items()},
            device_busy_share=busy / (1e3 * wall_prof),
            host_syncs_per_step=syncs / args.steps)

    stage[0] = "eager steps"
    _, eager_out = profiled(eager)
    replays, reads = g.replays, g.flag_reads
    stage[0] = "graph rollout"
    diag, graph_out = profiled(lambda s, n: m.rollout(s, f, n))
    graph_out.update(
        replays_per_step=(g.replays - replays) / (2 * args.steps),
        flag_reads_per_step=(g.flag_reads - reads) / (2 * args.steps),
        graphs_captured=len(g.program), capture_seconds=g.capture_seconds)
    out = dict(
        config=args.config, evp_algorithm=args.evp_algorithm,
        grid=[args.ny, args.nx], steps=args.steps,
        card=torch.cuda.get_device_name(0),
        eager=eager_out, graph=graph_out,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        thermo_passes_last_step=int(diag.niter_thermo),
        ridging_passes_last_step=int(diag.niter_ridge))
    stage[0] = "run_split"
    with tempfile.TemporaryDirectory(prefix="profile_step_") as tmp:
        from cice5_tpu_torch.io import history as hist
        stream = hist.HistoryStream(hist.available_fields(m.cfg, m.tr),
                                    freq="1", freq_n=4)
        _, split = run_split(m, st, 4, start_step=2, check_every=1,
                             history=stream, history_dir=tmp,
                             log=lambda *a: None)
    stage[0] = "phase_device, history_device"
    out.update(phase_device=phase_device(m, st, f),
               history_device=history_device(m, st, f), run_split=split)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
