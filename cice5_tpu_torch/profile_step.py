"""Where the time of one model step goes on the GPU.

    python -m cice5_tpu_torch.profile_step [--config gx1_parity]
        [--evp-algorithm pallas] [--ny 384 --nx 320 --steps 3]

Runs the BL99 + CCSM3 configuration (``bench_easy``, the default), the
gx1-parity configuration (``gx1_parity``: mushy thermo, dEdd, tracers,
tripole seam, on ``synth_gx1_grid``), the same with topographic ponds
(``gx1_topo``), on a T-fold seam with the transport conservation and
monotonicity checks (``gx1_tfold``), with EAP rheology and the
per-category mechred diagnostics (``gx1_eap``), the BL99 model with
upwind transport (``bl99_upwind``), CICE's gx3 test configuration (``gx3``: 116x100, nilyr=7,
open north, on ``synth_gx1_grid``'s mesh at that shape, the arrays that
chip_smoke writes to its gx3 grid files) or the ACCESS-OM 0.25-degree one
(``auscom_025``: the gx1-parity physics at 1080x1440 with the coupled
radiation ordering of the coupled model), float32, ndte=120, on the GPU;
``--ny``/``--nx`` default to the configuration's grid;
``--evp-algorithm pallas`` takes the fused EVP sweep (kernel evp_fused)
where the step does (not on the tripole seam). Prints one JSON line with

- ``phase_ms``: wall time per step phase of the eager step
  (``driver.step.step``; column physics, strength, EVP, transport,
  ridging, slab ocean, and the rest), each phase bracketed by
  ``torch.cuda.synchronize()`` so that its device work is inside it;
  ``column_ms`` splits the column physics the same way (radiation,
  vertical thermo; the rest of it is the tracers and the ITD; under the
  coupled radiation ordering the radiation runs after the dynamics and is
  a phase of its own). The phase wrappers patch module functions, so they
  time the eager step only;
- ``eager`` and ``graph``: the eager step and ``Model.rollout``, whose
  steps replay the step's CUDA graphs, each over ``--steps`` steps:
  ``ms_per_step`` (host clock, no syncs inside), and from
  ``torch.profiler`` device kernel time and kernels per step for each
  hand-written kernel and for all other (PyTorch) kernels, the device
  busy share of the wall time and the host syncs
  (``aten::_local_scalar_dense``) per step; for ``graph`` also the graph
  replays and loop flag reads per step, the graphs of the step's program
  and the host seconds their capture took;
- the thermo solver's passes (BL99 or mushy Picard, both stages) and the
  ridging passes of the last step.

It needs a CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

import torch

from cice5_tpu_torch.config import (auscom_025_config, bench_easy_config,
                                    gx1_parity_config, gx3_config)
from cice5_tpu_torch.driver import step as step_mod
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.grid import synth_gx1_grid

PHASES = {"_column_physics": "column_physics",
          "strength_rothrock": "strength", "evp": "evp", "evp_fused": "evp",
          "eap": "eap", "transport_remap": "transport",
          "transport_upwind": "transport", "ridge_ice": "ridging",
          "ocean_mixed_layer": "ocean"}
# inside _column_physics: reported apart, not added to phase_ms
COLUMN_PHASES = {"_step_radiation": "radiation",
                 "thermo_vertical": "vertical_thermo"}
# device kernel name -> wrapper; the EVP engine (csrc/evp_resident.cu)
# runs evp_sweep, or evp_fused on the fused path; remap_recon and
# remap_flux are the single-edge kernel's (csrc/remap_flux_edge.cu)
OWN_KERNELS = {"evp_resident": "evp_sweep",
               "remap_tiles": "remap_flux_both",
               "remap_recon": "remap_flux_edge",
               "remap_flux": "remap_flux_edge",
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


CONFIGS = {
    "bench_easy": bench_easy_config,
    "gx1_parity": gx1_parity_config,
    "gx1_topo": lambda: _with(gx1_parity_config(), tracers=dict(
        tr_pond_lvl=False, tr_pond_topo=True)),
    "gx1_tfold": gx1_tfold_config,
    "gx1_eap": gx1_eap_config,
    "bl99_upwind": lambda: _with(bench_easy_config(),
                                 dyn=dict(advection="upwind")),
    "gx3": gx3_config,
    "auscom_025": lambda: auscom_025_config(coupled_radiation=True),
}


def _timed_phases(totals, column, coupled_radiation=False):
    """Wrap the phase functions the step module calls so that each adds
    its synchronized wall time to ``totals`` (``column`` for the parts of
    the column physics; the radiation goes to ``totals`` under the coupled
    ordering, which runs it after the dynamics). Returns an undo
    function."""
    saved = []

    def wrap(owner, attr, label, acc):
        fn = getattr(owner, attr)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[label] += time.perf_counter() - t0
            return out
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    for attr, label in PHASES.items():
        owner = step_mod.ocean if attr == "ocean_mixed_layer" else step_mod
        wrap(owner, attr, label, totals)
    for attr, label in COLUMN_PHASES.items():
        owner = step_mod.vertical if attr == "thermo_vertical" else step_mod
        in_column = not (coupled_radiation and attr == "_step_radiation")
        wrap(owner, attr, label, column if in_column else totals)

    def undo():
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return undo


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
    st, _ = m.rollout(st, f, 2)         # the first call captures the graphs
    torch.cuda.synchronize()
    (g,) = m.graphs.values()

    def eager(st, n):
        for _ in range(n):
            st, diag = step_mod.step(st, f, *m.step_args)
        return st, diag

    totals, column = defaultdict(float), defaultdict(float)
    undo = _timed_phases(totals, column, cfg.coupled_radiation)
    try:
        t0 = time.perf_counter()
        st, _ = eager(st, args.steps)
        torch.cuda.synchronize()
        ms_synced = 1e3 * (time.perf_counter() - t0) / args.steps
    finally:
        undo()
    phase_ms = {k: 1e3 * v / args.steps for k, v in totals.items()}
    # the dynamics' cleanup_itd, aggregates and diagnostics
    phase_ms["rest"] = ms_synced - sum(phase_ms.values())
    column_ms = {k: 1e3 * v / args.steps for k, v in column.items()}
    column_ms["tracers_and_itd"] = phase_ms["column_physics"] \
        - sum(column_ms.values())

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

    _, eager_out = profiled(eager)
    replays, reads = g.replays, g.flag_reads
    diag, graph_out = profiled(lambda s, n: m.rollout(s, f, n))
    graph_out.update(
        replays_per_step=(g.replays - replays) / (2 * args.steps),
        flag_reads_per_step=(g.flag_reads - reads) / (2 * args.steps),
        graphs_captured=len(g.program), capture_seconds=g.capture_seconds)
    out = dict(
        config=args.config, evp_algorithm=args.evp_algorithm,
        grid=[args.ny, args.nx], steps=args.steps,
        card=torch.cuda.get_device_name(0),
        ms_per_step_phase_synced=ms_synced, phase_ms=phase_ms,
        column_ms=column_ms, eager=eager_out, graph=graph_out,
        thermo_passes_last_step=int(diag.niter_thermo),
        ridging_passes_last_step=int(diag.niter_ridge))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
