"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. Phases (any failure exits non-zero):

1. Print the card's name and power limit (nvidia-smi) and build every
   hand-written kernel from ``cice5_tpu_torch/csrc`` with nvcc, one
   process per library, all started together (kernel C twice: the
   default library of (nilyr, nslyr) = (4, 1) and (7, 1), and CESM2's
   (8, 3)); print ptxas's report of kernels B and E (one source) and C
   (registers, stack, spills of each instantiation) and fail if B or E
   spills or uses stack, or C spills.
2. Hold each kernel against its plain PyTorch version on the same CUDA
   tensors, at the shapes of the main paths (384x320), on inputs captured
   from one step of each model: the EVP sweep (float64 at ndte=1 and 120,
   float32 at 1 and 120) on the open-boundary BL99 grid and on the gx1
   tripole seam; the remap flux kernel B (float64 and float32, with an
   ice-free band so the skip path runs) with the BL99 tracer table (18
   tracers) and the gx1-parity one (19, pond chains of type 2 and 3),
   with its tile plan; the delta-Eddington kernel C (float64 and float32
   on the captured inputs at nilyr 4 and 7, float64 with seeded ponds
   under the level, cesm and topo pond setups; 5 categories, with an
   unlit band that must be exact zeros), every output field and every
   layer on its own scale; the fused EVP kernel (float64 and float32 at
   ndte=1 with kchunk=1 and ndte=120 with kchunk=10, on the BL99 inputs)
   against its plain version and against the EVP sweep kernel; the
   single-edge remap kernel E (both edges, float64 and float32, both
   tracer tables, with the ice-free band) against its plain version and
   against the same edge set of B, which must equal it bit for bit (E is
   B's one-edge mode: the same blocks, pipeline and per-edge code), with
   E's and B's times on the same inputs. Kernel and plain times come from CUDA
   events. Both EVP kernels are one engine (csrc/evp_resident.cu): its
   forced device-memory branch must equal the plain sweep bit for bit on
   the EVP sweep's inputs, and for each model the script prints the EVP
   tile plan and, from CUDA graph replays of one call as the step makes it
   (its replay must equal the eager call bit for bit), the per-subcycle
   cost and one grid barrier's cost. The times of A, B, C and D in the
   kernels line are such replays' device times (one call, argument
   packing included); the eager times, which include the host's launch
   gaps, are printed beside them. A (on the gx1 tripole inputs) and D (on
   the BL99 inputs) run again with the revised EVP's parameters
   (``revised_cap``: the step's own ``evp_params`` with
   ``revised_evp=True``, brlx from the grid's smallest spacing, revp=1),
   held at the same bounds, A with its plan and cost split.
3. Check the whole paths against the plain paths on small inputs: two
   float64 steps on the GPU (kernels) and on the CPU (plain versions)
   from one warmed-up state, for the BL99 model (with the EVP sweep, and
   with the fused EVP at ndte=10) and for the gx1-parity model on a small
   tripole grid whose land touches the seam; and on the GPU, each model's
   graph rollout (``Model.rollout`` replaying its CUDA graphs) against
   its eager step (``driver.step.step``) at 0.0 in every State and
   StepDiag field.
4. Drive the main paths through ``Model.init_state`` and ``rollout`` (CUDA
   graph replays after the first call's eager step and capture) with the
   health guards of ``bench.py`` and a per-step timing cross-check:
   the gx1-parity model (``gx1_parity_config()`` on ``synth_gx1_grid``,
   320x384, float32, ndte=120; 10 timed steps), the BL99 + CCSM3 model of
   slice 1 (5 timed steps), and the same model with
   ``evp_algorithm="pallas"`` (the fused EVP kernel, 12 launches per
   step; 5 timed steps). For each, the launch counters are set to 0 just
   before its timed rollout and read just after (each replay adds the
   launches its graphs' capture recorded). Then its ``graph`` phase: from
   the warmed-up state, 3 eager steps against a 3-step graph rollout, at
   0.0 in every State and StepDiag field (pass counts included), with
   both ms/step, the host syncs per step of each, and the graph replays
   and loop flag reads per step on one line.
5. Drive the gx1-parity main path through the run loop (``Model.run``,
   ``run_phase``): 8 steps with state checks, diagnostics, a history
   stream of every available field and restarts, launch counters set to
   0 just before and read just after; a restored run against the
   continuous one at 0.0 in every State field; the history files read
   back; ms/step of run with and without history beside rollout; and a
   small float64 run on the card against the CPU's history. One ``run:``
   JSON line.
6. Drive the coupled model (``driver.coupled.CoupledModel``) on the
   ACCESS-OM 0.25-degree configuration (``auscom_025_phase``:
   ``auscom_025_config(coupled_radiation=True)`` on ``synth_gx1_grid``,
   1080x1440, float32, ndte=120, the default 70N/60S ice edge), its
   callbacks handing NumPy host arrays in and out as an OASIS coupler
   does (built beforehand from the port's forcing of each step): 2
   warm-up coupled steps (the first an eager step and the capture), 4
   timed ones with the launch counters set to 0 just before and read just
   after (1 each of A, B and C per coupled step), the bench.py guards,
   ``Model.rollout`` over the same forcings (ms/step, and its state equal
   to the coupled run's at 0.0), ms per exchange (host to device of the
   inbound fields, device to host of the outbound ones), peak device
   memory beside the gx1-parity path's, the graph capture time; the graph
   step against the eager step at 0.0 (``graph_phase``, 2 steps); kernels
   A (device-memory branch), B and C against their plain versions on
   inputs captured at 1080x1440, with their times and bounds. One
   ``auscom_025:`` JSON line.
7. Hold A and D with a form-drag Cw plane (``neutral_drag_coeffs`` of the
   captured gx1-parity and BL99 states) against their plain versions (in
   phase 2's order), and run a small float64 coupled model with every
   coupled-mode option (coupled_radiation, formdrag, highfreq,
   fbot_xfer_type="Cdn_ocn") on the card and on the CPU within 3e-8 of
   scale, its graph rollout equal to the eager step at 0.0 and a restart
   after 2 steps through the graphs equal to the continuous run at 0.0.
8. The standalone configurations and the column options
   (``options_phase``): ``gx3_config`` and ``tp1_config`` at 116x100
   (nilyr=7, ndte=120, float32), each reading its grid through
   ``make_grid`` -> ``popgrid`` -> ``read_pop_grid_nc`` from a netCDF3
   file pair this phase writes to a temporary directory (the synthetic
   global mesh with the gx1 land mask resampled; the reference's
   global_gx3/global_tp1 files are not in the repository), driven
   through ``Model.run`` for 4 steps after 2 warm-up steps; the
   gx1-parity model with topographic ponds (``gx1_topo``, 384x320, kernel
   C under pond_scheme="topo") through ``Model.rollout``, 5 steps; the
   BL99 model at 384x320 with zero-layer thermo (``Model.rollout``, 5
   steps) and with the coupler's per-category surface fluxes
   (calc_Tsfc=False, ``CoupledModel`` with NumPy fluxes every step, 4
   steps). Each with the launch counters set to 0 just before its timed
   steps and read just after (A, B, and C where the path runs dEdd, once
   per step), the bench.py guards, ms/step, peak device memory, and the
   graph rollout against the eager step at 0.0; one JSON line each
   (``gx3:``, ``tp1:``, ``gx1_topo:``, ``bl99_options ktherm=0:``,
   ``bl99_options calc_Tsfc=False:``). Then A, B and C against their
   plain versions on inputs captured from gx3 and from gx1_topo, float64
   and float32 (C's float32 held to the plain float32's accuracy against
   float64), and every column option set of
   ``cice5_tpu_torch/small_sets.py`` (the sets tests/test_torch_options.py
   holds against the JAX step; 24x16, float64) on the card against the
   CPU within 3e-8 of scale, with its graph rollout equal to the eager
   step at 0.0.
9. The dynamics and transport options (``dynamics_phase``) at 384x320,
   ndte=120, float32: the gx1-parity model on a T-fold seam (tripoleT)
   with the transport conservation and monotonicity checks
   (``gx1_tfold``, ``Model.rollout``, 5 steps: A on the T-fold, B and C
   once per step; the count of monotonicity violations and the
   conservation error printed); the gx1-parity model with
   EAP rheology (kdyn=2) and the per-category mechred diagnostics
   (``gx1_eap``, ``Model.run``, 4 steps after 2, with a history stream of
   the EAP and mechred fields written once and read back: B and C once
   per step, A never; the PyTorch kernels per graph step under
   torch.profiler); the BL99 model with upwind transport
   (``bl99_upwind``, ``Model.rollout``, 5 steps: A once per step, B
   never). Each with the bench.py guards, ms/step, peak device memory and
   the graph rollout against the eager step at 0.0, one JSON line each
   (``gx1_tfold:``, ``gx1_eap:``, ``bl99_upwind:``). Then A against
   ``subcycle_sweep`` on inputs captured from gx1_tfold (float64 and
   float32, ndte 1 and 120, the shared and the forced device branch, the
   latter at 0.0), with its plan, per-subcycle cost and graph-replay time,
   also with the revised EVP's parameters;
   B against its plain version on the same inputs; and every dynamics
   option set of ``cice5_tpu_torch/small_sets.py`` (24x16, float64) on the
   card against the CPU within 3e-8 of scale, the EAP structure tensor
   included (EAP on the T-fold seam too), with its graph rollout equal to
   the eager step at 0.0.
10. The aerosol, brine and skeletal-BGC tracers (``tracer_phase``): the
   gx1-parity model with n_aero=3, the brine height and the nine BGC
   tracers (``gx1_bgc``, 384x320, float32, ndte=120, 39 tracers) through
   ``Model.run``, 4 steps after 2, with a history stream of the aerosol,
   brine and BGC fields written once and read back (the bio-grid fields
   on nilyr+2 levels): A, B and C once per step, the bench.py guards,
   every tracer finite, the aerosol and BGC concentrations >= 0 (to
   puny), the brine height ratio in (0, MAXHBR], primary production and
   an aerosol flux to the ocean, the PyTorch kernels per graph step, and
   the graph rollout against the eager step at 0.0; 4 more steps of
   ``Model.run`` with the ms per step split by part (graph replay, state
   check, history values, accumulation and file, the rest); one
   ``gx1_bgc:`` JSON line. Then B against its plain version on the
   gx1_bgc inputs (the 39-tracer table, float64 and float32) with its
   plan, time and bound, and each tracer set of
   ``cice5_tpu_torch/small_sets.py`` (24x16, float64) on the card against
   the CPU within 3e-8 of scale, first_ice
   and the aerosol and BGC fluxes included, with its graph rollout equal
   to the eager step at 0.0.
11. The gx1-parity main path driven by forcing files
   (``file_forcing_phase``, 384x320, float32, ndte=120): synthetic
   NCAR-layout files (12 monthly records of fsw, cldf and fsnow; the
   six-hourly records of Tair, uatm, vatm, Qa and rhoa of the first two
   days, the run starting on January 2 past the year seam) written to a
   temporary directory, ``Model.run`` with ``FileForcing.provider`` for 8
   steps after 2 with the bench.py guards, a state check every step and a
   2-D history stream written through ``write_ready(use_async=True)`` and
   read back; A, B and C once per step (launch counters set to 0 just
   before, read just after); ms/step of ``Model.run`` on the files beside
   the same run on the idealized forcing, in turns, and the forcing's own
   ms/step (record reads, interpolation, host-to-device copy, derivation
   on the card); a CICE 5 binary dump with its tracer files at step 4 of
   8 restored into a fresh Model, whose run equals the continuous run at
   0.0 in every State field the dump carries (all but mlt_onset), with
   the dump's bytes and write and read seconds; the run's 2-D history
   fields appended to the native asynchronous netCDF writer
   (``io/fastwriter.py``, built by g++ into ``build/``) and read back
   equal, ms per append beside a synchronous ``write_netcdf`` of the same
   fields; ``prescribe_ice`` on the state in float64 on the card against
   the CPU at 0.0. One ``file_forcing:`` JSON line.
12. CESM2's column (``cesm2_layers_phase``): ``gx1_parity_config(nilyr=8,
   nslyr=3)`` at 384x320, float32, ndte=120 (27 tracers) through
   ``Model.run`` with a history stream of every field, the layered 4Di
   and 4Ds ones among them (4 steps after 2: A, B and C once per step,
   launch counters set to 0 just before and read just after), the
   bench.py guards, peak memory, the graph rollout against the eager step
   at 0.0 and its ms/step; the history file read back on 8 ice and 3
   snow levels; a CICE 5 dump at step 2 of 4 restored into a fresh Model
   whose run equals the continuous one at 0.0; B on the 27-tracer table
   and C at 8/3 against their plain versions on the path's inputs (C in
   float64 within 1e-12 of scale, with level ponds too, every snow layer
   absorbing; in float32 no farther from float64 than the plain float32
   beyond DEDD_F32_TOL), with C's time, bound and resident blocks per SM;
   the small float64 ``cesm2_layers`` sets (mushy and BL99) on the card
   against the CPU. One ``cesm2_layers:`` JSON line.
13. The revised EVP and dynamics subcycling (``evp_options_phase``) at
   384x320, float32, ndte=120, each through ``Model.rollout`` (5 steps
   after 2) with the bench.py guards, the launch counters set to 0 just
   before and read just after, peak memory and the graph rollout against
   the eager step at 0.0: ``gx1_revp`` (gx1-parity with
   ``revised_evp=True``: A, B and C once per step) and ``gx1_ndtd2``
   (gx1-parity with ``ndtd=2``: A and B twice per step, C once), each with
   its ms per step and peak memory beside gx1-parity's, driven the same
   way just before them (``gx1_parity_beside``); and ``bl99_fused_revp``
   (the BL99 model at 384x320 with the fused EVP and the revised EVP: D
   12 times and B once per step); one JSON line each
   (``gx1_parity_beside:``, ``gx1_revp:``, ``gx1_ndtd2:``,
   ``bl99_fused_revp:``). Then every namelist option set of
   ``cice5_tpu_torch/small_sets.py`` (24x16, float64) on the card against
   the CPU within 3e-8 of scale (stresses 1e-5), from the frozen open sea
   of its reference where it has one and with the fields its option
   drives (``small_sets.FLAG_DRIVES``) compared too, with its graph
   rollout equal to the eager step at 0.0.
14. The multi-GPU path (``sharded_phase``), in spawned processes
   (``chip_smoke.py --sharded-rank`` / ``--nccl-rank``) whose output is
   printed here: 4 gloo ranks sharing the card on a 2x2 mesh run the
   gx1-parity model at 384x320 (float32, ndte=120, a 192x160 tile per
   rank) through ``ShardedModel.run`` (3 steps after a warm-up step, a
   diagnostics line and a state check each step) with the launch counters
   and the halo traffic set to 0 just before and read just after (B and C
   once per rank per step, A and D never: on a mesh the EVP runs the
   subcycle loop with one halo exchange per subcycle), the bench.py
   guards on the gathered state, a per-rank restart round trip at 0.0 and
   the gathered state against the one-device eager step (kernel A); the
   24x16 float64 gx1-parity model with land on the seam on the 2x2, 1x4
   and 4x1 meshes on the card against the CPU; one NCCL rank: the
   reductions and a 1x1-mesh step against ``Model``'s eager step at 0.0.
   One ``sharded:`` JSON line; four processes on one card are a
   correctness run, not a multi-GPU speed.
15. Print one JSON line with every kernel (launches from the gx1-parity
   main path, the fused kernel's from the fused path, and each path's
   launches per step, the sharded path's per rank; times on the
   gx1-parity inputs, the fused kernel's on the BL99 ones; A's T-fold
   and revised-EVP (gx1 tripole, T-fold), D's revised-EVP, B's gx1_bgc
   and cesm2_layers and C's cesm2_layers launches and times beside, E's
   beside B's on the same inputs), then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# hand count of the evp_sweep kernel's arithmetic per subcycle: strain
# rates 84, Delta 28, replacement pressure 17, stress relaxation 44,
# stress divergence 196 per region point; the momentum solve 45 per U point
EVP_FLOP_REGION, EVP_FLOP_U = 369, 45
# remap_flux_both: reconstruction 60 + 70 per tracer per cell; integrals
# about 320 + 30 per tracer + 200 per parent class per edge, both counted
# only where the data needs them (cells and edges with ice within reach)
RM_FLOP_CELL, RM_FLOP_CELL_TRACER = 60, 70
RM_FLOP_EDGE, RM_FLOP_EDGE_TRACER, RM_FLOP_EDGE_PARENT = 320, 30, 200
# shortwave_dedd per lit column (nilyr=4, nslyr=1), counting exp and sqrt
# as one operation: 30 layer-property sets (ice 4, snow 2, pond 4 per band)
# of ~480 each with the 8-point Gaussian re-integration (~14.4k), 6
# Fresnel layers (~0.2k), 9 adding sweeps with their interface fluxes
# (~3.1k over 7 layers), 9 snow-table lookups (~1.7k), partition and mix
# (~0.6k). Each further layer adds its step of the 9 sweeps and its
# partition terms (~450); more than one snow layer adds a third snow
# property set per band (3 x 480)
DEDD_OPS_LIT_COLUMN, DEDD_OPS_LAYER, DEDD_OPS_PROPS = 20000, 450, 480
# CESM2's sea-ice column: 8 ice and 3 snow layers (CICE 5.1.2 with mushy
# thermodynamics; Bailey et al. 2020, JAMES)
CESM2_LAYERS = (8, 3)
# float32 bound of shortwave_dedd against its plain version, each field on
# its own scale: ~3x the 1.6e-5 this script measured at 384x320
# (fswsfcn) on an NVIDIA H100 80GB HBM3 at 700 W
DEDD_F32_TOL = 5e-5


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_phase():
    """ptxas's report of kernels B and E (csrc/remap_tiles.cu: both edge
    sets, the north set, the east set) and C (csrc/shortwave_dedd.cu: the
    default library's (nilyr, nslyr) = (4, 1) and (7, 1), and each library
    built for another pair) from the build: registers, stack frame and
    spills of each instantiation. B and E must have no spills and no
    stack, C no spills."""
    import re
    from cice5_tpu_torch.ops import kernels
    c = kernels.KERNELS["shortwave_dedd"]
    for k, no_stack in ((kernels.KERNELS["remap_flux_both"], True),
                        *((v, False) for v in (c, *c.variants()))):
        entries = kernels.ptxas_entries(k.build_log)
        if not entries:
            fail(f"no ptxas report for {k.library.name}")
        for e in entries:
            t = re.search(r"I([fd])((?:Li\d+E)+)E", e["name"])
            if not t:
                fail(f"{k.library.name}: unexpected entry {e['name']}")
            dt = "f32" if t.group(1) == "f" else "f64"
            args = [int(a) for a in re.findall(r"Li(\d+)E", t.group(2))]
            tag = (f"{dt} nilyr={args[0]} nslyr={args[1]}" if len(args) == 2
                   else f"{dt} edges={('north', 'east', 'both')[args[0]]}")
            print(f"ptxas {k.library.name} {tag}: {e['registers']} "
                  f"registers, {e['stack']} B stack, {e['spill_stores']} B "
                  f"spill stores, {e['spill_loads']} B spill loads",
                  flush=True)
            if e["spill_stores"] or e["spill_loads"] or \
                    (no_stack and e["stack"]):
                fail(f"{k.library.name} {tag} spills or uses stack: {e}")


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_plan(kw):
    """The EVP kernels' device-memory branch forced on these inputs: tiles
    of at most 30x32 U points on a third of the card's SMs, so each block
    walks several tiles per subcycle (130 tiles on 44 blocks at 384x320
    on 132 SMs)."""
    from cice5_tpu_torch.ops import kernels
    from cice5_tpu_torch.ops.evp_resident import tile_plan
    (ny, nx), dtype = kw["uvel"].shape, kw["uvel"].dtype
    n_sm, smem = kernels.device_limits(kw["uvel"].device)
    return tile_plan(ny, nx, dtype, max(1, n_sm // 3), smem, "device")


def evp_phase(cap64, cap32, label):
    """Kernel A (evp_sweep) against subcycle_sweep on the card, each output
    (u, v, each stress component, each diagnostic) against its own scale.
    Built without FMA contraction, the kernel rounds as its plain version
    does, so float32 is held as tightly as float64 allows. The same inputs
    go through the kernel's device-memory branch (``device_plan``), which
    must equal the plain version bit for bit."""
    import torch
    from cice5_tpu_torch.models.dynamics import evp as tevp
    from cice5_tpu_torch.ops import check
    results, inexact = {}, []
    for tag, (p, _, topo, kw), ndte, tol in (
            ("f64 ndte=1", cap64, 1, 1e-12),
            ("f64 ndte=120", cap64, 120, 3e-8),
            ("f32 ndte=1", cap32, 1, 1e-6),
            ("f32 ndte=120", cap32, 120, 1e-5)):
        ref = check.evp_outputs(tevp.subcycle_sweep(p, ndte, topo, **kw))
        got = check.evp_outputs(tevp.evp_sweep(p, ndte, topo, **kw))
        dplan = device_plan(kw)
        dev = check.evp_outputs(check.evp_on_plan(p, ndte, topo, dplan,
                                                  **kw))
        torch.cuda.synchronize()
        field, rel, err = check.worst(check.field_errors(ref, got))
        _, _, err_dev = check.worst(check.field_errors(ref, dev))
        print(f"evp_sweep {label} {tag}: max abs diff {err:.3e}; worst field "
              f"{field}: rel diff {rel:.3e} (bound {tol:.0e} x the field's "
              f"scale); device-memory branch ({dplan.describe()}): max abs "
              f"diff {err_dev:.3e} (must be 0)")
        results[tag] = (err, rel, tol)
        if err_dev != 0.0:
            inexact.append(tag)
    bad = [t for t, (_, rel, tol) in results.items() if not rel <= tol]
    if bad:
        fail(f"evp_sweep disagrees with subcycle_sweep ({label}): {bad}")
    if inexact:
        fail(f"evp_sweep's device-memory branch differs from subcycle_sweep "
             f"({label}): {inexact}")
    p, ndte, topo, kw = cap32
    ms = cuda_time_ms(lambda: tevp.evp_sweep(p, ndte, topo, **kw), reps=20)
    plain_ms = cuda_time_ms(lambda: tevp.subcycle_sweep(p, ndte, topo, **kw),
                            reps=2)
    ny, nx = kw["uvel"].shape
    bound_ms, bound_by, what = evp_bound(kw, ndte)
    print(f"evp_sweep {label} f32 ndte={ndte} at {ny}x{nx}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({what})")
    return dict(err=results["f32 ndte=120"][0], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def graph_ms(fn, reps: int):
    """(ms per replay, outputs) of ``fn`` captured in one CUDA graph after
    a warm-up call on a side stream: the device time of the call without
    the host's launch gaps."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_time_ms(graph.replay, reps=reps), out


def evp_costs(cap32, label):
    """Kernel A's plan and cost split at the main path's shapes (f32), all
    device times of CUDA graph replays: one A call as the step makes it
    (``evp.evp_sweep``, argument packing included) at ndte=1 and ndte=120,
    whose difference over 119 is the cost of one subcycle; one grid
    barrier alone on the plan's blocks, split (the kernel's) and
    cooperative_groups' ``grid.sync()``; the device-memory branch. The
    ndte=120 replay must equal the eager call bit for bit. Returns the
    ndte=120 replay's ms."""
    from cice5_tpu_torch.models.dynamics import evp as tevp
    from cice5_tpu_torch.ops import check, kernels
    p, ndte, topo, kw = cap32
    (ny, nx), dtype = kw["uvel"].shape, kw["uvel"].dtype
    plan = kernels.evp_plan(ny, nx, dtype, kw["uvel"].device)
    print(f"evp plan {label} f32 {ny}x{nx}: {plan.describe()}; grid "
          f"barriers per call: evp_sweep {plan.barriers(ndte, True)} "
          f"(ndte={ndte}), evp_fused {plan.barriers(10, False)} per launch "
          f"of 10 subcycles", flush=True)
    eager = tevp.evp_sweep(p, ndte, topo, **kw)
    t = {}
    for n in (1, ndte):
        t[n], out = graph_ms(lambda n=n: tevp.evp_sweep(p, n, topo, **kw),
                             reps=50)
    _, _, err = check.worst(check.field_errors(check.evp_outputs(eager),
                                               check.evp_outputs(out)))
    if err != 0.0:
        fail(f"evp_sweep's CUDA graph replay differs from the eager call "
             f"({label}): {err:.3e}")
    per_sub = (t[ndte] - t[1]) / (ndte - 1) * 1e3
    bar = {}
    for split in (True, False):
        tb = {n: cuda_time_ms(lambda n=n: kernels.evp_barriers(
            plan.blocks, n, split), reps=20) for n in (1, ndte + 1)}
        bar[split] = (tb[ndte + 1] - tb[1]) / ndte * 1e3
    dplan = device_plan(kw)
    t_dev, _ = graph_ms(lambda: check.evp_on_plan(p, ndte, topo, dplan,
                                                  **kw), reps=10)
    print(f"evp_sweep {label} f32 cost split (CUDA graph replays): ndte=1 "
          f"{t[1]:.4f} ms, ndte={ndte} {t[ndte]:.4f} ms (bit-equal to the "
          f"eager call), per subcycle {per_sub:.3f} us; one grid barrier "
          f"alone on {plan.blocks} blocks: split {bar[True]:.3f} us "
          f"({100 * bar[True] / per_sub:.1f}% of a subcycle), "
          f"cooperative_groups grid.sync() {bar[False]:.3f} us; "
          f"device-memory branch ({dplan.describe()}) ndte={ndte} "
          f"{t_dev:.4f} ms", flush=True)
    return t[ndte]


def evp_bound(kw, ndte):
    """(bound ms, "bytes"/"operations", text) of an ndte-subcycle float32
    EVP sweep on these inputs: each input read once, each output written
    once, and the hand-counted flops of every subcycle."""
    ny, nx = kw["uvel"].shape
    nreg, nu = (ny + 1) * (nx + 1), ny * nx
    nbytes = 4 * ((2 + 13) * nu + (12 + 2 + 10) * nreg      # inputs
                  + (2 + 2) * nu + (12 + 5) * nreg)          # outputs
    flops = ndte * (EVP_FLOP_REGION * nreg + EVP_FLOP_U * nu)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP")


def revised_cap(captured):
    """The EVP sweep arguments (p, ndte, topo, kw) of ``capture``'s result
    with the parameters that the step passes with ``revised_evp=True``
    (``driver.step.evp_params``: Bouillon et al. 2013, CICE 5.1's
    ice_dyn_shared.F90:230-240; brlx from the grid's smallest ocean
    spacing and revp=1) in place of the classic ones."""
    from cice5_tpu_torch.driver.step import evp_params
    from cice5_tpu_torch.small_sets import with_
    grid, args, _, cfg = captured
    _, ndte, topo, kw = args["evp"]
    p = evp_params(with_(cfg, dyn=dict(revised_evp=True)), grid, topo)
    return p, ndte, topo, kw


def revised_evp_phase(cap64, cap32, label):
    """Kernel A with the revised EVP's parameters (``revised_cap``) on the
    inputs of ``label`` that ``capture`` returned, float64 and float32:
    ``evp_phase`` (against subcycle_sweep at the classic run's bounds,
    and the forced device-memory branch at 0.0) and ``evp_costs`` (plan,
    cost split, the CUDA graph replay bit-equal to the eager call).
    Returns evp_phase's result with the replay's ms as ``ms`` and the
    eager ms beside."""
    rev64, rev32 = revised_cap(cap64), revised_cap(cap32)
    classic = cap32[1]["evp"][0]
    print(f"evp_sweep {label} revised EVP: brlx {rev32[0].brlx:.6e} (classic "
          f"{classic.brlx:.6e}), revp {rev32[0].revp}, arlx1i "
          f"{rev32[0].arlx1i:.6e}", flush=True)
    a = evp_phase(rev64, rev32, f"{label} revised EVP")
    a["eager_ms"], a["ms"] = a["ms"], evp_costs(rev32,
                                                f"{label} revised EVP")
    a["brlx"] = rev32[0].brlx
    return a


def evp_fused_phase(cap64, cap32, label="BL99"):
    """Kernel D (evp_fused, ndte/kchunk cooperative launches of kchunk
    subcycles) against its plain version fused_sweep_plain (nwin=4
    Y-windows) and against kernel A on the same captured inputs of the
    open-boundary BL99 grid (``label``: with the revised EVP's parameters
    too), each output against its own scale. D is the same function as A
    run by the same kernel (csrc/evp_resident.cu), so it is held with A's
    bounds and must equal A bit for bit."""
    import torch
    from cice5_tpu_torch.models.dynamics import evp as tevp
    from cice5_tpu_torch.ops import check
    from cice5_tpu_torch.ops import evp_fused as tfused
    results, bad = {}, []
    for tag, (p, _, topo, kw), ndte, kchunk, tol in (
            ("f64 ndte=1", cap64, 1, 1, 1e-12),
            ("f64 ndte=120", cap64, 120, 10, 3e-8),
            ("f32 ndte=1", cap32, 1, 1, 1e-6),
            ("f32 ndte=120", cap32, 120, 10, 1e-5)):
        sw = dict(kchunk=kchunk, nwin=4, **kw)
        got = check.evp_outputs(tfused.fused_sweep(p, ndte, topo, **sw))
        plain = check.evp_outputs(tfused.fused_sweep_plain(p, ndte, topo,
                                                           **sw))
        a = check.evp_outputs(tevp.evp_sweep(p, ndte, topo, **kw))
        torch.cuda.synchronize()
        fp, rp, ep = check.worst(check.field_errors(plain, got))
        fa, ra, ea = check.worst(check.field_errors(a, got))
        print(f"evp_fused {label} {tag} kchunk={kchunk}: vs fused_sweep_plain "
              f"max abs diff {ep:.3e}, worst field {fp}: rel diff {rp:.3e}; "
              f"vs evp_sweep max abs diff {ea:.3e}, worst field {fa}: rel "
              f"diff {ra:.3e} (bound {tol:.0e} x the field's scale)")
        results[tag] = ep
        # one engine (csrc/evp_resident.cu) runs both: D equals A exactly
        if not (rp <= tol and ra <= tol and ea == 0.0):
            bad.append(tag)
    if bad:
        fail(f"evp_fused disagrees with its plain version or evp_sweep "
             f"({label}): {bad}")
    p, ndte, topo, kw = cap32
    sw = dict(kchunk=10, nwin=4, **kw)
    ms = cuda_time_ms(lambda: tfused.fused_sweep(p, ndte, topo, **sw),
                      reps=20)
    plain_ms = cuda_time_ms(
        lambda: tfused.fused_sweep_plain(p, ndte, topo, **sw), reps=2)
    a_ms = cuda_time_ms(lambda: tevp.evp_sweep(p, ndte, topo, **kw),
                        reps=20)
    g_ms, _ = graph_ms(lambda: tfused.fused_sweep(p, ndte, topo, **sw),
                       reps=20)
    ga_ms, _ = graph_ms(lambda: tevp.evp_sweep(p, ndte, topo, **kw), reps=20)
    ny, nx = kw["uvel"].shape
    bound_ms, bound_by, what = evp_bound(kw, ndte)
    print(f"evp_fused {label} f32 ndte={ndte} kchunk=10 at {ny}x{nx}: kernel "
          f"{ms:.3f} ms ({ndte // 10} launches), in a CUDA graph {g_ms:.4f} "
          f"ms; plain {plain_ms:.3f} ms; evp_sweep on the same inputs "
          f"{a_ms:.3f} ms, in a CUDA graph {ga_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({what}, the work of evp_sweep)")
    return dict(err=results["f32 ndte=120"], ms=g_ms, eager_ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def remap_args_with_band(args):
    """The captured remap_flux_both arguments with the mass field zeroed
    over the southern third, so whole tiles hold no ice and skip."""
    geomN, geomE, mmE2, tmE2, hmE2, tt, par, ny, nx = args
    mm = mmE2.clone()
    mm[:, : (ny + 4) // 3] = 0.0
    return (geomN, geomE, mm, tmE2, hmE2, tt, par, ny, nx)


def _upcast(x):
    """Floating tensors of (nested tuples of) ``x`` in float64."""
    import torch
    if isinstance(x, tuple):
        return tuple(_upcast(y) for y in x)
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def remap_phase(args64, args32, grid64, grid32, label, f32_update="plain"):
    """Kernel B (remap_flux_both) against remap_flux_plain on the card:
    the fluxes, and the remapped fields after the divergence update (the
    quantities tests/test_remap_pallas.py holds at 2e-5 in float32). With
    ``f32_update="accuracy"`` the float32 remapped fields are held instead
    to the plain float32's accuracy: no farther from the float64 update of
    the same inputs than the plain version's, beyond 2e-5 of each field's
    scale (on the T-fold inputs the type-3 pond tracers' float32 update
    parts from float64 by ~2e-4 of scale, kernel and plain alike; ROADMAP
    section C). Prints B's plan and times one call eagerly and as a CUDA
    graph replay (the device time without the host's launch gaps; it must
    equal the eager call bit for bit)."""
    import torch
    from cice5_tpu_torch.models.transport import remap as trm
    from cice5_tpu_torch.ops import check, remap_tiles
    errs, bad = {}, False
    for tag, args, grid, tol, tol_upd in (
            ("f64", args64, grid64, 1e-12, 1e-12),
            ("f32", args32, grid32, 1e-5, 2e-5)):
        args = remap_args_with_band(args)
        ref = trm.remap_flux_plain(*args)
        got = trm.remap_flux_both(*args)
        torch.cuda.synchronize()
        field, rel, err = check.worst(check.field_errors(
            check.remap_outputs(ref), check.remap_outputs(got)))
        # north-edge rows whose W=2 window lies inside the ice-free band
        nz = (args[-2] + 4) // 3 - 4
        skipped = bool((got[0][:, :nz] == 0).all()
                       and (got[1][:, :, :nz] == 0).all())
        mm, tm = args[2][:, 2:-2, 2:-2], args[3][:, :, 2:-2, 2:-2]
        upd = [trm._update(grid, mm=mm, tm=tm, fn_mflx=f[0], fn_mtflx=f[1],
                           fe_mflx=f[2], fe_mtflx=f[3], tracer_type=args[5],
                           parent=args[6]) for f in (ref, got)]
        # remapped fields, each tracer against its own scale (the 2e-5 of
        # tests/test_remap_pallas.py is for O(1) fields)
        field_u, rel_u, _ = check.worst(check.field_errors(
            dict(mm=upd[0][0], tm=upd[0][1]), dict(mm=upd[1][0],
                                                   tm=upd[1][1]),
            axes={"tm": 1}))
        accuracy = ""
        ok_u = rel_u <= tol_upd
        if tag == "f32":
            a64 = _upcast(args)
            f64 = trm.remap_flux_plain(*a64)
            truth = trm._update(grid64, mm=a64[2][:, 2:-2, 2:-2],
                                tm=a64[3][:, :, 2:-2, 2:-2],
                                fn_mflx=f64[0], fn_mtflx=f64[1],
                                fe_mflx=f64[2], fe_mtflx=f64[3],
                                tracer_type=args[5], parent=args[6])
            dist = [check.field_errors(
                dict(mm=truth[0], tm=truth[1]), dict(mm=u[0], tm=u[1]),
                axes={"tm": 1}) for u in upd]
            # how much farther from float64 the kernel's update is than
            # the plain one's, each field on its own scale
            excess = max(((k, dist[1][k][1] - dist[0][k][1])
                          for k in dist[0]), key=lambda kv: kv[1])
            plain_acc = check.worst(dist[0])
            accuracy = (f"; float32 update against float64: plain worst "
                        f"{plain_acc[0]} {plain_acc[1]:.3e}, kernel farther "
                        f"by at most {excess[1]:.3e} of scale ({excess[0]}"
                        f"{'; bound 2e-05' if f32_update == 'accuracy' else ''})")
            if f32_update == "accuracy":
                ok_u = excess[1] <= tol_upd
        print(f"remap_flux_both {label} {tag}: fluxes max abs diff "
              f"{err:.3e}; worst "
              f"flux {field}: rel diff {rel:.3e} (bound {tol:.0e} x the "
              f"field's scale); worst remapped field {field_u}: rel diff "
              f"{rel_u:.3e} (bound {tol_upd:.0e} x the field's scale"
              f"{', not held: accuracy below' if f32_update == 'accuracy' and tag == 'f32' else ''}); "
              f"ice-free tiles exact zeros: {skipped}{accuracy}")
        errs[tag] = err
        bad = bad or not (rel <= tol and ok_u and skipped)
    if bad:
        fail(f"remap_flux_both disagrees with remap_flux_plain ({label})")
    args = args32
    geomN, geomE, mmE2, tmE2, hmE2, tt, par, ny, nx = args
    ncat, ntrace = tmE2.shape[:2]
    for dt, a in (("f32", args32), ("f64", args64)):
        plan = remap_tiles.plan(ny, nx, ncat, tt, par, a[2].dtype.itemsize)
        print(f"remap_flux_both plan {label} {dt} {ny}x{nx}: "
              f"{plan.describe()}; 1 launch per call", flush=True)
    eager = trm.remap_flux_both(*args)
    ms = cuda_time_ms(lambda: trm.remap_flux_both(*args), reps=20)
    g_ms, out = graph_ms(lambda: trm.remap_flux_both(*args), reps=50)
    if not all(torch.equal(x, y) for x, y in zip(eager, out)):
        fail(f"remap_flux_both's CUDA graph replay differs from the eager "
             f"call ({label})")
    plain_ms = cuda_time_ms(lambda: trm.remap_flux_plain(*args), reps=3)
    bound_ms, bound_by, what = remap_bound(args, ("north", "east"))
    print(f"remap_flux_both {label} f32 at {ny}x{nx}, ncat={ncat}, "
          f"ntrace={ntrace}: kernel {g_ms:.4f} ms in a CUDA graph (eager "
          f"{ms:.4f} ms), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({what})", flush=True)
    return dict(err=errs["f32"], ms=g_ms, eager_ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def remap_bound(args, edges):
    """(bound ms, "bytes"/"operations", text) of the float32 remap flux
    kernel on these inputs for the given edge sets: the fluxes written
    once, the raw mass field read once, and where ice is within reach (a
    cell whose 5x5 raw neighbourhood, the W=2 window every flux through it
    reads, holds ice in the category) the raw tracers, and in any category
    the ocean mask and each edge set's geometry, read once; the
    hand-counted flops counted the same way. A cell out of reach of ice
    only gives exact zeros, whatever implements the function."""
    import torch
    geomN, geomE, mmE2, tmE2, hmE2, tt, par, ny, nx = args
    ncat, ntrace = tmE2.shape[:2]
    nedge = sum((ny + 1) * nx if e == "north" else ny * (nx + 1)
                for e in edges)
    lit = torch.nn.functional.max_pool2d(
        (mmE2 != 0).float()[:, None], 5, stride=1)[:, 0]     # (ncat,ny,nx)
    nlit = float(lit.sum())
    nlit_any = float(lit.amax(0).sum())
    nbytes = 4 * (mmE2.numel() + ntrace * nlit + nlit_any    # raw fields
                  + 48 * len(edges) * nlit_any               # geometry
                  + ncat * (1 + ntrace) * nedge)             # fluxes
    nparent = len({q for q, t in zip(par, tt) if t == 2})
    flops = nlit * (RM_FLOP_CELL + RM_FLOP_CELL_TRACER * ntrace) \
        + len(edges) * nlit * (RM_FLOP_EDGE + RM_FLOP_EDGE_TRACER * ntrace
                               + RM_FLOP_EDGE_PARENT * nparent)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP")


def remap_edge_phase(args64, args32, label):
    """Kernel E (remap_flux_edge: the reconstruction and ONE edge set's
    integrals, the one-edge mode of csrc/remap_tiles.cu) against its plain
    version remap_flux_edge_plain and against the same edge set of kernel
    B, for both edges, with the ice-free band, each flux against its own
    scale. E runs B's blocks and pipeline and computes each edge with B's
    code, so B's half must equal E bit for bit. Times E's north edges
    and B's two sets on the same float32 inputs as CUDA graph replays, in
    turns (E, B, B, E)."""
    import torch
    from cice5_tpu_torch.models.transport import remap as trm
    from cice5_tpu_torch.ops import check
    names, axes = ("mflx", "mtflx"), {"mtflx": 1}
    errs, bad = {}, []
    for tag, args, tol in (("f64", args64, 1e-12), ("f32", args32, 1e-5)):
        args = remap_args_with_band(args)
        geomN, geomE, mm, tm, hm, tt, par, ny, nx = args
        both = trm.remap_flux_both(*args)
        for edge, geom, half in (("north", geomN, both[:2]),
                                 ("east", geomE, both[2:])):
            call = (edge, geom, mm, tm, hm, tt, par, ny, nx)
            got = dict(zip(names, trm.remap_flux_edge(*call)))
            plain = dict(zip(names, trm.remap_flux_edge_plain(*call)))
            torch.cuda.synchronize()
            fp, rp, ep = check.worst(check.field_errors(plain, got, axes))
            fb, rb, eb = check.worst(check.field_errors(
                dict(zip(names, half)), got, axes))
            print(f"remap_flux_edge {label} {tag} {edge}: vs "
                  f"remap_flux_edge_plain max abs diff {ep:.3e}, worst flux "
                  f"{fp}: rel diff {rp:.3e} (bound {tol:.0e} x the flux's "
                  f"scale); vs remap_flux_both's {edge} half max abs diff "
                  f"{eb:.3e} (worst {fb}: rel {rb:.3e})")
            errs[(tag, edge)] = ep
            if not (rp <= tol and eb == 0.0):
                bad.append(f"{tag} {edge}")
    if bad:
        fail(f"remap_flux_edge disagrees with its plain version or with "
             f"B's half ({label}): {bad}")
    geomN, geomE, mm, tm, hm, tt, par, ny, nx = args32
    call = ("north", geomN, mm, tm, hm, tt, par, ny, nx)
    ms = cuda_time_ms(lambda: trm.remap_flux_edge(*call), reps=10)
    times = {"E north": [], "E east": [], "B": []}
    fns = {"E north": lambda: trm.remap_flux_edge(*call),
           "E east": lambda: trm.remap_flux_edge(
               "east", geomE, mm, tm, hm, tt, par, ny, nx),
           "B": lambda: trm.remap_flux_both(*args32)}
    for k in ("E north", "E east", "B", "B", "E east", "E north"):
        times[k].append(graph_ms(fns[k], reps=50)[0])
    g = {k: min(v) for k, v in times.items()}
    plain_ms = cuda_time_ms(lambda: trm.remap_flux_edge_plain(*call), reps=3)
    bound_ms, bound_by, what = remap_bound(args32, ("north",))
    print(f"remap_flux_edge {label} f32 at {ny}x{nx}: north edges "
          f"{g['E north']:.4f} ms in a CUDA graph (eager {ms:.4f} ms), east "
          f"edges {g['E east']:.4f} ms, B (both sets, same inputs) "
          f"{g['B']:.4f} ms (replays in turns: {json.dumps(times)}); plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({what})", flush=True)
    return dict(err=max(errs[("f32", e)] for e in ("north", "east")),
                ms=g["E north"], eager_ms=ms, east_ms=g["E east"],
                b_ms=g["B"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def small_reference_check(evp_algorithm="auto", ndte=8):
    """The whole path through the kernels on the GPU against the plain
    versions on the CPU: a 16x32 float64 model, one warm-up step on the
    CPU, then two steps on each device from that state. (From rest the
    first EVP step turns the rounding noise of the strain rates of a
    uniform flow into stress, c0 = strength / tinyarea, so a 1-ulp
    difference between the devices' exp() grows to ~1e-5 there; from a
    moving state the step is well conditioned.) ``evp_algorithm="pallas"``
    checks the fused-EVP path the same way."""
    import dataclasses
    import torch
    from cice5_tpu_torch.config import bench_easy_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.ops import check
    cfg = bench_easy_config(ny=16, nx=32, ndte=ndte, dtype="float64")
    cfg = cfg.replace(dyn=dataclasses.replace(cfg.dyn,
                                              evp_algorithm=evp_algorithm))
    mc, mg = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    st = mc.init_state(ice_mask=mc.grid.tmask)
    f = mc.forcing_at(0)
    st, _ = mc.step(st, f)
    names = ("aicen", "vicen", "vsnon", "trcrn", "uvel", "vvel", "sst")
    ref, got = (mc.rollout(st, f, 2)[0],
                mg.rollout(st.to("cuda"), f.to("cuda"), 2)[0])
    torch.cuda.synchronize()
    graph_against_eager(mg, st.to("cuda"), f.to("cuda"),
                        f"small float64 run ({evp_algorithm})")
    field, rel, err = check.worst(check.field_errors(
        {k: getattr(ref, k) for k in names},
        {k: getattr(got, k).cpu() for k in names}, axes={"trcrn": 1}))
    print(f"small float64 run (16x32, evp_algorithm={evp_algorithm}, "
          f"ndte={ndte}, 2 steps after a warm-up step): GPU kernels vs CPU "
          f"plain max abs diff {err:.3e}; worst field {field}: rel diff "
          f"{rel:.3e} (bound 3e-8 x the field's scale)")
    if not rel <= 3e-8:
        fail(f"small float64 run ({evp_algorithm}): {field} on the GPU "
             f"differs from the CPU by {rel:.3e} of its scale (> 3e-8)")


def graph_against_eager(m, st, f, label, nsteps=2):
    """``nsteps`` of ``m.rollout`` (graph replays: ``m`` has captured its
    step) against as many eager steps on the GPU: every State and StepDiag
    field at 0.0, pass counts included."""
    import torch
    from cice5_tpu_torch.driver.step import step as step_fn
    ref = (st, None)
    for _ in range(nsteps):
        ref = step_fn(ref[0], f, *m.step_args)
    got = m.rollout(st, f, nsteps)
    torch.cuda.synchronize()
    diff = state_and_diag_differences(ref, got)
    print(f"{label}: graph rollout vs eager steps on the GPU ({nsteps} "
          f"steps): fields that differ {diff or 'none'}")
    if diff:
        fail(f"{label}: the graph rollout differs from the eager step: "
             f"{diff}")


def dedd_args_with_band(kw):
    """The captured shortwave_dEdd_ncat arguments with an ice-free band
    (the first eighth of the longitudes) and a dark band (coszen <= 0 over
    the next eighth) cut across the sunlit ice, so the kernel's unlit path
    runs on columns that would otherwise be lit."""
    kw = dict(kw)
    nx = kw["aicen"].shape[2]
    kw["aicen"] = kw["aicen"].clone()
    kw["aicen"][:, :, : nx // 8] = 0.0
    kw["coszen"] = kw["coszen"].clone()
    kw["coszen"][:, nx // 8: nx // 4] = -0.1
    return kw


def with_ponds(kw, seed=5):
    """The arguments with ponds on every ice column (apnd 0.05-0.6, hpnd
    0-0.4 m, some below the depth that counts), drawn from a seed, so each
    pond setup of the kernel has ponds to work on."""
    import torch
    a = kw["aicen"]
    gen = torch.Generator(device=a.device).manual_seed(seed)
    u = lambda lo, hi: torch.where(a > 0, lo + (hi - lo) * torch.rand(
        a.shape, generator=gen, device=a.device, dtype=a.dtype), 0.0)
    return dict(kw, apnd=u(0.05, 0.6), hpnd=u(0.0, 0.4))


def dedd_lit(kw):
    """The lit (category, cell) columns: aicen, net SW and coszen above
    puny (dedd.py:shortwave_dEdd)."""
    from cice5_tpu_torch import constants as ct
    netsw = kw["swvdr"] + kw["swvdf"] + kw["swidr"] + kw["swidf"]
    return ((kw["aicen"] > ct.puny) & (netsw > ct.puny)[None]
            & (kw["coszen"] > ct.puny)[None])


def dedd_phase(kw64, kw32):
    """Kernel C (shortwave_dedd) against shortwave_dEdd_plain on the card:
    each of the 14 output planes, and each layer of Sswabsn/Iswabsn/
    fswpenln, against its own scale; every unlit column (aicen, net SW or
    coszen at or below puny) exactly zero; at nilyr 4 (the model's) and 7.
    Times one call eagerly and as a CUDA graph replay (which must equal
    the eager call bit for bit)."""
    import torch
    from cice5_tpu_torch.models.radiation import dedd
    from cice5_tpu_torch.ops import check
    errs, bad = {}, []
    # the captured inputs at nilyr 4 and 7, then each pond setup (the
    # model sends level ponds) in float64 with ponds on every ice column
    for tag, kw, tol in (
            ("f64", kw64, 1e-12), ("f32", kw32, DEDD_F32_TOL),
            ("f64 nilyr=7", dict(kw64, nilyr=7), 1e-12),
            ("f32 nilyr=7", dict(kw32, nilyr=7), DEDD_F32_TOL),
            *((f"f64 {s} ponds", with_ponds(dict(kw64, pond_scheme=s)),
               1e-12) for s in ("lvl", "cesm", "topo"))):
        kw = dedd_args_with_band(kw)
        ref = dedd.shortwave_dEdd_plain(**kw)
        got = dedd.shortwave_dEdd_ncat(**kw)
        torch.cuda.synchronize()
        if "ponds" in tag and not float(ref.albpndn.max()) > 0.0:
            fail(f"shortwave_dedd {tag}: no pond albedo, ponds not exercised")
        field, rel, err = check.worst(check.field_errors(
            ref._asdict(), got._asdict()))
        lit = dedd_lit(kw)
        dark = bool(all(((x if x.dim() == 3 else x.movedim(1, 0))[
            ..., ~lit] == 0).all() for x in got))
        print(f"shortwave_dedd {tag}: max abs diff {err:.3e}; worst field "
              f"{field}: rel diff {rel:.3e} (bound {tol:.0e} x the field's "
              f"scale); lit columns {int(lit.sum())} of {lit.numel()}; "
              f"unlit columns exact zeros: {dark}")
        errs[tag] = err
        if not (rel <= tol and dark):
            bad.append(tag)
    if bad:
        fail(f"shortwave_dedd disagrees with shortwave_dEdd_plain: {bad}")
    kw = kw32
    eager = dedd.shortwave_dEdd_ncat(**kw)
    ms = cuda_time_ms(lambda: dedd.shortwave_dEdd_ncat(**kw), reps=20)
    g_ms, out = graph_ms(lambda: dedd.shortwave_dEdd_ncat(**kw), reps=50)
    if not all(torch.equal(x, y) for x, y in zip(eager, out)):
        fail("shortwave_dedd's CUDA graph replay differs from the eager call")
    plain_ms = cuda_time_ms(lambda: dedd.shortwave_dEdd_plain(**kw), reps=2)
    ncat, ny, nx = kw["aicen"].shape
    bounds = {n: dedd_bound(dict(kw, nilyr=n)) for n in (4, 7)}
    g7_ms, _ = graph_ms(lambda: dedd.shortwave_dEdd_ncat(**dict(kw, nilyr=7)),
                        reps=50)
    bound_ms, bound_by, what = bounds[kw["nilyr"]]
    print(f"shortwave_dedd f32 at {ny}x{nx}, ncat={ncat}, nilyr="
          f"{kw['nilyr']}: kernel {g_ms:.4f} ms in a CUDA graph (eager "
          f"{ms:.4f} ms), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({what}); the same inputs at nilyr=7: kernel {g7_ms:.4f} ms in "
          f"a CUDA graph, bound {bounds[7][0]:.4f} ms ({bounds[7][2]})",
          flush=True)
    return dict(err=errs["f32"], ms=g_ms, eager_ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def dedd_bound(kw):
    """(bound ms, "bytes"/"operations", text) of the float32 dEdd kernel
    on these inputs at their nilyr and nslyr: every column reads aicen and
    writes all its planes, every cell reads coszen and the four shortwave
    planes; only a lit column reads the other five category inputs, and
    only a cell with one reads fnidr. Operations: DEDD_OPS_LIT_COLUMN per
    lit column at 4/1, DEDD_OPS_LAYER per further layer, and with more
    than one snow layer the third snow property set of each band."""
    ncat, ny, nx = kw["aicen"].shape
    nilyr, nslyr = kw["nilyr"], kw["nslyr"]
    nout = 11 + nslyr + 2 * nilyr + 1
    lit = dedd_lit(kw)
    nlit, nlit_cells = int(lit.sum()), int(lit.any(0).sum())
    nbytes = 4 * (ncat * ny * nx * (1 + nout) + 5 * ny * nx + 5 * nlit
                  + nlit_cells)
    ops = (DEDD_OPS_LIT_COLUMN + DEDD_OPS_LAYER * (nilyr + nslyr - 5)
           + (3 * DEDD_OPS_PROPS if nslyr > 1 else 0)) * nlit
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            f"{nbytes / 1e6:.1f} MB, {nlit} lit columns in groups of 10, "
            f"{ops / 1e9:.3f} G operations")


def small_parity_grid(cfg, device):
    """A small global tripole grid (the mesh of synth_gx1_grid at cfg's
    shape) whose land touches the seam off its fold symmetry."""
    import numpy as np
    from cice5_tpu_torch.grid import popgrid_np, synth_global_arrays
    kmt = np.ones((cfg.grid.ny, cfg.grid.nx), np.int32)
    kmt[:2] = 0
    kmt[-1, 3:6] = 0
    kmt[-2, 4] = 0
    kmt[-1, 11] = 0
    return popgrid_np(cfg, *synth_global_arrays(kmt), device=device)


def parity_reference_check():
    """The gx1-parity path through the kernels on the GPU against the plain
    versions on the CPU: 24x16 float64 on a small tripole grid with land
    on the seam, ndte=8, a northern-summer noon with rain on the ice (so
    the pond lid's "no fresh water" test never rests on rounding noise),
    one warm-up step on the CPU, then two steps on each device. Tracers
    are compared as conserved amounts (weight x value)."""
    import dataclasses
    import torch
    from cice5_tpu_torch.config import gx1_parity_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.models.thermo.itd import tracer_weights
    from cice5_tpu_torch.ops import check
    cfg = gx1_parity_config()
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=24, nx=16),
                      dyn=dataclasses.replace(cfg.dyn, ndte=8),
                      dtype="float64", accum_dtype="float64")
    mc = Model(cfg, grid=small_parity_grid(cfg, "cpu"), device="cpu")
    mg = Model(cfg, grid=small_parity_grid(cfg, "cpu"), device="cuda")
    st = mc.init_state()
    f = mc.forcing_at(172 * 24 + 12)
    f = f.replace(frain=torch.full_like(f.frain, 2.0e-5))
    st, _ = mc.step(st, f)
    ref, got = (mc.rollout(st, f, 2)[0],
                mg.rollout(st.to("cuda"), f.to("cuda"), 2)[0].to("cpu"))
    torch.cuda.synchronize()
    graph_against_eager(mg, st.to("cuda"), f.to("cuda"),
                        "small float64 gx1-parity run")
    names = ("aicen", "vicen", "vsnon", "uvel", "vvel", "sst")
    amount = lambda s: tracer_weights(mc.tr, s.aicen, s.vicen, s.vsnon,
                                      s.trcrn) * s.trcrn
    r = {k: getattr(ref, k) for k in names}
    g = {k: getattr(got, k) for k in names}
    r["trcrn_amount"], g["trcrn_amount"] = amount(ref), amount(got)
    field, rel, err = check.worst(check.field_errors(
        r, g, axes={"trcrn_amount": 1}))
    print(f"small float64 gx1-parity run (24x16 tripole, land on the seam, "
          f"ndte=8, 2 steps after a warm-up step): GPU kernels vs CPU plain "
          f"max abs diff {err:.3e}; worst field {field}: rel diff "
          f"{rel:.3e} (bound 3e-8 x the field's scale)")
    if not rel <= 3e-8:
        fail(f"small gx1-parity run: {field} on the GPU differs from the "
             f"CPU by {rel:.3e} of its scale (> 3e-8)")


def check_health(m, state, diag, label):
    """The guards of bench.py:88-153 on the port's state."""
    import torch
    if not (torch.isfinite(state.vicen).all()
            and torch.isfinite(state.aicen).all()):
        fail(f"{label}: non-finite state")
    tarea = m.grid.tarea.double()
    tmask = m.grid.tmask
    ocean = float((tarea * tmask).sum())
    ice = float((state.aicen.double().sum(0) * tarea * tmask).sum())
    frac = ice / ocean
    if not 0.005 < frac < 1.05:
        fail(f"{label}: global ice fraction {frac:.4f} outside 0.5%..105%")
    if float(state.vicen.double().sum()) <= 0.0:
        fail(f"{label}: zero total ice volume")
    if diag is not None:
        if int(diag.state_bad) > 0:
            fail(f"{label}: in-step state_bad={int(diag.state_bad)}")
        if not bool(diag.therm_converged):
            fail(f"{label}: thermo solver did not converge")
    return frac


def main_path(label, build, nsteps, expect):
    """Drive one main path: ``build()`` returns (model, initial state,
    forcing); 2 warm-up steps, ``nsteps`` timed steps of ``rollout`` with
    the launch counters set to 0 just before and read just after (each
    kernel must have launched ``expect[name]`` times), the bench.py guards
    and the 3x per-step cross-check."""
    import torch
    from cice5_tpu_torch.ops import kernels
    m, st, forcing = build()
    cfg = m.cfg
    st, diag = m.rollout(st, forcing, 2)           # warm-up
    torch.cuda.synchronize()
    check_health(m, st, diag, f"{label} post-warmup")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st, diag = m.rollout(st, forcing, nsteps)
    torch.cuda.synchronize()
    dt_roll = (time.perf_counter() - t0) / nsteps
    launches = kernels.launch_counts()
    frac = check_health(m, st, diag, f"{label} post-timing")
    if launches != expect:
        fail(f"{label} main path launches {launches}, expected {expect}")

    per_step = []
    s2 = st
    for _ in range(3):
        t0 = time.perf_counter()
        s2, d2 = m.step(s2, forcing)
        torch.cuda.synchronize()
        per_step.append(time.perf_counter() - t0)
    check_health(m, s2, d2, f"{label} per-step cross-check")
    dt_single = min(per_step)
    if not dt_single / 3.0 < dt_roll < dt_single * 3.0 + 1e-3:
        fail(f"{label}: rollout {dt_roll * 1e3:.3f} ms/step disagrees >3x "
             f"with per-step {dt_single * 1e3:.3f} ms/step")
    cells = cfg.grid.nx * cfg.grid.ny
    solver = "mushy Picard" if cfg.thermo.ktherm == 2 else "BL99"
    print(f"main path {label} on {card_line()}: {cfg.grid.ny}x{cfg.grid.nx} "
          f"{cfg.dtype} ndte={cfg.dyn.ndte}, {nsteps} timed steps: rollout "
          f"{dt_roll * 1e3:.3f} ms/step, per-step {dt_single * 1e3:.3f} "
          f"ms/step, {cells / dt_roll:.4e} cell-steps/s; ice fraction "
          f"{frac:.4f}; {solver} passes {int(diag.niter_thermo)}, ridging "
          f"passes {int(diag.niter_ridge)} in the last step; launches "
          f"{launches}", flush=True)
    graph_phase(label, m, st, forcing, 3)
    return launches


# history fields of a run that are rounding noise on cold surfaces (the
# surface melt, held against a scale of at least 1) and the melt onset
# date that tests that melt for > 0 (not compared across devices)
MELT_NOISE = frozenset({"meltt", "melts", "fmeltt_ai", "fmelttn_ai"})
ONSET = "mlt_onset"
RUN_EXPECT = dict(evp_sweep=8, remap_flux_both=8, shortwave_dedd=8,
                  evp_fused=0, remap_flux_edge=0)


def _recording_stream():
    """A HistoryStream class that keeps each step's aice (a clone on the
    card) and the float64 averages of the last file it wrote."""
    from cice5_tpu_torch.io import history as hist

    class Recording(hist.HistoryStream):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.aice, self.last = [], {}

        def accum(self, values, time):
            self.aice.append(values["aice"].clone())
            super().accum(values, time)

        def averages(self, dims="2D"):
            self.last[dims] = super().averages(dims)
            return self.last[dims]
    return Recording


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def run_phase():
    """The run loop (``Model.run``) on the gx1-parity main path, 320x384
    float32, into a temporary directory: 8 steps with the diagnostics
    every 4, a state check every step, a history stream of every
    available field written every 4 steps and a restart every 4 steps,
    with the launch counters set to 0 just before and read just after.
    Then the exact restart through the graphs: 4 steps with a restart, a
    fresh Model restored from the pointer file and 4 more steps must
    equal the 8-step run at 0.0 in every State field. The history files
    are read back: every variable finite, the second file's aice the mean
    of the 4 steps' aice to 1 float32 ulp. Then ms/step of ``Model.run``
    without history, with history accumulated (no file), with history
    written every 4 steps, and of ``Model.rollout`` over the same 8
    forcings, twice each in one call, and a small float64 run on the card
    against the same run on the CPU."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from scipy.io import netcdf_file
    from cice5_tpu_torch.io import history as hist
    from cice5_tpu_torch.io import restart as restart_mod
    from cice5_tpu_torch.ops import kernels
    from cice5_tpu_torch.state import State
    Recording = _recording_stream()
    quiet = lambda *a: None
    m, st0, _ = build_parity()
    fields = hist.available_fields(m.cfg, m.tr)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as tmp:
        logs = []
        stream = Recording(fields, freq="1", freq_n=4)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        full = m.run(st0, 8, diag_every=4, check_every=1, history=stream,
                     history_dir=f"{tmp}/history", restart_every=4,
                     restart_dir=f"{tmp}/full", log=logs.append)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) / 8 * 1e3
        launches = kernels.launch_counts()
        if launches != RUN_EXPECT:
            fail(f"run: launches {launches}, expected {RUN_EXPECT}")
        check_health(m, full, None, "run")
        if sum("wrote history" in x for x in logs) != 2 or \
                sum("istep" in x for x in logs) != 2:
            fail(f"run: log {logs}")
        # exact restart through the graphs
        m.run(st0, 4, restart_every=4, restart_dir=f"{tmp}/half", log=quiet)
        m2, _, _ = build_parity()
        st4, meta = restart_mod.restore(pointer_dir=f"{tmp}/half")
        out = m2.run(st4, 4, start_step=meta["istep"], log=quiet)
        torch.cuda.synchronize()
        restart_diff = max((float((getattr(out, f.name).double()
                                   - getattr(full, f.name).double())
                                  .abs().max())
                            for f in dataclasses.fields(State)
                            if getattr(full, f.name).numel()), default=0.0)
        differ = [f.name for f in dataclasses.fields(State)
                  if not torch.equal(getattr(out, f.name),
                                     getattr(full, f.name))]
        if differ or meta["istep"] != 4:
            fail(f"run: the restored run differs from the continuous run "
                 f"in {differ} (max abs diff {restart_diff:.3e}; restart "
                 f"at istep {meta['istep']})")
        # the history files
        names = sorted(os.listdir(f"{tmp}/history"))
        if len(names) != 2:
            fail(f"run: history files {names}")
        for name in names:
            with netcdf_file(f"{tmp}/history/{name}", "r", mmap=False) as f:
                for k, v in f.variables.items():
                    if not np.isfinite(np.asarray(v[:])).all():
                        fail(f"run: {name} {k} is not finite")
                if name == names[1]:
                    aice = np.asarray(f.variables["aice"][0])
        acc = stream.aice[4].cpu().numpy()
        for a in stream.aice[5:8]:
            acc = acc + a.cpu().numpy()
        mean = acc / np.float32(4)
        aice_err = float(np.abs(aice - mean).max())
        aice_ulp = float(np.spacing(np.float32(np.abs(mean).max())))
        if not aice_err <= aice_ulp:
            fail(f"run: the second file's aice differs from the mean of its "
                 f"4 steps by {aice_err:.3e} (> 1 float32 ulp {aice_ulp:.3e})")
        history_bytes = _dir_bytes(f"{tmp}/history")
        restart_bytes = _dir_bytes(f"{tmp}/half") - os.path.getsize(
            f"{tmp}/half/{restart_mod.POINTER_NAME}")

        # ms/step, from the warmed-up state, graphs captured
        forcings = [m.forcing_at(8 + k) for k in range(8)]
        never = dict(freq="1", freq_n=10 ** 9)
        ways = {
            "run": lambda: m.run(full, 8, start_step=8, log=quiet),
            "run_history_accumulated": lambda: m.run(
                full, 8, start_step=8, log=quiet,
                history=hist.HistoryStream(fields, **never)),
            "run_history_written": lambda: m.run(
                full, 8, start_step=8, log=quiet,
                history=hist.HistoryStream(fields, freq="1", freq_n=4),
                history_dir=f"{tmp}/timed"),
            "rollout": lambda: m.rollout(full, forcings, 8)}
        ms = {k: [] for k in ways}
        for k in list(ways) + list(ways)[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ways[k]()
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) / 8 * 1e3)
    small = small_run_check()
    line = dict(
        path="gx1-parity", shape=[m.cfg.grid.ny, m.cfg.grid.nx],
        dtype=m.cfg.dtype, ndte=m.cfg.dyn.ndte, steps=8, card=card_line(),
        launches=launches,
        ms_per_step_first_run_with_capture_diags_checks_history_restarts=(
            first_ms),
        ms_per_step=ms, history_fields=len(fields),
        history_bytes_per_file=history_bytes // 2,
        restart_bytes=restart_bytes, restart_max_abs_diff=restart_diff,
        aice_average_max_abs_err=aice_err,
        small_float64_gpu_vs_cpu=small)
    print("run: " + json.dumps(line), flush=True)


def small_run_check():
    """A small float64 ``Model.run`` of the gx1-parity model (24x16
    tripole grid with land on the seam, ndte=8, rain on the ice) on the
    card and on the CPU from one warmed-up state (a step on the CPU): 2
    steps, one history file each. Every float64 average within 3e-8 of
    its field's scale (the surface-melt noise against a scale of at least
    1, the melt onset date not compared), every float32 variable of the
    files within that plus 1 float32 ulp of its scale. Returns the worst
    average's relative difference."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from scipy.io import netcdf_file
    from cice5_tpu_torch.config import gx1_parity_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.forcing import idealized_polar_forcing
    from cice5_tpu_torch.io import history as hist
    Recording = _recording_stream()
    cfg = gx1_parity_config()
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=24, nx=16),
                      dyn=dataclasses.replace(cfg.dyn, ndte=8),
                      dtype="float64", accum_dtype="float64")
    istep = 172 * 24 + 12

    def rainy(m):
        def provider(k, info):
            f = idealized_polar_forcing(
                m.grid.shape, info.yday, dtype=m.cfg.xp_dtype,
                tlat=m.grid.TLAT, tlon=m.grid.TLON, orb=m.orb,
                device=m.device)
            return f.replace(frain=torch.full_like(f.frain, 2.0e-5))
        return provider
    models = {d: Model(cfg, grid=small_parity_grid(cfg, "cpu"), device=d)
              for d in ("cpu", "cuda")}
    for m in models.values():
        m.forcing_provider = rainy(m)
    st, _ = models["cpu"].step(models["cpu"].init_state(),
                               models["cpu"].forcing_at(istep))
    streams, worst = {}, (0.0, "")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_small_") as tmp:
        for d, m in models.items():
            streams[d] = Recording(hist.available_fields(cfg, m.tr),
                                   freq="1", freq_n=2)
            m.run(st.to(d), 2, start_step=istep + 1, log=lambda *a: None,
                  history=streams[d], history_dir=f"{tmp}/{d}")
        for dims, fl in streams["cpu"].groups.items():
            a, b = streams["cpu"].last[dims], streams["cuda"].last[dims]
            for i, f in enumerate(fl):
                if f.name == ONSET:
                    continue
                scale = max(float(np.abs(a[i]).max(initial=0.0)),
                            1.0 if f.name in MELT_NOISE else 1e-300)
                rel = float(np.abs(a[i] - b[i]).max(initial=0.0)) / scale
                worst = max(worst, (rel, f.name))
        (name,) = os.listdir(f"{tmp}/cpu")
        with netcdf_file(f"{tmp}/cpu/{name}", "r", mmap=False) as fa, \
                netcdf_file(f"{tmp}/cuda/{name}", "r", mmap=False) as fb:
            if list(fa.variables) != list(fb.variables):
                fail("small float64 run: the history files' variables differ")
            bad = []
            # a file holds each average times its field's output scale
            out = {f.name: f.scale for f in streams["cpu"].fields}
            for k, va in fa.variables.items():
                if k == ONSET:
                    continue
                x = np.asarray(va[:], np.float64)
                y = np.asarray(fb.variables[k][:], np.float64)
                scale = max(float(np.abs(x).max(initial=0.0)),
                            out[k] if k in MELT_NOISE else 1e-300)
                ulp = float(np.spacing(np.float32(scale)))
                if not np.abs(x - y).max(initial=0.0) <= 3e-8 * scale + ulp:
                    bad.append(k)
    print(f"small float64 run (24x16 tripole, ndte=8, 2 steps after a warm-up "
          f"step, a history file each): GPU vs CPU worst history average "
          f"{worst[1]}: rel diff {worst[0]:.3e} (bound 3e-8 x the field's "
          f"scale); file variables beyond 3e-8 x scale + 1 float32 ulp: "
          f"{bad or 'none'}", flush=True)
    if not worst[0] <= 3e-8 or bad:
        fail(f"small float64 run: GPU history differs from the CPU's: "
             f"{worst}, {bad}")
    return dict(worst_field=worst[1], worst_rel_diff=worst[0])


def state_and_diag_differences(ref, got):
    """{field: max abs difference} of every State and StepDiag field of
    two (state, diag) pairs, pass counts included, that differs at all."""
    import dataclasses
    import torch
    (sr, dr), (sg, dg) = ref, got
    pairs = [(f.name, getattr(sr, f.name), getattr(sg, f.name))
             for f in dataclasses.fields(sr)]
    pairs += list(zip(dr._fields, dr, dg))
    return {n: float((x.double() - y.double()).abs().max())
            for n, x, y in pairs
            if torch.is_tensor(x) and not torch.equal(x, y)}


def graph_phase(label, m, st, forcing, nsteps):
    """From one warmed-up state, ``nsteps`` steps through the eager step
    (``driver.step.step``, one PyTorch launch per op, one host read per
    loop pass) and through ``Model.rollout`` (CUDA graph replays): every
    State and StepDiag field must agree at 0.0, pass counts included.
    Prints both ms/step (host clock around work that ends in a
    synchronize), the host syncs per step of each (``graph.HostSyncs``
    over one more step of each, untimed), the graph replays and flag reads
    per step, and the kernel launches of each run."""
    import torch
    from cice5_tpu_torch.driver import graph
    from cice5_tpu_torch.driver.step import step as step_fn
    from cice5_tpu_torch.ops import kernels
    (g,) = m.graphs.values()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ref = (st, None)
    for _ in range(nsteps):
        ref = step_fn(ref[0], forcing, *m.step_args)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / nsteps * 1e3
    eager_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    replays, reads = g.replays, g.flag_reads
    t0 = time.perf_counter()
    got = m.rollout(st, forcing, nsteps)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) / nsteps * 1e3
    graph_launches = kernels.launch_counts()
    replays = (g.replays - replays) / nsteps
    reads = (g.flag_reads - reads) / nsteps
    diff = state_and_diag_differences(ref, got)
    with graph.HostSyncs() as eager_syncs:
        step_fn(st, forcing, *m.step_args)
        torch.cuda.synchronize()
    with graph.HostSyncs() as graph_syncs:
        m.rollout(st, forcing, 1)
        torch.cuda.synchronize()
    print(f"graph {label}: {nsteps} steps from one warmed-up state: eager "
          f"{eager_ms:.3f} ms/step, graph {graph_ms:.3f} ms/step; host "
          f"syncs per step eager {eager_syncs.syncs}, graph "
          f"{graph_syncs.syncs}; graph replays per step {replays:.2f}, "
          f"loop flag reads per step {reads:.2f} ({len(g.program)} graphs "
          f"captured); launches eager {eager_launches}, graph "
          f"{graph_launches}; passes of the last step "
          f"{int(got[1].niter_thermo)} thermo, {int(got[1].niter_ridge)} "
          f"ridging; fields that differ {diff or 'none'}", flush=True)
    if diff:
        fail(f"{label}: the graph rollout differs from the eager step: "
             f"{diff}")
    if eager_launches != graph_launches:
        fail(f"{label}: the graph rollout counted launches "
             f"{graph_launches}, the eager steps {eager_launches}")


# the fields an atmosphere and an ocean model send the ice
# (driver/coupled.py ATM_FIELDS and OCN_FIELDS, fsw as its four bands)
ATM_SENT = ("swvdr", "swvdf", "swidr", "swidf", "flw", "Tair", "potT", "Qa",
            "rhoa", "uatm", "vatm", "wind", "zlvl", "fsnow", "frain")
OCN_SENT = ("sst", "sss", "uocn", "vocn", "ss_tltx", "ss_tlty", "frzmlt",
            "qdp", "hmix")


def host_exchanges(forcing_at, steps):
    """{istep: (atm, ocn)}: the forcing ``forcing_at(istep)`` of each step
    as the NumPy host arrays a coupler hands over, built before any
    timing."""
    out = {}
    for k in steps:
        f = forcing_at(k)
        out[k] = ({n: getattr(f, n).cpu().numpy() for n in ATM_SENT},
                  {n: getattr(f, n).cpu().numpy() for n in OCN_SENT})
    return out


def coupled_model(m, ex, record=None, timing=None, **kw):
    """A CoupledModel of ``m`` whose callbacks hand over the NumPy fields
    of ``ex`` (host_exchanges) and copy the outbound tensors to NumPy, as
    an OASIS coupler takes host buffers; with ``timing`` the host-to-device
    merge of the inbound fields and the device-to-host copy of the
    outbound ones are timed (each after a synchronize)."""
    import torch
    from cice5_tpu_torch.driver.coupled import CoupledModel
    dt = m.cfg.time.dt

    class Timed(CoupledModel):
        def _merge(self, updates, allowed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._merge(updates, allowed)
            torch.cuda.synchronize()
            if timing is not None:
                timing["h2d"].append(time.perf_counter() - t0)

    def put_ocn(t, out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = {k: v.cpu().numpy() for k, v in out.items()}
        if timing is not None:
            timing["d2h"].append(time.perf_counter() - t0)
        if record is not None:
            record[t] = host

    step_of = lambda t: int(round(t / dt))
    return Timed(model=m, get_atm=lambda t: ex[step_of(t)][0],
                 get_ocn=lambda t: ex[step_of(t)][1], put_ocn=put_ocn, **kw)


def merged_forcings(m, ex, steps):
    """The forcing a CoupledModel of ``m`` steps with after the exchanges
    of ``steps`` (host_exchanges), on the device: what ``Model.rollout``
    gets to run the same steps."""
    from cice5_tpu_torch.driver.coupled import CoupledModel
    cm = CoupledModel(model=m)
    out = []
    for k in steps:
        cm.from_atm(ex[k][0])
        cm.from_ocn(ex[k][1])
        out.append(cm._forcing)
    return out


def auscom_025_phase(gx1_peak, nwarm=2, nsteps=4):
    """The coupled model on the ACCESS-OM 0.25-degree configuration
    (phase 6 of the module docstring). Prints one ``auscom_025:`` JSON
    line."""
    import gc
    import torch
    from cice5_tpu_torch.config import auscom_025_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import synth_gx1_grid
    from cice5_tpu_torch.ops import check, kernels
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = auscom_025_config(coupled_radiation=True)  # 1080x1440 f32 ndte=120
    label = "auscom_025 coupled"
    t0 = time.perf_counter()
    m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
    kernels.reset_launch_counts()
    st = m.init_state()               # prefill_radiation: one C launch
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = kernels.launch_counts()
    steps = range(nwarm + nsteps)
    ex = host_exchanges(m.forcing_at, steps)
    inbound = sum(a.nbytes for d in ex[0] for a in d.values())
    timing = {"h2d": [], "d2h": []}
    outbound = {}
    cm = coupled_model(m, ex, record=outbound, timing=timing)
    t0 = time.perf_counter()
    st, diag = cm.run(st, 1)          # eager step + capture
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (g,) = m.graphs.values()
    st, diag = cm.run(st, nwarm - 1, start_step=1)
    torch.cuda.synchronize()
    check_health(m, st, diag, f"{label} post-warmup")
    st_warm = st
    timing = {"h2d": [], "d2h": []}
    cm = coupled_model(m, ex, record=outbound, timing=timing)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st, diag = cm.run(st, nsteps, start_step=nwarm)
    torch.cuda.synchronize()
    coupled_ms = (time.perf_counter() - t0) / nsteps * 1e3
    launches = kernels.launch_counts()
    frac = check_health(m, st, diag, f"{label} post-timing")
    expect = dict(evp_sweep=nsteps, remap_flux_both=nsteps,
                  shortwave_dedd=nsteps, evp_fused=0, remap_flux_edge=0)
    if launches != expect:
        fail(f"{label}: launches {launches}, expected {expect}")
    if len(outbound) != nwarm + nsteps or not all(
            np_finite(v) for v in outbound[max(outbound)].values()):
        fail(f"{label}: outbound exchanges {sorted(outbound)}")
    out_bytes = sum(v.nbytes for v in outbound[max(outbound)].values())
    # Model.rollout over the same forcings, from the same state
    fl = merged_forcings(m, ex, range(nwarm, nwarm + nsteps))
    roll_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_r, d_r = m.rollout(st_warm, fl, nsteps)
        torch.cuda.synchronize()
        roll_ms.append((time.perf_counter() - t0) / nsteps * 1e3)
    same = state_and_diag_differences((st, diag), (st_r, d_r))
    if same:
        fail(f"{label}: the coupled run differs from Model.rollout over the "
             f"same forcings: {same}")
    peak = torch.cuda.max_memory_allocated()
    h2d_ms = sum(timing["h2d"]) / nsteps * 1e3
    d2h_ms = sum(timing["d2h"]) / nsteps * 1e3
    cells = cfg.grid.nx * cfg.grid.ny
    print(f"main path {label} on {card_line()}: {cfg.grid.ny}x{cfg.grid.nx} "
          f"{cfg.dtype} ndte={cfg.dyn.ndte}, {nsteps} timed coupled steps: "
          f"{coupled_ms:.3f} ms/step ({cells / coupled_ms * 1e3:.4e} "
          f"cell-steps/s), Model.rollout over the same forcings "
          f"{roll_ms[0]:.3f} / {roll_ms[1]:.3f} ms/step (its state equal to "
          f"the coupled run's); exchange per step: inbound {inbound / 1e6:.1f}"
          f" MB host to device {h2d_ms:.3f} ms, outbound {out_bytes / 1e6:.1f}"
          f" MB device to host {d2h_ms:.3f} ms; ice fraction {frac:.4f}; "
          f"launches {launches}; peak device memory "
          f"{peak / 2**30:.2f} GiB (gx1-parity path {gx1_peak / 2**30:.2f} "
          f"GiB); capture {g.capture_seconds:.2f} s, first step (eager + "
          f"capture) {first_s:.2f} s", flush=True)
    graph_phase(label, m, st, fl[-1], 2)
    ks = auscom_kernels(m, st, fl[-1], launches)
    line = dict(
        path="auscom_025 coupled", shape=[cfg.grid.ny, cfg.grid.nx],
        dtype=cfg.dtype, ndte=cfg.dyn.ndte, card=card_line(),
        warmup_steps=nwarm, timed_steps=nsteps,
        ms_per_coupled_step=coupled_ms, cell_steps_per_s=cells / coupled_ms
        * 1e3, rollout_ms_per_step=roll_ms,
        exchange_ms_per_step=dict(host_to_device=h2d_ms,
                                  device_to_host=d2h_ms),
        exchange_bytes_per_step=dict(inbound=inbound, outbound=out_bytes),
        launches=launches, launches_at_init=init_launches,
        ice_fraction=frac, peak_memory_bytes=peak,
        gx1_parity_peak_memory_bytes=gx1_peak,
        capture_s=g.capture_seconds, first_step_s=first_s, init_s=init_s,
        graphs_captured=len(g.program), kernels=ks)
    print("auscom_025: " + json.dumps(line), flush=True)


def np_finite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(a).all())


def timed_call(fn):
    """(fn(), its ms between two CUDA events)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def auscom_kernels(m, st, forcing, launches):
    """Kernels A, B and C at 1080x1440 float32 on the arguments of one
    coupled step (``check.capture_kernel_args``), against their plain
    versions with the tolerances of phase 2 (A 1e-5, B 1e-5 and 2e-5 for
    the remapped fields, each field on its own scale); A must run its
    device-memory branch. C is held in float64 to 1e-12 and in float32
    against the float64 result (``dedd_full_size_check``). Each kernel's
    time is a CUDA graph replay of one call; the plain version's the
    reference call's own."""
    import torch
    from cice5_tpu_torch.models.dynamics import evp as tevp
    from cice5_tpu_torch.models.radiation import dedd
    from cice5_tpu_torch.models.transport import remap as trm
    from cice5_tpu_torch.ops import check, kernels
    _, cap = check.capture_kernel_args(m, st, forcing)
    out, bad = {}, []
    # A: the EVP sweep on the device-memory branch
    p, ndte, topo, kw = cap["evp"]
    (ny, nx), dtype = kw["uvel"].shape, kw["uvel"].dtype
    plan = kernels.evp_plan(ny, nx, dtype, kw["uvel"].device)
    ref, plain_ms = timed_call(lambda: tevp.subcycle_sweep(p, ndte, topo,
                                                           **kw))
    got = tevp.evp_sweep(p, ndte, topo, **kw)
    field, rel, err = check.worst(check.field_errors(
        check.evp_outputs(ref), check.evp_outputs(got)))
    del ref
    ms, _ = graph_ms(lambda: tevp.evp_sweep(p, ndte, topo, **kw), reps=10)
    bound = evp_bound(kw, ndte)
    print(f"evp_sweep auscom_025 f32 ndte={ndte} at {ny}x{nx}: plan "
          f"{plan.describe()}; vs subcycle_sweep max abs diff {err:.3e}, "
          f"worst field {field}: rel diff {rel:.3e} (bound 1e-5 x the "
          f"field's scale); kernel {ms:.4f} ms in a CUDA graph, plain "
          f"{plain_ms:.1f} ms, bound {bound[0]:.4f} ms ({bound[2]})",
          flush=True)
    if plan.branch != "device" or not rel <= 1e-5:
        bad.append("evp_sweep")
    out["evp_sweep"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                            bound_by=bound[1], max_abs_err=err,
                            launches=launches["evp_sweep"],
                            plan=plan.describe())
    # B: the remap flux kernel
    args = cap["remap"]
    ref, plain_ms = timed_call(lambda: trm.remap_flux_plain(*args))
    got = trm.remap_flux_both(*args)
    field, rel, err = check.worst(check.field_errors(
        check.remap_outputs(ref), check.remap_outputs(got)))
    mm, tm = args[2][:, 2:-2, 2:-2], args[3][:, :, 2:-2, 2:-2]
    upd = [trm._update(m.grid, mm=mm, tm=tm, fn_mflx=f[0], fn_mtflx=f[1],
                       fe_mflx=f[2], fe_mtflx=f[3], tracer_type=args[5],
                       parent=args[6]) for f in (ref, got)]
    field_u, rel_u, _ = check.worst(check.field_errors(
        dict(mm=upd[0][0], tm=upd[0][1]), dict(mm=upd[1][0], tm=upd[1][1]),
        axes={"tm": 1}))
    del ref, upd
    ms, _ = graph_ms(lambda: trm.remap_flux_both(*args), reps=20)
    bound = remap_bound(args, ("north", "east"))
    ncat, ntrace = args[3].shape[:2]
    print(f"remap_flux_both auscom_025 f32 at {ny}x{nx}, ncat={ncat}, "
          f"ntrace={ntrace}: vs remap_flux_plain max abs diff {err:.3e}, "
          f"worst flux {field}: rel diff {rel:.3e} (bound 1e-5); worst "
          f"remapped field {field_u}: rel diff {rel_u:.3e} (bound 2e-5); "
          f"kernel {ms:.4f} ms in a CUDA graph, plain {plain_ms:.1f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[2]})", flush=True)
    if not (rel <= 1e-5 and rel_u <= 2e-5):
        bad.append("remap_flux_both")
    out["remap_flux_both"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                                  bound_by=bound[1], max_abs_err=err,
                                  launches=launches["remap_flux_both"])
    # C: delta-Eddington on the state after dynamics (coupled ordering)
    kw = cap["dedd"]
    c = dedd_full_size_check(kw)
    ms, _ = graph_ms(lambda: dedd.shortwave_dEdd_ncat(**kw), reps=20)
    bound = dedd_bound(kw)
    print(f"shortwave_dedd auscom_025 at {ny}x{nx}: float64 vs "
          f"shortwave_dEdd_plain worst field {c['f64'][0]}: rel diff "
          f"{c['f64'][1]:.3e} (bound 1e-12); float32 vs the plain float32 "
          f"worst field {c['f32'][0]}: rel diff {c['f32'][1]:.3e}; against "
          f"the float64 result the kernel's float32 worst field "
          f"{c['acc_kernel'][0]}: rel diff {c['acc_kernel'][1]:.3e}, the "
          f"plain float32's {c['acc_plain'][0]}: {c['acc_plain'][1]:.3e}; "
          f"the kernel's worst distance beyond the plain float32's "
          f"{c['excess'][1]:.3e} of scale ({c['excess'][0]}; bound "
          f"{DEDD_F32_TOL:.0e}), in one column at most "
          f"{c['column_excess'][1]:.3e} ({c['column_excess'][0]}); lit "
          f"columns {c['lit']} of {c['cols']}, "
          f"unlit exact zeros: {c['dark']}; kernel {ms:.4f} ms in a CUDA "
          f"graph, plain {c['plain_ms']:.1f} ms, bound {bound[0]:.4f} ms "
          f"({bound[2]})", flush=True)
    if not (c["f64"][1] <= 1e-12 and c["excess"][1] <= DEDD_F32_TOL
            and c["dark"]):
        bad.append("shortwave_dedd")
    out["shortwave_dedd"] = dict(ms=ms, plain_ms=c["plain_ms"],
                                 bound_ms=bound[0], bound_by=bound[1],
                                 max_abs_err=c["f32_abs"],
                                 launches=launches["shortwave_dedd"])
    if bad:
        fail(f"auscom_025: kernels disagree with their plain versions or "
             f"A left its device-memory branch: {bad}")
    return out


def dedd_full_size_check(kw):
    """Kernel C on the 1080x1440 inputs ``kw`` (float32, as captured) and
    on the same inputs in float64. In float64 the kernel must equal its
    plain version to 1e-12 of each field's scale: the same function. In
    float32 the two are two roundings of a function that float32 does not
    determine well on this many columns: each float32 result parts from
    the float64 one by up to ~6e-2 of a layer absorption's scale, and the
    two float32 results from each other by up to ~2.5e-4 of an albedo's,
    above the DEDD_F32_TOL that phase 2 holds at 384x320 (PERF.md section
    6). So for each field (and layer) the kernel's float32 result
    must be no farther from the float64 one than the plain version's
    float32 result is, beyond DEDD_F32_TOL of the field's scale; the
    kernel's distance from the plain float32, and the most it is farther
    than the plain float32 from the float64 result in any one column, are
    printed beside. Every unlit column exact zeros."""
    import torch
    from cice5_tpu_torch.models.radiation import dedd
    from cice5_tpu_torch.ops import check
    k64 = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
               else v) for k, v in kw.items()}
    p64 = dedd.shortwave_dEdd_plain(**k64)._asdict()
    f64 = check.worst(check.field_errors(
        p64, dedd.shortwave_dEdd_ncat(**k64)._asdict()))
    p32, plain_ms = timed_call(lambda: dedd.shortwave_dEdd_plain(**kw))
    g32 = dedd.shortwave_dEdd_ncat(**kw)
    lit = dedd_lit(kw)
    dark = bool(all(((x if x.dim() == 3 else x.movedim(1, 0))[
        ..., ~lit] == 0).all() for x in g32))
    p32, g32 = p32._asdict(), g32._asdict()
    f32 = check.worst(check.field_errors(p32, g32))
    excess = {}
    for name, ref in p64.items():
        ax = 1 if ref.dim() == 4 else None
        parts = ([(name, ref, p32[name], g32[name])] if ax is None else
                 [(f"{name}[{k}]", ref.select(ax, k), p32[name].select(ax, k),
                   g32[name].select(ax, k)) for k in range(ref.shape[ax])])
        for key, a, b, c in parts:
            scale = float(a.abs().max())
            ek = (c.double() - a).abs()
            ep = (b.double() - a).abs()
            rel = lambda x: float(x) / scale if scale > 0 else (
                0.0 if float(x) == 0 else float("inf"))
            excess[key] = (rel(ek.max() - ep.max()),
                           rel((ek - ep).clamp(min=0.0).max()))
    worst_excess = max(((k, v[0]) for k, v in excess.items()),
                       key=lambda kv: kv[1])
    worst_column = max(((k, v[1]) for k, v in excess.items()),
                       key=lambda kv: kv[1])
    acc_k = check.worst(check.field_errors(p64, g32))
    acc_p = check.worst(check.field_errors(p64, p32))
    return dict(f64=f64, f32=f32, f32_abs=f32[2], excess=worst_excess,
                column_excess=worst_column, acc_kernel=acc_k,
                acc_plain=acc_p, dark=dark, lit=int(lit.sum()),
                cols=lit.numel(), plain_ms=plain_ms)


def small_coupled_config():
    """The gx1-parity model at 24x16, ndte=8, float64, with every
    coupled-mode option of the port on."""
    import dataclasses
    from cice5_tpu_torch.config import gx1_parity_config
    cfg = gx1_parity_config(coupled_radiation=True, dtype="float64",
                            accum_dtype="float64")
    r = dataclasses.replace
    return cfg.replace(
        grid=r(cfg.grid, ny=24, nx=16), dyn=r(cfg.dyn, ndte=8),
        forcing=r(cfg.forcing, formdrag=True, highfreq=True),
        thermo=r(cfg.thermo, fbot_xfer_type="Cdn_ocn"))


def small_coupled_check():
    """The coupled model with every coupled-mode option on the card
    (graph replays) and on the CPU (plain versions): a 24x16 float64
    gx1-parity model on the small tripole grid, a northern-summer noon
    with rain on the ice, the exchanges of each hour as NumPy arrays; one
    warm-up coupled step on the CPU, then 2 coupled steps on each device
    from that state, every state field within 3e-8 of its scale (tracers
    as conserved amounts, the stresses at the EVP's 1e-5); the graph
    rollout against the eager step at 0.0; and a restart after 2 steps
    through the graphs (dump, restore on the card, a fresh model, 2 more
    coupled steps) equal to 4 continuous coupled steps at 0.0."""
    import dataclasses
    import tempfile
    import torch
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.forcing import idealized_polar_forcing
    from cice5_tpu_torch.io import restart as restart_mod
    from cice5_tpu_torch.models.thermo.itd import tracer_weights
    from cice5_tpu_torch.ops import check
    from cice5_tpu_torch.state import State
    cfg = small_coupled_config()
    istep = 172 * 24 + 12

    def rainy(m, k):
        f = idealized_polar_forcing(
            m.grid.shape, m.calendar.info(k, cfg.time.dt).yday,
            dtype=m.cfg.xp_dtype, tlat=m.grid.TLAT, tlon=m.grid.TLON,
            orb=m.orb, device=m.device)
        return f.replace(frain=torch.full_like(f.frain, 2.0e-5))

    def model(device):
        m = Model(cfg, grid=small_parity_grid(cfg, "cpu"), device=device)
        # the forcing a CoupledModel starts from (coszen and yday are not
        # exchanged) and init_state's prefill take the summer noon's
        m.forcing_provider = lambda k, info, f=rainy(m, istep): f
        return m
    mc, mg = model("cpu"), model("cuda")
    ex = host_exchanges(lambda k: rainy(mc, k), range(istep, istep + 5))
    st, _ = coupled_model(mc, ex).run(mc.init_state(), 1, start_step=istep)
    ref, _ = coupled_model(mc, ex).run(st, 2, start_step=istep + 1)
    got, dg = coupled_model(mg, ex).run(st.to("cuda"), 2,
                                        start_step=istep + 1)
    got = got.to("cpu")
    names = ("aicen", "vicen", "vsnon", "uvel", "vvel", "sst", "scale_factor",
             "rad_alb", "strocnxT", "strocnyT")
    amount = lambda s: tracer_weights(mc.tr, s.aicen, s.vicen, s.vsnon,
                                      s.trcrn) * s.trcrn
    r = {k: getattr(ref, k) for k in names}
    g = {k: getattr(got, k) for k in names}
    r["trcrn_amount"], g["trcrn_amount"] = amount(ref), amount(got)
    r["rad_prev"], g["rad_prev"] = ref.rad_prev, got.rad_prev
    field, rel, err = check.worst(check.field_errors(
        r, g, axes={"trcrn_amount": 1, "rad_prev": 1}))
    sfield, srel, _ = check.worst(check.field_errors(
        {k: getattr(ref, k) for k in ("stressp", "stressm", "stress12")},
        {k: getattr(got, k) for k in ("stressp", "stressm", "stress12")}))
    merged = merged_forcings(mg, ex, [istep + 3])[0]
    graph_against_eager(mg, st.to("cuda"), merged,
                        "small float64 coupled run (every coupled option)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_coupled_") as tmp:
        full, _ = coupled_model(mg, ex).run(st.to("cuda"), 4,
                                            start_step=istep + 1)
        half, _ = coupled_model(mg, ex).run(st.to("cuda"), 2,
                                            start_step=istep + 1)
        restart_mod.dump(half, f"{tmp}/iced.npz", istep=istep + 3,
                         time=(istep + 3) * cfg.time.dt)
        st2, meta = restart_mod.restore(pointer_dir=tmp)
        out, _ = coupled_model(model("cuda"), ex).run(
            st2, 2, start_step=meta["istep"])
    torch.cuda.synchronize()
    differ = [f.name for f in dataclasses.fields(State)
              if not torch.equal(getattr(out, f.name), getattr(full, f.name))]
    print(f"small float64 coupled run (24x16 tripole, coupled_radiation, "
          f"formdrag, highfreq, fbot_xfer_type='Cdn_ocn', ndte=8, 2 coupled "
          f"steps after a warm-up step): GPU kernels vs CPU plain max abs "
          f"diff {err:.3e}; worst field {field}: rel diff {rel:.3e} (bound "
          f"3e-8 x the field's scale); worst stress {sfield}: rel diff "
          f"{srel:.3e} (bound 1e-5); drag planes {tuple(dg.drag.shape)}; "
          f"restart after 2 coupled steps through the graphs vs 4 "
          f"continuous: fields that differ {differ or 'none'}", flush=True)
    if not (rel <= 3e-8 and srel <= 1e-5):
        fail(f"small float64 coupled run: {field} on the GPU differs from "
             f"the CPU by {rel:.3e} of its scale (> 3e-8), or {sfield} by "
             f"{srel:.3e} (> 1e-5)")
    if differ:
        fail(f"small float64 coupled run: the restored run differs from the "
             f"continuous one in {differ}")


def build_parity():
    """gx1_parity_config() on synth_gx1_grid, as bench.py:bench_parity
    builds it: the default 70N/60S ice edge, forcing of step 0."""
    from cice5_tpu_torch.config import gx1_parity_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import synth_gx1_grid
    cfg = gx1_parity_config()            # 320x384, float32, ndte=120
    m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
    return m, m.init_state(), m.forcing_at(0)


def build_bl99():
    from cice5_tpu_torch.config import bench_easy_config
    from cice5_tpu_torch.driver.model import Model
    m = Model(bench_easy_config())       # 320x384, float32, ndte=120
    return m, m.init_state(ice_mask=m.grid.tmask), m.forcing_at(0)


def build_bl99_fused(**dyn):
    """The BL99 + CCSM3 model with the fused EVP sweep
    (evp_algorithm="pallas", kernel D: ndte/10 launches per step) and the
    dynamics fields ``dyn`` changed."""
    from cice5_tpu_torch.config import bench_easy_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.small_sets import with_
    cfg = bench_easy_config()            # 320x384, float32, ndte=120
    m = Model(with_(cfg, dyn=dict(dyn, evp_algorithm="pallas")))
    return m, m.init_state(ice_mask=m.grid.tmask), m.forcing_at(0)


def capture(build_model, dtype):
    """(grid, kernel arguments of one step at the main path's shapes after
    a warm-up step (velocities and stresses non-zero), the form-drag Cw
    plane of the state that step started from, the model's config)."""
    from cice5_tpu_torch.ops import check
    from cice5_tpu_torch.driver.step import step as step_fn
    m, st, f = build_model(dtype)
    st, _ = step_fn(st, f, *m.step_args)
    return (m.grid, check.capture_kernel_args(m, st, f)[1],
            drag_plane(m, st), m.cfg)


def drag_plane(m, st):
    """The ocean drag coefficient that form drag computes for ``st``
    (``neutral_drag_coeffs``, as the step calls it with formdrag on): a
    Cw plane for the EVP kernels."""
    from cice5_tpu_torch.models.formdrag import neutral_drag_coeffs
    tr, trc = m.tr, st.trcrn
    kw = {}
    if tr.nt_apnd >= 0:
        kw.update(apnd=trc[:, tr.nt_apnd], hpnd=trc[:, tr.nt_hpnd])
    if tr.nt_alvl >= 0:
        kw.update(alvl=trc[:, tr.nt_alvl], vlvl=trc[:, tr.nt_vlvl])
    return neutral_drag_coeffs(
        aice=st.aicen.sum(0), vice=st.vicen.sum(0), vsno=st.vsnon.sum(0),
        aicen=st.aicen, vicen=st.vicen, **kw).Cdn_ocn


def formdrag_evp_phase(cap64, cap32, cw64, cw32, label, fused):
    """Kernel A (or with ``fused`` kernel D, ndte=120 in launches of 10)
    with a form-drag Cw plane in its U-point inputs, against its plain
    version with the same plane (and D against A), float64 and float32,
    each output on its own scale with A's bounds; A's device-memory branch
    must equal the plain sweep bit for bit, D must equal A bit for bit.
    The plane must change the result against the constant ct.dragio."""
    import torch
    from cice5_tpu_torch import constants as ct
    from cice5_tpu_torch.models.dynamics import evp as tevp
    from cice5_tpu_torch.ops import check
    from cice5_tpu_torch.ops import evp_fused as tfused
    name = "evp_fused" if fused else "evp_sweep"
    bad = []
    for tag, (p, _, topo, kw), cw, tol in (("f64", cap64, cw64, 3e-8),
                                           ("f32", cap32, cw32, 1e-5)):
        kw = dict(kw, Cw=cw.to(kw["uvel"].dtype))
        ndte = 120
        a = check.evp_outputs(tevp.evp_sweep(p, ndte, topo, **kw))
        const = check.evp_outputs(tevp.evp_sweep(
            p, ndte, topo, **dict(kw, Cw=ct.dragio)))
        if fused:
            sw = dict(kchunk=10, nwin=4, **kw)
            got = check.evp_outputs(tfused.fused_sweep(p, ndte, topo, **sw))
            ref = check.evp_outputs(tfused.fused_sweep_plain(p, ndte, topo,
                                                             **sw))
            _, _, exact = check.worst(check.field_errors(a, got))
        else:
            got = a
            ref = check.evp_outputs(tevp.subcycle_sweep(p, ndte, topo, **kw))
            dev = check.evp_outputs(check.evp_on_plan(p, ndte, topo,
                                                      device_plan(kw), **kw))
            _, _, exact = check.worst(check.field_errors(ref, dev))
        torch.cuda.synchronize()
        field, rel, err = check.worst(check.field_errors(ref, got))
        moved = float((const["uvel"] - got["uvel"]).abs().max())
        print(f"{name} {label} {tag} ndte={ndte} with a form-drag Cw plane "
              f"(Cdn_ocn {float(cw.min()):.4g}..{float(cw.max()):.4g}): vs "
              f"its plain version max abs diff {err:.3e}; worst field "
              f"{field}: rel diff {rel:.3e} (bound {tol:.0e} x the field's "
              f"scale); {'vs evp_sweep' if fused else 'device-memory branch'}"
              f" max abs diff {exact:.3e} (must be 0); uvel moved by "
              f"{moved:.3e} from the constant Cw", flush=True)
        if not (rel <= tol and exact == 0.0 and moved > 0.0):
            bad.append(tag)
    if bad:
        fail(f"{name} with a form-drag Cw plane ({label}): {bad}")


# ---------------------------------------------------------------------
# the standalone configurations and the column options (phase 9)
# ---------------------------------------------------------------------

# the coupler's per-category surface fluxes of the calc_Tsfc=False path
# (W/m^2, from a fixed generator): fsurfn_f = fcondtopn_f, a surface in
# conductive balance, with latent and sensible parts
CPL_FLUX = dict(fsurf=(-40.0, -5.0), flat=(-6.0, 0.0), fsens=(-15.0, 5.0))


def write_pop_pair(d, stem, ny, nx):
    """A POP grid file pair as netCDF3 under directory ``d``
    (``<stem>.grid.nc``: ulat/ulon/angle in radians, htn/hte in cm;
    ``<stem>.kmt.nc``: kmt), popgrid_nc's layout: the synthetic global mesh
    of ``synth_global_arrays`` with the gx1 land mask resampled to ny x nx
    (its polar land bands; the reference's global_gx3 and global_tp1
    files are not in the repository), open water at the north edge."""
    import numpy as np
    from scipy.io import netcdf_file
    from cice5_tpu_torch.grid import _gx1_kmt, synth_global_arrays
    kmt = _gx1_kmt()
    kmt = kmt[np.arange(ny) * kmt.shape[0] // ny][
        :, np.arange(nx) * kmt.shape[1] // nx]
    ulat, ulon, htn, hte, angle, kmt = synth_global_arrays(kmt)
    with netcdf_file(os.path.join(d, f"{stem}.grid.nc"), "w") as f:
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        for name, a in (("ulat", ulat), ("ulon", ulon), ("htn", htn * 100.0),
                        ("hte", hte * 100.0), ("angle", angle)):
            f.createVariable(name, "d", ("nj", "ni"))[:] = a
    with netcdf_file(os.path.join(d, f"{stem}.kmt.nc"), "w") as f:
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        f.createVariable("kmt", "i", ("nj", "ni"))[:] = kmt


def coupler_fluxes(cfg, seed):
    """{field: (ncat, ny, nx) NumPy float array} of the per-category
    surface fluxes an atmosphere sends under calc_Tsfc=False."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shp = (cfg.ncat, cfg.grid.ny, cfg.grid.nx)
    fs = rng.uniform(*CPL_FLUX["fsurf"], shp)
    return dict(fsurfn_f=fs, fcondtopn_f=fs.copy(),
                flatn_f=rng.uniform(*CPL_FLUX["flat"], shp),
                fsensn_f=rng.uniform(*CPL_FLUX["fsens"], shp))


def option_path(label, m, st, nsteps, expect, drive="rollout", cm=None,
                grid_read_s=None, nwarm=2, run_kw=None, report=None):
    """Drive one path of phases 9 and 10: ``nwarm`` warm-up steps (the
    first an eager step and the capture), then ``nsteps`` timed steps
    through ``Model.run`` (``drive="run"``, with ``run_kw``),
    ``Model.rollout`` or the coupled model ``cm`` with the launch counters
    set to 0 just before and read just after (each kernel
    ``expect[name]`` launches per step), the bench.py guards, and the
    graph rollout against the eager step at 0.0 (``graph_phase``). Prints
    the path's line and one JSON line, with ``report(model, state,
    diag)``'s entries added. Returns that line (the launches per step of
    each kernel launched under "launches_per_step")."""
    import torch
    from cice5_tpu_torch.ops import kernels
    cfg = m.cfg
    f0 = m.forcing_at(0)
    t0 = time.perf_counter()
    if cm is not None:
        st, diag = cm.run(st, nwarm)
        f0 = cm._forcing
    else:
        st, diag = m.rollout(st, f0, nwarm)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check_health(m, st, diag, f"{label} post-warmup")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if cm is not None:
        st, diag = cm.run(st, nsteps, start_step=nwarm)
    elif drive == "run":
        st = m.run(st, nsteps, start_step=nwarm, check_every=1,
                   log=lambda *a: None, **(run_kw or {}))
        diag = None
    else:
        st, diag = m.rollout(st, f0, nsteps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / nsteps * 1e3
    launches = kernels.launch_counts()
    want = {k: v * nsteps for k, v in expect.items()}
    want.update({k: 0 for k in kernels.KERNELS if k not in want})
    frac = check_health(m, st, diag, f"{label} post-timing")
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    (g,) = m.graphs.values()
    cells = cfg.grid.nx * cfg.grid.ny
    through = {"run": "Model.run", "rollout": "Model.rollout"}[drive] \
        if cm is None else "CoupledModel.run"
    per_step = {k: v // nsteps for k, v in launches.items() if v}
    print(f"main path {label} on {card_line()}: {cfg.grid.ny}x{cfg.grid.nx} "
          f"{cfg.dtype} ndte={cfg.dyn.ndte} nilyr={cfg.nilyr} ktherm="
          f"{cfg.thermo.ktherm} calc_Tsfc={cfg.thermo.calc_Tsfc}, through "
          f"{through}, {nsteps} timed steps after {nwarm}: {ms:.3f} ms/step "
          f"({cells / ms * 1e3:.4e} cell-steps/s); launches per step "
          f"{per_step}; ice fraction {frac:.4f}; peak device memory "
          f"{peak / 2**30:.3f} GiB; capture {g.capture_seconds:.2f} s, "
          f"first {nwarm} steps {first_s:.2f} s", flush=True)
    graph_phase(label, m, st, f0, 2)
    line = dict(path=label, shape=[cfg.grid.ny, cfg.grid.nx],
                dtype=cfg.dtype, ndte=cfg.dyn.ndte, nilyr=cfg.nilyr,
                ktherm=cfg.thermo.ktherm, calc_Tsfc=cfg.thermo.calc_Tsfc,
                through=through, card=card_line(), warmup_steps=nwarm,
                timed_steps=nsteps, ms_per_step=ms,
                cell_steps_per_s=cells / ms * 1e3,
                launches_per_step=per_step, ice_fraction=frac,
                peak_memory_bytes=peak, capture_s=g.capture_seconds)
    if grid_read_s is not None:
        line["grid_read_s"] = grid_read_s
    if report is not None:
        line.update(report(m, st, diag))
    print(f"{label}: " + json.dumps(line), flush=True)
    return line


def fresh_path():
    """Free the previous path's device memory and start a peak count."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def build_standalone(builder, grid_dir, dtype="float32"):
    """``gx3_config(grid_dir)`` or ``tp1_config(grid_dir)`` (116x100,
    nilyr=7, ndte=120) at ``dtype``: a Model that reads its grid through
    make_grid -> popgrid -> read_pop_grid_nc, and its initial state (the
    default 70N/60S ice edge)."""
    from cice5_tpu_torch import config
    from cice5_tpu_torch.driver.model import Model
    cfg = getattr(config, f"{builder}_config")(grid_dir, dtype=dtype,
                                               accum_dtype=dtype)
    m = Model(cfg)
    return m, m.init_state(), m.forcing_at(0)


def gx1_topo_config(dtype="float32"):
    """gx1_parity_config with topographic ponds in place of level ponds."""
    import dataclasses
    from cice5_tpu_torch.config import gx1_parity_config
    cfg = gx1_parity_config(dtype=dtype, accum_dtype=dtype)
    return cfg.replace(tracers=dataclasses.replace(
        cfg.tracers, tr_pond_lvl=False, tr_pond_topo=True))


def build_gx1_topo(dtype="float32"):
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import synth_gx1_grid
    cfg = gx1_topo_config(dtype)
    m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
    return m, m.init_state(), m.forcing_at(0)


def bl99_option_config(option, dtype="float32"):
    """bench_easy_config (384x320) with ktherm=0 or calc_Tsfc=False."""
    import dataclasses
    from cice5_tpu_torch.config import bench_easy_config
    cfg = bench_easy_config(dtype=dtype)
    th = dict(ktherm=0) if option == "ktherm0" else dict(calc_Tsfc=False)
    return cfg.replace(thermo=dataclasses.replace(cfg.thermo, **th))


def option_kernels(label, build_model, scheme=None):
    """Kernels A, B and C against their plain versions on the arguments of
    one step of ``build_model`` (after a warm-up step) in float64 and
    float32, with phase 2's tolerances (A, B) and C's float64 check at
    1e-12 with its float32 accuracy held to the plain float32's against
    float64 (``dedd_full_size_check``); C must have been called with pond
    setup ``scheme``. Prints A's plan and cost split (``evp_costs``) and
    C's time as a CUDA graph replay."""
    from cice5_tpu_torch.models.radiation import dedd
    caps = {dt: capture(build_model, dt) for dt in ("float64", "float32")}
    evp_phase(caps["float64"][1]["evp"], caps["float32"][1]["evp"], label)
    evp_costs(caps["float32"][1]["evp"], label)
    remap_phase(caps["float64"][1]["remap"], caps["float32"][1]["remap"],
                caps["float64"][0], caps["float32"][0], label)
    kw = caps["float32"][1]["dedd"]
    if kw["pond_scheme"] != scheme:
        fail(f"{label}: shortwave_dedd called with pond_scheme="
             f"{kw['pond_scheme']!r}, expected {scheme!r}")
    c = dedd_full_size_check(kw)
    ncat, ny, nx = kw["aicen"].shape
    print(f"shortwave_dedd {label} at {ny}x{nx}, nilyr={kw['nilyr']}, "
          f"pond_scheme={kw['pond_scheme']!r}: float64 vs "
          f"shortwave_dEdd_plain worst field {c['f64'][0]}: rel diff "
          f"{c['f64'][1]:.3e} (bound 1e-12); float32 vs the plain float32 "
          f"worst field {c['f32'][0]}: rel diff {c['f32'][1]:.3e}; the "
          f"kernel's float32 worst distance from the float64 result beyond "
          f"the plain float32's {c['excess'][1]:.3e} of scale "
          f"({c['excess'][0]}; bound {DEDD_F32_TOL:.0e}); lit columns "
          f"{c['lit']} of {c['cols']}, unlit exact zeros: {c['dark']}",
          flush=True)
    if not (c["f64"][1] <= 1e-12 and c["excess"][1] <= DEDD_F32_TOL
            and c["dark"]):
        fail(f"shortwave_dedd disagrees with shortwave_dEdd_plain "
             f"({label})")
    ms, _ = graph_ms(lambda: dedd.shortwave_dEdd_ncat(**kw), reps=50)
    bound = dedd_bound(kw)
    print(f"shortwave_dedd {label} f32: kernel {ms:.4f} ms in a CUDA graph,"
          f" plain {c['plain_ms']:.3f} ms, bound {bound[0]:.4f} ms "
          f"({bound[2]})", flush=True)


def small_option_check(label, cfg, extra=(), diag_extra=(),
                       frozen_sea=False):
    """One option set through the kernels on the GPU against the plain
    versions on the CPU: 24x16 float64, ndte=8, a northern-summer noon
    with rain on the ice, ponds seeded where there is ice (with
    ``frozen_sea`` the open ocean under air below freezing starts at its
    freezing point, as the flag sets' references do), one warm-up step on
    the CPU, then two steps on each device, within 3e-8 of each field's
    scale (tracers as conserved amounts; the State fields ``extra`` too,
    the stresses among them within 1e-5; the StepDiag fields
    ``diag_extra`` each entry of its leading axis on its own scale); and
    on the GPU the graph rollout against the eager step at 0.0."""
    import torch
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.models.thermo.itd import tracer_weights
    from cice5_tpu_torch.ops import check
    mc = Model(cfg, grid=small_parity_grid(cfg, "cpu"), device="cpu")
    mg = Model(cfg, grid=small_parity_grid(cfg, "cpu"), device="cuda")
    st = mc.init_state()
    tr = mc.tr
    if tr.nt_apnd >= 0:
        gen = torch.Generator().manual_seed(7)
        has = st.aicen > 0
        u = lambda lo, hi: torch.where(has, lo + (hi - lo) * torch.rand(
            has.shape, generator=gen, dtype=torch.float64), 0.0)
        trc = st.trcrn.clone()
        trc[:, tr.nt_apnd], trc[:, tr.nt_hpnd] = u(0.1, 0.5), u(0.02, 0.3)
        st = st.replace(trcrn=trc)
    f = mc.forcing_at(172 * 24 + 12)
    f = f.replace(frain=torch.full_like(f.frain, 2.0e-5))
    if not cfg.thermo.calc_Tsfc:
        f = f.replace(**{k: torch.as_tensor(v) for k, v in
                         coupler_fluxes(cfg, seed=11).items()})
    if frozen_sea:
        cold = (f.Tair < 273.15 + f.Tf) & mc.grid.tmask
        st = st.replace(sst=torch.where(cold, f.Tf, st.sst))
    st, _ = mc.step(st, f)
    ref, ref_d = mc.rollout(st, f, 2)
    got, got_d = mg.rollout(st.to("cuda"), f.to("cuda"), 2)
    got = got.to("cpu")
    torch.cuda.synchronize()
    if cfg.dyn.monotonicity_check and int(ref_d.transport_mono_bad) != \
            int(got_d.transport_mono_bad):
        fail(f"small {label} run: {int(got_d.transport_mono_bad)} "
             f"monotonicity violations on the GPU, "
             f"{int(ref_d.transport_mono_bad)} on the CPU")
    graph_against_eager(mg, st.to("cuda"), f.to("cuda"),
                        f"small float64 {label} run")
    stress = tuple(k for k in extra
                   if k in ("stressp", "stressm", "stress12"))
    names = ("aicen", "vicen", "vsnon", "uvel", "vvel", "sst") + tuple(
        k for k in extra if k not in stress)
    amount = lambda s: tracer_weights(tr, s.aicen, s.vicen, s.vsnon,
                                      s.trcrn) * s.trcrn
    r = {k: getattr(ref, k) for k in names}
    g = {k: getattr(got, k) for k in names}
    r["trcrn_amount"], g["trcrn_amount"] = amount(ref), amount(got)
    axes = {"trcrn_amount": 1}
    for k in diag_extra:
        r[k], g[k] = getattr(ref_d, k), getattr(got_d, k).to("cpu")
        if r[k].dim() == 3:
            axes[k] = 0
    field, rel, err = check.worst(check.field_errors(r, g, axes=axes))
    live = ""
    if tr.nt_apnd >= 0:
        vol = (got.trcrn[:, tr.nt_apnd] * got.trcrn[:, tr.nt_hpnd]
               * got.aicen).sum()
        live = f"; pond volume {float(vol):.4e}"
        if not float(vol) > 0.0:
            fail(f"small float64 {label} run: no pond water")
    print(f"small float64 {label} run (24x16 {cfg.grid.ns_boundary} north, "
          f"ndte=8, 2 steps after a warm-up step): GPU kernels vs CPU plain "
          f"max abs diff {err:.3e}; worst field {field}: rel diff "
          f"{rel:.3e} (bound 3e-8 x the field's scale){live}", flush=True)
    if not rel <= 3e-8:
        fail(f"small {label} run: {field} on the GPU differs from the CPU "
             f"by {rel:.3e} of its scale (> 3e-8)")
    if stress:
        field, rel, err = check.worst(check.field_errors(
            {k: getattr(ref, k) for k in stress},
            {k: getattr(got, k) for k in stress}))
        print(f"small float64 {label} run: stresses max abs diff "
              f"{err:.3e}; worst {field}: rel diff {rel:.3e} (bound 1e-5 x "
              f"the field's scale)", flush=True)
        if not rel <= 1e-5:
            fail(f"small {label} run: {field} on the GPU differs from the "
                 f"CPU by {rel:.3e} of its scale (> 1e-5)")


def options_phase():
    """Phase 9: the standalone configurations gx3 and tp1 (116x100, grids
    read from netCDF3 files this phase writes), the gx1-parity model with
    topographic ponds (384x320), and the BL99 model with zero-layer thermo
    (``Model.rollout``) and with the coupler's surface fluxes
    (calc_Tsfc=False, ``CoupledModel`` with NumPy fluxes each step);
    kernels A, B and C on the gx3 and gx1_topo inputs; the small float64
    GPU-vs-CPU run of every column option set of
    ``cice5_tpu_torch/small_sets.py``."""
    import tempfile
    import torch
    from cice5_tpu_torch import small_sets
    from cice5_tpu_torch.driver.coupled import CoupledModel
    from cice5_tpu_torch.driver.model import Model
    abc = dict(evp_sweep=1, remap_flux_both=1, shortwave_dedd=1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_grids_") as tmp:
        write_pop_pair(tmp, "global_gx3", 116, 100)
        write_pop_pair(tmp, "global_tp1", 116, 100)
        for label in ("gx3", "tp1"):
            fresh_path()
            t0 = time.perf_counter()
            m, st, _ = build_standalone(label, tmp)
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            option_path(label, m, st, 4, abc, drive="run",
                        grid_read_s=read_s)
            del m, st
        option_kernels("gx3", lambda dt: build_standalone("gx3", tmp, dt),
                       scheme="lvl")
    fresh_path()
    m, st, _ = build_gx1_topo()
    option_path("gx1_topo", m, st, 5, abc)
    del m, st
    option_kernels("gx1_topo", build_gx1_topo, scheme="topo")
    fresh_path()
    m = Model(bl99_option_config("ktherm0"))
    option_path("bl99_options ktherm=0", m,
                m.init_state(ice_mask=m.grid.tmask), 5,
                dict(evp_sweep=1, remap_flux_both=1))
    fresh_path()
    m = Model(bl99_option_config("calc_Tsfc"))
    sent = [coupler_fluxes(m.cfg, seed=k) for k in range(2)]
    cm = CoupledModel(model=m, get_atm=lambda t: sent[int(t // 3600) % 2])
    option_path("bl99_options calc_Tsfc=False", m,
                m.init_state(ice_mask=m.grid.tmask), 4,
                dict(evp_sweep=1, remap_flux_both=1), cm=cm)
    del m, cm
    fresh_path()
    for label, cfg in small_sets.column_option_sets().items():
        small_option_check(label, cfg)


def pytorch_kernels_per_step(m, st, f, nsteps=1):
    """(PyTorch kernels, their device ms) per step of ``Model.rollout``
    (graph replays) under torch.profiler, the hand-written kernels
    apart."""
    import torch
    own = ("evp_resident", "remap_tiles", "remap_recon", "remap_flux",
           "shortwave_dedd")
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        m.rollout(st, f, nsteps)
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not any(k in e.name for k in own)):
            n += 1
            us += e.time_range.elapsed_us()
    return n / nsteps, us / 1e3 / nsteps


def dynamics_phase():
    """The dynamics and transport options at full width
    (384x320, ndte=120, float32): gx1-parity on a T-fold seam with the
    transport checks (``gx1_tfold``, ``Model.rollout``: A on the T-fold,
    B and C once per step), gx1-parity with EAP and the per-category
    mechred diagnostics (``gx1_eap``, ``Model.run`` with a history stream
    of the EAP and mechred fields: B and C once per step, A never; its
    PyTorch kernels per step), the BL99 model with upwind transport
    (``bl99_upwind``, ``Model.rollout``: A once per step, B never); A
    against ``subcycle_sweep`` and B against its plain version on the
    T-fold inputs, A also with the revised EVP's parameters
    (``revised_evp_phase``); the small float64 GPU-vs-CPU run of each
    dynamics option set. Returns ({path: launches per step}, A's T-fold
    result, A's revised T-fold result)."""
    import dataclasses
    import tempfile
    import numpy as np
    from scipy.io import netcdf_file
    from cice5_tpu_torch.config import bench_easy_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import synth_gx1_grid
    from cice5_tpu_torch.io import history as hist
    from cice5_tpu_torch.profile_step import gx1_eap_config, gx1_tfold_config
    from cice5_tpu_torch import small_sets
    launches = {}

    def build(cfg_fn):
        def b(dtype="float32"):
            cfg = cfg_fn().replace(dtype=dtype, accum_dtype=dtype)
            m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
            return m, m.init_state(), m.forcing_at(0)
        return b

    def checks(m, st, diag):
        # the count of tracer values outside their pre-transport bounds is
        # the reference scheme's (ice edges and the T-fold's fold rows;
        # ROADMAP section C): printed here, and held card against CPU by
        # the small transport_checks run below
        bad = int(diag.transport_mono_bad)
        err = float(diag.transport_conserv_err)
        if not err <= 1e-5:
            fail(f"gx1_tfold: transport conservation error {err:.3e}")
        return dict(transport_mono_bad=bad, transport_conserv_err=err)

    fresh_path()
    m, st, _ = build(gx1_tfold_config)()
    if m.topo.ns != "tripoleT":
        fail("gx1_tfold: not on a T-fold seam")
    launches["gx1_tfold"] = option_path(
        "gx1_tfold", m, st, 5, dict(evp_sweep=1, remap_flux_both=1,
                                    shortwave_dedd=1),
        report=checks)["launches_per_step"]
    del m, st
    caps = {dt: capture(build(gx1_tfold_config), dt)
            for dt in ("float64", "float32")}
    if caps["float32"][1]["evp"][2].ns != "tripoleT":
        fail("gx1_tfold: kernel A was not called on the T-fold")
    a = evp_phase(caps["float64"][1]["evp"], caps["float32"][1]["evp"],
                  "gx1_tfold")
    a["eager_ms"], a["ms"] = a["ms"], evp_costs(caps["float32"][1]["evp"],
                                                "gx1_tfold")
    a_rev = revised_evp_phase(caps["float64"], caps["float32"], "gx1_tfold")
    remap_phase(caps["float64"][1]["remap"], caps["float32"][1]["remap"],
                caps["float64"][0], caps["float32"][0], "gx1_tfold",
                f32_update="accuracy")
    del caps

    fresh_path()
    m, st, _ = build(gx1_eap_config)()
    names = {f.name for f in hist.EAP_FIELDS + hist.MECHRED_CAT_FIELDS}
    fields = [f for f in hist.available_fields(m.cfg, m.tr)
              if f.name in names]
    if {f.name for f in fields} != names:
        fail(f"gx1_eap: the history catalog lacks "
             f"{names - {f.name for f in fields}}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eap_") as tmp:
        def eap_report(m, st, diag):
            kn, kms = pytorch_kernels_per_step(m, st, m.forcing_at(6))
            files = sorted(os.listdir(tmp))
            if len(files) != 1:
                fail(f"gx1_eap: history files {files}")
            with netcdf_file(f"{tmp}/{files[0]}", "r", mmap=False) as nc:
                for k in names:
                    if not np.isfinite(np.asarray(nc.variables[k][:])).all():
                        fail(f"gx1_eap: history {k} is not finite")
                a11 = np.asarray(nc.variables["a11"][:])
                krdg = np.asarray(nc.variables["krdgn"][:])
            if not (np.abs(a11 - 0.5).max() > 0.0 and krdg.max() > 1.0):
                fail("gx1_eap: the structure tensor or the mechred stack "
                     "did not move")
            return dict(pytorch_kernels_per_graph_step=kn,
                        pytorch_device_ms_per_graph_step=kms,
                        history_fields=sorted(names),
                        a11_range=[float(a11.min()), float(a11.max())])

        launches["gx1_eap"] = option_path(
            "gx1_eap", m, st, 4, dict(remap_flux_both=1, shortwave_dedd=1),
            drive="run", report=eap_report, run_kw=dict(
                history=hist.HistoryStream(fields, freq="1", freq_n=4),
                history_dir=tmp))["launches_per_step"]
    del m, st

    fresh_path()
    cfg = bench_easy_config()
    m = Model(cfg.replace(dyn=dataclasses.replace(cfg.dyn,
                                                  advection="upwind")))
    launches["bl99_upwind"] = option_path(
        "bl99_upwind", m, m.init_state(ice_mask=m.grid.tmask), 5,
        dict(evp_sweep=1))["launches_per_step"]
    del m
    fresh_path()
    for label, cfg in small_sets.dyn_option_sets().items():
        small_option_check(label, cfg,
                           small_sets.DYN_STATE if cfg.dyn.kdyn == 2 else ())
    return launches, a, a_rev


def tracer_health(m, st, label):
    """The tracer guards of the gx1_bgc path: every tracer finite, the
    aerosol and BGC concentrations >= 0 (to puny, as
    tests/test_aerosol.py holds the JAX package's), the brine height
    ratio in (0, MAXHBR] where there is ice. Returns their ranges."""
    import torch
    from cice5_tpu_torch import constants as ct
    from cice5_tpu_torch.models.tracers import brine
    tr, t = m.tr, st.trcrn
    if not bool(torch.isfinite(t).all()):
        fail(f"{label}: a tracer is not finite")
    aero = t[:, tr.nt_aero:tr.nt_aero + 4 * tr.n_aero]
    bgc = t[:, tr.nt_bgc[0]:tr.nt_bgc[0] + tr.nbtrcr]
    fbri = t[:, tr.nt_fbri][st.aicen > ct.puny]
    out = dict(aero_min=float(aero.min()), aero_max=float(aero.max()),
               bgc_min=float(bgc.min()), bgc_max=float(bgc.max()),
               fbri_range=[float(fbri.min()), float(fbri.max())])
    if not (out["aero_min"] >= -ct.puny and out["bgc_min"] >= -ct.puny):
        fail(f"{label}: negative aerosol or BGC concentration {out}")
    if not (out["fbri_range"][0] > 0.0
            and out["fbri_range"][1] <= brine.MAXHBR):
        fail(f"{label}: brine height ratio outside (0, {brine.MAXHBR}]: "
             f"{out['fbri_range']}")
    return out


def tracer_phase():
    """The aerosol, brine and skeletal-BGC tracers at full width: the
    gx1-parity model with n_aero=3, the brine height and the nine BGC
    tracers (``gx1_bgc``, 384x320, float32, ndte=120, 39 tracers) through
    ``Model.run`` with a history stream of the aerosol, brine and BGC
    fields (A, B and C once per step; the tracer guards; the PyTorch
    kernels per graph step); B against its plain version on the gx1_bgc
    inputs (the 39-tracer table, float64 and float32); the small float64
    GPU-vs-CPU run of each tracer set, the tracer fluxes included.
    Returns ({path: launches per step}, B's result)."""
    import tempfile
    import numpy as np
    import torch
    from scipy.io import netcdf_file
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import synth_gx1_grid
    from cice5_tpu_torch.io import history as hist
    from cice5_tpu_torch import small_sets
    from cice5_tpu_torch.profile_step import gx1_bgc_config, run_split

    def build(dtype="float32"):
        cfg = gx1_bgc_config().replace(dtype=dtype, accum_dtype=dtype)
        m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
        return m, m.init_state(), m.forcing_at(0)

    fresh_path()
    m, st, _ = build()
    if m.tr.ntrcr != 39:
        fail(f"gx1_bgc: {m.tr.ntrcr} tracers, expected 39")
    names = {f.name for f in hist.BGC_FIELDS + hist.BGC_3DB_FIELDS
             + hist.aero_fields(m.tr.n_aero)
             + hist.skl_bgc_fields(m.tr.bgc_names)}
    fields = [f for f in hist.available_fields(m.cfg, m.tr)
              if f.name in names]
    if {f.name for f in fields} != names:
        fail(f"gx1_bgc: the history catalog lacks "
             f"{names - {f.name for f in fields}}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bgc_") as tmp:
        def bgc_report(m, st, diag):
            out = tracer_health(m, st, "gx1_bgc")
            _, d = m.step(st, m.forcing_at(6))
            for k in small_sets.TRACER_DIAG:
                if not bool(torch.isfinite(getattr(d, k)).all()):
                    fail(f"gx1_bgc: StepDiag.{k} is not finite")
            if not (float(d.PP_net.max()) > 0.0
                    and float(d.faero_ocn.abs().max()) > 0.0):
                fail("gx1_bgc: no primary production or no aerosol flux "
                     "to the ocean")
            kn, kms = pytorch_kernels_per_step(m, st, m.forcing_at(6))
            files = sorted(os.listdir(tmp))
            if len(files) != 1:
                fail(f"gx1_bgc: history files {files}")
            with netcdf_file(f"{tmp}/{files[0]}", "r", mmap=False) as nc:
                for k in names:
                    if not np.isfinite(np.asarray(nc.variables[k][:])).all():
                        fail(f"gx1_bgc: history {k} is not finite")
                nkbio = nc.dimensions["nkbio"]
            if nkbio != m.cfg.nilyr + 2:
                fail(f"gx1_bgc: {nkbio} bio-grid levels in the history")
            # the same run again, its ms per step split by part
            with tempfile.TemporaryDirectory(prefix="chip_smoke_split_") as t2:
                _, split = run_split(
                    m, st, 4, start_step=6, check_every=1,
                    log=lambda *a: None, history_dir=t2,
                    history=hist.HistoryStream(fields, freq="1", freq_n=4))
            print(f"gx1_bgc Model.run split on {card_line()} (ms per step, "
                  f"each part synchronized): {json.dumps(split)}", flush=True)
            return dict(out, ntrcr=m.tr.ntrcr, run_split_ms=split,
                        PP_net_max=float(d.PP_net.max()),
                        faero_ocn_max=float(d.faero_ocn.abs().max()),
                        flux_bio_max=float(d.flux_bio.abs().max()),
                        pytorch_kernels_per_graph_step=kn,
                        pytorch_device_ms_per_graph_step=kms,
                        history_fields=len(names))

        launches = {"gx1_bgc": option_path(
            "gx1_bgc", m, st, 4, dict(evp_sweep=1, remap_flux_both=1,
                                      shortwave_dedd=1),
            drive="run", report=bgc_report, run_kw=dict(
                history=hist.HistoryStream(fields, freq="1", freq_n=4),
                history_dir=tmp))["launches_per_step"]}
    del m, st
    caps = {dt: capture(build, dt) for dt in ("float64", "float32")}
    ntrace = caps["float32"][1]["remap"][3].shape[1]
    print(f"remap_flux_both gx1_bgc: {ntrace} remapped tracer fields "
          f"(mass-weighted table of the 39-tracer registry)", flush=True)
    b = remap_phase(caps["float64"][1]["remap"], caps["float32"][1]["remap"],
                    caps["float64"][0], caps["float32"][0], "gx1_bgc")
    del caps
    fresh_path()
    for label, cfg in small_sets.tracer_option_sets().items():
        small_option_check(label, cfg, small_sets.TRACER_STATE,
                           small_sets.TRACER_DIAG)
    return launches, b


# the file-driven run starts on January 2, past the year seam (the first
# steps of a year read the previous year's last six-hourly record: the CPU
# tests hold that, tests/test_torch_forcing_data.py)
FILE_START, FILE_WARM, FILE_STEPS = 24, 2, 8


def write_forcing_tree(root, m, last_istep, seed=13):
    """NCAR-layout forcing files (``forcing_data.ncar_files``, big-endian
    float64 direct-access records) on the model's grid: 12 monthly records
    of fsw, cldf and fsnow (mm/month), and the six-hourly records of Tair,
    uatm, vatm, Qa and rhoa from the year's first through the last day a
    step up to ``last_istep`` reads. The values are the port's idealized
    forcing at each record's time with noise from ``seed``. Returns the
    bytes written."""
    import numpy as np
    import torch
    from cice5_tpu_torch.forcing import idealized_polar_forcing
    from cice5_tpu_torch.forcing_data import ncar_files
    rng = np.random.default_rng(seed)
    files = ncar_files(str(root), m.cfg.time.year_init)
    shape = m.grid.shape
    at = lambda yday: idealized_polar_forcing(
        shape, yday, dtype=torch.float64, tlat=m.grid.TLAT.double(),
        tlon=m.grid.TLON.double(), orb=m.orb, device=m.device)
    noise = lambda a: a * (1.0 + 0.05 * rng.standard_normal(shape))
    recs = {k: [] for k in files}
    for month in range(12):
        f = at(15.0 + 30.4 * month)
        fsw = (f.swvdr + f.swvdf + f.swidr + f.swidf).cpu().numpy()
        recs["fsw"].append(noise(fsw))
        recs["cldf"].append(np.clip(0.8 + 0.1 * rng.standard_normal(shape),
                                    0.0, 1.0))
        recs["fsnow"].append(noise(f.fsnow.cpu().numpy() * 86400.0 * 365.0
                                   / 12.0))
    nrec = 4 * (1 + last_istep * int(m.cfg.time.dt) // 86400) + 1
    for r in range(nrec):
        f = at(1.0 + (r + 1) / 4.0)     # valid at the end of its interval
        recs["Tair"].append(f.Tair.cpu().numpy()
                            + rng.standard_normal(shape))
        recs["uatm"].append(noise(f.uatm.cpu().numpy()))
        recs["vatm"].append(rng.standard_normal(shape))
        recs["Qa"].append(noise(f.Qa.cpu().numpy()))
        recs["rhoa"].append(noise(f.rhoa.cpu().numpy()))
    total = 0
    for name, path in files.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = np.stack(recs[name]).astype(">f8")
        data.tofile(path)
        total += data.nbytes
    return total


def _async_streams():
    """HistoryStreams whose run-loop writes pass ``use_async=True``."""
    from cice5_tpu_torch.io import history as hist

    class AsyncStreams(hist.HistoryStreams):
        def write_ready(self, grid, info, out_dir, case_name="cice5_tpu",
                        use_async=True):
            return super().write_ready(grid, info, out_dir, case_name,
                                       use_async=True)
    return AsyncStreams


def forcing_split_ms(tmp, m, steps):
    """The forcing's own ms per step over ``steps`` from a fresh
    FileForcing (its record cache cold, the files in the page cache):
    record reads, interpolation, the host-to-device copy, and the
    derivation on the card (``build_forcing``), each synchronized."""
    import torch
    from cice5_tpu_torch import constants as ct
    from cice5_tpu_torch.forcing_data import FileForcing, build_forcing, \
        to_device

    class Timed(FileForcing):
        read_s = 0.0

        def _read(self, name, yr, rec):
            t0 = time.perf_counter()
            a = super()._read(name, yr, rec)
            self.read_s += time.perf_counter() - t0
            return a

    ds = Timed(str(tmp), nx=m.cfg.grid.nx, ny=m.cfg.grid.ny,
               fyear_init=m.cfg.time.year_init,
               year_init=m.cfg.time.year_init)
    out = dict(read=0.0, interpolate=0.0, copy=0.0, derive=0.0)
    for istep in steps:
        info = m.calendar.info(istep, m.cfg.time.dt)
        yday, sec = float(int(info.yday)), float(info.sec)
        torch.cuda.synchronize()
        r0, t0 = ds.read_s, time.perf_counter()
        raw = ds.raw_at(yday, sec, info.year)
        t1 = time.perf_counter()
        dev = to_device(raw, m.cfg.xp_dtype, m.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        build_forcing(dev, yday + sec / ct.secday, m.grid,
                      dtype=m.cfg.xp_dtype, precip_units=ds.precip_units)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out["read"] += ds.read_s - r0
        out["interpolate"] += (t1 - t0) - (ds.read_s - r0)
        out["copy"] += t2 - t1
        out["derive"] += t3 - t2
    out = {k: v / len(steps) * 1e3 for k, v in out.items()}
    out["total"] = sum(out.values())
    return out


def file_forcing_phase():
    """The gx1-parity main path driven by forcing files (384x320, float32,
    ndte=120): synthetic NCAR-layout files written to a temporary
    directory, ``Model.run`` with ``FileForcing.provider`` (the bench.py
    guards, a state check every step, a 2-D history stream written with
    ``write_ready(use_async=True)`` and read back), A, B and C once per
    step; ms/step of ``Model.run`` on the files beside the same run on
    the idealized forcing (in turns, one call), and the forcing's own
    ms/step by part; a CICE 5 binary dump (with its tracer files) at step
    4 of 8 restored into a fresh Model, whose run must equal the
    continuous one at 0.0 in every State field the dump carries; the
    2-D history fields appended to the native asynchronous netCDF writer
    and read back equal, its ms per record beside a synchronous
    ``write_netcdf`` of the same fields; ``prescribe_ice`` on the state
    in float64 on the card against the CPU. One ``file_forcing:`` JSON
    line. Returns the launches per step."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from scipy.io import netcdf_file
    from cice5_tpu_torch.forcing_data import FileForcing
    from cice5_tpu_torch.io import history as hist
    from cice5_tpu_torch.io import restart_v5
    from cice5_tpu_torch.io.fastwriter import AsyncNetcdfWriter, build
    from cice5_tpu_torch.models.prescribed import prescribe_ice
    from cice5_tpu_torch.ops import kernels
    from cice5_tpu_torch.state import State
    quiet = lambda *a: None
    fresh_path()
    t0 = time.perf_counter()
    build()
    writer_build_s = time.perf_counter() - t0
    m, st0, _ = build_parity()
    cfg = m.cfg
    s0 = FILE_START + FILE_WARM
    expect = dict(evp_sweep=FILE_STEPS, remap_flux_both=FILE_STEPS,
                  shortwave_dedd=FILE_STEPS, evp_fused=0, remap_flux_edge=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_forcing_") as tmp:
        t0 = time.perf_counter()
        nbytes = write_forcing_tree(f"{tmp}/data", m,
                                    s0 + FILE_STEPS)
        write_s = time.perf_counter() - t0
        tree = dict(nx=cfg.grid.nx, ny=cfg.grid.ny,
                    fyear_init=cfg.time.year_init,
                    year_init=cfg.time.year_init)
        files = FileForcing(f"{tmp}/data", **tree)
        m.forcing_provider = files.provider(m)
        st_w = m.run(st0, FILE_WARM, start_step=FILE_START, log=quiet)
        torch.cuda.synchronize()
        check_health(m, st_w, None, "file_forcing post-warmup")
        fields2d = hist.available_fields(cfg, m.tr, include_3d=False)
        stream = hist.HistoryStream(fields2d, freq="1", freq_n=FILE_STEPS)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        full = m.run(st_w, FILE_STEPS, start_step=s0, check_every=1,
                     history=_async_streams()([stream]),
                     history_dir=f"{tmp}/history", log=quiet)
        torch.cuda.synchronize()
        checked_ms = (time.perf_counter() - t0) / FILE_STEPS * 1e3
        launches = kernels.launch_counts()
        frac = check_health(m, full, None, "file_forcing")
        if launches != expect:
            fail(f"file_forcing: launches {launches}, expected {expect}")
        names = sorted(os.listdir(f"{tmp}/history"))
        if len(names) != 1:
            fail(f"file_forcing: history files {names}")
        with netcdf_file(f"{tmp}/history/{names[0]}", "r",
                         mmap=False) as f:
            for k, v in f.variables.items():
                if not np.isfinite(np.asarray(v[:])).all():
                    fail(f"file_forcing: history {k} is not finite")
            history_aice = np.asarray(f.variables["aice"][0])

        # ms/step on the files and on the idealized forcing, in turns
        ways = {"files": files.provider(m), "idealized": None}
        ms = {k: [] for k in ways}
        for k in ("files", "idealized", "idealized", "files"):
            m.forcing_provider = ways[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.run(st_w, FILE_STEPS, start_step=s0, log=quiet)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) / FILE_STEPS * 1e3)
        split = forcing_split_ms(f"{tmp}/data", m,
                                 range(s0, s0 + FILE_STEPS))

        # the CICE 5 dump at step 4 of 8, a fresh Model, 4 more steps
        m.forcing_provider = files.provider(m)
        cont = m.run(st_w, FILE_STEPS, start_step=s0, log=quiet)
        half = m.run(st_w, FILE_STEPS // 2, start_step=s0, log=quiet)
        k = s0 + FILE_STEPS // 2
        core = f"{tmp}/restart/iced.{k:05d}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = restart_v5.write_restart_v5(half, core, cfg, m.tr, istep=k,
                                            time=k * cfg.time.dt)
        dump_write_s = time.perf_counter() - t0
        dump_bytes = sum(os.path.getsize(p) for p in paths)
        m2, _, _ = build_parity()
        m2.forcing_provider = FileForcing(f"{tmp}/data",
                                          **tree).provider(m2)
        t0 = time.perf_counter()
        st_r, meta = restart_v5.read_restart_v5(core, m2.cfg, m2.tr,
                                                device=m2.device)
        torch.cuda.synchronize()
        dump_read_s = time.perf_counter() - t0
        if meta["istep"] != k or meta.get("missing_files"):
            fail(f"file_forcing: v5 dump meta {meta}")
        out = m2.run(st_r, FILE_STEPS // 2, start_step=k, log=quiet)
        torch.cuda.synchronize()
        carried = [f.name for f in dataclasses.fields(State)
                   if f.name != "mlt_onset"]
        differ = [n for n in carried
                  if not torch.equal(getattr(out, n), getattr(cont, n))]
        restart_diff = max(float((getattr(out, n).double()
                                  - getattr(cont, n).double()).abs().max())
                           for n in carried if getattr(cont, n).numel())
        if differ:
            fail(f"file_forcing: the run restored from the CICE 5 dump "
                 f"differs from the continuous run in {differ} (max abs "
                 f"diff {restart_diff:.3e})")
        del m2, st_r, out

        # the 2-D history fields through the native writer
        s2d = hist.HistoryStream(fields2d, freq="1", freq_n=10 ** 9)
        _, d = m.step(full, m.forcing_at(s0 + FILE_STEPS))
        s2d.accum(hist.diag_to_values(
            d, full, m.grid, m.tr, m.forcing_at(s0 + FILE_STEPS),
            cfg.nilyr, cfg.nslyr), 0.0)
        varnames = [f.name for f in s2d.groups["2D"]]
        recs = 4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        avg = s2d.averages("2D").astype(np.float32)
        host_ms = (time.perf_counter() - t0) * 1e3
        path = f"{tmp}/async.nc"
        append_ms = []
        with AsyncNetcdfWriter(path, cfg.grid.ny, cfg.grid.nx,
                               varnames) as w:
            for r in range(recs):
                t0 = time.perf_counter()
                w.append(r * cfg.time.dt, dict(zip(varnames, avg)))
                append_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            w.flush()
            flush_ms = (time.perf_counter() - t0) * 1e3
        with netcdf_file(path, "r", mmap=False) as f:
            for r in range(recs):
                for i, name in enumerate(varnames):
                    if not np.array_equal(np.asarray(f.variables[name][r]),
                                          avg[i]):
                        fail(f"file_forcing: the native writer's {name} "
                             f"record {r} differs from what was appended")
        async_bytes = os.path.getsize(path)
        info = m.calendar.info(s0 + FILE_STEPS, cfg.time.dt)
        t0 = time.perf_counter()
        hist.write_netcdf(s2d, m.grid, info, f"{tmp}/sync.nc")
        sync_ms = (time.perf_counter() - t0) * 1e3
        sync_bytes = os.path.getsize(f"{tmp}/sync.nc")

    # prescribe_ice in float64, card against CPU
    st64 = full.to(m.device, dtype=torch.float64)
    g64 = m.grid.to(m.device, dtype=torch.float64)
    rng = np.random.default_rng(5)
    cov = torch.from_numpy(rng.uniform(-0.1, 1.1, m.grid.shape)).to(m.device)
    tf = torch.from_numpy(rng.uniform(-1.9, -1.7, m.grid.shape)).to(m.device)
    pg = prescribe_ice(st64, cov, g64, m.tr, cfg, m.hin_max, tf)
    pc = prescribe_ice(st64.to("cpu"), cov.cpu(), g64.to("cpu"), m.tr, cfg,
                       m.hin_max, tf.cpu())
    presc_diff = {n: float((getattr(pg, n).cpu() - getattr(pc, n)).abs()
                           .max()) for n in ("aicen", "vicen", "vsnon",
                                              "trcrn")}
    if any(v != 0.0 for v in presc_diff.values()):
        fail(f"file_forcing: prescribe_ice on the card differs from the "
             f"CPU in float64: {presc_diff}")
    line = dict(
        path="gx1-parity file forcing", shape=[cfg.grid.ny, cfg.grid.nx],
        dtype=cfg.dtype, ndte=cfg.dyn.ndte, card=card_line(),
        start_step=s0, steps=FILE_STEPS, launches=launches,
        forcing_bytes_written=nbytes, forcing_write_s=write_s,
        ice_fraction=frac,
        ms_per_step_run_checked_with_async_history=checked_ms,
        ms_per_step_run=ms, forcing_ms_per_step=split,
        v5_dump_bytes=dump_bytes, v5_dump_files=len(paths),
        v5_dump_write_s=dump_write_s, v5_dump_read_s=dump_read_s,
        v5_restart_max_abs_diff=restart_diff,
        history_aice_max=float(np.abs(history_aice).max()),
        native_writer=dict(
            build_s=writer_build_s, fields=len(varnames), records=recs,
            append_ms_per_record=append_ms, flush_ms=flush_ms,
            bytes=async_bytes, averages_to_host_ms=host_ms,
            sync_write_netcdf_ms=sync_ms, sync_bytes=sync_bytes),
        prescribe_ice_gpu_vs_cpu_float64=presc_diff)
    print("file_forcing: " + json.dumps(line), flush=True)
    m.forcing_provider = None
    return {"gx1-parity file forcing": {
        k: v // FILE_STEPS for k, v in launches.items()}}



# the mesh of the sharded phase: 4 gloo ranks on the one card
SHARDED_RANKS, SHARDED_MESH = 4, (2, 2)
SHARDED_EXPECT = dict(evp_sweep=0, remap_flux_both=3, shortwave_dedd=3,
                      evp_fused=0, remap_flux_edge=0)
SMALL_MESHES = ((2, 2), (1, 4), (4, 1))


def _state_diff(ref, got):
    """(max abs diff over every State field, the first field where it is
    not 0.0 or None)."""
    import dataclasses
    worst, first = 0.0, None
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if a.numel() == 0:
            continue
        d = float((a.double() - b.double()).abs().max())
        if d > 0.0 and first is None:
            first = f.name
        worst = max(worst, d)
    return worst, first


def tile_kernel_check(cap):
    """Kernels B and C against their plain versions on the float32
    arguments captured on one rank's tile (``check.capture_kernel_args``
    of a sharded step), each field against its own scale (B within 1e-5,
    C within DEDD_F32_TOL, as phase 2 holds them); eager CUDA-event
    times of one call, and the bounds of these inputs."""
    import torch
    from cice5_tpu_torch.models.radiation import dedd
    from cice5_tpu_torch.models.transport import remap as trm
    from cice5_tpu_torch.ops import check
    args, kw = cap["remap"], cap["dedd"]
    out = {}
    for name, kernel, plain, outputs, tol, bound in (
            ("remap_flux_both", lambda: trm.remap_flux_both(*args),
             lambda: trm.remap_flux_plain(*args), check.remap_outputs,
             1e-5, lambda: remap_bound(args, ("north", "east"))),
            ("shortwave_dedd", lambda: dedd.shortwave_dEdd_ncat(**kw),
             lambda: dedd.shortwave_dEdd_plain(**kw),
             lambda o: o._asdict(), DEDD_F32_TOL, lambda: dedd_bound(kw))):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        field, rel, err = check.worst(check.field_errors(outputs(ref),
                                                         outputs(got)))
        if not rel <= tol:
            fail(f"{name} on the sharded tile: {field} differs from the "
                 f"plain version by {rel:.3e} of its scale (> {tol:.0e})")
        bound_ms, bound_by, _ = bound()
        out[name] = dict(
            shape=[args[7], args[8]] if name == "remap_flux_both"
            else list(kw["aicen"].shape[-2:]), max_abs_err=err,
            worst_field=field, rel_err=rel,
            ms=cuda_time_ms(kernel, reps=20),
            plain_ms=cuda_time_ms(plain, reps=2), bound_ms=bound_ms,
            bound_by=bound_by)
    return out


def sharded_rank(rank: int, world: int, tmp: str):
    """One rank of the sharded phase (``python3 chip_smoke.py
    --sharded-rank RANK WORLD DIR``, spawned by ``sharded_phase``): gloo
    over the ``file://`` store DIR/store, the rank's tiles on the one
    card. Writes its result to DIR/rank<RANK>.json."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from cice5_tpu_torch.config import gx1_parity_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.driver.sharded import ShardedModel
    from cice5_tpu_torch.driver.step import step as step_fn
    from cice5_tpu_torch.grid import synth_gx1_grid
    from cice5_tpu_torch.io import shard_io
    from cice5_tpu_torch.ops import check, kernels
    from cice5_tpu_torch.parallel import distributed as pdist
    torch.set_num_threads(2)
    pdist.initialize_distributed("gloo", init_method=f"file://{tmp}/store",
                                 rank=rank, world_size=world)
    res = {"rank": rank}
    # the 384x320 gx1-parity model on the 2x2 mesh
    cfg = gx1_parity_config()
    grid = synth_gx1_grid(cfg, device="cuda")
    sm = ShardedModel(cfg, mesh_shape=SHARDED_MESH, grid=grid)
    t0 = time.perf_counter()
    st, diag = sm.step(sm.init_state(), sm.forcing_at(0))   # warm-up
    torch.cuda.synchronize()
    res["warmup_step_s"] = time.perf_counter() - t0
    warm = sm.global_view(st)
    steps, logs = [], []
    dist.barrier()
    kernels.reset_launch_counts()
    pdist.reset_traffic()
    t0 = time.perf_counter()
    st = sm.run(st, 3, start_step=1, diag_every=1, check_every=1,
                diag_fn=lambda i, s, d: steps.append((s, d)),
                log=logs.append)
    torch.cuda.synchronize()
    dist.barrier()
    res["ms_per_step_run"] = (time.perf_counter() - t0) / 3 * 1e3
    res["launches"] = kernels.launch_counts()
    res["traffic"] = pdist.traffic()
    res["diag_lines"] = logs
    gst, gdiag = steps[-1]
    res["state_bad"] = int(gdiag.state_bad)
    res["therm_converged"] = bool(gdiag.therm_converged)
    # the per-rank restart files, restored at 0.0
    shard_io.dump_sharded(st, f"{tmp}/dump", istep=4, time=4 * 3600.0,
                          mesh=sm.mesh)
    dist.barrier()
    back = sm.put(shard_io.restore_sharded(f"{tmp}/dump")[0])
    res["restore_max_abs_diff"] = _state_diff(st, back)[0]
    # B and C against their plain versions at the tile's shape, on the
    # arguments of one more sharded step (every rank steps, rank 0 checks)
    _, cap = check.capture_kernel_args(sm, st, sm.forcing_at(4))
    if rank == 0:
        res["tile_kernels"] = tile_kernel_check(cap)
    dist.barrier()
    if rank == 0:
        from cice5_tpu_torch.io import diagnostics as diag_mod
        res["health"] = check_health(sm, gst, None, "sharded 2x2")
        res["check_state"] = bool(diag_mod.check_state(
            gst, sm.grid, sm.tr, cfg.nilyr, cfg.nslyr, log=logs.append))
        # the one-device eager step (kernel A) on the same inputs
        m1 = Model(cfg, grid=grid)
        s1, first = warm, None
        worst = 0.0
        for k in range(3):
            s1, _ = step_fn(s1, m1.forcing_at(1 + k), *m1.step_args)
            d, f = _state_diff(s1, steps[k][0])
            if f is not None and first is None:
                first = f"{f} at step {k + 1}"
            worst = max(worst, d)
        torch.cuda.synchronize()
        res["max_abs_diff_vs_one_device"] = worst
        res["first_difference"] = first
    dist.barrier()
    # small float64 runs on three meshes against the CPU plain run
    res["small"] = {}
    for mesh in SMALL_MESHES:
        c = gx1_parity_config()
        c = c.replace(grid=dataclasses.replace(c.grid, ny=24, nx=16),
                      dyn=dataclasses.replace(c.dyn, ndte=8),
                      dtype="float64", accum_dtype="float64")
        mc = Model(c, grid=small_parity_grid(c, "cpu"), device="cpu")
        f = mc.forcing_at(172 * 24 + 12)
        f = f.replace(frain=torch.full_like(f.frain, 2.0e-5))
        s0, _ = mc.step(mc.init_state(), f)              # warm-up, CPU
        ss = ShardedModel(c, mesh_shape=mesh,
                          grid=small_parity_grid(c, "cpu"))
        sg, fg = ss.put(s0.to("cuda")), ss.put(f.to("cuda"))
        for _ in range(2):
            sg, dg = ss.step(sg, fg)
        gs, gd = ss.global_view((sg, dg))
        if rank == 0:
            ref, dref = mc.rollout(s0, f, 2)
            err = lambda a, b: float((a.cpu() - b).abs().max())
            res["small"][f"{mesh[0]}x{mesh[1]}"] = dict(
                vicen=err(gs.vicen, ref.vicen), uvel=err(gs.uvel, ref.uvel),
                fhocn=err(gd.fhocn, dref.fhocn))
    with open(f"{tmp}/rank{rank}.json", "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()


def nccl_rank(tmp: str):
    """The one-rank NCCL check (``python3 chip_smoke.py --nccl-rank DIR``):
    init, global_sum/global_min against the plain reductions, and one
    sharded gx1-parity step on a 1x1 mesh against the ``Model`` eager
    step. Writes DIR/nccl.json."""
    import torch
    import torch.distributed as dist
    from cice5_tpu_torch.driver.sharded import ShardedModel
    from cice5_tpu_torch.driver.step import step as step_fn
    from cice5_tpu_torch.ops import kernels
    from cice5_tpu_torch.parallel import halo
    from cice5_tpu_torch.parallel import distributed as pdist
    pdist.initialize_distributed("nccl", init_method=f"file://{tmp}/store",
                                 rank=0, world_size=1)
    m, st0, f0 = build_parity()
    sm = ShardedModel(m.cfg, mesh_shape=(1, 1), grid=m.grid)
    x = torch.randn(384, 320, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(3))
    res = dict(backend=dist.get_backend(),
               global_sum_diff=float(halo.global_sum(x, sm.topo) - x.sum()),
               global_min_diff=float(halo.global_min(x, sm.topo) - x.min()))
    kernels.reset_launch_counts()
    got, _ = sm.step(sm.put(st0), sm.put(f0))
    res["launches"] = kernels.launch_counts()
    ref, _ = step_fn(st0, f0, *m.step_args)
    torch.cuda.synchronize()
    res["max_abs_diff_vs_model"], res["first_difference"] = _state_diff(
        ref, got)
    with open(f"{tmp}/nccl.json", "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()


def _spawn(args, tmp, name):
    """Start ``python3 chip_smoke.py ARGS``, its output into
    tmp/<name>.log; returns (process, log path)."""
    log = os.path.join(tmp, f"{name}.log")
    with open(log, "w") as fh:
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              *map(str, args)], stdout=fh,
                             stderr=subprocess.STDOUT, cwd=HERE)
    return p, log


def _collect(procs, timeout, label):
    """Wait for the spawned processes (all killed at ``timeout``), print
    each one's output, and fail if one failed."""
    deadline = time.perf_counter() + timeout
    for p, _ in procs:
        try:
            p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        except subprocess.TimeoutExpired:
            pass
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    bad = False
    for k, (p, log) in enumerate(procs):
        text = open(log).read()
        print(f"--- {label} process {k} (exit {p.returncode}):\n"
              f"{text[-3000:]}", flush=True)
        bad |= p.returncode != 0
    if bad:
        fail(f"{label}: a spawned process failed")


def sharded_phase():
    """The multi-GPU path (``ShardedModel`` over ``torch.distributed``),
    in spawned processes whose output is printed here:

    - gloo, 4 ranks sharing the one card on a 2x2 mesh: the gx1-parity
      model at 384x320, float32, ndte=120, 192x160 per rank; a warm-up
      step, then 3 steps of ``ShardedModel.run`` with a diagnostics line
      and a state check each step, the launch counters and the halo
      traffic set to 0 just before and read just after (B and C once per
      rank per step, A and D never: on a mesh the EVP runs the subcycle
      loop with one halo exchange per subcycle, as the JAX step does);
      the bench.py guards on the gathered state; a ``dump_sharded`` /
      ``restore_sharded`` round trip at 0.0; the gathered state against
      the one-device eager step (kernel A) on the same inputs. Then the
      24x16 float64 gx1-parity model (land on the seam, ndte=8, 2 steps
      after a CPU warm-up step) on the 2x2, 1x4 and 4x1 meshes on the
      card against the one-device CPU run: vicen and uvel within 1e-8,
      fhocn within 1e-5, as the CPU tests hold them. Four processes
      sharing one card through host-staged halos are a correctness run:
      their ms/step is not a multi-GPU speed.
    - NCCL, 1 rank: init, ``global_sum`` / ``global_min`` against the
      plain reductions, and one sharded gx1-parity step on a 1x1 mesh
      equal to the ``Model`` eager step at 0.0.

    Prints one ``sharded:`` JSON line; returns the path's launches per
    step and rank."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        t0 = time.perf_counter()
        procs = [_spawn(["--sharded-rank", r, SHARDED_RANKS, tmp], tmp,
                        f"rank{r}") for r in range(SHARDED_RANKS)]
        _collect(procs, 600, "sharded gloo")
        ranks = [json.load(open(f"{tmp}/rank{r}.json"))
                 for r in range(SHARDED_RANKS)]
        gloo_s = time.perf_counter() - t0
        os.makedirs(f"{tmp}/nccl")
        procs = [_spawn(["--nccl-rank", f"{tmp}/nccl"], tmp, "nccl")]
        _collect(procs, 300, "sharded nccl")
        nccl = json.load(open(f"{tmp}/nccl/nccl.json"))
    r0 = ranks[0]
    for r in ranks:
        if r["launches"] != SHARDED_EXPECT:
            fail(f"sharded rank {r['rank']}: launches {r['launches']} in 3 "
                 f"steps, expected {SHARDED_EXPECT}")
        if r["state_bad"] or not r["therm_converged"]:
            fail(f"sharded rank {r['rank']}: state_bad {r['state_bad']}, "
                 f"thermo converged {r['therm_converged']}")
        if r["restore_max_abs_diff"] != 0.0:
            fail(f"sharded rank {r['rank']}: restored state differs by "
                 f"{r['restore_max_abs_diff']}")
    if not r0["check_state"] or len(r0["diag_lines"]) != 3:
        fail(f"sharded: check_state {r0['check_state']}, diagnostics "
             f"{r0['diag_lines']}")
    for mesh, e in r0["small"].items():
        if not (e["vicen"] <= 1e-8 and e["uvel"] <= 1e-8
                and e["fhocn"] <= 1e-5):
            fail(f"sharded small float64 {mesh}: card vs CPU {e}")
    if nccl["max_abs_diff_vs_model"] != 0.0:
        fail(f"sharded NCCL 1x1 step differs from the Model eager step by "
             f"{nccl['max_abs_diff_vs_model']} ({nccl['first_difference']})")
    if abs(nccl["global_sum_diff"]) > 1e-2 or nccl["global_min_diff"]:
        fail(f"sharded NCCL reductions: {nccl}")
    per_step = {k: v // 3 for k, v in r0["launches"].items()}
    line = dict(
        path="gx1-parity sharded 2x2", shape=[384, 320], tile=[192, 160],
        dtype="float32", ndte=120, card=card_line(),
        note=("4 gloo processes share one card and stage every halo "
              "through host memory: a correctness run, not a multi-GPU "
              "speed"),
        ranks=SHARDED_RANKS, mesh=list(SHARDED_MESH),
        launches_per_step_per_rank=per_step,
        evp="subcycle loop with one halo exchange per subcycle (kernel A "
            "is not launched on a mesh)",
        ms_per_step_run=[r["ms_per_step_run"] for r in ranks],
        warmup_step_s=[r["warmup_step_s"] for r in ranks],
        exchanges_per_step=[r["traffic"]["exchanges"] / 3 for r in ranks],
        halo_bytes_per_step=[r["traffic"]["bytes"] / 3 for r in ranks],
        collectives_per_step=[r["traffic"]["collectives"] / 3
                              for r in ranks],
        ice_fraction=r0["health"],
        restore_max_abs_diff=max(r["restore_max_abs_diff"] for r in ranks),
        max_abs_diff_vs_one_device=r0["max_abs_diff_vs_one_device"],
        first_difference=r0["first_difference"],
        small_float64_card_vs_cpu=r0["small"], nccl=nccl,
        tile_kernels=r0["tile_kernels"],
        phase_s=time.perf_counter() - t0, gloo_s=gloo_s)
    print(r0["diag_lines"][-1])
    print(f"sharded: {json.dumps(line)}", flush=True)
    return {"gx1-parity sharded 2x2 (per rank)": per_step}, \
        r0["tile_kernels"]

def build_cesm2_layers(dtype="float32"):
    """``gx1_parity_config(nilyr=8, nslyr=3)`` on synth_gx1_grid (384x320,
    ndte=120): CESM2's column in the gx1-parity physics, the default
    70N/60S ice edge, forcing of step 0."""
    from cice5_tpu_torch.config import gx1_parity_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import synth_gx1_grid
    nilyr, nslyr = CESM2_LAYERS
    cfg = gx1_parity_config(nilyr=nilyr, nslyr=nslyr, dtype=dtype,
                            accum_dtype=dtype)
    m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
    return m, m.init_state(), m.forcing_at(0)


def dedd_layers_check(kw64, kw32, label):
    """Kernel C at the layer counts of the captured arguments (float64
    ``kw64``, float32 ``kw32``): in float64 on the captured inputs with
    the ice-free and dark bands, and with level ponds on every ice column,
    within 1e-12 of each field's (and layer's) scale, unlit columns exact
    zeros; in float32 the kernel's result no farther from the float64 one
    than the plain float32's beyond DEDD_F32_TOL of scale
    (``dedd_full_size_check``). Times one float32 call as a CUDA graph
    replay and eagerly, with the plain version's time, the bound and the
    resident blocks per SM of both instantiations."""
    import torch
    from cice5_tpu_torch.models.radiation import dedd
    from cice5_tpu_torch.ops import check, kernels
    nilyr, nslyr = kw32["nilyr"], kw32["nslyr"]
    bad = []
    for tag, kw in (("f64", kw64), ("f64 lvl ponds", with_ponds(kw64))):
        kw = dedd_args_with_band(kw)
        ref = dedd.shortwave_dEdd_plain(**kw)
        got = dedd.shortwave_dEdd_ncat(**kw)
        torch.cuda.synchronize()
        field, rel, err = check.worst(check.field_errors(
            ref._asdict(), got._asdict()))
        lit = dedd_lit(kw)
        dark = bool(all(((x if x.dim() == 3 else x.movedim(1, 0))[
            ..., ~lit] == 0).all() for x in got))
        snow = [float(got.Sswabsn[:, k].abs().max()) for k in range(nslyr)]
        print(f"shortwave_dedd {label} {tag} nilyr={nilyr} nslyr={nslyr}: "
              f"max abs diff {err:.3e}; worst field {field}: rel diff "
              f"{rel:.3e} (bound 1e-12 x the field's scale); lit columns "
              f"{int(lit.sum())} of {lit.numel()}; unlit columns exact "
              f"zeros: {dark}; max |Sswabsn| per snow layer {snow}",
              flush=True)
        if not (rel <= 1e-12 and dark and min(snow) > 0.0):
            bad.append(tag)
    c = dedd_full_size_check(kw32)
    print(f"shortwave_dedd {label} f32 nilyr={nilyr} nslyr={nslyr}: vs the "
          f"plain float32 worst field {c['f32'][0]}: rel diff "
          f"{c['f32'][1]:.3e}; the kernel's float32 worst distance from the "
          f"float64 result beyond the plain float32's {c['excess'][1]:.3e} "
          f"of scale ({c['excess'][0]}; bound {DEDD_F32_TOL:.0e}); float64 "
          f"of the same inputs worst {c['f64'][0]} {c['f64'][1]:.3e}; unlit "
          f"exact zeros: {c['dark']}", flush=True)
    if not (c["f64"][1] <= 1e-12 and c["excess"][1] <= DEDD_F32_TOL
            and c["dark"]):
        bad.append("f32")
    if bad:
        fail(f"shortwave_dedd disagrees with shortwave_dEdd_plain at "
             f"nilyr={nilyr}, nslyr={nslyr} ({label}): {bad}")
    kw = kw32
    eager = dedd.shortwave_dEdd_ncat(**kw)
    ms = cuda_time_ms(lambda: dedd.shortwave_dEdd_ncat(**kw), reps=20)
    g_ms, out = graph_ms(lambda: dedd.shortwave_dEdd_ncat(**kw), reps=50)
    if not all(torch.equal(x, y) for x, y in zip(eager, out)):
        fail(f"shortwave_dedd's CUDA graph replay differs from the eager "
             f"call ({label})")
    blocks = {dt: kernels.dedd_blocks_per_sm(nilyr, nslyr, d)
              for dt, d in (("f32", torch.float32), ("f64", torch.float64))}
    bound_ms, bound_by, what = dedd_bound(kw)
    ncat, ny, nx = kw["aicen"].shape
    print(f"shortwave_dedd {label} f32 at {ny}x{nx}, ncat={ncat}, nilyr="
          f"{nilyr}, nslyr={nslyr}: kernel {g_ms:.4f} ms in a CUDA graph "
          f"(eager {ms:.4f} ms), plain {c['plain_ms']:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({what}); resident blocks per SM {blocks} "
          f"(shared memory per block "
          f"{kernels.dedd_smem_bytes(nilyr, nslyr, 4)} / "
          f"{kernels.dedd_smem_bytes(nilyr, nslyr, 8)} B)", flush=True)
    return dict(nilyr=nilyr, nslyr=nslyr, err=c["f32_abs"], ms=g_ms,
                eager_ms=ms, plain_ms=c["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, blocks_per_sm=blocks)


def cesm2_layers_phase():
    """CESM2's column (``cesm2_layers``: ``gx1_parity_config(nilyr=8,
    nslyr=3)``, 384x320, float32, ndte=120, 27 tracers) through
    ``Model.run`` with a history stream of every available field (the
    layered 4Di and 4Ds ones among them), 4 steps after 2: A, B and C once
    per step, the bench.py guards, peak memory, the graph rollout against
    the eager step at 0.0 and the rollout's ms/step; the history file read
    back (8 ice and 3 snow levels, every variable finite); a CICE 5 dump at
    step 2 of 4 restored into a fresh Model, whose run equals the
    continuous one at 0.0 in every State field the dump carries. Then B
    (the 27-tracer table) and C at 8/3 against their plain versions on the
    path's inputs (``dedd_layers_check``), and the small float64 layer sets
    of ``cice5_tpu_torch/small_sets.py`` on the card against the CPU.
    Returns ({path: launches per step}, C's result, B's result)."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from scipy.io import netcdf_file
    from cice5_tpu_torch import small_sets
    from cice5_tpu_torch.io import history as hist
    from cice5_tpu_torch.io import restart_v5
    from cice5_tpu_torch.state import State
    nilyr, nslyr = CESM2_LAYERS
    quiet = lambda *a: None
    fresh_path()
    m, st, _ = build_cesm2_layers()
    if (m.cfg.nilyr, m.cfg.nslyr, m.tr.ntrcr) != (nilyr, nslyr, 27):
        fail(f"cesm2_layers: nilyr={m.cfg.nilyr}, nslyr={m.cfg.nslyr}, "
             f"{m.tr.ntrcr} tracers (expected {nilyr}, {nslyr}, 27)")
    fields = hist.available_fields(m.cfg, m.tr)
    layered = {f.name: f.dims for f in fields if f.dims in ("4Di", "4Ds")}
    if sorted(set(layered.values())) != ["4Di", "4Ds"]:
        fail(f"cesm2_layers: the history catalog's layered fields {layered}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cesm2_") as tmp:
        def report(m, st, diag):
            files = sorted(os.listdir(f"{tmp}/history"))
            if len(files) != 1:
                fail(f"cesm2_layers: history files {files}")
            with netcdf_file(f"{tmp}/history/{files[0]}", "r",
                             mmap=False) as nc:
                levels = (nc.dimensions["nkice"], nc.dimensions["nksnow"])
                for k, v in nc.variables.items():
                    if not np.isfinite(np.asarray(v[:])).all():
                        fail(f"cesm2_layers: history {k} is not finite")
                tsnz = np.asarray(nc.variables["Tsnz"][:])
            if levels != (nilyr, nslyr):
                fail(f"cesm2_layers: history levels {levels}")
            # the rollout over the run's forcing of step 6, graphs captured
            f = m.forcing_at(6)
            roll = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.rollout(st, f, 4)
                torch.cuda.synchronize()
                roll.append((time.perf_counter() - t0) / 4 * 1e3)
            # the CICE 5 dump at step 2 of 4, a fresh Model, 2 more steps
            s0 = 6
            cont = m.run(st, 4, start_step=s0, log=quiet)
            half = m.run(st, 2, start_step=s0, log=quiet)
            core = f"{tmp}/restart/iced.{s0 + 2:05d}"
            paths = restart_v5.write_restart_v5(
                half, core, m.cfg, m.tr, istep=s0 + 2,
                time=(s0 + 2) * m.cfg.time.dt)
            m2, _, _ = build_cesm2_layers()
            st_r, meta = restart_v5.read_restart_v5(core, m2.cfg, m2.tr,
                                                    device=m2.device)
            if meta["istep"] != s0 + 2 or meta.get("missing_files"):
                fail(f"cesm2_layers: v5 dump meta {meta}")
            out = m2.run(st_r, 2, start_step=s0 + 2, log=quiet)
            torch.cuda.synchronize()
            carried = [fl.name for fl in dataclasses.fields(State)
                       if fl.name != "mlt_onset"]
            differ = [n for n in carried
                      if not torch.equal(getattr(out, n), getattr(cont, n))]
            diff = max(float((getattr(out, n).double()
                              - getattr(cont, n).double()).abs().max())
                       for n in carried if getattr(cont, n).numel())
            if differ:
                fail(f"cesm2_layers: the run restored from the CICE 5 dump "
                     f"differs from the continuous run in {differ} (max abs "
                     f"diff {diff:.3e})")
            return dict(nslyr=nslyr, ntrcr=m.tr.ntrcr,
                        ms_per_step_rollout=roll,
                        history_fields=len(fields),
                        layered_history_fields=layered,
                        history_levels=list(levels),
                        Tsnz_range=[float(tsnz.min()), float(tsnz.max())],
                        v5_dump_bytes=sum(os.path.getsize(p) for p in paths),
                        v5_restore_max_abs_diff=diff)

        launches = {"cesm2_layers": option_path(
            "cesm2_layers", m, st, 4,
            dict(evp_sweep=1, remap_flux_both=1, shortwave_dedd=1),
            drive="run", report=report, run_kw=dict(
                history=hist.HistoryStream(fields, freq="1", freq_n=4),
                history_dir=f"{tmp}/history"))["launches_per_step"]}
    del m, st
    fresh_path()
    caps = {dt: capture(build_cesm2_layers, dt)
            for dt in ("float64", "float32")}
    b = remap_phase(caps["float64"][1]["remap"], caps["float32"][1]["remap"],
                    caps["float64"][0], caps["float32"][0], "cesm2_layers")
    c = dedd_layers_check(caps["float64"][1]["dedd"],
                          caps["float32"][1]["dedd"], "cesm2_layers")
    del caps
    fresh_path()
    for label, cfg in small_sets.layer_option_sets().items():
        small_option_check(label, cfg)
    return launches, c, b


def build_gx1_option(**sections):
    """``gx1_parity_config()`` on synth_gx1_grid (384x320, float32,
    ndte=120) with the fields of its sections ``sections`` changed
    (``small_sets.with_``), the default 70N/60S ice edge, forcing of step
    0."""
    from cice5_tpu_torch.config import gx1_parity_config
    from cice5_tpu_torch.driver.model import Model
    from cice5_tpu_torch.grid import synth_gx1_grid
    from cice5_tpu_torch.small_sets import with_
    cfg = with_(gx1_parity_config(), **sections)
    m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
    return m, m.init_state(), m.forcing_at(0)


def evp_options_phase():
    """The revised EVP and dynamics subcycling at full width (384x320,
    float32, ndte=120), each through ``Model.rollout`` with the bench.py
    guards (``option_path``: 5 timed steps after 2, launch counters set
    to 0 just before and read just after, graph rollout against the eager
    step at 0.0): ``gx1_revp``, gx1-parity with ``revised_evp=True``
    (Bouillon et al. 2013, CICE 5.1's ice_dyn_shared.F90:230; A, B and C
    once per step), and ``gx1_ndtd2``, gx1-parity with ``ndtd=2`` (two
    dynamics, transport and ridging passes of dt/2 per step: A and B
    twice, C once), each with its ms per step and peak memory beside
    gx1-parity's, which runs first the same way (``gx1_parity_beside``);
    ``bl99_fused_revp``, the BL99 + CCSM3 model with the fused EVP and
    the revised EVP (D 12 times and B once per step); then the small
    float64 GPU-vs-CPU run of each namelist option set of
    ``cice5_tpu_torch/small_sets.py``, from the frozen open sea where the
    tests start from it and with the fields its option drives compared
    too. Returns {path: launches per step}."""
    from cice5_tpu_torch import small_sets
    from cice5_tpu_torch.driver.step import _min_spacing
    abc = dict(evp_sweep=1, remap_flux_both=1, shortwave_dedd=1)
    ref = None
    launches = {}
    for label, sections, expect in (
            ("gx1_parity_beside", {}, abc),
            ("gx1_revp", dict(dyn=dict(revised_evp=True)), abc),
            ("gx1_ndtd2", dict(time=dict(ndtd=2)),
             dict(evp_sweep=2, remap_flux_both=2, shortwave_dedd=1))):
        fresh_path()
        m, st, _ = build_gx1_option(**sections)

        def beside(m, st, diag):
            out = dict(ndtd=m.cfg.time.ndtd,
                       revised_evp=m.cfg.dyn.revised_evp)
            if ref is not None:
                out.update(gx1_parity_ms_per_step=ref["ms_per_step"],
                           gx1_parity_peak_memory_bytes=ref[
                               "peak_memory_bytes"])
            if m.cfg.dyn.revised_evp:
                out["xmin_m"] = _min_spacing(m.grid, m.topo)
            return out

        line = option_path(label, m, st, 5, expect, report=beside)
        del m, st
        if ref is None:
            ref = line
            continue
        launches[label] = line["launches_per_step"]
        print(f"{label} beside gx1-parity: {line['ms_per_step']:.3f} "
              f"against {ref['ms_per_step']:.3f} ms/step "
              f"({line['ms_per_step'] / ref['ms_per_step']:.3f}x), peak "
              f"device memory {line['peak_memory_bytes'] / 2**30:.3f} "
              f"against {ref['peak_memory_bytes'] / 2**30:.3f} GiB",
              flush=True)
    fresh_path()
    m, st, _ = build_bl99_fused(revised_evp=True)
    launches["bl99_fused_revp"] = option_path(
        "bl99_fused_revp", m, st, 5, dict(evp_fused=12, remap_flux_both=1),
        report=lambda m, st, diag: dict(
            revised_evp=True,
            xmin_m=_min_spacing(m.grid, m.topo)))["launches_per_step"]
    del m, st
    fresh_path()
    for label, cfg in small_sets.flag_option_sets().items():
        drives = small_sets.FLAG_DRIVES.get(label, ())
        small_option_check(
            label, cfg,
            extra=tuple(k[len("out/"):] for k in drives
                        if k.startswith("out/")),
            diag_extra=tuple(k[len("diag/"):] for k in drives
                             if k.startswith("diag/")),
            frozen_sea=label in small_sets.FROZEN_SEA)
    return launches


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the GPU machine only")
    try:
        from cice5_tpu_torch.config import bench_easy_config, gx1_parity_config
        from cice5_tpu_torch.driver.model import Model
        from cice5_tpu_torch.grid import synth_gx1_grid
        from cice5_tpu_torch.ops import kernels
    except ImportError as e:
        fail(f"run from the root of a checkout: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    libs = [*kernels.KERNELS.values(), kernels.dedd_kernel(*CESM2_LAYERS)]
    t_build = kernels.build_all(libs)
    print(f"kernel build: {t_build:.2f} s for "
          f"{len({k.library for k in libs})} libraries from "
          f"{len({k.source for k in libs})} sources", flush=True)
    ptxas_phase()

    # slice 1: the BL99 model's kernel inputs (open boundaries, 18 tracers)
    def bl99_model(dt):
        m = Model(bench_easy_config(dtype=dt))
        return m, m.init_state(ice_mask=m.grid.tmask), m.forcing_at(0)

    caps = {dt: capture(bl99_model, dt) for dt in ("float64", "float32")}
    evp_phase(caps["float64"][1]["evp"], caps["float32"][1]["evp"], "BL99")
    evp_costs(caps["float32"][1]["evp"], "BL99")
    remap_phase(caps["float64"][1]["remap"], caps["float32"][1]["remap"],
                caps["float64"][0], caps["float32"][0], "BL99")
    # slice 3: kernel D on the same open-boundary inputs, E beside B
    d = evp_fused_phase(caps["float64"][1]["evp"], caps["float32"][1]["evp"])
    d_rev = evp_fused_phase(*(revised_cap(caps[dt])
                              for dt in ("float64", "float32")),
                            label="BL99 revised EVP")
    formdrag_evp_phase(caps["float64"][1]["evp"], caps["float32"][1]["evp"],
                       caps["float64"][2], caps["float32"][2], "BL99",
                       fused=True)
    remap_edge_phase(caps["float64"][1]["remap"],
                     caps["float32"][1]["remap"], "BL99")
    # slice 2: the gx1-parity model's (tripole seam, 19 tracers, dEdd)
    def parity_model(dt):
        cfg = gx1_parity_config(dtype=dt, accum_dtype=dt)
        m = Model(cfg, grid=synth_gx1_grid(cfg, device="cuda"))
        return m, m.init_state(), m.forcing_at(0)

    caps = {dt: capture(parity_model, dt) for dt in ("float64", "float32")}
    a = evp_phase(caps["float64"][1]["evp"], caps["float32"][1]["evp"],
                  "gx1 tripole")
    a["eager_ms"], a["ms"] = a["ms"], evp_costs(caps["float32"][1]["evp"],
                                                "gx1 tripole")
    a_rev = revised_evp_phase(caps["float64"], caps["float32"],
                              "gx1 tripole")
    formdrag_evp_phase(caps["float64"][1]["evp"], caps["float32"][1]["evp"],
                       caps["float64"][2], caps["float32"][2], "gx1 tripole",
                       fused=False)
    b = remap_phase(caps["float64"][1]["remap"], caps["float32"][1]["remap"],
                    caps["float64"][0], caps["float32"][0], "gx1")
    c = dedd_phase(caps["float64"][1]["dedd"], caps["float32"][1]["dedd"])
    e = remap_edge_phase(caps["float64"][1]["remap"],
                         caps["float32"][1]["remap"], "gx1")
    del caps
    small_reference_check()
    small_reference_check("pallas", ndte=10)
    parity_reference_check()
    small_coupled_check()
    torch.cuda.reset_peak_memory_stats()
    launches = main_path("gx1-parity", build_parity, 10,
                         dict(evp_sweep=10, remap_flux_both=10,
                              shortwave_dedd=10, evp_fused=0,
                              remap_flux_edge=0))
    gx1_peak = torch.cuda.max_memory_allocated()
    bl99 = main_path("BL99+CCSM3", build_bl99, 5,
                     dict(evp_sweep=5, remap_flux_both=5, shortwave_dedd=0,
                          evp_fused=0, remap_flux_edge=0))
    fused = main_path("BL99+CCSM3 fused EVP", build_bl99_fused, 5,
                      dict(evp_sweep=0, remap_flux_both=5, shortwave_dedd=0,
                           evp_fused=60, remap_flux_edge=0))
    run_phase()
    auscom_025_phase(gx1_peak)
    options_phase()
    by_path, a_tfold, a_tfold_rev = dynamics_phase()
    bgc_launches, b_bgc = tracer_phase()
    by_path.update(bgc_launches)
    by_path.update(file_forcing_phase())
    cesm2_launches, c_layers, b_layers = cesm2_layers_phase()
    by_path.update(cesm2_launches)
    by_path.update(evp_options_phase())
    sharded_launches, tile = sharded_phase()
    by_path.update(sharded_launches)
    by_path.update({"gx1-parity": {k: v // 10 for k, v in launches.items()},
                    "BL99+CCSM3": {k: v // 5 for k, v in bl99.items()},
                    "BL99+CCSM3 fused EVP": {k: v // 5
                                             for k, v in fused.items()}})
    per_path = lambda name: {p: v.get(name, 0) for p, v in by_path.items()}

    line = {"kernels": [
        dict(name="evp_sweep", route="cuda",
             source="cice5_tpu_torch/csrc/evp_resident.cu",
             replaces="cice5_tpu/ops/pallas/evp_resident.py:35",
             launches=launches["evp_sweep"], max_abs_err=a["err"],
             ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
             bound_by=a["bound_by"], library_ms=None,
             launches_per_step_by_path=per_path("evp_sweep"),
             tfold=dict(launches=by_path["gx1_tfold"]["evp_sweep"] * 5,
                        max_abs_err=a_tfold["err"], ms=a_tfold["ms"],
                        plain_ms=a_tfold["plain_ms"],
                        bound_ms=a_tfold["bound_ms"]),
             # the revised EVP's parameters on the gx1 tripole inputs (its
             # launches from the gx1_revp path) and on the T-fold ones
             revised=dict(
                 launches=by_path["gx1_revp"]["evp_sweep"] * 5,
                 max_abs_err=a_rev["err"], ms=a_rev["ms"],
                 eager_ms=a_rev["eager_ms"], plain_ms=a_rev["plain_ms"],
                 bound_ms=a_rev["bound_ms"], bound_by=a_rev["bound_by"],
                 brlx=a_rev["brlx"],
                 tfold=dict(max_abs_err=a_tfold_rev["err"],
                            ms=a_tfold_rev["ms"],
                            plain_ms=a_tfold_rev["plain_ms"],
                            bound_ms=a_tfold_rev["bound_ms"],
                            brlx=a_tfold_rev["brlx"])),
             ndtd2=dict(launches=by_path["gx1_ndtd2"]["evp_sweep"] * 5)),
        dict(name="remap_flux_both", route="cuda",
             source="cice5_tpu_torch/csrc/remap_tiles.cu",
             replaces="cice5_tpu/ops/pallas/remap_flux.py:163",
             launches=launches["remap_flux_both"], max_abs_err=b["err"],
             ms=b["ms"], plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
             bound_by=b["bound_by"], library_ms=None,
             launches_per_step_by_path=per_path("remap_flux_both"),
             sharded_tile=tile["remap_flux_both"],
             gx1_bgc=dict(launches=by_path["gx1_bgc"]["remap_flux_both"]
                          * 4, max_abs_err=b_bgc["err"], ms=b_bgc["ms"],
                          plain_ms=b_bgc["plain_ms"],
                          bound_ms=b_bgc["bound_ms"],
                          bound_by=b_bgc["bound_by"]),
             cesm2_layers=dict(
                 launches=by_path["cesm2_layers"]["remap_flux_both"] * 4,
                 max_abs_err=b_layers["err"], ms=b_layers["ms"],
                 plain_ms=b_layers["plain_ms"],
                 bound_ms=b_layers["bound_ms"],
                 bound_by=b_layers["bound_by"])),
        dict(name="shortwave_dedd", route="cuda",
             source="cice5_tpu_torch/csrc/shortwave_dedd.cu",
             replaces="cice5_tpu/ops/pallas/dedd_fused.py:51",
             launches=launches["shortwave_dedd"], max_abs_err=c["err"],
             ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
             bound_by=c["bound_by"], library_ms=None,
             launches_per_step_by_path=per_path("shortwave_dedd"),
             sharded_tile=tile["shortwave_dedd"],
             cesm2_layers=dict(
                 {k: v for k, v in c_layers.items() if k != "err"},
                 launches=by_path["cesm2_layers"]["shortwave_dedd"] * 4,
                 max_abs_err=c_layers["err"])),
        dict(name="evp_fused", route="cuda",
             source="cice5_tpu_torch/csrc/evp_resident.cu",
             replaces="cice5_tpu/ops/pallas/evp_fused.py:49",
             launches=fused["evp_fused"], max_abs_err=d["err"],
             ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
             bound_by=d["bound_by"], library_ms=None,
             launches_per_step_by_path=per_path("evp_fused"),
             # the revised EVP's parameters on the BL99 inputs (its
             # launches from the bl99_fused_revp path)
             revised=dict(launches=by_path["bl99_fused_revp"]["evp_fused"]
                          * 5, max_abs_err=d_rev["err"],
                          ms=d_rev["ms"], eager_ms=d_rev["eager_ms"],
                          plain_ms=d_rev["plain_ms"],
                          bound_ms=d_rev["bound_ms"],
                          bound_by=d_rev["bound_by"])),
        # no main path calls the single-edge kernel (0 launches on each);
        # its time beside B's on the same inputs
        dict(name="remap_flux_edge", route="cuda",
             source="cice5_tpu_torch/csrc/remap_tiles.cu",
             replaces="cice5_tpu/ops/pallas/remap_flux.py:75",
             launches=launches["remap_flux_edge"], max_abs_err=e["err"],
             ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
             bound_by=e["bound_by"], library_ms=None, eager_ms=e["eager_ms"],
             east_ms=e["east_ms"], remap_flux_both_same_inputs_ms=e["b_ms"],
             launches_per_step_by_path=per_path("remap_flux_edge")),
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--nccl-rank"]:
        nccl_rank(sys.argv[2])
    else:
        main()
