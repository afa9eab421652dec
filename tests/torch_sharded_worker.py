"""One rank of the port's mesh tests: run with the rank, the world size, a
scratch directory and a JSON spec,

    python tests/torch_sharded_worker.py RANK WORLD DIR SPEC

on gloo over the ``file://`` store ``DIR/store``, with one thread. The spec
names the mesh shape and the tasks; each task writes what it computed to
``DIR/<task>.r<RANK>.npz`` (``save``) for the test to compare. Imports the
port only (the AST check of tests/test_torch_port.py holds it to that).
``tests/test_torch_sharded.py`` and ``tests/test_torch_evp_chunked.py``
launch it (``launch``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cice5_tpu_torch import convert  # noqa: E402
from cice5_tpu_torch.constants import FieldLoc, FieldType  # noqa: E402
from cice5_tpu_torch.io import xyt  # noqa: E402
from cice5_tpu_torch.parallel import distributed as pdist  # noqa: E402
from cice5_tpu_torch.parallel import halo  # noqa: E402
from cice5_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                           mesh_topology)

# the halo cases: a (2, ny, nx) float64 field from a seed on each topology
HALO_NY, HALO_NX = 12, 16
HALO_TOPOLOGIES = (("cyclic", "open"), ("open", "open"), ("open", "cyclic"),
                   ("cyclic", "tripole"), ("cyclic", "tripoleT"))
LOCS = (FieldLoc.CENTER, FieldLoc.NECORNER, FieldLoc.EFACE, FieldLoc.NFACE)
KINDS = (FieldType.SCALAR, FieldType.VECTOR)


def halo_field(seed=7):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((2, HALO_NY, HALO_NX))),
            torch.from_numpy(rng.standard_normal((2, HALO_NY, HALO_NX))))


def halo_cases(field, partner):
    """{name: fn(topology) -> the extended array} of every halo case."""
    cases = {}
    for ew, ns in HALO_TOPOLOGIES:
        for loc in LOCS:
            for kind in KINDS:
                key = f"{ew}-{ns}-{loc.name}-{kind.name}"
                cases[f"extend/{key}"] = (ew, ns, lambda t, x, p, loc=loc,
                                          kind=kind: halo.extend(
                                              x, t, loc=loc, kind=kind))
                cases[f"wide2/{key}"] = (ew, ns, lambda t, x, p, loc=loc,
                                         kind=kind: halo.extend_wide(
                                             x, t, 2, loc=loc, kind=kind))
            if ns in ("tripole", "tripoleT"):
                cases[f"partner/{ew}-{ns}-{loc.name}"] = (
                    ew, ns, lambda t, x, p, loc=loc: halo.extend(
                        x, t, loc=loc, fold_partner=-p, fold_sign=-1.0))
        cases[f"extrapolate/{ew}-{ns}"] = (
            ew, ns, lambda t, x, p: halo.extend(x, t,
                                                open_fill="extrapolate"))
        if ns != "tripoleT":
            cases[f"groups/{ew}-{ns}"] = (
                ew, ns, lambda t, x, p: halo.extend_wide_groups(
                    torch.cat([x, p]), t, 2, [
                        (slice(0, 2), FieldLoc.NECORNER, FieldType.VECTOR,
                         None, 1.0),
                        (slice(2, 4), FieldLoc.CENTER, FieldType.SCALAR,
                         -x, -1.0)]))
    return cases


def task_halo(spec, out):
    x, p = halo_field()
    for name, (ew, ns, fn) in halo_cases(x, p).items():
        mesh = make_mesh(HALO_NY, HALO_NX, shape=tuple(spec["mesh"]))
        topo = mesh_topology(mesh, ew, ns)
        out[name] = fn(topo, pdist.put(x, mesh), pdist.put(p, mesh)).numpy()
    mesh = make_mesh(HALO_NY, HALO_NX, shape=tuple(spec["mesh"]))
    topo = mesh_topology(mesh, "cyclic", "open")
    tile = pdist.put(x, mesh)
    out["global_sum"] = np.array([float(halo.global_sum(tile, topo))
                                  for _ in range(2)])
    out["global_sum_int"] = np.array(int(halo.global_sum(
        (tile > 0).to(torch.int32), topo)))
    out["global_min"] = np.array(float(halo.global_min(tile, topo)))
    out["gathered"] = pdist.gather(tile, mesh).numpy()
    out["xyt_roundtrip"] = xyt.gather_xyt(xyt.scatter_xyt(x.numpy(), mesh),
                                          mesh)


def case_config(name):
    """The port's configuration of a ShardedModel case, float64: "rect"
    (tests/test_sharded_model.py's 16x32 basin, ndte=15), "tripole"
    (gx1-parity on a 24x16 tripole grid, ndte=8), and the run cases
    "small" (the basin at 8x16) and "small_restore" (that with an open
    east-west boundary and ice restoring), and "rect_revised" (the basin
    with the revised EVP)."""
    from cice5_tpu_torch import config as C
    r = dataclasses.replace
    if name == "tripole":
        cfg = C.gx1_parity_config()
        return cfg.replace(grid=r(cfg.grid, ny=24, nx=16),
                           dyn=r(cfg.dyn, ndte=8), dtype="float64",
                           accum_dtype="float64")
    small = name.startswith("small")
    cfg = C.rect_config(ny=8 if small else 16, nx=16 if small else 32,
                        dtype="float64", accum_dtype="float64")
    cfg = cfg.replace(dyn=r(cfg.dyn, ndte=15,
                            revised_evp=name == "rect_revised"))
    if name == "small_restore":
        cfg = cfg.replace(grid=r(cfg.grid, ew_boundary="open"),
                          forcing=r(cfg.forcing, restore_ice=True,
                                    trestore=0.5))
    return cfg


def recorded(z, prefix) -> dict:
    """The arrays of a recorded reference (an npz or a dict) under
    ``prefix/``."""
    n = len(prefix) + 1
    return {k[n:]: z[k] for k in z if k.startswith(prefix + "/")}


def task_model(spec, out):
    """Each recorded case: two steps of ShardedModel from the recorded
    state and forcings, gathered; the traffic of the last step."""
    from cice5_tpu_torch.driver.sharded import ShardedModel
    z = np.load(spec["reference"])
    for name in spec["cases"]:
        grid = convert.grid_from_arrays(recorded(z, f"{name}/grid"),
                                        device="cpu")
        sm = ShardedModel(case_config(name), mesh_shape=tuple(spec["mesh"]),
                          grid=grid, device="cpu")
        st = sm.put(convert.state_from_arrays(recorded(z, f"{name}/st0"),
                                              device="cpu"))
        for k in range(2):
            f = sm.put(convert.forcing_from_arrays(
                recorded(z, f"{name}/f{k}"), device="cpu"))
            pdist.reset_traffic()
            st, diag = sm.step(st, f)
        traffic = pdist.traffic()
        gst, gd = sm.gather((st, diag))
        for k, v in convert.to_numpy(gst).items():
            out[f"{name}/state/{k}"] = v
        for k, v in gd._asdict().items():
            out[f"{name}/diag/{k}"] = np.asarray(v)
        for k, v in traffic.items():
            out[f"{name}/traffic/{k}"] = np.array(v)


def task_revised(spec, out):
    """The "rect" case's recorded state and forcings under the revised EVP
    ("rect_revised"): two steps of ShardedModel, gathered, and the
    revised EVP's xmin (the ocean minimum of dxt and dyt) as this rank
    computes it for its tile."""
    from cice5_tpu_torch.driver.sharded import ShardedModel
    from cice5_tpu_torch.driver.step import _min_spacing
    z = np.load(spec["reference"])
    grid = convert.grid_from_arrays(recorded(z, "rect/grid"), device="cpu")
    sm = ShardedModel(case_config("rect_revised"),
                      mesh_shape=tuple(spec["mesh"]), grid=grid, device="cpu")
    st = sm.put(convert.state_from_arrays(recorded(z, "rect/st0"),
                                          device="cpu"))
    for k in range(2):
        st, diag = sm.step(st, sm.put(convert.forcing_from_arrays(
            recorded(z, f"rect/f{k}"), device="cpu")))
    gst, gd = sm.gather((st, diag))
    for k, v in convert.to_numpy(gst).items():
        out[f"state/{k}"] = v
    for k, v in gd._asdict().items():
        out[f"diag/{k}"] = np.asarray(v)
    out["xmin"] = np.array(_min_spacing(sm.tile_grid, sm.topo))


def task_run(spec, out):
    """run_loop over the mesh with history, restarts, diagnostics and
    state checks (files under DIR/<case>, written by rank 0); then the
    per-rank restart files and 2 more steps of history accumulated on the
    tiles and written per rank (io/shard_io.py)."""
    from cice5_tpu_torch.driver.sharded import ShardedModel
    from cice5_tpu_torch.io import history as hmod
    from cice5_tpu_torch.io import shard_io
    d = Path(spec["dir"])
    for name in spec["run_cases"]:
        sm = ShardedModel(case_config(name), mesh_shape=tuple(spec["mesh"]),
                          device="cpu")
        st = sm.init_state(ice_mask=sm.grid.tmask)
        fields = hmod.available_fields(sm.cfg, sm.tr)
        hs = hmod.HistoryStreams([hmod.HistoryStream(
            fields, freq="1", freq_n=2, suffix="inst")])
        logs = []
        st = sm.run(st, nsteps=2, diag_every=1, history=hs,
                    history_dir=str(d / name / "hist"), restart_every=2,
                    restart_dir=str(d / name / "rest"), check_every=1,
                    log=logs.append)
        out[f"{name}/log"] = np.array(json.dumps(logs))
        for k, v in convert.to_numpy(sm.gather(st)).items():
            out[f"{name}/state/{k}"] = v
        shard_io.dump_sharded(st, str(d / name / "shards"), istep=2,
                              time=7200.0, mesh=sm.mesh)
        stream = hmod.HistoryStream(fields, freq="1", freq_n=2)
        for k in range(2, 4):
            f = sm.forcing_at(k)
            st, diag = sm.step(st, f)
            stream.accum(hmod.diag_to_values(
                diag, st, sm.tile_grid, sm.tr, f, sm.cfg.nilyr,
                sm.cfg.nslyr), (k + 1) * 3600.0)
        shard_io.dump_history_sharded(stream, sm.calendar.info(4, 3600.0),
                                      str(d / name / "hist_tiles"),
                                      mesh=sm.mesh)


def task_evp(spec, out):
    """The per-subcycle EVP and evp_chunked on the mesh, gathered."""
    from cice5_tpu_torch.models.dynamics import shared as dyn
    from cice5_tpu_torch.models.dynamics.evp import evp, evp_chunked
    z = np.load(spec["evp"]["arrays"])
    grid = convert.grid_from_arrays(recorded(z, "grid"), device="cpu")
    fields = {k: torch.from_numpy(v) for k, v in recorded(z, "f").items()}
    ny, nx = grid.hm.shape
    for ns in spec["evp"]["ns"]:
        mesh = make_mesh(ny, nx, shape=tuple(spec["mesh"]))
        topo = mesh_topology(mesh, "cyclic", ns)
        p = dyn.EVPParams.classic(3600.0, ndte=spec["evp"]["ndte"])
        tg, tf = pdist.put(grid, mesh), pdist.put(fields, mesh)
        runs = {"evp": lambda: evp(3600.0, p, tg, topo, **tf)}
        for K in spec["evp"]["K"]:
            runs[f"chunked{K}"] = lambda K=K: evp_chunked(
                3600.0, p, tg, topo, K=K, **tf)
        for label, fn in runs.items():
            pdist.reset_traffic()
            r = fn()
            out[f"{ns}/{label}/exchanges"] = np.array(
                pdist.traffic()["exchanges"])
            for k in spec["evp"]["fields"]:
                out[f"{ns}/{label}/{k}"] = pdist.to_host(getattr(r, k),
                                                         mesh)


TASKS = {"halo": task_halo, "model": task_model, "run": task_run,
         "evp": task_evp, "revised": task_revised}


def main(argv):
    rank, world, tmp, spec_path = int(argv[0]), int(argv[1]), argv[2], \
        argv[3]
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    pdist.initialize_distributed("gloo", init_method=f"file://{tmp}/store",
                                 rank=rank, world_size=world)
    for task in spec["tasks"]:
        out = {}
        TASKS[task](spec, out)
        np.savez(os.path.join(tmp, f"{task}.r{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def launch(tmp: Path, spec: dict, world: int = 4, timeout: float = 120.0):
    """Run ``world`` ranks of this module on ``spec`` in ``tmp``; each
    rank's output goes to ``tmp/rank<r>.log``. Returns {task: [per-rank
    dict of arrays]}; raises with every rank's log when one fails."""
    tmp.mkdir(parents=True, exist_ok=True)
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(dict(spec, dir=str(tmp))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(tmp),
             str(spec_path)], stdout=log, stderr=subprocess.STDOUT,
            env=env))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        text = "\n".join(f"--- rank {r} (exit {p.returncode}):\n"
                         + (tmp / f"rank{r}.log").read_text()[-4000:]
                         for r, p in enumerate(procs))
        raise AssertionError(f"a rank failed:\n{text}")
    out = {}
    for task in spec["tasks"]:
        out[task] = []
        for r in range(world):
            with np.load(tmp / f"{task}.r{r}.npz") as z:
                out[task].append({k: z[k] for k in z.files})
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
