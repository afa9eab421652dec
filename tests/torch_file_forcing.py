"""Synthetic forcing files of tests/test_torch_forcing_data.py and the
recorded JAX run they drive.

``write_ncar_tree`` writes an NCAR-layout tree (``ncar_files``) of
big-endian float64 direct-access records made from a seed: the monthly
files (fsw, cldf, fsnow) whole, the six-hourly ones (Tair, uatm, vatm,
Qa, rhoa) at their full length of 1460 records, with only the records
asked for written (the others are holes that read as zeros). The air is
above freezing, so all the precipitation falls as rain (a level pond's
"no fresh water" branch then never rests on rounding noise).

The reference: the JAX package's run_loop on the gx1-parity model of
test_torch_parity_step.py (24x16, ndte=8, float64) from its recorded
warmed-up state, driven by the JAX FileForcing over such a tree:
FILE_NSTEPS steps from FILE_START, the first ones reading the previous
cycle year's last record (the year seam) and the last one the next
record pair. Recorded in FILE_REFERENCE under a SHA-256 of its inputs;
``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_file_forcing.py``
rewrites it (~1 min here). Importing this module imports no JAX.
"""
import os
from pathlib import Path

import numpy as np

import torch_port_util as U

FILE_REFERENCE = Path(__file__).with_name("test_torch_file_forcing.npz")
YEARS = (1996, 1997)
SIX_RECORDS = (0, 1, 2, 1459)
# model year 1997 reads cycle year 1996 and its previous year the other
# file year (fyear = 1996 + (year - 1997) % 2)
TREE = dict(atm_data_type="ncar", fyear_init=1996, ycycle=2,
            year_init=1997)
FILE_START, FILE_NSTEPS = 4, 3
SEED = 31
MONTHLY = {"fsw": (120.0, 260.0), "cldf": (0.3, 0.9),
           "fsnow": (20.0, 60.0)}
SIXHOURLY = {"Tair": (274.0, 277.0), "uatm": (-6.0, 6.0),
             "vatm": (-6.0, 6.0), "Qa": (3.0e-3, 4.5e-3),
             "rhoa": (1.25, 1.35)}
NREC_SIX = 1460


def write_records(path, nrec: int, records: dict):
    """A direct-access file of ``nrec`` big-endian float64 records of the
    arrays' shape with ``records`` {index: array} written; the rest are
    holes. Returns the bytes written."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    a0 = next(iter(records.values()))
    size = a0.size * 8
    with open(path, "wb") as f:
        f.truncate(nrec * size)
        for r, a in sorted(records.items()):
            f.seek(r * size)
            f.write(np.ascontiguousarray(a, ">f8").tobytes())
    return size * len(records)


def write_ncar_tree(root, ny: int, nx: int, years=YEARS,
                    six_records=SIX_RECORDS, seed=SEED) -> int:
    """The NCAR tree of every year under ``root``; returns the bytes
    written."""
    from cice5_tpu_torch.forcing_data import ncar_files
    rng = np.random.default_rng(seed)
    total = 0
    for yr in years:
        files = ncar_files(str(root), yr)
        for name, (lo, hi) in MONTHLY.items():
            total += write_records(files[name], 12, {
                r: rng.uniform(lo, hi, (ny, nx)) for r in range(12)})
        for name, (lo, hi) in SIXHOURLY.items():
            total += write_records(files[name], NREC_SIX, {
                r: rng.uniform(lo, hi, (ny, nx)) for r in six_records})
    return total


def make_file_reference() -> dict:
    """Run the JAX run_loop driven by the JAX FileForcing from the
    recorded warmed-up parity state. Returns {"out/<field>": the final
    state, "forcing<k>/<field>": the forcing of each step}."""
    import dataclasses
    import tempfile
    from functools import partial
    import jax.numpy as jnp
    from cice5_tpu.driver.model import Model as JModel, run_loop
    from cice5_tpu.driver.step import step as jstep_fn
    from cice5_tpu.forcing_data import FileForcing as JFileForcing
    from cice5_tpu.grid import popgrid_np
    from cice5_tpu.state import State as JState
    from cice5_tpu_torch.convert import config_from_dict

    cfg = U.jax_config(config_from_dict(U.parity_config_dict()))
    jm = JModel(cfg, grid=popgrid_np(cfg, *U.parity_grid_arrays()))
    jm._jstep = U.jit_fast(partial(jstep_fn, cfg=jm.cfg, tr=jm.tr,
                                   topo=jm.topo, hin_max=jm.hin_max,
                                   salinz=jm.salinz))
    ref = U.load_parity_reference()
    st = JState(**{f.name: jnp.asarray(ref[f"in/{f.name}"])
                   for f in dataclasses.fields(JState)})
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_ncar_tree(tmp, U.PARITY_NY, U.PARITY_NX)
        ds = JFileForcing(tmp, nx=U.PARITY_NX, ny=U.PARITY_NY, **TREE)

        def provider(istep, info):
            f = ds.forcing_at(float(int(info.yday)), float(info.sec),
                              info.year, jm.grid, dtype=jnp.float64)
            for fl in dataclasses.fields(f):
                v = getattr(f, fl.name)
                if v is not None:
                    out[f"forcing{istep}/{fl.name}"] = np.asarray(v)
            return f
        jm.forcing_provider = provider
        final = run_loop(jm, st, FILE_NSTEPS, start_step=FILE_START,
                         log=lambda *a: None)
    for f in dataclasses.fields(final):
        out[f"out/{f.name}"] = np.asarray(getattr(final, f.name))
    return out


def file_reference_key() -> str:
    """SHA-256 of what the reference depends on: the parity reference's
    inputs (its starting state), the file writer and the recipe."""
    import hashlib
    import inspect
    h = hashlib.sha256(U.parity_reference_key().encode())
    for fn in (write_records, write_ncar_tree, make_file_reference,
               U.jax_config):
        h.update(inspect.getsource(fn).encode())
    h.update(repr((YEARS, SIX_RECORDS, TREE, FILE_START, FILE_NSTEPS, SEED,
                   MONTHLY, SIXHOURLY, NREC_SIX)).encode())
    return h.hexdigest()


def load_file_reference() -> dict:
    with np.load(FILE_REFERENCE) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(FILE_REFERENCE, key=np.array(file_reference_key()),
                        **make_file_reference())
    print(f"wrote {FILE_REFERENCE}")
