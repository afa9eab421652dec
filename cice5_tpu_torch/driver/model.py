"""Model container: initialization + run loop (PyTorch port of
``cice5_tpu/driver/model.py``).

CICE_InitMod.F90:52 cice_init, CICE_RunMod.F90:37 CICE_Run and the default
initial conditions of ice_init.F90:1475 set_state_var (ice at cold high
latitudes with a parabolic ITD centred on hbar=3 m). ``Model`` runs on the
GPU, where its steps replay CUDA graphs; the plain PyTorch path on the
CPU is taken only when the caller asks for it with ``device="cpu"``.
``run_loop`` (``Model.run``) steps the model and, between the steps, reads
the device for the state checks, the runtime diagnostics and the history
and restart files (``io/``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.calendar import Calendar
from cice5_tpu_torch.config import ModelConfig
from cice5_tpu_torch.driver import graph
from cice5_tpu_torch.driver.step import prefill_radiation, step as step_fn
from cice5_tpu_torch.forcing import Forcing, idealized_polar_forcing
from cice5_tpu_torch.grid import Grid, make_grid
from cice5_tpu_torch.io import diagnostics as diag_mod
from cice5_tpu_torch.io import history as hist_mod
from cice5_tpu_torch.io import restart as restart_mod
from cice5_tpu_torch.models.radiation.orbital import shr_orb_params
from cice5_tpu_torch.models.restoring import edge_mask, restore_ice
from cice5_tpu_torch.models.tracers.aerosol import KSCAV
from cice5_tpu_torch.models.thermo import itd, shared as thshared
from cice5_tpu_torch.parallel import Topology
from cice5_tpu_torch.state import State, build_tracer_registry, zeros_state

EDGE_INIT_NH = 70.0
EDGE_INIT_SH = -60.0
HSNO_INIT = 0.20

_LATER = "a later slice of the port"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for every option outside the port so far,
    naming the slice that brings it. The port runs the rectangular,
    column, POP displaced-pole and tripole grids, on a U-fold (tripole)
    or T-fold (tripoleT) seam, lat-lon and CPOM grids; zero-layer, BL99
    or mushy thermodynamics, with the surface temperature solved or the
    coupler's fluxes prescribed (calc_Tsfc=False); CCSM3 or
    delta-Eddington shortwave; the iage, FY, level-ice and aerosol
    tracers, the CESM, level-ice or topographic ponds (frzpnd 'hlid' or
    'cesm'), the dynamic brine height and the skeletal-layer BGC (either
    bgc_flux_type, any subset of its tracers); EVP (kdyn=1) or EAP
    (kdyn=2) dynamics, on either seam, with remap, upwind or no transport
    and ridging, the fused EVP sweep off a tripole seam, the transport
    conservation and monotonicity checks and the per-category mechred
    diagnostics, the chunked EVP (K subcycles per halo exchange, on one
    device or a mesh of ranks); and the coupled-mode options formdrag,
    highfreq, coupled_radiation and fbot_xfer_type="Cdn_ocn". Each option
    is held against the JAX step on its own (tests/test_torch_options.py,
    tests/test_torch_sharded.py). It refuses compact_columns (not ported)
    and a tripole east-west boundary. Nothing is silently
    approximated."""
    g, th, dy, tc = cfg.grid, cfg.thermo, cfg.dyn, cfg.tracers
    later = "is not ported yet: it comes with"
    checks = [
        (g.grid_type not in ("rectangular", "column", "displaced_pole",
                             "tripole", "latlon", "cpom"),
         f"grid_type={g.grid_type!r} {later} {_LATER}"),
        (g.ew_boundary in ("tripole", "tripoleT"),
         f"ew_boundary={g.ew_boundary!r}: a tripole fold is a north seam, "
         "and no slice of the port brings it as an east-west boundary"),
        (g.compact_columns == "on",
         "compact_columns='on' is not ported: the JAX package measured "
         "column packing a loss (cice5_tpu/driver/model.py:130-141), so no "
         "slice of the port brings it"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(what)
    fused = dy.evp_algorithm == "pallas" and g.ns_boundary not in (
        "tripole", "tripoleT")
    if fused and g.ns_boundary == "cyclic":
        raise NotImplementedError(
            "evp_algorithm='pallas' with a cyclic north-south boundary: the "
            "JAX package's fused EVP kernel pads its windows with zero rows "
            "as if the boundary were open (cice5_tpu/ops/pallas/"
            "evp_fused.py:165-173), so it computes open-boundary dynamics "
            "there and is no reference to hold the port against")
    if fused and dy.ndte % 10 != 0:
        raise NotImplementedError(
            f"evp_algorithm='pallas' with ndte={dy.ndte}: the fused EVP "
            f"sweep runs chunks of 10 subcycles, so ndte must be a multiple "
            f"of 10 (cice5_tpu/ops/pallas/evp_fused.py:162)")
    if th.fbot_xfer_type not in ("constant", "Cdn_ocn"):
        raise ValueError(
            f"fbot_xfer_type={th.fbot_xfer_type!r}: the bottom heat "
            "transfer is 'constant' or 'Cdn_ocn' "
            "(ice_therm_vertical.F90:741-746)")
    if th.ktherm not in (0, 1, 2):
        raise ValueError(f"ktherm={th.ktherm}: 0 (zero-layer), 1 (BL99) or "
                         "2 (mushy)")
    if tc.tr_pond_lvl and tc.frzpnd not in ("hlid", "cesm"):
        raise ValueError(f"frzpnd={tc.frzpnd!r}: the level-pond refreezing "
                         "is 'hlid' or 'cesm' (ice_meltpond_lvl.F90)")
    if dy.kdyn not in (0, 1, 2):
        raise ValueError(f"kdyn={dy.kdyn}: 0 (no dynamics), 1 (EVP) or 2 "
                         "(EAP)")
    if dy.advection not in ("remap", "upwind", "none"):
        raise ValueError(f"advection={dy.advection!r}: 'remap', 'upwind' "
                         "or 'none'")
    if tc.skl_bgc and tc.bgc_flux_type not in ("Jin2006", "constant"):
        raise ValueError(f"bgc_flux_type={tc.bgc_flux_type!r}: 'Jin2006' "
                         "or 'constant' (ice_algae.F90:356-408)")
    if tc.tr_aero and tc.n_aero > len(KSCAV):
        raise ValueError(f"n_aero={tc.n_aero}: at most {len(KSCAV)} "
                         "species (ice_domain_size.F90 max_aero)")
    if dy.yield_curve != "ellipse":
        raise NotImplementedError(
            f"yield_curve={dy.yield_curve!r}: only 'ellipse' exists "
            "(ice_dyn_shared.F90:41)")


def initial_itd(cfg: ModelConfig, hin_max):
    """Parabolic initial category areas/thicknesses
    (ice_init.F90:1617-1635)."""
    hbar = 3.0
    hinit = np.zeros(cfg.ncat)
    ainit = np.zeros(cfg.ncat)
    for n in range(cfg.ncat):
        if n < cfg.ncat - 1:
            hinit[n] = 0.5 * (hin_max[n] + hin_max[n + 1])
        else:
            hinit[n] = hin_max[n] + 1.0
        ainit[n] = max(0.0, 2.0 * hbar * hinit[n] - hinit[n] ** 2)
    ainit /= ainit.sum() + ct.puny / cfg.ncat
    return ainit, hinit


def init_state(cfg: ModelConfig, grid: Grid, tr, hin_max, salinz,
               Tair=None, sst=None, ice_mask=None) -> State:
    """Default initial state (ice_init.F90:1475-1813 set_state_var).
    ice_mask: boolean (ny, nx) array or tensor; default ice poleward of
    70N / 60S on ocean cells."""
    device = grid.hm.device
    kw = dict(dtype=cfg.xp_dtype, device=device)
    st = zeros_state(cfg, tr, device=device)
    sss = 34.0
    Tf = -ct.depressT * sss

    tmask = grid.tmask
    if ice_mask is None:
        ulat_deg = torch.rad2deg(grid.ULAT)
        ice_mask = tmask & ((ulat_deg > EDGE_INIT_NH)
                            | (ulat_deg < EDGE_INIT_SH))
    msk = torch.as_tensor(np.asarray(ice_mask) if not torch.is_tensor(
        ice_mask) else ice_mask, device=device).to(torch.bool)

    ainit, hinit = initial_itd(cfg, hin_max)
    a0 = torch.as_tensor(ainit, **kw)[:, None, None]
    v0 = torch.as_tensor(ainit * hinit, **kw)[:, None, None]
    aicen = torch.where(msk[None], a0, 0.0)
    vicen = torch.where(msk[None], v0, 0.0)
    vsnon = torch.minimum(aicen * HSNO_INIT, 0.2 * vicen)

    TairC = (Tair - ct.Tffresh) if Tair is not None else \
        torch.tensor(-15.0, **kw)
    Tsfc0 = torch.clamp(TairC, max=ct.Tsmelt)
    trcrn = st.trcrn.clone()
    trcrn[:, tr.nt_Tsfc] = torch.where(msk[None], Tsfc0, Tf)
    sal = torch.as_tensor(salinz, **kw)
    Tmltz = -sal * ct.depressT
    zero_layer = cfg.thermo.ktherm == 0     # latent heat only
    for k in range(cfg.nilyr):
        zfrac = (k + 0.5) / cfg.nilyr
        Ti = torch.minimum(Tsfc0 + (Tf - Tsfc0) * zfrac, Tmltz[k] - 0.1)
        qk = thshared.ice_enthalpy(Ti, Tmltz[k])
        if zero_layer:
            qk = torch.full_like(qk, -ct.rhoi * ct.Lfresh)
        trcrn[:, tr.nt_qice + k] = torch.where(msk[None], qk, 0.0)
        trcrn[:, tr.nt_sice + k] = torch.where(msk[None], sal[k], 0.0)
    qs = thshared.snow_enthalpy(torch.clamp(Tsfc0, max=-1.0))
    if zero_layer:
        qs = torch.full_like(qs, -ct.rhos * ct.Lfresh)
    for k in range(cfg.nslyr):
        trcrn[:, tr.nt_qsno + k] = torch.where(msk[None], qs,
                                               -ct.rhos * ct.Lfresh)
    if tr.nt_alvl >= 0:
        trcrn[:, tr.nt_alvl] = torch.where(msk[None], 1.0, 0.0)
        trcrn[:, tr.nt_vlvl] = torch.where(msk[None], 1.0, 0.0)
    if tr.nt_fbri >= 0:
        trcrn[:, tr.nt_fbri] = 1.0
    sst0 = torch.full(grid.shape, Tf, **kw) if sst is None else sst
    return st.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                      sst=sst0 * tmask.to(cfg.xp_dtype))


class Model:
    """Standalone driver of the port.

    device: None runs on the GPU and raises when there is none; pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU.
    grid: optional pre-built Grid (moved to the device); defaults to
    ``make_grid(cfg)``, which reads the grid files a POP, CPOM or lat-lon
    configuration names (``gx3_config(grid_dir)``); gx1 takes its grid
    from the caller (``grid.synth_gx1_grid(cfg, device=...)``).

    On a CUDA device ``step`` and ``rollout`` replay the step captured as
    CUDA graphs (``driver/graph.py``), once for each set of input shapes
    and dtypes, at its first call: that call runs its first step eagerly,
    captures, and replays the steps after it. A capture that fails
    raises; nothing falls back to eager launches. On
    the CPU they run the step eagerly. The eager step on any device is the
    module function ``driver.step.step`` (``step(state, forcing,
    *model.step_args)``)."""

    def __init__(self, cfg: ModelConfig, grid: Grid | None = None,
                 device=None):
        check_supported(cfg)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Model runs on the GPU and no CUDA device is available;"
                    " pass device='cpu' to run the plain PyTorch path on "
                    "the CPU")
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.device = device
        self.grid = make_grid(cfg, device=self.device) if grid is None \
            else grid.to(self.device)
        self.tr = build_tracer_registry(cfg)
        self.hin_max = itd.category_bounds(cfg.ncat, cfg.kitd, cfg.kcatbound)
        # float64 on the device, so the step reads it in place
        self.salinz = torch.as_tensor(thshared.salinity_profile(
            cfg.nilyr, cfg.thermo.saltmax, cfg.thermo.nsal, cfg.thermo.msal),
            dtype=torch.float64, device=self.device)
        self.topo = Topology(ew=cfg.grid.ew_boundary,
                             ns=cfg.grid.ns_boundary)
        self.calendar = Calendar(cfg.time.year_init, cfg.time.days_per_year,
                                 cfg.time.use_leap_years)
        sw = cfg.shortwave
        self.orb = shr_orb_params(sw.iyear_orb, eccen=sw.orb_eccen,
                                  obliq=sw.orb_obliq, mvelp=sw.orb_mvelp)
        self.graphs: dict[tuple, graph.StepGraph] = {}

    @property
    def step_args(self) -> tuple:
        """The arguments of ``driver.step.step`` after (state, forcing)."""
        return (self.grid, self.cfg, self.tr, self.topo, self.hin_max,
                self.salinz)

    def init_state(self, **kw) -> State:
        # slab-ocean runs start SST from the forcing's open-water SST
        if "sst" not in kw and self.cfg.forcing.oceanmixed_ice \
                and self.forcing_provider is None:
            kw["sst"] = self.forcing_at(0).sst
        st = init_state(self.cfg, self.grid, self.tr, self.hin_max,
                        self.salinz, **kw)
        if self.cfg.coupled_radiation:
            # init_shortwave analog: seed the radiation memory so the
            # first coupled-ordering step has nonzero SW
            st = prefill_radiation(st, self.forcing_at(0), self.cfg,
                                   self.tr)
        return st

    forcing_provider = None   # optional: callable(istep, info) -> Forcing

    def forcing_at(self, istep: int) -> Forcing:
        info = self.calendar.info(istep, self.cfg.time.dt)
        if self.forcing_provider is not None:
            return self.forcing_provider(istep, info)
        return idealized_polar_forcing(
            self.grid.shape, info.yday, dtype=self.cfg.xp_dtype,
            tlat=self.grid.TLAT, tlon=self.grid.TLON, orb=self.orb,
            device=self.device)

    def _eager(self, state: State, forcing: Forcing):
        return step_fn(state, forcing, *self.step_args)

    def _graph(self, state: State, forcing: Forcing):
        """(the StepGraph for these inputs, and (state, diag) of the eager
        step run to capture it, or None when it was captured before)."""
        key = graph.signature(state, forcing)
        g = self.graphs.get(key)
        if g is not None:
            return g, None
        bad = {d for *_, d in key if d != self.device}
        if bad:
            raise ValueError(f"inputs on {sorted(map(str, bad))} for a "
                             f"model on {self.device}")
        out = self._eager(state, forcing)
        g = self.graphs[key] = graph.StepGraph(self._eager, state, forcing)
        return g, out

    def step(self, state: State, forcing: Forcing):
        """One step. Returns (state, diag); on CUDA both are clones that
        no later replay overwrites."""
        if self.device.type != "cuda":
            return self._eager(state, forcing)
        g, out = self._graph(state, forcing)
        if out is not None:
            return out
        g.load(state, forcing)
        g.replay()
        return g.result()

    def run(self, state: State, nsteps: int, **kw):
        """Time loop (CICE_RunMod.F90:37-90 CICE_Run): step + diagnostics +
        history accumulation/write + restart dumps (``run_loop``)."""
        return run_loop(self, state, nsteps, **kw)

    # run_loop's I/O boundary: one device holds the global arrays and
    # writes the files (a ShardedModel gathers its tiles, and only its
    # primary rank writes)
    writes_files = True

    def global_view(self, tree):
        return tree

    def rollout(self, state: State, forcing, nsteps: int):
        """Advance nsteps. ``forcing`` is one Forcing held fixed, or a
        sequence of nsteps Forcings. Returns (state, diag of the last
        step). On CUDA the steps are graph replays that chain on the
        device; a sequence's forcings are copied into the graph's buffers
        one per step."""
        seq = forcing if isinstance(forcing, (list, tuple)) else None
        if seq is not None and len(seq) != nsteps:
            raise ValueError(f"{len(seq)} forcings for {nsteps} steps")
        diag = None
        if self.device.type != "cuda":
            for k in range(nsteps):
                state, diag = self._eager(state, seq[k] if seq else forcing)
            return state, diag
        if nsteps == 0:
            return state, diag
        g, out = self._graph(state, seq[0] if seq else forcing)
        start = 0
        if out is not None:
            (state, diag), start = out, 1
        if start < nsteps:
            g.load(state, None if seq else forcing)
            for k in range(start, nsteps):
                if seq:
                    g.load(forcing=seq[k])
                g.replay()
            state, diag = g.result()
        return state, diag


def run_loop(m, state, nsteps: int, start_step: int = 0,
             diag_every: int = 0, diag_fn=None, history=None,
             history_dir: str = "history", restart_every: int = 0,
             restart_dir: str = "restart", log=print,
             check_every: int = 0, dump_last: bool = False):
    """Driver time loop (CICE_RunMod.F90:37-90 CICE_Run): step + boundary
    restoring + state health checks + runtime diagnostics + history
    accumulation/write + restart dumps, for a ``Model`` or a
    ``ShardedModel``. ``m`` needs .cfg/.grid/.tr/.topo/.calendar/.step/
    .forcing_at and the I/O boundary .global_view/.writes_files.

    Each step is ``m.step`` (on CUDA a replay of the step's graphs); the
    loop reads the device only between steps: the step's state_bad count
    under ``check_every`` (a global count on a mesh), the diagnostics
    every ``diag_every`` steps, and the history and restart files when
    they are written. On a mesh of ranks each of those gathers the tiles
    into global tensors on every rank (``m.global_view``, collective), and
    only the primary rank accumulates history, writes files and logs.
    History accumulates on the device. Returns the final state."""
    cfg = m.cfg
    dtype = cfg.xp_dtype
    if state.aicen.dtype != dtype:
        raise ValueError(
            f"a {state.aicen.dtype} state for a {dtype} model: restore it "
            f"with restart.restore(..., dtype=model.cfg.xp_dtype)")
    rest, mask = None, None
    if cfg.forcing.restore_ice:
        # the restoring state and the edge mask, made once for the run
        rest = state
        mask = edge_mask(state.aicen.shape[-2:], m.topo, dtype,
                         state.aicen.device)
    writer = m.writes_files
    if not writer:
        log = _silent
    for k in range(nsteps):
        istep = start_step + k
        forcing = m.forcing_at(istep)
        state, diag = m.step(state, forcing)
        if rest is not None:
            state = restore_ice(cfg.time.dt, cfg.forcing.trestore,
                                state, rest, m.topo, mask)
        info = m.calendar.info(istep + 1, cfg.time.dt)

        if check_every:
            # the in-step flag is computed inside the step every step
            # (l_stop analog) — reading it costs one scalar sync
            if int(diag.state_bad) > 0 or (istep % check_every == 0):
                if not diag_mod.check_state(m.global_view(state), m.grid,
                                            m.tr, cfg.nilyr, cfg.nslyr,
                                            istep=istep, log=log):
                    raise RuntimeError(
                        f"check_state failed at istep {istep}: "
                        f"{int(diag.state_bad)} bad state values "
                        "(see log for the offending cell dump)")

        if diag_every and (istep % diag_every == 0):
            gstate = m.global_view(state)
            gd = diag_mod.compute_diags(gstate, m.grid, m.tr,
                                        cfg.nilyr, cfg.nslyr)
            log(diag_mod.format_diags(istep, gd))
            if diag_fn is not None:
                diag_fn(istep, gstate, m.global_view(diag))

        if history is not None:
            gdiag, gstate, gforcing = m.global_view((diag, state, forcing))
        if history is not None and writer:
            history.accum(hist_mod.diag_to_values(
                gdiag, gstate, m.grid, tr=m.tr, forcing=gforcing,
                nilyr=cfg.nilyr, nslyr=cfg.nslyr), info.time)
            if hasattr(history, "write_ready"):   # HistoryStreams
                for fn in history.write_ready(m.grid, info, history_dir):
                    log(f"wrote history {fn}")
            elif history.ready(info):
                fn = os.path.join(
                    history_dir,
                    f"iceh.{info.year:04d}-{info.month:02d}-"
                    f"{info.mday:02d}-{info.sec:05d}.nc")
                hist_mod.write_netcdf(history, m.grid, info, fn)
                log(f"wrote history {fn}")

        write_last = dump_last and k == nsteps - 1
        if (restart_every and ((istep + 1) % restart_every == 0)) \
                or write_last:
            # dump_last: always checkpoint at job end regardless of the
            # periodic schedule (setup_nml dump_last,
            # input_templates/gx3/ice_in:21)
            fn = os.path.join(
                restart_dir,
                f"iced.{info.year:04d}-{info.month:02d}-"
                f"{info.mday:02d}-{info.sec:05d}.npz")
            gstate = m.global_view(state)
            if writer:
                restart_mod.dump(gstate, fn, istep=istep + 1,
                                 time=info.time)
                log(f"wrote restart {fn}")
    return state


def _silent(*args, **kw):
    """The log of a rank that is not the primary."""
