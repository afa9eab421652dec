"""The benchmark's plain reference of the sea-ice step.

``reference.cice`` is a frozen copy of the port's plain PyTorch path: the
step (``driver/step.py``) with every model module it calls, the grid
construction, the forcing, the state, the calendar and the default initial
state, with each hand-written kernel's caller bound to its plain version
on every device (``evp.evp_sweep``, ``remap.remap_flux_both``,
``dedd.shortwave_dEdd_ncat``, ``evp_fused.fused_sweep``). It imports
nothing of the port, of JAX or of the JAX package, and works out from the
benchmark's inputs (the grid's POP arrays, the initial state, the
forcing) everything the port derives from them.

``Reference`` builds one configuration on one device in one precision.
States and forcings go in and out as dicts of tensors keyed by field
name, so the harness hands the same inputs to the port and to the
reference, and the reference reads the port's outputs only to judge them.
"""
from __future__ import annotations

import dataclasses

import torch

from reference.cice import config as rc
from reference.cice.calendar import Calendar
from reference.cice.driver.step import prefill_radiation, step as ref_step
from reference.cice.forcing import Forcing, idealized_polar_forcing
from reference.cice.grid import popgrid_np
from reference.cice.init import init_state
from reference.cice.models.radiation.orbital import shr_orb_params
from reference.cice.models.thermo import itd, shared as thshared
from reference.cice.parallel import Topology
from reference.cice.state import State, build_tracer_registry

_SECTIONS = {"grid": rc.GridConfig, "thermo": rc.ThermoConfig,
             "dyn": rc.DynConfig, "shortwave": rc.ShortwaveConfig,
             "tracers": rc.TracerConfig, "forcing": rc.ForcingConfig,
             "time": rc.TimeConfig}


def model_config(model: dict, dtype: str) -> rc.ModelConfig:
    """The reference's ModelConfig of a configuration file's ``model``
    object (every field spelled out), computed in ``dtype``."""
    kw = {k: (_SECTIONS[k](**v) if k in _SECTIONS else v)
          for k, v in model.items()}
    return rc.ModelConfig(**kw).replace(dtype=dtype, accum_dtype=dtype)


def state_fields() -> tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(State))


class Reference:
    """One configuration of the plain step on ``device`` in ``dtype``
    ("float64" or "float32")."""

    def __init__(self, model: dict, pop_arrays, *, dtype: str, device):
        self.cfg = cfg = model_config(model, dtype)
        self.device = torch.device(device)
        self.dtype = cfg.xp_dtype
        self.grid = popgrid_np(cfg, *pop_arrays, device=self.device)
        self.tr = build_tracer_registry(cfg)
        self.hin_max = itd.category_bounds(cfg.ncat, cfg.kitd,
                                           cfg.kcatbound)
        self.salinz = torch.as_tensor(thshared.salinity_profile(
            cfg.nilyr, cfg.thermo.saltmax, cfg.thermo.nsal,
            cfg.thermo.msal), dtype=torch.float64, device=self.device)
        self.topo = Topology(ew=cfg.grid.ew_boundary,
                             ns=cfg.grid.ns_boundary)
        self.calendar = Calendar(cfg.time.year_init, cfg.time.days_per_year,
                                 cfg.time.use_leap_years)
        sw = cfg.shortwave
        self.orb = shr_orb_params(sw.iyear_orb, eccen=sw.orb_eccen,
                                  obliq=sw.orb_obliq, mvelp=sw.orb_mvelp)

    def yday(self, istep: int) -> float:
        return self.calendar.info(istep, self.cfg.time.dt).yday

    def idealized_forcing(self, istep: int) -> Forcing:
        """The analytic forcing of step ``istep`` (``Model.forcing_at``)."""
        return idealized_polar_forcing(
            self.grid.shape, self.yday(istep), dtype=self.dtype,
            tlat=self.grid.TLAT, tlon=self.grid.TLON, orb=self.orb,
            device=self.device)

    def initial_state(self) -> dict:
        """The default initial state (``Model.init_state`` with no
        arguments): ice poleward of 70N/60S, the slab ocean's SST from the
        forcing of step 0, and with the coupled radiation ordering its
        radiation memory seeded from that forcing."""
        cfg = self.cfg
        kw = {}
        if cfg.forcing.oceanmixed_ice:
            kw["sst"] = self.idealized_forcing(0).sst
        st = init_state(cfg, self.grid, self.tr, self.hin_max, self.salinz,
                        **kw)
        if cfg.coupled_radiation:
            st = prefill_radiation(st, self.idealized_forcing(0), cfg,
                                   self.tr)
        return self.as_dict(st)

    def as_dict(self, st) -> dict:
        return {k: getattr(st, k) for k in state_fields()}

    def _state(self, fields: dict) -> State:
        return State(**{k: torch.as_tensor(fields[k]).to(
            device=self.device, dtype=self.dtype) for k in state_fields()})

    def _forcing(self, fields: dict) -> Forcing:
        kw = {}
        for f in dataclasses.fields(Forcing):
            v = fields.get(f.name)
            if v is not None:
                v = torch.as_tensor(v).to(device=self.device,
                                          dtype=self.dtype)
            kw[f.name] = v
        return Forcing(**kw)

    def step(self, state: dict, forcing: dict):
        """One step from ``state`` under ``forcing`` (dicts of tensors or
        arrays, cast to the reference's device and dtype). Returns (state
        dict, StepDiag)."""
        st, diag = ref_step(self._state(state), self._forcing(forcing),
                            self.grid, self.cfg, self.tr, self.topo,
                            self.hin_max, self.salinz)
        return self.as_dict(st), diag

    def tracer_amounts(self, state: dict) -> torch.Tensor:
        """The conserved amount (weight x value) of every tracer slot,
        (ncat, ntrcr, ny, nx), in the reference's dtype."""
        s = self._state(state)
        return itd.tracer_weights(self.tr, s.aicen, s.vicen, s.vsnon,
                                  s.trcrn) * s.trcrn
