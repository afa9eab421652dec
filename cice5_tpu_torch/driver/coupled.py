"""The coupling boundary: where an atmosphere or ocean model (or a data
pump) exchanges fields with the sea-ice model (PyTorch port of
``cice5_tpu/driver/coupled.py``).

Reference equivalents: the AusCOM/ACCESS OASIS3-MCT driver
(drivers/auscom/cpl_interface.F90 from_atm :470, from_ocn :554, into_ocn
:613; CICE_RunMod.F90:52-240, the coupled loop that interleaves ice_step
with the coupler's gets and puts) and ``scale_fluxes``
(source/ice_flux.F90:840-933), which turns ice-area-weighted cell means
into the per-ice-area fluxes a coupler expects.

In place of MPI + OASIS puts and gets into a remote coupler, the exchange
is three host callbacks of the embedding system:

    get_atm(time_sec)  -> dict of atmospheric fields (ny, nx); with
                          calc_Tsfc=False also the per-category surface
                          fluxes CAT_FIELDS (ncat, ny, nx)
    get_ocn(time_sec)  -> dict of ocean fields
    put_ocn(time_sec, dict)  # receives the scaled outbound fields

Inbound fields may be host NumPy arrays (an OASIS coupler hands host
buffers) or tensors; each goes to the model's device and dtype, once per
exchange. The ice steps between exchanges through ``Model.step``, so on
CUDA every step replays the step's CUDA graphs. The outbound dict holds
tensors on the model's device: the loop reads the device on the host only
in ``boundary_checksums`` and in what ``put_ocn`` does with them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.driver.model import Model
from cice5_tpu_torch.forcing import Tf_from_sss, sw_partition


class ScaledFluxes(NamedTuple):
    """Per-ice-area fluxes for the coupler (ice_flux.F90:840
    scale_fluxes)."""
    strairxT: torch.Tensor
    strairyT: torch.Tensor
    fsens: torch.Tensor
    flat: torch.Tensor
    fswabs: torch.Tensor
    flwout: torch.Tensor
    evap: torch.Tensor
    fresh: torch.Tensor
    fsalt: torch.Tensor
    fhocn: torch.Tensor
    fswthru: torch.Tensor
    alvdr: torch.Tensor
    alvdf: torch.Tensor
    alidr: torch.Tensor
    alidf: torch.Tensor


def scale_fluxes(diag, *, aice, tmask, Tf, Tair, Qa) -> ScaledFluxes:
    """Cell-mean (ice-area-weighted) fluxes as per-unit-ice-area values;
    ice-free cells get the reference's defaults (zero fluxes, blackbody
    flwout at Tf). Tair and Qa are taken as the JAX function takes them
    and, as there, unused."""
    has_ice = (aice > ct.puny) & tmask
    ar = torch.where(has_ice, 1.0 / torch.clamp(aice, min=ct.puny), 0.0)
    s = lambda x: torch.where(has_ice, x * ar, 0.0)
    return ScaledFluxes(
        strairxT=s(diag.strairxT), strairyT=s(diag.strairyT),
        fsens=s(diag.fsens), flat=s(diag.flat), fswabs=s(diag.fswabs),
        flwout=torch.where(
            has_ice, diag.flwout * ar,
            -ct.stefan_boltzmann * (Tf + ct.Tffresh) ** 4),
        evap=s(diag.evap), fresh=s(diag.fresh), fsalt=s(diag.fsalt),
        fhocn=s(diag.fhocn), fswthru=s(diag.fswthru),
        alvdr=s(diag.alvdr), alvdf=s(diag.alvdf),
        alidr=s(diag.alidr), alidf=s(diag.alidf))


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

# the field names accepted from the atmosphere (cpl_interface.F90 from_atm
# field list, generalized) and the ocean (from_ocn :554-600)
ATM_FIELDS = ("swvdr", "swvdf", "swidr", "swidf", "flw", "Tair", "potT",
              "Qa", "rhoa", "uatm", "vatm", "wind", "zlvl", "fsnow",
              "frain", "fsw")
OCN_FIELDS = ("sst", "sss", "uocn", "vocn", "ss_tltx", "ss_tlty", "frzmlt",
              "qdp", "hmix")
# the per-category surface fluxes an atmosphere sends when the ice takes
# them as given (calc_Tsfc=False; set_sfcflux, ice_flux.F90:1015), each
# (ncat, ny, nx): the JAX package's Forcing has the fields and its step
# reads them, but its coupled driver passes no field of that shape
CAT_FIELDS = ("fsurfn_f", "fcondtopn_f", "flatn_f", "fsensn_f")


@dataclasses.dataclass
class CoupledModel:
    """Callback-coupled ice model (drivers/auscom/CICE_RunMod.F90:52-240).

    num_cpl_ai: ice steps per atmosphere coupling period;
    num_cpl_io: ice steps per ocean coupling period."""
    model: Model
    get_atm: Callable[[float], Mapping[str, object]] | None = None
    get_ocn: Callable[[float], Mapping[str, object]] | None = None
    put_ocn: Callable[[float, Mapping[str, object]], None] | None = None
    num_cpl_ai: int = 1
    num_cpl_io: int = 1

    def __post_init__(self):
        self._forcing = self.model.forcing_at(0)
        self._shape = tuple(self.model.grid.shape)
        self._dtype = self.model.cfg.xp_dtype

    def _field(self, v, per_category=False) -> torch.Tensor:
        """An inbound field on the model's device in its dtype, at the
        grid's shape, or (ncat, ny, nx) ``per_category`` (a scalar is
        broadcast, as it broadcasts in the JAX package's step, so the
        step's captured graphs keep their shapes). A copy: the caller may
        reuse its buffer."""
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.asarray(v, dtype=_NP_DTYPES[self._dtype]))
        t = v.to(device=self.model.device, dtype=self._dtype, copy=True)
        shape = ((self.model.cfg.ncat,) + self._shape if per_category
                 else self._shape)
        return torch.broadcast_to(t, shape).contiguous()

    def _merge(self, updates: Mapping[str, object], allowed) -> None:
        """Overwrite forcing fields from a coupler exchange."""
        fields = {}
        for k, v in updates.items():
            if k == "fsw":   # total SW -> spectral split
                vdr, vdf, idr, idf = sw_partition(self._field(v))
                fields.update(swvdr=vdr, swvdf=vdf, swidr=idr, swidf=idf)
                continue
            if k not in allowed:
                raise KeyError(f"unknown coupling field '{k}'")
            fields[k] = self._field(v, per_category=k in CAT_FIELDS)
        if "sss" in fields:
            fields["Tf"] = Tf_from_sss(fields["sss"])
        if "Tair" in fields and "potT" not in fields:
            fields["potT"] = fields["Tair"]
        if ("uatm" in fields or "vatm" in fields) and "wind" not in fields:
            u = fields.get("uatm", self._forcing.uatm)
            v = fields.get("vatm", self._forcing.vatm)
            fields["wind"] = torch.sqrt(u * u + v * v)
        self._forcing = self._forcing.replace(**fields)

    def from_atm(self, fields: Mapping[str, object]) -> None:
        """Receive atmospheric coupling fields (cpl_interface.F90:470);
        the per-category surface fluxes only when the model takes them
        (calc_Tsfc=False)."""
        allowed = ATM_FIELDS if self.model.cfg.thermo.calc_Tsfc \
            else ATM_FIELDS + CAT_FIELDS
        self._merge(fields, allowed)

    def from_ocn(self, fields: Mapping[str, object]) -> None:
        """Receive ocean coupling fields (cpl_interface.F90:554)."""
        self._merge(fields, OCN_FIELDS + ("Tf",))

    def into_ocn(self, state, diag) -> dict:
        """Outbound fields for the ocean (cpl_interface.F90:613 into_ocn):
        ice-ocean stress, per-area heat/water/salt fluxes, penetrating SW,
        ice concentration; tensors on the model's device."""
        sf = scale_fluxes(
            diag, aice=diag.aice, tmask=self.model.grid.tmask,
            Tf=self._forcing.Tf, Tair=self._forcing.Tair,
            Qa=self._forcing.Qa)
        return {
            "strocnxT": state.strocnxT, "strocnyT": state.strocnyT,
            "fresh": sf.fresh, "fsalt": sf.fsalt, "fhocn": sf.fhocn,
            "fswthru": sf.fswthru, "aice": diag.aice,
            "melt": sf.fresh, "form": sf.fsalt,
        }

    def boundary_checksums(self, time_sec: float, outbound: Mapping[
            str, object] | None = None) -> dict:
        """Coupling-debug checksums (cpl_interface.F90:753
        write_boundary_checksums): plain sums of every inbound forcing
        field and (optionally) of the outbound exchange, as a dict of
        Python floats for log-to-log comparison against a peer model's
        ledger. Reads each sum back from the device."""
        sums = {"time": float(time_sec)}
        f = self._forcing
        for k in ATM_FIELDS + OCN_FIELDS:
            v = getattr(f, k, None)
            if v is not None and v.dim() == 2:
                sums[k] = float(v.sum())
        if outbound is not None:
            for k, v in outbound.items():
                sums["out_" + k] = float(torch.as_tensor(v).sum())
        return sums

    def run(self, state, nsteps: int, start_step: int = 0,
            chksum_every: int = 0):
        """Coupled time loop: exchange on coupling boundaries, step the ice
        in between (CICE_RunMod.F90:121-240). chksum_every > 0 prints
        boundary checksums on that cadence (the reference's DEBUG ledger,
        cpl_interface.F90:753). Returns (state, diag of the last step)."""
        dt = self.model.cfg.time.dt
        diag = None
        for k in range(nsteps):
            istep = start_step + k
            t = istep * dt
            if self.get_atm is not None and istep % self.num_cpl_ai == 0:
                self.from_atm(self.get_atm(t))
            if self.get_ocn is not None and istep % self.num_cpl_io == 0:
                self.from_ocn(self.get_ocn(t))
            state, diag = self.model.step(state, self._forcing)
            out = None
            if (self.put_ocn is not None
                    and (istep + 1) % self.num_cpl_io == 0):
                out = self.into_ocn(state, diag)
                self.put_ocn(t + dt, out)
            if chksum_every and (istep + 1) % chksum_every == 0:
                print("[ice chksum]", self.boundary_checksums(t + dt, out))
        return state, diag
