"""The port's form drag (``cice5_tpu_torch/models/formdrag.py``) against
the JAX package's ``neutral_drag_coeffs`` (Tsamados et al. 2014,
ice_atmo.F90:644-1023) on the same seeded NumPy inputs, float64: every
coefficient and geometry field within 1e-12 of its scale, with and
without the pond and level-ice tracers; then the cases of
tests/test_formdrag.py (neutral limits, ridges, ponds, caps, ice-free
defaults, draft and freeboard) run on the port."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice5_tpu.models import formdrag as jfd
from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.models import formdrag as tfd
from torch_port_util import assert_close

NCAT, NY, NX = 5, 12, 16


def _random_inputs(seed, ponds, levels):
    """Seeded (ncat, 12, 16) category fields with open water, thin and
    ridged ice, and their aggregates; the pond and level-ice tracers when
    asked for."""
    rng = np.random.default_rng(seed)
    aicen = rng.uniform(0.0, 0.2, (NCAT, NY, NX))
    aicen[:, rng.uniform(size=(NY, NX)) < 0.15] = 0.0      # open water
    aicen[:, :2, :3] = 1e-4                                 # below act
    hin = rng.uniform(0.1, 4.0, (NCAT, NY, NX))
    vicen = aicen * hin
    vsnon = vicen * rng.uniform(0.0, 0.3, (NCAT, NY, NX))
    kw = dict(aice=aicen.sum(0), vice=vicen.sum(0), vsno=vsnon.sum(0),
              aicen=aicen, vicen=vicen)
    if ponds:
        kw.update(apnd=rng.uniform(0.0, 0.6, aicen.shape),
                  hpnd=rng.uniform(0.0, 0.4, aicen.shape),
                  ipnd=rng.uniform(0.0, 0.05, aicen.shape))
    if levels:
        kw.update(alvl=rng.uniform(0.3, 1.0, aicen.shape),
                  vlvl=rng.uniform(0.2, 1.0, aicen.shape))
    return kw


@pytest.mark.parametrize("ponds,levels", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_neutral_drag_coeffs_matches_jax(ponds, levels):
    kw = _random_inputs(3, ponds, levels)
    ref = jfd.neutral_drag_coeffs(**{k: jnp.asarray(v)
                                     for k, v in kw.items()})
    got = tfd.neutral_drag_coeffs(**{k: torch.as_tensor(v)
                                     for k, v in kw.items()})
    assert tfd.FormDrag._fields == jfd.FormDrag._fields
    for name, a, b in zip(got._fields, ref, got):
        assert b.dtype == torch.float64, name
        assert_close(np.asarray(a), b, 1e-12, name, floor=1e-30)
    # the inputs reach every branch: ridges, keels, ponds and ice-free
    if levels:
        assert float(got.Cdn_atm_rdg.max()) > 0.0
        assert float(got.Cdn_ocn_keel.max()) > 0.0
    if ponds:
        assert float(got.Cdn_atm_pond.max()) > 0.0
    assert bool((got.Cdn_ocn == ct.dragio).any())


def test_float32_stays_float32():
    kw = _random_inputs(4, True, True)
    got = tfd.neutral_drag_coeffs(**{k: torch.as_tensor(v, dtype=torch.float32)
                                     for k, v in kw.items()})
    assert all(x.dtype == torch.float32 for x in got)
    ref = tfd.neutral_drag_coeffs(**{k: torch.as_tensor(v)
                                     for k, v in kw.items()})
    for name, a, b in zip(got._fields, ref, got):
        assert_close(a, b, 1e-5, name, floor=1e-30)


# the cases of tests/test_formdrag.py, on the port


def _inputs(B=(6,), ai=0.9, hi=2.0, hs=0.2, ncat=5, ardg_frac=0.0,
            apnd_val=0.0):
    f = lambda v: torch.full(B, float(v), dtype=torch.float64)
    fc = lambda v: torch.full((ncat,) + B, float(v), dtype=torch.float64)
    return dict(
        aice=f(ai), vice=f(ai * hi), vsno=f(ai * hs),
        aicen=fc(ai / ncat), vicen=fc(ai * hi / ncat),
        alvl=fc(1.0 - ardg_frac), vlvl=fc(1.0 - ardg_frac),
        apnd=fc(apnd_val), hpnd=fc(0.1 if apnd_val else 0.0), ipnd=fc(0.0))


def test_level_ice_near_skin_drag():
    """All level ice, no ponds: drag ~ skin + floe edge only."""
    r = tfd.neutral_drag_coeffs(**_inputs())
    assert float(r.Cdn_atm_rdg.max()) == 0.0
    assert float(r.Cdn_ocn_keel.max()) == 0.0
    assert float(r.Cdn_atm_pond.max()) == 0.0
    np.testing.assert_allclose(r.Cdn_atm_skin.numpy(), tfd.CSA)
    np.testing.assert_allclose(r.Cdn_ocn_skin.numpy(), tfd.CSW)
    assert float(r.Cdn_atm.min()) > 0.0


def test_ridges_add_drag():
    lvl = tfd.neutral_drag_coeffs(**_inputs(ardg_frac=0.0))
    rdg = tfd.neutral_drag_coeffs(**_inputs(ardg_frac=0.5, hi=3.0))
    assert float(rdg.Cdn_atm_rdg.min()) > 0.0
    assert float(rdg.Cdn_ocn_keel.min()) > 0.0
    assert float(rdg.hridge.min()) > 0.0
    assert float(rdg.hkeel.min()) > float(rdg.hridge.min())
    assert float((rdg.Cdn_atm - lvl.Cdn_atm).min()) > 0.0


def test_ponds_add_drag():
    dry = tfd.neutral_drag_coeffs(**_inputs())
    wet = tfd.neutral_drag_coeffs(**_inputs(apnd_val=0.3))
    assert float(wet.Cdn_atm_pond.min()) > 0.0
    assert float(dry.Cdn_atm_pond.max()) == 0.0


def test_caps_respected():
    r = tfd.neutral_drag_coeffs(**_inputs(ardg_frac=0.95, hi=8.0,
                                          apnd_val=0.9))
    assert float(r.Cdn_atm.max()) <= tfd.CAMAX + 1e-12
    assert float(r.Cdn_ocn.max()) <= tfd.CWMAX + 1e-12


def test_ice_free_defaults():
    kw = _inputs(ai=0.0, hi=0.0, hs=0.0)
    r = tfd.neutral_drag_coeffs(**kw)
    cd_neutral = (ct.vonkar / math.log(ct.zref / ct.iceruf)) ** 2
    np.testing.assert_allclose(r.Cdn_atm.numpy(), cd_neutral, rtol=1e-6)
    np.testing.assert_allclose(r.Cdn_ocn.numpy(), ct.dragio, rtol=1e-6)


def test_draft_physical():
    r = tfd.neutral_drag_coeffs(**_inputs(hi=2.0, hs=0.2))
    hd, hf = r.hdraft.numpy(), r.hfreebd.numpy()
    assert (hd > 0).all() and (hf > 0).all()
    np.testing.assert_allclose(hd + hf, 2.2, rtol=1e-6)
