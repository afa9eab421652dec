"""Delta-Eddington multiple-scattering shortwave radiation (PyTorch port of
``cice5_tpu/models/radiation/dedd.py``).

The Briegleb & Light solver of ice_shortwave.F90: run_dEdd (:1251),
shortwave_dEdd (:1607), compute_dEdd (:2034, layer optical properties with
the snow grain-radius tables and the R_ice/R_pnd/R_snw tuning),
solution_dEdd (:3270, the adding method with the Fresnel refraction
layer) and shortwave_dEdd_set_snow (:3782). All three surface types (bare,
snow, pond) are computed for every cell and mixed by their area
fractions; the three spectral bands ride a leading case axis; the
klev = nslyr + nilyr + 1 radiation layers follow the reference:
[snow SSL, rest of the snow | pond layers] + [ice SSL, DL, interior].

``shortwave_dEdd`` is elementwise over any batch *B (layer axes first);
``compute_dEdd`` is the reference's one-surface-type path over the same
building blocks.
``shortwave_dEdd_ncat`` runs all categories of the model step: the
hand-written CUDA kernel ``csrc/shortwave_dedd.cu`` for tensors on the GPU,
its plain version ``shortwave_dEdd_plain`` (this module's
``shortwave_dEdd`` over the category batch) on the CPU. The kernel replaces
the JAX package's Pallas ``shortwave_dEdd_tiled``
(cice5_tpu/ops/pallas/dedd_fused.py:51) and reads its tables and optical
constants from ``kernel_tables`` here, so the two cannot drift.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from reference.cice import constants as ct
from reference.cice.utils import device_values

NSPINT = 3
HS_SSL = 0.040       # snow surface scattering layer thickness (m)
HI_SSL = 0.050       # ice SSL thickness (m)
HPMIN = 0.005        # minimum allowed melt pond depth (m)
HP0 = 0.200          # pond depth below which transition to bare ice
TRMIN = 0.001
EXP_MIN = math.exp(-10.0)
REFINDX = 1.310
CP063, CP455 = 0.063, 0.455

# snow grain radius table (ice_shortwave.F90 rsnw_tab etc.)
RSNW_TAB = np.array([5, 7, 10, 15, 20, 30, 40, 50, 65, 80, 100, 120, 140,
                     170, 200, 240, 290, 350, 420, 500, 570, 660, 760, 870,
                     1000, 1100, 1250, 1400, 1600, 1800, 2000, 2500],
                    np.float64)
QS_TAB = np.array([
    [2.131798, 2.187756, 2.267358], [2.104499, 2.148345, 2.236078],
    [2.081580, 2.116885, 2.175067], [2.062595, 2.088937, 2.130242],
    [2.051403, 2.072422, 2.106610], [2.039223, 2.055389, 2.080586],
    [2.032383, 2.045751, 2.066394], [2.027920, 2.039388, 2.057224],
    [2.023444, 2.033137, 2.048055], [2.020412, 2.028840, 2.041874],
    [2.017608, 2.024863, 2.036046], [2.015592, 2.022021, 2.031954],
    [2.014083, 2.019887, 2.028853], [2.012368, 2.017471, 2.025353],
    [2.011092, 2.015675, 2.022759], [2.009837, 2.013897, 2.020168],
    [2.008668, 2.012252, 2.017781], [2.007627, 2.010813, 2.015678],
    [2.006764, 2.009577, 2.013880], [2.006037, 2.008520, 2.012382],
    [2.005528, 2.007807, 2.011307], [2.005025, 2.007079, 2.010280],
    [2.004562, 2.006440, 2.009333], [2.004155, 2.005898, 2.008523],
    [2.003794, 2.005379, 2.007795], [2.003555, 2.005041, 2.007329],
    [2.003264, 2.004624, 2.006729], [2.003037, 2.004291, 2.006230],
    [2.002776, 2.003929, 2.005700], [2.002590, 2.003627, 2.005276],
    [2.002395, 2.003391, 2.004904], [2.002071, 2.002922, 2.004241]])
WS_TAB = np.array([
    [0.9999994, 0.9999673, 0.9954589], [0.9999992, 0.9999547, 0.9938576],
    [0.9999990, 0.9999382, 0.9917989], [0.9999985, 0.9999123, 0.9889724],
    [0.9999979, 0.9998844, 0.9866190], [0.9999970, 0.9998317, 0.9823021],
    [0.9999960, 0.9997800, 0.9785269], [0.9999951, 0.9997288, 0.9751601],
    [0.9999936, 0.9996531, 0.9706974], [0.9999922, 0.9995783, 0.9667577],
    [0.9999903, 0.9994798, 0.9621007], [0.9999885, 0.9993825, 0.9579541],
    [0.9999866, 0.9992862, 0.9541924], [0.9999838, 0.9991434, 0.9490959],
    [0.9999810, 0.9990025, 0.9444940], [0.9999772, 0.9988171, 0.9389141],
    [0.9999726, 0.9985890, 0.9325819], [0.9999670, 0.9983199, 0.9256405],
    [0.9999605, 0.9980117, 0.9181533], [0.9999530, 0.9976663, 0.9101540],
    [0.9999465, 0.9973693, 0.9035031], [0.9999382, 0.9969939, 0.8953134],
    [0.9999289, 0.9965848, 0.8865789], [0.9999188, 0.9961434, 0.8773350],
    [0.9999068, 0.9956323, 0.8668233], [0.9998975, 0.9952464, 0.8589990],
    [0.9998837, 0.9946782, 0.8476493], [0.9998699, 0.9941218, 0.8367318],
    [0.9998515, 0.9933966, 0.8227881], [0.9998332, 0.9926888, 0.8095131],
    [0.9998148, 0.9919968, 0.7968620], [0.9997691, 0.9903277, 0.7677887]])
GS_TAB = np.array([
    [0.859913, 0.848003, 0.824415], [0.867130, 0.858150, 0.848445],
    [0.873381, 0.867221, 0.861714], [0.878368, 0.874879, 0.874036],
    [0.881462, 0.879661, 0.881299], [0.884361, 0.883903, 0.890184],
    [0.885937, 0.886256, 0.895393], [0.886931, 0.887769, 0.899072],
    [0.887894, 0.889255, 0.903285], [0.888515, 0.890236, 0.906588],
    [0.889073, 0.891127, 0.910152], [0.889452, 0.891750, 0.913100],
    [0.889730, 0.892213, 0.915621], [0.890026, 0.892723, 0.918831],
    [0.890238, 0.893099, 0.921540], [0.890441, 0.893474, 0.924581],
    [0.890618, 0.893816, 0.927701], [0.890762, 0.894123, 0.930737],
    [0.890881, 0.894397, 0.933568], [0.890975, 0.894645, 0.936148],
    [0.891035, 0.894822, 0.937989], [0.891097, 0.895020, 0.939949],
    [0.891147, 0.895212, 0.941727], [0.891189, 0.895399, 0.943339],
    [0.891225, 0.895601, 0.944915], [0.891248, 0.895745, 0.945950],
    [0.891277, 0.895951, 0.947288], [0.891299, 0.896142, 0.948438],
    [0.891323, 0.896388, 0.949762], [0.891340, 0.896623, 0.950916],
    [0.891356, 0.896851, 0.951945], [0.891386, 0.897399, 0.954156]])

# ice/pond IOPs per band (ice_shortwave.F90 *_mn arrays)
KI_SSL_MN = (1000.1, 1003.7, 7042.0)
WI_SSL_MN = (0.9999, 0.9963, 0.9088)
GI_SSL_MN = (0.94, 0.94, 0.94)
KI_DL_MN = (100.2, 107.7, 1309.0)
WI_DL_MN = (0.9980, 0.9287, 0.0305)
GI_DL_MN = (0.94, 0.94, 0.94)
KI_INT_MN = (20.2, 27.7, 1445.0)
WI_INT_MN = (0.9901, 0.7223, 0.0277)
GI_INT_MN = (0.94, 0.94, 0.94)
KI_P_SSL_MN = (70.2, 77.7, 1309.0)
WI_P_SSL_MN = (0.9972, 0.9009, 0.0305)
GI_P_SSL_MN = (0.94, 0.94, 0.94)
KI_P_INT_MN = (20.2, 27.7, 1445.0)
WI_P_INT_MN = (0.9901, 0.7223, 0.0277)
GI_P_INT_MN = (0.94, 0.94, 0.94)
KW = (0.20, 12.0, 729.0)

GAUSPT = (0.9894009, 0.9445750, 0.8656312, 0.7554044,
          0.6178762, 0.4580168, 0.2816036, 0.0950125)
GAUSWT = (0.0271525, 0.0622535, 0.0951585, 0.1246290,
          0.1495960, 0.1691565, 0.1826034, 0.1894506)

POND_SCHEMES = ("cesm", "lvl", "topo")


def _tune(kmn, wmn, Rtune, fp, fm):
    """Scattering-coefficient tuning (ice_shortwave.F90:2560-2650)."""
    f = fp if Rtune >= 0 else fm
    sigp = max(kmn * wmn * (1.0 + f * Rtune), 0.0)
    k = sigp + kmn * (1.0 - wmn)
    return k, sigp / k


# the per-band optical constants, in the order of kernel_tables
IOP_KEYS = ("k_ssl", "w_ssl", "g_ssl", "k_dl", "w_dl", "g_dl", "k_int",
            "w_int", "g_int", "k_pssl", "w_pssl", "g_pssl", "k_pint",
            "w_pint", "g_pint", "kw")


def band_iops(R_ice, R_pnd):
    """Tuned ice/pond inherent optical properties of each band (Python
    floats; compute_dEdd :2560-2650)."""
    iops = []
    for ns in range(NSPINT):
        k_ssl, w_ssl = _tune(KI_SSL_MN[ns], WI_SSL_MN[ns], R_ice, 0.15, 0.15)
        k_dl, w_dl = _tune(KI_DL_MN[ns], WI_DL_MN[ns], R_ice, 0.15, 0.15)
        k_int, w_int = _tune(KI_INT_MN[ns], WI_INT_MN[ns], R_ice, 0.15, 0.15)
        k_pssl, w_pssl = _tune(KI_P_SSL_MN[ns], WI_P_SSL_MN[ns], R_pnd,
                               2.0, 0.5)
        k_pint, w_pint = _tune(KI_P_INT_MN[ns], WI_P_INT_MN[ns], R_pnd,
                               2.0, 0.5)
        iops.append(dict(k_ssl=k_ssl, w_ssl=w_ssl, g_ssl=GI_SSL_MN[ns],
                         k_dl=k_dl, w_dl=w_dl, g_dl=GI_DL_MN[ns],
                         k_int=k_int, w_int=w_int, g_int=GI_INT_MN[ns],
                         k_pssl=k_pssl, w_pssl=w_pssl, g_pssl=GI_P_SSL_MN[ns],
                         k_pint=k_pint, w_pint=w_pint, g_pint=GI_P_INT_MN[ns],
                         kw=KW[ns]))
    return iops


@functools.lru_cache(maxsize=8)
def kernel_tables(R_ice, R_pnd, device) -> torch.Tensor:
    """The float64 constants the CUDA kernel reads: RSNW_TAB (32), QS_TAB,
    WS_TAB, GS_TAB (each 32x3, row-major), per band the 16 values of
    IOP_KEYS, then the segment constants of ``_interp_table`` as it
    computes them in float64: the value steps fp[k+1] - fp[k] of QS_TAB,
    WS_TAB, GS_TAB (each 31x3, row-major) and the inverse widths
    1 / (xp[k+1] - xp[k]) of RSNW_TAB (31). Built from this module's
    tables, so the kernel and the plain version share one source of
    numbers; built once per device (a copy to the GPU waits for the
    device)."""
    iops = band_iops(R_ice, R_pnd)
    parts = [RSNW_TAB, QS_TAB.ravel(), WS_TAB.ravel(), GS_TAB.ravel(),
             np.array([[io[k] for k in IOP_KEYS] for io in iops]).ravel(),
             *(np.diff(t, axis=0).ravel() for t in (QS_TAB, WS_TAB, GS_TAB)),
             1.0 / np.diff(RSNW_TAB)]
    return torch.as_tensor(np.concatenate(parts), dtype=torch.float64,
                           device=device)


def _interp_table(x, xp_np, fp_np):
    """Branch-free piecewise-linear table lookup, clamped at the ends:
    y = fp[0] + sum_k (fp[k+1]-fp[k]) * clip((x-xp[k])/dx_k, 0, 1)."""
    xp = np.asarray(xp_np, np.float64)
    fp = np.asarray(fp_np, np.float64)
    y = torch.full_like(x, float(fp[0]))
    for k in range(len(xp) - 1):
        dfk = float(fp[k + 1] - fp[k])
        inv = 1.0 / float(xp[k + 1] - xp[k])
        y = y + dfk * torch.clamp((x - float(xp[k])) * inv, 0.0, 1.0)
    return y


def set_snow(aicen, vsnon, Tsfc, *, R_snw, rsnw_mlt, dT_mlt, hs0):
    """Snow fraction/grain radius (shortwave_dEdd_set_snow :3782)."""
    mask = aicen > ct.puny
    hs = torch.where(mask, vsnon / torch.clamp(aicen, min=ct.puny), 0.0)
    fs = torch.where(hs >= ct.hs_min,
                     torch.clamp(hs / hs0, max=1.0) if hs0 > ct.puny
                     else torch.ones_like(hs), 0.0)
    dTs = ct.Timelt - Tsfc
    fT = -torch.clamp(dTs / dT_mlt - 1.0, max=0.0)
    rsnw_nm = float(np.clip(500.0 - R_snw * 250.0, 100.0, rsnw_mlt))
    rsnw = torch.clamp(rsnw_nm + (rsnw_mlt - rsnw_nm) * fT, 100.0, rsnw_mlt)
    return fs, hs, rsnw


class LayerProps(NamedTuple):
    """Per-layer direct/diffuse reflection-transmission properties
    (the per-layer block of solution_dEdd :3340-3560)."""
    rdir: torch.Tensor
    tdir: torch.Tensor
    rdif_a: torch.Tensor
    rdif_b: torch.Tensor
    tdif_a: torch.Tensor
    tdif_b: torch.Tensor
    trnlay: torch.Tensor


def _alpha(w, uu, gg, e):
    return 0.75 * w * uu * ((1.0 + gg * (1.0 - w))
                            / (1.0 - e * e * uu * uu))


def _agamm(w, uu, gg, e):
    return 0.5 * w * ((1.0 + 3.0 * gg * (1.0 - w) * uu * uu)
                      / (1.0 - e * e * uu * uu))


def _layer_props(tau_k, w0_k, g_k, mu0n) -> LayerProps:
    """Delta-scaled single-layer R/T with the 8-point Gaussian
    re-integration of the diffuse properties (solution_dEdd :3430-3560)."""
    ftot = g_k * g_k
    ts = (1.0 - w0_k * ftot) * tau_k
    ws = (1.0 - ftot) * w0_k / torch.clamp(1.0 - w0_k * ftot, min=ct.puny)
    gs = (g_k - ftot) / torch.clamp(1.0 - ftot, min=ct.puny)
    ws = torch.clamp(ws, max=1.0 - ct.puny)    # guard el at w=1
    lm = torch.sqrt(3.0 * (1.0 - ws) * (1.0 - ws * gs))
    ue = 1.5 * (1.0 - ws * gs) / torch.clamp(lm, min=ct.puny)
    # guard the resonance 1 - lm^2 mu^2 = 0
    safe_mu = lambda m: torch.where(torch.abs(1.0 - lm * lm * m * m) < 1e-6,
                                    m * (1.0 + 1e-3), m)
    mu0n_s = safe_mu(mu0n)
    extins = torch.clamp(torch.exp(-lm * ts), min=EXP_MIN)
    ne = ((ue + 1.0) ** 2 / extins) - ((ue - 1.0) ** 2 * extins)
    rdif_a = (ue ** 2 - 1.0) * (1.0 / extins - extins) / ne
    tdif_a = 4.0 * ue / ne
    trnlay = torch.clamp(torch.exp(-ts / mu0n_s), min=EXP_MIN)
    alp = _alpha(ws, mu0n_s, gs, lm)
    gam = _agamm(ws, mu0n_s, gs, lm)
    apg, amg = alp + gam, alp - gam
    rdir = apg * rdif_a + amg * (tdif_a * trnlay - 1.0)
    tdir = apg * tdif_a + (amg * rdif_a - apg + 1.0) * trnlay

    # gaussian re-integration of diffuse R/T (:3530-3560)
    R1, T1 = rdif_a, tdif_a
    swt = smr = smt = 0.0
    for mu_g, gwt in zip(GAUSPT, GAUSWT):
        mu_s = safe_mu(torch.full((), mu_g, dtype=ts.dtype, device=ts.device))
        trn = torch.clamp(torch.exp(-ts / mu_s), min=EXP_MIN)
        alp = _alpha(ws, mu_s, gs, lm)
        gam = _agamm(ws, mu_s, gs, lm)
        apg, amg = alp + gam, alp - gam
        rdr = apg * R1 + amg * T1 * trn - amg
        tdr = apg * T1 + amg * R1 * trn - apg * trn + trn
        swt = swt + mu_g * gwt
        smr = smr + mu_g * gwt * rdr
        smt = smt + mu_g * gwt * tdr
    rdif_a = smr / swt
    tdif_a = smt / swt
    return LayerProps(rdir=rdir, tdir=tdir, rdif_a=rdif_a, rdif_b=rdif_a,
                      tdif_a=tdif_a, tdif_b=tdif_a, trnlay=trnlay)


def _fresnel(p: LayerProps, mu0, mu0n_below) -> LayerProps:
    """Combine the Fresnel refraction interface onto the top of a layer
    (solution_dEdd :3565-3620)."""
    R1f = (mu0 - REFINDX * mu0n_below) / (mu0 + REFINDX * mu0n_below)
    R2f = (REFINDX * mu0 - mu0n_below) / (REFINDX * mu0 + mu0n_below)
    T1f = 2.0 * mu0 / (mu0 + REFINDX * mu0n_below)
    T2f = 2.0 * mu0 / (REFINDX * mu0 + mu0n_below)
    Rf_dir = 0.5 * (R1f * R1f + R2f * R2f)
    Tf_dir = 0.5 * (T1f * T1f + T2f * T2f) * REFINDX * mu0n_below / mu0
    Rf_dif_a, Tf_dif_a = CP063, 1.0 - CP063
    Rf_dif_b, Tf_dif_b = CP455, 1.0 - CP455
    rintfc = 1.0 / (1.0 - Rf_dif_b * p.rdif_a)
    return LayerProps(
        tdir=Tf_dir * p.tdir
        + Tf_dir * p.rdir * Rf_dif_b * rintfc * p.tdif_a,
        rdir=Rf_dir + Tf_dir * p.rdir * rintfc * Tf_dif_b,
        rdif_a=Rf_dif_a + Tf_dif_a * p.rdif_a * rintfc * Tf_dif_b,
        rdif_b=p.rdif_b + p.tdif_b * Rf_dif_b * rintfc * p.tdif_a,
        tdif_a=p.tdif_a * rintfc * Tf_dif_a,
        tdif_b=p.tdif_b * rintfc * Tf_dif_b,
        trnlay=Tf_dir * p.trnlay)


def _adding(props, albodr, albodf, shape_ref):
    """Downward/upward adding combination over the layer stack
    (solution_dEdd :3640-3680) with the TRMIN dark gate.

    props: list of klev+1 LayerProps (entries may be shared between
    layers); shape_ref fixes the (band, *B) shape. Returns 6 lists of
    length klev+2: (trndir, trntdr, trndif, rupdir, rupdif, rdndif)."""
    klev = len(props) - 1
    one = torch.ones_like(shape_ref)
    zero = torch.zeros_like(shape_ref)
    trndir, trntdr, trndif, rdndif = [one], [one], [one], [zero]
    masked = []
    for k, p in enumerate(props):
        lit = trntdr[k] > TRMIN
        p = LayerProps(*[torch.where(lit, x, 0.0) for x in p])
        masked.append(p)
        trndir.append(trndir[k] * p.trnlay)
        refkm1 = 1.0 / (1.0 - rdndif[k] * p.rdif_a)
        tdrrdir = trndir[k] * p.rdir
        tdndif = trntdr[k] - trndir[k]
        trntdr.append(trndir[k] * p.tdir
                      + (tdndif + tdrrdir * rdndif[k]) * refkm1 * p.tdif_a)
        rdndif.append(p.rdif_b + p.tdif_b * rdndif[k] * refkm1 * p.tdif_a)
        trndif.append(trndif[k] * refkm1 * p.tdif_a)

    rupdir = [None] * (klev + 2)
    rupdif = [None] * (klev + 2)
    rupdir[klev + 1] = albodr * one
    rupdif[klev + 1] = albodf * one
    for k in range(klev, -1, -1):
        p = masked[k]
        refkp1 = 1.0 / (1.0 - p.rdif_b * rupdif[k + 1])
        rupdir[k] = p.rdir + (p.trnlay * rupdir[k + 1]
                              + (p.tdir - p.trnlay) * rupdif[k + 1]) \
            * refkp1 * p.tdif_b
        rupdif[k] = p.rdif_a + p.tdif_a * rupdif[k + 1] * refkp1 * p.tdif_b
    return trndir, trntdr, trndif, rupdir, rupdif, rdndif


def _dedd_solution_cases(tau, w0, g, coszen, *, kfrsnl_cases,
                         albodr_cases, albodf_cases):
    """Case-batched adding method (solution_dEdd :3270-3580): a leading
    case axis C batches the (surface type, band) solutions; the per-case
    Fresnel layer index and ocean albedos are constant masks.
    tau/w0/g: (klev+1, C, *B). Returns 6 stacks (klev+2, C, *B). (The
    generic path of compute_dEdd; shortwave_dEdd computes each distinct
    layer once instead.)"""
    klev = tau.shape[0] - 1
    C = tau.shape[1]
    kw = dict(dtype=tau.dtype, device=tau.device)
    cshape = (C,) + (1,) * (tau.dim() - 2)
    mu0 = torch.broadcast_to(torch.clamp(coszen, min=0.01), tau.shape[1:])
    mu0n_below = torch.sqrt(1.0 - (1.0 - mu0 ** 2) / (REFINDX * REFINDX))
    kf = device_values(kfrsnl_cases, dtype=torch.int64,
                       device=tau.device).reshape(cshape)
    albodr = device_values(albodr_cases, **kw).reshape(cshape)
    albodf = device_values(albodf_cases, **kw).reshape(cshape)
    props = []
    for k in range(klev + 1):
        mu0n = torch.where(k >= kf, mu0n_below, mu0)
        p = _layer_props(tau[k], w0[k], g[k], mu0n)
        pf = _fresnel(p, mu0, mu0n_below)
        props.append(LayerProps(*[torch.where(k == kf, a, b)
                                  for a, b in zip(pf, p)]))
    return tuple(torch.stack(lst) for lst in _adding(props, albodr, albodf,
                                                      mu0))


def _net_fluxes(trndirA, trntdrA, trndifA, rupdirA, rupdifA, rdndifA):
    """Interface net down fluxes (:2880-2910), batched over cases."""
    refkA = 1.0 / (1.0 - rdndifA * rupdifA)
    dfdirA = (trndirA + (trntdrA - trndirA) * (1.0 - rupdifA) * refkA
              - trndirA * rupdirA * (1.0 - rdndifA) * refkA)
    dfdirA = torch.where(dfdirA < ct.puny, 0.0, dfdirA)
    dfdifA = trndifA * (1.0 - rupdifA) * refkA
    dfdifA = torch.where(dfdifA < ct.puny, 0.0, dfdifA)
    return dfdirA, dfdifA


class DEddFluxes(NamedTuple):
    avdr: torch.Tensor
    avdf: torch.Tensor
    aidr: torch.Tensor
    aidf: torch.Tensor
    fsfc: torch.Tensor
    fint: torch.Tensor
    fthru: torch.Tensor
    Sabs: torch.Tensor     # (nslyr, *B)
    Iabs: torch.Tensor     # (nilyr, *B)
    fthrul: torch.Tensor   # (nilyr+1, *B) penetrating SW at ice interfaces


def _build_bands(*, nilyr, nslyr, srftyp, fnidr, hs, rsnw, hi, hp,
                 R_ice, R_pnd, kalg):
    """Layer inherent optical properties for all 3 spectral bands of one
    surface type (the dzk/IOP setup of compute_dEdd :2034-2860).
    Returns (tau, w0, g) each (klev+1, NSPINT, *B)."""
    klev = nslyr + nilyr + 1
    kii = nslyr + 1
    full = lambda v: torch.full_like(hi, v)
    zero = torch.zeros_like(hi)
    iops = band_iops(R_ice, R_pnd)

    # layer thicknesses dzk
    dz_s = hs / nslyr
    dzk = [None] * (klev + 1)
    dzk[0] = torch.clamp(dz_s / 2.0, max=HS_SSL)
    dzk[1] = dz_s - dzk[0]
    for k in range(2, nslyr + 1):
        dzk[k] = dz_s
    dz_i = hi / nilyr
    dz_ssl = torch.minimum(torch.clamp(hi / 30.0, max=HI_SSL), dz_i / 2.0)
    dzk[kii] = dz_ssl
    dzk[kii + 1] = dz_i - dz_ssl
    for k in range(kii + 2, klev + 1):
        dzk[k] = dz_i
    if srftyp == 2:
        dz_p = hp / (nslyr + 1)
        for k in range(0, nslyr + 1):
            dzk[k] = dz_p

    fr_adj = 1.0 * fnidr + 0.8 * (1.0 - fnidr)    # snow grain factor

    band_tau, band_w0, band_g = [], [], []
    for ns in range(NSPINT):
        io = iops[ns]
        taus, w0s, gs = [], [], []
        # layers above the ice
        if srftyp == 0:
            for k in range(0, nslyr + 1):
                taus.append(zero)
                w0s.append(zero)
                gs.append(zero)
        elif srftyp == 1:
            frsnw = fr_adj * rsnw
            Qs = _interp_table(frsnw, RSNW_TAB, QS_TAB[:, ns])
            ws_t = _interp_table(frsnw, RSNW_TAB, WS_TAB[:, ns])
            gs_t = _interp_table(frsnw, RSNW_TAB, GS_TAB[:, ns])
            ks_coef = Qs * ((ct.rhos / 917.0) * 3.0
                            / (4.0 * frsnw * 1.0e-6))
            for k in range(0, nslyr + 1):
                taus.append(ks_coef * dzk[k])
                w0s.append(ws_t)
                gs.append(gs_t)
        else:   # pond water
            for k in range(0, nslyr + 1):
                taus.append(KW[ns] * dzk[k])
                w0s.append(zero)
                gs.append(zero)

        # sea ice layers
        if srftyp <= 1:
            taus.append(io["k_ssl"] * dzk[kii])
            w0s.append(full(io["w_ssl"]))
            gs.append(full(io["g_ssl"]))
            fs_dl = 0.25 * nilyr
            taus.append(io["k_dl"] * dzk[kii + 1] * fs_dl)
            w0s.append(full(io["w_dl"]))
            gs.append(full(io["g_dl"]))
            for k in range(kii + 2, klev):
                taus.append(io["k_int"] * dzk[k])
                w0s.append(full(io["w_int"]))
                gs.append(full(io["g_int"]))
            # lowest layer: algae absorption in the visible
            kabs = io["k_int"] * (1.0 - io["w_int"])
            sig = io["k_int"] * io["w_int"]
            if ns == 0:
                kabs = kabs + kalg * (0.50 / torch.clamp(dzk[klev],
                                                         min=ct.puny))
                w0s.append(sig / (sig + kabs))
            else:
                w0s.append(full(sig / (sig + kabs)))
            taus.append((kabs + sig) * dzk[klev])
            gs.append(full(io["g_int"]))
        else:   # ponded ice, with the thin-pond transition (:2800-2860)
            blend = torch.where((hp >= HPMIN) & (hp <= HP0), hp / HP0, 1.0)
            sig_i = io["k_ssl"] * io["w_ssl"]
            sig_p = io["k_pssl"] * io["w_pssl"]
            sig = sig_i + (sig_p - sig_i) * blend
            kext = sig + io["k_pssl"] * (1.0 - io["w_pssl"])
            taus.append(kext * dzk[kii])
            w0s.append(sig / kext)
            gs.append(full(io["g_pint"]))
            fs_dl = 0.25 * nilyr
            sig_i = io["k_dl"] * io["w_dl"] * fs_dl
            sig_p = io["k_pint"] * io["w_pint"]
            sig = sig_i + (sig_p - sig_i) * blend
            kext = sig + io["k_pint"] * (1.0 - io["w_pint"])
            taus.append(kext * dzk[kii + 1])
            w0s.append(sig / kext)
            gs.append(full(io["g_pint"]))
            for k in range(kii + 2, klev + 1):
                sig_i = io["k_int"] * io["w_int"]
                sig_p = io["k_pint"] * io["w_pint"]
                sig = sig_i + (sig_p - sig_i) * blend
                kext = sig + io["k_pint"] * (1.0 - io["w_pint"])
                taus.append(kext * dzk[k])
                w0s.append(sig / kext)
                gs.append(full(io["g_pint"]))

        shape = tuple(hi.shape)
        band_tau.append(torch.stack([t.broadcast_to(shape) for t in taus]))
        band_w0.append(torch.stack([w.broadcast_to(shape) for w in w0s]))
        band_g.append(torch.stack([x.broadcast_to(shape) for x in gs]))

    return (torch.stack(band_tau, dim=1), torch.stack(band_w0, dim=1),
            torch.stack(band_g, dim=1))


def _net_k(sol, k):
    """Net downward direct/diffuse flux factors at interface k
    (compute_dEdd :2880-2910)."""
    trndir, trntdr, trndif, rupdir, rupdif, rdndif = sol
    refk = 1.0 / (1.0 - rdndif[k] * rupdif[k])
    dfdir = trndir[k] + (trntdr[k] - trndir[k]) * (1.0 - rupdif[k]) * refk \
        - trndir[k] * rupdir[k] * (1.0 - rdndif[k]) * refk
    dfdir = torch.where(dfdir < ct.puny, 0.0, dfdir)
    dfdif = trndif[k] * (1.0 - rupdif[k]) * refk
    dfdif = torch.where(dfdif < ct.puny, 0.0, dfdif)
    return dfdir, dfdif


def _partition_sol(*, nilyr, nslyr, srftyp, fnidr, swvdr, swvdf, swidr,
                   swidf, sol) -> DEddFluxes:
    """Flux partition into surface/internal/penetrating absorption
    (compute_dEdd :2860-3050) from the adding solution lists (entries
    (NSPINT, *B)): every output is a difference of the band-weighted total
    net downward flux at two interfaces."""
    klev = nslyr + nilyr + 1
    ksrf = 1 if srftyp == 1 else nslyr + 2
    wghtns2 = 0.67 + (0.78 - 0.67) * (1.0 - fnidr)
    wghtns3 = 1.0 - wghtns2
    rupdirL, rupdifL = sol[3], sol[4]

    avdr = rupdirL[0][0]
    avdf = rupdifL[0][0]
    aidr = rupdirL[0][1] * wghtns2 + rupdirL[0][2] * wghtns3
    aidf = rupdifL[0][1] * wghtns2 + rupdifL[0][2] * wghtns3

    # net_tot[k]: band-weighted total net downward flux at interface k;
    # net_vs[k]: its visible part (for fswpenl)
    net_tot = [None] * (klev + 2)
    net_vs = [None] * (klev + 2)
    for k in range(klev + 2):
        dfdir, dfdif = _net_k(sol, k)
        net_vs[k] = dfdir[0] * swvdr + dfdif[0] * swvdf
        nir = (wghtns2 * dfdir[1] + wghtns3 * dfdir[2]) * swidr \
            + (wghtns2 * dfdif[1] + wghtns3 * dfdif[2]) * swidf
        net_tot[k] = net_vs[k] + nir

    fsfc = net_tot[0] - net_tot[ksrf]
    fint = net_tot[ksrf] - net_tot[klev + 1]
    fthru = net_tot[klev + 1]
    if srftyp == 1:
        Sabs = torch.stack([net_tot[k] - net_tot[k + 1]
                            for k in range(1, nslyr + 1)])
    else:
        Sabs = torch.zeros((nslyr,) + tuple(fsfc.shape), dtype=fsfc.dtype,
                           device=fsfc.device)
    iabs = []
    for k in range(nslyr + 2, nslyr + 2 + nilyr):
        km, kp = k, k + 1
        if srftyp == 1 and k == nslyr + 2:
            km, kp = k - 1, k + 1
        iabs.append(net_tot[km] - net_tot[kp])
    fthrul = torch.stack([net_vs[k] for k in range(nslyr + 2, klev + 2)])
    return DEddFluxes(avdr=avdr, avdf=avdf, aidr=aidr, aidf=aidf,
                      fsfc=fsfc, fint=fint, fthru=fthru, Sabs=Sabs,
                      Iabs=torch.stack(iabs), fthrul=fthrul)


def _partition(*, nilyr, nslyr, srftyp, fnidr, swvdr, swvdf, swidr, swidf,
               dfdirA, dfdifA, rupdirA, rupdifA) -> DEddFluxes:
    """Per-band flux partition into surface/internal/penetrating
    absorption (compute_dEdd :2860-3050). dfdirA etc: (klev+2, NSPINT, *B)
    for one surface type."""
    klev = nslyr + nilyr + 1
    ksrf = 1 if srftyp == 1 else nslyr + 2
    wghtns2 = 0.67 + (0.78 - 0.67) * (1.0 - fnidr)
    wghtns3 = 1.0 - wghtns2
    B = tuple(dfdirA.shape[2:])
    kw = dict(dtype=dfdirA.dtype, device=dfdirA.device)
    aidr = aidf = fsfc = fint = fthru = torch.zeros(B, **kw)
    Sabs = [torch.zeros(B, **kw) for _ in range(nslyr)]
    Iabs = [torch.zeros(B, **kw) for _ in range(nilyr)]
    fthrul = [None] * (nilyr + 1)
    for ns in range(NSPINT):
        dfdir, dfdif = dfdirA[:, ns], dfdifA[:, ns]
        rupdir, rupdif = rupdirA[:, ns], rupdifA[:, ns]
        if ns == 0:
            swdr, swdf, wght = swvdr, swvdf, 1.0
            avdr, avdf = rupdir[0], rupdif[0]
        else:
            swdr, swdf = swidr, swidf
            wght = wghtns2 if ns == 1 else wghtns3
            aidr = aidr + rupdir[0] * wght
            aidf = aidf + rupdif[0] * wght
        net = lambda k: dfdir[k] * swdr + dfdif[k] * swdf
        tmp0 = net(0) * wght
        tmpks = net(ksrf) * wght
        tmpkl = net(klev + 1) * wght
        fsfc = fsfc + tmp0 - tmpks
        fint = fint + tmpks - tmpkl
        fthru = fthru + tmpkl
        if srftyp == 1:
            for k in range(1, nslyr + 1):
                Sabs[k - 1] = Sabs[k - 1] + (net(k) - net(k + 1)) * wght
        for k in range(nslyr + 2, nslyr + 2 + nilyr):
            km, kp = k, k + 1
            if srftyp == 1 and k == nslyr + 2:
                km, kp = k - 1, k + 1
            Iabs[k - nslyr - 2] = Iabs[k - nslyr - 2] \
                + (net(km) - net(kp)) * wght
        if ns == 0:
            for k in range(nslyr + 2, klev + 2):
                fthrul[k - nslyr - 2] = net(k)
    return DEddFluxes(avdr=avdr, avdf=avdf, aidr=aidr, aidf=aidf,
                      fsfc=fsfc, fint=fint, fthru=fthru,
                      Sabs=torch.stack(Sabs), Iabs=torch.stack(Iabs),
                      fthrul=torch.stack(fthrul))


def compute_dEdd(*, nilyr, nslyr, srftyp, coszen, fnidr, swvdr, swvdf,
                 swidr, swidf, hs, rsnw, hi, hp, R_ice=0.0, R_pnd=0.0,
                 kalg=0.6) -> DEddFluxes:
    """Layer optical properties + band-batched adding solution + flux
    partition for one surface type over all cells (compute_dEdd
    :2034-3050): the generic, one-surface-at-a-time path."""
    tau, w0, g = _build_bands(
        nilyr=nilyr, nslyr=nslyr, srftyp=srftyp, fnidr=fnidr, hs=hs,
        rsnw=rsnw, hi=hi, hp=hp, R_ice=R_ice, R_pnd=R_pnd, kalg=kalg)
    kf = 0 if srftyp == 2 else nslyr + 2
    sol = _dedd_solution_cases(
        tau, w0, g, coszen, kfrsnl_cases=(kf,) * NSPINT,
        albodr_cases=(0.01, 0.0, 0.0), albodf_cases=(0.01, 0.0, 0.0))
    dfdirA, dfdifA = _net_fluxes(*sol)
    return _partition(
        nilyr=nilyr, nslyr=nslyr, srftyp=srftyp, fnidr=fnidr, swvdr=swvdr,
        swvdf=swvdf, swidr=swidr, swidf=swidf, dfdirA=dfdirA, dfdifA=dfdifA,
        rupdirA=sol[3], rupdifA=sol[4])


class DEddResult(NamedTuple):
    alvdrn: torch.Tensor
    alvdfn: torch.Tensor
    alidrn: torch.Tensor
    alidfn: torch.Tensor
    fswsfcn: torch.Tensor
    fswintn: torch.Tensor
    fswthrun: torch.Tensor
    Sswabsn: torch.Tensor
    Iswabsn: torch.Tensor
    fswpenln: torch.Tensor
    albicen: torch.Tensor
    albsnon: torch.Tensor
    albpndn: torch.Tensor
    snowfracn: torch.Tensor   # category snow fraction used in radiation


def pond_setup(fp, hp, hs, *, pond_scheme, hs0, hs1, pndaspect):
    """Radiative pond fraction/depth with snow on the ponds (run_dEdd
    :1385-1412 cesm taper, :1478-1510 level ponds; topo ponds pass
    through)."""
    if pond_scheme == "lvl":
        # taper pond area with snow on pond ice (:1483-1487)
        if hs1 > ct.puny:
            asnow = torch.clamp(hs / hs1, max=1.0)
            fp = torch.where(hs >= ct.puny, (1.0 - asnow) * fp, fp)
        # infiltrate snow / saturate shallow ponds (:1489-1507)
        haspnd = hp > ct.puny
        rp = ct.rhofresh * hp / torch.clamp(ct.rhofresh * hp + ct.rhos * hs,
                                            min=ct.puny)
        hmx = hs * (ct.rhofresh - ct.rhos) / ct.rhofresh
        deep = hp >= hmx
        hp_sat = (ct.rhofresh * hp + ct.rhos * hs) / ct.rhofresh
        drown = haspnd & (rp >= 0.15) & deep
        fp = torch.where(haspnd, torch.where(drown, fp, 0.0), fp)
        hp = torch.where(haspnd, torch.where(drown, hp_sat, 0.0), hp)
        fp = torch.where(hp < HPMIN, 0.0, fp)
    elif pond_scheme != "topo":
        asnow = torch.clamp(hs / max(hs0, 1e-6), max=1.0)
        infl = hs >= ct.hs_min
        fp = torch.where(infl, (1.0 - asnow) * fp, fp)
        hp = torch.where(infl, pndaspect * fp, hp)
        fp = torch.where(hp < HPMIN, 0.0, fp)
    return fp, hp


def shortwave_dEdd(*, nilyr, nslyr, aicen, vicen, vsnon, Tsfcn, apnd, hpnd,
                   coszen, fnidr, swvdr, swvdf, swidr, swidf,
                   R_ice=0.0, R_pnd=0.0, R_snw=1.5, dT_mlt=1.5,
                   rsnw_mlt=1500.0, kalg=0.6, hs0=0.03, hs1=0.03,
                   pndaspect=0.8, pond_scheme="cesm") -> DEddResult:
    """Full delta-Eddington radiation over batch *B (shortwave_dEdd :1607
    + the pond/snow property setup of run_dEdd); forcing planes broadcast
    against the category fields. Layer outputs are layer-first:
    Sswabsn (nslyr, *B), Iswabsn (nilyr, *B), fswpenln (nilyr+1, *B).

    apnd: pond fraction of ice area; hpnd: pond depth. Cells that are not
    lit (aicen, net SW and coszen above puny) get exact zeros."""
    mask = aicen > ct.puny
    netsw = swvdr + swvdf + swidr + swidf
    lit = mask & (netsw > ct.puny) & (coszen > ct.puny)
    cz = torch.clamp(coszen, min=ct.puny)

    hi = torch.where(mask, vicen / torch.clamp(aicen, min=ct.puny), 0.0)
    fs, hs, rsnw = set_snow(aicen, vsnon, Tsfcn, R_snw=R_snw,
                            rsnw_mlt=rsnw_mlt, dT_mlt=dT_mlt, hs0=hs0)
    fp, hp = pond_setup(apnd, hpnd, hs, pond_scheme=pond_scheme, hs0=hs0,
                        hs1=hs1, pndaspect=pndaspect)
    fp = torch.minimum(fp, 1.0 - fs)
    fi = torch.clamp(1.0 - fs - fp, min=0.0)

    # broadcast the forcing planes to the batch once
    B = tuple(torch.broadcast_shapes(hi.shape, cz.shape))
    hi, hs, hp, rsnw, fs, fp, fi, lit = (torch.broadcast_to(x, B) for x in
                                         (hi, hs, hp, rsnw, fs, fp, fi, lit))
    cz, fnidr = torch.broadcast_to(cz, B), torch.broadcast_to(fnidr, B)

    # Layers computed once where they repeat: bare and snow share all ice
    # layers (same optical properties, Fresnel level kf = nslyr+2), the
    # interior ice layers are identical, the pond's sub-ice layers are
    # identical, and the bare surface's top layers are exactly clear.
    klev = nslyr + nilyr + 1
    kii = nslyr + 1
    build = dict(nilyr=nilyr, nslyr=nslyr, fnidr=fnidr,
                 hi=torch.clamp(hi, min=ct.puny), hp=hp, rsnw=rsnw,
                 R_ice=R_ice, R_pnd=R_pnd, kalg=kalg)
    tau0, w00, g0 = _build_bands(srftyp=0, hs=torch.zeros_like(hs), **build)
    tau1, w01, g1 = _build_bands(srftyp=1, hs=torch.clamp(hs, min=ct.hs_min),
                                 **build)
    tau2, w02, g2 = _build_bands(srftyp=2, hs=torch.zeros_like(hs), **build)

    mu0 = torch.clamp(cz, min=0.01)
    mu0n_below = torch.sqrt(1.0 - (1.0 - mu0 ** 2) / (REFINDX * REFINDX))

    pIceSSL = _layer_props(tau0[kii], w00[kii], g0[kii], mu0)
    pIceDL = _fresnel(_layer_props(tau0[kii + 1], w00[kii + 1], g0[kii + 1],
                                   mu0n_below), mu0, mu0n_below)
    n_int = klev - kii - 2                       # kii+2 .. klev-1
    ice_props = [pIceSSL, pIceDL]
    if n_int > 0:
        pIceInt = _layer_props(tau0[kii + 2], w00[kii + 2], g0[kii + 2],
                               mu0n_below)
        ice_props += [pIceInt] * n_int
    ice_props.append(_layer_props(tau0[klev], w00[klev], g0[klev],
                                  mu0n_below))

    kw = dict(dtype=cz.dtype, device=cz.device)
    o, z0 = torch.ones((), **kw), torch.zeros((), **kw)
    clear = LayerProps(rdir=z0, tdir=o, rdif_a=z0, rdif_b=z0, tdif_a=o,
                       tdif_b=o, trnlay=o)
    props_bare = [clear] * (nslyr + 1) + ice_props

    snow_top = [_layer_props(tau1[0], w01[0], g1[0], mu0),
                _layer_props(tau1[1], w01[1], g1[1], mu0)]
    if nslyr > 1:
        snow_top += [_layer_props(tau1[2], w01[2], g1[2], mu0)] * (nslyr - 1)
    props_snow = snow_top + ice_props

    # pond: Fresnel at the very top (kf=0), identical water layers and
    # identical sub-ice layers
    pPw = _layer_props(tau2[1], w02[1], g2[1], mu0n_below)
    n_pint = klev - kii - 1                      # kii+2 .. klev
    props_pond = [_fresnel(pPw, mu0, mu0n_below)] + [pPw] * nslyr \
        + [_layer_props(tau2[kii], w02[kii], g2[kii], mu0n_below),
           _layer_props(tau2[kii + 1], w02[kii + 1], g2[kii + 1],
                        mu0n_below)] \
        + [_layer_props(tau2[kii + 2], w02[kii + 2], g2[kii + 2],
                        mu0n_below)] * n_pint

    # open-ocean albedo under the ice: 0.01 visible, 0 near-IR
    shape_ref = torch.zeros((NSPINT,) + B, **kw)
    albo = device_values((0.01, 0.0, 0.0), **kw).reshape(
        (NSPINT,) + (1,) * len(B))
    part = dict(nilyr=nilyr, nslyr=nslyr, fnidr=fnidr, swvdr=swvdr,
                swvdf=swvdf, swidr=swidr, swidf=swidf)
    r_bare, r_snow, r_pond = (
        _partition_sol(srftyp=srf, sol=_adding(props, albo, albo, shape_ref),
                       **part)
        for srf, props in ((0, props_bare), (1, props_snow),
                           (2, props_pond)))

    def mix(name, k=False):
        f = (lambda x: x[None]) if k else (lambda x: x)
        return (getattr(r_bare, name) * f(fi) + getattr(r_snow, name) * f(fs)
                + getattr(r_pond, name) * f(fp))

    L, Lk = lit, lit[None]
    broadband = lambda r: (ct.awtvdr * r.avdr + ct.awtidr * r.aidr
                           + ct.awtvdf * r.avdf + ct.awtidf * r.aidf)
    return DEddResult(
        alvdrn=torch.where(L, mix("avdr"), 0.0),
        alvdfn=torch.where(L, mix("avdf"), 0.0),
        alidrn=torch.where(L, mix("aidr"), 0.0),
        alidfn=torch.where(L, mix("aidf"), 0.0),
        fswsfcn=torch.where(L, mix("fsfc"), 0.0),
        fswintn=torch.where(L, mix("fint"), 0.0),
        fswthrun=torch.where(L, mix("fthru"), 0.0),
        Sswabsn=torch.where(Lk, r_snow.Sabs * fs[None], 0.0),
        Iswabsn=torch.where(Lk, mix("Iabs", True), 0.0),
        fswpenln=torch.where(Lk, mix("fthrul", True), 0.0),
        albicen=torch.where(L, broadband(r_bare), 0.0),
        albsnon=torch.where(L, broadband(r_snow), 0.0),
        albpndn=torch.where(L, broadband(r_pond), 0.0),
        snowfracn=torch.where(L, fs, 0.0))


def shortwave_dEdd_plain(*, aicen, vicen, vsnon, Tsfcn, apnd, hpnd, coszen,
                         fnidr, swvdr, swvdf, swidr, swidf, **kw
                         ) -> DEddResult:
    """All categories at once in plain PyTorch: aicen..hpnd (ncat, ny, nx),
    the forcing planes (ny, nx). Returns DEddResult with the category axis
    first (Sswabsn (ncat, nslyr, ny, nx), ...), the layout of the JAX
    package's vmapped ``shortwave_dEdd`` and of the CUDA kernel."""
    r = shortwave_dEdd(aicen=aicen, vicen=vicen, vsnon=vsnon, Tsfcn=Tsfcn,
                       apnd=apnd, hpnd=hpnd, coszen=coszen, fnidr=fnidr,
                       swvdr=swvdr, swvdf=swvdf, swidr=swidr, swidf=swidf,
                       **kw)
    return r._replace(Sswabsn=r.Sswabsn.movedim(0, 1),
                      Iswabsn=r.Iswabsn.movedim(0, 1),
                      fswpenln=r.fswpenln.movedim(0, 1))


def shortwave_dEdd_ncat(**kw) -> DEddResult:
    """The reference's delta-Eddington: ``shortwave_dEdd_plain`` on
    whatever device the tensors are on."""
    return shortwave_dEdd_plain(**kw)
