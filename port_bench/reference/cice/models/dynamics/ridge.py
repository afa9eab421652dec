"""Mechanical redistribution (ridging), PyTorch port of
``cice5_tpu/models/dynamics/ridge.py``.

ice_mechred.F90: ridge_ice (:101, iterate until the area is conserved),
asum_ridging (:758), ridge_prep (:820), ridge_itd (:936, participation +
ridge-ITD functions), ridge_shift (:1303), ridge_check (:2040). The donor
(n) x receiver (nr) loops are a static ncat x ncat double loop of
vectorized ops; the outer iteration (``ops/loop.py``) ends when every
cell's area is conserved or after NITERMAX passes. The topo-pond water
of the ridged area drains to the ocean (``dfpond``, ice_mechred.F90:
1713-1717), so does the aerosol of the snow that ridging does not keep
(``faero_ocn``, :1704-1711) and the skeletal-BGC amount that the area
reduction crushes out (``dflux_bio``, the JAX package's conservation
completion); ``cat_diags`` returns the per-category mechred diagnostics.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference.cice import constants as ct
from reference.cice.models.thermo.itd import compute_tracers, tracer_weights
from reference.cice.models.tracers.brine import PHI_SK
from reference.cice.ops.loop import while_loop
from reference.cice.state import (DEP_AICE, DEP_TRCR, DEP_VICE,
                                   TracerRegistry)

# ridging parameters (ice_mechred.F90:66-84)
CS = 0.25          # fraction of shear energy contributing to ridging
FSNOWRDG = 0.5     # snow fraction that survives ridging
GSTAR = 0.15       # max G(h) participating (krdg_partic=0)
ASTAR = 0.05       # e-folding scale (krdg_partic=1)
MAXRAFT = 1.0      # max thickness of rafting ice (m)
HSTAR = 25.0       # mean ridge thickness parameter (krdg_redist=0)
NITERMAX = 20


class RidgeITD(NamedTuple):
    aksum: torch.Tensor      # (*B)
    apartic0: torch.Tensor   # (*B) open-water participation
    apartic: torch.Tensor    # (ncat, *B)
    hrmin: torch.Tensor
    hrmax: torch.Tensor
    hrexp: torch.Tensor
    krdg: torch.Tensor


def ridge_itd(aicen, vicen, aice0, *, krdg_partic=1, krdg_redist=1,
              mu_rdg=4.0) -> RidgeITD:
    """Participation and ridge-ITD functions (ice_mechred.F90:936-1290)."""
    a0 = torch.where(aice0 > ct.puny, aice0, 0.0)
    an = torch.where(aicen > ct.puny, aicen, 0.0)
    csum = torch.cat([a0[None], a0[None] + torch.cumsum(an, dim=0)], dim=0)
    total = torch.clamp(csum[-1], min=ct.puny)
    G = csum / total                                   # G(0..ncat)
    Gm1 = torch.cat([torch.zeros_like(G[:1]), G[:-1]], dim=0)

    if krdg_partic == 0:
        Gstari = 1.0 / GSTAR
        full = G < GSTAR
        partial = (~full) & (Gm1 < GSTAR)
        ap = torch.where(full,
                         Gstari * (G - Gm1) * (2.0 - (Gm1 + G) * Gstari),
                         torch.where(partial,
                                     Gstari * (GSTAR - Gm1)
                                     * (2.0 - (Gm1 + GSTAR) * Gstari), 0.0))
    else:
        astari = 1.0 / ASTAR
        xtmp = 1.0 / (1.0 - math.exp(-astari))
        eG = torch.exp(-G * astari) * xtmp
        eGm1 = torch.cat([torch.full_like(eG[:1], xtmp), eG[:-1]], dim=0)
        ap = eGm1 - eG
    apartic0 = ap[0]
    apartic = ap[1:]

    hi = torch.where(an > ct.puny, vicen / torch.clamp(an, min=ct.puny), 0.0)
    hi = torch.clamp(hi, min=ct.puny)
    has = an > ct.puny
    hrmin = torch.where(has, torch.minimum(2.0 * hi, hi + MAXRAFT), 0.0)
    if krdg_redist == 0:
        hrmax = torch.where(has, torch.maximum(2.0 * torch.sqrt(HSTAR * hi),
                                               hrmin + ct.puny), 0.0)
        krdg = torch.where(has, 0.5 * (hrmin + hrmax) / hi, 1.0)
        hrexp = torch.zeros_like(hrmin)
    else:
        hrexp = torch.where(has, mu_rdg * torch.sqrt(hi), 0.0)
        krdg = torch.where(has, (hrmin + hrexp) / hi, 1.0)
        hrmax = torch.zeros_like(hrmin)

    aksum = apartic0 + (apartic * (1.0 - 1.0 / krdg)).sum(0)
    return RidgeITD(aksum=aksum, apartic0=apartic0, apartic=apartic,
                    hrmin=hrmin, hrmax=hrmax, hrexp=hrexp, krdg=krdg)


class RidgeResult(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    trcrn: torch.Tensor
    aice0: torch.Tensor
    dardg1dt: torch.Tensor
    dardg2dt: torch.Tensor
    dvirdgdt: torch.Tensor
    opening: torch.Tensor
    fresh: torch.Tensor      # snow mass melted into the ocean (kg/m^2/s)
    fhocn: torch.Tensor      # heat flux to melt that snow (W/m^2)
    asum_err: torch.Tensor   # |asum - 1| after the final iteration
    niter: torch.Tensor      # iterations taken (0-d int64; normally 1-2)
    dfpond: torch.Tensor     # topo-pond water lost with ridged area (m)
    faero_ocn: torch.Tensor  # (n_aero, *B) aerosol of the snow that
    # ridging does not keep, to the ocean (kg/m^2/s)
    dflux_bio: torch.Tensor  # (nbtrcr, *B) skeletal-BGC amount crushed
    # out by the area reduction, to the ocean (mmol/m^2/s)
    catdiag: torch.Tensor    # per-category mechred diagnostics (9, ncat,
    # *B) in driver.step.RDGN_KEYS order when cat_diags, else (0, ncat,
    # *B): dardg1ndt, dardg2ndt, dvirdgndt (rates), araftn, vraftn,
    # aparticn, krdgn, aredistn, vredistn (ice_history_mechred.F90)


def _chain_root_and_parents(tr: TracerRegistry, it):
    parents = []
    q = it
    while tr.depend[q] >= DEP_TRCR:
        q = tr.depend[q] - DEP_TRCR
        parents.append(q)
    return tr.depend[q], parents


def ridge_ice(dt, tr: TracerRegistry, hin_max, nilyr, nslyr, *, aicen,
              vicen, vsnon, trcrn, aice0, rdg_conv, rdg_shear,
              krdg_partic=1, krdg_redist=1, mu_rdg=4.0,
              ndtd=1, tr_pond_topo=False, cat_diags=False) -> RidgeResult:
    """Full ridging driver (ice_mechred.F90:101-757 ridge_ice), in
    conserved-amount space: amounts are built once, transferred by every
    iteration, and turned back into tracer values once at the end."""
    ncat = aicen.shape[0]
    B = tuple(aicen.shape[1:])
    kw = dict(dtype=aicen.dtype, device=aicen.device)

    # receiver dependency class of every slot (its amount follows the
    # ridged area "A", volume "V" or snow "S"); level-ice and pond tracers
    # are lost in ridging (ice_mechred.F90 ridge_shift): None
    share = []
    for it in range(tr.ntrcr):
        root, parents = _chain_root_and_parents(tr, it)
        if (tr.nt_alvl in parents or tr.nt_apnd in parents
                or it == tr.nt_alvl or it == tr.nt_vlvl):
            share.append(None)
        else:
            share.append({DEP_AICE: "A", DEP_VICE: "V"}.get(root, "S"))
    hmax = [float(h) for h in hin_max]
    hmax[ncat] = 1.0e8          # ridge_prep: all ridged ice thinner than top

    asum = aice0 + aicen.sum(0)
    closing_net = CS * rdg_shear + rdg_conv
    divu_adv = (1.0 - asum) / dt
    closing_net = torch.where(divu_adv < 0.0,
                              torch.maximum(closing_net, -divu_adv),
                              closing_net)
    opning = closing_net + divu_adv

    z = torch.zeros(B, **kw)
    c = dict(niter=torch.zeros((), dtype=torch.int64, device=aicen.device),
             aicen=aicen, vicen=vicen, vsnon=vsnon,
             atrcrn=tracer_weights(tr, aicen, vicen, vsnon, trcrn) * trcrn,
             aice0=aice0, closing_net=closing_net, opning=opning,
             done=torch.zeros(B, dtype=torch.bool, device=aicen.device),
             ardg1=z, ardg2=z, virdg=z, aopen=z, msnow_mlt=z, esnow_mlt=z,
             mpond=z, maero=torch.zeros((tr.n_aero,) + B, **kw),
             mbio=torch.zeros((tr.nbtrcr,) + B, **kw),
             catdiag=torch.zeros(((9 if cat_diags else 0), ncat) + B, **kw))
    a0, na = tr.nt_aero, tr.n_aero
    pond_slot = tr.nt_hpnd if tr_pond_topo and tr.nt_hpnd >= 0 else None
    qs0, qs1 = tr.nt_qsno, tr.nt_qsno + nslyr
    eps_sum = 8.0 * torch.finfo(aicen.dtype).eps

    def pending(c):
        return (c["niter"] < NITERMAX) & (~c["done"]).any()

    def body(c, go):
        """One ridging pass (ops/loop.py): the cells whose area is not yet
        conserved ridge, and none when ``go`` is False."""
        active = ~c["done"] & go
        aicen, vicen, vsnon, atrcrn = (c["aicen"], c["vicen"], c["vsnon"],
                                       c["atrcrn"])
        aice0 = c["aice0"]
        r = ridge_itd(aicen, vicen, aice0, krdg_partic=krdg_partic,
                      krdg_redist=krdg_redist, mu_rdg=mu_rdg)

        # gross closing, limited by open water / category availability
        closing_gross = c["closing_net"] / torch.clamp(r.aksum, min=ct.puny)
        opn = c["opning"]
        wk = r.apartic0 * closing_gross * dt
        fac = torch.where((r.apartic0 > 0.0) & (wk > aice0),
                          aice0 / torch.clamp(wk, min=ct.puny), 1.0)
        closing_gross = closing_gross * fac
        opn = opn * fac
        for n in range(ncat):
            wk = r.apartic[n] * closing_gross * dt
            lim = (aicen[n] > ct.puny) & (r.apartic[n] > 0.0) \
                & (wk > aicen[n])
            fac = torch.where(lim, aicen[n] / torch.clamp(wk, min=ct.puny),
                              1.0)
            closing_gross = closing_gross * fac
            opn = opn * fac
        closing_gross = torch.where(active, closing_gross, 0.0)
        opn = torch.where(active, opn, 0.0)

        aice0 = torch.clamp(
            aice0 - r.apartic0 * closing_gross * dt + opn * dt, min=0.0)
        aopen = c["aopen"] + opn * dt
        a_init, v_init, s_init = aicen, vicen, vsnon
        ardg1_d, ardg2_d, virdg_d = c["ardg1"], c["ardg2"], c["virdg"]
        msnow, esnow, mpond = c["msnow_mlt"], c["esnow_mlt"], c["mpond"]
        maero, mbio = c["maero"], c["mbio"]

        d_aicen = [None] * ncat
        d_vicen = [None] * ncat
        d_vsnon = [None] * ncat
        d_atrcr = [None] * ncat

        def acc(lst, i, val):
            lst[i] = val if lst[i] is None else lst[i] + val

        if cat_diags:
            # per-donor ridged amounts, rafting, and redistribution into
            # each receiver (ice_mechred.F90:671, :1227)
            cd = {k: [None] * ncat for k in ("ardg1", "ardg2", "virdg",
                                             "araft", "vraft", "reda",
                                             "redv")}

        for n in range(ncat):
            ridging = ((a_init[n] > ct.puny) & (r.apartic[n] > 0.0)
                       & (closing_gross > 0.0))
            ardg1n = torch.where(
                ridging, torch.minimum(r.apartic[n] * closing_gross * dt,
                                       a_init[n]), 0.0)
            ardg2n = ardg1n / torch.clamp(r.krdg[n], min=ct.puny)
            afrac = ardg1n / torch.clamp(a_init[n], min=ct.puny)
            virdgn = v_init[n] * afrac
            vsrdgn = s_init[n] * afrac

            acc(d_aicen, n, -ardg1n)
            acc(d_vicen, n, -virdgn)
            acc(d_vsnon, n, -vsrdgn)
            ardg1_d = ardg1_d + ardg1n
            ardg2_d = ardg2_d + ardg2n
            virdg_d = virdg_d + virdgn
            msnow = msnow + ct.rhos * vsrdgn * (1.0 - FSNOWRDG)
            esnow = esnow + (1.0 - FSNOWRDG) / nslyr * afrac \
                * atrcrn[n, qs0:qs1].sum(0)
            if na:
                # the aerosol of the snow that ridging does not keep:
                # vsrdgn*(1-fsnowrdg)*conc = afrac*(1-FSNOWRDG)*amount
                # (ice_mechred.F90:1704-1711)
                sno_amt = torch.stack([atrcrn[n, a0 + 4 * it]
                                       + atrcrn[n, a0 + 4 * it + 1]
                                       for it in range(na)])
                maero = maero + (1.0 - FSNOWRDG) * afrac[None] * sno_amt
            if tr.nbtrcr:
                # BGC: the donor loses afrac*amount; the receivers' gains
                # are taken off below, leaving the area-crush loss
                bio_amt = torch.stack([atrcrn[n, s] for s in tr.nt_bgc])
                mbio = mbio + afrac[None] * bio_amt

            if cat_diags:
                # rafting where hrmin takes the 2h branch (hi <= maxraft)
                hi_n = torch.where(a_init[n] > ct.puny,
                                   v_init[n] / torch.clamp(a_init[n],
                                                           min=ct.puny), 0.0)
                mraft = (hi_n <= MAXRAFT).to(hi_n.dtype)
                for k, val in (("ardg1", ardg1n), ("ardg2", ardg2n),
                               ("virdg", virdgn), ("araft", mraft * ardg2n),
                               ("vraft", mraft * virdgn)):
                    cd[k][n] = val

            # donor side: a fraction afrac of every amount leaves
            acc(d_atrcr, n, (-afrac)[None] * atrcrn[n])
            if pond_slot is not None:
                # ridged topo-pond water drains: afrac * aicen*apnd*hpnd
                mpond = mpond + afrac * atrcrn[n, pond_slot]

            # receiver-side redistribution
            dhr = torch.clamp(r.hrmax[n] - r.hrmin[n], min=ct.puny)
            dhr2 = torch.clamp(r.hrmax[n] ** 2 - r.hrmin[n] ** 2,
                               min=ct.puny)
            for nr in range(ncat):
                if krdg_redist == 0:
                    out = (r.hrmin[n] >= hmax[nr + 1]) | \
                        (r.hrmax[n] <= hmax[nr])
                    hL = torch.clamp(r.hrmin[n], min=hmax[nr])
                    hR = torch.clamp(r.hrmax[n], max=hmax[nr + 1])
                    hL = torch.where(out, 0.0, hL)
                    hR = torch.where(out, 0.0, hR)
                    farea = (hR - hL) / dhr
                    fvol = (hR * hR - hL * hL) / dhr2
                else:
                    hi1 = r.hrmin[n]
                    hexp = torch.clamp(r.hrexp[n], min=ct.puny)
                    if nr < ncat - 1:
                        out = hi1 >= hmax[nr + 1]
                        hL = torch.clamp(hi1, min=hmax[nr])
                        hR = hmax[nr + 1]
                        expL = torch.exp(-(hL - hi1) / hexp)
                        expR = torch.exp(-(hR - hi1) / hexp)
                        farea = torch.where(out, 0.0, expL - expR)
                        fvol = torch.where(
                            out, 0.0,
                            ((hL + hexp) * expL - (hR + hexp) * expR)
                            / (hi1 + hexp))
                    else:
                        hL = torch.clamp(hi1, min=hmax[nr])
                        expL = torch.exp(-(hL - hi1) / hexp)
                        farea = expL
                        fvol = (hL + hexp) * expL / (hi1 + hexp)

                acc(d_aicen, nr, farea * ardg2n)
                acc(d_vicen, nr, fvol * virdgn)
                acc(d_vsnon, nr, fvol * vsrdgn * FSNOWRDG)
                frac = dict(A=farea * ardg2n / torch.clamp(a_init[n],
                                                           min=ct.puny),
                            V=fvol * afrac, S=fvol * afrac * FSNOWRDG)
                coeff = torch.stack([z if cls is None else frac[cls]
                                     for cls in share])
                acc(d_atrcr, nr, coeff * atrcrn[n])
                if tr.nbtrcr:
                    mbio = mbio - frac["A"][None] * bio_amt
                if cat_diags:
                    acc(cd["reda"], nr, farea * ardg2n)
                    acc(cd["redv"], nr, fvol * virdgn)

        stk = lambda lst, zz: torch.stack([d if d is not None else zz
                                           for d in lst])
        aicen = aicen + stk(d_aicen, z)
        vicen = vicen + stk(d_vicen, z)
        vsnon = vsnon + stk(d_vsnon, z)
        atrcrn = atrcrn + stk(d_atrcr, torch.zeros((tr.ntrcr,) + B, **kw))
        catdiag = c["catdiag"]
        if cat_diags:
            sums = torch.stack([stk(cd[k], z) for k in (
                "ardg1", "ardg2", "virdg", "araft", "vraft")])
            # participation and ridge thickness ratio of the last pass
            # that ran (ice_mechred.F90:397); a pass with go False keeps
            # them, so the loop stays over-run invariant
            catdiag = torch.cat([
                catdiag[:5] + sums,
                torch.where(go, r.apartic, catdiag[5])[None],
                torch.where(go, r.krdg, catdiag[6])[None],
                catdiag[7:9] + torch.stack([stk(cd["reda"], z),
                                            stk(cd["redv"], z)])])

        # convergence check (ridge_check, ice_mechred.F90:2040-2093),
        # scale-aware for float32
        asum2 = aice0 + aicen.sum(0)
        ok = torch.abs(asum2 - 1.0) < max(ct.puny, eps_sum)
        divadv = (1.0 - asum2) / dt
        return dict(
            niter=c["niter"] + go, aicen=aicen, vicen=vicen, vsnon=vsnon,
            atrcrn=atrcrn, aice0=aice0,
            closing_net=torch.where(ok, 0.0, torch.clamp(-divadv, min=0.0)),
            opning=torch.where(ok, 0.0, torch.clamp(divadv, min=0.0)),
            done=c["done"] | ok, ardg1=ardg1_d, ardg2=ardg2_d,
            virdg=virdg_d, aopen=aopen, msnow_mlt=msnow, esnow_mlt=esnow,
            mpond=mpond, maero=maero, mbio=mbio, catdiag=catdiag)

    # the first pass always runs (ridge_ice's loop is a do-while)
    c = while_loop(body, pending, body(c, torch.ones(
        (), dtype=torch.bool, device=aicen.device)))

    trcrn_f = compute_tracers(tr, c["atrcrn"], c["aicen"], c["vicen"],
                              c["vsnon"])
    dti = 1.0 / dt
    dti_th = 1.0 / (ndtd * dt)
    asum_f = c["aice0"] + c["aicen"].sum(0)
    return RidgeResult(
        aicen=c["aicen"], vicen=c["vicen"], vsnon=c["vsnon"], trcrn=trcrn_f,
        aice0=c["aice0"],
        dardg1dt=c["ardg1"] * dti, dardg2dt=c["ardg2"] * dti,
        dvirdgdt=c["virdg"] * dti, opening=c["aopen"] * dti,
        fresh=c["msnow_mlt"] * dti_th, fhocn=c["esnow_mlt"] * dti_th,
        asum_err=torch.abs(asum_f - 1.0), niter=c["niter"],
        dfpond=c["mpond"], faero_ocn=c["maero"] * dti_th,
        # the slot amounts (conc * sk_l per area) times the porosity are
        # the physical mass, the unit of flux_bio (ice_algae.F90:464)
        dflux_bio=c["mbio"] * PHI_SK * dti_th,
        catdiag=(torch.cat([c["catdiag"][:3] * dti, c["catdiag"][3:]])
                 if cat_diags else c["catdiag"]))
