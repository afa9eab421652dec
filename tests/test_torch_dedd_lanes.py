"""The schedule of the delta-Eddington kernel C
(``cice5_tpu_torch/csrc/shortwave_dedd.cu``), on the CPU.

The kernel's warps take chunks of 32 (category, cell) columns from a work
counter, write the zeros of the unlit columns at once and append the lit
ones to one list; after a grid barrier they take the list ten columns at
a time and solve them, three lanes per column (one per spectral band).
``compaction`` below runs that bookkeeping with the warps interleaved in
a seeded random order, and ``band_split`` forms the outputs from the
three bands' adding solutions as the column's band-0 lane does, surface
after surface, at (nilyr, nslyr) 4/1, 7/1 and CESM2's 8/3; both are held
against the plain version here, with the size of a lane's shared-memory
slot (``kernels.dedd_lane_values``). The kernel itself is held
against the plain version on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from cice5_tpu_torch import constants as ct
from cice5_tpu_torch.models.radiation import dedd

NCAT, NY, NX = 5, 12, 20
PARAMS = dict(R_ice=0.0, R_pnd=0.0, R_snw=1.5, dT_mlt=1.5, rsnw_mlt=1500.0,
              kalg=0.6, hs0=0.03, hs1=0.03, pndaspect=0.8)
NGRP, CPG = 10, 4            # csrc NGRP, CPG


def dedd_case(seed=7, dtype=torch.float64):
    """Category fields (NCAT, NY, NX) and forcing planes (NY, NX) with about
    a quarter of the columns lit: ice-free rows 0-1 and ice on 40% of the
    rest, polar night on rows 6-7, no sunlight in column 0; category 0
    snow-free, some ponds too shallow to count."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or (NCAT, NY, NX))
    aicen = u(0.05, 0.6)
    aicen[:, :2] = 0.0
    aicen[rng.uniform(size=aicen.shape) < 0.6] = 0.0
    vicen = aicen * u(0.1, 3.0)
    vsnon = aicen * u(0.0, 0.3)
    vsnon[0] = 0.0
    apnd, hpnd = u(0.0, 0.6), u(0.0, 0.4)
    hpnd[1, 3] = 0.003
    coszen = u(0.05, 0.9, NY, NX)
    coszen[6:8] = -0.2
    sw = [u(0.0, 200.0, NY, NX) for _ in range(4)]
    for s in sw:
        s[:, 0] = 0.0
    T = lambda a: torch.as_tensor(a, dtype=dtype)
    return dict(aicen=T(aicen), vicen=T(vicen), vsnon=T(vsnon),
                Tsfcn=T(u(-15.0, 0.0)), apnd=T(apnd), hpnd=T(hpnd),
                coszen=T(coszen), fnidr=T(u(0.3, 0.7, NY, NX)),
                swvdr=T(sw[0]), swvdf=T(sw[1]), swidr=T(sw[2]),
                swidf=T(sw[3]))


def lit_columns(kw):
    netsw = kw["swvdr"] + kw["swvdf"] + kw["swidr"] + kw["swidf"]
    return ((kw["aicen"] > ct.puny) & (netsw > ct.puny)[None]
            & (kw["coszen"] > ct.puny)[None]).reshape(-1)


def compaction(lit, warps, seed=0):
    """The kernel's bookkeeping over the flat (category, cell) columns,
    with ``warps`` resident warps acting one step at a time in a seeded
    random order. Phase 1: a warp takes the next CPG chunks of 32 columns
    from the counter, zero-fills their unlit columns and appends the lit
    ones to the common list (one reservation per grab); phase 2, after
    the grid barrier: a warp takes the next NGRP entries of the list.
    Returns (groups solved, columns zero-filled)."""
    ncol = len(lit)
    nchunk = -(-ncol // 32)
    rng = np.random.default_rng(seed)
    counter, lst, zeroed = 0, [], []
    live = list(range(warps))
    while live:                           # phase 1
        k = live[rng.integers(len(live))]
        chunk, counter = counter, counter + CPG
        if chunk >= nchunk:
            live.remove(k)
            continue
        cols = range(chunk * 32, min((chunk + CPG) * 32, ncol))
        zeroed += [c for c in cols if not lit[c]]
        lst += [c for c in cols if lit[c]]
    taken, groups = 0, []
    live = list(range(warps))
    while live:                           # phase 2
        k = live[rng.integers(len(live))]
        g0, taken = taken, taken + NGRP
        if g0 >= len(lst):
            live.remove(k)
        else:
            groups.append(lst[g0:g0 + NGRP])
    return groups, zeroed


@pytest.mark.parametrize("warps,seed", [(1, 0), (12, 1), (64, 2)])
def test_compaction_solves_each_lit_column_once(warps, seed):
    """Every lit column is solved exactly once and every unlit one zero-
    filled exactly once; every group is full but the last."""
    kw = dedd_case()
    lit = lit_columns(kw).numpy()
    assert 0 < lit.sum() < len(lit)
    groups, zeroed = compaction(lit, warps, seed)
    solved = sorted(c for g in groups for c in g)
    assert solved == list(np.flatnonzero(lit))
    assert sorted(zeroed) == list(np.flatnonzero(~lit))
    assert all(len(g) == NGRP for g in groups[:-1])
    assert 1 <= len(groups[-1]) <= NGRP


def band_split(kw, nilyr, scheme, nslyr=1):
    """shortwave_dEdd's outputs formed as kernel C forms them: the adding
    solution of each surface is taken band by band (a lane each), and the
    column's band-0 lane gathers bands 1 and 2 at every interface, forms
    the partition of that surface in the plain version's band order and
    adds the surface's share to the mixed outputs (b*fi, then + s*fs, then
    + p*fp). The solutions come from the plain version's own adding method
    (captured from one call), so the test holds the combination alone.
    Returns (the kernel's output planes, the plain version's result)."""
    sols = []
    orig = dedd._partition_sol

    def capture(**a):
        sols.append((a["srftyp"], a["sol"]))
        return orig(**a)
    dedd._partition_sol = capture
    try:
        ref = dedd.shortwave_dEdd(nilyr=nilyr, nslyr=nslyr,
                                  pond_scheme=scheme, **PARAMS, **kw)
    finally:
        dedd._partition_sol = orig
    # the surface fractions, as shortwave_dEdd sets them up
    fs, hs, _ = dedd.set_snow(kw["aicen"], kw["vsnon"], kw["Tsfcn"],
                              R_snw=1.5, rsnw_mlt=1500.0, dT_mlt=1.5,
                              hs0=0.03)
    fp, _ = dedd.pond_setup(kw["apnd"], kw["hpnd"], hs, pond_scheme=scheme,
                            hs0=0.03, hs1=0.03, pndaspect=0.8)
    fp = torch.minimum(fp, 1.0 - fs)
    fi = torch.clamp(1.0 - fs - fp, min=0.0)
    klev = nslyr + nilyr + 1
    nout = 11 + nslyr + 2 * nilyr + 1
    w2 = 0.67 + (0.78 - 0.67) * (1.0 - kw["fnidr"])
    w3 = 1.0 - w2
    acc = [None] * nout
    for srf, sol in sols:
        frac = (fi, fs, fp)[srf]
        lanes = [tuple([e[b] for e in lst] for lst in sol) for b in range(3)]
        ksrf = 1 if srf == 1 else nslyr + 2
        net_tot, net_vs = [], []
        for k in range(klev + 2):
            (d0, e0), (d1, e1), (d2, e2) = (dedd._net_k(ln, k)
                                            for ln in lanes)
            nv = d0 * kw["swvdr"] + e0 * kw["swvdf"]
            nir = (w2 * d1 + w3 * d2) * kw["swidr"] \
                + (w2 * e1 + w3 * e2) * kw["swidf"]
            net_tot.append(nv + nir)
            net_vs.append(nv)
        rdir = [ln[3][0] for ln in lanes]
        rdif = [ln[4][0] for ln in lanes]
        vals = [rdir[0], rdif[0], rdir[1] * w2 + rdir[2] * w3,
                rdif[1] * w2 + rdif[2] * w3, net_tot[0] - net_tot[ksrf],
                net_tot[ksrf] - net_tot[klev + 1], net_tot[klev + 1]]
        mixed = list(range(7))
        for k in range(nslyr + 2, nslyr + 2 + nilyr):
            km = k - 1 if (srf == 1 and k == nslyr + 2) else k
            mixed.append(5 + k)
            vals.append(net_tot[km] - net_tot[k + 1])
        for k in range(nslyr + 2, klev + 2):
            mixed.append(5 + nilyr + k)
            vals.append(net_vs[k])
        for q, x in zip(mixed, vals):
            acc[q] = x * frac if srf == 0 else acc[q] + x * frac
        if srf == 1:
            for k in range(1, nslyr + 1):
                acc[6 + k] = (net_tot[k] - net_tot[k + 1]) * frac
        acc[nout - 4 + srf] = (ct.awtvdr * vals[0] + ct.awtidr * vals[2]
                               + ct.awtvdf * vals[1] + ct.awtidf * vals[3])
    acc[nout - 1] = fs
    return acc, ref


# the layer counts of the kernel's default build, and CESM2's 8 ice and 3
# snow layers (a library of its own)
LAYERS = [pytest.param(4, 1, id="4"), pytest.param(7, 1, id="7"),
          pytest.param(8, 3, id="8-3")]


@pytest.mark.parametrize("nilyr,nslyr", LAYERS)
@pytest.mark.parametrize("scheme", ["lvl", "cesm", "topo"])
def test_band_split_partition_equals_plain(nilyr, nslyr, scheme):
    """In float64 the band-split combination of kernel C gives the plain
    version's 11 + nslyr + 2 nilyr + 1 outputs bit for bit on every lit
    column, every snow layer's absorption among them."""
    kw = dedd_case()
    got, ref = band_split(kw, nilyr, scheme, nslyr)
    lit = lit_columns(kw).reshape(NCAT, NY, NX)
    planes = [ref.alvdrn, ref.alvdfn, ref.alidrn, ref.alidfn, ref.fswsfcn,
              ref.fswintn, ref.fswthrun, *ref.Sswabsn, *ref.Iswabsn,
              *ref.fswpenln, ref.albicen, ref.albsnon, ref.albpndn,
              ref.snowfracn]
    assert len(planes) == len(got) == 11 + nslyr + 2 * nilyr + 1
    if nslyr > 1:
        assert all(float(p[lit].abs().max()) > 0.0 for p in ref.Sswabsn)
    for q, (r, g) in enumerate(zip(planes, got)):
        assert torch.equal(r[lit], torch.broadcast_to(g, r.shape)[lit]), q


@pytest.mark.parametrize("nilyr,nslyr", LAYERS)
def test_lane_slot_fits_the_card(nilyr, nslyr):
    """A lane's slot of kernel C (csrc lane_values: the adding arrays, 6 x
    (klev+2), and the outputs) and the block's shared memory: 115 values
    and 123,184 B in float64 at CESM2's 8/3, within the H100's 232,448 B
    a block may use."""
    from cice5_tpu_torch.ops import kernels
    klev = nslyr + nilyr + 1
    nout = 11 + nslyr + 2 * nilyr + 1
    values = 6 * (klev + 2) + nout
    assert kernels.dedd_lane_values(nilyr, nslyr) == values
    for itemsize in (4, 8):
        smem = kernels.dedd_smem_bytes(nilyr, nslyr, itemsize, 232448)
        assert smem == 678 * 8 + 128 * itemsize * values
    assert kernels.dedd_smem_bytes(8, 3, 8) == 123184


def test_lane_slot_too_large_is_refused():
    """A pair whose block exceeds the card's shared memory raises, naming
    the limit: 20 ice and 5 snow layers need 235,824 B in float64 (and
    fit in float32)."""
    from cice5_tpu_torch.ops import kernels
    assert kernels.dedd_smem_bytes(20, 5, 4, 232448) == 120624
    with pytest.raises(ValueError, match="232448 B a block may use"):
        kernels.dedd_smem_bytes(20, 5, 8, 232448)
    with pytest.raises(ValueError, match="nslyr >= 1"):
        kernels.dedd_kernel(4, 0)
