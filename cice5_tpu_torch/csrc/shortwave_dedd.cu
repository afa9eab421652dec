// Delta-Eddington shortwave column solve for NVIDIA Hopper (sm_90a).
//
// Replaces: the Pallas kernel shortwave_dEdd_tiled of the JAX package
// (cice5_tpu/ops/pallas/dedd_fused.py:51), which runs the whole
// delta-Eddington column of models/radiation/dedd.py:shortwave_dEdd for
// every (category, cell): snow grain radius and pond setup, the layer
// optical properties of the bare, snow and pond surfaces in the three
// spectral bands (the snow tables, the Fresnel layer at index 0 for ponds
// and nslyr+2 otherwise), the adding method over klev+2 interfaces with the
// TRMIN dark gate, the flux partition and the area-fraction mix
// (ice_shortwave.F90:1607-3680).
//
// Design: compacted lit columns, split over the spectral bands; one
// cooperative launch of as many 4-warp blocks as the card holds at once.
//   - Phase 1, the scan: each warp takes 4 chunks of 32 (category, cell)
//     columns at a time from an integer work counter (atomicAdd, no host
//     sync), their loads in flight together. Its lanes test one column of a
//     chunk each: a column that is not lit (aicen, the net
//     shortwave and coszen all above puny, dedd.py:696) gets its exact
//     zeros at once, in coalesced stores (the byte floor of the call); the
//     lit ones are balloted and appended to one list of lit columns in the
//     work array the wrapper allocates (one atomicAdd per grab).
//     This is the reference's compressed list of lit cells
//     (ice_shortwave.F90:1607+), built at warp granularity.
//   - One grid barrier, then phase 2: each warp takes the next 10 columns
//     of the list from a second counter and solves them, until the list is
//     done. Lit cells cluster along the ice edge, so a warp that solved the
//     columns it found itself would carry whole chunks of them (3.2 groups
//     each) while others idle; taking groups from the common list leaves
//     at most one group's imbalance.
//   - A group is solved three lanes per column, one per spectral band:
//     each lane builds its band's layer properties (10 sets) and runs its
//     band's three adding sweeps (bare, snow, pond). After each sweep the
//     band-0 lane of the column takes the other two bands' interface
//     fluxes and albedos by warp shuffles and forms the flux partition in
//     the plain version's band order, adding the surface's share to the
//     mixed outputs. layer_props is one function, not inlined ten times:
//     the smaller code runs faster.
//   - Per-lane arrays (the downward adding state, the interface fluxes and
//     the mixed outputs) live in shared memory, one slot per thread, so the
//     registers hold the scalars and the layer properties.
//   - Constant work is out of the column: the snow tables' segment steps
//     and inverse widths come from dedd.kernel_tables (float64, as
//     dedd.py:_interp_table computes them), the 31 clamp weights of a lane's
//     grain radius are computed once for its three lookups, and the
//     Gaussian points, weights and their sum are compile-time constants.
//   - The layer counts are compile-time: the default build instantiates
//     (nilyr, nslyr) = (4, 1) and (7, 1), and a build with -DDEDD_NI=<n>
//     -DDEDD_NS=<m> instantiates that pair alone, into a library of its
//     own (ops/kernels.py builds it at the pair's first use). A lane's slot
//     grows with the layers (lane_values: 115 values at 8/3, 123 KB of
//     shared memory per block in float64); the wrapper refuses a pair
//     whose block does not fit the card's shared memory. Above 10 layers
//     the adding state goes back through the lane's slot (reload_lane).
// Every expression keeps the plain version's operation order (the build
// turns off FMA contraction, ops/kernels.py NVCC_FLAGS), and each column
// writes only its own outputs, so no result depends on the schedule.
//
// Bound on the H100: bytes on the gx1-parity data, operations where most
// columns are lit. Every column reads aicen and writes 11+nslyr+2*nilyr+1
// planes, and every cell reads coszen and the four shortwave planes (~92 B
// per column in float32 at nilyr=4); only a lit column reads the other five
// category inputs (and its cell fnidr), and does ~20k operations (30
// distinct layer property sets, each with an 8-point Gaussian
// re-integration, nine adding sweeps, the table lookups). At 384x320x5
// with 9% of the columns lit (the 70N/60S ice edge in daylight) that is
// ~58 MB (~17 us at 3.35 TB/s) against ~1.1 G operations (~16 us at
// 67 TFLOP/s).
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr double PUNY = 1.0e-11;
constexpr double HS_MIN = 1.0e-4;
constexpr double TIMELT = 0.0;
constexpr double RHOS = 330.0;
constexpr double RHOFRESH = 1000.0;
constexpr double HS_SSL = 0.040;
constexpr double HI_SSL = 0.050;
constexpr double HPMIN = 0.005;
constexpr double HP0 = 0.200;
constexpr double TRMIN = 0.001;
constexpr double EXP_MIN = 4.5399929762484854e-05;   // exp(-10)
constexpr double REFINDX = 1.310;
constexpr double CP063 = 0.063, CP455 = 0.455;
constexpr double AWTVDR = 0.00318, AWTIDR = 0.00182;
constexpr double AWTVDF = 0.63282, AWTIDF = 0.36218;

// the 8-point Gaussian quadrature of the diffuse re-integration
// (dedd.py GAUSPT, GAUSWT) and the sum of its weights mu*w, taken in the
// plain version's order
__host__ __device__ constexpr double gaus_pt(int q) {
  return q == 0 ? 0.9894009 : q == 1 ? 0.9445750 : q == 2 ? 0.8656312
       : q == 3 ? 0.7554044 : q == 4 ? 0.6178762 : q == 5 ? 0.4580168
       : q == 6 ? 0.2816036 : 0.0950125;
}
__host__ __device__ constexpr double gaus_wt(int q) {
  return q == 0 ? 0.0271525 : q == 1 ? 0.0622535 : q == 2 ? 0.0951585
       : q == 3 ? 0.1246290 : q == 4 ? 0.1495960 : q == 5 ? 0.1691565
       : q == 6 ? 0.1826034 : 0.1894506;
}
__host__ __device__ constexpr double gaus_swt() {
  double s = 0.0;
  for (int q = 0; q < 8; ++q) s = s + gaus_pt(q) * gaus_wt(q);
  return s;
}
constexpr double GAUS_SWT = gaus_swt();

// layout of dedd.kernel_tables
constexpr int NTAB = 32;
constexpr int T_RSNW = 0, T_QS = 32, T_WS = 32 + 96, T_GS = 32 + 192;
constexpr int T_IOP = 32 + 288;
enum { K_SSL, W_SSL, G_SSL, K_DL, W_DL, G_DL, K_INT, W_INT, G_INT, K_PSSL,
       W_PSSL, G_PSSL, K_PINT, W_PINT, G_PINT, KWAT, NIOP };
constexpr int T_DQS = T_IOP + 3 * NIOP;            // steps, (NTAB-1) x 3
constexpr int T_DWS = T_DQS + 3 * (NTAB - 1);
constexpr int T_DGS = T_DWS + 3 * (NTAB - 1);
constexpr int T_INV = T_DGS + 3 * (NTAB - 1);      // inverse widths
constexpr int NTABV = T_INV + NTAB - 1;            // 678 values

constexpr int WARPS = 4;                  // warps per block
constexpr int NT = 32 * WARPS;            // threads per block
constexpr int NGRP = 10;                  // lit columns per warp solve
constexpr int CPG = 4;                    // chunks of 32 columns per grab
constexpr unsigned FULL = 0xffffffffu;

// the kernel's work array (ops/kernels.py shortwave_dedd allocates it):
// four counters, zeroed on the stream before each launch, then the list of
// lit columns
enum { W_CHUNK, W_NLIT, W_BARRIER, W_TAKEN, W_LIST };

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }
template <typename T>
__device__ __forceinline__ T clip01(T a) {
  return tmin(tmax(a, T(0)), T(1));
}

template <typename T>
struct LP {
  T rdir, tdir, rdif_a, rdif_b, tdif_a, tdif_b, trnlay;
};

template <typename T>
__device__ __forceinline__ LP<T> clear_layer() {
  LP<T> p;
  p.rdir = T(0); p.tdir = T(1); p.rdif_a = T(0); p.rdif_b = T(0);
  p.tdif_a = T(1); p.tdif_b = T(1); p.trnlay = T(1);
  return p;
}

template <typename T>
__device__ __forceinline__ LP<T> zero_layer() {
  LP<T> p;
  p.rdir = p.tdir = p.rdif_a = p.rdif_b = p.tdif_a = p.tdif_b = p.trnlay =
      T(0);
  return p;
}

// the three snow-table lookups of band ns at x (dedd.py:_interp_table:
// y = fp[0] + sum_k (fp[k+1]-fp[k]) * clip((x-xp[k]) / dx_k, 0, 1)), each
// clamp weight computed once for the three
template <typename T>
__device__ __forceinline__ void snow_tables(T x, int ns,
                                            const double* __restrict__ tab,
                                            T& Qs, T& ws, T& gs) {
  Qs = T(tab[T_QS + ns]);
  ws = T(tab[T_WS + ns]);
  gs = T(tab[T_GS + ns]);
#pragma unroll 4
  for (int k = 0; k < NTAB - 1; ++k) {
    const T w = clip01((x - T(tab[T_RSNW + k])) * T(tab[T_INV + k]));
    Qs = Qs + T(tab[T_DQS + 3 * k + ns]) * w;
    ws = ws + T(tab[T_DWS + 3 * k + ns]) * w;
    gs = gs + T(tab[T_DGS + 3 * k + ns]) * w;
  }
}

template <typename T>
__device__ __forceinline__ T alpha_f(T w, T uu, T gg, T e) {
  return T(0.75) * w * uu * ((T(1) + gg * (T(1) - w))
                             / (T(1) - e * e * uu * uu));
}

template <typename T>
__device__ __forceinline__ T agamm_f(T w, T uu, T gg, T e) {
  return T(0.5) * w * ((T(1) + T(3) * gg * (T(1) - w) * uu * uu)
                       / (T(1) - e * e * uu * uu));
}

// delta-scaled single-layer R/T with the Gaussian re-integration
// (dedd.py:_layer_props)
template <typename T>
__device__ __noinline__ LP<T> layer_props(T tau, T w0, T g, T mu0n) {
  const T ftot = g * g;
  const T ts = (T(1) - w0 * ftot) * tau;
  T ws = (T(1) - ftot) * w0 / tmax(T(1) - w0 * ftot, T(PUNY));
  const T gs = (g - ftot) / tmax(T(1) - ftot, T(PUNY));
  ws = tmin(ws, T(1.0 - PUNY));
  const T lm = sqrt(T(3) * (T(1) - ws) * (T(1) - ws * gs));
  const T ue = T(1.5) * (T(1) - ws * gs) / tmax(lm, T(PUNY));
  auto safe_mu = [&](T m) {
    return tabs(T(1) - lm * lm * m * m) < T(1e-6) ? m * T(1.0 + 1e-3) : m;
  };
  const T mu0n_s = safe_mu(mu0n);
  const T extins = tmax(T(exp(-lm * ts)), T(EXP_MIN));
  const T up = ue + T(1), um = ue - T(1);
  const T ne = (up * up / extins) - (um * um * extins);
  T rdif_a = (ue * ue - T(1)) * (T(1) / extins - extins) / ne;
  T tdif_a = T(4) * ue / ne;
  const T trnlay = tmax(T(exp(-ts / mu0n_s)), T(EXP_MIN));
  T alp = alpha_f(ws, mu0n_s, gs, lm);
  T gam = agamm_f(ws, mu0n_s, gs, lm);
  T apg = alp + gam, amg = alp - gam;
  LP<T> p;
  p.rdir = apg * rdif_a + amg * (tdif_a * trnlay - T(1));
  p.tdir = apg * tdif_a + (amg * rdif_a - apg + T(1)) * trnlay;
  p.trnlay = trnlay;

  const T R1 = rdif_a, T1 = tdif_a;
  T smr = T(0), smt = T(0);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const T mu_s = safe_mu(T(gaus_pt(q)));
    const T trn = tmax(T(exp(-ts / mu_s)), T(EXP_MIN));
    alp = alpha_f(ws, mu_s, gs, lm);
    gam = agamm_f(ws, mu_s, gs, lm);
    apg = alp + gam;
    amg = alp - gam;
    const T rdr = apg * R1 + amg * T1 * trn - amg;
    const T tdr = apg * T1 + amg * R1 * trn - apg * trn + trn;
    const T mw = T(gaus_pt(q) * gaus_wt(q));
    smr = (q == 0) ? mw * rdr : smr + mw * rdr;
    smt = (q == 0) ? mw * tdr : smt + mw * tdr;
  }
  rdif_a = smr / T(GAUS_SWT);
  tdif_a = smt / T(GAUS_SWT);
  p.rdif_a = p.rdif_b = rdif_a;
  p.tdif_a = p.tdif_b = tdif_a;
  return p;
}

// the Fresnel refraction interface on top of a layer (dedd.py:_fresnel)
template <typename T>
__device__ LP<T> fresnel(const LP<T>& p, T mu0, T mu0n) {
  const T R1f = (mu0 - T(REFINDX) * mu0n) / (mu0 + T(REFINDX) * mu0n);
  const T R2f = (T(REFINDX) * mu0 - mu0n) / (T(REFINDX) * mu0 + mu0n);
  const T T1f = T(2) * mu0 / (mu0 + T(REFINDX) * mu0n);
  const T T2f = T(2) * mu0 / (T(REFINDX) * mu0 + mu0n);
  const T Rf_dir = T(0.5) * (R1f * R1f + R2f * R2f);
  const T Tf_dir = T(0.5) * (T1f * T1f + T2f * T2f) * T(REFINDX) * mu0n / mu0;
  const T Rf_dif_a = T(CP063), Tf_dif_a = T(1.0 - CP063);
  const T Rf_dif_b = T(CP455), Tf_dif_b = T(1.0 - CP455);
  const T rintfc = T(1) / (T(1) - Rf_dif_b * p.rdif_a);
  LP<T> o;
  o.tdir = Tf_dir * p.tdir + Tf_dir * p.rdir * Rf_dif_b * rintfc * p.tdif_a;
  o.rdir = Rf_dir + Tf_dir * p.rdir * rintfc * Tf_dif_b;
  o.rdif_a = Rf_dif_a + Tf_dif_a * p.rdif_a * rintfc * Tf_dif_b;
  o.rdif_b = p.rdif_b + p.tdif_b * Rf_dif_b * rintfc * p.tdif_a;
  o.tdif_a = p.tdif_a * rintfc * Tf_dif_a;
  o.tdif_b = p.tdif_b * rintfc * Tf_dif_b;
  o.trnlay = Tf_dir * p.trnlay;
  return o;
}

// a lane's arrays in shared memory: entry e of this thread at s[e * NT]
template <typename T>
struct Lane {
  T* s;
  __device__ __forceinline__ T& operator[](int e) const { return s[e * NT]; }
};

// layer k of the three surfaces' stacks from their distinct property sets
// (KL = klev + 1 layers: NS+1 above the ice, then SSL, DL, interior, bottom)
template <typename T, int NS, int NI>
struct IceStack {
  static constexpr int KII = NS + 1, KLEV = NS + NI + 1;
  LP<T> ssl, dl, inr, bot;
  __device__ __forceinline__ LP<T> ice(int k) const {
    return k == KII ? ssl : k == KII + 1 ? dl : k == KLEV ? bot : inr;
  }
};

template <typename T, int NS, int NI>
struct BareStack {
  IceStack<T, NS, NI> ice;
  __device__ __forceinline__ LP<T> operator()(int k) const {
    return k <= NS ? clear_layer<T>() : ice.ice(k);
  }
};

template <typename T, int NS, int NI>
struct SnowStack {
  IceStack<T, NS, NI> ice;
  LP<T> s0, s1, sr;
  __device__ __forceinline__ LP<T> operator()(int k) const {
    return k == 0 ? s0 : k == 1 ? s1 : k <= NS ? sr : ice.ice(k);
  }
};

template <typename T, int NS, int NI>
struct PondStack {
  static constexpr int KII = NS + 1;
  LP<T> top, water, ssl, dl, inr;
  __device__ __forceinline__ LP<T> operator()(int k) const {
    return k == 0 ? top : k <= NS ? water : k == KII ? ssl
         : k == KII + 1 ? dl : inr;
  }
};

// a compiler barrier on memory for stacks of more than 10 layers (7/1's):
// after it the lane's arrays are read back from shared memory, not
// forwarded in registers from the stores before it. Forwarded, the
// downward state and the interface fluxes of 13 layers (8/3) push the
// float64 kernel past 255 registers into spills; behind the barrier it
// takes 212
template <int KL>
__device__ __forceinline__ void reload_lane() {
  if constexpr (KL > 10) asm volatile("" ::: "memory");
}

// adding method over the layer stack with the TRMIN gate (dedd.py:_adding)
// and the net downward flux factors of every interface (dedd.py:_net_k),
// KL layers and KL + 1 interfaces. The downward state of each interface
// goes to the lane's arrays (trndir, trntdr, trndif, rdndif at entries
// a*(KL+1) + k, a = 0..3), the flux factors to dfdir (a = 4) and dfdif
// (a = 5); the upward pass forms each interface's factors as it reaches
// it. Returns the top interface's albedos.
template <typename T, int KL, typename Stack>
__device__ __forceinline__ void adding(const Stack& prop, T albo,
                                       const Lane<T>& L, T& rup0dir,
                                       T& rup0dif) {
  constexpr int N1 = KL + 1;
  T tdir = T(1), ttdr = T(1), tdif = T(1), rdn = T(0);
  L[0] = tdir; L[N1] = ttdr; L[2 * N1] = tdif; L[3 * N1] = rdn;
#pragma unroll
  for (int k = 0; k < KL; ++k) {
    const LP<T> p = ttdr > T(TRMIN) ? prop(k) : zero_layer<T>();
    const T ndir = tdir * p.trnlay;
    const T refkm1 = T(1) / (T(1) - rdn * p.rdif_a);
    const T tdrrdir = tdir * p.rdir;
    const T tdndif = ttdr - tdir;
    const T nttdr = tdir * p.tdir
                    + (tdndif + tdrrdir * rdn) * refkm1 * p.tdif_a;
    const T nrdn = p.rdif_b + p.tdif_b * rdn * refkm1 * p.tdif_a;
    tdif = tdif * refkm1 * p.tdif_a;
    tdir = ndir;
    ttdr = nttdr;
    rdn = nrdn;
    L[k + 1] = tdir; L[N1 + k + 1] = ttdr; L[2 * N1 + k + 1] = tdif;
    L[3 * N1 + k + 1] = rdn;
  }
  auto flux = [&](int k, T rupdir, T rupdif) {
    const T trndir = L[k], trntdr = L[N1 + k], trndif = L[2 * N1 + k];
    const T rdndif = L[3 * N1 + k];
    const T refk = T(1) / (T(1) - rdndif * rupdif);
    const T d = trndir + (trntdr - trndir) * (T(1) - rupdif) * refk
                - trndir * rupdir * (T(1) - rdndif) * refk;
    L[4 * N1 + k] = d < T(PUNY) ? T(0) : d;
    const T f = trndif * (T(1) - rupdif) * refk;
    L[5 * N1 + k] = f < T(PUNY) ? T(0) : f;
  };
  reload_lane<KL>();
  T rupdir = albo, rupdif = albo;
  flux(KL, rupdir, rupdif);
#pragma unroll
  for (int k = KL - 1; k >= 0; --k) {
    const LP<T> p = L[N1 + k] > T(TRMIN) ? prop(k) : zero_layer<T>();
    const T refkp1 = T(1) / (T(1) - p.rdif_b * rupdif);
    const T ndir = p.rdir + (p.trnlay * rupdir
                             + (p.tdir - p.trnlay) * rupdif)
                                * refkp1 * p.tdif_b;
    rupdif = p.rdif_a + p.tdif_a * rupdif * refkp1 * p.tdif_b;
    rupdir = ndir;
    flux(k, rupdir, rupdif);
  }
  rup0dir = rupdir;
  rup0dif = rupdif;
}

struct Params {
  double rsnw_nm, rsnw_mlt, dT_mlt, kalg, hs0, hs1, pndaspect;
  int pond_scheme;   // 0 cesm, 1 lvl, 2 topo
};

template <typename T>
struct Inputs {
  const T *aicen, *vicen, *vsnon, *Tsfcn, *apnd, *hpnd;   // (ncat, ny, nx)
  const T *coszen, *fnidr, *swvdr, *swvdf, *swidr, *swidf;   // (ny, nx)
};

// the flux partition of surface SRF (dedd.py:_partition_sol) from the
// lane's interface fluxes and top albedos, the bands gathered by the
// column's band-0 lane from the next two lanes in band order, and its share
// of the mixed outputs (mix(b, s, p) = b*fi + s*fs + p*fp, surface by
// surface): every lane of the warp shuffles, the band-0 lanes write their
// lane's output entries (entry NMIX... of its arrays, see solve)
template <typename T, int NI, int NS, int SRF>
__device__ __forceinline__ void partition_mix(const Lane<T>& L, bool leader,
                                              T rup0dir, T rup0dif,
                                              T wghtns2, T wghtns3, T swvdr,
                                              T swvdf, T swidr, T swidf,
                                              T frac) {
  constexpr int KLEV = NS + NI + 1, N1 = KLEV + 2;
  constexpr int ACC = 6 * N1;                 // the lane's output entries
  constexpr int NOUT = 11 + NS + NI + NI + 1;
  constexpr int ksrf = SRF == 1 ? 1 : NS + 2;
  reload_lane<KLEV + 1>();
  const T r1 = __shfl_down_sync(FULL, rup0dir, 1);
  const T r2 = __shfl_down_sync(FULL, rup0dir, 2);
  const T f1 = __shfl_down_sync(FULL, rup0dif, 1);
  const T f2 = __shfl_down_sync(FULL, rup0dif, 2);
  // net_tot (into dfdir's entries) and net_vs (into dfdif's) per interface
#pragma unroll
  for (int k = 0; k < N1; ++k) {
    const T d0 = L[4 * N1 + k], e0 = L[5 * N1 + k];
    const T d1 = __shfl_down_sync(FULL, d0, 1);
    const T d2 = __shfl_down_sync(FULL, d0, 2);
    const T e1 = __shfl_down_sync(FULL, e0, 1);
    const T e2 = __shfl_down_sync(FULL, e0, 2);
    const T net_vs = d0 * swvdr + e0 * swvdf;
    const T nir = (wghtns2 * d1 + wghtns3 * d2) * swidr
                  + (wghtns2 * e1 + wghtns3 * e2) * swidf;
    L[4 * N1 + k] = net_vs + nir;
    L[5 * N1 + k] = net_vs;
  }
  if (!leader) return;
  auto net_tot = [&](int k) { return L[4 * N1 + k]; };
  auto mix = [&](int q, T x) {
    L[ACC + q] = SRF == 0 ? x * frac : L[ACC + q] + x * frac;
  };
  const T avdr = rup0dir, avdf = rup0dif;
  const T aidr = r1 * wghtns2 + r2 * wghtns3;
  const T aidf = f1 * wghtns2 + f2 * wghtns3;
  mix(0, avdr);
  mix(1, avdf);
  mix(2, aidr);
  mix(3, aidf);
  mix(4, net_tot(0) - net_tot(ksrf));
  mix(5, net_tot(ksrf) - net_tot(KLEV + 1));
  mix(6, net_tot(KLEV + 1));
  if (SRF == 1) {
#pragma unroll
    for (int k = 1; k <= NS; ++k)
      L[ACC + 7 + k - 1] = (net_tot(k) - net_tot(k + 1)) * frac;
  }
#pragma unroll
  for (int k = NS + 2; k < NS + 2 + NI; ++k) {
    const int km = (SRF == 1 && k == NS + 2) ? k - 1 : k;
    mix(7 + NS + k - NS - 2, net_tot(km) - net_tot(k + 1));
  }
#pragma unroll
  for (int k = NS + 2; k < KLEV + 2; ++k)
    mix(7 + NS + NI + k - NS - 2, L[5 * N1 + k]);
  L[ACC + NOUT - 4 + SRF] = T(AWTVDR) * avdr + T(AWTIDR) * aidr
                            + T(AWTVDF) * avdf + T(AWTIDF) * aidf;
}

// values per shared-memory slot of a thread: the adding arrays (6 x
// (klev+2)) and the outputs (11 + nslyr + 2 nilyr + 1)
template <int NI, int NS>
__host__ __device__ constexpr int lane_values() {
  return 6 * (NS + NI + 3) + 11 + NS + 2 * NI + 1;
}

// solve n <= NGRP lit columns cols[0..n) of the warp: lanes 3g, 3g+1, 3g+2
// take column g's bands 0, 1, 2; the other lanes repeat column 0 unseen
template <typename T, int NI, int NS>
__device__ __forceinline__ void solve(const unsigned* cols, int n, size_t np,
                                      Inputs<T> in,
                                      const double* __restrict__ tab,
                                      Params prm, Lane<T> L,
                                      T* __restrict__ out) {
  constexpr int KLEV = NS + NI + 1;
  constexpr int KL = KLEV + 1;                  // layers
  constexpr int KII = NS + 1;
  constexpr int NOUT = 11 + NS + NI + NI + 1;
  constexpr int ACC = 6 * (KL + 1);
  const int lane = threadIdx.x & 31;
  const int g = lane / 3, ns = lane - 3 * g;
  const bool active = lane < 3 * n;
  const size_t kc = (size_t)cols[active ? g : 0];
  const size_t c = kc / np, k = kc - c * np;

  const T a = in.aicen[kc];
  const T swvdr = in.swvdr[k], swvdf = in.swvdf[k];
  const T swidr = in.swidr[k], swidf = in.swidf[k];
  const T cz = tmax(in.coszen[k], T(PUNY));
  const T fni = in.fnidr[k];
  const T asafe = tmax(a, T(PUNY));
  const T hi = in.vicen[kc] / asafe;

  // snow fraction and grain radius (dedd.py:set_snow)
  const T hs = in.vsnon[kc] / asafe;
  const T fs = hs >= T(HS_MIN)
                   ? (prm.hs0 > PUNY ? tmin(hs / T(prm.hs0), T(1)) : T(1))
                   : T(0);
  const T dTs = T(TIMELT) - in.Tsfcn[kc];
  const T fT = -tmin(dTs / T(prm.dT_mlt) - T(1), T(0));
  const T rsnw = tmin(tmax(T(prm.rsnw_nm) + T(prm.rsnw_mlt - prm.rsnw_nm) * fT,
                           T(100)), T(prm.rsnw_mlt));

  // radiative pond fraction/depth (dedd.py:pond_setup)
  T fp = in.apnd[kc], hp = in.hpnd[kc];
  if (prm.pond_scheme == 1) {
    if (prm.hs1 > PUNY) {
      const T asnow = tmin(hs / T(prm.hs1), T(1));
      fp = hs >= T(PUNY) ? (T(1) - asnow) * fp : fp;
    }
    const bool haspnd = hp > T(PUNY);
    const T rp = T(RHOFRESH) * hp
                 / tmax(T(RHOFRESH) * hp + T(RHOS) * hs, T(PUNY));
    const T hmx = hs * T(RHOFRESH - RHOS) / T(RHOFRESH);
    const bool deep = hp >= hmx;
    const T hp_sat = (T(RHOFRESH) * hp + T(RHOS) * hs) / T(RHOFRESH);
    const bool drown = haspnd && rp >= T(0.15) && deep;
    if (haspnd) {
      fp = drown ? fp : T(0);
      hp = drown ? hp_sat : T(0);
    }
    fp = hp < T(HPMIN) ? T(0) : fp;
  } else if (prm.pond_scheme == 0) {
    const double h0 = prm.hs0 > 1e-6 ? prm.hs0 : 1e-6;
    const T asnow = tmin(hs / T(h0), T(1));
    if (hs >= T(HS_MIN)) {
      fp = (T(1) - asnow) * fp;
      hp = T(prm.pndaspect) * fp;
    }
    fp = hp < T(HPMIN) ? T(0) : fp;
  }
  fp = tmin(fp, T(1) - fs);
  const T fi = tmax(T(1) - fs - fp, T(0));

  const T mu0 = tmax(cz, T(0.01));
  const T mu0n = sqrt(T(1) - (T(1) - mu0 * mu0) / T(REFINDX * REFINDX));

  // layer thicknesses (dedd.py:_build_bands)
  const T hib = tmax(hi, T(PUNY));
  const T dz_i = hib / T(NI);
  const T dz_ssl = tmin(tmin(hib / T(30), T(HI_SSL)), dz_i / T(2));
  const T dz_dl = dz_i - dz_ssl;
  const T hss = tmax(hs, T(HS_MIN));
  const T dz_s = hss / T(NS);
  const T dz_s0 = tmin(dz_s / T(2), T(HS_SSL));
  const T dz_s1 = dz_s - dz_s0;
  const T dz_p = hp / T(NS + 1);
  const T blend = (hp >= T(HPMIN) && hp <= T(HP0)) ? hp / T(HP0) : T(1);
  const T fr_adj = T(1) * fni + T(0.8) * (T(1) - fni);
  const T frsnw = fr_adj * rsnw;
  const T fs_dl = T(0.25 * NI);
  const T wghtns2 = T(0.67) + T(0.78 - 0.67) * (T(1) - fni);
  const T wghtns3 = T(1) - wghtns2;

  // this lane's band
  const double* io = tab + T_IOP + ns * NIOP;
  const T albo = ns == 0 ? T(0.01) : T(0);
  const bool leader = active && ns == 0;
  T rup0dir, rup0dif;

  // ice layers shared by the bare and snow surfaces
  IceStack<T, NS, NI> ice;
  ice.ssl = layer_props(T(io[K_SSL]) * dz_ssl, T(io[W_SSL]), T(io[G_SSL]),
                        mu0);
  ice.dl = fresnel(layer_props(T(io[K_DL]) * dz_dl * fs_dl, T(io[W_DL]),
                               T(io[G_DL]), mu0n), mu0, mu0n);
  ice.inr = layer_props(T(io[K_INT]) * dz_i, T(io[W_INT]), T(io[G_INT]),
                        mu0n);
  {
    const double sig_b = io[K_INT] * io[W_INT];
    T tau_b, w_b;
    if (ns == 0) {
      const T kabs = T(io[K_INT] * (1.0 - io[W_INT]))
                     + T(prm.kalg) * (T(0.5) / tmax(dz_i, T(PUNY)));
      w_b = T(sig_b) / (T(sig_b) + kabs);
      tau_b = (kabs + T(sig_b)) * dz_i;
    } else {
      const double kabs = io[K_INT] * (1.0 - io[W_INT]);
      w_b = T(sig_b / (sig_b + kabs));
      tau_b = T(kabs + sig_b) * dz_i;
    }
    ice.bot = layer_props(tau_b, w_b, T(io[G_INT]), mu0n);
  }

  // bare: clear layers above the ice
  adding<T, KL>(BareStack<T, NS, NI>{ice}, albo, L, rup0dir, rup0dif);
  partition_mix<T, NI, NS, 0>(L, leader, rup0dir, rup0dif, wghtns2, wghtns3,
                              swvdr, swvdf, swidr, swidf, fi);

  // snow: the table optics on the surface scattering layer and the rest
  {
    T Qs, ws_t, gs_t;
    snow_tables(frsnw, ns, tab, Qs, ws_t, gs_t);
    const T ks_coef = Qs * (T((RHOS / 917.0) * 3.0)
                            / (T(4) * frsnw * T(1e-6)));
    SnowStack<T, NS, NI> snow{ice};
    snow.s0 = layer_props(ks_coef * dz_s0, ws_t, gs_t, mu0);
    snow.s1 = layer_props(ks_coef * dz_s1, ws_t, gs_t, mu0);
    if (NS > 1) snow.sr = layer_props(ks_coef * dz_s, ws_t, gs_t, mu0);
    adding<T, KL>(snow, albo, L, rup0dir, rup0dif);
  }
  partition_mix<T, NI, NS, 1>(L, leader, rup0dir, rup0dif, wghtns2, wghtns3,
                              swvdr, swvdf, swidr, swidf, fs);

  // pond: Fresnel on the top water layer, then the ponded ice
  {
    PondStack<T, NS, NI> pond;
    pond.water = layer_props(T(io[KWAT]) * dz_p, T(0), T(0), mu0n);
    pond.top = fresnel(pond.water, mu0, mu0n);
    {
      const double si = io[K_SSL] * io[W_SSL];
      const double sp = io[K_PSSL] * io[W_PSSL];
      const T sig = T(si) + T(sp - si) * blend;
      const T kext = sig + T(io[K_PSSL] * (1.0 - io[W_PSSL]));
      pond.ssl = layer_props(kext * dz_ssl, sig / kext, T(io[G_PINT]), mu0n);
    }
    {
      const double si = io[K_DL] * io[W_DL] * (0.25 * NI);
      const double sp = io[K_PINT] * io[W_PINT];
      const T sig = T(si) + T(sp - si) * blend;
      const T kext = sig + T(io[K_PINT] * (1.0 - io[W_PINT]));
      pond.dl = layer_props(kext * dz_dl, sig / kext, T(io[G_PINT]), mu0n);
    }
    {
      const double si = io[K_INT] * io[W_INT];
      const double sp = io[K_PINT] * io[W_PINT];
      const T sig = T(si) + T(sp - si) * blend;
      const T kext = sig + T(io[K_PINT] * (1.0 - io[W_PINT]));
      pond.inr = layer_props(kext * dz_i, sig / kext, T(io[G_PINT]), mu0n);
    }
    adding<T, KL>(pond, albo, L, rup0dir, rup0dif);
  }
  partition_mix<T, NI, NS, 2>(L, leader, rup0dir, rup0dif, wghtns2, wghtns3,
                              swvdr, swvdf, swidr, swidf, fp);

  if (leader) {
    L[ACC + NOUT - 1] = fs;
    T* o = out + c * NOUT * np + k;
#pragma unroll
    for (int q = 0; q < NOUT; ++q) o[q * np] = L[ACC + q];
  }
}

template <typename T, int NI, int NS>
__global__ void __launch_bounds__(NT, 1)
shortwave_dedd_kernel(int ncat, int ny, int nx, Inputs<T> in,
                      const double* __restrict__ tab_g, Params prm,
                      T* __restrict__ out, unsigned* __restrict__ work) {
  constexpr int NOUT = 11 + NS + NI + NI + 1;
  extern __shared__ unsigned char smem_bytes[];
  double* tab = reinterpret_cast<double*>(smem_bytes);
  T* lanes = reinterpret_cast<T*>(tab + NTABV);
  for (int q = threadIdx.x; q < NTABV; q += NT) tab[q] = tab_g[q];

  const Lane<T> L{lanes + threadIdx.x};
  const int lane = threadIdx.x & 31;
  const size_t np = (size_t)ny * nx;
  const size_t ncol = (size_t)ncat * np;
  const unsigned nchunk = (unsigned)((ncol + 31) / 32);
  unsigned* list = work + W_LIST;

  // phase 1: the scan, CPG chunks at a time from the counter, their loads
  // in flight together
  for (;;) {
    unsigned chunk = 0;
    if (lane == 0) chunk = atomicAdd(work + W_CHUNK, (unsigned)CPG);
    chunk = __shfl_sync(FULL, chunk, 0);
    if (chunk >= nchunk) break;
    bool lit[CPG];
#pragma unroll
    for (int h = 0; h < CPG; ++h) {
      const size_t kc = (size_t)(chunk + h) * 32 + lane;
      lit[h] = false;
      if (kc < ncol) {
        const size_t k = kc % np;
        const T netsw = in.swvdr[k] + in.swvdf[k] + in.swidr[k]
                        + in.swidf[k];
        lit[h] = in.aicen[kc] > T(PUNY) && netsw > T(PUNY)
                 && in.coszen[k] > T(PUNY);
      }
    }
    unsigned ballot[CPG];
    int nl = 0;
#pragma unroll
    for (int h = 0; h < CPG; ++h) {
      const size_t kc = (size_t)(chunk + h) * 32 + lane;
      if (kc < ncol && !lit[h]) {
        const size_t c = kc / np, k = kc - c * np;
        T* o = out + c * NOUT * np + k;
#pragma unroll
        for (int q = 0; q < NOUT; ++q) o[q * np] = T(0);
      }
      ballot[h] = __ballot_sync(FULL, lit[h]);
      nl += __popc(ballot[h]);
    }
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(work + W_NLIT, (unsigned)nl);
    base = __shfl_sync(FULL, base, 0);
#pragma unroll
    for (int h = 0; h < CPG; ++h) {
      if (lit[h])
        list[base + __popc(ballot[h] & ((1u << lane) - 1u))] =
            (unsigned)((size_t)(chunk + h) * 32 + lane);
      base += __popc(ballot[h]);
    }
  }

  // the grid barrier: every block is resident (cooperative launch)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(work + W_BARRIER, 1u);
    while (atomicAdd(work + W_BARRIER, 0u) < gridDim.x) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();

  // phase 2: groups of 10 lit columns from the list, in turn
  const unsigned nlit = atomicAdd(work + W_NLIT, 0u);
  for (;;) {
    unsigned g0 = 0;
    if (lane == 0) g0 = atomicAdd(work + W_TAKEN, (unsigned)NGRP);
    g0 = __shfl_sync(FULL, g0, 0);
    if (g0 >= nlit) break;
    solve<T, NI, NS>(list + g0, nlit - g0 < NGRP ? (int)(nlit - g0) : NGRP,
                     np, in, tab, prm, L, out);
  }
}

template <typename T, int NI, int NS>
cudaError_t launch(int ncat, int ny, int nx, const Inputs<T>& in,
                   const double* tab, const Params& prm, T* out,
                   unsigned* work, cudaStream_t stream) {
  auto fn = shortwave_dedd_kernel<T, NI, NS>;
  const size_t smem = NTABV * sizeof(double)
                      + (size_t)lane_values<NI, NS>() * NT * sizeof(T);
  // the attribute and the resident grid once per instantiation, so a later
  // call (or its CUDA graph capture) issues the counters' reset and the
  // launch alone
  static int resident = 0;
  cudaError_t err;
  if (resident == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, nsm = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, NT, smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    resident = occ * nsm;
  }
  if ((err = cudaMemsetAsync(work, 0, W_LIST * sizeof(unsigned), stream))
      != cudaSuccess)
    return err;
  void* args[] = {(void*)&ncat, (void*)&ny, (void*)&nx, (void*)&in,
                  (void*)&tab, (void*)&prm, (void*)&out, (void*)&work};
  err = cudaLaunchCooperativeKernel((const void*)fn, dim3(resident), dim3(NT),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// resident blocks per SM of the instantiation <T, NI, NS> with its
// shared memory (the cooperative launch's grid is that times the SMs)
template <typename T, int NI, int NS>
int blocks_per_sm(int* blocks) {
  auto fn = shortwave_dedd_kernel<T, NI, NS>;
  const size_t smem = NTABV * sizeof(double)
                      + (size_t)lane_values<NI, NS>() * NT * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT,
                                                            smem);
}

template <typename T>
int occupancy(int nilyr, int nslyr, int* blocks) {
#if defined(DEDD_NI) && defined(DEDD_NS)
  if (nilyr == DEDD_NI && nslyr == DEDD_NS)
    return blocks_per_sm<T, DEDD_NI, DEDD_NS>(blocks);
#else
  if (nslyr == 1 && nilyr == 4) return blocks_per_sm<T, 4, 1>(blocks);
  if (nslyr == 1 && nilyr == 7) return blocks_per_sm<T, 7, 1>(blocks);
#endif
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(int ncat, int ny, int nx, int nilyr, int nslyr, const T* aicen,
        const T* vicen, const T* vsnon, const T* Tsfcn, const T* apnd,
        const T* hpnd, const T* coszen, const T* fnidr, const T* swvdr,
        const T* swvdf, const T* swidr, const T* swidf, const double* tab,
        double rsnw_nm, double rsnw_mlt, double dT_mlt, double kalg,
        double hs0, double hs1, double pndaspect, int pond_scheme, T* out,
        unsigned* work, void* stream) {
  const Params prm{rsnw_nm, rsnw_mlt, dT_mlt, kalg, hs0, hs1, pndaspect,
                   pond_scheme};
  const Inputs<T> in{aicen, vicen, vsnon, Tsfcn, apnd, hpnd,
                     coszen, fnidr, swvdr, swvdf, swidr, swidf};
  const cudaStream_t s = (cudaStream_t)stream;
  if ((size_t)ncat * ny * nx >= ((size_t)1 << 31))
    return (int)cudaErrorInvalidValue;
#if defined(DEDD_NI) && defined(DEDD_NS)
  if (nilyr == DEDD_NI && nslyr == DEDD_NS)
    return (int)launch<T, DEDD_NI, DEDD_NS>(ncat, ny, nx, in, tab, prm, out,
                                            work, s);
#else
  if (nslyr == 1 && nilyr == 4)
    return (int)launch<T, 4, 1>(ncat, ny, nx, in, tab, prm, out, work, s);
  if (nslyr == 1 && nilyr == 7)
    return (int)launch<T, 7, 1>(ncat, ny, nx, in, tab, prm, out, work, s);
#endif
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int shortwave_dedd_f32(int ncat, int ny, int nx, int nilyr, int nslyr,
                       const float* aicen, const float* vicen,
                       const float* vsnon, const float* Tsfcn,
                       const float* apnd, const float* hpnd,
                       const float* coszen, const float* fnidr,
                       const float* swvdr, const float* swvdf,
                       const float* swidr, const float* swidf,
                       const double* tab, double rsnw_nm, double rsnw_mlt,
                       double dT_mlt, double kalg, double hs0, double hs1,
                       double pndaspect, int pond_scheme, float* out,
                       unsigned* work, void* stream) {
  return run<float>(ncat, ny, nx, nilyr, nslyr, aicen, vicen, vsnon, Tsfcn,
                    apnd, hpnd, coszen, fnidr, swvdr, swvdf, swidr, swidf,
                    tab, rsnw_nm, rsnw_mlt, dT_mlt, kalg, hs0, hs1,
                    pndaspect, pond_scheme, out, work, stream);
}

int shortwave_dedd_f64(int ncat, int ny, int nx, int nilyr, int nslyr,
                       const double* aicen, const double* vicen,
                       const double* vsnon, const double* Tsfcn,
                       const double* apnd, const double* hpnd,
                       const double* coszen, const double* fnidr,
                       const double* swvdr, const double* swvdf,
                       const double* swidr, const double* swidf,
                       const double* tab, double rsnw_nm, double rsnw_mlt,
                       double dT_mlt, double kalg, double hs0, double hs1,
                       double pndaspect, int pond_scheme, double* out,
                       unsigned* work, void* stream) {
  return run<double>(ncat, ny, nx, nilyr, nslyr, aicen, vicen, vsnon, Tsfcn,
                     apnd, hpnd, coszen, fnidr, swvdr, swvdf, swidr, swidf,
                     tab, rsnw_nm, rsnw_mlt, dT_mlt, kalg, hs0, hs1,
                     pndaspect, pond_scheme, out, work, stream);
}

// resident blocks per SM of the (nilyr, nslyr) instantiation in float32
// (f64 = 0) or float64 (f64 = 1)
int shortwave_dedd_blocks_per_sm(int nilyr, int nslyr, int f64,
                                 int* blocks) {
  return f64 ? occupancy<double>(nilyr, nslyr, blocks)
             : occupancy<float>(nilyr, nslyr, blocks);
}

const char* shortwave_dedd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
