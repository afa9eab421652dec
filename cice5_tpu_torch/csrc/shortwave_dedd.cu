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
// Design: one thread per (category, cell), templated on the layer counts
// (NILYR 4 or 7, NSLYR 1), so every layer array is a fixed-size local
// array. A cell that is not lit (aicen, the net shortwave and coszen all
// above puny, dedd.py:742) writes exact zeros at once: the TPU kernel's
// block-level "no lit ice" skip, here per column. The snow tables and the
// tuned ice/pond optical constants come from dedd.kernel_tables (one
// float64 array built from the plain version's numbers), and every
// expression keeps the plain version's operation order; the build turns off
// FMA contraction (ops/kernels.py NVCC_FLAGS).
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
// 67 TFLOP/s). This first version keeps everything
// in registers and local memory with no attempt to share work between
// threads; PERF.md has the measured times.
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

__constant__ double kGausPt[8] = {0.9894009, 0.9445750, 0.8656312,
                                  0.7554044, 0.6178762, 0.4580168,
                                  0.2816036, 0.0950125};
__constant__ double kGausWt[8] = {0.0271525, 0.0622535, 0.0951585,
                                  0.1246290, 0.1495960, 0.1691565,
                                  0.1826034, 0.1894506};

// layout of dedd.kernel_tables
constexpr int NTAB = 32;
constexpr int T_RSNW = 0, T_QS = 32, T_WS = 32 + 96, T_GS = 32 + 192;
constexpr int T_IOP = 32 + 288;
enum { K_SSL, W_SSL, G_SSL, K_DL, W_DL, G_DL, K_INT, W_INT, G_INT, K_PSSL,
       W_PSSL, G_PSSL, K_PINT, W_PINT, G_PINT, KWAT, NIOP };

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

// clipped-ramp table lookup (dedd.py:_interp_table)
template <typename T>
__device__ T interp_table(T x, const double* __restrict__ xp,
                          const double* __restrict__ fp, int stride) {
  T y = T(fp[0]);
  for (int k = 0; k < NTAB - 1; ++k) {
    const T dfk = T(fp[(k + 1) * stride] - fp[k * stride]);
    const T inv = T(1.0 / (xp[k + 1] - xp[k]));
    y = y + dfk * clip01((x - T(xp[k])) * inv);
  }
  return y;
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
__device__ LP<T> layer_props(T tau, T w0, T g, T mu0n) {
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
  double swt = 0.0;
  T smr = T(0), smt = T(0);
  for (int q = 0; q < 8; ++q) {
    const T mu_s = safe_mu(T(kGausPt[q]));
    const T trn = tmax(T(exp(-ts / mu_s)), T(EXP_MIN));
    alp = alpha_f(ws, mu_s, gs, lm);
    gam = agamm_f(ws, mu_s, gs, lm);
    apg = alp + gam;
    amg = alp - gam;
    const T rdr = apg * R1 + amg * T1 * trn - amg;
    const T tdr = apg * T1 + amg * R1 * trn - apg * trn + trn;
    const double mw = kGausPt[q] * kGausWt[q];
    swt = swt + mw;
    smr = (q == 0) ? T(mw) * rdr : smr + T(mw) * rdr;
    smt = (q == 0) ? T(mw) * tdr : smt + T(mw) * tdr;
  }
  rdif_a = smr / T(swt);
  tdif_a = smt / T(swt);
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

// adding method over the layer stack with the TRMIN gate (dedd.py:_adding)
// and the net downward flux factors of every interface (dedd.py:_net_k).
// KL = klev + 1 layers, KL + 1 interfaces.
template <typename T, int KL>
__device__ void adding(const LP<T>* props, T albo, T* dfdir, T* dfdif,
                       T& rup0dir, T& rup0dif) {
  T trndir[KL + 1], trntdr[KL + 1], trndif[KL + 1], rdndif[KL + 1];
  T rupdir[KL + 1], rupdif[KL + 1];
  LP<T> m[KL];
  trndir[0] = trntdr[0] = trndif[0] = T(1);
  rdndif[0] = T(0);
#pragma unroll
  for (int k = 0; k < KL; ++k) {
    const LP<T> p = trntdr[k] > T(TRMIN) ? props[k] : zero_layer<T>();
    m[k] = p;
    trndir[k + 1] = trndir[k] * p.trnlay;
    const T refkm1 = T(1) / (T(1) - rdndif[k] * p.rdif_a);
    const T tdrrdir = trndir[k] * p.rdir;
    const T tdndif = trntdr[k] - trndir[k];
    trntdr[k + 1] = trndir[k] * p.tdir
                    + (tdndif + tdrrdir * rdndif[k]) * refkm1 * p.tdif_a;
    rdndif[k + 1] = p.rdif_b + p.tdif_b * rdndif[k] * refkm1 * p.tdif_a;
    trndif[k + 1] = trndif[k] * refkm1 * p.tdif_a;
  }
  rupdir[KL] = albo;
  rupdif[KL] = albo;
#pragma unroll
  for (int k = KL - 1; k >= 0; --k) {
    const LP<T>& p = m[k];
    const T refkp1 = T(1) / (T(1) - p.rdif_b * rupdif[k + 1]);
    rupdir[k] = p.rdir + (p.trnlay * rupdir[k + 1]
                          + (p.tdir - p.trnlay) * rupdif[k + 1])
                             * refkp1 * p.tdif_b;
    rupdif[k] = p.rdif_a + p.tdif_a * rupdif[k + 1] * refkp1 * p.tdif_b;
  }
  rup0dir = rupdir[0];
  rup0dif = rupdif[0];
#pragma unroll
  for (int k = 0; k <= KL; ++k) {
    const T refk = T(1) / (T(1) - rdndif[k] * rupdif[k]);
    T d = trndir[k] + (trntdr[k] - trndir[k]) * (T(1) - rupdif[k]) * refk
          - trndir[k] * rupdir[k] * (T(1) - rdndif[k]) * refk;
    dfdir[k] = d < T(PUNY) ? T(0) : d;
    const T f = trndif[k] * (T(1) - rupdif[k]) * refk;
    dfdif[k] = f < T(PUNY) ? T(0) : f;
  }
}

// flux partition of one surface type (dedd.py:_partition_sol)
template <typename T, int NI, int NS>
struct Part {
  T avdr, avdf, aidr, aidf, fsfc, fint, fthru;
  T Sabs[NS], Iabs[NI], fthrul[NI + 1];
};

template <typename T, int NI, int NS>
__device__ void partition(int srftyp, const T (*dfdir)[NS + NI + 3],
                          const T (*dfdif)[NS + NI + 3], const T* rdir0,
                          const T* rdif0, T wghtns2, T wghtns3, T swvdr,
                          T swvdf, T swidr, T swidf, Part<T, NI, NS>& r) {
  constexpr int KLEV = NS + NI + 1;
  const int ksrf = srftyp == 1 ? 1 : NS + 2;
  r.avdr = rdir0[0];
  r.avdf = rdif0[0];
  r.aidr = rdir0[1] * wghtns2 + rdir0[2] * wghtns3;
  r.aidf = rdif0[1] * wghtns2 + rdif0[2] * wghtns3;
  T net_tot[KLEV + 2], net_vs[KLEV + 2];
#pragma unroll
  for (int k = 0; k < KLEV + 2; ++k) {
    net_vs[k] = dfdir[0][k] * swvdr + dfdif[0][k] * swvdf;
    const T nir = (wghtns2 * dfdir[1][k] + wghtns3 * dfdir[2][k]) * swidr
                  + (wghtns2 * dfdif[1][k] + wghtns3 * dfdif[2][k]) * swidf;
    net_tot[k] = net_vs[k] + nir;
  }
  r.fsfc = net_tot[0] - net_tot[ksrf];
  r.fint = net_tot[ksrf] - net_tot[KLEV + 1];
  r.fthru = net_tot[KLEV + 1];
#pragma unroll
  for (int k = 1; k <= NS; ++k)
    r.Sabs[k - 1] = srftyp == 1 ? net_tot[k] - net_tot[k + 1] : T(0);
#pragma unroll
  for (int k = NS + 2; k < NS + 2 + NI; ++k) {
    const int km = (srftyp == 1 && k == NS + 2) ? k - 1 : k;
    r.Iabs[k - NS - 2] = net_tot[km] - net_tot[k + 1];
  }
#pragma unroll
  for (int k = NS + 2; k < KLEV + 2; ++k) r.fthrul[k - NS - 2] = net_vs[k];
}

struct Params {
  double rsnw_nm, rsnw_mlt, dT_mlt, kalg, hs0, hs1, pndaspect;
  int pond_scheme;   // 0 cesm, 1 lvl, 2 topo
};

template <typename T, int NI, int NS>
__global__ void shortwave_dedd_kernel(
    int ncat, int ny, int nx, const T* __restrict__ aicen,
    const T* __restrict__ vicen, const T* __restrict__ vsnon,
    const T* __restrict__ Tsfcn, const T* __restrict__ apnd,
    const T* __restrict__ hpnd, const T* __restrict__ coszen,
    const T* __restrict__ fnidr, const T* __restrict__ swvdr_p,
    const T* __restrict__ swvdf_p, const T* __restrict__ swidr_p,
    const T* __restrict__ swidf_p, const double* __restrict__ tab,
    Params prm, T* __restrict__ out) {
  constexpr int KLEV = NS + NI + 1;
  constexpr int KL = KLEV + 1;                  // layers
  constexpr int KII = NS + 1;
  constexpr int NOUT = 11 + NS + NI + NI + 1;
  const size_t np = (size_t)ny * nx;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (k >= np) return;
  const size_t kc = (size_t)c * np + k;
  T* o = out + (size_t)c * NOUT * np + k;

  const T a = aicen[kc];
  const T swvdr = swvdr_p[k], swvdf = swvdf_p[k];
  const T swidr = swidr_p[k], swidf = swidf_p[k];
  const T netsw = swvdr + swvdf + swidr + swidf;
  const bool mask = a > T(PUNY);
  if (!(mask && netsw > T(PUNY) && coszen[k] > T(PUNY))) {
#pragma unroll
    for (int q = 0; q < NOUT; ++q) o[q * np] = T(0);
    return;
  }
  const T cz = tmax(coszen[k], T(PUNY));
  const T fni = fnidr[k];
  const T asafe = tmax(a, T(PUNY));
  const T hi = vicen[kc] / asafe;

  // snow fraction and grain radius (dedd.py:set_snow)
  const T hs = vsnon[kc] / asafe;
  const T fs = hs >= T(HS_MIN)
                   ? (prm.hs0 > PUNY ? tmin(hs / T(prm.hs0), T(1)) : T(1))
                   : T(0);
  const T dTs = T(TIMELT) - Tsfcn[kc];
  const T fT = -tmin(dTs / T(prm.dT_mlt) - T(1), T(0));
  const T rsnw = tmin(tmax(T(prm.rsnw_nm) + T(prm.rsnw_mlt - prm.rsnw_nm) * fT,
                           T(100)), T(prm.rsnw_mlt));

  // radiative pond fraction/depth (dedd.py:pond_setup)
  T fp = apnd[kc], hp = hpnd[kc];
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

  // net flux factors per surface (bare, snow, pond), band and interface
  T dfdir[3][3][KLEV + 2], dfdif[3][3][KLEV + 2];
  T rdir0[3][3], rdif0[3][3];
  LP<T> props[KL];
  for (int ns = 0; ns < 3; ++ns) {
    const double* io = tab + T_IOP + ns * NIOP;
    const T albo = ns == 0 ? T(0.01) : T(0);
    // ice layers shared by the bare and snow surfaces
    const LP<T> pSSL = layer_props(T(io[K_SSL]) * dz_ssl, T(io[W_SSL]),
                                   T(io[G_SSL]), mu0);
    const LP<T> pDL = fresnel(
        layer_props(T(io[K_DL]) * dz_dl * fs_dl, T(io[W_DL]), T(io[G_DL]),
                    mu0n), mu0, mu0n);
    const LP<T> pInt = layer_props(T(io[K_INT]) * dz_i, T(io[W_INT]),
                                   T(io[G_INT]), mu0n);
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
    const LP<T> pBot = layer_props(tau_b, w_b, T(io[G_INT]), mu0n);
    props[KII] = pSSL;
    props[KII + 1] = pDL;
#pragma unroll
    for (int q = KII + 2; q < KLEV; ++q) props[q] = pInt;
    props[KLEV] = pBot;

    // bare: clear layers above the ice
#pragma unroll
    for (int q = 0; q <= NS; ++q) props[q] = clear_layer<T>();
    adding<T, KL>(props, albo, dfdir[0][ns], dfdif[0][ns], rdir0[0][ns],
                  rdif0[0][ns]);

    // snow: the table optics on the surface scattering layer and the rest
    const T Qs = interp_table(frsnw, tab + T_RSNW, tab + T_QS + ns, 3);
    const T ws_t = interp_table(frsnw, tab + T_RSNW, tab + T_WS + ns, 3);
    const T gs_t = interp_table(frsnw, tab + T_RSNW, tab + T_GS + ns, 3);
    const T ks_coef = Qs * (T((RHOS / 917.0) * 3.0) / (T(4) * frsnw * T(1e-6)));
    props[0] = layer_props(ks_coef * dz_s0, ws_t, gs_t, mu0);
    const LP<T> pS1 = layer_props(ks_coef * dz_s1, ws_t, gs_t, mu0);
    props[1] = pS1;
    if (NS > 1) {
      const LP<T> pSr = layer_props(ks_coef * dz_s, ws_t, gs_t, mu0);
#pragma unroll
      for (int q = 2; q <= NS; ++q) props[q] = pSr;
    }
    adding<T, KL>(props, albo, dfdir[1][ns], dfdif[1][ns], rdir0[1][ns],
                  rdif0[1][ns]);

    // pond: Fresnel on the top water layer, then the ponded ice
    const LP<T> pPw = layer_props(T(io[KWAT]) * dz_p, T(0), T(0), mu0n);
    props[0] = fresnel(pPw, mu0, mu0n);
#pragma unroll
    for (int q = 1; q <= NS; ++q) props[q] = pPw;
    {
      const double si = io[K_SSL] * io[W_SSL];
      const double sp = io[K_PSSL] * io[W_PSSL];
      const T sig = T(si) + T(sp - si) * blend;
      const T kext = sig + T(io[K_PSSL] * (1.0 - io[W_PSSL]));
      props[KII] = layer_props(kext * dz_ssl, sig / kext, T(io[G_PINT]), mu0n);
    }
    {
      const double si = io[K_DL] * io[W_DL] * (0.25 * NI);
      const double sp = io[K_PINT] * io[W_PINT];
      const T sig = T(si) + T(sp - si) * blend;
      const T kext = sig + T(io[K_PINT] * (1.0 - io[W_PINT]));
      props[KII + 1] = layer_props(kext * dz_dl, sig / kext, T(io[G_PINT]),
                                   mu0n);
    }
    {
      const double si = io[K_INT] * io[W_INT];
      const double sp = io[K_PINT] * io[W_PINT];
      const T sig = T(si) + T(sp - si) * blend;
      const T kext = sig + T(io[K_PINT] * (1.0 - io[W_PINT]));
      const LP<T> pPi = layer_props(kext * dz_i, sig / kext, T(io[G_PINT]),
                                    mu0n);
#pragma unroll
      for (int q = KII + 2; q <= KLEV; ++q) props[q] = pPi;
    }
    adding<T, KL>(props, albo, dfdir[2][ns], dfdif[2][ns], rdir0[2][ns],
                  rdif0[2][ns]);
  }

  const T wghtns2 = T(0.67) + T(0.78 - 0.67) * (T(1) - fni);
  const T wghtns3 = T(1) - wghtns2;
  Part<T, NI, NS> rb, rs, rp;
  partition<T, NI, NS>(0, dfdir[0], dfdif[0], rdir0[0], rdif0[0], wghtns2,
                       wghtns3, swvdr, swvdf, swidr, swidf, rb);
  partition<T, NI, NS>(1, dfdir[1], dfdif[1], rdir0[1], rdif0[1], wghtns2,
                       wghtns3, swvdr, swvdf, swidr, swidf, rs);
  partition<T, NI, NS>(2, dfdir[2], dfdif[2], rdir0[2], rdif0[2], wghtns2,
                       wghtns3, swvdr, swvdf, swidr, swidf, rp);

  auto mix = [&](T b, T s, T p) { return b * fi + s * fs + p * fp; };
  int q = 0;
  o[(q++) * np] = mix(rb.avdr, rs.avdr, rp.avdr);
  o[(q++) * np] = mix(rb.avdf, rs.avdf, rp.avdf);
  o[(q++) * np] = mix(rb.aidr, rs.aidr, rp.aidr);
  o[(q++) * np] = mix(rb.aidf, rs.aidf, rp.aidf);
  o[(q++) * np] = mix(rb.fsfc, rs.fsfc, rp.fsfc);
  o[(q++) * np] = mix(rb.fint, rs.fint, rp.fint);
  o[(q++) * np] = mix(rb.fthru, rs.fthru, rp.fthru);
#pragma unroll
  for (int l = 0; l < NS; ++l) o[(q++) * np] = rs.Sabs[l] * fs;
#pragma unroll
  for (int l = 0; l < NI; ++l)
    o[(q++) * np] = mix(rb.Iabs[l], rs.Iabs[l], rp.Iabs[l]);
#pragma unroll
  for (int l = 0; l <= NI; ++l)
    o[(q++) * np] = mix(rb.fthrul[l], rs.fthrul[l], rp.fthrul[l]);
  auto broadband = [&](const Part<T, NI, NS>& r) {
    return T(AWTVDR) * r.avdr + T(AWTIDR) * r.aidr + T(AWTVDF) * r.avdf
           + T(AWTIDF) * r.aidf;
  };
  o[(q++) * np] = broadband(rb);
  o[(q++) * np] = broadband(rs);
  o[(q++) * np] = broadband(rp);
  o[(q++) * np] = fs;
}

template <typename T>
int run(int ncat, int ny, int nx, int nilyr, int nslyr, const T* aicen,
        const T* vicen, const T* vsnon, const T* Tsfcn, const T* apnd,
        const T* hpnd, const T* coszen, const T* fnidr, const T* swvdr,
        const T* swvdf, const T* swidr, const T* swidf, const double* tab,
        double rsnw_nm, double rsnw_mlt, double dT_mlt, double kalg,
        double hs0, double hs1, double pndaspect, int pond_scheme, T* out,
        void* stream) {
  Params prm{rsnw_nm, rsnw_mlt, dT_mlt, kalg, hs0, hs1, pndaspect,
             pond_scheme};
  cudaStream_t s = (cudaStream_t)stream;
  const int block = 128;
  const dim3 grid((unsigned)(((size_t)ny * nx + block - 1) / block), ncat);
  if (nslyr == 1 && nilyr == 4) {
    shortwave_dedd_kernel<T, 4, 1><<<grid, block, 0, s>>>(
        ncat, ny, nx, aicen, vicen, vsnon, Tsfcn, apnd, hpnd, coszen, fnidr,
        swvdr, swvdf, swidr, swidf, tab, prm, out);
  } else if (nslyr == 1 && nilyr == 7) {
    shortwave_dedd_kernel<T, 7, 1><<<grid, block, 0, s>>>(
        ncat, ny, nx, aicen, vicen, vsnon, Tsfcn, apnd, hpnd, coszen, fnidr,
        swvdr, swvdf, swidr, swidf, tab, prm, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
                       void* stream) {
  return run<float>(ncat, ny, nx, nilyr, nslyr, aicen, vicen, vsnon, Tsfcn,
                    apnd, hpnd, coszen, fnidr, swvdr, swvdf, swidr, swidf,
                    tab, rsnw_nm, rsnw_mlt, dT_mlt, kalg, hs0, hs1,
                    pndaspect, pond_scheme, out, stream);
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
                       void* stream) {
  return run<double>(ncat, ny, nx, nilyr, nslyr, aicen, vicen, vsnon, Tsfcn,
                     apnd, hpnd, coszen, fnidr, swvdr, swvdf, swidr, swidf,
                     tab, rsnw_nm, rsnw_mlt, dT_mlt, kalg, hs0, hs1,
                     pndaspect, pond_scheme, out, stream);
}

const char* shortwave_dedd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
