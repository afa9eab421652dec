// EVP subcycle sweep for NVIDIA Hopper (sm_90a).
//
// Replaces: the Pallas kernel sweep_resident of the JAX package
// (cice5_tpu/ops/pallas/evp_resident.py:35), which runs all ndte EVP
// subcycles of models/dynamics/evp.py:subcycle_sweep in one call.
// Each subcycle (ice_dyn_evp.F90:336-410) is
//   1. the NE-corner ghost ring of (u, v), here by index arithmetic
//      (cyclic wrap or zero fill per boundary, parallel/halo.py:extend),
//      including the tripole U-fold of a north seam: the top row is read
//      symmetrized with its fold image, 0.5*(f(ny-1,i) - f(ny-1,nx-2-i)),
//      and the ghost row is -f(ny-2, nx-2-i), both mod nx (the NECORNER
//      vector fold of halo.extend, mpi/ice_boundary.F90:1494-1596),
//   2. the stress kernel on the (ny+1, nx+1) region: strain rates, Delta,
//      replacement pressure, the 12 relaxed stress components in place and
//      the 8 stress-divergence combinations str8 (evp.py:stress_kernel),
//   3. stepu, the 2x2 implicit momentum solve at every U point with
//      quadratic water drag (models/dynamics/shared.py:stepu).
// stepu reads str8 of the neighbouring cells (i+1, j+1), so each subcycle
// is two launches, evp_stress then evp_stepu, on the caller's stream; the
// exported function evp_sweep_<type> issues all 2*ndte of them.
//
// Bound on the H100: operations, for the sweep as a whole. Counting each
// input read once and each output written once, a 120-subcycle sweep at
// 384x320 float32 moves ~30 MB (9 us at 3.35 TB/s) but does ~6 GFLOP
// (~370 flops per region point and ~45 per U point per subcycle; 92 us
// at 67 TFLOP/s). This first version is far from either: it keeps every
// plane in device memory, so each of its 240 launches re-reads ~25
// planes (~12 MB, mostly from the 50 MB L2) and pays a launch; one
// thread per cell, coalesced along x. Keeping the sweep on chip (a
// persistent kernel with grid-wide sync, or a CUDA graph of the 240
// launches) is later work; PERF.md has the measured times.
//
// The diagnostics (divu, shear, rdg_conv, rdg_shear, prs_sig, strintx,
// strinty) are written only by the last subcycle, as the JAX fori_loop
// keeps only the last iteration's values. Every expression keeps the
// operation order of the plain version (models/dynamics/evp.py) and the
// build turns off FMA contraction (ops/kernels.py NVCC_FLAGS), so the
// kernel rounds like the plain version: where Delta < tinyarea the
// stress update amplifies any last-bit difference ~1e4 per subcycle.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

template <typename T>
struct C {
  static constexpr T p027 = T(0.027777777777777776);
  static constexpr T p055 = T(0.05555555555555555);
  static constexpr T p111 = T(0.1111111111111111);
  static constexpr T p166 = T(0.16666666666666666);
  static constexpr T p222 = T(0.2222222222222222);
  static constexpr T p25 = T(0.25);
  static constexpr T p333 = T(0.3333333333333333);
  static constexpr T p5 = T(0.5);
};

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

// value of a (ny, nx) U-point field at (j, i), j in [-1, ny], i in
// [-1, nx]: the ghost ring of halo.extend (x first, then full rows in y).
// fold: a tripole north seam (U-fold, NECORNER vector): the symmetrized
// top row feeds only this read; the carried u and v keep their values.
template <typename T>
__device__ __forceinline__ T ghosted(const T* __restrict__ f, int j, int i,
                                     int ny, int nx, int cyc_x, int cyc_y,
                                     int fold) {
  if (fold && j == ny) {
    // the fold ghost row, extended cyclically in x
    const int ii = i < 0 ? i + nx : (i >= nx ? i - nx : i);
    int src = nx - 2 - ii;
    src = src < 0 ? src + nx : src;
    return -f[(size_t)(ny - 2) * nx + src];
  }
  if (i < 0 || i >= nx) {
    if (!cyc_x) return T(0);
    i = i < 0 ? i + nx : i - nx;
  }
  if (j < 0 || j >= ny) {
    if (!cyc_y) return T(0);
    j = j < 0 ? j + ny : j - ny;
  }
  if (fold && j == ny - 1) {
    int src = nx - 2 - i;
    src = src < 0 ? src + nx : src;
    const T* row = f + (size_t)j * nx;
    return T(0.5) * (row[i] + -row[src]);
  }
  return f[(size_t)j * nx + i];
}

// region metric planes, in evp.GR_NAMES order
enum { G_DXT, G_DYT, G_DXHY, G_DYHX, G_CXP, G_CYP, G_CXM, G_CYM, G_TAREAR,
       G_TINY };
// U-point planes, in evp.U_NAMES order (+ Cw plane when given)
enum { U_ICEM, U_AIU, U_UOCN, U_VOCN, U_WATERX, U_WATERY, U_FORCEX,
       U_FORCEY, U_UMASSDTI, U_FM, U_UAREAR, U_UINIT, U_VINIT, U_CW };

template <typename T>
__global__ void evp_stress(int ny, int nx, int cyc_x, int cyc_y, int fold,
                           const T* __restrict__ u, const T* __restrict__ v,
                           T* __restrict__ stress,
                           const T* __restrict__ maskR,
                           const T* __restrict__ strengthR,
                           const T* __restrict__ gR, T arlx1i, T denom1,
                           T ecci, T* __restrict__ str8,
                           T* __restrict__ diagR, int last) {
  typedef C<T> K;
  const int nyr = ny + 1, nxr = nx + 1;
  const int ir = blockIdx.x * blockDim.x + threadIdx.x;
  const int jr = blockIdx.y * blockDim.y + threadIdx.y;
  if (ir >= nxr || jr >= nyr) return;
  const size_t np = (size_t)nyr * nxr;
  const size_t k = (size_t)jr * nxr + ir;

  const T dxt = gR[G_DXT * np + k], dyt = gR[G_DYT * np + k];
  const T dxhy = gR[G_DXHY * np + k], dyhx = gR[G_DYHX * np + k];
  const T cxp = gR[G_CXP * np + k], cyp = gR[G_CYP * np + k];
  const T cxm = gR[G_CXM * np + k], cym = gR[G_CYM * np + k];
  const T tarear = gR[G_TAREAR * np + k], tinyarea = gR[G_TINY * np + k];

  // region point (jr, ir) is T cell (jr, ir); its corners are the U
  // points (jr, ir) [NE], (jr, ir-1) [NW], (jr-1, ir-1) [SW], (jr-1, ir)
  const T u00 = ghosted(u, jr, ir, ny, nx, cyc_x, cyc_y, fold);
  const T uW = ghosted(u, jr, ir - 1, ny, nx, cyc_x, cyc_y, fold);
  const T uS = ghosted(u, jr - 1, ir, ny, nx, cyc_x, cyc_y, fold);
  const T uSW = ghosted(u, jr - 1, ir - 1, ny, nx, cyc_x, cyc_y, fold);
  const T v00 = ghosted(v, jr, ir, ny, nx, cyc_x, cyc_y, fold);
  const T vW = ghosted(v, jr, ir - 1, ny, nx, cyc_x, cyc_y, fold);
  const T vS = ghosted(v, jr - 1, ir, ny, nx, cyc_x, cyc_y, fold);
  const T vSW = ghosted(v, jr - 1, ir - 1, ny, nx, cyc_x, cyc_y, fold);

  // strain rates * area (ice_dyn_evp.F90:627-655)
  const T divune = cyp * u00 - dyt * uW + cxp * v00 - dxt * vS;
  const T divunw = cym * uW + dyt * u00 + cxp * vW - dxt * vSW;
  const T divusw = cym * uSW + dyt * uS + cxm * vSW + dxt * vW;
  const T divuse = cyp * uS - dyt * uSW + cxm * vS + dxt * v00;

  const T tensionne = -cym * u00 - dyt * uW + cxm * v00 + dxt * vS;
  const T tensionnw = -cyp * uW + dyt * u00 + cxm * vW + dxt * vSW;
  const T tensionsw = -cyp * uSW + dyt * uS + cxp * vSW - dxt * vW;
  const T tensionse = -cym * uS - dyt * uSW + cxp * vS - dxt * v00;

  const T shearne = -cym * v00 - dyt * vW - cxm * u00 - dxt * uS;
  const T shearnw = -cyp * vW + dyt * v00 - cxm * uW - dxt * uSW;
  const T shearsw = -cyp * vSW + dyt * vS - cxp * uSW + dxt * uW;
  const T shearse = -cym * vS - dyt * vSW - cxp * uS + dxt * u00;

  const T Deltane = sqrt(divune * divune
                         + ecci * (tensionne * tensionne + shearne * shearne));
  const T Deltanw = sqrt(divunw * divunw
                         + ecci * (tensionnw * tensionnw + shearnw * shearnw));
  const T Deltase = sqrt(divuse * divuse
                         + ecci * (tensionse * tensionse + shearse * shearse));
  const T Deltasw = sqrt(divusw * divusw
                         + ecci * (tensionsw * tensionsw + shearsw * shearsw));

  // replacement pressure (:683-699)
  const T strength = strengthR[k];
  const T tiny = tmax(tinyarea, T(1e-30));
  T c0ne = strength / tmax(Deltane, tiny);
  T c0nw = strength / tmax(Deltanw, tiny);
  T c0sw = strength / tmax(Deltasw, tiny);
  T c0se = strength / tmax(Deltase, tiny);
  const T prs_sig = c0ne * Deltane;

  const T c1ne = c0ne * arlx1i, c1nw = c0nw * arlx1i;
  const T c1sw = c0sw * arlx1i, c1se = c0se * arlx1i;
  c0ne = c1ne * ecci;
  c0nw = c1nw * ecci;
  c0sw = c1sw * ecci;
  c0se = c1se * ecci;

  const bool m = maskR[k] > T(0.5);
  T* s = stress;
  const T d1 = denom1;
  const T sp1 = m ? (s[0 * np + k] + c1ne * (divune - Deltane)) * d1 : T(0);
  const T sp2 = m ? (s[1 * np + k] + c1nw * (divunw - Deltanw)) * d1 : T(0);
  const T sp3 = m ? (s[2 * np + k] + c1sw * (divusw - Deltasw)) * d1 : T(0);
  const T sp4 = m ? (s[3 * np + k] + c1se * (divuse - Deltase)) * d1 : T(0);
  const T sm1 = m ? (s[4 * np + k] + c0ne * tensionne) * d1 : T(0);
  const T sm2 = m ? (s[5 * np + k] + c0nw * tensionnw) * d1 : T(0);
  const T sm3 = m ? (s[6 * np + k] + c0sw * tensionsw) * d1 : T(0);
  const T sm4 = m ? (s[7 * np + k] + c0se * tensionse) * d1 : T(0);
  const T s121 = m ? (s[8 * np + k] + c0ne * shearne * K::p5) * d1 : T(0);
  const T s122 = m ? (s[9 * np + k] + c0nw * shearnw * K::p5) * d1 : T(0);
  const T s123 = m ? (s[10 * np + k] + c0sw * shearsw * K::p5) * d1 : T(0);
  const T s124 = m ? (s[11 * np + k] + c0se * shearse * K::p5) * d1 : T(0);
  s[0 * np + k] = sp1;
  s[1 * np + k] = sp2;
  s[2 * np + k] = sp3;
  s[3 * np + k] = sp4;
  s[4 * np + k] = sm1;
  s[5 * np + k] = sm2;
  s[6 * np + k] = sm3;
  s[7 * np + k] = sm4;
  s[8 * np + k] = s121;
  s[9 * np + k] = s122;
  s[10 * np + k] = s123;
  s[11 * np + k] = s124;

  if (last) {
    // ridging / diagnostic terms (:667-677)
    const T divu = K::p25 * (divune + divunw + divuse + divusw) * tarear;
    const T Delta_avg =
        K::p25 * (Deltane + Deltanw + Deltase + Deltasw) * tarear;
    const T ts = tensionne + tensionnw + tensionse + tensionsw;
    const T ss = shearne + shearnw + shearse + shearsw;
    diagR[0 * np + k] = divu;
    diagR[1 * np + k] = K::p25 * tarear * sqrt(ts * ts + ss * ss);
    diagR[2 * np + k] = -tmin(divu, T(0));
    diagR[3 * np + k] = K::p5 * (Delta_avg - tabs(divu));
    diagR[4 * np + k] = prs_sig;
  }

  // stress-divergence combinations (ice_dyn_evp.F90:722-849)
  const T ssigpn = sp1 + sp2, ssigps = sp3 + sp4;
  const T ssigpe = sp1 + sp4, ssigpw = sp2 + sp3;
  const T ssigp1 = (sp1 + sp3) * K::p055, ssigp2 = (sp2 + sp4) * K::p055;
  const T ssigmn = sm1 + sm2, ssigms = sm3 + sm4;
  const T ssigme = sm1 + sm4, ssigmw = sm2 + sm3;
  const T ssigm1 = (sm1 + sm3) * K::p055, ssigm2 = (sm2 + sm4) * K::p055;
  const T ssig12n = s121 + s122, ssig12s = s123 + s124;
  const T ssig12e = s121 + s124, ssig12w = s122 + s123;
  const T ssig121 = (s121 + s123) * K::p111;
  const T ssig122 = (s122 + s124) * K::p111;

  const T csigpne = K::p111 * sp1 + ssigp2 + K::p027 * sp3;
  const T csigpnw = K::p111 * sp2 + ssigp1 + K::p027 * sp4;
  const T csigpsw = K::p111 * sp3 + ssigp2 + K::p027 * sp1;
  const T csigpse = K::p111 * sp4 + ssigp1 + K::p027 * sp2;
  const T csigmne = K::p111 * sm1 + ssigm2 + K::p027 * sm3;
  const T csigmnw = K::p111 * sm2 + ssigm1 + K::p027 * sm4;
  const T csigmsw = K::p111 * sm3 + ssigm2 + K::p027 * sm1;
  const T csigmse = K::p111 * sm4 + ssigm1 + K::p027 * sm2;
  const T csig12ne = K::p222 * s121 + ssig122 + K::p055 * s123;
  const T csig12nw = K::p222 * s122 + ssig121 + K::p055 * s124;
  const T csig12sw = K::p222 * s123 + ssig122 + K::p055 * s121;
  const T csig12se = K::p222 * s124 + ssig121 + K::p055 * s122;

  const T str12ew = K::p5 * dxt * (K::p333 * ssig12e + K::p166 * ssig12w);
  const T str12we = K::p5 * dxt * (K::p333 * ssig12w + K::p166 * ssig12e);
  const T str12ns = K::p5 * dyt * (K::p333 * ssig12n + K::p166 * ssig12s);
  const T str12sn = K::p5 * dyt * (K::p333 * ssig12s + K::p166 * ssig12n);

  const T strp_n = K::p25 * dyt * (K::p333 * ssigpn + K::p166 * ssigps);
  const T strm_n = K::p25 * dyt * (K::p333 * ssigmn + K::p166 * ssigms);
  const T strp_s = K::p25 * dyt * (K::p333 * ssigps + K::p166 * ssigpn);
  const T strm_s = K::p25 * dyt * (K::p333 * ssigms + K::p166 * ssigmn);
  const T strp_e = K::p25 * dxt * (K::p333 * ssigpe + K::p166 * ssigpw);
  const T strm_e = K::p25 * dxt * (K::p333 * ssigme + K::p166 * ssigmw);
  const T strp_w = K::p25 * dxt * (K::p333 * ssigpw + K::p166 * ssigpe);
  const T strm_w = K::p25 * dxt * (K::p333 * ssigmw + K::p166 * ssigme);

  T o[8];
  o[0] = -strp_n - strm_n - str12ew + dxhy * (-csigpne + csigmne)
         + dyhx * csig12ne;
  o[1] = strp_n + strm_n - str12we + dxhy * (-csigpnw + csigmnw)
         + dyhx * csig12nw;
  o[2] = -strp_s - strm_s + str12ew + dxhy * (-csigpse + csigmse)
         + dyhx * csig12se;
  o[3] = strp_s + strm_s + str12we + dxhy * (-csigpsw + csigmsw)
         + dyhx * csig12sw;
  o[4] = -strp_e + strm_e - str12ns - dyhx * (csigpne + csigmne)
         + dxhy * csig12ne;
  o[5] = strp_e - strm_e - str12sn - dyhx * (csigpse + csigmse)
         + dxhy * csig12se;
  o[6] = -strp_w + strm_w + str12ns - dyhx * (csigpnw + csigmnw)
         + dxhy * csig12nw;
  o[7] = strp_w - strm_w + str12sn - dyhx * (csigpsw + csigmsw)
         + dxhy * csig12sw;
#pragma unroll
  for (int q = 0; q < 8; ++q) str8[q * np + k] = m ? o[q] : T(0);
}

template <typename T>
__global__ void evp_stepu(int ny, int nx, T* __restrict__ u,
                          T* __restrict__ v, const T* __restrict__ str8,
                          const T* __restrict__ uin, int cw_plane, T Cw,
                          T brlx_revp, T brlx, T revp, T cosw, T sinw,
                          T* __restrict__ strint, int last) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t np = (size_t)ny * nx;
  const size_t k = (size_t)j * nx + i;
  const int nxr = nx + 1;
  const size_t npr = (size_t)(ny + 1) * nxr;

  const T uold = u[k], vold = v[k];
  const T aiu = uin[U_AIU * np + k];
  const T uocn = uin[U_UOCN * np + k], vocn = uin[U_VOCN * np + k];
  const T cw = cw_plane ? uin[U_CW * np + k] : Cw;
  const T du = uocn - uold, dv = vocn - vold;
  const T vrel = aiu * T(1026.0) * cw * sqrt(du * du + dv * dv);
  const T taux = vrel * uin[U_WATERX * np + k];
  const T tauy = vrel * uin[U_WATERY * np + k];

  const T umassdti = uin[U_UMASSDTI * np + k];
  const T fm = uin[U_FM * np + k];
  const T sgn = T((fm > T(0)) - (fm < T(0)));
  const T cca = brlx_revp * umassdti + vrel * cosw;
  const T ccb = fm + sgn * vrel * sinw;
  T ab2 = cca * cca + ccb * ccb;

  // str(i,j,1)+str(i+1,j,2)+str(i,j+1,3)+str(i+1,j+1,4) on the region
  const size_t r00 = (size_t)j * nxr + i, r10 = r00 + 1;
  const size_t r01 = r00 + nxr, r11 = r01 + 1;
  const T uarear = uin[U_UAREAR * np + k];
  const T strintx = uarear * (str8[0 * npr + r00] + str8[1 * npr + r10]
                              + str8[2 * npr + r01] + str8[3 * npr + r11]);
  const T strinty = uarear * (str8[4 * npr + r00] + str8[5 * npr + r01]
                              + str8[6 * npr + r10] + str8[7 * npr + r11]);

  const T cc1 = strintx + uin[U_FORCEX * np + k] + taux
                + umassdti * (brlx * uold + revp * uin[U_UINIT * np + k]);
  const T cc2 = strinty + uin[U_FORCEY * np + k] + tauy
                + umassdti * (brlx * vold + revp * uin[U_VINIT * np + k]);
  ab2 = tmax(ab2, T(1e-30));
  const bool m = uin[U_ICEM * np + k] > T(0.5);
  u[k] = m ? (cca * cc1 + ccb * cc2) / ab2 : T(0);
  v[k] = m ? (cca * cc2 - ccb * cc1) / ab2 : T(0);
  if (last) {
    strint[k] = m ? strintx : T(0);
    strint[np + k] = m ? strinty : T(0);
  }
}

template <typename T>
int run(int ny, int nx, int ndte, int cyc_x, int cyc_y, int fold, T* u,
        T* v,
        T* stress, const T* maskR, const T* strengthR, const T* gR,
        const T* uin, int cw_plane, double Cw, double arlx1i, double denom1,
        double ecci, double brlx, double revp, double cosw, double sinw,
        T* str8, T* diagR, T* strint, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(32, 8);
  const dim3 grid_r((nx + 1 + 31) / 32, (ny + 1 + 7) / 8);
  const dim3 grid_u((nx + 31) / 32, (ny + 7) / 8);
  for (int it = 0; it < ndte; ++it) {
    const int last = it == ndte - 1;
    evp_stress<T><<<grid_r, block, 0, s>>>(
        ny, nx, cyc_x, cyc_y, fold, u, v, stress, maskR, strengthR, gR,
        T(arlx1i), T(denom1), T(ecci), str8, diagR, last);
    evp_stepu<T><<<grid_u, block, 0, s>>>(
        ny, nx, u, v, str8, uin, cw_plane, T(Cw), T(brlx + revp), T(brlx),
        T(revp), T(cosw), T(sinw), strint, last);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

int evp_sweep_f32(int ny, int nx, int ndte, int cyc_x, int cyc_y, int fold,
                  float* u, float* v, float* stress, const float* maskR,
                  const float* strengthR, const float* gR, const float* uin,
                  int cw_plane, double Cw, double arlx1i, double denom1,
                  double ecci, double brlx, double revp, double cosw,
                  double sinw, float* str8, float* diagR, float* strint,
                  void* stream) {
  return run<float>(ny, nx, ndte, cyc_x, cyc_y, fold, u, v, stress, maskR,
                    strengthR, gR, uin, cw_plane, Cw, arlx1i, denom1, ecci,
                    brlx, revp, cosw, sinw, str8, diagR, strint, stream);
}

int evp_sweep_f64(int ny, int nx, int ndte, int cyc_x, int cyc_y, int fold,
                  double* u,
                  double* v, double* stress, const double* maskR,
                  const double* strengthR, const double* gR,
                  const double* uin, int cw_plane, double Cw, double arlx1i,
                  double denom1, double ecci, double brlx, double revp,
                  double cosw, double sinw, double* str8, double* diagR,
                  double* strint, void* stream) {
  return run<double>(ny, nx, ndte, cyc_x, cyc_y, fold, u, v, stress, maskR,
                     strengthR, gR, uin, cw_plane, Cw, arlx1i, denom1, ecci,
                     brlx, revp, cosw, sinw, str8, diagR, strint, stream);
}

const char* evp_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
