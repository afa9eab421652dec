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
// keeps only the last iteration's values. The per-point arithmetic is
// evp_point.cuh, shared with evp_fused.cu: every expression keeps the
// operation order of the plain version (models/dynamics/evp.py) and the
// build turns off FMA contraction (ops/kernels.py NVCC_FLAGS), so the
// kernel rounds like the plain version: where Delta < tinyarea the
// stress update amplifies any last-bit difference ~1e4 per subcycle.
#include "evp_point.cuh"

namespace {

using namespace evp;

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

template <typename T>
__global__ void evp_stress(int ny, int nx, int cyc_x, int cyc_y, int fold,
                           const T* __restrict__ u, const T* __restrict__ v,
                           T* __restrict__ stress,
                           const T* __restrict__ maskR,
                           const T* __restrict__ strengthR,
                           const T* __restrict__ gR, Params<T> P,
                           T* __restrict__ str8, T* __restrict__ diagR,
                           int last) {
  const int nyr = ny + 1, nxr = nx + 1;
  const int ir = blockIdx.x * blockDim.x + threadIdx.x;
  const int jr = blockIdx.y * blockDim.y + threadIdx.y;
  if (ir >= nxr || jr >= nyr) return;
  const size_t np = (size_t)nyr * nxr;
  const size_t k = (size_t)jr * nxr + ir;

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

  const bool m = maskR[k] > T(0.5);
  T s[12], o[8], d[5];
#pragma unroll
  for (int c = 0; c < 12; ++c) s[c] = m ? stress[c * np + k] : T(0);
  stress_point(u00, uW, uS, uSW, v00, vW, vS, vSW, gR, np, k, strengthR[k],
               m, P, s, o, last != 0, d);
#pragma unroll
  for (int c = 0; c < 12; ++c) stress[c * np + k] = s[c];
  if (last) {
#pragma unroll
    for (int q = 0; q < 5; ++q) diagR[q * np + k] = d[q];
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) str8[q * np + k] = o[q];
}

template <typename T>
__global__ void evp_stepu(int ny, int nx, T* __restrict__ u,
                          T* __restrict__ v, const T* __restrict__ str8,
                          const T* __restrict__ uin, int cw_plane, T Cw,
                          Params<T> P, T* __restrict__ strint, int last) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t np = (size_t)ny * nx;
  const size_t k = (size_t)j * nx + i;
  const int nxr = nx + 1;
  const size_t npr = (size_t)(ny + 1) * nxr;

  // str(i,j,1)+str(i+1,j,2)+str(i,j+1,3)+str(i+1,j+1,4) on the region
  const size_t r00 = (size_t)j * nxr + i, r10 = r00 + 1;
  const size_t r01 = r00 + nxr, r11 = r01 + 1;
  T uk = u[k], vk = v[k], sx, sy;
  stepu_point(uk, vk, str8[0 * npr + r00], str8[1 * npr + r10],
              str8[2 * npr + r01], str8[3 * npr + r11], str8[4 * npr + r00],
              str8[5 * npr + r01], str8[6 * npr + r10], str8[7 * npr + r11],
              uin, np, k, cw_plane, Cw, P, sx, sy);
  u[k] = uk;
  v[k] = vk;
  if (last) {
    strint[k] = sx;
    strint[np + k] = sy;
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
  const Params<T> P =
      make_params<T>(arlx1i, denom1, ecci, brlx, revp, cosw, sinw);
  const dim3 block(32, 8);
  const dim3 grid_r((nx + 1 + 31) / 32, (ny + 1 + 7) / 8);
  const dim3 grid_u((nx + 31) / 32, (ny + 7) / 8);
  for (int it = 0; it < ndte; ++it) {
    const int last = it == ndte - 1;
    evp_stress<T><<<grid_r, block, 0, s>>>(
        ny, nx, cyc_x, cyc_y, fold, u, v, stress, maskR, strengthR, gR, P,
        str8, diagR, last);
    evp_stepu<T><<<grid_u, block, 0, s>>>(ny, nx, u, v, str8, uin, cw_plane,
                                          T(Cw), P, strint, last);
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
