// Fused multi-subcycle EVP chunk for NVIDIA Hopper (sm_90a).
//
// Replaces: the Pallas kernel _fused_window_call of the JAX package
// (cice5_tpu/ops/pallas/evp_fused.py:49, driven by evp_fused at :110),
// which runs K statically unrolled EVP subcycles on one zero-padded
// Y-window of the full grid width held in VMEM, the windows' cores being
// reassembled after each chunk of K subcycles.
//
// What it computes: K subcycles of models/dynamics/evp.py:subcycle_sweep
// (the stress kernel on the (ny+1, nx+1) region, then stepu at every U
// point) for an open or closed north-south boundary and a cyclic, open or
// closed east-west one. That is the same function as evp_sweep.cu for
// those boundaries, computed with temporal blocking, and with the same
// per-point arithmetic (evp_point.cuh), so the two agree bit for bit.
//
// Design: one thread block per 2-D tile. The tile's core is CY x CX points
// (region and U points share the index (j, i): T cell (j, i) has U point
// (j, i) at its NE corner); its working set carries a margin of M = K+1
// points on each of the four sides. A CUDA block cannot hold a whole
// 320-point row the way the TPU window does, so the margins are 2-D, and
// the cyclic east-west wrap is index arithmetic. Points outside the domain
// (beyond an open or closed boundary) hold zeros and stay zero, as the
// zero ghosts of halo.extend do; at the working set's own edge a missing
// neighbour reads as zero, and the error this makes travels one point per
// subcycle, so after K subcycles it has not reached the core. The working
// state lives in shared memory: u, v, the 12 stress components and the 8
// stress-divergence terms, 22 values per point (f32, core 16x32, K=10:
// 38x54 points, 180 KB; f64, core 8x16: 30x38 points, 200 KB). Per
// subcycle the block runs the stress phase over the working set,
// __syncthreads(), the stepu phase, __syncthreads(). The read-only planes
// (metrics, strength, mask, the 13 U-point inputs) are read from device
// memory through L1/L2. Only core points are written: u, v and the stress
// after the last subcycle, the diagnostics of the last stress phase and
// strint of the last stepu. One launch per chunk; the caller swaps the
// input and output tensors between chunks.
//
// Bound on the H100: operations. The chunked sweep does the same work as
// evp_sweep (~370 flops per region point and ~45 per U point per
// subcycle: ~6 GFLOP for 120 subcycles at 384x320, 92 us at 67 TFLOP/s
// in float32) and must move the same ~30 MB. The margins are overhead, not
// work: at the tiles above every core point is computed 4.0x (f32) and
// 8.9x (f64) over, and with one 180-200 KB block per SM only 8 warps are
// resident, so this first version is latency-bound on the metric reads.
// PERF.md has the measured times.
#include "evp_point.cuh"

namespace {

using namespace evp;

constexpr int NTHREADS_X = 32, NTHREADS_Y = 8;

// shared-memory planes of the working set, each TY x TX values
enum { S_U = 0, S_V = 1, S_STRESS = 2, S_STR8 = 14, S_PLANES = 22 };

template <typename T>
__global__ void __launch_bounds__(NTHREADS_X * NTHREADS_Y)
    evp_fused_chunk(int ny, int nx, int K, int CY, int CX, int cyc_x,
                    const T* __restrict__ u_in, const T* __restrict__ v_in,
                    const T* __restrict__ stress_in,
                    const T* __restrict__ maskR,
                    const T* __restrict__ strengthR,
                    const T* __restrict__ gR, const T* __restrict__ uin,
                    int cw_plane, T Cw, Params<T> P, T* __restrict__ u_out,
                    T* __restrict__ v_out, T* __restrict__ stress_out,
                    T* __restrict__ diagR, T* __restrict__ strint) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int M = K + 1;
  const int TY = CY + 2 * M, TX = CX + 2 * M;
  const int npt = TY * TX;
  T* su = sh + S_U * npt;
  T* sv = sh + S_V * npt;
  T* ss = sh + S_STRESS * npt;
  T* s8 = sh + S_STR8 * npt;

  const int nyr = ny + 1, nxr = nx + 1;
  const size_t np = (size_t)ny * nx, npr = (size_t)nyr * nxr;
  // global (j, i) of the working set's point (0, 0)
  const int jb = blockIdx.y * CY - M, ib = blockIdx.x * CX - M;

  // column of the region / U plane holding global column i, or -1 outside
  // the domain (cyclic: wrapped; the region's column nx is T column 0's
  // ghost and holds the same values as column 0)
  auto region_col = [&](int i) {
    if (i >= 0 && i <= nx) return i;
    if (!cyc_x) return -1;
    return ((i % nx) + nx) % nx;
  };
  auto u_col = [&](int i) {
    if (i >= 0 && i < nx) return i;
    if (!cyc_x) return -1;
    return ((i % nx) + nx) % nx;
  };

  // load the state of the working set
  for (int lj = threadIdx.y; lj < TY; lj += NTHREADS_Y) {
    const int j = jb + lj;
    for (int li = threadIdx.x; li < TX; li += NTHREADS_X) {
      const int q = lj * TX + li;
      const int iu = u_col(ib + li), ir = region_col(ib + li);
      const bool in_u = j >= 0 && j < ny && iu >= 0;
      const bool in_r = j >= 0 && j <= ny && ir >= 0;
      su[q] = in_u ? u_in[(size_t)j * nx + iu] : T(0);
      sv[q] = in_u ? v_in[(size_t)j * nx + iu] : T(0);
      const size_t kr = in_r ? (size_t)j * nxr + ir : 0;
#pragma unroll
      for (int c = 0; c < 12; ++c)
        ss[c * npt + q] = in_r ? stress_in[c * npr + kr] : T(0);
    }
  }
  __syncthreads();

  const int cj0 = blockIdx.y * CY, ci0 = blockIdx.x * CX;
  for (int it = 0; it < K; ++it) {
    const bool last = it == K - 1;
    // stress phase: every region point of the working set
    for (int lj = threadIdx.y; lj < TY; lj += NTHREADS_Y) {
      const int j = jb + lj;
      for (int li = threadIdx.x; li < TX; li += NTHREADS_X) {
        const int q = lj * TX + li;
        const int ir = region_col(ib + li);
        T s[12], o[8], d[5];
        if (!(j >= 0 && j <= ny && ir >= 0)) {
#pragma unroll
          for (int c = 0; c < 8; ++c) s8[c * npt + q] = T(0);
          continue;
        }
        const size_t kr = (size_t)j * nxr + ir;
        // corners NE (lj, li), NW (lj, li-1), SE (lj-1, li), SW
        const bool w = li > 0, sth = lj > 0;
        const T u00 = su[q], v00 = sv[q];
        const T uW = w ? su[q - 1] : T(0), vW = w ? sv[q - 1] : T(0);
        const T uS = sth ? su[q - TX] : T(0), vS = sth ? sv[q - TX] : T(0);
        const T uSW = w && sth ? su[q - TX - 1] : T(0);
        const T vSW = w && sth ? sv[q - TX - 1] : T(0);
        const bool m = maskR[kr] > T(0.5);
#pragma unroll
        for (int c = 0; c < 12; ++c) s[c] = m ? ss[c * npt + q] : T(0);
        const bool core = last && j >= cj0 && j < cj0 + CY &&
                          ib + li >= ci0 && ib + li < ci0 + CX &&
                          ib + li <= nx;
        stress_point(u00, uW, uS, uSW, v00, vW, vS, vSW, gR, npr, kr,
                     strengthR[kr], m, P, s, o, core, d);
#pragma unroll
        for (int c = 0; c < 12; ++c) ss[c * npt + q] = s[c];
#pragma unroll
        for (int c = 0; c < 8; ++c) s8[c * npt + q] = o[c];
        if (core) {
          const size_t ko = (size_t)j * nxr + (ib + li);
#pragma unroll
          for (int c = 0; c < 5; ++c) diagR[c * npr + ko] = d[c];
        }
      }
    }
    __syncthreads();
    // stepu phase: every U point of the working set
    for (int lj = threadIdx.y; lj < TY; lj += NTHREADS_Y) {
      const int j = jb + lj;
      for (int li = threadIdx.x; li < TX; li += NTHREADS_X) {
        const int q = lj * TX + li;
        const int iu = u_col(ib + li);
        if (!(j >= 0 && j < ny && iu >= 0)) continue;     // stays zero
        const size_t ku = (size_t)j * nx + iu;
        // str8 of the region points (j, i), (j, i+1), (j+1, i), (j+1, i+1)
        const bool e = li + 1 < TX, n = lj + 1 < TY;
        const int q10 = q + 1, q01 = q + TX, q11 = q + TX + 1;
        T uk = su[q], vk = sv[q], sx, sy;
        stepu_point(uk, vk, s8[0 * npt + q], e ? s8[1 * npt + q10] : T(0),
                    n ? s8[2 * npt + q01] : T(0),
                    e && n ? s8[3 * npt + q11] : T(0), s8[4 * npt + q],
                    n ? s8[5 * npt + q01] : T(0),
                    e ? s8[6 * npt + q10] : T(0),
                    e && n ? s8[7 * npt + q11] : T(0), uin, np, ku, cw_plane,
                    Cw, P, sx, sy);
        su[q] = uk;
        sv[q] = vk;
        if (last && j >= cj0 && j < cj0 + CY && ib + li >= ci0 &&
            ib + li < ci0 + CX && ib + li < nx) {
          strint[ku] = sx;
          strint[np + ku] = sy;
        }
      }
    }
    __syncthreads();
  }

  // write the core: u, v at U points, the stress at region points
  for (int cj = threadIdx.y; cj < CY; cj += NTHREADS_Y) {
    const int j = cj0 + cj;
    for (int ci = threadIdx.x; ci < CX; ci += NTHREADS_X) {
      const int i = ci0 + ci;
      if (j > ny || i > nx) continue;
      const int q = (M + cj) * TX + M + ci;
      if (j < ny && i < nx) {
        u_out[(size_t)j * nx + i] = su[q];
        v_out[(size_t)j * nx + i] = sv[q];
      }
      const size_t ko = (size_t)j * nxr + i;
#pragma unroll
      for (int c = 0; c < 12; ++c) stress_out[c * npr + ko] = ss[c * npt + q];
    }
  }
}

template <typename T>
int run(int ny, int nx, int K, int cyc_x, const T* u, const T* v,
        const T* stress, const T* maskR, const T* strengthR, const T* gR,
        const T* uin, int cw_plane, double Cw, double arlx1i, double denom1,
        double ecci, double brlx, double revp, double cosw, double sinw,
        T* u_out, T* v_out, T* stress_out, T* diagR, T* strint,
        void* stream) {
  // core tile: as wide as shared memory allows at K = 10
  const int CY = sizeof(T) == 4 ? 16 : 8, CX = sizeof(T) == 4 ? 32 : 16;
  const int M = K + 1;
  const size_t smem =
      (size_t)S_PLANES * (CY + 2 * M) * (CX + 2 * M) * sizeof(T);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(evp_fused_chunk<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Params<T> P =
      make_params<T>(arlx1i, denom1, ecci, brlx, revp, cosw, sinw);
  const dim3 block(NTHREADS_X, NTHREADS_Y);
  const dim3 grid((nx + 1 + CX - 1) / CX, (ny + 1 + CY - 1) / CY);
  evp_fused_chunk<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      ny, nx, K, CY, CX, cyc_x, u, v, stress, maskR, strengthR, gR, uin,
      cw_plane, T(Cw), P, u_out, v_out, stress_out, diagR, strint);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int evp_fused_f32(int ny, int nx, int K, int cyc_x, const float* u,
                  const float* v, const float* stress, const float* maskR,
                  const float* strengthR, const float* gR, const float* uin,
                  int cw_plane, double Cw, double arlx1i, double denom1,
                  double ecci, double brlx, double revp, double cosw,
                  double sinw, float* u_out, float* v_out, float* stress_out,
                  float* diagR, float* strint, void* stream) {
  return run<float>(ny, nx, K, cyc_x, u, v, stress, maskR, strengthR, gR, uin,
                    cw_plane, Cw, arlx1i, denom1, ecci, brlx, revp, cosw,
                    sinw, u_out, v_out, stress_out, diagR, strint, stream);
}

int evp_fused_f64(int ny, int nx, int K, int cyc_x, const double* u,
                  const double* v, const double* stress, const double* maskR,
                  const double* strengthR, const double* gR,
                  const double* uin, int cw_plane, double Cw, double arlx1i,
                  double denom1, double ecci, double brlx, double revp,
                  double cosw, double sinw, double* u_out, double* v_out,
                  double* stress_out, double* diagR, double* strint,
                  void* stream) {
  return run<double>(ny, nx, K, cyc_x, u, v, stress, maskR, strengthR, gR,
                     uin, cw_plane, Cw, arlx1i, denom1, ecci, brlx, revp,
                     cosw, sinw, u_out, v_out, stress_out, diagR, strint,
                     stream);
}

const char* evp_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
