// The EVP subcycle sweep as one SM-resident persistent kernel for NVIDIA
// Hopper (sm_90a): the engine of both EVP kernels of the port.
//
// Replaces: the Pallas kernels sweep_resident
// (cice5_tpu/ops/pallas/evp_resident.py:35), which runs all ndte EVP
// subcycles of models/dynamics/evp.py:subcycle_sweep in one call, and
// _fused_window_call (cice5_tpu/ops/pallas/evp_fused.py:49), which runs a
// chunk of K subcycles on zero-padded windows. Both compute the same
// function (for an open or closed north-south boundary), so one kernel
// serves both entries:
//   evp_sweep_<type>: all ndte subcycles, in place on (u, v, stress), for
//     cyclic, open or closed boundaries and the tripole U-fold or T-fold
//     of a north seam;
//   evp_fused_<type>: one chunk of K subcycles from (u, v, stress) into
//     separate outputs, for an open or closed north-south boundary (the
//     caller swaps its tensors between chunks).
// Each subcycle (ice_dyn_evp.F90:336-410) is
//   1. the NE-corner ghost ring of (u, v) by index arithmetic (cyclic wrap
//      or zero fill per boundary, parallel/halo.py:extend), with the
//      tripole fold (fold mode 1, the U-fold): the top row is read
//      symmetrized with its fold image, 0.5*(f(ny-1,i) - f(ny-1,nx-2-i)),
//      and the ghost row is -f(ny-2, nx-2-i), both mod nx; the carried u
//      and v keep their values; or (fold mode 2, the T-fold, where a U
//      point is off the fold: offsets (0, 1), no degenerate row) the ghost
//      row is -f(ny-2, nx-1-i) and the top row is read as it is;
//   2. the stress kernel on the (ny+1, nx+1) region (evp.py:stress_kernel);
//   3. stepu at every U point (models/dynamics/shared.py:stepu).
//
// Design. The grid is cut into ntj x nti tiles of U points; region point
// (j, i) belongs to the tile of U point (j, i), and the tiles of the top
// row and right column also own the region's extra row ny and column nx.
// A tile computes the stress on its own region points AND on the one-point
// ring north and east of them, from the same inputs with the same code as
// the ring's owner, so the ring's values are bit-identical to the owner's.
// Then stepu of every own U point reads only the tile's own str8, and a
// subcycle needs a single grid-wide barrier: after stepu each block writes
// its new (u, v) to one of two global exchange planes (ping-pong: the
// writes of subcycle k go to plane k%2 while a slower block may still read
// plane (k-1)%2) and arrives on a counter (red.release); the reads of the
// next subcycle that need other blocks' values follow an acquire of the
// counter. Those reads use __ldcg (L2, never the non-coherent L1/texture
// path), because other blocks of the same launch wrote them.
//
// Hiding the barrier. A tile's (u, v) window (its U points plus a
// one-point ring) stays in shared memory, stepu writing the tile's own new
// values into it. The stress loop visits the region points whose corners
// are all the tile's own (the interior) first, so the first of its two
// passes over 512 threads needs no other block; a warp that reaches a
// "far" point (one reading the ring, or a fold tile's symmetrized top
// row) waits for the barrier alone and reads that point's four corners
// from the exchange plane, with the ghost/fold indices computed first
// (ghost_ref, integer work only) so the point's 16 loads go out together.
// Variants measured on the H100 during development with an instrumented
// copy of this kernel (not kept) ran slower: cooperative_groups'
// grid.sync() followed by a block-wide load of the ring; a third pass for
// the far points; 640 or 768 threads per block; stepu of the interior U
// points moved ahead of the far points. In all of them the blocks reach
// the barrier microseconds apart, and the last one to arrive carries its
// whole subcycle on the critical path.
//
// Three branches, chosen by the caller's tile plan
// (cice5_tpu_torch/ops/evp_resident.py:tile_plan) and passed in:
//   SHARED_RO (2): one tile per block, one block per SM; the 12 stress
//     components and 8 str8 terms of the tile's region points, its (u, v)
//     window and ALL its read-only planes (10 metric planes, strength,
//     mask on the region; the 13-14 U-point planes) live in shared memory
//     for the whole call. This is the float32 branch at 384x320 (11 x 12
//     tiles of at most 35x27 U points).
//   SHARED (1): the same with the read-only planes read through L1/L2 (the
//     float64 branch at 384x320: they do not fit beside the state).
//   DEVICE (0): grids whose state exceeds the card's shared memory (0.25
//     degree, 1080x1440): each block walks several tiles per subcycle; a
//     tile's stress state lives in its own slot of a device scratch, the
//     window and str8 in shared memory, the whole window is read from L2
//     after a block-wide wait.
// The branches differ only in where a base pointer points. Every plane of
// a tile is PLANE values long, a compile-time stride, so one point's
// loads of its 12-32 plane values share one address.
//
// Outputs: the diagnostics (divu, shear, rdg_conv, rdg_shear, prs_sig) of
// the last subcycle, by owners only; strint by the last stepu; u, v and
// the stress once, at the end. When the outputs alias the inputs
// (evp_sweep), a last barrier keeps every block's first reads ahead of
// any final write. Launch: cooperative (cudaLaunchCooperativeKernel), so
// every block is resident and the spin cannot deadlock; the grid is no
// larger than cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs. No -rdc
// is needed (nvcc 12.9; the barrier probe's grid.sync() included).
//
// Bound on the H100: operations. A 120-subcycle sweep at 384x320 float32
// moves ~30 MB counting each input read once and each output written once
// (9 us at 3.35 TB/s) and does ~6 GFLOP (~370 flops per region point and
// ~45 per U point per subcycle: 92 us at 67 TFLOP/s); the redundant ring
// adds ~5% arithmetic. Without FMA contraction every flop is one issued
// instruction, and the non-float work (addresses, selects, the IEEE
// division and square root) adds about a third: ~500 instructions per
// region point, so issuing one subcycle's 1008 points of a tile takes an
// SM's 4 schedulers ~2 us at 1.98 GHz, before stepu and the barrier.
// PERF.md has the measured times.
//
// The per-point arithmetic is evp_point.cuh, unchanged: every expression
// keeps the operation order of the plain version and the build turns off
// FMA contraction (ops/kernels.py NVCC_FLAGS), so the kernel rounds like
// the plain version (bit for bit).
#include <cooperative_groups.h>

#include "evp_point.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace evp;

// threads per block: 512 in float32 (ptxas: no spills under the 128
// registers this allows), 384 in float64, whose values take two registers
template <typename T>
struct Threads {
  static constexpr int n = sizeof(T) == 4 ? 512 : 384;
};
constexpr int NRO_R = 12;      // staged region planes: gR (10), strength, mask
constexpr int NRO_U = 14;      // staged U-point planes: uin (13) + Cw
constexpr int PLANE = 1024;    // the most region points of a tile

enum Branch { DEVICE = 0, SHARED = 1, SHARED_RO = 2 };

// the caller's tile plan (ops/evp_resident.py TilePlan.as_ints)
struct Plan {
  int ntj, nti, tym, txm, branch, blocks;
};

template <typename T>
struct Sweep {
  int ny, nx, nsub, cyc_x, cyc_y, fold, cw_plane, aliased;
  Plan pl;
  T Cw;
  Params<T> P;
  const T *u_in, *v_in, *stress_in;
  const T *maskR, *strengthR, *gR, *uin;
  T *u_out, *v_out, *stress_out, *diagR, *strint;
  T* xch;          // 2 exchange buffers of (u, v): 4 (ny, nx) planes
  T* tile_stress;  // DEVICE: 12 x PLANE values per tile
  unsigned int* sync;  // the grid barrier's counter, zeroed by the caller
};

// values per block of shared memory for one branch (mirrored by
// ops/evp_resident.py:smem_bytes)
__host__ __device__ inline size_t smem_values(const Plan& pl) {
  const size_t nw = (size_t)(pl.tym + 2) * (pl.txm + 2);
  size_t n = 2 * nw + 2 * (size_t)pl.txm + 8 * PLANE;
  if (pl.branch >= SHARED) n += 12 * PLANE;
  if (pl.branch == SHARED_RO) n += (NRO_R + NRO_U) * PLANE;
  return n;
}

// Where the value of a (ny, nx) U-point field at (j, i), j in [-1, ny],
// i in [-1, nx], comes from: the ghost ring of halo.extend (x first, then
// full rows in y) and the tripole fold (fold mode 1: U-fold, 2: T-fold).
// Returns how to combine f[a] and f[b] (ghost_value); integer work only,
// so a caller can issue the loads of several points together.
enum Ghost { G_ZERO = 0, G_SELF = 1, G_NEG = 2, G_SYM = 3 };
enum Fold { F_NONE = 0, F_U = 1, F_T = 2 };

__device__ __forceinline__ int ghost_ref(int j, int i, int ny, int nx,
                                         int cyc_x, int cyc_y, int fold,
                                         int& a, int& b) {
  a = b = 0;
  if (fold && j == ny) {
    // the fold ghost row, extended cyclically in x: -f(ny-2, nx-2-i) on
    // the U-fold, -f(ny-2, nx-1-i) on the T-fold
    const int ii = i < 0 ? i + nx : (i >= nx ? i - nx : i);
    int src = (fold == F_U ? nx - 2 : nx - 1) - ii;
    src = src < 0 ? src + nx : src;
    a = b = (ny - 2) * nx + src;
    return G_NEG;
  }
  if (i < 0 || i >= nx) {
    if (!cyc_x) return G_ZERO;
    i = i < 0 ? i + nx : i - nx;
  }
  if (j < 0 || j >= ny) {
    if (!cyc_y) return G_ZERO;
    j = j < 0 ? j + ny : j - ny;
  }
  a = b = j * nx + i;
  if (fold == F_U && j == ny - 1) {
    // the U-fold's top row symmetrized with its fold image
    int src = nx - 2 - i;
    src = src < 0 ? src + nx : src;
    b = j * nx + src;
    return G_SYM;
  }
  return G_SELF;
}

// x = f[a], y = f[b] of ghost_ref; the plain version's operations
template <typename T>
__device__ __forceinline__ T ghost_value(int kind, T x, T y) {
  return kind == G_SELF  ? x
         : kind == G_NEG ? -x
         : kind == G_SYM ? T(0.5) * (x + -y)
                         : T(0);
}

struct Tile {
  int j0, i0, ty, tx;
};

__device__ __forceinline__ Tile tile_of(const Plan& pl, int ny, int nx,
                                        int t) {
  const int tj = t / pl.nti, ti = t - tj * pl.nti;
  Tile tl;
  tl.j0 = tj * ny / pl.ntj;
  tl.i0 = ti * nx / pl.nti;
  tl.ty = (tj + 1) * ny / pl.ntj - tl.j0;
  tl.tx = (ti + 1) * nx / pl.nti - tl.i0;
  return tl;
}

// The grid barrier between subcycles, split: a block arrives once its
// (u, v) are written, computes what needs no other block's values, and
// only then waits. sync: a counter the caller zeroes before the launch;
// round k is complete when every block has arrived k times. Every block
// is resident at once (cooperative launch), so the spin cannot deadlock.
__device__ __forceinline__ void grid_arrive(unsigned int* sync) {
  __syncthreads();                // every thread's exchange writes issued
  if (threadIdx.x == 0)           // releases them (cumulative over the CTA)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                 :: "l"(sync), "r"(1u) : "memory");
}

__device__ __forceinline__ void spin_until(unsigned int* sync, int round) {
  const unsigned int target = (unsigned int)round * gridDim.x;
  for (;;) {
    unsigned int v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(sync) : "memory");
    if (v >= target) break;
    __nanosleep(32);
  }
}

// the whole block waits for round `round`
__device__ __forceinline__ void grid_wait(unsigned int* sync, int round) {
  if (threadIdx.x == 0) spin_until(sync, round);
  __syncthreads();
}

// only the calling warp's active lanes wait (__syncwarp orders their
// later reads after the leader's)
__device__ __forceinline__ void warp_wait(unsigned int* sync, int round) {
  const unsigned int mask = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(mask) - 1) spin_until(sync, round);
  __syncwarp(mask);
}

template <typename T, int BR>
__global__ void __launch_bounds__(Threads<T>::n, 1)
    evp_resident(const Sweep<T> S) {
  constexpr int NT = Threads<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Plan& pl = S.pl;
  const int ny = S.ny, nx = S.nx, nxr = nx + 1;
  const size_t np = (size_t)ny * nx, npr = (size_t)(ny + 1) * nxr;
  // planes of a tile's region and U points: a fixed stride, so every
  // access of one point to its planes is one address and offsets
  constexpr int NR = PLANE, NU = PLANE;
  const int NW = (pl.tym + 2) * (pl.txm + 2);
  T* win_u = sm;                  // (ty+2, tx+2) window of u, then of v
  T* win_v = win_u + NW;
  T* top_u = win_v + NW;          // raw (u, v) of a fold tile's top row
  T* top_v = top_u + pl.txm;
  T* s8 = top_v + pl.txm;         // 8 x NR str8
  T* sst = s8 + 8 * NR;           // 12 x NR stress (shared branches)
  T* sro = sst + 12 * NR;         // staged read-only planes (SHARED_RO)
  const int ntiles = pl.ntj * pl.nti;
  // the exchange buffers: (u, v) of even and of odd subcycles
  T* const X0 = S.xch;
  T* const X1 = S.xch + 2 * np;

  // the tiles' stress state, and the read-only planes where staged
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_of(pl, ny, nx, t);
    const int wr = tl.tx + 1, nr = (tl.ty + 1) * wr;
    T* st = BR == DEVICE ? S.tile_stress + (size_t)t * 12 * NR : sst;
    for (int q = threadIdx.x; q < nr; q += NT) {
      const int r = q / wr, c = q - r * wr;
      const size_t kr = (size_t)(tl.j0 + r) * nxr + tl.i0 + c;
#pragma unroll
      for (int p = 0; p < 12; ++p) st[p * NR + q] = S.stress_in[p * npr + kr];
      if (BR == SHARED_RO) {
#pragma unroll
        for (int p = 0; p < 10; ++p) sro[p * NR + q] = S.gR[p * npr + kr];
        sro[10 * NR + q] = S.strengthR[kr];
        sro[11 * NR + q] = S.maskR[kr];
      }
    }
    if (BR == SHARED_RO) {
      const int nu = tl.ty * tl.tx, npl = S.cw_plane ? 14 : 13;
      T* su = sro + NRO_R * NR;
      for (int q = threadIdx.x; q < nu; q += NT) {
        const int r = q / tl.tx, c = q - r * tl.tx;
        const size_t ku = (size_t)(tl.j0 + r) * nx + tl.i0 + c;
        for (int p = 0; p < npl; ++p) su[p * NU + q] = S.uin[p * np + ku];
      }
    }
  }

  for (int it = 0; it < S.nsub; ++it) {
    const bool last = it == S.nsub - 1;
    T* const prev = (it & 1) ? X0 : X1;
    T* const next = (it & 1) ? X1 : X0;
    const T* src_u = it == 0 ? S.u_in : prev;
    const T* src_v = it == 0 ? S.v_in : prev + np;
    const bool direct = last && !S.aliased;
    T* dst_u = direct ? S.u_out : next;
    T* dst_v = direct ? S.v_out : next + np;
    // after the first subcycle a shared branch keeps its window: stepu
    // writes its own new (u, v) there, and what other blocks wrote is read
    // from the exchange plane point by point, after the barrier
    const bool kept = BR != DEVICE && it > 0;
    if (BR == DEVICE && it > 0) grid_wait(S.sync, it);

    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tl = tile_of(pl, ny, nx, t);
      const int W = tl.tx + 2, H = tl.ty + 2;
      const int wr = tl.tx + 1, nr = (tl.ty + 1) * wr, nu = tl.ty * tl.tx;
      // a U-fold tile on the seam: its top row is symmetrized
      const bool fold_top = S.fold == F_U && tl.j0 + tl.ty == ny;
      T* st = BR == DEVICE ? S.tile_stress + (size_t)t * 12 * NR : sst;
      if (BR == DEVICE) __syncthreads();   // the previous tile is done

      // The stress at region point (r, c) = T cell (j0+r, i0+c): its
      // corners NE (r+1, c+1), NW (r+1, c), SE (r, c+1), SW (r, c) of the
      // window are U points (j, i), (j, i-1), (j-1, i), (j-1, i-1). A
      // "far" point reads them all from the exchange plane (whose values
      // of this tile's points equal the window's), with the ghost/fold
      // indices computed first so its 16 loads go out together.
      auto stress_at = [&](int r, int c, bool far) {
        const int j = tl.j0 + r, i = tl.i0 + c;
        const int q = r * wr + c, qw = (r + 1) * W + c + 1;
        const size_t kr = (size_t)j * nxr + i;
        const bool own = (r < tl.ty || j == ny) && (c < tl.tx || i == nx);
        T u00, uW, uS, uSW, v00, vW, vS, vSW;
        if (far) {
          int a[4], b[4], kind[4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
            kind[n] = ghost_ref(j - (n >> 1), i - (n & 1), ny, nx, S.cyc_x,
                                S.cyc_y, S.fold, a[n], b[n]);
          T xu[4], yu[4], xv[4], yv[4];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            xu[n] = __ldcg(src_u + a[n]);
            yu[n] = __ldcg(src_u + b[n]);
            xv[n] = __ldcg(src_v + a[n]);
            yv[n] = __ldcg(src_v + b[n]);
          }
          u00 = ghost_value(kind[0], xu[0], yu[0]);
          uW = ghost_value(kind[1], xu[1], yu[1]);
          uS = ghost_value(kind[2], xu[2], yu[2]);
          uSW = ghost_value(kind[3], xu[3], yu[3]);
          v00 = ghost_value(kind[0], xv[0], yv[0]);
          vW = ghost_value(kind[1], xv[1], yv[1]);
          vS = ghost_value(kind[2], xv[2], yv[2]);
          vSW = ghost_value(kind[3], xv[3], yv[3]);
        } else {
          u00 = win_u[qw];
          uW = win_u[qw - 1];
          uS = win_u[qw - W];
          uSW = win_u[qw - W - 1];
          v00 = win_v[qw];
          vW = win_v[qw - 1];
          vS = win_v[qw - W];
          vSW = win_v[qw - W - 1];
        }
        const T* ro = BR == SHARED_RO ? sro : S.gR;
        const size_t rs = BR == SHARED_RO ? (size_t)NR : npr;
        const size_t rk = BR == SHARED_RO ? (size_t)q : kr;
        const T strength = BR == SHARED_RO ? sro[10 * NR + q]
                                           : S.strengthR[kr];
        const bool m = (BR == SHARED_RO ? sro[11 * NR + q] : S.maskR[kr])
                       > T(0.5);
        T s[12], o[8], d[5];
#pragma unroll
        for (int p = 0; p < 12; ++p) s[p] = m ? st[p * NR + q] : T(0);
        const bool diag = last && own;
        stress_point(u00, uW, uS, uSW, v00, vW, vS, vSW, ro, rs, rk,
                     strength, m, S.P, s, o, diag, d);
#pragma unroll
        for (int p = 0; p < 12; ++p) st[p * NR + q] = s[p];
#pragma unroll
        for (int p = 0; p < 8; ++p) s8[p * NR + q] = o[p];
        if (diag) {
#pragma unroll
          for (int p = 0; p < 5; ++p) S.diagR[p * npr + kr] = d[p];
        }
      };

      // stepu at the tile's U point (r, c): str8 of the region points
      // (r, c), (r, c+1), (r+1, c), (r+1, c+1); the new (u, v) go to the
      // exchange plane and, in a shared branch, to the window
      auto stepu_at = [&](int r, int c) {
        const int j = tl.j0 + r, i = tl.i0 + c;
        const size_t ku = (size_t)j * nx + i;
        const bool top = fold_top && j == ny - 1;
        const int qw = (r + 1) * W + c + 1, qu = r * tl.tx + c;
        T uk = top ? top_u[c] : win_u[qw];
        T vk = top ? top_v[c] : win_v[qw];
        const int q00 = r * wr + c, q10 = q00 + 1, q01 = q00 + wr,
                  q11 = q01 + 1;
        const T* ui = BR == SHARED_RO ? sro + NRO_R * NR : S.uin;
        const size_t us = BR == SHARED_RO ? (size_t)NU : np;
        const size_t uk_ = BR == SHARED_RO ? (size_t)qu : ku;
        T sx, sy;
        stepu_point(uk, vk, s8[0 * NR + q00], s8[1 * NR + q10],
                    s8[2 * NR + q01], s8[3 * NR + q11], s8[4 * NR + q00],
                    s8[5 * NR + q01], s8[6 * NR + q10], s8[7 * NR + q11], ui,
                    us, uk_, S.cw_plane, S.Cw, S.P, sx, sy);
        __stcg(dst_u + ku, uk);
        __stcg(dst_v + ku, vk);
        if (BR != DEVICE) {         // the window keeps the new values
          if (top) {
            top_u[c] = uk;
            top_v[c] = vk;
          } else {
            win_u[qw] = uk;
            win_v[qw] = vk;
          }
        }
        if (last) {
          S.strint[ku] = sx;
          S.strint[np + ku] = sy;
        }
      };

      if (!kept) {
        // the whole window: the first subcycle, and every subcycle of
        // the device branch (read through L2: other blocks wrote it)
        for (int q = threadIdx.x; q < H * W; q += NT) {
          int a, b;
          const int kind = ghost_ref(tl.j0 - 1 + q / W, tl.i0 - 1 + q % W,
                                     ny, nx, S.cyc_x, S.cyc_y, S.fold, a, b);
          win_u[q] = ghost_value(kind, __ldcg(src_u + a), __ldcg(src_u + b));
          win_v[q] = ghost_value(kind, __ldcg(src_v + a), __ldcg(src_v + b));
        }
        if (fold_top) {
          const size_t k0 = (size_t)(ny - 1) * nx + tl.i0;
          for (int c = threadIdx.x; c < tl.tx; c += NT) {
            top_u[c] = __ldcg(src_u + k0 + c);
            top_v[c] = __ldcg(src_v + k0 + c);
          }
        }
        __syncthreads();
        for (int q = threadIdx.x; q < nr; q += NT)
          stress_at(q / wr, q % wr, false);
      } else {
        // The interior region points (rows 1..ri, columns 1..tx-1) read
        // only this tile's own (u, v) and come first, so the first of the
        // two passes of 512 threads needs no other block; a warp that
        // reaches a far point (rows 0 and ri+1..ty, columns 0 and tx of
        // rows 1..ri) waits for the barrier alone.
        const int ri = max(fold_top ? tl.ty - 2 : tl.ty - 1, 0);
        const int ci = tl.tx - 1, ni = ri * ci, nrow = (1 + tl.ty - ri) * wr;
        for (int k = threadIdx.x; k < nr; k += NT) {
          int r, c;
          if (k < ni) {
            r = 1 + k / ci;
            c = 1 + k % ci;
          } else if (k - ni < nrow) {
            const int rr = (k - ni) / wr;
            r = rr == 0 ? 0 : ri + rr;
            c = k - ni - rr * wr;
          } else {
            const int kk = k - ni - nrow;
            r = 1 + (kk >> 1);
            c = (kk & 1) ? tl.tx : 0;
          }
          const bool far = k >= ni;
          if (__any_sync(__activemask(), far)) warp_wait(S.sync, it);
          stress_at(r, c, far);
        }
      }
      __syncthreads();
      for (int q = threadIdx.x; q < nu; q += NT)
        stepu_at(q / tl.tx, q % tl.tx);
    }
    if (!last || S.aliased) grid_arrive(S.sync);
  }
  // the outputs alias the inputs: no block writes before every block has
  // finished its first reads
  if (S.aliased) grid_wait(S.sync, S.nsub);

  // the stress of the own region points, and (u, v) when they went
  // through the exchange planes
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_of(pl, ny, nx, t);
    const int wr = tl.tx + 1, nr = (tl.ty + 1) * wr, nu = tl.ty * tl.tx;
    const T* st = BR == DEVICE ? S.tile_stress + (size_t)t * 12 * NR : sst;
    for (int q = threadIdx.x; q < nr; q += NT) {
      const int r = q / wr, c = q - r * wr;
      const int j = tl.j0 + r, i = tl.i0 + c;
      if (!((r < tl.ty || j == ny) && (c < tl.tx || i == nx))) continue;
      const size_t kr = (size_t)j * nxr + i;
#pragma unroll
      for (int p = 0; p < 12; ++p) S.stress_out[p * npr + kr] = st[p * NR + q];
    }
    if (S.aliased) {
      const T* fu = ((S.nsub - 1) & 1) ? X1 : X0;
      for (int q = threadIdx.x; q < nu; q += NT) {
        const int r = q / tl.tx, c = q - r * tl.tx;
        const size_t ku = (size_t)(tl.j0 + r) * nx + tl.i0 + c;
        S.u_out[ku] = __ldcg(fu + ku);
        S.v_out[ku] = __ldcg(fu + np + ku);
      }
    }
  }
}

// nbar grid barriers and nothing else, on blocks of 512 threads: the cost
// of a barrier alone (chip_smoke.py measures it). mode 0:
// cooperative_groups' grid.sync(); mode 1: the sweep's split barrier,
// arrive then wait at once.
__global__ void __launch_bounds__(512, 1)
    barrier_probe(int nbar, int mode, unsigned int* sync) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 1; k <= nbar; ++k) {
    if (mode == 0) {
      grid.sync();
    } else {
      grid_arrive(sync);
      grid_wait(sync, k);
    }
  }
}

template <typename T, int BR>
cudaError_t launch_branch(const Sweep<T>& S, cudaStream_t stream) {
  const size_t smem = smem_values(S.pl) * sizeof(T);
  auto fn = evp_resident<T, BR>;
  // the attribute and the occupancy, once per instantiation and size, so
  // a later call (or its CUDA graph capture) issues the launch alone
  static size_t smem_set = 0, smem_occ = ~(size_t)0;
  static int nsm = 0, occ = 0;
  cudaError_t err;
  if (smem > 48 * 1024 && smem > smem_set) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (smem != smem_occ) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn,
                                                        Threads<T>::n, smem);
    if (err != cudaSuccess) return err;
    smem_occ = smem;
  }
  const int ntiles = S.pl.ntj * S.pl.nti;
  const int blocks = S.pl.blocks;
  if (blocks < 1 || blocks > ntiles) return cudaErrorInvalidValue;
  if (BR != DEVICE && blocks != ntiles) return cudaErrorInvalidValue;
  // every block must be resident at once for the grid barrier
  if (blocks > occ * nsm) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&S};
  err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks),
                                    dim3(Threads<T>::n), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int run(Sweep<T> S, const int* plan, void* stream) {
  S.pl.ntj = plan[0];
  S.pl.nti = plan[1];
  S.pl.tym = plan[2];
  S.pl.txm = plan[3];
  S.pl.branch = plan[4];
  S.pl.blocks = plan[5];
  if (S.nsub < 1 || S.fold < F_NONE || S.fold > F_T || S.pl.ntj < 1 || S.pl.nti < 1 || S.pl.ntj > S.ny ||
      S.pl.nti > S.nx || S.pl.tym < (S.ny + S.pl.ntj - 1) / S.pl.ntj ||
      S.pl.txm < (S.nx + S.pl.nti - 1) / S.pl.nti ||
      (S.pl.tym + 1) * (S.pl.txm + 1) > PLANE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (S.pl.branch) {
    case DEVICE: return (int)launch_branch<T, DEVICE>(S, s);
    case SHARED: return (int)launch_branch<T, SHARED>(S, s);
    case SHARED_RO: return (int)launch_branch<T, SHARED_RO>(S, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
Sweep<T> make(int ny, int nx, int nsub, int cyc_x, int cyc_y, int fold,
              const T* u, const T* v, const T* stress, const T* maskR,
              const T* strengthR, const T* gR, const T* uin, int cw_plane,
              double Cw, double arlx1i, double denom1, double ecci,
              double brlx, double revp, double cosw, double sinw, T* u_out,
              T* v_out, T* stress_out, T* diagR, T* strint, T* scratch,
              unsigned int* sync, int aliased) {
  Sweep<T> S;
  S.ny = ny;
  S.nx = nx;
  S.nsub = nsub;
  S.cyc_x = cyc_x;
  S.cyc_y = cyc_y;
  S.fold = fold;
  S.cw_plane = cw_plane;
  S.aliased = aliased;
  S.Cw = T(Cw);
  S.P = make_params<T>(arlx1i, denom1, ecci, brlx, revp, cosw, sinw);
  S.u_in = u;
  S.v_in = v;
  S.stress_in = stress;
  S.maskR = maskR;
  S.strengthR = strengthR;
  S.gR = gR;
  S.uin = uin;
  S.u_out = u_out;
  S.v_out = v_out;
  S.stress_out = stress_out;
  S.diagR = diagR;
  S.strint = strint;
  S.xch = scratch;
  S.tile_stress = scratch + 4 * (size_t)ny * nx;
  S.sync = sync;
  return S;
}

}  // namespace

extern "C" {

// ndte subcycles in place on (u, v, stress); cyc_x/cyc_y: cyclic
// boundaries, fold: the tripole fold of a north seam (0 none, 1 U-fold,
// 2 T-fold). plan: the 6 ints
// of TilePlan.as_ints; scratch: TilePlan.scratch_values values; sync: one
// zeroed counter.
int evp_sweep_f32(int ny, int nx, int ndte, int cyc_x, int cyc_y, int fold,
                  float* u, float* v, float* stress, const float* maskR,
                  const float* strengthR, const float* gR, const float* uin,
                  int cw_plane, double Cw, double arlx1i, double denom1,
                  double ecci, double brlx, double revp, double cosw,
                  double sinw, float* diagR, float* strint, const int* plan,
                  float* scratch, unsigned int* sync, void* stream) {
  return run<float>(make<float>(ny, nx, ndte, cyc_x, cyc_y, fold, u, v,
                                stress, maskR, strengthR, gR, uin, cw_plane,
                                Cw, arlx1i, denom1, ecci, brlx, revp, cosw,
                                sinw, u, v, stress, diagR, strint, scratch,
                                sync, 1),
                    plan, stream);
}

int evp_sweep_f64(int ny, int nx, int ndte, int cyc_x, int cyc_y, int fold,
                  double* u, double* v, double* stress, const double* maskR,
                  const double* strengthR, const double* gR,
                  const double* uin, int cw_plane, double Cw, double arlx1i,
                  double denom1, double ecci, double brlx, double revp,
                  double cosw, double sinw, double* diagR, double* strint,
                  const int* plan, double* scratch, unsigned int* sync,
                  void* stream) {
  return run<double>(make<double>(ny, nx, ndte, cyc_x, cyc_y, fold, u, v,
                                  stress, maskR, strengthR, gR, uin,
                                  cw_plane, Cw, arlx1i, denom1, ecci, brlx,
                                  revp, cosw, sinw, u, v, stress, diagR,
                                  strint, scratch, sync, 1),
                     plan, stream);
}

// one chunk of K subcycles from (u, v, stress) into (u_out, v_out,
// stress_out), open or closed north-south, cyclic or not east-west
int evp_fused_f32(int ny, int nx, int K, int cyc_x, const float* u,
                  const float* v, const float* stress, const float* maskR,
                  const float* strengthR, const float* gR, const float* uin,
                  int cw_plane, double Cw, double arlx1i, double denom1,
                  double ecci, double brlx, double revp, double cosw,
                  double sinw, float* u_out, float* v_out, float* stress_out,
                  float* diagR, float* strint, const int* plan,
                  float* scratch, unsigned int* sync, void* stream) {
  return run<float>(make<float>(ny, nx, K, cyc_x, 0, 0, u, v, stress, maskR,
                                strengthR, gR, uin, cw_plane, Cw, arlx1i,
                                denom1, ecci, brlx, revp, cosw, sinw, u_out,
                                v_out, stress_out, diagR, strint, scratch,
                                sync, 0),
                    plan, stream);
}

int evp_fused_f64(int ny, int nx, int K, int cyc_x, const double* u,
                  const double* v, const double* stress, const double* maskR,
                  const double* strengthR, const double* gR,
                  const double* uin, int cw_plane, double Cw, double arlx1i,
                  double denom1, double ecci, double brlx, double revp,
                  double cosw, double sinw, double* u_out, double* v_out,
                  double* stress_out, double* diagR, double* strint,
                  const int* plan, double* scratch, unsigned int* sync,
                  void* stream) {
  return run<double>(make<double>(ny, nx, K, cyc_x, 0, 0, u, v, stress,
                                  maskR, strengthR, gR, uin, cw_plane, Cw,
                                  arlx1i, denom1, ecci, brlx, revp, cosw,
                                  sinw, u_out, v_out, stress_out, diagR,
                                  strint, scratch, sync, 0),
                     plan, stream);
}

// the card's SM count and the shared memory a block may opt in to
int evp_resident_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return (int)err;
}

// nbar grid barriers in one cooperative launch of `blocks` blocks of 512
// threads; mode 0: cooperative_groups' grid.sync(), 1: the sweep's split
// barrier (sync: one zeroed counter)
int evp_resident_barriers(int blocks, int nbar, int mode, unsigned int* sync,
                          void* stream) {
  void* args[] = {(void*)&nbar, (void*)&mode, (void*)&sync};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)barrier_probe, dim3(blocks), dim3(512), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* evp_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* evp_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
