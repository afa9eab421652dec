// Incremental-remap reconstruction + transport integrals of both edge sets,
// or of one, for NVIDIA Hopper (sm_90a), one launch per call, the
// reconstruction of a tile kept in shared memory.
//
// Replaces: the Pallas kernels integrals_tiled_both (both edge sets,
// exported as remap_flux_both_<type>) and integrals_tiled (one edge set,
// exported as remap_flux_edge_<type>) of the JAX package
// (cice5_tpu/ops/pallas/remap_flux.py:163 and :75). From the RAW mass field
// mm (aicen), the class-sorted tracer stack tm and the ocean mask hm, each
// with a W=2 ghost ring (the tripole fold or the cyclic wrap is already in
// them), it computes
//   1. the van-Leer limited linear reconstruction (centre value and x/y
//      gradients) of the mass field and of every tracer
//      (models/transport/remap.py:_reconstruct_ext; construct_fields,
//      ice_transport_remap.F90:1024-1316), and
//   2. the quadratic transport integrals over the NGROUPS=6 departure
//      triangles of every north and east edge
//      (remap.py:_integrals; transport_integrals :3199-3512): every tracer
//      flux is the sum over the 6 donor views of Wc*tc + Wx*tx + Wy*ty,
//      with per-view weight maps W built from the triangle group sums.
// Tracer dependency types 1, 2 and 3: a type-2 tracer (the pond area apnd
// on the level-ice area alvl) is weighted by its type-1 parent, a type-3
// tracer (the pond depth hpnd and lid ipnd on apnd) by its type-2 parent
// and that parent's type-1 parent.
//
// Design. One block of 512 threads per (category, tile of 8x32 edge
// points); block b takes category b % ncat of tile b / ncat, so a tile's
// categories run back to back and its edge geometry comes from device
// memory once per call (the other categories find it in L2); a block
// that skips reads none. Threads 0-255 own the north edges of the tile,
// 256-511 its east edges.
//   - One edge set (the template's EDGES 0 north, 1 east; 2 is both): the
//     same blocks and pipeline, threads 0-255 own the tile's edges of the
//     set and 256-511 take part in the loads and the reconstruction only.
//     The pipeline's stages need 432 (raw window) and 340 (one-ring
//     window) threads, so a 256-thread block would loop twice per stage,
//     and a 16x32 tile of one set would need a 612-cell window; the idle
//     half costs a skipped integration per step. Each edge is computed by
//     the code that computes it in the two-set kernel, so the one-set
//     kernel's fluxes equal that half of the two-set call bit for bit.
//   - Ice skip first: the block reads its category's raw mm window
//     ((8+4) x (32+4) cells, every cell a flux of the tile reaches through
//     the reconstruction); if it holds no ice the block writes exact zeros
//     for its edges and reads neither tracers nor geometry (the Pallas
//     kernel's block skip, remap_flux.py:216-233).
//   - The reconstruction lives in shared memory, tracer by tracer, in a
//     three-stage pipeline with one __syncthreads per stage step: while the
//     edge threads integrate tracer t-2 from its reconstruction, threads
//     0-339 rebuild tracer t-1 on the one-ring window ((8+2) x (32+2)
//     cells) from its raw window, and threads 0-431 load tracer t's raw
//     window. Raw windows and reconstructions are double-buffered.
//   - Parents stay: the stack is class-sorted with parents first
//     (remap.py:tracer_table), so the reconstruction (tc, tx, ty, and for a
//     type-1 parent its mtx, mty and the nonzero mask of its raw window) of
//     every tracer that is a parent is written to a slot of its own and
//     read there by its dependents until the end of the block.
//   - Registers (at most 64 in float32, so two blocks share an SM; 128 in
//     float64): an edge thread keeps only the six views' weight maps of
//     the current class (18 values: the type-1 class comes first, and no
//     class returns); the triangle group sums are rebuilt, group by group,
//     from the geometry when a parent class starts (2 times per call with
//     the BL99 table, 4 with the gx1-parity one), so no per-thread array
//     is indexed at run time. A thread loads its raw window cell of the
//     next tracer one step ahead, so the load's latency hides behind the
//     step.
// The arithmetic is that of the plain version (remap.py:_reconstruct_ext,
// _integrals) in the same order, built without FMA contraction.
//
// Bound on the H100: memory. At 384x320, ncat=5, ntrace=18, float32 the
// call must read the raw fields (45 MB) and the triangle geometry of both
// edge sets (about 47 MB) and write the fluxes (about 93 MB), some 185 MB
// or 55 us at 3.35 TB/s where every tile holds ice (BL99); with ice on a
// tenth of the ocean (gx1-parity) the reads shrink to the tiles within
// reach of ice and the flux writes (exact zeros elsewhere) dominate. The
// arithmetic (a few thousand operations per edge and category) is a few
// tens of microseconds in float32. One edge set moves half the geometry
// and the fluxes, and the same raw fields.
#include <cuda_runtime.h>
#include <stddef.h>

#define REMAP_MAX_TRACERS 64

namespace {

constexpr int NGROUPS = 6;
constexpr double PUNY = 1.0e-11;
// donor-cell codes (remap.py: TL, BL, TR, BR, TC, BC = range(6))
enum { TL, BL, TR, BR, TC, BC };

constexpr int TY = 8, TX = 32;             // edge points of a tile
constexpr int RY = TY + 2, RX = TX + 2;    // its one-ring reconstruction
constexpr int WY = TY + 4, WX = TX + 4;    // its raw W=2 window
constexpr int NR = RY * RX, NW = WY * WX;  // 340, 432
constexpr int NEDGE = TY * TX;             // edges of one set per tile
constexpr int THREADS = 2 * NEDGE;         // north half, east half

struct Table {
  int nslot;
  signed char type[REMAP_MAX_TRACERS];
  signed char parent[REMAP_MAX_TRACERS];
  signed char slot[REMAP_MAX_TRACERS];     // -1: not a parent
};

// the order the JAX code walks the donor views in: BC, TC, BL, TL, BR, TR
__device__ __forceinline__ constexpr int view_order(int q) {
  return q == 0 ? BC : q == 1 ? TC : q == 2 ? BL : q == 3 ? TL
       : q == 4 ? BR : TR;
}

// offset in the one-ring window of donor view v of edge (ly, lx)
// (remap.py _nbr_views_north / _nbr_views_east)
__device__ __forceinline__ int view_off(bool east, int v, int ly, int lx) {
  int dy, dx;
  if (!east) {
    dy = (v == TC || v == TL || v == TR) ? 1 : 0;
    dx = (v == BL || v == TL) ? 0 : (v == BC || v == TC) ? 1 : 2;
  } else {
    dy = (v == BR || v == TR) ? 0 : (v == BC || v == TC) ? 1 : 2;
    dx = (v == BC || v == BL || v == BR) ? 0 : 1;
  }
  return (ly + dy) * RX + lx + dx;
}

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

// limited_gradient core (ice_transport_remap.F90:1344-1490) on a 3x3
// neighbourhood stored row-major with index (dj+1)*3 + (di+1)
template <typename T>
__device__ __forceinline__ void limited_gradient(const T p[9],
                                                 const T msk[9], T phimask,
                                                 T cnx, T cny, T& gx_out,
                                                 T& gy_out) {
  const T phi = p[4];
  T val[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) val[q] = msk[q] * p[q] + (T(1) - msk[q]) * phi;
  const T gx = (val[5] - val[3]) * T(0.5);
  const T gy = (val[7] - val[1]) * T(0.5);
  // stack order of the JAX code: nw, n, ne, w, centre, e, sw, s, se
  T mn = val[6], mx = val[6];
  mn = tmin(mn, val[7]); mx = tmax(mx, val[7]);
  mn = tmin(mn, val[8]); mx = tmax(mx, val[8]);
  mn = tmin(mn, val[3]); mx = tmax(mx, val[3]);
  mn = tmin(mn, phi);    mx = tmax(mx, phi);
  mn = tmin(mn, val[5]); mx = tmax(mx, val[5]);
  mn = tmin(mn, val[0]); mx = tmax(mx, val[0]);
  mn = tmin(mn, val[1]); mx = tmax(mx, val[1]);
  mn = tmin(mn, val[2]); mx = tmax(mx, val[2]);
  const T pmn = mn - phi, pmx = mx - phi;
  const T w1 = (T(0.5) - cnx) * gx + (T(0.5) - cny) * gy;
  const T w2 = (T(0.5) - cnx) * gx - (T(0.5) + cny) * gy;
  const T w3 = -(T(0.5) + cnx) * gx - (T(0.5) + cny) * gy;
  const T w4 = (T(0.5) - cny) * gy - (T(0.5) + cnx) * gx;
  const T qmn = tmin(tmin(w1, w2), tmin(w3, w4));
  const T qmx = tmax(tmax(w1, w2), tmax(w3, w4));
  const T lim1 = tabs(qmn) > tabs(pmn)
                     ? tmax(T(0), pmn / (qmn != T(0) ? qmn : T(1))) : T(1);
  const T lim2 = tabs(qmx) > tabs(pmx)
                     ? tmax(T(0), pmx / (qmx != T(0) ? qmx : T(1))) : T(1);
  const T lim = tmin(lim1, lim2);
  const bool keep = phimask > T(PUNY);
  gx_out = keep ? lim * gx : T(0);
  gy_out = keep ? lim * gy : T(0);
}

// the six triangle-group sums of group g of one edge over the quadrature
// points, from the mass reconstruction at the group's donor cell
template <typename T>
struct GroupSums {
  T s, sx, sy, sxx, sxy, syy;
};

template <typename T>
__device__ __forceinline__ GroupSums<T> group_sums(
    const T* __restrict__ qx, const T* __restrict__ qy, int npE, int ke,
    int g, const T* mass, int od) {
  const T P333 = T(1.0 / 3.0);
  const T mc_d = mass[od], mx_d = mass[NR + od], my_d = mass[2 * NR + od];
  GroupSums<T> r;
  r.s = r.sx = r.sy = r.sxx = r.sxy = r.syy = T(0);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const T x = qx[(g * 3 + q) * npE + ke];
    const T y = qy[(g * 3 + q) * npE + ke];
    const T mq = P333 * (mc_d + x * mx_d + y * my_d);
    r.s += mq;
    r.sx += mq * x;
    r.sy += mq * y;
    r.sxx += mq * x * x;
    r.sxy += mq * x * y;
    r.syy += mq * y * y;
  }
  return r;
}

// shared memory of one block, in values of T (plan: ops/remap_tiles.py)
__host__ __device__ constexpr size_t smem_values(int nslot) {
  // mm and hm windows, 2 raw tracer windows, a raw mask per slot;
  // mass reconstruction (mc, mx, my, mxav, myav), 2 tracer
  // reconstructions (tc, tx, ty), 5 planes per slot (tc, tx, ty, mtx, mty)
  return (size_t)NW * (4 + nslot) + (size_t)NR * (5 + 6 + 5 * nslot);
}

template <typename T, int EDGES>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
remap_tiles(int ncat, int ntrace, int ny, int nx, int ntx, Table tab,
            const T* __restrict__ mmE2, const T* __restrict__ tmE2,
            const T* __restrict__ hmE2, const int* __restrict__ dnN,
            const T* __restrict__ taN, const T* __restrict__ qxN,
            const T* __restrict__ qyN, const int* __restrict__ dnE,
            const T* __restrict__ taE, const T* __restrict__ qxE,
            const T* __restrict__ qyE, T* __restrict__ fn_mflx,
            T* __restrict__ fn_mtflx, T* __restrict__ fe_mflx,
            T* __restrict__ fe_mtflx) {
  extern __shared__ unsigned char smem_bytes[];
  T* mmw = reinterpret_cast<T*>(smem_bytes);
  T* hmw = mmw + NW;
  T* raw = hmw + NW;                       // [2][NW]
  T* pmask = raw + 2 * NW;                 // [nslot][NW]
  T* mass = pmask + tab.nslot * NW;  // [5][NR]
  T* rec = mass + 5 * NR;                  // [2][3][NR]
  T* slots = rec + 6 * NR;                 // [nslot][5][NR]

  const int c = blockIdx.x % ncat;
  const int tile = blockIdx.x / ncat;
  const int j0 = (tile / ntx) * TY, i0 = (tile % ntx) * TX;
  const int tid = threadIdx.x;
  // 32-bit offsets (the wrapper refuses arrays of 2^31 values or more):
  // few registers per thread, pointers are formed where they are used
  const int nx2 = nx + 4, ny2 = ny + 4;
  const int np2 = ny2 * nx2;

  // this thread's cell of the raw window (tid < NW)
  const int gj = j0 + tid / WX, gi = i0 + tid % WX;
  const bool in_win = tid < NW && gj < ny2 && gi < nx2;
  const int gw = gj * nx2 + gi;
  const T mval = in_win ? mmE2[c * np2 + gw] : T(0);
  if (tid < NW) mmw[tid] = mval;

  // this thread's edge: north (ny+1, nx) or east (ny, nx+1); with one
  // edge set, threads NEDGE.. own none
  const bool east = EDGES == 2 ? tid >= NEDGE : EDGES == 1;
  const int e = tid >= NEDGE ? tid - NEDGE : tid;
  const int ly = e / TX, lx = e % TX;
  const int j = j0 + ly, i = i0 + lx;
  const int nyr = east ? ny : ny + 1, nxr = east ? nx + 1 : nx;
  const bool valid = (EDGES == 2 || tid < NEDGE) && j < nyr && i < nxr;
  const int npE = nyr * nxr;
  const int ke = j * nxr + i;                   // edge in its set's plane
  const int kt = c * ntrace * npE + ke;         // its tracer 0 flux

  if (!__syncthreads_or(mval != T(0))) {
    if (valid) {
      (east ? fe_mflx : fn_mflx)[c * npE + ke] = T(0);
      for (int t = 0; t < ntrace; ++t)
        (east ? fe_mtflx : fn_mtflx)[kt + t * npE] = T(0);
    }
    return;
  }
  const int tm0 = c * ntrace * np2 + gw;        // tracer 0's window cell
  if (tid < NW) hmw[tid] = in_win ? hmE2[gw] : T(0);
  __syncthreads();

  // this thread's cell of the one-ring window (tid < NR) and the top-left
  // corner of its 3x3 neighbourhood in the raw window
  const int wbase = (tid / RX) * WX + tid % RX;
  const bool recon_thread = tid < NR;

  // the weight maps of the current class: the type-1 class first, then
  // each parent's class in turn (the stack is class-sorted, make_table)
  T Wc[6], Wx[6], Wy[6];
#pragma unroll
  for (int v = 0; v < 6; ++v) Wc[v] = Wx[v] = Wy[v] = T(0);
  int cur_parent = -1;
  // tracer 0's raw value of this thread's window cell, loaded a step ahead
  T next = (ntrace > 0 && in_win) ? tmE2[tm0] : T(0);

  // step k: load tracer k's raw window, rebuild tracer k-1 (k-1 = -1: the
  // mass field), integrate tracer k-2 (-1: the mass flux)
  for (int k = 0; k <= ntrace + 1; ++k) {
    // ---- load tracer k's raw window
    if (k < ntrace && tid < NW) {
      const T v = next;
      if (k + 1 < ntrace) next = in_win ? tmE2[tm0 + (k + 1) * np2] : T(0);
      raw[(k & 1) * NW + tid] = v;
      const int s = tab.slot[k];
      if (s >= 0 && tab.type[k] == 1)
        pmask[s * NW + tid] = tabs(v) > T(0) ? T(1) : T(0);
    }
    // ---- rebuild tracer r = k-1 on the one-ring window
    const int r = k - 1;
    if (recon_thread && r < ntrace) {
      T me9[9];
#pragma unroll
      for (int q = 0; q < 9; ++q)
        me9[q] = mmw[wbase + (q / 3) * WX + q % 3] > T(0) ? T(1) : T(0);
      if (r < 0) {
        T m9[9], h9[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          m9[q] = mmw[wbase + (q / 3) * WX + q % 3];
          h9[q] = hmw[wbase + (q / 3) * WX + q % 3];
        }
        const T mmc = m9[4];
        T mxg, myg;
        limited_gradient(m9, h9, h9[4], T(0), T(0), mxg, myg);
        const T XXAV = T(1.0 / 12.0);
        const T denom = mmc > T(0) ? mmc : T(1);
        mass[tid] = mmc;
        mass[NR + tid] = mxg;
        mass[2 * NR + tid] = myg;
        mass[3 * NR + tid] = mmc > T(0) ? mxg * XXAV / denom : T(0);
        mass[4 * NR + tid] = mmc > T(0) ? myg * XXAV / denom : T(0);
      } else {
        const T* rw = raw + (r & 1) * NW;
        const int ty = tab.type[r];
        const int s = tab.slot[r];
        T* out = s >= 0 ? slots + s * 5 * NR : rec + (r & 1) * 3 * NR;
        T tc, tx = T(0), tyv = T(0);
        if (ty == 1) {
          T p9[9];
#pragma unroll
          for (int q = 0; q < 9; ++q) p9[q] = rw[wbase + (q / 3) * WX + q % 3];
          const T mxav = mass[3 * NR + tid], myav = mass[4 * NR + tid];
          limited_gradient(p9, me9, me9[4], mxav, myav, tx, tyv);
          tc = p9[4] - tx * mxav - tyv * myav;
          if (s >= 0) {
            const T XXAV = T(1.0 / 12.0);
            const T mmc = mass[tid], mxg = mass[NR + tid];
            const T myg = mass[2 * NR + tid];
            const T w2 = mmc * tx + mxg * tc;
            const T w3 = mmc * tyv + myg * tc;
            const T mt = mmc * p9[4];
            const T d2 = tabs(mt) > T(0) ? mt : T(1);
            const bool ok = tabs(mt) > T(PUNY);
            out[3 * NR + tid] = ok ? (w2 * XXAV) / d2 : T(0);
            out[4 * NR + tid] = ok ? (w3 * XXAV) / d2 : T(0);
          }
        } else if (ty == 2) {
          const int ps = tab.slot[tab.parent[r]];
          const T* pm = pmask + ps * NW;
          const T* par = slots + ps * 5 * NR;
          T p9[9], k9[9];
#pragma unroll
          for (int q = 0; q < 9; ++q) {
            const int o = wbase + (q / 3) * WX + q % 3;
            p9[q] = rw[o];
            k9[q] = pm[o] * me9[q];
          }
          const T mtxp = par[3 * NR + tid], mtyp = par[4 * NR + tid];
          limited_gradient(p9, k9, k9[4], mtxp, mtyp, tx, tyv);
          tc = p9[4] - tx * mtxp - tyv * mtyp;
        } else {
          tc = rw[wbase + WX + 1];
        }
        out[tid] = tc;
        out[NR + tid] = tx;
        out[2 * NR + tid] = tyv;
      }
    }
    // ---- integrate tracer f = k-2 (-1: the mass flux and the type-1 maps)
    const int f = k - 2;
    if (valid && f >= -1) {
      if (f < 0) {
        T mf = T(0);
#pragma unroll 1
        for (int g = 0; g < NGROUPS; ++g) {
          const int d = (east ? dnE : dnN)[g * npE + ke];
          const T a = (east ? taE : taN)[g * npE + ke];
          const GroupSums<T> gs = group_sums(
              east ? qxE : qxN, east ? qyE : qyN, npE, ke, g, mass,
              view_off(east, d, ly, lx));
          mf += a * gs.s;
#pragma unroll
          for (int v = 0; v < 6; ++v) {
            const bool on = d == v;
            Wc[v] += on ? a * gs.s : T(0);
            Wx[v] += on ? a * gs.sx : T(0);
            Wy[v] += on ? a * gs.sy : T(0);
          }
        }
        (east ? fe_mflx : fn_mflx)[c * npE + ke] = mf;
      } else {
        const int ty = tab.type[f];
        if (ty >= 2 && tab.parent[f] != cur_parent) {
          // the maps of the class on parent pa (a type-2 parent weights by
          // its own type-1 parent's group sums)
          const int pa = tab.parent[f];
          cur_parent = pa;
          const T* P = slots + tab.slot[pa] * 5 * NR;
          const int gp = tab.type[pa] == 1 ? -1 : tab.parent[pa];
          const T* G = slots + (gp < 0 ? 0 : tab.slot[gp]) * 5 * NR;
#pragma unroll
          for (int v = 0; v < 6; ++v) Wc[v] = Wx[v] = Wy[v] = T(0);
#pragma unroll 1
          for (int g = 0; g < NGROUPS; ++g) {
            const int d = (east ? dnE : dnN)[g * npE + ke];
            const T a = (east ? taE : taN)[g * npE + ke];
            const int od = view_off(east, d, ly, lx);
            const GroupSums<T> gs = group_sums(
                east ? qxE : qxN, east ? qyE : qyN, npE, ke, g, mass, od);
            const T pa_c = P[od], pa_x = P[NR + od], pa_y = P[2 * NR + od];
            T mts, mtx = T(0), mty = T(0);
            if (gp < 0) {
              mts = gs.s * pa_c + gs.sx * pa_x + gs.sy * pa_y;
              mtx = gs.sx * pa_c + gs.sxx * pa_x + gs.sxy * pa_y;
              mty = gs.sy * pa_c + gs.sxy * pa_x + gs.syy * pa_y;
            } else {
              const T ga = G[od], gb = G[NR + od], gd = G[2 * NR + od];
              const T pts = gs.s * ga + gs.sx * gb + gs.sy * gd;
              const T ptx = gs.sx * ga + gs.sxx * gb + gs.sxy * gd;
              const T pty = gs.sy * ga + gs.sxy * gb + gs.syy * gd;
              mts = pts * pa_c + ptx * pa_x + pty * pa_y;
            }
#pragma unroll
            for (int v = 0; v < 6; ++v) {
              const bool on = d == v;
              Wc[v] += on ? a * mts : T(0);
              Wx[v] += on ? a * mtx : T(0);
              Wy[v] += on ? a * mty : T(0);
            }
          }
        }
        const int s = tab.slot[f];
        const T* R = s >= 0 ? slots + s * 5 * NR
                            : rec + (f & 1) * 3 * NR;
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const int v = view_order(q);
          const int o = view_off(east, v, ly, lx);
          T term = Wc[v] * R[o];
          if (ty <= 2) {
            term = term + Wx[v] * R[NR + o];
            term = term + Wy[v] * R[2 * NR + o];
          }
          acc = q == 0 ? term : acc + term;
        }
        (east ? fe_mtflx : fn_mtflx)[kt + f * npE] = acc;
      }
    }
    __syncthreads();
  }
}

// the kernel's table: types, parents, and a slot for every tracer that is
// the parent of another, in stack order; false where it does not fit or
// the stack is not class-sorted (remap.py:tracer_table)
bool make_table(int ntrace, const int* ttype, const int* parent,
                Table& tab) {
  if (ntrace < 1 || ntrace > REMAP_MAX_TRACERS) return false;
  tab.nslot = 0;
  bool is_parent[REMAP_MAX_TRACERS] = {};
  for (int t = 0; t < ntrace; ++t) {
    if (ttype[t] < 1 || ttype[t] > 3) return false;
    if (ttype[t] >= 2) {
      if (parent[t] < 0 || parent[t] >= t) return false;
      is_parent[parent[t]] = true;
    }
    // class-sorted: types in order, each parent's class contiguous
    if (t > 0 && (ttype[t] < ttype[t - 1]
                  || (ttype[t] == ttype[t - 1] && ttype[t] >= 2
                      && parent[t] < parent[t - 1])))
      return false;
  }
  for (int t = 0; t < ntrace; ++t) {
    tab.type[t] = (signed char)ttype[t];
    tab.parent[t] = (signed char)(ttype[t] >= 2 ? parent[t] : -1);
    tab.slot[t] = (signed char)(is_parent[t] ? tab.nslot++ : -1);
  }
  return true;
}

template <typename T, int EDGES>
int run(int ncat, int ntrace, int ny, int nx, const int* ttype,
        const int* parent, const T* mmE2, const T* tmE2, const T* hmE2,
        const int* dnN, const T* taN, const T* qxN, const T* qyN,
        const int* dnE, const T* taE, const T* qxE, const T* qyE,
        T* fn_mflx, T* fn_mtflx, T* fe_mflx, T* fe_mtflx, void* stream) {
  Table tab;
  if (ncat < 1 || !make_table(ntrace, ttype, parent, tab))
    return (int)cudaErrorInvalidValue;
  // the kernel's 32-bit offsets
  if ((size_t)ncat * ntrace * (ny + 4) * (nx + 4) >= ((size_t)1 << 31)
      || (size_t)ncat * ntrace * (ny + 1) * (nx + 1) >= ((size_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_values(tab.nslot) * sizeof(T);
  // the attribute once per size, so a later call (or its CUDA graph
  // capture) issues the launch alone
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        remap_tiles<T, EDGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int nty = (ny + 1 + TY - 1) / TY, ntx = (nx + 1 + TX - 1) / TX;
  const unsigned blocks = (unsigned)ncat * nty * ntx;
  remap_tiles<T, EDGES><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      ncat, ntrace, ny, nx, ntx, tab, mmE2, tmE2, hmE2, dnN, taN, qxN, qyN,
      dnE, taE, qxE, qyE, fn_mflx, fn_mtflx, fe_mflx, fe_mtflx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int remap_flux_both_f32(int ncat, int ntrace, int ny, int nx,
                        const int* ttype, const int* parent,
                        const float* mmE2, const float* tmE2,
                        const float* hmE2, const int* dnN, const float* taN,
                        const float* qxN, const float* qyN, const int* dnE,
                        const float* taE, const float* qxE, const float* qyE,
                        float* fn_mflx, float* fn_mtflx, float* fe_mflx,
                        float* fe_mtflx, void* stream) {
  return run<float, 2>(ncat, ntrace, ny, nx, ttype, parent, mmE2, tmE2,
                       hmE2, dnN, taN, qxN, qyN, dnE, taE, qxE, qyE, fn_mflx,
                       fn_mtflx, fe_mflx, fe_mtflx, stream);
}

int remap_flux_both_f64(int ncat, int ntrace, int ny, int nx,
                        const int* ttype, const int* parent,
                        const double* mmE2, const double* tmE2,
                        const double* hmE2, const int* dnN,
                        const double* taN, const double* qxN,
                        const double* qyN, const int* dnE, const double* taE,
                        const double* qxE, const double* qyE,
                        double* fn_mflx, double* fn_mtflx, double* fe_mflx,
                        double* fe_mtflx, void* stream) {
  return run<double, 2>(ncat, ntrace, ny, nx, ttype, parent, mmE2, tmE2,
                        hmE2, dnN, taN, qxN, qyN, dnE, taE, qxE, qyE, fn_mflx,
                        fn_mtflx, fe_mflx, fe_mtflx, stream);
}

const char* remap_flux_both_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// one edge set (east = 0: the north edges (ny+1, nx), 1: the east edges
// (ny, nx+1)) with its geometry (dn, ta, qx, qy) and fluxes
int remap_flux_edge_f32(int east, int ncat, int ntrace, int ny, int nx,
                        const int* ttype, const int* parent,
                        const float* mmE2, const float* tmE2,
                        const float* hmE2, const int* dn, const float* ta,
                        const float* qx, const float* qy, float* mflx,
                        float* mtflx, void* stream) {
  if (east)
    return run<float, 1>(ncat, ntrace, ny, nx, ttype, parent, mmE2, tmE2,
                         hmE2, nullptr, nullptr, nullptr, nullptr, dn, ta,
                         qx, qy, nullptr, nullptr, mflx, mtflx, stream);
  return run<float, 0>(ncat, ntrace, ny, nx, ttype, parent, mmE2, tmE2, hmE2,
                       dn, ta, qx, qy, nullptr, nullptr, nullptr, nullptr,
                       mflx, mtflx, nullptr, nullptr, stream);
}

int remap_flux_edge_f64(int east, int ncat, int ntrace, int ny, int nx,
                        const int* ttype, const int* parent,
                        const double* mmE2, const double* tmE2,
                        const double* hmE2, const int* dn, const double* ta,
                        const double* qx, const double* qy, double* mflx,
                        double* mtflx, void* stream) {
  if (east)
    return run<double, 1>(ncat, ntrace, ny, nx, ttype, parent, mmE2, tmE2,
                          hmE2, nullptr, nullptr, nullptr, nullptr, dn, ta,
                          qx, qy, nullptr, nullptr, mflx, mtflx, stream);
  return run<double, 0>(ncat, ntrace, ny, nx, ttype, parent, mmE2, tmE2,
                        hmE2, dn, ta, qx, qy, nullptr, nullptr, nullptr,
                        nullptr, mflx, mtflx, nullptr, nullptr, stream);
}

const char* remap_flux_edge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
