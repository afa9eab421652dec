// Incremental-remap reconstruction + transport integrals of ONE edge set
// for NVIDIA Hopper (sm_90a).
//
// Replaces: the Pallas kernel integrals_tiled of the JAX package
// (cice5_tpu/ops/pallas/remap_flux.py:75), exported as
// remap_flux_edge_<type>: the reconstruction, then the integrals of the
// north or the east edges only. This is the device code of the first
// version of the merged kernel remap_flux_both (kernel B, now
// csrc/remap_tiles.cu, which computes with the same arithmetic in the same
// order), so each edge set's fluxes here equal B's bit for bit, and the
// checks hold B against it. From the RAW mass field mm (aicen), the
// class-sorted tracer stack tm and the ocean mask hm, each with a W=2
// ghost ring, it computes
//   1. the van-Leer limited linear reconstruction (centre value and x/y
//      gradients) of the mass field and of every tracer
//      (models/transport/remap.py:_reconstruct_ext; construct_fields,
//      ice_transport_remap.F90:1024-1316), on the one-ring domain, and
//   2. the quadratic transport integrals over the NGROUPS=6 departure
//      triangles of every edge of the set
//      (remap.py:_integrals; transport_integrals :3199-3512), with the
//      per-view weight maps of the JAX code: every tracer flux is
//      sum over the 6 donor views of Wc*tc + Wx*tx + Wy*ty.
// Tracer dependency types 1, 2 and 3: a type-2 tracer (e.g. the pond area
// apnd on the level-ice area alvl) is weighted by its type-1 parent, a
// type-3 tracer (the pond depth hpnd and lid ipnd on apnd) by its type-2
// parent and that parent's type-1 parent, the chain of remap.py:_integrals.
//
// Design: two kernels on the caller's stream. remap_recon writes the
// reconstruction (ncat, 3 + 3*ntrace, ny+2, nx+2) to a scratch tensor the
// wrapper allocates, one thread per (category, cell); remap_flux<EDGE>
// evaluates one edge per thread and reads the six donor cells of its
// views from that scratch. Every sum runs in a fixed order inside one
// thread: no atomics, so results are reproducible run to run.
//
// Ice skip: a block of edges whose raw-mass window (the W=2 cells every
// flux of the block reads through the reconstruction) holds no ice
// writes exact zeros without integrating, as the Pallas kernel does
// (remap_flux.py:216-233).
//
// Bound on the H100: memory. At 384x320, ncat=5, ntrace=18, float32 the
// call must read the raw tracer window (45 MB) and the triangle geometry
// of one edge set (about 24 MB) and write its fluxes (about 47 MB); this
// version also writes and re-reads the 141 MB reconstruction scratch.
// No model path calls it; moving it onto remap_tiles.cu's device code is
// later work.
#include <cuda_runtime.h>
#include <stddef.h>

#define REMAP_MAX_TRACERS 64

struct TracerTable {
  int n;
  int type[REMAP_MAX_TRACERS];
  int parent[REMAP_MAX_TRACERS];
};

namespace {

constexpr int NGROUPS = 6;
constexpr double PUNY = 1.0e-11;
// donor-cell codes (remap.py: TL, BL, TR, BR, TC, BC = range(6)) and the
// order the JAX code walks the donor views in (BC, TC, BL, TL, BR, TR)
enum { TL, BL, TR, BR, TC, BC };
__constant__ int kViewOrder[6] = {BC, TC, BL, TL, BR, TR};

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

// limited_gradient core (ice_transport_remap.F90:1344-1490) on a 3x3
// neighbourhood stored row-major with index (dj+1)*3 + (di+1)
template <typename T>
__device__ void limited_gradient(const T p[9], const T msk[9], T phimask,
                                 T cnx, T cny, T& gx_out, T& gy_out) {
  const T phi = p[4];
  T val[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) val[q] = msk[q] * p[q] + (T(1) - msk[q]) * phi;
  const T gx = (val[5] - val[3]) * T(0.5);
  const T gy = (val[7] - val[1]) * T(0.5);
  T mn = val[6], mx = val[6];
  // stack order of the JAX code: nw, n, ne, w, centre, e, sw, s, se
  const int order[9] = {6, 7, 8, 3, 4, 5, 0, 1, 2};
#pragma unroll
  for (int q = 1; q < 9; ++q) {
    const T x = order[q] == 4 ? phi : val[order[q]];
    mn = tmin(mn, x);
    mx = tmax(mx, x);
  }
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

// one thread per (category, one-ring cell): mc, mx, my and tc, tx, ty of
// every tracer, written to recon (ncat, 3 + 3*ntrace, ny+2, nx+2)
template <typename T>
__global__ void remap_recon(int ntrace, int ny, int nx, TracerTable tab,
                            const T* __restrict__ mmE2,
                            const T* __restrict__ tmE2,
                            const T* __restrict__ hmE2,
                            T* __restrict__ recon) {
  const int nyR = ny + 2, nxR = nx + 2;
  const int nx2 = nx + 4;
  const size_t np2 = (size_t)(ny + 4) * nx2;
  const size_t npR = (size_t)nyR * nxR;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (i >= nxR || j >= nyR) return;
  const T* mm = mmE2 + (size_t)c * np2;
  const T* tm = tmE2 + (size_t)c * ntrace * np2;
  T* out = recon + (size_t)c * (3 + 3 * ntrace) * npR;
  const size_t ko = (size_t)j * nxR + i;

  // one-ring cell (j, i) is two-ring cell (j+1, i+1); its 3x3 window
  size_t kk[9];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj)
#pragma unroll
    for (int di = 0; di < 3; ++di)
      kk[dj * 3 + di] = (size_t)(j + dj) * nx2 + (i + di);

  T m9[9], h9[9], me9[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    m9[q] = mm[kk[q]];
    h9[q] = hmE2[kk[q]];
    me9[q] = m9[q] > T(0) ? T(1) : T(0);
  }
  const T mmc = m9[4];
  T mxg, myg;
  limited_gradient(m9, h9, h9[4], T(0), T(0), mxg, myg);
  const T XXAV = T(1.0 / 12.0);
  const T denom = mmc > T(0) ? mmc : T(1);
  const T mxav = mmc > T(0) ? mxg * XXAV / denom : T(0);
  const T myav = mmc > T(0) ? myg * XXAV / denom : T(0);
  out[0 * npR + ko] = mmc;
  out[1 * npR + ko] = mxg;
  out[2 * npR + ko] = myg;

  T mtx[REMAP_MAX_TRACERS], mty[REMAP_MAX_TRACERS];
  for (int t = 0; t < ntrace; ++t) {
    const int ty = tab.type[t];
    const T* tt = tm + (size_t)t * np2;
    T tc, tx = T(0), tyv = T(0);
    if (ty == 1) {
      T p9[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) p9[q] = tt[kk[q]];
      limited_gradient(p9, me9, me9[4], mxav, myav, tx, tyv);
      tc = p9[4] - tx * mxav - tyv * myav;
      const T w2 = mmc * tx + mxg * tc;
      const T w3 = mmc * tyv + myg * tc;
      const T mt = mmc * p9[4];
      const T d2 = tabs(mt) > T(0) ? mt : T(1);
      const bool ok = tabs(mt) > T(PUNY);
      mtx[t] = ok ? (w2 * XXAV) / d2 : T(0);
      mty[t] = ok ? (w3 * XXAV) / d2 : T(0);
    } else if (ty == 2) {
      const int pa = tab.parent[t];
      const T* tp = tm + (size_t)pa * np2;
      T p9[9], k9[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        p9[q] = tt[kk[q]];
        k9[q] = (tabs(tp[kk[q]]) > T(0) ? T(1) : T(0)) * me9[q];
      }
      limited_gradient(p9, k9, k9[4], mtx[pa], mty[pa], tx, tyv);
      tc = p9[4] - tx * mtx[pa] - tyv * mty[pa];
    } else {
      tc = tt[kk[4]];
    }
    out[(3 + 3 * t) * npR + ko] = tc;
    out[(4 + 3 * t) * npR + ko] = tx;
    out[(5 + 3 * t) * npR + ko] = tyv;
  }
}

// one thread per (category, edge). EDGE 0: north edges, region
// (ny+1, nx); EDGE 1: east edges, region (ny, nx+1).
template <typename T, int EDGE>
__global__ void remap_flux(int ntrace, int ny, int nx, TracerTable tab,
                           const T* __restrict__ mmE2,
                           const T* __restrict__ recon,
                           const int* __restrict__ donor,
                           const T* __restrict__ triarea,
                           const T* __restrict__ qx,
                           const T* __restrict__ qy, T* __restrict__ mflx,
                           T* __restrict__ mtflx) {
  const int nyr = EDGE == 0 ? ny + 1 : ny;
  const int nxr = EDGE == 0 ? nx : nx + 1;
  const int nxR = nx + 2;
  const size_t npR = (size_t)(ny + 2) * nxR;
  const size_t npE = (size_t)nyr * nxr;
  const int c = blockIdx.z;
  const int i0 = blockIdx.x * blockDim.x, j0 = blockIdx.y * blockDim.y;
  const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;

  // block-level ice skip over the raw W=2 window of the block's edges
  const int nx2 = nx + 4, ny2 = ny + 4;
  const T* mm = mmE2 + (size_t)c * ny2 * nx2;
  const int wr = blockDim.y + 5, wc = blockDim.x + 5;
  int lit = 0;
  for (int q = threadIdx.y * blockDim.x + threadIdx.x; q < wr * wc;
       q += blockDim.x * blockDim.y) {
    const int jj = j0 + q / wc, ii = i0 + q % wc;
    if (jj < ny2 && ii < nx2 && mm[(size_t)jj * nx2 + ii] != T(0)) lit = 1;
  }
  lit = __syncthreads_or(lit);
  if (i >= nxr || j >= nyr) return;
  const size_t ke = (size_t)j * nxr + i;
  T* mfl = mflx + (size_t)c * npE;
  T* mtf = mtflx + (size_t)c * ntrace * npE;
  if (!lit) {
    mfl[ke] = T(0);
    for (int t = 0; t < ntrace; ++t) mtf[(size_t)t * npE + ke] = T(0);
    return;
  }

  // one-ring offsets of the six donor views (remap.py _nbr_views_*)
  size_t off[6];
  if (EDGE == 0) {
    off[BC] = (size_t)j * nxR + i + 1;
    off[TC] = (size_t)(j + 1) * nxR + i + 1;
    off[BL] = (size_t)j * nxR + i;
    off[TL] = (size_t)(j + 1) * nxR + i;
    off[BR] = (size_t)j * nxR + i + 2;
    off[TR] = (size_t)(j + 1) * nxR + i + 2;
  } else {
    off[BC] = (size_t)(j + 1) * nxR + i;
    off[TC] = (size_t)(j + 1) * nxR + i + 1;
    off[BL] = (size_t)(j + 2) * nxR + i;
    off[TL] = (size_t)(j + 2) * nxR + i + 1;
    off[BR] = (size_t)j * nxR + i;
    off[TR] = (size_t)j * nxR + i + 1;
  }
  const T* rc = recon + (size_t)c * (3 + 3 * ntrace) * npR;

  int dn[NGROUPS];
  T ta[NGROUPS], msum[NGROUPS], mxsum[NGROUPS], mysum[NGROUPS];
  T mxxsum[NGROUPS], mxysum[NGROUPS], myysum[NGROUPS];
  T qxs[NGROUPS][3], qys[NGROUPS][3];
  const T P333 = T(1.0 / 3.0);
  T mf = T(0);
#pragma unroll
  for (int g = 0; g < NGROUPS; ++g) {
    dn[g] = donor[g * npE + ke];
    ta[g] = triarea[g * npE + ke];
    const size_t od = off[dn[g]];
    const T mc_d = rc[od], mx_d = rc[npR + od], my_d = rc[2 * npR + od];
    T s = T(0), sx = T(0), sy = T(0), sxx = T(0), sxy = T(0), syy = T(0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const T x = qx[(g * 3 + q) * npE + ke];
      const T y = qy[(g * 3 + q) * npE + ke];
      qxs[g][q] = x;
      qys[g][q] = y;
      const T mq = P333 * (mc_d + x * mx_d + y * my_d);
      s += mq;
      sx += mq * x;
      sy += mq * y;
      sxx += mq * x * x;
      sxy += mq * x * y;
      syy += mq * y * y;
    }
    msum[g] = s;
    mxsum[g] = sx;
    mysum[g] = sy;
    mxxsum[g] = sxx;
    mxysum[g] = sxy;
    myysum[g] = syy;
    mf += ta[g] * s;
  }
  mfl[ke] = mf;

  // type-1 weight maps W1 (per donor view) and the per-parent maps of
  // the current type-2 class, rebuilt when the parent changes (the
  // stack is class-sorted, so each class is one contiguous run)
  T Wc1[6], Wx1[6], Wy1[6], Wcp[6], Wxp[6], Wyp[6];
#pragma unroll
  for (int v = 0; v < 6; ++v) {
    Wc1[v] = Wx1[v] = Wy1[v] = T(0);
#pragma unroll
    for (int g = 0; g < NGROUPS; ++g) {
      const bool on = dn[g] == v;
      Wc1[v] += on ? ta[g] * msum[g] : T(0);
      Wx1[v] += on ? ta[g] * mxsum[g] : T(0);
      Wy1[v] += on ? ta[g] * mysum[g] : T(0);
    }
  }
  int cur_parent = -1;
  for (int t = 0; t < ntrace; ++t) {
    const int ty = tab.type[t];
    const T *Wc = Wc1, *Wx = Wx1, *Wy = Wy1;
    if (ty >= 2) {
      const int pa = tab.parent[t];
      if (pa != cur_parent) {
        cur_parent = pa;
        const T* tcp = rc + (size_t)(3 + 3 * pa) * npR;
        const T* txp = tcp + npR;
        const T* typ = txp + npR;
        // a type-2 parent weights by its own type-1 parent's group sums
        const int gp = tab.type[pa] == 1 ? -1 : tab.parent[pa];
        const T* tcg = rc + (size_t)(3 + 3 * (gp < 0 ? 0 : gp)) * npR;
        const T* txg = tcg + npR;
        const T* tyg = txg + npR;
#pragma unroll
        for (int v = 0; v < 6; ++v) Wcp[v] = Wxp[v] = Wyp[v] = T(0);
#pragma unroll
        for (int g = 0; g < NGROUPS; ++g) {
          const size_t od = off[dn[g]];
          const T a = tcp[od], b = txp[od], d = typ[od];
          T mts, mtx = T(0), mty = T(0);
          if (gp < 0) {
            mts = msum[g] * a + mxsum[g] * b + mysum[g] * d;
            mtx = mxsum[g] * a + mxxsum[g] * b + mxysum[g] * d;
            mty = mysum[g] * a + mxysum[g] * b + myysum[g] * d;
          } else {
            const T ga = tcg[od], gb = txg[od], gd = tyg[od];
            const T pts = msum[g] * ga + mxsum[g] * gb + mysum[g] * gd;
            const T ptx = mxsum[g] * ga + mxxsum[g] * gb + mxysum[g] * gd;
            const T pty = mysum[g] * ga + mxysum[g] * gb + myysum[g] * gd;
            mts = pts * a + ptx * b + pty * d;
          }
#pragma unroll
          for (int v = 0; v < 6; ++v) {
            const bool on = dn[g] == v;
            Wcp[v] += on ? ta[g] * mts : T(0);
            Wxp[v] += on ? ta[g] * mtx : T(0);
            Wyp[v] += on ? ta[g] * mty : T(0);
          }
        }
      }
      Wc = Wcp;
      Wx = Wxp;
      Wy = Wyp;
    }
    const T* tcv = rc + (size_t)(3 + 3 * t) * npR;
    const T* txv = tcv + npR;
    const T* tyv = txv + npR;
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int v = kViewOrder[q];
      const size_t o = off[v];
      T term = Wc[v] * tcv[o];
      if (ty <= 2) {
        term = term + Wx[v] * txv[o];
        term = term + Wy[v] * tyv[o];
      }
      acc = q == 0 ? term : acc + term;
    }
    mtf[(size_t)t * npE + ke] = acc;
  }
}

// TracerTable of the caller's types and parents, or false past its room
bool make_table(int ntrace, const int* ttype, const int* parent,
                TracerTable& tab) {
  if (ntrace > REMAP_MAX_TRACERS) return false;
  tab.n = ntrace;
  for (int t = 0; t < ntrace; ++t) {
    tab.type[t] = ttype[t];
    tab.parent[t] = parent[t];
  }
  return true;
}

// the reconstruction, then one edge set's integrals (east: 0 north, 1 east)
template <typename T>
int run_edge(int east, int ncat, int ntrace, int ny, int nx,
             const int* ttype, const int* parent, const T* mmE2,
             const T* tmE2, const T* hmE2, const int* dn, const T* ta,
             const T* qx, const T* qy, T* recon, T* mflx, T* mtflx,
             void* stream) {
  TracerTable tab;
  if (!make_table(ntrace, ttype, parent, tab))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(32, 8);
  const dim3 grid_c((nx + 2 + 31) / 32, (ny + 2 + 7) / 8, ncat);
  remap_recon<T><<<grid_c, block, 0, s>>>(ntrace, ny, nx, tab, mmE2, tmE2,
                                          hmE2, recon);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (east) {
    const dim3 grid_e((nx + 1 + 31) / 32, (ny + 7) / 8, ncat);
    remap_flux<T, 1><<<grid_e, block, 0, s>>>(ntrace, ny, nx, tab, mmE2,
                                              recon, dn, ta, qx, qy, mflx,
                                              mtflx);
  } else {
    const dim3 grid_n((nx + 31) / 32, (ny + 1 + 7) / 8, ncat);
    remap_flux<T, 0><<<grid_n, block, 0, s>>>(ntrace, ny, nx, tab, mmE2,
                                              recon, dn, ta, qx, qy, mflx,
                                              mtflx);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int remap_flux_edge_f32(int east, int ncat, int ntrace, int ny, int nx,
                        const int* ttype, const int* parent,
                        const float* mmE2, const float* tmE2,
                        const float* hmE2, const int* dn, const float* ta,
                        const float* qx, const float* qy, float* recon,
                        float* mflx, float* mtflx, void* stream) {
  return run_edge<float>(east, ncat, ntrace, ny, nx, ttype, parent, mmE2,
                         tmE2, hmE2, dn, ta, qx, qy, recon, mflx, mtflx,
                         stream);
}

int remap_flux_edge_f64(int east, int ncat, int ntrace, int ny, int nx,
                        const int* ttype, const int* parent,
                        const double* mmE2, const double* tmE2,
                        const double* hmE2, const int* dn, const double* ta,
                        const double* qx, const double* qy, double* recon,
                        double* mflx, double* mtflx, void* stream) {
  return run_edge<double>(east, ncat, ntrace, ny, nx, ttype, parent, mmE2,
                          tmE2, hmE2, dn, ta, qx, qy, recon, mflx, mtflx,
                          stream);
}

const char* remap_flux_edge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
