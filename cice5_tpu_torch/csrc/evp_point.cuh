// The per-point arithmetic of one EVP subcycle, used by both entries of
// the EVP kernel (evp_resident.cu) so that it computes every point with
// the same operations in the same order as the plain version
// (models/dynamics/evp.py:stress_kernel, models/dynamics/shared.py:stepu).
// Built without FMA contraction (ops/kernels.py NVCC_FLAGS), the kernel
// then rounds like the plain version.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace evp {

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

// sqrt(x) and a / b for b > 0, the IEEE-rounded results bit for bit, with
// an exact zero kept out of the rounding routine: sqrt(+-0) = +-0 and
// +-0 / b = +-0, but a zero input takes the routine's slow path, whose
// cost the whole warp pays, and land and ice-free points (zero strain,
// zero strength, zero velocity) give zeros everywhere. The routine sees
// 1 in their place, so the compiler may evaluate it for every lane.
template <typename T>
__device__ __forceinline__ T sqrt_z(T x) {
  const T r = sqrt(x == T(0) ? T(1) : x);
  return x == T(0) ? x : r;
}
template <typename T>
__device__ __forceinline__ T div_z(T a, T b) {
  const T r = (a == T(0) ? T(1) : a) / b;
  return a == T(0) ? a : r;
}

// region metric planes, in evp.GR_NAMES order
enum { G_DXT, G_DYT, G_DXHY, G_DYHX, G_CXP, G_CYP, G_CXM, G_CYM, G_TAREAR,
       G_TINY };
// U-point planes, in evp.U_NAMES order (+ Cw plane when given)
enum { U_ICEM, U_AIU, U_UOCN, U_VOCN, U_WATERX, U_WATERY, U_FORCEX,
       U_FORCEY, U_UMASSDTI, U_FM, U_UAREAR, U_UINIT, U_VINIT, U_CW };

// the scalar parameters of a subcycle (dyn.EVPParams)
template <typename T>
struct Params {
  T arlx1i, denom1, ecci, brlx_revp, brlx, revp, cosw, sinw;
};

// The stress update at one region point (T cell; ice_dyn_evp.F90:520-849).
// u00..vSW: the velocities at its NE, NW (W), SE (S) and SW corners.
// gR/np/k: the metric planes and this point's index in them. s: the 12
// stress components, updated in place (0 where the ice mask m is off).
// str8: the 8 stress-divergence combinations. diag (divu, shear,
// rdg_conv, rdg_shear, prs_sig) is written when diag_on.
template <typename T>
__device__ __forceinline__ void stress_point(
    T u00, T uW, T uS, T uSW, T v00, T vW, T vS, T vSW,
    const T* __restrict__ gR, size_t np, size_t k, T strength, bool m,
    const Params<T>& P, T s[12], T str8[8], bool diag_on, T diag[5]) {
  typedef C<T> K;
  const T dxt = gR[G_DXT * np + k], dyt = gR[G_DYT * np + k];
  const T dxhy = gR[G_DXHY * np + k], dyhx = gR[G_DYHX * np + k];
  const T cxp = gR[G_CXP * np + k], cyp = gR[G_CYP * np + k];
  const T cxm = gR[G_CXM * np + k], cym = gR[G_CYM * np + k];
  const T tarear = gR[G_TAREAR * np + k], tinyarea = gR[G_TINY * np + k];
  const T ecci = P.ecci;

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

  const T Deltane = sqrt_z(divune * divune
                         + ecci * (tensionne * tensionne + shearne * shearne));
  const T Deltanw = sqrt_z(divunw * divunw
                         + ecci * (tensionnw * tensionnw + shearnw * shearnw));
  const T Deltase = sqrt_z(divuse * divuse
                         + ecci * (tensionse * tensionse + shearse * shearse));
  const T Deltasw = sqrt_z(divusw * divusw
                         + ecci * (tensionsw * tensionsw + shearsw * shearsw));

  // replacement pressure (:683-699)
  const T tiny = tmax(tinyarea, T(1e-30));
  T c0ne = div_z(strength, tmax(Deltane, tiny));
  T c0nw = div_z(strength, tmax(Deltanw, tiny));
  T c0sw = div_z(strength, tmax(Deltasw, tiny));
  T c0se = div_z(strength, tmax(Deltase, tiny));
  const T prs_sig = c0ne * Deltane;

  const T arlx1i = P.arlx1i;
  const T c1ne = c0ne * arlx1i, c1nw = c0nw * arlx1i;
  const T c1sw = c0sw * arlx1i, c1se = c0se * arlx1i;
  c0ne = c1ne * ecci;
  c0nw = c1nw * ecci;
  c0sw = c1sw * ecci;
  c0se = c1se * ecci;

  const T d1 = P.denom1;
  const T sp1 = m ? (s[0] + c1ne * (divune - Deltane)) * d1 : T(0);
  const T sp2 = m ? (s[1] + c1nw * (divunw - Deltanw)) * d1 : T(0);
  const T sp3 = m ? (s[2] + c1sw * (divusw - Deltasw)) * d1 : T(0);
  const T sp4 = m ? (s[3] + c1se * (divuse - Deltase)) * d1 : T(0);
  const T sm1 = m ? (s[4] + c0ne * tensionne) * d1 : T(0);
  const T sm2 = m ? (s[5] + c0nw * tensionnw) * d1 : T(0);
  const T sm3 = m ? (s[6] + c0sw * tensionsw) * d1 : T(0);
  const T sm4 = m ? (s[7] + c0se * tensionse) * d1 : T(0);
  const T s121 = m ? (s[8] + c0ne * shearne * K::p5) * d1 : T(0);
  const T s122 = m ? (s[9] + c0nw * shearnw * K::p5) * d1 : T(0);
  const T s123 = m ? (s[10] + c0sw * shearsw * K::p5) * d1 : T(0);
  const T s124 = m ? (s[11] + c0se * shearse * K::p5) * d1 : T(0);
  s[0] = sp1;
  s[1] = sp2;
  s[2] = sp3;
  s[3] = sp4;
  s[4] = sm1;
  s[5] = sm2;
  s[6] = sm3;
  s[7] = sm4;
  s[8] = s121;
  s[9] = s122;
  s[10] = s123;
  s[11] = s124;

  if (diag_on) {
    // ridging / diagnostic terms (:667-677)
    const T divu = K::p25 * (divune + divunw + divuse + divusw) * tarear;
    const T Delta_avg =
        K::p25 * (Deltane + Deltanw + Deltase + Deltasw) * tarear;
    const T ts = tensionne + tensionnw + tensionse + tensionsw;
    const T ss = shearne + shearnw + shearse + shearsw;
    diag[0] = divu;
    diag[1] = K::p25 * tarear * sqrt_z(ts * ts + ss * ss);
    diag[2] = -tmin(divu, T(0));
    diag[3] = K::p5 * (Delta_avg - tabs(divu));
    diag[4] = prs_sig;
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

  str8[0] = m ? -strp_n - strm_n - str12ew + dxhy * (-csigpne + csigmne)
                    + dyhx * csig12ne
              : T(0);
  str8[1] = m ? strp_n + strm_n - str12we + dxhy * (-csigpnw + csigmnw)
                    + dyhx * csig12nw
              : T(0);
  str8[2] = m ? -strp_s - strm_s + str12ew + dxhy * (-csigpse + csigmse)
                    + dyhx * csig12se
              : T(0);
  str8[3] = m ? strp_s + strm_s + str12we + dxhy * (-csigpsw + csigmsw)
                    + dyhx * csig12sw
              : T(0);
  str8[4] = m ? -strp_e + strm_e - str12ns - dyhx * (csigpne + csigmne)
                    + dxhy * csig12ne
              : T(0);
  str8[5] = m ? strp_e - strm_e - str12sn - dyhx * (csigpse + csigmse)
                    + dxhy * csig12se
              : T(0);
  str8[6] = m ? -strp_w + strm_w + str12ns - dyhx * (csigpnw + csigmnw)
                    + dxhy * csig12nw
              : T(0);
  str8[7] = m ? strp_w - strm_w + str12sn - dyhx * (csigpsw + csigmsw)
                    + dxhy * csig12sw
              : T(0);
}

// The implicit momentum solve at one U point with quadratic water drag
// (models/dynamics/shared.py:stepu; ice_dyn_shared.F90:623-755).
// uin/np/k: the U-point planes (evp.U_NAMES order, + Cw) and this point's
// index. s0..s7: str8[0](j,i) + str8[1](j,i+1) + str8[2](j+1,i) +
// str8[3](j+1,i+1) for x, str8[4](j,i) + str8[5](j+1,i) + str8[6](j,i+1) +
// str8[7](j+1,i+1) for y, in that order. Returns (u, v) in place and the
// stress divergence (strintx, strinty), 0 where the ice mask is off.
template <typename T>
__device__ __forceinline__ void stepu_point(
    T& u, T& v, T s0, T s1, T s2, T s3, T s4, T s5, T s6, T s7,
    const T* __restrict__ uin, size_t np, size_t k, int cw_plane, T Cw,
    const Params<T>& P, T& strintx_out, T& strinty_out) {
  const T uold = u, vold = v;
  const T aiu = uin[U_AIU * np + k];
  const T uocn = uin[U_UOCN * np + k], vocn = uin[U_VOCN * np + k];
  const T cw = cw_plane ? uin[U_CW * np + k] : Cw;
  const T du = uocn - uold, dv = vocn - vold;
  const T vrel = aiu * T(1026.0) * cw * sqrt_z(du * du + dv * dv);
  const T taux = vrel * uin[U_WATERX * np + k];
  const T tauy = vrel * uin[U_WATERY * np + k];

  const T umassdti = uin[U_UMASSDTI * np + k];
  const T fm = uin[U_FM * np + k];
  const T sgn = T((fm > T(0)) - (fm < T(0)));
  const T cca = P.brlx_revp * umassdti + vrel * P.cosw;
  const T ccb = fm + sgn * vrel * P.sinw;
  T ab2 = cca * cca + ccb * ccb;

  const T uarear = uin[U_UAREAR * np + k];
  const T strintx = uarear * (s0 + s1 + s2 + s3);
  const T strinty = uarear * (s4 + s5 + s6 + s7);

  const T cc1 = strintx + uin[U_FORCEX * np + k] + taux
                + umassdti * (P.brlx * uold + P.revp * uin[U_UINIT * np + k]);
  const T cc2 = strinty + uin[U_FORCEY * np + k] + tauy
                + umassdti * (P.brlx * vold + P.revp * uin[U_VINIT * np + k]);
  ab2 = tmax(ab2, T(1e-30));
  const bool m = uin[U_ICEM * np + k] > T(0.5);
  u = m ? div_z(cca * cc1 + ccb * cc2, ab2) : T(0);
  v = m ? div_z(cca * cc2 - ccb * cc1, ab2) : T(0);
  strintx_out = m ? strintx : T(0);
  strinty_out = m ? strinty : T(0);
}

template <typename T>
Params<T> make_params(double arlx1i, double denom1, double ecci, double brlx,
                      double revp, double cosw, double sinw) {
  Params<T> P;
  P.arlx1i = T(arlx1i);
  P.denom1 = T(denom1);
  P.ecci = T(ecci);
  P.brlx_revp = T(brlx + revp);
  P.brlx = T(brlx);
  P.revp = T(revp);
  P.cosw = T(cosw);
  P.sinw = T(sinw);
  return P;
}

}  // namespace evp
