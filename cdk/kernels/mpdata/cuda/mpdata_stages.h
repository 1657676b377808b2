// MPDATA advect_scalar2D stages as point functions over one CRM slice.
//
// One header, two drivers:
//   * mpdata_loop.cu   — the GPU kernel: one slice per thread block, the
//                        slice's fields in shared memory, threads stride
//                        over each stage's points, __syncthreads between
//                        stages, the n-step time loop inside the kernel;
//   * mpdata_host.cpp  — a serial host driver of the SAME stage functions
//                        (built into cpp/libcdk_host.so), which the CPU
//                        tests compare with the jnp reference.
//
// Semantics and floating-point evaluation order follow
// cdk/kernels/mpdata/reference.py stage by stage (Fortran
// advect_scalar2D_cpu, advect…F90:477-642).  Fortran x index i maps to
// row (i + off) of each buffer; k is the 0-based level, K = nzm.
//
// Every stage writes only buffers the same stage does not read at another
// point, so each stage updates its buffers in place:
//   stage 1: reads f, u, w            -> mx, mn, uuu, www (first-order)
//   stage 2: reads uuu, www           -> f (upwind update), flx
//   stage 3: reads f, u, w            -> uuu, www (antidiffusive)
//   stage 4: reads f, mx, mn, uuu, www-> mx, mn (limiter ratios mxr, mnr)
//   stage 5: reads uuu, www, mx, mn   -> uuu, www (limited)
//   stage 6: reads f, uuu, www        -> f (final update), flx
#pragma once

#ifdef __CUDACC__
#define CDK_HD __host__ __device__ __forceinline__
#else
#define CDK_HD inline
#endif

namespace cdk_mpdata {

constexpr double kEps = 1.0e-10;  // limiter regularization (advect…F90:510)

template <typename T>
struct Slice {
  T* f;          // (nx+6, K)   i = -2..nx+3
  const T* u;    // (nx+5, K)   i = -1..nx+3
  const T* w;    // (nx+4, K)   i = -1..nx+2, levels below the top only
  T* uuu;        // (nx+5, K)   i = -1..nx+3
  T* www;        // (nx+4, K+1) i = -1..nx+2, level K is the zero top
  T* mx;         // (nx+2, K)   i = 0..nx+1
  T* mn;
  const T* rho;  // (K) per-level coefficients
  const T* irho;
  const T* iadz;
  const T* dd;
  const T* irhow;
  T* flx;        // (K) domain-summed vertical flux of the step
  int nx, K;

  CDK_HD T& F(int i, int k) const { return f[(i + 2) * K + k]; }
  CDK_HD T U(int i, int k) const { return u[(i + 1) * K + k]; }
  CDK_HD T W(int i, int k) const { return w[(i + 1) * K + k]; }
  CDK_HD T& UU(int i, int k) const { return uuu[(i + 1) * K + k]; }
  CDK_HD T& WW(int i, int k) const { return www[(i + 1) * (K + 1) + k]; }
  CDK_HD T& MX(int i, int k) const { return mx[i * K + k]; }
  CDK_HD T& MN(int i, int k) const { return mn[i * K + k]; }
  CDK_HD int kb(int k) const { return k > 0 ? k - 1 : 0; }
  CDK_HD int kc(int k) const { return k < K - 1 ? k + 1 : K - 1; }
};

template <typename T> CDK_HD T pp(T y) { return y > T(0) ? y : T(0); }
template <typename T> CDK_HD T pn(T y) { return -(y < T(0) ? y : T(0)); }
template <typename T> CDK_HD T mx2(T a, T b) { return a > b ? a : b; }
template <typename T> CDK_HD T mn2(T a, T b) { return a < b ? a : b; }
template <typename T> CDK_HD T min3(T a, T b, T c) { return mn2(mn2(a, b), c); }

template <typename T> CDK_HD T andiff(T x1, T x2, T a, T b) {
  return ((a < T(0) ? -a : a) - a * a * b) * T(0.5) * (x2 - x1);
}
template <typename T> CDK_HD T across(T x1, T a1, T a2) {
  return T(0.03125) * a1 * a2 * x1;
}

// Per-level coefficients, computed once per kernel call (they depend only
// on rho, rhow, adz, which the time loop never changes).
template <typename T>
CDK_HD void level_coefs(int k, int K, const T* rho, const T* rhow,
                        const T* adz, T* s_rho, T* irho, T* iadz, T* dd,
                        T* irhow) {
  int kspan = (k + 1 < K - 1 ? k + 1 : K - 1) - (k - 1 > 0 ? k - 1 : 0);
  s_rho[k] = rho[k];
  irho[k] = T(1) / rho[k];
  iadz[k] = T(1) / adz[k];
  dd[k] = T(2) / T(kspan) / adz[k];
  irhow[k] = T(1) / (rhow[k] * adz[k]);
}

// Point counts of each stage (a driver runs p = 0 .. count-1).
template <typename T> CDK_HD int stage1_points(const Slice<T>& s) {
  return (3 * s.nx + 11) * s.K;
}
template <typename T> CDK_HD int stage2_points(const Slice<T>& s) {
  return (s.nx + 5) * s.K;
}
template <typename T> CDK_HD int stage3_points(const Slice<T>& s) {
  return (2 * s.nx + 7) * s.K;
}
template <typename T> CDK_HD int stage4_points(const Slice<T>& s) {
  return (s.nx + 2) * s.K;
}
template <typename T> CDK_HD int stage5_points(const Slice<T>& s) {
  return (2 * s.nx + 1) * s.K;
}
template <typename T> CDK_HD int stage6_points(const Slice<T>& s) {
  return s.nx * s.K + s.K;
}

// Stage 1: FCT extrema over i=0..nx+1 (:513-526), first-order upwind
// fluxes uuu over i=-1..nx+3 and www over i=-1..nx+2 (:528-548).
template <typename T>
CDK_HD void stage1(const Slice<T>& s, int p) {
  const int K = s.K, nx = s.nx;
  const int n_mx = (nx + 2) * K, n_u = (nx + 5) * K;
  if (p < n_mx) {
    int i = p / K, k = p % K;
    T c = s.F(i, k), l = s.F(i - 1, k), r = s.F(i + 1, k);
    T b = s.F(i, s.kb(k)), a = s.F(i, s.kc(k));
    s.MX(i, k) = mx2(mx2(mx2(l, r), mx2(b, a)), c);
    s.MN(i, k) = mn2(mn2(mn2(l, r), mn2(b, a)), c);
  } else if (p < n_mx + n_u) {
    p -= n_mx;
    int i = p / K - 1, k = p % K;
    T uu = s.U(i, k);
    s.UU(i, k) = pp(uu) * s.F(i - 1, k) - pn(uu) * s.F(i, k);
  } else {
    p -= n_mx + n_u;
    int i = p / K - 1, k = p % K;
    T ww = s.W(i, k);
    s.WW(i, k) = pp(ww) * s.F(i, s.kb(k)) - pn(ww) * s.F(i, k);
  }
}

// Stage 2: upwind update of f over i=-1..nx+2 (:550-560); the first part
// of the domain flux sum over i=1..nx.
template <typename T>
CDK_HD void stage2(const Slice<T>& s, int p) {
  const int K = s.K, nx = s.nx;
  const int n_f = (nx + 4) * K;
  if (p < n_f) {
    int i = p / K - 1, k = p % K;
    T upd = ((s.UU(i + 1, k) - s.UU(i, k))
             + (s.WW(i, k + 1) - s.WW(i, k)) * s.iadz[k]) * s.irho[k];
    s.F(i, k) = s.F(i, k) - upd;
  } else {
    int k = p - n_f;
    T acc = s.WW(1, k);
    for (int i = 2; i <= nx; ++i) acc += s.WW(i, k);
    s.flx[k] = acc;
  }
}

// Stage 3: antidiffusive pseudo-velocities (:561-585): uuu over
// i=0..nx+2, www over i=0..nx+1 and levels 1..K-1; the bottom boundary
// www(:, 0) = 0 over the whole row (:586).
template <typename T>
CDK_HD void stage3(const Slice<T>& s, int p) {
  const int K = s.K, nx = s.nx;
  const int n_u = (nx + 3) * K;
  if (p < n_u) {
    int i = p / K, k = p % K;
    int kb = s.kb(k), kc = s.kc(k);
    T fib = s.F(i - 1, k), fi = s.F(i, k), uu = s.U(i, k);
    T x1 = s.dd[k] * (s.F(i - 1, kc) + s.F(i, kc) - s.F(i - 1, kb)
                      - s.F(i, kb));
    T a2 = s.W(i - 1, k) + s.W(i - 1, kc) + s.W(i, k) + s.W(i, kc);
    s.UU(i, k) = andiff(fib, fi, uu, s.irho[k])
                 - across(x1, uu, a2) * s.irho[k];
  } else {
    p -= n_u;
    int i = p / K - 1, k = p % K;  // i = -1..nx+2
    if (k == 0) {
      s.WW(i, 0) = T(0);
      return;
    }
    if (i < 0 || i > nx + 1) return;  // keeps the first-order value
    int kb = s.kb(k);
    T ww = s.W(i, k);
    T x1 = s.F(i + 1, kb) + s.F(i + 1, k) - s.F(i - 1, kb) - s.F(i - 1, k);
    T a2 = s.U(i, kb) + s.U(i, k) + s.U(i + 1, k) + s.U(i + 1, kb);
    s.WW(i, k) = andiff(s.F(i, kb), s.F(i, k), ww, s.irhow[k])
                 - across(x1, ww, a2) * s.irho[k];
  }
}

// Stage 4: second extrema update with the upwind-updated f (:588-600)
// and the in/out flux ratios (:601-612); mx, mn become mxr, mnr.
template <typename T>
CDK_HD void stage4(const Slice<T>& s, int p) {
  const int K = s.K;
  int i = p / K, k = p % K;
  int kc = s.kc(k);
  T c = s.F(i, k), l = s.F(i - 1, k), r = s.F(i + 1, k);
  T b = s.F(i, s.kb(k)), a = s.F(i, kc);
  T mxv = mx2(mx2(mx2(l, r), mx2(b, a)), mx2(c, s.MX(i, k)));
  T mnv = mn2(mn2(mn2(l, r), mn2(b, a)), mn2(c, s.MN(i, k)));
  T ui = s.UU(i, k), uic = s.UU(i + 1, k);
  T wi = s.WW(i, k), wkc = s.WW(i, kc);
  T ia = s.iadz[k];
  s.MX(i, k) = s.rho[k] * (mxv - c)
               / (pn(uic) + pp(ui) + ia * (pn(wkc) + pp(wi)) + T(kEps));
  s.MN(i, k) = s.rho[k] * (c - mnv)
               / (pp(uic) + pn(ui) + ia * (pp(wkc) + pn(wi)) + T(kEps));
}

// Stage 5: limit the fluxes (:613-628): uuu over i=1..nx+1, www over
// i=1..nx.
template <typename T>
CDK_HD void stage5(const Slice<T>& s, int p) {
  const int K = s.K, nx = s.nx;
  const int n_u = (nx + 1) * K;
  const T one = T(1);
  if (p < n_u) {
    int i = p / K + 1, k = p % K;
    T lu = s.UU(i, k);
    s.UU(i, k) = pp(lu) * min3(one, s.MX(i, k), s.MN(i - 1, k))
                 - pn(lu) * min3(one, s.MX(i - 1, k), s.MN(i, k));
  } else {
    p -= n_u;
    int i = p / K + 1, k = p % K;
    int kb = s.kb(k);
    T lw = s.WW(i, k);
    s.WW(i, k) = pp(lw) * min3(one, s.MX(i, k), s.MN(i, kb))
                 - pn(lw) * min3(one, s.MX(i, kb), s.MN(i, k));
  }
}

// Stage 6: final update with the positive clip over i=1..nx (:630-637);
// the second part of the domain flux sum (the limited www over i=1..nx).
template <typename T>
CDK_HD void stage6(const Slice<T>& s, int p) {
  const int K = s.K, nx = s.nx;
  const int n_f = nx * K;
  if (p < n_f) {
    int i = p / K + 1, k = p % K;
    T upd = ((s.UU(i + 1, k) - s.UU(i, k))
             + (s.WW(i, k + 1) - s.WW(i, k)) * s.iadz[k]) * s.irho[k];
    T v = s.F(i, k) - upd;
    s.F(i, k) = v > T(0) ? v : T(0);
  } else {
    int k = p - n_f;
    T acc = s.WW(1, k);
    for (int i = 2; i <= nx; ++i) acc += s.WW(i, k);
    s.flx[k] = s.flx[k] + acc;
  }
}

}  // namespace cdk_mpdata
