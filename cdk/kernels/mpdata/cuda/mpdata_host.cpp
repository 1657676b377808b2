// Serial host driver of the MPDATA stage functions in mpdata_stages.h.
//
// Runs exactly the per-point arithmetic the GPU kernel (mpdata_loop.cu)
// runs, one stage after the other, so the CPU tests can check the
// kernel's stage decomposition against the jnp reference without a GPU.
// Built into cpp/libcdk_host.so (cpp/Makefile) and called through
// cdk.core.native.mpdata_stages_loop.
#include <cstdint>
#include <vector>

#include "mpdata_stages.h"

namespace {

template <typename T>
void run_loop(int ns, int nx, int nz, int nsteps, const T* f_in, const T* u,
              const T* w, const T* rho, const T* rhow, const T* adz,
              const T* flux_in, T* f_out, T* flux_out) {
  using namespace cdk_mpdata;
  const int K = nz - 1;
  std::vector<T> f((nx + 6) * K), us((nx + 5) * K), ws((nx + 4) * K);
  std::vector<T> uuu((nx + 5) * K), www((nx + 4) * (K + 1), T(0));
  std::vector<T> mx((nx + 2) * K), mn((nx + 2) * K);
  std::vector<T> c_rho(K), irho(K), iadz(K), dd(K), irhow(K), flx(K);
  Slice<T> s{f.data(), us.data(), ws.data(), uuu.data(), www.data(),
             mx.data(), mn.data(), c_rho.data(), irho.data(), iadz.data(),
             dd.data(), irhow.data(), flx.data(), nx, K};
  for (int sl = 0; sl < ns; ++sl) {
    const T* fs = f_in + (int64_t)sl * (nx + 6) * K;
    for (int p = 0; p < (nx + 6) * K; ++p) f[p] = fs[p];
    for (int p = 0; p < (nx + 5) * K; ++p)
      us[p] = u[(int64_t)sl * (nx + 5) * K + p];
    for (int x = 0; x < nx + 4; ++x)
      for (int k = 0; k < K; ++k)
        ws[x * K + k] = w[((int64_t)sl * (nx + 4) + x) * nz + k];
    for (int x = 0; x < nx + 4; ++x) www[x * (K + 1) + K] = T(0);
    for (int k = 0; k < K; ++k)
      level_coefs(k, K, rho + sl * K, rhow + sl * nz, adz + sl * K,
                  c_rho.data(), irho.data(), iadz.data(), dd.data(),
                  irhow.data());
    for (int step = 0; step < nsteps; ++step) {
      for (int p = 0; p < stage1_points(s); ++p) stage1(s, p);
      for (int p = 0; p < stage2_points(s); ++p) stage2(s, p);
      for (int p = 0; p < stage3_points(s); ++p) stage3(s, p);
      for (int p = 0; p < stage4_points(s); ++p) stage4(s, p);
      for (int p = 0; p < stage5_points(s); ++p) stage5(s, p);
      for (int p = 0; p < stage6_points(s); ++p) stage6(s, p);
    }
    T* fo = f_out + (int64_t)sl * (nx + 6) * K;
    for (int p = 0; p < (nx + 6) * K; ++p) fo[p] = f[p];
    for (int k = 0; k < nz; ++k)
      flux_out[sl * nz + k] =
          (nsteps > 0 && k < K) ? flx[k] : flux_in[sl * nz + k];
  }
}

}  // namespace

extern "C" {

void cdk_mpdata_stages_loop_f64(int ns, int nx, int nz, int nsteps,
                                const double* f, const double* u,
                                const double* w, const double* rho,
                                const double* rhow, const double* adz,
                                const double* flux, double* f_out,
                                double* flux_out) {
  run_loop(ns, nx, nz, nsteps, f, u, w, rho, rhow, adz, flux, f_out,
           flux_out);
}

void cdk_mpdata_stages_loop_f32(int ns, int nx, int nz, int nsteps,
                                const float* f, const float* u,
                                const float* w, const float* rho,
                                const float* rhow, const float* adz,
                                const float* flux, float* f_out,
                                float* flux_out) {
  run_loop(ns, nx, nz, nsteps, f, u, w, rho, rhow, adz, flux, f_out,
           flux_out);
}

}  // extern "C"
