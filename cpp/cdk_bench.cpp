// Standalone native benchmark driver: the C++ analog of the reference's
// three Fortran `program` drivers (biharmonic_wk_kernel.F90:545-580,
// advect_scalar2D…F90:3-67, nested.F90:11-469) — deterministic init, run
// the scalar kernels, time them, print reference-style report lines.
//
// This gives the framework a JAX-free native path end to end: the same
// C ABI kernels the Python test suite uses as oracles, driven by a native
// harness. Build: `make -C cpp bench` -> cpp/cdk_bench; run `./cdk_bench
// [biharmonic|mpdata|cke|all] [iters]`.
//
// Note on scope: these are the TRUSTED scalar forms (the reference's "CPU
// reference" role). The accelerator-optimized variants of this framework
// are XLA programs and the CUDA MPDATA kernel (cdk/kernels/).

#include <chrono>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void cdk_lcg_fill(long long seed, long long n, double* out);
void cdk_uniform_fill(unsigned long long seed, long long n, double* out);
void cdk_biharmonic_ref(int nelemd, int qsize, int nlev, int np,
                        const double* dvv, const double* dinv,
                        const double* spheremp, const double* tensorvisc,
                        double rrearth, const double* qtens, double* out);
void cdk_cke_ref(int nedges, int ncells, int nvert, int nadv,
                 const int* adv_cells, const double* c1, const double* c3a,
                 const double* tracer, const double* ntf,
                 const double* adv_mask, const int* kmin, const int* kmax,
                 double coef3rdorder, double* out);
void cdk_mpdata_ref(int ns, int nx, int nz, const double* f_in,
                    const double* u_in, const double* w_in,
                    const double* rho, const double* rhow, const double* adz,
                    const double* flux_in, double* f_out, double* flux_out);
}

static double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static void bench_biharmonic(int iters) {
  // shipped miniapp size (biharmonic_wk_kernel.F90:10-17)
  const int np = 4, nlev = 72, qsize = 40, nelemd = 16;
  const double rrearth = 0.00000016666666666666;
  const long long npts = np * np;
  std::vector<double> dvv(npts), dinv(nelemd * npts * 4),
      sp(nelemd * npts), tv(nelemd * npts * 4),
      q(static_cast<long long>(nelemd) * qsize * nlev * npts),
      out(q.size());
  // LCG stream in the reference's fill order (seed 11; see problem.py for
  // the Fortran-order layout subtleties the Python path reproduces — the
  // native driver needs determinism, not cross-path bit equality)
  long long seed = 11;
  cdk_lcg_fill(seed, dvv.size(), dvv.data());
  cdk_uniform_fill(12, dinv.size(), dinv.data());
  cdk_uniform_fill(13, sp.size(), sp.data());
  cdk_uniform_fill(14, tv.size(), tv.data());
  cdk_uniform_fill(15, q.size(), q.data());

  double t0 = now_s();
  for (int n = 0; n < iters; ++n)
    cdk_biharmonic_ref(nelemd, qsize, nlev, np, dvv.data(), dinv.data(),
                       sp.data(), tv.data(), rrearth, q.data(), out.data());
  double dt = (now_s() - t0) / iters;
  const double pts = static_cast<double>(nelemd) * qsize * nlev * npts;
  std::printf(" biharmonic CPU(C++) Timing: %10.6f s  (%8.2f M pts/s)\n",
              dt, pts / dt / 1e6);
}

static void bench_mpdata(int iters) {
  const int ns = 48, nz = 58, nx = 32, nzm = nz - 1;
  const long long fx = nx + 6, ux = nx + 5, wx = nx + 4;
  std::vector<double> f(ns * fx * nzm), u(ns * ux * nzm), w(ns * wx * nz),
      rho(ns * nzm), rhow(ns * nz), adz(ns * nzm), flux(ns * nz),
      f_out(f.size()), flux_out(flux.size());
  cdk_uniform_fill(100, f.size(), f.data());
  cdk_uniform_fill(101, u.size(), u.data());
  cdk_uniform_fill(102, w.size(), w.data());
  for (auto& x : u) x -= 0.5;
  for (auto& x : w) x -= 0.5;
  cdk_uniform_fill(103, rho.size(), rho.data());
  cdk_uniform_fill(104, rhow.size(), rhow.data());
  cdk_uniform_fill(105, adz.size(), adz.data());
  for (auto& x : rho) x += 0.5;
  for (auto& x : rhow) x += 0.5;
  for (auto& x : adz) x += 0.5;
  cdk_uniform_fill(106, flux.size(), flux.data());

  double t0 = now_s();
  for (int n = 0; n < iters; ++n)
    cdk_mpdata_ref(ns, nx, nz, f.data(), u.data(), w.data(), rho.data(),
                   rhow.data(), adz.data(), flux.data(), f_out.data(),
                   flux_out.data());
  double dt = (now_s() - t0) / iters;
  const double pts = static_cast<double>(ns) * nx * nzm;
  std::printf(" mpdata     CPU(C++) Timing: %10.6f s  (%8.2f M pts/s)\n",
              dt, pts / dt / 1e6);
}

static void bench_cke(int iters) {
  // shipped nested.nml size (nested.nml:1-7)
  const int e = 25600, c = 2800, kv = 100, a = 10;
  std::vector<int> cells(static_cast<long long>(e) * a), kmin(c), kmax(c);
  std::vector<double> c1(cells.size()), c3(cells.size()),
      tracer(static_cast<long long>(c) * kv),
      ntf(static_cast<long long>(e) * kv), am(ntf.size(), 1.0),
      out(ntf.size());
  std::vector<double> r(cells.size());
  cdk_uniform_fill(7, r.size(), r.data());
  for (size_t i = 0; i < cells.size(); ++i)
    cells[i] = static_cast<int>(r[i] * c) % c;
  cdk_uniform_fill(8, c1.size(), c1.data());
  cdk_uniform_fill(9, c3.size(), c3.data());
  std::vector<double> rd(c);
  cdk_uniform_fill(10, c, rd.data());
  for (int i = 0; i < c; ++i) {
    int depth = static_cast<int>(rd[i] * kv * 2.0 + 0.5);
    depth = depth < 3 ? 3 : (depth > kv ? kv : depth);
    kmin[i] = 0;
    kmax[i] = depth - 1;
  }
  cdk_uniform_fill(11, tracer.size(), tracer.data());
  for (int i = 0; i < c; ++i)
    for (int k = kmax[i] + 1; k < kv; ++k) tracer[i * (long long)kv + k] = 0;
  cdk_uniform_fill(16, ntf.size(), ntf.data());
  for (auto& x : ntf) x = 15.0 * (0.5 - x);

  double t0 = now_s();
  for (int n = 0; n < iters; ++n)
    cdk_cke_ref(e, c, kv, a, cells.data(), c1.data(), c3.data(),
                tracer.data(), ntf.data(), am.data(), kmin.data(),
                kmax.data(), 2.14, out.data());
  double dt = (now_s() - t0) / iters;
  const double pts = static_cast<double>(e) * kv;
  std::printf(" cke        CPU(C++) Timing: %10.6f s  (%8.2f M pts/s)\n",
              dt, pts / dt / 1e6);
}

int main(int argc, char** argv) {
  std::string which = argc > 1 ? argv[1] : "all";
  int iters = argc > 2 ? std::atoi(argv[2]) : 10;
  if (which == "biharmonic" || which == "all") bench_biharmonic(iters);
  if (which == "mpdata" || which == "all") bench_mpdata(iters);
  if (which == "cke" || which == "all") bench_cke(iters);
  return 0;
}
