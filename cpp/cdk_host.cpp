// Native host layer: deterministic generators + independent C++ oracle
// kernels, exported through a C ABI for ctypes.
//
// This is the equivalent of the reference's native components
// (SURVEY §2b): where cke.cpp/cke_impl{1,2}.cpp marshal Fortran arrays into
// device views and provide a second implementation to verify against
// (nested_loops/cke.cpp:24-120, cke_impl1.cpp:11-48), this library provides
//   - the exact `myrandom` LCG stream (biharmonic_wk_kernel.F90:77-91) and
//     a splitmix64-based uniform stream for host-side data generation at
//     production scale (C++ speed, identical values to the Python path is
//     NOT required — each generator is the documented source of truth for
//     its consumers);
//   - independent scalar C++ implementations of all three kernels, used by
//     the test-suite as a second, JAX-free oracle (the role yakl_check and
//     the in-run CPU references play in the reference suite);
//   - trailing-dimension padding (the analog of nvldim pack padding,
//     nested_vars.F90:94-100).
//
// The device-side native path is the CUDA MPDATA kernel
// (cdk/kernels/mpdata/cuda/), whose stage functions this library also
// runs serially on the host (mpdata_host.cpp) for the CPU tests.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- RNG ----

// Exact port of the reference myrandom LCG: state' = (1301*state + 97) mod
// 131072, value = state'/131072 (biharmonic_wk_kernel.F90:77-91).
void cdk_lcg_fill(long long seed, long long n, double* out) {
  long long s = seed;
  for (long long i = 0; i < n; ++i) {
    s = (1301 * s + 97) % 131072;
    out[i] = static_cast<double>(s) / 131072.0;
  }
}

// splitmix64 uniform stream in [0,1): fast host-side generation for
// production-scale inputs.
static inline uint64_t splitmix64(uint64_t& x) {
  uint64_t z = (x += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

void cdk_uniform_fill(unsigned long long seed, long long n, double* out) {
  uint64_t s = seed;
  for (long long i = 0; i < n; ++i) {
    out[i] = (splitmix64(s) >> 11) * 0x1.0p-53;
  }
}

// ------------------------------------------------------------- layout ----

// Pad the trailing (lane) dimension of an (rows, d) array to `dpad`
// (zero-fill) — the analog of the reference's nvldim pack padding.
void cdk_pad_lanes(long long rows, long long d, long long dpad,
                   const double* in, double* out) {
  for (long long r = 0; r < rows; ++r) {
    std::memcpy(out + r * dpad, in + r * d, sizeof(double) * d);
    std::memset(out + r * dpad + d, 0, sizeof(double) * (dpad - d));
  }
}

// ---------------------------------------------- biharmonic oracle ----

// Weak tensor-HV Laplacian, one (np x np) level at a time, scalar loops.
// Same math as biharmonic_wk_scalar_cpu (biharmonic_wk_kernel.F90:100-202):
// gradient_sphere -> tensorVisc contraction -> divergence_sphere_wk.
// Layouts (C-order, matching cdk.kernels.biharmonic.problem):
//   dvv[np][np] as [i][l]; dinv/tensorvisc[e][i][j][2][2]; spheremp[e][i][j];
//   qtens[e][q][k][i][j].
void cdk_biharmonic_ref(int nelemd, int qsize, int nlev, int np,
                        const double* dvv, const double* dinv,
                        const double* spheremp, const double* tensorvisc,
                        double rrearth, const double* qtens, double* out) {
  const int npts = np * np;
  std::vector<double> v1(npts), v2(npts), g1(npts), g2(npts), vt1(npts),
      vt2(npts);
  auto DVV = [&](int i, int l) { return dvv[i * np + l]; };
  for (int e = 0; e < nelemd; ++e) {
    const double* di = dinv + static_cast<long long>(e) * npts * 4;
    const double* sp = spheremp + static_cast<long long>(e) * npts;
    const double* tv = tensorvisc + static_cast<long long>(e) * npts * 4;
    for (int q = 0; q < qsize; ++q) {
      for (int k = 0; k < nlev; ++k) {
        const double* s =
            qtens + (((static_cast<long long>(e) * qsize + q) * nlev + k)) *
                        npts;
        double* o =
            out + (((static_cast<long long>(e) * qsize + q) * nlev + k)) *
                      npts;
        // gradient_sphere: v1(l,j) = rr * sum_i Dvv(i,l) s(i,j);
        //                  v2(j,l) = rr * sum_i Dvv(i,l) s(j,i)
        for (int j = 0; j < np; ++j)
          for (int l = 0; l < np; ++l) {
            double dx = 0.0, dy = 0.0;
            for (int i = 0; i < np; ++i) {
              dx += DVV(i, l) * s[i * np + j];
              dy += DVV(i, l) * s[j * np + i];
            }
            v1[l * np + j] = rrearth * dx;
            v2[j * np + l] = rrearth * dy;
          }
        // contravariant->latlon (Dinv^T), tensorVisc, then Dinv
        for (int p = 0; p < npts; ++p) {
          const double d00 = di[p * 4 + 0], d01 = di[p * 4 + 1],
                       d10 = di[p * 4 + 2], d11 = di[p * 4 + 3];
          const double ds1 = d00 * v1[p] + d10 * v2[p];
          const double ds2 = d01 * v1[p] + d11 * v2[p];
          g1[p] = ds1 * tv[p * 4 + 0] + ds2 * tv[p * 4 + 1];
          g2[p] = ds1 * tv[p * 4 + 2] + ds2 * tv[p * 4 + 3];
          vt1[p] = d00 * g1[p] + d01 * g2[p];
          vt2[p] = d10 * g1[p] + d11 * g2[p];
        }
        // divergence_sphere_wk
        for (int n = 0; n < np; ++n)
          for (int m = 0; m < np; ++m) {
            double acc = 0.0;
            for (int j = 0; j < np; ++j) {
              acc -= (sp[j * np + n] * vt1[j * np + n] * DVV(m, j) +
                      sp[m * np + j] * vt2[m * np + j] * DVV(n, j)) *
                     rrearth;
            }
            o[m * np + n] = acc;
          }
      }
    }
  }
}

// Two-application biharmonic with ring-DSS assembly between — the HOMME
// structure whose exchange the miniapp drops (SURVEY §5 deferred DSS).
// Topology/assembly per cdk.kernels.biharmonic.dss: element e's
// j=np-1 GLL column is element (e+1)%nelemd's j=0 column; assembled dof =
// (sum of sharers) / (sum of sharers' spheremp); interior dof = s/sp.
void cdk_biharmonic_dss_ref(int nelemd, int qsize, int nlev, int np,
                            const double* dvv, const double* dinv,
                            const double* spheremp,
                            const double* tensorvisc, double rrearth,
                            const double* qtens, double* out,
                            double* scratch) {
  const int npts = np * np;
  const long long per_e = static_cast<long long>(qsize) * nlev * npts;
  const long long total = static_cast<long long>(nelemd) * per_e;
  // 1st Laplacian into scratch
  cdk_biharmonic_ref(nelemd, qsize, nlev, np, dvv, dinv, spheremp,
                     tensorvisc, rrearth, qtens, scratch);
  // DSS assembly in place (reads need the pre-assembly neighbor columns,
  // so stage the two shared columns per element first)
  std::vector<double> left_col(total / np), right_col(total / np);
  for (int e = 0; e < nelemd; ++e)
    for (int q = 0; q < qsize; ++q)
      for (int k = 0; k < nlev; ++k)
        for (int i = 0; i < np; ++i) {
          long long base = ((static_cast<long long>(e) * qsize + q) * nlev
                            + k) * npts + i * np;
          long long cidx = ((static_cast<long long>(e) * qsize + q) * nlev
                            + k) * np + i;
          left_col[cidx] = scratch[base + 0];
          right_col[cidx] = scratch[base + np - 1];
        }
  for (int e = 0; e < nelemd; ++e) {
    int el = (e - 1 + nelemd) % nelemd;
    int er = (e + 1) % nelemd;
    const double* sp = spheremp + static_cast<long long>(e) * npts;
    const double* spl = spheremp + static_cast<long long>(el) * npts;
    const double* spr = spheremp + static_cast<long long>(er) * npts;
    for (int q = 0; q < qsize; ++q)
      for (int k = 0; k < nlev; ++k)
        for (int i = 0; i < np; ++i) {
          long long base = ((static_cast<long long>(e) * qsize + q) * nlev
                            + k) * npts + i * np;
          long long cl = ((static_cast<long long>(el) * qsize + q) * nlev
                          + k) * np + i;
          long long cr = ((static_cast<long long>(er) * qsize + q) * nlev
                          + k) * np + i;
          for (int j = 1; j < np - 1; ++j)
            scratch[base + j] /= sp[i * np + j];
          scratch[base + 0] = (scratch[base + 0] + right_col[cl]) /
                              (sp[i * np + 0] + spl[i * np + np - 1]);
          scratch[base + np - 1] = (scratch[base + np - 1] + left_col[cr]) /
                                   (sp[i * np + np - 1] + spr[i * np + 0]);
        }
  }
  // 2nd Laplacian
  cdk_biharmonic_ref(nelemd, qsize, nlev, np, dvv, dinv, spheremp,
                     tensorvisc, rrearth, scratch, out);
}

// Two-application biharmonic with the 2-D TORUS DSS between — edges in
// both GLL directions plus 4-way corner dofs (cdk.kernels.biharmonic
// .dss2d semantics: elements on a periodic (ex, ey) grid, flattened
// e = a*ey + b; assembled dof = Σ sharers / Σ sharers' spheremp,
// evaluated as a j-direction edge sum followed by an i-direction edge
// sum OF THE j-SUMMED field, which carries the corner partials).
void cdk_biharmonic_dss2d_ref(int ex, int ey, int qsize, int nlev, int np,
                              const double* dvv, const double* dinv,
                              const double* spheremp,
                              const double* tensorvisc, double rrearth,
                              const double* qtens, double* out,
                              double* scratch) {
  const int nelemd = ex * ey;
  const int npts = np * np;
  const long long per_lvl = npts;
  const long long per_e = static_cast<long long>(qsize) * nlev * npts;
  const long long total = static_cast<long long>(nelemd) * per_e;
  auto eid = [&](int a, int b) {
    return ((a + ex) % ex) * ey + ((b + ey) % ey);
  };
  // 1st Laplacian into scratch
  cdk_biharmonic_ref(nelemd, qsize, nlev, np, dvv, dinv, spheremp,
                     tensorvisc, rrearth, qtens, scratch);
  // assembled mass: the same two-pass sum applied to spheremp
  std::vector<double> jm(static_cast<long long>(nelemd) * npts);
  std::vector<double> mass(static_cast<long long>(nelemd) * npts);
  for (int a = 0; a < ex; ++a)
    for (int b = 0; b < ey; ++b) {
      const double* sp = spheremp + static_cast<long long>(eid(a, b)) * npts;
      const double* spl =
          spheremp + static_cast<long long>(eid(a, b - 1)) * npts;
      const double* spr =
          spheremp + static_cast<long long>(eid(a, b + 1)) * npts;
      double* o = jm.data() + static_cast<long long>(eid(a, b)) * npts;
      for (int i = 0; i < np; ++i) {
        for (int j = 1; j < np - 1; ++j) o[i * np + j] = sp[i * np + j];
        o[i * np + 0] = sp[i * np + 0] + spl[i * np + np - 1];
        o[i * np + np - 1] = sp[i * np + np - 1] + spr[i * np + 0];
      }
    }
  for (int a = 0; a < ex; ++a)
    for (int b = 0; b < ey; ++b) {
      const double* t = jm.data() + static_cast<long long>(eid(a, b)) * npts;
      const double* tu =
          jm.data() + static_cast<long long>(eid(a - 1, b)) * npts;
      const double* td =
          jm.data() + static_cast<long long>(eid(a + 1, b)) * npts;
      double* o = mass.data() + static_cast<long long>(eid(a, b)) * npts;
      for (int j = 0; j < np; ++j) {
        for (int i = 1; i < np - 1; ++i) o[i * np + j] = t[i * np + j];
        o[0 * np + j] = t[0 * np + j] + tu[(np - 1) * np + j];
        o[(np - 1) * np + j] = t[(np - 1) * np + j] + td[0 * np + j];
      }
    }
  // field: the same two passes per (q, k) level
  std::vector<double> tfield(total);
  for (int a = 0; a < ex; ++a)
    for (int b = 0; b < ey; ++b) {
      long long e = eid(a, b), el = eid(a, b - 1), er = eid(a, b + 1);
      for (long long lv = 0;
           lv < static_cast<long long>(qsize) * nlev; ++lv) {
        const double* s = scratch + e * per_e + lv * per_lvl;
        const double* sl = scratch + el * per_e + lv * per_lvl;
        const double* sr = scratch + er * per_e + lv * per_lvl;
        double* o = tfield.data() + e * per_e + lv * per_lvl;
        for (int i = 0; i < np; ++i) {
          for (int j = 1; j < np - 1; ++j) o[i * np + j] = s[i * np + j];
          o[i * np + 0] = s[i * np + 0] + sl[i * np + np - 1];
          o[i * np + np - 1] = s[i * np + np - 1] + sr[i * np + 0];
        }
      }
    }
  for (int a = 0; a < ex; ++a)
    for (int b = 0; b < ey; ++b) {
      long long e = eid(a, b), eu = eid(a - 1, b), ed = eid(a + 1, b);
      const double* m = mass.data() + e * npts;
      for (long long lv = 0;
           lv < static_cast<long long>(qsize) * nlev; ++lv) {
        const double* t = tfield.data() + e * per_e + lv * per_lvl;
        const double* tu = tfield.data() + eu * per_e + lv * per_lvl;
        const double* td = tfield.data() + ed * per_e + lv * per_lvl;
        double* o = scratch + e * per_e + lv * per_lvl;
        for (int j = 0; j < np; ++j) {
          for (int i = 1; i < np - 1; ++i)
            o[i * np + j] = t[i * np + j] / m[i * np + j];
          o[0 * np + j] = (t[0 * np + j] + tu[(np - 1) * np + j]) /
                          m[0 * np + j];
          o[(np - 1) * np + j] = (t[(np - 1) * np + j] + td[0 * np + j]) /
                                 m[(np - 1) * np + j];
        }
      }
    }
  // 2nd Laplacian
  cdk_biharmonic_ref(nelemd, qsize, nlev, np, dvv, dinv, spheremp,
                     tensorvisc, rrearth, scratch, out);
}

// ---------------------------------------------------- cke oracle ----

// Original-form edge flux (nested.F90:119-157): per-edge wgt/sgn column
// temps, gather over contributing cells, k restricted to the cell's
// [kmin, kmax] (0-based inclusive).  Layouts per cdk.kernels.cke.
void cdk_cke_ref(int nedges, int ncells, int nvert, int nadv,
                 const int* adv_cells, const double* c1, const double* c3a,
                 const double* tracer, const double* ntf,
                 const double* adv_mask, const int* kmin, const int* kmax,
                 double coef3rdorder, double* out) {
  std::vector<double> wgt(nvert), sgn(nvert);
  for (int e = 0; e < nedges; ++e) {
    const double* ntf_e = ntf + static_cast<long long>(e) * nvert;
    const double* am_e = adv_mask + static_cast<long long>(e) * nvert;
    double* o = out + static_cast<long long>(e) * nvert;
    for (int k = 0; k < nvert; ++k) {
      wgt[k] = ntf_e[k] * am_e[k];
      sgn[k] = ntf_e[k] >= 0.0 ? 1.0 : -1.0;  // Fortran sign(1,x)
      o[k] = 0.0;
    }
    for (int i = 0; i < nadv; ++i) {
      const int c = adv_cells[e * nadv + i];
      const double coef1 = c1[e * nadv + i];
      const double coef3 = c3a[e * nadv + i] * coef3rdorder;
      const double* t = tracer + static_cast<long long>(c) * nvert;
      for (int k = kmin[c]; k <= kmax[c]; ++k) {
        o[k] += t[k] * wgt[k] * (coef1 + coef3 * sgn[k]);
      }
    }
  }
}

// ------------------------------------------------- mpdata oracle ----

// One MPDATA advect_scalar2D step, scalar loops, CPU/openacc_1 semantics
// (advect_scalar2D_pushncols_openacc.F90:477-642).  Layouts per
// cdk.kernels.mpdata.problem: (nslices, x, z) C-order, x offsets
// f:+2, u:+1, w:+1 relative to Fortran i, z 0-based.
void cdk_mpdata_ref(int ns, int nx, int nz, const double* f_in,
                    const double* u_in, const double* w_in,
                    const double* rho, const double* rhow, const double* adz,
                    const double* flux_in, double* f_out, double* flux_out) {
  const int nzm = nz - 1;
  const int fx = nx + 6, ux = nx + 5, wx = nx + 4, mxx = nx + 2;
  const double eps = 1.0e-10;
  auto pp = [](double y) { return std::max(0.0, y); };
  auto pn = [](double y) { return -std::min(0.0, y); };
  auto andiff = [](double x1, double x2, double a, double b) {
    return (std::fabs(a) - a * a * b) * 0.5 * (x2 - x1);
  };
  auto across = [](double x1, double a1, double a2) {
    return 0.03125 * a1 * a2 * x1;
  };

  std::memcpy(f_out, f_in, sizeof(double) * ns * fx * nzm);
  std::memcpy(flux_out, flux_in, sizeof(double) * ns * nz);
  std::vector<double> mx(mxx * nzm), mn(mxx * nzm), uuu(ux * nzm),
      www(wx * nz);

  for (int sl = 0; sl < ns; ++sl) {
    double* f = f_out + static_cast<long long>(sl) * fx * nzm;
    const double* u = u_in + static_cast<long long>(sl) * ux * nzm;
    const double* w = w_in + static_cast<long long>(sl) * wx * nz;
    const double* rh = rho + static_cast<long long>(sl) * nzm;
    const double* rw = rhow + static_cast<long long>(sl) * nz;
    const double* az = adz + static_cast<long long>(sl) * nzm;
    double* fl = flux_out + static_cast<long long>(sl) * nz;
    // Fortran-indexed accessors (i is the Fortran x index, k 0-based)
    auto F = [&](int i, int k) -> double& { return f[(i + 2) * nzm + k]; };
    auto U = [&](int i, int k) { return u[(i + 1) * nzm + k]; };
    auto W = [&](int i, int k) { return w[(i + 1) * nz + k]; };
    auto UU = [&](int i, int k) -> double& { return uuu[(i + 1) * nzm + k]; };
    auto WW = [&](int i, int k) -> double& { return www[(i + 1) * nz + k]; };
    auto MX = [&](int i, int k) -> double& { return mx[i * nzm + k]; };
    auto MN = [&](int i, int k) -> double& { return mn[i * nzm + k]; };

    // stage 1: FCT extrema
    for (int k = 0; k < nzm; ++k) {
      const int kc = std::min(nzm - 1, k + 1), kb = std::max(0, k - 1);
      for (int i = 0; i <= nx + 1; ++i) {
        MX(i, k) = std::max({F(i - 1, k), F(i + 1, k), F(i, kb), F(i, kc),
                             F(i, k)});
        MN(i, k) = std::min({F(i - 1, k), F(i + 1, k), F(i, kb), F(i, kc),
                             F(i, k)});
      }
    }
    // stage 2: upwind fluxes + domain flux
    for (int k = 0; k < nzm; ++k) {
      const int kb = std::max(0, k - 1);
      for (int i = -1; i <= nx + 3; ++i)
        UU(i, k) = std::max(0.0, U(i, k)) * F(i - 1, k) +
                   std::min(0.0, U(i, k)) * F(i, k);
      for (int i = -1; i <= nx + 2; ++i)
        WW(i, k) = std::max(0.0, W(i, k)) * F(i, kb) +
                   std::min(0.0, W(i, k)) * F(i, k);
      fl[k] = 0.0;
      for (int i = 1; i <= nx; ++i) fl[k] += WW(i, k);
    }
    for (int i = -1; i <= nx + 2; ++i) WW(i, nz - 1) = 0.0;  // top BC
    // stage 3: upwind update over i=-1..nx+2
    for (int k = 0; k < nzm; ++k) {
      const double irho = 1.0 / rh[k], iadz = 1.0 / az[k];
      for (int i = -1; i <= nx + 2; ++i)
        F(i, k) -= (UU(i + 1, k) - UU(i, k) +
                    (WW(i, k + 1) - WW(i, k)) * iadz) *
                   irho;
    }
    // stage 4: antidiffusive pseudo-velocities
    for (int k = 0; k < nzm; ++k) {
      const int kc = std::min(nzm - 1, k + 1), kb = std::max(0, k - 1);
      const double irho = 1.0 / rh[k];
      const double irhow = 1.0 / (rw[k] * az[k]);
      const double dd = 2.0 / (kc - kb == 0 ? 1 : kc - kb) / az[k];
      for (int i = 0; i <= nx + 2; ++i) {
        const int ib = i - 1;
        UU(i, k) =
            andiff(F(ib, k), F(i, k), U(i, k), irho) -
            across(dd * (F(ib, kc) + F(i, kc) - F(ib, kb) - F(i, kb)),
                   U(i, k),
                   W(ib, k) + W(ib, kc) + W(i, k) + W(i, kc)) *
                irho;
      }
      for (int i = 0; i <= nx + 1; ++i) {
        const int ib = i - 1, ic = i + 1;
        WW(i, k) =
            andiff(F(i, kb), F(i, k), W(i, k), irhow) -
            across(F(ic, kb) + F(ic, k) - F(ib, kb) - F(ib, k), W(i, k),
                   U(i, kb) + U(i, k) + U(ic, k) + U(ic, kb)) *
                irho;
      }
    }
    for (int i = -1; i <= nx + 2; ++i) WW(i, 0) = 0.0;  // bottom BC
    // stage 5a: second extrema with updated f
    for (int k = 0; k < nzm; ++k) {
      const int kc = std::min(nzm - 1, k + 1), kb = std::max(0, k - 1);
      for (int i = 0; i <= nx + 1; ++i) {
        MX(i, k) = std::max({MX(i, k), F(i - 1, k), F(i + 1, k), F(i, kb),
                             F(i, kc), F(i, k)});
        MN(i, k) = std::min({MN(i, k), F(i - 1, k), F(i + 1, k), F(i, kb),
                             F(i, kc), F(i, k)});
      }
    }
    // stage 5b: in/out flux ratios
    for (int k = 0; k < nzm; ++k) {
      const int kc = std::min(nzm - 1, k + 1);
      const double iadz = 1.0 / az[k];
      for (int i = 0; i <= nx + 1; ++i) {
        const double outflux = pn(UU(i + 1, k)) + pp(UU(i, k)) +
                               iadz * (pn(WW(i, kc)) + pp(WW(i, k)));
        const double influx = pp(UU(i + 1, k)) + pn(UU(i, k)) +
                              iadz * (pp(WW(i, kc)) + pn(WW(i, k)));
        MX(i, k) = rh[k] * (MX(i, k) - F(i, k)) / (outflux + eps);
        MN(i, k) = rh[k] * (F(i, k) - MN(i, k)) / (influx + eps);
      }
    }
    // stage 5c: limit fluxes + accumulate flux
    for (int k = 0; k < nzm; ++k) {
      const int kb = std::max(0, k - 1);
      for (int i = 1; i <= nx + 1; ++i) {
        const double v = UU(i, k);
        UU(i, k) = pp(v) * std::min({1.0, MX(i, k), MN(i - 1, k)}) -
                   pn(v) * std::min({1.0, MX(i - 1, k), MN(i, k)});
      }
      for (int i = 1; i <= nx; ++i) {
        const double v = WW(i, k);
        WW(i, k) = pp(v) * std::min({1.0, MX(i, k), MN(i, kb)}) -
                   pn(v) * std::min({1.0, MX(i, kb), MN(i, k)});
        fl[k] += WW(i, k);
      }
    }
    // stage 6: final update with positive clip
    for (int k = 0; k < nzm; ++k) {
      const double irho = 1.0 / rh[k], iadz = 1.0 / az[k];
      for (int i = 1; i <= nx; ++i)
        F(i, k) = std::max(
            0.0, F(i, k) - (UU(i + 1, k) - UU(i, k) +
                            (WW(i, k + 1) - WW(i, k)) * iadz) *
                               irho);
    }
  }
}

}  // extern "C"
