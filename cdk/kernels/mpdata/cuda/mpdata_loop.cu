// MPDATA n-step loop for NVIDIA Hopper, called from JAX through jax.ffi.
//
// One CRM slice per thread block.  The block copies its slice's f, u, w
// and per-level coefficients into shared memory once, runs every stage of
// every time step there (threads stride over a stage's points,
// __syncthreads between stages), and writes f and the flux back once.
// Device-memory traffic is one read of the inputs and one write of the
// outputs per call, whatever the number of steps.  The per-point
// arithmetic lives in mpdata_stages.h, which the host build shares.
//
// Build (cdk.kernels.mpdata.hopper.build does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o <lib>.so \
//        mpdata_loop.cu
#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "mpdata_stages.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

using cdk_mpdata::Slice;

constexpr int kThreads = 256;

template <typename T>
size_t smem_bytes(int nx, int K) {
  size_t n = (size_t)(nx + 6) * K + (size_t)(nx + 5) * K
             + (size_t)(nx + 4) * K + (size_t)(nx + 5) * K
             + (size_t)(nx + 4) * (K + 1) + 2 * (size_t)(nx + 2) * K
             + 6 * (size_t)K;
  return n * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mpdata_loop_kernel(const T* __restrict__ f_in, const T* __restrict__ u,
                   const T* __restrict__ w, const T* __restrict__ rho,
                   const T* __restrict__ rhow, const T* __restrict__ adz,
                   const T* __restrict__ flux_in, T* __restrict__ f_out,
                   T* __restrict__ flux_out, int nx, int nz, int nsteps) {
  using namespace cdk_mpdata;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = nz - 1;
  const int64_t sl = blockIdx.x;
  const int tid = threadIdx.x;
  T* f = reinterpret_cast<T*>(smem_raw);
  T* us = f + (nx + 6) * K;
  T* ws = us + (nx + 5) * K;
  T* uuu = ws + (nx + 4) * K;
  T* www = uuu + (nx + 5) * K;
  T* mx = www + (nx + 4) * (K + 1);
  T* mn = mx + (nx + 2) * K;
  T* c_rho = mn + (nx + 2) * K;
  T* irho = c_rho + K;
  T* iadz = irho + K;
  T* dd = iadz + K;
  T* irhow = dd + K;
  T* flx = irhow + K;

  const T* fs = f_in + sl * (nx + 6) * K;
  for (int p = tid; p < (nx + 6) * K; p += kThreads) f[p] = fs[p];
  const T* usrc = u + sl * (nx + 5) * K;
  for (int p = tid; p < (nx + 5) * K; p += kThreads) us[p] = usrc[p];
  const T* wsrc = w + sl * (nx + 4) * nz;
  for (int p = tid; p < (nx + 4) * nz; p += kThreads) {
    int x = p / nz, k = p % nz;
    if (k < K) ws[x * K + k] = wsrc[p];
    else www[x * (K + 1) + K] = T(0);
  }
  for (int k = tid; k < K; k += kThreads)
    level_coefs(k, K, rho + sl * K, rhow + sl * nz, adz + sl * K, c_rho,
                irho, iadz, dd, irhow);
  __syncthreads();

  Slice<T> s{f, us, ws, uuu, www, mx, mn, c_rho, irho, iadz, dd, irhow,
             flx, nx, K};
  for (int step = 0; step < nsteps; ++step) {
    for (int p = tid; p < stage1_points(s); p += kThreads) stage1(s, p);
    __syncthreads();
    for (int p = tid; p < stage2_points(s); p += kThreads) stage2(s, p);
    __syncthreads();
    for (int p = tid; p < stage3_points(s); p += kThreads) stage3(s, p);
    __syncthreads();
    for (int p = tid; p < stage4_points(s); p += kThreads) stage4(s, p);
    __syncthreads();
    for (int p = tid; p < stage5_points(s); p += kThreads) stage5(s, p);
    __syncthreads();
    for (int p = tid; p < stage6_points(s); p += kThreads) stage6(s, p);
    __syncthreads();
  }

  T* fo = f_out + sl * (nx + 6) * K;
  for (int p = tid; p < (nx + 6) * K; p += kThreads) fo[p] = f[p];
  for (int k = tid; k < nz; k += kThreads)
    flux_out[sl * nz + k] =
        (nsteps > 0 && k < K) ? flx[k] : flux_in[sl * nz + k];
}

template <typename T>
ffi::Error launch(cudaStream_t stream, ffi::AnyBuffer f, ffi::AnyBuffer u,
                  ffi::AnyBuffer w, ffi::AnyBuffer rho, ffi::AnyBuffer rhow,
                  ffi::AnyBuffer adz, ffi::AnyBuffer flux,
                  ffi::Result<ffi::AnyBuffer> f_out,
                  ffi::Result<ffi::AnyBuffer> flux_out, int64_t nsteps) {
  auto d = f.dimensions();
  const int ns = (int)d[0], nx = (int)d[1] - 6, K = (int)d[2], nz = K + 1;
  if (ns == 0) return ffi::Error::Success();
  const size_t smem = smem_bytes<T>(nx, K);
  auto kern = mpdata_loop_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess)
    return ffi::Error::Internal(std::string("cudaFuncSetAttribute: ")
                                + cudaGetErrorString(e));
  kern<<<ns, kThreads, smem, stream>>>(
      reinterpret_cast<const T*>(f.untyped_data()),
      reinterpret_cast<const T*>(u.untyped_data()),
      reinterpret_cast<const T*>(w.untyped_data()),
      reinterpret_cast<const T*>(rho.untyped_data()),
      reinterpret_cast<const T*>(rhow.untyped_data()),
      reinterpret_cast<const T*>(adz.untyped_data()),
      reinterpret_cast<const T*>(flux.untyped_data()),
      reinterpret_cast<T*>(f_out->untyped_data()),
      reinterpret_cast<T*>(flux_out->untyped_data()), nx, nz, (int)nsteps);
  e = cudaGetLastError();
  if (e != cudaSuccess)
    return ffi::Error::Internal(std::string("mpdata_loop_kernel: ")
                                + cudaGetErrorString(e));
  return ffi::Error::Success();
}

ffi::Error MpdataLoopImpl(cudaStream_t stream, ffi::AnyBuffer f,
                          ffi::AnyBuffer u, ffi::AnyBuffer w,
                          ffi::AnyBuffer rho, ffi::AnyBuffer rhow,
                          ffi::AnyBuffer adz, ffi::AnyBuffer flux,
                          ffi::Result<ffi::AnyBuffer> f_out,
                          ffi::Result<ffi::AnyBuffer> flux_out,
                          int64_t nsteps) {
  if (f.dimensions().size() != 3 || nsteps < 0)
    return ffi::Error::InvalidArgument("f must be (nslices, nx+6, nzm)");
  switch (f.element_type()) {
    case ffi::DataType::F32:
      return launch<float>(stream, f, u, w, rho, rhow, adz, flux, f_out,
                           flux_out, nsteps);
    case ffi::DataType::F64:
      return launch<double>(stream, f, u, w, rho, rhow, adz, flux, f_out,
                            flux_out, nsteps);
    default:
      return ffi::Error::InvalidArgument("mpdata loop takes f32 or f64");
  }
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    CdkMpdataLoop, MpdataLoopImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::AnyBuffer>()  // f
        .Arg<ffi::AnyBuffer>()  // u
        .Arg<ffi::AnyBuffer>()  // w
        .Arg<ffi::AnyBuffer>()  // rho
        .Arg<ffi::AnyBuffer>()  // rhow
        .Arg<ffi::AnyBuffer>()  // adz
        .Arg<ffi::AnyBuffer>()  // flux
        .Ret<ffi::AnyBuffer>()  // f_out
        .Ret<ffi::AnyBuffer>()  // flux_out
        .Attr<int64_t>("nsteps"));
