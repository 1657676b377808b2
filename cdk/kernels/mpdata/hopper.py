"""MPDATA on NVIDIA Hopper: a CUDA kernel called through `jax.ffi`.

One CRM slice per thread block: the block keeps its slice's f, u, w and
every intermediate field in shared memory (one 38×57 f32 plane is 8.7 KB),
runs all stages of all n time steps there, and touches device memory once
on the way in and once on the way out.  The XLA-compiled reference loop
instead reads f, u and w from device memory every step.  This is the
design of the reference's GPU variants (openacc_1 and openacc_2,
advect…F90:247-474), with the time loop moved inside the kernel.

The per-point arithmetic is cuda/mpdata_stages.h; its serial host driver
(cuda/mpdata_host.cpp, built into cpp/libcdk_host.so) is what the CPU
tests check against the reference, since a CUDA kernel has no interpret
mode.  The shared library is built from cuda/ with nvcc at first use into
`build/cuda/` (gitignored); `python -m cdk.kernels.mpdata.hopper`
builds it ahead of time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np

from cdk.core.registry import UnsupportedConfigError, register
from cdk.kernels.mpdata.problem import MpdataData

_SRC = Path(__file__).resolve().parent / "cuda"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "cuda"
_TARGET = "cdk_mpdata_loop"
# a block may use at most 227 KB of shared memory on Hopper
SMEM_LIMIT = 227 * 1024


def smem_bytes(nx: int, nzm: int, itemsize: int) -> int:
    """Shared memory one block needs (mirrors smem_bytes in the .cu):
    f, u, w, uuu, www (one extra top level), mx, mn and six per-level
    vectors."""
    k = nzm
    n = ((nx + 6) * k + 2 * (nx + 5) * k + (nx + 4) * k
         + (nx + 4) * (k + 1) + 2 * (nx + 2) * k + 6 * k)
    return n * itemsize


def nvcc_command(out: Path) -> list[str]:
    nvcc = shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
        "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-I", str(_SRC),
        "-o", str(out), str(_SRC / "mpdata_loop.cu"),
    ]


def library_path() -> Path:
    """Build output path, keyed by a hash of the sources so an edited
    kernel is rebuilt rather than loaded stale."""
    h = hashlib.sha256()
    for name in ("mpdata_loop.cu", "mpdata_stages.h"):
        h.update((_SRC / name).read_bytes())
    return _BUILD / f"libcdk_mpdata_{h.hexdigest()[:12]}.so"


def build() -> Path:
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.CdkMpdataLoop), platform="CUDA")


def check_supported(cfg) -> None:
    """Raise UnsupportedConfigError unless this kernel can run `cfg` here:
    a GPU backend, f32 or f64, and a slice that fits one block's shared
    memory."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise UnsupportedConfigError(
            f"CUDA kernel needs a GPU; JAX's device is {platform!r}")
    if cfg.dtype not in ("float32", "float64"):
        raise UnsupportedConfigError(f"dtype {cfg.dtype} (f32/f64 only)")
    need = smem_bytes(cfg.nx, cfg.nzm, np.dtype(cfg.np_dtype).itemsize)
    if need > SMEM_LIMIT:
        raise UnsupportedConfigError(
            f"slice needs {need} B of shared memory > {SMEM_LIMIT}")


def mpdata_loop(data: MpdataData, nsteps: int):
    """n MPDATA steps in one kernel launch -> (f, flux), the same values
    as n chained reference.advect_scalar2d steps."""
    _register()
    call = jax.ffi.ffi_call(
        _TARGET,
        (jax.ShapeDtypeStruct(data.f.shape, data.f.dtype),
         jax.ShapeDtypeStruct(data.flux.shape, data.flux.dtype)),
    )
    return call(data.f, data.u, data.w, data.rho, data.rhow, data.adz,
                data.flux, nsteps=np.int64(nsteps))


@register(
    "mpdata",
    "hopper_fused",
    "CUDA kernel (jax.ffi): one CRM slice per thread block, all stages "
    "fused in shared memory, the n-step time loop inside the kernel",
)
def make_hopper_fused(cfg):
    check_supported(cfg)

    @jax.jit
    def step(data: MpdataData):
        return mpdata_loop(data, 1)

    @functools.partial(jax.jit, static_argnames="n")
    def loop(data: MpdataData, n: int):
        return mpdata_loop(data, n)

    return {"step": step, "loop": loop}


if __name__ == "__main__":
    print(build())
