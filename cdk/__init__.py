"""cdk — a JAX reimplementation of E3SM's codesign-kernels suite.

A JAX/XLA framework (with one CUDA kernel reached through jax.ffi)
providing the capabilities of E3SM-Project/codesign-kernels: three climate
co-design benchmark kernels, each with a trusted reference implementation,
accelerator-optimized variants for NVIDIA GPUs, deterministic
initialization, in-process timing, and tolerance verification — plus the
multi-card domain decomposition (halo exchange between cards) the
reference deferred.

Kernels:
  - biharmonic: HOMME spectral-element tensor-hyperviscosity weak Laplacian
    (reference: atmosphere/biharmonic_wk_kernel.F90)
  - mpdata: SAM/MMF MPDATA positive-definite monotonic 2-D tracer advection
    (reference: mmf-mpdata-tracer/advect_scalar2D_pushncols_openacc.F90)
  - cke: MPAS-Ocean high-order edge-flux nested-loop gather kernel
    (reference: nested_loops/nested.F90 + cke_*.cpp)
"""

__version__ = "0.1.0"

from cdk.core import config, frng, norms, timer  # noqa: F401
