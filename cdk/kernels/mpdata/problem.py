"""MPDATA advect_scalar2D problem data: shapes, halos, deterministic init.

Reference semantics (mmf-mpdata-tracer/advect_scalar2D_pushncols_openacc.F90):
  - fields (Fortran, slice index fastest, j==1 dropped here):
      f   (nslices, i=-2..nx+3, k=1..nzm)   scalar tracer, 2/3-wide x halo
      u   (nslices, i=-1..nx+3, k=1..nzm)   horizontal mass flux at x-faces
      w   (nslices, i=-1..nx+2, k=1..nz )   vertical mass flux at z-faces
      rho (nslices, k=1..nzm), rhow (nslices, k=1..nz), adz (nslices, k=1..nzm)
      flux(nslices, k=1..nz)                 domain-summed vertical flux
    (array bounds advect_scalar2D…F90:16-38)
  - init: compiler `random_number` with seed 100 (advect…F90:645-665) — NOT
    portable across compilers, so (per the reference's own practice of only
    ever comparing within-process) we substitute a documented deterministic
    PCG64 stream. Deviations, with rationale:
      * u, w are drawn in [-0.5, 0.5): the reference's [0,1) init leaves
        every `min(0,u)` upwind branch dead; signed velocities exercise both.
      * rho, rhow, adz are drawn in [0.5, 1.5): they are divided by
        (advect…F90:552-567), and near-zero uniforms make the problem
        arbitrarily ill-conditioned, which would mask real variant bugs
        behind amplification noise.

Layout: C-order (nslices, x, z) with z innermost. The reference pushes
nslices to the fastest dimension for CPU SIMD ("pushncols",
advect…F90:30-46); here the contiguous z-column is innermost and nslices
is a pure batch axis (one slice per thread block in the CUDA kernel,
kernels/mpdata/hopper.py).

Python x-index conventions (0-based offsets from the Fortran lower bounds):
  f :  ix = i + 2   (i in [-2, nx+3], size nx+6)
  u :  ix = i + 1   (i in [-1, nx+3], size nx+5)
  w :  ix = i + 1   (i in [-1, nx+2], size nx+4)
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from cdk.core.config import MpdataConfig
from cdk.core.frng import HostRng


@jax.tree_util.register_dataclass
@dataclass
class MpdataData:
    """Problem arrays, C-order (nslices, x, z).

    f:    (nslices, nx+6, nzm)
    u:    (nslices, nx+5, nzm)
    w:    (nslices, nx+4, nz)
    rho:  (nslices, nzm)
    rhow: (nslices, nz)
    adz:  (nslices, nzm)
    flux: (nslices, nz)   — input values; the kernel overwrites k<nzm and
                            passes k=nz-1 through (the reference never
                            writes flux(:,nz), advect…F90:540-547)
    """

    f: jnp.ndarray
    u: jnp.ndarray
    w: jnp.ndarray
    rho: jnp.ndarray
    rhow: jnp.ndarray
    adz: jnp.ndarray
    flux: jnp.ndarray

    def astype(self, dtype) -> "MpdataData":
        return MpdataData(
            *(jnp.asarray(a, dtype=dtype) for a in (
                self.f, self.u, self.w, self.rho, self.rhow, self.adz,
                self.flux))
        )


def init_data(cfg: MpdataConfig = MpdataConfig()) -> MpdataData:
    """Deterministic init from one documented PCG64 stream (draw order
    mirrors the reference's: adz, f, u, w, rho, rhow, flux,
    advect…F90:654-660)."""
    if cfg.device_init:
        return _init_data_device(cfg)
    gen = HostRng(cfg.seed)
    s, nx, nz, nzm = cfg.nslices, cfg.nx, cfg.nz, cfg.nzm
    adz = gen.uniform((s, nzm)) + 0.5
    f = gen.uniform((s, nx + 6, nzm))
    u = gen.uniform((s, nx + 5, nzm)) - 0.5
    w = gen.uniform((s, nx + 4, nz)) - 0.5
    rho = gen.uniform((s, nzm)) + 0.5
    rhow = gen.uniform((s, nz)) + 0.5
    flux = gen.uniform((s, nz))
    dt = cfg.np_dtype
    return MpdataData(
        jnp.asarray(f, dt), jnp.asarray(u, dt), jnp.asarray(w, dt),
        jnp.asarray(rho, dt), jnp.asarray(rhow, dt), jnp.asarray(adz, dt),
        jnp.asarray(flux, dt),
    )


def _init_data_device(cfg: MpdataConfig) -> MpdataData:
    """On-device generation (production scale), same shapes/distributions
    as the host path."""
    import jax.random as jr

    dt = cfg.np_dtype
    s, nx, nz, nzm = cfg.nslices, cfg.nx, cfg.nz, cfg.nzm
    k = jr.PRNGKey(cfg.seed)
    ks = jr.split(k, 7)
    u = lambda key, shape: jr.uniform(key, shape, dtype=jnp.float32).astype(dt)
    return MpdataData(
        u(ks[1], (s, nx + 6, nzm)),
        u(ks[2], (s, nx + 5, nzm)) - dt(0.5),
        u(ks[3], (s, nx + 4, nz)) - dt(0.5),
        u(ks[4], (s, nzm)) + dt(0.5),
        u(ks[5], (s, nz)) + dt(0.5),
        u(ks[0], (s, nzm)) + dt(0.5),
        u(ks[6], (s, nz)),
    )
