"""Biharmonic_wk problem data: shapes, deterministic init, layouts.

Reference semantics (atmosphere/biharmonic_wk_kernel.F90):
  - fields: Dvv(np,np) derivative matrix; per element Dinv(np,np,2,2),
    spheremp(np,np), tensorVisc(np,np,2,2); state qtens(np,np,nlev,qsize,
    nelemd) (:19-33).
  - init: myrandom LCG with reset, filling in the exact order
    Dvv, then per element (Dinv, spheremp, tensorVisc), then qtens
    (:48-58). Our `init_data` reproduces that stream bit-exactly.

Layout: the logical (i, j) in [0,np)² GLL point grid is kept as trailing
(np, np) axes for the reference implementation and flattened to a single
16-point axis for the optimized variants, with the fused (qsize, nlev)
batch — the reference push-loop's len = nlev*qsize = 2880
(biharmonic_wk_kernel.F90:533) — as the contiguous innermost axis.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import jax
import jax.numpy as jnp
import numpy as np

from cdk.core.config import BiharmonicConfig
from cdk.core.frng import Lcg


@jax.tree_util.register_dataclass
@dataclass
class BiharmonicData:
    """Problem arrays in C-order numpy/jax layout.

    dvv:        (np, np)                — indexed [i, l] like Fortran Dvv(i,l)
    dinv:       (nelemd, np, np, 2, 2)  — [e, i, j, a, b] ≙ Dinv(i,j,a+1,b+1)
    spheremp:   (nelemd, np, np)
    tensorvisc: (nelemd, np, np, 2, 2)
    qtens:      (nelemd, qsize, nlev, np, np) — [e, q, k, i, j]
    """

    dvv: jnp.ndarray
    dinv: jnp.ndarray
    spheremp: jnp.ndarray
    tensorvisc: jnp.ndarray
    qtens: jnp.ndarray

    def astype(self, dtype) -> "BiharmonicData":
        return BiharmonicData(
            *(jnp.asarray(a, dtype=dtype) for a in (
                self.dvv, self.dinv, self.spheremp, self.tensorvisc, self.qtens))
        )


def init_data(cfg: BiharmonicConfig = BiharmonicConfig()) -> BiharmonicData:
    """Deterministic init, bit-identical to the reference initialize_data
    (biharmonic_wk_kernel.F90:48-58): LCG reset to seed 11, then fill
    Dvv, per-element (Dinv, spheremp, tensorVisc), then qtens, each array
    traversed in Fortran column-major order.

    With cfg.device_init, arrays are instead generated ON DEVICE from a
    jax.random stream (same shapes/distributions; production scale where
    transferring hundreds of MB of host arrays is the bottleneck and
    Fortran-stream parity is not the point)."""
    if cfg.device_init:
        return _init_data_device(cfg)
    n = cfg.np_gll
    gen = Lcg()
    dvv = gen.fill_fortran((n, n))
    dinv = np.empty((cfg.nelemd, n, n, 2, 2))
    spheremp = np.empty((cfg.nelemd, n, n))
    tensorvisc = np.empty((cfg.nelemd, n, n, 2, 2))
    for e in range(cfg.nelemd):
        dinv[e] = gen.fill_fortran((n, n, 2, 2))
        spheremp[e] = gen.fill_fortran((n, n))
        tensorvisc[e] = gen.fill_fortran((n, n, 2, 2))
    # Fortran qtens(i,j,k,q,ie) -> ours [e,q,k,i,j]
    q_f = gen.fill_fortran((n, n, cfg.nlev, cfg.qsize, cfg.nelemd))
    qtens = np.ascontiguousarray(q_f.transpose(4, 3, 2, 0, 1))
    dt = cfg.np_dtype
    return BiharmonicData(
        jnp.asarray(dvv, dt),
        jnp.asarray(dinv, dt),
        jnp.asarray(spheremp, dt),
        jnp.asarray(tensorvisc, dt),
        jnp.asarray(qtens, dt),
    )


def flatten_gll(x: jnp.ndarray) -> jnp.ndarray:
    """Flatten trailing (np, np) point axes to one 16-point axis (C order:
    p = i*np + j)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def to_lane_layout(qtens: jnp.ndarray) -> jnp.ndarray:
    """(e, q, k, i, j) -> (e, npts, ncol): GLL points on the middle axis,
    the fused (q, k) batch innermost — the layout the optimized variants
    consume."""
    e, q, k, n, _ = qtens.shape
    return qtens.reshape(e, q * k, n * n).transpose(0, 2, 1)


def from_lane_layout(q_lane: jnp.ndarray, cfg: BiharmonicConfig) -> jnp.ndarray:
    """Inverse of to_lane_layout."""
    e = q_lane.shape[0]
    n = cfg.np_gll
    return q_lane.transpose(0, 2, 1).reshape(e, cfg.qsize, cfg.nlev, n, n)


def _init_data_device(cfg: BiharmonicConfig) -> BiharmonicData:
    import jax.random as jr

    dt = cfg.np_dtype
    n = cfg.np_gll
    k = jr.PRNGKey(11)
    ks = jr.split(k, 5)
    u = lambda key, shape: jr.uniform(key, shape, dtype=jnp.float32).astype(dt)
    return BiharmonicData(
        u(ks[0], (n, n)),
        u(ks[1], (cfg.nelemd, n, n, 2, 2)),
        u(ks[2], (cfg.nelemd, n, n)),
        u(ks[3], (cfg.nelemd, n, n, 2, 2)),
        u(ks[4], (cfg.nelemd, cfg.qsize, cfg.nlev, n, n)),
    )
