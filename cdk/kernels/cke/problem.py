"""CKE (MPAS-Ocean nested-loop) problem data: shapes, deterministic init.

Reference semantics (nested_loops/nested.F90, nested_vars.F90):
  - per-cell: minLevelCell=1, maxLevelCell random in [3, nVertLevels] with
    ~half at max depth (topography-like, nested.F90:59-68); tracerCur =
    15·rand inside [kmin, kmax] else 0, cellMask 1/0 (:71-83).
  - per-edge: nAdvCellsForEdge = nAdv; advCellsForEdge random cell ids
    (worst-case gather locality by design, :51-57, 87-97); advCoefs =
    20·rand, advCoefs3rd = 21·rand (:90-96); normalThicknessFlux =
    15·(0.5 − rand), advMaskHighOrder = 1, highOrderFlx = 0 (:100-107).
  - the reference does NOT seed its RNG (:64); it relies on within-process
    comparison only. We use the framework's documented PCG64 stream instead
    (same replacement rationale as mpdata — see core/frng.py).

Layout: C-order (nEdges, nAdv) / (nEdges, nVertLevels) /
(nCells, nVertLevels) with the vertical column innermost and contiguous,
the analog of the reference's ekat::Pack / F90_PACK_SIZE pack padding of
nVertLevels (nested_vars.F90:94-100, cke_impl.hpp:21-22).
Cell indices are 0-based (the reference's C++ layer does the same 1→0 shift
when marshaling to Kokkos, cke.cpp:55-88 `delta=-1`).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from cdk.core.config import CkeConfig
from cdk.core.frng import HostRng


@jax.tree_util.register_dataclass
@dataclass
class CkeData:
    """Problem arrays, C-order, 0-based cell indices.

    adv_cells:   (nedges, nadv) int32 — contributing cell per (edge, i)
    adv_coefs:   (nedges, nadv)       — 2nd-order weights
    adv_coefs3:  (nedges, nadv)       — 3rd-order weights (× coef3rdOrder)
    tracer:      (ncells, nvert)      — zero outside [kmin, kmax]
    cell_mask:   (ncells, nvert)      — 1 inside [kmin, kmax], else 0
    ntf:         (nedges, nvert)      — normalThicknessFlux
    adv_mask:    (nedges, nvert)      — advMaskHighOrder (all ones)
    min_level:   (ncells,) int32      — 0-based kmin (all zero)
    max_level:   (ncells,) int32      — 0-based kmax (inclusive)
    """

    adv_cells: jnp.ndarray
    adv_coefs: jnp.ndarray
    adv_coefs3: jnp.ndarray
    tracer: jnp.ndarray
    cell_mask: jnp.ndarray
    ntf: jnp.ndarray
    adv_mask: jnp.ndarray
    min_level: jnp.ndarray
    max_level: jnp.ndarray

    def astype(self, dtype) -> "CkeData":
        cast = lambda a: (
            a if jnp.issubdtype(a.dtype, jnp.integer)
            else jnp.asarray(a, dtype=dtype)
        )
        return CkeData(
            self.adv_cells, cast(self.adv_coefs), cast(self.adv_coefs3),
            cast(self.tracer), cast(self.cell_mask), cast(self.ntf),
            cast(self.adv_mask), self.min_level, self.max_level,
        )


def init_data(cfg: CkeConfig = CkeConfig()) -> CkeData:
    if cfg.device_init:
        return _init_data_device(cfg)
    gen = HostRng(cfg.seed)
    c, e, kv, a = cfg.ncells, cfg.nedges, cfg.nvertlevels, cfg.nadv

    # topography: depth = min(max(3, round(rand·2·nVert)), nVert)  (1-based)
    depth = np.minimum(
        np.maximum(3, np.rint(gen.uniform(c) * kv * 2.0).astype(np.int64)), kv
    )
    min_level = np.zeros(c, np.int32)
    max_level = (depth - 1).astype(np.int32)  # 0-based inclusive

    k_idx = np.arange(kv)[None, :]
    active = (k_idx >= min_level[:, None]) & (k_idx <= max_level[:, None])
    tracer = np.where(active, 15.0 * gen.uniform((c, kv)), 0.0)
    cell_mask = active.astype(np.float64)

    adv_cells = np.minimum(
        (c * gen.uniform((e, a))).astype(np.int64), c - 1
    ).astype(np.int32)
    adv_coefs = 20.0 * gen.uniform((e, a))
    adv_coefs3 = 21.0 * gen.uniform((e, a))

    ntf = 15.0 * (0.5 - gen.uniform((e, kv)))
    adv_mask = np.ones((e, kv))

    dt = cfg.np_dtype
    return CkeData(
        jnp.asarray(adv_cells),
        jnp.asarray(adv_coefs, dt),
        jnp.asarray(adv_coefs3, dt),
        jnp.asarray(tracer, dt),
        jnp.asarray(cell_mask, dt),
        jnp.asarray(ntf, dt),
        jnp.asarray(adv_mask, dt),
        jnp.asarray(min_level),
        jnp.asarray(max_level),
    )


def _init_data_device(cfg: CkeConfig) -> CkeData:
    """On-device generation (production scale), same structure as the host
    path: random topography depth, masked tracer, random connectivity."""
    import jax.random as jr

    dt = cfg.np_dtype
    c, e, kv, a = cfg.ncells, cfg.nedges, cfg.nvertlevels, cfg.nadv
    k = jr.PRNGKey(cfg.seed)
    ks = jr.split(k, 7)
    u = lambda key, shape: jr.uniform(key, shape, dtype=jnp.float32).astype(dt)

    depth = jnp.minimum(
        jnp.maximum(3, jnp.round(
            jr.uniform(ks[0], (c,), dtype=jnp.float32) * kv * 2.0
        ).astype(jnp.int32)), kv)
    min_level = jnp.zeros((c,), jnp.int32)
    max_level = depth - 1
    k_idx = jnp.arange(kv)[None, :]
    active = (k_idx >= min_level[:, None]) & (k_idx <= max_level[:, None])
    tracer = jnp.where(active, 15.0 * u(ks[1], (c, kv)), 0).astype(dt)
    cell_mask = active.astype(dt)
    adv_cells = jr.randint(ks[2], (e, a), 0, c, dtype=jnp.int32)
    return CkeData(
        adv_cells,
        (20.0 * u(ks[3], (e, a))).astype(dt),
        (21.0 * u(ks[4], (e, a))).astype(dt),
        tracer,
        cell_mask,
        (15.0 * (0.5 - u(ks[5], (e, kv)))).astype(dt),
        jnp.ones((e, kv), dt),
        min_level,
        max_level,
    )
