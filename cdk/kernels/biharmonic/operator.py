"""Fused-operator biharmonic variant: per-element 16×16 Laplacian matrix.

For fixed element matrices (Dvv, Dinv, spheremp, tensorVisc),
`laplace_sphere_wk` is a LINEAR map on the 16 GLL points of a level, so
the whole kernel collapses to one batched contraction

    qtens[e, :, col] = L[e] @ qtens[e, :, col],   L[e] ∈ R^{16×16}

over the fused (qsize*nlev) column batch.  L[e] is built ONCE by probing
the trusted reference with the 16 identity basis fields (exact, since the
operator is linear); the per-step cost is then 16×16×ncol MACs per
element, with the field read once and written once.

This is the fused analog of the reference's push-loop restructuring
(biharmonic_wk_kernel.F90:369-536), which fuses (nlev, qsize) into
len=2880 but still walks gradient → visc → divergence as three directive
kernels.

Precision: every contraction here states its precision.  On the GPU an
f32 dot at the default precision may run in TF32 (about three decimal
digits); "highest" keeps f32.  The exact variants use "highest"; the
"default" variant is registered as fast-math.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cdk.core.registry import register
from cdk.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    to_lane_layout,
)
from cdk.kernels.biharmonic.reference import laplace_sphere_wk


def build_element_operator(dvv, dinv, spheremp, tensorvisc, rrearth) -> jnp.ndarray:
    """L: (nelemd, npts, npts) with out_flat = L[e] @ s_flat, built by
    applying the trusted reference to the identity basis (exact for a
    linear operator)."""
    n = dvv.shape[0]
    npts = n * n
    basis = jnp.eye(npts, dtype=dvv.dtype).reshape(npts, n, n)

    def probe(e_dinv, e_sp, e_tv):
        # out[b] = laplace applied to basis vector b -> (npts, n, n)
        out = laplace_sphere_wk(
            basis, dvv, e_dinv[None], e_sp[None], e_tv[None], rrearth
        )
        # L[p_out, p_in] = out[p_in] at flattened p_out
        return out.reshape(npts, npts).T

    return jax.vmap(probe)(dinv, spheremp, tensorvisc)


def apply_operator(L: jnp.ndarray, q_lane: jnp.ndarray,
                   precision="highest") -> jnp.ndarray:
    """q_lane: (e, npts, ncol) -> L[e] @ q_lane[e], batched over elements."""
    return jnp.einsum(
        "eop,epc->eoc", L, q_lane, preferred_element_type=q_lane.dtype,
        precision=precision,
    )


def blockdiag_operator(L: jnp.ndarray) -> jnp.ndarray:
    """Assemble the per-element 16×16 operators into one dense block-diagonal
    (nelemd*npts, nelemd*npts) matrix: one dense matmul in place of nelemd
    tiny batched ones, at nelemd× redundant zero-FLOPs and (nelemd·16)²
    operator bytes — a demonstration form for miniapp sizes."""
    e, npts, _ = L.shape
    eye = jnp.eye(e, dtype=L.dtype)
    # (e, o, e', p) with L[e] on the diagonal
    bd = jnp.einsum("eop,ef->eofp", L, eye)
    return bd.reshape(e * npts, e * npts)


def apply_operator_blockdiag(Lbd: jnp.ndarray, q_flat: jnp.ndarray,
                             precision="highest") -> jnp.ndarray:
    """q_flat: (e*npts, ncol) -> Lbd @ q_flat, one dense matmul."""
    return jnp.dot(Lbd, q_flat, preferred_element_type=q_flat.dtype,
                   precision=precision)


def _fused_operator_forms(cfg, precision):
    rr = cfg.np_dtype(cfg.rrearth)

    @jax.jit
    def step(data: BiharmonicData) -> jnp.ndarray:
        L = build_element_operator(
            data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr
        )
        out = apply_operator(L, to_lane_layout(data.qtens),
                             precision=precision)
        return from_lane_layout(out, cfg)

    @functools.partial(jax.jit, static_argnames="n")
    def loop(data: BiharmonicData, n: int) -> jnp.ndarray:
        """n chained applications with qtens resident in lane layout —
        the reference's nIters loop over device-resident push-loop data;
        layout conversion happens once at each end, not per step."""
        L = build_element_operator(
            data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr
        )

        def body(q, _):
            return apply_operator(L, q, precision=precision), None

        out, _ = lax.scan(body, to_lane_layout(data.qtens), None, length=n)
        return from_lane_layout(out, cfg)

    return {"step": step, "loop": loop}


@register(
    "biharmonic",
    "fused_operator",
    "per-element 16x16 fused Laplacian matrix applied as one batched "
    "contraction over the fused column batch at precision='highest' "
    "(fusion of the reference push-loop, biharmonic_wk_kernel.F90:369-536)",
)
def make_fused_operator(cfg):
    return _fused_operator_forms(cfg, "highest")


@register(
    "biharmonic",
    "fused_operator_bd",
    "block-diagonal dense assembly of the per-element operators: the whole "
    "timestep is ONE (e*16, e*16) x (e*16, ncol) matmul (miniapp sizes)",
)
def make_fused_operator_bd(cfg):
    from cdk.core.platform import dense_operand_budget

    rr = cfg.np_dtype(cfg.rrearth)
    e, npts, ncol = cfg.nelemd, cfg.npts, cfg.ncol
    need = (e * npts) ** 2 * np.dtype(cfg.np_dtype).itemsize
    if need > dense_operand_budget():
        # typed unsupported-at-this-config skip (the driver reports it
        # with this reason; crashes still FAIL)
        from cdk.core.registry import UnsupportedConfigError

        raise UnsupportedConfigError(
            f"fused_operator_bd: dense operator would be "
            f"{need / 2**30:.1f} GiB > budget "
            f"{dense_operand_budget() / 2**30:.1f} GiB; use fused_operator"
        )

    @jax.jit
    def step(data: BiharmonicData) -> jnp.ndarray:
        L = build_element_operator(
            data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr
        )
        q_flat = to_lane_layout(data.qtens).reshape(e * npts, ncol)
        out = apply_operator_blockdiag(blockdiag_operator(L), q_flat)
        return from_lane_layout(out.reshape(e, npts, ncol), cfg)

    return step


@register(
    "biharmonic",
    "fused_operator_tf32",
    "fused-operator contraction at precision='default', which the GPU runs "
    "in TF32 (speed point of the precision/throughput trade; use "
    "fused_operator for verification-grade f32)",
    supports_f64=False,
    fast_math=True,
)
def make_fused_operator_tf32(cfg):
    return _fused_operator_forms(cfg, "default")
