"""biharmonic_dss: the TWO-application biharmonic with the DSS
element-boundary exchange the miniapp dropped.

The extracted reference kernel applies the weak Laplacian ONCE per
(element, tracer, level) (biharmonic_wk_kernel.F90:186-200) and is therefore
element-local; real HOMME applies it twice with a DSS (direct stiffness
summation) exchange between applications, which couples neighboring
elements — SURVEY §5 names this the deferred capability ("scales
embarrassingly until the real DSS exchange is added").  This module supplies
that capability with a defined synthetic topology:

  TOPOLOGY — periodic 1-D ring of elements along the j GLL axis: element
  e's j=np-1 GLL column is the SAME physical degree of freedom as element
  e+1's j=0 column (wrapping at nelemd).  The miniapp's elements carry no
  mesh, so the ring is the minimal topology that makes DSS a real
  neighbor exchange (ppermute-shaped, like the reference's deferred MPI
  plan, nested_loops/README.md:29-31).

  DSS — the weak-Laplacian output is a spheremp-weighted (mass-weighted)
  residual; assembly sums the contributions of all sharers of a dof and
  projects back with the assembled inverse mass:

      assembled(s)[dof] = Σ_sharers s / Σ_sharers spheremp
      interior dofs:      s / spheremp

  (HOMME's rspheremp ≙ 1/Σ spheremp.)  Both sharers compute the identical
  assembled value — the defining DSS property, which the N-device parity
  tests pin down.

  biharmonic_dss(q) = laplace_wk( dss( laplace_wk(q) ) )

Variants follow the house discipline (one trusted jnp form + fused
forms): the fused-operator forms apply the probed per-element 16×16
Laplacian matrix (operator.build_element_operator) twice with the
elementwise DSS between.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cdk.core.registry import register
from cdk.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    to_lane_layout,
)
from cdk.kernels.biharmonic.reference import laplace_sphere_wk


def dss_weights(spheremp: jnp.ndarray) -> jnp.ndarray:
    """Per-dof inverse assembled mass W (e, i, j): 1/spheremp at interior
    points, 1/(spheremp_e + spheremp_neighbor) on the shared j=0 / j=np-1
    columns of the periodic element ring.  Static per problem — computed
    once and reused every step (and precomputed per shard in the dist
    path so no spheremp columns ever travel)."""
    sp = spheremp
    mass = sp
    # right edge (j = np-1) pairs with right neighbor's j = 0 column
    m_r = sp[..., -1] + jnp.roll(sp, -1, axis=0)[..., 0]
    # left edge (j = 0) pairs with left neighbor's j = np-1 column
    m_l = sp[..., 0] + jnp.roll(sp, 1, axis=0)[..., -1]
    mass = jnp.concatenate(
        [m_l[..., None], sp[..., 1:-1], m_r[..., None]], axis=-1
    )
    return 1.0 / mass


def dss_apply(s, w, left_col, right_col):
    """Assemble with explicit neighbor columns (the dist building block).

    s:         (..., i, j) weak-form contributions
    w:         inverse assembled mass, broadcastable to s
    left_col:  (..., i) — LEFT neighbor's j=np-1 contribution column
    right_col: (..., i) — RIGHT neighbor's j=0 contribution column
    """
    summed = jnp.concatenate(
        [
            (s[..., 0] + left_col)[..., None],
            s[..., 1:-1],
            (s[..., -1] + right_col)[..., None],
        ],
        axis=-1,
    )
    return summed * w


def dss_ring(s: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Single-device DSS over the periodic element ring (roll = the
    zero-communication form of the neighbor exchange)."""
    left_col = jnp.roll(s, 1, axis=0)[..., -1]
    right_col = jnp.roll(s, -1, axis=0)[..., 0]
    return dss_apply(s, w, left_col, right_col)


def biharmonic_wk_dss_reference(qtens, dvv, dinv, spheremp, tensorvisc,
                                rrearth) -> jnp.ndarray:
    """laplace → DSS → laplace on (e, q, k, i, j) qtens."""
    bc = lambda a: a[:, None, None]
    lap = lambda x: laplace_sphere_wk(
        x, dvv, bc(dinv), bc(spheremp), bc(tensorvisc), rrearth
    )
    w = bc(dss_weights(spheremp))
    return lap(dss_ring(lap(qtens), w))


@register(
    "biharmonic_dss",
    "reference_jnp",
    "trusted jnp form: weak Laplacian twice with ring-DSS assembly between "
    "(the HOMME structure the miniapp extracts one application of, "
    "biharmonic_wk_kernel.F90:186-200 + SURVEY §5 deferred DSS)",
)
def make_reference(cfg):
    rr = cfg.np_dtype(cfg.rrearth)

    @jax.jit
    def step(data: BiharmonicData) -> jnp.ndarray:
        return biharmonic_wk_dss_reference(
            data.qtens, data.dvv, data.dinv, data.spheremp, data.tensorvisc,
            rr,
        )

    return step


def dss_ring_lane(s_lane: jnp.ndarray, w: jnp.ndarray, npg: int):
    """DSS in the (e, npts, ncol) lane layout (p = i*np + j flattened):
    the j=0 / j=np-1 GLL columns are the p % np == 0 / np-1 rows.
    w: (e, np, np) inverse assembled mass."""
    e, npts, ncol = s_lane.shape
    s4 = s_lane.reshape(e, npg, npg, ncol)        # (e, i, j, col)
    # roll only the boundary-column SLICES: rolling the full s4 twice
    # would materialize the whole field twice more per step
    left = jnp.roll(s4[:, :, -1], 1, axis=0)      # (e, i, col)
    right = jnp.roll(s4[:, :, 0], -1, axis=0)
    summed = jnp.concatenate(
        [
            (s4[:, :, 0] + left)[:, :, None],
            s4[:, :, 1:-1],
            (s4[:, :, -1] + right)[:, :, None],
        ],
        axis=2,
    )
    return (summed * w[..., None]).reshape(e, npts, ncol)


def _fused_dss_forms(cfg, precision):
    from cdk.kernels.biharmonic.operator import (
        apply_operator,
        build_element_operator,
    )

    rr = cfg.np_dtype(cfg.rrearth)
    npg = cfg.np_gll

    def _build(data):
        L = build_element_operator(
            data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr
        )
        return L, dss_weights(data.spheremp)  # (e,16,16), (e, i, j)

    @jax.jit
    def prepare(data: BiharmonicData):
        return _build(data)

    @jax.jit
    def step(aux, data: BiharmonicData) -> jnp.ndarray:
        L, w = aux
        q = to_lane_layout(data.qtens)
        s = apply_operator(L, q, precision)
        s = dss_ring_lane(s, w, npg)
        out = apply_operator(L, s, precision)
        return from_lane_layout(out, cfg)

    @functools.partial(jax.jit, static_argnames="n")
    def loop(data: BiharmonicData, n: int) -> jnp.ndarray:
        # carry the scan state in the lane layout: the qtens↔lane
        # conversion inside the body would relayout the whole field twice
        # per step
        L, w = _build(data)

        def body(q, _):
            s = apply_operator(L, q, precision)
            return apply_operator(L, dss_ring_lane(s, w, npg),
                                  precision), None

        out, _ = jax.lax.scan(body, to_lane_layout(data.qtens), None,
                              length=n)
        return from_lane_layout(out, cfg)

    return {"prepare": prepare, "step": step, "loop": loop}


@register(
    "biharmonic_dss",
    "fused_operator",
    "two probed 16x16-operator applications at precision='highest' with "
    "the elementwise DSS assembly between",
)
def make_fused_dss(cfg):
    return _fused_dss_forms(cfg, "highest")


@register(
    "biharmonic_dss",
    "fused_operator_tf32",
    "fused-operator DSS form at precision='default' (TF32 on the GPU; "
    "speed point)",
    supports_f64=False,
    fast_math=True,
)
def make_fused_dss_tf32(cfg):
    return _fused_dss_forms(cfg, "default")
