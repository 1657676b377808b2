"""biharmonic_dss2d: two-application biharmonic with a TWO-DIMENSIONAL
element-grid DSS — edges in both GLL directions plus 4-way corner dofs.

The ring-DSS family (dss.py) supplies the deferred exchange capability on
the minimal 1-D topology; real HOMME elements live on a 2-D quadrilateral
mesh (the cube sphere) where every element shares EDGES with 4 neighbors
and CORNER dofs with (generically) 4 elements, and the DSS sums over all
sharers of each dof (biharmonic_wk_kernel.F90:186-200 extracts one
application of exactly this structure; SURVEY §5 names the exchange as the
deferred capability).  This module supplies the 2-D structure with a
defined synthetic topology:

  TOPOLOGY — periodic (ex, ey) torus of elements, flattened row-major
  e = a*ey + b.  Element (a, b):
    * its j = np-1 GLL column is the same physical dof column as element
      (a, b+1 mod ey)'s j = 0 column        (x / intra-row direction);
    * its i = np-1 GLL row is the same physical dof row as element
      (a+1 mod ex, b)'s i = 0 row           (y / inter-row direction);
    * each corner dof is shared by FOUR elements (e.g. (i,j)=(np-1,np-1)
      of (a,b) ≡ (0,np-1) of (a+1,b) ≡ (np-1,0) of (a,b+1) ≡ (0,0) of
      (a+1,b+1)) — the torus is the minimal topology with HOMME's 4-way
      corner multiplicity (cube-sphere corners of valence 3 differ only
      in the sharer count, not in the assembly algebra).

  DSS — assembled(s)[dof] = Σ_sharers s / Σ_sharers spheremp, evaluated
  as TWO passes: a j-direction edge sum (full columns, corners included)
  followed by an i-direction edge sum OF THE ALREADY j-SUMMED rows.  The
  second pass's boundary rows carry the first pass's corner partial sums,
  so the 4-way corner total emerges from two nearest-neighbor exchanges —
  no diagonal communication is ever needed.  This two-pass identity is
  what makes the distributed form ppermute-only on a 2-D device mesh
  (dist/biharmonic.make_dist_step_dss2d).

  biharmonic_dss2d(q) = laplace_wk( dss2d( laplace_wk(q) ) )

Variants follow the house discipline: a trusted jnp reference plus
fused-operator forms (the apply is element-local and identical to the
ring family's; only the assembly differs).
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


def torus_shape(nelemd: int) -> tuple[int, int]:
    """Most-square (ex, ey) factorization with ey <= ex (shipped nelemd=16
    -> 4x4; production 5400 -> 75x72).  ey is the fast (element-row)
    direction the flattening e = a*ey + b keeps contiguous.  Prime counts degenerate to the 1-D ring topology (ey=1: the
    j-direction pairs an element with itself through the wrap, which the
    assembly handles but tests avoid)."""
    ey = int(nelemd**0.5)
    while nelemd % ey:
        ey -= 1
    return nelemd // ey, ey


def _edge_pair_sum(s: jnp.ndarray, eax: int, gax: int) -> jnp.ndarray:
    """One direction's shared-edge sum: along GLL axis `gax`, boundary
    slice 0 gains the `eax`-rolled(+1) neighbor's boundary slice n-1 and
    slice n-1 gains the rolled(-1) neighbor's slice 0.  Only the two
    boundary slices are rolled (rolling the full field materializes it
    twice more — the dss_ring_lane lesson).  Axis-parameterized so the
    same pass serves both the (…, i, j) reference layout and the
    (…, i, j, ncol) lane layout."""
    from jax import lax

    n = s.shape[gax]
    lo0 = lax.slice_in_dim(s, 0, 1, axis=gax)
    hi0 = lax.slice_in_dim(s, n - 1, n, axis=gax)
    mid = lax.slice_in_dim(s, 1, n - 1, axis=gax)
    lo = lo0 + jnp.roll(hi0, 1, axis=eax)
    hi = hi0 + jnp.roll(lo0, -1, axis=eax)
    return jnp.concatenate([lo, mid, hi], axis=gax)


def dss2d_sum(s5: jnp.ndarray, iax: int = -2, jax_: int = -1) -> jnp.ndarray:
    """Σ_sharers over the torus: j pass then i pass of the j-summed field
    (corners get all four sharers through the two-pass composition).
    s5: (ex, ey, ...) with the GLL i/j axes at iax/jax_."""
    return _edge_pair_sum(_edge_pair_sum(s5, 1, jax_), 0, iax)


def dss2d_weights(spheremp: jnp.ndarray, ex: int, ey: int) -> jnp.ndarray:
    """Inverse assembled mass W (e, np, np): 1/spheremp at interior dofs,
    1/(2-sum) on shared edges, 1/(4-sum) at corners — the same two-pass
    sum applied to spheremp itself (HOMME's rspheremp).  Static per
    problem; the dist path shards the precomputed field so no spheremp
    dofs ever travel at step time."""
    n = spheremp.shape[-1]
    sp5 = spheremp.reshape(ex, ey, n, n)
    return (1.0 / dss2d_sum(sp5)).reshape(spheremp.shape)


def dss_torus(s: jnp.ndarray, w: jnp.ndarray, ex: int, ey: int) -> jnp.ndarray:
    """Single-device DSS on (e, ..., i, j): assemble shared dofs over the
    torus and project back with the inverse assembled mass.  Both (all
    four, at corners) sharers compute the identical assembled value — the
    defining DSS property the parity tests pin down."""
    s5 = s.reshape(ex, ey, *s.shape[1:])
    return (dss2d_sum(s5).reshape(s.shape)) * w


def biharmonic_wk_dss2d_reference(qtens, dvv, dinv, spheremp, tensorvisc,
                                  rrearth, ex: int, ey: int) -> jnp.ndarray:
    """laplace → torus-DSS → laplace on (e, q, k, i, j) qtens."""
    bc = lambda a: a[:, None, None]
    lap = lambda x: laplace_sphere_wk(
        x, dvv, bc(dinv), bc(spheremp), bc(tensorvisc), rrearth
    )
    w = bc(dss2d_weights(spheremp, ex, ey))
    return lap(dss_torus(lap(qtens), w, ex, ey))


@register(
    "biharmonic_dss2d",
    "reference_jnp",
    "trusted jnp form: weak Laplacian twice with the 2-D torus DSS between "
    "(edge + 4-way corner assembly — the full HOMME DSS structure; the "
    "ring family's 1-D topology is the j-direction subcase)",
)
def make_reference(cfg):
    rr = cfg.np_dtype(cfg.rrearth)
    ex, ey = torus_shape(cfg.nelemd)

    @jax.jit
    def step(data: BiharmonicData) -> jnp.ndarray:
        return biharmonic_wk_dss2d_reference(
            data.qtens, data.dvv, data.dinv, data.spheremp, data.tensorvisc,
            rr, ex, ey,
        )

    return step


def dss2d_lane(s_lane: jnp.ndarray, w_lane: jnp.ndarray, ex: int, ey: int,
               npg: int) -> jnp.ndarray:
    """Torus DSS in the (e, npts, ncol) lane layout (p = i*np + j): the
    j-direction boundary columns are the p % np ∈ {0, np-1} rows,
    the i-direction boundary rows the p ∈ [0,np) / [npts-np, npts) slices.
    w_lane: (e, npts, 1) inverse assembled mass in the same layout."""
    e, npts, ncol = s_lane.shape
    s5 = s_lane.reshape(ex, ey, npg, npg, ncol)
    summed = dss2d_sum(s5, iax=2, jax_=3)
    return (summed.reshape(e, npts, ncol)) * w_lane


def _fused_dss2d_forms(cfg, precision):
    from cdk.kernels.biharmonic.operator import (
        apply_operator,
        build_element_operator,
    )

    rr = cfg.np_dtype(cfg.rrearth)
    npg = cfg.np_gll
    ex, ey = torus_shape(cfg.nelemd)

    def _build(data):
        L = build_element_operator(
            data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr
        )
        w = dss2d_weights(data.spheremp, ex, ey)
        return L, w.reshape(cfg.nelemd, cfg.npts, 1)

    @jax.jit
    def prepare(data: BiharmonicData):
        return _build(data)

    @jax.jit
    def step(aux, data: BiharmonicData) -> jnp.ndarray:
        L, w = aux
        q = to_lane_layout(data.qtens)
        s = apply_operator(L, q, precision)
        s = dss2d_lane(s, w, ex, ey, npg)
        return from_lane_layout(apply_operator(L, s, precision), cfg)

    @functools.partial(jax.jit, static_argnames="n")
    def loop(data: BiharmonicData, n: int) -> jnp.ndarray:
        # lane-layout carry: the qtens↔lane conversion is hoisted out of
        # the scan body (as in the dss.py loop)
        L, w = _build(data)

        def body(q, _):
            s = apply_operator(L, q, precision)
            return apply_operator(L, dss2d_lane(s, w, ex, ey, npg),
                                  precision), None

        out, _ = jax.lax.scan(body, to_lane_layout(data.qtens), None,
                              length=n)
        return from_lane_layout(out, cfg)

    return {"prepare": prepare, "step": step, "loop": loop}


@register(
    "biharmonic_dss2d",
    "fused_operator",
    "two probed 16x16-operator applications at precision='highest' with "
    "the torus-DSS assembly between",
)
def make_fused_dss2d(cfg):
    return _fused_dss2d_forms(cfg, "highest")


@register(
    "biharmonic_dss2d",
    "fused_operator_tf32",
    "fused-operator torus-DSS form at precision='default' (TF32 on the "
    "GPU; speed point)",
    supports_f64=False,
    fast_math=True,
)
def make_fused_dss2d_tf32(cfg):
    return _fused_dss2d_forms(cfg, "default")
