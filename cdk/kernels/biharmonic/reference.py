"""Trusted jnp reference implementation of the biharmonic_wk weak Laplacian.

Semantics match the reference CPU kernel module `biharmonic_wk_scalar_cpu`
(atmosphere/biharmonic_wk_kernel.F90:100-202) — despite the miniapp's name,
the extracted kernel applies the tensor-HV weak Laplacian ONCE per
(element, tracer, level):

  gradient_sphere (:109-134):
      v1(l,j) = rrearth * Σ_i Dvv(i,l) s(i,j)       (x-derivative)
      v2(j,l) = rrearth * Σ_i Dvv(i,l) s(j,i)       (y-derivative)
      ds_a = Dinv(:,:,1,a) v1 + Dinv(:,:,2,a) v2    (contravariant→latlon)
  tensorVisc contraction (:173-180):
      g_a = Σ_b tensorVisc(:,:,a,b) ds_b
  divergence_sphere_wk (:138-160):
      vt_a = Σ_b Dinv(:,:,a,b) g_b
      div(m,n) = -rrearth Σ_j [ spheremp(j,n) vt1(j,n) Dvv(m,j)
                              + spheremp(m,j) vt2(m,j) Dvv(n,j) ]

Everything is expressed as einsums over the trailing (i, j) GLL axes,
batched over (nelemd, qsize, nlev) — the jnp analog of the reference's
"push-loop" restructuring (loops pushed into the operators with the
(nlev, qsize) batch fused, biharmonic_wk_kernel.F90:369-536). XLA
parallelizes these the way OpenACC directives parallelize the Fortran.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cdk.core.registry import register
from cdk.kernels.biharmonic.problem import BiharmonicData


def _bcast(elem_field: jnp.ndarray) -> jnp.ndarray:
    """Broadcast a per-element (e, i, j[, ...]) field over the (q, k) batch
    axes of qtens (e, q, k, i, j)."""
    return elem_field[:, None, None]


def _contract_l(dvv, s):
    """out[..., l, j] = Σ_i dvv[i, l] s[..., i, j], unrolled over the np=4
    GLL axis.  A 4-term contraction is far too small for a matrix unit,
    and unrolled elementwise FMAs stay exact f32 whatever the backend's
    default dot precision."""
    n = dvv.shape[0]
    return sum(dvv[i, :, None] * s[..., i, None, :] for i in range(n))


def gradient_sphere(s, dvv, dinv, rrearth):
    """s: (..., i, j) -> ds: tuple of 2 arrays (..., i, j)."""
    # v1[l,j] = rr * Σ_i dvv[i,l] s[i,j];  v2[j,l] = rr * Σ_i dvv[i,l] s[j,i]
    v1 = rrearth * _contract_l(dvv, s)
    v2 = rrearth * jnp.swapaxes(
        _contract_l(dvv, jnp.swapaxes(s, -1, -2)), -1, -2
    )
    ds1 = dinv[..., 0, 0] * v1 + dinv[..., 1, 0] * v2
    ds2 = dinv[..., 0, 1] * v1 + dinv[..., 1, 1] * v2
    return ds1, ds2


def divergence_sphere_wk(v1, v2, dvv, dinv, spheremp, rrearth):
    vt1 = dinv[..., 0, 0] * v1 + dinv[..., 0, 1] * v2
    vt2 = dinv[..., 1, 0] * v1 + dinv[..., 1, 1] * v2
    n = dvv.shape[0]
    x = spheremp * vt1
    y = spheremp * vt2
    # t1[m,n] = Σ_j dvv[m,j] x[j,n];  t2[m,n] = Σ_j dvv[n,j] y[m,j]
    # (unrolled elementwise form — see _contract_l)
    t1 = sum(dvv[:, j, None] * x[..., j, None, :] for j in range(n))
    t2 = sum(dvv[None, :, j] * y[..., :, j, None] for j in range(n))
    return -rrearth * (t1 + t2)


def laplace_sphere_wk(s, dvv, dinv, spheremp, tensorvisc, rrearth):
    ds1, ds2 = gradient_sphere(s, dvv, dinv, rrearth)
    g1 = ds1 * tensorvisc[..., 0, 0] + ds2 * tensorvisc[..., 0, 1]
    g2 = ds1 * tensorvisc[..., 1, 0] + ds2 * tensorvisc[..., 1, 1]
    return divergence_sphere_wk(g1, g2, dvv, dinv, spheremp, rrearth)


def biharmonic_wk_reference(
    qtens, dvv, dinv, spheremp, tensorvisc, rrearth
) -> jnp.ndarray:
    """Apply the weak Laplacian to every (e, q, k) slab of qtens."""
    return laplace_sphere_wk(
        qtens,
        dvv,
        _bcast(dinv),
        _bcast(spheremp),
        _bcast(tensorvisc),
        rrearth,
    )


@register(
    "biharmonic",
    "reference_jnp",
    "trusted jnp/XLA einsum reference (analog of the Fortran CPU form, "
    "biharmonic_wk_kernel.F90:186-200)",
)
def make_reference(cfg):
    rr = cfg.np_dtype(cfg.rrearth)

    @jax.jit
    def step(data: BiharmonicData) -> jnp.ndarray:
        return biharmonic_wk_reference(
            data.qtens, data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr
        )

    return step
