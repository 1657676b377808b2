"""Trusted jnp reference of the CKE nested-loop edge-flux kernel.

Semantics match the reference's original CPU form
(nested_loops/nested.F90:119-157, 495-564):

    wgt(k,e)  = normalThicknessFlux(k,e) · advMaskHighOrder(k,e)
    sgn(k,e)  = sign(1, normalThicknessFlux(k,e))      (+1 for ntf ≥ 0)
    flx(k,e)  = Σ_{i=1..nAdv} tracerCur(k, advCellsForEdge(i,e))
                · wgt(k,e) · (advCoefs(i,e) + advCoefs3rd(i,e)
                              · coef3rdOrder · sgn(k,e))

with the k-range restriction k ∈ [minLevelCell, maxLevelCell] of the
contributing CELL (:137-152).  The GPU-optimized forms replace the k bounds
with a cellMask multiply (:609-625) — identical results because tracerCur is
zero outside the active range by construction (:71-83); we follow the
masked-form convention (`tracer · cellMask`), the idempotent safety net the
reference's forms 2/3 apply every iteration (:297-310).

Formulation: the irregular per-edge gather becomes one XLA gather along
the cell axis — the gather index is per-(edge, i) and uniform across the
vertical, so columns stay contiguous (the key layout property; SURVEY §7
"hard parts") — followed by two (edge, adv)×(edge, adv, k) contractions,
one for the 2nd-order and one for the sign-corrected 3rd-order term, at
precision='highest' (a reference must not run in TF32):

    flx = wgt ⊙ (Σ_i c1·T[cells] + sgn ⊙ Σ_i c3·T[cells])
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cdk.core.registry import register
from cdk.kernels.cke.problem import CkeData


def fsign1(x):
    """Fortran sign(1, x): +1 for x ≥ 0 (including +0), −1 for x < 0.
    (jnp.sign would give 0 at 0.)"""
    return jnp.where(x >= 0, jnp.asarray(1.0, x.dtype),
                     jnp.asarray(-1.0, x.dtype))


def edge_flux(adv_cells, adv_coefs, adv_coefs3, tracer, cell_mask, ntf,
              adv_mask, coef3rdorder):
    """-> highOrderFlx (nedges, nvert)."""
    wgt = ntf * adv_mask
    sgn = fsign1(ntf)
    t = tracer * cell_mask
    tg = t[adv_cells]  # (nedges, nadv, nvert) gather along cells
    s1 = jnp.einsum("ea,eak->ek", adv_coefs, tg, precision="highest")
    s3 = jnp.einsum("ea,eak->ek", adv_coefs3, tg, precision="highest")
    return wgt * (s1 + coef3rdorder * s3 * sgn)


@register(
    "cke",
    "reference_jnp",
    "trusted jnp/XLA gather+contraction reference (original CPU form, "
    "nested.F90:119-157)",
)
def make_reference(cfg):
    c3 = cfg.np_dtype(cfg.coef3rdorder)

    @jax.jit
    def step(data: CkeData) -> jnp.ndarray:
        return edge_flux(
            data.adv_cells, data.adv_coefs, data.adv_coefs3, data.tracer,
            data.cell_mask, data.ntf, data.adv_mask, c3,
        )

    return step
