"""Per-adv-column gather CKE variant.

One XLA gather per contributing-cell slot — `nAdv` gathers of (nedges,)
rows each — with the weighted accumulate fused into the gather consumer,
in place of the single (nedges, nadv) row gather of the reference
formulation.  Cost scales with nedges·nadv·nvert.  The distributed CKE
loop (dist/cke.py) runs this form on each shard.

Exact same arithmetic as the reference per (edge, i) term; sums accumulate
in slot order i = 0..nadv-1 like the Fortran inner loop
(nested.F90:533-552), so f64 parity holds at errTol.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cdk.core.registry import register
from cdk.kernels.cke.problem import CkeData
from cdk.kernels.cke.reference import fsign1


def edge_flux_peradv(adv_cells, adv_coefs, adv_coefs3, tracer, cell_mask,
                     ntf, adv_mask, coef3rdorder):
    t = tracer * cell_mask
    e, a = adv_cells.shape
    s1 = jnp.zeros(ntf.shape, t.dtype)
    s3 = jnp.zeros(ntf.shape, t.dtype)
    for i in range(a):  # static unroll over contributing-cell slots
        g = jnp.take(t, adv_cells[:, i], axis=0)  # (nedges, nvert)
        s1 = s1 + adv_coefs[:, i:i + 1] * g
        s3 = s3 + adv_coefs3[:, i:i + 1] * g
    return ntf * adv_mask * (s1 + coef3rdorder * s3 * fsign1(ntf))


@register(
    "cke",
    "gather_peradv",
    "per-adv-slot column gathers (nAdv 1-D-indexed XLA gathers, weighted "
    "accumulate fused) with exact arithmetic",
)
def make_gather_peradv(cfg):
    c3 = cfg.np_dtype(cfg.coef3rdorder)

    @jax.jit
    def step(data: CkeData) -> jnp.ndarray:
        return edge_flux_peradv(
            data.adv_cells, data.adv_coefs, data.adv_coefs3, data.tracer,
            data.cell_mask, data.ntf, data.adv_mask, c3,
        )

    return step
