"""One-hot-matmul CKE variant: the irregular gather recast as dense matmuls.

The kernel is LINEAR in tracerCur for fixed connectivity/weights, so the
whole per-edge gather-accumulate (nested.F90:533-552) collapses to two
dense matrices applied per iteration:

    A1[e, c] = Σ_i advCoefs(i,e)    · δ(advCellsForEdge(i,e) = c)
    A3[e, c] = Σ_i advCoefs3rd(i,e) · δ(advCellsForEdge(i,e) = c)
    flx      = wgt ⊙ (A1 @ T + coef3rdOrder · sgn ⊙ (A3 @ T)),
    T        = tracerCur ⊙ cellMask          (ncells, nvert)

A1/A3 are built ONCE in setup (scatter-add over the static connectivity)
and the per-iteration cost is two (nedges × ncells) · nvert matmuls — at
the shipped size 25600×2800×100, ~28.7 GFLOP of dense work in place of
25.6M irregular gather-MACs, at ncells/nadv = 280× redundant FLOPs.  The
analog of what ekat::Pack SIMD (cke_impl1.cpp:22-35) does on the CPU.

Memory: A1/A3 are nedges·ncells·4 B ≈ 287 MB each at f32 on the shipped
size and grow with nedges·ncells, so the variant is a miniapp-size design
point; the gather forms are the production forms.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np

from cdk.core.registry import register
from cdk.kernels.cke.problem import CkeData
from cdk.kernels.cke.reference import fsign1


def build_connectivity_matrices(adv_cells, adv_coefs, adv_coefs3, ncells):
    """-> (A1, A3), each (nedges, ncells), scatter-add of per-(edge,i)
    weights onto their cell column (duplicate cells per edge accumulate,
    matching the reference's `flxTmp += …` loop, nested.F90:545-550)."""
    e, a = adv_cells.shape
    zeros = jnp.zeros((e, ncells), adv_coefs.dtype)
    rows = jnp.broadcast_to(jnp.arange(e)[:, None], (e, a))
    a1 = zeros.at[rows, adv_cells].add(adv_coefs)
    a3 = zeros.at[rows, adv_cells].add(adv_coefs3)
    return a1, a3


def apply_onehot(a1, a3, tracer, cell_mask, ntf, adv_mask, coef3rdorder,
                 precision="highest"):
    # precision="highest": at the default precision an f32 dot may run in
    # reduced precision (TF32 on the GPU) over the K=ncells contraction;
    # the bf16 variant opts out.
    t = (tracer * cell_mask).astype(a1.dtype)
    out_dt = tracer.dtype
    s1 = jnp.dot(a1, t, preferred_element_type=out_dt, precision=precision)
    s3 = jnp.dot(a3, t, preferred_element_type=out_dt, precision=precision)
    return ntf * adv_mask * (s1 + coef3rdorder * s3 * fsign1(ntf))


def _make_onehot(cfg, precision):
    c3 = cfg.np_dtype(cfg.coef3rdorder)
    ncells = cfg.ncells
    # dense-recast applicability: A1+A3 are 2*nedges*ncells floats,
    # device-resident and streamed per iteration (~57 GB at the production
    # 256k x 28k size), so past the device's dense-operand budget the
    # variant is a typed skip; the gather forms are the production forms
    from cdk.core.platform import dense_operand_budget

    itemsize = 2 if precision == "default" else np.dtype(cfg.np_dtype).itemsize
    need = 2 * cfg.nedges * ncells * itemsize
    if need > dense_operand_budget():
        from cdk.core.registry import UnsupportedConfigError

        raise UnsupportedConfigError(
            f"onehot_matmul: connectivity matrices would be "
            f"{need / 2**30:.1f} GiB > budget "
            f"{dense_operand_budget() / 2**30:.1f} GiB; use gather_peradv "
            f"at this scale"
        )
    # the bf16 speed point also STORES the connectivity matrices in bf16:
    # per-iteration device-memory streaming of A1/A3 halves (they dominate traffic at
    # 2 x nedges x ncells)
    store_dt = jnp.bfloat16 if precision == "default" else None

    @jax.jit
    def prepare(data: CkeData):
        # untimed connectivity staging, the analog of cke_init's one-time
        # deep_copy (nested.F90:400-403 is under timerData, not the
        # iteration loop)
        a1, a3 = build_connectivity_matrices(
            data.adv_cells, data.adv_coefs, data.adv_coefs3, ncells
        )
        if store_dt is not None:
            a1, a3 = a1.astype(store_dt), a3.astype(store_dt)
        return a1, a3

    @jax.jit
    def step(aux, data: CkeData) -> jnp.ndarray:
        a1, a3 = aux
        return apply_onehot(
            a1, a3, data.tracer, data.cell_mask, data.ntf, data.adv_mask,
            c3, precision,
        )

    return prepare, step


@register(
    "cke",
    "onehot_matmul",
    "gather recast as two dense (nedges x ncells) connectivity matmuls at "
    "precision='highest'; connectivity matrices prebuilt untimed (analog of "
    "cke_impl1's pack-SIMD flat form)",
)
def make_onehot_matmul(cfg):
    return _make_onehot(cfg, "highest")


@register(
    "cke",
    "onehot_matmul_bf16",
    "connectivity matrices stored in bf16 and applied at the default "
    "precision: the explicit precision/throughput trade point",
    supports_f64=False,
    fast_math=True,
)
def make_onehot_matmul_bf16(cfg):
    return _make_onehot(cfg, "default")
