"""CKE kernel: jnp reference vs an independent scalar-loop oracle written
from the original-form semantics (kmin/kmax bounds, per-edge column temps,
nested.F90:495-564), then variants vs the reference at the reference's own
errTol=1e-10 per-point check (nested.F90:267-287)."""

import numpy as np
import pytest

from cdk.core.config import CkeConfig, with_overrides
from cdk.core.norms import pointwise_check
from cdk.core import registry as _registry
from cdk.kernels.cke import problem, reference


def _onehot_step(cfg, data):
    return _registry.make_step(_registry.get("cke", "onehot_matmul"), cfg, data)

SMALL = with_overrides(CkeConfig(), nedges=40, ncells=12, nvertlevels=7, nadv=4)


def oracle_edge_flux(data, coef3rdorder):
    """Scalar-loop original form: per-edge wgt/sgn column temps, gather over
    contributing cells, k restricted to the cell's [kmin, kmax]."""
    adv_cells = np.asarray(data.adv_cells)
    c1 = np.asarray(data.adv_coefs, np.float64)
    c3a = np.asarray(data.adv_coefs3, np.float64)
    tracer = np.asarray(data.tracer, np.float64)
    ntf = np.asarray(data.ntf, np.float64)
    adv_mask = np.asarray(data.adv_mask, np.float64)
    kmin = np.asarray(data.min_level)
    kmax = np.asarray(data.max_level)
    e, a = adv_cells.shape
    kv = tracer.shape[1]
    flx = np.zeros((e, kv))
    for ie in range(e):
        wgt = ntf[ie] * adv_mask[ie]
        sgn = np.where(ntf[ie] >= 0.0, 1.0, -1.0)
        for i in range(a):
            ic = adv_cells[ie, i]
            coef1 = c1[ie, i]
            coef3 = c3a[ie, i] * coef3rdorder
            for k in range(kmin[ic], kmax[ic] + 1):
                flx[ie, k] += tracer[ic, k] * wgt[k] * (coef1 + coef3 * sgn[k])
    return flx


@pytest.fixture(scope="module")
def small_data():
    return problem.init_data(SMALL)


@pytest.fixture(scope="module")
def small_oracle(small_data):
    return oracle_edge_flux(small_data, SMALL.coef3rdorder)


def test_init_topography():
    d = problem.init_data(SMALL)
    mx = np.asarray(d.max_level)
    assert (mx >= 2).all() and (mx <= SMALL.nvertlevels - 1).all()
    tr = np.asarray(d.tracer)
    cm = np.asarray(d.cell_mask)
    # tracer is zero exactly where the mask is zero (nested.F90:71-83)
    assert (tr[cm == 0.0] == 0.0).all()
    assert (tr[cm == 1.0] >= 0.0).all()


def test_reference_matches_oracle(small_data, small_oracle):
    step = reference.make_reference(SMALL)
    out = np.asarray(step(small_data))
    n_bad, max_err, lines = pointwise_check(out, small_oracle, SMALL.errtol)
    assert n_bad == 0, "\n".join(lines)


def test_onehot_matches_reference(small_data):
    ref = np.asarray(reference.make_reference(SMALL)(small_data))
    out = np.asarray(_onehot_step(SMALL, small_data)(small_data))
    n_bad, max_err, _ = pointwise_check(out, ref, SMALL.errtol)
    assert n_bad == 0


def test_duplicate_cells_accumulate():
    """Two identical (edge, i) entries must contribute twice (the reference
    accumulates, nested.F90:545-550)."""
    d = problem.init_data(SMALL)
    dup_cells = np.asarray(d.adv_cells).copy()
    dup_cells[:, 1] = dup_cells[:, 0]
    import jax.numpy as jnp

    d2 = problem.CkeData(
        jnp.asarray(dup_cells), d.adv_coefs, d.adv_coefs3, d.tracer,
        d.cell_mask, d.ntf, d.adv_mask, d.min_level, d.max_level,
    )
    ref = np.asarray(reference.make_reference(SMALL)(d2))
    oracle = oracle_edge_flux(d2, SMALL.coef3rdorder)
    onehot = np.asarray(_onehot_step(SMALL, d2)(d2))
    assert pointwise_check(ref, oracle, SMALL.errtol)[0] == 0
    assert pointwise_check(onehot, ref, SMALL.errtol)[0] == 0


def test_shipped_namelist_size():
    """Full nested.nml problem (nIters timing aside): variants agree at
    errTol on the shipped 25600x2800x100 size."""
    cfg = CkeConfig()
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    out = np.asarray(_onehot_step(cfg, data)(data))
    n_bad, max_err, lines = pointwise_check(out, ref, cfg.errtol)
    assert n_bad == 0, f"max_err={max_err}\n" + "\n".join(lines[:5])


def test_onehot_matmul_midsize_f32():
    cfg = with_overrides(
        CkeConfig(), nedges=512, ncells=300, nvertlevels=40, dtype="float32"
    )
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    out = np.asarray(_onehot_step(cfg, data)(data))
    # f32 variant vs f32 reference: same-dtype parity, looser than errTol
    from cdk.core.norms import rel_l1

    assert rel_l1(out, ref) < 1e-6


@pytest.mark.parametrize("budget,raises", [(1 << 10, True), (1 << 30, False)])
def test_onehot_matmul_respects_dense_budget(monkeypatch, small_data,
                                            budget, raises):
    """The dense recast is a typed skip once its connectivity matrices
    outgrow the device's dense-operand budget."""
    from cdk.core import platform

    monkeypatch.setattr(platform, "dense_operand_budget", lambda: budget)
    if raises:
        with pytest.raises(_registry.UnsupportedConfigError):
            _onehot_step(SMALL, small_data)
        return
    ref = np.asarray(reference.make_reference(SMALL)(small_data))
    out = np.asarray(_onehot_step(SMALL, small_data)(small_data))
    assert pointwise_check(out, ref, SMALL.errtol)[0] == 0


def test_reference_contractions_pin_highest_precision(small_data):
    """The reference's contractions ask for precision='highest', so a
    backend's reduced-precision default (TF32 on the GPU) never applies."""
    import jax

    jaxpr = jax.make_jaxpr(reference.make_reference(SMALL))(small_data)
    dots = [e for e in jaxpr.eqns[0].params["jaxpr"].eqns
            if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        assert all(p == jax.lax.Precision.HIGHEST
                   for p in e.params["precision"]), e.params["precision"]


def test_gather_peradv_matches_oracle(small_data, small_oracle):
    from cdk.kernels.cke import gather_peradv

    out = np.asarray(gather_peradv.make_gather_peradv(SMALL)(small_data))
    n_bad, max_err, lines = pointwise_check(out, small_oracle, SMALL.errtol)
    assert n_bad == 0, "\n".join(lines)


@pytest.mark.parametrize("geometry", [
    (512, 96, 30, 7),     # mid-size, odd slot count
    (300, 400, 21, 6),    # more cells than edges, odd level count
    (128, 700, 12, 10),   # many cells per edge block
])
@pytest.mark.parametrize("name", ["gather_peradv", "onehot_matmul"])
def test_exact_variants_midsize(geometry, name):
    """Exact variants at mid-size configs: f64 pointwise at errTol vs the
    reference (the slot-order accumulation contract, nested.F90:533-552)."""
    from cdk.core.registry import make_step, get

    ne, nc, nv, na = geometry
    cfg = with_overrides(CkeConfig(), nedges=ne, ncells=nc, nvertlevels=nv,
                         nadv=na)
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    out = np.asarray(make_step(get("cke", name), cfg, data)(data))
    n_bad, max_err, _ = pointwise_check(out, ref, cfg.errtol)
    assert n_bad == 0, (name, max_err)
