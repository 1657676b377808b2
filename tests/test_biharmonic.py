"""Biharmonic kernel: jnp reference vs an independent scalar-loop numpy
oracle, then every optimized variant vs the reference (the reference
driver's own protocol: trusted form first, variants verified against it,
biharmonic_wk_kernel.F90:545-580)."""

import numpy as np
import pytest

from cdk.core.config import BiharmonicConfig, with_overrides
from cdk.core.norms import rel_l2
from cdk.core import registry as _registry
from cdk.kernels.biharmonic import operator, problem, reference


def _step(cfg, name, data):
    return _registry.make_step(_registry.get("biharmonic", name), cfg, data)

SMALL = with_overrides(BiharmonicConfig(), nelemd=3, nlev=4, qsize=2)
RR = SMALL.rrearth


def oracle_laplace(s, dvv, dinv, sp, tv, rr):
    """Independent scalar-loop implementation of the weak tensor Laplacian
    (written from the mathematical definition, np=4 GLL)."""
    n = s.shape[0]
    v1 = np.zeros((n, n))
    v2 = np.zeros((n, n))
    for j in range(n):
        for l in range(n):
            dsdx = sum(dvv[i, l] * s[i, j] for i in range(n))
            dsdy = sum(dvv[i, l] * s[j, i] for i in range(n))
            v1[l, j] = dsdx * rr
            v2[j, l] = dsdy * rr
    ds = np.zeros((n, n, 2))
    for j in range(n):
        for i in range(n):
            ds[i, j, 0] = dinv[i, j, 0, 0] * v1[i, j] + dinv[i, j, 1, 0] * v2[i, j]
            ds[i, j, 1] = dinv[i, j, 0, 1] * v1[i, j] + dinv[i, j, 1, 1] * v2[i, j]
    g = np.zeros((n, n, 2))
    for j in range(n):
        for i in range(n):
            g[i, j, 0] = ds[i, j, 0] * tv[i, j, 0, 0] + ds[i, j, 1] * tv[i, j, 0, 1]
            g[i, j, 1] = ds[i, j, 0] * tv[i, j, 1, 0] + ds[i, j, 1] * tv[i, j, 1, 1]
    vt = np.zeros((n, n, 2))
    for j in range(n):
        for i in range(n):
            vt[i, j, 0] = dinv[i, j, 0, 0] * g[i, j, 0] + dinv[i, j, 0, 1] * g[i, j, 1]
            vt[i, j, 1] = dinv[i, j, 1, 0] * g[i, j, 0] + dinv[i, j, 1, 1] * g[i, j, 1]
    div = np.zeros((n, n))
    for nn in range(n):
        for m in range(n):
            acc = 0.0
            for j in range(n):
                acc -= (
                    sp[j, nn] * vt[j, nn, 0] * dvv[m, j]
                    + sp[m, j] * vt[m, j, 1] * dvv[nn, j]
                ) * rr
            div[m, nn] = acc
    return div


def oracle_biharmonic(data):
    dvv = np.asarray(data.dvv, np.float64)
    dinv = np.asarray(data.dinv, np.float64)
    sp = np.asarray(data.spheremp, np.float64)
    tv = np.asarray(data.tensorvisc, np.float64)
    q = np.asarray(data.qtens, np.float64)
    out = np.empty_like(q)
    e_, q_, k_ = q.shape[:3]
    for e in range(e_):
        for qq in range(q_):
            for k in range(k_):
                out[e, qq, k] = oracle_laplace(
                    q[e, qq, k], dvv, dinv[e], sp[e], tv[e], RR
                )
    return out


@pytest.fixture(scope="module")
def small_data():
    return problem.init_data(SMALL)


@pytest.fixture(scope="module")
def small_oracle(small_data):
    return oracle_biharmonic(small_data)


def test_init_matches_fortran_stream():
    """First LCG values land where the Fortran init puts them: Dvv is filled
    first (reset), column-major."""
    data = problem.init_data(SMALL)
    from tests.test_core import scalar_lcg

    vals, _ = scalar_lcg(16)
    dvv = np.asarray(data.dvv)
    # Fortran Dvv(i,l): i fastest
    k = 0
    for l in range(4):
        for i in range(4):
            assert dvv[i, l] == vals[k]
            k += 1


def test_reference_matches_oracle(small_data, small_oracle):
    step = reference.make_reference(SMALL)
    out = np.asarray(step(small_data))
    assert rel_l2(out, small_oracle) < 1e-14


def test_fused_operator_matches_reference(small_data, small_oracle):
    step = _step(SMALL, 'fused_operator', small_data)
    out = np.asarray(step(small_data))
    assert rel_l2(out, small_oracle) < 1e-13


def test_full_size_variants_agree():
    cfg = BiharmonicConfig()
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    op = np.asarray(_step(cfg, 'fused_operator', data)(data))
    assert rel_l2(op, ref) < 1e-12
    # the reference checks GPU2 L2 ≈ 1e-16 at f64; our operator variant
    # reassociates sums, so the tolerance is looser but still tiny.


def test_fused_operator_loop_matches_chained_steps(small_data):
    """The resident-layout loop equals n chained step() calls."""
    made = operator.make_fused_operator(SMALL)
    step, loop = made["step"], made["loop"]
    q = small_data
    out = q.qtens
    import dataclasses

    d = q
    for _ in range(3):
        out = step(d)
        d = dataclasses.replace(d, qtens=out)
    out_loop = loop(small_data, 3)
    assert rel_l2(np.asarray(out_loop), np.asarray(out)) < 1e-13


def test_fused_operator_f32_full_size():
    """The exact-f32 (precision='highest') fused operator stays inside the
    family's 1e-6 f32 gate at the shipped size."""
    cfg = BiharmonicConfig(dtype="float32")
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    out = np.asarray(_step(cfg, "fused_operator", data)(data))
    assert rel_l2(out, ref) < 1e-6


@pytest.mark.parametrize("budget,raises", [(1 << 10, True), (1 << 30, False)])
def test_fused_operator_bd_respects_dense_budget(monkeypatch, small_data,
                                                 small_oracle, budget,
                                                 raises):
    """The dense block-diagonal form is a typed skip once its operator
    outgrows the device's dense-operand budget, and exact below it."""
    from cdk.core import platform

    monkeypatch.setattr(platform, "dense_operand_budget", lambda: budget)
    if raises:
        with pytest.raises(_registry.UnsupportedConfigError):
            _step(SMALL, "fused_operator_bd", small_data)
        return
    out = np.asarray(_step(SMALL, "fused_operator_bd", small_data)(small_data))
    assert rel_l2(out, small_oracle) < 1e-13

