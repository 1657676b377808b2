"""Two-application biharmonic with ring-DSS: single-device semantics,
variant parity through the harness, and the N-device ppermute decomposition
(serialized + overlapped) vs the single-device reference."""

import numpy as np
import pytest

from cdk.core.config import BiharmonicConfig, with_overrides
from cdk.core.norms import rel_l2
from cdk.dist import biharmonic as dist_bi
from cdk.dist import mesh as meshmod
from cdk.kernels.biharmonic import dss, problem

CFG = BiharmonicConfig()  # nelemd=16


def test_dss_shared_dofs_agree():
    """The defining DSS property: after assembly, both sharers of a GLL
    column hold the identical value (out[e][..., -1] == out[e+1][..., 0])."""
    data = problem.init_data(CFG)
    s = np.asarray(
        dss.dss_ring(
            data.qtens, dss.dss_weights(data.spheremp)[:, None, None]
        )
    )
    left = s[..., -1]
    right = np.roll(s, -1, axis=0)[..., 0]
    np.testing.assert_allclose(left, right, rtol=0, atol=0)


def test_dss_interior_is_mass_projection():
    """Interior dofs are untouched by assembly: dss == s/spheremp there."""
    data = problem.init_data(CFG)
    w = dss.dss_weights(data.spheremp)
    s = np.asarray(data.qtens)
    out = np.asarray(dss.dss_ring(data.qtens, w[:, None, None]))
    sp = np.asarray(data.spheremp)[:, None, None]
    np.testing.assert_allclose(
        out[..., 1:-1], s[..., 1:-1] / sp[..., 1:-1], rtol=1e-14
    )


def test_dss_ring_lane_matches_full_field():
    """The lane-layout DSS (the fused forms' carry layout) computes the
    same assembly as dss_ring on the (e, ..., i, j) reference layout."""
    import jax.numpy as jnp

    from cdk.kernels.biharmonic.problem import (
        from_lane_layout,
        to_lane_layout,
    )

    cfg = with_overrides(BiharmonicConfig(), nelemd=6, nlev=3, qsize=2)
    data = problem.init_data(cfg)
    w = dss.dss_weights(data.spheremp)
    ref = dss.dss_ring(data.qtens, w[:, None, None])
    out = from_lane_layout(
        dss.dss_ring_lane(to_lane_layout(data.qtens), jnp.asarray(w),
                          cfg.np_gll), cfg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-15, atol=0)


def test_dss_loops_match_chained_steps():
    """The variants' resident-layout loops == chaining their steps."""
    from cdk.core.registry import _materialize, get

    cfg = with_overrides(BiharmonicConfig(), nelemd=8, nlev=4, qsize=2)
    data = problem.init_data(cfg)
    for name in ("fused_operator", "fused_operator_tf32"):
        step2, aux, loop = _materialize(get("biharmonic_dss", name), cfg,
                                        data)
        assert loop is not None
        import dataclasses

        q = data.qtens
        for _ in range(3):
            q = step2(aux, dataclasses.replace(data, qtens=q))
        out = loop(data, 3)
        assert rel_l2(np.asarray(out), np.asarray(q)) < 1e-6, name


@pytest.mark.parametrize("nelemd", [8, 5])
def test_dss_fused_loop_matches_chained_reference(nelemd):
    """The fused-operator loop (the production champion's timed path) ==
    chained reference steps at f64, for a short and a longer chain.
    (Multi-step f32 comparisons are vacuous here: the raw operator
    contracts ~1e-25/step, so chained fields underflow to exact zero —
    hence the f64 gate, like the suite's other f64 parity tests.)"""
    import dataclasses

    from cdk.core.registry import _materialize, get

    cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd, nlev=4,
                         qsize=2, dtype="float64")
    data = problem.init_data(cfg)
    ref_step, _, _ = _materialize(
        get("biharmonic_dss", "reference_jnp"), cfg, data)
    _, _, loop = _materialize(
        get("biharmonic_dss", "fused_operator"), cfg, data)
    for n in (3, 11):
        q = data.qtens
        for _ in range(n):
            q = ref_step((), dataclasses.replace(data, qtens=q))
        assert rel_l2(np.asarray(loop(data, n)), np.asarray(q)) < 1e-13, n


def test_dss_fused_single_step_f32():
    """The exact-f32 fused form passes the DSS-family f32 gate (1e-6) on
    one step; the TF32 form is fast-math and not held to it."""
    from cdk.core.registry import _materialize, get

    cfg = with_overrides(BiharmonicConfig(), nelemd=16, nlev=6, qsize=3,
                         dtype="float32")
    data = problem.init_data(cfg)
    ref_step, _, _ = _materialize(
        get("biharmonic_dss", "reference_jnp"), cfg, data)
    step2, aux, _ = _materialize(
        get("biharmonic_dss", "fused_operator"), cfg, data)
    e = rel_l2(np.asarray(step2(aux, data)),
               np.asarray(ref_step((), data)))
    assert e < 1e-6, e


@pytest.mark.parametrize("ndev,n", [(2, 8), (4, 4), (2, 3)])
def test_dss_dist_loop_matches_chained_reference(ndev, n):
    """The dist ring-DSS loop (boundary columns ppermuted every step) ==
    chained reference at f64."""
    import dataclasses

    from cdk.core.registry import _materialize, get

    cfg = with_overrides(BiharmonicConfig(), nelemd=32, nlev=4, qsize=2,
                         dtype="float64")
    data = problem.init_data(cfg)
    m = meshmod.make_mesh(ndev)
    shard_inputs, _, gather = dist_bi.make_dist_step_dss(cfg, m)
    loop = dist_bi.make_dist_loop_dss(cfg, m)
    q_s, aux = shard_inputs(data)
    out = gather(loop(q_s, aux, n))

    ref_step, _, _ = _materialize(
        get("biharmonic_dss", "reference_jnp"), cfg, data)
    q = data.qtens
    for _ in range(n):
        q = ref_step((), dataclasses.replace(data, qtens=q))
    assert rel_l2(out, np.asarray(q)) < 1e-12


def test_dss_variants_through_harness():
    from cdk.harness import driver

    cfg = with_overrides(BiharmonicConfig(), nelemd=4, nlev=4, qsize=2)
    res = driver.run_kernel("biharmonic_dss", cfg, iters=2, trials=1,
                            quiet=True)
    names = {r.variant for r in res}
    assert names >= {"reference_jnp", "fused_operator"}
    assert all(r.ok for r in res), [(r.variant, r.metrics) for r in res]


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("overlap", [False, True])
def test_dss_decomposed_matches_single(ndev, overlap):
    from cdk.kernels.biharmonic.dss import make_reference

    data = problem.init_data(CFG)
    ref = np.asarray(make_reference(CFG)(data))
    m = meshmod.make_mesh(ndev)
    shard_inputs, step, gather = dist_bi.make_dist_step_dss(
        CFG, m, overlap=overlap
    )
    q_s, aux = shard_inputs(data)
    out = gather(step(q_s, aux))
    # the dist path runs the probed-operator form; identity-basis probing
    # reassociates the 4x4 contractions (f64: ~1e-15 relative)
    assert rel_l2(out, ref) < 1e-12


def test_dss_overlap_matches_serial_exactly():
    """Overlapped and serialized dist forms are the same arithmetic —
    bitwise-identical outputs."""
    data = problem.init_data(CFG)
    m = meshmod.make_mesh(4)
    shard_inputs, step_s, gather = dist_bi.make_dist_step_dss(CFG, m)
    _, step_o, _ = dist_bi.make_dist_step_dss(CFG, m, overlap=True)
    q_s, aux = shard_inputs(data)
    a = gather(step_s(q_s, aux))
    b = gather(step_o(q_s, aux))
    np.testing.assert_array_equal(a, b)


def test_dss_multistep_chain():
    """Chained dist steps (output feeds back) track the single-device chain."""
    from cdk.kernels.biharmonic.dss import make_reference
    import jax.numpy as jnp
    from dataclasses import replace

    data = problem.init_data(CFG)
    ref_step = make_reference(CFG)
    m = meshmod.make_mesh(8)
    shard_inputs, step, gather = dist_bi.make_dist_step_dss(CFG, m)
    q_s, aux = shard_inputs(data)
    d = data
    for _ in range(3):
        q_ref = ref_step(d)
        d = replace(d, qtens=q_ref)
        q_s = step(q_s, aux)
    assert rel_l2(gather(q_s), np.asarray(q_ref)) < 1e-11


def test_dss_dist_loop_matches_chained():
    from cdk.kernels.biharmonic.dss import make_reference
    from dataclasses import replace

    data = problem.init_data(CFG)
    ref_step = make_reference(CFG)
    m = meshmod.make_mesh(4)
    shard_inputs, step, gather = dist_bi.make_dist_step_dss(CFG, m)
    loop = dist_bi.make_dist_loop_dss(CFG, m)
    q_s, aux = shard_inputs(data)
    out_loop = gather(loop(q_s, aux, 3))
    d = data
    for _ in range(3):
        q_ref = ref_step(d)
        d = replace(d, qtens=q_ref)
    assert rel_l2(out_loop, np.asarray(q_ref)) < 1e-11


@pytest.mark.parametrize("nelemd", [8, 5])
def test_dss_fused_step_matches_reference_and_loop_n1(nelemd):
    """One fused step == the reference at f64, and the loop's n=1 path
    (a single scan iteration) == that step."""
    from cdk.core.registry import _materialize, get

    cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd, nlev=4,
                         qsize=2, dtype="float64")
    data = problem.init_data(cfg)
    ref_step, _, _ = _materialize(
        get("biharmonic_dss", "reference_jnp"), cfg, data)
    step2, aux, loop = _materialize(
        get("biharmonic_dss", "fused_operator"), cfg, data)
    one = np.asarray(step2(aux, data))
    assert rel_l2(one, np.asarray(ref_step((), data))) < 1e-13
    np.testing.assert_array_equal(np.asarray(loop(data, 1)), one)


@pytest.mark.parametrize("ndev", [1, 4])
def test_dss_dist_overlap_loop_matches_serial_loop(ndev):
    """A multi-step loop over the overlapped dist step == the same loop
    over the serialized step, bitwise: both assemble the identical DSS
    window — only when the halo columns arrive differs."""
    import functools

    import jax

    cfg = with_overrides(BiharmonicConfig(), nelemd=32, nlev=4, qsize=2,
                         dtype="float32")
    data = problem.init_data(cfg)
    m = meshmod.make_mesh(ndev)
    si, step_s, gather = dist_bi.make_dist_step_dss(cfg, m)
    _, step_o, _ = dist_bi.make_dist_step_dss(cfg, m, overlap=True)
    q, aux = si(data)

    @functools.partial(jax.jit, static_argnums=(0,))
    def run(step, q):
        return jax.lax.fori_loop(0, 4, lambda i, x: step(x, aux), q)

    np.testing.assert_array_equal(gather(run(step_s, q)),
                                  gather(run(step_o, q)))
