"""Two-application biharmonic with the 2-D torus DSS (edge + 4-way corner
assembly): assembly oracle, defining sharer-equality properties, variant
parity through the harness, and the 2-D-mesh ppermute decomposition vs the
single-device reference."""

import numpy as np
import pytest

from cdk.core.config import BiharmonicConfig, with_overrides
from cdk.core.norms import rel_l2
from cdk.dist import biharmonic as dist_bi
from cdk.dist import mesh as meshmod
from cdk.kernels.biharmonic import dss2d, problem

CFG = BiharmonicConfig()  # nelemd=16 -> 4x4 torus


def _oracle_sum(field, ex, ey, n):
    """Brute-force Σ_sharers via global dof identification on the torus:
    element (a,b)'s GLL point (i,j) is global dof ((a*(n-1)+i) mod
    ex*(n-1), (b*(n-1)+j) mod ey*(n-1))."""
    acc = {}
    for e in range(ex * ey):
        a, b = divmod(e, ey)
        for i in range(n):
            for j in range(n):
                k = ((a * (n - 1) + i) % (ex * (n - 1)),
                     (b * (n - 1) + j) % (ey * (n - 1)))
                acc[k] = acc.get(k, 0.0) + field[e, i, j]
    out = np.empty_like(field)
    for e in range(ex * ey):
        a, b = divmod(e, ey)
        for i in range(n):
            for j in range(n):
                k = ((a * (n - 1) + i) % (ex * (n - 1)),
                     (b * (n - 1) + j) % (ey * (n - 1)))
                out[e, i, j] = acc[k]
    return out


@pytest.mark.parametrize("exy", [(3, 4), (2, 2), (4, 4)])
def test_dss2d_sum_matches_bruteforce_oracle(exy):
    import jax.numpy as jnp

    ex, ey = exy
    n = 4
    rng = np.random.default_rng(0)
    field = rng.standard_normal((ex * ey, n, n))
    got = np.asarray(
        dss2d.dss2d_sum(jnp.asarray(field).reshape(ex, ey, n, n))
    ).reshape(ex * ey, n, n)
    np.testing.assert_allclose(got, _oracle_sum(field, ex, ey, n),
                               rtol=1e-13)


def test_dss2d_weights_multiplicity():
    """Constant spheremp exposes the sharer counts: interior 1, edges 2,
    corners 4."""
    import jax.numpy as jnp

    ex, ey = 3, 4
    w = np.asarray(dss2d.dss2d_weights(jnp.ones((ex * ey, 4, 4)), ex, ey))
    assert np.allclose(w[:, 1:-1, 1:-1], 1.0)      # interior
    assert np.allclose(w[:, 1:-1, 0], 0.5)         # j edges
    assert np.allclose(w[:, 0, 1:-1], 0.5)         # i edges
    corners = w[:, [0, 0, -1, -1], [0, -1, 0, -1]]
    assert np.allclose(corners, 0.25)              # 4-way corners


def test_dss2d_shared_dofs_agree():
    """The defining DSS property, 2-D: after assembly every edge sharer
    pair and every 4-way corner quadruple holds the identical value."""
    data = problem.init_data(CFG)
    ex, ey = dss2d.torus_shape(CFG.nelemd)
    w = dss2d.dss2d_weights(data.spheremp, ex, ey)[:, None, None]
    s = np.asarray(dss2d.dss_torus(data.qtens, w, ex, ey))
    s5 = s.reshape(ex, ey, *s.shape[1:])
    # j-direction edge columns
    np.testing.assert_array_equal(
        s5[..., -1], np.roll(s5, -1, axis=1)[..., 0]
    )
    # i-direction edge rows
    np.testing.assert_array_equal(
        s5[..., -1, :], np.roll(s5, -1, axis=0)[..., 0, :]
    )
    # 4-way corner: (a,b) at (n-1,n-1) == (a+1,b+1) at (0,0)
    np.testing.assert_array_equal(
        s5[..., -1, -1],
        np.roll(np.roll(s5, -1, axis=0), -1, axis=1)[..., 0, 0],
    )


def test_dss2d_interior_is_mass_projection():
    data = problem.init_data(CFG)
    ex, ey = dss2d.torus_shape(CFG.nelemd)
    w = dss2d.dss2d_weights(data.spheremp, ex, ey)[:, None, None]
    s = np.asarray(data.qtens)
    out = np.asarray(dss2d.dss_torus(data.qtens, w, ex, ey))
    sp = np.asarray(data.spheremp)[:, None, None]
    np.testing.assert_allclose(
        out[..., 1:-1, 1:-1], (s / sp)[..., 1:-1, 1:-1], rtol=1e-14
    )


def test_dss2d_lane_matches_full_field():
    """The lane-layout assembly (optimized variants' form) computes the
    identical bits through the layout transforms."""
    from cdk.kernels.biharmonic.problem import (
        from_lane_layout,
        to_lane_layout,
    )

    cfg = with_overrides(CFG, nelemd=12, nlev=3, qsize=2)
    data = problem.init_data(cfg)
    ex, ey = dss2d.torus_shape(cfg.nelemd)
    w = dss2d.dss2d_weights(data.spheremp, ex, ey)
    full = np.asarray(
        dss2d.dss_torus(data.qtens, w[:, None, None], ex, ey)
    )
    lane = from_lane_layout(
        dss2d.dss2d_lane(
            to_lane_layout(data.qtens), w.reshape(cfg.nelemd, cfg.npts, 1),
            ex, ey, cfg.np_gll,
        ),
        cfg,
    )
    np.testing.assert_array_equal(np.asarray(lane), full)


def test_dss2d_reduces_to_ring_when_ex_is_1():
    """A 1-row torus is exactly the ring family's topology in j (plus the
    self-paired i wrap): the j-direction assembly must agree with dss.py
    on interior i rows."""
    import jax.numpy as jnp

    from cdk.kernels.biharmonic import dss

    rng = np.random.default_rng(3)
    e, n = 6, 4
    s = jnp.asarray(rng.standard_normal((e, n, n)))
    sp = jnp.asarray(rng.uniform(0.5, 2.0, (e, n, n)))
    ring = np.asarray(
        dss.dss_ring(s, dss.dss_weights(sp))
    )
    torus = np.asarray(
        dss2d.dss_torus(s, dss2d.dss2d_weights(sp, 1, e), 1, e)
    )
    # i rows 1..n-2 have no i-direction sharing: identical to the ring
    np.testing.assert_allclose(torus[:, 1:-1, :], ring[:, 1:-1, :],
                               rtol=1e-14)


@pytest.mark.parametrize("exy", [(4, 4), (3, 8), (2, 6)])
def test_dss2d_lane_matches_torus_on_shapes(exy):
    """The lane-layout torus assembly (the fused forms' carry layout)
    equals dss_torus on the (e, ..., i, j) layout across torus shapes."""
    import jax.numpy as jnp

    ex, ey = exy
    e, npg, ncol = ex * ey, 4, 10
    npts = npg * npg
    rng = np.random.default_rng(11)
    s4 = rng.standard_normal((e, ncol, npg, npg))
    w = rng.uniform(0.5, 2.0, (e, npg, npg))
    ref = dss2d.dss_torus(jnp.asarray(s4), jnp.asarray(w)[:, None], ex, ey)
    s_lane = jnp.asarray(s4.reshape(e, ncol, npts).transpose(0, 2, 1))
    out = dss2d.dss2d_lane(s_lane, jnp.asarray(w).reshape(e, npts, 1),
                           ex, ey, npg)
    out4 = np.asarray(out).transpose(0, 2, 1).reshape(e, ncol, npg, npg)
    np.testing.assert_allclose(out4, np.asarray(ref), rtol=1e-15, atol=0)


def test_dss2d_loops_match_chained_steps():
    from cdk.core.registry import _materialize, get

    cfg = with_overrides(CFG, nelemd=8, nlev=4, qsize=2)
    data = problem.init_data(cfg)
    for name in ("fused_operator", "fused_operator_tf32"):
        step2, aux, loop = _materialize(
            get("biharmonic_dss2d", name), cfg, data)
        assert loop is not None
        import dataclasses

        q = data.qtens
        for _ in range(3):
            q = step2(aux, dataclasses.replace(data, qtens=q))
        assert rel_l2(np.asarray(loop(data, 3)), np.asarray(q)) < 1e-6, name


@pytest.mark.parametrize("nelemd", [12, 16, 160])
def test_dss2d_fused_loop_matches_chained_reference(nelemd):
    """The fused-operator loop (the production champion's timed path) ==
    chained reference steps at f64 on (4,3), (4,4) and (16,10) tori."""
    import dataclasses

    from cdk.core.registry import _materialize, get

    cfg = with_overrides(CFG, nelemd=nelemd, nlev=4, qsize=2,
                         dtype="float64")
    data = problem.init_data(cfg)
    ref_step, _, _ = _materialize(
        get("biharmonic_dss2d", "reference_jnp"), cfg, data)
    _, _, loop = _materialize(
        get("biharmonic_dss2d", "fused_operator"), cfg, data)
    n = 5
    q = data.qtens
    for _ in range(n):
        q = ref_step((), dataclasses.replace(data, qtens=q))
    assert rel_l2(np.asarray(loop(data, n)), np.asarray(q)) < 1e-13


@pytest.mark.parametrize("nelemd", [16, 160])
def test_dss2d_f32_steps_within_gates(nelemd):
    """One f32 step: the exact fused form within the family's 1e-6 gate,
    the TF32 form within the fast-math tier (1e-2)."""
    from cdk.core.registry import _materialize, get

    cfg = with_overrides(CFG, nelemd=nelemd, nlev=4, qsize=2,
                         dtype="float32")
    data = problem.init_data(cfg)
    ref = np.asarray(registry_step(cfg, "reference_jnp", data)(data))
    for name, gate in (("fused_operator", 1e-6),
                       ("fused_operator_tf32", 1e-2)):
        step2, aux, _ = _materialize(get("biharmonic_dss2d", name), cfg,
                                     data)
        e = rel_l2(np.asarray(step2(aux, data)), ref)
        assert e < gate, (name, e)


def registry_step(cfg, name, data):
    from cdk.core.registry import get, make_step

    return make_step(get("biharmonic_dss2d", name), cfg, data)


def test_dss2d_variants_through_harness():
    from cdk.harness import driver

    cfg = with_overrides(CFG, nelemd=4, nlev=4, qsize=2)
    res = driver.run_kernel("biharmonic_dss2d", cfg, iters=2, trials=1,
                            quiet=True)
    names = {r.variant for r in res}
    assert names >= {"reference_jnp", "fused_operator"}
    assert all(r.ok for r in res), [(r.variant, r.metrics) for r in res]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (2, 4), (4, 2)])
def test_dss2d_decomposed_matches_single(shape):
    from cdk.kernels.biharmonic.dss2d import make_reference

    data = problem.init_data(CFG)
    ref = np.asarray(make_reference(CFG)(data))
    m = meshmod.make_mesh2d(shape=shape)
    shard_inputs, step, gather = dist_bi.make_dist_step_dss2d(CFG, m)
    q_s, aux = shard_inputs(data)
    out = gather(step(q_s, aux))
    # probed-operator reassociation (f64), same bound as the ring family
    assert rel_l2(out, ref) < 1e-12


def test_dss2d_dist_loop_matches_chained():
    from dataclasses import replace

    from cdk.kernels.biharmonic.dss2d import make_reference

    data = problem.init_data(CFG)
    ref_step = make_reference(CFG)
    m = meshmod.make_mesh2d(shape=(2, 4))
    shard_inputs, step, gather = dist_bi.make_dist_step_dss2d(CFG, m)
    loop = dist_bi.make_dist_loop_dss2d(CFG, m)
    q_s, aux = shard_inputs(data)
    out_loop = gather(loop(q_s, aux, 3))
    d = data
    for _ in range(3):
        q_ref = ref_step(d)
        d = replace(d, qtens=q_ref)
    assert rel_l2(out_loop, np.asarray(q_ref)) < 1e-11


@pytest.mark.parametrize("ndev,n", [(2, 1), (2, 5), (2, 7), (4, 4)])
def test_dss2d_dist_row_mesh_matches_chained_reference(ndev, n):
    """The dist torus-DSS loop with the element grid's columns split over
    a (1, ndev) mesh == chained reference at f64."""
    dist_loop_vs_reference((1, ndev), n)


@pytest.mark.parametrize(
    "shape,n",
    [((2, 2), 5), ((2, 2), 4), ((4, 2), 9), ((2, 4), 4), ((2, 1), 4),
     ((4, 1), 2)],
)
def test_dss2d_dist_2d_mesh_matches_chained_reference(shape, n):
    """The dist torus-DSS loop on 2-D meshes (both edge passes exchanged
    between devices, corners through the two-pass sum) == chained
    reference at f64."""
    dist_loop_vs_reference(shape, n)


def dist_loop_vs_reference(shape, n):
    import dataclasses

    from cdk.core.registry import _materialize, get

    cfg = with_overrides(CFG, nelemd=32, nlev=4, qsize=2, dtype="float64")
    data = problem.init_data(cfg)
    ref_step, _, _ = _materialize(
        get("biharmonic_dss2d", "reference_jnp"), cfg, data)
    m = meshmod.make_mesh2d(shape=shape)
    shard_inputs, _, gather = dist_bi.make_dist_step_dss2d(cfg, m)
    loop = dist_bi.make_dist_loop_dss2d(cfg, m)
    q5, aux = shard_inputs(data)
    q = data.qtens
    for _ in range(n):
        q = ref_step((), dataclasses.replace(data, qtens=q))
    assert rel_l2(gather(loop(q5, aux, n)), np.asarray(q)) < 1e-12


def test_dss2d_dist_f32_step_matches_reference():
    """One f32 dist step on a 2-device row mesh within the family's 1e-6
    gate (multi-step f32 chains underflow to zero and compare nothing)."""
    cfg = with_overrides(CFG, nelemd=32, nlev=4, qsize=2, dtype="float32")
    data = problem.init_data(cfg)
    ref = np.asarray(registry_step(cfg, "reference_jnp", data)(data))
    m = meshmod.make_mesh2d(shape=(1, 2))
    shard_inputs, step, gather = dist_bi.make_dist_step_dss2d(cfg, m)
    q5, aux = shard_inputs(data)
    assert rel_l2(gather(step(q5, aux)), ref) < 1e-6


def test_dss2d_dist_loop_equals_chained_steps_exactly():
    """The scanned dist loop and chained dist steps are the same
    arithmetic — bitwise-identical outputs."""
    cfg = with_overrides(CFG, nelemd=32, nlev=4, qsize=2, dtype="float64")
    data = problem.init_data(cfg)
    m = meshmod.make_mesh2d(shape=(2, 2))
    si, step, gather = dist_bi.make_dist_step_dss2d(cfg, m)
    loop = dist_bi.make_dist_loop_dss2d(cfg, m)
    q5, aux = si(data)
    q = q5
    for _ in range(4):
        q = step(q, aux)
    np.testing.assert_array_equal(gather(loop(q5, aux, 4)), gather(q))


def test_dss2d_geometry_fuzz():
    """Fused loop vs reference across random torus shapes (odd ey,
    rectangular grids, prime-ish factors) — the edge-sum shifts must hold
    at every geometry, not just the shipped/production ones."""
    import dataclasses

    from cdk.core.registry import _materialize, get

    rng = np.random.default_rng(5)
    shapes = [(2, 3), (5, 4), (3, 6), (7, 2), (4, 10)]
    for ex, ey in [shapes[i] for i in rng.permutation(len(shapes))[:4]]:
        cfg = with_overrides(CFG, nelemd=ex * ey, nlev=3, qsize=2,
                             dtype="float64")
        if dss2d.torus_shape(cfg.nelemd) != (ex, ey):
            # torus_shape fixes the family topology per nelemd; only
            # shapes it actually produces are reachable
            ex, ey = dss2d.torus_shape(cfg.nelemd)
        data = problem.init_data(cfg)
        ref_step, _, _ = _materialize(
            get("biharmonic_dss2d", "reference_jnp"), cfg, data)
        q = data.qtens
        for _ in range(2):
            q = ref_step((), dataclasses.replace(data, qtens=q))
        for name in ("fused_operator",):
            _, _, loop = _materialize(get("biharmonic_dss2d", name), cfg,
                                      data)
            e = rel_l2(np.asarray(loop(data, 2)), np.asarray(q))
            assert e < 1e-13, (name, ex, ey, e)


def test_dss2d_dist_rejects_indivisible_grid():
    m = meshmod.make_mesh2d(shape=(3, 2))
    with pytest.raises(ValueError, match="not divisible"):
        dist_bi.make_dist_step_dss2d(CFG, m)  # 4x4 grid, 3 does not divide
