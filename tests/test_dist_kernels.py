"""Element-sharded biharmonic and edge/cell-sharded CKE vs their
single-device references on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from cdk.core.config import BiharmonicConfig, CkeConfig, with_overrides
from cdk.core.norms import pointwise_check, rel_l2
from cdk.dist import biharmonic as dist_bi
from cdk.dist import cke as dist_cke
from cdk.dist import mesh as meshmod


def test_biharmonic_element_sharded():
    from cdk.kernels.biharmonic import problem, reference

    cfg = BiharmonicConfig()  # nelemd=16 over 8 devices
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    m = meshmod.make_mesh(8)
    sharded = dist_bi.shard_data(data, m)
    out = np.asarray(dist_bi.make_dist_step(cfg, m)(sharded))
    assert rel_l2(out, ref) < 1e-14


@pytest.mark.parametrize("ndev", [2, 8])
def test_cke_edge_cell_sharded(ndev):
    from cdk.kernels.cke import problem, reference

    cfg = with_overrides(CkeConfig(), nedges=256, ncells=100, nvertlevels=20)
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    m = meshmod.make_mesh(ndev)
    sharded = dist_cke.shard_data(data, m)
    out = np.asarray(dist_cke.make_dist_step(cfg, m)(sharded))
    n_bad, max_err, lines = pointwise_check(out, ref, cfg.errtol)
    assert n_bad == 0, f"max_err={max_err}"


def test_overlap_gain_and_cke_scaling_plumbing():
    from cdk.harness import scaling

    r = scaling.overlap_gain_mpdata(n_devices=2, nx_per_device=64,
                                    n_steps=2, quiet=True)
    assert r["plain_s"] > 0 and r["overlap_s"] > 0
    pts = scaling.weak_scaling_cke(
        device_counts=(1, 2), nedges_per_device=64, ncells=40, nvert=10,
        n_steps=2, quiet=True,
    )
    assert len(pts) == 2


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_cke_ring_overlap_matches_serialized(ndev):
    """Ring-pipelined (overlapped) CKE dist step == all_gather serialized
    step bitwise, and == reference at errTol."""
    from cdk.kernels.cke import problem, reference
    from cdk.core.config import CkeConfig

    cfg = with_overrides(CkeConfig(), nedges=256, ncells=96, nvertlevels=20)
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    m = meshmod.make_mesh(ndev)
    sharded = dist_cke.shard_data(data, m)
    out_s = np.asarray(dist_cke.make_dist_step(cfg, m)(sharded))
    out_r = np.asarray(dist_cke.make_dist_step_ring(cfg, m)(sharded))
    np.testing.assert_array_equal(out_r, out_s)
    n_bad, max_err, _ = pointwise_check(out_r, ref, cfg.errtol)
    assert n_bad == 0, f"max_err={max_err}"


@pytest.mark.parametrize("ring", [False, True])
def test_cke_dist_loop_matches_chained(ring):
    """One-jit scan over the dist step == chaining per-dispatch runs
    (tracer *= cellMask between iterations, the harness discipline)."""
    import dataclasses

    from cdk.core.config import CkeConfig
    from cdk.kernels.cke import problem

    cfg = with_overrides(CkeConfig(), nedges=256, ncells=96, nvertlevels=20)
    data = problem.init_data(cfg)
    m = meshmod.make_mesh(4)
    sharded = dist_cke.shard_data(data, m)
    run = (dist_cke.make_dist_step_ring if ring
           else dist_cke.make_dist_step)(cfg, m)
    loop = dist_cke.make_dist_loop(cfg, m, ring=ring)
    out_l = np.asarray(loop(sharded, 3))
    d = sharded
    out_c = None
    for _ in range(3):
        out_c = run(d)
        d = dataclasses.replace(d, tracer=d.tracer * d.cell_mask)
    np.testing.assert_array_equal(out_l, np.asarray(out_c))


def test_scaling_harness_biharmonic_and_gains():
    from cdk.harness import scaling

    pts = scaling.weak_scaling_biharmonic(
        device_counts=(1, 2), nelemd_per_device=2, nlev=4, qsize=2,
        n_steps=2, quiet=True,
    )
    assert len(pts) == 2 and all(p.seconds_per_step > 0 for p in pts)
    g1 = scaling.overlap_gain_biharmonic(
        n_devices=2, nelemd_per_device=2, n_steps=2, quiet=True)
    g2 = scaling.overlap_gain_cke(
        n_devices=2, nedges_per_device=64, ncells=40, nvert=10, n_steps=2,
        quiet=True)
    assert g1["plain_s"] > 0 and g2["plain_s"] > 0
