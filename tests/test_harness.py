"""Harness driver protocol: init -> reference -> variants -> verify -> time
on tiny configs (CPU; exercises the step/prepare/loop variant protocols and
the adaptive slope timer end-to-end)."""

import json

from cdk.core.config import (
    BiharmonicConfig,
    CkeConfig,
    MpdataConfig,
    with_overrides,
)
from cdk.harness import driver


def test_run_kernel_biharmonic_small():
    cfg = with_overrides(BiharmonicConfig(), nelemd=2, nlev=4, qsize=2)
    res = driver.run_kernel("biharmonic", cfg, iters=2, trials=1, quiet=True)
    names = {r.variant for r in res}
    assert "reference_jnp" in names and "fused_operator" in names
    assert all(r.ok for r in res), [(r.variant, r.metrics) for r in res]
    assert all(r.seconds_per_call > 0 for r in res)


def test_run_kernel_mpdata_small():
    cfg = with_overrides(MpdataConfig(), nslices=2, nx=6, nz=8)
    res = driver.run_kernel("mpdata", cfg, iters=2, trials=1, quiet=True)
    # off the GPU the CUDA kernel is a typed skip, not a failure and not
    # an interpreted run
    assert {r.variant for r in res} == {"reference_jnp"}
    assert all(r.ok for r in res)


def test_run_kernel_cke_small_with_prepare():
    cfg = with_overrides(CkeConfig(), nedges=16, ncells=10, nvertlevels=6,
                         nadv=3)
    res = driver.run_kernel("cke", cfg, iters=2, trials=1, quiet=True)
    assert {r.variant for r in res} >= {"reference_jnp", "onehot_matmul",
                                       "gather_peradv"}
    assert all(r.ok for r in res), [(r.variant, r.metrics) for r in res]


def test_json_roundtrip():
    cfg = with_overrides(BiharmonicConfig(), nelemd=2, nlev=4, qsize=2)
    res = driver.run_kernel("biharmonic", cfg, iters=2, trials=1, quiet=True)
    from dataclasses import asdict

    s = driver.to_json({"kernels": {"biharmonic": [asdict(r) for r in res]}})
    parsed = json.loads(s)
    assert parsed["kernels"]["biharmonic"][0]["grid_points_per_s"] > 0


def test_cli_list(capsys):
    from cdk.cli import main

    assert main(["list"]) == 0
    out = capsys.readouterr().out
    assert "biharmonic" in out and "hopper_fused" in out


def test_profile_cost_analysis():
    import jax.numpy as jnp

    from cdk.harness import profile

    ca = profile.cost_analysis(lambda x: (x @ x).sum(),
                               jnp.ones((64, 64), jnp.float32))
    assert isinstance(ca, dict)
    stats = profile.device_memory_stats()
    assert isinstance(stats, dict)


def test_cli_run_cke_with_overrides(capsys):
    from cdk.cli import main

    rc = main([
        "run", "cke", "--set", "nedges=16", "--set", "ncells=10",
        "--set", "nvertlevels=6", "--set", "nadv=3", "--iters", "2",
        "--trials", "1", "--variant", "reference_jnp",
        "--variant", "gather_peradv",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "gather_peradv" in out


def test_bf16_all_kernels_smoke():
    """bfloat16 dtype end-to-end on every kernel (reference vs one variant
    at the bf16 verification tier)."""
    from cdk.core.config import with_overrides

    for kernel, cfg, variants in [
        ("biharmonic",
         with_overrides(BiharmonicConfig(), nelemd=2, nlev=4, qsize=2,
                        dtype="bfloat16"),
         ["reference_jnp", "fused_operator_tf32"]),
        ("cke",
         with_overrides(CkeConfig(), nedges=16, ncells=10, nvertlevels=6,
                        nadv=3, dtype="bfloat16"),
         ["reference_jnp", "gather_peradv"]),
    ]:
        res = driver.run_kernel(kernel, cfg, variants=variants, iters=2,
                                trials=1, quiet=True)
        assert res and all(r.ok for r in res), (
            kernel, [(r.variant, r.metrics) for r in res])


def test_broken_variant_turns_red():
    """A deliberately-broken variant must surface as an explicit FAILED
    result (and make the CLI exit non-zero) — never a silent skip."""
    from cdk.core import registry

    @registry.register("biharmonic", "_broken_wrong", "test-only")
    def make_broken_wrong(cfg):
        return lambda data: data.qtens * 2.0  # wrong answer

    @registry.register("biharmonic", "_broken_crash", "test-only")
    def make_broken_crash(cfg):
        def step(data):
            raise RuntimeError("deliberate crash")

        return step

    try:
        cfg = with_overrides(BiharmonicConfig(), nelemd=2, nlev=4, qsize=2)
        res = driver.run_kernel("biharmonic", cfg, iters=2, trials=1,
                                quiet=True)
        by_name = {r.variant: r for r in res}
        assert not by_name["_broken_wrong"].ok
        assert not by_name["_broken_crash"].ok
        assert "deliberate crash" in by_name["_broken_crash"].note

        from cdk.cli import main

        rc = main([
            "run", "biharmonic", "--set", "nelemd=2", "--set", "nlev=4",
            "--set", "qsize=2", "--iters", "2", "--trials", "1",
            "--variant", "reference_jnp", "--variant", "_broken_wrong",
        ])
        assert rc == 1
    finally:
        registry._REGISTRY["biharmonic"].pop("_broken_wrong", None)
        registry._REGISTRY["biharmonic"].pop("_broken_crash", None)


def test_cli_integrate(tmp_path, capsys):
    from cdk.cli import main

    out = tmp_path / "state.npz"
    rc = main([
        "integrate", "mpdata", "--steps", "3", "--variant", "reference_jnp",
        "--set", "nslices=2", "--set", "nx=6", "--set", "nz=8",
        "--out", str(out),
    ])
    assert rc == 0 and out.exists()
    import numpy as np

    z = np.load(out)
    assert z["out0"].shape == (2, 12, 7)


def test_dss_precision_gate_per_variant():
    """A deliberate 1e-5 relative drift injected into an exact-f32 DSS
    variant must turn the driver red: the family f32 gate is 1e-6 (sized
    to the 'highest'-precision forms' measured ~1.5e-7), while a variant
    registered as fast-math (the TF32 policy) takes the loose tier and
    tolerates it."""
    import cdk.kernels  # noqa: F401 — populate the registry

    from cdk.core import registry

    base = registry.get("biharmonic_dss2d", "fused_operator")

    def make_drifted(cfg, _fn=base.fn):
        made = _fn(cfg)

        def step2(aux, data, _step=made["step"]):
            return _step(aux, data) * (1.0 + 1.0e-5)

        return {"prepare": made["prepare"], "step": step2}

    registry._REGISTRY["biharmonic_dss2d"]["_drift_exact"] = (
        registry.Variant("biharmonic_dss2d", "_drift_exact", make_drifted,
                         "test-only", supports_f64=False))
    registry._REGISTRY["biharmonic_dss2d"]["_drift_fast"] = (
        registry.Variant("biharmonic_dss2d", "_drift_fast", make_drifted,
                         "test-only", supports_f64=False, fast_math=True))
    try:
        cfg = with_overrides(BiharmonicConfig(), nelemd=4, nlev=4, qsize=2,
                             dtype="float32")
        res = driver.run_kernel(
            "biharmonic_dss2d", cfg, iters=2, trials=1, quiet=True,
            variants=["reference_jnp", "_drift_exact", "_drift_fast"])
        by_name = {r.variant: r for r in res}
        # exact-f32 family gate (1e-6): the 1e-5 drift is a FAILURE
        assert not by_name["_drift_exact"].ok, by_name["_drift_exact"]
        # fast-math tier (1e-2): same drift is within policy
        assert by_name["_drift_fast"].ok, by_name["_drift_fast"]
    finally:
        registry._REGISTRY["biharmonic_dss2d"].pop("_drift_exact", None)
        registry._REGISTRY["biharmonic_dss2d"].pop("_drift_fast", None)


def test_dist_bench_legs_run_and_verify():
    """The gated dist bench legs (harness/distbench.py) run + verify at
    reduced shapes on the 1-device CPU mesh: every family produces a
    finite slope and passes its verification gate; a deliberately broken
    champion mapping turns a leg red (the regression-gate contract: a
    deliberately broken dist kernel turns the bench red)."""
    import math

    from cdk.core.config import CkeConfig, MpdataConfig
    from cdk.harness.distbench import run_dist_legs

    champs = {
        "mpdata": "reference_jnp",
        "biharmonic_dss": "fused_operator",
        "biharmonic_dss2d": "fused_operator",
        "cke": "gather_peradv",
    }
    configs = {
        "mpdata": with_overrides(MpdataConfig(), nslices=16, nx=16, nz=12,
                                 dtype="float32"),
        "mpdata_slices": with_overrides(MpdataConfig(), nslices=16, nx=16,
                                        nz=12, dtype="float32"),
        "biharmonic_dss": with_overrides(BiharmonicConfig(), nelemd=16,
                                         nlev=4, qsize=2, dtype="float32"),
        "biharmonic_dss2d": with_overrides(BiharmonicConfig(), nelemd=16,
                                           nlev=4, qsize=2,
                                           dtype="float32"),
        "cke": with_overrides(CkeConfig(), nedges=256, ncells=96,
                              nvertlevels=20, dtype="float32"),
    }
    res = run_dist_legs(champs, trials=1, quiet=True, configs=configs)
    assert {r.family for r in res} == set(configs)
    for r in res:
        assert r.ok, (r.family, r.err, r.note)
        assert math.isfinite(r.seconds_per_call) and r.seconds_per_call > 0
        assert r.grid_points_per_s > 0

    # broken champion -> the leg fails instead of silently passing
    from cdk.core import registry

    @registry.register("mpdata", "_broken", "test-only")
    def make_broken(cfg):
        def loop(data, n):
            return data.f * 2.0, data.flux

        return {"step": lambda data: loop(data, 1), "loop": loop}

    try:
        bad = dict(champs, mpdata="_broken")
        res_bad = run_dist_legs(bad, trials=1, quiet=True,
                                configs={"mpdata": configs["mpdata"]})
    finally:
        registry._REGISTRY["mpdata"].pop("_broken", None)
    mp = next(r for r in res_bad if r.family == "mpdata")
    assert not mp.ok
