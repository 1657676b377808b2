"""Benchmark/verification driver: the reference miniapps' run protocol as
one reusable harness.

Protocol per kernel (what each Fortran `program` hard-codes,
biharmonic:545-580, advect…F90:48-67, nested.F90:11-469):

  1. deterministic init,
  2. stage data to device (timed separately, like `timerData`
     nested.F90:163-182),
  3. run the trusted reference variant → save output,
  4. for every other registered variant: run (timed over nIters like
     nested.F90:191-199), verify against the saved reference output with the
     kernel's own norm, print a reference-style report line,
  5. emit machine-readable JSON metrics (the stdout *is* the metrics schema
     in the reference — results/ files are captured stdout; we keep the
     human lines and add JSON).

Timing semantics: variant timing EXCLUDES host↔device transfers (the
mpdata convention, `!$acc wait` before system_clock, advect…F90:109-110;
the atmosphere miniapp's GPU-time-includes-transfers convention is reported
separately as `stage_s`)."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any

import jax

from cdk.core import registry
from cdk.core.timer import Timer, slope_time_detail
from cdk.harness.specs import get_spec

REFERENCE_VARIANT = "reference_jnp"


@dataclass
class VariantResult:
    kernel: str
    variant: str
    ok: bool
    seconds_per_call: float
    grid_points_per_s: float
    metrics: dict[str, float] = field(default_factory=dict)
    note: str = ""
    fast_math: bool = False  # intentionally-lower-precision speed point


def run_kernel(
    kernel: str,
    cfg=None,
    variants: list[str] | None = None,
    iters: int = 10,
    trials: int = 3,
    quiet: bool = False,
    min_delta: float = 5e-3,
) -> list[VariantResult]:
    spec = get_spec(kernel)
    cfg = cfg or spec.default_config()
    say = (lambda *a: None) if quiet else print

    say(f"== {kernel} ({jax.default_backend()}, dtype={cfg.dtype}) ==")
    stage = Timer("data staging")
    stage.start()
    data = spec.init(cfg)
    data = jax.device_put(data)
    jax.block_until_ready(data)
    stage.stop()
    say(stage.report())

    reg = registry.variants(kernel)
    if REFERENCE_VARIANT not in reg:
        raise RuntimeError(f"no {REFERENCE_VARIANT} registered for {kernel}")
    names = variants or list(reg)
    gp = spec.grid_points(cfg)

    ref_step = reg[REFERENCE_VARIANT].fn(cfg)
    ref_out = ref_step(data)
    jax.block_until_ready(ref_out)

    results: list[VariantResult] = []
    for name in names:
        var = reg[name]
        if cfg.dtype == "float64" and not var.supports_f64:
            say(f" {name:<22s}: skipped (no f64 support)")
            continue
        try:
            step2, aux, vloop = registry._materialize(var, cfg, data)
            out = jax.block_until_ready(step2(aux, data))
        except registry.UnsupportedConfigError as e:
            # a variant whose stated applicability excludes this config
            # or device (e.g. the CUDA kernel off the GPU) is a SKIP with
            # its reason, not a failure — crashes (including
            # bare NotImplementedError from JAX internals) still fail
            say(f" {name:<22s}: skipped (unsupported here: {e})")
            continue
        except Exception as e:
            # a variant that crashes is a FAILED result, not a silent skip
            # (a regression must turn the bench red, not shrink it)
            msg = f"{type(e).__name__}: {str(e)[:300]}"
            say(f" {name:<22s}: ERROR {msg}  ** FAILED **")
            results.append(VariantResult(
                kernel, name, False, float("inf"), 0.0, {},
                note=f"run error: {msg}", fast_math=var.fast_math,
            ))
            continue
        check = spec.verify(cfg, out, ref_out, loose=var.fast_math)
        # per-step time via the two-point slope over device-side iteration
        # loops (the reference's nIters loop, with dispatch and sync cost
        # cancelled); variants with their own n-step loop are timed
        # through it
        if vloop is not None:
            make_runner = lambda n: (lambda d: vloop(d, n))
        else:
            make_runner = lambda n: spec.scan_runner(step2, aux, n)
        try:
            sec, band = slope_time_detail(make_runner, data, n1=iters,
                                          n2=8 * iters, trials=trials,
                                          min_delta=min_delta)
        except Exception as e:
            # timing failure must not drop the verification verdict: keep
            # the result (ok from the check) with no throughput claim
            msg = f"{type(e).__name__}: {str(e)[:200]}"
            say(f" {name:<22s}: verified "
                f"{'ok' if check.ok else '** FAILED **'}; timing ERROR {msg}")
            results.append(VariantResult(
                kernel, name, check.ok, float("inf"), 0.0, check.metrics,
                note=f"timing error: {msg}", fast_math=var.fast_math,
            ))
            continue
        metrics = dict(check.metrics)
        # timing dispersion (seconds/step) alongside the headline min —
        # lets the bench publish a band instead of a bare point
        metrics.update({f"slope_{k}": v for k, v in band.items()})
        res = VariantResult(
            kernel, name, check.ok, sec, gp / sec, metrics,
            fast_math=var.fast_math,
        )
        results.append(res)
        status = "" if check.ok else "  ** VERIFY FAILED **"
        say(
            f" {name:<22s}: {sec * 1e3:10.4f} ms/call "
            f"({res.grid_points_per_s / 1e6:10.2f} M pts/s){status}"
        )
        for line in check.lines:
            say(line)
    return results


def run_all(iters: int = 10, trials: int = 3, dtype: str | None = None,
            quiet: bool = False) -> dict[str, Any]:
    from cdk.harness.specs import all_specs

    out: dict[str, Any] = {"backend": jax.default_backend(), "kernels": {}}
    for kernel, spec in all_specs().items():
        cfg = spec.default_config()
        if dtype:
            from cdk.core.config import with_overrides

            cfg = with_overrides(cfg, dtype=dtype)
        results = run_kernel(kernel, cfg, iters=iters, trials=trials,
                             quiet=quiet)
        out["kernels"][kernel] = [asdict(r) for r in results]
    return out


def to_json(results: dict[str, Any]) -> str:
    return json.dumps(results, indent=2, default=float)
