"""Per-kernel harness glue: how to init, which outputs to compare, and each
kernel's own verification idiom (the reference uses a different norm per
miniapp — SURVEY §4):

  biharmonic — relative L2 on qtens   (compute_l2norm, biharmonic:69-73)
  mpdata     — relative L1 on f, flux (compare, advect…F90:679-684)
  cke        — per-point relative err vs errTol (nested.F90:267-287)
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Callable

import numpy as np

from cdk.core import config as cfgmod
from cdk.core.norms import pointwise_check, rel_l1, rel_l2


@dataclass(frozen=True)
class CheckResult:
    ok: bool
    lines: list[str]  # stdout lines in the reference's report style
    metrics: dict[str, float]


@dataclass(frozen=True)
class KernelSpec:
    name: str
    default_config: Callable[[], Any]
    init: Callable[[Any], Any]          # cfg -> data pytree
    verify: Callable[[Any, Any, Any], CheckResult]  # (cfg, out, ref_out)
    grid_points: Callable[[Any], int]
    flops_per_point: int  # rough, for reporting
    # (step2, aux, n) -> fn(data) running n steps device-side under one
    # dispatch (the analog of the reference's `do n=1,nIters` loops,
    # nested.F90:191-199: per-dispatch latency would otherwise swamp
    # microsecond kernels). step2(aux, data) is the canonical variant call
    # form; aux is threaded as a jit argument, never closure-captured (see
    # registry._materialize).
    scan_runner: Callable[..., Callable] = None


def _tol(cfg, loose, f64_tol, f32_tol):
    if cfg.dtype == "bfloat16":
        return 1.0e-1 if loose else 3.0e-2
    if loose:
        return 1.0e-2
    return f64_tol if cfg.dtype == "float64" else f32_tol


def _verify_biharmonic(cfg, out, ref, loose=False) -> CheckResult:
    """All three biharmonic families (single application, ring DSS, torus
    DSS) share this check."""
    l2 = rel_l2(np.asarray(out), np.asarray(ref))
    # f32 gate: the exact (precision='highest') fused forms measured
    # 9.4e-8 (single application) and 1.5e-7 (both DSS families) relative
    # L2 against the reference at production size on an H200 (PERF.md),
    # so 1e-6 leaves ~7x margin while a TF32 slip (measured 1.1e-4 and
    # 2.4e-4) fails loudly; fast-math variants take the loose tier.
    gate = _tol(cfg, loose, 1e-13, 1e-6)
    return CheckResult(
        ok=bool(np.isfinite(l2) and l2 < gate),
        lines=[f" L2 norm: {l2: .6E}  (tol {gate:g})"],
        metrics={"rel_l2": l2, "tol": gate},
    )


def _verify_mpdata(cfg, out, ref, loose=False) -> CheckResult:
    f_o, flux_o = out
    f_r, flux_r = ref
    e_f = rel_l1(np.asarray(f_o), np.asarray(f_r))
    e_flux = rel_l1(np.asarray(flux_o), np.asarray(flux_r))
    # f32 gates: the CUDA kernel measured 2.9e-8 (f) and 2.4e-8 (flux)
    # relative L1 after one production step on an H200 (PERF.md) — the
    # same arithmetic in another FMA-contraction order: f ≤ 1e-6,
    # flux ≤ 1e-5
    tol = _tol(cfg, loose, 1e-13, 1e-6)
    return CheckResult(
        ok=bool(np.isfinite(e_f) and np.isfinite(e_flux)
                and e_f < tol and e_flux < 10 * tol),
        lines=[
            f" Relative L1 Error - f    : {e_f: .6E}",
            f" Relative L1 Error - flux : {e_flux: .6E}",
        ],
        metrics={"rel_l1_f": e_f, "rel_l1_flux": e_flux, "tol": tol,
                 "tol_flux": 10 * tol},
    )


def _verify_cke(cfg, out, ref, loose=False) -> CheckResult:
    if cfg.dtype == "float64" and not loose:
        # the reference's own per-point check at errTol (nested.F90:267-287)
        n_bad, max_err, lines = pointwise_check(
            np.asarray(out), np.asarray(ref), cfg.errtol
        )
        return CheckResult(
            ok=n_bad == 0,
            lines=lines
            or [f" max relative error: {max_err: .6E} (tol {cfg.errtol:g})"],
            metrics={"n_violations": float(n_bad), "max_rel_err": max_err,
                     "tol": cfg.errtol},
        )
    # f32: per-point relative error is dominated by cancellation at
    # near-zero flux points; use the aggregate norm.  The exact gather
    # form matched the reference bit for bit at production size on an
    # H200 (PERF.md); 1e-6 allows for another summation order
    tol = _tol(cfg, loose, cfg.errtol, 1e-6)
    e = rel_l1(np.asarray(out), np.asarray(ref))
    return CheckResult(
        ok=bool(np.isfinite(e) and e < tol),
        lines=[f" Relative L1 Error - flx  : {e: .6E}  (tol {tol:g})"],
        metrics={"rel_l1": e, "tol": tol},
    )


def _scan_biharmonic(step2, aux, n):
    """Chain n Laplacian applications (qtens feeds back)."""
    import jax
    from jax import lax

    @jax.jit
    def run(aux, data):
        def body(q, _):
            return step2(aux, _dc_replace(data, qtens=q)), None
        out, _ = lax.scan(body, data.qtens, None, length=n)
        return out

    return lambda data: run(aux, data)


def _scan_mpdata(step2, aux, n):
    """n advection steps: f and flux feed back (a real multi-step
    integration, unlike the reference's single call)."""
    import jax
    from jax import lax

    @jax.jit
    def run(aux, data):
        def body(carry, _):
            f, flux = carry
            return step2(aux, _dc_replace(data, f=f, flux=flux)), None
        out, _ = lax.scan(body, (data.f, data.flux), None, length=n)
        return out

    return lambda data: run(aux, data)


def _scan_cke(step2, aux, n):
    """n flux iterations; tracerCur *= cellMask each pass like the
    reference's forms 2/3 (nested.F90:297-310) — idempotent in value but a
    real data dependence, so XLA cannot hoist the body out of the loop."""
    import jax
    from jax import lax

    @jax.jit
    def run(aux, data):
        def body(carry, _):
            tracer, _ = carry
            flx = step2(aux, _dc_replace(data, tracer=tracer))
            # carry the result instead of stacking n copies of it
            return (tracer * data.cell_mask, flx), None
        import jax.numpy as jnp

        init_flx = jnp.zeros(data.ntf.shape, data.ntf.dtype)
        (_, flx), _ = lax.scan(body, (data.tracer, init_flx), None,
                               length=n)
        return flx

    return lambda data: run(aux, data)


def _specs() -> dict[str, KernelSpec]:
    from cdk.kernels.biharmonic import problem as bi_problem
    from cdk.kernels.cke import problem as cke_problem
    from cdk.kernels.mpdata import problem as mp_problem

    return {
        "biharmonic": KernelSpec(
            "biharmonic", cfgmod.BiharmonicConfig, bi_problem.init_data,
            _verify_biharmonic, lambda c: c.grid_points, 135,
            _scan_biharmonic,
        ),
        # two-application biharmonic with the ring-DSS exchange (the HOMME
        # structure the miniapp drops — SURVEY §5 deferred DSS); same
        # problem data/config as the extracted single-application kernel
        "biharmonic_dss": KernelSpec(
            "biharmonic_dss", cfgmod.BiharmonicConfig, bi_problem.init_data,
            _verify_biharmonic, lambda c: c.grid_points, 280,
            _scan_biharmonic,
        ),
        # two-application biharmonic with the 2-D torus DSS (edge + 4-way
        # corner assembly — the full HOMME DSS structure; kernels/
        # biharmonic/dss2d.py defines the topology)
        "biharmonic_dss2d": KernelSpec(
            "biharmonic_dss2d", cfgmod.BiharmonicConfig,
            bi_problem.init_data, _verify_biharmonic,
            lambda c: c.grid_points, 280, _scan_biharmonic,
        ),
        "mpdata": KernelSpec(
            "mpdata", cfgmod.MpdataConfig, mp_problem.init_data,
            _verify_mpdata, lambda c: c.grid_points, 60, _scan_mpdata,
        ),
        "cke": KernelSpec(
            "cke", cfgmod.CkeConfig, cke_problem.init_data,
            _verify_cke, lambda c: c.grid_points, 2 * 10 + 4, _scan_cke,
        ),
    }


def get_spec(name: str) -> KernelSpec:
    return _specs()[name]


def all_specs() -> dict[str, KernelSpec]:
    return _specs()
