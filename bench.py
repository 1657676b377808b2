"""Headline benchmark: all co-design kernel families on one NVIDIA GPU.

Refuses to run (exit 2, no timing) unless JAX's first device is a GPU.
Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

PRIMARY headline = geometric-mean speedup of the best VERIFIED-PARITY
variant (fast-math speed points excluded) over the reference's best
published per-kernel numbers, using figures that match our steady-state
(transfer-free) timing semantics:

  biharmonic_wk : GPU2 device-kernel compute 1.033 ms/call → 716 M pts/s
                  (K20X nvprof split, atm.pgiacc.17.7-nvprof:11-15; the
                  3.074 ms headline includes H2D/D2H which a resident-data
                  run never pays per step)
  MPDATA        : OpenACC-2 warm 294 µs/step, transfers excluded →
                  298 M pts/s (advect.pgiacc.17.7:12)
  nested (CKE)  : no committed reference results (BASELINE.md) — baselined
                  against our own committed native C++ scalar driver,
                  12.141 ms/iter → 210.9 M pts/s
                  (results/cpu-native/cdk_bench.txt, cpp/cdk_bench.cpp)

SECONDARY (stderr only): the same geomean over the best variant including
fast-math forms — a speed point, not a parity claim — plus one line per
beyond-reference family (the DSS-coupled biharmonics), which have no
baseline row and stay out of the geomean but still gate the exit status.

The JSON line also carries:
  "device"     — JAX's platform, device kind and count, and the card's
                 name and power limit from nvidia-smi
  "band"       — geomean lo/hi: hi = the headline (best-window slopes),
                 lo = the same geomean at each leg's MEDIAN trial slope
  "legs"       — per-leg us/step min/median/max
  "production" — the five families' production-scale champions
                 (BASELINE.json config "all three kernels at production
                 E3SM scale"), slope-timed and VERIFIED; a failure here
                 sets RC!=0 like the shipped legs
  "dist"       — the distributed production paths on a 1-device mesh
                 (harness/distbench.py), slope-timed and verified against
                 the same-run production champions; failures set RC!=0
  per-leg "gpts_per_s" — grid-points/s, the BASELINE.json north-star
                 metric (pts/step ÷ s/step)

Exit status: 2 when no GPU is found; 1 if any exact (non-fast-math)
variant fails verification or crashes — a regression turns the bench red
instead of silently shrinking it; else 0.

Per-kernel detail goes to stderr; timing is the two-point slope over
device-side scan loops, each ended by block_until_ready (see
cdk/core/timer.py)."""

from __future__ import annotations

import json
import sys


BASELINES_PTS_S = {
    "biharmonic": 737_280 / 1.033e-3,   # ≈ 716 M pts/s (K20X compute)
    "mpdata": 87_552 / 294e-6,          # ≈ 298 M pts/s (K20X, excl. copies)
    "cke": 2_560_000 / 12.141e-3,       # ≈ 211 M pts/s (native C++ serial)
}
BASELINE_KIND = {"biharmonic": "K20X", "mpdata": "K20X", "cke": "C++"}

# Production-scale champions: the fastest exact variant of each family at
# its production config, measured on an H200 (CHANGES.md, PERF.md).
# PROMOTION RULE: a variant is promoted here only after a production run
# on the card (the driver at production_config, every variant) shows it
# beating the incumbent by more than the leg's recorded dispersion band,
# in the same process on the same card, with both numbers and the card's
# name and power limit recorded in PERF.md — the pin is deliberate so a
# noise-level flip cannot silently change what the regression gate times.
PRODUCTION_CHAMPIONS = {
    "biharmonic": "fused_operator",
    "biharmonic_dss": "fused_operator",
    "biharmonic_dss2d": "fused_operator",
    "mpdata": "hopper_fused",
    "cke": "reference_jnp",
}


def _geomean(xs):
    g = 1.0
    for x in xs:
        g *= x
    return g ** (1.0 / len(xs)) if xs else 0.0


def _best(pool, pin=None):
    """Deterministic champion pick: 2% throughput buckets, then the
    PINNED production champion name, then name — variants measured
    identical within timing noise keep a stable row across runs instead
    of flip-flopping on the noise, and a dead heat resolves to the SAME
    name in the shipped and production sections."""
    import math

    def key(r):
        gps = r.grid_points_per_s
        bucket = (int(math.log(gps) / math.log(1.02))
                  if gps > 0 else -(10 ** 9))
        return (bucket, r.variant == pin, r.variant)

    return max(pool, key=key)


def _leg_band_us(best):
    """{min,median,max} us/step from the driver's slope dispersion
    metrics (empty when the timer had no resolvable samples)."""
    m = best.metrics
    if "slope_min" not in m:
        return {}
    return {
        "min_us": round(m["slope_min"] * 1e6, 3),
        "median_us": round(m["slope_median"] * 1e6, 3),
        "max_us": round(m["slope_max"] * 1e6, 3),
    }


def main() -> int:
    from cdk.core.platform import (
        NoGpuError,
        device_record,
        enable_compilation_cache,
        require_gpu,
    )

    err = lambda *a: print(*a, file=sys.stderr, flush=True)
    try:
        require_gpu()
    except NoGpuError as e:
        err(f"[bench] {e}; refusing to time anything")
        return 2
    device = device_record()
    err(f"[bench] device: {device}")
    enable_compilation_cache()
    import cdk.kernels  # noqa: F401
    from cdk.core.config import with_overrides
    from cdk.harness import driver
    from cdk.harness.specs import all_specs

    exact_ratios, fm_ratios = [], []
    exact_lo, exact_hi = [], []  # per-leg ratio band endpoints
    exact_failures = []
    extra_lines = []
    legs = {}
    for kernel, spec in all_specs().items():
        cfg = with_overrides(spec.default_config(), dtype="float32",
                             device_init=True)
        try:
            results = driver.run_kernel(kernel, cfg, iters=50, trials=3,
                                        quiet=True)
        except Exception as e:  # one kernel failing must not zero the bench
            err(f"[bench] {kernel}: ERROR {type(e).__name__}: {e}")
            exact_failures.append(f"{kernel}:<all>")
            continue
        exact_failures += [
            f"{kernel}:{r.variant}" for r in results
            if not r.ok and not r.fast_math
        ]
        ok = [r for r in results if r.ok]
        if kernel not in BASELINES_PTS_S:
            # kernels beyond the reference's extracted set (the DSS-coupled
            # biharmonic families) have no baseline row and stay out of the
            # geomean — but their best verified figure is still reported so
            # a regression is visible in the bench log
            exact = [r for r in ok if not r.fast_math]
            if exact:
                best = _best(exact, PRODUCTION_CHAMPIONS.get(kernel))
                legs[kernel] = {
                    "variant": best.variant,
                    "us_per_step": round(best.seconds_per_call * 1e6, 3),
                    "gpts_per_s": round(best.grid_points_per_s, 0),
                    **_leg_band_us(best),
                }
                extra_lines.append(
                    f"[bench] {kernel:<16s} exact best="
                    f"{best.variant:<22s} "
                    f"{best.seconds_per_call * 1e6:9.2f} us/step "
                    f"{best.grid_points_per_s / 1e6:10.1f} M pts/s "
                    f"(no reference baseline; not in geomean)"
                )
            continue
        base = BASELINES_PTS_S[kernel]
        kind = BASELINE_KIND[kernel]
        for tag, pool, ratios in (
            ("exact", [r for r in ok if not r.fast_math], exact_ratios),
            ("fast ", ok, fm_ratios),
        ):
            if not pool:
                err(f"[bench] {kernel}: NO PASSING {tag.strip()} VARIANT")
                continue
            best = _best(pool, PRODUCTION_CHAMPIONS.get(kernel))
            ratio = best.grid_points_per_s / base
            ratios.append(ratio)
            if tag == "exact":
                legs[kernel] = {
                    "variant": best.variant,
                    "us_per_step": round(best.seconds_per_call * 1e6, 3),
                    "gpts_per_s": round(best.grid_points_per_s, 0),
                    **_leg_band_us(best),
                }
                # ratio band endpoints from the slope dispersion: hi =
                # the headline's best-window slope, lo = the MEDIAN
                # trial slope (typical window)
                m = best.metrics
                if "slope_median" in m and m["slope_median"] > 0:
                    exact_lo.append(
                        ratio * best.seconds_per_call / m["slope_median"])
                else:
                    exact_lo.append(ratio)
                exact_hi.append(ratio)
            err(
                f"[bench] {kernel:<11s} {tag} best={best.variant:<20s} "
                f"{best.seconds_per_call * 1e6:9.2f} us/step "
                f"{best.grid_points_per_s / 1e6:10.1f} M pts/s "
                f"{ratio:8.1f}x vs {kind}"
            )

    for line in extra_lines:
        err(line)

    # ---- production-scale sweep: champions only, verified + gated ----
    from cdk.core.config import production_config

    production = {}
    for kernel, champ in PRODUCTION_CHAMPIONS.items():
        try:
            results = driver.run_kernel(
                kernel, production_config(kernel), variants=[champ],
                iters=50, trials=3, quiet=True)
        except Exception as e:
            err(f"[bench] production {kernel}: ERROR "
                f"{type(e).__name__}: {e}")
            exact_failures.append(f"production:{kernel}:<all>")
            continue
        r = next((r for r in results if r.variant == champ), None)
        if r is None or not r.ok:
            err(f"[bench] production {kernel}: {champ} "
                f"{'missing' if r is None else 'VERIFY FAILED'}")
            exact_failures.append(f"production:{kernel}:{champ}")
            continue
        production[kernel] = {
            "variant": champ,
            "us_per_step": round(r.seconds_per_call * 1e6, 2),
            "gpts_per_s": round(r.grid_points_per_s, 0),
            **_leg_band_us(r),
        }
        err(f"[bench] production {kernel:<16s} {champ:<28s} "
            f"{r.seconds_per_call * 1e6:9.2f} us/step "
            f"{r.grid_points_per_s / 1e9:7.2f} G pts/s")

    # ---- distributed production paths: 1-dev mesh, verified + gated ----
    from cdk.harness.distbench import run_dist_legs

    dist_rows = {}
    try:
        dlegs = run_dist_legs(PRODUCTION_CHAMPIONS, production=True,
                              trials=3, quiet=True)
    except Exception as e:
        err(f"[bench] dist: ERROR {type(e).__name__}: {e}")
        exact_failures.append("dist:<all>")
        dlegs = []
    for d in dlegs:
        if not d.ok:
            why = d.note or f"VERIFY FAILED err={d.err:.3e}"
            err(f"[bench] dist {d.family}: {d.path} {why}")
            exact_failures.append(f"dist:{d.family}:{d.path}")
            continue
        dist_rows[d.family] = {
            "path": d.path,
            "us_per_step": round(d.seconds_per_call * 1e6, 2),
            "gpts_per_s": round(d.grid_points_per_s, 0),
            "min_us": round(d.slope_min * 1e6, 3),
            "median_us": round(d.slope_median * 1e6, 3),
            "max_us": round(d.slope_max * 1e6, 3),
            "err": d.err,
        }
        err(f"[bench] dist       {d.family:<16s} {d.path:<28s} "
            f"{d.seconds_per_call * 1e6:9.2f} us/step "
            f"{d.grid_points_per_s / 1e9:7.2f} G pts/s")

    if exact_failures:
        err(f"[bench] FAILED exact variants: {', '.join(exact_failures)}")

    gm = _geomean(exact_ratios)
    gm_lo, gm_hi = _geomean(exact_lo), _geomean(exact_hi)
    err(f"[bench] verified-parity geomean {gm:.1f}x "
        f"[band {gm_lo:.1f}-{gm_hi:.1f}x] "
        f"(fast-math speed point: {_geomean(fm_ratios):.1f}x)")
    print(json.dumps({
        "metric": "verified_kernel_geomean_speedup",
        "value": round(gm, 3),
        "unit": "x",
        "vs_baseline": round(gm, 3),
        "device": device,
        "band": {"lo": round(gm_lo, 3), "hi": round(gm_hi, 3)},
        "legs": legs,
        "production": production,
        "dist": dist_rows,
    }))
    if not exact_ratios or exact_failures:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
