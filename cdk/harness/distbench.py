"""Gated distributed production legs for bench.py.

Each distributed production path is a first-class bench leg: built on a
device mesh (one device in bench.py; the four-card comparison is
chip_smoke.py --four), slope-timed with the same two-point device-side
loop semantics as the single-device legs, VERIFIED against the
same-config single-device production champion (itself driver-verified
against the family reference in the same bench run), and failures
propagate to the bench exit status.

Each leg also reports grid-points/s — the BASELINE.json north-star
metric (derived pts/s rows idiom: reference atmosphere/results/
summary.txt)."""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import numpy as np


@dataclass
class DistLegResult:
    family: str
    path: str          # which dist formulation ran
    seconds_per_call: float
    slope_min: float
    slope_median: float
    slope_max: float
    grid_points_per_s: float
    err: float
    tol: float
    ok: bool
    note: str = ""


def _slope_loop(run_n, n1: int, n2: int, trials: int = 3):
    """Two-point slope timing of run_n(n) (one-dispatch n-step device
    loop, synchronised inside run_n) -> (min, median, max) s/step.

    The recorded leg value is the MEDIAN: a stall during the n1 run
    biases one slope LOW (a negative slope is possible on a loaded host),
    so a min-of-trials value records artifacts.  If even the median is
    non-positive (degenerate timing under extreme load), fall back to
    the bulk rate of the longer run — an upper bound, but positive."""
    run_n(n1)  # compile + warm both step counts
    run_n(n2)
    slopes = []
    for _ in range(trials):
        t0 = time.perf_counter()
        run_n(n1)
        t1 = time.perf_counter()
        run_n(n2)
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (n2 - n1))
    s = sorted(slopes)
    med = s[len(s) // 2]
    if med <= 0:
        t0 = time.perf_counter()
        run_n(n2)
        bulk = (time.perf_counter() - t0) / n2
        return bulk, bulk, bulk
    return s[0], med, s[-1]


def _champion_loop(kernel: str, champ: str, cfg, data):
    """Materialized single-chip champion loop(data, n) in the family's
    canonical output layout (the dist gather target)."""
    from cdk.core.registry import _materialize, get
    from cdk.harness.specs import get_spec

    step2, aux, vloop = _materialize(get(kernel, champ), cfg, data)
    if vloop is not None:
        return vloop
    spec = get_spec(kernel)
    return lambda d, n: spec.scan_runner(step2, aux, n)(d)


# Tolerances of the dist legs, each against the single-device champion
# after the same number of steps, in f32:
#  - mpdata halo loop: the masked-global core and the positional champion
#    are the same staged arithmetic in a different association order;
#  - mpdata slice loop: each device runs the champion's own loop on its
#    slices, so only the padding can differ (it must not);
#  - dss / dss2d: the same fused-operator arithmetic at precision
#    'highest', with the DSS edge sums taken from ppermuted columns;
#  - cke: the all_gathered field feeds the same per-slot gather.
# The values measured on the card are in PERF.md.
TOL_MPDATA = 1e-5
TOL_DSS = 1e-5
TOL_CKE = 1e-6


def _leg_mpdata(cfg, m, champ, trials):
    from cdk.core.norms import rel_l1
    from cdk.dist import mpdata as dist_mp
    from cdk.kernels.mpdata import problem

    data = problem.init_data(cfg)
    si, _, gather_f = dist_mp.make_dist_step(cfg, m)
    args = si(data)
    loop = dist_mp.make_dist_loop(cfg, m)

    def run_n(n):
        return jax.block_until_ready(loop(*args, n))

    nv = 5
    f_d, flux_d = loop(*args, nv)
    f_r, flux_r = _champion_loop("mpdata", champ, cfg, data)(data, nv)
    err = max(rel_l1(gather_f(f_d), np.asarray(f_r)),
              rel_l1(np.asarray(flux_d), np.asarray(flux_r)))
    lo, med, hi = _slope_loop(run_n, 20, 120, trials)
    return "halo_hoisted_loop", lo, med, hi, float(err), TOL_MPDATA


def _leg_dss(cfg, m, champ, trials):
    from cdk.core.norms import rel_l2
    from cdk.dist import biharmonic as dist_bi
    from cdk.kernels.biharmonic import problem

    data = problem.init_data(cfg)
    si, _, gather = dist_bi.make_dist_step_dss(cfg, m)
    loop = dist_bi.make_dist_loop_dss(cfg, m)
    q, aux = si(data)

    def run_n(n):
        return jax.block_until_ready(loop(q, aux, n))

    nv = 8
    out_d = gather(loop(q, aux, nv))
    out_r = _champion_loop("biharmonic_dss", champ, cfg, data)(data, nv)
    err = rel_l2(out_d, np.asarray(out_r))
    lo, med, hi = _slope_loop(run_n, 16, 80, trials)
    return "dss_ring_loop", lo, med, hi, float(err), TOL_DSS


def _leg_dss2d(cfg, m, champ, trials):
    from cdk.core.norms import rel_l2
    from cdk.dist import biharmonic as dist_bi
    from cdk.dist import mesh as meshmod
    from cdk.kernels.biharmonic import problem

    data = problem.init_data(cfg)
    m2 = meshmod.make_mesh2d(shape=(1, m.devices.size))
    si, _, gather = dist_bi.make_dist_step_dss2d(cfg, m2)
    loop = dist_bi.make_dist_loop_dss2d(cfg, m2)
    q5, aux = si(data)

    def run_n(n):
        return jax.block_until_ready(loop(q5, aux, n))

    nv = 4
    out_d = gather(loop(q5, aux, nv))
    out_r = _champion_loop("biharmonic_dss2d", champ, cfg, data)(data, nv)
    err = rel_l2(out_d, np.asarray(out_r))
    lo, med, hi = _slope_loop(run_n, 10, 60, trials)
    return "dss2d_torus_loop", lo, med, hi, float(err), TOL_DSS


def _leg_cke(cfg, m, champ, trials):
    from cdk.core.norms import rel_l1
    from cdk.dist import cke as dist_cke
    from cdk.kernels.cke import problem

    data = problem.init_data(cfg)
    sdata = dist_cke.shard_data(data, m)
    loop = dist_cke.make_dist_loop(cfg, m, ring=False)

    def run_n(n):
        return jax.block_until_ready(loop(sdata, n))

    nv = 2
    flx_d = loop(sdata, nv)
    flx_r = _champion_loop("cke", champ, cfg, data)(data, nv)
    err = rel_l1(np.asarray(flx_d), np.asarray(flx_r))
    lo, med, hi = _slope_loop(run_n, 4, 10, trials)
    return "allgather_loop", lo, med, hi, float(err), TOL_CKE


def _leg_mpdata_slices(cfg, m, champ, trials):
    """The slice-batch data-parallel loop — the REFERENCE's own scaling
    axis (per-node slice batches, zero exchange): each device runs the
    single-device loop on its own slices (dist.mpdata.single_device_loop),
    so this leg gates 'dist form == champion' at ratio ~1.0 by design."""
    from cdk.core.norms import rel_l1
    from cdk.dist import mpdata as dist_mp
    from cdk.kernels.mpdata import problem

    data = problem.init_data(cfg)
    si, loop, (gather_f, gather_flux) = dist_mp.make_dist_loop_slices(
        cfg, m)
    args = si(data)

    def run_n(n):
        return jax.block_until_ready(loop(*args, n))

    nv = 3
    f_d, flux_d = loop(*args, nv)
    f_r, flux_r = _champion_loop("mpdata", champ, cfg, data)(data, nv)
    err = max(rel_l1(gather_f(f_d), np.asarray(f_r)),
              rel_l1(gather_flux(flux_d), np.asarray(flux_r)))
    lo, med, hi = _slope_loop(run_n, 20, 120, trials)
    return "slice_batch_loop", lo, med, hi, float(err), TOL_MPDATA


# leg name -> (kernel family, builder).  The slice-batch mpdata leg is
# a second dist formulation of the same family (zero-exchange data
# parallelism — the reference's own scaling axis).
LEGS = {
    "mpdata": ("mpdata", _leg_mpdata),
    "mpdata_slices": ("mpdata", _leg_mpdata_slices),
    "biharmonic_dss": ("biharmonic_dss", _leg_dss),
    "biharmonic_dss2d": ("biharmonic_dss2d", _leg_dss2d),
    "cke": ("cke", _leg_cke),
    # plain biharmonic is deliberately absent: element-sharded it has NO
    # exchange (the DSS-free kernel is embarrassingly parallel), so its
    # "dist" number is the single-chip kernel under shard_map — nothing a
    # regression gate on top of the production leg would catch.
}


def run_dist_legs(champions: dict, production: bool = True,
                  trials: int = 3, quiet: bool = False,
                  configs: dict | None = None):
    """Run all dist production legs on a 1-device mesh.

    champions: {kernel: single-chip champion variant name} (the bench's
    PRODUCTION_CHAMPIONS dict) — each leg verifies against its family's
    champion loop output.  configs overrides the per-family config
    (tests pass reduced shapes; the bench passes nothing and gets the
    production presets)."""
    from cdk.core.config import production_config, with_overrides
    from cdk.dist import mesh as meshmod
    from cdk.harness.specs import get_spec

    say = (lambda *a: None) if quiet else print
    m = meshmod.make_mesh(1)
    results = []
    for leg, (family, build) in LEGS.items():
        spec = get_spec(family)
        if configs is not None:
            if leg not in configs:
                continue  # explicit config set = explicit leg set
            cfg = configs[leg]
        else:
            cfg = (production_config(family) if production
                   else with_overrides(spec.default_config(),
                                       dtype="float32", device_init=True))
        try:
            path, lo, med, hi, err, tol = build(cfg, m, champions[family],
                                                trials)
        except Exception as e:  # a crashed leg must gate, not kill, bench
            results.append(DistLegResult(
                leg, "<error>", 0.0, 0.0, 0.0, 0.0, 0.0,
                float("nan"), 0.0, False,
                note=f"{type(e).__name__}: {e}"))
            say(f"[dist] {leg:<16s} ERROR {type(e).__name__}: {e}")
            continue
        ok = bool(np.isfinite(err) and err < tol)
        results.append(DistLegResult(
            leg, path, med, lo, med, hi,
            spec.grid_points(cfg) / med, err, tol, ok,
        ))
        say(f"[dist] {leg:<16s} {path:<24s} {med * 1e6:9.2f} us/step "
            f"{spec.grid_points(cfg) / med / 1e9:7.2f} G pts/s "
            f"err={err:.2e} (tol {tol:g}) {'ok' if ok else 'VERIFY FAILED'}")
    return results
