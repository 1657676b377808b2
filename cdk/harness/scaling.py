"""Weak-scaling harness: grid-points/s and parallel efficiency as devices
grow with the domain (the BASELINE.json north-star metric: ≥80% weak-scaling
efficiency from 1 chip up).

On real multi-chip hardware the mesh spans chips/hosts; on a single-chip or
CPU session the same code runs against `xla_force_host_platform_device_count`
virtual devices (functional validation of the decomposition + collectives;
absolute numbers are only meaningful on real hardware)."""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np

from cdk.core.config import MpdataConfig, with_overrides
from cdk.dist import mesh as meshmod
from cdk.dist import mpdata as dist_mpdata


@dataclass
class ScalePoint:
    n_devices: int
    nx_global: int
    seconds_per_step: float
    grid_points_per_s: float
    efficiency: float  # vs the 1-device point, weak scaling


def _time_steps(step, args, n_steps: int, trials: int = 3) -> float:
    """Best-of total seconds for n_steps chained dispatches (per-dispatch;
    the dist step is one XLA program per call)."""
    import time

    def run():
        f_s = args[0]
        out = None
        for _ in range(n_steps):
            out = step(f_s, *args[1:])
            f_s = out[0]
        jax.block_until_ready(out)

    run()  # compile + warm
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best / n_steps


def weak_scaling_mpdata(
    device_counts=(1, 2, 4, 8),
    nx_per_device: int = 64,
    nslices: int = 48,
    nz: int = 58,
    dtype: str = "float32",
    n_steps: int = 20,
    overlap: bool = True,
    quiet: bool = False,
) -> list[ScalePoint]:
    """Grow the global x domain proportionally to the device count and
    measure grid-points/s per step of the halo-exchange dist step."""
    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    base_pts_per_dev = None
    for n in device_counts:
        if n > len(jax.devices()):
            say(f" weak-scaling: skipping n={n} (only "
                f"{len(jax.devices())} devices)")
            continue
        nx = nx_per_device * n
        cfg = with_overrides(
            MpdataConfig(), nx=nx, nslices=nslices, nz=nz, dtype=dtype
        )
        m = meshmod.make_mesh(n)
        shard_inputs, step_plain, _ = dist_mpdata.make_dist_step(cfg, m)
        step = (dist_mpdata.make_dist_step_overlap(cfg, m)
                if overlap else step_plain)
        from cdk.kernels.mpdata import problem

        data = problem.init_data(cfg)
        f_s, u_s, w_s, aux = shard_inputs(data)
        sec = _time_steps(step, (f_s, u_s, w_s, aux), n_steps)
        pts = cfg.grid_points / sec
        per_dev = pts / n
        if base_pts_per_dev is None:
            base_pts_per_dev = per_dev
        eff = per_dev / base_pts_per_dev
        points.append(ScalePoint(n, nx, sec, pts, eff))
        say(
            f" weak-scaling mpdata n={n:<2d} nx={nx:<5d} "
            f"{sec * 1e6:9.2f} us/step {pts / 1e6:10.1f} M pts/s "
            f"eff={eff * 100:5.1f}%"
        )
    return points


def weak_scaling_mpdata_slices(
    device_counts=(1, 2, 4, 8),
    nslices_per_device: int = 16,
    nx: int = 64,
    nz: int = 58,
    dtype: str = "float32",
    n_steps: int = 20,
    quiet: bool = False,
) -> list[ScalePoint]:
    """Weak scaling along the SLICE-BATCH axis — the reference's own
    scaling knob (each node its own slice batch): grow nslices with the
    device count and run the zero-exchange data-parallel loop
    (dist.mpdata.make_dist_loop_slices).  Efficiency is exact by
    construction up to compiler/runtime variation; this is the
    production scaling axis, with the x-decomposed sweep above
    exercising the halo-exchange capability."""
    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    base_pts_per_dev = None
    for n in device_counts:
        if n > len(jax.devices()):
            say(f" weak-scaling: skipping n={n} (only "
                f"{len(jax.devices())} devices)")
            continue
        cfg = with_overrides(
            MpdataConfig(), nx=nx, nslices=nslices_per_device * n, nz=nz,
            dtype=dtype,
        )
        m = meshmod.make_mesh(n)
        from cdk.kernels.mpdata import problem

        si, loop, _ = dist_mpdata.make_dist_loop_slices(cfg, m)
        args = si(problem.init_data(cfg))

        def run(nsteps):
            jax.block_until_ready(loop(*args, nsteps))

        run(n_steps)
        import time

        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(n_steps)
            best = min(best, time.perf_counter() - t0)
        sec = best / n_steps
        pts = cfg.grid_points / sec
        per_dev = pts / n
        if base_pts_per_dev is None:
            base_pts_per_dev = per_dev
        eff = per_dev / base_pts_per_dev
        points.append(ScalePoint(n, cfg.nx, sec, pts, eff))
        say(
            f" weak-scaling mpdata-slices n={n:<2d} "
            f"nslices={cfg.nslices:<5d} {sec * 1e6:9.2f} us/step "
            f"{pts / 1e6:10.1f} M pts/s eff={eff * 100:5.1f}%"
        )
    return points


def overlap_gain_mpdata(
    n_devices: int = 8,
    nx_per_device: int = 64,
    n_steps: int = 20,
    dtype: str = "float32",
    quiet: bool = False,
) -> dict:
    """Serialized vs overlapped halo-exchange step at fixed size: the
    halo-overlap % metric (SURVEY §7 step 7). Meaningful on several cards;
    on virtual CPU devices it validates the plumbing only."""
    say = (lambda *a: None) if quiet else print
    n = min(n_devices, len(jax.devices()))
    cfg = with_overrides(MpdataConfig(), nx=nx_per_device * n, dtype=dtype)
    m = meshmod.make_mesh(n)
    shard_inputs, step_plain, _ = dist_mpdata.make_dist_step(cfg, m)
    step_ov = dist_mpdata.make_dist_step_overlap(cfg, m)
    from cdk.kernels.mpdata import problem

    data = problem.init_data(cfg)
    args = shard_inputs(data)
    t_plain = _time_steps(step_plain, args, n_steps)
    t_ov = _time_steps(step_ov, args, n_steps)
    gain = (t_plain - t_ov) / t_plain
    say(
        f" overlap n={n}: plain {t_plain * 1e6:9.2f} us/step, "
        f"overlapped {t_ov * 1e6:9.2f} us/step, gain {gain * 100:5.1f}%"
    )
    return {"n_devices": n, "plain_s": t_plain, "overlap_s": t_ov,
            "gain": gain}


def weak_scaling_biharmonic(
    device_counts=(1, 2, 4, 8),
    nelemd_per_device: int = 16,
    nlev: int = 72,
    qsize: int = 40,
    dtype: str = "float32",
    n_steps: int = 10,
    overlap: bool = True,
    quiet: bool = False,
) -> list[ScalePoint]:
    """DSS-coupled biharmonic weak scaling: elements grow with devices; per
    step each shard exchanges two GLL boundary columns over the ring."""
    import time

    from cdk.core.config import BiharmonicConfig
    from cdk.dist import biharmonic as dist_bi
    from cdk.kernels.biharmonic import problem

    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    base = None
    for n in device_counts:
        if n > len(jax.devices()):
            continue
        cfg = with_overrides(
            BiharmonicConfig(), nelemd=nelemd_per_device * n, nlev=nlev,
            qsize=qsize, dtype=dtype,
        )
        m = meshmod.make_mesh(n)
        shard_inputs, step, _ = dist_bi.make_dist_step_dss(
            cfg, m, overlap=overlap and nelemd_per_device >= 2
        )
        q_s, aux = shard_inputs(problem.init_data(cfg))
        jax.block_until_ready(step(q_s, aux))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            q = q_s
            for _ in range(n_steps):
                q = step(q, aux)
            jax.block_until_ready(q)
            best = min(best, (time.perf_counter() - t0) / n_steps)
        pts = cfg.grid_points / best
        per_dev = pts / n
        base = base or per_dev
        eff = per_dev / base
        points.append(ScalePoint(n, cfg.nelemd, best, pts, eff))
        say(
            f" weak-scaling biharmonic_dss n={n:<2d} nelemd={cfg.nelemd:<5d} "
            f"{best * 1e6:9.2f} us/step {pts / 1e6:10.1f} M pts/s "
            f"eff={eff * 100:5.1f}%"
        )
    return points


def weak_scaling_dss2d(
    mesh_shapes=((1, 1), (1, 2), (2, 2), (2, 4)),
    nelemd_per_device: int = 16,
    nlev: int = 72,
    qsize: int = 40,
    dtype: str = "float32",
    n_steps: int = 10,
    quiet: bool = False,
) -> list[ScalePoint]:
    """2-D torus-DSS weak scaling: the element GRID grows with the 2-D
    device mesh (both axes), per step each shard runs the two
    nearest-neighbor ppermute passes (j columns along ej, i rows of the
    j-summed field along ei).  Element counts are chosen so each shard
    keeps a fixed (2ex0 x 2ey0)-per-device grid patch."""
    import time

    from cdk.core.config import BiharmonicConfig
    from cdk.dist import biharmonic as dist_bi
    from cdk.kernels.biharmonic import problem
    from cdk.kernels.biharmonic.dss2d import torus_shape

    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    base = None
    ex0, ey0 = torus_shape(nelemd_per_device)
    for pi, pj in mesh_shapes:
        n = pi * pj
        if n > len(jax.devices()):
            continue
        # grow the torus with the mesh, keeping torus_shape's own
        # factorization consistent with the mesh (ex multiple of pi, ey
        # of pj): nelemd = (ex0*pi) * (ey0*pj) need not re-factorize to
        # that grid, so verify and fall back to a square-per-device patch
        nelemd = (ex0 * pi) * (ey0 * pj)
        ex, ey = torus_shape(nelemd)
        if ex % pi or ey % pj:
            nelemd = (2 * pi) * (2 * pj) * 4
            ex, ey = torus_shape(nelemd)
            if ex % pi or ey % pj:
                continue
        cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd, nlev=nlev,
                             qsize=qsize, dtype=dtype)
        m = meshmod.make_mesh2d(shape=(pi, pj))
        shard_inputs, step, _ = dist_bi.make_dist_step_dss2d(cfg, m)
        q_s, aux = shard_inputs(problem.init_data(cfg))
        jax.block_until_ready(step(q_s, aux))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            q = q_s
            for _ in range(n_steps):
                q = step(q, aux)
            jax.block_until_ready(q)
            best = min(best, (time.perf_counter() - t0) / n_steps)
        pts = cfg.grid_points / best
        per_dev = pts / n
        base = base or per_dev
        eff = per_dev / base
        points.append(ScalePoint(n, cfg.nelemd, best, pts, eff))
        say(
            f" weak-scaling biharmonic_dss2d mesh={pi}x{pj} "
            f"nelemd={cfg.nelemd:<5d} {best * 1e6:9.2f} us/step "
            f"{pts / 1e6:10.1f} M pts/s eff={eff * 100:5.1f}%"
        )
    return points


def overlap_gain_biharmonic(
    n_devices: int = 8,
    nelemd_per_device: int = 16,
    n_steps: int = 10,
    dtype: str = "float32",
    quiet: bool = False,
) -> dict:
    """Serialized vs overlapped DSS step at fixed size (the biharmonic leg
    of the halo-overlap % north-star metric)."""
    import time

    from cdk.core.config import BiharmonicConfig
    from cdk.dist import biharmonic as dist_bi
    from cdk.kernels.biharmonic import problem

    say = (lambda *a: None) if quiet else print
    n = min(n_devices, len(jax.devices()))
    cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd_per_device * n,
                         dtype=dtype)
    m = meshmod.make_mesh(n)
    data = problem.init_data(cfg)

    def time_step(overlap):
        shard_inputs, step, _ = dist_bi.make_dist_step_dss(
            cfg, m, overlap=overlap)
        q_s, aux = shard_inputs(data)
        jax.block_until_ready(step(q_s, aux))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            q = q_s
            for _ in range(n_steps):
                q = step(q, aux)
            jax.block_until_ready(q)
            best = min(best, (time.perf_counter() - t0) / n_steps)
        return best

    t_plain = time_step(False)
    t_ov = time_step(True)
    gain = (t_plain - t_ov) / t_plain
    say(
        f" overlap biharmonic_dss n={n}: plain {t_plain * 1e6:9.2f} us/step,"
        f" overlapped {t_ov * 1e6:9.2f} us/step, gain {gain * 100:5.1f}%"
    )
    return {"n_devices": n, "plain_s": t_plain, "overlap_s": t_ov,
            "gain": gain}


def overlap_gain_cke(
    n_devices: int = 8,
    nedges_per_device: int = 3200,
    ncells: int = 2800,
    nvert: int = 100,
    n_steps: int = 10,
    dtype: str = "float32",
    quiet: bool = False,
) -> dict:
    """all_gather-serialized vs ring-pipelined CKE dist step (the overlap
    measurement hook); results are bitwise-equal by construction."""
    import time

    from cdk.core.config import CkeConfig
    from cdk.dist import cke as dist_cke
    from cdk.kernels.cke import problem

    say = (lambda *a: None) if quiet else print
    n = min(n_devices, len(jax.devices()))
    cfg = with_overrides(CkeConfig(), nedges=nedges_per_device * n,
                         ncells=ncells, nvertlevels=nvert, dtype=dtype)
    m = meshmod.make_mesh(n)
    data = dist_cke.shard_data(problem.init_data(cfg), m)

    def time_step(run):
        jax.block_until_ready(run(data))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = None
            for _ in range(n_steps):
                out = run(data)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / n_steps)
        return best

    t_plain = time_step(dist_cke.make_dist_step(cfg, m))
    t_ring = time_step(dist_cke.make_dist_step_ring(cfg, m))
    gain = (t_plain - t_ring) / t_plain
    say(
        f" overlap cke n={n}: all_gather {t_plain * 1e6:9.2f} us/iter, "
        f"ring {t_ring * 1e6:9.2f} us/iter, gain {gain * 100:5.1f}%"
    )
    return {"n_devices": n, "plain_s": t_plain, "overlap_s": t_ring,
            "gain": gain}


def weak_scaling_cke(
    device_counts=(1, 2, 4, 8),
    nedges_per_device: int = 3200,
    ncells: int = 2800,
    nvert: int = 100,
    dtype: str = "float32",
    n_steps: int = 10,
    quiet: bool = False,
) -> list[ScalePoint]:
    """Edge-partitioned CKE: edges grow with devices, cell fields sharded +
    all-gathered (the communication weak-scales with ncells, constant)."""
    import time

    from cdk.core.config import CkeConfig
    from cdk.dist import cke as dist_cke
    from cdk.kernels.cke import problem

    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    base = None
    for n in device_counts:
        if n > len(jax.devices()):
            continue
        cfg = with_overrides(
            CkeConfig(), nedges=nedges_per_device * n, ncells=ncells,
            nvertlevels=nvert, dtype=dtype,
        )
        m = meshmod.make_mesh(n)
        data = dist_cke.shard_data(problem.init_data(cfg), m)
        run = dist_cke.make_dist_step(cfg, m)
        jax.block_until_ready(run(data))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = None
            for _ in range(n_steps):
                out = run(data)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / n_steps)
        pts = cfg.grid_points / best
        per_dev = pts / n
        base = base or per_dev
        eff = per_dev / base
        points.append(ScalePoint(n, cfg.nedges, best, pts, eff))
        say(
            f" weak-scaling cke n={n:<2d} nEdges={cfg.nedges:<7d} "
            f"{best * 1e6:9.2f} us/iter {pts / 1e6:10.1f} M pts/s "
            f"eff={eff * 100:5.1f}%"
        )
    return points
