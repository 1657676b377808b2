"""Accumulating wall-clock timers.

JAX analog of the reference timer module (reference:
nested_loops/timerMod.f90:10-127 — Timer type with create/start/stop/print
accumulating `cpu_time`).  Differences forced by the execution model:
JAX dispatch is asynchronous, so `stop()` optionally blocks on device work
(`block_until_ready`) before reading the clock — the analog of the
reference's `!$acc wait` before `system_clock`
(mmf-mpdata-tracer/advect_scalar2D…F90:109-110,237-238).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import jax


@dataclass
class Timer:
    name: str
    start_time: float = 0.0
    elapsed: float = 0.0
    running: bool = False
    count: int = 0

    def start(self) -> "Timer":
        if not self.running:
            self.running = True
            self.start_time = time.perf_counter()
        return self

    def stop(self, wait_for: Any = None) -> float:
        """Stop the timer, accumulating elapsed time. If `wait_for` is given
        (a jax array / pytree), block until it is ready first."""
        if wait_for is not None:
            jax.block_until_ready(wait_for)
        if self.running:
            self.elapsed += time.perf_counter() - self.start_time
            self.running = False
            self.count += 1
        return self.elapsed

    def report(self) -> str:
        return f" Timer {self.name:<28s}: {self.elapsed: .6f} s"

    def print(self) -> None:
        print(self.report())


@dataclass
class TimerSet:
    """A named collection of timers, like the reference driver's
    timerData/timerOrig/timerGPU set (nested_loops/nested.F90:163-294)."""

    timers: dict[str, Timer] = field(default_factory=dict)

    def __call__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def report(self) -> str:
        return "\n".join(t.report() for t in self.timers.values())

    def as_dict(self) -> dict[str, float]:
        return {name: t.elapsed for name, t in self.timers.items()}


def best_of(fn, *args, iters: int = 20, trials: int = 5, warmup: int = 3) -> float:
    """Best (min) per-call seconds over `trials` timing runs of `iters`
    dispatches each. Min-of-trials filters host scheduling noise."""
    best = float("inf")
    for t in range(trials):
        sec, _ = time_fn(fn, *args, iters=iters, warmup=warmup if t == 0 else 1)
        best = min(best, sec / iters)
    return best


def time_fn(fn, *args, iters: int = 1, warmup: int = 1) -> tuple[float, Any]:
    """Time `iters` sequential dispatches of `fn(*args)`, blocking on the
    final result — the analog of the reference's `do n=1,nIters` timing loops
    (nested.F90:191-199). Returns (seconds_total, last_result)."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def slope_time(make_runner, data, n1: int = 50, n2: int = 400,
               trials: int = 5, min_delta: float = 5e-3,
               max_n: int = 51200) -> float:
    """Best-of per-step seconds via two-point slope: time an n1-step and an
    n2-step device-side loop (each ended by block_until_ready) and return
    (t(n2) − t(n1)) / (n2 − n1).  The slope cancels the constant dispatch
    and synchronisation cost, which would otherwise swamp microsecond
    kernels.  If the slope is below the timing noise
    floor (`min_delta` seconds), the iteration counts are grown until it is
    resolvable — sub-µs kernels need thousands of chained steps."""
    best, _ = slope_time_detail(make_runner, data, n1=n1, n2=n2,
                                trials=trials, min_delta=min_delta,
                                max_n=max_n)
    return best


def slope_time_detail(make_runner, data, n1: int = 50, n2: int = 400,
                      trials: int = 5, min_delta: float = 5e-3,
                      max_n: int = 51200) -> tuple[float, dict]:
    """slope_time plus a dispersion band.  Returns (best_seconds_per_step,
    band) where band carries per-trial-pair slope samples from every
    accepted scale: {"min", "median", "max", "n_samples"} in seconds/step,
    so a later swing smaller than the band is distinguishable from a real
    regression.  `best` keeps slope_time's definition (min over scales of
    best-trial deltas)."""

    def times_of(n):
        r = make_runner(n)
        jax.block_until_ready(r(data))  # compile + warm
        ts = []
        for _ in range(trials):
            t0 = time.perf_counter()
            jax.block_until_ready(r(data))
            ts.append(time.perf_counter() - t0)
        return ts

    def _band(samples):
        if not samples:
            return {}
        s = sorted(samples)
        return {
            "min": s[0],
            "median": s[len(s) // 2],
            "max": s[-1],
            "n_samples": len(s),
        }

    slopes = []
    samples = []  # per-trial-pair slopes across accepted scales
    while True:
        t2s, t1s = times_of(n2), times_of(n1)
        delta = min(t2s) - min(t1s)
        if delta >= min_delta:
            slopes.append(delta / (n2 - n1))
            samples += [(b - a) / (n2 - n1) for a, b in zip(t1s, t2s)]
            if len(slopes) >= 2 or n2 * 2 > max_n:
                # min over scales: per-step time cannot be lower than the
                # true cost, and each scale's measurement only errs upward
                # (noise adds to the longer run more often than it
                # subtracts)
                return min(slopes), _band(samples)
            n1 *= 2
            n2 *= 2
        elif n2 >= max_n:
            if slopes:
                return min(slopes), _band(samples)
            samples = [(b - a) / (n2 - n1) for a, b in zip(t1s, t2s)]
            return max(delta, 1e-12) / (n2 - n1), _band(samples)
        else:
            n1 *= 4
            n2 *= 4
