"""Profiling/tracing utilities — the aux subsystem the reference covers
with hand timers + committed nvprof/ArmIE artifacts (SURVEY §5: timerMod,
system_clock brackets, results/*-nvprof).

Equivalents here:
  - `trace(...)`: jax.profiler TensorBoard trace of a callable (the nvprof
    analog — per-HLO/per-kernel device timeline, viewable with
    `tensorboard --logdir <dir>` or xprof).
  - `annotate(name)`: TraceAnnotation context for attributing regions.
  - `device_memory_stats()`: live device-memory usage (allocator
    observability).
  - `cost_analysis(fn, *args)`: XLA's own FLOP/byte estimates per
    executable — the ArmIE instruction-count analog, for roofline math.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Any

import jax


def trace(fn, *args, logdir: str | None = None, iters: int = 3) -> str:
    """Capture a device trace of `iters` calls of fn(*args); returns the
    trace directory (default `<repo>/build/trace`, gitignored; inspect
    with tensorboard/xprof)."""
    if logdir is None:
        from cdk.core.platform import REPO_ROOT

        logdir = str(REPO_ROOT / "build" / "trace")
    Path(logdir).mkdir(parents=True, exist_ok=True)
    out = fn(*args)  # compile outside the trace window
    jax.block_until_ready(out)
    with jax.profiler.trace(logdir):
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
    return logdir


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler timelines."""
    with jax.profiler.TraceAnnotation(name):
        yield


def device_memory_stats(device=None) -> dict[str, Any]:
    dev = device or jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    return dict(stats) if stats else {}


def cost_analysis(fn, *args) -> dict[str, float]:
    """XLA cost model for the compiled executable of fn(*args): flops,
    bytes accessed, etc. — model-side roofline inputs."""
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):  # older jax returns one dict per computation
        ca = ca[0] if ca else {}
    return {k: float(v) for k, v in ca.items()
            if isinstance(v, (int, float))}
