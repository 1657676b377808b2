"""Device policy: which accelerator a measurement runs on, what it is
allowed to allocate, and where compiled programs are cached."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

REPO_ROOT = Path(__file__).resolve().parents[2]


class NoGpuError(RuntimeError):
    """A measurement path found no GPU.  Timing the CPU (or any other
    device) in its place would report a number nobody deploys."""


def require_gpu() -> jax.Device:
    """-> the first device, which must be a GPU; raises NoGpuError
    otherwise (including when JAX cannot initialise any backend)."""
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:
        raise NoGpuError(f"no GPU found: {e}") from e
    if dev.platform != "gpu":
        raise NoGpuError(
            f"no GPU found: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind})")
    return dev


def nvidia_smi_card() -> str:
    """The card's name and power limit as nvidia-smi reports them
    ("NVIDIA H200, 700.00 W"), read by a child process that never imports
    JAX; "not available" when nvidia-smi cannot be run."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not available ({type(e).__name__})"
    if r.returncode != 0:
        return f"not available (nvidia-smi exit {r.returncode})"
    return r.stdout.strip()


def device_record() -> dict:
    """What every benchmark row names: JAX's platform, device kind and
    device count, and the card's name and power limit."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": nvidia_smi_card(),
    }


# Host-backend cap for a dense-recast operand.  The CPU backend reports no
# allocator limit, and the tests share their host with other processes.
HOST_DENSE_BUDGET = 2 * 2**30


def dense_operand_budget() -> int:
    """Bytes a dense-recast variant may spend on its recast operands: a
    quarter of the device allocator's limit, leaving the rest for the
    problem's inputs, outputs and XLA's temporaries."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return limit // 4 if limit else HOST_DENSE_BUDGET


def compilation_cache_dir() -> Path:
    """$JAX_COMPILATION_CACHE_DIR when set, else `<repo>/.jax_cache`.  The
    path is part of the cache key, so it is fixed, never per-run."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else REPO_ROOT / ".jax_cache"


def enable_compilation_cache() -> Path:
    """Persistent compilation cache: compiles survive across processes, so
    short-lived benchmark invocations skip recompilation.  When the
    environment names a directory JAX reads it itself and nothing is set
    here."""
    path = compilation_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return path
