"""Kernel-variant registry.

The reference ships N implementation variants per kernel, dispatched by the
driver program (e.g. biharmonic CPU / gpu_compiler_inline / gpu_push_loop,
biharmonic_wk_kernel.F90:100-536; nested original / gpu-optimized / k-tiled /
cke_impl1 / cke_impl2, nested.F90:191-439).  Here variants register under
(kernel, variant-name) and the harness enumerates them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

_REGISTRY: dict[str, dict[str, "Variant"]] = {}


class UnsupportedConfigError(NotImplementedError):
    """Raised by a variant factory whose stated applicability excludes the
    requested config or device (e.g. a CUDA kernel off the GPU, or a dense
    recast whose operands exceed the device's memory budget).  The driver
    reports it as an explicit typed SKIP with the reason.  A dedicated
    type — NOT a bare NotImplementedError — because JAX itself raises
    NotImplementedError for missing primitive/transform rules, and a
    regression of that kind must stay a loud FAILURE."""


@dataclass(frozen=True)
class Variant:
    kernel: str
    name: str
    fn: Callable
    description: str = ""
    supports_f64: bool = True
    fast_math: bool = False  # intentionally-lower-precision variant


def register(
    kernel: str,
    name: str,
    description: str = "",
    supports_f64: bool = True,
    fast_math: bool = False,
):
    def deco(fn):
        _REGISTRY.setdefault(kernel, {})[name] = Variant(
            kernel, name, fn, description, supports_f64, fast_math
        )
        return fn

    return deco


def variants(kernel: str) -> dict[str, "Variant"]:
    return dict(_REGISTRY.get(kernel, {}))


def get(kernel: str, name: str) -> "Variant":
    return _REGISTRY[kernel][name]


def kernels() -> list[str]:
    return sorted(_REGISTRY)


def _materialize(variant: "Variant", cfg, data):
    """-> (step2, aux, loop_or_None) with the canonical call form
    step2(aux, data).

    Variant factories return one of:
      step(data)
      (prepare, step2)            — prepare(data) builds untimed
                                    device-resident auxiliaries (the analog
                                    of the reference's untimed staging,
                                    nested.F90:400-403); step2(aux, data)
      {"step":…, "prepare":…, "loop":…}
                                  — `loop(data, n)` runs n steps with state
                                    kept in the variant's resident layout
                                    (the reference's `do n=1,nIters` over
                                    device-resident data, nested.F90:191-199)

    aux is threaded as an explicit jit ARGUMENT everywhere downstream —
    closing a jitted harness function over large prepared device arrays
    would embed them as constants in the compiled program."""
    made = variant.fn(cfg)
    loop = None
    if isinstance(made, dict):
        loop = made.get("loop")
        prepare = made.get("prepare")
        step2 = made["step"]
        made = (prepare, step2) if prepare else step2
    if isinstance(made, tuple):
        prepare, step2 = made
        aux = prepare(data)
        return step2, aux, loop

    def step2_plain(aux, d, _s=made):
        return _s(d)

    return step2_plain, (), loop


def make_step(variant: "Variant", cfg, data):
    """Materialize a variant into a plain step(data) callable (aux is
    passed per call, never closure-captured into downstream jits)."""
    step2, aux, _ = _materialize(variant, cfg, data)
    return lambda d: step2(aux, d)
