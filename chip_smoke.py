"""Smoke run of every kernel family on one NVIDIA GPU.

    python3 chip_smoke.py           # one card: phases 1-4 below
    python3 chip_smoke.py --four    # four cards: the dist paths only

Phases (each prints its own lines; any failure exits non-zero):
  1. the device: JAX's first device must be a GPU; prints its kind, the
     device count, and the card's name and power limit from nvidia-smi;
  2. compiles the production step of each family's reference and
     champion once and prints `compiled.memory_analysis()` for each;
  3. verifies each family: the card's reference against the scalar C++
     oracle on the shipped (small) input, and the champion against the
     reference at production width through `driver.run_kernel`; prints
     each error beside its tolerance and the precision used;
  4. times the CUDA MPDATA kernel against XLA's reference n-step loop at
     production width, alternating them (A, B, B, A), in µs/step.

With --four only phase 1 and the four-card dist paths run: each dist
path on a 4-device mesh against the same config computed on card 0.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def say(*a):
    print(*a, flush=True)


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return " ".join(f"{f.replace('_size_in_bytes', '')}="
                    f"{getattr(ma, f, 'n/a')}" for f in fields)


def _policy(var) -> str:
    return "reduced (fast-math)" if var.fast_math else "exact f32"


def phase_compile(families, champions):
    import jax

    from cdk.core import registry
    from cdk.core.config import production_config
    from cdk.harness.specs import get_spec

    say("== phase 2: compile every production step ==")
    for fam in families:
        cfg = production_config(fam)
        data = get_spec(fam).init(cfg)
        for name in dict.fromkeys(("reference_jnp", champions[fam])):
            step2, aux, _ = registry._materialize(
                registry.get(fam, name), cfg, data)
            t0 = time.perf_counter()
            compiled = jax.jit(step2).lower(aux, data).compile()
            say(f"[compile] {fam:<16s} {name:<16s} "
                f"{time.perf_counter() - t0:6.1f} s  {_memory_line(compiled)}")
        del data


def _oracle(fam, cfg, data):
    from cdk.core import native
    from cdk.kernels.biharmonic.dss2d import torus_shape

    if fam == "biharmonic":
        return native.biharmonic_ref(data, cfg.rrearth)
    if fam == "biharmonic_dss":
        return native.biharmonic_dss_ref(data, cfg.rrearth)
    if fam == "biharmonic_dss2d":
        return native.biharmonic_dss2d_ref(data, cfg.rrearth,
                                           *torus_shape(cfg.nelemd))
    if fam == "cke":
        return native.cke_ref(data, cfg.coef3rdorder)
    return native.mpdata_ref(data)


def phase_verify(families, champions) -> bool:
    from cdk.core import registry
    from cdk.core.config import production_config, with_overrides
    from cdk.harness import driver
    from cdk.harness.specs import get_spec

    say("== phase 3: verify every production family ==")
    ok = True
    for fam in families:
        spec = get_spec(fam)
        # (a) the reference on the card against the f64 scalar oracle
        cfg = with_overrides(spec.default_config(), dtype="float32")
        data = spec.init(cfg)
        out = registry.get(fam, "reference_jnp").fn(cfg)(data)
        check = spec.verify(cfg, jax_to_np(out), _oracle(fam, cfg, data))
        ok &= check.ok
        say(f"[verify] {fam:<16s} reference_jnp vs C++ f64 oracle "
            f"(shipped size, f32 on card) {_errs(check.metrics)} "
            f"{'ok' if check.ok else 'FAILED'}")
        # (b) the champion against the reference at production width
        champ = champions[fam]
        res = driver.run_kernel(fam, production_config(fam),
                                variants=[champ], iters=4, trials=1,
                                quiet=True)
        r = next((r for r in res if r.variant == champ), None)
        good = r is not None and r.ok
        ok &= good
        var = registry.get(fam, champ)
        say(f"[verify] {fam:<16s} {champ} vs reference_jnp (production, "
            f"{_policy(var)}) {_errs(r.metrics) if r else 'missing'} "
            f"{'ok' if good else 'FAILED'}")
    return ok


def jax_to_np(out):
    import numpy as np

    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _errs(metrics) -> str:
    keep = ("rel_l2", "rel_l1", "rel_l1_f", "rel_l1_flux", "max_rel_err",
            "tol", "tol_flux")
    return " ".join(f"{k}={metrics[k]:.3e}" for k in keep if k in metrics)


def _time_per_step(fn, data, n, reps=5) -> float:
    import jax

    jax.block_until_ready(fn(data))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(data)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps / n


def phase_time_mpdata():
    from cdk.core import registry
    from cdk.core.config import production_config
    from cdk.harness.specs import get_spec

    say("== phase 4: CUDA MPDATA kernel vs XLA reference loop ==")
    cfg = production_config("mpdata")
    spec = get_spec("mpdata")
    data = spec.init(cfg)
    n = 100
    ref_step, aux, _ = registry._materialize(
        registry.get("mpdata", "reference_jnp"), cfg, data)
    xla = spec.scan_runner(ref_step, aux, n)
    _, _, kloop = registry._materialize(
        registry.get("mpdata", "hopper_fused"), cfg, data)
    cuda = lambda d: kloop(d, n)
    order = (("xla", xla), ("cuda", cuda), ("cuda", cuda), ("xla", xla))
    got = {"xla": [], "cuda": []}
    for name, fn in order:
        got[name].append(_time_per_step(fn, data, n) * 1e6)
    say(f"[time] mpdata production n={n} order A,B,B,A: "
        f"XLA reference_jnp loop {got['xla'][0]:.2f} {got['xla'][1]:.2f} "
        f"us/step; CUDA hopper_fused {got['cuda'][0]:.2f} "
        f"{got['cuda'][1]:.2f} us/step")


def phase_four() -> bool:
    """The dist paths on a 4-device mesh, each against the same config
    computed on card 0 (the default device)."""
    import jax
    import numpy as np

    from cdk.core import registry
    from cdk.core.config import production_config, with_overrides
    from cdk.core.norms import rel_l1, rel_l2
    from cdk.dist import biharmonic as dist_bi
    from cdk.dist import cke as dist_cke
    from cdk.dist import mesh as meshmod
    from cdk.dist import mpdata as dist_mp
    from cdk.harness.specs import get_spec

    say("== phase 5: four-card dist paths vs card 0 ==")
    mesh = meshmod.make_mesh(4)
    ok = True

    def shards(arr) -> str:
        devs = sorted({s.device.id for s in arr.addressable_shards})
        shapes = {tuple(s.data.shape) for s in arr.addressable_shards}
        return f"shards on devices {devs} of shape {sorted(shapes)}"

    def report(path, err, tol, arr, t_dist, t_one):
        nonlocal ok
        good = bool(np.isfinite(err) and err < tol)
        spread = len({s.device.id for s in arr.addressable_shards}) == 4
        ok &= good and spread
        say(f"[four] {path:<24s} err={err:.3e} tol={tol:g} "
            f"{shards(arr)} dist {t_dist * 1e6:.1f} us/step, card 0 "
            f"{t_one * 1e6:.1f} us/step "
            f"{'ok' if good and spread else 'FAILED'}")

    def timed(fn, n):
        jax.block_until_ready(fn(n))
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(n))
        return out, (time.perf_counter() - t0) / n

    def chained(fam, cfg, data, n):
        """n reference steps on card 0, as the driver's scan runs them."""
        spec = get_spec(fam)
        step2, aux, _ = registry._materialize(
            registry.get(fam, "reference_jnp"), cfg, data)
        run = spec.scan_runner(step2, aux, n)
        return lambda k: run(data)

    bcfg = with_overrides(production_config("biharmonic"), nelemd=4 * 5400)
    from cdk.kernels.biharmonic import problem as bp

    bdata = bp.init_data(bcfg)
    # element-sharded single-application step
    sh = dist_bi.shard_data(bdata, mesh)
    step = dist_bi.make_dist_step(bcfg, mesh)
    q_d, t_d = timed(lambda k: step(sh), 1)
    q_1, t_1 = timed(chained("biharmonic", bcfg, bdata, 1), 1)
    report("biharmonic element step", rel_l2(np.asarray(q_d),
                                              np.asarray(q_1)),
           1e-6, q_d, t_d, t_1)
    del q_d, q_1, sh
    n = 4
    # ring-DSS loop
    si, _, gather = dist_bi.make_dist_step_dss(bcfg, mesh)
    loop = dist_bi.make_dist_loop_dss(bcfg, mesh)
    q, aux = si(bdata)
    out, t_d = timed(lambda k: loop(q, aux, k), n)
    ref, t_1 = timed(chained("biharmonic_dss", bcfg, bdata, n), n)
    report("ring-DSS loop", rel_l2(gather(out), np.asarray(ref)), 1e-5,
           out, t_d, t_1)
    del q, aux, out, ref
    # torus-DSS loop on a 2x2 mesh over the element grid
    mesh2 = meshmod.make_mesh2d(shape=(2, 2))
    si, _, gather = dist_bi.make_dist_step_dss2d(bcfg, mesh2)
    loop = dist_bi.make_dist_loop_dss2d(bcfg, mesh2)
    q, aux = si(bdata)
    out, t_d = timed(lambda k: loop(q, aux, k), n)
    ref, t_1 = timed(chained("biharmonic_dss2d", bcfg, bdata, n), n)
    report("torus-DSS loop 2x2", rel_l2(gather(out), np.asarray(ref)),
           1e-5, out, t_d, t_1)
    del q, aux, out, ref, bdata

    mcfg = with_overrides(production_config("mpdata"), nslices=4 * 8192)
    from cdk.kernels.mpdata import problem as mp

    mdata = mp.init_data(mcfg)
    n = 10
    f_1, t_1 = timed(chained("mpdata", mcfg, mdata, n), n)
    # x-decomposed halo loop (XLA masked core)
    si, _, gather_f = dist_mp.make_dist_step(mcfg, mesh)
    args = si(mdata)
    loop = dist_mp.make_dist_loop(mcfg, mesh)
    out, t_d = timed(lambda k: loop(*args, k), n)
    err = max(rel_l1(gather_f(out[0]), np.asarray(f_1[0])),
              rel_l1(np.asarray(out[1]), np.asarray(f_1[1])))
    report("mpdata halo loop", err, 1e-5, out[0], t_d, t_1)
    del args, out
    # slice-batch loop (the CUDA kernel on each card)
    si, loop, (gather_f, gather_flux) = dist_mp.make_dist_loop_slices(
        mcfg, mesh)
    args = si(mdata)
    out, t_d = timed(lambda k: loop(*args, k), n)
    err = max(rel_l1(gather_f(out[0]), np.asarray(f_1[0])),
              rel_l1(gather_flux(out[1]), np.asarray(f_1[1])))
    report("mpdata slice-batch loop", err, 1e-5, out[0], t_d, t_1)
    del args, out, mdata, f_1

    ccfg = with_overrides(production_config("cke"), nedges=4 * 256000)
    from cdk.kernels.cke import problem as cp

    cdata = cp.init_data(ccfg)
    n = 4
    sdata = dist_cke.shard_data(cdata, mesh)
    loop = dist_cke.make_dist_loop(ccfg, mesh)
    out, t_d = timed(lambda k: loop(sdata, k), n)
    ref, t_1 = timed(chained("cke", ccfg, cdata, n), n)
    report("cke all_gather loop", rel_l1(np.asarray(out), np.asarray(ref)),
           1e-6, out, t_d, t_1)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--four", action="store_true",
                   help="run the four-card dist paths (and nothing else)")
    args = p.parse_args(argv)
    try:
        from cdk.core.platform import (
            NoGpuError,
            enable_compilation_cache,
            nvidia_smi_card,
            require_gpu,
        )
    except ImportError as e:
        print(f"chip_smoke: the cdk package is not importable ({e})",
              file=sys.stderr)
        return 1

    try:
        dev = require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    import jax

    say("== phase 1: device ==")
    count = len(jax.devices())
    say(f"[device] platform={dev.platform} kind={dev.device_kind} "
        f"count={count}")
    say(f"[device] nvidia-smi: {nvidia_smi_card()}")
    enable_compilation_cache()
    if args.four and count < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {count}",
              file=sys.stderr)
        return 1

    import cdk.kernels  # noqa: F401  (registers the variants)
    from bench import PRODUCTION_CHAMPIONS

    families = list(PRODUCTION_CHAMPIONS)
    if args.four:
        ok = phase_four()
    else:
        phase_compile(families, PRODUCTION_CHAMPIONS)
        ok = phase_verify(families, PRODUCTION_CHAMPIONS)
        phase_time_mpdata()
    if not ok:
        print("chip_smoke: a verification FAILED", file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
