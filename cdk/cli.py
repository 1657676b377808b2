"""Command-line driver: `python -m cdk <cmd> ...`.

Replaces the reference's per-miniapp executables (`./atm`, `./advect`,
`./nested` — atmosphere/README.md:21, mmf-mpdata-tracer/README.md:21,
nested_loops/README.md:14) with one CLI:

  python -m cdk list
  python -m cdk run biharmonic|mpdata|cke|all [--dtype float32]
         [--iters N] [--trials N] [--variant NAME ...] [--json out.json]
         [--set key=value ...] [--namelist nested.nml] [--preset production]
         [--device-init]
  python -m cdk integrate mpdata --steps N --variant hopper_fused
         [--out state.npz]
  python -m cdk scaling --devices 1,2,4,8 --nx-per-device 512
  python -m cdk verify
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_set(kvs):
    out = {}
    for kv in kvs or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cdk")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list kernels and registered variants")

    sub.add_parser(
        "verify",
        help="run the full verification battery (pytest: oracles, parity, "
        "decomposition, transforms, native) on the virtual CPU mesh",
    )

    runp = sub.add_parser("run", help="run a kernel benchmark + verification")
    runp.add_argument("kernel",
                      choices=["biharmonic", "biharmonic_dss",
                               "biharmonic_dss2d", "mpdata", "cke", "all"])
    runp.add_argument("--dtype", default=None,
                      choices=["float32", "float64", "bfloat16"])
    runp.add_argument("--iters", type=int, default=10)
    runp.add_argument("--trials", type=int, default=3)
    runp.add_argument("--variant", action="append", default=None)
    runp.add_argument("--json", dest="json_out", default=None)
    runp.add_argument("--set", dest="sets", action="append", default=None,
                      metavar="key=value", help="config field override")
    runp.add_argument("--namelist", default=None,
                      help="reference-format nested.nml (cke only)")
    runp.add_argument("--preset", default=None, choices=["production"],
                      help="use the production-scale config preset")
    runp.add_argument("--device-init", action="store_true",
                      help="generate inputs on device (jax.random)")

    intp = sub.add_parser(
        "integrate",
        help="run an N-step integration of a kernel with a chosen variant "
        "and save the final state (npz)",
    )
    intp.add_argument("kernel",
                      choices=["biharmonic", "biharmonic_dss",
                               "biharmonic_dss2d", "mpdata", "cke"])
    intp.add_argument("--steps", type=int, default=100)
    intp.add_argument("--variant", default="reference_jnp")
    intp.add_argument("--dtype", default="float32",
                      choices=["float32", "float64", "bfloat16"])
    intp.add_argument("--out", default=None, help="output .npz path")
    intp.add_argument("--set", dest="sets", action="append", default=None,
                      metavar="key=value")

    scalep = sub.add_parser(
        "scaling",
        help="weak-scaling + overlap-gain sweeps of the dist steps "
        "(mpdata | biharmonic | cke | all)",
    )
    scalep.add_argument("kernel", nargs="?", default="all",
                        choices=["mpdata", "biharmonic", "cke", "all"])
    scalep.add_argument("--devices", default="1,2,4,8")
    scalep.add_argument("--nx-per-device", type=int, default=64)
    scalep.add_argument("--nelemd-per-device", type=int, default=16)
    scalep.add_argument("--nedges-per-device", type=int, default=3200)
    scalep.add_argument("--steps", type=int, default=20)
    scalep.add_argument("--no-overlap", action="store_true")
    scalep.add_argument("--overlap-gain", action="store_true",
                        help="also measure serialized-vs-overlapped gain")

    mpp = sub.add_parser(
        "dist-mp",
        help="real multi-controller parity run: N OS processes joined by "
        "jax.distributed (CPU/Gloo collectives), each verifying the "
        "N-process dist result against its local single-process reference",
    )
    mpp.add_argument("kernel", nargs="?", default="all",
                     choices=["mpdata", "cke", "biharmonic",
                              "biharmonic_dss", "biharmonic_dss2d", "all"])
    mpp.add_argument("--nproc", type=int, default=2)
    mpp.add_argument("--steps", type=int, default=3)
    mpp.add_argument("--devices-per-proc", type=int, default=2)

    args = p.parse_args(argv)

    if args.cmd == "dist-mp":
        from cdk.dist.multiproc import PARITY, launch

        kernels = sorted(PARITY) if args.kernel == "all" else [args.kernel]
        rc = 0
        for k in kernels:
            verdicts = launch(k, nproc=args.nproc, steps=args.steps,
                              devices_per_proc=args.devices_per_proc)
            if not all(v["ok"] for v in verdicts):
                rc = 1
        return rc

    if args.cmd == "verify":
        import os
        import subprocess
        from pathlib import Path

        root = Path(__file__).resolve().parents[1]
        env = dict(os.environ)
        return subprocess.run(
            [sys.executable, "-m", "pytest", str(root / "tests"), "-q"],
            env=env, cwd=root,
        ).returncode

    from cdk.core.platform import enable_compilation_cache

    enable_compilation_cache()
    import cdk.kernels  # noqa: F401  (registers variants)
    from cdk.core import registry

    if args.cmd == "list":
        for kernel in registry.kernels():
            print(f"{kernel}:")
            for name, var in registry.variants(kernel).items():
                print(f"  {name:<22s} {var.description}")
        return 0

    if args.cmd == "integrate":
        import jax
        import numpy as np

        from cdk.core import registry as reg
        from cdk.core.config import with_overrides
        from cdk.harness.specs import get_spec

        spec = get_spec(args.kernel)
        overrides = _parse_set(args.sets)
        overrides["dtype"] = args.dtype
        cfg = with_overrides(spec.default_config(), **overrides)
        data = spec.init(cfg)
        var = reg.get(args.kernel, args.variant)
        step2, aux, vloop = reg._materialize(var, cfg, data)
        if vloop is not None:
            out = vloop(data, args.steps)
        else:
            out = spec.scan_runner(step2, aux, args.steps)(data)
        jax.block_until_ready(out)
        leaves = {
            f"out{i}": np.asarray(leaf)
            for i, leaf in enumerate(
                out if isinstance(out, tuple) else (out,))
        }
        for name, arr in leaves.items():
            print(f" {args.kernel}/{args.variant} x{args.steps}: {name} "
                  f"shape={arr.shape} |x|max={np.abs(arr).max():.6e}")
        if args.out:
            np.savez(args.out, **leaves)
            print(f"wrote {args.out}")
        return 0

    if args.cmd == "scaling":
        from cdk.harness import scaling

        devices = tuple(int(x) for x in args.devices.split(","))
        overlap = not args.no_overlap
        kernels = (["mpdata", "biharmonic", "cke"]
                   if args.kernel == "all" else [args.kernel])
        for k in kernels:
            if k == "mpdata":
                scaling.weak_scaling_mpdata(
                    device_counts=devices,
                    nx_per_device=args.nx_per_device,
                    n_steps=args.steps, overlap=overlap,
                )
                scaling.weak_scaling_mpdata_slices(
                    device_counts=devices, n_steps=args.steps,
                )
                if args.overlap_gain:
                    scaling.overlap_gain_mpdata(
                        n_devices=devices[-1],
                        nx_per_device=args.nx_per_device,
                        n_steps=args.steps,
                    )
            elif k == "biharmonic":
                scaling.weak_scaling_biharmonic(
                    device_counts=devices,
                    nelemd_per_device=args.nelemd_per_device,
                    n_steps=args.steps, overlap=overlap,
                )
                def _sq(n):
                    p = int(n**0.5)
                    while n % p:
                        p -= 1
                    return (p, n // p)

                scaling.weak_scaling_dss2d(
                    mesh_shapes=tuple(_sq(n) for n in devices),
                    nelemd_per_device=args.nelemd_per_device,
                    n_steps=args.steps,
                )
                if args.overlap_gain:
                    scaling.overlap_gain_biharmonic(
                        n_devices=devices[-1],
                        nelemd_per_device=args.nelemd_per_device,
                        n_steps=args.steps,
                    )
            else:
                scaling.weak_scaling_cke(
                    device_counts=devices,
                    nedges_per_device=args.nedges_per_device,
                    n_steps=args.steps,
                )
                if args.overlap_gain:
                    scaling.overlap_gain_cke(
                        n_devices=devices[-1],
                        nedges_per_device=args.nedges_per_device,
                        n_steps=args.steps,
                    )
        return 0

    from dataclasses import asdict

    from cdk.core.config import (
        cke_config_from_namelist,
        production_config,
        with_overrides,
    )
    from cdk.harness import driver
    from cdk.harness.specs import get_spec

    overrides = _parse_set(args.sets)
    if args.dtype:
        overrides["dtype"] = args.dtype
    elif "dtype" not in overrides:
        # default configs are f64 (the reference's RKIND=real*8,
        # nested_vars.F90:17-18) — but without the x64 flag JAX silently
        # truncates to f32, which would then be verified at f64 gates and
        # spuriously fail.  Coerce and say so.
        import jax as _jax

        if not _jax.config.jax_enable_x64:
            print("note: jax x64 disabled -> running dtype=float32 "
                  "(use JAX_ENABLE_X64=1 for f64 parity runs)")
            overrides["dtype"] = "float32"
    if getattr(args, "device_init", False):
        overrides["device_init"] = True

    if args.kernel == "all":
        results = driver.run_all(iters=args.iters, trials=args.trials,
                                 dtype=args.dtype)
    else:
        if args.kernel == "cke" and args.namelist:
            cfg = cke_config_from_namelist(args.namelist, **overrides)
        elif args.preset == "production":
            cfg = with_overrides(production_config(args.kernel), **overrides)
        else:
            cfg = with_overrides(get_spec(args.kernel).default_config(),
                                 **overrides)
        res = driver.run_kernel(args.kernel, cfg, variants=args.variant,
                                iters=args.iters, trials=args.trials)
        results = {"kernels": {args.kernel: [asdict(r) for r in res]}}

    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(driver.to_json(results))
        print(f"wrote {args.json_out}")
    # a failed variant is a failed run (the reference prints violations and
    # the human reads them, nested.F90:272-274; a CLI must exit non-zero)
    failed = [
        r["variant"]
        for rs in results["kernels"].values()
        for r in rs
        if not r["ok"]
    ]
    if failed:
        print(f"FAILED variants: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
