"""Real multi-controller (one JAX process per "host") parity runs.

The reference links MPI but never communicates — "plan was to add some MPI
parallelism later" (nested_loops/README.md:29-31, nested.F90:41-43,468-470).
The dist layer implements the decomposition the reference deferred; the
virtual single-process mesh (tests/conftest.py) exercises the collective
PROGRAM, but every device still lives in one OS process.  This module
supplies the true multi-host leg (BASELINE.json config: "Multi-host
biharmonic_wk + MPDATA ... on N>=2 hosts"): N separate OS processes, each
owning its local CPU devices, joined into one multi-controller runtime by
`jax.distributed.initialize`, with psum/ppermute/all_gather crossing the
process boundary over XLA's Gloo CPU collectives.  This is a CPU-only
parity harness: the workers pin the CPU platform, and multi-host runs on
GPUs (NCCL across hosts) are out of its scope.  The program it runs —
same `shard_map`, same specs, same dist factories — is the one the
single-process GPU paths run.

Protocol: every process builds the IDENTICAL problem from the deterministic
seed (the reference's same-seed re-init discipline, biharmonic_wk_kernel
.F90:48-58), shards it onto the GLOBAL mesh, runs the dist step/loop, then
all-gathers the result (`multihost_utils.process_allgather`) and verifies
against the locally-computed single-process reference — so each process
independently asserts N-process == 1-process parity.

Run it via `python -m cdk dist-mp --kernel mpdata --nproc 2` (the
launcher) or directly as workers (`python -m cdk.dist.multiproc
--process-id I --num-processes N ...`).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

TOL = 1e-12  # f64 parity gate (the dist tests' 1e-13 + one margin decade)


# --------------------------------------------------------------------------
# worker side (runs inside each jax.distributed process)
# --------------------------------------------------------------------------


def _parity_mpdata(steps: int):
    import numpy as np

    from cdk.core.config import MpdataConfig
    from cdk.core.norms import rel_l1
    from cdk.dist import mesh as meshmod
    from cdk.dist import mpdata as dist_mpdata
    from cdk.kernels.mpdata import problem, reference

    cfg = MpdataConfig(dtype="float64")
    data = problem.init_data(cfg)
    m = meshmod.make_mesh()
    shard_inputs, step, gather_f = dist_mpdata.make_dist_step(cfg, m)
    f_s, u_s, w_s, aux = shard_inputs(data)

    f_ref, flux_ref = data.f, data.flux
    ref_step = reference.make_reference(cfg)
    d = data
    flux_s = None
    for _ in range(steps):
        f_ref, flux_ref = ref_step(d)
        d = problem.MpdataData(f_ref, d.u, d.w, d.rho, d.rhow, d.adz,
                               flux_ref)
        f_s, flux_s = step(f_s, u_s, w_s, aux)

    e_f = rel_l1(gather_f(f_s), np.asarray(f_ref))
    # flux is psum-replicated -> directly fetchable on every process
    e_flux = rel_l1(np.asarray(flux_s), np.asarray(flux_ref))
    return max(float(e_f), float(e_flux))


def _parity_cke(steps: int):
    import numpy as np

    from cdk.core.config import CkeConfig
    from cdk.core.norms import rel_l1
    from cdk.dist import cke as dist_cke
    from cdk.dist import mesh as meshmod
    from cdk.kernels.cke import problem, reference

    import jax

    ndev = len(jax.devices())
    cfg = CkeConfig(nedges=64 * ndev, ncells=40, nvertlevels=16,
                    dtype="float64")
    data = problem.init_data(cfg)
    ref = reference.make_reference(cfg)(data)
    m = meshmod.make_mesh()
    data_s = dist_cke.shard_data(data, m)
    loop = dist_cke.make_dist_loop(cfg, m)
    flx_s = loop(data_s, steps)
    from cdk.dist.mesh import to_host_global

    return float(rel_l1(to_host_global(flx_s), np.asarray(ref)))


def _parity_dss2d(steps: int):
    import dataclasses

    import numpy as np

    from cdk.core.config import BiharmonicConfig, with_overrides
    from cdk.core.norms import rel_l2
    from cdk.core.registry import _materialize, get
    from cdk.dist import biharmonic as dist_bi
    from cdk.dist import mesh as meshmod
    from cdk.dist.mesh import to_host_global
    from cdk.kernels.biharmonic import problem

    cfg = with_overrides(BiharmonicConfig(), nelemd=16, nlev=4, qsize=2,
                         dtype="float64")
    data = problem.init_data(cfg)
    ref_step, _, _ = _materialize(
        get("biharmonic_dss2d", "reference_jnp"), cfg, data)
    q = data.qtens
    for _ in range(steps):
        q = ref_step((), dataclasses.replace(data, qtens=q))

    m = meshmod.make_mesh2d()
    shard_inputs, _, gather = dist_bi.make_dist_step_dss2d(cfg, m)
    loop = dist_bi.make_dist_loop_dss2d(cfg, m)
    q5, aux = shard_inputs(data)
    out = gather(to_host_global(loop(q5, aux, steps)))
    return float(rel_l2(np.asarray(out), np.asarray(q)))


def _parity_biharmonic(steps: int):
    """Element-sharded biharmonic step chained `steps` times: XLA batch-
    partitions the einsums over the global mesh with no collectives, so
    this leg proves the multi-controller runtime itself (device_put onto a
    cross-process NamedSharding + global fetch) for the plain family."""
    import dataclasses

    import numpy as np

    from cdk.core.config import BiharmonicConfig, with_overrides
    from cdk.core.norms import rel_l2
    from cdk.dist import biharmonic as dist_bi
    from cdk.dist import mesh as meshmod
    from cdk.dist.mesh import to_host_global
    from cdk.kernels.biharmonic import problem, reference

    cfg = with_overrides(BiharmonicConfig(), nelemd=48, nlev=4, qsize=2,
                         dtype="float64")
    data = problem.init_data(cfg)
    ref_step = reference.make_reference(cfg)
    q_ref = data.qtens
    for _ in range(steps):
        q_ref = ref_step(dataclasses.replace(data, qtens=q_ref))

    m = meshmod.make_mesh()
    sharded = dist_bi.shard_data(data, m)
    step = dist_bi.make_dist_step(cfg, m)
    q = sharded.qtens
    for _ in range(steps):
        q = step(dataclasses.replace(sharded, qtens=q))
    return float(rel_l2(to_host_global(q), np.asarray(q_ref)))


def _parity_biharmonic_dss(steps: int):
    """Ring-DSS loop (boundary GLL columns ring-ppermuted every step)
    across REAL process boundaries — the edge-column ring exchange most
    like HOMME's DSS."""
    import dataclasses

    import numpy as np

    from cdk.core.config import BiharmonicConfig, with_overrides
    from cdk.core.norms import rel_l2
    from cdk.core.registry import _materialize, get
    from cdk.dist import biharmonic as dist_bi
    from cdk.dist import mesh as meshmod
    from cdk.dist.mesh import to_host_global
    from cdk.kernels.biharmonic import problem

    n = steps
    cfg = with_overrides(BiharmonicConfig(), nelemd=96, nlev=4, qsize=2,
                         dtype="float64")
    data = problem.init_data(cfg)
    ref_step, _, _ = _materialize(
        get("biharmonic_dss", "reference_jnp"), cfg, data)
    q_ref = data.qtens
    for _ in range(n):
        q_ref = ref_step((), dataclasses.replace(data, qtens=q_ref))

    m = meshmod.make_mesh()
    shard_inputs, _, gather = dist_bi.make_dist_step_dss(cfg, m)
    loop = dist_bi.make_dist_loop_dss(cfg, m)
    q_s, aux = shard_inputs(data)
    out = gather(to_host_global(loop(q_s, aux, n)))
    return float(rel_l2(np.asarray(out), np.asarray(q_ref)))


PARITY = {
    "mpdata": _parity_mpdata,
    "cke": _parity_cke,
    "biharmonic": _parity_biharmonic,
    "biharmonic_dss": _parity_biharmonic_dss,
    "biharmonic_dss2d": _parity_dss2d,
}


def worker_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cdk.dist.multiproc worker")
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--coordinator", default="localhost:12421")
    p.add_argument("--kernel", default="mpdata", choices=sorted(PARITY))
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--devices-per-proc", type=int, default=2)
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1 (a 0-step run produces no output "
                "to verify)")

    # platform pins must land before the first jax device query
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{args.devices_per_proc}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    err = PARITY[args.kernel](args.steps)
    ok = err < TOL
    print(json.dumps({
        "process": args.process_id,
        "num_processes": args.num_processes,
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "kernel": args.kernel,
        "steps": args.steps,
        "max_rel_err": err,
        "ok": ok,
    }), flush=True)
    return 0 if ok else 1


# --------------------------------------------------------------------------
# launcher side (spawns the workers; usable from the CLI and from tests)
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(kernel: str = "mpdata", nproc: int = 2, steps: int = 3,
           devices_per_proc: int = 2, timeout: float = 600.0,
           quiet: bool = False) -> list[dict]:
    """Spawn `nproc` worker processes, wait, and return their JSON verdict
    dicts.  Raises on a worker that dies without a verdict.  _free_port
    closes the probe socket before the coordinator rebinds it (TOCTOU);
    a lost race shows up as worker 0 dying on a bind error, so retry the
    whole launch on a fresh port rather than trying to hold the socket."""
    last_exc = None
    for _attempt in range(3):
        try:
            return _launch_once(kernel, nproc, steps, devices_per_proc,
                                timeout, quiet)
        except RuntimeError as e:
            msg = str(e).lower()
            if "address already in use" in msg or "bind" in msg:
                last_exc = e
                continue
            raise
    raise last_exc


def _launch_once(kernel: str, nproc: int, steps: int,
                 devices_per_proc: int, timeout: float,
                 quiet: bool) -> list[dict]:
    import time

    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    # the workers pick their own per-process device count; drop any
    # inherited pin (e.g. the test conftest's 8-virtual-device flag)
    flags = [t for t in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in t]
    if flags:
        env["XLA_FLAGS"] = " ".join(flags)
    else:
        env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cdk.dist.multiproc",
             "--process-id", str(i), "--num-processes", str(nproc),
             "--coordinator", coord, "--kernel", kernel,
             "--steps", str(steps),
             "--devices-per-proc", str(devices_per_proc)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for i in range(nproc)
    ]
    verdicts = []
    # one shared deadline across all workers: they run concurrently, so
    # the total wait is `timeout`, not nproc*timeout worst-case
    deadline = time.monotonic() + timeout
    try:
        for i, pr in enumerate(procs):
            out, errtxt = pr.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if not lines:
                raise RuntimeError(
                    f"worker {i} produced no verdict "
                    f"(rc={pr.returncode}):\n{errtxt[-2000:]}"
                )
            v = json.loads(lines[-1])
            verdicts.append(v)
            if not quiet:
                print(f" [mp worker {i}] kernel={v['kernel']} "
                      f"procs={v['num_processes']} "
                      f"devices={v['global_devices']} "
                      f"(local {v['local_devices']}) steps={v['steps']} "
                      f"max_rel_err={v['max_rel_err']:.3e} "
                      f"{'ok' if v['ok'] else '** FAILED **'}")
    except BaseException:
        # a dead/hung/timed-out worker must not leave the others blocked
        # inside jax.distributed.initialize waiting on it
        for p2 in procs:
            if p2.poll() is None:
                p2.kill()
        raise
    return verdicts


if __name__ == "__main__":
    sys.exit(worker_main())
