"""Device mesh setup for domain-decomposed runs.

The reference links MPI but never communicates — "plan was to add some MPI
parallelism later" (nested_loops/README.md:29-31, nested.F90:41-43,468-470).
This module supplies what was deferred: a 1-D `jax.sharding.Mesh` over
the horizontal-domain axis (elements for biharmonic, x-columns for mpdata,
edges for cke), and a 2-D mesh over the element grid for the torus DSS.
The cards of one host reach each other all to all over NVLink, so a
mesh's shape follows the decomposition, not a physical topology."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DOMAIN_AXIS = "x"


def make_mesh(n_devices: int | None = None, axis: str = DOMAIN_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]), (axis,))


def make_mesh2d(n_devices: int | None = None,
                shape: tuple[int, int] | None = None,
                axes: tuple[str, str] = ("ei", "ej")) -> Mesh:
    """2-D device mesh over the element-GRID axes for the torus-DSS
    decomposition (dist.biharmonic.make_dist_step_dss2d): axis `ei` splits
    element rows (i-direction exchanges), `ej` element columns
    (j-direction exchanges).  With no explicit shape, the device count is
    factorized most-square (8 -> 2x4)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if shape is None:
        pi = int(n**0.5)
        while n % pi:
            pi -= 1
        shape = (pi, n // pi)
    if shape[0] * shape[1] > len(devs):
        raise ValueError(f"requested {shape} devices, have {len(devs)}")
    return Mesh(
        np.asarray(devs[: shape[0] * shape[1]]).reshape(shape), axes
    )


def to_host_global(a) -> np.ndarray:
    """Fetch a (possibly multi-controller) jax.Array as the full global
    host ndarray: a plain device_get when every shard is process-local, a
    `process_allgather` when shards live on other processes' devices
    (jax refuses a direct fetch there).  Lets the dist gathers work
    unchanged under both the single-process virtual mesh and real
    multi-process runs (dist.multiproc)."""
    if getattr(a, "is_fully_addressable", True):
        return np.asarray(a)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(a, tiled=True))


def domain_sharding(mesh: Mesh, rank: int, sharded_dim: int = 0):
    """NamedSharding splitting `sharded_dim` of a rank-`rank` array over the
    mesh's domain axis, replicating the rest."""
    spec = [None] * rank
    spec[sharded_dim] = mesh.axis_names[0]
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
