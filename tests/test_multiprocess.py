"""Real multi-controller runs: N separate OS processes joined by
`jax.distributed.initialize`, collectives crossing the process boundary
over XLA's Gloo CPU backend — the true multi-host leg of BASELINE.json's
"Multi-host biharmonic_wk + MPDATA ... on N>=2 hosts" config, which the
in-process virtual mesh (conftest) cannot exercise.

Each worker independently verifies the N-process dist result against its
locally computed single-process reference at f64 (see
cdk/dist/multiproc.py); the test asserts every worker's verdict.
These spawn subprocesses (~30-60 s each); the launcher strips this
process's 8-virtual-device XLA_FLAGS pin from the worker env (workers set
their own per-process device count)."""

import pytest

from cdk.dist.multiproc import launch


def _launch(kernel, **kw):
    return launch(kernel, quiet=True, **kw)


@pytest.mark.parametrize("kernel", ["mpdata", "cke", "biharmonic",
                                    "biharmonic_dss", "biharmonic_dss2d"])
def test_two_process_parity(kernel):
    verdicts = _launch(kernel, nproc=2, steps=3, devices_per_proc=2)
    assert len(verdicts) == 2
    for v in verdicts:
        assert v["global_devices"] == 4
        assert v["local_devices"] == 2
        assert v["ok"], v


def test_three_process_uneven_devices_mpdata():
    """3 processes x 1 device: every ppermute edge crosses a process
    boundary (no intra-process neighbor to hide behind)."""
    verdicts = _launch("mpdata", nproc=3, steps=2, devices_per_proc=1)
    for v in verdicts:
        assert v["global_devices"] == 3
        assert v["ok"], v


def test_three_process_ring_dss():
    """3 processes x 1 device on the ring-DSS loop: every ppermute of GLL
    edge columns crosses a real process boundary — the communication
    pattern closest to HOMME's DSS in the multi-controller runtime."""
    verdicts = _launch("biharmonic_dss", nproc=3, steps=8,
                       devices_per_proc=1)
    for v in verdicts:
        assert v["global_devices"] == 3
        assert v["ok"], v
