"""The driver contract: entry() compiles single-device; dryrun_multichip
jits the full distributed step over an n-device mesh."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import pytest


def test_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.block_until_ready(jax.jit(fn)(*args))
    assert out.shape == args[0].shape


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n):
    import __graft_entry__ as g

    g.dryrun_multichip(n)
