"""Core utilities: exact LCG stream, namelist parsing, norms."""

import numpy as np
import pytest

from cdk.core import frng, norms
from cdk.core.config import (
    BiharmonicConfig,
    CkeConfig,
    cke_config_from_namelist,
    read_namelist,
    with_overrides,
)


def scalar_lcg(n, state=11):
    """Straight scalar transcription of the reference myrandom recurrence
    (biharmonic_wk_kernel.F90:87-90) used as the oracle for the vectorized
    generator."""
    out = []
    for _ in range(n):
        state = (1301 * state + 97) % 131072
        out.append(state / 131072.0)
    return np.array(out), state


def test_lcg_matches_scalar_oracle():
    gen = frng.Lcg()
    got = gen.draw(1000)
    want, state = scalar_lcg(1000)
    np.testing.assert_array_equal(got, want)
    assert gen.state == state
    # continuation draws continue the same stream
    got2 = gen.draw(500)
    want2, _ = scalar_lcg(500, state)
    np.testing.assert_array_equal(got2, want2)


def test_lcg_first_value():
    # old=11 -> (1301*11+97) % 131072 = 14408
    gen = frng.Lcg()
    assert gen.draw(1)[0] == 14408 / 131072.0


def test_lcg_reset():
    gen = frng.Lcg()
    a = gen.draw(37)
    gen.reset()
    b = gen.draw(37)
    np.testing.assert_array_equal(a, b)


def test_lcg_long_stream_wraps_period():
    # qsize*nlev*np*np*nelemd = 737280 draws exceeds the 2^17 period —
    # the reference wraps too; just check vectorized == scalar chunkwise.
    gen = frng.Lcg()
    got = gen.draw(200000)
    want, _ = scalar_lcg(200000)
    np.testing.assert_array_equal(got, want)


def test_fill_fortran_order():
    gen = frng.Lcg()
    arr = gen.fill_fortran((3, 4))
    gen.reset()
    flat = gen.draw(12)
    # Fortran column-major: a(1,1), a(2,1), a(3,1), a(1,2), ...
    for j in range(4):
        for i in range(3):
            assert arr[i, j] == flat[j * 3 + i]


def test_read_reference_namelist(tmp_path):
    nml = tmp_path / "nested.nml"
    nml.write_text(
        "&nested_nml\n   nIters = 100\n   nEdges = 25600\n   nCells = 2800\n"
        "   nVertLevels = 100\n   nAdv = 10\n/\n"
    )
    d = read_namelist(nml)
    assert d == {
        "niters": 100,
        "nedges": 25600,
        "ncells": 2800,
        "nvertlevels": 100,
        "nadv": 10,
    }
    cfg = cke_config_from_namelist(nml)
    assert cfg.nedges == 25600 and cfg.nadv == 10
    assert cfg.coef3rdorder == 2.14


def test_config_overrides():
    cfg = with_overrides(BiharmonicConfig(), nelemd=4, dtype="float32")
    assert cfg.nelemd == 4 and cfg.np_dtype == np.float32
    assert cfg.ncol == 2880
    with pytest.raises(ValueError):
        with_overrides(CkeConfig(), bogus=1)


def test_norms():
    ref = np.array([1.0, 2.0, -3.0])
    assert norms.rel_l2(ref, ref) == 0.0
    assert norms.rel_l1(ref, ref) == 0.0
    x = ref.copy()
    x[0] += 1e-3
    assert 0 < norms.rel_l2(x, ref) < 1e-3
    n_bad, max_err, lines = norms.pointwise_check(x, ref, tol=1e-10)
    assert n_bad == 1 and max_err == pytest.approx(1e-3)
    assert len(lines) == 1
    n_bad, _, _ = norms.pointwise_check(x, ref, tol=1.0)
    assert n_bad == 0
    # NaN counts as violation even when all finite errors pass
    x[1] = np.nan
    n_bad, _, _ = norms.pointwise_check(x, ref, tol=1.0)
    assert n_bad == 1


def test_device_host_consistency():
    """yakl_check analog: device copies match host arrays bitwise."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cdk.core.norms import device_host_consistency

    host = {"a": np.arange(12.0).reshape(3, 4), "b": np.ones(5)}
    dev = jax.device_put({"a": jnp.asarray(host["a"]),
                          "b": jnp.asarray(host["b"])})
    ok, lines = device_host_consistency(dev, host)
    assert ok, lines
    bad = {"a": host["a"] + 1e-9, "b": host["b"]}
    ok, lines = device_host_consistency(dev, bad)
    assert not ok and lines


def test_device_init_paths():
    """Device-side init: same shapes/structure as host init, deterministic."""
    import numpy as np

    from cdk.core.config import (
        BiharmonicConfig, CkeConfig, MpdataConfig, with_overrides
    )
    from cdk.kernels.biharmonic import problem as bp
    from cdk.kernels.cke import problem as cp
    from cdk.kernels.mpdata import problem as mp

    b = bp.init_data(with_overrides(
        BiharmonicConfig(), nelemd=2, nlev=3, qsize=2, dtype="float32",
        device_init=True))
    assert b.qtens.shape == (2, 2, 3, 4, 4)
    m = mp.init_data(with_overrides(
        MpdataConfig(), nslices=2, nx=4, nz=6, dtype="float32",
        device_init=True))
    assert m.f.shape == (2, 10, 5)
    c = cp.init_data(with_overrides(
        CkeConfig(), nedges=8, ncells=6, nvertlevels=5, nadv=3,
        dtype="float32", device_init=True))
    tr, cm = np.asarray(c.tracer), np.asarray(c.cell_mask)
    assert (tr[cm == 0.0] == 0.0).all()
    assert (np.asarray(c.adv_cells) < 6).all()
    c2 = cp.init_data(with_overrides(
        CkeConfig(), nedges=8, ncells=6, nvertlevels=5, nadv=3,
        dtype="float32", device_init=True))
    np.testing.assert_array_equal(np.asarray(c.tracer), np.asarray(c2.tracer))
