"""Native (C++) host layer: the JAX-free second oracle for every kernel —
the role the reference's in-run CPU references and yakl_check play
(SURVEY §4). Skipped when no C++ toolchain is present."""

import numpy as np
import pytest

from cdk.core import native
from cdk.core.config import (
    BiharmonicConfig,
    CkeConfig,
    MpdataConfig,
    with_overrides,
)
from cdk.core.frng import Lcg
from cdk.core.norms import pointwise_check, rel_l1, rel_l2

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_lcg_stream_matches_python():
    np.testing.assert_array_equal(native.lcg_fill(1000), Lcg().draw(1000))


def test_uniform_fill_deterministic():
    a = native.uniform_fill(100, seed=42)
    b = native.uniform_fill(100, seed=42)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all() and (a < 1).all() and len(np.unique(a)) > 90


def test_pad_lanes():
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    p = native.pad_lanes(a, 8)
    assert p.shape == (3, 8)
    np.testing.assert_array_equal(p[:, :4], a)
    assert (p[:, 4:] == 0).all()


def test_biharmonic_cpp_oracle():
    from cdk.kernels.biharmonic import problem, reference

    cfg = with_overrides(BiharmonicConfig(), nelemd=4, nlev=6, qsize=3)
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    cpp = native.biharmonic_ref(data, cfg.rrearth)
    assert rel_l2(cpp, ref) < 1e-14


def test_cke_cpp_oracle():
    from cdk.kernels.cke import problem, reference

    cfg = with_overrides(CkeConfig(), nedges=64, ncells=20, nvertlevels=9)
    data = problem.init_data(cfg)
    ref = np.asarray(reference.make_reference(cfg)(data))
    cpp = native.cke_ref(data, cfg.coef3rdorder)
    assert pointwise_check(cpp, ref, cfg.errtol)[0] == 0


def test_mpdata_cpp_oracle():
    from cdk.kernels.mpdata import problem, reference

    cfg = with_overrides(MpdataConfig(), nslices=4, nx=8, nz=10)
    data = problem.init_data(cfg)
    f_ref, flux_ref = reference.make_reference(cfg)(data)
    f_cpp, flux_cpp = native.mpdata_ref(data)
    assert rel_l1(f_cpp, np.asarray(f_ref)) < 1e-14
    assert rel_l1(flux_cpp, np.asarray(flux_ref)) < 1e-14


def test_native_bench_driver_runs():
    """The standalone C++ driver (Fortran-program analog) builds and runs."""
    import subprocess
    from pathlib import Path

    cpp = Path(__file__).resolve().parents[1] / "cpp"
    subprocess.run(["make", "-C", str(cpp), "bench"], check=True,
                   capture_output=True)
    r = subprocess.run([str(cpp / "cdk_bench"), "all", "2"],
                       capture_output=True, text=True, check=True)
    assert "biharmonic CPU(C++) Timing" in r.stdout
    assert "cke" in r.stdout and "mpdata" in r.stdout


def test_cpp_biharmonic_dss_oracle_matches_jnp():
    from cdk.core.config import BiharmonicConfig, with_overrides
    from cdk.kernels.biharmonic import dss, problem

    cfg = with_overrides(BiharmonicConfig(), nelemd=5, nlev=3, qsize=2)
    data = problem.init_data(cfg)
    want = np.asarray(dss.make_reference(cfg)(data))
    got = native.biharmonic_dss_ref(data, cfg.rrearth)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_cpp_biharmonic_dss2d_oracle_matches_jnp():
    from cdk.core.config import BiharmonicConfig, with_overrides
    from cdk.kernels.biharmonic import dss2d, problem

    cfg = with_overrides(BiharmonicConfig(), nelemd=12, nlev=3, qsize=2)
    data = problem.init_data(cfg)
    ex, ey = dss2d.torus_shape(cfg.nelemd)
    want = np.asarray(dss2d.make_reference(cfg)(data))
    got = native.biharmonic_dss2d_ref(data, cfg.rrearth, ex, ey)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
