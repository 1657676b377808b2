"""MPDATA kernel: jnp reference vs an independent scalar-loop numpy oracle
written directly from the staged algorithm semantics (Fortran-style 1-based
indexing with explicit offsets), then optimized variants vs the reference —
the reference driver's own protocol (advect_scalar2D…F90:48-67)."""

import numpy as np
import pytest

from cdk.core.config import MpdataConfig, with_overrides
from cdk.core.norms import rel_l1
from cdk.kernels.mpdata import problem, reference

SMALL = with_overrides(MpdataConfig(), nslices=3, nx=6, nz=9)


def oracle_advect(f, u, w, rho, rhow, adz, flux_in, bounds=None):
    """Scalar-loop MPDATA step, Fortran index conventions: f(i=-2..nx+3),
    u(i=-1..nx+3), w(i=-1..nx+2, k=1..nz), all k=1..nzm unless noted.
    If `bounds` is a pair of arrays shaped like mx/mn, the final FCT
    extrema are copied into it before stage 5b overwrites them."""
    s, fx, nzm = f.shape
    nx, nz = fx - 6, nzm + 1
    eps = 1.0e-10

    # Fortran-indexed accessors (python storage offsets: f:+2, u/w:+1, k:-1)
    F = lambda sl, i, k: f[sl, i + 2, k - 1]
    U = lambda sl, i, k: u[sl, i + 1, k - 1]
    W = lambda sl, i, k: w[sl, i + 1, k - 1]

    pp = lambda y: max(0.0, y)
    pn = lambda y: -min(0.0, y)
    andiff = lambda x1, x2, a, b: (abs(a) - a * a * b) * 0.5 * (x2 - x1)
    across = lambda x1, a1, a2: 0.03125 * a1 * a2 * x1

    f = f.copy()
    mx = np.zeros((s, nx + 2, nzm))
    mn = np.zeros((s, nx + 2, nzm))
    uuu = np.zeros((s, nx + 5, nzm))
    www = np.zeros((s, nx + 4, nz))
    flux = flux_in.copy()

    for sl in range(s):
        irho = 1.0 / rho[sl]
        iadz = 1.0 / adz[sl]
        # stage 1: extrema
        for k in range(1, nzm + 1):
            kc, kb = min(nzm, k + 1), max(1, k - 1)
            for i in range(0, nx + 2):
                vals = [F(sl, i - 1, k), F(sl, i + 1, k), F(sl, i, kb),
                        F(sl, i, kc), F(sl, i, k)]
                mx[sl, i, k - 1] = max(vals)
                mn[sl, i, k - 1] = min(vals)
        # stage 2: upwind fluxes
        for k in range(1, nzm + 1):
            kb = max(1, k - 1)
            for i in range(-1, nx + 4):
                uuu[sl, i + 1, k - 1] = (max(0.0, U(sl, i, k)) * F(sl, i - 1, k)
                                         + min(0.0, U(sl, i, k)) * F(sl, i, k))
            for i in range(-1, nx + 3):
                www[sl, i + 1, k - 1] = (max(0.0, W(sl, i, k)) * F(sl, i, kb)
                                         + min(0.0, W(sl, i, k)) * F(sl, i, k))
            flux[sl, k - 1] = sum(www[sl, i + 1, k - 1] for i in range(1, nx + 1))
        # www(:, nz) = 0 (set before stage 3 reads it)
        www[sl, :, nz - 1] = 0.0
        # stage 3: upwind update over i=-1..nx+2
        for k in range(1, nzm + 1):
            for i in range(-1, nx + 3):
                f[sl, i + 2, k - 1] -= (
                    uuu[sl, i + 2, k - 1] - uuu[sl, i + 1, k - 1]
                    + (www[sl, i + 1, k] - www[sl, i + 1, k - 1]) * iadz[k - 1]
                ) * irho[k - 1]
        # stage 4: antidiffusive velocities
        for k in range(1, nzm + 1):
            kc, kb = min(nzm, k + 1), max(1, k - 1)
            irhow_k = 1.0 / (rhow[sl, k - 1] * adz[sl, k - 1])
            dd = 2.0 / (kc - kb) / adz[sl, k - 1]
            for i in range(0, nx + 3):
                ib = i - 1
                uuu[sl, i + 1, k - 1] = andiff(
                    F(sl, ib, k), F(sl, i, k), U(sl, i, k), irho[k - 1]
                ) - across(
                    dd * (F(sl, ib, kc) + F(sl, i, kc)
                          - F(sl, ib, kb) - F(sl, i, kb)),
                    U(sl, i, k),
                    W(sl, ib, k) + W(sl, ib, kc) + W(sl, i, k) + W(sl, i, kc),
                ) * irho[k - 1]
            for i in range(0, nx + 2):
                ib, ic = i - 1, i + 1
                www[sl, i + 1, k - 1] = andiff(
                    F(sl, i, kb), F(sl, i, k), W(sl, i, k), irhow_k
                ) - across(
                    F(sl, ic, kb) + F(sl, ic, k) - F(sl, ib, kb) - F(sl, ib, k),
                    W(sl, i, k),
                    U(sl, i, kb) + U(sl, i, k) + U(sl, ic, k) + U(sl, ic, kb),
                ) * irho[k - 1]
        www[sl, :, 0] = 0.0
        # stage 5a: second extrema with updated f
        for k in range(1, nzm + 1):
            kc, kb = min(nzm, k + 1), max(1, k - 1)
            for i in range(0, nx + 2):
                vals = [F(sl, i - 1, k), F(sl, i + 1, k), F(sl, i, kb),
                        F(sl, i, kc), F(sl, i, k)]
                mx[sl, i, k - 1] = max(mx[sl, i, k - 1], max(vals))
                mn[sl, i, k - 1] = min(mn[sl, i, k - 1], min(vals))
        # snapshot the extrema bounds before they are overwritten by the
        # in/out ratios (used by the FCT-property test)
        if bounds is not None:
            bounds[0][sl] = mx[sl].copy()
            bounds[1][sl] = mn[sl].copy()
        # stage 5b: ratios
        for k in range(1, nzm + 1):
            kc = min(nzm, k + 1)
            for i in range(0, nx + 2):
                uo = pn(uuu[sl, i + 2, k - 1]) + pp(uuu[sl, i + 1, k - 1])
                wo = pn(www[sl, i + 1, kc - 1]) + pp(www[sl, i + 1, k - 1])
                mx[sl, i, k - 1] = (rho[sl, k - 1]
                                    * (mx[sl, i, k - 1] - F(sl, i, k))
                                    / (uo + iadz[k - 1] * wo + eps))
                ui = pp(uuu[sl, i + 2, k - 1]) + pn(uuu[sl, i + 1, k - 1])
                wi = pp(www[sl, i + 1, kc - 1]) + pn(www[sl, i + 1, k - 1])
                mn[sl, i, k - 1] = (rho[sl, k - 1]
                                    * (F(sl, i, k) - mn[sl, i, k - 1])
                                    / (ui + iadz[k - 1] * wi + eps))
        # stage 5c: limit fluxes
        for k in range(1, nzm + 1):
            kb = max(1, k - 1)
            for i in range(1, nx + 2):
                v = uuu[sl, i + 1, k - 1]
                uuu[sl, i + 1, k - 1] = (
                    pp(v) * min(1.0, mx[sl, i, k - 1], mn[sl, i - 1, k - 1])
                    - pn(v) * min(1.0, mx[sl, i - 1, k - 1], mn[sl, i, k - 1])
                )
            for i in range(1, nx + 1):
                v = www[sl, i + 1, k - 1]
                www[sl, i + 1, k - 1] = (
                    pp(v) * min(1.0, mx[sl, i, k - 1], mn[sl, i, kb - 1])
                    - pn(v) * min(1.0, mx[sl, i, kb - 1], mn[sl, i, k - 1])
                )
                flux[sl, k - 1] += www[sl, i + 1, k - 1]
        # stage 6: final update with clip
        for k in range(1, nzm + 1):
            for i in range(1, nx + 1):
                f[sl, i + 2, k - 1] = max(
                    0.0,
                    f[sl, i + 2, k - 1] - (
                        uuu[sl, i + 2, k - 1] - uuu[sl, i + 1, k - 1]
                        + (www[sl, i + 1, k] - www[sl, i + 1, k - 1])
                        * iadz[k - 1]
                    ) * irho[k - 1],
                )
    return f, flux


@pytest.fixture(scope="module")
def small_data():
    return problem.init_data(SMALL)


@pytest.fixture(scope="module")
def small_oracle(small_data):
    args = [np.asarray(a, np.float64) for a in (
        small_data.f, small_data.u, small_data.w, small_data.rho,
        small_data.rhow, small_data.adz, small_data.flux)]
    return oracle_advect(*args)


def test_shapes():
    d = problem.init_data(SMALL)
    nx, nz, nzm, s = SMALL.nx, SMALL.nz, SMALL.nzm, SMALL.nslices
    assert d.f.shape == (s, nx + 6, nzm)
    assert d.u.shape == (s, nx + 5, nzm)
    assert d.w.shape == (s, nx + 4, nz)
    assert d.flux.shape == (s, nz)


def test_reference_matches_oracle(small_data, small_oracle):
    f_ref, flux_ref = small_oracle
    step = reference.make_reference(SMALL)
    f_out, flux_out = step(small_data)
    assert rel_l1(np.asarray(f_out), f_ref) < 1e-14
    assert rel_l1(np.asarray(flux_out), flux_ref) < 1e-14


def test_reference_full_size_runs_and_is_positive():
    cfg = MpdataConfig()
    data = problem.init_data(cfg)
    f_out, flux_out = reference.make_reference(cfg)(data)
    f_out = np.asarray(f_out)
    # positive-definite advection: interior f stays non-negative (:630-637)
    assert (f_out[:, 3:cfg.nx + 3] >= 0.0).all()
    assert np.isfinite(f_out).all() and np.isfinite(np.asarray(flux_out)).all()


def test_flux_nz_passthrough(small_data):
    """The reference never writes flux(:,nz) (advect…F90:540-547)."""
    step = reference.make_reference(SMALL)
    _, flux_out = step(small_data)
    np.testing.assert_array_equal(
        np.asarray(flux_out)[:, -1], np.asarray(small_data.flux)[:, -1]
    )


def test_fct_limiter_non_oscillatory():
    """The non-oscillatory limiter's contract (advect…F90:588-628): the
    corrected interior solution stays within the local extrema bounds
    mx/mn accumulated from the input and upwind fields."""
    cfg = with_overrides(MpdataConfig(), nslices=4, nx=10, nz=12, seed=7)
    data = problem.init_data(cfg)
    args = [np.asarray(a, np.float64) for a in (
        data.f, data.u, data.w, data.rho, data.rhow, data.adz, data.flux)]
    s_, nx = cfg.nslices, cfg.nx
    mx_snap = np.zeros((s_, nx + 2, cfg.nzm))
    mn_snap = np.zeros((s_, nx + 2, cfg.nzm))
    f_ref, _ = oracle_advect(*args, bounds=(mx_snap, mn_snap))
    # interior i=1..nx maps to mx/mn index i and f python ix=i+2
    f_int = f_ref[:, 3:nx + 3]
    mx_int = mx_snap[:, 1:nx + 1]
    mn_int = mn_snap[:, 1:nx + 1]
    eps = 1e-9 * np.abs(mx_int).max()
    assert (f_int <= mx_int + eps).all(), "limiter exceeded upper bound"
    assert (f_int >= np.minimum(mn_int, 0.0) - eps).all(), \
        "limiter exceeded lower bound"
    # and the jnp reference's output obeys the same bounds
    f_jnp, _ = reference.make_reference(cfg)(data)
    f_jnp_int = np.asarray(f_jnp)[:, 3:nx + 3]
    assert (f_jnp_int <= mx_int + eps).all()
    assert (f_jnp_int >= np.minimum(mn_int, 0.0) - eps).all()


def test_long_integration_stable_uniform_advection():
    """Long-run stability in a physical regime: uniform advection at
    Courant 0.2 with unit density stays bounded and positive for 200 steps
    (the monotone scheme preserves the initial max). The miniapp's random
    static u/w/rho init is NOT a stable integration regime — persistent
    convergence zones grow f exponentially regardless of solver — which is
    why the reference only ever runs one step."""
    import dataclasses

    import jax.numpy as jnp

    cfg = with_overrides(MpdataConfig(), nslices=4, nx=12, nz=10)
    data = problem.init_data(cfg)
    d = dataclasses.replace(
        data,
        u=jnp.full_like(data.u, 0.2),
        w=jnp.zeros_like(data.w),
        rho=jnp.ones_like(data.rho),
        rhow=jnp.ones_like(data.rhow),
        adz=jnp.ones_like(data.adz),
    )
    step = reference.make_reference(cfg)
    m0 = float(np.asarray(d.f).max())
    for _ in range(200):
        f, flux = step(d)
        d = dataclasses.replace(d, f=f, flux=flux)
    fa = np.asarray(d.f)
    assert np.isfinite(fa).all()
    assert fa.min() >= 0.0
    assert fa.max() <= m0 + 1e-12




# ---- the CUDA kernel (kernels/mpdata/hopper.py) ---------------------------
# A CUDA kernel has no interpret mode.  Its per-point arithmetic is
# cuda/mpdata_stages.h; the serial host driver of those same stage
# functions (native.mpdata_stages_loop) is checked here against chained
# reference steps, and the kernel itself against the reference on the card
# (the `gpu` tests).

# (nslices, nx, nz, steps): the production column shape (nz=58, not a
# power of two), tiny and odd extents, and multi-step runs
HOPPER_GRID = [
    (3, 32, 58, 1),
    (2, 32, 58, 4),
    (2, 8, 5, 3),
    (1, 4, 3, 2),
    (2, 5, 17, 5),
    (4, 16, 58, 2),
    (3, 1, 4, 2),
]


def _chained_reference(data, n):
    import jax

    step = jax.jit(reference.advect_scalar2d)
    f, flux = data.f, data.flux
    for _ in range(n):
        f, flux = step(f, data.u, data.w, data.rho, data.rhow, data.adz,
                       flux)
    return np.asarray(f), np.asarray(flux)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("geometry", HOPPER_GRID)
def test_hopper_stages_match_reference(geometry, dtype):
    from cdk.core import native

    if not native.available():
        pytest.skip("native host library unavailable")
    ns, nx, nz, n = geometry
    cfg = with_overrides(MpdataConfig(), nslices=ns, nx=nx, nz=nz,
                         dtype=dtype)
    data = problem.init_data(cfg)
    f_r, flux_r = _chained_reference(data, n)
    f_k, flux_k = native.mpdata_stages_loop(data, n)
    assert f_k.dtype == np.dtype(dtype)
    tol = 1e-13 if dtype == "float64" else 1e-6
    assert rel_l1(f_k, f_r) < tol
    assert rel_l1(flux_k, flux_r) < 10 * tol


def test_hopper_stages_zero_steps_is_identity():
    from cdk.core import native

    if not native.available():
        pytest.skip("native host library unavailable")
    data = problem.init_data(SMALL)
    f_k, flux_k = native.mpdata_stages_loop(data, 0)
    np.testing.assert_array_equal(f_k, np.asarray(data.f))
    np.testing.assert_array_equal(flux_k, np.asarray(data.flux))


def test_hopper_smem_fits_production_slice():
    """One production slice (nx=32, nzm=57) fits a block's shared memory in
    f32 and f64; a much wider slice is rejected up front."""
    from cdk.kernels.mpdata import hopper

    assert hopper.smem_bytes(32, 57, 4) < hopper.SMEM_LIMIT
    assert hopper.smem_bytes(32, 57, 8) < hopper.SMEM_LIMIT
    assert hopper.smem_bytes(400, 57, 8) > hopper.SMEM_LIMIT


def test_hopper_is_typed_skip_off_gpu():
    """Off the GPU the variant raises UnsupportedConfigError (the driver's
    typed skip) — it never falls back to an interpreter or the reference."""
    from cdk.core.registry import UnsupportedConfigError
    from cdk.kernels.mpdata import hopper

    with pytest.raises(UnsupportedConfigError, match="needs a GPU"):
        hopper.make_hopper_fused(SMALL)


@pytest.mark.parametrize("cfg_over,match", [
    ({"dtype": "bfloat16"}, "dtype"),
    ({"nx": 400, "nz": 58, "dtype": "float64"}, "shared memory"),
])
def test_hopper_rejects_unsupported_configs_on_gpu(monkeypatch, cfg_over,
                                                   match):
    """On a GPU the dtype and the shared-memory budget still gate the
    kernel, as typed skips."""
    import jax

    from cdk.core.registry import UnsupportedConfigError
    from cdk.kernels.mpdata import hopper

    class FakeGpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    with pytest.raises(UnsupportedConfigError, match=match):
        hopper.check_supported(with_overrides(SMALL, **cfg_over))


def test_hopper_build_command_and_cache_key(tmp_path):
    """nvcc targets Hopper's own instruction set (sm_90a) and builds the
    sources in the repository; the output path changes with the sources."""
    from cdk.kernels.mpdata import hopper

    cmd = hopper.nvcc_command(tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("mpdata_loop.cu")
    path = hopper.library_path()
    assert path.parent.name == "cuda" and path.parent.parent.name == "build"
    assert path == hopper.library_path()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("geometry", HOPPER_GRID)
def test_hopper_kernel_matches_reference_on_gpu(gpu_device, geometry, dtype):
    from cdk.kernels.mpdata import hopper

    ns, nx, nz, n = geometry
    cfg = with_overrides(MpdataConfig(), nslices=ns, nx=nx, nz=nz,
                         dtype=dtype)
    data = problem.init_data(cfg)
    f_r, flux_r = _chained_reference(data, n)
    made = hopper.make_hopper_fused(cfg)
    f_k, flux_k = made["loop"](data, n)
    tol = 1e-13 if dtype == "float64" else 1e-6
    assert rel_l1(np.asarray(f_k), f_r) < tol
    assert rel_l1(np.asarray(flux_k), flux_r) < 10 * tol
