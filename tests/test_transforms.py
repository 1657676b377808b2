"""Functional-transform coverage: the kernels are pure jnp programs, so
they differentiate and batch for free — a capability layer the Fortran
reference has no analog for (useful for adjoint/sensitivity studies of the
advection operator)."""

import jax
import jax.numpy as jnp
import numpy as np

from cdk.core.config import MpdataConfig, CkeConfig, with_overrides
from cdk.kernels.cke import problem as cke_problem, reference as cke_ref
from cdk.kernels.mpdata import problem, reference

CFG = with_overrides(MpdataConfig(), nslices=2, nx=6, nz=8)


def test_mpdata_grad_runs_and_is_finite():
    data = problem.init_data(CFG)

    def loss(f):
        f_out, flux = reference.advect_scalar2d(
            f, data.u, data.w, data.rho, data.rhow, data.adz, data.flux
        )
        return jnp.sum(f_out**2)

    g = jax.jit(jax.grad(loss))(data.f)
    assert g.shape == data.f.shape
    assert np.isfinite(np.asarray(g)).all()
    # upstream of the clipped/untouched halo, gradient must be nonzero
    assert float(jnp.abs(g).max()) > 0


def test_cke_jvp_linear_in_tracer():
    """The flux is linear in tracerCur: jvp == primal difference exactly."""
    cfg = with_overrides(CkeConfig(), nedges=16, ncells=8, nvertlevels=5)
    d = cke_problem.init_data(cfg)
    c3 = cfg.np_dtype(cfg.coef3rdorder)

    def f(tracer):
        return cke_ref.edge_flux(
            d.adv_cells, d.adv_coefs, d.adv_coefs3, tracer, d.cell_mask,
            d.ntf, d.adv_mask, c3,
        )

    t = d.tracer
    dt = jnp.ones_like(t)
    _, jvp = jax.jvp(f, (t,), (dt,))
    direct = f(t + dt) - f(t)
    np.testing.assert_allclose(np.asarray(jvp), np.asarray(direct),
                               rtol=1e-9, atol=1e-9)


def test_mpdata_vmap_over_problems():
    """vmap over a leading ensemble axis matches per-member loops."""
    data = problem.init_data(CFG)
    fs = jnp.stack([data.f, data.f * 0.5])

    def step_f(f):
        f_out, _ = reference.advect_scalar2d(
            f, data.u, data.w, data.rho, data.rhow, data.adz, data.flux
        )
        return f_out

    batched = jax.vmap(step_f)(fs)
    for i, fi in enumerate([data.f, data.f * 0.5]):
        np.testing.assert_allclose(
            np.asarray(batched[i]), np.asarray(step_f(fi)), rtol=1e-12
        )


def test_namelist_roundtrip_shipped_values():
    from cdk.core.config import cke_config_from_namelist

    cfg = cke_config_from_namelist("configs/nested.nml")
    assert (cfg.niters, cfg.nedges, cfg.ncells, cfg.nvertlevels, cfg.nadv) \
        == (100, 25600, 2800, 100, 10)


def test_bfloat16_dtype_supported():
    cfg = with_overrides(MpdataConfig(), nslices=2, nx=6, nz=8,
                         dtype="bfloat16")
    d = problem.init_data(cfg)
    assert d.f.dtype == jnp.bfloat16
    f_out, flux = reference.make_reference(cfg)(d)
    assert f_out.dtype == jnp.bfloat16
    assert np.isfinite(np.asarray(f_out, np.float32)).all()


def test_dss2d_is_linear_and_differentiable():
    """The torus-DSS biharmonic is linear in qtens (fixed geometry): jvp
    equals the primal difference exactly, and grad is finite/nonzero —
    the adjoint-capability layer extends to the DSS-coupled families."""
    from cdk.core.config import BiharmonicConfig
    from cdk.kernels.biharmonic import problem as bi_problem
    from cdk.kernels.biharmonic.dss2d import (
        biharmonic_wk_dss2d_reference,
        torus_shape,
    )

    cfg = with_overrides(BiharmonicConfig(), nelemd=6, nlev=3, qsize=2,
                         dtype="float64")
    ex, ey = torus_shape(cfg.nelemd)
    data = bi_problem.init_data(cfg)
    rr = cfg.np_dtype(cfg.rrearth)

    def f(q):
        return biharmonic_wk_dss2d_reference(
            q, data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr,
            ex, ey)

    rng = np.random.default_rng(2)
    dq = jnp.asarray(rng.standard_normal(data.qtens.shape))
    _, jvp_out = jax.jvp(f, (data.qtens,), (dq,))
    np.testing.assert_allclose(np.asarray(jvp_out), np.asarray(f(dq)),
                               rtol=1e-12, atol=1e-18)
    g = jax.jit(jax.grad(lambda q: jnp.sum(f(q) ** 2)))(data.qtens)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0
