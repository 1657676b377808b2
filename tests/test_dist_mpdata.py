"""Distributed MPDATA: masked-global core parity (bitwise on f) and
N-device halo-exchange decomposition vs the single-device reference —
SURVEY §7 gate 6 (N-device run matches 1-device at f64)."""

import jax
import numpy as np
import pytest

from cdk.core.config import MpdataConfig, with_overrides
from cdk.core.norms import rel_l1
from cdk.dist import mesh as meshmod
from cdk.dist import mpdata as dist_mpdata
from cdk.kernels.mpdata import problem, reference

CFG = MpdataConfig()  # nx=32 across 8 devices -> chunk ~5 columns


def test_masked_global_matches_reference():
    """Same arithmetic per point; separately-jitted XLA programs may differ
    by compiler FMA/fusion choices (observed ≤1 ULP), so compare at tight
    tolerance rather than bitwise."""
    data = problem.init_data(CFG)
    f_ref, flux_ref = reference.make_reference(CFG)(data)
    f_m, flux_m = jax.jit(dist_mpdata.advect_masked_global)(data)
    assert rel_l1(np.asarray(f_m), np.asarray(f_ref)) < 1e-14
    assert rel_l1(np.asarray(flux_m), np.asarray(flux_ref)) < 1e-14


@pytest.mark.parametrize("ndev", [2, 8])
def test_decomposed_matches_global(ndev):
    data = problem.init_data(CFG)
    f_ref, flux_ref = reference.make_reference(CFG)(data)
    m = meshmod.make_mesh(ndev)
    shard_inputs, step, gather_f = dist_mpdata.make_dist_step(CFG, m)
    f_s, u_s, w_s, aux = shard_inputs(data)
    f_out, flux_out = step(f_s, u_s, w_s, aux)
    f_g = gather_f(f_out)
    assert rel_l1(f_g, np.asarray(f_ref)) < 1e-14
    # flux partial sums + psum reassociate the reduction: tolerance check
    assert rel_l1(np.asarray(flux_out), np.asarray(flux_ref)) < 1e-13


def test_decomposed_multistep():
    """Multi-step advection: exchange-step-exchange chains stay exact."""
    data = problem.init_data(CFG)
    ref_step = reference.make_reference(CFG)
    m = meshmod.make_mesh(8)
    shard_inputs, step, gather_f = dist_mpdata.make_dist_step(CFG, m)
    f_s, u_s, w_s, aux = shard_inputs(data)

    f_ref, flux_ref = data.f, data.flux
    d = data
    for _ in range(3):
        f_ref, flux_ref = ref_step(d)
        d = problem.MpdataData(f_ref, d.u, d.w, d.rho, d.rhow, d.adz, flux_ref)
        f_s, flux_s = step(f_s, u_s, w_s, aux)
    assert rel_l1(gather_f(f_s), np.asarray(f_ref)) < 1e-13


@pytest.mark.parametrize("ndev", [2, 8])
def test_overlap_step_matches_plain(ndev):
    """The overlapped (interior-first + boundary-strip) step produces the
    same owned values as the serialized exchange->compute step."""
    cfg = with_overrides(MpdataConfig(), nx=64)  # chunk >= strip width
    data = problem.init_data(cfg)
    f_ref, flux_ref = reference.make_reference(cfg)(data)
    m = meshmod.make_mesh(ndev)
    shard_inputs, step_plain, gather_f = dist_mpdata.make_dist_step(cfg, m)
    step_ov = dist_mpdata.make_dist_step_overlap(cfg, m)
    f_s, u_s, w_s, aux = shard_inputs(data)
    f_a, flux_a = step_plain(f_s, u_s, w_s, aux)
    f_b, flux_b = step_ov(f_s, u_s, w_s, aux)
    assert rel_l1(gather_f(f_b), gather_f(f_a)) < 1e-15
    assert rel_l1(np.asarray(flux_b), np.asarray(flux_a)) < 1e-14
    assert rel_l1(gather_f(f_b), np.asarray(f_ref)) < 1e-14


def test_weak_scaling_harness_runs():
    from cdk.harness import scaling

    pts = scaling.weak_scaling_mpdata(
        device_counts=(1, 2), nx_per_device=32, nslices=4, nz=10,
        n_steps=2, quiet=True,
    )
    assert len(pts) == 2 and pts[0].efficiency == 1.0
    assert all(p.grid_points_per_s > 0 for p in pts)


def test_overlap_multistep_matches_reference():
    cfg = with_overrides(MpdataConfig(), nx=64, nslices=4, nz=12)
    data = problem.init_data(cfg)
    ref_step = reference.make_reference(cfg)
    m = meshmod.make_mesh(4)
    shard_inputs, _, gather_f = dist_mpdata.make_dist_step(cfg, m)
    step_ov = dist_mpdata.make_dist_step_overlap(cfg, m)
    f_s, u_s, w_s, aux = shard_inputs(data)
    d = data
    f_ref = None
    for _ in range(4):
        f_ref, flux_ref = ref_step(d)
        d = problem.MpdataData(f_ref, d.u, d.w, d.rho, d.rhow, d.adz,
                               flux_ref)
        f_s, _ = step_ov(f_s, u_s, w_s, aux)
    assert rel_l1(gather_f(f_s), np.asarray(f_ref)) < 1e-13


@pytest.mark.parametrize("overlap", [False, True])
def test_dist_loop_scan_matches_chained(overlap):
    """One-jit scan over the shard_mapped step == per-dispatch chaining."""
    cfg = with_overrides(MpdataConfig(), nx=64, nslices=4, nz=12)
    data = problem.init_data(cfg)
    m = meshmod.make_mesh(4)
    shard_inputs, step, gather_f = dist_mpdata.make_dist_step(cfg, m)
    loop = dist_mpdata.make_dist_loop(cfg, m, overlap=overlap)
    f_s, u_s, w_s, aux = shard_inputs(data)
    f_l, flux_l = loop(f_s, u_s, w_s, aux, 3)
    f_c, flux_c = f_s, aux[3]
    rho, rhow, adz, _ = aux
    for _ in range(3):
        f_c, flux_c = step(f_c, u_s, w_s, (rho, rhow, adz, flux_c))
    assert rel_l1(gather_f(f_l), gather_f(f_c)) < 1e-15
    assert rel_l1(np.asarray(flux_l), np.asarray(flux_c)) < 1e-15


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("overlap", [False, True])
def test_dist_step_matches_global_masked_core(overlap, ndev):
    """The plain and overlapped dist steps produce the values of the
    single-device masked-global core on the whole grid."""
    data = problem.init_data(CFG)
    m = meshmod.make_mesh(ndev)
    shard_inputs, step, gather_f = dist_mpdata.make_dist_step(CFG, m)
    if overlap:
        step = dist_mpdata.make_dist_step_overlap(CFG, m)
    f_d, flux_d = step(*shard_inputs(data))
    f_g, flux_g = dist_mpdata.advect_masked_global(data)
    assert rel_l1(gather_f(f_d), np.asarray(f_g)) < 1e-14
    assert rel_l1(np.asarray(flux_d), np.asarray(flux_g)) < 1e-14


@pytest.mark.parametrize("ndev", [2, 4])
def test_dist_loop_matches_reference(ndev):
    """The hoisted dist loop (u/w halos exchanged once per run, f every
    step) vs chained reference steps.  Masked vs positional forms
    reassociate ~1 ulp/step, hence the 1e-12 gate instead of bit-exact."""
    import dataclasses

    cfg = with_overrides(MpdataConfig(), nx=64, nslices=4, nz=12)
    data = problem.init_data(cfg)
    m = meshmod.make_mesh(ndev)
    shard_inputs, _, gather_f = dist_mpdata.make_dist_step(cfg, m)
    loop = dist_mpdata.make_dist_loop(cfg, m)
    f_s, u_s, w_s, aux = shard_inputs(data)
    n = 8
    f_l, flux_l = loop(f_s, u_s, w_s, aux, n)

    ref_step = reference.make_reference(cfg)
    d = data
    for _ in range(n):
        f_r, flux_r = ref_step(d)
        d = dataclasses.replace(d, f=f_r, flux=flux_r)
    assert rel_l1(gather_f(f_l), np.asarray(f_r)) < 1e-12
    assert rel_l1(np.asarray(flux_l), np.asarray(flux_r)) < 1e-12


def test_dist_step_and_loop_reject_chunk_below_halo():
    """Over-decomposed meshes must raise, not silently truncate halos
    (_exchange's x[:, -h:] would just yield fewer columns and misalign
    every global index — reproduced as rel-L1 ~0.9 garbage pre-guard)."""
    cfg = with_overrides(MpdataConfig(), nx=10, nslices=4, nz=12)
    m = meshmod.make_mesh(8)  # chunk = ceil(16/8) = 2 < HALO = 3
    with pytest.raises(ValueError):
        dist_mpdata.make_dist_step(cfg, m)
    with pytest.raises(ValueError):
        dist_mpdata.make_dist_loop(cfg, m)


def test_dist_overlap_rejects_narrow_chunk():
    """The overlap form needs depth+3 local columns beside each halo."""
    cfg = with_overrides(MpdataConfig(), nx=10, nslices=4, nz=12)
    m = meshmod.make_mesh(4)  # chunk = ceil(16/4) = 4 < 6
    with pytest.raises(ValueError):
        dist_mpdata.make_dist_step_overlap(cfg, m)
    with pytest.raises(ValueError):
        dist_mpdata.make_dist_loop(cfg, m, overlap=True)


@pytest.mark.parametrize("ndev", [2, 8])
def test_dist_slices_matches_single_chip_bitwise(ndev):
    """Slice-batch (data-parallel) dist loop == the single-device loop:
    every shard runs the same loop on its own slices, with no exchange
    and no collective (the reference's own scaling axis, mmf-mpdata
    README per-node slice batch).  Tolerance, not bitwise: the per-shard
    batch shape differs and the CPU backend contracts FMAs
    shape-dependently."""
    _slices_vs_single_device(ndev, 48)


def test_dist_slices_pads_uneven_slice_count():
    """45 slices on 8 devices: the slice axis is padded to 48 with a
    benign state that the gathers drop."""
    _slices_vs_single_device(8, 45)


def _slices_vs_single_device(ndev, nslices):
    from cdk.core.registry import _materialize, get
    from cdk.harness.specs import get_spec

    cfg = with_overrides(MpdataConfig(), nslices=nslices, nx=16, nz=12,
                         dtype="float32")
    data = problem.init_data(cfg)
    m = meshmod.make_mesh(ndev)
    si, loop, (gather_f, gather_flux) = dist_mpdata.make_dist_loop_slices(
        cfg, m)
    f_s, u_s, w_s, aux = si(data)
    assert f_s.shape[0] == -(-nslices // ndev) * ndev
    f_d, flux_d = loop(f_s, u_s, w_s, aux, 3)

    step2, aux_r, _ = _materialize(get("mpdata", "reference_jnp"), cfg, data)
    f_r, flux_r = get_spec("mpdata").scan_runner(step2, aux_r, 3)(data)
    assert gather_f(f_d).shape == f_r.shape
    assert rel_l1(gather_f(f_d), np.asarray(f_r)) < 1e-5
    assert rel_l1(gather_flux(flux_d), np.asarray(flux_r)) < 1e-5


def test_single_device_loop_off_gpu_is_reference_scan():
    """Off the GPU the slice-batch form runs the XLA reference scan (the
    CUDA kernel applies only on a GPU), never an interpreted kernel."""
    from cdk.kernels.mpdata import hopper

    cfg = with_overrides(MpdataConfig(), nslices=2, nx=6, nz=8)
    loop = dist_mpdata.single_device_loop(cfg)
    assert loop is not hopper.mpdata_loop
    data = problem.init_data(cfg)
    f, flux = loop(data, 2)
    d = data
    ref_step = reference.make_reference(cfg)
    for _ in range(2):
        f_r, flux_r = ref_step(d)
        import dataclasses

        d = dataclasses.replace(d, f=f_r, flux=flux_r)
    assert rel_l1(np.asarray(f), np.asarray(f_r)) < 1e-14


def test_dist_loop_unroll_matches_unrolled_1():
    """The promoted unroll=2 hoisted loop == unroll=1 bitwise on a
    multi-device mesh: scan unrolling duplicates the body without
    changing its arithmetic or exchange pattern."""
    cfg = with_overrides(MpdataConfig(), nslices=8, nx=32, nz=12,
                         dtype="float32")
    data = problem.init_data(cfg)
    m = meshmod.make_mesh(4)
    si, _, gather_f = dist_mpdata.make_dist_step(cfg, m)
    args = si(data)
    loop1 = dist_mpdata.make_dist_loop(cfg, m, unroll=1)
    loop2 = dist_mpdata.make_dist_loop(cfg, m)  # default unroll=2
    f1, fx1 = loop1(*args, 5)   # odd n: exercises the unroll remainder
    f2, fx2 = loop2(*args, 5)
    np.testing.assert_array_equal(gather_f(f1), gather_f(f2))
    np.testing.assert_array_equal(np.asarray(fx1), np.asarray(fx2))


def test_single_device_loop_on_gpu_is_the_cuda_kernel(monkeypatch):
    """On a GPU the slice-batch form runs the CUDA kernel, and a config
    the kernel cannot run is an error, not a quiet fall back to XLA."""
    from cdk.core.registry import UnsupportedConfigError
    from cdk.kernels.mpdata import hopper

    class FakeGpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    cfg = with_overrides(MpdataConfig(), nslices=2, dtype="float32")
    assert dist_mpdata.single_device_loop(cfg) is hopper.mpdata_loop
    with pytest.raises(UnsupportedConfigError):
        dist_mpdata.single_device_loop(with_overrides(cfg, dtype="bfloat16"))
