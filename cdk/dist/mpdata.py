"""Domain-decomposed MPDATA: x-column decomposition with halo exchange.

The reference defers all horizontal decomposition ("plan was to add some MPI
parallelism later", nested_loops/README.md:29-31); its MPDATA miniapp scales
only the per-node slice batch.  This module supplies the deferred
capability (SURVEY §5 "long-context analog"):

  - the global x axis is split into contiguous owned chunks over a 1-D
    `Mesh`;
  - each step, every shard exchanges H halo columns with its neighbors via
    `lax.ppermute` (a collective permute, NVLink between cards) inside
    `shard_map`;
  - each shard then runs the *masked-global* MPDATA core on its extended
    (owned + 2H) columns and keeps the owned slice.

Masked-global core: the single-device reference (reference.advect_scalar2d)
realizes the Fortran loops' x-range restrictions *positionally*
(concatenation at fixed offsets).  That formulation can't be cut at an
arbitrary x: a shard's local array edge would get boundary treatment that
belongs only to the true domain edge.  `advect_scalar2d_masked` instead
computes every stage with uniform stencils over ALL columns (collocated
layout: f, u, w all on one x grid) and applies each Fortran range
restriction as a `where` on the column's GLOBAL Fortran index — so a shard
holding any window of global columns computes exactly the global values for
its owned region, provided H ≥ 3 (the f→f_out stencil dependency depth:
f_out(i) reads f(i±3)); HALO below is exactly 3.

Domain flux sums (flux(k) = Σ_{i=1..nx}, advect…F90:540-547,613-628) become
owned-column partial sums + `lax.psum`.

Collocated layout: column ix holds Fortran index gi = ix − 2 of f; u(gi)
and w(gi) are stored at the same ix (u valid gi ∈ [-1, nx+3] → ix ≥ 1,
w valid gi ∈ [-1, nx+2]; unused slots are zero)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cdk.kernels.mpdata.problem import MpdataData
from cdk.kernels.mpdata.reference import (
    EPS,
    _across,
    _andiff,
    _kb,
    _kc,
    _min3,
    _pn,
    _pp,
)

# Exchange halo width. 3 = the exact f→f_out stencil dependency depth
# (f_out(i) reads f(i±3)); verified exact at f64 on the 2/8-device mesh.
# A wider halo costs extra computed columns per shard and exchange bytes
# for nothing the tests can detect.
HALO = 3


def _xl(a):
    """Left-neighbor read along x: out[ix] = a[ix-1] (clamped at 0)."""
    return jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)


def _xr(a):
    """Right-neighbor read along x: out[ix] = a[ix+1] (clamped at end)."""
    return jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)


def advect_scalar2d_masked(f, u, w, rho, rhow, adz, gi, owned, nx):
    """Masked-global MPDATA step on collocated (S, X, Z) arrays.

    gi:    (X,) or (X,1) int32 — global Fortran i of each column
    owned: (X,) or (X,1) bool — columns whose outputs this shard owns (flux
           sums count only owned columns; f is returned for all columns but
           only owned ones are meaningful)
    Returns (f_out (S,X,nzm), flux_body (S,nzm) partial sum over owned).
    """
    s, X, nzm = f.shape
    gim = jnp.reshape(gi, (1, X, 1))
    ownedm = jnp.reshape(owned, (1, X, 1))

    def m(lo, hi):
        return (gim >= lo) & (gim <= hi)

    irho = (1.0 / rho)[:, None, :]
    iadz = (1.0 / adz)[:, None, :]
    k1 = jnp.arange(nzm)
    kspan = (
        jnp.minimum(nzm - 1, k1 + 1) - jnp.maximum(0, k1 - 1)
    ).astype(f.dtype)
    dd = 2.0 / jnp.reshape(kspan, (1, 1, nzm)) / adz[:, None, :]
    irhow = (1.0 / (rhow[..., :nzm] * adz))[:, None, :]
    w_s = w[..., :nzm]
    one = jnp.asarray(1.0, f.dtype)
    fmask = m(1, nx) & ownedm

    # stage 1: extrema (valid gi in [0, nx+1])
    lf, rf = _xl(f), _xr(f)
    mx = jnp.maximum(jnp.maximum(jnp.maximum(lf, rf),
                                 jnp.maximum(_kb(f), _kc(f))), f)
    mn = jnp.minimum(jnp.minimum(jnp.minimum(lf, rf),
                                 jnp.minimum(_kb(f), _kc(f))), f)

    # stage 2: upwind fluxes (uuu valid gi in [-1,nx+3], www in [-1,nx+2])
    uuu = _pp(u) * lf - _pn(u) * f
    www_k = _pp(w_s) * _kb(f) - _pn(w_s) * f
    flux = jnp.sum(jnp.where(fmask, www_k, 0.0), axis=1)
    www_kp1 = jnp.concatenate(  # www(k+1) with www(:,nz)=0 top boundary
        [www_k[..., 1:], jnp.zeros_like(www_k[..., :1])], axis=-1
    )

    # stage 3: upwind update (gi in [-1, nx+2])
    upd = (_xr(uuu) - uuu + (www_kp1 - www_k) * iadz) * irho
    f1 = jnp.where(m(-1, nx + 2), f - upd, f)

    # stage 4: antidiffusive velocities
    lf1, rf1 = _xl(f1), _xr(f1)
    lw = _xl(w_s)
    uuu2_b = _andiff(lf1, f1, u, irho) - _across(
        dd * (_kc(lf1) + _kc(f1) - _kb(lf1) - _kb(f1)),
        u,
        lw + _kc(lw) + w_s + _kc(w_s),
    ) * irho
    uuu2 = jnp.where(m(0, nx + 2), uuu2_b, uuu)
    ru = _xr(u)
    www2_b = _andiff(_kb(f1), f1, w_s, irhow) - _across(
        _kb(rf1) + rf1 - _kb(lf1) - lf1,
        w_s,
        _kb(u) + u + ru + _kb(ru),
    ) * irho
    www2_k = jnp.where(m(0, nx + 1), www2_b, www_k)
    # bottom boundary www(:,:,1)=0 (:586)
    www2_k = jnp.concatenate(
        [jnp.zeros_like(www2_k[..., :1]), www2_k[..., 1:]], axis=-1
    )

    # stage 5a: second extrema with updated f
    mx = jnp.maximum(jnp.maximum(jnp.maximum(lf1, rf1),
                                 jnp.maximum(_kb(f1), _kc(f1))),
                     jnp.maximum(f1, mx))
    mn = jnp.minimum(jnp.minimum(jnp.minimum(lf1, rf1),
                                 jnp.minimum(_kb(f1), _kc(f1))),
                     jnp.minimum(f1, mn))

    # stage 5b: in/out flux ratios (valid gi in [0, nx+1])
    ruuu2 = _xr(uuu2)
    wkc = _kc(www2_k)
    rho_b = rho[:, None, :]
    mxr = rho_b * (mx - f1) / (
        _pn(ruuu2) + _pp(uuu2) + iadz * (_pn(wkc) + _pp(www2_k)) + EPS
    )
    mnr = rho_b * (f1 - mn) / (
        _pp(ruuu2) + _pn(uuu2) + iadz * (_pp(wkc) + _pn(www2_k)) + EPS
    )

    # stage 5c: limit fluxes (uuu gi in [1, nx+1], www gi in [1, nx])
    lmxr, lmnr = _xl(mxr), _xl(mnr)
    uuu3 = jnp.where(
        m(1, nx + 1),
        _pp(uuu2) * _min3(one, mxr, lmnr) - _pn(uuu2) * _min3(one, lmxr, mnr),
        uuu2,
    )
    www3_b = (_pp(www2_k) * _min3(one, mxr, _kb(mnr))
              - _pn(www2_k) * _min3(one, _kb(mxr), mnr))
    www3_k = jnp.where(m(1, nx), www3_b, www2_k)
    flux = flux + jnp.sum(jnp.where(fmask, www3_b, 0.0), axis=1)

    # stage 6: final update with positive clip (gi in [1, nx])
    www3_kp1 = jnp.concatenate(
        [www3_k[..., 1:], jnp.zeros_like(www3_k[..., :1])], axis=-1
    )
    upd6 = (_xr(uuu3) - uuu3 + (www3_kp1 - www3_k) * iadz) * irho
    f_out = jnp.where(m(1, nx), jnp.maximum(0.0, f1 - upd6), f1)
    return f_out, flux


def to_collocated(data: MpdataData):
    """-> (f, u_g, w_g) on the common x grid (S, nx+6, ·); u/w are padded
    with zeros at the collocated slots where they are undefined."""
    s, fx, nzm = data.f.shape
    nx = fx - 6
    z = jnp.zeros((s, 1, nzm), data.f.dtype)
    zw = jnp.zeros((s, 1, nzm + 1), data.f.dtype)
    u_g = jnp.concatenate([z, data.u], axis=1)                 # gi ≥ -1
    w_g = jnp.concatenate([zw, data.w, zw], axis=1)            # gi in [-1,nx+2]
    return data.f, u_g, w_g


def advect_masked_global(data: MpdataData):
    """Single-device entry: masked core on the full global grid — must match
    reference.advect_scalar2d bitwise on f (tested)."""
    f, u_g, w_g = to_collocated(data)
    nx = f.shape[1] - 6
    gi = jnp.arange(f.shape[1], dtype=jnp.int32) - 2
    owned = jnp.ones(f.shape[1], dtype=bool)
    f_out, flux = advect_scalar2d_masked(
        f, u_g, w_g, data.rho, data.rhow, data.adz, gi, owned, nx
    )
    nzm = f.shape[-1]
    flux_out = jnp.concatenate([flux, data.flux[:, nzm:]], axis=-1)
    return f_out, flux_out


def _exchange_strips(x, h, axis_name, n):
    """Halo ppermutes along x inside shard_map: -> (left, right), the h
    columns arriving from the left/right neighbor (zeros at the global
    domain ends — provably never read by owned outputs, masks cover
    gi ∈ [-2, nx+3])."""
    left = lax.ppermute(x[:, -h:], axis_name,
                        [(i, i + 1) for i in range(n - 1)])
    right = lax.ppermute(x[:, :h], axis_name,
                         [(i, i - 1) for i in range(1, n)])
    return left, right


def _exchange(x, h, axis_name, n):
    """Halo exchange along x inside shard_map: returns x extended by h
    neighbor columns on each side (see _exchange_strips)."""
    left, right = _exchange_strips(x, h, axis_name, n)
    return jnp.concatenate([left, x, right], axis=1)


def _masked_core(nx):
    """-> core(f_, u_, w_, rho, rhow, adz, gi0_, lo, hi): one masked MPDATA
    step on an extended column window whose owned outputs are local columns
    [lo, hi); returns (f_out_ext, flux_part (S, nzm))."""
    def core(f_, u_, w_, rho, rhow, adz, gi0_, lo, hi):
        lis = jnp.arange(f_.shape[1], dtype=jnp.int32)
        return advect_scalar2d_masked(
            f_, u_, w_, rho, rhow, adz, gi0_ + lis,
            (lis >= lo) & (lis < hi), nx,
        )
    return core


def make_dist_step(cfg, mesh: Mesh, halo: int = HALO):
    """Build (shard_inputs, step, gather_f) for x-decomposed MPDATA.

    shard_inputs(data) -> (f_s, u_s, w_s, aux) sharded over the mesh axis;
    step(f_s, u_s, w_s, aux) -> (f_s_next, flux) one advection step with
    halo exchange; flux is replicated (psum over shards).  Each shard runs
    the XLA-compiled masked core (advect_scalar2d_masked)."""
    nzm_l = cfg.nzm
    core = _masked_core(cfg.nx)
    axis = mesh.axis_names[0]
    nparts = mesh.devices.size
    nx = cfg.nx
    xg = nx + 6
    chunk = -(-xg // nparts)  # ceil: pad global grid to nparts*chunk
    if nparts > 1 and chunk < halo:
        # _exchange's edge slices would silently truncate (x[:, -h:] just
        # returns fewer columns) and every gi/owned index would misalign
        raise ValueError(
            f"chunk={chunk} < halo={halo}: too many devices for nx={nx}"
        )
    xp = chunk * nparts
    fspec = P(None, axis, None)

    def shard_inputs(data: MpdataData):
        f, u_g, w_g = to_collocated(data)
        pad = xp - xg

        def padx(a):
            return jnp.pad(a, ((0, 0), (0, pad), (0, 0)))

        dev_put = lambda a, spec: jax.device_put(
            a, jax.sharding.NamedSharding(mesh, spec)
        )
        f_s = dev_put(padx(f), fspec)
        u_s = dev_put(padx(u_g), fspec)
        w_s = dev_put(padx(w_g), fspec)
        aux = tuple(
            dev_put(a, P())
            for a in (data.rho, data.rhow, data.adz, data.flux)
        )
        return f_s, u_s, w_s, aux

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(fspec, fspec, fspec, (P(), P(), P(), P())),
        out_specs=(fspec, P()),
        check_vma=False,
    )
    def step(f_loc, u_loc, w_loc, aux):
        rho, rhow, adz, flux_in = aux
        nzm = nzm_l
        f_ext = _exchange(f_loc, halo, axis, nparts)
        u_ext = _exchange(u_loc, halo, axis, nparts)
        w_ext = _exchange(w_loc, halo, axis, nparts)
        me = lax.axis_index(axis)
        gi0 = me * chunk - 2 - halo
        f_out_ext, flux_part = core(f_ext, u_ext, w_ext, rho, rhow, adz,
                                    gi0, halo, halo + chunk)
        f_out = f_out_ext[:, halo:halo + chunk]
        flux = lax.psum(flux_part, axis)
        flux_out = jnp.concatenate([flux, flux_in[:, nzm:]], axis=-1)
        return f_out, flux_out

    def gather_f(f_s):
        """Collect the sharded f back to the reference global layout
        (multi-controller safe: see dist.mesh.to_host_global)."""
        from cdk.dist.mesh import to_host_global

        return np.asarray(to_host_global(f_s))[:, :xg]

    return shard_inputs, step, gather_f


def make_dist_step_overlap(cfg, mesh: Mesh, halo: int = HALO):
    """x-decomposed MPDATA step with comm/compute OVERLAP.

    The plain step (make_dist_step) serializes: exchange → compute, so the
    ppermute latency sits on the critical path.  Here the graph is
    restructured so XLA's latency-hiding scheduler can run the halo
    ppermutes concurrently with the bulk of the arithmetic (the interior/
    boundary split of SURVEY §5):

      1. kick off the f/u/w halo ppermutes;
      2. INTERIOR: run the masked core on the UNEXTENDED local chunk —
         valid for every column ≥ DEPTH(=3) from the shard edges, and
         data-independent of the exchange;
      3. BOUNDARY: once halos land, run the masked core on two thin strips
         (halo + DEPTH+3 local columns) and patch their DEPTH owned edge
         columns over the interior result.

    Results are identical to the serialized step (same per-column
    arithmetic; flux partial sums are disjoint across interior/strips).
    Uses the same (shard_inputs, gather_f) as make_dist_step."""
    nzm_l = cfg.nzm
    core0 = _masked_core(cfg.nx)
    axis = mesh.axis_names[0]
    nparts = mesh.devices.size
    nx = cfg.nx
    xg = nx + 6
    chunk = -(-xg // nparts)
    depth = 3            # stencil dependency depth of the masked core
    need = depth + 3     # strip columns needed beyond the patched region
    if chunk < max(halo, need):
        raise ValueError(
            f"chunk={chunk} too small for overlap (need >= {need})"
        )
    fspec = P(None, axis, None)

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(fspec, fspec, fspec, (P(), P(), P(), P())),
        out_specs=(fspec, P()),
        check_vma=False,
    )
    def step(f_loc, u_loc, w_loc, aux):
        rho, rhow, adz, flux_in = aux
        nzm = nzm_l
        me = lax.axis_index(axis)
        gi0 = me * chunk - 2

        def core(f_, u_, w_, gi0_, lo, hi):
            """Masked core on one column window, owned outputs [lo, hi)."""
            return core0(f_, u_, w_, rho, rhow, adz, gi0_, lo, hi)

        # 1) halo exchange (independent of the interior compute below)
        perm_r = [(i, i + 1) for i in range(nparts - 1)]
        perm_l = [(i, i - 1) for i in range(1, nparts)]
        halos = [
            (lax.ppermute(a[:, -halo:], axis, perm_r),
             lax.ppermute(a[:, :halo], axis, perm_l))
            for a in (f_loc, u_loc, w_loc)
        ]

        # 2) interior: valid except within `depth` of the shard edges
        f_int, flux_int = core(f_loc, u_loc, w_loc, gi0, depth,
                               chunk - depth)

        # 3) boundary strips
        def strip(side):
            if side == 0:  # left edge of the chunk
                arrs = [jnp.concatenate([h[0], a[:, :need]], axis=1)
                        for h, a in zip(halos, (f_loc, u_loc, w_loc))]
                return core(*arrs, gi0 - halo, halo, halo + depth)
            # right edge
            arrs = [jnp.concatenate([a[:, -need:], h[1]], axis=1)
                    for h, a in zip(halos, (f_loc, u_loc, w_loc))]
            return core(*arrs, gi0 + chunk - need, need - depth, need)

        fl, flux_l = strip(0)
        fr, flux_r = strip(1)
        f_out = jnp.concatenate(
            [
                fl[:, halo:halo + depth],
                f_int[:, depth:chunk - depth],
                fr[:, need - depth:need],
            ],
            axis=1,
        )
        flux = lax.psum(flux_int + flux_l + flux_r, axis)
        flux_out = jnp.concatenate([flux, flux_in[:, nzm:]], axis=-1)
        return f_out, flux_out

    return step


def single_device_loop(cfg):
    """-> loop(data, n) -> (f, flux): the single-device n-step integration
    the slice-batch form runs on each device.  On a GPU that is the CUDA
    kernel (kernels/mpdata/hopper.py; a config it cannot run raises
    UnsupportedConfigError rather than falling back); elsewhere — the CPU
    test mesh — the scan over the XLA reference step."""
    from cdk.kernels.mpdata import hopper
    from cdk.kernels.mpdata.reference import advect_scalar2d

    if jax.devices()[0].platform == "gpu":
        hopper.check_supported(cfg)
        return hopper.mpdata_loop

    def loop(data: MpdataData, n: int):
        def body(carry, _):
            f, flux = carry
            return advect_scalar2d(f, data.u, data.w, data.rho, data.rhow,
                                   data.adz, flux), None

        out, _ = lax.scan(body, (data.f, data.flux), None, length=n)
        return out

    return loop


def make_dist_loop_slices(cfg, mesh: Mesh):
    """Slice-batch (data-parallel) distributed MPDATA — the scaling axis
    the REFERENCE itself uses: its miniapp parallelizes by giving each
    node its own slice batch (advect_scalar2D is embarrassingly parallel
    over CRM columns; the per-node batch is the only scaling knob the
    Fortran exposes — mmf-mpdata-tracer/README.md, nIters/nslices), and
    the deferred MPI plan (nested_loops/README.md:27-35) never touches x.

    The slice axis is sharded over the mesh and each shard runs the
    single-device loop (single_device_loop) on its own slices.  There is
    NO exchange and NO collective at all: f, u, w, rho, rhow, adz AND flux
    are all per-slice, so every output is computed where it lives.  Weak
    scaling is exact by construction (per-device work is independent of
    the mesh size); the x-decomposed forms (make_dist_step /
    make_dist_loop) supply the halo-exchange capability for domains whose
    x extent outgrows a card.

    Returns (shard_inputs, loop, (gather_f, gather_flux)):
    loop(f_s, u_s, w_s, aux, n) runs n steps under one jit; outputs stay
    sharded; slices are padded to a multiple of the mesh size with a
    benign state (f=u=w=0, rho=rhow=adz=1) that the gathers drop."""
    nsl = cfg.nslices
    axis = mesh.axis_names[0]
    nparts = mesh.devices.size
    sp = -(-nsl // nparts) * nparts
    spec3 = P(axis, None, None)
    spec2 = P(axis, None)
    run_local = single_device_loop(cfg)

    def _pads(a, pad):
        r = sp - a.shape[0]
        if r == 0:
            return a
        return jnp.pad(a, ((0, r),) + ((0, 0),) * (a.ndim - 1),
                       constant_values=pad)

    def shard_inputs(data: MpdataData):
        put = lambda a, s: jax.device_put(
            a, jax.sharding.NamedSharding(mesh, s))
        f_s = put(_pads(data.f, 0.0), spec3)
        u_s = put(_pads(data.u, 0.0), spec3)
        w_s = put(_pads(data.w, 0.0), spec3)
        aux_s = (
            put(_pads(data.rho, 1.0), spec2),
            put(_pads(data.rhow, 1.0), spec2),
            put(_pads(data.adz, 1.0), spec2),
            put(_pads(data.flux, 0.0), spec2),
        )
        return f_s, u_s, w_s, aux_s

    @functools.partial(jax.jit, static_argnames="n")
    def loop(f_s, u_s, w_s, aux, n: int):
        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(spec3, spec3, spec3, (spec2, spec2, spec2, spec2)),
            out_specs=(spec3, spec2),
            check_vma=False,
        )
        def run(f_loc, u_loc, w_loc, aux):
            rho, rhow, adz, flux = aux
            return run_local(
                MpdataData(f_loc, u_loc, w_loc, rho, rhow, adz, flux), n)

        return run(f_s, u_s, w_s, aux)

    def gather_f(f_s):
        from cdk.dist.mesh import to_host_global

        return np.asarray(to_host_global(f_s))[:nsl]

    def gather_flux(flux_s):
        from cdk.dist.mesh import to_host_global

        return np.asarray(to_host_global(flux_s))[:nsl]

    return shard_inputs, loop, (gather_f, gather_flux)


def make_dist_loop(cfg, mesh: Mesh, halo: int = HALO, overlap: bool = False,
                   unroll: int = 2):
    """n-step distributed integration under ONE jit: `lax.scan` over the
    halo-exchange step, so the whole multi-step run (exchanges included)
    compiles to a single device-side loop — the production integration
    driver shape (one dispatch per run, not per step).

    The serialized (overlap=False) form exchanges the u/w halos once per
    RUN: u/w are constant across the reference's step loop
    (advect…F90:479-481 takes them as intent(in)), so re-running their
    ppermute+concat every step — as chaining make_dist_step does — would
    leave invariant work inside the scan body.  `unroll` duplicates the
    scan body so XLA can overlap one step's exchange glue with the
    previous step's compute.  Bitwise-identical to the chained step: the
    same masked arithmetic sees the same assembled window (tested)."""
    if not overlap:
        return _make_dist_loop_hoisted(cfg, mesh, halo, unroll=unroll)
    step = make_dist_step_overlap(cfg, mesh, halo)

    @functools.partial(jax.jit, static_argnames="n")
    def loop(f_s, u_s, w_s, aux, n: int):
        def body(carry, _):
            f, flux = carry
            rho, rhow, adz, _ = aux
            f2, flux2 = step(f, u_s, w_s, (rho, rhow, adz, flux))
            return (f2, flux2), None

        (f_out, flux_out), _ = jax.lax.scan(
            body, (f_s, aux[3]), None, length=n
        )
        return f_out, flux_out

    return loop


def _make_dist_loop_hoisted(cfg, mesh: Mesh, halo: int, unroll: int = 1):
    """Serialized dist loop with the step-invariant u/w halo exchange
    hoisted out of the scan (see make_dist_loop docstring).  Each scan
    iteration exchanges only f, then runs the same masked core as
    make_dist_step on the same extended window."""
    core = _masked_core(cfg.nx)
    nzm = cfg.nzm
    nx = cfg.nx
    axis = mesh.axis_names[0]
    nparts = mesh.devices.size
    chunk = -(-(nx + 6) // nparts)
    if nparts > 1 and chunk < halo:
        raise ValueError(
            f"chunk={chunk} < halo={halo}: too many devices for nx={nx}"
        )
    fspec = P(None, axis, None)

    @functools.partial(jax.jit, static_argnames="n")
    def loop(f_s, u_s, w_s, aux, n: int):
        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(fspec, fspec, fspec, (P(), P(), P(), P())),
            out_specs=(fspec, P()),
            check_vma=False,
        )
        def run(f_loc, u_loc, w_loc, aux):
            rho, rhow, adz, flux_in = aux
            me = lax.axis_index(axis)
            gi0 = me * chunk - 2 - halo
            u_ext = _exchange(u_loc, halo, axis, nparts)
            w_ext = _exchange(w_loc, halo, axis, nparts)

            def body(carry, _):
                f_l, _flux = carry
                f_ext = _exchange(f_l, halo, axis, nparts)
                f_o_ext, flux_p = core(f_ext, u_ext, w_ext, rho, rhow,
                                       adz, gi0, halo, halo + chunk)
                f_o = f_o_ext[:, halo:halo + chunk]
                return (f_o, lax.psum(flux_p, axis)), None

            (f_o, flux), _ = lax.scan(
                body, (f_loc, flux_in[:, :nzm]), None, length=n,
                unroll=unroll,
            )
            flux_out = jnp.concatenate([flux, flux_in[:, nzm:]], axis=-1)
            return f_o, flux_out

        return run(f_s, u_s, w_s, aux)

    return loop
