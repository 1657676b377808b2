"""ctypes bindings to the native host layer (cpp/libcdk_host.so).

The counterpart of the reference's C-interop layer: where
nested_vars.F90 exports `c_ptr`s (nested_vars.F90:75-86) and cke_mod.F90
declares `bind(c)` interfaces for the C++ side (cke_mod.F90:6-48), here the
C++ library exposes a C ABI and NumPy arrays cross via ctypes — no copy,
the C++ code writes straight into the caller's buffers.

The library is built on demand (`make -C cpp`); everything degrades
gracefully to the pure-Python implementations when a toolchain is absent
(`available()` gates the tests)."""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_CPP_DIR = Path(__file__).resolve().parents[2] / "cpp"
_LIB_PATH = _CPP_DIR / "libcdk_host.so"
_lib = None


def _f64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def build(force: bool = False) -> bool:
    if _LIB_PATH.exists() and not force:
        return True
    try:
        subprocess.run(["make", "-C", str(_CPP_DIR)], check=True,
                       capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def load():
    global _lib
    if _lib is None:
        if not build():
            raise RuntimeError("native host library unavailable")
        _lib = ctypes.CDLL(str(_LIB_PATH))
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


def lcg_fill(n: int, seed: int = 11) -> np.ndarray:
    out = np.empty(n, np.float64)
    load().cdk_lcg_fill(ctypes.c_longlong(seed), ctypes.c_longlong(n),
                        _f64(out))
    return out


def uniform_fill(n: int, seed: int) -> np.ndarray:
    out = np.empty(n, np.float64)
    load().cdk_uniform_fill(ctypes.c_ulonglong(seed), ctypes.c_longlong(n),
                            _f64(out))
    return out


def pad_lanes(a: np.ndarray, dpad: int) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    rows = int(np.prod(a.shape[:-1]))
    out = np.empty((*a.shape[:-1], dpad), np.float64)
    load().cdk_pad_lanes(ctypes.c_longlong(rows),
                         ctypes.c_longlong(a.shape[-1]),
                         ctypes.c_longlong(dpad), _f64(a), _f64(out))
    return out


def biharmonic_ref(data, rrearth: float) -> np.ndarray:
    """C++ scalar oracle of the weak tensor Laplacian (layouts per
    BiharmonicData)."""
    dvv = np.ascontiguousarray(data.dvv, np.float64)
    dinv = np.ascontiguousarray(data.dinv, np.float64)
    sp = np.ascontiguousarray(data.spheremp, np.float64)
    tv = np.ascontiguousarray(data.tensorvisc, np.float64)
    q = np.ascontiguousarray(data.qtens, np.float64)
    e, qs, nl, n, _ = q.shape
    out = np.empty_like(q)
    load().cdk_biharmonic_ref(e, qs, nl, n, _f64(dvv), _f64(dinv), _f64(sp),
                              _f64(tv), ctypes.c_double(rrearth), _f64(q),
                              _f64(out))
    return out


def biharmonic_dss_ref(data, rrearth: float) -> np.ndarray:
    """C++ scalar oracle of the two-application ring-DSS biharmonic
    (kernels/biharmonic/dss.py semantics)."""
    dvv = np.ascontiguousarray(data.dvv, np.float64)
    dinv = np.ascontiguousarray(data.dinv, np.float64)
    sp = np.ascontiguousarray(data.spheremp, np.float64)
    tv = np.ascontiguousarray(data.tensorvisc, np.float64)
    q = np.ascontiguousarray(data.qtens, np.float64)
    e, qs, nl, n, _ = q.shape
    out = np.empty_like(q)
    scratch = np.empty_like(q)
    load().cdk_biharmonic_dss_ref(e, qs, nl, n, _f64(dvv), _f64(dinv),
                                  _f64(sp), _f64(tv),
                                  ctypes.c_double(rrearth), _f64(q),
                                  _f64(out), _f64(scratch))
    return out


def biharmonic_dss2d_ref(data, rrearth: float, ex: int, ey: int) -> np.ndarray:
    """C++ scalar oracle of the two-application 2-D torus-DSS biharmonic
    (kernels/biharmonic/dss2d.py semantics: edge + 4-way corner assembly
    via the two-pass sum)."""
    dvv = np.ascontiguousarray(data.dvv, np.float64)
    dinv = np.ascontiguousarray(data.dinv, np.float64)
    sp = np.ascontiguousarray(data.spheremp, np.float64)
    tv = np.ascontiguousarray(data.tensorvisc, np.float64)
    q = np.ascontiguousarray(data.qtens, np.float64)
    e, qs, nl, n, _ = q.shape
    assert e == ex * ey
    out = np.empty_like(q)
    scratch = np.empty_like(q)
    load().cdk_biharmonic_dss2d_ref(ex, ey, qs, nl, n, _f64(dvv),
                                    _f64(dinv), _f64(sp), _f64(tv),
                                    ctypes.c_double(rrearth), _f64(q),
                                    _f64(out), _f64(scratch))
    return out


def cke_ref(data, coef3rdorder: float) -> np.ndarray:
    """C++ scalar oracle of the original-form edge flux."""
    cells = np.ascontiguousarray(data.adv_cells, np.int32)
    c1 = np.ascontiguousarray(data.adv_coefs, np.float64)
    c3 = np.ascontiguousarray(data.adv_coefs3, np.float64)
    tr = np.ascontiguousarray(data.tracer, np.float64)
    ntf = np.ascontiguousarray(data.ntf, np.float64)
    am = np.ascontiguousarray(data.adv_mask, np.float64)
    kmin = np.ascontiguousarray(data.min_level, np.int32)
    kmax = np.ascontiguousarray(data.max_level, np.int32)
    e, a = cells.shape
    c, kv = tr.shape
    out = np.empty((e, kv), np.float64)
    load().cdk_cke_ref(e, c, kv, a, _i32(cells), _f64(c1), _f64(c3),
                       _f64(tr), _f64(ntf), _f64(am), _i32(kmin), _i32(kmax),
                       ctypes.c_double(coef3rdorder), _f64(out))
    return out


def mpdata_ref(data) -> tuple[np.ndarray, np.ndarray]:
    """C++ scalar oracle of one MPDATA step; returns (f, flux)."""
    f = np.ascontiguousarray(data.f, np.float64)
    u = np.ascontiguousarray(data.u, np.float64)
    w = np.ascontiguousarray(data.w, np.float64)
    rho = np.ascontiguousarray(data.rho, np.float64)
    rhow = np.ascontiguousarray(data.rhow, np.float64)
    adz = np.ascontiguousarray(data.adz, np.float64)
    flux = np.ascontiguousarray(data.flux, np.float64)
    ns, fx, nzm = f.shape
    f_out = np.empty_like(f)
    flux_out = np.empty_like(flux)
    load().cdk_mpdata_ref(ns, fx - 6, nzm + 1, _f64(f), _f64(u), _f64(w),
                          _f64(rho), _f64(rhow), _f64(adz), _f64(flux),
                          _f64(f_out), _f64(flux_out))
    return f_out, flux_out


def mpdata_stages_loop(data, nsteps: int) -> tuple[np.ndarray, np.ndarray]:
    """Serial host run of the GPU MPDATA kernel's own stage functions
    (cdk/kernels/mpdata/cuda/mpdata_stages.h) for `nsteps` steps, in
    the dtype of `data` (float32 or float64); returns (f, flux)."""
    dt = np.dtype(np.asarray(data.f).dtype)
    if dt not in (np.float32, np.float64):
        raise ValueError(f"mpdata_stages_loop takes f32 or f64, got {dt}")
    arrs = [np.ascontiguousarray(a, dt) for a in (
        data.f, data.u, data.w, data.rho, data.rhow, data.adz, data.flux)]
    ns, fx, nzm = arrs[0].shape
    f_out = np.empty_like(arrs[0])
    flux_out = np.empty_like(arrs[6])
    ptr = ctypes.POINTER(ctypes.c_float if dt == np.float32
                         else ctypes.c_double)
    fn = (load().cdk_mpdata_stages_loop_f32 if dt == np.float32
          else load().cdk_mpdata_stages_loop_f64)
    fn(ns, fx - 6, nzm + 1, nsteps,
       *(a.ctypes.data_as(ptr) for a in (*arrs, f_out, flux_out)))
    return f_out, flux_out
