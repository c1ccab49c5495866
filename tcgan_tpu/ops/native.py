"""ctypes bindings for the native CPU baseline solver (csrc/ssnode.cpp).

Reference parity: the ctypes loading of ``libssnode`` in
``tc_gan/ssnode.py`` (SURVEY.md §2 "ssnode": "Python wrapper over the C
solver"). Auto-builds the shared library on first use if a toolchain is
available; callers should treat availability as optional
(:func:`available`) — the device path never needs it.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

from tcgan_tpu.ops.io_funs import IO_TYPES
from tcgan_tpu.ops.ssn import SSNConfig

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_LIB_PATH = _CSRC / "libssnode.so"
_lib = None
_load_error: str | None = None


def _ensure_built() -> bool:
    global _load_error
    # Always invoke make (a fresh .so is a no-op thanks to the Makefile
    # dependency on ssnode.cpp): an exists() shortcut would silently use
    # a stale binary after a source edit, or a foreign-arch -march=native
    # binary synced from another host (SIGILL inside ctypes).
    try:
        subprocess.run(["make", "-C", str(_CSRC)], check=True,
                       capture_output=True, text=True, timeout=300)
        return _LIB_PATH.exists()
    except subprocess.CalledProcessError as e:  # pragma: no cover
        _load_error = (f"build failed: {e}; "
                       f"{(e.stdout or '')[-300:]} {(e.stderr or '')[-600:]}")
        return _LIB_PATH.exists()
    except Exception as e:  # pragma: no cover
        if _LIB_PATH.exists():
            # no toolchain but a binary is present (e.g. a deployment
            # image without g++): use it rather than fail
            return True
        _load_error = f"build failed: {e}"
        return False


def _load():
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if not _ensure_built():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:  # pragma: no cover
        _load_error = str(e)
        return None
    lib.ssnode_solve_batch.restype = ctypes.c_int64
    lib.ssnode_solve_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # W
        ctypes.POINTER(ctypes.c_double),  # I
        ctypes.POINTER(ctypes.c_double),  # r (in/out)
        ctypes.POINTER(ctypes.c_double),  # tau
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # batch, n_stim, n2
        ctypes.c_double, ctypes.c_int,  # dt, io_type
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32),  # flags
        ctypes.POINTER(ctypes.c_int32),  # iters
    ]
    lib.ssnode_num_threads.restype = ctypes.c_int32
    lib.ssnode_num_threads.argtypes = []
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return int(lib.ssnode_num_threads()) if lib else 0


class NativeResult(NamedTuple):
    r: np.ndarray
    converged: np.ndarray
    diverged: np.ndarray
    iters: np.ndarray


def solve_fixed_point_native(
    cfg: SSNConfig, W: np.ndarray, I_ext: np.ndarray,
    r0: np.ndarray | None = None,
) -> NativeResult:
    """Solve on the CPU via the OpenMP C++ solver (float64).

    Same contract as :func:`tcgan_tpu.ops.fixed_point.solve_fixed_point`
    with a (batch, n_stim, 2N) layout.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native solver unavailable: {_load_error}")
    if cfg.stepper != "euler":
        raise NotImplementedError(
            "the native CPU baseline implements the reference's forward "
            "Euler only; use stepper='euler' for cross-checks against it"
        )
    W = np.ascontiguousarray(W, dtype=np.float64)
    I_ext = np.ascontiguousarray(I_ext, dtype=np.float64)
    if W.ndim == 2:
        W = W[None]
    if I_ext.ndim == 2:
        I_ext = np.broadcast_to(I_ext[None], (W.shape[0],) + I_ext.shape).copy()
    batch, n2 = W.shape[0], W.shape[-1]
    n_stim = I_ext.shape[-2]
    # The C solver indexes raw pointers — validate every batch/size
    # relation here (a 3-D I_ext with a mismatched batch dim, or an
    # I_ext/W width mismatch, would read past the end of the buffer
    # inside C with no error). Size-1 batch dims broadcast like JAX.
    if W.ndim != 3 or W.shape[-2] != n2:
        raise ValueError(f"W must be (batch, 2N, 2N); got {W.shape}")
    if I_ext.shape[-1] != n2:
        raise ValueError(
            f"I_ext width {I_ext.shape[-1]} != W width {n2}")
    if I_ext.ndim != 3:
        raise ValueError(f"I_ext must be (batch, n_stim, 2N) or "
                         f"(n_stim, 2N); got {I_ext.shape}")
    if I_ext.shape[0] != batch:
        if I_ext.shape[0] == 1:
            I_ext = np.broadcast_to(I_ext, (batch, n_stim, n2)).copy()
        elif batch == 1 and I_ext.shape[0] > 1:
            batch = I_ext.shape[0]
            W = np.broadcast_to(W, (batch, n2, n2)).copy()
        else:
            raise ValueError(
                f"batch mismatch: W has {batch}, I_ext has "
                f"{I_ext.shape[0]}")
    r = (np.zeros((batch, n_stim, n2)) if r0 is None
         else np.ascontiguousarray(np.broadcast_to(r0, (batch, n_stim, n2)),
                                   dtype=np.float64).copy())
    tau = np.ascontiguousarray(np.asarray(cfg.tau_vector(), dtype=np.float64))
    flags = np.zeros((batch, n_stim), dtype=np.int32)
    iters = np.zeros((batch, n_stim), dtype=np.int32)

    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.ssnode_solve_batch(
        dptr(W), dptr(I_ext), dptr(r), dptr(tau),
        batch, n_stim, n2,
        cfg.dt, IO_TYPES.index(cfg.io_type),
        cfg.k, cfg.n, cfg.rate_soft_bound, cfg.rate_hard_bound,
        cfg.max_iter, cfg.atol, cfg.rate_stop_at,
        iptr(flags), iptr(iters),
    )
    return NativeResult(r, flags == 1, flags == 2, iters)
