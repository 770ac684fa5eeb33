"""ctypes binding of the native host preprocessing library (PyTorch-side
counterpart of ``instance_nerf_tpu.data.native``).

The port builds the repo's ``native/voxel_ops.cpp`` with g++ at first use,
with the JAX package's flags (``-O3 -march=native -ffast-math``), into
``instance_nerf_tpu_torch/_build/voxel_ops-<hash>.so``; the hash covers the
source and the flags, so an edited source rebuilds. Nothing is built when
the module is imported, and nothing is written under ``native/``.

Every entry point has its numpy formula beside it (``*_plain``), the plain
reference, which it falls back to without a toolchain (``available()``
says which one runs). The ``-ffast-math`` build's alphas differ from
numpy's by up to 2.4e-7 (a few ulp below 1; ``tests/test_torch_spatial.py``
holds them to 3e-7 absolute); the copies and masks are exact.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "voxel_ops.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
FLAGS = ("-O3", "-march=native", "-ffast-math", "-funroll-loops", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the build of the current source lands."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"voxel_ops-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a private name, then an atomic rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, SRC, "-lpthread", "-lm"], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not os.path.isfile(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.density_to_alpha_ngp.argtypes = [f32p, f32p, ctypes.c_size_t]
        lib.density_to_alpha_ddp.argtypes = [f32p, f32p, ctypes.c_size_t]
        lib.pad_copy_4d.argtypes = [f32p, f32p] + [ctypes.c_int64] * 7
        lib.instance_masks.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                       ctypes.POINTER(ctypes.c_int64),
                                       ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_size_t, ctypes.c_size_t]
        _lib = lib
        return _lib


def available() -> bool:
    """The native build loads (else every entry point runs its numpy
    formula)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def density_to_alpha_plain(sigma: np.ndarray, kind: str = "ngp") -> np.ndarray:
    sigma = np.ascontiguousarray(sigma, np.float32)
    if kind == "ngp":
        return np.clip(1.0 - np.exp(-np.exp(sigma) / 100.0), 0.0, 1.0)
    return np.clip(1.0 - np.exp(-np.clip(sigma, 0, None) / 100.0), 0.0, 1.0)


def density_to_alpha(sigma: np.ndarray, kind: str = "ngp") -> np.ndarray:
    """sigma -> alpha, f32: ``clip(1 - exp(-exp(s) / 100), 0, 1)`` for
    ``kind="ngp"``, ``clip(1 - exp(-relu(s) / 100), 0, 1)`` otherwise
    (dense-depth-priors)."""
    lib = _load()
    if lib is None:
        return density_to_alpha_plain(sigma, kind)
    sigma = np.ascontiguousarray(sigma, np.float32)
    out = np.empty_like(sigma)
    fn = lib.density_to_alpha_ngp if kind == "ngp" else lib.density_to_alpha_ddp
    fn(_ptr(sigma, ctypes.c_float), _ptr(out, ctypes.c_float), sigma.size)
    return out


def pad_copy_plain(src: np.ndarray, pad_shape) -> np.ndarray:
    out = np.zeros((*pad_shape, src.shape[-1]), np.float32)
    w, l, h, _ = src.shape
    out[:w, :l, :h] = src
    return out


def pad_copy(src: np.ndarray, pad_shape) -> np.ndarray:
    """(w, l, h, c) f32 -> zero-padded (pw, pl, ph, c)."""
    lib = _load()
    if lib is None:
        return pad_copy_plain(src, pad_shape)
    w, l, h, c = src.shape
    pw, pl, ph = pad_shape
    src = np.ascontiguousarray(src, np.float32)
    out = np.zeros((pw, pl, ph, c), np.float32)
    lib.pad_copy_4d(_ptr(src, ctypes.c_float), _ptr(out, ctypes.c_float), w, l, h, c,
                    pw, pl, ph)
    return out


def instance_masks_plain(grid: np.ndarray, ids: np.ndarray) -> np.ndarray:
    grid = np.asarray(grid, np.int64)
    ids = np.asarray(ids, np.int64)
    return (grid[None] == ids[:, None, None, None]).astype(np.uint8)


def instance_masks(grid: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(W, L, H) int64 id grid + (K,) ids -> (K, W, L, H) uint8 masks."""
    lib = _load()
    if lib is None:
        return instance_masks_plain(grid, ids)
    grid = np.ascontiguousarray(grid, np.int64)
    ids = np.ascontiguousarray(ids, np.int64)
    out = np.empty((ids.size, grid.size), np.uint8)
    lib.instance_masks(_ptr(grid, ctypes.c_int64), _ptr(ids, ctypes.c_int64),
                       _ptr(out, ctypes.c_uint8), grid.size, ids.size)
    return out.reshape(ids.size, *grid.shape)
