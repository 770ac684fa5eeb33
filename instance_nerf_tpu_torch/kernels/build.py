"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``_build/<name>-<hash>.so`` inside the package at
first use. The hash covers the source, the shared headers ``csrc/*.cuh``
and the flags, so an edited source or header rebuilds and an unchanged one
loads from the cache. Nothing is built when a module is imported.

Division stays IEEE-rounded (no ``--use_fast_math``): the NMS keep
decisions must match the plain PyTorch version bit for bit, and the
scatter-add's f32 atomics must round as its plain version's adds do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# every kernel source of the port, by name (csrc/<name>.cu)
SOURCES = ("nms_sweep", "nms_sweep_iou", "scatter_add", "coarse_occ", "adam", "hash_encode",
           "composite")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per kernel source: seconds spent compiling (0.0 when loaded from cache)
# and what ptxas reported (registers, shared memory, spills)
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own lookup: CUDA_HOME / CUDA_PATH, then the toolkit's default
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header (csrc/*.cuh) it may include
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src, *(os.path.join(CSRC_DIR, h) for h in headers)]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is cached."""
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        build_info.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": log.strip()}


def build_all(names) -> None:
    """Compile every named source at once (one ``nvcc`` each, in parallel)."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = [(n, _start(n)) for n in todo]
        for n, s in started:
            _finish(n, s)
        for n in todo:
            _libs[n] = ctypes.CDLL(_target(n)[1])


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def typed(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """``csrc/<name>.cu``'s C function ``fn`` with its argument types set
    and an int result (the launch's CUDA error)."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def call_on_stream(f, index: int, *args) -> int:
    """``f(*args, stream)`` with CUDA device ``index`` current and its
    current stream's handle as the last argument. The device is switched
    only when it is not current already, and the raw handle is taken without
    building a ``torch.cuda.Stream`` (PyTorch's private calls where this
    build has them: a kernel that runs for microseconds pays this on every
    launch)."""
    import torch

    get_device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if index == get_device():
        stream = raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream
        return f(*args, stream)
    with torch.cuda.device(index):
        return f(*args, torch.cuda.current_stream(index).cuda_stream)
