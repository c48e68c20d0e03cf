"""Build and bind the hand-written CUDA kernels (``portello_tpu_torch/csrc``).

The sources compile with ``nvcc`` for ``sm_90a``, one process per source, all
started together, and link into one shared library with a plain C
interface, loaded with ctypes.  The build runs at first CUDA use,
writes into ``portello_tpu_torch/_build/`` and is rebuilt whenever a source is
newer than the library.  A failed build raises with nvcc's stderr; nothing
falls back to another path.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SO_PATH = os.path.join(BUILD_DIR, "libportello_kernels.so")
SOURCES = ("compress.cu", "match_run.cu", "window_match.cu", "bgzf_deflate.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# Launches per kernel wrapper, counted where the kernel is launched.
launch_counts = {"cleanup_and_compress": 0, "match_run": 0, "window_match": 0}

_lib = None
_lock = threading.Lock()
build_seconds: float | None = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _stale() -> bool:
    if not os.path.exists(SO_PATH):
        return True
    built = os.path.getmtime(SO_PATH)
    return any(
        os.path.getmtime(os.path.join(CSRC, f)) > built
        for f in os.listdir(CSRC)
    )


def build() -> float:
    """Compile the kernels into ``SO_PATH``; returns the build seconds.

    Each source compiles to an object in its own nvcc process, all at once;
    one more nvcc links them.  The library is linked into a per-process temp
    file and published atomically, so a concurrent process never loads a
    half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    tmp = f"{SO_PATH}.{tag}"
    objs = [os.path.join(BUILD_DIR, f"{f}.{tag}.o") for f in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        errors = []
        for src, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src}:\n{err}")
        if not errors:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                errors.append(f"link:\n{proc.stderr}")
        if errors:
            raise RuntimeError("nvcc build failed:\n" + "\n".join(errors))
        os.replace(tmp, SO_PATH)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    return time.perf_counter() - t0


def _bind(path: str):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ptt_cleanup_and_compress.restype = i
    lib.ptt_cleanup_and_compress.argtypes = [
        p, p, i, i, i, p, p, p, p, p, p,
    ]
    lib.ptt_match_run.restype = i
    lib.ptt_match_run.argtypes = [p, i, p, i, p, p, p, i, i, i, i, p, p]
    ll = ctypes.c_longlong
    lib.ptt_window_runs_resident.restype = i
    lib.ptt_window_runs_resident.argtypes = [
        p, ll, p, p, i, p, p, p, p, p, i, i, i, p, p, p,
    ]
    lib.ptt_window_match.restype = i
    lib.ptt_window_match.argtypes = [p, p, i, p, p, i, i, i, p, p, p]
    lib.ptt_bgzf_deflate.restype = i
    lib.ptt_bgzf_deflate.argtypes = [p, p, i, p, p, p, p, i, p]
    lib.ptt_bgzf_card_create.restype = p
    lib.ptt_bgzf_card_create.argtypes = [i, i, i]
    return lib


def ensure_built() -> float:
    """Build the library if it is missing or stale; returns the build
    seconds, 0 when it was current.  It only runs nvcc: it loads nothing and
    touches no device, so a process can build once before it forks workers
    that will use CUDA."""
    return build() if _stale() else 0.0


def get_lib():
    """The bound kernel library, built first if missing or stale."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            build_seconds = ensure_built()
            _lib = _bind(SO_PATH)
        return _lib


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launch_counts[name] += 1


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel operand: CUDA, dtype, rank, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
