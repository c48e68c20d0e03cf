"""ctypes bindings for the native per-read liftover core (ptcore.cc).

The C++ core is the reference-exact CPU implementation of the phase-2 inner
loop (liftover + indel simplify; reference liftover_read_alignment.rs:35-223,
simplify_alignment_indels.rs:4-156).  It serves as

1. the measured native baseline for bench.py (BASELINE.md: no Rust toolchain
   exists in this image, so this compiled multithreaded implementation of the
   same per-read algorithm is the honest denominator), and
2. a fast host path, bit-identical to the Python oracle
   (tests/test_native_core.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "io", "native", "ptcore.cc")
_SO = os.path.join(_HERE, "..", "_build", "native", "ptcore.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None

_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _build() -> str | None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # compile into a per-pid temp and publish atomically: concurrent
    # processes racing on a stale .so must never dlopen a half-written
    # library (os.replace is atomic on POSIX)
    tmp_so = f"{_SO}.tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
        "-o", tmp_so, "-lpthread",
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp_so):
            os.remove(tmp_so)
        return proc.stderr[-2000:]
    os.replace(tmp_so, _SO)
    return None


def get_lib():
    """Load (building on first use) the native core; None when unavailable."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        # sanitizer runs bind a prebuilt instrumented build, bypassing the
        # staleness rebuild (scripts/asan_native.py)
        override = os.environ.get("PTPU_PTCORE_SO")
        if not override and (
            not os.path.exists(_SO)
            or os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(override or _SO)
        lib.ptcore_lift_simplify_batch.restype = ctypes.c_longlong
        lib.ptcore_lift_simplify_batch.argtypes = [
            ctypes.c_longlong,                     # b
            _I32P, _I32P, _I32P, ctypes.c_longlong,  # ops, lens, n_ops, max_ops
            _I32P,                                  # pos
            _I32P, _I32P, _I32P, ctypes.c_longlong,  # bk, bv, nb, max_blocks
            _U8P, _I32P,                            # ref_win, ref_base
            _U8P, ctypes.c_longlong,                # read_seq, max_seq
            ctypes.c_int,                           # n_threads
            _I32P, _I32P, _I32P, _I32P,             # out codes/lens/n/pos
            ctypes.c_longlong,                      # max_out
        ]
        lib.ptcore_hw_threads.restype = ctypes.c_int
        lib.ptcore_hw_threads.argtypes = []
        lib.ptcore_shift_batch.restype = ctypes.c_longlong
        lib.ptcore_shift_batch.argtypes = [
            ctypes.c_longlong,                       # b
            _I32P, _I32P, _I32P, ctypes.c_longlong,  # ops, lens, n_ops, max_ops
            _I32P,                                   # pos (window-relative)
            _U8P, _U8P, ctypes.c_longlong,           # contig_win, read_seq, max_seq
            ctypes.c_int,                            # n_threads
            _I32P, _I32P, _I32P, _I32P,              # out codes/lens/n/pos
            ctypes.c_longlong,                       # max_out
        ]
        _lib = lib
        return _lib


def build_error() -> str | None:
    return _build_error


def lift_simplify_batch(
    ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq,
    max_out: int, n_threads: int = 1,
):
    """Run the native lift+simplify over a padded batch (DeviceEngine layout).

    Returns (out_codes, out_lens, out_n, out_pos); out_n[i] == -1 marks an
    unmapped item, -2 an output overflow.  Raises RuntimeError when the
    native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"ptcore unavailable: {build_error()}")
    b, max_ops = ops.shape
    max_blocks = bk.shape[1]
    max_seq = ref_win.shape[1]
    out_codes = np.zeros((b, max_out), dtype=np.int32)
    out_lens = np.zeros((b, max_out), dtype=np.int32)
    out_n = np.zeros(b, dtype=np.int32)
    out_pos = np.zeros(b, dtype=np.int32)
    asc = np.ascontiguousarray
    rc = lib.ptcore_lift_simplify_batch(
        b,
        asc(ops, dtype=np.int32), asc(lens, dtype=np.int32),
        asc(n_ops, dtype=np.int32), max_ops,
        asc(pos, dtype=np.int32),
        asc(bk, dtype=np.int32), asc(bv, dtype=np.int32),
        asc(nb, dtype=np.int32), max_blocks,
        asc(ref_win, dtype=np.uint8), asc(ref_base, dtype=np.int32),
        asc(read_seq, dtype=np.uint8), max_seq,
        int(n_threads),
        out_codes, out_lens, out_n, out_pos,
        max_out,
    )
    if rc != 0:
        raise RuntimeError(f"ptcore_lift_simplify_batch failed rc={rc}")
    return out_codes, out_lens, out_n, out_pos


def shift_batch(
    ops, lens, n_ops, pos, contig_win, read_seq, max_out: int,
    n_threads: int = 1,
):
    """Native batch left-shift (the rev-item host-shift prep step; reference
    read_alignment_scanner.rs:159-176).  ``pos`` is relative to each row's
    ``contig_win`` (which must cover ``[0, pos + ref_span)`` of the reversed
    contig).  Returns (out_codes, out_lens, out_n, out_pos); out_n[i] == -2
    marks an output overflow.  Bit-identical to ops/shift.left_shift_indels
    (tests/test_native_core.py)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"ptcore unavailable: {build_error()}")
    b, max_ops = ops.shape
    max_seq = contig_win.shape[1]
    out_codes = np.zeros((b, max_out), dtype=np.int32)
    out_lens = np.zeros((b, max_out), dtype=np.int32)
    out_n = np.zeros(b, dtype=np.int32)
    out_pos = np.zeros(b, dtype=np.int32)
    asc = np.ascontiguousarray
    rc = lib.ptcore_shift_batch(
        b,
        asc(ops, dtype=np.int32), asc(lens, dtype=np.int32),
        asc(n_ops, dtype=np.int32), max_ops,
        asc(pos, dtype=np.int32),
        asc(contig_win, dtype=np.uint8), asc(read_seq, dtype=np.uint8),
        max_seq,
        int(n_threads),
        out_codes, out_lens, out_n, out_pos,
        max_out,
    )
    if rc != 0:
        raise RuntimeError(f"ptcore_shift_batch failed rc={rc}")
    return out_codes, out_lens, out_n, out_pos


def hw_threads() -> int:
    lib = get_lib()
    return int(lib.ptcore_hw_threads()) if lib is not None else 1
