"""ctypes bindings + build for the native (C++) BGZF/BAM codec.

The shared library is compiled on first use with g++ (no pip installs in this
environment); a failure to build falls back to the pure-Python codec, so the
framework stays functional anywhere.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading


_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "ptio.cc")
_SO = os.path.join(_HERE, "..", "_build", "native", "ptio.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def _build() -> str | None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # compile into a per-pid temp and publish atomically: concurrent
    # processes racing on a stale .so must never dlopen a half-written
    # library (os.replace is atomic on POSIX)
    tmp_so = f"{_SO}.tmp{os.getpid()}"
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp_so]
    # libdeflate (the codec htslib links for BGZF) when present; zlib-only
    # fallback otherwise
    proc = subprocess.run(
        base + ["-lz", "-ldeflate", "-lpthread"], capture_output=True, text=True
    )
    if proc.returncode != 0:
        proc = subprocess.run(
            base + ["-DPTIO_NO_LIBDEFLATE", "-lz", "-lpthread"],
            capture_output=True, text=True,
        )
    if proc.returncode != 0:
        if os.path.exists(tmp_so):
            os.remove(tmp_so)
        return proc.stderr[-2000:]
    os.replace(tmp_so, _SO)
    return None


def get_lib():
    """Load (building if needed) the native library; None when unavailable."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        # sanitizer runs bind a prebuilt instrumented build, bypassing the
        # staleness rebuild (scripts/asan_native.py)
        override = os.environ.get("PTPU_PTIO_SO")
        if not override and (
            not os.path.exists(_SO)
            or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
            )
        ):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(override or _SO)
        lib.ptio_reader_open.restype = ctypes.c_void_p
        lib.ptio_reader_open.argtypes = [ctypes.c_char_p]
        lib.ptio_reader_close.argtypes = [ctypes.c_void_p]
        lib.ptio_read.restype = ctypes.c_longlong
        lib.ptio_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong
        ]
        lib.ptio_seek_voffset.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
        lib.ptio_tell_voffset.restype = ctypes.c_ulonglong
        lib.ptio_tell_voffset.argtypes = [ctypes.c_void_p]
        lib.ptio_read_records.restype = ctypes.c_longlong
        lib.ptio_read_records.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_ulonglong,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.ptio_check_eof.restype = ctypes.c_int
        lib.ptio_check_eof.argtypes = [ctypes.c_char_p]
        lib.ptio_reader_set_threads.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ptio_writer_open.restype = ctypes.c_void_p
        lib.ptio_writer_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int
        ]
        lib.ptio_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong
        ]
        lib.ptio_writer_close.restype = ctypes.c_int
        lib.ptio_writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_error() -> str | None:
    return _build_error


class NativeBgzfReader:
    """Drop-in replacement for bgzf.BgzfReader backed by the C++ codec, plus a
    bulk record-scan fast path."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise OSError(f"native codec unavailable: {build_error()}")
        self._lib = lib
        self._h = lib.ptio_reader_open(path.encode())
        if not self._h:
            raise OSError(f"Failed to open '{path}'")

    def close(self) -> None:
        if self._h:
            self._lib.ptio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, n: int) -> bytes:
        buf = ctypes.create_string_buffer(n)
        got = self._lib.ptio_read(self._h, buf, n)
        return buf.raw[:got]

    def seek_voffset(self, voffset: int) -> None:
        self._lib.ptio_seek_voffset(self._h, voffset)

    def tell_voffset(self) -> int:
        return self._lib.ptio_tell_voffset(self._h)

    def read_records_bulk(
        self, buf_cap: int = 8 << 20, max_records: int = 1 << 30,
        limit_voffset: int = 0,
    ) -> list[bytes]:
        """Read up to max_records size-prefixed records; returns raw payloads.

        The scratch buffer persists across calls (create_string_buffer
        zero-fills — at 10 MB assembly-contig records that was a measured
        ~10% of the whole phase-1 scan) and grows geometrically on demand.
        """
        buf = getattr(self, "_bulk_buf", None)
        if buf is None or len(buf) < buf_cap:
            buf = self._bulk_buf = bytearray(buf_cap)
        cbuf = (ctypes.c_char * len(buf)).from_buffer(buf)
        n_bytes = ctypes.c_longlong(0)
        n = self._lib.ptio_read_records(
            self._h, cbuf, len(buf), max_records, limit_voffset,
            ctypes.byref(n_bytes),
        )
        if n == -1:
            raise ValueError("invalid BAM record size (corrupt stream)")
        if n == -2:
            # first record exceeds buf_cap: retry at the required capacity
            # (e.g. an ultralong read; an empty return would look like EOF)
            del cbuf  # release the exported buffer before it is replaced
            return self.read_records_bulk(
                buf_cap=int(n_bytes.value), max_records=max_records,
                limit_voffset=limit_voffset,
            )
        out = []
        mv = memoryview(buf)[: n_bytes.value]
        off = 0
        for _ in range(n):
            size = int.from_bytes(mv[off : off + 4], "little", signed=True)
            out.append(bytes(mv[off + 4 : off + 4 + size]))
            off += 4 + size
        del mv, cbuf
        return out

    def set_threads(self, n: int) -> None:
        """Enable parallel BGZF readahead (ptio decode pool)."""
        self._lib.ptio_reader_set_threads(self._h, int(n))


class NativeBgzfWriter:
    """Drop-in replacement for bgzf.BgzfWriter with pool-threaded deflate."""

    def __init__(self, path: str, level: int = 6, n_threads: int = 1):
        lib = get_lib()
        if lib is None:
            raise OSError(f"native codec unavailable: {build_error()}")
        self._lib = lib
        self._h = lib.ptio_writer_open(path.encode(), level, n_threads)
        if not self._h:
            raise OSError(f"Failed to open '{path}' for writing")

    def write(self, data: bytes) -> None:
        self._lib.ptio_write(self._h, data, len(data))

    def close(self) -> None:
        if self._h:
            ok = self._lib.ptio_writer_close(self._h)
            self._h = None
            if not ok:
                raise OSError("native BGZF writer failed")


def native_check_eof(path: str) -> bool:
    lib = get_lib()
    if lib is None:
        from portello_tpu_torch.io.bgzf import check_eof_marker

        return check_eof_marker(path)
    return bool(lib.ptio_check_eof(path.encode()))
