"""Native phase-2 feed: the C++ read scanner (``ptscan.cc``) driving the
PyTorch device steps.

The scanner's ctypes layer and the CRAM feeder are copied from the JAX
package's ``pipeline/native_feed.py`` (everything above the dispatch loop);
the scanner builds with g++ from this package's own ``io/native/ptscan.cc``
(with ``ptio.cc`` and ``ptcore.cc``) into ``_build/native/`` at first use.
The dispatch loop is the port's:

    while ptscan_next_batch(h, desc):    # C++ scans + preps one full batch
        out = step(desc -> device)       # one device step (fixed shapes)
        ptscan_post_results(h, out)      # C++ finishes + writes ready reads

Slots come in two modes.  Resident slot mode (the default; ``PTPU_RESIDENT=0``
selects table slots) keeps the whole genome on the device for the run,
built once by ``build_global_ref``; a slot then holds the padded cigars,
block maps, the read rows packed as BAM nibbles and each item's reference
chromosome, and the step is ``fwd_batch_resident``.  Table slots
(``resident=False``) hold the ``(B, max_seq)`` ref-window and read rows
instead, and the step is ``fwd_batch``.  Host-shift routing
(``PTPU_HOST_SHIFT``, on by default) left-shifts reverse-contig items during
the C++ prep, so every batch is a forward batch.  Under device-shift routing
(``PTPU_HOST_SHIFT=0``) the scanner emits reverse batches too, whose slots
add the reversed contig's window, and the step for them is ``rev_batch``;
the scanner then emits table slots only, so the feed forces table slots as
well, whatever ``PTPU_RESIDENT`` says.  Two batches stay in flight: the
card computes batch N while the scanner preps batch N+1.

Every batch goes through a sharded step of ``parallel/mesh.py``.  Its mesh
is ``device`` alone, or with ``PTPU_SHARD=1`` the local devices: each batch
then splits on dim 0, every device runs the whole step on its rows, with
its own replica of the resident genome, and each shard's outputs go
straight into its rows of the batch's host outputs.

Each batch is one asynchronous dispatch: its slot's arrays are copied into
pinned staging buffers (so the slot, which stays frozen only until its
``ptscan_post_results`` call, is free as soon as ``dispatch`` returns), and
on each shard's stream the copy to the card, one CUDA graph replay of the
step compiled for its kind and bucket (``models/compiled.py``) and the
copy of its outputs into pinned host buffers are queued without a wait.
``post`` waits on the batch's events.  Every slot is ``batch_size`` rows,
so each kind and bucket is one shape and one graph per shard.
"""

from __future__ import annotations

import collections
import ctypes
import json
import logging
import os
import subprocess
import threading

import numpy as np
import torch

from portello_tpu_torch.kernels import _cuda
from portello_tpu_torch.kernels.bgzf_deflate import writer_cards
from portello_tpu_torch.kernels.resident import (
    build_global_ref,
    split_global_base,
)
from portello_tpu_torch.models.compiled import StepCache, compiled_steps_line
from portello_tpu_torch.models.pipeline_model import (
    DEFAULT_BUCKETS,
    bucket_kwargs,
)
from portello_tpu_torch.parallel.mesh import (
    replicate,
    sharded_step,
    sharding_mesh,
)
from portello_tpu_torch.pipeline.read_scan import get_alignment_file_header
from portello_tpu_torch.utils.spans import MAIN, CallSpans

logger = logging.getLogger("portello-tpu")


_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "io", "native", "ptscan.cc")
_SO = os.path.join(_HERE, "..", "_build", "native", "ptscan.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None
# the stats dict of the last scan_and_remap_reads_native run in this process
_last_stats: dict = {}
# the scanner's phases in ptscan_timing's order, the stats' t_native_<phase>
NATIVE_PHASES = ("read", "prepare", "fill", "drain", "post", "shift",
                 "finish_enc", "fin_encode", "fin_write")


class _BatchDesc(ctypes.Structure):
    _fields_ = [
        ("bucket", ctypes.c_longlong),
        ("is_rev", ctypes.c_longlong),
        ("count", ctypes.c_longlong),
        ("ops", ctypes.POINTER(ctypes.c_int32)),
        ("lens", ctypes.POINTER(ctypes.c_int32)),
        ("n_ops", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int32)),
        ("bk", ctypes.POINTER(ctypes.c_int32)),
        ("bv", ctypes.POINTER(ctypes.c_int32)),
        ("nb", ctypes.POINTER(ctypes.c_int32)),
        ("ref_win", ctypes.POINTER(ctypes.c_uint8)),
        ("ref_base", ctypes.POINTER(ctypes.c_int32)),
        ("read_seq", ctypes.POINTER(ctypes.c_uint8)),
        ("contig_win", ctypes.POINTER(ctypes.c_uint8)),
        ("win_base", ctypes.POINTER(ctypes.c_int32)),
        # resident slot mode only (null otherwise)
        ("read_packed", ctypes.POINTER(ctypes.c_uint8)),
        ("ref_chrom", ctypes.POINTER(ctypes.c_int32)),
    ]


class _P1Out(ctypes.Structure):
    """Flattened phase-1 walk results (ptscan.cc PtscanP1Out)."""

    _fields_ = [
        ("n_rec", ctypes.c_longlong),
        ("rec", ctypes.POINTER(ctypes.c_int64)),
        ("n_seg", ctypes.c_longlong),
        ("seg", ctypes.POINTER(ctypes.c_int64)),
        ("cig", ctypes.POINTER(ctypes.c_int64)),
        ("n_cig", ctypes.c_longlong),
        ("bmk", ctypes.POINTER(ctypes.c_int64)),
        ("bmv", ctypes.POINTER(ctypes.c_int64)),
        ("n_bm", ctypes.c_longlong),
        ("rev", ctypes.POINTER(ctypes.c_uint8)),
        ("n_rev", ctypes.c_longlong),
        ("qname", ctypes.POINTER(ctypes.c_uint8)),
        ("n_qname", ctypes.c_longlong),
    ]


def i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


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


def bind_lib(so_path: str):
    """Load a prebuilt ptscan shared object and set its prototypes (no
    rebuild — e.g. a sanitizer-instrumented build; scripts/tsan_native.py)."""
    lib = ctypes.CDLL(so_path)
    lib.ptscan_create.restype = ctypes.c_void_p
    lib.ptscan_next_batch.restype = ctypes.c_int
    lib.ptscan_next_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(_BatchDesc)]
    lib.ptscan_post_results.restype = ctypes.c_int
    lib.ptscan_error.restype = ctypes.c_char_p
    lib.ptscan_error.argtypes = [ctypes.c_void_p]
    lib.ptscan_finish.restype = ctypes.c_int
    lib.ptscan_finish.argtypes = [ctypes.c_void_p]
    lib.ptscan_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    lib.ptscan_timing.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    lib.ptscan_counters.restype = ctypes.c_char_p
    lib.ptscan_counters.argtypes = [ctypes.c_void_p]
    lib.ptscan_destroy.argtypes = [ctypes.c_void_p]
    # push-mode reader (direct CRAM streaming)
    lib.ptio_reader_open_push.restype = ctypes.c_void_p
    lib.ptio_reader_open_push.argtypes = [ctypes.c_longlong]
    lib.ptio_reader_push.restype = ctypes.c_int
    lib.ptio_reader_push.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong
    ]
    lib.ptio_reader_push_eof.argtypes = [ctypes.c_void_p]
    lib.ptio_reader_push_close.argtypes = [ctypes.c_void_p]
    lib.ptio_reader_close.argtypes = [ctypes.c_void_p]
    # phase-1 per-record walk (contig_scan native path)
    lib.ptscan_p1_create.restype = ctypes.c_void_p
    lib.ptscan_p1_create.argtypes = [
        ctypes.c_longlong, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.ptscan_p1_process.restype = ctypes.c_int
    lib.ptscan_p1_process.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
    ]
    lib.ptscan_p1_results.argtypes = [ctypes.c_void_p, ctypes.POINTER(_P1Out)]
    lib.ptscan_p1_error.restype = ctypes.c_char_p
    lib.ptscan_p1_error.argtypes = [ctypes.c_void_p]
    lib.ptscan_p1_destroy.argtypes = [ctypes.c_void_p]
    # the card's BGZF compressor on the host, and a writer that deflates
    # through a card (kernels/bgzf_deflate.py; tests)
    lib.ptio_bgzf_deflate_plain.restype = ctypes.c_int
    lib.ptio_bgzf_deflate_plain.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.ptio_bgzf_search_visits.restype = ctypes.c_longlong
    lib.ptio_bgzf_search_visits.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptio_bgzf_host_card.restype = ctypes.c_void_p
    lib.ptio_bgzf_host_card.argtypes = [ctypes.c_int]
    lib.ptio_bgzf_host_card_free.argtypes = [ctypes.c_void_p]
    lib.ptio_bgzf_host_card_fail.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptio_bgzf_host_card_calls.restype = ctypes.c_int
    lib.ptio_bgzf_host_card_calls.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
    ]
    lib.ptio_writer_open_card.restype = ctypes.c_void_p
    lib.ptio_writer_open_card.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ptio_writer_open.restype = ctypes.c_void_p
    lib.ptio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.ptio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
    lib.ptio_writer_close.restype = ctypes.c_int
    lib.ptio_writer_close.argtypes = [ctypes.c_void_p]
    # seq nibble codec debug surface (tests/test_simd_codecs.py)
    lib.ptscan_dbg_seqcodec.restype = None
    lib.ptscan_dbg_seqcodec.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
    ]
    return lib


def get_lib():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        # sanitizer runs: bind a prebuilt instrumented library for the WHOLE
        # process (incl. pytest), bypassing the staleness rebuild that would
        # silently swap in an uninstrumented build
        override = os.environ.get("PTPU_PTSCAN_SO")
        if override:
            _lib = bind_lib(override)
            return _lib
        deps = [_SRC,
                os.path.join(os.path.dirname(_SRC), "ptio.cc"),
                os.path.join(os.path.dirname(_SRC), "ptcore.cc"),
                os.path.join(_HERE, "..", "csrc", "bgzf_deflate.h")]
        if not os.path.exists(_SO) or any(
            os.path.getmtime(d) > os.path.getmtime(_SO) for d in deps
        ):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        _lib = bind_lib(_SO)
        return _lib


def build_error() -> str | None:
    return _build_error


def _flat_index(contig_list, all_info):
    """Flatten the phase-1 contig index into the ptscan struct-of-arrays."""
    n = len(contig_list.data)
    contig_len = np.array([c.length for c in contig_list.data], np.int64)
    names = [c.label for c in contig_list.data]
    name_cat = "".join(names).encode()
    name_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(x) for x in names], out=name_off[1:])

    seg_off = np.zeros(n + 1, np.int64)
    seg_chrom, seg_pos, seg_fwd, seg_mapq = [], [], [], []
    so_start, so_end = [], []
    bm_lens = []
    bm_keys_parts, bm_vals_parts = [], []
    rc_off = np.zeros(n + 1, np.int64)
    rc_parts = []
    for ci in range(n):
        info = all_info[ci]
        segs = info.ordered_contig_segment_info
        seg_off[ci + 1] = seg_off[ci] + len(segs)
        for si in segs:
            seg = si.seq_order_segment
            seg_chrom.append(seg.chrom_index)
            seg_pos.append(seg.pos)
            seg_fwd.append(1 if seg.is_fwd_strand else 0)
            seg_mapq.append(seg.mapq)
            so_start.append(seg.seq_order_read_start)
            so_end.append(seg.seq_order_read_end)
            bm = si.contig_to_ref_map
            bm_lens.append(len(bm))
            bm_keys_parts.append(np.asarray(bm.keys, np.int64))
            bm_vals_parts.append(np.asarray(bm.vals, np.int64))
        rc = info.rev_contig_seq
        rc_parts.append(
            np.asarray(rc, np.uint8) if rc is not None else np.zeros(0, np.uint8)
        )
        rc_off[ci + 1] = rc_off[ci] + len(rc_parts[-1])

    s_total = int(seg_off[-1])
    bm_off = np.zeros(s_total + 1, np.int64)
    np.cumsum(bm_lens, out=bm_off[1:])
    return {
        "n": n,
        "contig_len": contig_len,
        "name_cat": name_cat,
        "name_off": name_off,
        "seg_off": seg_off,
        "seg_chrom": np.array(seg_chrom, np.int32),
        "seg_pos": np.array(seg_pos, np.int64),
        "seg_fwd": np.array(seg_fwd, np.uint8),
        "seg_mapq": np.array(seg_mapq, np.int32),
        "so_start": np.array(so_start, np.int64),
        "so_end": np.array(so_end, np.int64),
        "bm_off": bm_off,
        "bm_keys": (
            np.concatenate(bm_keys_parts) if bm_keys_parts else np.zeros(0, np.int64)
        ),
        "bm_vals": (
            np.concatenate(bm_vals_parts) if bm_vals_parts else np.zeros(0, np.int64)
        ),
        "rc_off": rc_off,
        "rc_bytes": (
            np.concatenate(rc_parts) if rc_parts else np.zeros(0, np.uint8)
        ),
    }


def create_scanner(
    lib,
    read_bam: str,
    remapped_out: str,
    unassembled_out: str,
    header: bytes,
    reference,
    ref_chrom_list,
    contig_list,
    all_contig_mapping_info,
    buckets,
    batch_size: int,
    is_target_region: bool,
    shard_plan,
    thread_count: int,
    push_reader=None,
    resident: bool = False,
    cards=None,
):
    """Marshal the phase-1 index + config and call ``ptscan_create``.

    The single owner of the 37-positional-argument ABI (also used by the
    jax-free TSAN harness, scripts/tsan_native.py).  Returns ``(handle,
    keepalive)`` — the C++ scanner keeps RAW POINTERS into the index and
    reference arrays, so the caller must hold ``keepalive`` (and the
    ``reference`` list) alive until ``ptscan_destroy``.

    ``resident``: emit resident-mode slots (packed read rows + ref chrom
    index; no ref_win/read_seq tables) — kernels/resident.py.  The C++ side
    additionally requires host-shift routing and silently falls back to
    table slots under PTPU_HOST_SHIFT=0; the feed mirrors that condition.

    ``cards``: the two writers' codecs on the card
    (``kernels.bgzf_deflate.writer_cards``); None deflates on the host.
    """
    idx = _flat_index(contig_list, all_contig_mapping_info)

    ref_names = [c.label for c in ref_chrom_list.data]
    ref_name_cat = "".join(ref_names).encode()
    ref_name_off = np.zeros(len(ref_names) + 1, np.int64)
    np.cumsum([len(x) for x in ref_names], out=ref_name_off[1:])
    ref_arrays = [np.ascontiguousarray(r, dtype=np.uint8) for r in reference]
    ref_ptrs = (ctypes.c_void_p * len(ref_arrays))(
        *[r.ctypes.data_as(ctypes.c_void_p).value for r in ref_arrays]
    )
    ref_lens = np.array([len(r) for r in ref_arrays], np.int64)

    bucket_dims = np.array(
        [
            [b.max_ops, b.max_blocks, b.max_seq, b.resolved_max_rows()]
            for b in buckets
        ],
        np.int64,
    ).ravel()

    owned = None
    owned_ptr = None
    emit_unmapped = 1
    if shard_plan is not None:
        owned = np.array(
            [1 if shard_plan.owns(t) else 0 for t in range(len(contig_list.data))],
            np.uint8,
        )
        owned_ptr = owned.ctypes.data_as(ctypes.c_void_p)
        emit_unmapped = 1 if shard_plan.host_id == 0 else 0

    # Deflate is the dominant host cost at long read lengths (round-3
    # profile: ~2/3 of host feed time), so the BGZF pool gets the full
    # thread budget — the pool threads park when idle, and prep/fill are
    # bursty.  (The reference gives htslib threads/2; this is a deliberate
    # rebalance, not parity.)
    writer_threads = max(1, thread_count)
    level = 0 if remapped_out == "-" else 6


    lib.ptscan_create.argtypes = []  # bypass strict typing; pass explicit ctypes
    h = lib.ptscan_create(
        read_bam.encode(), remapped_out.encode(),
        unassembled_out.encode(),
        ctypes.cast(ctypes.c_char_p(header), ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_longlong(len(header)),
        ctypes.c_int(level), ctypes.c_int(writer_threads),
        ctypes.c_longlong(idx["n"]), i64p(idx["contig_len"]),
        ctypes.c_char_p(idx["name_cat"]), i64p(idx["name_off"]),
        ctypes.c_longlong(len(ref_names)), ctypes.c_char_p(ref_name_cat),
        i64p(ref_name_off), ref_ptrs, i64p(ref_lens),
        i64p(idx["seg_off"]), i32p(idx["seg_chrom"]), i64p(idx["seg_pos"]),
        u8p(idx["seg_fwd"]), i32p(idx["seg_mapq"]), i64p(idx["so_start"]),
        i64p(idx["so_end"]), i64p(idx["bm_off"]), i64p(idx["bm_keys"]),
        i64p(idx["bm_vals"]), i64p(idx["rc_off"]), u8p(idx["rc_bytes"]),
        ctypes.c_longlong(len(buckets)), i64p(bucket_dims),
        ctypes.c_longlong(batch_size), ctypes.c_int(1 if is_target_region else 0),
        owned_ptr if owned_ptr is not None else ctypes.c_void_p(None),
        ctypes.c_int(emit_unmapped), ctypes.c_int(max(1, thread_count)),
        push_reader if push_reader is not None else ctypes.c_void_p(None),
        ctypes.c_int(1 if resident else 0),
        cards if cards is not None else ctypes.c_void_p(None),
    )
    h = ctypes.c_void_p(h)
    if not h:
        raise RuntimeError("ptscan_create failed")
    keepalive = (idx, header, ref_name_cat, ref_name_off, ref_arrays,
                 ref_ptrs, ref_lens, bucket_dims, owned)
    return h, keepalive


def _as_np(ptr, shape, dtype):
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(int(np.prod(shape)) * np.dtype(dtype).itemsize,),
    ).view(dtype).reshape(shape)


class _FeederAborted(RuntimeError):
    """The consumer closed the push stream under the producer (the scanner
    hit its own error first; that error is the one to surface)."""


def _cram_feeder(lib, push_handle, cram_path, reference, state,
                 chunk_bytes=1 << 20, fetch_plan=None,
                 include_unmapped=True):
    """Producer thread: decode CRAM records and push uncompressed BAM bytes
    into the native scanner (direct streaming — replaces the temp-BAM
    transcode; the reference streams CRAM through htslib,
    read_alignment_scanner.rs:382-394).

    ``fetch_plan``: optional list of (tid, end) contig ranges — used for
    contig-shard (multi-process) runs, where this process lifts only reads
    whose primary alignment is on an owned contig: the feeder then serves
    those contigs by .crai slice seek (plus, when ``include_unmapped``, the
    unmapped section), touching only the indexed containers and decoding
    each shared multi-reference container at most once (fetch_many)."""
    import struct as _struct

    from portello_tpu_torch.io.cram import CramReader

    try:
        buf = bytearray()

        def flush():
            if not buf:
                return
            data = bytes(buf)
            if lib.ptio_reader_push(push_handle, data, len(data)) != 0:
                raise _FeederAborted("push stream closed by consumer")
            buf.clear()

        with CramReader(cram_path, reference=reference) as r:
            buf += r.header.encode()
            if fetch_plan is not None:
                def _records():
                    yield from r.fetch_many(fetch_plan)
                    if include_unmapped:
                        yield from r.fetch_unmapped()

                source = _records()
            else:
                source = r
            for rec in source:
                blob = rec.encode()
                buf += _struct.pack("<i", len(blob)) + blob
                if len(buf) >= chunk_bytes:
                    flush()
            flush()
        lib.ptio_reader_push_eof(push_handle)
    except BaseException as e:  # noqa: BLE001 — surfaced by the main thread
        state["exc"] = e
        # no EOF: a clean EOF at a record boundary would silently truncate;
        # close instead so the scanner stops and the main thread re-raises
        lib.ptio_reader_push_close(push_handle)


def _grab(ptr, bs: int, cols: int, dtype=np.int32) -> np.ndarray:
    return _as_np(ptr, (bs, cols) if cols else (bs,), dtype)


def _cigar_arrays(d, bcfg, bs: int) -> tuple[np.ndarray, ...]:
    """The slot's cigars and block maps, the first seven inputs of both
    forward steps."""
    return (
        _grab(d.ops, bs, bcfg.max_ops), _grab(d.lens, bs, bcfg.max_ops),
        _grab(d.n_ops, bs, 0), _grab(d.pos, bs, 0),
        _grab(d.bk, bs, bcfg.max_blocks), _grab(d.bv, bs, bcfg.max_blocks),
        _grab(d.nb, bs, 0),
    )


def _slot_arrays(d, bcfg, bs: int) -> tuple[np.ndarray, ...]:
    """A table slot's arrays, fwd_batch's positional inputs."""
    return _cigar_arrays(d, bcfg, bs) + (
        _grab(d.ref_win, bs, bcfg.max_seq, np.uint8),
        _grab(d.ref_base, bs, 0),
        _grab(d.read_seq, bs, bcfg.max_seq, np.uint8),
    )


def _rev_slot_arrays(d, bcfg, bs: int) -> tuple[np.ndarray, ...]:
    """A reverse table slot's arrays, rev_batch's positional inputs: a table
    slot's, with each item's window base (B,) int32 and reversed-contig
    window (B, max_seq) uint8 after its position."""
    table = _slot_arrays(d, bcfg, bs)
    rev = (
        _grab(d.win_base, bs, 0),
        _grab(d.contig_win, bs, bcfg.max_seq, np.uint8),
    )
    return table[:4] + rev + table[4:]


def _resident_slot_arrays(d, bcfg, bs: int, goff: np.ndarray
                          ) -> tuple[np.ndarray, ...]:
    """A resident slot's arrays, fwd_batch_resident's positional inputs
    without the genome.

    A resident slot has no ref-window or read tables (null pointers); its
    packed read rows and reference chromosome index are read instead, and
    each item's global base ``goff[ref_chrom] + ref_base`` is split into
    (superblock, residue) here on the host."""
    ref_base = _grab(d.ref_base, bs, 0)
    ref_chrom = _grab(d.ref_chrom, bs, 0)
    g_sb, g_off = split_global_base(goff[ref_chrom] + ref_base.astype(np.int64))
    return _cigar_arrays(d, bcfg, bs) + (
        g_sb, g_off, ref_base,
        _grab(d.read_packed, bs, (bcfg.max_seq + 1) // 2, np.uint8),
    )


def host_shift_routing() -> bool:
    """The native feed's routing, read exactly as its C++ scanner reads it
    (``ptscan_create`` in ``io/native/ptscan.cc``): device-shift routing when
    ``PTPU_HOST_SHIFT`` is set and starts with ``0`` (``0``, ``00`` and
    ``0x`` alike), host-shift routing otherwise.

    The scanner picks its slot kind and emits reverse batches on its own
    reading, so the feed must agree with it to the character: where it read
    ``00`` as host-shift, it asked for resident slots that the scanner never
    filled.  The Python feed's ``DeviceEngine`` keeps the JAX package's
    reading, ``!= "0"`` (``models/pipeline_model.py``): no C++ reads the
    switch on that path, and there it agrees with the JAX ``DeviceEngine``."""
    return not os.environ.get("PTPU_HOST_SHIFT", "").startswith("0")


def resident_mode() -> bool:
    """Resident slot mode unless ``PTPU_RESIDENT=0``, and only under
    host-shift routing: the reverse step reads table slots, so the scanner
    emits table slots under device-shift routing, as in the JAX package.
    ``1`` forces it and is the default here; any other value is read as
    unset, as the JAX package reads it."""
    return os.environ.get("PTPU_RESIDENT", "") != "0" and host_shift_routing()


def _cram_fetch_plan(cram_path: str, contig_list, shard_plan):
    """The (tid, end) ranges of a shard's owned contigs, for the CRAM
    feeder's .crai slice seeks; None (read the whole file) for an unsharded
    run or a CRAM without an index.

    Ownership is keyed on the primary record's tid, the scanner's own test,
    so fetching only the owned contigs is sound.  ``--target-region`` does
    not narrow the fetch: a primary on a contig outside the region can carry
    a supplementary alignment into it."""
    if shard_plan is None:
        return None
    from portello_tpu_torch.io.crai import CraiIndex

    try:
        CraiIndex.load(cram_path)
    except FileNotFoundError:
        return None
    plan = [
        (ci, c.length) for ci, c in enumerate(contig_list.data)
        if shard_plan.owns(ci)
    ]
    logger.info(
        "Serving this shard's CRAM reads by .crai slice seek over "
        f"{len(plan)} owned contigs"
    )
    return plan


def scan_and_remap_reads_native(
    read_to_assembly_bam: str,
    remapped_read_output: str,
    unassembled_read_output: str,
    reference,
    ref_chrom_list,
    all_contig_mapping_info,
    is_target_region: bool,
    device: torch.device,
    cmdline: str = "",
    batch_size: int = 512,
    buckets=None,
    thread_count: int = 1,
    cram_reference=None,
    shard_plan=None,
    *,
    spans: CallSpans,
    log_timing: bool = False,
) -> dict:
    """Native-feed phase 2 on ``device``; returns the stats dict, which it
    also leaves in the module's ``_last_stats``: the JAX package's keys (the
    item counts, ``t_prep``, ``t_dev`` and ``t_post`` in seconds, and the
    scanner's ``t_native_<phase>``) and the port's own (slot mode, H2D
    bytes, kernel launches, shards), with the call's trace:

    - ``spans``, ``call_id`` and ``clock_offset_ns`` of ``spans`` (the
      caller's ``utils.spans.CallSpans``, whose open phase this run ends),
      with the run's spans added:
      ``startup.genome_build``, ``startup.genome_upload``,
      ``startup.scanner``, the ``feed`` phase (per batch
      ``feed.next_batch``, ``dispatch.submit`` with ``dispatch.capture``
      where a graph is captured, ``dispatch.wait``, ``post.intake``), the
      ``finish`` phase (``finish.scanner``, ``finish.destroy``), and the
      native threads' ``producer``, ``producer.first_slot``, ``finisher``,
      ``writer.close.remapped`` and ``writer.close.unassembled``;
    - ``wait_s`` and ``waits``: seconds and count of the native waits that
      blocked, by ``"<site>@<role>"``;
    - ``cpu_s``: CPU seconds by thread role, ``spans.cpu_s`` (the native
      threads' here, the main thread's when the caller closes the call);
    - ``host_lift_s``: seconds in the exact host path, by call site
      (``prep``, ``post``);
    - ``deflate_blocks``: the two writers' BGZF blocks deflated on the card
      and on the host (``{"card": n, "host": n}``), and ``deflate_launches``,
      the card's launches: on ``cuda`` the writers deflate there
      (``kernels/bgzf_deflate.py``), each level-6 writer through one codec
      thread whose waits for the card count as ``card_deflate done@deflate``.

    The list and the ``cpu_s`` dict are the recorder's own, so what the
    caller records after the run returns reaches the stats.
    ``log_timing`` logs the timers and the native split (``--profile``).

    Raises RuntimeError when the native library is unavailable.  CRAM input
    streams directly: a producer thread decodes records and pushes
    uncompressed BAM bytes into the scanner.  ``shard_plan`` (a
    ``parallel.distributed.HostShardPlan``) restricts the run to the reads
    whose primary alignment is on the host's contigs, and the unassembled
    reads to host 0; a CRAM input is then read by .crai slice seek over the
    owned contigs only."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"ptscan unavailable: {build_error()}")

    from portello_tpu_torch.io.aln_input import is_cram_file
    from portello_tpu_torch.utils.chrom_list import ChromList
    from portello_tpu_torch.utils.progress import ProgressReporter

    logger.info(
        f"Processing read-to-contig alignment file '{read_to_assembly_bam}' "
        f"(native feed, torch device {device})"
    )
    contig_list = ChromList.from_bam_filename(read_to_assembly_bam)
    buckets = list(buckets if buckets is not None else DEFAULT_BUCKETS)
    header = get_alignment_file_header(ref_chrom_list, cmdline).encode()

    resident = resident_mode()
    if not host_shift_routing():
        logger.info(
            f"Device-shift routing (PTPU_HOST_SHIFT="
            f"{os.environ['PTPU_HOST_SHIFT']}): reverse-contig batches run "
            "rev_batch; table slots"
        )
    # Data parallelism over the local devices (PTPU_SHARD=1): each batch
    # splits on dim 0 over the mesh, with no collectives.  Only local
    # devices: each host feeds its own batches.  Without it the mesh is
    # ``device`` alone.
    mesh = sharding_mesh(device, batch_size)
    if mesh is not None:
        logger.info(f"Sharding batches over {len(mesh)} local devices")
    mesh = mesh or [torch.device(device)]
    genomes = res_goff = None
    if resident:
        # the genome goes to the device once and stays there for the run;
        # under sharding, once to each distinct device of the mesh
        with spans.span("startup.genome_build") as built:
            words, res_goff = build_global_ref(reference)
        with spans.span("startup.genome_upload") as uploaded:
            genomes = replicate(mesh, words)
            for g in genomes:
                if g.is_cuda:
                    torch.cuda.synchronize(g.device)
        logger.info(
            f"Resident genome: {words.nbytes / 2**20:.1f} MiB on "
            f"{', '.join(sorted({str(g.device) for g in genomes}))} "
            f"(built in {spans.seconds(built):.2f} s, uploaded in "
            f"{spans.seconds(uploaded):.2f} s); packed read rows"
        )

    push_handle = None
    feeder = None
    feeder_state: dict = {}
    if is_cram_file(read_to_assembly_bam):
        logger.info("Streaming CRAM input directly into the native scanner")
        fetch_plan = _cram_fetch_plan(read_to_assembly_bam, contig_list,
                                      shard_plan)
        push_handle = ctypes.c_void_p(lib.ptio_reader_open_push(0))
        feeder = threading.Thread(
            target=_cram_feeder,
            args=(lib, push_handle, read_to_assembly_bam, cram_reference,
                  feeder_state),
            kwargs={"fetch_plan": fetch_plan,
                    "include_unmapped": shard_plan is None
                    or shard_plan.host_id == 0},
            name="cram-feeder",
            daemon=True,
        )
        feeder.start()

    try:
        with spans.span("startup.scanner"):
            cards = writer_cards(torch.device(device))
            h, _keepalive = create_scanner(
                lib, read_to_assembly_bam, remapped_read_output,
                unassembled_read_output, header, reference, ref_chrom_list,
                contig_list, all_contig_mapping_info, buckets, batch_size,
                is_target_region, shard_plan, thread_count,
                push_reader=push_handle, resident=resident, cards=cards,
            )
    except BaseException:
        # create failed: the scanner did not take reader ownership; after
        # push_close the feeder's next push fails, so the join is bounded
        if push_handle is not None:
            lib.ptio_reader_push_close(push_handle)
            feeder.join()
            lib.ptio_reader_close(push_handle)
            exc = feeder_state.get("exc")
            if exc is not None and not isinstance(exc, _FeederAborted):
                raise exc from None
        raise

    genome_kb = sum(ci.length for ci in contig_list.data) // 1000
    cum_len = np.zeros(len(contig_list.data) + 1, np.int64)
    np.cumsum([ci.length for ci in contig_list.data], out=cum_len[1:])
    progress = ProgressReporter(
        genome_kb, "Remapped read alignments from", "assembly contig kb"
    )
    stats_buf = (ctypes.c_longlong * 6)()
    timing_buf = (ctypes.c_longlong * 9)()
    desc = _BatchDesc()
    n_batches = n_rev = 0
    h2d_bytes = h2d_rev = 0
    per_bucket = [0] * len(buckets)
    launches_before = dict(_cuda.launch_counts)
    # Up to 2 dispatched batches outstanding; post_results resolves batches
    # in emission order (the C++ side queues them FIFO).
    in_flight: collections.deque = collections.deque()

    # The compiled steps of this run (one CUDA graph per step kind, bucket
    # and mesh position) and their staging buffers; freed with the run.
    cache = StepCache()

    def dispatch(d):
        nonlocal h2d_bytes, h2d_rev, n_rev
        bcfg = buckets[int(d.bucket)]
        per_bucket[int(d.bucket)] += 1
        # fixed shape: slots are always batch_size rows (EOF partials are
        # pre-padded by the C++ side)
        if d.is_rev:
            if resident:
                raise RuntimeError(
                    "native feed emitted a reverse batch in resident slot mode"
                )
            kind, args = "rev", _rev_slot_arrays(d, bcfg, batch_size)
        elif resident:
            kind = "fwd_resident"
            args = _resident_slot_arrays(d, bcfg, batch_size, res_goff)
        else:
            kind, args = "fwd", _slot_arrays(d, bcfg, batch_size)
        step = sharded_step(cache, kind, mesh, batch_size, bucket_kwargs(bcfg),
                            genomes if resident else None)
        # the slot's arrays are copied into the step's staging buffers
        # before submit returns; the copies to the device, the replays and
        # the copies back are queued, not waited on
        captured = len(cache.graphs())
        handle = step.submit(*args)
        for g in cache.graphs()[captured:]:
            if g.capture_ns is not None:
                spans.add("dispatch.capture", *g.capture_ns)
        nbytes = sum(a.nbytes for a in args)
        h2d_bytes += nbytes
        if d.is_rev:
            n_rev += 1
            h2d_rev += nbytes
        return handle

    def post(handle):
        with spans.span("dispatch.wait"):
            host = handle.wait()
            codes = np.ascontiguousarray(host["codes"], np.int32)
            olens = np.ascontiguousarray(host["lens"], np.int32)
            n_out = np.ascontiguousarray(host["n_out"], np.int32)
            opos = np.ascontiguousarray(host["ref2_pos"], np.int32)
            mapped = host["mapped"].astype(np.uint8)
            fallback = host["fallback"].astype(np.uint8)
            read_len = host["read_len"].astype(np.int64)
        with spans.span("post.intake"):
            rc = lib.ptscan_post_results(
                h, i32p(codes), i32p(olens), i32p(n_out), i32p(opos),
                u8p(mapped), u8p(fallback), i64p(read_len),
                ctypes.c_longlong(codes.shape[1]),
            )
        if rc < 0:
            raise RuntimeError(lib.ptscan_error(h).decode())

    try:
        in_feed = spans.phase("feed")
        while True:
            with spans.span("feed.next_batch"):
                rc = lib.ptscan_next_batch(h, ctypes.byref(desc))
            if rc < 0:
                raise RuntimeError(lib.ptscan_error(h).decode())
            if rc == 0:
                break
            if rc == 2:  # EOF with results outstanding: drain one, retry
                post(in_flight.popleft())
                continue
            n_batches += 1
            with spans.span("dispatch.submit"):
                in_flight.append(dispatch(desc))
            if len(in_flight) >= 2:
                post(in_flight.popleft())
            lib.ptscan_stats(h, stats_buf)
            tid = int(stats_buf[5])
            if tid > 0:
                done = int(cum_len[tid]) // 1000
                progress.inc(max(done - progress.count, 0))
        while in_flight:
            post(in_flight.popleft())
        spans.phase("finish")

        if feeder is not None:
            feeder.join()
            if feeder_state.get("exc") is not None:
                raise feeder_state["exc"]

        with spans.span("finish.scanner") as in_scanner:
            rc = lib.ptscan_finish(h)
        if rc < 0:
            raise RuntimeError(lib.ptscan_error(h).decode())
        lib.ptscan_stats(h, stats_buf)
        lib.ptscan_timing(h, timing_buf)
        counters = json.loads(lib.ptscan_counters(h))
    except BaseException:
        if feeder is not None and feeder.is_alive():
            lib.ptio_reader_push_close(push_handle)
            feeder.join()
        exc = feeder_state.get("exc")
        if exc is not None and not isinstance(exc, _FeederAborted):
            raise exc from None
        raise
    finally:
        progress.clear()
        with spans.span("finish.destroy"):
            lib.ptscan_destroy(h)

    # the native threads' spans: the producer's inside the feed, the
    # finisher's across the feed and the finish (inside the call), and the
    # writers' closes, on the main thread, inside ptscan_finish
    where = {"producer": ("producer", in_feed),
             "finisher": ("finisher", spans.spans[in_feed][1]),
             "writer.close.remapped": (MAIN, in_scanner),
             "writer.close.unassembled": (MAIN, in_scanner)}
    producer = in_feed
    for name, t0, t1 in counters["spans"]:
        if name == "producer.first_slot":
            spans.add(name, t0, t1, "producer", producer)
        else:
            role, parent = where[name]
            i = spans.add(name, t0, t1, role, parent)
            if name == "producer":
                producer = i
    spans.cpu_s.update({r: ns / 1e9 for r, ns in counters["cpu_ns"].items()})
    timers = spans.seconds_by_name()
    t_prep = timers.get("feed.next_batch", 0.0)
    t_dev = timers.get("dispatch.submit", 0.0) + timers.get("dispatch.wait", 0.0)
    t_post = timers.get("post.intake", 0.0)

    stats = {
        "n_primary": int(stats_buf[0]),
        "device_items": int(stats_buf[1]),
        "host_items": int(stats_buf[2]),
        "fallback_items": int(stats_buf[3]),
        "n_unassembled": int(stats_buf[4]),
        "resident": resident,
        "rev_batches": n_rev,
        "h2d_bytes_per_batch": h2d_bytes // max(n_batches, 1),
        "h2d_bytes_per_rev_batch": h2d_rev // max(n_rev, 1),
        "batches_per_bucket": per_bucket,
        "kernel_launches": {
            k: v - launches_before[k] for k, v in _cuda.launch_counts.items()
        },
        "shards": len(mesh),
        **cache.stats(),
    }
    logger.info(
        f"Lifted {stats['n_primary']} primary reads: "
        f"{stats['device_items']} device work items, "
        f"{stats['host_items']} host items "
        f"({stats['fallback_items']} window/bucket fallbacks)"
    )
    logger.info(
        f"H2D per batch: {stats['h2d_bytes_per_batch']} bytes "
        f"({'resident' if resident else 'table'} slots, {n_batches} batches, "
        f"rev_batches {n_rev} of {stats['h2d_bytes_per_rev_batch']} bytes, "
        f"batches per bucket {per_bucket})"
    )
    logger.info(compiled_steps_line(stats, mesh, n_batches))
    deflated = counters["deflate_blocks"]
    logger.info(
        f"BGZF blocks: {deflated['card']} deflated on the card in "
        f"{counters['deflate_launches']} launches, {deflated['host']} on the "
        "host"
    )
    waits = counters["wait_ns"]
    stats.update({f"t_native_{n}": timing_buf[i] / 1e9
                  for i, n in enumerate(NATIVE_PHASES)})
    stats.update({
        "t_prep": t_prep, "t_dev": t_dev, "t_post": t_post,
        "wait_s": {k: ns / 1e9 for k, (ns, _) in waits.items()},
        "waits": {k: n for k, (_, n) in waits.items()},
        "cpu_s": spans.cpu_s,
        "host_lift_s": {k: ns / 1e9 for k, ns in counters["host_lift_ns"].items()},
        "deflate_blocks": deflated,
        "deflate_launches": counters["deflate_launches"],
        "spans": spans.spans,
        "call_id": spans.call_id,
        "clock_offset_ns": spans.clock_offset_ns,
    })
    if log_timing:
        logger.info(
            f"feed timing: prep {t_prep:.2f}s, device {t_dev:.2f}s, "
            f"finish {t_post:.2f}s over {n_batches} batches"
        )
        logger.info(
            "native phase split: "
            + ", ".join(f"{n} {stats[f't_native_{n}']:.3f}s" for n in NATIVE_PHASES)
            + "; waits: " + ", ".join(
                f"{k} {v:.3f}s x{stats['waits'][k]}"
                for k, v in sorted(stats["wait_s"].items()))
            + "; cpu: " + ", ".join(
                f"{k} {v:.3f}s" for k, v in spans.cpu_s.items())
        )
    global _last_stats
    _last_stats = stats
    return stats
