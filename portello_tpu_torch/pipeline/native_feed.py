"""Native phase-2 feed: the C++ read scanner (``ptscan.cc``) driving the
PyTorch device steps.

The scanner, its ctypes layer and the CRAM feeder are shared with
``portello_tpu.pipeline.native_feed``; only the dispatch loop is ported:

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

A slot stays frozen only until its ``ptscan_post_results`` call.  The H2D
copies here are plain pageable copies, which have consumed the slot when
``.to(device)`` returns.
"""

from __future__ import annotations

import collections
import ctypes
import logging
import os
import threading
import time

import numpy as np
import torch

from portello_tpu.pipeline.native_feed import (
    _as_np,
    _BatchDesc,
    _cram_feeder,
    _FeederAborted,
    build_error,
    create_scanner,
    get_lib,
    i32p,
    i64p,
    u8p,
)
from portello_tpu.pipeline.read_scan import get_alignment_file_header
from portello_tpu_torch.kernels import _cuda
from portello_tpu_torch.kernels.resident import (
    build_global_ref,
    genome_tensor,
    split_global_base,
)
from portello_tpu_torch.models.pipeline_model import (
    DEFAULT_BUCKETS,
    bucket_kwargs,
    fwd_batch,
    fwd_batch_resident,
    rev_batch,
)

logger = logging.getLogger("portello-tpu")


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


def _slot_tensors(d, bcfg, bs: int, device) -> tuple[torch.Tensor, ...]:
    """A table slot's arrays as fwd_batch's positional tensors on
    ``device``."""
    arrays = _cigar_arrays(d, bcfg, bs) + (
        _grab(d.ref_win, bs, bcfg.max_seq, np.uint8),
        _grab(d.ref_base, bs, 0),
        _grab(d.read_seq, bs, bcfg.max_seq, np.uint8),
    )
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _rev_slot_tensors(d, bcfg, bs: int, device) -> tuple[torch.Tensor, ...]:
    """A reverse table slot's arrays as rev_batch's positional tensors on
    ``device``: a table slot's, with each item's window base (B,) int32 and
    reversed-contig window (B, max_seq) uint8 after its position."""
    table = _slot_tensors(d, bcfg, bs, device)
    rev = (
        torch.from_numpy(_grab(d.win_base, bs, 0)).to(device),
        torch.from_numpy(_grab(d.contig_win, bs, bcfg.max_seq, np.uint8)).to(device),
    )
    return table[:4] + rev + table[4:]


def _resident_slot_tensors(d, bcfg, bs: int, device, goff: np.ndarray
                           ) -> tuple[torch.Tensor, ...]:
    """A resident slot's arrays as fwd_batch_resident's positional tensors
    (without the genome) on ``device``.

    A resident slot has no ref-window or read tables (null pointers); its
    packed read rows and reference chromosome index are read instead, and
    each item's global base ``goff[ref_chrom] + ref_base`` is split into
    (superblock, residue) here on the host."""
    ref_base = _grab(d.ref_base, bs, 0)
    ref_chrom = _grab(d.ref_chrom, bs, 0)
    g_sb, g_off = split_global_base(goff[ref_chrom] + ref_base.astype(np.int64))
    arrays = _cigar_arrays(d, bcfg, bs) + (
        g_sb, g_off, ref_base,
        _grab(d.read_packed, bs, (bcfg.max_seq + 1) // 2, np.uint8),
    )
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def host_shift_routing() -> bool:
    """Host-shift routing unless ``PTPU_HOST_SHIFT=0`` (the switch the C++
    scanner reads too)."""
    return os.environ.get("PTPU_HOST_SHIFT", "1") != "0"


def resident_mode() -> bool:
    """Resident slot mode unless ``PTPU_RESIDENT=0`` (``1``, the JAX
    package's switch to force it, is accepted and is the default here), and
    only under host-shift routing: the reverse step reads table slots, so
    the scanner emits table slots under ``PTPU_HOST_SHIFT=0``, as in the
    JAX package."""
    flag = os.environ.get("PTPU_RESIDENT", "")
    if flag not in ("", "0", "1"):
        raise ValueError(f"PTPU_RESIDENT must be 0 or 1, got {flag!r}")
    return flag != "0" and host_shift_routing()


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
) -> dict:
    """Native-feed phase 2 on ``device``; returns the stats dict.

    Raises RuntimeError when the native library is unavailable.  CRAM input
    streams directly: a producer thread decodes records and pushes
    uncompressed BAM bytes into the scanner."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"ptscan unavailable: {build_error()}")

    from portello_tpu.io.aln_input import is_cram_file
    from portello_tpu.utils.chrom_list import ChromList
    from portello_tpu.utils.progress import ProgressReporter

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
            "Device-shift routing (PTPU_HOST_SHIFT=0): reverse-contig batches "
            "run rev_batch; table slots"
        )
    genome = res_goff = None
    if resident:
        # the genome goes to the device once and stays there for the run
        t0 = time.perf_counter()
        words, res_goff = build_global_ref(reference)
        t1 = time.perf_counter()
        genome = genome_tensor(words, device)
        if genome.is_cuda:
            torch.cuda.synchronize(device)
        logger.info(
            f"Resident genome: {words.nbytes / 2**20:.1f} MiB on {device} "
            f"(built in {t1 - t0:.2f} s, uploaded in "
            f"{time.perf_counter() - t1:.2f} s); packed read rows"
        )

    push_handle = None
    feeder = None
    feeder_state: dict = {}
    if is_cram_file(read_to_assembly_bam):
        logger.info("Streaming CRAM input directly into the native scanner")
        push_handle = ctypes.c_void_p(lib.ptio_reader_open_push(0))
        feeder = threading.Thread(
            target=_cram_feeder,
            args=(lib, push_handle, read_to_assembly_bam, cram_reference,
                  feeder_state),
            name="cram-feeder",
            daemon=True,
        )
        feeder.start()

    try:
        h, _keepalive = create_scanner(
            lib, read_to_assembly_bam, remapped_read_output,
            unassembled_read_output, header, reference, ref_chrom_list,
            contig_list, all_contig_mapping_info, buckets, batch_size,
            is_target_region, None, thread_count,
            push_reader=push_handle, resident=resident,
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
    lib.ptscan_timing.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
    ]
    desc = _BatchDesc()
    t_prep = t_dev = t_post = 0.0
    n_batches = n_rev = 0
    h2d_bytes = h2d_rev = 0
    launches_before = dict(_cuda.launch_counts)
    # Up to 2 dispatched batches outstanding; post_results resolves batches
    # in emission order (the C++ side queues them FIFO).
    in_flight: collections.deque = collections.deque()

    def dispatch(d):
        nonlocal h2d_bytes, h2d_rev, n_rev
        bcfg = buckets[int(d.bucket)]
        # fixed shape: slots are always batch_size rows (EOF partials are
        # pre-padded by the C++ side)
        if d.is_rev:
            if resident:
                raise RuntimeError(
                    "native feed emitted a reverse batch in resident slot mode"
                )
            args = _rev_slot_tensors(d, bcfg, batch_size, device)
            out = rev_batch(*args, **bucket_kwargs(bcfg))
        elif resident:
            args = _resident_slot_tensors(d, bcfg, batch_size, device, res_goff)
            out = fwd_batch_resident(*args, genome, **bucket_kwargs(bcfg))
        else:
            args = _slot_tensors(d, bcfg, batch_size, device)
            out = fwd_batch(*args, **bucket_kwargs(bcfg))
        nbytes = sum(a.nbytes for a in args)
        h2d_bytes += nbytes
        if d.is_rev:
            n_rev += 1
            h2d_rev += nbytes
        return out

    def post(out):
        nonlocal t_dev, t_post
        t0 = time.perf_counter()
        host = {k: v.cpu().numpy() for k, v in out.items()}
        codes = np.ascontiguousarray(host["codes"], np.int32)
        olens = np.ascontiguousarray(host["lens"], np.int32)
        n_out = np.ascontiguousarray(host["n_out"], np.int32)
        opos = np.ascontiguousarray(host["ref2_pos"], np.int32)
        mapped = host["mapped"].astype(np.uint8)
        fallback = host["fallback"].astype(np.uint8)
        read_len = host["read_len"].astype(np.int64)
        t_dev += time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = lib.ptscan_post_results(
            h, i32p(codes), i32p(olens), i32p(n_out), i32p(opos),
            u8p(mapped), u8p(fallback), i64p(read_len),
            ctypes.c_longlong(codes.shape[1]),
        )
        if rc < 0:
            raise RuntimeError(lib.ptscan_error(h).decode())
        t_post += time.perf_counter() - t0

    try:
        while True:
            t0 = time.perf_counter()
            rc = lib.ptscan_next_batch(h, ctypes.byref(desc))
            t_prep += time.perf_counter() - t0
            if rc < 0:
                raise RuntimeError(lib.ptscan_error(h).decode())
            if rc == 0:
                break
            if rc == 2:  # EOF with results outstanding: drain one, retry
                post(in_flight.popleft())
                continue
            n_batches += 1
            t0 = time.perf_counter()
            in_flight.append(dispatch(desc))
            t_dev += time.perf_counter() - t0
            if len(in_flight) >= 2:
                post(in_flight.popleft())
            lib.ptscan_stats(h, stats_buf)
            tid = int(stats_buf[5])
            if tid > 0:
                done = int(cum_len[tid]) // 1000
                progress.inc(max(done - progress.count, 0))
        while in_flight:
            post(in_flight.popleft())

        if feeder is not None:
            feeder.join()
            if feeder_state.get("exc") is not None:
                raise feeder_state["exc"]

        if lib.ptscan_finish(h) < 0:
            raise RuntimeError(lib.ptscan_error(h).decode())
        lib.ptscan_stats(h, stats_buf)
        lib.ptscan_timing(h, timing_buf)
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
        lib.ptscan_destroy(h)

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
        "kernel_launches": {
            k: v - launches_before[k] for k, v in _cuda.launch_counts.items()
        },
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
        f"rev_batches {n_rev} of {stats['h2d_bytes_per_rev_batch']} bytes)"
    )
    if os.environ.get("PTPU_FEED_TIMING"):
        logger.info(
            f"feed timing: prep {t_prep:.2f}s, device {t_dev:.2f}s, "
            f"finish {t_post:.2f}s over {n_batches} batches"
        )
        names = ("read", "prepare", "fill", "drain", "post", "shift",
                 "finish_enc", "fin_encode", "fin_write")
        logger.info(
            "native phase split: "
            + ", ".join(f"{n} {v / 1e9:.3f}s" for n, v in zip(names, timing_buf))
        )
    return stats
