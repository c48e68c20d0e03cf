"""Coordinate-sort a BAM (external merge sort; `samtools sort` role).

The pipeline's output contract is unsorted (reference
docs/user_guide.md:63-77 tells users to pipe into `samtools sort`); this
companion tool completes that workflow inside the framework: chunked
in-memory sorts spilled to temporary BAMs, then a k-way raw-record merge
under a `SO:coordinate` header.  Sort key = (tid as unsigned — unmapped
tid=-1 last, pos, input order) — samtools' coordinate order with a stable
tie-break, so repeated runs are byte-deterministic.
"""

from __future__ import annotations

import argparse
import heapq
import os
import re
import struct
import sys
import tempfile

from portello_tpu_torch.io.bam import BamHeader, BamReader, BamWriter


def _key(raw: bytes) -> tuple[int, int]:
    tid, pos = struct.unpack_from("<ii", raw, 0)
    return (tid & 0xFFFFFFFF, pos)


def _coordinate_header(header: BamHeader) -> BamHeader:
    text = header.text.decode(errors="replace")
    if text.startswith("@HD"):
        line, _, rest = text.partition("\n")
        if "SO:" in line:
            line = re.sub(r"SO:\S+", "SO:coordinate", line)
        else:
            line += "\tSO:coordinate"
        text = line + "\n" + rest
    else:
        text = "@HD\tVN:1.6\tSO:coordinate\n" + text
    return BamHeader(text=text.encode(), refs=list(header.refs))


def sort_bam(
    input_path: str,
    output: str,
    n_threads: int = 1,
    mem_bytes: int = 512 << 20,
    tmp_dir: str | None = None,
) -> int:
    """Sort ``input_path`` into ``output`` ('-' = uncompressed stdout BAM).
    Returns the record count."""
    chunks: list[str] = []
    try:
        return _sort_bam_inner(
            input_path, output, n_threads, mem_bytes, tmp_dir, chunks
        )
    finally:
        # spilled temporaries must not outlive the call on ANY exit path
        # (truncated input mid-scan, Ctrl-C, merge failure)
        for c in chunks:
            if os.path.exists(c):
                os.remove(c)


def _composite_key(raw: bytes) -> int:
    """(tid unsigned, pos) as ONE uint64: (tid & 0xFFFFFFFF) << 32 |
    (pos + 1).  pos >= -1 in BAM, so pos+1 is an order-preserving unsigned
    mapping; a stable sort on this key reproduces the (utid, pos, input
    order) tuple sort byte-for-byte."""
    tid, pos = struct.unpack_from("<ii", raw, 0)
    return ((tid & 0xFFFFFFFF) << 32) | (pos + 1)


def _sort_chunk(keys):
    """Stable C-speed ordering of one chunk (numpy argsort over the
    composite key — the GIL-bound tuple sort was the serial bottleneck)."""
    import numpy as np

    return np.argsort(np.array(keys, dtype=np.uint64), kind="stable")


def _sort_bam_inner(input_path, output, n_threads, mem_bytes, tmp_dir, chunks):
    from concurrent.futures import ThreadPoolExecutor

    n = 0
    # Parallel chunk pipeline (the reference leaves sorting to samtools,
    # which fans out with -@; same role here): with threads, each spill's
    # sort + BGZF compression runs on a worker while the reader keeps
    # decoding the next chunk.  One spill in flight; the chunk budget is
    # halved so peak memory stays ~mem_bytes.
    async_spill = n_threads > 1
    chunk_budget = mem_bytes // 2 if async_spill else mem_bytes
    pool = ThreadPoolExecutor(max_workers=1) if async_spill else None
    pending = None
    try:
        with BamReader(input_path) as reader:
            header = _coordinate_header(reader.header)
            raws: list[bytes] = []
            keys: list[int] = []
            used = 0

            def do_spill(chunk_raws, chunk_keys):
                order = _sort_chunk(chunk_keys)
                fd, path = tempfile.mkstemp(
                    suffix=".bam", prefix="ptpu_sort_", dir=tmp_dir
                )
                os.close(fd)
                w = BamWriter(
                    path, header, level=1, n_threads=max(1, n_threads - 1)
                )
                try:
                    for i in order:
                        w.write_raw(chunk_raws[i])
                finally:
                    w.close()
                return path

            def spill():
                nonlocal raws, keys, used, pending
                if not raws:
                    return
                # chunks list stays in input order (merge-stability contract)
                if pending is not None:
                    chunks.append(pending.result())
                    pending = None
                if pool is not None:
                    pending = pool.submit(do_spill, raws, keys)
                else:
                    chunks.append(do_spill(raws, keys))
                raws = []
                keys = []
                used = 0

            for raw in reader.iter_raw():
                raws.append(raw)
                keys.append(_composite_key(raw))
                n += 1
                used += len(raw) + 64
                if used >= chunk_budget:
                    spill()

            dest = sys.stdout.buffer if output == "-" else output
            level = 0 if output == "-" else 6
            if not chunks and pending is None:
                # single in-memory chunk: write directly
                order = _sort_chunk(keys)
                w = BamWriter(dest, header, level=level, n_threads=n_threads)
                try:
                    for i in order:
                        w.write_raw(raws[i])
                finally:
                    w.close()
                return n
            spill()
            if pending is not None:
                chunks.append(pending.result())
                pending = None
    finally:
        if pending is not None:
            chunks.append(pending.result())
        if pool is not None:
            pool.shutdown(wait=True)

    readers = [BamReader(c) for c in chunks]
    try:
        # per-stream helper so each generator binds its own chunk index
        # (a nested genexp would late-bind the loop variable and tag every
        # stream with the last index, silently voiding the tie-break)
        def keyed(ci, r):
            return ((*_key(raw), ci, raw) for raw in r.iter_raw())

        streams = [keyed(ci, r) for ci, r in enumerate(readers)]
        w = BamWriter(dest, header, level=level, n_threads=n_threads)
        try:
            # heapq.merge is stable across equal keys in stream order, and
            # chunks were spilled in input order -> deterministic output
            for *_k, raw in heapq.merge(*streams, key=lambda t: t[:3]):
                w.write_raw(raw)
        finally:
            w.close()
    finally:
        for r in readers:
            r.close()
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="portello-tpu sort")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True, help="output BAM ('-' = stdout)")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument(
        "--mem-mb", type=int, default=512,
        help="in-memory chunk budget before spilling (MB)",
    )
    p.add_argument("--tmp-dir", default=None)
    args = p.parse_args(argv)
    n = sort_bam(
        args.input, args.output, n_threads=args.threads,
        mem_bytes=args.mem_mb << 20, tmp_dir=args.tmp_dir,
    )
    print(f"sorted {n} records", file=sys.stderr)


if __name__ == "__main__":
    main()
