"""Device-resident genome + packed read rows (resident slot mode).

Port of ``portello_tpu.kernels.resident``.  In resident slot mode the two
``(B, max_seq)`` byte tables of a table slot disappear: the whole genome
stays on the device for the run as one flat uint8 tensor, and each read
row travels packed as BAM nibbles, ``(B, ceil(max_seq / 2))`` uint8.

The numpy helpers (``build_global_ref``, ``split_global_base``,
``pack_seq_rows``) are copies of the JAX package's: that module imports jax.
On the device the port does not keep the JAX package's (superblock, residue)
int32 split or its barrel realign, which are TPU layout: ``global_base``
joins the split into an int64 byte offset and the genome is indexed
directly.  A GRCh38-sized genome is about 3.1 GB, so offsets pass 2^31.

The native feed does not go through ``build_global_ref``: ``alloc_genome``
lays the table out from the chromosome lengths alone (``genome_layout``) and
writes its pads on each device, and ``upload_genome`` copies each
chromosome into its place, on a card through a few pinned staging buffers
(``chunk_plan``), on the CPU by slice assignment.  The bytes are
``build_global_ref``'s, every one.

``ref_windows`` and ``read_windows_packed`` are the plain window fetches of
stage 4.  They equal ``fetch_ref_windows_global`` and
``fetch_read_windows_packed`` byte for byte, including what they read
outside the data: the genome fetch clamps to the table as the JAX fetch
does, and a packed byte outside the row is 0xFD, which widens to ``'N'`` at
an even base position and ``'D'`` at an odd one.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

SB = 64  # superblock bytes in the global reference table
SEQ_SYMBOLS = b"=ACMGRSVTWYHKDBN"  # BAM 4-bit code -> ASCII (ptscan kSeqChars)
_REF_PAD = ord("N")
PACKED_FILL = 0xFD  # packed byte read outside a row

# The card's genome goes up through one pinned buffer of STAGE_BYTES for
# each of STAGE_THREADS host threads.  On an H100's host the host's copies
# set the pace: four threads reach 25 GB/s of the link's 53, more gain
# under a tenth while taking the host's other cores, and buffers of 32 MiB
# or more were slower at every thread count.
STAGE_BYTES = 16 << 20
STAGE_THREADS = 4

# host-side ASCII -> BAM nibble code (total on the 16-symbol alphabet; read
# sequences are always inside it: BAM decode emits exactly these chars and
# ops.seq.rev_comp maps everything else to 'N')
_ENC_LUT = np.full(256, 15, np.uint8)
for _i, _c in enumerate(SEQ_SYMBOLS):
    _ENC_LUT[_c] = _i
    _ENC_LUT[ord(chr(_c).lower())] = _i


def build_global_ref(reference) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate the per-chrom reference arrays into the device-resident
    superblock table.

    Returns ``(words, goff)``: ``words`` is (NSB, SB/4) uint32 (the uint8
    table viewed as little-endian words — the layout the device fetch
    bitcasts back), ``goff`` is the int64 global BYTE offset of each chrom.
    Every chrom starts 64-aligned; one front pad superblock keeps index
    clamping trivially safe and two tail superblocks keep the +1 row of the
    last window in-table.
    """
    parts = [np.full(SB, _REF_PAD, np.uint8)]
    goff = np.zeros(len(reference), np.int64)
    off = SB
    for i, r in enumerate(reference):
        a = np.ascontiguousarray(r, dtype=np.uint8)
        goff[i] = off
        parts.append(a)
        pad = (-len(a)) % SB
        if pad:
            parts.append(np.full(pad, _REF_PAD, np.uint8))
        off += len(a) + pad
    parts.append(np.full(2 * SB, _REF_PAD, np.uint8))
    cat = np.concatenate(parts)
    return cat.reshape(-1, SB).view(np.uint32).copy(), goff


def genome_layout(lengths) -> tuple[np.ndarray, int]:
    """``build_global_ref``'s layout from the chromosome lengths alone: the
    int64 global byte offset of each chromosome and the table's bytes."""
    padded = -(-np.asarray(lengths, np.int64) // SB) * SB
    goff = np.empty(len(padded), np.int64)
    goff[:1] = SB
    np.cumsum(padded[:-1], out=goff[1:])
    goff[1:] += SB
    return goff, SB + int(padded.sum()) + 2 * SB


def pad_ranges(lengths, goff: np.ndarray, total: int) -> list[tuple[int, int]]:
    """The ``[start, stop)`` byte ranges of the table that hold no
    chromosome byte: the front pad superblock, each chromosome's tail pad
    up to its next 64-byte boundary, and the two tail superblocks."""
    ranges = [(0, SB)]
    for n, off in zip(lengths, goff.tolist()):
        if n % SB:
            ranges.append((off + n, off + n + (-n) % SB))
    ranges.append((total - 2 * SB, total))
    return ranges


def chunk_plan(lengths, goff: np.ndarray, chunk: int) -> list[tuple[int, int, int, int]]:
    """Each chromosome cut into copies of at most ``chunk`` bytes:
    ``(chromosome, source offset, destination offset, bytes)``, in table
    order.  Together they cover every chromosome byte once and no pad."""
    plan = []
    for c, (n, off) in enumerate(zip(lengths, goff.tolist())):
        for s in range(0, n, chunk):
            plan.append((c, s, off + s, min(chunk, n - s)))
    return plan


def alloc_genome(lengths, devices) -> tuple[np.ndarray, dict]:
    """The genome's build: its layout, one flat uint8 table on each distinct
    device of ``devices`` and the ``N`` of its pads.  Returns ``(goff,
    tables)``, ``tables`` by device; ``upload_genome`` writes the
    chromosomes.  A CPU table aliases a numpy buffer."""
    goff, total = genome_layout(lengths)
    pads = pad_ranges(lengths, goff, total)
    tables = {}
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cpu":
            flat = np.empty(total, np.uint8)
            for a, b in pads:
                flat[a:b] = _REF_PAD
            tables[dev] = torch.from_numpy(flat)
        else:
            t = torch.empty(total, dtype=torch.uint8, device=dev)
            for a, b in pads:
                t[a:b].fill_(_REF_PAD)
            tables[dev] = t
    return goff, tables


def upload_genome(reference, goff: np.ndarray, tables: dict) -> tuple[int, int]:
    """Every chromosome of ``reference`` into its place in each of
    ``alloc_genome``'s ``tables``; returns when the bytes are there.

    A CPU table is written by slice assignment.  The cards' tables are
    written through pinned staging: each of ``STAGE_THREADS`` host threads
    copies its share of ``chunk_plan``'s chunks of ``STAGE_BYTES`` into its
    own pinned buffer and queues the chunk's copy to every card on that
    card's copy stream, waiting on the buffer's last copies before it fills
    it again, so the threads' host copies overlap each other's DMA.  The
    buffers are zeroed before they go, so no byte of the reference outlives
    the call in pinned memory.  Returns ``(staged bytes, staged copies)``,
    summed over the cards (0 on the CPU)."""
    arrays = [np.ascontiguousarray(r, dtype=np.uint8) for r in reference]
    lengths = [len(a) for a in arrays]
    cards = []
    for dev, table in tables.items():
        if dev.type == "cpu":
            flat = table.numpy()
            for a, off in zip(arrays, goff.tolist()):
                flat[off:off + len(a)] = a
        else:
            cards.append(dev)
    if not cards:
        return 0, 0
    chunk, threads = STAGE_BYTES, STAGE_THREADS
    plan = chunk_plan(lengths, goff, chunk)
    streams = {}
    for dev in cards:
        streams[dev] = torch.cuda.Stream(dev)
        # the table's allocation and pads were queued on the current stream
        streams[dev].wait_stream(torch.cuda.current_stream(dev))
    errors = []

    def work(share) -> None:
        try:
            stage(share)
        except Exception as exc:  # raised again by the calling thread
            errors.append(exc)

    def stage(share) -> None:
        buf = torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
        view = buf.numpy()
        done, filled = [], 0
        try:
            for c, src, dst, n in share:
                for e in done:
                    e.synchronize()
                view[:n] = arrays[c][src:src + n]
                filled = max(filled, n)
                done = []
                for dev in cards:
                    with torch.cuda.stream(streams[dev]):
                        tables[dev][dst:dst + n].copy_(buf[:n], non_blocking=True)
                        e = torch.cuda.Event()
                        e.record(streams[dev])
                    done.append(e)
        finally:
            for e in done:
                e.synchronize()
            view[:filled] = 0

    workers = [threading.Thread(target=work, args=(plan[t::threads],),
                                name=f"genome-stage-{t}")
               for t in range(min(threads, len(plan)))]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    for dev in cards:
        torch.cuda.synchronize(dev)
    if errors:
        raise errors[0]
    return sum(lengths) * len(cards), len(plan) * len(cards)


def split_global_base(gbyte) -> tuple[np.ndarray, np.ndarray]:
    """int64 global byte offset(s) -> (superblock index int32, residue int32).

    The device never reconstructs the raw byte offset (which can exceed
    int32 for >2.1 GB genomes); all window arithmetic runs in the split
    (superblock, residue) domain.
    """
    gbyte = np.asarray(gbyte, np.int64)
    return (gbyte >> 6).astype(np.int32), (gbyte & 63).astype(np.int32)


def pack_seq_rows(rows: np.ndarray) -> np.ndarray:
    """(B, L) ASCII uint8 rows -> (B, ceil(L/2)) packed BAM nibble rows
    (high nibble = first base; zero-padded rows pack to 0x00 = '==')."""
    rows = np.ascontiguousarray(rows, np.uint8)
    b, length = rows.shape
    if length % 2:
        rows = np.concatenate([rows, np.zeros((b, 1), np.uint8)], axis=1)
    nib = _ENC_LUT[rows]
    # '=' is code 0, so zero padding encodes to 0 and round-trips to '='
    nib[rows == 0] = 0
    return ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8)


def genome_tensor(words_or_flat, device) -> torch.Tensor:
    """The JAX package's ``(NSB, 16)`` uint32 table (or any flat uint8
    array) as the port's flat ``(N,)`` uint8 genome on ``device``: the same
    bytes in the same order.  A CPU result aliases the numpy buffer."""
    a = np.ascontiguousarray(words_or_flat)
    if a.dtype not in (np.uint8, np.uint32):
        raise ValueError(f"genome must be uint8 or uint32, got {a.dtype}")
    return torch.from_numpy(a.view(np.uint8).reshape(-1)).to(device)


def global_base(g_sb: torch.Tensor, g_off: torch.Tensor) -> torch.Tensor:
    """(superblock, residue) int32 -> int64 global byte offset."""
    return (g_sb.long() << 6) | g_off.long()


def ref_windows(genome: torch.Tensor, g_base: torch.Tensor,
                starts: torch.Tensor, window: int) -> torch.Tensor:
    """Bytes ``genome[g_base + starts + t]`` for t in [0, window).

    ``g_base`` int64 and ``starts`` int32 broadcast to a common shape S; the
    result is (*S, window) uint8.  Like ``fetch_ref_windows_global``, the
    window's first superblock is clamped to [0, NSB - 2], so every read
    stays inside the table."""
    if window > SB:
        raise ValueError(f"window {window} exceeds the {SB}-byte superblock")
    nsb = genome.shape[0] // SB
    q = g_base + starts.long()
    sb = torch.clamp(q >> 6, 0, nsb - 2)
    t = torch.arange(window, dtype=torch.int64, device=genome.device)
    idx = ((sb << 6) | (q & 63)).unsqueeze(-1) + t
    return genome[idx]


def read_windows_packed(rows: torch.Tensor, starts: torch.Tensor,
                        window: int) -> torch.Tensor:
    """(B, Lp) packed nibble rows + (B, C) base-coordinate starts ->
    (B, C, window) ASCII bytes of the bases ``starts + t``.

    Base p sits in packed byte p >> 1 (high nibble first); a byte outside
    [0, Lp) is 0xFD, so it widens to 'N' at even p and 'D' at odd p."""
    b, lp = rows.shape
    t = torch.arange(window, dtype=torch.int64, device=rows.device)
    p = starts.long().unsqueeze(-1) + t                      # (B, C, W)
    k = p >> 1
    inside = (k >= 0) & (k < lp)
    got = torch.gather(rows, 1, k.clamp(0, lp - 1).reshape(b, -1))
    byte = torch.where(inside, got.reshape(p.shape), PACKED_FILL).long()
    nib = torch.where((p & 1) == 1, byte & 15, byte >> 4)
    lut = torch.tensor(list(SEQ_SYMBOLS), dtype=torch.uint8, device=rows.device)
    return lut[nib]
