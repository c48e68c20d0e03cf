"""CRAM 3.0 container codec: decode-only reader + a writer subset.

The reference accepts BAM or CRAM for both alignment inputs through htslib
(reference src/cli.rs:25,32; rust-htslib bam::IndexedReader).  This module
provides the same capability natively: a spec-based CRAM 3.0 reader
(containers, compression header, slice decode, feature-based record
reconstruction, rANS 4x8 order-0/1, gzip/bzip2/lzma/raw block methods, the
EXTERNAL / HUFFMAN / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP / BETA encodings
htslib emits) yielding the same ``BamRecord`` objects as the BAM reader.

No htslib exists in this image to produce interop fixtures, so conformance
is established by (a) known-answer tests for the primitive codecs
(ITF8/LTF8, rANS normalization invariants) and (b) round-trip tests through
the writer subset, which emits spec-valid CRAM 3.0 (verbatim-base RR=0
slices, external gzip blocks) — see tests/test_cram.py.

Note on M/=/X: CRAM's feature model reconstructs alignment-match ops as
``M`` (substitutions are features, not cigar ops), exactly as htslib does —
so a CRAM assembly-to-ref input yields M cigars and the repeat trimmer's
=/X requirement fails identically to the reference running on the same
file.
"""

from __future__ import annotations

import bz2
import lzma
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from portello_tpu_torch.io.bam import BamHeader, BamRecord, FREVERSE, FMREVERSE, FMUNMAP, FUNMAP
from portello_tpu_torch.ops import cigar as cg

CRAM_MAGIC = b"CRAM"

# canonical CRAM v3 EOF container (hts-specs section 9; byte-exact)
CRAM_EOF = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001"
    "000100ee63014b"
)
# canonical CRAM v2.1 EOF container: the same sentinel (ref -1, start
# 0x454F46 'EOF', one 6-byte raw block) minus the two CRC32 fields v3
# added — 30 bytes, matching htslib's 2.x constant:
#   len=11 | ref itf8 -1 | start itf8 0x454F46 | span nrec counter bases
#   nblocks nland | block hdr 00 01 00 06 06 | data 010001000100
CRAM_EOF_V2 = bytes.fromhex(
    "0b000000ffffffff0fe0454f46000000000100" "0001000606" "010001000100"
)

# block compression methods (CRAM 3.1 adds 5-8)
RAW, GZIP, BZIP2, LZMA, RANS4X8 = 0, 1, 2, 3, 4
RANSNX16, ARITH, FQZCOMP, TOK3 = 5, 6, 7, 8
# block content types
FILE_HEADER, COMPRESSION_HEADER, SLICE_HEADER, EXTERNAL_T, CORE_T = 0, 1, 2, 4, 5

# CF flags (htslib cram.h)
CF_QUAL = 1
CF_DETACHED = 2
CF_MATE_DOWNSTREAM = 4
CF_NO_SEQ = 8


class CramFormatError(ValueError):
    pass


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def read_itf8(buf: bytes, off: int) -> tuple[int, int]:
    b0 = buf[off]
    if b0 < 0x80:
        val, off = b0, off + 1
    elif b0 < 0xC0:
        val, off = ((b0 & 0x7F) << 8) | buf[off + 1], off + 2
    elif b0 < 0xE0:
        val = ((b0 & 0x3F) << 16) | (buf[off + 1] << 8) | buf[off + 2]
        off += 3
    elif b0 < 0xF0:
        val = (
            ((b0 & 0x1F) << 24) | (buf[off + 1] << 16) | (buf[off + 2] << 8)
            | buf[off + 3]
        )
        off += 4
    else:
        val = (
            ((b0 & 0x0F) << 28) | (buf[off + 1] << 20) | (buf[off + 2] << 12)
            | (buf[off + 3] << 4) | (buf[off + 4] & 0x0F)
        )
        off += 5
    if val >= 1 << 31:
        val -= 1 << 32
    return val, off


def write_itf8(val: int) -> bytes:
    val &= 0xFFFFFFFF
    if val < 0x80:
        return bytes([val])
    if val < 0x4000:
        return bytes([0x80 | (val >> 8), val & 0xFF])
    if val < 0x200000:
        return bytes([0xC0 | (val >> 16), (val >> 8) & 0xFF, val & 0xFF])
    if val < 0x10000000:
        return bytes([
            0xE0 | (val >> 24), (val >> 16) & 0xFF, (val >> 8) & 0xFF,
            val & 0xFF,
        ])
    return bytes([
        0xF0 | ((val >> 28) & 0x0F), (val >> 20) & 0xFF, (val >> 12) & 0xFF,
        (val >> 4) & 0xFF, val & 0x0F,
    ])


def read_ltf8(buf: bytes, off: int) -> tuple[int, int]:
    b0 = buf[off]
    n = 0
    while n < 8 and (b0 << n) & 0x80:
        n += 1
    val = b0 & (0xFF >> (n + (0 if n == 8 else 1)))
    if n == 8:
        val = 0
    for i in range(n):
        val = (val << 8) | buf[off + 1 + i]
    off += 1 + n
    if val >= 1 << 63:
        val -= 1 << 64
    return val, off


def write_ltf8(val: int) -> bytes:
    val &= (1 << 64) - 1
    if val < 0x80:
        return bytes([val])
    # choose smallest n extra bytes such that value fits in (7-n)+8n bits
    for n in range(1, 8):
        if val < 1 << (7 - n + 8 * n):
            prefix = (0xFF << (8 - n)) & 0xFF
            top = val >> (8 * n)
            out = [prefix | top]
            for i in range(n - 1, -1, -1):
                out.append((val >> (8 * i)) & 0xFF)
            return bytes(out)
    out = [0xFF]
    for i in range(7, -1, -1):
        out.append((val >> (8 * i)) & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# rANS 4x8 (hts-specs CRAMcodecs; htslib rANS_static.c)
# ---------------------------------------------------------------------------

_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT  # 4096
_RANS_LOW = 1 << 23


def _rans_read_freqs(buf: bytes, off: int) -> tuple[np.ndarray, int]:
    """Order-0 frequency table with the RLE scheme of rANS_static.c."""
    F = np.zeros(256, dtype=np.int64)
    j = buf[off]
    off += 1
    rle = 0
    while True:
        f = buf[off]
        off += 1
        if f >= 128:
            f = ((f & 127) << 8) | buf[off]
            off += 1
        F[j] = f
        if rle > 0:
            rle -= 1
            j += 1
        else:
            nj = buf[off]
            off += 1
            if nj == j + 1:
                rle = buf[off]
                off += 1
            j = nj
            if j == 0:
                break
    return F, off


def _rans_write_freqs(F: np.ndarray) -> bytes:
    """Emit the frequency table in the rANS_static.c RLE grammar:

        sym0 { freq [next_sym [run]] }*0

    After each freq, if the run counter is live the next symbol is implied
    (+1); otherwise the next symbol byte follows, and when it equals sym+1 a
    run-length byte follows it.  A next-symbol byte of 0 terminates.
    """
    out = bytearray()
    syms = [s for s in range(256) if F[s] > 0]
    if not syms:
        return bytes([0, 0, 0])

    def emit_freq(f):
        if f >= 128:
            out.append(128 | (f >> 8))
            out.append(f & 0xFF)
        else:
            out.append(f)

    out.append(syms[0])
    rle = 0
    for i, s in enumerate(syms):
        emit_freq(int(F[s]))
        if rle > 0:
            rle -= 1  # next symbol implied (s + 1)
        elif i + 1 < len(syms):
            nxt = syms[i + 1]
            out.append(nxt)
            if nxt == s + 1:
                run = 0
                while (i + 2 + run < len(syms)
                       and syms[i + 2 + run] == nxt + 1 + run):
                    run += 1
                out.append(run)
                rle = run
        else:
            out.append(0)
    return bytes(out)


def _normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale counts so they sum to exactly TOTFREQ with no zero for present
    symbols."""
    total = counts.sum()
    if total == 0:
        return counts
    F = np.floor(counts * (_TOTFREQ / total)).astype(np.int64)
    F[(counts > 0) & (F == 0)] = 1
    diff = _TOTFREQ - F.sum()
    # adjust the most frequent symbol
    while diff != 0:
        m = int(np.argmax(F))
        step = diff
        if F[m] + step < 1:
            step = 1 - F[m]
        F[m] += step
        diff -= step
    return F


def rans_decode(data: bytes) -> bytes:
    """Decode an rANS 4x8 block ([order u8][comp u32][raw u32][payload])."""
    order = data[0]
    n_out = struct.unpack_from("<I", data, 5)[0]
    payload = data[9:]
    if n_out == 0:
        return b""
    if order == 0:
        return _rans0_decode(payload, n_out)
    if order == 1:
        return _rans1_decode(payload, n_out)
    raise CramFormatError(f"unknown rANS order {order}")


def _build_cum(F: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    C = np.zeros(257, dtype=np.int64)
    C[1:] = np.cumsum(F)
    # symbol lookup per 12-bit slot
    slot = np.zeros(_TOTFREQ, dtype=np.uint8)
    for s in range(256):
        if F[s] > 0:
            slot[C[s] : C[s + 1]] = s
    return C, slot


def _rans0_decode(buf: bytes, n_out: int) -> bytes:
    F, off = _rans_read_freqs(buf, 0)
    C, slot = _build_cum(F)
    R = list(struct.unpack_from("<4I", buf, off))
    off += 16
    out = bytearray(n_out)
    for i in range(n_out):
        j = i & 3
        r = R[j]
        f = r & (_TOTFREQ - 1)
        s = slot[f]
        out[i] = s
        r = int(F[s]) * (r >> _TF_SHIFT) + f - int(C[s])
        while r < _RANS_LOW and off < len(buf):
            r = (r << 8) | buf[off]
            off += 1
        R[j] = r
    return bytes(out)


def _rans1_decode(buf: bytes, n_out: int) -> bytes:
    # nested RLE over contexts, each with an order-0 style table
    Fs = {}
    off = 0
    i = buf[off]
    off += 1
    rle_i = 0
    while True:
        F, off = _rans_read_freqs(buf, off)
        Fs[i] = _build_cum(F) + (F,)
        if rle_i > 0:
            rle_i -= 1
            i += 1
        else:
            ni = buf[off]
            off += 1
            if ni == i + 1:
                rle_i = buf[off]
                off += 1
            i = ni
            if i == 0:
                break
    R = list(struct.unpack_from("<4I", buf, off))
    off += 16
    out = bytearray(n_out)
    # htslib rANS_static.c layout: quarters of floor(n/4) at offsets
    # 0/Q/2Q/3Q; state 3 decodes the tail [4Q, n) continuing its context
    # chain (NOT ceil quarters — sizes % 4 != 0 would desynchronize).
    Q = n_out >> 2
    last = [0, 0, 0, 0]
    ptr = off

    def step(j, idx):
        got = Fs.get(last[j])
        if got is None:
            raise CramFormatError("rANS order-1 missing context")
        C, slot, F = got
        nonlocal ptr
        r = R[j]
        f = r & (_TOTFREQ - 1)
        s = int(slot[f])
        out[idx] = s
        r = int(F[s]) * (r >> _TF_SHIFT) + f - int(C[s])
        while r < _RANS_LOW and ptr < len(buf):
            r = (r << 8) | buf[ptr]
            ptr += 1
        R[j] = r
        last[j] = s

    for i2 in range(Q):
        for j in range(4):
            step(j, j * Q + i2)
    for idx in range(4 * Q, n_out):
        step(3, idx)
    return bytes(out)


def rans_encode_order1(raw: bytes) -> bytes:
    """rANS 4x8 order-1 encoder (round-trip coverage for the O1 decoder;
    quarter layout mirrors rANS_static.c: 4 states over floor(n/4) quarters
    at offsets 0/Q/2Q/3Q, state 3 carrying the tail [4Q, n), first byte of
    each quarter in context 0)."""
    n = len(raw)
    if n == 0:
        return struct.pack("<BII", 1, 0, 0)
    arr = np.frombuffer(raw, dtype=np.uint8)
    Q = n >> 2
    # per-state contiguous context ranges: [0,Q) [Q,2Q) [2Q,3Q) [3Q,n)
    ranges = [(0, Q), (Q, 2 * Q), (2 * Q, 3 * Q), (3 * Q, n)]
    counts = np.zeros((256, 256), dtype=np.int64)
    for lo, hi in ranges:
        last = 0
        for idx in range(lo, hi):
            counts[last, arr[idx]] += 1
            last = arr[idx]
    ctxs = [c for c in range(256) if counts[c].sum() > 0]
    Fs = {}
    Cs = {}
    for c in ctxs:
        F = _normalize_freqs(counts[c])
        C = np.zeros(257, dtype=np.int64)
        C[1:] = np.cumsum(F)
        Fs[c], Cs[c] = F, C
    # context tables with the outer RLE grammar
    tab = bytearray()
    tab.append(ctxs[0])
    rle = 0
    for k, c in enumerate(ctxs):
        tab += _rans_write_freqs(Fs[c])
        if rle > 0:
            rle -= 1
        elif k + 1 < len(ctxs):
            nxt = ctxs[k + 1]
            tab.append(nxt)
            if nxt == c + 1:
                run = 0
                while (k + 2 + run < len(ctxs)
                       and ctxs[k + 2 + run] == nxt + 1 + run):
                    run += 1
                tab.append(run)
                rle = run
        else:
            tab.append(0)
    # encode in reverse (LIFO per state)
    R = [_RANS_LOW] * 4
    out_rev = bytearray()
    # positions in global decode order: Q interleaved rounds then the tail
    # on state 3 (see _rans1_decode)
    seq = []
    for i2 in range(Q):
        for j in range(4):
            seq.append((j, j * Q + i2))
    for idx in range(4 * Q, n):
        seq.append((3, idx))
    for j, idx in reversed(seq):
        s_ = int(arr[idx])
        q_start = j * Q
        ctx = int(arr[idx - 1]) if idx > q_start else 0
        F, C = Fs[ctx], Cs[ctx]
        f = int(F[s_])
        r = R[j]
        rmax = ((_RANS_LOW >> _TF_SHIFT) << 8) * f
        while r >= rmax:
            out_rev.append(r & 0xFF)
            r >>= 8
        R[j] = ((r // f) << _TF_SHIFT) + (r % f) + int(C[s_])
    head = bytearray()
    for j in range(4):
        head += struct.pack("<I", R[j])
    payload = bytes(tab) + bytes(head) + bytes(reversed(out_rev))
    return struct.pack("<BII", 1, len(payload), n) + payload


def rans_encode_order0(raw: bytes) -> bytes:
    """Encode with rANS 4x8 order-0 (for the writer subset + codec tests)."""
    n = len(raw)
    if n == 0:
        return struct.pack("<BII", 0, 0, 0)
    arr = np.frombuffer(raw, dtype=np.uint8)
    counts = np.bincount(arr, minlength=256).astype(np.int64)
    F = _normalize_freqs(counts)
    C = np.zeros(257, dtype=np.int64)
    C[1:] = np.cumsum(F)
    freq_tab = _rans_write_freqs(F)

    # encode in reverse, 4 interleaved states
    R = [_RANS_LOW] * 4
    out_rev = bytearray()
    for i in range(n - 1, -1, -1):
        j = i & 3
        s = arr[i]
        f = int(F[s])
        r = R[j]
        # renormalize: keep r < f * (LOW >> TF_SHIFT) * 256
        rmax = ((_RANS_LOW >> _TF_SHIFT) << 8) * f
        while r >= rmax:
            out_rev.append(r & 0xFF)
            r >>= 8
        R[j] = ((r // f) << _TF_SHIFT) + (r % f) + int(C[s])
    head = bytearray()
    for j in range(4):
        head += struct.pack("<I", R[j])
    payload = bytes(freq_tab) + bytes(head) + bytes(reversed(out_rev))
    return struct.pack("<BII", 0, len(payload), n) + payload


# ---------------------------------------------------------------------------
# blocks and containers
# ---------------------------------------------------------------------------

@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes  # uncompressed


def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == RAW:
        return data
    if method == GZIP:
        return zlib.decompress(data, 15 + 32)
    if method == BZIP2:
        return bz2.decompress(data)
    if method == LZMA:
        return lzma.decompress(data)
    if method == RANS4X8:
        return rans_decode(data)
    if method == RANSNX16:
        from portello_tpu_torch.io import rans_nx16

        return rans_nx16.decode(data, raw_size)
    if method == FQZCOMP:
        from portello_tpu_torch.io import fqzcomp

        return fqzcomp.decode(data, raw_size)
    if method == TOK3:
        from portello_tpu_torch.io import tok3

        return tok3.decode(data)
    if method == ARITH:
        from portello_tpu_torch.io import arith_nx16

        return arith_nx16.decode(data, raw_size)
    raise CramFormatError(f"unsupported CRAM block method {method}")


def read_block(
    buf: bytes, off: int, version: tuple[int, int] = (3, 0)
) -> tuple[Block, int]:
    start = off
    method = buf[off]
    ctype = buf[off + 1]
    off += 2
    cid, off = read_itf8(buf, off)
    comp, off = read_itf8(buf, off)
    raw, off = read_itf8(buf, off)
    data = buf[off : off + comp]
    off += comp
    if version >= (3, 0):
        # CRAM 3.0 mandates the block CRC32 (over method..compressed data);
        # htslib validates it on read — a passing size check alone would let
        # bit flips flow through as silent base/qual corruption.  2.x blocks
        # have no CRC field at all.
        stored = struct.unpack_from("<I", buf, off)[0]
        computed = zlib.crc32(buf[start:off]) & 0xFFFFFFFF
        if stored != computed:
            raise CramFormatError(
                f"CRAM block CRC mismatch (stored {stored:#x}, "
                f"computed {computed:#x})"
            )
        off += 4
    out = _decompress(method, data, raw)
    if len(out) != raw:
        raise CramFormatError("CRAM block raw size mismatch")
    return Block(method, ctype, cid, out), off


def write_block_precompressed(
    method: int, ctype: int, cid: int, comp: bytes, raw_len: int,
    version: tuple[int, int] = (3, 0),
) -> bytes:
    """Frame an already-compressed payload (fqzcomp needs record lengths
    the generic write_block cannot know)."""
    body = bytearray([method, ctype])
    body += write_itf8(cid)
    body += write_itf8(len(comp))
    body += write_itf8(raw_len)
    body += comp
    if version >= (3, 0):
        body += struct.pack("<I", zlib.crc32(bytes(body)) & 0xFFFFFFFF)
    return bytes(body)


def write_block(
    method: int, ctype: int, cid: int, data: bytes,
    version: tuple[int, int] = (3, 0),
) -> bytes:
    if method == GZIP:
        comp = zlib.compress(data, 6)
    elif method == RANS4X8:
        comp = rans_encode_order0(data)
    elif method == RANSNX16:
        from portello_tpu_torch.io import rans_nx16

        comp = rans_nx16.encode(data, order=0)
    elif method == TOK3:
        from portello_tpu_torch.io import tok3

        comp = tok3.encode(data)
    else:
        method = RAW
        comp = data
    body = bytearray([method, ctype])
    body += write_itf8(cid)
    body += write_itf8(len(comp))
    body += write_itf8(len(data))
    body += comp
    if version >= (3, 0):
        body += struct.pack("<I", zlib.crc32(bytes(body)) & 0xFFFFFFFF)
    return bytes(body)


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    bases: int
    n_blocks: int
    landmarks: list[int] = field(default_factory=list)


def read_container_header(
    f, version: tuple[int, int] = (3, 0)
) -> ContainerHeader | None:
    head = f.read(4)
    if len(head) < 4:
        return None
    length = struct.unpack("<i", head)[0]
    # the varint section is unbounded (the landmark list has one entry per
    # slice); grow the read window on demand instead of assuming a cap
    rest = bytearray(f.read(64))

    def r(fn, off):
        while True:
            try:
                return fn(rest, off)
            except IndexError:
                more = f.read(64)
                if not more:
                    raise CramFormatError("truncated CRAM container header")
                rest.extend(more)

    off = 0
    ref_id, off = r(read_itf8, off)
    start, off = r(read_itf8, off)
    span, off = r(read_itf8, off)
    n_records, off = r(read_itf8, off)
    # v2.x stores the record counter as itf8 (htslib widened it to ltf8 in
    # 3.0); num_bases is ltf8 in both
    if version >= (3, 0):
        record_counter, off = r(read_ltf8, off)
    else:
        record_counter, off = r(read_itf8, off)
    bases, off = r(read_ltf8, off)
    n_blocks, off = r(read_itf8, off)
    n_land, off = r(read_itf8, off)
    landmarks = []
    for _ in range(n_land):
        v, off = r(read_itf8, off)
        landmarks.append(v)
    if version >= (3, 0):
        while len(rest) < off + 4:
            more = f.read(64)
            if not more:
                raise CramFormatError("truncated CRAM container header")
            rest.extend(more)
        stored = struct.unpack_from("<I", rest, off)[0]
        computed = zlib.crc32(head + bytes(rest[:off])) & 0xFFFFFFFF
        if stored != computed:
            raise CramFormatError(
                f"CRAM container header CRC mismatch (stored {stored:#x}, "
                f"computed {computed:#x})"
            )
        off += 4
    f.seek(off - len(rest), 1)  # rewind unread tail
    return ContainerHeader(
        length, ref_id, start, span, n_records, record_counter, bases,
        n_blocks, landmarks,
    )


def write_container_header(
    h: ContainerHeader, version: tuple[int, int] = (3, 0)
) -> bytes:
    body = bytearray()
    body += write_itf8(h.ref_id)
    body += write_itf8(h.start)
    body += write_itf8(h.span)
    body += write_itf8(h.n_records)
    if version >= (3, 0):
        body += write_ltf8(h.record_counter)
    else:
        body += write_itf8(h.record_counter)
    body += write_ltf8(h.bases)
    body += write_itf8(h.n_blocks)
    body += write_itf8(len(h.landmarks))
    for v in h.landmarks:
        body += write_itf8(v)
    out = struct.pack("<i", h.length) + bytes(body)
    if version >= (3, 0):
        out += struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)
    return out


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

@dataclass
class Encoding:
    codec: int
    # EXTERNAL
    content_id: int = -1
    # HUFFMAN
    alphabet: list[int] = field(default_factory=list)
    bit_lens: list[int] = field(default_factory=list)
    # BYTE_ARRAY_LEN
    len_enc: "Encoding | None" = None
    val_enc: "Encoding | None" = None
    # BYTE_ARRAY_STOP
    stop_byte: int = 0
    # BETA
    offset: int = 0
    n_bits: int = 0
    # prepared huffman decode table: sorted (code, len) -> symbol
    _huff: dict | None = None


E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, \
    E_BETA, E_SUBEXP, E_GOLOMB_RICE, E_GAMMA = range(10)


def parse_encoding(buf: bytes, off: int) -> tuple[Encoding, int]:
    codec, off = read_itf8(buf, off)
    size, off = read_itf8(buf, off)
    params = buf[off : off + size]
    off += size
    e = Encoding(codec)
    p = 0
    if codec == E_EXTERNAL:
        e.content_id, p = read_itf8(params, p)
    elif codec == E_HUFFMAN:
        n, p = read_itf8(params, p)
        for _ in range(n):
            v, p = read_itf8(params, p)
            e.alphabet.append(v)
        n2, p = read_itf8(params, p)
        for _ in range(n2):
            v, p = read_itf8(params, p)
            e.bit_lens.append(v)
        e._huff = _build_huffman(e.alphabet, e.bit_lens)
    elif codec == E_BYTE_ARRAY_LEN:
        e.len_enc, p = parse_encoding(params, p)
        e.val_enc, p = parse_encoding(params, p)
    elif codec == E_BYTE_ARRAY_STOP:
        e.stop_byte = params[p]
        p += 1
        e.content_id, p = read_itf8(params, p)
    elif codec == E_BETA:
        e.offset, p = read_itf8(params, p)
        e.n_bits, p = read_itf8(params, p)
    elif codec == E_NULL:
        pass
    else:
        raise CramFormatError(f"unsupported CRAM encoding codec {codec}")
    return e, off


def encode_encoding(e: Encoding) -> bytes:
    params = bytearray()
    if e.codec == E_EXTERNAL:
        params += write_itf8(e.content_id)
    elif e.codec == E_HUFFMAN:
        params += write_itf8(len(e.alphabet))
        for v in e.alphabet:
            params += write_itf8(v)
        params += write_itf8(len(e.bit_lens))
        for v in e.bit_lens:
            params += write_itf8(v)
    elif e.codec == E_BYTE_ARRAY_LEN:
        params += encode_encoding(e.len_enc)
        params += encode_encoding(e.val_enc)
    elif e.codec == E_BYTE_ARRAY_STOP:
        params.append(e.stop_byte)
        params += write_itf8(e.content_id)
    elif e.codec == E_BETA:
        params += write_itf8(e.offset)
        params += write_itf8(e.n_bits)
    return write_itf8(e.codec) + write_itf8(len(params)) + bytes(params)


def _build_huffman(alphabet: list[int], bit_lens: list[int]) -> dict:
    """Canonical Huffman code assignment (spec section 13.4)."""
    pairs = sorted(zip(bit_lens, alphabet))
    table = {}
    code = 0
    prev_len = 0
    for blen, sym in pairs:
        code <<= blen - prev_len
        prev_len = blen
        table[(blen, code)] = sym
        code += 1
    return table


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


class _ExternalStream:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read_itf8(self) -> int:
        v, self.pos = read_itf8(self.data, self.pos)
        return v

    def read_bytes(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_until(self, stop: int) -> bytes:
        end = self.data.index(bytes([stop]), self.pos)
        out = self.data[self.pos : end]
        self.pos = end + 1
        return out


class SliceDecoder:
    """Evaluates encodings against a slice's core + external blocks."""

    def __init__(self, core: bytes, external: dict[int, bytes]):
        self.core = BitReader(core)
        self.ext = {cid: _ExternalStream(d) for cid, d in external.items()}

    def _ext(self, cid: int) -> _ExternalStream:
        st = self.ext.get(cid)
        if st is None:
            st = self.ext[cid] = _ExternalStream(b"")
        return st

    def read_int(self, e: Encoding) -> int:
        if e.codec == E_EXTERNAL:
            return self._ext(e.content_id).read_itf8()
        if e.codec == E_HUFFMAN:
            if len(e.alphabet) == 1:
                return e.alphabet[0]
            blen = 0
            code = 0
            while True:
                code = (code << 1) | self.core.read_bits(1)
                blen += 1
                sym = e._huff.get((blen, code))
                if sym is not None:
                    return sym
                if blen > 31:
                    raise CramFormatError("bad huffman stream")
        if e.codec == E_BETA:
            return self.core.read_bits(e.n_bits) - e.offset
        raise CramFormatError(f"unsupported int encoding {e.codec}")

    def read_byte(self, e: Encoding) -> int:
        if e.codec == E_EXTERNAL:
            return self._ext(e.content_id).read_byte()
        return self.read_int(e) & 0xFF

    def read_bytes_n(self, e: Encoding, n: int) -> bytes:
        if e.codec == E_EXTERNAL:
            return self._ext(e.content_id).read_bytes(n)
        return bytes(self.read_byte(e) for _ in range(n))

    def read_array(self, e: Encoding) -> bytes:
        if e.codec == E_BYTE_ARRAY_STOP:
            return self._ext(e.content_id).read_until(e.stop_byte)
        if e.codec == E_BYTE_ARRAY_LEN:
            n = self.read_int(e.len_enc)
            return self.read_bytes_n(e.val_enc, n)
        raise CramFormatError(f"unsupported array encoding {e.codec}")


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------

@dataclass
class CompressionHeader:
    rn: bool = True     # read names preserved
    ap_delta: bool = False
    rr: bool = True     # reference required
    sub_matrix: bytes = b"\x00" * 5
    tag_dict: list[list[tuple[bytes, bytes]]] = field(default_factory=list)
    series: dict[bytes, Encoding] = field(default_factory=dict)
    tags: dict[int, Encoding] = field(default_factory=dict)


def parse_compression_header(data: bytes) -> CompressionHeader:
    ch = CompressionHeader()
    off = 0
    _size, off = read_itf8(data, off)
    n, off = read_itf8(data, off)
    for _ in range(n):
        key = data[off : off + 2]
        off += 2
        if key in (b"RN", b"AP", b"RR"):
            val = data[off] != 0
            off += 1
            if key == b"RN":
                ch.rn = val
            elif key == b"AP":
                ch.ap_delta = val
            else:
                ch.rr = val
        elif key == b"SM":
            ch.sub_matrix = data[off : off + 5]
            off += 5
        elif key == b"TD":
            sz, off = read_itf8(data, off)
            blob = data[off : off + sz]
            off += sz
            for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                entries = []
                for i in range(0, len(line) - 2, 3):
                    entries.append((line[i : i + 2], line[i + 2 : i + 3]))
                ch.tag_dict.append(entries)
            if not ch.tag_dict:
                ch.tag_dict.append([])
        else:
            raise CramFormatError(f"unknown preservation key {key!r}")
    # data series encodings
    _size, off = read_itf8(data, off)
    n, off = read_itf8(data, off)
    for _ in range(n):
        key = data[off : off + 2]
        off += 2
        enc, off = parse_encoding(data, off)
        ch.series[key] = enc
    # tag encodings
    _size, off = read_itf8(data, off)
    n, off = read_itf8(data, off)
    for _ in range(n):
        key, off = read_itf8(data, off)
        enc, off = parse_encoding(data, off)
        ch.tags[key] = enc
    return ch


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _parse_sam_header_text(text: bytes) -> BamHeader:
    refs = []
    for line in text.decode(errors="replace").splitlines():
        if line.startswith("@SQ"):
            name = length = None
            for f in line.split("\t")[1:]:
                if f.startswith("SN:"):
                    name = f[3:]
                elif f.startswith("LN:"):
                    length = int(f[3:])
            if name is not None and length is not None:
                refs.append((name, length))
    return BamHeader(text=text, refs=refs)


_SUB_BASES = b"ACGTN"


def _sub_base(matrix: bytes, ref_base: int, code: int) -> int:
    """Decode a substitution code against the SM matrix (spec section 10.6)."""
    r = _SUB_BASES.find(bytes([ref_base]).upper())
    if r < 0:
        r = 4
    alts = [b for b in _SUB_BASES if b != _SUB_BASES[r]]
    byte = matrix[r]
    for k in range(4):
        if (byte >> (6 - 2 * k)) & 3 == code:
            return alts[k]
    return ord("N")


class _CountingFile:
    """File wrapper counting bytes actually read — the evidence that an
    indexed fetch touched only its containers (tests/test_crai_index.py)."""

    def __init__(self, f):
        self._f = f
        self.bytes_read = 0

    def read(self, n=-1):
        b = self._f.read(n)
        self.bytes_read += len(b)
        return b

    def seek(self, off, whence=0):
        return self._f.seek(off, whence)

    def tell(self):
        return self._f.tell()

    def close(self):
        return self._f.close()


class CramReader:
    """Decode-only CRAM 3.0 reader with the BamReader iteration surface.

    ``reference``: optional list/dict of chrom uint8 arrays (required for
    reference-based slices, i.e. RR=1 without embedded reference).
    """

    def __init__(self, path: str, reference=None):
        self.path = path
        self.f = _CountingFile(open(path, "rb"))
        self._index = None
        magic = self.f.read(6)
        if magic[:4] != CRAM_MAGIC:
            raise CramFormatError(f"{path}: not a CRAM file")
        self.version = (magic[4], magic[5])
        # 2.1 (no container/block CRCs, itf8 record counter) and 3.x are
        # implemented; 2.0 predates the record-counter/bases fields and
        # 1.x is a different container model — reject those clearly
        # instead of desynchronizing every offset
        if self.version not in ((2, 1),) and self.version[0] != 3:
            raise CramFormatError(
                f"{path}: CRAM version {self.version[0]}.{self.version[1]} "
                "not supported (this reader implements CRAM 2.1 and 3.x)"
            )
        self.f.read(20)  # file id
        self.reference = reference
        # first container: SAM header text
        h = read_container_header(self.f, self.version)
        body = self.f.read(h.length)
        blk, _ = read_block(body, 0, self.version)
        if blk.content_type != FILE_HEADER:
            raise CramFormatError("missing CRAM file header block")
        ln = struct.unpack_from("<i", blk.data, 0)[0]
        text = blk.data[4 : 4 + ln]
        self.header = _parse_sam_header_text(text)
        # @RG IDs in header order: the RG data series stores an index into
        # this list (reconstructed to an RG:Z aux tag per record)
        self._rg_ids: list[str] = []
        for line in text.decode(errors="replace").splitlines():
            if line.startswith("@RG"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("ID:"):
                        self._rg_ids.append(fld[3:])
                        break

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        while True:
            h = read_container_header(self.f, self.version)
            if h is None:
                return
            body = self.f.read(h.length)
            if h.ref_id == -1 and h.n_records == 0 and h.bases == 0:
                return  # EOF container (spec section 9)
            yield from self._decode_container(h, body)

    @property
    def bytes_read(self) -> int:
        return self.f.bytes_read

    def load_index(self):
        """Load the .crai (raises FileNotFoundError when absent — the
        reference errors on unindexed inputs, cli.rs:147-163)."""
        if self._index is None:
            from portello_tpu_torch.io.crai import CraiIndex

            self._index = CraiIndex.load(self.path)
        return self._index

    def _iter_container_at(self, off: int):
        self.f.seek(off)
        h = read_container_header(self.f, self.version)
        if h is None:
            return
        body = self.f.read(h.length)
        if h.ref_id == -1 and h.n_records == 0 and h.bases == 0:
            return
        yield from self._decode_container(h, body)

    def fetch(self, tid: int, beg: int, end: int):
        """Yield records overlapping [beg, end) on tid by .crai slice seek
        (htslib iterator semantics, matching BamReader.fetch: pos < end and
        endpos > beg).  Touches only the overlapping containers."""
        for off in self.load_index().query_containers(tid, beg, end):
            for rec in self._iter_container_at(off):
                if rec.tid != tid or rec.pos >= end:
                    continue
                if rec.alignment_end() > beg:
                    yield rec

    def fetch_many(self, ranges):
        """Yield records of several whole-contig ranges in (tid, pos) order.

        ``ranges``: list of (tid, end) pairs.  Unlike per-tid ``fetch``
        loops, every container is decoded AT MOST ONCE even when a
        multi-reference container holds records of several requested tids
        (fragmented-assembly CRAMs pack many tiny contigs per container) —
        record order is preserved because containers and in-container
        records are coordinate-sorted."""
        idx = self.load_index()
        want = {int(t): int(e) for t, e in ranges}
        offs = sorted({
            o for t, e in want.items() for o in idx.query_containers(t, 0, e)
        })
        for off in offs:
            for rec in self._iter_container_at(off):
                end = want.get(rec.tid)
                if end is None or rec.pos >= end:
                    continue
                if rec.alignment_end() > 0:
                    yield rec

    def fetch_unmapped(self):
        """Yield unmapped (seq_id -1) records via the index
        (FetchDefinition::Unmapped parity, read_alignment_scanner.rs:537-559)."""
        for off in self.load_index().unmapped_containers():
            for rec in self._iter_container_at(off):
                if rec.tid < 0 or rec.is_unmapped():
                    yield rec

    # -- container decode --
    def _decode_container(self, h: ContainerHeader, body: bytes):
        off = 0
        blk, off = read_block(body, off, self.version)
        if blk.content_type != COMPRESSION_HEADER:
            raise CramFormatError("expected compression header block")
        ch = parse_compression_header(blk.data)
        while off < len(body):
            sh_blk, off = read_block(body, off, self.version)
            if sh_blk.content_type != SLICE_HEADER:
                raise CramFormatError("expected slice header block")
            # slice header
            d = sh_blk.data
            p = 0
            s_ref, p = read_itf8(d, p)
            s_start, p = read_itf8(d, p)
            s_span, p = read_itf8(d, p)
            s_nrec, p = read_itf8(d, p)
            # slice record counter mirrors the container field's width
            if self.version >= (3, 0):
                _s_counter, p = read_ltf8(d, p)
            else:
                _s_counter, p = read_itf8(d, p)
            s_nblocks, p = read_itf8(d, p)
            n_ids, p = read_itf8(d, p)
            for _ in range(n_ids):
                _, p = read_itf8(d, p)
            s_embed_ref, p = read_itf8(d, p)
            p += 16  # MD5
            core = b""
            external: dict[int, bytes] = {}
            for _ in range(s_nblocks):
                b, off = read_block(body, off, self.version)
                if b.content_type == CORE_T:
                    core = b.data
                else:
                    external[b.content_id] = b.data
            embedded_ref = external.get(s_embed_ref) if s_embed_ref >= 0 else None
            yield from self._decode_slice(
                ch, s_ref, s_start, s_nrec, core, external, embedded_ref,
                s_start,
            )

    def _resolve_ref(self, tid: int):
        """Resolve the decode reference for this file's OWN tid, validated
        against the CRAM's @SQ name/length.

        The provided ``reference`` may be a dict keyed by sequence name or a
        list positional in THIS FILE's header order — either way the length
        must match the @SQ record, because decoding a reference-based (RR=1)
        slice against the wrong sequence silently corrupts every read base
        (e.g. a read-to-assembly CRAM's tids are assembly contigs, not
        reference chromosomes)."""
        if not hasattr(self, "_ref_cache"):
            self._ref_cache = {}
        if tid in self._ref_cache:
            return self._ref_cache[tid]
        name, length = self.header.refs[tid]
        seq = None
        if isinstance(self.reference, dict):
            seq = self.reference.get(name)
        elif self.reference is not None and tid < len(self.reference):
            seq = self.reference[tid]
        if seq is None or len(seq) != length:
            have = "no sequence" if seq is None else f"length {len(seq)}"
            raise CramFormatError(
                f"reference-based CRAM slice on '{name}' (length {length}) "
                f"cannot be decoded: {have} available for that name.  The "
                "decode reference must be the SAME assembly the CRAM was "
                "compressed against (use embedded-ref/RR=0 CRAM or BAM "
                "input otherwise)"
            )
        self._ref_cache[tid] = seq
        return seq

    def _ref_bases(self, tid: int, start0: int, n: int, embedded, s_start):
        if embedded is not None:
            off = start0 - (s_start - 1)
            return np.frombuffer(embedded, np.uint8)[off : off + n]
        if self.reference is None:
            raise CramFormatError(
                "CRAM slice requires the reference (RR=1) but none was "
                "provided"
            )
        chrom = self._resolve_ref(tid)
        return np.asarray(chrom[start0 : start0 + n], np.uint8)

    def _decode_slice(self, ch, s_ref, s_start, n_rec, core, external,
                      embedded_ref, slice_start):
        dec = SliceDecoder(core, external)
        S = ch.series

        def g(key):
            e = S.get(key)
            if e is None:
                raise CramFormatError(f"missing data series {key!r}")
            return e

        last_pos = s_start
        records: list[BamRecord] = []
        nf_links: list[tuple[int, int]] = []
        for ridx in range(n_rec):
            bf = dec.read_int(g(b"BF"))
            cf = dec.read_int(g(b"CF"))
            tid = dec.read_int(g(b"RI")) if s_ref == -2 else s_ref
            rl = dec.read_int(g(b"RL"))
            if ch.ap_delta:
                pos = last_pos + dec.read_int(g(b"AP"))
                last_pos = pos
            else:
                pos = dec.read_int(g(b"AP"))
            rg = dec.read_int(g(b"RG"))
            qname = b""
            if ch.rn:
                qname = dec.read_array(g(b"RN"))
            mtid, mpos, tlen = -1, -1, 0
            mate_flags = 0
            if cf & CF_DETACHED:
                mate_flags = dec.read_int(g(b"MF"))
                if not ch.rn:
                    qname = dec.read_array(g(b"RN"))
                mtid = dec.read_int(g(b"NS"))
                mpos = dec.read_int(g(b"NP"))
                tlen = dec.read_int(g(b"TS"))
            elif cf & CF_MATE_DOWNSTREAM:
                nf = dec.read_int(g(b"NF"))
                nf_links.append((ridx, ridx + nf + 1))
            # tags
            tl = dec.read_int(g(b"TL"))
            tags = []
            for tag, ty in ch.tag_dict[tl] if tl < len(ch.tag_dict) else []:
                key = (tag[0] << 16) | (tag[1] << 8) | ty[0]
                raw_val = dec.read_array(ch.tags[key])
                tags.append(_decode_tag_value(tag, ty, raw_val))
            # RG aux tag reconstructed from the read-group index + @RG header
            # lines (htslib cram_decode; the index is -1 for 'no group')
            if 0 <= rg < len(self._rg_ids):
                tags.append((b"RG", b"Z", self._rg_ids[rg].encode()))

            flag = bf
            if mate_flags & 1:
                flag |= FMREVERSE
            if mate_flags & 2:
                flag |= FMUNMAP

            seq = np.zeros(0, np.uint8)
            qual = np.full(rl, 0xFF, np.uint8)
            cigar = cg.EMPTY.copy()
            if not (bf & FUNMAP):
                fn = dec.read_int(g(b"FN"))
                feats = []
                fpos = 0
                for _ in range(fn):
                    fc = dec.read_byte(g(b"FC"))
                    fpos += dec.read_int(g(b"FP"))
                    feats.append((fc, fpos, dec, S))
                    fc_ch = chr(fc)
                    if fc_ch == "X":
                        feats[-1] = (fc, fpos, dec.read_int(g(b"BS")))
                    elif fc_ch == "D":
                        feats[-1] = (fc, fpos, dec.read_int(g(b"DL")))
                    elif fc_ch == "I":
                        feats[-1] = (fc, fpos, dec.read_array(g(b"IN")))
                    elif fc_ch == "i":
                        feats[-1] = (fc, fpos, dec.read_byte(g(b"BA")))
                    elif fc_ch == "S":
                        feats[-1] = (fc, fpos, dec.read_array(g(b"SC")))
                    elif fc_ch == "H":
                        feats[-1] = (fc, fpos, dec.read_int(g(b"HC")))
                    elif fc_ch == "P":
                        feats[-1] = (fc, fpos, dec.read_int(g(b"PD")))
                    elif fc_ch == "N":
                        feats[-1] = (fc, fpos, dec.read_int(g(b"RS")))
                    elif fc_ch == "B":
                        b_ = dec.read_byte(g(b"BA"))
                        q_ = dec.read_byte(g(b"QS"))
                        feats[-1] = (fc, fpos, (b_, q_))
                    elif fc_ch == "b":
                        feats[-1] = (fc, fpos, dec.read_array(g(b"BB")))
                    elif fc_ch == "q":
                        feats[-1] = (fc, fpos, dec.read_array(g(b"QQ")))
                    elif fc_ch == "Q":
                        feats[-1] = (fc, fpos, dec.read_int(g(b"QS")))
                    else:
                        raise CramFormatError(f"unknown feature code {fc_ch}")
                mq = dec.read_int(g(b"MQ"))
                no_seq = bool(cf & CF_NO_SEQ)
                seq, cigar = self._reconstruct(
                    ch, dec, S, tid, pos, rl, feats, embedded_ref, slice_start,
                    no_seq=no_seq, qual=qual,
                )
                if no_seq:
                    # sequence stored as '*' (htslib: cigar comes from the
                    # features, bases are not reconstructed)
                    seq = np.zeros(0, np.uint8)
                if cf & CF_QUAL:
                    qual = np.frombuffer(
                        dec.read_bytes_n(g(b"QS"), rl), np.uint8
                    ).copy()
                rec_mapq = mq
            else:
                rec_mapq = 0
                if not (cf & CF_NO_SEQ):
                    seq = np.frombuffer(
                        dec.read_bytes_n(g(b"BA"), rl), np.uint8
                    ).copy()
                else:
                    seq = np.full(rl, ord("N"), np.uint8)
                if cf & CF_QUAL:
                    qual = np.frombuffer(
                        dec.read_bytes_n(g(b"QS"), rl), np.uint8
                    ).copy()

            rec = BamRecord(
                qname=bytes(qname) or b"*",
                flag=flag,
                tid=tid if not (bf & FUNMAP) or tid >= 0 else -1,
                pos=pos - 1,
                mapq=rec_mapq,
                cigar=cigar,
                mtid=mtid,
                mpos=mpos - 1 if mpos > 0 else -1,
                tlen=tlen,
                seq=seq,
                qual=qual,
                tags=tags,
            )
            records.append(rec)

        # NF mate resolution (htslib cram_decode_slice): mate flags AND the
        # mate-unmapped bit propagate; TLEN is 0 when either end is unmapped
        for i, j in nf_links:
            if j < len(records):
                a, b = records[i], records[j]
                a.mtid, a.mpos = b.tid, b.pos
                b.mtid, b.mpos = a.tid, a.pos
                if a.flag & FREVERSE:
                    b.flag |= FMREVERSE
                if b.flag & FREVERSE:
                    a.flag |= FMREVERSE
                if a.flag & FUNMAP:
                    b.flag |= FMUNMAP
                if b.flag & FUNMAP:
                    a.flag |= FMUNMAP
                if (a.flag | b.flag) & FUNMAP:
                    a.tlen = b.tlen = 0
                    continue
                aleft = min(a.pos, b.pos)
                aright = max(a.alignment_end(), b.alignment_end())
                span = aright - aleft
                if a.pos <= b.pos:
                    a.tlen, b.tlen = span, -span
                else:
                    a.tlen, b.tlen = -span, span
        yield from records

    def _reconstruct(self, ch, dec, S, tid, pos1, rl, feats, embedded_ref,
                     slice_start, no_seq: bool = False, qual=None):
        """Features -> (seq, cigar) (spec section 10.5; htslib cram_decode).

        ``no_seq`` (CF_NO_SEQ on a mapped record): the cigar still comes
        from the features but no bases are reconstructed — in particular
        RR=0 match regions must NOT consume BA bytes (none were written;
        reading them would desynchronize every later record in the slice).
        ``qual`` receives quality-carrying features (q/Q/B) when given."""
        seq = np.zeros(rl, np.uint8)
        ops: list[tuple[int, int]] = []
        rpos = 0            # read cursor (0-based)
        ref_cursor = pos1 - 1

        def emit(code, ln):
            if ln > 0:
                ops.append((code, ln))

        def take_match(n):
            nonlocal rpos, ref_cursor
            if n <= 0:
                return
            if no_seq:
                pass  # cigar only; no base bytes stored for this record
            elif ch.rr:
                seq[rpos : rpos + n] = self._ref_bases(
                    tid, ref_cursor, n, embedded_ref, slice_start
                )
            else:
                ba = dec.read_bytes_n(S[b"BA"], n)
                seq[rpos : rpos + n] = np.frombuffer(ba, np.uint8)
            emit(cg.M, n)
            rpos += n
            ref_cursor += n

        for fc, fpos, val in feats:
            fc_ch = chr(fc)
            gap = (fpos - 1) - rpos  # fpos is 1-based read position
            if fc_ch == "H":
                # hard clips sit outside read bases: no gap-match before them
                take_match(gap)
                emit(cg.H, val)
                continue
            take_match(gap)
            if fc_ch == "S":
                sc = np.frombuffer(val, np.uint8)
                if not no_seq:
                    seq[rpos : rpos + len(sc)] = sc
                emit(cg.S, len(sc))
                rpos += len(sc)
            elif fc_ch == "X":
                if not no_seq:
                    rb = self._ref_bases(
                        tid, ref_cursor, 1, embedded_ref, slice_start
                    )
                    seq[rpos] = _sub_base(ch.sub_matrix, int(rb[0]), val)
                # merge into M run (substitutions are matches in the cigar)
                emit(cg.M, 1)
                rpos += 1
                ref_cursor += 1
            elif fc_ch == "D":
                emit(cg.D, val)
                ref_cursor += val
            elif fc_ch == "N":
                emit(cg.N, val)
                ref_cursor += val
            elif fc_ch == "I":
                ins = np.frombuffer(val, np.uint8)
                if not no_seq:
                    seq[rpos : rpos + len(ins)] = ins
                emit(cg.I, len(ins))
                rpos += len(ins)
            elif fc_ch == "i":
                if not no_seq:
                    seq[rpos] = val
                emit(cg.I, 1)
                rpos += 1
            elif fc_ch == "P":
                emit(cg.P, val)
            elif fc_ch == "B":
                if not no_seq:
                    seq[rpos] = val[0]
                if qual is not None:
                    qual[fpos - 1] = val[1]
                emit(cg.M, 1)
                rpos += 1
                ref_cursor += 1
            elif fc_ch == "b":
                bb = np.frombuffer(val, np.uint8)
                if not no_seq:
                    seq[rpos : rpos + len(bb)] = bb
                emit(cg.M, len(bb))
                rpos += len(bb)
                ref_cursor += len(bb)
            elif fc_ch == "q":
                # per-base quality run (QQ series); bases unaffected
                if qual is not None:
                    qs = np.frombuffer(val, np.uint8)
                    qual[fpos - 1 : fpos - 1 + len(qs)] = qs
            elif fc_ch == "Q":
                # single quality score (QS series); bases unaffected
                if qual is not None:
                    qual[fpos - 1] = val
            else:
                raise CramFormatError(f"unhandled feature {fc_ch}")
        take_match(rl - rpos)
        # merge adjacent ops of equal code (X features emit unit Ms)
        if not ops:
            return seq, cg.EMPTY.copy()
        merged = [list(ops[0])]
        for code, ln in ops[1:]:
            if merged[-1][0] == code:
                merged[-1][1] += ln
            else:
                merged.append([code, ln])
        return seq, np.array(merged, dtype=np.int64)


def _decode_tag_value(tag: bytes, ty: bytes, raw: bytes):
    """Raw BAM-encoded aux value bytes -> (tag, type, python value)."""
    t = ty
    if t == b"Z" or t == b"H":
        # io/bam.py _decode_tags keeps Z/H values as bytes
        return (tag, t, raw.rstrip(b"\x00"))
    if t == b"A":
        return (tag, t, raw[:1])
    if t in (b"c", b"C", b"s", b"S", b"i", b"I", b"f"):
        fmt = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H",
               b"i": "<i", b"I": "<I", b"f": "<f"}[t]
        v = struct.unpack(fmt, raw[: struct.calcsize(fmt)])[0]
        return (tag, t, float(v) if t == b"f" else int(v))
    if t == b"B":
        sub = raw[:1]
        n = struct.unpack("<i", raw[1:5])[0]
        dt = {b"c": np.int8, b"C": np.uint8, b"s": np.int16, b"S": np.uint16,
              b"i": np.int32, b"I": np.uint32, b"f": np.float32}[sub]
        arr = np.frombuffer(raw, dtype=dt, count=n, offset=5).copy()
        return (tag, b"B", (sub, arr))
    raise CramFormatError(f"unknown tag type {ty!r}")


def check_cram_eof(path: str) -> bool:
    with open(path, "rb") as f:
        ver = f.read(6)[4:6]
        eof = CRAM_EOF_V2 if ver and ver[0] == 2 else CRAM_EOF
        f.seek(0, 2)
        sz = f.tell()
        if sz < len(eof):
            return False
        f.seek(sz - len(eof))
        return f.read(len(eof)) == eof


def is_cram(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == CRAM_MAGIC


# ---------------------------------------------------------------------------
# writer subset (spec-valid CRAM 3.0: RR=0 verbatim-base slices, external
# gzip blocks, names preserved, absolute positions)
# ---------------------------------------------------------------------------

_SERIES_IDS = {
    b"BF": 1, b"CF": 2, b"RI": 3, b"RL": 4, b"AP": 5, b"RG": 6, b"MF": 7,
    b"NS": 8, b"NP": 9, b"TS": 10, b"NF": 11, b"TL": 12, b"FN": 13,
    b"FC": 14, b"FP": 15, b"DL": 16, b"BS": 17, b"HC": 18, b"PD": 19,
    b"RS": 20, b"MQ": 21, b"BA": 22, b"QS": 23,
}
_RN_ID, _IN_ID, _SC_ID, _BB_ID, _QQ_ID, _TAG_ID = 30, 31, 32, 33, 34, 40


class CramWriter:
    """Minimal spec-valid CRAM 2.1/3.0/3.1 writer (one slice per container).

    ``version=(3, 1)`` stamps the 3.1 magic and compresses external blocks
    with rANS Nx16 (method 5) instead of gzip, producing files only a 3.1
    reader accepts — the e2e conformance vector for this repo's 3.1 decode
    path (htslib is not in-image to produce one).  ``version=(2, 1)``
    emits the legacy layout (no container/block CRCs, itf8 record
    counters, the 30-byte v2 EOF, gzip-only block methods) as the
    conformance vector for the 2.1 read path.
    """

    def __init__(
        self,
        path: str,
        header: BamHeader,
        records_per_slice: int = 1000,
        version: tuple[int, int] = (3, 0),
        profile: str = "normal",
        write_index: bool = True,
    ):
        if version not in ((2, 1), (3, 0), (3, 1)):
            raise CramFormatError(f"unsupported CRAM write version {version}")
        if profile not in ("normal", "archive"):
            raise CramFormatError(f"unsupported CRAM profile {profile!r}")
        if profile == "archive" and version < (3, 1):
            raise CramFormatError(
                "the archive profile (fqzcomp/arith blocks) requires "
                "version=(3, 1)"
            )
        self.profile = profile
        self.path = path
        # the reference requires indexed inputs (cli.rs:147-163); writing
        # the .crai alongside makes every file this writer produces directly
        # consumable there (and by CramReader.fetch)
        self._write_index = write_index
        self._crai_entries: list = []
        self.f = open(path, "wb")
        self.header = header
        self.rps = records_per_slice
        self.pending: list[BamRecord] = []
        self.counter = 0
        self.version = version
        self._ext_method = RANSNX16 if version >= (3, 1) else GZIP
        self.f.write(
            CRAM_MAGIC + bytes(version) + b"portello-tpu".ljust(20, b"\x00")
        )
        # CRAM carries references only as @SQ text; synthesize lines for refs
        # absent from the text (htslib keeps text and binary list in sync)
        text = header.text or b""
        have = {
            f.split(":", 1)[1]
            for line in text.decode(errors="replace").splitlines()
            if line.startswith("@SQ")
            for f in line.split("\t")[1:]
            if f.startswith("SN:")
        }
        extra = "".join(
            f"@SQ\tSN:{name}\tLN:{length}\n"
            for name, length in header.refs
            if name not in have
        )
        if extra:
            text = text + extra.encode()
        hdr_payload = struct.pack("<i", len(text)) + text
        blk = write_block(GZIP, FILE_HEADER, 0, hdr_payload, self.version)
        ch = ContainerHeader(len(blk), 0, 0, 0, 0, 0, 0, 1, [0])
        self.f.write(write_container_header(ch, self.version))
        self.f.write(blk)

    def write(self, rec: BamRecord) -> None:
        self.pending.append(rec)
        if len(self.pending) >= self.rps:
            self._flush()

    def close(self) -> None:
        self._flush()
        self.f.write(CRAM_EOF_V2 if self.version < (3, 0) else CRAM_EOF)
        self.f.close()
        if self._write_index:
            from portello_tpu_torch.io.crai import CraiEntry, CraiIndex

            CraiIndex(
                [CraiEntry(*e) for e in self._crai_entries]
            ).save(self.path + ".crai")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _flush(self) -> None:
        if not self.pending:
            return
        recs = self.pending
        self.pending = []

        streams: dict[int, bytearray] = {}
        qs_lens: list[int] = []  # per-record QS lengths (fqzcomp framing)

        def put_itf8(key: bytes, v: int):
            streams.setdefault(_SERIES_IDS[key], bytearray()).extend(write_itf8(v))

        def put_byte(key: bytes, v: int):
            streams.setdefault(_SERIES_IDS[key], bytearray()).append(v & 0xFF)

        def put_raw(cid: int, data: bytes):
            streams.setdefault(cid, bytearray()).extend(data)

        # tag dictionary: one line per distinct tag signature
        td_lines: list[bytes] = []
        td_index: dict[bytes, int] = {}
        tag_encs: dict[int, Encoding] = {}

        multi_ref = len({r.tid for r in recs}) > 1
        s_ref = -2 if multi_ref else recs[0].tid
        starts = [r.pos + 1 for r in recs if r.tid >= 0]
        s_start = min(starts) if starts and not multi_ref else 0
        s_end = 0
        n_bases = 0

        from portello_tpu_torch.io.bam import _encode_tag  # raw value encoding

        for r in recs:
            bf = r.flag & ~(FMUNMAP | FMREVERSE)
            cf = CF_QUAL
            detached = (
                r.mtid != -1 or r.mpos != -1 or r.tlen != 0 or (r.flag & 0x1)
                # unpaired records carrying mate bits: BF strips them, and
                # only the detached path's MF restores them on decode
                or (r.flag & (FMUNMAP | FMREVERSE)) != 0
            )
            if detached:
                cf |= CF_DETACHED
            # mapped record with SEQ '*' (empty seq, real cigar): CF_NO_SEQ.
            # Without the flag, the features would imply BA match bases that
            # are never written, desynchronizing every later record's bases
            # in the shared BA stream.
            no_seq = (
                not (r.flag & FUNMAP) and len(r.seq) == 0 and len(r.cigar) > 0
            )
            if no_seq:
                cf |= CF_NO_SEQ
            put_itf8(b"BF", bf)
            put_itf8(b"CF", cf)
            if multi_ref:
                put_itf8(b"RI", r.tid)
            rl = r.seq_len()
            if no_seq:
                # RL is the cigar's read length for '*'-seq records
                rl = int(sum(
                    int(ln) for code, ln in r.cigar
                    if cg.CONSUMES_READ[int(code)]
                ))
            n_bases += rl
            put_itf8(b"RL", rl)
            put_itf8(b"AP", r.pos + 1)
            put_itf8(b"RG", -1)
            put_raw(_RN_ID, bytes(r.qname) + b"\x00")
            if detached:
                mf = 0
                if r.flag & FMREVERSE:
                    mf |= 1
                if r.flag & FMUNMAP:
                    mf |= 2
                put_itf8(b"MF", mf)
                put_itf8(b"NS", r.mtid)
                put_itf8(b"NP", r.mpos + 1 if r.mpos >= 0 else 0)
                put_itf8(b"TS", r.tlen)
            sig = b"".join(t[0] + t[1] for t in r.tags)
            tl = td_index.get(sig)
            if tl is None:
                tl = len(td_lines)
                td_index[sig] = tl
                td_lines.append(sig)
            put_itf8(b"TL", tl)
            for tag, ty, val in r.tags:
                key = (tag[0] << 16) | (tag[1] << 8) | ty[0]
                raw_val = _encode_tag(tag, ty, val)[3:]
                if key not in tag_encs:
                    tag_encs[key] = Encoding(
                        E_BYTE_ARRAY_LEN,
                        len_enc=Encoding(E_EXTERNAL, content_id=_TAG_ID),
                        val_enc=Encoding(E_EXTERNAL, content_id=_TAG_ID),
                    )
                put_raw(_TAG_ID, write_itf8(len(raw_val)) + raw_val)

            if not (r.flag & FUNMAP):
                # verbatim bases (RR=0): features only for non-M structure
                feats = []
                rpos = 0
                for code, ln in r.cigar:
                    code = int(code)
                    ln = int(ln)
                    if cg.IS_ALIGN_MATCH[code]:
                        rpos += ln
                    elif code == cg.S:
                        val = (b"N" * ln if no_seq
                               else r.seq[rpos : rpos + ln])
                        feats.append((b"S", rpos + 1, val))
                        rpos += ln
                    elif code == cg.I:
                        val = (b"N" * ln if no_seq
                               else r.seq[rpos : rpos + ln])
                        feats.append((b"I", rpos + 1, val))
                        rpos += ln
                    elif code == cg.D:
                        feats.append((b"D", rpos + 1, ln))
                    elif code == cg.N:
                        feats.append((b"N", rpos + 1, ln))
                    elif code == cg.H:
                        feats.append((b"H", rpos + 1, ln))
                    elif code == cg.P:
                        feats.append((b"P", rpos + 1, ln))
                put_itf8(b"FN", len(feats))
                prev = 0
                for fch, fpos, val in feats:
                    put_byte(b"FC", fch[0])
                    put_itf8(b"FP", fpos - prev)
                    prev = fpos
                    if fch == b"S":
                        put_raw(_SC_ID, bytes(val) + b"\x00")
                    elif fch == b"I":
                        put_raw(_IN_ID, bytes(val) + b"\x00")
                    elif fch in (b"D", b"N", b"H", b"P"):
                        put_itf8({b"D": b"DL", b"N": b"RS", b"H": b"HC",
                                  b"P": b"PD"}[fch], val)
                put_itf8(b"MQ", r.mapq)
                # match-region bases go through BA (RR=0); a CF_NO_SEQ
                # record stores none (the reader skips take_match reads)
                if not no_seq:
                    rpos = 0
                    for code, ln in r.cigar:
                        code, ln = int(code), int(ln)
                        if cg.IS_ALIGN_MATCH[code]:
                            put_raw(
                                _SERIES_IDS[b"BA"],
                                bytes(np.asarray(
                                    r.seq[rpos : rpos + ln], np.uint8
                                )),
                            )
                        if cg.CONSUMES_READ[code]:
                            rpos += ln
                qual = r.qual if len(r.qual) == rl else np.full(rl, 0xFF, np.uint8)
                put_raw(_SERIES_IDS[b"QS"], bytes(np.asarray(qual, np.uint8)))
                qs_lens.append(rl)
                if r.tid >= 0:
                    s_end = max(s_end, r.pos + cg.get_cigar_ref_offset(r.cigar))
            else:
                put_raw(
                    _SERIES_IDS[b"BA"], bytes(np.asarray(r.seq, np.uint8))
                )
                qual = r.qual if len(r.qual) == rl else np.full(rl, 0xFF, np.uint8)
                put_raw(_SERIES_IDS[b"QS"], bytes(np.asarray(qual, np.uint8)))
                qs_lens.append(rl)

        # compression header
        pres = bytearray()
        n_pres = 5
        pres += b"RN" + b"\x01"
        pres += b"AP" + b"\x00"
        pres += b"RR" + b"\x00"
        # SM is mandatory (spec 8.4); the zero matrix is consistent with
        # verbatim-base (RR=0) slices, which never emit X features
        pres += b"SM" + b"\x00" * 5
        td_blob = b"".join(line + b"\x00" for line in td_lines)
        pres += b"TD" + write_itf8(len(td_blob)) + td_blob
        pres_map = write_itf8(n_pres) + bytes(pres)

        series_map = bytearray()
        used = []
        for key, cid in _SERIES_IDS.items():
            if cid in streams or key in (b"BF", b"CF", b"RL", b"AP", b"RG",
                                         b"TL", b"FN", b"FC", b"FP", b"MQ",
                                         b"BA", b"QS"):
                used.append((key, Encoding(E_EXTERNAL, content_id=cid)))
        used.append((b"RN", Encoding(E_BYTE_ARRAY_STOP, stop_byte=0,
                                     content_id=_RN_ID)))
        used.append((b"IN", Encoding(E_BYTE_ARRAY_STOP, stop_byte=0,
                                     content_id=_IN_ID)))
        used.append((b"SC", Encoding(E_BYTE_ARRAY_STOP, stop_byte=0,
                                     content_id=_SC_ID)))
        for key, enc in used:
            series_map += key + encode_encoding(enc)
        series_blob = write_itf8(len(used)) + bytes(series_map)

        tag_map = bytearray()
        for key, enc in tag_encs.items():
            tag_map += write_itf8(key) + encode_encoding(enc)
        tag_blob = write_itf8(len(tag_encs)) + bytes(tag_map)

        chdr = (
            write_itf8(len(pres_map)) + pres_map
            + write_itf8(len(series_blob)) + series_blob
            + write_itf8(len(tag_blob)) + tag_blob
        )
        chdr_blk = write_block(GZIP, COMPRESSION_HEADER, 0, chdr, self.version)

        # slice blocks: core (empty) + externals
        ext_ids = sorted(streams)
        blocks = [write_block(RAW, CORE_T, 0, b"", self.version)]
        for cid in ext_ids:
            method = self._ext_method
            if cid == _RN_ID and self.version >= (3, 1):
                method = TOK3  # htslib's 3.1 default for the RN series
            data = bytes(streams[cid])
            if self.profile == "archive":
                # archive profile: fqzcomp for qualities, adaptive
                # arithmetic for base/tag byte streams (the htslib archive
                # layout these codecs exist for)
                if cid == _SERIES_IDS[b"QS"] and qs_lens:
                    from portello_tpu_torch.io import fqzcomp

                    blocks.append(write_block_precompressed(
                        FQZCOMP, EXTERNAL_T, cid,
                        fqzcomp.encode(data, qs_lens), len(data),
                        self.version,
                    ))
                    continue
                if cid in (_SERIES_IDS[b"BA"], _TAG_ID):
                    from portello_tpu_torch.io import arith_nx16

                    blocks.append(write_block_precompressed(
                        ARITH, EXTERNAL_T, cid,
                        arith_nx16.encode(data, order=1), len(data),
                        self.version,
                    ))
                    continue
            blocks.append(
                write_block(method, EXTERNAL_T, cid, data, self.version)
            )

        span = max(s_end - (s_start - 1), 0) if not multi_ref and starts else 0
        sh = bytearray()
        sh += write_itf8(s_ref)
        sh += write_itf8(s_start if starts and not multi_ref else 0)
        sh += write_itf8(span)
        sh += write_itf8(len(recs))
        if self.version >= (3, 0):
            sh += write_ltf8(self.counter)
        else:
            sh += write_itf8(self.counter)
        sh += write_itf8(len(blocks))
        # content-id list covers EXTERNAL blocks only (htslib convention:
        # num_content_ids = num_blocks - 1; the core block has no id)
        sh += write_itf8(len(ext_ids))
        for cid in ext_ids:
            sh += write_itf8(cid)
        sh += write_itf8(-1)  # no embedded reference
        sh += b"\x00" * 16    # MD5 (unchecked by this reader)
        # spec section 8.5: the slice header block MUST be uncompressed
        # (htslib rejects non-RAW slice headers)
        sh_blk = write_block(RAW, SLICE_HEADER, 0, bytes(sh), self.version)

        body = chdr_blk + sh_blk + b"".join(blocks)
        h = ContainerHeader(
            len(body),
            s_ref,
            s_start if starts and not multi_ref else 0,
            span,
            len(recs),
            self.counter,
            n_bases,
            1 + 1 + len(blocks),
            [len(chdr_blk)],
        )
        self.counter += len(recs)
        c_off = self.f.tell()
        self.f.write(write_container_header(h, self.version))
        self.f.write(body)
        # .crai entries for this container's single slice: landmark[0] is the
        # slice header block's offset from the container-header end; multi-ref
        # slices emit one line per contained reference (htslib convention)
        slice_off = len(chdr_blk)
        slice_size = len(body) - slice_off
        if multi_ref:
            per: dict[int, list[int]] = {}
            for r in recs:
                if r.tid < 0:
                    per.setdefault(-1, [0, 0])
                    continue
                end0 = r.pos + max(int(cg.get_cigar_ref_offset(r.cigar)), 1)
                lohi = per.setdefault(r.tid, [r.pos, end0])
                lohi[0] = min(lohi[0], r.pos)
                lohi[1] = max(lohi[1], end0)
            for tid in sorted(per):
                lo, hi = per[tid]
                if tid < 0:
                    self._crai_entries.append(
                        (-1, 0, 0, c_off, slice_off, slice_size)
                    )
                else:
                    self._crai_entries.append(
                        (tid, lo + 1, hi - lo, c_off, slice_off, slice_size)
                    )
        else:
            self._crai_entries.append((
                s_ref,
                s_start if starts and not multi_ref else 0,
                span,
                c_off, slice_off, slice_size,
            ))
