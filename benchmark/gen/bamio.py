"""The generator's own BAM, BGZF and BAI writer (SAM spec sections 4 and 5).

It imports nothing of the program.  Records are packed one by one from numpy
arrays; the BGZF stream is cut into fixed blocks that a thread pool deflates
(``zlib`` releases the interpreter lock), so the bytes depend only on the
records and the level.  The BAI is built from the offsets the writer knows.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# BAM op codes (SAM spec section 4.2): M I D N S H P = X
M, I, D, N, S, H, P, EQ, X = range(9)
_REF_OPS = np.zeros(16, bool)
_REF_OPS[[M, D, N, EQ, X]] = True
_READ_OPS = np.zeros(16, bool)
_READ_OPS[[M, I, S, EQ, X]] = True
CIGAR_CHARS = "MIDNSHP=X"

FREVERSE, FUNMAP, FSUPPLEMENTARY = 0x10, 0x4, 0x800

_SEQ_CODE = np.full(256, 15, np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _SEQ_CODE[_c] = _i

BLOCK = 0xFF00  # uncompressed bytes per BGZF block, as htslib writes them
_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_REC = struct.Struct("<iiBBHHHiiii")


def ref_len(cigar: np.ndarray) -> int:
    return int(cigar[_REF_OPS[cigar[:, 0]], 1].sum()) if len(cigar) else 0


def read_len(cigar: np.ndarray) -> int:
    return int(cigar[_READ_OPS[cigar[:, 0]], 1].sum()) if len(cigar) else 0


def cigar_str(cigar: np.ndarray) -> str:
    return "".join(f"{n}{CIGAR_CHARS[c]}" for c, n in cigar.tolist())


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def _tag(tag: bytes, ty: bytes, val) -> bytes:
    if ty == b"Z":
        return tag + b"Z" + val.encode() + b"\0"
    if ty == b"B":  # (subtype, uint32 array): the long-CIGAR CG tag only
        sub, arr = val
        return tag + b"B" + sub + struct.pack("<i", len(arr)) + arr.tobytes()
    fmt = {b"i": "<i", b"f": "<f", b"C": "<B"}[ty]
    return tag + ty + struct.pack(fmt, val)


def encode_record(qname: bytes, flag: int, tid: int, pos: int, mapq: int,
                  cigar: np.ndarray, seq: np.ndarray, qual: np.ndarray | None,
                  tags=()) -> bytes:
    """One BAM record without its length prefix.  ``seq`` holds ASCII bases,
    ``qual`` Phred values (None: absent, written as 0xFF); a CIGAR of more
    than 65,535 ops goes to a CG tag behind a kSmN placeholder."""
    l_seq = len(seq)
    tags = list(tags)
    end = pos + max(ref_len(cigar), 1)
    if len(cigar) > 0xFFFF:
        u32 = (cigar[:, 1].astype("<u4") << 4) | cigar[:, 0].astype("<u4")
        tags.append((b"CG", b"B", (b"I", u32)))
        cigar = np.array([[S, l_seq], [N, end - pos]], np.int64)
    rbin = reg2bin(max(pos, 0), max(pos, 0) + 1) if tid < 0 else reg2bin(pos, end)
    out = bytearray(_REC.pack(tid, pos, len(qname) + 1, mapq, rbin & 0xFFFF,
                              len(cigar), flag, l_seq, -1, -1, 0))
    out += qname + b"\0"
    out += ((cigar[:, 1].astype("<u4") << 4) | cigar[:, 0].astype("<u4")).tobytes()
    codes = _SEQ_CODE[seq]
    if l_seq % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    out += ((codes[0::2] << 4) | codes[1::2]).tobytes()
    out += (np.full(l_seq, 0xFF, np.uint8) if qual is None else qual).tobytes()
    for t in tags:
        out += _tag(*t)
    return bytes(out)


def _deflate(args) -> bytes:
    data, level = args
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    return (struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2,
                        len(body) + 25)
            + body + struct.pack("<II", zlib.crc32(data), len(data)))


class BamFile:
    """Writes a coordinate-sorted BAM and its BAI.

    Records go in as ``add(raw, tid, pos, end, unmapped)``; ``close`` deflates
    the stream in ``BLOCK``-sized pieces on ``threads`` threads and writes the
    index beside it."""

    def __init__(self, path: str, header_text: str, refs, level: int = 6,
                 threads: int = 8):
        self.path, self.level, self.threads = path, level, threads
        self.refs = list(refs)
        h = bytearray(b"BAM\1")
        text = header_text.encode()
        h += struct.pack("<i", len(text)) + text + struct.pack("<i", len(self.refs))
        for name, length in self.refs:
            h += struct.pack("<i", len(name) + 1) + name.encode() + b"\0"
            h += struct.pack("<i", length)
        self.buf = bytearray(h)
        self.spans = []  # (tid, pos, end, unmapped, u_start, u_end)

    def add(self, raw: bytes, tid: int, pos: int, end: int, unmapped: bool) -> None:
        start = len(self.buf)
        self.buf += struct.pack("<i", len(raw)) + raw
        self.spans.append((tid, pos, end, unmapped, start, len(self.buf)))

    def close(self) -> None:
        data = memoryview(self.buf)
        pieces = [(data[i:i + BLOCK], self.level) for i in range(0, len(data), BLOCK)]
        with ThreadPoolExecutor(self.threads) as pool:
            blocks = list(pool.map(_deflate, pieces))
        del pieces
        data.release()
        self.buf = bytearray()
        coff = np.zeros(len(blocks) + 1, np.int64)
        np.cumsum([len(b) for b in blocks], out=coff[1:])
        with open(self.path, "wb") as f:
            for b in blocks:
                f.write(b)
            f.write(_EOF)

        def voff(u: int) -> int:
            k = u // BLOCK
            return int(coff[k]) << 16 | (u - k * BLOCK)

        self._write_bai(voff)

    def _write_bai(self, voff) -> None:
        per_ref = [dict(bins={}, linear={}, counts=[0, 0], vr=[None, None])
                   for _ in self.refs]
        n_no_coor = 0
        for tid, pos, end, unmapped, u0, u1 in self.spans:
            if tid < 0:
                n_no_coor += 1
                continue
            r = per_ref[tid]
            v0, v1 = voff(u0), voff(u1)
            chunks = r["bins"].setdefault(reg2bin(pos, end), [])
            if chunks and chunks[-1][1] == v0:
                chunks[-1][1] = v1
            else:
                chunks.append([v0, v1])
            lin = r["linear"]
            for w in range(pos >> 14, ((end - 1) >> 14) + 1):
                if w not in lin or lin[w] > v0:
                    lin[w] = v0
            r["counts"][1 if unmapped else 0] += 1
            r["vr"][0] = v0 if r["vr"][0] is None else min(r["vr"][0], v0)
            r["vr"][1] = v1 if r["vr"][1] is None else max(r["vr"][1], v1)
        out = bytearray(b"BAI\1") + struct.pack("<i", len(self.refs))
        for r in per_ref:
            meta = r["vr"][0] is not None
            out += struct.pack("<i", len(r["bins"]) + meta)
            for b in sorted(r["bins"]):
                out += struct.pack("<Ii", b, len(r["bins"][b]))
                for cb, ce in r["bins"][b]:
                    out += struct.pack("<QQ", cb, ce)
            if meta:
                out += struct.pack("<IiQQQQ", 37450, 2, r["vr"][0], r["vr"][1],
                                   *r["counts"])
            lin, filled, prev = r["linear"], [], 0
            for w in range((max(lin) + 1) if lin else 0):
                prev = lin.get(w, prev)
                filled.append(prev)
            out += struct.pack("<i", len(filled)) + struct.pack(f"<{len(filled)}Q", *filled)
        out += struct.pack("<Q", n_no_coor)
        with open(self.path + ".bai", "wb") as f:
            f.write(bytes(out))
