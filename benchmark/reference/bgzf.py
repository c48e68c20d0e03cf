"""BGZF (blocked gzip) reader: a frozen copy of the port's pure-Python codec.

The BAM container format: a series of gzip members, each with a BC extra
subfield recording the compressed block size, supporting virtual-offset random
access (coffset << 16 | uoffset).  Replaces htslib's bgzf.c for this framework.
Format per SAM spec section 4.1.
"""

from __future__ import annotations

import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<BBBBIBBH")  # gzip member header (10 bytes)
_SUBFIELD = struct.Struct("<2sH")

MAX_BLOCK = 0x10000  # 64 KiB uncompressed block payload cap


class BgzfError(ValueError):
    pass


def _read_block_at(raw: bytes, coffset: int) -> tuple[bytes, int]:
    """Decode one BGZF block starting at byte ``coffset``.

    Returns (uncompressed payload, compressed size).
    """
    if coffset + 12 > len(raw):
        raise BgzfError("truncated BGZF block header")
    magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = _HEADER.unpack_from(
        raw, coffset
    )
    if magic1 != 0x1F or magic2 != 0x8B or method != 8 or not flags & 4:
        raise BgzfError("not a BGZF block")
    # Scan extra subfields for BC (BSIZE).
    xs = coffset + 12
    xend = xs + xlen
    bsize = None
    while xs + 4 <= xend:
        si, slen = _SUBFIELD.unpack_from(raw, xs)
        if si == b"BC" and slen == 2:
            bsize = struct.unpack_from("<H", raw, xs + 4)[0] + 1
        xs += 4 + slen
    if bsize is None:
        raise BgzfError("BGZF block missing BC subfield")
    cdata_start = coffset + 12 + xlen
    cdata_end = coffset + bsize - 8
    isize = struct.unpack_from("<I", raw, coffset + bsize - 4)[0]
    data = zlib.decompress(raw[cdata_start:cdata_end], wbits=-15)
    if len(data) != isize:
        raise BgzfError("BGZF block ISIZE mismatch")
    return data, bsize


def check_eof_marker(path: str) -> bool:
    """True if the file ends with the BGZF EOF marker (htslib hts_check_EOF
    equivalent; reference bam_reader_utils.rs:19-43 aborts when missing)."""
    with open(path, "rb") as f:
        f.seek(0, io.SEEK_END)
        size = f.tell()
        if size < len(BGZF_EOF):
            return False
        f.seek(size - len(BGZF_EOF))
        return f.read(len(BGZF_EOF)) == BGZF_EOF


class BgzfReader:
    """Random-access BGZF reader over an in-memory or mmapped file image.

    For simplicity and speed the whole compressed file is mapped (BAM inputs
    are seekable local files); blocks are inflated on demand with a one-block
    cache for sequential scans.
    """

    def __init__(self, path: str):
        import mmap

        self._f = open(path, "rb")
        try:
            self._raw = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            self._raw = b""
        self._block_coffset = -1
        self._block = b""
        self._block_csize = 0
        # Sequential cursor (virtual offset).
        self._coffset = 0
        self._uoffset = 0

    def close(self) -> None:
        if self._f is not None:
            if not isinstance(self._raw, bytes):
                self._raw.close()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def file_size(self) -> int:
        return len(self._raw)

    def _load_block(self, coffset: int) -> None:
        if coffset != self._block_coffset:
            self._block, self._block_csize = _read_block_at(self._raw, coffset)
            self._block_coffset = coffset

    def seek_voffset(self, voffset: int) -> None:
        self._coffset = voffset >> 16
        self._uoffset = voffset & 0xFFFF

    def tell_voffset(self) -> int:
        # htslib normalizes an exhausted block to (next_block << 16 | 0);
        # matching it keeps boundary voffsets (index chunk ends) compatible
        # with htslib-built indexes and avoids uoffset==65536 overflowing
        # into the coffset bits for spec-max blocks (ptio.cc parity).
        if (
            self._coffset == self._block_coffset
            and self._block
            and self._uoffset >= len(self._block)
        ):
            return (self._coffset + self._block_csize) << 16
        return (self._coffset << 16) | self._uoffset

    def at_eof(self) -> bool:
        if self._coffset >= len(self._raw):
            return True
        if self._raw[self._coffset : self._coffset + len(BGZF_EOF)] == BGZF_EOF and (
            self._coffset + len(BGZF_EOF) == len(self._raw)
        ):
            return True
        return False

    def read(self, n: int) -> bytes:
        """Read exactly n uncompressed bytes from the cursor (short at EOF)."""
        out = bytearray()
        while n > 0:
            if self._coffset >= len(self._raw):
                break
            self._load_block(self._coffset)
            block = self._block
            if self._uoffset >= len(block):
                # advance to next block (also skips zero-length blocks/EOF)
                self._coffset += self._block_csize
                self._uoffset = 0
                continue
            take = min(n, len(block) - self._uoffset)
            out += block[self._uoffset : self._uoffset + take]
            self._uoffset += take
            n -= take
        return bytes(out)


def _blocks(data: bytes):
    """The (start, end) of each BGZF member of ``data``."""
    out = []
    at = 0
    while at + 18 <= len(data):
        xlen = struct.unpack_from("<H", data, at + 10)[0]
        bsize = None
        xs = at + 12
        while xs < at + 12 + xlen:
            si, slen = data[xs:xs + 2], struct.unpack_from("<H", data, xs + 2)[0]
            if si == b"BC":
                bsize = struct.unpack_from("<H", data, xs + 4)[0] + 1
            xs += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without a BC subfield")
        out.append((at + 12 + xlen, at + bsize - 8))
        at += bsize
    return out


def inflate(path: str, threads: int = 8) -> bytes:
    """The whole uncompressed stream of a BGZF file."""
    with open(path, "rb") as f:
        data = f.read()
    spans = _blocks(data)
    with ThreadPoolExecutor(threads) as pool:
        parts = list(pool.map(
            lambda s: zlib.decompress(data[s[0]:s[1]], wbits=-15), spans))
    return b"".join(parts)


def raw_records(path: str, threads: int = 8):
    """Every raw record of a BAM file, in order, as a view into the
    inflated stream."""
    buf = memoryview(inflate(path, threads))
    if buf[:4] != b"BAM\1":
        raise ValueError(f"{path}: not a BAM file")
    at = 8 + struct.unpack_from("<i", buf, 4)[0]
    (n_ref,) = struct.unpack_from("<i", buf, at)
    at += 4
    for _ in range(n_ref):
        at += 8 + struct.unpack_from("<i", buf, at)[0]
    end = len(buf)
    while at + 4 <= end:
        (size,) = struct.unpack_from("<i", buf, at)
        if at + 4 + size > end:
            raise ValueError(f"{path}: truncated record")
        yield buf[at + 4:at + 4 + size]
        at += 4 + size
    if at != end:
        raise ValueError(f"{path}: trailing bytes")
