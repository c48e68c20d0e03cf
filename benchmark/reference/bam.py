"""BAM records and a sequential reader, in plain Python and numpy.

A frozen copy of the port's record codec (SAM spec section 4), without its
index, its C++ codec and its writer: the benchmark's reference reads the
inputs and the program's outputs with it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.bgzf import BgzfReader
from benchmark.reference import cigar as cg



def bam_reg2bin(beg: int, end: int) -> int:
    """The BAM record bin field (SAM spec section 5.3, min_shift 14, depth 5)."""
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


# --- flags (SAM spec section 1.4) ------------------------------------------
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

# --- 4-bit base coding ------------------------------------------------------
SEQ_CHARS = b"=ACMGRSVTWYHKDBN"
_SEQ_DECODE = np.frombuffer(SEQ_CHARS, dtype=np.uint8)
# packed byte -> both ASCII chars in one gather (2.5x over two fancy-indexes
# + strided stores at long reads; byte pairs viewed as uint16, endian-safe)
_SEQ_DECODE2 = np.empty((256, 2), np.uint8)
_SEQ_DECODE2[:, 0] = _SEQ_DECODE[np.arange(256) >> 4]
_SEQ_DECODE2[:, 1] = _SEQ_DECODE[np.arange(256) & 0xF]
_SEQ_DECODE2 = _SEQ_DECODE2.reshape(-1).view(np.uint16)
_SEQ_ENCODE = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(SEQ_CHARS):
    _SEQ_ENCODE[_c] = _i
    _SEQ_ENCODE[ord(chr(_c).lower())] = _i

_AUX_SCALAR = {
    b"A": ("<c", 1), b"c": ("<b", 1), b"C": ("<B", 1), b"s": ("<h", 2),
    b"S": ("<H", 2), b"i": ("<i", 4), b"I": ("<I", 4), b"f": ("<f", 4),
}
_B_DTYPES = {
    b"c": np.int8, b"C": np.uint8, b"s": np.int16, b"S": np.uint16,
    b"i": np.int32, b"I": np.uint32, b"f": np.float32,
}


@dataclass
class BamHeader:
    """Header: SAM text + binary reference list."""

    text: bytes = b""
    refs: list[tuple[str, int]] = field(default_factory=list)

    def reference_sequences(self) -> list[tuple[str, int]]:
        return self.refs

    def encode(self) -> bytes:
        out = bytearray(b"BAM\x01")
        out += struct.pack("<i", len(self.text))
        out += self.text
        out += struct.pack("<i", len(self.refs))
        for name, length in self.refs:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        return bytes(out)

    @staticmethod
    def from_refs(refs, text: bytes = b"") -> "BamHeader":
        return BamHeader(text=text, refs=list(refs))


class BamFormatError(ValueError):
    pass


@dataclass
class BamRecord:
    """One alignment record, decoded into mutable fields.

    Mirrors rust-htslib ``bam::Record`` surface where the reference uses it:
    flags/tid/pos/mapq/cigar/seq/qual access, aux tag get/remove/push,
    set_unmapped/set_supplementary etc.
    """

    qname: bytes = b"*"
    flag: int = 0
    tid: int = -1
    pos: int = -1
    mapq: int = 255
    cigar: np.ndarray = field(default_factory=lambda: cg.EMPTY.copy())
    mtid: int = -1
    mpos: int = -1
    tlen: int = 0
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))  # ASCII
    qual: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    tags: list[tuple[bytes, bytes, object]] = field(default_factory=list)
    # Raw bytes as decoded (None once mutated); enables lossless pass-through.
    raw: bytes | None = None

    # -- flag helpers (rust-htslib Record API parity) --
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    def set_flags(self, flag: int) -> None:
        self.flag = flag
        self.raw = None

    def set_unmapped(self) -> None:
        self.flag |= FUNMAP
        self.raw = None

    def set_supplementary(self) -> None:
        self.flag |= FSUPPLEMENTARY
        self.raw = None

    def unset_supplementary(self) -> None:
        self.flag &= ~FSUPPLEMENTARY
        self.raw = None

    def seq_len(self) -> int:
        return len(self.seq)

    def alignment_end(self) -> int:
        """End reference position (zero-indexed, exclusive); pos+1 when
        unmapped/cigarless (htslib bam_endpos; reference bam_record_utils.rs:21-27)."""
        if self.is_unmapped() or len(self.cigar) == 0:
            return self.pos + 1
        return self.pos + cg.get_cigar_ref_offset(self.cigar)

    # -- aux tags (reference bam_utils/aux/mod.rs:25-103 parity) --
    def get_tag(self, tag: bytes):
        for t, ty, val in self.tags:
            if t == tag:
                return ty, val
        return None

    def get_string_tag(self, tag: bytes) -> str | None:
        got = self.get_tag(tag)
        if got is None:
            return None
        ty, val = got
        if ty not in (b"Z", b"H"):
            raise BamFormatError(
                f"Unexpected {tag.decode()} tag format in read "
                f"{self.qname.decode()}: {ty}"
            )
        return val.decode()

    def get_int_tag(self, tag: bytes) -> int | None:
        got = self.get_tag(tag)
        if got is None:
            return None
        ty, val = got
        if ty not in (b"c", b"C", b"s", b"S", b"i", b"I"):
            raise BamFormatError(
                f"Unexpected {tag.decode()} tag format in read "
                f"{self.qname.decode()}: {ty}"
            )
        return int(val)

    def get_float_tag(self, tag: bytes) -> float | None:
        """Typed float aux getter (reference bam_utils/aux/mod.rs:25-103):
        accepts a float tag, errors on any other type."""
        got = self.get_tag(tag)
        if got is None:
            return None
        ty, val = got
        if ty != b"f":
            raise BamFormatError(
                f"Unexpected {tag.decode()} tag format in read "
                f"{self.qname.decode()}: {ty}"
            )
        return float(val)

    def remove_tag(self, tag: bytes) -> None:
        n = len(self.tags)
        self.tags = [t for t in self.tags if t[0] != tag]
        if len(self.tags) != n:
            self.raw = None

    def push_tag(self, tag: bytes, type_char: bytes, value) -> None:
        self.tags.append((tag, type_char, value))
        self.raw = None

    def touch(self) -> None:
        """Mark mutated (invalidate raw pass-through bytes)."""
        self.raw = None

    # -- codec --
    @staticmethod
    def decode(raw: bytes, lazy: bool = False) -> "BamRecord":
        """Decode one record.  ``lazy=True`` defers seq/qual materialization
        to first attribute access (phase-1 contig scan touches ``seq`` only
        for reverse-strand contigs; eagerly expanding a multi-Mb assembly
        contig sequence dominated that scan)."""
        (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, mtid,
         mpos, tlen) = struct.unpack_from("<iiBBHHHiiii", raw, 0)
        off = 32
        qname = raw[off : off + l_read_name - 1]
        off += l_read_name
        cigar_u32 = np.frombuffer(raw, dtype="<u4", count=n_cigar, offset=off)
        off += 4 * n_cigar
        cigar = np.empty((n_cigar, 2), dtype=np.int64)
        cigar[:, 0] = cigar_u32 & 0xF
        cigar[:, 1] = cigar_u32 >> 4
        nseq_bytes = (l_seq + 1) // 2
        seq_off = off
        off += nseq_bytes + l_seq
        tags = _decode_tags(raw, off)
        if lazy:
            rec = LazyBamRecord(
                qname=qname, flag=flag, tid=tid, pos=pos, mapq=mapq,
                cigar=cigar, mtid=mtid, mpos=mpos, tlen=tlen, tags=tags,
                raw=raw,
            )
            rec._seq = None
            rec._qual = None
            rec._lazy_src = (raw, seq_off, l_seq)
        else:
            packed = np.frombuffer(
                raw, dtype=np.uint8, count=nseq_bytes, offset=seq_off
            )
            seq = _SEQ_DECODE2[packed].view(np.uint8)[:l_seq]
            qual = np.frombuffer(
                raw, dtype=np.uint8, count=l_seq, offset=seq_off + nseq_bytes
            ).copy()
            rec = BamRecord(
                qname=qname, flag=flag, tid=tid, pos=pos, mapq=mapq,
                cigar=cigar, mtid=mtid, mpos=mpos, tlen=tlen, seq=seq,
                qual=qual, tags=tags, raw=raw,
            )
        # Long-CIGAR records: placeholder kSmN with real cigar in CG:B,I
        # (SAM spec section 4.2.2); htslib decodes transparently.
        if (
            n_cigar == 2
            and cigar[0, 0] == cg.S
            and cigar[0, 1] == l_seq
            and cigar[1, 0] == cg.N
        ):
            got = rec.get_tag(b"CG")
            if got is not None and got[0] == b"B":
                sub, arr = got[1]
                if sub == b"I":
                    u = np.asarray(arr, dtype=np.uint32)
                    real = np.empty((len(u), 2), dtype=np.int64)
                    real[:, 0] = u & 0xF
                    real[:, 1] = u >> 4
                    rec.cigar = real
                    rec.remove_tag(b"CG")
                    rec.raw = None
        return rec

    def encode(self) -> bytes:
        if self.raw is not None:
            return self.raw
        cigar = self.cigar
        tags = self.tags
        l_seq = len(self.seq)
        if len(cigar) > 0xFFFF:
            ref_len = cg.get_cigar_ref_offset(cigar)
            cig_u32 = (cigar[:, 1].astype(np.uint32) << 4) | cigar[:, 0].astype(
                np.uint32
            )
            tags = list(tags) + [(b"CG", b"B", (b"I", cig_u32))]
            cigar = np.array([[cg.S, l_seq], [cg.N, ref_len]], dtype=np.int64)
        qname = self.qname or b"*"
        l_read_name = len(qname) + 1
        if self.is_unmapped() or len(cigar) == 0:
            rbin = bam_reg2bin(max(self.pos, 0), max(self.pos, 0) + 1)
        else:
            rbin = bam_reg2bin(self.pos, self.pos + cg.get_cigar_ref_offset(cigar))
        # the record bin field is u16; past the BAI limit (CSI-scale contigs)
        # reg2bin exceeds it and htslib truncates on write — readers never
        # consult the record bin there (the index drives region queries)
        rbin &= 0xFFFF
        out = bytearray(
            struct.pack(
                "<iiBBHHHiiii",
                self.tid, self.pos, l_read_name, self.mapq, rbin, len(cigar),
                self.flag, l_seq, self.mtid, self.mpos, self.tlen,
            )
        )
        out += qname + b"\x00"
        cig_u32 = (cigar[:, 1].astype("<u4") << 4) | cigar[:, 0].astype("<u4")
        out += cig_u32.tobytes()
        codes = _SEQ_ENCODE[self.seq]
        if l_seq % 2:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        out += ((codes[0::2] << 4) | codes[1::2]).tobytes()
        qual = self.qual
        if len(qual) != l_seq:
            qual = np.full(l_seq, 0xFF, np.uint8)
        out += qual.tobytes()
        for tag, ty, val in tags:
            out += _encode_tag(tag, ty, val)
        return bytes(out)

    # -- SAM text (test fixtures; reference builds fixtures with
    #    bam::Record::from_sam, e.g. split_read.rs:157-233) --
    @staticmethod
    def from_sam(header: BamHeader, line: str | bytes) -> "BamRecord":
        if isinstance(line, bytes):
            line = line.decode()
        f = line.rstrip("\n").split("\t")
        name_to_tid = {name: i for i, (name, _) in enumerate(header.refs)}
        rec = BamRecord(
            qname=f[0].encode(),
            flag=int(f[1]),
            tid=name_to_tid[f[2]] if f[2] != "*" else -1,
            pos=int(f[3]) - 1,
            mapq=int(f[4]),
            cigar=cg.from_string(f[5]),
            mtid=(
                name_to_tid[f[6]]
                if f[6] not in ("*", "=")
                else (-1 if f[6] == "*" else name_to_tid[f[2]])
            ),
            mpos=int(f[7]) - 1,
            tlen=int(f[8]),
            seq=(
                np.frombuffer(f[9].encode(), np.uint8).copy()
                if f[9] != "*"
                else np.zeros(0, np.uint8)
            ),
        )
        if f[10] != "*":
            rec.qual = np.frombuffer(f[10].encode(), np.uint8) - 33
        else:
            rec.qual = np.full(len(rec.seq), 0xFF, np.uint8)
        for tagstr in f[11:]:
            tag, ty, val = tagstr.split(":", 2)
            rec.tags.append(_tag_from_sam(tag, ty, val))
        return rec

    def to_sam(self, header: BamHeader) -> str:
        rname = header.refs[self.tid][0] if self.tid >= 0 else "*"
        mrname = (
            "="
            if self.mtid == self.tid and self.tid >= 0
            else (header.refs[self.mtid][0] if self.mtid >= 0 else "*")
        )
        seq = self.seq.tobytes().decode() if len(self.seq) else "*"
        if len(self.qual) and not np.all(self.qual == 0xFF):
            qual = (self.qual + 33).tobytes().decode()
        else:
            qual = "*"
        fields = [
            self.qname.decode(), str(self.flag), rname, str(self.pos + 1),
            str(self.mapq), cg.to_string(self.cigar), mrname, str(self.mpos + 1),
            str(self.tlen), seq, qual,
        ]
        for tag, ty, val in self.tags:
            fields.append(_tag_to_sam(tag, ty, val))
        return "\t".join(fields)


class LazyBamRecord(BamRecord):
    """BamRecord whose seq/qual materialize on first access from the raw
    record bytes.  Produced by ``BamRecord.decode(raw, lazy=True)``; raw
    bytes are immutable so the deferred view stays valid even after field
    mutation clears ``self.raw``."""

    _lazy_src: tuple = (b"", 0, 0)

    @property
    def seq(self) -> np.ndarray:
        s = self._seq
        if s is None:
            raw, off, l_seq = self._lazy_src
            packed = np.frombuffer(
                raw, dtype=np.uint8, count=(l_seq + 1) // 2, offset=off
            )
            s = self._seq = _SEQ_DECODE2[packed].view(np.uint8)[:l_seq]
        return s

    @seq.setter
    def seq(self, value) -> None:
        self._seq = value

    @property
    def qual(self) -> np.ndarray:
        q = self._qual
        if q is None:
            raw, off, l_seq = self._lazy_src
            q = self._qual = np.frombuffer(
                raw, dtype=np.uint8, count=l_seq, offset=off + (l_seq + 1) // 2
            ).copy()
        return q

    @qual.setter
    def qual(self, value) -> None:
        self._qual = value

    def seq_len(self) -> int:
        return self._lazy_src[2] if self._seq is None else len(self._seq)


def _decode_tags(raw: bytes, off: int) -> list[tuple[bytes, bytes, object]]:
    tags = []
    end = len(raw)
    while off + 3 <= end:
        tag = raw[off : off + 2]
        ty = raw[off + 2 : off + 3]
        off += 3
        if ty in _AUX_SCALAR:
            fmt, size = _AUX_SCALAR[ty]
            (val,) = struct.unpack_from(fmt, raw, off)
            off += size
            if ty == b"A":
                val = val  # bytes of length 1
        elif ty in (b"Z", b"H"):
            z = raw.index(b"\x00", off)
            val = raw[off:z]
            off = z + 1
        elif ty == b"B":
            sub = raw[off : off + 1]
            (count,) = struct.unpack_from("<i", raw, off + 1)
            dt = _B_DTYPES[sub]
            arr = np.frombuffer(
                raw, dtype=dt, count=count, offset=off + 5
            ).copy()
            val = (sub, arr)
            off += 5 + count * dt().itemsize
        else:
            raise BamFormatError(f"unknown aux type {ty!r}")
        tags.append((tag, ty, val))
    return tags


def _encode_tag(tag: bytes, ty: bytes, val) -> bytes:
    out = tag + ty
    if ty in _AUX_SCALAR:
        fmt, _ = _AUX_SCALAR[ty]
        if ty == b"A" and isinstance(val, (bytes, bytearray)):
            out += struct.pack(fmt, bytes(val[:1]))
        else:
            out += struct.pack(fmt, val)
    elif ty in (b"Z", b"H"):
        v = val.encode() if isinstance(val, str) else bytes(val)
        out += v + b"\x00"
    elif ty == b"B":
        sub, arr = val
        arr = np.asarray(arr, dtype=_B_DTYPES[sub])
        out += sub + struct.pack("<i", len(arr)) + arr.tobytes()
    else:
        raise BamFormatError(f"unknown aux type {ty!r}")
    return out


def _tag_from_sam(tag: str, ty: str, val: str):
    t = tag.encode()
    if ty == "i":
        v = int(val)
        # SAM 'i' covers the uint32 range; htslib stores the smallest
        # fitting BAM type (values past int32 encode as 'I')
        if v > 0x7FFFFFFF:
            return t, b"I", v
        return t, b"i", v
    if ty == "f":
        return t, b"f", float(val)
    if ty == "A":
        return t, b"A", val.encode()
    if ty in ("Z", "H"):
        return t, ty.encode(), val.encode()
    if ty == "B":
        sub = val[0].encode()
        nums = val[2:].split(",") if len(val) > 2 else []
        dt = _B_DTYPES[sub]
        arr = np.array(
            [float(x) if sub == b"f" else int(x) for x in nums], dtype=dt
        )
        return t, b"B", (sub, arr)
    raise BamFormatError(f"unknown SAM tag type {ty}")


def _tag_to_sam(tag: bytes, ty: bytes, val) -> str:
    t = tag.decode()
    if ty in (b"c", b"C", b"s", b"S", b"i", b"I"):
        return f"{t}:i:{int(val)}"
    if ty == b"f":
        return f"{t}:f:{val:g}"
    if ty == b"A":
        return f"{t}:A:{val.decode() if isinstance(val, bytes) else val}"
    if ty in (b"Z", b"H"):
        return f"{t}:{ty.decode()}:{val.decode() if isinstance(val, bytes) else val}"
    if ty == b"B":
        sub, arr = val
        # %g for float elements (htslib formatting; str() would expand
        # float32 values to their full double repr)
        fmt = (lambda x: f"{x:g}") if sub == b"f" else str
        return f"{t}:B:{sub.decode()}," + ",".join(fmt(x) for x in arr.tolist())
    raise BamFormatError(f"unknown aux type {ty!r}")


class BamReader:
    """Sequential BAM reader over the pure-Python BGZF codec."""

    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise BamFormatError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        text = self._bgzf.read(l_text)
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            name = self._bgzf.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._bgzf.read(4))
            refs.append((name, l_ref))
        self.header = BamHeader(text=text, refs=refs)

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def iter_raw(self):
        """Yield raw record payloads from the current position."""
        while True:
            szb = self._bgzf.read(4)
            if len(szb) < 4:
                return
            (block_size,) = struct.unpack("<i", szb)
            raw = self._bgzf.read(block_size)
            if len(raw) < block_size:
                raise BamFormatError("truncated BAM record")
            yield raw

    def __iter__(self):
        for raw in self.iter_raw():
            yield BamRecord.decode(raw)
