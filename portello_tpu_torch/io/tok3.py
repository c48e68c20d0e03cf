"""CRAM 3.1 name-tokeniser codec (block method 8, "tok3").

htslib compresses the RN (read name) data series with this codec by
default at CRAM 3.1, so reading real 3.1 output needs it (the reference
accepts such files through htslib — reference src/cli.rs:25,32).

Model per hts-specs/CRAMcodecs "Name tokenisation": each name is split
into tokens (digit runs, character runs, single punctuation); every name
is coded relative to an earlier name — token-for-token MATCH / numeric
DELTA / literal — and the per-(position, type) token streams are entropy
coded with rANS Nx16.  Serialised layout implemented here:

    u32 ulen, u32 nnames (LE), u8 flags (bit0 = arithmetic coder)
    then per stream: u8 descriptor (bit7 = first stream of the next token
    position, bit6 = duplicate of an earlier stream, bits 0-5 token type);
    duplicates carry [u8 pos][u8 type]; otherwise uint7 compressed length
    + an rANS Nx16 stream.

No htslib exists in this image to cross-check against its binary output,
so conformance is established in three layers: spec-derived structural
fixtures decode streams this encoder never produced (tests/test_tok3.py);
the DECODER accepts foreign-shaped streams hand-assembled per the spec
(tests/test_cram_spec_fixtures.py); and the ENCODER's exact output bytes
are pinned against independently-transcribed entropy stages + hand-written
framing for worked examples covering DIFF/MATCH/DELTA, CAT framing,
order-0 bodies, and the bit-6 duplicate-stream descriptor
(TestEncoderGoldenOutputs).  Remaining named ambiguity vs htslib: where
the spec permits encoder CHOICE — which names to DUP/DIFF against, when a
stream is worth the dup descriptor (here: identical blob longer than 8
bytes), and the per-stream order-0/order-1 pick — this encoder's choices
are deliberate and any conformant decoder accepts them, but the choices
(and therefore compressed sizes) need not match htslib's byte-for-byte.
The arithmetic-coder variant (flags bit0) routes the token streams
through io/arith_nx16.
"""

from __future__ import annotations

import struct

from portello_tpu_torch.io import rans_nx16

__all__ = ["decode", "encode", "Tok3Error"]


class Tok3Error(ValueError):
    pass


# token types (spec table)
T_TYPE = 0
T_STRING = 1
T_CHAR = 2
T_DIGITS0 = 3
T_DZLEN = 4
T_DUP = 5
T_DIFF = 6
T_DIGITS = 7
T_DELTA = 8
T_DELTA0 = 9
T_MATCH = 10
T_NOP = 11
T_END = 12
_NTYPES = 13

_SEP = 0  # names are NUL-separated inside the RN series blob


class _Stream:
    __slots__ = ("data", "off")

    def __init__(self, data: bytes = b""):
        self.data = data
        self.off = 0

    def byte(self) -> int:
        b = self.data[self.off]
        self.off += 1
        return b

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.off)[0]
        self.off += 4
        return v

    def cstr(self) -> bytes:
        end = self.data.index(_SEP, self.off)
        s = self.data[self.off : end]
        self.off = end + 1
        return s


# ---------------------------------------------------------------------------
# tokenisation
# ---------------------------------------------------------------------------

def _tokenize(name: bytes) -> list[tuple[int, bytes]]:
    """Split a name into (type, text) tokens: digit runs (DIGITS, or
    DIGITS0 when zero-padded or too long for u32), alpha runs (STRING),
    and single other characters (CHAR)."""
    toks = []
    i = 0
    n = len(name)
    while i < n:
        c = name[i]
        if 0x30 <= c <= 0x39:
            j = i
            while j < n and 0x30 <= name[j] <= 0x39:
                j += 1
            text = name[i:j]
            if text[0] == 0x30 and len(text) > 1 or int(text) > 0xFFFFFFFF:
                toks.append((T_DIGITS0, text))
            else:
                toks.append((T_DIGITS, text))
            i = j
        elif (0x41 <= c <= 0x5A) or (0x61 <= c <= 0x7A):
            j = i
            while j < n and (
                (0x41 <= name[j] <= 0x5A) or (0x61 <= name[j] <= 0x7A)
            ):
                j += 1
            toks.append((T_STRING, name[i:j]))
            i = j
        else:
            toks.append((T_CHAR, name[i : i + 1]))
            i += 1
    return toks


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def encode(raw: bytes, use_arith: bool = False) -> bytes:
    """Encode a NUL-separated (and NUL-terminated) name blob.

    ``use_arith`` selects the adaptive-arithmetic entropy layer (flags
    bit 0) instead of rANS Nx16 for the token streams."""
    if raw and not raw.endswith(b"\x00"):
        raise Tok3Error("name blob must end with the NUL separator")
    names = raw.split(b"\x00")[:-1] if raw else []
    streams: dict[tuple[int, int], bytearray] = {}

    def put(pos: int, typ: int, payload: bytes) -> None:
        streams.setdefault((pos, typ), bytearray()).extend(payload)

    prev_toks: list[list[tuple[int, bytes]]] = []
    max_pos = 0
    for i, name in enumerate(names):
        toks = _tokenize(name)
        # reference: previous identical name -> DUP, else DIFF vs name i-1
        if i > 0 and names[i - 1] == name:
            put(0, T_TYPE, bytes([T_DUP]))
            put(0, T_DUP, struct.pack("<I", 0))
            prev_toks.append(toks)
            continue
        put(0, T_TYPE, bytes([T_DIFF]))
        put(0, T_DIFF, struct.pack("<I", 0))
        ref = prev_toks[i - 1] if i > 0 else []
        for p, (typ, text) in enumerate(toks, start=1):
            max_pos = max(max_pos, p)
            rt = ref[p - 1] if p - 1 < len(ref) else None
            if rt is not None and rt == (typ, text):
                put(p, T_TYPE, bytes([T_MATCH]))
                continue
            if (
                rt is not None
                and typ == T_DIGITS
                and rt[0] == T_DIGITS
                and 0 <= int(text) - int(rt[1]) <= 255
            ):
                put(p, T_TYPE, bytes([T_DELTA]))
                put(p, T_DELTA, bytes([int(text) - int(rt[1])]))
            elif (
                rt is not None
                and typ == T_DIGITS0
                and rt[0] == T_DIGITS0
                and len(rt[1]) == len(text)
                and 0 <= int(text) - int(rt[1]) <= 255
            ):
                put(p, T_TYPE, bytes([T_DELTA0]))
                put(p, T_DELTA0, bytes([int(text) - int(rt[1])]))
            elif typ == T_DIGITS:
                put(p, T_TYPE, bytes([T_DIGITS]))
                put(p, T_DIGITS, struct.pack("<I", int(text)))
            elif typ == T_DIGITS0:
                if int(text) > 0xFFFFFFFF:
                    put(p, T_TYPE, bytes([T_STRING]))
                    put(p, T_STRING, text + b"\x00")
                else:
                    put(p, T_TYPE, bytes([T_DIGITS0]))
                    put(p, T_DIGITS0, struct.pack("<I", int(text)))
                    put(p, T_DZLEN, bytes([len(text)]))
            elif typ == T_CHAR:
                put(p, T_TYPE, bytes([T_CHAR]))
                put(p, T_CHAR, text)
            else:
                put(p, T_TYPE, bytes([T_STRING]))
                put(p, T_STRING, text + b"\x00")
        put(len(toks) + 1, T_TYPE, bytes([T_END]))
        max_pos = max(max_pos, len(toks) + 1)
        prev_toks.append(toks)

    out = bytearray()
    out += struct.pack("<II", len(raw), len(names))
    out.append(1 if use_arith else 0)
    if use_arith:
        from portello_tpu_torch.io import arith_nx16

        def _compress(blob: bytes) -> bytes:
            comp = arith_nx16.encode(blob, order=0)
            if len(blob) >= 16:
                alt = arith_nx16.encode(blob, order=1)
                if len(alt) < len(comp):
                    comp = alt
            return comp
    else:
        def _compress(blob: bytes) -> bytes:
            comp = rans_nx16.encode(blob, order=0)
            if len(blob) >= 16:
                alt = rans_nx16.encode(blob, order=1)
                if len(alt) < len(comp):
                    comp = alt
            return comp

    seen: dict[bytes, tuple[int, int]] = {}
    for pos in range(0, max_pos + 1):
        first = True
        for typ in range(_NTYPES):
            data = streams.get((pos, typ))
            if data is None:
                continue
            desc = typ | (0x80 if first else 0)
            blob = bytes(data)
            dup = seen.get(blob)
            if dup is not None and len(blob) > 8:
                out.append(desc | 0x40)
                out += bytes([dup[0], dup[1]])
            else:
                comp = _compress(blob)
                out.append(desc)
                out += rans_nx16.write_uint7(len(comp))
                out += comp
                seen[blob] = (pos, typ)
            first = False
    return bytes(out)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode(data: bytes) -> bytes:
    """Decode a tok3 blob back to the NUL-separated name series."""
    if len(data) < 9:
        raise Tok3Error("tok3 stream too short")
    ulen, nnames = struct.unpack_from("<II", data, 0)
    flags = data[8]
    use_arith = bool(flags & 1)
    off = 9
    B: dict[tuple[int, int], _Stream] = {}
    pos = -1
    while off < len(data):
        desc = data[off]
        off += 1
        typ = desc & 0x3F
        if typ >= _NTYPES:
            raise Tok3Error(f"bad token type {typ}")
        if desc & 0x80:
            pos += 1
        if desc & 0x40:
            dpos = data[off]
            dtyp = data[off + 1]
            off += 2
            src = B.get((dpos, dtyp))
            if src is None:
                raise Tok3Error("duplicate stream references missing stream")
            B[(pos, typ)] = _Stream(src.data)
        else:
            clen, off = rans_nx16.read_uint7(data, off)
            if use_arith:
                from portello_tpu_torch.io import arith_nx16

                payload = arith_nx16.decode(data[off : off + clen])
            else:
                payload = rans_nx16.decode(data[off : off + clen])
            B[(pos, typ)] = _Stream(payload)
            off += clen

    def stream(p: int, t: int) -> _Stream:
        s = B.get((p, t))
        if s is None:
            raise Tok3Error(f"missing stream (pos {p}, type {t})")
        return s

    names: list[bytes] = []
    tok_lists: list[list[tuple[int, bytes]]] = []
    for i in range(nnames):
        t0 = stream(0, T_TYPE).byte()
        if t0 == T_DUP:
            dist = stream(0, T_DUP).u32()
            ref_i = i - 1 - dist
            if ref_i < 0:  # negative indexing would alias the wrong name
                raise Tok3Error(f"name {i}: DUP distance {dist} out of range")
            names.append(names[ref_i])
            tok_lists.append(tok_lists[ref_i])
            continue
        if t0 != T_DIFF:
            raise Tok3Error(f"name {i}: expected DIFF/DUP, got {t0}")
        dist = stream(0, T_DIFF).u32()
        if i > 0 and i - 1 - dist < 0:
            raise Tok3Error(f"name {i}: DIFF distance {dist} out of range")
        ref = tok_lists[i - 1 - dist] if i > 0 else []
        toks: list[tuple[int, bytes]] = []
        p = 1
        while True:
            t = stream(p, T_TYPE).byte()
            if t == T_END:
                break
            rt = ref[p - 1] if p - 1 < len(ref) else None
            if t == T_MATCH:
                if rt is None:
                    raise Tok3Error(f"name {i}: MATCH without reference")
                toks.append(rt)
            elif t == T_STRING:
                toks.append((T_STRING, stream(p, T_STRING).cstr()))
            elif t == T_CHAR:
                toks.append((T_CHAR, bytes([stream(p, T_CHAR).byte()])))
            elif t == T_DIGITS:
                toks.append(
                    (T_DIGITS, str(stream(p, T_DIGITS).u32()).encode())
                )
            elif t == T_DIGITS0:
                v = stream(p, T_DIGITS0).u32()
                ln = stream(p, T_DZLEN).byte()
                toks.append((T_DIGITS0, str(v).encode().rjust(ln, b"0")))
            elif t == T_DELTA:
                if rt is None:
                    raise Tok3Error(f"name {i}: DELTA without reference")
                v = int(rt[1]) + stream(p, T_DELTA).byte()
                toks.append((T_DIGITS, str(v).encode()))
            elif t == T_DELTA0:
                if rt is None:
                    raise Tok3Error(f"name {i}: DELTA0 without reference")
                v = int(rt[1]) + stream(p, T_DELTA0).byte()
                toks.append(
                    (T_DIGITS0, str(v).encode().rjust(len(rt[1]), b"0"))
                )
            elif t == T_NOP:
                pass
            else:
                raise Tok3Error(f"name {i}: unsupported token type {t}")
            p += 1
        names.append(b"".join(x[1] for x in toks))
        tok_lists.append(toks)
    out = b"".join(n + b"\x00" for n in names)
    if len(out) != ulen:
        raise Tok3Error(
            f"tok3 decode length {len(out)} != declared {ulen}"
        )
    return out
