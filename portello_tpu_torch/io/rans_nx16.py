"""rANS Nx16 codec (CRAM 3.1 block method 5).

The reference reads any htslib-supported CRAM (reference src/cli.rs:25,32);
CRAM 3.1 replaces rANS 4x8 with the rANS Nx16 family defined in
hts-specs/CRAMcodecs ("rANS Nx16 compression").  This module implements the
full decode surface from the spec — order-0/order-1 entropy cores with
4-way or 32-way state interleaving, 16-bit renormalisation, and the
bit-PACK, RLE, STRIPE, CAT and NOSZ meta-transforms — plus an encoder for
every mode so the decoder is exercised by round-trips and by hand-built
spec fixtures (tests/test_rans_nx16.py, tests/test_cram_spec_fixtures.py).

Format summary (spec section "rANS Nx16"):

  [flags u8] [uncomp-len uint7 unless NOSZ]
  flags: 0x01 ORDER1  0x04 N32  0x08 STRIPE  0x10 NOSZ  0x20 CAT
         0x40 RLE     0x80 PACK
  decode order: (stripe recurses) -> read PACK meta -> read RLE meta ->
  entropy (or CAT) -> expand RLE -> unpack bits.

Spec details encoded here that round-trips alone would not pin down:
  * uint7 is a BIG-endian base-128 varint (MSB = continuation).
  * order-0 frequencies normalise to 2^12; order-1 rows to 2^(comp>>4),
    with the order-1 table optionally order-0-rANS compressed (comp&1).
  * order-1 splits input into N fragments of floor(len/N); the LAST state
    carries the tail [N*flen, len), and each fragment starts in context 0.
  * renormalisation is a single 16-bit step against the 2^15 lower bound.
  * PACK fits 0/1/2/4 bits per value for alphabet sizes 1/2/4/16.
  * RLE meta holds the run-marked symbol set and the uint7 run lengths
    (run = extra copies); meta itself may be order-0 compressed.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decode", "encode", "RansNx16Error"]


class RansNx16Error(ValueError):
    pass


# flag bits (spec table)
ORDER1 = 0x01
N32 = 0x04
STRIPE = 0x08
NOSZ = 0x10
CAT = 0x20
RLE = 0x40
PACK = 0x80

_LOW = 1 << 15  # renormalisation lower bound
_SHIFT0 = 12    # order-0 frequency precision


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def read_uint7(buf: bytes, off: int) -> tuple[int, int]:
    """Big-endian base-128 varint; high bit of each byte = more follow."""
    v = 0
    while True:
        c = buf[off]
        off += 1
        v = (v << 7) | (c & 0x7F)
        if not c & 0x80:
            return v, off


def write_uint7(v: int) -> bytes:
    if v < 0:
        raise RansNx16Error("uint7 cannot encode negatives")
    out = bytearray([v & 0x7F])
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _read_alphabet(buf: bytes, off: int) -> tuple[list[int], int]:
    """Symbol list with the spec's +1-run encoding (ascending symbols)."""
    A: list[int] = []
    rle = 0
    sym = buf[off]
    off += 1
    last = sym
    while True:
        A.append(sym)
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = buf[off]
            off += 1
            if sym == last + 1:
                rle = buf[off]
                off += 1
        last = sym
        if sym == 0:
            break
    return A, off


def _write_alphabet(A: list[int]) -> bytes:
    """Mirror of _read_alphabet (A must be sorted ascending, non-empty)."""
    out = bytearray([A[0]])
    rle = 0
    for i, s in enumerate(A):
        if rle > 0:
            rle -= 1
            continue
        nxt = A[i + 1] if i + 1 < len(A) else 0
        out.append(nxt)
        if nxt == s + 1:
            run = 0
            while i + 2 + run < len(A) and A[i + 2 + run] == nxt + 1 + run:
                run += 1
            out.append(run)
            rle = run
    return bytes(out)


def _normalize(counts: np.ndarray, bits: int) -> np.ndarray:
    """Scale to sum 2^bits, present symbols kept >= 1, residue on the max
    (spec NormaliseFrequencies)."""
    t = 1 << bits
    total = int(counts.sum())
    if total == 0:
        return counts.astype(np.int64)
    F = (counts.astype(np.int64) * t) // total
    F[(counts > 0) & (F == 0)] = 1
    m = int(np.argmax(F))
    F[m] += t - int(F.sum())
    if F[m] < 1:
        raise RansNx16Error("frequency normalisation failed")
    return F


def _cum_lookup(F: np.ndarray, bits: int) -> tuple[np.ndarray, np.ndarray]:
    C = np.zeros(257, dtype=np.int64)
    C[1:] = np.cumsum(F)
    slot = np.zeros(1 << bits, dtype=np.uint8)
    for s in np.nonzero(F)[0]:
        slot[C[s] : C[s + 1]] = s
    return C, slot


# ---------------------------------------------------------------------------
# entropy cores
# ---------------------------------------------------------------------------

def _rans_decode_o0(buf: bytes, off: int, n_out: int, N: int) -> bytes:
    F = np.zeros(256, dtype=np.int64)
    A, off = _read_alphabet(buf, off)
    for s in A:
        F[s], off = read_uint7(buf, off)
    F = _normalize(F, _SHIFT0)
    C, slot = _cum_lookup(F, _SHIFT0)
    R = list(struct.unpack_from(f"<{N}I", buf, off))
    off += 4 * N
    out = bytearray(n_out)
    mask = (1 << _SHIFT0) - 1
    for i in range(n_out):
        j = i % N
        r = R[j]
        m = r & mask
        s = int(slot[m])
        out[i] = s
        r = int(F[s]) * (r >> _SHIFT0) + m - int(C[s])
        if r < _LOW:
            r = (r << 16) | (buf[off] | (buf[off + 1] << 8))
            off += 2
        R[j] = r
    return bytes(out)


def _rans_encode_o0(raw: bytes, N: int) -> bytes:
    arr = np.frombuffer(raw, dtype=np.uint8)
    F = _normalize(np.bincount(arr, minlength=256), _SHIFT0)
    C = np.zeros(257, dtype=np.int64)
    C[1:] = np.cumsum(F)
    A = [int(s) for s in np.nonzero(F)[0]]
    tab = bytearray(_write_alphabet(A))
    for s in A:
        tab += write_uint7(int(F[s]))
    R = [_LOW] * N
    rev = bytearray()
    for i in range(len(raw) - 1, -1, -1):
        j = i % N
        s = int(arr[i])
        f = int(F[s])
        r = R[j]
        x_max = ((_LOW >> _SHIFT0) << 16) * f
        if r >= x_max:
            rev.append((r >> 8) & 0xFF)  # prepended: final order lo, hi
            rev.append(r & 0xFF)
            r >>= 16
        R[j] = ((r // f) << _SHIFT0) + (r % f) + int(C[s])
    head = b"".join(struct.pack("<I", R[j]) for j in range(N))
    return bytes(tab) + head + bytes(reversed(rev))


def _read_freqs_o1(buf: bytes, off: int):
    comp = buf[off]
    off += 1
    shift = comp >> 4
    if comp & 1:
        # table itself order-0 compressed (4-way per spec)
        ulen, off = read_uint7(buf, off)
        clen, off = read_uint7(buf, off)
        fsrc = _rans_decode_o0(buf[off : off + clen], 0, ulen, 4)
        off += clen
        foff = 0
    else:
        fsrc = buf
        foff = off
    A, foff = _read_alphabet(fsrc, foff)
    tables = {}
    for i in A:
        F = np.zeros(256, dtype=np.int64)
        run = 0
        for j in A:
            if run > 0:
                run -= 1
            else:
                F[j], foff = read_uint7(fsrc, foff)
                if F[j] == 0:
                    run = fsrc[foff]
                    foff += 1
        F = _normalize(F, shift)
        C, slot = _cum_lookup(F, shift)
        tables[i] = (F, C, slot)
    if not comp & 1:
        off = foff
    return tables, shift, off


def _rans_decode_o1(buf: bytes, off: int, n_out: int, N: int) -> bytes:
    tables, shift, off = _read_freqs_o1(buf, off)
    R = list(struct.unpack_from(f"<{N}I", buf, off))
    off += 4 * N
    out = bytearray(n_out)
    mask = (1 << shift) - 1
    flen = n_out // N
    last = [0] * N

    def step(j: int, idx: int) -> None:
        nonlocal off
        got = tables.get(last[j])
        if got is None:
            raise RansNx16Error("order-1 stream references missing context")
        F, C, slot = got
        r = R[j]
        m = r & mask
        s = int(slot[m])
        out[idx] = s
        r = int(F[s]) * (r >> shift) + m - int(C[s])
        if r < _LOW:
            r = (r << 16) | (buf[off] | (buf[off + 1] << 8))
            off += 2
        R[j] = r
        last[j] = s

    for i in range(flen):
        for j in range(N):
            step(j, j * flen + i)
    for idx in range(N * flen, n_out):
        step(N - 1, idx)
    return bytes(out)


def _rans_encode_o1(raw: bytes, N: int, comp_table: bool = False) -> bytes:
    n = len(raw)
    arr = np.frombuffer(raw, dtype=np.uint8)
    shift = _SHIFT0
    flen = n // N
    ranges = [(j * flen, (j + 1) * flen) for j in range(N)]
    lo, _hi = ranges[-1]
    ranges[-1] = (lo, n)  # last state carries the tail
    counts = np.zeros((256, 256), dtype=np.int64)
    for lo, hi in ranges:
        last = 0
        for idx in range(lo, hi):
            s = int(arr[idx])
            counts[last, s] += 1
            last = s
    ctxs = [c for c in range(256) if counts[c].sum() > 0]
    Fs = {}
    Cs = {}
    syms_present = sorted(
        set(int(s) for s in np.unique(arr)) | set(ctxs)
    )
    for c in ctxs:
        F = _normalize(counts[c], shift)
        C = np.zeros(257, dtype=np.int64)
        C[1:] = np.cumsum(F)
        Fs[c], Cs[c] = F, C
    # table: alphabet covers contexts AND symbols (decoder iterates j over A)
    A = syms_present
    tab = bytearray(_write_alphabet(A))
    for i in A:
        if i not in Fs:
            # context never used: all-zero row as one zero + run
            row = np.zeros(256, dtype=np.int64)
        else:
            row = Fs[i]
        j = 0
        while j < len(A):
            f = int(row[A[j]])
            tab += write_uint7(f)
            if f == 0:
                run = 0
                while j + 1 + run < len(A) and row[A[j + 1 + run]] == 0:
                    run += 1
                tab.append(run)
                j += run
            j += 1
    if comp_table:
        packed = _rans_encode_o0(bytes(tab), 4)
        head = bytearray([(shift << 4) | 1])
        head += write_uint7(len(tab))
        head += write_uint7(len(packed))
        head += packed
    else:
        head = bytearray([shift << 4])
        head += tab
    # encode in reverse of decode order
    seq = []
    for i in range(flen):
        for j in range(N):
            seq.append((j, j * flen + i))
    for idx in range(N * flen, n):
        seq.append((N - 1, idx))
    R = [_LOW] * N
    rev = bytearray()
    for j, idx in reversed(seq):
        s = int(arr[idx])
        frag_start = j * flen
        ctx = int(arr[idx - 1]) if idx > frag_start else 0
        F, C = Fs[ctx], Cs[ctx]
        f = int(F[s])
        r = R[j]
        x_max = ((_LOW >> shift) << 16) * f
        if r >= x_max:  # one 16-bit step suffices: r < 2^31 always
            rev.append((r >> 8) & 0xFF)
            rev.append(r & 0xFF)
            r >>= 16
        R[j] = ((r // f) << shift) + (r % f) + int(C[s])
    statev = b"".join(struct.pack("<I", R[j]) for j in range(N))
    return bytes(head) + statev + bytes(reversed(rev))


# ---------------------------------------------------------------------------
# meta-transforms
# ---------------------------------------------------------------------------

def _unpack(data: bytes, P: list[int], nsym: int, n_out: int) -> bytes:
    out = bytearray(n_out)
    if nsym <= 1:
        for i in range(n_out):
            out[i] = P[0]
    elif nsym <= 2:
        for i in range(n_out):
            out[i] = P[(data[i >> 3] >> (i & 7)) & 1]
    elif nsym <= 4:
        for i in range(n_out):
            out[i] = P[(data[i >> 2] >> ((i & 3) << 1)) & 3]
    elif nsym <= 16:
        for i in range(n_out):
            out[i] = P[(data[i >> 1] >> ((i & 1) << 2)) & 15]
    else:
        raise RansNx16Error("PACK with more than 16 symbols")
    return bytes(out)


def _pack(raw: bytes) -> tuple[bytes, list[int]] | None:
    """Bit-pack raw if its alphabet fits 16 symbols; None otherwise."""
    syms = sorted(set(raw))
    nsym = len(syms)
    if nsym > 16 or not raw:
        return None
    idx = {s: i for i, s in enumerate(syms)}
    n = len(raw)
    if nsym <= 1:
        return b"", syms
    if nsym <= 2:
        out = bytearray((n + 7) >> 3)
        for i, b in enumerate(raw):
            out[i >> 3] |= idx[b] << (i & 7)
    elif nsym <= 4:
        out = bytearray((n + 3) >> 2)
        for i, b in enumerate(raw):
            out[i >> 2] |= idx[b] << ((i & 3) << 1)
    else:
        out = bytearray((n + 1) >> 1)
        for i, b in enumerate(raw):
            out[i >> 1] |= idx[b] << ((i & 1) << 2)
    return bytes(out), syms


def _rle_expand(lit: bytes, meta: bytes, n_out: int) -> bytes:
    moff = 0
    n = meta[moff]
    moff += 1
    if n == 0:
        n = 256
    marked = bytearray(256)
    for _ in range(n):
        marked[meta[moff]] = 1
        moff += 1
    out = bytearray()
    for b in lit:
        if marked[b]:
            run, moff = read_uint7(meta, moff)
            out += bytes([b]) * (run + 1)
        else:
            out.append(b)
    if len(out) != n_out:
        raise RansNx16Error(
            f"RLE expansion produced {len(out)} bytes, expected {n_out}"
        )
    return bytes(out)


def _rle_compress(raw: bytes) -> tuple[bytes, bytes]:
    """Run-length encode every symbol that repeats (simple encoder: mark
    all symbols whose best run >= 2... marks everything with a run)."""
    # choose symbols that appear in runs of >= 3 anywhere
    runs_seen = set()
    i = 0
    n = len(raw)
    while i < n:
        j = i
        while j < n and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            runs_seen.add(raw[i])
        i = j
    syms = sorted(runs_seen)
    meta = bytearray()
    if len(syms) == 256:
        meta.append(0)
    else:
        meta.append(len(syms))
    meta += bytes(syms)
    lit = bytearray()
    marked = bytearray(256)
    for s in syms:
        marked[s] = 1
    i = 0
    while i < n:
        b = raw[i]
        if marked[b]:
            j = i
            while j < n and raw[j] == b:
                j += 1
            lit.append(b)
            meta += write_uint7(j - i - 1)
            i = j
        else:
            lit.append(b)
            i += 1
    return bytes(lit), bytes(meta)


# ---------------------------------------------------------------------------
# top-level codec
# ---------------------------------------------------------------------------

def decode(data: bytes, n_out: int | None = None) -> bytes:
    """Decode a complete rANS Nx16 stream (flags byte onward).

    ``n_out`` is required only for NOSZ streams (CRAM supplies it from the
    block's raw size).
    """
    off = 0
    flags = data[off]
    off += 1
    if not flags & NOSZ:
        embedded, off = read_uint7(data, off)
        # a caller-supplied length (the CRAM block's raw size) must agree
        # with the stream's own — checking BEFORE decoding bounds the work
        # a corrupt/hostile length field can demand
        if n_out is not None and embedded != n_out:
            raise RansNx16Error(
                f"stream length {embedded} != declared block size {n_out}"
            )
        n_out = embedded
    if n_out is None:
        raise RansNx16Error("NOSZ stream requires an external length")
    if n_out == 0:
        return b""
    if flags & STRIPE:
        return _decode_stripe(data, off, n_out)
    N = 32 if flags & N32 else 4

    pack_len = n_out
    P = None
    nsym = 0
    if flags & PACK:
        nsym = data[off]
        off += 1
        P = list(data[off : off + nsym])
        off += nsym
        n_out, off = read_uint7(data, off)
        if n_out > pack_len:  # packing never expands; bounds corrupt work
            raise RansNx16Error("PACK length exceeds output size")

    rle_len = n_out
    rle_meta = None
    if flags & RLE:
        rmlen, off = read_uint7(data, off)
        n_out, off = read_uint7(data, off)
        if n_out > rle_len:  # RLE literals never exceed the expansion
            raise RansNx16Error("RLE literal length exceeds output size")
        if rmlen & 1:
            rle_meta = data[off : off + (rmlen >> 1)]
            off += rmlen >> 1
        else:
            cmlen, off = read_uint7(data, off)
            rle_meta = _rans_decode_o0(
                data[off : off + cmlen], 0, rmlen >> 1, 4
            )
            off += cmlen

    if flags & CAT:
        out = data[off : off + n_out]
        if len(out) != n_out:
            raise RansNx16Error("CAT stream truncated")
    elif flags & ORDER1:
        out = _rans_decode_o1(data, off, n_out, N)
    else:
        out = _rans_decode_o0(data, off, n_out, N)

    if flags & RLE:
        out = _rle_expand(out, rle_meta, rle_len)
    if flags & PACK:
        out = _unpack(out, P, nsym, pack_len)
    return out


def stripe_decode(data: bytes, off: int, n_out: int, decode_fn, err_cls):
    """Shared STRIPE framing (also used by the arith codec): N byte, uint7
    compressed lengths, byte-interleaved substreams."""
    N = data[off]
    off += 1
    if N == 0:
        raise err_cls("STRIPE with zero substreams")
    clens = []
    for _ in range(N):
        c, off = read_uint7(data, off)
        clens.append(c)
    parts = []
    for j in range(N):
        ulen = n_out // N + (1 if n_out % N > j else 0)
        parts.append(decode_fn(data[off : off + clens[j]], ulen))
        off += clens[j]
    out = bytearray(n_out)
    for j in range(N):
        if len(parts[j]) != len(out[j::N]):
            raise err_cls("STRIPE substream length mismatch")
        out[j::N] = parts[j]
    return bytes(out)


def _decode_stripe(data: bytes, off: int, n_out: int) -> bytes:
    return stripe_decode(data, off, n_out, decode, RansNx16Error)


def encode(
    raw: bytes,
    order: int = 0,
    n32: bool = False,
    use_pack: bool = False,
    use_rle: bool = False,
    use_cat: bool = False,
    stripe: int = 0,
    nosz: bool = False,
    comp_table: bool = False,
) -> bytes:
    """Encode ``raw`` as an rANS Nx16 stream with the requested transforms.

    The flag combinations mirror what htscodecs emits; the decoder accepts
    any legal combination regardless of what this encoder chooses.
    """
    flags = 0
    out = bytearray()
    if stripe:
        flags |= STRIPE
        body = bytearray([stripe])
        parts = [raw[j::stripe] for j in range(stripe)]
        encs = [encode(p, order=order, n32=n32) for p in parts]
        for e in encs:
            body += write_uint7(len(e))
        for e in encs:
            body += e
        out.append(flags)
        out += write_uint7(len(raw))
        out += body
        return bytes(out)

    N = 32 if n32 else 4
    if n32:
        flags |= N32
    payload = raw
    packed_meta = b""
    if use_pack:
        got = _pack(payload)
        if got is not None:
            packed, syms = got
            flags |= PACK
            packed_meta = bytes([len(syms)]) + bytes(syms)
            pack_body_len = len(packed)
            payload = packed
    rle_meta_block = b""
    if use_rle and payload:
        lit, meta = _rle_compress(payload)
        # meta count byte 0 means "all 256 symbols" — an empty run set is
        # unrepresentable, so only apply RLE when some symbol has runs
        if meta[0] != 0 or len(meta) > 1:
            flags |= RLE
            rle_meta_block = (
                write_uint7((len(meta) << 1) | 1)
                + write_uint7(len(lit))
                + meta
            )
            payload = lit
    if use_cat or len(payload) < N:
        flags |= CAT
        body = payload
    elif order == 1 and len(payload) >= N:
        flags |= ORDER1
        body = _rans_encode_o1(payload, N, comp_table=comp_table)
    else:
        body = _rans_encode_o0(payload, N)
    if nosz:
        flags |= NOSZ
    out.append(flags)
    if not nosz:
        out += write_uint7(len(raw))
    if flags & PACK:
        out += packed_meta
        out += write_uint7(pack_body_len)  # pre-RLE (packed) length
    if flags & RLE:
        out += rle_meta_block
    out += body
    return bytes(out)
