"""Adaptive arithmetic codec (CRAM 3.1 block method 6, "arith").

htslib's archive profile may compress data series with this codec
(htscodecs arith_dynamic); the normal profile never emits it.  Decoding it
extends this repo's CRAM 3.1 coverage to archive-flavoured inputs.

Model per hts-specs/CRAMcodecs "Adaptive arithmetic coding": an LZMA-style
byte-wise range coder (32-bit range, carry-propagating encoder, 2^24
renormalisation bound) over adaptive frequency models (init 1 per symbol,
+STEP on use, halved at the cap).  Stream layout:

  [flags u8] [uncomp-len uint7 unless NOSZ] payload
  flags: 0x01 ORDER1, 0x04 EXT (bzip2 payload), 0x08 STRIPE, 0x10 NOSZ,
         0x20 CAT, 0x40 RLE, 0x80 PACK
  (vs rANS Nx16: bit 0x04 means EXT here, not 32-way interleaving)

Order-0 uses one 256-symbol model; order-1 one model per previous byte.
RLE mode codes (literal, run) pairs inline: the literal through a
256-model, the run in 255-capped parts through models keyed by the
literal for part 0 and by continuation slots 256/257 after.  PACK and
STRIPE reuse the rANS Nx16 transforms.

As with the CRAM container itself (io/cram.py), no htslib exists in-image
to cross-check byte streams, so the coder is validated by round-trips over
every mode plus structural fixtures (tests/test_arith_nx16.py); the range
coder and model update schedule follow the published algorithm and are
documented here as the interop surface.
"""

from __future__ import annotations

import bz2

from portello_tpu_torch.io.rans_nx16 import (
    _pack,
    _unpack,
    read_uint7,
    write_uint7,
)

__all__ = ["decode", "encode", "ArithError"]


class ArithError(ValueError):
    pass


ORDER1 = 0x01
EXT = 0x04
STRIPE = 0x08
NOSZ = 0x10
CAT = 0x20
RLE = 0x40
PACK = 0x80

_TOP = 1 << 24
_STEP = 16
_MAX_TOT = 1 << 15


# ---------------------------------------------------------------------------
# range coder (LZMA-style: 32-bit range, 64-bit carry-propagating low)
# ---------------------------------------------------------------------------

class _REnc:
    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            for _ in range(self.cache_size - 1):
                self.out.append((0xFF + carry) & 0xFF)
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, cum: int, freq: int, tot: int) -> None:
        r = self.range // tot
        self.low += cum * r
        self.range = r * freq
        while self.range < _TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class _RDec:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(5):  # first byte is the encoder's initial cache (0)
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
        self._r = 1

    def _byte(self) -> int:
        if self.pos >= len(self.data):
            return 0  # spec: the final flush may be truncated by writers
        b = self.data[self.pos]
        self.pos += 1
        return b

    def get_freq(self, tot: int) -> int:
        self._r = self.range // tot
        if self._r == 0:
            # range underflow only happens on corrupt/desynchronized input
            # (freqs are >= 1 and totals capped well below 2^24); without
            # this check the renorm loop below would spin on range == 0
            raise ArithError("range coder underflow (corrupt stream)")
        return min(self.code // self._r, tot - 1)

    def decode(self, cum: int, freq: int) -> None:
        self.code -= cum * self._r
        self.range = self._r * freq
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF


class _Model:
    """Adaptive frequency model: init 1/symbol, +STEP on use, halve at cap."""

    __slots__ = ("freq", "total")

    def __init__(self, nsym: int = 256):
        self.freq = [1] * nsym
        self.total = nsym

    def _bump(self, s: int) -> None:
        self.freq[s] += _STEP
        self.total += _STEP
        if self.total > _MAX_TOT:
            t = 0
            f = self.freq
            for i in range(len(f)):
                f[i] = (f[i] + 1) >> 1
                t += f[i]
            self.total = t

    def enc(self, rc: _REnc, s: int) -> None:
        cum = 0
        f = self.freq
        for i in range(s):
            cum += f[i]
        rc.encode(cum, f[s], self.total)
        self._bump(s)

    def dec(self, rc: _RDec) -> int:
        target = rc.get_freq(self.total)
        cum = 0
        f = self.freq
        for s in range(len(f)):
            if cum + f[s] > target:
                rc.decode(cum, f[s])
                self._bump(s)
                return s
            cum += f[s]
        raise ArithError("arith model desynchronized")


# ---------------------------------------------------------------------------
# entropy cores
# ---------------------------------------------------------------------------

def _decode_o0(data: bytes, pos: int, n_out: int) -> bytes:
    rc = _RDec(data, pos)
    m = _Model()
    out = bytearray(n_out)
    for i in range(n_out):
        out[i] = m.dec(rc)
    return bytes(out)


def _encode_o0(raw: bytes) -> bytes:
    rc = _REnc()
    m = _Model()
    for b in raw:
        m.enc(rc, b)
    return rc.finish()


def _decode_o1(data: bytes, pos: int, n_out: int) -> bytes:
    rc = _RDec(data, pos)
    models = [None] * 256
    out = bytearray(n_out)
    last = 0
    for i in range(n_out):
        m = models[last]
        if m is None:
            m = models[last] = _Model()
        last = out[i] = m.dec(rc)
    return bytes(out)


def _encode_o1(raw: bytes) -> bytes:
    rc = _REnc()
    models = [None] * 256
    last = 0
    for b in raw:
        m = models[last]
        if m is None:
            m = models[last] = _Model()
        m.enc(rc, b)
        last = b
    return rc.finish()


def _decode_rle(data: bytes, pos: int, n_out: int, order1: bool) -> bytes:
    """Inline lit/run RLE.  With ORDER1 the literal model is conditioned on
    the previous literal (htscodecs arith O1+RLE); run models are shared."""
    rc = _RDec(data, pos)
    lit_models: list = [None] * 256 if order1 else [_Model()]
    run_m = [None] * 258
    out = bytearray()
    last = 0
    while len(out) < n_out:
        if order1:
            lm = lit_models[last]
            if lm is None:
                lm = lit_models[last] = _Model()
        else:
            lm = lit_models[0]
        lit = lm.dec(rc)
        k = lit
        run = 0
        while True:
            m = run_m[k]
            if m is None:
                m = run_m[k] = _Model()
            part = m.dec(rc)
            run += part
            if part != 255:
                break
            k = 256 if k == lit else 257
        out += bytes([lit]) * (run + 1)
        last = lit
    if len(out) != n_out:
        raise ArithError("arith RLE expansion length mismatch")
    return bytes(out)


def _encode_rle(raw: bytes, order1: bool) -> bytes:
    rc = _REnc()
    lit_models: list = [None] * 256 if order1 else [_Model()]
    run_m = [None] * 258
    i = 0
    n = len(raw)
    last = 0
    while i < n:
        lit = raw[i]
        j = i
        while j < n and raw[j] == lit:
            j += 1
        run = j - i - 1
        if order1:
            lm = lit_models[last]
            if lm is None:
                lm = lit_models[last] = _Model()
        else:
            lm = lit_models[0]
        lm.enc(rc, lit)
        k = lit
        while True:
            part = min(run, 255)
            m = run_m[k]
            if m is None:
                m = run_m[k] = _Model()
            m.enc(rc, part)
            run -= part
            if part != 255:
                break
            k = 256 if k == lit else 257
        last = lit
        i = j
    return rc.finish()


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def decode(data: bytes, n_out: int | None = None) -> bytes:
    off = 0
    flags = data[off]
    off += 1
    if not flags & NOSZ:
        embedded, off = read_uint7(data, off)
        # caller-supplied length (the CRAM block raw size) bounds the work
        # a corrupt length field can demand — check before decoding
        if n_out is not None and embedded != n_out:
            raise ArithError(
                f"stream length {embedded} != declared block size {n_out}"
            )
        n_out = embedded
    if n_out is None:
        raise ArithError("NOSZ stream requires an external length")
    if n_out == 0:
        return b""
    if flags & STRIPE:
        return _decode_stripe(data, off, n_out)

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
            raise ArithError("PACK length exceeds output size")

    if flags & CAT:
        out = data[off : off + n_out]
        if len(out) != n_out:
            raise ArithError("CAT stream truncated")
    elif flags & EXT:
        out = bz2.decompress(data[off:])
        if len(out) != n_out:
            raise ArithError("EXT (bzip2) payload length mismatch")
    elif flags & RLE:
        # RLE is inline (adaptive lit/run models); ORDER1 conditions the
        # literal model on the previous literal
        out = _decode_rle(data, off, n_out, bool(flags & ORDER1))
    elif flags & ORDER1:
        out = _decode_o1(data, off, n_out)
    else:
        out = _decode_o0(data, off, n_out)

    if flags & PACK:
        out = _unpack(out, P, nsym, pack_len)
    return out


def _decode_stripe(data: bytes, off: int, n_out: int) -> bytes:
    from portello_tpu_torch.io.rans_nx16 import stripe_decode

    return stripe_decode(data, off, n_out, decode, ArithError)


def encode(
    raw: bytes,
    order: int = 0,
    use_pack: bool = False,
    use_rle: bool = False,
    use_cat: bool = False,
    use_ext: bool = False,
    stripe: int = 0,
    nosz: bool = False,
) -> bytes:
    flags = 0
    out = bytearray()
    if stripe:
        flags |= STRIPE
        body = bytearray([stripe])
        parts = [raw[j::stripe] for j in range(stripe)]
        encs = [encode(p, order=order) for p in parts]
        for e in encs:
            body += write_uint7(len(e))
        for e in encs:
            body += e
        out.append(flags)
        out += write_uint7(len(raw))
        out += body
        return bytes(out)

    payload = raw
    packed_meta = b""
    pack_body_len = 0
    if use_pack:
        got = _pack(payload)
        if got is not None:
            packed, syms = got
            flags |= PACK
            packed_meta = bytes([len(syms)]) + bytes(syms)
            pack_body_len = len(packed)
            payload = packed
    if use_cat or len(payload) < 4:
        flags |= CAT
        body = payload
    elif use_ext:
        flags |= EXT
        body = bz2.compress(payload)
    elif use_rle:
        flags |= RLE | (ORDER1 if order else 0)
        body = _encode_rle(payload, order1=bool(order))
    elif order == 1:
        flags |= ORDER1
        body = _encode_o1(payload)
    else:
        body = _encode_o0(payload)
    if nosz:
        flags |= NOSZ
    out.append(flags)
    if not nosz:
        out += write_uint7(len(raw))
    if flags & PACK:
        out += packed_meta
        out += write_uint7(pack_body_len)
    out += body
    return bytes(out)
