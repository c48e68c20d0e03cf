"""fqzcomp quality codec (CRAM 3.1 block method 7).

htslib's archive profile compresses the QS (quality) series with fqzcomp
(htscodecs fqzcomp_qual); the normal profile never emits it.  With this
module every CRAM 3.1 block method (4-8) decodes.

Model per hts-specs/CRAMcodecs "fqzcomp quality codec": adaptive models
(io/arith_nx16's range coder) over a 16-bit context built per quality from
the recent-quality history (qtab/qshift/qbits at qloc), the in-record
position (ptab at ploc), the running delta count (dtab at dloc) and the
parameter selector (sloc):

    ctx  = base_context
         + ((qctx & qmask) << qloc)        with qctx = (qctx << qshift) + qtab[q]
         + ptab[min(pos, 1023)] << ploc    (when HAVE_PTAB)
         + dtab[min(delta, 255)] << dloc   (when HAVE_DTAB)
         + sel << sloc                     (when DO_SEL)
    delta += (prevq != q)

Header: [vers=5][gflags][nparam?][selector table?] then per parameter set:
16-bit base context, pflags, max_sym, packed qbits/qshift, qloc/sloc,
ploc/dloc, then the optional qmap and qtab/ptab/dtab tables in the
double-RLE array encoding.  Record framing: lengths via four byte models
(first record always; later ones when DO_LEN), optional reverse flags
applied after decode (DO_REV), optional whole-record dedup (DO_DEDUP).

No htslib exists in-image to cross-check streams (the io/cram.py caveat);
round-trips over every flag combination plus structural fixtures live in
tests/test_fqzcomp.py, and the context/update algebra above is documented
as the interop surface.
"""

from __future__ import annotations

from portello_tpu_torch.io.arith_nx16 import _Model, _RDec, _REnc

__all__ = ["decode", "encode", "FqzError"]


class FqzError(ValueError):
    pass


FQZ_VERS = 5

GFLAG_MULTI_PARAM = 1
GFLAG_HAVE_STAB = 2
GFLAG_DO_REV = 4

PFLAG_DO_DEDUP = 2
PFLAG_DO_LEN = 4
PFLAG_DO_SEL = 8
PFLAG_HAVE_QMAP = 16
PFLAG_HAVE_PTAB = 32
PFLAG_HAVE_DTAB = 64
PFLAG_HAVE_QTAB = 128


# ---------------------------------------------------------------------------
# table (de)serialisation: run lengths per ascending value, with a repeat
# count byte after two equal consecutive runs (the double-RLE scheme)
# ---------------------------------------------------------------------------

def _read_array(buf: bytes, off: int, size: int) -> tuple[list[int], int]:
    A: list[int] = []
    j = 0
    last = -1
    while len(A) < size:
        run = buf[off]
        off += 1
        if run == last:
            # equal-run RLE: the next byte counts additional values that
            # share this run length
            copy = buf[off]
            off += 1
            for _ in range(copy):
                A.extend([j] * run)
                j += 1
            last = -1
            continue
        acc = run
        while run == 255:  # 255-capped continuation parts for long runs
            run = buf[off]
            off += 1
            acc += run
        A.extend([j] * acc)
        j += 1
        last = acc if acc < 255 else -1
    if len(A) != size:
        raise FqzError("fqzcomp table overrun")
    return A, off


def _write_array(A: list[int], size: int) -> bytes:
    # A maps [0, size) -> value; must be non-decreasing starting at 0
    runs: list[int] = []
    j = 0
    i = 0
    while i < len(A):
        run = 0
        while i < len(A) and A[i] == j:
            run += 1
            i += 1
        runs.append(run)
        j += 1
    out = bytearray()
    k = 0
    last = -1
    while k < len(runs):
        run = runs[k]
        if run == last:
            copy = 0
            while (
                k + copy < len(runs)
                and runs[k + copy] == run
                and copy < 255
            ):
                copy += 1
            out.append(run)
            out.append(copy)
            k += copy
            last = -1
            continue
        x = run
        while x >= 255:
            out.append(255)
            x -= 255
        out.append(x)
        k += 1
        last = run if run < 255 else -1
    return bytes(out)


# ---------------------------------------------------------------------------
# parameter sets
# ---------------------------------------------------------------------------

class _Param:
    __slots__ = (
        "context", "pflags", "max_sym", "qbits", "qshift", "qloc", "sloc",
        "ploc", "dloc", "qmap", "qtab", "ptab", "dtab", "qmask",
        "do_dedup", "do_len", "do_sel", "have_qmap",
    )

    def read(self, buf: bytes, off: int) -> int:
        self.context = buf[off] | (buf[off + 1] << 8)
        self.pflags = buf[off + 2]
        self.max_sym = buf[off + 3]
        x = buf[off + 4]
        self.qbits, self.qshift = x >> 4, x & 15
        x = buf[off + 5]
        self.qloc, self.sloc = x >> 4, x & 15
        x = buf[off + 6]
        self.ploc, self.dloc = x >> 4, x & 15
        off += 7
        self.qmask = (1 << self.qbits) - 1
        self.do_dedup = bool(self.pflags & PFLAG_DO_DEDUP)
        self.do_len = bool(self.pflags & PFLAG_DO_LEN)
        self.do_sel = bool(self.pflags & PFLAG_DO_SEL)
        self.have_qmap = bool(self.pflags & PFLAG_HAVE_QMAP)
        if self.have_qmap:
            self.qmap = list(buf[off : off + self.max_sym])
            off += self.max_sym
        else:
            self.qmap = None
        if self.pflags & PFLAG_HAVE_QTAB:
            self.qtab, off = _read_array(buf, off, 256)
        else:
            self.qtab = None  # identity
        if self.pflags & PFLAG_HAVE_PTAB:
            self.ptab, off = _read_array(buf, off, 1024)
        else:
            self.ptab = None
        if self.pflags & PFLAG_HAVE_DTAB:
            self.dtab, off = _read_array(buf, off, 256)
        else:
            self.dtab = None
        return off

    def write(self) -> bytes:
        out = bytearray()
        out += bytes([self.context & 0xFF, self.context >> 8])
        out.append(self.pflags)
        out.append(self.max_sym)
        out.append((self.qbits << 4) | self.qshift)
        out.append((self.qloc << 4) | self.sloc)
        out.append((self.ploc << 4) | self.dloc)
        if self.have_qmap:
            out += bytes(self.qmap)
        if self.pflags & PFLAG_HAVE_QTAB:
            out += _write_array(self.qtab, 256)
        if self.pflags & PFLAG_HAVE_PTAB:
            out += _write_array(self.ptab, 1024)
        if self.pflags & PFLAG_HAVE_DTAB:
            out += _write_array(self.dtab, 256)
        return bytes(out)


class _State:
    __slots__ = ("qctx", "prevq", "delta", "p", "sel")

    def reset(self, rec_len: int, sel: int) -> None:
        self.qctx = 0
        self.prevq = 0
        self.delta = 0
        self.p = rec_len
        self.sel = sel


def _ctx(pm: _Param, st: _State) -> int:
    last = pm.context
    last += (st.qctx & pm.qmask) << pm.qloc
    if pm.ptab is not None:
        last += pm.ptab[min(st.p, 1023)] << pm.ploc
    if pm.dtab is not None:
        last += pm.dtab[min(st.delta, 255)] << pm.dloc
    if pm.do_sel:
        last += st.sel << pm.sloc
    return last & 0xFFFF


def _update(pm: _Param, st: _State, q: int) -> None:
    st.qctx = (st.qctx << pm.qshift) + (
        pm.qtab[q] if pm.qtab is not None else q
    )
    st.delta += st.prevq != q
    st.prevq = q
    st.p -= 1


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Models:
    def __init__(self, max_sym: int, max_sel: int):
        self.qual: dict[int, _Model] = {}
        self.nsym = max_sym + 1
        self.len = [_Model(256) for _ in range(4)]
        self.rev = _Model(2)
        self.dup = _Model(2)
        self.sel = _Model(max_sel + 1) if max_sel > 0 else None

    def q(self, ctx: int) -> _Model:
        m = self.qual.get(ctx)
        if m is None:
            m = self.qual[ctx] = _Model(self.nsym)
        return m


def decode(data: bytes, n_out: int | None = None) -> bytes:
    off = 0
    vers = data[off]
    off += 1
    if vers != FQZ_VERS:
        raise FqzError(f"fqzcomp version {vers} not supported (expect 5)")
    gflags = data[off]
    off += 1
    nparam = 1
    if gflags & GFLAG_MULTI_PARAM:
        nparam = data[off]
        off += 1
    max_sel = nparam - 1
    stab = list(range(256))
    if gflags & GFLAG_HAVE_STAB:
        max_sel = data[off]
        off += 1
        stab, off = _read_array(data, off, 256)
    params = []
    for _ in range(nparam):
        pm = _Param()
        off = pm.read(data, off)
        params.append(pm)

    if n_out is None:
        raise FqzError("fqzcomp requires the uncompressed size")
    models = _Models(max(pm.max_sym for pm in params), max_sel)
    rc = _RDec(data, off)
    out = bytearray()
    st = _State()
    rev_flags: list[tuple[int, int, bool]] = []  # (start, len, reversed)
    rec_len = 0
    last_len = 0
    prev_rec: bytes | None = None
    while len(out) < n_out:
        # new record
        sel = 0
        if max_sel > 0 and models.sel is not None:
            sel = models.sel.dec(rc)
        x = stab[sel] if gflags & GFLAG_HAVE_STAB else sel
        pm = params[min(x, nparam - 1)]
        if pm.do_len or last_len == 0:
            rec_len = (
                models.len[0].dec(rc)
                | (models.len[1].dec(rc) << 8)
                | (models.len[2].dec(rc) << 16)
                | (models.len[3].dec(rc) << 24)
            )
            last_len = rec_len
        else:
            rec_len = last_len
        if rec_len == 0 or len(out) + rec_len > n_out:
            raise FqzError("fqzcomp record framing exceeds output size")
        is_rev = False
        if gflags & GFLAG_DO_REV:
            is_rev = bool(models.rev.dec(rc))
        if pm.do_dedup and models.dup.dec(rc):
            if prev_rec is None or len(prev_rec) != rec_len:
                raise FqzError("fqzcomp dedup without matching previous")
            rev_flags.append((len(out), rec_len, is_rev))
            out += prev_rec
            continue
        st.reset(rec_len, sel)
        start = len(out)
        for _ in range(rec_len):
            q = models.q(_ctx(pm, st)).dec(rc)
            out.append(pm.qmap[q] if pm.qmap is not None else q)
            _update(pm, st, q)
        prev_rec = bytes(out[start:])
        rev_flags.append((start, rec_len, is_rev))
    for start, ln, is_rev in rev_flags:
        if is_rev:
            out[start : start + ln] = out[start : start + ln][::-1]
    return bytes(out)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def encode(
    quals: bytes,
    lens: list[int],
    use_qmap: bool | None = None,
    use_dedup: bool = False,
    rev: list[bool] | None = None,
) -> bytes:
    """Encode concatenated per-record qualities (record lengths ``lens``).

    Chooses a single parameter set: 10-bit quality history (shift 5),
    6-bit position bucket table, optional symbol map when the alphabet is
    small.  ``rev`` marks records whose qualities are stored reversed.
    """
    if sum(lens) != len(quals):
        raise FqzError("lens do not sum to the quality bytes")
    if rev is not None:
        rev = [r for r, ln in zip(rev, lens) if ln > 0]
    # zero-length records carry no quality bytes and are invisible to the
    # decoder's until-n_out framing; encoding them would desynchronize it
    lens = [ln for ln in lens if ln > 0]
    syms = sorted(set(quals)) if quals else [0]
    if use_qmap is None:
        use_qmap = len(syms) <= 16
    pm = _Param()
    pm.pflags = PFLAG_DO_LEN | PFLAG_HAVE_PTAB
    if use_qmap:
        pm.pflags |= PFLAG_HAVE_QMAP
        pm.qmap = list(syms)
        qidx = {s: i for i, s in enumerate(syms)}
        pm.max_sym = len(syms)
    else:
        pm.qmap = None
        qidx = None
        pm.max_sym = (max(quals) if quals else 0) + 1
    if use_dedup:
        pm.pflags |= PFLAG_DO_DEDUP
    pm.context = 0
    pm.qbits, pm.qshift = 10, 5
    pm.qloc, pm.sloc = 0, 15
    pm.ploc, pm.dloc = 10, 15
    pm.qmask = (1 << pm.qbits) - 1
    pm.qtab = None
    pm.dtab = None
    # 1024 positions -> 64 buckets of 16
    pm.ptab = [min(p >> 4, 63) for p in range(1024)]
    pm.do_dedup = use_dedup
    pm.do_len = True
    pm.do_sel = False
    pm.have_qmap = use_qmap

    gflags = GFLAG_DO_REV if rev else 0
    out = bytearray([FQZ_VERS, gflags])
    out += pm.write()

    models = _Models(pm.max_sym, 0)
    rc = _REnc()
    st = _State()
    pos = 0
    prev_rec: bytes | None = None
    for ri, ln in enumerate(lens):
        rec = quals[pos : pos + ln]
        pos += ln
        models.len[0].enc(rc, ln & 0xFF)
        models.len[1].enc(rc, (ln >> 8) & 0xFF)
        models.len[2].enc(rc, (ln >> 16) & 0xFF)
        models.len[3].enc(rc, (ln >> 24) & 0xFF)
        if rev:
            models.rev.enc(rc, 1 if rev[ri] else 0)
        if use_dedup:
            dup = prev_rec == rec and prev_rec is not None
            models.dup.enc(rc, 1 if dup else 0)
            if dup:
                continue
        st.reset(ln, 0)
        for b in rec:
            q = qidx[b] if qidx is not None else b
            models.q(_ctx(pm, st)).enc(rc, q)
            _update(pm, st, q)
        prev_rec = rec
    out += rc.finish()
    return bytes(out)
