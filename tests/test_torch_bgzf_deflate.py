"""PyTorch port: the BGZF writers' compressor on the card
(``csrc/bgzf_deflate.cu``) and its plain version (``ptio_bgzf_deflate_plain``
in ``io/native/ptio.cc``, the same algorithm from ``csrc/bgzf_deflate.h``).

On the CPU: every stream inflates with zlib to its payload and carries the
payload's CRC32; an incompressible payload is stored and a run of one byte
is matches of 258 at distance 1; the output is within 2% of zlib level 6's
on the benchmark generator's reads; a writer whose codec thread deflates
through a card (here one that runs the plain version on the host) frames its
blocks as BGZF does and ends with the EOF block, and stops sending sets to
the card after a failed submit; the search's count of chain entries holds
on known payloads; a writer without a card
writes the bytes of the original ``ptio.cc``; and a whole native-feed call
through such a card gives the host path's records.  On the card, the
kernel's bytes equal the plain version's, and a native-feed call on
``cuda`` deflates every block there:

    python -m pytest --noconftest tests/test_torch_bgzf_deflate.py -m cuda

(this file imports no JAX; ``--noconftest`` skips the suite's JAX set-up).
"""

import ctypes
import os
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from portello_tpu_torch import main as port
from portello_tpu_torch.io.bam import BamReader
from portello_tpu_torch.kernels import bgzf_deflate as bd
from portello_tpu_torch.pipeline import native_feed
from portello_tpu_torch.testutil.simulate import make_scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def _payloads() -> dict[str, bytes]:
    rng = np.random.default_rng(17)
    # HiFi-like qualities: most bytes one value, the rest spread
    quals = np.where(rng.random(bd.MAX_PAYLOAD) < 0.63, 40,
                     rng.integers(2, 93, bd.MAX_PAYLOAD)).astype(np.uint8)
    bases = rng.choice(np.array([0x11, 0x12, 0x14, 0x18, 0x21, 0x22, 0x24, 0x28,
                                 0x41, 0x42, 0x44, 0x48, 0x81, 0x82, 0x84, 0x88],
                                np.uint8), bd.MAX_PAYLOAD)
    records = np.concatenate([np.concatenate([bases[k:k + 700], quals[k:k + 1400]])
                              for k in range(0, 22000, 700)])[:bd.MAX_PAYLOAD]
    return {
        "empty": b"",
        "one_byte": b"\x2a",
        "two_bytes": b"ab",
        "three_bytes": b"aaa",
        "short_text": b"the payload of a BGZF block, " * 9,
        "run": b"\x28" * bd.MAX_PAYLOAD,
        "random": rng.integers(0, 256, bd.MAX_PAYLOAD, np.uint8).tobytes(),
        "random_tail": rng.integers(0, 256, 1001, np.uint8).tobytes(),
        "qualities": quals.tobytes(),
        "records": records.tobytes(),
        "period_3": b"abc" * (bd.MAX_PAYLOAD // 3),
        "far_repeat": (rng.integers(0, 256, 20000, np.uint8).tobytes() * 4)[:60000],
    }


PAYLOADS = _payloads()


@pytest.fixture(scope="module")
def lib():
    lib = native_feed.get_lib()
    if lib is None:
        pytest.skip(f"ptscan unavailable: {native_feed.build_error()}")
    return lib


def _inflate(stream: bytes) -> bytes:
    d = zlib.decompressobj(-15)
    out = d.decompress(stream) + d.flush()
    assert d.eof and not d.unused_data
    return out


# ------------------------------------------------------------ a decoder

class _Bits:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def get(self, n: int) -> int:
        v = 0
        for k in range(n):
            byte = self.data[self.pos >> 3]
            v |= ((byte >> (self.pos & 7)) & 1) << k
            self.pos += 1
        return v

    def huff(self, table: dict) -> int:
        code = length = 0
        while (length, code) not in table:
            code = code << 1 | self.get(1)
            length += 1
            assert length <= 15
        return table[(length, code)]


def _table(lengths) -> dict:
    count = [0] * 16
    for ln in lengths:
        count[ln] += 1
    count[0] = 0
    nxt, code = [0] * 16, 0
    for ln in range(1, 16):
        code = (code + count[ln - 1]) << 1
        nxt[ln] = code
    table = {}
    for sym, ln in enumerate(lengths):
        if ln:
            table[(ln, nxt[ln])] = sym
            nxt[ln] += 1
    return table


_LBASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
          59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DBASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
          513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577]
_DEXTRA = [0, 0, 0, 0] + [k // 2 for k in range(2, 28)]


def _symbols(stream: bytes):
    """The deflate stream's blocks as (type, symbols): a literal is an int,
    a match a (length, distance) pair."""
    bits, blocks, last = _Bits(stream), [], 0
    while not last:
        last, kind = bits.get(1), bits.get(2)
        syms = []
        if kind == 0:
            bits.pos = (bits.pos + 7) & ~7
            n = bits.get(16)
            assert bits.get(16) == n ^ 0xffff
            syms = [bits.get(8) for _ in range(n)]
        else:
            if kind == 1:
                lit = _table([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)
                dist = _table([5] * 30)
            else:
                hlit, hdist, hclen = bits.get(5) + 257, bits.get(5) + 1, bits.get(4) + 4
                order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
                cl = [0] * 19
                for k in range(hclen):
                    cl[order[k]] = bits.get(3)
                cl_table, lens = _table(cl), []
                while len(lens) < hlit + hdist:
                    s = bits.huff(cl_table)
                    if s < 16:
                        lens.append(s)
                    elif s == 16:
                        lens += [lens[-1]] * (3 + bits.get(2))
                    elif s == 17:
                        lens += [0] * (3 + bits.get(3))
                    else:
                        lens += [0] * (11 + bits.get(7))
                assert len(lens) == hlit + hdist
                lit, dist = _table(lens[:hlit]), _table(lens[hlit:])
            while (s := bits.huff(lit)) != 256:
                if s < 256:
                    syms.append(s)
                    continue
                length = _LBASE[s - 257] + bits.get(_LEXTRA[s - 257])
                d = bits.huff(dist)
                syms.append((length, _DBASE[d] + bits.get(_DEXTRA[d])))
        blocks.append((kind, syms))
    return blocks


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_plain_stream_inflates_to_its_payload_with_its_crc(lib, name):
    payload = PAYLOADS[name]
    [(stream, crc)] = bd.deflate_plain([payload])
    assert _inflate(stream) == payload
    assert crc == zlib.crc32(payload)
    assert len(stream) + 26 <= 65536  # BSIZE fits 16 bits
    blocks = _symbols(stream)
    decoded = bytearray()
    for _, syms in blocks:
        for s in syms:
            if isinstance(s, int):
                decoded.append(s)
            else:
                length, dist = s
                assert 3 <= length <= 258 and 1 <= dist <= min(32768, len(decoded))
                for _ in range(length):
                    decoded.append(decoded[-dist])
    assert bytes(decoded) == payload


def test_incompressible_payload_is_stored(lib):
    payload = PAYLOADS["random"]
    [(stream, _)] = bd.deflate_plain([payload])
    blocks = _symbols(stream)
    assert {kind for kind, _ in blocks} == {0}
    assert len(stream) == len(payload) + 5 * len(blocks)
    assert len(stream) + 26 <= 65536


def test_run_of_one_byte_is_matches_of_258_at_distance_1(lib):
    [(stream, _)] = bd.deflate_plain([PAYLOADS["run"]])
    [(_, syms)] = _symbols(stream)
    assert syms[0] == 0x28
    matches = syms[1:]
    assert all(d == 1 for _, d in matches)
    assert all(length == 258 for length, _ in matches[:-1])
    assert 1 + sum(length for length, _ in matches) == bd.MAX_PAYLOAD


def test_search_visits_count_the_chain_entries_looked_at(lib):
    """A run of one byte finds its longest match at the first entry of
    every chain; distinct trigrams have no chains; no position looks at
    more than 128 entries."""
    run = PAYLOADS["run"]
    assert bd.search_visits([run]) == len(run) - 3
    assert bd.search_visits([bytes(range(200)), b"", b"ab"]) == 0
    quals = PAYLOADS["qualities"]
    assert 0 < bd.search_visits([quals]) <= 128 * (len(quals) - 2)


def test_empty_and_short_payloads(lib):
    got = bd.deflate_plain([b"", b"\x2a", b"ab"])
    assert got[0] == (b"\x03\x00", 0)  # one final fixed block, end of block
    assert [_inflate(s) for s, _ in got] == [b"", b"\x2a", b"ab"]


def test_plain_is_deterministic(lib):
    payloads = [PAYLOADS["records"], PAYLOADS["qualities"]]
    assert bd.deflate_plain(payloads) == bd.deflate_plain(payloads)


def _zlib6(payload: bytes) -> int:
    z = zlib.compressobj(6, zlib.DEFLATED, -15, 8)
    return len(z.compress(payload) + z.flush())


def test_size_within_2pct_of_zlib6_on_the_benchmark_reads(lib, tmp_path):
    """The reads of the benchmark's generator at a CPU test's size, in the
    writer's 65,280-byte blocks."""
    from benchmark.gen import build
    from benchmark.tests import tiny

    _, _, config, mix = tiny.spec("revio.hostshift")
    meta = build.build(config, mix, 2**31 + 5, str(tmp_path))
    with BamReader(meta["reads_bam"]) as r:
        assert r.header is not None
    import gzip

    with gzip.open(meta["reads_bam"], "rb") as f:
        raw = f.read()
    blocks = [raw[k:k + bd.MAX_PAYLOAD] for k in range(0, len(raw), bd.MAX_PAYLOAD)]
    assert len(blocks) >= 50
    ours = sum(len(s) for s, _ in bd.deflate_plain(blocks))
    ref = sum(_zlib6(b) for b in blocks)
    assert ours <= 1.02 * ref, (ours, ref)


# ---------------------------------------------------- a writer with a card

def _bgzf_blocks(data: bytes):
    """(deflate stream, inflated payload) of each BGZF block of a file, with
    its framing checked; the EOF block last."""
    blocks, off = [], 0
    while off < len(data):
        head = data[off:off + 18]
        assert head[:4] == b"\x1f\x8b\x08\x04" and head[10:12] == b"\x06\x00"
        assert head[12:16] == b"BC\x02\x00"
        bsize = int.from_bytes(head[16:18], "little") + 1
        block = data[off:off + bsize]
        assert len(block) == bsize
        stream = block[18:-8]
        crc = int.from_bytes(block[-8:-4], "little")
        isize = int.from_bytes(block[-4:], "little")
        payload = _inflate(stream)
        assert len(payload) == isize <= bd.MAX_PAYLOAD
        assert crc == zlib.crc32(payload)
        blocks.append((stream, payload, block))
        off += bsize
    assert blocks[-1][2] == EOF_BLOCK
    return blocks[:-1]


def _write(lib, path, data: bytes, card=None, level=6, threads=3, piece=7777):
    if card is None:
        w = lib.ptio_writer_open(str(path).encode(), level, threads)
    else:
        w = lib.ptio_writer_open_card(str(path).encode(), level, threads, card)
    assert w
    for k in range(0, len(data), piece):
        lib.ptio_write(w, data[k:k + piece], len(data[k:k + piece]))
    assert lib.ptio_writer_close(w) == 1
    with open(path, "rb") as f:
        return f.read()


def _data(n_blocks: float) -> bytes:
    rec = PAYLOADS["records"]
    return (rec * (int(n_blocks) + 1))[:int(n_blocks * bd.MAX_PAYLOAD)]


@pytest.mark.parametrize("staged", [1, 3, 256])
def test_writer_through_a_card_frames_bgzf_blocks(lib, tmp_path, staged):
    card = lib.ptio_bgzf_host_card(staged)
    try:
        data = _data(13.5)
        out = _write(lib, tmp_path / "card.bgzf", data, card=card)
    finally:
        lib.ptio_bgzf_host_card_free(card)
    blocks = _bgzf_blocks(out)
    assert b"".join(p for _, p, _ in blocks) == data
    assert [len(p) for _, p, _ in blocks] == [bd.MAX_PAYLOAD] * 13 + [bd.MAX_PAYLOAD // 2]
    plain = bd.deflate_plain([p for _, p, _ in blocks])
    assert [s for s, _, _ in blocks] == [s for s, _ in plain]


@pytest.mark.parametrize("fail_at", [0, 3])
def test_writer_stops_at_the_cards_first_failed_submit(lib, tmp_path, fail_at):
    """A failed submit fails the writer's close, is never waited on, and
    no set goes to the card after it."""
    card = lib.ptio_bgzf_host_card(2)
    lib.ptio_bgzf_host_card_fail(card, fail_at)
    data = _data(13.5)
    try:
        w = lib.ptio_writer_open_card(str(tmp_path / "f.bgzf").encode(), 6, 3,
                                      card)
        assert w
        for k in range(0, len(data), 7777):
            lib.ptio_write(w, data[k:k + 7777], len(data[k:k + 7777]))
        assert lib.ptio_writer_close(w) == 0
        waits = ctypes.c_int()
        submits = lib.ptio_bgzf_host_card_calls(card, ctypes.byref(waits))
    finally:
        lib.ptio_bgzf_host_card_free(card)
    assert (submits, waits.value) == (fail_at + 1, fail_at)


def test_writer_through_a_card_with_nothing_written(lib, tmp_path):
    card = lib.ptio_bgzf_host_card(4)
    try:
        out = _write(lib, tmp_path / "empty.bgzf", b"", card=card)
    finally:
        lib.ptio_bgzf_host_card_free(card)
    assert out == EOF_BLOCK


def test_level_0_writer_ignores_the_card(lib, tmp_path):
    card = lib.ptio_bgzf_host_card(4)
    data = _data(2.2)
    try:
        with_card = _write(lib, tmp_path / "c.bgzf", data, card=card, level=0)
    finally:
        lib.ptio_bgzf_host_card_free(card)
    assert with_card == _write(lib, tmp_path / "h.bgzf", data, level=0)


@pytest.fixture(scope="module")
def original_ptio(tmp_path_factory):
    """The JAX package's ``ptio.cc``, which the port's copy began from,
    built with the flags of the port's native library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    src = os.path.join(REPO, "portello_tpu", "io", "native", "ptio.cc")
    so = str(tmp_path_factory.mktemp("original_ptio") / "ptio.so")
    base = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", so]
    proc = subprocess.run(base + ["-lz", "-ldeflate", "-lpthread"],
                          capture_output=True)
    if proc.returncode != 0:
        subprocess.run(base + ["-DPTIO_NO_LIBDEFLATE", "-lz", "-lpthread"],
                       check=True, capture_output=True)
    orig = ctypes.CDLL(so)
    orig.ptio_writer_open.restype = ctypes.c_void_p
    orig.ptio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    orig.ptio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
    orig.ptio_writer_close.restype = ctypes.c_int
    orig.ptio_writer_close.argtypes = [ctypes.c_void_p]
    return orig


@pytest.mark.parametrize("level,threads", [(6, 1), (6, 4), (0, 4)])
def test_writer_without_a_card_writes_the_original_bytes(lib, original_ptio,
                                                         tmp_path, level, threads):
    data = _data(3.3)
    ours = _write(lib, tmp_path / "port.bgzf", data, level=level, threads=threads)
    theirs = _write(original_ptio, tmp_path / "orig.bgzf", data, level=level,
                    threads=threads)
    assert ours == theirs


# ------------------------------------------------ a native-feed call

@pytest.fixture(scope="module")
def scenario(tmp_path_factory, lib):
    d = tmp_path_factory.mktemp("bgzf_deflate")
    make_scenario(str(d), rng=np.random.default_rng(41),
                  n_reads_per_contig=60, read_len=1500)
    return d


def _args(d, tag, device, *extra):
    return [
        "--assembly-to-ref", str(d / "asm_to_ref.bam"),
        "--read-to-assembly", str(d / "read_to_asm.bam"),
        "--remapped-read-output", str(d / f"remapped_{tag}.bam"),
        "--unassembled-read-output", str(d / f"un_{tag}.bam"),
        "--ref", str(d / "ref.fa"), "--device", device,
        "--batch-size", "32", "--threads", "3", *extra,
    ]


def _records(path) -> list[str]:
    with BamReader(str(path)) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


def _outputs(d, tag) -> tuple[list[str], list[str]]:
    return _records(d / f"remapped_{tag}.bam"), _records(d / f"un_{tag}.bam")


@pytest.fixture(scope="module")
def host_records(scenario):
    port.main(_args(scenario, "host", "host"))
    return _outputs(scenario, "host")


def test_native_feed_through_host_cards_equals_the_host_path(
        scenario, host_records, lib, monkeypatch):
    cards = (ctypes.c_void_p * 2)(lib.ptio_bgzf_host_card(3),
                                  lib.ptio_bgzf_host_card(3))
    monkeypatch.setattr(native_feed, "writer_cards", lambda device: cards)
    try:
        port.main(_args(scenario, "cards", "cpu", "--feed", "native"))
    finally:
        for c in cards:
            lib.ptio_bgzf_host_card_free(c)
    stats = native_feed._last_stats
    assert _outputs(scenario, "cards") == host_records
    assert stats["deflate_blocks"]["host"] == 0
    assert stats["deflate_blocks"]["card"] > 0
    assert stats["deflate_launches"] >= 2
    assert stats["waits"]["card_deflate done@deflate"] == stats["deflate_launches"]
    for tag in ("remapped", "un"):
        with open(scenario / f"{tag}_cards.bam", "rb") as f:
            _bgzf_blocks(f.read())


def test_native_feed_on_the_cpu_deflates_on_the_host(scenario, host_records):
    port.main(_args(scenario, "cpu", "cpu", "--feed", "native"))
    stats = native_feed._last_stats
    assert _outputs(scenario, "cpu") == host_records
    assert stats["deflate_blocks"]["card"] == 0
    assert stats["deflate_blocks"]["host"] > 0
    assert stats["deflate_launches"] == 0
    assert "card_deflate done@deflate" not in stats["waits"]


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [132, 5])
def test_kernel_bytes_equal_the_plain_version(lib, cuda_device, grid):
    payloads = list(PAYLOADS.values()) + [PAYLOADS["records"][:k] for k in
                                          (3, 4, 31, 32, 33, 4097, 65279)]
    got = bd.deflate_cuda(payloads, cuda_device, grid=grid)
    want = bd.deflate_plain(payloads)
    for p, g, w in zip(payloads, got, want):
        assert g == w, len(p)


@pytest.mark.cuda
def test_kernel_bytes_equal_the_plain_version_on_the_benchmark_reads(
        lib, cuda_device, tmp_path):
    from benchmark.gen import build
    from benchmark.tests import tiny
    import gzip

    _, _, config, mix = tiny.spec("longinsert.hostshift", 200)
    meta = build.build(config, mix, 2**31 + 11, str(tmp_path))
    with gzip.open(meta["reads_bam"], "rb") as f:
        raw = f.read()
    blocks = [raw[k:k + bd.MAX_PAYLOAD] for k in range(0, len(raw), bd.MAX_PAYLOAD)]
    got = bd.deflate_cuda(blocks, cuda_device)
    assert got == bd.deflate_plain(blocks)
    assert [_inflate(s) for s, _ in got] == blocks


@pytest.mark.cuda
def test_native_feed_on_cuda_deflates_every_block_on_the_card(
        scenario, host_records, cuda_device):
    port.main(_args(scenario, "cuda", "cuda", "--feed", "native"))
    stats = native_feed._last_stats
    assert _outputs(scenario, "cuda") == host_records
    assert stats["deflate_blocks"]["host"] == 0
    assert stats["deflate_blocks"]["card"] > 0
    assert stats["deflate_launches"] > 0
