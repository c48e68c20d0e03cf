"""The BGZF writers' compressor on the card (``csrc/bgzf_deflate.cu``) and
its plain version (``ptio_bgzf_deflate_plain`` of the native library,
``io/native/ptio.cc``), which give the same bytes.

A native-feed run on ``cuda`` hands ``writer_cards(device)`` to the scanner:
each of its two level-6 BGZF writers then deflates through one codec thread
that stages up to ``STAGED_BLOCKS`` payloads in pinned memory and launches
the kernel on its own stream, in place of the zlib pool.  The staging is
allocated once per process and device.  Every other writer (level 0 on
stdout, any run without a card) keeps zlib.

``deflate_cuda`` (or a ``Launch``, which stages once and can run again) and
``deflate_plain`` compress a list of payloads (each at most ``MAX_PAYLOAD``
bytes) into ``(raw deflate stream, CRC32)`` pairs, and ``search_visits``
counts the match search's work, for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from portello_tpu_torch.kernels import _cuda

MAX_PAYLOAD = 65280  # a BGZF writer's block, 0xff00 bytes
OUT_STRIDE = 65536
# Payloads a codec stages in each of its two sets: ~8 MiB, a wave of the
# card's 132 SMs; both sets together hold the 256 blocks a writer lets the
# finisher queue (ptio.cc's max_inflight), so one fills while the other is
# on the card.
STAGED_BLOCKS = 128

# Launches of deflate_cuda (the writers' codecs count theirs in the
# scanner's stats, ``deflate_launches``).
launches = 0

_cards: dict[int, ctypes.Array] = {}


def _grid(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def writer_cards(device: torch.device) -> ctypes.Array | None:
    """The remapped and the unassembled writer's codecs on ``device``, as
    the ``bgzf::Card*`` pair ``ptscan_create`` takes, made at the first
    call of the process on that device; None off the card."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _cards:
        lib = _cuda.get_lib()
        pair = (ctypes.c_void_p * 2)()
        for k in range(2):
            card = lib.ptt_bgzf_card_create(index, STAGED_BLOCKS,
                                            _grid(torch.device("cuda", index)))
            if not card:
                raise RuntimeError(f"bgzf_deflate: no staging on cuda:{index}")
            pair[k] = card
        _cards[index] = pair
    return _cards[index]


def _check(payloads) -> None:
    if any(len(p) > MAX_PAYLOAD for p in payloads):
        raise ValueError(f"a BGZF payload holds at most {MAX_PAYLOAD} bytes")


class Launch:
    """One launch of the kernel over ``payloads`` on ``device``, at most
    ``grid`` blocks (the SM count by default): ``run()`` launches it on the
    current stream over the device buffers staged once, ``results()`` reads
    back each payload's raw deflate stream and CRC32."""

    def __init__(self, payloads: list[bytes], device: torch.device,
                 grid: int | None = None):
        _check(payloads)
        n = self.n = len(payloads)
        dev = torch.device(device)
        staged = np.zeros((n, MAX_PAYLOAD), np.uint8)
        for k, p in enumerate(payloads):
            staged[k, :len(p)] = np.frombuffer(p, np.uint8)
        self.inp = torch.from_numpy(staged).to(dev)
        self.in_len = torch.tensor([len(p) for p in payloads],
                                   dtype=torch.int32, device=dev)
        self.out = torch.empty((n, OUT_STRIDE), dtype=torch.uint8, device=dev)
        self.out_len = torch.empty(n, dtype=torch.int32, device=dev)
        self.crc = torch.empty(n, dtype=torch.int32, device=dev)
        self.scratch = torch.empty((n, MAX_PAYLOAD), dtype=torch.int32,
                                   device=dev)
        self.grid = grid or _grid(dev)

    def run(self) -> None:
        global launches
        if self.n == 0:
            return
        rc = _cuda.get_lib().ptt_bgzf_deflate(
            self.inp.data_ptr(), self.in_len.data_ptr(), self.n,
            self.out.data_ptr(), self.out_len.data_ptr(), self.crc.data_ptr(),
            self.scratch.data_ptr(), self.grid, _cuda.stream_handle())
        if rc != 0:
            raise RuntimeError(f"bgzf_deflate kernel launch failed: CUDA error {rc}")
        launches += 1

    def results(self) -> list[tuple[bytes, int]]:
        out, out_len = self.out.cpu().numpy(), self.out_len.cpu().numpy()
        crcs = self.crc.cpu().numpy().view(np.uint32)
        return [(out[k, :out_len[k]].tobytes(), int(crcs[k]))
                for k in range(self.n)]


def deflate_cuda(payloads: list[bytes], device: torch.device,
                 grid: int | None = None) -> list[tuple[bytes, int]]:
    """Each payload's raw deflate stream and CRC32, from one launch on
    ``device`` (at most ``grid`` blocks; the SM count by default)."""
    launch = Launch(payloads, device, grid)
    launch.run()
    return launch.results()


def _native_lib():
    from portello_tpu_torch.pipeline import native_feed

    lib = native_feed.get_lib()
    if lib is None:
        raise RuntimeError(f"ptscan unavailable: {native_feed.build_error()}")
    return lib


def search_visits(payloads: list[bytes]) -> int:
    """The chain entries the match search looks at over ``payloads``: the
    work that bounds the kernel (each a candidate's position and one byte
    loaded from shared memory)."""
    _check(payloads)
    lib = _native_lib()
    return sum(lib.ptio_bgzf_search_visits(p, len(p)) for p in payloads)


def deflate_plain(payloads: list[bytes]) -> list[tuple[bytes, int]]:
    """Each payload's raw deflate stream and CRC32 from the plain version."""
    _check(payloads)
    lib = _native_lib()
    out = np.zeros(OUT_STRIDE, np.uint8)
    crc = ctypes.c_uint32()
    got = []
    for p in payloads:
        buf = np.frombuffer(p, np.uint8) if p else np.zeros(1, np.uint8)
        n = lib.ptio_bgzf_deflate_plain(buf.ctypes.data, len(p), out.ctypes.data,
                                        ctypes.byref(crc))
        got.append((out[:n].tobytes(), crc.value))
    return got
