"""Window runs of mixed indel clusters (stage 4 of the resident step).

On CUDA tensors these launch the hand-written kernel in
``csrc/window_match.cu``, which takes the place of the TPU kernel
``portello_tpu.kernels.pallas.window_match.window_match_runs_batch``; on
CPU tensors they run the plain PyTorch versions below.  Two contracts share
the kernel's per-window compare (``csrc/window_runs.h``):

- ``window_runs_resident``: the main path.  For each mixed (item, cluster),
  the trailing equal run of the windows that end at the cluster's ref and
  read ends, and the leading equal run of the windows that start at its ref
  and read starts, read from the resident genome and the packed read row
  (``simplify_kernel.py:482-502`` of the JAX package).  No limit applies;
  clusters that are not mixed get 0.
- ``window_match_runs_batch``: the Pallas kernel's own contract on
  ``pad_table`` tables, so the kernel is held against its semantics.
"""

from __future__ import annotations

import torch

from portello_tpu_torch.kernels.resident import read_windows_packed, ref_windows

_I32 = torch.int32

PAD_LO = 128  # front sentinel pad of a pad_table row (starts reach -window)
TAB_SB = 128  # pad_table row width (bytes)


def pad_table(seq: torch.Tensor, fill: int) -> torch.Tensor:
    """(..., L) uint8 sequences -> (..., nsb, 128) tables, as the JAX
    ``pad_table``: ``PAD_LO`` fill bytes in front, a fill tail rounding the
    total to a multiple of 128 with at least 256 spare."""
    length = seq.shape[-1]
    lead = seq.shape[:-1]
    pad_hi = 256 + (-length) % TAB_SB
    padded = torch.cat(
        [
            torch.full((*lead, PAD_LO), fill, dtype=torch.uint8, device=seq.device),
            seq,
            torch.full((*lead, pad_hi), fill, dtype=torch.uint8, device=seq.device),
        ],
        dim=-1,
    )
    return padded.reshape(*lead, -1, TAB_SB)


def _runs(eq: torch.Tensor):
    """(..., W) equality -> (leading run, trailing run) int32."""
    lead = torch.cumprod(eq.to(_I32), -1, dtype=_I32).sum(-1, dtype=_I32)
    trail = torch.cumprod(eq.flip(-1).to(_I32), -1, dtype=_I32).sum(-1, dtype=_I32)
    return lead, trail


def _table_windows(tab, starts, window: int):
    """(B, nsb, 128) tables at (B, C) starts -> (B, C, window) bytes, with
    the Pallas kernel's superblock clamp."""
    b, nsb, _ = tab.shape
    p = starts.long() + PAD_LO
    first = (torch.clamp(p >> 7, 0, nsb - 2) << 7) + (p & 127)
    t = torch.arange(window, dtype=torch.int64, device=tab.device)
    idx = (first.unsqueeze(-1) + t).reshape(b, -1)
    return torch.gather(tab.reshape(b, -1), 1, idx).reshape(*starts.shape, window)


def window_match_runs_plain(a_tab, b_tab, ia, ib, window: int):
    """Plain PyTorch version of the Pallas contract.

    a_tab/b_tab: (B, nsb, 128) uint8 from :func:`pad_table`; ia/ib: (B, C)
    int32 window starts into the unpadded sequences, in [-window, len].
    Returns (run_fwd, run_rev), each (B, C) int32 in [0, window]."""
    eq = _table_windows(a_tab, ia, window) == _table_windows(b_tab, ib, window)
    return _runs(eq)


def window_match_runs_cuda(a_tab, b_tab, ia, ib, window: int):
    """Launch ``ptt_window_match``; same contract as the plain version."""
    from portello_tpu_torch.kernels import _cuda

    _cuda.require(a_tab, "a_tab", torch.uint8, 3)
    _cuda.require(b_tab, "b_tab", torch.uint8, 3)
    if b_tab.shape != a_tab.shape or b_tab.device != a_tab.device:
        raise ValueError("a_tab and b_tab must share shape and device")
    b, nsb, width = a_tab.shape
    if width != TAB_SB or nsb < 2:
        raise ValueError(f"tables must be (B, nsb >= 2, {TAB_SB}), got "
                         f"{tuple(a_tab.shape)}")
    for name, x in (("ia", ia), ("ib", ib)):
        _cuda.require(x, name, _I32, 2)
        if x.shape != ia.shape or x.shape[0] != b:
            raise ValueError(f"{name} must be (B, C) matching the tables")
        if x.device != a_tab.device:
            raise ValueError(f"{name} must be on {a_tab.device}")
    if not 0 < window <= TAB_SB:
        raise ValueError(f"window must be in (0, {TAB_SB}], got {window}")
    c = ia.shape[1]
    run_fwd = torch.empty((b, c), dtype=_I32, device=a_tab.device)
    run_rev = torch.empty((b, c), dtype=_I32, device=a_tab.device)
    lib = _cuda.get_lib()
    with torch.cuda.device(a_tab.device):
        rc = lib.ptt_window_match(
            a_tab.data_ptr(), b_tab.data_ptr(), nsb, ia.data_ptr(),
            ib.data_ptr(), b, c, window, run_fwd.data_ptr(),
            run_rev.data_ptr(), _cuda.stream_handle(),
        )
    _cuda.check(rc, "window_match")
    return run_fwd, run_rev


def window_match_runs_batch(a_tab, b_tab, ia, ib, *, window: int):
    """The Pallas contract: kernel for CUDA tensors, plain for CPU."""
    if a_tab.is_cuda:
        return window_match_runs_cuda(a_tab, b_tab, ia, ib, window)
    return window_match_runs_plain(a_tab, b_tab, ia, ib, window)


def window_runs_resident_plain(genome, g_base, read_packed, bs, rs, dl, il,
                               mixed, window: int):
    """Plain PyTorch version of the resident contract.

    genome: (N,) uint8, N a multiple of 64; g_base: (B,) int64 global byte
    offset of each item's ref coordinates; read_packed: (B, Lp) uint8 BAM
    nibble rows; bs/rs/dl/il: (B, C) int32 cluster ref start, read start,
    deletion and insertion lengths; mixed: (B, C) bool.  Returns (raw_r,
    raw_l), (B, C) int32 in [0, window], 0 where not mixed."""
    base = g_base[:, None]
    starts_a = torch.stack([bs + dl - window, bs], dim=-1)      # (B, C, 2)
    starts_b = torch.stack([rs + il - window, rs], dim=-1)
    b, c = bs.shape
    wa = ref_windows(genome, base[:, :, None], starts_a, window)  # (B, C, 2, W)
    wb = read_windows_packed(read_packed, starts_b.reshape(b, 2 * c), window)
    eq = wa == wb.reshape(b, c, 2, window)
    lead, trail = _runs(eq)
    zero = torch.zeros_like(bs)
    return (torch.where(mixed, trail[:, :, 0], zero),
            torch.where(mixed, lead[:, :, 1], zero))


def window_runs_resident_cuda(genome, g_base, read_packed, bs, rs, dl, il,
                              mixed, window: int):
    """Launch ``ptt_window_runs_resident``; same contract as the plain
    version.  One launch covers every (item, cluster) pair."""
    from portello_tpu_torch.kernels import _cuda

    _cuda.require(genome, "genome", torch.uint8, 1)
    _cuda.require(g_base, "g_base", torch.int64, 1)
    _cuda.require(read_packed, "read_packed", torch.uint8, 2)
    _cuda.require(mixed, "mixed", torch.bool, 2)
    dev = genome.device
    b = read_packed.shape[0]
    if genome.shape[0] < 2 * 64:
        raise ValueError("genome must hold at least two 64-byte superblocks")
    if g_base.shape[0] != b:
        raise ValueError("g_base must be (B,) matching read_packed")
    for name, x in (("bs", bs), ("rs", rs), ("dl", dl), ("il", il)):
        _cuda.require(x, name, _I32, 2)
        if x.shape != mixed.shape or x.shape[0] != b:
            raise ValueError(f"{name} must be (B, C) matching mixed")
    for name, x in (("g_base", g_base), ("read_packed", read_packed),
                    ("bs", bs), ("rs", rs), ("dl", dl), ("il", il),
                    ("mixed", mixed)):
        if x.device != dev:
            raise ValueError(f"{name} must be on {dev}")
    if not 0 < window <= 64:
        raise ValueError(f"window must be in (0, 64], got {window}")
    c = mixed.shape[1]
    raw_r = torch.empty((b, c), dtype=_I32, device=dev)
    raw_l = torch.empty((b, c), dtype=_I32, device=dev)
    lib = _cuda.get_lib()
    with torch.cuda.device(dev):
        rc = lib.ptt_window_runs_resident(
            genome.data_ptr(), genome.shape[0], g_base.data_ptr(),
            read_packed.data_ptr(), read_packed.shape[1], bs.data_ptr(),
            rs.data_ptr(), dl.data_ptr(), il.data_ptr(), mixed.data_ptr(),
            b, c, window, raw_r.data_ptr(), raw_l.data_ptr(),
            _cuda.stream_handle(),
        )
    _cuda.check(rc, "window_match")
    return raw_r, raw_l


def window_runs_resident(genome, g_base, read_packed, bs, rs, dl, il, mixed,
                         window: int):
    """The resident window runs: kernel for CUDA tensors, plain for CPU."""
    if genome.is_cuda:
        return window_runs_resident_cuda(
            genome, g_base, read_packed, bs, rs, dl, il, mixed, window
        )
    return window_runs_resident_plain(
        genome, g_base, read_packed, bs, rs, dl, il, mixed, window
    )

