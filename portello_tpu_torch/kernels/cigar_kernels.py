"""Batched CIGAR normalization: edge-indel cleanup and compress.

Port of ``portello_tpu.kernels.cigar_kernels`` (gather form) to PyTorch on
``(B, K)`` int32 code/len tensors.  ``cleanup_and_compress`` is the stage the
forward step runs twice per item (lift site and finish site); on a CUDA
tensor it launches the hand-written kernel in ``csrc/compress.cu``, which
takes the place of the TPU kernel
``portello_tpu.kernels.pallas.compress_pallas.cleanup_and_compress_batch``.
On a CPU tensor it runs the plain PyTorch version below.
"""

from __future__ import annotations

import torch

# Op codes (must match portello_tpu.ops.cigar).
M, I, D, N, S, H, P, EQ, X, PAD = 0, 1, 2, 3, 4, 5, 6, 7, 8, 9

INT32_MAX = 2**31 - 1

_I32 = torch.int32


def is_align_match(codes):
    return (codes == M) | (codes == EQ) | (codes == X)


def consumes_ref(codes):
    return (codes == M) | (codes == D) | (codes == N) | (codes == EQ) | (codes == X)


def consumes_read(codes):
    # hard clips count (the pipeline runs with ignore_hard_clip=False)
    return (
        (codes == M) | (codes == I) | (codes == S) | (codes == H)
        | (codes == EQ) | (codes == X)
    )


def arange32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def exclusive_cummax(x: torch.Tensor) -> torch.Tensor:
    """Running maximum along dim 1, shifted right by one (first column -1)."""
    cm = torch.cummax(x, dim=1).values
    return torch.cat([torch.full_like(cm[:, :1], -1), cm[:, :-1]], dim=1)


def clean_up_edge_indels(codes, lens):
    """Batched clean_up_cigar_edge_indels (reference cigar/mod.rs:265-291).

    PAD entries are ignored but kept in place.  Edge regions are everything
    before the first / after the last M/=/X entry.  Returns (codes, lens,
    leading_del_shift (B,))."""
    n = codes.shape[1]
    valid = codes != PAD
    am = is_align_match(codes) & valid
    any_am = am.any(dim=1)
    idx = arange32(n, codes.device)
    am_i = am.to(_I32)
    first = torch.where(any_am, am_i.argmax(dim=1).to(_I32), n)
    last = torch.where(any_am, n - 1 - am_i.flip(1).argmax(dim=1).to(_I32), -1)
    lead = idx[None, :] < first[:, None]
    trail = idx[None, :] > last[:, None]
    edge = (lead | trail) & valid
    is_del = edge & (codes == D)
    is_ins = edge & (codes == I)
    shift = torch.where(lead & (codes == D) & valid, lens, 0).sum(1, dtype=_I32)
    new_codes = torch.where(is_del | is_ins, S, codes)
    new_lens = torch.where(is_del, 0, lens)
    return new_codes, new_lens, shift


def compress(codes, lens, max_out: int):
    """Batched compress_cigar (reference cigar/mod.rs:204-228), gather form.

    Drops zero-length and PAD entries, then merges adjacent equal-code runs.
    Returns (out_codes (B, max_out), out_lens, n_out (B,), overflow (B,));
    ``overflow`` is True when the compressed cigar exceeds ``max_out`` ops.
    """
    b, n = codes.shape
    dev = codes.device
    keep = (codes != PAD) & (lens != 0)
    idx = arange32(n, dev)
    # previous kept code per position: running max of (index << 4 | code)
    packed = torch.where(keep, (idx[None, :] << 4) | codes, -1)
    prev_packed = exclusive_cummax(packed)
    prev_code = torch.where(prev_packed >= 0, prev_packed & 0xF, -1)
    new_run = keep & (prev_code != codes)
    n_runs = new_run.sum(1, dtype=_I32)
    overflow = n_runs > max_out

    r = arange32(max_out, dev)
    n_kept = torch.clamp(n_runs, max=max_out)
    out_valid = r[None, :] < n_kept[:, None]
    # run r spans input indices [starts[r], starts[r+1]); lengths come from
    # a prefix sum over kept lens
    cs_runs = torch.cumsum(new_run.to(_I32), dim=1, dtype=_I32)
    boundary_q = arange32(max_out + 1, dev).add_(1).expand(b, max_out + 1)
    sboth = torch.searchsorted(
        cs_runs, boundary_q.contiguous(), right=False, out_int32=True
    ).long()
    ps = torch.cat(
        [
            torch.zeros((b, 1), dtype=_I32, device=dev),
            torch.cumsum(torch.where(keep, lens, 0), dim=1, dtype=_I32),
        ],
        dim=1,
    )
    codes_ext = torch.cat(
        [codes, torch.full((b, 1), PAD, dtype=_I32, device=dev)], dim=1
    )
    ps_at = torch.gather(ps, 1, sboth)
    out_lens = torch.where(out_valid, ps_at[:, 1:] - ps_at[:, :-1], 0)
    out_codes = torch.where(
        out_valid, torch.gather(codes_ext, 1, sboth[:, :-1]), PAD
    )
    return out_codes, out_lens, n_kept, overflow


def cleanup_and_compress_plain(codes, lens, max_out: int):
    """Plain PyTorch version of the fused pair; the CPU path and the
    reference the CUDA kernel is held against on the card."""
    codes, lens, shift = clean_up_edge_indels(codes, lens)
    out_codes, out_lens, n_out, overflow = compress(codes, lens, max_out)
    return out_codes, out_lens, n_out, shift, overflow


def cleanup_and_compress_cuda(codes, lens, max_out: int):
    """Launch ``csrc/compress.cu`` on (B, K) int32 CUDA tensors."""
    from portello_tpu_torch.kernels import _cuda

    _cuda.require(codes, "codes", _I32, 2)
    _cuda.require(lens, "lens", _I32, 2)
    if lens.shape != codes.shape or lens.device != codes.device:
        raise ValueError("codes and lens must share shape and device")
    if max_out < 1:
        raise ValueError(f"max_out must be positive, got {max_out}")
    b, k = codes.shape
    dev = codes.device
    out_codes = torch.empty((b, max_out), dtype=_I32, device=dev)
    out_lens = torch.empty((b, max_out), dtype=_I32, device=dev)
    n_out = torch.empty(b, dtype=_I32, device=dev)
    shift = torch.empty(b, dtype=_I32, device=dev)
    overflow = torch.empty(b, dtype=torch.bool, device=dev)
    lib = _cuda.get_lib()
    with torch.cuda.device(dev):
        rc = lib.ptt_cleanup_and_compress(
            codes.data_ptr(), lens.data_ptr(), b, k, max_out,
            out_codes.data_ptr(), out_lens.data_ptr(), n_out.data_ptr(),
            shift.data_ptr(), overflow.data_ptr(), _cuda.stream_handle(),
        )
    _cuda.check(rc, "cleanup_and_compress")
    return out_codes, out_lens, n_out, shift, overflow


def cleanup_and_compress(codes, lens, max_out: int):
    """clean_up_cigar_edge_indels followed by compress_cigar — the finishing
    pair applied by liftover (liftover_read_alignment.rs:218-222) and
    simplify (simplify_alignment_indels.rs:153-155).

    Returns (codes (B, max_out), lens, n_out (B,), shift (B,), overflow (B,)).
    A CUDA tensor goes to the kernel, a CPU tensor to the plain version."""
    if codes.is_cuda:
        return cleanup_and_compress_cuda(codes, lens, max_out)
    return cleanup_and_compress_plain(codes, lens, max_out)


def cigar_read_len(codes, lens):
    """Total read length per item (hard clips included), for the liftover
    length invariant (read_alignment_scanner.rs:204-229)."""
    return torch.where(consumes_read(codes), lens, 0).sum(1, dtype=_I32)
