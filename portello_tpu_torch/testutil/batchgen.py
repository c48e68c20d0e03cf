"""Synthetic padded forward-step batches with HiFi-like shape statistics.

Jax-free copies, for ``chip_smoke.py`` on a machine without JAX:

- ``make_item_arrays``: ``portello_tpu.testutil.batchgen.make_item_arrays``
  (that module imports jax through ``kernels.cigar_kernels``), forward and
  reverse (``rev=True``) batches.  For the same generator state it returns
  the same arrays as the JAX helper (``tests/test_torch_fwd_step.py``,
  ``tests/test_torch_rev_step.py``).
- ``shift_win_base``: moves half of a reverse batch's items deeper into a
  longer contig, to nonzero window bases.
- ``resident_from_table``: turns such a table batch into resident inputs.
- ``mixed_cigar`` and ``resident_table_pair``: the adversarial generator of
  the JAX package's resident tests (``tests/test_resident.py``): clusters at
  the span's start and end, split-gap lifts, odd read offsets and windows at
  chromosome boundaries, as paired table and resident inputs.
"""

from __future__ import annotations

import numpy as np

from portello_tpu.ops import cigar as cg
from portello_tpu.ops.blockmap import build_block_map
from portello_tpu.testutil.simulate import apply_edits, rand_seq
from portello_tpu_torch.kernels.cigar_kernels import INT32_MAX, PAD
from portello_tpu_torch.kernels.resident import (
    SB,
    build_global_ref,
    pack_seq_rows,
    split_global_base,
)
from portello_tpu_torch.models.batch import BucketConfig

#: Primary bucket for 18-24 kb HiFi reads (``DEFAULT_BUCKETS[0]``).
HIFI_BUCKET = BucketConfig(
    max_ops=128, max_blocks=48, max_seq=24576, max_clusters=96, window=48
)


def make_item_arrays(
    rng: np.random.Generator,
    b: int,
    bcfg: BucketConfig,
    read_len: int = 18000,
    read_error: float = 0.0025,
    contig_var_rate: float = 0.0012,
    rev: bool = False,
):
    """Build one batch of consistent (contig window, block map, read) items.

    HiFi reads map to their own sample's assembly, so read->contig cigars
    carry only sequencing error; contig->ref blocks carry variant indels.
    Returns numpy arrays in the positional order of ``fwd_batch``, or of
    ``rev_batch`` with ``rev`` (the contig row as ``contig_win``, at
    ``win_base`` 0).
    """
    margin = 64
    span = read_len + 2 * margin
    ops = np.full((b, bcfg.max_ops), PAD, np.int32)
    lens = np.zeros((b, bcfg.max_ops), np.int32)
    n_ops = np.zeros(b, np.int32)
    pos = np.zeros(b, np.int32)
    bk = np.full((b, bcfg.max_blocks), INT32_MAX, np.int32)
    bv = np.full((b, bcfg.max_blocks), -1, np.int32)
    nb = np.zeros(b, np.int32)
    ref_win = np.zeros((b, bcfg.max_seq), np.uint8)
    ref_base = np.zeros(b, np.int32)
    read_seq = np.zeros((b, bcfg.max_seq), np.uint8)
    if rev:
        contig_win = np.zeros((b, bcfg.max_seq), np.uint8)
        win_base = np.zeros(b, np.int32)

    for i in range(b):
        ref_seg = rand_seq(rng, span)
        contig_seq, contig_cigar = apply_edits(
            ref_seg, rng, contig_var_rate * 0.5, contig_var_rate * 0.5, eqx=True
        )
        bm = build_block_map(0, contig_cigar, False)
        k = min(len(bm), bcfg.max_blocks)
        bk[i, :k] = bm.keys[:k]
        bv[i, :k] = bm.vals[:k]
        nb[i] = k
        rpos = margin // 2
        rl = min(read_len, len(contig_seq) - rpos - 1)
        rseq, rcig = apply_edits(
            contig_seq[rpos : rpos + rl], rng, read_error * 0.5, read_error * 0.5,
            eqx=False,
        )
        n = min(len(rcig), bcfg.max_ops)
        ops[i, :n] = rcig[:n, 0]
        lens[i, :n] = rcig[:n, 1]
        n_ops[i] = n
        pos[i] = rpos
        w = min(span, bcfg.max_seq)
        ref_win[i, :w] = ref_seg[:w]
        rs = min(len(rseq), bcfg.max_seq)
        read_seq[i, :rs] = rseq[:rs]
        if rev:
            cw = min(len(contig_seq), bcfg.max_seq)
            contig_win[i, :cw] = contig_seq[:cw]

    if rev:
        return (
            ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
            ref_win, ref_base, read_seq,
        )
    return ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq


def resident_from_table(arrays, genome_bytes=None, rng=None):
    """Resident inputs for a table batch of ``make_item_arrays``.

    Each item's ``ref_win`` row is placed in a genome at a 64-aligned offset,
    which becomes the item's global base, and its ``read_seq`` row is packed
    with ``pack_seq_rows``.  Without ``genome_bytes`` the genome is just the
    rows, laid out by ``build_global_ref``.  With it, the genome has that
    many bytes (rounded up to 64) of 'N', and the placements spread across
    it up to its end, each behind 128 random bases drawn from ``rng``; a
    genome over 2 GiB puts bases past 2^31.

    Returns ``(g_sb, g_off, read_packed, genome)``: the split bases (B,)
    int32, the packed rows (B, ceil(max_seq / 2)) uint8 and the flat uint8
    genome.  ``fwd_batch_resident`` on them equals ``fwd_batch`` on
    ``arrays``."""
    ref_win, read_seq = arrays[7], arrays[9]
    b, width = ref_win.shape
    if genome_bytes is None:
        words, g_base = build_global_ref(list(ref_win))
        genome = words.view(np.uint8).reshape(-1)
    else:
        rng = np.random.default_rng(0) if rng is None else rng
        n = -(-int(genome_bytes) // SB) * SB
        flank = 2 * SB
        stride = (n - 3 * SB - flank - width) // max(b - 1, 1) // SB * SB
        if stride < flank + width:
            raise ValueError(f"genome of {n} bytes cannot hold {b} rows")
        g_base = SB + flank + np.arange(b, dtype=np.int64) * stride
        jitter = rng.integers(0, (stride - flank - width) // SB + 1, size=b)
        g_base[:-1] += jitter[:-1].astype(np.int64) * SB
        g_base[-1] = (n - 2 * SB - width) // SB * SB  # the last row ends the genome
        genome = np.full(n, ord("N"), np.uint8)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        for i in range(b):
            o = int(g_base[i])
            genome[o - flank:o] = rng.choice(acgt, size=flank)
            genome[o:o + width] = ref_win[i]
    g_sb, g_off = split_global_base(g_base)
    return g_sb, g_off, pack_seq_rows(read_seq), genome


def mixed_cigar(rng, read_len, n_clusters, edge=None):
    """Input cigar with n_clusters DI clusters; ``edge`` places one cluster
    at the very start/end of the alignment (window reads off the span)."""
    ops = []
    if edge == "start":
        ops += [(cg.D, 2), (cg.I, 2)]
    ops += [(cg.M, 6)]
    for _ in range(n_clusters):
        ops += [(cg.D, int(rng.integers(1, 4))), (cg.I, int(rng.integers(1, 4))),
                (cg.M, int(rng.integers(4, 9)))]
    if edge == "end":
        ops += [(cg.I, 2), (cg.D, 2)]
    # top up read length with a final M
    rlen = sum(l for c, l in ops if c in (cg.M, cg.I))
    if rlen < read_len:
        ops.append((cg.M, read_len - rlen))
    return np.array(ops, np.int64)


def resident_table_pair(rng, n_items, max_ops, max_blocks, max_seq, chroms,
                        goff):
    """Paired inputs for ``fwd_batch`` (table form, filled like the JAX
    package's ``DeviceEngine._prep_item``) and ``fwd_batch_resident`` (the
    genome of ``chroms`` laid out at ``goff`` by ``build_global_ref``).
    Returns ``(table_args, res_args)``; the genome is not included."""
    b = n_items
    ops = np.full((b, max_ops), PAD, np.int32)
    lens = np.zeros((b, max_ops), np.int32)
    n_ops = np.zeros(b, np.int32)
    pos = np.zeros(b, np.int32)
    bk = np.full((b, max_blocks), INT32_MAX, np.int32)
    bv = np.full((b, max_blocks), -1, np.int32)
    nb = np.zeros(b, np.int32)
    ref_win = np.zeros((b, max_seq), np.uint8)
    ref_base = np.zeros(b, np.int32)
    read_seq = np.zeros((b, max_seq), np.uint8)
    gbyte = np.zeros(b, np.int64)
    alpha = np.frombuffer(b"ACGT", np.uint8)

    for i in range(b):
        ci = int(rng.integers(0, len(chroms)))
        chrom = chroms[ci]
        edge = [None, "start", "end", None][i % 4]
        cig = mixed_cigar(rng, int(rng.integers(40, 120)), 1 + i % 3, edge)
        rspan = int(cg.get_cigar_ref_offset(cig))
        p0 = int(rng.integers(0, max(1, len(chrom) - rspan - 4)))
        # block map: one or two mapped blocks (a split creates a lift gap)
        if i % 3 == 2 and rspan > 20:
            cut = rspan // 2
            gap = int(rng.integers(0, 6))
            keys = np.array([p0, p0 + cut, p0 + cut + 1], np.int64)
            vals = np.array([p0, -1, p0 + cut + gap], np.int64)
            keys_v = np.array([p0, p0 + cut + 1], np.int64)
            vals_v = np.array([p0, p0 + cut + gap], np.int64)
        else:
            keys = np.array([p0], np.int64)
            vals = np.array([p0], np.int64)
            keys_v, vals_v = keys, vals
        k = len(keys)
        bk[i, :k] = keys
        bv[i, :k] = np.where(vals < 0, -1, vals)
        nb[i] = k
        n = len(cig)
        ops[i, :n] = cig[:, 0]
        lens[i, :n] = cig[:, 1]
        n_ops[i] = n
        pos[i] = p0
        # ref window exactly as _prep_item computes it (span-tight)
        span_end = p0 + rspan
        nxt = np.concatenate([keys_v[1:], [span_end]])
        ref_lo = int(vals_v.min())
        ref_hi = int(
            (vals_v + np.minimum(nxt, span_end) - keys_v).max()
        )
        win = chrom[ref_lo:min(ref_hi, len(chrom))]
        ref_win[i, : len(win)] = win
        ref_base[i] = ref_lo
        gbyte[i] = goff[ci] + ref_lo
        # read bases: matches over M ops against the LIFTED ref (use the
        # contig==ref identity away from the gap), random ins content with
        # occasional re-matchable bases
        parts = []
        rp = p0
        for code, ln in cig:
            if code == cg.M:
                seg = chrom[rp : rp + ln].copy()
                if len(seg) < ln:
                    seg = np.concatenate(
                        [seg, rng.choice(alpha, size=ln - len(seg))]
                    )
                rp += ln
                parts.append(seg)
            elif code == cg.D:
                rp += ln
            else:
                parts.append(rng.choice(alpha, size=ln))
        rs = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        read_seq[i, : len(rs)] = rs

    g_sb, g_off = split_global_base(gbyte)
    packed = pack_seq_rows(read_seq)
    table_args = (ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base,
                  read_seq)
    res_args = (ops, lens, n_ops, pos, bk, bv, nb, g_sb, g_off, ref_base,
                packed)
    return table_args, res_args


def shift_win_base(rev_arrays, rng):
    """A reverse batch of ``make_item_arrays(rev=True)`` with about half of
    its items moved deeper into a longer contig: for such an item a random
    prefix of 1..2^20 bases precedes its window, so
    ``win_base`` is nonzero, ``pos`` and the block map's keys move by it,
    and ``contig_win`` stays the same row.  Items that neither step flags
    lift to the same output as in the base-0 batch.  Returns new arrays and
    the (B,) bool mask of the moved items."""
    arrays = [a.copy() for a in rev_arrays]
    pos, win_base, bk, nb = arrays[3], arrays[4], arrays[6], arrays[8]
    moved = rng.random(len(pos)) < 0.5
    for i in np.flatnonzero(moved):
        wb = int(rng.integers(1, (1 << 20) + 1))
        win_base[i] += wb
        pos[i] += wb
        bk[i, : nb[i]] += wb
    return tuple(arrays), moved
