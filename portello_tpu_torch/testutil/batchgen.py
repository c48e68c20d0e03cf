"""Synthetic padded forward-step batches with HiFi-like shape statistics.

A jax-free copy of ``portello_tpu.testutil.batchgen.make_item_arrays`` (that
module imports jax through ``kernels.cigar_kernels``), for ``chip_smoke.py``
on a machine without JAX.  For the same generator state it returns the same
arrays as the JAX helper (``tests/test_torch_fwd_step.py``).
"""

from __future__ import annotations

import numpy as np

from portello_tpu.ops.blockmap import build_block_map
from portello_tpu.testutil.simulate import apply_edits, rand_seq
from portello_tpu_torch.kernels.cigar_kernels import INT32_MAX, PAD
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
):
    """Build one batch of consistent (contig window, block map, read) items.

    HiFi reads map to their own sample's assembly, so read->contig cigars
    carry only sequencing error; contig->ref blocks carry variant indels.
    Returns numpy arrays in the positional order of ``fwd_batch``.
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

    return ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq
