"""Seeded inputs of one cell: a reference, haplotype contigs aligned to it,
and HiFi reads aligned to the contigs.

``build(config, mix, seed, root)`` writes, under ``root``:

- ``genome-<key>/<seed>/ref.fa`` and ``asm_to_ref.bam`` (+ ``.bai``): the
  configuration's chromosomes as random bases, and its contig layout, each
  contig a haplotype of the reference at the configuration's variant rates,
  aligned with =/X CIGARs, split records carrying SA tags;
- ``genome-<key>/<seed>/reads-<key>/reads.bam`` (+ ``.bai``): the mix's
  reads, coordinate-sorted, with the unassembled reads at the end;
  ``meta.json``, their counts.

Each ``<key>`` is a digest of the fields the generator reads (``GENOME_KEYS``
of the configuration; its ``reads`` and the mix's ``MIX_KEYS``), so two
configurations that differ only in the program's switches share their
inputs.

Everything is drawn from ``seed``; every count and size is fixed by the
configuration and the mix (lengths and read qualities on a quantile grid,
variant counts by rate), so that a seed changes where things are and which
bases, not how much work there is.  A finished directory holds
``meta.json`` last, so a directory without it is rebuilt.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from statistics import NormalDist

import numpy as np

from benchmark.gen import bamio
from benchmark.gen.bamio import EQ, FREVERSE, FSUPPLEMENTARY, FUNMAP, D, I, S, X
from benchmark.lib.buckets import BUCKETS

BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b



def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


GENOME_KEYS = ("chromosomes", "contigs", "divergence")
MIX_KEYS = ("reads", "length_median", "length_sigma", "length_clip")


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *keys])


def grid(n: int, mu: float, sigma: float, lo: float, hi: float,
         rng: np.random.Generator) -> np.ndarray:
    """``n`` values of a log-normal on the quantile grid (i + 1/2) / n,
    clipped to [lo, hi], in an order drawn from ``rng``."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return rng.permutation(np.clip(np.exp(mu + sigma * z), lo, hi))


# ------------------------------------------------------------------ events
def apply_events(seg: np.ndarray, pos: np.ndarray, kind: np.ndarray,
                 length: np.ndarray, rng: np.random.Generator):
    """``seg`` edited by sorted, non-touching events (kind 0 a substitution,
    1 an insertion, 2 a deletion of ``length`` bases at ``pos``); returns
    the edited sequence and its =/X/I/D CIGAR against ``seg``."""
    n = len(seg)
    reflen = np.where(kind == 0, 1, np.where(kind == 2, length, 0))
    ends = pos + reflen
    prev_end = np.concatenate([[0], ends[:-1]])
    op = np.choose(kind, [X, I, D])
    ops = np.empty((2 * len(pos) + 1, 2), np.int64)
    ops[0:-1:2, 0] = EQ
    ops[0:-1:2, 1] = pos - prev_end
    ops[1::2, 0] = op
    ops[1::2, 1] = np.where(kind == 0, 1, length)
    ops[-1] = (EQ, n - (ends[-1] if len(ends) else 0))
    ops = ops[ops[:, 1] > 0]

    out = seg.copy()
    sub = pos[kind == 0]
    out[sub] = BASES[(np.searchsorted(BASES, out[sub]) + rng.integers(1, 4, len(sub))) % 4]
    dels = kind == 2
    mark = np.zeros(n + 1, np.int32)
    np.add.at(mark, pos[dels], 1)
    np.add.at(mark, pos[dels] + length[dels], -1)
    keep = np.cumsum(mark[:-1]) == 0
    dropped_before = np.concatenate([[0], np.cumsum(~keep)])
    out = out[keep]
    ins = kind == 1
    at = pos[ins] - dropped_before[pos[ins]]
    lens = length[ins]
    bases = BASES[rng.integers(0, 4, int(lens.sum()))]
    out = np.insert(out, np.repeat(at, lens), bases)
    return out, ops


def draw_events(n: int, counts, lengths, kind_map, margin: int,
                rng: np.random.Generator):
    """Events of the given kinds and counts at distinct sorted positions in
    [margin, n - margin), each kind ``k`` becoming ``apply_events``' kind
    ``kind_map[k]``; any that touches an earlier one is dropped."""
    kinds = np.concatenate([np.full(c, k) for k, c in counts])
    span = max(n - 2 * margin, 1)
    k = min(len(kinds), span)
    pos = rng.choice(span, size=k, replace=False) + margin
    kinds = rng.permutation(kinds)[:k]
    length = lengths(kinds, rng)
    order = np.argsort(pos, kind="stable")
    pos, length = pos[order], length[order]
    kind = np.asarray(kind_map)[kinds[order]]
    ends = pos + np.where(kind == 0, 1, np.where(kind == 2, length, 0))
    reach = np.concatenate([[-1], np.maximum.accumulate(ends)[:-1]])
    ok = (pos > reach) & (ends <= n - margin)
    return pos[ok], kind[ok], length[ok]


# ---------------------------------------------------------- reference, contigs
def make_reference(config: dict, seed: int) -> list[tuple[str, np.ndarray]]:
    out = []
    for i, (name, length) in enumerate(config["chromosomes"]):
        rng = rng_for(seed, 1, i)
        out.append((name, BASES[rng.integers(0, 4, length, dtype=np.uint8)]))
    return out


def write_fasta(path: str, chroms) -> None:
    width = 60
    with open(path, "wb") as f:
        for name, seq in chroms:
            f.write(b">" + name.encode() + b"\n")
            full = len(seq) // width * width
            body = np.empty((full // width, width + 1), np.uint8)
            body[:, :width] = seq[:full].reshape(-1, width)
            body[:, width] = 10
            f.write(body.tobytes())
            if full < len(seq):
                f.write(seq[full:].tobytes() + b"\n")


def derive_haplotype(ref_seg: np.ndarray, div: dict, rng: np.random.Generator):
    """A haplotype of ``ref_seg`` at the configuration's rates of SNVs, small
    indels and SVs (half insertions, half deletions); its sequence and =/X
    CIGAR against ``ref_seg``."""
    n = len(ref_seg)
    n_ind = round(n * div["indel_per_kb"] / 1e3)
    n_sv = round(n * div["sv_per_mb"] / 1e6)
    # kinds: 0 SNV, 3/4 small insertion/deletion, 5/6 SV insertion/deletion
    counts = [(0, round(n * div["snv_per_kb"] / 1e3)),
              (3, n_ind - n_ind // 2), (4, n_ind // 2),
              (5, n_sv - n_sv // 2), (6, n_sv // 2)]

    def lengths(kinds, r):
        small = np.minimum(r.geometric(div["indel_len_p"], len(kinds)), 49)
        lo, hi = div["sv_len"]
        sv = np.exp(r.uniform(np.log(lo), np.log(hi), len(kinds))).astype(np.int64)
        return np.where(kinds == 0, 1, np.where(kinds >= 5, sv, small))

    events = draw_events(n, counts, lengths, [0, 0, 0, 1, 2, 1, 2], 1_000, rng)
    return apply_events(ref_seg, *events, rng)


def build_contigs(config: dict, ref: list, seed: int):
    """Each contig's sequence and alignment records (as encoded BAM records
    with their sort keys)."""
    chrom_ix = {name: i for i, (name, _) in enumerate(config["chromosomes"])}
    contigs, records = [], []
    for ci, spec in enumerate(config["contigs"]):
        tid = chrom_ix[spec["chrom"]]
        pieces, parts = [], []
        at = 0
        for pi, (start, end, strand) in enumerate(spec["parts"]):
            hap, core = derive_haplotype(ref[tid][1][start:end],
                                         config["divergence"],
                                         rng_for(seed, 2, ci, pi))
            pieces.append(hap if strand == "+" else revcomp(hap))
            parts.append((start, core, strand == "+", at, at + len(hap)))
            at += len(hap)
        seq = np.concatenate(pieces)
        rev = spec["reverse"]
        if rev:
            seq = revcomp(seq)
        total = len(seq)
        aligned = []
        for start, core, plus, a0, a1 in parts:
            c0, c1 = (total - a1, total - a0) if rev else (a0, a1)
            fwd = plus != rev
            left, right = (c0, total - c1) if fwd else (total - c1, c0)
            clip = lambda n: [[S, n]] if n else []  # noqa: E731
            cigar = np.concatenate([np.array(clip(left), np.int64).reshape(-1, 2),
                                    core,
                                    np.array(clip(right), np.int64).reshape(-1, 2)])
            sa = (f"{spec['chrom']},{start + 1},{'+' if fwd else '-'},"
                  + (f"{left}S" if left else "") + f"{c1 - c0}M"
                  + (f"{right}S" if right else "") + ",60,0;")
            aligned.append((tid, start, cigar, fwd, sa, c1 - c0))
        primary = max(range(len(aligned)), key=lambda k: aligned[k][5])
        for k, (tid_k, start, cigar, fwd, _sa, _n) in enumerate(aligned):
            flag = (0 if fwd else FREVERSE) | (0 if k == primary else FSUPPLEMENTARY)
            tags = [(b"NM", b"i", 0)]
            others = "".join(a[4] for j, a in enumerate(aligned) if j != k)
            if others:
                tags.append((b"SA", b"Z", others))
            raw = bamio.encode_record(spec["name"].encode(), flag, tid_k, start,
                                      60, cigar, seq if fwd else revcomp(seq),
                                      None, tags)
            records.append((tid_k, start, start + bamio.ref_len(cigar), raw))
        contigs.append((spec["name"], seq))
    return contigs, records


# ------------------------------------------------------------------ reads
def _read_events(n: int, q: float, model: dict, rng: np.random.Generator):
    """HiFi errors of a read of ``n`` bases at Phred ``q``: their number
    from the rate, their kinds from the model's shares, 1-2 base indels."""
    count = int(round(n * 10 ** (-q / 10)))
    sub, ins = model["error_shares"][:2]
    u = rng.random(count)
    kind = np.where(u < sub, 0, np.where(u < sub + ins, 3, 4))
    counts = [(k, int((kind == k).sum())) for k in (0, 3, 4)]

    def lengths(kinds, r):
        return np.where(kinds == 0, 1, 1 + (r.random(len(kinds)) < 0.1))

    return draw_events(n, counts, lengths, [0, 0, 0, 1, 2], 50, rng)


def _qual_lut(model: dict) -> np.ndarray:
    levels, shares = model["qual_bins"], model["qual_shares"]
    edges = np.round(np.cumsum(shares) * 256).astype(int)
    lut = np.empty(256, np.uint8)
    lo = 0
    for level, hi in zip(levels, edges):
        lut[lo:hi] = level
        lo = hi
    lut[lo:] = levels[-1]
    return lut


def _aligned_piece(contig: np.ndarray, pos: int, n: int, q: float,
                   model: dict, rng: np.random.Generator):
    """The read bases drawn from ``contig[pos:pos+n]`` with HiFi errors,
    in the contig's orientation, and their CIGAR."""
    tmpl = contig[pos:pos + n]
    return apply_events(tmpl, *_read_events(n, q, model, rng), rng)


def build_reads(config: dict, mix: dict, contigs: list, seed: int):
    """The mix's read records (sort key, end, raw) and the per-read facts
    the harness samples from."""
    model = config["reads"]
    rng = rng_for(seed, 3)
    n = mix["reads"]
    lengths = grid(n, np.log(mix["length_median"]), mix["length_sigma"],
                   *mix["length_clip"], rng).astype(np.int64)
    quals = np.clip(rng.permutation(
        model["q_mean"] + model["q_sd"] * np.array(
            [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])),
        *model["q_clip"])
    n_unmapped = round(n * model["unmapped_share"])
    n_split = round(n * model["split_share"])
    kinds = rng.permutation(np.repeat([0, 1, 2], [n - n_unmapped - n_split,
                                                  n_split, n_unmapped]))
    clen = np.array([len(s) for _, s in contigs], np.int64)
    cum = np.concatenate([[0], np.cumsum(clen)])
    lut = _qual_lut(model)
    zmws = rng.permutation(np.arange(1_000_000, 1_000_000 + 40 * n, 40))[:n]
    movie = model["movie"]

    def locate(length):
        """A uniform position in the contigs' bases at which ``length``
        bases fit."""
        while True:
            x = int(rng.integers(0, cum[-1]))
            ci = int(np.searchsorted(cum, x, side="right") - 1)
            if clen[ci] >= length:
                return ci, int(min(x - cum[ci], clen[ci] - length))

    def soft_clip():
        if rng.random() < model["soft_clip_share"]:
            return int(rng.integers(1, model["soft_clip_max"] + 1))
        return 0

    records, facts = [], []
    for r in range(n):
        length, q = int(lengths[r]), float(quals[r])
        name = f"{movie}/{int(zmws[r])}/ccs".encode()
        base_tags = [(b"rq", b"f", float(1 - 10 ** (-q / 10))),
                     (b"np", b"i", int(rng.integers(5, 31))),
                     (b"zm", b"i", int(zmws[r]))]
        if kinds[r] == 2:  # unassembled: passed through unmapped
            seq = BASES[rng.integers(0, 4, length, dtype=np.uint8)]
            raw = bamio.encode_record(name, FUNMAP, -1, -1, 0,
                                      np.zeros((0, 2), np.int64), seq,
                                      lut[rng.integers(0, 256, len(seq), dtype=np.uint8)],
                                      base_tags)
            records.append(((1 << 62, r), -1, -1, -1, raw))
            facts.append((name, length, 0, "unmapped", True))
            continue
        mapq = 60 if rng.random() < model["mapq60_share"] else int(rng.integers(1, 60))
        if kinds[r] == 0:
            lc, rc = soft_clip(), soft_clip()
            core_n = length - lc - rc
            ci, pos = locate(core_n)
            body, core = _aligned_piece(contigs[ci][1], pos, core_n, q, model, rng)
            seq = np.concatenate([BASES[rng.integers(0, 4, lc, dtype=np.uint8)], body,
                                  BASES[rng.integers(0, 4, rc, dtype=np.uint8)]])
            qual = lut[rng.integers(0, 256, len(seq), dtype=np.uint8)]
            cigar = np.concatenate([np.array([[S, lc]] if lc else [], np.int64).reshape(-1, 2),
                                    core,
                                    np.array([[S, rc]] if rc else [], np.int64).reshape(-1, 2)])
            flag = FREVERSE if rng.random() < 0.5 else 0
            nm = int(core[core[:, 0] != EQ, 1].sum())
            raw = bamio.encode_record(name, flag, ci, pos, mapq, cigar, seq, qual,
                                      [(b"NM", b"i", nm)] + base_tags)
            end = pos + bamio.ref_len(cigar)
            records.append(((ci, pos), ci, pos, end, raw))
            facts.append((name, len(seq), len(cigar), "plain", bool(flag)))
            continue
        # a split read: two pieces on two loci, each on either strand
        la = int(length * rng.uniform(0.3, 0.7))
        lb = length - la
        pieces = []
        for part_len in (la, lb):
            ci, pos = locate(part_len)
            body, core = _aligned_piece(contigs[ci][1], pos, part_len, q, model, rng)
            pieces.append([ci, pos, body, core, rng.random() < 0.5])
        so = [b if not rev else revcomp(b) for _, _, b, _, rev in pieces]
        read = np.concatenate(so)
        qual = lut[rng.integers(0, 256, len(read), dtype=np.uint8)]
        la, lb = len(so[0]), len(so[1])
        recs = []
        for k, (ci, pos, body, core, rev) in enumerate(pieces):
            other = lb if k == 0 else la
            clip = np.array([[S, other]], np.int64)
            first = (k == 0) != rev  # this piece leads in its stored orientation
            cigar = np.concatenate([core, clip] if first else [clip, core])
            recs.append((ci, pos, cigar, rev))
        prim = 0 if la >= lb else 1
        sa = [f"{contigs[ci][0]},{pos + 1},{'-' if rev else '+'},"
              f"{bamio.cigar_str(cig)},{mapq},0;" for ci, pos, cig, rev in recs]
        for k, (ci, pos, cigar, rev) in enumerate(recs):
            flag = (FREVERSE if rev else 0) | (0 if k == prim else FSUPPLEMENTARY)
            q_k = qual if not rev else qual[::-1].copy()
            raw = bamio.encode_record(name, flag, ci, pos, mapq, cigar,
                                      read if not rev else revcomp(read), q_k,
                                      [(b"NM", b"i", 0), (b"SA", b"Z", sa[1 - k])]
                                      + base_tags)
            records.append(((ci, pos), ci, pos, pos + bamio.ref_len(cigar), raw))
        facts.append((name, length, max(len(c) for _, _, c, _ in recs), "split",
                      recs[prim][3]))
    records.sort(key=lambda t: t[0])
    return records, facts


def bucket_of(n_bases: int, n_ops: int) -> int:
    for b, bucket in enumerate(BUCKETS):
        if n_ops <= bucket.max_ops and n_bases <= bucket.max_seq:
            return b
    return len(BUCKETS)


def _write_reads(path: str, header: str, refs, records) -> None:
    f = bamio.BamFile(path, header, refs)
    for _key, tid, pos, end, raw in records:
        f.add(raw, tid, pos, end, tid < 0)
    f.close()


def _key(*parts) -> str:
    return hashlib.sha256(json.dumps(parts, sort_keys=True).encode()).hexdigest()[:16]


def input_dirs(config: dict, mix: dict, seed: int, root: str) -> tuple[str, str]:
    """The directories of the genome and of the reads of (config, mix, seed)."""
    gdir = os.path.join(root, "genome-" + _key(*(config[k] for k in GENOME_KEYS)),
                        str(seed))
    mdir = os.path.join(gdir, "reads-" + _key(config["reads"],
                                              *(mix[k] for k in MIX_KEYS)))
    return gdir, mdir


def cached(config: dict, mix: dict, seed: int, root: str) -> dict | None:
    """The inputs' paths and counts, if they are built."""
    gdir, mdir = input_dirs(config, mix, seed, root)
    try:
        with open(os.path.join(mdir, "meta.json")) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return None
    for key in ("fasta", "contig_bam"):
        meta[key] = os.path.join(gdir, meta[key])
    meta["reads_bam"] = os.path.join(mdir, meta["reads_bam"])
    return meta


def build(config: dict, mix: dict, seed: int, root: str) -> dict:
    """The cell's inputs under ``root`` (built when absent); returns their
    paths and counts."""
    meta = cached(config, mix, seed, root)
    if meta is not None:
        return meta
    gdir, mdir = input_dirs(config, mix, seed, root)
    meta_path = os.path.join(mdir, "meta.json")
    shutil.rmtree(mdir, ignore_errors=True)
    os.makedirs(mdir, exist_ok=True)
    ref = make_reference(config, seed)
    contigs, contig_records = build_contigs(config, ref, seed)
    fasta = os.path.join(gdir, "ref.fa")
    contig_bam = os.path.join(gdir, "asm_to_ref.bam")
    done = os.path.join(gdir, "genome.done")
    if not os.path.exists(done):
        write_fasta(fasta, ref)
        hdr = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{len(s)}\n" for n, s in ref) + (
            "@PG\tID:minimap2\tPN:minimap2\tCL:minimap2 -ax asm5 --eqx\n")
        f = bamio.BamFile(contig_bam, hdr, [(n, len(s)) for n, s in ref])
        for tid, pos, end, raw in sorted(contig_records, key=lambda t: t[:2]):
            f.add(raw, tid, pos, end, False)
        f.close()
        open(done, "w").close()
    del ref, contig_records

    records, facts = build_reads(config, mix, contigs, seed)
    refs = [(name, len(seq)) for name, seq in contigs]
    hdr = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in refs) + (
        f"@RG\tID:{config['reads']['movie']}\tSM:{config['reads']['sample']}\tPL:PACBIO\n"
        "@PG\tID:pbmm2\tPN:pbmm2\tCL:pbmm2 align --preset HIFI --sort\n")
    reads_bam = os.path.join(mdir, "reads.bam")
    _write_reads(reads_bam, hdr, refs, records)

    shares = np.zeros(len(BUCKETS) + 1)
    for _name, n_bases, n_ops, kind, _rev in facts:
        if kind != "unmapped":
            shares[bucket_of(n_bases, n_ops)] += 1
    meta = {
        "fasta": "ref.fa", "contig_bam": "asm_to_ref.bam", "reads_bam": "reads.bam",
        "n_reads": len(facts),
        "n_primary": sum(f[3] != "unmapped" for f in facts),
        "n_unmapped": sum(f[3] == "unmapped" for f in facts),
        "n_split": sum(f[3] == "split" for f in facts),
        "n_records": len(records),
        "read_bases": int(sum(f[1] for f in facts)),
        "bucket_share": (shares / max(shares.sum(), 1)).round(6).tolist(),
        "reads": [[f[0].decode(), f[1], f[3], f[2]] for f in facts],
    }
    tmp = meta_path + ".part"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)
    return cached(config, mix, seed, root)


def _qname(raw: bytes) -> bytes:
    return raw[32:32 + raw[8] - 1]


if __name__ == "__main__":
    # ``python3 -m benchmark.gen.build`` with {"config", "mix", "seed", "root"}
    # as JSON on standard input: the harness builds a cell's inputs in a child
    # process, so that the process it measures starts from the same state
    # whether or not the inputs were cached.
    job = json.load(sys.stdin)
    build(job["config"], job["mix"], job["seed"], job["root"])
