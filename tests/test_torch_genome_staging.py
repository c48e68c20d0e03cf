"""The resident genome built in place: ``genome_layout``, ``pad_ranges`` and
``chunk_plan`` against ``build_global_ref``; the CPU build's bytes; the
card's staged path on the CPU with its CUDA calls stood in for; the
stats of a native-feed call (one build span, then one upload span, and the
staging counters).  On the card, the staged upload through pinned buffers
at chunk sizes smaller than a chromosome, past byte 2^31, and on a mesh
that lists the card twice:

    python -m pytest --noconftest tests/test_torch_genome_staging.py -m cuda

(this file imports no JAX; ``--noconftest`` skips the suite's JAX set-up).
"""

import os
import threading

import numpy as np
import pytest
import torch

from portello_tpu_torch.kernels import resident as tres
from portello_tpu_torch.pipeline import native_feed as nf

SB = tres.SB
CPU = torch.device("cpu")

LAYOUTS = {
    "one": [1000],
    "multiples_of_64": [64, 128, 6400],
    "odd": [1, 63, 65, 127, 1001],
    "small_25": [int(n) for n in np.random.default_rng(25).integers(1, 3000, 25)],
    "length_1": [300, 1, 300],
}


def _chroms(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n) for n in lengths]


def _flat_ref(chroms):
    words, goff = tres.build_global_ref(chroms)
    return words.view(np.uint8).reshape(-1), goff


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_and_cpu_build_equal_build_global_ref(name):
    lengths = LAYOUTS[name]
    chroms = _chroms(lengths)
    want, want_goff = _flat_ref(chroms)
    goff, total = tres.genome_layout(lengths)
    assert goff.dtype == np.int64 and goff.tolist() == want_goff.tolist()
    assert total == len(want)
    goff, tables = tres.alloc_genome(lengths, [CPU, CPU])
    assert list(tables) == [CPU]
    assert tres.upload_genome(chroms, goff, tables) == (0, 0)
    got = tables[CPU]
    assert got.dtype == torch.uint8 and got.numel() == total
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [7, 64, 1000])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_chunk_plan_covers_each_chromosome_byte_once(name, chunk):
    lengths = LAYOUTS[name]
    goff, total = tres.genome_layout(lengths)
    writes = np.zeros(total, np.int64)
    for c, src, dst, n in tres.chunk_plan(lengths, goff, chunk):
        assert 0 < n <= chunk and dst == goff[c] + src
        assert 0 <= src and src + n <= lengths[c]
        writes[dst:dst + n] += 1
    pads = np.zeros(total, np.int64)
    for a, b in tres.pad_ranges(lengths, goff, total):
        pads[a:b] += 1
    in_chrom = np.zeros(total, bool)
    for n, off in zip(lengths, goff):
        in_chrom[off:off + n] = True
    assert np.array_equal(writes, in_chrom.astype(np.int64))
    # the pads and the chromosomes tile the table, once each
    assert np.array_equal(writes + pads, np.ones(total, np.int64))


class _StandInCard:
    """The CUDA calls of the staged path, stood in for on the CPU: a table
    keyed by a card's device but held in host memory, streams and events
    that complete at once, and pinned buffers that are plain ones, each
    kept to be read after the upload.  ``fail_at`` makes that event record
    raise."""

    def __init__(self, monkeypatch, fail_at=None):
        self.buffers, self.records, self.fail_at = [], 0, fail_at
        lock = threading.Lock()
        card = self
        empty = torch.empty

        class Stream:
            def __init__(self, device=None):
                pass

            def wait_stream(self, other):
                pass

        class Event:
            def record(self, stream=None):
                with lock:
                    card.records += 1
                    n = card.records
                if n == card.fail_at:
                    raise RuntimeError("stand-in copy failed")

            def synchronize(self):
                pass

        def stage_empty(*args, pin_memory=False, **kwargs):
            t = empty(*args, **kwargs)
            if pin_memory:
                card.buffers.append(t)
            return t

        monkeypatch.setattr(torch.cuda, "Stream", Stream)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "stream", lambda s: _Nothing())
        monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
        monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
        monkeypatch.setattr(torch, "empty", stage_empty)


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


CARD = torch.device("cuda", 0)


@pytest.mark.parametrize("chunk", [7, 64, 1000])
@pytest.mark.parametrize("threads", [1, tres.STAGE_THREADS])
def test_staged_path_with_a_stand_in_card(monkeypatch, threads, chunk):
    """The card's path on the CPU: every chromosome byte lands where
    ``build_global_ref`` puts it, on one thread as on the chosen count, at
    any chunk size; each thread stages through its own buffer, and every
    buffer is zeroed before the upload returns."""
    lengths = LAYOUTS["small_25"] + [1, 64, 5003]
    chroms = _chroms(lengths, seed=chunk)
    want, _ = _flat_ref(chroms)
    goff, tables = tres.alloc_genome(lengths, [CPU])
    table = tables[CPU]
    table[np.concatenate([np.arange(off, off + n) for n, off in zip(lengths, goff)])] = 0
    card = _StandInCard(monkeypatch)
    monkeypatch.setattr(tres, "STAGE_BYTES", chunk)
    monkeypatch.setattr(tres, "STAGE_THREADS", threads)
    got = tres.upload_genome(chroms, goff, {CARD: table})
    plan = tres.chunk_plan(lengths, goff, chunk)
    assert got == (sum(lengths), len(plan)) and card.records == len(plan)
    assert np.array_equal(table.numpy(), want)
    assert len(card.buffers) == threads
    assert all(b.numel() == chunk and not b.any() for b in card.buffers)


def test_staged_path_raises_what_a_thread_met(monkeypatch):
    lengths = [5000, 3000]
    chroms = _chroms(lengths)
    goff, tables = tres.alloc_genome(lengths, [CPU])
    card = _StandInCard(monkeypatch, fail_at=3)
    monkeypatch.setattr(tres, "STAGE_BYTES", 100)
    monkeypatch.setattr(tres, "STAGE_THREADS", 2)
    with pytest.raises(RuntimeError, match="stand-in copy failed"):
        tres.upload_genome(chroms, goff, {CARD: tables[CPU]})
    assert card.records > 3  # the other thread went on to its end
    assert all(not b.any() for b in card.buffers)


def _scenario_args(d, tag, device):
    return ["--assembly-to-ref", os.path.join(d, "asm_to_ref.bam"),
            "--read-to-assembly", os.path.join(d, "read_to_asm.bam"),
            "--remapped-read-output", os.path.join(d, f"remapped_{tag}.bam"),
            "--unassembled-read-output", os.path.join(d, f"un_{tag}.bam"),
            "--ref", os.path.join(d, "ref.fa"),
            "--device", device, "--feed", "native", "--batch-size", "16"]


def _genome_spans(stats):
    return [(name, t0, t1) for name, _, _, t0, t1 in stats["spans"]
            if name.startswith("startup.genome_")]


def _reference_lengths(d):
    """The scenario's chromosome lengths in the order of the contig BAM's
    header, as the CLI passes the chromosomes."""
    from portello_tpu_torch.io.fasta import get_genome_ref_from_fasta
    from portello_tpu_torch.utils.chrom_list import ChromList

    chroms = get_genome_ref_from_fasta(os.path.join(d, "ref.fa")).chroms
    order = ChromList.from_bam_filename(os.path.join(d, "asm_to_ref.bam"))
    return [len(chroms[c.label]) for c in order.data]


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    from portello_tpu_torch.testutil.simulate import make_scenario

    if nf.get_lib() is None:
        pytest.skip(f"ptscan unavailable: {nf.build_error()}")
    d = str(tmp_path_factory.mktemp("genome_staging"))
    make_scenario(d, rng=np.random.default_rng(41), n_reads_per_contig=10,
                  read_len=300)
    return d


def test_each_call_builds_then_uploads_its_genome_once(scenario, monkeypatch):
    """Each call's stats hold one ``startup.genome_build`` span and after
    it one ``startup.genome_upload`` span, which the benchmark's
    ``genome.*`` metrics read, and count the table's bytes; on the CPU
    nothing goes through pinned staging."""
    from portello_tpu_torch.main import main as port_main

    monkeypatch.delenv("PTPU_RESIDENT", raising=False)
    monkeypatch.delenv("PTPU_HOST_SHIFT", raising=False)
    lengths = _reference_lengths(scenario)
    calls = []
    for k in range(2):
        port_main(_scenario_args(scenario, f"cpu{k}", "cpu"))
        calls.append(nf._last_stats)
    assert calls[0] is not calls[1]
    for stats in calls:
        (b, b0, b1), (u, u0, u1) = _genome_spans(stats)
        assert (b, u) == ("startup.genome_build", "startup.genome_upload")
        assert b0 <= b1 <= u0 <= u1
        assert stats["genome_bytes"] == tres.genome_layout(lengths)[1]
        assert stats["genome_staged_bytes"] == 0 and stats["genome_chunks"] == 0


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [1, tres.STAGE_THREADS])
def test_staged_upload_equals_build_global_ref(cuda_device, monkeypatch, threads):
    lengths = LAYOUTS["small_25"] + [100_003, 64, 1]
    chroms = _chroms(lengths, seed=threads)
    want, _ = _flat_ref(chroms)
    goff, tables = tres.alloc_genome(lengths, [cuda_device])
    chunk = 999  # smaller than most chromosomes, and not a multiple of 64
    monkeypatch.setattr(tres, "STAGE_BYTES", chunk)
    monkeypatch.setattr(tres, "STAGE_THREADS", threads)
    staged = tres.upload_genome(chroms, goff, tables)
    assert staged == (sum(lengths), len(tres.chunk_plan(lengths, goff, chunk)))
    assert np.array_equal(tables[cuda_device].cpu().numpy(), want)


@pytest.mark.cuda
def test_staged_upload_past_2g(cuda_device, monkeypatch):
    """A last chromosome that starts past byte 2^31: its first and last
    bytes, the bytes either side of each chunk seam, and the pads around
    it are where ``build_global_ref`` puts them."""
    chunk = 1 << 20
    lengths = [(1 << 31) + 5, 3 * chunk + 17]
    chroms = [np.full(lengths[0], ord("A"), np.uint8), _chroms(lengths[1:], seed=7)[0]]
    goff, tables = tres.alloc_genome(lengths, [cuda_device])
    assert goff[1] > 1 << 31
    monkeypatch.setattr(tres, "STAGE_BYTES", chunk)
    tres.upload_genome(chroms, goff, tables)
    g = tables[cuda_device]
    last, n = int(goff[1]), lengths[1]
    at = [0, n - 1] + [k * chunk + d for k in (1, 2, 3) for d in (-1, 0)]
    idx = torch.tensor([last + p for p in at], device=cuda_device)
    assert g[idx].cpu().tolist() == [int(chroms[1][p]) for p in at]
    assert bytes(g[last - 59:last].cpu().numpy()) == b"N" * 59
    assert bytes(g[last + n:].cpu().numpy()) == b"N" * (g.numel() - last - n)
    assert bytes(g[:SB].cpu().numpy()) == b"N" * SB
    assert int(g[SB]) == ord("A") and int(g[SB + lengths[0] - 1]) == ord("A")


@pytest.mark.cuda
def test_mesh_of_one_card_twice_shares_one_copy(cuda_device, monkeypatch):
    lengths = [5000, 77, 64]
    chroms = _chroms(lengths, seed=3)
    goff, tables = tres.alloc_genome(lengths, [cuda_device, cuda_device])
    assert list(tables) == [cuda_device]
    monkeypatch.setattr(tres, "STAGE_BYTES", 1024)
    assert tres.upload_genome(chroms, goff, tables) == (sum(lengths), 7)
    assert np.array_equal(tables[cuda_device].cpu().numpy(), _flat_ref(chroms)[0])


@pytest.mark.cuda
def test_call_on_the_card_counts_its_staging(scenario, cuda_device, monkeypatch):
    from portello_tpu_torch.main import main as port_main

    monkeypatch.delenv("PTPU_RESIDENT", raising=False)
    monkeypatch.delenv("PTPU_HOST_SHIFT", raising=False)
    lengths = _reference_lengths(scenario)
    port_main(_scenario_args(scenario, "cuda", "cuda"))
    stats = nf._last_stats
    goff, total = tres.genome_layout(lengths)
    assert stats["genome_bytes"] == total
    assert stats["genome_staged_bytes"] == sum(lengths)
    assert stats["genome_chunks"] == len(tres.chunk_plan(lengths, goff, tres.STAGE_BYTES))
    assert [name for name, _, _ in _genome_spans(stats)] == [
        "startup.genome_build", "startup.genome_upload"]
