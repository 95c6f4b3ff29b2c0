"""The generator: the same seed gives the same reads and FASTQ, another
seed others; the reads follow the traffic mix."""
import numpy as np
import torch

from kmcbench.reads import (BLOCK_READS, Sample, fastq_block, genome,
                            read_blocks, write_fastq)

SEED = 2**33 + 12345  # seeds may pass 32 bits


def sample(**kw):
    base = dict(genome_bp=1 << 14, coverage=20, read_len=150,
                substitution_rate=0.0025, reverse_share=0.5)
    return Sample(**{**base, **kw})


def all_reads(s, seed):
    return torch.cat([c for _, c in read_blocks(s, seed, "cpu")])


def test_same_seed_same_reads_and_fastq(tmp_path):
    s = sample()
    assert torch.equal(all_reads(s, SEED), all_reads(s, SEED))
    a, b = tmp_path / "a.fq", tmp_path / "b.fq"
    assert write_fastq(a, s, SEED, "cpu") == write_fastq(b, s, SEED, "cpu")
    assert a.read_bytes() == b.read_bytes()


def test_other_seed_other_reads():
    s = sample()
    assert not torch.equal(all_reads(s, SEED), all_reads(s, SEED + 1))
    assert not torch.equal(genome(s, SEED, "cpu"), genome(s, SEED + 1, "cpu"))


def test_blocks_are_made_alone():
    """A whole block depends on (seed, block index) only: the first block
    is the same whatever the number of reads after it."""
    s = sample(genome_bp=1 << 16, coverage=1500)
    assert s.n_reads > BLOCK_READS
    longer = sample(genome_bp=1 << 16, coverage=1600)
    a = dict(read_blocks(s, SEED, "cpu"))
    b = dict(read_blocks(longer, SEED, "cpu"))
    assert torch.equal(a[0], b[0])
    assert not torch.equal(a[0][:1000], a[BLOCK_READS][:1000])


def test_reads_follow_the_mix():
    """Substitution rate and strand share as the mix states, every read a
    window of the genome (or its reverse complement) up to them."""
    s = sample(genome_bp=1 << 16, coverage=40, substitution_rate=0.01)
    ref = genome(s, SEED, "cpu")
    reads = all_reads(s, SEED).long()
    assert reads.shape == (s.n_reads, 150)
    windows = ref.long().unfold(0, 150, 1)
    fwd_hits, diffs = 0, 0
    for r in reads[:400]:
        for cand, is_fwd in ((r, True), ((3 - r).flip(0), False)):
            d = (windows != cand).sum(1)
            best = int(d.min())
            if best <= 12:
                fwd_hits += is_fwd
                diffs += best
                break
        else:
            raise AssertionError("a read matches no window of the genome")
    assert 0.4 < fwd_hits / 400 < 0.6
    assert 0.007 < diffs / (400 * 150) < 0.013


def test_repeat_copies_are_placed():
    """Each repeat family's unit lies in the genome as many times as the
    configuration gives: its 31-mers occur that often, the rest once (a
    few more where the copies' flanking bases agree by chance)."""
    s = sample(genome_bp=1 << 16, repeats=((500, 7), (300, 3)))
    ref = genome(s, SEED, "cpu").long()
    words = torch.zeros(ref.numel() - 30, dtype=torch.int64)
    for j in range(31):
        words = (words << 2) | ref[j:j + words.numel()]
    _, counts = torch.unique(words, return_counts=True)
    n7, n3 = int((counts == 7).sum()), int((counts == 3).sum())
    assert 500 - 30 <= n7 <= 500 - 30 + 4
    assert 300 - 30 <= n3 <= 300 - 30 + 4
    assert int(counts.max()) == 7
    assert int((counts > 1).sum()) - n7 - n3 <= 16
    assert torch.equal(ref, genome(s, SEED, "cpu").long())
    plain = sample(genome_bp=1 << 16)
    assert not torch.equal(ref, genome(plain, SEED, "cpu").long())


def test_fastq_records():
    codes = torch.tensor([[0, 1, 2, 3] * 2], dtype=torch.uint8)
    rec = bytes(fastq_block(41, codes).numpy())
    assert rec == b"@0000000041\nACGTACGT\n+\nIIIIIIII\n"
    s = sample()
    record = 1 + 10 + 1 + 150 + 3 + 150 + 1  # @id, bases, +, quality
    assert record * s.n_reads == sum(
        fastq_block(first, c).numel() for first, c in read_blocks(s, SEED,
                                                                  "cpu"))


def test_kmer_total():
    s = sample()
    assert s.n_kmers(27) == s.n_reads * 124
    assert np.isclose(s.n_reads, (1 << 14) * 20 / 150, atol=1)
