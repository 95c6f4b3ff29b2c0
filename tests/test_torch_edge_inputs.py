"""Pathological inputs through the port (the twins of
tests/test_edge_inputs.py): each count on the CPU must match kmc_tpu's
oracle, as the reference's tests hold kmc_tpu to it, or fail loudly."""
import numpy as np
import pytest

from kmc_tpu import oracle
from kmc_tpu_torch import InputFileType, count
from kmc_tpu_torch.formats import dump_db_file

from util import random_reads, write_fastq


def _count(inputs, out, k, **kw):
    return count(inputs, out, k=k, device="cpu", **kw)


def _expect(reads, k, **kw):
    counts = oracle.count_kmers(reads, k)
    records, stats = oracle.apply_cutoffs(counts, kw.get("cutoff_min", 1),
                                          10**9, 255)
    return oracle.dump_text(records), stats


def test_empty_input_file(tmp_path):
    inp = tmp_path / "empty.fastq"
    inp.write_text("")
    out = str(tmp_path / "out")
    _, res2 = _count([str(inp)], out, 21, cutoff_min=1,
                     batch_positions=1 << 12)
    assert res2.n_total_kmers == 0
    assert res2.n_unique_kmers == 0
    assert dump_db_file(out) == ""


def test_reads_shorter_than_k(tmp_path):
    reads = ["ACGT", "ACGTACGTAC", "A"]
    inp = write_fastq(tmp_path / "in.fastq", reads)
    out = str(tmp_path / "out")
    res1, res2 = _count([inp], out, 21, cutoff_min=1,
                        batch_positions=1 << 12)
    assert res2.n_total_kmers == 0
    assert res1.n_sequences == 3


def test_empty_read_records(tmp_path):
    inp = tmp_path / "in.fastq"
    inp.write_text("@r0\nACGTACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIIIIIII\n"
                   "@empty\n\n+\n\n"
                   "@r1\nTTTTGGGGCCCCAAAATTTTGGGG\n+\nIIIIIIIIIIIIIIIIIIIIIIII\n")
    out = str(tmp_path / "out")
    reads = ["ACGTACGTACGTACGTACGTACGT", "", "TTTTGGGGCCCCAAAATTTTGGGG"]
    res1, _ = _count([str(inp)], out, 15, cutoff_min=1,
                     batch_positions=1 << 12)
    expect, _ = _expect([r for r in reads if r], 15)
    assert dump_db_file(out) == expect
    assert res1.n_sequences == 3


def test_missing_trailing_newline(tmp_path):
    reads = random_reads(10, 60, seed=71)
    inp = tmp_path / "in.fastq"
    body = "".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                   for i, r in enumerate(reads))
    inp.write_bytes(body[:-1].encode())  # drop the final newline
    out = str(tmp_path / "out")
    _count([str(inp)], out, 21, cutoff_min=1, batch_positions=1 << 12)
    assert dump_db_file(out) == _expect(reads, 21)[0]


def test_crlf_line_endings(tmp_path):
    """CRLF FASTQ: the '\\r' maps to the sentinel, breaking k-mers at line
    ends as the reference's code table does for unknown symbols."""
    reads = random_reads(10, 60, seed=72)
    inp = tmp_path / "in.fastq"
    body = "".join(f"@r{i}\r\n{r}\r\n+\r\n{'I' * len(r)}\r\n"
                   for i, r in enumerate(reads))
    inp.write_bytes(body.encode())
    out = str(tmp_path / "out")
    _count([str(inp)], out, 21, cutoff_min=1, batch_positions=1 << 12)
    assert dump_db_file(out) == _expect(reads, 21)[0]


def test_lowercase_bases(tmp_path):
    reads_lc = ["acgtacgtacgtacgtacgtacgt", "ACGTacgtACGTacgtACGTacgt"]
    inp = write_fastq(tmp_path / "in.fastq", reads_lc)
    out = str(tmp_path / "out")
    _count([inp], out, 15, cutoff_min=1, batch_positions=1 << 12)
    assert dump_db_file(out) == _expect([r.upper() for r in reads_lc], 15)[0]


def test_all_n_reads(tmp_path):
    reads = ["N" * 50, "N" * 50, "ACGTACGTACGTACGTACGTN" + "N" * 20]
    inp = write_fastq(tmp_path / "in.fastq", reads)
    out = str(tmp_path / "out")
    _, res2 = _count([inp], out, 15, cutoff_min=1, batch_positions=1 << 12)
    expect, stats = _expect(reads, 15)
    assert dump_db_file(out) == expect
    assert res2.n_unique_kmers == stats["n_unique"]


def test_fasta_without_final_newline_and_empty_records(tmp_path):
    inp = tmp_path / "in.fasta"
    inp.write_bytes(b">a\nACGTACGTACGTACGTACGT\n>empty\n>b\nTTTTGGGGCCCCAAAA")
    out = str(tmp_path / "out")
    _count([str(inp)], out, 15, cutoff_min=1, batch_positions=1 << 12,
           input_file_type=InputFileType.FASTA)
    expect, _ = _expect(["ACGTACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA"], 15)
    assert dump_db_file(out) == expect


def test_fuzz_random_degenerate_fastq(tmp_path):
    """Randomized record soup: mixed lengths, Ns, empty reads, short
    reads: every k-mer the oracle counts must appear identically."""
    rng = np.random.default_rng(99)
    reads = []
    for _ in range(120):
        n = int(rng.integers(0, 90))
        reads.append("".join(rng.choice(list("ACGTN"), n,
                                        p=[0.24, 0.24, 0.24, 0.24, 0.04])))
    inp = write_fastq(tmp_path / "in.fastq", reads)
    out = str(tmp_path / "out")
    _, res2 = _count([inp], out, 17, cutoff_min=1, batch_positions=512)
    expect, stats = _expect(reads, 17)
    assert dump_db_file(out) == expect
    assert res2.n_total_kmers == stats["n_total"]


def test_malformed_bam_raises(tmp_path):
    """A corrupt BAM block length must raise, not hang or eat memory, on
    the native parser and on its plain version."""
    import gzip
    import struct

    body = (b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 0)
            + struct.pack("<i", 1 << 30))  # absurd block_size
    bam = tmp_path / "bad.bam"
    bam.write_bytes(gzip.compress(body))
    from kmc_tpu_torch.io.bam import _bam_code_chunks_py, bam_code_chunks

    with pytest.raises(ValueError):
        list(bam_code_chunks(str(bam)))
    with pytest.raises(ValueError):
        list(_bam_code_chunks_py(str(bam)))
