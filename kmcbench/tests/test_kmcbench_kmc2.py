"""The frozen KMC2 decoder on databases the port's CPU path writes:
records, LUT and header against the port's own reader and against the
plain reference."""
import numpy as np
import pytest
import torch

from kmcbench import compare, kmc2, reference
from kmcbench.reads import Sample, write_fastq

SEED = 2**35 + 99


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    from kmc_tpu_torch import count

    d = tmp_path_factory.mktemp("db")
    s = Sample(genome_bp=1 << 14, coverage=12, read_len=150,
               substitution_rate=0.005, reverse_share=0.5)
    fq = d / "reads.fastq"
    write_fastq(fq, s, SEED, "cpu")
    _, r2 = count([str(fq)], str(d / "db"), k=27, device="cpu",
                  cutoff_min=2, counter_max=255, batch_positions=1 << 12)
    return s, d / "db", r2


def test_decode_matches_the_ports_reader(counted):
    from kmc_tpu_torch.formats.kmc_db import read_db

    _, prefix, _ = counted
    db = kmc2.read(prefix)
    kmers, counters, lut_index = kmc2.decode(db, "cpu")
    theirs = read_db(str(prefix))
    assert db.n_records == theirs.n_records == db.n_stored > 0
    assert (db.k, db.lut_prefix_len, db.sig_len, db.counter_size) == (
        theirs.info.kmer_len, theirs.info.lut_prefix_len,
        theirs.info.signature_len, theirs.info.counter_size)
    kb = theirs.kmers_bytes().astype(np.int64)
    want = np.zeros(len(kb), dtype=np.int64)
    for j in range(kb.shape[1]):
        want = (want << 8) | kb[:, j]
    assert np.array_equal(kmers.numpy(), want)
    assert np.array_equal(counters.numpy(), theirs.counters())
    per_bin = 1 << (2 * db.lut_prefix_len)
    assert np.array_equal((lut_index // per_bin).numpy(), theirs.bin_ids())


def test_database_passes_against_the_reference(counted):
    s, prefix, r2 = counted
    ref = reference.count(s, SEED, 27, "cpu")
    knobs = dict(kmer_len=27, cutoff_min=2, cutoff_max=10**9,
                 counter_max=255, canonical_kmers=True)
    stats = dict(n_total=r2.n_total_kmers, n_unique=r2.n_unique_kmers,
                 n_below=r2.n_below_cutoff_min, n_above=r2.n_above_cutoff_max)
    numbers = compare.judge_db(prefix, ref, knobs, [stats], "cpu")
    assert numbers == dict(jobs_wrong=0, records_wrong=0,
                           records_misplaced=0, header_wrong=0)


def _rewrite(prefix, dst, edit_suf=None, edit_pre=None):
    pre = bytearray(open(str(prefix) + ".kmc_pre", "rb").read())
    suf = bytearray(open(str(prefix) + ".kmc_suf", "rb").read())
    if edit_suf:
        edit_suf(suf)
    if edit_pre:
        edit_pre(pre)
    open(str(dst) + ".kmc_pre", "wb").write(pre)
    open(str(dst) + ".kmc_suf", "wb").write(suf)


@pytest.mark.parametrize("fault,number", [
    ("counter", "records_wrong"),
    ("swap", "records_misplaced"),
    ("lut", "records_wrong"),
    ("header", "header_wrong"),
    ("truncated", "records_wrong"),
])
def test_a_damaged_database_fails(counted, tmp_path, fault, number):
    s, prefix, r2 = counted
    db = kmc2.read(prefix)
    rb = db.record_bytes
    n_lut = len(db.luts)

    def counter(suf):
        suf[4 + 5 * rb + rb - 1] ^= 1

    def swap(suf):  # two records of one bin trade places
        a, b = 4 + 7 * rb, 4 + 8 * rb
        suf[a:a + rb], suf[b:b + rb] = suf[b:b + rb], suf[a:a + rb]

    def lut(pre):  # the first non-empty LUT slot starts one record late
        i = int(np.flatnonzero(np.diff(db.luts))[0]) + 1
        off = 4 + 8 * i
        v = int.from_bytes(pre[off:off + 8], "little") + 1
        pre[off:off + 8] = v.to_bytes(8, "little")

    def header(pre):  # cutoff_min in the header
        hstart = len(pre) - 8 - int.from_bytes(pre[-8:-4], "little")
        pre[hstart + 20] ^= 1

    def truncated(suf):
        del suf[4:4 + rb]

    edits = {"counter": (counter, None), "swap": (swap, None),
             "lut": (None, lut), "header": (None, header),
             "truncated": (truncated, None)}
    assert n_lut > 1
    _rewrite(prefix, tmp_path / "bad", *edits[fault])
    ref = reference.count(s, SEED, 27, "cpu")
    knobs = dict(kmer_len=27, cutoff_min=2, cutoff_max=10**9,
                 counter_max=255, canonical_kmers=True)
    numbers = compare.judge_db(tmp_path / "bad", ref, knobs, [], "cpu")
    assert numbers[number] > 0
    assert not compare.passed(numbers)
