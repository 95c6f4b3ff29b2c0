"""The plain reference against a dict count, KMC's signature rule
against a per-value version, and the control failing the comparison."""
import itertools

import torch

from kmcbench import compare, reference
from kmcbench.reads import Sample, read_blocks

SEED = 2**40 + 3


def to_int(bases):
    v = 0
    for b in bases:
        v = v * 4 + b
    return v


def test_count_matches_a_dict():
    s = Sample(genome_bp=1 << 12, coverage=8, read_len=150,
               substitution_rate=0.01, reverse_share=0.5)
    k = 21
    want = {}
    for _, codes in read_blocks(s, SEED, "cpu"):
        for read in codes.tolist():
            for i in range(len(read) - k + 1):
                fwd = read[i:i + k]
                rc = [3 - b for b in reversed(fwd)]
                key = min(to_int(fwd), to_int(rc))
                want[key] = want.get(key, 0) + 1
    got = reference.count(s, SEED, k, "cpu")
    assert got.keys.tolist() == sorted(want)
    assert got.counts.tolist() == [want[x] for x in sorted(want)]
    st = got.stats(2, 10)
    assert st == dict(n_total=sum(want.values()), n_unique=len(want),
                      n_below=sum(v < 2 for v in want.values()),
                      n_above=sum(v > 10 for v in want.values()))
    keys, counters = got.kept(2, 10, 5)
    kept = [x for x in sorted(want) if 2 <= want[x] <= 10]
    assert keys.tolist() == kept
    assert counters.tolist() == [min(want[x], 5) for x in kept]


def allowed(bases):
    """KMC's CMmer::is_allowed on a base list (mmer.h), written out: no
    TT* or TGT at the end, no AA after the first base, no ACA start."""
    s = "".join("ACGT"[b] for b in bases)
    if s.endswith("TGT") or s[-3:-1] == "TT":
        return False
    if "AA" in s[1:]:
        return False
    return not s.startswith("ACA")


def test_norm_table_is_kmcs_rule():
    m = 5
    table = reference.norm_table(m, "cpu").tolist()
    for bases in itertools.product(range(4), repeat=m):
        rc = [3 - b for b in reversed(bases)]
        vals = [to_int(x) for x in (bases, rc) if allowed(x)]
        assert table[to_int(bases)] == min(vals, default=4 ** m)


def test_signature_is_strand_free_minimum():
    g = torch.Generator().manual_seed(5)
    k, m = 27, 9
    kmers = torch.randint(0, 1 << 54, (300,), generator=g)
    table = reference.norm_table(m, "cpu")
    sig = reference.signatures(kmers, k, m)
    for x, got in zip(kmers.tolist(), sig.tolist()):
        bases = [(x >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        best = min(int(table[to_int(bases[j:j + m])])
                   for j in range(k - m + 1))
        assert got == best
        rc = to_int([3 - b for b in reversed(bases)])
        assert int(reference.signatures(torch.tensor([rc]), k, m)) == got


def test_control_fails_the_comparison():
    """The control (k-mers keyed by a 32-bit hash) at about a million
    distinct k-mers: colliding k-mers share a counter, so records and the
    stage-2 counts differ from the reference."""
    from kmcbench.control import control_numbers
    from kmcbench.harness import load_cell

    s = Sample(genome_bp=1 << 20, coverage=3, read_len=150,
               substitution_rate=0.0025, reverse_share=0.5)
    knobs = load_cell("isolate_k27.fastq100x").knobs
    numbers = control_numbers(s, SEED, knobs, "cpu")
    assert numbers["n_unique"] > 800_000
    assert numbers["records_wrong"] > 0 and numbers["jobs_wrong"] == 1
    assert not compare.passed(numbers)
    ref = reference.count(s, SEED, 27, "cpu")
    ctl = reference.control_count(ref)
    assert 0 < ref.keys.numel() - ctl.keys.numel() < 1000
    assert int(ctl.counts.sum()) == int(ref.counts.sum())
    # the reference in its own place passes
    ref_kept = ref.kept(2, 10**9, 255)
    assert compare.records_wrong(*ref_kept, *ref.kept(2, 10**9, 255)) == 0


def test_records_wrong_counts_each_fault():
    ref_keys = torch.tensor([1, 5, 9, 12])
    ref_counters = torch.tensor([3, 3, 4, 2])
    rw = compare.records_wrong
    assert rw(ref_keys, ref_counters, ref_keys.flip(0),
              ref_counters.flip(0)) == 0
    assert rw(ref_keys, ref_counters, ref_keys[:3], ref_counters[:3]) == 1
    assert rw(ref_keys, ref_counters, torch.tensor([1, 5, 9, 12, 13]),
              torch.tensor([3, 3, 4, 2, 2])) == 1
    assert rw(ref_keys, ref_counters, torch.tensor([1, 5, 9, 12, 12]),
              torch.tensor([3, 3, 4, 2, 2])) == 1
    assert rw(ref_keys, ref_counters, ref_keys,
              torch.tensor([3, 3, 5, 2])) == 1
