"""The sharded spill and the merge of spilled runs on the store's device.

kmc_tpu_torch.distributed_count with shards too small for the unique set
spills every shard's rows to host RAM, as kmc_tpu's distributed_count does,
and must write the same .kmc_pre / .kmc_suf bytes with the same stats
(spills and compactions included), and the single-device count's bytes.
The -m budget re-merges the spilled runs, or raises MemoryError naming -m,
where kmc_tpu's does.  The merge itself (ops/store.py merge_runs, run here
through the sort's plain version on CPU tensors) is held against kmc_tpu's
host re-merge and host merge, cut into many key ranges by a small byte
limit, with totals near 2^32, dead rows, empty runs and a single run."""
import dataclasses
import sys
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py sets up the 8-device CPU mesh)
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import kmc_tpu.memory as jax_memory  # noqa: E402
import kmc_tpu_torch.memory as torch_memory  # noqa: E402
from kmc_tpu.ops.store import DeviceKmerStore as JaxStore  # noqa: E402
from kmc_tpu.parallel.distributed import make_mesh as jax_make_mesh  # noqa: E402
from kmc_tpu.parallel.multihost import (  # noqa: E402
    distributed_count as jax_distributed_count)
from kmc_tpu_torch import count, distributed_count, make_mesh  # noqa: E402
from kmc_tpu_torch.ops.store import (DeviceKmerStore, _merge_row_bytes,  # noqa: E402
                                     merge_runs_to_host, remerge_runs)

STATS = ("n_unique", "n_total", "n_below", "n_above", "n_super_kmers",
         "n_reads", "n_compactions", "n_spills")
SUFFIXES = (".kmc_pre", ".kmc_suf")
S = 1 << 9  # batch positions of the sharded counts


def _same_db(a, b):
    for suf in SUFFIXES:
        assert Path(str(a) + suf).read_bytes() == \
            Path(str(b) + suf).read_bytes(), suf


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    # ~5 k unique k-mers against shards of 2 k rows: every shard compacts,
    # then spills
    path = tmp_path_factory.mktemp("sharded_spill") / "reads.fastq"
    return write_fastq(path, random_reads(600, 120, seed=7, n_prob=0.004,
                                          genome_len=5000))


def _both(reads_file, tmp_path, D, **kw):
    """(kmc_tpu's stats, the port's stats); the DBs in tmp_path/{jax,torch}."""
    kw = dict(dict(cutoff_min=1, batch_positions=S,
                   capacity_rows_per_device=1 << 11), **kw)
    sj = jax_distributed_count([reads_file], str(tmp_path / "jax"),
                               mesh=jax_make_mesh(D), **kw)
    st = distributed_count([reads_file], str(tmp_path / "torch"),
                           devices=make_mesh(D, device="cpu"), **kw)
    return sj, st


@pytest.mark.parametrize("D", [2, 4])
# k = 25 fuses the bin into key column 0; k = 31 keeps it in a column of its
# own, so the merges order rows by (bin, lanes) over three key columns
@pytest.mark.parametrize("k", [25, 31])
def test_sharded_spill_matches_kmc_tpu(reads_file, tmp_path, D, k):
    sj, st = _both(reads_file, tmp_path, D, k=k)
    _same_db(tmp_path / "torch", tmp_path / "jax")
    assert {key: st[key] for key in STATS} == {key: sj[key] for key in STATS}
    assert st["n_spills"] >= 2 and st["n_compactions"] > st["n_spills"]
    count([reads_file], str(tmp_path / "single"), device="cpu", k=k,
          cutoff_min=1, batch_positions=S)
    _same_db(tmp_path / "torch", tmp_path / "single")


def _tight_plans(monkeypatch, budget):
    """Both packages' -m plans with spill_budget_bytes set to `budget`."""
    def wrap(real):
        def plan(*a, **kw):
            return dataclasses.replace(real(*a, **kw),
                                       spill_budget_bytes=budget)
        return plan

    for mod in (jax_memory, torch_memory):
        monkeypatch.setattr(mod, "plan_memory", wrap(mod.plan_memory))


def test_budget_remerges_like_kmc_tpu(reads_file, tmp_path, monkeypatch):
    # spills of ~4 k rows x 20 B against ~5 k unique k-mers: past 150 kB
    # the spills re-merge, about every other spill
    _tight_plans(monkeypatch, 150_000)
    sj, st = _both(reads_file, tmp_path, 4, k=25)
    _same_db(tmp_path / "torch", tmp_path / "jax")
    assert {key: st[key] for key in STATS} == {key: sj[key] for key in STATS}
    assert st["n_remerges"] >= 2


def test_budget_overflow_raises_like_kmc_tpu(reads_file, tmp_path,
                                             monkeypatch):
    _tight_plans(monkeypatch, 1024)
    with pytest.raises(MemoryError, match="-m"):
        jax_distributed_count([reads_file], str(tmp_path / "jax"), k=25,
                              mesh=jax_make_mesh(4), cutoff_min=1,
                              batch_positions=S,
                              capacity_rows_per_device=1 << 11)
    with pytest.raises(MemoryError, match="-m"):
        distributed_count([reads_file], str(tmp_path / "torch"), k=25,
                          devices=["cpu"] * 4, cutoff_min=1,
                          batch_positions=S, capacity_rows_per_device=1 << 11)
    assert not (tmp_path / "torch.kmc_pre").exists()


def test_sharded_store_spill_budget_like_kmc_tpu():
    """tests/test_memory.py's test_sharded_spill_budget on both packages'
    stores: the same batches, spilled, then a budget armed just above one
    spill; the next spill re-merges.  The spilled rows and their byte
    figure must be kmc_tpu's."""
    from kmc_tpu.io.native import pack_codes
    from kmc_tpu.ops.extract import batch_len
    from kmc_tpu.parallel.multihost import ShardedKmerStore as JaxSharded
    from kmc_tpu_torch.io.native import pack_codes_fused
    from kmc_tpu_torch.parallel.multihost import ShardedKmerStore

    D, s, k = 2, 1 << 10, 27
    jst = JaxSharded(jax_make_mesh(D), 1 << 12, k=k, sig_len=9,
                     spill_budget_bytes=1 << 30)
    tst = ShardedKmerStore(["cpu"] * D, 1 << 12, k=k, sig_len=9,
                           spill_budget_bytes=1 << 30)
    L = batch_len(s, k)
    for it in range(2):
        # identical batches each round: the re-merge collapses duplicates
        rng = np.random.default_rng(7)
        codes = [rng.integers(0, 4, L).astype(np.uint8) for _ in range(D)]
        pm = [pack_codes(c) for c in codes]
        jst.ingest(np.stack([p for p, _ in pm]), np.stack([m for _, m in pm]),
                   s=s)
        tst.ingest_group([("m", pack_codes_fused(c)) for c in codes], s=s)
        jst.spill()
        tst.spill()
        assert tst._spilled_bytes() == jst._spilled_bytes()
        if it == 0:
            # arm the budget just above one spill: the next one crosses it
            for st in (jst, tst):
                st.spill_budget_bytes = st._spilled_bytes() + 100
    assert len(tst.spilled) == len(jst.spilled) == 1
    assert tst.n_spills == jst.n_spills == 2 and tst.n_remerges == 1
    assert tst._spilled_bytes() == jst._spilled_bytes() <= 1 << 30
    (cols, counts), = tst.spilled[0]
    bins, words, jcounts = jst.spilled[0]
    r0 = tst.r0
    assert np.array_equal(cols[0] >> np.uint32(2 * r0), bins)
    assert np.array_equal(cols[0] & np.uint32((1 << 2 * r0) - 1),
                          words[:, 0])
    assert np.array_equal(cols[1], words[:, 1])
    assert np.array_equal(counts, jcounts)
    assert set(np.unique(counts)) >= {2}  # duplicates summed


# -- the merge alone --

KW = dict(k=27, sig_len=9, both_strands=True, n_bins=512)


def _run(rng, n, n_keys=2, *, col0_values=200, big=False, dead_mid=0,
         dead_tail=0):
    """A sorted run as a store spills it: up to n rows of valid bins (k =
    27's fused column 0 below bin 513) with keys from a small set, so runs
    share keys, one row a key, counts 1..9 (or near 2^32 with big); then
    `dead_mid` zero-total groups written dead among them and `dead_tail`
    dead rows after them."""
    stride = (513 << 22) // col0_values
    col0 = rng.integers(0, col0_values, n).astype(np.uint32) * np.uint32(stride)
    cols = [col0] + [rng.integers(0, 8, n).astype(np.uint32)
                     for _ in range(n_keys - 1)]
    order = np.lexsort(tuple(cols[::-1]))
    cols = [c[order] for c in cols]
    new = np.zeros(n, bool)
    new[:1] = True
    for c in cols:
        new[1:] |= c[1:] != c[:-1]
    cols = [c[new] for c in cols]
    n = len(cols[0])
    counts = (rng.integers(0xFFFFFFF0, 0xFFFFFFFF, n, dtype=np.uint64,
                           endpoint=True) if big
              else rng.integers(1, 10, n)).astype(np.uint32)
    if dead_mid:
        idx = rng.choice(n, dead_mid, replace=False)
        for c in cols:
            c[idx] = 0xFFFFFFFF
        counts[idx] = 0
    cols = [np.concatenate([c, np.full(dead_tail, 0xFFFFFFFF, np.uint32)])
            for c in cols]
    counts = np.concatenate([counts, np.zeros(dead_tail, np.uint32)])
    return tuple(cols), counts


RUN_SETS = {
    "runs": lambda rng: [_run(rng, 3000, dead_tail=1),
                         _run(rng, 2000, dead_mid=5, dead_tail=1),
                         _run(rng, 2500)],
    "near_2_32": lambda rng: [_run(rng, 1500, big=True, dead_tail=1)
                              for _ in range(3)],
    "empty_runs": lambda rng: [_run(rng, 0), _run(rng, 2000),
                               (tuple(np.zeros(0, np.uint32)
                                      for _ in range(2)),
                                np.zeros(0, np.uint32))],
    "single_run": lambda rng: [_run(rng, 3000, dead_mid=3, dead_tail=1)],
}
SMALL = _merge_row_bytes(2) * 97  # 97 rows a key range


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", list(RUN_SETS))
def test_remerge_matches_kmc_tpu(name):
    """The re-merge in many key ranges == in one == kmc_tpu's host
    re-merge (totals clamped at 0xFFFFFFFF, one trailing dead row)."""
    runs = RUN_SETS[name](np.random.default_rng(3))
    jst = JaxStore(1 << 10, **KW)
    jst.spilled = list(runs)
    jst._remerge_spilled()
    (jcols, jcounts), = jst.spilled
    one = remerge_runs(runs, 2, "cpu")
    many = remerge_runs(runs, 2, "cpu", max_bytes=SMALL)
    for cols, counts in (one, many):
        _equal(cols, jcols)
        _equal([counts], [jcounts])
    if name == "near_2_32":
        assert (jcounts == 0xFFFFFFFF).sum() > 0


@pytest.mark.parametrize("name", list(RUN_SETS))
def test_host_merge_matches_kmc_tpu(name):
    """The host route's merge (u64 totals) == kmc_tpu's _host_merge, through
    the store; and in many key ranges == in one."""
    runs = RUN_SETS[name](np.random.default_rng(4))
    jst = JaxStore(1 << 10, **KW)
    tst = DeviceKmerStore(1 << 10, device="cpu", **KW)
    jst.spilled = list(runs)
    tst.spilled = list(runs)
    _equal(tst._host_merge(), jst._host_merge())
    one = merge_runs_to_host(runs, 2, "cpu")
    many = merge_runs_to_host(runs, 2, "cpu", max_bytes=SMALL)
    _equal(many[0], one[0])
    _equal([many[1]], [one[1]])
    assert many[2] == one[2]
    if name == "near_2_32":
        assert one[1].max() > 0xFFFFFFFF  # exact u64 sums


def test_merge_ranges_split_groups_never():
    """Three key columns (the bin in a column of its own) in ranges of a
    few rows: each group is whole in one range, so the merged run equals
    the unlimited one; one column-0 value past the limit raises."""
    rng = np.random.default_rng(5)
    runs = [_run(rng, 1200, n_keys=3, col0_values=5000, dead_tail=1)
            for _ in range(4)]
    one = merge_runs_to_host(runs, 3, "cpu")
    many = merge_runs_to_host(runs, 3, "cpu", max_bytes=_merge_row_bytes(3) * 9)
    _equal(many[0], one[0])
    _equal([many[1]], [one[1]])
    same = [(tuple(np.zeros(50, np.uint32) for _ in range(2)),
             np.ones(50, np.uint32))]
    with pytest.raises(MemoryError, match="column-0"):
        merge_runs_to_host(same, 2, "cpu", max_bytes=_merge_row_bytes(2) * 20)
