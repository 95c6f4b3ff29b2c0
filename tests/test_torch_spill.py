"""Spill to host RAM: the port's store and count against kmc_tpu's, exactly.

A store that cannot take the next batch after compaction spills its
compacted rows to host RAM.  At finalize the spilled runs are replayed into
the store (replay route) or, when they outgrow it, merged on the host
(host route).  Counts of both routes, under a tight budget that re-merges
the runs, and with voluntary compactions, must write the same .kmc_pre /
.kmc_suf bytes as kmc_tpu; the spilled runs themselves must equal
kmc_tpu's row for row; and each of kmc_tpu's three count arithmetics (device
totals mod 2^32, re-merge clamped at 0xFFFFFFFF, host merge in u64 clamped
to counter_max) is held at counts near 2^32."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import kmc_tpu.memory as jax_memory  # noqa: E402
import kmc_tpu_torch.runner as torch_runner  # noqa: E402
from kmc_tpu.io.native import pack_codes_boundaries  # noqa: E402
from kmc_tpu.ops.store import DeviceKmerStore as JaxStore  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import Runner, Stage1Params, Stage2Params, count  # noqa: E402
from kmc_tpu_torch.io.readers import batch_len  # noqa: E402
from kmc_tpu_torch.ops import store as store_mod  # noqa: E402
from kmc_tpu_torch.ops.store import DeviceKmerStore  # noqa: E402

K, M, S = 27, 9, 1 << 10
KW = dict(k=K, sig_len=M, both_strands=True, n_bins=512)


def _same_db(a, b):
    for suf in (".kmc_pre", ".kmc_suf"):
        assert Path(str(a) + suf).read_bytes() == Path(str(b) + suf).read_bytes(), suf


def _torch_count(fq, out, **kw):
    """The port's count on the CPU; returns (runner, stage-2 results)."""
    p1 = Stage1Params(input_files=[fq], kmer_len=K)
    p2 = Stage2Params(output_file_name=str(out))
    for key, val in kw.items():
        setattr(p1 if hasattr(p1, key) else p2, key, val)
    r = Runner(device="cpu")
    r.run_stage1(p1)
    return r, r.run_stage2(p2)


# genome length -> the finalize route it takes with a 4096-row store and
# 1024-position batches: ~20 k unique k-mers outgrow the store (host merge),
# ~3.4 k fit it after a compaction but not beside the next batch (replay)
ROUTES = {"host": 20000, "replay": 3400}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("spill")
    return {route: write_fastq(d / f"{route}.fastq",
                               random_reads(400, 100, seed=3, n_prob=0.003,
                                            genome_len=glen))
            for route, glen in ROUTES.items()}


@pytest.mark.parametrize("route", sorted(ROUTES))
# k = 27 merges on two key columns; k = 31 keeps the bin in a column of
# its own and k = 33 has three lanes, so both merge on three
@pytest.mark.parametrize("k,m", [(27, 12), (27, 1), (31, 12), (33, 12)])
def test_spilling_count_byte_identical(reads, tmp_path, route, k, m):
    kw = dict(cutoff_min=1, batch_positions=S, device_store_rows=4096,
              max_ram_gb=m)
    jax_count([reads[route]], str(tmp_path / "jax"), k=k, **kw)
    r, res = _torch_count(reads[route], tmp_path / "torch", kmer_len=k, **kw)
    _same_db(tmp_path / "torch", tmp_path / "jax")
    assert r.spill_stats["n_spills"] >= 2
    assert r.spill_stats["finalize_route"] == route
    # and the same bytes as a store that never spills
    count([reads[route]], str(tmp_path / "big"), k=k, device="cpu",
          cutoff_min=1, batch_positions=S, device_store_rows=1 << 16)
    _same_db(tmp_path / "torch", tmp_path / "big")
    assert res.n_total_kmers > 0


def _cut_ranges(monkeypatch, ranges):
    """ranges "many": make the host route's merge cut key ranges of at most
    2000 rows; "one": leave it one range (the CPU sets no limit).  Returns
    the list that gets each merge's count of non-empty ranges."""
    if ranges == "many":
        monkeypatch.setattr(store_mod, "_merge_rows", lambda *a, **kw: 2000)
    cuts, real = [], store_mod._key_ranges

    def key_ranges(*a, **kw):
        got = real(*a, **kw)
        cuts.append(sum(int((end - first).sum()) > 0 for first, end in got))
        return got

    monkeypatch.setattr(store_mod, "_key_ranges", key_ranges)
    return cuts


@pytest.fixture(scope="module")
def jax_host_dbs(reads, tmp_path_factory):
    """kmc_tpu's databases of the host-route input, by k."""
    d = tmp_path_factory.mktemp("jax_host")
    out = {}

    def db(k):
        if k not in out:
            out[k] = d / f"k{k}"
            jax_count([reads["host"]], str(out[k]), k=k, cutoff_min=1,
                      batch_positions=S, device_store_rows=4096)
        return out[k]
    return db


@pytest.mark.parametrize("ranges", ["one", "many"])
@pytest.mark.parametrize("k", [27, 31, 33])
def test_host_route_many_ranges_byte_identical(reads, jax_host_dbs, tmp_path,
                                               monkeypatch, k, ranges):
    """The host route completes each merged key range on the store's device:
    in one range or cut into many, it writes kmc_tpu's bytes, and its
    kmc.host_completer counts one range for each range the merge cut."""
    cuts = _cut_ranges(monkeypatch, ranges)
    r, res = _torch_count(reads["host"], tmp_path / "torch", kmer_len=k,
                          cutoff_min=1, batch_positions=S,
                          device_store_rows=4096)
    _same_db(tmp_path / "torch", jax_host_dbs(k))
    assert r.spill_stats["finalize_route"] == "host"
    assert r.spill_stats["n_spills"] >= 2 and r.spill_stats["n_remerges"] == 0
    assert cuts[-1] >= 3 if ranges == "many" else cuts[-1] == 1
    assert r._count.counter("ranges", "kmc.host_completer") == cuts[-1]
    assert res.n_unique_kmers > 0


def _tight_plans(monkeypatch, budget):
    """Both packages' -m plans with spill_budget_bytes set to `budget`."""
    real_j, real_t = jax_memory.plan_memory, torch_runner.plan_memory

    def wrap(real):
        def plan(*a, **kw):
            return dataclasses.replace(real(*a, **kw),
                                       spill_budget_bytes=budget)
        return plan

    monkeypatch.setattr(jax_memory, "plan_memory", wrap(real_j))
    monkeypatch.setattr(torch_runner, "plan_memory", wrap(real_t))


def test_budget_remerge_count_byte_identical(reads, tmp_path, monkeypatch):
    # seven runs of ~3.2 k rows x 12 B (~39 KB each) and ~15 k unique
    # k-mers (~180 KB): the sixth spill crosses the budget and re-merges
    _tight_plans(monkeypatch, 210_000)
    kw = dict(cutoff_min=1, batch_positions=S, device_store_rows=4096)
    jax_count([reads["host"]], str(tmp_path / "jax"), k=K, **kw)
    r, _ = _torch_count(reads["host"], tmp_path / "torch", **kw)
    _same_db(tmp_path / "torch", tmp_path / "jax")
    assert r.spill_stats["n_remerges"] >= 1


def test_budget_overflow_reaches_the_caller(reads, tmp_path, monkeypatch):
    """The spill runs on the ingest worker thread; its MemoryError must
    still end the count, naming -m."""
    _tight_plans(monkeypatch, 1024)
    with pytest.raises(MemoryError, match="-m"):
        _torch_count(reads["host"], tmp_path / "torch", cutoff_min=1,
                     batch_positions=S, device_store_rows=4096)
    assert not (tmp_path / "torch.kmc_pre").exists()


def test_autocompact_rows_byte_identical(reads, tmp_path, monkeypatch):
    kw = dict(cutoff_min=1, batch_positions=S, device_store_rows=1 << 14)
    r0, _ = _torch_count(reads["replay"], tmp_path / "plain", **kw)
    monkeypatch.setenv("KMC_TPU_AUTOCOMPACT_ROWS", str(3 * S))
    jax_count([reads["replay"]], str(tmp_path / "jax"), k=K, **kw)
    r, _ = _torch_count(reads["replay"], tmp_path / "torch", **kw)
    _same_db(tmp_path / "torch", tmp_path / "jax")
    _same_db(tmp_path / "torch", tmp_path / "plain")
    assert r.n_compactions > r0.n_compactions


# -- the store, call for call --

def _ingest_codes(rng, genome):
    L = batch_len(S, K)
    starts = rng.integers(0, len(genome) - 100, L // 101 + 1)
    return np.concatenate([np.append(genome[s:s + 100], 4)
                           for s in starts])[:L]


def _feed_both(stores, codes):
    buf, ts = pack_codes_boundaries(codes)
    for st in stores:
        st.ingest_boundaries(buf, ts, s=S)


def _random_run(store, seed, n=3000, counts=None):
    rng = np.random.default_rng(seed)
    cols = tuple(rng.integers(0, 1 << 30, n, dtype=np.uint32)
                 for _ in range(store.n_cols))
    return cols, (np.ones(n, np.uint32) if counts is None else counts)


def _assert_runs_equal(got, want):
    assert len(got) == len(want)
    for (gc, gn), (wc, wn) in zip(got, want):
        assert len(gc) == len(wc)
        for a, b in zip(gc, wc):
            assert a.dtype == np.uint32
            assert np.array_equal(a, np.asarray(b))
        assert gn.dtype == np.uint32
        assert np.array_equal(gn, np.asarray(wn))


def test_spilled_runs_equal_kmc_tpu():
    jst = JaxStore(1 << 13, initial_rows=1 << 13, **KW)
    tst = DeviceKmerStore(1 << 13, device="cpu", **KW)
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    for _ in range(3):
        _feed_both((jst, tst), _ingest_codes(rng, genome))
    jst.spill()
    tst.spill()
    run = _random_run(tst, 1)
    for st in (jst, tst):
        st.append(*run)
    _feed_both((jst, tst), _ingest_codes(rng, genome))
    jst.spill()
    tst.spill()
    _assert_runs_equal(tst.spilled, jst.spilled)
    assert tst.n_spills == 2
    assert tst.total_occurrences() == jst.total_occurrences()


def test_overflowing_ingest_spills_like_kmc_tpu():
    """Batches of distinct k-mers fill a 2*s-row store: each further batch
    compacts, finds no room and spills, in the same places as kmc_tpu."""
    jst = JaxStore(2 * S, initial_rows=2 * S, **KW)
    tst = DeviceKmerStore(2 * S, device="cpu", **KW)
    rng = np.random.default_rng(0)
    for _ in range(7):
        _feed_both((jst, tst), rng.integers(0, 4, batch_len(S, K))
                   .astype(np.uint8))
    assert tst.n_spills == len(tst.spilled) == len(jst.spilled) >= 2
    _assert_runs_equal(tst.spilled, jst.spilled)
    assert tst.n_used == int(jst.n_used)


def test_spill_budget_remerges_and_bounds():
    """Crossing the spill budget re-merges runs in place, as kmc_tpu does;
    an impossible budget raises MemoryError naming the flag."""
    def both(budget):
        return (JaxStore(1 << 13, spill_budget_bytes=budget, **KW),
                DeviceKmerStore(1 << 13, spill_budget_bytes=budget,
                                device="cpu", **KW))

    def fill(stores, seed):
        for st in stores:
            st.append(*_random_run(st, seed, n=4096))
            st.spill()

    generous = both(1 << 30)  # two spills coexist un-merged
    fill(generous, 1)
    fill(generous, 2)
    assert len(generous[1].spilled) == 2 and generous[1].n_remerges == 0
    _assert_runs_equal(generous[1].spilled, generous[0].spilled)

    tight = both(60_000)  # the second spill re-merges
    fill(tight, 1)
    fill(tight, 1)
    assert len(tight[1].spilled) == 1 and tight[1].n_remerges == 1
    _assert_runs_equal(tight[1].spilled, tight[0].spilled)
    cols, counts = tight[1].spilled[0]
    assert np.all(np.diff(cols[0].astype(np.int64)) >= 0)
    assert set(np.unique(counts)) <= {0, 2}

    for st in both(1024):
        st.append(*_random_run(st, 1, n=4096))
        with pytest.raises(MemoryError, match="-m"):
            st.spill()


def _finalize(st, **kw):
    # kmc_tpu's device completer takes its limits as int32 scalars
    args = dict(cutoff_min=1, cutoff_max=2**31 - 1, counter_max=2**31 - 1,
                lut_prefix_len=4, counter_size=4)
    args.update(kw)
    return st.finalize_records(**args)


def _assert_same_records(got, ref):
    assert got[2] == tuple(int(x) for x in ref[2])
    assert np.array_equal(got[0], ref[0])
    assert np.array_equal(got[1], np.asarray(ref[1]).astype(np.uint64))


def _big_counts_run(store, counts):
    """Rows of two live keys (valid bins) that repeat with the counts."""
    n = len(counts)
    base = np.array([7 << (2 * store.r0 - 4), 9 << (2 * store.r0 - 4)],
                    np.uint32)
    col0 = base[np.arange(n) % 2]
    cols = (col0,) + tuple(np.full(n, 0x12345678 + j, np.uint32)
                           for j in range(store.n_cols - 1))
    return cols, np.asarray(counts, np.uint32)


def test_device_totals_wrap_mod_2_32():
    """A device group total wraps mod 2^32; a group that wraps to 0 is
    dropped (key A: 2^32 - 1 + 1 -> gone; key B: 2^32 - 1 + 5 -> 4)."""
    stores = (JaxStore(1 << 10, **KW),
              DeviceKmerStore(1 << 10, device="cpu", **KW))
    run = _big_counts_run(stores[1], [0xFFFFFFFF, 0xFFFFFFFF, 1, 5])
    for st in stores:
        st.append(*run)
        st.compact()
    jst, tst = stores
    n = tst.n_used
    assert n == int(jst.n_used)
    for a, b in zip(tst.key_cols, jst.key_cols):
        assert np.array_equal(a[:n].numpy().view(np.uint32),
                              np.asarray(b)[:n])
    assert np.array_equal(tst.counts[:n].numpy().view(np.uint32),
                          np.asarray(jst.counts)[:n])
    got, ref = _finalize(tst), _finalize(jst)
    assert got[2][0] == 1  # only key B is left
    _assert_same_records(got, ref)
    assert tst.finalize_route == "device"


def test_remerge_clamps_at_u32_max():
    stores = (JaxStore(1 << 10, spill_budget_bytes=64, **KW),
              DeviceKmerStore(1 << 10, spill_budget_bytes=64, device="cpu",
                              **KW))
    run = _big_counts_run(stores[1], [0xFFFFFFF0, 3])
    for st in stores:
        for _ in range(2):  # the second spill crosses the budget
            st.append(*run)
            st.spill()
    jst, tst = stores
    assert tst.n_remerges == 1
    _assert_runs_equal(tst.spilled, jst.spilled)
    assert 0xFFFFFFFF in tst.spilled[0][1] and 6 in tst.spilled[0][1]


@pytest.mark.parametrize("counter_max", [2**32 - 1, 1000])
def test_host_merge_sums_in_u64(counter_max):
    """Runs that outgrow the store finalize through the host merge: totals
    above 2^32 stay exact there and clamp to counter_max."""
    stores = (JaxStore(64, initial_rows=64, **KW),
              DeviceKmerStore(64, device="cpu", **KW))
    # one row of key A and one of key B in each of three runs: their
    # totals, 3 x (2^32 - 16) and 3 x (2^32 - 1), meet only in the host merge
    big = _big_counts_run(stores[1], [0xFFFFFFF0, 0xFFFFFFFF])
    for st in stores:
        for seed in range(3):  # 60 distinct rows a run: each spills
            st.append(*_random_run(st, seed, n=60))
            st.append(*big)
        st.spill()
    kw = dict(counter_max=counter_max, cutoff_max=1 << 40)
    got = _finalize(tst := stores[1], **kw)
    ref = _finalize(stores[0], **kw)
    assert tst.finalize_route == "host"
    _assert_same_records(got, ref)
