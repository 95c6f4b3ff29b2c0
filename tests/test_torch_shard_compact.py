"""ShardedKmerStore.compact issues every shard's grouping sort before it
finishes any shard's compaction.  On CPU shards the pass must leave every
shard exactly as each shard's own compact (its two halves back to back)
does, and as a plain NumPy model of kmc_tpu's compaction: live rows
merged by key with totals mod 2^32, a group whose total wraps to 0 kept
as a dead row of count 0, and one dead row after the groups whenever the
store held a dead row."""
import numpy as np
import pytest
import torch

from kmc_tpu_torch.parallel.multihost import ShardedKmerStore

K = 27
CAP = 1 << 12
ALL_ONES = np.uint32(0xFFFFFFFF)


def _store(D):
    return ShardedKmerStore(["cpu"] * D, CAP, k=K)


def _keys(rng, n_cols, n, pool=400):
    """n rows drawn from a pool of live keys (u32, high bits included)."""
    keys = rng.integers(16, 0xFFFFFFFF, size=(n_cols, pool), dtype=np.uint32)
    return keys[:, rng.integers(0, pool, size=n)]


def _ingested(shard, rng, n=3000):
    """Rows as the ingest leaves them: no counts column, a row weighs 1,
    and windows that held a sentinel are dead (all-ones) rows."""
    cols = _keys(rng, shard.n_cols, n)
    cols[:, rng.random(n) < 0.1] = ALL_ONES
    for dst, src in zip(shard.key_cols, cols):
        dst[:n] = torch.from_numpy(src.view(np.int32))
    shard.n_used = n


def _counted(shard, rng, n=1200):
    """Rows appended with counts: some 0 (written dead), and three keys
    outside the pool whose totals wrap mod 2^32: to 0 (2^31 + 2^31 and
    2^32 - 1 + 1) and to 4 (2^32 - 1 + 5)."""
    cols = _keys(rng, shard.n_cols, n)
    counts = rng.integers(0, 6, size=n, dtype=np.uint32)
    for j, (key, c) in enumerate([(1, 1 << 31), (1, 1 << 31),
                                  (2, 0xFFFFFFFF), (2, 1),
                                  (3, 0xFFFFFFFF), (3, 5)]):
        cols[:, j] = key
        counts[j] = c
    shard.append(tuple(cols), counts)


def _rows(shard):
    """(key columns as uint32 [n_cols, n_used], counts as uint32 or None)."""
    n = shard.n_used
    cols = np.stack([c[:n].numpy().view(np.uint32) for c in shard.key_cols])
    counts = None if shard.counts is None else \
        shard.counts[:n].numpy().view(np.uint32)
    return cols, counts


def _plain_compact(cols, counts, capacity):
    """kmc_tpu's compaction of rows (uint32 [n_cols, n]) in NumPy."""
    live = cols[0] != ALL_ONES
    if counts is not None:
        live &= counts != 0
    weights = (np.ones(cols.shape[1], np.uint64) if counts is None
               else counts.astype(np.uint64))[live]
    keys, inv = np.unique(cols[:, live].T, axis=0, return_inverse=True)
    totals = np.zeros(len(keys), np.uint64)
    np.add.at(totals, inv.reshape(-1), weights)
    totals = (totals & 0xFFFFFFFF).astype(np.uint32)
    keys = keys.T.copy()
    keys[:, totals == 0] = ALL_ONES
    if live.sum() < capacity:
        keys = np.concatenate([keys, np.full((len(keys), 1), ALL_ONES,
                                             np.uint32)], axis=1)
        totals = np.append(totals, np.uint32(0))
    return keys, totals


def _fill(store, case, seed):
    """Each shard's rows from its own generator."""
    for d, shard in enumerate(store.shards):
        rng = np.random.default_rng([seed, d])
        if case == "counted":
            _counted(shard, rng)
        else:
            _ingested(shard, rng)


@pytest.mark.parametrize("case", ["ingested", "counted", "held_dead"])
@pytest.mark.parametrize("D", [2, 4])
def test_store_wide_compaction_equals_each_shard_alone(D, case):
    at_once, alone = _store(D), _store(D)
    seed = 2**40 + 17 * D
    for store in (at_once, alone):
        _fill(store, case, seed)
    expect = [_plain_compact(*_rows(sh), sh.capacity)
              for sh in at_once.shards]
    passes = 2 if case == "held_dead" else 1
    for p in range(passes):
        if p:  # the compacted stores, which hold a dead row, take more rows
            for store in (at_once, alone):
                for d, shard in enumerate(store.shards):
                    _counted(shard, np.random.default_rng([seed, d, p]))
            expect = [_plain_compact(*_rows(sh), sh.capacity)
                      for sh in at_once.shards]
        at_once.compact()
        for shard in alone.shards:
            shard.compact()
        for a, b, (keys, totals) in zip(at_once.shards, alone.shards,
                                        expect):
            assert a.n_used == b.n_used == len(totals)
            assert a.n_compactions == b.n_compactions == p + 1
            for ca, cb in zip(a.key_cols, b.key_cols):
                assert torch.equal(ca, cb)
            assert torch.equal(a.counts, b.counts)
            cols, counts = _rows(a)
            assert np.array_equal(cols, keys)
            assert np.array_equal(counts, totals)
            assert (cols[0] == ALL_ONES).sum() >= 1  # the dead rows' group
        assert at_once.n_compactions == p + 1
        assert at_once._rows_per_device == max(sh.n_used
                                               for sh in alone.shards)
    if case != "ingested":  # groups whose totals wrapped to 0 stay dead
        cols, counts = _rows(at_once.shards[0])
        assert ((cols[0] == ALL_ONES) & (counts == 0)).sum() >= 3
