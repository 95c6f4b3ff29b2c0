"""The port's DeviceKmerStore against kmc_tpu's, fed the same batches.

A store of 2*s rows fed repeated batches must compact (first with unit
counts, then counted) and still finalize to the same record bytes, LUT and
stats as kmc_tpu's store; the same holds for a kmc_tpu store state carried
across with store_from_numpy_state."""
import numpy as np
import pytest

from kmc_tpu.io.native import pack_codes_boundaries, pack_codes_fused
from kmc_tpu.ops.store import DeviceKmerStore as JaxStore
from kmc_tpu_torch.formats.kmc_db import pick_lut_prefix_len
from kmc_tpu_torch.io.readers import batch_len
from kmc_tpu_torch.ops.store import DeviceKmerStore, store_from_numpy_state

S = 4096
M = 9


def _batches(k, seed):
    """Two read-like batches from one small genome (k-mers repeat across
    them) and one sentinel-dense batch that needs the packed+mask feed."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 1500).astype(np.uint8)
    L = batch_len(S, k)
    out = []
    for b in range(2):
        starts = rng.integers(0, len(genome) - 100, L // 101 + 1)
        reads = np.concatenate([np.append(genome[s:s + 100], 4)
                                for s in starts])[:L]
        out.append(("b", reads))
    dense = rng.integers(0, 4, L).astype(np.uint8)
    dense[rng.random(L) < 0.2] = 4
    out.append(("m", dense))
    return out


def _feed(store, kind, codes):
    if kind == "b":
        buf, ts = pack_codes_boundaries(codes)
        assert buf is not None
        store.ingest_boundaries(buf, ts, s=S)
    else:
        store.ingest_fused(pack_codes_fused(codes), s=S)


def _finalize(store, cutoff_min, lpl):
    return store.finalize_records(
        cutoff_min=cutoff_min, cutoff_max=10**9, counter_max=255,
        lut_prefix_len=lpl, counter_size=1)


def _assert_same(got, ref):
    rec_t, lut_t, st_t = got
    rec_j, lut_j, st_j = ref
    assert st_t == st_j
    assert np.array_equal(rec_t, rec_j)
    assert np.array_equal(lut_t, lut_j.astype(np.uint64))


@pytest.mark.parametrize("k,both,cutoff_min", [(27, True, 1), (33, True, 2),
                                               (20, False, 1)])
def test_store_compacts_and_finalizes_like_kmc_tpu(k, both, cutoff_min):
    kw = dict(k=k, sig_len=M, both_strands=both, n_bins=512)
    jst = JaxStore(2 * S, **kw)
    tst = DeviceKmerStore(2 * S, device="cpu", **kw)
    batches = _batches(k, seed=k)
    order = [0, 1, 0, 2, 1, 0, 1]
    for i in order:
        _feed(jst, *batches[i])
        _feed(tst, *batches[i])
    assert tst.n_compactions >= 2 and tst.counts is not None
    assert tst.total_occurrences() == jst.total_occurrences()
    assert tst.total_super_kmers() == jst.total_super_kmers()
    assert np.array_equal(tst.host_sig_map(), jst.host_sig_map())
    lpl = pick_lut_prefix_len(k, tst.n_used_bins, 4 * 100)
    _assert_same(_finalize(tst, cutoff_min, lpl), _finalize(jst, cutoff_min, lpl))


@pytest.mark.parametrize("n_ingests", [2, 5])
def test_state_carried_across_finalizes_the_same(n_ingests):
    k = 27
    kw = dict(k=k, sig_len=M, both_strands=True, n_bins=512)
    jst = JaxStore(2 * S, **kw)
    batches = _batches(k, seed=11)
    for i in [0, 1, 2, 0, 1][:n_ingests]:
        _feed(jst, *batches[i])
    counts = None if jst.counts is None else np.asarray(jst.counts)
    tst = store_from_numpy_state(
        [np.asarray(c) for c in jst.key_cols], counts, int(jst.n_used),
        np.asarray(jst.occ_acc), np.asarray(jst.skm_acc),
        np.asarray(jst.prev_sig), device="cpu", **kw)
    assert (counts is not None) == (n_ingests > 2)
    assert tst.total_occurrences() == jst.total_occurrences()
    assert tst.total_super_kmers() == jst.total_super_kmers()
    # carried state keeps ingesting like the original
    _feed(jst, *batches[1])
    _feed(tst, *batches[1])
    assert tst.total_super_kmers() == jst.total_super_kmers()
    lpl = pick_lut_prefix_len(k, tst.n_used_bins, 4 * 100)
    _assert_same(_finalize(tst, 1, lpl), _finalize(jst, 1, lpl))


def test_overflow_after_compaction_raises():
    """A store that overflows after compaction spills to host RAM; only a
    spill over the -m budget raises."""
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 4, batch_len(S, 27)).astype(np.uint8)
               for _ in range(4)]  # distinct random batches: nothing merges
    st = DeviceKmerStore(2 * S, k=27, sig_len=M, both_strands=True,
                         n_bins=512, device="cpu")
    for codes in batches:
        _feed(st, "b", codes)
    assert st.n_spills == 1 and len(st.spilled[0][1]) == 2 * S
    st = DeviceKmerStore(2 * S, k=27, sig_len=M, both_strands=True,
                         n_bins=512, spill_budget_bytes=1024, device="cpu")
    with pytest.raises(MemoryError, match="-m"):
        for codes in batches:
            _feed(st, "b", codes)
