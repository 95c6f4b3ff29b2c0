"""The -m / max_ram_gb plan (kmc_tpu_torch/memory.py) and its enforcement,
the twins of tests/test_memory.py: each plan equals kmc_tpu's, -m reaches
the store, a tight budget keeps the bytes, and the spill budget re-merges
or raises MemoryError naming -m."""
import dataclasses

import numpy as np
import pytest

from kmc_tpu.memory import plan_memory as jax_plan
from kmc_tpu_torch.memory import plan_memory


@pytest.mark.parametrize("kw", [
    dict(max_ram_gb=1), dict(max_ram_gb=2), dict(max_ram_gb=12),
    dict(max_ram_gb=1, requested_rows=1 << 22),
    dict(max_ram_gb=2, strict_memory=True),
    dict(max_ram_gb=2, requested_rows=1 << 22, strict_memory=True),
    dict(max_ram_gb=1, n_threads=8), dict(max_ram_gb=12, n_threads=8),
])
def test_plan_equals_kmc_tpu(kw):
    kw = dict(kw, k=27, batch_positions=1 << 10)
    m = kw.pop("max_ram_gb")
    assert dataclasses.asdict(plan_memory(m, **kw)) == \
        dataclasses.asdict(jax_plan(m, **kw))


def test_plan_rows_scale_with_budget():
    rows = [plan_memory(m, k=27, batch_positions=1 << 10).device_store_rows
            for m in (1, 2, 12)]
    assert rows[0] < rows[1] <= rows[2]
    assert rows[2] == 1 << 26


def test_plan_explicit_rows_win():
    p = plan_memory(1, k=27, batch_positions=1 << 10, requested_rows=1 << 22)
    assert p.device_store_rows == 1 << 22


def test_plan_strict_composes():
    auto = plan_memory(2, k=27, batch_positions=1 << 10)
    strict = plan_memory(2, k=27, batch_positions=1 << 10,
                         strict_memory=True)
    assert strict.device_store_rows == auto.device_store_rows // 2
    exp = plan_memory(2, k=27, batch_positions=1 << 10,
                      requested_rows=1 << 22, strict_memory=True)
    assert exp.device_store_rows == 1 << 21


def test_plan_parse_chunk_shrinks():
    small = plan_memory(1, k=27, batch_positions=1 << 10, n_threads=8)
    big = plan_memory(12, k=27, batch_positions=1 << 10, n_threads=8)
    assert small.parse_chunk_bytes < big.parse_chunk_bytes
    assert small.parse_chunk_bytes >= 1 << 20


def _mk_fastq(path, n_reads=400, read_len=100, seed=0):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n_reads):
            seq = acgt[rng.integers(0, 4, read_len)].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * read_len))


def test_runner_m_changes_store_capacity(tmp_path, monkeypatch):
    """-m reaches the store's allocation, not just the parser."""
    import kmc_tpu_torch.ops.store as store_mod
    from kmc_tpu_torch import count

    fq = tmp_path / "t.fastq"
    _mk_fastq(fq, n_reads=50)
    caps = []
    real = store_mod.DeviceKmerStore

    class Capture(real):
        def __init__(self, capacity_rows, **kw):
            caps.append((capacity_rows, kw.get("spill_budget_bytes")))
            super().__init__(capacity_rows, **kw)

    monkeypatch.setattr(store_mod, "DeviceKmerStore", Capture)
    for m, out in ((1, "o1"), (12, "o2")):
        count([str(fq)], str(tmp_path / out), k=27, cutoff_min=1,
              batch_positions=1 << 12, max_ram_gb=m, device="cpu")
    (cap1, bud1), (cap12, bud12) = caps
    assert cap1 < cap12
    assert bud1 is not None and bud12 is not None and bud1 < bud12


def test_tight_budget_byte_identical(tmp_path):
    """-m1 (small store, spill budget live) writes the same bytes, and
    kmc_tpu's."""
    from kmc_tpu.runner import count as jax_count
    from kmc_tpu_torch import count

    fq = tmp_path / "t.fastq"
    _mk_fastq(fq)
    count([str(fq)], str(tmp_path / "ref"), k=27, cutoff_min=1,
          batch_positions=1 << 12, device_store_rows=1 << 15, device="cpu")
    count([str(fq)], str(tmp_path / "m1"), k=27, cutoff_min=1,
          batch_positions=1 << 12, max_ram_gb=1, device="cpu")
    jax_count([str(fq)], str(tmp_path / "jax"), k=27, cutoff_min=1,
              batch_positions=1 << 12, max_ram_gb=1)
    for suf in (".kmc_pre", ".kmc_suf"):
        ref = (tmp_path / ("ref" + suf)).read_bytes()
        assert (tmp_path / ("m1" + suf)).read_bytes() == ref
        assert (tmp_path / ("jax" + suf)).read_bytes() == ref


def test_spill_budget_remerges_and_bounds():
    """Crossing the spill budget re-merges runs in place; an impossible
    budget raises MemoryError naming the flag."""
    from kmc_tpu_torch.ops.store import DeviceKmerStore

    def store(budget):
        return DeviceKmerStore(1 << 13, k=27, sig_len=9, both_strands=True,
                               n_bins=512, spill_budget_bytes=budget,
                               device="cpu")

    def fill(st, seed, n=4096):
        rng = np.random.default_rng(seed)
        cols = tuple(rng.integers(0, 1 << 30, n, dtype=np.uint32)
                     for _ in range(st.n_cols))
        st._materialize_counts()
        st.append(cols, np.ones(n, np.uint32))

    s1 = store(1 << 30)  # generous: two spills coexist un-merged
    fill(s1, 1)
    s1.spill()
    fill(s1, 2)
    s1.spill()
    assert len(s1.spilled) == 2

    s2 = store(60_000)  # tight: identical fills collapse back under it
    fill(s2, 1)
    s2.spill()
    fill(s2, 1)
    s2.spill()
    assert len(s2.spilled) == 1
    cols, _ = s2.spilled[0]
    assert np.all(np.diff(cols[0].astype(np.uint64)) >= 0)

    s3 = store(1024)
    fill(s3, 1)
    with pytest.raises(MemoryError, match="-m"):
        s3.spill()


def test_sharded_spill_budget():
    """ShardedKmerStore holds its spills to the same budget: identical
    batches each round re-merge under a budget armed above one spill."""
    from kmc_tpu_torch.io.native import pack_codes_fused
    from kmc_tpu_torch.io.readers import batch_len
    from kmc_tpu_torch.parallel.multihost import ShardedKmerStore

    store = ShardedKmerStore(["cpu"] * 2, 1 << 12, k=27, sig_len=9,
                             spill_budget_bytes=1 << 30)
    s = 1 << 10
    L = batch_len(s, 27)
    for it in range(2):
        rng = np.random.default_rng(7)
        items = [("m", pack_codes_fused(rng.integers(0, 4, L).astype(
            np.uint8))) for _ in range(store.D)]
        store.ingest_group(items, s=s)
        store.spill()
        if it == 0:
            store.spill_budget_bytes = store._spilled_bytes() + 100
    assert store.n_remerges == 1
    assert len(store.spilled) == 1  # re-merged under the budget
    assert store._spilled_bytes() <= store.spill_budget_bytes
