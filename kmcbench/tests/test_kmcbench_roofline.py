"""The roofline readers' byte formulas, and the probes that record each
kernel call's bytes from the program's shapes."""
import numpy as np
import pytest
import torch

from kmcbench import roofline
from kmcbench.probes import Probes


def test_ingest_bytes():
    # a boundary-delta feed of 1,234,567 bytes, s = 2^22, k <= 32: 2 key
    # columns and counts
    assert roofline.ingest_bytes(1_234_567, 1 << 22, 3) == \
        1_234_567 + 4 * (1 << 22) * 3


def test_sort_bytes():
    assert roofline.sort_bytes(1 << 26, 3) == 2 * 4 * (1 << 26) * 3
    assert roofline.sort_bytes(0, 5) == 0


def test_share_pct():
    h100 = "NVIDIA H100 80GB HBM3"
    # 3.35 GB in 1 ms is the peak itself
    assert roofline.share_pct(3_350_000_000, 1e-3, h100) == pytest.approx(
        100.0)
    assert roofline.share_pct(1000, 0.0, h100) is None  # no device time
    assert roofline.share_pct(0, 1.0, h100) is None
    assert roofline.share_pct(1000, 1.0, "some other card") is None


def test_probes_record_each_call_from_its_shapes(tmp_path):
    """A count on the CPU under the probes: one ingest record a batch,
    with the feed's bytes and s rows of the store's columns; one sort
    record a grouping sort, with its rows and columns."""
    from kmc_tpu_torch import count
    from kmc_tpu_torch.ops import sort_kernel, store

    from kmcbench.reads import Sample, write_fastq

    s = Sample(genome_bp=1 << 13, coverage=10, read_len=150,
               substitution_rate=0.005, reverse_share=0.5)
    fq = tmp_path / "r.fq"
    write_fastq(fq, s, 7, "cpu")
    seen = {"ingest": [], "sort": []}
    ingest, sort = store.ingest, sort_kernel.radix_sort_columns

    def spy_ingest(buf, tail_start, key_cols, counts, *a, **kw):
        seen["ingest"].append(buf.numel() + 4 * kw["s"] * (
            len(key_cols) + (counts is not None)))
        return ingest(buf, tail_start, key_cols, counts, *a, **kw)

    def spy_sort(cols, n_keys):
        seen["sort"].append(8 * cols[0].shape[0] * len(cols))
        return sort(cols, n_keys)

    spy_sort.launches = 0
    probes = Probes()
    probes.job = 0
    store.ingest, store.radix_sort_columns = spy_ingest, spy_sort
    try:
        probes.install()
        try:
            count([str(fq)], str(tmp_path / "db"), k=27, device="cpu",
                  batch_positions=1 << 10, device_store_rows=1 << 12)
        finally:
            probes.remove()
    finally:
        store.ingest, store.radix_sort_columns = ingest, sort
    assert store.ingest is ingest
    assert len(seen["ingest"]) > 3 and len(seen["sort"]) > 1
    assert sum(seen["ingest"]) == probes.bytes["ingest"][0]
    assert sum(seen["sort"]) == probes.bytes["sort"][0]
    assert probes.spans["host_input"][0] > 0
    assert probes.spans["compact"][0] > 0
    assert probes.spans["write"][0] > 0


def test_exchange_bytes_and_share():
    # four senders, four owners, 3 int32 columns (two keys and counts)
    counts = np.array([[10, 20, 30, 40], [5, 5, 5, 5], [0, 0, 0, 0],
                       [1, 2, 3, 4]])
    assert roofline.exchange_bytes(counts, 3) == 2 * 4 * 3 * 130
    assert roofline.exchange_bytes(np.zeros((4, 4), np.int64), 3) == 0
    # 185M rows of 12 bytes, read and written, in 4 ms summed over cards
    nbytes = roofline.exchange_bytes([[185_000_000]], 3)
    assert roofline.share_pct(nbytes, 4e-3, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(100.0 * 4.44e9 / 3.35e12 / 4e-3)


def test_probes_record_the_exchange_as_the_program_counts_it(tmp_path):
    """A sharded count on four CPU shards under the probes and a profile:
    the exchange's bytes from its shapes equal the program's kmc.exchange
    "bytes" counter and the count's exchange_bytes."""
    from kmc_tpu_torch import trace
    from kmc_tpu_torch.parallel import multihost

    from kmcbench import devtrace
    from kmcbench.reads import Sample, write_fastq

    s = Sample(genome_bp=1 << 13, coverage=10, read_len=150,
               substitution_rate=0.005, reverse_share=0.5)
    fq = tmp_path / "r.fq"
    write_fastq(fq, s, 7, "cpu")
    probes = Probes()
    probes.job = 0
    a2a = multihost.ragged_all_to_all
    probes.install()
    try:
        with devtrace.profiler("cpu"):
            res = multihost.distributed_count(
                [str(fq)], str(tmp_path / "db"), k=27, devices=["cpu"] * 4,
                batch_positions=1 << 10, capacity_rows_per_device=1 << 12)
            spans = [sp for sp in trace.records() if sp.name == "kmc.exchange"]
    finally:
        probes.remove()
    assert multihost.ragged_all_to_all is a2a
    assert res["exchange_bytes"] > 0
    assert probes.bytes["exchange"][0] == res["exchange_bytes"] == sum(
        sp.counters["bytes"] for sp in spans)
