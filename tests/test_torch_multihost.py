"""kmc_tpu_torch.distributed_count on CPU shards against kmc_tpu's
distributed_count on a CPU mesh of the same size: the databases must be
byte-identical and the stats equal, exactly."""
import sys
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py sets up the 8-device CPU mesh)
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

from kmc_tpu.parallel.distributed import make_mesh as jax_make_mesh  # noqa: E402
from kmc_tpu.parallel.multihost import (  # noqa: E402
    distributed_count as jax_distributed_count)
from kmc_tpu_torch import count, distributed_count, make_mesh  # noqa: E402

STATS = ("n_unique", "n_total", "n_below", "n_above", "n_super_kmers",
         "n_reads", "n_reads_local", "consumed_bytes_local", "n_devices",
         "n_processes", "n_compactions", "n_spills")
SUFFIXES = (".kmc_pre", ".kmc_suf")

# (D, distributed_count kwargs); batch_positions 1 << 12 and
# capacity_rows_per_device 1 << 17 unless a case sets them
CASES = {
    "d1_k25": (1, dict(k=25, cutoff_min=1)),
    "d4_k25": (4, dict(k=25, cutoff_min=1)),
    "d4_k21_ci2_cs100": (4, dict(k=21, cutoff_min=2, counter_max=100)),
    # per-shard stores fill: mid-run compactions, then a counted exchange
    "d4_compactions": (4, dict(k=25, cutoff_min=1, batch_positions=1 << 10,
                               capacity_rows_per_device=1 << 13)),
    # 2 * 15 + 10 > 32: the bin is a column of its own (non-fused layout)
    "d4_k31_unfused": (4, dict(k=31, cutoff_min=1)),
    "d4_forward_only": (4, dict(k=25, cutoff_min=1, both_strands=False)),
    "d4_hc": (4, dict(k=25, cutoff_min=1, homopolymer_compressed=True)),
    # the input split into record-aligned byte ranges, 3 parser threads
    "d4_split_parse": (4, dict(k=25, cutoff_min=1, min_shard_bytes=1 << 12,
                               n_parse_threads=3)),
    "d4_serial_parse": (4, dict(k=25, cutoff_min=1, shard_input=False)),
}


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_mh") / "reads.fastq"
    # a small genome, so the per-shard stores of the compaction case hold
    # its unique set after merging
    return write_fastq(path, random_reads(600, 120, seed=7, n_prob=0.004,
                                          genome_len=5000))


@pytest.fixture(scope="module")
def results(reads_file, tmp_path_factory):
    """Each case counted once by kmc_tpu and once by the port."""
    work = tmp_path_factory.mktemp("torch_mh_out")
    cache = {}

    def run(name):
        if name not in cache:
            D, kw = CASES[name]
            kw = dict(kw)
            kw.setdefault("batch_positions", 1 << 12)
            kw.setdefault("capacity_rows_per_device", 1 << 17)
            out_j, out_t = str(work / f"{name}_jax"), str(work / f"{name}_t")
            sj = jax_distributed_count([reads_file], out_j,
                                       mesh=jax_make_mesh(D), **kw)
            st = distributed_count([reads_file], out_t,
                                   devices=make_mesh(D, device="cpu"), **kw)
            cache[name] = (sj, st, out_j, out_t, kw)
        return cache[name]

    return run


@pytest.mark.parametrize("name", list(CASES))
def test_db_byte_identical_to_kmc_tpu(results, name):
    sj, st, out_j, out_t, _ = results(name)
    for suf in SUFFIXES:
        assert Path(out_t + suf).read_bytes() == \
            Path(out_j + suf).read_bytes(), suf
    assert {k: st[k] for k in STATS} == {k: sj[k] for k in STATS}
    assert st["n_total"] > 0
    assert st["n_spills"] == 0


def test_compaction_case_compacts_and_counts(results):
    _, st, *_ = results("d4_compactions")
    assert st["n_compactions"] >= 2
    assert st["exchange_bytes"] > 0


def test_sharded_db_equals_single_device_count(results, reads_file,
                                               tmp_path):
    _, st, _, out_t, kw = results("d4_k25")
    r1, r2 = count([reads_file], str(tmp_path / "single"), device="cpu",
                   k=kw["k"], cutoff_min=kw["cutoff_min"],
                   batch_positions=kw["batch_positions"])
    for suf in SUFFIXES:
        assert (tmp_path / f"single{suf}").read_bytes() == \
            Path(out_t + suf).read_bytes(), suf
    assert st["n_super_kmers"] == r1.n_total_super_kmers
    assert st["n_unique"] == r2.n_unique_kmers
    assert st["n_total"] == r2.n_total_kmers


@pytest.mark.parametrize("kw,item", [
    (dict(k=13), "A11b"),
    (dict(output_type="kff"), "A11b"),
    (dict(signature_map_policy="greedy"), "A11b"),
    (dict(estimate_only=True), "A11b"),
    (dict(opt_out_size=True), "A11b"),
])
def test_unported_knobs_raise(reads_file, tmp_path, kw, item):
    kw = dict(kw)
    k = kw.pop("k", 25)
    with pytest.raises(NotImplementedError, match=item):
        distributed_count([reads_file], str(tmp_path / "db"), k=k,
                          devices=["cpu"] * 2, **kw)
    assert not (tmp_path / "db.kmc_pre").exists()


def test_overflow_after_compaction_raises(reads_file, tmp_path):
    """The unique set outgrows the shards, which raised before the port had
    the sharded spill: now every shard spills to host RAM, as kmc_tpu's do,
    and the database and stats are kmc_tpu's."""
    kw = dict(k=25, cutoff_min=1, batch_positions=1 << 9,
              capacity_rows_per_device=1 << 10)
    sj = jax_distributed_count([reads_file], str(tmp_path / "jax"),
                               mesh=jax_make_mesh(4), **kw)
    st = distributed_count([reads_file], str(tmp_path / "db"),
                           devices=["cpu"] * 4, **kw)
    for suf in SUFFIXES:
        assert (tmp_path / f"db{suf}").read_bytes() == \
            (tmp_path / f"jax{suf}").read_bytes(), suf
    assert {k: st[k] for k in STATS} == {k: sj[k] for k in STATS}
    assert st["n_spills"] >= 2


def test_make_mesh_cpu_and_device_lists():
    assert [d.type for d in make_mesh(3, device="cpu")] == ["cpu"] * 3
    assert len(make_mesh(device="cpu")) == 1
    with pytest.raises(ValueError, match="at least one"):
        distributed_count(["x.fastq"], "db", k=25, devices=[])


@pytest.mark.parametrize("n_parts", [1, 3])
def test_input_shards_match_kmc_tpu(reads_file, n_parts):
    from kmc_tpu.io.readers import process_input_shards as jax_shards
    from kmc_tpu_torch.io.readers import (ParseState, file_code_stream,
                                          process_input_shards,
                                          shard_code_stream)

    parts = process_input_shards([reads_file], "fastq", n_parts,
                                 min_shard_bytes=1 << 12)
    assert parts == jax_shards([reads_file], "fastq", n_parts,
                               min_shard_bytes=1 << 12)
    assert sum(len(p) for p in parts) > n_parts  # several byte ranges
    whole, st = ParseState(), ParseState()
    want = np.concatenate(list(file_code_stream([reads_file], "fastq",
                                                whole)))
    got = np.concatenate([c for p in parts for c in shard_code_stream(
        p, "fastq", st, n_threads=2)])
    assert np.array_equal(got, want)
    assert st.n_reads == whole.n_reads == 600
