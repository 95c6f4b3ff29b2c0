"""The sharded count's other modes (small k, the greedy map, KFF, -e and
--opt-out-size, -hc) on CPU shards against kmc_tpu's distributed_count on a
CPU mesh of the same size: every output file byte for byte, the stats dict
apart from its timings, exactly."""
import sys
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py sets up the 8-device CPU mesh)
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

from kmc_tpu.parallel.distributed import make_mesh as jax_make_mesh  # noqa: E402
from kmc_tpu.parallel.multihost import (  # noqa: E402
    _stage0_greedy_map as jax_stage0_greedy_map,
    distributed_count as jax_distributed_count)
from kmc_tpu_torch import count, distributed_count  # noqa: E402
from kmc_tpu_torch.formats.kff import read_kff  # noqa: E402
from kmc_tpu_torch.formats.kmc_db import read_db  # noqa: E402
from kmc_tpu_torch.parallel.multihost import _stage0_greedy_map  # noqa: E402

SUFFIXES = (".kmc_pre", ".kmc_suf", ".kff")
GREEDY = dict(signature_map_policy="greedy")
# shards of 2^10 rows fed batches of 2^9 positions: every shard spills
SPILL = dict(batch_positions=1 << 9, capacity_rows_per_device=1 << 10)
# shards that fill and compact before the exchange
COMPACT = dict(batch_positions=1 << 10, capacity_rows_per_device=1 << 13)

# (D, distributed_count kwargs); batch_positions 1 << 12 and
# capacity_rows_per_device 1 << 17 unless a case sets them
CASES = {
    "smallk_k12": (4, dict(k=12, cutoff_min=1)),
    "smallk_k13": (4, dict(k=13)),
    "smallk_k13_kff": (4, dict(k=13, output_type="kff")),
    "smallk_k12_kff_d2": (2, dict(k=12, cutoff_min=1, output_type="kff")),
    "smallk_k13_forward": (4, dict(k=13, cutoff_min=1, both_strands=False,
                                   counter_max=3)),
    "smallk_k13_hc": (4, dict(k=13, cutoff_min=1,
                              homopolymer_compressed=True)),
    "greedy_k25": (4, dict(k=25, cutoff_min=1, **GREEDY)),
    "greedy_k25_d2": (2, dict(k=25, cutoff_min=1, **GREEDY)),
    "greedy_k25_compactions": (4, dict(k=25, cutoff_min=1, **GREEDY,
                                       **COMPACT)),
    "greedy_k25_spill": (4, dict(k=25, cutoff_min=1, **GREEDY, **SPILL)),
    # 2 x 16 + the bin's bits > 32: the bin is a key column of its own
    "greedy_k32": (4, dict(k=32, cutoff_min=1, **GREEDY)),
    "greedy_k32_spill": (4, dict(k=32, cutoff_min=1, **GREEDY, **SPILL)),
    "greedy_k25_hc": (4, dict(k=25, cutoff_min=1, **GREEDY,
                              homopolymer_compressed=True)),
    "greedy_k25_serial": (4, dict(k=25, cutoff_min=2, **GREEDY,
                                  shard_input=False)),
    "kff_k25": (4, dict(k=25, cutoff_min=1, output_type="kff")),
    "kff_k25_d2": (2, dict(k=25, cutoff_min=1, output_type="kff")),
    "kff_k25_spill": (4, dict(k=25, cutoff_min=1, output_type="kff",
                              **SPILL)),
    "kff_k21_ci2_cs100": (4, dict(k=21, cutoff_min=2, counter_max=100,
                                  output_type="kff")),
    "kff_k31_unfused": (4, dict(k=31, cutoff_min=1, output_type="kff")),
    "kff_greedy_k27_spill": (4, dict(k=27, cutoff_min=1, output_type="kff",
                                     **GREEDY, **SPILL)),
    "estimate_k25": (4, dict(k=25, estimate_only=True)),
    "estimate_k21_d2": (2, dict(k=21, estimate_only=True)),
    "estimate_k13": (4, dict(k=13, estimate_only=True)),
    "opt_out_size_k25": (4, dict(k=25, cutoff_min=1, opt_out_size=True)),
    "opt_out_size_kff_spill": (4, dict(k=25, cutoff_min=1, opt_out_size=True,
                                       output_type="kff", **SPILL)),
}


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_modes") / "reads.fastq"
    # a small genome, so k-mers repeat and the compaction case's shards
    # hold its unique set after merging
    return write_fastq(path, random_reads(600, 120, seed=7, n_prob=0.004,
                                          genome_len=5000))


@pytest.fixture(scope="module")
def results(reads_file, tmp_path_factory):
    """Each case counted once by kmc_tpu and once by the port."""
    work = tmp_path_factory.mktemp("torch_modes_out")
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
                                   devices=["cpu"] * D, **kw)
            cache[name] = (sj, st, out_j, out_t, kw)
        return cache[name]

    return run


def _no_timings(stats):
    return {k: v for k, v in stats.items() if k != "timings"}


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_identical_to_kmc_tpu(results, name):
    sj, st, out_j, out_t, kw = results(name)
    written = [suf for suf in SUFFIXES if Path(out_j + suf).exists()]
    assert written == [suf for suf in SUFFIXES if Path(out_t + suf).exists()]
    for suf in written:
        assert Path(out_t + suf).read_bytes() == \
            Path(out_j + suf).read_bytes(), suf
    # every key of kmc_tpu's stats, equal; the port adds its merge counts
    got = _no_timings(st)
    assert {k: got[k] for k in _no_timings(sj)} == _no_timings(sj)
    if kw.get("estimate_only"):
        assert written == [] and st["n_reads"] == 600
        assert sum(st["estimated_histogram"]) > 0
    else:
        assert written == ([".kff"] if kw.get("output_type") == "kff"
                           else [".kmc_pre", ".kmc_suf"])
        assert st["n_total"] > 0
    if kw["k"] <= 13 and not kw.get("estimate_only"):
        assert st["was_small_k_opt_used"] and st["n_super_kmers"] == 0
    if kw.get("capacity_rows_per_device") == SPILL["capacity_rows_per_device"]:
        assert st["n_spills"] >= 2
    if name == "greedy_k25_compactions":
        assert st["n_compactions"] >= 2 and st["n_spills"] == 0


@pytest.mark.parametrize("k,hc", [(25, False), (32, False), (25, True)])
def test_greedy_map_equals_kmc_tpus(reads_file, k, hc):
    """The sampled stage 0 and the map it builds, bit for bit."""
    kw = dict(k=k, sig_len=9, n_bins=512, batch_positions=1 << 12,
              homopolymer_compressed=hc)
    want = jax_stage0_greedy_map([reads_file], "fastq", **kw)
    timings = {}
    got = _stage0_greedy_map([reads_file], "fastq", device="cpu",
                             timings=timings, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert int(want.max()) > 1
    assert set(timings) == {"stage0_s", "map_build_s"}


def test_greedy_footer_is_not_the_prefix_maps(results, reads_file, tmp_path):
    """The greedy count's .kmc_pre footer routes signatures by the greedy
    map, not by the prefix policy's (kmc_tpu's sharded footer, byte for
    byte, is held above)."""
    _, st, _, out_t, kw = results("greedy_k25")
    distributed_count([reads_file], str(tmp_path / "prefix"), k=25,
                      cutoff_min=1, devices=["cpu"] * 4,
                      batch_positions=kw["batch_positions"])
    greedy, prefix = read_db(out_t), read_db(str(tmp_path / "prefix"))
    assert not np.array_equal(greedy.sig_map, prefix.sig_map)
    assert greedy.info.n_bins != prefix.info.n_bins
    assert st["timings"]["stage0_s"] > 0 and st["timings"]["map_build_s"] > 0


def _records(out, kff: bool):
    """(k-mer bytes, counts) of a database, in sorted k-mer order."""
    if kff:
        data = read_kff(out + ".kff")
        kmers, counts = data.kmers, data.counts
    else:
        db = read_db(out)
        kmers, counts = db.kmers_bytes(), db.counters()
    order = np.lexsort(kmers.T[::-1])
    return kmers[order], np.asarray(counts)[order]


@pytest.mark.parametrize("name,single", [
    ("greedy_k25_spill", dict(signature_map_policy="greedy")),
    ("greedy_k32", dict(signature_map_policy="greedy")),
    ("kff_k25_spill", dict(output_type="kff")),
])
def test_kmer_set_equals_single_device_count(results, reads_file, tmp_path,
                                             name, single):
    """The sharded (k-mer, count) set == the port's single-device count's;
    the greedy runs also count the same super-k-mers."""
    from kmc_tpu_torch import OutputFileType

    _, st, _, out_t, kw = results(name)
    opts = dict(single)
    if opts.get("output_type") == "kff":
        opts["output_file_type"] = OutputFileType.KFF
        del opts["output_type"]
    out1 = str(tmp_path / "single")
    r1, r2 = count([reads_file], out1, device="cpu", k=kw["k"],
                   cutoff_min=kw["cutoff_min"],
                   batch_positions=kw["batch_positions"], **opts)
    kff = kw.get("output_type") == "kff"
    got, want = _records(out_t, kff), _records(out1, kff)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert st["n_unique"] == r2.n_unique_kmers
    assert st["n_total"] == r2.n_total_kmers
    assert st["n_super_kmers"] == r1.n_total_super_kmers


@pytest.mark.parametrize("name", ["smallk_k13", "smallk_k13_kff"])
def test_smallk_equals_single_device_count(results, reads_file, tmp_path,
                                           name):
    from kmc_tpu_torch import OutputFileType

    _, st, _, out_t, kw = results(name)
    kff = kw.get("output_type") == "kff"
    opts = dict(output_file_type=OutputFileType.KFF) if kff else {}
    r1, r2 = count([reads_file], str(tmp_path / "single"), device="cpu",
                   k=kw["k"], cutoff_min=kw.get("cutoff_min", 2),
                   batch_positions=kw["batch_positions"], **opts)
    assert r1.was_small_k_opt_used
    for suf in ((".kff",) if kff else (".kmc_pre", ".kmc_suf")):
        assert (tmp_path / f"single{suf}").read_bytes() == \
            Path(out_t + suf).read_bytes(), suf
    assert (st["n_unique"], st["n_total"]) == (r2.n_unique_kmers,
                                               r2.n_total_kmers)
