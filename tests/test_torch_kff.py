"""KFF output and -w on the port against kmc_tpu, on the CPU.

The port's KffWriter / read_kff / read_kff_meta against kmc_tpu's on the
same records; then count(..., output_file_type=KFF) through the words-path
finalize's three routes (device, replay of spilled runs, host merge), after
a checkpoint resume, and -w: the .kff bytes and the results must equal
kmc_tpu's, and each route keeps its own count arithmetic near 2^32."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

from kmc_tpu.formats import kff as jax_kff  # noqa: E402
from kmc_tpu.ops.store import DeviceKmerStore as JaxStore  # noqa: E402
from kmc_tpu.runner import OutputFileType as JaxOutputFileType  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import (OutputFileType, Runner, Stage1Params,  # noqa: E402
                           Stage2Params)
from kmc_tpu_torch.formats import kff as torch_kff  # noqa: E402
from kmc_tpu_torch.ops import store as store_mod  # noqa: E402
from kmc_tpu_torch.ops.store import DeviceKmerStore  # noqa: E402

_TIMES = {"time", "time_strict_mem", "time_finalize_exec", "time_finalize_d2h"}


def _no_times(res):
    return {k: v for k, v in dataclasses.asdict(res).items()
            if k not in _TIMES}


def _random_sections(k, counter_size, seed, n_sections=3):
    rng = np.random.default_rng(seed)
    kb = (k + 3) // 4
    out = []
    for i in range(n_sections):
        n = int(rng.integers(0, 50)) if i else 0  # an empty section too
        kmers = rng.integers(0, 256, (n, kb), dtype=np.uint8)
        kmers[:, 0] &= (1 << (2 * (k - 4 * (kb - 1)))) - 1
        top = (1 << (8 * counter_size)) - 1 if counter_size else 1
        out.append((kmers, rng.integers(1, top + 1, n, dtype=np.uint64)
                    .astype(np.uint32)))
    return out


def _meta(mod, path):
    return dataclasses.asdict(mod.read_kff_meta(str(path)))


def _write(mod, path, k, counter_size, canonical, sections):
    w = mod.KffWriter(str(path), canonical=canonical, k=k,
                      counter_size=counter_size, min_count=2,
                      max_count=1000)
    for kmers, counts in sections:
        w.store_section(kmers, counts)
    w.close()
    return Path(path).read_bytes()


@pytest.mark.parametrize("k,counter_size,canonical", [
    (5, 1, True), (27, 0, True), (27, 4, False), (33, 2, True),
    (129, 3, True)])
def test_kff_writer_bytes_and_reader(tmp_path, k, counter_size, canonical):
    sections = _random_sections(k, counter_size, seed=k + counter_size)
    got = _write(torch_kff, tmp_path / "t.kff", k, counter_size, canonical,
                 sections)
    want = _write(jax_kff, tmp_path / "j.kff", k, counter_size, canonical,
                  sections)
    assert got == want
    data = torch_kff.read_kff(str(tmp_path / "t.kff"))
    ref = jax_kff.read_kff(str(tmp_path / "j.kff"))
    assert (data.k, data.counter_size, data.canonical) == (
        k, counter_size, canonical)
    assert np.array_equal(data.kmers, np.concatenate([s[0] for s in sections]))
    want_counts = (np.concatenate([s[1] for s in sections]) if counter_size
                   else np.ones(len(data.kmers), np.uint32))
    assert np.array_equal(data.counts, want_counts)
    assert np.array_equal(data.kmers, ref.kmers)
    assert np.array_equal(data.counts, ref.counts)
    assert _meta(torch_kff, tmp_path / "t.kff") == \
        _meta(jax_kff, tmp_path / "j.kff")


def test_read_kff_decodes_block_sections(tmp_path):
    """A max > 1 block section (written by kmc_tpu's tools) reads as
    kmc_tpu reads it."""
    path = str(tmp_path / "blocks.kff")
    rng = np.random.default_rng(3)
    w = jax_kff.KffWriter(path, canonical=False, k=7, counter_size=1,
                          min_count=1, max_count=255)
    w.store_block_section(
        [(rng.integers(0, 4, 7 + n - 1).astype(np.uint8),
          rng.integers(1, 200, n)) for n in (1, 3, 8)])
    w.store_section(rng.integers(0, 64, (4, 2), dtype=np.uint8),
                    np.arange(1, 5, dtype=np.uint32))
    w.close()
    got, ref = torch_kff.read_kff(path), jax_kff.read_kff(path)
    assert len(got.kmers) == 1 + 3 + 8 + 4
    assert np.array_equal(got.kmers, ref.kmers)
    assert np.array_equal(got.counts, ref.counts)
    assert _meta(torch_kff, path) == _meta(jax_kff, path)


# genome length -> the finalize route with 1024-position batches and a
# 4096-row store (tests/test_torch_spill.py): ~20 k unique k-mers outgrow
# the store (host merge), ~3.4 k fit it after a compaction but not beside
# the next batch (replay); the device route gets a store that never spills
ROUTES = {"device": (3400, 1 << 16), "replay": (3400, 4096),
          "host": (20000, 4096)}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("kff")
    return {glen: write_fastq(d / f"g{glen}.fastq",
                              random_reads(400, 200, seed=3, n_prob=0.003,
                                           genome_len=glen))
            for glen in {g for g, _ in ROUTES.values()}}


def _both_counts(fq, tmp_path, k, **kw):
    """The same count in both packages; returns the port's runner."""
    jkw = dict(kw)
    if "output_file_type" in jkw:
        jkw["output_file_type"] = JaxOutputFileType[kw["output_file_type"].name]
    j1, j2 = jax_count([fq], str(tmp_path / "jax"), k=k, **jkw)
    p1 = Stage1Params(input_files=[fq], kmer_len=k)
    p2 = Stage2Params(output_file_name=str(tmp_path / "torch"))
    for key, val in kw.items():
        setattr(p1 if hasattr(p1, key) else p2, key, val)
    r = Runner(device="cpu")
    t1 = r.run_stage1(p1)
    t2 = r.run_stage2(p2)
    assert _no_times(t1) == _no_times(j1)
    assert _no_times(t2) == _no_times(j2)
    return r, t2


def _same_kff(tmp_path):
    got = (tmp_path / "torch.kff").read_bytes()
    assert got == (tmp_path / "jax.kff").read_bytes()
    return got


@pytest.mark.parametrize("route", sorted(ROUTES) + ["host_ranges"])
@pytest.mark.parametrize("k", [16, 27, 33, 129])
def test_count_kff_byte_identical(reads, tmp_path, monkeypatch, route, k):
    """Each route; host_ranges: the host route with its merge cut into key
    ranges of at most 2000 rows, each range's words completed on the
    device and copied as it completes."""
    if route == "host_ranges":
        monkeypatch.setattr(store_mod, "_merge_rows", lambda *a, **kw: 2000)
    route, ranges = route.split("_")[0], route == "host_ranges"
    glen, rows = ROUTES[route]
    r, res = _both_counts(reads[glen], tmp_path, k, cutoff_min=1,
                          batch_positions=1 << 10, device_store_rows=rows,
                          output_file_type=OutputFileType.KFF)
    _same_kff(tmp_path)
    assert r.spill_stats["finalize_route"] == route
    if ranges:
        assert r._count.counter("ranges", "kmc.host_completer") >= 3
    data = torch_kff.read_kff(str(tmp_path / "torch.kff"))
    assert len(data.kmers) == res.n_unique_kmers - res.n_below_cutoff_min \
        - res.n_above_cutoff_max > 0


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("kw", [
    dict(canonical_kmers=False),
    # bins whose k-mers all fall under -ci get no section
    dict(cutoff_min=3, cutoff_max=5, counter_max=4),
    dict(cutoff_min=2, counter_max=1),
])
def test_count_kff_knobs_byte_identical(reads, tmp_path, route, kw):
    glen, rows = ROUTES[route]
    kw = dict(kw)
    kw.setdefault("cutoff_min", 1)
    _both_counts(reads[glen], tmp_path, 27, batch_positions=1 << 10,
                 device_store_rows=rows, output_file_type=OutputFileType.KFF,
                 **kw)
    _same_kff(tmp_path)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_without_output_results(reads, tmp_path, route):
    glen, rows = ROUTES[route]
    r, res = _both_counts(reads[glen], tmp_path, 27, cutoff_min=2,
                          batch_positions=1 << 10, device_store_rows=rows,
                          without_output=True)
    assert r.spill_stats["finalize_route"] == route
    assert res.n_unique_kmers > res.n_below_cutoff_min > 0
    assert not list(tmp_path.glob("torch*"))


def test_kff_after_checkpoint_resume(reads, tmp_path):
    """A stage-1 checkpoint with spilled runs, resumed in a new runner,
    writes kmc_tpu's straight-count .kff."""
    glen, rows = ROUTES["host"]
    fq = reads[glen]
    kw = dict(batch_positions=1 << 10, device_store_rows=rows)
    jax_count([fq], str(tmp_path / "jax"), k=27, cutoff_min=1,
              output_file_type=JaxOutputFileType.KFF, **kw)
    r = Runner(device="cpu")
    r.run_stage1(Stage1Params(input_files=[fq], kmer_len=27, **kw))
    assert r._store.spilled
    ck = str(tmp_path / "ck")
    r.save_stage1_checkpoint(ck)
    r2 = Runner(device="cpu")
    r2.resume_stage1_checkpoint(ck, Stage1Params(input_files=[fq], **kw))
    r2.run_stage2(Stage2Params(output_file_name=str(tmp_path / "torch"),
                               cutoff_min=1,
                               output_file_type=OutputFileType.KFF))
    _same_kff(tmp_path)


def test_cli_kff_identical(reads, tmp_path):
    import kmc_tpu.cli as jax_cli
    import kmc_tpu_torch.cli as torch_cli

    fq = reads[ROUTES["device"][0]]
    args = ["-k25", "-ci2", "-okff", "-hp", "-S4096"]
    assert jax_cli.main(args + [fq, str(tmp_path / "jax"),
                                str(tmp_path)]) == 0
    assert torch_cli.main(args + ["--device=cpu", fq, str(tmp_path / "torch"),
                                  str(tmp_path)]) == 0
    _same_kff(tmp_path)


# -- the words-path finalize, call for call, near 2^32 --

KW = dict(k=27, sig_len=9, both_strands=True, n_bins=512)


def _big_counts_run(store, counts):
    """Rows of two live keys (valid bins) that repeat with the counts."""
    n = len(counts)
    base = np.array([7 << (2 * store.r0 - 4), 9 << (2 * store.r0 - 4)],
                    np.uint32)
    col0 = base[np.arange(n) % 2]
    cols = (col0,) + tuple(np.full(n, 0x12345678 + j, np.uint32)
                           for j in range(store.n_cols - 1))
    return cols, np.asarray(counts, np.uint32)


def _same_words_out(got, ref):
    assert got[3] == tuple(int(x) for x in ref[3])
    for a, b in zip(got[:3], ref[:3]):
        assert np.array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def test_finalize_device_totals_wrap():
    """The device route's totals are u32: key A (2^32 - 1 + 1) wraps to 0
    and is dropped, key B (2^32 - 1 + 5) counts 4."""
    stores = (JaxStore(1 << 10, **KW),
              DeviceKmerStore(1 << 10, device="cpu", **KW))
    run = _big_counts_run(stores[1], [0xFFFFFFFF, 0xFFFFFFFF, 1, 5])
    kw = dict(cutoff_min=1, cutoff_max=2**31 - 1, counter_max=2**31 - 1)
    for st in stores:
        st.append(*run)
    got, ref = stores[1].finalize(**kw), stores[0].finalize(**kw)
    assert stores[1].finalize_route == "device"
    assert got[3][0] == 1 and list(got[2]) == [4]
    _same_words_out(got, ref)


@pytest.mark.parametrize("counter_max", [2**32 - 1, 1000])
def test_finalize_host_route_sums_in_u64(counter_max):
    """Runs that outgrow the store take the host merge: totals above 2^32
    stay exact (none is dropped) and clamp to counter_max."""
    stores = (JaxStore(64, initial_rows=64, **KW),
              DeviceKmerStore(64, device="cpu", **KW))
    big = _big_counts_run(stores[1], [0xFFFFFFF0, 0xFFFFFFFF])
    rng = np.random.default_rng(0)
    for seed in range(3):  # 60 distinct rows a run: each spills
        other = (tuple(rng.integers(0, 1 << 30, 60, dtype=np.uint32)
                       for _ in range(stores[1].n_cols)),
                 np.ones(60, np.uint32))
        for st in stores:
            st.append(*other)
            st.append(*big)
            st.spill()
    kw = dict(cutoff_min=1, cutoff_max=1 << 40, counter_max=counter_max)
    got, ref = stores[1].finalize(**kw), stores[0].finalize(**kw)
    assert stores[1].finalize_route == "host"
    assert min(2**32 - 1, counter_max) in got[2]
    _same_words_out(got, ref)
