"""The host-bucket route (--no-device-store) on the port against kmc_tpu,
on the CPU: the stage-0 signature histogram, the greedy signature map, one
stage-1 batch, the per-bin merge and whole counts' KMC2 / KFF bytes."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from kmc_tpu import signatures as jax_signatures  # noqa: E402
from kmc_tpu.io.native import pack_codes  # noqa: E402
from kmc_tpu.ops.extract import (stage0_stats_accum,  # noqa: E402
                                 stage1_batch_packed)
from kmc_tpu.ops.sortcount import merge_count_bin as jax_merge  # noqa: E402
from kmc_tpu.runner import OutputFileType as JaxOutputFileType  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import OutputFileType, count, signatures  # noqa: E402
from kmc_tpu_torch.io.readers import batch_len  # noqa: E402
from kmc_tpu_torch.ops.extract import i32_to_u32  # noqa: E402
from kmc_tpu_torch.ops.sortcount import (merge_count_bin,  # noqa: E402
                                         stage0_accum, stage1_batch)

_TIMES = {"time", "time_strict_mem", "time_finalize_exec", "time_finalize_d2h"}
S = 1 << 12


def _no_times(res):
    return {k: v for k, v in dataclasses.asdict(res).items()
            if k not in _TIMES}


def _batch(k, seed, n_prob=0.01):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - 100, batch_len(S, k) // 100 + 1)
    codes = np.concatenate([np.append(genome[s:s + 100], 4) for s in starts])
    codes = codes[:batch_len(S, k)].astype(np.uint8)
    codes[rng.random(len(codes)) < n_prob] = 4
    return codes


@pytest.mark.parametrize("k,m", [(27, 9), (33, 7), (14, 5)])
def test_stage0_histogram_matches_kmc_tpu(k, m):
    msize = signatures.map_size(m)
    hist_t = torch.zeros(msize, dtype=torch.int64)
    hist_j = jnp.zeros((msize,), jnp.uint32)
    for seed in range(2):
        codes = _batch(k, seed)
        stage0_accum(torch.from_numpy(codes), hist_t, s=S, k=k, sig_len=m)
        packed, mask = pack_codes(codes)
        hist_j = stage0_stats_accum(packed, mask, hist_j, s=S, k=k, sig_len=m)
    assert np.array_equal(hist_t.numpy(), np.asarray(hist_j).astype(np.int64))
    assert 0 < int(hist_t.sum()) < 2 * S


@pytest.mark.parametrize("m,n_bins,seed", [(5, 64, 0), (7, 512, 1),
                                           (9, 512, 2), (9, 2000, 3)])
def test_signature_map_matches_kmc_tpu(m, n_bins, seed):
    rng = np.random.default_rng(seed)
    msize = signatures.map_size(m)
    stats = rng.zipf(1.6, msize).astype(np.uint64) % 100000
    stats[rng.random(msize) < 0.3] = 0
    got = signatures.build_signature_map(stats, m, n_bins)
    want = jax_signatures.build_signature_map(stats, m, n_bins)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert signatures.n_used_bins(got) == jax_signatures.n_used_bins(want)


@pytest.mark.parametrize("k,both", [(27, True), (33, True), (31, False)])
def test_stage1_batch_matches_kmc_tpu(k, both):
    codes = _batch(k, 7)
    sig, lanes, counts = stage1_batch(torch.from_numpy(codes), s=S, k=k,
                                      sig_len=9, both_strands=both)
    packed, mask = pack_codes(codes)
    u_sig, u_words, u_counts, n = stage1_batch_packed(
        packed, mask, s=S, k=k, sig_len=9, both_strands=both)
    n = int(n)
    assert sig.shape[0] == n
    assert np.array_equal(i32_to_u32(sig).numpy(),
                          np.asarray(u_sig[:n]).astype(np.int64))
    words = torch.stack([i32_to_u32(c) for c in lanes], dim=1).numpy()
    assert np.array_equal(words, np.asarray(u_words[:n]).astype(np.int64))
    assert np.array_equal(counts.numpy(),
                          np.asarray(u_counts[:n]).astype(np.int64))
    assert int(counts.sum()) == S


@pytest.mark.parametrize("W,kw", [
    (2, dict(cutoff_min=1, cutoff_max=10**9, counter_max=255)),
    (2, dict(cutoff_min=3, cutoff_max=6, counter_max=4)),
    (3, dict(cutoff_min=2, cutoff_max=2**31 - 1, counter_max=2**31 - 1)),
])
def test_merge_count_bin_matches_kmc_tpu(W, kw):
    """kmc_tpu's padded bin (all-ones rows of count 0) through both merges;
    totals wrap mod 2^32 and a group that wraps to 0 is dropped."""
    rng = np.random.default_rng(W + kw["cutoff_min"])
    n, P = 3000, 4096
    keys = rng.integers(0, 400, n)
    words = np.full((P, W), 0xFFFFFFFF, np.uint32)
    words[:n] = np.stack([(keys * 2654435761 + t) & 0xFFFFFFFF
                          for t in range(W)], axis=1).astype(np.uint32)
    counts = np.zeros(P, np.uint32)
    counts[:n] = rng.integers(1, 5, n)
    # one key's total wraps to 0, another's to 3
    words[n:n + 4] = words[0] ^ np.uint32(1)
    counts[n:n + 4] = [0xFFFFFFFF, 1, 0, 0]
    words[n + 4:n + 6] = words[1] ^ np.uint32(2)
    counts[n + 4:n + 6] = [0xFFFFFFFF, 4]
    got_w, got_c, stats = merge_count_bin(
        [torch.from_numpy(np.ascontiguousarray(words[:, t]).view(np.int32))
         for t in range(W)],
        torch.from_numpy(counts.view(np.int32)), **kw)
    kept_w, kept_c, n_kept, ref = jax_merge(jnp.asarray(words),
                                            jnp.asarray(counts), **kw)
    n_kept = int(n_kept)
    assert stats == tuple(int(x) for x in ref)
    assert np.array_equal(got_w.numpy(),
                          np.asarray(kept_w[:n_kept]).astype(np.int64))
    assert np.array_equal(got_c.numpy(),
                          np.asarray(kept_c[:n_kept]).astype(np.int64))


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("buckets")
    return write_fastq(d / "in.fastq", random_reads(300, 120, seed=5,
                                                    n_prob=0.005,
                                                    genome_len=6000))


@pytest.mark.parametrize("k,kw", [
    (27, dict(cutoff_min=2)),
    (27, dict(cutoff_min=1, output_file_type=OutputFileType.KFF)),
    (33, dict(cutoff_min=1, n_bins=64, signature_len=7)),
    (31, dict(cutoff_min=1, canonical_kmers=False,
              output_file_type=OutputFileType.KFF)),
    (25, dict(cutoff_min=2, cutoff_max=6, counter_max=4, n_threads=4)),
    (16, dict(cutoff_min=1, without_output=True)),
])
def test_host_bucket_count_byte_identical(fastq, tmp_path, k, kw):
    jkw = dict(kw)
    if "output_file_type" in kw:
        jkw["output_file_type"] = JaxOutputFileType[kw["output_file_type"].name]
    j1, j2 = jax_count([fastq], str(tmp_path / "jax"), k=k,
                       device_store=False, batch_positions=S, **jkw)
    t1, t2 = count([fastq], str(tmp_path / "torch"), k=k, device="cpu",
                   device_store=False, batch_positions=S, **kw)
    assert _no_times(t1) == _no_times(j1)
    assert _no_times(t2) == _no_times(j2)
    assert t2.n_total_kmers > 0
    if kw.get("without_output"):
        assert not list(tmp_path.glob("torch*"))
        return
    sufs = ([".kff"] if kw.get("output_file_type") == OutputFileType.KFF
            else [".kmc_pre", ".kmc_suf"])
    for suf in sufs:
        assert (tmp_path / f"torch{suf}").read_bytes() == \
            (tmp_path / f"jax{suf}").read_bytes(), suf


@pytest.mark.parametrize("max_bytes", [1 << 20, 3 << 19, 5 << 20])
def test_stage0_sample_stops_at_kmc_tpus_chunk(tmp_path, monkeypatch,
                                               max_bytes):
    """file_code_stream(max_bytes=...) yields kmc_tpu's chunks and stops
    after the same one (1 MiB chunks over two files of ~1.6 MiB)."""
    import kmc_tpu.io.readers as jax_readers
    import kmc_tpu_torch.io.readers as torch_readers

    for mod in (jax_readers, torch_readers):
        monkeypatch.setattr(mod, "CHUNK_BYTES", 1 << 20)
    paths = [write_fastq(tmp_path / f"in{i}.fastq",
                         random_reads(5000, 150, seed=i, genome_len=20000))
             for i in range(2)]
    got = list(torch_readers.file_code_stream(paths, "fastq",
                                              max_bytes=max_bytes))
    want = list(jax_readers.file_code_stream(paths, "fastq",
                                             max_bytes=max_bytes))
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
