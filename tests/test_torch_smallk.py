"""Small-k (k <= 13) on the port against kmc_tpu, on the CPU: the dense
histogram of a batch, and the KMC1 / KFF files and results of whole
counts, canonical and forward-only, with and without counters."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from kmc_tpu.io.native import pack_codes  # noqa: E402
from kmc_tpu.ops.smallk import (smallk_batch_packed,  # noqa: E402
                                smallk_histogram_shape)
from kmc_tpu.runner import EstimateHistogramCfg as JaxEstimate  # noqa: E402
from kmc_tpu.runner import OutputFileType as JaxOutputFileType  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import (EstimateHistogramCfg, OutputFileType,  # noqa: E402
                           count)
from kmc_tpu_torch.formats.kmc_db import pick_lut_prefix_len  # noqa: E402
from kmc_tpu_torch.io.native import pack_codes_fused  # noqa: E402
from kmc_tpu_torch.io.readers import batch_len  # noqa: E402
from kmc_tpu_torch.ops.smallk import (smallk_batch,  # noqa: E402
                                      smallk_histogram_size)

_TIMES = {"time", "time_strict_mem", "time_finalize_exec", "time_finalize_d2h"}


def _no_times(res):
    return {k: v for k, v in dataclasses.asdict(res).items()
            if k not in _TIMES}


@pytest.mark.parametrize("k", [1, 5, 9, 13])
@pytest.mark.parametrize("both", [True, False])
def test_smallk_batch_matches_kmc_tpu(k, both):
    s = 1 << 12
    rng = np.random.default_rng(k)
    hist_t = torch.zeros(smallk_histogram_size(k), dtype=torch.int64)
    hist_j = jnp.zeros(smallk_histogram_shape(k), jnp.uint32)
    for _ in range(2):  # two batches accumulate
        codes = rng.integers(0, 4, batch_len(s, k)).astype(np.uint8)
        codes[rng.random(len(codes)) < 0.02] = 4
        smallk_batch(torch.from_numpy(pack_codes_fused(codes)), hist_t, s=s,
                     k=k, both_strands=both)
        packed, mask = pack_codes(codes)
        hist_j = smallk_batch_packed(packed, mask, hist_j, s=s, k=k,
                                     both_strands=both)
    assert np.array_equal(hist_t.numpy(), np.asarray(hist_j).astype(np.int64))
    assert int(hist_t.sum()) == 2 * s


def test_kmc1_lut_prefix_len_matches_kmc_tpu():
    from kmc_tpu.formats.kmc_db import pick_lut_prefix_len as jax_pick

    for k in range(1, 14):
        for n in (0, 10, 10**4, 10**7):
            assert pick_lut_prefix_len(k, 1, n, kmc1=True) == \
                jax_pick(k, 1, n, kmc1=True)
            if k >= 2:
                assert pick_lut_prefix_len(k, 64, n) == jax_pick(k, 64, n)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("smallk")
    return write_fastq(d / "in.fastq", random_reads(300, 90, seed=11,
                                                    n_prob=0.01,
                                                    genome_len=4000))


@pytest.mark.parametrize("k,kw", [
    (1, dict(cutoff_min=1)),
    (1, dict(cutoff_min=1, output_file_type=OutputFileType.KFF)),
    (4, dict(cutoff_min=1)),  # lut_prefix_len == k: no suffix bytes
    (5, dict(cutoff_min=2, canonical_kmers=False)),
    (5, dict(cutoff_min=1, cutoff_max=30, counter_max=20,
             output_file_type=OutputFileType.KFF)),
    (9, dict(cutoff_min=1, counter_max=1)),  # counter_size 0
    (9, dict(cutoff_min=2, output_file_type=OutputFileType.KFF,
             canonical_kmers=False)),
    (13, dict(cutoff_min=1)),
    (13, dict(cutoff_min=2, output_file_type=OutputFileType.KFF)),
])
def test_smallk_count_byte_identical(fastq, tmp_path, k, kw):
    jkw = dict(kw)
    if "output_file_type" in kw:
        jkw["output_file_type"] = JaxOutputFileType[kw["output_file_type"].name]
    j1, j2 = jax_count([fastq], str(tmp_path / "jax"), k=k,
                       batch_positions=1 << 12, **jkw)
    t1, t2 = count([fastq], str(tmp_path / "torch"), k=k, device="cpu",
                   batch_positions=1 << 12, **kw)
    assert _no_times(t1) == _no_times(j1)
    assert _no_times(t2) == _no_times(j2)
    assert t1.was_small_k_opt_used and t2.n_total_kmers > 0
    sufs = ([".kff"] if kw.get("output_file_type") == OutputFileType.KFF
            else [".kmc_pre", ".kmc_suf"])
    for suf in sufs:
        assert (tmp_path / f"torch{suf}").read_bytes() == \
            (tmp_path / f"jax{suf}").read_bytes(), suf


def test_smallk_without_output(fastq, tmp_path):
    _, j2 = jax_count([fastq], str(tmp_path / "jax"), k=7, cutoff_min=2,
                      without_output=True, batch_positions=1 << 12)
    _, t2 = count([fastq], str(tmp_path / "torch"), k=7, cutoff_min=2,
                  without_output=True, device="cpu", batch_positions=1 << 12)
    assert _no_times(t2) == _no_times(j2)
    assert t2.n_below_cutoff_min > 0
    assert not list(tmp_path.glob("torch*"))


@pytest.mark.parametrize("k", [9, 13])
def test_estimate_with_small_k_raises(fastq, tmp_path, k):
    with pytest.raises(ValueError, match="small-k"):
        jax_count([fastq], str(tmp_path / "jax"), k=k,
                  estimate_histogram_cfg=JaxEstimate.ONLY_ESTIMATE)
    with pytest.raises(ValueError, match="small-k"):
        count([fastq], str(tmp_path / "torch"), k=k, device="cpu",
              estimate_histogram_cfg=EstimateHistogramCfg.ONLY_ESTIMATE)
