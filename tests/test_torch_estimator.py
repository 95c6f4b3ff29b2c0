"""The ntCard estimator (-e, --opt-out-size) on the port against kmc_tpu,
on the CPU: the canonical ntHash of every window, the -e histogram at one
and at several reader threads (the estimator hashes each parsed chunk
alone, so the chunks must be kmc_tpu's), the --opt-out-size databases and
the CLI's histogram file."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import kmc_tpu.cli as jax_cli  # noqa: E402
import kmc_tpu_torch.cli as torch_cli  # noqa: E402
from kmc_tpu.ops import nthash as jax_nthash  # noqa: E402
from kmc_tpu.runner import EstimateHistogramCfg as JaxEstimate  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import EstimateHistogramCfg, count  # noqa: E402
from kmc_tpu_torch.ops.nthash import nthash_canonical  # noqa: E402


@pytest.mark.parametrize("k", [1, 21, 27, 33, 64])
def test_nthash_canonical_matches_kmc_tpu(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 5000).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.005] = 4
    h, valid = nthash_canonical(torch.from_numpy(codes), k)
    want_h, want_valid = jax_nthash.nthash_canonical(codes, k)
    assert np.array_equal(valid.numpy(), want_valid)
    assert np.array_equal(h.numpy().view(np.uint64), want_h)
    assert nthash_canonical(torch.from_numpy(codes[:k - 1]), k)[0].numel() == 0


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("est")
    return write_fastq(d / "in.fastq", random_reads(2000, 150, seed=9,
                                                    n_prob=0.002,
                                                    genome_len=20000))


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("hc", [False, True])
def test_estimated_histogram_matches_kmc_tpu(fastq, tmp_path, n_threads, hc):
    kw = dict(n_threads=n_threads, homopolymer_compressed=hc)
    j1, j2 = jax_count([fastq], str(tmp_path / "jax"), k=25,
                       estimate_histogram_cfg=JaxEstimate.ONLY_ESTIMATE, **kw)
    t1, t2 = count([fastq], str(tmp_path / "torch"), k=25, device="cpu",
                   estimate_histogram_cfg=EstimateHistogramCfg.ONLY_ESTIMATE,
                   **kw)
    assert t1.estimated_histogram == j1.estimated_histogram
    assert sum(t1.estimated_histogram) > 0
    assert t1.n_sequences == j1.n_sequences == 2000
    assert t2.n_total_kmers == j2.n_total_kmers == 0
    assert not list(tmp_path.glob("torch*"))


@pytest.mark.parametrize("device_store", [True, False])
def test_opt_out_size_db_byte_identical(fastq, tmp_path, device_store):
    kw = dict(cutoff_min=2, device_store=device_store,
              batch_positions=1 << 14)
    j1, _ = jax_count(
        [fastq], str(tmp_path / "jax"), k=27,
        estimate_histogram_cfg=JaxEstimate.ESTIMATE_AND_COUNT_KMERS, **kw)
    t1, _ = count(
        [fastq], str(tmp_path / "torch"), k=27, device="cpu",
        estimate_histogram_cfg=EstimateHistogramCfg.ESTIMATE_AND_COUNT_KMERS,
        **kw)
    assert t1.estimated_histogram == j1.estimated_histogram
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"torch{suf}").read_bytes() == \
            (tmp_path / f"jax{suf}").read_bytes(), suf


@pytest.mark.parametrize("args", [["-e"], ["-e", "-t1", "-k31"],
                                  ["--opt-out-size", "-ci1"]])
def test_cli_estimate_identical(fastq, tmp_path, args):
    """The -e histogram file (and the --opt-out-size database), with the
    -j summaries."""
    import json

    base = ["-k27", "-hp", "-S16384"]
    out = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("torch", torch_cli, ["--device=cpu"])):
        assert cli.main(base + args + extra + [
            f"-j{tmp_path / (name + '.json')}", fastq, str(tmp_path / name),
            str(tmp_path)]) == 0
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        for key in ("1st_stage", "2nd_stage", "Total"):
            doc.pop(key)
        out[name] = doc
    assert out["torch"] == out["jax"]
    sufs = [""] if "-e" in args else [".kmc_pre", ".kmc_suf"]
    for suf in sufs:
        got = (tmp_path / f"torch{suf}").read_bytes()
        assert got == (tmp_path / f"jax{suf}").read_bytes()
        assert got
