"""The port's SPMD count step (kmc_tpu_torch.parallel.distributed.
make_distributed_count_step) on 8 CPU shards against kmc_tpu's on the
8-device CPU mesh that tests/conftest.py sets up: every shard's (words,
counts, n_out, n_dropped) bit for bit, and the twins of
tests/test_distributed.py."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_distributed import reads_to_code_batches  # noqa: E402
from util import random_reads  # noqa: E402

from kmc_tpu import oracle  # noqa: E402
from kmc_tpu.formats.kmc_db import kmers_bytes_to_strings  # noqa: E402
from kmc_tpu.parallel.distributed import (  # noqa: E402
    make_distributed_count_step as jax_make_step, make_mesh)
from kmc_tpu.signatures import build_signature_map, map_size  # noqa: E402
from kmc_tpu_torch.parallel.distributed import (  # noqa: E402
    make_distributed_count_step)
from kmc_tpu_torch.runner import words_to_kmer_bytes  # noqa: E402

D = 8
S = 1 << 10
M = 7


def _sig_map(sig_len=M):
    sig_map = build_signature_map(np.zeros(map_size(sig_len), np.uint64),
                                  sig_len, 64)
    return np.where(sig_map < 0, sig_map.max(), sig_map).astype(np.int32)


def _u32(t):
    return t.numpy().view(np.uint32)


def _port_counts(step, codes, sig_map, k):
    """{k-mer: count} over every round and shard, and the owner of each."""
    got, owner_of = {}, {}
    for r in range(codes.shape[0] // D):
        words, counts, n_out, n_dropped = step(codes[r * D:(r + 1) * D],
                                               sig_map)
        assert sum(int(x) for x in n_dropped) == 0
        for d in range(D):
            n = int(n_out[d])
            kb = words_to_kmer_bytes(_u32(words[d][:n]), k)
            for s_km, c in zip(kmers_bytes_to_strings(kb, k),
                               _u32(counts[d][:n])):
                got[s_km] = got.get(s_km, 0) + int(c)
                assert owner_of.setdefault(s_km, d) == d
    return got


@pytest.mark.parametrize("k,capacity,n_reads", [
    (21, S, 64), (33, S, 64), (21, None, 150), (55, S, 64),
    # segments of 40 rows: every busy sender drops rows
    (21, 40, 64), (33, 40, 150)])
def test_step_equals_kmc_tpus(k, capacity, n_reads):
    assert len(jax.devices()) == D
    reads = random_reads(n_reads, 100, seed=42, genome_len=600)
    codes = reads_to_code_batches(reads, S, k, D)
    sig_map = _sig_map()
    jstep, jcap = jax_make_step(make_mesh(), s=S, k=k, sig_len=M,
                                both_strands=True, capacity=capacity)
    step, cap = make_distributed_count_step(["cpu"] * D, s=S, k=k,
                                            sig_len=M, both_strands=True,
                                            capacity=capacity)
    assert cap == jcap
    n_dropped_all = 0
    for r in range(codes.shape[0] // D):
        batch = codes[r * D:(r + 1) * D]
        jw, jc, jn, jd = (np.asarray(x) for x in jstep(batch, sig_map))
        words, counts, n_out, n_dropped = step(batch, sig_map)
        W = (k + 15) // 16
        for d in range(D):
            assert words[d].shape == (D * cap, W)
            assert np.array_equal(_u32(words[d]), jw[d])
            assert np.array_equal(_u32(counts[d]), jc[d])
            assert int(n_out[d]) == int(jn[d])
            assert int(n_dropped[d]) == int(jd[d])
        n_dropped_all += int(jd.sum())
    assert (n_dropped_all > 0) == (capacity == 40)


@pytest.mark.parametrize("k", [21, 33])
def test_step_matches_oracle(k):
    reads = random_reads(64, 100, seed=42, genome_len=600)
    codes = reads_to_code_batches(reads, S, k, D)
    step, _ = make_distributed_count_step(["cpu"] * D, s=S, k=k, sig_len=M,
                                          capacity=S)
    assert _port_counts(step, codes, _sig_map(), k) == \
        dict(oracle.count_kmers(reads, k))


def test_owner_partition_consistency():
    """The same k-mer always lands on the same owner (a list of tensors as
    the batches, and the map as a tensor)."""
    import torch

    k = 21
    reads = random_reads(48, 90, seed=5, genome_len=400)
    codes = reads_to_code_batches(reads, S, k, D)
    step, _ = make_distributed_count_step(["cpu"] * D, s=S, k=k, sig_len=M,
                                          capacity=S)
    batches = torch.from_numpy(codes)
    got = _port_counts(step, batches, torch.from_numpy(_sig_map()), k)
    assert sum(got.values()) == sum(oracle.count_kmers(reads, k).values())


def test_default_capacity_and_shard_count():
    step, cap = make_distributed_count_step(["cpu"] * 4, s=1 << 12, k=27,
                                            sig_len=9)
    assert cap == max(64, ((1 << 12) // 4) * 2)
    assert make_distributed_count_step(["cpu"] * 4, s=64, k=27,
                                       sig_len=9)[1] == 64
    with pytest.raises(ValueError, match="one batch per shard"):
        step([np.zeros(8, np.uint8)] * 3, _sig_map(9))
