"""The port's splitter scan and feed decodes against kmc_tpu's, exactly.

The plain version (what the kernel runs for CPU tensors) is held against
kmc_tpu.ops.extract (position_sigs + _kmer_words) and once against the TPU
kernel pallas_extract2d in interpret mode.  The CUDA kernel is held against
the plain version in tests/test_torch_kernels.py, on a card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmc_tpu.ops.extract import _kmer_words, _unpack_device, position_sigs
from kmc_tpu.ops.store import _unpack_boundaries as jax_unpack_boundaries
from kmc_tpu.io.native import pack_codes, pack_codes_boundaries
from kmc_tpu_torch.io.readers import batch_len
from kmc_tpu_torch.ops.extract import _unpack_device as torch_unpack_device
from kmc_tpu_torch.ops.extract_kernel import (extract_splitter_scan,
                                              extract_splitter_scan_1d,
                                              splitter_scan_plain)
from kmc_tpu_torch.ops.ingest_kernel import _unpack_boundaries

M = 9


def _codes(s, k, seed, n_rate):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, batch_len(s, k)).astype(np.uint8)
    codes[rng.random(len(codes)) < n_rate] = 4
    return codes


def _jax_reference(codes, s, k, both):
    c = jnp.asarray(codes, jnp.uint32)
    bad = (c >= 4).astype(jnp.int32)
    valid, sig, p, q = position_sigs(jnp.minimum(c, 3), bad, s=s, k=k,
                                     sig_len=M)
    words = [np.asarray(jnp.where(valid, w, jnp.uint32(0xFFFFFFFF)))
             for w in _kmer_words(p, q, k, s, both)]
    return np.asarray(sig), np.stack(words)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [14, 16, 17, 27, 31, 32, 33, 55, 129, 256])
@pytest.mark.parametrize("both,n_rate", [(True, 0.01), (True, 0.3),
                                         (False, 0.01)])
def test_plain_scan_matches_kmc_tpu(k, both, n_rate):
    s = 2048
    codes = _codes(s, k, seed=k, n_rate=n_rate)
    sig, lanes = splitter_scan_plain(torch.from_numpy(codes), s=s, k=k,
                                     sig_len=M, both_strands=both)
    ref_sig, ref_lanes = _jax_reference(codes, s, k, both)
    assert np.array_equal(_u32(sig), ref_sig)
    assert np.array_equal(_u32(lanes), ref_lanes)
    if n_rate < 0.1:
        assert (ref_sig != 0xFFFFFFFF).any()


def test_plain_scan_matches_pallas_extract2d_interpret():
    from kmc_tpu.ops.pallas_extract import (pallas2d_align, pallas2d_batch_len,
                                            pallas_extract2d)

    k = 27
    s = pallas2d_align(k)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 5, max(pallas2d_batch_len(s, k),
                                   batch_len(s, k))).astype(np.uint8)
    outs = pallas_extract2d(jnp.asarray(codes), s=s, k=k, sig_len=M,
                            both_strands=True, interpret=True)
    sig, lanes = splitter_scan_plain(torch.from_numpy(codes), s=s, k=k,
                                     sig_len=M, both_strands=True)
    assert np.array_equal(_u32(sig), np.asarray(outs[0]))
    assert np.array_equal(_u32(lanes), np.stack([np.asarray(o)
                                                 for o in outs[1:]]))


@pytest.mark.parametrize("k", [21, 27, 32, 33])
@pytest.mark.parametrize("both", [True, False])
def test_scan_1d_plain_matches_pallas_extract_interpret(k, both):
    """The 1-D entry's plain version against the TPU kernel pallas_extract
    in interpret mode (exact there; its compiled TPU build miscompiles), on
    the inputs tests/test_pallas_extract.py gives it."""
    from kmc_tpu.ops.pallas_extract import (TILE, pallas_batch_len,
                                            pallas_extract)

    s = TILE * 2
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, pallas_batch_len(s, k)).astype(np.uint8)
    outs = pallas_extract(jnp.asarray(codes), s=s, k=k, sig_len=M,
                          both_strands=both, interpret=True)
    sig, lanes = extract_splitter_scan_1d(torch.from_numpy(codes), s=s, k=k,
                                          sig_len=M, both_strands=both)
    assert len(lanes) == len(outs) - 1 == (k + 15) // 16
    assert np.array_equal(_u32(sig), np.asarray(outs[0]))
    for got, want in zip(lanes, outs[1:]):
        assert got.shape == (s,)
        assert np.array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("kw", [
    dict(s=1 << 15, k=27),         # not a multiple of the 65536 tile
    dict(s=1 << 16, k=2048 - 15),  # k + 16 past the 2048-code halo
    dict(s=1 << 16, k=27, n=(1 << 16) + 2047),  # halo cut short
])
def test_scan_1d_contract_raises(kw):
    kw = dict(kw)
    n = kw.pop("n", kw["s"] + 2048)
    with pytest.raises(ValueError):
        extract_splitter_scan_1d(torch.zeros(n, dtype=torch.uint8),
                                 sig_len=M, both_strands=True, **kw)


@pytest.mark.parametrize("k,n_rate", [(27, 0.01), (33, 0.0), (55, 0.012)])
def test_boundary_decode_matches_kmc_tpu(k, n_rate):
    s = 4096
    codes = _codes(s, k, seed=100 + k, n_rate=n_rate)
    codes[-40:] = 4  # a trailing sentinel run becomes tail_start
    buf, ts = pack_codes_boundaries(codes)
    assert buf is not None
    c4_j, bad_j = jax_unpack_boundaries(jnp.asarray(buf), jnp.int32(ts),
                                        s=s, k=k)
    c4_t, bad_t = _unpack_boundaries(torch.from_numpy(buf), ts, s=s, k=k)
    assert np.array_equal(c4_t.numpy(), np.asarray(c4_j))
    assert np.array_equal(bad_t.numpy(), np.asarray(bad_j))
    assert np.array_equal(bad_t.numpy().astype(bool), codes >= 4)


def test_fused_feed_decode_matches_kmc_tpu():
    codes = _codes(4096, 27, seed=3, n_rate=0.2)
    packed, mask = pack_codes(codes)
    c4_j, bad_j = _unpack_device(jnp.asarray(packed), jnp.asarray(mask))
    c4_t, bad_t = torch_unpack_device(torch.from_numpy(packed),
                                      torch.from_numpy(mask))
    assert np.array_equal(c4_t.numpy(), np.asarray(c4_j))
    assert np.array_equal(bad_t.numpy(), np.asarray(bad_j))


def test_wrapper_rejects_bad_input():
    codes = torch.zeros(batch_len(64, 27), dtype=torch.uint8)
    with pytest.raises(ValueError):
        extract_splitter_scan(codes.to(torch.int32), s=64, k=27, sig_len=M,
                              both_strands=True)
    with pytest.raises(ValueError):
        extract_splitter_scan(codes[:-8], s=64, k=27, sig_len=M,
                              both_strands=True)
    with pytest.raises(ValueError):
        extract_splitter_scan(codes, s=60, k=27, sig_len=M, both_strands=True)

