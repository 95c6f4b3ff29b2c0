"""The port's owner exchange (kmc_tpu_torch/parallel/exchange_kernel.py) on
the CPU against kmc_tpu's Pallas all-to-all kernels run in TPU interpret
mode on a 4-device CPU mesh: the delivered rows and the received row
counts must be equal, exactly."""
import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

from kmc_tpu.parallel.pallas_a2a import (pallas_all_to_all,
                                         pallas_ragged_all_to_all)
from kmc_tpu_torch.parallel.exchange_kernel import (all_to_all,
                                                    all_to_all_plain,
                                                    ragged_all_to_all,
                                                    ragged_all_to_all_plain)

D = 4


def _mesh():
    return Mesh(np.array(jax.devices()[:D]), ("d",))


def _jax_ragged(x, n_rows, chunk):
    def body(xs, ns):
        out, rr = pallas_ragged_all_to_all(
            xs[0], ns[0], axis="d", chunk=chunk, transport="pallas",
            interpret=pltpu.InterpretParams())
        return out[None], rr[None]

    f = jax.jit(jax.shard_map(
        body, mesh=_mesh(),
        in_specs=(P("d", None, None, None), P("d", None)),
        out_specs=(P("d", None, None, None), P("d", None))))
    out, rr = f(x, n_rows)
    return np.asarray(out), np.asarray(rr)


def _jax_dense(x):
    def body(xs):
        return pallas_all_to_all(xs[0], axis="d", transport="pallas",
                                 interpret=pltpu.InterpretParams())[None]

    spec = P("d", None, None, None)
    f = jax.jit(jax.shard_map(body, mesh=_mesh(), in_specs=(spec,),
                              out_specs=spec))
    return np.asarray(f(x))


def _shards(x):
    """numpy uint32[D, D, cap, C] -> the port's per-shard int32 tensors."""
    return [torch.from_numpy(np.ascontiguousarray(x[j]).view(np.int32))
            for j in range(D)]


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("C", [1, 3])
def test_ragged_plain_matches_pallas_interpret(C):
    cap, chunk = 1024, 256
    rng = np.random.default_rng(C)
    x = rng.integers(0, 2**32, size=(D, D, cap, C), dtype=np.uint32)
    n_rows = rng.integers(0, cap + 1, size=(D, D)).astype(np.int32)
    n_rows[0, 1] = 0        # an empty segment
    n_rows[1, 2] = cap      # a full one
    n_rows[2, 3] = chunk + 7  # not a multiple of the chunk
    n_rows[3, 0] = 1
    ref, ref_rr = _jax_ragged(x, n_rows, chunk)
    for fn in (ragged_all_to_all, ragged_all_to_all_plain):
        outs, rr = fn(_shards(x), n_rows)
        assert np.array_equal(rr, ref_rr)
        assert np.array_equal(rr, n_rows.T)
        for r in range(D):
            got = _u32(outs[r])
            for j in range(D):
                m = int(rr[r, j])
                assert np.array_equal(got[j, :m], ref[r, j, :m]), (r, j)


def test_dense_plain_matches_pallas_interpret():
    cap, C = 16, 3
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2**32, size=(D, D, cap, C), dtype=np.uint32)
    ref = _jax_dense(x)
    for fn in (all_to_all, all_to_all_plain):
        outs = fn(_shards(x))
        for r in range(D):
            assert np.array_equal(_u32(outs[r]), ref[r])


def test_cpu_shards_take_the_plain_version():
    x = np.arange(D * D * 8 * 2, dtype=np.uint32).reshape(D, D, 8, 2)
    before = (ragged_all_to_all.launches, all_to_all.launches)
    ragged_all_to_all(_shards(x), np.full((D, D), 3))
    all_to_all(_shards(x))
    assert (ragged_all_to_all.launches, all_to_all.launches) == before


def _bad_inputs():
    good = [torch.zeros((D, 8, 2), dtype=torch.int32) for _ in range(D)]
    strided = [torch.zeros((D, 8, 4), dtype=torch.int32)[:, :, ::2]
               for _ in range(D)]
    wrong_dtype = good[:-1] + [torch.zeros((D, 8, 2), dtype=torch.int64)]
    mixed = good[:-1] + [torch.zeros((D, 8, 2), dtype=torch.int32,
                                     device="meta")]
    return [(strided, "contiguous"), (wrong_dtype, "int32"),
            (mixed, "mixed device types")]


@pytest.mark.parametrize("case", range(3))
def test_wrapper_rejects_bad_shards(case):
    xs, msg = _bad_inputs()[case]
    with pytest.raises(ValueError, match=msg):
        ragged_all_to_all(xs, np.zeros((D, D), np.int32))
    with pytest.raises(ValueError, match=msg):
        all_to_all(xs)


def test_wrapper_rejects_bad_counts():
    xs = [torch.zeros((D, 8, 2), dtype=torch.int32) for _ in range(D)]
    with pytest.raises(ValueError, match="cap"):
        ragged_all_to_all(xs, np.full((D, D), 9))
    with pytest.raises(ValueError, match=r"\[D=4\]\[D\]"):
        ragged_all_to_all(xs, np.zeros((D, D - 1), np.int32))
