"""The plain versions of the port's memory probes (kmc_tpu_torch.
microbench_sort) against jax.numpy on the tool's block shape.

tools/microbench_sort.py's Pallas bodies (copy_kernel, gather_kernel,
gatherl_kernel) are closures inside sec_pallas and cannot be imported, so
each is held here through the jnp expression its body evaluates on one
(1024, 1024) block: x + 1, jnp.take(axis=0) and jnp.take(axis=1).  The CUDA
probes are held against these plain versions in tests/test_torch_kernels.py,
on a card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmc_tpu_torch import microbench_sort as mb

N = 1 << 21  # two (1024, 1024) blocks


@pytest.fixture(scope="module")
def inputs():
    return mb.probe_inputs(N, "cpu")


def _u32(t):
    return t.numpy().view(np.uint32)


def _blocks(x):
    return [jnp.asarray(x[b * 1024:(b + 1) * 1024])
            for b in range(x.shape[0] // 1024)]


def test_inputs_match_the_tool(inputs):
    x, idx, idxl = inputs
    assert x.shape == (N // 1024, 1024) and x.dtype == torch.int32
    want = np.random.default_rng(0).integers(0, 2**32, size=N,
                                             dtype=np.uint32)
    assert np.array_equal(_u32(x).ravel(), want)
    assert sorted(idx.tolist()) == sorted(idxl.tolist()) == list(range(1024))


@pytest.mark.parametrize("fn", [mb.probe_add1, mb.probe_add1_plain])
def test_add1_matches_jnp(inputs, fn):
    x = inputs[0]
    got = _u32(fn(x))
    want = np.concatenate([np.asarray(b + jnp.uint32(1))
                           for b in _blocks(_u32(x))])
    assert np.array_equal(got, want)
    edge = torch.tensor([[-1, 2**31 - 1] * 512], dtype=torch.int32)
    assert np.array_equal(_u32(fn(edge))[0, :2], [0, 2**31])


@pytest.mark.parametrize("fn", [mb.probe_gather_rows,
                                mb.probe_gather_rows_plain])
def test_gather_rows_matches_jnp_take_axis0(inputs, fn):
    x, idx, _ = inputs
    got = _u32(fn(x, idx))
    want = np.concatenate([np.asarray(jnp.take(b, jnp.asarray(idx.numpy()),
                                               axis=0))
                           for b in _blocks(_u32(x))])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fn", [mb.probe_gather_lanes,
                                mb.probe_gather_lanes_plain])
def test_gather_lanes_matches_jnp_take_axis1(inputs, fn):
    x, _, idxl = inputs
    got = _u32(fn(x, idxl))
    want = np.concatenate([np.asarray(jnp.take(b, jnp.asarray(idxl.numpy()),
                                               axis=1))
                           for b in _blocks(_u32(x))])
    assert np.array_equal(got, want)


def test_section_runs_on_cpu_when_asked(capsys, monkeypatch):
    monkeypatch.setenv("MB_LOGN", "20")
    assert mb.main(["pallas", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device=cpu"
    for name in ("probe_add1", "probe_gather_rows", "probe_gather_lanes"):
        assert any(line.startswith(name) and "n=2^20" in line
                   and "GB/s" in line for line in lines), name
    assert mb.main(["sort", "--device=cpu"]) == 2


def test_section_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mb.main(["pallas"])


def test_bad_shapes_raise(inputs):
    x, idx, _ = inputs
    with pytest.raises(ValueError):
        mb.probe_gather_rows(x[:1000], idx)
    with pytest.raises(ValueError):
        mb.probe_gather_lanes(x, idx[:10])
    with pytest.raises(ValueError):
        mb.probe_add1(x.view(-1))
