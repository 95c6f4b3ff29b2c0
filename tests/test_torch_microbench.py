"""The plain versions of the port's memory probes (kmc_tpu_torch.
microbench_sort) against jax.numpy on the tool's block shape, and the
`sort` section on the CPU against jax.lax.sort on the tool's inputs.

tools/microbench_sort.py's Pallas bodies (copy_kernel, gather_kernel,
gatherl_kernel) are closures inside sec_pallas and cannot be imported, so
each is held here through the jnp expression its body evaluates on one
(1024, 1024) block: x + 1, jnp.take(axis=0) and jnp.take(axis=1).  The CUDA
probes are held against these plain versions in tests/test_torch_kernels.py,
on a card."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kmc_tpu_torch import microbench_sort as mb
from kmc_tpu_torch.ops.sort_kernel import radix_sort_columns

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
    assert mb.main(["bitonic", "--device=cpu"]) == 2


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


def test_sort_section_runs_on_cpu_when_asked(capsys, monkeypatch):
    monkeypatch.setenv("MB_LOGN", "14")
    assert mb.main(["sort", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["device=cpu", "--- sort ---"]
    for label in ("2 u32 keys", "1 u32 key + 1 payload", "1 u32 key alone",
                  "u32(8-bit values) + payload", "pre-sorted 1 key"):
        assert any(line.startswith(f"radix_sort {label}") and "n=2^14" in line
                   and "GB/s" in line for line in lines), label
        assert any(line.startswith(f"  {label}: kernel_ms")
                   and "library_ms" in line for line in lines), label


def test_sort_section_shapes():
    got = mb.sec_sort(1 << 12, device="cpu")
    assert list(got) == ["2 u32 keys n=2^12", "1 u32 key + 1 payload n=2^12",
                         "1 u32 key alone n=2^12",
                         "u32(8-bit values) + payload n=2^12",
                         "pre-sorted 1 key n=2^12"]
    for row in got.values():
        assert row["n"] == 1 << 12 and row["ms"] > 0 and row["bound_ms"] > 0


def test_sort_section_inputs_and_order_match_lax_sort():
    a, b = mb._u32_cols(1 << 12, "cpu")
    for seed, col in ((0, a), (1, b)):
        want = np.random.default_rng(seed).integers(0, 2**32, size=1 << 12,
                                                     dtype=np.uint32)
        assert np.array_equal(_u32(col), want)
    got = radix_sort_columns([a, b], 2)
    ref = jax.lax.sort([jnp.asarray(_u32(a)), jnp.asarray(_u32(b))],
                       num_keys=2)
    for g, r in zip(got, ref):
        assert np.array_equal(_u32(g), np.asarray(r))
    packed = mb._packed_key(a, b)
    order = torch.sort(packed).indices
    assert torch.equal(a[order], got[0]) and torch.equal(b[order], got[1])
