"""The plain versions of the port's memory probes (kmc_tpu_torch.
microbench_sort) against jax.numpy on the tool's block shape, the `sort`
section on the CPU against jax.lax.sort on the tool's inputs, and the
roofline, bitonic, scatter and onehot sections' ops against NumPy (the
compare-exchange pass also against the tool's own jnp _ce_pass).

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
    assert mb.main(["nosuch", "--device=cpu"]) == 2


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


def _tool():
    """tools/microbench_sort.py, loaded by path (tools/ is no package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / \
        "microbench_sort.py"
    spec = importlib.util.spec_from_file_location("mb_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_ops_match_numpy():
    x = mb._rand_u32(1 << 12, "cpu")
    xu = _u32(x)
    assert np.array_equal(xu, np.random.default_rng(0).integers(
        0, 2**32, size=1 << 12, dtype=np.uint32))
    assert np.array_equal(_u32(mb.u32_add1(x)), xu + np.uint32(1))
    assert np.array_equal(_u32(mb.u32_cumsum(x)),
                          np.cumsum(xu, dtype=np.uint32))
    assert np.array_equal(_u32(mb.reverse(x)), xu[::-1])


@pytest.mark.parametrize("logn", [1, 5, 12])
def test_bitonic_ladder_matches_tool_and_merges(logn):
    N = 1 << logn
    x = mb._rand_u32(N, "cpu", seed=logn)
    iota = torch.arange(N, dtype=torch.int32)
    tool = _tool()
    ref, xj = [], jnp.asarray(_u32(x))
    iota_j = jnp.arange(N, dtype=jnp.uint32)
    for s in range(logn - 1, -1, -1):
        xj = tool._ce_pass(xj, 1 << s, iota_j)
        ref.append(np.asarray(xj))
    got = x
    for i, s in enumerate(range(logn - 1, -1, -1)):
        got = mb.ce_pass(got, 1 << s, iota)
        assert np.array_equal(_u32(got), ref[i]), s
    assert np.array_equal(_u32(mb.bitonic_ladder(x, iota)), ref[-1])
    # a bitonic sequence (ascending, then descending) merges into order
    u = np.sort(_u32(x))
    bitonic = np.concatenate([u[: N // 2], u[N // 2:][::-1]])
    merged = mb.bitonic_ladder(torch.from_numpy(bitonic.view(np.int32)),
                               iota)
    assert np.array_equal(_u32(merged), np.sort(bitonic))


def test_scatter_ops_match_numpy():
    N = 1 << 12
    x, idx, hi = mb.scatter_inputs(N, "cpu")
    xu, iu = _u32(x), idx.numpy()
    assert np.array_equal(iu, np.random.default_rng(4).permutation(N))
    want = np.zeros(N, np.uint32)
    want[iu] = xu
    assert np.array_equal(_u32(mb.scatter_perm(x, idx)), want)
    assert np.array_equal(_u32(mb.gather_perm(x, idx)), xu[iu])
    hist = mb.scatter_add_histogram(hi).numpy()
    assert np.array_equal(hist, np.bincount(iu & 0xFFFF,
                                            minlength=mb.HIST_BINS))


def test_onehot_permute_matches_numpy():
    perm, vals = mb.onehot_inputs(1 << 12, "cpu")
    assert tuple(perm.shape) == (16, 256) and tuple(vals.shape) == (16, 256,
                                                                     8)
    assert all(sorted(row) == list(range(256)) for row in perm.tolist())
    got = mb.onehot_permute(perm, vals).numpy()
    want = np.take_along_axis(vals.numpy(), perm.numpy()[:, :, None].astype(
        np.int64), axis=1)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("section,labels", [
    ("roofline", ["elementwise add (r+w)", "cumsum u32", "reverse (r+w)"]),
    ("bitonic", ["bitonic merge ladder (12 passes)",
                 "single compare-exchange pass"]),
    ("scatter", ["XLA scatter (full permutation)",
                 "XLA gather (full permutation)",
                 "XLA scatter-add histogram (64K bins)"]),
    ("onehot", ["one-hot matmul permute 256-tiles (8B rows)"]),
])
def test_other_sections_run_on_cpu_when_asked(capsys, monkeypatch, section,
                                              labels):
    monkeypatch.setenv("MB_LOGN", "12")
    assert mb.main([section, "--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["device=cpu", f"--- {section} ---"]
    for label in labels:
        assert any(line.startswith(label) and "n=2^12" in line
                   for line in lines), label
    got = mb.SECTIONS[section](1 << 12, device="cpu")
    assert list(got) == labels
    assert all(row["n"] == 1 << 12 and row["ms"] > 0 for row in got.values())
