"""The port's grouping sort against jax.lax.sort, exactly.

The plain version (what the kernel runs for CPU tensors) is held against
jax.lax.sort(num_keys=n), the contract of kmc_tpu's _grouping_sort.  So is
a plain emulation of the kernel's pass plan (sort_plan): stable sorts on
the extracted digits in the kernel's pass order, skipping each digit the
histogram shows constant, carrying the other columns as the kernel does
(whole rows, or a key word and a row index gathered at the end).  The CUDA
radix-sort kernel is held against the plain version in
tests/test_torch_kernels.py, on a card."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kmc_tpu_torch.ops.sort_kernel import (ROWS_MAX_COLS, TILE,
                                           radix_sort_columns,
                                           radix_sort_plain, sort_plan,
                                           work_bytes)


def _columns(n, n_keys, n_payload, seed, key_range=2**32):
    """Key columns with heavy duplicates and ~10% dead (all-ones) rows,
    payload columns with zero counts on dead rows."""
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, min(key_range, 2**32 - 1), n, dtype=np.uint32)
            for _ in range(n_keys)]
    if n_keys > 1:  # ties in the leading key: the later keys decide
        keys[0] = rng.integers(0, 8, n, dtype=np.uint32)
    dead = rng.random(n) < 0.1
    for c in keys:
        c[dead] = 0xFFFFFFFF
    pays = [rng.integers(1, 1000, n, dtype=np.uint32) for _ in range(n_payload)]
    for c in pays:
        c[dead] = 0
    return keys + pays


def _torch(cols):
    return [torch.from_numpy(c.view(np.int32).copy()) for c in cols]


@pytest.mark.parametrize("n,n_keys,n_payload,key_range", [
    (1, 1, 0, 2**32),
    (1000, 1, 1, 2**32),
    (3001, 2, 1, 2**32),
    (4097, 2, 1, 50),        # many equal (bin|k-mer) rows: compaction input
    (777, 3, 1, 2**32),
    (2048, 5, 0, 4),
    (1500, 9, 1, 3),
    (999, 17, 1, 2),
])
def test_plain_sort_matches_lax_sort(n, n_keys, n_payload, key_range):
    cols = _columns(n, n_keys, n_payload, seed=n + n_keys, key_range=key_range)
    ref = jax.lax.sort([jnp.asarray(c) for c in cols], num_keys=n_keys)
    got = radix_sort_columns(_torch(cols), n_keys)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(r))


def test_plain_sort_is_stable_and_handles_extremes():
    key = np.array([5, 0xFFFFFFFF, 0, 5, 0x80000000, 0x7FFFFFFF, 5],
                   dtype=np.uint32)
    pay = np.arange(len(key), dtype=np.uint32)
    k_out, p_out = radix_sort_plain(_torch([key, pay]), 1)
    assert k_out.numpy().view(np.uint32).tolist() == [
        0, 5, 5, 5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    assert p_out.numpy().tolist() == [2, 0, 3, 6, 5, 4, 1]


def test_wrapper_rejects_bad_input():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        radix_sort_columns([a, torch.zeros(7, dtype=torch.int32)], 1)
    with pytest.raises(ValueError):
        radix_sort_columns([a.to(torch.int64)], 1)
    with pytest.raises(ValueError):
        radix_sort_columns([a], 2)
    with pytest.raises(ValueError):
        radix_sort_columns([torch.zeros(16, dtype=torch.int32)[::2]], 1)



def emulate_plan(cols, n_keys):
    """The kernel's sort of u32 numpy columns, pass by pass: (sorted
    columns, number of live passes)."""
    passes, rows_mode = sort_plan(len(cols), n_keys)
    n = len(cols[0])

    def digit(key, shift, width):
        return (key >> np.uint32(shift)) & np.uint32((1 << width) - 1)

    # the histogram pass: a digit is constant in the input iff it is
    # constant at its pass (a pass only permutes rows)
    live = [len(np.unique(digit(cols[c], s, w))) > 1 for c, s, w in passes]
    if rows_mode:
        rows = list(cols)
        for (c, s, w), is_live in zip(passes, live):
            if is_live:
                order = np.argsort(digit(rows[c], s, w), kind="stable")
                rows = [r[order] for r in rows]
        return rows, sum(live)
    key, idx, prev = None, np.arange(n), None
    for (c, s, w), is_live in zip(passes, live):
        if not is_live:
            continue
        if c != prev:  # a new key column: through the row index
            key = cols[c][idx]
        order = np.argsort(digit(key, s, w), kind="stable")
        key, idx, prev = key[order], idx[order], c
    return [c[idx] for c in cols], sum(live)


def _plan_columns(n, n_keys, n_payload, kind, seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_keys)]
    if kind == "const_high":  # bins with few values in a high byte
        keys[0] = (keys[0] & np.uint32(0x0003FFFF)) | np.uint32(0x5A000000)
        for k in keys[1:]:
            k &= np.uint32(0x00FFFFFF)
    elif kind == "const_col":  # a whole key column constant
        keys[-1][:] = 0x12345678
        if n_keys > 2:
            keys[1][:] = 0
    elif kind == "ties":  # few distinct rows: the later keys decide
        keys = [rng.integers(0, 3, n, dtype=np.uint32) for _ in keys]
    if kind in ("dead", "const_high"):
        dead = rng.random(n) < 0.15
        for k in keys:
            k[dead] = 0xFFFFFFFF
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32)
            for _ in range(n_payload)]
    return keys + pays


@pytest.mark.parametrize("n_keys,n_payload", [(1, 0), (1, 1), (1, 2), (2, 0),
                                              (2, 1), (3, 0), (3, 1),
                                              (17, 0), (17, 1)])
@pytest.mark.parametrize("kind", ["random", "const_high", "const_col",
                                  "dead", "ties"])
def test_plan_emulation_matches_lax_sort(n_keys, n_payload, kind):
    n = 1000 if n_keys < 17 else 300
    cols = _plan_columns(n, n_keys, n_payload, kind,
                         seed=7 * n_keys + n_payload)
    got, _ = emulate_plan(cols, n_keys)
    ref = jax.lax.sort([jnp.asarray(c) for c in cols], num_keys=n_keys)
    for g, r in zip(got, ref):
        assert np.array_equal(g, np.asarray(r))


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1])
@pytest.mark.parametrize("n_keys,n_payload", [(2, 1), (4, 1)])
def test_plan_emulation_at_tile_edges(n, n_keys, n_payload):
    cols = _plan_columns(n, n_keys, n_payload, "dead", seed=n)
    got, _ = emulate_plan(cols, n_keys)
    ref = jax.lax.sort([jnp.asarray(c) for c in cols], num_keys=n_keys)
    want = radix_sort_plain(_torch(cols), n_keys)
    for g, r, w in zip(got, ref, want):
        assert np.array_equal(g, np.asarray(r))
        assert np.array_equal(g, w.numpy().view(np.uint32))


def test_plan_skips_constant_digits():
    """Live pass counts of 0, 1, 2 and 3: the parity cases of the card
    tests, where the result must end in the output buffer."""
    rng = np.random.default_rng(0)
    byte0 = rng.integers(0, 256, 5000, dtype=np.uint32)
    seven = np.full(5000, 7, dtype=np.uint32)
    for key1, want_live in ((seven, 0), (byte0, 1), (byte0 << 8 | byte0, 2),
                            (byte0 << 24 | byte0 << 8 | byte0, 3)):
        cols = [seven, key1, np.arange(5000, dtype=np.uint32)]
        got, n_live = emulate_plan(cols, 2)
        assert n_live == want_live
        ref = jax.lax.sort([jnp.asarray(c) for c in cols], num_keys=2)
        for g, r in zip(got, ref):
            assert np.array_equal(g, np.asarray(r))


def test_sort_plan_layout():
    passes, rows_mode = sort_plan(3, 2)
    assert passes == [(1, 0, 8), (1, 8, 8), (1, 16, 8), (1, 24, 8),
                      (0, 0, 8), (0, 8, 8), (0, 16, 8), (0, 24, 8)]
    assert rows_mode
    assert sort_plan(ROWS_MAX_COLS, 1)[1]
    assert not sort_plan(ROWS_MAX_COLS + 1, 1)[1]
    passes, rows_mode = sort_plan(18, 17)
    assert len(passes) == 68 and not rows_mode
    with pytest.raises(ValueError):
        sort_plan(2, 3)
    # one u64 status word per (tile, digit) dominates the work area
    assert work_bytes(1 << 26, 2, 8) >= -(-(1 << 26) // TILE) * 256 * 8
    assert work_bytes(1, 1, 4) % 256 == 0
