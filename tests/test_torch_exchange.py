"""The port's owner exchange (kmc_tpu_torch/parallel/exchange_kernel.py) on
the CPU against kmc_tpu's Pallas all-to-all kernels run in TPU interpret
mode on a 4-device CPU mesh: the delivered rows and the received row
counts must be equal, exactly.  The kernel's host-side plans (the tile
list each card's launch walks, and which process launches for which
owners) are checked here too: a NumPy walk of the tiles, copying as the
kernel does, must deliver what the plain version does."""
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
                                                    launch_plan,
                                                    ragged_all_to_all,
                                                    ragged_all_to_all_plain,
                                                    tile_list, tile_rows)

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


def walk_tiles(tiles, xs, outs, cap, C):
    """Copy as the kernel does: for each tile, rows * C words from the
    sender's flat buffer at (owner * cap + row0) * C to the owner's flat
    buffer at (sender * cap + row0) * C."""
    for o, s, r0, m in np.asarray(tiles, np.int64):
        src, dst = (o * cap + r0) * C, (s * cap + r0) * C
        outs[o][dst:dst + m * C] = xs[s][src:src + m * C]


def _counts(fill, cap, seed):
    rng = np.random.default_rng(seed)
    if fill == "random":
        n = rng.integers(0, cap + 1, size=(D, D))
        n[0, 1], n[1, 2] = 0, cap
        return n
    return np.full((D, D), {"zero": 0, "cap": cap, "12345": 12345}[fill])


_FILLS = ["zero", "cap", "12345", "random"]


@pytest.mark.parametrize("fill", _FILLS)
@pytest.mark.parametrize("cap,C", [(12347, 3), (1 << 14, 1), (1 << 14, 2),
                                   ((1 << 16) + 3, 3)])
def test_tile_list_covers_each_pair_once(fill, cap, C):
    """Every (owner, sender) row range of the plan's pairs exactly once, in
    tiles of tile_rows(C) rows (a multiple of 4), none past n[j][o]; tile 0
    of every non-empty pair first, in the pairs' order (so neighbouring
    tiles go to other owners)."""
    n = _counts(fill, cap, cap + C)
    pairs = [(o, s) for s in range(D) for o in range(D)]
    tiles = tile_list(n, pairs, C).astype(np.int64)
    rows = tile_rows(C)
    assert rows % 4 == 0 and 0 < rows * C <= 1 << 16
    assert tiles.shape == (int((-(-n // rows)).sum()), 4)
    assert (tiles[:, 3] > 0).all() and (tiles[:, 3] <= rows).all()
    for o, s in pairs:
        mine = tiles[(tiles[:, 0] == o) & (tiles[:, 1] == s)]
        mine = mine[np.argsort(mine[:, 2])]
        assert np.array_equal(mine[:, 2], np.arange(len(mine)) * rows)
        assert int(mine[:, 3].sum()) == n[s, o]
        assert (mine[:, 2] + mine[:, 3] <= n[s, o]).all()
    first = [(o, s) for o, s in pairs if n[s, o]]
    assert [tuple(t) for t in tiles[:len(first), :2]] == first


@pytest.mark.parametrize("fill", _FILLS)
@pytest.mark.parametrize("cap", [12347, 1 << 14])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_walk_tiles_matches_plain(fill, cap, C):
    """The tiles of every card's launch, walked in NumPy word by word as
    the kernel copies them, deliver ragged_all_to_all_plain's rows (one
    card; and four cards, one shard each)."""
    n = _counts(fill, cap, 7 * C + cap)
    rng = np.random.default_rng(C)
    x = rng.integers(0, 2**32, size=(D, D, cap, C), dtype=np.uint32)
    ref, _ = ragged_all_to_all_plain(_shards(x), n)
    for cards in ([0] * D, list(range(D))):
        outs = [np.zeros(D * cap * C, np.uint32) for _ in range(D)]
        for _, pairs in launch_plan(cards, [list(range(D))]).values():
            walk_tiles(tile_list(n, pairs, C), [x[j].reshape(-1)
                                                for j in range(D)],
                       outs, cap, C)
        for r in range(D):
            got = outs[r].reshape(D, cap, C)
            for j in range(D):
                m = int(n[j, r])
                assert np.array_equal(got[j, :m], _u32(ref[r])[j, :m])
                assert not got[j, m:].any()  # nothing past n[j][r]


# (shard cards, layout, {card: (launching rank, the senders it copies)})
_PLANS = [
    # two processes of two shards on one card: rank 0 launches for all
    (["c0"] * 4, [[0, 1], [2, 3]], {"c0": (0, [0, 1, 2, 3])}),
    # four processes on four cards: each launches for its own sender
    (["c0", "c1", "c2", "c3"], [[0], [1], [2], [3]],
     {f"c{i}": (i, [i]) for i in range(4)}),
    # four shards on one card in one process: one launch
    (["c0"] * 4, [[0, 1, 2, 3]], {"c0": (0, [0, 1, 2, 3])}),
    # mixed: rank 0 holds a shard on each card and leads both; rank 1's
    # sender on c1 and rank 2's on c0 are copied by rank 0's launches
    (["c0", "c1", "c1", "c0"], [[0, 1], [2], [3]],
     {"c0": (0, [0, 3]), "c1": (0, [1, 2])}),
    # mixed: ranks 1 and 2 share card c1, rank 1 leads it
    (["c0", "c1", "c1", "c2"], [[0], [1], [2, 3]],
     {"c0": (0, [0]), "c1": (1, [1, 2]), "c2": (2, [3])}),
]


@pytest.mark.parametrize("case", range(len(_PLANS)))
def test_launch_plan(case):
    """The lowest rank on a card launches once there, for every sender on
    the card and every owner (the owners alternating); the plan covers
    each (owner, sender) pair exactly once."""
    cards, layout, want = _PLANS[case]
    plan = launch_plan(cards, layout)
    assert list(plan) == list(want)
    seen = []
    for c, (leader, pairs) in plan.items():
        senders = sorted({s for _, s in pairs})
        assert (leader, senders) == want[c]
        assert pairs == [(o, s) for s in senders for o in range(D)]
        seen += pairs
    assert sorted(seen) == [(o, s) for o in range(D) for s in range(D)]
