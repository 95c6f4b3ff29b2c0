"""Counting across several nodes in the port (A11e), on the CPU.

The exchange splits into an on-node leg (the kernel's pairs, launch_plan)
and a cross-node leg (NCCL point-to-point on cards, gloo here;
cross_node_pairs): every (owner, sender) pair lies in exactly one leg and
no kernel pair crosses nodes, whatever the layout, and a card is named by
(node, PCI bus id).  The cross-node leg runs one NCCL group a card slot
(slot i: every process's i-th distinct card): cross_node_routes puts each
cross-node pair on its owner's slot and stages the sender's rows onto its
process's card of that slot when its own card is of another, so a process
may hold several cards (kmc_tpu's multi-host layout: one process a host).
check_node_layout refuses the card layouts the NCCL groups cannot carry
across nodes.  Then torch.distributed processes in two emulated nodes
(tests/torch_multiproc_worker.py's MP_NODE) on CPU shards, each CPU shard
a card slot of its own: the exchange equals its plain version, and every
mode's files equal one process's and kmc_tpu's distributed_count (on its
CPU mesh, and its own two-process run), byte for byte.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from kmc_tpu_torch.parallel.distributed import check_node_layout
from kmc_tpu_torch.parallel.exchange_kernel import (card_slots,
                                                    cross_node_pairs,
                                                    cross_node_routes,
                                                    launch_plan)
from test_torch_exchange import _PLANS
from test_torch_multiprocess import (KNOBS, global_stats, results,
                                     run_workers, same_files, single)

HERE = Path(__file__).resolve().parent
BUS = ("0000:18:00.0", "0000:2a:00.0", "0000:3a:00.0", "0000:5d:00.0",
       "0000:9a:00.0", "0000:ab:00.0")


def _check_legs(cards, layout, nodes, counts):
    """The plan's pairs and the cross-node pairs: each (owner, sender)
    pair once; kernel pairs within a node, led by a rank on the card's
    node that holds a shard there; cross pairs between nodes, with their
    rows, each routed on its owner's card slot (slot i: the i-th distinct
    card of a process, in its list's order) and staged exactly when the
    sender's card is of another slot, onto a card its process holds;
    the layout check takes the layout, and no slot's group puts two ranks
    on one card.  Returns (plan, cross)."""
    D = len(cards)
    rank_of = {g: p for p, pos in enumerate(layout) for g in pos}
    plan = launch_plan(cards, layout, nodes)
    cross = cross_node_pairs(counts, nodes)
    seen = []
    for c, (leader, pairs) in plan.items():
        on = [g for g in range(D) if cards[g] == c]
        assert leader == min(rank_of[g] for g in on)
        assert {s for _, s in pairs} <= set(on)
        for o, s in pairs:
            assert nodes[o] == nodes[s], (c, o, s)
        seen += pairs
    assert cross.shape[1] == 3
    for s, o, m in cross.tolist():
        assert nodes[o] != nodes[s] and m == counts[s, o]
        seen.append((o, s))
    assert sorted(seen) == [(o, s) for o in range(D) for s in range(D)]
    slot_cards = [list(dict.fromkeys(cards[g] for g in pos))
                  for pos in layout]
    check_node_layout([nodes[pos[0]] for pos in layout], slot_cards)
    slot = [slot_cards[rank_of[g]].index(cards[g]) for g in range(D)]
    assert card_slots(cards, layout).tolist() == slot
    routes = cross_node_routes(cards, layout, nodes, counts)
    assert routes.dtype == np.int64 and np.array_equal(routes[:, :3], cross)
    for s, o, m, k, staged in routes.tolist():
        assert k == slot[o] < len(slot_cards[rank_of[s]])
        assert staged == int(slot[s] != k)
    if len(set(nodes)) > 1:
        for k in range(len(slot_cards[0])):
            held = [cs[k] for cs in slot_cards]
            assert len(set(held)) == len(held)
    return plan, cross


def _node_cards(nodes, buses):
    return [(n, b) for n, b in zip(nodes, buses)]


# (nodes of the shards, bus ids of the shards' cards, layout)
_NODE_PLANS = {
    # two nodes of two processes, one card each
    "2x2": (["a", "a", "b", "b"], [BUS[0], BUS[1], BUS[2], BUS[3]],
            [[0], [1], [2], [3]]),
    # two nodes of one process, two shards on its card
    "2x1": (["a", "a", "b", "b"], [BUS[0]] * 4, [[0, 1], [2, 3]]),
    # three nodes of three, one and two processes
    "3_uneven": (["a", "a", "a", "b", "c", "c"],
                 [BUS[0], BUS[1], BUS[2], BUS[0], BUS[0], BUS[1]],
                 [[0], [1], [2], [3], [4], [5]]),
    # every node repeats the same bus ids
    "bus_ids_repeat": (["a", "a", "b", "b", "c", "c"],
                       [BUS[0], BUS[1]] * 3,
                       [[0], [1], [2], [3], [4], [5]]),
    # two nodes of one process holding two cards
    "2n_1p_2c": (["a", "a", "b", "b"], [BUS[0], BUS[1]] * 2,
                 [[0, 1], [2, 3]]),
    # two nodes of two processes holding two cards each
    "2n_2p_2c": (["a"] * 4 + ["b"] * 4, list(BUS[:4]) * 2,
                 [[0, 1], [2, 3], [4, 5], [6, 7]]),
    # two shards a card, the cards interleaved in one process's list
    "shards_a_card": (["a"] * 4 + ["b"] * 4,
                      [BUS[0], BUS[1], BUS[0], BUS[1],
                       BUS[2], BUS[2], BUS[3], BUS[3]],
                      [[0, 1, 2, 3], [4, 5, 6, 7]]),
    # a process of three cards on each of two nodes
    "three_cards": (["a"] * 3 + ["b"] * 3,
                    [BUS[0], BUS[1], BUS[2], BUS[1], BUS[2], BUS[3]],
                    [[0, 1, 2], [3, 4, 5]]),
    # three nodes of one process holding two cards, one of them twice
    "3n_1p_2c": (["a", "a", "b", "b", "b", "c", "c"],
                 [BUS[0], BUS[1], BUS[1], BUS[0], BUS[0], BUS[2], BUS[3]],
                 [[0, 1], [2, 3, 4], [5, 6]]),
}


@pytest.mark.parametrize("name", list(_NODE_PLANS))
def test_launch_plan_across_nodes(name):
    nodes, buses, layout = _NODE_PLANS[name]
    D = len(nodes)
    counts = np.random.default_rng(D).integers(0, 50, (D, D))
    cards = _node_cards(nodes, buses)
    plan, cross = _check_legs(cards, layout, nodes, counts)
    # one launch for each card of each node, by the rank holding it
    assert list(plan) == list(dict.fromkeys(cards))
    for c, (leader, _) in plan.items():
        assert nodes[layout[leader][0]] == c[0]
    n_cross = sum(nodes[s] != nodes[o] for s in range(D) for o in range(D))
    assert len(cross) == n_cross > 0
    # a process of several cards stages some rows, not all
    staged = cross_node_routes(cards, layout, nodes, counts)[:, 4]
    several = any(len({buses[g] for g in pos}) > 1 for pos in layout)
    assert staged.any() == several and not staged.all()
    # the bus ids alone would merge cards of different nodes
    if len(set(buses)) < len(set(cards)):
        assert len(launch_plan(buses, layout)) < len(plan)


@pytest.mark.parametrize("case", range(len(_PLANS)))
def test_launch_plan_one_node_is_todays(case):
    """With one node the plan is the one-node plan, pair for pair, and the
    cross-node leg is empty."""
    cards, layout, want = _PLANS[case]
    D = len(cards)
    counts = np.random.default_rng(case).integers(0, 9, (D, D))
    plan, cross = _check_legs(cards, layout, ["n"] * D, counts)
    assert plan == launch_plan(cards, layout)
    assert {c: (leader, sorted({s for _, s in pairs}))
            for c, (leader, pairs) in plan.items()} == want
    assert cross.shape == (0, 3)


# (ranks' nodes, ranks' cards, the message's words or None: taken)
_LAYOUTS = {
    "one_node_two_ranks_a_card": (["a", "a"], [[BUS[0]], [BUS[0]]], None),
    "one_node_two_cards_a_rank": (["a", "a"], [[BUS[0], BUS[1]], [BUS[2]]],
                                  None),
    "one_rank_a_card": (["a", "a", "b", "b"],
                        [[BUS[0]], [BUS[1]], [BUS[0]], [BUS[1]]], None),
    "cpu_shards": (["a", "b", "b"], [[], [], []], None),
    "two_ranks_one_card": (["a", "a", "b", "b"],
                           [[BUS[0]], [BUS[0]], [BUS[0]], [BUS[1]]],
                           "ranks [0, 1] share card 0000:18:00.0 of node 'a'"),
    "two_cards_one_rank": (["a", "b"], [[BUS[0], BUS[1]], [BUS[0], BUS[1]]],
                           None),
    "three_cards_a_rank": (["a", "a", "b", "b"],
                           [[BUS[0], BUS[1], BUS[2]], [BUS[3], BUS[4], BUS[5]],
                            [BUS[0], BUS[1], BUS[2]], [BUS[3], BUS[4], BUS[5]]],
                           None),
    "two_ranks_one_card_of_two": (["a", "a", "b", "b"],
                                  [[BUS[0], BUS[1]], [BUS[1], BUS[2]],
                                   [BUS[0], BUS[1]], [BUS[2], BUS[3]]],
                                  "ranks [0, 1] share card 0000:2a:00.0 of "
                                  "node 'a'"),
    "unequal_card_counts": (["a", "b"], [[BUS[0], BUS[1]], [BUS[0]]],
                            "the ranks hold [2, 1] cards"),
}


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_node_layout_check(name):
    """Within one node every layout is taken; across nodes a rank may hold
    several cards, but no two ranks share one and every rank holds as
    many (one NCCL group a card slot), and the refusal names the
    layout."""
    nodes, cards, words = _LAYOUTS[name]
    if words is None:
        check_node_layout(nodes, cards)
        return
    with pytest.raises(ValueError) as e:
        check_node_layout(nodes, cards)
    assert words in str(e.value) and "NCCL" in str(e.value)
    assert f"across {len(set(nodes))} nodes" in str(e.value)


def test_cross_node_routes_cpu_shards():
    """CPU shards stand each as a card of its own (cards = the shards'
    numbers): a shard's slot is its place in its process, and a pair
    stages when its sender's place differs from its owner's."""
    nodes = ["a", "a", "b", "b"]
    counts = np.arange(16).reshape(4, 4)
    assert cross_node_routes(range(4), [[0, 1], [2, 3]], nodes,
                             counts).tolist() == [
        [0, 2, 2, 0, 0], [0, 3, 3, 1, 1], [1, 2, 6, 0, 1], [1, 3, 7, 1, 0],
        [2, 0, 8, 0, 0], [2, 1, 9, 1, 1], [3, 0, 12, 0, 1],
        [3, 1, 13, 1, 0]]
    assert cross_node_routes(range(4), [[0, 1, 2, 3]], ["a"] * 4,
                             counts).shape == (0, 5)


_EXCHANGE_CHILD = r"""
import json, socket, sys
import numpy as np, torch
import torch.distributed as dist

init, rank, out, n_procs, per, C, seed = sys.argv[1], int(sys.argv[2]), \
    sys.argv[3], *map(int, sys.argv[4:8])
# two emulated nodes: the first half of the ranks, and the second
socket.gethostname = lambda: f"node{rank * 2 // n_procs}"
torch.set_num_threads(1)
from kmc_tpu_torch.parallel.distributed import init_multihost
from kmc_tpu_torch.parallel.exchange_kernel import (
    ragged_all_to_all_plain, ragged_all_to_all_processes)

init_multihost(init, n_procs, rank)
D, cap = n_procs * per, 97
layout = [list(range(p * per, (p + 1) * per)) for p in range(n_procs)]
rng = np.random.default_rng(seed)
counts = rng.integers(0, cap + 1, size=(D, D))
counts[0, D - 1], counts[D - 2, 1], counts[3, 2] = 0, cap, 0
full = [torch.from_numpy(rng.integers(-2**31, 2**31, (D, cap, C)).astype(
    np.int32)) for _ in range(D)]
want, _ = ragged_all_to_all_plain(full, counts)
xp = ragged_all_to_all_processes
outs, recv = xp([full[j].clone() for j in layout[rank]], counts, layout)
ok = all(torch.equal(outs[l][j, :counts[j, o]], want[o][j, :counts[j, o]])
         for l, o in enumerate(layout[rank]) for j in range(D))
json.dump({"ok": ok, "recv": recv.tolist(), "staged": xp.staged_bytes,
           "want_recv": counts[:, layout[rank]].T.tolist()}, open(out, "w"))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("n_procs,per,C,seed", [
    pytest.param(4, 2, 1, 0, id="1-0"), pytest.param(4, 2, 3, 1, id="3-1"),
    pytest.param(2, 3, 1, 0, id="one_process_a_node-1-0"),
    pytest.param(2, 3, 3, 1, id="one_process_a_node-3-1")])
def test_exchange_across_two_nodes_matches_plain(tmp_path, n_procs, per, C,
                                                 seed):
    """Processes of several CPU shards in two emulated nodes (four of two
    shards, or one a node of three), random counts: the on-node leg (an
    all-to-all over the node's gloo group) and the cross-node leg (gloo
    point-to-point, each pair on its owner's slot, staged where the
    sender's slot differs) deliver what the plain version does."""
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _EXCHANGE_CHILD, init, str(r),
         str(tmp_path / f"r{r}.json"), str(n_procs), str(per), str(C),
         str(seed)], cwd=HERE.parent,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n_procs)]
    logs = [p.communicate(timeout=120)[0].decode(errors="replace")
            for p in procs]
    D = n_procs * per
    counts = np.random.default_rng(seed).integers(0, 98, size=(D, D))
    counts[0, D - 1], counts[D - 2, 1], counts[3, 2] = 0, 97, 0
    node = np.arange(D) * 2 // D
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        assert got["ok"] and got["recv"] == got["want_recv"]
        want = 4 * C * sum(int(counts[s, o])
                           for s in range(r * per, (r + 1) * per)
                           for o in range(D)
                           if node[s] != node[o] and s % per != o % per)
        assert got["staged"] == want > 0


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    rng = np.random.default_rng(13)
    path = tmp_path_factory.mktemp("mn") / "reads.fastq"
    genome = rng.integers(0, 4, 30000)
    with open(path, "w") as f:
        for i in range(500):
            start = rng.integers(0, len(genome) - 130)
            seq = "".join("ACGT"[c] for c in genome[start:start + 130])
            if i % 40 == 3:
                seq = seq[:60] + "N" + seq[61:]
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return str(path)


NODES = {"MP_NODE": "0,0,1,1", "MP_DEVICES": "cpu"}
MODES = ("default", "k13", "kff", "greedy", "spill")
SHARDED = ("default", "kff")
# the two-node spawns: (processes, their MP_* knobs).  Four processes of
# one CPU shard, nodes {0, 1} and {2, 3}: every process reading the whole
# stream, every mode; and the input split four ways by bytes.  One
# process a node holding two CPU shards (kmc_tpu's multi-host layout),
# every mode.
SPAWNS = {
    "serial": (4, dict(NODES, MP_SHARD_INPUT="0",
                       MP_MODES=",".join(MODES))),
    "sharded": (4, dict(NODES, MP_MIN_SHARD="4096",
                        MP_MODES=",".join(SHARDED))),
    "one_process_a_node": (2, dict(MP_NODE="0,1", MP_DEVICES="cpu,cpu",
                                   MP_SHARD_INPUT="0",
                                   MP_MODES=",".join(MODES))),
}


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory, reads_file):
    """Every spawn of SPAWNS."""
    d = tmp_path_factory.mktemp("mn_run")
    return {name: run_workers(d / name, reads_file, env, n_procs=n)
            for name, (n, env) in SPAWNS.items()}


@pytest.fixture(scope="module")
def kmc_tpu_two_processes(tmp_path_factory, reads_file):
    """kmc_tpu's own two-process run (tests/multiproc_worker.py: two
    jax.distributed processes of four CPU devices each), the default count
    with the port workers' knobs."""
    from test_multiprocess import _run_workers

    out = tmp_path_factory.mktemp("mn_jax") / "db"
    _run_workers(2, reads_file, str(out))
    return out


def _kmc_tpu(reads, out, mode):
    from kmc_tpu.parallel.distributed import make_mesh
    from kmc_tpu.parallel.multihost import distributed_count

    from torch_multiproc_worker import MODES as KW

    rows = 1 << 11 if mode == "spill" else 1 << 12
    return distributed_count([reads], str(out), mesh=make_mesh(4),
                             capacity_rows_per_device=rows,
                             **dict(KNOBS, **KW[mode]))


CASES = [(name, m) for name, (_, env) in SPAWNS.items()
         for m in env["MP_MODES"].split(",")]


@pytest.mark.parametrize("spawn,mode", CASES)
def test_two_nodes_match_one_process_and_kmc_tpu(two_nodes, reads_file,
                                                 tmp_path, request, spawn,
                                                 mode):
    n_procs, env = SPAWNS[spawn]
    res = results(two_nodes[spawn], mode, n_procs=n_procs)
    st = res[0]["stats"]
    assert all(global_stats(r["stats"]) == global_stats(st) for r in res)
    assert [r["node"] for r in res] == [
        f"node{n}" for n in env["MP_NODE"].split(",")]
    assert st["n_processes"] == n_procs and st["n_devices"] == 4
    assert all(r["launches"] == 0 for r in res)  # CPU shards: no kernel
    if mode != "k13":
        assert st["timings"]["exchange_route"] == "plain+p2p"
        # a process of two shards sends rows across nodes from both
        # slots, so each stages some onto the owner's slot
        assert all((r["exchange_staged_bytes"] > 0) == (n_procs == 2)
                   for r in res)
    parsed = [r["stats"]["consumed_bytes_local"] for r in res]
    if spawn == "sharded":
        assert sum(parsed) == os.path.getsize(reads_file) and min(parsed) > 0
    sp = single(reads_file, tmp_path / "sp", mode)
    keys = ("n_super_kmers", "n_total", "n_unique", "n_below", "n_above",
            "n_reads")
    assert {k: st[k] for k in keys} == {k: sp[k] for k in keys}
    if spawn != "sharded":  # the deal is one process's
        assert global_stats(st) | {"n_processes": 1} == \
            global_stats(sp) | {"n_processes": 1}
    if mode == "spill":
        assert st["n_spills"] >= 1
    out = Path(f"{two_nodes[spawn]}.{mode}")
    same_files(out, tmp_path / "sp", mode)
    _kmc_tpu(reads_file, tmp_path / "jax", mode)
    same_files(out, tmp_path / "jax", mode)
    if spawn == "one_process_a_node" and mode == "default":
        jax_db = request.getfixturevalue("kmc_tpu_two_processes")
        jax_st = json.loads(Path(f"{jax_db}.stats.0").read_text())
        assert (jax_st["n_processes"], jax_st["n_devices"]) == (2, 8)
        assert {k: st[k] for k in keys} == {k: jax_st[k] for k in keys}
        same_files(out, jax_db, mode)


def test_dead_peer_across_nodes_fails_survivors(reads_file, tmp_path):
    """Process 1 dies where it would post the exchange's cross-node leg;
    every survivor (its node's and the other node's) ends in an error
    within the heartbeat, none hangs or writes a database."""
    env = dict(NODES, MP_SHARD_INPUT="0", MP_HEARTBEAT_SECS="10",
               MP_CRASH_AT="p2p", MP_CRASH_PID="1")
    env = dict(os.environ, **env)
    init = f"file://{tmp_path / 'pg'}"
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_multiproc_worker.py"), init, "4",
         str(pid), reads_file, str(tmp_path / "db")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for pid in range(4)]
    try:
        outs = [p.communicate(timeout=120)[0].decode(errors="replace")
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a survivor hung past the failure-detection bound")
    codes = [p.returncode for p in procs]
    assert codes[1] == 17, outs[1][-2000:]
    for pid in (0, 2, 3):
        assert codes[pid] not in (0, None), outs[pid][-2000:]
    assert time.monotonic() - t0 < 90
    assert not (tmp_path / "db.default.kmc_pre").exists()
