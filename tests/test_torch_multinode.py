"""Counting across several nodes in the port (A11e), on the CPU.

The exchange splits into an on-node leg (the kernel's pairs, launch_plan)
and a cross-node leg (NCCL point-to-point on cards, gloo here;
cross_node_pairs): every (owner, sender) pair lies in exactly one leg and
no kernel pair crosses nodes, whatever the layout, and a card is named by
(node, PCI bus id).  check_node_layout refuses the card layouts NCCL
cannot carry across nodes.  Then torch.distributed processes in two
emulated nodes (tests/torch_multiproc_worker.py's MP_NODE) on CPU shards:
the exchange equals its plain version, and every mode's files equal one
process's and kmc_tpu's distributed_count on its CPU mesh, byte for byte.
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
from kmc_tpu_torch.parallel.exchange_kernel import (cross_node_pairs,
                                                    launch_plan)
from test_torch_exchange import _PLANS
from test_torch_multiprocess import (KNOBS, global_stats, results,
                                     run_workers, same_files, single)

HERE = Path(__file__).resolve().parent
BUS = ("0000:18:00.0", "0000:2a:00.0", "0000:3a:00.0", "0000:5d:00.0")


def _check_legs(cards, layout, nodes, counts):
    """The plan's pairs and the cross-node pairs: each (owner, sender)
    pair once; kernel pairs within a node, led by a rank on the card's
    node that holds a shard there; cross pairs between nodes, with their
    rows.  Returns (plan, cross)."""
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
    "two_cards_one_rank": (["a", "b"], [[BUS[0], BUS[1]], [BUS[0]]],
                           "rank 0 holds shards on 2 cards"),
}


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_node_layout_check(name):
    """Within one node every layout is taken; across nodes each rank holds
    one card of its own, and the refusal names the layout."""
    nodes, cards, words = _LAYOUTS[name]
    if words is None:
        check_node_layout(nodes, cards)
        return
    with pytest.raises(ValueError) as e:
        check_node_layout(nodes, cards)
    assert words in str(e.value) and "NCCL" in str(e.value)
    assert f"across {len(set(nodes))} nodes" in str(e.value)


_EXCHANGE_CHILD = r"""
import json, socket, sys
import numpy as np, torch
import torch.distributed as dist

init, rank, out, C, seed = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    int(sys.argv[4]), int(sys.argv[5])
socket.gethostname = lambda: f"node{rank // 2}"
torch.set_num_threads(1)
from kmc_tpu_torch.parallel.distributed import init_multihost
from kmc_tpu_torch.parallel.exchange_kernel import (
    ragged_all_to_all_plain, ragged_all_to_all_processes)

init_multihost(init, 4, rank)
D, cap = 8, 97
layout = [[2 * p, 2 * p + 1] for p in range(4)]
rng = np.random.default_rng(seed)
counts = rng.integers(0, cap + 1, size=(D, D))
counts[0, 7], counts[6, 1], counts[3, 2] = 0, cap, 0
full = [torch.from_numpy(rng.integers(-2**31, 2**31, (D, cap, C)).astype(
    np.int32)) for _ in range(D)]
want, _ = ragged_all_to_all_plain(full, counts)
outs, recv = ragged_all_to_all_processes(
    [full[j].clone() for j in layout[rank]], counts, layout)
ok = all(torch.equal(outs[l][j, :counts[j, o]], want[o][j, :counts[j, o]])
         for l, o in enumerate(layout[rank]) for j in range(D))
json.dump({"ok": ok, "recv": recv.tolist(),
           "want_recv": counts[:, layout[rank]].T.tolist()}, open(out, "w"))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("C,seed", [(1, 0), (3, 1)])
def test_exchange_across_two_nodes_matches_plain(tmp_path, C, seed):
    """Four processes of two CPU shards in two emulated nodes, random
    counts: the on-node leg (an all-to-all over the node's gloo group) and
    the cross-node leg (gloo point-to-point) deliver what the plain version
    does."""
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _EXCHANGE_CHILD, init, str(r),
         str(tmp_path / f"r{r}.json"), str(C), str(seed)], cwd=HERE.parent,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(4)]
    logs = [p.communicate(timeout=120)[0].decode(errors="replace")
            for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        assert got["ok"] and got["recv"] == got["want_recv"]


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


# the modes of the two-node spawns: (worker mode, the spawn)
NODES = {"MP_NODE": "0,0,1,1", "MP_DEVICES": "cpu"}
MODES = ("default", "k13", "kff", "greedy", "spill")
SHARDED = ("default", "kff")


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory, reads_file):
    """Two spawns of four processes, one CPU shard each, nodes {0, 1} and
    {2, 3}: every process reading the whole stream, every mode; and the
    input split four ways by bytes."""
    d = tmp_path_factory.mktemp("mn_run")
    serial = run_workers(d / "serial", reads_file, dict(
        NODES, MP_SHARD_INPUT="0", MP_MODES=",".join(MODES)), n_procs=4)
    sharded = run_workers(d / "sharded", reads_file, dict(
        NODES, MP_MIN_SHARD="4096", MP_MODES=",".join(SHARDED)), n_procs=4)
    return {"serial": serial, "sharded": sharded}


def _kmc_tpu(reads, out, mode):
    from kmc_tpu.parallel.distributed import make_mesh
    from kmc_tpu.parallel.multihost import distributed_count

    from torch_multiproc_worker import MODES as KW

    rows = 1 << 11 if mode == "spill" else 1 << 12
    return distributed_count([reads], str(out), mesh=make_mesh(4),
                             capacity_rows_per_device=rows,
                             **dict(KNOBS, **KW[mode]))


CASES = [("serial", m) for m in MODES] + [("sharded", m) for m in SHARDED]


@pytest.mark.parametrize("spawn,mode", CASES)
def test_two_nodes_match_one_process_and_kmc_tpu(two_nodes, reads_file,
                                                 tmp_path, spawn, mode):
    res = results(two_nodes[spawn], mode, n_procs=4)
    st = res[0]["stats"]
    assert all(global_stats(r["stats"]) == global_stats(st) for r in res)
    assert [r["node"] for r in res] == ["node0", "node0", "node1", "node1"]
    assert st["n_processes"] == 4 and st["n_devices"] == 4
    assert all(r["launches"] == 0 for r in res)  # CPU shards: no kernel
    if mode != "k13":
        assert st["timings"]["exchange_route"] == "plain+p2p"
    parsed = [r["stats"]["consumed_bytes_local"] for r in res]
    if spawn == "sharded":
        assert sum(parsed) == os.path.getsize(reads_file) and min(parsed) > 0
    sp = single(reads_file, tmp_path / "sp", mode)
    keys = ("n_super_kmers", "n_total", "n_unique", "n_below", "n_above",
            "n_reads")
    assert {k: st[k] for k in keys} == {k: sp[k] for k in keys}
    if spawn == "serial":  # the deal is one process's
        assert global_stats(st) | {"n_processes": 1} == \
            global_stats(sp) | {"n_processes": 1}
    if mode == "spill":
        assert st["n_spills"] >= 1
    out = Path(f"{two_nodes[spawn]}.{mode}")
    same_files(out, tmp_path / "sp", mode)
    _kmc_tpu(reads_file, tmp_path / "jax", mode)
    same_files(out, tmp_path / "jax", mode)


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
