"""Devices and processes of a multi-device count, and the SPMD count step
(the port's kmc_tpu/parallel/distributed.py).

kmc_tpu builds a jax.sharding.Mesh; the port takes a plain list of
torch.devices, one per shard of the store.  A list may repeat a device, so
one card (or the CPU) can hold several shards: ["cuda:0"] * 4 is the
counterpart of the 8-virtual-device CPU mesh that kmc_tpu's tests use.

make_distributed_count_step is kmc_tpu's self-contained multi-device step:
one batch per shard is counted (ops/sortcount.py::stage1_batch: the
splitter-scan kernel and the grouping sort), each unique k-mer goes to the
owner bin % D of its signature's bin, and the owners' rows move in one
dense exchange of fixed-capacity segments (exchange_kernel.py's
all_to_all, the dense entry of csrc/ragged_a2a.cu) and are merged by each
owner with the grouping sort.  kmc_tpu's step runs jax.lax.sort and
jax.lax.all_to_all under shard_map; one process drives every shard here.

init_multihost joins a torch.distributed group (gloo), the counterpart of
jax.distributed's control plane: flags, histograms, scalars and stats
cross it as CPU tensors or pickled objects, whatever the shards' devices
are, so several processes of one node may share one card.  It records
each rank's node (its host name).  Fleet is a process's view of that
group for the sharded count: its rank, the ranks' nodes, and the global
shard list, which is the ranks' own device lists concatenated rank-major
(the order of jax's mesh positions).

A group across several nodes moves the exchange's rows between nodes by
NCCL point-to-point (exchange_kernel.py's cross-node leg), and NCCL binds
a rank to one card: there every process holds its shards on one card of
its own (check_node_layout), its current device is that card, and the
ranks share one NCCL group (nccl_group), made once, collectively, with
the heartbeat's timeout.  CPU shards across nodes need no NCCL: their
cross-node leg is gloo point-to-point, their on-node leg an all-to-all
over a gloo group of the node's ranks (node_group).
"""
from __future__ import annotations

import os
import socket
import time
import weakref
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.extract import i32_to_u32, u32_to_i32
from ..ops.sort_kernel import radix_sort_columns
from ..ops.sortcount import stage1_batch
from ..ops.store import _group_reduce
from .exchange_kernel import all_to_all


class _Group:
    """The live group's nodes, timeout and subgroups (one process group a
    process: init_multihost sets it anew).  The groups are held by weak
    references: torch's registry owns them, and destroy_process_group
    frees them then, not at the interpreter's exit."""
    world = None  # weak reference to the default group these belong to
    hosts = None  # each rank's node, in rank order
    timeout = None
    node_group = None  # weak reference to the gloo group of this node
    nccl = None  # weak reference to the NCCL group over every rank
    nccl_device = None  # and its card


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   heartbeat_timeout_seconds: int | None = None) -> None:
    """Join the torch.distributed group of a multi-process count (mirrors
    kmc_tpu's init_multihost).  Call once per process, before the count;
    one-process runs may skip it.

    coordinator_address: "host:port" (TCP, process 0 listens), or an init
    URL ("tcp://host:port"; "file:///path" for processes of one node, or
    of nodes that share a file system); None takes torch's environment
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun
    sets them).  The group is gloo: the control plane runs on CPU tensors
    whatever the shards' devices are.

    heartbeat_timeout_seconds bounds how long a collective waits for a
    peer (default 100 s, jax's default, which kmc_tpu keeps); a peer that
    dies closes its connections, so the survivors' next collective raises
    instead of hanging.  The NCCL group of a card group across nodes gets
    the same timeout.  A group across several nodes checks its card
    layout and joins that NCCL group at the sharded count's start
    (Fleet), on every rank alike."""
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    timeout = timedelta(seconds=heartbeat_timeout_seconds or 100)
    dist.init_process_group("gloo", init_method=url, timeout=timeout,
                            **kwargs)
    _Group.world, _Group.timeout = None, timeout
    rank_nodes()


def rank_nodes() -> list:
    """Each rank's node (its host name), in rank order: recorded by
    init_multihost, or gathered here (collectively) for a group made
    elsewhere; [this host] without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return [socket.gethostname()]
    if _Group.world is None or _Group.world() is not dist.group.WORLD:
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, socket.gethostname())
        _Group.world, _Group.hosts = weakref.ref(dist.group.WORLD), hosts
        _Group.node_group = _Group.nccl = _Group.nccl_device = None
        if _Group.timeout is None:
            _Group.timeout = timedelta(seconds=100)
    return _Group.hosts


def check_node_layout(nodes, cards) -> None:
    """Raise ValueError, naming the layout, for a card group across nodes
    that NCCL cannot carry.  nodes[r]: rank r's node; cards[r]: the cards
    of rank r's shards, by a name unique within its node (empty for CPU
    shards).  Within one node every layout is taken.  Across nodes each
    rank holds its shards on one card, and no two ranks share a card
    (NCCL refuses two ranks on one GPU: "Duplicate GPU detected")."""
    if len(set(nodes)) < 2:
        return
    holders = {}
    for r, (node, cs) in enumerate(zip(nodes, cards)):
        if len(set(cs)) > 1:
            raise ValueError(
                f"kmc_tpu_torch: rank {r} holds shards on {len(set(cs))} "
                f"cards {sorted(set(cs))} of node {node!r} in a group across "
                f"{len(set(nodes))} nodes; the exchange's cross-node leg is "
                "NCCL, which binds a process to one card: run one process a "
                "card")
        for c in set(cs):
            holders.setdefault((node, c), []).append(r)
    for (node, c), ranks in holders.items():
        if len(ranks) > 1:
            raise ValueError(
                f"kmc_tpu_torch: ranks {ranks} share card {c} of node "
                f"{node!r} in a group across {len(set(nodes))} nodes; the "
                "exchange's cross-node leg is NCCL, which takes one process "
                "a card (\"Duplicate GPU detected\"): run one process a card, "
                "or every process on one node")


def node_group():
    """The gloo group of this rank's node (one a node, made collectively
    by every rank on the first call)."""
    nodes = rank_nodes()  # forgets the groups of a destroyed world
    if _Group.node_group is None:
        for node in dict.fromkeys(nodes):
            g = dist.new_group([r for r, n in enumerate(nodes) if n == node],
                               timeout=_Group.timeout, backend="gloo")
            if node == nodes[dist.get_rank()]:
                _Group.node_group = weakref.ref(g)
    return _Group.node_group()


def nccl_group(device: torch.device):
    """The NCCL group over every rank, for the exchange's cross-node leg,
    bound to this rank's card `device`: made collectively by every rank on
    the first call, with the gloo group's timeout, and brought up at once:
    an all-reduce over every rank (a group's first call must involve them
    all; it makes the communicator), then one point-to-point exchange
    between every pair of ranks on different nodes, the only pairs the
    cross-node leg has.  NCCL connects a pair at its first point-to-point
    operation, on the calling thread, with no timeout, so those pairs are
    connected here and an exchange's leg finds its connections made.
    nccl_group.init_s and nccl_group.warmup_s keep the two steps' host
    seconds.  A failed or timed-out NCCL operation tears the process down
    (TORCH_NCCL_ASYNC_ERROR_HANDLING=1), so a survivor of a dead peer ends
    in an error within the timeout, never hangs."""
    device = torch.device(device)
    nodes = rank_nodes()  # forgets the groups of a destroyed world
    if _Group.nccl is None:
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "1"
        torch.cuda.set_device(device)
        t0 = time.perf_counter()
        g = dist.new_group(backend="nccl", timeout=_Group.timeout)
        world, rank = dist.get_world_size(), dist.get_rank()
        probe = torch.ones(1, dtype=torch.int32, device=device)
        dist.all_reduce(probe, group=g)
        if int(probe) != world:
            raise RuntimeError(f"kmc_tpu_torch: the NCCL group's first "
                               f"all-reduce gave {int(probe)}")
        t1 = time.perf_counter()
        peers = [p for p in range(world) if nodes[p] != nodes[rank]]
        got = torch.zeros(world, dtype=torch.int32, device=device)
        ops = [op for p in peers for op in (
            dist.P2POp(dist.isend, probe, p, g),
            dist.P2POp(dist.irecv, got[p:p + 1], p, g))]
        for w in dist.batch_isend_irecv(ops) if ops else []:
            w.wait()
        if int(got.sum()) != world * len(peers):
            raise RuntimeError("kmc_tpu_torch: the NCCL group's pairs "
                               "delivered wrong values")
        nccl_group.init_s, nccl_group.warmup_s = \
            t1 - t0, time.perf_counter() - t1
        _Group.nccl, _Group.nccl_device = weakref.ref(g), device
    elif _Group.nccl_device != device:
        raise ValueError(f"kmc_tpu_torch: this rank's NCCL group is bound to "
                         f"{_Group.nccl_device}, not {device}")
    return _Group.nccl()


nccl_group.init_s = None  # host seconds: the group and its communicator
nccl_group.warmup_s = None  # host seconds: the cross-node pairs' warm-up


def join_cards(devices) -> None:
    """For a group across nodes whose shards are on cards: check every
    rank's card layout (raising the same error on every rank), then join
    the NCCL group on this rank's card.  Collective; nothing to do within
    one node or for CPU shards."""
    from .. import _build
    from .exchange_kernel import _card_id

    nodes = rank_nodes()
    if len(set(nodes)) < 2:
        return
    kind = devices[0].type
    if kind == "cuda":
        lib = _build.load("ragged_a2a")
        mine = sorted({_card_id(lib, d.index) for d in devices})
    got = [None] * len(nodes)
    dist.all_gather_object(got, (kind, mine if kind == "cuda" else []))
    if len({k for k, _ in got}) != 1:
        raise ValueError(f"the ranks' shards mix device types: "
                         f"{[k for k, _ in got]}")
    if kind == "cuda":
        check_node_layout(nodes, [cards for _, cards in got])
        nccl_group(devices[0])


def process_count() -> int:
    """Ranks of the live torch.distributed group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Fleet:
    """This process's place in the count's process group: rank, world size,
    whether the ranks sit on several nodes (multi_node) and the global
    shard layout (layout[r] lists rank r's global shard positions; the
    global list is the ranks' device lists concatenated rank-major).  With
    one process every collective is the identity.  A group across nodes
    checks its card layout and joins the NCCL group here (join_cards)."""

    def __init__(self, devices):
        self.world = process_count()
        self.rank = process_index()
        self.multi = self.world > 1
        kinds = {d.type for d in devices}
        if len(kinds) != 1:
            raise ValueError(f"shards of mixed device types {sorted(kinds)}")
        mine = (len(devices), kinds.pop())
        every = self.all_gather_obj(mine)
        if len({kind for _, kind in every}) != 1:
            raise ValueError(f"the ranks' shards mix device types: {every}")
        self.layout, pos = [], 0
        for n, _ in every:
            self.layout.append(list(range(pos, pos + n)))
            pos += n
        self.D = pos
        self.positions = self.layout[self.rank]
        self.multi_node = len(set(rank_nodes())) > 1
        if self.multi_node:
            join_cards(devices)

    def all_gather_obj(self, obj) -> list:
        """Every rank's obj, in rank order."""
        if not self.multi:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def gather_obj(self, obj):
        """Every rank's obj in rank order on rank 0; None elsewhere."""
        if not self.multi:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out

    def broadcast_obj(self, obj):
        """Rank 0's obj on every rank."""
        if not self.multi:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def allsum(self, values):
        """Elementwise int64 sums over the ranks of a list of ints."""
        v = torch.tensor([int(x) for x in values], dtype=torch.int64)
        if self.multi:
            dist.all_reduce(v)
        return [int(x) for x in v]

    def allmax(self, value: int) -> int:
        if not self.multi:
            return int(value)
        v = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(v, op=dist.ReduceOp.MAX)
        return int(v)

    def sum_to_root(self, t: torch.Tensor):
        """The ranks' CPU tensors t summed on rank 0; None elsewhere."""
        if not self.multi:
            return t
        dist.reduce(t, dst=0)
        return t if self.rank == 0 else None

    def all_flags(self, flags) -> np.ndarray:
        """Every rank's list of bools as int64[world, n], by one all-gather
        of a small tensor."""
        v = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int64)
        if not self.multi:
            return v.numpy()[None]
        out = [torch.empty_like(v) for _ in range(self.world)]
        dist.all_gather(out, v)
        return torch.stack(out).numpy()

    def all_rows(self, local: np.ndarray) -> np.ndarray:
        """Each rank's rows (one per local shard), stacked in global shard
        order."""
        if not self.multi:
            return local
        return np.concatenate(self.all_gather_obj(local))


def make_mesh(n_devices: int | None = None, device="cuda") -> list:
    """The shards' devices (mirrors kmc_tpu's make_mesh).

    device="cuda" (default): every visible card, or the first n_devices of
    them; raises RuntimeError when there is no card or fewer than
    n_devices, and never falls back to the CPU.  device="cpu": n_devices
    (default 1) shards on the CPU, which the caller asks for explicitly."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [resolve_device("cpu")] * (1 if n_devices is None
                                           else int(n_devices))
    resolve_device(device)  # raises without a card
    n_cards = torch.cuda.device_count()
    n = n_cards if n_devices is None else int(n_devices)
    if n < 1 or n > n_cards:
        raise RuntimeError(f"kmc_tpu_torch: {n} CUDA devices asked for, "
                           f"{n_cards} visible")
    return [torch.device("cuda", i) for i in range(n)]


def resolve_devices(devices) -> list:
    """torch.devices for a caller's list (None: make_mesh()); each entry
    is one shard, and entries may repeat."""
    if devices is None:
        return make_mesh()
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("need at least one device")
    return out


def _local_count_step(codes, sig_map, *, s, k, sig_len, both_strands,
                      capacity, D):
    """One shard's count and send buffer (the sender's half of kmc_tpu's
    _local_count_step).

    codes: u8[L] (L = batch_len(s, k)), the shard's batch on its device;
    sig_map: int64[4^m + 1], the replicated signature -> bin map there.
    Returns (send int32[D, capacity, W + 1]: segment o holds the rows for
    owner o in (k-mer) order, each its W lanes and its count (u32 bit
    views), padded with all-ones lanes and count 0; the rows that did not
    fit their segment, an int64 0-d tensor)."""
    dev = codes.device
    sig, lanes, counts = stage1_batch(codes, s=s, k=k, sig_len=sig_len,
                                      both_strands=both_strands)
    W = len(lanes)
    # kmc_tpu's stage 1 returns s rows: the groups, then copies of the
    # last group with count 0
    g = sig.shape[0]
    idx = torch.clamp(torch.arange(s, device=dev), max=g - 1)
    sig, lanes = sig[idx], [w[idx] for w in lanes]
    counts = torch.where(torch.arange(s, device=dev) < g, counts[idx], 0)

    # signature -> bin -> owner; invalid rows go to owner D (not sent)
    slot = torch.clamp(i32_to_u32(sig), max=sig_map.shape[0] - 1)
    owner = torch.where(sig != -1, sig_map[slot] % D, D).to(torch.int32)
    rows = radix_sort_columns([owner, *lanes, u32_to_i32(counts)], 1 + W)
    owner = rows[0].to(torch.int64)

    # each row's slot in its owner's segment; rows past `capacity` drop
    start = torch.searchsorted(owner, torch.arange(D + 1, device=dev))
    pos = torch.arange(s, device=dev) - start[owner]
    in_cap = (pos < capacity) & (owner < D)
    slot = torch.where(in_cap, owner * capacity + pos, D * capacity)
    send = torch.full((D * capacity + 1, W + 1), -1, dtype=torch.int32,
                      device=dev)
    send[:, W] = 0
    send[slot] = torch.stack(rows[1:], dim=1)
    n_dropped = ((owner < D) & ~in_cap).sum()
    return send[:D * capacity].view(D, capacity, W + 1), n_dropped


def _owner_merge(recv):
    """One owner's merge of what it received (the owner's half of kmc_tpu's
    _local_count_step): recv int32[D, capacity, W + 1].  Returns (words
    int32[P, W], counts int32[P], n_out int64 0-d tensor), P = D x
    capacity: row i holds the i-th group in k-mer order, its u32 total
    when that is not 0, else all-ones lanes and count 0, so the valid
    groups are the first n_out rows."""
    D, cap, C = recv.shape
    W = C - 1
    P = D * cap
    flat = recv.reshape(P, C)
    cols = [flat[:, t].contiguous() for t in range(C)]
    reps, totals = _group_reduce(cols[:W], cols[W], W, drop_zero=False)
    n = totals.shape[0]
    valid = totals > 0
    words = torch.full((P, W), -1, dtype=torch.int32, device=recv.device)
    counts = torch.zeros(P, dtype=torch.int32, device=recv.device)
    words[:n] = torch.where(valid[:, None], torch.stack(reps, dim=1), -1)
    counts[:n] = u32_to_i32(torch.where(valid, totals, 0))
    return words, counts, valid.sum()


def make_distributed_count_step(devices, *, s: int, k: int, sig_len: int,
                                both_strands: bool = True,
                                capacity: int | None = None):
    """The multi-device counting step (mirrors kmc_tpu's
    make_distributed_count_step): returns (step, capacity).

    devices: one shard per entry (see resolve_devices).  step(codes,
    sig_map): codes holds one u8 batch of batch_len(s, k) codes per shard
    (a list, or a [D, L] array or tensor), sig_map the int32[4^m + 1]
    signature -> bin map.  Returns (words, counts, n_out, n_dropped), each
    a list over the shards, as kmc_tpu's step returns them per device:
    words int32[D x capacity, W] and counts int32[D x capacity] (u32 bit
    views) of the k-mers the shard owns, merged, valid groups first and
    the rest all-ones lanes with count 0; n_out the valid groups and
    n_dropped the rows the shard could not send (int64 0-d tensors).

    capacity is the rows a sender may send each owner (the analogue of
    KMC's n_plus_x_recs reservation, kb_collector.h:66-116); default
    max(64, (s // D) * 2).  On CUDA shards the exchange is the dense
    all-to-all kernel; CPU shards take the kernels' plain versions."""
    devices = resolve_devices(devices)
    D = len(devices)
    if capacity is None:
        capacity = max(64, (s // D) * 2)

    def step(codes, sig_map):
        if len(codes) != D:
            raise ValueError(f"need one batch per shard ({D}), got "
                             f"{len(codes)}")
        sm = torch.as_tensor(np.asarray(sig_map) if not isinstance(
            sig_map, torch.Tensor) else sig_map).to(torch.int64)
        maps = {}
        sends, dropped = [], []
        for d, dev in enumerate(devices):
            if dev not in maps:
                maps[dev] = sm.to(dev)
            send, n_dropped = _local_count_step(
                torch.as_tensor(codes[d]).to(dev), maps[dev], s=s, k=k,
                sig_len=sig_len, both_strands=both_strands,
                capacity=capacity, D=D)
            sends.append(send)
            dropped.append(n_dropped)
        recv = all_to_all(sends)
        del sends
        words, counts, n_out = zip(*(_owner_merge(r) for r in recv))
        return list(words), list(counts), list(n_out), dropped

    return step, capacity
