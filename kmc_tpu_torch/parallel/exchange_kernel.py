"""The owner exchange: ragged and dense all-to-all between the store's shards.

Kernel: csrc/ragged_a2a.cu, which takes the place of the TPU kernels
kmc_tpu/parallel/pallas_a2a.py::pallas_ragged_all_to_all and (as the dense
entry) pallas_all_to_all; see the source for its design and bound.  One
launch a card (launch_plan) copies the rows of every sender on that card
to every owner of its node, walking a tile list built here (tile_list):
on one card as a device copy, to other cards' outputs over peer access
(the senders' cards push).  Between nodes no memory is addressable from a
kernel: those rows go by NCCL point-to-point (the cross-node leg below),
which replaces no kernel.  Plain versions:
ragged_all_to_all_plain and all_to_all_plain below, built from slicing and
copy_; the wrappers take them for CPU tensors only, and the kernel is held
against them on the card.

Contract (D shards; shard j's tensors on its own device):

    ragged_all_to_all(xs, n_rows) -> (outs, recv_rows)
      xs[j]: int32[D, cap, C], segment r for owner r; n_rows[j][r] <= cap
      outs[r][j, :recv_rows[r][j]] == xs[j][r, :n_rows[j][r]]
      recv_rows[r][j] == n_rows[j][r]   (host int64[D, D], the transpose)
    all_to_all(xs) -> outs   (n_rows = cap everywhere)

Rows of outs[r][j] past recv_rows[r][j] are left as they were allocated
(torch.empty): callers read only the delivered prefixes.

Across processes (a torch.distributed group: the shards of a count spread
over several processes, kmc_tpu's multi-host exchange), each process holds
only its own senders and owners:

    ragged_all_to_all_processes(xs, counts, layout) -> (outs, recv_rows)
      layout[p]: process p's global shard positions (rank-major); this
      process's are layout[rank], and xs[l] is sender layout[rank][l]
      counts: int64[D, D], n[j][r] for every sender j and owner r (every
      process knows them from the owner plan)
      outs[l] is owner layout[rank][l]'s [D, cap, C], filled as above;
      recv_rows[l][j] == counts[j][layout[rank][l]]

On CUDA shards the senders' buffers come from send_buffer (memory the
kernel library allocates and exports, csrc/ragged_a2a.cu's IPC entries).
The exchange runs in two legs.  A card is named by (node, PCI bus id),
since every node of a cluster repeats the same bus ids.

  on-node leg      the pairs whose sender and owner share a node
                   (launch_plan).  The lowest rank holding a shard on a
                   card launches that card's kernel for every process's
                   senders there: it opens the other processes' senders on
                   its card and the outputs of the other processes' owners
                   (exported the same way), through CUDA IPC handles, all
                   of its own node (a handle of another node means nothing
                   here: opening one raises, and the cross_node_opens
                   counter stays 0).  A rank that leads no card launches
                   nothing.
  cross-node leg   the pairs whose owner sits on another node
                   (cross_node_pairs): one torch.distributed
                   batch_isend_irecv on the NCCL group
                   (distributed.nccl_group), each sender's xs[l][o, :m]
                   straight into the owner's outs[l'][j, :m], on a stream
                   of its own beside the kernel's launches.  NCCL binds a
                   rank to one card, so across nodes every process holds
                   its shards on one card of its own (the count checks
                   it at its start: distributed.check_node_layout).

Within one node the second leg is empty and the first is the whole
exchange.  CPU shards take the plain version: the on-node leg by
torch.distributed.all_to_all_single of the flattened segments over the
node's ranks (a gloo group of them; the whole group on one node), the
cross-node leg by the same point-to-point operations on the gloo group.
The route follows the shards' device type only: a failed allocation,
open, launch, send or receive raises on every rank (NCCL tears down a
process whose operation fails or outlasts the group's timeout, and the
others' next collective raises).  The processes meet before the launches and sends (so the
cards' launches run together) and again, once both legs are done, before
the senders' buffers are freed and the owners read.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch
import torch.distributed as dist

_TILE_WORDS = 1 << 14  # words a tile of the kernel copies (64 KB)
_MAX_SHARDS = 128  # csrc/ragged_a2a.cu's MAX_DEV
_peers_on: set = set()  # (device, peer) pairs with peer access enabled


def _check(xs, n_rows=None):
    """Validate the shards; returns (D, cap, C, counts int64[D, D])."""
    xs = list(xs)
    D = len(xs)
    if D == 0:
        raise ValueError("need at least one shard")
    shape = tuple(xs[0].shape)
    if len(shape) != 3 or shape[0] != D:
        raise ValueError(f"each shard must be [D={D}, cap, C], got {shape}")
    for x in xs:
        if x.dtype != torch.int32:
            raise ValueError(f"shards must be int32 (u32 bit views), got "
                             f"{x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError("every shard must have one shape")
        if not x.is_contiguous():
            raise ValueError("shards must be contiguous")
    kinds = {x.device.type for x in xs}
    if len(kinds) != 1:
        raise ValueError(f"shards of mixed device types {sorted(kinds)}")
    if kinds.pop() not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xs[0].device}")
    cap, C = shape[1], shape[2]
    if n_rows is None:
        counts = np.full((D, D), cap, np.int64)
    else:
        counts = np.array([np.asarray(r, dtype=np.int64).reshape(-1)
                           for r in n_rows], dtype=np.int64)
        if counts.shape != (D, D):
            raise ValueError(f"n_rows must be [D={D}][D], got {counts.shape}")
        if counts.min(initial=0) < 0 or counts.max(initial=0) > cap:
            raise ValueError(f"n_rows must lie in [0, cap={cap}]")
    return D, cap, C, counts


def _exchange_plain(xs, counts):
    D = len(xs)
    outs = [torch.empty_like(x) for x in xs]
    for r in range(D):
        for j in range(D):
            m = int(counts[j, r])
            outs[r][j, :m].copy_(xs[j][r, :m])
    return outs


def ragged_all_to_all_plain(xs, n_rows):
    """The ragged exchange by slicing and copy_ (any devices)."""
    _, _, _, counts = _check(xs, n_rows)
    return _exchange_plain(list(xs), counts), counts.T.copy()


def all_to_all_plain(xs):
    """The dense exchange by slicing and copy_ (any devices)."""
    _, _, _, counts = _check(xs)
    return _exchange_plain(list(xs), counts)


def _enable_peer(lib, dev: int, peer: int) -> None:
    from .. import _build

    if (dev, peer) in _peers_on:
        return
    err = lib.kmc_enable_peer_access(dev, peer)
    if err:
        _build.check(lib, err, f"peer access from cuda:{dev} to cuda:{peer} "
                     "refused")
    _peers_on.add((dev, peer))


def tile_rows(C: int) -> int:
    """Rows of one tile: _TILE_WORDS words, a multiple of 4 rows."""
    return max(4, _TILE_WORDS // C // 4 * 4)


def tile_list(counts, pairs, C: int) -> np.ndarray:
    """The tiles of one launch: int32[n, 4] of (owner, sender, row0, rows),
    covering rows [0, counts[sender, owner]) of every (owner, sender) pair
    of `pairs` exactly once in runs of tile_rows(C) rows (the last run of a
    pair shorter), with the pairs interleaved round-robin: tile 0 of every
    pair in the order of `pairs`, then tile 1, and so on."""
    rows = tile_rows(C)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    n = np.asarray(counts, np.int64)[pairs[:, 1], pairs[:, 0]]
    k = -(-n // rows)  # tiles of each pair
    # (tile t, pair) in row-major order: tile 0 of every pair, then tile 1
    t, pair = np.nonzero(np.arange(int(k.max(initial=0)))[:, None] < k)
    row0 = t * rows
    return np.stack([pairs[pair, 0], pairs[pair, 1], row0,
                     np.minimum(rows, n[pair] - row0)], 1).astype(np.int32)


def launch_plan(cards, layout, nodes=None) -> dict:
    """Who launches for what.  cards[g]: the card of global shard g (any
    id that names it alike in every process; across nodes it holds the
    node, as bus ids repeat from node to node); layout[p]: process p's
    global shards; nodes[g]: shard g's node (None: every shard on one
    node).  Returns {card: (leader rank, pairs)} in the order the cards
    first appear: the lowest rank holding a shard on the card launches one
    kernel there for the (owner, sender) pairs whose sender is on the card
    and whose owner is on the sender's node, the owners alternating (the
    card pushes its senders' rows to those owners' outputs).  The pairs
    that cross nodes are cross_node_pairs'."""
    D = len(cards)
    nodes = [0] * D if nodes is None else list(nodes)
    rank_of = np.empty(D, np.int64)
    for p, pos in enumerate(layout):
        rank_of[list(pos)] = p
    plan = {}
    for c in dict.fromkeys(cards):
        on = [g for g in range(D) if cards[g] == c]
        plan[c] = (int(rank_of[on].min()),
                   [(o, s) for s in on for o in range(D)
                    if nodes[o] == nodes[s]])
    return plan


def cross_node_pairs(counts, nodes) -> np.ndarray:
    """The exchange's cross-node leg: int64[n, 3] of (sender, owner, rows)
    for every pair whose sender and owner sit on different nodes (nodes[g]:
    shard g's node), rows = counts[sender, owner], sender-major.  With
    launch_plan's pairs it covers every (owner, sender) pair once."""
    nodes = np.unique(np.asarray(nodes), return_inverse=True)[1].reshape(-1)
    s, o = np.nonzero(nodes[:, None] != nodes[None, :])
    counts = np.asarray(counts, np.int64)
    return np.stack([s, o, counts[s, o]], 1).astype(np.int64).reshape(-1, 3)


_tile_cache: dict = {}  # (device, C, pairs, counts) -> tiles on the card
_TILE_CACHE_ENTRIES = 16
_loaded: set = set()  # devices with the kernel's module loaded


def _device_tiles(lib, dev: int, counts, pairs, C: int):
    """tile_list's tiles on card dev, uploaded once for each plan and counts
    (the dense exchange's and a repeated exchange's are the same every
    call); returns (tensor, n)."""
    from .. import _build

    if dev not in _loaded:  # the kernel's module, before any launch
        _build.check(lib, lib.kmc_exchange_load(dev), f"loading the "
                     f"exchange kernel on cuda:{dev}")
        _loaded.add(dev)
    counts = np.ascontiguousarray(counts, np.int64)
    key = (dev, C, tuple(pairs), counts.tobytes())
    hit = _tile_cache.get(key)
    if hit is None:
        tiles = tile_list(counts, pairs, C)
        hit = (torch.from_numpy(tiles).to(torch.device("cuda", dev),
                                          non_blocking=True), len(tiles))
        if len(_tile_cache) >= _TILE_CACHE_ENTRIES:
            _tile_cache.pop(next(iter(_tile_cache)))
        _tile_cache[key] = hit
    return hit


def _launch(lib, dev: int, ptrs, tiles, cap: int, C: int) -> int:
    """One card's launch on its current stream: ptrs, int64[2 * D] (the
    senders' then the outputs' pointers as the card sees them), tiles from
    _device_tiles.  Returns 1, or 0 when there is no tile."""
    from .. import _build

    t, n = tiles
    ptrs = np.ascontiguousarray(ptrs, np.uint64).view(np.int64)
    counter = torch.empty(1, dtype=torch.int64,
                          device=torch.device("cuda", dev))
    err = lib.kmc_exchange_tiles(dev, ptrs.ctypes.data, t.data_ptr(), n,
                                 len(ptrs) // 2, cap, C, counter.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "all-to-all launch")
    return int(n > 0)


def _exchange_kernel(xs, counts):
    """One launch a card (launch_plan), each on the card's current stream.
    Returns (outs, number of launches)."""
    from .. import _build

    lib = _build.load("ragged_a2a")
    D = len(xs)
    cap, C = xs[0].shape[1], xs[0].shape[2]
    if cap >= 1 << 31 or D > _MAX_SHARDS:
        raise ValueError(f"the kernel takes cap < 2^31 and at most "
                         f"{_MAX_SHARDS} shards, got cap {cap}, {D} shards")
    cards = [x.device.index for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    plan = launch_plan(cards, [list(range(D))])
    # the other cards a card's launch writes
    peers = {c: sorted({cards[g] for pair in pairs for g in pair} - {c})
             for c, (_, pairs) in plan.items()}
    for c, qs in peers.items():
        for q in qs:
            _enable_peer(lib, c, q)
    ptrs = [x.data_ptr() for x in xs] + [o.data_ptr() for o in outs]
    tiles = {c: _device_tiles(lib, c, counts, pairs, C)
             for c, (_, pairs) in plan.items()}
    streams = {c: torch.cuda.current_stream(c) for c in plan}
    multi = any(peers.values())
    if multi:
        # a card writes an owner's block on another card only once that
        # card's stream is done with the memory
        ready = {}
        for c, s in streams.items():
            ready[c] = torch.cuda.Event()
            ready[c].record(s)
        for c, qs in peers.items():
            for q in qs:
                streams[c].wait_event(ready[q])
    launches = sum(_launch(lib, c, ptrs, tiles[c], cap, C) for c in plan)
    if multi:
        # and the owner's card reads it only after the launch is done
        for c, qs in peers.items():
            done = torch.cuda.Event()
            done.record(streams[c])
            for q in qs:
                streams[q].wait_event(done)
    return outs, launches


def ragged_all_to_all(xs, n_rows):
    """The ragged exchange (see the module docstring).  CPU shards take the
    plain version; CUDA shards launch the kernel, once a card on the card's
    current stream (each launch counted); anything else raises."""
    D, _, _, counts = _check(xs, n_rows)
    xs = list(xs)
    if xs[0].device.type == "cpu":
        return _exchange_plain(xs, counts), counts.T.copy()
    outs, n = _exchange_kernel(xs, counts)
    ragged_all_to_all.launches += n
    return outs, counts.T.copy()


def all_to_all(xs):
    """The dense exchange: outs[r][j] == xs[j][r].  CPU shards take the
    plain version; CUDA shards launch the kernel with every segment full,
    once a card (each launch counted); anything else raises."""
    _, _, _, counts = _check(xs)
    xs = list(xs)
    if xs[0].device.type == "cpu":
        return _exchange_plain(xs, counts)
    outs, n = _exchange_kernel(xs, counts)
    all_to_all.launches += n
    return outs


ragged_all_to_all.launches = 0
all_to_all.launches = 0


# -- across processes --

_IPC_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)
_ipc_buffers: dict = {}  # data_ptr -> _IpcBuffer of this process's senders


class _IpcBuffer:
    """A buffer in memory the kernel library allocated (kmc_ipc_alloc) and
    exported: a sender's, or the output of an owner whose card another
    process launches for; torch views it through the CUDA array interface
    (and holds this object while the view lives)."""

    def __init__(self, shape, device: torch.device):
        from .. import _build

        self.lib = _build.load("ragged_a2a")
        self.device = device
        self.shape = tuple(int(x) for x in shape)
        nbytes = max(4 * int(np.prod(self.shape)), 4)
        ptr = ctypes.c_void_p()
        self.handle = ctypes.create_string_buffer(_IPC_HANDLE_BYTES)
        err = self.lib.kmc_ipc_alloc(device.index, nbytes, ctypes.byref(ptr),
                                     self.handle)
        _build.check(self.lib, err, "IPC buffer allocation")
        self.ptr = ptr.value

    @property
    def __cuda_array_interface__(self):
        return {"shape": self.shape, "typestr": "<i4",
                "data": (self.ptr, False), "version": 2}

    def tensor(self) -> torch.Tensor:
        t = torch.as_tensor(self, device=self.device)
        if t.data_ptr() != self.ptr:
            self.free()
            raise RuntimeError("torch did not view the IPC buffer in place")
        return t

    def free(self):
        from .. import _build

        if self.ptr is not None:
            err = self.lib.kmc_ipc_free(self.device.index, self.ptr)
            self.ptr = None
            _build.check(self.lib, err, "IPC buffer free")

    def __del__(self):
        # an output's memory goes with the last view of it (every process
        # that opened it has closed it before the exchange returned)
        if self.ptr is not None:
            self.lib.kmc_ipc_free(self.device.index, self.ptr)
            self.ptr = None


def send_buffer(shape, device, multi: bool) -> torch.Tensor:
    """An int32 tensor of `shape` for one sender of an exchange: on a card
    in a multi-process exchange, memory exported for CUDA IPC (freed by the
    exchange), else torch.empty."""
    device = torch.device(device)
    if not multi or device.type != "cuda":
        return torch.empty(shape, dtype=torch.int32, device=device)
    buf = _IpcBuffer(shape, device)
    t = buf.tensor()
    _ipc_buffers[buf.ptr] = buf
    return t


def _shard_nodes(layout, nodes) -> list:
    """Each global shard's node: nodes[p] for the shards of layout[p]."""
    out = [None] * sum(map(len, layout))
    for p, pos in enumerate(layout):
        for g in pos:
            out[g] = nodes[p]
    return out


def _cross_ops(xs, outs, cross, layout, rank, group):
    """This process's operations of the cross-node leg: for every pair of
    cross_node_pairs with rows, the sender's xs[l][o, :m] goes to the
    owner's outs[l'][j, :m] by torch.distributed point-to-point on `group`
    (peers by global rank).  Both sides post a pair of ranks' operations in
    the pairs' (sender, owner) order, which is how NCCL matches them; the
    tag names the pair for gloo."""
    D = sum(map(len, layout))
    rank_of = {g: p for p, pos in enumerate(layout) for g in pos}
    idx = {g: l for l, g in enumerate(layout[rank])}
    ops = []
    for s, o, m in cross.tolist():
        if m == 0:
            continue
        if s in idx:
            ops.append(dist.P2POp(dist.isend, xs[idx[s]][o, :m], rank_of[o],
                                  group, s * D + o))
        elif o in idx:
            ops.append(dist.P2POp(dist.irecv, outs[idx[o]][s, :m],
                                  rank_of[s], group, s * D + o))
    return ops


def _plain_processes(xs, counts, layout, rank, nodes):
    """The on-node leg by all_to_all_single of the flattened segments over
    the node's ranks (the whole group on one node): to process q go, owner
    by owner of q's, each local sender's rows for that owner; split sizes
    from counts, which every process holds.  Across nodes the cross-node
    pairs go by gloo point-to-point on the whole group (_cross_ops),
    posted before the all-to-all and waited on after it."""
    from .distributed import node_group

    D = counts.shape[0]
    cap, C = xs[0].shape[1], xs[0].shape[2]
    mine = layout[rank]
    outs = [torch.empty((D, cap, C), dtype=torch.int32) for _ in mine]
    here = [p for p, node in enumerate(nodes) if node == nodes[rank]]
    group, works = None, []
    if len(here) < len(layout):
        group = node_group()
        cross = cross_node_pairs(counts, _shard_nodes(layout, nodes))
        ops = _cross_ops(xs, outs, cross, layout, rank, None)
        works = dist.batch_isend_irecv(ops) if ops else []
    near = [layout[p] for p in here]
    parts, in_split = [], []
    for q_pos in near:
        n = 0
        for o in q_pos:
            for l, j in enumerate(mine):
                m = int(counts[j, o])
                parts.append(xs[l][o, :m].reshape(-1))
                n += m * C
        in_split.append(n)
    out_split = [sum(int(counts[j, o]) for o in mine for j in p_pos) * C
                 for p_pos in near]
    send = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int32)
    recv = torch.empty(sum(out_split), dtype=torch.int32)
    dist.all_to_all_single(recv, send, out_split, in_split, group=group)
    at = 0
    for p_pos in near:
        for l, o in enumerate(mine):
            for j in p_pos:
                m = int(counts[j, o])
                outs[l][j, :m] = recv[at:at + m * C].view(m, C)
                at += m * C
    for w in works:
        w.wait()
    return outs


_card_ids: dict = {}  # device index -> PCI bus id


def _card_id(lib, index: int) -> str:
    from .. import _build

    if index not in _card_ids:
        buf = ctypes.create_string_buffer(32)
        _build.check(lib, lib.kmc_pci_bus_id(index, buf, len(buf)),
                     f"PCI bus id of cuda:{index}")
        _card_ids[index] = buf.value.decode()
    return _card_ids[index]


def _kernel_processes(xs, counts, layout, rank, nodes):
    """One launch a card over the on-node pairs of every process's shards,
    and the cross-node pairs by NCCL beside it (see the module docstring);
    returns (outs, launches)."""
    from .. import _build
    from .distributed import nccl_group

    lib = _build.load("ragged_a2a")
    D = counts.shape[0]
    cap, C = xs[0].shape[1], xs[0].shape[2]
    if cap >= 1 << 31 or D > _MAX_SHARDS:
        raise ValueError(f"the kernel takes cap < 2^31 and at most "
                         f"{_MAX_SHARDS} shards, got cap {cap}, {D} shards")
    mine = layout[rank]
    bufs = []
    for x in xs:
        buf = _ipc_buffers.get(x.data_ptr())
        if buf is None:
            raise ValueError("a sender's buffer of a cross-process exchange "
                             "must come from send_buffer")
        bufs.append(buf)
    world = dist.get_world_size()
    devs = [x.device for x in xs]
    got = [None] * world
    dist.all_gather_object(got, ([b.handle.raw for b in bufs],
                                 [_card_id(lib, d.index) for d in devs]))
    # a card is (node, PCI bus id): every node repeats the same bus ids
    cards, send_h, rank_of = [None] * D, [None] * D, [0] * D
    for p, pos in enumerate(layout):
        for i, g in enumerate(pos):
            send_h[g], rank_of[g] = got[p][0][i], p
            cards[g] = (nodes[p], got[p][1][i])
    node_of = _shard_nodes(layout, nodes)
    me = nodes[rank]
    opened = {}  # (device, buffer kind, shard) -> pointer opened there
    try:
        plan = launch_plan(cards, layout, node_of)
        cross = cross_node_pairs(counts, node_of)
        # the NCCL group, on this process's one card: made at the count's
        # start, after its layout check (distributed.Fleet), or by every
        # rank here at a direct call's first cross-node exchange
        nccl = nccl_group(devs[0]) if len(set(nodes)) > 1 else None
        # an owner's output is exported when another process's launch
        # writes it
        exported = [False] * D
        for leader, pairs in plan.values():
            for o, _ in pairs:
                exported[o] |= leader != rank_of[o]
        led = {c: pairs for c, (leader, pairs) in plan.items()
               if leader == rank}
        failed = None
        outs, out_bufs = [], []
        try:
            for l, g in enumerate(mine):
                if exported[g]:
                    out_bufs.append(_IpcBuffer((D, cap, C), devs[l]))
                    outs.append(out_bufs[-1].tensor())
                else:
                    outs.append(torch.empty((D, cap, C), dtype=torch.int32,
                                            device=devs[l]))
            for dev in set(devs):
                torch.cuda.synchronize(dev)  # the senders' rows are written
        except Exception as e:  # noqa: BLE001 - raised after the meeting
            failed = e
        got = [None] * world
        dist.all_gather_object(got, (failed is None,
                                     [b.handle.raw for b in out_bufs]))
        if failed is not None:
            raise failed
        if not all(ok for ok, _ in got):
            raise RuntimeError("a peer process could not allocate the "
                               "outputs of the exchange")
        out_h = [None] * D
        for p, pos in enumerate(layout):
            for g, h in zip([g for g in pos if exported[g]], got[p][1]):
                out_h[g] = h
        local = {(me, _card_id(lib, d.index)): d.index for d in devs}
        launch_args = {}
        try:
            # each card this process launches for: the pointers as that
            # card sees them and its tiles, before the launches
            for c, pairs in led.items():
                dev = local[c]
                ptrs = np.zeros(2 * D, np.uint64)
                for kind, shards, own, handles in (
                        (0, {s for _, s in pairs}, xs, send_h),
                        (1, {o for o, _ in pairs}, outs, out_h)):
                    for g in sorted(shards):
                        if rank_of[g] == rank:
                            t = own[mine.index(g)]
                            if t.device.index != dev:
                                _enable_peer(lib, dev, t.device.index)
                            ptrs[kind * D + g] = t.data_ptr()
                            continue
                        if node_of[g] != me:  # a handle means nothing there
                            ragged_all_to_all_processes.cross_node_opens += 1
                            raise RuntimeError(
                                f"opening shard {g}'s handle of node "
                                f"{node_of[g]!r} on node {me!r}")
                        ptr = ctypes.c_void_p()
                        err = lib.kmc_ipc_open(dev, handles[g],
                                               ctypes.byref(ptr))
                        _build.check(lib, err, f"opening shard {g}'s "
                                     f"{'output' if kind else 'sender'} "
                                     f"(rank {rank_of[g]}) on cuda:{dev}")
                        opened[(dev, kind, g)] = ptr.value
                        ptrs[kind * D + g] = ptr.value
                launch_args[dev] = (ptrs, _device_tiles(lib, dev, counts,
                                                        pairs, C))
            ops = _cross_ops(xs, outs, cross, layout, rank, nccl)
            events = {dev: (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                      for dev in launch_args}
            leg = (torch.cuda.Stream(devs[0]),
                   torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) if ops else None
            for dev in launch_args:
                torch.cuda.synchronize(dev)  # the tiles are on the card
        except Exception as e:  # noqa: BLE001 - raised after the meeting
            failed = e
        # the group meets before any launch or send (so the cards'
        # launches run together), and no process starts when one could
        # not open
        ready = [None] * world
        dist.all_gather_object(ready, failed is None)
        if failed is not None:
            raise failed
        if not all(ready):
            raise RuntimeError("a peer process could not open the buffers "
                               "of the exchange")
        launches = 0
        ragged_all_to_all_processes.span = None
        if launch_args or ops:
            for dev, (start, _) in events.items():
                start.record(torch.cuda.current_stream(dev))
            t0 = time.monotonic()
            for dev, (ptrs, tiles) in launch_args.items():
                launches += _launch(lib, dev, ptrs, tiles, cap, C)
            for dev, (_, end) in events.items():
                end.record(torch.cuda.current_stream(dev))
            if leg:
                # the cross-node leg on a stream of its own, beside the
                # launches: NCCL's stream waits on it, and it on NCCL's
                stream, start, end = leg
                with torch.cuda.stream(stream):
                    start.record(stream)
                    for w in dist.batch_isend_irecv(ops):
                        w.wait()
                    end.record(stream)
            # a peer that died leaves a receive pending on the card: the
            # NCCL group's watchdog tears this process down at its timeout
            for dev in {d.index for d in devs} | set(launch_args):
                torch.cuda.synchronize(dev)  # every peer read and write done
            ragged_all_to_all_processes.span = (t0, time.monotonic())
            if events:
                ragged_all_to_all_processes.kernel_ms += max(
                    a.elapsed_time(b) for a, b in events.values())
            if leg:
                ragged_all_to_all_processes.nccl_ms += start.elapsed_time(end)
    finally:
        errs = [lib.kmc_ipc_close(dev, ptr)
                for (dev, _, _), ptr in opened.items()]
        dist.barrier()  # no process touches another's buffers any more
        for b in bufs:
            _ipc_buffers.pop(b.ptr, None)
            b.free()
    for err in errs:
        _build.check(lib, err, "closing a peer's buffer")
    return outs, launches


def ragged_all_to_all_processes(xs, counts, layout):
    """The ragged exchange across the processes of a torch.distributed
    group (see the module docstring).  xs are consumed: on cards their
    memory is freed once every owner has read it."""
    from .distributed import rank_nodes

    rank = dist.get_rank()
    counts = np.asarray(counts, dtype=np.int64)
    D = counts.shape[0]
    mine = layout[rank]
    xs = list(xs)
    if len(xs) != len(mine) or sum(map(len, layout)) != D:
        raise ValueError("the senders must be this process's shards of the "
                         "layout")
    if xs:
        _check([xs[0]] * D, None)  # shape, dtype, contiguity, device kind
    for x in xs:
        if tuple(x.shape) != tuple(xs[0].shape) or x.dtype != torch.int32:
            raise ValueError("every sender must be one int32 [D, cap, C]")
    if counts.shape != (D, D) or counts.min(initial=0) < 0 \
            or counts.max(initial=0) > xs[0].shape[1]:
        raise ValueError("counts must be [D, D] within [0, cap]")
    recv_rows = counts[:, mine].T.copy()
    nodes = rank_nodes()
    if xs[0].device.type == "cpu":
        return _plain_processes(xs, counts, layout, rank, nodes), recv_rows
    outs, n = _kernel_processes(xs, counts, layout, rank, nodes)
    xp = ragged_all_to_all_processes
    xp.launches += n
    row = 4 * xs[0].shape[2]
    xp.bytes += int(2 * row * counts[:, mine].sum())
    near = np.array([node == nodes[rank]
                     for node in _shard_nodes(layout, nodes)])
    others = np.setdiff1d(np.flatnonzero(near), mine)
    xp.peer_bytes += int(row * counts[np.ix_(others, mine)].sum())
    xp.sent_rows += int(counts[np.ix_(mine, np.flatnonzero(near))].sum())
    xp.cross_node_bytes += int(
        row * counts[np.ix_(mine, np.flatnonzero(~near))].sum())
    return outs, recv_rows


# Counters of this process, summed over the exchanges: launches of the
# kernel (one a card it leads whose senders have a row for an owner of
# their node); the kernel's device milliseconds (CUDA events, the slowest
# card's); the bytes its owners' rows take to read and write (both legs)
# and, of them, the bytes the kernel read from other processes' senders of
# this node; the rows its senders sent on the on-node leg; the bytes its
# senders sent on the cross-node leg, and that leg's device milliseconds
# (CUDA events on the leg's own stream); the opens of another node's IPC
# handle that the guard refused, each one raising: launch_plan keeps every
# such pair out of the kernel's leg, so this stays 0 unless the plan
# breaks, and the reports print it as the record that no cross-node open
# was tried.  span: the
# last exchange's host monotonic clock from this process's first launch or
# send to its card's synchronize (None when it did neither); the clock is
# one for every process of a node, so the spans of a node's processes
# together bound its exchange, and spans of different nodes do not compose
ragged_all_to_all_processes.launches = 0
ragged_all_to_all_processes.kernel_ms = 0.0
ragged_all_to_all_processes.bytes = 0
ragged_all_to_all_processes.peer_bytes = 0
ragged_all_to_all_processes.sent_rows = 0
ragged_all_to_all_processes.cross_node_bytes = 0
ragged_all_to_all_processes.nccl_ms = 0.0
ragged_all_to_all_processes.cross_node_opens = 0
ragged_all_to_all_processes.span = None
