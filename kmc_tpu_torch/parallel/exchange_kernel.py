"""The owner exchange: ragged and dense all-to-all between the store's shards.

Kernel: csrc/ragged_a2a.cu, which takes the place of the TPU kernels
kmc_tpu/parallel/pallas_a2a.py::pallas_ragged_all_to_all and (as the dense
entry) pallas_all_to_all; see the source for its design and bound.  One
process drives every shard, so the owner's kernel reads the senders'
buffers directly: on one card as a device copy, across cards over peer
access.  Plain versions: ragged_all_to_all_plain and all_to_all_plain
below, built from slicing and copy_; the wrappers take them for CPU tensors
only, and the kernel is held against them on the card.

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
kernel library allocates and exports, csrc/ragged_a2a.cu's IPC entries):
the owners' launches read the other processes' buffers through CUDA IPC
handles and their own directly.  CPU shards take the plain version,
torch.distributed.all_to_all_single of the flattened segments over the
group.  The route follows the shards' device type only: a failed open or
launch raises.  The processes meet before the owners' launches (so the
launches of every process run together) and again before the senders'
buffers are freed.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch
import torch.distributed as dist

_CHUNK_ROWS = 2048  # rows per block of the kernel (a multiple of 4)
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


def _exchange_kernel(xs, counts):
    """Launch the kernel once per owner, on the owner's current stream.
    Returns (outs, number of launches)."""
    from .. import _build

    lib = _build.load("ragged_a2a")
    D = len(xs)
    cap, C = xs[0].shape[1], xs[0].shape[2]
    devs = [x.device for x in xs]
    streams = [torch.cuda.current_stream(d) for d in devs]
    multi = len({d.index for d in devs}) > 1
    ready = []
    if multi:
        # an owner reads a sender's buffer only once the sender's stream has
        # written it
        for j in range(D):
            ev = torch.cuda.Event()
            ev.record(streams[j])
            ready.append(ev)
    # the table (senders' base pointers, then the D x D counts) is the same
    # for every owner: one pinned, asynchronous copy per card
    table_h = torch.from_numpy(np.concatenate(
        [np.array([x.data_ptr() for x in xs], np.uint64).view(np.int64),
         counts.reshape(-1)]))
    tables = {}
    outs = []
    launches = 0
    for r in range(D):
        dev = devs[r].index
        for j in range(D):
            if devs[j].index != dev:
                _enable_peer(lib, dev, devs[j].index)
                streams[r].wait_event(ready[j])
        if dev not in tables:
            with torch.cuda.device(dev):
                tables[dev] = table_h.pin_memory().to(devs[r],
                                                      non_blocking=True)
        out = torch.empty_like(xs[r])
        n_chunks = -(-int(counts[:, r].max()) // _CHUNK_ROWS)
        err = lib.kmc_ragged_a2a_owner(
            dev, tables[dev].data_ptr(), D, r, cap, C, _CHUNK_ROWS, n_chunks,
            out.data_ptr(), streams[r].cuda_stream)
        _build.check(lib, err, "ragged all-to-all launch")
        launches += 1
        outs.append(out)
    if multi:
        # a sender's memory may be reused only after every owner's read
        for r in range(D):
            ev = torch.cuda.Event()
            ev.record(streams[r])
            for j in range(D):
                if devs[j].index != devs[r].index:
                    streams[j].wait_event(ev)
    return outs, launches


def ragged_all_to_all(xs, n_rows):
    """The ragged exchange (see the module docstring).  CPU shards take the
    plain version; CUDA shards launch the kernel, once per owner on the
    owner's current stream (each launch counted); anything else raises."""
    D, _, _, counts = _check(xs, n_rows)
    xs = list(xs)
    if xs[0].device.type == "cpu":
        return _exchange_plain(xs, counts), counts.T.copy()
    outs, n = _exchange_kernel(xs, counts)
    ragged_all_to_all.launches += n
    return outs, counts.T.copy()


def all_to_all(xs):
    """The dense exchange: outs[r][j] == xs[j][r].  CPU shards take the
    plain version; CUDA shards launch the kernel with every segment full
    (each launch counted); anything else raises."""
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
    """A sender's buffer in memory the kernel library allocated
    (kmc_ipc_alloc) and exported; torch views it through the CUDA array
    interface."""

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
        _build.check(self.lib, err, "IPC send buffer allocation")
        self.ptr = ptr.value

    @property
    def __cuda_array_interface__(self):
        return {"shape": self.shape, "typestr": "<i4",
                "data": (self.ptr, False), "version": 2}

    def free(self):
        from .. import _build

        if self.ptr is not None:
            err = self.lib.kmc_ipc_free(self.device.index, self.ptr)
            self.ptr = None
            _build.check(self.lib, err, "IPC send buffer free")


def send_buffer(shape, device, multi: bool) -> torch.Tensor:
    """An int32 tensor of `shape` for one sender of an exchange: on a card
    in a multi-process exchange, memory exported for CUDA IPC (freed by the
    exchange), else torch.empty."""
    device = torch.device(device)
    if not multi or device.type != "cuda":
        return torch.empty(shape, dtype=torch.int32, device=device)
    buf = _IpcBuffer(shape, device)
    t = torch.as_tensor(buf, device=device)
    if t.data_ptr() != buf.ptr:
        buf.free()
        raise RuntimeError("torch did not view the IPC send buffer in place")
    _ipc_buffers[buf.ptr] = buf
    return t


def _plain_processes(xs, counts, layout, rank):
    """all_to_all_single of the flattened segments: to process q go, owner
    by owner of q's, each local sender's rows for that owner; split sizes
    from counts, which every process holds."""
    D = counts.shape[0]
    cap, C = xs[0].shape[1], xs[0].shape[2]
    mine = layout[rank]
    parts, in_split = [], []
    for q_pos in layout:
        n = 0
        for o in q_pos:
            for l, j in enumerate(mine):
                m = int(counts[j, o])
                parts.append(xs[l][o, :m].reshape(-1))
                n += m * C
        in_split.append(n)
    out_split = [sum(int(counts[j, o]) for o in mine for j in p_pos) * C
                 for p_pos in layout]
    send = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int32)
    recv = torch.empty(sum(out_split), dtype=torch.int32)
    dist.all_to_all_single(recv, send, out_split, in_split)
    outs = [torch.empty((D, cap, C), dtype=torch.int32) for _ in mine]
    at = 0
    for p_pos in layout:
        for l, o in enumerate(mine):
            for j in p_pos:
                m = int(counts[j, o])
                outs[l][j, :m] = recv[at:at + m * C].view(m, C)
                at += m * C
    return outs


def _kernel_processes(xs, counts, layout, rank):
    """The owners' launches over every process's senders (see the module
    docstring); returns (outs, launches)."""
    from .. import _build

    lib = _build.load("ragged_a2a")
    D = counts.shape[0]
    cap, C = xs[0].shape[1], xs[0].shape[2]
    mine = layout[rank]
    bufs = []
    for x in xs:
        buf = _ipc_buffers.get(x.data_ptr())
        if buf is None:
            raise ValueError("a sender's buffer of a cross-process exchange "
                             "must come from send_buffer")
        bufs.append(buf)
    for dev in {x.device for x in xs}:
        torch.cuda.synchronize(dev)  # the senders' rows are written
    handles = [None] * dist.get_world_size()
    dist.all_gather_object(handles, [b.handle.raw for b in bufs])
    opened = {}  # (device, sender) -> pointer opened on that device
    try:
        failed = None
        try:
            # one table a card (the senders' pointers as that card sees
            # them, then the counts) and every output, before the launches
            tables = {}
            for dev in dict.fromkeys(x.device for x in xs):
                ptrs = []
                for p, p_pos in enumerate(layout):
                    for i, j in enumerate(p_pos):
                        if p == rank:
                            ptrs.append(xs[i].data_ptr())
                            continue
                        ptr = ctypes.c_void_p()
                        err = lib.kmc_ipc_open(dev.index, handles[p][i],
                                               ctypes.byref(ptr))
                        _build.check(lib, err, f"opening sender {j}'s "
                                     f"buffer (rank {p}) on {dev}")
                        opened[(dev.index, j)] = ptr.value
                        ptrs.append(ptr.value)
                tables[dev] = torch.from_numpy(np.concatenate(
                    [np.array(ptrs, np.uint64).view(np.int64),
                     counts.reshape(-1)])).to(dev)
            outs = [torch.empty((D, cap, C), dtype=torch.int32,
                                device=x.device) for x in xs]
            events = {dev: (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                      for dev in tables}
        except Exception as e:  # noqa: BLE001 - raised after the meeting
            failed = e
        # the group meets before any launch (so every process's launches
        # run together), and no process launches when one could not open
        ready = [None] * dist.get_world_size()
        dist.all_gather_object(ready, failed is None)
        if failed is not None:
            raise failed
        if not all(ready):
            raise RuntimeError("a peer process could not open the senders' "
                               "buffers of the exchange")
        for dev, (start, _) in events.items():
            start.record(torch.cuda.current_stream(dev))
        t0 = time.monotonic()
        for l, o in enumerate(mine):
            dev = xs[l].device
            n_chunks = -(-int(counts[:, o].max()) // _CHUNK_ROWS)
            err = lib.kmc_ragged_a2a_owner(
                dev.index, tables[dev].data_ptr(), D, o, cap, C, _CHUNK_ROWS,
                n_chunks, outs[l].data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check(lib, err, "ragged all-to-all launch")
        for dev, (_, end) in events.items():
            end.record(torch.cuda.current_stream(dev))
        for dev in tables:
            torch.cuda.synchronize(dev)  # every read of a peer is done
        ragged_all_to_all_processes.span = (t0, time.monotonic())
        ragged_all_to_all_processes.kernel_ms += max(
            a.elapsed_time(b) for a, b in events.values())
    finally:
        errs = [lib.kmc_ipc_close(dev, ptr)
                for (dev, _), ptr in opened.items()]
        dist.barrier()  # no process reads another's buffers any more
        for b in bufs:
            _ipc_buffers.pop(b.ptr, None)
            b.free()
    for err in errs:
        _build.check(lib, err, "closing a peer's buffer")
    return outs, len(mine)


def ragged_all_to_all_processes(xs, counts, layout):
    """The ragged exchange across the processes of a torch.distributed
    group (see the module docstring).  xs are consumed: on cards their
    memory is freed once every owner has read it."""
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
    if xs[0].device.type == "cpu":
        return _plain_processes(xs, counts, layout, rank), recv_rows
    outs, n = _kernel_processes(xs, counts, layout, rank)
    ragged_all_to_all_processes.launches += n
    row = 4 * xs[0].shape[2]
    ragged_all_to_all_processes.bytes += int(2 * row * counts[:, mine].sum())
    peers = np.setdiff1d(np.arange(D), mine)
    ragged_all_to_all_processes.peer_bytes += int(
        row * counts[np.ix_(peers, mine)].sum())
    return outs, recv_rows


# launches of the kernel; the device milliseconds of this process's owner
# launches (CUDA events, the slowest card's), the bytes they read and
# wrote and, of them, the bytes read from other processes' senders, summed
# over the exchanges; and the last exchange's host monotonic
# clock (one clock for every process of a machine) from this process's
# first launch to its cards' synchronize, so the processes' spans together
# bound the whole exchange
ragged_all_to_all_processes.launches = 0
ragged_all_to_all_processes.kernel_ms = 0.0
ragged_all_to_all_processes.bytes = 0
ragged_all_to_all_processes.peer_bytes = 0
ragged_all_to_all_processes.span = None
