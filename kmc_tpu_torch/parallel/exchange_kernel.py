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
"""
from __future__ import annotations

import numpy as np
import torch

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
