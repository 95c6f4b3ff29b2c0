"""Devices of a multi-device count, and the SPMD count step (the port's
kmc_tpu/parallel/distributed.py).

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
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.extract import i32_to_u32, u32_to_i32
from ..ops.sort_kernel import radix_sort_columns
from ..ops.sortcount import stage1_batch
from ..ops.store import _group_reduce
from .exchange_kernel import all_to_all


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
