"""Worker process for the port's multi-process distributed_count tests: one
of N torch.distributed (gloo) processes, each driving its own shards of one
store.  The twin of tests/multiproc_worker.py (kmc_tpu's worker), run as

    python torch_multiproc_worker.py <coordinator> <n_procs> <pid> <reads> <out>

<coordinator> is "host:port" or an init URL ("file:///path": processes of
one node, no port to race for).  It reads tests/multiproc_worker.py's
environment knobs (MP_K, MP_BATCH, MP_CI, MP_CAPACITY, MP_SHARD_INPUT,
MP_MIN_SHARD, MP_HEARTBEAT_SECS, MP_CRASH_SECS, MP_CRASH_PID) and two more:

  MP_DEVICES  this process's shards, comma-separated (default "cpu,cpu");
              "{pid}" in an entry stands for the rank, so "cuda:{pid}"
              gives each process its own card; lists separated by ";"
              are each rank's own, indexed by the rank
              ("cuda:0,cuda:1;cuda:2,cuda:3": two processes of two cards)
  MP_MODES    the counts to run one after the other, comma-separated
              (default "default"): default, k13, kff, e (-e), opt
              (--opt-out-size), greedy, spill (the default count on shards
              of MP_SPILL_CAPACITY rows, default 2^11); "<mode>@<bytes>"
              sets the -m plan's spill budget of that count
  MP_NODE     emulates several nodes on one machine: this process's node
              name, or a comma-separated list of every process's, indexed
              by the rank ("0,0,1,1": ranks 0-1 on one node, 2-3 on
              another).  The worker makes socket.gethostname return
              "node<name>" before init_multihost, which records it as the
              rank's node; unset, the real host name stands
  MP_CRASH_AT "p2p": process MP_CRASH_PID dies (exit 17) where it would
              post the exchange's cross-node leg, after the NCCL groups'
              own warm-up (the fault-injection tests' dead peer across
              nodes)

Each mode m counts into <out>.<m> ("@" written "_"); process 0 writes the
database, and every process writes <out>.<m>.stats.<pid>: JSON of
{"stats": the returned stats, "launches": the exchange kernel's
cross-process launches in that count, "kernels": each kernel's launches,
"exchange_ms" / "exchange_bytes" / "exchange_peer_bytes" /
"exchange_sent_rows": the cross-process exchange kernel's device time in
this process, the bytes its owners read and wrote and of them those the
kernel read from other processes' senders of its node, the rows its
senders sent to owners of their node, "exchange_cross_node_bytes" /
"exchange_cross_node_in_bytes" / "exchange_nccl_ms" /
"exchange_cross_node_opens": the bytes its senders sent to other nodes
and its owners received from them, that NCCL leg's device time (its
slowest slot's), the IPC opens of another node's handles (0),
"exchange_slot_nccl_ms": each card slot's NCCL time,
"exchange_staged_bytes" / "exchange_staging_ms": the bytes its senders
staged onto a card of another slot for the NCCL leg (CPU shards: each a
slot of its own) and the staging copies' device time, "node": this
process's node, "nccl_init_s" / "nccl_warmup_s": each slot's host seconds
of its NCCL group's communicator and of its cross-node pairs' warm-up
(null before a group across nodes on cards made them), "exchange_span": the
host monotonic clock around this process's launches and sends of the
count's exchange (null without one; spans compose within a node only),
"wall_s", "peak_bytes": the peak device memory of each card (CUDA
shards)}, or {"error": "MemoryError", "message": ...} when the count
raised MemoryError.  Imports neither jax nor kmc_tpu.
"""
import copy
import dataclasses
import faulthandler
import json
import os
import signal
import socket
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the result's name of each counter of the cross-process exchange
# (exchange_kernel.py's ragged_all_to_all_processes)
XP_COUNTERS = (
    ("launches", "launches"), ("exchange_ms", "kernel_ms"),
    ("exchange_bytes", "bytes"), ("exchange_peer_bytes", "peer_bytes"),
    ("exchange_sent_rows", "sent_rows"),
    ("exchange_cross_node_bytes", "cross_node_bytes"),
    ("exchange_cross_node_in_bytes", "cross_node_in_bytes"),
    ("exchange_nccl_ms", "nccl_ms"),
    ("exchange_slot_nccl_ms", "slot_nccl_ms"),
    ("exchange_staged_bytes", "staged_bytes"),
    ("exchange_staging_ms", "staging_ms"),
    ("exchange_cross_node_opens", "cross_node_opens"))

MODES = {
    "default": {},
    "k13": dict(k=13),
    "kff": dict(output_type="kff"),
    "e": dict(estimate_only=True),
    "opt": dict(opt_out_size=True),
    "greedy": dict(signature_map_policy="greedy"),
    "spill": {},
}


def _launches():
    """Each kernel's launch count so far (the fused ingest's greedy entry
    counted apart as well)."""
    from kmc_tpu_torch.ops.extract_kernel import extract_splitter_scan
    from kmc_tpu_torch.ops.ingest_kernel import ingest
    from kmc_tpu_torch.ops.sort_kernel import radix_sort_columns
    from kmc_tpu_torch.parallel.exchange_kernel import (
        ragged_all_to_all, ragged_all_to_all_processes)

    return {"fused_ingest": ingest.launches,
            "greedy_entry": ingest.greedy_launches,
            "splitter_scan": extract_splitter_scan.launches,
            "radix_sort": radix_sort_columns.launches,
            "ragged_all_to_all": ragged_all_to_all.launches,
            "ragged_all_to_all_processes":
                ragged_all_to_all_processes.launches}


def main():
    coordinator, n_procs, pid, reads, out = sys.argv[1:6]
    # SIGTERM prints every thread's stack: where a hung worker waits
    faulthandler.register(signal.SIGTERM)
    from kmc_tpu_torch import memory
    from kmc_tpu_torch.parallel.distributed import (init_multihost,
                                                    nccl_groups, process_count)
    from kmc_tpu_torch.parallel.exchange_kernel import \
        ragged_all_to_all_processes
    from kmc_tpu_torch.parallel.multihost import distributed_count

    node = os.environ.get("MP_NODE")
    if node:
        names = node.split(",")
        host = f"node{names[int(pid)] if len(names) > 1 else names[0]}"
        socket.gethostname = lambda: host
    if os.environ.get("MP_CRASH_AT") == "p2p" and int(pid) == int(
            os.environ.get("MP_CRASH_PID", "1")):
        import torch.distributed as dist

        from kmc_tpu_torch.parallel import distributed as pd

        post = dist.batch_isend_irecv

        def die(ops):
            if pd._Group.nccl is None and dist.get_backend(
                    ops[0].group) == "nccl":
                return post(ops)  # the NCCL group's own pair warm-up
            os._exit(17)

        dist.batch_isend_irecv = die
    hb = os.environ.get("MP_HEARTBEAT_SECS")
    init_multihost(coordinator_address=coordinator,
                   num_processes=int(n_procs), process_id=int(pid),
                   heartbeat_timeout_seconds=int(hb) if hb else None)
    assert process_count() == int(n_procs), process_count()

    # fault injection (tests/test_torch_fault_injection.py): this process
    # dies abruptly mid-run; the survivors must fail, not hang
    crash = os.environ.get("MP_CRASH_SECS")
    if crash and int(pid) == int(os.environ.get("MP_CRASH_PID", "1")):
        import threading

        threading.Timer(float(crash), lambda: os._exit(17)).start()

    # the processes share the machine's cores: torch's CPU ops in each
    # take its share, not every core
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(n_procs)))
    lists = os.environ.get("MP_DEVICES", "cpu,cpu").split(";")
    devices = [d.replace("{pid}", pid) for d in
               lists[int(pid) if len(lists) > 1 else 0].split(",")]
    knobs = dict(
        k=int(os.environ.get("MP_K", 25)),
        batch_positions=int(os.environ.get("MP_BATCH", 1 << 10)),
        cutoff_min=int(os.environ.get("MP_CI", 1)),
        capacity_rows_per_device=int(os.environ.get("MP_CAPACITY", 1 << 12)),
        shard_input=os.environ.get("MP_SHARD_INPUT", "1") != "0",
        min_shard_bytes=int(os.environ.get("MP_MIN_SHARD", 32 << 20)),
    )
    planned = memory.plan_memory
    xp = ragged_all_to_all_processes
    cards = sorted({torch.device(d) for d in devices if d.startswith("cuda")},
                   key=str)
    for d in cards:
        torch.empty(0, device=d)  # the card's context, before its stats
    for mode in os.environ.get("MP_MODES", "default").split(","):
        name, _, budget = mode.partition("@")
        memory.plan_memory = planned if not budget else (
            lambda *a, budget=int(budget), **kw: dataclasses.replace(
                planned(*a, **kw), spill_budget_bytes=budget))
        kw = dict(knobs, **MODES[name])
        if name == "spill":
            kw["capacity_rows_per_device"] = int(
                os.environ.get("MP_SPILL_CAPACITY", 1 << 11))
        dst = f"{out}.{mode.replace('@', '_')}"
        if cards:
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
        kernels = _launches()
        before = {k: copy.copy(getattr(xp, c)) for k, c in XP_COUNTERS}
        t0 = time.perf_counter()
        try:
            stats = distributed_count([reads], dst, devices=devices, **kw)
            after = _launches()
            result = {
                "stats": stats,
                "kernels": {n: after[n] - kernels[n] for n in after},
                "node": socket.gethostname(),
                "nccl_init_s": nccl_groups.init_s,
                "nccl_warmup_s": nccl_groups.warmup_s,
                "exchange_span": xp.span if xp.launches > before["launches"]
                else None,
                "wall_s": time.perf_counter() - t0,
                "peak_bytes": {str(d): torch.cuda.max_memory_allocated(d)
                               for d in cards}}
            for k, c in XP_COUNTERS:  # this count's share of each counter
                now = getattr(xp, c)
                result[k] = [t - (before[k][i] if i < len(before[k]) else 0)
                             for i, t in enumerate(now)] \
                    if isinstance(now, list) else now - before[k]
        except MemoryError as e:
            result = {"error": "MemoryError", "message": str(e)}
        with open(f"{dst}.stats.{pid}", "w") as f:
            json.dump(result, f)

    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
