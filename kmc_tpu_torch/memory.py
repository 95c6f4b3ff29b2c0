"""Functional `-m` / max_ram_gb budget planning (a copy of kmc_tpu/memory.py).

The reference sizes every pool from `-m` in AdjustMemoryLimits
(KMC's kmc_core/kmc.h:427-507): FASTQ buffers are halved until
they fit 17% of the budget, binary-reader buffers until they fit 10%
(>=8 MiB), splitter/read overheads are subtracted, and the remainder goes
to the bin storer (65-75%), failing if that pool drops under 256 MiB.
Strict-memory re-planning (kmc.h:318-367) further splits stage-2 memory.

The device design has different pools, so the carve is different, but the
semantics are the same: `-m` is a HOST-RAM budget every sized buffer
derives from.

  parse pool   the parsed chunks: one output of CHUNK_BYTES + 1 a chunk
               (only the pages its codes fill are touched), one being
               filled per parser thread, the queued ones and the one the
               batches are cut from; beside them each parser thread's
               read buffer of io.readers.PIECE_BYTES (1 MiB)
  host pool    everything row-shaped on the host: spilled compacted runs,
               the external-merge window, and the finalize D2H record
               assembly
  device rows  the device store is budgeted by device memory, not `-m` —
               but a spill moves a full store's rows to host RAM, so the
               per-spill pull must fit the host pool; when the requested
               rows would make a single spilled run overflow it, rows
               shrink (halving, like the reference's buffer loops).  On
               the CPU "device" tensors are host RAM as well, so the same
               bound applies directly.

The plan's rows size the device store; a store that overflows after
compaction spills its compacted rows to host RAM, and spilled runs whose
bytes cross spill_budget_bytes are re-merged in place (a merged run still
over it raises MemoryError naming -m), as in kmc_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MemoryPlan:
    budget_bytes: int
    #: native reader chunk size (io.readers.CHUNK_BYTES)
    parse_chunk_bytes: int
    #: total budget for host-row payloads (spills + merge + D2H assembly)
    host_pool_bytes: int
    #: cumulative spilled-run bytes that trigger an in-place re-merge
    spill_budget_bytes: int
    #: device store rows (pow2; >= 2*batch_positions is enforced by callers)
    device_store_rows: int


def _spilled_row_bytes(k: int) -> int:
    """Host bytes per spilled store row: the key columns + counts column
    (the device store's layout), plus the transient
    second copy the re-merge lexsort takes."""
    W = (k + 15) // 16
    n_cols = W  # fused layout is the common case; +1 col is ~12% off
    return 2 * (4 * n_cols + 4)


def plan_memory(max_ram_gb: int, *, k: int, batch_positions: int,
                n_threads: int = 1, strict_memory: bool = False,
                requested_rows: int | None = None) -> MemoryPlan:
    """Carve `-m` into the pools (see module docstring).

    requested_rows: an explicit device_store_rows from the caller wins —
    the plan only derives rows when the caller left them automatic
    (reference: an explicit tool parameter also overrides the derived
    pool, kmc_runner.h's SetMaxRamGB vs the CLI defaults)."""
    budget = max(1, int(max_ram_gb)) << 30

    # parse pool: 64 MiB chunks halved until the in-flight set fits 17%
    # of the budget (reference fastq_buffer_size loop, kmc.h:443-451),
    # floored at 1 MiB
    n_th = max(1, int(n_threads))
    chunk = 64 << 20
    while chunk > (1 << 20) and chunk * (n_th + 2) > budget * 0.17:
        chunk //= 2

    # fixed runtime reserve (Python + torch host runtime + batch staging)
    reserve = 256 << 20
    host_pool = max(budget - chunk * (n_th + 2) - reserve, 64 << 20)
    # spilled runs may at the worst moment coexist with the merge window
    # over the same rows: give spills 60% (reference max_mem_storer is
    # 65-75% of its remainder, kmc.h:487-491)
    spill_budget = int(host_pool * 0.6)

    if requested_rows is not None:
        rows = int(requested_rows)
    else:
        rows = 1 << 26
        row_b = _spilled_row_bytes(k)
        # one spilled run (a full store pull) must fit the spill budget
        while rows > (1 << 20) and rows * row_b > spill_budget:
            rows //= 2
    if strict_memory:
        # -sm composes: halve the store, overflow rides the spill path
        # (the strict-memory pipeline analogue, kmc.h:1611-1692)
        rows = max(rows // 2, 2 * int(batch_positions))
    rows = max(rows, 2 * int(batch_positions))

    return MemoryPlan(
        budget_bytes=budget,
        parse_chunk_bytes=chunk,
        host_pool_bytes=host_pool,
        spill_budget_bytes=spill_budget,
        device_store_rows=rows,
    )
