"""Device-resident k-mer store: kmc_tpu/ops/store.py's DeviceKmerStore on torch.

The store holds one row per ingested start position, in key columns only:
the bin id rides the spare top bits of k-mer lane 0 whenever they hold it
(fused layout), else it is a column of its own.  Two signature->bin
policies, as in kmc_tpu:

  prefix    the bin is the top bits of the signature (plus a special bin);
  greedy    KMC's sampled-histogram greedy map (signatures.py::
            build_signature_map, s_mapper.h:141-235).  Eager greedy takes
            the map up front and bins every batch through it (the fused
            ingest's greedy entry).  Deferred greedy (the default,
            KMC_TPU_GREEDY_DEFER) ingests under the prefix layout of 512
            bins, folds the stage-0 histogram into the first ingest
            launches, and remaps at finalize: the signature is recomputed
            from each unique k-mer's lanes (ops/extract.py::
            sig_of_word_cols), mapped to its greedy bin and the rows
            re-sorted by the greedy key with the grouping-sort kernel (the
            collect).  Both write eager greedy's bytes.

Dead rows (windows holding a sentinel) are all-ones in every column and sort
after every live row.  Counts are implicitly 1 until the first compaction
(or external append) materializes a counts column.

  ingest    per batch, one fused kernel launch (ops/ingest_kernel.py):
            decode the boundary-delta (or packed+mask) feed, run the
            splitter scan, map signature -> bin, fuse the key columns and
            write them in place at n_used; occurrence and super-k-mer
            totals accumulate on the device.
  compact   when the store is full: the grouping-sort kernel
            (ops/sort_kernel.py) orders the live rows, group starts come
            from torch.nonzero, group totals are differences of an int64
            prefix sum of the counts, and the representatives are written
            back in place over the front of the store.
  spill     when a compacted store still cannot take the next batch: the
            compacted rows go to host RAM as one sorted run (uint32 numpy
            columns + uint32 counts, kmc_tpu's layout) and the store starts
            empty; runs whose bytes cross the -m spill budget are re-merged
            into one.
  finalize  spilled runs are replayed into the store first; then the same
            reduction and an emitter chosen by the output, on the device:
            _complete_groups (cutoffs, the exact KMC2 record bytes, suffix +
            little-endian counter, and the per-(bin, prefix) LUT) or
            _word_groups (KFF output and -w: the groups' bins, k-mer lanes
            and clamped counts in record order), copied to the host in one
            piece.  When the replayed unique set outgrows the store, the
            "host" route hands the groups to the same emitter a piece at a
            time, each piece's rows copied to the host as it completes: the
            runs and the store merged on the device a key range at a time,
            or, under deferred greedy (which re-sorts across ranges), the
            host merge's remapped groups uploaded back in chunks.  Both
            finalizes run one route skeleton (_finalize).
  merge     every merge of spilled runs (the re-merge and the host route's
            merge; the sharded store's too) runs on the store's device
            (merge_runs): the runs stay in host RAM and are cut at common
            column-0 values into key ranges that fit the device's free
            memory, each uploaded, sorted by the grouping-sort kernel and
            reduced to exact int64 totals, then handed on (_merge_ranges) or
            copied back.

Count arithmetic follows kmc_tpu path by path: device group totals wrap mod
2^32 (a group that wraps to 0 is dropped), the early re-merge of spilled
runs clamps at 0xFFFFFFFF, and the host route's merge keeps exact totals
(int64 on the device, u64 on the host) that its completer clamps to
counter_max.

Columns are int32 tensors holding u32 bit patterns (torch's uint32 lacks the
needed arithmetic); lane math runs in int64 (see ops/extract.py).  The
output bytes are identical to kmc_tpu's, and so are checkpoints
(save_checkpoint / load_checkpoint) and spilled runs.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from .extract import i32_to_u32, sig_of_word_cols, u32_to_i32
from .ingest_kernel import ingest
from .sort_kernel import radix_sort_columns

_DEAD = -1  # all-ones u32 as an int32 bit view


def prefix_bin_bits(k: int, sig_len: int, n_bins: int) -> tuple[int, bool]:
    """(prefix bits b, fused) for the "prefix" policy (mirrors
    store.prefix_bin_bits): bins are the top b bits of the signature plus
    one special bin (id 2^b) for windows of only disallowed m-mers."""
    W = (k + 15) // 16
    r0 = k - 16 * (W - 1)
    spare = 32 - 2 * r0
    b = min(max(n_bins, 2).bit_length() - 1, 2 * sig_len)
    return b, b + 1 <= spare


def prefix_sig_map(sig_len: int, prefix_bits: int) -> np.ndarray:
    """The "prefix" policy's signature->bin map as int32[4^sig_len + 1]
    (for the .kmc_pre footer)."""
    msize = (1 << (2 * sig_len)) + 1
    shift = 2 * sig_len - prefix_bits
    return (np.arange(msize, dtype=np.int64) >> shift).astype(np.int32)


def greedy_fuse(k: int, n_used_bins: int) -> bool:
    """Whether the greedy layout fuses the bin into lane 0 (mirrors
    store.greedy_fuse)."""
    W = (k + 15) // 16
    r0 = k - 16 * (W - 1)
    return 2 * r0 + int(n_used_bins + 1).bit_length() <= 32


def greedy_defer_default() -> bool:
    """KMC_TPU_GREEDY_DEFER (default on, kmc_tpu's knob): greedy stores
    ingest under the prefix layout and remap at finalize."""
    return os.environ.get("KMC_TPU_GREEDY_DEFER", "1") not in (
        "0", "false", "no")


def _fused_cols(bins, lanes, *, fuse: bool, r0: int):
    """Key columns (int32 bit views) of live rows from bins and lanes
    (int64 u32 values)."""
    if fuse:
        return [u32_to_i32((bins << (2 * r0)) | lanes[0])] + [
            u32_to_i32(w) for w in lanes[1:]]
    return [u32_to_i32(bins)] + [u32_to_i32(w) for w in lanes]


def _group_reduce(cols, counts, n_keys: int, drop_zero: bool = True,
                  wrap: bool = True):
    """Sort live rows by their key columns and merge equal keys.

    cols: int32 key columns of the live rows; counts: their int32 (u32)
    counts, or None when every row weighs 1.  Returns (representative key
    columns in key order, int64 totals), totals taken mod 2^32 like the
    u32 arithmetic of kmc_tpu's store (exact when wrap is False); groups
    whose total is 0 are dropped unless drop_zero is False."""
    return _group_totals(*_group_sort(cols, counts, n_keys), n_keys,
                         drop_zero=drop_zero, wrap=wrap)


def _group_sort(cols, counts, n_keys: int):
    """_group_reduce's first half, which waits on nothing: the grouping
    sort of the live rows (counts, when given, ride as the last column)
    and a flag on each group's first row.  Returns (sorted columns,
    flags); no sort is launched for no rows."""
    n = cols[0].shape[0]
    dev = cols[0].device
    cols = cols + ([counts] if counts is not None else [])
    if n == 0:
        return cols, torch.zeros(0, dtype=torch.bool, device=dev)
    sorted_cols = radix_sort_columns(cols, n_keys)
    new = torch.zeros(n, dtype=torch.bool, device=dev)
    # fill_: assigning a Python scalar to an element copies it from the
    # host, which waits for the device (the sort just launched)
    new[0].fill_(True)
    for c in sorted_cols[:n_keys]:
        new[1:] |= c[1:] != c[:-1]
    return sorted_cols, new


def _group_totals(sorted_cols, new, n_keys: int, drop_zero: bool = True,
                  wrap: bool = True):
    """_group_reduce's second half on _group_sort's output: the group
    starts (torch.nonzero, which waits for the sort), the totals (of the
    counts column where there is one, else of the rows) and the
    representatives."""
    keys = sorted_cols[:n_keys]
    n = new.shape[0]
    dev = new.device
    if n == 0:
        return keys, torch.zeros(0, dtype=torch.int64, device=dev)
    starts = torch.nonzero(new).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    if len(sorted_cols) == n_keys:
        totals = ends - starts
    else:
        cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(i32_to_u32(sorted_cols[n_keys]), 0)])
        totals = cs[ends] - cs[starts]
        if wrap:
            totals &= 0xFFFFFFFF
    reps = [c[starts] for c in keys]
    if not drop_zero:
        return reps, totals
    keep = totals != 0
    return [c[keep] for c in reps], totals[keep]


def _split_bins(cols, *, fuse: bool, r0: int):
    """(bins, k-mer lanes) as int64 u32 values from key columns (mirrors
    store._split_bins)."""
    if fuse:
        c0 = i32_to_u32(cols[0])
        return c0 >> (2 * r0), [c0 & ((1 << (2 * r0)) - 1)] + [
            i32_to_u32(c) for c in cols[1:]]
    return i32_to_u32(cols[0]), [i32_to_u32(c) for c in cols[1:]]


def _cutoffs(bins, totals, *, cutoff_min, cutoff_max, n_bins):
    """(keep mask, (n_unique, n_below, n_above) tensors) of grouped rows:
    a group of a valid bin counts as unique, and is kept within the
    cutoffs."""
    valid = bins < n_bins
    below = valid & (totals < cutoff_min)
    above = valid & (totals > cutoff_max)
    return valid & ~below & ~above, (valid.sum(), below.sum(), above.sum())


def _completer(bins, wr, totals, *, cutoff_min, cutoff_max, counter_max, k,
               lut_prefix_len, counter_size, n_bins):
    """KMC2 completer over grouped rows in (bin, k-mer) order (mirrors
    store._finalize_groups_core).  Returns (record bytes u8[n_keep, RB],
    lut int64[n_bins << 2*lpl], (n_unique, n_below, n_above) tensors)."""
    W = (k + 15) // 16
    r0 = k - 16 * (W - 1)
    keep, stats = _cutoffs(bins, totals, cutoff_min=cutoff_min,
                           cutoff_max=cutoff_max, n_bins=n_bins)
    bins, totals = bins[keep], totals[keep]
    wr = [w[keep] for w in wr]

    kb = (k + 3) // 4
    suffix_bytes = (k - lut_prefix_len) // 4 if lut_prefix_len else kb
    cnt = torch.clamp(totals, max=counter_max)
    rec = []
    for j in range(suffix_bytes):
        t = suffix_bytes - 1 - j  # byte index from the right of the k-mer
        rec.append((wr[W - 1 - t // 4] >> (8 * (t % 4))) & 0xFF)
    for j in range(counter_size):  # little-endian counter
        rec.append((cnt >> (8 * j)) & 0xFF)
    n_keep = bins.shape[0]
    rec = (torch.stack(rec, dim=1).to(torch.uint8) if rec else
           torch.zeros((n_keep, 0), dtype=torch.uint8, device=bins.device))

    if lut_prefix_len:
        if lut_prefix_len <= r0:
            prefix = wr[0] >> (2 * (r0 - lut_prefix_len))
        else:
            need = lut_prefix_len - r0  # bases from lane 1
            prefix = (wr[0] << (2 * need)) | (wr[1] >> (2 * (16 - need)))
        prefix &= (1 << (2 * lut_prefix_len)) - 1
    else:
        prefix = torch.zeros_like(bins)
    lut_size = n_bins << (2 * lut_prefix_len)
    lut = torch.bincount((bins << (2 * lut_prefix_len)) | prefix,
                         minlength=lut_size)
    return rec, lut, stats


def _complete_groups(store, reps, totals, *, cutoff_min, cutoff_max,
                     counter_max, lut_prefix_len, counter_size):
    """_completer over a store's grouped rows: reps, its key columns in
    (bin, k-mer) order, split by the store's fuse, r0 and k, and its
    n_used_bins the valid bins."""
    bins, wr = _split_bins(reps, fuse=store.fuse, r0=store.r0)
    return _completer(bins, wr, totals, cutoff_min=cutoff_min,
                      cutoff_max=cutoff_max, counter_max=counter_max,
                      k=store.k, lut_prefix_len=lut_prefix_len,
                      counter_size=counter_size, n_bins=store.n_used_bins)


def _word_groups(store, reps, totals, *, cutoff_min, cutoff_max,
                 counter_max):
    """The words path's emitter (KFF output and -w) over a store's grouped
    rows in (bin, k-mer) order: (kept bins int32, their k-mer lanes
    int32[n_keep, W] and counts clamped to counter_max, both u32 bit views,
    (n_unique, n_below, n_above) tensors)."""
    bins, wr = _split_bins(reps, fuse=store.fuse, r0=store.r0)
    keep, stats = _cutoffs(bins, totals, cutoff_min=cutoff_min,
                           cutoff_max=cutoff_max, n_bins=store.n_used_bins)
    return (bins[keep].to(torch.int32),
            torch.stack([u32_to_i32(w[keep]) for w in wr], dim=1),
            u32_to_i32(torch.clamp(totals[keep], max=counter_max)), stats)


class _SpillOverflow(Exception):
    """The replayed unique set exceeds the device store: finalize falls
    back to the host merge of the spilled runs."""


def _host_u32(t: torch.Tensor) -> np.ndarray:
    """A column (int32 bit view) as a uint32 numpy array of its own: the
    device-to-host edge of spills and checkpoints."""
    t = t.cpu() if t.device.type != "cpu" else t.clone()
    return t.numpy().view(np.uint32)


# -- merging sorted runs on a device --
#
# kmc_tpu merges spilled runs with a host lexsort + reduceat.  Here the runs
# stay in host RAM and a merge borrows device memory for a moment: each run
# is sorted by its key columns, so all runs are cut at the same column-0
# values into key ranges that fit the device (rows of one key share column
# 0, so no group straddles two ranges), and each range is uploaded, sorted
# by the grouping-sort kernel and reduced in turn.


def _merge_row_bytes(n_keys: int, caller: int = 96) -> int:
    """Device bytes a row of a merge may take: its key and count columns
    three times (the upload, the sort's output and scratch), the int64
    prefix sums, group starts and totals, and `caller` bytes for what the
    caller does with the groups."""
    return 16 * (n_keys + 1) + caller


def _completer_row_bytes(n_keys: int, W: int, rec_bytes: int) -> int:
    """Device bytes _completer may take for a group of a merge: the group
    held (key columns, int64 total), its bin and lanes split out as int64,
    the cutoff masks, the kept copies, the record bytes built as int64
    columns, stacked and narrowed, and the LUT's keys."""
    return 4 * n_keys + 16 * W + 48 + 17 * rec_bytes


def _word_row_bytes(n_keys: int, W: int) -> int:
    """Device bytes _word_groups may take for a group of a merge: the group
    held, its bin and lanes split out and the cutoff masks (as in
    _completer_row_bytes), the kept bin, lanes and total as int64, and
    their int32 narrowings, the lanes twice while they are stacked."""
    return 4 * n_keys + 16 * W + 48 + 8 * (W + 2) + 4 * (2 * W + 2)


def _merge_rows(device, n_keys: int, max_bytes, caller: int = 96):
    """Rows one key range may hold: max_bytes (default: the device memory
    free to torch; no limit on the CPU) over the bytes of a row."""
    if max_bytes is None:
        if device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(device)
        max_bytes = (free + torch.cuda.memory_reserved(device)
                     - torch.cuda.memory_allocated(device))
    return max(1, int(max_bytes) // _merge_row_bytes(n_keys, caller))


def _live_run(cols, counts):
    """A sorted run without its dead rows (count 0, all-ones keys: a
    compaction writes each group whose total wraps to 0 and one trailing
    row so), as (key columns, counts, number of dead rows).  A host run
    stays a view when its dead rows are a suffix."""
    if isinstance(counts, np.ndarray):
        dead = counts == 0
        n_dead = int(np.count_nonzero(dead))
        n = len(counts) - n_dead
        if n_dead and not dead[n:].all():
            live = ~dead
            return [c[live] for c in cols], counts[live], n_dead
        return [c[:n] for c in cols], counts[:n], n_dead
    live = counts != 0
    n_dead = live.numel() - int(live.sum())
    if n_dead:
        idx = torch.nonzero(live).squeeze(1)
        return [c[idx] for c in cols], counts[idx], n_dead
    return list(cols), counts, 0


def _first_rows(key0, values: np.ndarray) -> np.ndarray:
    """For each value (int64, 0..2^32), the first row of a run whose column
    0 is at or above it.  key0: the run's column 0, uint32 numpy or an
    int64 tensor of u32 values."""
    if isinstance(key0, np.ndarray):
        pos = np.searchsorted(
            key0, np.minimum(values, 0xFFFFFFFF).astype(np.uint32))
        return np.where(values > 0xFFFFFFFF, len(key0), pos)
    return torch.searchsorted(
        key0, torch.from_numpy(values).to(key0.device)).cpu().numpy()


def _key_ranges(key0s, lo, hi, max_rows):
    """Cut the rows whose column 0 lies in [lo, hi) (None: unbounded) into
    key ranges of at most max_rows rows (None: one range), at the same
    column-0 values in every run.  Returns per range, in key order, the
    (first, end) rows of each run.  Raises MemoryError when the rows of one
    column-0 value alone exceed max_rows."""
    lens = np.array([len(k) for k in key0s], np.int64)

    def rows_at(values):  # int64[len(values), n_runs]
        values = np.asarray(values, np.int64)
        return np.stack([_first_rows(k, values) for k in key0s], axis=1)

    first = rows_at([lo])[0] if lo is not None else np.zeros_like(lens)
    end = rows_at([hi])[0] if hi is not None else lens
    if max_rows is None or int((end - first).sum()) <= max_rows:
        return [(first, end)]
    # candidate cuts: each run's column 0 every `step` rows, and each of
    # those values + 1.  Between two neighbouring candidates lie either the
    # rows of one value or at most `step` rows of each run.
    step = max(1, max_rows // (2 * len(key0s)))
    samples = [k[a:b:step] for k, a, b in zip(key0s, first, end)]
    cand = np.concatenate([s if isinstance(s, np.ndarray) else s.cpu().numpy()
                           for s in samples]).astype(np.int64)
    cand = np.unique(np.concatenate([cand, cand + 1]))
    cand = cand[cand > (-1 if lo is None else lo)]
    if hi is not None:
        cand = cand[cand < hi]
    pos = np.concatenate([first[None], rows_at(cand), end[None]])
    below = (pos - first).sum(axis=1)
    ranges, i = [], 0
    while i < len(pos) - 1:
        j = int(np.searchsorted(below, below[i] + max_rows, side="right")) - 1
        if j <= i:
            raise MemoryError(
                f"{below[i + 1] - below[i]} rows share one column-0 value; a "
                f"merge on this device takes at most {max_rows} rows at once")
        ranges.append((pos[i], pos[j]))
        i = j
    return ranges


def _live_runs(runs):
    """The runs without their dead rows, as (key columns, counts) pairs,
    and the number of dead rows."""
    live = [_live_run(cols, counts) for cols, counts in runs]
    return [(cols, counts) for cols, counts, _ in live], sum(
        n_dead for _, _, n_dead in live)


def _merge_ranges(live, n_keys: int, device, *, max_bytes=None, lo=None,
                  hi=None, caller: int = 96):
    """merge_runs a key range at a time: yields each range's (representative
    key columns, exact int64 totals) on `device`, in key order.  live: runs
    without their dead rows (_live_runs); caller: the device bytes a row
    keeps for what the caller does with a range's groups (_merge_row_bytes).
    The device memory is measured at the first range."""
    device = torch.device(device)
    if not live:
        return
    key0s = [c[0] if isinstance(c[0], np.ndarray) else i32_to_u32(c[0])
             for c, _ in live]
    for first, end in _key_ranges(
            key0s, lo, hi, _merge_rows(device, n_keys, max_bytes, caller)):
        n = int((end - first).sum())
        if n == 0:
            continue
        cols = [torch.empty(n, dtype=torch.int32, device=device)
                for _ in range(n_keys + 1)]
        off = 0
        for (run_cols, run_counts), a, b in zip(live, first, end):
            a, b = int(a), int(b)
            for dst, src in zip(cols, [*run_cols, run_counts]):
                part = src[a:b]
                if isinstance(part, np.ndarray):
                    trace.add("h2d_bytes", part.nbytes)
                    part = torch.from_numpy(part.view(np.int32))
                dst[off:off + b - a].copy_(part)
            off += b - a
        reps, totals = _group_reduce(cols[:n_keys], cols[n_keys], n_keys,
                                     drop_zero=False, wrap=False)
        del cols
        yield reps, totals
        del reps, totals


def merge_runs(runs, n_keys: int, device, emit, *, max_bytes=None, lo=None,
               hi=None) -> int:
    """Merge sorted runs of rows on `device` (the grouping-sort kernel on a
    card, its plain version on the CPU).

    runs: (key columns, counts) pairs, each run sorted by its n_keys key
    columns compared as u32, given as uint32 numpy arrays (host runs) or
    int32 bit-view tensors on `device`.  Dead rows (count 0) take no part.
    Only rows whose column 0 lies in [lo, hi) (None: unbounded) are merged,
    in key ranges that each fit max_bytes of device memory (see _merge_rows;
    a test passes a small limit to force many ranges).  For each range in
    key order, emit(representative key columns, exact int64 totals)
    receives its groups, on `device`.  Returns the number of dead rows."""
    live, n_dead = _live_runs(runs)
    for reps, totals in _merge_ranges(live, n_keys, device,
                                      max_bytes=max_bytes, lo=lo, hi=hi):
        emit(reps, totals)
    return n_dead


def merge_runs_to_host(runs, n_keys: int, device, *, max_bytes=None):
    """merge_runs with the groups copied back to host RAM: (sorted unique
    key columns as uint32 numpy, exact uint64 totals, number of dead
    rows)."""
    parts = []

    def emit(reps, totals):
        parts.append(([_host_u32(c) for c in reps],
                      totals.cpu().numpy().view(np.uint64)))
        trace.add("d2h_bytes", 4 * len(reps) * len(totals) + 8 * len(totals))

    n_dead = merge_runs(runs, n_keys, device, emit, max_bytes=max_bytes)
    if not parts:
        return ([np.zeros(0, np.uint32) for _ in range(n_keys)],
                np.zeros(0, np.uint64), n_dead)
    if len(parts) == 1:
        return parts[0][0], parts[0][1], n_dead
    cols = [np.concatenate([p[0][j] for p in parts]) for j in range(n_keys)]
    return cols, np.concatenate([p[1] for p in parts]), n_dead


def remerge_runs(runs, n_keys: int, device, *, max_bytes=None):
    """The runs collapsed into one sorted unique run, (uint32 key columns
    tuple, uint32 counts), merged on `device`: totals clamp at 0xFFFFFFFF,
    and one dead row (all-ones keys, count 0) follows the groups when the
    runs held any, as kmc_tpu's host re-merge leaves them."""
    cols, totals, n_dead = merge_runs_to_host(runs, n_keys, device,
                                              max_bytes=max_bytes)
    counts = np.minimum(totals, 0xFFFFFFFF).astype(np.uint32)
    if n_dead:
        cols = [np.append(c, np.uint32(0xFFFFFFFF)) for c in cols]
        counts = np.append(counts, np.uint32(0))
    return tuple(cols), counts


def _acc_pair(v: int) -> np.ndarray:
    """An occurrence total as kmc_tpu's (lo, hi) uint32 accumulator."""
    return np.array([v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF], np.uint32)


def _acc_value(a) -> int:
    lo, hi = (int(x) for x in np.asarray(a, dtype=np.uint64))
    return lo + (hi << 32)


def _autocompact_rows() -> int:
    """KMC_TPU_AUTOCOMPACT_ROWS: ingested rows between voluntary mid-run
    compactions (kmc_tpu's knob of the same name); 0, the default, is
    off."""
    return max(0, int(os.environ.get("KMC_TPU_AUTOCOMPACT_ROWS", "0")))


class DeviceKmerStore:
    """Device store of ([bin,] k-mer lanes[, counts]) rows (see module
    docstring), updated in place: ingest writes its rows into preallocated
    columns and compaction writes the merged rows back over the front of
    the same columns, so the store never holds two copies of itself."""

    def __init__(self, capacity_rows: int, *, k: int, sig_len: int,
                 both_strands: bool, n_bins: int, map_mode: str = "prefix",
                 sig_map: np.ndarray | None = None,
                 greedy_defer: bool | None = None,
                 initial_rows: int | None = None,
                 spill_budget_bytes: int | None = None, device="cuda"):
        """capacity_rows caps the store; it starts at initial_rows (default
        capacity_rows) and grows 4x on demand up to the cap.  Spilled runs
        whose bytes cross spill_budget_bytes (the -m plan's) are re-merged;
        None sets no budget.

        map_mode "prefix": n_bins is rounded down to a power of two.
        map_mode "greedy": sig_map (int32[4^sig_len + 1], from
        signatures.build_signature_map, -1 for unreachable slots) routes each
        signature; n_bins is not read.  Deferred greedy (greedy_defer,
        default KMC_TPU_GREEDY_DEFER) may take the map later (set_sig_map,
        before finalize or a checkpoint); eager greedy needs it here."""
        self.device = resolve_device(device)
        self.max_capacity = int(capacity_rows)
        self.k = int(k)
        self.sig_len = int(sig_len)
        self.both_strands = bool(both_strands)
        self.W = (self.k + 15) // 16
        self.r0 = self.k - 16 * (self.W - 1)
        self.map_mode = map_mode
        self._sig_map = None  # greedy: the map on the device, -1 -> dead bin
        if map_mode == "prefix":
            self.prefix_bits, self.fuse = prefix_bin_bits(
                self.k, self.sig_len, n_bins)
            self.n_used_bins = (1 << self.prefix_bits) + 1  # + special bin
            self._g_defer = False
        elif map_mode == "greedy":
            self._g_defer = (greedy_defer_default() if greedy_defer is None
                             else bool(greedy_defer))
            self.prefix_bits = 0
            self.n_used_bins = self.fuse = None  # set with the map
            if sig_map is not None:
                self.set_sig_map(sig_map)
            elif not self._g_defer:
                raise ValueError("eager greedy map_mode requires sig_map "
                                 "upfront")
        else:
            raise ValueError(f"unknown map_mode {map_mode!r}")
        # the rows' layout: the output's, except under deferred greedy,
        # whose rows keep the prefix layout of 512 bins until finalize
        if self._g_defer:
            self._ing_prefix_bits, self._ing_fuse = prefix_bin_bits(
                self.k, self.sig_len, 512)
            self._ing_n_bins = (1 << self._ing_prefix_bits) + 1
        else:
            self._ing_prefix_bits = self.prefix_bits
            self._ing_fuse = self.fuse
            self._ing_n_bins = self.n_used_bins
        self.n_dead_bin = self._ing_n_bins
        self.n_cols = self.W if self._ing_fuse else self.W + 1
        self.capacity = min(self.max_capacity,
                            int(initial_rows or self.max_capacity))
        self.key_cols = self._alloc_cols(self.capacity)
        self.counts = None  # materialized by the first compaction or append
        self.n_used = 0
        self.occ_acc = torch.zeros((), dtype=torch.int64, device=self.device)
        self.skm_acc = torch.zeros((), dtype=torch.int64, device=self.device)
        self.prev_sig = torch.full((1,), _DEAD, dtype=torch.int32,
                                   device=self.device)
        self.n_compactions = 0
        self.total_appended_rows = 0
        self._since_compact = 0  # rows appended since the last compaction
        # host-side spilled runs: (uint32 key columns tuple, uint32 counts)
        self.spilled: list = []
        self.spill_budget_bytes = spill_budget_bytes
        self.n_spills = 0
        self.spill_bytes = 0  # bytes every spill copied to the host
        self.n_remerges = 0
        self.merge_launches = 0  # grouping-sort launches of the merges
        self.collect_launches = 0  # grouping-sort launches of the collect
        self.finalize_route = None  # "device", "replay" or "host"

    def _alloc_cols(self, rows: int):
        return [torch.full((rows,), _DEAD, dtype=torch.int32,
                           device=self.device) for _ in range(self.n_cols)]

    def _grow(self, needed_rows: int) -> bool:
        new_cap = self.capacity
        while new_cap < needed_rows:
            new_cap *= 4
        new_cap = min(new_cap, self.max_capacity)
        if new_cap <= self.capacity:
            return False
        n = self.n_used
        cols = self._alloc_cols(new_cap)
        for new, old in zip(cols, self.key_cols):
            new[:n] = old[:n]
        self.key_cols = cols
        if self.counts is not None:
            counts = torch.zeros(new_cap, dtype=torch.int32, device=self.device)
            counts[:n] = self.counts[:n]
            self.counts = counts
        self.capacity = new_cap
        return True

    def _make_room(self, s: int):
        """Room for s more rows (mirrors kmc_tpu's _make_room): grow, else
        compact, else grow again, else spill."""
        if self.n_used + s <= self.capacity or self._grow(self.n_used + s):
            return
        self.compact()
        if self.n_used + s <= self.capacity or self._grow(self.n_used + s):
            return
        self.spill()

    def _materialize_counts(self):
        """Create the counts column (1 for live rows) when a path needs it."""
        if self.counts is not None:
            return
        n = self.n_used
        self.counts = torch.zeros(self.capacity, dtype=torch.int32,
                                  device=self.device)
        self.counts[:n] = (self.key_cols[0][:n] != _DEAD).to(torch.int32)

    def _to_device(self, buf) -> torch.Tensor:
        if isinstance(buf, np.ndarray):
            buf = torch.from_numpy(buf)
        return buf.to(self.device)

    def _u32_to_device(self, a) -> torch.Tensor:
        """A uint32 numpy column as an int32 bit-view tensor on the store's
        device (the host-to-device edge of append)."""
        a = np.require(np.asarray(a), dtype=np.uint32,
                       requirements=("C", "W"))  # copies only when needed
        return torch.from_numpy(a.view(np.int32)).to(self.device)

    def ingest_boundaries(self, buf, tail_start: int, *, s: int,
                          hist: torch.Tensor | None = None):
        """Ingest one batch in the boundary-delta feed format
        (io/native.py::pack_codes_boundaries).  hist (int32[4^sig_len + 1]
        on the store's device), when given, gains the batch's stage-0
        signature histogram from the same launch (the deferred greedy
        fold; kmc_tpu's stage0_accum on the same feed)."""
        self._ingest(buf, int(tail_start), s, hist)

    def ingest_fused(self, buf, *, s: int, hist: torch.Tensor | None = None):
        """Ingest one batch in the packed+mask feed format
        (io/native.py::pack_codes_fused); hist as in ingest_boundaries."""
        self._ingest(buf, None, s, hist)

    def ingest_packed(self, item, *, s: int,
                      hist: torch.Tensor | None = None):
        """Ingest one packed batch as the feeds hand it over: ("b", buf,
        tail_start) in the boundary-delta feed or ("m", buf) in the
        packed+mask feed; hist as in ingest_boundaries."""
        self._ingest(item[1], int(item[2]) if item[0] == "b" else None, s,
                     hist)

    def _ingest(self, buf, tail_start, s: int, hist=None):
        """The fused ingest (ops/ingest_kernel.py: decode, splitter scan,
        bin, append; mirrors kmc_tpu's _ingest_prefix_* and, for an eager
        greedy store, _ingest_greedy_* through the kernel's greedy entry)
        of one batch, in place at rows [n_used, n_used + s).  The feed
        reaches the device after _make_room, so no batch is held there
        while the store compacts."""
        self._make_room(s)
        eager = self.map_mode == "greedy" and not self._g_defer
        with trace.span("kmc.h2d"):
            feed = self._to_device(buf)
            trace.add("bytes", feed.nbytes)
        with trace.span("kmc.ingest_launch"):
            self.prev_sig = ingest(
                feed, tail_start, self.key_cols, self.counts, self.n_used,
                self.occ_acc, self.skm_acc, self.prev_sig, s=s, k=self.k,
                sig_len=self.sig_len, both_strands=self.both_strands,
                prefix_bits=self._ing_prefix_bits, fuse=self._ing_fuse,
                sig_map=self._sig_map if eager else None, hist=hist)
            trace.add("positions", s)
        self.n_used += s
        self.total_appended_rows += s
        self._since_compact += s
        thr = _autocompact_rows()
        if thr and self._since_compact >= thr:
            self.compact()

    def append(self, cols, counts, count_occurrences: bool = True):
        """External append of merged rows (mirrors kmc_tpu's append):
        cols are uint32 numpy key columns in the store's layout, counts
        uint32.  Rows with count 0 are written dead.  count_occurrences=False
        (checkpoint resume, spill replay) leaves the occurrence total alone,
        so rows counted once are not counted again."""
        if len(cols) != self.n_cols:
            raise ValueError(
                f"appending {len(cols)} key columns into a {self.n_cols}-"
                "column store (k/n_bins/fuse mismatch?)")
        counts = np.asarray(counts, dtype=np.uint32)
        n = len(counts)
        self.total_appended_rows += n
        self._make_room(n)
        self._materialize_counts()
        trace.add("h2d_bytes", 4 * n * (len(cols) + 1))
        cnt = self._u32_to_device(counts)
        dead = cnt == 0
        lo, hi = self.n_used, self.n_used + n
        for dst, src in zip(self.key_cols, cols):
            dst[lo:hi] = torch.where(dead, _DEAD, self._u32_to_device(src))
        self.counts[lo:hi] = cnt
        if count_occurrences:
            # kmc_tpu adds the append's u32 sum to its 64-bit accumulator
            self.occ_acc += int(counts.sum(dtype=np.uint64)) & 0xFFFFFFFF
        self.n_used = hi
        self._since_compact += n

    def _live_rows(self):
        """(key columns, counts or None) of the live rows in [0, n_used)."""
        n = self.n_used
        live = self.key_cols[0][:n] != _DEAD
        if self.counts is not None:
            live &= self.counts[:n] != 0
        idx = torch.nonzero(live).squeeze(1)
        cols = [c[:n][idx] for c in self.key_cols]
        counts = self.counts[:n][idx] if self.counts is not None else None
        return cols, counts

    def compact(self):
        """Merge duplicate rows in place (mirrors store._compact_core): the
        merged rows and their counts overwrite the front of the store.  As
        in kmc_tpu, a group whose total wraps to 0 stays as a dead row of
        count 0, and one dead row follows the groups whenever the store
        held a dead row, so n_used and every spilled run match kmc_tpu's
        row for row.  Its two halves, run back to back."""
        self._compact_finish(self._compact_issue())

    def _compact_issue(self):
        """compact's first half: the live rows (torch.nonzero, which waits
        only for the store's queued ingest) and the launch of their
        grouping sort.  Returns what _compact_finish takes; the store is
        unchanged until then, so the sharded store issues every shard's
        sort before it waits on any."""
        with trace.span("kmc.compact"):
            launches = radix_sort_columns.launches
            cols, counts = self._live_rows()
            n_live = cols[0].shape[0]
            sorted_cols, new = _group_sort(cols, counts, self.n_cols)
            trace.add("rows", n_live)
            trace.add("sort_launches", radix_sort_columns.launches - launches)
            return sorted_cols, new, n_live

    def _compact_finish(self, issued):
        """compact's second half: the groups' totals and representatives
        (torch.nonzero waits for the sort), written over the front of the
        store."""
        sorted_cols, new, n_live = issued
        with trace.span("kmc.compact_finish"):
            reps, totals = _group_totals(sorted_cols, new, self.n_cols,
                                         drop_zero=False)
            zero = totals == 0
            g = totals.shape[0]
            if self.counts is None:
                self.counts = torch.zeros(self.capacity, dtype=torch.int32,
                                          device=self.device)
            for dst, src in zip(self.key_cols, reps):
                dst[:g] = torch.where(zero, _DEAD, src)
            self.counts[:g] = u32_to_i32(totals)
            if n_live < self.capacity:  # the group of the dead rows
                # fill_, not an assignment, which would wait for the device
                for dst in self.key_cols:
                    dst[g].fill_(_DEAD)
                self.counts[g].fill_(0)
                g += 1
            self.n_used = g
            self.n_compactions += 1
            self._since_compact = 0

    # -- spill to host RAM under the -m budget --

    def spill(self):
        """Move the compacted store to host RAM as one sorted run (mirrors
        kmc_tpu's spill) and start empty; then hold the runs to the
        budget: the compaction's queued device work is waited for
        (kmc.spill_wait) before the copy (kmc.spill_d2h)."""
        with trace.span("kmc.spill"):
            self.compact()
            n = self.n_used
            with trace.span("kmc.spill_wait"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            with trace.span("kmc.spill_d2h"):
                run = (tuple(_host_u32(c[:n]) for c in self.key_cols),
                       _host_u32(self.counts[:n]))
                nbytes = sum(c.nbytes for c in run[0]) + run[1].nbytes
                trace.add("bytes", nbytes)
            trace.add("rows", n)
            self.spilled.append(run)
            self.n_spills += 1
            self.spill_bytes += nbytes
            self.n_used = 0
            self._since_compact = 0
        self._enforce_spill_budget()

    def _spilled_bytes(self) -> int:
        return sum(sum(c.nbytes for c in cols) + cnt.nbytes
                   for cols, cnt in self.spilled)

    def _enforce_spill_budget(self):
        """-m enforcement (mirrors kmc_tpu): re-merge the spilled runs when
        their bytes cross the budget; a single merged run still over it
        means the unique set does not fit -m."""
        b = self.spill_budget_bytes
        if b is None or self._spilled_bytes() <= b:
            return
        if len(self.spilled) > 1:
            self._remerge_spilled()
        if self._spilled_bytes() > b:
            raise MemoryError(
                f"unique k-mer set exceeds the -m/max_ram_gb host budget "
                f"({self._spilled_bytes()} spilled bytes > {b} budget); "
                "raise -m")

    def _remerge_spilled(self):
        """Collapse every spilled run into one sorted unique run, merged on
        the store's device; totals clamp at 0xFFFFFFFF (kmc_tpu's
        _remerge_spilled)."""
        with trace.span("kmc.remerge"):
            trace.add("rows", sum(len(c) for _, c in self.spilled))
            launches = radix_sort_columns.launches
            self.spilled = [remerge_runs(self.spilled, self.n_cols,
                                         self.device)]
            launches = radix_sort_columns.launches - launches
            self.merge_launches += launches
            trace.add("sort_launches", launches)
            self.n_remerges += 1

    def _replay_spills(self):
        """Append the spilled runs back into the store, compacting as it
        fills (mirrors kmc_tpu's _replay_spills).  Raises _SpillOverflow,
        with the consumed prefix of the first run trimmed, when a compacted
        store has no room left."""
        if not self.spilled:
            return
        with trace.span("kmc.replay"):
            self._materialize_counts()
            while self.spilled:
                cols, counts = self.spilled[0]
                pos = 0
                while pos < len(counts):
                    room = self.capacity - self.n_used
                    if room <= 0:
                        self.compact()
                        room = self.capacity - self.n_used
                    if room <= 0:
                        # the host merge must see every remaining row once
                        self.spilled[0] = (tuple(c[pos:] for c in cols),
                                           counts[pos:])
                        raise _SpillOverflow()
                    take = min(room, len(counts) - pos)
                    self.append(tuple(c[pos:pos + take] for c in cols),
                                counts[pos:pos + take],
                                count_occurrences=False)
                    trace.add("rows", take)
                    pos += take
                self.spilled.pop(0)

    def _take_runs(self):
        """Compact the store and hand its rows and the spilled runs over as
        the runs of a merge.  The store is consumed."""
        self.compact()
        n = self.n_used
        runs = self.spilled + [([c[:n] for c in self.key_cols],
                                self.counts[:n])]
        self.spilled = []
        self.key_cols = self.counts = None
        return runs

    def _host_merge(self):
        """Merge the spilled runs and the compacted store by (bin, k-mer)
        on the store's device and copy the groups to host RAM (kmc_tpu's
        _host_merge).  Returns (bins u32, lanes (n, W) u32, totals u64) of
        the valid groups in the output's key order: under deferred greedy
        each unique k-mer is remapped to its greedy bin on the host and
        the groups re-sorted there (kmc_tpu's host mirror of its collect;
        this route exists because they do not fit the device).  Deferred
        greedy's host route takes it, for both outputs (_remapped_groups).
        The store is consumed."""
        with trace.span("kmc.host_merge"):
            runs = self._take_runs()
            launches = radix_sort_columns.launches
            cols, totals, _ = merge_runs_to_host(runs, self.n_cols,
                                                 self.device)
            launches = radix_sort_columns.launches - launches
            self.merge_launches += launches
            trace.add("sort_launches", launches)
            del runs
            if self._ing_fuse:
                bins = cols[0] >> np.uint32(2 * self.r0)
                lanes = ([cols[0] & np.uint32((1 << (2 * self.r0)) - 1)]
                         + cols[1:])
            else:
                bins, lanes = cols[0], cols[1:]
            valid = (bins < self._ing_n_bins) & (totals > 0)
            lanes = np.stack([x[valid] for x in lanes], axis=1)
            bins, totals = bins[valid].astype(np.uint32), totals[valid]
            if self._g_defer:
                from ..signatures import sig_of_lanes_numpy

                sm = self._sig_map.cpu().numpy()
                sig = sig_of_lanes_numpy(lanes, self.k, self.sig_len)
                bins = sm[np.minimum(sig, np.uint32(len(sm) - 1))].astype(
                    np.uint32)
                order = np.lexsort(tuple(lanes[:, ::-1].T) + (bins,))
                bins, lanes, totals = bins[order], lanes[order], totals[order]
            trace.add("rows", len(bins))
            return bins, lanes, totals

    def _finalize_records_host(self, emit, n_rows: int, row_bytes: int):
        """The host route of both finalizes (kmc_tpu's
        _finalize_records_host and its words-path twin), for a unique set
        that outgrows the store; emit, n_rows and row_bytes as in
        _finalize.  A group source hands the groups over in the output's
        order a piece at a time, on the store's device: each key range of
        the merge where its key order is the output's (prefix and eager
        greedy stores, _merged_groups), else chunks of the host merge's
        remapped groups (deferred greedy, which re-sorts across all ranges,
        _remapped_groups).  Each piece goes through emit while it is there
        and its rows are copied to the host as it completes
        (kmc.host_completer [ranges, d2h_bytes]); the summed tensors and
        the stats follow the last (kmc.host_completer [rows, d2h_bytes]).
        Returns what _finalize returns."""
        with trace.span("kmc.host_route"):
            source = (self._remapped_groups if self._g_defer
                      else self._merged_groups)
            stats = torch.zeros(3, dtype=torch.int64, device=self.device)
            sums, parts = None, []
            for got in source(row_bytes):
                with trace.span("kmc.host_completer"):
                    *out, stats_r = emit(*got)
                    del got
                    if sums is None:
                        sums = [torch.zeros_like(x) for x in out[n_rows:]]
                    for acc, x in zip(sums, out[n_rows:]):
                        acc += x
                    stats += torch.stack(stats_r)
                    parts.append([x.cpu().numpy() for x in out[:n_rows]])
                    del out
                    trace.add("d2h_bytes", sum(x.nbytes for x in parts[-1]))
                    trace.add("ranges", 1)
            with trace.span("kmc.host_completer"):
                rows = [x[0] if len(x) == 1 else np.concatenate(x)
                        for x in zip(*parts)]
                del parts
                sums = [x.cpu().numpy() for x in sums]
                stats_h = tuple(int(x) for x in stats.cpu())
                trace.add("rows", len(rows[0]))
                trace.add("d2h_bytes",
                          sum(x.nbytes for x in sums) + stats.nbytes)
        return rows + sums, stats_h

    def _merged_groups(self, row_bytes: int):
        """The host route's group source where the merge's key order is the
        output's: the spilled runs and the compacted store merged on the
        store's device a key range at a time (kmc.host_merge, once to take
        the runs, then once a range [rows, sort_launches]), each range sized
        to leave row_bytes a group for the emitter, with the merge's exact
        int64 totals (kmc_tpu's u64 host merge).  Yields (key columns,
        totals) a range, at least one.  The store is consumed."""
        with trace.span("kmc.host_merge"):
            live, _ = _live_runs(self._take_runs())
            ranges = _merge_ranges(live, self.n_cols, self.device,
                                   caller=row_bytes)
            del live
        n = 0
        while True:
            with trace.span("kmc.host_merge"):
                launches = radix_sort_columns.launches
                got = next(ranges, None)
                launches = radix_sort_columns.launches - launches
                self.merge_launches += launches
                trace.add("sort_launches", launches)
                if got is not None:
                    trace.add("rows", len(got[1]))
            if got is None:
                break
            n += 1
            yield got
        if not n:  # no live row: one empty range, for the output's shapes
            yield ([torch.empty(0, dtype=torch.int32, device=self.device)]
                   * self.n_cols,
                   torch.empty(0, dtype=torch.int64, device=self.device))

    def _remapped_groups(self, row_bytes: int):
        """Deferred greedy's group source: the host merge's groups
        (_host_merge: remapped to greedy bins and re-sorted on the host)
        uploaded back to the store's device in chunks sized as a merge's
        key ranges are (_merge_rows, row_bytes a group for the emitter; an
        emitter works row by row, so any cut is exact), as greedy key
        columns and exact int64 totals (kmc.host_merge a chunk
        [h2d_bytes]).  Yields at least one chunk.  The store is
        consumed."""
        bins, lanes, totals = self._host_merge()
        n = len(totals)
        step = _merge_rows(self.device, self.n_cols, None,
                           row_bytes) or max(n, 1)
        for a in range(0, max(n, 1), step):
            with trace.span("kmc.host_merge"):
                part = (bins[a:a + step].view(np.int32),
                        lanes[a:a + step].view(np.int32),
                        totals[a:a + step].view(np.int64))
                trace.add("h2d_bytes", sum(x.nbytes for x in part))
                b, w, t = (torch.from_numpy(x).to(self.device) for x in part)
                lanes_d = [i32_to_u32(w[:, j]) for j in range(self.W)]
                cols = _fused_cols(i32_to_u32(b), lanes_d, fuse=self.fuse,
                                   r0=self.r0)
                del b, w, lanes_d
            yield cols, t

    def total_occurrences(self) -> int:
        return int(self.occ_acc)

    def total_super_kmers(self) -> int:
        return int(self.skm_acc)

    def host_sig_map(self) -> np.ndarray:
        """The signature->bin map as int32[4^sig_len + 1] (for the .kmc_pre
        footer; a greedy map with its -1 slots routed to the dead bin, as
        kmc_tpu's host_sig_map returns it)."""
        if self.map_mode == "greedy":
            self._require_sig_map()
            return self._sig_map.cpu().numpy()
        return prefix_sig_map(self.sig_len, self.prefix_bits)

    def set_sig_map(self, sig_map: np.ndarray):
        """Install (or, under deferred greedy, replace) the greedy map
        (mirrors kmc_tpu's set_sig_map): -1 slots go to the dead bin
        n_used_bins, and the output layout follows greedy_fuse."""
        if self.map_mode != "greedy":
            raise ValueError("set_sig_map applies to greedy map_mode only")
        if self._sig_map is not None and not self._g_defer:
            raise ValueError("eager greedy stores cannot change their map")
        sig_map = np.asarray(sig_map)
        self.n_used_bins = int(sig_map.max()) + 1
        self.fuse = greedy_fuse(self.k, self.n_used_bins)
        sm = np.where(sig_map < 0, self.n_used_bins, sig_map)
        self._sig_map = torch.from_numpy(
            np.ascontiguousarray(sm, dtype=np.int32)).to(self.device)

    def _require_sig_map(self):
        if self.map_mode == "greedy" and self._sig_map is None:
            raise RuntimeError(
                "deferred greedy store: call set_sig_map() before finalize/"
                "checkpoint (the stage-0 histogram feeds it)")

    def _reduce_live(self):
        """The live rows grouped, in the output's key order: (key columns,
        int64 totals mod 2^32, zero groups dropped).  Under deferred greedy
        the groups (rows of the prefix layout) are remapped and re-sorted by
        the greedy key (the collect; kmc_tpu's _greedy_collect /
        _greedy_remap_store): the signature is recomputed from each
        k-mer's lanes, mapped through the greedy map, and the greedy key
        columns sorted with the totals riding along by the grouping-sort
        kernel."""
        cols, counts = self._live_rows()
        reps, totals = _group_reduce(cols, counts, self.n_cols)
        del cols, counts
        if not self._g_defer:
            return reps, totals
        _, wr = _split_bins(reps, fuse=self._ing_fuse, r0=self.r0)
        del reps
        sig = sig_of_word_cols(wr, k=self.k, sig_len=self.sig_len)
        slot = torch.clamp(sig, max=self._sig_map.shape[0] - 1)
        gbins = self._sig_map[slot].to(torch.int64)
        del sig, slot
        g_cols = _fused_cols(gbins, wr, fuse=self.fuse, r0=self.r0)
        del gbins, wr
        with trace.span("kmc.collect"):
            launches = radix_sort_columns.launches
            out = radix_sort_columns(g_cols + [u32_to_i32(totals)],
                                     len(g_cols))
            launches = radix_sort_columns.launches - launches
            self.collect_launches += launches
            trace.add("sort_launches", launches)
            trace.add("rows", len(totals))
        return out[:-1], i32_to_u32(out[-1])

    def _finalize(self, emit, n_rows: int, row_bytes: int):
        """The route skeleton of both finalizes.  emit(reps, totals) takes
        grouped rows in the output's key order on the store's device and
        returns (*row tensors, *summed tensors, (n_unique, n_below,
        n_above) tensors), its first n_rows tensors a row per kept group;
        row_bytes: the device bytes it may take for a group.  Spilled runs
        are replayed into the store first; the live rows' groups
        (_reduce_live) then go through emit and are copied to the host in
        one piece (the device and replay routes; kmc.finalize_exec ends
        with the device, then kmc.finalize_d2h).  When they do not fit, the
        host route takes over (_finalize_records_host).  Returns ([row
        arrays, summed arrays] on the host, the stats as ints).  The store
        is consumed."""
        with trace.span("kmc.finalize"):
            self._require_sig_map()
            replayed = bool(self.spilled)
            try:
                self._replay_spills()
            except _SpillOverflow:
                self.finalize_route = "host"
                return self._finalize_records_host(emit, n_rows, row_bytes)
            self.finalize_route = "replay" if replayed else "device"
            with trace.span("kmc.finalize_exec"):  # ends with the device
                *out, stats = emit(*self._reduce_live())
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            with trace.span("kmc.finalize_d2h"):
                out = [x.cpu().numpy() for x in out]
                stats = tuple(int(x) for x in torch.stack(stats).cpu())
                trace.add("rows", len(out[0]))
                trace.add("bytes", sum(x.nbytes for x in out))
            self.key_cols = self.counts = None
            return out, stats

    def finalize_records(self, *, cutoff_min: int, cutoff_max: int,
                         counter_max: int, lut_prefix_len: int,
                         counter_size: int):
        """KMC2 finalize: _finalize with the completer (_complete_groups).
        Returns (rec u8[N, record_bytes] in final record order,
        cutoff-filtered; lut uint64[n_bins << 2*lpl]; (n_unique, n_below,
        n_above)).  The store is consumed."""
        kw = dict(cutoff_min=cutoff_min, cutoff_max=cutoff_max,
                  counter_max=counter_max, lut_prefix_len=lut_prefix_len,
                  counter_size=counter_size)
        rb = ((self.k - lut_prefix_len) // 4 if lut_prefix_len
              else (self.k + 3) // 4) + counter_size
        (rec, lut), stats = self._finalize(
            lambda reps, totals: _complete_groups(self, reps, totals, **kw),
            1, _completer_row_bytes(self.n_cols, self.W, rb))
        return rec, lut.view(np.uint64), stats

    def finalize(self, *, cutoff_min: int, cutoff_max: int,
                 counter_max: int):
        """Words-path finalize (KFF output and -w; kmc_tpu's finalize):
        _finalize with the words emitter (_word_groups).  Returns (bins
        int32, words uint32[N, W], counts uint32, (n_unique, n_below,
        n_above)) as host arrays in final record order, cutoff-filtered and
        clamped to counter_max.  The device and replay routes take u32
        group totals (a group that wraps to 0 is dropped), the host route
        exact totals, as finalize_records.  The store is consumed."""
        (bins, words, counts), stats = self._finalize(
            lambda reps, totals: _word_groups(
                self, reps, totals, cutoff_min=cutoff_min,
                cutoff_max=cutoff_max, counter_max=counter_max),
            3, _word_row_bytes(self.n_cols, self.W))
        return bins, words.view(np.uint32), counts.view(np.uint32), stats

    # -- stage-1 checkpoints, in kmc_tpu's file format --

    def save_checkpoint(self, path: str):
        """Compact, then write the store to `path`.npz and each spilled run
        to `path`.spill{i}.npz, with kmc_tpu's keys and types, so either
        package resumes it."""
        self._require_sig_map()
        sig_map = np.zeros(0, np.int32)
        if self.map_mode == "greedy":  # in its -1 form, as kmc_tpu saves it
            sm = self.host_sig_map()
            sig_map = np.where(sm == self.n_used_bins, -1, sm).astype(np.int32)
        self.compact()
        n = self.n_used
        cols = np.stack([_host_u32(c[:n]) for c in self.key_cols])
        counts = _host_u32(self.counts[:n])
        occ = self.total_occurrences()
        # kmc_tpu reads occ_upper as a bound on any one reduction's count
        # sum (it picks its wide group-reduce from it); the port needs none
        held = int(counts.sum(dtype=np.uint64)) + sum(
            int(c.sum(dtype=np.uint64)) for _, c in self.spilled)
        np.savez_compressed(
            path,
            cols=cols,
            counts=counts,
            occ=_acc_pair(occ),
            skm=_acc_pair(self.total_super_kmers()),
            occ_upper=np.asarray(occ + held, dtype=np.uint64),
            k=np.asarray(self.k),
            sig_len=np.asarray(self.sig_len),
            both_strands=np.asarray(self.both_strands),
            n_used_bins=np.asarray(self.n_used_bins),
            prefix_bits=np.asarray(self.prefix_bits),
            map_mode=np.asarray(self.map_mode),
            # deferred greedy rows keep the prefix layout; the loader
            # rebuilds it whatever KMC_TPU_GREEDY_DEFER says then
            greedy_defer=np.asarray(self._g_defer),
            sig_map=sig_map,
            spilled=np.asarray(len(self.spilled)),
        )
        for i, (run_cols, run_counts) in enumerate(self.spilled):
            np.savez_compressed(f"{path}.spill{i}", cols=np.stack(run_cols),
                                counts=run_counts)

    @classmethod
    def load_checkpoint(cls, path: str, capacity_rows: int, *,
                        device="cuda") -> "DeviceKmerStore":
        """A store holding a checkpoint written by save_checkpoint or by
        kmc_tpu's (mirrors kmc_tpu's load_checkpoint; occ_upper is not
        read)."""
        device = resolve_device(device)
        data = np.load(path if str(path).endswith(".npz") else f"{path}.npz")
        map_mode = str(data["map_mode"])
        if map_mode == "prefix":
            kw = dict(n_bins=1 << int(data["prefix_bits"]))
        else:
            # checkpoints from before the deferred mode hold eager rows
            kw = dict(n_bins=int(data["n_used_bins"]), sig_map=data["sig_map"],
                      greedy_defer=bool(data["greedy_defer"])
                      if "greedy_defer" in data else False)
        n = len(data["counts"])

        def r32(x):  # kmc_tpu rounds store sizes up to 32 rows
            return (int(x) + 31) & ~31

        store = cls(r32(max(capacity_rows, 2 * max(n, 1))),
                    k=int(data["k"]), sig_len=int(data["sig_len"]),
                    both_strands=bool(data["both_strands"]),
                    map_mode=map_mode, **kw,
                    initial_rows=r32(max(2 * n, 1 << 10)), device=device)
        store.append(tuple(data["cols"]), data["counts"],
                     count_occurrences=False)
        store.occ_acc.fill_(_acc_value(data["occ"]))
        store.skm_acc.fill_(_acc_value(data["skm"]))
        for i in range(int(data["spilled"])):
            sp = np.load(f"{path}.spill{i}.npz")
            store.spilled.append((tuple(sp["cols"]), sp["counts"]))
        return store


def store_from_numpy_state(key_cols, counts, n_used, occ_acc, skm_acc,
                           prev_sig, *, k, sig_len, both_strands, n_bins,
                           device="cuda") -> DeviceKmerStore:
    """A DeviceKmerStore holding the state of a kmc_tpu store, given as
    numpy arrays: key_cols (uint32 columns, rows [0, n_used) used), counts
    (uint32 or None), occ_acc / skm_acc ((lo, hi) uint32 pairs), prev_sig
    (uint32[1]).  The layouts of the two packages are the same, so the
    state carries across as it is; checkpoint files carry it too
    (DeviceKmerStore.load_checkpoint)."""
    n_used = int(n_used)
    rows = max(len(np.asarray(key_cols[0])), n_used, 1)
    st = DeviceKmerStore(rows, k=k, sig_len=sig_len,
                         both_strands=both_strands, n_bins=n_bins,
                         device=device)
    if len(key_cols) != st.n_cols:
        raise ValueError(f"{len(key_cols)} key columns, store layout needs "
                         f"{st.n_cols}")

    def dev(a):
        return st._u32_to_device(np.asarray(a)[:n_used])

    for dst, src in zip(st.key_cols, key_cols):
        dst[:n_used] = dev(src)
    if counts is not None:
        st.counts = torch.zeros(rows, dtype=torch.int32, device=st.device)
        st.counts[:n_used] = dev(counts)
    st.n_used = n_used
    st.occ_acc.fill_(_acc_value(occ_acc))
    st.skm_acc.fill_(_acc_value(skm_acc))
    st.prev_sig = torch.from_numpy(
        np.array(prev_sig, dtype=np.uint32).reshape(1).view(np.int32)
    ).to(st.device)
    return st
