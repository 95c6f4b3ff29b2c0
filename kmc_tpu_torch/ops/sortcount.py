"""The host-bucket route's device work (kmc_tpu's --no-device-store path).

The port's counterpart of kmc_tpu/ops/sortcount.py and of the stage-0 and
stage-1 batch functions of kmc_tpu/ops/extract.py:

  stage 0   stage0_accum: the signature histogram of a sampled batch, from
            the splitter-scan kernel's signatures (ops/extract_kernel.py)
            and an index_add_;
  stage 1   stage1_batch: one batch's unique (signature, k-mer, count)
            triples: the splitter-scan kernel, then the grouping-sort
            kernel (ops/sort_kernel.py) on the keys [sig, *lanes], group
            starts, run lengths and a compaction in torch ops;
  stage 2   merge_count_bin: one bin's rows merged by k-mer with the
            grouping-sort kernel, their counts summed mod 2^32 (kmc_tpu's
            u32 segment sum; a group that wraps to 0 is dropped), the
            cutoffs, the counter_max clamp and the front compaction.

Columns are int32 tensors holding u32 bit patterns, as in the store.
"""
from __future__ import annotations

import torch

from .extract import i32_to_u32
from .extract_kernel import extract_splitter_scan
from .store import _group_reduce


def stage0_accum(codes: torch.Tensor, hist: torch.Tensor, *, s: int, k: int,
                 sig_len: int) -> None:
    """Add a batch's per-position signatures to hist (int64[4^m + 1], in
    place; invalid windows are not counted), as kmc_tpu's
    stage0_stats_accum does.  codes: the batch's u8 codes on hist's
    device."""
    sig, _ = extract_splitter_scan(codes, s=s, k=k, sig_len=sig_len,
                                   both_strands=True)
    sig = sig[sig >= 0].to(torch.int64)  # INVALID_SIG is -1 as an int32
    hist.index_add_(0, sig, torch.ones_like(sig))


def stage1_batch(codes: torch.Tensor, *, s: int, k: int, sig_len: int,
                 both_strands: bool):
    """One batch's unique rows in (sig, k-mer) order, as kmc_tpu's
    stage1_batch_packed returns its first n_groups rows: (sig int32,
    lanes [int32] * W, counts int64), u32 bit views.  Invalid windows form
    the last group (sig 0xFFFFFFFF, all-ones lanes).  codes: the batch's
    u8 codes on the device that computes."""
    sig, lanes = extract_splitter_scan(codes, s=s, k=k, sig_len=sig_len,
                                       both_strands=both_strands)
    cols, counts = _group_reduce([sig, *lanes.unbind(0)], None,
                                 1 + lanes.shape[0])
    return cols[0], cols[1:], counts


def merge_count_bin(cols, counts: torch.Tensor, *, cutoff_min: int,
                    cutoff_max: int, counter_max: int):
    """Merge one bin's rows (kmc_tpu's merge_count_bin).

    cols: the W k-mer lanes (int32 bit views, rows in any order); counts:
    their int32 (u32) partial counts.  Rows of count 0 (kmc_tpu's padding)
    add nothing.  Returns (kept lanes int64[n_kept, W] of u32 values in
    k-mer order, kept counts int64 clamped to counter_max, (n_unique,
    n_below, n_above))."""
    reps, totals = _group_reduce(list(cols), counts, len(cols))
    below = totals < cutoff_min
    above = totals > cutoff_max
    keep = ~below & ~above
    words = torch.stack([i32_to_u32(r[keep]) for r in reps], dim=1)
    stats = (totals.shape[0], int(below.sum()), int(above.sum()))
    return words, torch.clamp(totals[keep], max=counter_max), stats
