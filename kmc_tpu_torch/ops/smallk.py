"""Small-k counting (k <= 13): a dense 4^k histogram on the device.

The port's counterpart of kmc_tpu/ops/smallk.py (KMC's small-k
optimisation, kmc.h:677-970, splitter.cpp:682-805): no bins and no sort;
every valid (canonical) k-mer of a batch adds one to its slot of a dense
histogram of 4^k + 1 int64 slots, whose last slot takes the invalid
positions.  The batch arrives in the packed+mask feed
(io/native.py::pack_codes_fused) and is decoded, packed into windows and
canonicalised by the same torch ops as the splitter scan's plain version
(ops/extract.py); kmc_tpu does the same in XLA ops with a scatter-add.
kmc_tpu's histogram is u32 and wraps, so the runner reduces the int64
slots mod 2^32 at the end.
"""
from __future__ import annotations

import torch

from ..io.readers import batch_len
from .extract import _kmer_words, _pack_streams, _unpack_device


def smallk_histogram_size(k: int) -> int:
    """Slots of the histogram: one per k-mer and the invalid slot."""
    return (1 << (2 * k)) + 1


def smallk_batch(buf: torch.Tensor, hist: torch.Tensor, *, s: int, k: int,
                 both_strands: bool) -> None:
    """Add one batch's k-mer occurrences to hist (int64[4^k + 1], in place).

    buf: the batch's pack_codes_fused buffer (u8[3L/8], L = batch_len(s,
    k)) on hist's device."""
    L = batch_len(s, k)
    c4, bad = _unpack_device(buf[: L // 4], buf[L // 4: L // 4 + L // 8])
    p, q = _pack_streams(c4, L - 15)
    cs = torch.cat([bad.new_zeros(1), torch.cumsum(bad, 0)])
    valid = (cs[k:k + s] - cs[:s]) == 0
    word = _kmer_words(p, q, k, s, both_strands)[0]  # k <= 13: one lane
    idx = torch.where(valid, word, 1 << (2 * k))
    hist.index_add_(0, idx, torch.ones_like(idx))
