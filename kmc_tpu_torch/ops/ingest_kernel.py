"""The fused ingest: one batch of the feed into the store's key columns.

Kernel: csrc/extract.cu (C entries kmc_ingest_bounds and kmc_ingest_mask),
the Hopper counterpart of the executable that kmc_tpu builds per batch from
kmc_tpu/ops/store.py::_ingest_prefix_bounds / ::_ingest_prefix_fused (feed
decode, the splitter scan of pallas_extract2d, signature -> bin, key
columns, append) under the "prefix" policy; see the source for the design
and bound.  One launch per batch (the boundary-delta feed adds one short
single-block launch for the delta prefix sum) writes rows [n_used, n_used +
s) of the store's columns in place and adds to the occurrence and
super-k-mer accumulators on the device, so the host never waits.

Plain version: ingest_plain below, the composition of the decode
(decode_boundaries / decode_fused), the scan's plain version
(ops/extract_kernel.py::splitter_scan_plain) and the binning
(bin_and_append); it runs for CPU tensors and is what the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..io.readers import batch_len
from .extract import _unpack_device, i32_to_u32, u32_to_i32
from .extract_kernel import MAX_K, MIN_K, splitter_scan_plain

_DEAD = -1  # all-ones u32 as an int32 bit view
TILE = 1024  # positions per block of the kernel (csrc/extract.cu)


# -- plain version --

def _unpack_boundaries(buf: torch.Tensor, tail_start: int, *, s: int,
                       k: int):
    """Decode the boundary-delta feed (io/native.py::pack_codes_boundaries):
    2-bit packed codes ++ little-endian u16 sentinel-position deltas.
    Returns (c4 int64[L], bad int64[L]); bad[i] = 1 iff i is a listed
    sentinel or batch padding (i >= tail_start).  Mirrors
    kmc_tpu/ops/store.py::_unpack_boundaries."""
    L = batch_len(s, k)
    p = buf[: L // 4].to(torch.int64)
    c4 = torch.stack([(p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3, p & 3],
                     dim=1).reshape(-1)
    d8 = buf[L // 4 :].to(torch.int64).reshape(-1, 2)
    deltas = d8[:, 0] | (d8[:, 1] << 8)
    pos = torch.cumsum(deltas, 0) - 1  # padding slots repeat the last
    bad = torch.zeros(L + 1, dtype=torch.int64, device=buf.device)
    bad[torch.where(pos >= 0, pos, L)] = 1
    bad = bad[:L]
    bad |= (torch.arange(L, device=buf.device) >= tail_start).to(torch.int64)
    return c4, bad


def decode_boundaries(buf: torch.Tensor, tail_start: int, *, s: int,
                      k: int) -> torch.Tensor:
    """The boundary-delta feed as the u8 code stream the splitter scan
    takes (4 at a sentinel)."""
    return _codes_from(*_unpack_boundaries(buf, tail_start, s=s, k=k))


def decode_fused(buf: torch.Tensor, *, s: int, k: int) -> torch.Tensor:
    """The packed+mask feed (io/native.py::pack_codes_fused) as the u8
    code stream the splitter scan takes."""
    L = batch_len(s, k)
    return _codes_from(*_unpack_device(buf[: L // 4], buf[L // 4 :]))


def _codes_from(c4: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """(c4, bad) -> u8 codes (4 marks a sentinel)."""
    return torch.where(bad != 0, 4, c4).to(torch.uint8)


def _key_cols_from(bins, lanes, valid, *, fuse: bool, r0: int):
    """Store key columns (int32 bit views) from per-position bins (int64)
    and lanes (int32 views; all-ones where invalid).  Mirrors
    kmc_tpu/ops/store.py::_key_cols_from."""
    if fuse:
        col0 = (bins << (2 * r0)) | i32_to_u32(lanes[0])
        return [torch.where(valid, u32_to_i32(col0), _DEAD)] + list(lanes[1:])
    return [torch.where(valid, u32_to_i32(bins), _DEAD)] + list(lanes)


def bin_and_append(sig, lanes, key_cols, counts, n_used: int, occ_acc,
                   skm_acc, prev_sig, *, sig_len: int, prefix_bits: int,
                   fuse: bool, r0: int) -> torch.Tensor:
    """Signature -> bin, key columns written at rows [n_used, n_used + s),
    counts set to 1 there (when the column exists), occ_acc / skm_acc
    added to in place; returns the new prev_sig (int32[1]).  Mirrors
    kmc_tpu/ops/store.py::_ingest_binning under the "prefix" policy."""
    valid = sig != _DEAD
    # a super-k-mer starts at each valid position whose signature
    # differs from its predecessor's (KMC splitter.cpp:557-677)
    prev = torch.cat([prev_sig, sig[:-1]])
    skm_acc += (valid & (sig != prev)).sum()
    occ_acc += valid.sum()
    bins = i32_to_u32(sig) >> (2 * sig_len - prefix_bits)
    cols = _key_cols_from(bins, lanes, valid, fuse=fuse, r0=r0)
    lo, hi = n_used, n_used + sig.shape[0]
    for dst, src in zip(key_cols, cols):
        dst[lo:hi] = src
    if counts is not None:
        counts[lo:hi] = 1
    return sig[-1:].clone()


def ingest_plain(buf, tail_start, key_cols, counts, n_used: int, occ_acc,
                 skm_acc, prev_sig, *, s: int, k: int, sig_len: int,
                 both_strands: bool, prefix_bits: int, fuse: bool):
    """The fused ingest's plain version: decode (tail_start None: the
    packed+mask feed), splitter scan, bin and append; same contract as
    ingest()."""
    if tail_start is None:
        codes = decode_fused(buf, s=s, k=k)
    else:
        codes = decode_boundaries(buf, int(tail_start), s=s, k=k)
    sig, lanes = splitter_scan_plain(codes, s=s, k=k, sig_len=sig_len,
                                     both_strands=both_strands)
    W = (k + 15) // 16
    return bin_and_append(sig, lanes, key_cols, counts, n_used, occ_acc,
                          skm_acc, prev_sig, sig_len=sig_len,
                          prefix_bits=prefix_bits, fuse=fuse,
                          r0=k - 16 * (W - 1))


# -- the kernel's wrapper --

def _check(buf, tail_start, key_cols, counts, n_used, occ_acc, skm_acc,
           prev_sig, s, k, sig_len, prefix_bits, fuse):
    dev = buf.device
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous 1-D uint8 tensor")
    if s <= 0 or s % 8:
        raise ValueError("s must be a positive multiple of 8")
    if not (MIN_K <= k <= MAX_K) or not (5 <= sig_len <= 11):
        raise ValueError(f"k={k} / sig_len={sig_len} out of range")
    W = (k + 15) // 16
    r0 = k - 16 * (W - 1)
    if not 0 <= prefix_bits <= 2 * sig_len or (
            fuse and 2 * r0 + prefix_bits + 1 > 32):
        raise ValueError(f"prefix_bits={prefix_bits} / fuse={fuse} do not "
                         f"fit k={k}")
    L = batch_len(s, k)
    if tail_start is None:
        if buf.numel() != L // 4 + L // 8:
            raise ValueError(f"a packed+mask batch holds {L // 4 + L // 8} "
                             f"bytes, got {buf.numel()}")
    elif buf.numel() < L // 4 or (buf.numel() - L // 4) % 2:
        raise ValueError("a boundary-delta batch holds L/4 bytes and whole "
                         "u16 deltas")
    if len(key_cols) != W + (0 if fuse else 1):
        raise ValueError(f"{len(key_cols)} key columns; the layout needs "
                         f"{W + (0 if fuse else 1)}")
    if n_used < 0:
        raise ValueError("n_used must be >= 0")
    for c in list(key_cols) + ([counts] if counts is not None else []):
        if (c.dtype != torch.int32 or c.dim() != 1 or not c.is_contiguous()
                or c.device != dev):
            raise ValueError("columns must be contiguous 1-D int32 tensors "
                             "on the feed's device")
        if c.numel() < n_used + s:
            raise ValueError(f"a column of {c.numel()} rows cannot take rows "
                             f"[{n_used}, {n_used + s})")
    for name, t, dtype in (("occ_acc", occ_acc, torch.int64),
                           ("skm_acc", skm_acc, torch.int64),
                           ("prev_sig", prev_sig, torch.int32)):
        if t.dtype != dtype or t.numel() != 1 or t.device != dev:
            raise ValueError(f"{name} must be one {dtype} on the feed's "
                             "device")


def ingest(buf: torch.Tensor, tail_start, key_cols, counts, n_used: int,
           occ_acc: torch.Tensor, skm_acc: torch.Tensor,
           prev_sig: torch.Tensor, *, s: int, k: int, sig_len: int,
           both_strands: bool, prefix_bits: int, fuse: bool) -> torch.Tensor:
    """Ingest one batch into a store's columns, in place.

    buf: the batch's feed as a contiguous uint8 tensor, the boundary-delta
    format with tail_start an int, or the packed+mask format with
    tail_start None.  key_cols: the store's int32 key columns (fused: W
    columns, the bin in lane 0's top bits; else the bin column and W
    lanes); counts: its int32 counts column or None.  Rows [n_used,
    n_used + s) are written; occ_acc and skm_acc (int64 scalars) are added
    to; prev_sig (int32[1], the signature before position 0) is read, and
    the new one (the signature of position s - 1) is returned in a tensor
    of its own.

    A CPU feed takes the plain version; a CUDA feed launches the kernel on
    the current stream (and counts the launch); anything else raises."""
    _check(buf, tail_start, key_cols, counts, n_used, occ_acc, skm_acc,
           prev_sig, s, k, sig_len, prefix_bits, fuse)
    if buf.device.type == "cpu":
        return ingest_plain(buf, tail_start, key_cols, counts, n_used,
                            occ_acc, skm_acc, prev_sig, s=s, k=k,
                            sig_len=sig_len, both_strands=both_strands,
                            prefix_bits=prefix_bits, fuse=fuse)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    from .. import _build

    lib = _build.load("extract")
    dev = buf.device
    prev_out = torch.empty(1, dtype=torch.int32, device=dev)
    cols = (ctypes.c_void_p * len(key_cols))(*[c.data_ptr() for c in key_cols])
    counts_ptr = counts.data_ptr() if counts is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tail_start is None:
        err = lib.kmc_ingest_mask(
            dev.index, buf.data_ptr(), buf.numel(), cols, len(key_cols),
            n_used, counts_ptr, occ_acc.data_ptr(), skm_acc.data_ptr(),
            prev_sig.data_ptr(), prev_out.data_ptr(), s, k, sig_len,
            int(both_strands), prefix_bits, int(fuse), stream)
    else:
        scratch = torch.empty(2 * ((s + TILE - 1) // TILE + 2),
                              dtype=torch.int32, device=dev)
        err = lib.kmc_ingest_bounds(
            dev.index, buf.data_ptr(), buf.numel(), int(tail_start),
            scratch.data_ptr(), cols, len(key_cols), n_used, counts_ptr,
            occ_acc.data_ptr(), skm_acc.data_ptr(), prev_sig.data_ptr(),
            prev_out.data_ptr(), s, k, sig_len, int(both_strands),
            prefix_bits, int(fuse), stream)
    _build.check(lib, err, "fused ingest launch")
    ingest.launches += 1
    return prev_out


ingest.launches = 0
