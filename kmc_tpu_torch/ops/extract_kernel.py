"""The splitter scan: per start position, signature + canonical k-mer lanes.

Kernel: csrc/extract.cu, the Hopper port of the TPU kernels
kmc_tpu/ops/pallas_extract.py::pallas_extract2d (extract_splitter_scan) and
::pallas_extract (extract_splitter_scan_1d, the 1-D tile layout's
contract), see the source for the design and bound.  Both entries read a
u8 code stream; the store's ingest does not call them: it runs the same
device code on the packed feed inside one fused launch per batch
(ops/ingest_kernel.py), so no decoded code stream is ever written.  Plain
version: splitter_scan_plain below, built from ops/extract.py; it runs for
CPU tensors and is what the kernel is held against on the card.
"""
from __future__ import annotations

import torch

from ..io.readers import batch_len
from .extract import (_kmer_words, codes_to_c4_bad, position_sigs,
                      u32_to_i32)

MIN_K = 14
MAX_K = 256
TILE_1D = 1 << 16  # pallas_extract's positions per grid step
HALO_1D = 2048  # pallas_extract's codes past the tile
TAIL = 16  # codes past the last k-mer start that the packed windows read


def splitter_scan_plain(codes: torch.Tensor, *, s: int, k: int, sig_len: int,
                        both_strands: bool):
    """(sig int32[s], lanes int32[W, s]) as u32 bit views, from a u8 code
    stream (codes >= 4 are sentinels); mirrors kmc_tpu's
    extract.position_sigs + _kmer_words with invalid lanes all-ones."""
    c4, bad = codes_to_c4_bad(codes[: batch_len(s, k)])
    valid, sig, p, q = position_sigs(c4, bad, s=s, k=k, sig_len=sig_len)
    words = _kmer_words(p, q, k, s, both_strands)
    lanes = torch.stack([u32_to_i32(torch.where(valid, w, 0xFFFFFFFF))
                         for w in words])
    return u32_to_i32(sig), lanes


def extract_splitter_scan(codes: torch.Tensor, *, s: int, k: int,
                          sig_len: int, both_strands: bool):
    """The splitter scan of one batch.

    codes: contiguous 1-D uint8 tensor of at least batch_len(s, k) codes,
    s % 8 == 0, MIN_K <= k <= MAX_K, 5 <= sig_len <= 11.  Returns
    (sig int32[s], lanes int32[W, s]), u32 bit views: sig is 0xFFFFFFFF and
    every lane all-ones where the window holds a sentinel.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream (and counts the launch); anything else raises."""
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError("codes must be a 1-D uint8 tensor")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if s <= 0 or s % 8:
        raise ValueError("s must be a positive multiple of 8")
    if not (MIN_K <= k <= MAX_K) or not (5 <= sig_len <= 11):
        raise ValueError(f"k={k} / sig_len={sig_len} out of range")
    if codes.numel() < batch_len(s, k):
        raise ValueError(f"need {batch_len(s, k)} codes, got {codes.numel()}")
    if codes.device.type == "cpu":
        return splitter_scan_plain(codes, s=s, k=k, sig_len=sig_len,
                                   both_strands=both_strands)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    from .. import _build

    lib = _build.load("extract")
    W = (k + 15) // 16
    sig = torch.empty(s, dtype=torch.int32, device=codes.device)
    lanes = torch.empty((W, s), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.kmc_splitter_scan(
            codes.device.index, codes.data_ptr(), codes.numel(),
            sig.data_ptr(), lanes.data_ptr(), s, k, sig_len,
            int(both_strands), stream)
    _build.check(lib, err, "splitter scan launch")
    extract_splitter_scan.launches += 1
    return sig, lanes


extract_splitter_scan.launches = 0


def extract_splitter_scan_1d(codes: torch.Tensor, *, s: int, k: int,
                             sig_len: int, both_strands: bool):
    """The splitter scan under pallas_extract's 1-D contract.

    codes: contiguous 1-D uint8 tensor of s + 2048 codes (at least),
    s % 65536 == 0, k + 16 <= 2048, MIN_K <= k, 5 <= sig_len <= 11; only
    codes [0, batch_len(s, k)) are read.  Returns (sig int32[s],
    [lane_0 ... lane_{W-1}] as W int32[s] tensors), u32 bit views, as
    pallas_extract returns them.

    A CPU tensor takes the plain version; a CUDA tensor launches the 1-D C
    entry (which checks the contract itself) on the current stream and
    counts the launch; anything else raises."""
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError("codes must be a 1-D uint8 tensor")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if s <= 0 or s % TILE_1D:
        raise ValueError(f"s must be a positive multiple of {TILE_1D}")
    if not (MIN_K <= k and k + TAIL <= HALO_1D) or not (5 <= sig_len <= 11):
        raise ValueError(f"k={k} / sig_len={sig_len} out of range")
    if codes.numel() < s + HALO_1D:
        raise ValueError(f"need {s + HALO_1D} codes, got {codes.numel()}")
    W = (k + 15) // 16
    if codes.device.type == "cpu":
        sig, lanes = splitter_scan_plain(codes, s=s, k=k, sig_len=sig_len,
                                         both_strands=both_strands)
        return sig, list(lanes.unbind(0))
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    from .. import _build

    lib = _build.load("extract")
    sig = torch.empty(s, dtype=torch.int32, device=codes.device)
    lanes = torch.empty((W, s), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.kmc_splitter_scan_1d(
            codes.device.index, codes.data_ptr(), codes.numel(),
            sig.data_ptr(), lanes.data_ptr(), s, k, sig_len,
            int(both_strands), stream)
    _build.check(lib, err, "1-D splitter scan launch")
    extract_splitter_scan_1d.launches += 1
    return sig, list(lanes.unbind(0))


extract_splitter_scan_1d.launches = 0
