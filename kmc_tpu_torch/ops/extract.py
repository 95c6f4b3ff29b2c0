"""Plain PyTorch versions of the splitter scan and the packed-feed decodes.

The port's counterpart of kmc_tpu/ops/extract.py.  The input is a flat code
stream where any value >= 4 (N bases, read separators, padding) breaks
k-mers.  For every candidate start position the scan yields

  * the signature: over the window's k-m+1 m-mers, the minimum canonical
    norm (4^m where no m-mer is allowed; KMC's mmer.h:81-91 rule), or
    INVALID_SIG if any code of the window is >= 4;
  * the canonical k-mer as W = ceil(k/16) lanes, most significant first and
    right-aligned (the smaller of the forward and reverse-complement
    strands), or all-ones lanes for an invalid window.

Torch's uint32 lacks shifts, compares and adds, so the lane math here runs
on int64 tensors that hold u32 values; results leave as int32 bit views
(u32_to_i32).  These functions are the CPU path of the splitter-scan
kernel (ops/extract_kernel.py) and the reference it is held against on the
card.
"""
from __future__ import annotations

import numpy as np
import torch

INVALID_SIG = 0xFFFFFFFF
U32_MASK = 0xFFFFFFFF


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit view -> int64 tensor holding the u32 value."""
    return x.to(torch.int64) & U32_MASK


def _pack_streams(c4: torch.Tensor, n: int):
    """p[i]: 16 bases at i, big-endian; q[i]: their reverse-complement
    packing (mirrors extract._pack_streams)."""
    p = torch.zeros(n, dtype=torch.int64, device=c4.device)
    q = torch.zeros(n, dtype=torch.int64, device=c4.device)
    for j in range(16):
        cj = c4[j : j + n]
        p |= cj << (2 * (15 - j))
        q |= (3 - cj) << (2 * j)
    return p, q


def _is_allowed(m: torch.Tensor, sig_len: int) -> torch.Tensor:
    """CMmer::is_allowed (mmer.h:40-63) as tensor bit math (mirrors
    extract._is_allowed)."""
    lo = m & 0x3F
    ok = ~((lo == 0x3F) | (lo == 0x3B) | ((m & 0x3C) == 0x3C))
    x = m
    for _ in range(sig_len - 3):
        ok &= (x & 0xF) != 0
        x = x >> 2
    ok &= (x != 0) & (x != 0x04) & ((x & 0xF) != 0)
    return ok


def _norms(p: torch.Tensor, q: torch.Tensor, sig_len: int, n: int) -> torch.Tensor:
    """Canonical norm of the m-mer at every position (mirrors
    extract._norms)."""
    special = 1 << (2 * sig_len)
    fwd = p[:n] >> (2 * (16 - sig_len))
    rev = q[:n] & ((1 << (2 * sig_len)) - 1)
    fv = torch.where(_is_allowed(fwd, sig_len), fwd, special)
    rv = torch.where(_is_allowed(rev, sig_len), rev, special)
    return torch.minimum(fv, rv)


def _sliding_min(x: torch.Tensor, w: int, out_len: int) -> torch.Tensor:
    """out[i] = min(x[i:i+w]) by log-step doubling (mirrors
    extract._sliding_min)."""
    acc = x
    n = x.shape[0]
    covered = 1
    while covered < w:
        step = min(covered, w - covered)
        acc = torch.minimum(acc[: n - step], acc[step:])
        n -= step
        covered += step
    return acc[:out_len]


def position_sigs(c4: torch.Tensor, bad: torch.Tensor, *, s: int, k: int,
                  sig_len: int):
    """Per start position (valid, sig) plus the packed streams (p, q);
    sig is INVALID_SIG where the window holds a non-base (mirrors
    extract.position_sigs).  c4: int64 codes in 0..3; bad: 0/1."""
    L = c4.shape[0]
    p, q = _pack_streams(c4, L - 15)
    cs = torch.cat([bad.new_zeros(1), torch.cumsum(bad.to(torch.int64), 0)])
    valid = (cs[k : k + s] - cs[0:s]) == 0
    norms = _norms(p, q, sig_len, s + k - sig_len)
    sig = _sliding_min(norms, k - sig_len + 1, s)
    sig = torch.where(valid, sig, INVALID_SIG)
    return valid, sig, p, q


def _kmer_words(p, q, k: int, s: int, both_strands: bool):
    """Canonical k-mer at every start as W int64 lanes holding u32 values
    (mirrors extract._kmer_words; see its docstring for the offsets)."""
    W = (k + 15) // 16
    r0 = k - 16 * (W - 1)
    w0 = p[0:s]
    if r0 < 16:
        w0 = w0 >> (2 * (16 - r0))
    fwd = [w0] + [p[r0 + 16 * (t - 1) : r0 + 16 * (t - 1) + s]
                  for t in range(1, W)]
    if not both_strands:
        return fwd
    m0 = (1 << (2 * r0)) - 1
    off0 = k - r0
    rc = [q[off0 : off0 + s] & m0] + [q[k - r0 - 16 * t : k - r0 - 16 * t + s]
                                      for t in range(1, W)]
    use_rc = torch.zeros(s, dtype=torch.bool, device=p.device)
    decided = torch.zeros(s, dtype=torch.bool, device=p.device)
    for t in range(W):
        use_rc |= ~decided & (rc[t] < fwd[t])
        decided |= rc[t] != fwd[t]
    return [torch.where(use_rc, rc[t], fwd[t]) for t in range(W)]


def codes_to_c4_bad(codes: torch.Tensor):
    """u8 code stream -> (c4 int64 in 0..3, bad 0/1 int64), as
    extract.stage1_batch derives them."""
    c = codes.to(torch.int64)
    return torch.clamp(c, max=3), (c >= 4).to(torch.int64)


def _unpack_device(packed: torch.Tensor, mask: torch.Tensor):
    """Invert io/native.py::pack_codes_fused: packed u8[L/4], mask u8[L/8]
    (MSB-first) -> (c4 int64[L], bad int64[L]) (mirrors
    extract._unpack_device)."""
    p = packed.to(torch.int64)
    c4 = torch.stack([(p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3, p & 3],
                     dim=1).reshape(-1)
    m = mask.to(torch.int64)
    bits = torch.stack([(m >> (7 - j)) & 1 for j in range(8)],
                       dim=1).reshape(-1)
    return c4, 1 - bits


_NORM_TABLES: dict = {}


def _norm_table_on(sig_len: int, device) -> torch.Tensor:
    """signatures.norm_table(sig_len) as an int64 tensor on device (the
    canonical allowed norm of each of the 4^m m-mers, 4^m where neither
    strand is allowed), kept per (sig_len, device)."""
    key = (sig_len, str(device))
    if key not in _NORM_TABLES:
        from ..signatures import norm_table

        _NORM_TABLES[key] = torch.from_numpy(
            norm_table(sig_len).astype(np.int64)).to(device)
    return _NORM_TABLES[key]


def sig_of_word_cols(wr, *, k: int, sig_len: int) -> torch.Tensor:
    """Signature of each canonical k-mer row, recomputed from its W lane
    columns (int64 tensors of u32 values, most significant first,
    right-aligned), as kmc_tpu's extract.sig_of_word_cols: the minimum over
    the k-mer's m-mers of the canonical norm (4^m where none is allowed),
    each m-mer's norm one lookup in signatures.norm_table.  It equals the
    splitter's per-position signature, since a k-mer and its reverse
    complement hold the same set of canonical m-mer norms."""
    W = len(wr)
    mask_m = (1 << (2 * sig_len)) - 1
    table = _norm_table_on(sig_len, wr[0].device)
    best = torch.full_like(wr[0], 1 << (2 * sig_len))
    for j in range(k - sig_len + 1):
        shift = 2 * (k - sig_len - j)  # m-mer j = (kmer >> shift) & mask
        lane = W - 1 - shift // 32
        off = shift % 32
        v = wr[lane] >> off
        if off + 2 * sig_len > 32 and lane > 0:
            v = v | (wr[lane - 1] << (32 - off))
        best = torch.minimum(best, table[v & mask_m])
    return best
