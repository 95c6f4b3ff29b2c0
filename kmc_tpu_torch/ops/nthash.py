"""The ntCard k-mer abundance-histogram estimator behind -e / --opt-out-size.

The port's counterpart of kmc_tpu/ops/nthash.py (KMC's CntHashEstimator,
ntHashWrapper.h:97-456; Mohamadi et al., Bioinformatics 2017): a canonical
ntHash of every k-mer window, two hash-prefix-gated sampled counter arrays
of 2^r slots, and the ntCard recurrence that solves the abundance histogram
from their collision statistics.

ntHash's split rotation srol is linear over XOR, so the hash of the window
at position i is a closed-form XOR of per-position table rows,

    fh[i] = XOR_j srol^(k-1-j)(seed[c[i+j]])
    rh[i] = XOR_j srol^j(seed[3 - c[i+j]])

that is k gathers from 4-entry tables with no sequential dependence.  The
hashes and the counter updates run on the estimator's device in torch int64
ops (u64 bit patterns in int64: the unsigned minimum flips the sign bit,
the unsigned shift masks); the same ops on CPU tensors are the plain
version.  The recurrence is kmc_tpu's float64 loop, on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# public ntHash seed constants
SEED = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
        0x295549F54BE24456)
_U64 = (1 << 64) - 1
_SIGN = -(1 << 63)  # the sign bit as an int64


def srol(v: int) -> int:
    """ntHash2 split rotate left of a u64 (a Python int): 64-bit rol1, then
    swap bits 0 and 33."""
    r = ((v << 1) | (v >> 63)) & _U64
    swap = (r ^ (r >> 33)) & 1
    return r ^ (swap * ((1 << 33) | 1))


def _i64(v: int) -> int:
    """A u64 value as the int64 with the same bits."""
    return v - (1 << 64) if v >> 63 else v


def _tables(k: int, device):
    """(tab_f, tab_r) int64[k, 4]: row j of tab_f is srol^(k-1-j) of the
    seeds, row j of tab_r srol^j of the reversed seeds (seed[3 - c])."""
    acc_f, acc_r = list(SEED), list(SEED[::-1])
    tab_f = [None] * k
    tab_r = [None] * k
    for j in range(k):
        tab_f[k - 1 - j] = [_i64(v) for v in acc_f]
        tab_r[j] = [_i64(v) for v in acc_r]
        acc_f = [srol(v) for v in acc_f]
        acc_r = [srol(v) for v in acc_r]
    return (torch.tensor(tab_f, dtype=torch.int64, device=device),
            torch.tensor(tab_r, dtype=torch.int64, device=device))


def _lshr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def nthash_canonical(codes: torch.Tensor, k: int):
    """Canonical ntHash of every k-mer window of a u8 code stream (codes
    >= 4 break windows), on the tensor's device.  Returns (hashes int64 of
    u64 bit patterns, valid bool), each of length len(codes) - k + 1;
    equal to kmc_tpu's nthash_canonical bit for bit."""
    n = codes.shape[0] - k + 1
    dev = codes.device
    if n <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    c = torch.clamp(codes.to(torch.int64), max=3)
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum((codes >= 4).to(torch.int64), 0)])
    valid = (bad[k:] - bad[:-k]) == 0
    tab_f, tab_r = _tables(k, dev)
    fh = torch.zeros(n, dtype=torch.int64, device=dev)
    rh = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(k):
        cj = c[j:j + n]
        fh ^= tab_f[j][cj]
        rh ^= tab_r[j][cj]
    # unsigned min: flipping the sign bit maps u64 order onto int64 order
    h = torch.minimum(fh ^ _SIGN, rh ^ _SIGN) ^ _SIGN
    return h, valid


class NtCardEstimator:
    """Streaming abundance-histogram estimator (KMC's ctor defaults s = 11,
    r = 27; kmc.h:1118-1121 picks s by input size).  The two counters are
    int32 tensors of 2^r slots on `device`; their bits are kmc_tpu's u32
    counters, which wrap mod 2^32."""

    max_occ_value = 65536

    def __init__(self, k: int, s: int = 11, r: int = 27, device="cuda"):
        self.k = k
        self.s = s
        self.r = r
        self.device = resolve_device(device)
        self.counters = [torch.zeros(1 << r, dtype=torch.int32,
                                     device=self.device) for _ in range(2)]
        self._accept1 = (1 << (s - 1)) - 1

    def process_codes(self, codes):
        """Feed a code chunk (uint8 numpy or tensor; >= 4 breaks k-mer
        windows).  Each chunk is hashed alone, as kmc_tpu hashes it."""
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.ascontiguousarray(codes))
        h, valid = nthash_canonical(codes.to(self.device), self.k)
        h = h[valid]
        if h.numel() == 0:
            return
        pref = _lshr(h, 63 - self.s)
        slot = h & ((1 << self.r) - 1)
        for sel, ctr in ((pref == 1, self.counters[0]),
                         ((pref >> 1) == self._accept1, self.counters[1])):
            idx = slot[sel]
            ctr.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))

    def _occurrence_hist(self, ctr: torch.Tensor, max_occ: int) -> np.ndarray:
        """bincount(min(counter as u32, max_occ_value))[: max_occ + 1]."""
        c = torch.where(ctr < 0, self.max_occ_value,
                        torch.clamp(ctr, max=self.max_occ_value))
        return torch.bincount(c, minlength=max_occ + 1)[: max_occ + 1] \
            .cpu().numpy()

    def estimate_histogram(self) -> list[int]:
        """ntCard recurrence (ntHashWrapper.h:436-455), kmc_tpu's float64
        loop on the host; the counters' statistics come from the device."""
        if any(bool((c < 0).any()) for c in self.counters):
            max_occ = self.max_occ_value  # a counter at or past 2^31 as u32
        else:
            max_occ = max(int(c.max()) for c in self.counters)
        max_occ = min(max(max_occ, 2), self.max_occ_value)
        r = self.r
        h0 = self._occurrence_hist(self.counters[0], max_occ)
        h1 = self._occurrence_hist(self.counters[1], max_occ)
        mean = (h0 + h1) / 2.0
        c_log2 = np.log(2.0)
        if mean[0] <= 0:
            return [0] * (max_occ + 1)
        log_m0 = np.log(mean[0])
        f0_mean = float(np.int64((r * c_log2 - log_m0) * (1 << (self.s + r))))
        denom = mean[0] * (log_m0 - r * c_log2)
        if denom == 0:
            return [0] * (max_occ + 1)
        hist = np.zeros(max_occ + 1)
        hist[1] = -1.0 * mean[1] / denom
        for i in range(2, max_occ + 1):
            ssum = 0.0
            for j in range(1, i):
                ssum += j * mean[i - j] * hist[j]
            hist[i] = -1.0 * mean[i] / denom - ssum / (i * mean[0])
        out = [0] * (max_occ + 1)
        for i in range(1, max_occ + 1):
            out[i] = abs(int(hist[i] * f0_mean))
        return out
