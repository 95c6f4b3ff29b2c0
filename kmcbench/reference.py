"""The plain reference: the generated reads counted again in plain
PyTorch, and the control that breaks one of the configuration's
guarantees.

It takes the reads from reads.py (the same seed, the same device), never
from the program, and imports nothing of kmc_tpu_torch.  A k-mer is a
2-bit big-endian int64 (A=0 C=1 G=2 T=3), k <= 31; canonical is the
smaller of the k-mer and its reverse complement.  A signature follows
KMC's rule (mmer.h): the smallest allowed canonical m-mer of the k-mer,
4^m when it has none.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .reads import Sample, read_blocks


@dataclass
class Counted:
    keys: torch.Tensor    # int64, sorted, distinct
    counts: torch.Tensor  # int64

    def stats(self, cutoff_min: int, cutoff_max: int) -> dict:
        """Stage 2's counts: occurrences, distinct k-mers, and those below
        and above the cutoffs."""
        return dict(n_total=int(self.counts.sum()),
                    n_unique=int(self.keys.numel()),
                    n_below=int((self.counts < cutoff_min).sum()),
                    n_above=int((self.counts > cutoff_max).sum()))

    def kept(self, cutoff_min: int, cutoff_max: int, counter_max: int):
        """(keys, stored counters) of the database: the k-mers inside the
        cutoffs, their counts clamped to counter_max."""
        keep = (self.counts >= cutoff_min) & (self.counts <= cutoff_max)
        return self.keys[keep], self.counts[keep].clamp(max=counter_max)


def canonical_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64[n * (L - k + 1)]: the canonical k-mer at every position of
    each read of codes (uint8[n, L], 0..3)."""
    if not 1 <= k <= 31:
        raise ValueError("the reference holds k-mers of at most 31 bases")
    c = codes.long()
    n_pos = c.shape[1] - k + 1
    fwd = torch.zeros((c.shape[0], n_pos), dtype=torch.int64,
                      device=c.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | c[:, j:j + n_pos]
        rev = (rev << 2) | (3 - c[:, k - 1 - j:k - 1 - j + n_pos])
    return torch.minimum(fwd, rev).reshape(-1)


def count(sample: Sample, seed: int, k: int, device) -> Counted:
    """Count every canonical k-mer of the sample's reads."""
    keys = torch.empty(sample.n_kmers(k), dtype=torch.int64, device=device)
    at = 0
    for _, codes in read_blocks(sample, seed, device):
        block = canonical_kmers(codes, k)
        keys[at:at + block.numel()] = block
        at += block.numel()
        del codes, block
    keys, _ = torch.sort(keys)
    keys, counts = torch.unique_consecutive(keys, return_counts=True)
    return Counted(keys, counts.long())


def control_count(exact: Counted) -> Counted:
    """The control: the same count with k-mers keyed by a 32-bit hash, as
    an approximate counter keys them (it breaks the guarantee of exact
    counts).  k-mers whose hashes collide share one counter, stored under
    the smallest of them."""
    h = ((exact.keys * -7046029254386353131) >> 32) & 0xFFFFFFFF
    h, order = torch.sort(h, stable=True)  # keys stay ascending in a group
    keys, counts = exact.keys[order], exact.counts[order]
    first = torch.ones_like(h, dtype=torch.bool)
    first[1:] = h[1:] != h[:-1]
    starts = torch.nonzero(first).squeeze(1)
    sums = torch.zeros(starts.numel(), dtype=torch.int64, device=h.device)
    sums.index_add_(0, torch.cumsum(first.long(), 0) - 1, counts)
    reps, order = torch.sort(keys[starts])
    return Counted(reps, sums[order])


def _allowed(x: torch.Tensor, m: int) -> torch.Tensor:
    """KMC's allowed-signature rule (mmer.h, CMmer::is_allowed), on the
    2-bit value (the last base in the low bits): no TT* or TGT at the
    end, no AA after the first base, no ACA at the start."""
    ok = ~(((x & 0x3F) == 0x3F) | ((x & 0x3F) == 0x3B)
           | ((x & 0x3C) == 0x3C))
    for _ in range(m - 3):
        ok &= (x & 0xF) != 0
        x = x >> 2
    return ok & (x != 0) & (x != 0x04) & ((x & 0xF) != 0)


def norm_table(m: int, device) -> torch.Tensor:
    """int64[4^m]: each m-mer's signature value, the smaller allowed one
    of it and its reverse complement, 4^m when neither is allowed."""
    special = 1 << (2 * m)
    x = torch.arange(special, dtype=torch.int64, device=device)
    rc = torch.zeros_like(x)
    y = x
    for _ in range(m):
        rc = (rc << 2) | (3 - (y & 3))
        y = y >> 2
    fwd = torch.where(_allowed(x, m), x, special)
    rev = torch.where(_allowed(rc, m), rc, special)
    return torch.minimum(fwd, rev)


def signatures(kmers: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """int64: each k-mer's signature (strand-free: the minimum of its
    m-mers' norms, so a k-mer and its reverse complement agree)."""
    table = norm_table(m, kmers.device)
    mask = (1 << (2 * m)) - 1
    best = torch.full_like(kmers, 1 << (2 * m))
    for j in range(k - m + 1):
        best = torch.minimum(best, table[(kmers >> (2 * (k - m - j)))
                                         & mask])
    return best
