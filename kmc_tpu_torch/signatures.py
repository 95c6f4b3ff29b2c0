"""Signatures and the greedy signature -> bin map (a NumPy copy of
kmc_tpu/signatures.py).

KMC gives every k-mer a signature, the smallest allowed canonical m-mer in
it, and partitions the signatures into bins.  The host-bucket route needs
the signature -> bin map before stage 1, so it samples a signature
histogram first (stage 0) and builds the map here with KMC's greedy
balance (s_mapper.h:141-235); the allowed-signature rule is mmer.h:40-63.
Signatures whose canonical norm is S = 4^m (no allowed m-mer) go to the
special bin, the last one.  The per-m-mer norm table and the per-position
signatures of a code stream (norm_table, kmer_signatures_numpy) serve the
database API's binned lookups.
"""
from __future__ import annotations

import numpy as np

from .defs import MAX_SL, MIN_SL

_norm_cache: dict[int, np.ndarray] = {}


def is_allowed(mmer: np.ndarray, sig_len: int) -> np.ndarray:
    """Vectorized allowed-signature predicate (mmer.h:40-63).

    Disallowed: TTT/TGT/TG* suffix patterns, 'AA' anywhere inside,
    AAA/ACA/*AA prefixes.
    """
    m = np.asarray(mmer, dtype=np.uint32)
    ok = ~(((m & 0x3F) == 0x3F) | ((m & 0x3F) == 0x3B) | ((m & 0x3C) == 0x3C))
    x = m
    for _ in range(sig_len - 3):
        ok &= (x & 0xF) != 0
        x = x >> np.uint32(2)
    ok &= (x != 0) & (x != 0x04) & ((x & 0xF) != 0)
    return ok


def rev_comp_mmer(mmer: np.ndarray, sig_len: int) -> np.ndarray:
    """Reverse complement of a 2-bit packed m-mer (mmer.h:68-79)."""
    m = np.asarray(mmer, dtype=np.uint32)
    rev = np.zeros_like(m)
    shift = 2 * (sig_len - 1)
    for _ in range(sig_len):
        rev += (np.uint32(3) - (m & np.uint32(3))) << np.uint32(shift)
        m = m >> np.uint32(2)
        shift -= 2
    return rev


def norm_table(sig_len: int) -> np.ndarray:
    """norm[x] for all 4^sig_len m-mers, as uint32 (mmer.h:81-91).

    norm[x] = min over both strands of (value if allowed else special),
    special = 4^sig_len.
    """
    if sig_len in _norm_cache:
        return _norm_cache[sig_len]
    if not (MIN_SL <= sig_len <= MAX_SL):
        raise ValueError(f"signature length must be in [{MIN_SL},{MAX_SL}]")
    special = np.uint32(1 << (2 * sig_len))
    vals = np.arange(1 << (2 * sig_len), dtype=np.uint32)
    rev = rev_comp_mmer(vals, sig_len)
    fwd_val = np.where(is_allowed(vals, sig_len), vals, special)
    rev_val = np.where(is_allowed(rev, sig_len), rev, special)
    table = np.minimum(fwd_val, rev_val)
    _norm_cache[sig_len] = table
    return table


def special_signature(sig_len: int) -> int:
    return 1 << (2 * sig_len)


def map_size(sig_len: int) -> int:
    return (1 << (2 * sig_len)) + 1


def build_signature_map(stats: np.ndarray, sig_len: int, n_bins: int) -> np.ndarray:
    """Greedy balanced partition of signatures into bins (s_mapper.h:141-235).

    `stats` is the per-signature k-mer occurrence histogram from stage 0
    (length 4^sig_len or 4^sig_len+1; the special slot is ignored).  Returns
    an int32 array of length 4^sig_len+1 mapping signature -> bin id;
    disallowed signatures keep -1 except the special signature which gets the
    last used bin id.

    Same scheme AND fill semantics as KMC (s_mapper.h:164-226):
    signatures sorted by occurrence count descending (+1000 smoothing per
    allowed signature, s_mapper.h:162), heavy ones (above the running
    mean) get singleton bins; the rest are grouped by a greedy SKIP-SCAN
    against a 1.1x-running-mean cap — an entry that does not fit is
    skipped and the scan continues with the smaller entries after it
    (revisiting the skipped one for a later bin), stopping early once
    even the smallest remaining entry cannot fit.  The only residual
    difference from KMC's binary is the tie order of its
    UNSTABLE std::sort (Comp compares counts only, s_mapper.h:40-43);
    ours is a stable descending sort, which can permute equal-count
    signatures across bins — affecting only the on-disk bin layout,
    never the k-mer/count content or dump output.
    """
    msize = map_size(sig_len)
    sig_map = np.full(msize, -1, dtype=np.int32)

    allowed = is_allowed(np.arange(msize - 1, dtype=np.uint32), sig_len)
    stats = np.asarray(stats, dtype=np.uint64)

    # order all signatures by occurrence count, descending (stable tie-break)
    counts = np.zeros(msize - 1, dtype=np.uint64)
    counts[: min(len(stats), msize - 1)] = stats[: msize - 1]
    order = np.argsort(-counts.astype(np.int64), kind="stable")
    order = order[allowed[order]]

    # +1000 smoothing per allowed signature (s_mapper.h:162)
    weights = counts[order].astype(np.float64) + 1000.0

    total = float(weights.sum())
    bin_no = 0
    max_bins = n_bins - 1  # one bin reserved for the special signature
    mean = total / n_bins
    n_entries = len(order)
    taken = np.zeros(n_entries, dtype=bool)
    alive = n_entries
    P = np.arange(n_entries)
    while alive > max_bins - bin_no:
        if max_bins - bin_no <= 1:
            # KMC's n==0 continuation divides by zero -> mean =
            # inf -> the group cap is infinite and the next group bin
            # absorbs every remaining entry; same outcome, written out
            sig_map[order[P]] = bin_no
            taken[P] = True
            alive = 0
            P = P[:0]
            bin_no += 1
            break
        w0 = weights[P[0]]
        if w0 > mean:
            sig_map[order[P[0]]] = bin_no
            taken[P[0]] = True
            total -= w0
            P = P[1:]
            alive -= 1
        else:
            # greedy skip-scan group fill (s_mapper.h:200-217): take
            # entries in descending order while they fit under the cap,
            # skipping ones that do not, early-exiting when even the
            # smallest remaining cannot fit.  Runs of consecutive fits
            # resolve with one searchsorted over the alive cumsum.
            cap = 1.1 * mean
            W = weights[P]
            cs = np.concatenate([[0.0], np.cumsum(W)])
            tmp = 0.0
            j = 0
            sel: list[tuple[int, int]] = []
            m = len(P)
            while j < m:
                if tmp + W[m - 1] >= cap:
                    break  # smallest alive cannot fit: nothing more will
                end = int(np.searchsorted(cs, cs[j] + (cap - tmp),
                                          side="left")) - 1
                if end > j:
                    sel.append((j, end))
                    tmp += float(cs[end] - cs[j])
                    j = end
                j += 1  # entry j does not fit: skip, revisit later
            if sel:
                idx = np.concatenate([P[a:b] for a, b in sel])
            else:
                # cap smaller than every entry: KMC's loop would
                # make an EMPTY bin forever; it cannot reach this state
                # (w0 <= mean < cap), keep the front entry defensively
                idx = P[:1]
            sig_map[order[idx]] = bin_no
            taken[idx] = True
            total -= float(weights[idx].sum())
            alive -= len(idx)
            P = P[~taken[P]]
        bin_no += 1
        mean = total / (max_bins - bin_no)
    # remaining signatures: singleton bins (s_mapper.h:219-226)
    for i in P:
        sig_map[order[i]] = bin_no
        bin_no += 1
    sig_map[special_signature(sig_len)] = bin_no
    return sig_map


def n_used_bins(sig_map: np.ndarray) -> int:
    """Number of bins actually addressed by the map (max bin id + 1)."""
    return int(sig_map.max()) + 1


def sig_of_lanes_numpy(lanes: np.ndarray, k: int, sig_len: int) -> np.ndarray:
    """Signature of each k-mer row from its packed lanes (host mirror of
    the device's signature of word columns).

    lanes: uint32[n, W] MSW-first right-aligned 2-bit lanes.  Exact for any
    strand: the m-mer norm is strand-invariant (mmer.h:81-91), so the
    minimum over the stored k-mer's own m-mers equals the splitter's
    per-window signature."""
    n, W = lanes.shape
    table = norm_table(sig_len)
    special = np.uint32(special_signature(sig_len))
    mask_m = np.uint32((1 << (2 * sig_len)) - 1)
    best = np.full(n, special, np.uint32)
    for j in range(k - sig_len + 1):
        shift = 2 * (k - sig_len - j)
        lane = W - 1 - (shift // 32)
        off = shift % 32
        v = lanes[:, lane] >> np.uint32(off)
        if off + 2 * sig_len > 32 and lane > 0:
            v = v | (lanes[:, lane - 1] << np.uint32(32 - off))
        best = np.minimum(best, table[v & mask_m])
    return best


def kmer_signatures_numpy(codes: np.ndarray, k: int, sig_len: int) -> np.ndarray:
    """Per-position signature (min window norm) over a code stream; oracle/test
    helper — the device path computes the same thing in the splitter scan.

    codes: uint8 array, values 0..3 valid, >=4 invalid.  Returns, for every
    start position i (len(codes)-k+1 entries), min norm over the k-mer's
    m-mer window; positions whose k-mer window contains an invalid code get
    special+1 (an out-of-band marker).
    """
    c = codes.astype(np.uint32)
    n = len(c)
    if n < k:
        return np.zeros(0, dtype=np.uint32)
    table = norm_table(sig_len)
    special = np.uint32(special_signature(sig_len))
    # m-mer values at each position
    n_mm = n - sig_len + 1
    mm = np.zeros(n_mm, dtype=np.uint32)
    for j in range(sig_len):
        mm = (mm << np.uint32(2)) | c[j : j + n_mm].clip(max=3)
    norms = table[mm]
    # invalidate m-mers containing invalid codes
    bad = c >= 4
    cs = np.concatenate([[0], np.cumsum(bad)])
    mm_bad = (cs[sig_len:] - cs[:-sig_len]) > 0
    norms = np.where(mm_bad, special + np.uint32(1), norms)
    # sliding window min over k - sig_len + 1 norms (log-step doubling:
    # acc[j] covers [j, j+covered) and is extended by the shifted acc itself)
    w = k - sig_len + 1
    acc = norms
    covered = 1
    while covered < w:
        step = min(covered, w - covered)
        acc = np.minimum(acc[: len(acc) - step], acc[step:])
        covered += step
    out = acc[: n - k + 1]
    # mark kmers containing invalid codes
    km_bad = (cs[k:] - cs[: n - k + 1]) > 0
    out = np.where(km_bad, special + np.uint32(1), out)
    return out
