"""The fused ingest's plain version against kmc_tpu's, and the kernel's
arithmetic emulated in numpy.

ingest_plain (what a CPU store runs, and what the CUDA kernel of
csrc/extract.cu is held against on the card) must leave exactly the key
columns, n_used, occurrence and super-k-mer totals and prev_sig that
kmc_tpu.ops.store._ingest_prefix_bounds / _ingest_prefix_fused leave, batch
after batch.  The kernel's bit tricks (16-base windows by funnel shifts of
packed words, the reverse complement by bit reversal, the sentinel bitmap,
branch-free is_allowed, the van Herk sliding minimum, the delta list's
per-tile slots) are emulated here in numpy and held against the port's
plain functions, since the kernel itself only runs on a card (its tests
are in tests/test_torch_kernels.py).  Integers throughout: no tolerance."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmc_tpu.io.native import (pack_codes, pack_codes_boundaries,
                               pack_codes_fused)
from kmc_tpu.ops.store import _ingest_prefix_bounds, _ingest_prefix_fused
from kmc_tpu_torch.io.readers import batch_len
from kmc_tpu_torch.ops.extract import (_is_allowed, _pack_streams,
                                       _sliding_min, codes_to_c4_bad,
                                       position_sigs)
from kmc_tpu_torch.ops.extract_kernel import splitter_scan_plain
from kmc_tpu_torch.ops.ingest_kernel import ingest, ingest_plain
from kmc_tpu_torch.ops.store import prefix_bin_bits

M = 9
S = 1000  # not a multiple of the kernel's 1024-position tile
N0 = 37   # rows already in the store: a non-aligned n_used
U32 = 0xFFFFFFFF


def _reads(k, seed, tail, s=S):
    """Read-like codes (reads of max(150, 2k) bases, separators, Ns)
    ending in `tail` padding sentinels."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, batch_len(s, k)).astype(np.uint8)
    read = max(150, 2 * k)
    codes[rng.integers(0, read):: read + 1] = 4
    codes[rng.random(len(codes)) < 0.001] = 4
    if tail:
        codes[-tail:] = 4
    return codes


def _dense(k, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, batch_len(S, k)).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.25] = 4
    return codes


def _acc_pair(v):
    return np.array([v & U32, v >> 32], np.uint32)


def _acc_int(a):
    a = np.asarray(a).astype(np.uint64)
    return int(a[0]) + (int(a[1]) << 32)


@pytest.mark.parametrize("k", [14, 27, 32, 33, 55, 256])
@pytest.mark.parametrize("both", [True, False])
def test_ingest_plain_matches_kmc_tpu(k, both):
    """Two batches in a row (boundary-delta with tail_start inside the
    batch, then a sentinel-dense packed+mask one) into a store already
    holding N0 rows, with accumulators near 2^32 and a counts column."""
    prefix_bits, fuse = prefix_bin_bits(k, M, 512)
    W = (k + 15) // 16
    n_cols = W if fuse else W + 1
    cap = N0 + 2 * S + 16
    rng = np.random.default_rng(k)
    cols = [np.full(cap, U32, np.uint32) for _ in range(n_cols)]
    for c in cols:
        c[:N0] = rng.integers(0, 2**32, N0, dtype=np.uint32)
    occ0, skm0 = 2**32 - 50, 2**32 - 3
    prev0 = 12345

    j_cols = tuple(jnp.asarray(c) for c in cols)
    j_state = [jnp.int32(N0), jnp.asarray(_acc_pair(occ0)),
               jnp.asarray(_acc_pair(skm0)),
               jnp.asarray(np.array([prev0], np.uint32))]
    t_cols = [torch.from_numpy(c.view(np.int32).copy()) for c in cols]
    counts = torch.zeros(cap, dtype=torch.int32)
    counts[:N0] = 7
    occ = torch.tensor(occ0, dtype=torch.int64)
    skm = torch.tensor(skm0, dtype=torch.int64)
    prev = torch.tensor([prev0], dtype=torch.int32)
    n_used = N0
    statics = dict(s=S, k=k, sig_len=M, both_strands=both,
                   map_mode="prefix", prefix_bits=prefix_bits, fuse=fuse,
                   n_dead_bin=(1 << prefix_bits) + 1, extract_mode="xla")

    for codes, kind in ((_reads(k, k + 1, tail=29), "b"),
                        (_dense(k, k + 2), "m")):
        if kind == "b":
            buf, ts = pack_codes_boundaries(codes)
            assert buf is not None and ts == len(codes) - 29
            out = _ingest_prefix_bounds(jnp.asarray(buf), jnp.int32(ts),
                                        j_cols, *j_state, **statics)
        else:
            buf, ts = pack_codes_fused(codes), None
            assert pack_codes_boundaries(codes)[0] is None  # too dense
            out = _ingest_prefix_fused(jnp.asarray(buf), j_cols, *j_state,
                                       **statics)
        j_cols, j_state = out[0], list(out[1:])
        prev = ingest_plain(torch.from_numpy(buf), ts, t_cols, counts,
                            n_used, occ, skm, prev, s=S, k=k, sig_len=M,
                            both_strands=both, prefix_bits=prefix_bits,
                            fuse=fuse)
        n_used += S
        assert int(j_state[0]) == n_used
        for got, want in zip(t_cols, j_cols):
            assert np.array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
        assert int(occ) == _acc_int(j_state[1])
        assert int(skm) == _acc_int(j_state[2])
        assert prev.numpy().view(np.uint32)[0] == np.asarray(j_state[3])[0]
        assert (counts[N0:n_used] == 1).all() and (counts[:N0] == 7).all()
    assert int(occ) > occ0 and int(skm) > skm0  # both carried past 2^32


def test_ingest_wrapper_takes_plain_on_cpu_and_checks_input():
    k = 27
    prefix_bits, fuse = prefix_bin_bits(k, M, 512)
    codes = _reads(k, 3, tail=0)
    buf, ts = pack_codes_boundaries(codes)
    cols = [torch.full((N0 + S,), -1, dtype=torch.int32) for _ in range(2)]
    state = (torch.zeros((), dtype=torch.int64),
             torch.zeros((), dtype=torch.int64),
             torch.full((1,), -1, dtype=torch.int32))
    kw = dict(s=S, k=k, sig_len=M, both_strands=True,
              prefix_bits=prefix_bits, fuse=fuse)
    before = ingest.launches
    prev = ingest(torch.from_numpy(buf), ts, cols, None, N0, *state, **kw)
    assert ingest.launches == before  # the plain version: no launch
    ref = [torch.full((N0 + S,), -1, dtype=torch.int32) for _ in range(2)]
    ref_state = tuple(t.clone() for t in (state[0] * 0, state[1] * 0))
    ref_prev = ingest_plain(torch.from_numpy(buf), ts, ref, None, N0,
                            *ref_state, torch.full((1,), -1, dtype=torch.int32),
                            **kw)
    assert all(torch.equal(a, b) for a, b in zip(cols, ref))
    assert torch.equal(prev, ref_prev)
    bad_calls = [
        dict(buf=torch.from_numpy(buf).to(torch.int32)),   # dtype
        dict(cols=cols[:1]),                                # layout
        dict(n_used=N0 + 1),                                # no room
        dict(buf=torch.from_numpy(buf)[:100]),              # short feed
        dict(s=S + 4),                                      # s % 8
    ]
    for bad in bad_calls:
        args = dict(buf=torch.from_numpy(buf), cols=cols, n_used=N0, s=S)
        args.update(bad)
        with pytest.raises(ValueError):
            ingest(args["buf"], ts, args["cols"], None, args["n_used"],
                   *state, **dict(kw, s=args["s"]))


# -- numpy emulation of csrc/extract.cu's arithmetic --

def _funnel_l(lo, hi, shift):
    """__funnelshift_l(lo, hi, shift): the top 32 bits of (hi:lo) << shift
    (shift < 32)."""
    wide = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((wide << shift.astype(np.uint64)) >> np.uint64(32)).astype(
        np.uint64) & np.uint64(U32)


def _brev(x):
    x = x.astype(np.uint64)
    out = np.zeros_like(x)
    for b in range(32):
        out |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(31 - b)
    return out


def _revcomp16(p):
    r = _brev(~p & np.uint64(U32))
    return ((r >> np.uint64(1)) & np.uint64(0x55555555)) | (
        (r & np.uint64(0x55555555)) << np.uint64(1))


def _pack4(w):
    return ((w & np.uint64(0x03030303)) * np.uint64(0x40100401)
            & np.uint64(U32)) >> np.uint64(24)


def _bad4(w):
    gt = np.zeros_like(w)
    for b in range(4):
        byte = (w >> np.uint64(8 * b)) & np.uint64(0xFF)
        gt |= np.where(byte > 3, np.uint64(0xFF << (8 * b)), np.uint64(0))
    return ((gt & np.uint64(0x01020408)) * np.uint64(0x01010101)
            & np.uint64(U32)) >> np.uint64(24)


def _stage_codes(codes, n_words):
    """The scan entries' staging: 16-byte loads of u8 codes (staged code c
    at position c - 32; codes outside the stream read as sentinels),
    packed in registers into 2-bit words PW and the bitmap BW."""
    st = np.full(32 * n_words, 4, np.uint8)
    st[32: 32 + len(codes)] = codes[: 32 * n_words - 32]
    w = st.view("<u4").astype(np.uint64).reshape(n_words, 8)
    pk = _pack4(w)
    bd = _bad4(w)
    pw = np.stack([pk[:, 0] << 24 | pk[:, 1] << 16 | pk[:, 2] << 8 | pk[:, 3],
                   pk[:, 4] << 24 | pk[:, 5] << 16 | pk[:, 6] << 8
                   | pk[:, 7]], axis=1).reshape(-1)
    bw = np.zeros(n_words, np.uint64)
    for j in range(8):
        bw = (bw << np.uint64(4)) | bd[:, j]
    return pw, bw


def _window16(pw, c):
    return _funnel_l(pw[(c >> 4) + 1], pw[c >> 4], 2 * (c & 15))


def _bits32(bw, c):
    return _funnel_l(bw[(c >> 5) + 1], bw[c >> 5], c & 31)


def _is_allowed_bits(v, m):
    """csrc/extract.cu's branch-free is_allowed."""
    v = v.astype(np.uint64)
    z = ~(v | (v >> np.uint64(1))) & np.uint64(0x55555555)
    pairs = np.uint64(((1 << (2 * (m - 2))) - 1) & 0x55555555)
    lo = v & np.uint64(0x3F)
    bad = ((z & (z >> np.uint64(2)) & pairs) != 0) | (lo == 0x3F) | (
        lo == 0x3B) | ((v & np.uint64(0x3C)) == 0x3C) | (
        (v >> np.uint64(2 * m - 6)) == 4)
    return ~bad


def _van_herk(a, w):
    """out[x] = min(a[x : x + w]) for x < len(a) - w + 1, one run of w
    keys at a time: suffix minima of run q, then prefix minima of run q + 1
    (csrc/extract.cu's sliding minimum)."""
    n_out = len(a) - w + 1
    nseg = (n_out + w - 1) // w
    pad = np.full((nseg + 1) * w, np.iinfo(a.dtype).max, a.dtype)
    pad[: len(a)] = a
    runs = pad[: nseg * w].reshape(nseg, w)
    suffix = np.minimum.accumulate(runs[:, ::-1], axis=1)[:, ::-1]
    nxt = np.full((nseg, w), np.iinfo(a.dtype).max, a.dtype)
    nxt[:, 1:] = pad[w: w + nseg * w].reshape(nseg, w)[:, : w - 1]
    prefix = np.minimum.accumulate(nxt, axis=1)
    return np.minimum(suffix, prefix).reshape(-1)[:n_out]


def _van_herk_chunked(a, w, n_out, chunk=8):
    """The kernel's form of _van_herk: each run of w keys cut into chunks;
    per chunk its suffix and prefix minima and its minimum, per run the
    minima of the later and of the earlier chunks, then per x two reads
    of each."""
    big = np.iinfo(a.dtype).max
    nseg = (n_out - 1 + w) // w  # runs covering x in [0, n_out)
    keys = np.full((nseg + 1) * w, big, a.dtype)
    keys[: len(a)] = a[: len(keys)]
    nsub = (w + chunk - 1) // chunk
    suf = np.empty_like(keys)
    pre = np.empty_like(keys)
    cmin = np.empty((nseg + 1) * nsub, a.dtype)
    for i in range((nseg + 1) * nsub):
        q, u = divmod(i, nsub)
        lo = q * w + u * chunk
        v = keys[lo: lo + min(chunk, w - u * chunk)]
        suf[lo: lo + len(v)] = np.minimum.accumulate(v[::-1])[::-1]
        pre[lo: lo + len(v)] = np.minimum.accumulate(v)
        cmin[i] = v.min()
    cs = np.empty_like(cmin)
    cp = np.empty_like(cmin)
    for q in range(nseg + 1):
        c = cmin[q * nsub: (q + 1) * nsub]
        cp[q * nsub: (q + 1) * nsub] = np.concatenate(
            [[big], np.minimum.accumulate(c)[:-1]])
        cs[q * nsub: (q + 1) * nsub] = np.concatenate(
            [np.minimum.accumulate(c[::-1])[::-1][1:], [big]])
    out = np.empty(n_out, a.dtype)
    for x in range(n_out):
        q, r = divmod(x, w)
        mn = min(suf[x], cs[q * nsub + r // chunk])
        if r:
            e = (q + 1) * w + r - 1
            mn = min(mn, pre[e], cp[(q + 1) * nsub + (r - 1) // chunk])
        out[x] = mn
    return out


@pytest.mark.parametrize("m", range(5, 12))
def test_branch_free_is_allowed_matches_plain(m):
    v = np.arange(1 << (2 * m), dtype=np.int64)
    want = _is_allowed(torch.from_numpy(v), m).numpy()
    assert np.array_equal(_is_allowed_bits(v, m), want)


@pytest.mark.parametrize("w", [1, 2, 5, 19, 48, 247])
def test_van_herk_sliding_min_matches_plain(w):
    rng = np.random.default_rng(w)
    for n in (w, w + 1, 3 * w + 7, 2049 + w):
        a = rng.integers(0, 2**31, n).astype(np.int64)
        a[rng.random(n) < 0.1] = 0
        want = _sliding_min(torch.from_numpy(a), w, n - w + 1).numpy()
        assert np.array_equal(_van_herk(a, w), want)
        assert np.array_equal(_van_herk_chunked(a, w, n - w + 1), want)


def test_packed_windows_and_bitmap_match_plain():
    """P by funnel shifts of staged words (from u8 codes by the multiply
    tricks, and from the packed feed's big-endian bytes), Q by bit
    reversal, and window / m-mer validity from the bitmap."""
    k, s = 27, 4096
    codes = _reads(k, 9, tail=11, s=s)
    codes[5] = 200  # any code >= 4 is a sentinel
    L = len(codes)
    n_words = (L + 32 + 64) // 32
    pw, bw = _stage_codes(codes, n_words)
    # staged words hold a sentinel's low two bits, as the packed feed
    # does (no output reads a sentinel's bits)
    c4, bad = codes_to_c4_bad(torch.from_numpy(codes))
    p, q = (t.numpy().astype(np.uint64) for t in _pack_streams(
        torch.from_numpy((codes & 3).astype(np.int64)), L - 15))
    pos = np.arange(L - 15)
    c = pos + 32
    assert np.array_equal(_window16(pw, c), p)
    assert np.array_equal(_revcomp16(_window16(pw, c)), q)
    # the packed feed staged by big-endian 4-byte loads gives the same words
    packed, mask = pack_codes(codes)
    be = np.zeros(len(packed) + 8 - len(packed) % 4, np.uint8)
    be[: len(packed)] = packed
    # staged word i holds packed bytes 4i - 8 .. 4i - 5 (codes from 16i - 32)
    pw_feed = np.concatenate([np.zeros(2, np.uint64),
                              be.view(">u4").astype(np.uint64)])
    assert np.array_equal(_window16(pw_feed, c), p)
    mask_bits = np.unpackbits(mask)[:L]
    assert np.array_equal(mask_bits == 0, codes >= 4)
    # a window is valid iff its k bits are clear; an m-mer iff its m bits
    valid, _, _, _ = position_sigs(c4, bad, s=s, k=k, sig_len=M)
    win = _bits32(bw, pos[:s] + 32) >> np.uint64(32 - k)
    assert np.array_equal(win == 0, valid.numpy())
    mm = _bits32(bw, pos + 32) >> np.uint64(32 - M)
    direct = np.array([(codes[i:i + M] >= 4).any() for i in pos])
    assert np.array_equal(mm != 0, direct)


@pytest.mark.parametrize("k,both", [(14, True), (27, True), (27, False),
                                    (33, True), (55, True), (129, False),
                                    (256, True)])
def test_kernel_emulation_matches_plain_scan(k, both):
    """The kernel's whole scan (keys, van Herk minimum, lanes from funnel
    windows, the strand choice) emulated over one batch equals
    splitter_scan_plain."""
    s = 2048
    codes = _reads(k, k + 20, tail=5, s=s)
    L = len(codes)
    n_words = (L + 32 + 2 * 256 + 64) // 32
    pw, bw = _stage_codes(codes, n_words)
    w = k - M + 1
    x = np.arange(s + w - 1)  # m-mers of positions 0 .. s + k - m - 1
    c = x + 32
    win = _window16(pw, c)
    special = np.uint64(1 << (2 * M))
    f = win >> np.uint64(32 - 2 * M)
    r = _revcomp16(win) & (special - np.uint64(1))
    fv = np.where(_is_allowed_bits(f, M), f, special)
    rv = np.where(_is_allowed_bits(r, M), r, special)
    key = np.where(_bits32(bw, c) >> np.uint64(32 - M) != 0, np.uint64(0),
                   np.uint64(0x80000000) | np.minimum(fv, rv))
    mins = _van_herk(key, w)
    valid = mins != 0
    sig = np.where(valid, mins & np.uint64(0x7FFFFFFF), np.uint64(U32))
    W = (k + 15) // 16
    r0 = k - 16 * (W - 1)
    base = np.arange(s) + 32

    def fwd(t):
        if t == 0:
            v = _window16(pw, base)
            return v >> np.uint64(32 - 2 * r0) if r0 < 16 else v
        return _window16(pw, base + r0 + 16 * (t - 1))

    def rc(t):
        if t == 0:
            v = _revcomp16(_window16(pw, base + k - r0))
            return v & np.uint64((1 << (2 * r0)) - 1) if r0 < 16 else v
        return _revcomp16(_window16(pw, base + k - r0 - 16 * t))

    use_rc = np.zeros(s, bool)
    decided = np.zeros(s, bool)
    if both:
        for t in range(W):
            fw, rw = fwd(t), rc(t)
            use_rc |= ~decided & (rw < fw)
            decided |= rw != fw
    lanes = np.stack([np.where(valid, np.where(use_rc, rc(t), fwd(t)),
                               np.uint64(U32)) for t in range(W)])
    sig_p, lanes_p = splitter_scan_plain(torch.from_numpy(codes), s=s, k=k,
                                         sig_len=M, both_strands=both)
    assert np.array_equal(sig.astype(np.uint32), sig_p.numpy().view(np.uint32))
    assert np.array_equal(lanes.astype(np.uint32),
                          lanes_p.numpy().view(np.uint32))
    assert valid.any() and not valid.all()


def test_delta_scan_tile_slots_match_search():
    """The delta list's per-tile first slot and the position before it
    (the single-block launch before the boundary-feed ingest), and each
    tile's own sum of its slots' positions, against np.searchsorted over
    the prefix sums, with padding slots and a tile with no sentinel."""
    tile = 1024
    k, s = 27, 6 * tile + 8
    codes = np.zeros(batch_len(s, k), np.uint8)
    rng = np.random.default_rng(4)
    sent = np.sort(rng.choice(np.arange(3 * tile, len(codes) - 100), 40,
                              replace=False))
    codes[sent] = 4
    codes[[0, 1, 1023, 1024]] = 4
    buf, ts = pack_codes_boundaries(codes)
    L = len(codes)
    d = buf[L // 4:].view("<u2").astype(np.int64)
    pos = np.cumsum(d) - 1
    n_real = int(np.flatnonzero(d).max()) + 1
    n_lo = (s + tile - 1) // tile + 2
    lo = np.empty(n_lo, np.int64)
    prev_of = np.empty(n_lo, np.int64)
    run = -1
    for i in range(len(d)):  # the kernel's fill, slot by slot
        prev, run = run, run + d[i]
        if d[i]:
            for t in range((prev + tile) // tile,
                           min(run // tile, n_lo - 1) + 1):
                lo[t], prev_of[t] = i, prev
    last = pos[n_real - 1]
    lo[(last + tile) // tile:] = n_real
    want = np.searchsorted(pos[:n_real], np.arange(n_lo) * tile)
    assert np.array_equal(lo, want)
    has = lo < n_real
    assert np.array_equal(prev_of[has],
                          np.where(lo[has] > 0, pos[lo[has] - 1], -1))
    for t in range(n_lo - 2):  # each tile's staged sentinels
        first, end = (lo[t - 1], prev_of[t - 1]) if t else (0, -1)
        got = end + np.cumsum(d[first:lo[t + 2]])
        org = t * tile - 32
        got = np.unique(got[(d[first:lo[t + 2]] > 0) & (got >= org)])
        want_t = pos[:n_real][(pos[:n_real] >= org)
                              & (pos[:n_real] < (t + 2) * tile)]
        assert np.array_equal(got, np.unique(want_t))
    assert np.array_equal(np.sort(np.concatenate([sent, [0, 1, 1023, 1024]])),
                          pos[:n_real])
