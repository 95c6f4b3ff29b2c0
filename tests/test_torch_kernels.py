"""The CUDA kernels of kmc_tpu_torch against their plain versions, on a card.

Every test here needs a CUDA card and skips without one.  The file imports
neither jax nor kmc_tpu, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from kmc_tpu_torch import microbench_sort as mb
from kmc_tpu_torch.io.readers import batch_len
from kmc_tpu_torch.ops.extract_kernel import (extract_splitter_scan,
                                              extract_splitter_scan_1d,
                                              splitter_scan_plain)
from kmc_tpu_torch.ops.sort_kernel import radix_sort_columns, radix_sort_plain
from kmc_tpu_torch.parallel.exchange_kernel import (all_to_all,
                                                    all_to_all_plain,
                                                    ragged_all_to_all,
                                                    ragged_all_to_all_plain)

M = 9


def _card_fastq(path, genome_len, n_reads, seed):
    """n_reads reads of 150 bases from a random genome, as a FASTQ."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, st in enumerate(rng.integers(0, len(genome) - 150, n_reads)):
            seq = acgt[genome[st:st + 150]].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * 150))
    return str(path)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [14, 27, 32, 33, 48, 55, 129, 256])
@pytest.mark.parametrize("both", [True, False])
def test_splitter_scan_matches_plain(k, both):
    _need_card()
    s = (1 << 16) + 8  # not a multiple of the kernel's 1024-position tile
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, batch_len(s, k)).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.01] = 4
    codes = torch.from_numpy(codes)
    sig_p, lanes_p = splitter_scan_plain(codes, s=s, k=k, sig_len=M,
                                         both_strands=both)
    before = extract_splitter_scan.launches
    sig_k, lanes_k = extract_splitter_scan(codes.cuda(), s=s, k=k, sig_len=M,
                                           both_strands=both)
    torch.cuda.synchronize()
    assert extract_splitter_scan.launches == before + 1
    assert torch.equal(sig_k.cpu(), sig_p)
    assert torch.equal(lanes_k.cpu(), lanes_p)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [14, 21, 27, 33, 55, 256])
@pytest.mark.parametrize("both", [True, False])
def test_splitter_scan_1d_matches_plain(k, both):
    _need_card()
    s = 1 << 17  # two of pallas_extract's 65536-position tiles
    rng = np.random.default_rng(k + 1)
    codes = rng.integers(0, 4, s + 2048).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.01] = 4
    # past batch_len(s, k) the halo holds garbage the entry must not read
    codes[batch_len(s, k):] = rng.integers(0, 256, s + 2048 - batch_len(s, k))
    codes = torch.from_numpy(codes)
    sig_p, lanes_p = extract_splitter_scan_1d(codes, s=s, k=k, sig_len=M,
                                              both_strands=both)
    before = extract_splitter_scan_1d.launches
    sig_k, lanes_k = extract_splitter_scan_1d(codes.cuda(), s=s, k=k,
                                              sig_len=M, both_strands=both)
    torch.cuda.synchronize()
    assert extract_splitter_scan_1d.launches == before + 1
    assert torch.equal(sig_k.cpu(), sig_p)
    assert len(lanes_k) == len(lanes_p) == (k + 15) // 16
    for got, want in zip(lanes_k, lanes_p):
        assert torch.equal(got.cpu(), want)


def _feed_batch(k, s, seed, dense):
    """One batch's feed: read-like codes in the boundary-delta format with
    40 padding sentinels (tail_start inside the batch), or sentinel-dense
    codes in the packed+mask format (tail_start None)."""
    from kmc_tpu_torch.io.native import (pack_codes_boundaries,
                                         pack_codes_fused)

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, batch_len(s, k)).astype(np.uint8)
    if dense:
        codes[rng.random(len(codes)) < 0.2] = 4
        return torch.from_numpy(pack_codes_fused(codes)), None
    if len(codes) >= 1024:  # room in the delta list for reads and Ns
        codes[rng.integers(0, 300)::max(151, 2 * k + 1)] = 4
        codes[rng.random(len(codes)) < 1e-3] = 4
    codes[-40:] = 4
    buf, ts = pack_codes_boundaries(codes)
    assert buf is not None and ts == len(codes) - 40
    return torch.from_numpy(buf), ts


def _greedy_map(seed):
    """A greedy signature -> bin map of 512 bins (-1 slots routed to the
    dead bin, as a store holds it) from a random sparse histogram."""
    from kmc_tpu_torch.signatures import build_signature_map, map_size

    rng = np.random.default_rng(seed)
    hist = np.zeros(map_size(M), np.uint64)
    hist[rng.integers(0, map_size(M), 3000)] = rng.integers(1, 1000, 3000)
    sig_map = build_signature_map(hist, M, 512)
    nb = int(sig_map.max()) + 1
    return torch.from_numpy(np.where(sig_map < 0, nb, sig_map).astype(
        np.int32)), nb


def _check_ingest(k, both, s, n_used, feeds, with_counts, device="cuda",
                  greedy=False, with_hist=False):
    from kmc_tpu_torch.ops.ingest_kernel import ingest, ingest_plain
    from kmc_tpu_torch.ops.store import greedy_fuse, prefix_bin_bits
    from kmc_tpu_torch.signatures import map_size

    prefix_bits, fuse = prefix_bin_bits(k, M, 512)
    sig_map = None
    if greedy:
        sig_map, nb = _greedy_map(k)
        prefix_bits, fuse = 0, greedy_fuse(k, nb)
    n_cols = (k + 15) // 16 + (0 if fuse else 1)
    cap = n_used + len(feeds) * s + 5
    rng = np.random.default_rng(k + s)
    init = [torch.from_numpy(rng.integers(-2**31, 2**31, cap,
                                          dtype=np.int64).astype(np.int32))
            for _ in range(n_cols + 1)]
    state = {}
    for dev in ("cpu", device):
        cols = [c.clone().to(dev) for c in init[:n_cols]]
        counts = init[-1].clone().to(dev) if with_counts else None
        occ = torch.tensor(2**32 - 7, dtype=torch.int64, device=dev)
        skm = torch.tensor(5, dtype=torch.int64, device=dev)
        prev = torch.tensor([-1], dtype=torch.int32, device=dev)
        hist = (torch.full((map_size(M),), 3, dtype=torch.int32, device=dev)
                if with_hist else None)
        dev_map = sig_map.to(dev) if greedy else None
        rows = n_used
        for buf, ts in feeds:
            fn = ingest_plain if dev == "cpu" else ingest
            before = (ingest.launches, ingest.greedy_launches,
                      ingest.hist_launches)
            prev = fn(buf.to(dev), ts, cols, counts, rows, occ, skm, prev,
                      s=s, k=k, sig_len=M, both_strands=both,
                      prefix_bits=prefix_bits, fuse=fuse, sig_map=dev_map,
                      hist=hist)
            if dev != "cpu":
                assert (ingest.launches, ingest.greedy_launches,
                        ingest.hist_launches) == (
                    before[0] + 1, before[1] + int(greedy),
                    before[2] + int(with_hist))
            rows += s
        torch.cuda.synchronize(device)
        state[dev] = [t.cpu() for t in cols + ([counts] if with_counts
                                               else []) + [occ, skm, prev]
                      + ([hist] if with_hist else [])]
    for got, want in zip(state[device], state["cpu"]):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [14, 27, 32, 33, 55, 256])
@pytest.mark.parametrize("both", [True, False])
def test_fused_ingest_matches_plain(k, both):
    """Two batches in a row (prev_sig carries), boundary-delta then
    packed+mask, at a non-aligned n_used, s not a multiple of the tile."""
    _need_card()
    s = 3 * 2048 + 8
    feeds = [_feed_batch(k, s, seed=k, dense=False),
             _feed_batch(k, s, seed=k + 1, dense=True)]
    _check_ingest(k, both, s, n_used=1001, feeds=feeds, with_counts=False)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [14, 27, 33, 55])
@pytest.mark.parametrize("with_hist", [False, True])
def test_fused_ingest_greedy_entry_matches_plain(k, with_hist):
    """The greedy entry (bin = map[min(sig, 4^m)]) over both feeds, with
    and without the stage-0 histogram output, against ingest_plain."""
    _need_card()
    s = 3 * 2048 + 8
    feeds = [_feed_batch(k, s, seed=k, dense=False),
             _feed_batch(k, s, seed=k + 1, dense=True)]
    _check_ingest(k, True, s, n_used=1001, feeds=feeds, with_counts=True,
                  greedy=True, with_hist=with_hist)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [27, 33])
@pytest.mark.parametrize("both", [True, False])
def test_fused_ingest_histogram_matches_plain(k, both):
    """The prefix entry's stage-0 histogram output (the deferred greedy
    fold) over both feeds and a tile edge, against ingest_plain's."""
    _need_card()
    for s in (3 * 2048 + 8, 1024):
        feeds = [_feed_batch(k, s, seed=k + s, dense=False),
                 _feed_batch(k, s, seed=k + s + 1, dense=True)]
        _check_ingest(k, both, s, n_used=7, feeds=feeds, with_counts=False,
                      with_hist=True)


@pytest.mark.gpu
@pytest.mark.parametrize("defer", ["1", "0"], ids=["deferred", "eager"])
@pytest.mark.parametrize("genome_len,route", [(8000, "device"),
                                              (20000, "replay"),
                                              (60000, "host")])
def test_greedy_count_on_card_matches_cpu(tmp_path, monkeypatch, defer,
                                          genome_len, route):
    """Greedy counts on the card write the CPU's bytes on every finalize
    route; eager batches go through the greedy entry, deferred ones fold
    the histogram into the prefix entry and collect with the radix sort."""
    _need_card()
    from kmc_tpu_torch import Runner, Stage1Params, Stage2Params
    from kmc_tpu_torch.ops.ingest_kernel import ingest

    monkeypatch.setenv("KMC_TPU_GREEDY_DEFER", defer)
    _card_fastq(tmp_path / "in.fastq", genome_len, 4000, seed=3)
    stats = {}
    for dev in ("cuda", "cpu"):
        before = (ingest.greedy_launches, ingest.hist_launches)
        r = Runner(device=dev)
        r.run_stage1(Stage1Params(input_files=[str(tmp_path / "in.fastq")],
                                  kmer_len=27, batch_positions=1 << 14,
                                  device_store_rows=1 << 15,
                                  signature_map_policy="greedy"))
        store = r._store
        r.run_stage2(Stage2Params(output_file_name=str(tmp_path / dev),
                                  cutoff_min=1))
        stats[dev] = (r.spill_stats["finalize_route"],
                      ingest.greedy_launches - before[0],
                      ingest.hist_launches - before[1])
        if dev == "cuda" and defer == "1" and route != "host":
            assert store.collect_launches == 1  # the collect's radix sort
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"cuda{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes()
    assert stats["cuda"][0] == stats["cpu"][0] == route
    n_batches = stats["cuda"][1] if defer == "0" else stats["cuda"][2]
    assert n_batches >= 1 and stats["cpu"][1:] == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("s,n_used", [(1024, 0), (1024, 3), (8, 6),
                                      ((1 << 16) + 8, 12345)])
@pytest.mark.parametrize("dense", [False, True])
def test_fused_ingest_tile_edges_and_counts(s, n_used, dense):
    """Exactly one tile, a tile plus aligned and unaligned store offsets,
    one group of 8 rows, and a counts column."""
    _need_card()
    feeds = [_feed_batch(27, s, seed=s + n_used, dense=dense),
             _feed_batch(27, s, seed=s + n_used + 1, dense=dense)]
    _check_ingest(27, True, s, n_used, feeds, with_counts=True)


@pytest.mark.gpu
def test_fused_ingest_on_second_card():
    _need_card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs at least 2 CUDA cards, found {n}")
    s = 4096
    feeds = [_feed_batch(33, s, seed=1, dense=False)]
    _check_ingest(33, True, s, 7, feeds, with_counts=True, device="cuda:1")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["probe_add1", "probe_gather_rows",
                                  "probe_gather_lanes"])
def test_probe_matches_plain(name):
    _need_card()
    x, idx, idxl = mb.probe_inputs(1 << 22, "cuda")
    fn = getattr(mb, name)
    plain = getattr(mb, name + "_plain")
    args = {"probe_add1": (x,), "probe_gather_rows": (x, idx),
            "probe_gather_lanes": (x, idxl)}[name]
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, plain(*args))
    assert torch.equal(plain(*[a.cpu() for a in args]), got.cpu())


def _columns(n, n_keys, seed, key_range):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, min(key_range, 2**32 - 1), n, dtype=np.uint32)
            for _ in range(n_keys)]
    dead = rng.random(n) < 0.1
    for c in keys:
        c[dead] = 0xFFFFFFFF  # the store's dead rows
    counts = rng.integers(1, 1000, n, dtype=np.uint32)
    counts[dead] = 0
    return [torch.from_numpy(c.view(np.int32).copy()) for c in keys + [counts]]


def _check_sort(cols, n_keys, device="cuda"):
    ref = radix_sort_plain(cols, n_keys)
    before = radix_sort_columns.launches
    on_card = [c.to(device) for c in cols]
    got = radix_sort_columns(on_card, n_keys)
    torch.cuda.synchronize(device)
    assert radix_sort_columns.launches == before + 1
    for g, r in zip(got, ref):
        assert g.device == on_card[0].device
        assert torch.equal(g.cpu(), r)


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_keys,key_range", [
    (1 << 20, 2, 2**32),
    (1 << 22, 2, 2**32),        # the main path's rows: 2 keys + counts
    ((1 << 18) + 3, 3, 50),     # 4 columns: index mode
    ((1 << 16) + 5, 4, 2**32),  # the k = 55 layout
    (4095, 1, 2**32),
    (5, 17, 2),
    ((1 << 14) + 7, 17, 2**32),  # the k = 256 layout
    (1, 2, 2**32),
    (4096, 2, 2**32),            # one tile
    (4097, 2, 2**32),            # one tile plus one row
    (4097, 4, 2**32),
])
def test_radix_sort_matches_plain(n, n_keys, key_range):
    _need_card()
    _check_sort(_columns(n, n_keys, seed=n, key_range=key_range), n_keys)


def _u32_cols(*arrays):
    return [torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32)
                             .copy()) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [2, 3, 5])
def test_radix_sort_odd_live_passes_and_skips(n_cols):
    """Live pass counts of 1, 2 and 3 (the result must end in the output
    whichever buffer the parity picks), every row equal (no live pass)."""
    _need_card()
    rng = np.random.default_rng(n_cols)
    n = 3 * 4096 + 11
    pay = [rng.integers(0, 2**32, n, dtype=np.uint32)
           for _ in range(n_cols - 2)]
    byte0 = rng.integers(0, 256, n, dtype=np.uint32)
    for key0, key1 in (
            (np.full(n, 7), 0xABCD0000 | byte0),       # one live pass
            (np.full(n, 7), 0xAB000000 | byte0 << 8 | byte0),   # two
            (byte0 << 16 | 5, 0x1200 | byte0),         # three
            (np.full(n, 0xFFFFFFFF), np.full(n, 3))):  # every row equal
        _check_sort(_u32_cols(key0, key1, *pay), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["sorted", "reversed"])
@pytest.mark.parametrize("n_keys", [1, 2, 4])
def test_radix_sort_presorted_and_reversed(order, n_keys):
    _need_card()
    n = (1 << 17) + 9
    rng = np.random.default_rng(n_keys)
    keys = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_keys)]
    keys[0] >>= 20  # ties in the leading key
    rows = np.lexsort(keys[::-1])  # keys[0] most significant
    keys = [k[rows] for k in keys]
    if order == "reversed":
        keys = [k[::-1] for k in keys]
    _check_sort(_u32_cols(*keys, np.arange(n)), n_keys)


@pytest.mark.gpu
def test_radix_sort_sender_layout():
    """1 key + 2 payloads: the sharded senders' sort of (bin|k-mer, lane,
    count) rows by key column 0."""
    _need_card()
    cols = _columns((1 << 20) + 1, 2, seed=3, key_range=2**32)
    _check_sort(cols, 1)


@pytest.mark.gpu
def test_radix_sort_on_second_card():
    _need_card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs at least 2 CUDA cards, found {n}")
    _check_sort(_columns((1 << 18) + 1, 2, seed=4, key_range=2**32), 2,
                device="cuda:1")
    _check_sort(_columns(5000, 4, seed=5, key_range=2**32), 4,
                device="cuda:1")


@pytest.mark.gpu
def test_radix_sort_stage_times():
    _need_card()
    from kmc_tpu_torch.ops.sort_kernel import radix_sort_stage_ms, sort_plan

    cols = [c.cuda() for c in _columns(1 << 18, 2, seed=6, key_range=2**32)]
    got, ms = radix_sort_stage_ms(cols, 2)
    ref = radix_sort_plain(cols, 2)
    assert len(ms) == len(sort_plan(3, 2)[0]) + 2
    assert all(t >= 0 for t in ms)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_count_on_card_matches_cpu(tmp_path):
    _need_card()
    from kmc_tpu_torch import count

    _card_fastq(tmp_path / "in.fastq", 20000, 4000, seed=0)
    kw = dict(k=27, cutoff_min=2, batch_positions=1 << 14,
              device_store_rows=3 << 14)
    r_gpu = count([str(tmp_path / "in.fastq")], str(tmp_path / "gpu"),
                  device="cuda", **kw)
    r_cpu = count([str(tmp_path / "in.fastq")], str(tmp_path / "cpu"),
                  device="cpu", **kw)
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"gpu{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes()
    assert r_gpu[1].n_unique_kmers == r_cpu[1].n_unique_kmers > 0


def _exchange_shards(devices, cap, C, seed):
    D = len(devices)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=(D, D, cap, C), dtype=np.uint32)
    n_rows = rng.integers(0, cap + 1, size=(D, D))
    n_rows[0, 1 % D] = 0
    n_rows[D - 1, 0] = cap
    xs = [torch.from_numpy(x[j].view(np.int32)).to(devices[j])
          for j in range(D)]
    return xs, n_rows


def _check_exchange(devices, cap, C, seed):
    D = len(devices)
    xs, n_rows = _exchange_shards(devices, cap, C, seed)
    ref, rr_ref = ragged_all_to_all_plain(xs, n_rows)
    before = ragged_all_to_all.launches
    outs, rr = ragged_all_to_all(xs, n_rows)
    for d in set(devices):
        torch.cuda.synchronize(d)
    assert ragged_all_to_all.launches == before + len(set(devices))
    assert np.array_equal(rr, rr_ref)
    for r in range(D):
        assert outs[r].device == xs[r].device
        for j in range(D):
            m = int(rr[r, j])
            assert torch.equal(outs[r][j, :m], ref[r][j, :m]), (r, j)
    dense_ref = all_to_all_plain(xs)
    before = all_to_all.launches
    dense = all_to_all(xs)
    for d in set(devices):
        torch.cuda.synchronize(d)
    assert all_to_all.launches == before + len(set(devices))
    for got, want in zip(dense, dense_ref):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("cap,C", [(1024, 2), ((1 << 16) + 3, 3), (64, 1)])
def test_exchange_one_card_matches_plain(cap, C):
    _need_card()
    _check_exchange(["cuda:0"] * 4, cap, C, seed=cap + C)


@pytest.mark.gpu
def test_exchange_across_cards_matches_plain():
    _need_card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs at least 2 CUDA cards for peer reads, found {n}")
    devices = [f"cuda:{i % n}" for i in range(4)]
    _check_exchange(devices, (1 << 14) + 4, 2, seed=5)


_IPC_CHILD = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
from kmc_tpu_torch.parallel.distributed import init_multihost
from kmc_tpu_torch.parallel.exchange_kernel import (
    ragged_all_to_all_plain, ragged_all_to_all_processes, send_buffer)

init, rank, out, cap, C = sys.argv[1:6]
rank, cap, C = int(rank), int(cap), int(C)
init_multihost(init, 2, rank)
D, layout = 4, [[0, 1], [2, 3]]
counts = np.random.default_rng(C).integers(0, cap + 1, size=(D, D))
counts[0, 3], counts[2, 1] = 0, cap
full = [torch.from_numpy(np.random.default_rng(100 + j).integers(
    -2**31, 2**31, (D, cap, C)).astype(np.int32)) for j in range(D)]
want, _ = ragged_all_to_all_plain(full, counts)
refused = False
try:  # a sender's buffer not exported for IPC is refused on every rank
    ragged_all_to_all_processes(
        [torch.empty((D, cap, C), dtype=torch.int32, device="cuda:0")] * 2,
        counts, layout)
except ValueError:
    refused = True
xs = []
for j in layout[rank]:
    buf = send_buffer((D, cap, C), "cuda:0", True)
    buf.copy_(full[j].cuda())
    xs.append(buf)
outs, recv = ragged_all_to_all_processes(xs, counts, layout)
torch.cuda.synchronize()
ok = all(torch.equal(outs[l][j, :counts[j, o]].cpu(),
                     want[o][j, :counts[j, o]])
         for l, o in enumerate(layout[rank]) for j in range(D))
json.dump({"ok": ok, "refused": refused, "recv": recv.tolist(),
           "launches": ragged_all_to_all_processes.launches}, open(out, "w"))
dist.destroy_process_group()
"""


@pytest.mark.gpu
@pytest.mark.parametrize("cap,C", [(1024, 2), ((1 << 16) + 3, 3)])
def test_exchange_across_processes_matches_plain(tmp_path, cap, C):
    """Two processes on card 0, two senders and two owners each: rank 0's
    one launch reads rank 1's senders and writes rank 1's outputs through
    CUDA IPC, and every owner gets what the plain version delivers."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    _need_card()
    repo = Path(__file__).resolve().parent.parent
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _IPC_CHILD, init, str(r),
         str(tmp_path / f"r{r}.json"), str(cap), str(C)], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    counts = np.random.default_rng(C).integers(0, cap + 1, size=(4, 4))
    counts[0, 3], counts[2, 1] = 0, cap
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        assert got["ok"] and got["refused"], got
        # one launch a card, by the lowest rank on it
        assert got["launches"] == (1 if r == 0 else 0)
        assert got["recv"] == counts[:, [2 * r, 2 * r + 1]].T.tolist()


@pytest.mark.gpu
def test_two_process_count_on_card_matches_cpu(tmp_path):
    """tests/torch_multiproc_worker.py as two processes on card 0 (two
    shards each): the database and stats equal the single-process count
    over 4 CPU shards, and the exchange ran the kernel across processes."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    _need_card()
    from kmc_tpu_torch import distributed_count

    fq = _card_fastq(tmp_path / "in.fastq", 20000, 4000, seed=3)
    here = Path(__file__).resolve().parent
    env = dict(os.environ, MP_DEVICES="cuda:0,cuda:0", MP_K="27", MP_CI="2",
               MP_BATCH=str(1 << 14), MP_CAPACITY=str(5 << 13),
               MP_SHARD_INPUT="0", MP_MODES="default,kff")
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_multiproc_worker.py"), init, "2",
         str(r), fq, str(tmp_path / "mp")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for mode, kw in (("default", {}), ("kff", dict(output_type="kff"))):
        res = [json.loads((tmp_path / f"mp.{mode}.stats.{r}").read_text())
               for r in range(2)]
        st = distributed_count([fq], str(tmp_path / f"cpu_{mode}"),
                               devices=["cpu"] * 4, k=27, cutoff_min=2,
                               batch_positions=1 << 14,
                               capacity_rows_per_device=5 << 13, **kw)
        for rank, r in enumerate(res):
            # one exchange launch for card 0, by rank 0
            assert r["launches"] == (1 if rank == 0 else 0)
            assert r["kernels"]["fused_ingest"] > 0
            assert r["stats"]["timings"]["exchange_route"] == "ipc_kernel"
            for key in ("n_unique", "n_total", "n_super_kmers", "n_below",
                        "n_above", "n_compactions", "n_spills",
                        "exchange_bytes"):
                assert r["stats"][key] == st[key], (mode, key)
        for suf in ((".kff",) if mode == "kff" else (".kmc_pre",
                                                      ".kmc_suf")):
            assert (tmp_path / f"mp.{mode}{suf}").read_bytes() == \
                (tmp_path / f"cpu_{mode}{suf}").read_bytes(), (mode, suf)


_NODES_CHILD = r"""
import json, socket, sys
import numpy as np, torch
import torch.distributed as dist

init, n_procs, rank, out, per, cap, C, cards = sys.argv[1:9]
n_procs, rank, per, cap, C, cards = map(int, (n_procs, rank, per, cap, C,
                                              cards))
# two emulated nodes: the first half of the ranks, and the second
socket.gethostname = lambda: f"node{rank * 2 // n_procs}"
from kmc_tpu_torch.parallel.distributed import init_multihost
from kmc_tpu_torch.parallel.exchange_kernel import (
    ragged_all_to_all_plain, ragged_all_to_all_processes, send_buffer)

xp = ragged_all_to_all_processes
init_multihost(init, n_procs, rank)
D = n_procs * per
layout = [list(range(p * per, (p + 1) * per)) for p in range(n_procs)]
counts = np.random.default_rng(C).integers(0, cap + 1, size=(D, D))
counts[0, D - 1], counts[D - 1, 0] = 0, cap
full = [torch.from_numpy(np.random.default_rng(100 + j).integers(
    -2**31, 2**31, (D, cap, C)).astype(np.int32)) for j in range(D)]
want, _ = ragged_all_to_all_plain(full, counts)
# this rank's cards: its shards take them in turn
devs = [f"cuda:{rank * cards + l % cards}" for l in range(per)]
xs = []
for l, j in enumerate(layout[rank]):
    buf = send_buffer((D, cap, C), devs[l], True)
    buf.copy_(full[j].to(devs[l]))
    xs.append(buf)
outs, recv = xp(xs, counts, layout)
for d in set(devs):
    torch.cuda.synchronize(d)
ok = all(torch.equal(outs[l][j, :counts[j, o]].cpu(),
                     want[o][j, :counts[j, o]])
         for l, o in enumerate(layout[rank]) for j in range(D))
json.dump({"ok": ok, "recv": recv.tolist(), "launches": xp.launches,
           "opens": xp.cross_node_opens, "nccl_ms": xp.nccl_ms,
           "slot_nccl_ms": xp.slot_nccl_ms, "staged": xp.staged_bytes,
           "cross_bytes": xp.cross_node_bytes}, open(out, "w"))
dist.destroy_process_group()
"""


def _need_cards(n):
    _need_card()
    have = torch.cuda.device_count()
    if have < n:
        pytest.skip(f"needs {n} CUDA cards (NCCL's cross-node leg takes one "
                    f"process a card), found {have}")


@pytest.mark.gpu
@pytest.mark.parametrize("n_procs,per,cards", [(2, 2, 1), (4, 1, 1),
                                               (2, 2, 2)],
                         ids=["2-2", "4-1", "2-2-two_cards"])
def test_exchange_across_nodes_matches_plain(tmp_path, n_procs, per, cards):
    """Processes on cards of their own in two emulated nodes (`cards`
    cards a process, one NCCL group a card slot): the on-node pairs go
    through the kernel (over CUDA IPC between a node's two processes, or
    between a process's two cards), the cross-node pairs through NCCL on
    the owner's slot, staged onto the sender's card of that slot where
    its own is of another, and every owner gets what the plain version
    delivers; no handle of the other node is opened."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    _need_cards(n_procs * cards)
    repo = Path(__file__).resolve().parent.parent
    init = f"file://{tmp_path / 'pg'}"
    cap, C = (1 << 16) + 3, 3
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NODES_CHILD, init, str(n_procs), str(r),
         str(tmp_path / f"r{r}.json"), str(per), str(cap), str(C),
         str(cards)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n_procs)]
    logs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    D = n_procs * per
    counts = np.random.default_rng(C).integers(0, cap + 1, size=(D, D))
    counts[0, D - 1], counts[D - 1, 0] = 0, cap
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        assert got["ok"], got
        assert got["launches"] == cards and got["opens"] == 0
        assert got["nccl_ms"] > 0 and got["cross_bytes"] > 0
        assert len(got["slot_nccl_ms"]) == cards
        assert all(ms > 0 for ms in got["slot_nccl_ms"])
        assert (got["staged"] > 0) == (cards > 1)
        mine = list(range(r * per, (r + 1) * per))
        assert got["recv"] == counts[:, mine].T.tolist()


def _run_worker_group(tmp_path, n_procs, env_extra, fq, timeout=300):
    """tests/torch_multiproc_worker.py as n_procs processes; returns each
    one's (exit code, output)."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, **env_extra)
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_multiproc_worker.py"), init,
         str(n_procs), str(r), fq, str(tmp_path / "mp")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n_procs)]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode(errors="replace")
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:  # the worker prints its stacks on SIGTERM
            p.terminate()
        time.sleep(3)
        for p in procs:
            p.kill()
        logs = [p.communicate()[0].decode(errors="replace")[-3000:]
                for p in procs]
        pytest.fail(f"a worker hung past {timeout} s:\n" + "\n".join(logs))
    return [(p.returncode, log) for p, log in zip(procs, logs)]


@pytest.mark.gpu
def test_two_node_count_on_cards_matches_cpu(tmp_path):
    """Two processes, one card each, in two emulated nodes: every row of
    the exchange crosses between the nodes by NCCL but a sender's own,
    which the kernel copies; the database and stats equal the count over
    2 CPU shards."""
    import json

    _need_cards(2)
    from kmc_tpu_torch import distributed_count

    fq = _card_fastq(tmp_path / "in.fastq", 20000, 4000, seed=4)
    ran = _run_worker_group(tmp_path, 2, dict(
        MP_DEVICES="cuda:{pid}", MP_NODE="0,1", MP_K="27", MP_CI="2",
        MP_BATCH=str(1 << 14), MP_CAPACITY=str(5 << 13),
        MP_SHARD_INPUT="0", MP_MODES="default,kff"), fq)
    for rc, log in ran:
        assert rc == 0, log[-3000:]
    for mode, kw in (("default", {}), ("kff", dict(output_type="kff"))):
        res = [json.loads((tmp_path / f"mp.{mode}.stats.{r}").read_text())
               for r in range(2)]
        st = distributed_count([fq], str(tmp_path / f"cpu_{mode}"),
                               devices=["cpu"] * 2, k=27, cutoff_min=2,
                               batch_positions=1 << 14,
                               capacity_rows_per_device=5 << 13, **kw)
        for r in res:
            assert r["launches"] == 1 and r["exchange_cross_node_opens"] == 0
            assert r["exchange_cross_node_bytes"] > 0
            assert r["exchange_nccl_ms"] > 0
            assert r["stats"]["timings"]["exchange_route"] == \
                "ipc_kernel+nccl"
            for key in ("n_unique", "n_total", "n_super_kmers", "n_below",
                        "n_above", "n_compactions", "n_spills",
                        "exchange_bytes"):
                assert r["stats"][key] == st[key], (mode, key)
        for suf in ((".kff",) if mode == "kff" else (".kmc_pre",
                                                      ".kmc_suf")):
            assert (tmp_path / f"mp.{mode}{suf}").read_bytes() == \
                (tmp_path / f"cpu_{mode}{suf}").read_bytes(), (mode, suf)


_TWO_CARDS = "cuda:0,cuda:1;cuda:2,cuda:3"  # two processes of two cards


@pytest.mark.gpu
def test_two_node_count_two_cards_a_process_matches_cpu(tmp_path):
    """kmc_tpu's multi-host layout: two emulated nodes of one process
    holding two cards, one NCCL group a card slot.  Each process launches
    the exchange kernel once on each of its cards, stages rows onto its
    card of the owner's slot, and sends on every slot's group; the
    database and stats equal the count over 4 CPU shards."""
    import json

    _need_cards(4)
    from kmc_tpu_torch import distributed_count

    fq = _card_fastq(tmp_path / "in.fastq", 20000, 4000, seed=7)
    ran = _run_worker_group(tmp_path, 2, dict(
        MP_DEVICES=_TWO_CARDS, MP_NODE="0,1", MP_K="27", MP_CI="2",
        MP_BATCH=str(1 << 14), MP_CAPACITY=str(5 << 13),
        MP_SHARD_INPUT="0", MP_MODES="default,kff"), fq)
    for rc, log in ran:
        assert rc == 0, log[-3000:]
    for mode, kw in (("default", {}), ("kff", dict(output_type="kff"))):
        res = [json.loads((tmp_path / f"mp.{mode}.stats.{r}").read_text())
               for r in range(2)]
        st = distributed_count([fq], str(tmp_path / f"cpu_{mode}"),
                               devices=["cpu"] * 4, k=27, cutoff_min=2,
                               batch_positions=1 << 14,
                               capacity_rows_per_device=5 << 13, **kw)
        for r in res:
            assert r["launches"] == 2 and r["exchange_cross_node_opens"] == 0
            assert r["exchange_cross_node_bytes"] > 0
            assert r["exchange_staged_bytes"] > 0
            assert len(r["exchange_slot_nccl_ms"]) == 2
            assert all(ms > 0 for ms in r["exchange_slot_nccl_ms"])
            assert len(r["nccl_init_s"]) == len(r["nccl_warmup_s"]) == 2
            assert r["stats"]["timings"]["exchange_route"] == \
                "ipc_kernel+nccl"
            for key in ("n_unique", "n_total", "n_super_kmers", "n_below",
                        "n_above", "n_compactions", "n_spills",
                        "exchange_bytes"):
                assert r["stats"][key] == st[key], (mode, key)
        for suf in ((".kff",) if mode == "kff" else (".kmc_pre",
                                                      ".kmc_suf")):
            assert (tmp_path / f"mp.{mode}{suf}").read_bytes() == \
                (tmp_path / f"cpu_{mode}{suf}").read_bytes(), (mode, suf)


@pytest.mark.gpu
def test_two_ranks_on_one_card_across_nodes_raise(tmp_path):
    """Four processes on card 0 in two emulated nodes: NCCL would take two
    ranks on one GPU, so every rank raises at the count's start, naming
    the layout."""
    _need_card()
    fq = _card_fastq(tmp_path / "in.fastq", 5000, 200, seed=5)
    ran = _run_worker_group(tmp_path, 4, dict(
        MP_DEVICES="cuda:0", MP_NODE="0,0,1,1", MP_K="27"), fq)
    for rc, log in ran:
        assert rc not in (0, None), log[-3000:]
        assert "ranks [0, 1] share card" in log and "node0" in log, \
            log[-3000:]


@pytest.mark.gpu
def test_dead_peer_across_nodes_on_cards_fails_survivor(tmp_path):
    """Process 1 of two on cards of their own in two emulated nodes dies
    where it would post the NCCL leg; the survivor, whose NCCL receive
    never completes, is torn down by the NCCL group's watchdog at the
    group's timeout (the heartbeat), never hangs.  The survivor's last
    lines are printed: they name what ended it."""
    import time

    _need_cards(2)
    fq = _card_fastq(tmp_path / "in.fastq", 20000, 2000, seed=6)
    t0 = time.monotonic()
    ran = _run_worker_group(tmp_path, 2, dict(
        MP_DEVICES="cuda:{pid}", MP_NODE="0,1", MP_K="27",
        MP_BATCH=str(1 << 14), MP_CAPACITY=str(5 << 13),
        MP_HEARTBEAT_SECS="20", MP_CRASH_AT="p2p", MP_CRASH_PID="1"), fq,
        timeout=240)
    assert ran[1][0] == 17, ran[1][1][-2000:]
    assert ran[0][0] not in (0, None), ran[0][1][-2000:]
    print(f"survivor exited {ran[0][0]}:\n{ran[0][1][-1500:]}")
    assert time.monotonic() - t0 < 180
    assert not (tmp_path / "mp.default.kmc_pre").exists()


@pytest.mark.gpu
def test_dead_peer_two_cards_a_process_fails_survivor(tmp_path):
    """The dead-peer test in kmc_tpu's multi-host layout: process 1 of two
    emulated nodes, each one process of two cards, dies where it would
    post the NCCL leg; the survivor, whose receives on a slot's group
    never complete, is torn down by that group's watchdog at its timeout,
    never hangs."""
    import time

    _need_cards(4)
    fq = _card_fastq(tmp_path / "in.fastq", 20000, 2000, seed=8)
    t0 = time.monotonic()
    ran = _run_worker_group(tmp_path, 2, dict(
        MP_DEVICES=_TWO_CARDS, MP_NODE="0,1", MP_K="27",
        MP_BATCH=str(1 << 14), MP_CAPACITY=str(5 << 13),
        MP_HEARTBEAT_SECS="20", MP_CRASH_AT="p2p", MP_CRASH_PID="1"), fq,
        timeout=240)
    assert ran[1][0] == 17, ran[1][1][-2000:]
    assert ran[0][0] not in (0, None), ran[0][1][-2000:]
    print(f"survivor exited {ran[0][0]}:\n{ran[0][1][-1500:]}")
    assert time.monotonic() - t0 < 180
    assert not (tmp_path / "mp.default.kmc_pre").exists()


@pytest.mark.gpu
def test_distributed_count_on_card_matches_cpu(tmp_path):
    _need_card()
    from kmc_tpu_torch import distributed_count

    _card_fastq(tmp_path / "in.fastq", 20000, 4000, seed=1)
    kw = dict(k=27, cutoff_min=2, batch_positions=1 << 14,
              capacity_rows_per_device=5 << 13)
    s_gpu = distributed_count([str(tmp_path / "in.fastq")],
                              str(tmp_path / "gpu"), devices=["cuda:0"] * 4,
                              **kw)
    s_cpu = distributed_count([str(tmp_path / "in.fastq")],
                              str(tmp_path / "cpu"), devices=["cpu"] * 4, **kw)
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"gpu{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes()
    assert s_gpu["n_compactions"] == s_cpu["n_compactions"] >= 1
    assert s_gpu["n_unique"] == s_cpu["n_unique"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("genome_len,route", [(20000, "replay"),
                                              (60000, "host")])
def test_spilling_count_on_card_matches_cpu(tmp_path, genome_len, route):
    _need_card()
    from kmc_tpu_torch import Runner, Stage1Params, Stage2Params

    _card_fastq(tmp_path / "in.fastq", genome_len, 4000, seed=2)
    stats = {}
    for dev in ("cuda", "cpu"):
        r = Runner(device=dev)
        r.run_stage1(Stage1Params(input_files=[str(tmp_path / "in.fastq")],
                                  kmer_len=27, batch_positions=1 << 14,
                                  device_store_rows=1 << 15))
        r.run_stage2(Stage2Params(output_file_name=str(tmp_path / dev),
                                  cutoff_min=1))
        stats[dev] = r.spill_stats
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"cuda{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes()
    assert stats["cuda"]["n_spills"] == stats["cpu"]["n_spills"] >= 1
    assert stats["cuda"]["finalize_route"] == stats["cpu"]["finalize_route"] \
        == route
    if route == "host":  # the runs and the store merged on the card
        assert stats["cuda"]["merge_launches"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("k,case", [(27, "kmc2"), (33, "kmc2"), (27, "kff"),
                                    (27, "greedy")])
def test_host_route_ranges_on_card_matches_cpu(tmp_path, monkeypatch, k,
                                               case):
    """The host route's emitter on the card, over a merge cut into many
    key ranges, each range's rows copied as it completes: KMC2 records, KFF
    output (the words emitter), and deferred greedy (the host merge's
    remapped groups uploaded back in chunks)."""
    _need_card()
    from kmc_tpu_torch import (OutputFileType, Runner, Stage1Params,
                               Stage2Params)
    from kmc_tpu_torch.ops import store as store_mod

    monkeypatch.setenv("KMC_TPU_GREEDY_DEFER", "1")
    s1 = dict(signature_map_policy="greedy") if case == "greedy" else {}
    s2 = (dict(output_file_type=OutputFileType.KFF) if case == "kff"
          else {})
    sufs = (".kff",) if case == "kff" else (".kmc_pre", ".kmc_suf")
    _card_fastq(tmp_path / "in.fastq", 60000, 4000, seed=2)
    ranges = {}
    for dev in ("cuda", "cpu"):
        with monkeypatch.context() as m:
            if dev == "cuda":
                m.setattr(store_mod, "_merge_rows", lambda *a, **kw: 20000)
            r = Runner(device=dev)
            r.run_stage1(Stage1Params(
                input_files=[str(tmp_path / "in.fastq")], kmer_len=k,
                batch_positions=1 << 14, device_store_rows=1 << 15, **s1))
            r.run_stage2(Stage2Params(output_file_name=str(tmp_path / dev),
                                      cutoff_min=1, **s2))
        assert r.spill_stats["finalize_route"] == "host"
        ranges[dev] = r._count.counter("ranges", "kmc.host_completer")
    for suf in sufs:
        assert (tmp_path / f"cuda{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes()
    assert ranges["cuda"] >= 3 and ranges["cpu"] == 1


def _sorted_run(rng, n, n_keys, dead_tail=1):
    """A spilled run: unique rows sorted by their key columns (few column-0
    values, so runs share keys), counts up to 2^32 - 1, dead rows after."""
    cols = [rng.integers(0, 300, n).astype(np.uint32) << np.uint32(20)]
    cols += [rng.integers(0, 16, n).astype(np.uint32)
             for _ in range(n_keys - 1)]
    order = np.lexsort(tuple(cols[::-1]))
    cols = [c[order] for c in cols]
    new = np.ones(n, bool)
    new[1:] = np.any([c[1:] != c[:-1] for c in cols], axis=0)
    cols = [np.append(c[new], np.full(dead_tail, 0xFFFFFFFF, np.uint32))
            for c in cols]
    counts = rng.integers(1, 1 << 32, int(new.sum()), dtype=np.uint64)
    return tuple(cols), np.append(counts.astype(np.uint32),
                                  np.zeros(dead_tail, np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("n_keys", [2, 3])
@pytest.mark.parametrize("ranges", ["one", "many"])
def test_merge_runs_on_card_matches_cpu(n_keys, ranges):
    """The merge of spilled runs on the card (the grouping-sort kernel)
    against the same merge on the CPU (its plain version): sorted unique
    rows, exact u64 totals, and the re-merge's clamp and dead row."""
    _need_card()
    from kmc_tpu_torch.ops.store import (_merge_row_bytes, merge_runs_to_host,
                                         remerge_runs)

    rng = np.random.default_rng(n_keys)
    runs = [_sorted_run(rng, 50_000, n_keys) for _ in range(3)]
    n_rows = sum(len(counts) for _, counts in runs)
    limit = (None if ranges == "one"
             else _merge_row_bytes(n_keys) * (n_rows // 6))  # ~6 ranges
    want = merge_runs_to_host(runs, n_keys, "cpu")
    before = radix_sort_columns.launches
    got = merge_runs_to_host(runs, n_keys, "cuda", max_bytes=limit)
    launches = radix_sort_columns.launches - before
    assert launches == 1 if limit is None else launches > 1  # one a range
    for a, b in zip(got[0], want[0]):
        assert a.dtype == np.uint32 and np.array_equal(a, b)
    assert np.array_equal(got[1], want[1]) and got[2] == want[2] == 3
    assert want[1].max() > 0xFFFFFFFF
    got_r = remerge_runs(runs, n_keys, "cuda", max_bytes=limit)
    want_r = remerge_runs(runs, n_keys, "cpu")
    for a, b in zip(got_r[0] + (got_r[1],), want_r[0] + (want_r[1],)):
        assert np.array_equal(a, b)


@pytest.mark.gpu
def test_sharded_spilling_count_on_card_matches_cpu(tmp_path):
    """A sharded count whose shards spill (on distinct cards where there
    are several): the card's database equals the CPU's, with the same
    spills, and the merges ran the grouping-sort kernel."""
    _need_card()
    from kmc_tpu_torch import distributed_count

    _card_fastq(tmp_path / "in.fastq", 60000, 4000, seed=3)
    n = torch.cuda.device_count()
    kw = dict(k=27, cutoff_min=1, batch_positions=1 << 13,
              capacity_rows_per_device=1 << 15)
    s_gpu = distributed_count([str(tmp_path / "in.fastq")],
                              str(tmp_path / "gpu"),
                              devices=[f"cuda:{i % n}" for i in range(4)],
                              **kw)
    s_cpu = distributed_count([str(tmp_path / "in.fastq")],
                              str(tmp_path / "cpu"), devices=["cpu"] * 4, **kw)
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"gpu{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes()
    for key in ("n_unique", "n_total", "n_compactions", "n_spills",
                "n_remerges"):
        assert s_gpu[key] == s_cpu[key], key
    assert s_gpu["n_spills"] >= 1 and s_gpu["merge_launches"] >= 1


_SHARDED_SPILL = dict(batch_positions=1 << 13, capacity_rows_per_device=1 << 15)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", [
    ("smallk13", dict(k=13)),
    ("smallk13_kff", dict(k=13, output_type="kff")),
    ("greedy27", dict(k=27, signature_map_policy="greedy")),
    ("greedy32_spill", dict(k=32, signature_map_policy="greedy",
                            **_SHARDED_SPILL)),
    ("kff27", dict(k=27, output_type="kff")),
    ("kff27_spill", dict(k=27, output_type="kff", **_SHARDED_SPILL)),
    ("estimate", dict(k=27, estimate_only=True)),
    ("opt_out_size", dict(k=27, opt_out_size=True)),
])
def test_sharded_modes_on_card_match_cpu(tmp_path, name, kw):
    """The sharded count's other modes over 4 shards (on distinct cards
    where there are several): the card's files and stats equal the CPU's;
    the greedy and KFF routes ran the ragged exchange and the grouping
    sort, the greedy route the fused ingest's greedy entry."""
    _need_card()
    from kmc_tpu_torch import distributed_count
    from kmc_tpu_torch.ops.ingest_kernel import ingest

    src = _card_fastq(tmp_path / "in.fastq", 60000, 4000, seed=4)
    n = torch.cuda.device_count()
    kw = dict(dict(cutoff_min=1, batch_positions=1 << 14,
                   capacity_rows_per_device=1 << 17), **kw)
    before = (ragged_all_to_all.launches, radix_sort_columns.launches,
              ingest.greedy_launches)
    s_gpu = distributed_count([src], str(tmp_path / "gpu"),
                              devices=[f"cuda:{i % n}" for i in range(4)],
                              **kw)
    launches = (ragged_all_to_all.launches - before[0],
                radix_sort_columns.launches - before[1],
                ingest.greedy_launches - before[2])
    s_cpu = distributed_count([src], str(tmp_path / "cpu"),
                              devices=["cpu"] * 4, **kw)
    files = sorted(p.name[3:] for p in tmp_path.glob("gpu.*"))
    assert files == sorted(p.name[3:] for p in tmp_path.glob("cpu.*"))
    for suf in files:
        assert (tmp_path / f"gpu{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes(), suf
    for key in ("timings", "merge_launches"):  # no launches on the CPU
        s_gpu.pop(key, None)
        s_cpu.pop(key, None)
    assert s_gpu == s_cpu
    if name.startswith(("greedy", "kff")):
        assert launches[0] >= 1 and launches[1] >= 1
        assert (launches[2] >= 1) == name.startswith("greedy")
    if name.endswith("spill"):
        assert s_gpu["n_spills"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("k", [21, 27, 33])
def test_distributed_step_on_card_matches_cpu(k):
    """make_distributed_count_step over 4 card shards (distinct cards where
    there are several) equals the same step on 4 CPU shards, and exchanges
    through the dense all-to-all kernel."""
    _need_card()
    from kmc_tpu_torch.parallel.distributed import (
        make_distributed_count_step)
    from kmc_tpu_torch.signatures import build_signature_map, map_size

    s, D = 1 << 14, 4
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (D, batch_len(s, k))).astype(np.uint8)
    codes[:, 150::151] = 4
    codes[:, -40:] = 4
    hist = rng.integers(0, 1000, map_size(M)).astype(np.uint64)
    sig_map = build_signature_map(hist, M, 64)
    n = torch.cuda.device_count()
    step, cap = make_distributed_count_step(
        [f"cuda:{i % n}" for i in range(D)], s=s, k=k, sig_len=M)
    ref, _ = make_distributed_count_step(["cpu"] * D, s=s, k=k, sig_len=M)
    before = all_to_all.launches
    got = step(codes, sig_map)
    assert all_to_all.launches == before + min(n, D)  # one a card
    want = ref(codes, sig_map)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)
    assert sum(int(x) for x in got[2]) > 0


# -- the other routes of one device: small k, the estimator, host buckets,
# the per-bin merge and the words-path finalize --

@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 9, 13])
@pytest.mark.parametrize("both", [True, False])
def test_smallk_batch_on_card_matches_plain(k, both):
    _need_card()
    from kmc_tpu_torch.io.native import pack_codes_fused
    from kmc_tpu_torch.ops.smallk import smallk_batch, smallk_histogram_size

    s = 1 << 20
    rng = np.random.default_rng(k)
    hists = {dev: torch.zeros(smallk_histogram_size(k), dtype=torch.int64,
                              device=dev) for dev in ("cuda", "cpu")}
    for _ in range(2):
        codes = rng.integers(0, 4, batch_len(s, k)).astype(np.uint8)
        codes[rng.random(len(codes)) < 0.01] = 4
        buf = torch.from_numpy(pack_codes_fused(codes))
        for dev, hist in hists.items():
            smallk_batch(buf.to(dev), hist, s=s, k=k, both_strands=both)
    assert torch.equal(hists["cuda"].cpu(), hists["cpu"])


@pytest.mark.gpu
def test_estimator_on_card_matches_plain():
    _need_card()
    from kmc_tpu_torch.ops.nthash import NtCardEstimator, nthash_canonical

    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 1 << 16).astype(np.uint8)
    chunks = []
    for _ in range(3):
        starts = rng.integers(0, len(genome) - 150, 20000)
        reads = genome[starts[:, None] + np.arange(150)]
        chunks.append(np.concatenate(
            [reads, np.full((len(starts), 1), 4, np.uint8)], axis=1).ravel())
    h_gpu, v_gpu = nthash_canonical(torch.from_numpy(chunks[0]).cuda(), 27)
    h_cpu, v_cpu = nthash_canonical(torch.from_numpy(chunks[0]), 27)
    assert torch.equal(h_gpu.cpu(), h_cpu) and torch.equal(v_gpu.cpu(), v_cpu)
    est = {dev: NtCardEstimator(27, s=7, device=dev) for dev in ("cuda", "cpu")}
    for chunk in chunks:
        for e in est.values():
            e.process_codes(chunk)
    for a, b in zip(est["cuda"].counters, est["cpu"].counters):
        assert torch.equal(a.cpu(), b)
    hist = est["cuda"].estimate_histogram()
    assert hist == est["cpu"].estimate_histogram() and sum(hist) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k,both", [(27, True), (33, True), (31, False)])
def test_host_bucket_batch_on_card_matches_plain(k, both):
    """Stage 0's histogram and stage 1's batch grouping: the scan entry and
    the grouping sort on the card against their plain versions."""
    _need_card()
    from kmc_tpu_torch.ops.sortcount import stage0_accum, stage1_batch

    s = 1 << 20
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 1 << 15).astype(np.uint8)
    starts = rng.integers(0, len(genome) - 150, batch_len(s, k) // 151 + 1)
    codes = np.concatenate([np.append(genome[st:st + 150], np.uint8(4))
                            for st in starts])[:batch_len(s, k)]
    codes = torch.from_numpy(codes.astype(np.uint8))
    scans, sorts = extract_splitter_scan.launches, radix_sort_columns.launches
    got = stage1_batch(codes.cuda(), s=s, k=k, sig_len=M, both_strands=both)
    want = stage1_batch(codes, s=s, k=k, sig_len=M, both_strands=both)
    assert extract_splitter_scan.launches == scans + 1
    assert radix_sort_columns.launches == sorts + 1
    for a, b in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        assert torch.equal(a.cpu(), b)
    assert int(want[2].sum()) == s
    hists = {dev: torch.zeros((1 << 2 * M) + 1, dtype=torch.int64,
                              device=dev) for dev in ("cuda", "cpu")}
    for dev, hist in hists.items():
        stage0_accum(codes.to(dev), hist, s=s, k=k, sig_len=M)
    assert torch.equal(hists["cuda"].cpu(), hists["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 2, 3])
def test_merge_count_bin_on_card_matches_plain(W):
    _need_card()
    from kmc_tpu_torch.ops.sortcount import merge_count_bin

    rng = np.random.default_rng(W)
    n = 1 << 20
    keys = rng.integers(0, n // 4, n)
    cols = [torch.from_numpy(((keys * 2654435761 + t) & 0xFFFFFFFF)
                             .astype(np.uint32).view(np.int32))
            for t in range(W)]
    counts = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    counts = torch.from_numpy(counts.view(np.int32))
    kw = dict(cutoff_min=1 << 28, cutoff_max=2**31, counter_max=255)
    before = radix_sort_columns.launches
    got = merge_count_bin([c.cuda() for c in cols], counts.cuda(), **kw)
    assert radix_sort_columns.launches == before + 1
    want = merge_count_bin(cols, counts, **kw)
    assert got[2] == want[2] and want[2][1] > 0 and want[2][2] > 0
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def _fastq(path, genome_len, n_reads, seed):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, st in enumerate(rng.integers(0, genome_len - 150, n_reads)):
            seq = acgt[genome[st:st + 150]].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * 150))
    return str(path)


@pytest.mark.gpu
@pytest.mark.parametrize("name,genome_len,kw", [
    ("kff_device", 20000, dict(output_file_type="KFF")),
    ("kff_replay", 20000, dict(output_file_type="KFF",
                               device_store_rows=1 << 15)),
    ("kff_host", 60000, dict(output_file_type="KFF",
                             device_store_rows=1 << 15)),
    ("w", 20000, dict(without_output=True)),
    ("smallk", 20000, dict(kmer_len=11)),
    ("smallk_kff", 20000, dict(kmer_len=13, output_file_type="KFF")),
    ("buckets", 20000, dict(device_store=False)),
    ("buckets_kff", 20000, dict(device_store=False, output_file_type="KFF")),
    ("estimate", 20000, dict(estimate_histogram_cfg="ONLY_ESTIMATE")),
    ("opt_out_size", 20000,
     dict(estimate_histogram_cfg="ESTIMATE_AND_COUNT_KMERS")),
])
def test_route_on_card_matches_cpu(tmp_path, name, genome_len, kw):
    """Each route of one device counts on the card as on the CPU: the same
    files byte for byte, the same results apart from times."""
    _need_card()
    import dataclasses

    from kmc_tpu_torch import (EstimateHistogramCfg, OutputFileType, Runner,
                               Stage1Params, Stage2Params)

    fq = _fastq(tmp_path / "in.fastq", genome_len, 4000, seed=2)
    kw = dict(kw)
    if "output_file_type" in kw:
        kw["output_file_type"] = OutputFileType[kw["output_file_type"]]
    if "estimate_histogram_cfg" in kw:
        kw["estimate_histogram_cfg"] = EstimateHistogramCfg[
            kw["estimate_histogram_cfg"]]
    times = {"time", "time_strict_mem", "time_finalize_exec",
             "time_finalize_d2h"}
    res = {}
    for dev in ("cuda", "cpu"):
        p1 = Stage1Params(input_files=[fq], kmer_len=27,
                          batch_positions=1 << 14)
        p2 = Stage2Params(output_file_name=str(tmp_path / dev), cutoff_min=2)
        for key, val in kw.items():
            setattr(p1 if hasattr(p1, key) else p2, key, val)
        r = Runner(device=dev)
        res[dev] = [{k: v for k, v in dataclasses.asdict(x).items()
                     if k not in times}
                    for x in (r.run_stage1(p1), r.run_stage2(p2))]
    assert res["cuda"] == res["cpu"]
    files = sorted(p.name[len("cpu"):] for p in tmp_path.glob("cpu.*"))
    assert files == sorted(p.name[len("cuda"):]
                           for p in tmp_path.glob("cuda.*"))
    for suf in files:
        assert (tmp_path / f"cuda{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes(), suf
    assert bool(files) == (name not in ("w", "estimate"))


def _bam(path, genome_len, n_reads, seed):
    """A BGZF BAM of 150 bp unmapped reads from a random genome, in
    members of 60,000 bytes (so the parallel inflate has blocks to share
    out)."""
    import struct
    import zlib

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    nib = np.array([1, 2, 4, 8], np.uint8)
    body = bytearray(b"BAM\x01" + struct.pack("<ii", 0, 0))
    for i, st in enumerate(rng.integers(0, genome_len - 150, n_reads)):
        seq = nib[genome[st:st + 150]]
        name = b"r%d\x00" % i
        rec = struct.pack("<iiBBHHHiiii", -1, -1, len(name), 0, 4680, 0, 4,
                          150, -1, -1, 0)
        rec += name + ((seq[0::2] << 4) | seq[1::2]).tobytes() + b"\xff" * 150
        body += struct.pack("<i", len(rec)) + rec
    with open(path, "wb") as f:
        for lo in range(0, len(body), 60000):
            payload = bytes(body[lo:lo + 60000])
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            comp = co.compress(payload) + co.flush()
            f.write(b"\x1f\x8b\x08\x04" + b"\x00" * 6 + b"\x06\x00BC\x02\x00"
                    + struct.pack("<H", len(comp) + 25) + comp
                    + struct.pack("<II", zlib.crc32(payload), len(payload)))
    return str(path)


def _kmc_input(tmp_path, fmt):
    """A -fbam input, or a -fkmc input: a k = 27 database counted on the
    CPU from a FASTQ."""
    from kmc_tpu_torch import count

    if fmt == "bam":
        return _bam(tmp_path / "in.bam", 20000, 4000, seed=3)
    fq = _fastq(tmp_path / "in.fastq", 20000, 4000, seed=3)
    count([fq], str(tmp_path / "src"), k=27, cutoff_min=1,
          batch_positions=1 << 14, device="cpu")
    return str(tmp_path / "src")


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,k", [("bam", 27), ("kmc", 27), ("kmc", 21)])
def test_input_on_card_matches_cpu(tmp_path, fmt, k):
    """-fbam and -fkmc count on the card as on the CPU.  -fkmc's batches
    (one separator per 28 codes) are too dense for the boundary-delta
    feed, so they take the packed+mask entry, all but the last, whose few
    records before the padding fit the delta list; -fbam's 150 bp reads
    take the boundary entry."""
    _need_card()
    from kmc_tpu_torch import InputFileType, count
    from kmc_tpu_torch.ops.ingest_kernel import ingest

    src = _kmc_input(tmp_path, fmt)
    kw = dict(k=k, cutoff_min=1, batch_positions=1 << 14,
              input_file_type=InputFileType(fmt))
    launches, mask = ingest.launches, ingest.mask_launches
    r_gpu = count([src], str(tmp_path / "gpu"), device="cuda", **kw)
    n, n_mask = ingest.launches - launches, ingest.mask_launches - mask
    r_cpu = count([src], str(tmp_path / "cpu"), device="cpu", **kw)
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"gpu{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes()
    assert r_gpu[1].n_total_kmers == r_cpu[1].n_total_kmers > 0
    assert r_gpu[0].n_sequences == r_cpu[0].n_sequences
    assert n >= 2
    if fmt == "kmc":
        assert n - 1 <= n_mask <= n
    else:
        assert n_mask == 0


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["bam", "kmc"])
def test_sharded_input_on_card_matches_cpu(tmp_path, fmt):
    _need_card()
    from kmc_tpu_torch import distributed_count

    src = _kmc_input(tmp_path, fmt)
    kw = dict(k=25, cutoff_min=1, batch_positions=1 << 14,
              capacity_rows_per_device=5 << 13, input_file_type=fmt)
    s_gpu = distributed_count([src], str(tmp_path / "gpu"),
                              devices=["cuda:0"] * 2, **kw)
    s_cpu = distributed_count([src], str(tmp_path / "cpu"),
                              devices=["cpu"] * 2, **kw)
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"gpu{suf}").read_bytes() == \
            (tmp_path / f"cpu{suf}").read_bytes()
    assert s_gpu["n_unique"] == s_cpu["n_unique"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k", [21, 27])
def test_fkmc_batch_takes_mask_entry(tmp_path, k):
    """A -fkmc batch has no boundary-delta form, and kmc_ingest_mask
    writes ingest_plain's rows and counters for it."""
    _need_card()
    from kmc_tpu_torch.io.native import (pack_codes_boundaries,
                                         pack_codes_fused)
    from kmc_tpu_torch.io.readers import BatchStream, ParseState
    from kmc_tpu_torch.ops.ingest_kernel import ingest
    from kmc_tpu_torch.runner import kmc_db_code_chunks

    s = 1 << 14
    chunks = kmc_db_code_chunks([_kmc_input(tmp_path, "kmc")], ParseState())
    feeds = []
    for batch in BatchStream(s, k).batches(chunks):
        assert pack_codes_boundaries(batch) == (None, -1)
        feeds.append((torch.from_numpy(pack_codes_fused(batch)), None))
        if len(feeds) == 2:
            break
    mask = ingest.mask_launches
    _check_ingest(k, True, s, 0, feeds, with_counts=True)
    assert ingest.mask_launches == mask + 2
