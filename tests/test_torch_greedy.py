"""The greedy signature -> bin map of the port's device store against
kmc_tpu's, on the CPU, byte for byte.

Counts with signature_map_policy="greedy", deferred (KMC_TPU_GREEDY_DEFER=1,
stage 0 folded into the ingest, the rows remapped and re-sorted at
finalize) and eager (stage 0 first, every batch binned through the map),
must write kmc_tpu's .kmc_pre / .kmc_suf (kmc_tpu with its tiled finalize
and without), and so must the spilling counts of both finalize routes, KFF
output, -w's results and checkpoints written by either package and resumed
by the other.  The twins of tests/test_greedy_defer.py (deferred == eager,
the recomputed signature == the splitter's) run on the port, and the fused
ingest's greedy entry and its histogram output (plain versions, what a CPU
store runs and what the kernel is held against on the card) against
kmc_tpu's _ingest_greedy_bounds / _fused and _stage0_accum_bounds /
_fused.  Integers throughout: no tolerance."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

from kmc_tpu.io.native import pack_codes_boundaries, pack_codes_fused  # noqa: E402
from kmc_tpu.ops import store as jax_store  # noqa: E402
from kmc_tpu.runner import OutputFileType as JaxOutputFileType  # noqa: E402
from kmc_tpu.runner import Runner as JaxRunner  # noqa: E402
from kmc_tpu.runner import Stage1Params as JaxStage1Params  # noqa: E402
from kmc_tpu.runner import Stage2Params as JaxStage2Params  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import OutputFileType, Runner, Stage1Params, \
    Stage2Params, count  # noqa: E402
from kmc_tpu_torch.io.readers import batch_len  # noqa: E402
from kmc_tpu_torch.ops.extract import sig_of_word_cols  # noqa: E402
from kmc_tpu_torch.ops.ingest_kernel import ingest, ingest_plain  # noqa: E402
from kmc_tpu_torch.ops import store as store_mod  # noqa: E402
from kmc_tpu_torch.ops.store import DeviceKmerStore, greedy_fuse  # noqa: E402
from kmc_tpu_torch.signatures import (build_signature_map,  # noqa: E402
                                      kmer_signatures_numpy, map_size,
                                      sig_of_lanes_numpy)

KMC = (".kmc_pre", ".kmc_suf")
MODES = {"deferred": "1", "eager": "0"}


def _same_db(a, b):
    for suf in KMC:
        assert Path(str(a) + suf).read_bytes() == \
            Path(str(b) + suf).read_bytes(), suf


def _both(fq, tmp_path, monkeypatch, mode, tag="", **kw):
    """The same greedy count by kmc_tpu and by the port (CPU); returns the
    port's (runner, stage-2 results) and kmc_tpu's stage-2 results."""
    monkeypatch.setenv("KMC_TPU_GREEDY_DEFER", MODES[mode])
    k = kw.pop("k")
    out = {}
    for pkg, make, P1, P2 in (
            ("jax", JaxRunner, JaxStage1Params, JaxStage2Params),
            ("torch", lambda: Runner(device="cpu"), Stage1Params,
             Stage2Params)):
        p1 = P1(input_files=[fq], kmer_len=k, signature_map_policy="greedy")
        p2 = P2(output_file_name=str(tmp_path / f"{pkg}{tag}"))
        for key, val in kw.items():
            if key == "output_file_type":
                val = (JaxOutputFileType if pkg == "jax"
                       else OutputFileType)[val]
            setattr(p1 if hasattr(p1, key) else p2, key, val)
        r = make()
        r.run_stage1(p1)
        out[pkg] = (r, r.run_stage2(p2))
    return out["torch"], out["jax"][1]


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    d = tmp_path_factory.mktemp("greedy")
    return write_fastq(d / "in.fastq", random_reads(150, 90, seed=27,
                                                    n_prob=0.003,
                                                    genome_len=3000))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("k", [21, 27, 33, 64])
def test_greedy_count_equals_kmc_tpu(fq, tmp_path, monkeypatch, mode, k):
    (r, res), jres = _both(fq, tmp_path, monkeypatch, mode, k=k,
                           cutoff_min=1, batch_positions=1 << 11)
    _same_db(tmp_path / "torch", tmp_path / "jax")
    assert res == jres or (res.n_unique_kmers, res.n_total_kmers) == (
        jres.n_unique_kmers, jres.n_total_kmers)
    assert r.spill_stats["finalize_route"] == "device"
    assert r._n_used_bins > 1 and res.n_unique_kmers > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_equals_kmc_tpu_nontiled(fq, tmp_path, monkeypatch, mode):
    """kmc_tpu's non-tiled finalize (the capacity-scale remap) writes the
    port's bytes too (test_greedy_count_equals_kmc_tpu holds its tiled
    one)."""
    monkeypatch.setenv("KMC_TPU_GREEDY_DEFER", MODES[mode])
    count([fq], str(tmp_path / "torch"), k=27, cutoff_min=1, device="cpu",
          batch_positions=1 << 11, signature_map_policy="greedy")
    monkeypatch.setenv("KMC_TPU_TILED_FINALIZE", "0")
    jax_count([fq], str(tmp_path / "jax_nontiled"), k=27, cutoff_min=1,
              batch_positions=1 << 11, signature_map_policy="greedy")
    _same_db(tmp_path / "torch", tmp_path / "jax_nontiled")


# genome length -> the finalize route of a 4096-row store with 1024-position
# batches (as tests/test_torch_spill.py)
ROUTES = {"host": 20000, "replay": 3400}


@pytest.fixture(scope="module")
def spill_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("gspill")
    return {route: write_fastq(d / f"{route}.fastq",
                               random_reads(400, 100, seed=3, n_prob=0.003,
                                            genome_len=glen))
            for route, glen in ROUTES.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_spilling_count(spill_reads, tmp_path, monkeypatch, mode,
                               route):
    (r, _), _ = _both(spill_reads[route], tmp_path, monkeypatch, mode, k=27,
                      cutoff_min=1, batch_positions=1 << 10,
                      device_store_rows=4096)
    _same_db(tmp_path / "torch", tmp_path / "jax")
    assert r.spill_stats["n_spills"] >= 2
    assert r.spill_stats["finalize_route"] == route
    # and the bytes of a store that never spills
    count([spill_reads[route]], str(tmp_path / "big"), k=27, device="cpu",
          cutoff_min=1, batch_positions=1 << 10, device_store_rows=1 << 16,
          signature_map_policy="greedy")
    _same_db(tmp_path / "torch", tmp_path / "big")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_host_route_completer(spill_reads, tmp_path, monkeypatch,
                                     mode):
    """Both modes complete their host route on the device a piece at a
    time: eager greedy each key range of the merge (its merge order is the
    output's), deferred greedy, which remaps and re-sorts across all merged
    key ranges, chunks of the host merge's groups uploaded back.  Both write
    kmc_tpu's bytes, cut into many pieces."""
    monkeypatch.setattr(store_mod, "_merge_rows", lambda *a, **kw: 2000)
    (r, _), _ = _both(spill_reads["host"], tmp_path, monkeypatch, mode, k=27,
                      cutoff_min=1, batch_positions=1 << 10,
                      device_store_rows=4096)
    _same_db(tmp_path / "torch", tmp_path / "jax")
    assert r.spill_stats["finalize_route"] == "host"
    ranges = r._count.counter("ranges", "kmc.host_completer")
    assert ranges >= 3
    assert r._count.calls("kmc.host_completer") == ranges + 1


def _kff_bytes(path):
    return Path(str(path) + ".kff").read_bytes()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("route", ["device", "host"])
def test_greedy_kff_and_w(fq, spill_reads, tmp_path, monkeypatch, mode,
                          route):
    """KFF output (one section per greedy bin) and -w's results, on the
    device route and through the host merge."""
    src, rows = ((fq, 1 << 16) if route == "device"
                 else (spill_reads["host"], 4096))
    kw = dict(k=27, cutoff_min=2, counter_max=100, batch_positions=1 << 10,
              device_store_rows=rows)
    (r, _), _ = _both(src, tmp_path, monkeypatch, mode,
                      output_file_type="KFF", **kw)
    assert _kff_bytes(tmp_path / "torch") == _kff_bytes(tmp_path / "jax")
    assert r.spill_stats["finalize_route"] == route
    (_, res), jres = _both(src, tmp_path, monkeypatch, mode, tag="_w",
                           without_output=True, **kw)
    got = (res.n_unique_kmers, res.n_below_cutoff_min,
           res.n_above_cutoff_max, res.n_total_kmers)
    assert got == (jres.n_unique_kmers, jres.n_below_cutoff_min,
                   jres.n_above_cutoff_max, jres.n_total_kmers)
    assert got[0] > got[1] > 0


PACKAGES = {
    "torch": (lambda: Runner(device="cpu"), Stage1Params, Stage2Params),
    "jax": (JaxRunner, JaxStage1Params, JaxStage2Params),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
@pytest.mark.parametrize("rows", [1 << 16, 4096], ids=["no_spill", "spilled"])
def test_greedy_checkpoint_across_packages(spill_reads, tmp_path,
                                           monkeypatch, mode, writer, reader,
                                           rows):
    """A greedy stage-1 checkpoint written by one package finishes in the
    other to the straight count's bytes, whatever KMC_TPU_GREEDY_DEFER says
    when it is resumed."""
    fq_ = spill_reads["replay"]
    kw = dict(kmer_len=27, signature_map_policy="greedy",
              batch_positions=1 << 10, device_store_rows=rows)
    monkeypatch.setenv("KMC_TPU_GREEDY_DEFER", MODES[mode])
    count([fq_], str(tmp_path / "straight"), k=27, device="cpu",
          cutoff_min=1, batch_positions=1 << 10,
          signature_map_policy="greedy")
    make, P1, P2 = PACKAGES[writer]
    r = make()
    r.run_stage1(P1(input_files=[fq_], **kw))
    assert (len(r._store.spilled) > 0) == (rows == 4096)
    ck = str(tmp_path / "ck")
    r.save_stage1_checkpoint(ck)
    data = np.load(ck + ".npz")
    assert str(data["map_mode"]) == "greedy"
    assert bool(data["greedy_defer"]) == (mode == "deferred")
    monkeypatch.setenv("KMC_TPU_GREEDY_DEFER",
                       MODES["eager" if mode == "deferred" else "deferred"])
    make, P1, P2 = PACKAGES[reader]
    r2 = make()
    r2.resume_stage1_checkpoint(ck, P1(input_files=[fq_], **kw))
    r2.run_stage2(P2(output_file_name=str(tmp_path / "resumed"),
                     cutoff_min=1))
    _same_db(tmp_path / "resumed", tmp_path / "straight")


def test_greedy_checkpoint_file_matches_kmc_tpu(fq, tmp_path, monkeypatch):
    """The port's deferred greedy checkpoint holds kmc_tpu's arrays."""
    paths = {}
    for pkg, (make, P1, _) in PACKAGES.items():
        monkeypatch.setenv("KMC_TPU_GREEDY_DEFER", "1")
        r = make()
        r.run_stage1(P1(input_files=[fq], kmer_len=27, batch_positions=1 << 10,
                        signature_map_policy="greedy"))
        paths[pkg] = str(tmp_path / pkg)
        r.save_stage1_checkpoint(paths[pkg])
    t, j = (np.load(paths[p] + ".npz") for p in ("torch", "jax"))
    for key in ("cols", "counts", "occ", "skm", "k", "sig_len",
                "both_strands", "n_used_bins", "prefix_bits", "map_mode",
                "greedy_defer", "sig_map", "spilled"):
        assert np.array_equal(t[key], j[key]), key


# -- twins of tests/test_greedy_defer.py on the port --

def _port_db(fq_, out, monkeypatch, mode, **kw):
    monkeypatch.setenv("KMC_TPU_GREEDY_DEFER", MODES[mode])
    count([fq_], str(out), device="cpu", signature_map_policy="greedy",
          cutoff_min=1, **kw)


@pytest.mark.parametrize("k", [21, 27, 33, 64])
def test_defer_bytes_equal_eager(tmp_path, monkeypatch, k):
    fq_ = write_fastq(tmp_path / "in.fastq",
                      random_reads(150, 90, seed=k, genome_len=3000))
    for mode in MODES:
        _port_db(fq_, tmp_path / mode, monkeypatch, mode, k=k,
                 batch_positions=1 << 11)
    _same_db(tmp_path / "deferred", tmp_path / "eager")


def test_defer_bytes_equal_eager_with_spills(tmp_path, monkeypatch):
    fq_ = write_fastq(tmp_path / "in.fastq",
                      random_reads(120, 100, seed=7, genome_len=6000))
    for mode in MODES:
        _port_db(fq_, tmp_path / mode, monkeypatch, mode, k=21,
                 batch_positions=512, device_store_rows=2048)
    _same_db(tmp_path / "deferred", tmp_path / "eager")


@pytest.mark.parametrize("k,sig_len", [(21, 9), (27, 9), (33, 7), (64, 11)])
def test_sig_recompute_matches_splitter(k, sig_len):
    """sig_of_word_cols (the deferred remap on the device) and
    sig_of_lanes_numpy (the host route's) equal the splitter's signature
    of each k-mer, read off its own canonical lanes."""
    rng = np.random.default_rng(k + sig_len)
    W = (k + 15) // 16
    n = 300
    lanes = np.zeros((n, W), np.uint32)
    sigs_ref = np.zeros(n, np.uint32)
    for i in range(n):
        codes = rng.integers(0, 4, k).astype(np.uint8)
        rc = (3 - codes)[::-1]
        canon = min(tuple(codes), tuple(rc))
        v = 0
        for c in canon:
            v = (v << 2) | int(c)
        for t in range(W - 1, -1, -1):
            lanes[i, t] = v & 0xFFFFFFFF
            v >>= 32
        sigs_ref[i] = kmer_signatures_numpy(codes, k, sig_len)[0]
    got = sig_of_word_cols([torch.from_numpy(lanes[:, t].astype(np.int64))
                            for t in range(W)], k=k, sig_len=sig_len)
    np.testing.assert_array_equal(got.numpy(), sigs_ref)
    np.testing.assert_array_equal(sig_of_lanes_numpy(lanes, k, sig_len),
                                  sigs_ref)


# -- the greedy entry and the histogram output of the fused ingest --

M, S, N0 = 9, 1000, 37


def _codes(k, seed, tail=0, dense=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, batch_len(S, k)).astype(np.uint8)
    if dense:
        codes[rng.random(len(codes)) < 0.25] = 4
    else:
        codes[rng.integers(0, 150)::151] = 4
    if tail:
        codes[-tail:] = 4
    return codes


def _greedy_map(seed, m=M):
    """A greedy map of 512 bins from a random histogram over 3000 of the
    signatures (a dense uniform one takes build_signature_map's skip-scan
    about a minute)."""
    rng = np.random.default_rng(seed)
    hist = np.zeros(map_size(m), np.uint64)
    hist[rng.integers(0, map_size(m), 3000)] = rng.integers(1, 1000, 3000)
    return build_signature_map(hist, m, 512)


@pytest.mark.parametrize("k", [14, 27, 33, 55])
def test_greedy_entry_plain_matches_kmc_tpu(k):
    """Two batches (boundary-delta with a tail, then sentinel-dense
    packed+mask) through kmc_tpu's _ingest_greedy_bounds / _fused and the
    port's ingest_plain with the same map: the same key columns, totals
    and prev_sig; and the same histogram as _stage0_accum_bounds /
    _fused."""
    sig_map = _greedy_map(k)
    n_used_bins = int(sig_map.max()) + 1
    fuse = greedy_fuse(k, n_used_bins)
    dev_map = np.where(sig_map < 0, n_used_bins, sig_map).astype(np.int32)
    W = (k + 15) // 16
    n_cols = W if fuse else W + 1
    cap = N0 + 2 * S + 16
    rng = np.random.default_rng(k)
    cols = [np.full(cap, 0xFFFFFFFF, np.uint32) for _ in range(n_cols)]
    for c in cols:
        c[:N0] = rng.integers(0, 2**32, N0, dtype=np.uint32)
    j_cols = tuple(jnp.asarray(c) for c in cols)
    j_state = [jnp.int32(N0), jnp.zeros(2, jnp.uint32),
               jnp.zeros(2, jnp.uint32), jnp.full((1,), 0xFFFFFFFF,
                                                  jnp.uint32)]
    j_hist = jnp.zeros(map_size(M), jnp.uint32)
    t_cols = [torch.from_numpy(c.view(np.int32).copy()) for c in cols]
    occ = torch.zeros((), dtype=torch.int64)
    skm = torch.zeros((), dtype=torch.int64)
    prev = torch.full((1,), -1, dtype=torch.int32)
    t_map = torch.from_numpy(dev_map)
    t_hist = torch.zeros(map_size(M), dtype=torch.int32)
    statics = dict(s=S, k=k, sig_len=M, both_strands=True, map_mode="greedy",
                   prefix_bits=0, fuse=fuse, n_dead_bin=n_used_bins,
                   extract_mode="xla")
    n_used = N0
    for codes, kind in ((_codes(k, k + 1, tail=29), "b"),
                        (_codes(k, k + 2, dense=True), "m")):
        if kind == "b":
            buf, ts = pack_codes_boundaries(codes)
            out = jax_store._ingest_greedy_bounds(
                jnp.asarray(buf), jnp.int32(ts), j_cols, *j_state,
                jnp.asarray(dev_map), **statics)
            j_hist = jax_store._stage0_accum_bounds(
                jnp.asarray(buf), jnp.int32(ts), j_hist, s=S, k=k, sig_len=M)
        else:
            buf, ts = pack_codes_fused(codes), None
            out = jax_store._ingest_greedy_fused(
                jnp.asarray(buf), j_cols, *j_state, jnp.asarray(dev_map),
                **statics)
            j_hist = jax_store._stage0_accum_fused(
                jnp.asarray(buf), j_hist, s=S, k=k, sig_len=M)
        j_cols, j_state = out[0], list(out[1:])
        prev = ingest_plain(torch.from_numpy(buf), ts, t_cols, None, n_used,
                            occ, skm, prev, s=S, k=k, sig_len=M,
                            both_strands=True, prefix_bits=0, fuse=fuse,
                            sig_map=t_map, hist=t_hist)
        n_used += S
        for got, want in zip(t_cols, j_cols):
            assert np.array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
        acc = [np.asarray(a).astype(np.uint64) for a in j_state[1:3]]
        assert int(occ) == int(acc[0][0]) + (int(acc[0][1]) << 32)
        assert int(skm) == int(acc[1][0]) + (int(acc[1][1]) << 32)
        assert prev.numpy().view(np.uint32)[0] == np.asarray(j_state[3])[0]
        assert np.array_equal(t_hist.numpy().view(np.uint32),
                              np.asarray(j_hist))
    assert int(t_hist.sum()) == int(occ) > 0


def test_greedy_entry_wrapper_checks_and_counts():
    """On the CPU the wrapper takes the plain version (no launch is
    counted) and refuses a map or a histogram of the wrong shape."""
    k = 27
    sig_map = _greedy_map(1)
    nb = int(sig_map.max()) + 1
    fuse = greedy_fuse(k, nb)
    t_map = torch.from_numpy(np.where(sig_map < 0, nb, sig_map).astype(
        np.int32))
    buf, ts = pack_codes_boundaries(_codes(k, 5))
    cols = [torch.full((S,), -1, dtype=torch.int32)
            for _ in range(2 if fuse else 3)]
    state = (torch.zeros((), dtype=torch.int64),
             torch.zeros((), dtype=torch.int64),
             torch.full((1,), -1, dtype=torch.int32))
    kw = dict(s=S, k=k, sig_len=M, both_strands=True, prefix_bits=0,
              fuse=fuse)
    before = (ingest.launches, ingest.greedy_launches, ingest.hist_launches)
    hist = torch.zeros(map_size(M), dtype=torch.int32)
    ingest(torch.from_numpy(buf), ts, cols, None, 0, *state, sig_map=t_map,
           hist=hist, **kw)
    assert (ingest.launches, ingest.greedy_launches,
            ingest.hist_launches) == before
    assert int(hist.sum()) == int(state[0])
    with pytest.raises(ValueError, match="sig_map"):
        ingest(torch.from_numpy(buf), ts, cols, None, 0, *state,
               sig_map=t_map[:-1], **kw)
    with pytest.raises(ValueError, match="hist"):
        ingest(torch.from_numpy(buf), ts, cols, None, 0, *state,
               hist=hist.to(torch.int64), **kw)


def test_fold_histogram_equals_stage0(fq, monkeypatch):
    """A deferred store's folded histogram over a run's first batches
    builds kmc_tpu's map: the port's Runner and kmc_tpu's write the same
    .kmc_pre footer, and a store given no map refuses to finalize."""
    st = DeviceKmerStore(1 << 12, k=27, sig_len=M, both_strands=True,
                         n_bins=512, map_mode="greedy", greedy_defer=True,
                         device="cpu")
    with pytest.raises(RuntimeError, match="set_sig_map"):
        st.finalize_records(cutoff_min=1, cutoff_max=10**9, counter_max=255,
                            lut_prefix_len=4, counter_size=1)
    with pytest.raises(ValueError, match="eager"):
        DeviceKmerStore(1 << 12, k=27, sig_len=M, both_strands=True,
                        n_bins=512, map_mode="greedy", greedy_defer=False,
                        device="cpu")
    # a sample cap of one batch: the map comes from batch 0 alone
    monkeypatch.setenv("KMC_TPU_STAGE0_SAMPLE_POSITIONS", str(1 << 10))
    monkeypatch.setenv("KMC_TPU_GREEDY_DEFER", "1")
    maps = []
    for make, P1 in ((lambda: Runner(device="cpu"), Stage1Params),
                     (JaxRunner, JaxStage1Params)):
        r = make()
        r.run_stage1(P1(input_files=[fq], kmer_len=27,
                        batch_positions=1 << 10,
                        signature_map_policy="greedy"))
        maps.append(np.asarray(r._sig_map))
    assert np.array_equal(maps[0], maps[1])
