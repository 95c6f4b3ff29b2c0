"""The writer half of the port's streaming module (formats/streaming.py:
the KMC1 stream writer, the key-stream merges and the stream_* operations)
and the delegation of its tools to it, against its in-memory tools and
against kmc_tpu's, on the CPU: the twins of tests/test_streaming.py's
writer cases.  Every output is compared byte for byte.  The two RSS-capped
unions run the port in a child process with neither torch nor jax
loaded."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import kmc_tpu.formats.streaming as ref_streaming  # noqa: E402
from kmc_tpu.tools import db_ops as ref_db_ops  # noqa: E402
from kmc_tpu_torch import count  # noqa: E402
from kmc_tpu_torch.formats import streaming  # noqa: E402
from kmc_tpu_torch.formats.dump import dump_db_file  # noqa: E402
from kmc_tpu_torch.formats.kff import KffWriter, read_kff, \
    read_kff_meta  # noqa: E402
from kmc_tpu_torch.formats.kmc_db import DbInfo, read_pre_meta, \
    write_kmc1_db  # noqa: E402
from kmc_tpu_torch.tools import db_ops  # noqa: E402
from kmc_tpu_torch.tools import native_tools  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
KMC = (".kmc_pre", ".kmc_suf")

_CHILD_CHECK = """
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "kmc_tpu"))
assert not loaded, loaded
"""


def _same(a: str, b: str, sufs=KMC):
    for suf in sufs:
        assert Path(a + suf).read_bytes() == Path(b + suf).read_bytes(), \
            (a, b, suf)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Two KMC2 databases counted by the port on the CPU."""
    d = tmp_path_factory.mktemp("sdbs")
    out = []
    for i, seed in enumerate((3, 4)):
        inp = write_fastq(d / f"in{i}.fastq",
                          random_reads(300, 100, seed=seed, genome_len=4000))
        db = str(d / f"db{i}")
        count([inp], db, k=21, cutoff_min=1, batch_positions=1 << 12,
              device="cpu")
        out.append(db)
    return out


@pytest.mark.parametrize("op,mode", [
    ("union", "sum"), ("union", "min"), ("union", "max"),
    ("intersect", "min"), ("intersect", "sum"),
    ("kmers_subtract", None), ("counters_subtract", "diff"),
    ("reverse_kmers_subtract", None),
])
def test_stream_ops_match_inmemory(dbs, tmp_path, op, mode):
    db1, db2 = dbs
    out_m, out_s, out_r = (str(tmp_path / f"{t}_{op}_{mode}")
                           for t in ("m", "s", "r"))
    db_ops.run_simple_op(op, db1, db2, out_m, mode=mode)
    streaming.stream_simple_op(op, db1, db2, out_s, mode=mode,
                               block_records=97)
    ref_streaming.stream_simple_op(op, db1, db2, out_r, mode=mode,
                                   block_records=97)
    _same(out_m, out_s)
    _same(out_m, out_r)


def test_stream_dump_matches(dbs, tmp_path):
    p, r = tmp_path / "dump.txt", tmp_path / "ref.txt"
    streaming.stream_dump(dbs[0], str(p), block_records=50)
    ref_streaming.stream_dump(dbs[0], str(r), block_records=50)
    assert p.read_text() == dump_db_file(dbs[0]) == r.read_text()


def test_streaming_kmc1_writer_and_merge(dbs, tmp_path):
    """StreamingKmc1Writer over the windows of merge_key_streams (the
    union's key blocks, block by block) writes the in-memory union's
    database, and kmc_tpu's writer over its own merge the same bytes."""
    db1, db2 = dbs
    out_m = str(tmp_path / "u_mem")
    db_ops.run_simple_op("union", db1, db2, out_m)
    info = read_pre_meta(out_m)[0]
    for mod, tag in ((streaming, "port"), (ref_streaming, "ref")):
        r1, r2 = (mod.DbStreamReader(db, block_records=64)
                  for db in (db1, db2))
        w = mod.StreamingKmc1Writer(str(tmp_path / f"u_{tag}"), info)
        with r1, r2:
            for keys, counts in mod.merge_key_streams(
                    r1.key_blocks(), r2.key_blocks(), "union", "sum"):
                w.put_block(mod._kmers_of(keys, (info.kmer_len + 3) // 4),
                            np.minimum(counts, 255))
        w.close()
    _same(out_m, str(tmp_path / "u_port"))
    _same(out_m, str(tmp_path / "u_ref"))


def test_streaming_union_bounded_rss(tmp_path):
    """The port's twin of tests/test_streaming.py's: a union of two 12 M-row
    databases streams under a 450 MB RLIMIT_AS that the in-memory union
    cannot meet, with neither torch nor jax loaded, and writes the bytes of
    the in-memory union."""
    native_tools.get_lib()  # built here: the child's cap would stop g++
    k, kb = 25, 7
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        kmers = rng.integers(0, 256, size=(12_000_000, kb), dtype=np.uint8)
        kmers[:, 0] &= 0x03
        kmers = kmers[np.lexsort(tuple(kmers[:, j]
                                       for j in range(kb - 1, -1, -1)))]
        dup = np.ones(len(kmers), bool)
        dup[1:] = (kmers[1:] != kmers[:-1]).any(axis=1)
        kmers = kmers[dup]
        counts = rng.integers(1, 200, size=len(kmers)).astype(np.uint32)
        p = str(tmp_path / f"big{i}")
        write_kmc1_db(p, DbInfo(kmer_len=k, counter_size=1, lut_prefix_len=5,
                                cutoff_min=1, cutoff_max=10**9), kmers, counts)
        paths.append(p)
        del kmers, counts
    out = str(tmp_path / "u_stream")
    script = f"""
import resource, sys
resource.setrlimit(resource.RLIMIT_AS, (450 << 20, 450 << 20))
sys.path.insert(0, {str(REPO)!r})
from kmc_tpu_torch.formats.streaming import stream_simple_op
print("records:", stream_simple_op("union", {paths[0]!r}, {paths[1]!r},
                                   {out!r}, block_records=1 << 15))
""" + _CHILD_CHECK
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    script_mem = f"""
import os, resource, sys
resource.setrlimit(resource.RLIMIT_AS, (450 << 20, 450 << 20))
os.environ["KMC_TPU_STREAM_THRESHOLD"] = str(1 << 60)
os.environ["KMC_TPU_NATIVE_TOOLS"] = "0"
sys.path.insert(0, {str(REPO)!r})
from kmc_tpu_torch.tools.db_ops import run_simple_op
try:
    run_simple_op("union", {paths[0]!r}, {paths[1]!r}, {out!r} + "_m")
except MemoryError:
    sys.exit(0)
sys.exit(3)
"""
    r2 = subprocess.run([sys.executable, "-c", script_mem],
                        capture_output=True, text=True, timeout=600)
    assert r2.returncode == 0, ("the in-memory union fit under the cap\n"
                                + r2.stdout + r2.stderr)
    out_m = str(tmp_path / "u_mem")
    db_ops.run_simple_op("union", paths[0], paths[1], out_m)
    _same(out_m, out)


def test_run_simple_op_delegates_to_streaming(dbs, tmp_path, monkeypatch):
    db1, db2 = dbs
    out_m = str(tmp_path / "deleg_m")
    db_ops.run_simple_op("union", db1, db2, out_m)
    monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", "0")
    monkeypatch.setenv("KMC_TPU_NATIVE_TOOLS", "0")
    called = []
    orig = streaming.stream_simple_op

    def spy(*a, **k):
        called.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(streaming, "stream_simple_op", spy)
    out_s, out_r = str(tmp_path / "deleg_s"), str(tmp_path / "deleg_r")
    db_ops.run_simple_op("union", db1, db2, out_s)
    ref_db_ops.run_simple_op("union", db1, db2, out_r)
    assert called, "streaming path not taken"
    _same(out_m, out_s)
    _same(out_m, out_r)


def test_transform_dump_delegates_to_streaming(dbs, tmp_path, monkeypatch):
    p_m, p_s, p_r = (tmp_path / f"d_{t}.txt" for t in "msr")
    db_ops.transform_dump(dbs[0], str(p_m))
    monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", "0")
    db_ops.transform_dump(dbs[0], str(p_s))
    ref_db_ops.transform_dump(dbs[0], str(p_r))
    assert p_m.read_text() == p_s.read_text() == p_r.read_text()


@pytest.mark.parametrize("which", ["sort", "compact", "set_counts",
                                   "histogram", "compare"])
def test_stream_transforms_match_inmemory(dbs, tmp_path, monkeypatch, which):
    db1, db2 = dbs

    def run(mod, out):
        if which == "sort":
            mod.transform_sort(db1, out)
        elif which == "compact":
            mod.transform_compact(db1, out)
        elif which == "set_counts":
            mod.transform_set_counts(db1, out, 9)
        elif which == "histogram":
            mod.transform_histogram(db1, out + ".txt")
        else:
            return mod.db_compare(db1, db1), mod.db_compare(db1, db2)

    out_m, out_s, out_r = (str(tmp_path / f"t{t}_{which}") for t in "msr")
    r_m = run(db_ops, out_m)
    monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", "0")
    r_s = run(db_ops, out_s)
    r_r = run(ref_db_ops, out_r)
    if which == "compare":
        assert r_m == r_s == r_r == (True, False)
    elif which == "histogram":
        _same(out_m, out_s, [".txt"])
        _same(out_m, out_r, [".txt"])
    else:
        _same(out_m, out_s)
        _same(out_m, out_r)


def test_simple_op_preserves_both_strands(tmp_path, monkeypatch):
    inp = write_fastq(tmp_path / "ss.fastq", random_reads(60, 80, seed=50))
    db1, db2 = str(tmp_path / "ss1"), str(tmp_path / "ss2")
    for db in (db1, db2):
        count([inp], db, k=21, cutoff_min=1, batch_positions=1 << 12,
              canonical_kmers=False, device="cpu")
    outs = []
    for thr, tag in (("99999999999", "mem"), ("0", "stream")):
        monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", thr)
        out = str(tmp_path / f"ss_u_{tag}")
        db_ops.run_simple_op("union", db1, db2, out)
        assert read_pre_meta(out)[0].both_strands is False, tag
        outs.append(out)
    _same(*outs)


def test_stream_set_counts_zero_matches_inmemory(dbs, tmp_path,
                                                 monkeypatch):
    out_m, out_s, out_r = (str(tmp_path / f"sc0_{t}") for t in "msr")
    db_ops.transform_set_counts(dbs[0], out_m, 0)
    monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", "0")
    db_ops.transform_set_counts(dbs[0], out_s, 0)
    ref_db_ops.transform_set_counts(dbs[0], out_r, 0)
    _same(out_m, out_s)
    _same(out_m, out_r)


def test_unsorted_kff_streams_via_external_sort(dbs, tmp_path, monkeypatch):
    db1 = dbs[0]
    info, kmers, counts = db_ops.load_sorted(db1)
    kf = str(tmp_path / "unsorted.kff")
    w = KffWriter(kf, canonical=True, k=info.kmer_len, counter_size=2,
                  min_count=1, max_count=255)
    w.store_section(kmers[::-1], counts[::-1])
    w.close()
    raw = bytearray(open(kf, "rb").read())
    i = raw.index(b"ordered\x00")
    raw[i + 8:i + 16] = (0).to_bytes(8, "big")
    open(kf, "wb").write(bytes(raw))
    assert read_kff_meta(kf).ordered is False
    with streaming.DbStreamReader(kf, block_records=64) as r:
        parts = list(r.blocks())
    assert np.array_equal(np.concatenate([p[0] for p in parts]), kmers)
    assert np.array_equal(np.concatenate([p[1] for p in parts]), counts)
    monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", "0")
    assert db_ops.db_compare(kf, db1) is True
    out, out_r = str(tmp_path / "unsorted_union"), str(tmp_path / "ref")
    db_ops.run_simple_op("union", kf, db1, out, mode="max")
    ref_db_ops.run_simple_op("union", kf, db1, out_r, mode="max")
    _same(out, out_r)
    _, k_u, c_u = db_ops.load_sorted(out)
    assert np.array_equal(k_u, kmers) and np.array_equal(c_u, counts)


def _blocks(rng, n_blocks, k, lo, hi, max_count):
    return [(rng.integers(0, 4, k + n - 1).astype(np.uint8),
             rng.integers(1, max_count, n).astype(np.uint32))
            for n in (int(rng.integers(lo, hi)) for _ in range(n_blocks))]


def test_block_kff_streams_via_external_sort(tmp_path):
    """The port's store_block_section writes kmc_tpu's bytes, and a block
    section streams record for record as the in-memory read does."""
    from kmc_tpu.formats.kff import KffWriter as RefKffWriter

    rng = np.random.default_rng(5)
    k, kb = 21, 6
    blocks = _blocks(rng, 200, k, 1, 9, 60000)
    tail = rng.integers(0, 4, (9, kb * 4)).astype(np.uint8)
    tail[:, :kb * 4 - k] = 0
    tail_rows = ((tail[:, 0::4] << 6) | (tail[:, 1::4] << 4)
                 | (tail[:, 2::4] << 2) | tail[:, 3::4]).astype(np.uint8)
    tail_counts = rng.integers(1, 100, 9).astype(np.uint32)
    paths = []
    for cls, tag in ((KffWriter, "port"), (RefKffWriter, "ref")):
        p = str(tmp_path / f"blocks_{tag}.kff")
        w = cls(p, canonical=True, k=k, counter_size=2, min_count=1,
                max_count=1 << 30)
        w.store_block_section(blocks)
        w.store_section(tail_rows, tail_counts)
        w.close()
        paths.append(p)
    assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()
    kf = read_kff(paths[0])
    order = np.lexsort(tuple(kf.kmers[:, j] for j in range(kb - 1, -1, -1)))
    with streaming.DbStreamReader(paths[0], block_records=128) as r:
        assert r.info.n_unique_stored == len(order)
        parts = list(r.blocks())
    assert np.array_equal(np.concatenate([p[0] for p in parts]),
                          kf.kmers[order])
    assert np.array_equal(np.concatenate([p[1] for p in parts]),
                          kf.counts[order])


def test_block_kff_union_bounded_rss(tmp_path):
    """The port's twin of tests/test_streaming.py's: a block-section KFF of
    ~2.6 M k-mers flows through a union under a 500 MB RLIMIT_AS, with
    neither torch nor jax loaded, byte-identical to the in-memory path."""
    native_tools.get_lib()
    rng = np.random.default_rng(1)
    k, kb = 25, 7
    p_kff = str(tmp_path / "big_blocks.kff")
    w = KffWriter(p_kff, canonical=True, k=k, counter_size=1, min_count=1,
                  max_count=255)
    for _ in range(40):
        w.store_block_section(_blocks(rng, 10_000, k, 2, 12, 200))
    w.close()
    kmers2 = rng.integers(0, 256, size=(50_000, kb), dtype=np.uint8)
    kmers2[:, 0] &= 0x03
    kmers2 = kmers2[np.lexsort(tuple(kmers2[:, j]
                                     for j in range(kb - 1, -1, -1)))]
    dup = np.ones(len(kmers2), bool)
    dup[1:] = (kmers2[1:] != kmers2[:-1]).any(axis=1)
    kmers2 = kmers2[dup]
    p_db = str(tmp_path / "small")
    write_kmc1_db(p_db, DbInfo(kmer_len=k, counter_size=1, lut_prefix_len=5,
                               cutoff_min=1, cutoff_max=10**9), kmers2,
                  rng.integers(1, 200, size=len(kmers2)).astype(np.uint32))
    out = str(tmp_path / "u_stream")
    script = f"""
import resource, sys
resource.setrlimit(resource.RLIMIT_AS, (500 << 20, 500 << 20))
sys.path.insert(0, {str(REPO)!r})
from kmc_tpu_torch.formats.streaming import stream_simple_op
print("records:", stream_simple_op("union", {p_kff!r}, {p_db!r}, {out!r},
                                   block_records=1 << 15))
""" + _CHILD_CHECK
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    out_m = str(tmp_path / "u_mem")
    db_ops.run_simple_op("union", p_kff, p_db, out_m)
    _same(out_m, out)
