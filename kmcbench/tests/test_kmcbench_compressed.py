"""Compressed input: the traffic's FASTQ written as one gzip member or as
BGZF (kmcbench/compress.py) inflates to exactly the plain file's bytes,
in the form each route of the port's reader expects; the harness writes
it where the traffic mix says so and counts it correctly on the CPU,
plain FASTQ byte for byte as before; and input_read_s reads the busiest
pool thread's read seconds from the program's spans."""
import gzip
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from kmc_tpu_torch import trace
from kmc_tpu_torch.io import readers
from kmcbench import compress, harness, reads
from kmcbench.conftest import small_cell
from kmcbench.harness import Job, Run, load_cell, load_reader
from kmcbench.reads import Sample, write_fastq

SEED = 2**37 + 11  # seeds may pass 32 bits


def sample(**kw):
    """About 4.4 MB of FASTQ: four PIECEs and a part of one."""
    base = dict(genome_bp=1 << 16, coverage=32, read_len=150,
                substitution_rate=0.0024, reverse_share=0.5)
    return Sample(**{**base, **kw})


def old_write_fastq(path, s, seed, device):
    """write_fastq as it was before compression: the plain file."""
    with open(path, "wb") as f:
        for first, codes in reads.read_blocks(s, seed, device):
            reads.fastq_block(first, codes).cpu().numpy().tofile(f)


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    path = tmp_path_factory.mktemp("plain") / "reads.fastq"
    n = write_fastq(path, sample(), SEED, "cpu")
    data = path.read_bytes()
    assert n == len(data) > 4 * compress.PIECE
    return data


def written(tmp_path, kind, name="reads.fastq.gz", s=None):
    path = tmp_path / name
    n = write_fastq(path, s or sample(), SEED, "cpu", kind)
    return path, n


def members(raw: bytes) -> list:
    """Each BGZF member's (BSIZE field + 1, its bytes), walked by the
    field."""
    out, pos = [], 0
    while pos < len(raw):
        assert raw[pos:pos + 16] == compress.BGZF_HEAD
        (bsize_1,) = struct.unpack_from("<H", raw, pos + 16)
        out.append((bsize_1 + 1, raw[pos:pos + bsize_1 + 1]))
        pos += bsize_1 + 1
    assert pos == len(raw)
    return out


def test_gzip_is_one_member_of_the_plain_bytes(tmp_path, plain):
    path, n = written(tmp_path, "gzip")
    raw = path.read_bytes()
    assert n == len(plain)
    assert gzip.decompress(raw) == plain
    d = zlib.decompressobj(wbits=31)
    assert d.decompress(raw) == plain
    assert d.eof and d.unused_data == b""
    # no FEXTRA: no BC subfield for the port to split at
    assert raw[:10] == compress.GZIP_HEADER and raw[3] & 4 == 0
    assert readers._bgzf_file_shards(str(path), "fastq", 16, 1 << 10) is None
    assert readers._file_shards(str(path), "fastq", 8,
                                min_shard_bytes=1 << 10) == [(0, -1)]


def test_bgzf_members_and_record_aligned_shards(tmp_path, plain):
    path, n = written(tmp_path, "bgzf")
    raw = path.read_bytes()
    assert n == len(plain) and gzip.decompress(raw) == plain
    assert raw[-28:] == compress.BGZF_EOF and len(compress.BGZF_EOF) == 28
    got = []
    for bsize, member in members(raw):
        assert len(member) == bsize <= 1 << 16
        data = zlib.decompress(member, wbits=31)
        (isize,) = struct.unpack_from("<I", member, len(member) - 4)
        assert len(data) == isize <= compress.BGZF_BLOCK
        got.append(data)
    assert b"".join(got) == plain
    # every member full but the last and the empty end-of-file one
    assert {len(g) for g in got[:-2]} == {compress.BGZF_BLOCK}
    assert got[-1] == b""
    shards = readers._bgzf_file_shards(str(path), "fastq", 16, 1 << 16)
    assert shards is not None and len(shards) > 1
    parts = []
    for shard, _ in shards:
        r = readers.BgzfShardReader(str(path), shard)
        out = bytearray()
        buf = np.empty(1 << 20, dtype=np.uint8)
        while n := r.read_into(buf):
            out += buf[:n].tobytes()
        r.close()
        assert out[:1] == b"@"  # each shard starts at a record
        parts.append(bytes(out))
    assert b"".join(parts) == plain


@pytest.mark.parametrize("kind", compress.KINDS)
def test_same_seed_same_file(tmp_path, kind):
    a, _ = written(tmp_path, kind, "a.fastq.gz")
    b, _ = written(tmp_path, kind, "b.fastq.gz")
    assert a.read_bytes() == b.read_bytes()
    c, _ = written(tmp_path, kind, "c.fastq.gz", sample(coverage=33))
    assert c.read_bytes() != a.read_bytes()


@pytest.mark.parametrize("kind", compress.KINDS)
def test_pieces_are_cut_at_fixed_offsets(tmp_path, kind, plain):
    """Written in writes of odd sizes, the file is the one written whole:
    the pieces lie where the stream's offsets put them."""
    whole, _ = written(tmp_path, kind, "whole.fastq.gz")
    sizes = [7, 777_777, 1 << 21, compress.BGZF_BLOCK]
    with compress.Writer(tmp_path / "odd.fastq.gz", kind) as w:
        lo = 0
        for i in range(len(plain)):
            if lo >= len(plain):
                break
            w.write(plain[lo:lo + sizes[i % 4]])
            lo += sizes[i % 4]
    assert w.size == len(plain)
    assert (tmp_path / "odd.fastq.gz").read_bytes() == whole.read_bytes()


def test_no_key_writes_the_plain_file_as_before(tmp_path):
    s = load_cell("isolate_k27.fastq100x")
    assert s.compression is None
    new, old = tmp_path / "new.fastq", tmp_path / "old.fastq"
    write_fastq(new, sample(), SEED, "cpu")
    old_write_fastq(old, sample(), SEED, "cpu")
    assert new.read_bytes() == old.read_bytes()


def test_new_cells_name_their_compression():
    assert load_cell("isolate_k27.fastq100x_gz").compression == "gzip"
    assert load_cell("isolate_k27.fastq100x_bgzf").compression == "bgzf"


def test_unknown_compression_stops_the_run(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    base = small_cell()
    cell = harness.Cell("bad", base.config,
                        dict(base.traffic, compression="zstd"))
    with pytest.raises(SystemExit, match="'zstd'"):
        harness.run_cell(cell, SEED, 0.1, False, device="cpu",
                         log=lambda m: None)
    assert not list(tmp_path.rglob("reads.fastq*"))  # stopped before input


def _compressed_cell(kind):
    base = small_cell()
    traffic = dict(base.traffic)
    if kind is not None:
        traffic.update(compression=kind)
    return harness.Cell("small_" + str(kind), base.config, traffic, 1,
                        base.end_to_end, base.per_layer)


@pytest.mark.parametrize("kind", (None,) + compress.KINDS)
def test_small_cell_counts_correctly(monkeypatch, kind):
    """Each compression through run_cell on the CPU, the port's split
    floor lowered so that the small BGZF file takes the sharded route."""
    files, splits, lines = [], [], []
    write = harness.write_fastq

    def spy_write(path, *args):
        files.append(path.name)
        n = write(path, *args)
        if kind is None:
            old = path.with_name("old.fastq")
            old_write_fastq(old, *args[:3])
            assert old.read_bytes() == path.read_bytes()
        return n

    file_shards = readers._file_shards

    def spy_shards(path, fmt, n_threads, min_shard_bytes=32 << 20):
        ranges = file_shards(path, fmt, n_threads, min_shard_bytes=1 << 14)
        splits.append(ranges)
        return ranges

    monkeypatch.setattr(harness, "write_fastq", spy_write)
    monkeypatch.setattr(readers, "_file_shards", spy_shards)
    res = harness.run_cell(_compressed_cell(kind), SEED, 0.3, False,
                           device="cpu", log=lines.append)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["kind"] == "cpu"
    assert files == ["reads.fastq" if kind is None else "reads.fastq.gz"]
    assert any(line.startswith("compressed: ") for line in lines) == bool(
        kind)
    assert splits
    if kind == "gzip":
        assert all(r == [(0, -1)] for r in splits)
    if kind == "bgzf":
        assert all(len(r) > 1 and isinstance(r[0][0], readers.GzShard)
                   for r in splits)


def test_traced_bgzf_cell_reads_its_split_and_reads(monkeypatch):
    """A traced run of the BGZF cell: kmc.split counts more than one
    shard, input_read_s (a metric of the gzip cell, which the BGZF cell
    no longer lists) reads the pool's reads, and the cell's own per-layer
    metric, its traced rate, reads."""
    file_shards = readers._file_shards
    monkeypatch.setattr(
        readers, "_file_shards",
        lambda path, fmt, n, min_shard_bytes=0: file_shards(
            path, fmt, n, min_shard_bytes=1 << 14))
    cell = _compressed_cell("bgzf")
    cell.per_layer = load_cell("isolate_k27.fastq100x_bgzf").per_layer + [
        m for m in load_cell("isolate_k27.fastq100x_gz").per_layer
        if m["name"] == "input_read_s"]
    res = harness.run_cell(cell, SEED, 0.3, True, device="cpu",
                           log=lambda m: None)
    assert res["correct"]
    assert res["metrics"]["input_read_s"]["value"] > 0
    assert res["metrics"]["traced_kmers_per_s"]["value"] > 0
    split = [s for s in trace.records() if s.name == "kmc.split"]
    assert split and all(s.counters["shards"] > 1 for s in split)


def _span(name, a, b, thread, parent=None, **counters):
    """A record: a and b in seconds of perf_counter."""
    return SimpleNamespace(name=name, start=int(a * 1e9), end=int(b * 1e9),
                           thread=thread, parent=parent, count=1,
                           counters=counters or None)


def _records(t, read_s=(0.1, 0.2, 0.05)):
    """One job's spans from t s: counting thread 1, two reader threads,
    a kmc.parse span for each of read_s, in turn on threads 2 and 3."""
    s1 = _span("kmc.stage1", t + 0.001, t + 0.8, 1)
    recs = [s1]
    for i, r in enumerate(read_s):
        reader = _span("kmc.reader", t + 0.002, t + 0.6, 2 + i % 2, s1)
        recs += [reader, _span("kmc.parse", t + 0.01 + 0.1 * i,
                               t + 0.1 + 0.1 * i, 2 + i % 2, reader,
                               **({} if r is None else dict(read_s=r,
                                                            bytes=1)))]
    return recs


def _run(n_jobs):
    jobs = [Job(i, 10.0 + i, 11.0 + i) for i in range(n_jobs)]
    return Run(cell=load_cell("isolate_k27.fastq100x_gz"), device_kind="cpu",
               jobs=jobs, profiled=list(range(n_jobs)))


def test_input_read_s_on_synthetic_records(monkeypatch):
    recs = _records(10.0) + _records(11.0, (0.5,))
    monkeypatch.setattr(trace, "records", lambda: recs)
    # the busiest thread a job: thread 3's 0.2 s (thread 2 reads 0.15 s),
    # then 0.5 s; their mean
    assert load_reader("input_read_s").read(_run(2)) == pytest.approx(0.35)


@pytest.mark.parametrize("recs", [[], _records(10.0, (None, None))])
def test_input_read_s_reads_nothing_without_read_s(monkeypatch, recs):
    """Nothing recorded, or parse spans without read_s, as before the
    reads moved into C."""
    monkeypatch.setattr(trace, "records", lambda: recs)
    assert load_reader("input_read_s").read(_run(1)) is None


def member_dropped(monkeypatch):
    """Each BGZF shard's reader skips its second member."""
    next_block = readers.BgzfShardReader._next_block

    def skip_second(self):
        if self._bi == self._shard.block + 1:
            next_block(self)
        return next_block(self)

    monkeypatch.setattr(readers.BgzfShardReader, "_next_block", skip_second)


def half_of_each_chunk(monkeypatch):
    """The inflated input's chunks parsed, the second half of each one's
    codes left out."""
    from kmc_tpu_torch.io.native import NativeParser

    read_chunk = NativeParser.read_chunk

    def halved(self, *args):
        codes, *rest = read_chunk(self, *args)
        return (codes[:len(codes) // 2], *rest)

    monkeypatch.setattr(NativeParser, "read_chunk", halved)


def base_altered(monkeypatch):
    """One base changed in each chunk the inflate and parse give."""
    from kmc_tpu_torch.io.native import NativeParser

    read_chunk = NativeParser.read_chunk

    def altered(self, *args):
        codes, *rest = read_chunk(self, *args)
        bases = np.flatnonzero(codes < 4)
        if len(bases):
            codes[bases[len(bases) // 2]] ^= 1
        return (codes, *rest)

    monkeypatch.setattr(NativeParser, "read_chunk", altered)


@pytest.mark.parametrize("kind, fault", [
    ("bgzf", member_dropped), ("gzip", half_of_each_chunk),
    ("bgzf", half_of_each_chunk), ("gzip", base_altered),
    ("bgzf", base_altered)])
def test_fault_in_the_input_route_is_not_correct(monkeypatch, kind, fault):
    file_shards = readers._file_shards
    monkeypatch.setattr(
        readers, "_file_shards",
        lambda path, fmt, n, min_shard_bytes=0: file_shards(
            path, fmt, n, min_shard_bytes=1 << 14))
    fault(monkeypatch)
    res = harness.run_cell(_compressed_cell(kind), SEED, 0.3, False,
                           device="cpu", log=lambda m: None)
    assert res["correct"] is False and res["failed"] == 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
