"""The port's multi-threaded host ingest (kmc_tpu_torch/io/readers.py), the
twins of tests/test_parallel_reader.py: the parallel chunk stream is a
boundary refinement of the serial stream (identical codes, read counts
and databases), the per-process shards cover the serial stream exactly,
and each split and stream equals kmc_tpu's."""
import gzip
import os

import numpy as np
import pytest

from kmc_tpu.io import readers as jax_readers
from kmc_tpu_torch.io import readers

from util import random_reads, write_fasta, write_fastq


def _cat(gen):
    chunks = list(gen)
    return np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)


def _assert_streams_match(paths, fmt, n_threads=3):
    s1 = readers.ParseState()
    serial = _cat(readers.file_code_stream(paths, fmt, s1))
    s2 = readers.ParseState()
    par = _cat(readers.parallel_code_stream(paths, fmt, s2,
                                            n_threads=n_threads))
    assert np.array_equal(serial, par)
    assert s1.n_reads == s2.n_reads
    s3 = jax_readers.ParseState()
    ref = _cat(jax_readers.file_code_stream(paths, fmt, s3))
    assert np.array_equal(serial, ref) and s3.n_reads == s1.n_reads


def test_multi_file_fastq(tmp_path):
    paths = [write_fastq(tmp_path / f"in{i}.fastq", random_reads(40, 90,
                                                                 seed=i))
             for i in range(5)]
    _assert_streams_match(paths, "fastq")


def test_single_big_fastq_byte_range_split(tmp_path, monkeypatch):
    monkeypatch.setattr(readers, "CHUNK_BYTES", 1 << 12)
    path = write_fastq(tmp_path / "big.fastq", random_reads(4000, 120,
                                                            seed=3))
    size = os.path.getsize(path)
    shards = readers._file_shards(str(path), "fastq", 4,
                                  min_shard_bytes=size // 6)
    assert len(shards) > 1, "file did not split"
    assert shards == jax_readers._file_shards(str(path), "fastq", 4,
                                              min_shard_bytes=size // 6)
    _assert_streams_match([path], "fastq")


def test_fastq_quality_at_sign_ambiguity(tmp_path):
    """Quality strings starting with '@' and '+' must not fool the
    record-boundary scanner."""
    rng = np.random.default_rng(9)
    path = tmp_path / "tricky.fastq"
    with open(path, "w") as f:
        for i in range(3000):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 80))
            qual = (("@" if i % 2 else "+") + "@+II" * 20)[: len(seq)]
            f.write(f"@r{i} desc\n{seq}\n+\n{qual}\n")
    size = os.path.getsize(path)
    shards = readers._file_shards(str(path), "fastq", 4,
                                  min_shard_bytes=size // 6)
    assert len(shards) > 1
    data = open(path, "rb").read()
    for start, _ in shards[1:]:
        assert data[start : start + 2] == b"@r", data[start : start + 8]
    _assert_streams_match([str(path)], "fastq")


def test_single_big_fasta_split(tmp_path):
    path = write_fasta(tmp_path / "big.fa", random_reads(3000, 150, seed=5))
    size = os.path.getsize(path)
    shards = readers._file_shards(str(path), "fasta", 4,
                                  min_shard_bytes=size // 6)
    assert len(shards) > 1
    _assert_streams_match([path], "fasta")


def test_gz_files_one_shard_each(tmp_path):
    paths = []
    for i in range(3):
        reads = random_reads(60, 100, seed=10 + i)
        p = tmp_path / f"in{i}.fastq.gz"
        with gzip.open(p, "wt") as f:
            f.write("".join(f"@r{j}\n{r}\n+\n{'I' * len(r)}\n"
                            for j, r in enumerate(reads)))
        paths.append(str(p))
    for p in paths:
        assert readers._file_shards(p, "fastq", 4) == [(0, -1)]
    _assert_streams_match(paths, "fastq")


def test_runner_parallel_ingest_db_identical(tmp_path):
    """n_threads > 1 writes a byte-identical database."""
    from kmc_tpu_torch import count
    from kmc_tpu_torch.formats import dump_db_file

    paths = [write_fastq(tmp_path / f"r{i}.fastq",
                         random_reads(200, 110, seed=20 + i,
                                      genome_len=9000)) for i in range(4)]
    out1, out2 = str(tmp_path / "serial"), str(tmp_path / "parallel")
    for out, n in ((out1, 1), (out2, 4)):
        count(paths, out, k=25, cutoff_min=1, batch_positions=1 << 12,
              n_threads=n, device="cpu")
    for suf in (".kmc_pre", ".kmc_suf"):
        with open(out1 + suf, "rb") as a, open(out2 + suf, "rb") as b:
            assert a.read() == b.read(), suf
    assert dump_db_file(out1) == dump_db_file(out2)


def _assert_process_shards_cover(paths, fmt, n_parts, min_shard=2048):
    """The per-process shard streams, concatenated in part order, are the
    serial stream (no code lost, duplicated or reordered), and the parts
    are kmc_tpu's."""
    s1 = readers.ParseState()
    serial = _cat(readers.file_code_stream(paths, fmt, s1))
    parts = readers.process_input_shards(paths, fmt, n_parts,
                                         min_shard_bytes=min_shard)
    assert parts == jax_readers.process_input_shards(
        paths, fmt, n_parts, min_shard_bytes=min_shard)
    assert len(parts) == n_parts
    chunks, n_reads = [], 0
    for shard_list in parts:
        st = readers.ParseState()
        chunks.append(_cat(readers.shard_code_stream(shard_list, fmt, st,
                                                     n_threads=2)))
        n_reads += st.n_reads
    merged = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    assert np.array_equal(serial, merged)
    assert n_reads == s1.n_reads
    return parts


def test_process_shards_single_fastq(tmp_path):
    path = write_fastq(tmp_path / "big.fastq", random_reads(400, 120, seed=7))
    assert all(_assert_process_shards_cover([path], "fastq", 3))


def test_process_shards_fasta_and_gz(tmp_path):
    p1 = write_fasta(tmp_path / "a.fasta", random_reads(300, 100, seed=8))
    p2 = tmp_path / "b.fastq.gz"
    with gzip.open(p2, "wt") as f:
        f.write("".join(f"@g{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in
                        enumerate(random_reads(100, 80, seed=9))))
    _assert_process_shards_cover([str(p1)], "fasta", 2)
    _assert_process_shards_cover([str(p2)], "fastq", 2)


def test_process_shards_without_native_parser_raise(tmp_path, monkeypatch):
    """kmc_tpu's shard_code_stream falls back to a NumPy range parser when
    its native library is missing; the port has no NumPy parser by design
    (ROADMAP §C, native runtimes), so the same failure raises instead."""
    path = write_fastq(tmp_path / "fb.fastq", random_reads(200, 110,
                                                           seed=10))
    parts = readers.process_input_shards([path], "fastq", 2,
                                         min_shard_bytes=2048)
    import kmc_tpu_torch.io.native as native_mod

    def boom(fmt):
        raise RuntimeError("forced fallback")

    monkeypatch.setattr(native_mod, "NativeParser", boom)
    for p in parts:
        with pytest.raises(RuntimeError, match="forced fallback"):
            _cat(readers.shard_code_stream(p, "fastq", readers.ParseState()))


def _write_bgzf_gz(path, payload: bytes, block_bytes=4096):
    """bgzip-style .gz: a chain of BGZF members (BC extra field)."""
    import struct
    import zlib

    def block(p):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(p) + co.flush()
        bsize = len(comp) + 25 + 1
        header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + b"\x06\x00"
                  + b"BC\x02\x00" + struct.pack("<H", bsize - 1))
        return (header + comp + struct.pack("<I", zlib.crc32(p))
                + struct.pack("<I", len(p) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        for lo in range(0, len(payload), block_bytes):
            f.write(block(payload[lo : lo + block_bytes]))
    return str(path)


def _shard_stream(gz, shards, fmt, state):
    return _cat(readers.shard_code_stream(
        [(gz, a, b, i == len(shards) - 1) for i, (a, b) in enumerate(shards)],
        fmt, state, n_threads=3))


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_bgzf_gz_shards_record_aligned(tmp_path, fmt):
    """BGZF .gz inputs split at block boundaries into record-aligned
    GzShard ranges; the shard readers reproduce the decompressed payload
    and the sharded stream equals the serial inflate."""
    reads = random_reads(3000, 110, seed=21)
    plain = tmp_path / ("in.fastq" if fmt == "fastq" else "in.fasta")
    (write_fastq if fmt == "fastq" else write_fasta)(plain, reads)
    payload = plain.read_bytes()
    gz = _write_bgzf_gz(tmp_path / (plain.name + ".gz"), payload)
    shards = readers._file_shards(gz, fmt, 8, min_shard_bytes=1 << 14)
    assert len(shards) > 1, "BGZF file did not split"
    assert all(isinstance(a, readers.GzShard) for a, _ in shards)
    got = []
    for a, _ in shards:
        r = readers.BgzfShardReader(gz, a)
        buf = np.empty(1 << 14, np.uint8)
        while True:
            n = r.read_into(buf)
            if not n:
                break
            got.append(buf[:n].tobytes())
        r.close()
    assert b"".join(got) == payload
    s1, s2 = readers.ParseState(), readers.ParseState()
    serial = _cat(readers.file_code_stream([gz], fmt, s1))
    assert np.array_equal(serial, _shard_stream(gz, shards, fmt, s2))
    assert s1.n_reads == s2.n_reads


def test_plain_gz_stays_serial(tmp_path):
    plain = tmp_path / "in.fastq"
    write_fastq(plain, random_reads(500, 100, seed=5))
    gz = tmp_path / "in.fastq.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    assert readers._file_shards(str(gz), "fastq", 8,
                                min_shard_bytes=1 << 12) == [(0, -1)]
    _assert_streams_match([str(gz)], "fastq")


def test_bgzf_gz_crlf_and_long_reads(tmp_path):
    """CRLF line ends and reads longer than one BGZF block: the splits
    stay record-aligned and the stream equals the serial inflate."""
    rng = np.random.default_rng(31)
    recs = []
    for i in range(60):
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 9000))
        recs.append(f"@long{i}\r\n{seq}\r\n+\r\n{'I' * len(seq)}\r\n")
    gz = _write_bgzf_gz(tmp_path / "long.fastq.gz", "".join(recs).encode(),
                        block_bytes=2048)
    shards = readers._file_shards(gz, "fastq", 8, min_shard_bytes=1 << 12)
    assert len(shards) > 1
    s1, s2 = readers.ParseState(), readers.ParseState()
    serial = _cat(readers.file_code_stream([gz], "fastq", s1))
    assert np.array_equal(serial, _shard_stream(gz, shards, "fastq", s2))
    assert s1.n_reads == s2.n_reads == 60


def test_truncated_bgzf_gz_errors(tmp_path):
    """A BGZF gz cut mid-block raises while sharding or streaming."""
    plain = tmp_path / "t.fastq"
    write_fastq(plain, random_reads(500, 100, seed=8))
    raw = open(_write_bgzf_gz(tmp_path / "t.fastq.gz",
                              plain.read_bytes()), "rb").read()
    cut = tmp_path / "cut.fastq.gz"
    cut.write_bytes(raw[: len(raw) - 37])  # inside the last block
    with pytest.raises(Exception):
        shards = readers._file_shards(str(cut), "fastq", 8,
                                      min_shard_bytes=1 << 12)
        _shard_stream(str(cut), shards, "fastq", readers.ParseState())


def test_batchstream_tail_interval_no_window_loss():
    """Every tail length across two batch boundaries: the batched window
    starts equal the stream's true count (kmc_tpu's round-5 fix)."""
    from kmc_tpu_torch.io.readers import BatchStream, batch_len

    k, s = 25, 64
    L = batch_len(s, k)
    for n in range(k, 2 * L + 9):
        codes = np.arange(n, dtype=np.uint8) % 4  # all valid
        got = 0
        for batch in BatchStream(s, k).batches(iter([codes])):
            assert len(batch) == L
            run = np.zeros(len(batch) + 1, np.int64)
            for j, g in enumerate(batch < 4):
                run[j + 1] = run[j] + 1 if g else 0
            starts = np.flatnonzero(run[1:] >= k) - (k - 1)
            got += int(((starts >= 0) & (starts < s)).sum())
        assert got == n - k + 1, (n, got)


def _chunk_inputs(tmp_path, kind):
    """Two input files of one kind, ~70 KB each: plain FASTQ, FASTQ whose
    last line has no newline, multi-line FASTA, plain gzip of two members
    split mid-record, and BGZF."""
    paths = []
    for i in range(2):
        reads = random_reads(300, 110, seed=60 + i)
        if kind == "fasta":
            paths.append(write_fasta(tmp_path / f"in{i}.fa", reads,
                                     line_width=50))
            continue
        text = "".join(f"@r{j}\n{r}\n+\n{'I' * len(r)}\n"
                       for j, r in enumerate(reads)).encode()
        if kind == "fastq_unterminated":
            text = text[:-1]
        p = tmp_path / (f"in{i}.fastq" + (".gz" if kind in ("gz", "bgzf")
                                          else ""))
        if kind == "gz":
            cut = len(text) // 2 + 7
            p.write_bytes(gzip.compress(text[:cut]) + gzip.compress(text[cut:]))
        elif kind == "bgzf":
            _write_bgzf_gz(p, text, block_bytes=1000)
        else:
            p.write_bytes(text)
        paths.append(str(p))
    return paths


def _stream_chunks(module, stream, paths, fmt):
    """(chunks, ParseState) of one package's stream over paths."""
    st = module.ParseState()
    if stream == "serial":
        return list(module.file_code_stream(paths, fmt, st)), st
    if stream == "parallel":
        return list(module.parallel_code_stream(paths, fmt, st,
                                                n_threads=3)), st
    chunks = []
    for part in module.process_input_shards(paths, fmt, 2,
                                            min_shard_bytes=4096):
        chunks += list(module.shard_code_stream(part, fmt, st, n_threads=2))
    return chunks, st


# (chunk bytes, piece bytes): the chunk below one piece, equal to one, and
# two pieces and a part
CHUNK_PIECES = {"below": (700, 1024), "equal": (1024, 1024),
                "ragged": (2500, 1024)}


@pytest.mark.parametrize("sizes", sorted(CHUNK_PIECES))
@pytest.mark.parametrize("kind", ["fastq", "fastq_unterminated", "fasta",
                                  "gz", "bgzf"])
@pytest.mark.parametrize("stream", ["serial", "parallel", "shard"])
def test_chunks_read_in_pieces_are_kmc_tpus(tmp_path, monkeypatch, stream,
                                            kind, sizes):
    """Each stream reads and parses a chunk a piece at a time, yet yields
    kmc_tpu's chunks one for one (lengths and codes), with its read count
    and consumed bytes."""
    chunk, piece = CHUNK_PIECES[sizes]
    monkeypatch.setattr(readers, "CHUNK_BYTES", chunk)
    monkeypatch.setattr(jax_readers, "CHUNK_BYTES", chunk)
    monkeypatch.setattr(readers, "PIECE_BYTES", piece)
    for module in (readers, jax_readers):  # shards of a few KB
        orig = module._file_shards
        monkeypatch.setattr(
            module, "_file_shards",
            lambda path, fmt, n, min_shard_bytes=4096, _orig=orig: _orig(
                path, fmt, n, min_shard_bytes=min_shard_bytes))
    fmt = "fasta" if kind == "fasta" else "fastq"
    paths = _chunk_inputs(tmp_path, kind)
    got, s_got = _stream_chunks(readers, stream, paths, fmt)
    want, s_want = _stream_chunks(jax_readers, stream, paths, fmt)
    assert [len(c) for c in got] == [len(c) for c in want]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert sum(len(c) for c in got) > 60000
    assert (s_got.n_reads, s_got.consumed_bytes) == (
        s_want.n_reads, s_want.consumed_bytes)
    assert s_got.n_reads == 600
