"""The port's compatibility surfaces, the twins of tests/test_compat.py:
the py_kmc_api shim, KFF in and out for the tools, KFF minimizer sections,
and the header parsers' robustness.  Each mutation fuzz holds the port's
parser to kmc_tpu's on the same bytes: both parse to the same result, or
both raise."""
import dataclasses
import struct

import numpy as np
import pytest

from kmc_tpu_torch import count


def _make_db(tmp_path, seed=5, k=21):
    rng = np.random.default_rng(seed)
    reads = tmp_path / "r.fastq"
    with open(reads, "w") as f:
        for i in range(100):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 120))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * 120}\n")
    out = str(tmp_path / "db")
    count([str(reads)], out, k=k, cutoff_min=1, batch_positions=1 << 12,
          device="cpu")
    return str(reads), out, k


def _outcome(fn, *args):
    """fn(*args)'s result as plain data, or "raised"."""
    try:
        got = fn(*args)
    except Exception:  # noqa: BLE001 - any clean failure is an outcome
        return "raised"
    return _plain(got)


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return _plain(vars(x))
    return x


def test_py_kmc_api_shim(tmp_path):
    from kmc_tpu_torch import py_kmc_api as pka

    _, db, k = _make_db(tmp_path)
    f = pka.KMCFile()
    assert f.OpenForListing(db)
    info = f.Info()
    assert info.kmer_length == k
    kmer, cnt = pka.KmerAPI(k), pka.Count()
    n, first = 0, None
    while f.ReadNextKmer(kmer, cnt):
        if first is None:
            first = str(kmer)
        assert cnt.value >= 1
        n += 1
    assert n == info.total_kmers
    assert f.OpenForRA(db)
    k2 = pka.KmerAPI(k)
    assert k2.from_string(first)
    assert f.CheckKmer(k2, cnt)
    assert cnt.value >= 1
    vec = pka.CountVec()
    read_seq = first + "ACGT"
    assert f.GetCountersForRead(read_seq, vec)
    assert len(vec.value) == len(read_seq) - k + 1


def test_tools_kff_roundtrip(tmp_path):
    from kmc_tpu_torch.tools import db_ops

    _, db, k = _make_db(tmp_path, seed=6)
    kff_out = str(tmp_path / "out.kff")
    db_ops.transform_sort(db, kff_out)  # KMC db -> sorted KFF output
    _, kmers, counts = db_ops.load_sorted(kff_out)  # KFF input
    _, kmers2, counts2 = db_ops.load_sorted(db)
    assert np.array_equal(kmers, kmers2)
    assert np.array_equal(counts, counts2)
    text = db_ops.db_info_text(kff_out)
    assert "This is KFF file, summary:" in text
    assert f"k             :  {k}" in text
    assert "footer values:" in text and "tot_nb_blocks :  " in text
    from kmc_tpu.tools import db_ops as jax_db_ops

    assert text == jax_db_ops.db_info_text(kff_out)


def _minimizer_kff(path, k, m):
    """A KFF holding one minimizer section (kmc_tpu's test file)."""
    buf = bytearray()

    def be(x):
        return struct.pack(">Q", x)

    index = []
    buf += b"KFF" + bytes([1, 0, 0b00011011, 1, 1]) + struct.pack(">I", 0)
    index.append(len(buf))
    pairs = [(b"k", k), (b"m", m), (b"max", 1), (b"data_size", 1),
             (b"ordered", 1)]
    buf += b"v" + be(len(pairs))
    for name, val in pairs:
        buf += name + b"\x00" + be(val)
    index.append(len(buf))
    buf += b"m" + bytes([0xAB, 0xCD]) + be(3) + b"\x00" * 17
    nb_sections = len(index) + 1
    index_start = len(buf)
    index_end = index_start + 1 + 8 + nb_sections * 9 + 8
    buf += b"i" + be(nb_sections)
    buf += b"v" + struct.pack(">q", index[0] - index_end)
    buf += b"m" + struct.pack(">q", index[1] - index_end)
    buf += b"v" + struct.pack(">q", 0)
    buf += struct.pack(">q", 0)  # next_index
    footer = [(b"first_index", index_start), (b"min_count", 1),
              (b"max_count", 255), (b"counter_size", 1)]
    footer_size = 1 + 8 + sum(len(n) + 1 + 8 for n, _ in footer)
    footer_size += len(b"footer_size") + 1 + 8
    footer.append((b"footer_size", footer_size))
    buf += b"v" + be(len(footer))
    for name, val in footer:
        buf += name + b"\x00" + be(val)
    buf += b"KFF"
    open(path, "wb").write(bytes(buf))


def test_kff_minimizer_sections_display_but_refuse_data(tmp_path):
    """`info` lists KFF minimizer sections while every k-mer data path
    refuses them, as in kmc_tpu."""
    from kmc_tpu_torch.formats.kff import read_kff_meta
    from kmc_tpu_torch.formats.streaming import DbStreamReader
    from kmc_tpu_torch.tools import db_ops

    k, m = 21, 7
    path = str(tmp_path / "mini.kff")
    _minimizer_kff(path, k, m)
    meta = read_kff_meta(path)
    assert meta.k == k and meta.minimizer_size == m
    assert len(meta.m_sections) == 1
    _, nb, mini = meta.m_sections[0]
    assert nb == 3 and mini == bytes([0xAB, 0xCD])
    text = db_ops.db_info_text(path)
    assert "minimizer (HEX) :  ab cd" in text
    assert f"m             :  {m}" in text
    with pytest.raises(NotImplementedError):
        DbStreamReader(path)


def _seed_kff(path):
    from kmc_tpu_torch.formats.kff import KffWriter

    w = KffWriter(path, canonical=True, k=9, counter_size=1, min_count=1,
                  max_count=255)
    arr = np.zeros((12, 3), np.uint8)
    arr[:, -1] = np.arange(12, dtype=np.uint8)
    w.store_section(arr, np.full(12, 2, np.uint32))
    w.close()
    return open(path, "rb").read()


def test_kff_meta_mutation_fuzz(tmp_path):
    """Single-byte corruptions of a valid KFF: read_kff_meta parses them
    as kmc_tpu's does or raises where it raises; never hangs."""
    from kmc_tpu.formats.kff import read_kff_meta as jax_meta
    from kmc_tpu_torch.formats.kff import read_kff_meta

    seed = _seed_kff(str(tmp_path / "seed.kff"))
    rng = np.random.default_rng(0)
    mpath = str(tmp_path / "mut.kff")
    for _ in range(300):
        buf = bytearray(seed)
        pos = int(rng.integers(0, len(buf)))
        buf[pos] ^= int(rng.integers(1, 256))
        open(mpath, "wb").write(bytes(buf))
        assert _outcome(read_kff_meta, mpath) == _outcome(jax_meta, mpath), \
            pos


def test_kff_meta_truncation_raises_valueerror(tmp_path):
    from kmc_tpu_torch.formats.kff import read_kff_meta

    seed = _seed_kff(str(tmp_path / "seed.kff"))
    tpath = str(tmp_path / "trunc.kff")
    for cut in (5, 13, 60, len(seed) - 5):
        open(tpath, "wb").write(seed[:cut])
        with pytest.raises(ValueError):
            read_kff_meta(tpath)


def test_kff_meta_zeroed_first_index_falls_back(tmp_path):
    """A zeroed first_index reads by the sequential scan, not as an empty
    database."""
    from kmc_tpu_torch.formats.kff import read_kff_meta

    path = str(tmp_path / "seed.kff")
    _seed_kff(path)
    good = read_kff_meta(path)
    raw = bytearray(open(path, "rb").read())
    i = raw.rindex(b"first_index\x00") + len(b"first_index\x00")
    raw[i : i + 8] = (0).to_bytes(8, "big")
    zpath = str(tmp_path / "zero_idx.kff")
    open(zpath, "wb").write(bytes(raw))
    meta = read_kff_meta(zpath)
    assert meta.k == good.k == 9
    assert [n for _, n in meta.sections] == [n for _, n in good.sections]


@pytest.mark.parametrize("k", [13, 21])  # 13: KMC1 header, 21: KMC2
def test_kmc_pre_mutation_fuzz(tmp_path, k):
    """Single-byte corruptions of a valid .kmc_pre: read_pre_meta and
    read_db parse them as kmc_tpu's do or raise where they raise."""
    from kmc_tpu.formats.kmc_db import read_db as jax_read_db
    from kmc_tpu.formats.kmc_db import read_pre_meta as jax_pre_meta
    from kmc_tpu_torch.formats.kmc_db import read_db, read_pre_meta

    _, db, _ = _make_db(tmp_path, seed=11, k=k)
    seed = bytearray(open(db + ".kmc_pre", "rb").read())
    rng = np.random.default_rng(1)
    for _ in range(300):
        buf = bytearray(seed)
        pos = int(rng.integers(0, len(buf)))
        buf[pos] ^= int(rng.integers(1, 256))
        open(db + ".kmc_pre", "wb").write(bytes(buf))
        assert _outcome(read_pre_meta, db) == _outcome(jax_pre_meta, db), pos
        assert (_outcome(read_db, db) == "raised") == \
            (_outcome(jax_read_db, db) == "raised"), pos
    open(db + ".kmc_pre", "wb").write(bytes(seed))
    read_db(db)  # the seed still parses


def test_kmc_pre_truncation_and_suf_mismatch(tmp_path):
    """A truncated .kmc_pre raises ValueError (not struct.error), and a
    .kmc_suf whose size disagrees with the header is rejected."""
    from kmc_tpu_torch.formats.kmc_db import read_db, read_pre_meta

    _, db, _ = _make_db(tmp_path, seed=12, k=13)
    pre = open(db + ".kmc_pre", "rb").read()
    suf = open(db + ".kmc_suf", "rb").read()
    for cut in (0, 3, 8, 40, len(pre) - 5):
        open(db + ".kmc_pre", "wb").write(pre[:cut])
        with pytest.raises((ValueError, OSError)):
            read_pre_meta(db)
    open(db + ".kmc_pre", "wb").write(pre)
    open(db + ".kmc_suf", "wb").write(suf[: len(suf) - 8])
    with pytest.raises(ValueError):
        read_db(db)
    open(db + ".kmc_suf", "wb").write(suf)
    read_db(db)
