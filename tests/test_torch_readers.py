"""The port's database readers against kmc_tpu's, on the CPU: read_pre_meta,
read_db, sorted_records, DbStreamReader, the text dumps and kmc_dump, each
on KMC2, KMC1 and KFF files written by either package (the port reads
kmc_tpu's files and kmc_tpu reads the port's), exactly; and the listing
API under a 500 MB address-space cap, which the port's reader chain meets
because it loads neither torch nor jax."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import kmc_tpu.dump_cli as jax_dump_cli  # noqa: E402
from kmc_tpu.formats import kmc_db as jax_kmc_db  # noqa: E402
from kmc_tpu.formats import streaming as jax_streaming  # noqa: E402
from kmc_tpu.formats.dump import dump_db_file as jax_dump_db_file  # noqa: E402
from kmc_tpu.formats.dump import dump_records as jax_dump_records  # noqa: E402
from kmc_tpu.runner import OutputFileType as JaxOutputFileType  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import OutputFileType, count  # noqa: E402
from kmc_tpu_torch import dump_cli  # noqa: E402
from kmc_tpu_torch.formats import kmc_db  # noqa: E402
from kmc_tpu_torch.formats import streaming  # noqa: E402
from kmc_tpu_torch.formats.dump import dump_db_file, dump_records  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

# name -> count kwargs; each database is written by both packages
DBS = {
    "kmc2_k25": dict(k=25, cutoff_min=1),
    "kmc2_k21_ci2_cs100": dict(k=21, cutoff_min=2, counter_max=100),
    "kmc2_k21_counter_size0": dict(k=21, cutoff_min=1, counter_max=1),
    "kmc2_k45": dict(k=45, cutoff_min=1),
    "kmc1_k9": dict(k=9, cutoff_min=1),
    "kmc1_k13_forward": dict(k=13, cutoff_min=1, canonical_kmers=False),
}
WRITERS = ("jax", "port")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Each database written by kmc_tpu and by the port from one FASTQ."""
    d = tmp_path_factory.mktemp("readers")
    fq = write_fastq(d / "in.fastq", random_reads(300, 90, seed=5,
                                                  n_prob=0.005,
                                                  genome_len=3000))
    cache = {}

    def get(name, writer):
        if (name, writer) not in cache:
            kw = dict(DBS[name])
            k = kw.pop("k")
            out = str(d / f"{name}_{writer}")
            if writer == "jax":
                jax_count([fq], out, k=k, batch_positions=1 << 12, **kw)
            else:
                count([fq], out, k=k, batch_positions=1 << 12,
                      device="cpu", **kw)
            cache[(name, writer)] = out
        return cache[(name, writer)]

    get.fastq = fq
    get.dir = d
    return get


def _info(info):
    return dataclasses.asdict(info)


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("name", list(DBS))
def test_read_db_matches_kmc_tpu(dbs, name, writer):
    path = dbs(name, writer)
    for mmap in (False, True):
        info, luts, sig_map = kmc_db.read_pre_meta(path, mmap_luts=mmap)
        jinfo, jluts, jsig = jax_kmc_db.read_pre_meta(path, mmap_luts=mmap)
        assert _info(info) == _info(jinfo)
        assert np.array_equal(np.asarray(luts), np.asarray(jluts))
        assert (sig_map is None) == (jsig is None)
        if sig_map is not None:
            assert np.array_equal(sig_map, jsig)
    db, jdb = kmc_db.read_db(path), jax_kmc_db.read_db(path)
    assert _info(db.info) == _info(jdb.info)
    assert db.info.version == (0 if name.startswith("kmc1") else 0x200)
    assert np.array_equal(db.records, jdb.records)
    assert np.array_equal(db.counters(), jdb.counters())
    assert np.array_equal(db.kmers_bytes(), jdb.kmers_bytes())
    assert np.array_equal(db.bin_ids(), jdb.bin_ids())
    kmers, counts = kmc_db.sorted_records(db)
    jkmers, jcounts = jax_kmc_db.sorted_records(jdb)
    assert np.array_equal(kmers, jkmers) and np.array_equal(counts, jcounts)
    assert kmc_db.kmers_bytes_to_strings(kmers[:50], db.info.kmer_len) == \
        jax_kmc_db.kmers_bytes_to_strings(jkmers[:50], db.info.kmer_len)
    assert db.n_records > 0


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("name", list(DBS))
def test_dumps_match_kmc_tpu(dbs, name, writer):
    path = dbs(name, writer)
    for sorted_output in (True, False):
        text = dump_db_file(path, sorted_output=sorted_output)
        assert text == jax_dump_db_file(path, sorted_output=sorted_output)
        assert text
    db = kmc_db.read_db(path)
    kmers, counts = kmc_db.sorted_records(db)
    # small chunks: the vectorized line assembly across chunk edges
    assert dump_records(kmers, counts, db.info.kmer_len, chunk_rows=7) == \
        jax_dump_records(kmers, counts, db.info.kmer_len, chunk_rows=7)


def test_databases_byte_identical_across_packages(dbs):
    """What the two packages write from one FASTQ is the same file, so
    each reader test above reads both packages' bytes."""
    for name in DBS:
        a, b = dbs(name, "jax"), dbs(name, "port")
        for suf in (".kmc_pre", ".kmc_suf"):
            assert Path(a + suf).read_bytes() == Path(b + suf).read_bytes()


@pytest.mark.parametrize("block,cut", [
    (1 << 16, (None, None)),
    (1 << 7, (None, None)),  # many small blocks: the windowed merge bound
    (1 << 9, (2, 5)),
])
@pytest.mark.parametrize("name", ["kmc2_k25", "kmc2_k45", "kmc1_k9",
                                  "kmc2_k21_counter_size0"])
def test_stream_reader_matches_kmc_tpu(dbs, name, block, cut):
    path = dbs(name, "port" if block == 1 << 7 else "jax")
    got, want = [], []
    with streaming.DbStreamReader(path, block, *cut) as r:
        info = _info(r.info)
        for kmers, counts in r.blocks():
            got.append((kmers.copy(), counts.copy()))
    with jax_streaming.DbStreamReader(path, block, *cut) as r:
        assert info == _info(r.info)
        for kmers, counts in r.blocks():
            want.append((kmers.copy(), counts.copy()))
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    # the whole stream is the database's sorted records, cutoffs applied
    skmers, scounts = kmc_db.sorted_records(kmc_db.read_db(path))
    keep = np.ones(len(scounts), bool)
    if cut[0] is not None:
        keep = (scounts >= cut[0]) & (scounts <= cut[1])
    assert sum(len(b) for _, b in got) == int(keep.sum())
    if got:
        assert np.array_equal(np.concatenate([a for a, _ in got]),
                              skmers[keep])
        assert np.array_equal(np.concatenate([b for _, b in got]),
                              scounts[keep])


@pytest.mark.parametrize("writer", WRITERS)
def test_stream_reader_kff_matches_kmc_tpu(dbs, writer):
    """KFF input of DbStreamReader: the sorted sections of a KFF file."""
    out = str(dbs.dir / f"kff_{writer}")
    if writer == "jax":
        jax_count([dbs.fastq], out, k=25, cutoff_min=1,
                  batch_positions=1 << 12,
                  output_file_type=JaxOutputFileType.KFF)
    else:
        count([dbs.fastq], out, k=25, cutoff_min=1, batch_positions=1 << 12,
              output_file_type=OutputFileType.KFF, device="cpu")
    with streaming.DbStreamReader(out + ".kff", 1 << 8) as r:
        got = list(r.key_blocks())
    with jax_streaming.DbStreamReader(out + ".kff", 1 << 8) as r:
        want = list(r.key_blocks())
    assert len(got) == len(want) > 0
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("args", [[], ["-ci2"], ["-cx3"], ["-ci2", "-cx5"]])
@pytest.mark.parametrize("name", ["kmc2_k25", "kmc1_k9", "kmc2_k45"])
def test_kmc_dump_cli_matches_kmc_tpu(dbs, tmp_path, monkeypatch, name,
                                      args, native):
    """The port's kmc_dump writes kmc_tpu's file: the native listing-order
    dump, or with KMC_TPU_NATIVE_TOOLS=0 the listing API."""
    monkeypatch.setenv("KMC_TPU_NATIVE_TOOLS", native)
    path = dbs(name, "jax")
    out_t, out_j = tmp_path / "t.txt", tmp_path / "j.txt"
    assert dump_cli.main(args + [path, str(out_t)]) == 0
    assert jax_dump_cli.main(args + [path, str(out_j)]) == 0
    assert out_t.read_bytes() == out_j.read_bytes()


def test_kmc_dump_cli_kff_and_errors(dbs, tmp_path, capsys):
    """A KFF file goes through the listing API; a missing database and a
    wrong argument count fail as kmc_tpu's CLI does."""
    out = str(tmp_path / "x")
    count([dbs.fastq], out, k=21, cutoff_min=1, batch_positions=1 << 12,
          output_file_type=OutputFileType.KFF, device="cpu")
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    assert dump_cli.main([out + ".kff", str(a)]) == 0
    assert jax_dump_cli.main([out + ".kff", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes() and a.read_bytes()
    assert dump_cli.main([str(tmp_path / "none"), str(a)]) == \
        jax_dump_cli.main([str(tmp_path / "none"), str(b)]) == 1
    assert dump_cli.main([str(a)]) == jax_dump_cli.main([str(b)]) == 1
    assert "kmc_dump (kmc_tpu_torch)" in capsys.readouterr().out


def test_kmc_dump_cli_module_entry(dbs, tmp_path):
    """python -m kmc_tpu_torch.dump_cli writes what the function does."""
    path = dbs("kmc2_k25", "port")
    out = tmp_path / "m.txt"
    r = subprocess.run([sys.executable, "-m", "kmc_tpu_torch.dump_cli",
                        "-ci2", path, str(out)], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    ref = tmp_path / "r.txt"
    assert jax_dump_cli.main(["-ci2", path, str(ref)]) == 0
    assert out.read_bytes() == ref.read_bytes()


def test_listing_bounded_rss_port(tmp_path):
    """The port's twin of tests/test_streaming.py::test_listing_bounded_rss:
    under a 500 MB RLIMIT_AS, OpenForListing streams a 12 M-record KMC1
    database in order, the in-memory RA mode hits MemoryError, and the
    on-disk RA mode answers, with neither torch nor jax loaded."""
    from kmc_tpu_torch.formats.kmc_db import DbInfo, write_kmc1_db
    from kmc_tpu_torch.tools import native_tools

    native_tools.get_lib()  # built here: the child's cap would stop g++
    k = 25
    kb = (k + 3) // 4
    rng = np.random.default_rng(1)
    n = 12_000_000
    kmers = rng.integers(0, 256, size=(n, kb), dtype=np.uint8)
    kmers[:, 0] &= 0x03
    order = np.lexsort(tuple(kmers[:, j] for j in range(kb - 1, -1, -1)))
    kmers = kmers[order]
    dup = np.ones(n, bool)
    dup[1:] = (kmers[1:] != kmers[:-1]).any(axis=1)
    kmers = kmers[dup]
    counts = rng.integers(1, 200, size=len(kmers)).astype(np.uint32)
    info = DbInfo(kmer_len=k, counter_size=1, lut_prefix_len=5,
                  cutoff_min=1, cutoff_max=10**9, version=0)
    p = str(tmp_path / "bigdb")
    write_kmc1_db(p, info, kmers, counts)
    first = bytes(kmers[0])
    del kmers, counts

    script = f"""
import resource, sys, os
# RLIMIT_AS counts mapped address space, so the cap leaves room for the
# on-disk modes' memmaps (~76 MB) on top of the interpreter baseline; the
# in-memory RA materialization (~480 MB of real allocations) cannot fit
resource.setrlimit(resource.RLIMIT_AS, (500 << 20, 500 << 20))
sys.path.insert(0, {str(REPO)!r})
from kmc_tpu_torch.api import KMCFile, KmerAPI
f = KMCFile()
assert f.OpenForListing({p!r})
assert not f.Eof()
km = KmerAPI()
seen = 0
prev = None
while seen < 50000:
    ok, c = f.ReadNextKmer(km)
    assert ok and c >= 1
    s = km.to_string()
    assert prev is None or s > prev, (prev, s)
    prev = s
    seen += 1
assert not f.Eof()
f.Close()
# the cap binds: the in-memory arrays build on first row access
g = KMCFile()
try:
    g.OpenForRA({p!r})
    g.CheckKmer("A" * 25)
except MemoryError:
    pass
else:
    sys.exit(3)
del g
import gc
gc.collect()
# the on-disk RA mode answers membership queries under the cap
os.environ["KMC_TPU_RA_THRESHOLD"] = "0"
h = KMCFile()
assert h.OpenForRA({p!r}) and h._is_file_ra()
found, c = h.CheckKmer("".join("ACGT"[b % 4] for b in {first!r}[-25:]))
ok2, per = h.GetCountersForRead("A" * 40)
assert ok2 and len(per) == 16
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "kmc_tpu"))
assert not bad, bad
print("LISTING-OK-RA-OOM")
sys.exit(0)
"""
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LISTING-OK-RA-OOM" in r.stdout
