"""The port's KMCFile / KmerAPI against kmc_tpu.api, on the CPU: twins of
tests/test_api.py, each answer of kmc_tpu_torch.api equal to kmc_tpu.api's
on the same database (and to the oracle where the original test checks
it), and the py_kmc_api shim on kmc_tpu_torch.py_kmc_api against the root
shim over kmc_tpu."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import kmc_tpu.api as jax_api  # noqa: E402
from kmc_tpu import oracle  # noqa: E402
from kmc_tpu.runner import OutputFileType as JaxOutputFileType  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import OutputFileType, count  # noqa: E402
from kmc_tpu_torch import api  # noqa: E402
from kmc_tpu_torch.api import KmerAPI  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def both(probe):
    """probe(api module) run on the port's API and on kmc_tpu's; returns
    the port's answers once they equal kmc_tpu's."""
    got, want = probe(api), probe(jax_api)
    assert got == want
    return got


def _tolist(a):
    return [int(x) for x in np.asarray(a)]


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_api")
    reads = random_reads(80, 80, seed=3, genome_len=500, n_prob=0.01)
    path = str(tmp / "db")
    count([write_fastq(tmp / "in.fq", reads)], path, k=21, cutoff_min=1,
          batch_positions=1 << 12, device="cpu")
    counts = oracle.count_kmers(reads, 21)
    counts = {km: min(c, 255) for km, c in counts.items()}
    return path, reads, counts


def test_open_info(db):
    path, reads, counts = db

    def probe(m):
        f = m.KMCFile()
        assert f.OpenForRA(path)
        info = f.Info()
        out = (info.kmer_length, info.total_kmers, info.both_strands,
               f.KmerCount(), f.KmerLength(), f.IsKMC2())
        assert f.Close()
        return out

    assert both(probe)[:4] == (21, len(counts), True, len(counts))


def test_open_missing(tmp_path):
    assert both(lambda m: m.KMCFile().OpenForRA(str(tmp_path / "nope"))) \
        is False
    assert both(lambda m: m.KMCFile().OpenForListing(
        str(tmp_path / "nope"))) is False


def test_listing(db):
    path, reads, counts = db

    def probe(m):
        f = m.KMCFile()
        assert f.OpenForListing(path)
        kmer = m.KmerAPI()
        got = []
        while True:
            ok, c = f.ReadNextKmer(kmer)
            if not ok:
                break
            got.append((kmer.to_string(), c))
        assert f.RestartListing()
        ok, c = f.ReadNextKmer(kmer)
        return got, (ok, kmer.to_string(), c)

    got, first = both(probe)
    assert dict(got) == counts
    assert [km for km, _ in got] == sorted(counts)
    assert first == (True,) + got[0]


def test_check_kmer(db):
    path, reads, counts = db

    def probe(m):
        f = m.KMCFile()
        f.OpenForRA(path)
        out = []
        for km in list(counts)[:50]:
            out.append(f.CheckKmer(km))
            out.append(f.CheckKmer(oracle.revcomp(km)))
        out += [f.CheckKmer("A" * 21), f.CheckKmer("ACGT"),
                f.CheckKmer("N" * 21)]
        return out

    out = both(probe)
    for i, km in enumerate(list(counts)[:50]):
        assert out[2 * i] == out[2 * i + 1] == (True, counts[km])
    assert out[-3][0] == ("A" * 21 in counts)
    assert out[-2] == out[-1] == (False, 0)


def test_counter_filters(db):
    path, reads, counts = db

    def probe(m):
        f = m.KMCFile()
        f.OpenForRA(path)
        f.SetMinCount(2)
        km1 = next(km for km, c in counts.items() if c == 1)
        return f.KmerCount(), f.CheckKmer(km1), f.GetMinCount()

    n, miss, ci = both(probe)
    assert n == sum(1 for c in counts.values() if c >= 2)
    assert miss == (False, 0) and ci == 2


def test_get_counters_for_read(db):
    path, reads, counts = db
    k = 21

    def probe(m):
        f = m.KMCFile()
        f.OpenForRA(path)
        return [f.GetCountersForRead(r) for r in reads[:20]]

    for read, (ok, got) in zip(reads[:20], both(probe)):
        assert ok
        expect = []
        for i in range(len(read) - k + 1):
            km = read[i : i + k]
            if any(ch not in "ACGT" for ch in km):
                expect.append(0)
            else:
                expect.append(counts.get(min(km, oracle.revcomp(km)), 0))
        assert got == expect, read


@pytest.mark.parametrize("native", ["1", "0"])
def test_counters_for_read_bytes_input(db, monkeypatch, native):
    """ascii bytes and str agree, and a non-ASCII byte acts as 'N', on the
    native lookup and with KMC_TPU_NATIVE_TOOLS=0 on the NumPy one."""
    path, reads, counts = db
    monkeypatch.setenv("KMC_TPU_NATIVE_TOOLS", native)
    read = reads[0]
    raw = read.encode("ascii")
    bad = raw[:10] + b"\xff" + raw[11:]
    subbed = read[:10] + "N" + read[11:]

    def probe(m):
        f = m.KMCFile()
        f.OpenForRA(path)
        return [_tolist(f.counters_for_read_array(x)[1])
                for x in (read, raw, bad, subbed)]

    a, b, c, d = both(probe)
    assert a == b and c == d


def test_counters_for_read_numpy_sliced_long_read(db):
    path, reads, counts = db
    base = "N".join(reads)
    long_read = "N".join([base] * (((1 << 18) // len(base)) + 2))
    assert len(long_read) > (1 << 18)  # > 2 slices

    def probe(m):
        f = m.KMCFile()
        f.OpenForRA(path)
        return (_tolist(f.counters_for_read_array(long_read)[1]),
                _tolist(f._counters_for_read_numpy(long_read)[1]))

    nat, sliced = both(probe)
    assert nat == sliced


def test_kmer_api_roundtrip():
    def probe(m):
        kmer = m.KmerAPI()
        out = [kmer.from_string("ACGTACGTAC"), kmer.to_string()]
        kmer.reverse()
        out += [kmer.to_string(), kmer.from_string("ACGTN"),
                kmer.to_long(), kmer.get_signature(5)]
        return out

    out = both(probe)
    assert out[:4] == [True, "ACGTACGTAC", oracle.revcomp("ACGTACGTAC"),
                       False]


_PY_KMC_DUMP = r"""
import sys
sys.path.insert(0, {repo!r})
import {module} as pka
path, out, ci = sys.argv[1], sys.argv[2], int(sys.argv[3])
f = pka.KMCFile()
assert f.OpenForListing(path)
info = f.Info()
if ci:
    f.SetMinCount(ci)
kmer = pka.KmerAPI(info.kmer_length)
cnt = pka.Count()
with open(out, "w") as o:
    while f.ReadNextKmer(kmer, cnt):
        o.write(f"{{kmer}}\t{{cnt.value}}\n")
f.Close()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib"))
print(bad)
"""


@pytest.mark.parametrize("ci", [0, 2])
def test_py_kmc_dump_script_on_port_shim(tmp_path, ci):
    """A py_kmc_dump-style script (KMC's py_kmc_api example: Info,
    SetMinCount, KmerAPI, Count, ReadNextKmer) writes the same file on the
    port's shim as on the root shim over kmc_tpu, and the port's loads
    neither torch nor jax."""
    reads = random_reads(40, 80, seed=77)
    inp = write_fastq(tmp_path / "in.fastq", reads)
    db = str(tmp_path / "db")
    count([inp], db, k=21, cutoff_min=1, batch_positions=1 << 12,
          device="cpu")
    outs = {}
    for module in ("kmc_tpu_torch.py_kmc_api", "py_kmc_api"):
        out = tmp_path / f"{module}.txt"
        r = subprocess.run(
            [sys.executable, "-c",
             _PY_KMC_DUMP.format(repo=str(REPO), module=module),
             db, str(out), str(ci)],
            capture_output=True, text=True, timeout=600, cwd=tmp_path)
        assert r.returncode == 0, r.stderr[-800:]
        outs[module] = (out.read_text(), r.stdout.strip())
    text, loaded = outs["kmc_tpu_torch.py_kmc_api"]
    assert text == outs["py_kmc_api"][0]
    assert loaded == "[]"
    counts = oracle.count_kmers(reads, 21)
    assert sorted(text.splitlines()) == sorted(
        f"{km}\t{c}" for km, c in counts.items() if c >= ci)


def test_api_full_pybind_surface(tmp_path):
    reads = random_reads(20, 60, seed=80)
    inp = write_fastq(tmp_path / "in.fastq", reads)
    path = str(tmp_path / "db")
    count([inp], path, k=21, cutoff_min=1, batch_positions=1 << 12,
          device="cpu")

    def probe(m):
        f = m.KMCFile()
        assert f.OpenForListing(path)
        out = [f.GetBothStrands(), f.IsKMC2(), f.Eof()]
        f.SetMinCount(5)
        out.append(f.GetMinCount())
        f.ResetMinMaxCounts()
        out += [f.GetMinCount(), f.GetMaxCount()]
        n = 0
        km = m.KmerAPI(21)
        while f.ReadNextKmer(km)[0]:
            n += 1
        out += [f.Eof(), n, f.KmerCount()]
        ka = m.KmerAPI(8)
        out += [ka.from_string("ACGTACGT"), ka.get_asci_symbol(1),
                ka.get_num_symbol(3), ka.to_long()]
        kb = m.KmerAPI(8)
        kb.assign(ka)
        out += [kb == ka, kb < ka, m.KmerAPI(4) < ka, ka < m.KmerAPI(4)]
        kb.reverse()
        out += [kb.to_string(), ka.get_signature(5), str(ka)]
        return out

    out = both(probe)
    assert out[:6] == [True, True, False, 5, 1, out[5]]
    assert out[6] is True and out[7] == out[8]
    assert out[9:13] == [True, "C", 3, [0b0001101100011011]]
    assert out[13:17] == [True, False, False, False]
    assert out[17] == "ACGTACGT"
    from kmc_tpu_torch.signatures import kmer_signatures_numpy

    ka = KmerAPI(8)
    ka.from_string("ACGTACGT")
    assert out[18] == int(kmer_signatures_numpy(ka.codes, 8, 5)[0])


def test_py_kmc_api_shim_to_long():
    import py_kmc_api as jax_pka

    import kmc_tpu_torch.py_kmc_api as pka

    out = []
    for m in (pka, jax_pka):
        ka = m.KmerAPI(4)
        assert ka.from_string("ACGT")
        res = m.LongKmerRepresentation()
        assert ka.to_long(res) is None
        vec = m.CountVec()
        out.append((res.value, ka.to_long(), vec.value,
                    m.Count64(7).value))
    assert out[0] == out[1] == ([0b00011011], [0b00011011], [], 7)


def test_py_kmc_api_out_params(db):
    """CheckKmer / ReadNextKmer / GetCountersForRead with and without
    out-params, port shim against the root shim."""
    import py_kmc_api as jax_pka

    import kmc_tpu_torch.py_kmc_api as pka

    path, reads, counts = db
    out = []
    for m in (pka, jax_pka):
        f = m.KMCFile()
        assert f.OpenForRA(path)
        c, v = m.Count(), m.CountVec()
        km = next(iter(counts))
        got = [f.CheckKmer(km, c), c.value, f.CheckKmer(km),
               f.GetCountersForRead(reads[1], v), v.value,
               f.GetCountersForRead(reads[1])]
        g = m.KMCFile()
        assert g.OpenForListing(path)
        kmer = m.KmerAPI(21)
        got += [g.ReadNextKmer(kmer, c), c.value, kmer.to_string(),
                g.ReadNextKmer(kmer)]
        out.append(got)
    assert out[0] == out[1]
    assert out[0][0] is True and out[0][1] == counts[next(iter(counts))]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kff_random_access(tmp_path, writer):
    reads = random_reads(40, 80, seed=91)
    inp = write_fastq(tmp_path / "in.fastq", reads)
    out = str(tmp_path / "x")
    if writer == "port":
        count([inp], out, k=21, cutoff_min=1, batch_positions=1 << 12,
              output_file_type=OutputFileType.KFF, device="cpu")
    else:
        jax_count([inp], out, k=21, cutoff_min=1, batch_positions=1 << 12,
                  output_file_type=JaxOutputFileType.KFF)
    counts = oracle.count_kmers(reads, 21)
    queries = [km for i, km in enumerate(sorted(counts)) if i % 5 == 0]

    def probe(m):
        f = m.KMCFile()
        assert f.OpenForRA(out + ".kff")
        return (f.KmerLength(), f.KmerCount(),
                [f.CheckKmer(q) for q in queries], f.CheckKmer("A" * 21),
                f.GetCountersForRead(reads[0]))

    k, n, hits, poly_a, (ok, per_read) = both(probe)
    assert (k, n) == (21, len(counts))
    assert hits == [(True, counts[q]) for q in queries]
    assert ok and len(per_read) == len(reads[0]) - 20
    assert all(c >= 1 for c in per_read)


def test_reuse_across_wide_k_databases(tmp_path):
    """Close() then OpenForRA on a second k > 32 database uses that
    database's jump tables (the round-5 stale-cache regression)."""
    k = 45

    dbs = []
    for seed in (11, 12):
        reads = random_reads(40, 80, seed=seed)
        inp = write_fastq(tmp_path / f"in{seed}.fastq", reads)
        out = str(tmp_path / f"w{seed}")
        count([inp], out, k=k, cutoff_min=1, batch_positions=1 << 12,
              output_file_type=OutputFileType.KFF, device="cpu")
        dbs.append((out + ".kff", reads))

    def probe(m):
        f = m.KMCFile()
        res = []
        for path, reads in dbs:
            assert f.OpenForRA(path)
            res.append(f.GetCountersForRead(reads[0]))
            assert f.Close()
        return res

    for (path, reads), (ok, per_read) in zip(dbs, both(probe)):
        counts = oracle.count_kmers(reads, k)
        assert ok and len(per_read) == len(reads[0]) - k + 1
        assert per_read == [counts[min(reads[0][i:i + k],
                                       oracle.revcomp(reads[0][i:i + k]))]
                            for i in range(len(per_read))]


def test_listing_filter_change_mid_stream(tmp_path):
    reads = random_reads(80, 80, seed=95, genome_len=400)  # heavy repeats
    inp = write_fastq(tmp_path / "in.fastq", reads)
    out = str(tmp_path / "db")
    count([inp], out, k=21, cutoff_min=1, batch_positions=1 << 12,
          device="cpu")

    def walk(m, open_mode):
        f = m.KMCFile()
        assert getattr(f, open_mode)(out)
        km = m.KmerAPI()
        got = []
        ok, c = f.ReadNextKmer(km)
        assert ok
        got.append((km.to_string(), c))
        f.SetMinCount(3)
        while True:
            ok, c = f.ReadNextKmer(km)
            if not ok:
                break
            assert c >= 3
            got.append((km.to_string(), c))
        return got

    listing = both(lambda m: walk(m, "OpenForListing"))
    assert listing == both(lambda m: walk(m, "OpenForRA"))


@pytest.mark.parametrize("cfg,writer", [
    (dict(k=25, cutoff_min=1), "port"),                    # KMC2, prefix map
    (dict(k=25, cutoff_min=1, signature_map_policy="greedy"), "jax"),
    (dict(k=9, cutoff_min=1), "port"),                     # small k: KMC1
    (dict(k=9, cutoff_min=1), "jax"),
])
def test_file_ra_matches_inmemory(tmp_path, monkeypatch, cfg, writer):
    """The on-disk RA mode agrees with the in-memory one on every query
    (present, absent, non-canonical, filtered, per read), and both equal
    kmc_tpu's, on KMC2 (both signature-map policies) and KMC1 databases
    of either package."""
    seed = 300 + cfg["k"] + len(cfg)
    reads = random_reads(120, 90, seed=seed, genome_len=1500)
    inp = write_fastq(tmp_path / "fr.fastq", reads)
    path = str(tmp_path / "fr_db")
    if writer == "port":
        count([inp], path, batch_positions=1 << 12, device="cpu", **cfg)
    else:
        jax_count([inp], path, batch_positions=1 << 12, **cfg)
    counts = oracle.count_kmers(reads, cfg["k"])
    queries = list(counts)[:60]
    queries += [oracle.revcomp(q) for q in queries[:10]]
    rng = np.random.default_rng(cfg["k"])
    queries += ["".join("ACGT"[c] for c in rng.integers(0, 4, cfg["k"]))
                for _ in range(30)]  # mostly absent
    probe_reads = list(reads[:8]) + [
        reads[0][:10] + "N" + reads[0][11:],   # broken k-mers
        "N" * len(reads[0]),                   # all invalid
        reads[0][: cfg["k"] - 1],              # too short
        reads[0][: cfg["k"]]]                  # exactly one

    def probe(m, file_ra):
        if file_ra:
            monkeypatch.setenv("KMC_TPU_RA_THRESHOLD", "0")
        else:
            monkeypatch.delenv("KMC_TPU_RA_THRESHOLD", raising=False)
        f = m.KMCFile()
        assert f.OpenForRA(path)
        out = [f._is_file_ra(), [f.CheckKmer(q) for q in queries]]
        f.SetMinCount(3)
        out.append([f.CheckKmer(q) for q in queries[:30]])
        f.ResetMinMaxCounts()
        out.append([f.GetCountersForRead(rd) for rd in probe_reads])
        out.append(f.KmerCount())
        out.append(f.ReadNextKmer(m.KmerAPI(cfg["k"])))
        out.append(f.Eof())
        return out

    mem = both(lambda m: probe(m, False))
    fra = both(lambda m: probe(m, True))
    assert mem[0] is False and fra[0] is True
    assert mem[1:5] == fra[1:5]
    assert fra[-2:] == [(False, 0), True]  # on-disk RA mode does not list
