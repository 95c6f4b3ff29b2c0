"""The port's native streaming tools core against its NumPy paths and
against kmc_tpu, on the CPU: the twins of tests/test_native_tools.py's
kmc_tools cases.  Every operation runs three ways -- kmc_tpu with the
native core, the port with it, and the port with KMC_TPU_NATIVE_TOOLS=0 --
and the output files must be equal byte for byte.  The inputs are KMC1 and
multi-bin KMC2 databases and KFF files fabricated from a numpy seed with
kmc_tpu's writers."""
import filecmp
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kmc_tpu.formats.kff import KffWriter
from kmc_tpu.formats.kmc_db import KMC2_VER, DbInfo, Kmc2DbWriter, \
    write_kmc1_db
from kmc_tpu.tools import complex_ops as ref_complex
from kmc_tpu.tools import db_ops as ref_db_ops
from kmc_tpu_torch.tools import complex_ops as port_complex
from kmc_tpu_torch.tools import db_ops as port_db_ops
from kmc_tpu_torch.tools import native_tools as port_native

REPO = Path(__file__).resolve().parent.parent

# (tag, db_ops module, complex_ops module, KMC_TPU_NATIVE_TOOLS)
WAYS = (("ref", ref_db_ops, ref_complex, "1"),
        ("port", port_db_ops, port_complex, "1"),
        ("port_numpy", port_db_ops, port_complex, "0"))


def _random_records(rng, k, n, max_count=300):
    kb = (k + 3) // 4
    kmers = rng.integers(0, 256, (n, kb), dtype=np.uint8)
    kmers[:, 0] &= (1 << (2 * k - 8 * (kb - 1))) - 1
    keys = kmers.view(f"S{kb}").reshape(-1)
    _, idx = np.unique(keys, return_index=True)
    kmers = kmers[np.sort(idx)]
    kmers = kmers[np.lexsort(tuple(kmers[:, j]
                                   for j in range(kb - 1, -1, -1)))]
    counts = rng.integers(1, max_count, len(kmers)).astype(np.uint32)
    return kmers, counts


def _write_kmc1(path, k, kmers, counts, lpl, counter_size=2, cutoff_min=1,
                cutoff_max=10**9):
    info = DbInfo(kmer_len=k, counter_size=counter_size, lut_prefix_len=lpl,
                  cutoff_min=cutoff_min, cutoff_max=cutoff_max, version=0)
    write_kmc1_db(str(path), info, kmers, counts)


def _write_kmc2(path, k, kmers, counts, lpl, n_bins, rng, counter_size=2):
    """Records partitioned into bins at random, sorted in each bin."""
    info = DbInfo(kmer_len=k, counter_size=counter_size, lut_prefix_len=lpl,
                  signature_len=5, cutoff_min=1, cutoff_max=10**9,
                  n_bins=n_bins, version=KMC2_VER,
                  n_unique_stored=len(kmers))
    bins = np.sort(rng.integers(0, n_bins, len(kmers)).astype(np.int64))
    out_k = np.concatenate([kmers[bins == b] for b in range(n_bins)])
    out_c = np.concatenate([counts[bins == b] for b in range(n_bins)])
    w = Kmc2DbWriter(str(path), info, np.zeros((1 << 10) + 1, np.int32))
    w.write_all(bins, out_k, out_c)
    w.n_unique = w.n_total = len(kmers)
    w.close()


def _write_kff(path, k, kmers, counts, counter_size=2, n_sections=1,
               encoding=0b00011011):
    w = KffWriter(str(path), canonical=True, k=k, counter_size=counter_size,
                  min_count=1, max_count=10**9, encoding=encoding)
    bounds = np.linspace(0, len(kmers), n_sections + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        w.store_section(kmers[lo:hi], counts[lo:hi])
    w.close()


def three_ways(monkeypatch, tmp_path, name, fn, outs):
    """fn(db_ops, complex_ops, out_prefix) once per way; the outputs of
    the three must be equal."""
    prefixes = []
    for tag, db_ops, complex_ops, native in WAYS:
        monkeypatch.setenv("KMC_TPU_NATIVE_TOOLS", native)
        o = str(tmp_path / f"{name}_{tag}")
        fn(db_ops, complex_ops, o)
        prefixes.append(o)
    monkeypatch.delenv("KMC_TPU_NATIVE_TOOLS")
    for suf in outs:
        for o in prefixes[1:]:
            assert filecmp.cmp(prefixes[0] + suf, o + suf, shallow=False), \
                f"{o}{suf} differs from {prefixes[0]}{suf}"


@pytest.mark.parametrize("k,lpl", [(13, 5), (21, 5), (25, 1), (32, 4),
                                   (33, 5), (55, 7), (130, 6), (255, 3)])
def test_transform_ops_equivalence(k, lpl, tmp_path, monkeypatch):
    rng = np.random.default_rng(k)
    kmers, counts = _random_records(rng, k, 3000)
    db = str(tmp_path / "in")
    _write_kmc1(db, k, kmers, counts, lpl)
    kmc = [".kmc_pre", ".kmc_suf"]
    for name, fn, outs in (
            ("sort", lambda m, c, o: m.transform_sort(db, o), kmc),
            ("reduce", lambda m, c, o: m.transform_reduce(
                db, o, {"ci": 3, "cs": 100}), kmc),
            ("compact", lambda m, c, o: m.transform_compact(db, o), kmc),
            ("setc", lambda m, c, o: m.transform_set_counts(db, o, 77), kmc),
            ("dump", lambda m, c, o: m.transform_dump(db, o + ".txt", True),
             [".txt"]),
            ("hist", lambda m, c, o: m.transform_histogram(db, o + ".txt"),
             [".txt"])):
        three_ways(monkeypatch, tmp_path, name, fn, outs)


@pytest.mark.parametrize("n_bins", [7, 64])
def test_kmc2_merge_equivalence(n_bins, tmp_path, monkeypatch):
    """The loser-tree merge of a KMC2 database's bins, sorted and in file
    order, and kmc_dump."""
    import kmc_tpu.dump_cli as ref_dump
    import kmc_tpu_torch.dump_cli as port_dump

    rng = np.random.default_rng(n_bins)
    kmers, counts = _random_records(rng, 27, 20000)
    db = str(tmp_path / "in2")
    _write_kmc2(db, 27, kmers, counts, 7, n_bins, rng)

    def cli_dump(m, c, o):
        main = (ref_dump if m is ref_db_ops else port_dump).main
        assert main([db, o + ".txt"]) == 0

    for name, fn, outs in (
            ("sort2", lambda m, c, o: m.transform_sort(db, o),
             [".kmc_pre", ".kmc_suf"]),
            ("dump2", lambda m, c, o: m.transform_dump(db, o + ".txt", True),
             [".txt"]),
            ("dump2seq", lambda m, c, o: m.transform_dump(
                db, o + ".txt", False), [".txt"]),
            ("dumpcli", cli_dump, [".txt"])):
        three_ways(monkeypatch, tmp_path, name, fn, outs)


@pytest.mark.parametrize("op,mode", [
    ("union", None), ("union", "min"), ("union", "max"), ("union", "diff"),
    ("union", "left"), ("union", "right"),
    ("intersect", None), ("intersect", "sum"),
    ("kmers_subtract", None), ("counters_subtract", None),
    ("reverse_kmers_subtract", None), ("reverse_counters_subtract", None),
])
def test_simple_ops_equivalence(op, mode, tmp_path, monkeypatch):
    rng = np.random.default_rng(sum(map(ord, op + (mode or ""))))
    kmers, counts = _random_records(rng, 25, 8000)
    m1 = rng.random(len(kmers)) < 0.7
    m2 = rng.random(len(kmers)) < 0.7
    db1, db2 = str(tmp_path / "a"), str(tmp_path / "b")
    _write_kmc1(db1, 25, kmers[m1], counts[m1], 5)
    _write_kmc2(db2, 25, kmers[m2], (counts[m2] % 9 + 1).astype(np.uint32),
                5, 16, rng)
    kmc = [".kmc_pre", ".kmc_suf"]
    three_ways(monkeypatch, tmp_path, f"{op}_{mode}",
               lambda m, c, o: m.run_simple_op(op, db1, db2, o, mode), kmc)
    three_ways(monkeypatch, tmp_path, f"{op}_{mode}_cut",
               lambda m, c, o: m.run_simple_op(
                   op, db1, db2, o, mode, in1_cut=(3, 200),
                   in2_cut=(2, None)), kmc)


def test_compare_equivalence(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    kmers, counts = _random_records(rng, 21, 4000)
    db1, db2, db3 = (str(tmp_path / n) for n in ("c1", "c2", "c3"))
    _write_kmc1(db1, 21, kmers, counts, 5)
    _write_kmc2(db2, 21, kmers, counts, 5, 16, rng)
    _write_kmc1(db3, 21, kmers[1:], counts[1:], 5)
    for _, db_ops, _, native in WAYS:
        monkeypatch.setenv("KMC_TPU_NATIVE_TOOLS", native)
        assert db_ops.db_compare(db1, db2) is True
        assert db_ops.db_compare(db1, db3) is False


def _def_file(path, text):
    Path(path).write_text(text)
    return str(path)


def test_complex_native_equivalence(tmp_path, monkeypatch):
    rng = np.random.default_rng(31)
    kmers, counts = _random_records(rng, 25, 6000)
    m1 = rng.random(len(kmers)) < 0.7
    m2 = rng.random(len(kmers)) < 0.7
    a, b = str(tmp_path / "ca"), str(tmp_path / "cb")
    _write_kmc1(a, 25, kmers[m1], counts[m1], 5)
    _write_kmc2(b, 25, kmers[m2], (counts[m2] % 11 + 1).astype(np.uint32),
                5, 8, rng)
    for i, (expr, params) in enumerate([
            ("(a *max b) + (a - b)", "-ci2"), ("a ~ (b +min a)", ""),
            ("((a + b) * a) +diff b", "-ci1 -cs100"), ("a", "-ci3")]):
        three_ways(monkeypatch, tmp_path, f"cx{i}", lambda m, c, o: (
            c.run_complex_file(_def_file(
                o + ".def", f"INPUT:\na={a} -ci2\nb={b}\nOUTPUT:\n{o}={expr}\n"
                + (f"OUTPUT_PARAMS:\n{params}\n" if params else "")))),
            [".kmc_pre", ".kmc_suf"])


def test_chunk_parallel_threads_identical(tmp_path):
    """The port's chunk-parallel native drivers write the same bytes at -t1
    and -t4, and kmc_tpu's at -t4 too."""
    from kmc_tpu.tools import native_tools as ref_native

    rng = np.random.default_rng(31)
    for k, lpl, n_bins in ((25, 5, 64), (75, 3, 8)):
        kmers, counts = _random_records(rng, k, 20000)
        a, b = str(tmp_path / f"ta{k}"), str(tmp_path / f"tb{k}")
        m = rng.random(len(kmers)) < 0.6
        _write_kmc2(a, k, kmers[m], counts[m], lpl, n_bins, rng)
        m2 = rng.random(len(kmers)) < 0.5
        _write_kmc2(b, k, kmers[m2], (counts[m2] % 9 + 1).astype(np.uint32),
                    lpl, n_bins, rng)

        def run_all(db_ops, complex_ops, tag):
            outs = []
            o = str(tmp_path / f"s_{k}_{tag}")
            db_ops.transform_sort(a, o)
            outs += [o + ".kmc_pre", o + ".kmc_suf"]
            o = str(tmp_path / f"u_{k}_{tag}")
            db_ops.run_simple_op("union", a, b, o)
            outs += [o + ".kmc_pre", o + ".kmc_suf"]
            o = str(tmp_path / f"d_{k}_{tag}.txt")
            db_ops.transform_dump(a, o, sorted_output=True)
            outs.append(o)
            o = str(tmp_path / f"x_{k}_{tag}")
            complex_ops.run_complex_file(_def_file(
                o + ".def", f"INPUT:\nia={a} -ci2\nib={b}\nOUTPUT:\n"
                f"{o}=(ia *max ib) + (ia - ib)\n"))
            outs += [o + ".kmc_pre", o + ".kmc_suf"]
            return outs

        try:
            port_native.set_threads(1)
            base = run_all(port_db_ops, port_complex, "t1")
            port_native.set_threads(4)
            got = run_all(port_db_ops, port_complex, "t4")
            ref_native.set_threads(4)
            ref = run_all(ref_db_ops, ref_complex, "ref_t4")
        finally:
            port_native.set_threads(None)
            ref_native.set_threads(None)
        for x, y, z in zip(base, got, ref):
            assert filecmp.cmp(x, y, shallow=False), (k, x)
            assert filecmp.cmp(x, z, shallow=False), (k, x)


def test_native_union_bounded_address_space(tmp_path):
    """The port's native union of two 6 M-record databases under a 450 MB
    RLIMIT_AS, with neither torch nor jax loaded, writes the bytes of the
    unconstrained run and of kmc_tpu's."""
    port_native.get_lib()  # built here: the child's cap would stop g++
    rng = np.random.default_rng(1)
    k, kb = 25, 7
    paths = []
    for i in range(2):
        kmers = rng.integers(0, 256, (6_000_000, kb), dtype=np.uint8)
        kmers[:, 0] &= 0x03
        kmers = kmers[np.lexsort(tuple(kmers[:, j]
                                       for j in range(kb - 1, -1, -1)))]
        dup = np.ones(len(kmers), bool)
        dup[1:] = (kmers[1:] != kmers[:-1]).any(axis=1)
        kmers = kmers[dup]
        counts = rng.integers(1, 200, len(kmers)).astype(np.uint32)
        p = str(tmp_path / f"nbig{i}")
        _write_kmc1(p, k, kmers, counts, 5, counter_size=1)
        paths.append(p)
        del kmers, counts
    out = str(tmp_path / "n_union")
    script = f"""
import resource, sys
resource.setrlimit(resource.RLIMIT_AS, (450 << 20, 450 << 20))
sys.path.insert(0, {str(REPO)!r})
from kmc_tpu_torch.tools.db_ops import run_simple_op
print("records:", run_simple_op("union", {paths[0]!r}, {paths[1]!r},
                                {out!r}))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "kmc_tpu"))
assert not loaded, loaded
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    free, ref = str(tmp_path / "n_union_free"), str(tmp_path / "n_union_ref")
    port_db_ops.run_simple_op("union", paths[0], paths[1], free)
    ref_db_ops.run_simple_op("union", paths[0], paths[1], ref)
    for suf in (".kmc_pre", ".kmc_suf"):
        assert filecmp.cmp(out + suf, free + suf, shallow=False), suf
        assert filecmp.cmp(out + suf, ref + suf, shallow=False), suf


def test_counter_size_zero_input(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    kmers, _ = _random_records(rng, 21, 2000)
    db = str(tmp_path / "cs0")
    _write_kmc1(db, 21, kmers, np.ones(len(kmers), np.uint32), 5,
                counter_size=0)
    three_ways(monkeypatch, tmp_path, "cs0sort",
               lambda m, c, o: m.transform_sort(db, o),
               [".kmc_pre", ".kmc_suf"])
    three_ways(monkeypatch, tmp_path, "cs0dump",
               lambda m, c, o: m.transform_dump(db, o + ".txt", True),
               [".txt"])


@pytest.mark.parametrize("k,n_sections,lpl2",
                         [(21, 1, 5), (27, 5, 7), (55, 3, 3)])
def test_kff_native_equivalence(k, n_sections, lpl2, tmp_path, monkeypatch):
    rng = np.random.default_rng(k + n_sections)
    kmers, counts = _random_records(rng, k, 2500)
    kff = str(tmp_path / "in.kff")
    _write_kff(kff, k, kmers, counts, n_sections=n_sections)
    kmers2, counts2 = _random_records(rng, k, 1500)
    db2 = str(tmp_path / "db2")
    _write_kmc1(db2, k, kmers2, counts2, lpl2)
    kmc = [".kmc_pre", ".kmc_suf"]
    for name, fn, outs in (
            ("ksort", lambda m, c, o: m.transform_sort(kff, o), kmc),
            ("kdump", lambda m, c, o: m.transform_dump(kff, o + ".txt", True),
             [".txt"]),
            ("khist", lambda m, c, o: m.transform_histogram(kff, o + ".txt"),
             [".txt"]),
            ("okff", lambda m, c, o: m.transform_sort(db2, o + ".kff"),
             [".kff"]),
            ("kunion", lambda m, c, o: m.run_simple_op(
                "union", kff, db2, o, "sum", {}), kmc),
            ("kint", lambda m, c, o: m.run_simple_op(
                "intersect", kff, db2, o + ".kff", "min", {}), [".kff"]),
            ("ksetc", lambda m, c, o: m.transform_set_counts(
                kff, o + ".kff", 9), [".kff"])):
        three_ways(monkeypatch, tmp_path, name, fn, outs)


def test_kff_non_default_encoding_native(tmp_path, monkeypatch):
    rng = np.random.default_rng(99)
    enc = 0b00011110
    kmers, counts = _random_records(rng, 25, 1200)
    a, b = str(tmp_path / "a.kff"), str(tmp_path / "b.kff")
    _write_kff(a, 25, kmers, counts, encoding=enc, n_sections=2)
    kmers2, counts2 = _random_records(rng, 25, 900)
    _write_kff(b, 25, kmers2, counts2, encoding=enc)
    three_ways(monkeypatch, tmp_path, "eunion", lambda m, c, o: (
        m.run_simple_op("union", a, b, o + ".kff", "sum", {})), [".kff"])
    three_ways(monkeypatch, tmp_path, "edump", lambda m, c, o: (
        m.transform_dump(a, o + ".txt", True)), [".txt"])


def test_complex_native_kff_and_single_pass(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    kmers, counts = _random_records(rng, 25, 2000)
    db1 = str(tmp_path / "c1")
    _write_kmc1(db1, 25, kmers, counts, 5, cutoff_min=2)
    kmers2, counts2 = _random_records(rng, 25, 1500)
    kff2 = str(tmp_path / "c2.kff")
    _write_kff(kff2, 25, kmers2, counts2, n_sections=2)

    def run(c, out):
        assert c.run_complex_file(_def_file(
            out + ".def", f"INPUT:\na={db1}\nb={kff2} -ci2\nOUTPUT:\n"
            f"{out}=(a*max b)+(a-b)\n"))

    three_ways(monkeypatch, tmp_path, "cplx_kmc",
               lambda m, c, o: run(c, o), [".kmc_pre", ".kmc_suf"])
    three_ways(monkeypatch, tmp_path, "cplx_kff",
               lambda m, c, o: run(c, o + ".kff"), [".kff"])


@pytest.mark.parametrize("k", [25, 55])
def test_filter_native_equivalence(k, tmp_path, monkeypatch):
    """filter with the native lookup (k <= 32 and the wide k > 32 one)
    against the port's NumPy lookup and kmc_tpu's."""
    import kmc_tpu.tools.fastq_filter as ref_ff
    import kmc_tpu_torch.tools.fastq_filter as port_ff
    from kmc_tpu.oracle import count_kmers

    rng = np.random.default_rng(23 + k)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 5000))
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(200):
            seq = (genome[(st := int(rng.integers(0, 4900))):st + 80]
                   if i % 2 else "".join("ACGT"[j]
                                         for j in rng.integers(0, 4, 80)))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    cnt = count_kmers([genome], k, True, False)
    ks = sorted(cnt)
    kb = (k + 3) // 4
    rows = np.zeros((len(ks), kb), np.uint8)
    for i, km in enumerate(ks):
        v = int("".join("0123"["ACGT".index(ch)] for ch in km), 4)
        rows[i] = np.frombuffer(v.to_bytes(kb, "big"), np.uint8)
    db = str(tmp_path / "fdb")
    _write_kmc1(db, k, rows, np.array([cnt[km] for km in ks], np.uint32),
                5 if k <= 32 else 7)
    n_kept = []
    for mode in ({"min_kmers": 0.5}, {"trim": True, "min_kmers": 2},
                 {"hard_mask": True, "min_kmers": 2}):
        outs = []
        for ff, native in ((ref_ff, "1"), (port_ff, "1"), (port_ff, "0")):
            monkeypatch.setenv("KMC_TPU_NATIVE_TOOLS", native)
            o = tmp_path / "out.fq"
            ff.filter_fastq(db, str(fq), str(o), **mode)
            outs.append(o.read_bytes())
        assert outs[0] == outs[1] == outs[2], mode
        n_kept.append(outs[0].count(b"@r"))
    assert 0 < n_kept[0] < 200  # the fraction filter separates the reads
