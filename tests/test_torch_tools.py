"""The port's kmc_tools against kmc_tpu's, on the CPU: the twins of
tests/test_tools.py.  Each case runs the same operations through both
packages (kmc_tpu's tools_cli / db_ops / complex_ops / fastq_filter and
kmc_tpu_torch's) into a directory of its own, and every file written, every
return value and the captured stdout / stderr must be equal, byte for byte
(KMC1 / KMC2 / KFF outputs, dumps, histograms, info / check text, compare's
exit code, the filter's FASTQ / FASTA).  The input databases are counted by
the port on the CPU from a numpy seed."""
import gzip
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

from kmc_tpu_torch import count  # noqa: E402

PKGS = ("kmc_tpu", "kmc_tpu_torch")


def mods(pkg: str) -> SimpleNamespace:
    imp = importlib.import_module
    return SimpleNamespace(
        pkg=pkg, cli=imp(f"{pkg}.tools_cli"), db_ops=imp(f"{pkg}.tools.db_ops"),
        complex_ops=imp(f"{pkg}.tools.complex_ops"),
        ff=imp(f"{pkg}.tools.fastq_filter"),
        native=imp(f"{pkg}.tools.native_tools"),
        kff=imp(f"{pkg}.formats.kff"), kmc_db=imp(f"{pkg}.formats.kmc_db"),
        dump=imp(f"{pkg}.formats.dump"),
        streaming=imp(f"{pkg}.formats.streaming"))


def _tree(d: Path) -> dict:
    """Every file under d, its path and bytes with d itself masked (a
    gzip file by its content: its header holds the time it was written)."""
    out = {}
    for p in sorted(d.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            if p.suffix == ".gz":
                data = gzip.decompress(data)
            out[str(p.relative_to(d))] = data.replace(str(d).encode(), b"<D>")
    return out


def twin(tmp_path, body, capsys=None):
    """Run body(m, d) for kmc_tpu and for the port; their return values
    (as repr, d masked), files and captured output must be equal.  Returns kmc_tpu's
    (value, files)."""
    res = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        ret = body(mods(pkg), d)
        shown = repr(ret).replace(str(d), "<D>")
        text = None
        if capsys is not None:
            cap = capsys.readouterr()
            text = (cap.out.replace(str(d), "<D>"),
                    cap.err.replace(str(d), "<D>"))
        res[pkg] = (ret, shown, _tree(d), text)
    (r_ret, r_shown, r_files, r_text), (_, p_shown, p_files, p_text) = \
        res.values()
    assert p_shown == r_shown
    assert sorted(p_files) == sorted(r_files)
    for name, data in r_files.items():
        assert p_files[name] == data, name
    assert p_text == r_text
    return r_ret, r_files


@pytest.fixture
def two_dbs(tmp_path):
    reads1 = random_reads(60, 70, seed=1, genome_len=400)
    reads2 = random_reads(60, 70, seed=2, genome_len=400)
    db1 = str(tmp_path / "db1")
    db2 = str(tmp_path / "db2")
    count([write_fastq(tmp_path / "a.fq", reads1)], db1, k=21, cutoff_min=1,
          batch_positions=1 << 12, device="cpu")
    count([write_fastq(tmp_path / "b.fq", reads2)], db2, k=21, cutoff_min=1,
          batch_positions=1 << 12, device="cpu")
    from kmc_tpu_torch.formats.dump import dump_db_file

    def counts(db):
        return {ln.split("\t")[0]: int(ln.split("\t")[1])
                for ln in dump_db_file(db).splitlines()}

    return db1, db2, counts(db1), counts(db2)


def _db_files(tree: dict, name: str) -> bool:
    return f"{name}.kmc_pre" in tree and f"{name}.kmc_suf" in tree


@pytest.mark.parametrize("op", ["union", "intersect", "kmers_subtract",
                                "counters_subtract"])
def test_simple_op(two_dbs, tmp_path, op):
    db1, db2, _, _ = two_dbs
    _, files = twin(tmp_path, lambda m, d: m.db_ops.run_simple_op(
        op, db1, db2, str(d / "o")))
    assert _db_files(files, "o")


def test_intersect_counter_modes(two_dbs, tmp_path):
    db1, db2, _, _ = two_dbs

    def body(m, d):
        return [m.db_ops.run_simple_op("intersect", db1, db2,
                                       str(d / f"m_{mode}"), mode=mode)
                for mode in ("max", "sum", "left", "right")]

    twin(tmp_path, body)


def test_transform_sort_and_dump(two_dbs, tmp_path):
    db1, _, _, _ = two_dbs

    def body(m, d):
        m.db_ops.transform_sort(db1, str(d / "sorted"))
        return (m.dump.dump_db_file(str(d / "sorted")),
                m.kmc_db.read_db(str(d / "sorted")).info.version)

    (text, version), files = twin(tmp_path, body)
    assert version == 0 and text and _db_files(files, "sorted")


def test_transform_histogram(two_dbs, tmp_path):
    db1, _, _, _ = two_dbs
    _, files = twin(tmp_path, lambda m, d: m.db_ops.transform_histogram(
        db1, str(d / "hist.txt"), 1, 300))
    assert files["hist.txt"].count(b"\n") == 300


def test_transform_reduce(two_dbs, tmp_path):
    db1, _, _, _ = two_dbs
    twin(tmp_path, lambda m, d: m.db_ops.transform_reduce(
        db1, str(d / "red"), m.db_ops.OutputParams(
            cutoff_min=2, cutoff_max=100, counter_max=10)))


def test_transform_set_counts_and_compact(two_dbs, tmp_path):
    db1, _, _, _ = two_dbs

    def body(m, d):
        m.db_ops.transform_set_counts(db1, str(d / "sc"), 7)
        m.db_ops.transform_compact(db1, str(d / "cp"))
        return m.kmc_db.read_db(str(d / "cp")).info.counter_size

    assert twin(tmp_path, body)[0] == 1


def test_tools_counter_size_rule():
    """tools_counter_size gives kmc_tpu's widths over a grid of limits."""
    from kmc_tpu.tools.db_ops import tools_counter_size as ref
    from kmc_tpu_torch.tools.db_ops import tools_counter_size as port

    for cs in (1, 255, 256, 65535, 10**9, 0xFFFFFFFF, 2**40):
        for cx in (1, 255, 65535, 10**9, 2**40):
            assert port(cs, cx) == ref(cs, cx), (cs, cx)
    for value in (0, 7, 300, 70000, 2**33):
        for kff in (False, True):
            assert port(0xFFFFFFFF, 0xFFFFFFFF, counter_value=value,
                        kff=kff) == ref(0xFFFFFFFF, 0xFFFFFFFF,
                                        counter_value=value, kff=kff)


def test_compact_header_fields(two_dbs, tmp_path):
    db1, _, _, _ = two_dbs

    def body(m, d):
        m.db_ops.transform_compact(db1, str(d / "cp_ci"), {"ci": 3})
        info = m.kmc_db.read_db(str(d / "cp_ci")).info
        return info.counter_size, info.cutoff_min

    assert twin(tmp_path, body)[0] == (1, 3)


def test_set_counts_header_fields(two_dbs, tmp_path):
    db1, _, _, _ = two_dbs

    def body(m, d):
        m.db_ops.transform_set_counts(db1, str(d / "sc_hdr"), 300)
        info = m.kmc_db.read_db(str(d / "sc_hdr")).info
        return info.counter_size, info.cutoff_min, info.cutoff_max

    assert twin(tmp_path, body)[0] == (2, 1, 0xFFFFFFFF)


def test_compare(two_dbs, tmp_path):
    db1, db2, _, _ = two_dbs
    assert twin(tmp_path, lambda m, d: (
        m.db_ops.db_compare(db1, db1), m.db_ops.db_compare(db1, db2)))[0] \
        == (True, False)


def _complex(m, d, text, name="ops.txt"):
    f = d / name
    f.write_text(text.replace("<D>", str(d)))
    return m.complex_ops.run_complex_file(str(f))


def test_complex_expression(two_dbs, tmp_path):
    db1, db2, _, _ = two_dbs
    _, files = twin(tmp_path, lambda m, d: _complex(
        m, d, f"INPUT:\na = {db1}\nb = {db2}\nOUTPUT:\n<D>/cx = (a - b) + "
        "(a * b)\nOUTPUT_PARAMS:\n-ci1\n"))
    assert _db_files(files, "cx")


def _encoded_kff(m, db1, kff, enc=0b11100100):
    """db1's k-mers in a KFF file of another encoding (the writer of
    tests/test_tools.py's write_encoded_kff, through m's KffWriter)."""
    trans = str.maketrans("ACGT", "TGCA")
    perm = {"A": (enc >> 6) & 3, "C": (enc >> 4) & 3,
            "G": (enc >> 2) & 3, "T": enc & 3}
    recs = {}
    for ln in m.dump.dump_db_file(db1).splitlines():
        km, c = ln.split("\t")
        rc = km.translate(trans)[::-1]
        recs[min(km, rc, key=lambda s: s.translate(trans))] = int(c)
    k = len(next(iter(recs)))
    kb = (k + 3) // 4
    reprs = sorted(recs, key=lambda s: s.translate(trans))
    rows = np.zeros((len(reprs), kb), np.uint8)
    for i, s in enumerate(reprs):
        syms = [0] * (kb * 4 - k) + [perm[ch] for ch in s]
        for j, v in enumerate(syms):
            rows[i, j // 4] |= v << (2 * (3 - (j % 4)))
    w = m.kff.KffWriter(kff, canonical=True, k=k, counter_size=1,
                        min_count=1, max_count=255, encoding=enc)
    w.store_section(rows, np.array([recs[s] for s in reprs], np.uint32))
    w.close()


def test_kff_nondefault_encoding(two_dbs, tmp_path, capsys):
    db1, _, c1, _ = two_dbs
    km = next(iter(c1))

    def body(m, d):
        kff = str(d / "enc.kff")
        _encoded_kff(m, db1, kff)
        rc = [m.cli.main(["transform", kff, "dump", str(d / "enc.txt")]),
              m.cli.main(["check", kff, km])]
        with pytest.raises(ValueError, match="different k-mers encodings"):
            m.db_ops.run_simple_op("union", kff, db1, str(d / "mix"))
        m.db_ops.run_simple_op("union", kff, kff, str(d / "u_enc"))
        rc.append(m.cli.main(["transform", str(d / "u_enc.kff"), "dump",
                              str(d / "u_enc.txt")]))
        return rc

    rc, files = twin(tmp_path, body, capsys)
    assert rc == [0, 0, 0] and "u_enc.kff" in files
    assert "u_enc.kmc_pre" not in files


def test_complex_okff_output(two_dbs, tmp_path):
    db1, db2, _, _ = two_dbs

    def body(m, d):
        _complex(m, d, f"INPUT:\na = {db1}\nb = {db2}\nOUTPUT:\n"
                 "<D>/cx_kff = a + b\nOUTPUT_PARAMS:\n-ci1 -okff\n")
        with pytest.raises(ValueError, match="unknown output type"):
            _complex(m, d, f"INPUT:\na = {db1}\nOUTPUT:\n<D>/z = a\n"
                     "OUTPUT_PARAMS:\n-obad\n", "bad.txt")

    assert "cx_kff.kff" in twin(tmp_path, body)[1]


def test_tools_cli(two_dbs, tmp_path, capsys):
    db1, db2, c1, _ = two_dbs
    km = next(iter(c1))

    def body(m, d):
        return [
            m.cli.main(["info", db1]),
            m.cli.main(["check", db1, km]),
            m.cli.main(["transform", db1, "dump", str(d / "d.txt")]),
            m.cli.main(["transform", db1, "dump", "-s", str(d / "ds.txt")]),
            m.cli.main(["simple", db1, db2, "union", "-ocmax",
                        str(d / "u2")]),
            m.cli.main(["compare", db1, db1]),
            m.cli.main(["compare", db1, db2]),
        ]

    assert twin(tmp_path, body, capsys)[0] == [0, 0, 0, 0, 0, 0, 1]


def test_info_and_check_text(two_dbs, tmp_path, capsys):
    """info and check print kmc_tpu's text for KMC2, KMC1 and KFF files."""
    db1, db2, c1, _ = two_dbs
    kms = list(c1)[:3] + ["A" * 21]

    def body(m, d):
        m.db_ops.run_simple_op("union", db1, db2, str(d / "u"))
        m.db_ops.transform_sort(db1, str(d / "s.kff"))
        rc = []
        for db in (db1, str(d / "u"), str(d / "s.kff")):
            rc.append(m.cli.main(["info", db]))
            rc += [m.cli.main(["check", db, km]) for km in kms]
        return rc

    twin(tmp_path, body, capsys)


def test_complex_expression_streaming_matches(two_dbs, tmp_path,
                                              monkeypatch):
    db1, db2, _, _ = two_dbs

    def body(m, d):
        for i, (expr, params) in enumerate([
                ("(a - b) + (a * b)", "-ci1"),
                ("a +max b ~ (b *sum a)", "-ci1 -cs60000"),
                ("a - (b - a)", "-ci1")]):
            for tag, thr in (("mem", "99999999999"), ("stream", "0")):
                monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", thr)
                _complex(m, d, f"INPUT:\na = {db1} -ci1\nb = {db2} -cx50000"
                         f"\nOUTPUT:\n<D>/cxs{i}_{tag} = {expr}\n"
                         f"OUTPUT_PARAMS:\n{params}\n", f"ops{i}_{tag}.txt")
        monkeypatch.delenv("KMC_TPU_STREAM_THRESHOLD")

    _, files = twin(tmp_path, body)
    for i in range(3):
        for suf in (".kmc_pre", ".kmc_suf"):
            assert files[f"cxs{i}_mem{suf}"] == files[f"cxs{i}_stream{suf}"]


def test_complex_streaming_rejects_k_mismatch(tmp_path, monkeypatch):
    inp = write_fastq(tmp_path / "km.fastq", random_reads(40, 80, seed=11))
    db1, db2 = str(tmp_path / "km21"), str(tmp_path / "km25")
    count([inp], db1, k=21, cutoff_min=1, batch_positions=1 << 12,
          device="cpu")
    count([inp], db2, k=25, cutoff_min=1, batch_positions=1 << 12,
          device="cpu")

    def body(m, d):
        for thr in ("99999999999", "0"):
            monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", thr)
            with pytest.raises(ValueError, match="mismatch"):
                _complex(m, d, f"INPUT:\na = {db1}\nb = {db2}\nOUTPUT:\n"
                         "<D>/cx_mismatch = a + b\n")
        monkeypatch.delenv("KMC_TPU_STREAM_THRESHOLD")

    run = tmp_path / "run"
    run.mkdir()
    twin(run, body)


def test_simple_input_cuts_cli(two_dbs, tmp_path, monkeypatch):
    db1, db2, _, _ = two_dbs

    def body(m, d):
        rc = []
        for op in ("intersect", "union", "kmers_subtract"):
            rc.append(m.cli.main(["simple", db1, "-ci2", db2, "-cx3", op,
                                  str(d / f"m_{op}")]))
            monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", "0")
            rc.append(m.cli.main(["simple", db1, "-ci2", db2, "-cx3", op,
                                  str(d / f"s_{op}")]))
            monkeypatch.delenv("KMC_TPU_STREAM_THRESHOLD")
        return rc

    rc, files = twin(tmp_path, body)
    assert rc == [0] * 6
    for op in ("intersect", "union", "kmers_subtract"):
        assert files[f"m_{op}.kmc_suf"] == files[f"s_{op}.kmc_suf"]


def test_output_defaults_from_inputs(two_dbs, tmp_path):
    db1, db2, _, _ = two_dbs
    assert twin(tmp_path, lambda m, d: [
        m.cli.main(["simple", db1, "-ci2", db2, "counters_subtract",
                    str(d / "cs")]),
        m.cli.main(["simple", db1, "-ci2", db2, "counters_subtract",
                    str(d / "cs3"), "-ci3"])])[0] == [0, 0]


def test_transform_input_cut(two_dbs, tmp_path, monkeypatch):
    db1, _, _, _ = two_dbs

    def body(m, d):
        rc = [m.cli.main(["transform", db1, "-ci2", "dump", "-s",
                          str(d / "d.txt"), "histogram", str(d / "h.txt"),
                          "sort", str(d / "srt")])]
        monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", "0")
        rc.append(m.cli.main(["transform", db1, "-ci2", "dump", "-s",
                              str(d / "d2.txt"), "histogram",
                              str(d / "h2.txt"), "sort", str(d / "srt2")]))
        monkeypatch.delenv("KMC_TPU_STREAM_THRESHOLD")
        return rc

    rc, files = twin(tmp_path, body)
    assert rc == [0, 0] and files["d.txt"] == files["d2.txt"]


def test_simple_multi_output_single_pass(two_dbs, tmp_path):
    db1, db2, _, _ = two_dbs

    def body(m, d):
        rc = [m.cli.main(["simple", db1, "-ci2", db2,
                          "intersect", "-ocmax", str(d / "mo_0"),
                          "union", str(d / "mo_1"), "-ci2",
                          "reverse_counters_subtract", str(d / "mo_2")])]
        for args in (["intersect", "-ocmax", str(d / "so_0")],
                     ["union", str(d / "so_1"), "-ci2"],
                     ["reverse_counters_subtract", str(d / "so_2")]):
            rc.append(m.cli.main(["simple", db1, "-ci2", db2, *args]))
        return rc

    rc, files = twin(tmp_path, body)
    assert rc == [0] * 4
    for j in range(3):
        assert files[f"mo_{j}.kmc_suf"] == files[f"so_{j}.kmc_suf"]


def test_global_params_and_okff(two_dbs, tmp_path):
    db1, db2, _, _ = two_dbs

    def body(m, d):
        rc = [m.cli.main(["-t4", "-v", "-hp", "simple", db1, db2,
                          "union", str(d / "u_kmc"), "-okmc",
                          "union", str(d / "u_kff"), "-okff"])]
        params = dict(m.cli.GLOBAL_PARAMS)
        rc += [
            m.cli.main(["transform", str(d / "u_kmc"), "dump", "-s",
                        str(d / "d_kmc.txt")]),
            m.cli.main(["transform", str(d / "u_kff.kff"), "dump", "-s",
                        str(d / "d_kff.txt")]),
            m.cli.main(["transform", db1, "set_counts", "9", str(d / "sc"),
                        "-okff"]),
            m.cli.main(["transform", str(d / "sc.kff"), "dump", "-s",
                        str(d / "d_sc.txt")]),
            m.cli.main(["transform", db1, "histogram", str(d / "h"),
                        "-okff"]),
            m.cli.main(["transform", db1, "sort", str(d / "x"), "-obad"]),
            m.cli.main(["-zz", "simple", db1, db2, "union", str(d / "y")]),
            m.cli.main(["-t"]),
        ]
        m.native.set_threads(None)
        return rc, params

    (rc, params), files = twin(tmp_path, body)
    assert rc == [0, 0, 0, 0, 0, 1, 1, 1, 1]
    assert params == {"threads": 4, "verbose": True, "hide_progress": True}
    assert files["d_kmc.txt"] == files["d_kff.txt"]


def test_transform_multi_output_single_pass(two_dbs, tmp_path):
    db1, _, _, _ = two_dbs
    ops = {"sort": ["sort", "{}", "-cs100"], "red": ["reduce", "{}", "-ci3"],
           "cmp": ["compact", "{}"], "sc": ["set_counts", "5", "{}"],
           "hist": ["histogram", "{}"], "dump": ["dump", "-s", "{}"]}

    def body(m, d):
        multi = [a.format(d / f"m_{n}") for n, op in ops.items() for a in op]
        rc = [m.cli.main(["transform", db1, "-ci2", *multi])]
        for n, op in ops.items():
            rc.append(m.cli.main(["transform", db1, "-ci2",
                                  *[a.format(d / f"s_{n}") for a in op]]))
        return rc

    rc, files = twin(tmp_path, body)
    assert rc == [0] * 7
    assert files["m_hist"] == files["s_hist"]
    assert files["m_red.kmc_suf"] == files["s_red.kmc_suf"]


def test_filter_mode_rules(two_dbs, tmp_path, capsys):
    db1, _, c1, _ = two_dbs
    km = next(iter(c1))

    def body(m, d):
        fq = d / "q.fq"
        fq.write_text(f"@r\n{km}\n+\n{'I' * len(km)}\n")
        return [m.cli.main(["filter", "-t", db1, str(fq), "-ci0.5",
                            str(d / "o.fq")]),
                m.cli.main(["filter", "-t", "-hm", db1, str(fq), "-ci5",
                            str(d / "a.fq")]),
                m.cli.main(["filter", "-hm", db1, str(fq), "-ci5",
                            str(d / "b.fq")])]

    rc, files = twin(tmp_path, body, capsys)
    assert rc == [1, 0, 0] and files["a.fq"] == files["b.fq"]


def test_filter_list_input_and_format_rules(two_dbs, tmp_path, capsys):
    db1, _, c1, _ = two_dbs
    kms = [km for km, c in c1.items() if c >= 2]

    def body(m, d):
        q1, q2 = d / "q1.fq", d / "q2.fq"
        q1.write_text(f"@a\n{kms[0]}\n+\n{'I' * 21}\n")
        q2.write_text(f"@b\n{kms[1]}\n+\n{'I' * 21}\n")
        lst = d / "inputs.lst"
        lst.write_text(f"{q1}\n{q2}\n")
        out = str(d / "o.fq")
        return [m.cli.main(["filter", db1, f"@{lst}", "-ci1", out]),
                m.cli.main(["filter", db1, "@/nonexistent.lst", out]),
                m.cli.main(["filter", db1, str(q1), "-fa", out, "-fq"])]

    assert twin(tmp_path, body, capsys)[0] == [0, 1, 1]


def test_transform_sort_on_kmc1_omitted(two_dbs, tmp_path, capsys):
    db1, db2, _, _ = two_dbs

    def body(m, d):
        return [m.cli.main(["simple", db1, db2, "union", str(d / "u")]),
                m.cli.main(["transform", str(d / "u"), "sort", str(d / "s"),
                            "histogram", str(d / "h")]),
                m.cli.main(["transform", db1, "sort", str(d / "s2")])]

    rc, files = twin(tmp_path, body, capsys)
    assert rc == [0, 0, 0] and "s.kmc_pre" not in files and "h" in files


def test_simple_oc_mode_after_output(two_dbs, tmp_path):
    db1, db2, _, _ = two_dbs
    _, files = twin(tmp_path, lambda m, d: [
        m.cli.main(["simple", db1, db2, "intersect", "-ocsum",
                    str(d / "pre")]),
        m.cli.main(["simple", db1, db2, "intersect", str(d / "post"),
                    "-ocsum"])])
    assert files["pre.kmc_suf"] == files["post.kmc_suf"]


def test_filter_db_cutoffs_and_fasta_output(two_dbs, tmp_path):
    db1, _, c1, _ = two_dbs
    common = [km for km, c in c1.items() if c >= 2][0]
    rare = [km for km, c in c1.items() if c == 1][0]

    def body(m, d):
        fq = d / "q.fq"
        fq.write_text(f"@common\n{common}\n+\n{'I' * 21}\n"
                      f"@rare\n{rare}\n+\n{'I' * 21}\n")
        return [m.cli.main(["filter", db1, "-ci2", str(fq), "-ci1",
                            str(d / "o.fq")]),
                m.cli.main(["filter", db1, str(fq), "-ci1", str(d / "o2.fq")]),
                m.cli.main(["filter", db1, str(fq), "-ci1", str(d / "o.fa"),
                            "-fa"])]

    rc, files = twin(tmp_path, body)
    assert rc == [0, 0, 0] and files["o.fa"].startswith(b">common\n")


def _filter_cases(kms):
    plain = "".join(f"@q{i}\n{km}\n+\n{'I' * len(km)}\n"
                    for i, km in enumerate(kms))
    keep = dict(min_kmers=1)
    cut = "".join(f"@c{i}\n{km}TTTTTTTTAA\n+\n{'I' * 41}\n"
                  for i, km in enumerate(kms))
    return {
        "plain": (plain, keep),
        "crlf": (plain.replace("\n", "\r\n"), keep),
        "plusid": ("".join(f"@q{i}\n{km}\n+q{i}\n{'I' * len(km)}\n"
                           for i, km in enumerate(kms)), keep),
        "short": ("@s\nACGTACGT\n+\nIIIIIIII\n" + plain, keep),
        "notrail": (plain.rstrip("\n"), keep),
        "fasta": ("".join(f">q{i}\n{km}\n" for i, km in enumerate(kms)),
                  keep),
        "emptyseq": ("@e0\n\n+\n\n" + plain, keep),
        "dropall": (plain, {}),
        "frac": (plain, dict(min_kmers=0.3, max_kmers=1.0)),
        "fq2fa": (plain, dict(out_format="a", min_kmers=1)),
        "partialtail": (plain + "@tail\nACGTACGT", keep),
        "trim_cut": (cut, dict(min_kmers=2, trim=True)),
        "hm_cut": (cut, dict(min_kmers=2, hard_mask=True)),
        "hm2fa": (cut, dict(min_kmers=2, hard_mask=True, out_format="a")),
    }


def test_filter_bytes_fast_path_equivalence(two_dbs, tmp_path, monkeypatch):
    """Both filter paths (KMC_TPU_FILTER_BYTES 1 and 0) at two chunk sizes,
    on every record shape of tests/test_tools.py's case list that the
    paths treat differently, and gzip input and output."""
    db1, _, c1, _ = two_dbs
    kms = [km for km, c in c1.items() if c >= 2][:40]
    cases = _filter_cases(kms)

    def body(m, d):
        res = []
        for chunk in (8 << 20, 61):
            monkeypatch.setattr(m.ff, "_CHUNK", chunk)
            for name, (content, kw) in cases.items():
                inp = d / f"{name}.in"
                with open(inp, "w", newline="") as f:
                    f.write(content)
                for fast in ("1", "0"):
                    monkeypatch.setenv("KMC_TPU_FILTER_BYTES", fast)
                    res.append(m.ff.filter_fastq(
                        db1, str(inp), str(d / f"{name}.{chunk}.{fast}.out"),
                        **kw))
        gz_in = d / "q.fq.gz"
        with gzip.open(gz_in, "wt") as f:
            f.write(cases["plain"][0])
        for fast in ("1", "0"):
            monkeypatch.setenv("KMC_TPU_FILTER_BYTES", fast)
            out = d / f"gz.{fast}.out.gz"
            res.append(m.ff.filter_fastq(db1, [str(gz_in), str(inp)],
                                         str(out), min_kmers=1))
        return res

    twin(tmp_path, body)


def test_complex_streaming_path_equivalence(two_dbs, tmp_path, monkeypatch):
    db1, db2, _, _ = two_dbs

    def body(m, d):
        for tag, thr in (("mem", str(1 << 60)), ("stream", "0")):
            monkeypatch.setenv("KMC_TPU_NATIVE_TOOLS", "0")
            monkeypatch.setenv("KMC_TPU_STREAM_THRESHOLD", thr)
            _complex(m, d, f"INPUT:\na = {db1} -ci2\nb = {db2}\nOUTPUT:\n"
                     f"<D>/cxs_{tag} = (a - b) + (a *max b)\n",
                     f"ops_{tag}.txt")

    _, files = twin(tmp_path, body)
    assert files["cxs_mem.kmc_suf"] == files["cxs_stream.kmc_suf"]


def test_filter_bytes_fast_path_fuzz(two_dbs, tmp_path, monkeypatch):
    import random

    db1, _, c1, _ = two_dbs
    kms = [km for km, c in c1.items() if c >= 2]

    def body(m, d):
        rng = random.Random(99)
        res = []
        for trial in range(8):
            recs = []
            for i in range(rng.randrange(1, 30)):
                r = rng.random()
                if r < 0.5:
                    seq = rng.choice(kms)
                elif r < 0.7:
                    seq = "".join(rng.choice("ACGTN")
                                  for _ in range(rng.randrange(0, 70)))
                else:
                    seq = rng.choice(kms) + "".join(
                        rng.choice("ACGT") for _ in range(rng.randrange(30)))
                ws = " " * rng.randrange(0, 2)
                recs.append(f"@r{i}{ws}\n{seq}\n+\n{'I' * len(seq)}\n")
            content = "".join(recs)
            if rng.random() < 0.3:
                content = content.replace("\n", "\r\n")
            mode = rng.choice(["remove", "trim", "hm"])
            kw = {"remove": dict(min_kmers=rng.choice([1, 2, 0.5]),
                                 max_kmers=rng.choice([3, 10**9, 1.0])),
                  "trim": dict(min_kmers=rng.choice([1, 2]), trim=True),
                  "hm": dict(min_kmers=rng.choice([1, 2]), hard_mask=True),
                  }[mode]
            inp = d / f"fz{trial}.fq"
            with open(inp, "w", newline="") as f:
                f.write(content)
            monkeypatch.setattr(m.ff, "_CHUNK", rng.choice([8 << 20, 61]))
            for fast in ("1", "0"):
                monkeypatch.setenv("KMC_TPU_FILTER_BYTES", fast)
                res.append(m.ff.filter_fastq(
                    db1, str(inp), str(d / f"fz{trial}.{fast}.out"), **kw))
        return res

    twin(tmp_path, body)


def test_filter_pipeline_threads_byte_identical(two_dbs, tmp_path,
                                                monkeypatch):
    db1, _, c1, _ = two_dbs
    kms = [km for km, c in c1.items() if c >= 2][:60]
    plain = "".join(f"@q{i}\n{km}TTTTAACC\n+\n{'I' * (len(km) + 8)}\n"
                    for i, km in enumerate(kms))

    def body(m, d):
        fq = d / "in.fastq"
        fq.write_text(plain)
        gz = d / "in2.fastq.gz"
        gz.write_bytes(gzip.compress(plain.encode(), mtime=0))
        monkeypatch.setattr(m.ff, "_CHUNK", 1 << 9)
        stats = []
        for j, mode in enumerate(({"min_kmers": 1},
                                  {"min_kmers": 2, "trim": True},
                                  {"min_kmers": 2, "hard_mask": True})):
            for t in (1, 4, None):
                m.native.set_threads(t)
                stats.append(m.ff.filter_fastq(
                    db1, [str(fq), str(gz)], str(d / f"out_{j}_{t}.fastq"),
                    **mode))
        m.native.set_threads(None)
        return stats

    _, files = twin(tmp_path, body)
    for j in range(3):
        assert files[f"out_{j}_1.fastq"] == files[f"out_{j}_4.fastq"] \
            == files[f"out_{j}_None.fastq"]


def test_filter_pipeline_error_propagates(two_dbs, tmp_path):
    """A mid-stream error in the port's filter pipeline (FASTA input with
    FASTQ output, at -t4) raises kmc_tpu's error through the reader and
    writer threads, and the threads end.  The call runs in a thread of
    its own that must finish within 60 s, so a hang fails the test."""
    import threading

    db1, _, c1, _ = two_dbs
    kms = [km for km, c in c1.items() if c >= 2][:10]

    def body(m, d):
        fa = d / "in.fasta"
        fa.write_text("".join(f">q{i}\n{km}\n" for i, km in enumerate(kms)))
        m.native.set_threads(4)
        err = []

        def run():
            try:
                m.ff.filter_fastq(db1, str(fa), str(d / "o.fastq"),
                                  min_kmers=1, out_format="q")
            except ValueError as e:
                err.append(str(e))

        th = threading.Thread(target=run, daemon=True)
        before = threading.active_count()
        th.start()
        th.join(60)
        m.native.set_threads(None)
        assert not th.is_alive(), "filter pipeline hung"
        assert threading.active_count() <= before
        return err

    err, _ = twin(tmp_path, body)
    assert len(err) == 1 and "FASTA input" in err[0]
