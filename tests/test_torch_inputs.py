"""BAM (-fbam) and KMC-database (-fkmc) input on the port against kmc_tpu,
on the CPU: the BAM parser and its plain version, the parallel BGZF
inflate, whole counts on every route of one device, the sharded count and
the CLI, each byte for byte and result for result."""
import dataclasses
import gzip
import json
import struct
import sys
import zlib
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py sets up the 8-device CPU mesh)
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

import kmc_tpu.cli as jax_cli  # noqa: E402
from kmc_tpu import oracle  # noqa: E402
from kmc_tpu.io.bam import bam_code_chunks as jax_bam_code_chunks  # noqa: E402
from kmc_tpu.parallel.distributed import make_mesh as jax_make_mesh  # noqa: E402
from kmc_tpu.parallel.multihost import (  # noqa: E402
    distributed_count as jax_distributed_count)
from kmc_tpu.runner import EstimateHistogramCfg as JaxEstimate  # noqa: E402
from kmc_tpu.runner import InputFileType as JaxInputFileType  # noqa: E402
from kmc_tpu.runner import OutputFileType as JaxOutputFileType  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import (EstimateHistogramCfg, InputFileType,  # noqa: E402
                           OutputFileType, cli, count, distributed_count)
from kmc_tpu_torch.io.bam import (_bam_code_chunks_py,  # noqa: E402
                                  bam_code_chunks, bgzf_block_spans)

SUFFIXES = (".kmc_pre", ".kmc_suf")
_TIMES = {"time", "time_strict_mem", "time_finalize_exec", "time_finalize_d2h"}
_BAM_CODE = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _no_times(res):
    return {k: v for k, v in dataclasses.asdict(res).items()
            if k not in _TIMES}


def _bgzf_member(payload: bytes) -> bytes:
    """One BGZF member: a gzip member whose BC extra field holds its size
    (SAM spec 4.1)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 26
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + b"\x06\x00"
              + b"BC\x02\x00" + struct.pack("<H", bsize - 1))
    return (header + comp + struct.pack("<I", zlib.crc32(payload))
            + struct.pack("<I", len(payload) & 0xFFFFFFFF))


def make_bam(path, reads, flags=None, member_bytes=None):
    """A BAM of unmapped records with the given flag bits: BGZF members of
    member_bytes each, or one plain gzip member when member_bytes is None
    (no BSIZE field: the serial reader's route)."""
    body = b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 1)
    body += struct.pack("<i", 4) + b"ref\x00" + struct.pack("<i", 1000)
    for i, r in enumerate(reads):
        name = f"r{i}".encode() + b"\x00"
        seq = bytearray()
        for j in range(0, len(r), 2):
            lo = _BAM_CODE[r[j + 1]] if j + 1 < len(r) else 0
            seq.append((_BAM_CODE[r[j]] << 4) | lo)
        rec = struct.pack("<iiBBHHHiiii", 0, 0, len(name), 30, 0, 0,
                          (flags or {}).get(i, 0), len(r), -1, -1, 0)
        rec += name + bytes(seq) + b"\xff" * len(r)
        body += struct.pack("<i", len(rec)) + rec
    with open(path, "wb") as f:
        if member_bytes is None:
            f.write(gzip.compress(body))
        else:
            for lo in range(0, len(body), member_bytes):
                f.write(_bgzf_member(body[lo : lo + member_bytes]))
            f.write(BGZF_EOF)
    return str(path)


@pytest.fixture(scope="module")
def reads():
    return random_reads(240, 101, seed=41, n_prob=0.004, genome_len=3000)


@pytest.fixture(scope="module")
def inputs(reads, tmp_path_factory):
    """The BAMs, and the KMC databases -fkmc reads, each written once."""
    d = tmp_path_factory.mktemp("torch_inputs")
    fq = write_fastq(d / "in.fastq", reads)
    paths = {
        "fastq": fq,
        "bam": make_bam(d / "plain.bam", reads),
        "bam_flags": make_bam(d / "flags.bam", reads,
                              flags={0: 0x100, 7: 0x800, 11: 0x10}),
        "bam_bgzf": make_bam(d / "bgzf.bam", reads, member_bytes=4000),
        "dir": d,
    }
    stored = list(reads)
    stored[3] = oracle.revcomp(stored[3])
    paths["bam_reverse"] = make_bam(d / "rev.bam", stored, flags={3: 0x10})
    # -fkmc sources: KMC2 databases of either package and a KMC1 database
    jax_count([fq], str(d / "jax_k25"), k=25, cutoff_min=1,
              batch_positions=1 << 12)
    jax_count([fq], str(d / "jax_k13"), k=13, cutoff_min=1,
              batch_positions=1 << 12)
    count([fq], str(d / "port_k27"), k=27, cutoff_min=1,
          batch_positions=1 << 12, device="cpu")
    count([fq], str(d / "port_k21_ci2"), k=21, cutoff_min=2,
          batch_positions=1 << 12, device="cpu")
    for name in ("jax_k25", "jax_k13", "port_k27", "port_k21_ci2"):
        paths[name] = str(d / name)
    return paths


@pytest.mark.parametrize("both_strands", [True, False])
def test_bam_parser_matches_plain_and_kmc_tpu(inputs, both_strands):
    """The native parser == its plain version == kmc_tpu's, flags and the
    reverse-complement undo of single-strand mode included."""
    bam = inputs["bam_flags"]
    runs = [list(bam_code_chunks(bam, both_strands)),
            list(_bam_code_chunks_py(bam, both_strands)),
            list(jax_bam_code_chunks(bam, both_strands))]
    codes = [np.concatenate([c for c, _ in r]) for r in runs]
    n_reads = [sum(n for _, n in r) for r in runs]
    assert np.array_equal(codes[0], codes[1])
    assert np.array_equal(codes[0], codes[2])
    assert n_reads == [238] * 3  # the secondary and supplementary records


@pytest.mark.parametrize("bam,n_threads", [
    ("bam_bgzf", 4),   # the block table inflated on a thread pool
    ("bam", 4),        # plain gzip: no BSIZE field, the serial reader
    ("bam_bgzf", 1),
])
def test_bam_inflate_routes_match_serial(inputs, bam, n_threads):
    path = inputs[bam]
    if bam == "bam_bgzf":
        assert len(bgzf_block_spans(path)) > 4
    else:
        with pytest.raises(ValueError):
            bgzf_block_spans(path)
    got = list(bam_code_chunks(path, True, n_threads=n_threads))
    plain = list(_bam_code_chunks_py(path, True))
    assert np.array_equal(np.concatenate([c for c, _ in got]),
                          np.concatenate([c for c, _ in plain]))
    assert sum(n for _, n in got) == 240


def test_bam_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        next(bam_code_chunks(str(tmp_path / "none.bam")))


# case -> (input key, file type, count kwargs)
COUNT_CASES = {
    "bam": ("bam", "bam", dict(k=21, cutoff_min=1)),
    "bam_flags": ("bam_flags", "bam", dict(k=21, cutoff_min=1)),
    "bam_reverse_forward_only": ("bam_reverse", "bam",
                                 dict(k=15, cutoff_min=1,
                                      canonical_kmers=False)),
    "bam_bgzf_4_readers": ("bam_bgzf", "bam",
                           dict(k=25, cutoff_min=2, n_reader_threads=4)),
    "bam_host_buckets": ("bam_bgzf", "bam",
                         dict(k=21, cutoff_min=1, device_store=False)),
    "bam_small_k": ("bam", "bam", dict(k=9, cutoff_min=1)),
    "bam_kff": ("bam", "bam", dict(k=21, cutoff_min=1, output="kff")),
    "bam_opt_out_size": ("bam_bgzf", "bam",
                         dict(k=21, cutoff_min=1, n_threads=1,
                              estimate="count")),
    "kmc2_jax_k25_to_21": ("jax_k25", "kmc", dict(k=21, cutoff_min=1)),
    "kmc2_port_k27_to_27": ("port_k27", "kmc", dict(k=27, cutoff_min=1)),
    "kmc2_ci2_to_17": ("port_k21_ci2", "kmc", dict(k=17, cutoff_min=2)),
    "kmc1_k13_to_9": ("jax_k13", "kmc", dict(k=9, cutoff_min=1)),
    "kmc_two_dbs": (("jax_k25", "port_k27"), "kmc", dict(k=21, cutoff_min=1)),
    "kmc_host_buckets": ("jax_k25", "kmc", dict(k=21, cutoff_min=1,
                                                device_store=False)),
    "kmc_kff": ("port_k27", "kmc", dict(k=25, cutoff_min=1, output="kff")),
    "kmc_hc": ("jax_k25", "kmc", dict(k=19, cutoff_min=1,
                                      homopolymer_compressed=True)),
}


def _count_both(inputs, case, tmp_path):
    key, ftype, kw = COUNT_CASES[case]
    kw = dict(kw)
    files = [inputs[k] for k in (key if isinstance(key, tuple) else (key,))]
    k = kw.pop("k")
    kff = kw.pop("output", None) == "kff"
    est = kw.pop("estimate", None)
    res = {}
    for pkg in ("jax", "port"):
        extra = dict(kw)
        if pkg == "jax":
            extra["input_file_type"] = JaxInputFileType(ftype)
            if kff:
                extra["output_file_type"] = JaxOutputFileType.KFF
            if est:
                extra["estimate_histogram_cfg"] = \
                    JaxEstimate.ESTIMATE_AND_COUNT_KMERS
            r1, r2 = jax_count(files, str(tmp_path / pkg), k=k,
                               batch_positions=1 << 12, **extra)
        else:
            extra["input_file_type"] = InputFileType(ftype)
            if kff:
                extra["output_file_type"] = OutputFileType.KFF
            if est:
                extra["estimate_histogram_cfg"] = \
                    EstimateHistogramCfg.ESTIMATE_AND_COUNT_KMERS
            r1, r2 = count(files, str(tmp_path / pkg), k=k,
                           batch_positions=1 << 12, device="cpu", **extra)
        res[pkg] = (_no_times(r1), _no_times(r2))
    return res, kff


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_count_matches_kmc_tpu(inputs, tmp_path, case):
    res, kff = _count_both(inputs, case, tmp_path)
    assert res["port"] == res["jax"]
    for suf in ((".kff",) if kff else SUFFIXES):
        assert (tmp_path / f"port{suf}").read_bytes() == \
            (tmp_path / f"jax{suf}").read_bytes(), suf
    r1, r2 = res["port"]
    assert r2["n_total_kmers"] > 0
    if case == "bam_flags":
        assert r1["n_sequences"] == 238
    if case.startswith("kmc2_port_k27_to_27"):
        # k_in == k: every stored k-mer is read once, as itself
        assert r2["n_unique_kmers"] == r2["n_total_kmers"] == \
            r1["n_sequences"]


def test_fbam_counts_the_reads(inputs, reads, tmp_path):
    """-fbam counts what the FASTQ of the same reads counts."""
    r_b = count([inputs["bam_bgzf"]], str(tmp_path / "b"), k=25,
                cutoff_min=1, batch_positions=1 << 12, device="cpu",
                input_file_type=InputFileType.BAM)
    r_q = count([inputs["fastq"]], str(tmp_path / "q"), k=25, cutoff_min=1,
                batch_positions=1 << 12, device="cpu")
    for suf in SUFFIXES:
        assert (tmp_path / f"b{suf}").read_bytes() == \
            (tmp_path / f"q{suf}").read_bytes()
    assert _no_times(r_b[1]) == _no_times(r_q[1])
    assert r_b[0].n_sequences == r_q[0].n_sequences == len(reads)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("fmt", ["bam", "kmc"])
def test_sharded_count_matches_kmc_tpu(inputs, tmp_path, fmt, D):
    """distributed_count with -fbam / -fkmc == kmc_tpu's on a CPU mesh of
    the same size == the single-device count."""
    src = [inputs["bam_bgzf"]] if fmt == "bam" else [inputs["jax_k25"]]
    kw = dict(k=21, cutoff_min=1, batch_positions=1 << 12,
              capacity_rows_per_device=1 << 15, input_file_type=fmt)
    sj = jax_distributed_count(src, str(tmp_path / "jax"),
                               mesh=jax_make_mesh(D), **kw)
    st = distributed_count(src, str(tmp_path / "port"),
                           devices=["cpu"] * D, **kw)
    _, r2 = count(src, str(tmp_path / "single"), k=21, cutoff_min=1,
                  batch_positions=1 << 12, device="cpu",
                  input_file_type=InputFileType(fmt))
    for suf in SUFFIXES:
        port = (tmp_path / f"port{suf}").read_bytes()
        assert port == (tmp_path / f"jax{suf}").read_bytes(), suf
        assert port == (tmp_path / f"single{suf}").read_bytes(), suf
    for key in ("n_unique", "n_total", "n_below", "n_above",
                "n_super_kmers", "n_reads", "n_devices", "n_compactions"):
        assert st[key] == sj[key], key
    assert st["n_total"] == r2.n_total_kmers > 0


@pytest.mark.parametrize("argv", [
    ["-fbam", "-k21", "-ci1"],
    ["-fbam", "-k9", "-ci1", "-t1"],
    ["-fkmc", "-k21", "-ci1"],
    ["-fkmc", "-k25", "-ci2", "-okff"],
])
def test_cli_matches_kmc_tpu(inputs, tmp_path, capsys, argv):
    src = inputs["bam_bgzf"] if "-fbam" in argv else inputs["jax_k25"]
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device=cpu"])):
        out = str(tmp_path / name)
        js = str(tmp_path / f"{name}.json")
        assert main(argv + extra + ["-hp", "-S4096", f"-j{js}", src, out,
                                    str(tmp_path)]) == 0
        doc = json.loads(Path(js).read_text())
        for key in ("1st_stage", "2nd_stage", "Total"):
            doc.pop(key)
        outs[name] = doc
    assert outs["port"] == outs["jax"]
    sufs = (".kff",) if "-okff" in argv else SUFFIXES
    for suf in sufs:
        assert (tmp_path / f"port{suf}").read_bytes() == \
            (tmp_path / f"jax{suf}").read_bytes(), suf
    assert "No. of unique k-mers" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["-k21", "-ci1"],
    ["-fbam", "-k17", "-ci1", "-t1"],
])
def test_develop_mode_files_match_kmc_tpu(inputs, tmp_path, monkeypatch,
                                          argv):
    """KMC_TPU_DEVELOP writes kmc_tpu's signature-map and per-bin files."""
    monkeypatch.setenv("KMC_TPU_DEVELOP", "1")
    src = inputs["bam"] if "-fbam" in argv else inputs["fastq"]
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device=cpu"])):
        assert main(argv + extra + ["-hp", "-S4096", src,
                                    str(tmp_path / name),
                                    str(tmp_path)]) == 0
    for suf in (".sig_map.develop", ".bin_stats.develop"):
        port = (tmp_path / f"port{suf}").read_text()
        assert port == (tmp_path / f"jax{suf}").read_text(), suf
    assert port.startswith("bin\tn_records\tbytes\n")
