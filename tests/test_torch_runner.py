"""kmc_tpu_torch.count / CLI on the CPU against kmc_tpu.runner.count: the
database files must be byte-identical, the results equal apart from times."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import (random_reads, write_fasta, write_fastq,  # noqa: E402
                  write_fastq_gz)

import kmc_tpu.cli as jax_cli  # noqa: E402
import kmc_tpu_torch.cli as torch_cli  # noqa: E402
from kmc_tpu.runner import InputFileType as JaxInputFileType  # noqa: E402
from kmc_tpu.runner import count as jax_count  # noqa: E402
from kmc_tpu_torch import (InputFileType, Runner, Stage1Params,  # noqa: E402
                           count, distributed_count)

_TIMES = {"time", "time_strict_mem", "time_finalize_exec", "time_finalize_d2h"}


def _no_times(res):
    return {k: v for k, v in dataclasses.asdict(res).items()
            if k not in _TIMES}


def _write(tmp_path, fmt, reads):
    if fmt == "fastq":
        return write_fastq(tmp_path / "in.fastq", reads)
    if fmt == "fastq.gz":
        return write_fastq_gz(tmp_path / "in.fastq.gz", reads)
    if fmt == "fasta":
        return write_fasta(tmp_path / "in.fasta", reads)
    return write_fasta(tmp_path / "in.mfasta", reads, line_width=37)


_FMT = {"fastq": "FASTQ", "fastq.gz": "FASTQ", "fasta": "FASTA",
        "multifasta": "MULTILINE_FASTA"}

CASES = [
    # (format, k, count kwargs, n_prob)
    ("fastq", 27, dict(cutoff_min=2), 0.0),
    ("fastq", 14, dict(cutoff_min=1), 0.01),
    ("fasta", 33, dict(cutoff_min=1, cutoff_max=4, n_threads=1), 0.0),
    ("multifasta", 27, dict(cutoff_min=1, counter_max=3), 0.0),
    ("fastq.gz", 27, dict(cutoff_min=2, cutoff_max=300), 0.02),
    ("fastq", 129, dict(cutoff_min=1), 0.0),
    ("fastq", 31, dict(cutoff_min=1, canonical_kmers=False,
                       signature_len=7), 0.0),
    ("fastq", 25, dict(cutoff_min=1, homopolymer_compressed=True,
                       n_bins=128), 0.0),
    # tiny batches and a small store: several unit then counted compactions
    ("fastq", 27, dict(cutoff_min=1, batch_positions=256,
                       device_store_rows=4096), 0.005),
]


@pytest.mark.parametrize("fmt,k,kw,n_prob", CASES)
def test_count_db_byte_identical(tmp_path, fmt, k, kw, n_prob):
    reads = random_reads(300, max(100, k + 60), seed=k + len(fmt), n_prob=n_prob,
                         genome_len=3000)
    inp = _write(tmp_path, fmt, reads)
    kw = dict(kw)
    kw.setdefault("batch_positions", 1 << 12)
    kind = _FMT[fmt]
    out_j = str(tmp_path / "jax")
    out_t = str(tmp_path / "torch")
    j1, j2 = jax_count([inp], out_j, k=k,
                       input_file_type=JaxInputFileType[kind], **kw)
    t1, t2 = count([inp], out_t, k=k, device="cpu",
                   input_file_type=InputFileType[kind], **kw)
    for suf in (".kmc_pre", ".kmc_suf"):
        assert Path(out_t + suf).read_bytes() == Path(out_j + suf).read_bytes(), suf
    assert _no_times(t1) == _no_times(j1)
    assert _no_times(t2) == _no_times(j2)
    assert t2.n_total_kmers > 0


def test_cli_json_and_db_identical(tmp_path):
    reads = random_reads(200, 90, seed=5, genome_len=2000)
    inp = write_fastq(tmp_path / "in.fastq", reads)
    args = ["-k25", "-ci1", "-cs50", "-hp", "-S4096"]
    rc_j = jax_cli.main(args + [f"-j{tmp_path / 'j.json'}", inp,
                                str(tmp_path / "jdb"), str(tmp_path)])
    rc_t = torch_cli.main(args + ["--device=cpu", f"-j{tmp_path / 't.json'}",
                                  inp, str(tmp_path / "tdb"), str(tmp_path)])
    assert rc_j == 0 and rc_t == 0
    jj = json.loads((tmp_path / "j.json").read_text())
    tj = json.loads((tmp_path / "t.json").read_text())
    for doc in (jj, tj):
        for key in ("1st_stage", "2nd_stage", "Total"):
            doc.pop(key)
    assert tj == jj
    for suf in (".kmc_pre", ".kmc_suf"):
        assert (tmp_path / f"tdb{suf}").read_bytes() == \
            (tmp_path / f"jdb{suf}").read_bytes()


@pytest.mark.parametrize("kw,item", [
    (dict(signature_map_policy="greedy"), "A11b"),
])
def test_unported_options_raise(tmp_path, kw, item):
    """The greedy map counts on one device (tests/test_torch_greedy.py);
    over shards it is still to come."""
    inp = write_fastq(tmp_path / "in.fastq", random_reads(10, 50, seed=1))
    kw = dict(kw)
    k = kw.pop("k", 27)
    with pytest.raises(NotImplementedError, match=item):
        distributed_count([inp], str(tmp_path / "db"), k=k,
                          devices=["cpu"] * 2, **kw)
    assert not (tmp_path / "db.kmc_pre").exists()
    count([inp], str(tmp_path / "one"), k=k, device="cpu", **kw)
    assert (tmp_path / "one.kmc_pre").exists()


@pytest.mark.parametrize("kw", [dict(output_type="kff"), dict(k=13),
                                dict(estimate_only=True)])
def test_sharded_unported_options_raise(tmp_path, kw):
    """KFF output, small k and -e run on one device (Runner) but not yet
    over shards (ROADMAP A11b)."""
    inp = write_fastq(tmp_path / "in.fastq", random_reads(10, 50, seed=1))
    kw = dict(kw)
    k = kw.pop("k", 27)
    with pytest.raises(NotImplementedError, match="A11b"):
        distributed_count([inp], str(tmp_path / "db"), k=k,
                          devices=["cpu"] * 2, **kw)
    assert not list(tmp_path.glob("db*"))


@pytest.mark.parametrize("args,sufs", [
    (["-okff"], [".kff"]),
    (["-w"], []),
    (["-k9"], [".kmc_pre", ".kmc_suf"]),
    (["-k13", "-okff", "-b"], [".kff"]),
    (["--no-device-store"], [".kmc_pre", ".kmc_suf"]),
    (["--no-device-store", "-okff", "-k31"], [".kff"]),
])
def test_cli_routes_identical(tmp_path, args, sufs):
    reads = random_reads(200, 90, seed=6, genome_len=2000)
    inp = write_fastq(tmp_path / "in.fastq", reads)
    base = ["-k25", "-ci1", "-hp", "-S4096"]
    docs = {}
    for name, cli, extra in (("jdb", jax_cli, []),
                             ("tdb", torch_cli, ["--device=cpu"])):
        assert cli.main(base + args + extra + [
            f"-j{tmp_path / (name + '.json')}", inp, str(tmp_path / name),
            str(tmp_path)]) == 0
        docs[name] = json.loads((tmp_path / f"{name}.json").read_text())
        for key in ("1st_stage", "2nd_stage", "Total"):
            docs[name].pop(key)
    assert docs["tdb"] == docs["jdb"]
    assert docs["tdb"]["Stats"]["#Unique_k-mers"] > 0
    for suf in sufs:
        assert (tmp_path / f"tdb{suf}").read_bytes() == \
            (tmp_path / f"jdb{suf}").read_bytes(), suf
    if not sufs:
        assert not list(tmp_path.glob("tdb.kmc*"))


def test_checkpoints_raise(tmp_path):
    """Checkpoints work (tests/test_torch_checkpoint.py,
    tests/test_torch_greedy.py); what raises is a save before stage 1 and a
    checkpoint of a signature map policy neither package has."""
    import numpy as np

    runner = Runner(device="cpu")
    with pytest.raises(RuntimeError, match="stage-1"):
        runner.save_stage1_checkpoint(str(tmp_path / "ck"))
    ck = str(tmp_path / "ck")
    np.savez_compressed(ck, cols=np.zeros((2, 0), np.uint32),
                        counts=np.zeros(0, np.uint32), map_mode="balanced",
                        k=27, sig_len=9, both_strands=True, n_used_bins=512,
                        sig_map=np.zeros(0, np.int32))
    np.savez(ck + ".meta", kmer_len=27, signature_len=9, canonical=True,
             n_reads=0)
    inp = write_fastq(tmp_path / "in.fastq", random_reads(10, 50, seed=1))
    with pytest.raises(ValueError, match="map_mode"):
        runner.resume_stage1_checkpoint(ck, Stage1Params(input_files=[inp]))
