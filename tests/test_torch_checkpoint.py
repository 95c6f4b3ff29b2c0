"""Stage-1 checkpoints across the two packages (mirrors test_checkpoint.py).

A checkpoint is the store's .npz, one .spill{i}.npz per spilled run and a
.meta.npz sidecar, in kmc_tpu's format.  Written by the port and resumed by
the port, written by kmc_tpu and resumed by the port, and written by the
port and resumed by kmc_tpu, with and without spilled runs, it must finish
to the same database as the straight count."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

from kmc_tpu.runner import Runner as JaxRunner  # noqa: E402
from kmc_tpu.runner import Stage1Params as JaxStage1Params  # noqa: E402
from kmc_tpu.runner import Stage2Params as JaxStage2Params  # noqa: E402
from kmc_tpu_torch import Runner, Stage1Params, Stage2Params, count  # noqa: E402
from kmc_tpu_torch.ops.store import DeviceKmerStore  # noqa: E402

K, S = 25, 1 << 10

PACKAGES = {
    "torch": (lambda: Runner(device="cpu"), Stage1Params, Stage2Params),
    "jax": (JaxRunner, JaxStage1Params, JaxStage2Params),
}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    return write_fastq(d / "r.fastq", random_reads(300, 120, seed=3,
                                                   genome_len=12000))


@pytest.fixture(scope="module")
def straight(reads, tmp_path_factory):
    out = tmp_path_factory.mktemp("straight") / "db"
    count([reads], str(out), k=K, device="cpu", cutoff_min=1,
          batch_positions=S)
    return out


def _stage1(pkg, reads, rows):
    make, P1, _ = PACKAGES[pkg]
    r = make()
    r.run_stage1(P1(input_files=[reads], kmer_len=K, batch_positions=S,
                    device_store_rows=rows))
    return r


def _resume_and_finish(pkg, reads, ckpt, out, rows):
    make, P1, P2 = PACKAGES[pkg]
    r = make()
    # k comes from the checkpoint, not from these params
    r.resume_stage1_checkpoint(ckpt, P1(input_files=[reads],
                                        batch_positions=S,
                                        device_store_rows=rows))
    return r, r.run_stage2(P2(output_file_name=str(out), cutoff_min=1))


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("rows", [1 << 16, 4096], ids=["no_spill", "spilled"])
def test_checkpoint_resumes_across_packages(reads, straight, tmp_path,
                                            writer, reader, rows):
    r = _stage1(writer, reads, rows)
    n_spilled = len(r._store.spilled)
    assert (n_spilled > 0) == (rows == 4096)
    ckpt = str(tmp_path / "ck")
    r.save_stage1_checkpoint(ckpt)
    for suffix in [".npz", ".meta.npz"] + [f".spill{i}.npz"
                                          for i in range(n_spilled)]:
        assert Path(ckpt + suffix).exists(), suffix
    out = tmp_path / "db"
    r2, res = _resume_and_finish(reader, reads, ckpt, out, rows)
    for suf in (".kmc_pre", ".kmc_suf"):
        assert Path(str(out) + suf).read_bytes() == \
            Path(str(straight) + suf).read_bytes(), suf
    # the occurrence total crossed over too (kmc_tpu's (lo, hi) pair)
    ref = np.load(ckpt + ".npz")["occ"]
    assert res.n_total_kmers == int(ref[0]) + (int(ref[1]) << 32) > 0


def test_checkpoint_file_matches_kmc_tpu(reads, tmp_path):
    """The port's checkpoint arrays equal kmc_tpu's for the same input:
    the same keys, dtypes and rows, spilled runs included."""
    paths = {}
    for pkg in PACKAGES:
        r = _stage1(pkg, reads, 4096)
        paths[pkg] = str(tmp_path / pkg)
        r.save_stage1_checkpoint(paths[pkg])
    t, j = (np.load(paths[p] + ".npz") for p in ("torch", "jax"))
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        if key == "occ_upper":  # a bound for kmc_tpu's wide mode only
            assert int(t[key]) >= int(j["occ"][0])
            continue
        assert t[key].dtype == j[key].dtype, key
        assert np.array_equal(t[key], j[key]), key
    for i in range(int(j["spilled"])):
        ts, js = (np.load(f"{paths[p]}.spill{i}.npz") for p in ("torch", "jax"))
        for key in ("cols", "counts"):
            assert ts[key].dtype == js[key].dtype
            assert np.array_equal(ts[key], js[key])
    tm, jm = (np.load(paths[p] + ".meta.npz") for p in ("torch", "jax"))
    for key in jm.files:
        assert np.array_equal(tm[key], jm[key]), key


def test_greedy_checkpoint_raises(tmp_path):
    path = str(tmp_path / "ck")
    np.savez_compressed(path, cols=np.zeros((2, 0), np.uint32),
                        counts=np.zeros(0, np.uint32), map_mode="greedy")
    with pytest.raises(NotImplementedError, match="A7"):
        DeviceKmerStore.load_checkpoint(path, 1 << 12, device="cpu")
