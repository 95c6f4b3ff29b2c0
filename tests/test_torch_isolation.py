"""kmc_tpu_torch stands alone: it imports neither jax nor kmc_tpu, and it
never runs on the CPU unless the caller asks for it."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kmc_tpu_torch
from kmc_tpu_torch import Runner, count, distributed_count, make_mesh
from kmc_tpu_torch.ops.nthash import NtCardEstimator
from kmc_tpu_torch.ops.store import DeviceKmerStore
from kmc_tpu_torch.parallel.multihost import ShardedKmerStore

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import kmc_tpu_torch
names = ["kmc_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(kmc_tpu_torch.__path__,
                                          "kmc_tpu_torch.")
    if m.name != "kmc_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "kmc_tpu"
             or m.startswith("kmc_tpu."))
print(len(names), bad)
assert not bad, bad
for name in ("kmc_tpu_torch.formats.kff",
             "kmc_tpu_torch.ops.nthash",
             "kmc_tpu_torch.ops.smallk",
             "kmc_tpu_torch.ops.sortcount",
             "kmc_tpu_torch.signatures",
             "kmc_tpu_torch.parallel.distributed",
             "kmc_tpu_torch.parallel.exchange_kernel",
             "kmc_tpu_torch.parallel.multihost",
             "kmc_tpu_torch.microbench_sort",
             "kmc_tpu_torch.ops.extract_kernel",
             "kmc_tpu_torch.ops.ingest_kernel",
             "kmc_tpu_torch.ops.store"):
    assert name in names, name
"""


def test_no_jax_or_kmc_tpu_import():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20  # every module of the package was imported


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_count_without_device_raises_without_card(tmp_path, monkeypatch):
    _no_card(monkeypatch)
    fq = tmp_path / "in.fastq"
    fq.write_text("@r\nACGTACGTACGTACGTACGTACGTACGTAC\n+\n" + "I" * 30 + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        count([str(fq)], str(tmp_path / "db"), k=27)
    assert not (tmp_path / "db.kmc_pre").exists()


@pytest.mark.parametrize("make", [
    lambda: Runner(),
    lambda: DeviceKmerStore(64, k=27, sig_len=9, both_strands=True,
                            n_bins=512),
    lambda: make_mesh(),
    lambda: make_mesh(2),
    lambda: ShardedKmerStore(None, 64, k=27),
    lambda: NtCardEstimator(27, r=10),
])
def test_entry_points_default_to_cuda(monkeypatch, make):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_distributed_count_without_devices_raises_without_card(
        tmp_path, monkeypatch):
    _no_card(monkeypatch)
    fq = tmp_path / "in.fastq"
    fq.write_text("@r\nACGTACGTACGTACGTACGTACGTACGTAC\n+\n" + "I" * 30 + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        distributed_count([str(fq)], str(tmp_path / "db"), k=27)
    with pytest.raises(RuntimeError, match="cuda"):
        distributed_count([str(fq)], str(tmp_path / "db"), k=27,
                          devices=["cuda:0"] * 2)
    assert not (tmp_path / "db.kmc_pre").exists()


def test_new_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """The 1-D splitter scan's and the probes' callers, the checkpoint
    loader and the microbench section need a card unless asked for the
    CPU."""
    from kmc_tpu_torch import microbench_sort

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceKmerStore.load_checkpoint(str(tmp_path / "none"), 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        microbench_sort.probe_inputs(1 << 20, "cuda")
    assert microbench_sort.probe_inputs(1 << 20, "cpu")[0].device.type == "cpu"


def test_cli_without_card_fails(tmp_path, monkeypatch, capsys):
    from kmc_tpu_torch.cli import main

    _no_card(monkeypatch)
    fq = tmp_path / "in.fastq"
    fq.write_text("@r\nACGTACGTACGTACGTACGTACGTACGTAC\n+\n" + "I" * 30 + "\n")
    assert main(["-k27", "-hp", str(fq), str(tmp_path / "db"),
                 str(tmp_path)]) == 1
    assert "cuda" in capsys.readouterr().err
    assert kmc_tpu_torch.Runner(device="cpu").device.type == "cpu"
