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
for name in ("kmc_tpu_torch.api",
             "kmc_tpu_torch.dump_cli",
             "kmc_tpu_torch.develop",
             "kmc_tpu_torch.py_kmc_api",
             "kmc_tpu_torch.io.bam",
             "kmc_tpu_torch.formats.dump",
             "kmc_tpu_torch.formats.streaming",
             "kmc_tpu_torch.tools.native_tools",
             "kmc_tpu_torch.formats.kff",
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
             "kmc_tpu_torch.ops.store",
             "kmc_tpu_torch.tools_cli",
             "kmc_tpu_torch.tools.db_ops",
             "kmc_tpu_torch.tools.complex_ops",
             "kmc_tpu_torch.tools.fastq_filter"):
    assert name in names, name
"""


_READERS_PROBE = r"""
import importlib, sys
import kmc_tpu_torch
for name in ("kmc_tpu_torch.api", "kmc_tpu_torch.dump_cli",
             "kmc_tpu_torch.formats", "kmc_tpu_torch.formats.kmc_db",
             "kmc_tpu_torch.formats.dump", "kmc_tpu_torch.formats.kff",
             "kmc_tpu_torch.formats.streaming", "kmc_tpu_torch.io.bam",
             "kmc_tpu_torch.io.native", "kmc_tpu_torch.io.readers",
             "kmc_tpu_torch.develop", "kmc_tpu_torch.py_kmc_api",
             "kmc_tpu_torch.signatures", "kmc_tpu_torch.tools.native_tools",
             "kmc_tpu_torch.tools_cli", "kmc_tpu_torch.tools.db_ops",
             "kmc_tpu_torch.tools.complex_ops",
             "kmc_tpu_torch.tools.fastq_filter"):
    importlib.import_module(name)
from kmc_tpu_torch.api import KMCFile, KmerAPI, KMCFileInfo
from kmc_tpu_torch.formats.streaming import (StreamingKmc1Writer,
    merge_key_streams, stream_compare, stream_dump, stream_histogram,
    stream_simple_op, stream_transform, write_kmc1_pre)
from kmc_tpu_torch.formats.kff import KffWriter
assert hasattr(KffWriter, "store_block_section")
from kmc_tpu_torch.tools.native_tools import (run_compare, run_expr,
    run_histogram, run_op, set_threads)
from kmc_tpu_torch.tools_cli import main as tools_main
from kmc_tpu_torch.formats import dump_db_file, read_db
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "kmc_tpu"))
assert not loaded, loaded
# the counting names still resolve, and only then load torch
from kmc_tpu_torch import count, distributed_count, Runner, make_mesh
assert "torch" in sys.modules
assert set(kmc_tpu_torch.__all__) <= set(dir(kmc_tpu_torch))
for name in kmc_tpu_torch.__all__:
    getattr(kmc_tpu_torch, name)
try:
    kmc_tpu_torch.no_such_name
except AttributeError:
    pass
else:
    raise SystemExit("unknown package attribute resolved")
print("ok")
"""


def test_reader_modules_load_no_torch():
    """The host modules (the readers, the API, kmc_dump, BAM parsing,
    develop mode, the py_kmc_api shim, kmc_tools with its database algebra,
    filter and the writer half of the streaming module) load neither
    torch, jax nor kmc_tpu; the package's counting names load torch on
    first use."""
    r = subprocess.run([sys.executable, "-c", _READERS_PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_no_jax_or_kmc_tpu_import():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 41  # every module of the package was imported


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


_MULTIPROC_PROBE = r"""
import ast, importlib.util, sys
from pathlib import Path
spec = importlib.util.spec_from_file_location(
    "torch_multiproc_worker", "tests/torch_multiproc_worker.py")
worker = importlib.util.module_from_spec(spec)
spec.loader.exec_module(worker)
from kmc_tpu_torch.parallel.distributed import (Fleet, init_multihost,
    process_count, process_index)
from kmc_tpu_torch.parallel.exchange_kernel import (
    ragged_all_to_all_processes, send_buffer)
from kmc_tpu_torch.parallel.multihost import (_lockstep_groups,
    _merge_estimator_multihost, _serial_deal, distributed_count)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kmc_tpu"))
assert not bad, bad
for path in ["tests/torch_multiproc_worker.py"] + sorted(
        str(p) for p in Path("kmc_tpu_torch/parallel").glob("*.py")):
    for node in ast.walk(ast.parse(Path(path).read_text())):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "kmc_tpu"), \
                (path, name)
assert process_count() == 1 and process_index() == 0
print("ok")
"""


def test_multiprocess_code_loads_no_jax():
    """The port's multi-process worker (tests/torch_multiproc_worker.py)
    and the process-group code of kmc_tpu_torch.parallel import neither
    jax nor kmc_tpu, by import and by their sources' import statements."""
    r = subprocess.run([sys.executable, "-c", _MULTIPROC_PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_microbench_sections_default_to_cuda(monkeypatch):
    from kmc_tpu_torch import microbench_sort

    _no_card(monkeypatch)
    for name in ("roofline", "bitonic", "scatter", "onehot"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            microbench_sort.SECTIONS[name](1 << 12)
