"""BENCHMARK.json as the harness reads it: every name it gives finds its
file, configurations state what they cut, and the command fails without
a card."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from kmcbench import harness
from kmcbench.reads import Sample

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_files():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert (ROOT / "kmcbench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    c = harness.load_cell(cell)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer and c.chips in (1, 4)
    for m in c.end_to_end + c.per_layer:
        assert hasattr(harness.load_reader(m["name"]), "read")
    s = c.sample
    assert s.n_kmers(c.knobs["kmer_len"]) > 0


def test_at_most_one_cell_asks_for_four_chips():
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4} and chips.count(4) <= 1


def test_sharded_readers_load():
    from kmcbench.conftest import SHARDED_PER_LAYER

    for m in SHARDED_PER_LAYER:
        assert hasattr(harness.load_reader(m["name"]), "read")


def test_cell_sizes():
    iso = harness.load_cell("isolate_k27.fastq100x").sample
    big = harness.load_cell("large_genome_k27.fastq30x").sample
    assert (iso.n_reads, iso.n_kmers(27)) == (3_094_434, 383_709_816)
    for name in ("isolate_k27.fastq100x_gz", "isolate_k27.fastq100x_bgzf"):
        gz = harness.load_cell(name).sample
        assert gz == iso
        assert (gz.n_reads, gz.n_kmers(27)) == (3_094_434, 383_709_816)
    assert (big.n_reads, big.n_kmers(27)) == (6_710_886, 832_149_864)
    assert isinstance(iso, Sample)


def test_command_with_too_few_cards_fails_and_prints_nothing(monkeypatch,
                                                             capsys):
    """A cell of four chips where one card is visible."""
    import torch

    from kmcbench import run
    from kmcbench.conftest import small_sharded_cell

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cell = small_sharded_cell()
    monkeypatch.setattr(harness, "load_cell", lambda name: cell)
    rc = run.main(["--workload", "small_4card",
                   "--seed", str(2**40), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 4 CUDA devices" in out.err


def test_command_without_a_card_fails_and_prints_nothing():
    """Any card there is hidden from the command."""
    out = subprocess.run(
        [sys.executable, "kmcbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
