"""The benchmark's command on a card: a short run of each cell, traced
and not, correct, with its metrics; and the harness's job of a cell of
four chips on four cards (marked gpu: skips without the cards)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from kmcbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [0, 1])
def test_short_run_on_the_card(traced):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")
    cell = "isolate_k27.fastq100x"
    out = subprocess.run(
        [sys.executable, "kmcbench/run.py", "--workload", cell, "--seed",
         str(2**33 + traced), "--seconds", "2", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    c = harness.load_cell(cell)
    want = c.per_layer if traced else c.end_to_end
    names = {m["name"] for m in want} - {"spill_s"}
    assert names <= set(res["metrics"])
    if traced:
        assert res["device"]["busy_s"] > 0
        assert 0 < res["metrics"]["ingest_roofline_pct"]["value"] <= 100


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True])
def test_sharded_job_on_four_cards(traced):
    """The harness's job of a cell of four chips, on four cards: a small
    sample counted by distributed_count over cuda:0..3, correct, with the
    exchange on its kernel and the sharded readers' metrics."""
    import torch

    from kmcbench.conftest import small_sharded_cell

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    logs = []
    res = harness.run_cell(small_sharded_cell(), 2**33 + 7, 2,
                           traced, device="cuda", log=logs.append)
    assert res["correct"], logs[-20:]
    assert res["device"]["count"] == 4
    jobs = [line for line in logs if line.startswith("job ")]
    assert jobs and all("'exchange_route': 'kernel'" in line
                        for line in jobs)
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        names = {m["name"] for m in small_sharded_cell().per_layer}
        assert names <= set(res["metrics"])
        assert 0 < res["metrics"]["exchange_roofline_pct"]["value"] <= 100
