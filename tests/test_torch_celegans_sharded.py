"""The C. elegans deployment (kmcbench/configs/celegans_k27.json, the
fastq30x traffic) counted as its benchmark cell counts it, by one
distributed_count call over four shards, here four CPU shards at a small
genome: the database must hold exactly what the plain recount
(kmcbench/reference.py) counts, and be the one-device Runner's bytes."""
from pathlib import Path

import pytest
import torch

from kmcbench import compare, reference
from kmcbench.harness import load_cell, run_job, run_sharded_job
from kmcbench.reads import write_fastq

CELL = "celegans_k27.fastq30x.x4"
# the genome cut to 16 kbp; batches are dealt to the shards in turn, so
# each shard meets nearly every genome k-mer and a quarter of the error
# k-mers, ~23k distinct rows: four shards of 2^15 rows fed 2^10 positions
# a batch compact several times and never spill, as the cell's shards of
# 2^26 rows (~61M distinct rows each) do
GENOME_BP = 1 << 14
KNOBS = dict(batch_positions=1 << 10, device_store_rows=1 << 15)
SUFFIXES = (".kmc_pre", ".kmc_suf")


@pytest.mark.parametrize("seed", [2**31 + 11, 2**40 + 7])
def test_sharded_count_matches_the_reference_and_one_device(tmp_path, seed):
    cell = load_cell(CELL)
    assert cell.chips == 4
    config = dict(cell.config, genome_bp=GENOME_BP)
    knobs = dict(config["knobs"], **KNOBS)
    sample = type(cell.sample).of(config, cell.traffic)
    fastq = tmp_path / "reads.fastq"
    write_fastq(fastq, sample, seed, "cpu")

    sharded = run_sharded_job(0, knobs, fastq, tmp_path / "sharded",
                              [torch.device("cpu")] * cell.chips)
    assert sharded.error is None, sharded.error
    assert sharded.spill["n_spills"] == 0
    assert sharded.n_compactions >= 3
    assert sharded.spill["exchange_bytes"] > 0

    ref = reference.count(sample, seed, knobs["kmer_len"], "cpu")
    numbers = compare.judge_db(tmp_path / "sharded", ref, knobs,
                               [sharded.stats], "cpu")
    assert compare.passed(numbers), numbers
    assert numbers["header_wrong"] == numbers["records_wrong"] == 0

    single = run_job(0, knobs, fastq, tmp_path / "single", tmp_path,
                     torch.device("cpu"))
    assert single.error is None, single.error
    assert single.stats == sharded.stats
    for suf in SUFFIXES:
        assert Path(str(tmp_path / "sharded") + suf).read_bytes() == \
            Path(str(tmp_path / "single") + suf).read_bytes(), suf

