"""pytest set-up of the benchmark's own tests (python -m pytest kmcbench):
the `gpu` marker, and small cells on the CPU: one that spills, and the
same sample counted by four shards, as a cell of four chips would."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips on machines without one")


def small_cell(genome_bp=1 << 15, coverage=10, repeats=()):
    """large_genome_k27.fastq30x shrunk to run on the CPU in a second: a
    32 kbp genome at 10x, batches of 2^12 positions and a store of 2^13
    rows, so every job compacts, spills and takes the host route.
    repeats: (length, copies) of repeat families to write into it."""
    from kmcbench.harness import Cell, load_cell

    base = load_cell("large_genome_k27.fastq30x")
    config = dict(base.config, genome_bp=genome_bp,
                  repeats=[{"length": n, "copies": c} for n, c in repeats])
    config["knobs"] = dict(config["knobs"], batch_positions=1 << 12,
                           device_store_rows=1 << 13)
    traffic = dict(base.traffic, coverage=coverage)
    return Cell("small", config, traffic, 1, base.end_to_end,
                base.per_layer)


def _sharded_per_layer() -> list:
    """The per-layer metrics of BENCHMARK.json's cell of four chips: the
    readers of the sharded count's layers (kmcbench/metrics/)."""
    from kmcbench.harness import load_cell

    return load_cell("celegans_k27.fastq30x.x4").per_layer


SHARDED_PER_LAYER = _sharded_per_layer()


def small_sharded_cell(**kw):
    """small_cell (the same keywords) as a cell of four chips, with the
    sharded count's per-layer metrics: four shards of 2^13 rows, which
    the tests put on the CPU (or on four cards)."""
    from kmcbench.harness import Cell

    small = small_cell(**kw)
    return Cell("small_4card", small.config, small.traffic, 4,
                small.end_to_end, SHARDED_PER_LAYER)


@pytest.fixture
def cell():
    return small_cell()
