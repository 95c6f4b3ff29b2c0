"""pytest set-up of the benchmark's own tests (python -m pytest kmcbench):
the `gpu` marker, and a small cell on the CPU that spills."""
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


@pytest.fixture
def cell():
    return small_cell()
