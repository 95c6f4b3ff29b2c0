"""A run with the timed path broken underneath comes out not correct:
the harness (the look for a card skipped: device "cpu") on a small cell,
once for each fault a one-card count can have, and on the same sample as
a cell of four chips (four CPU shards) once for each fault of the sharded
count, the exchange between its shards left out among them."""
import numpy as np
import pytest

from kmcbench.conftest import small_cell, small_sharded_cell
from kmcbench.harness import run_cell

SEED = 2**36 + 5


def run(traced=False, cell=None):
    return run_cell(cell or small_cell(), SEED, 0.3, traced, device="cpu",
                    log=lambda msg: None)


def test_sound_run_is_correct():
    res = run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_counters_past_counter_max_are_clamped_and_correct():
    """A repeat of 40 copies at 10x: its k-mers count past counter_max
    (255), so the run checks the program's clamp against the reference's."""
    from kmcbench import reference

    cell = small_cell(repeats=((200, 40),))
    ref = reference.count(cell.sample, SEED, 27, "cpu")
    assert int(ref.counts.max()) > cell.knobs["counter_max"]
    res = run_cell(cell, SEED, 0.3, False, device="cpu", log=lambda m: None)
    assert res["correct"], res["checks"]


def state_unchanged(monkeypatch):
    """Every ingest returns the store as it was."""
    from kmc_tpu_torch.ops import store

    monkeypatch.setattr(store, "ingest",
                        lambda buf, ts, cols, counts, n_used, occ, skm,
                        prev, **kw: prev)


def half_the_batches(monkeypatch):
    """Every second batch left out; the counts come from the rest."""
    from kmc_tpu_torch.ops import store

    ingest = store.ingest
    calls = [0]

    def every_other(buf, *args, **kw):
        calls[0] += 1
        if calls[0] % 2:
            return ingest(buf, *args, **kw)
        return args[6]  # prev_sig: this batch was never ingested

    monkeypatch.setattr(store, "ingest", every_other)


def counter_altered(monkeypatch):
    """One record's counter changed where the writer produces it."""
    from kmc_tpu_torch.formats.kmc_db import Kmc2DbWriter

    write = Kmc2DbWriter.write_all_records

    def altered(self, rec, lut_counts):
        rec = np.array(rec, copy=True)
        rec[len(rec) // 2, -1] ^= 1
        return write(self, rec, lut_counts)

    monkeypatch.setattr(Kmc2DbWriter, "write_all_records", altered)


def kmer_altered(monkeypatch):
    """One k-mer's last base changed in the finalize's records."""
    from kmc_tpu_torch.ops.store import DeviceKmerStore

    finalize = DeviceKmerStore.finalize_records

    def altered(self, **kw):
        rec, lut, stats = finalize(self, **kw)
        rec = np.array(rec, copy=True)
        rec[len(rec) // 3, -2] ^= 1
        return rec, lut, stats

    monkeypatch.setattr(DeviceKmerStore, "finalize_records", altered)


def stats_altered(monkeypatch):
    """Stage 2 reports one distinct k-mer too many."""
    from kmc_tpu_torch.runner import Runner

    stage2 = Runner.run_stage2

    def altered(self, params):
        res = stage2(self, params)
        res.n_unique_kmers += 1
        return res

    monkeypatch.setattr(Runner, "run_stage2", altered)


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batches,
                                   counter_altered, kmer_altered,
                                   stats_altered])
@pytest.mark.parametrize("traced", [False, True])
def test_fault_is_not_correct(monkeypatch, fault, traced):
    fault(monkeypatch)
    res = run(traced)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_failed_job_is_not_correct(monkeypatch):
    from kmc_tpu_torch.runner import Runner

    def boom(self, params):
        raise RuntimeError("device lost")

    monkeypatch.setattr(Runner, "run_stage2", boom)
    res = run()
    assert res["correct"] is False and res["failed"] >= 1


def exchange_left_out(monkeypatch):
    """The finalize's exchange moves nothing between shards: each owner
    takes only the rows its own shard sent itself."""
    from kmc_tpu_torch.parallel import multihost

    a2a = multihost.ragged_all_to_all

    def own_rows_only(xs, n_rows):
        outs, recv_rows = a2a(xs, n_rows)
        return outs, recv_rows * np.eye(len(xs), dtype=recv_rows.dtype)

    monkeypatch.setattr(multihost, "ragged_all_to_all", own_rows_only)


def sharded_kmer_altered(monkeypatch):
    """One k-mer's last base changed in the owners' records."""
    from kmc_tpu_torch.parallel.multihost import ShardedKmerStore

    finalize = ShardedKmerStore.finalize_records

    def altered(self, **kw):
        rec, *rest = finalize(self, **kw)
        rec = np.array(rec, copy=True)
        rec[len(rec) // 3, -2] ^= 1
        return (rec, *rest)

    monkeypatch.setattr(ShardedKmerStore, "finalize_records", altered)


def sharded_stats_altered(monkeypatch):
    """The count reports one distinct k-mer too many."""
    from kmc_tpu_torch.parallel import multihost

    count = multihost.distributed_count

    def altered(*args, **kw):
        res = count(*args, **kw)
        res["n_unique"] += 1
        return res

    monkeypatch.setattr(multihost, "distributed_count", altered)


def test_sound_sharded_run_is_correct():
    logs = []
    res = run_cell(small_sharded_cell(), SEED, 0.3, False, device="cpu",
                   log=logs.append)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"]["count"] == 4
    assert {"kmers_per_s", "host_peak_gib", "setup_s"} <= set(res["metrics"])
    jobs = [line for line in logs if line.startswith("job ")]
    assert jobs and all("'exchange_route': 'plain'" in line and
                        "'n_spills'" in line for line in jobs)


def test_sharded_traced_run_reads_its_program_spans():
    res = run(True, small_sharded_cell())
    assert res["correct"] and res["device"]["count"] == 4
    assert res["metrics"]["exchange_s"]["value"] > 0
    assert res["metrics"]["shard_ingest_s"]["value"] > 0


def test_knob_the_sharded_count_cannot_take_stops_the_run():
    cell = small_sharded_cell()
    cell.config["knobs"]["ram_only_mode"] = True
    with pytest.raises(SystemExit, match="ram_only_mode"):
        run(cell=cell)


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batches,
                                   exchange_left_out, counter_altered,
                                   sharded_kmer_altered,
                                   sharded_stats_altered])
@pytest.mark.parametrize("traced", [False, True])
def test_sharded_fault_is_not_correct(monkeypatch, fault, traced):
    fault(monkeypatch)
    res = run(traced, small_sharded_cell())
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_failed_sharded_job_is_not_correct(monkeypatch):
    from kmc_tpu_torch.parallel import multihost

    def boom(*args, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(multihost, "distributed_count", boom)
    res = run(cell=small_sharded_cell())
    assert res["correct"] is False and res["failed"] >= 1
