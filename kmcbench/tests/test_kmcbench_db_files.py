"""Each job of a run writes a new database and the one before it is
deleted, so a run leaves one database, the last job's, for the check."""
from pathlib import Path

from kmcbench import compare, harness
from kmcbench.conftest import small_cell


def test_one_database_left_and_it_is_the_last_jobs(monkeypatch):
    seen = {}
    judge = compare.judge_db

    def spy(prefix, *args, **kw):
        work = Path(prefix).parent
        seen["prefix"] = Path(prefix)
        seen["left"] = sorted(p.name for p in work.glob("db*"))
        return judge(prefix, *args, **kw)

    monkeypatch.setattr(compare, "judge_db", spy)
    res = harness.run_cell(small_cell(), 20260919, 0.5, False, device="cpu",
                           log=lambda msg: None)
    # the warm-up job's database (db0) is gone even after one job
    assert res["correct"] and res["attempted"] >= 1
    last = harness._db_path(seen["prefix"].parent, res["attempted"] - 1)
    assert seen["prefix"] == last
    assert seen["left"] == [last.name + ".kmc_pre", last.name + ".kmc_suf"]
