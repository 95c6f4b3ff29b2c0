"""The device trace's reduction: each event keeps its card, the busy
seconds of each card, and the readers of the mean card's idle share."""
import json

import pytest

from kmcbench import devtrace, harness


class FakeProf:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def kernel(card, ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": card,
            "ts": ts, "dur": dur, "args": {"device": card}}


def job(ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": "job", "ts": ts,
            "dur": dur}


def trace_of(events, tmp_path):
    return devtrace.read(FakeProf(events), tmp_path / "t.json", ("job",))


def test_each_card_keeps_its_events(tmp_path):
    """Two cards over a 100 us job: card 0 busy 40 us (two overlapping
    kernels), card 1 busy 10 us; a kernel outside the job is clipped."""
    t = trace_of([job(0, 100), kernel(0, 10, 30), kernel(0, 20, 30),
                  kernel(1, 60, 10), kernel(1, 150, 10)], tmp_path)
    assert t.cards == [0, 0, 1]
    assert t.card_busy_s(2) == pytest.approx([40e-6, 10e-6])
    # a card with no event reads 0
    assert t.card_busy_s(4) == pytest.approx([40e-6, 10e-6, 0.0, 0.0])
    # the union over both cards, as a one-card cell reads it
    assert t.busy_s == pytest.approx(50e-6)


def run_of(trace, chips):
    cell = harness.Cell("c", {}, {}, chips)
    return harness.Run(cell=cell, device_kind="cpu", trace=trace)


def test_card_idle_pct(tmp_path):
    read = harness.load_reader("card_idle_pct").read
    t = trace_of([job(0, 100), kernel(0, 0, 40), kernel(1, 0, 10)],
                 tmp_path)
    # cards idle 60% and 90%, and cards 2 and 3 all of the job
    assert read(run_of(t, 4)) == pytest.approx((60 + 90 + 100 + 100) / 4)
    one = trace_of([job(0, 100), kernel(0, 10, 30), kernel(0, 20, 30)],
                   tmp_path)
    assert read(run_of(one, 1)) == pytest.approx(
        harness.load_reader("device_idle_pct").read(run_of(one, 1)))
    assert read(run_of(None, 4)) is None
