"""The device trace of a traced window: torch.profiler over whole jobs,
reduced to device busy time (of all cards together, and of each card),
device time by kernel and the idle gaps, each gap named by the
benchmark's host span that was open then.

Device activity is the union of kernel, memcpy and memset spans (the
port's chip_smoke.py `_union_us`), clipped to the profiled jobs' spans
("job" labels, so the profiler's own start and stop stay outside)."""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler(device_type: str):
    """torch.profiler over every host thread (the ingest runs on a worker
    thread) and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        return profile(activities=acts, experimental_config=
                       _ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=acts)


def union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _clip(spans, windows):
    out = []
    for a, b in spans:
        for lo, hi in windows:
            if a < hi and b > lo:
                out.append((max(a, lo), min(b, hi)))
    return out


@dataclass
class Trace:
    windows: list                 # (start, end) us of each profiled job
    device: list                  # (name, start, end) us, clipped
    host: list = field(default_factory=list)  # (name, start, end) us
    cards: list = field(default_factory=list)  # each device event's card

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.windows) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((a, b) for _, a, b in self.device) / 1e6

    def card_busy_s(self, n_cards: int) -> list:
        """Busy seconds of each of n_cards cards, the union of its own
        events; a card with no event reads 0."""
        ids = sorted(set(self.cards), key=str)
        busy = [union_us((a, b) for (_, a, b), c in zip(self.device,
                                                        self.cards) if c == i)
                / 1e6 for i in ids]
        return busy + [0.0] * (n_cards - len(busy))

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose name holds one of names as
        a whole identifier."""
        pat = re.compile(r"(?<![A-Za-z_])(" + "|".join(map(re.escape, names))
                         + r")(?![A-Za-z_])")
        return sum(b - a for n, a, b in self.device if pat.search(n)) / 1e6

    def device_ops(self, top=10) -> list:
        by = {}
        for n, a, b in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])
                [:top]]

    def idle_gaps(self, top=10) -> list:
        """The longest stretches of the profiled jobs with no device
        activity, each named by the innermost host span open at its
        middle."""
        busy = sorted((a, b) for _, a, b in self.device)
        gaps = []
        for lo, hi in self.windows:
            at = lo
            for a, b in busy:
                if b <= lo or a >= hi:
                    continue
                if a > at:
                    gaps.append((at, a))
                at = max(at, b)
            if hi > at:
                gaps.append((at, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            open_ = [(s, n) for n, s, e in self.host if s <= mid <= e]
            name = max(open_)[1] if open_ else "none"
            out.append([name, (b - a) / 1e6])
        return out


def read(prof, path: Path, host_names) -> Trace | None:
    """Export prof's trace to path, reduce it, delete the file.  None when
    the trace holds no profiled job."""
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    windows, host, dev = [], [], []
    for e in events:
        if "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat == "user_annotation":
            if e.get("name") == "job":
                windows.append((a, b))
            elif e.get("name") in host_names:
                host.append((e["name"], a, b))
        elif cat in DEVICE_CATS:
            card = (e.get("args") or {}).get("device", e.get("pid"))
            dev.append((e.get("name", cat), a, b, card))
    if not windows:
        return None
    windows.sort()
    clipped = [(n, ab, card) for n, s, e, card in dev
               for ab in _clip([(s, e)], windows)]
    device = [(n, a, b) for n, (a, b), _ in clipped]
    return Trace(windows=windows, device=device, host=host,
                 cards=[card for _, _, card in clipped])
