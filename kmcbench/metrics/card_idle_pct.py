"""card_idle_pct: the mean over a cell's cards of each card's idle share
of the traced jobs' wall time, the share in which no kernel, memcpy or
memset ran on that card, in %.  On one card it equals
device_idle_pct."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    busy = t.card_busy_s(run.cell.chips)
    return 100.0 * (1.0 - sum(busy) / len(busy) / t.window_s)
