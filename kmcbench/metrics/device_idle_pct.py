"""device_idle_pct: the share of the traced jobs' wall time in which no
kernel, memcpy or memset ran on the card, in %."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
