"""setup_s: from the process's start to the first job of the window:
imports, the card, the input written, and one warm-up job (on a
checkout's first run, the nvcc and native builds too)."""


def read(run):
    return run.setup_s
