"""Develop-mode diagnostics (the port's copy of kmc_tpu/develop.py; KMC's
kmc_core/develop.cpp:9-60).

The reference's DEVELOP_MODE dumps the signature->bin mapping and per-bin
record statistics; these helpers produce the same information from a built
signature map or a finished database.  Enabled from the CLI with
KMC_TPU_DEVELOP=1 (the reference uses a compile-time flag, defs.h:22).
"""
from __future__ import annotations

import numpy as np


def dump_signature_map(sig_map: np.ndarray, sig_len: int, path: str):
    """One line per signature: <ACGT m-mer> <signature value> <bin id>
    (reference develop.cpp map_log)."""
    with open(path, "w") as f:
        for sig, b in enumerate(np.asarray(sig_map)):
            if sig < (1 << (2 * sig_len)):
                mmer = "".join(
                    "ACGT"[(sig >> (2 * (sig_len - 1 - j))) & 3]
                    for j in range(sig_len)
                )
            else:
                mmer = "#" * sig_len  # the special (disallowed) slot
            f.write(f"{mmer}\t{sig}\t{int(b)}\n")


def dump_bin_stats(db_path: str, path: str):
    """Per-bin record counts and sizes of a KMC2 database
    (reference develop.cpp bin stats log)."""
    from .formats.kmc_db import read_db

    db = read_db(db_path)
    bins = db.bin_ids()
    n_bins = db.info.n_bins
    counts = np.bincount(bins, minlength=n_bins)
    rec_bytes = db.info.record_bytes
    with open(path, "w") as f:
        f.write("bin\tn_records\tbytes\n")
        for b in range(n_bins):
            f.write(f"{b}\t{counts[b]}\t{counts[b] * rec_bytes}\n")
    return counts
