"""kmc_dump CLI on the port (the counterpart of kmc_tpu/dump_cli.py;
KMC's kmc_dump/kmc_dump.cpp — deprecated in favour of `kmc_tools transform
dump`, kept for compatibility).  Host code only: it loads no torch.

    python -m kmc_tpu_torch.dump_cli [-cx<val>] [-ci<val>] <kmc_database> <output_file>
"""
from __future__ import annotations

import sys

from .api import KMCFile, KmerAPI

USAGE = """kmc_dump (kmc_tpu_torch) — list k-mers of a KMC database to text
Usage: kmc_dump [options] <kmc_database> <output_file>
Options:
  -ci<value> - exclude k-mers occurring less than <value> times
  -cx<value> - exclude k-mers occurring more of than <value> times
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ci = None
    cx = None
    positional = []
    for a in argv:
        if a.startswith("-ci"):
            ci = int(a[3:])
        elif a.startswith("-cx"):
            cx = int(a[3:])
        elif a == "--help":
            print(USAGE)
            return 0
        else:
            positional.append(a)
    if len(positional) != 2:
        print(USAGE)
        return 1
    db_path, out_path = positional
    # native fast path: listing order with the listing-mode default
    # cutoffs (header ci/cx unless overridden, kmc_api/kmc_file.cpp)
    if not str(db_path).endswith(".kff"):
        from .formats.kmc_db import read_pre_meta
        from .tools import native_tools

        try:
            info = read_pre_meta(db_path)[0]
        except (OSError, ValueError):
            info = None
        if info is not None:
            eff = (ci if ci is not None else info.cutoff_min,
                   cx if cx is not None else info.cutoff_max)
            try:
                if native_tools.run_dump(db_path, out_path, in_cut=eff,
                                         sorted_order=False) is not None:
                    return 0
            except OSError:
                pass  # fall through to the listing API
    f = KMCFile()
    if not f.OpenForListing(db_path):
        print(f"Error: cannot open database {db_path}", file=sys.stderr)
        return 1
    if ci is not None:
        f.SetMinCount(ci)
    if cx is not None:
        f.SetMaxCount(cx)
    kmer = KmerAPI()
    with open(out_path, "w") as out:
        while True:
            ok, count = f.ReadNextKmer(kmer)
            if not ok:
                break
            out.write(f"{kmer.to_string()}\t{count}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
