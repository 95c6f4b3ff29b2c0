"""The control of the comparison that decides `correct`: the plain
reference put in the program's place with one of the configuration's
guarantees broken, exact counts (control_count keys k-mers by a 32-bit
hash, as an approximate counter would).  It has to come out not correct.
The benchmark's own runs never run it.

    python kmcbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints, for each seed, the compared numbers of the control's output
against the reference, beside their limits.  The control writes no
database, so records_misplaced is not read.  It runs on the card, at
the cell's own size.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(sample, seed: int, knobs: dict, device) -> dict:
    """The compared numbers of the control's database and stage-2 counts
    for one seed."""
    from kmcbench import compare, reference

    cmin, cmax, cmx = (knobs["cutoff_min"], knobs["cutoff_max"],
                       knobs["counter_max"])
    ref = reference.count(sample, seed, knobs["kmer_len"], device)
    ctl = reference.control_count(ref)
    ref_keys, ref_counters = ref.kept(cmin, cmax, cmx)
    keys, counters = ctl.kept(cmin, cmax, cmx)
    return {"records_wrong": compare.records_wrong(ref_keys, ref_counters,
                                                   keys, counters),
            "header_wrong": int(keys.numel() != ref_keys.numel()),
            "jobs_wrong": compare.jobs_wrong([ctl.stats(cmin, cmax)],
                                             ref.stats(cmin, cmax)),
            "n_unique": ref.keys.numel(), "n_kept": ref_keys.numel()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from kmcbench import compare
    from kmcbench.harness import load_cell

    cell = load_cell(args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        numbers = control_numbers(cell.sample, seed, cell.knobs, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": compare.passed(numbers),
                          "numbers": numbers,
                          "limits": compare.LIMITS}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, never this folder
    sys.exit(main())
