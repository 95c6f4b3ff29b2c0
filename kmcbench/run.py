"""Run one cell of kmc_tpu_torch's benchmark once.

    python kmcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints its readings on standard error, the numbers compared with the
plain reference (each beside its limit) last, and the result as one JSON
object on the last line of standard output.  Exits non-zero, with no
result, without as many CUDA cards as the cell asks for, or when JAX or
the JAX package was loaded.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from kmcbench.harness import load_cell, run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, never this folder, heads the module path
    sys.path[0] = str(ROOT)
    # kernel and build caches at fixed paths inside the checkout
    cache = ROOT / "_kmcbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    sys.exit(main())
