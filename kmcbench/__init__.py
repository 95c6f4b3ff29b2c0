"""kmcbench: the benchmark of kmc_tpu_torch, the PyTorch/CUDA port.

One command runs one cell once:

    python kmcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (configs/<name>.json: a deployment's knobs and
genome) under a traffic mix (traffic/<name>.json: the sample's reads),
both named in BENCHMARK.json at the checkout's root.  Each metric is a
reader of its own, metrics/<name>.py.  The plain reference (reference.py)
counts the generated reads again in plain PyTorch and judges the
database the timed jobs wrote (compare.py, kmc2.py).  Nothing here
imports jax or the JAX package.
"""
