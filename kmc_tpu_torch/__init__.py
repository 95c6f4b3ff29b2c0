"""kmc_tpu_torch: the PyTorch/CUDA port of kmc_tpu, for NVIDIA Hopper.

The default `kmc` count (k 14..256, canonical, prefix signature->bin map,
device store, KMC2 output) runs on the card through two hand-written CUDA
kernels, the splitter scan and the grouping sort, and writes databases
byte-identical to kmc_tpu's; so do KFF output and -w, small k (k <= 13,
KMC1 output), the host-bucket route (device_store=False) and the ntCard
estimator (-e, --opt-out-size).  distributed_count splits the store into
shards, one per device of a list (a device may repeat), and routes rows to
their bin owners through a third kernel, the ragged all-to-all.  Entry
points take device="cuda" (default) or device="cpu" (devices= for the
sharded count); they never fall back to the CPU on their own.
"""
from .runner import (
    EstimateHistogramCfg,
    InputFileType,
    OutputFileType,
    Runner,
    Stage1Params,
    Stage1Results,
    Stage2Params,
    Stage2Results,
    count,
)
from .parallel.distributed import make_mesh
from .parallel.multihost import distributed_count

__all__ = [
    "EstimateHistogramCfg",
    "InputFileType",
    "OutputFileType",
    "Runner",
    "Stage1Params",
    "Stage1Results",
    "Stage2Params",
    "Stage2Results",
    "count",
    "distributed_count",
    "make_mesh",
]
