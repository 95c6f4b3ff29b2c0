"""kmc_tpu_torch: the PyTorch/CUDA port of kmc_tpu, for NVIDIA Hopper.

The default `kmc` count (k 14..256, canonical, prefix signature->bin map,
device store, KMC2 output) runs on the card through two hand-written CUDA
kernels, the splitter scan and the grouping sort, and writes databases
byte-identical to kmc_tpu's; so do KFF output and -w, small k (k <= 13,
KMC1 output), the host-bucket route (device_store=False), the ntCard
estimator (-e, --opt-out-size) and BAM and KMC-database input (-fbam,
-fkmc).  distributed_count splits the store into shards, one per device
of a list (a device may repeat), and routes rows to their bin owners
through a third kernel, the ragged all-to-all; after init_multihost the
shards of several processes (a torch.distributed group) form one store,
the kernel reading peer processes' rows through CUDA IPC.  Entry points take
device="cuda" (default) or device="cpu" (devices= for the sharded count);
they never fall back to the CPU on their own.

The readers of KMC databases (formats.kmc_db.read_db, formats.dump,
formats.streaming, api.KMCFile / KmerAPI, dump_cli, py_kmc_api) are host
code: the counting names below load torch on first use (PEP 562), so
importing a reader module loads neither torch nor jax.
"""
import importlib

_LAZY = {
    "EstimateHistogramCfg": ".runner",
    "InputFileType": ".runner",
    "OutputFileType": ".runner",
    "Runner": ".runner",
    "Stage1Params": ".runner",
    "Stage1Results": ".runner",
    "Stage2Params": ".runner",
    "Stage2Results": ".runner",
    "count": ".runner",
    "distributed_count": ".parallel.multihost",
    "init_multihost": ".parallel.distributed",
    "make_mesh": ".parallel.distributed",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
