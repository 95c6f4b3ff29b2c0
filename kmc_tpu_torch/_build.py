"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled on its own by nvcc for sm_90a into a shared library
with a plain C interface (no PyTorch headers), all sources in parallel, and
loaded with ctypes.  Wrappers pass device pointers and the CUDA stream as
c_void_p.  Libraries go into kmc_tpu_torch/_build/cuda/, named by a hash of
the source, so an edited source is rebuilt and an unchanged one is reused.
Importing this module needs no nvcc: nothing is compiled until a kernel is
first launched (or build_all() is called).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build" / "cuda"
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SORT_ARGS = [_I32, ctypes.POINTER(_P), _P, _P, _I64, _I32, _I32, _I64,
              ctypes.POINTER(_I32), _I32, _I32, _P, _I64, _P]
_SCAN_ARGS = [_I32, _P, _I64, _P, _P, _I64, _I32, _I32, _I32, _P]
# counts, occ, skm, prev_in, prev_out, s, k, sig_len, both_strands,
# prefix_bits, fuse, map (null: the prefix entry), map_len, hist (or null),
# stream
_INGEST_TAIL = [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P,
                _I64, _P, _P]
# source name -> {C entry: argtypes}; every entry returns a cudaError_t
SIGNATURES = {
    "extract": {
        # device, codes, n_codes, sig, lanes, s, k, sig_len, both_strands,
        # stream
        "kmc_splitter_scan": _SCAN_ARGS,
        # the same arguments, under pallas_extract's 1-D contract
        "kmc_splitter_scan_1d": _SCAN_ARGS,
        # device, buf, n_buf, tail_start, scratch, cols, n_cols, n_used,
        # counts, occ, skm, prev_in, prev_out, s, k, sig_len, both_strands,
        # prefix_bits, fuse, map, map_len, hist, stream
        "kmc_ingest_bounds": [_I32, _P, _I64, _I64, _P, ctypes.POINTER(_P),
                              _I32, _I64] + _INGEST_TAIL,
        # the same without tail_start and scratch
        "kmc_ingest_mask": [_I32, _P, _I64, ctypes.POINTER(_P), _I32,
                            _I64] + _INGEST_TAIL,
    },
    "radix_sort": {
        # device, cols, out, scratch, stride, n_cols, n_keys, n, passes,
        # n_passes, rows_mode, work, work_bytes, stream
        "kmc_radix_sort_columns": _SORT_ARGS,
        # the same, then float stage_ms[n_passes + 2]
        "kmc_radix_sort_stage_ms": _SORT_ARGS + [ctypes.POINTER(
            ctypes.c_float)],
    },
    "ragged_a2a": {
        # device, peer
        "kmc_enable_peer_access": [_I32, _I32],
        # device, table, n_dev, owner, cap, n_words_row, chunk_rows,
        # n_chunks, out, stream
        "kmc_ragged_a2a_owner": [_I32, _P, _I32, _I32, _I64, _I32, _I64,
                                 _I64, _P, _P],
        # device, bytes, void** ptr, handle (64 bytes)
        "kmc_ipc_alloc": [_I32, _I64, ctypes.POINTER(_P), _P],
        # device, ptr
        "kmc_ipc_free": [_I32, _P],
        # device, handle (64 bytes), void** ptr
        "kmc_ipc_open": [_I32, _P, ctypes.POINTER(_P)],
        "kmc_ipc_close": [_I32, _P],
    },
    "probes": {
        # x, o, n, stream
        "kmc_probe_add1": [_P, _P, _I64, _P],
        # x, idx, o, n_rows, stream (rows of 1024 u32, idx int32[1024])
        "kmc_probe_gather_rows": [_P, _P, _P, _I64, _P],
        "kmc_probe_gather_lanes": [_P, _P, _P, _I64, _P],
    },
}
SOURCES = tuple(SIGNATURES)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of kmc_tpu_torch "
                       "are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every missing kernel library (one nvcc per source, all
    started together).  Returns {name: compiler report}; with verbose the
    report holds ptxas's register and shared-memory use (-Xptxas -v)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        so = _lib_path(name)
        if so.exists() and not verbose:
            continue
        tmp = so.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    reports = {}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name` (building it if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _lib_path(name)
            if not so.exists():
                build_all()
            lib = ctypes.CDLL(str(so))
            lib.kmc_cuda_error_string.restype = ctypes.c_char_p
            lib.kmc_cuda_error_string.argtypes = [ctypes.c_int]
            for entry, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err:
        msg = lib.kmc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
