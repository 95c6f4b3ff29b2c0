"""Microbenchmarks on the card: the port of tools/microbench_sort.py's
`pallas` and `sort` sections.

    python -m kmc_tpu_torch.microbench_sort [pallas|sort|all] \
        [--device=cuda|cpu]

MB_LOGN (default 28) sets N = 2^MB_LOGN u32 words, as in the tool.

`pallas`: memory probes over u32[N/1024, 1024].  Three hand-written CUDA
probes (csrc/probes.cu) replace the section's three Pallas kernels:

  probe_add1          o = x + 1                            (copy_kernel)
  probe_gather_rows   per block of 1024 rows, o[r, :] = x[idx[r], :]
                                                           (gather_kernel)
  probe_gather_lanes  o[r, c] = x[r, idxl[c]]              (gatherl_kernel)

idx and idxl are permutations of 1024 (numpy seeds 2 and 3, as in the
tool).  Each probe has a plain torch version (x + 1, index_select over each
block's rows, index_select over columns); the plain version runs for CPU
tensors, and on the card it is also the library call the probe is timed
against.

`sort`: the tool's lax.sort measurements made with the grouping-sort
kernel (ops/sort_kernel.py::radix_sort_columns, csrc/radix_sort.cu) on
u32 columns from numpy seeds 0 and 1: 2 keys; 1 key + 1 payload; 1 key
alone; 8-bit values + payload; 2 keys at 2^24 and 2^26 rows; a pre-sorted
key.  Each line sets the kernel beside one torch.sort of the same rows: of
a packed int64 key for 2 keys, of the int64 key (stable=True when a
payload rides) otherwise.  --device=cpu runs the plain version.

Each measurement prints the tool's report line (name, n, ms, GB/s), then
the kernel's time against the byte bound (every column read once and
written once over 3.35 TB/s) and the library call.  The tool's other
sections (roofline, bitonic, scatter, onehot) run no Pallas kernel and
are not ported (ROADMAP §A).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .device import device_name, resolve_device
from .ops.extract import i32_to_u32
from .ops.sort_kernel import radix_sort_columns

ROW = 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate


def report(name, n, secs, bytes_moved=None):
    """The tool's report line."""
    gbs = f"  {bytes_moved / secs / 1e9:8.1f} GB/s" if bytes_moved else ""
    print(f"{name:44s} n=2^{int(np.log2(n)):2d}  {secs*1e3:9.2f} ms{gbs}",
          flush=True)


def _check_rows(x: torch.Tensor):
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != ROW:
        raise ValueError("x must be an int32 (u32 bit view) [R, 1024] tensor")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _check_idx(idx: torch.Tensor, x: torch.Tensor):
    if idx.dtype != torch.int32 or idx.shape != (ROW,):
        raise ValueError("idx must be an int32[1024] tensor")
    if idx.device != x.device or not idx.is_contiguous():
        raise ValueError("idx must be contiguous, on x's device")


def probe_add1_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1  # int32 add wraps like u32


def probe_gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    blocks = x.view(-1, ROW, ROW)  # [R/1024 blocks, 1024 rows, 1024 lanes]
    return torch.index_select(blocks, 1, idx).view(x.shape)


def probe_gather_lanes_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(x, 1, idx)


def _launch(entry: str, x: torch.Tensor, idx, fn):
    """Launch C entry `entry` of csrc/probes.cu on x (and idx) into a new
    output on the current stream; counts the launch on fn."""
    from . import _build

    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    lib = _build.load("probes")
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if idx is None:
            err = getattr(lib, entry)(x.data_ptr(), o.data_ptr(), x.numel(),
                                      stream)
        else:
            err = getattr(lib, entry)(x.data_ptr(), idx.data_ptr(),
                                      o.data_ptr(), x.shape[0], stream)
    _build.check(lib, err, f"{entry} launch")
    fn.launches += 1
    return o


def probe_add1(x: torch.Tensor) -> torch.Tensor:
    """o = x + 1 over an int32 (u32) [R, 1024] tensor.  CPU tensors take
    the plain version; CUDA tensors launch the kernel and count it."""
    _check_rows(x)
    if x.device.type == "cpu":
        return probe_add1_plain(x)
    return _launch("kmc_probe_add1", x, None, probe_add1)


def probe_gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per block of 1024 rows, o[r, :] = x[idx[r], :]; R % 1024 == 0 and
    idx is int32[1024] with values in [0, 1024)."""
    _check_rows(x)
    _check_idx(idx, x)
    if x.shape[0] % ROW:
        raise ValueError("x must hold whole blocks of 1024 rows")
    if x.device.type == "cpu":
        return probe_gather_rows_plain(x, idx)
    return _launch("kmc_probe_gather_rows", x, idx, probe_gather_rows)


def probe_gather_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """o[r, c] = x[r, idx[c]]; idx is int32[1024] with values in
    [0, 1024)."""
    _check_rows(x)
    _check_idx(idx, x)
    if x.device.type == "cpu":
        return probe_gather_lanes_plain(x, idx)
    return _launch("kmc_probe_gather_lanes", x, idx, probe_gather_lanes)


for _fn in (probe_add1, probe_gather_rows, probe_gather_lanes):
    _fn.launches = 0


def probe_inputs(n: int, device):
    """The section's inputs: x = u32[n/1024, 1024] (numpy seed 0) and the
    row and lane permutations (seeds 2 and 3), as in the tool."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32).view(np.int32)
    idx = np.random.default_rng(2).permutation(ROW).astype(np.int32)
    idxl = np.random.default_rng(3).permutation(ROW).astype(np.int32)
    return (torch.from_numpy(x).reshape(n // ROW, ROW).to(dev),
            torch.from_numpy(idx).to(dev), torch.from_numpy(idxl).to(dev))


def _timeit(fn, dev, warmup=1, iters=3, reps=1) -> float:
    """Best seconds of fn() over iters runs after warm-up, a run being the
    mean of reps calls back to back (so the host's launch work hides
    behind the device's after the first): CUDA events on the card, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(iters):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3 / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            secs = (time.perf_counter() - t0) / reps
        best = min(best, secs)
    return best


def sec_pallas(n: int | None = None, device="cuda") -> dict:
    """Run and time the three probes at N = n words (default 2^MB_LOGN);
    returns {name: {"ms", "library_ms", "bound_ms", "gbs"}}, the report
    lines printed as it goes."""
    n = n or 1 << int(os.environ.get("MB_LOGN", "28"))
    if n % (ROW * ROW):
        raise ValueError("N must be a multiple of 2^20 (blocks of 1024 rows)")
    dev = resolve_device(device)
    x, idx, idxl = probe_inputs(n, dev)
    nbytes = 2 * 4 * n
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    # (probe, the tool's label for its Pallas kernel, plain version, inputs)
    for fn, label, plain, args in (
            (probe_add1, "block passthrough (r+w)", probe_add1_plain, (x,)),
            (probe_gather_rows, "in-VMEM take(1024 rows)",
             probe_gather_rows_plain, (x, idx)),
            (probe_gather_lanes, "in-VMEM take(lanes)",
             probe_gather_lanes_plain, (x, idxl))):
        name = fn.__name__
        fn(*args)  # warm-up
        plain(*args)
        secs = lib_secs = float("inf")
        for _ in range(10):  # best of 10, in turns: drift hits both alike
            secs = min(secs, _timeit(lambda: fn(*args), dev, 0, 1, 10))
            lib_secs = min(lib_secs,
                           _timeit(lambda: plain(*args), dev, 0, 1, 10))
        report(f"{name} {label}", n, secs, nbytes)
        print(f"  {name}: {secs * 1e3:.4f} ms, bound {bound_ms:.4f} ms "
              f"(2 x 4 B x N at 3.35 TB/s), library {lib_secs * 1e3:.4f} ms",
              flush=True)
        out[name] = dict(ms=secs * 1e3, library_ms=lib_secs * 1e3,
                         bound_ms=bound_ms, gbs=nbytes / secs / 1e9)
    return out


def _u32_cols(n: int, dev):
    """The tool's rand_u32 columns (numpy seeds 0 and 1), as int32 bit
    views."""
    return [torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2**32, size=n, dtype=np.uint32).view(np.int32)).to(dev)
        for seed in (0, 1)]


def _packed_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key ordered as (hi, lo) compared as u32: (hi - 2^31) <<
    32 | lo."""
    return ((i32_to_u32(hi) - (1 << 31)) << 32) | i32_to_u32(lo)


def sec_sort(n: int | None = None, device="cuda") -> dict:
    """Time the grouping sort at the tool's shapes (N = n rows, default
    2^MB_LOGN) beside one torch.sort of the same rows; returns {label:
    {"n", "ms", "library_ms", "bound_ms", "gbs"}}, the report lines printed
    as it goes."""
    n = n or 1 << int(os.environ.get("MB_LOGN", "28"))
    dev = resolve_device(device)
    a, b = _u32_cols(n, dev)
    a8 = a & 0xFF
    s = torch.arange(n, dtype=torch.int32, device=dev)
    cases = [  # (label, columns, n_keys, the library call's key, stable)
        ("2 u32 keys", [a, b], 2, lambda: _packed_key(a, b), False),
        ("1 u32 key + 1 payload", [a, b], 1, lambda: i32_to_u32(a), True),
        ("1 u32 key alone", [a], 1, lambda: i32_to_u32(a), False),
        ("u32(8-bit values) + payload", [a8, b], 1, lambda: i32_to_u32(a8),
         True),
    ]
    for m in (1 << 24, 1 << 26):
        if m <= n:
            cases.append(("2 u32 keys", [a[:m], b[:m]], 2,
                          lambda m=m: _packed_key(a[:m], b[:m]), False))
    cases.append(("pre-sorted 1 key", [s], 1, lambda: i32_to_u32(s), False))
    out = {}
    for label, cols, n_keys, make_key, stable in cases:
        rows = cols[0].shape[0]
        nbytes = 2 * 4 * rows * len(cols)
        secs = _timeit(lambda: radix_sort_columns(cols, n_keys), dev)
        key = make_key()
        lib_secs = _timeit(lambda: torch.sort(key, stable=stable), dev)
        del key
        report(f"radix_sort {label}", rows, secs, nbytes)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  {label}: kernel_ms {secs * 1e3:.4f}, bound_ms "
              f"{bound_ms:.4f}, library_ms {lib_secs * 1e3:.4f} (torch.sort"
              f"{', stable' if stable else ''})", flush=True)
        out[f"{label} n=2^{rows.bit_length() - 1}"] = dict(
            n=rows, ms=secs * 1e3, library_ms=lib_secs * 1e3,
            bound_ms=bound_ms, gbs=nbytes / secs / 1e9)
    return out


SECTIONS = {"pallas": sec_pallas, "sort": sec_sort}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for a in list(args):
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            args.remove(a)
    which = args[0] if args else "all"
    if which != "all" and which not in SECTIONS:
        print(f"section {which!r} is not ported: it runs no Pallas kernel "
              f"(ROADMAP §A lists it); ported: {', '.join(SECTIONS)}",
              file=sys.stderr)
        return 2
    dev = resolve_device(device)
    print(f"device={device_name(dev)}", flush=True)
    for name, fn in SECTIONS.items():
        if which in ("all", name):
            print(f"--- {name} ---", flush=True)
            fn(device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
