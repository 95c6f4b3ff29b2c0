"""Microbenchmarks on the card: the port of tools/microbench_sort.py.

    python -m kmc_tpu_torch.microbench_sort \
        [sort|roofline|bitonic|pallas|scatter|onehot|all] [--device=cuda|cpu]

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

Each measurement of those two prints the tool's report line (name, n,
ms, GB/s), then the kernel's time against the byte bound (every column
read once and written once over 3.35 TB/s) and the library call.

The other four sections time the tool's XLA ops as torch ops on the same
inputs (no Pallas kernel runs there, so no kernel of the port's either),
with the tool's labels and byte counts; u32 math runs on int32 bit views:

  roofline  x + 1, the u32 cumulative sum and the reverse of N words
            (numpy seed 0), each 2 x 4 B x N moved;
  bitonic   one log N ladder of compare-exchange passes (a bitonic merge)
            built from torch.roll and torch.where, and one pass alone;
  scatter   a full permutation's scatter and gather (numpy seed 4) and a
            scatter-add histogram into 64 K bins (index_add_);
  onehot    the permutation of 256-row tiles of 8 u8 columns by a bf16
            einsum with one_hot(perm) (numpy seed 5; at most 2^24 rows, as
            the tool).
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


def _rand_u32(n: int, dev, seed: int = 0) -> torch.Tensor:
    """The tool's rand_u32 (numpy seed), as an int32 bit view."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2**32, size=n, dtype=np.uint32).view(np.int32)).to(dev)


def _logn(n: int | None) -> int:
    n = n or 1 << int(os.environ.get("MB_LOGN", "28"))
    if n & (n - 1):
        raise ValueError("N must be a power of two")
    return n.bit_length() - 1


def u32_add1(x: torch.Tensor) -> torch.Tensor:
    return x + 1  # int32 adds wrap like u32


def u32_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The inclusive u32 sum, wrapping (int32 bit views)."""
    return torch.cumsum(x, 0, dtype=torch.int32)


def reverse(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, (0,))


def sec_roofline(n: int | None = None, device="cuda") -> dict:
    """The tool's roofline section: x + 1, cumsum and reverse of N u32
    words; returns {label: {"n", "ms", "gbs"}}."""
    logn = _logn(n)
    N = 1 << logn
    dev = resolve_device(device)
    a = _rand_u32(N, dev)
    out = {}
    for label, fn in (("elementwise add (r+w)", u32_add1),
                      ("cumsum u32", u32_cumsum),
                      ("reverse (r+w)", reverse)):
        secs = _timeit(lambda: fn(a), dev)
        report(label, N, secs, 2 * 4 * N)
        out[label] = dict(n=N, ms=secs * 1e3, gbs=2 * 4 * N / secs / 1e9)
    return out


_SIGN = -(1 << 31)  # flips the sign bit: u32 order as int32 order


def ce_pass(x: torch.Tensor, stride: int, iota: torch.Tensor) -> torch.Tensor:
    """One bitonic compare-exchange pass at `stride` over u32 words (the
    tool's _ce_pass): the lower element of each pair takes the minimum,
    the upper the maximum, from rolled copies."""
    up = torch.roll(x, -stride)
    dn = torch.roll(x, stride)
    is_lo = (iota & stride) == 0
    fx, fup, fdn = x ^ _SIGN, up ^ _SIGN, dn ^ _SIGN
    return torch.where(is_lo, torch.minimum(fx, fup),
                       torch.maximum(fx, fdn)) ^ _SIGN


def bitonic_ladder(x: torch.Tensor, iota: torch.Tensor) -> torch.Tensor:
    """log N compare-exchange passes at strides N/2, ..., 1: a bitonic
    merge (the tool's `merge`)."""
    for s in range(x.shape[0].bit_length() - 2, -1, -1):
        x = ce_pass(x, 1 << s, iota)
    return x


def sec_bitonic(n: int | None = None, device="cuda") -> dict:
    """The tool's bitonic section: the merge ladder of log N passes and one
    pass alone; returns {label: {"n", "ms", "gbs"}}."""
    logn = _logn(n)
    N = 1 << logn
    dev = resolve_device(device)
    a = _rand_u32(N, dev)
    iota = torch.arange(N, dtype=torch.int32, device=dev)
    out = {}
    for label, fn, nbytes in (
            (f"bitonic merge ladder ({logn} passes)",
             lambda: bitonic_ladder(a, iota), 2 * 4 * N * logn),
            ("single compare-exchange pass",
             lambda: ce_pass(a, 1 << (logn - 1), iota), 2 * 4 * N)):
        secs = _timeit(fn, dev)
        report(label, N, secs, nbytes)
        out[label] = dict(n=N, ms=secs * 1e3, gbs=nbytes / secs / 1e9)
    return out


HIST_BINS = 1 << 16


def scatter_inputs(N: int, dev):
    """The tool's scatter inputs: x (seed 0), a permutation of N (seed 4)
    and its low 16 bits, the histogram's bins."""
    idx = torch.from_numpy(np.random.default_rng(4).permutation(N).astype(
        np.int32)).to(dev)
    return _rand_u32(N, dev), idx, idx & (HIST_BINS - 1)


def scatter_perm(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """zeros_like(x).at[idx].set(x)."""
    out = torch.zeros_like(x)
    out[idx.long()] = x
    return out


def gather_perm(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long()]


def scatter_add_histogram(bins: torch.Tensor) -> torch.Tensor:
    """zeros(64 K, u32).at[bins].add(1), as an int32 bit view."""
    hist = torch.zeros(HIST_BINS, dtype=torch.int32, device=bins.device)
    return hist.index_add_(0, bins.long(), torch.ones_like(bins))


def sec_scatter(n: int | None = None, device="cuda") -> dict:
    """The tool's scatter section: a full permutation's scatter and gather,
    and a scatter-add histogram into 64 K bins; returns {label: {"n",
    "ms"}}."""
    N = 1 << _logn(n)
    dev = resolve_device(device)
    a, idx, hi = scatter_inputs(N, dev)
    out = {}
    for label, fn in (("XLA scatter (full permutation)",
                       lambda: scatter_perm(a, idx)),
                      ("XLA gather (full permutation)",
                       lambda: gather_perm(a, idx)),
                      ("XLA scatter-add histogram (64K bins)",
                       lambda: scatter_add_histogram(hi))):
        secs = _timeit(fn, dev)
        report(label, N, secs, None)
        out[label] = dict(n=N, ms=secs * 1e3)
    return out


TILE = 256  # the one-hot permute's tile


def onehot_inputs(N: int, dev):
    """The tool's one-hot inputs (numpy seed 5): perm int32[nb, 256], each
    row one of 1024 permutations of 256, and vals u8[nb, 256, 8], nb =
    min(N, 2^24) / 256."""
    nb = min(N, 1 << 24) // TILE
    rng = np.random.default_rng(5)
    perm = np.stack([rng.permutation(TILE) for _ in range(1024)])[
        rng.integers(0, 1024, nb)].astype(np.int32)
    vals = rng.integers(0, 256, (nb, TILE, 8), dtype=np.uint8)
    return torch.from_numpy(perm).to(dev), torch.from_numpy(vals).to(dev)


def onehot_permute(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[b, i] = vals[b, perm[b, i]] as the tool computes it: a bf16
    einsum of one_hot(perm) with the rows (u8 values are exact in bf16)."""
    oh = torch.nn.functional.one_hot(perm.long(), TILE).to(torch.bfloat16)
    out = torch.einsum("bij,bjc->bic", oh, vals.to(torch.bfloat16))
    return out.to(torch.uint8)


def sec_onehot(n: int | None = None, device="cuda") -> dict:
    """The tool's onehot section: 256-row tiles of 8-byte rows permuted by
    a one-hot matmul; returns {label: {"n", "ms", "rows_per_s"}}."""
    N = 1 << _logn(n)
    dev = resolve_device(device)
    perm, vals = onehot_inputs(N, dev)
    label = "one-hot matmul permute 256-tiles (8B rows)"
    secs = _timeit(lambda: onehot_permute(perm, vals), dev)
    report(label, N, secs, None)
    print(f"  -> {N / secs / 1e6:.0f} M rows/s", flush=True)
    return {label: dict(n=N, ms=secs * 1e3, rows_per_s=N / secs)}


SECTIONS = {"sort": sec_sort, "roofline": sec_roofline,
            "bitonic": sec_bitonic, "pallas": sec_pallas,
            "scatter": sec_scatter, "onehot": sec_onehot}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for a in list(args):
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            args.remove(a)
    which = args[0] if args else "all"
    if which != "all" and which not in SECTIONS:
        print(f"no section {which!r}; the sections: {', '.join(SECTIONS)}",
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
