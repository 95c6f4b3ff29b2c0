"""The grouping sort: rows of u32 columns sorted by their leading key columns.

Kernel: csrc/radix_sort.cu, a one-sweep LSD radix sort that takes the place
of the TPU kernel kmc_tpu/ops/pallas_sort.py::pallas_bitonic_sort behind the
contract of kmc_tpu/ops/store.py::_grouping_sort (see the source for its
design and bound).  The pass plan and the buffers are made here: sort_plan
lists the digit passes and how the other columns ride with them, work_bytes
sizes the kernel's status, histogram and plan area.  Plain version:
radix_sort_plain below; it runs for CPU tensors and is what the kernel is
held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .extract import i32_to_u32

TILE = 6144  # rows a block of the pass kernel takes at a time
RADIX = 256
DIGIT_BITS = 8
# Carry whole rows through the passes up to this many columns; wider rows
# carry (key word, row index) and are gathered once at the end (see the
# kernel's source note: the scratch stays within 4 x n x 4 B either way).
ROWS_MAX_COLS = 3
MAX_COLS = 32


def radix_sort_plain(cols, n_keys: int):
    """A chain of stable torch.sorts on int64 copies, one per key column
    from the last to the first; every column is then gathered in the
    resulting row order."""
    n = cols[0].shape[0]
    perm = torch.arange(n, device=cols[0].device)
    for c in reversed(cols[:n_keys]):
        _, order = torch.sort(i32_to_u32(c)[perm], stable=True)
        perm = perm[order]
    return [c[perm] for c in cols]


def sort_plan(n_cols: int, n_keys: int):
    """The kernel's plan: (passes, rows_mode).  passes lists (column, shift,
    width) digit passes in the order they run, least significant first: the
    key columns from the last to the first, each byte from the low one up.
    rows_mode: every pass carries whole rows (n_cols <= ROWS_MAX_COLS),
    else it carries (key word, row index), a new key column is gathered
    through the index at its first live pass and every column once at the
    end.  The kernel skips, on the card, each pass whose digit is the same
    in every row."""
    if not 1 <= n_keys <= n_cols <= MAX_COLS:
        raise ValueError(f"need 1 <= n_keys <= n_cols <= {MAX_COLS}")
    passes = [(c, shift, DIGIT_BITS) for c in reversed(range(n_keys))
              for shift in range(0, 32, DIGIT_BITS)]
    return passes, n_cols <= ROWS_MAX_COLS


def _align256(b: int) -> int:
    return (b + 255) & ~255


def work_bytes(n: int, n_keys: int, n_passes: int) -> int:
    """Bytes of the kernel's work area (mirrors `layout` in the source):
    per (tile, digit) a u64 status word, per key byte a 256-bin histogram,
    per pass a tile counter, 256 digit bases and a plan entry."""
    n_tiles = (n + TILE - 1) // TILE
    return (_align256(n_tiles * RADIX * 8) + _align256(n_keys * 4 * RADIX * 4)
            + _align256(n_passes * 4) + _align256(n_passes * RADIX * 4)
            + _align256((n_passes + 1) * 16))


def _check(cols, n_keys: int):
    cols = list(cols)
    if not cols or not (1 <= n_keys <= len(cols)):
        raise ValueError("need 1 <= n_keys <= len(cols)")
    if len(cols) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns")
    n = cols[0].shape[0]
    dev = cols[0].device
    for c in cols:
        if c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != n:
            raise ValueError("columns must be 1-D int32 tensors of one length")
        if not c.is_contiguous():
            raise ValueError("columns must be contiguous")
        if c.device != dev:
            raise ValueError("columns must share one device")
    if n >= 1 << 32:
        raise ValueError("at most 2^32 - 1 rows")
    return cols, n, dev


def _launch(entry: str, cols, n_keys: int, *extra):
    """Allocate outputs, scratch and the work area for the sort of `cols`
    (checked, on one CUDA device, n > 0) and call C entry `entry` of
    csrc/radix_sort.cu on the current stream.  Returns the outputs."""
    from .. import _build

    n = cols[0].shape[0]
    dev = cols[0].device
    lib = _build.load("radix_sort")
    passes, rows_mode = sort_plan(len(cols), n_keys)
    # the outputs are columns of one block, which with a scratch block of
    # n_cols (rows mode) or 2 (index mode) columns makes the ping-pong pair;
    # columns start on 16-byte boundaries
    stride = (n + 3) // 4 * 4
    out = torch.empty((len(cols), stride), dtype=torch.int32, device=dev)
    scratch = torch.empty((len(cols) if rows_mode else 2, stride),
                          dtype=torch.int32, device=dev)
    nbytes = work_bytes(n, n_keys, len(passes))
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    flat = [v for p in passes for v in p]
    plan = (ctypes.c_int * len(flat))(*flat)
    col_ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            dev.index, col_ptrs, out.data_ptr(), scratch.data_ptr(), stride,
            len(cols), n_keys, n, plan, len(passes), int(rows_mode),
            work.data_ptr(), nbytes, stream, *extra)
    _build.check(lib, err, "radix sort launch")
    return [out[c, :n] for c in range(len(cols))]


def radix_sort_columns(cols, n_keys: int):
    """Sort rows ascending by cols[:n_keys] compared lexicographically as
    u32; the remaining columns are payloads that move with their rows.

    cols: equal-length contiguous 1-D int32 tensors (u32 bit views) on one
    device, 1 <= n_keys <= len(cols) <= 32.  Returns new sorted tensors.
    Equal keys keep their input order.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream (and count the
    launch); anything else raises."""
    cols, n, dev = _check(cols, n_keys)
    if dev.type == "cpu":
        return radix_sort_plain(cols, n_keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n == 0:
        return [torch.empty_like(c) for c in cols]
    outs = _launch("kmc_radix_sort_columns", cols, n_keys)
    radix_sort_columns.launches += 1
    return outs


radix_sort_columns.launches = 0


def radix_sort_stage_ms(cols, n_keys: int):
    """The kernel's sort of CUDA columns with CUDA events between its
    stages, waited for: (sorted columns, stage times in ms) with one time
    for the memset, histogram and plan, one per planned pass (a pass whose
    digit is constant only launches and returns) and one for the finish.
    A measurement entry: it does not count as a launch of the sort."""
    cols, n, dev = _check(cols, n_keys)
    if dev.type != "cuda" or n == 0:
        raise ValueError("stage times need rows on a CUDA device")
    n_stages = len(sort_plan(len(cols), n_keys)[0]) + 2
    ms = (ctypes.c_float * n_stages)()
    outs = _launch("kmc_radix_sort_stage_ms", cols, n_keys, ms)
    return outs, list(ms)
