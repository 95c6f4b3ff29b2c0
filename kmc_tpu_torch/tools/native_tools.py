"""ctypes bindings for the native streaming tools core
(native/kmc_stream.cpp): sorted-stream KMC1/KMC2/KFF readers, k-way bin
merge, set-operation merges, expressions, histograms, compare, KMC1 record
and LUT emission, the text dump and the read-counter lookups of KMCFile's
random-access mode, all in C++.  The port's copy of
kmc_tpu/tools/native_tools.py.

KMC's analogues: CKMC2DbReader (kmc_tools/kmc2_db_reader.h:400-560), the
operations.h sorted merges, and CKMC1DbWriter.  The library is built on
first use from the same source with the same g++ command into the port's
own build directory (kmc_tpu_torch/_build/native/), keyed on a hash of the
source, as io/native.py builds kmc_host.cpp.  A failed build raises: the
port has no silent fallback for its native runtime.  Inputs outside the
native scope (KFF shapes it does not stream, non-default encodings) return
None so the callers take their NumPy paths, and KMC_TPU_NATIVE_TOOLS=0
selects those paths everywhere (kmc_tpu's switch, which the tests use to
hold both paths against each other).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..formats.kmc_db import KMC1_VER, PRE_MARKER, read_pre_meta

_lock = threading.Lock()
_lib = None
_threads_pending = None  # set_threads() called before the lib was built


def set_threads(n: int | None):
    """Worker-thread count for the chunk-parallel native drivers
    (kst_op/kst_dump/kst_expr): None/0 = auto (hardware concurrency),
    1 = serial, N = N threads — the kmc_tools global -t flag
    (kmc_tools/kmc2_db_reader.h:400-560 runs its merge across -t too)."""
    global _threads_pending
    _threads_pending = 0 if n is None else int(n)
    if _lib is not None:
        _lib.kst_set_threads(_threads_pending)


def get_threads() -> int:
    """The last set_threads value (0 = auto/unset) — consumers like the
    filter pipeline read it to decide whether to run staged threads."""
    return 0 if _threads_pending is None else int(_threads_pending)

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "kmc_stream.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"

OP_CODES = {
    "copy": 0,
    "union": 1,
    "intersect": 2,
    "kmers_subtract": 3,
    "counters_subtract": 4,
}
MODE_CODES = {
    "min": 0, "max": 1, "sum": 2, "diff": 3,
    "left": 4, "from_db1": 4, "right": 5, "from_db2": 5,
}


class _InputSpec(ctypes.Structure):
    _fields_ = [
        ("suf_path", ctypes.c_char_p),
        ("luts", ctypes.POINTER(ctypes.c_uint64)),
        ("n_sections", ctypes.c_uint64),
        ("lut_size", ctypes.c_uint64),
        ("kmer_len", ctypes.c_uint32),
        ("lut_prefix_len", ctypes.c_uint32),
        ("counter_size", ctypes.c_uint32),
        ("ci", ctypes.c_uint64),
        ("cx", ctypes.c_uint64),
        # format 0 = KMC .kmc_suf, 1 = KFF raw sections (whole big-endian
        # k-mer bytes + BE counters; sections at sec_offsets/sec_counts)
        ("format", ctypes.c_uint32),
        ("sec_offsets", ctypes.POINTER(ctypes.c_uint64)),
        ("sec_counts", ctypes.POINTER(ctypes.c_uint64)),
    ]


def _enabled() -> bool:
    return os.environ.get("KMC_TPU_NATIVE_TOOLS", "1") != "0"


def available() -> bool:
    """True when the native core is enabled (its library is then built,
    or the build raises) — the gate callers use before shaping work for
    the native fast paths."""
    return _enabled() and get_lib() is not None


def _load() -> ctypes.CDLL:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"libkmc_stream-{digest}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(".so.tmp%d" % os.getpid())
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-pthread", str(_SRC), "-o", str(tmp)]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode:
            raise RuntimeError(
                f"building the native streaming core failed:\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    isp = ctypes.POINTER(_InputSpec)
    lib.kst_op.restype = ctypes.c_int64
    lib.kst_op.argtypes = [isp, isp, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.c_uint64, ctypes.c_uint32,
                           ctypes.c_uint32, ctypes.c_uint64,
                           ctypes.c_uint64, ctypes.c_uint64,
                           ctypes.c_int64, u64p]
    lib.kst_dump.restype = ctypes.c_int64
    lib.kst_dump.argtypes = [isp, ctypes.c_char_p, ctypes.c_int32]
    lib.kst_expr.restype = ctypes.c_int64
    lib.kst_expr.argtypes = [isp, ctypes.POINTER(ctypes.c_int32),
                             ctypes.c_int32, ctypes.c_char_p,
                             ctypes.c_uint32, ctypes.c_uint64,
                             ctypes.c_uint32, ctypes.c_uint32,
                             ctypes.c_uint64, ctypes.c_uint64,
                             ctypes.c_uint64, u64p]
    lib.kst_histogram.restype = ctypes.c_int64
    lib.kst_histogram.argtypes = [isp, u64p, ctypes.c_uint64]
    lib.kst_compare.restype = ctypes.c_int32
    lib.kst_compare.argtypes = [isp, isp]
    lib.kst_set_threads.restype = None
    lib.kst_set_threads.argtypes = [ctypes.c_int32]
    lib.kst_counters_for_seq.restype = ctypes.c_int64
    lib.kst_counters_for_seq.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int32,
        u64p, u32p, ctypes.c_uint64, u64p, u32p]
    lib.kst_counters_for_seq_wide.restype = ctypes.c_int64
    lib.kst_counters_for_seq_wide.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int32,
        u8p, ctypes.c_uint32, u32p, ctypes.c_uint64, u64p, u64p, u32p]
    lib.kst_counters_for_seq_binned.restype = ctypes.c_int64
    lib.kst_counters_for_seq_binned.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int32,
        u32p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32), u64p,
        ctypes.c_uint32, u8p, ctypes.c_uint64, ctypes.c_uint32,
        u64p, ctypes.c_uint32, u32p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The native streaming core, built on first use (raises if it cannot
    be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _load()
            if _threads_pending is not None:
                lib.kst_set_threads(_threads_pending)
            _lib = lib
        return _lib


class _NativeInput:
    """An InputSpec plus the Python objects keeping its pointers alive."""

    def __init__(self, path: str, cut=(None, None)):
        ci, cx = cut
        if str(path).endswith(".kff"):
            # KFF raw sections: ordered (internally sorted) 'r' sections
            # streamed as cursors, like formats/streaming._KffSectionCursor
            # (reference: kff_db_reader.h:1226-1455)
            from ..formats.kff import read_kff_meta

            m = read_kff_meta(str(path))
            if (m.m_sections or m.max_in_block != 1 or not m.ordered):
                raise ValueError("KFF shape outside native scope")
            self.kff_meta = m
            self.sec_offsets = np.array([o for o, _ in m.sections],
                                        np.uint64)
            self.sec_counts = np.array([n for _, n in m.sections],
                                       np.uint64)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            self.spec = _InputSpec(
                suf_path=str(path).encode(),
                luts=None,
                n_sections=len(m.sections),
                lut_size=0,
                kmer_len=m.k,
                lut_prefix_len=0,
                counter_size=m.counter_size,
                ci=int(ci) if ci else 1,
                cx=int(cx) if cx is not None and cx else (1 << 64) - 1,
                format=1,
                sec_offsets=self.sec_offsets.ctypes.data_as(u64p),
                sec_counts=self.sec_counts.ctypes.data_as(u64p),
            )
            return
        self.info, luts, _ = read_pre_meta(str(path), mmap_luts=True)
        if self.info.version == KMC1_VER:
            # mmap'd KMC1 LUTs carry no trailing n_recs sentinel: load the
            # (small) LUT into RAM and append it
            lut_size = 1 << (2 * self.info.lut_prefix_len)
            arr = np.empty(lut_size + 1, np.uint64)
            arr[:lut_size] = luts[:lut_size]
            arr[lut_size] = self.info.n_unique_stored
            self.luts = arr
            n_sections = 1
        else:
            self.luts = luts
            n_sections = self.info.n_bins
        self.spec = _InputSpec(
            suf_path=(str(path) + ".kmc_suf").encode(),
            luts=self.luts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n_sections=n_sections,
            lut_size=1 << (2 * self.info.lut_prefix_len),
            kmer_len=self.info.kmer_len,
            lut_prefix_len=self.info.lut_prefix_len,
            counter_size=self.info.counter_size,
            ci=int(ci) if ci else 1,
            cx=int(cx) if cx is not None and cx else (1 << 64) - 1,
            format=0,
            sec_offsets=None,
            sec_counts=None,
        )

    @property
    def kmer_len(self) -> int:
        return int(self.spec.kmer_len)


def _eligible(path) -> bool:
    """KMC .kmc_pre/.kmc_suf databases, or ordered max=1 KFF files without
    minimizer sections (the same subset the streaming Python path covers);
    anything else stays on the Python fallbacks."""
    p = str(path)
    if p.endswith(".kff"):
        try:
            from ..formats.kff import read_kff_meta

            m = read_kff_meta(p)
            return (not m.m_sections and m.max_in_block == 1 and m.ordered)
        except (OSError, ValueError, NotImplementedError):
            return False
    try:
        with open(p + ".kmc_pre", "rb") as f:
            return f.read(4) == PRE_MARKER
    except OSError:
        return False


def _open_inputs(paths_cuts):
    if get_lib() is None or not _enabled():
        return None
    try:
        return [_NativeInput(p, cut) for p, cut in paths_cuts]
    except (OSError, ValueError, NotImplementedError):
        return None


def run_op(op: str, db1, out: str, info_out, out_params, db2=None,
           mode: str | None = None, in1_cut=(None, None),
           in2_cut=(None, None), set_value: int | None = None,
           kff_out: dict | None = None):
    """One streamed operation -> KMC1 database at `out`, or a KFF file
    when kff_out is given (dict with canonical/encoding/counter_size; the
    Python KffWriter wraps the header/index/footer around the natively
    appended raw record section — reference: kff_db_writer.h).

    info_out: the output DbInfo (kmer_len/counter_size/lut_prefix_len/
    cutoffs/both_strands already resolved by the caller — identical fields
    to the Python writers').  Returns the record count, or None when the
    native path is unavailable/ineligible (caller falls back)."""
    if not _eligible(db1) or (db2 is not None and not _eligible(db2)):
        return None
    specs = _open_inputs([(db1, in1_cut)] +
                         ([(db2, in2_cut)] if db2 is not None else []))
    if specs is None:
        return None
    lib = get_lib()
    op_code = OP_CODES["copy" if db2 is None else op]
    mode_code = MODE_CODES.get((mode or "sum").lower(), 2)
    sv = -1 if set_value is None else int(set_value)
    if kff_out is not None:
        from ..formats.kff import DEFAULT_ENCODING, KffWriter

        k = specs[0].kmer_len
        cs = int(kff_out["counter_size"])
        w = KffWriter(
            str(out),
            canonical=bool(kff_out["canonical"]),
            k=k,
            counter_size=cs,
            min_count=int(out_params.cutoff_min),
            max_count=int(out_params.cutoff_max),
            encoding=int(kff_out.get("encoding", DEFAULT_ENCODING)),
        )
        data_off = w.begin_streamed_section()
        hist = np.zeros(1, np.uint64)  # unused in KFF mode
        n = lib.kst_op(
            ctypes.byref(specs[0].spec),
            ctypes.byref(specs[1].spec) if db2 is not None else None,
            op_code, mode_code, str(out).encode(), 1, data_off,
            0, cs,
            int(out_params.cutoff_min), int(out_params.cutoff_max),
            int(out_params.counter_max), sv,
            hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        if n < 0:
            raise OSError(f"native tools op failed on {db1}")
        w.end_streamed_section(int(n), (k + 3) // 4 + cs)
        w.close()
        return int(n)
    lut_size = 1 << (2 * info_out.lut_prefix_len)
    hist = np.zeros(lut_size, np.uint64)
    n = lib.kst_op(
        ctypes.byref(specs[0].spec),
        ctypes.byref(specs[1].spec) if db2 is not None else None,
        op_code, mode_code,
        (str(out) + ".kmc_suf").encode(), 0, 0,
        info_out.lut_prefix_len,
        info_out.counter_size,
        int(out_params.cutoff_min),
        int(out_params.cutoff_max),
        int(out_params.counter_max),
        sv,
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if n < 0:
        raise OSError(f"native tools op failed on {db1}")
    from ..formats.streaming import write_kmc1_pre

    write_kmc1_pre(str(out), info_out, hist, int(n))
    return int(n)


def run_expr(leaf_paths_cuts, prog, out: str, info_out, out_params,
             kff_out: dict | None = None):
    """Single-pass complex-expression evaluation (kst_expr): the whole
    parenthesized set algebra as one pull-based merger network over the
    leaf streams — no intermediate databases (the reference's
    CInput-over-CInput trees, expression_node.h:26-196).

    leaf_paths_cuts: [(db_path, (ci, cx))] one per LEAF OCCURRENCE.
    prog: flat int32 node program, 4 per node [kind, a, b, mode]; kind 0 =
    leaf (a = leaf index), 1..4 = union/intersect/kmers_subtract/
    counters_subtract over child node ids; root last.  Returns record
    count or None (fallback)."""
    for p, _ in leaf_paths_cuts:
        if not _eligible(p):
            return None
    specs = _open_inputs(leaf_paths_cuts)
    if specs is None:
        return None
    lib = get_lib()
    spec_arr = (_InputSpec * len(specs))(*[s.spec for s in specs])
    prog_arr = (ctypes.c_int32 * len(prog))(*prog)
    if kff_out is not None:
        from ..formats.kff import DEFAULT_ENCODING, KffWriter

        k = specs[0].kmer_len
        cs = int(kff_out["counter_size"])
        w = KffWriter(
            str(out), canonical=bool(kff_out["canonical"]), k=k,
            counter_size=cs, min_count=int(out_params.cutoff_min),
            max_count=int(out_params.cutoff_max),
            encoding=int(kff_out.get("encoding", DEFAULT_ENCODING)))
        data_off = w.begin_streamed_section()
        hist = np.zeros(1, np.uint64)
        n = lib.kst_expr(
            spec_arr, prog_arr, len(prog) // 4, str(out).encode(), 1,
            data_off, 0, cs, int(out_params.cutoff_min),
            int(out_params.cutoff_max), int(out_params.counter_max),
            hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        if n < 0:
            raise OSError("native expression evaluation failed")
        w.end_streamed_section(int(n), (k + 3) // 4 + cs)
        w.close()
        return int(n)
    lut_size = 1 << (2 * info_out.lut_prefix_len)
    hist = np.zeros(lut_size, np.uint64)
    n = lib.kst_expr(
        spec_arr, prog_arr, len(prog) // 4,
        (str(out) + ".kmc_suf").encode(), 0, 0,
        info_out.lut_prefix_len, info_out.counter_size,
        int(out_params.cutoff_min), int(out_params.cutoff_max),
        int(out_params.counter_max),
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if n < 0:
        raise OSError("native expression evaluation failed")
    from ..formats.streaming import write_kmc1_pre

    write_kmc1_pre(str(out), info_out, hist, int(n))
    return int(n)


def run_dump(db, out_path: str, in_cut=(None, None),
             sorted_order: bool = True):
    """Text dump — globally sorted, or file (listing) order when
    sorted_order is False; returns record count or None (fallback)."""
    if not _eligible(db):
        return None
    specs = _open_inputs([(db, in_cut)])
    if specs is None:
        return None
    n = get_lib().kst_dump(ctypes.byref(specs[0].spec),
                           str(out_path).encode(),
                           1 if sorted_order else 0)
    if n < 0:
        raise OSError(f"native dump failed on {db}")
    return int(n)


def run_histogram(db, cutoff_max: int, in_cut=(None, None)):
    """Counter histogram as uint64[cutoff_max + 2] (last slot = clamped
    overflow), or None (fallback)."""
    if not _eligible(db):
        return None
    specs = _open_inputs([(db, in_cut)])
    if specs is None:
        return None
    hist = np.zeros(int(cutoff_max) + 2, np.uint64)
    n = get_lib().kst_histogram(
        ctypes.byref(specs[0].spec),
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(hist))
    if n < 0:
        raise OSError(f"native histogram failed on {db}")
    return hist


def build_key_index16(keys: np.ndarray) -> np.ndarray:
    """65537-entry top-16-bit range table over a sorted u64 key array —
    narrows each native lookup to a ~n/65536-record range (the in-RAM
    analogue of the prefix-LUT jump in CKMCFile::CheckKmer)."""
    tops = np.arange(1 << 16, dtype=np.uint64) << np.uint64(48)
    idx = np.empty((1 << 16) + 1, np.uint64)
    idx[:-1] = np.searchsorted(keys, tops)
    idx[-1] = len(keys)
    return idx


def counters_for_seq(seq_bytes: bytes, k: int, both_strands: bool,
                     keys: np.ndarray, counts: np.ndarray,
                     idx16: np.ndarray | None = None):
    """Counters for every k-mer window of `seq_bytes` against the in-RAM
    RA index (sorted u64 keys in the API's high-byte packing + u32
    counts); None when the native path is unavailable or k > 32."""
    if k > 32 or not _enabled():
        return None
    lib = get_lib()
    if lib is None:
        return None
    n = len(seq_bytes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint32)
    if keys.dtype != np.uint64 or counts.dtype != np.uint32:
        return None
    keys = np.ascontiguousarray(keys)
    counts = np.ascontiguousarray(counts)
    seq = np.frombuffer(seq_bytes, np.uint8)
    out = np.empty(n, np.uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    got = lib.kst_counters_for_seq(
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(seq),
        k, 1 if both_strands else 0,
        keys.ctypes.data_as(u64p),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys),
        np.ascontiguousarray(idx16).ctypes.data_as(u64p)
        if idx16 is not None else None,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if got != n:
        return None
    return out


def build_row_index16(rows: np.ndarray) -> np.ndarray:
    """65537-entry jump table over sorted (N, KB) uint8 key rows, keyed on
    the first two row bytes — the wide-key analogue of build_key_index16
    (rows are lexicographically sorted, so their leading 16 bits are too)."""
    key16 = (rows[:, 0].astype(np.uint32) << 8) | rows[:, 1]
    idx = np.empty((1 << 16) + 1, np.uint64)
    idx[:-1] = np.searchsorted(key16, np.arange(1 << 16, dtype=np.uint32))
    idx[-1] = len(rows)
    return idx


def build_row_keys0(rows: np.ndarray) -> np.ndarray:
    """Big-endian u64 of each row's first 8 bytes (native byte order for
    C) — lets the wide lookup binary-search on u64 compares."""
    return (np.ascontiguousarray(rows[:, :8]).view(">u8").ravel()
            .astype(np.uint64))


def counters_for_seq_wide(seq_bytes: bytes, k: int, both_strands: bool,
                          rows: np.ndarray, counts: np.ndarray,
                          idx16: np.ndarray | None = None,
                          keys0: np.ndarray | None = None):
    """Counters for every k-mer window of `seq_bytes` at k in (32, 256]
    against the in-RAM RA index (sorted (N, KB) big-endian byte rows of
    the API packing + u32 counts); None when the native path is
    unavailable (reference: multi-word CKmerAPI lookups through
    kmc_file.cpp:1193)."""
    if not (32 < k <= 256) or not _enabled():
        return None
    lib = get_lib()
    if lib is None:
        return None
    n = len(seq_bytes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint32)
    kb = (k + 3) // 4
    if (rows.dtype != np.uint8 or rows.ndim != 2 or rows.shape[1] != kb
            or counts.dtype != np.uint32):
        return None
    rows = np.ascontiguousarray(rows)
    counts = np.ascontiguousarray(counts)
    seq = np.frombuffer(seq_bytes, np.uint8)
    out = np.empty(n, np.uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    got = lib.kst_counters_for_seq_wide(
        seq.ctypes.data_as(u8p), len(seq), k, 1 if both_strands else 0,
        rows.ctypes.data_as(u8p), kb,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(rows),
        np.ascontiguousarray(idx16).ctypes.data_as(u64p)
        if idx16 is not None else None,
        np.ascontiguousarray(keys0).ctypes.data_as(u64p)
        if keys0 is not None else None,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if got != n:
        return None
    return out


def build_aux_luts(luts: np.ndarray, records: np.ndarray):
    """(aux, aux_bits): cumulative record boundaries extended by the top
    aux_bits of suffix byte 0 — up to 256x finer than the stored LUT,
    narrowing the binned lookup's search range to ~1 record.  aux_bits
    adapts so the table stays <= 2^24 entries (the probe pass and the
    table itself stay cheap at any lut_prefix_len).  One vectorized
    pass: the (lut_idx, top bits of suffix byte 0) key is globally
    monotone because records are (bin, prefix)-major and suffix-sorted
    within each range."""
    n = len(records)
    n_entries = len(luts) - 1
    aux_bits = 8
    while aux_bits > 1 and (n_entries << aux_bits) > (1 << 24):
        aux_bits -= 1
    luts_np = np.asarray(luts)
    counts = np.diff(luts_np).astype(np.int64)
    # u32 keys: n_entries << aux_bits is capped at 2^24, so the combined
    # key fits comfortably and the build moves half the bytes
    lut_idx = np.repeat(np.arange(n_entries, dtype=np.uint32), counts)
    lut_idx <<= np.uint32(aux_bits)
    lut_idx |= (records[:, 0] >> np.uint8(8 - aux_bits))
    # cumulative histogram of the keys == searchsorted(lut_idx, arange);
    # cumsum stays in int64 (a casting cumsum-into-uint64 is ~20x slower)
    # and reinterprets — counts are nonnegative so the bits agree
    counts_fine = np.bincount(lut_idx, minlength=n_entries << aux_bits)
    aux = np.empty((n_entries << aux_bits) + 1, np.int64)
    aux[0] = 0
    np.cumsum(counts_fine, out=aux[1:])
    return aux.view(np.uint64), aux_bits


def counters_for_seq_binned(seq_bytes: bytes, k: int, both_strands: bool,
                            *, sig_len: int, sig_map: np.ndarray,
                            luts: np.ndarray, lut_prefix_len: int,
                            records: np.ndarray, counter_size: int,
                            aux_luts: np.ndarray | None = None,
                            aux_bits: int = 8):
    """Counters for every k-mer window against the RAW KMC2 layout
    (sig_map + cumulative prefix LUTs + bin-major suffix records) — the
    reference's GetCountersForRead query shape (kmc_file.cpp:1193/1321):
    per-window signature via a sliding min of canonical m-mer norms
    (table from signatures.norm_table, identical by construction), then
    one tiny per-(bin, prefix)-range binary search.  None on fallback."""
    if not _enabled() or (sig_len and k < sig_len) or k < 2 or k > 256:
        return None
    lib = get_lib()
    if lib is None:
        return None
    n = len(seq_bytes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint32)
    if sig_len:
        from ..signatures import norm_table

        norms = norm_table(sig_len)  # cached u32[4^m]
    else:  # KMC1: prefix-only LUT, no signature routing
        norms = np.zeros(1, np.uint32)
    sig_map = np.ascontiguousarray(sig_map, np.int32)
    luts = np.ascontiguousarray(luts, np.uint64)
    if records.dtype != np.uint8 or records.ndim != 2:
        return None
    rb = records.shape[1]
    if rb != (k - lut_prefix_len) // 4 + counter_size:
        return None
    records = np.ascontiguousarray(records)
    seq = np.frombuffer(seq_bytes, np.uint8)
    out = np.empty(n, np.uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    got = lib.kst_counters_for_seq_binned(
        seq.ctypes.data_as(u8p), len(seq), k, 1 if both_strands else 0,
        norms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), sig_len,
        sig_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        luts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lut_prefix_len, records.ctypes.data_as(u8p), len(records),
        counter_size,
        aux_luts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        if aux_luts is not None else None, aux_bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if got != n:
        return None
    return out


def run_compare(db1, db2):
    """Record-level equality; True/False, or None (fallback)."""
    if not _eligible(db1) or not _eligible(db2):
        return None
    specs = _open_inputs([(db1, (None, None)), (db2, (None, None))])
    if specs is None:
        return None
    if specs[0].kmer_len != specs[1].kmer_len:
        return False
    r = get_lib().kst_compare(ctypes.byref(specs[0].spec),
                              ctypes.byref(specs[1].spec))
    if r < 0:
        raise OSError("native compare failed")
    return bool(r)
