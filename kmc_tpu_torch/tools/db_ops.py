"""Database algebra: kmc_tools equivalents on sorted record arrays (the
port's copy of kmc_tpu/tools/db_ops.py).

Reimplements KMC's sorted-stream merge operations
(kmc_tools/operations.h) as vectorized NumPy over whole record arrays, or
through the native streaming core (tools/native_tools.py) and the
streaming merges (formats/streaming.py); these ops are I/O-bound host
code and load no torch.  Counter combination modes follow CounterOpType semantics
(operations.h:36-61): MIN/MAX/SUM/DIFF/FROM_DB1/FROM_DB2, with DIFF
dropping k-mers whose first counter does not exceed the second.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..defs import byte_log
from ..formats.kmc_db import (
    DbInfo,
    KMC2_VER,
    read_db,
    sorted_records,
    write_kmc1_db,
)


def load_sorted(path_prefix: str):
    """(info, kmers (N,KB) uint8, counts uint32) in global k-mer order.

    Accepts KMC databases (path prefix of .kmc_pre/.kmc_suf) or KFF files
    (path ending in .kff), like the reference's db_reader_factory
    (kmc_tools/db_reader_factory.h)."""
    if str(path_prefix).endswith(".kff"):
        from ..formats.kff import read_kff

        kf = read_kff(str(path_prefix))
        order = _lexsort_rows(kf.kmers)
        info = DbInfo(
            kmer_len=kf.k,
            counter_size=kf.counter_size,
            lut_prefix_len=0,
            cutoff_min=kf.min_count,
            cutoff_max=kf.max_count,
            both_strands=kf.canonical,
            n_unique_stored=len(kf.kmers),
            encoding=kf.encoding,
        )
        return info, kf.kmers[order], kf.counts[order]
    db = read_db(path_prefix)
    kmers, counts = sorted_records(db)
    return db.info, kmers, counts


def _lexsort_rows(kmers: np.ndarray) -> np.ndarray:
    return np.lexsort(tuple(kmers[:, j] for j in range(kmers.shape[1] - 1, -1, -1)))


def _row_equal_prev(kmers: np.ndarray) -> np.ndarray:
    eq = np.ones(len(kmers), dtype=bool)
    eq[0] = False
    eq[1:] = (kmers[1:] == kmers[:-1]).all(axis=1)
    return eq


@dataclass
class OutputParams:
    """Output database parameters (kmc_tools per-output -ci/-cx/-cs)."""

    cutoff_min: int = 1
    cutoff_max: int = 1_000_000_000
    counter_max: int = 255

    def apply(self, kmers, counts):
        counts = np.asarray(counts, dtype=np.uint64)
        keep = (counts >= self.cutoff_min) & (counts <= self.cutoff_max)
        return kmers[keep], np.minimum(counts[keep], self.counter_max).astype(np.uint32)


def _aligned_merge(k1, c1, k2, c2):
    """Align two sorted unique record sets on the union of k-mers.

    Returns (kmers, a1, a2, in1, in2): counters aligned to the merged key
    set, with membership masks."""
    n1, n2 = len(k1), len(k2)
    if k1.shape[1] != k2.shape[1]:
        raise ValueError("k-mer length mismatch between databases")
    if n1 + n2 == 0:
        kb = k1.shape[1]
        z = np.zeros(0)
        return np.zeros((0, kb), np.uint8), z.astype(np.uint64), z.astype(np.uint64), z.astype(bool), z.astype(bool)
    allk = np.concatenate([k1, k2])
    src = np.concatenate([np.zeros(n1, np.int8), np.ones(n2, np.int8)])
    cnt = np.concatenate([c1.astype(np.uint64), c2.astype(np.uint64)])
    order = _lexsort_rows(allk)
    allk, src, cnt = allk[order], src[order], cnt[order]
    dup = _row_equal_prev(allk)
    # rows come from unique sets, so a group is 1 or 2 rows (db1 sorts first
    # only by stable lexsort order — rely on masks instead)
    heads = ~dup
    gid = np.cumsum(heads) - 1
    n_groups = int(gid[-1]) + 1 if len(gid) else 0
    a1 = np.zeros(n_groups, np.uint64)
    a2 = np.zeros(n_groups, np.uint64)
    in1 = np.zeros(n_groups, bool)
    in2 = np.zeros(n_groups, bool)
    m1 = src == 0
    a1[gid[m1]] = cnt[m1]
    in1[gid[m1]] = True
    a2[gid[~m1]] = cnt[~m1]
    in2[gid[~m1]] = True
    return allk[heads], a1, a2, in1, in2


def _combine(a1, a2, mode: str):
    mode = mode.lower()
    if mode == "min":
        return np.minimum(a1, a2)
    if mode == "max":
        return np.maximum(a1, a2)
    if mode == "sum":
        return a1 + a2
    if mode == "diff":
        return np.where(a1 > a2, a1 - a2, 0)
    if mode in ("left", "from_db1"):
        return a1
    if mode in ("right", "from_db2"):
        return a2
    raise ValueError(f"unknown counter mode {mode}")


def _eval_aligned(aligned, op: str, mode: str | None):
    """One simple-set operation over already-aligned merge artifacts —
    lets a multi-output invocation share a single merge pass (the
    reference computes every output of one `simple` run from one
    streamed merge)."""
    kk, a1, a2, in1, in2 = aligned
    if op.startswith("reverse_"):
        return _eval_aligned((kk, a2, a1, in2, in1), op[len("reverse_"):],
                             mode)
    both = in1 & in2
    if op == "union":
        counts = np.where(both, _combine(a1, a2, mode or "sum"),
                          np.where(in1, a1, a2))
        keep = counts > 0
    elif op == "intersect":
        counts = _combine(a1, a2, mode or "min")
        keep = both & (counts > 0)
    elif op == "kmers_subtract":
        counts = a1
        keep = in1 & ~in2
    elif op == "counters_subtract":
        counts = np.where(both, _combine(a1, a2, mode or "diff"), a1)
        keep = in1 & (counts > 0)
    else:
        raise ValueError(op)
    return kk[keep], counts[keep]


def op_union(k1, c1, k2, c2, mode: str = "sum"):
    return _eval_aligned(_aligned_merge(k1, c1, k2, c2), "union", mode)


def op_intersect(k1, c1, k2, c2, mode: str = "min"):
    return _eval_aligned(_aligned_merge(k1, c1, k2, c2), "intersect", mode)


def op_kmers_subtract(k1, c1, k2, c2):
    return _eval_aligned(_aligned_merge(k1, c1, k2, c2), "kmers_subtract",
                         None)


def op_counters_subtract(k1, c1, k2, c2, mode: str = "diff"):
    return _eval_aligned(_aligned_merge(k1, c1, k2, c2),
                         "counters_subtract", mode)


SIMPLE_OPS = {
    "union": op_union,
    "intersect": op_intersect,
    "kmers_subtract": op_kmers_subtract,
    "counters_subtract": op_counters_subtract,
    "reverse_kmers_subtract": lambda k1, c1, k2, c2: op_kmers_subtract(k2, c2, k1, c1),
    "reverse_counters_subtract": lambda k1, c1, k2, c2, mode="diff": op_counters_subtract(
        k2, c2, k1, c1, mode
    ),
}

DEFAULT_COUNTER_MODE = {
    # reference defaults, kmc_tools/config.h:99-108
    "union": "sum",
    "intersect": "min",
    "counters_subtract": "diff",
    "reverse_counters_subtract": "diff",
}


# above this many combined input records the 2-arg set ops stream in
# bounded memory instead of materializing (formats/streaming.py); override
# with KMC_TPU_STREAM_THRESHOLD (0 forces streaming everywhere)
STREAM_THRESHOLD = 1 << 24


def _stream_threshold() -> int:
    import os

    v = os.environ.get("KMC_TPU_STREAM_THRESHOLD")
    return int(v) if v is not None else STREAM_THRESHOLD


DEFAULT_ENCODING = 0b00011011


def _input_encoding(path: str) -> int:
    """Encoding byte of an input database from its header alone (KMC
    databases are always the default; KFF files carry theirs,
    kmer_file_header.h:66-74)."""
    if str(path).endswith(".kff"):
        from ..formats.kff import read_kff_meta

        return read_kff_meta(str(path)).encoding
    return DEFAULT_ENCODING


def _check_encodings(paths) -> int:
    """The reference rejects input sets with differing k-mer encodings
    (parameters_parser.cpp:778-784).  Returns the common encoding."""
    encs = [_input_encoding(p) for p in paths]
    if len(set(encs)) > 1:
        raise ValueError("different k-mers encodings across input databases")
    return encs[0]


def _header_params(path: str):
    """(min_count, max_count, counter_size) from the database header —
    the reference defaults unset input -ci/-cx from these and sizes the
    default output counter_max from the widest input counter
    (parameters_parser.cpp:842-848, 738-749)."""
    if str(path).endswith(".kff"):
        from ..formats.kff import read_kff_meta

        m = read_kff_meta(str(path))
        return m.min_count, m.max_count, m.counter_size
    from ..formats.kmc_db import read_pre_meta

    info = read_pre_meta(str(path))[0]
    return info.cutoff_min, info.cutoff_max, info.counter_size


def effective_input_cut(path: str, cut=None):
    """Resolve a per-input (-ci, -cx) pair: None (or 0, the reference's
    'not set' sentinel) falls back to the input header's min/max count."""
    ci, cx = cut if cut is not None else (None, None)
    h_ci, h_cx, _ = _header_params(path)
    return (h_ci if not ci else ci, h_cx if not cx else cx)


def default_output_params(paths, eff_cuts, overrides=None) -> OutputParams:
    """Reference output-parameter defaulting (parameters_parser.cpp:
    851-892): unset -ci = min effective input ci, unset -cx = max
    effective input cx, unset -cs = the max value the widest input
    counter can hold.  `overrides` holds explicitly-given values under
    keys ci/cx/cs (0 counts as unset, like the reference)."""
    overrides = overrides or {}
    cs_max = max(_header_params(p)[2] for p in paths)
    return OutputParams(
        cutoff_min=overrides.get("ci") or min(c for c, _ in eff_cuts),
        cutoff_max=overrides.get("cx") or max(x for _, x in eff_cuts),
        counter_max=overrides.get("cs")
        or ((1 << (8 * cs_max)) - 1 if cs_max else 1),
    )


def _apply_input_cut(kmers, counts, cut):
    """Read-time input filtering (the reference applies the per-input
    ci/cx inside the db readers, kmc1_db_reader.h:574-618)."""
    ci, cx = cut
    keep = (counts.astype(np.uint64) >= ci) & (counts.astype(np.uint64) <= cx)
    if keep.all():
        return kmers, counts
    return kmers[keep], counts[keep]


def _resolve_out_params(out_params, paths, eff_cuts) -> OutputParams:
    """out_params: OutputParams = use verbatim (legacy API); dict of
    explicit overrides or None = reference defaulting from the inputs."""
    if isinstance(out_params, OutputParams):
        return out_params
    return default_output_params(paths, eff_cuts, out_params)


def _stored_count(path: str) -> int:
    try:
        if str(path).endswith(".kff"):
            from ..formats.kff import read_kff_meta

            return sum(n for _, n in read_kff_meta(str(path)).sections)
        from ..formats.kmc_db import read_pre_meta

        return read_pre_meta(str(path))[0].n_unique_stored
    except Exception:
        return 0


def _simple_out_info(op_params: OutputParams, k: int, both_strands: bool,
                     input_ns) -> DbInfo:
    """Output DbInfo for a streamed 2-input set op (the reference sizes the
    LUT from the INPUT headers — it streams, so the output count is unknown
    upfront)."""
    return DbInfo(
        kmer_len=k,
        counter_size=tools_counter_size(op_params.cutoff_max,
                                        op_params.counter_max),
        lut_prefix_len=tools_lut_prefix_len(k, input_ns),
        cutoff_min=op_params.cutoff_min,
        cutoff_max=op_params.cutoff_max,
        both_strands=both_strands,
        version=0,
    )


def _native_simple(op, db1, db2, out, mode, op_params, eff1, eff2,
                   encoding=DEFAULT_ENCODING):
    """Native streamed set op; None when ineligible (caller falls back)."""
    from . import native_tools

    if op.startswith("reverse_"):
        op, db1, db2, eff1, eff2 = op[len("reverse_"):], db2, db1, eff2, eff1
    try:
        info1 = read_any_header_info(db1)
        info2 = read_any_header_info(db2)
    except (OSError, ValueError, NotImplementedError):
        return None
    if info1 is None or info2 is None:
        return None
    if info1.kmer_len != info2.kmer_len:
        raise ValueError(
            f"k-mer length mismatch: {info1.kmer_len} vs {info2.kmer_len}")
    if encoding != DEFAULT_ENCODING and not str(out).endswith(".kff"):
        return None  # Python path handles the forced-KFF rename + warning
    info_out = _simple_out_info(
        op_params, info1.kmer_len, info1.both_strands,
        [info1.n_unique_stored, info2.n_unique_stored])
    return native_tools.run_op(
        op, db1, out, info_out, op_params, db2=db2,
        mode=mode or DEFAULT_COUNTER_MODE.get(op, "sum"),
        in1_cut=eff1, in2_cut=eff2,
        kff_out=_native_kff_out(out, encoding, info1.both_strands,
                                op_params))


def read_db_header_info(path):
    """DbInfo from a .kmc_pre header alone; None for KFF inputs."""
    if str(path).endswith(".kff"):
        return None
    from ..formats.kmc_db import read_pre_meta

    return read_pre_meta(str(path))[0]


def read_any_header_info(path):
    """Header-only DbInfo for a KMC database OR a KFF file (section table
    walked, payload untouched) — the metadata the native streamed paths
    need (db_reader_factory.h analogue)."""
    if not str(path).endswith(".kff"):
        return read_db_header_info(path)
    from ..formats.kff import read_kff_meta

    m = read_kff_meta(str(path))
    return DbInfo(
        kmer_len=m.k,
        counter_size=m.counter_size,
        lut_prefix_len=0,
        cutoff_min=m.min_count,
        cutoff_max=m.max_count,
        both_strands=m.canonical,
        n_unique_stored=sum(n for _, n in m.sections),
        encoding=m.encoding,
    )


def _native_kff_out(out, encoding, both_strands, op_params,
                    counter_value=None):
    """kff_out dict for native_tools.run_op when `out` is .kff, else
    None."""
    if not str(out).endswith(".kff"):
        return None
    return dict(
        canonical=both_strands,
        encoding=encoding,
        counter_size=tools_counter_size(op_params.cutoff_max,
                                        op_params.counter_max,
                                        counter_value, kff=True),
    )


def run_simple_op(op: str, db1: str, db2: str, out: str, mode: str | None = None,
                  out_params: OutputParams | dict | None = None,
                  in1_cut=None, in2_cut=None):
    """2-database set operation.  in1_cut/in2_cut: per-input (-ci, -cx)
    pairs applied at read time; out_params: an OutputParams (used
    verbatim) or a dict of explicit -ci/-cx/-cs overrides completed by
    the reference's input-derived defaulting (default_output_params)."""
    eff1 = effective_input_cut(db1, in1_cut)
    eff2 = effective_input_cut(db2, in2_cut)
    encoding = _check_encodings([db1, db2])
    out_params = _resolve_out_params(out_params, [db1, db2], [eff1, eff2])
    n = _native_simple(op, db1, db2, out, mode, out_params, eff1, eff2,
                       encoding=encoding)
    if n is not None:
        return n
    if (not str(out).endswith(".kff") and encoding == DEFAULT_ENCODING
            and _stored_count(db1) + _stored_count(db2) > _stream_threshold()):
        from ..formats.streaming import stream_simple_op

        try:
            return stream_simple_op(op, db1, db2, out, mode=mode,
                                    out_params=out_params,
                                    in1_cut=eff1, in2_cut=eff2)
        except NotImplementedError:
            pass  # e.g. unsorted KFF input: materialize instead
    info1, k1, c1 = load_sorted(db1)
    info2, k2, c2 = load_sorted(db2)
    if info1.kmer_len != info2.kmer_len:
        raise ValueError(
            f"k-mer length mismatch: {info1.kmer_len} vs {info2.kmer_len}"
        )
    k1, c1 = _apply_input_cut(k1, c1, eff1)
    k2, c2 = _apply_input_cut(k2, c2, eff2)
    fn = SIMPLE_OPS[op]
    if op in DEFAULT_COUNTER_MODE:
        kmers, counts = fn(k1, c1, k2, c2, mode or DEFAULT_COUNTER_MODE[op])
    else:
        kmers, counts = fn(k1, c1, k2, c2)
    kmers, counts = out_params.apply(kmers, counts)
    write_sorted_db(out, info1.kmer_len, kmers, counts, out_params,
                    both_strands=info1.both_strands,
                    input_ns=[info1.n_unique_stored, info2.n_unique_stored],
                    encoding=encoding)
    return len(kmers)


def run_simple_ops(db1: str, db2: str, ops, in1_cut=None, in2_cut=None):
    """Every output of one `kmc_tools simple` invocation from a SINGLE
    load + aligned merge of the two inputs (the reference streams all
    simple outputs off one merge pass, kmc_tools.cpp/bundle.h).
    ops: [(op, mode|None, out_path, overrides_dict|OutputParams)].
    Falls back to per-op streaming above the memory threshold."""
    from . import native_tools

    if (native_tools.get_lib() is not None and native_tools._enabled()
            and native_tools._eligible(db1) and native_tools._eligible(db2)):
        # the native streamed passes are fast enough that per-op passes
        # beat one shared in-memory merge; run_simple_op delegates each
        # (KFF outputs included: the native core appends the raw record
        # section, the Python KffWriter wraps it)
        for op, mode, out, params in ops:
            run_simple_op(op, db1, db2, out, mode, params,
                          in1_cut=in1_cut, in2_cut=in2_cut)
        return
    if (_stored_count(db1) + _stored_count(db2) > _stream_threshold()
            or any(str(o[2]).endswith(".kff") for o in ops)):
        for op, mode, out, params in ops:
            run_simple_op(op, db1, db2, out, mode, params,
                          in1_cut=in1_cut, in2_cut=in2_cut)
        return
    eff1 = effective_input_cut(db1, in1_cut)
    eff2 = effective_input_cut(db2, in2_cut)
    encoding = _check_encodings([db1, db2])
    info1, k1, c1 = load_sorted(db1)
    info2, k2, c2 = load_sorted(db2)
    if info1.kmer_len != info2.kmer_len:
        raise ValueError(
            f"k-mer length mismatch: {info1.kmer_len} vs {info2.kmer_len}")
    k1, c1 = _apply_input_cut(k1, c1, eff1)
    k2, c2 = _apply_input_cut(k2, c2, eff2)
    aligned = _aligned_merge(k1, c1, k2, c2)
    for op, mode, out, params in ops:
        out_params = _resolve_out_params(params, [db1, db2], [eff1, eff2])
        kmers, counts = _eval_aligned(
            aligned, op, mode or DEFAULT_COUNTER_MODE.get(op))
        kmers, counts = out_params.apply(kmers, counts)
        write_sorted_db(out, info1.kmer_len, kmers, counts, out_params,
                        both_strands=info1.both_strands,
                        input_ns=[info1.n_unique_stored,
                                  info2.n_unique_stored],
                        encoding=encoding)


def tools_counter_size(cutoff_max: int, counter_max: int,
                       counter_value: int | None = None,
                       kff: bool = False) -> int:
    """Counter byte width of a kmc_tools OUTPUT database.

    The tools writers size counters as MIN(BYTE_LOG(counter_max),
    BYTE_LOG(cutoff_max)) — always >= 1, unlike the counting engine's
    calc_counter_size where counter_max == 1 stores no counter bytes
    (kmc_tools/kmc1_db_writer.h:154-156, kff_db_writer.h:74 vs
    kmc_core/defs.h:154-159).  set_counts overrides with
    BYTE_LOG(counter_value) for KMC1 outputs only (the KFF writer has no
    counter_value special case).  BYTE_LOG caps at 4 bytes
    (kmc_tools/defs.h:29)."""
    def blog(x: int) -> int:
        return min(byte_log(max(int(x), 0)), 4)

    if counter_value and not kff:
        return blog(counter_value)
    return min(blog(counter_max), blog(cutoff_max))


def tools_lut_prefix_len(k: int, input_ns) -> int:
    """The reference's output-LUT split: per input database, the best
    LUT-vs-suffix tradeoff for THAT input's record count; the output takes
    the maximum (CKMC1DbWriter::calc_lut_prefix_len,
    kmc_tools/kmc1_db_writer.h:425-456)."""
    bests = []
    for n in input_ns:
        best, best_mem = 0, 1 << 62
        for lpl in range(1, 16):
            if lpl > k:
                break
            suffix_len = k - lpl
            if suffix_len % 4:
                continue
            mem = n * suffix_len // 4 + (1 << (2 * lpl)) * 8
            if mem < best_mem:
                best, best_mem = lpl, mem
        bests.append(best)
    return max(bests) if bests else 0


def write_sorted_db(path_prefix: str, k: int, kmers, counts,
                    out_params: OutputParams, both_strands: bool = True,
                    input_ns=None, encoding: int = DEFAULT_ENCODING,
                    counter_value: int | None = None):
    """Write globally sorted records as a KMC1 database (what kmc_tools
    produces for transform/simple outputs, kmc1_db_writer.h:55), or as a KFF
    file when the output path ends in .kff (reference -o kff option).

    input_ns: record counts of the INPUT databases — the reference sizes
    the output LUT from those headers (it streams, so the output count is
    unknown upfront); omitted -> sized from the actual output.

    encoding: the inputs' common symbol encoding.  The KMC format only
    supports the default A->0 C->1 G->2 T->3; for any other encoding the
    KFF format is enforced for the output, with a warning — exactly the
    reference's behavior (parameters_parser.cpp:796-838).

    counter_value: set_counts' fixed counter (sizes KMC1 counters as
    BYTE_LOG(value), kmc_tools/kmc1_db_writer.h:155-156)."""
    if encoding != DEFAULT_ENCODING and not str(path_prefix).endswith(".kff"):
        import sys

        print("Warning: only A -> 0, C -> 1, G -> 2, T -> 3 encoding is "
              "supported by KMC format. Because different encoding was used "
              "for input database(s) KKF file format is enforced for each "
              "output", file=sys.stderr)
        path_prefix = str(path_prefix) + ".kff"
    counter_size = tools_counter_size(
        out_params.cutoff_max, out_params.counter_max, counter_value,
        kff=str(path_prefix).endswith(".kff"))
    if str(path_prefix).endswith(".kff"):
        from ..formats.kff import KffWriter

        w = KffWriter(
            str(path_prefix),
            canonical=both_strands,
            k=k,
            counter_size=counter_size,
            min_count=out_params.cutoff_min,
            max_count=out_params.cutoff_max,
            encoding=encoding,
        )
        w.store_section(np.asarray(kmers), np.asarray(counts, np.uint32))
        w.close()
        return
    if input_ns is not None:
        lut_prefix_len = tools_lut_prefix_len(k, input_ns)
    else:
        lut_prefix_len = _pick_kmc1_lut_len(k, len(kmers))
    info = DbInfo(
        kmer_len=k,
        counter_size=counter_size,
        lut_prefix_len=lut_prefix_len,
        cutoff_min=out_params.cutoff_min,
        cutoff_max=out_params.cutoff_max,
        both_strands=both_strands,
        version=0,
    )
    write_kmc1_db(path_prefix, info, kmers, np.asarray(counts, np.uint32))


def _pick_kmc1_lut_len(k: int, n: int) -> int:
    from ..formats.kmc_db import pick_lut_prefix_len

    return pick_lut_prefix_len(k, 1, n, kmc1=True)


# ---------------- transforms ----------------

def _stream_single(db, out) -> bool:
    return (not str(out).endswith(".kff") and not str(db).endswith(".kff")
            and _stored_count(db) > _stream_threshold())


def _native_transform(db, out, p: OutputParams, eff, *,
                      set_value: int | None = None):
    """Native streamed single-input transform; None when ineligible."""
    from . import native_tools

    try:
        info = read_any_header_info(db)
    except (OSError, ValueError, NotImplementedError):
        return None
    if info is None:
        return None
    encoding = getattr(info, "encoding", DEFAULT_ENCODING)
    if encoding != DEFAULT_ENCODING and not str(out).endswith(".kff"):
        return None  # Python path handles the forced-KFF rename + warning
    info_out = DbInfo(
        kmer_len=info.kmer_len,
        counter_size=tools_counter_size(p.cutoff_max, p.counter_max,
                                        counter_value=set_value),
        lut_prefix_len=tools_lut_prefix_len(info.kmer_len,
                                            [info.n_unique_stored]),
        cutoff_min=p.cutoff_min,
        cutoff_max=p.cutoff_max,
        both_strands=info.both_strands,
        version=0,
    )
    return native_tools.run_op(
        "copy", db, out, info_out, p, in1_cut=eff, set_value=set_value,
        kff_out=_native_kff_out(out, encoding, info.both_strands, p,
                                counter_value=set_value))


def transform_sort(db: str, out: str,
                   out_params: OutputParams | dict | None = None,
                   in_cut=None):
    eff = effective_input_cut(db, in_cut)
    p = _resolve_out_params(out_params, [db], [eff])
    if _native_transform(db, out, p, eff) is not None:
        return
    if _stream_single(db, out):
        from ..formats.streaming import stream_transform

        stream_transform(db, out, p, in_cut=eff)
        return
    info, kmers, counts = load_sorted(db)
    kmers, counts = _apply_input_cut(kmers, counts, eff)
    kmers, counts = p.apply(kmers, counts)
    write_sorted_db(out, info.kmer_len, kmers, counts, p, info.both_strands,
                    input_ns=[info.n_unique_stored], encoding=info.encoding)


def transform_reduce(db: str, out: str, out_params: OutputParams | dict,
                     in_cut=None):
    transform_sort(db, out, out_params, in_cut=in_cut)


def _compact_params(db, out_params, eff) -> OutputParams:
    """compact = reduce with counter_max forced to 1: output ci/cx still
    default from the input (or explicit -ci/-cx overrides), the filter runs
    on the ORIGINAL counters, and every stored counter is clamped to 1
    (parameters_parser.cpp:437-441 + kmc1_db_writer.h add_kmer)."""
    if isinstance(out_params, OutputParams):
        p = out_params
    else:
        ov = dict(out_params or {})
        ov.pop("cs", None)  # -cs ignored for compact (with a CLI warning)
        p = default_output_params([db], [eff], ov)
    return OutputParams(cutoff_min=p.cutoff_min, cutoff_max=p.cutoff_max,
                        counter_max=1)


# set_counts output header fields (parameters_parser.cpp:443-450)
_SET_COUNTS_LIMIT = 0xFFFFFFFF


def transform_compact(db: str, out: str,
                      out_params: OutputParams | dict | None = None,
                      in_cut=None):
    eff = effective_input_cut(db, in_cut)
    p = _compact_params(db, out_params, eff)
    if _native_transform(db, out, p, eff) is not None:
        return
    if _stream_single(db, out):
        from ..formats.streaming import stream_transform

        stream_transform(db, out, p, compact=True, in_cut=eff)
        return
    info, kmers, counts = load_sorted(db)
    kmers, counts = _apply_input_cut(kmers, counts, eff)
    kmers, counts = p.apply(kmers, counts)
    write_sorted_db(out, info.kmer_len, kmers, counts, p, info.both_strands,
                    input_ns=[info.n_unique_stored], encoding=info.encoding)


def transform_set_counts(db: str, out: str, value: int, in_cut=None):
    eff = effective_input_cut(db, in_cut)
    p = OutputParams(cutoff_min=1, cutoff_max=_SET_COUNTS_LIMIT,
                     counter_max=_SET_COUNTS_LIMIT)
    if _native_transform(db, out, p, eff, set_value=value) is not None:
        return
    if _stream_single(db, out):
        from ..formats.streaming import stream_transform

        stream_transform(db, out, p, set_value=value, in_cut=eff)
        return
    info, kmers, counts = load_sorted(db)
    kmers, counts = _apply_input_cut(kmers, counts, eff)
    counts = np.full(len(kmers), value, np.uint32)
    write_sorted_db(out, info.kmer_len, kmers, counts, p, info.both_strands,
                    input_ns=[info.n_unique_stored], encoding=info.encoding,
                    counter_value=value)


def transform_histogram(db: str, out_path: str, cutoff_min: int | None = None,
                        cutoff_max: int | None = None, in_cut=None) -> None:
    """Histogram of counter values (histogram_writer.h:20-84):
    lines `value\\tnumber_of_kmers_with_that_counter`.  Unset bounds mirror
    the reference defaulting (parameters_parser.cpp:869-889): lower = the
    effective input ci, upper = min(db max_count, 10000, largest value a
    counter byte can hold)."""
    eff = effective_input_cut(db, in_cut)
    if cutoff_min is None:
        cutoff_min = eff[0]
    # native counters-only scan (KMC and KFF inputs)
    from . import native_tools

    try:
        info = read_any_header_info(db)
    except (OSError, ValueError, NotImplementedError):
        info = None
    if info is not None:
        hi = cutoff_max
        if hi is None:
            hi = min(info.cutoff_max, 10000)
            if info.counter_size:
                hi = min(hi, (1 << (8 * info.counter_size)) - 1)
        hist = native_tools.run_histogram(db, hi, in_cut=eff)
        if hist is not None:
            with open(out_path, "w") as f:
                for v in range(cutoff_min, hi + 1):
                    f.write(f"{v}\t{hist[v]}\n")
            return
    if _stream_single(db, out_path):
        from ..formats.streaming import stream_histogram

        stream_histogram(db, out_path, cutoff_min, cutoff_max, in_cut=eff)
        return
    info, _, counts = load_sorted(db)
    counts = counts[(counts.astype(np.uint64) >= eff[0])
                    & (counts.astype(np.uint64) <= eff[1])]
    if cutoff_max is None:
        cutoff_max = min(info.cutoff_max, 10000)
        if info.counter_size:
            cutoff_max = min(cutoff_max, (1 << (8 * info.counter_size)) - 1)
    hist = np.bincount(counts.astype(np.int64), minlength=cutoff_max + 1)
    with open(out_path, "w") as f:
        for v in range(cutoff_min, cutoff_max + 1):
            f.write(f"{v}\t{hist[v] if v < len(hist) else 0}\n")


def transform_dump(db: str, out_path: str, sorted_output: bool = True,
                   in_cut=None):
    explicit_cut = in_cut is not None and any(v for v in in_cut)
    try:
        hdr = read_any_header_info(db)
    except (OSError, ValueError, NotImplementedError):
        hdr = None
    # the dump's ACGT text depends on the file's symbol encoding: the
    # native dump prints default-encoding symbols only
    if (hdr is not None
            and getattr(hdr, "encoding", DEFAULT_ENCODING)
            == DEFAULT_ENCODING):
        from . import native_tools

        eff = (effective_input_cut(db, in_cut) if explicit_cut
               else (None, None))
        # without -s a KMC2 database dumps in file (bin) order, the
        # reference's sequential open mode (kmc_tools.cpp:83-92); KFF
        # inputs always dump through the sorted merge (matching the
        # load_sorted fallback)
        sorted_order = (sorted_output or hdr.version == 0
                        or str(db).endswith(".kff"))
        if native_tools.run_dump(db, str(out_path), in_cut=eff,
                                 sorted_order=sorted_order) is not None:
            return
    if sorted_output and not str(db).endswith(".kff") \
            and _stored_count(db) > _stream_threshold():
        from ..formats.streaming import stream_dump

        stream_dump(db, str(out_path),
                    in_cut=effective_input_cut(db, in_cut)
                    if explicit_cut else (None, None))
        return
    if explicit_cut or str(db).endswith(".kff"):
        # KFF inputs go through load_sorted (db_reader_factory analogue);
        # dump_db_file only understands .kmc_pre/.kmc_suf layouts
        from ..formats.dump import dump_records

        info, kmers, counts = load_sorted(db)
        if explicit_cut:
            kmers, counts = _apply_input_cut(
                kmers, counts, effective_input_cut(db, in_cut))
        with open(out_path, "w") as f:
            f.write(dump_records(kmers, counts, info.kmer_len,
                                 encoding=info.encoding))
        return
    from ..formats.dump import dump_db_file

    dump_db_file(db, out_path, sorted_output)


def run_transform_ops(db: str, ops, in_cut=None):
    """Every output of one `kmc_tools transform` invocation from a SINGLE
    load of the input database (the reference streams all transform
    outputs off one DB pass, kmc_tools.cpp:449-470).  ops: list of
    ("sort"|"reduce", out, overrides), ("compact", out),
    ("set_counts", out, value), ("histogram", out, lo, hi),
    ("dump", out, sorted_output).  Above the streaming threshold — or when
    the native streamed passes are available (each pass is a fast C
    pread-merge) — each op dispatches to its own function instead."""
    from . import native_tools

    native_ok = (native_tools.get_lib() is not None
                 and native_tools._enabled()
                 and native_tools._eligible(db))
    if native_ok or _stored_count(db) > _stream_threshold():
        for op in ops:
            if op[0] in ("sort", "reduce"):
                (transform_sort if op[0] == "sort" else transform_reduce)(
                    db, op[1], op[2], in_cut=in_cut)
            elif op[0] == "compact":
                transform_compact(db, op[1],
                                  op[2] if len(op) > 2 else None,
                                  in_cut=in_cut)
            elif op[0] == "set_counts":
                transform_set_counts(db, op[1], op[2], in_cut=in_cut)
            elif op[0] == "histogram":
                transform_histogram(db, op[1], op[2], op[3], in_cut=in_cut)
            else:
                transform_dump(db, op[1], op[2], in_cut=in_cut)
        return
    from ..formats.dump import dump_records

    eff = effective_input_cut(db, in_cut)
    info, kmers0, counts0 = load_sorted(db)
    kmers0, counts0 = _apply_input_cut(kmers0, counts0, eff)
    for op in ops:
        kind = op[0]
        if kind in ("sort", "reduce", "compact", "set_counts"):
            out = op[1]
            counter_value = None
            if kind in ("sort", "reduce"):
                p = _resolve_out_params(op[2], [db], [eff])
                kmers, counts = p.apply(kmers0, counts0)
            elif kind == "compact":
                p = _compact_params(db, op[2] if len(op) > 2 else None, eff)
                kmers, counts = p.apply(kmers0, counts0)
            else:
                value = op[2]
                p = OutputParams(cutoff_min=1, cutoff_max=_SET_COUNTS_LIMIT,
                                 counter_max=_SET_COUNTS_LIMIT)
                kmers = kmers0
                counts = np.full(len(kmers0), value, np.uint32)
                counter_value = value
            write_sorted_db(out, info.kmer_len, kmers, counts, p,
                            info.both_strands,
                            input_ns=[info.n_unique_stored],
                            encoding=info.encoding,
                            counter_value=counter_value)
        elif kind == "histogram":
            _, out, lo, hi = op
            if lo is None:
                lo = eff[0]
            if hi is None:
                hi = min(info.cutoff_max, 10000)
                if info.counter_size:
                    hi = min(hi, (1 << (8 * info.counter_size)) - 1)
            hist = np.bincount(counts0.astype(np.int64), minlength=hi + 1)
            with open(out, "w") as f:
                for v in range(lo, hi + 1):
                    f.write(f"{v}\t{hist[v] if v < len(hist) else 0}\n")
        else:  # dump
            _, out, _sorted = op
            if not _sorted and info.version == KMC2_VER \
                    and not str(db).endswith(".kff"):
                # without -s a KMC2 input dumps in FILE (bin) order — the
                # reference's sequential open mode emits k-mers "not
                # sorted!" (kmc2_db_reader.h:481); in-memory kmers0 is the
                # globally sorted view, so delegate to the file-order dump
                transform_dump(db, out, False, in_cut=in_cut)
            else:
                with open(out, "w") as f:
                    f.write(dump_records(kmers0, counts0, info.kmer_len,
                                         encoding=info.encoding))


def db_compare(db1: str, db2: str) -> bool:
    """kmc_tools compare: record-level equality (operations.h:258)."""
    _check_encodings([db1, db2])
    from . import native_tools

    eq = native_tools.run_compare(db1, db2)
    if eq is not None:
        return eq
    if _stored_count(db1) + _stored_count(db2) > _stream_threshold():
        from ..formats.streaming import stream_compare

        try:
            return stream_compare(db1, db2)
        except NotImplementedError:
            pass
    _, k1, c1 = load_sorted(db1)
    _, k2, c2 = load_sorted(db2)
    return (
        k1.shape == k2.shape
        and bool((k1 == k2).all())
        and bool((c1 == c2).all())
    )


def db_info_segments(db_path: str):
    """[(stream, text)] segments of `kmc_tools info` output, where stream
    is "out" or "err" — the reference prints the KFF footer block to
    stderr interleaved with the stdout scope lines (kmc_tools.cpp:
    158-220)."""
    if str(db_path).endswith(".kff"):
        from ..formats.kff import read_kff_meta

        # header/index walk only — also works on files with minimizer
        # sections or max>1 blocks, which are displayable but not readable
        # as k-mer data (parity with the reference: kmc_tools.cpp:158-220
        # lists them, kff_db_reader.h:16 cannot consume them)
        kf = read_kff_meta(str(db_path))
        segs = []
        head = [
            "This is KFF file, summary:",
            f"canonical         :  {'yes' if kf.canonical else 'no'}",
            f"all k-mers unique :  {'yes' if kf.all_unique else 'no'}",
            "symbols encoding:",
            f"\tA: {(kf.encoding >> 6) & 3}",
            f"\tC: {(kf.encoding >> 4) & 3}",
            f"\tG: {(kf.encoding >> 2) & 3}",
            f"\tT: {kf.encoding & 3}",
        ]
        segs.append(("out", "\n".join(head) + "\n"))
        # footer k/v sorted by key (the reference iterates a std::map) and
        # printed to STDERR inside the per-scope loop
        footer_lines = ""
        if kf.footer:
            footer_lines = "footer values:\n" + "".join(
                f"\t{k}      :  {v}\n" for k, v in sorted(kf.footer.items()))
        for scope in kf.scopes or []:
            lines = [f"k             :  {scope['k']}",
                     f"data_size     :  {scope['data_size']}",
                     f"max           :  {scope['max']}"]
            if scope["m"] is not None:
                lines.append(f"m             :  {scope['m']}")
            segs.append(("out", "\n".join(lines) + "\n"))
            segs.append(("err", footer_lines))
            body = ["Data sections:"]
            tot = 0
            for off, nb, mini in scope["sections"]:
                # the reference labels every section "raw" (its minimizer
                # reader sets type RAW too, kff_info_reader.cpp:289) and
                # prints the minimizer hex, empty for raw sections
                body.append("\ttype            :  raw")
                body.append(f"\tdata_start      :  {off}")
                body.append(f"\tnb_blocks       :  {nb}")
                tot += nb
                body.append("\tminimizer (HEX) :  "
                            + "".join(f"{b:x} " for b in mini))
            body.append(f"tot_nb_blocks :  {tot}")
            segs.append(("out", "\n".join(body) + "\n"))
        return segs
    # byte-for-byte the reference's layout (kmc_tools.cpp:139-151) so
    # scripts parsing `kmc_tools info` keep working
    info = read_db(db_path).info
    lines = [
        f"k                 :  {info.kmer_len}",
        f"total k-mers      :  {info.n_unique_stored}",
        f"cutoff max        :  {info.cutoff_max}",
        f"cutoff min        :  {info.cutoff_min}",
        f"counter size      :  {info.counter_size} bytes",
        "mode              :  "
        + ("quality-aware counters" if info.mode else "occurrence counters"),
        f"both strands      :  {'yes' if info.both_strands else 'no'}",
        f"database format   :  {'KMC2.x' if info.version == 0x200 else 'KMC1.x'}",
        f"signature length  :  {info.signature_len}",
        # the reference's KMC1 header has no bins field and prints 0
        f"number of bins    :  {info.n_bins if info.version == 0x200 else 0}",
        f"lut_prefix_len    :  {info.lut_prefix_len}",
    ]
    return [("out", "\n".join(lines) + "\n")]


def db_info_text(db_path: str) -> str:
    """All info output (stdout + stderr segments) as one string."""
    return "".join(text for _, text in db_info_segments(db_path))
