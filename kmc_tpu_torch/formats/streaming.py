"""Bounded-memory sorted streaming over KMC databases.

The reference's kmc_tools never materializes a database: CKMC2DbReader
merges the 512 per-bin sections of a KMC2 DB back into one sorted stream in
constant memory (kmc_tools/kmc2_db_reader.h:400-560), CKMC1DbReader streams
the already-sorted records (kmc1_db_reader.h), and CBundle batches them
through operation trees (bundle.h:18-245).  This module is the port's
copy of kmc_tpu/formats/streaming.py: per-bin cursors over the .kmc_suf
file + a windowed vectorized k-way merge (the reader half), and the KMC1
writer, key-stream merges and stream_* operations of kmc_tools (the writer
half).  Only the prefix LUTs live in RAM (same policy as the reference's
readers); record traffic is block-sized.

Key representation: a block of (N, KB) right-aligned big-endian k-mer bytes
is viewed as a NumPy 'S{KB}' array — lexicographic byte order equals
numeric k-mer order, so searchsorted/argsort on the S-array implement the
merge without per-record Python.

Pure NumPy — no torch import — so host-only tool runs stay light.
"""
from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from .kmc_db import (
    KMC1_VER,
    KMC2_VER,
    PRE_MARKER,
    SUF_MARKER,
    DbInfo,
    read_pre_meta,
)

DEFAULT_BLOCK = 1 << 16


def _keys_of(kmers: np.ndarray) -> np.ndarray:
    """(N, KB) uint8 -> (N,) 'S{KB}' lexicographic keys (zero-copy-ish)."""
    n, kb = kmers.shape
    if kb == 0:
        return np.zeros(n, dtype="S1")
    return np.ascontiguousarray(kmers).view(f"S{kb}").reshape(n)


def _kmers_of(keys: np.ndarray, kb: int) -> np.ndarray:
    """(N,) 'S{KB}' -> (N, KB) uint8."""
    if kb == 0:
        return np.zeros((len(keys), 0), np.uint8)
    return np.frombuffer(keys.tobytes(), dtype=np.uint8).reshape(-1, kb)


class _SectionCursor:
    """Sorted records of one contiguous .kmc_suf section (one KMC2 bin, or
    the whole of a KMC1 DB), streamed in blocks.

    Produces (keys 'S', counts u32) blocks; prefixes are reconstructed from
    the bin's LUT slice with a windowed searchsorted."""

    def __init__(self, f, info: DbInfo, luts: np.ndarray, lut_base: int,
                 rec_lo: int, rec_hi: int, block: int):
        self.f = f
        self.info = info
        self.luts = luts
        self.lut_base = lut_base  # first lut index of this section
        self.lut_size = 1 << (2 * info.lut_prefix_len)
        self.pos = rec_lo
        self.hi = rec_hi
        self.block = block
        self.buf_keys: np.ndarray | None = None
        self.buf_counts: np.ndarray | None = None

    def exhausted(self) -> bool:
        return self.pos >= self.hi and (
            self.buf_keys is None or len(self.buf_keys) == 0)

    def file_done(self) -> bool:
        return self.pos >= self.hi

    def _load(self):
        info = self.info
        n = min(self.block, self.hi - self.pos)
        rb = info.record_bytes
        if rb:
            self.f.seek(4 + self.pos * rb)
            raw = self.f.read(n * rb)
            rec = np.frombuffer(raw, np.uint8, count=n * rb).reshape(n, rb)
        else:
            rec = np.zeros((n, 0), np.uint8)
        sb = info.suffix_bytes
        kb = info.kmer_bytes
        kmers = np.zeros((n, kb), np.uint8)
        if sb:
            kmers[:, kb - sb :] = rec[:, :sb]
        # prefix of record i = lut slot whose cumulative range contains i
        lo = self.lut_base
        hi = min(lo + self.lut_size + 1, len(self.luts))
        rel = np.searchsorted(
            self.luts[lo:hi],
            np.arange(self.pos, self.pos + n, dtype=np.uint64),
            side="right") - 1
        prefix = rel.astype(np.uint64)
        for j in range(kb - sb - 1, -1, -1):
            kmers[:, j] = (prefix & np.uint64(0xFF)).astype(np.uint8)
            prefix >>= np.uint64(8)
        cs = info.counter_size
        if cs == 0:
            counts = np.ones(n, np.uint32)
        else:
            c = np.zeros(n, np.uint64)
            for j in range(cs - 1, -1, -1):
                c = (c << np.uint64(8)) | rec[:, sb + j].astype(np.uint64)
            counts = c.astype(np.uint32)
        self.pos += n
        keys = _keys_of(kmers)
        if self.buf_keys is not None and len(self.buf_keys):
            self.buf_keys = np.concatenate([self.buf_keys, keys])
            self.buf_counts = np.concatenate([self.buf_counts, counts])
        else:
            self.buf_keys, self.buf_counts = keys, counts

    def ensure(self):
        if (self.buf_keys is None or len(self.buf_keys) == 0) and \
                self.pos < self.hi:
            self._load()

    def take_upto(self, bound: bytes):
        """Pop every buffered record with key <= bound."""
        i = int(np.searchsorted(self.buf_keys, bound, side="right"))
        out = (self.buf_keys[:i], self.buf_counts[:i])
        self.buf_keys = self.buf_keys[i:]
        self.buf_counts = self.buf_counts[i:]
        return out


class DbStreamReader:
    """Globally-sorted bounded-memory (kmers, counts) block stream over a
    KMC1/KMC2 database or KFF file — the CKMC*DbReader/CBundle analogue."""

    def __init__(self, path: str, block_records: int = DEFAULT_BLOCK,
                 cutoff_min: int | None = None, cutoff_max: int | None = None):
        self.path = str(path)
        self.block = int(block_records)
        self.cutoff_min = cutoff_min
        self.cutoff_max = cutoff_max
        if self.path.endswith(".kff"):
            self._init_kff()
        else:
            # LUTs stay demand-paged (np.memmap): bounded resident memory
            # even for databases whose LUT area rivals the suffix area
            self.info, self.luts, self.sig_map = read_pre_meta(
                self.path, mmap_luts=True)
            self._f = open(self.path + ".kmc_suf", "rb")
            if self._f.read(4) != SUF_MARKER:
                raise ValueError("bad .kmc_suf marker")

    # -- kff --

    def _init_kff(self):
        from .kff import read_kff_meta

        self._kff = read_kff_meta(self.path)
        if self._kff.m_sections:
            # parity with the reference: kmc_tools displays minimizer
            # sections (info) but its KFF db reader does not consume them
            # (kff_db_reader.h:16)
            raise NotImplementedError(
                "KFF minimizer sections cannot be read as k-mer data")
        self.luts = None
        self.sig_map = None
        self._f = open(self.path, "rb")
        self._kff_runs = None
        n_stored = sum(n for _, n in self._kff.sections)
        if self._kff.max_in_block != 1 or not self._kff.ordered:
            # max>1 block sections (which the reference refuses outright,
            # kff_db_reader.h:16) and unsorted record sections cannot feed
            # the windowed merge directly: expand+sort them into on-disk
            # runs in bounded memory, then merge the runs like sections
            n_stored = self._build_kff_runs()
        self.info = DbInfo(
            kmer_len=self._kff.k,
            counter_size=self._kff.counter_size,
            lut_prefix_len=0,
            cutoff_min=self._kff.min_count,
            cutoff_max=self._kff.max_count,
            both_strands=self._kff.canonical,
            n_unique_stored=n_stored,
            version=KMC2_VER,
        )

    def _build_kff_runs(self) -> int:
        """Bounded-memory external sort of a block-section / unsorted KFF:
        walk every data scope, expand max>1 raw blocks to per-k-mer rows
        in ~1 MB slabs, sort each accumulated chunk, and append it to an
        unlinked temp file as a (kb + counter_size)-byte record run —
        exactly the record shape _KffSectionCursor streams, so the merge
        machinery consumes runs like sections.  Equal keys keep file
        order (runs are sequential file slices + stable sorts), matching
        the in-memory read_kff + stable-lexsort path record-for-record.
        Returns the total expanded row count."""
        import tempfile

        from .kff import _block_n_bytes, _decode_block_section

        meta = self._kff
        kb = (meta.k + 3) // 4
        cs = meta.counter_size
        rb = kb + cs
        self._kff_tmp = tempfile.TemporaryFile()
        runs: list[tuple[int, int]] = []  # (byte offset, n_records)
        budget_rows = max(self.block, 1 << 16)
        acc_k: list[np.ndarray] = []
        acc_c: list[np.ndarray] = []
        acc_n = 0

        def flush():
            nonlocal acc_n
            if not acc_n:
                return
            kmers = np.concatenate(acc_k)
            counts = np.concatenate(acc_c)
            keys = _keys_of(np.ascontiguousarray(kmers))
            order = np.argsort(keys, kind="stable")
            rows = np.empty((len(keys), rb), np.uint8)
            rows[:, :kb] = kmers[order]
            if cs:
                c = counts[order].astype(np.uint64)
                for j in range(cs):  # big-endian, like KFF records
                    rows[:, kb + j] = (
                        (c >> np.uint64(8 * (cs - 1 - j)))
                        & np.uint64(0xFF)).astype(np.uint8)
            start = self._kff_tmp.tell()
            self._kff_tmp.write(rows.tobytes())
            runs.append((start, len(keys)))
            acc_k.clear()
            acc_c.clear()
            acc_n = 0

        def push(kmers, counts):
            nonlocal acc_n
            acc_k.append(kmers)
            acc_c.append(counts)
            acc_n += len(kmers)
            if acc_n >= budget_rows:
                flush()

        # effective per-scope variables: each scope records only its 'v'
        # delta; values inherit from the preceding scopes
        eff = {"k": meta.k, "data_size": cs, "max": 1}
        total = 0
        for scope in (meta.scopes or []):
            for key in ("k", "data_size", "max"):
                if scope.get(key) is not None:
                    eff[key] = int(scope[key])
            if eff["k"] != meta.k or eff["data_size"] != cs:
                raise NotImplementedError(
                    "mixed k / data_size scopes cannot stream")
            mx = eff["max"]
            for (start, nb, mini) in scope["sections"]:
                if mini:
                    continue  # m-sections were refused above
                if mx == 1:
                    # plain records, possibly unsorted: slab-read rows
                    pos = 0
                    while pos < nb:
                        n = min(nb - pos, budget_rows)
                        self._f.seek(start + pos * rb)
                        raw = np.frombuffer(
                            self._f.read(n * rb), np.uint8).reshape(n, rb)
                        c = np.zeros(n, np.uint64)
                        for j in range(cs):
                            c = (c << np.uint64(8)) | raw[:, kb + j].astype(
                                np.uint64)
                        push(raw[:, :kb].copy(),
                             c.astype(np.uint32) if cs
                             else np.ones(n, np.uint32))
                        total += n
                        pos += n
                else:
                    # raw blocks: walk block sizes, decode whole blocks
                    # per ~1 MB slab (expansion is ~20x the raw bytes, so
                    # slabs stay small; oversized blocks grow the slab)
                    n_bytes = _block_n_bytes(mx)
                    fpos = start
                    left = nb
                    while left:
                        self._f.seek(fpos)
                        slab = self._f.read(1 << 20)
                        while True:
                            off = 0
                            cnt = 0
                            while cnt < left:
                                if off + n_bytes > len(slab):
                                    break
                                bn = int.from_bytes(
                                    slab[off : off + n_bytes], "big")
                                bsz = (n_bytes
                                       + (eff["k"] + bn - 1 + 3) // 4
                                       + bn * cs)
                                if off + bsz > len(slab):
                                    break
                                off += bsz
                                cnt += 1
                            if cnt or not left:
                                break
                            more = self._f.read(1 << 20)
                            if not more:
                                raise ValueError("truncated KFF block")
                            slab += more
                        _, km, ct = _decode_block_section(
                            np.frombuffer(slab[:off], np.uint8), 0, cnt,
                            eff["k"], mx, cs)
                        push(km, ct)
                        total += len(km)
                        fpos += off
                        left -= cnt
        flush()
        self._kff_runs = runs
        return total

    def close(self):
        self._f.close()
        tmp = getattr(self, "_kff_tmp", None)
        if tmp is not None:
            tmp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _cursors(self) -> list:
        info = self.info
        if self.luts is None:  # KFF
            if self._kff_runs is not None:
                # external-sorted runs of an expanded block-section /
                # unsorted file: same record shape as plain sections
                return [
                    _KffSectionCursor(self._kff_tmp, self._kff,
                                      off, n, self.block)
                    for off, n in self._kff_runs
                ]
            return [
                _KffSectionCursor(self._f, self._kff, off, n, self.block)
                for off, n in self._kff.sections
            ]
        lut_size = 1 << (2 * info.lut_prefix_len)
        if info.version == KMC1_VER or info.n_bins <= 1:
            # record count from the header (mmap'd KMC1 LUTs carry no
            # trailing n_recs sentinel)
            n_recs = (info.n_unique_stored if info.version == KMC1_VER
                      else int(self.luts[-1]))
            return [_SectionCursor(self._f, info, self.luts, 0, 0,
                                   n_recs, self.block)]
        cursors = []
        for b in range(info.n_bins):
            lo = int(self.luts[b * lut_size])
            hi = int(self.luts[min((b + 1) * lut_size, len(self.luts) - 1)])
            if hi > lo:
                cursors.append(_SectionCursor(
                    self._f, info, self.luts, b * lut_size, lo, hi,
                    max(self.block // max(info.n_bins // 8, 1), 1024)))
        return cursors

    def blocks(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield (kmers (B, KB) uint8, counts (B,) uint32) blocks in global
        ascending k-mer order, min/max filtered."""
        kb = self.info.kmer_bytes
        for keys, counts in self.key_blocks():
            yield _kmers_of(keys, kb), counts

    def key_blocks(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """blocks(), but keys stay in 'S{KB}' form (cheap to compare)."""
        cursors = self._cursors()
        cmin, cmax = self.cutoff_min, self.cutoff_max
        while cursors:
            for c in cursors:
                c.ensure()
            cursors = [c for c in cursors if not c.exhausted()]
            if not cursors:
                break
            # safe merge bound: the smallest "last loaded key" among
            # cursors that still have file data (their unseen records may
            # be anywhere above it); fully-loaded cursors are complete
            bounds = [c.buf_keys[-1] for c in cursors if not c.file_done()]
            bound = min(bounds) if bounds else max(
                c.buf_keys[-1] for c in cursors)
            parts = [c.take_upto(bound) for c in cursors]
            keys = np.concatenate([p[0] for p in parts])
            counts = np.concatenate([p[1] for p in parts])
            if len(keys) == 0:
                continue
            if len(parts) > 1:
                order = np.argsort(keys, kind="stable")
                keys, counts = keys[order], counts[order]
            if cmin is not None or cmax is not None:
                keep = np.ones(len(counts), bool)
                if cmin is not None:
                    keep &= counts >= cmin
                if cmax is not None:
                    keep &= counts <= cmax
                keys, counts = keys[keep], counts[keep]
            if len(keys):
                yield keys, counts


class _KffSectionCursor:
    """Sorted records of one KFF 'r' section (big-endian k-mer + counter)."""

    def __init__(self, f, meta, offset: int, n_recs: int, block: int):
        self.f = f
        self.meta = meta
        self.kb = (meta.k + 3) // 4
        self.rec_bytes = self.kb + meta.counter_size
        self.off = offset
        self.pos = 0
        self.hi = n_recs
        self.block = block
        self.buf_keys = None
        self.buf_counts = None

    def exhausted(self):
        return self.pos >= self.hi and (
            self.buf_keys is None or len(self.buf_keys) == 0)

    def file_done(self):
        return self.pos >= self.hi

    def ensure(self):
        if (self.buf_keys is None or len(self.buf_keys) == 0) and \
                self.pos < self.hi:
            n = min(self.block, self.hi - self.pos)
            self.f.seek(self.off + self.pos * self.rec_bytes)
            raw = np.frombuffer(self.f.read(n * self.rec_bytes), np.uint8)
            rec = raw.reshape(n, self.rec_bytes)
            kmers = rec[:, : self.kb]
            cs = self.meta.counter_size
            c = np.zeros(n, np.uint64)
            for j in range(cs):  # KFF counters are big-endian
                c = (c << np.uint64(8)) | rec[:, self.kb + j].astype(np.uint64)
            self.buf_keys = _keys_of(np.ascontiguousarray(kmers))
            self.buf_counts = c.astype(np.uint32) if cs else np.ones(
                n, np.uint32)
            self.pos += n

    take_upto = _SectionCursor.take_upto


class StreamingKmc1Writer:
    """Incremental KMC1 (version 0) database writer: records stream to
    .kmc_suf while the prefix histogram accumulates; close() writes the
    LUT + header.  The kmc_tools output side (CKMC1DbWriter,
    kmc_tools/kmc1_db_writer.h:55) in bounded memory."""

    def __init__(self, path_prefix: str, info: DbInfo):
        self.path = path_prefix
        self.info = info
        self.lut_size = 1 << (2 * info.lut_prefix_len)
        self.hist = np.zeros(self.lut_size, np.uint64)
        self.n = 0
        self._suf = open(path_prefix + ".kmc_suf", "wb")
        self._suf.write(SUF_MARKER)

    def put_block(self, kmers: np.ndarray, counts: np.ndarray):
        info = self.info
        n = len(kmers)
        if n == 0:
            return
        sb = info.suffix_bytes
        rec = np.empty((n, sb + info.counter_size), np.uint8)
        if sb:
            rec[:, :sb] = kmers[:, kmers.shape[1] - sb :]
        c = np.asarray(counts, np.uint64)
        for j in range(info.counter_size):
            rec[:, sb + j] = ((c >> np.uint64(8 * j)) & np.uint64(0xFF)
                              ).astype(np.uint8)
        rec.tofile(self._suf)
        from .kmc_db import kmer_bytes_to_prefix_ids

        pids = kmer_bytes_to_prefix_ids(kmers, info.kmer_len,
                                        info.lut_prefix_len)
        self.hist += np.bincount(pids.astype(np.int64),
                                 minlength=self.lut_size).astype(np.uint64)
        self.n += n

    def close(self):
        self._suf.write(SUF_MARKER)
        self._suf.close()
        write_kmc1_pre(self.path, self.info, self.hist, self.n)


def write_kmc1_pre(path_prefix: str, info: DbInfo, hist: np.ndarray,
                   n: int) -> None:
    """Write a KMC1 .kmc_pre (LUT cumsum + header) from a prefix histogram
    — shared by StreamingKmc1Writer and the native tools core (which emits
    the .kmc_suf records + histogram in C, tools/native_tools.py)."""
    lut_size = 1 << (2 * info.lut_prefix_len)
    with open(str(path_prefix) + ".kmc_pre", "wb") as pre:
        pre.write(PRE_MARKER)
        lut = np.zeros(lut_size, np.uint64)
        np.cumsum(hist[:lut_size][:-1], out=lut[1:])
        lut.astype("<u8").tofile(pre)
        header = struct.pack(
            "<IIIIIIQB",
            info.kmer_len, info.mode, info.counter_size,
            info.lut_prefix_len, info.cutoff_min,
            info.cutoff_max & 0xFFFFFFFF, n,
            0 if info.both_strands else 1,
        )
        header += b"\x00" * 3
        header += struct.pack("<I", (info.cutoff_max >> 32) & 0xFFFFFFFF)
        header += b"\x00" * 20
        header += struct.pack("<I", KMC1_VER)
        pre.write(header)
        pre.write(struct.pack("<I", len(header)))
        pre.write(PRE_MARKER)


# -- windowed two-stream merge ops (the streaming CUnion/CIntersection/...,
#    operations.h:85-258) --


class _Peekable:
    def __init__(self, it):
        self.it = iter(it)
        self.keys = np.zeros(0, "S1")
        self.counts = np.zeros(0, np.uint32)
        self.done = False

    def ensure(self):
        while not self.done and len(self.keys) == 0:
            try:
                self.keys, self.counts = next(self.it)
            except StopIteration:
                self.done = True

    def take_upto(self, bound: bytes):
        i = int(np.searchsorted(self.keys, bound, side="right"))
        out = (self.keys[:i], self.counts[:i])
        self.keys, self.counts = self.keys[i:], self.counts[i:]
        return out


def merge_key_streams(s1, s2, op: str, mode: str) -> Iterator[
        tuple[np.ndarray, np.ndarray]]:
    """Merge two sorted-unique (keys 'S', counts) block streams under a set
    operation.  op: union|intersect|kmers_subtract|counters_subtract (use
    swapped streams for the reverse_* variants); mode: the counter
    combination (db_ops._combine / reference CounterOpType semantics).
    Yields windows whose results are identical to the in-memory
    db_ops.SIMPLE_OPS applied to the concatenation."""
    a, b = _Peekable(s1), _Peekable(s2)
    while True:
        a.ensure()
        b.ensure()
        if a.done and len(a.keys) == 0 and b.done and len(b.keys) == 0:
            return
        # safe merge bound: every key <= bound has been fully seen on both
        # sides (a side with buffered data bounds at its tail; an exhausted
        # side imposes no bound)
        bounds = [side.keys[-1] for side in (a, b)
                  if len(side.keys) and not side.done]
        if not bounds:
            bounds = [side.keys[-1] for side in (a, b) if len(side.keys)]
        bound = min(bounds)
        k1, c1 = a.take_upto(bound)
        k2, c2 = b.take_upto(bound)
        keys, counts = _merge_window(k1, c1, k2, c2, op, mode)
        if len(keys):
            yield keys, counts


def _merge_window(k1, c1, k2, c2, op, mode):
    """One aligned window (both sides complete for every key <= bound);
    exactly db_ops' op_* semantics on 'S'-key arrays, counters in uint64."""
    from ..tools.db_ops import _combine

    a1 = c1.astype(np.uint64)
    a2 = c2.astype(np.uint64)
    in2 = np.isin(k1, k2, assume_unique=True)
    in1 = np.isin(k2, k1, assume_unique=True)
    # counts of k2 aligned to k1's matched keys (both sorted unique)
    m2on1 = a2[in1] if in2.any() else a2[:0]

    if op == "intersect":
        keys = k1[in2]
        counts = _combine(a1[in2], m2on1, mode)
        keep = counts > 0
        return keys[keep], counts[keep]
    if op == "kmers_subtract":
        return k1[~in2], a1[~in2]
    if op == "counters_subtract":
        counts = a1.copy()
        counts[in2] = _combine(a1[in2], m2on1, mode)
        keep = counts > 0
        return k1[keep], counts[keep]
    if op == "union":
        keys = np.concatenate([k1, k2[~in1]])
        counts = np.concatenate([a1, a2[~in1]])
        if in2.any():
            counts[: len(k1)][in2] = _combine(a1[in2], m2on1, mode)
        order = np.argsort(keys, kind="stable")
        keys, counts = keys[order], counts[order]
        keep = counts > 0
        return keys[keep], counts[keep]
    raise ValueError(op)


_STREAM_OPS = {
    "union", "intersect", "kmers_subtract", "counters_subtract",
    "reverse_kmers_subtract", "reverse_counters_subtract",
}


def stream_simple_op(op: str, db1: str, db2: str, out: str,
                     mode: str | None = None, out_params=None,
                     block_records: int = DEFAULT_BLOCK,
                     in1_cut=(None, None), in2_cut=(None, None)) -> int:
    """Bounded-memory two-database set operation -> KMC1-format DB (what
    kmc_tools writes for simple ops).  in1_cut/in2_cut: per-input (ci, cx)
    applied at the cursor (the reference filters inside the db readers).
    Returns output record count."""
    from ..tools.db_ops import DEFAULT_COUNTER_MODE, OutputParams

    if op not in _STREAM_OPS:
        raise ValueError(op)
    if op.startswith("reverse_"):
        return stream_simple_op(op[len("reverse_"):], db2, db1, out,
                                mode=mode, out_params=out_params,
                                block_records=block_records,
                                in1_cut=in2_cut, in2_cut=in1_cut)
    r1 = DbStreamReader(db1, block_records,
                        cutoff_min=in1_cut[0], cutoff_max=in1_cut[1])
    try:
        r2 = DbStreamReader(db2, block_records,
                            cutoff_min=in2_cut[0], cutoff_max=in2_cut[1])
    except BaseException:
        r1.close()
        raise
    if r1.info.kmer_len != r2.info.kmer_len:
        r1.close()
        r2.close()
        raise ValueError("k-mer length mismatch")
    mode = mode or DEFAULT_COUNTER_MODE.get(op, "sum")
    if out_params is None:
        from ..tools.db_ops import default_output_params, effective_input_cut

        op_params = default_output_params(
            [db1, db2], [effective_input_cut(db1, in1_cut),
                         effective_input_cut(db2, in2_cut)])
    else:
        op_params = out_params
    kb = r1.info.kmer_bytes

    from ..tools.db_ops import tools_counter_size, tools_lut_prefix_len

    # the reference sizes the output LUT from the INPUT headers (it
    # streams, so the output count is unknown upfront) — same here
    k = r1.info.kmer_len
    info = DbInfo(
        kmer_len=k,
        counter_size=tools_counter_size(op_params.cutoff_max,
                                        op_params.counter_max),
        lut_prefix_len=tools_lut_prefix_len(
            k, [r1.info.n_unique_stored, r2.info.n_unique_stored]),
        cutoff_min=op_params.cutoff_min,
        cutoff_max=op_params.cutoff_max,
        both_strands=r1.info.both_strands,
        version=KMC1_VER,
    )
    w = StreamingKmc1Writer(out, info)
    with r1, r2:
        for keys, counts in merge_key_streams(
                r1.key_blocks(), r2.key_blocks(), op, mode):
            keep = ((counts >= op_params.cutoff_min)
                    & (counts <= op_params.cutoff_max))
            w.put_block(
                _kmers_of(keys[keep], kb),
                np.minimum(counts[keep], op_params.counter_max))
    w.close()
    return w.n


def stream_dump(db: str, out_path: str,
                block_records: int = DEFAULT_BLOCK,
                in_cut=(None, None)) -> int:
    """Bounded-memory sorted text dump (kmc_tools transform db dump -s)."""
    from .dump import dump_records_bytes

    r = DbStreamReader(db, block_records,
                       cutoff_min=in_cut[0], cutoff_max=in_cut[1])
    n = 0
    with r, open(out_path, "wb") as f:
        for kmers, counts in r.blocks():
            if len(counts):
                for part in dump_records_bytes(kmers, counts,
                                               r.info.kmer_len):
                    f.write(part)
            n += len(counts)
    return n


def stream_transform(db: str, out: str, out_params, *, set_value=None,
                     compact=False, block_records: int = DEFAULT_BLOCK,
                     in_cut=(None, None)) -> int:
    """Bounded-memory single-input transform (sort/reduce/compact/
    set_counts) -> KMC1 DB; mirrors db_ops.transform_* semantics."""
    r = DbStreamReader(db, block_records,
                       cutoff_min=in_cut[0], cutoff_max=in_cut[1])
    from ..tools.db_ops import tools_counter_size, tools_lut_prefix_len

    k = r.info.kmer_len
    kb = r.info.kmer_bytes
    info = DbInfo(
        kmer_len=k,
        counter_size=tools_counter_size(out_params.cutoff_max,
                                        out_params.counter_max,
                                        counter_value=set_value),
        lut_prefix_len=tools_lut_prefix_len(k, [r.info.n_unique_stored]),
        cutoff_min=out_params.cutoff_min,
        cutoff_max=out_params.cutoff_max,
        both_strands=r.info.both_strands,
        version=KMC1_VER,
    )
    w = StreamingKmc1Writer(out, info)
    with r:
        for keys, counts in r.key_blocks():
            if compact:
                # filter runs on the ORIGINAL counters; stored counter
                # clamps to counter_max=1 (kmc1_db_writer.h add_kmer)
                keep = ((counts >= out_params.cutoff_min)
                        & (counts <= out_params.cutoff_max))
                keys = keys[keep]
                counts = np.ones(len(keys), np.uint32)
            elif set_value is not None:
                # overwritten counters are written verbatim, like the
                # in-memory transform_set_counts (no cutoff re-filter)
                counts = np.full(len(keys), set_value, np.uint32)
            else:
                keep = ((counts >= out_params.cutoff_min)
                        & (counts <= out_params.cutoff_max))
                keys, counts = keys[keep], counts[keep]
            w.put_block(_kmers_of(keys, kb),
                        np.minimum(counts, out_params.counter_max))
    w.close()
    return w.n


def stream_histogram(db: str, out_path: str, cutoff_min: int = 1,
                     cutoff_max: int | None = None,
                     block_records: int = DEFAULT_BLOCK,
                     in_cut=(None, None)) -> None:
    """Bounded-memory counter histogram (histogram_writer.h:20-84)."""
    r = DbStreamReader(db, block_records,
                       cutoff_min=in_cut[0], cutoff_max=in_cut[1])
    info = r.info
    if cutoff_max is None:
        cutoff_max = min(info.cutoff_max, 10000)
        if info.counter_size:
            cutoff_max = min(cutoff_max, (1 << (8 * info.counter_size)) - 1)
    hist = np.zeros(cutoff_max + 2, np.int64)
    with r:
        for _, counts in r.key_blocks():
            c = np.minimum(counts.astype(np.int64), cutoff_max + 1)
            hist += np.bincount(c, minlength=cutoff_max + 2)
    with open(out_path, "w") as f:
        for v in range(cutoff_min, cutoff_max + 1):
            f.write(f"{v}\t{hist[v]}\n")


def stream_compare(db1: str, db2: str,
                   block_records: int = DEFAULT_BLOCK) -> bool:
    """Bounded-memory record-level equality (operations.h:258)."""
    r1 = DbStreamReader(db1, block_records)
    try:
        r2 = DbStreamReader(db2, block_records)
    except BaseException:
        r1.close()
        raise
    if r1.info.kmer_len != r2.info.kmer_len:
        r1.close()
        r2.close()
        return False
    with r1, r2:
        a, b = _Peekable(r1.key_blocks()), _Peekable(r2.key_blocks())
        while True:
            a.ensure()
            b.ensure()
            a_done = a.done and len(a.keys) == 0
            b_done = b.done and len(b.keys) == 0
            if a_done or b_done:
                return a_done and b_done
            n = min(len(a.keys), len(b.keys))
            if not (np.array_equal(a.keys[:n], b.keys[:n])
                    and np.array_equal(a.counts[:n], b.counts[:n])):
                return False
            a.keys, a.counts = a.keys[n:], a.counts[n:]
            b.keys, b.counts = b.keys[n:], b.counts[n:]
