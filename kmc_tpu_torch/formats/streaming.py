"""Bounded-memory sorted streaming over KMC databases.

The reference's kmc_tools never materializes a database: CKMC2DbReader
merges the 512 per-bin sections of a KMC2 DB back into one sorted stream in
constant memory (kmc_tools/kmc2_db_reader.h:400-560), CKMC1DbReader streams
the already-sorted records (kmc1_db_reader.h), and CBundle batches them
through operation trees (bundle.h:18-245).  This module is the port's
equivalent, the reader half of kmc_tpu/formats/streaming.py: per-bin
cursors over the .kmc_suf file + a windowed vectorized k-way merge.  Only the prefix LUTs live in RAM (same policy as the
reference's readers); record traffic is block-sized.

Key representation: a block of (N, KB) right-aligned big-endian k-mer bytes
is viewed as a NumPy 'S{KB}' array — lexicographic byte order equals
numeric k-mer order, so searchsorted/argsort on the S-array implement the
merge without per-record Python.

Pure NumPy — no torch import — so host-only tool runs stay light.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from .kmc_db import (
    KMC1_VER,
    KMC2_VER,
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
