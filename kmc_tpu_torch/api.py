"""Random-access / listing API over KMC databases.

The port's copy of kmc_tpu/api.py.  Mirrors KMC's kmc_api surface
(CKMCFile / CKmerAPI, kmc_api/kmc_file.h:34-235, kmer_api.h:23) with the
same method names as py_kmc_api (py_kmc_api/py_kmc_api.cpp:27-98), plus
vectorized batch variants (queries are array ops, not per-k-mer calls).
Host code only: NumPy and the native streaming core, no torch.
"""
from __future__ import annotations

import numpy as np

from .formats.kmc_db import KmcDb, read_db, sorted_records
from .io.readers import CODE_LUT
from .signatures import kmer_signatures_numpy

CODE_LUT_INV = np.frombuffer(b"ACGT", dtype=np.uint8)
# bytes.translate table: ASCII passes through, >=0x80 becomes 'N'
_NON_ASCII_TO_N = bytes(range(128)) + b"N" * 128


def _canonicalize_codes(codes: np.ndarray) -> np.ndarray:
    rc = (3 - codes)[::-1]
    diff = codes != rc
    if not diff.any():
        return codes
    i = int(np.argmax(diff))
    return codes if codes[i] < rc[i] else rc


def _codes_to_bytes(codes: np.ndarray) -> np.ndarray:
    """2-bit pack a single k-mer's codes into right-aligned big-endian bytes."""
    k = len(codes)
    kb = (k + 3) // 4
    padded = np.concatenate([np.zeros(kb * 4 - k, np.uint8), codes.astype(np.uint8)])
    b = (
        (padded[0::4] << 6) | (padded[1::4] << 4) | (padded[2::4] << 2) | padded[3::4]
    ).astype(np.uint8)
    return b


class KmerAPI:
    """K-mer value object (reference CKmerAPI, kmc_api/kmer_api.h:23)."""

    def __init__(self, kmer_len: int = 1):
        self.kmer_len = kmer_len
        self.codes = np.zeros(kmer_len, dtype=np.uint8)

    def from_string(self, s: str) -> bool:
        codes = CODE_LUT[np.frombuffer(s.encode(), dtype=np.uint8)]
        if (codes >= 4).any():
            return False
        self.kmer_len = len(s)
        self.codes = codes
        return True

    def to_string(self) -> str:
        return CODE_LUT_INV[self.codes].tobytes().decode("ascii")

    def reverse(self):
        """In-place reverse complement (kmer_api.h reverse())."""
        self.codes = (3 - self.codes)[::-1]

    def to_long(self) -> list[int]:
        """The k-mer as its right-aligned 2k-bit big integer in MSW-first
        uint64 words (kmer_api.h:452-470: the left-aligned internal rows are
        shifted down so the last base lands in the LSB of the last word) —
        e.g. 'ACGT' -> [0b00011011] == [27]."""
        n_words = (self.kmer_len + 31) // 32
        value = 0
        for c in self.codes:
            value = (value << 2) | int(c)
        return [(value >> (64 * (n_words - 1 - i))) & ((1 << 64) - 1)
                for i in range(n_words)]

    def get_signature(self, sig_len: int) -> int:
        """The k-mer's minimizer signature (kmer_api.h get_signature;
        used by CheckKmer-style bin routing)."""
        sig = kmer_signatures_numpy(self.codes, self.kmer_len, sig_len)
        return int(sig[0])

    def get_asci_symbol(self, pos: int) -> str:
        return "ACGT"[int(self.codes[pos])]

    def get_num_symbol(self, pos: int) -> int:
        return int(self.codes[pos])

    def assign(self, other: "KmerAPI"):
        self.kmer_len = other.kmer_len
        self.codes = other.codes.copy()

    def __eq__(self, other):
        return (isinstance(other, KmerAPI)
                and self.kmer_len == other.kmer_len
                and bool(np.array_equal(self.codes, other.codes)))

    def __lt__(self, other):
        # reference operator< (kmer_api.h:374-386): k-mers of different
        # lengths are incomparable (always False), not length-ordered
        if self.kmer_len != other.kmer_len:
            return False
        return self.codes.tobytes() < other.codes.tobytes()

    def __hash__(self):
        return hash((self.kmer_len, self.codes.tobytes()))

    def __str__(self):
        return self.to_string()


class KMCFileInfo:
    """Mirror of CKMCFileInfo (py_kmc_api)."""

    def __init__(self, info, total_kmers):
        self.kmer_length = info.kmer_len
        self.mode = info.mode
        self.counter_size = info.counter_size
        self.lut_prefix_length = info.lut_prefix_len
        self.signature_len = info.signature_len
        self.min_count = info.cutoff_min
        self.max_count = info.cutoff_max
        self.both_strands = info.both_strands
        self.total_kmers = total_kmers


class _FileRA:
    """Reference-style random access over the on-disk layout: sig_map in
    RAM, prefix LUTs demand-paged (memmap), suffix records memmapped, ONE
    binary search per query within the (bin, prefix) record range — exactly
    CKMCFile::CheckKmer (kmc_file.cpp:1321) — so membership queries on a
    100 GB database touch a handful of pages instead of materializing it."""

    def __init__(self, path: str, meta=None):
        import os

        from .formats.kmc_db import read_pre_meta

        if meta is None:
            meta = read_pre_meta(path, mmap_luts=True)
        self.info, self.luts, self.sig_map = meta
        rb = self.info.record_bytes
        if rb:
            n = (os.path.getsize(path + ".kmc_suf") - 8) // rb
            self.records = np.memmap(path + ".kmc_suf", dtype=np.uint8,
                                     mode="r", offset=4, shape=(n, rb))
            self.n_records = n
        else:
            self.records = None
            self.n_records = self.info.n_unique_stored
        self.sb = self.info.suffix_bytes
        self.cs = self.info.counter_size

    def lookup(self, codes: np.ndarray):
        """codes: canonicalized valid 2-bit codes of length k.  Returns the
        raw stored counter, or None if absent."""
        info = self.info
        row = _codes_to_bytes(codes)
        kb = len(row)
        prefix = 0
        for b in row[: kb - self.sb]:
            prefix = (prefix << 8) | int(b)
        if info.version == 0x200:
            sig = int(kmer_signatures_numpy(codes, info.kmer_len,
                                            info.signature_len)[0])
            bin_id = int(self.sig_map[min(sig, len(self.sig_map) - 1)])
            idx = (bin_id << (2 * info.lut_prefix_len)) | prefix
        else:
            idx = prefix
        lo = int(self.luts[idx])
        hi = (int(self.luts[idx + 1]) if idx + 1 < len(self.luts)
              else self.n_records)
        if self.sb == 0:
            # prefix-only records: presence == non-empty range; counter is
            # the range's single record (or implicit 1)
            if hi <= lo:
                return None
            return self._counter(lo)
        want = row[kb - self.sb :].tobytes()
        while lo < hi:
            mid = (lo + hi) // 2
            got = self.records[mid, : self.sb].tobytes()
            if got < want:
                lo = mid + 1
            elif got > want:
                hi = mid
            else:
                return self._counter(mid)
        return None

    def _counter(self, i: int) -> int:
        if self.cs == 0:
            return 1
        c = 0
        for j in range(self.cs - 1, -1, -1):
            c = (c << 8) | int(self.records[i, self.sb + j])
        return c

    def lookup_batch(self, rows: np.ndarray, sigs, valid: np.ndarray):
        """Vectorized form of lookup() for all k-mers of one read
        (the reference runs GetCountersForRead's per-k-mer CheckKmer loop
        in C++, kmc_file.cpp:1193; a per-k-mer Python loop over a memmap is
        ~20x slower).  rows: (n, kb) canonical big-endian k-mer bytes;
        sigs: per-window signatures of the same windows (signatures are
        strand-invariant, so forward-read windows give the same values);
        valid: (n,) bool.  Returns uint64 counters, 0 where absent or
        invalid.  All n binary searches advance together: log2(max range)
        masked gather steps against the record memmap."""
        info = self.info
        n = len(rows)
        if n == 0:
            return np.zeros(0, np.uint64)
        kb = rows.shape[1]
        pb = kb - self.sb
        prefix = np.zeros(n, np.uint64)
        for j in range(pb):
            prefix = (prefix << np.uint64(8)) | rows[:, j].astype(np.uint64)
        if info.version == 0x200:
            sig_c = np.minimum(np.asarray(sigs, np.int64),
                               len(self.sig_map) - 1)
            bin_id = np.asarray(self.sig_map)[sig_c].astype(np.uint64)
            idx = (bin_id << np.uint64(2 * info.lut_prefix_len)) | prefix
        else:
            idx = prefix
        idx = np.where(valid, idx, 0).astype(np.int64)
        luts = self.luts
        lo = np.asarray(luts[idx]).astype(np.int64)
        hi = np.where(
            idx + 1 < len(luts),
            np.asarray(luts[np.minimum(idx + 1, len(luts) - 1)]).astype(np.int64),
            self.n_records,
        )
        if self.sb == 0:
            # prefix-only records: presence == non-empty range
            found = np.where(valid & (hi > lo), lo, -1)
            return self._counters_at(found)
        want = self._suffix_words(rows[:, pb:])
        lo_s, hi_s = lo.copy(), hi
        found = np.full(n, -1, np.int64)
        active = valid & (hi_s > lo_s)
        span = int((hi_s - lo_s).max()) if n else 0
        for _ in range(max(1, span).bit_length()):
            if not active.any():
                break
            mid = (lo_s + hi_s) >> 1
            got = self._suffix_words(
                self.records[np.where(active, mid, 0), : self.sb])
            less = np.zeros(n, bool)
            greater = np.zeros(n, bool)
            decided = np.zeros(n, bool)
            for gw, ww in zip(got, want):  # MSW-first lexicographic compare
                lt = gw < ww
                gt = gw > ww
                less |= ~decided & lt
                greater |= ~decided & gt
                decided |= lt | gt
            found = np.where(active & ~decided, mid, found)
            lo_s = np.where(active & less, mid + 1, lo_s)
            hi_s = np.where(active & greater, mid, hi_s)
            active = active & decided & (hi_s > lo_s)
        return self._counters_at(found)

    @staticmethod
    def _suffix_words(b: np.ndarray):
        """(n, sb) big-endian suffix bytes -> list of MSW-first uint64
        word columns (short tail word zero-padded on the right; order-
        preserving for equal-length keys)."""
        n, sb = b.shape
        words = []
        for w0 in range(0, sb, 8):
            w = np.zeros(n, np.uint64)
            for j in range(w0, min(w0 + 8, sb)):
                w |= b[:, j].astype(np.uint64) << np.uint64(
                    8 * (7 - (j - w0)))
            words.append(w)
        return words

    def _counters_at(self, found: np.ndarray) -> np.ndarray:
        ok = found >= 0
        if self.cs == 0:
            return np.where(ok, np.uint64(1), np.uint64(0))
        raw = self.records[np.where(ok, found, 0),
                           self.sb : self.sb + self.cs].astype(np.uint64)
        c = np.zeros(len(found), np.uint64)
        for j in range(self.cs):  # stored little-endian
            c |= raw[:, j] << np.uint64(8 * j)
        return np.where(ok, c, np.uint64(0))


def _ra_threshold() -> int:
    import os

    return int(os.environ.get("KMC_TPU_RA_THRESHOLD", 1 << 24))


class KMCFile:
    """KMC database reader (reference CKMCFile).

    OpenForRA materializes the sorted records for random access
    (CheckKmer / GetCountersForRead).  OpenForListing streams in bounded
    memory: records come through formats/streaming.py block cursors and
    the prefix LUTs stay demand-paged — the analogue of the reference's
    buffered listing mode (CPrefixFileBufferForListingMode,
    kmc_api/kmc_file.h:36-96).  Like the reference, random-access queries
    require RA mode.
    """

    def __init__(self):
        self._db_obj: KmcDb | None = None
        self._db_path: str | None = None
        self._info = None
        self._kmers_arr = None  # (N, KB) sorted (RA mode); lazy for KMC2
        self._counts_arr = None
        self._kmers_keys = None  # cached _rows_search_keys(self._kmers)
        self._keys_idx16 = None  # cached top-16-bit range table (native RA)
        self._rows_idx16_cache = None  # wide-key (k>32) jump table
        self._rows_keys0_cache = None  # wide-key first-8-byte u64 keys
        self._binned_src = None  # converted (luts, sig_map, records, aux)
        self._ra_maps = None  # memmap RA structures (KMC2, below threshold)
        self._pos = 0
        self._min_count = 1
        self._max_count = (1 << 32) - 1
        self._reader = None  # listing mode
        self._file_ra = None  # on-disk RA mode (big databases)
        self._sym_map = None  # ACGT code -> file symbol (non-default KFF)
        self._path = None
        self._it = None
        self._buf_k = None
        self._buf_c = None
        self._buf_i = 0
        self._buf_ok = None
        self._buf_ok_ver = -1
        self._filter_ver = 0

    # -- opening ----------------------------------------------------------
    @property
    def _db(self):
        """Materialized KmcDb (records copy) — LAZY: the binned native
        lookup serves reads from memmaps, so the filter never loads it."""
        if self._db_obj is None and self._db_path is not None:
            self._db_obj = read_db(self._db_path)
        return self._db_obj

    @_db.setter
    def _db(self, v):
        self._db_obj = v
        if v is None:
            self._db_path = None

    @property
    def _kmers(self):
        if self._kmers_arr is None and self._db is not None:
            self._kmers_arr, self._counts_arr = sorted_records(self._db)
        return self._kmers_arr

    @_kmers.setter
    def _kmers(self, v):
        self._kmers_arr = v

    @property
    def _counts(self):
        if self._counts_arr is None and self._db is not None:
            self._kmers_arr, self._counts_arr = sorted_records(self._db)
        return self._counts_arr

    @_counts.setter
    def _counts(self, v):
        self._counts_arr = v

    def OpenForRA(self, path: str) -> bool:
        return self._open(path, ra=True)

    def OpenForListing(self, path: str) -> bool:
        return self._open(path, ra=False)

    def _open(self, path: str, ra: bool = True) -> bool:
        self._binned_src = None
        self._ra_maps = None
        self._rows_idx16_cache = None
        self._rows_keys0_cache = None
        self._sym_map = None  # else a prior non-default KFF re-encodes
        # queries against the next database
        if ra and str(path).endswith(".kff"):
            # KFF random access: materialize into the same sorted RA
            # structure the reference builds (CKffAndKMCRandomAccess
            # loads the KFF into a CKMCFile-shaped prefix/suffix array,
            # kmc_tools/kff_random_access.h:21-120)
            from .formats.kff import read_kff
            from .formats.kmc_db import DbInfo

            try:
                kf = read_kff(str(path))
            except (OSError, ValueError, NotImplementedError):
                return False
            order = np.lexsort(tuple(
                kf.kmers[:, j] for j in range(kf.kmers.shape[1] - 1, -1, -1)))
            self._kmers = kf.kmers[order]
            self._kmers_keys = None
            self._keys_idx16 = None
            self._counts = kf.counts[order]
            self._info = DbInfo(
                kmer_len=kf.k,
                counter_size=kf.counter_size,
                lut_prefix_len=0,
                cutoff_min=kf.min_count,
                cutoff_max=kf.max_count,
                both_strands=kf.canonical,
                n_unique_stored=len(self._counts),
                encoding=kf.encoding,
            )
            if kf.encoding != 0b00011011:
                # query strings must be re-encoded into the file's symbol
                # space before lookup (the reference's enocde_reads_map,
                # kff_random_access.h:118-140)
                self._sym_map = np.array(
                    [(kf.encoding >> 6) & 3, (kf.encoding >> 4) & 3,
                     (kf.encoding >> 2) & 3, kf.encoding & 3], np.uint8)
            else:
                self._sym_map = None
            self._db = None
            self._pos = 0
            self._min_count = self._info.cutoff_min
            self._max_count = self._info.cutoff_max
            return True
        if ra:
            # above the threshold, random access stays ON DISK like the
            # reference (sig_map -> bin -> prefix LUT -> binary search in
            # the suffix file); below it, materializing is faster and also
            # serves listing-style iteration
            try:
                from .formats.kmc_db import read_pre_meta

                meta = read_pre_meta(path, mmap_luts=True)
            except (OSError, ValueError):
                return False
            if meta[0].n_unique_stored > _ra_threshold():
                try:
                    self._file_ra = _FileRA(path, meta=meta)
                except (OSError, ValueError):
                    return False
                self._info = self._file_ra.info
                self._path = path
                self._db = None
                self._kmers = self._counts = self._kmers_keys = None
                self._keys_idx16 = None
                self._min_count = self._info.cutoff_min
                self._max_count = self._info.cutoff_max
                return True
            try:
                # memmap-backed structures only; the record-copying
                # read_db load happens lazily on first row access
                self._ra_maps = _FileRA(path, meta=meta)
            except (OSError, ValueError):
                return False
            self._db_obj = None
            self._db_path = path
            self._info = self._ra_maps.info
            # row materialization (reconstruct + global sort) is LAZY:
            # the binned native lookup serves reads straight off the raw
            # layout, so the filter never pays for it
            self._kmers = self._counts = None
            self._kmers_keys = None
            self._keys_idx16 = None
            self._pos = 0
        else:
            from .formats.streaming import DbStreamReader

            try:
                self._reader = DbStreamReader(path)
            except (OSError, ValueError, NotImplementedError):
                return False
            self._path = path
            self._info = self._reader.info
            self._restart_stream()
        self._min_count = self._info.cutoff_min
        self._max_count = self._info.cutoff_max
        return True

    def _restart_stream(self):
        self._it = self._reader.blocks()
        self._buf_k = None
        self._buf_c = None
        self._buf_i = 0
        self._buf_ok = None

    def _fill(self) -> bool:
        """Advance the cursor to the next record passing the CURRENT
        min/max filter; False at end of stream.  Blocks are buffered RAW so
        later SetMinCount/SetMaxCount changes apply to not-yet-read rows
        exactly like RA mode's read-time filtering; the per-block pass mask
        is cached (keyed on a filter version) so a full listing stays
        O(block), not O(block^2)."""
        while True:
            if self._buf_k is not None and self._buf_i < len(self._buf_c):
                if self._buf_ok is None or self._buf_ok_ver != self._filter_ver:
                    c = self._buf_c
                    self._buf_ok = ((c >= self._min_count)
                                    & (c <= self._max_count))
                    self._buf_ok_ver = self._filter_ver
                ok = self._buf_ok[self._buf_i :]
                hit = int(np.argmax(ok))
                if ok[hit]:
                    self._buf_i += hit
                    return True
                self._buf_i = len(self._buf_c)
                continue
            try:
                self._buf_k, self._buf_c = next(self._it)
                self._buf_i = 0
                self._buf_ok = None
            except StopIteration:
                return False

    def Close(self) -> bool:
        ok = (self._db_obj is not None or self._db_path is not None
              or self._reader is not None
              or self._file_ra is not None
              or self._kmers_arr is not None)  # KFF-RA materialized mode
        self._db = None
        self._file_ra = None
        self._kmers = self._counts = self._kmers_keys = None
        self._keys_idx16 = None
        self._rows_idx16_cache = None
        self._rows_keys0_cache = None
        self._binned_src = None
        self._ra_maps = None
        self._sym_map = None
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        self._it = self._buf_k = self._buf_c = None
        return ok

    # -- info -------------------------------------------------------------
    def Info(self) -> KMCFileInfo:
        total = (len(self._kmers) if self._kmers is not None
                 else self._info.n_unique_stored)
        return KMCFileInfo(self._info, total)

    def _is_file_ra(self) -> bool:
        return self._file_ra is not None

    def KmerLength(self) -> int:
        return self._info.kmer_len

    def KmerCount(self) -> int:
        if self._kmers is not None:
            mask = (self._counts >= self._min_count) & (self._counts <= self._max_count)
            return int(mask.sum())
        # listing mode: one bounded-memory counting pass over a fresh
        # stream (does not disturb the listing position)
        from .formats.streaming import DbStreamReader

        n = 0
        with DbStreamReader(self._path, cutoff_min=self._min_count,
                            cutoff_max=self._max_count) as r:
            for _, c in r.key_blocks():
                n += len(c)
        return n

    # -- counter filtering (kmc_file.h SetMinCount/SetMaxCount) -----------
    def SetMinCount(self, c: int) -> bool:
        self._min_count = c
        self._filter_ver += 1
        return True

    def SetMaxCount(self, c: int) -> bool:
        self._max_count = c
        self._filter_ver += 1
        return True

    def GetMinCount(self) -> int:
        return self._min_count

    def GetMaxCount(self) -> int:
        return self._max_count

    def GetBothStrands(self) -> bool:
        return bool(self._info.both_strands)

    def ResetMinMaxCounts(self) -> bool:
        """Back to the database's own cutoff bounds (kmc_file.h)."""
        self._min_count = self._info.cutoff_min
        self._max_count = self._info.cutoff_max
        return True

    def IsKMC2(self) -> bool:
        return self._info.version == 0x200

    def RestartListing(self) -> bool:
        if self._reader is not None:
            self._restart_stream()
        else:
            self._pos = 0
        return True

    def Eof(self) -> bool:
        if self._reader is not None:
            return not self._fill()
        if self._file_ra is not None:
            return True  # on-disk RA mode does not list (reference RA)
        return self._pos >= len(self._kmers)

    # -- listing -----------------------------------------------------------
    def ReadNextKmer(self, kmer: KmerAPI):
        """Returns (ok, count); advances the listing cursor (skipping k-mers
        outside [min_count, max_count] like the reference)."""
        if self._file_ra is not None:
            return False, 0  # listing requires OpenForListing (reference)
        if self._reader is not None:
            if not self._fill():
                return False, 0
            i = self._buf_i
            self._buf_i += 1
            kmer.kmer_len = self._info.kmer_len
            kmer.codes = _bytes_to_codes(self._buf_k[i], kmer.kmer_len)
            return True, int(self._buf_c[i])
        while self._pos < len(self._kmers):
            i = self._pos
            self._pos += 1
            c = int(self._counts[i])
            if self._min_count <= c <= self._max_count:
                kmer.kmer_len = self._info.kmer_len
                kmer.codes = _bytes_to_codes(self._kmers[i], kmer.kmer_len)
                return True, c
        return False, 0

    # -- random access ------------------------------------------------------
    def CheckKmer(self, kmer) -> tuple[bool, int]:
        """Membership + counter for one k-mer (string or KmerAPI).

        The reference routes through signature -> bin -> prefix LUT -> binary
        search (kmc_file.cpp:1321); over the in-memory sorted array one
        searchsorted is equivalent.  RA mode only, like the reference
        (listing mode returns not-found).
        """
        if self._kmers is None and self._file_ra is None:
            return False, 0
        if isinstance(kmer, KmerAPI):
            codes = kmer.codes
        else:
            codes = CODE_LUT[np.frombuffer(str(kmer).encode(), dtype=np.uint8)]
        if (codes >= 4).any() or len(codes) != self._info.kmer_len:
            return False, 0
        if self._sym_map is not None:  # non-default KFF encoding
            codes = self._sym_map[codes]
        if self._info.both_strands:
            codes = _canonicalize_codes(codes)
        if self._file_ra is not None:
            c = self._file_ra.lookup(codes)
            if c is None or not (self._min_count <= c <= self._max_count):
                return False, 0
            return True, c
        row = _codes_to_bytes(codes)
        idx = _searchsorted_rows(self._kmers, row[None, :],
                                 haystack_keys=self._hay_keys())[0]
        if idx < len(self._kmers) and (self._kmers[idx] == row).all():
            c = int(self._counts[idx])
            if self._min_count <= c <= self._max_count:
                return True, c
        return False, 0

    def _hay_keys(self):
        if self._kmers_keys is None and self._kmers is not None:
            self._kmers_keys = _rows_search_keys(self._kmers)
            self._keys_idx16 = None
        return self._kmers_keys

    def _hay_idx16(self):
        if self._keys_idx16 is None and self._kmers_keys is not None \
                and self._kmers_keys.dtype == np.uint64:
            from .tools.native_tools import build_key_index16

            self._keys_idx16 = build_key_index16(self._kmers_keys)
        return self._keys_idx16

    def _rows_idx16(self):
        """Jump table for the wide (k>32) native lookup, keyed on the
        first two key-row bytes; cached like _hay_idx16."""
        if getattr(self, "_rows_idx16_cache", None) is None \
                and self._kmers is not None and len(self._kmers):
            from .tools.native_tools import build_row_index16

            self._rows_idx16_cache = build_row_index16(self._kmers)
        return getattr(self, "_rows_idx16_cache", None)

    def _rows_keys0(self):
        """Per-row first-8-byte u64 keys for the wide native lookup
        (binary search on u64 compares, tail memcmp only on u64 ties)."""
        if getattr(self, "_rows_keys0_cache", None) is None \
                and self._kmers is not None and len(self._kmers):
            from .tools.native_tools import build_row_keys0

            self._rows_keys0_cache = build_row_keys0(self._kmers)
        return getattr(self, "_rows_keys0_cache", None)

    def IsKmer(self, kmer) -> bool:
        return self.CheckKmer(kmer)[0]

    def GetCountersForRead(self, read: str) -> tuple[bool, list]:
        """Counters for every k-mer of a read, 0 where absent or broken by
        non-ACGT symbols (reference kmc_file.cpp:1193).  RA mode only."""
        ok, counters = self.counters_for_read_array(read)
        return ok, [int(c) for c in counters]

    def counters_for_read_array(self, read) -> tuple[bool, np.ndarray]:
        """GetCountersForRead returning the raw uint32 array (no Python
        list round-trip) — the filter's bulk entry point.  Accepts str or
        ascii bytes (the filter's chunked reader passes bytes verbatim)."""
        from .tools import native_tools

        if isinstance(read, str):
            read_b = read.encode("ascii", errors="replace")
        else:
            read_b, read = bytes(read), None

        # native binned lookup over the RAW KMC2 layout for any k — the
        # reference's own query shape (signature -> bin -> prefix range ->
        # tiny suffix binary search, kmc_file.cpp:1193/1321); no row
        # materialization, no global sort
        src = getattr(self, "_binned_src", None)
        if src is None and self._sym_map is None:
            fr = getattr(self, "_ra_maps", None) or self._file_ra
            if fr is not None and fr.records is not None:
                # KMC2: signature->bin routing; KMC1 (version 0): the LUT
                # is prefix-only — sig_len 0 disables the signature chain
                src = (fr.luts, fr.sig_map
                       if self._info.version == 0x200 else np.zeros(1),
                       fr.records)
            if src is not None:
                # contiguity/dtype conversions + the fine-grained aux LUT
                # hoisted out of the per-read call (a per-call sig_map copy
                # alone costs more than the lookup)
                luts_c = np.ascontiguousarray(src[0], np.uint64)
                if len(luts_c) == (1 << (2 * self._info.lut_prefix_len)):
                    # KMC1 mmap LUTs carry no trailing record-count
                    # sentinel (read_pre_meta skips it to avoid
                    # materializing) — append it so luts[idx+1] and the
                    # aux-LUT diff are valid at the last prefix
                    luts_c = np.append(luts_c, np.uint64(fr.n_records))
                # the aux LUT build touches every record once (O(n) RAM
                # + a full pass over the suffix memmap) — fine below the
                # RA threshold, but the on-disk _file_ra mode promises
                # bounded memory at ANY database size, so it queries the
                # raw (bin, prefix) ranges directly instead
                aux, aux_bits = (
                    native_tools.build_aux_luts(luts_c, src[2])
                    if self._info.suffix_bytes >= 1
                    and getattr(self, "_ra_maps", None) is not None
                    else (None, 8))
                src = (luts_c,
                       np.ascontiguousarray(src[1], np.int32),
                       src[2], aux, aux_bits)
                self._binned_src = src
        eff_sig_len = (self._info.signature_len
                       if self._info.version == 0x200 else 0)
        if src is not None and (eff_sig_len == 0
                                or self._info.kmer_len >= eff_sig_len):
            luts, sig_map, records, aux, aux_bits = src
            counters = native_tools.counters_for_seq_binned(
                read_b,
                self._info.kmer_len, self._info.both_strands,
                sig_len=eff_sig_len, sig_map=sig_map,
                luts=luts, lut_prefix_len=self._info.lut_prefix_len,
                records=records, counter_size=self._info.counter_size,
                aux_luts=aux, aux_bits=aux_bits)
            if counters is not None:
                counters = np.where(
                    (counters >= self._min_count)
                    & (counters <= self._max_count), counters, 0)
                return True, counters
        # in-RAM sorted-array lookup (KMC1/KFF-materialized databases):
        # u64 keys for k<=32, byte rows + u64-first memcmp for k>32
        if (self._file_ra is None and self._kmers is not None
                and self._sym_map is None):
            counters = None
            if self._info.kmer_len <= 32:
                keys = self._hay_keys()
                if keys is not None and keys.dtype == np.uint64:
                    counters = native_tools.counters_for_seq(
                        read_b,
                        self._info.kmer_len, self._info.both_strands,
                        keys, self._counts, idx16=self._hay_idx16())
            else:
                counters = native_tools.counters_for_seq_wide(
                    read_b,
                    self._info.kmer_len, self._info.both_strands,
                    self._kmers, self._counts, idx16=self._rows_idx16(),
                    keys0=self._rows_keys0())
            if counters is not None:
                counters = np.where(
                    (counters >= self._min_count)
                    & (counters <= self._max_count), counters, 0)
                return True, counters
        if read is None:  # bytes caller hitting the numpy fallback
            # non-ASCII bytes become 'N' (invalid base, same semantics)
            # — a replacement-char decode would re-encode multi-byte and
            # shift every downstream window offset
            read = read_b.translate(_NON_ASCII_TO_N).decode("ascii")
        return self._counters_for_read_numpy(read)

    def _counters_for_read_numpy(self, read: str) -> tuple[bool, np.ndarray]:
        # bound the per-call transients: _batch_kmer_rows materializes
        # (n, k)-shaped window arrays, so a multi-MB read (e.g. the
        # filter's chunk-joined query falling back here) is processed in
        # overlapping slices instead of one allocation burst
        SLICE = 1 << 17
        k = self._info.kmer_len
        if len(read) > SLICE + k:
            parts = []
            ok_all = True
            for s in range(0, len(read) - k + 1, SLICE):
                ok, c = self._counters_for_read_numpy(
                    read[s:s + SLICE + k - 1])
                ok_all = ok_all and ok
                parts.append(c)
            return ok_all, (np.concatenate(parts) if parts
                            else np.zeros(0, np.uint32))
        if self._file_ra is not None:
            # on-disk RA: all the read's bin-range binary searches advance
            # together over the memmaps (the per-query semantics of the
            # reference's GetSuperKmers + per-bin lookups)
            k = self._info.kmer_len
            codes = CODE_LUT[np.frombuffer(read.upper().encode(),
                                           dtype=np.uint8)]
            n = len(codes) - k + 1
            if n <= 0:
                return True, np.zeros(0, np.uint32)
            rows, valid = _batch_kmer_rows(codes, k, self._info.both_strands)
            if self._info.version == 0x200:
                sigs = kmer_signatures_numpy(codes, k,
                                             self._info.signature_len)
            else:
                sigs = None
            counters = self._file_ra.lookup_batch(rows, sigs, valid)
            counters = np.where(
                (counters >= self._min_count) & (counters <= self._max_count),
                counters, 0)
            return True, counters
        if self._kmers is None:
            return False, np.zeros(0, np.uint32)
        k = self._info.kmer_len
        codes = CODE_LUT[np.frombuffer(read.upper().encode(), dtype=np.uint8)]
        if self._sym_map is not None:  # non-default KFF encoding
            codes = np.where(codes < 4, self._sym_map[codes & 3], codes)
        n = len(codes) - k + 1
        if n <= 0:
            return True, np.zeros(0, np.uint32)
        rows, valid = _batch_kmer_rows(codes, k, self._info.both_strands)
        idx = _searchsorted_rows(self._kmers, rows,
                                 haystack_keys=self._hay_keys())
        idx_c = np.minimum(idx, len(self._kmers) - 1)
        if len(self._kmers):
            found = (self._kmers[idx_c] == rows).all(axis=1) & (idx < len(self._kmers))
            counters = np.where(found & valid, self._counts[idx_c], 0)
        else:
            counters = np.zeros(n, np.uint32)
        counters = np.where(
            (counters >= self._min_count) & (counters <= self._max_count), counters, 0
        )
        return True, counters


def _bytes_to_codes(row: np.ndarray, k: int) -> np.ndarray:
    kb = len(row)
    codes = np.empty(kb * 4, dtype=np.uint8)
    codes[0::4] = (row >> 6) & 3
    codes[1::4] = (row >> 4) & 3
    codes[2::4] = (row >> 2) & 3
    codes[3::4] = row & 3
    return codes[kb * 4 - k :]


def _rows_to_u64(rows: np.ndarray) -> np.ndarray:
    """(N, KB<=8) big-endian rows packed into one uint64 key each
    (right-padded with zero bytes; order-preserving for equal widths)."""
    kb = rows.shape[1]
    out = np.zeros(len(rows), np.uint64)
    for j in range(kb):
        out |= rows[:, j].astype(np.uint64) << np.uint64(8 * (7 - j))
    return out


def _rows_search_keys(rows: np.ndarray):
    """Sortable 1-D key array for (N, KB) uint8 rows: native uint64 for
    KB<=8 (k<=32; numpy void-dtype comparisons are ~10x slower than scalar
    u64 compares), void records otherwise."""
    kb = rows.shape[1]
    if kb <= 8:
        return _rows_to_u64(rows)
    return np.ascontiguousarray(rows).view([("", np.uint8)] * kb).ravel()


def _searchsorted_rows(haystack: np.ndarray, needles: np.ndarray,
                       haystack_keys=None) -> np.ndarray:
    """Vectorized lexicographic searchsorted over (N, KB) uint8 rows.
    Pass haystack_keys=_rows_search_keys(haystack) to amortize the
    haystack packing across calls."""
    if haystack_keys is None:
        haystack_keys = _rows_search_keys(haystack)
    return np.searchsorted(haystack_keys, _rows_search_keys(needles))


def _batch_kmer_rows(codes: np.ndarray, k: int, both_strands: bool):
    """All k-mer rows of a read as (n, KB) bytes + validity mask."""
    n = len(codes) - k + 1
    valid = np.ones(n, dtype=bool)
    bad = codes >= 4
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    c4 = np.minimum(codes, 3).astype(np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(c4, k)
    if both_strands:
        rc = (3 - windows)[:, ::-1]
        use_rc = np.zeros(n, dtype=bool)
        decided = np.zeros(n, dtype=bool)
        for j in range(k):
            lt = rc[:, j] < windows[:, j]
            gt = rc[:, j] > windows[:, j]
            use_rc |= ~decided & lt
            decided |= lt | gt
        windows = np.where(use_rc[:, None], rc, windows)
    kb = (k + 3) // 4
    padded = np.zeros((n, kb * 4), dtype=np.uint8)
    padded[:, kb * 4 - k :] = windows
    rows = (
        (padded[:, 0::4] << 6)
        | (padded[:, 1::4] << 4)
        | (padded[:, 2::4] << 2)
        | padded[:, 3::4]
    ).astype(np.uint8)
    return rows, valid
