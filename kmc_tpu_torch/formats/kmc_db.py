"""KMC database (.kmc_pre / .kmc_suf) writers and readers.

The port's copy of kmc_tpu/formats/kmc_db.py, byte-compatible with KMC's
layouts:
  * KMC2 (version 0x200; kb_completer.cpp:117-326 writes it,
    kmc_api/kmc_file.cpp:184-260 reads it): the device completer emits
    the record bytes and the per-(bin, prefix) LUT counts in one piece
    (write_all_records), the host-bucket route one bin at a time
    (put_bin);
  * KMC1 (version 0x0; the small-k completer, kb_completer.h:199-305):
    write_kmc1_db.
The readers (read_pre_meta, read_db -> KmcDb, sorted_records) take both
versions, whichever package wrote them (kmc_api/kmc_file.cpp:184-260).
A batch of k-mers is a (N, KB) uint8 array, KB = ceil(k/4), holding the
2-bit packed k-mer as a big-endian, right-aligned integer, so the on-disk
suffix is its trailing suffix_bytes columns.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

PRE_MARKER = b"KMCP"
SUF_MARKER = b"KMCS"
KMC2_VER = 0x200
KMC1_VER = 0x0


@dataclass
class DbInfo:
    """Database parameters (mirrors CKMCFile::Info, kmc_api/kmc_file.h:198)."""

    kmer_len: int
    mode: int = 0
    counter_size: int = 1
    lut_prefix_len: int = 0
    signature_len: int = 0
    cutoff_min: int = 2
    cutoff_max: int = 1_000_000_000
    n_unique_stored: int = 0  # k-mers within [cutoff_min, cutoff_max]
    both_strands: bool = True
    # 2-bit symbol for each of A,C,G,T (KMC databases are always A->0 C->1
    # G->2 T->3)
    encoding: int = 0b00011011
    version: int = KMC2_VER
    n_bins: int = 0
    n_unique: int = 0
    n_below_min: int = 0
    n_above_max: int = 0
    n_total: int = 0

    @property
    def suffix_bytes(self) -> int:
        return (self.kmer_len - self.lut_prefix_len) // 4

    @property
    def record_bytes(self) -> int:
        return self.suffix_bytes + self.counter_size

    @property
    def kmer_bytes(self) -> int:
        return (self.kmer_len + 3) // 4


def kmer_bytes_to_prefix_ids(kmers: np.ndarray, k: int,
                             lut_prefix_len: int) -> np.ndarray:
    """Big-endian integer value of the prefix columns of (N, KB) k-mer
    bytes."""
    suffix_bytes = (k - lut_prefix_len) // 4
    kb = kmers.shape[1]
    pre = kmers[:, : kb - suffix_bytes].astype(np.uint64)
    out = np.zeros(len(kmers), dtype=np.uint64)
    for j in range(pre.shape[1]):
        out = (out << np.uint64(8)) | pre[:, j]
    return out


def pick_lut_prefix_len(k: int, n_bins: int, n_est_unique: int,
                        kmc1: bool = False) -> int:
    """LUT prefix length minimizing LUT + suffix bytes.

    KMC2: kmc.h:1450-1467 (lut_prefix_len in [2, 15], suffix % 4 == 0,
    n_bins LUTs).  KMC1 small-k: kmc.h:905-939 (lut_prefix_len in [1, 15],
    one LUT, the suffix may be empty)."""
    best_len = 0
    best_mem = 1 << 62
    for lpl in range(1 if kmc1 else 2, 16):
        if kmc1:
            suffix_len = 0 if lpl > k else k - lpl
        else:
            if lpl > k:
                continue
            suffix_len = k - lpl
        if suffix_len % 4:
            continue
        if kmc1:
            est_suf_mem = n_est_unique * (suffix_len // 4)
            lut_mem = (1 << (2 * lpl)) * 8
        else:
            est_suf_mem = n_est_unique * suffix_len // 4
            lut_mem = n_bins * (1 << (2 * lpl)) * 8
        if est_suf_mem + lut_mem < best_mem:
            best_len = lpl
            best_mem = est_suf_mem + lut_mem
    return best_len


def _records(kmers: np.ndarray, counts, suffix_bytes: int,
             counter_size: int) -> np.ndarray:
    """(N, suffix_bytes + counter_size) on-disk records: the k-mers' last
    suffix_bytes bytes, then the little-endian counter."""
    rec = np.empty((len(kmers), suffix_bytes + counter_size), dtype=np.uint8)
    rec[:, :suffix_bytes] = kmers[:, kmers.shape[1] - suffix_bytes:]
    c = np.asarray(counts, dtype=np.uint64)
    for j in range(counter_size):
        rec[:, suffix_bytes + j] = ((c >> np.uint64(8 * j))
                                    & np.uint64(0xFF)).astype(np.uint8)
    return rec


class Kmc2DbWriter:
    """Writer for a KMC2 database.  Records arrive either in one piece
    (write_all_records), already in final (bin, k-mer) order, or one bin
    at a time in increasing bin order (put_bin, KMC's completer order,
    kb_completer.cpp:130-222); close() emits the bins never put, empty."""

    def __init__(self, path_prefix: str, info: DbInfo, sig_map_bins: np.ndarray):
        """sig_map_bins: int32 array (4^sig_len + 1) mapping signature ->
        bin id (-1 for unused signatures)."""
        self.info = info
        self.path_prefix = str(path_prefix)
        self._sig_map_bins = np.asarray(sig_map_bins)
        self._sig_map_out = np.zeros(len(sig_map_bins), dtype=np.uint32)
        self._n_recs = 0  # running record count (cumulative LUT base)
        self._lut_pos = 0
        self._next_bin = 0
        self._lut_size = 1 << (2 * info.lut_prefix_len)
        self._pre = open(self.path_prefix + ".kmc_pre", "wb")
        self._suf = open(self.path_prefix + ".kmc_suf", "wb")
        self._pre.write(PRE_MARKER)
        self._suf.write(SUF_MARKER)
        self.n_unique = 0
        self.n_below_min = 0
        self.n_above_max = 0
        self.n_total = 0

    def write_all_records(self, rec: np.ndarray, lut_counts: np.ndarray):
        """rec = (N, record_bytes) suffix+counter bytes in final order and
        cutoff-filtered; lut_counts = uint64[n_bins << 2*lpl] records per
        (bin, prefix).  Must be the only write call; close() afterwards."""
        if self._next_bin or self._n_recs:
            raise RuntimeError("write_all_records must be the only write")
        np.ascontiguousarray(rec, dtype=np.uint8).tofile(self._suf)
        lut_counts = np.asarray(lut_counts, dtype=np.uint64)
        shifted = np.empty_like(lut_counts)
        shifted[0] = 0
        np.cumsum(lut_counts[:-1], out=shifted[1:])
        shifted.astype("<u8").tofile(self._pre)
        self._n_recs = len(rec)
        self._lut_pos = self._next_bin = self.info.n_bins
        # every bin is emitted in order, so the LUT index equals the bin id
        valid = self._sig_map_bins >= 0
        self._sig_map_out = np.where(valid, self._sig_map_bins, 0).astype(np.uint32)

    def put_bin(self, bin_id: int, kmers: np.ndarray, counts: np.ndarray,
                stats=None):
        """kmers: (N, KB) uint8 sorted ascending; counts: (N,) clamped to
        counter_max; both already cutoff-filtered.  Empty bins in [next,
        bin_id) are emitted first.  stats: the bin's n_unique,
        n_below_min, n_above_max and n_total, added to the writer's."""
        while self._next_bin < bin_id:
            self._put_one(self._next_bin, None, None)
        self._put_one(bin_id, kmers, counts)
        if stats is not None:
            self.n_unique += stats["n_unique"]
            self.n_below_min += stats["n_below_min"]
            self.n_above_max += stats["n_above_max"]
            self.n_total += stats["n_total"]

    def _put_one(self, bin_id, kmers, counts):
        info = self.info
        if kmers is None or len(kmers) == 0:
            lut = np.zeros(self._lut_size, dtype=np.uint64)
        else:
            prefix_ids = kmer_bytes_to_prefix_ids(kmers, info.kmer_len,
                                                  info.lut_prefix_len)
            lut = np.bincount(prefix_ids.astype(np.int64),
                              minlength=self._lut_size).astype(np.uint64)
            _records(kmers, counts, info.suffix_bytes,
                     info.counter_size).tofile(self._suf)
        # per-prefix counts -> running cumulative offsets
        shifted = np.empty_like(lut)
        shifted[0] = 0
        np.cumsum(lut[:-1], out=shifted[1:])
        shifted += np.uint64(self._n_recs)
        self._n_recs += int(lut.sum())
        shifted.astype("<u8").tofile(self._pre)
        self._sig_map_out[self._sig_map_bins == bin_id] = self._lut_pos
        self._lut_pos += 1
        self._next_bin = bin_id + 1

    def close(self):
        info = self.info
        while self._next_bin < info.n_bins:
            self._put_one(self._next_bin, None, None)
        self._suf.write(SUF_MARKER)
        self._suf.close()
        pre = self._pre
        pre.write(struct.pack("<Q", self._n_recs))
        self._sig_map_out.astype("<u4").tofile(pre)
        n_unique_stored = self.n_unique - self.n_below_min - self.n_above_max
        header = struct.pack(
            "<IIIIIIIQB",
            info.kmer_len,
            info.mode,
            info.counter_size,
            info.lut_prefix_len,
            info.signature_len,
            info.cutoff_min,
            info.cutoff_max & 0xFFFFFFFF,
            n_unique_stored,
            0 if info.both_strands else 1,
        )
        header += b"\x00" * 27
        header += struct.pack("<I", KMC2_VER)
        pre.write(header)
        pre.write(struct.pack("<I", len(header)))  # header_offset = 68
        pre.write(PRE_MARKER)
        pre.close()


def write_kmc1_db(path_prefix: str, info: DbInfo, kmers: np.ndarray,
                  counts: np.ndarray):
    """Write a KMC1 (version 0) database from globally sorted records
    (CSmallKCompleter::CompleteKMCFormat, kb_completer.h:199-305, and
    kmc_tools' CKMC1DbWriter)."""
    lut_size = 1 << (2 * info.lut_prefix_len)
    suffix_bytes = (info.kmer_len - info.lut_prefix_len) // 4
    with open(path_prefix + ".kmc_suf", "wb") as suf:
        suf.write(SUF_MARKER)
        if len(kmers):
            _records(kmers, counts, suffix_bytes, info.counter_size).tofile(suf)
        suf.write(SUF_MARKER)
    with open(path_prefix + ".kmc_pre", "wb") as pre:
        pre.write(PRE_MARKER)
        hist = np.zeros(lut_size, dtype=np.uint64)
        if len(kmers):
            prefix_ids = kmer_bytes_to_prefix_ids(kmers, info.kmer_len,
                                                  info.lut_prefix_len)
            hist = np.bincount(prefix_ids.astype(np.int64),
                               minlength=lut_size).astype(np.uint64)
        lut = np.zeros(lut_size, dtype=np.uint64)
        np.cumsum(hist[:-1], out=lut[1:])
        lut.astype("<u8").tofile(pre)
        header = struct.pack(
            "<IIIIIIQB",
            info.kmer_len,
            info.mode,
            info.counter_size,
            info.lut_prefix_len,
            info.cutoff_min,
            info.cutoff_max & 0xFFFFFFFF,
            len(kmers),
            0 if info.both_strands else 1,
        )
        header += b"\x00" * 3
        header += struct.pack("<I", (info.cutoff_max >> 32) & 0xFFFFFFFF)
        header += b"\x00" * 20
        header += struct.pack("<I", KMC1_VER)
        pre.write(header)
        pre.write(struct.pack("<I", len(header)))  # 64
        pre.write(PRE_MARKER)


@dataclass
class KmcDb:
    """A fully materialized KMC database (both versions) for tools/API use."""

    info: DbInfo
    luts: np.ndarray  # uint64, (n_luts * 4^lpl + 1,) cumulative, sentinel at end
    sig_map: np.ndarray | None  # uint32 (4^sig_len+1,) -> lut index, KMC2 only
    records: np.ndarray  # (n_recs, record_bytes) uint8 raw suffix+counter

    @property
    def n_records(self) -> int:
        return len(self.records)

    def counters(self) -> np.ndarray:
        """Decode per-record counters (little-endian; 1 when counter_size==0)."""
        cs = self.info.counter_size
        if cs == 0:
            return np.ones(self.n_records, dtype=np.uint32)
        c = np.zeros(self.n_records, dtype=np.uint64)
        sb = self.info.suffix_bytes
        for j in range(cs - 1, -1, -1):
            c = (c << np.uint64(8)) | self.records[:, sb + j].astype(np.uint64)
        return c.astype(np.uint32)

    def kmers_bytes(self) -> np.ndarray:
        """Reconstruct (n_recs, KB) uint8 right-aligned big-endian k-mers."""
        info = self.info
        n = self.n_records
        kb = info.kmer_bytes
        sb = info.suffix_bytes
        out = np.zeros((n, kb), dtype=np.uint8)
        if sb:
            out[:, kb - sb :] = self.records[:, :sb]
        # prefix per record: invert the cumulative LUT
        lut_idx = (np.searchsorted(self.luts, np.arange(n, dtype=np.uint64), side="right") - 1).astype(np.uint64)
        prefix = lut_idx & np.uint64((1 << (2 * info.lut_prefix_len)) - 1)
        for j in range(kb - sb - 1, -1, -1):
            out[:, j] = (prefix & np.uint64(0xFF)).astype(np.uint8)
            prefix = prefix >> np.uint64(8)
        return out

    def bin_ids(self) -> np.ndarray:
        """Per-record lut (bin) index."""
        lut_idx = (np.searchsorted(self.luts, np.arange(self.n_records, dtype=np.uint64), side="right") - 1).astype(np.uint64)
        return (lut_idx >> np.uint64(2 * self.info.lut_prefix_len)).astype(np.int64)


def _check_header_fields(kmer_len, mode, counter_size, lut_prefix_len,
                         signature_len):
    """Range checks on .kmc_pre header fields (corrupted values otherwise
    drive absurd allocations or effectively-unbounded loops downstream —
    the reference's readers bound these the same way via its parameter
    validation ranges, kmc_runner.cpp:189-258)."""
    if not 1 <= kmer_len <= 256:
        raise ValueError(f"bad .kmc_pre header (k={kmer_len})")
    if mode not in (0, 1):
        raise ValueError(f"bad .kmc_pre header (mode={mode})")
    if not 0 <= counter_size <= 8:
        raise ValueError(f"bad .kmc_pre header (counter_size={counter_size})")
    if not 0 <= lut_prefix_len <= 16 or lut_prefix_len > kmer_len:
        raise ValueError(
            f"bad .kmc_pre header (lut_prefix_len={lut_prefix_len})")
    if signature_len is not None and not 5 <= signature_len <= 11:
        raise ValueError(
            f"bad .kmc_pre header (signature_len={signature_len})")


def read_pre_meta(path_prefix: str, mmap_luts: bool = False):
    """Parse a .kmc_pre file: (info, luts, sig_map) — no .kmc_suf access.
    By default the LUTs load into RAM like the reference's CKMC2DbReader
    (kmc_tools/kmc2_db_reader.h:523); with mmap_luts=True they stay a
    np.memmap view so LUT memory is demand-paged (the listing-mode
    analogue of CPrefixFileBufferForListingMode, kmc_api/kmc_file.h:36-96);
    records can then stream in bounded memory (formats/streaming.py)."""
    p = Path(path_prefix + ".kmc_pre")
    size = p.stat().st_size
    with open(p, "rb") as f:
        if size < 16 or f.read(4) != PRE_MARKER:
            raise ValueError("bad .kmc_pre markers")
        f.seek(size - 12)
        version, header_offset, marker = struct.unpack("<II4s", f.read(12))
        if marker != PRE_MARKER:
            raise ValueError("bad .kmc_pre markers")
        hstart = size - 8 - header_offset
        # corrupted header_offset: too small for any header layout, or the
        # header block would overlap the leading marker
        if header_offset < 40 or hstart < 4:
            raise ValueError("bad .kmc_pre header offset")
        f.seek(hstart)
        hdr = f.read(header_offset)

        def _lut_at(offset, count):
            if mmap_luts:
                return np.memmap(p, dtype="<u8", mode="r", offset=offset,
                                 shape=(count,))
            f.seek(offset)
            return np.frombuffer(f.read(count * 8), dtype="<u8").copy()

        if version == KMC2_VER:
            (kmer_len, mode, counter_size, lut_prefix_len, signature_len,
             cutoff_min, cutoff_max, n_unique_stored) = struct.unpack_from(
                "<IIIIIIIQ", hdr, 0)
            both_flag = hdr[36]
            _check_header_fields(kmer_len, mode, counter_size,
                                 lut_prefix_len, signature_len)
            sig_map_size = (1 << (2 * signature_len)) + 1
            sig_map_start = hstart - sig_map_size * 4
            if sig_map_start < 4 + 8:
                raise ValueError("bad .kmc_pre layout (sig_map overlap)")
            f.seek(sig_map_start)
            sig_map = np.frombuffer(f.read(sig_map_size * 4), dtype="<u4").copy()
            # lut area includes the trailing n_recs uint64
            luts = _lut_at(4, (sig_map_start - 4) // 8)
            n_luts = (len(luts) - 1) >> (2 * lut_prefix_len)
            if n_luts < 1 or (n_luts << (2 * lut_prefix_len)) != len(luts) - 1:
                raise ValueError("bad .kmc_pre layout (LUT area size)")
        elif version == KMC1_VER:
            (kmer_len, mode, counter_size, lut_prefix_len,
             cutoff_min, cutoff_max_lo, n_unique_stored) = struct.unpack_from(
                "<IIIIIIQ", hdr, 0)
            both_flag = hdr[32]
            cutoff_max_hi = struct.unpack_from("<I", hdr, 36)[0]
            cutoff_max = cutoff_max_lo | (cutoff_max_hi << 32)
            signature_len = 0
            sig_map = None
            _check_header_fields(kmer_len, mode, counter_size,
                                 lut_prefix_len, None)
            lut_size = 1 << (2 * lut_prefix_len)
            if 4 + lut_size * 8 > hstart:
                raise ValueError("bad .kmc_pre layout (LUT overlap)")
            if mmap_luts:
                # no appended n_recs sentinel (would force materializing);
                # consumers take the record count from info.n_unique_stored
                luts = _lut_at(4, lut_size)
            else:
                luts = np.empty(lut_size + 1, dtype=np.uint64)
                luts[:lut_size] = _lut_at(4, lut_size)
                luts[lut_size] = n_unique_stored
            n_luts = 1
        else:
            raise ValueError(
                f"unsupported KMC database version 0x{version:x}")

    info = DbInfo(
        kmer_len=kmer_len,
        mode=mode,
        counter_size=counter_size,
        lut_prefix_len=lut_prefix_len,
        signature_len=signature_len,
        cutoff_min=cutoff_min,
        cutoff_max=cutoff_max,
        n_unique_stored=n_unique_stored,
        both_strands=(both_flag == 0),
        version=version,
        n_bins=n_luts,
    )
    return info, luts, sig_map


def read_db(path_prefix: str) -> KmcDb:
    """Read an entire KMC1/KMC2 database into memory."""
    info, luts, sig_map = read_pre_meta(path_prefix)
    suf_raw = Path(path_prefix + ".kmc_suf").read_bytes()
    if suf_raw[:4] != SUF_MARKER or suf_raw[-4:] != SUF_MARKER:
        raise ValueError("bad .kmc_suf markers")
    rec_size = info.record_bytes
    body = suf_raw[4:-4]
    if rec_size == 0:
        records = np.zeros((info.n_unique_stored, 0), dtype=np.uint8)
    else:
        if len(body) != info.n_unique_stored * rec_size:
            raise ValueError(
                ".kmc_suf size does not match the header's record count")
        n_recs = len(body) // rec_size
        records = np.frombuffer(body, dtype=np.uint8, count=n_recs * rec_size).reshape(n_recs, rec_size).copy()
    return KmcDb(info=info, luts=luts, sig_map=sig_map, records=records)


def row_sort_order(kmers: np.ndarray) -> np.ndarray:
    """Lexicographic sort order of (N, KB) byte rows via packed u64 keys:
    ceil(KB/8) u64 lexsort passes instead of KB u8 passes (measured 5x on
    a KB=14 / 8.4 M-row database)."""
    kb = kmers.shape[1]
    keys = []
    for off in range(0, kb, 8):
        w = min(8, kb - off)
        col = np.zeros(len(kmers), np.uint64)
        for j in range(w):
            col = (col << np.uint64(8)) | kmers[:, off + j]
        keys.append(col)
    if len(keys) == 1:
        return np.argsort(keys[0], kind="stable")
    return np.lexsort(tuple(reversed(keys)))


def sorted_records(db: KmcDb):
    """Return (kmers_bytes, counts) in global ascending k-mer order.

    KMC2 stores bins independently sorted; a global order needs a merge
    (CKMC2DbReader, kmc_tools/kmc2_db_reader.h:400-560).  We reconstruct all
    k-mers and sort by packed u64 keys — fine for in-memory tools.
    """
    kmers = db.kmers_bytes()
    counts = db.counters()
    if db.info.version == KMC2_VER and db.info.n_bins > 1:
        order = row_sort_order(kmers)
        kmers = kmers[order]
        counts = counts[order]
    return kmers, counts


def kmer_char_matrix(kmers: np.ndarray, k: int) -> np.ndarray:
    """Decode (N, KB) right-aligned big-endian k-mer bytes to an (N, k)
    uint8 matrix of ACGT characters."""
    kb = kmers.shape[1]
    # per-byte 4-symbol decode, then cut the left padding
    lut = np.empty((256, 4), dtype=np.uint8)
    b = np.arange(256, dtype=np.uint16)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    for j in range(4):
        lut[:, j] = acgt[(b >> (2 * (3 - j))) & 3]
    chars = lut[kmers].reshape(len(kmers), kb * 4)
    pad = kb * 4 - k
    return np.ascontiguousarray(chars[:, pad:])


def kmers_bytes_to_strings(kmers: np.ndarray, k: int) -> list[str]:
    """Decode (N, KB) right-aligned big-endian k-mer bytes to ACGT strings."""
    if len(kmers) == 0:
        return []
    flat = kmer_char_matrix(kmers, k).tobytes().decode("ascii")
    return [flat[i * k : (i + 1) * k] for i in range(len(kmers))]
