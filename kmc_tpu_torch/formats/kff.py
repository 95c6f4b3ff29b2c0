"""KFF v1.0 writer and reader (a copy of kmc_tpu/formats/kff.py).

Byte-compatible with KMC's KFF output (kmc_core/kff_writer.{h,cpp}).
Layout produced (all multi-byte integers big-endian):
  "KFF" ver_major ver_minor encoding unique(1) canonical(1) free_size(u32)
  'v' section: nb_vars(u64) then (name\\0 value:u64)* with k/max/data_size/ordered
  'r' sections: nb_recs(u64) then records of (k+3)//4 k-mer bytes
      (big-endian, right-aligned 2-bit) + data_size counter bytes (BE)
  'i' index section: nb_sections, (type, offset-from-index-end)*, next_index
  'v' footer: first_index/min_count/max_count/counter_size/footer_size
  "KFF"
The reader also decodes max > 1 block sections, which other tools write.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

VER_MAJOR = 1
VER_MINOR = 0
DEFAULT_ENCODING = 0b00011011  # A=0 C=1 G=2 T=3


def _be(x: int) -> bytes:
    return struct.pack(">Q", x & 0xFFFFFFFFFFFFFFFF)


def _block_n_bytes(mx: int) -> int:
    """Bytes of the per-block k-mer count: the minimal number that can
    represent the scope's `max` variable (KFF v1 raw-block rule)."""
    return max(1, (int(mx).bit_length() + 7) // 8)


class KffWriter:
    def __init__(self, path: str, canonical: bool, k: int, counter_size: int,
                 min_count: int, max_count: int, encoding: int = DEFAULT_ENCODING):
        self.k = k
        self.counter_size = counter_size
        self.min_count = min_count
        self.max_count = max_count
        self._f = open(path, "wb")
        self._index = []  # (section type byte, offset) pairs
        self._pos = 0
        self._cur_max = 1  # 'max' variable of the current scope
        self._write(b"KFF")
        self._write(bytes([VER_MAJOR, VER_MINOR, encoding, 1, 1 if canonical else 0]))
        self._write(struct.pack(">I", 0))  # free_size (u32, like KMC)
        # variables section
        self._write_vars([(b"k", k), (b"max", 1),
                          (b"data_size", counter_size), (b"ordered", 1)])

    def _write(self, data: bytes):
        self._f.write(data)
        self._pos += len(data)

    def _write_vars(self, pairs):
        self._index.append((b"v", self._pos))
        self._write(b"v")
        self._write(_be(len(pairs)))
        for name, value in pairs:
            self._write(name + b"\x00" + _be(value))

    def _scope_max(self, mx: int):
        """Declare a new variable scope when the 'max' in force differs —
        every KFF data section reads its variables from the latest 'v'."""
        if mx != self._cur_max:
            self._write_vars([(b"k", self.k), (b"max", mx),
                              (b"data_size", self.counter_size),
                              (b"ordered", 1 if mx == 1 else 0)])
            self._cur_max = mx

    def store_section(self, kmers: np.ndarray, counts: np.ndarray):
        """kmers: (N, (k+3)//4) uint8 right-aligned big-endian; counts uint32."""
        self._scope_max(1)
        self._index.append((b"r", self._pos))
        self._write(b"r")
        n = len(kmers)
        self._write(_be(n))
        if n:
            rec = np.empty((n, kmers.shape[1] + self.counter_size), dtype=np.uint8)
            rec[:, : kmers.shape[1]] = kmers
            c = np.asarray(counts, dtype=np.uint64)
            for j in range(self.counter_size):  # big-endian counter
                shift = np.uint64(8 * (self.counter_size - 1 - j))
                rec[:, kmers.shape[1] + j] = ((c >> shift) & np.uint64(0xFF)).astype(np.uint8)
            data = rec.tobytes()
            self._write(data)

    def close(self):
        nb_sections = len(self._index) + 1  # +1 footer
        index_size = 1 + 8 + nb_sections * 9 + 8
        index_start = self._pos
        index_end = self._pos + index_size
        self._write(b"i")
        self._write(_be(nb_sections))
        for sec_type, off in self._index:
            self._write(sec_type + struct.pack(">q", off - index_end))
        self._write(b"v" + struct.pack(">q", 0))  # footer
        self._write(struct.pack(">q", 0))  # next_index
        footer = [
            (b"first_index", index_start),
            (b"min_count", self.min_count),
            (b"max_count", self.max_count),
            (b"counter_size", self.counter_size),
        ]
        footer_size = 1 + 8 + sum(len(n) + 1 + 8 for n, _ in footer)
        footer_size += len(b"footer_size") + 1 + 8
        footer.append((b"footer_size", footer_size))
        self._write(b"v" + _be(len(footer)))
        for name, value in footer:
            self._write(name + b"\x00" + _be(value))
        self._write(b"KFF")
        self._f.close()


@dataclass
class KffData:
    k: int
    counter_size: int
    canonical: bool
    encoding: int
    min_count: int = 1
    max_count: int = 1 << 32
    kmers: np.ndarray = None  # (N, (k+3)//4) uint8
    counts: np.ndarray = None


@dataclass
class KffMeta:
    """KFF header + section table, no record data — lets records stream in
    bounded memory (formats/streaming.py) and supports random access
    (KMC's kff_random_access.h reads the same index)."""

    k: int
    counter_size: int
    canonical: bool
    encoding: int
    min_count: int = 1
    max_count: int = 1 << 32
    ordered: bool = False  # every 'r' section internally sorted
    # (False unless the file's variables say so — matches the reader)
    sections: list = None  # [(byte offset of first record, n_records)]
    minimizer_size: int | None = None  # 'm' variable when declared
    # minimizer sections: [(data start, nb_blocks, minimizer bytes)].
    # Displayable (kmc_tools info parity, kmc_tools.cpp:174-210) but NOT
    # decodable — KMC's own KFF db reader doesn't consume them
    # either (kff_db_reader.h:16); data paths must refuse such files.
    m_sections: list = None
    all_unique: bool = True  # header byte 6
    footer: dict = None  # footer variable k/v pairs (None when unindexed)
    # per-variable-section scopes, the CKFFInfoReader shape
    # (kff_info_reader.h:39-47): each 'v' section starts a FRESH scope (no
    # inheritance), data sections attach to the latest scope, and a scope
    # left without data sections is dropped.  Each scope is a dict
    # {k, data_size, max, m, sections: [(data_start, nb_blocks, minimizer
    # bytes)]} with None for undeclared variables.
    scopes: list = None
    max_in_block: int = 1  # largest 'max' variable over data scopes


def _read_exact(f, n):
    """Read exactly n bytes or raise ValueError (struct.error from a short
    read would escape the ValueError contract callers catch)."""
    b = f.read(n)
    if len(b) != n:
        raise ValueError("truncated KFF file")
    return b


def _read_vars(f, variables, scope_vars=None):
    (nb,) = struct.unpack(">Q", _read_exact(f, 8))
    for _ in range(nb):
        name = b""
        while True:
            ch = f.read(1)
            if not ch:
                raise ValueError("truncated KFF variable section")
            if ch == b"\x00":
                break
            name += ch
        (val,) = struct.unpack(">Q", _read_exact(f, 8))
        variables[name.decode()] = val
        if scope_vars is not None:
            scope_vars[name.decode()] = val


def read_kff_meta(path: str) -> KffMeta:
    """Walk a KFF file's section headers (variables + section table)
    without loading record payloads.

    Indexed files (a 'footer_size'-terminated footer pointing at
    'first_index', the shape both this writer and KMC's
    kff_writer.cpp:141-188 produce) are walked via the index — exactly
    KMC's CKFFInfoReader flow — so minimizer sections, whose
    block sizes the header alone doesn't determine, are recorded without
    being decoded.  Unindexed files fall back to a sequential walk,
    where an 'm' section cannot be skipped and raises."""
    import os

    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8 or head[:3] != b"KFF":
            raise ValueError("bad KFF marker")
        f.seek(size - 3)
        if f.read(3) != b"KFF":  # same contract as read_kff: a file
            raise ValueError("bad KFF markers")  # truncated before any
        f.seek(8)  # section must not parse as a valid empty database
        encoding = head[5]
        all_unique = bool(head[6])
        canonical = bool(head[7])
        (free_size,) = struct.unpack(">I", _read_exact(f, 4))
        f.seek(free_size, 1)
        first_section = f.tell()
        variables = {"max": 1, "data_size": 0, "k": 0}
        sections = []
        m_sections = []
        scopes = []
        max_in_block = 1

        def new_scope(svars):
            # each 'v' starts a FRESH scope; an immediately preceding
            # scope with no data sections is dropped (kff_info_reader.cpp:
            # 228-233)
            if scopes and not scopes[-1]["sections"]:
                scopes.pop()
            scopes.append({"k": svars.get("k"),
                           "data_size": svars.get("data_size"),
                           "max": svars.get("max"),
                           "m": svars.get("m"),
                           "sections": []})

        def read_r(indexed):
            nonlocal max_in_block
            (nb,) = struct.unpack(">Q", _read_exact(f, 8))
            mx = variables.get("max", 1)
            if mx != 1:
                max_in_block = max(max_in_block, mx)
                if not indexed:
                    # block sizes are data-dependent: walk them (n on
                    # minimal-for-max bytes, then sequence + data)
                    n_bytes = _block_n_bytes(mx)
                    k = variables["k"]
                    ds = variables["data_size"]
                    if scopes:
                        scopes[-1]["sections"].append((f.tell(), nb, b""))
                    for _ in range(nb):
                        n = int.from_bytes(_read_exact(f, n_bytes), "big")
                        if not 1 <= n <= mx:
                            raise ValueError("bad KFF block size")
                        f.seek((k + n - 1 + 3) // 4 + n * ds, 1)
                    return nb
            else:
                sections.append((f.tell(), nb))
            if scopes:
                scopes[-1]["sections"].append((f.tell(), nb, b""))
            return nb

        def read_m():
            mb = (int(variables.get("m", 0)) + 3) // 4
            mini = _read_exact(f, mb)
            (nb,) = struct.unpack(">Q", _read_exact(f, 8))
            m_sections.append((f.tell(), nb, mini))
            if scopes:
                scopes[-1]["sections"].append((f.tell(), nb, mini))

        # -- indexed walk (KMC's CKFFInfoReader flow) --
        positions, footer = _index_positions(f, size)
        if positions is not None:
            for pos in positions:
                f.seek(pos)
                sec = f.read(1)
                if sec == b"v":
                    svars = {}
                    _read_vars(f, variables, svars)
                    new_scope(svars)
                elif sec == b"r":
                    read_r(indexed=True)
                elif sec == b"m":
                    read_m()
                elif sec == b"i":
                    continue
                else:
                    raise ValueError(f"unknown KFF section {sec!r}")
        else:
            f.seek(first_section)  # the index probe moved the cursor
            end = size - 3
            while f.tell() < end:
                sec = f.read(1)
                if sec == b"v":
                    svars = {}
                    _read_vars(f, variables, svars)
                    new_scope(svars)
                elif sec == b"r":
                    nb = read_r(indexed=False)
                    if variables.get("max", 1) == 1:
                        kb = (variables["k"] + 3) // 4
                        f.seek(nb * (kb + variables["data_size"]), 1)
                    # max>1: read_r walked (and consumed) the blocks
                elif sec == b"i":
                    (nb,) = struct.unpack(">Q", _read_exact(f, 8))
                    f.seek(nb * 9 + 8, 1)
                elif sec == b"m":
                    raise NotImplementedError(
                        "KFF minimizer section in an unindexed file")
                else:
                    raise ValueError(f"unknown KFF section {sec!r}")
        if scopes and not scopes[-1]["sections"]:
            scopes.pop()
    return KffMeta(
        k=variables["k"],
        counter_size=variables["data_size"],
        canonical=canonical,
        encoding=encoding,
        min_count=variables.get("min_count", 1),
        max_count=variables.get("max_count", 1 << 32),
        ordered=bool(variables.get("ordered", 0)),
        sections=sections,
        minimizer_size=int(variables["m"]) if "m" in variables else None,
        m_sections=m_sections,
        all_unique=all_unique,
        footer=footer,
        scopes=scopes,
        max_in_block=max_in_block,
    )


def _index_positions(f, size):
    """(positions, footer_vars): absolute positions of every data section,
    from the footer's first_index and the index-section chain (entries are
    offsets relative to the index END, reference kff_writer.cpp:159);
    (None, None) when the file has no parseable footer/index."""
    try:
        if size < 3 + 8:
            return None, None
        f.seek(size - 3 - 8)
        (footer_size,) = struct.unpack(">Q", f.read(8))
        footer_pos = size - 3 - footer_size
        if not (0 < footer_pos < size):
            return None, None
        f.seek(footer_pos)
        if f.read(1) != b"v":
            return None, None
        fvars = {}
        _read_vars(f, fvars)
        idx = int(fvars["first_index"])
        positions = []
        seen = set()
        while 0 < idx < size:
            if idx in seen:  # malformed index cycle
                return None, None
            seen.add(idx)
            f.seek(idx)
            if f.read(1) != b"i":
                return None, None
            (nb,) = struct.unpack(">Q", f.read(8))
            if nb > size // 9:
                return None, None
            entries = [struct.unpack(">cq", f.read(9)) for _ in range(nb)]
            (next_rel,) = struct.unpack(">q", f.read(8))
            index_end = f.tell()
            for _t, rel in entries:
                positions.append(index_end + rel)
            idx = index_end + next_rel if next_rel else 0
    except (struct.error, KeyError, UnicodeDecodeError, ValueError, OSError):
        return None, None
    # a footer whose first_index is 0/garbage yields no entries — treat as
    # unindexed (sequential walk) rather than as a valid empty database
    return (positions, fvars) if positions else (None, None)


def _walk_blocks(raw, pos, nb, k, mx, data_size):
    """Sequential walk over a max>1 raw-block section (sizes are
    data-dependent): per-block (seq offset, n), and the end position."""
    n_bytes = _block_n_bytes(mx)
    offs = np.empty(nb, np.int64)
    ns = np.empty(nb, np.int64)
    for i in range(nb):
        n = int.from_bytes(raw[pos:pos + n_bytes], "big")
        if not 1 <= n <= mx:
            raise ValueError(f"KFF block holds {n} k-mers, max is {mx}")
        pos += n_bytes
        offs[i] = pos
        ns[i] = n
        s = k + n - 1
        pos += (s + 3) // 4 + n * data_size
        if pos > len(raw):
            raise ValueError("truncated KFF block section")
    return offs, ns, pos


def _decode_block_section(raw, pos, nb, k, mx, data_size):
    """Expand a max>1 raw-block section into per-k-mer rows — the KFF
    compact representation (n on minimal-for-max bytes, then the
    right-aligned 2-bit packed k+n-1 base sequence, then n*data_size
    counter bytes).  KMC's KFF reader refuses these files
    (kff_db_reader.h:16); decoding them extends KMC.
    Returns (end position, (N, ceil(k/4)) uint8 rows in the FILE's
    symbol space, (N,) uint32 counts)."""
    kb = (k + 3) // 4
    if nb == 0:
        return pos, np.zeros((0, kb), np.uint8), np.zeros(0, np.uint32)
    offs, ns, end = _walk_blocks(raw, pos, nb, k, mx, data_size)
    buf = np.frombuffer(raw, np.uint8)
    ss = k + ns - 1             # bases per block
    sbs = (ss + 3) // 4         # sequence bytes per block
    pads = sbs * 4 - ss         # pad symbols at the FRONT of each block
    # gather every sequence byte, expand to 2-bit symbols
    byte_idx = np.repeat(offs, sbs)
    within = np.arange(len(byte_idx), dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(sbs)[:-1]]), sbs)
    seq_bytes = buf[byte_idx + within]
    codes4 = np.empty((len(seq_bytes), 4), np.uint8)
    codes4[:, 0] = seq_bytes >> 6
    codes4[:, 1] = (seq_bytes >> 4) & 3
    codes4[:, 2] = (seq_bytes >> 2) & 3
    codes4[:, 3] = seq_bytes & 3
    codes = codes4.reshape(-1)  # 4*sum(sbs) symbols incl. per-block pads
    # per-k-mer gather: k-mer t of block i = codes[code_base[i]+pad[i]+t : +k]
    code_base = np.concatenate([[0], np.cumsum(sbs * 4)[:-1]])
    kmer_start = np.repeat(code_base + pads, ns)
    t_within = np.arange(int(ns.sum()), dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(ns)[:-1]]), ns)
    starts = kmer_start + t_within
    windows = codes[starts[:, None] + np.arange(k, dtype=np.int64)]
    padded = np.zeros((len(starts), kb * 4), np.uint8)
    padded[:, kb * 4 - k:] = windows
    rows = ((padded[:, 0::4] << 6) | (padded[:, 1::4] << 4)
            | (padded[:, 2::4] << 2) | padded[:, 3::4]).astype(np.uint8)
    if data_size:
        data_off = offs + sbs  # counters follow each block's sequence
        c_start = np.repeat(data_off, ns) + t_within * data_size
        counts = np.zeros(len(starts), np.uint64)
        for j in range(data_size):
            counts = (counts << np.uint64(8)) | buf[c_start + j]
        counts = counts.astype(np.uint32)
    else:
        counts = np.ones(len(starts), np.uint32)
    return end, rows, counts


def read_kff(path: str) -> KffData:
    """Read a KFF file; max=1 records (the shape KMC and this
    framework produce) AND max>1 block sections (which KMC's
    own KFF reader refuses, kff_db_reader.h:16) are both decoded."""
    raw = open(path, "rb").read()
    if raw[:3] != b"KFF" or raw[-3:] != b"KFF":
        raise ValueError("bad KFF markers")
    encoding = raw[5]
    canonical = bool(raw[7])
    pos = 8
    (free_size,) = struct.unpack_from(">I", raw, pos)
    pos += 4 + free_size
    variables = {"max": 1, "data_size": 0, "k": 0}
    kmer_chunks = []
    count_chunks = []

    def read_vars(pos):
        (nb,) = struct.unpack_from(">Q", raw, pos)
        pos += 8
        for _ in range(nb):
            end = raw.index(b"\x00", pos)
            name = raw[pos:end].decode()
            (val,) = struct.unpack_from(">Q", raw, end + 1)
            variables[name] = val
            pos = end + 9
        return pos

    while pos < len(raw) - 3:
        sec = raw[pos : pos + 1]
        pos += 1
        if sec == b"v":
            pos = read_vars(pos)
        elif sec == b"r":
            (nb,) = struct.unpack_from(">Q", raw, pos)
            pos += 8
            k = variables["k"]
            max_per_block = variables.get("max", 1)
            data_size = variables["data_size"]
            if max_per_block != 1:
                pos, km, ct = _decode_block_section(
                    raw, pos, nb, k, max_per_block, data_size)
                kmer_chunks.append(km)
                count_chunks.append(ct)
                continue
            kb = (k + 3) // 4
            rec = kb + data_size
            arr = np.frombuffer(raw, np.uint8, count=nb * rec, offset=pos).reshape(nb, rec)
            kmer_chunks.append(arr[:, :kb])
            c = np.zeros(nb, np.uint64)
            for j in range(data_size):
                c = (c << np.uint64(8)) | arr[:, kb + j].astype(np.uint64)
            count_chunks.append(c.astype(np.uint32) if data_size else np.ones(nb, np.uint32))
            pos += nb * rec
        elif sec == b"i":
            (nb,) = struct.unpack_from(">Q", raw, pos)
            pos += 8 + nb * 9 + 8
        elif sec == b"m":
            raise NotImplementedError("KFF minimizer sections not supported")
        else:
            raise ValueError(f"unknown KFF section {sec!r} at {pos-1}")
    k = variables["k"]
    kb = (k + 3) // 4
    kmers = (
        np.concatenate(kmer_chunks) if kmer_chunks else np.zeros((0, kb), np.uint8)
    )
    counts = (
        np.concatenate(count_chunks) if count_chunks else np.zeros(0, np.uint32)
    )
    return KffData(
        k=k,
        counter_size=variables["data_size"],
        canonical=canonical,
        encoding=encoding,
        min_count=variables.get("min_count", 1),
        max_count=variables.get("max_count", 1 << 32),
        kmers=kmers.copy(),
        counts=counts,
    )
