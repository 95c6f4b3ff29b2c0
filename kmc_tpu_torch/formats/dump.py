"""Text dump of a KMC database (kmc_tools transform dump equivalent); the
port's copy of kmc_tpu/formats/dump.py.

Format: one `KMER\\tCOUNT\\n` line per stored k-mer, in ascending k-mer order
(reference: kmc_tools/dump_writer.h:120-160,241).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .kmc_db import KmcDb, kmers_bytes_to_strings, read_db, sorted_records

DEFAULT_ENCODING = 0b00011011  # A->0 C->1 G->2 T->3


@lru_cache(maxsize=None)
def _char_lut32(encoding: int = DEFAULT_ENCODING) -> np.ndarray:
    """256-entry LUT: the 4 base chars of one 2-bit-packed byte, packed into
    a little-endian uint32 so the whole decode is ONE flat gather.  The
    symbol->char map comes from the database's encoding byte (the
    reference's DumpOpt, dump_writer.h:85-94: bits 7..6 are A's symbol,
    5..4 C's, 3..2 G's, 1..0 T's)."""
    syms = ((encoding >> 6) & 3, (encoding >> 4) & 3,
            (encoding >> 2) & 3, encoding & 3)
    if sorted(syms) != [0, 1, 2, 3]:
        raise ValueError(f"encoding {encoding:#010b} is not a permutation "
                         "of the four 2-bit symbols")
    codes = bytearray(4)
    for sym, ch in zip(syms, b"ACGT"):
        codes[sym] = ch
    lut = np.zeros(256, np.uint32)
    chars = np.frombuffer(bytes(codes), np.uint8)
    b = np.arange(256, dtype=np.uint32)
    for j in range(4):
        lut |= chars[(b >> (2 * (3 - j))) & 3].astype(np.uint32) << (8 * j)
    lut.setflags(write=False)
    return lut


def dump_records_bytes(kmers: np.ndarray, counts: np.ndarray, k: int,
                       chunk_rows: int = 1 << 20,
                       encoding: int = DEFAULT_ENCODING):
    """Yield the dump text as ASCII byte chunks — vectorized line assembly
    (the reference's dump hot loop, dump_writer.h:120-160, is a tight byte
    writer; a per-row Python f-string join is far slower at millions of
    rows).  Rows are built in a fixed-width byte matrix
    `[kmer k][\\t][gap][digits][\\n]` with counts right-aligned and the gap
    bytes NUL-filled, then one C-level translate() pass strips the gaps;
    memory stays bounded by chunking."""
    counts = np.asarray(counts)
    n = len(counts)
    kb = kmers.shape[1]
    pad = kb * 4 - k
    lut = _char_lut32(encoding)
    for i in range(0, n, chunk_rows):
        c = counts[i : i + chunk_rows].astype(np.uint64)
        m = len(c)
        maxd = len(str(int(c.max())))
        width = k + 2 + maxd
        buf = np.empty((m, width), np.uint8)
        chars32 = np.take(lut, kmers[i : i + chunk_rows])
        buf[:, :k] = chars32.view(np.uint8).reshape(m, kb * 4)[:, pad:]
        buf[:, k] = 0x09
        buf[:, width - 1] = 0x0A
        t = c if int(c.max()) >= 1 << 32 else c.astype(np.uint32)
        for jd in range(maxd):  # rightmost digit lands at column k+maxd
            col = buf[:, k + maxd - jd]
            col[:] = 0x30 + (t % 10).astype(np.uint8)
            if jd:  # leading zeros become NULs, stripped below
                col[c < np.uint64(10**jd)] = 0
            t = t // 10
        yield buf.tobytes().translate(None, b"\x00")


def dump_records(kmers: np.ndarray, counts: np.ndarray, k: int,
                 chunk_rows: int = 1 << 20,
                 encoding: int = DEFAULT_ENCODING) -> str:
    counts = np.asarray(counts)
    if len(counts) == 0:
        return ""
    if counts.dtype.kind == "f":  # quality-mode counters: keep exact repr
        strs = kmers_bytes_to_strings(kmers, k)
        return "".join(f"{s}\t{c}\n" for s, c in zip(strs, counts))
    return b"".join(
        dump_records_bytes(kmers, counts, k, chunk_rows, encoding)
    ).decode("ascii")


def dump_db(db: KmcDb, sorted_output: bool = True) -> str:
    if sorted_output:
        kmers, counts = sorted_records(db)
    else:
        # FILE (bin) order — the reference's sequential open mode emits
        # k-mers "not sorted!" (kmc_tools/kmc2_db_reader.h:481)
        kmers, counts = db.kmers_bytes(), db.counters()
    return dump_records(kmers, counts, db.info.kmer_len)


def dump_db_file(path_prefix: str, out_path: str | None = None, sorted_output: bool = True) -> str:
    text = dump_db(read_db(path_prefix), sorted_output)
    if out_path is not None:
        with open(out_path, "w") as f:
            f.write(text)
    return text
