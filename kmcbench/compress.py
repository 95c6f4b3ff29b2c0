"""The traffic's FASTQ compressed as reads arrive from a sequencing
provider or ENA: one gzip member (RFC 1952), as GNU gzip and pigz write
it, or BGZF (SAMv1 section 4.1, "The BGZF compression format"), as
htslib's bgzip writes it.

Both cut the uncompressed stream at fixed offsets, PIECE bytes apart,
and deflate the pieces on a thread pool (zlib releases the interpreter
lock while it compresses), writing them in stream order, so the same
bytes in give the same file out.

gzip: one 10-byte header, then each piece as raw deflate primed with the
previous piece's last 32 KiB and ended by a sync flush (the last piece by
Z_FINISH), as pigz joins its blocks into one stream; then one trailer,
the CRC-32 of all the bytes and their count mod 2^32.  No FEXTRA field,
so a reader that looks for BGZF's "BC" subfield finds none.

bgzf: members of at most BGZF_BLOCK input bytes, each a gzip member with
FEXTRA and one "BC" subfield (SLEN 2) holding its compressed size less
one, then the standard 28-byte empty member that marks the end of file.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

KINDS = ("gzip", "bgzf")
BGZF_BLOCK = 0xff00  # input bytes of a BGZF member at most (BGZF_BLOCK_SIZE)
PIECE = 16 * BGZF_BLOCK  # input bytes a pool task compresses
WINDOW = 1 << 15  # deflate's window: the dictionary a gzip piece gets
LEVEL = 6  # zlib's level: the default of GNU gzip, pigz and htslib's bgzip
# ID1 ID2 CM FLG, MTIME 0, XFL 0, OS 3 (Unix), as GNU gzip writes them
GZIP_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"
# ID1 ID2 CM FLG=FEXTRA, MTIME 0, XFL 0, OS 255, XLEN 6, 'B' 'C' SLEN 2
BGZF_HEAD = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
BGZF_EOF = BGZF_HEAD + b"\x1b\x00\x03\x00" + bytes(8)


def check(kind) -> None:
    """Stop the run on a compression the harness cannot write."""
    if kind not in KINDS:
        raise SystemExit(f"unknown compression {kind!r} in the traffic mix "
                         f"(one of {', '.join(KINDS)}, or no key)")


def _deflate(piece, zdict: bytes, last: bool) -> bytes:
    """A gzip piece: raw deflate, primed with zdict, byte-aligned."""
    c = (zlib.compressobj(LEVEL, zlib.DEFLATED, -15, zdict=zdict) if zdict
         else zlib.compressobj(LEVEL, zlib.DEFLATED, -15))
    return c.compress(piece) + c.flush(zlib.Z_FINISH if last
                                       else zlib.Z_SYNC_FLUSH)


def _bgzf_members(piece) -> bytes:
    """BGZF members of the piece's consecutive BGZF_BLOCK bytes."""
    out = []
    for lo in range(0, len(piece), BGZF_BLOCK):
        block = piece[lo:lo + BGZF_BLOCK]
        c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
        data = c.compress(block) + c.flush()
        bsize = len(BGZF_HEAD) + 2 + len(data) + 8
        out += [BGZF_HEAD, struct.pack("<H", bsize - 1), data,
                struct.pack("<II", zlib.crc32(block), len(block))]
    return b"".join(out)


class Writer:
    """A file-like writer of one compressed file: write() takes the
    uncompressed stream in order, close() ends the file.  cpu_s sums the
    pool's compression, wait_s is what the caller spent in write() and
    close(), and compressed_bytes the file's size."""

    def __init__(self, path, kind: str):
        check(kind)
        self.kind = kind
        threads = len(os.sched_getaffinity(0))
        self._pool = ThreadPoolExecutor(threads,
                                        thread_name_prefix="kmcbench-gz")
        self._depth = 2 * threads  # pieces in flight at most
        self._pending = deque()
        self._carry = bytearray()
        self._window = b""  # the last WINDOW bytes before the next piece
        self._f = open(path, "wb")
        self.crc = self.size = self.compressed_bytes = 0
        self.cpu_s = self.wait_s = 0.0
        if kind == "gzip":
            self._out(GZIP_HEADER)

    def _out(self, data: bytes) -> None:
        self._f.write(data)
        self.compressed_bytes += len(data)

    def _task(self, piece, zdict, last):
        t0 = time.thread_time()
        if self.kind == "gzip":
            out = _deflate(piece, zdict, last)
        else:
            out = _bgzf_members(piece)
        return out, time.thread_time() - t0

    def _submit(self, piece, last=False) -> None:
        self.size += len(piece)
        zdict = None
        if self.kind == "gzip":
            self.crc = zlib.crc32(piece, self.crc)
            # every piece but the last is PIECE bytes, past WINDOW
            zdict, self._window = self._window, bytes(piece[-WINDOW:])
        self._pending.append(self._pool.submit(self._task, piece, zdict,
                                               last))
        while len(self._pending) > self._depth:
            self._drain_one()

    def _drain_one(self) -> None:
        out, cpu = self._pending.popleft().result()
        self.cpu_s += cpu
        self._out(out)

    def write(self, data) -> None:
        t0 = time.perf_counter()
        view = memoryview(data).cast("B")
        if self._carry:
            need = PIECE - len(self._carry)
            self._carry += view[:need]
            view = view[need:]
            if len(self._carry) == PIECE:
                self._submit(bytes(self._carry))
                self._carry = bytearray()
        full = len(view) // PIECE * PIECE
        for lo in range(0, full, PIECE):
            self._submit(view[lo:lo + PIECE])
        self._carry += view[full:]
        self.wait_s += time.perf_counter() - t0

    def close(self) -> None:
        t0 = time.perf_counter()
        try:
            if self.kind == "gzip" or self._carry:
                self._submit(bytes(self._carry), last=True)
            while self._pending:
                self._drain_one()
            if self.kind == "gzip":
                self._out(struct.pack("<II", self.crc, self.size & 0xffffffff))
            else:
                self._out(BGZF_EOF)
        finally:
            self._pool.shutdown()
            self._f.close()
        self.wait_s += time.perf_counter() - t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:  # the write failed: drop the pieces, close the file
            self._pool.shutdown(cancel_futures=True)
            self._f.close()
