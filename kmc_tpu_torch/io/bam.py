"""BAM input: BGZF inflate + alignment-record decode -> code chunks.

The port's copy of kmc_tpu/io/bam.py.  Records are parsed by the native
host runtime (native/kmc_host.cpp parse_bam) and raise where it cannot be
built, as every input of the port does; the NumPy parser
(_bam_code_chunks_py) is kept as the plain version the native one is held
against in the tests.

Semantics mirror the reference (splitter.cpp:329-420, fastq_reader.cpp:
203-310): secondary (flag bit 8) and supplementary (bit 11) alignments are
excluded; in single-strand mode reverse-complemented alignments (bit 4) are
transformed back to the original read orientation; 4-bit sequence codes map
1/2/4/8 -> A/C/G/T and everything else (incl. N=15) breaks k-mers.
"""
from __future__ import annotations

import struct
import zlib
from typing import Iterator

import numpy as np

from ..defs import CODE_INVALID

# 4-bit BAM code -> 2-bit code (invalid = 4)
NIBBLE_LUT = np.full(16, CODE_INVALID, dtype=np.uint8)
NIBBLE_LUT[1] = 0  # A
NIBBLE_LUT[2] = 1  # C
NIBBLE_LUT[4] = 2  # G
NIBBLE_LUT[8] = 3  # T
# reverse-complement nibble decode (splitter.cpp rev_maping)
NIBBLE_LUT_RC = np.full(16, CODE_INVALID, dtype=np.uint8)
NIBBLE_LUT_RC[1] = 3
NIBBLE_LUT_RC[2] = 2
NIBBLE_LUT_RC[4] = 1
NIBBLE_LUT_RC[8] = 0


def bgzf_decompress(path: str) -> bytes:
    """Inflate all BGZF members (a BAM is a concatenated-member gzip)."""
    raw = open(path, "rb").read()
    out = []
    pos = 0
    while pos < len(raw):
        d = zlib.decompressobj(wbits=31)
        out.append(d.decompress(raw[pos:]))
        consumed = len(raw) - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return b"".join(out)


def bgzf_block_spans(path: str):
    """[(offset, compressed_size)] of every BGZF member in the file, read
    from the BSIZE extra field without inflating (SAM spec §4.1) — the
    block table the reference's CBamTaskManager work-steals over
    (binary_reader.h:79-146)."""
    spans = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            head = f.read(18)
            if len(head) < 18:
                break
            if head[:4] != b"\x1f\x8b\x08\x04":
                raise ValueError(f"not a BGZF member at offset {pos}")
            (xlen,) = struct.unpack_from("<H", head, 10)
            extra = head[12:18] + f.read(max(0, xlen - 6))
            bsize = None
            i = 0
            while i + 4 <= len(extra):
                si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from(
                    "<H", extra, i + 2)[0]
                if si1 == 66 and si2 == 67 and slen == 2:  # 'BC'
                    bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
                    break
                i += 4 + slen
            if bsize is None:
                raise ValueError(f"BGZF BSIZE field missing at offset {pos}")
            spans.append((pos, bsize))
            pos += bsize
            f.seek(pos)
    return spans


def _parallel_inflated_chunks(path: str, n_threads: int,
                              blocks_per_batch: int = 512,
                              spans=None):
    """Yield inflated byte chunks of a BGZF file IN ORDER, inflating blocks
    on a thread pool (each BGZF member is an independent gzip stream and
    zlib.decompress releases the GIL) — the host-side analogue of the
    reference's CBamTaskManager parallel BGZF pipeline (queues.h:2148)."""
    from concurrent.futures import ThreadPoolExecutor

    if spans is None:
        spans = bgzf_block_spans(path)

    def inflate_batch(batch):
        with open(path, "rb") as f:
            out = []
            for off, size in batch:
                f.seek(off)
                out.append(zlib.decompress(f.read(size), wbits=31))
            return b"".join(out)

    batches = [spans[i : i + blocks_per_batch]
               for i in range(0, len(spans), blocks_per_batch)]
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        # bounded pipeline: keep ~2*n_threads batches in flight
        window = 2 * n_threads
        futs = [ex.submit(inflate_batch, b) for b in batches[:window]]
        nxt = window
        for i in range(len(batches)):
            yield futs[i % window].result()
            if nxt < len(batches):
                futs[i % window] = ex.submit(inflate_batch, batches[nxt])
                nxt += 1


def bam_code_chunks(path: str, both_strands: bool = True,
                    n_threads: int = 1) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (codes, n_reads) chunks; a CODE_INVALID separates reads.

    Streams through the native BGZF inflater + C record parser (constant
    memory, no whole-file materialization).  n_threads > 1 inflates the
    independent BGZF blocks on a thread pool (record parsing stays
    sequential — record reassembly is stateful)."""
    from .native import NativeBamParser, NativeGzReader

    open(path, "rb").close()  # a missing file raises FileNotFoundError
    parser = NativeBamParser(both_strands)
    reader = None
    if n_threads > 1:
        try:
            # probe: a parallel walk requires real BGZF members (BSIZE
            # extra field); plain-gzip BAMs take the serial reader
            spans = bgzf_block_spans(path)
        except ValueError:
            reader = NativeGzReader(path)
        else:
            prev_reads = 0
            for chunk in _parallel_inflated_chunks(path, n_threads,
                                                   spans=spans):
                codes = parser.parse(np.frombuffer(chunk, dtype=np.uint8))
                if len(codes):
                    n_now = parser.n_reads
                    yield codes, n_now - prev_reads
                    prev_reads = n_now
            return
    if reader is None:
        reader = NativeGzReader(path)
    try:
        buf = np.empty(8 << 20, dtype=np.uint8)
        prev_reads = 0
        while True:
            n = reader.read_into(buf)
            if not n:
                break
            codes = parser.parse(buf[:n])
            if len(codes):
                n_now = parser.n_reads
                yield codes, n_now - prev_reads
                prev_reads = n_now
    finally:
        reader.close()


def _bam_code_chunks_py(path: str, both_strands: bool = True,
                        chunk_reads: int = 65536) -> Iterator[tuple[np.ndarray, int]]:
    """The plain version of bam_code_chunks: the whole file inflated, then
    each record decoded with NumPy (the same reads and codes)."""
    data = bgzf_decompress(path)
    if data[:4] != b"BAM\x01":
        raise ValueError("BAM magic missing")
    (l_text,) = struct.unpack_from("<i", data, 4)
    pos = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, pos)
    pos += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, pos)
        pos += 4 + l_name + 4

    buf = []
    n_reads = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError("malformed BAM stream (truncated record length)")
        (block_size,) = struct.unpack_from("<i", data, pos)
        # same sanity cap as the native parser (native/kmc_host.cpp)
        if block_size < 32 or block_size > (1 << 28) \
                or pos + 4 + block_size > len(data):
            raise ValueError("malformed BAM stream (bad block size)")
        pos += 4
        rec_end = pos + block_size
        bin_mq_nl, flag_nc, l_seq = struct.unpack_from("<III", data, pos + 8)
        l_read_name = bin_mq_nl & 0xFF
        n_cigar_op = flag_nc & 0xFFFF
        flags = flag_nc >> 16
        exclude = bool((flags >> 8) & 1) or bool((flags >> 11) & 1)
        seq_off = pos + 32 + l_read_name + 4 * n_cigar_op
        if not exclude and l_seq > 0:
            nb = (l_seq + 1) // 2
            packed = np.frombuffer(data, np.uint8, count=nb, offset=seq_off)
            nibbles = np.empty(nb * 2, np.uint8)
            nibbles[0::2] = packed >> 4
            nibbles[1::2] = packed & 15
            nibbles = nibbles[:l_seq]
            is_rc = bool((flags >> 4) & 1)
            if not both_strands and is_rc:
                codes = NIBBLE_LUT_RC[nibbles][::-1]
            else:
                codes = NIBBLE_LUT[nibbles]
            buf.append(codes)
            buf.append(np.full(1, CODE_INVALID, np.uint8))
            n_reads += 1
            if len(buf) >= 2 * chunk_reads:
                yield np.concatenate(buf), n_reads
                buf = []
                n_reads = 0
        pos = rec_end
    if buf or n_reads:
        yield (
            np.concatenate(buf) if buf else np.zeros(0, np.uint8),
            n_reads,
        )
