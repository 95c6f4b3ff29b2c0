"""Host-side input: FASTQ/FASTA (plain or gzip) -> flat 2-bit code stream.

The port's counterpart of kmc_tpu/io/readers.py, with the same semantics
(including the fixes to stream tails, reader-pool permits and the
end-of-stream sentinel).  The whole input becomes ONE flat uint8 code stream
(A,C,G,T -> 0..3; every other byte -> 4) in which read separators and N
bases are the same sentinel that breaks k-mers.

Batches are consecutive stream windows: a batch exposes S candidate k-mer
start positions and carries k+TAIL context codes past them, so k-mers
crossing a batch boundary are evaluated exactly once.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from .. import trace
from ..defs import CODE_INVALID

# byte -> code translation: ACGTacgt -> 0..3, everything else -> 4
CODE_LUT = np.full(256, CODE_INVALID, dtype=np.uint8)
for i, ch in enumerate(b"ACGT"):
    CODE_LUT[ch] = i
    CODE_LUT[ord(chr(ch).lower())] = i

TAIL = 16  # extra codes needed past the last k-mer start for packing windows


def batch_len(s: int, k: int) -> int:
    """Code-stream length of a batch with s candidate starts (rounded up to a
    multiple of 8 so batches 2-bit-pack cleanly; s must be a multiple of 8).
    Mirrors kmc_tpu/ops/extract.py::batch_len."""
    return s + ((k + TAIL + 7) // 8) * 8


CHUNK_BYTES = 64 << 20

# A chunk is read and parsed in pieces of at most this many bytes, through
# one read buffer a reader keeps for the whole count (NativeParser.read_chunk).
# 1 MiB with its codes (at most a piece, about half of one for FASTQ) stays
# in a server core's 1-2 MiB L2, so the parse reads back from cache the
# bytes the read just wrote; a buffer of a whole chunk was a fresh mapping
# each time, every page faulted in and zeroed for one use.  Eight threads
# over a 952 MB FASTQ on an H100 machine's 8 cores drained it in 0.20 s at
# 1 MiB, 0.22-0.29 s at 256 KiB, 0.28-0.38 s at 4 MiB, 0.48-0.59 s with a
# 64 MiB buffer a shard.
PIECE_BYTES = 1 << 20


def set_chunk_bytes(n: int) -> None:
    """Size the native/stream read chunk from the -m plan
    (memory.plan_memory; the reference halves fastq_buffer_size until it
    fits its pool, kmc.h:443-451).  Read at call time by every stream."""
    global CHUNK_BYTES
    CHUNK_BYTES = max(1 << 20, int(n))


@dataclass
class ParseState:
    n_reads: int = 0
    consumed_bytes: int = 0  # raw (compressed) input bytes consumed so far


def file_code_stream(paths, fmt: str, state: ParseState | None = None,
                     max_bytes: int | None = None) -> Iterator[np.ndarray]:
    """Yield code-array chunks for a list of input files, parsed serially by
    the native C parser/inflater (native/kmc_host.cpp).  The parser resumes
    mid-line, so chunks need no newline alignment and no leftover copies;
    one sentinel follows each file, so k-mers never span files.  max_bytes
    stops the stream after the chunk at which that many input bytes have
    been consumed (the stage-0 sample, KMC's defs.h:37 STATS_FASTQ_SIZE),
    at the same chunk as kmc_tpu's stream."""
    from .native import NativeGzReader, NativeParser

    own_state = state or ParseState()
    consumed = 0
    # the consumer waits on the read and the parse inline; one read buffer
    # serves the whole stream
    with trace.span("kmc.parse_wait"):
        buf = np.empty(PIECE_BYTES, dtype=np.uint8)
        trace.add("buffers")
    for path in paths:
        parser = NativeParser(fmt)
        p = Path(path)
        gz = p.suffix == ".gz"
        reader = NativeGzReader(path) if gz else open(p, "rb", buffering=0)
        try:
            ended_with_newline = True
            while True:
                with trace.span("kmc.parse_wait"):
                    chunk, n, newline, pieces, _ = parser.read_chunk(
                        reader, buf, CHUNK_BYTES)
                    trace.add("pieces", pieces)
                    if n:
                        trace.add("chunks")
                        trace.add("bytes", n)
                if not n:
                    break
                ended_with_newline = newline
                yield chunk
                consumed += n
                own_state.consumed_bytes += n
                if max_bytes is not None and consumed >= max_bytes:
                    break
            if not ended_with_newline and (max_bytes is None
                                           or consumed < max_bytes):
                yield parser.parse(np.frombuffer(b"\n", dtype=np.uint8))
        finally:
            reader.close()
        own_state.n_reads += parser.n_reads
        yield np.full(1, CODE_INVALID, dtype=np.uint8)
        if max_bytes is not None and consumed >= max_bytes:
            break


def _scan_record_start(win: bytes, fmt: str) -> int | None:
    """Offset of the first record start strictly inside `win` (which begins
    mid-record), or None if the window shows none / is too short to verify.

    FASTA: unambiguous ('\\n>').  FASTQ: candidate '\\n@' verified
    structurally over TWO records (the '+' separator line and the
    quality/sequence length equality disambiguate '@' inside quality
    strings — same approach as the reference's part splitter,
    fastq_reader.cpp:577-770)."""
    if fmt in ("fasta", "multifasta"):
        i = win.find(b"\n>")
        return i + 1 if i != -1 else None

    def _is_record_at(pos: int, depth: int = 2) -> bool:
        if pos >= len(win):
            return False
        if win[pos : pos + 1] != b"@":
            return False
        e0 = win.find(b"\n", pos)
        if e0 == -1:
            return False
        e1 = win.find(b"\n", e0 + 1)
        e2 = win.find(b"\n", e1 + 1) if e1 != -1 else -1
        e3 = win.find(b"\n", e2 + 1) if e2 != -1 else -1
        if e2 == -1:
            return False
        if win[e1 + 1 : e1 + 2] != b"+":
            return False
        if e3 == -1:
            # can't see the full quality line: accept only at true EOF
            return len(win) - (e2 + 1) <= (e1 - (e0 + 1))
        if (e3 - (e2 + 1)) != (e1 - (e0 + 1)):
            return False
        if depth > 1 and e3 + 1 < len(win):
            return _is_record_at(e3 + 1, depth - 1)
        return True

    i = 0
    while True:
        i = win.find(b"\n@", i)
        if i == -1:
            return None
        if _is_record_at(i + 1):
            return i + 1
        i += 1


class GzShard:
    """A record-aligned decompressed range of a BGZF gz file: starts
    `offset` decompressed bytes into block `block`, ends `end_offset`
    bytes into block `end_block` (exclusive; end_block == len(spans)
    means EOF).  `spans` is the shared [(offset, csize)] block table and
    `cbytes` the compressed extent (for byte-balanced partitioning)."""

    __slots__ = ("block", "offset", "end_block", "end_offset", "spans",
                 "cbytes")

    def __init__(self, block, offset, end_block, end_offset, spans, cbytes):
        self.block = block
        self.offset = offset
        self.end_block = end_block
        self.end_offset = end_offset
        self.spans = spans
        self.cbytes = cbytes


class BgzfShardReader:
    """NativeGzReader-shaped reader over one GzShard: inflates successive
    BGZF members (each an independent gzip stream), trimming the first
    block to the shard's record-aligned start and stopping exactly at the
    next shard's start — so concatenating all shards' output reproduces
    the serial decompressed stream byte-for-byte."""

    def __init__(self, path: str, shard: GzShard):
        import zlib as _zlib

        self._zlib = _zlib
        self._f = open(path, "rb")
        self._shard = shard
        self._bi = shard.block
        self._pending = b""
        self._first = True

    def _next_block(self) -> bytes | None:
        sh = self._shard
        if self._bi > sh.end_block or (self._bi == sh.end_block
                                       and sh.end_offset == 0):
            return None
        if self._bi >= len(sh.spans):
            return None
        off, csize = sh.spans[self._bi]
        self._f.seek(off)
        data = self._zlib.decompress(self._f.read(csize), wbits=31)
        if self._bi == sh.end_block:
            data = data[: sh.end_offset]
        if self._first:
            data = data[sh.offset:]
            self._first = False
        self._bi += 1
        return data

    def read_into(self, out: np.ndarray) -> int:
        want = len(out)
        parts = [self._pending] if self._pending else []
        have = len(self._pending)
        while have < want:
            blk = self._next_block()
            if blk is None:
                break
            parts.append(blk)
            have += len(blk)
        buf = b"".join(parts)
        n = min(want, len(buf))
        out[:n] = np.frombuffer(buf, dtype=np.uint8, count=n)
        self._pending = buf[n:]
        return n

    def close(self):
        self._f.close()


def bgzf_block_spans(path: str):
    """[(offset, compressed_size)] of every BGZF member in the file, read
    from the BSIZE extra field without inflating (SAM spec 4.1).  A copy of
    kmc_tpu/io/bam.py::bgzf_block_spans."""
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


def _bgzf_file_shards(path: str, fmt: str, n: int,
                      min_shard_bytes: int) -> list | None:
    """Record-aligned GzShard ranges of a BGZF gz file (bgzip output —
    FASTQ/FASTA .gz as well as BAM are BGZF when produced by bgzip), or
    None when the file is not BGZF / too small / splits are unverifiable.
    Block boundaries come from the BSIZE headers without inflating; only
    the ~4 MB windows at the candidate splits are inflated to find record
    starts (the same two-record structural verification as plain files).
    The reference parallelizes BAM BGZF this way (binary_reader.h:79-146,
    CBamTaskManager queues.h:2148) but keeps gz serial per file
    (kmc.h:276-292) — this extends the block-parallel path to any BGZF
    input."""
    import os as _os
    import zlib as _zlib

    with open(path, "rb") as f:
        head = f.read(18)
    if len(head) < 18 or head[:4] != b"\x1f\x8b\x08\x04":
        return None  # not BGZF (plain gz: serial inflate)
    size = _os.path.getsize(path)
    nparts = min(n, max(1, size // min_shard_bytes))
    if nparts <= 1:
        return None
    try:
        spans = bgzf_block_spans(path)
    except ValueError:
        return None

    offsets = [s[0] for s in spans]
    import bisect as _bisect

    starts = [(0, 0)]
    with open(path, "rb") as f:
        for j in range(1, nparts):
            target = size * j // nparts
            bi = _bisect.bisect_left(offsets, target)
            if bi >= len(spans):
                continue
            # inflate a window from block bi to find the next record start
            win_parts, lens, dec = [], [], 0
            bj = bi
            while bj < len(spans) and dec < (4 << 20):
                off, csize = spans[bj]
                f.seek(off)
                data = _zlib.decompress(f.read(csize), wbits=31)
                win_parts.append(data)
                lens.append(len(data))
                dec += len(data)
                bj += 1
            win = b"".join(win_parts)
            roff = _scan_record_start(win, fmt)
            if roff is None:
                continue  # merge into the previous shard
            acc = 0
            for t, ln in enumerate(lens):
                if roff < acc + ln:
                    cand = (bi + t, roff - acc)
                    break
                acc += ln
            else:
                continue
            if cand > starts[-1]:
                starts.append(cand)
    if len(starts) <= 1:
        return None
    bounds = starts + [(len(spans), 0)]
    shards = []
    for i in range(len(bounds) - 1):
        (b0, o0), (b1, o1) = bounds[i], bounds[i + 1]
        cend = offsets[b1] if b1 < len(spans) else size
        shards.append((GzShard(b0, o0, b1, o1, spans, cend - offsets[b0]),
                       None))
    return shards


def _file_shards(path: str, fmt: str, n_threads: int,
                 min_shard_bytes: int = 32 << 20) -> list[tuple[int, int]]:
    """[(start, end)] byte ranges of `path` aligned to record starts.
    BGZF gz files split at block boundaries (GzShard ranges); plain gz
    (serial inflate) and unverifiable splits collapse to one range."""
    import os as _os

    p = Path(path)
    if p.suffix == ".gz":
        gz_shards = _bgzf_file_shards(path, fmt, n_threads * 2,
                                      min_shard_bytes)
        if gz_shards is not None:
            return gz_shards
        return [(0, -1)]
    size = _os.path.getsize(path)
    n = min(n_threads * 2, max(1, size // min_shard_bytes))
    if n <= 1:
        return [(0, -1)]
    bounds = [0]
    with open(path, "rb") as f:
        for j in range(1, n):
            target = size * j // n
            if target <= bounds[-1]:
                continue
            f.seek(target)
            win = f.read(4 << 20)
            off = _scan_record_start(win, fmt)
            if off is None:
                continue  # merge into the previous shard
            start = target + off
            if start > bounds[-1]:
                bounds.append(start)
    bounds.append(size)
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def process_input_shards(paths, fmt: str, n_parts: int, *,
                         min_shard_bytes: int = 32 << 20,
                         units_per_part: int = 4):
    """Partition the input into n_parts disjoint, record-aligned work lists
    (mirrors kmc_tpu's process_input_shards): a list of n_parts lists of
    (path, start, end, last_of_file) tuples in stream order, contiguous and
    balanced by bytes.  Plain gz files are atomic units; plain files and
    BGZF files split at verified record starts."""
    import os as _os

    units = []  # (path, start, end, last_of_file, nbytes)
    for path in paths:
        ranges = _file_shards(path, fmt, n_parts * units_per_part,
                              min_shard_bytes=min_shard_bytes)
        size = _os.path.getsize(path)
        for i, (a, b) in enumerate(ranges):
            if isinstance(a, GzShard):
                nb = a.cbytes  # compressed extent balances BGZF shards
            else:
                nb = (b if b >= 0 else size) - a
            units.append((path, a, b, i == len(ranges) - 1, nb))
    total = sum(u[4] for u in units)
    parts: list[list] = [[] for _ in range(n_parts)]
    acc = 0
    for u in units:
        # contiguous partition by byte midpoint: a unit goes to the part
        # whose byte window holds its centre
        mid = acc + u[4] / 2
        p = min(int(mid * n_parts / total) if total else 0, n_parts - 1)
        parts[p].append(u[:4])
        acc += u[4]
    return parts


def shard_code_stream(shards, fmt: str, state: ParseState | None = None,
                      n_threads: int = 1) -> Iterator[np.ndarray]:
    """Code-chunk stream over an explicit shard list [(path, start, end,
    last_of_file)] (one element of process_input_shards), parsed by
    n_threads native parsers (mirrors kmc_tpu's shard_code_stream without
    its NumPy fallback)."""
    from .native import NativeParser

    NativeParser(fmt)  # build the runtime, check fmt before threads start
    return _parallel_chunks(list(shards), fmt, state or ParseState(),
                            max(1, n_threads))


def parallel_code_stream(paths, fmt: str, state: ParseState | None = None,
                         n_threads: int = 2) -> Iterator[np.ndarray]:
    """file_code_stream with N parser threads (the native C parsers release
    the GIL, so parse genuinely overlaps across cores — the analogue of the
    reference's reader/splitter thread pool, kmc.h:234-294).

    Work shards: one per gz file (inflation is serial per stream, parallel
    across files — reference kmc.h:276-292 gives gz files cores/2 readers);
    plain FASTQ/FASTA files split into byte ranges aligned to record starts.
    The consumer drains shards strictly in order, so the emitted chunk
    stream is a chunk-boundary refinement of the serial stream: batches,
    counts, stats, and DB bytes are identical to the serial path."""
    from .native import NativeParser

    NativeParser(fmt)  # build the runtime, check fmt before threads start
    own_state = state or ParseState()

    shards = []  # (path, start, end, last_of_file)
    with trace.span("kmc.split"):
        for path in paths:
            ranges = _file_shards(path, fmt, n_threads)
            for i, (a, b) in enumerate(ranges):
                shards.append((path, a, b, i == len(ranges) - 1))
        trace.add("shards", len(shards))
    return _parallel_chunks(shards, fmt, own_state, n_threads)


def _parallel_chunks(shards, fmt, own_state, n_threads):
    import queue as _queue
    import threading

    from .native import NativeGzReader, NativeParser

    qs = [_queue.Queue(maxsize=2) for _ in shards]
    window = threading.Semaphore(n_threads + 2)  # shards in flight
    next_shard = [0]
    lock = threading.Lock()
    errors: list = []
    stop = threading.Event()  # consumer gone: producers must bail out
    started_by = trace.current()

    def _put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def run_shard(si, buf):
        path, start, end, last = shards[si]
        parser = NativeParser(fmt)
        q = qs[si]
        bgzf = isinstance(start, GzShard)
        gz = bgzf or Path(path).suffix == ".gz"
        if bgzf:
            reader = BgzfShardReader(path, start)
        elif gz:
            reader = NativeGzReader(path)
        else:
            reader = open(path, "rb", buffering=0)
        try:
            if not gz and start:
                reader.seek(start)
            remaining = None if (gz or end < 0) else end - start
            ended_with_newline = True
            consumed = 0
            while not stop.is_set():
                want = CHUNK_BYTES if remaining is None else min(
                    CHUNK_BYTES, remaining)
                if want == 0:
                    break
                # the piece loop runs in C: one call and one release of
                # the interpreter lock a chunk
                with trace.span("kmc.parse", usage=True):
                    codes, n, newline, pieces, read_s = parser.read_chunk(
                        reader, buf, want)
                    trace.add("bytes", n)
                    trace.add("read_s", read_s)
                trace.add("pieces", pieces)
                if not n:
                    break
                ended_with_newline = newline
                if not _put(q, ("c", codes, n)):
                    return
                consumed += n
                if remaining is not None:
                    remaining -= n
            if stop.is_set():
                return
            if last and not ended_with_newline:
                if not _put(q, ("c", parser.parse(
                        np.frombuffer(b"\n", dtype=np.uint8)), 0)):
                    return
            if last:
                # file boundary sentinel (k-mers must not span files)
                if not _put(q, ("c", np.full(1, CODE_INVALID, dtype=np.uint8),
                                0)):
                    return
            _put(q, ("done", parser.n_reads, consumed))
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            errors.append(e)
            _put(q, ("err", None, 0))
        finally:
            reader.close()

    def worker():
        with trace.span("kmc.reader", parent=started_by, usage=True):
            # one read buffer a thread, kept across its shards
            buf = np.empty(PIECE_BYTES, dtype=np.uint8)
            trace.add("buffers")
            claim_and_run(buf)

    def claim_and_run(buf):
        while True:
            # acquire the in-flight permit BEFORE claiming a shard index:
            # claiming first allowed permits to land on LATER shards while
            # the earlier claimant starved — the consumer then waited on a
            # shard no permit-holder was running while the permit-holders
            # blocked on their full queues (deadlock; found by the BGZF
            # many-shard test).  Permit-then-claim keeps the claim order
            # equal to the run order, so the consumer's next shard is
            # always in flight or about to be.
            window.acquire()
            with lock:
                si = next_shard[0]
                if si >= len(shards):
                    window.release()
                    return
                next_shard[0] += 1
            if stop.is_set():
                window.release()
                return
            run_shard(si, buf)

    threads = [threading.Thread(target=worker, name=f"kmc-read{i}",
                                daemon=True)
               for i in range(min(n_threads, len(shards)))]
    with trace.span("kmc.reader_start"):
        for t in threads:
            t.start()
    try:
        for si in range(len(shards)):
            q = qs[si]
            while True:
                with trace.span("kmc.parse_wait"):
                    kind, payload, nbytes = q.get()
                    if kind == "c":
                        trace.add("chunks")
                        trace.add("bytes", nbytes)
                if kind == "err":
                    raise errors[0]
                if kind == "done":
                    own_state.n_reads += payload
                    window.release()
                    break
                own_state.consumed_bytes += nbytes
                yield payload
    finally:
        # unblock producers if the consumer stops early: the stop flag
        # breaks any producer waiting on a full queue (and stops new file
        # reads), the drain frees anything already queued
        stop.set()
        with lock:
            next_shard[0] = len(shards)
        for q in qs:
            while True:
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
        for _ in threads:
            window.release()
        for t in threads:
            t.join(timeout=10)


def homopolymer_compress_codes(codes: np.ndarray) -> np.ndarray:
    """Collapse runs of identical bases (reference splitter.cpp:424-435);
    runs of sentinels collapse too, which is harmless."""
    if len(codes) == 0:
        return codes
    keep = np.empty(len(codes), dtype=bool)
    keep[0] = True
    np.not_equal(codes[1:], codes[:-1], out=keep[1:])
    return codes[keep]


def homopolymer_compress_stream(chunks) -> Iterator[np.ndarray]:
    """homopolymer_compress_codes over a code-chunk stream: a run spanning a
    chunk boundary collapses to one code at the head of the next chunk,
    which is dropped when it continues the previous chunk's run."""
    prev_last = -1
    for chunk in chunks:
        chunk = homopolymer_compress_codes(chunk)
        if len(chunk) and chunk[0] == prev_last:
            chunk = chunk[1:]
        if len(chunk):
            prev_last = int(chunk[-1])
        yield chunk


class BatchStream:
    """Assemble code chunks into fixed-shape device batches.

    Each batch is a uint8 array of length S + k + TAIL whose first S
    positions are candidate k-mer starts; consecutive batches advance the
    stream cursor by exactly S so every global position is evaluated once.
    """

    def __init__(self, s: int, k: int):
        if s % 8:
            raise ValueError("batch_positions must be a multiple of 8")
        self.s = s
        self.k = k
        self.batch_bytes = batch_len(s, k)

    def batches(self, chunks: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        s, L = self.s, self.batch_bytes
        carry = np.zeros(0, dtype=np.uint8)
        parts = [carry]
        size = 0
        for chunk in chunks:
            parts.append(chunk)
            size += len(chunk)
            if size >= L:
                with trace.span("kmc.assemble"):
                    buf = np.concatenate(parts)
                    trace.add("batches", (len(buf) - L) // s + 1)
                pos = 0
                while pos + L <= len(buf):
                    yield buf[pos : pos + L]
                    pos += s
                parts = [buf[pos:]]
                size = len(parts[0])
        with trace.span("kmc.assemble"):
            tail = np.concatenate(parts)
        while len(tail) > 0:
            if len(tail) < L:
                with trace.span("kmc.assemble"):
                    padded = np.full(L, CODE_INVALID, dtype=np.uint8)
                    padded[: len(tail)] = tail
                    trace.add("batches")
                yield padded
                # batch_len pads L past s + k - 1, so a tail of length in
                # (s + k - 1, L) still holds valid window STARTS at >= s —
                # breaking here silently dropped up to L - (s + k - 1)
                # occurrences per stream end (found by a 3-process
                # byte-identity check; the start position must land in a
                # ~(L - s - k + 1)/s window, so most runs never hit it).
                # Keep consuming until no start can form a window.
                tail = tail[self.s :]
                if len(tail) < self.k:
                    break
                continue
            yield tail[:L]
            tail = tail[self.s :]
