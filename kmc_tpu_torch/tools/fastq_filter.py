"""kmc_tools `filter`: filter FASTQ/FASTA reads by k-mer presence in a DB
(the port's copy of kmc_tpu/tools/fastq_filter.py; NumPy and ctypes only).

Reference: kmc_tools/fastq_filter.{h,cpp} + kmc_tools.cpp:226-345.

Semantics (fastq_filter.cpp:106-174):
  * remove mode: a read passes when its number of k-mers with counter > 0
    lies in [min, max]; bounds given as floats are fractions of the read's
    k-mer count, floored to integers (uint32 cast, :119-120); int bounds are
    absolute counts.  Whether a bound is a fraction is decided by the
    *syntax* the user typed (1 is absolute, 1.0 is 100%), so the API takes
    int or float values.
  * trim mode (-t, :134-152): drop the read if its first k-mer's counter is
    below min_kmers (an absolute per-k-mer threshold here); otherwise keep
    the longest prefix of k-mers with counter >= min_kmers, i.e.
    run + k - 1 bases.
  * hard-mask mode (-hm, :153-174): every base covered by a k-mer whose
    counter is below min_kmers becomes 'N'.
"""
from __future__ import annotations

import gzip

import numpy as np

from ..api import KMCFile


_CHUNK = 8 << 20  # bytes per fast-path read; tests shrink it to force
                  # record/CR splits across chunk boundaries
_WS = b" \t\n\r\x0b\x0c\x1c\x1d\x1e\x1f"  # str.rstrip's ASCII set


def _open(path, mode):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


class _ReadAhead:
    """Reader-thread chunk prefetch — the reference filter's input-reader
    stage (kmc_tools.cpp:226-268 runs reader/filter/writer threads).
    Contract: the single consumer reads fixed-size chunks until b''."""

    def __init__(self, f, chunk_bytes: int, depth: int = 4):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None

        def run():
            try:
                while True:
                    b = f.read(chunk_bytes)
                    self._q.put(b)
                    if not b:
                        return
            except BaseException as e:  # re-raised by the consumer
                self._err = e
                self._q.put(None)

        self._t = threading.Thread(target=run, daemon=True,
                                   name="kmc-filter-read")
        self._t.start()

    def read(self, _n: int) -> bytes:
        b = self._q.get()
        if b is None:
            raise self._err
        return b


class _WriteBehind:
    """Writer-thread output drain — the reference filter's writer stage.
    Writes are queued in order; worker errors re-raise on the next
    write()/finish()."""

    def __init__(self, f, depth: int = 16):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None
        self._f = f

        def run():
            while True:
                b = self._q.get()
                if b is None:
                    return
                try:
                    f.write(b)
                except BaseException as e:
                    self._err = e
                    # drain so the producer never blocks on a dead writer
                    while self._q.get() is not None:
                        pass
                    return

        self._t = threading.Thread(target=run, daemon=True,
                                   name="kmc-filter-write")
        self._t.start()

    def write(self, b):
        if self._err is not None:
            raise self._err
        self._q.put(bytes(b))
        return len(b)

    # io.TextIOWrapper wraps this for the trailing-partial-record path
    closed = False

    def writable(self):
        return True

    def readable(self):
        return False

    def seekable(self):
        return False

    def flush(self):
        pass

    def finish(self):
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            raise self._err


def filter_fastq(
    db_path: str,
    input_path: str,
    output_path: str,
    min_kmers: int | float = 2,
    max_kmers: int | float = 10**9,
    trim: bool = False,
    hard_mask: bool = False,
    min_fraction: float | None = None,  # deprecated aliases
    max_fraction: float | None = None,
    db_cutoff_min: int | None = None,
    db_cutoff_max: int | None = None,
    in_format: str | None = None,
    out_format: str | None = None,
):
    # deprecated aliases kept the old rule: values <= 1.0 are fractions,
    # larger values are absolute counts
    if min_fraction is not None:
        min_kmers = float(min_fraction) if min_fraction <= 1.0 else int(min_fraction)
    if max_fraction is not None:
        max_kmers = float(max_fraction) if max_fraction <= 1.0 else int(max_fraction)
    db = KMCFile()
    if not db.OpenForRA(db_path):
        raise FileNotFoundError(f"cannot open database {db_path}")
    # DB-side cutoffs: k-mers whose counter falls outside [min, max] read
    # as absent (SetMinCount/SetMaxCount applied by kmc_tools.cpp:307-308)
    if db_cutoff_min is not None:
        db.SetMinCount(db_cutoff_min)
    if db_cutoff_max is not None:
        db.SetMaxCount(db_cutoff_max)
    k = db.KmerLength()
    # trim/hard-mask use min_kmers as an absolute per-k-mer counter bar
    thr = int(min_kmers) if not isinstance(min_kmers, float) else max(int(min_kmers), 1)

    is_fasta = None if in_format is None else (in_format == "a")
    out_fasta = None if out_format is None else (out_format == "a")
    n_kept = 0
    n_total = 0
    BATCH = 256  # reads per lookup: one vectorized DB pass per batch
    # the reference accepts several inputs (@list files expand to
    # input_srcs, parameters_parser.cpp:106-124); all filtered reads land
    # in the one output
    inputs = ([input_path] if isinstance(input_path, (str, bytes))
              or hasattr(input_path, "__fspath__") else list(input_path))

    def _process(fin, fout):
        nonlocal n_kept, n_total, is_fasta
        eof = False
        while not eof:
            recs = []
            while len(recs) < BATCH:
                header = fin.readline()
                if not header:
                    eof = True
                    break
                if is_fasta is None:
                    is_fasta = header.startswith(">")
                seq = fin.readline().rstrip("\n")
                if is_fasta:
                    qual = None
                else:
                    fin.readline()  # '+'
                    qual = fin.readline().rstrip("\n")
                recs.append((header, seq, qual))
            if not recs:
                break
            n_total += len(recs)
            # join the batch with 'N' separators: windows crossing a
            # separator are invalid by construction, and read i's windows
            # are a contiguous slice of the joined read's counter vector
            _, joined = db.counters_for_read_array(
                "N".join(seq for _, seq, _ in recs))
            if not trim and not hard_mask:
                # remove mode, vectorized across the whole batch: per-read
                # present-k-mer counts via one cumsum over the joined
                # counter vector (the per-read python loop costs more than
                # the lookups at reference-parity speeds)
                lens = np.fromiter((len(s_) for _, s_, _ in recs),
                                   np.int64, len(recs))
                nk = lens - k + 1
                if (nk > 0).all():
                    starts = np.zeros(len(recs), np.int64)
                    np.cumsum(lens[:-1] + 1, out=starts[1:])
                    csum = np.concatenate(
                        [[0], np.cumsum(joined > 0, dtype=np.int64)])
                    n_present = csum[starts + nk] - csum[starts]
                    lo_v = ((min_kmers * nk).astype(np.int64)
                            if isinstance(min_kmers, float)
                            else np.full(len(recs), min_kmers, np.int64))
                    hi_v = ((max_kmers * nk).astype(np.int64)
                            if isinstance(max_kmers, float)
                            else np.full(len(recs), max_kmers, np.int64))
                    keep = (lo_v <= n_present) & (n_present <= hi_v)
                    write_fasta = is_fasta if out_fasta is None else out_fasta
                    if write_fasta and not is_fasta:
                        parts = [f">{recs[i][0].rstrip().lstrip('@')}\n"
                                 f"{recs[i][1]}\n"
                                 for i in np.flatnonzero(keep)]
                    elif write_fasta:
                        parts = [f"{recs[i][0].rstrip()}\n{recs[i][1]}\n"
                                 for i in np.flatnonzero(keep)]
                    else:
                        if is_fasta:
                            raise ValueError(
                                "FASTA input has no qualities; cannot "
                                "write FASTQ output")
                        parts = [f"{recs[i][0].rstrip()}\n{recs[i][1]}\n+\n"
                                 f"{recs[i][2]}\n"
                                 for i in np.flatnonzero(keep)]
                    fout.write("".join(parts))
                    n_kept += int(keep.sum())
                    continue
            off = 0
            for header, seq, qual in recs:
                nk = len(seq) - k + 1
                counters = joined[off : off + nk] if nk > 0 else joined[:0]
                off += len(seq) + 1
                n_kmers = len(counters)
                if n_kmers == 0:
                    continue
                if trim:
                    # longest prefix of k-mers with counter >= thr -> keep
                    # run + k - 1 bases (FilterReadTrim, :134-152)
                    good = counters >= thr
                    if not good[0]:
                        continue
                    run = int(np.argmin(good)) if not good.all() else n_kmers
                    seq = seq[: run + k - 1]
                    if qual is not None:
                        qual = qual[: run + k - 1]
                elif hard_mask:
                    mask = np.ones(len(seq), dtype=bool)
                    for i in np.flatnonzero(counters < thr):
                        mask[i : i + k] = False
                    b = np.frombuffer(seq.encode("ascii"), np.uint8).copy()
                    b[~mask] = 0x4E  # 'N'
                    seq = b.tobytes().decode("ascii")
                else:
                    n_present = int((counters > 0).sum())
                    # float bounds are fractions of the k-mer count, floored
                    # (uint32 casts at fastq_filter.cpp:119-120)
                    lo = (int(min_kmers * n_kmers)
                          if isinstance(min_kmers, float) else min_kmers)
                    hi = (int(max_kmers * n_kmers)
                          if isinstance(max_kmers, float) else max_kmers)
                    if not (lo <= n_present <= hi):
                        continue
                n_kept += 1
                write_fasta = is_fasta if out_fasta is None else out_fasta
                if write_fasta:
                    hdr = header.rstrip()
                    if not is_fasta:  # FASTQ record -> FASTA output (-fa)
                        hdr = ">" + hdr.lstrip("@")
                    fout.write(f"{hdr}\n{seq}\n")
                else:
                    if is_fasta:
                        raise ValueError(
                            "FASTA input has no qualities; cannot write "
                            "FASTQ output")
                    fout.write(f"{header.rstrip()}\n{seq}\n+\n{qual}\n")

    def _process_bytes(fin, fout):
        """Fast path for ALL filter modes: chunked binary reads,
        vectorized record bookkeeping, one joined DB query per chunk.
        Remove mode re-emits normalized kept records as verbatim byte
        spans with consecutive runs coalesced (the reference re-emits
        records unchanged, fastq_filter.cpp:176); trim and hard-mask
        compute their per-record transforms with vectorized window math
        (reduceat first-bad-window / bincount coverage diff) and emit
        rebuilt records.  Falls back to _process semantics byte-for-byte
        for denormalized records and partial trailing records."""
        nonlocal n_kept, n_total, is_fasta
        import io

        carry = b""
        rl = None  # lines per record: 4 fastq, 2 fasta
        while True:
            blob = fin.read(_CHUNK)
            at_eof = not blob
            data = carry + blob
            if not data:
                return
            # universal-newline translation, matching the legacy "rt"
            # reader; a trailing '\r' may pair with '\n' in the next chunk
            pend_cr = b""
            if not at_eof and data[-1:] == b"\r":
                pend_cr, data = b"\r", data[:-1]
            if b"\r" in data:
                data = data.replace(b"\r\n", b"\n").replace(b"\r", b"\n")
            if rl is None:
                if is_fasta is None:
                    is_fasta = data[:1] == b">"
                rl = 2 if is_fasta else 4
            if at_eof and not data.endswith(b"\n"):
                data += b"\n"
            arr = np.frombuffer(data, np.uint8)
            nl = np.flatnonzero(arr == 10)
            full = (len(nl) // rl) * rl
            if full == 0:
                if at_eof:
                    carry = data
                    break  # partial record tail: legacy readline semantics
                carry = data + pend_cr
                continue
            end = int(nl[full - 1]) + 1
            carry = data[end:] + pend_cr
            nl = nl[:full]
            n_rec = full // rl
            line_s = np.empty(full, np.int64)
            line_s[0] = 0
            line_s[1:] = nl[:-1] + 1
            line_e = nl.astype(np.int64)
            seq_s, seq_e = line_s[1::rl], line_e[1::rl]
            lens = seq_e - seq_s
            n_total += n_rec
            # joined query: seqs separated by 'N' (windows crossing a
            # separator are invalid by construction); plain byte-slice
            # join — O(n_rec) slices beat any per-byte index arithmetic
            offs = np.zeros(n_rec, np.int64)
            np.cumsum(lens[:-1] + 1, out=offs[1:])
            total = int(lens.sum()) + n_rec - 1
            if total > 0:
                joined = b"N".join(
                    data[s:e] for s, e in zip(seq_s.tolist(),
                                              seq_e.tolist()))
                _, cnt = db.counters_for_read_array(joined)
            else:
                cnt = np.zeros(0, np.uint32)
            nk = lens - k + 1
            nkc = np.maximum(nk, 0)
            write_fasta = is_fasta if out_fasta is None else out_fasta
            if not write_fasta and is_fasta:
                # raised for any chunk with records, kept or not — the
                # legacy path errors as soon as a batch is read
                raise ValueError("FASTA input has no qualities; "
                                 "cannot write FASTQ output")
            if trim or hard_mask:
                # vectorized per-record transforms over the VALID windows
                # of the joined counter vector (window t of record i sits
                # at offs[i]+t; windows crossing the 'N' separators never
                # enter these arrays, matching per-read semantics)
                cw_all = np.asarray(cnt)
                total_v = int(nkc.sum())
                v_base = np.zeros(n_rec, np.int64)
                np.cumsum(nkc[:-1], out=v_base[1:])
                t_within = (np.arange(total_v, dtype=np.int64)
                            - np.repeat(v_base, nkc))
                w_idx = np.repeat(offs, nkc) + t_within
                badw = cw_all[w_idx] < thr
                newlen = None
                if trim:
                    # first bad window per record (FilterReadTrim,
                    # fastq_filter.cpp:134-152): drop on run 0, else keep
                    # run + k - 1 bases
                    BIG = np.int64(1) << 60
                    if total_v:
                        # BIG sentinel keeps every v_base a valid reduceat
                        # index (records with nkc==0 at the tail have
                        # v_base == total_v); clipping to total_v-1 would
                        # split the previous record's segment and lose its
                        # last window from the min
                        idxv = np.concatenate(
                            [np.where(badw, t_within, BIG), [BIG]])
                        fb = np.minimum.reduceat(idxv, v_base)
                        fb = np.where(nkc > 0, fb, 0)
                        run = np.where(fb >= BIG, nkc, fb)
                    else:
                        run = np.zeros(n_rec, np.int64)
                    keep = (nkc > 0) & (run > 0)
                    newlen = run + k - 1
                else:
                    # hard mask (FilterReadHardMask, :153-174): bases
                    # covered by a below-threshold window become 'N';
                    # spans clip at each record's end (mask[i:i+k] on a
                    # len(seq) mask)
                    keep = nkc > 0
                    cover = None
                    if total_v:
                        rec_of_v = np.repeat(
                            np.arange(n_rec, dtype=np.int64), nkc)
                        bad_pos = w_idx[badw]
                        rec_end = offs + lens
                        ends = np.minimum(bad_pos + np.int64(k),
                                          rec_end[rec_of_v[badw]])
                        d = np.bincount(bad_pos, minlength=total + 1)
                        d -= np.bincount(ends, minlength=total + 1)
                        cover = np.cumsum(d[:total]) > 0
                n_kept += int(keep.sum())
                kidx = np.flatnonzero(keep)
                if len(kidx):
                    if not trim:
                        if cover is not None and cover.any():
                            jarr = np.frombuffer(joined, np.uint8).copy()
                            jarr[cover] = 0x4E  # 'N'
                            jb = jarr.tobytes()
                        else:
                            jb = joined
                    parts = []
                    off_l = offs.tolist()
                    lens_l = lens.tolist()
                    nl_l = newlen.tolist() if trim else None
                    for i in kidx.tolist():
                        hdr = data[line_s[rl * i]:line_e[rl * i]].rstrip(_WS)
                        if trim:
                            L = nl_l[i]
                            seqb = data[seq_s[i]:seq_s[i] + L]
                        else:
                            o = off_l[i]
                            seqb = jb[o:o + lens_l[i]]
                        if write_fasta and not is_fasta:
                            parts.append(b">" + hdr.lstrip(b"@") + b"\n"
                                         + seqb + b"\n")
                        elif write_fasta:
                            parts.append(hdr + b"\n" + seqb + b"\n")
                        else:
                            qs = line_s[rl * i + 3]
                            qe = line_e[rl * i + 3]
                            if trim:
                                qe = min(qe, qs + L)
                            parts.append(hdr + b"\n" + seqb + b"\n+\n"
                                         + data[qs:qe] + b"\n")
                    fout.write(b"".join(parts))
                if at_eof:
                    break
                continue
            # cast first, then a same-dtype cumsum (a casting cumsum is
            # ~20x slower in numpy)
            present = (np.asarray(cnt) > 0).astype(np.int64)
            csum = np.empty(len(present) + 1, np.int64)
            csum[0] = 0
            np.cumsum(present, out=csum[1:])
            n_present = csum[np.minimum(offs + nkc, len(csum) - 1)] - \
                csum[np.minimum(offs, len(csum) - 1)]
            lo_v = (np.floor(min_kmers * nk).astype(np.int64)
                    if isinstance(min_kmers, float)
                    else np.full(n_rec, min_kmers, np.int64))
            hi_v = (np.floor(max_kmers * nk).astype(np.int64)
                    if isinstance(max_kmers, float)
                    else np.full(n_rec, max_kmers, np.int64))
            keep = (nk > 0) & (lo_v <= n_present) & (n_present <= hi_v)
            n_kept += int(keep.sum())
            kidx = np.flatnonzero(keep)
            if not len(kidx):
                if at_eof:
                    break
                continue
            # normalized = every line free of trailing whitespace (the
            # full str.rstrip ASCII set: \t\v\f\r \x1c-\x1f) and (for
            # FASTQ) a bare '+' separator -> records re-emit verbatim
            lastb = arr[np.maximum(line_e - 1, 0)]
            nonempty = line_e > line_s
            norm = not bool((nonempty
                             & ((lastb == 32)
                                | ((lastb >= 9) & (lastb <= 13))
                                | ((lastb >= 28) & (lastb <= 31)))).any())
            if norm and rl == 4:
                norm = bool(((line_e[2::4] - line_s[2::4] == 1)
                             & (arr[line_s[2::4]] == ord("+"))).all())
            if norm and write_fasta == is_fasta:
                rec_start = line_s[0::rl]
                rec_end = line_e[rl - 1::rl] + 1
                brk = np.flatnonzero(np.diff(kidx) != 1)
                run_a = np.concatenate([[0], brk + 1])
                run_b = np.concatenate([brk, [len(kidx) - 1]])
                fout.write(b"".join(
                    data[rec_start[kidx[a]]:rec_end[kidx[b]]]
                    for a, b in zip(run_a, run_b)))
            else:
                parts = []
                for i in kidx:
                    hdr = data[line_s[rl * i]:line_e[rl * i]].rstrip(_WS)
                    seq = data[seq_s[i]:seq_e[i]]
                    if write_fasta and not is_fasta:
                        parts.append(b">" + hdr.lstrip(b"@") + b"\n"
                                     + seq + b"\n")
                    elif write_fasta:
                        parts.append(hdr + b"\n" + seq + b"\n")
                    else:
                        qual = data[line_s[rl * i + 3]:line_e[rl * i + 3]]
                        parts.append(hdr + b"\n" + seq + b"\n+\n"
                                     + qual + b"\n")
                fout.write(b"".join(parts))
            if at_eof:
                break
        if carry:
            # trailing partial record: legacy readline-based semantics
            carry = carry.replace(b"\r\n", b"\n").replace(b"\r", b"\n")
            tin = io.StringIO(carry.decode("ascii", errors="replace"))
            tw = io.TextIOWrapper(fout, encoding="ascii", newline="")
            try:
                _process(tin, tw)
                tw.flush()
            finally:
                tw.detach()

    import os as _os
    from . import native_tools as _nt
    # the fast path issues one joined DB query per 8 MB chunk — only
    # sane against the native lookup; the NumPy fallback materializes
    # per-window arrays, so it keeps the 256-read batching of _process
    fast = (_os.environ.get("KMC_TPU_FILTER_BYTES", "1") != "0"
            and _nt.available())
    # reader/filter/writer stage threads (the reference pipeline,
    # kmc_tools.cpp:226-345): -t1 (or auto on a 1-core host) keeps the
    # serial loop, anything else overlaps read+inflate and output writes
    # with the lookup chunk; output bytes are identical either way
    # (chunks drain in order)
    nt = _nt.get_threads()
    if nt == 0:  # auto: the hardware concurrency, like the native core
        try:
            nt = len(_os.sched_getaffinity(0))
        except AttributeError:
            nt = _os.cpu_count() or 1
    pipeline = fast and nt != 1
    with _open(output_path, "wb" if fast else "wt") as fraw:
        fout = _WriteBehind(fraw) if pipeline else fraw
        try:
            for one_input in inputs:
                with _open(one_input, "rb" if fast else "rt") as fraw_in:
                    fin = (_ReadAhead(fraw_in, _CHUNK) if pipeline
                           else fraw_in)
                    (_process_bytes if fast else _process)(fin, fout)
        finally:
            if pipeline:
                fout.finish()
    return n_kept, n_total
