"""Spans and counters set from outside kmc_tpu_torch, by wrapping its
functions and methods for the length of a traced window (the program
itself carries none yet).  Each wrapper opens a torch.profiler label of
its span's name, so a trace can tell what the host was doing, adds its
seconds to the current job's total of that span, and, for the two
kernels, the bytes of each call (roofline.py).

  host_input   the producer's batches (parse and batch assembly,
               io/readers.py, io/native.py) and the pack calls
               (pack_codes_boundaries / pack_codes_fused, as runner.py
               calls them)
  ingest, compact, spill, remerge, replay, host_merge, host_route,
  finalize     DeviceKmerStore's methods of those steps (ops/store.py)
  write        Kmc2DbWriter's record write and close (formats/kmc_db.py)

Where the sharded count is loaded (kmc_tpu_torch.parallel.multihost), the
exchange's calls record their bytes too (roofline.exchange_bytes).
"""
from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from torch.profiler import record_function

from . import roofline

STORE_SPANS = {"_ingest": "ingest", "compact": "compact", "spill": "spill",
               "_remerge_spilled": "remerge", "_replay_spills": "replay",
               "_host_merge": "host_merge",
               "_finalize_records_host": "host_route",
               "finalize_records": "finalize"}
WRITER_SPANS = {"write_all_records": "write", "close": "write"}


class _SortProbe:
    """Stands in for radix_sort_columns in the store's module: records
    each call's bytes and keeps the function's launch counter readable."""

    def __init__(self, fn, probes):
        self._fn = fn
        self._probes = probes

    @property
    def launches(self):
        return self._fn.launches

    def __call__(self, cols, n_keys):
        self._probes.add("sort", roofline.sort_bytes(cols[0].shape[0],
                                                     len(cols)))
        return self._fn(cols, n_keys)


class Probes:
    """Per job: seconds in each span (spans[name][job]) and bytes of each
    kernel's calls (bytes[name][job])."""

    def __init__(self):
        self.job = -1
        self.spans = defaultdict(lambda: defaultdict(float))
        self.bytes = defaultdict(lambda: defaultdict(int))
        self._lock = threading.Lock()
        self._undo = []

    def add(self, kernel: str, nbytes: int):
        with self._lock:
            self.bytes[kernel][self.job] += nbytes

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with record_function(name):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.spans[name][self.job] += dt

    def _patch(self, owner, attr, value):
        self._undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, value)

    def _wrap(self, fn, name):
        probes = self

        def wrapped(*args, **kw):
            with probes.span(name):
                return fn(*args, **kw)
        return wrapped

    def install(self):
        from kmc_tpu_torch import runner
        from kmc_tpu_torch.formats import kmc_db
        from kmc_tpu_torch.io import readers
        from kmc_tpu_torch.ops import store

        probes = self
        batches = readers.BatchStream.__dict__["batches"]

        def timed_batches(bs, chunks):
            it = batches(bs, chunks)
            while True:
                with probes.span("host_input"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch

        self._patch(readers.BatchStream, "batches", timed_batches)
        for fn in ("pack_codes_boundaries", "pack_codes_fused"):
            self._patch(runner, fn, self._wrap(getattr(runner, fn),
                                               "host_input"))
        cls = store.DeviceKmerStore
        for attr, name in STORE_SPANS.items():
            self._patch(cls, attr, self._wrap(cls.__dict__[attr], name))
        for attr, name in WRITER_SPANS.items():
            self._patch(kmc_db.Kmc2DbWriter, attr,
                        self._wrap(kmc_db.Kmc2DbWriter.__dict__[attr], name))
        ingest = store.ingest

        def counted_ingest(buf, tail_start, key_cols, counts, *args, **kw):
            probes.add("ingest", roofline.ingest_bytes(
                buf.numel(), kw["s"], len(key_cols) + (counts is not None)))
            return ingest(buf, tail_start, key_cols, counts, *args, **kw)

        self._patch(store, "ingest", counted_ingest)
        self._patch(store, "radix_sort_columns",
                    _SortProbe(store.radix_sort_columns, self))
        multihost = sys.modules.get("kmc_tpu_torch.parallel.multihost")
        if multihost is not None:
            a2a = multihost.ragged_all_to_all

            def counted_a2a(xs, n_rows):
                probes.add("exchange", roofline.exchange_bytes(
                    n_rows, xs[0].shape[-1]))
                return a2a(xs, n_rows)

            self._patch(multihost, "ragged_all_to_all", counted_a2a)

    def remove(self):
        while self._undo:
            owner, attr, value = self._undo.pop()
            setattr(owner, attr, value)

    def per_job(self, table, name, jobs) -> list:
        """table[name][j] for each job j of jobs."""
        return [table[name].get(j, 0) for j in jobs]
