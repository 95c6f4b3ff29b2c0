"""Drop-in replacement for KMC's py_kmc_api module, on the port's API (the
counterpart of the repository's root py_kmc_api.py over kmc_tpu).

KMC ships a pybind11 module exposing KMCFile / KmerAPI / Count /
CountVec (py_kmc_api/py_kmc_api.cpp:27-98) whose query methods fill mutable
out-params; scripts written against it (`import py_kmc_api as pka`) work
unchanged against kmc_tpu_torch (`import kmc_tpu_torch.py_kmc_api as
pka`).  Out-params are optional here — without them the
methods return values directly (the kmc_tpu_torch.api style).
"""
from .api import KMCFileInfo  # noqa: F401
from .api import KmerAPI as _KmerAPI
from .api import KMCFile as _KMCFile


class Count:
    """Mutable out-param mirroring py_kmc_api.Count."""

    def __init__(self, value: int = 0):
        self.value = value


class Count64(Count):
    pass


class CountVec:
    """Mutable vector out-param mirroring py_kmc_api.CountVec."""

    def __init__(self):
        self.value = []


class LongKmerRepresentation:
    def __init__(self):
        self.value = []


class KmerAPI(_KmerAPI):
    """py_kmc_api-compatible k-mer object: out-param to_long variant
    (py_kmc_api.cpp:65)."""

    def to_long(self, res: LongKmerRepresentation | None = None):
        words = super().to_long()
        if res is not None:
            res.value = words
            return None
        return words


class KMCFile(_KMCFile):
    """py_kmc_api-compatible facade: out-param variants of the queries."""

    def CheckKmer(self, kmer, count: Count | None = None):
        found, c = super().CheckKmer(kmer)
        if count is not None:
            count.value = c
            return found
        return found, c

    def ReadNextKmer(self, kmer, count: Count | None = None):
        ok, c = super().ReadNextKmer(kmer)
        if count is not None:
            count.value = c
            return ok
        return ok, c

    def GetCountersForRead(self, read, counts: CountVec | None = None):
        ok, vec = super().GetCountersForRead(read)
        if counts is not None:
            counts.value = vec
            return ok
        return ok, vec
