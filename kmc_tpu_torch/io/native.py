"""ctypes bindings for the native host runtime (native/kmc_host.cpp).

The port's counterpart of kmc_tpu/io/native.py.  The shared library is built
on first use from the same source with the same g++ command, together with
the port's chunk reader (csrc/read_parse.cpp), into the port's own build
directory (kmc_tpu_torch/_build/native/), keyed on a hash of the sources
(the build is -march=native, so a copied binary must not mask a source
change).  The port has no NumPy parser: a machine that cannot build the
runtime raises when input is first read.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_lock = threading.Lock()
_lib = None

_SRCS = (Path(__file__).resolve().parent.parent.parent / "native" / "kmc_host.cpp",
         Path(__file__).resolve().parent.parent / "csrc" / "read_parse.cpp")
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
# read_parse_chunk's source of last resort: fill(buf, n) -> bytes written
FILL = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64)


def _load() -> ctypes.CDLL:
    digest = hashlib.sha256(b"".join(p.read_bytes()
                                     for p in _SRCS)).hexdigest()[:16]
    so = _BUILD_DIR / f"libkmc_host-{digest}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(".so.tmp%d" % os.getpid())
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               *map(str, _SRCS), "-o", str(tmp), "-lz"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode:
            raise RuntimeError(
                f"building the native host runtime failed:\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.parse_fastq.restype = ctypes.c_int64
    lib.parse_fastq.argtypes = [u8p, ctypes.c_int64, u8p, i64p]
    lib.parse_fasta.restype = ctypes.c_int64
    lib.parse_fasta.argtypes = [u8p, ctypes.c_int64, u8p, i64p]
    lib.parse_bam.restype = ctypes.c_int64
    lib.parse_bam.argtypes = [u8p, ctypes.c_int64, u8p, i64p, i64p]
    lib.gz_open.restype = ctypes.c_void_p
    lib.gz_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gz_read.restype = ctypes.c_int64
    lib.gz_read.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
    lib.gz_close.restype = None
    lib.gz_close.argtypes = [ctypes.c_void_p]
    lib.read_parse_chunk.restype = ctypes.c_int64
    lib.read_parse_chunk.argtypes = [
        ctypes.c_int, ctypes.c_void_p, FILL, ctypes.c_int, u8p,
        ctypes.c_int64, ctypes.c_int64, u8p, i64p, i64p]
    lib.pack_codes_fused.restype = None
    lib.pack_codes_fused.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.pack_codes_boundaries.restype = ctypes.c_int64
    lib.pack_codes_boundaries.argtypes = [
        u8p, ctypes.c_int64, u8p, ctypes.c_int64, i64p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeParser:
    """Resumable FASTQ/FASTA byte->code parser backed by the C library."""

    def __init__(self, fmt: str):
        lib = get_lib()
        if fmt == "fastq":
            self._fn = lib.parse_fastq
        elif fmt in ("fasta", "multifasta"):
            self._fn = lib.parse_fasta
        else:
            raise ValueError(fmt)
        self._lib = lib
        self._fasta = fmt != "fastq"
        self.state = np.zeros(2, dtype=np.int64)

    @property
    def n_reads(self) -> int:
        return int(self.state[1])

    def parse(self, buf: np.ndarray) -> np.ndarray:
        out = np.empty(len(buf) + 1, dtype=np.uint8)
        n = self._fn(
            _u8ptr(buf),
            len(buf),
            _u8ptr(out),
            self.state.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out[:n]

    def read_chunk(self, reader, buf: np.ndarray, want: int):
        """One chunk: at most `want` input bytes read from reader in pieces
        of at most len(buf), the read buffer, each parsed as soon as it is
        read, its codes written at the running offset of one output for the
        chunk; all in one native call (csrc/read_parse.cpp), which holds
        the interpreter lock only to call a Python reader back.  reader: a
        raw file, read from its offset; a NativeGzReader; or anything with
        read_into(view), called for each piece.  Returns (codes, input
        bytes read, whether they end in a newline, pieces, seconds spent
        reading)."""
        out = np.empty(want + 1, dtype=np.uint8)  # at most a code a byte
        io = np.zeros(4, dtype=np.int64)
        fd, gz, errors = -1, None, []
        if isinstance(reader, NativeGzReader):
            gz = reader.handle
        elif hasattr(reader, "fileno"):
            fd = reader.fileno()

        def fill(_, n):
            try:
                return reader.read_into(buf[:n])
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
                return -1

        i64p = ctypes.POINTER(ctypes.c_int64)
        callback = FILL(fill)  # alive for the call
        m = self._lib.read_parse_chunk(
            fd, gz, callback, self._fasta, _u8ptr(buf), len(buf), want,
            _u8ptr(out), self.state.ctypes.data_as(i64p),
            io.ctypes.data_as(i64p))
        if m < 0:
            if errors:
                raise errors[0]
            raise OSError("gzip inflate error" if gz else "input read error")
        return out[:m], int(io[0]), io[1] == 10, int(io[2]), io[3] / 1e9


class NativeBamParser:
    """Resumable BAM record parser backed by the C library (parse_bam):
    feed inflated BGZF bytes, get code chunks.  Unconsumed tail bytes (a
    record split across feeds) are carried internally."""

    def __init__(self, both_strands: bool = True):
        self.lib = get_lib()
        self.state = np.zeros(5, dtype=np.int64)
        self.state[4] = 1 if both_strands else 0
        self._carry = np.zeros(0, dtype=np.uint8)

    @property
    def n_reads(self) -> int:
        return int(self.state[3])

    def parse(self, chunk: np.ndarray) -> np.ndarray:
        if len(self._carry):
            chunk = np.concatenate([self._carry, chunk])
        n = len(chunk)
        out = np.empty(2 * n + n // 16 + 64, dtype=np.uint8)
        consumed = ctypes.c_int64(0)
        m = self.lib.parse_bam(
            _u8ptr(chunk), n, _u8ptr(out),
            self.state.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.byref(consumed),
        )
        if m < 0:
            raise ValueError("malformed BAM stream")
        self._carry = chunk[consumed.value :].copy()
        return out[:m]


class NativeGzReader:
    """Streaming gzip reader (multi-member aware) backed by zlib."""

    def __init__(self, path: str, in_buf_bytes: int = 4 << 20):
        self.lib = get_lib()
        self.handle = self.lib.gz_open(str(path).encode(), in_buf_bytes)
        if not self.handle:
            raise OSError(f"cannot open {path}")

    def read_into(self, out: np.ndarray) -> int:
        n = self.lib.gz_read(self.handle, _u8ptr(out), len(out))
        if n < 0:
            raise OSError("gzip inflate error")
        return int(n)

    def close(self):
        if getattr(self, "handle", None):
            self.lib.gz_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()


def pack_codes_fused(codes: np.ndarray) -> np.ndarray:
    """codes u8[n] (n % 8 == 0) -> one u8[3n/8] buffer: packed 2-bit codes
    (4 per byte, first code in the top bits) followed by the validity
    bitmask (MSB-first), for one host-to-device copy."""
    n = len(codes)
    if n % 8:
        raise ValueError("pack_codes_fused needs a length divisible by 8")
    codes = np.ascontiguousarray(codes)
    out = np.empty(n // 4 + n // 8, dtype=np.uint8)
    get_lib().pack_codes_fused(_u8ptr(codes), n, _u8ptr(out))
    return out


def boundary_capacity(n: int) -> int:
    """Delta slots reserved per n-code batch (one per <=64-code read)."""
    return n // 64


def pack_codes_boundaries(codes: np.ndarray):
    """codes u8[n] -> (buf u8[n/4 + 2*boundary_capacity(n)], tail_start)
    in the boundary-delta feed format (see native/kmc_host.cpp), or
    (None, -1) when the batch is sentinel-dense and must use the masked
    format.  Codes at [tail_start, n) are a trailing sentinel run (batch
    padding), marked invalid on the device from the scalar."""
    n = len(codes)
    if n % 8:
        raise ValueError("pack_codes_boundaries needs a length divisible by 8")
    codes = np.ascontiguousarray(codes)
    max_b = boundary_capacity(n)
    buf = np.empty(n // 4 + 2 * max_b, np.uint8)
    ts = ctypes.c_int64(0)
    b = get_lib().pack_codes_boundaries(_u8ptr(codes), n, _u8ptr(buf), max_b,
                                        ctypes.byref(ts))
    if b < 0:
        return None, -1
    return buf, int(ts.value)
