"""A frozen reader of KMC2 databases (.kmc_pre / .kmc_suf), the layout of
KMC 3's kmc_api/kmc_file.cpp, that decodes every record on a torch device.

.kmc_pre: "KMCP", the LUTs (uint64 start offsets, n_bins * 4^lpl of them,
then the record count), the signature map (uint32[4^m + 1]: signature ->
LUT index), the header (k, mode, counter size, lpl, m, cutoff min and max,
k-mers stored, strand flag, then the version 0x200 at its end), the
header's length and "KMCP".  .kmc_suf: "KMCS", the records (the k-mer's
last (k - lpl) / 4 bytes, then the little-endian counter), "KMCS".
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

KMC2_VERSION = 0x200


@dataclass
class Db:
    k: int
    mode: int
    counter_size: int
    lut_prefix_len: int
    sig_len: int
    cutoff_min: int
    cutoff_max: int
    n_stored: int        # the header's k-mer count
    n_records: int       # the count after the LUTs
    both_strands: bool
    luts: np.ndarray     # uint64 start offsets, n_bins * 4^lpl of them
    sig_map: np.ndarray  # uint32[4^m + 1]
    suffix: bytes        # .kmc_suf's bytes between its markers

    @property
    def suffix_bytes(self) -> int:
        return (self.k - self.lut_prefix_len) // 4

    @property
    def record_bytes(self) -> int:
        return self.suffix_bytes + self.counter_size


def read(prefix) -> Db:
    """Parse a KMC2 database; raises ValueError on a malformed file."""
    pre = Path(str(prefix) + ".kmc_pre").read_bytes()
    suf = Path(str(prefix) + ".kmc_suf").read_bytes()
    if pre[:4] != b"KMCP" or pre[-4:] != b"KMCP":
        raise ValueError("bad .kmc_pre markers")
    if suf[:4] != b"KMCS" or suf[-4:] != b"KMCS":
        raise ValueError("bad .kmc_suf markers")
    (hlen,) = struct.unpack_from("<I", pre, len(pre) - 8)
    hstart = len(pre) - 8 - hlen
    (version,) = struct.unpack_from("<I", pre, len(pre) - 12)
    if version != KMC2_VERSION or hstart < 4:
        raise ValueError(f"not a KMC2 database (version 0x{version:x})")
    (k, mode, counter_size, lpl, m, cmin, cmax,
     n_stored) = struct.unpack_from("<IIIIIIIQ", pre, hstart)
    both = pre[hstart + 36] == 0
    map_len = (1 << (2 * m)) + 1
    map_start = hstart - 4 * map_len
    sig_map = np.frombuffer(pre, dtype="<u4", count=map_len,
                            offset=map_start).astype(np.uint32)
    n_lut = (map_start - 4) // 8 - 1
    if n_lut < 1 or (map_start - 4) % 8 or n_lut % (1 << (2 * lpl)):
        raise ValueError("bad .kmc_pre layout")
    luts = np.frombuffer(pre, dtype="<u8", count=n_lut + 1,
                         offset=4).astype(np.uint64)
    return Db(k=k, mode=mode, counter_size=counter_size, lut_prefix_len=lpl,
              sig_len=m, cutoff_min=cmin, cutoff_max=cmax, n_stored=n_stored,
              n_records=int(luts[-1]), both_strands=both, luts=luts[:-1],
              sig_map=sig_map, suffix=suf[4:-4])


def decode(db: Db, device):
    """(k-mers int64, counters int64, LUT index int64) of every record, in
    file order, on device.  k <= 31; the LUT index is bin * 4^lpl +
    prefix."""
    if db.k > 31:
        raise ValueError("the decoder holds k-mers of at most 31 bases")
    rb = db.record_bytes
    if len(db.suffix) != db.n_records * rb:
        raise ValueError(".kmc_suf length does not match the LUT's count")
    rec = torch.frombuffer(bytearray(db.suffix), dtype=torch.uint8).view(
        db.n_records, rb).to(device).long()
    starts = torch.from_numpy(db.luts.astype(np.int64)).to(device)
    ends = torch.cat([starts[1:], torch.tensor([db.n_records],
                                               device=device)])
    sizes = ends - starts
    if bool((sizes < 0).any()):
        raise ValueError("LUT offsets decrease")
    lut_index = torch.repeat_interleave(
        torch.arange(len(starts), device=device), sizes)
    sb = db.suffix_bytes
    kmer = lut_index & ((1 << (2 * db.lut_prefix_len)) - 1)
    for j in range(sb):
        kmer = (kmer << 8) | rec[:, j]
    counter = torch.zeros(db.n_records, dtype=torch.int64, device=device)
    for j in reversed(range(db.counter_size)):
        counter = (counter << 8) | rec[:, sb + j]
    return kmer, counter, lut_index
