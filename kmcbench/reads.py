"""The one generator of the benchmark's input: a seeded genome and the
reads of a sequencing run over it, as 2-bit codes and as FASTQ bytes.

The configuration gives the genome (length, repeat families), the
traffic mix the sample (coverage, read length, substitution rate, share of reads from the
reverse strand) and whether its file is compressed (compress.py).  Reads
come in blocks of BLOCK_READS, each drawn from a generator seeded by
(seed, block index), so any block can be made again alone and the same
seed gives the same reads on the same device type.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from . import compress

BLOCK_READS = 1 << 19
ID_DIGITS = 10  # "@" + a zero-padded read number: every record one length
_ACGT = (65, 67, 71, 84)


@dataclass(frozen=True)
class Sample:
    genome_bp: int
    coverage: int
    read_len: int
    substitution_rate: float
    reverse_share: float
    repeats: tuple = ()  # (length, copies) of each repeat family

    @classmethod
    def of(cls, config: dict, traffic: dict) -> "Sample":
        return cls(genome_bp=int(config["genome_bp"]),
                   coverage=int(traffic["coverage"]),
                   read_len=int(traffic["read_len"]),
                   substitution_rate=float(traffic["substitution_rate"]),
                   reverse_share=float(traffic["reverse_share"]),
                   repeats=tuple((int(r["length"]), int(r["copies"]))
                                 for r in config.get("repeats", ())))

    @property
    def n_reads(self) -> int:
        return self.genome_bp * self.coverage // self.read_len

    def n_kmers(self, k: int) -> int:
        return self.n_reads * max(self.read_len - k + 1, 0)


def _seed(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run's seed and a stream's tags."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def _gen(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, *tags))
    return g


def genome(sample: Sample, seed: int, device) -> torch.Tensor:
    """uint8[genome_bp] codes 0..3: uniform bases, with each repeat
    family's unit (its own uniform bases) written over the genome as
    identical copies.  The genome is cut into one slot for each copy of
    every family, and each copy lies at a uniform offset inside its slot,
    so copies never overlap."""
    g = _gen(device, seed, "genome")
    codes = torch.randint(0, 4, (sample.genome_bp,), generator=g,
                          device=device, dtype=torch.uint8)
    n_slots = sum(copies for _, copies in sample.repeats)
    slot = sample.genome_bp // max(n_slots, 1)
    first = 0
    for f, (length, copies) in enumerate(sample.repeats):
        if not 0 < length <= slot:
            raise ValueError(f"a repeat of {length} bp does not fit a slot "
                             f"of {slot} bp")
        g = _gen(device, seed, "repeat", f)
        unit = torch.randint(0, 4, (length,), generator=g, device=device,
                             dtype=torch.uint8)
        starts = torch.randint(0, slot - length + 1, (copies,), generator=g,
                               device=device)
        starts += slot * torch.arange(first, first + copies, device=device)
        codes[starts[:, None] + torch.arange(length, device=device)] = unit
        first += copies
    return codes


def read_blocks(sample: Sample, seed: int, device, ref: torch.Tensor = None):
    """Yield (first read number, uint8[n, read_len] codes) block by block.

    Each read starts at a uniform position of the genome, takes uniform
    substitutions (a base replaced by one of the three others) and, with
    probability reverse_share, is the reverse complement."""
    ref = genome(sample, seed, device) if ref is None else ref
    L = sample.read_len
    span = torch.arange(L, device=device)
    for b, lo in enumerate(range(0, sample.n_reads, BLOCK_READS)):
        n = min(BLOCK_READS, sample.n_reads - lo)
        g = _gen(device, seed, "reads", b)
        starts = torch.randint(0, sample.genome_bp - L + 1, (n, 1),
                               generator=g, device=device)
        codes = ref[starts + span]
        hit = torch.rand((n, L), generator=g, device=device) < \
            sample.substitution_rate
        shift = torch.randint(1, 4, (n, L), generator=g, device=device,
                              dtype=torch.uint8)
        codes = torch.where(hit, (codes + shift) & 3, codes)
        rev = torch.rand((n,), generator=g, device=device) < \
            sample.reverse_share
        codes = torch.where(rev[:, None], 3 - codes.flip(1), codes)
        yield lo, codes


def fastq_block(first: int, codes: torch.Tensor) -> torch.Tensor:
    """uint8[n * (2 * read_len + 16)]: the block's reads as FASTQ records
    ("@<10-digit number>", the bases, "+", a quality line of 'I')."""
    n, L = codes.shape
    dev = codes.device
    rec = torch.empty((n, 1 + ID_DIGITS + 1 + L + 3 + L + 1),
                      dtype=torch.uint8, device=dev)
    rec[:, 0] = ord("@")
    ids = torch.arange(first, first + n, device=dev, dtype=torch.int64)
    for j in range(ID_DIGITS):
        rec[:, ID_DIGITS - j] = (ids % 10 + 48).to(torch.uint8)
        ids = ids // 10
    rec[:, ID_DIGITS + 1] = ord("\n")
    lo = ID_DIGITS + 2
    rec[:, lo:lo + L] = torch.tensor(_ACGT, dtype=torch.uint8,
                                     device=dev)[codes.long()]
    rec[:, lo + L:lo + L + 3] = torch.tensor(list(b"\n+\n"),
                                             dtype=torch.uint8, device=dev)
    rec[:, lo + L + 3:lo + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.reshape(-1)


def write_fastq(path, sample: Sample, seed: int, device,
                compression: str = None, log=None) -> int:
    """Write the sample's reads to path as FASTQ, block by block, or with
    compression ("gzip" or "bgzf") as a compressed file of those bytes
    (compress.Writer); returns the FASTQ's bytes, before any compression.
    log, if given, gets a line of the compressed bytes and the
    compression's seconds."""
    total = 0
    gz = None if compression is None else compress.Writer(path, compression)
    with gz or open(path, "wb") as f:
        for first, codes in read_blocks(sample, seed, device):
            data = fastq_block(first, codes).cpu().numpy()
            f.write(data)
            total += data.nbytes
    if gz is not None and log is not None:
        log(f"compressed: {gz.compressed_bytes} bytes of {compression} at "
            f"level {compress.LEVEL} from {total}; the pool's compression "
            f"{gz.cpu_s:.3f} s of CPU, set-up waiting on it {gz.wait_s:.3f} s")
    return total
