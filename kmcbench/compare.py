"""The comparison that decides `correct`: the program's outputs against
the plain reference, as numbers each held to a limit.

Every number counts faults, so each limit is 0 (an exact comparison):

  records_wrong      records of the last job's database that are missing,
                     extra (or repeated), or whose counter differs
  records_misplaced  records outside the bin their signature maps to in
                     the file's own map, or out of order inside a bin,
                     where KMC's readers would not find them
  header_wrong       header and LUT fields that differ: k, counter size,
                     cutoffs, strands, the k-mers stored, the LUTs' count
  jobs_wrong         jobs whose stage-2 counts (n_total_kmers,
                     n_unique_kmers, n_below_cutoff_min,
                     n_above_cutoff_max) differ
"""
from __future__ import annotations

import torch

from . import kmc2
from .reference import Counted, signatures

LIMITS = {"records_wrong": 0, "records_misplaced": 0, "header_wrong": 0,
          "jobs_wrong": 0}


def records_wrong(ref_keys, ref_counters, keys, counters) -> int:
    """Missing, extra or repeated records, and records whose counter
    differs from the reference's."""
    keys, order = torch.sort(keys)
    counters = counters[order]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    repeated = int((~first).sum())
    keys, counters = keys[first], counters[first]
    at = torch.searchsorted(ref_keys, keys).clamp(max=max(
        ref_keys.numel() - 1, 0))
    if ref_keys.numel():
        found = ref_keys[at] == keys
    else:
        found = torch.zeros_like(keys, dtype=torch.bool)
    n_found = int(found.sum())
    wrong_counter = int((counters[found] != ref_counters[at[found]]).sum())
    extra = keys.numel() - n_found
    missing = ref_keys.numel() - n_found
    return repeated + extra + missing + wrong_counter


def records_misplaced(db: kmc2.Db, kmers, lut_index) -> int:
    """Records whose bin is not sig_map[signature], plus places inside a
    bin where the k-mers do not ascend."""
    if not kmers.numel():
        return 0
    per_bin = 1 << (2 * db.lut_prefix_len)
    bins = lut_index // per_bin
    sig_map = torch.from_numpy(db.sig_map.astype("int64")).to(kmers.device)
    want = sig_map[signatures(kmers, db.k, db.sig_len)]
    wrong_bin = int((bins != want).sum())
    same_bin = bins[1:] == bins[:-1]
    unordered = int((same_bin & (kmers[1:] <= kmers[:-1])).sum())
    return wrong_bin + unordered


def header_wrong(db: kmc2.Db, *, k, counter_size, cutoff_min, cutoff_max,
                 both_strands, n_kept) -> int:
    fields = [(db.k, k), (db.counter_size, counter_size),
              (db.cutoff_min, cutoff_min),
              (db.cutoff_max, cutoff_max & 0xFFFFFFFF),
              (db.both_strands, both_strands), (db.n_stored, n_kept),
              (db.n_records, n_kept)]
    return sum(a != b for a, b in fields)


def jobs_wrong(job_stats: list, ref_stats: dict) -> int:
    return sum(s != ref_stats for s in job_stats)


def counter_size(cutoff_max: int, counter_max: int) -> int:
    """Bytes of a stored counter (KMC's defs.h: none for counter_max 1,
    else the bytes that hold min(cutoff_max, counter_max))."""
    if counter_max == 1:
        return 0
    return max(1, (min(cutoff_max, counter_max).bit_length() + 7) // 8)


def judge_db(prefix, ref: Counted, knobs: dict, job_stats: list,
             device) -> dict:
    """Every number, against the reference, of the database at prefix and
    the jobs' stage-2 counts; a database that cannot be read counts all
    its records wrong."""
    cmin, cmax = knobs["cutoff_min"], knobs["cutoff_max"]
    ref_keys, ref_counters = ref.kept(cmin, cmax, knobs["counter_max"])
    out = {"jobs_wrong": jobs_wrong(job_stats, ref.stats(cmin, cmax))}
    try:
        db = kmc2.read(prefix)
        kmers, counters, lut_index = kmc2.decode(db, device)
    except (OSError, ValueError, RuntimeError) as e:
        out.update(records_wrong=ref_keys.numel() + 1,
                   records_misplaced=ref_keys.numel() + 1,
                   header_wrong=1, unreadable=str(e))
        return out
    out["records_wrong"] = records_wrong(ref_keys, ref_counters, kmers,
                                         counters)
    out["records_misplaced"] = records_misplaced(db, kmers, lut_index)
    out["header_wrong"] = header_wrong(
        db, k=knobs["kmer_len"],
        counter_size=counter_size(cmax, knobs["counter_max"]),
        cutoff_min=cmin, cutoff_max=cmax,
        both_strands=knobs["canonical_kmers"], n_kept=ref_keys.numel())
    return out


def checks(numbers: dict) -> dict:
    """{name: {"value": n, "limit": limit}} for every compared number."""
    return {name: {"value": numbers[name], "limit": lim}
            for name, lim in LIMITS.items() if name in numbers}


def passed(numbers: dict) -> bool:
    """Whether every compared number present is within its limit."""
    return all(numbers[name] <= lim for name, lim in LIMITS.items()
               if name in numbers)
