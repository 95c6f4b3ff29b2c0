"""kmc CLI on the PyTorch/CUDA port (the counterpart of kmc_tpu/cli.py).

Same flag grammar, positional arguments, summary text and -j JSON schema as
kmc_tpu's CLI (and KMC's kmc binary), plus --device=<cuda|cpu> (default
cuda).  With KMC_TPU_DEVELOP set (kmc_tpu's variable) it also writes the
develop-mode files beside the output (develop.py).

    python -m kmc_tpu_torch.cli -k27 -ci2 reads.fastq out_db tmp_dir
"""
from __future__ import annotations

import json
import os
import random
import sys

from . import defs
from .runner import (
    EstimateHistogramCfg,
    InputFileType,
    OutputFileType,
    Runner,
    Stage1Params,
    Stage2Params,
)

USAGE = f"""K-Mer Counter (kmc_tpu_torch) ver. {defs.KMC_TPU_VER} (PyTorch/CUDA)
Usage:
 kmc_tpu_torch [options] <input_file_name> <output_file_name> <working_directory>
 kmc_tpu_torch [options] <@input_file_names> <output_file_name> <working_directory>
Parameters:
  input_file_name - single file in specified (-f switch) format (gziped or not)
  @input_file_names - file name with list of input files in specified (-f switch) format (gziped or not)
Options:
  -v - verbose mode (shows all parameter settings); default: false
  -k<len> - k-mer length (k from {defs.MIN_K} to {defs.MAX_K}; default: 25)
  -m<size> - max amount of RAM in GB (from 1 to 1024); default: 12
  -sm - use strict memory mode (memory limit from -m<n> switch will not be exceeded)
  -hc - count homopolymer compressed k-mers (approximate and experimental)
  -p<par> - signature length (5, 6, 7, 8, 9, 10, 11); default: 9
  -f<a/q/m/bam/kmc> - input in FASTA format (-fa), FASTQ format (-fq), multi FASTA (-fm) or BAM (-fbam) or KMC (-fkmc); default: FASTQ
  -ci<value> - exclude k-mers occurring less than <value> times (default: 2)
  -cs<value> - maximal value of a counter (default: 255)
  -cx<value> - exclude k-mers occurring more of than <value> times (default: 1e9)
  -b - turn off transformation of k-mers into canonical form
  -r - turn on RAM-only mode
  -n<value> - number of bins
  -t<value> - total number of threads (default: no. of CPU cores)
  -sf<value> - number of FASTQ reading threads (overrides -t for readers)
  -sp<value> - number of splitting threads (no-op: splitting runs on the device)
  -sr<value> - number of threads for 2nd stage (no-op: stage 2 runs on the device)
  -j<file_name> - file name with execution summary in JSON format
  -w - without output
  -o<kmc/kff> - output in KMC of KFF format; default: KMC
  -hp - hide percentage progress (default: false)
  -e - only estimate histogram of k-mers occurrences instead of exact k-mer counting
  --opt-out-size - optimize output database size (may increase running time)
Device options:
  -S<value> - device batch size (candidate k-mer positions per batch)
  --no-device-store - stage bins in host RAM instead of device memory
  --device=<cuda|cpu> - device to count on (default: cuda; never falls back)
Example:
kmc_tpu_torch -k27 -m24 NA19238.fastq NA.res /data/kmc_tmp_dir/
"""


class CliError(Exception):
    pass


def parse_args(argv):
    s1 = Stage1Params()
    s2 = Stage2Params()
    cli = {"json_summary": "", "device": "cuda"}
    positional = []
    i = 0
    while i < len(argv):
        a = argv[i]
        i += 1
        if not a.startswith("-") or len(positional) > 0:
            positional.append(a)
            continue
        if a == "--opt-out-size":
            # estimate + count: the histogram estimate drives the
            # lut_prefix_len choice (reference kmc.h:1436-1447)
            if s1.estimate_histogram_cfg == EstimateHistogramCfg.DONT_ESTIMATE:
                s1.estimate_histogram_cfg = (
                    EstimateHistogramCfg.ESTIMATE_AND_COUNT_KMERS
                )
        elif a == "--no-device-store":
            s1.device_store = False
        elif a == "-v":
            s1.verbose = True
        elif a == "-sm":
            s1.strict_memory_mode = True
            s2.strict_memory_mode = True
        elif a == "-hc":
            s1.homopolymer_compressed = True
        elif a == "-b":
            s1.canonical_kmers = False
        elif a == "-r":
            s1.ram_only_mode = True
        elif a == "-w":
            s2.without_output = True
        elif a == "-hp":
            cli["hide_progress"] = True
        elif a == "-e":
            s1.estimate_histogram_cfg = EstimateHistogramCfg.ONLY_ESTIMATE
        elif a.startswith("-k"):
            s1.kmer_len = int(a[2:])
        elif a.startswith("-m"):
            s1.max_ram_gb = s2.max_ram_gb = int(a[2:])
        elif a.startswith("-p"):
            s1.signature_len = int(a[2:])
        elif a.startswith("-f"):
            fmt = a[2:]
            mapping = {
                "a": InputFileType.FASTA,
                "q": InputFileType.FASTQ,
                "m": InputFileType.MULTILINE_FASTA,
                "bam": InputFileType.BAM,
                "kmc": InputFileType.KMC,
            }
            if fmt not in mapping:
                raise CliError(f"unknown input format -f{fmt}")
            s1.input_file_type = mapping[fmt]
        elif a.startswith("-ci"):
            s2.cutoff_min = int(a[3:])
        elif a.startswith("-cs"):
            s2.counter_max = int(a[3:])
        elif a.startswith("-cx"):
            s2.cutoff_max = int(a[3:])
        elif a.startswith("-n"):
            s1.n_bins = int(a[2:])
        elif a.startswith("-t"):
            s1.n_threads = s2.n_threads = int(a[2:])
        elif a.startswith("-sf"):
            # reader threads (reference kmc.h:276-292): bounds the
            # parser-thread pool independently of -t
            s1.n_reader_threads = int(a[3:])
        elif a.startswith("-sp"):
            pass  # splitter threads: the device splitter scan (no-op)
        elif a.startswith("-sr"):
            pass  # stage-2 sorter threads: the device sort (no-op)
        elif a.startswith("-j"):
            cli["json_summary"] = a[2:]
        elif a.startswith("-o"):
            fmt = a[2:]
            if fmt == "kmc":
                s2.output_file_type = OutputFileType.KMC
            elif fmt == "kff":
                s2.output_file_type = OutputFileType.KFF
            else:
                raise CliError(f"unknown output format -o{fmt}")
        elif a.startswith("-S"):
            s1.batch_positions = int(a[2:])
        elif a.startswith("--device="):
            cli["device"] = a[len("--device="):]
        else:
            raise CliError(f"unknown option {a}")
    if len(positional) != 3:
        raise CliError("expected <input> <output> <working_directory>")
    inp, out, tmp = positional
    if inp.startswith("@"):
        with open(inp[1:]) as f:
            files = [line.strip() for line in f if line.strip()]
        # reference shuffles the input list for load balance (kmc.cpp:250-269)
        random.shuffle(files)
        s1.input_files = files
    else:
        s1.input_files = [inp]
    s1.tmp_path = tmp
    s2.output_file_name = out
    return s1, s2, cli


def format_summary(s1p, r1, r2) -> str:
    lines = [
        f"1st stage: {r1.time:g}s",
        f"2nd stage: {r2.time:g}s",
        f"Total    : {r1.time + r2.time:g}s",
        f"Tmp size : {r1.tmp_size // 1000000}MB",
        "",
        "Stats:",
        f"   No. of k-mers below min. threshold : {r2.n_below_cutoff_min:>12}",
        f"   No. of k-mers above max. threshold : {r2.n_above_cutoff_max:>12}",
        f"   No. of unique k-mers               : {r2.n_unique_kmers:>12}",
        f"   No. of unique counted k-mers       : "
        f"{r2.n_unique_kmers - r2.n_below_cutoff_min - r2.n_above_cutoff_max:>12}",
        f"   Total no. of k-mers                : {r2.n_total_kmers:>12}",
    ]
    if s1p.input_file_type != InputFileType.MULTILINE_FASTA:
        lines.append(f"   Total no. of reads                 : {r1.n_sequences:>12}")
    else:
        lines.append(f"   Total no. of sequences             : {r1.n_sequences:>12}")
    lines.append(f"   Total no. of super-k-mers          : {r1.n_total_super_kmers:>12}")
    return "\n".join(lines)


def save_json_summary(path, s1p, r1, r2):
    reads_key = (
        "#Total_reads"
        if s1p.input_file_type != InputFileType.MULTILINE_FASTA
        else "#Total_sequences"
    )
    doc = {
        "1st_stage": f"{r1.time:g}s",
        "2nd_stage": f"{r2.time:g}s",
        "Total": f"{r1.time + r2.time:g}s",
        "Tmp_size": f"{r1.tmp_size // 1000000}MB",
        "Stats": {
            "#k-mers_below_min_threshold": r2.n_below_cutoff_min,
            "#k-mers_above_max_threshold": r2.n_above_cutoff_max,
            "#Unique_k-mers": r2.n_unique_kmers,
            "#Unique_counted_k-mers": r2.n_unique_kmers
            - r2.n_below_cutoff_min
            - r2.n_above_cutoff_max,
            "#Total no. of k-mers": r2.n_total_kmers,
            reads_key: r1.n_sequences,
            "#Total_super-k-mers": r1.n_total_super_kmers,
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent="\t")
        f.write("\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or "--help" in argv:
        print(USAGE)
        return 0
    if "--version" in argv:
        print(USAGE.splitlines()[0])
        return 0
    try:
        s1, s2, cli = parse_args(argv)
    except CliError as e:
        print(f"Error: {e}", file=sys.stderr)
        print(USAGE)
        return 1
    if not cli.get("hide_progress"):
        class _ConsolePercent:
            """KMC-style 'Stage 1: 37%' console progress."""

            def __init__(self):
                self._label = ""
                self._last = -1

            def set_label(self, label):
                self._label = label
                self._last = -1

            def set_progress(self, value):
                if value != self._last:
                    self._last = value
                    print(f"\r{self._label}{value}%", end="", flush=True)
                    if value >= 100:
                        print()

        s1.percent_progress_observer = _ConsolePercent()
    try:
        runner = Runner(device=cli["device"])
        s2.validate()
        r1 = runner.run_stage1(s1)
        r2 = runner.run_stage2(s2)
    except (ValueError, FileNotFoundError, NotImplementedError,
            RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if s1.estimate_histogram_cfg == EstimateHistogramCfg.ONLY_ESTIMATE:
        with open(s2.output_file_name, "w") as f:
            for i, v in enumerate(r1.estimated_histogram):
                if i >= 1:
                    f.write(f"{i}\t{v}\n")
    print(format_summary(s1, r1, r2))
    if cli["json_summary"]:
        save_json_summary(cli["json_summary"], s1, r1, r2)
    if os.environ.get("KMC_TPU_DEVELOP"):
        # develop-mode diagnostics (KMC's DEVELOP_MODE, develop.cpp):
        # signature map + per-bin stats next to the output database
        from .develop import dump_bin_stats, dump_signature_map

        out = s2.output_file_name
        if runner._sig_map is not None:
            dump_signature_map(runner._sig_map, s1.signature_len,
                               out + ".sig_map.develop")
        if not s2.without_output and s2.output_file_type == OutputFileType.KMC \
                and not r1.was_small_k_opt_used:
            dump_bin_stats(out, out + ".bin_stats.develop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
