"""kmc_tools CLI equivalent (KMC's kmc_tools/kmc_tools.cpp,
parameters_parser.cpp:608-632); the port's copy of kmc_tpu/tools_cli.py.

Modes: transform, simple, complex, compare, info, check, filter.  Host code
only (NumPy, ctypes and the native streaming core): it loads no torch, so it
runs where the counting engine's libraries cannot be mapped.

    python -m kmc_tpu_torch.tools_cli [-t<n>] [-v] [-hp] <operation> ...
"""
from __future__ import annotations

import sys


from .tools import db_ops
from .tools.db_ops import OutputParams

USAGE = """kmc_tools (kmc_tpu_torch) — database algebra on KMC databases
Usage: kmc_tools [global_params] <operation> [operation parameters]
Global params (parameters_parser.cpp:58-92):
  -t<value> - total number of threads
  -v        - verbose mode
  -hp       - hide percentage progress
Operations:
  transform <db> [-ci<v>] [-cx<v>] <oper [oper_params] output [out_params]> [...]
      opers: sort, reduce, compact, histogram, dump [-s], set_counts <value>
      out_params: -ci<v> -cx<v> -cs<v>; -o<kmc|kff> for sort/reduce/
      compact/set_counts (kff appends .kff to the output path)
  simple <db1 [-ci<v>] [-cx<v>]> <db2 [-ci<v>] [-cx<v>]>
         <oper output [-ci<v>] [-cx<v>] [-cs<v>] [-o<kmc|kff>] [-oc<mode>]> [...]
      opers: intersect, union, kmers_subtract, counters_subtract,
             reverse_kmers_subtract, reverse_counters_subtract
      -oc<min|max|sum|diff|left|right> - counter calculation mode
  complex <operations_definition_file>
  compare <db1> <db2>
  info <db>
  check <db> <kmer>
  filter [-t|-hm] <kmc_db [-ci<v>] [-cx<v>]> <input_fastq [-ci<v>] [-cx<v>]
         [-f<a|q>]> <output_fastq [-f<a|q>]>
"""

# Parsed -t/-v/-hp global params of the last main() call (the reference
# keeps them in CConfig; thread count cannot change results, verbose adds
# no extra output here).
GLOBAL_PARAMS = {"threads": None, "verbose": False, "hide_progress": False}


def _parse_input_cut(args, i):
    """Consume per-input -ci/-cx tokens at position i (the reference's
    input_params, parameters_parser.cpp:842-848 default the unset ones
    from the input header).  Returns ((ci|None, cx|None), next_i)."""
    ci = cx = None
    while i < len(args) and (args[i].startswith("-ci")
                             or args[i].startswith("-cx")):
        if args[i].startswith("-ci"):
            ci = int(args[i][3:])
        else:
            cx = int(args[i][3:])
        i += 1
    return (ci, cx), i


def _parse_out_overrides(args):
    """Explicit per-output -ci/-cx/-cs values as an overrides dict; unset
    keys take the reference's input-derived defaults
    (db_ops.default_output_params)."""
    ov = {}
    for a in args:
        if a.startswith("-ci"):
            ov["ci"] = int(a[3:])
        elif a.startswith("-cx"):
            ov["cx"] = int(a[3:])
        elif a.startswith("-cs"):
            ov["cs"] = int(a[3:])
    return ov


def _pop_output_type(opts, out):
    """Apply a -o<kmc|kff> output-type token to the output path (the
    reference appends ".kff" itself for KFF outputs, kff_db_writer.h:79;
    parameters_parser.cpp:402-429, 562-574).  Returns (remaining_opts,
    out_path) or raises ValueError on an unknown type."""
    rest = []
    for a in opts:
        if a.startswith("-o") and not a.startswith("-oc"):
            t = a[2:]
            if t == "kff":
                out = str(out) + ".kff"
            elif t != "kmc":
                raise ValueError(f"unknown output type {a}")
        else:
            rest.append(a)
    return rest, out


def _parse_output_params(args, defaults=None):
    p = defaults or OutputParams()
    rest = []
    for a in args:
        if a.startswith("-ci"):
            p.cutoff_min = int(a[3:])
        elif a.startswith("-cx"):
            p.cutoff_max = int(a[3:])
        elif a.startswith("-cs"):
            p.counter_max = int(a[3:])
        else:
            rest.append(a)
    return p, rest


def cmd_transform(args) -> int:
    if len(args) < 2:
        print(USAGE)
        return 1
    db = args[0]
    # sort of an already-sorted (KMC1) database is omitted with a warning
    # and produces NO output (kmc_tools.cpp:421-432)
    input_is_kmc1 = False
    if not str(db).endswith(".kff"):
        from .formats.kmc_db import KMC2_VER, read_pre_meta

        try:
            input_is_kmc1 = read_pre_meta(db)[0].version != KMC2_VER
        except (OSError, ValueError):
            pass  # open errors surface from the op itself
    in_cut, i = _parse_input_cut(args, 1)
    # parse ALL output ops first, then run them off one load of the input
    # (the reference streams every output op from a single DB pass,
    # kmc_tools.cpp:449-470)
    ops = []
    while i < len(args):
        op = args[i]
        i += 1
        if op in ("sort", "reduce", "compact", "set_counts"):
            if op == "set_counts":
                value = int(args[i])
                i += 1
            out = args[i]
            i += 1
            opts = []
            while i < len(args) and args[i].startswith("-"):
                opts.append(args[i])
                i += 1
            try:
                opts, out = _pop_output_type(opts, out)
            except ValueError as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            ov = _parse_out_overrides(opts)
            if op == "sort" and input_is_kmc1:
                print("Warning: input database is already sorted. Each "
                      "sort operation will be omitted", file=sys.stderr)
            elif op in ("sort", "reduce"):
                ops.append((op, out, ov))
            elif op == "compact":
                # -cs is ignored for compact (parameters_parser.cpp:437-441)
                if ov.get("cs"):
                    print("Warning: -cs can not be specified for compact "
                          "operation, value specified will be ignored",
                          file=sys.stderr)
                    ov.pop("cs", None)
                ops.append(("compact", out, ov))
            else:
                # -cs/-cx/-ci are ignored for set_counts
                # (parameters_parser.cpp:443-450)
                if any(ov.get(f) for f in ("cs", "cx", "ci")):
                    print("Warning: -cs, -cx, -ci cannot be specified for "
                          "set_counts operation, values will be ignored",
                          file=sys.stderr)
                ops.append(("set_counts", out, value))
        elif op == "histogram":
            out = args[i]
            i += 1
            lo, hi = None, None  # unset -> reference input-derived defaults
            while i < len(args) and args[i].startswith("-"):
                if args[i].startswith("-ci"):
                    lo = int(args[i][3:])
                elif args[i].startswith("-cx"):
                    hi = int(args[i][3:])
                elif args[i].startswith("-o"):
                    # -o allowed only for compact/reduce/set_counts/sort
                    # (parameters_parser.cpp:424-428)
                    print("Error: -o parameter allowed only for compact, "
                          "reduce, set_counts and sort operations",
                          file=sys.stderr)
                    return 1
                i += 1
            ops.append(("histogram", out, lo, hi))
        elif op == "dump":
            sorted_out = False
            if i < len(args) and args[i] == "-s":
                sorted_out = True
                i += 1
            ops.append(("dump", args[i], sorted_out))
            i += 1
        else:
            print(f"Error: unknown transform operation {op}", file=sys.stderr)
            return 1
    if ops:
        db_ops.run_transform_ops(db, ops, in_cut=in_cut)
    return 0


def cmd_simple(args) -> int:
    if len(args) < 4:
        print(USAGE)
        return 1
    db1 = args[0]
    in1_cut, i = _parse_input_cut(args, 1)
    db2 = args[i]
    in2_cut, i = _parse_input_cut(args, i + 1)
    ops = []
    while i < len(args):
        op = args[i]
        i += 1
        if op not in db_ops.SIMPLE_OPS:
            print(f"Error: unknown simple operation {op}", file=sys.stderr)
            return 1
        mode = None
        if i < len(args) and args[i].startswith("-oc"):
            mode = args[i][3:]
            i += 1
        out = args[i]
        i += 1
        opts = []
        while i < len(args) and args[i].startswith("-"):
            # reference syntax places -oc<mode> among the output params
            # (read_output_desc_for_simple); the pre-output position above
            # is kept for backward compatibility
            if args[i].startswith("-oc"):
                mode = args[i][3:]
            else:
                opts.append(args[i])
            i += 1
        try:
            opts, out = _pop_output_type(opts, out)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        ops.append((op, mode, out, _parse_out_overrides(opts)))
    # every output computed from ONE load + merge of the inputs
    db_ops.run_simple_ops(db1, db2, ops, in1_cut=in1_cut, in2_cut=in2_cut)
    return 0


def cmd_compare(args) -> int:
    if len(args) != 2:
        print(USAGE)
        return 1
    equal = db_ops.db_compare(args[0], args[1])
    # reference prints nothing; exit code 0 = equal, 1 = different
    return 0 if equal else 1


def cmd_info(args) -> int:
    if len(args) != 1:
        print(USAGE)
        return 1
    for stream, text in db_ops.db_info_segments(args[0]):
        (sys.stdout if stream == "out" else sys.stderr).write(text)
    return 0


def cmd_check(args) -> int:
    if len(args) != 2:
        print(USAGE)
        return 1
    from .api import KMCFile

    f = KMCFile()
    if not f.OpenForRA(args[0]):
        print("Error: cannot open database", file=sys.stderr)
        return 1
    found, count = f.CheckKmer(args[1])
    # the reference prints the counter (0 when absent) and exits 0 either
    # way (check_kmer.h:241-242; Process() results are ignored by main)
    print(count if found else 0)
    return 0


def cmd_filter(args) -> int:
    """Positional grammar (CFilterUsageDisplayer, parameters_parser.cpp:
    652-655): filter [filter_params] <db [-ci -cx]> <input [-ci -cx -f?]>
    <output [-f?]>.  DB-side -ci/-cx restrict which database k-mers count
    as present (SetMinCount/SetMaxCount, kmc_tools.cpp:307-308)."""
    from .tools.fastq_filter import filter_fastq

    mode = "normal"  # -t / -hm overwrite each other; last wins
    i = 0
    while i < len(args) and args[i].startswith("-"):
        if args[i] == "-t":
            mode = "trim"
        elif args[i] == "-hm":
            mode = "hard_mask"
        else:
            print(f"Warning: Unknown parameter for filter operation: "
                  f"{args[i]}", file=sys.stderr)
        i += 1
    trim = mode == "trim"
    hard_mask = mode == "hard_mask"
    if len(args) - i < 3:
        print(USAGE)
        return 1
    db = args[i]
    i += 1
    db_ci = db_cx = None
    while i < len(args) and args[i].startswith("-"):
        if args[i].startswith("-ci"):
            db_ci = int(args[i][3:])
        elif args[i].startswith("-cx"):
            db_cx = int(args[i][3:])
        i += 1
    if i >= len(args):
        print(USAGE)
        return 1
    inp = args[i]
    i += 1
    if inp.startswith("@"):
        # @list expands to several inputs (parameters_parser.cpp:106-124)
        try:
            with open(inp[1:]) as f:
                inp = [ln.strip() for ln in f if ln.strip()]
        except OSError:
            print(f"Error: No {inp[1:]} file", file=sys.stderr)
            return 1
    # reference read-side defaults: -ci2 -cx1e9 (absolute counts); a value
    # written WITH a decimal point is a fraction of the read's k-mer count
    # (fastq_filter help: "integer or floating number in range [0.0;1.0]")
    fci: int | float = 2
    fcx: int | float = 10**9

    def _num(s):
        # a decimal point marks a fraction (reference syntax rule); plain
        # and scientific-notation integers (2, 1e9) are absolute counts
        return float(s) if "." in s else int(float(s))

    in_fmt = None
    while i < len(args) and args[i].startswith("-"):
        a = args[i]
        if a.startswith("-ci"):
            fci = _num(a[3:])
        elif a.startswith("-cx"):
            fcx = _num(a[3:])
        elif a in ("-fa", "-fq"):
            in_fmt = a[2:]
        i += 1
    if i >= len(args):
        print(USAGE)
        return 1
    out = args[i]
    i += 1
    out_fmt = None
    while i < len(args) and args[i].startswith("-"):
        if args[i] in ("-fa", "-fq"):
            out_fmt = args[i][2:]
        i += 1
    if in_fmt == "a" and out_fmt == "q":
        # parameters_parser.cpp:193-197
        print("Error: cannot set -fq for output when -fa is set for input",
              file=sys.stderr)
        return 1
    if mode != "normal" and (isinstance(fci, float)
                             or isinstance(fcx, float)):
        # parameters_parser.cpp:656-660
        print("Error: trim (-t) and soft mask (-hm) are not compatibile "
              "with float values of cut off (-ci -cx)", file=sys.stderr)
        return 1
    filter_fastq(db, inp, out, min_kmers=fci, max_kmers=fcx, trim=trim,
                 hard_mask=hard_mask, db_cutoff_min=db_ci,
                 db_cutoff_max=db_cx, in_format=in_fmt, out_format=out_fmt)
    return 0


def cmd_complex(args) -> int:
    if len(args) != 1:
        print(USAGE)
        return 1
    from .tools.complex_ops import run_complex_file

    run_complex_file(args[0])
    return 0


COMMANDS = {
    "transform": cmd_transform,
    "simple": cmd_simple,
    "compare": cmd_compare,
    "info": cmd_info,
    "check": cmd_check,
    "filter": cmd_filter,
    "complex": cmd_complex,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # like the reference, --help/--version anywhere shows usage and exits 0
    # (kmc_tools.cpp:628-652)
    if not argv or "--help" in argv or "--version" in argv or argv[0] == "-h":
        print(USAGE)
        return 0
    # global params before the operation name (parse_global_params,
    # parameters_parser.cpp:58-92)
    GLOBAL_PARAMS.update(threads=None, verbose=False, hide_progress=False)
    i = 0
    while i < len(argv) and argv[i].startswith("-"):
        a = argv[i]
        if a.startswith("-t"):
            if len(a) < 3:
                print("Error: -t require value", file=sys.stderr)
                return 1
            GLOBAL_PARAMS["threads"] = int(a[2:])
        elif a.startswith("-v"):
            GLOBAL_PARAMS["verbose"] = True
        elif a.startswith("-hp"):
            GLOBAL_PARAMS["hide_progress"] = True
        else:
            print(f"Error: unknown global option {a}", file=sys.stderr)
            return 1
        i += 1
    # native chunk-parallel drivers honor -t (default: all cores, like the
    # reference's parameters_parser.cpp defaults)
    from .tools import native_tools

    native_tools.set_threads(GLOBAL_PARAMS["threads"])
    if i >= len(argv):
        print(USAGE)
        return 1
    cmd = argv[i]
    if cmd not in COMMANDS:
        print(f"Error: unknown operation {cmd}", file=sys.stderr)
        print(USAGE)
        return 1
    return COMMANDS[cmd](argv[i + 1:])


if __name__ == "__main__":
    sys.exit(main())
