"""kmc_tools `complex` mode: set-algebra expressions over databases (the
port's copy of kmc_tpu/tools/complex_ops.py; NumPy and ctypes only).

File grammar (reference kmc_tools/parser.cpp:39-120, tokenizer.cpp:20-26):

    INPUT:
    name1 = /path/to/db [-ci<v>] [-cx<v>]
    name2 = ...
    OUTPUT:
    /path/out = name1 + name2 * (name1 - name2)
    OUTPUT_PARAMS:
    -ci<v> -cx<v> -cs<v>

Operators (ascending precedence: +,- then ~ then *):
    +  union           (counter: sum)
    -  kmers subtract
    ~  counters subtract (counter: diff)
    *  intersection    (counter: min)
An operator may carry an explicit counter mode, e.g. `a +max b`
(output_parser.h): one of min/max/sum/diff/left/right.
"""
from __future__ import annotations

import re

import numpy as np

from . import db_ops
from .db_ops import OutputParams


class _Tok:
    def __init__(self, kind, value=None):
        self.kind = kind
        self.value = value


def _tokenize(expr: str):
    pos = 0
    toks = []
    pat = re.compile(
        r"\s*(?:(?P<lp>\()|(?P<rp>\))|(?P<op>[+\-~*])(?P<mode>min|max|sum|diff|left|right)?|(?P<name>\w+))"
    )
    while pos < len(expr):
        m = pat.match(expr, pos)
        if not m:
            raise ValueError(f"cannot parse expression at: {expr[pos:]}")
        pos = m.end()
        if m.group("lp"):
            toks.append(_Tok("("))
        elif m.group("rp"):
            toks.append(_Tok(")"))
        elif m.group("op"):
            toks.append(_Tok("op", (m.group("op"), m.group("mode"))))
        else:
            toks.append(_Tok("name", m.group("name")))
    return toks


_DEFAULT_MODE = {"+": "sum", "*": "min", "~": "diff", "-": None}
_OP_FN = {
    "+": db_ops.op_union,
    "*": db_ops.op_intersect,
    "-": db_ops.op_kmers_subtract,
    "~": db_ops.op_counters_subtract,
}
# precedence per reference expression_node construction: * binds tightest,
# then ~, then +/- left-associative
_PREC = {"+": 1, "-": 1, "~": 2, "*": 3}


class _Parser:
    def __init__(self, toks, inputs):
        self.toks = toks
        self.pos = 0
        self.inputs = inputs

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def parse(self, min_prec=1):
        left = self.parse_atom()
        while True:
            t = self.peek()
            if t is None or t.kind != "op":
                break
            op, mode = t.value
            if _PREC[op] < min_prec:
                break
            self.pos += 1
            right = self.parse(_PREC[op] + 1)
            fn = _OP_FN[op]
            if op == "-":
                left = fn(left[0], left[1], right[0], right[1])
            else:
                left = fn(left[0], left[1], right[0], right[1], mode or _DEFAULT_MODE[op])
        return left

    def parse_atom(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of expression")
        if t.kind == "(":
            self.pos += 1
            v = self.parse()
            if self.peek() is None or self.peek().kind != ")":
                raise ValueError("missing )")
            self.pos += 1
            return v
        if t.kind == "name":
            self.pos += 1
            if t.value not in self.inputs:
                raise ValueError(f"undefined input {t.value}")
            return self.inputs[t.value]
        raise ValueError(f"unexpected token in expression")


def evaluate_expression(expr: str, inputs: dict):
    """inputs: name -> (kmers, counts). Returns (kmers, counts)."""
    return _Parser(_tokenize(expr), inputs).parse()


class _AstParser:
    """Same grammar, producing a tree: ("name", n) |
    ("op", op, mode, left, right)."""

    def __init__(self, toks):
        self.toks = toks
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def parse(self, min_prec=1):
        left = self.parse_atom()
        while True:
            t = self.peek()
            if t is None or t.kind != "op":
                break
            op, mode = t.value
            if _PREC[op] < min_prec:
                break
            self.pos += 1
            right = self.parse(_PREC[op] + 1)
            left = ("op", op, mode, left, right)
        return left

    def parse_atom(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of expression")
        if t.kind == "(":
            self.pos += 1
            v = self.parse()
            if self.peek() is None or self.peek().kind != ")":
                raise ValueError("missing )")
            self.pos += 1
            return v
        if t.kind == "name":
            self.pos += 1
            return ("name", t.value)
        raise ValueError("unexpected token in expression")


def parse_expression_ast(expr: str):
    p = _AstParser(_tokenize(expr))
    ast = p.parse()
    if p.peek() is not None:
        raise ValueError("trailing tokens in expression")
    return ast


# -- streaming evaluation: the expression tree becomes a tree of windowed
#    merge streams (formats/streaming.merge_key_streams), exactly the
#    reference's CInput-over-CInput operation networks (bundle.h:18-245,
#    expression_node.h:26-196) — bounded memory at any database size --

_STREAM_OP = {"+": "union", "*": "intersect", "-": "kmers_subtract",
              "~": "counters_subtract"}


class _StreamParser:
    """Same grammar, but atoms are stream FACTORIES (each occurrence of a
    named input opens its own cursor set) and operators compose
    merge_key_streams generators lazily."""

    def __init__(self, toks, factories):
        self.toks = toks
        self.pos = 0
        self.factories = factories

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def parse(self, min_prec=1):
        from ..formats.streaming import merge_key_streams

        left = self.parse_atom()
        while True:
            t = self.peek()
            if t is None or t.kind != "op":
                break
            op, mode = t.value
            if _PREC[op] < min_prec:
                break
            self.pos += 1
            right = self.parse(_PREC[op] + 1)
            left = merge_key_streams(left, right, _STREAM_OP[op],
                                     mode or _DEFAULT_MODE[op] or "sum")
        return left

    def parse_atom(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of expression")
        if t.kind == "(":
            self.pos += 1
            v = self.parse()
            if self.peek() is None or self.peek().kind != ")":
                raise ValueError("missing )")
            self.pos += 1
            return v
        if t.kind == "name":
            self.pos += 1
            if t.value not in self.factories:
                raise ValueError(f"undefined input {t.value}")
            return self.factories[t.value]()
        raise ValueError("unexpected token in expression")


def evaluate_expression_streaming(expr: str, factories: dict):
    """factories: name -> () -> (keys 'S', counts) block stream.  Returns
    the composed sorted-unique key-block stream for the expression."""
    return _StreamParser(_tokenize(expr), factories).parse()


def _parse_complex_file(path: str):
    """(inputs: name -> (db_path, per-input OutputParams), out_path, expr,
    out_params_tokens) — no database IO."""
    lines = [ln.strip() for ln in open(path)]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    section = None
    inputs = {}
    output_line = None
    out_params_tokens = []
    for ln in lines:
        up = ln.upper()
        if up.startswith("INPUT:"):
            section = "input"
            continue
        if up.startswith("OUTPUT:"):
            section = "output"
            continue
        if up.startswith("OUTPUT_PARAMS:"):
            section = "output_params"
            continue
        if section == "input":
            m = re.match(r"^\s*([\w+-]+)\s*=\s*(.*)$", ln)
            if not m:
                raise ValueError(f"bad input line: {ln}")
            name = m.group(1)
            parts = m.group(2).split()
            ci = cx = None
            for tok in parts[1:]:
                if tok.startswith("-ci"):
                    ci = int(tok[3:])
                elif tok.startswith("-cx"):
                    cx = int(tok[3:])
            # unset per-input cutoffs default from the input's header,
            # like the reference (parameters_parser.cpp:840-847)
            inputs[name] = (parts[0],
                            db_ops.effective_input_cut(parts[0], (ci, cx)))
        elif section == "output":
            if output_line is None:
                output_line = ln
        elif section == "output_params":
            out_params_tokens.extend(ln.split())
    if output_line is None:
        raise ValueError("no OUTPUT: line")
    m = re.match(r"^\s*(.*?)\s*=\s*(.*)$", output_line)
    if not m:
        raise ValueError(f"bad output line: {output_line}")
    return inputs, m.group(1).strip(), m.group(2), out_params_tokens


def run_complex_file(path: str):
    inputs, out_path, expr, out_params_tokens = _parse_complex_file(path)
    overrides, rest = _parse_out_params(out_params_tokens)
    # unset output params default from the inputs: min effective ci, max
    # cx, max counter range (parameters_parser.cpp:893-908)
    p = db_ops.default_output_params(
        [db for db, _ in inputs.values()],
        [cut for _, cut in inputs.values()], overrides)
    # OUTPUT_PARAMS may carry -o<kmc|kff> (parser.cpp:222-227); the
    # reference's KFF writer appends ".kff" itself (kff_db_writer.h:79)
    for tok in rest:
        if tok.startswith("-o"):
            t = tok[2:]
            if t == "kff":
                if not str(out_path).endswith(".kff"):
                    out_path = str(out_path) + ".kff"
            elif t != "kmc":
                raise ValueError(f"unknown output type {tok}")

    encoding = db_ops._check_encodings([db for db, _ in inputs.values()])
    if (encoding == db_ops.DEFAULT_ENCODING
            or str(out_path).endswith(".kff")):
        # native single-pass network; non-default encodings only when the
        # output stays KFF (the Python path handles the forced rename)
        out = _run_complex_native(inputs, out_path, expr, p)
        if out is not None:
            return out
    total = sum(db_ops._stored_count(db) for db, _ in inputs.values())
    if (total > db_ops._stream_threshold()
            and encoding == db_ops.DEFAULT_ENCODING
            and not str(out_path).endswith(".kff")):
        try:
            return _run_complex_streaming(inputs, out_path, expr, p)
        except NotImplementedError:
            pass  # e.g. unsorted KFF input: materialize instead

    loaded = {}
    input_infos = []
    for name, (path_db, cut) in inputs.items():
        info, kmers, counts = db_ops.load_sorted(path_db)
        keep = ((counts.astype(np.uint64) >= cut[0])
                & (counts.astype(np.uint64) <= cut[1]))
        loaded[name] = (kmers[keep], counts[keep].astype(np.uint64))
        input_infos.append(info)
    kmers, counts = evaluate_expression(expr, loaded)
    kmers, counts = p.apply(kmers, counts)
    some_info = input_infos[0]
    db_ops.write_sorted_db(
        out_path, some_info.kmer_len, kmers, counts, p,
        some_info.both_strands,
        input_ns=[i.n_unique_stored for i in input_infos],
        encoding=encoding)
    return out_path


_COMPLEX_OP_NAME = {"+": "union", "*": "intersect", "-": "kmers_subtract",
                    "~": "counters_subtract"}


def _run_complex_native(inputs, out_path, expr, p):
    """Lower the expression tree to ONE single-pass native merger network
    (kst_expr): leaves are per-occurrence input cursors, internal nodes
    are incremental 2-stream merges, the root applies the OUTPUT_PARAMS —
    no intermediate databases (round 2 chained temp-DB passes; the single
    pass reads every input exactly once, like the reference's
    CInput-over-CInput trees).  Returns out_path, or None when ineligible
    (library unavailable, k > native scope)."""
    from . import native_tools
    from ..formats.kmc_db import DbInfo

    if native_tools.get_lib() is None or not native_tools._enabled():
        return None
    for db, _ in inputs.values():
        if not native_tools._eligible(db):
            return None
    try:
        infos = {name: db_ops.read_any_header_info(db)
                 for name, (db, _) in inputs.items()}
    except (OSError, ValueError, NotImplementedError):
        return None
    ks = {i.kmer_len for i in infos.values()}
    if len(ks) > 1:
        raise ValueError("k-mer length mismatch between databases")
    k = ks.pop()
    lut_prefix_len = db_ops.tools_lut_prefix_len(
        k, [i.n_unique_stored for i in infos.values()])
    some = next(iter(infos.values()))
    info_out = DbInfo(
        kmer_len=k,
        counter_size=db_ops.tools_counter_size(p.cutoff_max, p.counter_max),
        lut_prefix_len=lut_prefix_len,
        cutoff_min=p.cutoff_min,
        cutoff_max=p.cutoff_max,
        both_strands=some.both_strands,
        version=0,
    )

    ast = parse_expression_ast(expr)
    leaves = []   # (db_path, cut) per leaf occurrence
    prog = []     # 4 int32 per node; children precede parents
    from .native_tools import MODE_CODES, OP_CODES

    def lower(node) -> int:
        if node[0] == "name":
            if node[1] not in inputs:
                raise ValueError(f"undefined input {node[1]}")
            db, cut = inputs[node[1]]
            leaves.append((db, cut))
            prog.extend([0, len(leaves) - 1, 0, 0])
        else:
            _, op, mode, left, right = node
            a = lower(left)
            b = lower(right)
            prog.extend([
                OP_CODES[_COMPLEX_OP_NAME[op]], a, b,
                MODE_CODES.get((mode or _DEFAULT_MODE[op] or "sum").lower(),
                               2),
            ])
        return len(prog) // 4 - 1

    lower(ast)
    kff_out = db_ops._native_kff_out(
        out_path, db_ops._check_encodings([db for db, _ in inputs.values()]),
        some.both_strands, p)
    n = native_tools.run_expr(leaves, prog, str(out_path), info_out, p,
                              kff_out=kff_out)
    if n is None:
        return None
    return out_path


def _run_complex_streaming(inputs, out_path, expr, p):
    """Bounded-memory complex evaluation: per-occurrence input cursors,
    composed merge streams, streaming KMC1 writer.  Byte-identical to the
    in-memory path (the output LUT is sized from the input headers on both,
    like the reference's calc_lut_prefix_len over config.headers)."""
    from .db_ops import tools_counter_size
    from ..formats.kmc_db import DbInfo, KMC1_VER
    from ..formats.streaming import (
        DbStreamReader,
        StreamingKmc1Writer,
        _kmers_of,
    )

    # probe headers (and refuse unstreamable inputs) before any writes
    infos = {}
    for name, (db, ip) in inputs.items():
        with DbStreamReader(db) as r:
            infos[name] = r.info
    ks = {i.kmer_len for i in infos.values()}
    if len(ks) > 1:
        # same check as the in-memory path's _aligned_merge: numpy 'S{kb}'
        # keys of different widths would NUL-pad and spuriously compare
        # equal instead of erroring
        raise ValueError("k-mer length mismatch between databases")

    def factory(db, cut):
        def make():
            r = DbStreamReader(db, cutoff_min=cut[0],
                               cutoff_max=cut[1])
            try:
                yield from r.key_blocks()
            finally:
                r.close()

        return make

    factories = {name: factory(db, cut)
                 for name, (db, cut) in inputs.items()}
    stream = evaluate_expression_streaming(expr, factories)

    some = next(iter(infos.values()))
    k = some.kmer_len
    kb = some.kmer_bytes
    info = DbInfo(
        kmer_len=k,
        counter_size=tools_counter_size(p.cutoff_max, p.counter_max),
        lut_prefix_len=db_ops.tools_lut_prefix_len(
            k, [i.n_unique_stored for i in infos.values()]),
        cutoff_min=p.cutoff_min,
        cutoff_max=p.cutoff_max,
        both_strands=some.both_strands,
        version=KMC1_VER,
    )
    w = StreamingKmc1Writer(out_path, info)
    for keys, counts in stream:
        keep = (counts >= p.cutoff_min) & (counts <= p.cutoff_max)
        w.put_block(_kmers_of(keys[keep], kb),
                    np.minimum(counts[keep], p.counter_max))
    w.close()
    return out_path


def _parse_out_params(tokens):
    """(overrides dict with only the explicitly-set ci/cx/cs, rest tokens).
    Unset fields default from the INPUTS (min effective ci / max cx / max
    counter range), exactly like the reference's complex-mode defaulting
    (parameters_parser.cpp:893-908)."""
    overrides = {}
    rest = []
    for tok in tokens:
        if tok.startswith("-ci"):
            overrides["ci"] = int(tok[3:])
        elif tok.startswith("-cx"):
            overrides["cx"] = int(tok[3:])
        elif tok.startswith("-cs"):
            overrides["cs"] = int(tok[3:])
        else:
            rest.append(tok)
    return overrides, rest
