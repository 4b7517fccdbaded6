"""bcftools-style site filter expressions (-i/--include, -e/--exclude).

The reference delegates to htslib's filter engine
(consensus.cpp:288,397-401); this is a clean-room evaluator for the
practically-used core of that language over per-site fields:

  fields     TYPE, QUAL, FILTER, POS, ID, REF, ALT, N_ALT, N_SAMPLES
  INFO       INFO/TAG or bare TAG (numeric, string, flag, or
             comma-separated vectors with any-element semantics);
             a bare flag is a boolean atom (``-i 'DB'``)
  FORMAT     GT / FMT/GT compared against bcftools genotype classes
             ("mis" "het" "hom" "ref" "alt" "hap") or a literal genotype
             ("0/1"; | and / compare equal) — true if ANY sample matches,
             bcftools' site-level semantics
  TYPE       "snp" | "indel" | "mnp" | "ref" | "other" (any ALT matches)
  arithmetic +, -, *, / over numbers and numeric fields; INFO vectors
             combine elementwise (scalar broadcasts), matching the
             engine's per-element evaluation
  functions  MAX MIN SUM AVG MEAN MEDIAN STDEV COUNT ABS STRLEN ILEN
  operators  == (=), !=, <, <=, >, >=, && (&), || (|), !, parentheses,
             ~ and !~ (regex match on strings/string vectors)
  literals   "strings", 'strings', numbers, @file (whitespace-separated
             value set loaded at compile time; ID=@ids.txt membership)

POS is 1-based as in bcftools.  QUAL comparisons against a missing QUAL
('.') are false, matching htslib's missing-value semantics.  FILTER
equality treats "PASS" and "." per bcftools: FILTER="PASS" matches PASS
only; FILTER="." matches missing.  Missing INFO tags never satisfy a
comparison (and their flags are false).  ILEN is the per-ALT length
change (len(ALT) - len(REF)) vector.

Usage: ``f = compile_filter('TYPE="snp" && QUAL>30'); f(rec) -> bool``.
"""

import math
import re
from typing import Callable, List

from ..utils.errors import die

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<num>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
      | (?P<str>"[^"]*"|'[^']*')
      | (?P<file>@[^\s()&|!=<>~,]+)
      | (?P<op><=|>=|==|!=|!~|&&|\|\||[<>=!()&|+\-*/~])
      | (?P<ident>[A-Za-z_][A-Za-z_0-9/]*)
    )""",
    re.VERBOSE,
)

# idents that legitimately contain '/'; anything else splits at '/' so
# that DP/2 parses as division, not a tag named "DP/2"
_SLASH_PREFIXES = ("INFO/", "FMT/", "FORMAT/", "info/", "fmt/", "format/")


def _tokenize(expr: str) -> List[str]:
    out = []
    i = 0
    while i < len(expr):
        m = _TOKEN.match(expr, i)
        if not m:
            if expr[i:].strip() == "":
                break
            die(f"filter expression: cannot parse at '{expr[i:]}'")
        tok = m.group(0).strip()
        if m.lastgroup == "ident" and "/" in tok and not tok.startswith(
            _SLASH_PREFIXES
        ):
            head = tok.split("/", 1)[0]
            out.append(head)
            i = m.start() + m.group(0).index(head) + len(head)
            continue
        out.append(tok)
        i = m.end()
    return out


def _rec_type(rec) -> set:
    """bcftools TYPE classes present in the record (any-ALT semantics)."""
    types = set()
    ref = rec.alleles[0]
    alts = rec.alleles[1:]
    if not alts:
        types.add("ref")
    for alt in alts:
        if alt in (".", ""):
            types.add("ref")
        elif len(ref) == 1 and len(alt) == 1:
            types.add("snp")
        elif len(ref) != len(alt):
            types.add("indel")
        elif len(ref) == len(alt) and len(ref) > 1:
            types.add("mnp")
        else:
            types.add("other")
    return types


class _GTVals(list):
    """Per-sample genotype strings — distinguishes GT from INFO vectors."""


def _info_lookup(tag: str, rec):
    """Value of INFO tag: None (absent), True (flag), or list of string
    elements (comma-split)."""
    info = getattr(rec, "info", ".") or "."
    if info in (".", ""):
        return None
    for part in info.split(";"):
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            if k == tag:
                return v.split(",")
        elif part == tag:
            return True
    return None


def _format_lookup(tag: str, rec):
    """Per-sample values of a FORMAT tag, flattened (any-sample,
    any-element semantics): None if the tag is absent from FORMAT; dies
    if the store was built without store_format (raw FORMAT columns are
    opt-in — panel-scale memory)."""
    fmt = getattr(rec, "fmt", ".") or "."
    if fmt == "-":  # store retained FORMAT but this record has none
        return None
    if fmt in (".", ""):
        die(f"filter expression: FORMAT tag {tag} requires raw FORMAT "
            "retention (enabled automatically when a -i/-e expression "
            "references FMT/)")
    cols = fmt.split("\t")
    keys = cols[0].split(":")
    if tag not in keys:
        return None
    ki = keys.index(tag)
    vals = []
    for samp in cols[1:]:
        parts = samp.split(":")
        v = parts[ki] if ki < len(parts) else "."
        vals.extend(v.split(","))
    return vals or None


def _gt_values(rec) -> "_GTVals":
    out = _GTVals()
    gts = rec.gts
    for s in range(len(gts)):
        a, b = int(gts[s][0]), int(gts[s][1])
        out.append(
            ("." if a < 0 else str(a)) + "/" + ("." if b < 0 else str(b))
        )
    return out


def _field_value(name: str, rec):
    upper = name.upper()
    if upper == "TYPE":
        return _rec_type(rec)
    if upper == "QUAL":
        return rec.qual
    if upper == "FILTER":
        return rec.filter
    if upper == "POS":
        return rec.pos + 1  # bcftools POS is 1-based
    if upper == "ID":
        return rec.vid
    if upper == "REF":
        return rec.alleles[0]
    if upper == "ALT":
        return rec.alleles[1] if len(rec.alleles) > 1 else "."
    if upper == "N_ALT":
        return len(rec.alleles) - 1
    if upper == "N_SAMPLES":
        return len(rec.gts)
    if upper == "ILEN":
        ref = rec.alleles[0]
        return [str(len(a) - len(ref)) for a in rec.alleles[1:]] or None
    if upper in ("GT", "FMT/GT", "FORMAT/GT"):
        return _gt_values(rec)
    if name.startswith(("INFO/", "info/")):
        return _info_lookup(name.split("/", 1)[1], rec)
    if name.startswith(("FMT/", "FORMAT/", "fmt/", "format/")):
        return _format_lookup(name.split("/", 1)[1], rec)
    # bare identifier falls through to INFO (bcftools behavior)
    return _info_lookup(name, rec)


def _field_truth(name: str, rec) -> bool:
    """Bare-field boolean: flag present, or value present and nonzero."""
    val = _field_value(name, rec)
    if val is None:
        return False
    if val is True:
        return True
    if isinstance(val, _GTVals):
        return any(g != "./." for g in val)
    if isinstance(val, list):
        return any(v not in (".", "", "0") for v in val)
    return bool(val)


_GT_CLASSES = ("mis", "het", "hom", "ref", "alt", "hap")


def _gt_matches(g: str, want: str) -> bool:
    """One sample genotype vs a bcftools GT class or literal genotype."""
    want = want.replace("|", "/")
    a, b = g.split("/")
    low = want.lower()
    if low == "mis":
        return a == "." and b == "."
    if a == "." and b == ".":
        return low == "mis"
    if low == "het":
        return a != b and a != "." and b != "."
    if low == "hom":
        return a == b and a != "."
    if low == "ref":
        return a == "0" and b == "0"
    if low == "alt":
        return (a not in (".", "0")) or (b not in (".", "0"))
    if low == "hap":
        return a == b  # haploid records store duplicated haplotypes
    return g == want or g == "/".join(reversed(want.split("/")))


# --------------------------------------------------------------------------
# node model: ("num", x) ("str", s) ("field", name) ("bool", fn)
# ("arith", fn) — fn(rec) -> runtime value
# --------------------------------------------------------------------------


def _eval(node, rec):
    kind = node[0]
    if kind == "num":
        return node[1]
    if kind == "str":
        return node[1]
    if kind == "strset":
        return node[1]
    if kind == "field":
        return _field_value(node[1], rec)
    return node[1](rec)  # arith / bool


class _StrSet(frozenset):
    """Values loaded from an @file atom (whitespace/newline-separated)."""


def _load_file_set(path: str) -> "_StrSet":
    try:
        with open(path) as f:
            return _StrSet(f.read().split())
    except OSError as e:
        die(f"filter expression: cannot read @{path}: {e}")


def _as_vec(val, ctx: str):
    """Numeric view of a runtime value: None, or list of floats."""
    if val is None:
        return None
    if val is True:
        return [1.0]
    if isinstance(val, (int, float)):
        return None if isinstance(val, float) and math.isnan(val) else [
            float(val)
        ]
    if isinstance(val, _GTVals) or isinstance(val, set):
        die(f"filter expression: {ctx} needs a numeric operand")
    if isinstance(val, list):
        out = []
        for v in val:
            if v in (".", ""):
                continue
            try:
                out.append(float(v))
            except ValueError:
                die(f"filter expression: {ctx} on non-numeric value '{v}'")
        return out or None
    die(f"filter expression: {ctx} needs a numeric operand")


def _arith_node(lhs, op: str, rhs):
    ops = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: float("nan") if b == 0 else a / b,
    }[op]

    def fn(rec):
        a = _as_vec(_eval(lhs, rec), f"'{op}'")
        b = _as_vec(_eval(rhs, rec), f"'{op}'")
        if a is None or b is None:
            return None
        if len(a) == 1:
            a = a * len(b)
        if len(b) == 1:
            b = b * len(a)
        if len(a) != len(b):
            die("filter expression: vector length mismatch in arithmetic")
        out = [ops(x, y) for x, y in zip(a, b)]
        return out[0] if len(out) == 1 else out

    return ("arith", fn)


_FUNCS = {
    "MAX": max,
    "MIN": min,
    "SUM": sum,
    "AVG": lambda v: sum(v) / len(v),
    "MEAN": lambda v: sum(v) / len(v),
    "MEDIAN": lambda v: sorted(v)[len(v) // 2]
    if len(v) % 2
    else (sorted(v)[len(v) // 2 - 1] + sorted(v)[len(v) // 2]) / 2,
    "STDEV": lambda v: math.sqrt(
        sum((x - sum(v) / len(v)) ** 2 for x in v) / len(v)
    ),
    "COUNT": len,
}


def _func_node(name: str, arg):
    upper = name.upper()
    if upper == "ABS":

        def fn(rec):
            v = _as_vec(_eval(arg, rec), "ABS")
            if v is None:
                return None
            out = [abs(x) for x in v]
            return out[0] if len(out) == 1 else out

        return ("arith", fn)
    if upper == "STRLEN":

        def fn(rec):
            v = _eval(arg, rec)
            if v is None:
                return None
            if isinstance(v, str):
                return float(len(v))
            if isinstance(v, list):
                out = [float(len(x)) for x in v]
                return out[0] if len(out) == 1 else out
            die("filter expression: STRLEN needs a string operand")

        return ("arith", fn)
    red = _FUNCS[upper]

    def fn(rec):
        v = _as_vec(_eval(arg, rec), upper)
        if v is None:
            return None
        return float(red(v))

    return ("arith", fn)


class _Parser:
    """Recursive descent:
    or -> and -> not -> cmp -> sum -> prod -> unary -> atom."""

    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self):
        t = self.peek()
        self.i += 1
        return t

    def parse(self) -> Callable:
        node = self.or_expr()
        if self.peek() is not None:
            die(f"filter expression: trailing tokens at '{self.peek()}'")
        return _truth_fn(node)

    def or_expr(self):
        left = self.and_expr()
        while self.peek() in ("||", "|"):
            self.take()
            right = self.and_expr()
            lf, rf = _truth_fn(left), _truth_fn(right)
            left = ("bool", lambda rec, lf=lf, rf=rf: lf(rec) or rf(rec))
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.peek() in ("&&", "&"):
            self.take()
            right = self.not_expr()
            lf, rf = _truth_fn(left), _truth_fn(right)
            left = ("bool", lambda rec, lf=lf, rf=rf: lf(rec) and rf(rec))
        return left

    def not_expr(self):
        if self.peek() == "!":
            self.take()
            f = _truth_fn(self.not_expr())
            return ("bool", lambda rec, f=f: not f(rec))
        return self.cmp_expr()

    def cmp_expr(self):
        lhs = self.sum_expr()
        op = self.peek()
        if op in ("==", "=", "!=", "<", "<=", ">", ">=", "~", "!~"):
            self.take()
            rhs = self.sum_expr()
            return ("bool", _make_cmp(lhs, op, rhs))
        return lhs

    def _is_neg_num(self):
        t = self.peek()
        return (
            t is not None and t.startswith("-") and len(t) > 1
            and t[1].isdigit()
        )

    def sum_expr(self):
        left = self.prod_expr()
        while self.peek() in ("+", "-") or self._is_neg_num():
            if self._is_neg_num():  # "DP-5" tokenizes as [DP, -5]
                right = ("num", float(self.take()))
                left = _arith_node(left, "+", right)
                continue
            op = self.take()
            left = _arith_node(left, op, self.prod_expr())
        return left

    def prod_expr(self):
        left = self.unary_expr()
        while self.peek() in ("*", "/"):
            op = self.take()
            left = _arith_node(left, op, self.unary_expr())
        return left

    def unary_expr(self):
        if self.peek() == "-":
            self.take()
            return _arith_node(("num", 0.0), "-", self.unary_expr())
        if self.peek() == "+":
            self.take()
            return self.unary_expr()
        return self.atom()

    def atom(self):
        t = self.take()
        if t is None:
            die("filter expression: unexpected end")
        if t == "(":
            node = self.or_expr()
            if self.take() != ")":
                die("filter expression: missing ')'")
            return node
        if t[0] in "\"'":
            return ("str", t[1:-1])
        if t[0] == "@":  # value-set file: ID=@ids.txt (filter.c @file)
            return ("strset", _load_file_set(t[1:]))
        try:
            return ("num", float(t))
        except ValueError:
            pass
        if (
            t.upper() in _FUNCS or t.upper() in ("ABS", "STRLEN")
        ) and self.peek() == "(":
            self.take()
            arg = self.sum_expr()
            if self.take() != ")":
                die("filter expression: missing ')' after function")
            return _func_node(t, arg)
        return ("field", t)  # case kept: INFO tags are case-sensitive


def _truth_fn(node):
    """Coerce a node to a rec -> bool function (boolean context)."""
    if node[0] == "bool":
        return node[1]
    if node[0] == "field":
        name = node[1]
        return lambda rec, name=name: _field_truth(name, rec)
    if node[0] == "arith":
        fn = node[1]

        def truth(rec, fn=fn):
            v = fn(rec)
            if v is None:
                return False
            if isinstance(v, list):
                return any(x != 0 for x in v)
            return bool(v)

        return truth
    if node[0] == "num":
        return lambda rec, v=bool(node[1]): v
    die("filter expression: expected comparison after string literal")


_NUM_TESTS = {
    "==": lambda x, r: x == r, "=": lambda x, r: x == r,
    "!=": lambda x, r: x != r, "<": lambda x, r: x < r,
    "<=": lambda x, r: x <= r, ">": lambda x, r: x > r,
    ">=": lambda x, r: x >= r,
}


def _make_cmp(lhs, op, rhs):
    # keep "special" runtime types (TYPE sets, GT lists) on the left
    def cmp(rec):
        lv = _eval(lhs, rec)
        rv = _eval(rhs, rec)
        if isinstance(lv, _StrSet) and not isinstance(rv, _StrSet):
            return _cmp_values(rv, op, lv)  # @file reads naturally on rhs
        if op in ("~", "!~"):
            return _cmp_regex(lv, op, rv)
        if isinstance(rv, (set, _GTVals)) and not isinstance(
            lv, (set, _GTVals)
        ):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            return _cmp_values(rv, flip.get(op, op), lv)
        return _cmp_values(lv, op, rv)

    return cmp


def _cmp_regex(lv, op, rv):
    """Regex match (~ / !~): any-element semantics over string vectors,
    matching htslib's filters (consensus.cpp:288 delegation)."""
    if not isinstance(rv, str):
        die("filter expression: ~ needs a string regex on the right")
    try:
        pat = re.compile(rv)
    except re.error as e:
        die(f"filter expression: bad regex '{rv}': {e}")
    if lv is None:
        return op == "!~"
    if isinstance(lv, (_GTVals, list)):
        strs = [str(v) for v in lv]
    elif isinstance(lv, set):
        strs = sorted(lv)
    elif lv is True:
        strs = []
    else:
        strs = [str(lv)]
    hit = any(pat.search(s) for s in strs)
    return hit if op == "~" else not hit


def _cmp_values(lv, op, rv):
    if isinstance(rv, _StrSet):  # @file membership (ID=@file semantics)
        if lv is None or lv is True:
            return op == "!="
        vals = (
            [str(v) for v in lv]
            if isinstance(lv, (list, _GTVals))
            else [str(lv)]
        )
        if op in ("==", "="):
            return any(v in rv for v in vals)
        if op == "!=":
            return all(v not in rv for v in vals)
        die(f"filter expression: @file does not support {op}")
    if lv is None:  # absent INFO tag: no comparison matches
        return op == "!=" if isinstance(rv, str) else False
    if rv is None:
        return op == "!=" if isinstance(lv, str) else False
    if lv is True:  # INFO flag compared numerically (FLAG=1 / =0)
        if isinstance(rv, (int, float)) and rv is not True:
            return {"==": rv == 1, "=": rv == 1, "!=": rv != 1}.get(
                op, False
            )
        return False
    if isinstance(lv, _GTVals):  # any-sample semantics
        if not isinstance(rv, str):
            die("filter expression: GT compares against a string")
        hits = (_gt_matches(g, rv) for g in lv)
        if op in ("==", "="):
            return any(hits)
        if op == "!=":
            return any(not h for h in hits)
        die(f"filter expression: GT does not support {op}")
    if isinstance(lv, set):  # TYPE
        if not isinstance(rv, str):
            die("filter expression: TYPE compares against a string")
        hit = rv.lower() in lv
        if op in ("==", "="):
            return hit
        if op == "!=":
            return not hit
        die(f"filter expression: TYPE does not support {op}")
    # vectors (INFO lists or arithmetic results): any-element semantics
    if isinstance(lv, list) and lv and isinstance(lv[0], float):
        lv_nums = lv
    elif isinstance(lv, list):
        if isinstance(rv, str):  # INFO string vector membership
            if op in ("==", "="):
                return rv in lv
            if op == "!=":
                return any(v != rv for v in lv)
            die(f"filter expression: INFO strings do not support {op}")
        lv_nums = []
        for v in lv:
            try:
                lv_nums.append(float(v))
            except (ValueError, TypeError):
                pass
        if not lv_nums:
            return False
    else:
        lv_nums = None
    if lv_nums is not None:
        rvec = _as_vec(rv, "comparison")
        if rvec is None:
            return False
        test = _NUM_TESTS[op]
        return any(test(x, r) for x in lv_nums for r in rvec)
    if isinstance(lv, float):
        if math.isnan(lv):
            return False  # missing QUAL never matches
        if isinstance(rv, str):
            die("filter expression: numeric comparison needs a number")
        rvec = _as_vec(rv, "comparison")
        if rvec is None:
            return False
        test = _NUM_TESTS[op]
        return any(test(lv, r) for r in rvec)
    if isinstance(lv, int):
        if isinstance(rv, str):
            die("filter expression: numeric comparison needs a number")
        rvec = _as_vec(rv, "comparison")
        if rvec is None:
            return False
        test = _NUM_TESTS[op]
        return any(test(lv, r) for r in rvec)
    # string field
    if not isinstance(rv, str):
        # string vs numeric vector from arithmetic/INFO: compare numerically
        # when the string parses, else die as before
        die("filter expression: string comparison needs a string")
    if op in ("==", "="):
        return lv == rv
    if op == "!=":
        return lv != rv
    die(f"filter expression: strings do not support {op}")


def compile_filter(expr: str) -> Callable:
    """Compile a -i/-e expression into rec -> bool."""
    return _Parser(_tokenize(expr)).parse()
