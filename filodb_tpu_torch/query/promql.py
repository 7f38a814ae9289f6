"""PromQL parser -> LogicalPlan (reference L6: prometheus/parse/Parser.scala
:183-190 entry points; grammar semantics of PromQL.g4 + ast/Vectors.scala,
Functions.scala, Expressions.scala — re-implemented as a hand-written lexer +
precedence-climbing parser, the same approach as the reference's
LegacyParser).

Coverage: vector selectors with matchers, matrix ranges ``[5m]``, subqueries
``[1h:5m]``, ``offset`` (incl. negative), ``@`` (timestamp / start() / end()),
all binary operators with PromQL precedence + ``bool`` + vector matching
(``on``/``ignoring``/``group_left``/``group_right``), aggregations with
``by``/``without`` (prefix or suffix), range/instant/misc/time functions,
number formats (hex, inf, nan, duration-style), string escapes.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

from ..core.filters import ColumnFilter
from ..core.schemas import METRIC_TAG
from . import functions as F
from .logical import (
    Aggregate,
    ApplyAbsentFunction,
    ApplyInstantFunction,
    ApplyLimitFunction,
    ApplyMiscellaneousFunction,
    ApplySortFunction,
    BinaryJoin,
    LogicalPlan,
    PeriodicSeries,
    PeriodicSeriesWithWindowing,
    RawSeries,
    ScalarBinaryOperation,
    ScalarFixedDoublePlan,
    ScalarTimeBasedPlan,
    ScalarVaryingDoublePlan,
    ScalarVectorBinaryOperation,
    SubqueryWithWindowing,
    TopLevelSubquery,
)

DEFAULT_LOOKBACK_MS = 300_000
DEFAULT_SUBQUERY_STEP_MS = 60_000


class PromQLError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+)
  | (?P<NUMBER>
        0[xX][0-9a-fA-F]+
      | (?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?
    )
  | (?P<IDENT>[a-zA-Z_:][a-zA-Z0-9_:.]*)
  | (?P<STRING>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*'|`[^`]*`)
  | (?P<OP> =~|!~|==|!=|<=|>=|<<|>>|[-+*/%^(){}\[\],=<>@:])
    """,
    re.VERBOSE,
)

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d|w|y)$")
_DURATION_SEQ_RE = re.compile(r"^(?:\d+(?:\.\d+)?(?:ms|s|m|h|d|w|y))+$")
_DUR_PART = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w|y)")
_UNIT_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000, "w": 604_800_000, "y": 31_536_000_000}


@dataclass
class Tok:
    kind: str  # NUMBER | IDENT | STRING | OP | DURATION | EOF
    text: str
    pos: int


def lex(q: str) -> list[Tok]:
    out: list[Tok] = []
    pos = 0
    while pos < len(q):
        m = _TOKEN_RE.match(q, pos)
        if not m:
            raise PromQLError(f"unexpected character {q[pos]!r} at {pos}")
        kind = m.lastgroup
        text = m.group()
        if kind != "WS":
            # idents may contain ':' (recording rules) but a LEADING colon is
            # always the subquery/range separator — emit it as an operator
            if kind == "IDENT" and text.startswith(":"):
                out.append(Tok("OP", ":", pos))
                pos += 1
                continue
            # duration literal: number+unit lexes as NUMBER IDENT; re-join.
            # Idents may contain ':' (recording rules) — inside [30m:1m] the
            # colon separates, so also try the pre-colon prefix.
            if kind == "IDENT" and out and out[-1].kind == "NUMBER" and pos == out[-1].pos + len(out[-1].text):
                if _DURATION_SEQ_RE.match(out[-1].text + text):
                    out[-1] = Tok("DURATION", out[-1].text + text, out[-1].pos)
                    pos = m.end()
                    continue
                prefix = text.split(":", 1)[0]
                if ":" in text and _DURATION_SEQ_RE.match(out[-1].text + prefix):
                    out[-1] = Tok("DURATION", out[-1].text + prefix, out[-1].pos)
                    pos = pos + len(prefix)  # resume at the ':'
                    continue
            out.append(Tok(kind, text, pos))
        pos = m.end()
    out.append(Tok("EOF", "", len(q)))
    return out


def parse_duration_ms(text: str) -> int:
    if _DURATION_SEQ_RE.match(text):
        return int(sum(float(n) * _UNIT_MS[u] for n, u in _DUR_PART.findall(text)))
    try:
        return int(float(text) * 1000)  # bare number = seconds (modern promql)
    except ValueError:
        raise PromQLError(f"invalid duration {text!r}")


def _unquote(s: str) -> str:
    if s[0] == "`":
        return s[1:-1]
    body = s[1:-1]
    return body.encode().decode("unicode_escape")


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Node:
    pass


@dataclass
class NumLit(Node):
    value: float


@dataclass
class StrLit(Node):
    value: str


@dataclass
class Selector(Node):
    metric: str | None
    matchers: list[ColumnFilter]
    window_ms: int | None = None  # matrix selector
    sub_step_ms: int | None = None  # subquery: expr[w:s]
    offset_ms: int = 0
    at: str | float | None = None  # epoch seconds | "start" | "end"


@dataclass
class Subquery(Node):
    inner: Node
    window_ms: int
    sub_step_ms: int | None
    offset_ms: int = 0
    at: str | float | None = None


@dataclass
class Call(Node):
    func: str
    args: list[Node]


@dataclass
class Agg(Node):
    op: str
    expr: Node
    param: Node | None
    by: list[str] | None
    without: list[str] | None


@dataclass
class Binary(Node):
    op: str
    lhs: Node
    rhs: Node
    return_bool: bool = False
    on: list[str] | None = None
    ignoring: list[str] | None = None
    group_side: str | None = None  # "left" | "right"
    include: list[str] | None = None


@dataclass
class Unary(Node):
    op: str
    expr: Node


# precedence (higher binds tighter); ^ is right-associative
_PREC = {
    "or": 1,
    "and": 2, "unless": 2,
    "==": 3, "!=": 3, "<=": 3, "<": 3, ">=": 3, ">": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5, "atan2": 5,
    "^": 6,
}


class Parser:
    def __init__(self, query: str):
        self.toks = lex(query)
        self.i = 0
        self.query = query

    # -- token helpers ---------------------------------------------------

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> Tok:
        t = self.next()
        if t.text != text:
            raise PromQLError(f"expected {text!r} at pos {t.pos}, got {t.text!r}")
        return t

    def accept(self, text: str) -> bool:
        if self.peek().text == text:
            self.i += 1
            return True
        return False

    # -- grammar ---------------------------------------------------------

    def parse(self) -> Node:
        node = self.expr(1)
        if self.peek().kind != "EOF":
            raise PromQLError(f"unexpected token {self.peek().text!r} at {self.peek().pos}")
        return node

    def expr(self, min_prec: int) -> Node:
        lhs = self.unary()
        while True:
            t = self.peek()
            op = t.text if t.kind in ("OP", "IDENT") else None
            if op not in _PREC or _PREC[op] < min_prec:
                return lhs
            self.next()
            return_bool = False
            on = ignoring = include = None
            group_side = None
            if op in F.COMPARISON_OPS and self.accept("bool"):
                return_bool = True
            if self.peek().text in ("on", "ignoring"):
                kind = self.next().text
                labels = self.label_list()
                if kind == "on":
                    on = labels
                else:
                    ignoring = labels
            if self.peek().text in ("group_left", "group_right"):
                group_side = "left" if self.next().text == "group_left" else "right"
                include = self.label_list() if self.peek().text == "(" else []
            next_min = _PREC[op] + (0 if op == "^" else 1)
            rhs = self.expr(next_min)
            lhs = Binary(op, lhs, rhs, return_bool, on, ignoring, group_side, include)

    def unary(self) -> Node:
        t = self.peek()
        if t.text in ("-", "+"):
            self.next()
            inner = self.unary()
            return inner if t.text == "+" else Unary("-", inner)
        return self.postfix(self.atom())

    def postfix(self, node: Node) -> Node:
        """Attach [range], [w:s], offset, @ to selectors/expressions."""
        while True:
            t = self.peek()
            if t.text == "[":
                self.next()
                w = self.next()
                if w.kind not in ("DURATION", "NUMBER"):
                    raise PromQLError(f"expected duration at {w.pos}")
                window = parse_duration_ms(w.text)
                if self.accept(":"):
                    sub_step = None
                    if self.peek().kind in ("DURATION", "NUMBER"):
                        sub_step = parse_duration_ms(self.next().text)
                    self.expect("]")
                    node = Subquery(node, window, sub_step)
                else:
                    self.expect("]")
                    if not isinstance(node, Selector) or node.window_ms is not None:
                        raise PromQLError("range selector on non-instant-selector; use a subquery [w:s]")
                    node.window_ms = window
            elif t.text == "offset":
                self.next()
                neg = self.accept("-")
                d = self.next()
                off = parse_duration_ms(d.text) * (-1 if neg else 1)
                tgt = node
                if isinstance(tgt, (Selector, Subquery)):
                    tgt.offset_ms += off
                else:
                    raise PromQLError("offset must follow a selector or subquery")
            elif t.text == "@":
                self.next()
                nxt = self.next()
                if nxt.text in ("start", "end"):
                    self.expect("(")
                    self.expect(")")
                    at = nxt.text
                elif nxt.kind in ("NUMBER", "DURATION"):
                    at = float(nxt.text)
                else:
                    raise PromQLError(f"invalid @ modifier at {nxt.pos}")
                if isinstance(node, (Selector, Subquery)):
                    node.at = at
                else:
                    raise PromQLError("@ must follow a selector or subquery")
            else:
                return node

    def label_list(self) -> list[str]:
        self.expect("(")
        out = []
        while not self.accept(")"):
            t = self.next()
            if t.kind not in ("IDENT", "STRING"):
                raise PromQLError(f"expected label name at {t.pos}")
            out.append(_unquote(t.text) if t.kind == "STRING" else t.text)
            if self.peek().text == ",":
                self.next()
        return out

    def atom(self) -> Node:
        t = self.peek()
        if t.text == "(":
            self.next()
            inner = self.expr(1)
            self.expect(")")
            return self.postfix(inner)
        if t.kind == "NUMBER":
            self.next()
            txt = t.text.lower()
            val = float(int(txt, 16)) if txt.startswith("0x") else float(txt)
            return NumLit(val)
        if t.kind == "STRING":
            self.next()
            return StrLit(_unquote(t.text))
        if t.kind == "IDENT":
            name = t.text
            if name in F.SET_OPS or name in ("bool", "on", "ignoring", "group_left", "group_right", "offset", "by", "without"):
                raise PromQLError(f"keyword {name!r} cannot start an expression")
            low = name.lower()
            if low in ("inf", "nan"):
                self.next()
                return NumLit(math.inf if low == "inf" else math.nan)
            if name in F.AGGREGATION_OPS and self.toks[self.i + 1].text in ("(", "by", "without"):
                return self.aggregation()
            if (
                name in F.RANGE_FUNCTIONS
                or name in F.INSTANT_FUNCTIONS
                or name in F.MISC_FUNCTIONS
                or name in F.TIME_FUNCTIONS
            ) and self.toks[self.i + 1].text == "(":
                self.next()
                self.expect("(")
                args: list[Node] = []
                while not self.accept(")"):
                    args.append(self.expr(1))
                    if self.peek().text == ",":
                        self.next()
                return Call(name, args)
            return self.selector()
        if t.text == "{":
            return self.selector()
        raise PromQLError(f"unexpected token {t.text!r} at {t.pos}")

    def aggregation(self) -> Node:
        op = self.next().text
        by = without = None
        if self.peek().text in ("by", "without"):
            kind = self.next().text
            labels = self.label_list()
            if kind == "by":
                by = labels
            else:
                without = labels
        self.expect("(")
        args: list[Node] = []
        while not self.accept(")"):
            args.append(self.expr(1))
            if self.peek().text == ",":
                self.next()
        if self.peek().text in ("by", "without"):
            kind = self.next().text
            labels = self.label_list()
            if kind == "by":
                by = labels
            else:
                without = labels
        if op in F.AGG_WITH_PARAM:
            if len(args) != 2:
                raise PromQLError(f"{op} expects (param, expr)")
            return Agg(op, args[1], args[0], by, without)
        if len(args) != 1:
            raise PromQLError(f"{op} expects one argument")
        return Agg(op, args[0], None, by, without)

    def selector(self) -> Node:
        metric = None
        matchers: list[ColumnFilter] = []
        t = self.peek()
        if t.kind == "IDENT":
            metric = self.next().text
        if self.accept("{"):
            while not self.accept("}"):
                lt = self.next()
                if lt.kind not in ("IDENT", "STRING") and lt.text not in F.SET_OPS:
                    raise PromQLError(f"expected label name at {lt.pos}")
                lname = _unquote(lt.text) if lt.kind == "STRING" else lt.text
                op = self.next().text
                if op not in ("=", "!=", "=~", "!~"):
                    raise PromQLError(f"bad matcher op {op!r}")
                vt = self.next()
                if vt.kind != "STRING":
                    raise PromQLError(f"expected quoted value at {vt.pos}")
                matchers.append(ColumnFilter(lname, op, _unquote(vt.text)))
                if self.peek().text == ",":
                    self.next()
        if metric is None and not matchers:
            raise PromQLError("empty selector")
        return Selector(metric, matchers)


# ---------------------------------------------------------------------------
# AST -> LogicalPlan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TimeStepParams:
    """Evaluation grid in epoch ms (reference TimeStepParams is seconds)."""

    start_ms: int
    end_ms: int
    step_ms: int


def _is_scalar_node(n: Node) -> bool:
    if isinstance(n, NumLit):
        return True
    if isinstance(n, Call) and n.func in F.TIME_FUNCTIONS:
        return True
    if isinstance(n, Call) and n.func == "scalar":
        return True
    if isinstance(n, Binary):
        return _is_scalar_node(n.lhs) and _is_scalar_node(n.rhs)
    if isinstance(n, Unary):
        return _is_scalar_node(n.expr)
    return False


class Converter:
    def __init__(self, params: TimeStepParams, lookback_ms: int = DEFAULT_LOOKBACK_MS):
        self.p = params
        self.lookback = lookback_ms

    def _resolve_at(self, at) -> int | None:
        if at is None:
            return None
        if at == "start":
            return self.p.start_ms
        if at == "end":
            return self.p.end_ms
        return int(float(at) * 1000)

    def to_plan(self, n: Node) -> LogicalPlan:
        p = self.p
        if isinstance(n, NumLit):
            return ScalarFixedDoublePlan(n.value, p.start_ms, p.end_ms, p.step_ms)
        if isinstance(n, Unary):
            inner = self.to_plan(n.expr)
            if isinstance(inner, ScalarFixedDoublePlan):
                return ScalarFixedDoublePlan(-inner.value, p.start_ms, p.end_ms, p.step_ms)
            return ScalarVectorBinaryOperation(
                "*", ScalarFixedDoublePlan(-1.0, p.start_ms, p.end_ms, p.step_ms), inner, True
            )
        if isinstance(n, Selector):
            return self.periodic_from_selector(n)
        if isinstance(n, Subquery):
            return self.subquery(n, None, ())
        if isinstance(n, Agg):
            return self.aggregate(n)
        if isinstance(n, Call):
            return self.call(n)
        if isinstance(n, Binary):
            return self.binary(n)
        raise PromQLError(f"cannot convert {n}")

    # -- selectors -------------------------------------------------------

    def _filters(self, sel: Selector) -> tuple[ColumnFilter, ...]:
        out = list(sel.matchers)
        if sel.metric is not None:
            out.append(ColumnFilter(METRIC_TAG, "=", sel.metric))
        else:
            # normalize __name__ matchers to _metric_
            out = [
                ColumnFilter(METRIC_TAG, f.op, f.value) if f.column == "__name__" else f
                for f in out
            ]
        return tuple(out)

    def periodic_from_selector(self, sel: Selector) -> LogicalPlan:
        if sel.window_ms is not None:
            raise PromQLError("range vector must be consumed by a range function")
        p = self.p
        at = self._resolve_at(sel.at)
        start, end = (at, at) if at is not None else (p.start_ms, p.end_ms)
        off = sel.offset_ms
        raw = RawSeries(
            self._filters(sel),
            start - self.lookback - off,
            end - off,
            offset_ms=off,
        )
        return PeriodicSeries(raw, p.start_ms, p.end_ms, p.step_ms, self.lookback, off, at)

    def windowed_from_selector(self, sel: Selector, func: str, args: tuple[float, ...]) -> LogicalPlan:
        p = self.p
        at = self._resolve_at(sel.at)
        start, end = (at, at) if at is not None else (p.start_ms, p.end_ms)
        off = sel.offset_ms
        window = sel.window_ms or 0
        raw = RawSeries(
            self._filters(sel),
            start - window - off,
            end - off,
            offset_ms=off,
        )
        return PeriodicSeriesWithWindowing(
            raw, func, window, p.start_ms, p.end_ms, p.step_ms, off, at, args
        )

    def subquery(self, sq: Subquery, func: str | None, args: tuple[float, ...]) -> LogicalPlan:
        p = self.p
        at = self._resolve_at(sq.at)
        start, end = (at, at) if at is not None else (p.start_ms, p.end_ms)
        sub_step = sq.sub_step_ms or DEFAULT_SUBQUERY_STEP_MS
        off = sq.offset_ms
        # inner evaluated over the extended aligned grid (reference
        # SubqueryUtils: start snapped down to a multiple of sub_step)
        inner_start = ((start - off - sq.window_ms) // sub_step) * sub_step
        if inner_start < start - off - sq.window_ms:
            inner_start += sub_step
        inner_end = ((end - off) // sub_step) * sub_step
        inner = Converter(
            TimeStepParams(inner_start, inner_end, sub_step), self.lookback
        ).to_plan(sq.inner)
        if func is None:
            return TopLevelSubquery(inner, p.start_ms, p.end_ms, p.step_ms, off)
        return SubqueryWithWindowing(
            inner, func, sq.window_ms, sub_step, p.start_ms, p.end_ms, p.step_ms, off, args
        )

    # -- functions -------------------------------------------------------

    def call(self, c: Call) -> LogicalPlan:
        p = self.p
        name = c.func
        if name in F.TIME_FUNCTIONS:
            if c.args and name != "pi":
                inner = self.to_plan(c.args[0])
                return ApplyInstantFunction(inner, name)
            if name == "pi":
                return ScalarFixedDoublePlan(math.pi, p.start_ms, p.end_ms, p.step_ms)
            return ScalarTimeBasedPlan(name, p.start_ms, p.end_ms, p.step_ms)
        if name in F.RANGE_FUNCTIONS:
            kernel, n_scalar, scalars_first = F.RANGE_FUNCTIONS[name]
            scalars: list[float] = []
            vec: Node | None = None
            for a in c.args:
                if isinstance(a, (Selector, Subquery)):
                    vec = a
                elif isinstance(a, NumLit):
                    scalars.append(a.value)
                elif isinstance(a, Unary) and isinstance(a.expr, NumLit):
                    scalars.append(-a.expr.value)
                else:
                    raise PromQLError(f"{name}: unsupported argument {a}")
            if vec is None:
                raise PromQLError(f"{name} needs a range-vector argument")
            if isinstance(vec, Subquery):
                return self.subquery(vec, kernel, tuple(scalars))
            if vec.window_ms is None:
                raise PromQLError(f"{name} needs a range vector (add [window])")
            return self.windowed_from_selector(vec, kernel, tuple(scalars))
        if name == "absent":
            inner_node = c.args[0]
            inner = self.to_plan(inner_node)
            filters = ()
            if isinstance(inner_node, Selector):
                filters = self._filters(inner_node)
            return ApplyAbsentFunction(inner, filters, p.start_ms, p.end_ms, p.step_ms)
        if name in ("sort", "sort_desc"):
            return ApplySortFunction(self.to_plan(c.args[0]), name == "sort_desc")
        if name == "scalar":
            return ScalarVaryingDoublePlan(self.to_plan(c.args[0]), "scalar")
        if name == "vector":
            return ScalarVaryingDoublePlan(self.to_plan(c.args[0]), "vector")
        if name == "limit":
            if len(c.args) != 2 or not isinstance(c.args[0], NumLit):
                raise PromQLError("limit expects (n, expr)")
            return ApplyLimitFunction(self.to_plan(c.args[1]), int(c.args[0].value))
        if name in ("optimize_with_agg", "no_optimize", "_filodb_chunkmeta_all"):
            # planner/lpopt markers + chunk-metadata debug wrapper
            if len(c.args) != 1:
                raise PromQLError(f"{name} expects exactly one argument")
            return ApplyMiscellaneousFunction(self.to_plan(c.args[0]), name)
        if name in ("label_replace", "label_join"):
            inner = self.to_plan(c.args[0])
            strs = []
            for a in c.args[1:]:
                if not isinstance(a, StrLit):
                    raise PromQLError(f"{name} expects string arguments")
                strs.append(a.value)
            return ApplyMiscellaneousFunction(inner, name, tuple(strs))
        if name in F.INSTANT_FUNCTIONS:
            # scalar args may come before (histogram_quantile) or after
            # (clamp, round) the vector argument
            scalars: list = []
            vec_plan: LogicalPlan | None = None
            for a in c.args:
                if _is_scalar_node(a):
                    lit = self.to_plan(a)
                    scalars.append(lit.value if isinstance(lit, ScalarFixedDoublePlan) else lit)
                else:
                    vec_plan = self.to_plan(a)
            if vec_plan is None:
                raise PromQLError(f"{name} needs a vector argument")
            return ApplyInstantFunction(vec_plan, name, tuple(scalars))
        raise PromQLError(f"unknown function {name!r}")

    def aggregate(self, a: Agg) -> LogicalPlan:
        inner = self.to_plan(a.expr)
        params: tuple = ()
        if a.param is not None:
            if isinstance(a.param, NumLit):
                params = (a.param.value,)
            elif isinstance(a.param, StrLit):
                params = (a.param.value,)
            elif isinstance(a.param, Unary) and isinstance(a.param.expr, NumLit):
                params = (-a.param.expr.value,)
            else:
                raise PromQLError(f"{a.op}: parameter must be a literal")
        return Aggregate(
            a.op,
            inner,
            params,
            tuple(a.by) if a.by is not None else None,
            tuple(a.without) if a.without is not None else None,
        )

    def binary(self, b: Binary) -> LogicalPlan:
        scalar_l = _is_scalar_node(b.lhs)
        scalar_r = _is_scalar_node(b.rhs)
        p = self.p
        if scalar_l and scalar_r:
            if b.op in F.SET_OPS:
                raise PromQLError(f"set operator {b.op} requires vector operands")
            lhs, rhs = self.to_plan(b.lhs), self.to_plan(b.rhs)
            return ScalarBinaryOperation(b.op, lhs, rhs, p.start_ms, p.end_ms, p.step_ms)
        if scalar_l or scalar_r:
            if b.op in F.SET_OPS:
                raise PromQLError(f"set operator {b.op} requires vector operands")
            sc = self.to_plan(b.lhs if scalar_l else b.rhs)
            vec = self.to_plan(b.rhs if scalar_l else b.lhs)
            return ScalarVectorBinaryOperation(b.op, sc, vec, scalar_l, b.return_bool)
        lhs, rhs = self.to_plan(b.lhs), self.to_plan(b.rhs)
        if b.op in F.SET_OPS:
            card = "many-to-many"
        elif b.group_side == "left":
            card = "many-to-one"
        elif b.group_side == "right":
            card = "one-to-many"
        else:
            card = "one-to-one"
        return BinaryJoin(
            lhs,
            b.op,
            rhs,
            card,
            tuple(b.on) if b.on is not None else None,
            tuple(b.ignoring or ()),
            tuple(b.include or ()),
            b.return_bool,
        )


# ---------------------------------------------------------------------------
# Entry points (reference Parser.queryToLogicalPlan:183 /
# queryRangeToLogicalPlan:190 / metadataQueryToLogicalPlan:104)
# ---------------------------------------------------------------------------


def parse_query(query: str) -> Node:
    return Parser(query).parse()


def query_range_to_logical_plan(
    query: str, start_s: float, end_s: float, step_s: float, lookback_ms: int = DEFAULT_LOOKBACK_MS
) -> LogicalPlan:
    params = TimeStepParams(int(start_s * 1000), int(end_s * 1000), max(int(step_s * 1000), 1))
    ast = parse_query(query)
    # bare matrix selector / subquery at top level => raw export / subquery
    if isinstance(ast, Selector) and ast.window_ms is not None:
        off = ast.offset_ms
        conv = Converter(params, lookback_ms)
        return RawSeries(
            conv._filters(ast),
            params.start_ms - ast.window_ms - off,
            params.end_ms - off,
            offset_ms=off,
        )
    return Converter(params, lookback_ms).to_plan(ast)


def query_to_logical_plan(query: str, time_s: float, lookback_ms: int = DEFAULT_LOOKBACK_MS) -> LogicalPlan:
    """Instant query: grid of one step at time_s."""
    return query_range_to_logical_plan(query, time_s, time_s, 1, lookback_ms)
