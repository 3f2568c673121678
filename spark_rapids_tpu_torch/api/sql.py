"""SQL front end: text -> tokens -> AST -> logical plan.

Counterpart of ``spark_rapids_tpu/api/sql.py`` for the subset the port
runs:

- ``WITH name AS (query) [, ...]`` before a query: each CTE is a view
  while the query is lowered, and a later CTE reads an earlier one;
- set operations with the reference's semantics (``lower_setop``):
  ``UNION ALL`` (a Union under the left side's names, each column
  widened to the wider numeric type as Spark widens it), ``UNION``,
  ``INTERSECT`` and ``EXCEPT`` (a Distinct of the union, or of a semi /
  anti join on null-safe keys: two NULLs match), chained left to right
  with INTERSECT binding tighter (Spark's precedence), parenthesised
  operands, a trailing ``ORDER BY`` / ``LIMIT`` of the whole operation,
  a WITH on its leftmost SELECT in scope for all of it, anywhere a
  query goes (a CTE, a derived table, a subquery);
- ``SELECT [DISTINCT]`` lists of expressions with aliases (``AS``
  optional) and ``*``; DISTINCT's ORDER BY names selected columns;
- ``FROM`` lists of temp views, CTEs and derived tables (``(query)
  [AS] alias``) as comma joins and ``[INNER | LEFT [OUTER] | RIGHT
  [OUTER] | FULL [OUTER] | LEFT SEMI | LEFT ANTI] JOIN ... ON`` or
  ``CROSS JOIN``, the two mixed
  (``a LEFT JOIN b ON ..., c``), with aliases, column names with or
  without a qualifier; a relation read twice under two aliases
  (``date_dim d1, date_dim d2``, a CTE ``ss ss1, ss ss2``) has its
  second copy's colliding columns renamed ``__<alias>_<name>`` inside
  the plan; a join without an equality between its sides (a cross join,
  or ``ON`` a non-equi condition) is a nested-loop join;
- ``WHERE`` with ``AND`` / ``OR`` / ``NOT``, the comparisons ``=``,
  ``<>``, ``!=``, ``<``, ``<=``, ``>``, ``>=``, ``[NOT] BETWEEN``,
  ``[NOT] IN (literal list)``, ``[NOT] LIKE 'pattern' [ESCAPE 'c']``
  (any pattern of ``%``, ``_`` and the escape, backslash by default),
  ``IS [NOT] NULL``; conjuncts common
  to every arm of an OR are factored out of it (``plan/logical_opt``'s
  ``_factor_or``, for WHERE and ``JOIN ... ON`` alike), so join
  equalities written inside the arms become join keys;
  ``<=>`` is not parsed (``Col.eq_null_safe`` has it);
- ``+``, ``-``, ``*``, ``/``, ``%``, unary minus, ``||``; ``CAST(x AS
  t)`` among the numbers, BOOL, DATE and STRING (``boolean``, ``int``,
  ``bigint``, ``float``, ``double``, ``date``, ``decimal(p, s)`` /
  ``numeric(p, s)`` up to 18 digits, ``string``, ``varchar[(n)]``;
  Spark's non-ANSI rules, ``expr/cast.py``); DECIMAL columns (Parquet ``decimal128``) in
  arithmetic, comparisons, CASE, the aggregates, keys and windows;
  ``CASE [x] WHEN ... THEN ... [ELSE ...] END`` and ``if(c, a, b)`` with
  numeric, DATE or string values; ``substring`` / ``substr`` with
  literal positions (in characters), ``concat``, ``coalesce`` / ``nvl``
  / ``ifnull`` (numbers, DATEs or strings), ``nullif``, ``isnull`` /
  ``isnotnull``, ``isnan``, ``nanvl``, ``abs``, ``round(x[, d])``
  (HALF_UP), ``upper`` / ``ucase``, ``lower`` / ``lcase`` and
  ``initcap`` (ASCII letters, as the reference), ``length`` /
  ``char_length`` / ``character_length``, ``trim`` / ``ltrim`` /
  ``rtrim``, ``reverse``, ``instr(s, sub)``, ``locate(sub, s[, pos])``,
  ``concat_ws(sep, ...)``, ``replace(s, search[, rep])``,
  ``repeat(s, n)``, ``lpad`` / ``rpad(s, n[, pad])`` (literal
  arguments but the string; by characters), ``md5``, ``rand([seed])``,
  ``to_date(s)``; the math functions of a number ``sqrt``,
  ``exp``, ``ln`` / ``log`` (one argument), ``log2``, ``log10`` (the
  logarithms NULL at 0 and below, Spark's answer), ``sin``, ``cos``,
  ``tan``, ``asin``, ``acos``, ``atan``, ``degrees``, ``radians``,
  ``floor``, ``ceil`` / ``ceiling`` (a bigint of a double),
  ``sign`` / ``signum``, and of two ``pow`` / ``power``, ``atan2``,
  ``mod`` and ``pmod`` (Spark's, also with a negative divisor);
  ``greatest`` / ``least`` of numbers, DATEs or strings (a NaN above
  every number, strings in byte order); ``hash(x, ...)`` (``expr/misc.Murmur3Hash``);
- integer, decimal (read as double, as the reference; Spark's is a
  DECIMAL), string and ``NULL`` literals;
  ``DATE 'yyyy-mm-dd'`` literals; DATE columns (date32 in Parquet)
  compare with DATEs, key joins, group-bys, DISTINCT and sorts, and are
  collected as date32; ``date ± INTERVAL n DAY[S]``, ``INTERVAL n DAYS +
  date`` and ``date ± n`` for an integer ``n``; ``year``, ``month``,
  ``day`` / ``dayofmonth``, ``quarter``, ``dayofweek``, ``weekday``,
  ``dayofyear``, ``last_day``, ``date_add``, ``date_sub`` and
  ``datediff`` (``expr/datetime.py``);
- ``GROUP BY`` expressions, ordinals or select aliases, with or
  without aggregates, or ``ROLLUP (...)``, ``CUBE (...)`` and ``GROUPING
  SETS ((...), x, (), ...)`` of them (the reference's Expand rewrite,
  ``plan/logical.build_grouping_sets``), with ``grouping(key)``, also
  inside arithmetic, ORDER BY and a window's PARTITION BY; the
  aggregates ``count(*)``, ``count``, ``sum``, ``min`` and ``max`` (also
  of strings and DATEs), ``first`` / ``first_value`` and ``last`` /
  ``last_value`` (Spark's default: NULL rows count), ``avg`` / ``mean``,
  ``stddev`` / ``stddev_samp`` / ``std``, ``stddev_pop``, ``variance`` /
  ``var_samp``, ``var_pop`` (all but ``count``, ``min``, ``max``,
  ``first`` and ``last`` of numbers, or of strings cast to double:
  Spark's implicit cast, NULL for a word that is no number), ``count``, ``sum`` and
  ``avg`` of ``DISTINCT x`` (one argument shared by every DISTINCT
  call: the reference's two-level rewrite,
  ``build_aggregate``), and expressions over them and over the group
  keys; ``HAVING``, whose aggregates need not be selected; a call that
  ORDER BY or HAVING repeats is the select list's column;
- ``ORDER BY`` expressions, select aliases or ordinals with ``ASC`` /
  ``DESC`` and ``NULLS FIRST`` / ``LAST``, and select aliases inside an
  expression (q70's ``case when lochierarchy = 0 then s_state end``,
  substituted through the tree as the reference does); ``LIMIT``;
- window functions in the select list and ORDER BY (the reference's
  ``lower_window``): ``f(...) OVER ([PARTITION BY ...] [ORDER BY ...]
  [ROWS | RANGE BETWEEN bound AND bound])``, a bound ``UNBOUNDED
  PRECEDING`` / ``FOLLOWING``, ``CURRENT ROW`` or ``n PRECEDING`` /
  ``FOLLOWING``; SQL's default frame is ``RANGE BETWEEN UNBOUNDED
  PRECEDING AND CURRENT ROW`` with ORDER BY, the whole partition
  without.  ``f`` is ``row_number``, ``rank``, ``dense_rank``,
  ``ntile(n)``, ``percent_rank``, ``cume_dist``, ``lead`` / ``lag(x[,
  n[, NULL]])``, or ``sum``, ``count``, ``avg``, ``min`` or ``max`` of
  numbers (``count``, ``min`` and ``max`` also of DATEs); a RANGE frame
  with offsets takes one integer or DATE order key.  The windows run
  after the aggregate and HAVING, before the ORDER BY and the
  projection, so ``sum(sum(x)) OVER (...)`` and ``x * 100.0 /
  sum(sum(x)) OVER (...)`` lower, and a filter on a window's column in
  an outer query stays above the window;
- expression subqueries, with the reference's semantics
  (``spark_rapids_tpu/api/sql.py``'s ``lower_where``):
  an uncorrelated scalar query anywhere an expression goes (WHERE, the
  select list, CASE, HAVING) runs while the text is lowered, to a
  literal (NULL of its type for no row; ``SqlError`` for more than
  one); ``x [NOT] IN (query)`` as a conjunct of WHERE is a semi or anti
  join (``NOT IN`` in three-valued logic: an empty set keeps every row,
  a NULL in the set none, a NULL ``x`` never matches), and inside any
  other expression an uncorrelated one runs to an IN list (q45's ``...
  or i_item_id in (select ...)``); ``[NOT] EXISTS`` as a conjunct of
  WHERE runs to a constant when uncorrelated, and is a semi or anti
  join on its equalities with the outer query when correlated (other
  conditions between the two queries a residual join condition); an OR
  of correlated ``EXISTS`` on the same outer keys is one semi join
  against the union of their key sets (q10); ``x CMP (query)`` with a
  correlated query of one aggregate is that query grouped by its
  correlation keys, an inner join and a filter (q1, q32).  A correlated
  query's WHERE has the conjuncts common to the arms of its ORs
  factored out first (the reference's AST-level ``_factor_or``): q41's
  ``i_manufact = i1.i_manufact`` inside both arms becomes a
  correlation.  A subquery that runs while the text is lowered runs on
  the session's device:
  ``sql_to_plan`` without a session raises ``SqlError`` for it.

Anything else raises ``SqlError`` naming the construct, before any
device work (a subquery may have run): ``INTERSECT ALL`` and ``EXCEPT
ALL`` (the reference answers them as the distinct forms, which is not
Spark's answer), ``lead`` / ``lag`` with a default other than NULL (the
reference answers NULL at the partition's edge, Spark the default),
``first`` / ``last`` with an ``ignoreNulls`` argument (``true`` is no
literal here; the DataFrame API takes it), a window outside the
select list and ORDER BY, ``first``, ``last``, ``collect_list`` and the
moments over a window, ``RLIKE`` and ``regexp_*`` (a device regex
engine is not ported), a string function with a non-literal argument
other than its string, a union of
columns with no common type (a string and a number), DISTINCT calls
of more than one argument, ``DISTINCT`` in another aggregate or over a
window, a CAST to or from TIMESTAMP, or between a DATE
and a number, an ``INTERVAL`` of another unit than days or away from a
DATE's ``+`` / ``-``, other date arithmetic, ``tinyint`` and
``smallint``, a DATE compared with a number or a string, a correlated
``IN (query)``, a correlation other than
equalities of a scalar query, a correlated subquery outside a conjunct
of WHERE, and the rest of Spark SQL.  The plan is built in Spark's order:
the FROM relations as a left-deep join tree, WHERE as a filter over it
(its subquery conjuncts as joins under that filter), the aggregate (its
keys and every aggregate call of the select list, HAVING and ORDER BY
as columns), HAVING as a filter over it, the windows, the sort, the
projection of the select list (for DISTINCT: the projection, its
Distinct, then the sort), the limit; then ``plan/logical_opt.optimize``
turns the comma joins and WHERE equalities into equi-joins with the
filters below them, also through a derived table's projection, a semi
or anti join, a union and an aggregate's group keys.
"""
from __future__ import annotations

import dataclasses
import datetime
import re
from typing import Any, Dict, List, Optional, Tuple

from ..columnar import dtypes as T
from ..expr import aggregates as eagg
from ..expr import arithmetic as ea
from ..expr import cast as ecast
from ..expr import conditional as econd
from ..expr import core as ec
from ..expr import datetime as edt
from ..expr import misc as emisc
from ..expr import predicates as ep
from ..expr import string_ops as es
from ..expr import window_funcs as ewin
from ..exec.tpu_window import check_window_func
from ..plan import logical as L
from ..plan.logical_opt import optimize


class SqlError(Exception):
    pass


# -- lexer -------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*\n?|/\*.*?\*/)
  | (?P<num>(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"[^"]*"|`[^`]*`)
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|>=|<=|\|\||[(),.*+\-/%<>=;])
""", re.VERBOSE | re.DOTALL)


@dataclasses.dataclass
class Tok:
    kind: str      # num | str | id | qid | op | end
    text: str
    pos: int


def _lex(sql: str) -> List[Tok]:
    out: List[Tok] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SqlError(f"unexpected character {sql[i]!r} at {i}")
        i = m.end()
        if m.lastgroup != "ws":
            out.append(Tok(m.lastgroup, m.group(), m.start()))
    out.append(Tok("end", "", len(sql)))
    return out


# -- AST ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Lit:
    value: Any              # None: the NULL literal


@dataclasses.dataclass(frozen=True)
class Ident:
    name: str
    qualifier: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Res:
    """A column resolved to its name in the plan's schema."""
    cname: str


@dataclasses.dataclass(frozen=True)
class Star:
    pass


@dataclasses.dataclass(frozen=True)
class Call:
    name: str
    args: Tuple[Any, ...]
    star: bool = False
    #: ``f(DISTINCT x)``
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class CastE:
    """``CAST(child AS typename)``."""
    child: Any
    typename: str


@dataclasses.dataclass(frozen=True)
class Interval:
    """``INTERVAL n unit``; it lowers only beside ``+`` / ``-`` of a
    DATE."""
    n: int
    unit: str


@dataclasses.dataclass(frozen=True)
class BinOp:
    op: str
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class NotOp:
    child: Any


@dataclasses.dataclass(frozen=True)
class Neg:
    child: Any


@dataclasses.dataclass(frozen=True)
class Between:
    child: Any
    lo: Any
    hi: Any
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InList:
    child: Any
    items: Tuple[Any, ...]
    negated: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class InSub:
    """``child [NOT] IN (query)``; compared by identity, as are the other
    subquery nodes (a query is not hashable)."""
    child: Any
    query: "Select"
    negated: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class Exists:
    query: "Select"
    negated: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class ScalarSub:
    """A parenthesised query in expression position."""
    query: "Select"


@dataclasses.dataclass(frozen=True)
class LikeOp:
    child: Any
    pattern: str
    negated: bool = False
    escape: str = "\\"


@dataclasses.dataclass(frozen=True)
class IsNullOp:
    child: Any
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Case:
    operand: Any
    whens: Tuple[Tuple[Any, Any], ...]
    els: Any = None


@dataclasses.dataclass(frozen=True)
class WindowE:
    """``func(...) OVER (PARTITION BY ... ORDER BY ... [frame])``;
    ``order`` holds (expression, ascending, nulls first) triples and
    ``frame`` is ``(kind, lo, hi)`` or None for SQL's default."""
    func: Call
    partition: Tuple[Any, ...]
    order: Tuple[Tuple[Any, bool, Optional[bool]], ...]
    frame: Optional[Tuple[str, Optional[int], Optional[int]]] = None


@dataclasses.dataclass
class TableRef:
    name: str
    alias: Optional[str]


@dataclasses.dataclass
class SubqueryRef:
    """A parenthesised query with an alias in FROM (a derived table)."""
    query: "Select"
    alias: str


@dataclasses.dataclass
class JoinRef:
    left: Any
    right: Any
    how: str
    on: Any


@dataclasses.dataclass
class OrderItem:
    expr: Any
    ascending: bool
    nulls_first: Optional[bool]


@dataclasses.dataclass
class Select:
    items: List[Tuple[Any, Optional[str]]]
    from_: List[Any]
    where: Any = None
    group_by: List[Any] = dataclasses.field(default_factory=list)
    having: Any = None
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    #: ``WITH name AS (query), ...``: (name, query) in order
    ctes: List[Tuple[str, Any]] = dataclasses.field(default_factory=list)
    #: ``SELECT DISTINCT``
    distinct: bool = False
    #: written in parentheses: its ORDER BY and LIMIT are its own, not a
    #: set operation's around it
    parenthesized: bool = False
    #: ``GROUP BY ROLLUP / CUBE / GROUPING SETS``: each set as positions
    #: in ``group_by``; None for a plain GROUP BY
    group_sets: Optional[List[Tuple[int, ...]]] = None


@dataclasses.dataclass
class SetOp:
    """``left UNION [ALL] | INTERSECT [ALL] | EXCEPT [ALL] right``, each
    side a Select or a SetOp; ``order_by`` and ``limit`` belong to the
    whole operation."""
    op: str                 # union | intersect | except
    all: bool
    left: Any
    right: Any
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None


def _kids(a) -> List[Any]:
    """The expression nodes directly under ``a``; a subquery's own
    expressions are not (only an ``IN (query)``'s operand is), nor is a
    window's function call (its arguments are: ``sum(sum(x)) OVER``
    aggregates ``sum(x)`` and is no aggregate itself)."""
    if isinstance(a, WindowE):
        return list(a.func.args) + list(a.partition) + \
            [e for e, _, _ in a.order]
    if isinstance(a, Case):
        out = [a.operand] if a.operand is not None else []
        for c, v in a.whens:
            out += [c, v]
        return out + ([a.els] if a.els is not None else [])
    if isinstance(a, (Call, InList)):
        return ([a.child] if isinstance(a, InList) else []) + \
            list(a.args if isinstance(a, Call) else a.items)
    if isinstance(a, Between):
        return [a.child, a.lo, a.hi]
    if isinstance(a, BinOp):
        return [a.left, a.right]
    if isinstance(a, (NotOp, Neg, LikeOp, IsNullOp, InSub, CastE)):
        return [a.child]
    return []


def _walk(a):
    yield a
    for k in _kids(a):
        yield from _walk(k)


def _transform_kids(a, f):
    """``a`` with ``f`` applied to each of its direct expression nodes."""
    if isinstance(a, WindowE):
        return WindowE(Call(a.func.name, tuple(f(x) for x in a.func.args),
                            a.func.star, a.func.distinct),
                       tuple(f(p) for p in a.partition),
                       tuple((f(e), asc, nf) for e, asc, nf in a.order),
                       a.frame)
    if isinstance(a, Case):
        return Case(f(a.operand) if a.operand is not None else None,
                    tuple((f(c), f(v)) for c, v in a.whens),
                    f(a.els) if a.els is not None else None)
    if isinstance(a, Call):
        return Call(a.name, tuple(f(x) for x in a.args), a.star, a.distinct)
    if isinstance(a, InList):
        return InList(f(a.child), tuple(f(x) for x in a.items), a.negated)
    if isinstance(a, Between):
        return Between(f(a.child), f(a.lo), f(a.hi), a.negated)
    if isinstance(a, BinOp):
        return BinOp(a.op, f(a.left), f(a.right))
    if isinstance(a, (NotOp, Neg, LikeOp, IsNullOp, InSub, CastE)):
        return dataclasses.replace(a, child=f(a.child))
    return a


def _transform(a, fn):
    """Bottom-up rebuild of an expression AST with ``fn`` applied to
    every node."""
    return fn(_transform_kids(a, lambda k: _transform(k, fn)))


#: keywords that end an expression or cannot be an alias
_KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit", "as", "and",
    "or", "not", "join", "on", "inner", "left", "right", "full", "outer",
    "cross", "asc", "desc", "nulls", "first", "last", "having", "union",
    "intersect", "except", "with", "distinct", "between", "in", "like",
    "is", "null", "case", "when", "then", "else", "end", "exists", "over",
    "offset", "semi", "anti", "using", "interval", "cast", "true", "false",
    "all", "window", "qualify", "lateral", "natural", "rollup", "cube",
    "grouping", "rlike", "date", "timestamp",
}
#: constructs of Spark SQL the port does not parse, by their keyword
_UNSUPPORTED = {
    "offset": "OFFSET",
    "true": "boolean literals", "false": "boolean literals",
    "using": "JOIN ... USING",
    "natural": "NATURAL JOIN",
    "window": "WINDOW", "qualify": "QUALIFY", "lateral": "LATERAL",
    "all": "ALL", "rlike": "RLIKE", "timestamp": "TIMESTAMP literals",
}
_AGGREGATES = {"sum": eagg.Sum, "count": eagg.Count, "max": eagg.Max,
               "min": eagg.Min, "first": eagg.First,
               "first_value": eagg.First, "last": eagg.Last,
               "last_value": eagg.Last,
               "avg": eagg.Average, "mean": eagg.Average,
               "stddev": eagg.StddevSamp, "stddev_samp": eagg.StddevSamp,
               "std": eagg.StddevSamp, "stddev_pop": eagg.StddevPop,
               "variance": eagg.VarianceSamp, "var_samp": eagg.VarianceSamp,
               "var_pop": eagg.VariancePop}
#: the aggregates a window takes
_WINDOW_AGGREGATES = {n: f for n, f in _AGGREGATES.items()
                      if not issubclass(f, eagg.First)}
#: window functions that are no aggregate, by their argument count
_WINDOW_FUNCTIONS = {"row_number": (0, 0), "rank": (0, 0),
                     "dense_rank": (0, 0), "percent_rank": (0, 0),
                     "cume_dist": (0, 0), "ntile": (1, 1), "lead": (1, 3),
                     "lag": (1, 3)}
#: the aggregates that take DISTINCT
_DISTINCT_AGGREGATES = ("count", "sum", "avg", "mean")
#: the DATE functions of one argument, by their SQL names
_DATE_FIELDS = {"year": edt.Year, "month": edt.Month, "day": edt.DayOfMonth,
                "dayofmonth": edt.DayOfMonth, "quarter": edt.Quarter,
                "dayofweek": edt.DayOfWeek, "weekday": edt.WeekDay,
                "dayofyear": edt.DayOfYear, "last_day": edt.LastDay}
_COMPARISONS = {"=": ep.EqualTo, "<": ep.LessThan, "<=": ep.LessThanOrEqual,
                ">": ep.GreaterThan, ">=": ep.GreaterThanOrEqual}
_ARITHMETIC = {"+": ea.Add, "-": ea.Subtract, "*": ea.Multiply,
               "/": ea.Divide, "%": ea.Remainder}
#: the math functions of one number, by their SQL names
_MATH = {"sqrt": ea.Sqrt, "exp": ea.Exp, "ln": ea.Log, "log": ea.Log,
         "log2": ea.Log2, "log10": ea.Log10, "sin": ea.Sin, "cos": ea.Cos,
         "tan": ea.Tan, "asin": ea.Asin, "acos": ea.Acos, "atan": ea.Atan,
         "degrees": ea.ToDegrees, "radians": ea.ToRadians,
         "floor": ea.Floor, "ceil": ea.Ceil, "ceiling": ea.Ceil,
         "sign": ea.Signum, "signum": ea.Signum}
#: the functions of two numbers
_MATH2 = {"pow": ea.Pow, "power": ea.Pow, "atan2": ea.Atan2,
          "mod": ea.Remainder, "pmod": ea.Pmod}


class _Parser:
    """Recursive descent over the token list."""

    def __init__(self, sql: str):
        self.toks = _lex(sql)
        self.i = 0

    # -- tokens --------------------------------------------------------------
    @property
    def tok(self) -> Tok:
        return self.toks[self.i]

    def _word(self, t: Tok = None) -> str:
        t = t or self.tok
        return t.text.lower() if t.kind == "id" else ""

    def at(self, *words: str) -> bool:
        return self._word() in words

    def at_op(self, *ops: str) -> bool:
        return self.tok.kind == "op" and self.tok.text in ops

    def advance(self) -> Tok:
        t = self.tok
        self.i += 1
        return t

    def expect(self, word: str) -> None:
        if not self.at(word):
            self._fail(f"expected {word.upper()}")
        self.advance()

    def expect_op(self, op: str) -> None:
        if not self.at_op(op):
            self._fail(f"expected {op!r}")
        self.advance()

    def _fail(self, what: str):
        t = self.tok
        got = t.text or "end of query"
        w = self._word(t)
        if w in _UNSUPPORTED:
            raise SqlError(f"{_UNSUPPORTED[w]} is not supported by the port "
                           f"(at {t.pos})")
        raise SqlError(f"{what}, got {got!r} at {t.pos}")

    def _unsupported_here(self) -> None:
        w = self._word()
        if w in _UNSUPPORTED:
            self._fail("")

    # -- statements ----------------------------------------------------------
    def parse(self):
        q = self.query_expr()
        if self.at_op(";"):
            self.advance()
        if self.tok.kind != "end":
            self._fail("expected end of query")
        return q

    def query_expr(self):
        """A query: SELECTs joined by ``UNION [ALL]`` and ``EXCEPT
        [ALL]``, left to right, over terms joined by ``INTERSECT [ALL]``,
        which binds tighter (Spark's precedence; the reference gives the
        three one level), with a trailing ORDER BY / LIMIT that belongs
        to the whole set operation."""
        left = self.intersect_term()
        while self.at("union", "except"):
            op = self.advance().text.lower()
            left = SetOp(op, self._set_all(), left, self.intersect_term())
        if not isinstance(left, SetOp):
            return left
        self.order_limit(left)
        if not left.order_by and left.limit is None:
            # an unparenthesised last SELECT took the trailing ORDER BY /
            # LIMIT while it was parsed: they belong to the whole query
            last = left
            while isinstance(last.right, SetOp):
                last = last.right
            rb = last.right
            if not rb.parenthesized and (rb.order_by or
                                         rb.limit is not None):
                left.order_by, left.limit = rb.order_by, rb.limit
                rb.order_by, rb.limit = [], None
        return left

    def intersect_term(self):
        left = self.query_term()
        while self.at("intersect"):
            self.advance()
            left = SetOp("intersect", self._set_all(), left,
                         self.query_term())
        return left

    def _set_all(self) -> bool:
        """``ALL`` after a set operator (``DISTINCT`` is the default)."""
        if self.at("all"):
            self.advance()
            return True
        if self.at("distinct"):
            self.advance()
        return False

    def query_term(self):
        """A SELECT, or a query in parentheses."""
        if self.at_op("("):
            self.advance()
            q = self.query_expr()
            self.expect_op(")")
            if isinstance(q, Select):
                q.parenthesized = True
            return q
        return self.select()

    def order_limit(self, q) -> None:
        """``[ORDER BY ...] [LIMIT n]`` into ``q``."""
        if self.at("order"):
            self.advance()
            self.expect("by")
            q.order_by = [self.order_item()]
            while self.at_op(","):
                self.advance()
                q.order_by.append(self.order_item())
        if self.at("limit"):
            self.advance()
            if self.tok.kind != "num" or not self.tok.text.isdigit():
                self._fail("expected an integer LIMIT")
            q.limit = int(self.advance().text)

    def select(self) -> Select:
        ctes = []
        if self.at("with"):
            self.advance()
            while True:
                name = self.name()
                self.expect("as")
                self.expect_op("(")
                ctes.append((name, self.query_expr()))
                self.expect_op(")")
                if not self.at_op(","):
                    break
                self.advance()
        self.expect("select")
        distinct = self.at("distinct")
        if distinct:
            self.advance()
        self._unsupported_here()
        items = [self.select_item()]
        while self.at_op(","):
            self.advance()
            items.append(self.select_item())
        if not self.at("from"):
            self._fail("expected FROM (a query without FROM is not ported)")
        self.advance()
        from_ = [self.join_tree()]
        while self.at_op(","):
            self.advance()
            from_.append(self.join_tree())
        q = Select(items, from_, ctes=ctes, distinct=distinct)
        if self.at("where"):
            self.advance()
            q.where = self.expr()
        if self.at("group"):
            self.advance()
            self.expect("by")
            self.group_by(q)
        if self.at("having"):
            self.advance()
            q.having = self.expr()
        self._unsupported_here()
        self.order_limit(q)
        self._unsupported_here()
        return q

    def _expr_list(self) -> List[Any]:
        """``(expr, ...)``; ``()`` is the empty list."""
        self.expect_op("(")
        out = []
        if not self.at_op(")"):
            out.append(self.expr())
            while self.at_op(","):
                self.advance()
                out.append(self.expr())
        self.expect_op(")")
        return out

    def _next_is(self, *texts: str) -> bool:
        return self.toks[self.i + 1].text.lower() in texts

    def group_by(self, q: Select) -> None:
        """GROUP BY's keys: expressions, ``ROLLUP (...)``, ``CUBE (...)``
        or ``GROUPING SETS ((...), x, (), ...)``, each set kept as the
        positions of its members in ``q.group_by`` (the reference's
        ``rollup_sets`` / ``cube_sets`` order)."""
        if self.at("rollup", "cube") and self._next_is("("):
            kind = self.advance().text.lower()
            q.group_by = self._expr_list()
            if not q.group_by:
                self._fail("expected a key")
            make = L.rollup_sets if kind == "rollup" else L.cube_sets
            q.group_sets = make(list(range(len(q.group_by))))
            return
        if self.at("grouping") and self._next_is("sets"):
            self.advance()
            self.advance()
            self.expect_op("(")
            q.group_by, q.group_sets = [], []
            while True:
                members = self._expr_list() if self.at_op("(") else \
                    [self.expr()]
                for m in members:
                    if m not in q.group_by:
                        q.group_by.append(m)
                q.group_sets.append(tuple(dict.fromkeys(
                    q.group_by.index(m) for m in members)))
                if not self.at_op(","):
                    break
                self.advance()
            self.expect_op(")")
            return
        self._unsupported_here()
        q.group_by = [self.expr()]
        while self.at_op(","):
            self.advance()
            q.group_by.append(self.expr())

    def _alias(self) -> Optional[str]:
        if self.at("as"):
            self.advance()
            return self.name()
        if self.tok.kind == "qid" or (self.tok.kind == "id" and
                                      self._word() not in _KEYWORDS):
            return self.name()
        return None

    def name(self) -> str:
        t = self.tok
        if t.kind == "qid":
            self.advance()
            return t.text[1:-1]
        if t.kind == "id" and self._word(t) not in _KEYWORDS:
            self.advance()
            return t.text
        self._fail("expected a name")

    def select_item(self):
        if self.at_op("*"):
            self.advance()
            return Star(), None
        e = self.expr()
        return e, self._alias()

    def table_ref(self):
        if self.at_op("("):
            q = self.subquery()
            if self.at("as"):
                self.advance()
            return SubqueryRef(q, self.name())
        name = self.name()
        if self.at_op("."):                       # db.table
            self.advance()
            name = self.name()
        return TableRef(name, self._alias())

    def join_tree(self):
        left = self.table_ref()
        while True:
            how = None
            if self.at("join"):
                how = "inner"
            elif self.at("inner"):
                self.advance()
                how = "inner"
            elif self.at("left", "right", "full", "cross"):
                how = self.advance().text.lower()
                if self.at("outer") and how != "cross":
                    self.advance()
                elif how == "left" and self.at("semi", "anti"):
                    how = self.advance().text.lower()
            else:
                self._unsupported_here()
                return left
            self.expect("join")
            right = self.table_ref()
            if how == "cross":
                left = JoinRef(left, right, how, None)
                continue
            if not self.at("on"):
                self._fail("expected ON")
            self.advance()
            left = JoinRef(left, right, how, self.expr())

    def order_item(self) -> OrderItem:
        e = self.expr()
        asc = True
        if self.at("asc", "desc"):
            asc = self.advance().text.lower() == "asc"
        nulls_first = None
        if self.at("nulls"):
            self.advance()
            if not self.at("first", "last"):
                self._fail("expected FIRST or LAST")
            nulls_first = self.advance().text.lower() == "first"
        return OrderItem(e, asc, nulls_first)

    # -- expressions (lowest precedence first) --------------------------------
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.at("or"):
            self.advance()
            e = BinOp("or", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.at("and"):
            self.advance()
            e = BinOp("and", e, self.not_expr())
        return e

    def not_expr(self):
        if self.at("not"):
            self.advance()
            return NotOp(self.not_expr())
        return self.predicate()

    def predicate(self):
        """A comparison, ``[NOT] BETWEEN``, ``[NOT] IN (list)``,
        ``[NOT] LIKE`` or ``IS [NOT] NULL`` over additive operands;
        ``EXISTS (query)``."""
        if self.at("exists"):
            self.advance()
            return Exists(self.subquery())
        e = self.additive()
        while True:
            self._unsupported_here()
            negated = False
            if self.at("not") and \
                    self._word(self.toks[self.i + 1]) in ("between", "in",
                                                          "like"):
                self.advance()
                negated = True
            if self.at("between"):
                self.advance()
                lo = self.additive()
                self.expect("and")
                e = Between(e, lo, self.additive(), negated)
            elif self.at("in"):
                self.advance()
                if self._word(self.toks[self.i + 1]) in ("select", "with"):
                    e = InSub(e, self.subquery(), negated)
                    continue
                self.expect_op("(")
                items = [self.expr()]
                while self.at_op(","):
                    self.advance()
                    items.append(self.expr())
                self.expect_op(")")
                e = InList(e, tuple(items), negated)
            elif self.at("like"):
                self.advance()
                t = self.tok
                if t.kind != "str":
                    self._fail("expected a string LIKE pattern")
                self.advance()
                escape = "\\"
                if self.tok.kind == "id" and self._word() == "escape":
                    self.advance()
                    esc = self.tok
                    if esc.kind != "str" or len(esc.text) != 3:
                        self._fail("expected one ESCAPE character")
                    escape = esc.text[1]
                    self.advance()
                e = LikeOp(e, t.text[1:-1].replace("''", "'"), negated,
                           escape)
            elif self.at("is"):
                self.advance()
                neg = self.at("not")
                if neg:
                    self.advance()
                self.expect("null")
                e = IsNullOp(e, neg)
            elif self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.advance().text
                e = BinOp("<>" if op == "!=" else op, e, self.additive())
            else:
                return e

    def additive(self):
        e = self.multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.advance().text
            e = BinOp(op, e, self.multiplicative())
        return e

    def multiplicative(self):
        e = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().text
            e = BinOp(op, e, self.unary())
        return e

    def unary(self):
        if self.at_op("-"):
            self.advance()
            return Neg(self.unary())
        if self.at_op("+"):
            self.advance()
            return self.unary()
        return self.primary()

    def case_expr(self) -> Case:
        self.expect("case")
        operand = None if self.at("when") else self.expr()
        whens = []
        while self.at("when"):
            self.advance()
            c = self.expr()
            self.expect("then")
            whens.append((c, self.expr()))
        if not whens:
            self._fail("expected WHEN")
        els = None
        if self.at("else"):
            self.advance()
            els = self.expr()
        self.expect("end")
        return Case(operand, tuple(whens), els)

    def primary(self):
        t = self.tok
        if self.at("null"):
            self.advance()
            return Lit(None)
        if self.at("case"):
            return self.case_expr()
        if self.at("cast") and self._next_is("("):
            return self.cast_expr()
        if self.at("interval"):
            return self.interval()
        if self.at("date") and self.toks[self.i + 1].kind == "str":
            self.advance()
            lit = self.advance()
            try:
                return Lit(datetime.date.fromisoformat(lit.text[1:-1]))
            except ValueError:
                raise SqlError(f"not a DATE literal: {lit.text} (at "
                               f"{lit.pos})") from None
        if self.at("grouping", "first", "last") and self._next_is("("):
            return self.call(self._word(self.advance()))
        if t.kind == "num":
            self.advance()
            txt = t.text
            return Lit(int(txt) if re.fullmatch(r"\d+", txt) else float(txt))
        if t.kind == "str":
            self.advance()
            return Lit(t.text[1:-1].replace("''", "'"))
        if self.at_op("("):
            if self._word(self.toks[self.i + 1]) in ("select", "with"):
                return ScalarSub(self.subquery())
            self.advance()
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "id" and self._word(t) in _KEYWORDS:
            self._fail("expected an expression")
        if t.kind not in ("id", "qid"):
            self._fail("expected an expression")
        name = self.name()
        if self.at_op("("):
            return self.call(name)
        if self.at_op("."):
            self.advance()
            if self.at_op("*"):
                self._fail("qualified * is not supported by the port")
            return Ident(self.name(), name)
        return Ident(name)

    def cast_expr(self) -> CastE:
        """``CAST(expr AS type[(p[, s])])``: the type name as written
        (``expr/cast.TYPE_NAMES`` decides when it lowers)."""
        self.advance()
        self.expect_op("(")
        e = self.expr()
        self.expect("as")
        t = self.tok
        if t.kind != "id":
            self._fail("expected a type name")
        self.advance()
        name = t.text.lower()
        if self.at_op("("):                     # decimal(p[, s])
            self.advance()
            args = []
            while not self.at_op(")") and self.tok.kind != "end":
                if not self.at_op(","):
                    args.append(self.tok.text)
                self.advance()
            self.expect_op(")")
            name += f"({','.join(args)})"
        self.expect_op(")")
        return CastE(e, name)

    def interval(self) -> Interval:
        """``INTERVAL n unit`` (``n`` a number or a quoted number)."""
        self.advance()
        t = self.tok
        text = t.text[1:-1] if t.kind == "str" else t.text
        if t.kind not in ("num", "str") or not re.fullmatch(r"-?\d+", text):
            self._fail("expected an integer INTERVAL")
        self.advance()
        if self.tok.kind != "id":
            self._fail("expected an INTERVAL unit")
        unit = self.advance().text.lower()
        return Interval(int(text), unit[:-1] if unit.endswith("s")
                        else unit)

    def subquery(self):
        """``(query)``: a SELECT or a set operation."""
        self.expect_op("(")
        if not (self.at("select", "with") or self.at_op("(")):
            self._fail("expected a query in parentheses")
        q = self.query_expr()
        self.expect_op(")")
        return q

    def call(self, name: str) -> Call:
        self.advance()                                  # (
        fname = name.lower()
        distinct = self.at("distinct")
        if distinct:
            self.advance()
        if self.at_op("*"):
            if distinct:
                self._fail(f"{fname}(DISTINCT *) is not valid")
            self.advance()
            self.expect_op(")")
            call = Call(fname, (), star=True)
        else:
            args = []
            if not self.at_op(")"):
                args.append(self.expr())
                while self.at_op(","):
                    self.advance()
                    args.append(self.expr())
            self.expect_op(")")
            call = Call(fname, tuple(args), distinct=distinct)
        return self.over_clause(call) if self.at("over") else call

    def over_clause(self, f: Call) -> WindowE:
        """``OVER ([PARTITION BY ...] [ORDER BY ...] [ROWS | RANGE BETWEEN
        bound AND bound])``."""
        self.advance()
        self.expect_op("(")
        partition, order, frame = [], [], None
        if self.at("partition"):
            self.advance()
            self.expect("by")
            partition.append(self.expr())
            while self.at_op(","):
                self.advance()
                partition.append(self.expr())
        if self.at("order"):
            self.advance()
            self.expect("by")
            while True:
                o = self.order_item()
                order.append((o.expr, o.ascending, o.nulls_first))
                if not self.at_op(","):
                    break
                self.advance()
        if self.at("rows", "range"):
            kind = self.advance().text.lower()
            self.expect("between")
            lo = self.frame_bound()
            self.expect("and")
            frame = (kind, lo, self.frame_bound())
        self.expect_op(")")
        return WindowE(f, tuple(partition), tuple(order), frame)

    def frame_bound(self) -> Optional[int]:
        """``UNBOUNDED PRECEDING | FOLLOWING`` (None), ``CURRENT ROW``
        (0), ``n PRECEDING`` (-n) or ``n FOLLOWING`` (n)."""
        if self.at("unbounded"):
            self.advance()
            if not self.at("preceding", "following"):
                self._fail("expected PRECEDING or FOLLOWING")
            self.advance()
            return None
        if self.at("current"):
            self.advance()
            self.expect("row")
            return 0
        if self.tok.kind != "num" or not self.tok.text.isdigit():
            self._fail("expected a frame bound")
        n = int(self.advance().text)
        if self.at("preceding"):
            self.advance()
            return -n
        self.expect("following")
        return n


def parse_sql(sql: str):
    return _Parser(sql).parse()


# -- lowering ----------------------------------------------------------------

def _sql_text(a) -> str:
    """A column name for an un-aliased select expression."""
    if isinstance(a, Ident):
        return a.name
    if isinstance(a, Res):
        return a.cname
    if isinstance(a, Lit):
        if isinstance(a.value, datetime.date):
            return f"DATE '{a.value.isoformat()}'"
        return "NULL" if a.value is None else repr(a.value)
    if isinstance(a, Call):
        inner = "*" if a.star else ", ".join(_sql_text(x) for x in a.args)
        return f"{a.name}({'DISTINCT ' if a.distinct else ''}{inner})"
    if isinstance(a, CastE):
        return f"CAST({_sql_text(a.child)} AS {a.typename.upper()})"
    if isinstance(a, Interval):
        return f"INTERVAL '{a.n}' {a.unit.upper()}"
    if isinstance(a, BinOp):
        return f"({_sql_text(a.left)} {a.op} {_sql_text(a.right)})"
    if isinstance(a, NotOp):
        return f"(NOT {_sql_text(a.child)})"
    if isinstance(a, Neg):
        return f"(- {_sql_text(a.child)})"
    if isinstance(a, Case):
        return "CASE"
    if isinstance(a, WindowE):
        return f"{_sql_text(a.func)} OVER (...)"
    return type(a).__name__.lower()


def _is_agg_call(a) -> bool:
    return isinstance(a, Call) and a.name in _AGGREGATES


def _has_agg(a) -> bool:
    return a is not None and any(_is_agg_call(n) for n in _walk(a))


def _agg_calls(a, out: List[Call]) -> None:
    for n in _walk(a):
        if _is_agg_call(n) and n not in out:
            out.append(n)


def _split(a, op: str) -> List[Any]:
    if isinstance(a, BinOp) and a.op == op:
        return _split(a.left, op) + _split(a.right, op)
    return [a]


def _and(parts: List[Any]):
    """The AND of ASTs; None for no part."""
    out = None
    for p in parts:
        out = p if out is None else BinOp("and", out, p)
    return out


def _factor_or(a):
    """``(A and P1) or (A and P2)`` as ``A and (P1 or P2)``, recursively:
    exact in three-valued logic (AND distributes over OR).  The
    reference's AST-level ``_factor_or``, run on a correlated subquery's
    WHERE before its conjuncts are split: q41 hides its correlation
    ``i_manufact = i1.i_manufact`` inside both arms of an OR."""
    if isinstance(a, BinOp) and a.op == "and":
        return BinOp("and", _factor_or(a.left), _factor_or(a.right))
    if not (isinstance(a, BinOp) and a.op == "or"):
        return a
    arms = [_split(_factor_or(d), "and") for d in _split(a, "or")]
    common = [c for c in arms[0] if all(c in arm for arm in arms[1:])]
    if not common:
        return a
    rests = []
    for arm in arms:
        rest = list(arm)
        for c in common:
            rest.remove(c)
        rests.append(_and(rest))
    if any(r is None for r in rests):
        return _and(common)                 # A or (A and P) is A
    disj = rests[0]
    for r in rests[1:]:
        disj = BinOp("or", disj, r)
    return _and(common + [disj])


#: a comparison with its sides swapped
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>"}


class _Scope:
    """Name resolution over a plan's columns: ``entries`` are (relation
    alias, {lower-case column name: the column's name in the plan}), so
    a qualified name picks its relation, and a column a self-join
    renamed (``__<alias>_<name>``) keeps its written name."""

    def __init__(self, entries):
        self.entries = entries

    @staticmethod
    def of(schema, alias: Optional[str] = None) -> "_Scope":
        return _Scope([(alias, {n.lower(): n for n in schema.names})])

    def resolve(self, a: Ident) -> str:
        col = a.name.lower()
        q = a.qualifier.lower() if a.qualifier is not None else None
        hits = [cols[col] for alias, cols in self.entries
                if col in cols and (q is None or alias == q)]
        if not hits:
            raise SqlError(f"column not found: "
                           f"{(a.qualifier + '.') if a.qualifier else ''}"
                           f"{a.name}")
        if len(hits) > 1:
            raise SqlError(f"ambiguous column: {a.name}")
        return hits[0]

    def canon(self, a):
        """``a`` with every identifier resolved to a column name."""
        return _transform(a, lambda n: Res(self.resolve(n))
                          if isinstance(n, Ident) else n)


def _literal_of(e: ec.Expression):
    if not isinstance(e, ec.Literal):
        raise SqlError("expected a literal argument")
    return e.value


def _check_comparable(left: ec.Expression, right: ec.Expression) -> None:
    """Two sides a comparison can take: one type, NULL, or numbers.  A
    DATE compares with a DATE alone (a DATE literal or CAST meets it;
    Spark's implicit cast of a string is not ported)."""
    lt, rt = left.dtype(), right.dtype()
    try:
        T.common_type(lt, rt)
    except ValueError:
        raise SqlError(f"a comparison of {lt} with {rt} is not supported "
                       f"by the port") from None


def _no_date_arithmetic(*args: ec.Expression) -> None:
    """Arithmetic of a DATE other than ``date ± days``."""
    if any(x.dtype() == T.DATE for x in args):
        raise SqlError("date arithmetic other than a DATE plus or minus "
                       "days is not supported by the port")


def _cast_type(name: str) -> T.DType:
    try:
        return ecast.type_of(name)
    except (KeyError, ValueError):
        raise SqlError(f"CAST to {name.upper()} is not supported by the "
                       f"port") from None


def _days_shift(op: str, left: ec.Expression, right: ec.Expression):
    """``date + n``, ``n + date`` and ``date - n`` for an integer ``n``
    (Spark's ``date_add`` / ``date_sub``); None for any other operands."""
    lt, rt = left.dtype(), right.dtype()
    if lt == T.DATE and rt.is_integral and op in ("+", "-"):
        return (edt.DateAdd if op == "+" else edt.DateSub)(left, right)
    if rt == T.DATE and lt.is_integral and op == "+":
        return edt.DateAdd(right, left)
    return None


def _comparison(op: str, left: ec.Expression, right: ec.Expression):
    _check_comparable(left, right)
    if op == "<>":
        return ep.Not(ep.EqualTo(left, right))
    return _COMPARISONS[op](left, right)


class _Lowerer:
    def __init__(self, views: Dict[str, L.LogicalPlan], session=None):
        self.views = views
        self.session = session
        self._uid = 0
        #: each uncorrelated scalar query's value, once it has run
        self._scalars: Dict[ScalarSub, ec.Literal] = {}

    def fresh(self, prefix: str) -> str:
        self._uid += 1
        return f"__{prefix}{self._uid}"

    def run(self, plan: L.LogicalPlan):
        """A subquery's rows, run now on the session's device through the
        optimizer ``sql_to_plan`` uses."""
        if self.session is None:
            raise SqlError("a subquery runs on a session's device: lower "
                           "the query through session.sql")
        return self.session.execute_to_arrow(optimize(plan))

    # -- FROM ----------------------------------------------------------------
    def relation(self, ref):
        """(plan, scope) of one FROM item: a view (or a CTE in scope), a
        derived table under its alias, or a join of two of them."""
        if isinstance(ref, TableRef):
            plan = self.views.get(ref.name.lower())
            if plan is None:
                raise SqlError(f"table or view not found: {ref.name}")
            return plan, _Scope.of(plan.schema,
                                   (ref.alias or ref.name).lower())
        if isinstance(ref, SubqueryRef):
            plan = self.query(ref.query)
            return plan, _Scope.of(plan.schema, ref.alias.lower())
        lplan, lscope = self.relation(ref.left)
        rplan, rscope = self.relation(ref.right)
        rplan, scope = self.combine(lplan, lscope, rplan, rscope)
        if ref.how == "cross":
            return L.Join(lplan, rplan, "cross", [], []), scope
        from ..plan.logical_opt import _and_all, _conjuncts
        from .dataframe import _extract_equi_keys
        both = L.Join(lplan, rplan, "cross", [], []).schema
        # the equalities inside every arm of an OR become join keys; a
        # join without one is a nested-loop join on its condition
        cond = _and_all(_conjuncts(self.expr(scope.canon(ref.on), both)))
        lkeys, rkeys, residual = _extract_equi_keys(cond, lplan.schema,
                                                    rplan.schema)
        join = L.Join(lplan, rplan, ref.how, lkeys, rkeys, residual)
        # a semi or anti join's output is its left side's
        return join, lscope if ref.how in ("semi", "anti") else scope

    def from_clause(self, from_: List[Any]):
        """(plan, scope) of a FROM list: a left-deep join tree, comma
        relations as cross joins."""
        plan, scope = self.relation(from_[0])
        for ref in from_[1:]:
            rplan, rscope = self.relation(ref)
            rplan, scope = self.combine(plan, scope, rplan, rscope)
            plan = L.Join(plan, rplan, "cross", [], [])
        return plan, scope

    @staticmethod
    def combine(lplan, lscope: _Scope, rplan, rscope: _Scope):
        """(right plan, joined scope): a right column whose name the left
        side already has is renamed ``__<alias>_<name>`` by a projection,
        so the joined columns' names stay distinct (self-joins)."""
        taken = set(lplan.schema.names)
        renames = {}
        for alias, cols in rscope.entries:
            for actual in cols.values():
                if actual in taken:
                    new = f"__{alias or 'r'}_{actual}"
                    while new in taken:
                        new += "_"
                    renames[actual] = new
                taken.add(renames.get(actual, actual))
        if renames:
            schema = rplan.schema
            rplan = L.Project(
                [ec.Alias(ec.AttributeReference(f.name).resolve(schema),
                          renames[f.name]) if f.name in renames else
                 ec.AttributeReference(f.name).resolve(schema)
                 for f in schema], rplan)
            rscope = _Scope([(alias, {k: renames.get(v, v)
                                      for k, v in cols.items()})
                             for alias, cols in rscope.entries])
        return rplan, _Scope(lscope.entries + rscope.entries)

    # -- expressions ---------------------------------------------------------
    def expr(self, a, schema) -> ec.Expression:
        """An expression over ``schema`` from an AST whose identifiers are
        resolved (``Res``)."""
        if isinstance(a, Lit):
            return ec.Literal(a.value)
        if isinstance(a, Res):
            if a.cname not in schema.names:
                raise SqlError(f"column not found: {a.cname}")
            return ec.AttributeReference(a.cname).resolve(schema)
        if isinstance(a, Ident):
            raise SqlError(f"column not found: {a.name}")
        if isinstance(a, Neg):
            child = self.expr(a.child, schema)
            if isinstance(child, ec.Literal) and \
                    isinstance(child.value, (int, float)) and \
                    not isinstance(child.value, bool):
                return ec.Literal(-child.value)
            _no_date_arithmetic(child)
            return ea.UnaryMinus(child)
        if isinstance(a, NotOp):
            return ep.Not(self.expr(a.child, schema))
        if isinstance(a, Between):
            e = self.expr(a.child, schema)
            cond = ep.And(_comparison(">=", e, self.expr(a.lo, schema)),
                          _comparison("<=", e, self.expr(a.hi, schema)))
            return ep.Not(cond) if a.negated else cond
        if isinstance(a, InList):
            e = self.expr(a.child, schema)
            items = [self.expr(i, schema) for i in a.items]
            for i in items:
                _check_comparable(e, i)
            if all(isinstance(i, ec.Literal) for i in items):
                out = ep.In(e, [i.value for i in items])
            else:
                out = ep.EqualTo(e, items[0])
                for i in items[1:]:
                    out = ep.Or(out, ep.EqualTo(e, i))
            return ep.Not(out) if a.negated else out
        if isinstance(a, LikeOp):
            try:
                out = es.Like(self.expr(a.child, schema),
                              ec.Literal(a.pattern), a.escape)
            except (NotImplementedError, ValueError) as err:
                raise SqlError(str(err)) from None
            return ep.Not(out) if a.negated else out
        if isinstance(a, IsNullOp):
            return (ep.IsNotNull if a.negated else ep.IsNull)(
                self.expr(a.child, schema))
        if isinstance(a, Case):
            if a.operand is not None:
                op = self.expr(a.operand, schema)
                branches = [(_comparison("=", op, self.expr(c, schema)),
                             self.expr(v, schema)) for c, v in a.whens]
            else:
                branches = [(self.expr(c, schema), self.expr(v, schema))
                            for c, v in a.whens]
            els = self.expr(a.els, schema) if a.els is not None else None
            out = econd.CaseWhen(branches, els)
            try:
                out.dtype()             # values of no common type raise
            except ValueError as err:
                raise SqlError(str(err)) from None
            return out
        if isinstance(a, CastE):
            out = ecast.Cast(self.expr(a.child, schema),
                             _cast_type(a.typename))
            try:
                out.dtype()             # a cast the port lacks raises
                return out
            except NotImplementedError as err:
                raise SqlError(str(err)) from None
        if isinstance(a, Interval):
            raise SqlError("INTERVAL is supported only beside + or - of a "
                           "DATE")
        if isinstance(a, BinOp):
            if a.op == "||":
                parts = [self.expr(p, schema) for p in _split(a, "||")]
                return es.ConcatStrings(*parts)
            if a.op in ("+", "-") and (isinstance(a.right, Interval) or (
                    a.op == "+" and isinstance(a.left, Interval))):
                return self.date_shift(a, schema)
            left = self.expr(a.left, schema)
            right = self.expr(a.right, schema)
            if a.op == "and":
                return ep.And(left, right)
            if a.op == "or":
                return ep.Or(left, right)
            if a.op in _FLIP:
                return _comparison(a.op, left, right)
            if a.op in _ARITHMETIC:
                shifted = _days_shift(a.op, left, right)
                if shifted is not None:
                    return shifted
                _no_date_arithmetic(left, right)
                return _ARITHMETIC[a.op](left, right)
            raise SqlError(f"operator {a.op!r} is not supported by the port")
        if isinstance(a, Call):
            if a.name in _AGGREGATES:
                raise SqlError(f"aggregate {a.name}() is not allowed here")
            if a.name in _WINDOW_FUNCTIONS:
                raise SqlError(f"{a.name}() needs an OVER clause")
            return self.function(a, schema)
        if isinstance(a, WindowE):
            raise SqlError("window functions are only allowed in SELECT and "
                           "ORDER BY")
        if isinstance(a, Star):
            raise SqlError("* is only allowed as a select item or count(*)")
        if isinstance(a, ScalarSub):
            if a not in self._scalars:
                self._scalars[a] = self.scalar_value(
                    self._uncorrelated(a.query, "a scalar query"))
            return self._scalars[a]
        if isinstance(a, InSub):
            return self.in_values(a, schema)
        if isinstance(a, Exists):
            raise SqlError("EXISTS is supported only as a conjunct of "
                           "WHERE")
        raise SqlError(f"unsupported expression {a!r}")

    def date_shift(self, a: BinOp, schema) -> ec.Expression:
        """``date ± INTERVAL n DAY[S]`` and ``INTERVAL n DAY[S] + date``
        (the reference's ``lower_bin``)."""
        iv, base = (a.right, a.left) if isinstance(a.right, Interval) \
            else (a.left, a.right)
        if iv.unit != "day":
            raise SqlError(f"INTERVAL of unit {iv.unit!r} is not supported "
                           f"by the port (days only)")
        e = self.expr(base, schema)
        if e.dtype() != T.DATE:
            raise SqlError(f"INTERVAL beside a {e.dtype()}: only a DATE "
                           f"takes days")
        return (edt.DateAdd if a.op == "+" else edt.DateSub)(
            e, ec.Literal(iv.n))

    # -- expression subqueries -----------------------------------------------
    def _uncorrelated(self, q, what: str) -> L.LogicalPlan:
        try:
            return self.query(q)
        except SqlError as err:
            raise SqlError(f"{what} inside an expression must be "
                           f"uncorrelated (the port decorrelates only a "
                           f"conjunct of WHERE): {err}") from None

    def scalar_value(self, plan: L.LogicalPlan) -> ec.Literal:
        """An uncorrelated scalar query's value: NULL of its type for no
        row, ``SqlError`` for more than one."""
        if len(plan.schema) != 1:
            raise SqlError("a scalar query must select one column")
        t = self.run(L.Limit(2, plan))
        if t.num_rows > 1:
            raise SqlError("a scalar query returned more than one row")
        value = t.column(0)[0].as_py() if t.num_rows else None
        return ec.Literal(value, plan.schema.fields[0].dtype)

    def in_values(self, a: InSub, schema) -> ec.Expression:
        """``x [NOT] IN (query)`` inside an expression (q45's ``... or
        i_item_id in (select ...)``): the query runs now, to an IN list,
        in three-valued logic (a NULL in the set makes NOT IN NULL or
        false, never true)."""
        sub = self._uncorrelated(a.query, "IN (query)")
        if len(sub.schema) != 1:
            raise SqlError("IN (query) must select one column")
        values = self.run(sub).column(0).to_pylist()
        has_null = None in values
        values = list(dict.fromkeys(v for v in values if v is not None))
        if not values and not has_null:        # the empty set
            return ec.Literal(a.negated, T.BOOL)
        out = ep.In(self.expr(a.child, schema), values)
        if not a.negated:
            return out
        if has_null:
            return econd.CaseWhen([(out, ec.Literal(False, T.BOOL))],
                                  ec.Literal(None, T.BOOL))
        return ep.Not(out)

    def where(self, where, plan: L.LogicalPlan,
              scope: _Scope) -> L.LogicalPlan:
        """WHERE over ``plan``, conjunct by conjunct: ``[NOT] IN (query)``
        is a semi or anti join, ``[NOT] EXISTS`` a constant (uncorrelated)
        or a semi or anti join (correlated), an OR of correlated EXISTS
        one semi join against the union of their key sets, and ``x CMP
        (query)`` a literal (uncorrelated) or a join with the query's
        groups (correlated); the other conjuncts are one filter above
        those joins."""
        rest = []
        for c in _split(where, "and"):
            if isinstance(c, NotOp) and isinstance(c.child, (InSub, Exists)):
                c = dataclasses.replace(c.child, negated=not c.child.negated)
            arms = _split(c, "or")
            if isinstance(c, InSub):
                plan = self.in_join(c, plan)
            elif isinstance(c, Exists):
                plan = self.exists(c, plan, scope)
            elif len(arms) > 1 and all(isinstance(d, Exists) and
                                       not d.negated for d in arms):
                plan = self.exists_or(arms, plan, scope)
            elif isinstance(c, BinOp) and c.op in _FLIP and \
                    isinstance(c.left, ScalarSub) != \
                    isinstance(c.right, ScalarSub):
                sub = c.right if isinstance(c.right, ScalarSub) else c.left
                try:
                    sub_plan = self.query(sub.query)
                except SqlError as err:
                    plan = self.scalar_cmp(c, plan, scope, err)
                    continue
                self._scalars[sub] = self.scalar_value(sub_plan)
                rest.append(c)
            else:
                rest.append(c)
        if rest:
            plan = L.Filter(self.expr(_and(rest), plan.schema), plan)
        return plan

    def in_join(self, c: InSub, plan: L.LogicalPlan) -> L.LogicalPlan:
        """``x IN (query)`` as a semi join; ``x NOT IN (query)`` as an
        anti join in three-valued logic: an empty set keeps every row, a
        NULL in the set keeps none, a NULL ``x`` never matches."""
        sub = self.query(c.query)
        if len(sub.schema) != 1:
            raise SqlError("IN (query) must select one column")
        f = sub.schema.fields[0]
        name = self.fresh("in")
        sub = L.Project([ec.Alias(ec.AttributeReference(f.name).resolve(
            sub.schema), name)], sub)
        lkey = self.expr(c.child, plan.schema)
        rkey = ec.AttributeReference(name, f.dtype, f.nullable)
        if not c.negated:
            return L.Join(plan, sub, "semi", [lkey], [rkey])
        if self.run(L.Limit(1, sub)).num_rows == 0:
            return plan
        if f.nullable and self.run(L.Limit(1, L.Filter(
                ep.IsNull(rkey), sub))).num_rows:
            return L.Filter(ec.Literal(False, T.BOOL), plan)
        if lkey.nullable:
            plan = L.Filter(ep.IsNotNull(lkey), plan)
        return L.Join(plan, sub, "anti", [lkey], [rkey])

    def exists(self, c: Exists, plan: L.LogicalPlan,
               scope: _Scope) -> L.LogicalPlan:
        """An uncorrelated ``[NOT] EXISTS`` runs now, to a constant; a
        correlated one is a semi or anti join (``exists_parts``)."""
        try:
            sub = self.query(c.query)
        except SqlError:
            okeys, inner, ikeys, cond = self.exists_parts(c, plan, scope)
            return L.Join(plan, inner, "anti" if c.negated else "semi",
                          okeys, ikeys, cond)
        if (self.run(L.Limit(1, sub)).num_rows > 0) == c.negated:
            return L.Filter(ec.Literal(False, T.BOOL), plan)
        return plan

    @staticmethod
    def _correlation(cj, inner: _Scope, outer: _Scope):
        """(inner side, outer side) of an equality between a column of
        the inner query and one of the outer query; None otherwise."""
        if isinstance(cj, BinOp) and cj.op == "=":
            for a, b in ((cj.left, cj.right), (cj.right, cj.left)):
                try:
                    inner.canon(a)
                    outer.canon(b)
                except SqlError:
                    continue
                return a, b
        return None

    def exists_parts(self, c: Exists, plan: L.LogicalPlan, scope: _Scope):
        """A correlated EXISTS as (outer keys, inner plan, inner keys,
        residual condition).  Its WHERE conjuncts over the inner query
        alone filter the inner side, its equalities between the two
        queries are the join keys (projected under fresh ``__ck`` names),
        and any other conjunct is the join's residual condition, with the
        inner columns it reads projected under fresh ``__rc`` names
        (q16's ``cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk``)."""
        q = c.query
        if not isinstance(q, Select) or q.group_by or \
                q.having is not None or q.ctes or q.distinct:
            raise SqlError("a correlated EXISTS with GROUP BY, HAVING, "
                           "WITH, DISTINCT or a set operation is not "
                           "supported by the port")
        inner, iscope = self.from_clause(q.from_)
        local, residual, okeys, ikeys = [], [], [], []
        for cj in _split(_factor_or(q.where), "and") \
                if q.where is not None else []:
            try:
                local.append(iscope.canon(cj))
                continue
            except SqlError:
                pass
            pair = self._correlation(cj, iscope, scope)
            if pair is None:
                residual.append(cj)
                continue
            ikeys.append(self.expr(iscope.canon(pair[0]), inner.schema))
            okeys.append(self.expr(scope.canon(pair[1]), plan.schema))
        if not ikeys:
            raise SqlError("a correlated EXISTS needs an equality between "
                           "the inner and the outer query")
        if local:
            inner = L.Filter(self.expr(_and(local), inner.schema), inner)
        names = [self.fresh("ck") for _ in ikeys]
        proj = [ec.Alias(k, n) for k, n in zip(ikeys, names)]
        extra: Dict[str, str] = {}          # inner column -> projected

        def inner_col(n):
            if not isinstance(n, Ident):
                return n
            try:
                col = iscope.resolve(n)
            except SqlError:
                return n
            if col not in extra:
                extra[col] = self.fresh("rc")
            return Res(extra[col])
        asts = [scope.canon(_transform(r, inner_col)) for r in residual]
        proj += [ec.Alias(ec.AttributeReference(col).resolve(inner.schema),
                          n) for col, n in extra.items()]
        inner = L.Project(proj, inner)
        cond = None
        if asts:
            both = L.Join(plan, inner, "cross", [], []).schema
            cond = self.expr(_and(asts), both)
        refs = [ec.AttributeReference(n).resolve(inner.schema)
                for n in names]
        return okeys, inner, refs, cond

    def exists_or(self, arms, plan: L.LogicalPlan,
                  scope: _Scope) -> L.LogicalPlan:
        """``EXISTS (q1) OR EXISTS (q2) ...`` whose arms correlate on the
        same outer keys: one semi join against the union of the arms' key
        sets (q10's web-or-catalog customers)."""
        parts = [self.exists_parts(d, plan, scope) for d in arms]
        if any(p[3] is not None for p in parts):
            raise SqlError("an OR of EXISTS with a residual condition is "
                           "not supported by the port")
        keys = [repr(k) for k in parts[0][0]]
        if any([repr(k) for k in p[0]] != keys for p in parts[1:]):
            raise SqlError("an OR of EXISTS needs the same correlation "
                           "keys in every arm")
        try:
            union = L.Union([p[1] for p in parts])
        except ValueError as err:
            raise SqlError(str(err)) from None
        return L.Join(plan, union, "semi", parts[0][0], parts[0][2])

    def scalar_cmp(self, c: BinOp, plan: L.LogicalPlan, scope: _Scope,
                   err: SqlError) -> L.LogicalPlan:
        """``x CMP (correlated query of one aggregate)`` (q1's
        ``ctr_total_return > (select avg(ctr_total_return) * 1.2 ...
        where ctr1.ctr_store_sk = ctr2.ctr_store_sk)``): the query grouped
        by its correlation keys, joined to the outer rows on them, the
        comparison a filter, and a projection back to the outer columns.
        An outer row without a group compares with NULL and drops, so the
        join is an inner one."""
        right = isinstance(c.right, ScalarSub)
        sub, outer = (c.right, c.left) if right else (c.left, c.right)
        op = c.op if right else _FLIP[c.op]
        q = sub.query
        if not isinstance(q, Select) or q.group_by or \
                q.having is not None or q.ctes or q.distinct or \
                len(q.items) != 1 or isinstance(q.items[0][0], Star) or \
                not _has_agg(q.items[0][0]):
            raise SqlError(f"a correlated scalar query must select one "
                           f"aggregate expression ({err})")
        _, iscope = self.from_clause(q.from_)
        local, ikeys, okeys = [], [], []
        for cj in _split(_factor_or(q.where), "and") \
                if q.where is not None else []:
            try:
                iscope.canon(cj)
                local.append(cj)
                continue
            except SqlError:
                pass
            pair = self._correlation(cj, iscope, scope)
            if pair is None:
                raise SqlError(f"a correlated scalar query's conditions must "
                               f"be equalities between the inner and the "
                               f"outer query, or conditions of the inner "
                               f"query alone ({err})")
            ikeys.append(pair[0])
            okeys.append(self.expr(scope.canon(pair[1]), plan.schema))
        if not ikeys:
            raise SqlError(str(err))
        names = [self.fresh("ck") for _ in ikeys]
        value = self.fresh("sv")
        grouped = self.select(dataclasses.replace(
            q, items=list(zip(ikeys, names)) + [(q.items[0][0], value)],
            where=_and(local), group_by=list(ikeys), order_by=[],
            limit=None))
        refs = [ec.AttributeReference(n).resolve(grouped.schema)
                for n in names]
        joined = L.Join(plan, grouped, "inner", okeys, refs)
        cond = _comparison(op, self.expr(outer, plan.schema),
                           ec.AttributeReference(value).resolve(
                               grouped.schema))
        # the helper columns do not leak into * or the select list
        return L.Project([ec.AttributeReference(f.name).resolve(plan.schema)
                          for f in plan.schema], L.Filter(cond, joined))

    def function(self, a: Call, schema) -> ec.Expression:
        args = [self.expr(x, schema) for x in a.args]
        n = a.name
        try:
            if n in ("substring", "substr") and len(args) in (2, 3):
                return es.Substring(args[0], *[
                    ec.Literal(_literal_of(x)) for x in args[1:]])
            if n == "concat" and args:
                return es.ConcatStrings(*args)
            if n in ("upper", "ucase", "lower", "lcase") and \
                    len(args) == 1 and args[0].dtype() == T.STRING:
                return (es.Upper if n in ("upper", "ucase") else
                        es.Lower)(args[0])
            out = self.strings(n, args)
            if out is not None:
                return out
            if n == "abs" and len(args) == 1:
                dt = args[0].dtype()
                if not dt.is_numeric:
                    raise SqlError(f"abs() of a {dt} is not supported by the "
                                   f"port")
                return ea.Abs(args[0])
            if n == "round" and len(args) in (1, 2):
                scale = _literal_of(args[1]) if len(args) == 2 else 0
                dt = args[0].dtype()
                if not isinstance(scale, int) or isinstance(scale, bool) or \
                        not dt.is_numeric:
                    raise SqlError("round() takes a number and an integer "
                                   "scale")
                return ea.Round(args[0], scale)
            if n in ("coalesce", "nvl", "ifnull") and args:
                out = econd.Coalesce(*args)
                out.dtype()             # arguments of no common type raise
                return out
            out = self.library(n, args)
            if out is not None:
                out.dtype()             # arguments of no common type raise
                return out
            if n in _DATE_FIELDS and len(args) == 1:
                out = _DATE_FIELDS[n](args[0])
            elif n in ("date_add", "date_sub") and len(args) == 2:
                out = (edt.DateAdd if n == "date_add" else edt.DateSub)(
                    *args)
            elif n == "datediff" and len(args) == 2:
                out = edt.DateDiff(*args)
            if out is not None:
                out.dtype()             # an argument of another type raises
                return out
        except (NotImplementedError, ValueError) as err:
            raise SqlError(str(err)) from None
        if n == "grouping":
            raise SqlError("grouping() takes one key of GROUP BY ROLLUP, "
                           "CUBE or GROUPING SETS")
        raise SqlError(f"function {n}() is not supported by the port")

    @staticmethod
    def strings(n: str, args: List[ec.Expression]
                ) -> Optional[ec.Expression]:
        """The string functions of the reference's function table, with
        ``md5``, ``rand`` and ``to_date``, or None for another name or
        arity.  A string argument of another type is cast to STRING, as
        Spark's implicit cast does."""
        def text(e):
            dt = e.dtype()
            return e if dt in (T.STRING, T.NULL) else ecast.Cast(e, T.STRING)
        k = len(args)
        one = {"length": es.Length, "char_length": es.Length,
               "character_length": es.Length, "trim": es.StringTrim,
               "ltrim": es.StringTrimLeft, "rtrim": es.StringTrimRight,
               "reverse": es.Reverse, "initcap": es.InitCap,
               "md5": emisc.Md5, "to_date": edt.ToDate}
        if n in one and k == 1:
            return one[n](args[0] if n == "to_date" else text(args[0]))
        if n == "instr" and k == 2:
            return es.StringLocate(args[1], text(args[0]))
        if n == "locate" and k in (2, 3):
            return es.StringLocate(args[0], text(args[1]), *args[2:])
        if n == "concat_ws" and k >= 1:
            return es.ConcatWs(args[0], *[text(a) for a in args[1:]])
        if n == "replace" and k in (2, 3):
            return es.Replace(text(args[0]), *args[1:])
        if n == "repeat" and k == 2:
            return es.StringRepeat(text(args[0]), args[1])
        if n in ("lpad", "rpad") and k in (2, 3):
            return (es.Lpad if n == "lpad" else es.Rpad)(text(args[0]),
                                                         *args[1:])
        if n == "rand" and k <= 1:
            return emisc.Rand(_literal_of(args[0]) if args else 0)
        return None

    @staticmethod
    def library(n: str, args: List[ec.Expression]) -> Optional[ec.Expression]:
        """The numeric, conditional and null functions of the reference's
        function table (``spark_rapids_tpu/api/sql.py``'s ``lower_func``),
        or None for another name or arity: the math functions of numbers,
        ``mod`` / ``pmod``, ``greatest`` / ``least`` of numbers or DATEs,
        ``nullif``, ``if``, ``isnull`` / ``isnotnull``, ``isnan``,
        ``nanvl`` and ``hash``."""
        def numbers(k):
            if len(args) != k or not all(
                    a.dtype().is_numeric or a.dtype() == T.NULL
                    for a in args):
                raise SqlError(f"{n}() takes {k} number"
                               f"{'s' if k > 1 else ''}")
        if n in _MATH:
            numbers(1)
            return _MATH[n](args[0])
        if n in _MATH2:
            numbers(2)
            return _MATH2[n](*args)
        if n in ("greatest", "least") and len(args) >= 2:
            return (ea.Greatest if n == "greatest" else ea.Least)(*args)
        if n == "nullif" and len(args) == 2:
            return econd.If(_comparison("=", args[0], args[1]),
                            ec.Literal(None, args[0].dtype()), args[0])
        if n == "if" and len(args) == 3:
            return econd.If(*args)
        if n in ("isnull", "isnotnull") and len(args) == 1:
            return (ep.IsNull if n == "isnull" else ep.IsNotNull)(args[0])
        if n == "isnan" and len(args) == 1:
            return ep.IsNaN(args[0])
        if n == "nanvl":
            numbers(2)
            return econd.NaNvl(*args)
        if n == "hash" and args:
            return emisc.Murmur3Hash(*args)
        return None

    def agg_func(self, a: Call, schema, window: bool = False
                 ) -> eagg.AggregateFunction:
        """The aggregate of a call (``window``: over a window, where
        ``min`` runs too)."""
        if a.star:
            if a.name != "count":
                raise SqlError(f"{a.name}(*) is not supported")
            return eagg.Count()
        if len(a.args) != 1:
            raise SqlError(f"{a.name}() takes one argument")
        if a.distinct and (window or a.name not in _DISTINCT_AGGREGATES):
            raise SqlError(f"{a.name}(DISTINCT ...)"
                           f"{' over a window' if window else ''} is not "
                           f"supported by the port")
        if _has_agg(a.args[0]):
            raise SqlError("nested aggregates are not allowed")
        arg = self.expr(a.args[0], schema)
        dt = arg.dtype()
        # check_window_func refuses the types a window does not take
        any_type = ("count", "max", "min", "first", "first_value", "last",
                    "last_value")
        if a.name not in any_type and dt == T.STRING:
            # Spark's implicit cast to double: NULL for a word that is no
            # number (the reference's engine adds the string's bytes)
            arg, dt = ecast.Cast(arg, T.FLOAT64), T.FLOAT64
        if a.name not in any_type and not dt.is_numeric and dt != T.NULL:
            raise SqlError(f"{a.name}() of a {dt} column is not supported "
                           f"by the port")
        return (_WINDOW_AGGREGATES if window else _AGGREGATES)[a.name](arg)

    def window(self, w: WindowE, alias: str, schema) -> L.WindowFunc:
        """The reference's ``lower_window``: the function, PARTITION BY,
        ORDER BY and frame, SQL's default frame being ``RANGE BETWEEN
        UNBOUNDED PRECEDING AND CURRENT ROW`` with ORDER BY and the whole
        partition without.  ``lead`` / ``lag`` with a default other than
        NULL raise: the reference ignores the default and answers NULL at
        the partition's edge, where Spark answers the default."""
        f, n = w.func, w.func.name
        if n in _WINDOW_FUNCTIONS:
            least, most = _WINDOW_FUNCTIONS[n]
            if f.star or not least <= len(f.args) <= most:
                raise SqlError(f"{n}() takes {least} to {most} arguments")
            args = [self.expr(x, schema) for x in f.args]
            if n in ("lead", "lag"):
                offset = _literal_of(args[1]) if len(args) > 1 else 1
                if len(args) > 2 and _literal_of(args[2]) is not None:
                    raise SqlError(f"{n}() with a default value is not "
                                   f"supported by the port")
                if not isinstance(offset, int) or isinstance(offset, bool):
                    raise SqlError(f"{n}() takes an integer offset")
                func = (ewin.Lead if n == "lead" else ewin.Lag)(args[0],
                                                               offset)
            elif n == "ntile":
                try:
                    func = ewin.NTile(_literal_of(args[0]))
                except ValueError as err:
                    raise SqlError(str(err)) from None
            else:
                func = {"row_number": ewin.RowNumber, "rank": ewin.Rank,
                        "dense_rank": ewin.DenseRank,
                        "percent_rank": ewin.PercentRank,
                        "cume_dist": ewin.CumeDist}[n]()
        elif n in _WINDOW_AGGREGATES:
            func = self.agg_func(f, schema, window=True)
        else:
            raise SqlError(f"{n}() over a window is not supported by the "
                           f"port")
        pb = [self.expr(p, schema) for p in w.partition]
        ob = [L.SortOrder(self.expr(e, schema), asc, nf)
              for e, asc, nf in w.order]
        frame = w.frame or (("range", None, 0) if ob else
                            ("rows", None, None))
        wf = L.WindowFunc(func, L.WindowSpec(pb, ob, frame), alias)
        try:
            check_window_func(wf)
        except NotImplementedError as err:
            raise SqlError(str(err)) from None
        return wf

    # -- SELECT --------------------------------------------------------------
    def select(self, q: Select) -> L.LogicalPlan:
        """The plan of one query.  Its CTEs are views of a copy of the
        view map, lowered in order (a later CTE sees an earlier one), and
        the copy is dropped when the query is lowered.  A CTE read twice
        is one plan under two aliases: ``combine`` renames the second
        copy's colliding columns, and no optimizer rule changes a node in
        place."""
        views = self.views
        if q.ctes:
            self.views = dict(views)
            for name, sub in q.ctes:
                self.views[name.lower()] = self.query(sub)
        try:
            return self._select_body(q)
        finally:
            self.views = views

    # -- set operations ------------------------------------------------------
    def query(self, q) -> L.LogicalPlan:
        """The plan of a SELECT or a set operation."""
        return self.setop(q) if isinstance(q, SetOp) else self.select(q)

    def setop(self, s: SetOp) -> L.LogicalPlan:
        """A set operation, with the reference's semantics
        (``lower_setop``) where Spark agrees: ``UNION ALL`` is a Union
        under the left side's names (its columns widened to the wider
        type, as Spark widens them), ``UNION`` a Distinct of it, and
        ``INTERSECT`` / ``EXCEPT`` a Distinct of a semi / anti join on
        null-safe keys (``_null_safe_keys``).  A WITH on the leftmost
        SELECT is in scope for the whole operation.  ``INTERSECT ALL``
        and ``EXCEPT ALL`` raise: the reference answers them as the
        distinct forms, which is not Spark's answer."""
        if s.all and s.op != "union":
            raise SqlError(f"{s.op.upper()} ALL is not supported by the "
                           f"port")
        leftmost = s.left
        while isinstance(leftmost, SetOp):
            leftmost = leftmost.left
        if leftmost.ctes:
            views = self.views
            self.views = dict(views)
            for name, sub in leftmost.ctes:
                self.views[name.lower()] = self.query(sub)
            try:
                return self.setop(_strip_leftmost_ctes(s))
            finally:
                self.views = views
        left, right = self.query(s.left), self.query(s.right)
        if len(left.schema) != len(right.schema):
            raise SqlError(f"the two sides of {s.op.upper()} select "
                           f"{len(left.schema)} and {len(right.schema)} "
                           f"columns")
        try:
            if s.op == "union":
                names = left.schema.names
                if right.schema.names != names:
                    right = L.Project([ec.Alias(ec.AttributeReference(
                        f.name).resolve(right.schema), n)
                        for f, n in zip(right.schema, names)], right)
                plan = L.Union([left, right])
                if not s.all:
                    plan = L.Distinct(plan)
            else:
                lkeys, rkeys = _null_safe_keys(left.schema, right.schema)
                plan = L.Distinct(L.Join(
                    left, right, "semi" if s.op == "intersect" else "anti",
                    lkeys, rkeys))
        except ValueError as err:
            raise SqlError(f"{s.op.upper()}: {err}") from None
        return self.order_and_limit(plan, s.order_by, s.limit)

    def order_and_limit(self, plan: L.LogicalPlan, order_by, limit):
        """A set operation's ORDER BY (output columns, by name or
        ordinal) and LIMIT over its rows."""
        if order_by:
            schema = plan.schema
            scope = _Scope.of(schema)
            orders = []
            for o in order_by:
                a = o.expr
                if isinstance(a, Lit) and isinstance(a.value, int):
                    if not 1 <= a.value <= len(schema):
                        raise SqlError(f"ORDER BY position {a.value} is not "
                                       f"in the select list")
                    a = Res(schema.names[a.value - 1])
                orders.append(L.SortOrder(self.expr(scope.canon(a), schema),
                                          o.ascending, o.nulls_first))
            plan = L.Sort(orders, plan)
        return L.Limit(limit, plan) if limit is not None else plan

    def _select_body(self, q: Select) -> L.LogicalPlan:
        # 1. FROM: a left-deep join tree, comma relations as cross joins
        plan, scope = self.from_clause(q.from_)
        # 2. select items with their display names; * expands in order
        items, names = [], []
        for a, alias in q.items:
            if isinstance(a, Star):
                for _, cols in scope.entries:
                    for low, actual in cols.items():
                        items.append(Res(actual))
                        # a renamed self-join column shows its own name
                        names.append(actual if actual.lower() == low
                                     else low)
                continue
            items.append(scope.canon(a))
            names.append(alias or _sql_text(a))
        seen: Dict[str, int] = {}
        for i, d in enumerate(names):
            if d in seen:
                seen[d] += 1
                names[i] = f"{d}_{seen[d]}"
            else:
                seen[d] = 0
        by_name = {d.lower(): it for d, it in zip(names, items)}
        # 3. WHERE, with its expression subqueries (optimize factors the
        # conjuncts of every OR's arms out)
        if q.where is not None:
            if _has_agg(q.where):
                raise SqlError("aggregates are not allowed in WHERE")
            plan = self.where(scope.canon(q.where), plan, scope)
        # 4. ORDER BY items: ordinals and select names stand for the
        # select expressions; GROUP BY items: ordinals, columns, names
        orders = []
        for o in q.order_by:
            a = o.expr
            if isinstance(a, Lit) and isinstance(a.value, int):
                if not 1 <= a.value <= len(items):
                    raise SqlError(f"ORDER BY position {a.value} is not "
                                   f"in the select list")
                a = items[a.value - 1]
            elif isinstance(a, Ident) and a.qualifier is None and \
                    a.name.lower() in by_name:
                a = by_name[a.name.lower()]
            else:
                try:
                    a = scope.canon(a)
                except SqlError:
                    # select aliases inside an ORDER BY expression (q70's
                    # ``case when lochierarchy = 0 then s_state end``):
                    # substituted through the tree, as the reference does
                    a = scope.canon(_transform(a, lambda n: by_name[
                        n.name.lower()] if isinstance(n, Ident) and
                        n.qualifier is None and n.name.lower() in by_name
                        else n))
            orders.append((a, o))
        keys = []
        for g in q.group_by:
            if isinstance(g, Lit) and isinstance(g.value, int):
                if not 1 <= g.value <= len(items):
                    raise SqlError(f"GROUP BY position {g.value} is not in "
                                   f"the select list")
                g = items[g.value - 1]
            else:
                try:
                    g = scope.canon(g)
                except SqlError:
                    if not (isinstance(g, Ident) and g.qualifier is None
                            and g.name.lower() in by_name):
                        raise
                    g = by_name[g.name.lower()]
            if _has_agg(g):
                raise SqlError("aggregates are not allowed in GROUP BY")
            keys.append(g)
        having = scope.canon(q.having) if q.having is not None else None
        # 5. the aggregate: group keys and every aggregate call of the
        # select list, HAVING and ORDER BY become its columns
        if keys or having is not None or q.group_sets is not None or \
                any(_has_agg(a) for a in items):
            plan, items, having, orders = self.aggregate(
                plan, keys, items, having, orders, q.group_sets)
        schema = plan.schema
        if having is not None:
            plan = L.Filter(self.expr(having, schema), plan)
        # 6. the window functions of the select list and ORDER BY, over
        # the aggregate's rows, each a column of one Window node
        wins: List[WindowE] = []
        for a in items + [a for a, _ in orders]:
            for n in _walk(a):
                if isinstance(n, WindowE) and n not in wins:
                    wins.append(n)
        if wins:
            names_of = {w: self.fresh("win") for w in wins}
            plan = L.Window([self.window(w, names_of[w], schema)
                             for w in wins], plan)
            schema = plan.schema

            def rw(a):
                return _transform(a, lambda n: Res(names_of[n]) if
                                  isinstance(n, WindowE) else n)
            items = [rw(a) for a in items]
            orders = [(rw(a), o) for a, o in orders]
        distinct_orders = orders if q.distinct else []
        if orders and not q.distinct:
            plan = L.Sort([L.SortOrder(self.expr(a, schema), o.ascending,
                                       o.nulls_first) for a, o in orders],
                          plan)
        outs = []
        for a, name in zip(items, names):
            e = self.expr(a, schema)
            outs.append(e if isinstance(e, ec.AttributeReference) and
                        e.col_name == name else ec.Alias(e, name))
        plan = L.Project(outs, plan)
        if q.distinct:
            # the sort runs over the distinct rows, by selected columns
            plan = L.Distinct(plan)
            out_orders = []
            for a, o in distinct_orders:
                if a not in items:
                    raise SqlError("ORDER BY of a SELECT DISTINCT must "
                                   "name a selected column")
                out_orders.append(OrderItem(Res(names[items.index(a)]),
                                            o.ascending, o.nulls_first))
            return self.order_and_limit(plan, out_orders, q.limit)
        if q.limit is not None:
            plan = L.Limit(q.limit, plan)
        return plan

    def aggregate(self, plan, keys, items, having, orders, sets=None):
        """The aggregate, and the select items, HAVING and ORDER BY
        rewritten over its columns: a key that is a column keeps its name,
        other keys and the aggregate calls take fresh ones.  DISTINCT
        calls take the reference's two-level rewrite
        (``plan/logical.build_aggregate``); with grouping sets (``sets``:
        positions in ``keys``) the aggregate runs over an Expand
        (``build_grouping_sets``) and ``grouping(k)`` reads the set id:
        1 in the sets without ``k``, else 0."""
        schema = plan.schema
        subst: Dict[Any, str] = {}
        group_exprs, key_names = [], []
        for k in keys:
            if k not in subst:
                e = self.expr(k, schema)
                if isinstance(k, Res):
                    name = k.cname
                else:
                    name = self.fresh("grp")
                    e = ec.Alias(e, name)
                subst[k] = name
                group_exprs.append(e)
            key_names.append(subst[k])
        calls: List[Call] = []
        for a in items + [having] + [a for a, _ in orders]:
            if a is not None:
                _agg_calls(a, calls)
        aggs = []
        for c in calls:
            name = self.fresh("agg")
            aggs.append(L.AggExpr(self.agg_func(c, schema), name,
                                  c.distinct))
            subst[c] = name
        named_sets = None if sets is None else \
            [tuple(dict.fromkeys(key_names[i] for i in st)) for st in sets]
        gsub = self._grouping_calls(items, having, orders, subst,
                                    named_sets)

        def rw(a):
            """Top down: a grouping() call, a key or an aggregate call is
            replaced whole, before its parts are."""
            if a in gsub:
                return gsub[a]
            if a in subst:
                return Res(subst[a])
            if not _kids(a):
                return a
            return _transform_kids(a, rw)
        items = [rw(a) for a in items]
        having = rw(having) if having is not None else None
        orders = [(rw(a), o) for a, o in orders]
        try:
            if named_sets is None:
                out = L.build_aggregate(group_exprs, aggs, plan)
            else:
                out = L.build_grouping_sets(group_exprs, named_sets, aggs,
                                            plan, keep_gid=bool(gsub))
        except NotImplementedError as err:
            raise SqlError(str(err)) from None
        return out, items, having, orders

    @staticmethod
    def _grouping_calls(items, having, orders, subst, sets):
        """Each ``grouping(k)`` call of the select list, HAVING and ORDER
        BY, as the reference lowers it: ``CASE WHEN __gid IN (the sets
        without k) THEN 1 ELSE 0 END``."""
        out = {}
        roots = items + [a for a, _ in orders] + \
            ([having] if having is not None else [])
        for root in roots:
            for n in _walk(root):
                if not (isinstance(n, Call) and n.name == "grouping") or \
                        n in out:
                    continue
                key = subst.get(n.args[0]) if len(n.args) == 1 and \
                    not n.star and not n.distinct else None
                if sets is None or \
                        key not in {m for st in sets for m in st}:
                    raise SqlError("grouping() takes one key of GROUP BY "
                                   "ROLLUP, CUBE or GROUPING SETS")
                rolled = tuple(Lit(i) for i, st in enumerate(sets)
                               if key not in st)
                out[n] = Case(None, ((InList(Res(L.GID), rolled), Lit(1)),),
                              Lit(0)) if rolled else Lit(0)
        return out


def _strip_leftmost_ctes(s: SetOp) -> SetOp:
    """``s`` with its leftmost SELECT's WITH list dropped (its CTEs are
    views by then)."""
    if isinstance(s.left, SetOp):
        return dataclasses.replace(s, left=_strip_leftmost_ctes(s.left))
    return dataclasses.replace(s, left=dataclasses.replace(s.left, ctes=[]))


#: the value a NULL stands in as in a null-safe key, by type (the
#: reference's ``lower_setop``: a string's is '', a date's 1970-01-01)
_NULL_SAFE_DEFAULT = {T.STRING: "", T.DATE: T.EPOCH, T.BOOL: False,
                      T.INT32: 0, T.INT64: 0, T.FLOAT32: 0.0,
                      T.FLOAT64: 0.0}


def _null_safe_keys(left, right):
    """(left keys, right keys) under which two NULLs match (``IS NOT
    DISTINCT FROM``): a column nullable on either side keys on its null
    flag and on its value with NULL replaced by its type's default (no
    value key where a side is all NULL); the flag keeps a real default
    (``''``, 1970-01-01, 0) apart from a NULL."""
    lkeys, rkeys = [], []
    for lf, rf in zip(left, right):
        refs = [ec.AttributeReference(f.name, f.dtype, f.nullable)
                for f in (lf, rf)]
        if not (lf.nullable or rf.nullable):
            lkeys.append(refs[0])
            rkeys.append(refs[1])
            continue
        lkeys.append(ep.IsNull(refs[0]))
        rkeys.append(ep.IsNull(refs[1]))
        if T.NULL not in (lf.dtype, rf.dtype):
            lkeys.append(econd.Coalesce(refs[0], ec.Literal(
                _NULL_SAFE_DEFAULT[lf.dtype], lf.dtype)))
            rkeys.append(econd.Coalesce(refs[1], ec.Literal(
                _NULL_SAFE_DEFAULT[rf.dtype], rf.dtype)))
    return lkeys, rkeys


def sql_to_plan(sql: str, views: Dict[str, L.LogicalPlan],
                session=None) -> L.LogicalPlan:
    """The optimized logical plan of a query over ``views`` (lower-case
    names -> plans).  An uncorrelated subquery runs while the query is
    lowered, on ``session``'s device; without a session it raises
    ``SqlError``."""
    return optimize(_Lowerer(views, session).query(parse_sql(sql)))
