"""SQL front end: text -> tokens -> AST -> logical plan.

Counterpart of ``spark_rapids_tpu/api/sql.py`` for the subset the port
runs:

- ``SELECT`` lists of expressions with aliases (``AS`` optional) and
  ``*``;
- ``FROM`` lists of temp views (comma joins) and ``[INNER | LEFT
  [OUTER] | RIGHT [OUTER] | FULL [OUTER]] JOIN ... ON``, views with
  aliases, column names with or without a qualifier;
- ``WHERE`` with ``AND`` / ``OR`` / ``NOT``, the comparisons ``=``,
  ``<>``, ``!=``, ``<``, ``<=``, ``>``, ``>=``, and ``+``, ``*``, ``%``;
- integer, decimal (read as double) and string literals;
- ``GROUP BY`` expressions or select aliases; the aggregates
  ``count(*)``, ``count``, ``sum`` and ``max``;
- ``ORDER BY`` expressions, select aliases or ordinals with ``ASC`` /
  ``DESC`` and ``NULLS FIRST`` / ``LAST``; ``LIMIT``.

Anything else raises ``SqlError`` naming the construct, before any
device work.  The plan is built in Spark's order: the FROM relations as
a left-deep join tree, WHERE as a filter over it, the aggregate, the
sort (over the aggregate's columns, an alias standing for its select
expression), the projection of the select list, the limit; then
``plan/logical_opt.optimize`` turns the comma joins and WHERE
equalities into equi-joins with the filters below them.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from ..expr import aggregates as eagg
from ..expr import arithmetic as ea
from ..expr import core as ec
from ..expr import predicates as ep
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
    value: Any


@dataclasses.dataclass(frozen=True)
class Ident:
    name: str
    qualifier: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Star:
    pass


@dataclasses.dataclass(frozen=True)
class Call:
    name: str
    args: Tuple[Any, ...]
    star: bool = False


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


@dataclasses.dataclass
class TableRef:
    name: str
    alias: Optional[str]


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
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None


#: keywords that end an expression or cannot be an alias
_KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit", "as", "and",
    "or", "not", "join", "on", "inner", "left", "right", "full", "outer",
    "cross", "asc", "desc", "nulls", "first", "last", "having", "union",
    "intersect", "except", "with", "distinct", "between", "in", "like",
    "is", "null", "case", "when", "then", "else", "end", "exists", "over",
    "offset", "semi", "anti", "using", "interval", "cast", "true", "false",
    "all", "window", "qualify", "lateral", "natural", "rollup", "cube",
    "grouping",
}
#: constructs of Spark SQL the port does not parse, by their keyword
_UNSUPPORTED = {
    "with": "WITH (common table expressions)", "union": "UNION",
    "intersect": "INTERSECT", "except": "EXCEPT", "distinct": "DISTINCT",
    "having": "HAVING", "between": "BETWEEN", "in": "IN", "like": "LIKE",
    "is": "IS [NOT] NULL", "case": "CASE", "exists": "EXISTS",
    "over": "window functions (OVER)", "offset": "OFFSET",
    "cast": "CAST", "interval": "INTERVAL", "null": "NULL literals",
    "true": "boolean literals", "false": "boolean literals",
    "using": "JOIN ... USING", "cross": "CROSS JOIN",
    "natural": "NATURAL JOIN", "semi": "SEMI JOIN", "anti": "ANTI JOIN",
    "rollup": "ROLLUP", "cube": "CUBE", "grouping": "GROUPING SETS",
    "window": "WINDOW", "qualify": "QUALIFY", "lateral": "LATERAL",
    "all": "ALL",
}
_AGGREGATES = {"sum": eagg.Sum, "count": eagg.Count, "max": eagg.Max}
_COMPARISONS = {"=": ep.EqualTo, "<": ep.LessThan, "<=": ep.LessThanOrEqual,
                ">": ep.GreaterThan, ">=": ep.GreaterThanOrEqual}
_ARITHMETIC = {"+": ea.Add, "*": ea.Multiply, "%": ea.Remainder}


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
    def parse(self) -> Select:
        if self.at_op("("):
            self._fail("subqueries are not supported by the port; expected "
                       "SELECT")
        q = self.select()
        if self.at_op(";"):
            self.advance()
        if self.tok.kind != "end":
            self._fail("expected end of query")
        return q

    def select(self) -> Select:
        self.expect("select")
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
        q = Select(items, from_)
        if self.at("where"):
            self.advance()
            q.where = self.expr()
        if self.at("group"):
            self.advance()
            self.expect("by")
            self._unsupported_here()
            q.group_by = [self.expr()]
            while self.at_op(","):
                self.advance()
                q.group_by.append(self.expr())
        self._unsupported_here()
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
        self._unsupported_here()
        return q

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

    def table_ref(self) -> TableRef:
        if self.at_op("("):
            self._fail("subqueries in FROM are not supported by the port")
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
            elif self.at("left", "right", "full"):
                how = self.advance().text.lower()
                if self.at("outer"):
                    self.advance()
            else:
                self._unsupported_here()
                return left
            self.expect("join")
            right = self.table_ref()
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
        return self.comparison()

    def comparison(self):
        e = self.additive()
        self._unsupported_here()
        if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
            op = self.advance().text
            e = BinOp("<>" if op == "!=" else op, e, self.additive())
            self._unsupported_here()
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

    def primary(self):
        t = self.tok
        if t.kind == "num":
            self.advance()
            txt = t.text
            return Lit(int(txt) if re.fullmatch(r"\d+", txt) else float(txt))
        if t.kind == "str":
            self.advance()
            return Lit(t.text[1:-1].replace("''", "'"))
        if self.at_op("("):
            self.advance()
            if self.at("select"):
                self._fail("subqueries are not supported by the port")
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

    def call(self, name: str) -> Call:
        self.advance()                                  # (
        fname = name.lower()
        if self.at("distinct"):
            self._fail("")
        if self.at_op("*"):
            self.advance()
            self.expect_op(")")
            return Call(fname, (), star=True)
        args = []
        if not self.at_op(")"):
            args.append(self.expr())
            while self.at_op(","):
                self.advance()
                args.append(self.expr())
        self.expect_op(")")
        if self.at("over"):
            self._fail("")
        return Call(fname, tuple(args))


def parse_sql(sql: str) -> Select:
    return _Parser(sql).parse()


# -- lowering ----------------------------------------------------------------

def _sql_text(a) -> str:
    """A column name for an un-aliased select expression."""
    if isinstance(a, Ident):
        return a.name
    if isinstance(a, Lit):
        return repr(a.value)
    if isinstance(a, Call):
        inner = "*" if a.star else ", ".join(_sql_text(x) for x in a.args)
        return f"{a.name}({inner})"
    if isinstance(a, BinOp):
        return f"({_sql_text(a.left)} {a.op} {_sql_text(a.right)})"
    if isinstance(a, NotOp):
        return f"(NOT {_sql_text(a.child)})"
    if isinstance(a, Neg):
        return f"(- {_sql_text(a.child)})"
    return repr(a)


def _has_agg(a) -> bool:
    if isinstance(a, Call):
        return a.name in _AGGREGATES or any(_has_agg(x) for x in a.args)
    if isinstance(a, BinOp):
        return _has_agg(a.left) or _has_agg(a.right)
    if isinstance(a, (NotOp, Neg)):
        return _has_agg(a.child)
    return False


class _Lowerer:
    def __init__(self, views: Dict[str, L.LogicalPlan]):
        self.views = views

    # -- FROM ----------------------------------------------------------------
    def relation(self, ref) -> L.LogicalPlan:
        if isinstance(ref, TableRef):
            plan = self.views.get(ref.name.lower())
            if plan is None:
                raise SqlError(f"table or view not found: {ref.name}")
            return plan
        left, right = self.relation(ref.left), self.relation(ref.right)
        from .dataframe import _extract_equi_keys
        both = L.Join(left, right, "cross", [], []).schema
        cond = self.expr(ref.on, both)
        lkeys, rkeys, residual = _extract_equi_keys(cond, left.schema,
                                                    right.schema)
        if not lkeys:
            raise SqlError("JOIN ... ON without an equality between the two "
                           "sides is not supported by the port")
        return L.Join(left, right, ref.how, lkeys, rkeys, residual)

    # -- expressions ---------------------------------------------------------
    def column(self, a: Ident, schema) -> ec.Expression:
        names = schema.names
        hits = [n for n in names if n == a.name] or \
            [n for n in names if n.lower() == a.name.lower()]
        if not hits:
            raise SqlError(f"column not found: {_sql_text(a)}")
        if len(hits) > 1:
            raise SqlError(f"ambiguous column: {_sql_text(a)}")
        return ec.AttributeReference(hits[0]).resolve(schema)

    def expr(self, a, schema, aggs: Dict = None) -> ec.Expression:
        if aggs is not None and a in aggs:
            return ec.AttributeReference(aggs[a]).resolve(schema)
        if isinstance(a, Lit):
            return ec.Literal(a.value)
        if isinstance(a, Ident):
            return self.column(a, schema)
        if isinstance(a, Neg):
            if isinstance(a.child, Lit) and isinstance(a.child.value,
                                                       (int, float)):
                return ec.Literal(-a.child.value)
            raise SqlError("unary minus of an expression is not supported "
                           "by the port")
        if isinstance(a, NotOp):
            return ep.Not(self.expr(a.child, schema, aggs))
        if isinstance(a, BinOp):
            left = self.expr(a.left, schema, aggs)
            right = self.expr(a.right, schema, aggs)
            if a.op == "and":
                return ep.And(left, right)
            if a.op == "or":
                return ep.Or(left, right)
            if a.op == "<>":
                return ep.Not(ep.EqualTo(left, right))
            if a.op in _COMPARISONS:
                return _COMPARISONS[a.op](left, right)
            if a.op in _ARITHMETIC:
                return _ARITHMETIC[a.op](left, right)
            raise SqlError(f"operator {a.op!r} is not supported by the port")
        if isinstance(a, Call):
            if a.name in _AGGREGATES:
                raise SqlError(f"aggregate {a.name}() is not allowed here")
            raise SqlError(f"function {a.name}() is not supported by the port")
        if isinstance(a, Star):
            raise SqlError("* is only allowed as a select item or count(*)")
        raise SqlError(f"unsupported expression {a!r}")

    def agg_func(self, a: Call, schema) -> eagg.AggregateFunction:
        if a.star:
            if a.name != "count":
                raise SqlError(f"{a.name}(*) is not supported")
            return eagg.Count()
        if len(a.args) != 1:
            raise SqlError(f"{a.name}() takes one argument")
        if _has_agg(a.args[0]):
            raise SqlError("nested aggregates are not allowed")
        return _AGGREGATES[a.name](self.expr(a.args[0], schema))

    def _collect_aggs(self, a, out: List[Call]) -> None:
        if isinstance(a, Call) and a.name in _AGGREGATES:
            if a not in out:
                out.append(a)
            return
        if isinstance(a, Call):
            raise SqlError(f"function {a.name}() is not supported by the "
                           f"port")
        for child in (getattr(a, "left", None), getattr(a, "right", None),
                      getattr(a, "child", None)):
            if child is not None:
                self._collect_aggs(child, out)

    # -- SELECT --------------------------------------------------------------
    def select(self, q: Select) -> L.LogicalPlan:
        plan = self.relation(q.from_[0])
        for ref in q.from_[1:]:
            plan = L.Join(plan, self.relation(ref), "cross", [], [])
        if q.where is not None:
            if _has_agg(q.where):
                raise SqlError("aggregates are not allowed in WHERE")
            plan = L.Filter(self.expr(q.where, plan.schema), plan)
        items = []
        for a, alias in q.items:
            if isinstance(a, Star):
                items.extend((Ident(n), None) for n in plan.schema.names)
            else:
                items.append((a, alias))
        aliases = {alias.lower(): a for a, alias in items if alias}
        grouped = bool(q.group_by) or any(_has_agg(a) for a, _ in items)
        agg_names = None
        if grouped:
            plan, agg_names = self.aggregate(q, items, aliases, plan)
        schema = plan.schema
        outs = []
        for a, alias in items:
            e = self.expr(a, schema, agg_names)
            name = alias or _sql_text(a)
            outs.append(e if isinstance(e, ec.AttributeReference) and
                        e.col_name == name else ec.Alias(e, name))
        if q.order_by:
            orders = []
            for o in q.order_by:
                a = o.expr
                if isinstance(a, Lit) and isinstance(a.value, int):
                    if not 1 <= a.value <= len(items):
                        raise SqlError(f"ORDER BY position {a.value} is not "
                                       f"in the select list")
                    e = outs[a.value - 1]
                    e = e.children[0] if isinstance(e, ec.Alias) else e
                elif isinstance(a, Ident) and a.qualifier is None and \
                        a.name.lower() in aliases and \
                        a.name not in schema.names:
                    e = self.expr(aliases[a.name.lower()], schema, agg_names)
                else:
                    e = self.expr(a, schema, agg_names)
                orders.append(L.SortOrder(e, o.ascending, o.nulls_first))
            plan = L.Sort(orders, plan)
        plan = L.Project(outs, plan)
        if q.limit is not None:
            plan = L.Limit(q.limit, plan)
        return plan

    def aggregate(self, q: Select, items, aliases, plan):
        """Aggregate node and the names of its outputs: every group
        expression and aggregate call (as AST) -> its output column."""
        schema = plan.schema
        group_asts = []
        for g in q.group_by:
            if isinstance(g, Lit) and isinstance(g.value, int):
                if not 1 <= g.value <= len(items):
                    raise SqlError(f"GROUP BY position {g.value} is not in "
                                   f"the select list")
                g = items[g.value - 1][0]
            elif isinstance(g, Ident) and g.qualifier is None and \
                    g.name not in schema.names and g.name.lower() in aliases:
                g = aliases[g.name.lower()]
            if _has_agg(g):
                raise SqlError("aggregates are not allowed in GROUP BY")
            group_asts.append(g)
        names: Dict[Any, str] = {}
        group_exprs = []
        for g in group_asts:
            e = self.expr(g, schema)
            name = ec.output_name(e) if isinstance(
                e, ec.AttributeReference) else _sql_text(g)
            group_exprs.append(e if isinstance(e, ec.AttributeReference)
                               else ec.Alias(e, name))
            names[g] = name
            if isinstance(g, Ident):
                names[Ident(g.name)] = name
        calls: List[Call] = []
        for a, _ in items:
            self._collect_aggs(a, calls)
        for o in q.order_by:
            if not (isinstance(o.expr, Ident) and o.expr.name.lower() in
                    aliases):
                self._collect_aggs(o.expr, calls)
        item_alias = {a: alias for a, alias in items if alias}
        agg_exprs = []
        for c in calls:
            alias = item_alias.get(c) or _sql_text(c)
            agg_exprs.append(L.AggExpr(self.agg_func(c, schema), alias))
            names[c] = alias
        return L.Aggregate(group_exprs, agg_exprs, plan), names


def sql_to_plan(sql: str, views: Dict[str, L.LogicalPlan]) -> L.LogicalPlan:
    """The optimized logical plan of a query over ``views`` (lower-case
    names -> plans)."""
    return optimize(_Lowerer(views).select(parse_sql(sql)))
