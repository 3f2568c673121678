"""Column API wrapper: PySpark-style ``Col`` over expression trees.

Counterpart of ``spark_rapids_tpu/api/column.py`` (the operators the
port supports).
"""
from __future__ import annotations

from ..expr import arithmetic as ea
from ..expr import core as ec
from ..expr import predicates as ep
from ..expr import string_ops as es


def _expr(v) -> ec.Expression:
    if isinstance(v, Col):
        return v.expr
    if isinstance(v, ec.Expression):
        return v
    return ec.Literal(v)


class Col:
    def __init__(self, expr: ec.Expression):
        self.expr = expr

    def __add__(self, o):
        return Col(ea.Add(self.expr, _expr(o)))

    def __radd__(self, o):
        return Col(ea.Add(_expr(o), self.expr))

    def __sub__(self, o):
        return Col(ea.Subtract(self.expr, _expr(o)))

    def __rsub__(self, o):
        return Col(ea.Subtract(_expr(o), self.expr))

    def __mul__(self, o):
        return Col(ea.Multiply(self.expr, _expr(o)))

    def __rmul__(self, o):
        return Col(ea.Multiply(_expr(o), self.expr))

    def __truediv__(self, o):
        return Col(ea.Divide(self.expr, _expr(o)))

    def __rtruediv__(self, o):
        return Col(ea.Divide(_expr(o), self.expr))

    def __mod__(self, o):
        return Col(ea.Remainder(self.expr, _expr(o)))

    def __neg__(self):
        return Col(ea.UnaryMinus(self.expr))

    def __eq__(self, o):  # type: ignore[override]
        return Col(ep.EqualTo(self.expr, _expr(o)))

    def __ne__(self, o):  # type: ignore[override]
        return Col(ep.Not(ep.EqualTo(self.expr, _expr(o))))

    def __lt__(self, o):
        return Col(ep.LessThan(self.expr, _expr(o)))

    def __le__(self, o):
        return Col(ep.LessThanOrEqual(self.expr, _expr(o)))

    def __gt__(self, o):
        return Col(ep.GreaterThan(self.expr, _expr(o)))

    def __ge__(self, o):
        return Col(ep.GreaterThanOrEqual(self.expr, _expr(o)))

    def __and__(self, o):
        return Col(ep.And(self.expr, _expr(o)))

    def __or__(self, o):
        return Col(ep.Or(self.expr, _expr(o)))

    def __invert__(self):
        return Col(ep.Not(self.expr))

    def alias(self, name: str) -> "Col":
        return Col(ec.Alias(self.expr, name))

    def cast(self, to) -> "Col":
        """``CAST(self AS to)``: ``to`` a dtype or a type name
        (``expr/cast.type_of``: ``expr/cast.TYPE_NAMES`` or
        ``decimal(p, s)``)."""
        from ..expr.cast import Cast, type_of
        return Col(Cast(self.expr, type_of(to) if isinstance(to, str)
                        else to))

    def between(self, lo, hi) -> "Col":
        """``lo <= self <= hi``, as SQL's BETWEEN lowers."""
        return (self >= lo) & (self <= hi)

    def isin(self, *values) -> "Col":
        vals = values[0] if len(values) == 1 and \
            isinstance(values[0], (list, tuple)) else list(values)
        return Col(ep.In(self.expr, list(vals)))

    def is_null(self) -> "Col":
        return Col(ep.IsNull(self.expr))

    isNull = is_null

    def is_not_null(self) -> "Col":
        return Col(ep.IsNotNull(self.expr))

    isNotNull = is_not_null

    def eq_null_safe(self, o) -> "Col":
        """``self <=> o``: two nulls are equal; never null."""
        return Col(ep.EqualNullSafe(self.expr, _expr(o)))

    eqNullSafe = eq_null_safe

    def like(self, pattern: str, escape: str = "\\") -> "Col":
        return Col(es.Like(self.expr, ec.Literal(pattern), escape))

    def substr(self, pos: int, length: int = None) -> "Col":
        """``substring`` by characters (``functions.substring``)."""
        return Col(es.Substring(self.expr, ec.Literal(pos),
                                None if length is None
                                else ec.Literal(length)))

    def startswith(self, s) -> "Col":
        return Col(es.StartsWith(self.expr, _expr(s)))

    def endswith(self, s) -> "Col":
        return Col(es.EndsWith(self.expr, _expr(s)))

    def contains(self, s) -> "Col":
        return Col(es.Contains(self.expr, _expr(s)))

    def asc(self):
        from ..plan.logical import SortOrder
        return SortOrder(self.expr, ascending=True)

    def desc(self):
        from ..plan.logical import SortOrder
        return SortOrder(self.expr, ascending=False)

    def __repr__(self):
        return f"Col({self.expr!r})"

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise ValueError("Cannot convert Col to bool; use & | ~ for logic")
