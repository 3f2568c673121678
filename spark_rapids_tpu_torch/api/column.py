"""Column API wrapper: PySpark-style ``Col`` over expression trees.

Counterpart of ``spark_rapids_tpu/api/column.py`` (the operators this
slice supports).
"""
from __future__ import annotations

from ..expr import arithmetic as ea
from ..expr import core as ec
from ..expr import predicates as ep


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

    def __mul__(self, o):
        return Col(ea.Multiply(self.expr, _expr(o)))

    def __rmul__(self, o):
        return Col(ea.Multiply(_expr(o), self.expr))

    def __mod__(self, o):
        return Col(ea.Remainder(self.expr, _expr(o)))

    def __eq__(self, o):  # type: ignore[override]
        return Col(ep.EqualTo(self.expr, _expr(o)))

    def __ne__(self, o):  # type: ignore[override]
        return Col(ep.Not(ep.EqualTo(self.expr, _expr(o))))

    def __gt__(self, o):
        return Col(ep.GreaterThan(self.expr, _expr(o)))

    def __and__(self, o):
        return Col(ep.And(self.expr, _expr(o)))

    def __invert__(self):
        return Col(ep.Not(self.expr))

    def alias(self, name: str) -> "Col":
        return Col(ec.Alias(self.expr, name))

    def __repr__(self):
        return f"Col({self.expr!r})"

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise ValueError("Cannot convert Col to bool; use & for logic")
