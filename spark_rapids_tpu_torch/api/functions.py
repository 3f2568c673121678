"""functions: col, the aggregates, conditionals, ``round`` and string
functions.

Counterpart of ``spark_rapids_tpu/api/functions.py`` (the port's
subset).
"""
from __future__ import annotations

from ..expr import aggregates as eagg
from ..expr import arithmetic as ea
from ..expr import conditional as econd
from ..expr import core as ec
from ..expr import string_ops as es
from .column import Col, _expr


def col(name: str) -> Col:
    return Col(ec.AttributeReference(name))


def lit(value) -> Col:
    return Col(ec.Literal(value))


def _arg(c) -> ec.Expression:
    return _expr(col(c) if isinstance(c, str) else c)


def sum(c) -> Col:  # noqa: A001
    return Col(eagg.Sum(_arg(c)))


def count(c="*") -> Col:
    if isinstance(c, str) and c == "*":
        return Col(eagg.Count())
    return Col(eagg.Count(_arg(c)))


def max(c) -> Col:  # noqa: A001
    return Col(eagg.Max(_arg(c)))


def avg(c) -> Col:
    return Col(eagg.Average(_arg(c)))


def stddev(c) -> Col:
    return Col(eagg.StddevSamp(_arg(c)))


stddev_samp = stddev


def stddev_pop(c) -> Col:
    return Col(eagg.StddevPop(_arg(c)))


def variance(c) -> Col:
    return Col(eagg.VarianceSamp(_arg(c)))


def var_pop(c) -> Col:
    return Col(eagg.VariancePop(_arg(c)))


class WhenBuilder(Col):
    """``when(c, v).when(...).otherwise(e)``: a CASE under construction."""

    def __init__(self, branches):
        self._branches = branches
        super().__init__(econd.CaseWhen(branches, None))

    def when(self, cond, value) -> "WhenBuilder":
        return WhenBuilder(self._branches + [(_expr(cond), _expr(value))])

    def otherwise(self, value) -> Col:
        return Col(econd.CaseWhen(self._branches, _expr(value)))


def when(cond, value) -> WhenBuilder:
    return WhenBuilder([(_expr(cond), _expr(value))])


def coalesce(*cols) -> Col:
    return Col(econd.Coalesce(*[_arg(c) for c in cols]))


def substring(c, pos: int, length: int) -> Col:
    return Col(es.Substring(_arg(c), ec.Literal(pos), ec.Literal(length)))


def concat(*cols) -> Col:
    return Col(es.ConcatStrings(*[_arg(c) for c in cols]))


def round(c, scale: int = 0) -> Col:  # noqa: A001
    """Spark's ``round`` (HALF_UP) to ``scale`` decimal places."""
    return Col(ea.Round(_arg(c), scale))
