"""functions: col, the aggregates (``count_distinct`` and
``sum_distinct`` too, ``min``, ``first`` and ``last``), conditionals and
the null and NaN functions, the math functions, ``hash``, ``md5``,
``rand`` and the ids, string functions, DATE functions (``to_date``
too) and window functions.

Counterpart of ``spark_rapids_tpu/api/functions.py`` (the port's
subset).
"""
from __future__ import annotations

from ..expr import aggregates as eagg
from ..expr import arithmetic as ea
from ..expr import conditional as econd
from ..expr import core as ec
from ..expr import datetime as edt
from ..expr import misc as emisc
from ..expr import predicates as ep
from ..expr import string_ops as es
from ..expr import window_funcs as wf
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


def min(c) -> Col:  # noqa: A001
    return Col(eagg.Min(_arg(c)))


def first(c, ignore_nulls: bool = False) -> Col:
    """The first value of a group in input order; nulls count unless
    ``ignore_nulls`` (Spark's default, where the reference skips them)."""
    return Col(eagg.First(_arg(c), ignore_nulls))


def last(c, ignore_nulls: bool = False) -> Col:
    return Col(eagg.Last(_arg(c), ignore_nulls))


def _distinct(agg) -> Col:
    """An aggregate of the distinct values of its input (the reference
    marks it ``_distinct``; ``GroupedData.agg`` rewrites it)."""
    agg._distinct = True
    return Col(agg)


def count_distinct(c) -> Col:
    return _distinct(eagg.Count(_arg(c)))


countDistinct = count_distinct


def sum_distinct(c) -> Col:
    return _distinct(eagg.Sum(_arg(c)))


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


def isnull(c) -> Col:
    return Col(ep.IsNull(_arg(c)))


def isnan(c) -> Col:
    return Col(ep.IsNaN(_arg(c)))


def nanvl(a, b) -> Col:
    return Col(econd.NaNvl(_arg(a), _expr(b)))


def substring(c, pos: int, length: int) -> Col:
    return Col(es.Substring(_arg(c), ec.Literal(pos), ec.Literal(length)))


def concat(*cols) -> Col:
    return Col(es.ConcatStrings(*[_arg(c) for c in cols]))


def concat_ws(sep: str, *cols) -> Col:
    return Col(es.ConcatWs(ec.Literal(sep), *[_arg(c) for c in cols]))


def instr(c, substr: str) -> Col:
    return Col(es.StringLocate(ec.Literal(substr), _arg(c)))


def locate(substr: str, c, pos: int = 1) -> Col:
    return Col(es.StringLocate(ec.Literal(substr), _arg(c),
                               ec.Literal(pos)))


def replace(c, search: str, rep: str = "") -> Col:
    return Col(es.Replace(_arg(c), ec.Literal(search), ec.Literal(rep)))


def repeat(c, n: int) -> Col:
    return Col(es.StringRepeat(_arg(c), ec.Literal(n)))


def lpad(c, length: int, pad: str = " ") -> Col:
    return Col(es.Lpad(_arg(c), ec.Literal(length), ec.Literal(pad)))


def rpad(c, length: int, pad: str = " ") -> Col:
    return Col(es.Rpad(_arg(c), ec.Literal(length), ec.Literal(pad)))


def rand(seed: int = 0) -> Col:
    return Col(emisc.Rand(seed))


def abs(c) -> Col:  # noqa: A001
    return Col(ea.Abs(_arg(c)))


def round(c, scale: int = 0) -> Col:  # noqa: A001
    """Spark's ``round`` (HALF_UP) to ``scale`` decimal places."""
    return Col(ea.Round(_arg(c), scale))


def _u(cls):
    def f(c) -> Col:
        return Col(cls(_arg(c)))
    f.__name__ = cls.__name__.lower()
    return f


sqrt = _u(ea.Sqrt)
exp = _u(ea.Exp)
log = _u(ea.Log)
log2 = _u(ea.Log2)
log10 = _u(ea.Log10)
sin = _u(ea.Sin)
cos = _u(ea.Cos)
tan = _u(ea.Tan)
asin = _u(ea.Asin)
acos = _u(ea.Acos)
atan = _u(ea.Atan)
floor = _u(ea.Floor)
ceil = _u(ea.Ceil)
signum = _u(ea.Signum)
degrees = _u(ea.ToDegrees)
radians = _u(ea.ToRadians)


def pow(a, b) -> Col:  # noqa: A001
    return Col(ea.Pow(_arg(a), _expr(b)))


def pmod(a, b) -> Col:
    """Spark's ``pmod``: ``(r + b) % b`` where ``r = a % b`` is negative
    (``expr/arithmetic.Pmod``)."""
    return Col(ea.Pmod(_arg(a), _expr(b)))


def greatest(*cols) -> Col:
    return Col(ea.Greatest(*[_arg(c) for c in cols]))


def least(*cols) -> Col:
    return Col(ea.Least(*[_arg(c) for c in cols]))


def hash(*cols) -> Col:  # noqa: A001
    return Col(emisc.Murmur3Hash(*[_arg(c) for c in cols]))


def monotonically_increasing_id() -> Col:
    return Col(emisc.MonotonicallyIncreasingID())


def spark_partition_id() -> Col:
    return Col(emisc.SparkPartitionID())


# -- DATE functions ------------------------------------------------------------

def _date_field(cls):
    def f(c) -> Col:
        return Col(cls(_arg(c)))
    f.__name__ = cls.__name__.lower()
    return f


year = _date_field(edt.Year)
month = _date_field(edt.Month)
dayofmonth = _date_field(edt.DayOfMonth)
quarter = _date_field(edt.Quarter)
dayofweek = _date_field(edt.DayOfWeek)
weekday = _date_field(edt.WeekDay)
dayofyear = _date_field(edt.DayOfYear)
last_day = _date_field(edt.LastDay)


def date_add(c, days) -> Col:
    return Col(edt.DateAdd(_arg(c), _expr(days)))


def date_sub(c, days) -> Col:
    return Col(edt.DateSub(_arg(c), _expr(days)))


def datediff(end, start) -> Col:
    return Col(edt.DateDiff(_arg(end), _arg(start)))


# -- window functions (``DataFrame.with_window``) ---------------------------

def row_number() -> Col:
    return Col(wf.RowNumber())


def rank() -> Col:
    return Col(wf.Rank())


def dense_rank() -> Col:
    return Col(wf.DenseRank())


def ntile(n: int) -> Col:
    return Col(wf.NTile(n))


def percent_rank() -> Col:
    return Col(wf.PercentRank())


def cume_dist() -> Col:
    return Col(wf.CumeDist())


def lead(c, offset: int = 1) -> Col:
    """The value ``offset`` rows on in the window's order (no default, as
    the reference's: NULL past the partition's edge)."""
    return Col(wf.Lead(_arg(c), offset))


def lag(c, offset: int = 1) -> Col:
    return Col(wf.Lag(_arg(c), offset))


length = _u(es.Length)
trim = _u(es.StringTrim)
ltrim = _u(es.StringTrimLeft)
rtrim = _u(es.StringTrimRight)
reverse = _u(es.Reverse)
initcap = _u(es.InitCap)
md5 = _u(emisc.Md5)
to_date = _u(edt.ToDate)
