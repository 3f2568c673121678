"""DATE expressions: the civil fields, ``last_day`` and day arithmetic.

Counterpart of ``spark_rapids_tpu/expr/datetime.py`` over DATE columns
(int32 days since 1970-01-01).  The civil decomposition is Howard
Hinnant's days-from-civil arithmetic on int64 tensors (floor divisions,
so dates before 1970 decompose as after).  The TIMESTAMP classes are not
ported, as TIMESTAMP is not.  Each field is an int32; ``DateAdd`` and
``DateSub`` add int64 days and wrap to int32, as the reference does.
An argument of another type raises ``NotImplementedError`` when the
expression is typed (``dtype()``), before any device work.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column
from .cast import Cast
from .core import Expression, eval_as_column


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day), int64 tensors."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                                   # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) -
                _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                             # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                     # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    return y + (m <= 2).to(torch.int64), m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _need_date(e: Expression, what: str) -> None:
    dt = e.dtype()
    if dt not in (T.DATE, T.NULL):
        raise NotImplementedError(f"{what}() of a {dt} is not supported by "
                                  f"the port (it takes a DATE)")


def _need_days(e: Expression, what: str) -> None:
    dt = e.dtype()
    if not (dt.is_integral or dt == T.NULL):
        raise NotImplementedError(f"{what}() takes an integer count of days, "
                                  f"not a {dt}")


class _DateField(Expression):
    """An int32 field of a DATE."""

    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        _need_date(self.children[0], self.name.lower())
        return T.INT32

    def field(self, days, y, m, d):
        raise NotImplementedError

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        days = c.data.to(torch.int64)
        y, m, d = civil_from_days(days)
        return Column(T.INT32, self.field(days, y, m, d).to(torch.int32),
                      c.validity)


class Year(_DateField):
    def field(self, days, y, m, d):
        return y


class Month(_DateField):
    def field(self, days, y, m, d):
        return m


class DayOfMonth(_DateField):
    def field(self, days, y, m, d):
        return d


class Quarter(_DateField):
    def field(self, days, y, m, d):
        return _fdiv(m - 1, 3) + 1


class DayOfWeek(_DateField):
    """Spark's ``dayofweek``: Sunday 1 .. Saturday 7 (1970-01-01 was a
    Thursday)."""

    def field(self, days, y, m, d):
        return torch.remainder(days + 4, 7) + 1


class WeekDay(_DateField):
    """Spark's ``weekday``: Monday 0 .. Sunday 6."""

    def field(self, days, y, m, d):
        return torch.remainder(days + 3, 7)


class DayOfYear(_DateField):
    def field(self, days, y, m, d):
        one = torch.ones_like(y)
        return days - days_from_civil(y, one, one) + 1


class LastDay(Expression):
    """``last_day(date)``: the last day of the date's month."""

    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        _need_date(self.children[0], "last_day")
        return T.DATE

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        y, m, _ = civil_from_days(c.data)
        nxt = days_from_civil(torch.where(m == 12, y + 1, y),
                              torch.where(m == 12, 1, m + 1),
                              torch.ones_like(m))
        return Column(T.DATE, (nxt - 1).to(torch.int32), c.validity)


class _DayShift(Expression):
    """``start`` moved by ``days`` (``sign`` 1 forward, -1 back)."""
    sign = 1

    def __init__(self, start: Expression, days: Expression):
        self.children = [start, days]

    def dtype(self):
        what = "date_add" if self.sign > 0 else "date_sub"
        _need_date(self.children[0], what)
        _need_days(self.children[1], what)
        return T.DATE

    def columnar_eval(self, batch):
        a = eval_as_column(self.children[0], batch)
        b = eval_as_column(self.children[1], batch)
        days = a.data.to(torch.int64) + self.sign * b.data.to(torch.int64)
        return Column(T.DATE, days.to(torch.int32), a.validity & b.validity)


class DateAdd(_DayShift):
    sign = 1


class DateSub(_DayShift):
    sign = -1


class DateDiff(Expression):
    """``datediff(end, start)``: the days from ``start`` to ``end``."""

    def __init__(self, end: Expression, start: Expression):
        self.children = [end, start]

    def dtype(self):
        _need_date(self.children[0], "datediff")
        _need_date(self.children[1], "datediff")
        return T.INT32

    def columnar_eval(self, batch):
        a = eval_as_column(self.children[0], batch)
        b = eval_as_column(self.children[1], batch)
        return Column(T.INT32, (a.data.to(torch.int64) -
                                b.data.to(torch.int64)).to(torch.int32),
                      a.validity & b.validity)


class ToDate(Cast):
    """``to_date(str)``: the cast of a STRING (or DATE) to DATE, Spark's
    ``stringToDate`` (``kernels/numtext.parse_date``)."""

    def __init__(self, child: Expression):
        super().__init__(child, T.DATE)

    def __repr__(self):
        return f"to_date({self.children[0]!r})"
