"""Casts among the numbers (DECIMAL64 included), BOOL, DATE and STRING.

Counterpart of ``spark_rapids_tpu/expr/cast.py``'s ``Cast`` with Spark's
non-ANSI rules (the reference's ``_cast_numeric``):

- a float to an integer truncates toward zero, NaN gives 0, and the
  value saturates at the type's bounds (``_float_to_int``);
- an integer to a narrower integer wraps;
- an integer or a float to a float rounds to the nearest;
- BOOL to a number gives 0 or 1, a number to BOOL is ``x != 0`` (NaN is
  true);
- a DATE to a DATE, and a bare NULL to any type;
- to a DECIMAL: a DECIMAL rescales exactly up and HALF_UP down, an
  integer or BOOL multiplies by ``10^scale`` exactly, a float rounds
  its shortest digits HALF_UP (below); a value that does not fit the
  precision is NULL (Spark's answer; the reference's int64 wraps);
- from a DECIMAL: an integer truncates toward zero, and an int keeps
  the low 32 bits of that long (Spark's ``toLong.toInt``, which wraps;
  the reference clips), a float is the nearest to ``unscaled /
  10^scale``, BOOL is ``x != 0``;
- a double to a DECIMAL rounds HALF_UP from the double's shortest
  decimal digits, those of Java's ``Double.toString`` (Spark's
  ``Decimal(double)``; the reference rounds ``value * 10^scale``, and
  ties half to even);
- to STRING (and VARCHAR): integers in decimal digits, a DECIMAL as
  plain digits with ``scale`` of them after the point, a DATE as
  ``yyyy-MM-dd``, BOOL as ``true`` / ``false``, a float as Java's
  ``Double.toString`` / ``Float.toString`` (its shortest digits from the
  ``format_double`` kernel);
- from STRING, trimmed: integers as Spark's ``UTF8String.toLong`` /
  ``toInt`` (a fraction is dropped, a value past the type is NULL),
  floats as Java's ``parseDouble`` / ``parseFloat`` and the words NaN,
  Inf and Infinity in any case (the ``parse_double`` kernel), a DECIMAL
  from its digits exactly, HALF_UP, a DATE as Spark's ``stringToDate``,
  BOOL from ``t true y yes 1`` / ``f false n no 0`` in any case; any
  other text is NULL (``kernels/numtext.py``).

Comparisons, join keys and unions widen their narrower side through the
same class (``can_widen``: int32 -> int64 -> float32 -> float64).  A
cast from a DATE to a number or back, and TIMESTAMP are not ported:
``Cast`` raises ``NotImplementedError`` naming the cast when it is typed
(``dtype()``), before any device work.  ``TYPE_NAMES`` are the
reference's type names (``_TYPE_MAP``) of the types the port carries;
``type_of`` reads them, ``varchar(n)`` / ``char(n)`` (a STRING), and
``decimal(p, s)`` / ``numeric(p, s)`` (the reference's default
``decimal(10, 0)`` without them).
"""
from __future__ import annotations

import re

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn, null_column
from ..kernels import decimal as dk
from ..kernels import numtext
from .core import Expression, eval_as_column

#: the largest double below 2^63: every double up to it converts to an
#: int64 exactly (the reference's ``_float_to_i64_exact`` bound)
_I64_LIMIT = 9223372036854774784.0
_INT_BOUNDS = {T.INT32: (-(1 << 31), (1 << 31) - 1),
               T.INT64: (-(1 << 63), (1 << 63) - 1)}
_NUMBERS = (T.BOOL, T.INT32, T.INT64, T.FLOAT32, T.FLOAT64)
TYPE_NAMES = {"boolean": T.BOOL, "bool": T.BOOL, "int": T.INT32,
              "integer": T.INT32, "bigint": T.INT64, "long": T.INT64,
              "float": T.FLOAT32, "real": T.FLOAT32, "double": T.FLOAT64,
              "date": T.DATE, "string": T.STRING, "varchar": T.STRING}
_DECIMAL_NAME = re.compile(r"(decimal|numeric|dec)\s*(?:\(\s*(\d+)\s*"
                           r"(?:,\s*(\d+)\s*)?\))?")
_CHAR_NAME = re.compile(r"(var)?char\s*\(\s*\d+\s*\)")
#: the types a STRING casts to and from
_TEXT_TYPES = (T.BOOL, T.INT32, T.INT64, T.FLOAT32, T.FLOAT64, T.DATE)


def type_of(name: str) -> T.DType:
    """The type a name gives: ``TYPE_NAMES``, or ``decimal(p, s)``
    (``numeric``, ``dec``; precision 10 and scale 0 by default, as the
    reference's SQL).  Raises ``KeyError`` for any other name and
    ``ValueError`` for a precision DECIMAL64 does not hold."""
    name = name.strip().lower()
    if name in TYPE_NAMES:
        return TYPE_NAMES[name]
    if _CHAR_NAME.fullmatch(name):
        return T.STRING
    m = _DECIMAL_NAME.fullmatch(name)
    if m is None:
        raise KeyError(name)
    p = int(m.group(2)) if m.group(2) else 10
    return T.DecimalType(p, int(m.group(3) or 0))


def can_widen(src: T.DType, to: T.DType) -> bool:
    """Whether ``src`` widens to ``to`` without losing its kind."""
    if src == to or src == T.NULL:
        return True
    try:
        return T.common_type(src, to) == to
    except ValueError:
        return False


def can_cast(src: T.DType, to: T.DType) -> bool:
    """Whether the port casts ``src`` to ``to``."""
    if src == to or src == T.NULL:
        return True
    if src == T.STRING or to == T.STRING:
        other = to if src == T.STRING else src
        return other in _TEXT_TYPES or other.is_decimal
    return (src in _NUMBERS or src.is_decimal) and \
        (to in _NUMBERS or to.is_decimal)


def _float_to_int(a: torch.Tensor, to: T.DType) -> torch.Tensor:
    """Spark's float -> integer: NaN gives 0, the value truncates toward
    zero and saturates at ``to``'s bounds.  The clamp runs on integers:
    a narrower type's bound clamped in float space can land one ulp
    short (the reference's note)."""
    x = a.to(torch.float64)
    x = torch.trunc(torch.where(torch.isnan(x), 0.0, x))
    i64 = x.clamp(-_I64_LIMIT, _I64_LIMIT).to(torch.int64)
    lo, hi = _INT_BOUNDS[to]
    i64 = torch.where(x > _I64_LIMIT, (1 << 63) - 1, i64)
    i64 = torch.where(x < -_I64_LIMIT, -(1 << 63), i64)
    return i64.clamp(lo, hi).to(to.torch_dtype)


def cast_data(a: torch.Tensor, src: T.DType, to: T.DType) -> torch.Tensor:
    """The data of a cast of ``a`` (of ``src``) to ``to``."""
    if to == T.BOOL:
        return a if src == T.BOOL else a != 0
    if to.is_integral and src.is_fractional:
        return _float_to_int(a, to)
    # integers wrap (two's complement), floats round to the nearest
    return a.to(to.torch_dtype)


def _to_decimal(a: torch.Tensor, src: T.DType, to: T.DecimalType):
    """(unscaled data, fits) of a number cast to ``to``."""
    if src.is_decimal:
        return dk.rescale(a, src.scale, to.scale, to.precision)
    if src.is_fractional:
        return dk.from_double(a, to.scale, to.precision)
    return dk.scale_up(a.to(torch.int64), to.scale, to.precision)


def _from_decimal(a: torch.Tensor, src: T.DecimalType, to: T.DType):
    if to == T.BOOL:
        return a != 0
    if to.is_fractional:
        return dk.to_double(a, src.scale).to(to.torch_dtype)
    # Spark's toLong.toInt: the truncated long fits, an int wraps
    return dk.truncate(a, src.scale).to(to.torch_dtype)


def to_string(c: Column) -> StringColumn:
    """``c`` as text (``kernels/numtext.py``)."""
    dt, v = c.dtype, c.validity
    if dt.is_decimal:
        return numtext.format_decimal(c.data, v, dt.precision, dt.scale)
    if dt == T.BOOL:
        return numtext.format_bool(c.data, v)
    if dt == T.DATE:
        return numtext.format_date(c.data, v)
    if dt.is_fractional:
        return numtext.format_float(c.data, v)
    return numtext.format_integer(c.data, v, dt == T.INT64)


def from_string(c: StringColumn, to: T.DType) -> Column:
    """Text read as ``to``, NULL where it is not one
    (``kernels/numtext.py``)."""
    if to.is_decimal:
        data, ok = numtext.parse_decimal(c, to.precision, to.scale)
    elif to == T.BOOL:
        data, ok = numtext.parse_bool(c)
    elif to == T.DATE:
        data, ok = numtext.parse_date(c)
    elif to.is_fractional:
        data, ok = numtext.parse_float(c, to == T.FLOAT32)
    else:
        data, ok = numtext.parse_integer(c, to == T.INT64)
        data = data.to(to.torch_dtype)
    return Column(to, data, c.validity & ok)


def cast_column(c: Column, to: T.DType) -> Column:
    """``c`` cast to ``to``: a value a DECIMAL cannot hold becomes
    NULL."""
    if c.dtype == to:
        return c
    if c.dtype == T.NULL:
        return null_column(to, c.capacity, c.device)
    if to == T.STRING:
        return to_string(c)
    if c.dtype == T.STRING:
        return from_string(c, to)
    if to.is_decimal:
        data, ok = _to_decimal(c.data, c.dtype, to)
        return Column(to, data, c.validity & ok)
    if c.dtype.is_decimal:
        return Column(to, _from_decimal(c.data, c.dtype, to), c.validity)
    return Column(to, cast_data(c.data, c.dtype, to), c.validity)


def as_type(c: Column, to: T.DType) -> Column:
    """``c``'s values in ``to`` for an operator that has promoted its
    operands: a DECIMAL on either side casts (``cast_column``); any other
    number converts with torch's ``.to``, as before DECIMAL64 (an
    integer wraps, a float truncates)."""
    if c.dtype.is_decimal or to.is_decimal:
        return cast_column(c, to)
    return Column(to, c.data.to(to.torch_dtype), c.validity)


class Cast(Expression):
    def __init__(self, child: Expression, to: T.DType):
        self.children = [child]
        self.to = to

    def dtype(self):
        src = self.children[0].dtype()
        if not can_cast(src, self.to):
            raise NotImplementedError(f"CAST of a {src} to {self.to} is not "
                                      f"supported by the port")
        return self.to

    @property
    def nullable(self):
        return self.children[0].nullable

    def columnar_eval(self, batch):
        return cast_column(eval_as_column(self.children[0], batch), self.to)

    def __repr__(self):
        return f"cast({self.children[0]!r} as {self.to})"
