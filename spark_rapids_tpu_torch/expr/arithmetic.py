"""Arithmetic and math: +, -, *, /, ``div``, %, ``pmod``, unary minus
and plus, ``abs``, ``round``, the double-valued math functions,
``signum``, ``floor``, ``ceil``, ``pow``, ``atan2``, ``greatest``,
``least``, and the bitwise and shift operators, with Spark's null and
type rules.

Counterpart of ``spark_rapids_tpu/expr/arithmetic.py``.  Operands promote
to their common type (int < bigint < float < double); ``/`` is always
double; a null operand gives null, and so does a zero divisor of ``/``,
``div``, ``%`` and ``pmod``.  Integer results wrap (two's complement), as
in non-ANSI Spark.

A DECIMAL operand of ``+``, ``-`` and ``*`` gives a DECIMAL computed on
the unscaled int64s (``kernels/decimal.py``) with the reference's result
types, capped at 18 digits: ``*`` ``decimal(min(p1 + p2, 18), s1 + s2)``,
``+`` / ``-`` the larger scale and one digit past the wider integer
part (the reference's ``max(p1, p2) + 1`` where the scales are equal;
an integer counts 19 digits, as there).  A result that does not fit is
NULL.  ``/`` of a DECIMAL, and any operator of a DECIMAL and a float,
is a double of the operands' values (the reference divides and mixes
the unscaled ints: ``1.50 / 0.5`` is 30.0 there).  ``div``, ``%``,
``pmod`` and the bitwise operators refuse a DECIMAL.

Four answers are Spark's where the reference's are not: an integer
quotient or remainder is exact (the reference truncates an f64 division,
inexact past 2^53); ``pmod`` with a negative divisor is Spark's ``(r +
n) % n`` (the reference adds ``|n|``: ``pmod(-7, -3)`` is 2 there, -1 in
Spark); a logarithm at or below its asymptote is null (the reference's
``ln(0)`` is -inf); and ``greatest`` / ``least`` order a NaN above
every number (the reference never takes a NaN after the first
argument).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column
from ..kernels import decimal as dk
from .cast import _float_to_int, as_type
from .core import Expression, eval_as_column

_MAX_DIGITS = T.DecimalType.MAX_PRECISION


def _digits(t: T.DType):
    """(precision, scale) of a DECIMAL operand; an integer counts 19
    digits, as the reference's ``_prec``."""
    return (t.precision, t.scale) if t.is_decimal else (19, 0)


def decimal_result(symbol: str, lt: T.DType, rt: T.DType) -> T.DType:
    """The DECIMAL of ``lt symbol rt`` (``+``, ``-`` or ``*``)."""
    (pa_, sa), (pb, sb) = _digits(lt), _digits(rt)
    if symbol == "*":
        if sa + sb > _MAX_DIGITS:
            raise NotImplementedError(f"a DECIMAL product of scale "
                                      f"{sa + sb} is past DECIMAL64's "
                                      f"{_MAX_DIGITS} digits")
        return T.DecimalType(min(_MAX_DIGITS, pa_ + pb), sa + sb)
    scale = max(sa, sb)
    whole = max(pa_ - sa, pb - sb)
    return T.DecimalType(min(_MAX_DIGITS, whole + scale + 1), scale)


class BinaryArithmetic(Expression):
    symbol = "?"
    #: whether a DECIMAL operand gives a DECIMAL (``+``, ``-``, ``*``)
    decimal_op = False

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def result_type(self, lt: T.DType, rt: T.DType) -> T.DType:
        if (lt.is_decimal or rt.is_decimal) and T.NULL not in (lt, rt):
            if lt.is_fractional or rt.is_fractional:
                return T.FLOAT64
            if not self.decimal_op or not (lt.is_numeric or lt == T.BOOL) \
                    or not (rt.is_numeric or rt == T.BOOL):
                raise NotImplementedError(
                    f"{self.symbol} of a {lt} and a {rt} is not supported "
                    f"by the port")
            return decimal_result(self.symbol, lt, rt)
        return T.common_type(lt, rt)

    def dtype(self):
        return self.result_type(self.children[0].dtype(),
                                self.children[1].dtype())

    def op(self, a, b):
        raise NotImplementedError

    def extra_null_mask(self, a, b):
        return None

    def columnar_eval(self, batch):
        lc = eval_as_column(self.children[0], batch)
        rc = eval_as_column(self.children[1], batch)
        out_t = self.dtype()
        if out_t.is_decimal:
            return self._decimal_eval(lc, rc, out_t)
        a = as_type(lc, out_t).data
        b = as_type(rc, out_t).data
        valid = lc.validity & rc.validity
        extra = self.extra_null_mask(a, b)
        if extra is not None:
            valid = valid & ~extra
        return Column(out_t, self.op(a, b), valid)

    def _decimal_eval(self, lc: Column, rc: Column, out_t: T.DecimalType):
        """``+``, ``-``, ``*`` on the unscaled int64s; NULL where the
        result does not fit ``out_t``."""
        a, b = lc.data.to(torch.int64), rc.data.to(torch.int64)
        valid = lc.validity & rc.validity
        if self.symbol == "*":
            data, ok = dk.mul_checked(a, b, out_t.precision)
            return Column(out_t, data, valid & ok)
        s = out_t.scale
        a, oka = dk.scale_up(a, s - _digits(lc.dtype)[1], _MAX_DIGITS)
        b, okb = dk.scale_up(b, s - _digits(rc.dtype)[1], _MAX_DIGITS)
        data = self.op(a, b)
        return Column(out_t, data,
                      valid & oka & okb & dk.fits(data, out_t.precision))

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class Add(BinaryArithmetic):
    symbol = "+"
    decimal_op = True

    def op(self, a, b):
        return a + b


class Subtract(BinaryArithmetic):
    symbol = "-"
    decimal_op = True

    def op(self, a, b):
        return a - b


class Multiply(BinaryArithmetic):
    symbol = "*"
    decimal_op = True

    def op(self, a, b):
        return a * b


class Divide(BinaryArithmetic):
    """Spark's ``/``: double whatever the operands; a zero divisor gives
    null."""
    symbol = "/"

    def result_type(self, lt, rt):
        return T.FLOAT64

    def op(self, a, b):
        return a / torch.where(b == 0, torch.ones_like(b), b)

    def extra_null_mask(self, a, b):
        return b == 0


class IntegralDivide(BinaryArithmetic):
    """Spark's ``div``: a bigint quotient truncated toward zero, exact on
    the int64 values; a zero divisor gives null."""
    symbol = "div"

    def result_type(self, lt, rt):
        if lt.is_decimal or rt.is_decimal:
            raise NotImplementedError("div of a DECIMAL is not supported by "
                                      "the port")
        return T.INT64

    def op(self, a, b):
        safe_b = torch.where(b == 0, torch.ones_like(b), b)
        return torch.div(a, safe_b, rounding_mode="trunc")

    def extra_null_mask(self, a, b):
        return b == 0


class Remainder(BinaryArithmetic):
    """Java remainder: the sign follows the dividend; a zero divisor
    gives null."""
    symbol = "%"

    def op(self, a, b):
        safe_b = torch.where(b == 0, torch.ones_like(b), b)
        return torch.fmod(a, safe_b)

    def extra_null_mask(self, a, b):
        return b == 0


class Pmod(BinaryArithmetic):
    """Spark's ``pmod(a, n)``: ``r = a % n``, and ``(r + n) % n`` where
    ``r`` is negative (Java remainders throughout); a zero divisor gives
    null."""
    symbol = "pmod"

    def op(self, a, b):
        safe_b = torch.where(b == 0, torch.ones_like(b), b)
        r = torch.fmod(a, safe_b)
        return torch.where(r < 0, torch.fmod(r + safe_b, safe_b), r)

    def extra_null_mask(self, a, b):
        return b == 0

    def __repr__(self):
        return f"pmod({self.children[0]!r}, {self.children[1]!r})"


class UnaryExpression(Expression):
    """A function of one column, row by row, nulls kept: ``op`` maps the
    child's data to the data of ``dtype()``."""

    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return self.children[0].dtype()

    def op(self, a: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        return Column(self.dtype(), self.op(c.data), c.validity)

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


class UnaryMinus(UnaryExpression):
    def op(self, a):
        return -a

    def __repr__(self):
        return f"(- {self.children[0]!r})"


class UnaryPositive(UnaryExpression):
    def op(self, a):
        return a


class Abs(UnaryExpression):
    """``abs(x)`` of a number, in its own type (the most negative integer
    wraps to itself, as in non-ANSI Spark)."""

    def op(self, a):
        return a.abs()


class _MathUnary(UnaryExpression):
    """A double-valued function of a number (``fn`` over its f64 value).
    The logarithms are null at or below their asymptote (``floor``:
    Spark's ``UnaryLogExpression``; the reference answers -inf or NaN)."""
    fn: Callable = staticmethod(torch.sqrt)
    floor = None

    def dtype(self):
        return T.FLOAT64

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        x = as_type(c, T.FLOAT64).data
        valid = c.validity if self.floor is None else \
            c.validity & (x > self.floor)
        return Column(T.FLOAT64, type(self).fn(x), valid)


def _make_math(name: str, fn, floor=None) -> type:
    return type(name, (_MathUnary,), {"fn": staticmethod(fn),
                                      "floor": floor})


Sqrt = _make_math("Sqrt", torch.sqrt)
Exp = _make_math("Exp", torch.exp)
Expm1 = _make_math("Expm1", torch.expm1)
Log = _make_math("Log", torch.log, 0.0)
Log1p = _make_math("Log1p", torch.log1p, -1.0)
Log2 = _make_math("Log2", torch.log2, 0.0)
Log10 = _make_math("Log10", torch.log10, 0.0)
Sin = _make_math("Sin", torch.sin)
Cos = _make_math("Cos", torch.cos)
Tan = _make_math("Tan", torch.tan)
Asin = _make_math("Asin", torch.asin)
Acos = _make_math("Acos", torch.acos)
Atan = _make_math("Atan", torch.atan)
Sinh = _make_math("Sinh", torch.sinh)
Cosh = _make_math("Cosh", torch.cosh)
Tanh = _make_math("Tanh", torch.tanh)
Asinh = _make_math("Asinh", torch.asinh)
Acosh = _make_math("Acosh", torch.acosh)
Atanh = _make_math("Atanh", torch.atanh)
Cbrt = _make_math("Cbrt", lambda a: torch.sign(a) * a.abs().pow(1.0 / 3))
ToDegrees = _make_math("ToDegrees", lambda a: a * (180.0 / math.pi))
ToRadians = _make_math("ToRadians", lambda a: a * (math.pi / 180.0))
Rint = _make_math("Rint", torch.round)


class Signum(UnaryExpression):
    """-1.0, 0.0 or 1.0 as a double (NaN stays NaN)."""

    def dtype(self):
        return T.FLOAT64

    def op(self, a):
        return torch.sign(a.to(torch.float64))  # a DECIMAL's sign too


class Floor(UnaryExpression):
    """An integer unchanged; a float's floor as a bigint (Spark's cast:
    NaN gives 0, the value saturates); a DECIMAL's as a bigint, on the
    unscaled int64."""
    ceil = False

    def dtype(self):
        ct = self.children[0].dtype()
        return ct if ct.is_integral else T.INT64

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        if not c.dtype.is_decimal:
            return super().columnar_eval(batch)
        m = 10 ** c.dtype.scale
        x = -c.data if self.ceil else c.data
        q = torch.div(x, m, rounding_mode="floor")
        return Column(T.INT64, -q if self.ceil else q, c.validity)

    def op(self, a):
        if not a.is_floating_point():
            return a
        return _float_to_int(torch.floor(a.to(torch.float64)), T.INT64)


class Ceil(Floor):
    """An integer unchanged; a float's ceiling as a bigint."""
    ceil = True

    def op(self, a):
        if not a.is_floating_point():
            return a
        return _float_to_int(torch.ceil(a.to(torch.float64)), T.INT64)


class Round(Expression):
    """``round(x, scale)``, Spark's HALF_UP (ties away from zero), as the
    reference computes it: ``sign(v) * floor(|v| * 10^scale + 0.5) /
    10^scale`` in double, back to the input's type; an integer with a
    scale of at least 0 is unchanged."""

    def __init__(self, child: Expression, scale: int = 0):
        self.children = [child]
        self.scale = int(scale)

    def dtype(self):
        return self.children[0].dtype()

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        if c.dtype.is_integral and self.scale >= 0:
            return c
        if c.dtype.is_decimal:
            # HALF_UP on the unscaled int64, in the input's type
            cut = c.dtype.scale - self.scale
            if cut <= 0:
                return c
            if cut > c.dtype.precision:
                return Column(c.dtype, torch.zeros_like(c.data), c.validity)
            data = dk.scale_down(c.data, cut) * (10 ** cut)
            return Column(c.dtype, data, c.validity &
                          dk.fits(data, c.dtype.precision))
        mult = 10.0 ** self.scale
        scaled = c.data.to(torch.float64) * mult
        out = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5) / mult
        return Column(c.dtype, out.to(c.dtype.torch_dtype), c.validity)

    def __repr__(self):
        return f"round({self.children[0]!r}, {self.scale})"


class Pow(BinaryArithmetic):
    """``pow(a, b)`` in double."""
    symbol = "**"

    def result_type(self, lt, rt):
        return T.FLOAT64

    def op(self, a, b):
        return torch.pow(a, b)


class Atan2(BinaryArithmetic):
    symbol = "atan2"

    def result_type(self, lt, rt):
        return T.FLOAT64

    def op(self, a, b):
        return torch.atan2(a, b)

    def __repr__(self):
        return f"atan2({self.children[0]!r}, {self.children[1]!r})"


class Greatest(Expression):
    """The largest non-null argument, in the arguments' common type
    (null only where every argument is); a NaN is the largest double,
    and strings compare in byte order."""
    take_larger = True

    def __init__(self, *children: Expression):
        self.children = list(children)

    def dtype(self):
        dt = self.children[0].dtype()
        for c in self.children[1:]:
            dt = T.common_type(dt, c.dtype())
        return dt

    def _beats(self, a, best):
        if a.is_floating_point():
            # Spark's order: NaN above every number
            an, bn = torch.isnan(a), torch.isnan(best)
            gt = (a > best) | (an & ~bn)
            lt = (a < best) | (bn & ~an)
        else:
            gt, lt = a > best, a < best
        return gt if self.take_larger else lt

    def columnar_eval(self, batch):
        out_t = self.dtype()
        if out_t == T.STRING:
            from ..columnar.column import StringColumn, null_column
            from ..kernels.strings import extreme
            cols = [eval_as_column(ch, batch) for ch in self.children]
            return extreme([c if isinstance(c, StringColumn) else
                            null_column(T.STRING, batch.capacity,
                                        batch.device) for c in cols],
                           self.take_larger)
        best = bestv = None
        for ch in self.children:
            c = as_type(eval_as_column(ch, batch), out_t)
            a = c.data
            if best is None:
                best, bestv = a, c.validity
                continue
            take = c.validity & (~bestv | self._beats(a, best))
            best = torch.where(take, a, best)
            bestv = bestv | c.validity
        return Column(out_t, best, bestv)

    def __repr__(self):
        name = "greatest" if self.take_larger else "least"
        return f"{name}({', '.join(map(repr, self.children))})"


class Least(Greatest):
    """The smallest non-null argument (a NaN only where it is the only
    value)."""
    take_larger = False


class BitwiseAnd(BinaryArithmetic):
    symbol = "&"

    def op(self, a, b):
        return a & b


class BitwiseOr(BinaryArithmetic):
    symbol = "|"

    def op(self, a, b):
        return a | b


class BitwiseXor(BinaryArithmetic):
    symbol = "^"

    def op(self, a, b):
        return a ^ b


class BitwiseNot(UnaryExpression):
    def op(self, a):
        return ~a


class _Shift(BinaryArithmetic):
    """A shift of the left operand by the right one modulo its width, in
    the left operand's type (Java's rule)."""

    def result_type(self, lt, rt):
        if lt.is_decimal or rt.is_decimal:
            raise NotImplementedError("a shift of a DECIMAL is not "
                                      "supported by the port")
        return lt

    def columnar_eval(self, batch):
        lc = eval_as_column(self.children[0], batch)
        rc = eval_as_column(self.children[1], batch)
        bits = 64 if lc.data.dtype == torch.int64 else 32
        n = rc.data.to(torch.int64) & (bits - 1)
        return Column(lc.dtype, self.shift(lc.data.to(torch.int64), n, bits)
                      .to(lc.data.dtype), lc.validity & rc.validity)


class ShiftLeft(_Shift):
    symbol = "<<"

    @staticmethod
    def shift(a, n, bits):
        return a << n              # an int32 result wraps in the cast


class ShiftRight(_Shift):
    symbol = ">>"

    @staticmethod
    def shift(a, n, bits):
        return a >> n


class ShiftRightUnsigned(_Shift):
    symbol = ">>>"

    @staticmethod
    def shift(a, n, bits):
        if bits == 32:
            return (a & 0xFFFFFFFF) >> n
        # int64: an arithmetic shift with the copies of the sign cleared
        keep = (torch.ones_like(a) << (64 - n).clamp(max=63)) - 1
        return torch.where(n == 0, a, (a >> n) & keep)
