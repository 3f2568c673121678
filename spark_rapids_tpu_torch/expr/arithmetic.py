"""Arithmetic: +, -, *, /, %, unary minus, ``abs`` and ``round`` with
Spark's null and type rules.

Counterpart of ``spark_rapids_tpu/expr/arithmetic.py``.  Operands promote
to their common type (int < bigint < float < double); ``/`` is always
double; a null operand gives null, and so does a zero divisor of ``/``
and ``%``.  Integer results wrap (two's complement), as in non-ANSI
Spark.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column
from .core import Expression, eval_as_column


class BinaryArithmetic(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def result_type(self, lt: T.DType, rt: T.DType) -> T.DType:
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
        a = lc.data.to(out_t.torch_dtype)
        b = rc.data.to(out_t.torch_dtype)
        valid = lc.validity & rc.validity
        extra = self.extra_null_mask(a, b)
        if extra is not None:
            valid = valid & ~extra
        return Column(out_t, self.op(a, b), valid)

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class Add(BinaryArithmetic):
    symbol = "+"

    def op(self, a, b):
        return a + b


class Subtract(BinaryArithmetic):
    symbol = "-"

    def op(self, a, b):
        return a - b


class Multiply(BinaryArithmetic):
    symbol = "*"

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


class Remainder(BinaryArithmetic):
    """Java remainder: the sign follows the dividend; a zero divisor
    gives null."""
    symbol = "%"

    def op(self, a, b):
        safe_b = torch.where(b == 0, torch.ones_like(b), b)
        return torch.fmod(a, safe_b)

    def extra_null_mask(self, a, b):
        return b == 0


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return self.children[0].dtype()

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        return Column(c.dtype, -c.data, c.validity)

    def __repr__(self):
        return f"(- {self.children[0]!r})"


class Abs(Expression):
    """``abs(x)`` of a number, in its own type (the most negative integer
    wraps to itself, as in non-ANSI Spark)."""

    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return self.children[0].dtype()

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        return Column(c.dtype, c.data.abs(), c.validity)

    def __repr__(self):
        return f"abs({self.children[0]!r})"


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
        mult = 10.0 ** self.scale
        scaled = c.data.to(torch.float64) * mult
        out = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5) / mult
        return Column(c.dtype, out.to(c.dtype.torch_dtype), c.validity)

    def __repr__(self):
        return f"round({self.children[0]!r}, {self.scale})"
