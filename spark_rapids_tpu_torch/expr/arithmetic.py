"""Arithmetic: +, -, *, /, % and unary minus with Spark's null and type
rules.

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
