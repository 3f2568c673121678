"""Numeric widening casts.

Trimmed counterpart of ``spark_rapids_tpu/expr/cast.py``'s ``Cast``: only
the widenings the port makes itself, from one numeric type to a wider one
in ``dtypes.common_type``'s order (int32 -> int64 -> float32 -> float64),
or from a bare NULL to any type.  Comparisons and join keys widen their
narrower side, and a union widens each child's columns to the union's
types, as Spark does.  Every other cast, and ``CAST`` in SQL text, is not
ported.
"""
from __future__ import annotations

from ..columnar import dtypes as T
from ..columnar.column import Column
from .core import Expression, eval_as_column


def can_widen(src: T.DType, to: T.DType) -> bool:
    """Whether ``src`` widens to ``to`` without losing its kind."""
    if src == to or src == T.NULL:
        return True
    try:
        return T.common_type(src, to) == to
    except ValueError:
        return False


class Cast(Expression):
    def __init__(self, child: Expression, to: T.DType):
        src = child.dtype()
        if not can_widen(src, to):
            raise NotImplementedError(f"a cast of {src} to {to} is not "
                                      f"ported (only numeric widenings)")
        self.children = [child]
        self.to = to

    def dtype(self):
        return self.to

    @property
    def nullable(self):
        return self.children[0].nullable

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        if c.dtype == self.to:
            return c
        return Column(self.to, c.data.to(self.to.torch_dtype), c.validity)

    def __repr__(self):
        return f"cast({self.children[0]!r} as {self.to})"
