"""Expression framework core.

Counterpart of ``spark_rapids_tpu/expr/core.py``.  An expression is bound
(name -> column ordinal) before execution and evaluates against a batch
to a ``Column`` or a host ``Scalar``, with SQL three-valued-logic nulls
carried in the validity mask.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, List, Optional

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn


@dataclasses.dataclass
class Scalar:
    """A host scalar result or literal; ``value`` None means null."""
    dtype: T.DType
    value: Any

    def to_column(self, capacity: int, device) -> Column:
        if self.dtype == T.STRING:
            return StringColumn.from_scalar(self.value, self.dtype, capacity,
                                            device)
        return Column.from_scalar(self.value, self.dtype, capacity, device)


def as_column(x, batch) -> Column:
    if isinstance(x, Scalar):
        return x.to_column(batch.capacity, batch.device)
    return x


class Expression:
    children: List["Expression"] = []

    @property
    def name(self) -> str:
        return type(self).__name__

    def dtype(self) -> T.DType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return True

    def columnar_eval(self, batch):
        raise NotImplementedError

    def bind(self, schema) -> "Expression":
        """Replace AttributeReferences by BoundReferences (ordinals)."""
        return self.map_children(lambda c: c.bind(schema))

    def map_children(self, fn) -> "Expression":
        if not self.children:
            return self
        new = [fn(c) for c in self.children]
        if all(a is b for a, b in zip(new, self.children)):
            return self
        return self.with_children(new)

    def with_children(self, children: List["Expression"]) -> "Expression":
        clone = self.__class__.__new__(self.__class__)
        clone.__dict__.update(self.__dict__)
        clone.children = list(children)
        return clone

    def collect(self, pred) -> List["Expression"]:
        out = [self] if pred(self) else []
        for c in self.children:
            out.extend(c.collect(pred))
        return out

    def __repr__(self):
        if self.children:
            return f"{self.name}({', '.join(map(repr, self.children))})"
        return self.name


class AttributeReference(Expression):
    """Column reference by name; typed once resolved against a schema."""

    def __init__(self, col_name: str, dt: Optional[T.DType] = None,
                 nullable: bool = True):
        self.col_name = col_name
        self._dtype = dt
        self._nullable = nullable
        self.children = []

    @property
    def name(self):
        return self.col_name

    def dtype(self):
        if self._dtype is None:
            raise ValueError(f"unresolved attribute {self.col_name}")
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def resolve(self, schema) -> "AttributeReference":
        f = schema[self.col_name]
        return AttributeReference(self.col_name, f.dtype, f.nullable)

    def bind(self, schema) -> "BoundReference":
        idx = schema.index_of(self.col_name)
        f = schema[idx]
        return BoundReference(idx, f.dtype, f.nullable, self.col_name)

    def columnar_eval(self, batch):
        return batch.columns[batch.schema.index_of(self.col_name)]

    def __repr__(self):
        return f"col({self.col_name})"


class BoundReference(Expression):
    """Column reference by ordinal."""

    def __init__(self, ordinal: int, dt: T.DType, nullable: bool = True,
                 col_name: str = ""):
        self.ordinal = ordinal
        self._dtype = dt
        self._nullable = nullable
        self.col_name = col_name
        self.children = []

    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def bind(self, schema):
        return self

    def columnar_eval(self, batch):
        return batch.columns[self.ordinal]

    def __repr__(self):
        return f"input[{self.ordinal}:{self.col_name}]"


class Literal(Expression):
    """A constant; a ``datetime.date`` is a DATE literal (SQL's ``DATE
    'yyyy-mm-dd'``, and the null-safe keys' default)."""

    def __init__(self, value, dt: Optional[T.DType] = None):
        if dt is None:
            if value is None:
                dt = T.NULL
            elif isinstance(value, bool):
                dt = T.BOOL
            elif isinstance(value, int):
                dt = T.INT64
            elif isinstance(value, float):
                dt = T.FLOAT64
            elif isinstance(value, str):
                dt = T.STRING
            elif isinstance(value, datetime.date) and \
                    not isinstance(value, datetime.datetime):
                dt = T.DATE
            else:
                raise ValueError(f"cannot infer literal type for {value!r}")
        self.value = value
        self._dtype = dt
        self.children = []

    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def columnar_eval(self, batch):
        return Scalar(self._dtype, self.value)

    def __repr__(self):
        return f"lit({self.value!r})"


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        self.children = [child]
        self.alias = alias

    @property
    def name(self):
        return self.alias

    def dtype(self):
        return self.children[0].dtype()

    @property
    def nullable(self):
        return self.children[0].nullable

    def columnar_eval(self, batch):
        return self.children[0].columnar_eval(batch)

    def __repr__(self):
        return f"{self.children[0]!r} AS {self.alias}"


def output_name(e: Expression) -> str:
    if isinstance(e, Alias):
        return e.alias
    if isinstance(e, (AttributeReference, BoundReference)):
        return e.col_name
    return repr(e)


def eval_as_column(expr: Expression, batch) -> Column:
    """Evaluate to a Column, broadcasting scalars to the batch capacity."""
    return as_column(expr.columnar_eval(batch), batch)
