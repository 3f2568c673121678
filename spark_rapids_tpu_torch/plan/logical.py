"""Logical plan nodes built by the DataFrame API.

Counterpart of ``spark_rapids_tpu/plan/logical.py``, limited to the nodes
the port plans: local relation, file scan, project, filter, aggregate,
join, sort, limit, union, distinct and window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import pyarrow as pa

from ..columnar.arrow import empty_table, schema_from_arrow
from ..columnar.dtypes import common_type
from ..columnar.schema import Field, Schema
from ..expr import core as ec
from ..expr.aggregates import AggregateFunction
from ..expr.predicates import promote_comparison_sides


class LogicalPlan:
    children: List["LogicalPlan"] = []

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def estimated_rows(self) -> int:
        return max((c.estimated_rows() for c in self.children), default=0)


class LocalRelation(LogicalPlan):
    """An in-memory arrow table split into ``num_partitions``.  Uploaded
    device batches are kept here, per (device, batch rows), so repeated
    queries over one DataFrame upload once."""

    def __init__(self, table: pa.Table, num_partitions: int = 1):
        self.table = table
        self.num_partitions = max(1, num_partitions)
        self.children = []
        self.device_cache: Dict[tuple, list] = {}

    @property
    def schema(self):
        return schema_from_arrow(self.table.schema)

    def estimated_rows(self):
        return self.table.num_rows


class EmptyRelation(LocalRelation):
    """No rows of ``schema``: what the optimizer leaves of a filter that
    no row passes (``logical_opt._fold_constants``)."""

    def __init__(self, schema: Schema):
        super().__init__(empty_table(schema))
        self._schema = schema

    @property
    def schema(self):
        return self._schema


class Scan(LogicalPlan):
    """A scan of Parquet files (paths are files or directories of part
    files).  ``schema`` is the columns the scan reads: the optimizer
    narrows it to what the plan above needs (``prune_scan_columns``)."""

    def __init__(self, paths: List[str], schema: Schema):
        self.paths = list(paths)
        self._schema = schema
        self.children = []
        self._rows: Optional[int] = None

    @property
    def schema(self):
        return self._schema

    def estimated_rows(self):
        """Row count from the files' Parquet footers (read once)."""
        if self._rows is None:
            import pyarrow.parquet as papq
            from ..io.readers import expand_paths
            self._rows = sum(papq.ParquetFile(f).metadata.num_rows
                             for f in expand_paths(self.paths))
        return self._rows


class Project(LogicalPlan):
    def __init__(self, exprs: List[ec.Expression], child: LogicalPlan):
        self.exprs = exprs
        self.children = [child]

    @property
    def schema(self):
        return Schema(Field(ec.output_name(e), e.dtype(), e.nullable)
                      for e in self.exprs)


class Filter(LogicalPlan):
    def __init__(self, condition: ec.Expression, child: LogicalPlan):
        self.condition = condition
        self.children = [child]

    @property
    def schema(self):
        return self.children[0].schema


class AggExpr:
    def __init__(self, func: AggregateFunction, alias: str):
        self.func = func
        self.alias = alias

    def __repr__(self):
        return f"{self.func!r} AS {self.alias}"


class Aggregate(LogicalPlan):
    def __init__(self, group_exprs: List[ec.Expression], aggs: List[AggExpr],
                 child: LogicalPlan):
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.children = [child]

    @property
    def schema(self):
        fields = [Field(ec.output_name(e), e.dtype(), True)
                  for e in self.group_exprs]
        fields += [Field(a.alias, a.func.dtype(), a.func.nullable)
                   for a in self.aggs]
        return Schema(fields)


JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti", "cross")


def join_schema(how: str, left: Schema, right: Schema) -> Schema:
    """Output schema of a join: semi/anti keep the left side alone; the
    side an outer join does not preserve becomes nullable."""
    if how in ("semi", "anti"):
        return left
    lfields, rfields = list(left), list(right)
    if how in ("left", "full"):
        rfields = [Field(f.name, f.dtype, True) for f in rfields]
    if how in ("right", "full"):
        lfields = [Field(f.name, f.dtype, True) for f in lfields]
    return Schema(lfields + rfields)


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, how: str,
                 left_keys: List[ec.Expression],
                 right_keys: List[ec.Expression],
                 condition: Optional[ec.Expression] = None):
        if how not in JOIN_TYPES:
            raise ValueError(f"join type {how!r}; expected one of "
                             f"{JOIN_TYPES}")
        self.how = how
        # each key pair shares one dtype, or the two sides' canonical key
        # words (and partition ids) would not compare
        pairs = [promote_comparison_sides(lk, rk)
                 for lk, rk in zip(left_keys, right_keys)]
        self.left_keys = [lk for lk, _ in pairs]
        self.right_keys = [rk for _, rk in pairs]
        self.condition = condition
        self.children = [left, right]

    @property
    def schema(self):
        return join_schema(self.how, self.children[0].schema,
                           self.children[1].schema)


@dataclasses.dataclass
class SortOrder:
    """One sort key; ``nulls_first`` defaults to Spark's: first when
    ascending, last when descending."""
    expr: ec.Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None

    def __post_init__(self):
        if self.nulls_first is None:
            self.nulls_first = self.ascending


class Sort(LogicalPlan):
    """A global sort of the child's rows."""

    def __init__(self, orders: List[SortOrder], child: LogicalPlan):
        self.orders = orders
        self.children = [child]

    @property
    def schema(self):
        return self.children[0].schema


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.children = [child]

    @property
    def schema(self):
        return self.children[0].schema

    def estimated_rows(self):
        return self.n


class Union(LogicalPlan):
    """UNION ALL under the first child's names.  Each column takes the
    widest of the children's types, as Spark widens a union
    (``union_types``), and is nullable if it is in any child."""

    def __init__(self, children: List[LogicalPlan]):
        self.children = list(children)
        union_types([c.schema for c in self.children])

    @property
    def schema(self):
        schemas = [c.schema for c in self.children]
        return Schema(Field(f.name, t, any(s[i].nullable for s in schemas))
                      for i, (f, t) in enumerate(zip(schemas[0],
                                                     union_types(schemas))))

    def estimated_rows(self):
        return sum(c.estimated_rows() for c in self.children)


def union_types(schemas: List[Schema]):
    """Per column, the type every child widens to: the wider of two
    numeric types (int32 < int64 < float32 < float64), the other type
    for a NULL column.  Children of other column counts, or a column
    with no such type (a string against a number, a date against
    either), raise ``ValueError``; the reference casts every child to
    the first child's types instead, narrowing a double to a bigint."""
    widths = {len(s) for s in schemas}
    if len(widths) != 1:
        raise ValueError(f"a union's children have {sorted(widths)} "
                         f"columns")
    out = []
    for i, f in enumerate(schemas[0]):
        t = f.dtype
        for s in schemas[1:]:
            try:
                t = common_type(t, s[i].dtype)
            except ValueError:
                raise ValueError(f"a union's column {i + 1} ({f.name}) is "
                                 f"{t} in one child and {s[i].dtype} in "
                                 f"another: no common type") from None
        out.append(t)
    return out


class Distinct(LogicalPlan):
    """The distinct rows of the child (``SELECT DISTINCT``, and UNION,
    INTERSECT and EXCEPT without ALL); planned as an aggregate grouped by
    every column."""

    def __init__(self, child: LogicalPlan):
        self.children = [child]

    @property
    def schema(self):
        return self.children[0].schema


@dataclasses.dataclass
class WindowSpec:
    """PARTITION BY, ORDER BY and the frame ``(kind, lo, hi)``: ``kind``
    "rows" (offsets in rows) or "range" (offsets in the order key's
    values), ``lo`` / ``hi`` offsets from the current row (negative
    preceding, 0 the current row; for RANGE, its peers), None
    unbounded."""
    partition_by: List[ec.Expression]
    order_by: List[SortOrder]
    frame: Tuple[str, Optional[int], Optional[int]] = ("rows", None, None)

    def sort_key(self) -> str:
        """Specs of one key sort their rows the same way."""
        return repr(([repr(e) for e in self.partition_by],
                     [(repr(o.expr), o.ascending, o.nulls_first)
                      for o in self.order_by]))


class WindowFunc:
    """A window function (or an aggregate over a window), its spec and
    the name of the column it adds."""

    def __init__(self, func: ec.Expression, spec: WindowSpec, alias: str):
        self.func = func
        self.spec = spec
        self.alias = alias

    def __repr__(self):
        return f"{self.func!r} OVER {self.spec.frame} AS {self.alias}"


class Window(LogicalPlan):
    """The child's columns and one more per window function."""

    def __init__(self, window_funcs: List[WindowFunc], child: LogicalPlan):
        self.window_funcs = window_funcs
        self.children = [child]

    @property
    def schema(self):
        base = list(self.children[0].schema)
        return Schema(base + [Field(wf.alias, wf.func.dtype(), True)
                              for wf in self.window_funcs])
