"""Logical plan nodes built by the DataFrame API.

Counterpart of ``spark_rapids_tpu/plan/logical.py``, limited to the nodes
the port plans: local relation, project, filter, aggregate and join.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import pyarrow as pa

from ..columnar.arrow import schema_from_arrow
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
