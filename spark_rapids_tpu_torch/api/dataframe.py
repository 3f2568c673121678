"""DataFrame API: the PySpark-flavoured surface that builds logical plans.

Counterpart of ``spark_rapids_tpu/api/dataframe.py`` (select,
with_column, filter, group_by().agg(), join, collect, to_arrow).
"""
from __future__ import annotations

from typing import List

import pyarrow as pa

from ..columnar.schema import Schema
from ..expr import aggregates as eagg
from ..expr import core as ec
from ..expr import predicates as ep
from ..plan import logical as L
from .column import Col


def _resolve(expr: ec.Expression, schema: Schema) -> ec.Expression:
    """Type AttributeReferences against a schema."""
    if isinstance(expr, ec.AttributeReference) and expr._dtype is None:
        return expr.resolve(schema)
    return expr.map_children(lambda c: _resolve(c, schema))


def _to_expr(c, schema: Schema) -> ec.Expression:
    if isinstance(c, str):
        return ec.AttributeReference(c).resolve(schema)
    if isinstance(c, Col):
        return _resolve(c.expr, schema)
    if isinstance(c, ec.Expression):
        return _resolve(c, schema)
    return ec.Literal(c)


class DataFrame:
    def __init__(self, logical: L.LogicalPlan, session):
        self._plan = logical
        self.session = session

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    def __getitem__(self, name: str) -> Col:
        f = self.schema[name]
        return Col(ec.AttributeReference(f.name, f.dtype, f.nullable))

    def select(self, *cols) -> "DataFrame":
        exprs = [_to_expr(c, self.schema) for c in cols]
        return DataFrame(L.Project(exprs, self._plan), self.session)

    def with_column(self, name: str, col) -> "DataFrame":
        e = _to_expr(col, self.schema)
        exprs, replaced = [], False
        for f in self.schema:
            if f.name == name:
                exprs.append(ec.Alias(e, name))
                replaced = True
            else:
                exprs.append(ec.AttributeReference(f.name, f.dtype,
                                                   f.nullable))
        if not replaced:
            exprs.append(ec.Alias(e, name))
        return DataFrame(L.Project(exprs, self._plan), self.session)

    withColumn = with_column

    def filter(self, cond) -> "DataFrame":
        return DataFrame(L.Filter(_to_expr(cond, self.schema), self._plan),
                         self.session)

    where = filter

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, [_to_expr(c, self.schema) for c in cols])

    groupBy = group_by

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join on a condition (``Col``: its equalities between the two
        sides become keys, the rest a residual condition) or on column
        names both sides share (the right side's copies are dropped, as
        Spark does).  Cross joins are planned but not ported: planning
        one raises."""
        how = _JOIN_ALIASES.get(how, how)
        if how == "cross" or on is None:
            return DataFrame(L.Join(self._plan, other._plan, "cross", [], []),
                             self.session)
        if isinstance(on, str):
            on = [on]
        if isinstance(on, (list, tuple)) and all(isinstance(x, str)
                                                 for x in on):
            joined = L.Join(self._plan, other._plan, how,
                            [_to_expr(k, self.schema) for k in on],
                            [_to_expr(k, other.schema) for k in on])
            if how in ("semi", "anti"):
                return DataFrame(joined, self.session)
            nleft = len(self.schema)
            dropped = set(on)
            out = []
            for i, f in enumerate(joined.schema):
                if i >= nleft and f.name in dropped:
                    dropped.discard(f.name)
                    continue
                out.append(ec.BoundReference(i, f.dtype, f.nullable, f.name))
            return DataFrame(L.Project(out, joined), self.session)
        cond = on.expr if isinstance(on, Col) else on
        lkeys, rkeys, residual = _extract_equi_keys(cond, self.schema,
                                                    other.schema)
        return DataFrame(L.Join(self._plan, other._plan, how, lkeys, rkeys,
                                residual), self.session)

    def collect(self) -> List[tuple]:
        t = self.to_arrow()
        cols = [t.column(i).to_pylist() for i in range(t.num_columns)]
        return list(zip(*cols)) if cols else []

    def to_arrow(self) -> pa.Table:
        return self.session.execute_to_arrow(self._plan)

    def explain(self) -> str:
        return self.session.plan(self._plan).tree_string()


_JOIN_ALIASES = {"left_outer": "left", "right_outer": "right",
                 "outer": "full", "full_outer": "full",
                 "leftsemi": "semi", "left_semi": "semi",
                 "leftanti": "anti", "left_anti": "anti",
                 "crossjoin": "cross"}


def _ref_names(e: ec.Expression) -> set:
    return {x.col_name for x in e.collect(
        lambda n: isinstance(n, ec.AttributeReference))}


def _extract_equi_keys(cond: ec.Expression, lschema: Schema,
                       rschema: Schema):
    """Split a join condition into equi-key pairs and a residual."""
    conjuncts = []

    def flatten(e):
        if isinstance(e, ep.And):
            flatten(e.children[0])
            flatten(e.children[1])
        else:
            conjuncts.append(e)
    flatten(cond)
    lkeys, rkeys, residual = [], [], []
    lnames, rnames = set(lschema.names), set(rschema.names)
    for c in conjuncts:
        if isinstance(c, ep.EqualTo):
            a, b = c.children
            an, bn = _ref_names(a), _ref_names(b)
            if an and bn and an <= lnames and bn <= rnames:
                lkeys.append(_resolve(a, lschema))
                rkeys.append(_resolve(b, rschema))
                continue
            if an and bn and an <= rnames and bn <= lnames:
                lkeys.append(_resolve(b, lschema))
                rkeys.append(_resolve(a, rschema))
                continue
        residual.append(c)
    res = None
    for r in residual:
        res = r if res is None else ep.And(res, r)
    return lkeys, rkeys, res


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[ec.Expression]):
        self.df = df
        self.keys = keys

    def agg(self, *aggs) -> DataFrame:
        schema = self.df.schema
        agg_exprs = []
        for a in aggs:
            e = a.expr if isinstance(a, Col) else a
            alias = None
            if isinstance(e, ec.Alias):
                alias = e.alias
                e = e.children[0]
            e = _resolve(e, schema)
            if not isinstance(e, eagg.AggregateFunction):
                raise TypeError(f"agg() takes aggregate functions, got {e!r}")
            agg_exprs.append(L.AggExpr(e, alias or repr(e)))
        return DataFrame(L.Aggregate(self.keys, agg_exprs, self.df._plan),
                         self.df.session)
