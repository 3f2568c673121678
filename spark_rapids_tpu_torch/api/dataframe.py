"""DataFrame API: the PySpark-flavoured surface that builds logical plans.

Counterpart of ``spark_rapids_tpu/api/dataframe.py`` (select,
with_column, with_window, filter, group_by().agg(), join, sort, limit,
temp views, collect, to_arrow).
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

    def with_window(self, alias: str, func, partition_by=None,
                    order_by=None, frame=("rows", None, 0)) -> "DataFrame":
        """Add the column ``alias``: a window function (``functions``'
        ``row_number``, ``rank``, ``lead``, ...) or an aggregate over the
        frame ``(kind, lo, hi)`` (``plan/logical.WindowSpec``; the
        default, as the reference's, is the running ROWS frame)."""
        from ..exec.tpu_window import check_window_func
        pb = [_to_expr(c, self.schema) for c in (partition_by or [])]
        ob = []
        for c in order_by or []:
            if isinstance(c, L.SortOrder):
                ob.append(L.SortOrder(_resolve(c.expr, self.schema),
                                      c.ascending, c.nulls_first))
            else:
                ob.append(L.SortOrder(_to_expr(c, self.schema)))
        f = _resolve(func.expr if isinstance(func, Col) else func,
                     self.schema)
        wf = L.WindowFunc(f, L.WindowSpec(pb, ob, tuple(frame)), alias)
        check_window_func(wf)
        return DataFrame(L.Window([wf], self._plan), self.session)

    withWindow = with_window

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
        Spark does).  A cross join, or a condition without an equality
        between the sides, runs as a nested-loop join."""
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

    def sort(self, *cols, ascending=None) -> "DataFrame":
        """A global sort by columns, names or ``Col.asc()`` / ``desc()``
        orders; ``limit`` right over it plans a ``TpuTopN``."""
        orders = []
        for c in cols:
            if isinstance(c, L.SortOrder):
                orders.append(L.SortOrder(_resolve(c.expr, self.schema),
                                          c.ascending, c.nulls_first))
            else:
                orders.append(L.SortOrder(_to_expr(c, self.schema)))
        if ascending is not None:
            flags = ascending if isinstance(ascending, (list, tuple)) \
                else [ascending] * len(orders)
            orders = [L.SortOrder(o.expr, bool(a)) for o, a in
                      zip(orders, flags)]
        return DataFrame(L.Sort(orders, self._plan), self.session)

    orderBy = order_by = sort

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._plan), self.session)

    def create_or_replace_temp_view(self, name: str) -> None:
        self.session.register_table(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

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
            if isinstance(e, eagg.Min):
                raise NotImplementedError("min() as a grouped aggregate is "
                                          "not ported (only over a window)")
            agg_exprs.append(L.AggExpr(e, alias or repr(e)))
        return DataFrame(L.Aggregate(self.keys, agg_exprs, self.df._plan),
                         self.df.session)
