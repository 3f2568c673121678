"""count(DISTINCT), ROLLUP, CUBE, GROUPING SETS and ``grouping()``
through the PyTorch port, against the JAX package, on the CPU.

Seeded tables go through the port (``device="cpu"``, ``batchSizeRows``
4 over 3 partitions, so every group arrives in several batches and
every Expand projection is a batch of its own) and through the JAX
package's engine and its pyarrow oracle.  The reference's
``tests/test_sql.py`` cases (``test_count_distinct``,
``test_count_distinct_global_and_avg``, ``test_sum_distinct_dataframe``,
``test_rollup_sql``, ``test_cube_and_grouping_sets_sql``,
``test_rollup_dataframe``, ``test_rollup_aggregate_over_key_column``)
run in SQL text and through the DataFrame API; rows agree as multisets,
floats within ``DEFAULT_FLOAT_REL`` (1e-9), integers, strings and NULLs
equal.  Also held here: NULL keys in the data beside a subtotal's NULL
(``grouping()`` tells them apart), ``grouping()`` inside arithmetic and
ORDER BY, a DISTINCT count of an all-NULL column and of no rows (0, and
a NULL sum beside it), the plan shapes (a ``TpuExpand`` under the
partial aggregate; two stacked aggregates for DISTINCT), the table core
taking NULL keys and the set id, batch sizes that change nothing, and
the refusals (``SqlError``): DISTINCT calls of two arguments,
``grouping()`` without grouping sets or of no key.
"""
import functools

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.api import TpuSession, functions as F
from spark_rapids_tpu_torch.api.sql import SqlError
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.tpu_aggregate import TpuHashAggregate

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_cpu_session, with_tpu_session

torch.set_num_threads(1)


def _t1() -> pa.Table:
    """The reference's ``t1`` at 200 rows."""
    rng = np.random.default_rng(42)
    n = 200
    return pa.table({
        "k": pa.array(rng.integers(0, 20, n), pa.int64()),
        "v": pa.array(rng.integers(-100, 100, n), pa.int64()),
        "x": pa.array(np.round(rng.random(n) * 100, 3), pa.float64()),
        "name": pa.array([f"item_{i % 37}" for i in range(n)], pa.string()),
    })


def _nulls() -> pa.Table:
    """Keys with NULLs (a string, an int32 and an int64) and values with
    NULLs, an all-NULL column ``z``."""
    rng = np.random.default_rng(7)
    n = 120

    def with_nulls(a, share=0.15):
        a = a.astype(object)
        a[rng.random(n) < share] = None
        return list(a)
    return pa.table({
        "g": pa.array(with_nulls(rng.choice(np.array(
            ["a", "b", "cc", ""], dtype=object), n)), pa.string()),
        "h": pa.array(with_nulls(rng.integers(0, 3, n)), pa.int32()),
        "m": pa.array(with_nulls(rng.integers(-2, 2, n)), pa.int64()),
        "v": pa.array(with_nulls(rng.integers(-50, 50, n)), pa.int64()),
        "x": pa.array(with_nulls(rng.random(n) * 10 - 3), pa.float64()),
        "z": pa.array([None] * n, pa.int64()),
    })


TABLES = {"t1": _t1(), "tn": _nulls()}


def _port(rows=4, parts=3):
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": rows}),
                   device="cpu")
    for name, t in TABLES.items():
        s.create_dataframe(t, num_partitions=parts) \
            .create_or_replace_temp_view(name)
    return s


@functools.lru_cache(maxsize=None)
def _jax_rows(sql, engine_name):
    engine = {"jax": with_tpu_session, "oracle": with_cpu_session}[
        engine_name]

    def run(s):
        for name, t in TABLES.items():
            s.create_dataframe(t, num_partitions=3) \
                .create_or_replace_temp_view(name)
        return s.sql(sql).collect()
    return canon_rows(engine(run))


def _check(sql, got, engines=("jax", "oracle")):
    got = canon_rows(got)
    for engine in engines:
        _compare_rows(_jax_rows(sql, engine), got, rel=DEFAULT_FLOAT_REL)
    return got


def _df(s, name="t1"):
    return s.sql(f"select * from {name}")


#: the reference's cases: (SQL text, the same through the DataFrame API)
CASES = {
    "count_distinct": (
        """SELECT k, count(DISTINCT v) AS dv, count(*) AS n,
                  sum(v) AS sv, max(v) AS mx
           FROM t1 GROUP BY k""",
        lambda s: _df(s).group_by("k").agg(
            F.count_distinct("v").alias("dv"), F.count().alias("n"),
            F.sum("v").alias("sv"), F.max("v").alias("mx"))),
    "count_distinct_global": (
        "SELECT count(DISTINCT k) FROM t1",
        lambda s: _df(s).group_by().agg(F.countDistinct("k"))),
    "count_distinct_and_avg": (
        """SELECT k % 3 AS g, count(DISTINCT k) AS dk, avg(x) AS ax
           FROM t1 GROUP BY k % 3""",
        lambda s: _df(s).group_by((F.col("k") % 3).alias("g")).agg(
            F.count_distinct("k").alias("dk"), F.avg("x").alias("ax"))),
    "sum_distinct": (
        "SELECT k, count(DISTINCT v) AS dv, sum(DISTINCT v) AS sv "
        "FROM t1 GROUP BY k",
        lambda s: _df(s).group_by("k").agg(
            F.count_distinct("v").alias("dv"),
            F.sum_distinct("v").alias("sv"))),
    "avg_distinct_of_doubles": (
        "SELECT k % 4 AS g, avg(DISTINCT x) AS ax, count(v) AS c, "
        "max(x) AS mx FROM t1 GROUP BY k % 4", None),
    "rollup": (
        """SELECT k % 2 AS a, k % 3 AS b, sum(v) AS sv, count(*) AS n
           FROM t1 GROUP BY ROLLUP(k % 2, k % 3)""",
        lambda s: _df(s).rollup((F.col("k") % 2).alias("a"),
                                (F.col("k") % 3).alias("b")).agg(
            F.sum("v").alias("sv"), F.count().alias("n"))),
    "cube": (
        """SELECT k % 2 AS a, k % 3 AS b, sum(v) AS sv
           FROM t1 GROUP BY CUBE(k % 2, k % 3)""",
        lambda s: _df(s).cube((F.col("k") % 2).alias("a"),
                              (F.col("k") % 3).alias("b")).agg(
            F.sum("v").alias("sv"))),
    "grouping_sets": (
        """SELECT k % 2 AS a, k % 3 AS b, count(*) AS n
           FROM t1 GROUP BY GROUPING SETS ((k % 2, k % 3), (k % 2), ())""",
        None),
    "rollup_strings_and_doubles": (
        """SELECT name, k, sum(x) AS sx, avg(v) AS av, max(name) AS mn
           FROM t1 GROUP BY ROLLUP(name, k)""",
        lambda s: _df(s).rollup("name", "k").agg(
            F.sum("x").alias("sx"), F.avg("v").alias("av"),
            F.max("name").alias("mn"))),
    "rollup_with_distinct": (
        """SELECT k % 3 AS a, count(DISTINCT v) AS dv, sum(x) AS sx
           FROM t1 GROUP BY ROLLUP(k % 3)""",
        lambda s: _df(s).rollup((F.col("k") % 3).alias("a")).agg(
            F.count_distinct("v").alias("dv"), F.sum("x").alias("sx"))),
}


def _cases(api):
    return sorted(n for n, (_, df) in CASES.items()
                  if api == "sql" or df is not None)


@pytest.mark.parametrize("name,api", [(n, "sql") for n in _cases("sql")] +
                         [(n, "dataframe") for n in _cases("dataframe")])
def test_grouping_matches_jax_and_oracle(name, api):
    sql, df = CASES[name]
    s = _port()
    got = (s.sql(sql) if api == "sql" else df(s)).collect()
    assert got
    _check(sql, got)


def test_sum_distinct_dataframe():
    """The reference's ``test_sum_distinct_dataframe``, by hand too."""
    data = pa.table({"g": pa.array([1, 1, 1, 2, 2], pa.int64()),
                     "v": pa.array([5, 5, 7, 3, 3], pa.int64())})
    s = TpuSession(device="cpu")
    df = s.create_dataframe(data, num_partitions=2)
    got = sorted(df.group_by("g").agg(
        F.count_distinct("v").alias("dv"),
        F.sum_distinct("v").alias("sv")).collect())
    assert got == [(1, 2, 12), (2, 1, 3)]


def test_rollup_dataframe_by_hand():
    """The reference's ``test_rollup_dataframe``: subtotals and the grand
    total."""
    data = pa.table({"a": pa.array([1, 1, 2], pa.int64()),
                     "b": pa.array([1, 2, 1], pa.int64()),
                     "v": pa.array([10, 20, 30], pa.int64())})
    s = TpuSession(device="cpu")
    rows = s.create_dataframe(data).rollup("a", "b").agg(
        F.sum("v").alias("sv")).collect()
    assert (1, None, 30) in rows and (None, None, 60) in rows
    assert sorted(rows, key=str) == sorted(
        [(1, 1, 10), (1, 2, 20), (2, 1, 30), (1, None, 30), (2, None, 30),
         (None, None, 60)], key=str)


@pytest.mark.parametrize("api", ["sql", "dataframe"])
def test_rollup_aggregate_over_key_column(api):
    """The reference's case: an aggregate input never reads the key's
    null-filled copy, so the grand total counts every row."""
    data = pa.table({"k": pa.array([1, 1, 2], pa.int64())})
    sql = "SELECT k, count(k) AS c FROM t GROUP BY ROLLUP(k)"
    s = TpuSession(device="cpu")
    s.create_dataframe(data).create_or_replace_temp_view("t")
    rows = s.sql(sql).collect() if api == "sql" else \
        s.sql("select * from t").rollup("k").agg(
            F.count("k").alias("c")).collect()
    assert sorted(rows, key=str) == [(1, 2), (2, 1), (None, 3)]

    def run(js):
        js.create_dataframe(data).create_or_replace_temp_view("t")
        return js.sql(sql).collect()
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(engine(run)), canon_rows(rows),
                      rel=DEFAULT_FLOAT_REL)


#: NULL keys, grouping() in arithmetic and ORDER BY, DISTINCT of NULLs
NULL_SQL = {
    "null_keys_beside_subtotals": """
        SELECT g, h, sum(v) AS sv, count(*) AS n, grouping(g) AS gg,
               grouping(h) AS gh
        FROM tn GROUP BY ROLLUP(g, h)""",
    "grouping_in_arithmetic_and_order": """
        SELECT g, m, sum(x) AS sx, grouping(g) + grouping(m) AS lvl,
               grouping(g) * 2 + grouping(m) AS gid
        FROM tn GROUP BY CUBE(g, m)
        ORDER BY lvl DESC, g, m""",
    "grouping_sets_of_nullable_ints": """
        SELECT h, m, count(v) AS c, max(x) AS mx, avg(x) AS ax
        FROM tn GROUP BY GROUPING SETS ((h, m), h, (m), ())""",
    "distinct_of_nulls": """
        SELECT h, count(DISTINCT z) AS dz, sum(DISTINCT z) AS sz,
               count(*) AS n, max(m) AS mm
        FROM tn GROUP BY h""",
    "distinct_over_no_rows": """
        SELECT count(DISTINCT v) AS dv, sum(v) AS sv, count(*) AS n,
               avg(x) AS ax
        FROM tn WHERE v > 1000""",
    "distinct_with_null_keys": """
        SELECT g, m, count(DISTINCT v) AS dv, sum(x) AS sx
        FROM tn GROUP BY g, m""",
    "having_and_order_repeat_the_call": """
        SELECT h, count(DISTINCT v) AS dv FROM tn GROUP BY h
        HAVING count(DISTINCT v) > 2 ORDER BY count(DISTINCT v), h""",
}


@pytest.mark.parametrize("name", sorted(NULL_SQL))
def test_nulls_and_grouping_match_jax_and_oracle(name):
    sql = NULL_SQL[name]
    got = _port().sql(sql).collect()
    assert got
    _check(sql, got)


def test_subtotal_nulls_are_apart_from_null_keys():
    """A NULL ``g`` in the data is a group of its own at the (g, h)
    level and at the (g) level; the subtotal over all ``g`` is another
    NULL, with ``grouping(g)`` 1."""
    rows = _port().sql(NULL_SQL["null_keys_beside_subtotals"]).collect()
    data = TABLES["tn"].to_pylist()
    nulls = sum(1 for r in data if r["g"] is None)
    level_g = {r[0]: r[3] for r in rows if r[5] == 1 and r[4] == 0}
    assert level_g[None] == nulls
    total = [r for r in rows if r[4] == 1]
    assert len(total) == 1 and total[0][:2] == (None, None) and \
        total[0][3] == len(data)


def test_order_by_grouping_sorts_subtotals():
    rows = _port().sql(NULL_SQL["grouping_in_arithmetic_and_order"]) \
        .collect()
    lvls = [r[3] for r in rows]
    assert lvls == sorted(lvls, reverse=True) and lvls[0] == 2 and \
        lvls[-1] == 0
    assert all(r[4] == {(0, 0): 0, (0, 1): 1, (1, 0): 2, (1, 1): 3}[
        (r[4] // 2, r[4] % 2)] for r in rows)


def test_distinct_over_no_rows_by_hand():
    """A global count(DISTINCT) over no rows is one row: 0 beside a NULL
    sum, as Spark answers."""
    assert _port().sql(NULL_SQL["distinct_over_no_rows"]).collect() == \
        [(0, None, 0, None)]


def test_batch_sizes_change_nothing():
    """One query over batches of 4, 16 and 1024 rows, 1 and 3
    partitions: the same rows."""
    sql = """SELECT g, h, count(DISTINCT m) AS dm, sum(x) AS sx,
                    grouping(h) AS gh
             FROM tn GROUP BY ROLLUP(g, h)"""
    want = canon_rows(_port(1024, 1).sql(sql).collect())
    for rows, parts in ((4, 3), (16, 2), (1024, 3)):
        _compare_rows(want, canon_rows(_port(rows, parts).sql(sql)
                                       .collect()), rel=DEFAULT_FLOAT_REL)


def _aggs(plan):
    out, stack = [], [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, TpuHashAggregate):
            out.append(n)
        stack.extend(n.children)
    return out


def test_plans_expand_under_the_partial_aggregate():
    """ROLLUP plans partial aggregate over ``TpuExpand``, a hash
    exchange on the keys and ``__gid`` read through AQE's coalescing
    read, and the final aggregate; a count(DISTINCT) plans two such
    aggregates, one over the other."""
    s = _port()
    plan = s.sql("select g, h, sum(v) from tn group by rollup(g, h)") \
        .explain().splitlines()
    ops = [ln.strip().split("[")[0] for ln in plan]
    i = ops.index("TpuExpand")
    assert ops[i - 4:i + 1] == ["TpuHashAggregate", "TpuAQEShuffleRead",
                                "TpuShuffleExchange", "TpuHashAggregate",
                                "TpuExpand"]
    assert "partial" in plan[i - 1] and "final" in plan[i - 4]
    plan = s.sql("select h, count(distinct v), sum(x) from tn group by h") \
        .explain()
    assert plan.count("TpuHashAggregate[partial") == 2 and \
        plan.count("TpuHashAggregate[final") == 2 and \
        plan.count("TpuShuffleExchange") == 2


def test_table_core_takes_null_keys_and_the_set_id():
    """Integer keys with NULLs and the set id fit the table core (B2's
    bucket ids give a NULL key digit 0, apart from every value): every
    batch of the rollup's aggregates takes it, and the rows equal the
    JAX engine's."""
    sql = "select h, m, max(x) mx, count(*) n from tn group by rollup(h, m)"
    s = _port()
    got = s.sql(sql).collect()
    _check(sql, got)
    aggs = _aggs(s.last_physical_plan)
    assert aggs and all(a.path_counts["sort"] == 0 and
                        a.path_counts["table"] > 0 for a in aggs)


@pytest.mark.parametrize("sql,what", [
    ("select count(distinct v), count(distinct x) from t1", "DISTINCT"),
    ("select k, sum(distinct v), avg(distinct x) from t1 group by k",
     "DISTINCT"),
    ("select max(distinct v) from t1", "max\\(DISTINCT"),
    ("select count(distinct v, x) from t1", "one argument"),
    ("select k, stddev(x), count(distinct v) from t1 group by k",
     "beside a DISTINCT"),
    ("select k, grouping(k) from t1 group by k", "grouping"),
    ("select k, grouping(v) from t1 group by rollup(k)", "grouping"),
    ("select k, count(distinct v) over (partition by k) from t1",
     "over a window"),
    ("select count(distinct *) from t1", "DISTINCT \\*"),
])
def test_outside_the_slice_raises(sql, what):
    with pytest.raises(SqlError, match=what):
        _port().sql(sql)


def test_two_distinct_arguments_raise_through_the_dataframe_api():
    with pytest.raises(NotImplementedError, match="DISTINCT"):
        _df(_port()).group_by("k").agg(F.count_distinct("v"),
                                       F.count_distinct("x"))


def test_expand_stacks_the_sets_of_a_batch():
    """``TpuExpand`` makes one batch of sets x rows of each input batch:
    its rows are, in order, each projection evaluated over the batch
    (the reference's one batch per projection), a NULL-filled STRING key
    a string column of no valid row."""
    from spark_rapids_tpu_torch.columnar.arrow import to_arrow
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec.tpu_expand import TpuExpand
    from spark_rapids_tpu_torch.expr import core as ec
    from spark_rapids_tpu_torch.plan import logical as L
    s = _port()
    df = s.sql("select * from tn").rollup("g", "h").agg(F.sum("v"))
    stack = [df._plan]
    while not isinstance(stack[-1], L.Expand):
        stack.append(stack[-1].children[0])
    expand = stack[-1]
    child = s.plan(expand.children[0])
    got = TpuExpand(expand, child).execute()
    bound = [[e.bind(child.output_schema) for e in proj]
             for proj in expand.projections]

    def rows(t):
        return [tuple(r.values()) for r in t.to_pylist()]
    for part, inputs in zip(got, child.execute()):
        part, inputs = list(part), list(inputs)
        assert len(part) == len(inputs)
        for out, b in zip(part, inputs):
            want = []
            for proj in bound:
                want += rows(to_arrow(ColumnarBatch(
                    expand.schema, [ec.eval_as_column(e, b) for e in proj],
                    b.rows)))
            assert rows(to_arrow(out)) == want
    assert len(expand.projections) == 3


def test_expand_of_another_form_raises():
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.schema import Field, Schema
    from spark_rapids_tpu_torch.exec.tpu_expand import TpuExpand
    from spark_rapids_tpu_torch.expr import arithmetic as ea
    from spark_rapids_tpu_torch.expr import core as ec
    from spark_rapids_tpu_torch.plan import logical as L
    s = _port()
    child = s.plan(s.sql("select * from tn")._plan)
    v = ec.AttributeReference("v", T.INT64)
    expand = L.Expand([[ec.Alias(ea.Add(v, ec.Literal(1)), "w")], [v]],
                      Schema([Field("w", T.INT64)]), s.sql(
                          "select * from tn")._plan)
    with pytest.raises(NotImplementedError, match="Expand column"):
        TpuExpand(expand, child)


def test_filters_stop_above_the_expand_and_pruning_reaches_below(
        tmp_path):
    """A HAVING conjunct on a rollup key sinks below the aggregate (a
    plain group key) and stops on the Expand (no rule moves a filter, or
    folds a constant, through it); the Parquet scan below reads only the
    columns the Expand's projections name.  Rows equal the JAX
    engine's."""
    import pyarrow.parquet as papq
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan.logical_opt import prune_scan_columns
    path = str(tmp_path / "tn.parquet")
    papq.write_table(TABLES["tn"], path)
    sql = """SELECT h, m, sum(v) AS sv FROM tn GROUP BY ROLLUP(h, m)
             HAVING h = 1 AND 1 = 1"""
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 4}),
                   device="cpu")
    s.read.parquet(path).create_or_replace_temp_view("tn")
    df = s.sql(sql)
    nodes, stack = [], [prune_scan_columns(df._plan)]
    while stack:
        n = stack.pop()
        nodes.append(n)
        stack.extend(n.children)
    expand = next(n for n in nodes if isinstance(n, L.Expand))
    above = [n for n in nodes if isinstance(n, L.Filter) and
             n.children[0] is expand]
    assert len(above) == 1 and "h" in repr(above[0].condition)
    below = [n for n in nodes if n is not expand and
             _is_below(n, expand)]
    assert not any(isinstance(n, L.Filter) for n in below)
    scans = [n for n in below if isinstance(n, L.Scan)]
    assert len(scans) == 1 and set(scans[0].schema.names) == \
        {"h", "m", "v"}
    _check(sql, df.collect())


def _is_below(node, top):
    stack = list(top.children)
    while stack:
        n = stack.pop()
        if n is node:
            return True
        stack.extend(n.children)
    return False
