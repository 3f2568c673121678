"""Derived tables, CTEs, cross and non-equi joins and ``round`` through
the PyTorch port, against the JAX package, on the CPU.

The same seeded tables go through the port's ``session.sql`` (or its
DataFrame API, ``device="cpu"``) and the JAX package's engine and its
pyarrow oracle; rows agree as multisets (floats within 1e-9 relative).
``TpuNestedLoopJoin`` runs every join type on a non-equi condition
against the reference's own ``TpuNestedLoopJoin``, with
``join.gather.chunkRows`` small enough that each left batch expands in
several chunks.  The optimizer's ``_rewrite_filter_project`` is held to
its plan shape: conjuncts over a derived table's pass-through columns
sink to the joins inside it, and a filter stays above an aggregate.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as JF

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.sql import sql_to_plan
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.plan import logical as L

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_cpu_session, with_tpu_session
from tests.test_torch_sql import _jax_rows, _port_rows, _register, _tables

torch.set_num_threads(1)

QUERIES = {
    "derived_filter": "select k, total from (select k, sum(x) total "
                      "from fact group by k) t where total > 100",
    "derived_nested": "select n from (select k, count(*) n from (select "
                      "k, x from fact where d < 30) a group by k) b "
                      "where k < 5",
    "derived_join_operand": "select dname, t.n from dim join (select d, "
                            "count(*) n from fact group by d) t on "
                            "t.d = dk where dv > 1",
    "derived_star": "select * from (select k, s, x from fact where "
                    "k = 3) q",
    "derived_comma_join": "select dname, t.sx from (select d, sum(x) sx "
                          "from fact group by d) t, dim where t.d = dk "
                          "and dname = 'd2'",
    "derived_aggregated": "select count(*) c, sum(n) total from (select "
                          "s, count(*) n from fact group by s) g",
    "cte_twice": "with g as (select k, sum(x) sx from fact group by k) "
                 "select a.k, a.sx, b.sx from g a, g b "
                 "where a.k = b.k + 1",
    "cte_reads_earlier": "with g as (select d, sum(x) sx from fact group "
                         "by d), h as (select d, sx * 2 s2 from g where "
                         "sx > 50) select dname, s2 from h, dim "
                         "where d = dk",
    "cte_in_derived": "select k, n from (with c as (select k, count(*) n "
                      "from fact group by k) select k, n from c) t "
                      "where n > 40",
    "cross_one_row": "select a.n, b.m, c.sd from (select count(*) n from "
                     "fact where k < 3) a, (select max(x) m from fact) b, "
                     "(select sum(d) sd from fact) c",
    "cross_join_keyword": "select a.n, b.m from (select count(*) n from "
                          "fact) a cross join (select sum(d) m from "
                          "fact) b",
    "join_on_non_equi": "select k, dk from fact join dim on d < dk "
                        "where k = 1 and dk > 37",
    "round_sql": "select k, round(x, 2) r2, round(x) r0, round(-x, 1) rn, "
                 "round(a, 0) ra from fact where k < 4",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_jax_engine_and_oracle(name):
    tables = _tables(1)
    sql = QUERIES[name]
    got = _port_rows(sql, tables)
    assert got, f"{name}: no rows"

    def fn(s):
        _register(s, tables, 3)
        return s.sql(sql).collect()
    for want in (_jax_rows(sql, tables), with_cpu_session(fn)):
        _compare_rows(canon_rows(want), canon_rows(got),
                      rel=DEFAULT_FLOAT_REL)


def test_cross_join_of_one_row_sides_plans_nested_loop():
    s = TpuSession(device="cpu")
    _register(s, _tables(1), 3)
    plan = s.sql(QUERIES["cross_one_row"]).explain()
    assert plan.count("TpuNestedLoopJoin[cross]") == 2
    assert "TpuHashJoin" not in plan


HOWS = ["inner", "left", "right", "full", "semi", "anti"]
#: the port's chunk bound (64 pairs in the test below: every left batch
#: of 32 rows against 40 expands in several chunks)
CHUNK = "spark.rapids.tpu.sql.join.gather.chunkRows"


def _sides(seed: int = 3, n_left: int = 70, n_right: int = 40):
    rng = np.random.default_rng(seed)

    def col(n, lo, hi, nulls):
        return pa.array(rng.integers(lo, hi, n), mask=rng.random(n) < nulls)
    left = pa.table({"k": col(n_left, 0, 50, 0.1),
                     "x": rng.random(n_left) * 10})
    right = pa.table({"rk": col(n_right, 0, 50, 0.1),
                      "y": rng.random(n_right) * 10})
    return left, right


def _nl_join(s, how, parts):
    lt, rt = _sides()
    a = s.create_dataframe(lt, num_partitions=parts)
    b = s.create_dataframe(rt, num_partitions=parts)
    # no equality: a band on the keys and an order on the values
    return a.join(b, (a["k"] > b["rk"] + 40) | (a["x"] < b["y"] - 9.5), how)


@pytest.mark.parametrize("how", HOWS)
def test_nested_loop_join_types_match_reference(how):
    """Each join type on a non-equi condition: pair-level semantics (outer
    sides null-extend, semi/anti select by a surviving pair), against the
    JAX package's TpuNestedLoopJoin and its oracle."""
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 32, CHUNK: 64}
    port = TpuSession(TpuConf(conf), device="cpu")
    df = _nl_join(port, how, 2)
    got = canon_rows(df.collect())
    join = next(n for n in _nodes(port.last_physical_plan)
                if type(n).__name__ == "TpuNestedLoopJoin")
    assert join.expand_counts["chunks"] > join.expand_counts["batches"] > 0
    assert f"TpuNestedLoopJoin[{how}]" in df.explain()
    jconf = {"spark.rapids.tpu.sql.batchSizeRows": 32}
    ref = with_tpu_session(lambda s: _nl_join(s, how, 2).collect(), jconf)
    assert "TpuNestedLoopJoin" in with_tpu_session(
        lambda s: s.explain(_nl_join(s, how, 2)._plan), jconf)
    oracle = with_cpu_session(lambda s: _nl_join(s, how, 2).collect())
    assert got
    for want in (ref, oracle):
        _compare_rows(canon_rows(want), got, rel=DEFAULT_FLOAT_REL)


def _nodes(node):
    yield node
    for c in node.children:
        yield from _nodes(c)


@pytest.mark.parametrize("how", ["inner", "left", "full", "anti"])
def test_nested_loop_chunks_do_not_change_rows(how):
    """The port expands pairs in chunks of ``join.gather.chunkRows``
    (the reference expands a batch's pairs at once): the rows are the
    same, in the same order, whatever the chunk size."""
    outs = []
    for chunk in (1 << 20, 7):
        s = TpuSession(TpuConf({CHUNK: chunk}), device="cpu")
        outs.append(_nl_join(s, how, 1).to_arrow())
    assert outs[0].equals(outs[1])


@pytest.mark.parametrize("how", ["cross", "left", "anti"])
def test_nested_loop_join_with_an_empty_side(how):
    """An empty right side: a left join null-extends every left row, an
    anti join keeps every one, a cross join has no rows."""
    lt, rt = _sides()
    port = TpuSession(device="cpu")
    a = port.create_dataframe(lt)
    b = port.create_dataframe(rt).filter(PF.col("y") < -1.0)
    df = a.join(b, how="cross") if how == "cross" else \
        a.join(b, a["x"] > b["y"], how)
    rows = df.collect()
    assert len(rows) == (0 if how == "cross" else lt.num_rows)
    if how == "left":
        assert all(r[2] is None and r[3] is None for r in rows)


ROUND_VALUES = [2.5, -2.5, 0.125, -0.125, 1.005, 2.675, 15.0, -15.0, 0.0,
                -0.0, 1234.5678, -1234.5678, 0.5, -0.5, 1e-12, 99.995,
                float("nan"), float("inf"), None]


@pytest.mark.parametrize("scale", [0, 2, -1])
def test_round_half_up_matches_reference(scale):
    """Spark's HALF_UP: ties go away from zero, on negatives too; an
    integer column is unchanged at a scale of 0 and rounds to tens at
    -1."""
    table = pa.table({
        "v": pa.array(ROUND_VALUES, pa.float64()),
        "i": pa.array([25, -25, 1234, -1235, 15, -15, 0, 7, 99, -99, 5,
                       -5, 45, -45, 1, 10, 11, 12, None], pa.int64())})

    def query(F):
        def run(s):
            df = s.create_dataframe(table)
            return df.select(F.round(F.col("v"), scale).alias("rv"),
                             F.round(F.col("i"), scale).alias("ri")
                             ).collect()
        return run
    got = query(PF)(TpuSession(device="cpu"))
    want = with_tpu_session(query(JF))
    _compare_rows(want, got, rel=0.0)
    oracle = with_cpu_session(query(JF))
    _compare_rows(oracle, got, rel=0.0)
    if scale == 0:
        assert [r[0] for r in got[:4]] == [3.0, -3.0, 0.0, -0.0]
        assert [r[1] for r in got[:4]] == [25, -25, 1234, -1235]
    if scale == -1:
        assert [r[1] for r in got[:4]] == [30, -30, 1230, -1240]


def _find_logical(plan, kind):
    out = [plan] if isinstance(plan, kind) else []
    for c in plan.children:
        out.extend(_find_logical(c, kind))
    return out


def _views():
    s = TpuSession(device="cpu")
    _register(s, _tables(1), 1)
    return s._views


def test_filter_sinks_through_derived_table_to_its_join():
    """Outer WHERE conjuncts on a derived table's pass-through columns
    (one renamed by the select list) go through its projection and into
    each side of the join inside it; a conjunct over a computed column
    stays above."""
    plan = sql_to_plan(
        "select * from (select k as kk, dname, x * 2 x2 from fact join dim "
        "on d = dk) t where kk = 3 and dname = 'd1' and x2 > 1", _views())
    top = plan
    assert isinstance(top, L.Project)
    f = top.children[0]
    assert isinstance(f, L.Filter) and "x" in repr(f.condition) and \
        "dname" not in repr(f.condition)
    join = _find_logical(plan, L.Join)[0]
    left, right = join.children
    assert isinstance(left, L.Filter) and "col(k)" in repr(left.condition)
    assert isinstance(right, L.Filter) and \
        "dname" in repr(right.condition)


def test_filter_stays_above_aggregate():
    """A conjunct on a derived table's aggregate sinks through its
    projection and stops at the Aggregate; one on a plain group key goes
    on below it (``logical_opt._rewrite_filter_aggregate``, a rule the
    reference lacks)."""
    plan = sql_to_plan("select k, n from (select k, count(*) n from fact "
                       "group by k) t where k = 2 and n > 1", _views())
    aggs = _find_logical(plan, L.Aggregate)
    assert len(aggs) == 1
    filters = _find_logical(plan, L.Filter)
    above = [f for f in filters if f.children[0] is aggs[0]]
    assert len(above) == 1 and "col(k)" not in repr(above[0].condition)
    below = _find_logical(aggs[0].children[0], L.Filter)
    assert len(below) == 1 and "col(k)" in repr(below[0].condition)


def test_cte_used_twice_is_one_plan_renamed():
    """A CTE read under two aliases is one plan object: the second copy's
    colliding columns are renamed by a projection over it, and the
    optimizer changes neither copy in place."""
    views = _views()
    plan = sql_to_plan(QUERIES["cte_twice"], views)
    join = _find_logical(plan, L.Join)[0]
    left, right = join.children
    names = set(left.schema.names) & set(right.schema.names)
    assert not names
    assert any(n.startswith("__b_") for n in right.schema.names)
    # the views are untouched: a second lowering gives the same rows
    tables = _tables(1)
    assert canon_rows(_port_rows(QUERIES["cte_twice"], tables)) == \
        canon_rows(_port_rows(QUERIES["cte_twice"], tables))
