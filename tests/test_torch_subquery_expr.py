"""Expression subqueries through the PyTorch port's SQL, against the JAX
package, on the CPU.

The same seeded tables (``test_torch_sql._tables``: nulls in ``a`` and
``s``, an int32 ``d`` against dim's int64 ``dk``) go through the port's
``session.sql`` (``device="cpu"``) and the JAX package's engine and its
pyarrow oracle; rows agree as multisets (floats within 1e-9 relative).
The constructs: uncorrelated scalar queries in WHERE, the select list,
CASE and HAVING (run while the text is lowered, to a literal; NULL when
empty, ``SqlError`` past one row); ``[NOT] IN (query)`` as a semi or
anti join in three-valued logic, and inside an OR as an IN list;
uncorrelated and correlated ``[NOT] EXISTS`` (a residual ``<>`` too),
an OR of EXISTS as one semi join against a ``TpuUnion`` of key sets;
a comparison with a correlated aggregate on either side; ``LEFT SEMI``
and ``LEFT ANTI JOIN``; ``upper`` / ``lower``.  The optimizer's
``_rewrite_filter_semi`` is held to its plan shape, ``TpuUnion`` to its
rows and its refusal of differing column types, and ``sql_to_plan``
without a session to its refusal to run a subquery.
"""
import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api.sql import SqlError, sql_to_plan
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.tpu_basic import TpuUnion
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import logical_opt

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_cpu_session
from tests.test_torch_sql import _jax_rows, _port_rows, _register, _tables

torch.set_num_threads(1)

#: (query, rows expected: True for some, False for none)
QUERIES = {
    "scalar_where": ("select k, x from fact where x > (select avg(x) "
                     "from fact where k = 3)", True),
    "scalar_select": ("select k, (select max(x) from fact) m, a from fact "
                      "where k = 1", True),
    "scalar_case": ("select case when (select count(*) from fact where "
                    "k < 3) > 100 then (select avg(x) from fact) else "
                    "(select sum(d) from fact) end b1, case when (select "
                    "count(*) from fact where k < 3) > 1000 then 1.5 else "
                    "(select avg(d) from fact where k = 2) end b2 from dim "
                    "where dk = 1", True),
    "scalar_having": ("select k, sum(x) sx from fact group by k having "
                      "sum(x) > (select 0.08 * sum(x) from fact)", True),
    "scalar_empty_is_null": ("select k, (select max(x) from fact where "
                             "k > 100) m from fact where k = 2", True),
    "scalar_empty_in_where": ("select k from fact where x > (select "
                              "max(x) from fact where k > 100)", False),
    "scalar_string": ("select dk, dname from dim where dname = (select "
                      "dname from dim where dk = 10)", True),
    "in_sub": ("select k, a, d from fact where d in (select dk from dim "
               "where dv = 2)", True),
    "in_sub_wider_key": ("select dk, dname from dim where dk in (select d "
                         "from fact where k = 4)", True),
    "not_in_sub": ("select k, a from fact where d not in (select dk from "
                   "dim where dv = 2)", True),
    "not_in_empty_set_keeps_all": ("select k, a from fact where a not in "
                                   "(select a from fact where k > 100)",
                                   True),
    "not_in_null_in_set_keeps_none": ("select k from fact where d not in "
                                      "(select a from fact)", False),
    "in_null_operand": ("select k, a from fact where a in (select "
                        "dk * 10 from dim)", True),
    "not_in_null_operand": ("select k, a from fact where a not in (select "
                            "dk from dim)", True),
    "in_sub_in_or": ("select k, d from fact where k = 1 or d in (select "
                     "dk from dim where dv = 3)", True),
    "not_in_sub_in_or": ("select k, d from fact where k = 1 or d not in "
                         "(select dk from dim where dv < 4)", True),
    "exists_corr": ("select dk, dname from dim where exists (select * "
                    "from fact where d = dk and k = 2)", True),
    "not_exists_corr": ("select dk, dname from dim where not exists "
                        "(select * from fact where d = dk and k = 2)", True),
    "exists_residual": ("select dk from dim where exists (select * from "
                        "fact where d = dk and k <> dv)", True),
    "not_exists_residual": ("select dk from dim where not exists (select * "
                            "from fact where fact.d = dim.dk and "
                            "fact.k < dim.dv)", True),
    "exists_uncorr_true": ("select dk from dim where exists (select * from "
                           "fact where k = 3) and dv = 1", True),
    "exists_uncorr_false": ("select dk from dim where exists (select * "
                            "from fact where k = 99)", False),
    "not_exists_uncorr": ("select dk from dim where not exists (select * "
                          "from fact where k = 99) and dv = 2", True),
    "exists_or": ("select dk from dim where exists (select * from fact "
                  "where d = dk and k = 1) or exists (select * from fact "
                  "where d = dk and k = 2)", True),
    "three_exists": ("select dk, dname from dim where exists (select * "
                     "from fact where d = dk and k < 6) and (exists "
                     "(select * from fact where d = dk and k = 7) or "
                     "exists (select * from fact where dk = d and k = 8)) "
                     "and not exists (select * from fact where d = dk and "
                     "k = 11)", True),
    "scalar_corr_star": ("select * from dim where dv * 7 > (select avg(k) "
                         "from fact where d = dk)", True),
    "scalar_corr_with_filter": ("select k, x from fact f1 where x > "
                                "(select avg(x) * 1.2 from fact f2 where "
                                "f1.k = f2.k and f2.d < 20) and k < 9",
                                True),
    "scalar_corr_and_in": ("select dk, dname from dim, fact where "
                           "d = dk and x > (select avg(x) from fact f2 where "
                           "f2.d = dk) and dk in (select d from fact where "
                           "k = 3)", True),
    "left_semi_join": ("select dk, dv from dim left semi join fact on "
                       "d = dk and k = 3", True),
    "left_anti_join": ("select dk, dv from dim left anti join fact on "
                       "d = dk and k = 3", True),
    "semi_join_residual": ("select dk from dim left semi join fact on "
                           "d = dk and k > dv + 5", True),
    "upper_lower": ("select k, upper(s) u, lower(s) l, ucase(dname) u2, "
                    "lcase(dname) l2 from fact, dim where d = dk and "
                    "upper(s) = 'MUSIC'", True),
}


def _check(sql, tables, want_rows):
    got = _port_rows(sql, tables)
    assert bool(got) == want_rows, f"{len(got)} rows"

    def fn(s):
        _register(s, tables, 3)
        return s.sql(sql).collect()
    for want in (_jax_rows(sql, tables), with_cpu_session(fn)):
        _compare_rows(canon_rows(want), canon_rows(got),
                      rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_jax_engine_and_oracle(name):
    sql, want_rows = QUERIES[name]
    _check(sql, _tables(1), want_rows)


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("op", ["<", "<=", ">", ">=", "=", "<>"])
def test_correlated_scalar_each_comparison_and_side(op, side):
    """``x CMP (query)`` and ``(query) CMP x``: the operator flips with
    the side, so both give the same rows, and both the JAX package's."""
    sub = "(select max(x) from fact f2 where f2.k = f1.k and f2.d < 20)"
    cond = f"x {op} {sub}" if side == "right" else f"{sub} {op} x"
    sql = f"select k, x from fact f1 where {cond}"
    _check(sql, _tables(1), True)
    flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=",
               "<>": "<>"}[op]
    other = f"{sub} {flipped} x" if side == "right" else f"x {flipped} {sub}"
    assert canon_rows(_port_rows(sql, _tables(1))) == canon_rows(
        _port_rows(f"select k, x from fact f1 where {other}", _tables(1)))


REFUSED = {
    "scalar_of_rows": "select k from fact where x > (select x from fact)",
    "scalar_of_columns": "select k from fact where x > (select x, k from "
                         "fact where k = 200)",
    "in_of_columns": "select k from fact where d in (select dk, dv from "
                     "dim)",
    "exists_or_other_keys": "select dk from dim where exists (select * from "
                            "fact where d = dk and k = 1) or exists (select "
                            "* from fact where k = dv)",
    "union_of_other_types": "select dk from dim where exists (select * from "
                            "fact where d = dk) or exists (select * from "
                            "fact where s = dk)",
    "correlated_non_equality": "select k from fact f1 where x > (select "
                               "avg(x) from fact f2 where f2.k < f1.k)",
    "correlated_not_aggregate": "select k from fact f1 where x > (select "
                                "x from fact f2 where f2.k = f1.k)",
    "correlated_in_expression": "select k from fact f1 where k = 1 or d in "
                                "(select dk from dim where dv = f1.k)",
    "exists_in_select": "select exists (select * from dim) from fact",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_subqueries_raise_sql_error(name):
    with pytest.raises(SqlError):
        _port_rows(REFUSED[name], _tables(1))


def _plan_nodes(plan):
    yield plan
    for c in plan.children:
        yield from _plan_nodes(c)


SEMI_SQL = ("select k, dname from fact, dim where d = dk and dv = 2 and "
            "k in (select dv from dim where dname = 'd3')")


@pytest.mark.parametrize("rule_on", [True, False])
def test_rewrite_filter_semi_makes_the_comma_join_an_equi_join(
        rule_on, monkeypatch):
    """The IN lowering stacks its semi join between WHERE's filter and
    the FROM list's cross join: ``_rewrite_filter_semi`` sinks the
    conjuncts over the left side into it, where the comma join becomes
    an equi-join on ``d = dk`` with ``dv = 2`` below it; without the rule
    the cross join stays."""
    if not rule_on:
        monkeypatch.setattr(logical_opt, "_rewrite_filter_semi",
                            lambda f: f)
    s = TpuSession(device="cpu")
    _register(s, _tables(1), 3)
    plan = sql_to_plan(SEMI_SQL, s._views, s)
    joins = [n for n in _plan_nodes(plan) if isinstance(n, L.Join)]
    semi = [j for j in joins if j.how == "semi"]
    assert len(semi) == 1
    left = semi[0].children[0]
    if rule_on:
        assert isinstance(left, L.Join) and left.how == "inner"
        assert [logical_opt._refs(k) for k in left.left_keys] == [{"d"}]
        assert not [j for j in joins if j.how == "cross"]
        right = left.children[1]
        assert isinstance(right, L.Filter) and "dv" in repr(right.condition)
    else:
        assert [j for j in joins if j.how == "cross"]
    _check(SEMI_SQL, _tables(1), True)


def _union_inputs(parts):
    rng = np.random.default_rng(5)
    a = pa.table({"x": pa.array(rng.integers(0, 9, 30)),
                  "y": pa.array(rng.random(30), mask=rng.random(30) < 0.2)})
    b = pa.table({"u": pa.array(rng.integers(0, 9, 17)),
                  "v": pa.array(rng.random(17))})
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 8}),
                   device="cpu")
    return s, [s.create_dataframe(t, num_partitions=parts)._plan
               for t in (a, b)], (a, b)


@pytest.mark.parametrize("parts", [1, 3])
def test_union_concatenates_children_under_the_first_names(parts):
    s, plans, (a, b) = _union_inputs(parts)
    union = L.Union(plans)
    assert union.schema.names == ["x", "y"]
    assert [f.nullable for f in union.schema] == [True, True]
    physical = s.plan(union)
    assert isinstance(physical, TpuUnion)
    assert physical.num_partitions() == 2 * parts
    got = s.execute_to_arrow(union)
    assert got.column_names == ["x", "y"]
    want = a.to_pylist() + [{"x": r["u"], "y": r["v"]}
                            for r in b.to_pylist()]
    assert got.to_pylist() == want
    assert union.estimated_rows() == 47


def test_union_refuses_differing_types():
    """Children of column types with no common type (a string against a
    number) raise; a narrower numeric child widens to the union's type,
    and ``TpuUnion`` refuses a child that cannot widen to it."""
    s, plans, _ = _union_inputs(1)
    words = s.create_dataframe(pa.table({
        "x": pa.array(["a", "b"]), "y": pa.array([0.5, 1.5])}))._plan
    with pytest.raises(ValueError, match="no common type"):
        L.Union([plans[0], words])
    narrow = s.create_dataframe(pa.table({
        "x": pa.array([1, 2], pa.int32()),
        "y": pa.array([0.5, 1.5])}))._plan
    union = L.Union([narrow, plans[0]])
    assert [f.dtype.name for f in union.schema] == ["bigint", "double"]
    assert s.execute_to_arrow(union).column(0).to_pylist()[:2] == [1, 2]
    with pytest.raises(ValueError, match="column types"):
        TpuUnion(L.Union(plans).schema, [s.plan(plans[0]), s.plan(words)])


WORDS = ["straße", "ÉCOLE", "Mixed Case 1", "ñandú", "", "ASCII only",
         "日本語 text", None, "İstanbul", "ﬁne"]


def test_upper_lower_match_the_reference_on_non_ascii():
    """ASCII letters change case; every other byte (each byte of a
    multi-byte UTF-8 character) stays, as in the JAX package's byte
    tables, so ``upper('straße')`` is ``'STRAßE'``."""
    t = {"w": pa.table({"i": pa.array(range(len(WORDS)), pa.int64()),
                        "s": pa.array(WORDS, pa.string())})}
    sql = "select i, upper(s) u, lower(s) l from w"
    got = _port_rows(sql, t)
    assert canon_rows(got) == canon_rows(_jax_rows(sql, t))
    by_i = {r[0]: r[1:] for r in got}
    assert by_i[0] == ("STRAßE", "straße")
    assert by_i[1] == ("ÉCOLE", "École")
    assert by_i[3] == ("ñANDú", "ñandú")
    assert by_i[7] == (None, None)


SESSIONLESS = {
    "scalar": "select k from fact where x > (select avg(x) from fact)",
    "scalar_in_select": "select (select max(d) from fact) m from dim",
    "not_in": "select k from fact where d not in (select dk from dim)",
    "in_in_or": "select k from fact where k = 1 or d in (select dk "
                "from dim)",
    "exists": "select dk from dim where exists (select * from fact)",
}


@pytest.mark.parametrize("name", sorted(SESSIONLESS))
def test_sql_to_plan_without_a_session_refuses_to_run_a_subquery(name):
    views = {n: L.LocalRelation(t) for n, t in _tables(1).items()}
    with pytest.raises(SqlError, match="session"):
        sql_to_plan(SESSIONLESS[name], views)


def test_sql_to_plan_without_a_session_plans_decorrelated_joins():
    """A correlated EXISTS, an IN as a conjunct and a correlated scalar
    comparison need nothing run: they plan as joins without a
    session."""
    views = {n: L.LocalRelation(t) for n, t in _tables(1).items()}
    plan = sql_to_plan(
        "select dk from dim where exists (select * from fact where d = dk) "
        "and dk in (select d from fact) and dv > (select avg(k) from fact "
        "where d = dk)", views)
    hows = sorted(n.how for n in _plan_nodes(plan) if isinstance(n, L.Join))
    assert hows == ["inner", "semi", "semi"]


def test_helper_columns_are_fresh_and_do_not_leak():
    """Several subqueries in one query take distinct helper names, and
    none reaches the output."""
    s = TpuSession(device="cpu")
    _register(s, _tables(1), 3)
    sql = QUERIES["three_exists"][0]
    plan = sql_to_plan(sql, s._views, s)
    names = [f.name for n in _plan_nodes(plan) for f in n.schema
             if f.name.startswith("__ck")]
    assert len(set(names)) >= 4
    assert s.sql(sql).to_arrow().column_names == ["dk", "dname"]
    star = s.sql(QUERIES["scalar_corr_star"][0]).to_arrow()
    assert star.column_names == ["dk", "dname", "dv"]


def test_subquery_node_fields_are_the_parsers():
    from spark_rapids_tpu_torch.api import sql as S
    q = S.parse_sql("select k from fact where not exists (select * from "
                    "dim) and d not in (select dk from dim) and x > "
                    "(select 1 from dim)")
    conj = S._split(q.where, "and")
    assert isinstance(conj[0], S.NotOp) and \
        isinstance(conj[0].child, S.Exists)
    assert isinstance(conj[1], S.InSub) and conj[1].negated
    assert isinstance(conj[2].right, S.ScalarSub)
    assert [f.name for f in dataclasses.fields(S.InSub)] == [
        "child", "query", "negated"]
