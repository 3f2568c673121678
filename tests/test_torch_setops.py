"""Set operations and SELECT DISTINCT through the PyTorch port's SQL,
against the JAX package, on the CPU.

Small seeded tables (``_tables``: three of one shape, with NULLs in the
int64 key ``k``, a string ``s`` that holds both ``''`` and NULL, and a
DATE ``d`` with NULLs) go through the port's ``session.sql``
(``device="cpu"``) and through the JAX package's engine and its pyarrow
oracle; rows agree as multisets (``tests/harness._compare_rows``: floats
within 1e-9 relative; integers, strings, dates and NULLs equal), and a
query whose ORDER BY fixes the order compares in order.

The constructs: UNION ALL, UNION, INTERSECT and EXCEPT, whose null-safe
keys match two NULLs and keep ``''`` apart from NULL; three-way chains,
parenthesised operands, a trailing ORDER BY / LIMIT of the whole set
operation and one inside a parenthesised SELECT, WITH over a set
operation, a set operation in a CTE and in a derived table, SELECT
DISTINCT with and without ORDER BY, q76's shape (three branches of
literal strings under a grouped count and sum) with rows.

Where the reference is at fault the port follows Spark, and each test
shows the reference's answer beside a hand-computed Spark answer:
INTERSECT ALL and EXCEPT ALL (the reference answers the distinct forms;
the port raises ``SqlError``), a union of int64 and float64 (the
reference narrows to the first child's type; the port widens), and
``a UNION b INTERSECT c`` (Spark binds INTERSECT tighter).  The
optimizer's filter push-down through a union and below an aggregate's
keys, and its constant folding, are held to their plan shapes and to
the rows without them.
"""
import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api.sql import SqlError, sql_to_plan
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import logical_opt

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_cpu_session, with_tpu_session

torch.set_num_threads(1)

DAY0 = datetime.date(2000, 1, 1)


def _table(seed: int, n: int = 150) -> pa.Table:
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, n).astype(object)
    k[rng.random(n) < 0.1] = None
    s = rng.choice(np.array(["a", "b", "", "cc"], dtype=object), n)
    s[rng.random(n) < 0.1] = None
    d = [None if rng.random() < 0.1 else
         DAY0 + datetime.timedelta(days=int(rng.integers(0, 4)))
         for _ in range(n)]
    return pa.table({
        "k": pa.array(list(k), pa.int64()),
        "s": pa.array(list(s), pa.string()),
        "d": pa.array(d, pa.date32()),
        "x": pa.array(rng.random(n) * 10, pa.float64()),
        "i": pa.array(rng.integers(0, 4, n).astype(np.int32)),
    })


def _tables():
    """``a``, ``b``, ``c``; and ``fact``/``dim``, whose key sets of an OR
    of EXISTS are int32 (``d``) and int64 (``k``)."""
    rng = np.random.default_rng(4)
    fact = pa.table({"k": pa.array(rng.integers(0, 12, 80)),
                     "d": pa.array(rng.integers(20, 40, 80).astype(
                         np.int32))})
    dim = pa.table({"dk": pa.array(np.arange(0, 40, 3, dtype=np.int64))})
    return {"a": _table(1), "b": _table(2), "c": _table(3), "fact": fact,
            "dim": dim}


def _register(session, tables, parts=3):
    for name, t in tables.items():
        session.create_dataframe(t, num_partitions=parts) \
            .create_or_replace_temp_view(name)
    return session


def _port_session(tables, parts=3):
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 64}),
                   device="cpu")
    return _register(s, tables, parts)


def _port_rows(sql, tables, parts=3):
    return _port_session(tables, parts).sql(sql).collect()


def _jax_rows(sql, tables, engine, parts=3):
    return engine(lambda s: _register(s, tables, parts).sql(sql).collect())


#: (query, whether its ORDER BY fixes the row order)
QUERIES = {
    "union_all": ("select k, s, d from a union all select k, s, d from b",
                  False),
    "union": ("select k, s, d from a union select k, s, d from b", False),
    "intersect": ("select k, s, d from a intersect select k, s, d from b",
                  False),
    "except": ("select k, s, d from a except select k, s, d from b", False),
    "union_renames_right": ("select k as key, s from a where i = 1 union "
                            "all select i, s from b where k = 2", False),
    "three_way_union_all": ("select s, d from a union all select s, d "
                            "from b union all select s, d from c", False),
    "three_way_except": ("select k, s from a except select k, s from b "
                         "where i = 0 except select k, s from c where "
                         "i = 1", False),
    "three_way_intersect": ("select s, d from a intersect select s, d "
                            "from b intersect select s, d from c", False),
    "parenthesised_operands": ("(select k, s from a where i < 2) except "
                               "(select k, s from b where i > 0)", False),
    "order_limit_of_setop": ("select k, s from a union select k, s from b "
                             "order by k desc nulls last, s limit 7",
                             True),
    "order_by_names": ("select k, d from a union select k, d from b "
                       "order by d, k", True),
    "order_limit_in_parentheses": ("(select k, x from a order by x desc "
                                   "limit 3) union all select k, x from "
                                   "b where k = 4", False),
    "with_over_setop": ("with w as (select k, s from a where i = 2) "
                        "select k, s from w union select k, s from b "
                        "where i = 3", False),
    "setop_in_cte": ("with u as (select k, x from a union all select k, "
                     "x from b) select k, count(*) n, sum(x) sx from u "
                     "group by k", False),
    "setop_in_derived_table": ("select s, count(*) n from (select s, d "
                               "from a intersect select s, d from b) t "
                               "group by s", False),
    "derived_parenthesised_except": ("select count(*) cnt from ((select "
                                     "s, d from a) except (select s, d "
                                     "from b where i = 0)) t", False),
    "select_distinct": ("select distinct s, d from a", False),
    "select_distinct_order": ("select distinct k, i from a order by k "
                              "desc, i limit 9", True),
    "select_distinct_grouped": ("select distinct i, count(*) from a group "
                                "by i, k", False),
    "union_then_join": ("select t.k, t.s, count(*) n from (select k, s "
                        "from a union all select k, s from b) t, c where "
                        "t.k = c.k and c.i = 1 group by t.k, t.s", False),
    "string_coalesce": ("select k, coalesce(s, 'none') c, nvl(s, '') e "
                        "from a where i < 2", False),
    "or_exists_key_sets_widen": ("select dk from dim where exists (select "
                                 "* from fact where d = dk) or exists "
                                 "(select * from fact where k = dk)",
                                 False),
    "date_keys_intersect": ("select d from a where i = 0 intersect select "
                            "d from b", False),
    "q76_shape": ("select channel, col_name, i, count(*) cnt, sum(x) sx "
                  "from (select 'store' as channel, 'k' col_name, i, x "
                  "from a where k is null union all select 'web' as "
                  "channel, 's' col_name, i, x from b where s is null "
                  "union all select 'catalog' as channel, 'd' col_name, "
                  "i, x from c where d is null) foo group by channel, "
                  "col_name, i order by channel, col_name, i", True),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_setop_matches_jax_and_oracle(name):
    sql, ordered = QUERIES[name]
    tables = _tables()
    got = _port_rows(sql, tables)
    assert got, f"{name}: no rows"
    for engine in (with_tpu_session, with_cpu_session):
        want = _jax_rows(sql, tables, engine)
        if ordered:
            _compare_rows(want, got, rel=DEFAULT_FLOAT_REL)
        else:
            _compare_rows(canon_rows(want), canon_rows(got),
                          rel=DEFAULT_FLOAT_REL)


def test_setop_order_by_ordinal():
    """Ordinals of a set operation's ORDER BY name its output columns
    (the reference sorts by them as constants, so it is held to the
    names instead)."""
    tables = _tables()
    base = "select k, d from a union select k, d from b order by "
    assert _port_rows(base + "2, 1", tables) == \
        _port_rows(base + "d, k", tables)


def _one_col(**cols):
    return {name: pa.table({"x": pa.array(v[0], v[1])})
            for name, v in cols.items()}


@pytest.mark.parametrize("op,spark", [("intersect", [1, 1, 2]),
                                      ("except", [1, 3])])
def test_intersect_except_all_raise_where_reference_drops_all(op, spark):
    """``a INTERSECT ALL b`` and ``a EXCEPT ALL b`` keep duplicates in
    Spark; the reference answers the distinct forms, and the port
    raises rather than copy that answer."""
    tables = _one_col(a=([1, 1, 1, 2, 3], pa.int64()),
                      b=([1, 1, 2, 2], pa.int64()))
    sql = f"select x from a {op} all select x from b"
    distinct = sorted(r[0] for r in _jax_rows(
        f"select x from a {op} select x from b", tables, with_tpu_session))
    ref = sorted(r[0] for r in _jax_rows(sql, tables, with_tpu_session))
    assert ref == distinct != spark
    with pytest.raises(SqlError, match="ALL is not supported"):
        _port_rows(sql, tables)
    assert sorted(r[0] for r in _port_rows(
        f"select x from a {op} select x from b", tables)) == distinct


def test_union_widens_where_reference_narrows():
    """int64 ``UNION ALL`` float64 is float64 in Spark; the reference
    casts the second child to the first child's int64."""
    tables = _one_col(a=([1, 1, 1, 2, 3], pa.int64()),
                      c=([2.5, 7.9], pa.float64()))
    sql = "select x from a union all select x from c"
    ref = sorted(r[0] for r in _jax_rows(sql, tables, with_tpu_session))
    assert ref == [1, 1, 1, 2, 2, 3, 7]
    got = sorted(r[0] for r in _port_rows(sql, tables))
    assert got == [1.0, 1.0, 1.0, 2.0, 2.5, 3.0, 7.9]
    assert all(isinstance(v, float) for v in got)
    # int32 under int64, either side first
    t = _tables()
    for sql in ("select i from a union all select k from b",
                "select k from a union all select i from b"):
        s = _port_session(t)
        assert s.sql(sql).to_arrow().schema.field(0).type == pa.int64()
        _compare_rows(canon_rows(_jax_rows(sql, t, with_cpu_session)),
                      canon_rows(s.sql(sql).collect()))


def test_null_column_against_a_typed_one():
    """A side that selects NULL meets the other side's NULL rows alone."""
    tables = _tables()
    got = _port_rows("select null from a intersect select k from b",
                     tables)
    assert got == [(None,)]
    got = _port_rows("select k from b except select null from a", tables)
    assert sorted(r[0] for r in got) == sorted(
        {r[0] for r in _port_rows("select k from b where k is not null",
                                  tables)})


def test_union_of_string_and_number_raises():
    with pytest.raises(SqlError, match="no common type"):
        _port_rows("select s from a union all select k from b", _tables())
    with pytest.raises(SqlError):
        _port_rows("select d from a intersect select k from b", _tables())
    with pytest.raises(SqlError, match="columns"):
        _port_rows("select k, s from a union select k from b", _tables())


def test_intersect_binds_tighter_than_union():
    """Spark: ``p UNION q INTERSECT r`` is ``p UNION (q INTERSECT r)``;
    the reference parses it ``(p UNION q) INTERSECT r``."""
    tables = _one_col(p=([1], pa.int64()), q=([2, 3], pa.int64()),
                      r=([3], pa.int64()))
    sql = "select x from p union select x from q intersect select x from r"
    assert sorted(r[0] for r in _port_rows(sql, tables)) == [1, 3]
    assert sorted(r[0] for r in _jax_rows(sql, tables,
                                          with_tpu_session)) == [3]
    paren = "select x from p union (select x from q intersect select x " \
        "from r)"
    assert sorted(r[0] for r in _jax_rows(paren, tables,
                                          with_tpu_session)) == [1, 3]


@pytest.mark.parametrize("values,other,intersect,except_", [
    (["", None, "x"], [None], [None], ["", "x"]),
    (["", None, "x"], [""], [""], [None, "x"]),
    ([DAY0, None], [None], [None], [DAY0]),
    ([datetime.date(1970, 1, 1), None], [datetime.date(1970, 1, 1)],
     [datetime.date(1970, 1, 1)], [None])])
def test_null_safe_keys_keep_default_apart_from_null(values, other,
                                                     intersect, except_):
    """Two NULLs match; ``''`` (a string's null default) and 1970-01-01
    (a date's) match only themselves, never NULL."""
    typ = pa.date32() if isinstance(values[0], datetime.date) \
        else pa.string()
    tables = _one_col(a=(values, typ), b=(other, typ))
    for op, want in (("intersect", intersect), ("except", except_)):
        sql = f"select x from a {op} select x from b"
        got = canon_rows(_port_rows(sql, tables))
        assert got == canon_rows([(v,) for v in want])
        assert canon_rows(_jax_rows(sql, tables, with_tpu_session)) == got


@pytest.mark.parametrize("sql", [
    "select count(distinct k), count(distinct x) from a",
    "select k from a where d = timestamp '2000-01-01 00:00:00'",
    "select distinct k from a order by x"])
def test_outside_the_slice_raises(sql):
    with pytest.raises(SqlError):
        _port_rows(sql, _tables())


def test_cast_to_string_lifted():
    """``cast(k as string)``, refused before the casts to STRING: the
    key's decimal digits."""
    rows = _port_rows("select k, cast(k as string) from a", _tables())
    assert rows and all(r[1] == (None if r[0] is None else str(r[0]))
                        for r in rows)


def _views(tables):
    return _port_session(tables)._views


def _nodes(plan, kind):
    out = [plan] if isinstance(plan, kind) else []
    for c in plan.children:
        out += _nodes(c, kind)
    return out


UNION_FILTER = ("select * from (select k, s, i from a union all select k, "
                "s, i from b) u where k = 2 and s <> 'a'")
AGG_FILTER = ("select * from (select k, i, sum(x) sx from a group by k, i) "
              "g where k = 3 and sx > 1 and i < 2")
CONSTANT_FILTER = ("select k, tag from (select k, 'x' tag from a union all "
                   "select k, 'y' tag from b) u where tag = 'x' and k > 1")


def test_filter_goes_into_each_union_child():
    plan = sql_to_plan(UNION_FILTER, _views(_tables()))
    (u,) = _nodes(plan, L.Union)
    assert not any(isinstance(n, L.Filter) and u in n.children
                   for n in _nodes(plan, L.Filter))
    for child in u.children:
        assert _nodes(child, L.Filter), "a union child has no filter"


def test_filter_on_group_keys_goes_below_the_aggregate():
    plan = sql_to_plan(AGG_FILTER, _views(_tables()))
    (agg,) = _nodes(plan, L.Aggregate)
    above = [n for n in _nodes(plan, L.Filter) if agg in n.children]
    assert len(above) == 1 and "__agg" in repr(above[0].condition)
    below = _nodes(agg.children[0], L.Filter)
    assert below and "col(k)" in repr(below[0].condition) and \
        "col(i)" in repr(below[0].condition)


def test_constant_filter_empties_a_union_branch():
    """``tag = 'x'`` over a branch that selects ``'y' tag`` is decided
    while the plan is optimized: that branch is an EmptyRelation."""
    plan = sql_to_plan(CONSTANT_FILTER, _views(_tables()))
    (u,) = _nodes(plan, L.Union)
    assert len(_nodes(u.children[1], L.EmptyRelation)) == 1
    assert not _nodes(u.children[1], L.LocalRelation)[0].table.num_rows
    assert not _nodes(u.children[0], L.EmptyRelation)


def _no_rule(f):
    return f


@pytest.mark.parametrize("sql,rules", [
    (UNION_FILTER, ["_rewrite_filter_union"]),
    (AGG_FILTER, ["_rewrite_filter_aggregate"]),
    (CONSTANT_FILTER, ["_fold_constants", "_rewrite_filter_union"])])
def test_push_down_keeps_the_rows(monkeypatch, sql, rules):
    tables = _tables()
    with_rules = canon_rows(_port_rows(sql, tables))
    assert with_rules
    for rule in rules:
        monkeypatch.setattr(logical_opt, rule, _no_rule)
    assert canon_rows(_port_rows(sql, tables)) == with_rules
    _compare_rows(canon_rows(_jax_rows(sql, tables, with_cpu_session)),
                  with_rules)


def test_keyless_aggregate_keeps_its_row_under_a_false_filter():
    """A filter that reads no column stays above a keyless aggregate:
    ``where 1 = 0`` over ``count(*)`` gives no row, not a count of 0."""
    tables = _tables()
    sql = "select * from (select count(*) n from a) t where 1 = 0"
    assert _port_rows(sql, tables) == []
    sql = "select n from (select count(*) n from a where 1 = 0) t"
    assert [tuple(r) for r in _port_rows(sql, tables)] == [(0,)]
