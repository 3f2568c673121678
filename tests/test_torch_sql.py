"""SQL text through the PyTorch port against the JAX package, on the CPU.

The subset includes, since the flat TPC-DS slice, BETWEEN, [NOT] IN
lists, [NOT] LIKE's four device forms, IS [NOT] NULL, CASE, ``-``, ``/``,
unary minus, ``||``, substring, coalesce, avg and the moments, HAVING,
GROUP BY without aggregates, select expressions over group keys,
qualified names of self-joins, OR factoring and a LEFT JOIN followed by
comma relations.

Each construct of the port's SQL subset runs on the same seeded tables
through the port's ``session.sql`` (``device="cpu"``) and the JAX
package's, and the rows must agree (floats within 1e-9 relative; a query
whose ORDER BY fixes the order compares in order).  A construct outside
the subset raises ``SqlError`` before any work.
"""
import re

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api.sql import SqlError, parse_sql
from spark_rapids_tpu_torch.config import TpuConf

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_tpu_session

WORDS = ["Music", "Books", "Electronics", "", "Home", "Sports", "Men",
         "a somewhat longer category name", "Women", "Jewelry"]


def _tables(seed: int = 0, n: int = 600):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 12, n)
    s = rng.choice(WORDS, n).astype(object)
    s[rng.random(n) < 0.05] = None
    a = rng.integers(-1000, 1000, n).astype(object)
    a[rng.random(n) < 0.05] = None
    fact = pa.table({
        "k": pa.array(k, pa.int64()),
        "s": pa.array(list(s), pa.string()),
        "a": pa.array(list(a), pa.int64()),
        "x": pa.array(rng.random(n) * 100, pa.float64()),
        "d": pa.array(rng.integers(0, 40, n).astype(np.int32), pa.int32()),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(0, 40, dtype=np.int64)),
        "dname": pa.array([f"d{i % 7}" for i in range(40)], pa.string()),
        "dv": pa.array(np.arange(40, dtype=np.int32) % 5, pa.int32()),
    })
    return {"fact": fact, "dim": dim}


def _register(session, tables, parts):
    for name, t in tables.items():
        session.create_dataframe(t, num_partitions=parts) \
            .create_or_replace_temp_view(name)


def _port_rows(sql, tables, parts=3):
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 256}),
                   device="cpu")
    _register(s, tables, parts)
    return s.sql(sql).collect()


def _jax_rows(sql, tables, parts=3):
    def fn(s):
        _register(s, tables, parts)
        return s.sql(sql).collect()
    return with_tpu_session(fn)


QUERIES = {
    "star_filter": "select * from fact where k > 7",
    "aliases": "select k as key, a val, x from fact where s = 'Music'",
    "and_or_not": "select k, a from fact where (k >= 9 or not (a < 0)) "
                  "and s <> 'Books' and d <= 20",
    "not_equal": "select k, s from fact where k != 3 and a > -500",
    "arithmetic": "select k + 1 as k1, a * 2 as a2, a % 7 as r from fact "
                  "where k < 4",
    "group_by": "select s, count(*) as n, count(a) as na, sum(a) sa, "
                "max(x) mx, sum(x) sx from fact group by s",
    "group_two_keys": "select k, s, sum(x) as total from fact "
                      "where k < 6 group by k, s",
    "global_agg": "select count(*) as n, sum(x) as sx, max(a) as ma "
                  "from fact where d < 30",
    "global_agg_empty": "select count(*) as n, sum(a) as sa from fact "
                        "where k > 100",
    "comma_join": "select dname, sum(x) as total, count(*) as n "
                  "from fact, dim where d = dk and dv >= 2 group by dname",
    "join_on": "select k, dname, x from fact join dim on d = dk "
               "where k = 2",
    "left_join": "select k, dname from fact left join dim on a = dk "
                 "where k = 5",
    "order_limit": "select s, k, sum(x) as total from fact group by s, k "
                   "order by total desc limit 7",
    "order_strings": "select s, count(*) as n from fact group by s "
                     "order by s desc nulls last limit 4",
    "order_alias_ordinal": "select k as key, count(*) as n from fact "
                           "group by k order by 2, key desc",
    "in_list": "select k, s from fact where k in (1, 2, 9) "
               "or s in ('Music', '')",
    "not_in_list": "select k from fact where k not in (1, 2, 3)",
    "like": "select k, s from fact where s like 'M%' or s like '%s' "
            "or s like '%om%' or s like 'Men'",
    "not_like": "select k from fact where s not like '%e%'",
    "between": "select k, x from fact where x between 10 and 30.5 "
               "and k not between 3 and 5",
    "is_null": "select k, a from fact where a is null or s is not null",
    "having": "select s, sum(x) as total from fact group by s "
              "having count(*) > 55 and max(a) > 900",
    "case": "select k, case when a > 0 then x when a < -900 then 0 "
            "else null end as c, case k when 1 then 10 when 2 then 20 "
            "end as n from fact where d < 30",
    "case_in_sum": "select s, sum(case when k < 5 then 1 else 0 end) as lo, "
                   "sum(case when d >= 20 then a else 0 end) as hi "
                   "from fact group by s",
    "minus_divide": "select k - d as kd, a / d as q, -a as na, -(x * 2) "
                    "as nx, x / 0 as z from fact where k < 3",
    "strings": "select substring(s, 2, 3) as sub, substr(s, 0, 2) as head, "
               "s || '/' || dname as joined, concat(dname, s) as c2 "
               "from fact, dim where d = dk and k < 4",
    "coalesce": "select k, coalesce(a, d, 0) as c, nvl(a, -1) as n "
                "from fact where k > 8",
    "avg_moments": "select s, avg(x) as ax, avg(a) aa, stddev_samp(x) sx, "
                   "stddev(a) sa, variance(x) vx, var_pop(a) vp, "
                   "stddev_pop(x) sp from fact group by s",
    "agg_ratio": "select k, stddev_samp(x) / avg(x) as cov from fact "
                 "group by k",
    "group_by_alone": "select s, d from fact where k < 3 group by s, d",
    "key_expression": "select substring(s, 1, 3) as p, count(*) as n "
                      "from fact group by s",
    "self_join": "select a.dk, b.dname from dim a, dim b "
                 "where a.dv = b.dk and a.dk < 30",
    "or_factoring": "select k, dname from fact, dim where "
                    "(d = dk and dv = 1 and x > 50) or "
                    "(d = dk and dv = 3 and k < 4)",
    "join_on_or_factoring": "select k, dname from fact join dim on "
                            "(d = dk and dv = 1) or (d = dk and x > 90)",
    "left_join_then_comma": "select k, dim.dname, d2.dv from fact left "
                            "outer join dim on (a = dk and d < 40), dim d2 "
                            "where k = d2.dk and k < 6",
}
#: queries whose ORDER BY fixes the row order
ORDERED = {"order_limit", "order_strings", "order_alias_ordinal"}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_construct_matches_jax(name):
    tables = _tables(1)
    sql = QUERIES[name]
    got = _port_rows(sql, tables)
    want = _jax_rows(sql, tables)
    assert got, f"{name}: no rows"
    if name in ORDERED:
        _compare_rows(want, got, rel=DEFAULT_FLOAT_REL)
    else:
        _compare_rows(canon_rows(want), canon_rows(got),
                      rel=DEFAULT_FLOAT_REL)


def test_order_by_limit_over_more_groups_with_string_keys():
    """A sort over many groups of a string key and a limit that cuts
    them: every row in order, ties resolved by the later keys."""
    rng = np.random.default_rng(4)
    n = 3000
    names = [f"brand#{i}" for i in range(300)] + ["", "b"]
    fact = pa.table({
        "brand": pa.array(list(rng.choice(names, n)), pa.string()),
        "yr": pa.array(rng.integers(1998, 2003, n).astype(np.int32)),
        "v": pa.array(rng.integers(1, 50, n), pa.int64()),
    })
    sql = ("select yr, brand, sum(v) as total from fact group by yr, brand "
           "order by yr, total desc, brand limit 100")
    got = _port_rows(sql, {"fact": fact}, parts=4)
    want = _jax_rows(sql, {"fact": fact}, parts=4)
    groups = _port_rows("select yr, brand, count(*) as c from fact "
                        "group by yr, brand", {"fact": fact})
    assert len(groups) > 100 and len(got) == 100
    assert got == want


UNSUPPORTED = {
    "select count(distinct k), count(distinct x) from fact": "DISTINCT",
    "select k from fact f1 where k = 1 or d in (select dk from dim where "
    "dv = f1.k)": "must be uncorrelated",
    "select k from fact where k = 1 or exists (select k from fact)":
        "EXISTS is supported only as a conjunct",
    "select k, lead(x, 1, 0) over (partition by k order by x) from fact":
        "default value",
    "select k from fact union select s from fact": "no common type",
    "select k from fact intersect all select k from fact": "INTERSECT ALL",
    "select k from fact right semi join dim on d = dk": "expected JOIN",
    "select k from fact f1 where x > (select avg(x) from fact f2 where "
    "f2.k < f1.k)": "equalities",
    "select case when k > 1 then s else 1 end from fact": "no common type",
    "select date '2000-02-30' from fact": "DATE",
    "select k from fact order by k limit 5 offset 2": "OFFSET",
    "select k from nosuchtable": "not found",
    "select nosuchcol from fact": "not found",
}


@pytest.mark.parametrize("sql", sorted(UNSUPPORTED))
def test_unsupported_construct_raises(sql):
    with pytest.raises(SqlError, match=UNSUPPORTED[sql]):
        _port_rows(sql, _tables(2, 50))


#: constructs the port refused before its string library and casts to
#: and from STRING, with a Python computation of Spark's answer per row
LIFTED = {
    "select k, s from fact where s like 'M_sic'":
        lambda s: s is not None and re.fullmatch("M.sic", s) is not None,
    "select k, s from fact where s like '%a%b%'":
        lambda s: s is not None and re.fullmatch(".*a.*b.*", s) is not None,
    "select k, s, cast(s as double) from fact": None,
    "select k, s, md5(s) from fact": None,
}


@pytest.mark.parametrize("sql", sorted(LIFTED))
def test_lifted_construct_answers(sql):
    """What ``test_unsupported_construct_raises`` refused before the
    string library: general LIKE keeps the rows Python's ``re`` matches,
    a string's CAST to double is NULL for a word that is no number, and
    ``md5`` is hashlib's."""
    import hashlib
    tables = _tables(2, 50)
    rows = _port_rows(sql, tables)
    if LIFTED[sql] is not None:
        want = [w for w in tables["fact"]["s"].to_pylist() if LIFTED[sql](w)]
        assert sorted(r[1] for r in rows) == sorted(want)
    elif "md5" in sql:
        assert all(r[2] == (None if r[1] is None else
                            hashlib.md5(r[1].encode()).hexdigest())
                   for r in rows) and len(rows) == 50
    else:
        def number(w):
            try:
                return float(w)
            except (TypeError, ValueError):
                return None
        assert all(r[2] == number(r[1]) for r in rows) and len(rows) == 50


def test_parse_shapes():
    q = parse_sql("select a x, sum(b) from t1, t2 join t3 on c = d "
                  "where e = 'it''s' group by a order by 2 desc limit 3;")
    assert [alias for _, alias in q.items] == ["x", None]
    assert len(q.from_) == 2 and q.limit == 3
    assert q.where.right.value == "it's"
    assert not q.order_by[0].ascending
