"""DATE literals, INTERVAL and the DATE functions through the PyTorch
port, against the JAX package, on the CPU.

Two seeded tables go through the port (``device="cpu"``,
``batchSizeRows`` 8 over 3 partitions) and through the JAX package's
engine and its pyarrow oracle: ``t1`` mirrors the reference's
``tests/test_sql.py`` table (1500 days from 1995-01-01), and ``edges``
holds dates across month, year and leap-year edges, century years
(1900 is no leap year, 2000 is), and dates before 1970 and before 1600,
with NULLs.  Every field function (``year``, ``month``, ``day`` /
``dayofmonth``, ``quarter``, ``dayofweek``, ``weekday``,
``dayofyear``, ``last_day``), ``date_add``, ``date_sub``, ``datediff``,
``DATE 'yyyy-mm-dd'`` literals and ``date ± INTERVAL n DAYS`` run in SQL
text and through the DataFrame API; rows agree as multisets, dates,
integers and NULLs equal.  ``date ± n`` (Spark's ``date_add`` /
``date_sub``; the JAX package has no such rule) is held to the port's
own ``date_add``, and the fields are also held to Python's ``datetime``.
What stays outside the slice raises ``SqlError``.
"""
import datetime
import functools

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.api import TpuSession, functions as F
from spark_rapids_tpu_torch.api.sql import SqlError
from spark_rapids_tpu_torch.config import TpuConf

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_cpu_session, with_tpu_session

torch.set_num_threads(1)


def _t1() -> pa.Table:
    rng = np.random.default_rng(42)
    n = 200
    return pa.table({
        "k": pa.array(rng.integers(0, 20, n), pa.int64()),
        "v": pa.array(rng.integers(-100, 100, n), pa.int64()),
        "d": pa.array([datetime.date(1995, 1, 1) + datetime.timedelta(
            days=int(i)) for i in rng.integers(0, 1500, n)], pa.date32()),
    })


EDGE_DAYS = ["1969-12-31", "1970-01-01", "1900-02-28", "1900-03-01",
             "2000-02-28", "2000-02-29", "2000-03-01", "2000-12-31",
             "2001-01-01", "2004-02-29", "2100-03-01", "1600-02-29",
             "1583-01-01", "1960-06-15", "2023-12-31", "2024-01-01",
             "1999-09-30", "1999-10-01", "2002-03-31", "2002-04-01"]


def _edges() -> pa.Table:
    days = [datetime.date.fromisoformat(s) for s in EDGE_DAYS] + [None]
    n = len(days)
    d2 = [None if i == 3 else datetime.date(2000, 1, 1) +
          datetime.timedelta(days=37 * i - 400) for i in range(n)]
    return pa.table({"id": pa.array(np.arange(n, dtype=np.int64)),
                     "d": pa.array(days, pa.date32()),
                     "d2": pa.array(d2, pa.date32()),
                     "n": pa.array([None if i == 5 else (i * 13) % 61 - 30
                                    for i in range(n)], pa.int32())})


TABLES = {"t1": _t1(), "edges": _edges()}


def _port(rows=8, parts=3):
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
    assert got
    for engine in engines:
        _compare_rows(_jax_rows(sql, engine), got, rel=DEFAULT_FLOAT_REL)
    return got


DATE_FUNCS_SQL = """
    SELECT year(d) AS y, month(d) AS m, dayofmonth(d) AS dd,
           date_add(d, 10) AS d10
    FROM t1 WHERE d >= DATE '1996-06-01'
      AND d < DATE '1998-12-01' - INTERVAL '90' DAY"""


@pytest.mark.parametrize("api", ["sql", "dataframe"])
def test_date_funcs_and_literals(api):
    """The reference's ``test_date_funcs_and_literals``."""
    s = _port()
    if api == "sql":
        got = s.sql(DATE_FUNCS_SQL).collect()
    else:
        lo, hi = datetime.date(1996, 6, 1), datetime.date(1998, 12, 1)
        df = s.sql("select * from t1")
        got = df.filter((F.col("d") >= lo) & (F.col("d") < F.date_sub(
            F.lit(hi), 90))).select(
            F.year("d").alias("y"), F.month("d").alias("m"),
            F.dayofmonth("d").alias("dd"),
            F.date_add("d", 10).alias("d10")).collect()
    rows = _check(DATE_FUNCS_SQL, got)
    assert all(1996 <= r[0] <= 1998 for r in rows)


#: (SQL expression over ``edges``, DataFrame expression, Python's answer
#: for a date ``d`` or None for no hand-check)
FIELDS = {
    "year": ("year(d)", lambda: F.year("d"), lambda d: d.year),
    "month": ("month(d)", lambda: F.month("d"), lambda d: d.month),
    "day": ("day(d)", lambda: F.dayofmonth("d"), lambda d: d.day),
    "dayofmonth": ("dayofmonth(d)", lambda: F.dayofmonth("d"),
                   lambda d: d.day),
    "quarter": ("quarter(d)", lambda: F.quarter("d"),
                lambda d: (d.month - 1) // 3 + 1),
    "dayofweek": ("dayofweek(d)", lambda: F.dayofweek("d"),
                  lambda d: d.isoweekday() % 7 + 1),
    "weekday": ("weekday(d)", lambda: F.weekday("d"),
                lambda d: d.weekday()),
    "dayofyear": ("dayofyear(d)", lambda: F.dayofyear("d"),
                  lambda d: d.timetuple().tm_yday),
    "last_day": ("last_day(d)", lambda: F.last_day("d"),
                 lambda d: (d.replace(day=28) + datetime.timedelta(
                     days=4)).replace(day=1) - datetime.timedelta(days=1)),
    "date_add": ("date_add(d, 45)", lambda: F.date_add("d", 45),
                 lambda d: d + datetime.timedelta(days=45)),
    "date_sub": ("date_sub(d, 400)", lambda: F.date_sub("d", 400),
                 lambda d: d - datetime.timedelta(days=400)),
    "datediff": ("datediff(d, d2)", lambda: F.datediff("d", "d2"), None),
}


@pytest.mark.parametrize("api", ["sql", "dataframe"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_date_function_matches_jax_oracle_and_python(name, api):
    sql_e, df_e, py = FIELDS[name]
    sql = f"select id, {sql_e} f from edges"
    s = _port()
    if api == "sql":
        got = s.sql(sql).collect()
    else:
        got = s.sql("select * from edges").select(
            "id", df_e().alias("f")).collect()
    _check(sql, got)
    if py is not None:
        days = TABLES["edges"]["d"].to_pylist()
        for i, f in got:
            assert f == (None if days[i] is None else py(days[i])), \
                (name, days[i], f)


INTERVAL_SQL = {
    "plus_interval": "select id, d + interval 30 days a from edges",
    "minus_interval": "select id, d - interval '61' day a from edges",
    "interval_plus": "select id, interval 2 days + d a from edges",
    "literal_window": """select id from edges
        where d between date '1999-12-01' and date '1999-12-01' + interval
        120 days or d2 < date '1970-01-01' - interval 1 day""",
    "literal_select": "select id, date '2000-02-28' + interval 2 days a, "
                      "datediff(d, date '2000-01-01') b from edges",
}


@pytest.mark.parametrize("name", sorted(INTERVAL_SQL))
def test_date_literals_and_intervals_match_jax_and_oracle(name):
    sql = INTERVAL_SQL[name]
    _check(sql, _port().sql(sql).collect())


def test_date_literal_plus_interval_by_hand():
    """``date '2000-02-28' + interval 2 days`` is 2000-03-01 (a leap
    year), and a DATE literal compares with a DATE column."""
    rows = _port().sql("select date '2000-02-28' + interval 2 days a, "
                       "date '1900-02-28' + interval 1 day b from edges "
                       "where d = date '2000-02-29'").collect()
    assert rows == [(datetime.date(2000, 3, 1), datetime.date(1900, 3, 1))]


def test_date_plus_integer_is_date_add():
    """``d + n``, ``n + d`` and ``d - n`` are Spark's ``date_add`` and
    ``date_sub`` (the JAX package has no such rule); the days may be a
    column (the JAX package's SQL takes a literal there)."""
    s = _port()
    got = s.sql("select id, d + n, n + d, d - 7, d + 1 from edges") \
        .collect()
    want = s.sql("select id, date_add(d, n), date_add(d, n), "
                 "date_sub(d, 7), date_add(d, 1) from edges").collect()
    assert sorted(got, key=lambda r: r[0]) == \
        sorted(want, key=lambda r: r[0])
    days = TABLES["edges"]["d"].to_pylist()
    ns = TABLES["edges"]["n"].to_pylist()
    for r in got:
        d, n = days[r[0]], ns[r[0]]
        assert r[1] == (None if d is None or n is None else
                        d + datetime.timedelta(days=n))
        assert r[3] == (None if d is None else
                        d - datetime.timedelta(days=7))


@pytest.mark.parametrize("sql,what", [
    ("select d + interval 1 month from edges", "unit 'month'"),
    ("select n + interval 1 day from edges", "only a DATE takes days"),
    ("select interval 1 day from edges", "INTERVAL is supported only"),
    ("select d - d2 from edges", "date arithmetic"),
    ("select d * 2 from edges", "date arithmetic"),
    ("select year(n) from edges", "takes a DATE"),
    ("select date_add(d, 1.5) from edges", "integer count of days"),
    ("select datediff(d, n) from edges", "takes a DATE"),
    ("select date '2000-02-30' from edges", "not a DATE literal"),
    ("select timestamp '2000-01-01 00:00:00' from edges", "TIMESTAMP"),
])
def test_outside_the_slice_raises(sql, what):
    with pytest.raises(SqlError, match=what):
        _port().sql(sql)
