"""CAST through the PyTorch port, against the JAX package, on the CPU.

One seeded table of edge values (``TABLE``: NaN, both infinities, ±1.5,
±2.5, doubles past int32 and past int64, -0.0, int64s past int32, BOOL,
float32 and int32 columns, NULLs) goes through the port
(``device="cpu"``, ``batchSizeRows`` 4 over 2 partitions) and through the
JAX package's engine and its pyarrow oracle.  Each cast among the
numbers, BOOL and DATE runs in SQL text and through ``Col.cast``; rows
agree as multisets, floats within ``DEFAULT_FLOAT_REL`` (1e-9), integers,
booleans and NULLs equal.  Spark's non-ANSI rules are also held to
values worked out by hand (``test_cast_edges_by_hand``): a float to an
integer truncates, NaN gives 0 and the value saturates; an int64 to an
int32 wraps.  Casts to and from ``decimal(p, s)`` hold to the JAX
package on the rows both engines answer alike (``test_cast_decimal``).
Casts from and to STRING (and VARCHAR) give Spark's answers
(``test_cast_string_lifted``; ``tests/test_torch_strfuncs.py`` holds the
rest of them).  What the port does not cast raises ``SqlError``: a DATE
to a number and back, a DECIMAL of more than 18 digits, TIMESTAMP,
``tinyint`` and ``smallint``.
"""
import datetime
import functools

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.api import TpuSession, functions as F
from spark_rapids_tpu_torch.api.sql import SqlError
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.config import TpuConf

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_cpu_session, with_tpu_session

torch.set_num_threads(1)

X = [float("nan"), float("inf"), float("-inf"), 1.5, -1.5, 2.5, -2.5,
     1e10, -1e10, 3e9, -3e9, 1e19, -1e19, 0.0, -0.0, 0.7, -0.7, None,
     2147483647.9, -2147483648.9, 9.2e18, 12345.678]
I64 = [1, -1, 2**31, -2**31 - 1, 2**40 + 5, -2**40 + 7, 2**63 - 1,
       -2**63, 0, None, 4294967297, 123]


def _table() -> pa.Table:
    n = len(X)
    rng = np.random.default_rng(5)
    i = (I64 * 2)[:n]
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "x": pa.array(X, pa.float64()),
        "f": pa.array([None if v is None else v for v in X], pa.float32()),
        "i": pa.array(i, pa.int64()),
        "n": pa.array([None if k % 7 == 3 else int(v) for k, v in
                       enumerate(rng.integers(-10**9, 10**9, n))],
                      pa.int32()),
        "b": pa.array([None if k % 5 == 4 else bool(k % 2) for k in
                       range(n)], pa.bool_()),
        "d": pa.array([datetime.date(1999, 12, 30) +
                       datetime.timedelta(days=k * 37) for k in range(n)],
                      pa.date32()),
        "s": pa.array([f"{k}" for k in range(n)], pa.string()),
    })


TABLE = _table()


def _port(parts=2, rows=4):
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": rows}),
                   device="cpu")
    s.create_dataframe(TABLE, num_partitions=parts) \
        .create_or_replace_temp_view("t")
    return s


@functools.lru_cache(maxsize=None)
def _jax_rows(sql, engine_name):
    engine = {"jax": with_tpu_session, "oracle": with_cpu_session}[
        engine_name]

    def run(s):
        s.create_dataframe(TABLE, num_partitions=2) \
            .create_or_replace_temp_view("t")
        return s.sql(sql).collect()
    return canon_rows(engine(run))


#: (source column, target type name): every cast among the numbers, BOOL
#: and DATE the port runs
CASTS = [("x", "int"), ("x", "bigint"), ("x", "float"), ("x", "boolean"),
         ("f", "int"), ("f", "bigint"), ("f", "double"),
         ("i", "int"), ("i", "double"), ("i", "float"), ("i", "boolean"),
         ("n", "bigint"), ("n", "double"), ("n", "float"),
         ("b", "int"), ("b", "bigint"), ("b", "double"),
         ("d", "date"), ("x", "double"), ("i", "bigint")]

@pytest.mark.parametrize("api", ["sql", "dataframe"])
@pytest.mark.parametrize("src,to", CASTS)
def test_cast_matches_jax_and_oracle(src, to, api):
    sql = f"select id, cast({src} as {to}) c from t"
    s = _port()
    if api == "sql":
        got = s.sql(sql).collect()
    else:
        got = s.sql("select * from t").select(
            "id", F.col(src).cast(to).alias("c")).collect()
    for engine in ("jax", "oracle"):
        _compare_rows(_jax_rows(sql, engine), canon_rows(got),
                      rel=DEFAULT_FLOAT_REL)


def test_cast_edges_by_hand():
    """Spark's non-ANSI answers, worked out by hand."""
    rows = {r[0]: r[1:] for r in _port().sql(
        "select id, cast(x as int) a, cast(x as bigint) b, "
        "cast(i as int) c, cast(x as boolean) e from t").collect()}
    as_int = {X.index(v): w for v, w in (
        (1.5, 1), (-1.5, -1), (2.5, 2), (-2.5, -2), (1e10, 2**31 - 1),
        (-1e10, -2**31), (3e9, 2**31 - 1), (0.7, 0), (-0.7, 0),
        (2147483647.9, 2**31 - 1), (-2147483648.9, -2**31))}
    as_int[0] = 0                                  # NaN
    as_int[1], as_int[2] = 2**31 - 1, -2**31       # +inf, -inf
    for k, want in as_int.items():
        assert rows[k][0] == want, (X[k], rows[k])
    assert rows[0][1] == 0 and rows[1][1] == 2**63 - 1 and \
        rows[2][1] == -2**63
    assert rows[11][1] == 2**63 - 1 and rows[12][1] == -2**63   # ±1e19
    assert rows[20][1] == 9200000000000000000
    wrapped = {2**31: -2**31, -2**31 - 1: 2**31 - 1, 2**40 + 5: 5,
               -2**40 + 7: 7, 2**63 - 1: -1, -2**63: 0, 4294967297: 1}
    for k in range(len(X)):
        v = I64[k % len(I64)]
        if v in wrapped:
            assert rows[k][2] == wrapped[v], (v, rows[k])
    assert rows[17] == (None, None, rows[17][2], None)          # NULL x
    assert rows[0][3] is True and rows[13][3] is False and \
        rows[14][3] is False                       # NaN, 0.0, -0.0


def test_cast_literals_and_arithmetic():
    """q5's ``cast(0 as double)`` columns and q49's, q61's and q90's
    ratios of two casts; q54's ``cast((revenue / 50) as int)``."""
    sql = ("select id, cast(0 as double) z, cast(n as double) / "
           "cast(i as double) r, cast((x / 50) as int) seg, "
           "cast(null as int) nl from t")
    got = canon_rows(_port().sql(sql).collect())
    _compare_rows(_jax_rows(sql, "jax"), got, rel=DEFAULT_FLOAT_REL)
    assert all(r[1] == 0.0 and r[4] is None for r in got)


@pytest.mark.parametrize("sql,want", [
    ("select id, cast(s as double) from t", lambda r: float(r[0])),
    ("select id, cast(x as string) from t",
     lambda r: None if X[r[0]] is None else _java_text(X[r[0]])),
    ("select id, cast(i as varchar) from t",
     lambda r: None if I64[r[0] % len(I64)] is None
     else str(I64[r[0] % len(I64)])),
])
def test_cast_string_lifted(sql, want):
    """CAST from and to STRING and VARCHAR, which the port refused before
    its casts to and from text: the text ``s`` (the row's id) reads as a
    double, a double prints as Java's ``Double.toString`` and a bigint in
    decimal digits (Spark's answers)."""
    rows = _port().sql(sql).collect()
    assert len(rows) == len(X)
    for r in rows:
        assert r[1] == want(r) or (r[1] != r[1] and want(r) != want(r)), r


def _java_text(x: float) -> str:
    """Java's ``Double.toString`` of the edge values of ``X``."""
    import math
    if x != x:
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    return {1e10: "1.0E10", -1e10: "-1.0E10", 3e9: "3.0E9", -3e9: "-3.0E9",
            1e19: "1.0E19", -1e19: "-1.0E19", 9.2e18: "9.2E18",
            2147483647.9: "2.1474836479E9",
            -2147483648.9: "-2.1474836489E9"}.get(x, repr(x))


@pytest.mark.parametrize("sql,what", [
    ("select cast(d as int) from t", "CAST of a date"),
    ("select cast(i as date) from t", "CAST of a bigint to date"),
    ("select cast(x as decimal(20, 2)) from t", "CAST to DECIMAL"),
    ("select cast(x as timestamp) from t", "CAST to TIMESTAMP"),
    ("select cast(i as tinyint) from t", "CAST to TINYINT"),
    ("select cast(i as smallint) from t", "CAST to SMALLINT"),
    ("select cast(b as date) from t", "CAST of a boolean"),
])
def test_cast_outside_the_port_raises(sql, what):
    with pytest.raises(SqlError, match=what):
        _port().sql(sql)


def test_cast_decimal():
    """CAST to and from DECIMAL through SQL text against the JAX package,
    on the rows whose values fit every target (the reference wraps a
    value past its precision where the port answers NULL, and NaN has no
    DECIMAL): a double rounds HALF_UP to the scale, an integer scales
    exactly, a DECIMAL goes back to a double, a bigint (truncated) and
    a narrower scale (HALF_UP)."""
    sql = ("select id, cast(x as decimal(12, 2)) dx, cast(n as decimal(12,"
           " 2)) dn, cast(i as decimal(18, 0)) di, cast(cast(x as decimal("
           "12, 3)) as double) back, cast(cast(x as decimal(12, 3)) as "
           "bigint) tr, cast(cast(x as decimal(12, 3)) as decimal(10, 1)) "
           "dr from t where x = x and abs(x) < 1e9 and i between "
           "-2000000000000 and 2000000000000")
    got = canon_rows(_port().sql(sql).collect())
    _compare_rows(_jax_rows(sql, "jax"), got, rel=DEFAULT_FLOAT_REL)
    assert len(got) > 5 and any(r[1] is not None for r in got)


def test_cast_through_the_dataframe_api_types_late():
    """``Col.cast`` types when the plan's schema is read: a cast of a
    string to double is a double there, and a cast the port lacks (a
    DATE to a number) raises ``NotImplementedError`` there, before any
    device work."""
    df = _port().sql("select * from t")
    out = df.select(F.col("n").cast(T.FLOAT64).alias("c"))
    assert out.schema["c"].dtype == T.FLOAT64
    text = df.select(F.col("s").cast("double").alias("v"))
    assert text.schema["v"].dtype == T.FLOAT64
    assert sorted(r[0] for r in text.collect()) == \
        [float(k) for k in range(len(X))]
    bad = df.select(F.col("d").cast("int"))
    with pytest.raises(NotImplementedError, match="CAST of a date"):
        bad.schema
