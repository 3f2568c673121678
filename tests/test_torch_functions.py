"""The port's numeric, conditional, null and hash functions against the
JAX package, on the CPU.

Every function of the slice is built in both packages (their modules
share names) over one seeded table with nulls, zeros and negatives in
int32, int64 and double columns.  To keep the suite cheap each API runs
once per engine: one DataFrame ``select`` of every expression and one SQL
text of every function name, per package, and one test per API compares
every column, naming each that differs.  Floats match within 1e-9 relative
(``DEFAULT_FLOAT_REL``); integers, strings, booleans and NULLs are equal.

Where the reference departs from Spark the port gives Spark's answer,
held by a ``test_reference_*`` case with the answer computed by hand.
"""
import types

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.config import TpuConf

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows
from tests.jax_reference import with_tpu_session

torch.set_num_threads(1)

BATCH = "spark.rapids.tpu.sql.batchSizeRows"


def _table(n: int = 160, seed: int = 23) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(v, share=0.08):
        v = v.astype(object)
        v[rng.random(n) < share] = None
        return list(v)
    i = rng.integers(-20, 21, n)
    i[:6] = [0, 0, -7, 7, -1, 1]
    x = (rng.random(n) * 400 - 200).round(3)
    x[:4] = [0.0, -3.5, 2.5, -0.5]
    nx = rng.random(n) * 10
    nx[rng.random(n) < 0.2] = np.nan
    words = np.array(["Music", "", "Home", "a longer word", "Électronique"],
                     dtype=object)
    return pa.table({
        "k": pa.array(np.arange(n) % 7, pa.int64()),
        "i": pa.array(nulls(i), pa.int32()),
        "ip": pa.array(nulls(np.abs(i)), pa.int32()),
        "l": pa.array(nulls(rng.integers(-100_000, 100_000, n)), pa.int64()),
        "x": pa.array(nulls(x), pa.float64()),
        "p": pa.array(nulls(rng.random(n) * 50 + 0.01), pa.float64()),
        "u": pa.array(nulls(rng.random(n) * 1.8 - 0.9), pa.float64()),
        "nx": pa.array(nulls(nx), pa.float64()),
        "b": pa.array(nulls(rng.random(n) < 0.5), pa.bool_()),
        "dt": pa.array(nulls(rng.integers(10_000, 12_000, n)), pa.int32())
        .cast(pa.date32()),
        "s": pa.array(nulls(rng.choice(words, n)), pa.string()),
        "t": pa.array(nulls(rng.choice(words, n)), pa.string()),
    })


def _modules(pkg: str):
    import importlib
    names = {"F": "api.functions", "ea": "expr.arithmetic",
             "ep": "expr.predicates", "econd": "expr.conditional",
             "ec": "expr.core"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


def _e(m, name):
    return m.F.col(name).expr


def _cls(cls_name, *args):
    """An expression class of both packages over column names or
    literals."""
    def build(m):
        return m.F.Col(getattr(m.ea, cls_name)(*[
            _e(m, a) if isinstance(a, str) else m.ec.Literal(a)
            for a in args]))
    return build


#: name -> the expression in one package's modules (``m``)
DATAFRAME = {
    "sqrt": lambda m: m.F.sqrt("p"),
    "exp": lambda m: m.F.exp(m.F.col("x") / 100),
    "log": lambda m: m.F.log("p"),
    "log2": lambda m: m.F.log2("p"),
    "log10": lambda m: m.F.log10("p"),
    "sin": lambda m: m.F.sin("x"),
    "cos": lambda m: m.F.cos("x"),
    "tan": lambda m: m.F.tan("x"),
    "asin": lambda m: m.F.asin("u"),
    "acos": lambda m: m.F.acos("u"),
    "atan": lambda m: m.F.atan("x"),
    "floor_double": lambda m: m.F.floor("x"),
    "ceil_double": lambda m: m.F.ceil("x"),
    "floor_int": lambda m: m.F.floor("i"),
    "ceil_long": lambda m: m.F.ceil("l"),
    "signum_double": lambda m: m.F.signum("x"),
    "signum_int": lambda m: m.F.signum("i"),
    "degrees": lambda m: m.F.degrees("x"),
    "radians": lambda m: m.F.radians("x"),
    "pow": lambda m: m.F.pow(m.F.col("x"), m.F.lit(2)),
    "pow_ints": lambda m: m.F.pow(m.F.col("i"), m.F.col("ip")),
    "pmod_long_int": lambda m: m.F.pmod(m.F.col("l"), m.F.col("ip")),
    "pmod_int_literal": lambda m: m.F.pmod(m.F.col("i"), m.F.lit(6)),
    "pmod_double": lambda m: m.F.pmod(m.F.col("x"), m.F.lit(3.5)),
    "greatest": lambda m: m.F.greatest("x", "l", "i"),
    "least": lambda m: m.F.least("x", "l", "i"),
    "greatest_ints": lambda m: m.F.greatest("i", "ip"),
    "isnull": lambda m: m.F.isnull(m.F.col("s")),
    "isnan": lambda m: m.F.isnan(m.F.col("nx")),
    "isnan_int": lambda m: m.F.isnan(m.F.col("i")),
    "nanvl": lambda m: m.F.nanvl(m.F.col("nx"), m.F.col("x")),
    "hash_longs": lambda m: m.F.hash("l", "i"),
    "hash_double": lambda m: m.F.hash("x"),
    "hash_bool_date": lambda m: m.F.hash("b", "dt"),
    "eq_null_safe_ints": lambda m: m.F.col("i").eq_null_safe(m.F.col("ip")),
    "eq_null_safe_strings": lambda m: m.F.col("s").eqNullSafe(m.F.col("t")),
    "if_strings": lambda m: m.F.Col(m.econd.If(
        (m.F.col("i") > 0).expr, _e(m, "s"), _e(m, "t"))),
    "case_strings": lambda m: m.F.when(m.F.col("i") < -5, m.F.col("s"))
    .when(m.F.col("i") > 5, m.F.lit("big")).otherwise(m.F.col("t")),
    "case_strings_no_else": lambda m: m.F.when(m.F.col("b"), m.F.col("s")),
    "integral_divide": _cls("IntegralDivide", "l", "i"),
    "unary_positive": _cls("UnaryPositive", "x"),
    "bitwise_and": _cls("BitwiseAnd", "l", "i"),
    "bitwise_or": _cls("BitwiseOr", "l", "i"),
    "bitwise_xor": _cls("BitwiseXor", "i", "ip"),
    "bitwise_not": _cls("BitwiseNot", "l"),
    "shift_left_int": _cls("ShiftLeft", "i", 3),
    "shift_left_long": _cls("ShiftLeft", "l", 40),
    "shift_right": _cls("ShiftRight", "l", 2),
    "shift_right_unsigned_long": _cls("ShiftRightUnsigned", "l", 5),
    "shift_right_unsigned_int": _cls("ShiftRightUnsigned", "i", 3),
    "expm1": _cls("Expm1", "u"),
    "log1p": _cls("Log1p", "p"),
    "sinh": _cls("Sinh", "u"),
    "cosh": _cls("Cosh", "u"),
    "tanh": _cls("Tanh", "x"),
    "asinh": _cls("Asinh", "x"),
    "acosh": _cls("Acosh", "p"),
    "atanh": _cls("Atanh", "u"),
    "cbrt": _cls("Cbrt", "x"),
    "rint": _cls("Rint", "x"),
    "atan2": _cls("Atan2", "x", "l"),
}

#: name -> SQL expression over the same table (``t``)
SQL = {
    "sqrt": "sqrt(p)", "exp": "exp(x / 100)", "ln": "ln(p)", "log": "log(p)",
    "log2": "log2(p)", "log10": "log10(p)", "sin": "sin(x)",
    "cos": "cos(x)", "tan": "tan(x)", "asin": "asin(u)", "acos": "acos(u)",
    "atan": "atan(x)", "atan2": "atan2(x, l)", "degrees": "degrees(x)",
    "radians": "radians(x)", "floor": "floor(x)", "ceil": "ceil(x)",
    "ceiling": "ceiling(i)", "sign": "sign(x)", "signum": "signum(i)",
    "pow": "pow(x, 2)", "power": "power(ip, i)", "mod": "mod(l, i)",
    "pmod": "pmod(l, ip)", "greatest": "greatest(x, l, i)",
    "least": "least(i, ip, 3)", "nullif": "nullif(i, ip)",
    "nullif_string": "nullif(s, t)", "if": "if(i > 0, x, l)",
    "if_string": "if(i > 0, s, 'none')", "isnull": "isnull(x)",
    "isnotnull": "isnotnull(s)", "isnan": "isnan(nx)",
    "nanvl": "nanvl(nx, x)", "hash": "hash(l, i, k)",
    "case_string": "case when i > 5 then s when i < -5 then t end",
}


def _port_session(table, parts: int = 3, batch: int = 64):
    s = TpuSession(TpuConf({BATCH: batch}), device="cpu")
    df = s.create_dataframe(table, num_partitions=parts)
    df.create_or_replace_temp_view("t")
    return s, df


def _select_all(m, df):
    return df.select(m.F.col("k"), *[DATAFRAME[n](m).alias(n)
                                     for n in sorted(DATAFRAME)])


_SQL_TEXT = "select k, " + ", ".join(
    f"{SQL[n]} as {n}" for n in sorted(SQL)) + " from t"


def _differing(names, got, want):
    """The names whose column differs between two row lists in one
    order (one partition: both engines keep the input's order)."""
    assert len(got) == len(want)
    bad = []
    for pos, name in enumerate(names, start=1):
        try:
            _compare_rows([(r[pos],) for r in want],
                          [(r[pos],) for r in got], rel=DEFAULT_FLOAT_REL)
        except AssertionError:
            bad.append(name)
    return bad


def test_dataframe_functions_match_jax():
    table = _table()
    _, df = _port_session(table, parts=1, batch=256)
    got = _select_all(_modules("spark_rapids_tpu_torch"), df).collect()
    want = with_tpu_session(lambda js: _select_all(
        _modules("spark_rapids_tpu"), js.create_dataframe(table)).collect(),
        {BATCH: 256})
    assert _differing(sorted(DATAFRAME), got, want) == []


def test_sql_functions_match_jax():
    table = _table()
    s, _ = _port_session(table, parts=1, batch=256)
    got = s.sql(_SQL_TEXT).collect()

    def jax(js):
        js.create_dataframe(table).create_or_replace_temp_view("t")
        return js.sql(_SQL_TEXT).collect()
    want = with_tpu_session(jax, {BATCH: 256})
    assert _differing(sorted(SQL), got, want) == []


def test_functions_over_partitions_and_batches():
    """The same select over 3 partitions in batches of 64 gives the
    one-batch rows (no function depends on its batch)."""
    table = _table()
    m = _modules("spark_rapids_tpu_torch")
    one = _select_all(m, _port_session(table, 1, 256)[1]).collect()
    many = _select_all(m, _port_session(table, 3, 64)[1]).collect()
    assert _differing(sorted(DATAFRAME), many, one) == []


def test_sql_functions_have_spark_types():
    """The result types of the SQL library: doubles for the math, a
    bigint floor and ceil of a double, an int32 floor of an int32, the
    common type of greatest and pmod, a never-null hash."""
    s, _ = _port_session(_table())
    df = s.sql("select sqrt(i) a, floor(x) b, floor(i) c, pmod(i, l) d, "
               "greatest(i, x) e, hash(s) f, isnan(x) g, nullif(s, t) h, "
               "if(b, 1, 2.5) j from t")
    got = {f.name: (f.dtype.name, f.nullable) for f in df.schema}
    assert got == {"a": ("double", True), "b": ("bigint", True),
                   "c": ("int", True), "d": ("bigint", True),
                   "e": ("double", True), "f": ("bigint", False),
                   "g": ("boolean", False), "h": ("string", True),
                   "j": ("double", True)}


def _one(sql: str):
    s, _ = _port_session(_table(8), parts=1)
    return s.sql(sql).collect()


def test_reference_pmod_negative_divisor():
    """Spark's ``pmod(a, n)`` is ``(r + n) % n`` for a negative ``r = a %
    n``: pmod(-7, -3) = ((-1) + (-3)) % (-3) = -1, pmod(7, -3) = 1,
    pmod(-7, 3) = 2, pmod(-7.5, -2.0) = -1.5.  The reference adds |n| and
    answers 2 for pmod(-7, -3)."""
    row = _one("select pmod(-7, -3), pmod(7, -3), pmod(-7, 3), "
               "pmod(-7.5, -2.0), pmod(7, 0) from t limit 1")[0]
    assert row == (-1, 1, 2, -1.5, None)
    jax = with_tpu_session(lambda js: js.sql(
        "select pmod(-7, -3) a").collect())
    assert jax == [(2,)]


def test_reference_integral_divide_is_exact():
    """Spark's ``div`` and ``%`` on bigints are exact: (2^62 + 1) div 3 =
    1537228672809129301, (2^62 + 1) % 3 = 2.  The reference divides in f64
    and truncates (inexact past 2^53)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.schema import Field, Schema
    from spark_rapids_tpu_torch.expr import arithmetic as ea
    from spark_rapids_tpu_torch.expr.core import BoundReference, Literal
    a = Column(T.INT64, torch.tensor([(1 << 62) + 1, -((1 << 62) + 1)]),
               torch.ones(2, dtype=torch.bool))
    b = ColumnarBatch(Schema([Field("a", T.INT64)]), [a], 2)
    ref = BoundReference(0, T.INT64, True, "a")
    assert ea.IntegralDivide(ref, Literal(3)).columnar_eval(b).data \
        .tolist() == [1537228672809129301, -1537228672809129301]
    assert ea.Remainder(ref, Literal(3)).columnar_eval(b).data.tolist() == \
        [2, -2]
    assert ea.Pmod(ref, Literal(3)).columnar_eval(b).data.tolist() == [2, 1]


def test_reference_log_at_or_below_zero_is_null():
    """Spark's ``ln``, ``log2`` and ``log10`` are null at 0 and below; the
    reference answers -inf and NaN."""
    row = _one("select ln(0), log2(-1), log10(0.0), ln(1), "
               "sqrt(-1) from t limit 1")[0]
    assert row[:4] == (None, None, None, 0.0) and row[4] != row[4]


def test_reference_greatest_least_order_nan_last():
    """Spark orders a NaN above every number: greatest(1.0, NaN) is NaN,
    least(NaN, 1.0) is 1.0; the reference keeps the first argument's
    value for both."""
    t = pa.table({"a": pa.array([1.0, float("nan")]),
                  "b": pa.array([float("nan"), 1.0])})
    s = TpuSession(device="cpu")
    s.create_dataframe(t).create_or_replace_temp_view("n")
    rows = s.sql("select greatest(a, b), least(a, b) from n").collect()
    assert all(g != g and lo == 1.0 for g, lo in rows)


def test_floor_ceil_of_nan_and_infinity_saturate():
    """Spark's cast of a double to a bigint: NaN gives 0, infinities the
    bounds."""
    t = pa.table({"a": pa.array([float("nan"), float("inf"),
                                 float("-inf"), -2.5])})
    s = TpuSession(device="cpu")
    got = s.create_dataframe(t).select(
        _modules("spark_rapids_tpu_torch").F.floor("a").alias("f"),
        _modules("spark_rapids_tpu_torch").F.ceil("a").alias("c")).collect()
    big = (1 << 63) - 1
    assert got == [(0, 0), (big, big), (-big - 1, -big - 1), (-3, -2)]


def test_string_hash_is_the_same_in_two_batch_widths():
    """One string's ``hash`` is the same whatever the longest string of
    its batch (the port's width-free fold; the reference's string words
    change with the batch, ROADMAP C)."""
    from spark_rapids_tpu_torch.api import functions as F
    s = TpuSession(device="cpu")
    short = s.create_dataframe(pa.table({"s": ["abc", "x"]}))
    wide = s.create_dataframe(pa.table({"s": ["abc", "y" * 70]}))
    h1 = short.select(F.hash("s").alias("h")).collect()[0]
    h2 = wide.select(F.hash("s").alias("h")).collect()[0]
    assert h1 == h2
    assert short.select(F.hash(F.lit(None)).alias("h")).collect()[0] != \
        short.select(F.hash(F.lit(0)).alias("h")).collect()[0]


def test_ids_match_jax_on_one_batch():
    """One partition of one batch: both packages number the rows 0..n-1
    in partition 0."""
    table = _table(40)
    F = _modules("spark_rapids_tpu_torch").F
    s = TpuSession(device="cpu")
    got = s.create_dataframe(table).select(
        F.col("l"), F.monotonically_increasing_id().alias("id"),
        F.spark_partition_id().alias("p")).collect()

    def jax(js):
        JF = _modules("spark_rapids_tpu").F
        return js.create_dataframe(table).select(
            JF.col("l"), JF.monotonically_increasing_id().alias("id"),
            JF.spark_partition_id().alias("p")).collect()
    assert got == with_tpu_session(jax)
    assert [r[1] for r in got] == list(range(40))


def test_reference_ids_across_partitions_and_batches():
    """Spark's ids: ``partition << 33 | row in the partition``, and the
    partition's index.  Over 3 partitions of 10 rows in batches of 4 the
    ids are p * 2^33 + 0..9; the reference numbers every batch from 0 in
    partition 0."""
    F = _modules("spark_rapids_tpu_torch").F
    s = TpuSession(TpuConf({BATCH: 4}), device="cpu")
    df = s.create_dataframe(pa.table({"v": list(range(30))}),
                            num_partitions=3)
    got = df.select("v", F.monotonically_increasing_id().alias("id"),
                    F.spark_partition_id().alias("p")).collect()
    assert got == [(v, ((v // 10) << 33) | (v % 10), v // 10)
                   for v in range(30)]
    # the filter and the aggregate above read the ids of the projection;
    # a filter on another column stays above it (the ids are the
    # unfiltered rows')
    n = df.select(F.monotonically_increasing_id().alias("id")) \
        .filter(F.col("id") >= (1 << 33)).group_by().agg(
            F.count("*").alias("n")).collect()
    assert n == [(20,)]
    kept = df.select("v", F.monotonically_increasing_id().alias("id")) \
        .filter(F.col("v") % 10 == 9).collect()
    assert kept == [(v, ((v // 10) << 33) | 9) for v in (9, 19, 29)]


def test_null_safe_equality_never_null():
    F = _modules("spark_rapids_tpu_torch").F
    s = TpuSession(device="cpu")
    t = pa.table({"a": pa.array([1, None, None, 2], pa.int64()),
                  "b": pa.array([1, None, 3, None], pa.int64())})
    got = s.create_dataframe(t).select(
        F.col("a").eq_null_safe(F.col("b")).alias("e")).collect()
    assert got == [(True,), (True,), (False,), (False,)]
