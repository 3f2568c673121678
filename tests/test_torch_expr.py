"""The port's expressions and aggregates of the flat TPC-DS slice against
the JAX package, on the CPU.

Every case builds the same expression in both packages (their modules
share names) over the same seeded table with nulls, runs it through each
package's DataFrame API (the port with ``device="cpu"``) and compares
the rows with ``tests/harness._compare_rows``: ``DEFAULT_FLOAT_REL`` in
exact mode, ``FAST_FLOAT_REL`` in variable float mode.  Aggregates run
grouped by an integer key (avg takes the port's table core there) and by
a string key (the sort path), over groups of one row and groups whose
inputs are all null.
"""
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.config import TpuConf

from tests.harness import (DEFAULT_FLOAT_REL, FAST_FLOAT_REL, _compare_rows,
                           canon_rows)
from tests.jax_reference import with_cpu_session, with_tpu_session

# the port's CPU runs here are many small torch ops: one intra-op thread
# per test process, so parallel test workers do not oversubscribe the
# cores with spinning thread pools
torch.set_num_threads(1)

WORDS = ["Music", "Books", "", "Home", ">10000", "5001-10000",
         "a somewhat longer value", "Électronique"]
VARIABLE = "spark.rapids.tpu.sql.variableFloatAgg.enabled"


def _table(n: int = 700, seed: int = 5) -> pa.Table:
    rng = np.random.default_rng(seed)
    s = rng.choice(np.array(WORDS, dtype=object), n)
    s[rng.random(n) < 0.06] = None
    t = rng.choice(np.array(WORDS, dtype=object), n)
    t[rng.random(n) < 0.06] = None
    a = rng.integers(-40, 40, n).astype(object)
    a[rng.random(n) < 0.06] = None
    x = (rng.random(n) * 300 - 100).round(2).astype(object)
    x[rng.random(n) < 0.06] = None
    k = rng.integers(0, 12, n)
    # key 90: one row; key 91: every input null
    k[0], k[1:4] = 90, 91
    a[1:4] = x[1:4] = None
    g = np.array([f"g{i}" for i in k], dtype=object)
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "g": pa.array(list(g), pa.string()),
        "a": pa.array(list(a), pa.int64()),
        "d": pa.array(rng.integers(-3, 4, n).astype(np.int32)),
        "x": pa.array(list(x), pa.float64()),
        "s": pa.array(list(s), pa.string()),
        "t": pa.array(list(t), pa.string()),
    })


def _modules(pkg: str):
    import importlib
    names = {"F": "api.functions", "ea": "expr.arithmetic",
             "ep": "expr.predicates", "econd": "expr.conditional",
             "es": "expr.string_ops", "ec": "expr.core"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


def _c(m, name):
    return m.F.col(name)


EXPRESSIONS = {
    "subtract": lambda m: _c(m, "a") - _c(m, "d"),
    "subtract_double": lambda m: _c(m, "x") - _c(m, "a"),
    "divide_ints": lambda m: _c(m, "a") / _c(m, "d"),
    "divide_int_double": lambda m: _c(m, "d") / _c(m, "x"),
    "divide_by_zero": lambda m: _c(m, "x") / m.F.lit(0),
    "unary_minus": lambda m: -_c(m, "a"),
    "unary_minus_double": lambda m: -_c(m, "x"),
    "in_ints": lambda m: _c(m, "a").isin(1, 2, -7, 30),
    "in_int32": lambda m: _c(m, "d").isin(0, 3),
    "in_strings": lambda m: _c(m, "s").isin("Music", "", "Home"),
    "is_null": lambda m: m.ep.IsNull(_c(m, "s").expr),
    "is_not_null": lambda m: m.ep.IsNotNull(_c(m, "x").expr),
    "between": lambda m: (_c(m, "x") >= 10.5) & (_c(m, "x") <= 120),
    "if": lambda m: m.econd.If((_c(m, "a") > 0).expr, _c(m, "x").expr,
                               _c(m, "d").expr),
    "case_when": lambda m: m.F.when(_c(m, "d") < 0, _c(m, "a"))
    .when(_c(m, "d") == 0, m.F.lit(100)).otherwise(m.F.lit(-1)),
    "case_null_else": lambda m: m.econd.CaseWhen(
        [((_c(m, "s") == "Music").expr, _c(m, "x").expr)],
        m.ec.Literal(None)),
    "case_no_else": lambda m: m.F.when(_c(m, "a") > 10, _c(m, "d")),
    "coalesce": lambda m: m.F.coalesce(_c(m, "x"), _c(m, "a"), m.F.lit(0)),
    "substring_1": lambda m: m.F.substring(_c(m, "s"), 1, 5),
    "substring_0": lambda m: m.F.substring(_c(m, "s"), 0, 3),
    "substring_negative": lambda m: m.F.substring(_c(m, "s"), -4, 2),
    "substring_past_end": lambda m: m.F.substring(_c(m, "s"), 7, 30),
    "starts_with": lambda m: _c(m, "s").startswith("Mu"),
    "ends_with": lambda m: _c(m, "s").endswith("000"),
    "contains": lambda m: _c(m, "s").contains("om"),
    "like_prefix": lambda m: _c(m, "s").like(">1000%"),
    "like_suffix": lambda m: _c(m, "s").like("%ks"),
    "like_contains": lambda m: _c(m, "s").like("%o%"),
    "like_equal": lambda m: _c(m, "s").like("Home"),
    "concat_with_nulls": lambda m: m.F.concat(_c(m, "s"), m.F.lit(", "),
                                              _c(m, "t")),
    "abs_int": lambda m: m.F.abs(_c(m, "a")),
    "abs_int32": lambda m: m.F.abs(_c(m, "d")),
    "abs_double": lambda m: m.F.abs(_c(m, "x")),
    "abs_of_difference": lambda m: m.F.abs(_c(m, "x") - _c(m, "a")) /
    _c(m, "x"),
}


def _port_rows(build, table, conf=None):
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 256,
                            **(conf or {})}), device="cpu")
    df = s.create_dataframe(table, num_partitions=3)
    return build(_modules("spark_rapids_tpu_torch"), df).collect(), s


def _jax_rows(build, table, conf=None, oracle=False):
    """The JAX package's rows: its engine, or its pyarrow oracle."""
    def fn(s):
        df = s.create_dataframe(table, num_partitions=3)
        return build(_modules("spark_rapids_tpu"), df).collect()
    return (with_cpu_session if oracle else with_tpu_session)(fn, conf)


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_expression_matches_jax(name):
    """Each expression against the JAX engine; substring against its
    oracle, whose positions count characters as Spark's do (the engine
    counts bytes and cuts the 2-byte É of "Électronique": ROADMAP C)."""
    def build(m, df):
        e = EXPRESSIONS[name](m)
        return df.select(_c(m, "k"), _c(m, "s"), _c(m, "x"),
                         e.alias("v") if hasattr(e, "alias")
                         else m.F.Col(e).alias("v"))
    table = _table()
    got, _ = _port_rows(build, table)
    want = _jax_rows(build, table, oracle=name.startswith("substring"))
    _compare_rows(canon_rows(want), canon_rows(got), rel=DEFAULT_FLOAT_REL)


AGGREGATES = ["avg", "stddev_samp", "stddev_pop", "variance", "var_pop"]


@pytest.mark.parametrize("mode", ["exact", "variable"])
@pytest.mark.parametrize("key", ["k", "g"], ids=["table", "sort"])
@pytest.mark.parametrize("agg", AGGREGATES)
def test_aggregate_matches_jax(agg, key, mode):
    conf = {VARIABLE: mode == "variable"}

    def build(m, df):
        fn = getattr(m.F, "stddev" if agg == "stddev_samp" else agg)
        return df.group_by(key).agg(fn("x").alias("fx"), fn("a").alias("fa"),
                                    fn("d").alias("fd"))
    table = _table()
    got, s = _port_rows(build, table, conf)
    want = _jax_rows(build, table, conf)
    rel = FAST_FLOAT_REL if mode == "variable" else DEFAULT_FLOAT_REL
    _compare_rows(canon_rows(want), canon_rows(got), rel=rel)
    rows = {r[0]: r[1:] for r in got}
    one, nulls = (90, 91) if key == "k" else ("g90", "g91")
    assert rows[nulls] == (None, None, rows[nulls][2])
    if agg in ("stddev_samp", "variance"):
        assert rows[one][:2] == (None, None)     # one row: no sample moment
    # over integer inputs, the moments and string keys the partial
    # aggregate runs the sort path, as in the reference (avg over doubles
    # alone: the next test)
    assert all(n.path_counts["table"] == 0
               for n in _aggregates(s.last_physical_plan)
               if n.mode == "partial")


def _aggregates(node):
    out = [node] if type(node).__name__ == "TpuHashAggregate" else []
    for c in node.children:
        out.extend(_aggregates(c))
    return out


def test_avg_alone_takes_the_table_core():
    """avg over a fractional column with an integer key reduces every
    batch in the table core (partial and final), as the reference's
    ``favg64`` descriptor does."""
    from spark_rapids_tpu_torch.api import functions as F
    for variable in (False, True):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 256,
                                VARIABLE: variable}), device="cpu")
        df = s.create_dataframe(_table(), num_partitions=3)
        got = df.group_by("k").agg(F.avg("x").alias("ax"),
                                   F.count("x").alias("n")).collect()
        want = with_tpu_session(lambda js: js.create_dataframe(
            _table(), num_partitions=3).group_by("k").agg(
            _modules("spark_rapids_tpu").F.avg("x").alias("ax"),
            _modules("spark_rapids_tpu").F.count("x").alias("n")).collect(),
            {VARIABLE: variable})
        _compare_rows(canon_rows(want), canon_rows(got),
                      rel=FAST_FLOAT_REL if variable else DEFAULT_FLOAT_REL)
        for node in _aggregates(s.last_physical_plan):
            assert node.path_counts["sort"] == 0
            assert node.path_counts["table"] > 0


def test_group_by_without_aggregates_plans_partial_exchange_final():
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 256}),
                   device="cpu")
    s.create_dataframe(_table(), num_partitions=3) \
        .create_or_replace_temp_view("t")
    df = s.sql("select g, s from t group by g, s")
    lines = [ln.strip() for ln in df.explain().splitlines()]
    assert lines[1:5] == ["TpuHashAggregate[final]",
                          "TpuAQEShuffleRead[pending]",
                          "TpuShuffleExchange[HashPartitioner(3)]",
                          "TpuHashAggregate[partial]"]
    got = df.collect()
    t = _table()
    want = {(g, x) for g, x in zip(t["g"].to_pylist(), t["s"].to_pylist())}
    assert sorted(got, key=str) == sorted(want, key=str)


@pytest.mark.parametrize("n", [0, 1, 25, 5000])
def test_top_n_equals_sort_and_limit(n):
    """``sort(...).limit(n)`` plans one TpuTopN (no range exchange) and
    equals the global sort's first n rows, ties and nulls included."""
    from spark_rapids_tpu_torch.api import functions as F
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 128}),
                   device="cpu")
    df = s.create_dataframe(_table(), num_partitions=3)
    top = df.sort(F.col("s").desc(), "d", F.col("x").asc()).limit(n)
    plan = top.explain().splitlines()
    assert plan[0] == f"TpuTopN[{n}]" and len(plan) == 2
    full = df.sort(F.col("s").desc(), "d", F.col("x").asc()).to_arrow()
    got = top.to_arrow()
    assert got.num_rows == min(n, full.num_rows)
    assert got.to_pylist() == full.slice(0, n).to_pylist()
    # the JAX package's sort + limit on the same table: the sort keys in
    # order, and each run of equal keys as a multiset (at the cut, a
    # subset of the table's rows with that key)
    JF = _modules("spark_rapids_tpu").F
    want = with_tpu_session(lambda js: js.create_dataframe(
        _table(), num_partitions=3).sort(
        JF.col("s").desc(), "d", JF.col("x").asc()).limit(n).collect(),
        {"spark.rapids.tpu.sql.batchSizeRows": 128})
    rows = [tuple(r.values()) for r in got.to_pylist()]
    names = got.column_names
    key = lambda r: tuple(r[names.index(c)] for c in ("s", "d", "x"))
    _compare_rows([key(r) for r in want], [key(r) for r in rows])
    everything = [tuple(r.values()) for r in full.to_pylist()]
    for k in dict.fromkeys(key(r) for r in rows):
        mine = canon_rows(r for r in rows if key(r) == k)
        theirs = canon_rows(r for r in want if key(r) == k)
        if k == key(rows[-1]):
            pool = canon_rows(r for r in everything if key(r) == k)
            assert all(r in pool for r in mine + theirs), k
        else:
            _compare_rows(theirs, mine)


def _string_max(m, df, grouped: bool):
    aggs = [m.F.max(_c(m, "s")).alias("ms"), m.F.count("*").alias("n")]
    keys = [_c(m, "k")] if grouped else []
    return df.group_by(*keys).agg(*aggs)


def test_string_max_grouped_matches_jax():
    """max of a STRING column per group: the largest string in byte order
    (so "a somewhat longer value" beats "Music" and "É" beats both), one
    row per group, null for a group of null inputs."""
    table = _table()
    got, _ = _port_rows(lambda m, df: _string_max(m, df, True), table)
    want = _jax_rows(lambda m, df: _string_max(m, df, True), table)
    _compare_rows(canon_rows(want), canon_rows(got), rel=DEFAULT_FLOAT_REL)
    assert any(r[1] == "Électronique" for r in got)


@pytest.mark.parametrize("rows", ["all", "none"])
def test_string_max_keyless_matches_oracle(rows):
    """max of a STRING column without keys, over every row and over none
    (null): against the JAX oracle, since the JAX engine raises on it
    (``test_reference_keyless_string_max_raises``)."""
    table = _table() if rows == "all" else _table().slice(0, 0)

    def build(m, df):
        return _string_max(m, df, False)
    got, _ = _port_rows(build, table)
    want = _jax_rows(build, table, oracle=True)
    _compare_rows(want, got, rel=DEFAULT_FLOAT_REL)
    assert got[0][0] == ("Électronique" if rows == "all" else None)


def test_reference_keyless_string_max_raises():
    """The JAX package's fault (ROADMAP C): its engine's keyless max of a
    string raises ``NotImplementedError`` (no key encoding for strings in
    its global-aggregate path), where the port gives the largest
    string."""
    with pytest.raises(NotImplementedError, match="string"):
        _jax_rows(lambda m, df: _string_max(m, df, False), _table())


@pytest.mark.parametrize("agg", ["sum", "avg", "mean", "stddev",
                                 "var_pop"])
def test_numeric_aggregate_of_a_string_raises(agg):
    """sum, avg and the moments of a string no longer raise: they are
    Spark's implicit cast of the string to double, NULL for a word that is
    no number (the JAX engine adds the strings' bytes, ROADMAP C), so
    they equal the same aggregate of ``cast(s as double)``, keyless and
    grouped."""
    s = TpuSession(device="cpu")
    s.create_dataframe(_table()).create_or_replace_temp_view("t")
    for sql, cast in ((f"select {agg}(s) from t",
                       f"select {agg}(cast(s as double)) from t"),
                      (f"select k, {agg}(s) from t group by k",
                       f"select k, {agg}(cast(s as double)) from t group "
                       f"by k")):
        assert sorted(s.sql(sql).collect(), key=str) == \
            sorted(s.sql(cast).collect(), key=str)


def _date_table(n: int = 200, seed: int = 9) -> pa.Table:
    """Two DATE columns with NULLs (q51's ``web.d_date`` and
    ``store.d_date`` after a full outer join) and an int key."""
    import datetime
    rng = np.random.default_rng(seed)
    day0 = datetime.date(2000, 1, 1)

    def dates():
        return [None if rng.random() < 0.3 else
                day0 + datetime.timedelta(days=int(x))
                for x in rng.integers(0, 400, n)]
    return pa.table({"k": pa.array(rng.integers(0, 5, n)),
                     "a": pa.array(dates(), pa.date32()),
                     "b": pa.array(dates(), pa.date32())})


@pytest.mark.parametrize("sql", [
    "select k, case when a is not null then a else b end d from t",
    "select k, case when k > 2 then a when k = 1 then b end d from t",
    "select k, case k when 0 then b else a end d from t",
    "select k, coalesce(a, b) d from t",
    "select k, d from (select k, case when a is not null then a else b "
    "end d from t) x where d is not null order by d, k",
])
def test_date_case_matches_jax(sql):
    """CASE and coalesce whose values are DATEs (q51's select list), in
    SQL text, against the JAX engine and its oracle."""
    table = _date_table()

    def run(s):
        s.create_dataframe(table, num_partitions=2) \
            .create_or_replace_temp_view("t")
        return s.sql(sql).collect()
    got = run(TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                  64}), device="cpu"))
    assert any(r[1] is not None for r in got)
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(engine(run)), canon_rows(got))


def test_abs_in_sql_and_its_refusals():
    """``abs`` of numbers in SQL text keeps the type; of a string or a
    DATE it raises ``SqlError``."""
    from spark_rapids_tpu_torch.api.sql import SqlError
    s = TpuSession(device="cpu")
    s.create_dataframe(_table()).create_or_replace_temp_view("t")
    got = s.sql("select abs(a) aa, abs(d) ad, abs(x) ax from t").to_arrow()
    assert [f.type for f in got.schema] == [pa.int64(), pa.int32(),
                                           pa.float64()]
    want = with_tpu_session(lambda js: (js.create_dataframe(_table())
                                        .create_or_replace_temp_view("t"),
                                        js.sql("select abs(a) aa, abs(d) "
                                               "ad, abs(x) ax from t")
                                        .collect())[1])
    _compare_rows(canon_rows(want), canon_rows(
        [tuple(r.values()) for r in got.to_pylist()]))
    for bad in ("select abs(s) from t", "select abs(a, d) from t"):
        with pytest.raises(SqlError):
            s.sql(bad)
