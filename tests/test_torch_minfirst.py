"""Grouped ``min``, ``first`` and ``last`` of the port against the JAX
package, on the CPU: on B2's table core (an integer key) and on the sort
path (a string key), over several batches, NULLs, NaNs and
``ignore_nulls`` both ways; B2's new kinds' plain version against a
Python loop; and the SQL that q41 and q70 need.

``first`` / ``last`` depend on row order, which Spark fixes only within
a partition's batches in order: they are held to the JAX engine over
one partition, and over three partitions only on columns the key
determines.  Floats match within 1e-9 relative (``DEFAULT_FLOAT_REL``);
integers, strings, DATEs and NULLs are equal.
"""
import datetime
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.config import TpuConf

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_tpu_session

torch.set_num_threads(1)

BATCH = "spark.rapids.tpu.sql.batchSizeRows"
WORDS = np.array(["Music", "", "Home", "a longer word", "Électronique",
                  "Books"], dtype=object)


def _table(n: int = 96, seed: int = 31) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(v, share=0.15):
        v = v.astype(object)
        v[rng.random(n) < share] = None
        return v
    k = rng.integers(0, 6, n)
    k[:3], k[3:6] = 90, 91          # 90: only NaN x; 91: every input null
    x = nulls((rng.random(n) * 200 - 100).round(2))
    x[rng.random(n) < 0.05] = float("nan")
    x[:3] = float("nan")
    i = nulls(rng.integers(-50, 50, n))
    dt = nulls(np.array([datetime.date(2000, 1, 1) + datetime.timedelta(
        days=int(d)) for d in rng.integers(0, 900, n)], dtype=object))
    s = nulls(rng.choice(WORDS, n))
    for col in (x, i, dt, s):
        col[3:6] = None
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "g": pa.array([f"g{v}" for v in k], pa.string()),
        "kk": pa.array(k * 10 + 1, pa.int32()),     # determined by the key
        "x": pa.array(list(x), pa.float64()),
        "i": pa.array(list(i), pa.int32()),
        "dt": pa.array(list(dt), pa.date32()),
        "s": pa.array(list(s), pa.string()),
    })


def _modules(pkg: str):
    import importlib
    return types.SimpleNamespace(
        F=importlib.import_module(f"{pkg}.api.functions"))


#: (first or last, column, ignore_nulls) of every type, both ways
FIRST_LAST = [("first", "x", True), ("last", "x", False),
              ("first", "dt", False), ("last", "dt", True),
              ("first", "i", False), ("last", "i", True),
              ("first", "kk", False), ("last", "kk", True)]


def _aggs(m, key: str):
    """min of every type (a string's only on the sort path: a STRING min
    leaves the table core, as in the reference), max, count, and first /
    last of every type both ways (FIRST_LAST; of a string too on the sort
    path)."""
    F = m.F
    mins = ("x", "i", "dt", "s") if key == "g" else ("x", "i", "dt")
    out = [F.min(c).alias(f"min_{c}") for c in mins] + \
        [F.max("x").alias("max_x"), F.count("*").alias("n")]
    pairs = FIRST_LAST + ([("first", "s", True), ("last", "s", False)]
                          if key == "g" else [])
    for fn, c, skip in pairs:
        out.append(getattr(F, fn)(c, skip).alias(
            f"{fn}_{c}_{'skip' if skip else 'keep'}"))
    return out


def _order_free(names):
    """Positions of the columns that do not depend on row order: the
    key, min, max, count, and first / last of the key-determined kk."""
    return [i for i, n in enumerate(names)
            if not n.startswith(("first", "last")) or "_kk_" in n]


def _aggregates(node):
    out = [node] if type(node).__name__ == "TpuHashAggregate" else []
    for c in node.children:
        out.extend(_aggregates(c))
    return out


SQL_TEXT = ("select k, min(x), min(i), min(dt), first(kk), last_value(kk), "
            "first_value(kk), last(kk), max(i) from t group by k")


def _port(table, key, parts):
    s = TpuSession(TpuConf({BATCH: 32}), device="cpu")
    df = s.create_dataframe(table, num_partitions=parts)
    out = df.group_by(key).agg(*_aggs(_modules("spark_rapids_tpu_torch"),
                                      key))
    return out.collect(), out.columns, s


@pytest.mark.parametrize("key", ["k", "g"], ids=["table", "sort"])
def test_grouped_min_first_last_match_jax(key):
    """One partition, the port's in batches of 32 rows, against the JAX
    engine over the same rows in one batch (one order either way): an
    integer key (every batch on the table core, partial and final) and a
    string key (the sort path), through the DataFrame API and, with the
    integer key, SQL.  Over three partitions the order-free columns equal
    the same rows."""
    table = _table()

    def jax(js):
        df = js.create_dataframe(table)
        df.create_or_replace_temp_view("t")
        return df.group_by(key).agg(*_aggs(
            _modules("spark_rapids_tpu"), key)).collect(), \
            js.sql(SQL_TEXT).collect() if key == "k" else None
    want, want_sql = with_tpu_session(jax)
    got, names, s = _port(table, key, 1)
    _compare_rows(canon_rows(want), canon_rows(got), rel=DEFAULT_FLOAT_REL)
    for node in _aggregates(s.last_physical_plan):
        table_batches, sort_batches = node.path_counts["table"], \
            node.path_counts["sort"]
        assert (table_batches > 0 and sort_batches == 0) if key == "k" \
            else table_batches == 0, node.path_counts
    rows = {r[0]: r for r in got}
    one, nulls = (90, 91) if key == "k" else ("g90", "g91")
    assert rows[one][1] != rows[one][1]         # min of NaNs alone: NaN
    assert rows[nulls][1:4] == (None, None, None)
    many, _, _ = _port(table, key, 3)
    free = _order_free(names)
    _compare_rows(canon_rows([tuple(r[i] for i in free) for r in want]),
                  canon_rows([tuple(r[i] for i in free) for r in many]),
                  rel=DEFAULT_FLOAT_REL)
    if want_sql is not None:
        s = TpuSession(TpuConf({BATCH: 32}), device="cpu")
        s.create_dataframe(table, num_partitions=3) \
            .create_or_replace_temp_view("t")
        _compare_rows(canon_rows(want_sql), canon_rows(
            s.sql(SQL_TEXT).collect()), rel=DEFAULT_FLOAT_REL)


def test_min_ignores_nan_unless_all_nan():
    """Spark's order puts NaN above every number: the min skips it, the
    max takes it; a group of NaNs has min NaN."""
    from spark_rapids_tpu_torch.api import functions as F
    t = pa.table({"k": [1, 1, 2, 2], "x": [float("nan"), 2.0,
                                           float("nan"), float("nan")]})
    for batch in (1 << 20, 1):
        s = TpuSession(TpuConf({BATCH: batch}), device="cpu")
        got = dict((r[0], r[1:]) for r in s.create_dataframe(t).group_by(
            "k").agg(F.min("x"), F.max("x")).collect())
        assert got[1][0] == 2.0 and got[1][1] != got[1][1]
        assert got[2][0] != got[2][0]


def test_reference_first_keeps_nulls_by_default():
    """Spark's ``first(x)`` and ``last(x)`` count null rows
    (``ignoreNulls = false``): a group whose first row is null answers
    NULL.  The reference's defaults skip nulls and answer 2.0 and 3.0."""
    t = pa.table({"k": [1, 1, 1, 1], "x": [None, 2.0, 3.0, None]})
    s = TpuSession(device="cpu")
    s.create_dataframe(t).create_or_replace_temp_view("n")
    got = s.sql("select k, first(x), last(x), first_value(x), "
                "last_value(x) from n group by k").collect()
    assert got == [(1, None, None, None, None)]

    def jax(js):
        js.create_dataframe(t).create_or_replace_temp_view("n")
        return js.sql("select k, first(x), last(x) from n group by k") \
            .collect()
    assert with_tpu_session(jax) == [(1, 2.0, 3.0)]


@pytest.mark.parametrize("kind", ["fmin64", "fmin", "first", "last",
                                  "first_all", "last_all"])
def test_plain_b2_kind_matches_a_loop(kind):
    """B2's plain version of each new kind against a Python loop over
    the rows: the min of the valid non-NaN values (its NaN-free count
    beside it), or the first / last valid row's position (every row's
    with ``_all``); dead rows (bucket ``table``) drop out."""
    from spark_rapids_tpu_torch.kernels.cuda_ops import (StageCol,
                                                         table_stage_plain)
    rng = np.random.default_rng(5)
    n, table = 300, 8
    bucket = rng.integers(0, table + 1, n).astype(np.int32)
    v = (rng.random(n) * 20 - 10).round(1)
    v[rng.random(n) < 0.1] = np.nan
    v[rng.random(n) < 0.05] = -0.0
    valid = rng.random(n) >= 0.2
    base = kind.split("_")[0]
    col = StageCol(base, None if base in ("first", "last") else
                   torch.from_numpy(v),
                   None if kind.endswith("_all") else torch.from_numpy(valid))
    got = table_stage_plain(torch.from_numpy(bucket), table, [col])[0]
    for b in range(table):
        rows = [r for r in range(n) if bucket[r] == b and
                (kind.endswith("_all") or valid[r])]
        if base in ("first", "last"):
            want = (rows[0] if base == "first" else rows[-1]) if rows else -1
            assert int(got[0][b]) == want
            continue
        nums = [v[r] for r in rows if not np.isnan(v[r])]
        assert int(got[0][b]) == len(rows) and int(got[1][b]) == len(nums)
        if not nums:
            continue
        if kind == "fmin64":
            from spark_rapids_tpu_torch.kernels.aggregate import unflip64
            m = float(unflip64(~got[2][b:b + 1])[0])
        else:
            m = float(got[2][b])
        assert m == float(np.float32(min(nums)) if kind == "fmin"
                          else min(nums))


def test_correlated_or_arms_factor_out_their_equality():
    """q41's shape: a correlated count whose equality with the outer
    query sits inside both arms of an OR is factored out
    (``_factor_or``) and decorrelated; the rows equal a Python answer.
    (q41 itself runs against the JAX engine in test_torch_tpcds.)"""
    from spark_rapids_tpu_torch.api.sql import (BinOp, Ident, Lit,
                                                _factor_or)
    a = BinOp("=", Ident("m"), Ident("m", "o"))
    p1 = BinOp("=", Ident("c"), Lit("x"))
    p2 = BinOp("=", Ident("c"), Lit("y"))
    got = _factor_or(BinOp("or", BinOp("and", a, p1), BinOp("and", a, p2)))
    assert got == BinOp("and", a, BinOp("or", p1, p2))
    assert _factor_or(BinOp("or", a, BinOp("and", a, p1))) == a
    table = _table()
    s = TpuSession(device="cpu")
    s.create_dataframe(table).create_or_replace_temp_view("t")
    got = s.sql("select distinct s from t o where k between 1 and 4 and "
                "(select count(*) from t where (g = o.g and i > 10) or "
                "(g = o.g and x < -50)) > 0 order by s").collect()
    rows = table.to_pylist()
    hit = {r["g"] for r in rows if (r["i"] is not None and r["i"] > 10) or
           (r["x"] is not None and r["x"] < -50)}
    want = sorted({(r["s"],) for r in rows if 1 <= r["k"] <= 4 and
                   r["g"] in hit}, key=lambda v: (v[0] is not None, v[0]))
    assert got and got == want


def test_order_by_alias_inside_an_expression_and_string_case():
    """q70's ORDER BY: a select alias inside a CASE (``case when lh = 0
    then g end``) over a ROLLUP with ``grouping()``, and a string-valued
    CASE in the select list and in a window's PARTITION BY; the rows
    equal a Python answer.  (q70 itself runs against the JAX engine in
    test_torch_tpcds.)"""
    table = _table()
    s = TpuSession(device="cpu")
    s.create_dataframe(table).create_or_replace_temp_view("t")
    got = s.sql("select g, sum(i) si, grouping(g) as lh, "
                "case when grouping(g) = 0 then g else 'all' end c, "
                "rank() over (partition by grouping(g), case when "
                "grouping(g) = 0 then 'one' end order by sum(i) desc) r "
                "from t group by rollup(g) "
                "order by lh desc, case when lh = 0 then g end, r").collect()
    vals = {}
    for r in table.to_pylist():
        vals.setdefault(r["g"], []).extend([r["i"]] if r["i"] is not None
                                           else [])
    sums = {g: sum(v) if v else None for g, v in vals.items()}
    total = sum(v for v in sums.values() if v is not None)
    fine = sorted(sums.items())
    ranked = [v for _, v in fine]

    def rank(v):     # DESC: NULLs last, as Spark orders a descending key
        if v is None:
            return 1 + sum(1 for w in ranked if w is not None)
        return 1 + sum(1 for w in ranked if w is not None and w > v)
    want = [(None, total, 1, "all", 1)] + [
        (g, v, 0, g, rank(v)) for g, v in fine]
    assert got == want
