"""DECIMAL64 through the PyTorch port on the CPU, against the JAX package,
pyarrow and Spark's answers worked out by hand.

The port holds ``decimal(p, s)`` (p <= 18) as the unscaled int64.  The
reference's own DECIMAL cases (its ``tests/test_decimal.py``: roundtrip,
mixed scales, multiply, grouped sum, compare and sort, p > 18 refused,
the conf off, mismatched scales, an int past 2^53, rescale casts) run
through both engines on the same seeded inputs and must give the same
``Decimal``s.  Then the port's own paths: a DECIMAL group key and DECIMAL
min / max on B2's table core against the sort path; a DECIMAL join key
probed by direct address and by the search; a RANGE frame over a DECIMAL
order key; a Parquet DECIMAL scan with a pushed filter; TPC-H Q1 and Q6
and the eight TPC-DS texts of ``chip_smoke`` phase 16 at a small scale
against pyarrow over the same Parquet (exact), the float tables' answers
(1e-9) and the JAX engine; literals at the bounds of q48's BETWEENs.

Where the reference's answer is not Spark's, the port is held to Spark's
by hand (ROADMAP C, reference faults 20 and 21): the reference checks no
DECIMAL overflow (an int64 product or sum wraps, and its collect raises
``ArrowInvalid`` on a value past 18 digits or answers the wrapped
number), where the port's value that does not fit its type is NULL; and
its ``avg`` and ``/`` of a DECIMAL read the unscaled ints (100x at scale
2).
"""
import collections
import os
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads
import pyarrow.parquet as papq
import pytest
import torch

import chip_smoke
from spark_rapids_tpu_torch.api import TpuSession, functions as F
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.kernels import join as join_k
from spark_rapids_tpu_torch.plan import overrides

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, _row_key
from tests.jax_reference import with_tpu_session

torch.set_num_threads(1)
chip_smoke._benchmarks_on_path()

import tpcds  # noqa: E402

#: scale and seed of the TPC-DS and TPC-H tables below
DS_SCALE, H_SCALE, SEED = 0.05, 0.01, 11


def _dec_table():
    """The reference's table (``tests/test_decimal.py``)."""
    return pa.table({
        "a": pa.array([Decimal("1.50"), Decimal("-2.25"), None,
                       Decimal("1000.01")], pa.decimal128(10, 2)),
        "b": pa.array([Decimal("0.5"), Decimal("1.5"), Decimal("2.0"),
                       None], pa.decimal128(8, 1)),
        "k": [1, 1, 2, 2],
    })


def _port(conf=None):
    return TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 2,
                               **(conf or {})}), device="cpu")


def _both(fn, ordered=False):
    """(port rows, JAX engine rows) of ``fn(session, F)``."""
    from spark_rapids_tpu.api import functions as JF
    got = fn(_port(), F).collect()
    ref = with_tpu_session(lambda s: fn(s, JF).collect())
    if not ordered:
        got, ref = sorted(got, key=_row_key), sorted(ref, key=_row_key)
    return got, ref


def _same(got, ref):
    """Equal rows: DECIMALs, integers and NULLs exactly, floats 1e-9."""
    _compare_rows(ref, got, rel=DEFAULT_FLOAT_REL)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert type(a) is type(b) or a is None or b is None, (a, b)


# -- the reference's cases -----------------------------------------------


def test_roundtrip():
    s = _port()
    rows = s.create_dataframe(_dec_table()).collect()
    assert rows[0][0] == Decimal("1.50") and rows[2][0] is None
    assert rows[0][1] == Decimal("0.5")
    out = s.create_dataframe(_dec_table()).to_arrow()
    assert out.equals(_dec_table())


def test_roundtrip_through_the_buffers_is_exact():
    """Seeded unscaled values up to 18 digits, negative, NULL and from a
    sliced array move to the device and back bit for bit."""
    rng = np.random.default_rng(3)
    u = rng.integers(-10 ** 18 + 1, 10 ** 18, 3000)
    u[:4] = [10 ** 18 - 1, -10 ** 18 + 1, 0, -1]
    arr = pa.array([None if i % 7 == 3 else Decimal(int(v)).scaleb(-4)
                    for i, v in enumerate(u)], pa.decimal128(18, 4))
    t = pa.table({"d": arr}).slice(5, 2900)
    b = from_arrow(t, "cpu")
    assert b.schema["d"].dtype == T.DecimalType(18, 4)
    assert to_arrow(b).equals(pa.table({"d": arr.slice(5, 2900)}))


def test_add_mixed_scale():
    got, ref = _both(lambda s, F: s.create_dataframe(_dec_table()).select(
        (F.col("a") + F.col("b")).alias("s"),
        (F.col("a") - F.col("b")).alias("d")))
    _same(got, ref)
    assert Decimal("2.00") in [r[0] for r in got]


def test_multiply():
    got, ref = _both(lambda s, F: s.create_dataframe(_dec_table()).select(
        (F.col("a") * F.col("b")).alias("m")))
    _same(got, ref)
    assert sorted(r[0] for r in got if r[0] is not None) == \
        [Decimal("-3.375"), Decimal("0.750")]


def test_sum_group():
    def fn(s, F):
        return s.create_dataframe(_dec_table()).group_by("k").agg(
            F.sum("a").alias("sa"), F.min("b").alias("mb"),
            F.max("a").alias("xa"), F.count("a").alias("n"))
    got, ref = _both(fn)
    _same(got, ref)
    df = fn(_port(), F)
    assert df.schema["sa"].dtype == T.DecimalType(18, 2)
    assert got[0][1] == Decimal("-0.75")


def test_compare_and_sort():
    got, ref = _both(lambda s, F: s.create_dataframe(_dec_table())
                     .filter(F.col("a") > 0).sort("a"), ordered=True)
    _same(got, ref)
    assert [r[0] for r in got] == [Decimal("1.50"), Decimal("1000.01")]


def test_precision_over_18_rejected(tmp_path):
    with pytest.raises(ValueError):
        T.DecimalType(20, 2)
    with pytest.raises(ValueError):
        T.from_arrow(pa.decimal128(20, 2))
    wide = pa.table({"w": pa.array([Decimal("1.00")], pa.decimal128(20, 2)),
                     "k": [1]})
    with pytest.raises(ValueError, match="18"):
        _port().create_dataframe(wide).collect()
    path = str(tmp_path / "wide.parquet")
    papq.write_table(wide, path)
    df = _port().read.parquet(path)
    assert df.select("k").collect() == [(1,)]
    with pytest.raises(NotImplementedError, match="decimal128"):
        df.select("w").collect()


def test_decimal_disabled_refuses():
    """The reference falls back to its CPU engine; the port has none and
    refuses the plan, naming the key."""
    s = _port({"spark.rapids.tpu.sql.decimalType.enabled": False})
    df = s.create_dataframe(_dec_table()).select(
        (F.col("a") + F.col("b")).alias("s"))
    with pytest.raises(NotImplementedError,
                       match="spark.rapids.tpu.sql.decimalType.enabled"):
        df.collect()
    assert s.create_dataframe(_dec_table()).select("k").collect()


def test_mismatched_scale_exact():
    def fn(s, F):
        t = pa.table({
            "a": pa.array([Decimal("11111111111111.11"), Decimal("2.50")],
                          type=pa.decimal128(16, 2)),
            "b": pa.array([Decimal("11111111111111.112"),
                           Decimal("2.500")], type=pa.decimal128(17, 3))})
        return s.create_dataframe(t).select(
            (F.col("a") == F.col("b")).alias("eq"),
            (F.col("a") < F.col("b")).alias("lt"))
    got, ref = _both(fn, ordered=True)
    _same(got, ref)
    assert got == [(False, True), (True, False)]


def test_compare_past_18_digits_is_exact():
    """Rescaling a side past 18 digits decides by its sign (the reference
    compares as doubles there): 10^17 at scale 0 against 0.5 at scale 2,
    both ways."""
    t = pa.table({
        "a": pa.array([Decimal(10 ** 17), Decimal(-10 ** 17), Decimal(3)],
                      pa.decimal128(18, 0)),
        "b": pa.array([Decimal("0.50"), Decimal("0.50"), Decimal("3.00")],
                      pa.decimal128(3, 2))})
    df = _port().create_dataframe(t).select(
        (F.col("a") > F.col("b")).alias("gt"),
        (F.col("a") == F.col("b")).alias("eq"),
        (F.col("b") < F.col("a")).alias("lt"))
    assert df.collect() == [(True, False, True), (False, False, False),
                            (False, True, False)]


def test_int_vs_decimal_above_2_53():
    v = 9007199254740993          # 2^53 + 1: no float64 holds it

    def fn(s, F):
        t = pa.table({"d": pa.array([Decimal(v), Decimal(v + 2)],
                                    type=pa.decimal128(18, 0))})
        return s.create_dataframe(t).filter(F.col("d") == F.lit(v))
    got, ref = _both(fn)
    assert got == ref == [(Decimal(v),)]


def test_rescale_cast():
    def fn(s, F):
        t = pa.table({"d": pa.array(
            [Decimal("12.345"), Decimal("-7.005"), Decimal("-7.051"), None],
            type=pa.decimal128(10, 3))})
        if s.__class__.__module__.startswith("spark_rapids_tpu_torch"):
            up, down = "decimal(12,5)", "decimal(10,1)"
        else:
            from spark_rapids_tpu.columnar import dtypes as JT
            up, down = JT.DecimalType(12, 5), JT.DecimalType(10, 1)
        return s.create_dataframe(t).select(
            F.col("d").cast(up).alias("up"),
            F.col("d").cast(down).alias("down"),
            F.col("d").cast("bigint").alias("i"))
    got, ref = _both(fn, ordered=True)
    _same(got, ref)
    # HALF_UP on the magnitude, truncation toward zero
    assert got[1] == (Decimal("-7.00500"), Decimal("-7.0"), -7)
    assert got[2][1:] == (Decimal("-7.1"), -7)


# -- the table core, the probes, windows, the scan -------------------------


def _keyed(seed=5, n=3000):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-30, 30, n)
    vals = rng.integers(-10 ** 9, 10 ** 9, n)
    return pa.table({
        "k": pa.array([None if i % 11 == 4 else Decimal(int(x)).scaleb(-2)
                       for i, x in enumerate(keys)], pa.decimal128(9, 2)),
        "v": pa.array([None if i % 13 == 5 else Decimal(int(x)).scaleb(-3)
                       for i, x in enumerate(vals)], pa.decimal128(12, 3)),
        "x": rng.random(n)})


def _aggs(plan):
    return [n for n in chip_smoke._walk(plan)
            if type(n).__name__ == "TpuHashAggregate"]


def test_table_core_decimal_key_against_sort_path():
    """A DECIMAL group key with DECIMAL min and max takes B2's table core
    (the reference's ``iminmax``); a table too small for the keys runs
    the sort path; both equal the JAX engine's rows."""
    t = _keyed()

    def fn(s, F):
        return s.create_dataframe(t, num_partitions=2).group_by("k").agg(
            F.min("v").alias("lo"), F.max("v").alias("hi"),
            F.count("v").alias("n"), F.sum("v").alias("s"))
    outs = {}
    for name, size in (("table", 4096), ("sort", 16)):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.agg.tableSize": size,
                                "spark.rapids.tpu.sql.batchSizeRows": 1024}),
                       device="cpu")
        outs[name] = sorted(fn(s, F).collect(), key=_row_key)
        counts = [a.path_counts for a in _aggs(s.last_physical_plan)]
        if name == "table":
            # the sum is the sort path's: only the partial's keys and
            # min / max take the core when the sum is left out
            s2 = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                     1024}), device="cpu")
            s2.create_dataframe(t, num_partitions=2).group_by("k").agg(
                F.min("v").alias("lo"), F.max("v").alias("hi")).collect()
            assert all(a.path_counts["table"] > 0 and
                       a.path_counts["sort"] == 0
                       for a in _aggs(s2.last_physical_plan))
        else:
            assert all(c["table"] == 0 for c in counts)
    assert outs["table"] == outs["sort"]
    from spark_rapids_tpu.api import functions as JF
    ref = sorted(with_tpu_session(lambda s: fn(s, JF).collect()),
                 key=_row_key)
    _same(outs["table"], ref)
    assert len(ref) == 61


def test_min_max_only_takes_the_table_core():
    t = _keyed(9)

    def fn(s, F):
        return s.create_dataframe(t, num_partitions=2).group_by("k").agg(
            F.min("v").alias("lo"), F.max("v").alias("hi"),
            F.first("v").alias("f"))
    s = _port({"spark.rapids.tpu.sql.batchSizeRows": 1024})
    got = sorted(fn(s, F).collect(), key=_row_key)
    assert all(a.path_counts["table"] > 0 and a.path_counts["sort"] == 0
               for a in _aggs(s.last_physical_plan))
    want = collections.defaultdict(list)
    for k, v in zip(t["k"].to_pylist(), t["v"].to_pylist()):
        want[k].append(v)
    for k, lo, hi, _ in got:
        vals = [v for v in want[k] if v is not None]
        assert (lo, hi) == (min(vals), max(vals))


def _join_node(plan):
    from spark_rapids_tpu_torch.exec.tpu_join import TpuHashJoinBase
    return [n for n in chip_smoke._walk(plan)
            if isinstance(n, TpuHashJoinBase)][0]


@pytest.mark.parametrize("how,keys", [("inner", 1), ("left", 1),
                                      ("semi", 1), ("anti", 1),
                                      ("inner", 2)])
def test_decimal_join_key(monkeypatch, how, keys):
    """One DECIMAL key probes by direct address (``direct_tables``, the
    reference's ``tpu_join.py:268``), two keys by the search; both equal
    the JAX engine's rows."""
    monkeypatch.setattr(join_k, "DIRECT_MIN_STREAM", 1024)
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 1 << 20)
    rng = np.random.default_rng(21)
    left = pa.table({"k": _keyed(1)["k"], "i": rng.integers(0, 3, 3000),
                     "x": rng.random(3000)})
    right = pa.table({"rk": _keyed(2, 400)["k"],
                      "ri": rng.integers(0, 3, 400),
                      "y": rng.random(400)})

    def query(s):
        a = s.create_dataframe(left, num_partitions=2)
        b = s.create_dataframe(right)
        cond = a["k"] == b["rk"]
        if keys == 2:
            cond = cond & (a["i"] == b["ri"])
        return a.join(b, cond, how)
    s = TpuSession(TpuConf(), device="cpu")
    got = sorted(query(s).collect(), key=_row_key)
    join = _join_node(s.last_physical_plan)
    want = "direct" if keys == 1 else "search"
    assert join.probes[want] > 0 and sum(join.probes.values()) == \
        join.probes[want]
    conf = {"spark.rapids.tpu.sql.adaptive.enabled": False}
    ref = sorted(with_tpu_session(lambda s: query(s).collect(), conf),
                 key=_row_key)
    assert len(got) > 100
    _same(got, ref)


def test_direct_tables_take_a_decimal_key():
    from spark_rapids_tpu_torch.columnar.column import Column
    data = torch.tensor([150, -225, 100001, 0], dtype=torch.int64)
    col = Column(T.DecimalType(9, 2), data, torch.tensor(
        [True, True, True, False]))
    dt = join_k.direct_tables(col, 4)
    assert (dt.smin, dt.smax, dt.nnull, dt.nvalid) == (-225, 100001, 1, 3)


def test_range_frame_over_a_decimal_order_key():
    """RANGE offsets scale by 10^s over a DECIMAL order key (the
    reference's ``tpu_window.py:376``): the sums, counts and minima equal
    the JAX engine's, the averages a sum by hand."""
    rng = np.random.default_rng(17)
    n = 400
    t = pa.table({"p": rng.integers(0, 4, n),
                  "o": pa.array([Decimal(int(x)).scaleb(-2) for x in
                                 rng.integers(0, 1000, n)],
                                pa.decimal128(6, 2)),
                  "v": pa.array([None if i % 9 == 2 else
                                 Decimal(int(x)).scaleb(-2) for i, x in
                                 enumerate(rng.integers(-5000, 5000, n))],
                                pa.decimal128(7, 2))})
    frame = "range between 1 preceding and 2 following"
    sql = (f"select p, o, v, sum(v) over (partition by p order by o "
           f"{frame}) s, count(v) over (partition by p order by o {frame}) "
           f"c, min(v) over (partition by p order by o {frame}) m, avg(v) "
           f"over (partition by p order by o {frame}) a from t")

    def run(s, with_avg):
        s.create_dataframe(t, num_partitions=2).create_or_replace_temp_view(
            "t")
        return [r if with_avg else r[:6] for r in s.sql(sql if with_avg
                else sql.replace(f", avg(v) over (partition by p order by o "
                                 f"{frame}) a", "")).collect()]
    got = sorted(run(_port(), True), key=_row_key)
    ref = sorted(with_tpu_session(lambda s: run(s, False)), key=_row_key)
    _same([r[:6] for r in got], ref)
    rows = t.to_pylist()
    for p, o, v, s_, c, m, a in got:
        frame_vals = [r["v"] for r in rows if r["p"] == p and
                      o - 1 <= r["o"] <= o + 2 and r["v"] is not None]
        assert s_ == (sum(frame_vals) if frame_vals else None)
        assert c == len(frame_vals)
        if frame_vals:
            assert abs(a - float(sum(frame_vals)) / len(frame_vals)) <= \
                1e-9 * max(1.0, abs(a))


def test_parquet_decimal_scan_with_pushed_filter(tmp_path):
    """A Parquet DECIMAL column reads as its unscaled int64; a comparison
    with a number pushes down as ``Decimal`` bounds of the column's type
    (a float's widened by one unit of the last digit) and prunes row
    groups by their statistics; the rows equal pyarrow's exact filter."""
    u = np.arange(-5000, 5000, dtype=np.int64) * 3
    t = pa.table({"p": chip_smoke.decimal128_array(u, 9, 2),
                  "k": np.arange(len(u))})
    path = str(tmp_path / "t.parquet")
    papq.write_table(t, path, row_group_size=1000)
    s = _port({"spark.rapids.tpu.sql.batchSizeRows": 1 << 16})
    s.read.parquet(path).create_or_replace_temp_view("t")
    df = s.sql("select k, p from t where p >= 12.36 and p < 20 and p <> 15")
    plan = df.explain()
    assert "Decimal('12.35')" in plan and "Decimal('20.00')" in plan
    got = df.collect()
    p = t["p"]
    want = t.filter(pc.and_(pc.and_(
        pc.greater_equal(p, pa.scalar(Decimal("12.36"), p.type)),
        pc.less(p, pa.scalar(Decimal("20.00"), p.type))),
        pc.not_equal(p, pa.scalar(Decimal("15.00"), p.type))))
    assert sorted(got) == sorted(zip(want["k"].to_pylist(),
                                     want["p"].to_pylist()))
    assert got and all(isinstance(r[1], Decimal) for r in got)
    from spark_rapids_tpu_torch.io.planner import to_arrow_filters
    from spark_rapids_tpu_torch.expr import core as ec
    from spark_rapids_tpu_torch.expr import predicates as ep
    ref = ec.AttributeReference("p", T.DecimalType(9, 2))
    filters = to_arrow_filters(ep.GreaterThanOrEqual(ref, ec.Literal(12)))
    frag = next(iter(pads.dataset(path).get_fragments()))
    kept = frag.split_by_row_group(papq.filters_to_expression(filters))
    assert filters == [("p", ">=", pa.scalar(Decimal("12.00"), p.type))]
    assert len(kept) == 5            # of 10 row groups


def test_literal_bounds_of_q48_are_exact():
    """q48's literals are doubles here, as in the reference (Spark reads
    them as DECIMALs): a 2-digit DECIMAL's unscaled int over 100 is the
    double nearest its value, so every cent around each bound of q48's
    BETWEENs compares as the exact DECIMAL does."""
    bounds = [(100.00, 150.00), (50.00, 100.00), (150.00, 200.00),
              (0, 2000), (150, 3000), (50, 25000)]
    cents = sorted({c for lo, hi in bounds for b in (lo, hi)
                    for c in range(int(b * 100) - 150, int(b * 100) + 151)})
    t = pa.table({"p": chip_smoke.decimal128_array(
        np.array(cents, np.int64), 7, 2)})
    s = _port({"spark.rapids.tpu.sql.batchSizeRows": 1 << 16})
    s.create_dataframe(t).create_or_replace_temp_view("t")
    for lo, hi in bounds:
        got = sorted(r[0] for r in s.sql(
            f"select p from t where p between {lo!r} and {hi!r}").collect())
        want = [Decimal(c).scaleb(-2) for c in cents
                if Decimal(str(lo)) <= Decimal(c).scaleb(-2) <= Decimal(
                    str(hi))]
        assert got == want, (lo, hi)


def test_case_and_coalesce_take_a_common_scale():
    """CASE and coalesce of DECIMALs of two scales give their wider type
    (Spark's ``widerDecimalType``; the reference's ``common_type``
    raises for two DECIMAL types), a literal arm at its scale."""
    s = _port()
    s.create_dataframe(_dec_table()).create_or_replace_temp_view("t")
    df = s.sql("select case when k = 1 then a else b end c, "
               "coalesce(b, a, 0) z, if(k = 2, 1.25, a) f from t")
    assert df.schema["c"].dtype == T.DecimalType(10, 2)
    assert df.schema["z"].dtype == T.DecimalType(10, 2)
    assert df.schema["f"].dtype == T.FLOAT64
    assert df.collect() == [
        (Decimal("1.50"), Decimal("0.50"), 1.5),
        (Decimal("-2.25"), Decimal("1.50"), -2.25),
        (Decimal("2.00"), Decimal("2.00"), 1.25),
        (None, Decimal("1000.01"), 1.25)]


def test_sum_avg_of_window_and_moments_read_values():
    """``avg``, the moments and ``/`` of a DECIMAL take its values, not
    its unscaled ints (reference fault 21: its avg is 100x at scale 2)."""
    s = _port()
    s.create_dataframe(_dec_table()).create_or_replace_temp_view("t")
    got = s.sql("select k, avg(a) m, stddev_pop(a) sd, sum(a) / count(a) "
                "q from t group by k order by k").collect()
    assert got[0][1] == pytest.approx(-0.375, rel=1e-12)
    assert got[0][2] == pytest.approx(1.875, rel=1e-12)
    assert got[0][3] == pytest.approx(-0.375, rel=1e-12)
    assert got[1][1:] == (pytest.approx(1000.01, rel=1e-12), 0.0,
                          pytest.approx(1000.01, rel=1e-12))
    div = s.sql("select a / b d from t").collect()
    assert div[0][0] == pytest.approx(3.0, rel=1e-12)


def test_reference_avg_and_divide_read_unscaled_ints():
    """Reference fault 21: the JAX engine's ``avg`` and ``/`` of a
    DECIMAL compute on the unscaled int64s (``aggregates.py:210``,
    ``arithmetic.py:180``): avg(1.50, -2.25) is -37.5 there, Spark's
    -0.375; 1.50 / 0.5 is 30.0 there, Spark's 3.0."""
    from spark_rapids_tpu.api import functions as JF

    def fn(s):
        df = s.create_dataframe(_dec_table())
        return (df.group_by("k").agg(JF.avg("a").alias("m")).collect(),
                df.select((JF.col("a") / JF.col("b")).alias("d")).collect())
    avg, div = with_tpu_session(fn)
    assert sorted(avg)[0][1] == pytest.approx(-37.5)
    assert div[0][0] == pytest.approx(30.0)
    port = _port().create_dataframe(_dec_table())
    assert sorted(port.group_by("k").agg(F.avg("a").alias("m"))
                  .collect())[0][1] == pytest.approx(-0.375)
    assert port.select((F.col("a") / F.col("b")).alias("d")) \
        .collect()[0][0] == pytest.approx(3.0)


# -- C6, C7 and round: Spark's answers by hand -------------------------------

_TIES = [0.285, -0.285, 1.005, -1.005, 0.125, -0.125, 2.675, 999.995,
         99.995, -999.994, 0.005, 1e-7]


def _ties_table():
    return pa.table({"x": pa.array(_TIES, pa.float64()),
                     "k": np.arange(len(_TIES))})


def test_double_to_decimal_rounds_the_shortest_digits():
    """C6: a double cast to DECIMAL rounds HALF_UP the digits of Java's
    ``Double.toString`` (Spark's ``Decimal(double)``), not ``x * 100``:
    0.285 is 0.29 and 1.005 is 1.01 at decimal(5,2) (worked out by hand
    from the texts "0.285" and "1.005"), ±0.125 is ±0.13, 2.675 is 2.68,
    999.995 does not fit and is NULL, 99.995 is 100.00."""
    df = _port().create_dataframe(_ties_table())
    got = [r[1] for r in df.select(F.col("k"), F.col("x").cast(
        "decimal(5,2)").alias("d")).sort("k").collect()]
    want = ["0.29", "-0.29", "1.01", "-1.01", "0.13", "-0.13", "2.68", None,
            "100.00", "-999.99", "0.01", "0.00"]
    assert got == [None if w is None else Decimal(w) for w in want]


def test_reference_double_to_decimal_rounds_the_binary_product():
    """The reference's double -> DECIMAL (``expr/cast.py:141-143``) rounds
    ``x * 10^scale`` half to even: 0.285 and 1.005 give 0.28 and 1.00
    (their products lie below the half), ±0.125 gives ±0.12."""
    def run(session):
        df = session.create_dataframe(_ties_table())
        df.create_or_replace_temp_view("t")
        return session.sql("select k, cast(x as decimal(5,2)) from t "
                           "where k < 6 order by k").collect()
    got = [r[1] for r in with_tpu_session(run)]
    assert got == [Decimal(w) for w in ("0.28", "-0.28", "1.00", "-1.00",
                                        "0.12", "-0.12")]


def test_decimal_to_int_wraps():
    """C7: a DECIMAL cast to int is Spark's ``toLong.toInt``: the
    truncated long keeps its low 32 bits, so 3000000000.7 at
    decimal(12,1) is -1294967296 (3000000000 - 2^32) and -3000000000.7
    is 1294967296; a bigint keeps the truncated value; a double cast to
    int still saturates."""
    t = pa.table({"d": pa.array([Decimal("3000000000.7"),
                                 Decimal("-3000000000.7"), Decimal("12.9")],
                                pa.decimal128(12, 1))})
    rows = _port().create_dataframe(t).select(
        F.col("d").cast("int"), F.col("d").cast("bigint"),
        F.col("d").cast("double").cast("int")).collect()
    assert rows == [(-1294967296, 3000000000, 2147483647),
                    (1294967296, -3000000000, -2147483648), (12, 12, 12)]


def test_reference_decimal_to_int_saturates():
    """The reference clips a DECIMAL cast to int at the type's bounds
    (``expr/cast.py:145-153``, ``jnp.clip``): 2147483647 for
    3000000000.7, where Spark wraps."""
    from spark_rapids_tpu.api import functions as JF
    t = pa.table({"d": pa.array([Decimal("3000000000.7")],
                                pa.decimal128(12, 1))})
    got = with_tpu_session(lambda s: s.create_dataframe(t).select(
        JF.col("d").cast("int")).collect())
    assert got == [(2147483647,)]


def test_round_of_a_decimal():
    """``round`` of a DECIMAL rounds HALF_UP at the requested scale
    (Spark's answers by hand): round(9.99, 1) is 10.0 and round(-1.25, 1)
    is -1.3, in the column's scale."""
    t = pa.table({"d": pa.array([Decimal("9.99"), Decimal("-1.25"),
                                 Decimal("0.04")], pa.decimal128(5, 2))})
    rows = _port().create_dataframe(t).select(F.round("d", 1)).collect()
    assert [r[0] for r in rows] == [Decimal("10.00"), Decimal("-1.30"),
                                    Decimal("0.00")]


def test_reference_round_of_a_decimal_returns_its_input():
    """Reference fault 22: the JAX engine's ``round`` of a DECIMAL
    (``expr/arithmetic.py:378-401``) rounds the unscaled int as a double
    at the requested scale and returns 9.99 and -1.25 unchanged."""
    from spark_rapids_tpu.api import functions as JF
    t = pa.table({"d": pa.array([Decimal("9.99"), Decimal("-1.25")],
                                pa.decimal128(5, 2))})
    got = with_tpu_session(lambda s: s.create_dataframe(t).select(
        JF.round("d", 1)).collect())
    assert [r[0] for r in got] == [Decimal("9.99"), Decimal("-1.25")]


# -- overflow: reference fault 20 -----------------------------------------

_BIG = 922337203685477581           # x 20 is 2^64 + 4


def _overflow_table():
    return pa.table({
        "d": pa.array([Decimal(10 ** 18 - 1), Decimal(10 ** 18 - 1),
                       Decimal(_BIG), Decimal(7)], pa.decimal128(18, 0)),
        "c": pa.array([Decimal("12345.67"), Decimal("123.45"),
                       Decimal("-999.99"), Decimal("-1000.00")],
                      pa.decimal128(7, 2)),
        "k": [1, 1, 2, 3]})


def test_overflow_is_null():
    """A value that does not fit its type is NULL, Spark's answer without
    ANSI mode, worked out by hand: CAST(12345.67 AS decimal(5,2)) and
    CAST(-1000.00 AS decimal(5,2)) are NULL, 123.45 and -999.99 fit.  At
    the 18-digit cap the port's type is narrower than Spark's (Spark
    types ``sum`` of decimal(18,0) as decimal(28,0) and ``d * 20`` as
    decimal(29,0)): the port answers NULL where the value needs more
    than 18 digits, never a wrapped number."""
    s = _port()
    s.create_dataframe(_overflow_table()).create_or_replace_temp_view("t")
    cast = s.sql("select cast(c as decimal(5,2)) x from t").collect()
    assert cast == [(None,), (Decimal("123.45"),), (Decimal("-999.99"),),
                    (None,)]
    sums = s.sql("select k, sum(d) s, sum(c) sc from t group by k "
                 "order by k").collect()
    assert sums == [(1, None, Decimal("12469.12")),
                    (2, Decimal(_BIG), Decimal("-999.99")),
                    (3, Decimal(7), Decimal("-1000.00"))]
    prod = s.sql("select d * 20 p, d + d a, d - 1 m from t").collect()
    assert prod == [(None, None, Decimal(10 ** 18 - 2)),
                    (None, None, Decimal(10 ** 18 - 2)),
                    (None, None, Decimal(_BIG - 1)),
                    (Decimal(140), Decimal(14), Decimal(6))]
    # a window sum past 18 digits too
    w = s.sql("select k, sum(d) over (partition by k) w from t "
              "order by k").collect()
    assert [r[1] for r in w] == [None, None, Decimal(_BIG), Decimal(7)]


def test_exact_sums_past_the_int64_range_of_their_partials():
    """The sums of 32-bit halves keep a group exact where its running
    int64 would wrap: ten values of 9 x 10^17 and ten of -9 x 10^17, in
    batches of 4 over 3 partitions, sum to 0."""
    vals = [9 * 10 ** 17] * 10 + [-9 * 10 ** 17] * 10
    t = pa.table({"d": pa.array([Decimal(v) for v in vals],
                                pa.decimal128(18, 0)), "k": [1] * 20})
    s = _port({"spark.rapids.tpu.sql.batchSizeRows": 4})
    got = s.create_dataframe(t, num_partitions=3).group_by("k").agg(
        F.sum("d").alias("s")).collect()
    assert got == [(1, Decimal(0))]


def test_reference_decimal_overflow_wraps_or_raises():
    """Reference fault 20: the JAX engine checks no DECIMAL overflow.
    ``d * 20`` of 922337203685477581 wraps to 4 (2^64 + 4), a silently
    wrong number; a sum past 18 digits, and a CAST that does not fit,
    raise ``ArrowInvalid`` when collected.  The port answers NULL
    (``test_overflow_is_null``)."""
    from spark_rapids_tpu.api import functions as JF

    def wrapped(s):
        return s.create_dataframe(_overflow_table()).filter(
            JF.col("k") == 2).select((JF.col("d") * 20).alias("p")).collect()
    assert with_tpu_session(wrapped) == [(Decimal(4),)]

    def summed(s):
        return s.create_dataframe(_overflow_table()).group_by("k").agg(
            JF.sum("d").alias("s")).collect()
    with pytest.raises(pa.ArrowInvalid):
        with_tpu_session(summed)


# -- TPC-H Q1 / Q6, the TPC-DS texts and D1-D3 of phase 16 ---------------


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Phase 6 and 7's float tables at DS_SCALE, phase 16's DECIMAL copies
    and lineitem at H_SCALE beside them, and phase 16's references."""
    d = str(tmp_path_factory.mktemp("decimal16"))
    chip_smoke.make_tpcds(d, DS_SCALE, SEED)
    chip_smoke.make_tpcds7(d, DS_SCALE, SEED)
    chip_smoke.write_decimal_tables(d, H_SCALE, SEED)
    # the JAX engine's q42 and q52 repeat groups over part files (ROADMAP
    # C: a complete aggregate over many partitions): it reads one file
    dec = chip_smoke.decimal_dir(d)
    papq.write_table(papq.read_table(os.path.join(dec, "store_sales.parquet")),
                     os.path.join(d, "store_sales_one.parquet"))
    return d, chip_smoke.ds16_references(d)


def _dec_session(d, views=True):
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 1 << 14}),
                   device="cpu")
    dec = chip_smoke.decimal_dir(d)
    for t in list(tpcds.TABLES) + ["lineitem"]:
        path = os.path.join(dec, f"{t}.parquet")
        if os.path.exists(path):
            s.read.parquet(path).create_or_replace_temp_view(t)
    return s


@pytest.mark.parametrize("q", sorted(chip_smoke.TPCH16_TEXTS))
def test_tpch_on_decimals(tables, q):
    """Q1 and Q6 over decimal(15,2) money: every DECIMAL sum equals
    pyarrow's ``decimal256`` sum exactly, the averages 1e-9, and the sums
    and counts the JAX engine's (its averages read unscaled ints)."""
    d, refs = tables
    text = chip_smoke.TPCH16_TEXTS[q]
    table = _dec_session(d).sql(text).to_arrow()
    chip_smoke.check_decimal_query(q, table, refs)
    assert table.num_rows == (4 if q == "Q1" else 1)
    if q == "Q1":
        assert str(table.schema.field("sum_charge").type) == \
            "decimal128(18, 6)"

    def jax(s):
        s.read.parquet(os.path.join(chip_smoke.decimal_dir(d),
                                    "lineitem.parquet")) \
            .create_or_replace_temp_view("lineitem")
        return s.sql(text).collect()
    ref = with_tpu_session(jax)
    got = [tuple(r.values()) for r in table.to_pylist()]
    keep = [i for i, f in enumerate(table.schema)
            if not str(f.type).startswith("double")]
    assert [tuple(r[i] for i in keep) for r in got] == \
        [tuple(r[i] for i in keep) for r in ref]


#: the phase-16 texts the JAX engine answers as Spark does (q7 and q13
#: average DECIMALs, fault 21; q13 and q48 factor IN lists, fault 4)
JAX_TEXTS = ("q3", "q42", "q52", "q55", "q98")


@pytest.mark.parametrize("q", chip_smoke.DS16_QUERIES)
def test_tpcds_on_decimals(tables, q):
    """The eight TPC-DS texts over decimal(7,2) store_sales and item equal
    pyarrow over the same Parquet exactly, their float tables' answers
    within 1e-9, give the same bytes twice, and (JAX_TEXTS) equal the JAX
    engine's rows."""
    d, refs = tables
    s = _dec_session(d)
    table = s.sql(tpcds.QUERIES[q]).to_arrow()
    chip_smoke.check_decimal_query(q, table, refs)
    assert chip_smoke.same_bytes(table, s.sql(tpcds.QUERIES[q]).to_arrow())
    assert table.num_rows > 0
    if q not in JAX_TEXTS:
        return

    def jax(js):
        for t in tpcds.TABLES:
            path = os.path.join(chip_smoke.decimal_dir(d), f"{t}.parquet")
            if t == "store_sales":
                path = os.path.join(d, "store_sales_one.parquet")
            if os.path.exists(path):
                js.read.parquet(path).create_or_replace_temp_view(t)
        return js.sql(tpcds.QUERIES[q]).collect()
    ref = sorted(with_tpu_session(jax), key=_row_key)
    got = sorted((tuple(r.values()) for r in table.to_pylist()),
                 key=_row_key)
    _same(got, ref)


@pytest.mark.parametrize("q", sorted(chip_smoke.DS16_OWN))
def test_own_decimal_paths(monkeypatch, tables, q):
    """D1 groups by a DECIMAL key on B2's table core behind an exchange on
    it; D2 probes one DECIMAL key by direct address; D3 a DECIMAL and an
    integer key by the search; each equals pyarrow exactly."""
    monkeypatch.setattr(join_k, "DIRECT_MIN_STREAM", 1024)
    d, refs = tables
    s = _dec_session(d)
    table = s.sql(chip_smoke.DS16_OWN[q]).to_arrow()
    chip_smoke.check_decimal_query(q, table, refs)
    plan = s.last_physical_plan
    if q == "D1":
        aggs = [a for a in _aggs(plan) if a.group_exprs]
        assert aggs and all(a.path_counts["table"] > 0 for a in aggs)
        assert all(a.group_exprs[0].dtype() == T.DecimalType(7, 0)
                   for a in aggs)
        assert "TpuShuffleExchange" in s.sql(chip_smoke.DS16_OWN[q]).explain()
    else:
        join = _join_node(plan)
        assert join.probes["direct" if q == "D2" else "search"] > 0


def test_q1_margin_rule():
    """``fit_decimals`` makes NULL a reference value past its column's
    precision, as the port answers it."""
    schema = pa.schema([("a", pa.decimal128(18, 6)), ("b", pa.int64())])
    rows, nulled = chip_smoke.fit_decimals(
        schema, [(Decimal("999999999999.999999"), 1),
                 (Decimal("1000000000000.000000"), 2)])
    assert rows == [(Decimal("999999999999.999999"), 1), (None, 2)]
    assert nulled == [(1, 0, Decimal("1000000000000.000000"))]
