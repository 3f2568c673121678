"""Window functions through the PyTorch port, against the JAX package, on
the CPU.

One seeded table (``_table``: NULLs in the int64 partition key ``g``,
the string ``s``, the DATE ``d`` and the int64 order key ``o``, ties in
``o`` and in the double order key ``f``, int64 and double values with
NULLs, a unique ``id``) goes through the port with ``batchSizeRows`` 16
over 3 partitions, so every window partition arrives in several
batches, and through the JAX package's engine and its pyarrow/pandas
oracle (``CpuWindow``).  Rows agree as multisets, floats within
``DEFAULT_FLOAT_REL`` (1e-9) relative; integers, strings, dates and
NULLs equal.  Each case runs through the port's SQL text and through
``DataFrame.with_window`` (the frame always written out: the SQL and
DataFrame defaults differ), against the JAX package's SQL.

The cases mirror ``tests/test_window.py`` (``TestWindow``,
``TestFrames``, ``TestWindowCompleteness``; ``collect_list`` is not
ported) and add string, DATE and double keys, DESC NULLS LAST, double
sums over every frame kind and ``lead`` of a string.  The plan shapes
(a hash exchange on the PARTITION BY keys, or a coalesce), the
refusals, the segment-restarting running sum and the window kernels
(``kernels/window.py``) against plain Python are held here too, and
``test_reference_lead_lag_drop_default`` shows the reference's NULLs
where Spark answers the default, which the port refuses.
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
from spark_rapids_tpu_torch.kernels import window as wk
from spark_rapids_tpu_torch.plan import logical as L

from tests.harness import (DEFAULT_FLOAT_REL, _compare_rows, canon_rows,
                           with_cpu_session, with_tpu_session)

torch.set_num_threads(1)

DAY0 = datetime.date(2000, 1, 1)


def _table(n: int = 120, seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(a, share=0.1):
        a = a.astype(object)
        a[rng.random(n) < share] = None
        return list(a)
    d = [None if rng.random() < 0.1 else
         DAY0 + datetime.timedelta(days=int(x))
         for x in rng.integers(0, 30, n)]
    return pa.table({
        "id": pa.array(rng.permutation(n).astype(np.int64)),
        "g": pa.array(nulls(rng.integers(0, 4, n)), pa.int64()),
        "s": pa.array(nulls(rng.choice(np.array(["ab", "b", "", "cde"],
                                                dtype=object), n)),
                      pa.string()),
        "d": pa.array(d, pa.date32()),
        "o": pa.array(nulls(rng.integers(0, 25, n)), pa.int64()),
        "f": pa.array(rng.integers(0, 30, n) * 0.25, pa.float64()),
        "v": pa.array(nulls(rng.integers(-50, 50, n)), pa.int64()),
        "x": pa.array(nulls(rng.random(n) * 100 - 20), pa.float64()),
    })


TABLE = _table()


def _port_session(parts=3, rows=16):
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
        s.create_dataframe(TABLE, num_partitions=3) \
            .create_or_replace_temp_view("t")
        return s.sql(sql).collect()
    return canon_rows(engine(run))


def _bound(b, lo: bool) -> str:
    if b is None:
        return "unbounded preceding" if lo else "unbounded following"
    if b == 0:
        return "current row"
    return f"{-b} preceding" if b < 0 else f"{b} following"


#: (SQL function, DataFrame function, PARTITION BY, ORDER BY as (column,
#: ascending, nulls first or None), frame or None where it does not
#: matter); the column is ``w``
CASES = {
    # TestWindow
    "row_number": ("row_number()", lambda: F.row_number(), ["g"],
                   [("o", True, None), ("id", True, None)], None),
    "rank": ("rank()", lambda: F.rank(), ["g"], [("o", True, None)], None),
    "dense_rank": ("dense_rank()", lambda: F.dense_rank(), ["g"],
                   [("o", True, None)], None),
    "lead": ("lead(x)", lambda: F.lead("x"), ["g"],
             [("o", True, None), ("id", True, None)], None),
    "lag": ("lag(v, 2)", lambda: F.lag("v", 2), ["g"],
            [("o", True, None), ("id", True, None)], None),
    "lead_string": ("lead(s, 1)", lambda: F.lead("s"), ["g"],
                    [("id", True, None)], None),
    "partition_sum": ("sum(x)", lambda: F.sum("x"), ["g"], [],
                      ("rows", None, None)),
    "partition_count": ("count(v)", lambda: F.count("v"), ["g"], [],
                        ("rows", None, None)),
    "partition_count_star": ("count(*)", lambda: F.count(), ["s"], [],
                             ("rows", None, None)),
    "running_sum": ("sum(v)", lambda: F.sum("v"), ["g"],
                    [("o", True, None), ("id", True, None)],
                    ("rows", None, 0)),
    "global_row_number": ("row_number()", lambda: F.row_number(), [],
                          [("o", True, None), ("id", True, None)], None),
    # TestFrames
    "bounded_rows": ("sum(v)", lambda: F.sum("v"), ["g"],
                     [("o", True, None), ("id", True, None)],
                     ("rows", -2, 1)),
    "range_sum": ("sum(v)", lambda: F.sum("v"), ["g"], [("o", True, None)],
                  ("range", -5, 5)),
    "range_count": ("count(v)", lambda: F.count("v"), ["g"],
                    [("o", True, None)], ("range", None, 0)),
    "range_avg": ("avg(v)", lambda: F.avg("v"), ["g"], [("o", True, None)],
                  ("range", -3, 3)),
    "range_desc": ("sum(v)", lambda: F.sum("v"), ["g"],
                   [("o", False, None)], ("range", -4, 2)),
    "range_half_unbounded": ("sum(v)", lambda: F.sum("v"), ["g"],
                             [("o", True, None)], ("range", -1, None)),
    "range_half_unbounded_desc": ("sum(v)", lambda: F.sum("v"), ["g"],
                                  [("o", False, None)],
                                  ("range", None, 1)),
    # TestWindowCompleteness
    "ntile": ("ntile(4)", lambda: F.ntile(4), ["g"],
              [("o", True, None), ("id", True, None)], None),
    "percent_rank": ("percent_rank()", lambda: F.percent_rank(), ["g"],
                     [("o", True, None)], None),
    "cume_dist": ("cume_dist()", lambda: F.cume_dist(), ["g"],
                  [("o", True, None)], None),
    "bounded_min_rows": ("min(v)", lambda: F.min("v"), ["g"],
                         [("o", True, None), ("id", True, None)],
                         ("rows", -3, 2)),
    "half_bounded_max_rows": ("max(v)", lambda: F.max("v"), ["g"],
                              [("o", True, None), ("id", True, None)],
                              ("rows", -2, None)),
    "range_min": ("min(v)", lambda: F.min("v"), ["g"], [("o", True, None)],
                  ("range", -5, 5)),
    "range_max": ("max(v)", lambda: F.max("v"), ["g"], [("o", True, None)],
                  ("range", None, 3)),
    "rank_desc_nulls_last": ("rank()", lambda: F.rank(), ["g"],
                             [("v", False, False)], None),
    "dense_rank_asc_nulls_last": ("dense_rank()", lambda: F.dense_rank(),
                                  ["g"], [("v", True, False)], None),
    # keys of every type, double values over every frame kind
    "string_key_rank": ("rank()", lambda: F.rank(), ["s"],
                        [("f", True, None)], None),
    "date_key_sum": ("sum(x)", lambda: F.sum("x"), ["d"], [],
                     ("rows", None, None)),
    "date_order_range": ("count(*)", lambda: F.count(), ["g"],
                         [("d", True, None)], ("range", -3, 3)),
    "date_order_rank": ("dense_rank()", lambda: F.dense_rank(), ["s"],
                        [("d", False, None)], None),
    "double_order_rows": ("max(x)", lambda: F.max("x"), ["s"],
                          [("f", True, None), ("id", True, None)],
                          ("rows", -1, 1)),
    "running_double_sum": ("sum(x)", lambda: F.sum("x"), ["g"],
                           [("o", True, None), ("id", True, None)],
                           ("rows", None, 0)),
    "bounded_double_sum": ("sum(x)", lambda: F.sum("x"), ["s"],
                           [("id", True, None)], ("rows", -4, 3)),
    "suffix_double_sum": ("sum(x)", lambda: F.sum("x"), ["g"],
                          [("id", True, None)], ("rows", 1, None)),
    "range_double_avg": ("avg(x)", lambda: F.avg("x"), ["s"],
                         [("o", True, None)], ("range", -2, 4)),
    "running_min_double": ("min(x)", lambda: F.min("x"), ["d"],
                           [("id", True, None)], ("rows", None, 0)),
    "date_max": ("max(d)", lambda: F.max("d"), ["g"], [],
                 ("rows", None, None)),
}


def _sql(name: str) -> str:
    fn, _, pb, ob, frame = CASES[name]
    parts = []
    if pb:
        parts.append("partition by " + ", ".join(pb))
    if ob:
        parts.append("order by " + ", ".join(
            c + ("" if asc else " desc") +
            ("" if nf is None else " nulls first" if nf else " nulls last")
            for c, asc, nf in ob))
    if frame is not None:
        kind, lo, hi = frame
        parts.append(f"{kind} between {_bound(lo, True)} and "
                     f"{_bound(hi, False)}")
    return f"select id, {fn} over ({' '.join(parts)}) w from t"


def _port_rows(name: str, api: str):
    s = _port_session()
    if api == "sql":
        return s.sql(_sql(name)).collect()
    _, fn, pb, ob, frame = CASES[name]
    df = s.sql("select * from t")
    orders = [L.SortOrder(F.col(c).expr, asc, nf) for c, asc, nf in ob]
    kw = {"frame": frame} if frame is not None else {}
    out = df.with_window("w", fn(), partition_by=pb, order_by=orders, **kw)
    return out.select("id", "w").collect()


#: cases the JAX package's oracle cannot run, held to its engine alone:
#: its pandas frames fail on a DATE ``max`` over NULLs ("agg function
#: failed [how->max,dtype->object]") and on a string ``lead`` past the
#: edge (its NaN fill is no string: "Expected bytes, got a 'float'")
ORACLE_FAILS = {"date_max", "lead_string", "abs_and_date_case"}


def _engines(name):
    return ("jax",) if name in ORACLE_FAILS else ("jax", "oracle")


@pytest.mark.parametrize("api", ["sql", "dataframe"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_window_matches_jax_and_oracle(name, api):
    got = canon_rows(_port_rows(name, api))
    assert len(got) == TABLE.num_rows
    for engine in _engines(name):
        _compare_rows(_jax_rows(_sql(name), engine), got,
                      rel=DEFAULT_FLOAT_REL)


#: SQL over several windows, aggregates and filters, each against both
#: engines
SQL_QUERIES = {
    "completeness": """
        select g, o, v, id,
               ntile(3) over (partition by g order by o, id) nt,
               percent_rank() over (partition by g order by o) pr,
               cume_dist() over (partition by g order by o) cd,
               min(v) over (partition by g order by o, id
                            rows between 3 preceding and 2 following) mn,
               max(v) over (partition by g order by o
                            range between 5 preceding and 5 following) mx
        from t order by g, o, id""",
    "share_of_partition": """
        select s, sum(x) sx, sum(x) * 100.0 / sum(sum(x)) over
               (partition by g) share, g
        from t group by s, g""",
    "window_over_aggregate_ranked": """
        select g, avg_v, rank() over (order by avg_v desc) r
        from (select g, avg(v) avg_v from t group by g) a""",
    "filter_on_window_column": """
        select * from (select id, g, rank() over (partition by g
               order by x desc nulls last) rnk from t) w
        where rnk < 4""",
    "window_alias_in_order_by": """
        select id, sum(v) over (partition by g order by o, id rows between
               unbounded preceding and current row) rs
        from t order by rs desc, id limit 12""",
    "mixed_keys": """
        select id, row_number() over (partition by g order by id) r1,
               row_number() over (partition by s order by id) r2 from t""",
    "default_frames": """
        select id, sum(v) over (partition by g order by o) running,
               sum(v) over (partition by g) whole from t""",
    "abs_and_date_case": """
        select id, abs(v) av, abs(x) ax,
               case when d is not null then d else max(d) over
               (partition by g) end dd from t""",
}


@pytest.mark.parametrize("name", sorted(SQL_QUERIES))
def test_sql_windows_match_jax_and_oracle(name):
    sql = SQL_QUERIES[name]
    got = _port_session().sql(sql).collect()
    assert got
    for engine in _engines(name):
        _compare_rows(_jax_rows(sql, engine), canon_rows(got),
                      rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("sql,below", [
    ("select id, rank() over (partition by g order by o) r from t",
     "TpuShuffleExchange[HashPartitioner(3)]"),
    ("select id, rank() over (order by o) r from t",
     "TpuCoalescePartitions"),
    ("select id, rank() over (partition by g order by o) r, "
     "rank() over (partition by s order by o) r2 from t",
     "TpuCoalescePartitions"),
    ("select id, rank() over (partition by g order by o) r, "
     "sum(v) over (partition by g) sv from t",
     "TpuShuffleExchange[HashPartitioner(3)]")])
def test_window_plan_shape(sql, below):
    """One PARTITION BY for every function of the node: a hash exchange on
    it into min(shuffle.partitions, the child's partitions); none, or
    mixed keys: one stream.  Over one partition nothing is added."""
    lines = [ln.strip() for ln in
             _port_session().sql(sql).explain().splitlines()]
    i = next(i for i, ln in enumerate(lines) if ln.startswith("TpuWindow"))
    assert lines[i + 1] == below
    one = [ln.strip() for ln in _port_session(parts=1).sql(sql).explain()
           .splitlines()]
    i = next(i for i, ln in enumerate(one) if ln.startswith("TpuWindow"))
    assert one[i + 1].startswith("TpuLocalScan")


def test_functions_of_one_spec_share_a_sort(monkeypatch):
    """Two functions over one PARTITION BY and ORDER BY sort once; a
    third of another order sorts again."""
    from spark_rapids_tpu_torch.exec import tpu_window
    calls = []
    real = tpu_window.sorted_words
    monkeypatch.setattr(tpu_window, "sorted_words",
                        lambda w: calls.append(1) or real(w))
    _port_session(parts=1).sql(
        "select id, max(x) over (partition by g order by o rows between "
        "unbounded preceding and current row) a, sum(x) over (partition by "
        "g order by o rows between unbounded preceding and current row) b, "
        "rank() over (partition by g order by id) c from t").collect()
    assert len(calls) == 2


def test_filter_stays_above_window():
    """A filter on a window's column, and one on a plain column above the
    window, stay above it: no rule moves a filter through a window."""
    sql = ("select * from (select id, g, rank() over (partition by g order "
           "by o) r from t) w where r < 3 and g = 1")
    lines = [ln.strip() for ln in _port_session().sql(sql).explain()
             .splitlines()]
    i = next(i for i, ln in enumerate(lines) if ln.startswith("TpuWindow"))
    assert any(ln.startswith("TpuFilter") for ln in lines[:i])
    assert not any(ln.startswith("TpuFilter") for ln in lines[i:])


def test_pruning_reads_what_the_window_needs(tmp_path):
    """The Parquet scan under a window keeps the columns the window and
    the query read, and no other."""
    import pyarrow.parquet as papq
    from spark_rapids_tpu_torch.api.sql import sql_to_plan
    from spark_rapids_tpu_torch.plan.logical_opt import prune_scan_columns
    path = str(tmp_path / "t.parquet")
    papq.write_table(TABLE, path)
    s = TpuSession(device="cpu")
    s.read.parquet(path).create_or_replace_temp_view("t")
    plan = prune_scan_columns(sql_to_plan(
        "select id, sum(x) over (partition by g order by o) w from t",
        s._views, s))
    node = plan
    while node.children:
        node = node.children[0]
    assert set(node.schema.names) == {"id", "x", "g", "o"}


def test_running_sum_depends_on_its_segment_alone():
    """A running double sum restarts at each partition: a partition's sums
    are the same bits after a partition of huge values as alone."""
    rng = np.random.default_rng(7)
    n = 300
    g = np.repeat([0, 1], n // 2)
    x = np.where(g == 0, rng.random(n) * 1e15, rng.random(n))
    t = pa.table({"id": np.arange(n), "g": g, "x": x})
    sql = ("select id, sum(x) over (partition by g order by id rows between "
           "unbounded preceding and current row) w from t where g = 1 or "
           "g = {}")

    def run(other):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 64}),
                       device="cpu")
        s.create_dataframe(t).create_or_replace_temp_view("t")
        rows = s.sql(sql.format(other)).collect()
        return {i: w for i, w in rows if i >= n // 2}
    assert run(0) == run(1)
    alone = run(1)
    acc = 0.0
    for i in range(n // 2, n):
        acc += x[i]
        assert abs(alone[i] - acc) <= 1e-12 * acc


@pytest.mark.parametrize("sql", [
    "select min(v) from t",
    "select g, min(v) from t group by g",
    "select id from t where rank() over (order by o) < 3",
    "select id, ntile(0) over (order by o) n from t",
    "select id, min(s) over (partition by g) m from t",
    "select id, sum(s) over (partition by g) m from t",
    "select id, stddev(x) over (partition by g) m from t",
    "select id, sum(v) over (partition by g order by o, id range between "
    "1 preceding and 1 following) m from t",
    "select id, sum(v) over (partition by g order by s range between "
    "1 preceding and 1 following) m from t",
    "select id, sum(v) over (partition by g order by o rows between "
    "1 following and 1 preceding) m from t",
    "select id, rank() from t",
    "select id, lead(v, 1, 0) over (order by id) m from t",
])
def test_unsupported_windows_raise_sql_error(sql):
    with pytest.raises(SqlError):
        _port_session().sql(sql)


def test_grouped_min_raises_through_the_dataframe_api():
    s = _port_session()
    with pytest.raises(NotImplementedError):
        s.sql("select * from t").group_by("g").agg(F.min("v"))


def test_reference_lead_lag_drop_default():
    """``lead(v, 1, 99)`` and ``lag(v, 2, 0)``: Spark answers the default
    past the partition's edge; the JAX engine and its oracle answer NULL
    (``spark_rapids_tpu/exec/tpu_window.py`` never reads the default).
    The port raises ``SqlError`` rather than give either."""
    data = pa.table({"k": pa.array([1, 1, 1, 2, 2], pa.int64()),
                     "v": pa.array([10, 20, 30, 40, 50], pa.int64())})
    sql = ("select k, v, lead(v, 1, 99) over (partition by k order by v) "
           "ld, lag(v, 2, 0) over (partition by k order by v) lg from t")

    def run(s):
        s.create_dataframe(data).create_or_replace_temp_view("t")
        return sorted(s.sql(sql).collect())
    spark = [(1, 10, 20, 0), (1, 20, 30, 0), (1, 30, 99, 10),
             (2, 40, 50, 0), (2, 50, 99, 0)]
    reference = [(1, 10, 20, None), (1, 20, 30, None), (1, 30, None, 10),
                 (2, 40, 50, None), (2, 50, None, None)]
    for engine in (with_tpu_session, with_cpu_session):
        got = engine(run)
        assert got == reference and got != spark
    s = TpuSession(device="cpu")
    s.create_dataframe(data).create_or_replace_temp_view("t")
    with pytest.raises(SqlError, match="default"):
        s.sql(sql)
    no_default = sql.replace(", 99", "").replace(", 0)", ")")
    assert sorted(s.sql(no_default).collect()) == \
        [(1, 10, 20, None), (1, 20, 30, None), (1, 30, None, 10),
         (2, 40, 50, None), (2, 50, None, None)]


# -- the window kernels against plain Python ---------------------------------

def _segments_of(keys):
    keys = torch.tensor(keys)
    boundary = torch.ones_like(keys, dtype=torch.bool)
    boundary[1:] = keys[1:] != keys[:-1]
    return wk.segments(boundary, torch.ones_like(boundary))


@pytest.mark.parametrize("seed", range(4))
def test_seg_scan_matches_python(seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 6, 50))
    x = rng.integers(-20, 20, 50)
    segs = _segments_of(keys)
    t = torch.tensor(x)
    fwd = wk.seg_scan(t, segs.row_in_seg, torch.add, 0)
    back = wk.seg_scan(t, segs.end - segs.pos, torch.maximum,
                       wk.I64_MIN, reverse=True)
    for i in range(50):
        same = [j for j in range(50) if keys[j] == keys[i]]
        assert fwd[i] == sum(x[j] for j in same if j <= i)
        assert back[i] == max(x[j] for j in same if j >= i)


@pytest.mark.parametrize("seed", range(4))
def test_block_sum_and_sparse_table_match_python(seed):
    rng = np.random.default_rng(seed)
    n = 64
    x = rng.random(n)
    lo = rng.integers(0, n, n)
    hi = np.minimum(lo + rng.integers(-1, 9, n), n - 1)
    widest = int(max(hi - lo + 1))
    got = wk.block_sum(torch.tensor(x), torch.tensor(lo), torch.tensor(hi),
                       widest)
    mx = wk.sparse_minmax(torch.tensor(x), torch.tensor(lo),
                          torch.tensor(hi), widest, torch.maximum,
                          float("-inf"))
    for i in range(n):
        want = sum(x[lo[i]:hi[i] + 1])
        assert abs(float(got[i]) - want) <= 1e-12 * max(1.0, want)
        if hi[i] >= lo[i]:
            assert float(mx[i]) == max(x[lo[i]:hi[i] + 1])


def test_order_ints_keep_float_order():
    x = torch.tensor([1.5, -0.0, 0.0, float("nan"), -3.0, float("inf"),
                      float("-inf")], dtype=torch.float64)
    w = wk.order_ints(x)
    order = torch.argsort(w, stable=True).tolist()
    assert [x[i].item() for i in order][:-1] == \
        [float("-inf"), -3.0, 0.0, 0.0, 1.5, float("inf")]
    assert order[-1] == 3
    back = wk.from_order_ints(w, torch.float32)
    assert back.dtype == torch.float32 and back[0].item() == 1.5


def test_range_positions_match_python():
    """RANGE frames over an ascending key with NULLs first, per segment."""
    keys = [0, 0, 0, 0, 0, 1, 1, 1]
    vals = [None, 1, 2, 2, 7, None, 3, 4]
    segs = _segments_of(keys)
    valid = torch.tensor([v is not None for v in vals])
    u = torch.tensor([0 if v is None else v for v in vals])
    first, last = wk.range_positions(u, valid, segs, -1, 1, True)
    want = []
    for i, v in enumerate(vals):
        same = [j for j in range(8) if keys[j] == keys[i]]
        if v is None:
            rows = [j for j in same if vals[j] is None]
        else:
            rows = [j for j in same if vals[j] is not None and
                    v - 1 <= vals[j] <= v + 1]
        want.append((min(rows), max(rows)))
    assert list(zip(first.tolist(), last.tolist())) == want
