"""The port's adaptive query execution (``exec/adaptive.py``) against the
JAX package's.

The helpers that decide from the shuffle's statistics
(``coalesce_partition_ids``, ``skew_split_sizes``) equal the
reference's exactly on the same statistics.  The cases of
``tests/test_adaptive.py`` run through both engines, with AQE on as it
is by default in both: the rows equal the JAX engine's and its oracle's,
and where both engines are far from a threshold they choose the same
strategy.  Byte counts differ between the engines (their capacity
padding differs), so no case sits near a threshold.  Both packages'
``BROADCAST_ROW_THRESHOLD`` are lowered inside each case so that the
planners make adaptive joins of a few thousand rows.  With AQE off the
port plans as before AQE came (the static plans, held here as text), apart
from the aggregate's exchange width, which is now the reference's.
Inputs are made with numpy from a seed; the port runs on the CPU.
"""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.exec import adaptive as jadaptive
from spark_rapids_tpu.plan import overrides as joverrides

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec import adaptive
from spark_rapids_tpu_torch.plan import overrides

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, _row_key
from tests.jax_reference import with_cpu_session, with_tpu_session

AQE = "spark.rapids.tpu.sql.adaptive."
BATCH = "spark.rapids.tpu.sql.batchSizeRows"
AQE_OFF = {AQE + "enabled": False}
HOWS = ["inner", "left", "right", "full", "semi", "anti"]


@pytest.fixture(autouse=True)
def adaptive_joins(monkeypatch):
    """Joins of the test sizes plan as adaptive joins in both packages
    (the JAX package's tests hide the row estimate by a repartition)."""
    monkeypatch.setattr(joverrides, "BROADCAST_ROW_THRESHOLD", 4)
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 4)


def _stats(rng, n: int, spread: int):
    return [(int(b), int(r)) for b, r in zip(
        rng.integers(0, spread, n) * rng.integers(1, 4, n),
        rng.integers(0, 1000, n))]


FIXED = [  # the reference's own cases (tests/test_adaptive.py)
    ([(10, 1), (10, 1), (10, 1), (100, 9), (10, 1)], 35, 5.0, 1 << 20),
    ([(1, 1)] * 8, 1000, 5.0, 1 << 20),
    ([(50, 1), (60, 1), (1, 1)], 64, 5.0, 1 << 20),
    ([(100, 1)] * 7 + [(10_000_000_000, 1)], 64, 5.0, 1 << 20),
    ([(10, 1)] * 7 + [(1000, 1)], 64, 5.0, 1 << 20),
    ([], 64, 5.0, 1), ([(0, 0)], 0, 0.5, 0)]


@pytest.mark.parametrize("case", range(len(FIXED) + 24))
def test_helpers_equal_reference(case):
    """Groups and skew flags of seeded random statistics (and the
    reference's fixed cases): 1-64 partitions, targets below, near and
    above the partition sizes, factors from 0.5 to 8."""
    if case < len(FIXED):
        stats, target, factor, min_bytes = FIXED[case]
    else:
        rng = np.random.default_rng(case)
        n = int(rng.integers(1, 65))
        spread = int(rng.choice([10, 1000, 1 << 24]))
        stats = _stats(rng, n, spread)
        target = int(rng.integers(0, 4 * spread))
        factor = float(rng.choice([0.5, 1.0, 1.5, 5.0, 8.0]))
        min_bytes = int(rng.integers(0, 2 * spread))
    assert adaptive.coalesce_partition_ids(stats, target) == \
        jadaptive.coalesce_partition_ids(stats, target)
    assert adaptive.skew_split_sizes(stats, factor, min_bytes) == \
        jadaptive.skew_split_sizes(stats, factor, min_bytes)


def _tables(n_left: int = 200, n_right: int = 20):
    """The reference's ``_tables``: k = id % 7 on both sides."""
    left = pa.table({"k": np.arange(n_left) % 7, "v": np.arange(n_left)})
    right = pa.table({"k2": np.arange(n_right) % 7,
                      "w": np.arange(n_right) * 10})
    return left, right


def _join(s, how, n_left=200, n_right=20):
    lt, rt = _tables(n_left, n_right)
    a = s.create_dataframe(lt, num_partitions=3)
    b = s.create_dataframe(rt, num_partitions=3)
    df = a.join(b, a["k"] == b["k2"], how)
    return df if how in ("semi", "anti") else df.select("k", "v", "w")


def _find(plan, name: str):
    if type(plan).__name__ == name:
        return plan
    for c in plan.children:
        got = _find(c, name)
        if got is not None:
            return got
    return None


def _port(conf=None):
    return TpuSession(TpuConf(conf or {}), device="cpu")


def _both(query, conf=None):
    """(port rows, its plan, JAX engine rows, its plan, oracle rows)."""
    s = _port(conf)
    df = query(s)
    got = sorted(df.collect(), key=_row_key)

    def jax_run(js):
        jdf = query(js)
        return jdf.collect(), jdf._last_physical_plan
    jax_rows, jax_plan = with_tpu_session(jax_run, conf)
    oracle = with_cpu_session(lambda js: query(js).collect(), conf)
    return (got, s.last_physical_plan, sorted(jax_rows, key=_row_key),
            jax_plan, sorted(oracle, key=_row_key))


def _check(got, jax_rows, oracle):
    _compare_rows(jax_rows, got, rel=DEFAULT_FLOAT_REL)
    _compare_rows(oracle, got, rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("how", HOWS)
def test_join_parity_aqe_on(how):
    got, plan, jax_rows, jax_plan, oracle = _both(lambda s: _join(s, how))
    _check(got, jax_rows, oracle)
    node = _find(plan, "TpuAdaptiveShuffledJoin")
    jnode = _find(jax_plan, "TpuAdaptiveShuffledJoin")
    assert node is not None and jnode is not None
    # a build of 20 (or 200) rows is far below 32 MiB: both convert,
    # but a full join, which stays shuffled
    want = "shuffled" if how == "full" else "broadcast"
    assert node.strategy == jnode.strategy == want


def test_small_build_converts_to_broadcast():
    got, plan, jax_rows, jax_plan, oracle = _both(
        lambda s: _join(s, "inner", n_left=500, n_right=5))
    _check(got, jax_rows, oracle)
    node = _find(plan, "TpuAdaptiveShuffledJoin")
    assert node.strategy == "broadcast" == \
        _find(jax_plan, "TpuAdaptiveShuffledJoin").strategy
    assert len(got) == sum(1 for i in range(500) if i % 7 <= 4)
    # the probe side streams its own three partitions, unshuffled
    assert node.tasks == 3
    assert "strategy=broadcast, build=right, 3 partitions" in \
        plan.tree_string()


def test_large_build_stays_shuffled():
    conf = {AQE + "autoBroadcastJoinBytes": 64}
    got, plan, jax_rows, jax_plan, oracle = _both(
        lambda s: _join(s, "inner", n_left=100, n_right=100), conf)
    _check(got, jax_rows, oracle)
    assert _find(plan, "TpuAdaptiveShuffledJoin").strategy == "shuffled" \
        == _find(jax_plan, "TpuAdaptiveShuffledJoin").strategy


#: the reference's skew case, with a target of one byte so that no two
#: partitions group (a group of several is never split: its 64 MiB
#: default groups all eight here, and the reference's own case never
#: splits)
SKEW_CONF = {AQE + "skewedPartitionThresholdBytes": 1,
             AQE + "skewedPartitionFactor": 1.5,
             AQE + "autoBroadcastJoinBytes": 1,
             AQE + "targetPartitionBytes": 1, BATCH: 64}


def _skewed(s):
    """90% of the probe rows share key 99 (the reference's case)."""
    ids = np.arange(1000)
    left = pa.table({"k": np.where(ids % 10 == 0, ids % 5, 99), "v": ids})
    right = pa.table({"k2": np.arange(200) % 100,
                      "w": np.arange(200) * 3})
    a = s.create_dataframe(left, num_partitions=2)
    b = s.create_dataframe(right)
    return a.join(b, a["k"] == b["k2"], "inner").select("k", "v", "w")


def test_skewed_join_parity():
    """The hot partition is cut into slices of its blocks, each joined to
    the whole build partition, and the split shows in ``explain()``."""
    s = _port(SKEW_CONF)
    df = _skewed(s)
    got = sorted(df.collect(), key=_row_key)
    node = _find(s.last_physical_plan, "TpuAdaptiveShuffledJoin")
    assert node.strategy == "shuffled"
    # keys 0 and 99 only: six reduce partitions are empty, so the median
    # is 0 and both others split, each of its 16 blocks (one per 64-row
    # map batch) into one of 4 slices
    assert node.splits == [4, 4]
    assert node.tasks == len(node.groups) + 6
    assert "2 skewed into 4+4 slices" in df.explain()
    jax_rows = sorted(with_tpu_session(lambda js: _skewed(js).collect(),
                                       SKEW_CONF), key=_row_key)
    oracle = sorted(with_cpu_session(lambda js: _skewed(js).collect(),
                                     SKEW_CONF), key=_row_key)
    _check(got, jax_rows, oracle)
    assert len(got) == 900 * 2 + 100 * 2


def test_skew_split_keeps_rows_against_aqe_off():
    """The split's rows equal the same join's with AQE off, as a
    multiset; the build partition's blocks outlive every slice but the
    last, and nothing outlives the query."""
    from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
    on = sorted(_skewed(_port(SKEW_CONF)).collect(), key=_row_key)
    off = sorted(_skewed(_port({**SKEW_CONF, **AQE_OFF})).collect(),
                 key=_row_key)
    assert on == off
    assert BufferCatalog.get().stats()["num_buffers"] == 0


def _aggregate(s, parts=4, n=500, mod=13):
    ids = np.arange(n)
    df = s.create_dataframe(pa.table({"g": ids % mod, "v": ids}),
                            num_partitions=parts)
    return df.group_by("g").agg(PF.sum("v").alias("sv"),
                                PF.count("v").alias("n")) \
        if isinstance(s, TpuSession) else \
        df.group_by("g").agg(JF.sum("v").alias("sv"),
                             JF.count("v").alias("n"))


def test_agg_parity_with_coalesced_read():
    got, plan, jax_rows, jax_plan, oracle = _both(_aggregate)
    _check(got, jax_rows, oracle)
    read = _find(plan, "TpuAQEShuffleRead")
    assert read is not None and _find(jax_plan, "TpuAQEShuffleRead")


def test_aqe_read_coalesces_small_partitions():
    """Eight reduce partitions of a few bytes each are read as one group;
    the JAX engine's read makes the same one group."""
    conf = {"spark.rapids.tpu.sql.shuffle.partitions": 8, BATCH: 64}
    got, plan, jax_rows, jax_plan, oracle = _both(
        lambda s: _aggregate(s, parts=4, n=100, mod=5), conf)
    _check(got, jax_rows, oracle)
    read = _find(plan, "TpuAQEShuffleRead")
    assert read.children[0].num_partitions() == 2
    assert read.groups == [[0, 1]] and \
        len(_find(jax_plan, "TpuAQEShuffleRead")._groups) == 1
    assert "TpuAQEShuffleRead[1 groups]" in plan.tree_string()
    assert len(got) == 5


def test_aqe_read_groups_to_target_bytes():
    """A target below one partition's bytes reads each partition alone;
    the rows do not change."""
    conf = {AQE + "targetPartitionBytes": 1, BATCH: 64}
    s = _port(conf)
    df = _aggregate(s, parts=4, n=2000, mod=97)
    got = sorted(df.collect(), key=_row_key)
    read = _find(s.last_physical_plan, "TpuAQEShuffleRead")
    n = read.children[0].num_partitions()
    assert n > 1 and read.groups == [[i] for i in range(n)]
    off = _aggregate(_port({**conf, **AQE_OFF}), parts=4, n=2000, mod=97)
    assert got == sorted(off.collect(), key=_row_key) and len(got) == 97


# the static plans of these queries (the planner before AQE; its aggregate
# exchange took shuffle.partitions, 4 here), with the aggregate's width
# in braces and the join's exchange width as {join}
_JOIN_PLAN = """{ind}TpuShuffledHashJoin[{how}, build=right]
{ind}  TpuShuffleExchange[HashPartitioner({join})]
{ind}    TpuLocalScan[3 partitions]
{ind}  TpuShuffleExchange[HashPartitioner({join})]
{ind}    TpuLocalScan[2 partitions]"""
_AGG_PLAN = """TpuHashAggregate[final]
  TpuShuffleExchange[HashPartitioner({agg})]
    TpuHashAggregate[partial]
"""
STATIC_PLANS = {
    "agg": _AGG_PLAN + _JOIN_PLAN.replace("{ind}", "      ")
    .replace("{how}", "inner"),
    "left": _AGG_PLAN + _JOIN_PLAN.replace("{ind}", "      ")
    .replace("{how}", "left"),
    "window": """TpuWindow[['r']]
  TpuShuffleExchange[HashPartitioner(3)]
    TpuLocalScan[3 partitions]""",
    "scan_agg": _AGG_PLAN + "      TpuLocalScan[3 partitions]",
    # a sort over more than one partition range-partitions first
    "sort": {4: """TpuSort
  TpuShuffleExchange[RangePartitioner(4)]
""" + _JOIN_PLAN.replace("{ind}", "    ").replace("{how}", "inner"),
             1: "TpuSort\n" + _JOIN_PLAN.replace("{ind}", "  ")
             .replace("{how}", "inner")}}


def _plan_queries(s):
    rng = np.random.default_rng(1)
    lt = pa.table({"k": rng.integers(0, 20, 2000),
                   "v": rng.permutation(2000), "g": rng.integers(0, 9, 2000)})
    rt = pa.table({"k2": rng.integers(0, 20, 300), "w": rng.random(300)})
    a = s.create_dataframe(lt, num_partitions=3)
    b = s.create_dataframe(rt, num_partitions=2)
    j = a.join(b, a["k"] == b["k2"], "inner")
    return {"agg": j.group_by("g").agg(PF.sum("w").alias("sw")),
            "sort": j.sort("v"),
            "window": a.with_window("r", PF.row_number(), partition_by=["g"],
                                    order_by=["v"]),
            "left": a.join(b, a["k"] == b["k2"], "left").group_by("k")
            .agg(PF.count("v").alias("c")),
            "scan_agg": a.group_by("g").agg(PF.sum("v").alias("sv"))}


@pytest.mark.parametrize("batch,join,agg,scan_agg", [(400, 4, 4, 3),
                                                   (1 << 20, 1, 1, 1)])
@pytest.mark.parametrize("q", list(STATIC_PLANS))
def test_aqe_off_plans_are_the_static_ones(monkeypatch, q, batch, join, agg, scan_agg):
    """AQE off: the static plan of each query, but for the aggregate's
    exchange, whose width is now ``_pick_partitions`` of the aggregate
    at most the partial aggregate's partitions (the reference's): 2000
    rows in 400-row batches need 5, so 4 over the join (the shuffle's
    partitions here) and 3 over a 3-partition scan; in 1<<20-row batches
    1 (before AQE: 4 in every case).  With AQE on, the same queries read
    their aggregate and window exchanges through a TpuAQEShuffleRead."""
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 100)
    conf = {BATCH: batch, "spark.rapids.tpu.sql.shuffle.partitions": 4}
    got = _plan_queries(_port({**conf, **AQE_OFF}))[q].explain()
    want = STATIC_PLANS[q]
    if q == "sort":
        want = want[join]
    want = want.replace("{join}", str(join)).replace(
        "{agg}", str(scan_agg if q == "scan_agg" else agg))
    assert got == want
    on = _plan_queries(_port(conf))[q].explain()
    assert ("TpuAQEShuffleRead" in on) == (q != "sort")
    assert ("TpuShuffledHashJoin" in on) is False


def test_aggregate_width_is_the_references():
    """The aggregate's exchange width equals the JAX engine's (AQE off in
    both) over several estimates: 1 to 8 partitions."""
    for n in (100, 900, 3000):
        conf = {BATCH: 400, **AQE_OFF}

        def query(s):
            ids = np.arange(n)
            df = s.create_dataframe(pa.table({"g": ids % 11, "v": ids}),
                                    num_partitions=8)
            f = PF if isinstance(s, TpuSession) else JF
            return df.group_by("g").agg(f.sum("v").alias("sv"))
        got = query(_port(conf)).explain()
        want = with_tpu_session(lambda s: s.explain(query(s)._plan), conf)
        width = min(8, -(-n // 400))
        assert f"TpuShuffleExchange[HashPartitioner({width})]" in got
        assert f"HashPartitioner({width})" in want


def _converted(s):
    """A 4-partition probe side joined to a 20-row build, all of it far
    below one batch, so the join's width is 1; the build converts to a
    broadcast and the join returns the probe's four partitions."""
    rng = np.random.default_rng(1)
    lt = pa.table({"k": rng.integers(0, 20, 2000), "v": rng.permutation(2000),
                   "g": rng.integers(0, 6, 2000)})
    rt = pa.table({"k2": np.arange(20), "w": np.arange(20) * 0.5})
    a = s.create_dataframe(lt, num_partitions=4)
    b = s.create_dataframe(rt)
    return a.join(b, a["k"] == b["k2"], "inner")


def test_runtime_partition_count_holds_for_sort_and_window():
    """A width of 1 over a 4-partition probe that converts to a broadcast
    returns four partitions: the join reports more than one, so the sort
    above range-partitions and the window exchanges, and the rows are
    globally sorted and each window sums its whole PARTITION BY group."""
    s = _port()
    df = _converted(s).sort("v")
    rows = df.collect()
    node = _find(s.last_physical_plan, "TpuAdaptiveShuffledJoin")
    assert node.width == 1 and node.strategy == "broadcast"
    assert node.tasks == 4 and node.num_partitions() > 1
    assert _find(s.last_physical_plan, "TpuShuffleExchange") is not None
    assert [r[1] for r in rows] == sorted(r[1] for r in rows)
    _compare_rows(with_cpu_session(lambda js: _converted(js).sort("v")
                                   .collect()), rows, rel=DEFAULT_FLOAT_REL)
    wdf = _converted(s).with_window("rs", PF.sum("w"), partition_by=["g"],
                                    order_by=["v"])
    wrows = wdf.collect()
    plan = wdf.explain()
    assert "TpuWindow" in plan and "TpuAQEShuffleRead" in plan
    by_group = {}
    for k, v, g, k2, w, rs in sorted(wrows, key=lambda r: (r[2], r[1])):
        by_group[g] = by_group.get(g, 0.0) + w
        assert rs == pytest.approx(by_group[g], rel=1e-12)
    assert len(wrows) == 2000


def test_reference_sort_over_converted_join_is_not_global():
    """The JAX package's fault: its adaptive join reports its planned
    width (1) after a broadcast conversion returns the probe's four
    partitions (``exec/adaptive.py:146``), so the sort above it sorts
    each partition apart and the rows are not globally sorted.  The port
    sorts them (previous test)."""
    rows = with_tpu_session(lambda js: _converted(js).sort("v").collect())
    vs = [r[1] for r in rows]
    assert sorted(vs) == list(range(2000)) and vs != sorted(vs)


def test_partition_bytes_count_a_string_slice_once():
    """The split's statistics count each partition's own rows: value and
    validity bytes, a string's offsets and its own characters, not the
    byte buffer its slice shares with the whole split batch; a split not
    asked for them (a plain exchange's) reads no string bytes."""
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.arrow import from_arrow
    from spark_rapids_tpu_torch.expr import core as ec
    from spark_rapids_tpu_torch.shuffle.partitioners import HashPartitioner
    rng = np.random.default_rng(12)
    n, parts = 2000, 8
    words = ["", "a", "bb", "ccccc", "dddddddddddd", "eeeeeeeeeeeeeeeeeeeee"]
    s = [words[i] for i in rng.integers(0, len(words), n)]
    table = pa.table({"s": pa.array(s), "v": rng.integers(0, 9, n)})
    batch = from_arrow(table, "cpu")
    part = HashPartitioner([ec.AttributeReference("v", T.INT64)], parts)
    assert part.split(batch).string_bytes is None
    split = part.split(batch, string_bytes=True)
    total = 0
    for pid in range(parts):
        piece = split.partition_slice(pid)
        if piece is None:
            continue
        chars = sum(len(x) for x in to_pylist_column(piece, "s"))
        rows = piece.num_rows
        want = rows + 4 * (rows + 1) + chars + rows + 8 * rows
        assert split.slice_bytes(pid, piece) == want
        total += chars
    assert total == sum(len(x) for x in s)


def to_pylist_column(batch, name):
    from spark_rapids_tpu_torch.columnar.arrow import to_arrow
    return to_arrow(batch).column(name).to_pylist()


def test_plain_exchange_has_no_statistics():
    """With AQE off an exchange's map output counts nothing, and asking
    it for statistics is a fault, not a silent zero."""
    from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchange
    s = _port(AQE_OFF)
    df = _aggregate(s, parts=2, n=300, mod=7)
    df.collect()
    ex = _find(s.last_physical_plan, "TpuShuffleExchange")
    assert isinstance(ex, TpuShuffleExchange)
    out = ex.map_output()
    with pytest.raises(ValueError):
        out.partition_stats()
    stats = ex.map_output(with_stats=True).partition_stats()
    assert sum(r for _, r in stats) > 0
    ex.close()


def test_explain_keeps_its_own_plan_when_planning_fails(monkeypatch):
    """A collect that fails while planning leaves the DataFrame's explain
    on its own plan, not on the session's previous query."""
    s = _port()
    other = _aggregate(s, parts=2, n=300, mod=7)
    other.collect()
    df = _aggregate(s, parts=2, n=300, mod=11)

    def fail(logical):
        raise RuntimeError("planning failed")
    monkeypatch.setattr(s, "plan", fail)
    with pytest.raises(RuntimeError):
        df.to_arrow()
    monkeypatch.undo()
    assert df._last_physical_plan is None
    assert "TpuAQEShuffleRead[pending]" in df.explain()
