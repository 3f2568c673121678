"""The join's direct-address probe (``kernels/join.direct_tables``,
``cuda_ops.direct_probe``) on the CPU.

A build side of one integer or DATE key whose valid values span at most
1<<24 is probed by two int32 tables instead of the binary search, in a
partition whose stream capacity is at least 1<<19 rows: the reference's
``TpuHashJoinBase._prepare_direct`` and its rule
(``spark_rapids_tpu/exec/tpu_join.py:151-164``, :254-313).  Here: the
tables against a numpy construction, the lookup's (lo, counts) against
the search's on the same build (nulls, negative and out-of-range keys,
dead rows), the choice against the reference's at the edges of both
limits, and joins that take the direct path against the JAX package's
engine and oracle.  Inputs are made with numpy from a seed.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import arrow as jarrow
from spark_rapids_tpu.exec.tpu_join import TpuHashJoinBase as JJoinBase

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.columnar.arrow import from_arrow
from spark_rapids_tpu_torch.columnar.column import bucket_capacity
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.tpu_join import TpuHashJoinBase
from spark_rapids_tpu_torch.kernels import canon, cuda_ops
from spark_rapids_tpu_torch.kernels import join as join_k
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import overrides

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, _row_key
from tests.jax_reference import with_cpu_session, with_tpu_session


def _column(kind: str, rng, n: int, null_frac: float = 0.1, wider: int = 0):
    """A key array of ``kind`` (``int64`` with negatives, ``int32``,
    ``date``) with ``null_frac`` nulls, its range ``wider`` values wider
    on each side."""
    mask = rng.random(n) < null_frac
    lo, hi = {"int64": (-700, 500), "int32": (-30, 90),
              "date": (10_000, 11_825)}[kind]
    keys = rng.integers(lo - wider, hi + wider, n)
    if kind == "int64":
        return pa.array(keys, mask=mask)
    arr = pa.array(keys.astype(np.int32), mask=mask)
    return arr.cast(pa.date32()) if kind == "date" else arr


def _ints(arr: pa.Array) -> np.ndarray:
    if pa.types.is_date32(arr.type):
        arr = arr.cast(pa.int32())
    return np.asarray(arr.fill_null(0)).astype(np.int64)


def _words(batch, live=None):
    col = batch.columns[0]
    if live is None:
        live = batch.live_mask()
    return canon.column_key_words(col, live)


@pytest.mark.parametrize("kind", ["int64", "int32", "date"])
def test_direct_tables_match_numpy(kind):
    rng = np.random.default_rng(3)
    keys = _column(kind, rng, 3000)
    batch = from_arrow(pa.table({"k": keys}), "cpu")
    dt = join_k.direct_tables(batch.columns[0], batch.num_rows)
    valid = ~np.asarray(keys.is_null())
    vals = _ints(keys)[valid]
    lo, hi = int(vals.min()), int(vals.max())
    slots = bucket_capacity(hi - lo + 1)
    hist = np.bincount(vals - lo, minlength=slots)
    nnull = int((~valid).sum())
    excl = np.cumsum(hist) - hist + nnull
    assert (dt.smin, dt.smax, dt.nnull, dt.nvalid) == (lo, hi, nnull,
                                                       int(valid.sum()))
    assert dt.hist.dtype == torch.int32 and dt.excl.dtype == torch.int32
    assert np.array_equal(dt.hist.numpy(), hist)
    assert np.array_equal(dt.excl.numpy(), excl)


@pytest.mark.parametrize("kind", ["int64", "int32", "date"])
def test_direct_counts_equal_probe_counts(kind):
    """Every probe row's (lo, counts) by direct address equals the binary
    search's on the same sorted build: null, out-of-range (below and
    above), absent and present keys, and dead rows past the live ones."""
    rng = np.random.default_rng(11)
    build = from_arrow(pa.table({"k": _column(kind, rng, 900)}), "cpu")
    bt = join_k.build(_words(build))
    dt = join_k.direct_tables(build.columns[0], build.num_rows)
    probe = from_arrow(pa.table({"k": _column(kind, rng, 2500, 0.15, 20)}),
                       "cpu")
    rows = probe.num_rows - 200
    live = torch.arange(probe.capacity) < rows
    words = _words(probe, live)
    want = join_k.probe_counts(bt, words, live, [0])
    got = join_k.direct_counts(dt, probe.columns[0], rows)
    signed = words[1] ^ cuda_ops.SIGN64
    hit = words[0] == 1
    assert bool((hit & (signed < dt.smin)).any())
    assert bool((hit & (signed > dt.smax)).any())
    assert bool((words[0] == 0).any()) and bool((words[0] == 2).any())
    assert bool((want.counts > 0).any())
    assert torch.equal(got.lo, want.lo)
    assert torch.equal(got.counts, want.counts)
    assert torch.equal(got.matched, want.matched)


def test_direct_probe_checks_its_tables():
    keys, valid = torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=bool)
    hist = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_ops.direct_probe(keys, valid, 4, 0, 1024, hist, hist, 0, 0)
    with pytest.raises(ValueError):
        cuda_ops.direct_probe(keys, valid, 4, 0, 5, hist.to(torch.int64),
                              hist, 0, 0)
    with pytest.raises(ValueError):
        cuda_ops.direct_probe(keys.double(), valid, 4, 0, 5, hist, hist, 0,
                              0)
    with pytest.raises(ValueError):
        cuda_ops.direct_probe(keys, valid[:3], 4, 0, 5, hist, hist, 0, 0)


@pytest.mark.parametrize("kind", ["int64", "int32", "date"])
def test_direct_probe_live_count_on_host_or_device(kind):
    """The live count as a host int or as a device count (a filtered
    batch's) gives the same (lo, counts): the rows past it are dead."""
    rng = np.random.default_rng(17)
    build = from_arrow(pa.table({"k": _column(kind, rng, 500)}), "cpu")
    dt = join_k.direct_tables(build.columns[0], build.num_rows)
    probe = from_arrow(pa.table({"k": _column(kind, rng, 1500, 0.1, 10)}),
                       "cpu")
    col, rows = probe.columns[0], probe.num_rows - 300
    host = join_k.direct_counts(dt, col, rows)
    dev = join_k.direct_counts(dt, col, torch.tensor(rows))
    assert torch.equal(host.lo, dev.lo)
    assert torch.equal(host.counts, dev.counts)
    assert bool((host.lo[rows:] == dt.nnull + dt.nvalid).all())
    assert int(host.counts[rows:].abs().sum()) == 0


@pytest.mark.parametrize("span", [1 << 24, (1 << 24) + 1])
def test_direct_range_limit_matches_reference(span):
    """A build whose valid keys span 1<<24 values takes the tables, one
    more does not: as the reference's ``_prepare_direct`` decides."""
    table = pa.table({"k": pa.array([-5, -5 + span - 1, None, 7],
                                    pa.int64())})
    jbatch = jarrow.from_arrow(table)
    ref = JJoinBase._prepare_direct(JJoinBase, None, [jbatch.columns[0]],
                                    jbatch)
    batch = from_arrow(table, "cpu")
    got = join_k.direct_tables(batch.columns[0], batch.num_rows)
    assert (got is None) == (ref is None) == (span > join_k.DIRECT_MAX_RANGE)
    if got is not None:
        assert got.hist.shape[0] == ref[4]
        assert got.smin + (1 << 63) == int(ref[0])
        assert got.smax + (1 << 63) == int(ref[1])
        assert np.array_equal(got.hist.numpy(), np.asarray(ref[2]))
        assert np.array_equal(got.excl.numpy(), np.asarray(ref[3]))


def _broadcast_join(session, stream_rows: int, how: str = "inner",
                    build_keys=None, seed: int = 2):
    rng = np.random.default_rng(seed)
    if build_keys is None:
        build_keys = rng.integers(-40, 400, 300)
    stream = session.create_dataframe(
        pa.table({"k": rng.integers(-60, 420, stream_rows),
                  "v": np.arange(stream_rows, dtype=np.int64)}))
    build = session.create_dataframe(
        pa.table({"bk": pa.array(build_keys, pa.int64()),
                  "w": rng.random(len(build_keys))}))
    return stream.join(build, stream["k"] == build["bk"], how)


def _join_node(plan):
    if isinstance(plan, TpuHashJoinBase):
        return plan
    for c in plan.children:
        got = _join_node(c)
        if got is not None:
            return got
    return None


@pytest.mark.parametrize("stream_rows", [(1 << 19) - 1024, (1 << 19) - 1,
                                         1 << 19])
def test_direct_stream_limit_matches_reference_rule(stream_rows):
    """The reference probes directly when the partition's stream batches
    hold at least 1<<19 rows of capacity (``stream_cap``, :151-164): in
    1024-row batches, (1<<19) - 1024 rows search, (1<<19) - 1 and 1<<19
    rows (512 batches) probe directly."""
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 1024}),
                   device="cpu")
    df = _broadcast_join(s, stream_rows)
    df.collect()
    join = _join_node(s.last_physical_plan)
    assert type(join).__name__ == "TpuBroadcastHashJoin"
    batches = -(-stream_rows // 1024)
    reference_rule = batches * 1024 >= (1 << 19)
    want = {"direct": batches, "search": 0} if reference_rule else \
        {"direct": 0, "search": batches}
    assert join.probes == want


def test_small_first_partition_does_not_freeze_the_choice():
    """A broadcast join whose first stream partition is small searches
    there; its second reaches the limit and probes directly, with the
    tables the build makes then (a union's partitions, one per child)."""
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 1 << 16}),
                   device="cpu")
    rng = np.random.default_rng(4)
    keys = [rng.integers(0, 300, 5000), rng.integers(0, 300, 1 << 19)]
    parts = [s.create_dataframe(pa.table({"k": k})) for k in keys]
    stream = DataFrame(L.Union([p._plan for p in parts]), s)
    build = s.create_dataframe(pa.table({"bk": np.arange(0, 300, 2)}))
    got = len(stream.join(build, stream["k"] == build["bk"], "semi")
              .collect())
    join = _join_node(s.last_physical_plan)
    assert join.probes == {"search": 1, "direct": 8}
    assert got == sum(int((k % 2 == 0).sum()) for k in keys)


def test_each_partition_decides_by_its_own_stream():
    """A broadcast join whose first stream partition reaches the limit
    probes it directly, and a small later partition still searches: the
    tables are kept with the build, the choice is made per partition."""
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 1 << 16}),
                   device="cpu")
    rng = np.random.default_rng(5)
    keys = [rng.integers(0, 300, 1 << 19), rng.integers(0, 300, 5000)]
    parts = [s.create_dataframe(pa.table({"k": k})) for k in keys]
    stream = DataFrame(L.Union([p._plan for p in parts]), s)
    build = s.create_dataframe(pa.table({"bk": np.arange(0, 300, 2)}))
    got = len(stream.join(build, stream["k"] == build["bk"], "semi")
              .collect())
    join = _join_node(s.last_physical_plan)
    assert join.probes == {"direct": 8, "search": 1}
    assert got == sum(int((k % 2 == 0).sum()) for k in keys)


@pytest.mark.parametrize("how,residual", [
    ("inner", False), ("left", False), ("right", False), ("semi", False),
    ("anti", False), ("full", False), ("inner", True)])
def test_direct_path_is_taken_by_the_rule(monkeypatch, how, residual):
    """No residual, not full, one integer key: the direct path (with the
    stream limit lowered to the test's size); else the search."""
    monkeypatch.setattr(join_k, "DIRECT_MIN_STREAM", 1024)
    s = TpuSession(TpuConf(), device="cpu")
    df = _broadcast_join(s, 3000, how if how != "full" else "inner")
    if residual:
        df = _residual_join(s)
    if how == "full":
        df = _full_join(s)
    df.collect()
    join = _join_node(s.last_physical_plan)
    direct = not residual and how != "full"
    assert (join.probes["direct"] > 0) == direct
    assert (join.probes["search"] > 0) != direct


def _residual_join(s):
    rng = np.random.default_rng(9)
    a = s.create_dataframe(pa.table({"k": rng.integers(0, 50, 3000),
                                     "x": rng.random(3000)}))
    b = s.create_dataframe(pa.table({"bk": rng.integers(0, 50, 200),
                                     "y": rng.random(200)}))
    return a.join(b, (a["k"] == b["bk"]) & (a["x"] > b["y"]), "inner")


def _full_join(s):
    rng = np.random.default_rng(9)
    a = s.create_dataframe(pa.table({"k": rng.integers(0, 50, 3000)}))
    b = s.create_dataframe(pa.table({"bk": rng.integers(0, 50, 200)}))
    return a.join(b, a["k"] == b["bk"], "full")


DIRECT_CASES = [("int64", "inner"), ("int64", "left"), ("int64", "right"),
                ("int64", "semi"), ("int64", "anti"), ("date", "inner"),
                ("date", "left"), ("int32", "inner")]


def _keyed_tables(kind: str, seed: int = 21):
    rng = np.random.default_rng(seed)
    left = pa.table({"k": _column(kind, rng, 3000, 0.05),
                     "x": rng.random(3000)})
    right = pa.table({"rk": _column(kind, rng, 400, 0.05),
                      "y": rng.random(400)})
    return left, right


@pytest.mark.parametrize("kind,how", DIRECT_CASES)
def test_direct_join_matches_jax(monkeypatch, kind, how):
    """Joins on integer and DATE keys with nulls and negative values,
    probed by direct address in the port (the stream limit lowered to
    the test's size), equal the JAX engine's rows and its oracle's."""
    monkeypatch.setattr(join_k, "DIRECT_MIN_STREAM", 1024)
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 1 << 20)
    left, right = _keyed_tables(kind)

    def query(s):
        a = s.create_dataframe(left, num_partitions=2)
        b = s.create_dataframe(right)
        return a.join(b, a["k"] == b["rk"], how)
    s = TpuSession(TpuConf(), device="cpu")
    df = query(s)
    got = sorted(df.collect(), key=_row_key)
    join = _join_node(s.last_physical_plan)
    assert join.probes["direct"] > 0 and join.probes["search"] == 0
    conf = {"spark.rapids.tpu.sql.adaptive.enabled": False}
    jax_rows = sorted(with_tpu_session(lambda s: query(s).collect(), conf),
                      key=_row_key)
    oracle = sorted(with_cpu_session(lambda s: query(s).collect(), conf),
                    key=_row_key)
    assert len(got) > 100
    _compare_rows(jax_rows, got, rel=DEFAULT_FLOAT_REL)
    _compare_rows(oracle, got, rel=DEFAULT_FLOAT_REL)
