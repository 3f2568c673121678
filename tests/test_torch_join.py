"""The port's joins against the JAX reference and its pyarrow oracle.

Both packages' ``BROADCAST_ROW_THRESHOLD`` are lowered inside each test
so that joins of a few thousand rows plan as ``TpuShuffledHashJoin``;
both packages run with ``adaptive.enabled`` off, so that they plan that
operator and not their adaptive join (``tests/test_torch_adaptive.py``
holds the adaptive one).  Inputs are made with numpy
from a seed and handed to both packages; the port runs with
``device="cpu"``.
"""
import numpy as np
import pyarrow as pa
import pytest

import chip_smoke
from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.columnar import arrow as jarrow
from spark_rapids_tpu.columnar.batch import resolve_speculative
from spark_rapids_tpu.exec.tpu_aggregate import \
    TpuHashAggregate as JHashAggregate
from spark_rapids_tpu.exec.tpu_basic import TpuLocalScan as JLocalScan
from spark_rapids_tpu.expr import aggregates as jea
from spark_rapids_tpu.expr import core as jec
from spark_rapids_tpu.plan import overrides as joverrides
from spark_rapids_tpu.plan.logical import AggExpr as JAggExpr
from spark_rapids_tpu.shuffle.partitioners import \
    HashPartitioner as JHashPartitioner

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.arrow import (from_numpy_columns,
                                                   schema_from_arrow,
                                                   to_arrow)
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.tpu_aggregate import (INT_MAX_EXACT,
                                                       PARTIAL,
                                                       TpuHashAggregate)
from spark_rapids_tpu_torch.expr import aggregates as ea
from spark_rapids_tpu_torch.expr import core as ec
from spark_rapids_tpu_torch.kernels import cuda_ops
from spark_rapids_tpu_torch.plan import overrides
from spark_rapids_tpu_torch.plan.logical import AggExpr
from spark_rapids_tpu_torch.shuffle.partitioners import HashPartitioner

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, _row_key
from tests.jax_reference import with_cpu_session, with_tpu_session

BATCH = "spark.rapids.tpu.sql.batchSizeRows"
PARTS = "spark.rapids.tpu.sql.shuffle.partitions"
CHUNK = "spark.rapids.tpu.sql.join.gather.chunkRows"
#: both packages: 400-row batches, so a few thousand rows shuffle into 4,
#: and the static planner (no AQE)
BASE = {BATCH: 400, PARTS: 4, "spark.rapids.tpu.sql.adaptive.enabled": False}
JAX_CONF = BASE
HOWS = ["inner", "left", "right", "full", "semi", "anti"]


@pytest.fixture(autouse=True)
def shuffled_joins(monkeypatch):
    """Joins of the test sizes shuffle in both packages."""
    monkeypatch.setattr(joverrides, "BROADCAST_ROW_THRESHOLD", 100)
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 100)


def join_tables(keys: str, seed: int = 5, n_left: int = 1200,
                n_right: int = 900, hot: int = 0):
    """Two seeded tables with duplicate keys on both sides.  ``keys``:
    ``int64`` (both sides int64), ``int32_int64`` (an int32 key against
    an int64 one), ``two_keys`` (a second key beside the first),
    ``null_second`` (two keys, nulls in the second).  ``hot`` rows of
    the right side (and hot // 5 of the left) share key 7."""
    rng = np.random.default_rng(seed)

    def key(n, dtype, null_frac):
        k = rng.integers(0, 150, n).astype(dtype)
        return pa.array(k, mask=rng.random(n) < null_frac)

    ldt = np.int32 if keys == "int32_int64" else np.int64
    first_nulls = 0.0 if keys == "null_second" else 0.05
    left = {"k": key(n_left, ldt, first_nulls),
            "x": rng.random(n_left), "i": np.arange(n_left, dtype=np.int32)}
    right = {"rk": key(n_right, np.int64, first_nulls),
             "y": rng.random(n_right),
             "j": np.arange(n_right, dtype=np.int64)}
    if keys in ("two_keys", "null_second"):
        second_nulls = 0.1 if keys == "null_second" else 0.0
        left["k2"] = key(n_left, np.int64, second_nulls)
        right["rk2"] = key(n_right, np.int64, second_nulls)
        left["k2"] = pa.array(np.asarray(left["k2"].fill_null(0)) % 3,
                              mask=np.asarray(left["k2"].is_null()))
        right["rk2"] = pa.array(np.asarray(right["rk2"].fill_null(0)) % 3,
                                mask=np.asarray(right["rk2"].is_null()))
    if hot:
        lk = np.asarray(left["k"].fill_null(0)).copy()
        rk = np.asarray(right["rk"].fill_null(0)).copy()
        lk[:hot // 5] = 7
        rk[:hot] = 7
        left["k"], right["rk"] = pa.array(lk), pa.array(rk)
    return pa.table(left), pa.table(right)


def join_df(session, keys: str, how: str, residual: bool = False,
            **kw):
    lt, rt = join_tables(keys, **kw)
    a = session.create_dataframe(lt, num_partitions=3)
    b = session.create_dataframe(rt, num_partitions=2)
    cond = a["k"] == b["rk"]
    if "k2" in lt.column_names:
        cond = cond & (a["k2"] == b["rk2"])
    if residual:
        cond = cond & (a["x"] > b["y"])
    return a.join(b, cond, how)


def port_session(conf=None):
    return TpuSession(TpuConf({**BASE, **(conf or {})}), device="cpu")


def rows(df):
    return sorted(df.collect(), key=_row_key)


def oracle_rows(query):
    """The pyarrow oracle's rows of ``query(session)``."""
    return sorted(with_cpu_session(lambda s: query(s).collect(), JAX_CONF),
                  key=_row_key)


def reference_rows(query):
    """(JAX engine rows, pyarrow oracle rows) of ``query(session)``."""
    jax_rows = sorted(with_tpu_session(lambda s: query(s).collect(),
                                       JAX_CONF), key=_row_key)
    return jax_rows, oracle_rows(query)


def find(node, kind: str):
    out = [node] if type(node).__name__ == kind else []
    for c in node.children:
        out.extend(find(c, kind))
    return out


@pytest.mark.parametrize("keys", ["int64", "int32_int64", "two_keys"])
@pytest.mark.parametrize("how", HOWS)
def test_join_types_match_reference(how, keys):
    jax_rows, oracle = reference_rows(lambda s: join_df(s, keys, how))
    s = port_session()
    df = join_df(s, keys, how)
    got = rows(df)
    assert f"TpuShuffledHashJoin[{how}, " in df.explain()
    assert len(got) > 50
    _compare_rows(jax_rows, got, rel=DEFAULT_FLOAT_REL)
    _compare_rows(oracle, got, rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("how", HOWS)
def test_null_in_second_key_matches_oracle(how):
    """A row whose second key is null matches nothing, whatever its first
    key.  The JAX package's device engine matches such rows in inner,
    left and anti joins: ``spark_rapids_tpu/kernels/join.py:93-97``
    checks only the first key's rank word.  The port checks every key's
    rank word and is held to the pyarrow oracle alone."""
    oracle = oracle_rows(lambda s: join_df(s, "null_second", how))
    got = rows(join_df(port_session(), "null_second", how))
    _compare_rows(oracle, got, rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
def test_residual_condition_matches_reference(how):
    def query(s):
        return join_df(s, "int64", how, residual=True)
    jax_rows, oracle = reference_rows(query)
    got = rows(query(port_session()))
    assert len(got) > 100
    _compare_rows(jax_rows, got, rel=DEFAULT_FLOAT_REL)
    _compare_rows(oracle, got, rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("how,residual", [(h, False) for h in HOWS] +
                         [("right", True), ("semi", True)])
def test_broadcast_join_types_match_oracle(monkeypatch, how, residual):
    """The broadcast join takes every join type but full, which the
    planner shuffles whatever its size."""
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 1 << 20)

    def query(s):
        return join_df(s, "two_keys", how, residual)
    df = query(port_session())
    kind = "Shuffled" if how == "full" else "Broadcast"
    assert f"Tpu{kind}HashJoin[{how}, " in df.explain()
    _compare_rows(oracle_rows(query), rows(df), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("how,residual", [
    ("inner", False), ("left", False), ("right", False), ("full", False),
    ("semi", False), ("inner", True), ("full", True), ("anti", True)])
def test_chunked_expansion_equals_whole(how, residual):
    """64-row chunks, one key matching 200 build rows per probe row: the
    rows equal the unchunked join's, in the same order."""
    def query(s):
        return join_df(s, "int64", how, residual, hot=200)
    whole_s, chunk_s = port_session(), port_session({CHUNK: 64})
    whole, chunked = query(whole_s), query(chunk_s)
    assert chunked.collect() == whole.collect()
    join = find(chunk_s.last_physical_plan, "TpuShuffledHashJoin")[0]
    if how not in ("semi", "anti") or residual:
        assert join.expand_counts["chunks"] > \
            3 * join.expand_counts["batches"]
    _compare_rows(oracle_rows(query), sorted(chunked.collect(), key=_row_key),
                  rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("on", ["k", ["k", "k2"]], ids=["one", "two"])
@pytest.mark.parametrize("how", ["inner", "left_outer", "outer",
                                 "left_semi", "leftanti", "right_outer"])
def test_join_on_names_and_aliases_match_oracle(how, on):
    """``on`` as names both sides share: the right side's key columns are
    dropped (Spark's rule); ``how`` takes the reference's aliases."""
    def query(s):
        lt, rt = join_tables("two_keys")
        rt = rt.rename_columns(["k", "y", "j",
                                "k2" if isinstance(on, list) else "rk2"])
        a = s.create_dataframe(lt, num_partitions=3)
        b = s.create_dataframe(rt, num_partitions=2)
        return a.join(b, on, how)
    jax_rows, oracle = reference_rows(query)
    df = query(port_session())
    assert df.columns == with_cpu_session(lambda s: query(s).columns)
    got = rows(df)
    _compare_rows(jax_rows, got, rel=DEFAULT_FLOAT_REL)
    _compare_rows(oracle, got, rel=DEFAULT_FLOAT_REL)


def _join_lines(text: str):
    """The join and exchange lines of a plan, indentation kept."""
    return [line.rstrip() for line in text.splitlines()
            if "Join" in line or "Exchange" in line]


@pytest.mark.parametrize("how,n_left,n_right,want", [
    ("inner", 300, 2000, "TpuBroadcastHashJoin[inner, build=left]"),
    ("inner", 2000, 300, "TpuBroadcastHashJoin[inner, build=right]"),
    ("inner", 2000, 1500, "TpuShuffledHashJoin[inner, build=right]"),
    ("inner", 1500, 2000, "TpuShuffledHashJoin[inner, build=left]"),
    ("left", 2000, 300, "TpuBroadcastHashJoin[left, build=right]"),
    ("left", 300, 2000, "TpuShuffledHashJoin[left, build=right]"),
    ("right", 300, 2000, "TpuBroadcastHashJoin[right, build=left]"),
    ("right", 2000, 300, "TpuShuffledHashJoin[right, build=left]"),
    ("full", 2000, 300, "TpuShuffledHashJoin[full, build=right]"),
    ("full", 200, 300, "TpuShuffledHashJoin[full, build=right]"),
    ("semi", 2000, 300, "TpuBroadcastHashJoin[semi, build=right]"),
    ("anti", 300, 2000, "TpuShuffledHashJoin[anti, build=right]"),
])
def test_join_strategy_matches_reference(monkeypatch, how, n_left, n_right,
                                         want):
    """Broadcast a build side of at most the threshold's estimated rows,
    never a full join; shuffle both sides otherwise.  The same choice and
    exchange widths as the reference's ``_plan_join``."""
    monkeypatch.setattr(joverrides, "BROADCAST_ROW_THRESHOLD", 500)
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 500)

    def query(s):
        lt, rt = join_tables("int64", n_left=n_left, n_right=n_right)
        a = s.create_dataframe(lt, num_partitions=2)
        b = s.create_dataframe(rt, num_partitions=2)
        return a.join(b, a["k"] == b["rk"], how)
    ref = with_tpu_session(lambda s: s.explain(query(s)._plan), JAX_CONF)
    got = query(port_session()).explain()
    assert want in got
    assert _join_lines(got) == _join_lines(ref)


@pytest.mark.parametrize("how", ["cross", "inner"])
def test_joins_without_keys_raise(how):
    """The two joins without keys that the port once refused (a cross
    join, and an inner join on ``x > y`` alone) plan a
    ``TpuNestedLoopJoin`` and equal the JAX package's engine and oracle."""
    def query(s):
        lt, rt = join_tables("int64", n_left=150, n_right=110)
        a, b = s.create_dataframe(lt, num_partitions=2), \
            s.create_dataframe(rt, num_partitions=2)
        return a.join(b, how="cross") if how == "cross" else \
            a.join(b, a["x"] > b["y"], how)
    jax_rows, oracle = reference_rows(query)
    df = query(port_session())
    got = rows(df)
    assert f"TpuNestedLoopJoin[{how}]" in df.explain()
    assert len(got) > 1000
    _compare_rows(jax_rows, got, rel=DEFAULT_FLOAT_REL)
    _compare_rows(oracle, got, rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("num_parts", [1, 7, 8, 4096])
def test_two_key_partition_ids_with_nulls_match_reference(num_parts):
    """The exchange's ids on an int32 and an int64 key with nulls equal
    the reference's hash_words + hash_to_partition bit for bit; the
    split's per-partition counts follow them."""
    rng = np.random.default_rng(num_parts)
    n = 3000
    table = pa.table({
        "a": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.2),
        "b": pa.array(rng.integers(-(1 << 62), 1 << 62, n),
                      mask=rng.random(n) < 0.2),
        "v": rng.random(n)})
    jbatch = jarrow.from_arrow(table)
    jkeys = [jec.AttributeReference("a", jbatch.schema["a"].dtype),
             jec.AttributeReference("b", jbatch.schema["b"].dtype)]
    want = np.asarray(JHashPartitioner(jkeys, num_parts)
                      .partition_ids(jbatch))[:n]
    schema = schema_from_arrow(table.schema)
    batch = from_numpy_columns(
        [np.asarray(c.data) for c in jbatch.columns],
        [np.asarray(c.validity) for c in jbatch.columns], schema, "cpu",
        num_rows=n)
    part = HashPartitioner([ec.AttributeReference("a", T.INT32),
                            ec.AttributeReference("b", T.INT64)], num_parts)
    got = cuda_ops.hash_partition_ids(part._key_words(batch), num_parts)
    assert np.array_equal(got.numpy()[:n], want)
    split = part.split(batch)
    assert np.array_equal(np.diff(split.offsets),
                          np.bincount(want, minlength=num_parts))


@pytest.fixture(scope="module")
def tpch_small():
    tables = chip_smoke.make_tpch(0.002, 3)
    return tables, chip_smoke.join_references(tables)


@pytest.mark.parametrize("q", list(chip_smoke.JOIN_QUERIES))
def test_chip_smoke_join_queries_match_oracle(tpch_small, q):
    """Phase 5's query text at SF 0.002, planned and run as at SF10
    (adaptive joins built on the same sides, which run shuffled or, with
    a build of at most the shrunk broadcast bytes, broadcast, never a
    full join; 4096-row batches keep the probes few): the port, the
    pyarrow oracle and the phase's own numpy reference agree."""
    how, side = chip_smoke.JOIN_QUERIES[q]
    tables, refs = tpch_small
    oracle = sorted(with_cpu_session(lambda s: chip_smoke.join_query(
        JF, chip_smoke.join_frames(s, tables), q).collect()),
        key=_row_key)
    s = TpuSession(TpuConf({
        BATCH: 4096, "spark.rapids.tpu.sql.adaptive.autoBroadcastJoinBytes":
        chip_smoke.join_broadcast_bytes(0.002)}), device="cpu")
    df = chip_smoke.join_query(PF, chip_smoke.join_frames(s, tables), q)
    assert chip_smoke._adaptive(how, side) in df.explain()
    table = df.to_arrow()
    assert "strategy=shuffled" in df.explain() or (
        how != "full" and "strategy=broadcast" in df.explain())
    _compare_rows(oracle, sorted(df.collect(), key=_row_key),
                  rel=DEFAULT_FLOAT_REL)
    chip_smoke.compare_groups(chip_smoke.table_groups(table), refs[q],
                              DEFAULT_FLOAT_REL, q)
    assert len(refs[q]) >= 5


def _int_max_table(case: str, n: int = 4000) -> pa.Table:
    rng = np.random.default_rng(11)
    q = rng.integers(-(1 << 40), 1 << 40, n)
    if case == "beyond":
        q[17] = INT_MAX_EXACT + 1        # past the exact window: sort path
    return pa.table({"k": pa.array(rng.integers(0, 60, n),
                                   mask=rng.random(n) < 0.02),
                     "q": pa.array(q, mask=rng.random(n) < 0.05),
                     "p": rng.integers(-5, 5, n).astype(np.int32)})


@pytest.mark.parametrize("case", ["fits", "beyond"])
def test_integer_max_on_table_path_matches_reference(case):
    """max of int64 and int32 columns in the table core (one f64 order
    word per row), against the reference's partial aggregate; a value
    beyond 2^48 sends the batch to the sort path."""
    table = _int_max_table(case)
    jbatch = jarrow.from_arrow(table)
    k, q, p = (jec.AttributeReference(c, jbatch.schema[c].dtype)
               for c in ("k", "q", "p"))
    jaggs = [JAggExpr(jea.Max(q), "mq"), JAggExpr(jea.Max(p), "mp"),
             JAggExpr(jea.Count(), "c")]
    jagg = JHashAggregate([k], jaggs, JLocalScan(table), mode="partial")
    prev = getattr(jconfig._ACTIVE_TLS, "conf", None)
    jconfig.set_active(jconfig.TpuConf({}), thread_only=True)
    try:
        jrows = sorted(jarrow.to_arrow(resolve_speculative(
            jagg._aggregate_batch(jbatch))).to_pylist(),
            key=lambda r: _row_key(tuple(r.values())))
    finally:
        jconfig._ACTIVE_TLS.conf = prev
    schema = schema_from_arrow(table.schema)
    pbatch = from_numpy_columns(
        [np.asarray(c.data) for c in jbatch.columns],
        [np.asarray(c.validity) for c in jbatch.columns], schema, "cpu",
        num_rows=jbatch.num_rows)
    paggs = [AggExpr(ea.Max(ec.AttributeReference("q", T.INT64)), "mq"),
             AggExpr(ea.Max(ec.AttributeReference("p", T.INT32)), "mp"),
             AggExpr(ea.Count(), "c")]
    pagg = TpuHashAggregate([ec.AttributeReference("k", T.INT64)], paggs,
                            None, PARTIAL, 4096, False)
    pout = to_arrow(pagg._aggregate(pbatch, update=True))
    assert pagg.path_counts == ({"table": 1, "sort": 0} if case == "fits"
                                else {"table": 0, "sort": 1})
    assert pout.schema.types[1:3] == [pa.int64(), pa.int32()]
    prows = sorted(pout.to_pylist(),
                   key=lambda r: _row_key(tuple(r.values())))
    _compare_rows([tuple(r.values()) for r in jrows],
                  [tuple(r.values()) for r in prows], rel=DEFAULT_FLOAT_REL)


def test_chunk_rows_is_the_fifth_conf_key():
    assert TpuConf({CHUNK: 64}).get(CHUNK) == 64
    assert TpuConf().get(CHUNK) == 1 << 22
    with pytest.raises(ValueError, match="at least 1"):
        TpuConf({CHUNK: 0})
    with pytest.raises(KeyError):
        TpuConf({"spark.rapids.tpu.sql.join.gather.targetRows": 1})


def test_empty_sides():
    """An empty build side or an empty stream side gives the rows each
    join type keeps without a match."""
    s = port_session()
    lt, rt = join_tables("int64")
    a = s.create_dataframe(lt, num_partitions=2)
    none = s.create_dataframe(rt.slice(0, 0), num_partitions=1)
    n = lt.num_rows
    counts = {how: len(a.join(none, a["k"] == none["rk"], how).collect())
              for how in HOWS}
    assert counts == {"inner": 0, "left": n, "right": 0, "full": n,
                      "semi": 0, "anti": n}
    counts = {how: len(none.join(a, none["rk"] == a["k"], how).collect())
              for how in HOWS}
    assert counts == {"inner": 0, "left": 0, "right": n, "full": n,
                      "semi": 0, "anti": 0}


def test_join_runs_are_byte_identical():
    """Duplicate build keys keep their order: two runs of a full join
    give the same bytes."""
    df = join_df(port_session(), "two_keys", "full")
    assert chip_smoke.same_bytes(df.to_arrow(), df.to_arrow())
