"""The port's out-of-core sort and spilled shuffle against the JAX
package, and the lazy partition contract.

Both engines sort one Parquet file of a few thousand rows in batches of
512 rows with ``sort.outOfCore.chunkRows`` 600, so that each sorted run
is one batch and the partition merges out of core in range chunks; each
engine's device budget is forced to 16 KiB (as the JAX package's
``tests/test_sort_ooc.py`` does), so every run spills while the input
streams in and the merge reads slices of spilled runs.  A shuffled join
whose blocks all spill must give the JAX engine's rows.  Inputs are made
with numpy from a seed; the port runs with ``device="cpu"``.
"""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu.memory.catalog import BufferCatalog as JBufferCatalog
from spark_rapids_tpu.plan import overrides as joverrides

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.tpu_sort import TpuSort
from spark_rapids_tpu_torch.memory.arena import DeviceManager
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
from spark_rapids_tpu_torch.plan import overrides

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, _row_key
from tests.jax_reference import with_tpu_session
from tests.test_torch_join import JAX_CONF, join_df, port_session, rows

CHUNK = 600
BATCH = 512
LIMIT = 1 << 14
OOC = {"spark.rapids.tpu.sql.sort.outOfCore.chunkRows": CHUNK,
       "spark.rapids.tpu.sql.batchSizeRows": BATCH}
JAX_OOC = {**OOC, "spark.rapids.tpu.sql.reader.batchSizeRows": BATCH}

#: ascending and descending keys, NULLS FIRST and LAST, a STRING key,
#: few distinct values (duplicates), and ``i`` to fix the order of ties
QUERIES = {
    "asc_nulls_last_string_desc":
        "select k, s, x, i from t order by k asc nulls last, "
        "s desc nulls first, i",
    "string_asc_int_desc":
        "select s, k, i from t order by s, k desc nulls last, i desc",
}


@pytest.fixture(autouse=True)
def default_budget():
    """The tests shrink the process's catalog limits: restore them."""
    yield
    DeviceManager.initialize(TpuConf(), "cpu")


@pytest.fixture(scope="module")
def table_file(tmp_path_factory):
    rng = np.random.default_rng(17)
    n = 4000
    k = rng.integers(-20, 20, n)
    words = ["", "a", "ab", "b", "ba", "zz", "é", "naïve", "x" * 19]
    t = pa.table({
        "k": pa.array(k, pa.int64(), mask=rng.random(n) < 0.07),
        "s": pa.array([words[int(v)] for v in rng.integers(0, 9, n)],
                      pa.string(), mask=rng.random(n) < 0.05),
        "x": rng.random(n),
        "i": np.arange(n, dtype=np.int64),
    })
    path = os.path.join(str(tmp_path_factory.mktemp("ooc")), "t.parquet")
    papq.write_table(t, path)
    return path


def _port_session(path, tmp_path, conf=None):
    s = TpuSession(TpuConf({
        **OOC, "spark.rapids.tpu.memory.spill.dir": str(tmp_path / "spill"),
        **(conf or {})}), device="cpu")
    s.read.parquet(path).create_or_replace_temp_view("t")
    return s


def _jax_rows(path, sql):
    def run(s):
        cat = JBufferCatalog.get()
        old = cat.device_limit
        cat.device_limit = LIMIT
        try:
            s.read.parquet(path).create_or_replace_temp_view("t")
            return s.sql(sql).collect()
        finally:
            cat.device_limit = old
    return with_tpu_session(run, JAX_OOC)


def _sort_node(session):
    node = session.last_physical_plan
    while not isinstance(node, TpuSort):
        node = node.children[0]
    return node


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_ooc_sort_matches_jax(table_file, tmp_path, name):
    sql = QUERIES[name]
    s = _port_session(table_file, tmp_path)
    BufferCatalog.get().device_limit = LIMIT
    got = s.sql(sql).collect()
    assert _sort_node(s).ooc_counts["chunks"] > 4
    mem = s.last_query_memory
    assert mem["spilled_device_to_host"] > 0 and mem["unspills"] > 0
    assert BufferCatalog.get().stats()["num_buffers"] == 0
    # the same rows in one piece, at the default budget and chunk size
    whole = _port_session(table_file, tmp_path, {
        "spark.rapids.tpu.sql.sort.outOfCore.chunkRows": 1 << 22})
    assert whole.sql(sql).collect() == got
    assert _sort_node(whole).ooc_counts["chunks"] == 0
    _compare_rows(_jax_rows(table_file, sql), got, rel=DEFAULT_FLOAT_REL)


def test_duplicate_keys_still_split_into_chunks(tmp_path):
    """All-equal keys split at (run, position): the chunks are bounded
    and the rows keep their input order (a stable sort)."""
    n = 3000
    t = pa.table({"k": np.full(n, 5, np.int64),
                  "i": np.arange(n, dtype=np.int64)})
    s = TpuSession(TpuConf({**OOC, "spark.rapids.tpu.memory.spill.dir":
                            str(tmp_path / "spill")}), device="cpu")
    BufferCatalog.get().device_limit = LIMIT
    BufferCatalog.get().host_limit = LIMIT      # the disk tier too
    got = s.create_dataframe(t).order_by("k").to_arrow()
    sort = _sort_node(s)
    assert sort.ooc_counts["chunks"] >= n // CHUNK
    assert got.column("i").to_pylist() == list(range(n))
    assert s.last_query_memory["spilled_host_to_disk"] > 0
    assert os.listdir(tmp_path / "spill") == []


def test_spilled_shuffled_join_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(joverrides, "BROADCAST_ROW_THRESHOLD", 100)
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 100)
    want = sorted(with_tpu_session(
        lambda s: join_df(s, "int64", "left").collect(), JAX_CONF),
        key=_row_key)
    s = port_session({"spark.rapids.tpu.memory.spill.dir":
                      str(tmp_path / "spill")})
    cat = BufferCatalog.get()
    cat.device_limit = 1                   # every block spills
    cat.host_limit = 1                     # and goes on to disk
    df = join_df(s, "int64", "left")
    got = rows(df)
    assert "TpuShuffledHashJoin[left, " in df.explain()
    mem = s.last_query_memory
    assert mem["spilled_host_to_disk"] > 0 and mem["unspills"] > 0
    assert cat.stats()["num_buffers"] == 0
    _compare_rows(want, got, rel=DEFAULT_FLOAT_REL)


def test_execute_returns_lazy_iterators(tmp_path):
    """One iterator per partition, nothing made before it is read; a
    partition read in part leaves nothing in the catalog once the plan
    is closed.  (With AQE on, the default, the aggregate's coalescing
    read writes the map side when it is executed, to group partitions by
    their bytes: the reference's stage barrier.)"""
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 100,
                            "spark.rapids.tpu.sql.shuffle.partitions": 4,
                            "spark.rapids.tpu.sql.adaptive.enabled":
                            False}), device="cpu")
    t = pa.table({"g": np.arange(1000) % 50, "v": np.arange(1000)})
    df = s.create_dataframe(t, num_partitions=3).group_by("g").agg(
        F.sum("v"))
    plan = s.plan(df._plan)
    parts = plan.execute()
    assert isinstance(parts, list) and len(parts) == plan.num_partitions()
    assert all(iter(p) is p for p in parts)
    cat = BufferCatalog.get()
    assert cat.stats()["num_buffers"] == 0          # no map side yet
    assert next(parts[0]).num_rows > 0
    assert cat.stats()["num_buffers"] > 0   # the other partitions' blocks
    plan.close()
    assert cat.stats()["num_buffers"] == 0
    # AQE on: the map side is in the catalog once the plan is executed,
    # and its groups (at most the exchange's width) are the partitions
    on = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 100,
                             "spark.rapids.tpu.sql.shuffle.partitions": 4}),
                    device="cpu")
    df = on.create_dataframe(t, num_partitions=3).group_by("g").agg(
        F.sum("v"))
    plan = on.plan(df._plan)
    parts = plan.execute()
    cat = BufferCatalog.get()               # the new session's catalog
    assert 1 <= len(parts) <= plan.num_partitions()
    assert all(iter(p) is p for p in parts)
    assert cat.stats()["num_buffers"] > 0
    assert next(parts[0]).num_rows > 0
    plan.close()
    assert cat.stats()["num_buffers"] == 0
