"""DATE columns in the PyTorch port, against the JAX package, on the CPU.

A date32 Parquet column reads as the port's DATE (int32 days since
1970-01-01 on the device) and is collected back to date32.  Seeded
tables written to Parquet go through the port's ``session.sql``
(``device="cpu"``) and the JAX package's engine and its pyarrow oracle:
a scan, comparisons and BETWEEN between DATE columns, IS NULL, a join
and an ``IN (query)`` on DATE keys, group-by, distinct, max and sort
keys.  Rows agree as multisets (dates and NULLs equal, floats within
1e-9 relative), in order where the ORDER BY fixes it.

DATE key words equal the JAX package's ``canon.value_words`` (the
int32's order word), the engine's DATE literal (1970-01-01, the
null-safe keys' default) and a string ``coalesce`` evaluate row by row,
and what stays outside the slice raises ``SqlError``: a TIMESTAMP
literal, a DATE compared with a number or a string, and arithmetic on a
DATE other than plus or minus days (``tests/test_torch_datetime.py``
holds DATE literals, INTERVAL and the DATE functions).
"""
import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.kernels import canon as jcanon

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api.sql import SqlError
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.columnar.schema import Field, Schema
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.expr import conditional as econd
from spark_rapids_tpu_torch.expr import core as ec
from spark_rapids_tpu_torch.kernels import canon

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_cpu_session, with_tpu_session

torch.set_num_threads(1)

DAY0 = datetime.date(1999, 12, 20)


def _dates(rng, n, span, null_frac):
    return [None if rng.random() < null_frac else
            DAY0 + datetime.timedelta(days=int(rng.integers(0, span)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dates")
    rng = np.random.default_rng(9)
    n = 400
    ev = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "d": pa.array(_dates(rng, n, 30, 0.1), pa.date32()),
        "d2": pa.array(_dates(rng, n, 30, 0.05), pa.date32()),
        "d3": pa.array(_dates(rng, n, 40, 0.0), pa.date32()),
        "v": pa.array(rng.random(n) * 100, pa.float64()),
    })
    cal = pa.table({
        "cd": pa.array([DAY0 + datetime.timedelta(days=i)
                        for i in range(0, 40, 2)], pa.date32()),
        "name": pa.array([f"day{i % 5}" for i in range(20)], pa.string()),
        "w": pa.array(np.arange(20, dtype=np.int32) % 3, pa.int32()),
    })
    paths = {}
    for name, t in (("ev", ev), ("cal", cal)):
        paths[name] = os.path.join(str(d), f"{name}.parquet")
        papq.write_table(t, paths[name])
    return paths


def _register(session, files):
    for name, path in files.items():
        session.read.parquet(path).create_or_replace_temp_view(name)
    return session


def _port(files):
    return _register(TpuSession(TpuConf(
        {"spark.rapids.tpu.sql.batchSizeRows": 128}), device="cpu"), files)


#: (query, whether its ORDER BY fixes the row order)
QUERIES = {
    "scan": ("select id, d, d2 from ev", False),
    "less": ("select id, d from ev where d < d2", False),
    "equal": ("select id from ev where d = d2", False),
    "not_equal_ge": ("select id from ev where d <> d2 and d3 >= d", False),
    "between": ("select id, d from ev where d between d2 and d3", False),
    "is_null": ("select id, d2 from ev where d is null", False),
    "join": ("select e.id, c.name, c.cd from ev e, cal c where e.d = c.cd",
             False),
    "in_query": ("select id, d from ev where d in (select cd from cal "
                 "where w = 1)", False),
    "group": ("select d, count(*) n, sum(v) sv from ev group by d", False),
    "group_max": ("select d2, max(d) md from ev group by d2", False),
    "distinct": ("select distinct d, d2 from ev where id < 200", False),
    "sort": ("select id, d from ev order by d desc, id", True),
    "sort_nulls_first": ("select d, id from ev where id < 300 order by d, "
                         "id limit 50", True),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_date_query_matches_jax_and_oracle(files, name):
    sql, ordered = QUERIES[name]
    got = _port(files).sql(sql).collect()
    assert got, f"{name}: no rows"
    for engine in (with_tpu_session, with_cpu_session):
        want = engine(lambda s: _register(s, files).sql(sql).collect())
        if ordered:
            _compare_rows(want, got, rel=DEFAULT_FLOAT_REL)
        else:
            _compare_rows(canon_rows(want), canon_rows(got),
                          rel=DEFAULT_FLOAT_REL)


def test_date_column_reads_and_collects_as_date32(files):
    df = _port(files).sql("select d from ev")
    assert df.schema.fields[0].dtype == T.DATE
    table = df.to_arrow()
    assert table.schema.field(0).type == pa.date32()
    want = papq.read_table(files["ev"], columns=["d"])
    assert table.column(0).to_pylist() == want.column(0).to_pylist()


def test_date_batch_round_trip():
    days = [datetime.date(1970, 1, 1), None, datetime.date(1969, 12, 31),
            datetime.date(2262, 4, 11), datetime.date(1, 1, 1)]
    t = pa.table({"d": pa.array(days, pa.date32())})
    batch = from_arrow(t, "cpu")
    col = batch.columns[0]
    assert col.dtype == T.DATE and col.data.dtype == torch.int32
    assert col.data[:5].tolist()[:3] == [0, 0, -1]
    assert to_arrow(batch).equals(t)


def test_date_value_words_match_reference():
    info = np.iinfo(np.int32)
    rng = np.random.default_rng(4)
    data = np.concatenate([[info.min, -719162, -1, 0, 1, 11000, info.max],
                           rng.integers(-800_000, 3_000_000, 50)]) \
        .astype(np.int32)
    valid = np.ones(len(data), bool)
    jw = jcanon.value_words(JColumn(JT.DATE, jnp.asarray(data),
                                    jnp.asarray(valid)), len(data))
    pw = canon.value_words(Column(T.DATE, torch.from_numpy(data.copy()),
                                  torch.from_numpy(valid)))
    assert len(jw) == len(pw) == 1
    assert np.array_equal(pw[0].numpy().view(np.uint64),
                          np.asarray(jw[0]).astype(np.uint64))
    # and in date order
    order = np.argsort(pw[0].numpy().view(np.uint64), kind="stable")
    assert np.array_equal(data[order], np.sort(data, kind="stable"))


def test_bool_value_words_order_false_first():
    """The null-safe keys' IS NULL flags are BOOL key words."""
    data = np.array([True, False, True], bool)
    w = canon.value_words(Column(T.BOOL, torch.from_numpy(data),
                                 torch.ones(3, dtype=torch.bool)))
    assert w[0].tolist() == [1, 0, 1]


def test_date_literal_and_string_coalesce():
    """``coalesce(d, DATE 1970-01-01)`` and ``coalesce(s, '')`` as the
    null-safe keys evaluate them: NULL rows take the default, other rows
    keep their value, and the result has no NULL."""
    t = pa.table({"d": pa.array([DAY0, None, datetime.date(1970, 1, 1)],
                                pa.date32()),
                  "s": pa.array(["ab", None, ""], pa.string())})
    batch = from_arrow(t, "cpu")
    lit = ec.Literal(T.EPOCH)
    assert lit.dtype() == T.DATE
    d = ec.BoundReference(0, T.DATE)
    s = ec.BoundReference(1, T.STRING)
    out_d = ec.eval_as_column(econd.Coalesce(d, lit), batch)
    assert out_d.dtype == T.DATE
    assert out_d.data[:3].tolist() == [T.date_to_days(DAY0), 0, 0]
    assert out_d.validity[:3].all()
    out_s = ec.eval_as_column(econd.Coalesce(s, ec.Literal("")), batch)
    back = to_arrow(ColumnarBatch(Schema([Field("s", T.STRING)]), [out_s],
                                  3))
    assert back.column(0).to_pylist() == ["ab", "", ""]


@pytest.mark.parametrize("sql,what", [
    ("select id from ev where d = timestamp '2000-01-01 00:00:00'",
     "TIMESTAMP literals"),
    ("select id from ev where d > 5", "comparison of date"),
    ("select id from ev where d = 'x'", "comparison of date"),
    ("select id from ev where d between 1 and 2", "comparison of date"),
    ("select id from ev where d in (1, 2)", "comparison of date"),
    ("select d * 2 from ev", "date arithmetic"),
    ("select -d from ev", "date arithmetic"),
    ("select sum(d) from ev", "sum"),
    ("select d from ev union all select id from ev", "no common type")])
def test_outside_the_slice_raises(files, sql, what):
    with pytest.raises(SqlError, match=what):
        _port(files).sql(sql)
