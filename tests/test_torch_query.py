"""The port's operators and the headline query against the JAX reference.

The headline query is ``bench.build_df``'s text, run through the JAX
package (its device engine on the CPU, and its pyarrow oracle) and
through the port with ``device="cpu"``, on the same seeded data.
"""
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.columnar import arrow as jarrow
from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.columnar.batch import resolve_speculative
from spark_rapids_tpu.exec.tpu_aggregate import \
    TpuHashAggregate as JHashAggregate
from spark_rapids_tpu.exec.tpu_basic import TpuLocalScan as JLocalScan
from spark_rapids_tpu.expr import aggregates as jea
from spark_rapids_tpu.expr import core as jec
from spark_rapids_tpu.plan.logical import AggExpr as JAggExpr

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.arrow import (from_numpy_columns,
                                                   schema_from_arrow,
                                                   to_arrow)
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.tpu_aggregate import (PARTIAL,
                                                       TpuHashAggregate)
from spark_rapids_tpu_torch.expr import aggregates as ea
from spark_rapids_tpu_torch.expr import core as ec
from spark_rapids_tpu_torch.plan.logical import AggExpr

from tests.harness import (DEFAULT_FLOAT_REL, FAST_FLOAT_REL, _compare_rows,
                           _row_key, with_cpu_session, with_tpu_session)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VFA = "spark.rapids.tpu.sql.variableFloatAgg.enabled"


def headline(F, session, n_rows=5000, num_partitions=4, seed=7):
    """bench.build_df's query text, with the functions module of either
    package."""
    rng = np.random.default_rng(seed)
    data = {
        "k": rng.integers(0, 1000, n_rows).astype(np.int64),
        "a": rng.integers(-100_000, 100_000, n_rows).astype(np.int64),
        "x": rng.random(n_rows),
        "y": rng.random(n_rows),
    }
    df = session.create_dataframe(data, num_partitions=num_partitions)
    dim = session.create_dataframe({
        "dk": np.arange(1000, dtype=np.int64),
        "w": rng.random(1000),
    }, num_partitions=1)
    agg = (df.filter((F.col("x") > 0.1) & (F.col("a") % 7 != 0))
             .with_column("z", F.col("x") * F.col("y") + F.col("a"))
             .group_by("k")
             .agg(F.sum("z").alias("sz"), F.count().alias("c"),
                  F.max("x").alias("mx")))
    joined = (agg.join(dim, agg["k"] == dim["dk"], "inner")
                 .select(F.col("k"), F.col("sz"), F.col("c"),
                         (F.col("mx") * F.col("w")).alias("mw")))
    return joined


def _port_rows(conf, **kw):
    s = TpuSession(TpuConf(conf), device="cpu")
    return sorted(headline(PF, s, **kw).collect(), key=_row_key), s


@pytest.mark.parametrize("variable", [False, True],
                         ids=["exact", "variable"])
def test_headline_query_matches_reference(variable):
    conf = {VFA: variable}
    rel = FAST_FLOAT_REL if variable else DEFAULT_FLOAT_REL
    jax_rows = sorted(with_tpu_session(
        lambda s: headline(JF, s).collect(), conf), key=_row_key)
    oracle_rows = sorted(with_cpu_session(
        lambda s: headline(JF, s).collect(), conf), key=_row_key)
    port_rows, session = _port_rows(conf)
    assert len(port_rows) > 900
    _compare_rows(jax_rows, port_rows, rel=rel)
    _compare_rows(oracle_rows, port_rows, rel=rel)
    assert _path_counts(session.last_physical_plan) == [
        {"table": 4, "sort": 0}, {"table": 8, "sort": 0}]
    plan = session.last_physical_plan.tree_string()
    for node in ("TpuLocalScan", "TpuHashAggregate[partial, staged=2 ops]",
                 "TpuShuffleExchange[HashPartitioner(8)]",
                 "TpuHashAggregate[final]", "TpuBroadcastHashJoin",
                 "TpuBroadcastExchange", "TpuProject"):
        assert node in plan


def _path_counts(node):
    """path_counts of every hash aggregate below ``node``, leaves first."""
    out = [c for child in node.children for c in _path_counts(child)]
    if isinstance(node, TpuHashAggregate):
        out.append(node.path_counts)
    return out


@pytest.mark.parametrize("conf", [
    {"spark.rapids.tpu.sql.batchSizeRows": 700,
     "spark.rapids.tpu.sql.shuffle.partitions": 3},
    {"spark.rapids.tpu.sql.agg.tableSize": 256},
], ids=["small_batches", "small_table"])
def test_headline_query_other_confs_match_oracle(conf):
    oracle_rows = sorted(with_cpu_session(
        lambda s: headline(JF, s, n_rows=3000).collect()), key=_row_key)
    port_rows, _ = _port_rows(conf, n_rows=3000)
    _compare_rows(oracle_rows, port_rows, rel=DEFAULT_FLOAT_REL)


def _filter_project(F, s):
    df = headline_inputs(s)[0]
    return df.filter(F.col("x") > 0.5).select(
        F.col("k"), (F.col("x") * F.col("y") + F.col("a")).alias("p"))


def _join_build_left(F, s):
    df, dim = headline_inputs(s)
    agg = df.group_by("k").agg(F.count().alias("c"))
    small = dim.filter(F.col("w") > 0.5)
    return small.join(agg, small["dk"] == agg["k"], "inner") \
        .select(F.col("dk"), F.col("w"), F.col("c"))


def headline_inputs(session, n_rows=3000, seed=7):
    rng = np.random.default_rng(seed)
    data = {"k": rng.integers(0, 1000, n_rows).astype(np.int64),
            "a": rng.integers(-100_000, 100_000, n_rows).astype(np.int64),
            "x": rng.random(n_rows), "y": rng.random(n_rows)}
    dim = {"dk": np.arange(1000, dtype=np.int64), "w": rng.random(1000)}
    return (session.create_dataframe(data, num_partitions=3),
            session.create_dataframe(dim, num_partitions=1))


@pytest.mark.parametrize("query", [_filter_project, _join_build_left],
                         ids=["filter_project", "join_build_left"])
def test_other_operators_match_oracle(query):
    oracle_rows = sorted(with_cpu_session(lambda s: query(JF, s).collect()),
                         key=_row_key)
    s = TpuSession(TpuConf(), device="cpu")
    port_rows = sorted(query(PF, s).collect(), key=_row_key)
    assert len(port_rows) > 100
    _compare_rows(oracle_rows, port_rows, rel=DEFAULT_FLOAT_REL)


def test_exact_mode_runs_are_byte_identical():
    s = TpuSession(TpuConf(), device="cpu")
    df = headline(PF, s, n_rows=3000)
    first, second = df.to_arrow(), df.to_arrow()
    assert first.equals(second)
    for a, b in zip(first.columns, second.columns):
        assert a.combine_chunks().buffers()[1] == \
            b.combine_chunks().buffers()[1]


def _agg_table(case: str, n: int = 5000) -> pa.Table:
    rng = np.random.default_rng(21)
    hi = {"fits": 300, "misfit": 10**9, "specials": 300, "f32_ovf": 300}[case]
    x = rng.standard_normal(n) * 1e3
    x[rng.random(n) < 0.01] = np.nan
    if case in ("specials", "f32_ovf"):
        # +-inf, -0.0 and a subnormal in the table core's exact sum/max
        pick = rng.random(n) < 0.02
        x[pick] = rng.choice(np.array([np.inf, -np.inf, -0.0, 1e-310]),
                             int(pick.sum()))
    if case == "f32_ovf":
        x[11] = 1e300            # beyond f32: the batch takes the sort path
    x_null = rng.random(n) < 0.05
    x_null[11] &= case != "f32_ovf"
    k_null = rng.random(n) < 0.02
    return pa.table({
        "k": pa.array(rng.integers(-hi, hi, n), mask=k_null),
        "x": pa.array(x, mask=x_null),
    })


@pytest.mark.parametrize("case", ["fits", "misfit", "specials", "f32_ovf"])
def test_partial_aggregate_matches_reference(case):
    """One batch through the reference's partial aggregate and the
    port's: the table core when the keys fit, the sort path when not."""
    table = _agg_table(case)
    jbatch = jarrow.from_arrow(table)
    k, x = (jec.AttributeReference(n, JT.INT64 if n == "k" else JT.FLOAT64)
            for n in ("k", "x"))
    jaggs = [JAggExpr(jea.Sum(x), "sx"), JAggExpr(jea.Count(), "c"),
             JAggExpr(jea.Count(x), "cx"), JAggExpr(jea.Max(x), "mx")]
    jagg = JHashAggregate([k], jaggs, JLocalScan(table), mode="partial")
    prev = getattr(jconfig._ACTIVE_TLS, "conf", None)
    jconfig.set_active(jconfig.TpuConf({}), thread_only=True)
    try:
        jout = resolve_speculative(jagg._aggregate_batch(jbatch))
        jrows = sorted(jarrow.to_arrow(jout).to_pylist(),
                       key=lambda r: _row_key(tuple(r.values())))
    finally:
        jconfig._ACTIVE_TLS.conf = prev

    schema = schema_from_arrow(table.schema)
    pbatch = from_numpy_columns(
        [np.asarray(c.data) for c in jbatch.columns],
        [np.asarray(c.validity) for c in jbatch.columns], schema, "cpu",
        num_rows=jbatch.num_rows)
    pk = ec.AttributeReference("k", T.INT64)
    px = ec.AttributeReference("x", T.FLOAT64)
    paggs = [AggExpr(ea.Sum(px), "sx"), AggExpr(ea.Count(), "c"),
             AggExpr(ea.Count(px), "cx"), AggExpr(ea.Max(px), "mx")]
    pagg = TpuHashAggregate([pk], paggs, None, PARTIAL, 4096, False)
    pout = pagg._aggregate(pbatch, update=True)
    on_table = case in ("fits", "specials")
    assert pagg.path_counts == ({"table": 1, "sort": 0} if on_table
                                else {"table": 0, "sort": 1})
    prows = sorted(to_arrow(pout).to_pylist(),
                   key=lambda r: _row_key(tuple(r.values())))
    assert to_arrow(pout).schema.names == jarrow.to_arrow(jout).schema.names
    _compare_rows([tuple(r.values()) for r in jrows],
                  [tuple(r.values()) for r in prows], rel=DEFAULT_FLOAT_REL)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['spark_rapids_tpu'] = None\n"
        "import importlib, pkgutil, spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from spark_rapids_tpu_torch.api import TpuSession\n"
        "s = TpuSession(device='cpu')\n"
        "df = chip_smoke.build_df(s, *chip_smoke.make_data(2000, 7), 2)\n"
        "assert len(df.collect()) > 500\n"
        "assert not [m for m, mod in sys.modules.items() if mod is not None\n"
        "            and m.split('.')[0] in ('jax', 'spark_rapids_tpu')]\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession()
    with pytest.raises(KeyError):
        TpuConf({"spark.rapids.tpu.sql.enabled": True})
