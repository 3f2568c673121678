"""The TPC-DS quartet (q3, q42, q52, q96) through the PyTorch port's
``session.sql`` on the CPU, against the JAX package and its oracle.

The tables come from ``benchmarks/tpcds.generate`` and are registered
with ``tpcds.register`` on a port session, unchanged.  Scale 0.02 is the
smallest at which every query returns rows with seed 11 (0.002 gives q3
no item of manufacturer 128).  With one file per table the port equals
the JAX package and its pyarrow oracle; with store_sales in 4 part files
it equals the oracle, where the JAX package's own q42 has duplicate
groups (its ``complete`` aggregate over a broadcast join that reports
one partition).  The plans' join strategies and build sides equal the
JAX package's, and at SF10's row estimates the same rule builds q96's
middle join on the right.
"""
import os
import re
import shutil
import sys

import pyarrow.parquet as papq
import pytest

import chip_smoke
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.plan import logical as L

from tests.harness import (DEFAULT_FLOAT_REL, _compare_rows, canon_rows,
                           with_cpu_session, with_tpu_session)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

import tpcds  # noqa: E402

QUARTET = ["q3", "q42", "q52", "q96"]
SCALE, SEED = 0.02, 11
#: rows of the tables q96 joins at TPC-DS SF10
SF10_ROWS = {"store_sales": 28_800_000, "household_demographics": 72_000,
             "time_dim": 86_400, "store": 120, "date_dim": 1_825,
             "item": 180_000}


@pytest.fixture(scope="module")
def one_file(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds") / "one")
    tpcds.generate(d, scale=SCALE, seed=SEED)
    return d


@pytest.fixture(scope="module")
def part_files(one_file, tmp_path_factory):
    """The same tables with store_sales as a directory of 4 part files."""
    d = str(tmp_path_factory.mktemp("tpcds") / "parts")
    os.makedirs(d)
    for t in tpcds.TABLES:
        if t != "store_sales":
            shutil.copy(os.path.join(one_file, f"{t}.parquet"), d)
    ss = papq.read_table(os.path.join(one_file, "store_sales.parquet"))
    out = os.path.join(d, "store_sales.parquet")
    os.makedirs(out)
    step = -(-ss.num_rows // 4)
    for i in range(4):
        papq.write_table(ss.slice(i * step, step),
                         os.path.join(out, f"part-{i:05d}.parquet"))
    return d


def _port(data_dir):
    s = TpuSession(device="cpu")
    tpcds.register(s, data_dir)
    return s


def _jax(data_dir, q, engine):
    def fn(s):
        tpcds.register(s, data_dir)
        return s.sql(tpcds.QUERIES[q]).collect()
    return engine(fn)


def _check_order(q, df, rows):
    """Rows follow the query's ORDER BY (ties in any order)."""
    names = df.columns
    keys = [chip_smoke._order_key(q, names, r) for r in rows]
    assert keys == sorted(keys), f"{q}: rows out of ORDER BY order"


@pytest.mark.parametrize("q", QUARTET)
def test_quartet_one_file_matches_jax_and_oracle(one_file, q):
    df = _port(one_file).sql(tpcds.QUERIES[q])
    got = df.collect()
    assert got, f"{q}: no rows"
    _check_order(q, df, got)
    for engine in (with_tpu_session, with_cpu_session):
        want = _jax(one_file, q, engine)
        _compare_rows(canon_rows(want), canon_rows(got),
                      rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", QUARTET)
def test_quartet_part_files_match_oracle(part_files, q):
    df = _port(part_files).sql(tpcds.QUERIES[q])
    got = df.collect()
    assert got, f"{q}: no rows"
    _check_order(q, df, got)
    want = _jax(part_files, q, with_cpu_session)
    _compare_rows(canon_rows(want), canon_rows(got), rel=DEFAULT_FLOAT_REL)


def test_reference_q42_duplicates_groups_on_part_files(part_files):
    """The JAX package's fault, shown on its own: with store_sales in
    part files its q42 returns one group more than once."""
    rows = _jax(part_files, "q42", with_tpu_session)
    keys = [r[:3] for r in rows]
    assert len(keys) > len(set(keys))
    oracle = _jax(part_files, "q42", with_cpu_session)
    assert len({r[:3] for r in oracle}) == len(oracle)


_JOIN = re.compile(r"Tpu\w*HashJoin\[[^\]]*\]")


@pytest.mark.parametrize("q", QUARTET)
def test_join_strategies_match_jax(one_file, q):
    got = _JOIN.findall(_port(one_file).sql(tpcds.QUERIES[q]).explain())

    def fn(s):
        tpcds.register(s, one_file)
        return s.explain(s.sql(tpcds.QUERIES[q])._plan)
    want = _JOIN.findall(with_tpu_session(fn))
    assert got == want and got
    if q == "q96":      # the middle join builds on the left at this scale
        assert got[1] == "TpuBroadcastHashJoin[inner, build=left]"


def _nodes(node):
    yield node
    for c in node.children:
        yield from _nodes(c)


@pytest.mark.parametrize("q", QUARTET)
def test_aggregates_are_partial_exchange_final(part_files, q):
    s = _port(part_files)
    plan = s.plan(s.sql(tpcds.QUERIES[q])._plan)
    aggs = [n for n in _nodes(plan) if type(n).__name__ == "TpuHashAggregate"]
    assert [a.mode for a in aggs] == ["final", "partial"]
    final, partial = aggs
    between = type(final.children[0]).__name__
    assert between == ("TpuCoalescePartitions" if q == "q96"
                       else "TpuShuffleExchange")
    assert final.children[0].children[0] is partial
    # a broadcast join has its stream side's partitions: store_sales's 4
    # part files, except q96's, whose middle join streams time_dim here
    assert partial.num_partitions() == (1 if q == "q96" else 4)


def _scans(plan):
    if isinstance(plan, L.Scan):
        yield plan
    for c in plan.children:
        yield from _scans(c)


@pytest.mark.parametrize("q,joins", [
    ("q96", ["TpuBroadcastHashJoin[inner, build=right]"] * 3),
    ("q3", ["TpuBroadcastHashJoin[inner, build=right]",
            "TpuBroadcastHashJoin[inner, build=left]"])])
def test_sf10_estimates_plan_the_reference_rule(one_file, q, joins):
    """At SF10's row counts every quartet join is broadcast, and q96's
    middle join builds on time_dim (86,400 rows against 28.8M)."""
    s = _port(one_file)
    for view in s._views.values():
        for scan in _scans(view):
            name = os.path.basename(scan.paths[0]).split(".")[0]
            scan._rows = SF10_ROWS.get(name, scan.estimated_rows())
    assert _JOIN.findall(s.sql(tpcds.QUERIES[q]).explain()) == joins


def test_phase6_generator_matches_generate(one_file, tmp_path):
    chip_smoke.make_tpcds(str(tmp_path), SCALE, SEED)
    for t in chip_smoke.DS_TABLES:
        want = papq.read_schema(os.path.join(one_file, f"{t}.parquet"))
        got = papq.read_schema(os.path.join(str(tmp_path), f"{t}.parquet")
                               if t != "store_sales" else
                               os.path.join(str(tmp_path), f"{t}.parquet",
                                            "part-00000.parquet"))
        assert got.names == want.names, t
        assert got.types == want.types, t
    assert len(os.listdir(os.path.join(str(tmp_path),
                                       "store_sales.parquet"))) == 8
