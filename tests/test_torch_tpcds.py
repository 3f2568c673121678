"""TPC-DS query text through the PyTorch port's ``session.sql`` on the
CPU, against the JAX package, its oracle and pyarrow: the quartet (q3,
q42, q52, q96), the 21 flat queries of ``chip_smoke`` phase 7, the 15
with derived tables or CTEs of its phase 8 and the 12 with expression
subqueries of its phase 9.

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

The 21 flat queries (``chip_smoke.DS7_QUERIES``) run on ``generate``'s
files at the same scale and seed, and on phase 7's files (returns drawn
from sales, ``chip_smoke.make_tpcds7``) at scale 0.1, where q17, q25,
q29 and q50 return rows; q85 returns rows on phase 7's web tables at
scale 5.  Each equals the JAX package's engine and oracle, and
``chip_smoke.ds7_references`` (pyarrow).  q13, q48 and q85 are held to
pyarrow alone: the JAX package factors ``ca_state IN (...)`` lists of
different values out of their ORs as one conjunct (ROADMAP C, fault 4),
which ``test_reference_factors_distinct_in_lists`` shows.

The 15 queries of phase 8 (``chip_smoke.DS8_QUERIES``) run the same two
ways: on ``generate``'s files at scale 0.02 against the JAX package's
engine, its oracle and ``chip_smoke.ds8_references`` (q34, q39 and q64
return no rows there), and on phase 7's files at scale 0.1, where every
one returns rows, against the oracle and the references; at SF10's row
estimates each plans DS8_PLANS' operators.

The 12 queries of phase 9 (``chip_smoke.DS9_QUERIES``: scalar, IN,
EXISTS and correlated scalar subqueries) run the same ways against
``chip_smoke.ds9_references``: on ``generate``'s files at scale 0.02
against the JAX package's engine and oracle (q24 and q58 return no rows
there), and on phase 7's files at scale 0.1 against the oracle, where
every query but q24 and q58 returns rows; at SF10's row estimates each
plans DS9_PLANS' operators.

The 15 queries of phase 10 (``chip_smoke.DS10_QUERIES``: UNION ALL,
INTERSECT and EXCEPT, SELECT DISTINCT, DATE keys) run the same ways
against ``chip_smoke.ds10_references``; q76 and q83 return no rows on
either file set and q23 one NULL sum, so each also runs on generate's
tables changed to give it rows (NULL foreign keys for q76, store_sales
written five times for q23, returns moved into q83's week), against the
JAX package's engine, its oracle and the references.

The 10 queries of phase 11 (``chip_smoke.DS11_QUERIES``: window
functions over aggregates, ranks over a HAVING, q51's running totals
over a full outer join) run the same ways against
``chip_smoke.ds11_references``: on ``generate``'s files at scale 0.02
against the JAX package's engine and oracle, and on phase 7's files at
0.1 against the oracle; at SF10's row estimates each plans DS11_PLANS'
operators (every window over a hash exchange on its PARTITION BY keys,
or a coalesce).  q44 returns no rows on either file set (its scalar
subquery reads NULL ``ss_hdemo_sk``, which neither generator draws), so
it also runs on generate's tables with 5% of ``ss_hdemo_sk`` NULL.

The 18 queries of phase 12 (``chip_smoke.DS12_QUERIES``: CAST, DATE
literals with INTERVAL, count(DISTINCT), ROLLUP with ``grouping()``)
run the same ways against ``chip_smoke.ds12_references``: on
``generate``'s files at scale 0.02 against the JAX package's engine and
oracle, and on phase 7's files at 0.1 against the oracle (and q49, which
has no rows on generate's files, against the engine too: its returns
match no sale there); at SF10's row estimates each plans DS12_PLANS'
operators, a ``TpuExpand`` under each ROLLUP's partial aggregate and
two stacked aggregates for each count(DISTINCT).
"""
import datetime
import functools
import os
import re
import shutil
import sys

import numpy as np
import pyarrow as pa
import pyarrow.compute  # noqa: F401
import pyarrow.parquet as papq
import pytest
import torch

import chip_smoke
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.plan import logical as L

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows, canon_rows
from tests.jax_reference import with_cpu_session, with_tpu_session

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

import tpcds  # noqa: E402

# the port's CPU runs here are many small torch ops: one intra-op thread
# per test process, so parallel test workers do not oversubscribe the
# cores with spinning thread pools
torch.set_num_threads(1)

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


@functools.lru_cache(maxsize=None)
def _jax(data_dir, q, engine):
    """The JAX package's rows of ``q`` (run once per worker, directory,
    query and engine: several tests read them)."""
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
    between = final.children[0]
    if q != "q96":      # AQE's coalescing read over the exchange
        assert type(between).__name__ == "TpuAQEShuffleRead"
        between = between.children[0]
    assert type(between).__name__ == ("TpuCoalescePartitions" if q == "q96"
                                      else "TpuShuffleExchange")
    assert between.children[0] is partial
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


#: queries whose OR arms hold IN lists the JAX package factors as one
#: (its fault 4): held to pyarrow alone
IN_FAULT = {"q13", "q48", "q85"}


def _views(session, data_dir):
    """Temp views of every table under ``data_dir``."""
    for t in tpcds.TABLES:
        path = os.path.join(data_dir, f"{t}.parquet")
        if os.path.exists(path):
            session.read.parquet(path).create_or_replace_temp_view(t)
    return session


@functools.lru_cache(maxsize=None)
def _jax_on(data_dir, q, engine):
    return engine(lambda s: _views(s, data_dir).sql(
        tpcds.QUERIES[q]).collect())


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    """Phase 7's files: returns drawn from sales, at scale 0.1."""
    d = str(tmp_path_factory.mktemp("tpcds7"))
    chip_smoke.make_tpcds(d, 0.1, SEED)
    chip_smoke.make_tpcds7(d, 0.1, SEED)
    return d


def _check_flat(data_dir, q, refs):
    df = _views(TpuSession(device="cpu"), data_dir).sql(tpcds.QUERIES[q])
    table = df.to_arrow()
    chip_smoke.check_ds7_rows(q, table, refs)
    return [tuple(r.values()) for r in table.to_pylist()]


@pytest.mark.parametrize("q", chip_smoke.DS7_QUERIES)
def test_flat_query_matches_jax_oracle_and_pyarrow(one_file, q):
    got = _check_flat(one_file, q,
                      chip_smoke.ds7_references(one_file, [q])[q])
    if q in IN_FAULT:
        return
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(_jax_on(one_file, q, engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


#: queries that return rows on phase 7's files at scale 0.1
DRAWN_ROWS = {"q17", "q25", "q29", "q50", "q7", "q15", "q21", "q40", "q84"}


@pytest.mark.parametrize("q", chip_smoke.DS7_QUERIES)
def test_flat_query_on_drawn_returns_matches_oracle(drawn, q):
    got = _check_flat(drawn, q, chip_smoke.ds7_references(drawn, [q])[q])
    if q in DRAWN_ROWS:
        assert got, f"{q}: no rows"
    if q not in IN_FAULT:
        _compare_rows(canon_rows(_jax_on(drawn, q, with_cpu_session)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


def test_q85_returns_rows_on_drawn_web_tables(tmp_path):
    """q85 needs about 10 rows' worth of returns per SF (its address arms
    match one generated state, OH, within a narrow profit range): at
    scale 5 phase 7's files give it rows, equal to pyarrow's.  The files
    (about 2 GB) are removed after the check."""
    d = str(tmp_path / "sf5")
    os.makedirs(d)
    try:
        chip_smoke.make_tpcds(d, 5, SEED)
        chip_smoke.make_tpcds7(d, 5, SEED)
        assert _check_flat(d, "q85",
                           chip_smoke.ds7_references(d, ["q85"])["q85"])
    finally:
        shutil.rmtree(d)


def test_reference_factors_distinct_in_lists(one_file):
    """The JAX package's fault 4, shown on q48: its ``In`` prints no
    values, so its OR factoring takes ``ca_state IN ('CO', 'OH', 'TX')``
    and ``ca_state IN ('OR', 'MN', 'KY')`` for one conjunct.  Its engine
    and oracle agree with each other and not with pyarrow; the port
    agrees with pyarrow."""
    from spark_rapids_tpu.expr import core as jec
    from spark_rapids_tpu.expr import predicates as jep
    col = jec.AttributeReference("ca_state")
    assert repr(jep.In(col, ["CO"])) == repr(jep.In(col, ["OR"]))
    truth = chip_smoke.ds7_references(one_file, ["q48"])["q48"]
    engine = _jax_on(one_file, "q48", with_tpu_session)
    oracle = _jax_on(one_file, "q48", with_cpu_session)
    assert engine == oracle != truth
    assert _check_flat(one_file, "q48", truth) == truth


def _sf10_plan(data_dir, q):
    """The physical plan of ``q`` over ``data_dir``'s tables with each
    scan's row estimate set to the table's rows at SF10."""
    sf10 = {**{t: int(v * 10) for t, v in chip_smoke.DS_ROWS_PER_SF.items()},
            **{t: int(v * 10) for t, v in
               chip_smoke.DS7_ROWS_PER_SF.items()}, "store": 120}
    s = _views(TpuSession(device="cpu"), data_dir)
    for view in s._views.values():
        for scan in _scans(view):
            name = os.path.basename(scan.paths[0]).split(".")[0]
            scan._rows = sf10.get(name, scan.estimated_rows())
    return s.sql(tpcds.QUERIES[q]).explain()


@pytest.mark.parametrize("q", chip_smoke.DS7_QUERIES)
def test_sf10_estimates_plan_phase7(drawn, q):
    """At SF10's row counts each flat query plans DS7_PLANS' operators
    with no cross join: store_sales joins store_returns and then
    catalog_sales shuffled (q17, q25, q29, q50), catalog_sales joins
    catalog_returns shuffled (q40), and every build side of at most
    BROADCAST_ROW_THRESHOLD estimated rows is broadcast."""
    plan = _sf10_plan(drawn, q)
    assert chip_smoke.plan_signature(plan) == chip_smoke.DS7_PLANS[q]
    assert "cross" not in plan


def test_phase7_generator_matches_generate(one_file, tmp_path):
    """Phase 7's tables have generate's names, types and row counts; its
    returns are sales lines (ticket or order number, item, customer)
    returned 1-120 days after the sale, as its docstring lists."""
    import pyarrow as pa
    d = str(tmp_path)
    chip_smoke.make_tpcds(d, SCALE, SEED)
    rows = chip_smoke.make_tpcds7(d, SCALE, SEED)
    for t in chip_smoke.DS7_TABLES:
        want = papq.read_table(os.path.join(one_file, f"{t}.parquet"))
        got = papq.read_table(os.path.join(d, f"{t}.parquet"))
        assert got.schema.names == want.schema.names, t
        assert got.schema.types == want.schema.types, t
        assert got.num_rows == want.num_rows == rows[t], t
    ss = papq.read_table(os.path.join(d, "store_sales.parquet"))
    sr = papq.read_table(os.path.join(d, "store_returns.parquet"))
    j = sr.join(ss, keys=["sr_ticket_number", "sr_item_sk",
                          "sr_customer_sk"],
                right_keys=["ss_ticket_number", "ss_item_sk",
                            "ss_customer_sk"], join_type="left semi")
    assert j.num_rows == sr.num_rows
    for sales, rets, keys in (
            ("catalog_sales", "catalog_returns",
             [("cr_order_number", "cs_order_number"),
              ("cr_item_sk", "cs_item_sk"),
              ("cr_returning_customer_sk", "cs_bill_customer_sk")]),
            ("web_sales", "web_returns",
             [("wr_order_number", "ws_order_number"),
              ("wr_item_sk", "ws_item_sk"),
              ("wr_returning_customer_sk", "ws_bill_customer_sk")])):
        f = papq.read_table(os.path.join(d, f"{sales}.parquet"))
        r = papq.read_table(os.path.join(d, f"{rets}.parquet"))
        p = sales[0] + "s"
        j = r.join(f, keys=[a for a, _ in keys],
                   right_keys=[b for _, b in keys], join_type="inner")
        days = pa.compute.subtract(j[f"{p[0]}r_returned_date_sk"],
                                   j[f"{p}_sold_date_sk"])
        assert pa.compute.any(pa.compute.and_(
            pa.compute.greater_equal(days, 1),
            pa.compute.less_equal(days, 120))).as_py()
        assert j.num_rows >= r.num_rows
    wr = papq.read_table(os.path.join(d, "web_returns.parquet"))
    assert wr["wr_returning_cdemo_sk"].equals(wr["wr_refunded_cdemo_sk"])


@pytest.mark.parametrize("q", chip_smoke.DS8_QUERIES)
def test_ds8_query_matches_jax_oracle_and_pyarrow(one_file, q):
    refs = chip_smoke.ds8_references(one_file, [q])[q]
    df = _views(TpuSession(device="cpu"), one_file).sql(tpcds.QUERIES[q])
    table = df.to_arrow()
    chip_smoke.check_rows(q, table, refs, chip_smoke.DS8_ORDER[q],
                          chip_smoke.DS8_LIMIT.get(q, 100))
    got = [tuple(r.values()) for r in table.to_pylist()]
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(_jax_on(one_file, q, engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", chip_smoke.DS8_QUERIES)
def test_ds8_query_on_drawn_returns_matches_oracle(drawn, q):
    refs = chip_smoke.ds8_references(drawn, [q])[q]
    df = _views(TpuSession(device="cpu"), drawn).sql(tpcds.QUERIES[q])
    table = df.to_arrow()
    chip_smoke.check_rows(q, table, refs, chip_smoke.DS8_ORDER[q],
                          chip_smoke.DS8_LIMIT.get(q, 100))
    got = [tuple(r.values()) for r in table.to_pylist()]
    assert got, f"{q}: no rows"
    _compare_rows(canon_rows(_jax_on(drawn, q, with_cpu_session)),
                  canon_rows(got), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", chip_smoke.DS8_QUERIES)
def test_sf10_estimates_plan_phase8(drawn, q):
    """At SF10's row counts each phase-8 query plans DS8_PLANS'
    operators: q28 and q88 a TpuNestedLoopJoin over their one-row
    aggregates, and no other query one."""
    plan = _sf10_plan(drawn, q)
    assert chip_smoke.plan_signature(plan) == chip_smoke.DS8_PLANS[q]
    assert ("TpuNestedLoopJoin" in plan) == (q in chip_smoke.DS8_NESTED)


def _ds9_rows(data_dir, q):
    table = _views(TpuSession(device="cpu"), data_dir).sql(
        tpcds.QUERIES[q]).to_arrow()
    chip_smoke.check_rows(q, table, chip_smoke.ds9_references(
        data_dir, [q])[q], chip_smoke.DS9_ORDER[q],
        chip_smoke.DS9_LIMIT.get(q, 100))
    return [tuple(r.values()) for r in table.to_pylist()]


@pytest.mark.parametrize("q", chip_smoke.DS9_QUERIES)
def test_ds9_query_matches_jax_oracle_and_pyarrow(one_file, q):
    got = _ds9_rows(one_file, q)
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(_jax_on(one_file, q, engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


#: phase-9 queries with no rows on phase 7's files at scale 0.1: q24's
#: stores of market 8 share no zip code with an address at this scale,
#: and q58 has no item whose three channels' revenues of one week lie
#: within 10% of each other
DS9_DRAWN_EMPTY = {"q24", "q58"}


@pytest.mark.parametrize("q", chip_smoke.DS9_QUERIES)
def test_ds9_query_on_drawn_returns_matches_oracle(drawn, q):
    got = _ds9_rows(drawn, q)
    assert bool(got) == (q not in DS9_DRAWN_EMPTY), f"{q}: {len(got)} rows"
    _compare_rows(canon_rows(_jax_on(drawn, q, with_cpu_session)),
                  canon_rows(got), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", chip_smoke.DS9_QUERIES)
def test_sf10_estimates_plan_phase9(drawn, q):
    """At SF10's row counts each phase-9 query plans DS9_PLANS'
    operators: the semi and anti joins of q10, q35 and q69 build on their
    fact tables' customer keys and shuffle, and q9's fifteen scalar
    queries and q45's IN (query) leave no join of their own in the outer
    plan."""
    plan = _sf10_plan(drawn, q)
    assert chip_smoke.plan_signature(plan) == chip_smoke.DS9_PLANS[q]
    assert "TpuNestedLoopJoin" not in plan and "cross" not in plan


def test_phase6_baskets_are_tickets(tmp_path):
    """Phase 6's baskets (its one departure from ``generate``, for q34):
    a tenth of each store_sales part's rows, in tickets of 8 to 16 lines
    past generate's ticket numbers, each ticket's lines on one date,
    time, customer, demographics, household, address and store."""
    d = str(tmp_path)
    chip_smoke.make_tpcds(d, SCALE, SEED)
    ss = papq.read_table(os.path.join(d, "store_sales.parquet"))
    nss = ss.num_rows
    baskets = ss.filter(pa.compute.greater_equal(ss["ss_ticket_number"],
                                                  nss // 4))
    assert abs(baskets.num_rows - nss * chip_smoke.DS_BASKET_SHARE) <= 8
    shared = ["ss_sold_date_sk", "ss_sold_time_sk", "ss_customer_sk",
              "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk"]
    g = baskets.group_by("ss_ticket_number").aggregate(
        [("ss_item_sk", "count")] +
        [(c, "count_distinct") for c in shared])
    lines = g["ss_item_sk_count"].to_pylist()
    # each part's last basket may be cut short
    assert sum(1 for n in lines if not 8 <= n <= 16) <= chip_smoke.DS_PARTS
    for c in shared:
        assert set(g[f"{c}_count_distinct"].to_pylist()) == {1}, c


def _ds10_rows(data_dir, q, refs=None):
    table = _views(TpuSession(device="cpu"), data_dir).sql(
        tpcds.QUERIES[q]).to_arrow()
    refs = refs if refs is not None else \
        chip_smoke.ds10_references(data_dir, [q])[q]
    chip_smoke.check_rows(q, table, refs, chip_smoke.DS10_ORDER[q],
                          chip_smoke.DS10_LIMIT.get(q, 100))
    return [tuple(r.values()) for r in table.to_pylist()]


#: phase-10 queries with no rows, or one NULL row, on generate's files at
#: scale 0.02 and on phase 7's at 0.1: q76 reads NULL foreign keys, which
#: neither generator draws; no item of q83 is returned in all three
#: channels in its week; q23's sum is NULL (no item sells more than four
#: times on one date).  ``test_ds10_*_with_rows`` give each its rows.
DS10_NO_ROWS = {"q76", "q83"}
DS10_NULL_SUM = {"q23"}


@pytest.mark.parametrize("q", chip_smoke.DS10_QUERIES)
def test_ds10_query_matches_jax_oracle_and_pyarrow(one_file, q):
    got = _ds10_rows(one_file, q)
    assert bool(got) == (q not in DS10_NO_ROWS), f"{q}: {len(got)} rows"
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(_jax_on(one_file, q, engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", chip_smoke.DS10_QUERIES)
def test_ds10_query_on_drawn_returns_matches_oracle(drawn, q):
    got = _ds10_rows(drawn, q)
    assert bool(got) == (q not in DS10_NO_ROWS), f"{q}: {len(got)} rows"
    assert (got == [(None,)]) == (q in DS10_NULL_SUM)
    _compare_rows(canon_rows(_jax_on(drawn, q, with_cpu_session)),
                  canon_rows(got), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", chip_smoke.DS10_QUERIES)
def test_sf10_estimates_plan_phase10(drawn, q):
    """At SF10's row counts each phase-10 query plans DS10_PLANS'
    operators: q4, q11 and q74 aggregate one channel's year per read of
    their CTE (the filter over the union empties the other branches),
    q38's and q87's semi and anti joins of DISTINCT sets shuffle, and no
    query plans a cross join."""
    plan = _sf10_plan(drawn, q)
    assert chip_smoke.plan_signature(plan) == chip_smoke.DS10_PLANS[q]
    assert "TpuNestedLoopJoin" not in plan and "cross" not in plan


def _copy_tables(src, dst, change):
    """``src``'s tables under ``dst``, each passed through ``change(name,
    table)`` first."""
    os.makedirs(dst)
    for t in tpcds.TABLES:
        path = os.path.join(src, f"{t}.parquet")
        if os.path.exists(path):
            papq.write_table(change(t, papq.read_table(path)),
                             os.path.join(dst, f"{t}.parquet"))
    return dst


def _check_ds10_with_rows(data_dir, q):
    got = _ds10_rows(data_dir, q)
    assert got and got != [(None,)], f"{q}: {got}"
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(_jax_on(data_dir, q, engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


def test_ds10_q76_with_rows(one_file, tmp_path):
    """q76 on generate's tables with 5% of ss_store_sk,
    ws_ship_customer_sk and cs_ship_mode_sk NULL (TPC-DS's own generator
    leaves such keys NULL; ``generate`` draws none)."""
    nulls = {"store_sales": "ss_store_sk", "web_sales": "ws_ship_customer_sk",
             "catalog_sales": "cs_ship_mode_sk"}
    rng = pa.array(np.random.default_rng(76).random(1 << 20) < 0.05)

    def change(name, t):
        if name not in nulls:
            return t
        i = t.schema.get_field_index(nulls[name])
        col = pa.compute.if_else(rng[:t.num_rows], pa.scalar(
            None, t.schema.field(i).type), t.column(i))
        return t.set_column(i, nulls[name], col)
    _check_ds10_with_rows(_copy_tables(one_file, str(tmp_path / "q76"),
                                       change), "q76")


def test_ds10_q23_with_rows(one_file, tmp_path):
    """q23 on generate's tables with each store_sales row written five
    times: every item sold on a date sells more than four times there,
    and the best customers stay the best (every sum five times larger)."""
    def change(name, t):
        return pa.concat_tables([t] * 5) if name == "store_sales" else t
    _check_ds10_with_rows(_copy_tables(one_file, str(tmp_path / "q23"),
                                       change), "q23")


def test_ds10_q83_with_rows(one_file, tmp_path):
    """q83 on generate's tables with the first 40 rows of each returns
    table returned on 2000-06-30 (q83's week) and of one of 8 items, so
    that items are returned in all three channels that week."""
    d = papq.read_table(os.path.join(one_file, "date_dim.parquet"))
    day = d.filter(pa.compute.equal(d["d_date"], pa.scalar(
        datetime.date(2000, 6, 30), pa.date32())))["d_date_sk"][0].as_py()
    items = papq.read_table(os.path.join(one_file, "item.parquet"))
    sks = items["i_item_sk"].to_pylist()[:8]
    returns = {"store_returns": "sr", "catalog_returns": "cr",
               "web_returns": "wr"}

    def change(name, t):
        if name not in returns:
            return t
        p = returns[name]
        n = min(40, t.num_rows)
        for col, vals in ((f"{p}_returned_date_sk", [day] * n),
                          (f"{p}_item_sk", [sks[i % 8] for i in range(n)])):
            i = t.schema.get_field_index(col)
            new = pa.concat_arrays([pa.array(vals, t.schema.field(i).type),
                                    t.column(i).slice(n).combine_chunks()])
            t = t.set_column(i, col, new)
        return t
    _check_ds10_with_rows(_copy_tables(one_file, str(tmp_path / "q83"),
                                       change), "q83")


def _ds11_rows(data_dir, q):
    table = _views(TpuSession(device="cpu"), data_dir).sql(
        tpcds.QUERIES[q]).to_arrow()
    chip_smoke.check_rows(q, table, chip_smoke.ds11_references(
        data_dir, [q])[q], chip_smoke.DS11_ORDER[q])
    return [tuple(r.values()) for r in table.to_pylist()]


#: phase-11 queries with no rows on generate's files at 0.02 and on
#: phase 7's at 0.1: q44's scalar subquery reads NULL ss_hdemo_sk, which
#: neither generator draws (``test_ds11_q44_with_rows`` gives it some)
DS11_NO_ROWS = {"q44"}
#: phase-11 queries whose OR arms hold IN lists of different values
#: (``(i_category in (...) and i_class in (...)) or (...)``), which the
#: JAX package factors as one conjunct (its fault 4, as in q13, q48 and
#: q85): its engine and oracle answer the first arm alone
#: (``test_reference_keeps_q53s_first_arm``), so these are held to
#: pyarrow alone
DS11_IN_FAULT = {"q53", "q63", "q89"}


@pytest.mark.parametrize("q", chip_smoke.DS11_QUERIES)
def test_ds11_query_matches_jax_oracle_and_pyarrow(one_file, q):
    got = _ds11_rows(one_file, q)
    assert bool(got) == (q not in DS11_NO_ROWS), f"{q}: {len(got)} rows"
    if q in DS11_IN_FAULT:
        return
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(_jax_on(one_file, q, engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", chip_smoke.DS11_QUERIES)
def test_ds11_query_on_drawn_returns_matches_oracle(drawn, q):
    got = _ds11_rows(drawn, q)
    assert bool(got) == (q not in DS11_NO_ROWS), f"{q}: {len(got)} rows"
    if q not in DS11_IN_FAULT:
        _compare_rows(canon_rows(_jax_on(drawn, q, with_cpu_session)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


def test_reference_keeps_q53s_first_arm(one_file):
    """The JAX package's q53 equals the port's q53 with its second OR arm
    deleted: its ``_factor_or`` matches the two arms' ``IN`` lists by a
    ``repr`` that prints no values and factors them out as one; the
    port's answer with both arms differs, and equals pyarrow's."""
    text = tpcds.QUERIES["q53"]
    first = text.replace("""or (i_category in ('Women', 'Music', 'Men')
                  and i_class in ('shirts', 'dresses', 'pants'))""", "")
    assert first != text
    jax = canon_rows(_jax_on(one_file, "q53", with_tpu_session))
    _compare_rows(jax, canon_rows(_views(TpuSession(device="cpu"),
                                         one_file).sql(first).collect()),
                  rel=DEFAULT_FLOAT_REL)
    assert jax != canon_rows(_ds11_rows(one_file, "q53"))


@pytest.mark.parametrize("q", chip_smoke.DS11_QUERIES)
def test_sf10_estimates_plan_phase11(drawn, q):
    """At SF10's row counts each phase-11 query plans DS11_PLANS'
    operators: one PARTITION BY over the node hash-exchanges on it (q51's
    three windows on the item), none (q44's ranks) or two of different
    keys (q47's and q57's mean and rank) coalesce, and no query plans a
    cross join."""
    plan = _sf10_plan(drawn, q)
    assert chip_smoke.window_plan_signature(plan) == \
        chip_smoke.DS11_PLANS[q]
    assert "TpuNestedLoopJoin" not in plan and "cross" not in plan


def test_ds11_q44_with_rows(one_file, tmp_path):
    """q44 on generate's tables with 5% of ss_hdemo_sk NULL (TPC-DS's own
    generator leaves such keys NULL; ``generate`` draws none): its scalar
    is the mean profit of store 4's lines without a household, and the
    items above 90% of it are ranked both ways."""
    rng = pa.array(np.random.default_rng(44).random(1 << 20) < 0.05)

    def change(name, t):
        if name != "store_sales":
            return t
        i = t.schema.get_field_index("ss_hdemo_sk")
        col = pa.compute.if_else(rng[:t.num_rows], pa.scalar(
            None, t.schema.field(i).type), t.column(i))
        return t.set_column(i, "ss_hdemo_sk", col)
    d = _copy_tables(one_file, str(tmp_path / "q44"), change)
    got = _ds11_rows(d, "q44")
    assert got, "q44: no rows"
    assert {r[0] for r in got} <= set(range(1, 11))
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(_jax_on(d, "q44", engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


def _ds12_rows(data_dir, q):
    table = _views(TpuSession(device="cpu"), data_dir).sql(
        tpcds.QUERIES[q]).to_arrow()
    chip_smoke.check_rows(q, table, chip_smoke.ds12_references(
        data_dir, [q])[q], chip_smoke.DS12_ORDER[q])
    return [tuple(r.values()) for r in table.to_pylist()]


#: phase-12 queries with no rows on generate's files at 0.02: q49 keeps
#: the sales whose returns match on (order, item), and ``generate`` draws
#: its returns apart from its sales (phase 7's files give it rows)
DS12_NO_ROWS = {"q49"}


@pytest.mark.parametrize("q", chip_smoke.DS12_QUERIES)
def test_ds12_query_matches_jax_oracle_and_pyarrow(one_file, q):
    got = _ds12_rows(one_file, q)
    assert bool(got) == (q not in DS12_NO_ROWS), f"{q}: {len(got)} rows"
    for engine in (with_tpu_session, with_cpu_session):
        _compare_rows(canon_rows(_jax_on(one_file, q, engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", chip_smoke.DS12_QUERIES)
def test_ds12_query_on_drawn_returns_matches_oracle(drawn, q):
    got = _ds12_rows(drawn, q)
    assert got, f"{q}: no rows"
    engines = (with_cpu_session, with_tpu_session) if q in DS12_NO_ROWS \
        else (with_cpu_session,)
    for engine in engines:
        _compare_rows(canon_rows(_jax_on(drawn, q, engine)),
                      canon_rows(got), rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("q", chip_smoke.DS12_QUERIES)
def test_sf10_estimates_plan_phase12(drawn, q):
    """At SF10's row counts each phase-12 query plans DS12_PLANS'
    operators: each ROLLUP a ``TpuExpand`` right under its partial
    aggregate, which a hash exchange separates from the final one; each
    count(DISTINCT) two aggregates, each partial, exchange and final,
    one over the other."""
    plan = _sf10_plan(drawn, q)
    assert chip_smoke.window_plan_signature(plan) == \
        chip_smoke.DS12_PLANS[q]
    ops = [ln.strip() for ln in plan.splitlines()]
    if q in chip_smoke.DS12_ROLLUP:
        i = next(i for i, ln in enumerate(ops)
                 if ln.startswith("TpuExpand"))
        assert ops[i - 1].startswith("TpuHashAggregate[partial")
        assert ops[i - 2].startswith("TpuShuffleExchange[HashPartitioner")
        assert ops[i - 3].startswith("TpuAQEShuffleRead")
        assert ops[i - 4].startswith("TpuHashAggregate[final")
    if q in chip_smoke.DS12_DISTINCT:
        i = ops.index("TpuHashAggregate[final]")
        assert [ln.split("[")[0] for ln in ops[i:i + 7]] == [
            "TpuHashAggregate", "TpuCoalescePartitions", "TpuHashAggregate",
            "TpuHashAggregate", "TpuAQEShuffleRead", "TpuShuffleExchange",
            "TpuHashAggregate"]


def _ds13_rows(data_dir, q):
    table = _views(TpuSession(device="cpu"), data_dir).sql(
        tpcds.QUERIES[q]).to_arrow()
    chip_smoke.check_rows(q, table, chip_smoke.ds13_references(
        data_dir, [q])[q], chip_smoke.DS13_ORDER[q])
    return [tuple(r.values()) for r in table.to_pylist()]


@pytest.mark.parametrize("q", ["q6", "q41", "q70"])
def test_ds13_query_matches_jax_and_pyarrow(one_file, q):
    """The last three TPC-DS texts the port's SQL refused or no phase
    ran: q6 (a correlated average per category), q41 (its correlation
    inside both arms of an OR) and q70 (a select alias inside an ORDER
    BY's CASE, a string CASE in a window's PARTITION BY over a ROLLUP)
    against ``ds13_references`` and the JAX engine.  q72 runs in phase
    13 and its CPU rehearsal: the JAX engine takes ~50 s on it here."""
    got = _ds13_rows(one_file, q)
    assert got, f"{q}: no rows"
    _compare_rows(canon_rows(_jax_on(one_file, q, with_tpu_session)),
                  canon_rows(got), rel=DEFAULT_FLOAT_REL)


def test_sf10_q72_filters_each_chunk_of_its_pairs(one_file):
    """At SF10's row counts q72 joins catalog_sales to inventory in a
    shuffled join on the item whose residual condition holds
    ``inv_quantity_on_hand < cs_quantity`` (evaluated on each chunk of
    ~800M expanded pairs), its WHERE pushed through the LEFT join of
    promotion; d1's week equals d2's as a join key."""
    sf10 = {**{t: int(v * 10) for t, v in chip_smoke.DS_ROWS_PER_SF.items()},
            **{t: int(v * 10) for t, v in
               chip_smoke.DS7_ROWS_PER_SF.items()}}
    s = _views(TpuSession(device="cpu"), one_file)
    for view in s._views.values():
        for scan in _scans(view):
            name = os.path.basename(scan.paths[0]).split(".")[0]
            scan._rows = sf10.get(name, scan.estimated_rows())
    plan = s.plan(s.sql(tpcds.QUERIES["q72"])._plan)
    joins = [n for n in _nodes(plan) if type(n).__name__.endswith("Join")]
    shuffled = [j for j in joins
                if type(j).__name__ == "TpuAdaptiveShuffledJoin"]
    assert len(shuffled) == 1
    j = shuffled[0].join
    assert repr(j.condition) == \
        "(col(inv_quantity_on_hand) < col(cs_quantity))"
    assert [repr(k) for k in j.left_keys + j.right_keys] == [
        "col(cs_item_sk)", "col(inv_item_sk)"]
    assert any("d_week_seq" in repr(n.join.left_keys) for n in joins)
    assert joins[0].join.how == "left" and joins[0].join.condition is None
