"""The port on a CUDA device: kernels against their plain versions and the
headline query against numpy.

Every test here is marked ``gpu`` and skips without a card.  The file
imports neither JAX nor the reference package, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.columnar.schema import Field, Schema
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.tpu_aggregate import TpuHashAggregate
from spark_rapids_tpu_torch.expr import core as ec
from spark_rapids_tpu_torch.kernels import cuda_ops
from spark_rapids_tpu_torch.shuffle.partitioners import HashPartitioner

NULL_WORD = np.uint64(0x9E3779B97F4A7C15)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _words(rng, n, num_words):
    words = []
    for _ in range(num_words):
        w = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
        w[rng.random(n) < 0.1] = NULL_WORD
        words.append(torch.from_numpy(w.view(np.int64)).cuda())
    return words


@pytest.mark.gpu
@pytest.mark.parametrize("n,num_words,num_parts",
                         [(4096, 1, 8), (100_003, 3, 1000), (1, 2, 1),
                          (50_000, 1, 2**31 - 1), (50_000, 1, 4096)])
def test_hash_partition_kernel_matches_plain(n, num_words, num_parts):
    _need_card()
    words = _words(np.random.default_rng(n), n, num_words)
    before = cuda_ops.LAUNCHES["hash_partition_ids"]
    got = cuda_ops.hash_partition_ids(words, num_parts)
    assert cuda_ops.LAUNCHES["hash_partition_ids"] == before + 1
    assert got.is_cuda
    assert torch.equal(got, cuda_ops.hash_partition_ids_plain(words,
                                                              num_parts))


@pytest.mark.gpu
@pytest.mark.parametrize("n,num_words,num_parts,live_frac",
                         [(4096, 1, 8, 0.25), (4 << 20, 1, 8, 1.0),
                          (100_003, 3, 1, 0.5), (1 << 20, 2, 4096, 0.9),
                          (1, 1, 8, 1.0), (0, 1, 8, 1.0),
                          (70_000, 1, 5, 0.0)])
def test_hash_split_matches_stable_sort(n, num_words, num_parts, live_frac):
    """The counting-sort split equals torch.sort(stable=True) + bincount
    of the ids (dead rows as partition num_parts), bit for bit."""
    _need_card()
    rng = np.random.default_rng(n + num_parts)
    words = _words(rng, n, num_words)
    live = torch.from_numpy(rng.random(n) < live_frac).cuda()
    perm, counts = cuda_ops.hash_split(words, live, num_parts)
    key = torch.where(live, cuda_ops.hash_partition_ids_plain(
        words, num_parts).to(torch.int64), num_parts)
    assert torch.equal(perm, torch.sort(key, stable=True)[1])
    assert torch.equal(counts, torch.bincount(key, minlength=num_parts + 1))


@pytest.mark.gpu
def test_split_on_card_calls_neither_sort_nor_bincount(monkeypatch):
    _need_card()
    n = 10_000
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.integers(0, 1000, n)).cuda()
    schema = Schema([Field("k", T.INT64, True)])
    batch = ColumnarBatch(schema, [Column(T.INT64, k, torch.ones(
        n, dtype=torch.bool, device="cuda"))], n - 7, device=k.device)
    part = HashPartitioner([ec.AttributeReference("k", T.INT64)], 8)
    want = part.split(batch)

    def refuse(*a, **kw):
        raise AssertionError("torch.sort / torch.bincount on the card")
    monkeypatch.setattr(torch, "sort", refuse)
    monkeypatch.setattr(torch, "bincount", refuse)
    got = part.split(batch)
    assert np.array_equal(got.offsets, want.offsets)
    assert got.offsets[-1] == n - 7


@pytest.mark.gpu
@pytest.mark.parametrize("n,table,k,m,sum_dt",
                         [(1 << 20, 4096, 7, 0, np.float32),
                          (100_000, 4096, 2, 3, np.float32),
                          (5000, 60_000, 1, 1, np.float32),
                          (0, 16, 1, 1, np.float32),
                          (1 << 20, 4096, 5, 1, np.float64),
                          (5000, 60_000, 2, 1, np.float64),
                          (100_003, 4096, 3, 2, np.float32),
                          (100_001, 4096, 3, 1, np.float64)])
def test_table_reduce_kernel_matches_plain(n, table, k, m, sum_dt):
    _need_card()
    rng = np.random.default_rng(n + table)
    bucket = rng.integers(0, table + 1, n).astype(np.int32)
    sums = np.stack([np.ones(n, sum_dt)] +
                    [rng.standard_normal(n).astype(sum_dt)
                     for _ in range(k - 1)])
    maxs = rng.standard_normal((m, n)).astype(np.float32)
    if n:
        maxs[:, rng.random(n) < 0.3] = -np.inf
        maxs[:, 0] = np.nan
    args = (torch.from_numpy(bucket).cuda(), torch.from_numpy(sums).cuda(),
            torch.from_numpy(maxs).cuda(), table)
    s, mx = cuda_ops.table_reduce(*args)
    ps, pm = cuda_ops.table_reduce_plain(*args)
    assert torch.equal(s[0], ps[0])
    # atomics reorder the sums of non-integer rows
    assert s.dtype == ps.dtype == torch.from_numpy(sums).dtype
    rtol, atol = (1e-5, 1e-3) if sum_dt == np.float32 else (1e-12, 1e-9)
    torch.testing.assert_close(s[1:], ps[1:], rtol=rtol, atol=atol)
    assert torch.equal(mx.isnan(), pm.isnan())
    assert torch.equal(mx.nan_to_num(), pm.nan_to_num())


def _stage_values(rng, n):
    """f64 values of many magnitudes with NaN, +-inf, -0.0, subnormals
    (f64 and f32) sprinkled in."""
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324,
                         1e-310, 1e-45, -3e-40])
    pick = rng.random(n) < 0.02
    v[pick] = rng.choice(specials, int(pick.sum()))
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("kinds,n,table,beyond_f32,offset", [
    (("fsum64", "fmax64"), 1 << 20, 4096, False, 0),       # exact partial
    (("fsum64", "icount", "fmax64"), 16_384, 4096, False, 0),   # final
    (("fsumv", "fmax"), 1 << 20, 4096, False, 0),           # variable
    (("fsum64", "fmax64"), 1 << 20, 1 << 14, False, 0),     # y-split
    (("fsum64", "fmax64", "count"), 100_001, 60_000, True, 0),  # chunks
    (("fsum64", "fmax", "fsumv", "icount", "count"), 50_003, 512, False,
     1),                                                    # unaligned
], ids=["partial", "final", "variable", "ysplit", "chunks", "unaligned"])
def test_table_stage_kernel_matches_plain(kinds, n, table, beyond_f32,
                                          offset):
    """Every table of the stage kernel against its plain version: integer
    tables (counts, flags, chunk lanes, i64 sums, u64 max words) and f32
    maxes bit for bit, f64 value sums within 1e-12 of the bucket's sum
    of |v|."""
    _need_card()
    rng = np.random.default_rng(n + table)
    m = n + offset
    bucket = torch.from_numpy(rng.integers(0, table + 1, m)
                              .astype(np.int32)).cuda()[offset:]
    live = bucket < table
    cols = [cuda_ops.StageCol("count")]
    for kind in kinds:
        valid = torch.from_numpy(rng.random(m) > 0.1).cuda()[offset:]
        if kind == "icount":
            data = torch.from_numpy(rng.integers(0, 1 << 40, m)).cuda()
            c = Column(T.INT64, data[offset:], valid)
        else:
            v = _stage_values(rng, m)
            if beyond_f32:
                v[::997] = 1e300
            c = Column(T.FLOAT64, torch.from_numpy(v).cuda()[offset:], valid)
        sc, fit = TpuHashAggregate._stage_col(kind, c, live)
        if beyond_f32:
            # an f64 beyond f32 range cannot sit on fsum64's lanes; the
            # fmax64 word is the f64's own bits and takes it
            assert bool(fit) == (kind != "fsum64")
        cols.append(sc)
    before = cuda_ops.LAUNCHES["table_reduce"]
    got = cuda_ops.table_stage(bucket, table, cols)
    assert cuda_ops.LAUNCHES["table_reduce"] == before + 1
    want = cuda_ops.table_stage_plain(bucket, table, cols)
    for c, g, w in zip(cols, got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, c.kind
            if c.kind == "fsumv" and a.dtype == torch.float64:
                mag = cuda_ops.table_stage_plain(bucket, table, [
                    cuda_ops.StageCol("fsumv", c.data.abs()
                                      .nan_to_num(0.0, 0.0, 0.0),
                                      c.valid)])[0][1]
                fin = torch.isfinite(b)
                assert torch.equal(a.isnan(), b.isnan()), c.kind
                assert torch.equal(a[~fin].nan_to_num(), b[~fin]
                                   .nan_to_num()), c.kind
                assert bool(((a - b)[fin].abs() <= 1e-12 * mag[fin])
                            .all()), c.kind
            elif a.is_floating_point():
                assert torch.equal(a.isnan(), b.isnan()), c.kind
                assert torch.equal(a.nan_to_num(), b.nan_to_num()), c.kind
            else:
                assert torch.equal(a, b), c.kind


@pytest.mark.gpu
@pytest.mark.parametrize("variable", [False, True], ids=["exact", "variable"])
def test_headline_query_on_card_matches_numpy(variable):
    _need_card()
    data, dim = chip_smoke.make_data(300_000, 7)
    conf = TpuConf({"spark.rapids.tpu.sql.variableFloatAgg.enabled":
                    variable,
                    "spark.rapids.tpu.sql.batchSizeRows": 1 << 16})
    df = chip_smoke.build_df(TpuSession(conf), data, dim, 4)
    cuda_ops.reset_launches()
    table = df.to_arrow()
    assert all(v > 0 for v in cuda_ops.LAUNCHES.values())
    rel = chip_smoke.VARIABLE_REL if variable else chip_smoke.EXACT_REL
    chip_smoke.compare(table, chip_smoke.numpy_reference(data, dim), rel,
                       "card")
    if not variable:
        assert table.equals(df.to_arrow())


def _join_frames(session, n_left=120_000, n_right=80_000, hot=0, seed=9):
    """Two seeded tables with duplicate keys, nulls in the first key and a
    second key; ``hot`` right rows (and hot // 10 left rows) share key 7."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)

    def side(n, prefix, nulls):
        k = rng.integers(0, 60_000, n)
        k[:hot // 10 if prefix == "l" else hot] = 7
        return pa.table({
            f"{prefix}k": pa.array(k, mask=rng.random(n) < nulls),
            f"{prefix}k2": rng.integers(0, 3, n),
            f"{prefix}v": rng.random(n),
            f"{prefix}i": np.arange(n, dtype=np.int32)})
    return (session.create_dataframe(side(n_left, "l", 0.0 if hot else 0.05),
                                     num_partitions=3),
            session.create_dataframe(side(n_right, "r", 0.0 if hot else
                                          0.05), num_partitions=2))


def _join(session, how, hot=0):
    a, b = _join_frames(session, hot=hot)
    return a.join(b, (a["lk"] == b["rk"]) & (a["lk2"] == b["rk2"]), how)


def _sessions(monkeypatch, conf=None):
    from spark_rapids_tpu_torch.plan import overrides
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 1000)
    conf = TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 1 << 15,
                    **(conf or {})})
    return TpuSession(conf), TpuSession(conf, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_join_types_on_card_equal_cpu(monkeypatch, how):
    """A two-key shuffled join on the card equals the port's CPU run row
    by row: every split, sort and compaction is stable on both."""
    _need_card()
    card, cpu = _sessions(monkeypatch)
    df = _join(card, how)
    assert f"TpuShuffledHashJoin[{how}, " in df.explain()
    cuda_ops.reset_launches()
    got = df.to_arrow()
    assert cuda_ops.LAUNCHES["hash_partition_ids"] > 0
    assert got.num_rows > 1000
    assert got.equals(_join(cpu, how).to_arrow())


@pytest.mark.gpu
def test_two_key_join_query_on_card_equals_cpu(monkeypatch):
    """chip_smoke's J7 (lineitem x partsupp on two keys) at SF 0.03: the
    join's rows equal the CPU run's, the query matches numpy."""
    _need_card()
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.plan import overrides
    tables = chip_smoke.make_tpch(0.03, 5)
    batch_rows, threshold, _ = chip_smoke.join_scale(0.03)
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", threshold)
    conf = TpuConf({"spark.rapids.tpu.sql.batchSizeRows": batch_rows})
    rows = []
    for device in ("cuda", "cpu"):
        s = TpuSession(conf, device=device)
        df = chip_smoke.join_query(F, chip_smoke.join_frames(s, tables), "J7")
        chip_smoke.compare_groups(chip_smoke.table_groups(df.to_arrow()),
                                  chip_smoke.join_references(tables)["J7"],
                                  chip_smoke.EXACT_REL, device)
        rows.append(chip_smoke.join_output(s, df)[1])
    assert rows[0].num_rows > 100_000
    assert rows[0].equals(rows[1])


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "full"])
def test_chunked_join_on_card_equals_whole(monkeypatch, how):
    _need_card()
    whole, _ = _sessions(monkeypatch)
    chunked, _ = _sessions(monkeypatch, {
        "spark.rapids.tpu.sql.join.gather.chunkRows": 4096})
    got = _join(chunked, how, hot=6000).to_arrow()
    join = chip_smoke._find(chunked.last_physical_plan,
                            "TpuShuffledHashJoin")[0]
    assert join.expand_counts["chunks"] > 2 * join.expand_counts["batches"]
    assert got.equals(_join(whole, how, hot=6000).to_arrow())


@pytest.fixture(scope="module")
def tpcds_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpcds")
    chip_smoke.make_tpcds(str(d), 0.1, 7)
    return str(d)


def _tpcds_session(data_dir, device):
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 1 << 16}),
                   device=device)
    for t in chip_smoke.DS_TABLES:
        s.read.parquet(f"{data_dir}/{t}.parquet") \
            .create_or_replace_temp_view(t)
    return s


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q3", "q42", "q52", "q96"])
def test_tpcds_quartet_on_card_equals_cpu(tpcds_dir, q):
    """The query text over Parquet part files on the card: the CPU run's
    bytes, the planned operators, and B1 in the grouped exchanges."""
    _need_card()
    import sys
    sys.path.insert(0, "benchmarks")
    from tpcds_queries import QUERIES
    want = _tpcds_session(tpcds_dir, "cpu").sql(QUERIES[q]).to_arrow()
    df = _tpcds_session(tpcds_dir, "cuda").sql(QUERIES[q])
    lines = [ln.strip() for ln in df.explain().splitlines()]
    plan = chip_smoke.DS_PLANS[q]
    assert len(lines) == len(plan)
    assert all(ln.startswith(w) for ln, w in zip(lines, plan))
    before = cuda_ops.LAUNCHES["hash_partition_ids"]
    got = df.to_arrow()
    assert got.num_rows > 0 and chip_smoke.same_bytes(got, want)
    if q != "q96":
        assert cuda_ops.LAUNCHES["hash_partition_ids"] > before


def _close_tables(got, want, rel=1e-12):
    """Equal column names and rows; integers, strings and nulls equal,
    floats within ``rel`` of the CPU's value."""
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for a, b in zip(got.columns, want.columns):
        for x, y in zip(a.to_pylist(), b.to_pylist()):
            if isinstance(y, float) and x is not None:
                assert x == y or (x != x and y != y) or \
                    abs(x - y) <= rel * max(abs(x), abs(y)), (x, y)
            else:
                assert x == y


def _expr_frame(session, n=5000, seed=3):
    rng = np.random.default_rng(seed)
    words = np.array(["Music", "Books", "", "Home", ">10000", "5001-10000",
                      "a somewhat longer value"], dtype=object)
    s = rng.choice(words, n)
    s[rng.random(n) < 0.05] = None
    a = rng.integers(-50, 50, n).astype(object)
    a[rng.random(n) < 0.05] = None
    x = (rng.random(n) * 200 - 50).astype(object)
    x[rng.random(n) < 0.05] = None
    import pyarrow as pa
    return session.create_dataframe(pa.table({
        "k": pa.array(rng.integers(0, 40, n)),
        "a": pa.array(list(a), pa.int64()),
        "d": pa.array(rng.integers(-3, 4, n).astype(np.int32)),
        "x": pa.array(list(x), pa.float64()),
        "s": pa.array(list(s), pa.string()),
    }), num_partitions=3)


def _expr_cases():
    from spark_rapids_tpu_torch.api import functions as F
    c = F.col
    return {
        "subtract": lambda: c("a") - c("d"),
        "divide": lambda: c("a") / c("d"),
        "divide_double": lambda: c("x") / c("a"),
        "unary_minus": lambda: -c("x"),
        "in_ints": lambda: c("a").isin(1, 2, 3, -7),
        "in_strings": lambda: c("s").isin("Music", "Home", ""),
        "is_null": lambda: c("s").isNull(),
        "is_not_null": lambda: c("x").isNotNull(),
        "between": lambda: c("x").between(10.0, 60.5),
        "if": lambda: F.when(c("a") > 0, c("x")).otherwise(c("d")),
        "case_null_else": lambda: F.when(c("d") < 0, c("a"))
        .when(c("d") == 0, 7),
        "coalesce": lambda: F.coalesce(c("x"), c("a"), F.lit(0)),
        "substring_1": lambda: F.substring(c("s"), 1, 5),
        "substring_0": lambda: F.substring(c("s"), 0, 3),
        "substring_neg": lambda: F.substring(c("s"), -4, 2),
        "like_prefix": lambda: c("s").like(">1000%"),
        "like_suffix": lambda: c("s").like("%ks"),
        "like_contains": lambda: c("s").like("%what%"),
        "like_equal": lambda: c("s").like("Home"),
        "concat": lambda: F.concat(c("s"), F.lit(", "), c("s")),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_expr_cases()))
def test_expression_on_card_equals_cpu(name):
    _need_card()
    out = []
    for device in ("cpu", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 2048}),
                       device=device)
        df = _expr_frame(s)
        out.append(df.select("k", _expr_cases()[name]().alias("v"))
                   .to_arrow())
    _close_tables(out[1], out[0])


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["k", "s"], ids=["table", "sort"])
def test_aggregates_on_card_equal_cpu(key):
    """avg and the moments on the card: an integer key takes the table
    core for avg (B2 launches), a string key the sort path; the moments
    always take the sort path."""
    _need_card()
    from spark_rapids_tpu_torch.api import functions as F
    out = []
    for device in ("cpu", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 2048}),
                       device=device)
        df = _expr_frame(s).group_by(key).agg(
            F.avg("x").alias("ax"), F.avg("a").alias("aa"),
            F.stddev_samp("x").alias("sx"), F.stddev_pop("a").alias("sp"),
            F.variance("x").alias("vx"), F.var_pop("d").alias("vd"))
        out.append(df.sort(key).to_arrow())
    _close_tables(out[1], out[0])
    before = cuda_ops.LAUNCHES["table_reduce"]
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 2048}),
                   device="cuda")
    got = _expr_frame(s).group_by(key).agg(F.avg("x").alias("ax")) \
        .sort(key).to_arrow()
    want = _expr_frame(TpuSession(device="cpu")).group_by(key).agg(
        F.avg("x").alias("ax")).sort(key).to_arrow()
    _close_tables(got, want)
    launched = cuda_ops.LAUNCHES["table_reduce"] - before
    assert launched > 0 if key == "k" else launched == 0


@pytest.mark.gpu
def test_top_n_on_card_equals_sort_and_limit():
    _need_card()
    from spark_rapids_tpu_torch.api import functions as F
    s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 2048}),
                   device="cuda")
    df = _expr_frame(s, n=20000).sort(F.col("s").desc(), "x", "a").limit(25)
    assert df.explain().splitlines()[0] == "TpuTopN[25]"
    got = df.to_arrow()
    full = _expr_frame(s, n=20000).sort(F.col("s").desc(), "x", "a")
    assert got.equals(full.to_arrow().slice(0, 25))


@pytest.fixture(scope="module")
def tpcds7_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds7"))
    chip_smoke.make_tpcds(d, 0.1, 7)
    chip_smoke.make_tpcds7(d, 0.1, 7)
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q7", "q15", "q17", "q21", "q40", "q84"])
def test_tpcds_flat_queries_on_card_equal_cpu(tpcds7_dir, q):
    """Six of phase 7's queries at scale 0.1 on the card against the port
    on the CPU: avg, stddev and a division of aggregates, substring and
    IN, CASE and HAVING, a left join with coalesce, concatenation."""
    _need_card()
    import sys
    sys.path.insert(0, "benchmarks")
    from tpcds_queries import QUERIES
    out = []
    for device in ("cpu", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 16}), device=device)
        for t in chip_smoke.DS_TABLES + chip_smoke.DS7_TABLES:
            s.read.parquet(f"{tpcds7_dir}/{t}.parquet") \
                .create_or_replace_temp_view(t)
        out.append(s.sql(QUERIES[q]).to_arrow())
    assert out[0].num_rows > 0
    _close_tables(out[1], out[0])


@pytest.mark.gpu
@pytest.mark.parametrize("keys", [1, 2, 3])
def test_join_probe_kernel_matches_plain(keys):
    """The join probe at a phase 7/8 join partition (a store_sales batch
    against store_returns' sorted lines), bit for bit against its plain
    version, the two ``_bsearch`` loops; one launch per call."""
    _need_card()
    bt, words, live, rank = chip_smoke.probe_inputs(
        np.random.default_rng(keys), keys)
    before = cuda_ops.LAUNCHES["join_probe"]
    lo, cnt = cuda_ops.join_probe(bt.sorted_words, words, live, rank,
                                  bt.index)
    assert cuda_ops.LAUNCHES["join_probe"] == before + 1
    plo, pcnt = cuda_ops.join_probe_plain(bt.sorted_words, words, live, rank)
    assert torch.equal(lo, plo) and torch.equal(cnt, pcnt)
    assert int(cnt.sum()) >= chip_smoke.PROBE_BUILD


def _probe_keys(rng, n, keys, distinct, null_frac):
    """Words of ``keys`` int64 keys on the card (a rank and a value word
    each) from ``distinct`` values; ``null_frac`` of the rows have a null
    (rank 0) in a random key."""
    words = []
    null_key = rng.integers(0, keys, n)
    is_null = rng.random(n) < null_frac
    for j in range(keys):
        null = is_null & (null_key == j)
        value = rng.integers(0, distinct, n).astype(np.int64) * 7919 - 40_000
        words += [np.where(null, 0, 1).astype(np.int64),
                  np.where(null, 0, value)]
    return [torch.from_numpy(w).cuda() for w in words]


#: (keys, build rows, distinct values per key, the index's shared bytes:
#: None for the card's own budget, else small so that stride > 1)
PROBE_EDGES = [
    (1, 0, 10, None), (1, 1, 10, None), (3, 1, 10, None),
    (1, 31, 10, 16), (1, 33, 10, 32),             # stride 32, -1 and +1
    (2, 63, 10, 32), (2, 65, 10, 64),             # stride 64, -1 and +1
    (1, 5000, 1, None), (1, 5000, 1, 1024),       # all one key
    (1, 100_003, 50, 4096), (2, 100_003, 30, None),  # runs over separators
    (3, 524_288, 200, None), (4, 70_001, 8, 8192),
    (13, 20_000, 2, None), (16, 9_999, 2, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("keys,build_n,distinct,budget", PROBE_EDGES)
def test_join_probe_index_and_kernel_match_plain(keys, build_n, distinct,
                                                 budget):
    """The probe's index (rows and separators) and the kernel over it
    equal the sorted words and ``join_probe_plain`` bit for bit: builds of
    0 and 1 rows, of stride +- 1, all one key (count = build_n), runs of
    equal keys across separators, no multiple of the stride, 1-16 keys
    (2-32 words: the K = 2, 4, 6, 8 instances and the generic one), null
    keys and dead rows.  One launch per call."""
    _need_card()
    from spark_rapids_tpu_torch.kernels import join as join_k
    rng = np.random.default_rng(build_n + keys)
    null_frac = 0.05 if distinct > 1 else 0.0
    bt = join_k.build(_probe_keys(rng, build_n, keys, distinct, null_frac))
    index = bt.index if budget is None else \
        cuda_ops.probe_index(bt.sorted_words, budget)
    k = 2 * keys
    assert index.rows.shape == (build_n, k) and index.rows.is_cuda
    assert all(torch.equal(index.rows[:, w], bt.sorted_words[w])
               for w in range(k))
    assert torch.equal(index.seps, index.rows[::index.stride])
    assert budget is None or index.stride > 1 or build_n <= 1
    n = 50_000
    words = _probe_keys(rng, n, keys, distinct + 1, 0.05)
    live = torch.from_numpy(rng.random(n) < 0.8).cuda()
    rank = list(range(0, k, 2))
    before = cuda_ops.LAUNCHES["join_probe"]
    lo, cnt = cuda_ops.join_probe(bt.sorted_words, words, live, rank, index)
    assert cuda_ops.LAUNCHES["join_probe"] == before + 1
    plo, pcnt = cuda_ops.join_probe_plain(bt.sorted_words, words, live, rank)
    assert torch.equal(lo, plo) and torch.equal(cnt, pcnt)
    if distinct == 1:
        assert int(cnt.max()) == build_n
    elif build_n > 1000:
        assert int(cnt.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 25])
def test_join_probe_odd_word_count(k):
    """An odd word count pads a zero word to each row: 3 words run the
    K = 4 instance, 25 the generic one."""
    _need_card()
    from spark_rapids_tpu_torch.kernels import join as join_k
    rng = np.random.default_rng(k)
    bt = join_k.build(_probe_keys(rng, 40_000, 13, 2, 0.05)[:k])
    assert bt.index.rows.shape == (40_000, k + 1)
    words = _probe_keys(rng, 30_000, 13, 2, 0.05)[:k]
    live = torch.from_numpy(rng.random(30_000) < 0.8).cuda()
    rank = list(range(0, k, 2))
    lo, cnt = cuda_ops.join_probe(bt.sorted_words, words, live, rank,
                                  bt.index)
    plo, pcnt = cuda_ops.join_probe_plain(bt.sorted_words, words, live, rank)
    assert torch.equal(lo, plo) and torch.equal(cnt, pcnt)
    assert int(cnt.sum()) > 0


@pytest.mark.gpu
def test_join_probe_without_index_builds_one():
    """A call without an index makes one and still launches once."""
    _need_card()
    from spark_rapids_tpu_torch.kernels import join as join_k
    rng = np.random.default_rng(5)
    bt = join_k.build(_probe_keys(rng, 3000, 2, 20, 0.05))
    words = _probe_keys(rng, 4096, 2, 21, 0.05)
    live = torch.ones(4096, dtype=torch.bool, device="cuda")
    before = cuda_ops.LAUNCHES["join_probe"]
    got = cuda_ops.join_probe(bt.sorted_words, words, live, [0, 2])
    assert cuda_ops.LAUNCHES["join_probe"] == before + 1
    want = cuda_ops.join_probe_plain(bt.sorted_words, words, live, [0, 2])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q28", "q65", "q78", "q97"])
def test_tpcds_subquery_queries_on_card_equal_cpu(tpcds7_dir, q):
    """Four of phase 8's queries at scale 0.1 on the card against the port
    on the CPU: a cross join of one-row aggregates (TpuNestedLoopJoin),
    nested derived tables with a non-equi residual, three CTEs with left
    joins and round, and a full outer join of two CTEs."""
    _need_card()
    import sys
    sys.path.insert(0, "benchmarks")
    from tpcds_queries import QUERIES
    out = []
    for device in ("cpu", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 16}), device=device)
        for t in chip_smoke.DS_TABLES + chip_smoke.DS7_TABLES:
            s.read.parquet(f"{tpcds7_dir}/{t}.parquet") \
                .create_or_replace_temp_view(t)
        out.append(s.sql(QUERIES[q]).to_arrow())
    assert out[0].num_rows > 0
    _close_tables(out[1], out[0])


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q9", "q10", "q45", "q69", "q81"])
def test_tpcds_expression_subqueries_on_card_equal_cpu(tpcds7_dir, q):
    """Five of phase 9's queries at scale 0.1 on the card against the
    port on the CPU: fifteen scalar queries in CASE run while the text is
    lowered, three EXISTS (two of them ORed over a union of key sets), an
    IN (query) inside an OR, EXISTS with NOT EXISTS, and a correlated
    scalar over a CTE read twice."""
    _need_card()
    import sys
    sys.path.insert(0, "benchmarks")
    from tpcds_queries import QUERIES
    out = []
    for device in ("cpu", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 16}), device=device)
        for t in chip_smoke.DS_TABLES + chip_smoke.DS7_TABLES:
            s.read.parquet(f"{tpcds7_dir}/{t}.parquet") \
                .create_or_replace_temp_view(t)
        out.append(s.sql(QUERIES[q]).to_arrow())
    assert out[0].num_rows > 0
    _close_tables(out[1], out[0])


def _setop_tables(n=20_000, seed=11):
    """Two tables of one shape: int64 keys, strings with '' and NULL,
    DATE keys with NULLs, doubles."""
    import datetime
    import pyarrow as pa
    out = {}
    for name, s in (("a", seed), ("b", seed + 1)):
        rng = np.random.default_rng(s)
        k = rng.integers(0, 500, n).astype(object)
        k[rng.random(n) < 0.05] = None
        st = rng.choice(np.array(["x", "yy", "", "zzz"], dtype=object), n)
        st[rng.random(n) < 0.05] = None
        days = rng.integers(0, 60, n)
        d = [None if rng.random() < 0.05 else
             datetime.date(2000, 1, 1) + datetime.timedelta(days=int(x))
             for x in days]
        out[name] = pa.table({
            "k": pa.array(list(k), pa.int64()),
            "s": pa.array(list(st), pa.string()),
            "d": pa.array(d, pa.date32()),
            "x": pa.array(rng.random(n) * 100, pa.float64())})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("sql", [
    "select k, s, x from a union all select k, s, x from b",
    "select s, d from a where k < 100 intersect select s, d from b",
    "select distinct k, d from a",
    "select s, count(*) n, sum(x) sx from (select s, x from a union all "
    "select s, x from b) t group by s"])
def test_setops_on_card_equal_cpu(sql):
    """A union, an INTERSECT on a string and a DATE key (null-safe keys
    through B1's exchange and the probe) and a SELECT DISTINCT (an
    aggregate of every column) on the card against the port on the CPU,
    as multisets."""
    _need_card()
    tables = _setop_tables()
    out = []
    for device in ("cpu", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 12}), device=device)
        for name, t in tables.items():
            s.create_dataframe(t, num_partitions=4) \
                .create_or_replace_temp_view(name)
        t = s.sql(sql).to_arrow()
        out.append(t.sort_by([(c, "ascending") for c in t.column_names]))
    assert out[0].num_rows > 0
    _close_tables(out[1], out[0])


def _window_table(n=20_000, seed=5):
    """int64 keys and orders with NULLs and ties, a string and a DATE key
    with NULLs, int64 and double values with NULLs, a unique id."""
    import datetime
    import pyarrow as pa
    rng = np.random.default_rng(seed)

    def nulls(a, share=0.05):
        a = a.astype(object)
        a[rng.random(n) < share] = None
        return list(a)
    d = [None if rng.random() < 0.05 else
         datetime.date(2000, 1, 1) + datetime.timedelta(days=int(x))
         for x in rng.integers(0, 90, n)]
    return pa.table({
        "id": pa.array(rng.permutation(n).astype(np.int64)),
        "k": pa.array(nulls(rng.integers(0, 300, n)), pa.int64()),
        "s": pa.array(nulls(rng.choice(np.array(["x", "yy", "", "zzz"],
                                                dtype=object), n)),
                      pa.string()),
        "d": pa.array(d, pa.date32()),
        "o": pa.array(nulls(rng.integers(0, 200, n)), pa.int64()),
        "v": pa.array(nulls(rng.integers(-1000, 1000, n)), pa.int64()),
        "x": pa.array(nulls(rng.random(n) * 200 - 50), pa.float64())})


@pytest.mark.gpu
@pytest.mark.parametrize("sql", [
    "select id, rank() over (partition by k order by x desc nulls last) a, "
    "dense_rank() over (partition by k order by x desc nulls last) b, "
    "row_number() over (partition by k order by o, id) c, "
    "ntile(3) over (partition by k order by o, id) e, "
    "percent_rank() over (partition by k order by o) f, "
    "cume_dist() over (partition by k order by o) g from t order by id",
    "select id, sum(x) over (partition by s) a, avg(x) over (partition by "
    "s) b, count(*) over (partition by s) c from t order by id",
    "select id, sum(x) over (partition by k order by d, id rows between "
    "unbounded preceding and current row) a, max(x) over (partition by k "
    "order by d, id rows between unbounded preceding and current row) b, "
    "sum(v) over (partition by k order by d, id rows between unbounded "
    "preceding and current row) c from t order by id",
    "select id, sum(x) over (partition by k order by o, id rows between 3 "
    "preceding and 2 following) a, min(v) over (partition by k order by "
    "o, id rows between 3 preceding and 2 following) b, max(x) over "
    "(partition by k order by o, id rows between 1 preceding and "
    "unbounded following) c from t order by id",
    "select id, sum(x) over (partition by s order by o range between 5 "
    "preceding and 5 following) a, count(v) over (partition by s order by "
    "d range between 3 preceding and 3 following) b, min(x) over "
    "(partition by s order by o desc range between 2 preceding and "
    "unbounded following) c, sum(x) over (partition by d order by o) e "
    "from t order by id",
    "select id, lead(s) over (partition by k order by o, id) a, lag(x, 2) "
    "over (partition by k order by o, id) b, max(d) over (partition by k) "
    "c from t order by id",
    "select id, rank() over (order by o desc nulls last) a, row_number() "
    "over (partition by s order by id) b from t order by id"])
def test_windows_on_card_equal_cpu(sql):
    """Window functions on the card against the port on the CPU (integers
    bit for bit, floats within 1e-12): ranks, whole-partition, running,
    bounded and RANGE frames over int, string and DATE keys, lead and
    lag, a window without PARTITION BY and two of mixed keys; the card
    gives the same bytes twice."""
    _need_card()
    t = _window_table()
    out = []
    for device in ("cpu", "cuda", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 12}), device=device)
        s.create_dataframe(t, num_partitions=4) \
            .create_or_replace_temp_view("t")
        out.append(s.sql(sql).to_arrow())
    assert out[0].num_rows == t.num_rows
    _close_tables(out[1], out[0])
    assert chip_smoke.same_bytes(out[1], out[2])


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q12", "q47", "q51", "q63"])
def test_tpcds_windows_on_card_equal_cpu(tpcds7_dir, q):
    """Four of phase 11's queries at scale 0.1 on the card against the
    port on the CPU: a class's revenue share, a mean and a rank over two
    specs, q51's running sums and maxima over a full outer join, and a
    window over B2's aggregate."""
    _need_card()
    import sys
    sys.path.insert(0, "benchmarks")
    from tpcds_queries import QUERIES
    out = []
    for device in ("cpu", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 16}), device=device)
        for t in chip_smoke.DS_TABLES + chip_smoke.DS7_TABLES:
            s.read.parquet(f"{tpcds7_dir}/{t}.parquet") \
                .create_or_replace_temp_view(t)
        out.append(s.sql(QUERIES[q]).to_arrow())
    assert out[0].num_rows > 0
    _close_tables(out[1], out[0])
