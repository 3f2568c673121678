"""The port on a CUDA device: kernels against their plain versions, the
headline query against numpy, and the memory tiers (a round trip through
pinned host and disk, a real OOM answered by the retry).

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
    (("fmin64", "fmax64", "first", "last"), 1 << 20, 4096, False, 0),
    (("fmin", "first_all", "last_all", "fmin64"), 50_003, 512, False, 1),
    (("fmin64", "last", "first_all"), 1 << 20, 1 << 14, False, 0),
    (("fmin64", "first", "count"), 100_001, 60_000, True, 0),
], ids=["partial", "final", "variable", "ysplit", "chunks", "unaligned",
        "min_first_last", "min_unaligned", "min_ysplit", "min_chunks"])
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
    before = dict(cuda_ops.LAUNCHES)
    got = cuda_ops.table_stage(bucket, table, cols)
    assert cuda_ops.LAUNCHES["table_reduce"] == before["table_reduce"] + 1
    for name, ks in (("table_reduce_min", ("fmin64", "fmin")),
                     ("table_reduce_firstlast", ("first", "last"))):
        assert cuda_ops.LAUNCHES[name] - before[name] == \
            any(c.kind in ks for c in cols)
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
    # every kernel of the headline's path: B1, B2 and the probe (B2's min
    # and first/last kinds are not on it)
    assert all(cuda_ops.LAUNCHES[k] > 0 for k in (
        "hash_partition_ids", "table_reduce", "join_probe"))
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
    """A card and a CPU session that plan the static shuffled join (AQE
    off; ``test_adaptive_join_on_card_equals_cpu`` runs the adaptive
    one)."""
    from spark_rapids_tpu_torch.plan import overrides
    monkeypatch.setattr(overrides, "BROADCAST_ROW_THRESHOLD", 1000)
    conf = TpuConf({"spark.rapids.tpu.sql.batchSizeRows": 1 << 15,
                    "spark.rapids.tpu.sql.adaptive.enabled": False,
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
    version, ``kernels/join.bounds``; one launch per call."""
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


def _slice12_table(n=20_000, seed=12):
    """Doubles with NaN, infinities and values past int32 and int64,
    int64s past int32, BOOL, DATEs from 1899 to 2101 across leap years,
    string, int32 and int64 keys with NULLs, int64 values with NULLs."""
    import datetime
    import pyarrow as pa
    rng = np.random.default_rng(seed)

    def nulls(a, share=0.05):
        a = a.astype(object)
        a[rng.random(n) < share] = None
        return list(a)
    x = rng.random(n) * 4e10 - 2e10
    x[rng.random(n) < 0.02] = np.nan
    x[rng.random(n) < 0.01] = np.inf
    x[rng.random(n) < 0.01] = -1e19
    d = [None if rng.random() < 0.05 else
         datetime.date(1899, 1, 1) + datetime.timedelta(days=int(v))
         for v in rng.integers(0, 74_000, n)]
    return pa.table({
        "id": pa.array(rng.permutation(n).astype(np.int64)),
        "x": pa.array(nulls(x), pa.float64()),
        "i": pa.array(nulls(rng.integers(-2**40, 2**40, n)), pa.int64()),
        "b": pa.array(nulls(rng.random(n) < 0.5), pa.bool_()),
        "d": pa.array(d, pa.date32()),
        "s": pa.array(nulls(rng.choice(np.array(["x", "yy", "", "zzz"],
                                                dtype=object), n)),
                      pa.string()),
        "h": pa.array(nulls(rng.integers(0, 5, n)), pa.int32()),
        "k": pa.array(nulls(rng.integers(0, 300, n)), pa.int64()),
        "v": pa.array(nulls(rng.integers(-1000, 1000, n)), pa.int64())})


@pytest.mark.gpu
@pytest.mark.parametrize("sql", [
    "select id, cast(x as int) a, cast(x as bigint) b, cast(i as int) c, "
    "cast(x as float) e, cast(i as double) f, cast(b as int) g, "
    "cast(x as boolean) h, cast(v as double) / 7 r from t order by id",
    "select id, year(d) a, month(d) b, day(d) c, quarter(d) e, "
    "dayofweek(d) f, weekday(d) g, dayofyear(d) h, last_day(d) l, "
    "datediff(d, date '1970-01-01') m, d + interval 45 days n, "
    "date_sub(d, 400) o, d - h p from t order by id",
    "select id from t where d between date '1999-12-01' and "
    "date '1999-12-01' + interval 90 days order by id",
    "select s, h, sum(v) sv, count(*) n, avg(x) ax, grouping(s) gs, "
    "grouping(s) + grouping(h) lvl from t group by rollup(s, h) "
    "order by lvl, s, h",
    "select h, k % 3 m, count(*) n, max(v) mv from t group by "
    "cube(h, k % 3) order by h, m",
    "select s, h, sum(v) sv from t group by grouping sets ((s, h), s, ()) "
    "order by s, h",
    "select count(distinct k) dk, sum(v) sv, count(*) n from t",
    "select h, count(distinct k) dk, sum(distinct k) sd, avg(x) ax, "
    "count(v) cv from t group by h order by h",
    "select s, avg(distinct v) av, max(x) mx from t group by s order by s"])
def test_slice12_on_card_equal_cpu(sql):
    """Casts, DATE functions and intervals, ROLLUP / CUBE / GROUPING SETS
    (an Expand under B2's or the sort path's partial aggregate and B1's
    exchange) and DISTINCT aggregates (two stacked aggregates) on the
    card against the port on the CPU (integers bit for bit, floats within
    1e-12); the card gives the same bytes twice."""
    _need_card()
    t = _slice12_table()
    out = []
    for device in ("cpu", "cuda", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 12}), device=device)
        s.create_dataframe(t, num_partitions=4) \
            .create_or_replace_temp_view("t")
        out.append(s.sql(sql).to_arrow())
    assert out[0].num_rows > 0
    assert chip_smoke.same_bytes(out[1], out[2])
    # subtotals tie in ORDER BY with NULL keys of the data: as multisets
    _close_tables(*[o.sort_by([(c, "ascending") for c in o.column_names])
                    for o in out[1::-1]])


@pytest.mark.gpu
@pytest.mark.parametrize("sql", [
    "select h, min(x) mn, max(x) mx, min(i) mi, min(d) md, first(v) fv, "
    "last(i) li, count(*) n from t group by h order by h",
    "select s, min(s) ms, min(x) mn, first(b) fb, last(d) ld from t "
    "group by s order by s",
    "select id, sqrt(abs(x)) a, ln(abs(i) + 1) b, floor(x / 3) c, "
    "ceil(x) e, signum(v) f, pow(h, 3) g, pmod(v, 7) p, pmod(i, -5) q, "
    "greatest(x, i, v) r, least(v, h) l, nullif(h, 2) n, "
    "if(b, s, 'none') o, isnan(x) w, nanvl(x, 0.0) y, hash(i, s, d) z, "
    "case when h = 1 then s end cs from t order by id"])
def test_slice13_on_card_equal_cpu(sql):
    """Grouped min, first and last (an integer key on B2's min and
    first/last kinds, a string key on the sort path) and the function
    library on the card against the port on the CPU (one partition: first
    and last follow its order); the card gives the same bytes twice."""
    _need_card()
    t = _slice12_table()
    out = []
    before = dict(cuda_ops.LAUNCHES)
    for device in ("cpu", "cuda", "cuda"):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 12}), device=device)
        s.create_dataframe(t).create_or_replace_temp_view("t")
        out.append(s.sql(sql).to_arrow())
    assert out[0].num_rows > 0
    assert chip_smoke.same_bytes(out[1], out[2])
    _close_tables(out[1], out[0])
    if sql.startswith("select h,"):
        for name in ("table_reduce_min", "table_reduce_firstlast"):
            assert cuda_ops.LAUNCHES[name] > before[name]


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q5", "q16", "q22", "q67", "q75"])
def test_tpcds_slice12_on_card_equal_cpu(tpcds7_dir, q):
    """Five of phase 12's queries at scale 0.1 on the card against the
    port on the CPU: a channel rollup over a union, a DISTINCT count
    under EXISTS and NOT EXISTS, a four-key rollup of averages, q67's
    eight-key rollup ranked per category, and q75's CASTs."""
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


def _tier_table(n=50_000, seed=3):
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    d = rng.normal(size=n)
    d[::7] = np.nan
    d[3::11] = -0.0
    return pa.table({
        "i": pa.array(rng.integers(-10**12, 10**12, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "d": pa.array(d, pa.float64()),
        "b": pa.array(rng.random(n) < 0.5),
        "s": pa.array([None if i % 13 == 0 else "ä" * (i % 9)
                       for i in range(n)], pa.string()),
    })


def _buffers(batch):
    out = []
    for c in batch.columns:
        bufs = [c.data, c.validity] + ([c.offsets] if hasattr(c, "offsets")
                                       else [])
        out += [b.cpu().contiguous().view(torch.uint8).numpy().tobytes()
                for b in bufs]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("host_limit", [1 << 40, 0])
def test_memory_tiers_round_trip_on_card(tmp_path, host_limit):
    """A CUDA batch through pinned host (and disk) and back, bit for bit;
    a slice of the spilled batch uploads alone."""
    _need_card()
    from spark_rapids_tpu_torch.columnar.arrow import from_arrow
    from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                       StorageTier)
    from spark_rapids_tpu_torch.memory.spillable import SpillableBatch
    cat = BufferCatalog.reset(spill_dir=str(tmp_path), host_limit=host_limit)
    batch = from_arrow(_tier_table(), "cuda")
    want = _buffers(batch)
    sb = SpillableBatch(batch, catalog=cat)
    del batch
    cat.spill_device_to_fit(cat.device_limit)
    e = cat._entries[sb.buffer_id]
    assert e.tier == (StorageTier.DISK if host_limit == 0
                      else StorageTier.HOST)
    if host_limit:
        assert all(b.is_pinned() for b in e.host.buffers)
    part = sb.materialize_slice(1000, 3000)
    assert cat.tier(sb.buffer_id) == e.tier and part.device.type == "cuda"
    assert _buffers(part.slice(0, 2000))[::2] == \
        _buffers(from_arrow(_tier_table().slice(1000, 2000), "cuda")
                 .slice(0, 2000))[::2]
    got = sb.materialize()
    assert got.device.type == "cuda" and _buffers(got) == want
    sb.close()
    assert cat.stats()["num_buffers"] == 0


@pytest.mark.gpu
def test_real_device_oom_is_answered_by_oom_retry(tmp_path):
    """Under a per-process memory fraction of 2 GiB, a spillable filler
    holds 1.2 GiB; an upload of 1 GiB, 1.125 GiB with its validity,
    raises the allocator's real ``OutOfMemoryError`` on its own, and
    through ``oom_retry`` spills the filler and succeeds."""
    _need_card()
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.arrow import _from_arrow
    from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                       StorageTier)
    from spark_rapids_tpu_torch.memory.pressure import oom_retry
    from spark_rapids_tpu_torch.memory.spillable import SpillableBatch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allowed = 2 << 30
    torch.cuda.set_per_process_memory_fraction(
        allowed / torch.cuda.mem_get_info()[1])
    cat = BufferCatalog.reset(spill_dir=str(tmp_path))
    try:
        n = allowed * 6 // 10 // 9
        sb = SpillableBatch(ColumnarBatch(
            Schema([Field("f", T.INT64)]),
            [Column(T.INT64, torch.zeros(n, dtype=torch.int64,
                                         device="cuda"),
                    torch.ones(n, dtype=torch.bool, device="cuda"))], n),
            catalog=cat)
        big = pa.table({"x": np.arange(1 << 27, dtype=np.int64)})
        with pytest.raises(torch.cuda.OutOfMemoryError):
            _from_arrow(big, "cuda")
        got = oom_retry(_from_arrow, big, "cuda")
        assert got.num_rows == big.num_rows
        assert cat.tier(sb.buffer_id) == StorageTier.HOST
        assert cat.oom_retries == 1
        del got
        sb.close()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("dim", list(chip_smoke.STAR_BUILDS))
def test_direct_probe_kernel_matches_plain(dim):
    """The direct-address probe at the star joins' four dimensions (a
    store_sales batch against the dimension's keys): one launch, bit for
    bit equal to ``direct_probe_plain`` and to the search's (lo, counts)."""
    _need_card()
    bt, words, live, rank, dt, key, rows = chip_smoke.star_direct_inputs(
        np.random.default_rng(3), dim)
    args = (key.data, key.validity, rows, dt.smin, dt.smax, dt.hist,
            dt.excl, dt.nnull, dt.nvalid)
    before = cuda_ops.LAUNCHES["direct_probe"]
    lo, cnt = cuda_ops.direct_probe(*args)
    assert cuda_ops.LAUNCHES["direct_probe"] == before + 1
    plo, pcnt = cuda_ops.direct_probe_plain(*args)
    slo, scnt = cuda_ops.join_probe(bt.sorted_words, words, live, rank,
                                    bt.index)
    assert torch.equal(lo, plo) and torch.equal(cnt, pcnt)
    assert torch.equal(lo, slo) and torch.equal(cnt, scnt)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int64", "int32", "date"])
@pytest.mark.parametrize("count_on", ["host", "device"])
def test_direct_probe_edges_match_search(kind, count_on):
    """Null, negative, absent and out-of-range keys and dead rows: the
    kernel's (lo, counts) equal the search's over the same build, with
    the live count on the host or on the card."""
    _need_card()
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.arrow import from_arrow
    from spark_rapids_tpu_torch.kernels import canon
    from spark_rapids_tpu_torch.kernels import join as join_k
    rng = np.random.default_rng(5)

    def keys(n, wider):
        k = rng.integers(-700 - wider, 500 + wider, n)
        mask = rng.random(n) < 0.1
        if kind == "int64":
            return pa.array(k, mask=mask)
        arr = pa.array(k.astype(np.int32), mask=mask)
        return arr.cast(pa.date32()) if kind == "date" else arr
    build = from_arrow(pa.table({"k": keys(5000, 0)}), "cuda")
    bt = join_k.build(canon.column_key_words(build.columns[0],
                                             build.live_mask()))
    dt = join_k.direct_tables(build.columns[0], build.num_rows)
    probe = from_arrow(pa.table({"k": keys(300_000, 40)}), "cuda")
    rows = probe.num_rows - 1000
    live = torch.arange(probe.capacity, device="cuda") < rows
    words = canon.column_key_words(probe.columns[0], live)
    if count_on == "device":
        rows = torch.tensor(rows, device="cuda")
    before = cuda_ops.LAUNCHES["direct_probe"]
    got = join_k.direct_counts(dt, probe.columns[0], rows)
    assert cuda_ops.LAUNCHES["direct_probe"] == before + 1
    want = join_k.probe_counts(bt, words, live, [0])
    assert torch.equal(got.lo, want.lo) and torch.equal(got.counts,
                                                        want.counts)


@pytest.mark.gpu
def test_broadcast_join_probes_directly_on_card():
    """A broadcast join whose stream partition reaches 1<<19 rows of
    capacity launches the direct probe, and its rows equal the CPU's."""
    _need_card()
    import pyarrow as pa
    from spark_rapids_tpu_torch.api import functions as F
    rng = np.random.default_rng(8)
    stream = pa.table({"k": rng.integers(-50, 2000, 1 << 20),
                       "v": rng.random(1 << 20)})
    dim = pa.table({"dk": np.arange(0, 1800, 3), "w": rng.random(600)})

    def rows(device):
        s = TpuSession(TpuConf(), device=device)
        a, b = s.create_dataframe(stream, 2), s.create_dataframe(dim)
        return a.join(b, a["k"] == b["dk"], "inner").group_by("dk").agg(
            F.count().alias("n"), F.sum("v").alias("sv")).to_arrow() \
            .sort_by("dk").to_pylist()
    cuda_ops.reset_launches()
    got = rows("cuda")
    assert cuda_ops.LAUNCHES["direct_probe"] > 0
    assert cuda_ops.LAUNCHES["join_probe"] == 0
    want = rows("cpu")
    assert [r["n"] for r in got] == [r["n"] for r in want]
    assert np.allclose([r["sv"] for r in got], [r["sv"] for r in want],
                       rtol=1e-9, atol=0)


def _skewed_join(session, how):
    """Half of the left side's 200,000 rows share the key (7, 0), which
    three right rows hold; the other keys are drawn over 60,000."""
    import pyarrow as pa
    rng = np.random.default_rng(12)

    def side(n, prefix, hot):
        k, k2 = rng.integers(0, 60_000, n), rng.integers(0, 3, n)
        k[:hot], k2[:hot] = 7, 0
        return session.create_dataframe(pa.table({
            f"{prefix}k": k, f"{prefix}k2": k2, f"{prefix}v": rng.random(n),
            f"{prefix}i": np.arange(n, dtype=np.int32)}), num_partitions=2)
    a, b = side(200_000, "l", 100_000), side(80_000, "r", 3)
    return a.join(b, (a["lk"] == b["rk"]) & (a["lk2"] == b["rk2"]), how)


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left", "full", "semi"])
def test_adaptive_join_on_card_equals_cpu(monkeypatch, how):
    """The adaptive join on the card, shuffled with its skewed partition
    split into slices (a one-byte target and threshold; a full join is
    never split), equals the port's CPU run row by row."""
    _need_card()
    card, cpu = _sessions(monkeypatch, {
        "spark.rapids.tpu.sql.adaptive.enabled": True,
        "spark.rapids.tpu.sql.adaptive.autoBroadcastJoinBytes": 1,
        "spark.rapids.tpu.sql.adaptive.targetPartitionBytes": 1,
        "spark.rapids.tpu.sql.adaptive.skewedPartitionThresholdBytes": 1,
        "spark.rapids.tpu.sql.adaptive.skewedPartitionFactor": 1.5})
    got = _skewed_join(card, how).to_arrow()
    join = chip_smoke._find(card.last_physical_plan,
                            "TpuAdaptiveShuffledJoin")[0]
    assert join.strategy == "shuffled"
    assert bool(join.splits) == (how != "full")
    assert got.num_rows > 100_000
    assert got.equals(_skewed_join(cpu, how).to_arrow())


# -- DECIMAL64 (phase 16) ---------------------------------------------------

def _decimal_column(rng, n, lo, hi, scale, device="cuda", null_frac=0.1):
    """A decimal(12, scale) column of unscaled ints in [lo, hi) with
    NULLs, on ``device``."""
    data = torch.from_numpy(rng.integers(lo, hi, n)).to(device)
    valid = torch.from_numpy(rng.random(n) >= null_frac).to(device)
    return Column(T.DecimalType(12, scale), data, valid)


@pytest.mark.gpu
@pytest.mark.parametrize("n,table", [(1 << 20, 4096), (50_003, 512)])
def test_table_stage_decimal_key_and_minmax_match_plain(n, table):
    """B2 with a DECIMAL group key (its unscaled int64's order word, packed
    by ``table_bucket``) and DECIMAL min / max (the reference's
    ``iminmax``: ``fmin64`` / ``fmax64`` over the unscaled values): one
    launch, every table bit for bit equal to ``table_stage_plain``."""
    _need_card()
    from spark_rapids_tpu_torch.kernels import aggregate as agg_k
    from spark_rapids_tpu_torch.kernels import canon
    rng = np.random.default_rng(n)
    key = _decimal_column(rng, n, -200, table - 300, 2)
    live = torch.arange(n, device="cuda") < n - 7
    bucket, fit, _, _ = agg_k.table_bucket(canon.value_words(key), [
        key.validity], live, table)
    assert bool(fit)
    vals = _decimal_column(rng, n, -10 ** 12, 10 ** 12, 4)
    cols = [cuda_ops.StageCol("count")]
    for kind in ("fmin64", "fmax64", "first"):
        sc, ok = TpuHashAggregate._stage_col(kind, vals, live)
        assert bool(ok)
        cols.append(sc)
    before = dict(cuda_ops.LAUNCHES)
    got = cuda_ops.table_stage(bucket, table, cols)
    assert cuda_ops.LAUNCHES["table_reduce"] == before["table_reduce"] + 1
    assert cuda_ops.LAUNCHES["table_reduce_min"] == \
        before["table_reduce_min"] + 1
    want = cuda_ops.table_stage_plain(bucket, table, cols)
    for c, g, w in zip(cols, got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b), c.kind
    # a DECIMAL past 2^48 leaves the max word's exact range: sort path
    big = Column(vals.dtype, vals.data * 10 ** 4, vals.validity)
    assert not bool(TpuHashAggregate._stage_col("fmax64", big, live)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("count_on", ["host", "device"])
def test_direct_probe_decimal_key_matches_plain_and_search(count_on):
    """``direct_probe`` on a DECIMAL key (its unscaled int64s, with
    NULLs, negatives and keys outside the build): one launch, equal to
    ``direct_probe_plain`` and to the search's (lo, counts)."""
    _need_card()
    from spark_rapids_tpu_torch.kernels import canon
    from spark_rapids_tpu_torch.kernels import join as join_k
    rng = np.random.default_rng(12)
    build = _decimal_column(rng, 5000, -70_000, 50_000, 2)
    blive = torch.ones(5000, dtype=torch.bool, device="cuda")
    bt = join_k.build(canon.column_key_words(build, blive))
    dt = join_k.direct_tables(build, 5000)
    assert dt is not None and dt.smin < 0
    probe = _decimal_column(rng, 1 << 19, -74_000, 54_000, 2)
    rows = (1 << 19) - 1000
    live = torch.arange(1 << 19, device="cuda") < rows
    words = canon.column_key_words(probe, live)
    if count_on == "device":
        rows = torch.tensor(rows, device="cuda")
    before = cuda_ops.LAUNCHES["direct_probe"]
    got = join_k.direct_counts(dt, probe, rows)
    assert cuda_ops.LAUNCHES["direct_probe"] == before + 1
    plo, pcnt = cuda_ops.direct_probe_plain(
        probe.data, probe.validity, rows, dt.smin, dt.smax, dt.hist,
        dt.excl, dt.nnull, dt.nvalid)
    want = join_k.probe_counts(bt, words, live, [0])
    assert torch.equal(got.lo, plo) and torch.equal(got.counts, pcnt)
    assert torch.equal(got.lo, want.lo) and torch.equal(got.counts,
                                                        want.counts)


@pytest.mark.gpu
def test_decimal_queries_on_card_equal_cpu():
    """A DECIMAL group key with DECIMAL min and max behind an exchange
    (B2's table core), and a semi join on one DECIMAL key with a DECIMAL
    sum (the sort path), on the card: B1, B2 and ``direct_probe`` launch,
    and the rows equal the CPU's bit for bit."""
    _need_card()
    import pyarrow as pa
    rng = np.random.default_rng(16)
    n = 1 << 20
    cents = rng.integers(0, 20_000, n)
    fact = pa.table({
        "price": chip_smoke.decimal128_array(cents, 7, 2),
        "band": chip_smoke.decimal128_array(cents // 100, 7, 0),
        "profit": chip_smoke.decimal128_array(
            rng.integers(-10 ** 8, 10 ** 8, n), 7, 2)})
    dim = pa.table({"p": chip_smoke.decimal128_array(
        rng.choice(20_000, 3000, replace=False), 7, 2)})

    def run(device):
        s = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                1 << 19}), device=device)
        # two partitions of 1<<19 rows: each streams the direct probe's
        # least capacity (kernels/join.DIRECT_MIN_STREAM)
        s.create_dataframe(fact, 2).create_or_replace_temp_view("f")
        s.create_dataframe(dim).create_or_replace_temp_view("d")
        cuda_ops.reset_launches()
        agg = s.sql("select band, count(*) c, min(profit) lo, max(profit) "
                    "hi from f group by band order by band").to_arrow()
        semi = s.sql("select count(*) c, sum(profit) s from f where price "
                     "in (select p from d)").to_arrow()
        return agg, semi, dict(cuda_ops.LAUNCHES)
    agg, semi, launches = run("cuda")
    for name in ("hash_partition_ids", "table_reduce", "table_reduce_min",
                 "direct_probe"):
        assert launches[name] > 0, name
    cagg, csemi, _ = run("cpu")
    assert agg.equals(cagg) and semi.equals(csemi)
    assert str(agg.schema.field("lo").type) == "decimal128(7, 2)"
    assert str(semi.schema.field("s").type) == "decimal128(17, 2)"


# -- slice 16: LIKE and the casts between floats and strings ------------------

def _text_column(strings, device):
    """(offsets int32, data uint8, valid bool) of Python strings (None a
    null row) on ``device``."""
    raw = [b"" if s is None else s.encode() for s in strings]
    offs = np.zeros(len(raw) + 1, np.int32)
    offs[1:] = np.cumsum([len(r) for r in raw])
    data = np.frombuffer(b"".join(raw) or b"\0", np.uint8).copy()
    valid = np.array([s is not None for s in strings])
    return (torch.from_numpy(offs).to(device),
            torch.from_numpy(data).to(device),
            torch.from_numpy(valid).to(device))


def _float_strings(rng, n):
    """Texts of numbers as casts meet them: shortest reprs of random bit
    patterns, long digit strings, halfway cases, Java's forms and junk."""
    bits = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    xs = bits.view(np.float64)
    out = []
    for i, x in enumerate(xs.tolist()):
        k = i % 6
        if k == 0:
            out.append(repr(x))
        elif k == 1:
            digits = "".join(map(str, rng.integers(0, 10, rng.integers(
                1, 40))))
            out.append(f"{digits[:3]}.{digits[3:]}e{rng.integers(-340, 320)}")
        elif k == 2:
            # halfway between two doubles, written out in full
            import decimal
            decimal.getcontext().prec = 800
            a = abs(x) if np.isfinite(x) else 1.0
            b = float(np.nextafter(a, np.inf))
            h = (decimal.Decimal(a) + decimal.Decimal(b)) / 2
            out.append(format(h, "e"))
        elif k == 3:
            out.append(["NaN", " -Infinity ", "inf", "1.5d", "+.5", "5.",
                        "1e", "abc", "", "0x10", "1_0", "-0.0"][i % 12])
        elif k == 4:
            out.append(repr(float(np.float32(x))) if np.isfinite(
                np.float32(x)) else "1.0")
        else:
            out.append(None if i % 12 == 5 else f" {x:.17g} ")
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("f32", [False, True], ids=["double", "float"])
def test_format_double_kernel_matches_plain(f32):
    """The shortest digits on the card equal ``float.__repr__``'s (and
    numpy's float32 repr's) bit for bit, subnormals included."""
    _need_card()
    rng = np.random.default_rng(16)
    n = 200_000
    if f32:
        x = rng.integers(0, 2**32 - 1, n, dtype=np.uint32,
                         endpoint=True).view(np.float32)
    else:
        x = rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                         endpoint=True).view(np.float64)
        x[:1000] = np.arange(1, 1001) * 5e-324
    x[1000:1010] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e7, 1e16, 0.285,
                    1.005, 1e-3]
    t = torch.from_numpy(x.copy())
    cuda_ops.reset_launches()
    digits, exp10 = cuda_ops.format_double(t.cuda())
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["format_double"] == 1
    want_d, want_e = cuda_ops.format_double_plain(t)
    assert torch.equal(digits.cpu(), want_d)
    assert torch.equal(exp10.cpu(), want_e)


@pytest.mark.gpu
@pytest.mark.parametrize("f32", [False, True], ids=["double", "float"])
def test_parse_double_kernel_matches_plain(f32):
    """Every text reads to the plain version's value bit for bit (Python's
    correctly rounded ``float``), the rows past 19 digits and the
    halfway cases included, and the same rows are numbers."""
    _need_card()
    rng = np.random.default_rng(17)
    strings = _float_strings(rng, 60_000)
    cols = _text_column(strings, "cpu")
    cuda_ops.reset_launches()
    got, ok = cuda_ops.parse_double(*[c.cuda() for c in cols], f32)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["parse_double"] == 1
    want, want_ok = cuda_ops.parse_double_plain(*cols, f32)
    assert torch.equal(ok.cpu(), want_ok)
    view = torch.int32 if f32 else torch.int64
    g = torch.where(ok.cpu(), got.cpu().view(view), 0)
    w = torch.where(want_ok, want.view(view), 0)
    nan = torch.isnan(want)
    assert torch.equal(g[~nan], w[~nan])
    assert torch.isnan(got.cpu()[nan & want_ok]).all()


@pytest.mark.gpu
def test_like_match_kernel_matches_plain():
    """Random patterns of ``%``, ``_``, escapes and multi-byte characters
    over strings drawn from the same alphabet match as the plain
    version does."""
    _need_card()
    rng = np.random.default_rng(18)
    alphabet = ["a", "b", "é", "%", "_", "ü", "x"]
    strings = ["".join(rng.choice(alphabet, rng.integers(0, 12)))
               if i % 17 else None for i in range(20_000)]
    cols = _text_column(strings, "cpu")
    dev = [c.cuda() for c in cols]
    for _ in range(25):
        pat = "".join(rng.choice(["a", "b", "é", "%", "_", "\\%", "\\_",
                                  "x"], rng.integers(0, 7)))
        tokens = cuda_ops.like_tokens(pat)
        got = cuda_ops.like_match(*dev, tokens)
        want = cuda_ops.like_match_plain(*cols, tokens)
        assert torch.equal(got.cpu(), want), pat


@pytest.mark.gpu
def test_string_functions_on_card_equal_cpu():
    """The string library, LIKE and the casts to and from STRING through
    SQL on the card give the CPU's rows, and launch the new kernels."""
    _need_card()
    import pyarrow as pa
    rng = np.random.default_rng(19)
    n = 50_000
    words = np.array(["special", "requests", "fur", "furious", "ly", "the",
                      "é", "  ", "x_y", "12", "-3.5", "2020-01-05"])
    text = [" ".join(rng.choice(words, rng.integers(1, 6))) for _ in
            range(n)]
    t = pa.table({"s": text,
                  "x": rng.standard_normal(n) * 10.0 ** rng.integers(
                      -8, 12, n),
                  "k": rng.integers(0, 50, n)})
    q = ("select k, count(*) c, sum(length(trim(s))) l, max(reverse(s)) r,"
         " min(replace(s, 'e', 'EE')) rp, max(lpad(s, 9, '*')) lp, "
         "sum(instr(s, 'ly')) i, max(md5(s)) m, sum(case when s like "
         "'%fu_ious%' then 1 else 0 end) lk, max(cast(x as string)) xs, "
         "sum(cast(cast(x as string) as double)) xd, sum(cast(s as "
         "double)) sd, max(initcap(s)) ic, max(concat_ws('|', s, 'z')) cw, "
         "count(cast(s as date)) dt from t group by k order by k")

    def run(device):
        s = TpuSession(device=device)
        s.create_dataframe(t, 2).create_or_replace_temp_view("t")
        cuda_ops.reset_launches()
        return s.sql(q).to_arrow(), dict(cuda_ops.LAUNCHES)
    got, launches = run("cuda")
    for name in ("like_match", "format_double", "parse_double"):
        assert launches[name] > 0, name
    want, _ = run("cpu")
    _close_tables(got, want)


# -- slice 17: like_match over row tiles, parse_double on edge rows ---------

def _like_regex(pattern: str) -> str:
    """A LIKE pattern (escape ``\\``) as a regular expression over the
    decoded text, ``_`` one character."""
    import re
    out, chars = [], iter(pattern)
    for ch in chars:
        if ch == "\\":
            out.append(re.escape(next(chars)))
        else:
            out.append({"%": ".*", "_": "."}.get(ch, re.escape(ch)))
    return "".join(out)


def _slice_column(cols, start, stop):
    """Rows [start, stop) of a text column as views: the offsets no
    longer start at 0 and the bytes stay whole."""
    offs, data, valid = cols
    return offs[start:stop + 1], data, valid[start:stop]


def _tile_strings(case, rng, words, fill, tile_rows, tile_bytes):
    """(strings, sliced rows or None) of one tile case: ``words`` make
    short rows, ``fill(length)`` a row of exactly ``length`` bytes."""
    short = lambda: " ".join(rng.choice(words, rng.integers(0, 7)))
    if case.startswith("n"):
        return [short() for _ in range(int(case[1:]))], None
    if case == "straddle":
        # long rows at every tile's end, so that rows and windows straddle
        return [fill(int(rng.integers(200, 3000))) if i % tile_rows >
                tile_rows - 4 else short() for i in range(5 * tile_rows
                                                          + 37)], None
    if case == "empty_and_null_tile":
        rows = [short() for _ in range(4 * tile_rows)]
        rows[tile_rows:2 * tile_rows] = [None] * tile_rows
        rows[2 * tile_rows:3 * tile_rows] = [""] * tile_rows
        rows[3 * tile_rows + 5:3 * tile_rows + 60] = [""] * 55
        return rows, None
    if case.startswith("budget"):
        # a tile whose span is the staging budget less one, equal or one
        # more, between ordinary tiles
        delta = {"budget_minus": -1, "budget": 0, "budget_plus": 1}[case]
        each = tile_bytes // tile_rows
        big = [fill(each) for _ in range(tile_rows)]
        big[-1] = fill(each + delta)
        return ([short() for _ in range(tile_rows)] + big +
                [short() for _ in range(tile_rows + 9)]), None
    if case == "sliced":
        return [short() for _ in range(3 * tile_rows + 11)], (
            tile_rows // 2 + 3, 3 * tile_rows)
    raise ValueError(case)


TILE_CASES = ["n1", "n255", "n256", "n257", "straddle",
              "empty_and_null_tile", "budget_minus", "budget",
              "budget_plus", "sliced"]

#: LIKE patterns for the tile cases: Q13's and Q16's, a piece whose
#: leftmost match must be passed over, anchored first and last pieces,
#: multi-byte characters under ``_``, and the two 512-token limits
LIKE_TILE_PATTERNS = ["%special%requests%", "%Customer%Complaints%",
                      "a%aab%b", "sp%", "%ts", "sp%_s", "%é_%", "_€%",
                      "%_é%€", "%", "", "%a%b%", "% %",
                      "%" + "a%" * 255 + "b", "_" * 512]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TILE_CASES)
def test_like_match_tiles_match_plain(case):
    """``like_match`` over row tiles staged in shared memory: rows at
    and across tile ends, spans at the staging budget, empty rows, a null
    tile, n around one tile and a sliced column give the plain version's
    answers for every pattern."""
    _need_card()
    rng = np.random.default_rng(171)
    words = np.array(["special", "requests", "Customer", "Complaints",
                      "aab", "a", "b", "é", "€x", "s", "sp", "ts", "aaab"])
    # k bytes, the last two one character
    fill = lambda k: "".join(rng.choice(list("abspt "), k - 2)) + "é"
    strings, sliced = _tile_strings(case, rng, words, fill,
                                    cuda_ops.LIKE_TILE_ROWS,
                                    cuda_ops.LIKE_TILE_BYTES)
    cols = _text_column(strings, "cpu")
    if sliced:
        cols = _slice_column(cols, *sliced)
    dev = [c.cuda() for c in cols]
    if sliced:
        assert int(dev[0][0]) != 0
    cuda_ops.reset_launches()
    for pat in LIKE_TILE_PATTERNS:
        tokens = cuda_ops.like_tokens(pat)
        got = cuda_ops.like_match(*dev, tokens)
        want = cuda_ops.like_match_plain(*cols, tokens)
        assert torch.equal(got.cpu(), want), pat
    assert cuda_ops.LAUNCHES["like_match"] == len(LIKE_TILE_PATTERNS)


@pytest.mark.gpu
def test_like_match_long_rows_and_passed_over_pieces():
    """A 1 MB row among short ones (read where it lies, past the staging
    budget) against ``re``; a piece whose leftmost match must be passed
    over (``a%aab%b`` on ``aaab...b``), anchored pieces and multi-byte
    ``_`` against the plain version."""
    import re
    _need_card()
    rng = np.random.default_rng(172)
    big = "".join(rng.choice(list("ab €é"), 1 << 20))
    big = "special " + big[:len(big) // 2] + " requests" + big[len(big)
                                                                // 2:]
    shorts = ["aaab" + "b" * k for k in range(40)] + [
        "aab", "aaab", "aaabb", "aabab", "ab", "a", "", "aaaab", "aabb",
        "é€é", "ééé", "€", "aéb", "a€b", "special requests", "requests",
        "Customer x Complaints"]
    strings = shorts[:30] + [big] + shorts[30:] + [big[:300000]]
    cols = _text_column(strings, "cpu")
    dev = [c.cuda() for c in cols]
    long_rows = [i for i, s in enumerate(strings) if len(s) > 1000]
    small = [s if len(s) <= 1000 else "" for s in strings]
    small_cols = _text_column(small, "cpu")
    # patterns Python's re matches in linear time on the 1 MB rows
    for pat in ["%special%requests%", "a%aab%b", "%aab%", "aa_b%",
                "%_b", "_é_", "a_b", "%€_é%", "special%", "%requests%b%",
                "%"]:
        tokens = cuda_ops.like_tokens(pat)
        got = cuda_ops.like_match(*dev, tokens).cpu()
        want = cuda_ops.like_match_plain(*small_cols, tokens)
        rx = re.compile(_like_regex(pat), re.DOTALL)
        for i in long_rows:
            want[i] = rx.fullmatch(strings[i]) is not None
        assert torch.equal(got, want), pat
    got = cuda_ops.like_match(*dev, cuda_ops.like_tokens("a%aab%b")).cpu()
    assert not got[strings.index("aaab")] and not got[strings.index("aabab")]
    assert got[strings.index("aaabb")]


def _halfway_texts(rng, n, f32):
    """Texts of numbers exactly halfway between two neighbouring doubles
    (floats), written out in full: every one takes the slow path."""
    import decimal
    decimal.getcontext().prec = 1200
    out = []
    for k in range(n):
        if f32:
            a = float(np.float32(rng.standard_normal() *
                                 10.0 ** rng.integers(-30, 30)))
            b = float(np.nextafter(np.float32(a), np.float32(np.inf)))
        else:
            a = float(rng.standard_normal() * 10.0 ** rng.integers(-300,
                                                                   300))
            b = float(np.nextafter(a, np.inf))
        h = (decimal.Decimal(a) + decimal.Decimal(b)) / 2
        out.append(format(h, "e" if k % 2 else "f"))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("f32", [False, True], ids=["double", "float"])
@pytest.mark.parametrize("case", TILE_CASES + ["all_slow", "long_digits"])
def test_parse_double_edge_rows_match_plain(case, f32):
    """``parse_double`` on n around one block of rows, long rows among
    short ones, runs of rows at 48 bytes each, empty and null runs,
    sliced columns, a block whose every row is a halfway case (the slow
    path in every thread), texts of 20-1,000 digits with whitespace and
    d/F suffixes: bit for bit the plain version's values and the same ok
    rows."""
    _need_card()
    rows = cuda_ops.TEXT_THREADS
    rng = np.random.default_rng(173)
    words = np.array(["1", "2.5", "-0.125", "7e3", "1e-7", ".5", "5.",
                      "3d", "4F", "nan", "-inf", "x"])
    fill = lambda k: ("1." + "".join(map(str, rng.integers(0, 10, k))))[
        :k - 1].rjust(k - 1) + "d"
    if case == "all_slow":
        strings = _halfway_texts(rng, 3 * rows + 5, f32)
        strings = [[s, f" {s}\t", s + "d", "+" + s + "F"][i % 4]
                   for i, s in enumerate(strings)]
        sliced = None
    elif case == "long_digits":
        strings = []
        for k in range(2000):
            nd = int(rng.integers(20, 1001))
            digs = "".join(map(str, rng.integers(0, 10, nd)))
            pt = int(rng.integers(0, nd + 1))
            text = digs[:pt] + "." + digs[pt:]
            text += f"e{rng.integers(-400, 400)}" if k % 3 == 0 else ""
            strings.append([text, f"  {text} ", text + "D", "-" + text +
                            "f"][k % 4])
        sliced = None
    else:
        strings, sliced = _tile_strings(case, rng, words, fill, rows,
                                        rows * 48)
        strings = [None if s is None else s.replace(" ", "") or s
                   for s in strings]
    cols = _text_column(strings, "cpu")
    if sliced:
        cols = _slice_column(cols, *sliced)
    cuda_ops.reset_launches()
    got, ok = cuda_ops.parse_double(*[c.cuda() for c in cols], f32)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["parse_double"] == 1
    want, want_ok = cuda_ops.parse_double_plain(*cols, f32)
    assert torch.equal(ok.cpu(), want_ok)
    view = torch.int32 if f32 else torch.int64
    g = torch.where(ok.cpu(), got.cpu().view(view), 0)
    w = torch.where(want_ok, want.view(view), 0)
    nan = torch.isnan(want)
    assert torch.equal(g[~nan], w[~nan])
    assert torch.isnan(got.cpu()[nan & want_ok]).all()


@pytest.mark.gpu
def test_parse_double_megabyte_rows():
    """Rows of 1 MB, read where they lie: a halfway case padded with a
    million zeros (ties to even) and with a last 1 past them (above the
    halfway point, decided by the digits past the 800 kept), among short
    rows."""
    import decimal
    _need_card()
    decimal.getcontext().prec = 100
    texts = []
    for a in (1.0, 1.0000000000000002, 3.0e-200):
        b = float(np.nextafter(a, np.inf))
        h = format((decimal.Decimal(a) + decimal.Decimal(b)) / 2, "f")
        texts += [h + "0" * (1 << 20), h + "0" * (1 << 20) + "1",
                  " " + h + "0" * 5000 + "1d "]
    strings = ["1.5", "2"] + texts[:4] + ["-3e3"] * 300 + texts[4:]
    cols = _text_column(strings, "cpu")
    got, ok = cuda_ops.parse_double(*[c.cuda() for c in cols])
    want, want_ok = cuda_ops.parse_double_plain(*cols)
    assert torch.equal(ok.cpu(), want_ok) and bool(want_ok.all())
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))
