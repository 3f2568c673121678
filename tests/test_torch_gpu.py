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
        if beyond_f32 and kind != "count":
            assert not bool(fit)
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
