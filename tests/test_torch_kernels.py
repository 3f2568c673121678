"""The port's kernels against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU each wrapper of ``spark_rapids_tpu_torch.kernels.cuda_ops`` runs
its plain torch version; the CUDA kernels themselves are compared with
those plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import dtypes as JT
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.kernels import aggregate as jagg
from spark_rapids_tpu.kernels import basic as jbasic
from spark_rapids_tpu.kernels import canon as jcanon
from spark_rapids_tpu.kernels import pallas_ops as jpallas

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.kernels import aggregate as agg_k
from spark_rapids_tpu_torch.kernels import basic, canon, cuda_ops

NULL_WORD = np.uint64(0x9E3779B97F4A7C15)
U64_EDGES = np.array([0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
                      2**63 + 1, 2**64 - 1, 0xff51afd7ed558ccd], np.uint64)


def _t(u64: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u64.view(np.int64).copy())


def _words(rng, n: int, num_words: int):
    """uint64 key words: random bits (top bit set in about half), the
    edge values, and null rows replaced by the null word."""
    out = []
    for _ in range(num_words):
        w = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
        w[:len(U64_EDGES)] = U64_EDGES
        w[rng.random(n) < 0.1] = NULL_WORD
        out.append(w)
    return out


def _np_mix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(jbasic.M1)
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(jbasic.M2)
        return x ^ (x >> np.uint64(33))


def test_uint64_emulation_matches_numpy():
    rng = np.random.default_rng(1)
    u = np.concatenate([U64_EDGES, rng.integers(0, 2**64 - 1, 5000,
                                                dtype=np.uint64,
                                                endpoint=True)])
    t = _t(u)
    assert np.array_equal(basic.mix64(t).numpy().view(np.uint64),
                          _np_mix64(u))
    assert np.array_equal(basic.srl64(t, 33).numpy().view(np.uint64),
                          u >> np.uint64(33))
    for m in (1, 3, 7, 8, 1000, 2**31 - 1):
        assert np.array_equal(basic.umod64(t, m).numpy(),
                              (u % np.uint64(m)).astype(np.int64))
    other = u[::-1].copy()
    assert np.array_equal(basic.ult64(t, _t(other)).numpy(), u < other)


@pytest.mark.parametrize("n,num_words,num_parts",
                         [(2048, 1, 8), (1000, 2, 7), (1024, 3, 1000),
                          (300, 1, 1)])
def test_hash_partition_ids_matches_reference(n, num_words, num_parts):
    rng = np.random.default_rng(n + num_words)
    words = _words(rng, n, num_words)
    jw = [jnp.asarray(w) for w in words]
    ref_pallas = np.asarray(jpallas.hash_partition_ids(jw, num_parts))
    ref_jnp = np.asarray(jbasic.hash_to_partition(jbasic.hash_words(jw),
                                                  num_parts))
    got = cuda_ops.hash_partition_ids([_t(w) for w in words], num_parts)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref_pallas)
    assert np.array_equal(got.numpy(), ref_jnp)
    h = np.full(n, 42, np.uint64)
    for w in words:
        h = _np_mix64(h ^ w)
    assert np.array_equal(got.numpy(), (h % np.uint64(num_parts))
                          .astype(np.int32))


def _reduce_inputs(rng, n: int, table: int):
    bucket = rng.integers(0, table, n).astype(np.int32)
    bucket[rng.random(n) < 0.2] = table          # dead slot
    bucket[:3] = table - 1                       # a bucket of -inf only
    ones = np.ones(n, np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    vals[bucket == table] = 0.0
    mx = rng.standard_normal(n).astype(np.float32)
    mx[rng.random(n) < 0.3] = -np.inf
    mx[:3] = -np.inf
    mx[bucket == table] = -np.inf
    nan_rows = np.nonzero((bucket == 5))[0][:2]
    mx[nan_rows] = np.nan                        # NaN wins bucket 5
    neg = -rng.random(n).astype(np.float32)
    return bucket, [ones, vals], [mx, neg]


def test_table_reduce_matches_reference():
    rng = np.random.default_rng(3)
    n, table = 3000, 64
    bucket, sums, maxs = _reduce_inputs(rng, n, table)
    js, jm = jpallas.table_reduce(jnp.asarray(bucket),
                                  [jnp.asarray(r) for r in sums],
                                  [jnp.asarray(r) for r in maxs], table,
                                  impl="scatter")
    ps, pm = cuda_ops.table_reduce(torch.from_numpy(bucket),
                                   torch.from_numpy(np.stack(sums)),
                                   torch.from_numpy(np.stack(maxs)), table)
    assert ps.shape == (2, table) and pm.shape == (2, table)
    assert np.array_equal(ps[0].numpy(), np.asarray(js[0]))
    np.testing.assert_allclose(ps[1].numpy(), np.asarray(js[1]), rtol=1e-6,
                               atol=1e-6)
    for i in range(2):
        np.testing.assert_array_equal(pm[i].numpy(), np.asarray(jm[i]))
    assert np.isnan(pm[0, 5].item())
    assert pm[0, table - 1].item() == -np.inf or bool((bucket == table - 1)
                                                      [3:].any())


def test_table_reduce_f64_sum_rows():
    """f64 sum rows (the port's variable-float value sums) reduce in f64:
    against numpy's f64 bincount, with the max rows unchanged."""
    rng = np.random.default_rng(4)
    n, table = 3000, 64
    bucket, sums, maxs = _reduce_inputs(rng, n, table)
    vals = rng.integers(-100_000, 100_000, n) + rng.random(n)
    vals[bucket == table] = 0.0
    s64 = np.stack([sums[0].astype(np.float64), vals])
    ps, pm = cuda_ops.table_reduce(torch.from_numpy(bucket),
                                   torch.from_numpy(s64),
                                   torch.from_numpy(np.stack(maxs)), table)
    assert ps.dtype == torch.float64 and ps.shape == (2, table)
    b = np.where(bucket < table, bucket, table)
    for i in range(2):
        want = np.bincount(b, weights=s64[i], minlength=table + 1)[:table]
        np.testing.assert_allclose(ps[i].numpy(), want, rtol=1e-12,
                                   atol=1e-9)
    _, pm32 = cuda_ops.table_reduce(torch.from_numpy(bucket),
                                    torch.from_numpy(np.stack(sums)),
                                    torch.from_numpy(np.stack(maxs)), table)
    assert torch.equal(pm.nan_to_num(), pm32.nan_to_num())
    assert torch.equal(pm.isnan(), pm32.isnan())


def test_table_reduce_empty_rows_and_checks():
    bucket = torch.tensor([0, 1, 4, 1], dtype=torch.int32)
    sums = torch.ones(1, 4)
    maxs = torch.empty(0, 4)
    s, m = cuda_ops.table_reduce(bucket, sums, maxs, 4)
    assert s.tolist() == [[1.0, 2.0, 0.0, 0.0]] and m.shape == (0, 4)
    with pytest.raises(ValueError):
        cuda_ops.table_reduce(bucket.long(), sums, maxs, 4)
    with pytest.raises(ValueError):
        cuda_ops.table_reduce(bucket, torch.ones(1, 8)[:, ::2], maxs, 4)
    with pytest.raises(ValueError):
        cuda_ops.table_reduce(bucket, sums, maxs.double(), 4)
    with pytest.raises(ValueError):
        cuda_ops.table_reduce(bucket, sums.half(), maxs, 4)
    with pytest.raises(ValueError):
        cuda_ops.hash_partition_ids([torch.ones(4, dtype=torch.int32)], 2)
    with pytest.raises(ValueError):
        cuda_ops.hash_partition_ids([torch.ones(8, dtype=torch.int64)[::2]],
                                    2)


_F64_EDGES = [np.nan, -np.nan, np.float64(np.frombuffer(
    np.uint64(0x7ff0000000000001).tobytes(), np.float64)[0]), -0.0, 0.0,
    np.inf, -np.inf, np.finfo(np.float64).tiny, np.finfo(np.float64).max,
    np.finfo(np.float64).min, 1.0, -1.0, 0.1]


@pytest.mark.parametrize("dtype", ["int64", "int32", "bool", "float64",
                                   "float32"])
def test_value_words_match_reference(dtype):
    rng = np.random.default_rng(5)
    if dtype == "int64":
        info = np.iinfo(np.int64)
        data = np.concatenate([[info.min, info.min + 1, -1, 0, 1, info.max],
                               rng.integers(info.min, info.max, 50)])
    elif dtype == "int32":
        info = np.iinfo(np.int32)
        data = np.concatenate([[info.min, -1, 0, 1, info.max],
                               rng.integers(info.min, info.max, 50)])
    elif dtype == "bool":
        data = rng.random(50) < 0.5
    else:
        data = np.concatenate([np.array(_F64_EDGES),
                               rng.standard_normal(50) * 1e3])
        if dtype == "float32":
            with np.errstate(over="ignore", invalid="ignore"):
                data = data.astype(np.float32)
    data = data.astype(dtype)
    valid = np.ones(len(data), bool)
    jdt = {"int64": JT.INT64, "int32": JT.INT32, "bool": JT.BOOL,
           "float64": JT.FLOAT64, "float32": JT.FLOAT32}[dtype]
    pdt = T.from_numpy(data.dtype)
    jw = jcanon.value_words(JColumn(jdt, jnp.asarray(data),
                                    jnp.asarray(valid)), len(data))
    pw = canon.value_words(Column(pdt, torch.from_numpy(data.copy()),
                                  torch.from_numpy(valid)))
    assert len(jw) == len(pw) == 1
    assert np.array_equal(pw[0].numpy().view(np.uint64),
                          np.asarray(jw[0]).astype(np.uint64))


def test_value_words_keep_subnormals_ordered():
    # XLA:CPU compares subnormals as zero (denormals-are-zero), so the
    # reference's words differ there; the port keeps IEEE order
    data = np.array([-5e-324, -0.0, 0.0, 5e-324])
    w = canon.value_words(Column(T.FLOAT64, torch.from_numpy(data),
                                 torch.ones(4, dtype=torch.bool)))[0]
    u = w.numpy().view(np.uint64)
    assert u[0] < u[1] == u[2] < u[3]


@pytest.mark.parametrize("case", ["fits", "misfit", "two_keys"])
def test_table_bucket_matches_reference(case):
    rng = np.random.default_rng(9)
    n, table = 2000, 4096
    nkeys = 2 if case == "two_keys" else 1
    hi = {"fits": 50, "misfit": 10**9, "two_keys": 20}[case]
    keys = [rng.integers(-hi, hi, n).astype(np.int64) for _ in range(nkeys)]
    valids = [rng.random(n) > 0.05 for _ in range(nkeys)]
    live = rng.random(n) > 0.2
    jw = [jcanon.value_words(JColumn(JT.INT64, jnp.asarray(k),
                                     jnp.asarray(v)), n)[0]
          for k, v in zip(keys, valids)]
    jb, jfit, jmins, jcards = jagg.table_bucket(
        jw, [jnp.asarray(v) for v in valids], jnp.asarray(live), table)
    pw = [canon.value_words(Column(T.INT64, torch.from_numpy(k),
                                   torch.from_numpy(v)))[0]
          for k, v in zip(keys, valids)]
    pb, pfit, pmins, pcards = agg_k.table_bucket(
        pw, [torch.from_numpy(v) for v in valids], torch.from_numpy(live),
        table)
    assert bool(pfit) == bool(jfit) == (case != "misfit")
    assert np.array_equal(pb.numpy(), np.asarray(jb))
    for pm, jm in zip(pmins, jmins):
        assert np.uint64(pm.numpy().view(np.uint64)) == np.uint64(jm)
    assert [int(c) for c in pcards] == [int(c) for c in jcards]
    pres, order, ng = agg_k.table_compact(
        torch.bincount(pb.long(), minlength=table + 1)[:table], table)
    jpres, jorder, jng = jagg.table_compact(
        jnp.bincount(jb, length=table + 1)[:table], table)
    assert int(ng) == int(jng)
    assert np.array_equal(order.numpy()[:int(ng)],
                          np.asarray(jorder)[:int(jng)])


# -- B2 redesigned: the table core's reduce stage ----------------------------

from spark_rapids_tpu.exec import tpu_aggregate as jta  # noqa: E402
from spark_rapids_tpu_torch.exec.tpu_aggregate import \
    TpuHashAggregate  # noqa: E402

_BUDGET = 232_448 - 1024          # the H100's opt-in shared memory


def _stage_values(rng, n, wide=False):
    """f64 values of many magnitudes with NaN, +-inf, -0.0 and f64
    subnormals sprinkled in; ``wide`` adds f32 subnormals and a value
    beyond f32 range, so the batch does not fit the exact-sum window."""
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)
    pick = rng.random(n) < 0.03
    specials = [np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, 1e-310]
    if wide:
        specials += [1e-45, -3e-40]
    v[pick] = rng.choice(np.array(specials), int(pick.sum()))
    if wide:
        v[7] = 1e300
    return v


def _stage_case(rng, n, table, wide=False):
    """Bucket ids with the dead slot and empty buckets, f64 values with
    specials, validity; the fsum64 column through the table core's own
    ``_stage_col`` (its emax and fit flag)."""
    bucket = rng.integers(0, table + 1, n).astype(np.int32)
    bucket[bucket == 3] = 4                       # bucket 3 stays empty
    v = _stage_values(rng, n, wide)
    valid = rng.random(n) > 0.1
    live = torch.from_numpy(bucket < table)
    col = Column(T.FLOAT64, torch.from_numpy(v), torch.from_numpy(valid))
    sc, fit = TpuHashAggregate._stage_col("fsum64", col, live)
    return bucket, v, valid, col, sc, fit


@pytest.mark.parametrize("wide", [False, True], ids=["fits", "wide"])
def test_table_stage_lanes_match_reference(wide):
    """fsum64: the count and flag tables against numpy, the chunk-lane
    table against the reference's ``_part_chunk_rows`` +
    ``jax.ops.segment_sum`` bit for bit, and the fit flag."""
    import jax
    rng = np.random.default_rng(11)
    n, table = 4000, 64
    bucket, v, valid, col, sc, fit = _stage_case(rng, n, table, wide)
    assert bool(fit) == (not wide)
    cnt, nan, pinf, ninf, lanes = cuda_ops.table_stage(
        torch.from_numpy(bucket), table, [sc])[0]
    b = np.where(bucket < table, bucket, table)
    for got, mask in ((cnt, valid), (nan, valid & np.isnan(v)),
                      (pinf, valid & (v == np.inf)),
                      (ninf, valid & (v == -np.inf))):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.bincount(
            b, weights=mask, minlength=table + 1)[:table].astype(np.int32))
    okf = valid & np.isfinite(v)
    vq = np.where(okf, v, 0.0)
    with np.errstate(over="ignore", invalid="ignore"):
        hi = vq.astype(np.float32)
        lo = (vq - hi.astype(np.float64)).astype(np.float32)
    emax = jnp.int32(int(sc.emax))
    rows = [r + s for r, s in zip(
        jta._part_chunk_rows(jnp.asarray(hi), jnp.asarray(okf), emax),
        jta._part_chunk_rows(jnp.asarray(lo), jnp.asarray(okf), emax))]
    ref = jax.ops.segment_sum(jnp.stack(rows, 1), jnp.asarray(b),
                              num_segments=table + 1)[:table]
    assert lanes.shape == (jta.CH_LANES, table)
    assert np.array_equal(lanes.numpy(), np.asarray(ref).T)
    assert not lanes[:, 3].any() and not cnt[3]


def _torch_two_stage_max(v, ok, bucket, table):
    """The table core's earlier exact max in torch: u32 max of the hi
    words, then of the lo words among the hi winners."""
    from spark_rapids_tpu_torch.kernels.aggregate import flip32
    b = torch.where(bucket < table, bucket, table).long()
    v = torch.where(v == 0.0, 0.0, v)
    okn = ok & ~torch.isnan(v)
    hi = v.to(torch.float32)
    lo = torch.where(torch.isfinite(v), v - hi.double(), 0.0).float()
    whi = torch.where(okn, flip32(hi), 0)
    mm1 = torch.zeros(table + 1, dtype=torch.int64).scatter_reduce_(
        0, b, whi, "amax")
    wlo = torch.where(okn & (whi == mm1[b]), flip32(lo), 0)
    mm2 = torch.zeros(table + 1, dtype=torch.int64).scatter_reduce_(
        0, b, wlo, "amax")
    return mm1[:table], mm2[:table]


def test_table_stage_max_word_matches_two_stage_max():
    """fmax64: the u64 max word is the bucket's largest value in float
    order (``flip64``), equal to numpy's max bit for bit; the f32 pair
    (hi, lo) of that value equals the reference's two-stage u32
    ``segment_max`` and the earlier torch two-stage max, which rank the
    rows the same way but keep only the pair; the count and non-NaN
    count against numpy."""
    from spark_rapids_tpu_torch.kernels.aggregate import flip32, unflip64
    import jax
    rng = np.random.default_rng(12)
    n, table = 4000, 64
    bucket, v, valid, col, _, _ = _stage_case(rng, n, table)
    live = torch.from_numpy(bucket < table)
    sc, fit = TpuHashAggregate._stage_col("fmax64", col, live)
    assert bool(fit)
    cnt, nn, word = cuda_ops.table_stage(torch.from_numpy(bucket), table,
                                         [sc])[0]
    b = np.where(bucket < table, bucket, table)
    vz = np.where(v == 0.0, 0.0, v)
    okn = valid & ~np.isnan(vz)
    # the word's value is the bucket's max exactly
    has = np.bincount(b, weights=okn, minlength=table + 1)[:table] > 0
    assert not word.numpy()[~has].any()
    m = unflip64(word)
    want = np.full(table, -np.inf)
    np.maximum.at(want, b[okn & (b < table)], vz[okn & (b < table)])
    assert np.array_equal(m.numpy()[has], want[has])
    # its f32 pair, as the two-stage max words
    hi32 = m.to(torch.float32)
    lo32 = torch.where(torch.isfinite(m), m - hi32.double(), 0.0).float()
    w = ((flip32(hi32) << 32) | flip32(lo32)).numpy().view(np.uint64)
    w[~has] = 0
    assert np.array_equal(nn.numpy(), np.bincount(
        b, weights=okn, minlength=table + 1)[:table])
    assert np.array_equal(cnt.numpy(), np.bincount(
        b, weights=valid, minlength=table + 1)[:table])
    hi = vz.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isfinite(vz), vz - hi.astype(np.float64),
                      0.0).astype(np.float32)
    jb = jnp.asarray(b)
    whi = jnp.where(jnp.asarray(okn), jta._flip32(jnp.asarray(hi)),
                    jnp.uint32(0))
    mm1 = jax.ops.segment_max(whi, jb, num_segments=table + 1)
    win = jnp.asarray(okn) & (whi == jnp.take(mm1, jb))
    mm2 = jax.ops.segment_max(
        jnp.where(win, jta._flip32(jnp.asarray(lo)), jnp.uint32(0)), jb,
        num_segments=table + 1)
    # an empty bucket: the reference's segment_max gives 0 only where a
    # row of value 0 landed, so compare where the bucket has a non-NaN
    assert np.array_equal((w >> np.uint64(32))[has],
                          np.asarray(mm1)[:table][has])
    assert np.array_equal((w & np.uint64(0xFFFFFFFF))[has],
                          np.asarray(mm2)[:table][has])
    assert not w[~has].any()
    t1, t2 = _torch_two_stage_max(col.data, col.validity & live,
                                  torch.from_numpy(bucket), table)
    assert np.array_equal(w >> np.uint64(32), t1.numpy().astype(np.uint64))
    assert np.array_equal(w & np.uint64(0xFFFFFFFF),
                          t2.numpy().astype(np.uint64))


def test_table_stage_other_kinds_match_numpy():
    """count, icount, fsumv and fmax against numpy; raw sum32/sum64/max32
    rows against the reference kernel's ``table_reduce`` (scatter)."""
    rng = np.random.default_rng(13)
    n, table = 3000, 50
    bucket, v, valid, col, _, _ = _stage_case(rng, n, table)
    live = torch.from_numpy(bucket < table)
    ints = rng.integers(-(1 << 40), 1 << 40, n)
    icol = Column(T.INT64, torch.from_numpy(ints), torch.from_numpy(valid))
    cols = [cuda_ops.StageCol("count"),
            TpuHashAggregate._stage_col("count", col, live)[0],
            TpuHashAggregate._stage_col("icount", icol, live)[0],
            TpuHashAggregate._stage_col("fsumv", col, live)[0],
            TpuHashAggregate._stage_col("fmax", col, live)[0]]
    (rows,), (cnt,), (isum,), (vc, vsum), (mc, mnn, mmax) = \
        cuda_ops.table_stage(torch.from_numpy(bucket), table, cols)
    b = np.where(bucket < table, bucket, table)

    def bc(w):
        return np.bincount(b, weights=w, minlength=table + 1)[:table]
    assert np.array_equal(rows.numpy(), bc(np.ones(n)))
    assert np.array_equal(cnt.numpy(), bc(valid))
    assert np.array_equal(vc.numpy(), bc(valid))
    want_i = np.zeros(table + 1, np.int64)
    np.add.at(want_i, b, np.where(valid, ints, 0))
    assert np.array_equal(isum.numpy(), want_i[:table])
    finite = np.isfinite(bc(np.where(valid, v, 0.0)))
    np.testing.assert_allclose(vsum.numpy()[finite],
                               bc(np.where(valid, v, 0.0))[finite],
                               rtol=1e-12, atol=1e-300)
    vz = np.where(v == 0.0, 0.0, v).astype(np.float32)
    okn = valid & ~np.isnan(vz)
    want_m = np.full(table + 1, -np.inf, np.float32)
    np.maximum.at(want_m, b[okn], vz[okn])
    assert np.array_equal(mmax.numpy(), want_m[:table])
    assert np.array_equal(mnn.numpy(), bc(okn))
    # raw rows: the TPU kernel's own function
    f32 = rng.standard_normal((2, n)).astype(np.float32)
    f32[1, ::17] = np.nan
    js, jm = jpallas.table_reduce(jnp.asarray(bucket), [jnp.asarray(f32[0])],
                                  [jnp.asarray(f32[1])], table,
                                  impl="scatter")
    (s32,), (s64,), (m32,) = cuda_ops.table_stage(
        torch.from_numpy(bucket), table,
        [cuda_ops.StageCol("sum32", torch.from_numpy(f32[:1])),
         cuda_ops.StageCol("sum64", torch.from_numpy(f32.astype(
             np.float64))),
         cuda_ops.StageCol("max32", torch.from_numpy(f32[1:]))])
    assert s32.shape == (1, table) and s64.shape == (2, table)
    np.testing.assert_allclose(s32[0].numpy(), np.asarray(js[0]), rtol=1e-5,
                               atol=1e-5)
    for i in range(2):
        np.testing.assert_allclose(s64[i].numpy(),
                                   bc(f32[i].astype(np.float64)),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(m32[0].numpy(), np.asarray(jm[0]))


@pytest.mark.parametrize("kinds,table", [
    (("count", "fsum64", "fmax64"), 4096),
    (("fsum64", "icount", "fmax64"), 4096),
    (("count", "fsumv", "fmax"), 4096),
    (("count", "fsum64", "fmax64"), 1 << 14),
    ((("sum64", 2), "max32"), 60_000),
    ((("sum32", 7),), 4096),
    ((("sum64", 5), ("max32", 1)), 4096),
    (("sum32",) * 7, 4096),
])
def test_stage_plan_packs_within_budget(kinds, table):
    """Every sub-row lands in exactly one group; a group fits the shared
    budget, takes at most STAGE_GROUP_PIECES columns, keeps 64-bit
    sub-rows 8-byte aligned; the headline exact partial needs 2 groups,
    the TPU kernel's raw rows of the headline query one.  A column is a
    kind, or a (raw kind, rows) pair."""
    shapes = [k if isinstance(k, tuple) else (k, 1) for k in kinds]
    plan = cuda_ops.stage_plan(shapes, table, _BUDGET)
    seen = []
    for pieces, nbytes in zip(plan.groups, plan.group_bytes):
        assert len(pieces) <= cuda_ops.STAGE_GROUP_PIECES
        assert nbytes <= _BUDGET
        end = 0
        for col, lo, hi, off in pieces:
            assert off == end and off % 8 == 0
            sub = cuda_ops.sub_bytes(*shapes[col])
            end += sum(sub[lo:hi]) * plan.stride
            seen += [(col, j) for j in range(lo, hi)]
        assert end == nbytes
    assert sorted(seen) == [(c, j) for c, s in enumerate(shapes)
                            for j in range(len(cuda_ops.sub_bytes(*s)))]
    assert plan.chunk <= table and plan.stride % 2 == 0
    assert plan.chunk == table or 8 * plan.stride <= _BUDGET
    if kinds == ("count", "fsum64", "fmax64") and table == 4096:
        assert plan.group_bytes == [196_608, 196_608]
    if shapes in ([("sum32", 7)], [("sum64", 5), ("max32", 1)]):
        assert len(plan.groups) == 1


def test_table_stage_checks_inputs():
    b = torch.zeros(4, dtype=torch.int32)
    v = torch.zeros(4, dtype=torch.float64)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):                  # fsum64 without emax
        cuda_ops.table_stage(b, 4, [cuda_ops.StageCol("fsum64", v, ok)])
    with pytest.raises(ValueError):                  # wrong column dtype
        cuda_ops.table_stage(b, 4, [cuda_ops.StageCol("fsumv", v.float())])
    with pytest.raises(ValueError):                  # unknown kind
        cuda_ops.table_stage(b, 4, [cuda_ops.StageCol("avg", v)])
    with pytest.raises(ValueError):                  # count takes no column
        cuda_ops.table_stage(b, 4, [cuda_ops.StageCol("count", v)])
    with pytest.raises(ValueError):                  # raw rows are [k, n]
        cuda_ops.table_stage(b, 4, [cuda_ops.StageCol("sum64", v)])
    with pytest.raises(ValueError):                  # ... with k >= 1
        cuda_ops.table_stage(b, 4, [cuda_ops.StageCol("sum64", v[None, :0])])
    with pytest.raises(ValueError):                  # raw kinds stand alone
        cuda_ops.table_stage(b, 4, [cuda_ops.StageCol("count"),
                                    cuda_ops.StageCol("sum64", v[None])])


# -- B1 redesigned: the counting-sort split ----------------------------------

def _barrett(h: int, p: int) -> int:
    """The kernels' fast modulo, in Python integers."""
    magic = ((1 << 64) - 1) // p
    r = h - ((h * magic) >> 64) * p
    return r - p if r >= p else r


def test_barrett_modulo_is_exact():
    rng = np.random.default_rng(14)
    hs = [int(x) for x in U64_EDGES] + [int(x) for x in rng.integers(
        0, 2**64 - 1, 2000, dtype=np.uint64, endpoint=True)]
    for p in (1, 2, 3, 7, 8, 1000, 4096, 4097, 65_521, 2**31 - 1):
        assert all(_barrett(h, p) == h % p for h in hs)


def _split_model(pids: np.ndarray, parts: int, warps: int = 8):
    """The three passes of the hash_split kernel in numpy, with its tiles
    and per-warp slices: tile histograms, the partition-major exclusive
    scan, and each warp's in-order ranks."""
    n = len(pids)
    tiles, tile = cuda_ops.split_tiles(n, parts)
    hist = np.zeros((parts + 1, tiles), np.int64)
    for t in range(tiles):
        hist[:, t] = np.bincount(pids[t * tile:(t + 1) * tile],
                                 minlength=parts + 1)
    flat = hist.reshape(-1)
    offsets = (np.cumsum(flat) - flat).reshape(parts + 1, tiles)
    counts = hist.sum(1)
    perm = np.empty(n, np.int64)
    for t in range(tiles):
        t0, t1 = t * tile, min(n, (t + 1) * tile)
        per = -(-(t1 - t0) // warps)
        per = -(-per // 32) * 32
        run = offsets[:, t].copy()
        for w in range(warps):
            w0 = min(t1, t0 + w * per)
            w1 = min(t1, w0 + per)
            for i in range(w0, w1):
                perm[run[pids[i]]] = i
                run[pids[i]] += 1
    return perm, counts


@pytest.mark.parametrize("n,parts,live_frac",
                         [(4096, 8, 0.25), (70_001, 8, 0.9), (9000, 1, 0.5),
                          (20_000, 4096, 1.0), (50, 3, 0.0)])
def test_hash_split_matches_stable_sort(n, parts, live_frac):
    """The split (plain version here) and a model of its kernel's passes
    against numpy's stable argsort + bincount of the reference's ids."""
    rng = np.random.default_rng(n + parts)
    words = _words(rng, n, 2)
    live = rng.random(n) < live_frac
    ids = np.asarray(jbasic.hash_to_partition(
        jbasic.hash_words([jnp.asarray(w) for w in words]), parts))
    key = np.where(live, ids, parts)
    perm, counts = cuda_ops.hash_split([_t(w) for w in words],
                                       torch.from_numpy(live), parts)
    assert np.array_equal(perm.numpy(), np.argsort(key, kind="stable"))
    assert np.array_equal(counts.numpy(), np.bincount(key,
                                                      minlength=parts + 1))
    mperm, mcounts = _split_model(key, parts)
    assert np.array_equal(mperm, perm.numpy())
    assert np.array_equal(mcounts, counts.numpy())


def test_partition_limit_in_split_and_conf():
    from spark_rapids_tpu_torch.config import (MAX_SHUFFLE_PARTITIONS,
                                               SHUFFLE_PARTITIONS, TpuConf)
    assert MAX_SHUFFLE_PARTITIONS == cuda_ops.SPLIT_MAX_PARTS == 4096
    TpuConf({SHUFFLE_PARTITIONS: 4096})
    for bad in (0, 4097):
        with pytest.raises(ValueError):
            TpuConf({SHUFFLE_PARTITIONS: bad})
    w = [torch.zeros(4, dtype=torch.int64)]
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        cuda_ops.hash_split(w, live, 4097)
    with pytest.raises(ValueError):
        cuda_ops.hash_split(w, live[:3], 8)
