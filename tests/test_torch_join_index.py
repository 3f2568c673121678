"""The join probe's index (``cuda_ops.probe_index``) on the CPU.

The index is what the probe kernel (csrc/join_probe.cu) searches: the
sorted build words row-major, and every ``stride``-th row as separators.
Here: the choice of ``stride``, the rows against ``sorted_words``, the
separator invariant that the kernel's two-level lower bound rests on,
a step-by-step mirror of the kernel's search (separators, window, gallop)
against the plain version, and the whole probe through ``probe_counts``
against the JAX package.  Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.kernels import join as jjoin

from spark_rapids_tpu_torch.kernels import cuda_ops
from spark_rapids_tpu_torch.kernels import join as join_k

#: an H100 block's opt-in shared memory, the default budget on that card
H100_BUDGET = 232_448


def _keys(rng, n, keys, distinct, null_frac=0.0):
    """Words of ``keys`` int64 keys (a rank word and a value word each),
    drawn from ``distinct`` values so that runs of equal keys are long;
    ``null_frac`` of the rows have a null (rank 0, value 0) in a random key."""
    words = []
    null_key = rng.integers(0, keys, n)
    is_null = rng.random(n) < null_frac
    for j in range(keys):
        null = is_null & (null_key == j)
        value = rng.integers(0, distinct, n).astype(np.int64) * 7919 - 40_000
        words += [np.where(null, 0, 1).astype(np.int64),
                  np.where(null, 0, value)]
    return words


def _torch(words):
    return [torch.from_numpy(np.ascontiguousarray(w)) for w in words]


@pytest.mark.parametrize("words", [2, 3, 4, 6, 8, 13, 16, 26, 32])
@pytest.mark.parametrize("build_n,budget", [
    (0, H100_BUDGET), (1, H100_BUDGET), (120, H100_BUDGET),
    (1_825, H100_BUDGET), (180_000, H100_BUDGET), (524_288, H100_BUDGET),
    (1_048_576, H100_BUDGET), (4_194_304, H100_BUDGET),
    (524_288, H100_BUDGET // 2 - 1024), (1_000_003, 4096), (77, 256)])
def test_stride_is_the_least_power_of_two_that_fits(words, build_n, budget):
    row = 8 * (words + (words & 1))
    if budget < row:
        with pytest.raises(ValueError):
            cuda_ops.probe_stride(build_n, words, budget)
        return
    stride = cuda_ops.probe_stride(build_n, words, budget)
    assert stride >= 1 and stride & (stride - 1) == 0
    assert -(-build_n // stride) * row <= budget
    if stride > 1:
        assert -(-build_n // (stride // 2)) * row > budget


def test_stride_at_the_main_path_shapes():
    """The separator tables of phase 3's shapes on an H100's budget: q17's
    join partition (524,288 rows of 6 words) and the star builds of one
    key, store and date_dim whole in shared memory."""
    assert cuda_ops.probe_stride(524_288, 6, H100_BUDGET) == 128
    assert cuda_ops.probe_stride(524_288, 4, H100_BUDGET) == 128
    assert cuda_ops.probe_stride(1024, 2, H100_BUDGET) == 1       # store
    assert cuda_ops.probe_stride(2048, 2, H100_BUDGET) == 1       # date_dim
    assert cuda_ops.probe_stride(262_144, 2, H100_BUDGET) == 32   # item
    assert cuda_ops.probe_stride(1 << 20, 2, H100_BUDGET) == 128  # customer


@pytest.mark.parametrize("keys,build_n,budget", [
    (1, 0, 4096), (1, 1, 4096), (1, 1000, 4096), (3, 777, 2048),
    (2, 4096, 1 << 20), (13, 300, 8192), (16, 513, 4096)])
def test_rows_equal_sorted_words(keys, build_n, budget):
    rng = np.random.default_rng(build_n + keys)
    bt = join_k.build(_torch(_keys(rng, build_n, keys, 50, 0.1)))
    assert bt.index is None                       # the CPU takes bounds
    idx = cuda_ops.probe_index(bt.sorted_words, budget)
    k = 2 * keys
    assert idx.words == k and idx.rows.dtype == torch.int64
    assert idx.rows.shape == (build_n, k)          # even: no pad word
    for w in range(k):
        assert torch.equal(idx.rows[:, w], bt.sorted_words[w])
    assert torch.equal(idx.seps, idx.rows[::idx.stride])
    assert idx.seps.shape[0] * 8 * k <= budget


def test_odd_word_count_pads_a_zero_word():
    words = _torch(_keys(np.random.default_rng(3), 100, 2, 10))[:3]
    idx = cuda_ops.probe_index(join_k.build(words).sorted_words, 1024)
    assert idx.rows.shape == (100, 4) and idx.words == 3
    assert not idx.rows[:, 3].any()
    assert idx.stride == 4 and idx.seps.shape == (25, 4)    # 32 rows fit


@pytest.mark.parametrize("words,build_n,probe_n", [
    (1, 0, 9), (1, 1, 9), (1, 40, 0), (1, 40, 60), (2, 33, 50),
    (3, 57, 41), (6, 90, 70)])
def test_plain_bounds_count_the_tuples_below(words, build_n, probe_n):
    """``bounds``, the probe's plain version, against a count in Python:
    the build tuples less than each probe tuple, and not greater, in
    unsigned lexicographic order.  Words are drawn from few values that
    include 0, -1 and the sign bit, so equal runs and the unsigned order
    both show."""
    rng = np.random.default_rng(words * 100 + build_n + probe_n)
    pool = np.array([0, 1, 2, -1, -(1 << 63), (1 << 63) - 1, 12345],
                    dtype=np.int64)
    build = [torch.from_numpy(rng.choice(pool, build_n))
             for _ in range(words)]
    probe = [torch.from_numpy(rng.choice(pool, probe_n))
             for _ in range(words)]
    if build_n:
        build = join_k.build(build).sorted_words
    lo, hi = join_k.bounds(build, probe)

    def tup(ws, i):
        return tuple(int(w[i]) & ((1 << 64) - 1) for w in ws)
    rows = [tup(build, i) for i in range(build_n)]
    assert rows == sorted(rows)
    for i in range(probe_n):
        t = tup(probe, i)
        assert int(lo[i]) == sum(r < t for r in rows)
        assert int(hi[i]) == sum(r <= t for r in rows)


def _lower(build_words, probe_words):
    return join_k.bounds(build_words, probe_words)[0]


@pytest.mark.parametrize("keys,build_n,distinct,budget", [
    (1, 0, 10, 256), (1, 1, 10, 256), (1, 1000, 30, 256),
    (1, 4099, 300, 1024), (2, 3001, 40, 2048), (3, 999, 5, 4096),
    (13, 517, 3, 8192), (16, 640, 2, 16384)])
def test_separator_bound_brackets_the_lower_bound(keys, build_n, distinct,
                                                  budget):
    """J, the lower bound among the separators, puts the full lower bound
    in ((J-1) stride, J stride], and within build_n: the window the kernel
    searches in global memory.  Few distinct keys make runs of equal keys
    that span separators."""
    rng = np.random.default_rng(build_n * 31 + keys)
    bt = join_k.build(_torch(_keys(rng, build_n, keys, distinct, 0.05)))
    idx = cuda_ops.probe_index(bt.sorted_words, budget)
    stride = idx.stride
    assert stride > 1 or build_n <= 1
    probe = _torch(_keys(rng, 700, keys, distinct + 2, 0.05))
    full = _lower(bt.sorted_words, probe)
    seps = [idx.seps[:, w].contiguous() for w in range(idx.words)]
    j = _lower(seps, probe)
    assert bool(((j - 1) * stride < full).all())
    assert bool((full <= torch.clamp(j * stride, max=build_n)).all())


def _mirror(idx, probe, live, rank):
    """csrc/join_probe.cu's search, step by step, in Python: the separators
    (shared memory), the window ((J-1) stride, J stride] of rows, and the
    gallop from lo for the upper bound.  Counts its comparisons."""
    rows = [tuple(r) for r in idx.rows[:, :idx.words].tolist()]
    seps = rows[::idx.stride]
    n_build, stride = len(rows), idx.stride
    pw = list(zip(*[w.tolist() for w in probe]))
    u = lambda t: tuple(x & (2**64 - 1) for x in t)     # unsigned words
    lo_out, counts_out, loads = [], [], 0
    for i, q in enumerate(pw):
        q = u(q)
        a, b, eq = 0, len(seps), False
        while a < b:
            m = (a + b) >> 1
            s = u(seps[m])
            if s < q:
                a = m + 1
            else:
                b, eq = m, s == q
        lo = 0 if a == 0 else (a - 1) * stride + 1
        hi = a * stride if a < len(seps) else n_build
        while lo < hi:
            m = (lo + hi) >> 1
            r = u(rows[m])
            loads += 1
            if r < q:
                lo = m + 1
            else:
                hi, eq = m, r == q
        count = 0
        if live[i] and all(q[w] == 1 for w in rank) and eq:
            step = 1
            while lo + step < n_build and u(rows[lo + step]) == q:
                loads += 1
                step <<= 1
            loads += lo + step < n_build
            ulo, uhi = lo + (step >> 1) + 1, min(lo + step, n_build)
            while ulo < uhi:
                m = (ulo + uhi) >> 1
                loads += 1
                if u(rows[m]) == q:
                    ulo = m + 1
                else:
                    uhi = m
            count = ulo - lo
        lo_out.append(lo)
        counts_out.append(count)
    return (torch.tensor(lo_out, dtype=torch.int64),
            torch.tensor(counts_out, dtype=torch.int64), loads)


@pytest.mark.parametrize("keys,build_n,distinct,budget", [
    (1, 0, 10, 256), (1, 1, 10, 256), (1, 15, 10, 16), (1, 17, 10, 32),
    (1, 31, 10, 32), (1, 33, 10, 32), (1, 32, 1, 256), (1, 500, 40, 256),
    (1, 500, 40, 1 << 16),
    (2, 301, 8, 512), (3, 257, 4, 1024), (4, 200, 3, 2048),
    (13, 150, 2, 4096), (16, 129, 2, 4096)])
def test_kernel_search_equals_plain(keys, build_n, distinct, budget):
    """The kernel's search, mirrored in Python, equals ``join_probe_plain``
    bit for bit: builds of 0, 1 and stride +- 1 rows (stride 16 for 15
    and 17 rows, 16 and 32 for 31 and 33), all one key, runs across separators, a build that
    is no multiple of the stride, a build whole in shared memory, 1-16
    keys, null keys and dead rows."""
    rng = np.random.default_rng(build_n * 7 + keys)
    null_frac = 0.05 if distinct > 1 else 0.0
    bt = join_k.build(_torch(_keys(rng, build_n, keys, distinct, null_frac)))
    idx = cuda_ops.probe_index(bt.sorted_words, budget)
    probe = _torch(_keys(rng, 160, keys, distinct + 1, 0.1))
    live = torch.from_numpy(rng.random(160) < 0.8)
    rank = list(range(0, 2 * keys, 2))
    lo, counts, loads = _mirror(idx, probe, live, rank)
    plo, pcounts = cuda_ops.join_probe_plain(bt.sorted_words, probe, live,
                                             rank)
    assert torch.equal(lo, plo) and torch.equal(counts, pcounts)
    if build_n == 32 and distinct == 1:           # all one key
        assert int(counts.max()) == build_n
    # at most log2(stride) window loads per row, plus the gallop's
    # 2 log2(count) + 2
    top = idx.stride.bit_length() - 1
    gallop = sum(2 * max(int(c), 1).bit_length() + 2 for c in counts)
    assert loads <= len(lo) * top + gallop


@pytest.mark.parametrize("keys,null_frac", [(1, 0.1), (2, 0.0), (3, 0.05)])
def test_probe_counts_equals_the_jax_package(keys, null_frac):
    """The port's whole probe (``probe_counts`` on the CPU) against the JAX
    package's ``probe_counts``: the same sorted build, lo and counts.
    Nulls sit in the first key alone, the one rank word the reference
    checks."""
    rng = np.random.default_rng(keys)
    n_build, n_probe, live_rows = 3000, 4096, 3500

    def words(n, distinct):
        ws = _keys(rng, n, keys, distinct)
        null = rng.random(n) < null_frac
        ws[0] = np.where(null, 0, ws[0])
        ws[1] = np.where(null, 0, ws[1])
        return ws
    distinct = {1: 600, 2: 40, 3: 12}[keys]       # per key
    bw, pw = words(n_build, distinct), words(n_probe, distinct + 1)
    pw[0][live_rows:] = 2                          # dead rows rank 2
    jbt = jjoin.build([jnp.asarray(w.view(np.uint64)) for w in bw])
    jc = jjoin.probe_counts(jbt, [jnp.asarray(w.view(np.uint64))
                                  for w in pw], live_rows)
    bt = join_k.build(_torch(bw))
    live = torch.arange(n_probe) < live_rows
    pc = join_k.probe_counts(bt, _torch(pw), live,
                             list(range(0, 2 * keys, 2)))
    assert np.array_equal(np.asarray(jc.lo), pc.lo.numpy())
    assert np.array_equal(np.asarray(jc.counts), pc.counts.numpy())
    assert np.array_equal(np.asarray(jc.matched), pc.matched.numpy())
    assert int(pc.counts.sum()) > 0
