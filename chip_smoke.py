"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Runs from the repository root:

    python3 chip_smoke.py                      # full size, on the card
    python3 chip_smoke.py --rows 4000000       # a shorter query phase
    python3 chip_smoke.py --device cpu --rows 200000 --sf 0.05  # rehearsal
    python3 chip_smoke.py --parent DIR         # also time DIR's kernels

Phases (any failure exits non-zero):
1. probe: a CUDA device is required; prints its name, count and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles every kernel of ``spark_rapids_tpu_torch/csrc`` with
   nvcc and prints each one's registers and shared memory;
3. kernels: each kernel against its plain torch version on the card at
   the main path's shapes (B1: the exchange's split and the ids alone;
   B2: the table core's reduce stage and the TPU kernel's raw rows),
   device-timed behind a sleep kernel (``time_cuda``) beside its byte
   bound (3.35 TB/s), its host cost per call, the plain version and a
   one-call PyTorch yardstick where one exists;
4. query: the headline query of ``bench.py`` (filter, project, group-by
   with sum/count/max, hash exchange, broadcast join, project) through
   the port's session at 64M rows in 4 partitions, twice in exact mode
   (results must be byte-identical) and in variable mode, each checked
   against a numpy computation of the same query from the same seed;
   before it, the query's variable-mode sums are reduced through the
   table-reduce kernel in f32 and in f64 rows, and the groups that miss
   the variable-mode limit are counted for each.  Each mode's warm run
   is profiled and must call none of STAGE_REPLACED_OPS;
5. joins: orders, lineitem and partsupp in TPC-H's shapes at scale
   ``--sf`` (default 10: 15M, ~60M and 8M rows), and seven queries over
   them: a year of orders joined to late lineitems as an inner, left,
   right, full, semi and anti join (J1-J6), and Q9's two-key join of
   lineitem and partsupp (J7), each grouped.  Each must plan a
   ``TpuShuffledHashJoin`` over two exchanges built on the expected
   side, match numpy at 1e-9 and give the same bytes twice; J1 runs once
   more under the profiler, and J2's join rows must not change when it
   expands in small chunks.  B1 and B2 must launch on this path.
The line before the last is a JSON object of every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
EXACT_REL = 1e-9                   # tests/harness.py DEFAULT_FLOAT_REL
VARIABLE_REL = 2e-5                # tests/harness.py FAST_FLOAT_REL
# atomics reorder sums: per sum-row dtype, the bound on a bucket's error
# relative to its sum of |v| (see phase 3)
B2_SUM_RTOL = {"float32": 1e-5, "float64": 1e-12}
PARTITIONS = 4                     # bench.main's partition count


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int = 20, warmup: int = 3, queued: bool = True):
    """(device ms per call, host ms per call), after warm-up.

    The host ms is the wall time of enqueueing one call.  With ``queued``
    the calls wait behind a sleep kernel that outlasts their enqueueing, so
    the CUDA events around them time the device alone (a call that is
    cheaper on the device than on the host is not timed at the host's
    rate).  A function that synchronises inside (a host read), or one
    whose calls overflow the device's launch queue (the plain versions,
    a hundred small launches each), cannot queue: pass ``queued=False``
    and its events include the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    if not queued:
        ev[1].record()
        for _ in range(iters):
            fn()
        ev[2].record()
        torch.cuda.synchronize()
        return ev[1].elapsed_time(ev[2]) / iters, host_s * 1e3
    sleep_s = 2 * host_s * iters + 1e-3
    for _ in range(4):
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(int(sleep_s * 2e9))      # cycles, clock <= 2 GHz
        ev[1].record()
        for _ in range(iters):
            fn()
        ev[2].record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) / 1e3 > enqueue_s:
            return ev[1].elapsed_time(ev[2]) / iters, host_s * 1e3
        sleep_s *= 2
    raise RuntimeError("the calls outlasted every sleep: not device-timed")


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_entry(name: str, source: str, replaces: str, shape: str,
                 err: float, timed, plain_ms: float, nbytes: int,
                 library_ms=None, **extra):
    ms, host_ms = timed
    return {"name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/csrc/{source}",
            "replaces": f"spark_rapids_tpu/kernels/pallas_ops.py:{replaces}",
            "shape": shape, "max_abs_err": err, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": library_ms, **extra}


# -- phase 3: kernels against their plain versions ---------------------------

def random_words(rng, n: int, num_words: int):
    import torch
    return [torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                          dtype=np.int64,
                                          endpoint=True)).cuda()
            for _ in range(num_words)]


def check_hash_ids(ops, rng, n: int, num_words: int, parts: int,
                   design: str):
    """B1's ids alone (the TPU kernel's function), from ``ops``: this
    tree's wrapper or the parent checkout's."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    words = random_words(rng, n, num_words)
    got = ops.hash_partition_ids(words, parts)
    torch.cuda.synchronize()
    check(torch.equal(got, cuda_ops.hash_partition_ids_plain(words, parts)),
          f"hash_partition_ids ({design}) differs from its plain version, "
          f"n={n}")
    return kernel_entry(
        "hash_partition_ids", "hash_partition.cu", "37",
        f"ids {n} rows x {num_words} word(s) -> {parts} parts ({design})",
        0.0, time_cuda(lambda: ops.hash_partition_ids(words, parts)),
        time_cuda(lambda: cuda_ops.hash_partition_ids_plain(words, parts),
                  iters=5, queued=False)[0],
        n * 8 * num_words + n * 4)


def check_hash_split(rng, n: int, num_words: int, parts: int,
                     live_frac: float):
    """B1 redesigned: the exchange's split against a stable sort of the
    ids + bincount, bit for bit."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    words = random_words(rng, n, num_words)
    live = torch.from_numpy(rng.random(n) < live_frac).cuda()
    perm, counts = cuda_ops.hash_split(words, live, parts)
    want_perm, want_counts = cuda_ops.hash_split_plain(words, live, parts)
    torch.cuda.synchronize()
    check(torch.equal(perm, want_perm) and torch.equal(counts, want_counts),
          f"hash_split differs from sort + bincount at n={n}, {parts} parts")

    def sort_path():      # the split before: ids kernel, stable sort, bincount
        key = torch.where(live, cuda_ops.hash_partition_ids(
            words, parts).to(torch.int64), parts)
        torch.sort(key, stable=True)
        torch.bincount(key, minlength=parts + 1)
    key = torch.where(live, cuda_ops.hash_partition_ids_plain(
        words, parts).to(torch.int64), parts)
    return kernel_entry(
        "hash_partition_ids", "hash_partition.cu", "37",
        f"split {n} rows x {num_words} word(s) -> {parts} parts, "
        f"{live_frac:.0%} live", 0.0,
        time_cuda(lambda: cuda_ops.hash_split(words, live, parts)),
        time_cuda(lambda: cuda_ops.hash_split_plain(words, live, parts),
                  iters=5, queued=False)[0],
        n * 8 * num_words + n + n * 8 + (parts + 1) * 8,
        design="counting-sort split",
        sort_path_ms=time_cuda(sort_path, iters=5, queued=False)[0],
        sort_ms=time_cuda(lambda: torch.sort(key, stable=True))[0])


def bench_like_reduce_rows(rng, n: int, table: int, k: int, m: int,
                           sum_dt):
    """Bucket ids and raw rows shaped like the headline query's partial
    aggregate: ~1000 keys, ~23% rows dead (bucket ``table``), a count
    row, sum rows of magnitude up to 1e5 and max rows in [0, 1)."""
    import torch
    keys = rng.integers(0, 1000, n)
    dead = rng.random(n) < 0.23
    bucket = np.where(dead, table, keys + 1).astype(np.int32)
    live = (~dead).astype(sum_dt)
    sums = [live]
    for _ in range(k - 1):
        z = rng.random(n) * rng.random(n) + rng.integers(-100_000, 100_000,
                                                         n)
        sums.append(np.where(dead, 0.0, z).astype(sum_dt))
    maxs = [np.where(dead, -np.inf, rng.random(n)).astype(np.float32)
            for _ in range(m)]
    t = torch.from_numpy
    sums_t = t(np.stack(sums)).cuda()
    maxs_t = (t(np.stack(maxs)).cuda() if maxs else
              torch.empty(0, n, dtype=torch.float32, device="cuda"))
    return t(bucket).cuda(), sums_t, maxs_t


def check_table_reduce(ops, rng, n: int, table: int, k: int, m: int, sum_dt,
                       design: str):
    """B2 as the TPU kernel's function: raw sum and max rows."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    bucket, sums, maxs = bench_like_reduce_rows(rng, n, table, k, m,
                                                sum_dt)
    rtol = B2_SUM_RTOL[np.dtype(sum_dt).name]
    s_got, m_got = ops.table_reduce(bucket, sums, maxs, table)
    s_want, m_want = cuda_ops.table_reduce_plain(bucket, sums, maxs, table)
    torch.cuda.synchronize()
    check(torch.equal(s_got[0], s_want[0]),
          "table_reduce count row differs from its plain version")
    check(torch.equal(m_got, m_want),
          "table_reduce max rows differ from their plain version")
    # atomic sums reorder additions: hold each bucket's sum to rtol of
    # the bucket's sum of |v| (f64 reference)
    b64 = torch.where(bucket < table, bucket, table).long()
    ref = torch.zeros(k, table + 1, dtype=torch.float64, device="cuda")
    ref.index_add_(1, b64, sums.double())
    mag = torch.zeros(k, table + 1, dtype=torch.float64, device="cuda")
    mag.index_add_(1, b64, sums.double().abs())
    err = (s_got.double() - ref[:, :table]).abs()
    check(bool((err <= rtol * mag[:, :table] + 1e-6).all()),
          "table_reduce sums outside tolerance")
    max_err = float(torch.cat([(s_got - s_want).abs().float().flatten(),
                               (m_got - m_want).abs().nan_to_num().flatten()
                               ]).max())

    # the yardstick: index_add_ / scatter_reduce_ along dim 0 of
    # [n, rows] (torch's fast layout; transposed outside the timing)
    sums_t, maxs_t = sums.T.contiguous(), maxs.T.contiguous()
    b_m = b64[:, None].expand(-1, m)

    def library():
        out = torch.zeros(table + 1, k, dtype=sums.dtype, device="cuda")
        out.index_add_(0, b64, sums_t)
        if m:
            mo = torch.full((table + 1, m), float("-inf"), device="cuda")
            mo.scatter_reduce_(0, b_m, maxs_t, "amax")
    es = sums.element_size()
    return kernel_entry(
        "table_reduce", "table_reduce.cu", "128",
        f"raw rows: {n} rows, table {table}, {k} {sums.dtype} sum + {m} max "
        f"rows ({design})", max_err,
        time_cuda(lambda: ops.table_reduce(bucket, sums, maxs, table)),
        time_cuda(lambda: cuda_ops.table_reduce_plain(bucket, sums, maxs,
                                                      table),
                  iters=5, queued=False)[0],
        n * 4 + k * (n + table) * es + m * (n + table) * 4,
        time_cuda(library)[0])


def query_stage_inputs(rng, n: int, table: int, stage: str):
    """The table stage's inputs at one of the headline query's shapes,
    built by the table core's own code (``TpuHashAggregate._stage_col``):
    ``partial`` (count(*), sum(z), max(x) over n input rows, exact),
    ``final`` (the merge of partial buffers: sum, count, max) or
    ``variable`` (the partial in variable float mode)."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.exec.tpu_aggregate import TpuHashAggregate
    from spark_rapids_tpu_torch.kernels.cuda_ops import StageCol
    keys = rng.integers(0, 1000, n)
    if stage == "final":       # partial tables: ~1000 live groups of 4096
        live = np.zeros(n, bool)
        live[np.arange(n) % table < 1000] = True
        keys = np.arange(n) % table
    else:
        live = rng.random(n) >= 0.23
    x = rng.random(n)
    z = x * rng.random(n) + rng.integers(-100_000, 100_000, n)
    t = torch.from_numpy
    bucket = t(np.where(live, keys + 1, table).astype(np.int32)).cuda()
    live_t = t(live).cuda()
    ones = torch.ones(n, dtype=torch.bool, device="cuda")

    def col(v):
        return Column(T.FLOAT64, t(v).cuda(), ones)
    kinds = {"partial": ("fsum64", "fmax64"), "variable": ("fsumv", "fmax"),
             "final": ("fsum64", "icount", "fmax64")}[stage]
    cols = [StageCol("count")]
    for kind, c in zip(kinds, [col(z), col(x)] if stage != "final" else
                       [col(z * 60), Column(T.INT64, t(rng.integers(
                           0, 60_000, n)).cuda(), ones), col(x)]):
        sc, _ = TpuHashAggregate._stage_col(kind, c, live_t)
        cols.append(sc)
    return bucket, cols


def check_table_stage(rng, n: int, table: int, stage: str):
    """B2 redesigned: the table core's whole reduce stage against its
    plain version.  Integer tables bit for bit; f64 value sums (variable
    mode) within B2_SUM_RTOL of the bucket's sum of |v|."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    bucket, cols = query_stage_inputs(rng, n, table, stage)
    got = cuda_ops.table_stage(bucket, table, cols)
    want = cuda_ops.table_stage_plain(bucket, table, cols)
    torch.cuda.synchronize()
    err = 0.0
    for c, g, w in zip(cols, got, want):
        for a, b in zip(g, w):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"table_stage {c.kind}: {a.dtype}{list(a.shape)} against "
                  f"{b.dtype}{list(b.shape)}")
            if a.dtype == torch.float64 and c.kind == "fsumv":
                mag = cuda_ops.table_stage_plain(
                    bucket, table, [cuda_ops.StageCol(
                        "fsumv", c.data.abs(), c.valid)])[0][1]
                d = (a - b).abs()
                check(bool((d <= B2_SUM_RTOL["float64"] * mag).all()),
                      "table_stage f64 sums outside tolerance")
                err = max(err, float(d.max()))
            else:
                check(torch.equal(a.nan_to_num(), b.nan_to_num()) and
                      torch.equal(a.isnan(), b.isnan()) if
                      a.is_floating_point() else torch.equal(a, b),
                      f"table_stage {c.kind} table differs from its plain "
                      f"version")
    in_bytes = n * 4 + sum(t.numel() * t.element_size() for c in cols
                           for t in (c.data, c.valid) if t is not None)
    out_bytes = sum(t.numel() * t.element_size() for g in got for t in g)
    return kernel_entry(
        "table_reduce", "table_reduce.cu", "128",
        f"stage {stage}: {n} rows, table {table}, kinds "
        f"{[c.kind for c in cols]}", err,
        time_cuda(lambda: cuda_ops.table_stage(bucket, table, cols)),
        time_cuda(lambda: cuda_ops.table_stage_plain(bucket, table, cols),
                  iters=5, queued=False)[0],
        in_bytes + out_bytes, design="whole reduce stage")


def load_parent_ops(path: str):
    """``kernels/cuda_ops`` of another checkout of the repo (the parent
    commit), imported as a package of its own; it builds its kernels into
    that checkout's build/kernels."""
    import importlib
    import importlib.util
    from pathlib import Path
    pkg = Path(path).resolve() / "spark_rapids_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_port.kernels.cuda_ops")


def kernel_phase(rng, parent: str = None, big: int = 4 << 20) -> dict:
    """Phase 3: every kernel against its plain version at the main path's
    shapes (and the sizes an exchange of whole batches will give B1).
    Returns each kernel's main-path entry; prints every entry."""
    from spark_rapids_tpu_torch.kernels import cuda_ops
    # each kernel's main-path check comes first among its checks
    split_main = lambda: check_hash_split(rng, 4096, 1, 8, 0.25)
    stage_main = lambda: check_table_stage(rng, big, 4096, "partial")
    checks = [
        # B1: the split at the main path's shape (a partial table of 4096
        # slots, ~1000 live), at a whole batch, and at the partition limit
        split_main,
        lambda: check_hash_split(rng, big, 1, 8, 1.0),
        lambda: check_hash_split(rng, big, 1, 1, 0.9),
        lambda: check_hash_split(rng, big, 2, cuda_ops.SPLIT_MAX_PARTS, 0.9),
        # B1's ids alone
        lambda: check_hash_ids(cuda_ops, rng, 4096, 1, 8, "Barrett modulo"),
        lambda: check_hash_ids(cuda_ops, rng, big, 1, 8, "Barrett modulo"),
        # B2: the stage at the query's shapes, then the TPU kernel's raw rows
        stage_main,
        lambda: check_table_stage(rng, 4 * 4096, 4096, "final"),
        lambda: check_table_stage(rng, big, 4096, "variable"),
        lambda: check_table_stage(rng, big // 4, 1 << 14, "partial"),
        lambda: check_table_reduce(cuda_ops, rng, big, 4096, 7, 0,
                                   np.float32, "stage kernel"),
        lambda: check_table_reduce(cuda_ops, rng, big, 4096, 5, 1,
                                   np.float64, "stage kernel"),
    ]
    if parent:
        old = load_parent_ops(parent)
        old.build_all()
        checks += [
            lambda: check_hash_ids(old, rng, 4096, 1, 8, "parent kernel"),
            lambda: check_hash_ids(old, rng, big, 1, 8, "parent kernel"),
            lambda: check_table_reduce(old, rng, big, 4096, 7, 0,
                                       np.float32, "parent kernel"),
            lambda: check_table_reduce(old, rng, big, 4096, 5, 1,
                                       np.float64, "parent kernel")]
    main = {}
    for measure in checks:
        entry = measure()
        if measure is split_main or measure is stage_main:
            main[entry["name"]] = entry
        print("kernel", json.dumps(entry), flush=True)
    return main


# -- phase 4: the headline query ---------------------------------------------

def make_data(n_rows: int, seed: int):
    """bench.build_df's tables, from the same generator calls."""
    rng = np.random.default_rng(seed)
    data = {
        "k": rng.integers(0, 1000, n_rows).astype(np.int64),
        "a": rng.integers(-100_000, 100_000, n_rows).astype(np.int64),
        "x": rng.random(n_rows),
        "y": rng.random(n_rows),
    }
    dim = {"dk": np.arange(1000, dtype=np.int64), "w": rng.random(1000)}
    return data, dim


def build_df(session, data, dim, num_partitions: int):
    """bench.build_df's query text against a port session."""
    from spark_rapids_tpu_torch.api import functions as F
    df = session.create_dataframe(data, num_partitions=num_partitions)
    dim = session.create_dataframe(dim, num_partitions=1)
    agg = (df.filter((F.col("x") > 0.1) & (F.col("a") % 7 != 0))
             .with_column("z", F.col("x") * F.col("y") + F.col("a"))
             .group_by("k")
             .agg(F.sum("z").alias("sz"), F.count().alias("c"),
                  F.max("x").alias("mx")))
    joined = (agg.join(dim, agg["k"] == dim["dk"], "inner")
                 .select(F.col("k"), F.col("sz"), F.col("c"),
                         (F.col("mx") * F.col("w")).alias("mw")))
    return joined


def numpy_reference(data, dim):
    k, a, x, y = data["k"], data["a"], data["x"], data["y"]
    mask = (x > 0.1) & (a % 7 != 0)
    kk = k[mask]
    z = x[mask] * y[mask] + a[mask]
    cnt = np.bincount(kk, minlength=1000)
    sz = np.bincount(kk, weights=z, minlength=1000)
    mx = np.full(1000, -np.inf)
    np.maximum.at(mx, kk, x[mask])
    w = dim["w"][dim["dk"]]
    g = np.nonzero(cnt)[0]
    return {"k": g, "sz": sz[g], "c": cnt[g], "mw": mx[g] * w}


def compare(table, ref, rel: float, what: str) -> float:
    """Check ``table`` against the numpy reference; returns the largest
    float error over its limit (1 would be at the limit)."""
    t = table.sort_by("k")
    got = {c: t.column(c).to_numpy() for c in ("k", "sz", "c", "mw")}
    check(len(got["k"]) == len(ref["k"]),
          f"{what}: {len(got['k'])} rows, reference {len(ref['k'])}")
    check(np.array_equal(got["k"], ref["k"]), f"{what}: keys differ")
    check(np.array_equal(got["c"], ref["c"]), f"{what}: counts differ")
    worst = 0.0
    for c in ("sz", "mw"):
        g, r = got[c], ref[c]
        ratio = np.abs(g - r) / rel_limit(g, r, rel)
        bad = ratio > 1.0
        check(not bad.any(),
              f"{what}: {int(bad.sum())} {c} values beyond {rel} relative")
        worst = max(worst, float(ratio.max(initial=0.0)))
    return worst


def rel_limit(got, ref, rel: float):
    """The repo's float limit: rel * max(|got|, |ref|, 1)."""
    return rel * np.maximum(np.maximum(np.abs(got), np.abs(ref)), 1.0)


def variable_sum_precision(data, ref, parts: int, batch_rows: int) -> None:
    """The query's sum(z) reduced through the table-reduce kernel in the
    query's order (each batch, then each partition's batches, then the
    partitions), with three kinds of rows, against numpy's f64 sums:
    f32 rows throughout (the TPU kernel's arithmetic); z rounded to f32,
    then f64 rows (the least error of any design that takes f32 value
    rows); f64 rows (the port's variable mode).  Prints, for each, the
    groups beyond VARIABLE_REL and the largest error over its limit."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    groups = 1000
    cols = {c: torch.from_numpy(data[c]).cuda() for c in "kaxy"}
    keep = (cols["x"] > 0.1) & (cols["a"] % 7 != 0)
    z = cols["x"] * cols["y"] + cols["a"]
    bucket = torch.where(keep, cols["k"], groups).to(torch.int32)
    n = bucket.shape[0]
    per = -(-n // parts)

    def reduce(b, vals):
        no_max = torch.empty(0, b.shape[0], device="cuda")
        return cuda_ops.table_reduce(b, vals[None], no_max, groups)[0][0]

    def merge(tabs):
        ids = torch.arange(groups, dtype=torch.int32, device="cuda")
        return reduce(ids.repeat(len(tabs)), torch.cat(tabs))

    want, g = ref["sz"], ref["k"]
    for name, cast, acc in (("f32 rows", torch.float32, torch.float32),
                            ("z in f32, f64 rows", torch.float32,
                             torch.float64),
                            ("f64 rows", torch.float64, torch.float64)):
        vals = torch.where(keep, z.to(cast).to(acc), 0.0)
        part_tabs = []
        for p in range(parts):
            lo, hi = min(p * per, n), min((p + 1) * per, n)
            part_tabs.append(merge([reduce(bucket[s:min(s + batch_rows, hi)],
                                           vals[s:min(s + batch_rows, hi)])
                                    for s in range(lo, hi, batch_rows)]))
        got = merge(part_tabs).double().cpu().numpy()[g]
        err = np.abs(got - want)
        ratio = err / rel_limit(got, want, VARIABLE_REL)
        print(f"variable sums through table_reduce, {name}: "
              f"{int((ratio > 1).sum())} of {len(g)} groups beyond "
              f"{VARIABLE_REL} relative; worst error/limit "
              f"{float(ratio.max())!r}, worst absolute error "
              f"{float(err.max())!r}")


def run_query(session, data, dim, parts: int, device: str):
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    df = build_df(session, data, dim, parts)
    times, tables, launches = [], [], []
    for _ in range(2):
        cuda_ops.reset_launches()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables.append(df.to_arrow())
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(dict(cuda_ops.LAUNCHES))
    return df, times, tables, launches


# torch ops the table core's reduce stage and the exchange's split no
# longer run: the table_stage and hash_split kernels took their work
STAGE_REPLACED_OPS = ("aten::scatter_reduce_", "aten::index_add_",
                      "aten::scatter_add_", "aten::bincount")


def profile_query(df) -> set:
    """One more warm run under torch.profiler: device time by op, the
    device's busy share of the (profiled) wall time and the device
    events of the run.  Returns the names of the ops the run called."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.to_arrow()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    names = {e.key for e in prof.key_averages()}
    # device events alone: an op's row in key_averages() carries its
    # kernels' time too, so summing every row counts the device twice
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        print("profile: the profiler saw no device time")
        return names
    by_name = {}
    for e in device:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    dev_us = sum(us for us, _ in by_name.values())
    copies = sum(n for name, (_, n) in by_name.items()
                 if name.startswith(("Memcpy", "Memset")))
    print(f"profile: wall {wall_us / 1e3:.3f} ms (profiled), device busy "
          f"{dev_us / 1e3:.3f} ms = {100 * dev_us / wall_us:.1f}% of wall; "
          f"{len(device) - copies} kernel launches, {copies} copies and "
          f"memsets")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :12]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<6d} {name[:90]}")
    return names


# -- phase 5: shuffled joins at TPC-H scale ----------------------------------

#: join type and planned build side of each phase 5 query
JOIN_QUERIES = {"J1": ("inner", "left"), "J2": ("left", "right"),
                "J3": ("right", "left"), "J4": ("full", "right"),
                "J5": ("semi", "right"), "J6": ("anti", "right"),
                "J7": ("inner", "right")}
#: one year of orders: 1994-01-01 < o_orderdate <= 1994-12-31 (days since
#: 1970-01-01)
YEAR_LO, YEAR_HI = 8765, 9130
JOIN_BATCH_ROWS = 1 << 22          # batchSizeRows of phase 5 at SF10
#: join.gather.chunkRows of the chunked J2 at SF10: below its stream
#: batches' output rows (~180K), so they expand in several chunks
JOIN_CHUNK_ROWS = 1 << 16


def join_scale(sf: float):
    """(batchSizeRows, broadcast threshold, chunk rows of the chunked J2)
    that give the plans and chunks of SF10 at scale ``sf``: below SF10
    all three shrink with the tables, so a rehearsal plans the same
    shuffled joins over the same number of batches."""
    from spark_rapids_tpu_torch.plan import overrides
    shrink = min(1.0, sf / 10)
    return (max(1024, int(JOIN_BATCH_ROWS * shrink)),
            int(overrides.BROADCAST_ROW_THRESHOLD * shrink),
            max(16, int(JOIN_CHUNK_ROWS * shrink)))


def make_tpch(sf: float, seed: int):
    """orders, lineitem and partsupp in TPC-H's shapes (spec 4.2.3), the
    fixed-width columns only, dates as int32 days since 1970-01-01."""
    rng = np.random.default_rng(seed)
    n_orders = int(1_500_000 * sf)
    parts = max(1, int(200_000 * sf))
    supps = max(4, int(10_000 * sf))
    i = np.arange(n_orders, dtype=np.int64)
    okey = (i // 8) * 32 + i % 8 + 1               # dbgen's sparse keys
    odate = rng.integers(8035, 10441, n_orders).astype(np.int32)
    orders = {"o_orderkey": okey, "o_orderdate": odate,
              "o_orderpriority": rng.integers(1, 6, n_orders)
              .astype(np.int32),
              "o_totalprice": rng.integers(85_000, 55_000_000, n_orders)
              / 100.0}
    lines = rng.integers(1, 8, n_orders)
    n_lines = int(lines.sum())
    order_of = np.repeat(i, lines)
    first = np.cumsum(lines) - lines
    linenumber = (np.arange(n_lines) - np.repeat(first, lines) + 1)
    partkey = rng.integers(1, parts + 1, n_lines)
    quantity = rng.integers(1, 51, n_lines)
    retail = (90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)) \
        / 100.0
    ldate = odate[order_of]
    ship = ldate + rng.integers(1, 122, n_lines)
    lineitem = {
        "l_orderkey": okey[order_of],
        "l_linenumber": linenumber.astype(np.int32),
        "l_partkey": partkey,
        "l_suppkey": ps_suppkey(partkey, rng.integers(0, 4, n_lines), supps),
        "l_quantity": quantity,
        "l_extendedprice": quantity * retail,
        "l_commitdate": (ldate + rng.integers(30, 91, n_lines))
        .astype(np.int32),
        "l_receiptdate": (ship + rng.integers(1, 31, n_lines))
        .astype(np.int32)}
    ps_part = np.repeat(np.arange(1, parts + 1, dtype=np.int64), 4)
    partsupp = {"ps_partkey": ps_part,
                "ps_suppkey": ps_suppkey(ps_part, np.tile(np.arange(4),
                                                          parts), supps),
                "ps_supplycost": rng.integers(100, 100_001, 4 * parts)
                / 100.0}
    return {"orders": orders, "lineitem": lineitem, "partsupp": partsupp}


def ps_suppkey(partkey, j, supps: int):
    """The spec's j-th supplier (0..3) of a part, for ``supps`` suppliers."""
    return (partkey + j * (supps // 4 + (partkey - 1) // supps)) % supps + 1


def join_frames(session, tables):
    return {name: session.create_dataframe(cols, num_partitions=PARTITIONS)
            for name, cols in tables.items()}


def join_query(F, frames, q: str):
    """Query ``q`` of phase 5, with the functions module ``F`` of the
    package whose session made ``frames``.  J1-J6: a year of orders
    joined to the lineitems received after their commit date (the shape
    of Q4, Q12 and Q21), grouped by priority; J7: Q9's two-key join of
    lineitem and partsupp, grouped by line number."""
    o, li, ps = frames["orders"], frames["lineitem"], frames["partsupp"]
    if q == "J7":
        li = li.select("l_partkey", "l_suppkey", "l_quantity", "l_linenumber")
        j = li.join(ps, (li["l_partkey"] == ps["ps_partkey"]) &
                    (li["l_suppkey"] == ps["ps_suppkey"]), "inner")
        return j.group_by("l_linenumber").agg(
            F.sum(F.col("l_quantity") * F.col("ps_supplycost"))
            .alias("value"), F.count().alias("cnt"),
            F.max("ps_supplycost").alias("max_cost"))
    how = JOIN_QUERIES[q][0]
    od = F.col("o_orderdate")
    year = o.filter((od > YEAR_LO) & ~(od > YEAR_HI)).select(
        "o_orderkey", "o_orderpriority", "o_totalprice")
    late = li.filter(F.col("l_receiptdate") > F.col("l_commitdate")).select(
        "l_orderkey", "l_extendedprice", "l_quantity")
    j = year.join(late, year["o_orderkey"] == late["l_orderkey"], how)
    if how in ("semi", "anti"):
        return j.group_by("o_orderpriority").agg(
            F.count().alias("cnt"), F.sum("o_totalprice").alias("price"))
    return j.group_by("o_orderpriority").agg(
        F.sum("l_extendedprice").alias("revenue"), F.count().alias("cnt"),
        F.max("l_quantity").alias("max_qty"))


def join_references(tables) -> dict:
    """{query: {group key: row}} of every phase 5 query by numpy, from the
    same tables (None is the null group)."""
    o, li, ps = tables["orders"], tables["lineitem"], tables["partsupp"]
    # J7: every (lineitem, partsupp) pair with equal keys; a small scale
    # factor repeats a part's supplier
    supps = int(max(ps["ps_suppkey"].max(), li["l_suppkey"].max())) + 1
    pkey = ps["ps_partkey"] * supps + ps["ps_suppkey"]
    order = np.argsort(pkey, kind="stable")
    lkey = li["l_partkey"] * supps + li["l_suppkey"]
    lorder = np.argsort(lkey)          # sorted needles search far faster
    lo = np.searchsorted(pkey[order], lkey[lorder])
    n = np.searchsorted(pkey[order], lkey[lorder], side="right") - lo
    row = lorder[np.repeat(np.arange(len(lkey)), n)]
    at = np.repeat(lo - (np.cumsum(n) - n), n) + np.arange(len(row))
    cost = ps["ps_supplycost"][order][at]
    line = li["l_linenumber"][row]
    cnt = np.bincount(line, minlength=8)
    value = np.bincount(line, weights=li["l_quantity"][row] * cost,
                        minlength=8)
    refs = {"J7": {g: (float(value[g]), int(cnt[g]),
                       float(cost[line == g].max()))
                   for g in range(1, 8) if cnt[g]}}
    # J1-J6: group 0 below is the null priority of unmatched lineitems
    od = o["o_orderdate"]
    in_year = (od > YEAR_LO) & ~(od > YEAR_HI)
    late = li["l_receiptdate"] > li["l_commitdate"]
    at = np.clip(np.searchsorted(o["o_orderkey"], li["l_orderkey"]), 0,
                 len(od) - 1)
    pair = late & (o["o_orderkey"][at] == li["l_orderkey"]) & in_year[at]
    matches = np.bincount(at[pair], minlength=len(od))
    pri = o["o_orderpriority"].astype(np.int64)
    gp = pri[at[pair]]
    price, qty = li["l_extendedprice"][pair], li["l_quantity"][pair]
    inner_n = np.bincount(gp, minlength=6)
    inner_sum = np.bincount(gp, weights=price, minlength=6)
    inner_max = [int(qty[gp == g].max()) if inner_n[g] else None
                 for g in range(6)]
    lone_orders = np.bincount(pri[in_year & (matches == 0)], minlength=6)
    lone_lines = late & ~pair
    lone_price = li["l_extendedprice"][lone_lines]
    lone_qty = li["l_quantity"][lone_lines]
    for q, (how, _) in JOIN_QUERIES.items():
        if q == "J7":
            continue
        if how in ("semi", "anti"):
            keep = in_year & ((matches > 0) if how == "semi" else
                              (matches == 0))
            k = np.bincount(pri[keep], minlength=6)
            tp = np.bincount(pri[keep], weights=o["o_totalprice"][keep],
                             minlength=6)
            refs[q] = {g: (int(k[g]), float(tp[g])) for g in range(1, 6)
                       if k[g]}
        else:
            out = {}
            for g in range(1, 6):
                extra = lone_orders[g] if how in ("left", "full") else 0
                if inner_n[g] + extra:
                    out[g] = (float(inner_sum[g]) if inner_n[g] else None,
                              int(inner_n[g] + extra), inner_max[g])
            if how in ("right", "full") and len(lone_price):
                out[None] = (float(lone_price.sum()), len(lone_price),
                             int(lone_qty.max()))
            refs[q] = out
    return refs


def same_bytes(a, b) -> bool:
    """Two arrow tables equal buffer for buffer."""
    return a.equals(b) and all(
        x.combine_chunks().buffers() == y.combine_chunks().buffers()
        for x, y in zip(a.columns, b.columns))


def table_groups(table):
    """{group key: row} of a query result (first column the key)."""
    cols = [table.column(i).to_pylist() for i in range(table.num_columns)]
    return {row[0]: tuple(row[1:]) for row in zip(*cols)}


def compare_groups(got: dict, want: dict, rel: float, what: str) -> float:
    """Check a query's groups against numpy's: the same keys, integers and
    nulls equal, floats within ``rel``.  Returns the largest float error
    over its limit."""
    check(set(got) == set(want),
          f"{what}: groups {sorted(got, key=str)} against "
          f"{sorted(want, key=str)}")
    worst = 0.0
    for g, row in want.items():
        for a, b in zip(got[g], row):
            if isinstance(b, float) and a is not None:
                ratio = abs(a - b) / float(rel_limit(a, b, rel))
                check(ratio <= 1.0, f"{what}, group {g}: {a!r} against "
                                    f"{b!r} beyond {rel} relative")
                worst = max(worst, ratio)
            else:
                check(a == b, f"{what}, group {g}: {a!r} against {b!r}")
    return worst


def join_output(session, df):
    """The join operator of ``df``'s plan and its output rows of one more
    run, as one arrow table."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.arrow import to_arrow
    join = _find(session.plan(df._plan), "TpuShuffledHashJoin")[0]
    return join, pa.concat_tables(to_arrow(b) for part in join.execute()
                                  for b in part)


def _find(node, kind: str):
    out = [node] if type(node).__name__ == kind else []
    for c in node.children:
        out.extend(_find(c, kind))
    return out


def join_phase(args, kernels_used) -> dict:
    """Phase 5: J1-J7 through the port at TPC-H scale ``--sf``.  Returns
    the B1/B2 launches of the join path (the queries' first and second
    runs)."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.kernels import cuda_ops
    from spark_rapids_tpu_torch.plan import overrides
    on_card = args.device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    tables = make_tpch(args.sf, args.seed)
    refs = join_references(tables)
    rows = {n: len(next(iter(t.values()))) for n, t in tables.items()}
    print(f"join data + numpy references: sf {args.sf}, {rows} in "
          f"{time.perf_counter() - t0:.1f}s")
    batch_rows, threshold, chunk_rows = join_scale(args.sf)
    overrides.BROADCAST_ROW_THRESHOLD = threshold   # for the process
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    session = TpuSession(TpuConf(conf), device=args.device)
    frames = join_frames(session, tables)
    t0 = time.perf_counter()
    for df in frames.values():
        session.plan(df._plan).execute()        # uploads the table once
    sync()
    print(f"join tables uploaded in {time.perf_counter() - t0:.3f}s")

    def run(df):
        sync()
        t0 = time.perf_counter()
        table = df.to_arrow()
        sync()
        return table, time.perf_counter() - t0

    cuda_ops.reset_launches()
    for q, (how, side) in JOIN_QUERIES.items():
        df = join_query(F, frames, q)
        physical = session.plan(df._plan)
        plan = physical.tree_string()
        node = f"TpuShuffledHashJoin[{how}, build={side}]"
        check(node in plan, f"{q}: {node} not planned:\n{plan}")
        join = _find(physical, "TpuShuffledHashJoin")[0]
        check([type(c).__name__ for c in join.children] ==
              ["TpuShuffleExchange"] * 2,
              f"{q}: the join is not over two exchanges:\n{plan}")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        before = dict(cuda_ops.LAUNCHES)
        (t1, cold), (t2, warm) = run(df), run(df)
        peak = torch.cuda.max_memory_allocated() if on_card else None
        launches = {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items()}
        worst = max(compare_groups(table_groups(t), refs[q], EXACT_REL,
                                   f"{q} run {i}")
                    for i, t in enumerate((t1, t2)))
        check(same_bytes(t1, t2), f"{q}: the two runs are not byte-identical")
        sides = ("orders", "lineitem") if q != "J7" else \
            ("lineitem", "partsupp")
        in_rows = rows[sides[0]] + rows[sides[1]]
        # every joined row lands in one group, null keys included
        join_out = sum(t1.column("cnt").to_pylist())
        print(f"{q} {how:5s} build={side:5s}: {t1.num_rows} groups; "
              f"input rows {in_rows}, join output rows {join_out}; cold "
              f"{cold:.4f}s warm {warm:.4f}s; warm {in_rows / warm / 1e6:.3f} "
              f"Mrows/s; peak device memory {peak} B; launches (2 runs) "
              f"{launches}; byte-identical runs; matches numpy at "
              f"{EXACT_REL} (worst error/limit {worst!r})")
    by_path = dict(cuda_ops.LAUNCHES)
    print("plan J7:\n" + join_query(F, frames, "J7").explain())

    # J1 under the profiler; J2 again with small expansion chunks
    if on_card:
        profile_query(join_query(F, frames, "J1"))
    chunked = TpuSession(TpuConf({**conf,
                                  "spark.rapids.tpu.sql.join.gather."
                                  "chunkRows": chunk_rows}),
                         device=args.device)
    df = join_query(F, join_frames(chunked, tables), "J2")
    table, secs = run(df)
    worst = compare_groups(table_groups(table), refs["J2"], EXACT_REL,
                           "chunked J2")
    # the aggregate rounds each batch's exact sum, so other chunk bounds
    # may move a sum's last bit: the join's own rows must not move at all
    whole, whole_rows = join_output(session, join_query(F, frames, "J2"))
    split, split_rows = join_output(chunked, df)
    check(split.expand_counts["chunks"] > split.expand_counts["batches"],
          f"J2 with chunkRows {chunk_rows}: no batch expanded in chunks "
          f"({split.expand_counts})")
    check(whole.expand_counts["chunks"] == whole.expand_counts["batches"],
          f"J2 expanded in chunks by default ({whole.expand_counts})")
    check(same_bytes(split_rows, whole_rows),
          "J2's join rows differ with chunked expansion")
    print(f"J2 with chunkRows {chunk_rows}: {split.expand_counts}; cold "
          f"{secs:.4f}s; join output ({split_rows.num_rows} rows) "
          f"byte-identical to J2's; matches numpy at {EXACT_REL} (worst "
          f"error/limit {worst!r})")
    for name in kernels_used:
        check(by_path.get(name, 0) > 0,
              f"{name} never launched on the join path")
    return by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=64_000_000)
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of phase 5's tables")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: also time its "
                         "kernels at the raw-row shapes with this timer")
    args = ap.parse_args(argv)

    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.kernels import cuda_ops

    # 1. probe
    if args.device == "cuda":
        check(torch.cuda.is_available(), "no CUDA device: nothing to smoke")
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi_line()
        print(f"device: {kind} x{count}; torch {torch.__version__} "
              f"cuda {torch.version.cuda}")
        print(f"nvidia-smi: {smi}")

        # 2. build
        t0 = time.perf_counter()
        reports = cuda_ops.build_all()
        print(f"build: {len(reports)} kernels in "
              f"{time.perf_counter() - t0:.1f}s")
        for name, rep in reports.items():
            for line in rep.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"  {name}: {line.strip()}")

        # 3. kernels against their plain versions
        kernels = kernel_phase(np.random.default_rng(args.seed), args.parent)

    # 4. the headline query
    t0 = time.perf_counter()
    data, dim = make_data(args.rows, args.seed)
    ref = numpy_reference(data, dim)
    print(f"query data + numpy reference: {args.rows} rows in "
          f"{time.perf_counter() - t0:.1f}s")
    batch_rows = 1 << 22
    if args.device == "cuda":
        variable_sum_precision(data, ref, PARTITIONS, batch_rows)
    base = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    results = {}
    for mode, variable in (("exact", False), ("variable", True)):
        conf = TpuConf({**base,
                        "spark.rapids.tpu.sql.variableFloatAgg.enabled":
                            variable})
        session = TpuSession(conf, device=args.device)
        df = None           # the last mode's device tables go first
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        df, times, tables, launches = run_query(session, data, dim,
                                                PARTITIONS, args.device)
        rel = VARIABLE_REL if variable else EXACT_REL
        worst = max(compare(t, ref, rel, f"{mode} run {i}")
                    for i, t in enumerate(tables))
        if not variable:
            same = all(a.equals(b) for a, b in
                       zip(tables[0].columns, tables[1].columns))
            check(same, "exact mode: the two runs are not byte-identical")
        peak = torch.cuda.max_memory_allocated() if args.device == "cuda" \
            else None
        results[mode] = launches[0]
        if args.device == "cuda":
            ops = profile_query(df)
            left = [o for o in STAGE_REPLACED_OPS if o in ops]
            check(not left,
                  f"{mode} query still runs {left} beside the kernels")
        print(f"query {mode} on {args.device}: {tables[0].num_rows} groups; "
              f"cold "
              f"{times[0]:.4f}s warm {times[1]:.4f}s; warm "
              f"{args.rows / times[1] / 1e6:.3f} Mrows/s; peak device "
              f"memory {peak} B; launches {launches[0]}; "
              f"{'byte-identical runs; ' if not variable else ''}matches "
              f"numpy at {rel} (worst error/limit {worst!r})")
    print("plan:\n" + df.explain())
    df = session = None         # phase 4's table leaves the card

    # 5. shuffled joins at TPC-H scale
    results["join"] = join_phase(
        args, list(kernels) if args.device == "cuda" else [])

    if args.device != "cuda":
        print("cpu rehearsal: no device result")
        return 0
    for name in kernels:
        by_path = {mode: results[mode][name] for mode in results}
        for mode, got in by_path.items():
            check(got > 0, f"{name} never launched on the {mode} path")
        kernels[name]["launches"] = by_path["exact"]
        kernels[name]["launches_by_path"] = by_path
    print(json.dumps({"kernels": list(kernels.values())}))
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
