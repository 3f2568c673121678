"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Runs from the repository root:

    python3 chip_smoke.py                      # full size, on the card
    python3 chip_smoke.py --rows 4000000       # a shorter query phase
    python3 chip_smoke.py --device cpu --rows 200000   # CPU rehearsal
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
   is profiled and must call none of STAGE_REPLACED_OPS.
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
    """One more warm run under torch.profiler: device time by op and the
    device's busy share of the (profiled) wall time.  Returns the names
    of the ops the run called."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.to_arrow()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    names = {e.key for e in averages}
    events = [e for e in averages
              if getattr(e, "self_device_time_total", 0) > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    if not events:
        print("profile: the profiler saw no device time")
        return names
    print(f"profile: wall {wall_us / 1e3:.3f} ms (profiled), device busy "
          f"{dev_us / 1e3:.3f} ms = {100 * dev_us / wall_us:.1f}% of wall")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    return names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=64_000_000)
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

    if args.device != "cuda":
        print("cpu rehearsal: no device result")
        return 0
    for name in kernels:
        by_path = {mode: results[mode][name] for mode in results}
        for mode, got in by_path.items():
            check(got > 0, f"{name} never launched on the {mode} query path")
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
