"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Runs from the repository root:

    python3 chip_smoke.py                      # full size, on the card
    python3 chip_smoke.py --rows 4000000       # a shorter query phase
    python3 chip_smoke.py --device cpu --rows 200000 --sf 0.05 --ds-sf 0.1
                                               # rehearsal on the CPU
    python3 chip_smoke.py --parent DIR         # also time DIR's kernels
    python3 chip_smoke.py --only 11            # phase 11 alone (no
                                               # contract line)

Phases (any failure exits non-zero):
1. probe: a CUDA device is required; prints its name, count and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles every kernel of ``spark_rapids_tpu_torch/csrc`` with
   nvcc and prints each one's registers and shared memory;
3. kernels: each kernel against its plain torch version on the card at
   the main path's shapes (B1: the exchange's split and the ids alone;
   B2: the table core's reduce stage and the TPU kernel's raw rows; the
   join probe at q17's and q78's join partitions, at one key, at the star
   joins' four dimensions and at a build past the L2), device-timed
   behind a sleep kernel (``time_cuda``) beside its byte bound (3.35
   TB/s), its host cost per call, the plain version and a one-call
   PyTorch yardstick where one exists; the probe's separator table
   against its threads per SM (``probe_tradeoff``);
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
   expands in small chunks.  B1 and B2 must launch on this path;
6. TPC-DS: the six tables of q3, q42, q52 and q96 at scale ``--ds-sf``
   (default 10: store_sales 28.8M rows in 8 Parquet files) written to a
   temporary directory, registered as temp views, and the queries' text
   run through ``session.sql``.  Each must plan the expected operators,
   match a pyarrow computation (1e-9, ORDER BY kept, ties as a
   multiset), and give the same bytes on two warm runs; cold and warm
   times, peak memory and a profile of q3 are printed.  B1 must launch;
7. flat TPC-DS: the 17 more tables of the 21 queries without subqueries
   (DS7_QUERIES) in the same directory, with returns drawn from sales
   (``make_tpcds7`` lists every departure from ``generate``), and each
   query's text through the same session: its plan's limit, sort,
   aggregate and join operators as DS7_PLANS lists (no cross join; below
   SF10 the broadcast threshold shrinks with the scale), a cold and two
   warm runs against a pyarrow computation (``ds7_references``; 1e-9,
   ORDER BY kept, ties as a multiset, also at the LIMIT's cut), warm
   runs byte-identical, rows unless DS7_EMPTY names the query; q17 runs
   once more under the profiler (launches and host-to-device copies).
   B1 and the join probe must launch;
8. TPC-DS with derived tables and CTEs: the 15 queries of DS8_QUERIES
   (q28 and q88 cross-join one-row aggregates in a TpuNestedLoopJoin)
   verbatim through the same session on the same tables, each with
   DS8_PLANS' operators, a cold and two warm runs against a pyarrow
   computation (``ds8_references``), warm runs byte-identical, rows
   unless DS8_EMPTY names the query, and B1, B2 and probe launches per
   query; q78 and q64 run once more under the profiler.  B1 and the
   join probe must launch;
9. TPC-DS with expression subqueries: the 12 queries of DS9_QUERIES
   (scalar, ``IN``, ``EXISTS`` and correlated scalar queries) verbatim
   through the same session on the same tables, each run timed as
   ``session.sql(text).to_arrow()``, so that the subqueries that run
   while the text is lowered are inside the wall (``SqlRun``), with
   DS9_PLANS' operators, a cold and two warm runs against a pyarrow
   computation (``ds9_references``), warm runs byte-identical, rows
   unless DS9_EMPTY names the query, the lowering's share and B1, B2
   and probe launches per query; q10 and q1 run once more under the
   profiler.  B1 and the join probe must launch;
10. TPC-DS with set operations, SELECT DISTINCT and DATE columns: the 15
   queries of DS10_QUERIES (UNION ALL reports over the three channels,
   the year-over-year customer totals, INTERSECT and EXCEPT of customer
   sets, q83's DATE keys) verbatim through the same session on the same
   tables, timed as in phase 9, each with DS10_PLANS' operators, a cold
   and two warm runs against a pyarrow computation
   (``ds10_references``), warm runs byte-identical, rows unless
   DS10_EMPTY names the query, peak memory and B1, B2 and probe launches
   per query; q4 and q87 run once more under the profiler.  B1 and the
   join probe must launch;
11. TPC-DS with window functions: the 10 queries of DS11_QUERIES
   (revenue shares of an item class, month and quarter outliers against
   a partition's mean, ranks, q51's running totals over a full outer
   join) verbatim through the same session on the same tables, timed as
   in phase 9, each with DS11_PLANS' operators (every window over a hash
   exchange on its PARTITION BY keys or a coalesce), a cold and two warm
   runs against pyarrow and numpy (``ds11_references``), warm runs
   byte-identical, rows unless DS11_EMPTY names the query, peak memory
   and B1, B2 and probe launches per query; q51 runs once more under the
   profiler.  B1 and the join probe must launch.
The line before the last is a JSON object of every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
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
    """One kernel line; ``replaces`` is a line of pallas_ops.py, or a
    ``file:line`` of the JAX package for a kernel of the port alone."""
    ms, host_ms = timed
    if ":" not in replaces:
        replaces = f"spark_rapids_tpu/kernels/pallas_ops.py:{replaces}"
    return {"name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/csrc/{source}",
            "replaces": replaces,
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


def q3_exchange_words(rng, n: int):
    """The hash words of q3's exchange (phase 6) for a partial aggregate's
    n output slots: d_year, i_brand_id, and i_brand's folded word and
    length."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.arrow import from_arrow
    from spark_rapids_tpu_torch.expr import core as ec
    from spark_rapids_tpu_torch.shuffle.partitioners import HashPartitioner
    table = pa.table({
        "d_year": pa.array(rng.integers(1998, 2003, n).astype(np.int32)),
        "i_brand_id": pa.array(rng.integers(1000000, 1000100, n)),
        "i_brand": pa.array([f"brand#{i}" for i in
                             rng.integers(0, 100, n)])})
    keys = [ec.AttributeReference("d_year", T.INT32),
            ec.AttributeReference("i_brand_id", T.INT64),
            ec.AttributeReference("i_brand", T.STRING)]
    return HashPartitioner(keys, 8)._key_words(from_arrow(table, "cuda"))


def ds7_exchange_words(rng, which: str, n: int, device: str = "cuda"):
    """The hash words of two of phase 7's exchanges at SF10, built as the
    exchange builds them (``HashPartitioner._key_words``).  ``"join"``:
    q17's store_sales side of its join with store_returns, keys
    ss_customer_sk, ss_item_sk and ss_ticket_number (3 words) over a map
    batch of n rows.  ``"agg"``: q25's aggregate exchange, keys
    i_item_id, i_item_desc, s_store_id and s_store_name (a folded word
    and a length each: 8 words) over a partial aggregate's n groups.
    Returns (words, live mask) of the batch, padded to its capacity."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.arrow import from_arrow
    from spark_rapids_tpu_torch.expr import core as ec
    from spark_rapids_tpu_torch.shuffle.partitioners import HashPartitioner
    if which == "join":
        cols = {
            "ss_customer_sk": rng.integers(
                0, DS7_ROWS_PER_SF["customer"] * 10, n),
            "ss_item_sk": rng.integers(0, DS_ROWS_PER_SF["item"] * 10, n),
            "ss_ticket_number": rng.integers(
                0, DS_ROWS_PER_SF["store_sales"] * 10, n) // 4}
        table = pa.table({k: pa.array(v) for k, v in cols.items()})
        keys = [ec.AttributeReference(k, T.INT64) for k in cols]
    else:
        item = rng.integers(0, DS_ROWS_PER_SF["item"] * 10, n)
        store = rng.integers(0, 120, n)
        table = pa.table({
            "i_item_id": pa.array([f"AAAAAAAA{i:08d}" for i in item]),
            "i_item_desc": pa.array([f"desc of item {i}" for i in item]),
            "s_store_id": pa.array([f"AAAAAAAA{i:04d}" for i in store]),
            "s_store_name": pa.array(rng.choice(
                ["ese", "ought", "able", "pri"], n))})
        keys = [ec.AttributeReference(k, T.STRING)
                for k in table.column_names]
    batch = from_arrow(table, device)
    return HashPartitioner(keys, 8)._key_words(batch), batch.live_mask()


def check_ds7_split(rng, which: str, rows: int, what: str):
    """B1's split of one of phase 7's exchanges (``ds7_exchange_words``)
    against its plain version."""
    words, live = ds7_exchange_words(rng, which, rows)
    cap = live.shape[0]
    return check_hash_split(rng, cap, len(words), 8, rows / cap, words,
                            what, live=live)


def check_hash_split(rng, n: int, num_words: int, parts: int,
                     live_frac: float, words=None, what: str = "",
                     live=None):
    """B1 redesigned: the exchange's split against a stable sort of the
    ids + bincount, bit for bit (of random words and rows, or of
    ``words`` and ``live``)."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    if words is None:
        words = random_words(rng, n, num_words)
    if live is None:
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
        f"{live_frac:.0%} live{what}", 0.0,
        time_cuda(lambda: cuda_ops.hash_split(words, live, parts)),
        time_cuda(lambda: cuda_ops.hash_split_plain(words, live, parts),
                  iters=5, queued=False)[0],
        n * 8 * num_words + n + n * 8 + (parts + 1) * 8,
        design="counting-sort split",
        sort_path_ms=time_cuda(sort_path, iters=5, queued=False)[0],
        sort_ms=time_cuda(lambda: torch.sort(key, stable=True))[0])


#: a join partition of phase 7/8 at SF10: a store_sales map batch's
#: capacity and live rows (28.8M rows in 8 part files) against
#: store_returns' rows (2.88M) in one of 8 partitions
PROBE_CAP, PROBE_LIVE = 1 << 22, 28_800_000 // 8
PROBE_BUILD = 2_880_000 // 8
#: a build of 6 words past the H100's 50 MB L2 (156 MB of live rows)
PROBE_BIG_BUILD = 3_250_000


def probe_tables(names, stream, build, device: str = "cuda"):
    """The join probe's inputs, built by the join's own ``_key_words``: a
    store_sales stream batch of PROBE_LIVE live rows (capacity PROBE_CAP)
    holding the int64 key columns ``names`` (``stream``), against the
    sorted build of ``build``'s rows (capacity a power of two, as the
    engine pads it).  Returns (build table, probe words, live mask, rank
    word positions)."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import (Column,
                                                        bucket_capacity)
    from spark_rapids_tpu_torch.columnar.schema import Field, Schema
    from spark_rapids_tpu_torch.exec.tpu_join import _key_words
    from spark_rapids_tpu_torch.expr import core as ec
    from spark_rapids_tpu_torch.kernels import join as join_k

    def batch(cols, cap):
        rows = len(cols[0])
        live = torch.arange(cap, device=device) < rows
        data = [torch.zeros(cap, dtype=torch.int64, device=device)
                for _ in cols]
        for d, c in zip(data, cols):
            d[:rows] = torch.from_numpy(c).to(device)
        schema = Schema([Field(n, T.INT64, True) for n in names])
        return ColumnarBatch(schema, [Column(T.INT64, d, live)
                                      for d in data], rows, device=device)
    exprs = [ec.BoundReference(i, T.INT64) for i in range(len(names))]
    sb = batch(stream, PROBE_CAP)
    bb = batch(build, bucket_capacity(len(build[0])))
    bwords, _ = _key_words(exprs, bb, bb.live_mask(), [None] * len(names))
    live = sb.live_mask()
    words, rank = _key_words(exprs, sb, live, [None] * len(names))
    return join_k.build(bwords), words, live, rank


def probe_inputs(rng, keys: int, device: str = "cuda",
                 build_rows: int = PROBE_BUILD):
    """The join probe at a phase 7/8 join partition (``probe_tables``):
    a store_sales stream batch against a build of ``build_rows`` lines
    drawn from it, as phase 7 draws returns from sales.  ``keys``: 3
    (q17's ss_customer_sk, ss_item_sk, ss_ticket_number), 2 (q78's
    ss_ticket_number, ss_item_sk) or 1 (ss_ticket_number)."""
    highs = {"ss_customer_sk": DS7_ROWS_PER_SF["customer"] * 10,
             "ss_item_sk": DS_ROWS_PER_SF["item"] * 10,
             "ss_ticket_number": DS_ROWS_PER_SF["store_sales"] * 10 // 4}
    names = {3: ["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
             2: ["ss_ticket_number", "ss_item_sk"],
             1: ["ss_ticket_number"]}[keys]
    stream = [rng.integers(0, highs[n], PROBE_LIVE) for n in names]
    pick = rng.choice(PROBE_LIVE, build_rows, replace=False)
    return probe_tables(names, stream, [c[pick] for c in stream], device)


def star_probe_inputs(rng, dim: str, device: str = "cuda"):
    """A star join's probe (``probe_tables``): a store_sales batch's
    foreign key, uniform over the dimension's keys as ``make_tpcds`` draws
    it, against the dimension's keys (STAR_BUILDS), one key of 2 words."""
    name, rows, first = STAR_BUILDS[dim]
    stream = [first + rng.integers(0, rows, PROBE_LIVE)]
    return probe_tables([name], stream,
                        [first + rng.permutation(rows)], device)


def check_join_probe(inputs, what: str, old=None):
    """The join probe on ``inputs`` (``probe_inputs`` or
    ``star_probe_inputs``) against its plain version (two ``_bsearch``
    loops), bit for bit, and with ``old`` (the parent checkout's
    ``cuda_ops``) also the parent's kernel, equal and timed.  On one key
    (2 words) it also times ``torch.searchsorted`` of the value word,
    lower and upper bound, over the build's live rows: the library
    call."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    from spark_rapids_tpu_torch.kernels.basic import SIGN64
    bt, words, live, rank = inputs
    n, k, bn = live.shape[0], len(words), bt.capacity
    build_live = int((bt.sorted_words[0] == 1).sum())
    lo, cnt = cuda_ops.join_probe(bt.sorted_words, words, live, rank,
                                  bt.index)
    plo, pcnt = cuda_ops.join_probe_plain(bt.sorted_words, words, live,
                                          rank)
    torch.cuda.synchronize()
    err = int(max((lo - plo).abs().max(), (cnt - pcnt).abs().max()))
    check(err == 0, f"join_probe differs from _bsearch{what}: {err}")
    check(int(cnt.sum()) >= build_live,
          f"join_probe{what}: fewer matches than build rows")
    extra = {}
    if old is not None:
        olo, ocnt = old.join_probe(bt.sorted_words, words, live, rank)
        torch.cuda.synchronize()
        check(torch.equal(olo, lo) and torch.equal(ocnt, cnt),
              f"the parent's join_probe differs{what}")
        extra["parent_ms"] = time_cuda(lambda: old.join_probe(
            bt.sorted_words, words, live, rank))[0]
    library = None
    if k == 2:
        bval = (bt.sorted_words[1][bt.sorted_words[0] == 1] ^
                SIGN64).contiguous()
        pval = words[1] ^ SIGN64

        def lib():
            torch.searchsorted(bval, pval)
            torch.searchsorted(bval, pval, right=True)
        library = time_cuda(lib)[0]
    return kernel_entry(
        "join_probe", "join_probe.cu", "spark_rapids_tpu/kernels/join.py:41",
        f"probe {n} rows ({int(live.sum())} live) x {k} words against "
        f"{build_live} build rows ({bn} capacity){what}", float(err),
        time_cuda(lambda: cuda_ops.join_probe(bt.sorted_words, words, live,
                                              rank, bt.index)),
        time_cuda(lambda: cuda_ops.join_probe_plain(
            bt.sorted_words, words, live, rank), iters=3, queued=False)[0],
        n * 8 * k + bn * 8 * k + n + 2 * n * 8, library_ms=library,
        design=f"separator table in shared memory (stride "
               f"{bt.index.stride}), interleaved rows, galloping upper "
               f"bound", **extra)


#: the probe's launch shapes measured against each other (phase 3)
TRADEOFF_TABLES_PER_SM = (1, 2, 4)
TRADEOFF_THREADS = (256, 512, 1024)


def probe_tradeoff(inputs, what: str) -> list:
    """The separator table's size against the threads per SM: the probe
    timed with an index for 1, 2 or 4 tables per SM (each the SM's share
    of shared memory) and 256, 512 or 1024 threads per block, each equal
    to the default index's result."""
    import torch
    from spark_rapids_tpu_torch.kernels import cuda_ops
    bt, words, live, rank = inputs
    want = cuda_ops.join_probe(bt.sorted_words, words, live, rank, bt.index)
    out = []
    for tables in TRADEOFF_TABLES_PER_SM:
        for threads in TRADEOFF_THREADS:
            index = cuda_ops.probe_index(
                bt.sorted_words, cuda_ops.probe_budget(tables), threads)
            got = cuda_ops.join_probe(bt.sorted_words, words, live, rank,
                                      index)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"join_probe{what} differs at {tables} tables per SM, "
                  f"{threads} threads")
            ms = time_cuda(lambda: cuda_ops.join_probe(
                bt.sorted_words, words, live, rank, index))[0]
            out.append({"tables_per_sm": tables, "threads": threads,
                        "stride": index.stride, "ms": ms})
            print(f"probe tradeoff{what}: {tables} table(s) per SM, "
                  f"{threads} threads, stride {index.stride}: {ms:.6f} ms",
                  flush=True)
    return out


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
    old = None
    if parent:
        old = load_parent_ops(parent)
        old.build_all()

    def probe(inputs, what):
        return lambda: check_join_probe(inputs(), what, old)
    # each kernel's main-path check comes first among its checks
    split_main = lambda: check_hash_split(rng, 4096, 1, 8, 0.25)
    stage_main = lambda: check_table_stage(rng, big, 4096, "partial")
    probe_main = probe(lambda: probe_inputs(rng, 3), " (q17's join)")
    checks = [
        # B1: the split at the main path's shape (a partial table of 4096
        # slots, ~1000 live), at a whole batch, and at the partition limit
        split_main,
        lambda: check_hash_split(rng, big, 1, 8, 1.0),
        lambda: check_hash_split(rng, big, 1, 1, 0.9),
        lambda: check_hash_split(rng, big, 2, cuda_ops.SPLIT_MAX_PARTS, 0.9),
        # q3's exchange (phase 6): a partial aggregate's 1024 slots, ~300
        # live groups, keys d_year, i_brand_id and i_brand (4 words)
        lambda: check_hash_split(rng, 1024, 4, 8, 0.3,
                                 q3_exchange_words(rng, 1024),
                                 " (q3's exchange words)"),
        # phase 7's exchanges: q17's 3-key join on a store_sales map
        # batch (28.8M rows in 8 part files), and q25's aggregate on 4
        # string keys (8 words) over about its 18,177 groups
        lambda: check_ds7_split(rng, "join", DS7_MAP_ROWS,
                                " (q17's join exchange words)"),
        lambda: check_ds7_split(rng, "agg", 20000,
                                " (q25's aggregate exchange words)"),
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
        # the join probe: q17's 3-key join, q78's 2-key store_sales /
        # store_returns join, one key beside torch.searchsorted, the star
        # joins' dimensions, and a 6-word build past the L2
        probe_main,
        probe(lambda: probe_inputs(rng, 2), " (q78's ss/sr join)"),
        probe(lambda: probe_inputs(rng, 1), " (one key)"),
        *[probe(lambda d=d: star_probe_inputs(rng, d), f" ({d} star)")
          for d in STAR_BUILDS],
        probe(lambda: probe_inputs(rng, 3, build_rows=PROBE_BIG_BUILD),
              " (a build past the L2)"),
    ]
    if parent:
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
        if measure in (split_main, stage_main, probe_main):
            main[entry["name"]] = entry
        print("kernel", json.dumps(entry), flush=True)
    main["join_probe"]["tradeoff"] = {
        what: probe_tradeoff(inputs(), what) for what, inputs in (
            (" (q17's join)", lambda: probe_inputs(rng, 3)),
            (" (customer star)", lambda: star_probe_inputs(rng, "customer")))}
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


#: the kernels of spark_rapids_tpu_torch/csrc, by name
PORT_KERNELS = ("hash_partition_kernel", "split_hist_kernel",
                "split_scan_kernel", "split_scatter_kernel",
                "table_stage_kernel", "join_probe_kernel")


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
    # the trace's raw events: building the profiler's event tree
    # (``prof.events()``, ``key_averages()``) takes minutes for a run of
    # 270,000 launches; the names and device times are the same
    events = prof.profiler.kineto_results.events()
    names = {e.name() for e in events}
    # device events alone: an op's CPU event spans its kernels' time too,
    # so summing every event counts the device twice
    device = [e for e in events
              if e.device_type() == torch.autograd.DeviceType.CUDA and
              not e.is_user_annotation()]
    if not device:
        print("profile: the profiler saw no device time")
        return names
    by_name = {}
    for e in device:
        us, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    dev_us = sum(us for us, _ in by_name.values())
    copies = sum(n for name, (_, n) in by_name.items()
                 if name.startswith(("Memcpy", "Memset")))
    htod = sum(n for name, (_, n) in by_name.items() if "HtoD" in name)
    print(f"profile: wall {wall_us / 1e3:.3f} ms (profiled), device busy "
          f"{dev_us / 1e3:.3f} ms = {100 * dev_us / wall_us:.1f}% of wall; "
          f"{len(device) - copies} kernel launches, {copies} copies and "
          f"memsets, of which {htod} host-to-device copies")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top 12, and the port's own kernels wherever they rank
    for rank, (name, (us, n)) in enumerate(ranked):
        if rank < 12 or any(k in name for k in PORT_KERNELS):
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
    default_threshold = overrides.BROADCAST_ROW_THRESHOLD
    overrides.BROADCAST_ROW_THRESHOLD = threshold   # until the phase ends
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
    overrides.BROADCAST_ROW_THRESHOLD = default_threshold
    return by_path


# -- phase 6: the TPC-DS quartet over Parquet at SF10 -------------------------

#: rows per scale factor of the six tables the quartet reads
#: (benchmarks/tpcds.py ROWS_PER_SF; store scales with max(sf, 1))
DS_ROWS_PER_SF = {"store_sales": 2_880_000, "item": 18_000,
                  "household_demographics": 7_200}
DS_TABLES = ("date_dim", "time_dim", "item", "store",
             "household_demographics", "store_sales")
DS_QUERIES = ("q3", "q42", "q52", "q96")
DS_PARTS = 8                        # store_sales part files
DS_BATCH_ROWS = 1 << 22             # batchSizeRows of phase 6
#: share of each store_sales part's rows that are baskets (``_baskets``),
#: and a basket's lines, low and high (exclusive)
DS_BASKET_SHARE = 0.1
DS_BASKET_LINES = (8, 17)
DATE_SK0 = 2450815                  # 1998-01-01
N_DATES = 365 * 5                   # 1998-2002
#: the star joins' dimensions at SF10: (store_sales key, rows, first key)
STAR_BUILDS = {"store": ("ss_store_sk", 120, 0),
               "date_dim": ("ss_sold_date_sk", N_DATES, DATE_SK0),
               "item": ("ss_item_sk", 180_000, 0),
               "customer": ("ss_customer_sk", 1_000_000, 0)}
#: the physical plan of each query, one operator per line, top down
_DS_STAR = ["TpuGlobalLimit", "TpuCoalescePartitions", "TpuLocalLimit",
            "TpuProject", "TpuSort",
            "TpuShuffleExchange[RangePartitioner(8)]",
            "TpuHashAggregate[final", "TpuShuffleExchange[HashPartitioner(8)]",
            "TpuHashAggregate[partial",
            "TpuBroadcastHashJoin[inner, build=right]",
            "TpuBroadcastHashJoin[inner, build=left]",
            "TpuBroadcastExchange", "TpuFilter",
            "TpuFileScan[parquet, 1 files", "TpuFileScan[parquet, 8 files",
            "TpuBroadcastExchange",
            "TpuFilter", "TpuFileScan[parquet, 1 files"]
DS_PLANS = {
    "q3": _DS_STAR, "q42": _DS_STAR, "q52": _DS_STAR,
    "q96": ["TpuGlobalLimit", "TpuCoalescePartitions", "TpuLocalLimit",
            "TpuProject[cnt]", "TpuSort", "TpuHashAggregate[final",
            "TpuCoalescePartitions", "TpuHashAggregate[partial",
            "TpuBroadcastHashJoin[inner, build=right]",
            "TpuBroadcastHashJoin[inner, build=right]",
            "TpuBroadcastHashJoin[inner, build=right]",
            "TpuFileScan[parquet, 8 files", "TpuBroadcastExchange",
            "TpuFilter", "TpuFileScan[parquet, 1 files",
            "TpuBroadcastExchange", "TpuFilter",
            "TpuFileScan[parquet, 1 files", "TpuBroadcastExchange",
            "TpuFilter", "TpuFileScan[parquet, 1 files"]}
#: ORDER BY of each query: (output column, ascending)
DS_ORDER = {"q3": [("d_year", True), ("sum_agg", False), ("brand_id", True)],
            "q42": [("total_sales", False), ("d_year", True),
                    ("i_category_id", True), ("i_category", True)],
            "q52": [("d_year", True), ("ext_price", False),
                    ("brand_id", True)],
            "q96": [("cnt", True)]}


def _baskets(r, m: int, ticket_cols) -> np.ndarray:
    """Make the first DS_BASKET_SHARE of a store_sales part's ``m`` rows
    baskets, in place: runs of DS_BASKET_LINES lines that share one draw
    of each ``(array, low, high)`` of ``ticket_cols``.  Returns the basket
    (0, 1, ...) of each of those rows."""
    k = int(m * DS_BASKET_SHARE)
    sizes = r.integers(*DS_BASKET_LINES, k // DS_BASKET_LINES[0] + 1)
    basket = np.repeat(np.arange(len(sizes)), sizes)[:k]
    nb = int(basket[-1]) + 1 if k else 0
    for arr, lo, hi in ticket_cols:
        arr[:k] = r.integers(lo, hi, nb)[basket]
    return basket


def make_tpcds(data_dir: str, scale: float, seed: int) -> dict:
    """The six tables of the quartet as Parquet under ``data_dir``, with
    the formulas, names and types of ``benchmarks/tpcds.py`` ``generate``
    at ``scale``; store_sales in DS_PARTS part files, each drawn from its
    own seeded generator.  One departure from ``generate``, for q34 (its
    ticket of 15 to 20 lines that pass ticket-level filters): the first
    DS_BASKET_SHARE (10%) of each part's rows are baskets, tickets of 8
    to 16 lines that share a ticket number past ``generate``'s range and
    one date, time, customer, demographics, household, address and store,
    as the lines of one TPC-DS ticket do (``generate`` draws every line's
    own, so no ticket holds more than one customer's line and q34 is
    empty at every scale); the other rows, and every column's type, are
    ``generate``'s.  Returns each table's row count."""
    import os
    import pyarrow as pa
    import pyarrow.parquet as papq
    rng = np.random.default_rng(seed)
    n = {k: max(int(v * scale), 64) for k, v in DS_ROWS_PER_SF.items()}
    n["store"] = max(int(12 * max(scale, 1)), 4)

    def write(name, table):
        papq.write_table(table, os.path.join(data_dir, f"{name}.parquet"))

    days = (np.datetime64("1998-01-01") +
            np.arange(N_DATES).astype("timedelta64[D]"))
    ymd = days.astype("datetime64[D]")
    years = ymd.astype("datetime64[Y]").astype(int) + 1970
    months = ymd.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (ymd - ymd.astype("datetime64[M]")).astype(int) + 1
    dow = ((ymd.astype("datetime64[D]").astype(int) + 4) % 7)
    qoy = (months - 1) // 3 + 1
    day_names = np.array(["Sunday", "Monday", "Tuesday", "Wednesday",
                          "Thursday", "Friday", "Saturday"])
    write("date_dim", pa.table({
        "d_date_sk": (DATE_SK0 + np.arange(N_DATES)).astype(np.int64),
        "d_date": ymd,
        "d_year": years.astype(np.int32),
        "d_moy": months.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": qoy.astype(np.int32),
        "d_dow": dow.astype(np.int32),
        "d_day_name": day_names[dow],
        "d_month_seq": ((years - 1900) * 12 + months - 1).astype(np.int32),
        "d_week_seq": ((ymd.astype(int) - ymd.astype(int).min()) // 7 +
                       5200).astype(np.int32),
        "d_quarter_name": np.array([f"{y}Q{q}" for y, q in zip(years, qoy)]),
    }))
    write("time_dim", pa.table({
        "t_time_sk": np.arange(86400, dtype=np.int64),
        "t_time": np.arange(86400, dtype=np.int64),
        "t_hour": (np.arange(86400) // 3600).astype(np.int32),
        "t_minute": ((np.arange(86400) % 3600) // 60).astype(np.int32),
    }))
    ni = n["item"]
    write("item", pa.table({
        "i_item_sk": np.arange(ni, dtype=np.int64),
        "i_item_id": np.array([f"AAAAAAAA{i:08d}" for i in range(ni)]),
        "i_item_desc": np.array([f"desc of item {i}" for i in range(ni)]),
        "i_brand_id": rng.integers(1000000, 1000100, ni).astype(np.int64),
        "i_brand": np.array([f"brand#{i % 100}" for i in range(ni)]),
        "i_class": rng.choice(["dresses", "shirts", "pants", "football",
                               "fishing", "classical", "rock"], ni),
        "i_class_id": rng.integers(1, 17, ni).astype(np.int64),
        "i_category": rng.choice(["Women", "Men", "Sports", "Music",
                                  "Books", "Home"], ni),
        "i_category_id": rng.integers(1, 11, ni).astype(np.int64),
        "i_manufact_id": rng.integers(1, 1000, ni).astype(np.int64),
        "i_manufact": np.array([f"manufact#{i % 1000}" for i in range(ni)]),
        "i_manager_id": rng.integers(1, 100, ni).astype(np.int64),
        "i_current_price": (rng.random(ni) * 100).round(2),
        "i_wholesale_cost": (rng.random(ni) * 80).round(2),
        "i_color": rng.choice(["red", "blue", "green", "yellow", "purple",
                               "orange", "white", "black"], ni),
        "i_size": rng.choice(["small", "medium", "large", "extra large",
                              "petite", "economy"], ni),
        "i_units": rng.choice(["Each", "Dozen", "Case", "Pallet"], ni),
        "i_product_name": np.array([f"product{i}" for i in range(ni)]),
    }))
    ns = n["store"]
    write("store", pa.table({
        "s_store_sk": np.arange(ns, dtype=np.int64),
        "s_store_id": np.array([f"AAAAAAAA{i:04d}" for i in range(ns)]),
        "s_store_name": rng.choice(["ese", "ought", "able", "pri"], ns),
        "s_state": rng.choice(["TN", "SD", "AL", "GA"], ns),
        "s_county": rng.choice(["Williamson County", "Ziebach County",
                                "Walker County"], ns),
        "s_city": rng.choice(["Midway", "Fairview", "Oakland"], ns),
        "s_zip": np.array([f"{rng.integers(10000, 99999)}"
                           for _ in range(ns)]),
        "s_number_employees": rng.integers(200, 300, ns).astype(np.int32),
        "s_company_id": np.ones(ns, dtype=np.int32),
        "s_gmt_offset": np.full(ns, -5.0),
        "s_market_id": rng.integers(1, 11, ns).astype(np.int32),
    }))
    nh = n["household_demographics"]
    write("household_demographics", pa.table({
        "hd_demo_sk": np.arange(nh, dtype=np.int64),
        "hd_dep_count": rng.integers(0, 10, nh).astype(np.int32),
        "hd_vehicle_count": rng.integers(-1, 5, nh).astype(np.int32),
        "hd_income_band_sk": rng.integers(1, 21, nh).astype(np.int64),
        "hd_buy_potential": rng.choice(["0-500", "501-1000", "1001-5000",
                                        "5001-10000", ">10000", "Unknown"],
                                       nh),
    }))
    # the other dimensions' sizes, as generate's foreign keys see them
    nc = max(int(100_000 * scale), 64)
    nd = max(int(19_208 * scale), 64)
    na = max(int(50_000 * scale), 64)
    npx = max(int(300 * scale), 64)
    nss = n["store_sales"]
    ss_dir = os.path.join(data_dir, "store_sales.parquet")
    bounds = np.linspace(0, nss, DS_PARTS + 1).astype(np.int64)
    os.makedirs(ss_dir)
    for part in range(DS_PARTS):
        r = np.random.default_rng([seed, part])
        m = int(bounds[part + 1] - bounds[part])
        price = (r.random(m) * 200).round(2)
        qty = r.integers(1, 100, m)
        wcost = (r.random(m) * 100).round(2)
        ext_sales = (price * qty).round(2)
        ext_wcost = (wcost * qty).round(2)
        sold = (DATE_SK0 + r.integers(0, N_DATES, m)).astype(np.int64)
        t = r.integers(0, 86400, m).astype(np.int64)
        item = r.integers(0, ni, m).astype(np.int64)
        cust = r.integers(0, nc, m).astype(np.int64)
        cdemo = r.integers(0, nd, m).astype(np.int64)
        hdemo = r.integers(0, nh, m).astype(np.int64)
        addr = r.integers(0, na, m).astype(np.int64)
        store = r.integers(0, ns, m).astype(np.int64)
        promo = r.integers(0, npx, m).astype(np.int64)
        ticket = (r.integers(0, nss, m) // 4).astype(np.int64)
        basket = _baskets(np.random.default_rng([seed, part, 8]), m, [
            (sold, DATE_SK0, DATE_SK0 + N_DATES), (t, 0, 86400),
            (cust, 0, nc), (cdemo, 0, nd), (hdemo, 0, nh), (addr, 0, na),
            (store, 0, ns)])
        # past generate's tickets; a part has at most bounds[part + 1] -
        # bounds[part] baskets, so the parts' ranges do not meet
        ticket[:len(basket)] = nss // 4 + int(bounds[part]) + basket
        papq.write_table(pa.table({
            "ss_sold_date_sk": sold,
            "ss_sold_time_sk": t,
            "ss_item_sk": item,
            "ss_customer_sk": cust,
            "ss_cdemo_sk": cdemo,
            "ss_hdemo_sk": hdemo,
            "ss_addr_sk": addr,
            "ss_store_sk": store,
            "ss_promo_sk": promo,
            "ss_ticket_number": ticket,
            "ss_quantity": qty.astype(np.int32),
            "ss_wholesale_cost": wcost,
            "ss_list_price": (price * 1.2).round(2),
            "ss_sales_price": price,
            "ss_ext_discount_amt": (r.random(m) * 100).round(2),
            "ss_ext_sales_price": ext_sales,
            "ss_ext_wholesale_cost": ext_wcost,
            "ss_ext_list_price": (price * 1.2 * qty).round(2),
            "ss_ext_tax": (ext_sales * 0.08).round(2),
            "ss_coupon_amt": (r.random(m) * 50).round(2),
            "ss_net_paid": (ext_sales * 0.95).round(2),
            "ss_net_paid_inc_tax": (ext_sales * 1.03).round(2),
            "ss_net_profit": (ext_sales - ext_wcost).round(2),
        }), os.path.join(ss_dir, f"part-{part:05d}.parquet"))
    return {"date_dim": N_DATES, "time_dim": 86400, "item": ni,
            "store": ns, "household_demographics": nh, "store_sales": nss}


def ds_references(data_dir: str) -> dict:
    """Each query's full result (every group, before its LIMIT), by
    pyarrow joins, group-bys and sorts written apart from the port."""
    import os
    import pyarrow.compute as pc
    import pyarrow.parquet as papq

    def read(name, cols, **kw):
        return papq.read_table(os.path.join(data_dir, f"{name}.parquet"),
                               columns=cols, **kw)
    out = {}
    ss = read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                              "ss_ext_sales_price"])
    for q, item_pred, date_pred in (
            ("q3", ("i_manufact_id", 128), [("d_moy", 11)]),
            ("q42", ("i_manager_id", 1), [("d_moy", 11), ("d_year", 2000)]),
            ("q52", ("i_manager_id", 1), [("d_moy", 11), ("d_year", 2000)])):
        dd = read("date_dim", ["d_date_sk", "d_year", "d_moy"])
        for col, v in date_pred:
            dd = dd.filter(pc.equal(dd[col], v))
        it = read("item", ["i_item_sk", "i_brand_id", "i_brand",
                           "i_category_id", "i_category", item_pred[0]])
        it = it.filter(pc.equal(it[item_pred[0]], item_pred[1]))
        j = ss.join(dd, keys="ss_sold_date_sk", right_keys="d_date_sk",
                    join_type="inner") \
            .join(it, keys="ss_item_sk", right_keys="i_item_sk",
                  join_type="inner")
        keys = ["d_year", "i_category_id", "i_category"] if q == "q42" \
            else ["d_year", "i_brand_id", "i_brand"]
        g = j.group_by(keys).aggregate([("ss_ext_sales_price", "sum")])
        out[q] = [tuple(r.values()) for r in g.to_pylist()]
    ss = read("store_sales", ["ss_sold_time_sk", "ss_hdemo_sk",
                              "ss_store_sk"])
    hd = read("household_demographics", ["hd_demo_sk", "hd_dep_count"])
    td = read("time_dim", ["t_time_sk", "t_hour", "t_minute"])
    st = read("store", ["s_store_sk", "s_store_name"])
    hd = hd.filter(pc.equal(hd["hd_dep_count"], 7))
    td = td.filter(pc.and_(pc.equal(td["t_hour"], 20),
                           pc.greater_equal(td["t_minute"], 30)))
    st = st.filter(pc.equal(st["s_store_name"], "ese"))
    j = ss.join(hd, keys="ss_hdemo_sk", right_keys="hd_demo_sk",
                join_type="inner") \
        .join(td, keys="ss_sold_time_sk", right_keys="t_time_sk",
              join_type="inner") \
        .join(st, keys="ss_store_sk", right_keys="s_store_sk",
              join_type="inner")
    out["q96"] = [(j.num_rows,)]
    return out


def _order_key(q: str, names, row):
    """The row's ORDER BY values, each descending one negated."""
    return tuple(row[names.index(c)] if asc else -row[names.index(c)]
                 for c, asc in DS_ORDER[q])


def check_ds_rows(q: str, table, full: list) -> int:
    """The port's rows against the reference's groups: every row one of
    them (strings and integers equal, sums within EXACT_REL), as many rows
    as the LIMIT keeps, in ORDER BY order; rows whose order keys tie may
    come in any order.  Returns the reference's group count."""
    names = table.column_names
    rows = [tuple(r.values()) for r in table.to_pylist()]
    check(len(rows) == min(100, len(full)),
          f"{q}: {len(rows)} rows, the reference has {len(full)} groups")
    ref = {r[:-1]: r[-1] for r in full}
    for r in rows:
        key, v = r[:-1], r[-1]
        check(key in ref, f"{q}: row {r} is no group of the reference")
        want = ref[key]
        check(v == want if isinstance(v, int) else
              abs(v - want) <= EXACT_REL * max(abs(want), 1.0),
              f"{q}: {key}: {v} against the reference's {want}")
    keys = [_order_key(q, names, r) for r in rows]
    check(keys == sorted(keys), f"{q}: rows out of ORDER BY order")
    # the first rows of the reference's own order hold the same order keys
    ref_rows = sorted((k + (v,) for k, v in ref.items()),
                      key=lambda r: _order_key(q, names, r))[:len(rows)]
    want_keys = [_order_key(q, names, r) for r in ref_rows]
    for a, b in zip(keys, want_keys):
        check(all(x == y or (isinstance(x, float) and abs(x - y) <=
                             EXACT_REL * max(abs(y), 1.0))
                  for x, y in zip(a, b)),
              f"{q}: order keys {a} where the reference has {b}")
    return len(full)


def cold_and_warm(session, df, on_card: bool):
    """A query's cold run (the device scan cache emptied, the kernels'
    launch counts and the peak memory reset) and two warm runs: (cold
    table, cold s, the cold scans' host read s and upload s, warm tables,
    warm s, peak device bytes or None off the card).  ``cuda_ops.LAUNCHES``
    then holds the three runs' launches."""
    import torch
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.kernels import cuda_ops

    def run():
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = df.to_arrow()
        if on_card:
            torch.cuda.synchronize()
        return table, time.perf_counter() - t0

    DeviceScanCache.get().clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    cold, cold_s = run()
    scans = _find(session.last_physical_plan, "TpuFileScan")
    read_s = sum(s.timings["read_s"] for s in scans)
    upload_s = sum(s.timings["upload_s"] for s in scans)
    warm, warm_s = zip(*[run() for _ in range(2)])
    peak = torch.cuda.max_memory_allocated() if on_card else None
    return cold, cold_s, read_s, upload_s, warm, warm_s, peak


def tpcds_phase(args, kernels_used, data_dir: str):
    """Phase 6: the verbatim text of TPC-DS q3, q42, q52 and q96 through
    the port's ``session.sql`` over Parquet temp views at scale
    ``--ds-sf``, written under ``data_dir``.  Returns B1's launches on
    this path and the session (phase 7 goes on with it)."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmarks"))
    from tpcds_queries import QUERIES
    check("spark_rapids_tpu" not in sys.modules,
          "the query corpus imported the JAX package")
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.kernels import cuda_ops
    on_card = args.device == "cuda"

    t0 = time.perf_counter()
    rows = make_tpcds(data_dir, args.ds_sf, args.seed)
    t1 = time.perf_counter()
    refs = ds_references(data_dir)
    print(f"tpcds data: sf {args.ds_sf}, {rows}, store_sales in "
          f"{DS_PARTS} files, written in {t1 - t0:.1f}s; pyarrow "
          f"references in {time.perf_counter() - t1:.1f}s")
    session = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                  DS_BATCH_ROWS}), device=args.device)
    for t in DS_TABLES:
        session.read.parquet(os.path.join(data_dir, f"{t}.parquet")) \
            .create_or_replace_temp_view(t)
    cache = DeviceScanCache.get()
    cache.clear()
    launches = {k: 0 for k in cuda_ops.LAUNCHES}
    for q in DS_QUERIES:
        df = session.sql(QUERIES[q])
        plan = df.explain()
        lines = [ln.strip() for ln in plan.splitlines()]
        check(len(lines) == len(DS_PLANS[q]) and
              all(ln.startswith(w) for ln, w in zip(lines, DS_PLANS[q])),
              f"{q}: not the planned operators:\n{plan}")
        cold, cold_s, read_s, upload_s, warm, warm_s, peak = \
            cold_and_warm(session, df, on_card)
        for name, v in cuda_ops.LAUNCHES.items():
            launches[name] += v
        groups = check_ds_rows(q, cold, refs[q])
        for t in warm:
            check_ds_rows(q, t, refs[q])
        check(same_bytes(warm[0], warm[1]),
              f"{q}: the two warm runs are not byte-identical")
        check(cold.num_rows > 0, f"{q}: no rows")
        if q == "q3" and args.ds_sf >= 10:
            # at SF10 the LIMIT cuts: ~180 items of manufacturer 128
            check(groups > 100, f"q3: {groups} groups, not more than "
                  f"its LIMIT 100")
        ss_rows = rows["store_sales"]
        print(f"{q}: {cold.num_rows} rows of {groups} groups; cold "
              f"{cold_s:.4f}s (host read {read_s:.4f}s, upload "
              f"{upload_s:.4f}s); warm {warm_s[0]:.4f}s "
              f"{warm_s[1]:.4f}s; warm {ss_rows / warm_s[1] / 1e6:.3f} "
              f"Mrows/s of store_sales; peak device memory {peak} B; "
              f"launches (3 runs) {dict(cuda_ops.LAUNCHES)}; "
              f"byte-identical warm runs; matches pyarrow at "
              f"{EXACT_REL}; first rows {cold.slice(0, 3).to_pylist()}")
    print("plan q3:\n" + session.sql(QUERIES["q3"]).explain())
    if on_card:
        before = cuda_ops.LAUNCHES["hash_partition_ids"]
        profile_query(session.sql(QUERIES["q3"]))
        b1 = cuda_ops.LAUNCHES["hash_partition_ids"] - before
        print(f"profile q3: B1 hash_split launches {b1}")
        check(b1 > 0, "q3's profiled run launched no hash_split")
    cache.clear()
    for name in kernels_used:
        check(launches.get(name, 0) > 0,
              f"{name} never launched on the TPC-DS path")
    return launches, session


# -- phase 7: the flat TPC-DS queries over Parquet at SF10 -------------------

#: the 21 TPC-DS queries without subqueries, CTEs, windows, ROLLUP or set
#: operations
DS7_QUERIES = ("q7", "q13", "q15", "q17", "q19", "q21", "q25", "q26", "q29",
               "q37", "q40", "q43", "q48", "q50", "q55", "q62", "q82",
               "q84", "q85", "q91", "q99")
#: rows per scale factor of the tables phase 7 adds (benchmarks/tpcds.py
#: ROWS_PER_SF)
DS7_ROWS_PER_SF = {"customer": 100_000, "customer_address": 50_000,
                   "customer_demographics": 19_208, "promotion": 300,
                   "catalog_sales": 1_440_000, "web_sales": 720_000,
                   "store_returns": 288_000, "catalog_returns": 144_000,
                   "web_returns": 72_000, "inventory": 1_000_000}
DS7_TABLES = ("customer", "customer_address", "customer_demographics",
              "income_band", "promotion", "warehouse", "ship_mode",
              "reason", "call_center", "web_site", "web_page",
              "catalog_sales", "web_sales", "store_returns",
              "catalog_returns", "web_returns", "inventory")
#: part files of catalog_sales and web_sales
DS7_PARTS = 8
#: rows of one store_sales part file (a map batch) at SF10
DS7_MAP_ROWS = DS_ROWS_PER_SF["store_sales"] * 10 // DS_PARTS
#: share of catalog_sales rows that repeat a store return's (customer,
#: item) 0-60 days after the return
DS7_REPEAT_SHARE = 0.1
#: a return comes this many days after its sale (1 to 120)
DS7_RETURN_DAYS = (1, 121)
#: queries allowed an empty answer at SF10, with the reason (none: below
#: SF10 a selective query may return no rows)
DS7_EMPTY: dict = {}
#: each query's plan at SF10's row estimates: its limit, sort, aggregate
#: and join operators, top down (the scans, filters, projections and
#: exchanges between them are not listed)
_BR = "TpuBroadcastHashJoin[inner, build=right]"
_BL = "TpuBroadcastHashJoin[inner, build=left]"
_SR = "TpuShuffledHashJoin[inner, build=right]"
_SL = "TpuShuffledHashJoin[inner, build=left]"
_AGG = ["TpuHashAggregate[final", "TpuHashAggregate[partial"]
_TOP = ["TpuGlobalLimit", "TpuSort"] + _AGG
DS7_PLANS = {
    "q7": _TOP + [_BR] * 4,
    "q13": _AGG + [_BR] * 5,
    "q15": _TOP + [_BR] * 3,
    "q17": _TOP + [_BR] * 5 + [_SR] * 2,
    "q19": _TOP + [_BR] * 4 + [_BL],
    "q21": _TOP + [_BR] * 3,
    "q25": _TOP + [_BR] * 5 + [_SR] * 2,
    "q26": _TOP + [_BR] * 4,
    "q29": _TOP + [_BR] * 5 + [_SR] * 2,
    "q37": _TOP + [_SL] + [_BR] + [_BL],
    "q40": _TOP + [_BR] * 3 + ["TpuShuffledHashJoin[left, build=right]"],
    "q43": _TOP + [_BR] + [_BL],
    "q48": _AGG + [_BR] * 4,
    "q50": _TOP + [_BR] * 3 + [_SR],
    "q55": _TOP + [_BR] + [_BL],
    "q62": _TOP + [_BR] * 4,
    "q82": _TOP + [_SL] + [_BR] + [_BL],
    "q84": ["TpuGlobalLimit", "TpuSort"] + [_BL] + [_BR] * 4,
    "q85": _TOP + [_BR] * 7,
    "q91": _TOP + [_BR] * 5 + [_BL],
    "q99": _TOP + [_BR] * 4}


def _ds7_rng(seed: int, *stream: int):
    return np.random.default_rng([seed, 7, *stream])


def _returns_of(r, sold_date, cols: dict, k: int) -> dict:
    """``k`` sales lines drawn without replacement (in row order): each
    keyed column of ``cols`` at those lines, and the sale's date plus
    DS7_RETURN_DAYS."""
    pick = np.sort(r.permutation(len(sold_date))[:k])
    out = {name: c[pick] for name, c in cols.items()}
    out["_returned"] = sold_date[pick] + r.integers(*DS7_RETURN_DAYS, k)
    return out


def make_tpcds7(data_dir: str, scale: float, seed: int) -> dict:
    """The 17 tables phase 7 adds to phase 6's (``make_tpcds``, which
    must have written store_sales under ``data_dir``), with the
    formulas, names and types of ``benchmarks/tpcds.py`` ``generate`` at
    ``scale``, except:

    - returns are drawn from sales, as TPC-DS's own generator draws them:
      each returns table holds ``generate``'s row count (10% of its sales
      table), each return a distinct sales line whose ticket or order
      number, item and customer it keeps (store_returns:
      ``sr_ticket_number``, ``sr_item_sk``, ``sr_customer_sk`` from
      store_sales; catalog_returns: ``cr_order_number``, ``cr_item_sk``,
      ``cr_returning_customer_sk`` = ``cs_bill_customer_sk``;
      web_returns: ``wr_order_number``, ``wr_item_sk``,
      ``wr_returning_customer_sk`` = ``ws_bill_customer_sk``), returned
      DS7_RETURN_DAYS (1-120) days after the sale;
    - a web return's returning demographics and address are its refunded
      ones (``wr_returning_cdemo_sk`` = ``wr_refunded_cdemo_sk``,
      ``wr_returning_addr_sk`` = ``wr_refunded_addr_sk``), TPC-DS's rule;
    - repeat purchases: a DS7_REPEAT_SHARE (10%) share of catalog_sales
      rows takes a random store return's customer
      (``cs_bill_customer_sk``) and item (``cs_item_sk``), sold
      (``cs_sold_date_sk``) 0-60 days after that return;
    - catalog_sales and web_sales are DS7_PARTS part files, each drawn
      from its own seeded generator, and string columns drawn per row in
      ``generate`` (zip codes, street numbers) are drawn as one array.

    Returns each table's row count."""
    import os
    import pyarrow as pa
    import pyarrow.parquet as papq
    from concurrent.futures import ThreadPoolExecutor
    n = {k: max(int(v * scale), 64) for k, v in DS7_ROWS_PER_SF.items()}
    ni = max(int(DS_ROWS_PER_SF["item"] * scale), 64)
    nh = max(int(DS_ROWS_PER_SF["household_demographics"] * scale), 64)
    nss = max(int(DS_ROWS_PER_SF["store_sales"] * scale), 64)
    nc, na = n["customer"], n["customer_address"]
    nd, npx = n["customer_demographics"], n["promotion"]
    rng = _ds7_rng(seed, 0)
    rows = {}

    def write(name, table):
        rows[name] = table.num_rows
        papq.write_table(table, os.path.join(data_dir, f"{name}.parquet"))

    def ids(prefix, count, width):
        return np.char.add(prefix, np.char.zfill(
            np.arange(count).astype(str), width))

    write("customer", pa.table({
        "c_customer_sk": np.arange(nc, dtype=np.int64),
        "c_customer_id": ids("AAAAAAAA", nc, 8),
        "c_current_addr_sk": rng.integers(0, na, nc).astype(np.int64),
        "c_current_cdemo_sk": rng.integers(0, nd, nc).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(0, nh, nc).astype(np.int64),
        "c_first_name": rng.choice(["John", "Mary", "Ann", "Sam", "Pat",
                                    "Lee", "Kim", "Dana"], nc),
        "c_last_name": rng.choice(["Smith", "Jones", "Brown", "Lee",
                                   "Walker", "Hill"], nc),
        "c_salutation": rng.choice(["Mr.", "Mrs.", "Ms.", "Dr."], nc),
        "c_birth_country": rng.choice(["UNITED STATES", "CANADA", "MEXICO",
                                       "GERMANY"], nc),
        "c_birth_year": rng.integers(1930, 1995, nc).astype(np.int32),
        "c_birth_month": rng.integers(1, 13, nc).astype(np.int32),
        "c_preferred_cust_flag": rng.choice(["Y", "N"], nc),
        "c_email_address": np.char.add(np.char.add(
            "c", np.arange(nc).astype(str)), "@example.com"),
        "c_login": np.char.add("login", np.arange(nc).astype(str)),
        "c_first_sales_date_sk": (DATE_SK0 + rng.integers(0, N_DATES, nc))
        .astype(np.int64),
        "c_first_shipto_date_sk": (DATE_SK0 + rng.integers(0, N_DATES, nc))
        .astype(np.int64),
    }))
    write("customer_address", pa.table({
        "ca_address_sk": np.arange(na, dtype=np.int64),
        "ca_zip": rng.integers(10000, 99999, na).astype(str),
        "ca_state": rng.choice(["TN", "SD", "AL", "GA", "CA", "TX", "NY",
                                "OH"], na),
        "ca_city": rng.choice(["Midway", "Fairview", "Oakland",
                               "Springfield", "Salem"], na),
        "ca_county": rng.choice(["Williamson County", "Ziebach County",
                                 "Walker County", "Rush County"], na),
        "ca_country": np.full(na, "United States"),
        "ca_gmt_offset": rng.choice([-5.0, -6.0, -7.0, -8.0], na),
        "ca_location_type": rng.choice(["apartment", "condo",
                                        "single family"], na),
        "ca_street_number": rng.integers(1, 1000, na).astype(str),
        "ca_street_name": rng.choice(["Main", "Oak", "Elm", "Park", "First",
                                      "Second"], na),
    }))
    write("customer_demographics", pa.table({
        "cd_demo_sk": np.arange(nd, dtype=np.int64),
        "cd_gender": rng.choice(["M", "F"], nd),
        "cd_marital_status": rng.choice(["S", "M", "D", "W", "U"], nd),
        "cd_education_status": rng.choice(
            ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"], nd),
        "cd_dep_count": rng.integers(0, 7, nd).astype(np.int32),
        "cd_purchase_estimate": (rng.integers(1, 12, nd) * 500)
        .astype(np.int32),
        "cd_credit_rating": rng.choice(["Low Risk", "Good", "High Risk",
                                        "Unknown"], nd),
        "cd_dep_employed_count": rng.integers(0, 7, nd).astype(np.int32),
        "cd_dep_college_count": rng.integers(0, 7, nd).astype(np.int32),
    }))
    write("income_band", pa.table({
        "ib_income_band_sk": np.arange(1, 21, dtype=np.int64),
        "ib_lower_bound": (np.arange(20) * 10000).astype(np.int32),
        "ib_upper_bound": ((np.arange(20) + 1) * 10000).astype(np.int32),
    }))
    write("promotion", pa.table({
        "p_promo_sk": np.arange(npx, dtype=np.int64),
        "p_channel_email": rng.choice(["Y", "N"], npx),
        "p_channel_event": rng.choice(["Y", "N"], npx),
        "p_channel_dmail": rng.choice(["Y", "N"], npx),
        "p_channel_tv": rng.choice(["Y", "N"], npx),
    }))
    write("warehouse", pa.table({
        "w_warehouse_sk": np.arange(5, dtype=np.int64),
        "w_warehouse_name": np.array([f"Warehouse {i}" for i in range(5)]),
        "w_warehouse_sq_ft": (np.arange(5) * 10000 + 50000).astype(np.int32),
        "w_state": np.array(["TN", "SD", "AL", "GA", "CA"]),
        "w_country": np.full(5, "United States"),
        "w_city": np.array(["Midway", "Fairview", "Oakland", "Springfield",
                            "Salem"]),
        "w_county": np.full(5, "Williamson County"),
    }))
    write("ship_mode", pa.table({
        "sm_ship_mode_sk": np.arange(20, dtype=np.int64),
        "sm_type": np.array((["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR",
                              "TWO DAY"] * 4)[:20]),
        "sm_carrier": np.array((["UPS", "FEDEX", "AIRBORNE", "USPS",
                                 "DHL"] * 4)[:20]),
    }))
    write("reason", pa.table({
        "r_reason_sk": np.arange(35, dtype=np.int64),
        "r_reason_desc": np.array([f"reason {i}" for i in range(35)]),
    }))
    write("call_center", pa.table({
        "cc_call_center_sk": np.arange(6, dtype=np.int64),
        "cc_name": np.array([f"call center {i}" for i in range(6)]),
        "cc_manager": np.array([f"Manager {i}" for i in range(6)]),
        "cc_county": np.full(6, "Williamson County"),
    }))
    write("web_site", pa.table({
        "web_site_sk": np.arange(30, dtype=np.int64),
        "web_site_id": np.array([f"AAAAAAAA{i:04d}" for i in range(30)]),
        "web_name": np.array([f"site_{i}" for i in range(30)]),
        "web_company_name": rng.choice(["pri", "ought", "able"], 30),
    }))
    write("web_page", pa.table({
        "wp_web_page_sk": np.arange(60, dtype=np.int64),
        "wp_char_count": rng.integers(4000, 6000, 60).astype(np.int32),
    }))
    nin = n["inventory"]
    write("inventory", pa.table({
        "inv_date_sk": (DATE_SK0 + rng.integers(0, N_DATES // 7, nin) * 7)
        .astype(np.int64),
        "inv_item_sk": rng.integers(0, ni, nin).astype(np.int64),
        "inv_warehouse_sk": rng.integers(0, 5, nin).astype(np.int64),
        "inv_quantity_on_hand": rng.integers(0, 1000, nin).astype(np.int32),
    }))

    ns = max(int(12 * max(scale, 1)), 4)
    nsr = n["store_returns"]
    ncs, nws = n["catalog_sales"], n["web_sales"]
    ncr, nwr = n["catalog_returns"], n["web_returns"]
    ncp = max(int(11_718 * scale), 64)

    def sales_parts(name, total, returns, make):
        """Write ``name`` in DS7_PARTS part files on threads; each part
        also draws its share of the returns.  Returns the drawn lines."""
        bounds = np.linspace(0, total, DS7_PARTS + 1).astype(np.int64)
        rets = np.diff(np.linspace(0, returns, DS7_PARTS + 1)
                       .astype(np.int64))
        out_dir = os.path.join(data_dir, f"{name}.parquet")
        os.makedirs(out_dir)

        def one(part):
            r = _ds7_rng(seed, 2 if name == "catalog_sales" else 3, part)
            table, keyed = make(r, int(bounds[part + 1] - bounds[part]))
            papq.write_table(table, os.path.join(
                out_dir, f"part-{part:05d}.parquet"))
            return _returns_of(r, keyed.pop("_sold"), keyed,
                               int(rets[part]))
        with ThreadPoolExecutor(4) as pool:
            drawn = list(pool.map(one, range(DS7_PARTS)))
        rows[name] = total
        return {c: np.concatenate([d[c] for d in drawn]) for c in drawn[0]}

    def catalog_sales(r, m):
        cprice = (r.random(m) * 200).round(2)
        cqty = r.integers(1, 100, m)
        cwcost = (r.random(m) * 100).round(2)
        cext = (cprice * cqty).round(2)
        sold = (DATE_SK0 + r.integers(0, N_DATES, m)).astype(np.int64)
        cust = r.integers(0, nc, m).astype(np.int64)
        item = r.integers(0, ni, m).astype(np.int64)
        order = (r.integers(0, ncs, m) // 3).astype(np.int64)
        # repeat purchases of store returns
        rep = np.flatnonzero(r.random(m) < DS7_REPEAT_SHARE)
        src = r.integers(0, nsr, len(rep))
        cust[rep] = sr["ss_customer_sk"][src]
        item[rep] = sr["ss_item_sk"][src]
        sold[rep] = sr["_returned"][src] + r.integers(0, 61, len(rep))
        table = pa.table({
            "cs_sold_date_sk": sold,
            "cs_sold_time_sk": r.integers(0, 86400, m).astype(np.int64),
            "cs_ship_date_sk": (DATE_SK0 + r.integers(0, N_DATES, m))
            .astype(np.int64),
            "cs_bill_customer_sk": cust,
            "cs_bill_cdemo_sk": r.integers(0, nd, m).astype(np.int64),
            "cs_bill_hdemo_sk": r.integers(0, nh, m).astype(np.int64),
            "cs_bill_addr_sk": r.integers(0, na, m).astype(np.int64),
            "cs_ship_addr_sk": r.integers(0, na, m).astype(np.int64),
            "cs_ship_mode_sk": r.integers(0, 20, m).astype(np.int64),
            "cs_call_center_sk": r.integers(0, 6, m).astype(np.int64),
            "cs_catalog_page_sk": r.integers(0, ncp, m).astype(np.int64),
            "cs_warehouse_sk": r.integers(0, 5, m).astype(np.int64),
            "cs_item_sk": item,
            "cs_promo_sk": r.integers(0, npx, m).astype(np.int64),
            "cs_order_number": order,
            "cs_quantity": cqty.astype(np.int32),
            "cs_wholesale_cost": cwcost,
            "cs_list_price": (cprice * 1.2).round(2),
            "cs_sales_price": cprice,
            "cs_ext_discount_amt": (r.random(m) * 100).round(2),
            "cs_ext_sales_price": cext,
            "cs_ext_wholesale_cost": (cwcost * cqty).round(2),
            "cs_ext_list_price": (cprice * 1.2 * cqty).round(2),
            "cs_ext_ship_cost": (cext * 0.05).round(2),
            "cs_coupon_amt": (r.random(m) * 50).round(2),
            "cs_net_paid": (cext * 0.95).round(2),
            "cs_net_paid_inc_ship": (cext * 1.02).round(2),
            "cs_net_profit": (cext - cwcost * cqty).round(2),
        })
        return table, {"_sold": sold, "order": order, "item": item,
                       "cust": cust}

    def web_sales(r, m):
        wprice = (r.random(m) * 200).round(2)
        wqty = r.integers(1, 100, m)
        wwcost = (r.random(m) * 100).round(2)
        wext = (wprice * wqty).round(2)
        sold = (DATE_SK0 + r.integers(0, N_DATES, m)).astype(np.int64)
        item = r.integers(0, ni, m).astype(np.int64)
        cust = r.integers(0, nc, m).astype(np.int64)
        order = (r.integers(0, nws, m) // 3).astype(np.int64)
        table = pa.table({
            "ws_sold_date_sk": sold,
            "ws_sold_time_sk": r.integers(0, 86400, m).astype(np.int64),
            "ws_ship_date_sk": (DATE_SK0 + r.integers(0, N_DATES, m))
            .astype(np.int64),
            "ws_item_sk": item,
            "ws_bill_customer_sk": cust,
            "ws_bill_addr_sk": r.integers(0, na, m).astype(np.int64),
            "ws_ship_customer_sk": r.integers(0, nc, m).astype(np.int64),
            "ws_ship_addr_sk": r.integers(0, na, m).astype(np.int64),
            "ws_web_page_sk": r.integers(0, 60, m).astype(np.int64),
            "ws_web_site_sk": r.integers(0, 30, m).astype(np.int64),
            "ws_ship_mode_sk": r.integers(0, 20, m).astype(np.int64),
            "ws_warehouse_sk": r.integers(0, 5, m).astype(np.int64),
            "ws_promo_sk": r.integers(0, npx, m).astype(np.int64),
            "ws_order_number": order,
            "ws_quantity": wqty.astype(np.int32),
            "ws_wholesale_cost": wwcost,
            "ws_list_price": (wprice * 1.2).round(2),
            "ws_sales_price": wprice,
            "ws_ext_discount_amt": (r.random(m) * 100).round(2),
            "ws_ext_sales_price": wext,
            "ws_ext_wholesale_cost": (wwcost * wqty).round(2),
            "ws_ext_list_price": (wprice * 1.2 * wqty).round(2),
            "ws_ext_ship_cost": (wext * 0.05).round(2),
            "ws_net_paid": (wext * 0.95).round(2),
            "ws_net_profit": (wext - wwcost * wqty).round(2),
        })
        return table, {"_sold": sold, "order": order, "item": item,
                       "cust": cust}

    # store_returns: drawn from phase 6's store_sales, part by part
    ss_files = sorted(os.listdir(os.path.join(data_dir,
                                              "store_sales.parquet")))
    take = np.diff(np.linspace(0, nsr, len(ss_files) + 1).astype(np.int64))
    drawn = []
    for part, (f, k) in enumerate(zip(ss_files, take)):
        ss = papq.read_table(
            os.path.join(data_dir, "store_sales.parquet", f),
            columns=["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                     "ss_ticket_number"])
        cols = {c: ss[c].to_numpy() for c in ss.column_names}
        drawn.append(_returns_of(_ds7_rng(seed, 1, part),
                                 cols.pop("ss_sold_date_sk"), cols,
                                 int(k)))
    sr = {c: np.concatenate([d[c] for d in drawn]) for c in drawn[0]}
    ramt = (rng.random(nsr) * 150).round(2)
    write("store_returns", pa.table({
        "sr_returned_date_sk": sr["_returned"].astype(np.int64),
        "sr_item_sk": sr["ss_item_sk"],
        "sr_customer_sk": sr["ss_customer_sk"],
        "sr_cdemo_sk": rng.integers(0, nd, nsr).astype(np.int64),
        "sr_store_sk": rng.integers(0, ns, nsr).astype(np.int64),
        "sr_reason_sk": rng.integers(0, 35, nsr).astype(np.int64),
        "sr_ticket_number": sr["ss_ticket_number"],
        "sr_return_quantity": rng.integers(1, 50, nsr).astype(np.int32),
        "sr_return_amt": ramt,
        "sr_return_tax": (ramt * 0.08).round(2),
        "sr_return_amt_inc_tax": (ramt * 1.08).round(2),
        "sr_fee": (rng.random(nsr) * 20).round(2),
        "sr_return_ship_cost": (rng.random(nsr) * 10).round(2),
        "sr_refunded_cash": (ramt * 0.8).round(2),
        "sr_reversed_charge": (ramt * 0.1).round(2),
        "sr_store_credit": (ramt * 0.1).round(2),
        "sr_net_loss": (rng.random(nsr) * 60).round(2),
    }))

    cr = sales_parts("catalog_sales", ncs, ncr, catalog_sales)
    cramt = (rng.random(ncr) * 150).round(2)
    write("catalog_returns", pa.table({
        "cr_returned_date_sk": cr["_returned"].astype(np.int64),
        "cr_item_sk": cr["item"],
        "cr_returning_customer_sk": cr["cust"],
        "cr_returning_addr_sk": rng.integers(0, na, ncr).astype(np.int64),
        "cr_call_center_sk": rng.integers(0, 6, ncr).astype(np.int64),
        "cr_catalog_page_sk": rng.integers(0, ncp, ncr).astype(np.int64),
        "cr_reason_sk": rng.integers(0, 35, ncr).astype(np.int64),
        "cr_order_number": cr["order"],
        "cr_return_quantity": rng.integers(1, 50, ncr).astype(np.int32),
        "cr_return_amount": cramt,
        "cr_return_amt_inc_tax": (cramt * 1.08).round(2),
        "cr_net_loss": (rng.random(ncr) * 60).round(2),
        "cr_refunded_cash": (cramt * 0.8).round(2),
        "cr_reversed_charge": (cramt * 0.1).round(2),
        "cr_store_credit": (cramt * 0.1).round(2),
    }))
    wr = sales_parts("web_sales", nws, nwr, web_sales)
    wramt = (rng.random(nwr) * 150).round(2)
    refunded_cdemo = rng.integers(0, nd, nwr).astype(np.int64)
    refunded_addr = rng.integers(0, na, nwr).astype(np.int64)
    write("web_returns", pa.table({
        "wr_returned_date_sk": wr["_returned"].astype(np.int64),
        "wr_item_sk": wr["item"],
        "wr_returning_customer_sk": wr["cust"],
        "wr_returning_addr_sk": refunded_addr,
        "wr_web_page_sk": rng.integers(0, 60, nwr).astype(np.int64),
        "wr_reason_sk": rng.integers(0, 35, nwr).astype(np.int64),
        "wr_order_number": wr["order"],
        "wr_refunded_cdemo_sk": refunded_cdemo,
        "wr_returning_cdemo_sk": refunded_cdemo,
        "wr_refunded_addr_sk": refunded_addr,
        "wr_return_quantity": rng.integers(1, 50, nwr).astype(np.int32),
        "wr_return_amt": wramt,
        "wr_refunded_cash": (wramt * 0.8).round(2),
        "wr_fee": (rng.random(nwr) * 20).round(2),
        "wr_net_loss": (rng.random(nwr) * 60).round(2),
    }))
    return rows


def _ds7_tools(data_dir: str):
    """(read, join, isin, between) over pyarrow for the references."""
    import os
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as papq

    def read(name, cols, prefix=""):
        t = papq.read_table(os.path.join(data_dir, f"{name}.parquet"),
                            columns=cols)
        return t.rename_columns([prefix + c for c in cols]) if prefix else t

    def join(a, b, ka, kb, how="inner"):
        return a.join(b, keys=ka, right_keys=kb, join_type=how)

    def isin(col, values):
        return pc.is_in(col, value_set=pa.array(values))

    def between(col, lo, hi):
        return pc.and_(pc.greater_equal(col, lo), pc.less_equal(col, hi))
    return read, join, isin, between


def _grouped(t, keys, aggs, out):
    """Rows of ``t`` grouped by ``keys`` with pyarrow ``aggs``
    ([(column, function[, options])]), as tuples of the ``out`` columns
    (group keys and ``<column>_<function>`` names)."""
    g = t.group_by(keys).aggregate(aggs)
    return list(zip(*[g[c].to_pylist() for c in out]))


def _case_sum_cols(t, names_conds):
    """``sum(case when cond then 1 else 0 end)`` inputs: one int64
    column per (name, condition)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    one, zero = pa.scalar(1, pa.int64()), pa.scalar(0, pa.int64())
    for name, cond in names_conds:
        t = t.append_column(name, pc.if_else(cond, one, zero))
    return t


def ds7_references(data_dir: str, queries=DS7_QUERIES) -> dict:
    """Each phase-7 query's full result (every row before its LIMIT), in
    its select list's order, by pyarrow joins, filters, group-bys and
    compute functions written apart from the port."""
    import pyarrow as pa
    import pyarrow.compute as pc
    read, join, isin, between = _ds7_tools(data_dir)
    std = pc.VarianceOptions(ddof=1)
    out = {}

    def dates(prefix, *conds):
        d = read("date_dim", ["d_date_sk", "d_year", "d_moy", "d_qoy",
                              "d_quarter_name", "d_day_name",
                              "d_month_seq"], prefix)
        for col, fn in conds:
            d = d.filter(fn(d[prefix + col]))
        return d

    def eq(v):
        return lambda c: pc.equal(c, v)

    def q7_26(fact, p):
        cols = [f"{p}_quantity", f"{p}_list_price", f"{p}_coupon_amt",
                f"{p}_sales_price"]
        f = read(fact, [f"{p}_sold_date_sk", f"{p}_item_sk",
                        f"{p}_cdemo_sk" if p == "ss" else "cs_bill_cdemo_sk",
                        f"{p}_promo_sk"] + cols)
        cd = read("customer_demographics", ["cd_demo_sk", "cd_gender",
                                            "cd_marital_status",
                                            "cd_education_status"])
        cd = cd.filter(pc.and_(pc.and_(pc.equal(cd["cd_gender"], "M"),
                                       pc.equal(cd["cd_marital_status"], "S")),
                               pc.equal(cd["cd_education_status"], "College")))
        pr = read("promotion", ["p_promo_sk", "p_channel_email",
                                "p_channel_event"])
        pr = pr.filter(pc.or_(pc.equal(pr["p_channel_email"], "N"),
                              pc.equal(pr["p_channel_event"], "N")))
        j = join(f, dates("", ("d_year", eq(2000))), f"{p}_sold_date_sk",
                 "d_date_sk")
        j = join(j, cd, f"{p}_cdemo_sk" if p == "ss" else "cs_bill_cdemo_sk",
                 "cd_demo_sk")
        j = join(j, pr, f"{p}_promo_sk", "p_promo_sk")
        j = join(j, read("item", ["i_item_sk", "i_item_id"]), f"{p}_item_sk",
                 "i_item_sk")
        return _grouped(j, ["i_item_id"], [(c, "mean") for c in cols],
                        ["i_item_id"] + [f"{c}_mean" for c in cols])

    if "q7" in queries:
        out["q7"] = q7_26("store_sales", "ss")
    if "q26" in queries:
        out["q26"] = q7_26("catalog_sales", "cs")

    def demo_address_arms(j, p, arms, addr_arms, hd=True):
        cond = None
        for ms, es, lo, hi, dep in arms:
            c = pc.and_(pc.and_(pc.equal(j["cd_marital_status"], ms),
                                pc.equal(j["cd_education_status"], es)),
                        between(j[f"{p}_sales_price"], lo, hi))
            if dep is not None:
                c = pc.and_(c, pc.equal(j["hd_dep_count"], dep))
            cond = c if cond is None else pc.or_(cond, c)
        acond = None
        for states, lo, hi in addr_arms:
            c = pc.and_(pc.and_(pc.equal(j["ca_country"], "United States"),
                                isin(j["ca_state"], states)),
                        between(j[f"{p}_net_profit"], lo, hi))
            acond = c if acond is None else pc.or_(acond, c)
        return j.filter(pc.and_(cond, acond))

    def store_demo_address(year, extra_cols, hd):
        ss = read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                  "ss_hdemo_sk", "ss_cdemo_sk", "ss_addr_sk",
                                  "ss_sales_price", "ss_net_profit"] +
                  extra_cols)
        j = join(ss, dates("", ("d_year", eq(year))), "ss_sold_date_sk",
                 "d_date_sk")
        j = join(j, read("store", ["s_store_sk"]), "ss_store_sk",
                 "s_store_sk")
        if hd:
            j = join(j, read("household_demographics",
                             ["hd_demo_sk", "hd_dep_count"]), "ss_hdemo_sk",
                     "hd_demo_sk")
        j = join(j, read("customer_demographics",
                         ["cd_demo_sk", "cd_marital_status",
                          "cd_education_status"]), "ss_cdemo_sk",
                 "cd_demo_sk")
        return join(j, read("customer_address", ["ca_address_sk", "ca_state",
                                                 "ca_country"]),
                    "ss_addr_sk", "ca_address_sk")

    def scalar(v):
        return v.as_py()

    if "q13" in queries:
        j = store_demo_address(2001, ["ss_quantity", "ss_ext_sales_price",
                                      "ss_ext_wholesale_cost"], True)
        j = demo_address_arms(
            j, "ss", [("M", "Advanced Degree", 100.0, 150.0, 3),
                      ("S", "College", 50.0, 100.0, 1),
                      ("W", "2 yr Degree", 150.0, 200.0, 1)],
            [(["TX", "OH", "TX"], 100, 200), (["OR", "NM", "KY"], 150, 300),
             (["VA", "TX", "MS"], 50, 250)])
        out["q13"] = [(scalar(pc.mean(j["ss_quantity"])),
                       scalar(pc.mean(j["ss_ext_sales_price"])),
                       scalar(pc.mean(j["ss_ext_wholesale_cost"])),
                       scalar(pc.sum(j["ss_ext_wholesale_cost"])))]
    if "q48" in queries:
        j = store_demo_address(2000, ["ss_quantity"], False)
        j = demo_address_arms(
            j, "ss", [("M", "4 yr Degree", 100.0, 150.0, None),
                      ("D", "2 yr Degree", 50.0, 100.0, None),
                      ("S", "College", 150.0, 200.0, None)],
            [(["CO", "OH", "TX"], 0, 2000), (["OR", "MN", "KY"], 150, 3000),
             (["VA", "CA", "MS"], 50, 25000)])
        out["q48"] = [(scalar(pc.sum(j["ss_quantity"])),)]
    if "q15" in queries:
        cs = read("catalog_sales", ["cs_sold_date_sk", "cs_bill_customer_sk",
                                    "cs_sales_price"])
        j = join(cs, dates("", ("d_qoy", eq(2)), ("d_year", eq(2001))),
                 "cs_sold_date_sk", "d_date_sk")
        j = join(j, read("customer", ["c_customer_sk", "c_current_addr_sk"]),
                 "cs_bill_customer_sk", "c_customer_sk")
        j = join(j, read("customer_address", ["ca_address_sk", "ca_zip",
                                              "ca_state"]),
                 "c_current_addr_sk", "ca_address_sk")
        zips = ["85669", "86197", "88274", "83405", "86475", "85392",
                "85460", "80348", "81792"]
        j = j.filter(pc.or_(pc.or_(
            isin(pc.utf8_slice_codeunits(j["ca_zip"], 0, 5), zips),
            isin(j["ca_state"], ["CA", "WA", "GA"])),
            pc.greater(j["cs_sales_price"], 500)))
        out["q15"] = _grouped(j, ["ca_zip"], [("cs_sales_price", "sum")],
                              ["ca_zip", "cs_sales_price_sum"])

    def store_return_catalog(d1, d2, d3, cols):
        ss = read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                                  "ss_store_sk", "ss_customer_sk",
                                  "ss_ticket_number"] + cols[0])
        sr = read("store_returns", ["sr_returned_date_sk", "sr_item_sk",
                                    "sr_customer_sk", "sr_ticket_number"] +
                  cols[1])
        cs = read("catalog_sales", ["cs_sold_date_sk", "cs_bill_customer_sk",
                                    "cs_item_sk"] + cols[2])
        ss = join(ss, dates("d1_", *d1), "ss_sold_date_sk", "d1_d_date_sk")
        sr = join(sr, dates("d2_", *d2), "sr_returned_date_sk",
                  "d2_d_date_sk")
        cs = join(cs, dates("d3_", *d3), "cs_sold_date_sk", "d3_d_date_sk")
        j = join(ss, sr, ["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
                 ["sr_customer_sk", "sr_item_sk", "sr_ticket_number"])
        j = join(j, cs, ["ss_customer_sk", "ss_item_sk"],
                 ["cs_bill_customer_sk", "cs_item_sk"])
        j = join(j, read("store", ["s_store_sk", "s_store_id",
                                   "s_store_name", "s_state"]),
                 "ss_store_sk", "s_store_sk")
        return join(j, read("item", ["i_item_sk", "i_item_id",
                                     "i_item_desc"]),
                    "ss_item_sk", "i_item_sk")

    quarters = ["2001Q1", "2001Q2", "2001Q3"]
    if "q17" in queries:
        j = store_return_catalog(
            [("d_quarter_name", eq("2001Q1"))],
            [("d_quarter_name", lambda c: isin(c, quarters))],
            [("d_quarter_name", lambda c: isin(c, quarters))],
            [["ss_quantity"], ["sr_return_quantity"], ["cs_quantity"]])
        keys = ["i_item_id", "i_item_desc", "s_state"]
        aggs, cols = [], list(keys)
        for c in ("ss_quantity", "sr_return_quantity", "cs_quantity"):
            aggs += [(c, "count"), (c, "mean"), (c, "stddev", std)]
            cols += [f"{c}_count", f"{c}_mean", f"{c}_stddev", None]
        g = j.group_by(keys).aggregate(aggs)
        rows = []
        for r in g.to_pylist():
            row = []
            for c in cols:
                if c is None:          # stddev / avg of the column before
                    s, m = row[-1], row[-2]
                    row.append(None if s is None or m is None or m == 0
                               else s / m)
                else:
                    row.append(r[c])
            rows.append(tuple(row))
        out["q17"] = rows
    for q, d1, d2, d3, cols, aggs in (
            ("q25", [("d_moy", eq(4)), ("d_year", eq(2001))],
             [("d_moy", lambda c: between(c, 4, 10)), ("d_year", eq(2001))],
             [("d_moy", lambda c: between(c, 4, 10)), ("d_year", eq(2001))],
             [["ss_net_profit"], ["sr_net_loss"], ["cs_net_profit"]],
             ["ss_net_profit", "sr_net_loss", "cs_net_profit"]),
            ("q29", [("d_moy", eq(9)), ("d_year", eq(1999))],
             [("d_moy", lambda c: between(c, 9, 12)), ("d_year", eq(1999))],
             [("d_year", lambda c: isin(c, [1999, 2000, 2001]))],
             [["ss_quantity"], ["sr_return_quantity"], ["cs_quantity"]],
             ["ss_quantity", "sr_return_quantity", "cs_quantity"])):
        if q in queries:
            j = store_return_catalog(d1, d2, d3, cols)
            keys = ["i_item_id", "i_item_desc", "s_store_id", "s_store_name"]
            out[q] = _grouped(j, keys, [(c, "sum") for c in aggs],
                              keys + [f"{c}_sum" for c in aggs])
    if "q19" in queries or "q55" in queries:
        ss = read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                                  "ss_customer_sk", "ss_store_sk",
                                  "ss_ext_sales_price"])
        it = read("item", ["i_item_sk", "i_brand_id", "i_brand",
                           "i_manufact_id", "i_manufact", "i_manager_id"])
    if "q19" in queries:
        j = join(ss, dates("", ("d_moy", eq(11)), ("d_year", eq(1998))),
                 "ss_sold_date_sk", "d_date_sk")
        j = join(j, it.filter(pc.equal(it["i_manager_id"], 8)), "ss_item_sk",
                 "i_item_sk")
        j = join(j, read("customer", ["c_customer_sk", "c_current_addr_sk"]),
                 "ss_customer_sk", "c_customer_sk")
        j = join(j, read("customer_address", ["ca_address_sk", "ca_zip"]),
                 "c_current_addr_sk", "ca_address_sk")
        j = join(j, read("store", ["s_store_sk", "s_zip"]), "ss_store_sk",
                 "s_store_sk")
        j = j.filter(pc.not_equal(pc.utf8_slice_codeunits(j["ca_zip"], 0, 5),
                                  pc.utf8_slice_codeunits(j["s_zip"], 0, 5)))
        keys = ["i_brand_id", "i_brand", "i_manufact_id", "i_manufact"]
        out["q19"] = _grouped(j, keys, [("ss_ext_sales_price", "sum")],
                              keys + ["ss_ext_sales_price_sum"])
    if "q55" in queries:
        j = join(ss, dates("", ("d_moy", eq(11)), ("d_year", eq(1999))),
                 "ss_sold_date_sk", "d_date_sk")
        j = join(j, it.filter(pc.equal(it["i_manager_id"], 28)),
                 "ss_item_sk", "i_item_sk")
        out["q55"] = _grouped(j, ["i_brand_id", "i_brand"],
                              [("ss_ext_sales_price", "sum")],
                              ["i_brand_id", "i_brand",
                               "ss_ext_sales_price_sum"])
    if "q21" in queries:
        inv = read("inventory", ["inv_date_sk", "inv_item_sk",
                                 "inv_warehouse_sk", "inv_quantity_on_hand"])
        it = read("item", ["i_item_sk", "i_item_id", "i_current_price"])
        j = join(inv, it.filter(between(it["i_current_price"], 0.99, 1.49)),
                 "inv_item_sk", "i_item_sk")
        j = join(j, read("warehouse", ["w_warehouse_sk", "w_warehouse_name"]),
                 "inv_warehouse_sk", "w_warehouse_sk")
        j = join(j, dates("", ("d_year", eq(2000))), "inv_date_sk",
                 "d_date_sk")
        q = pc.cast(j["inv_quantity_on_hand"], pa.int64())
        zero = pa.scalar(0, pa.int64())
        j = j.append_column("before", pc.if_else(pc.less(j["d_moy"], 3), q,
                                                 zero))
        j = j.append_column("after", pc.if_else(
            pc.greater_equal(j["d_moy"], 3), q, zero))
        rows = _grouped(j, ["w_warehouse_name", "i_item_id"],
                        [("before", "sum"), ("after", "sum")],
                        ["w_warehouse_name", "i_item_id", "before_sum",
                         "after_sum"])
        out["q21"] = [r for r in rows if r[2] is not None and r[2] > 0]

    def inventory_items(lo, manufacts, fact, key):
        it = read("item", ["i_item_sk", "i_item_id", "i_item_desc",
                           "i_current_price", "i_manufact_id"])
        it = it.filter(pc.and_(between(it["i_current_price"], lo, lo + 30),
                               isin(it["i_manufact_id"], manufacts)))
        inv = read("inventory", ["inv_date_sk", "inv_item_sk",
                                 "inv_quantity_on_hand"])
        inv = inv.filter(between(inv["inv_quantity_on_hand"], 100, 500))
        j = join(it, inv, "i_item_sk", "inv_item_sk")
        j = join(j, dates("", ("d_year", eq(2000))), "inv_date_sk",
                 "d_date_sk")
        j = join(j, read(fact, [key]), "i_item_sk", key)
        keys = ["i_item_id", "i_item_desc", "i_current_price"]
        return _grouped(j, keys, [], keys)

    if "q37" in queries:
        out["q37"] = inventory_items(68, [677, 940, 694, 808],
                                     "catalog_sales", "cs_item_sk")
    if "q82" in queries:
        out["q82"] = inventory_items(62, [129, 270, 821, 423],
                                     "store_sales", "ss_item_sk")
    if "q40" in queries:
        cs = read("catalog_sales", ["cs_sold_date_sk", "cs_item_sk",
                                    "cs_warehouse_sk", "cs_order_number",
                                    "cs_sales_price"])
        cr = read("catalog_returns", ["cr_order_number", "cr_item_sk",
                                      "cr_return_amount"])
        j = join(cs, cr, ["cs_order_number", "cs_item_sk"],
                 ["cr_order_number", "cr_item_sk"], "left outer")
        it = read("item", ["i_item_sk", "i_item_id", "i_current_price"])
        j = join(j, it.filter(between(it["i_current_price"], 0.99, 1.49)),
                 "cs_item_sk", "i_item_sk")
        j = join(j, read("warehouse", ["w_warehouse_sk", "w_state"]),
                 "cs_warehouse_sk", "w_warehouse_sk")
        j = join(j, dates("", ("d_year", lambda c: isin(c, [1999, 2000,
                                                            2001]))),
                 "cs_sold_date_sk", "d_date_sk")
        net = pc.subtract(j["cs_sales_price"],
                          pc.coalesce(j["cr_return_amount"], 0.0))
        j = j.append_column("before", pc.if_else(pc.less(j["d_year"], 2000),
                                                 net, 0.0))
        j = j.append_column("after", pc.if_else(
            pc.greater_equal(j["d_year"], 2000), net, 0.0))
        out["q40"] = _grouped(j, ["w_state", "i_item_id"],
                              [("before", "sum"), ("after", "sum")],
                              ["w_state", "i_item_id", "before_sum",
                               "after_sum"])
    if "q43" in queries:
        ss = read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                  "ss_sales_price"])
        st = read("store", ["s_store_sk", "s_store_name", "s_store_id",
                            "s_gmt_offset"])
        j = join(ss, dates("", ("d_year", eq(2000))), "ss_sold_date_sk",
                 "d_date_sk")
        j = join(j, st.filter(pc.equal(st["s_gmt_offset"], -5.0)),
                 "ss_store_sk", "s_store_sk")
        days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                "Friday", "Saturday"]
        null = pa.scalar(None, pa.float64())
        for d in days:
            j = j.append_column(d, pc.if_else(pc.equal(j["d_day_name"], d),
                                              j["ss_sales_price"], null))
        out["q43"] = _grouped(j, ["s_store_name", "s_store_id"],
                              [(d, "sum") for d in days],
                              ["s_store_name", "s_store_id"] +
                              [f"{d}_sum" for d in days])

    def day_buckets(t, late, early):
        diff = pc.subtract(t[late], t[early])
        conds = [pc.less_equal(diff, 30),
                 pc.and_(pc.greater(diff, 30), pc.less_equal(diff, 60)),
                 pc.and_(pc.greater(diff, 60), pc.less_equal(diff, 90)),
                 pc.greater(diff, 90)]
        names = ["d30", "d31_60", "d61_90", "d90_plus"]
        return _case_sum_cols(t, list(zip(names, conds))), names

    if "q50" in queries:
        ss = read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                                  "ss_customer_sk", "ss_ticket_number",
                                  "ss_store_sk"])
        sr = read("store_returns", ["sr_returned_date_sk", "sr_item_sk",
                                    "sr_customer_sk", "sr_ticket_number"])
        sr = join(sr, dates("d2_", ("d_year", eq(2001)), ("d_moy", eq(8))),
                  "sr_returned_date_sk", "d2_d_date_sk")
        j = join(ss, sr, ["ss_ticket_number", "ss_item_sk", "ss_customer_sk"],
                 ["sr_ticket_number", "sr_item_sk", "sr_customer_sk"])
        j = join(j, dates("d1_"), "ss_sold_date_sk", "d1_d_date_sk")
        j = join(j, read("store", ["s_store_sk", "s_store_name",
                                   "s_company_id", "s_state", "s_zip"]),
                 "ss_store_sk", "s_store_sk")
        j, names = day_buckets(j, "sr_returned_date_sk", "ss_sold_date_sk")
        keys = ["s_store_name", "s_company_id", "s_state", "s_zip"]
        out["q50"] = _grouped(j, keys, [(c, "sum") for c in names],
                              keys + [f"{c}_sum" for c in names])
    for q, fact, p, site in (("q62", "web_sales", "ws",
                              ("web_site", "ws_web_site_sk", "web_site_sk",
                               "web_name")),
                             ("q99", "catalog_sales", "cs",
                              ("call_center", "cs_call_center_sk",
                               "cc_call_center_sk", "cc_name"))):
        if q not in queries:
            continue
        f = read(fact, [f"{p}_ship_date_sk", f"{p}_sold_date_sk",
                        f"{p}_warehouse_sk", f"{p}_ship_mode_sk", site[1]])
        j = join(f, dates("", ("d_month_seq",
                               lambda c: between(c, 1200, 1211))),
                 f"{p}_ship_date_sk", "d_date_sk")
        j = join(j, read("warehouse", ["w_warehouse_sk", "w_warehouse_name"]),
                 f"{p}_warehouse_sk", "w_warehouse_sk")
        j = join(j, read("ship_mode", ["sm_ship_mode_sk", "sm_type"]),
                 f"{p}_ship_mode_sk", "sm_ship_mode_sk")
        j = join(j, read(site[0], [site[2], site[3]]), site[1], site[2])
        j, names = day_buckets(j, f"{p}_ship_date_sk", f"{p}_sold_date_sk")
        keys = ["w_warehouse_name", "sm_type", site[3]]
        out[q] = _grouped(j, keys, [(c, "sum") for c in names],
                          keys + [f"{c}_sum" for c in names])
    if "q84" in queries:
        c = read("customer", ["c_customer_sk", "c_customer_id",
                              "c_current_addr_sk", "c_current_cdemo_sk",
                              "c_current_hdemo_sk", "c_first_name",
                              "c_last_name"])
        ca = read("customer_address", ["ca_address_sk", "ca_city"])
        ib = read("income_band", ["ib_income_band_sk", "ib_lower_bound",
                                  "ib_upper_bound"])
        ib = ib.filter(pc.and_(pc.greater_equal(ib["ib_lower_bound"], 30000),
                               pc.less_equal(ib["ib_upper_bound"], 80000)))
        j = join(c, ca.filter(pc.equal(ca["ca_city"], "Fairview")),
                 "c_current_addr_sk", "ca_address_sk")
        j = join(j, read("household_demographics",
                         ["hd_demo_sk", "hd_income_band_sk"]),
                 "c_current_hdemo_sk", "hd_demo_sk")
        j = join(j, ib, "hd_income_band_sk", "ib_income_band_sk")
        j = join(j, read("customer_demographics", ["cd_demo_sk"]),
                 "c_current_cdemo_sk", "cd_demo_sk")
        j = join(j, read("store_returns", ["sr_cdemo_sk"]),
                 "c_current_cdemo_sk", "sr_cdemo_sk")
        name = pc.binary_join_element_wise(j["c_last_name"], ", ",
                                           j["c_first_name"], "")
        out["q84"] = list(zip(j["c_customer_id"].to_pylist(),
                              name.to_pylist()))
    if "q85" in queries:
        ws = read("web_sales", ["ws_sold_date_sk", "ws_item_sk",
                                "ws_order_number", "ws_web_page_sk",
                                "ws_quantity", "ws_sales_price",
                                "ws_net_profit"])
        wr = read("web_returns", ["wr_item_sk", "wr_order_number",
                                  "wr_refunded_cdemo_sk",
                                  "wr_returning_cdemo_sk",
                                  "wr_refunded_addr_sk", "wr_reason_sk",
                                  "wr_refunded_cash", "wr_fee"])
        j = join(ws, wr, ["ws_item_sk", "ws_order_number"],
                 ["wr_item_sk", "wr_order_number"])
        j = join(j, read("web_page", ["wp_web_page_sk"]), "ws_web_page_sk",
                 "wp_web_page_sk")
        j = join(j, dates("", ("d_year", eq(2000))), "ws_sold_date_sk",
                 "d_date_sk")
        cd = ["cd_demo_sk", "cd_marital_status", "cd_education_status"]
        j = join(j, read("customer_demographics", cd, "cd1_"),
                 "wr_refunded_cdemo_sk", "cd1_cd_demo_sk")
        j = join(j, read("customer_demographics", cd, "cd2_"),
                 "wr_returning_cdemo_sk", "cd2_cd_demo_sk")
        j = join(j, read("customer_address", ["ca_address_sk", "ca_country",
                                              "ca_state"]),
                 "wr_refunded_addr_sk", "ca_address_sk")
        j = join(j, read("reason", ["r_reason_sk", "r_reason_desc"]),
                 "wr_reason_sk", "r_reason_sk")
        cond = None
        for ms, es, lo, hi in (("M", "Advanced Degree", 100.0, 150.0),
                               ("S", "College", 50.0, 100.0),
                               ("W", "2 yr Degree", 150.0, 200.0)):
            c = pc.and_(pc.and_(
                pc.equal(j["cd1_cd_marital_status"], ms),
                pc.equal(j["cd1_cd_marital_status"],
                         j["cd2_cd_marital_status"])), pc.and_(
                pc.equal(j["cd1_cd_education_status"], es),
                pc.equal(j["cd1_cd_education_status"],
                         j["cd2_cd_education_status"])))
            c = pc.and_(c, between(j["ws_sales_price"], lo, hi))
            cond = c if cond is None else pc.or_(cond, c)
        acond = None
        for states, lo, hi in ((["IN", "OH", "NJ"], 100, 200),
                               (["WI", "CT", "KY"], 150, 300),
                               (["LA", "IA", "AR"], 50, 250)):
            c = pc.and_(pc.and_(pc.equal(j["ca_country"], "United States"),
                                isin(j["ca_state"], states)),
                        between(j["ws_net_profit"], lo, hi))
            acond = c if acond is None else pc.or_(acond, c)
        j = j.filter(pc.and_(cond, acond))
        rows = _grouped(j, ["r_reason_desc"],
                        [("ws_quantity", "mean"), ("wr_refunded_cash", "mean"),
                         ("wr_fee", "mean")],
                        ["r_reason_desc", "ws_quantity_mean",
                         "wr_refunded_cash_mean", "wr_fee_mean"])
        out["q85"] = [(r[0][:20],) + r[1:] for r in rows]
    if "q91" in queries:
        cr = read("catalog_returns", ["cr_call_center_sk",
                                      "cr_returned_date_sk",
                                      "cr_returning_customer_sk",
                                      "cr_net_loss"])
        # the call center on the left keeps its key column
        j = join(read("call_center", ["cc_call_center_sk", "cc_name",
                                      "cc_manager"]), cr,
                 "cc_call_center_sk", "cr_call_center_sk")
        j = join(j, dates("", ("d_year", eq(1998)), ("d_moy", eq(11))),
                 "cr_returned_date_sk", "d_date_sk")
        j = join(j, read("customer", ["c_customer_sk", "c_current_cdemo_sk",
                                      "c_current_hdemo_sk",
                                      "c_current_addr_sk"]),
                 "cr_returning_customer_sk", "c_customer_sk")
        cd = read("customer_demographics", ["cd_demo_sk", "cd_marital_status",
                                            "cd_education_status"])
        cd = cd.filter(pc.or_(
            pc.and_(pc.equal(cd["cd_marital_status"], "M"),
                    pc.equal(cd["cd_education_status"], "Unknown")),
            pc.and_(pc.equal(cd["cd_marital_status"], "W"),
                    pc.equal(cd["cd_education_status"], "Advanced Degree"))))
        j = join(j, cd, "c_current_cdemo_sk", "cd_demo_sk")
        hd = read("household_demographics", ["hd_demo_sk",
                                             "hd_buy_potential"])
        hd = hd.filter(pc.match_like(hd["hd_buy_potential"], ">10000%"))
        j = join(j, hd, "c_current_hdemo_sk", "hd_demo_sk")
        ca = read("customer_address", ["ca_address_sk", "ca_gmt_offset"])
        j = join(j, ca.filter(pc.equal(ca["ca_gmt_offset"], -7.0)),
                 "c_current_addr_sk", "ca_address_sk")
        keys = ["cc_call_center_sk", "cc_name", "cc_manager"]
        out["q91"] = _grouped(j, keys, [("cr_net_loss", "sum")],
                              keys + ["cr_net_loss_sum"])
    return out


#: ORDER BY of each query: (select column position, ascending); None:
#: no ORDER BY and no LIMIT (one row)
_ASC4 = [(0, True), (1, True), (2, True), (3, True)]
DS7_ORDER = {"q7": [(0, True)], "q13": None, "q15": [(0, True)],
             "q17": _ASC4[:3], "q19": [(4, False), (0, True)],
             "q21": _ASC4[:2], "q25": _ASC4, "q26": [(0, True)],
             "q29": _ASC4, "q37": [(0, True)], "q40": _ASC4[:2],
             "q43": [(i, True) for i in range(9)], "q48": None,
             "q50": _ASC4, "q55": [(2, False), (0, True)],
             "q62": _ASC4[:3], "q82": [(0, True)], "q84": [(0, True)],
             "q85": _ASC4, "q91": [(3, False)], "q99": _ASC4[:3]}
#: the table whose rows a query's Mrows/s counts (its largest scan)
DS7_FACT = {"q7": "store_sales", "q13": "store_sales",
            "q15": "catalog_sales", "q17": "store_sales",
            "q19": "store_sales", "q21": "inventory", "q25": "store_sales",
            "q26": "catalog_sales", "q29": "store_sales",
            "q37": "catalog_sales", "q40": "catalog_sales",
            "q43": "store_sales", "q48": "store_sales", "q50": "store_sales",
            "q55": "store_sales", "q62": "web_sales", "q82": "store_sales",
            "q84": "store_returns", "q85": "web_sales",
            "q91": "catalog_returns", "q99": "catalog_sales"}


def _order_value(row, item):
    """A row's ORDER BY value: its column at position ``item``, or
    ``item(row)`` for an expression that is no select column."""
    return item(row) if callable(item) else row[item]


def _near(v):
    """A float to 9 significant digits (EXACT_REL's grain), so that two
    sums of one value added in different orders sort as ties."""
    return float(f"{v:.9g}") if isinstance(v, float) and v == v else v


def _sort_rows(rows, order, near: bool = False):
    """Rows in ORDER BY order (Spark's nulls: first ascending, last
    descending), stable; ``near``: float keys equal to 9 significant
    digits tie."""
    out = list(rows)
    for i, asc in reversed(order or []):
        def value(r, i=i):
            v = _order_value(r, i)
            return _near(v) if near else v
        out.sort(key=lambda r: (0,) if value(r) is None else (1, value(r)),
                 reverse=not asc)
    return out


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b) or \
            abs(a - b) <= EXACT_REL * max(abs(a), abs(b), 1.0)
    return a == b


def check_ds7_rows(q: str, table, full: list) -> int:
    """``check_rows`` of a phase-7 query (LIMIT 100 after its ORDER BY)."""
    return check_rows(q, table, full, DS7_ORDER[q])


def check_rows(q: str, table, full: list, order, limit: int = 100) -> int:
    """The port's rows against the reference's full result: as many as
    the LIMIT keeps, in ORDER BY order (``order``: (column, ascending)
    pairs, or None for a query without ORDER BY or LIMIT), each
    position's order keys those of the reference's row there, and each
    row one of the reference's rows with those keys (so ties, also at
    the LIMIT's cut, compare as a multiset); strings, integers and nulls
    equal, floats within EXACT_REL.  Float order keys equal to 9
    significant digits are ties (``_near``): two engines that add one
    group's values in different orders may order two equal averages
    either way (q53's manufacturers of one mean).  Returns the
    reference's row count."""
    rows = [tuple(r.values()) for r in table.to_pylist()]
    ref = _sort_rows(full, order, near=True)
    want = min(limit, len(ref)) if order is not None else len(ref)
    check(len(rows) == want,
          f"{q}: {len(rows)} rows where the reference has {want}")

    def key(r):
        return tuple(_order_value(r, i) for i, _ in order or [])

    def same_key(a, b):
        return all(_close(x, y) for x, y in zip(key(a), key(b)))
    check([key(r) for r in _sort_rows(rows, order)] ==
          [key(r) for r in rows], f"{q}: rows out of ORDER BY order")
    used = set()
    for i, r in enumerate(_sort_rows(rows, order, near=True)):
        check(same_key(r, ref[i]),
              f"{q}: row {i} has order keys {key(r)}, the reference "
              f"{key(ref[i])}")
        lo, hi = i, i + 1
        while lo > 0 and same_key(ref[lo - 1], r):
            lo -= 1
        while hi < len(ref) and same_key(ref[hi], r):
            hi += 1
        j = next((j for j in range(lo, hi) if j not in used and
                  len(r) == len(ref[j]) and
                  all(_close(a, b) for a, b in zip(r, ref[j]))), None)
        check(j is not None, f"{q}: row {r} is no row of the reference "
                             f"(near {ref[i]})")
        used.add(j)
    return len(ref)


_PLAN_OP = re.compile(r"^(TpuGlobalLimit|TpuTopN|TpuSort|"
                      r"TpuHashAggregate\[\w+|Tpu\w*HashJoin\[[^\]]*\]|"
                      r"TpuNestedLoopJoin\[\w+\])")


def plan_signature(explain: str) -> list:
    """The limit, sort, aggregate and join operators of a plan, top
    down (what DS7_PLANS and DS8_PLANS list)."""
    return [m.group(1) for ln in explain.splitlines()
            if (m := _PLAN_OP.match(ln.strip()))]


def tpcds7_phase(args, kernels_used, data_dir: str, session) -> dict:
    """Phase 7: the verbatim text of the 21 flat TPC-DS queries
    (DS7_QUERIES) through the port's ``session.sql`` over Parquet temp
    views at scale ``--ds-sf``, on phase 6's tables and session with the
    17 more tables of ``make_tpcds7``.  Below SF10 the broadcast
    threshold shrinks with the scale, so the plans are SF10's.  Returns
    B1's launches on this path."""
    import os
    from tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.kernels import cuda_ops
    from spark_rapids_tpu_torch.plan import overrides
    on_card = args.device == "cuda"

    t0 = time.perf_counter()
    rows = make_tpcds7(data_dir, args.ds_sf, args.seed)
    t1 = time.perf_counter()
    refs = ds7_references(data_dir)
    print(f"tpcds7 data: sf {args.ds_sf}, {rows}, written in "
          f"{t1 - t0:.1f}s; pyarrow references in "
          f"{time.perf_counter() - t1:.1f}s")
    rows.update({"store_sales": max(int(DS_ROWS_PER_SF["store_sales"] *
                                        args.ds_sf), 64)})
    for t in DS7_TABLES:
        session.read.parquet(os.path.join(data_dir, f"{t}.parquet")) \
            .create_or_replace_temp_view(t)
    cache = DeviceScanCache.get()
    launches = {k: 0 for k in cuda_ops.LAUNCHES}
    threshold = overrides.BROADCAST_ROW_THRESHOLD
    overrides.BROADCAST_ROW_THRESHOLD = max(
        1, int(threshold * min(args.ds_sf, 10.0) / 10.0))
    try:
        for q in DS7_QUERIES:
            check("spark_rapids_tpu" not in sys.modules,
                  "phase 7 imported the JAX package")
            df = session.sql(QUERIES[q])
            plan = df.explain()
            check(plan_signature(plan) == DS7_PLANS[q] and
                  "cross" not in plan,
                  f"{q}: not the planned operators:\n{plan}")
            cold, cold_s, read_s, upload_s, warm, warm_s, peak = \
                cold_and_warm(session, df, on_card)
            for name, v in cuda_ops.LAUNCHES.items():
                launches[name] += v
            full = check_ds7_rows(q, cold, refs[q])
            for t in warm:
                check_ds7_rows(q, t, refs[q])
            check(same_bytes(warm[0], warm[1]),
                  f"{q}: the two warm runs are not byte-identical")
            # below SF10 a selective query may find nothing
            check(cold.num_rows > 0 or q in DS7_EMPTY or args.ds_sf < 10,
                  f"{q}: no rows (not in DS7_EMPTY)")
            fact = rows[DS7_FACT[q]]
            print(f"{q}: {cold.num_rows} rows of {full}; cold {cold_s:.4f}s "
                  f"(host read {read_s:.4f}s, upload {upload_s:.4f}s); warm "
                  f"{warm_s[0]:.4f}s {warm_s[1]:.4f}s; warm "
                  f"{fact / warm_s[1] / 1e6:.3f} Mrows/s of {DS7_FACT[q]}; "
                  f"peak device memory {peak} B; B1 launches (3 runs) "
                  f"{cuda_ops.LAUNCHES['hash_partition_ids']}; B2 launches "
                  f"{cuda_ops.LAUNCHES['table_reduce']}; byte-identical warm "
                  f"runs; matches pyarrow at {EXACT_REL}; first rows "
                  f"{cold.slice(0, 2).to_pylist()}")
        print("plan q17:\n" + session.sql(QUERIES["q17"]).explain())
        if on_card:
            before = cuda_ops.LAUNCHES["hash_partition_ids"]
            profile_query(session.sql(QUERIES["q17"]))
            b1 = cuda_ops.LAUNCHES["hash_partition_ids"] - before
            print(f"profile q17: B1 hash_split launches {b1}")
            check(b1 > 0, "q17's profiled run launched no hash_split")
    finally:
        overrides.BROADCAST_ROW_THRESHOLD = threshold
        cache.clear()
    for name in kernels_used:
        check(launches.get(name, 0) > 0,
              f"{name} never launched on the phase 7 path")
    return launches


# -- phase 8: derived tables, CTEs and nested-loop joins at SF10 ------------

#: the 15 TPC-DS queries that need subqueries in FROM (q28, q88: cross
#: joins of one-row aggregates) or CTEs, and nothing else the port lacks
DS8_QUERIES = ("q28", "q88", "q34", "q46", "q65", "q68", "q73", "q79",
               "q93", "q31", "q39", "q59", "q64", "q78", "q97")
#: queries allowed an empty answer at SF10, with the reason
DS8_EMPTY: dict = {}
#: ORDER BY of each query as (select column position, ascending); None:
#: one row, no ORDER BY
DS8_ORDER = {
    "q28": None, "q88": None, "q97": None,
    "q34": [(0, True), (1, True), (2, True), (3, False), (4, True)],
    "q46": [(i, True) for i in range(5)],
    "q65": [(0, True), (1, True), (2, True)],
    "q68": [(0, True), (4, True)],
    "q73": [(5, False), (0, True), (1, True), (4, True)],
    "q79": [(0, True), (1, True), (2, True), (5, True), (3, True)],
    "q93": [(1, True), (0, True)],
    "q31": [(0, True)],
    "q39": [(i, True) for i in range(10)],
    "q59": [(0, True), (1, True), (2, True)],
    "q64": [(0, True), (1, True), (20, True), (13, True), (16, True)],
    "q78": [(0, True), (2, False), (3, False), (4, False)]}
#: LIMIT of each query with an ORDER BY (100 where not listed)
DS8_LIMIT = {"q34": 1000}
#: the table whose rows a query's Mrows/s counts (its largest scan)
DS8_FACT = {q: "inventory" if q == "q39" else "store_sales"
            for q in DS8_QUERIES}
#: the queries whose plans hold a TpuNestedLoopJoin (and no other does)
DS8_NESTED = ("q28", "q88")
#: each query's plan at SF10's row estimates, as DS7_PLANS lists them
_NL = "TpuNestedLoopJoin[cross]"
_BLO = "TpuBroadcastHashJoin[left, build=right]"
_SLO = "TpuShuffledHashJoin[left, build=right]"
_LS = ["TpuGlobalLimit", "TpuSort"]
_TICKETS = _LS + [_BR] + _AGG + [_BR] * 3            # q34, q73, q79
_BOUGHT = _LS + [_BR] * 2 + _AGG + [_BR] * 4         # q46, q68
_CROSS_SALES = _AGG + [_BR] * 15 + [_SR] * 2 + _AGG + [_SR]
DS8_PLANS = {
    "q28": [_NL] * 2 + _AGG * 3,
    "q88": [_NL] * 3 + (_AGG + [_BR] * 3) * 4,
    "q34": _TICKETS, "q46": _BOUGHT, "q68": _BOUGHT, "q73": _TICKETS,
    "q65": _LS + [_SR, _BR, _BL] + _AGG + [_BR] + _AGG * 2 + [_BR],
    "q79": _TICKETS,
    "q93": _LS + _AGG + [_BR, _SLO],
    "q31": _LS + [_SR] * 3 + (_AGG + [_BR] * 2) * 4,
    "q39": _LS + [_SR] + (_AGG + [_BR] * 3) * 2,
    "q59": _LS + [_SR, _BR, _BR] + _AGG + [_BR] * 3 + _AGG + [_BR],
    "q64": _LS + [_SR] + _CROSS_SALES * 2,
    "q78": _LS + [_SLO] * 2 + _AGG + [_BR, _SLO] + _AGG + [_BR, _BLO] +
    _AGG + [_BR, _SLO],
    "q97": ["TpuGlobalLimit"] + _AGG +
    ["TpuShuffledHashJoin[full, build=right]"] + (_AGG + [_BR]) * 2}


def ds8_references(data_dir: str, queries=DS8_QUERIES) -> dict:
    """Each phase-8 query's full result (every row before its LIMIT), in
    its select list's order, by pyarrow joins, filters, group-bys and
    compute functions written apart from the port (a derived table or a
    CTE is a pyarrow table or a Python dict here; a join the port runs as
    a nested loop is a product of one-row results)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    read, join, isin, between = _ds7_tools(data_dir)
    std = pc.VarianceOptions(ddof=1)
    years = [1999, 2000, 2001]
    out = {}

    def rows_of(t, cols):
        return list(zip(*[t[c].to_pylist() for c in cols]))

    def dates(*conds, prefix="", cols=("d_date_sk", "d_year", "d_moy",
                                       "d_dom", "d_dow", "d_qoy",
                                       "d_month_seq", "d_week_seq")):
        d = read("date_dim", list(cols), prefix)
        for col, fn in conds:
            d = d.filter(fn(d[prefix + col]))
        return d

    def eq(v):
        return lambda c: pc.equal(c, v)

    def div(a, b):
        return None if a is None or b is None or b == 0 else a / b

    if "q28" in queries:
        ss = read("store_sales", ["ss_quantity", "ss_list_price",
                                  "ss_coupon_amt", "ss_wholesale_cost"])
        row = []
        for qlo, qhi, lp, ca, wc in ((0, 5, 8, 459, 57),
                                     (6, 10, 90, 2323, 31),
                                     (11, 15, 142, 12214, 79)):
            f = ss.filter(pc.and_(
                between(ss["ss_quantity"], qlo, qhi),
                pc.or_(pc.or_(between(ss["ss_list_price"], lp, lp + 10),
                              between(ss["ss_coupon_amt"], ca, ca + 1000)),
                       between(ss["ss_wholesale_cost"], wc, wc + 20))))
            row += [pc.mean(f["ss_list_price"]).as_py(),
                    pc.count(f["ss_list_price"]).as_py()]
        out["q28"] = [tuple(row)]
    if "q88" in queries:
        ss = read("store_sales", ["ss_sold_time_sk", "ss_hdemo_sk",
                                  "ss_store_sk"])
        hd = read("household_demographics", ["hd_demo_sk", "hd_dep_count",
                                             "hd_vehicle_count"])
        cond = None
        for dep in (4, 2, 0):
            c = pc.and_(pc.equal(hd["hd_dep_count"], dep),
                        pc.less_equal(hd["hd_vehicle_count"], dep + 2))
            cond = c if cond is None else pc.or_(cond, c)
        st = read("store", ["s_store_sk", "s_store_name"])
        j = join(join(ss, hd.filter(cond), "ss_hdemo_sk", "hd_demo_sk"),
                 st.filter(pc.equal(st["s_store_name"], "ese")),
                 "ss_store_sk", "s_store_sk")
        tm = read("time_dim", ["t_time_sk", "t_hour", "t_minute"])
        row = []
        for hour, early in ((8, False), (9, True), (9, False), (10, True)):
            m = pc.less(tm["t_minute"], 30) if early else \
                pc.greater_equal(tm["t_minute"], 30)
            t = tm.filter(pc.and_(pc.equal(tm["t_hour"], hour), m))
            row.append(join(j, t, "ss_sold_time_sk", "t_time_sk").num_rows)
        out["q88"] = [tuple(row)]

    def customers(t, cols):
        return join(t, read("customer", ["c_customer_sk"] + cols),
                    "ss_customer_sk", "c_customer_sk")

    def tickets(dom, counties, lo, hi):
        """q34 and q73: (ticket, customer) line counts within [lo, hi]."""
        ss = read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                  "ss_hdemo_sk", "ss_ticket_number",
                                  "ss_customer_sk"])
        st = read("store", ["s_store_sk", "s_county"])
        hd = read("household_demographics", ["hd_demo_sk", "hd_buy_potential",
                                             "hd_vehicle_count"])
        hd = hd.filter(pc.and_(isin(hd["hd_buy_potential"],
                                    [">10000", "Unknown"]),
                               pc.greater(hd["hd_vehicle_count"], 0)))
        j = join(ss, dates(("d_dom", dom),
                           ("d_year", lambda c: isin(c, years))),
                 "ss_sold_date_sk", "d_date_sk")
        j = join(j, st.filter(isin(st["s_county"], counties)),
                 "ss_store_sk", "s_store_sk")
        j = join(j, hd, "ss_hdemo_sk", "hd_demo_sk")
        g = j.group_by(["ss_ticket_number", "ss_customer_sk"]).aggregate(
            [("ss_ticket_number", "count")])
        g = g.filter(between(g["ss_ticket_number_count"], lo, hi))
        cols = ["c_last_name", "c_first_name", "c_salutation",
                "c_preferred_cust_flag"]
        return rows_of(customers(g, cols), cols + [
            "ss_ticket_number", "ss_ticket_number_count"])

    if "q34" in queries:
        out["q34"] = tickets(
            lambda c: pc.or_(between(c, 1, 3), between(c, 25, 28)),
            ["Williamson County", "Ziebach County", "Walker County",
             "Rush County"], 15, 20)
    if "q73" in queries:
        out["q73"] = tickets(lambda c: between(c, 1, 2),
                             ["Williamson County", "Ziebach County"], 1, 5)

    def bought(date_conds, sums):
        """q46 and q68: per (ticket, customer, address, city) sums, with
        the customer's current city, where it is not the bought city."""
        ss = read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                  "ss_hdemo_sk", "ss_addr_sk",
                                  "ss_ticket_number", "ss_customer_sk"] +
                  sums)
        st = read("store", ["s_store_sk", "s_city"])
        hd = read("household_demographics", ["hd_demo_sk", "hd_dep_count",
                                             "hd_vehicle_count"])
        j = join(ss, dates(*date_conds, ("d_year",
                                         lambda c: isin(c, years))),
                 "ss_sold_date_sk", "d_date_sk")
        j = join(j, st.filter(isin(st["s_city"], ["Fairview", "Midway"])),
                 "ss_store_sk", "s_store_sk")
        j = join(j, hd.filter(pc.or_(pc.equal(hd["hd_dep_count"], 4),
                                     pc.equal(hd["hd_vehicle_count"], 3))),
                 "ss_hdemo_sk", "hd_demo_sk")
        j = join(j, read("customer_address", ["ca_address_sk", "ca_city"]),
                 "ss_addr_sk", "ca_address_sk")
        g = j.group_by(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                        "ca_city"]).aggregate([(c, "sum") for c in sums])
        g = customers(g, ["c_current_addr_sk", "c_first_name",
                          "c_last_name"])
        g = join(g, read("customer_address", ["ca_address_sk", "ca_city"],
                         "cur_"), "c_current_addr_sk", "cur_ca_address_sk")
        return g.filter(pc.not_equal(g["cur_ca_city"], g["ca_city"]))

    if "q46" in queries:
        g = bought([("d_dow", lambda c: isin(c, [6, 0]))],
                   ["ss_coupon_amt", "ss_net_profit"])
        out["q46"] = rows_of(g, ["c_last_name", "c_first_name",
                                 "cur_ca_city", "ca_city",
                                 "ss_ticket_number", "ss_coupon_amt_sum",
                                 "ss_net_profit_sum"])
    if "q68" in queries:
        g = bought([("d_dom", lambda c: between(c, 1, 2))],
                   ["ss_ext_sales_price", "ss_ext_list_price",
                    "ss_ext_tax"])
        out["q68"] = rows_of(g, ["c_last_name", "c_first_name",
                                 "cur_ca_city", "ca_city",
                                 "ss_ticket_number",
                                 "ss_ext_sales_price_sum", "ss_ext_tax_sum",
                                 "ss_ext_list_price_sum"])
    if "q79" in queries:
        ss = read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                  "ss_hdemo_sk", "ss_addr_sk",
                                  "ss_ticket_number", "ss_customer_sk",
                                  "ss_coupon_amt", "ss_net_profit"])
        st = read("store", ["s_store_sk", "s_city", "s_number_employees"])
        hd = read("household_demographics", ["hd_demo_sk", "hd_dep_count",
                                             "hd_vehicle_count"])
        j = join(ss, dates(("d_dow", eq(1)),
                           ("d_year", lambda c: isin(c, years))),
                 "ss_sold_date_sk", "d_date_sk")
        j = join(j, st.filter(between(st["s_number_employees"], 200, 295)),
                 "ss_store_sk", "s_store_sk")
        j = join(j, hd.filter(pc.or_(pc.equal(hd["hd_dep_count"], 6),
                                     pc.greater(hd["hd_vehicle_count"], 2))),
                 "ss_hdemo_sk", "hd_demo_sk")
        g = j.group_by(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                        "s_city"]).aggregate([("ss_coupon_amt", "sum"),
                                              ("ss_net_profit", "sum")])
        g = customers(g, ["c_last_name", "c_first_name"])
        g = g.append_column("city", pc.utf8_slice_codeunits(g["s_city"], 0,
                                                            30))
        out["q79"] = rows_of(g, ["c_last_name", "c_first_name", "city",
                                 "ss_ticket_number", "ss_coupon_amt_sum",
                                 "ss_net_profit_sum"])
    if "q65" in queries:
        ss = read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                  "ss_item_sk", "ss_sales_price"])
        j = join(ss, dates(("d_month_seq", lambda c: between(c, 1176, 1187)),
                           cols=("d_date_sk", "d_month_seq")),
                 "ss_sold_date_sk", "d_date_sk")
        sc = j.group_by(["ss_store_sk", "ss_item_sk"]).aggregate(
            [("ss_sales_price", "sum")])
        sb = sc.group_by(["ss_store_sk"]).aggregate(
            [("ss_sales_price_sum", "mean")]).rename_columns(["sb_store",
                                                             "ave"])
        t = join(sc, sb, "ss_store_sk", "sb_store")
        t = t.filter(pc.less_equal(t["ss_sales_price_sum"],
                                   pc.multiply(t["ave"], 0.1)))
        t = join(t, read("store", ["s_store_sk", "s_store_name"]),
                 "ss_store_sk", "s_store_sk")
        t = join(t, read("item", ["i_item_sk", "i_item_desc",
                                  "i_current_price", "i_wholesale_cost",
                                  "i_brand"]), "ss_item_sk", "i_item_sk")
        out["q65"] = rows_of(t, ["s_store_name", "i_item_desc",
                                 "ss_sales_price_sum", "i_current_price",
                                 "i_wholesale_cost", "i_brand"])
    if "q93" in queries:
        ss = read("store_sales", ["ss_item_sk", "ss_ticket_number",
                                  "ss_customer_sk", "ss_quantity",
                                  "ss_sales_price"])
        sr = read("store_returns", ["sr_item_sk", "sr_ticket_number",
                                    "sr_reason_sk", "sr_return_quantity"])
        r = read("reason", ["r_reason_sk", "r_reason_desc"])
        # the WHERE on sr_reason_sk drops the outer join's unmatched rows
        j = join(ss, sr, ["ss_item_sk", "ss_ticket_number"],
                 ["sr_item_sk", "sr_ticket_number"])
        j = join(j, r.filter(pc.equal(r["r_reason_desc"], "reason 28")),
                 "sr_reason_sk", "r_reason_sk")
        price = j["ss_sales_price"]
        act = pc.if_else(
            pc.is_valid(j["sr_return_quantity"]),
            pc.multiply(pc.subtract(j["ss_quantity"],
                                    j["sr_return_quantity"]), price),
            pc.multiply(j["ss_quantity"], price))
        j = j.append_column("act", act)
        out["q93"] = _grouped(j, ["ss_customer_sk"], [("act", "sum")],
                              ["ss_customer_sk", "act_sum"])
    if "q31" in queries:
        def county_sales(fact, date_col, addr_col, val):
            f = read(fact, [date_col, addr_col, val])
            j = join(f, dates(("d_year", eq(2000)),
                              ("d_qoy", lambda c: isin(c, [1, 2]))),
                     date_col, "d_date_sk")
            j = join(j, read("customer_address", ["ca_address_sk",
                                                  "ca_county"]),
                     addr_col, "ca_address_sk")
            g = j.group_by(["ca_county", "d_qoy"]).aggregate([(val, "sum")])
            return {(c, q): v for c, q, v in rows_of(
                g, ["ca_county", "d_qoy", f"{val}_sum"])}
        ss = county_sales("store_sales", "ss_sold_date_sk", "ss_addr_sk",
                          "ss_ext_sales_price")
        ws = county_sales("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
                          "ws_ext_sales_price")
        rows = []
        for county in {c for c, _ in ss}:
            s1, s2 = ss.get((county, 1)), ss.get((county, 2))
            w1, w2 = ws.get((county, 1)), ws.get((county, 2))
            if None in (s1, s2, w1, w2):
                continue
            wr = w2 / w1 if w1 > 0 else None
            sr = s2 / s1 if s1 > 0 else None
            if wr is not None and sr is not None and wr > sr:
                rows.append((county, 2000, div(w2, w1), div(s2, s1)))
        out["q31"] = rows
    if "q39" in queries:
        inv = read("inventory", ["inv_date_sk", "inv_item_sk",
                                 "inv_warehouse_sk", "inv_quantity_on_hand"])
        j = join(inv, read("item", ["i_item_sk"]), "inv_item_sk", "i_item_sk")
        j = join(j, read("warehouse", ["w_warehouse_sk", "w_warehouse_name"]),
                 "inv_warehouse_sk", "w_warehouse_sk")
        j = join(j, dates(("d_year", eq(2001)),
                          ("d_moy", lambda c: isin(c, [1, 2]))),
                 "inv_date_sk", "d_date_sk")
        g = j.group_by(["w_warehouse_name", "inv_warehouse_sk",
                        "inv_item_sk", "d_moy"]).aggregate(
            [("inv_quantity_on_hand", "stddev", std),
             ("inv_quantity_on_hand", "mean")])
        by_moy = {1: {}, 2: {}}
        for _, wsk, isk, moy, sd, mean in rows_of(
                g, ["w_warehouse_name", "inv_warehouse_sk", "inv_item_sk",
                    "d_moy", "inv_quantity_on_hand_stddev",
                    "inv_quantity_on_hand_mean"]):
            ratio = 0.0 if mean == 0 else div(sd, mean)
            if ratio is not None and ratio > 0.5:
                cov = None if mean == 0 else div(sd, mean)
                by_moy[moy][(wsk, isk)] = (wsk, isk, moy, mean, cov)
        out["q39"] = [a + b for k, a in by_moy[1].items()
                      for b in [by_moy[2].get(k)] if b is not None]
    if "q59" in queries:
        days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                "Friday", "Saturday"]
        ss = read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                  "ss_sales_price"])
        d = read("date_dim", ["d_date_sk", "d_week_seq", "d_day_name",
                              "d_month_seq"])
        j = join(ss, d.select(["d_date_sk", "d_week_seq", "d_day_name"]),
                 "ss_sold_date_sk", "d_date_sk")
        none = pa.scalar(None, pa.float64())
        for day in days:
            j = j.append_column(day, pc.if_else(
                pc.equal(j["d_day_name"], day), j["ss_sales_price"], none))
        g = j.group_by(["d_week_seq", "ss_store_sk"]).aggregate(
            [(day, "sum") for day in days])
        wss = {(w, sk): v for w, sk, *v in rows_of(
            g, ["d_week_seq", "ss_store_sk"] + [f"{x}_sum" for x in days])}
        st = {sk: (name, sid) for sk, name, sid in rows_of(
            read("store", ["s_store_sk", "s_store_name", "s_store_id"]),
            ["s_store_sk", "s_store_name", "s_store_id"])}
        # the date_dim rows of each week in each year's months: a wss row
        # joins each of them (the query's own fan-out)
        per_week = {}
        for w, m in rows_of(d, ["d_week_seq", "d_month_seq"]):
            for lo in (1200, 1212):
                if lo <= m <= lo + 11:
                    per_week[(lo, w)] = per_week.get((lo, w), 0) + 1
        rows = []
        for (w, sk), v1 in wss.items():
            n1 = per_week.get((1200, w), 0)
            v2 = wss.get((w + 52, sk))
            n2 = per_week.get((1212, w + 52), 0)
            if not n1 or not n2 or v2 is None or sk not in st:
                continue
            name, sid = st[sk]
            row = (name, sid, w) + tuple(div(a, b) for a, b in zip(v1, v2))
            rows += [row] * (n1 * n2)
        out["q59"] = rows
    if "q64" in queries:
        cs = read("catalog_sales", ["cs_item_sk", "cs_order_number",
                                    "cs_ext_list_price"])
        cr = read("catalog_returns", ["cr_item_sk", "cr_order_number",
                                      "cr_refunded_cash",
                                      "cr_reversed_charge",
                                      "cr_store_credit"])
        j = join(cs, cr, ["cs_item_sk", "cs_order_number"],
                 ["cr_item_sk", "cr_order_number"])
        j = j.append_column("refund", pc.add(pc.add(
            j["cr_refunded_cash"], j["cr_reversed_charge"]),
            j["cr_store_credit"]))
        g = j.group_by(["cs_item_sk"]).aggregate(
            [("cs_ext_list_price", "sum"), ("refund", "sum")])
        cs_ui = g.filter(pc.greater(g["cs_ext_list_price_sum"], pc.multiply(
            g["refund_sum"], 2.0))).select(["cs_item_sk"])
        it = read("item", ["i_item_sk", "i_product_name", "i_color",
                           "i_current_price"])
        it = it.filter(pc.and_(
            isin(it["i_color"], ["red", "blue", "green", "purple", "white",
                                 "orange"]),
            between(it["i_current_price"], 20, 70)))
        ss = read("store_sales", ["ss_item_sk", "ss_ticket_number",
                                  "ss_store_sk", "ss_sold_date_sk",
                                  "ss_customer_sk", "ss_cdemo_sk",
                                  "ss_hdemo_sk", "ss_addr_sk", "ss_promo_sk",
                                  "ss_wholesale_cost", "ss_list_price",
                                  "ss_coupon_amt"])
        j = join(ss, it, "ss_item_sk", "i_item_sk")
        j = join(j, cs_ui, "ss_item_sk", "cs_item_sk")
        j = join(j, read("store_returns", ["sr_item_sk", "sr_ticket_number"]),
                 ["ss_item_sk", "ss_ticket_number"],
                 ["sr_item_sk", "sr_ticket_number"])
        j = join(j, read("store", ["s_store_sk", "s_store_name", "s_zip"]),
                 "ss_store_sk", "s_store_sk")
        j = join(j, read("customer", [
            "c_customer_sk", "c_current_cdemo_sk", "c_current_hdemo_sk",
            "c_current_addr_sk", "c_first_sales_date_sk",
            "c_first_shipto_date_sk"]), "ss_customer_sk", "c_customer_sk")
        # only the groups of 1999 and 2000 (d1's year, a group key) meet
        for p, col in (("d1_", "ss_sold_date_sk"),
                       ("d2_", "c_first_sales_date_sk"),
                       ("d3_", "c_first_shipto_date_sk")):
            d = dates(prefix=p, cols=("d_date_sk", "d_year"))
            if p == "d1_":
                d = d.filter(isin(d["d1_d_year"], [1999, 2000]))
            j = join(j, d, col, p + "d_date_sk")
        for p, col in (("cd1_", "ss_cdemo_sk"),
                       ("cd2_", "c_current_cdemo_sk")):
            j = join(j, read("customer_demographics",
                             ["cd_demo_sk", "cd_marital_status"], p), col,
                     p + "cd_demo_sk")
        j = j.filter(pc.not_equal(j["cd1_cd_marital_status"],
                                  j["cd2_cd_marital_status"]))
        j = join(j, read("promotion", ["p_promo_sk"]), "ss_promo_sk",
                 "p_promo_sk")
        for h, col in (("hd1_", "ss_hdemo_sk"),
                       ("hd2_", "c_current_hdemo_sk")):
            j = join(j, read("household_demographics",
                             ["hd_demo_sk", "hd_income_band_sk"], h), col,
                     h + "hd_demo_sk")
            ib = "ib" + h[2:]
            j = join(j, read("income_band", ["ib_income_band_sk"], ib),
                     h + "hd_income_band_sk", ib + "ib_income_band_sk")
        addr = ["ca_street_number", "ca_street_name", "ca_city", "ca_zip"]
        for p, col in (("ad1_", "ss_addr_sk"), ("ad2_", "c_current_addr_sk")):
            j = join(j, read("customer_address", ["ca_address_sk"] + addr, p),
                     col, p + "ca_address_sk")
        keys = (["i_product_name", "ss_item_sk", "s_store_name", "s_zip"] +
                ["ad1_" + c for c in addr] + ["ad2_" + c for c in addr] +
                ["d1_d_year", "d2_d_year", "d3_d_year"])
        g = j.group_by(keys).aggregate([
            ("ss_wholesale_cost", "count"), ("ss_wholesale_cost", "sum"),
            ("ss_list_price", "sum"), ("ss_coupon_amt", "sum")])
        cols = keys + ["ss_wholesale_cost_count", "ss_wholesale_cost_sum",
                       "ss_list_price_sum", "ss_coupon_amt_sum"]
        g = g.select(cols).rename_columns(
            keys[:12] + ["syear", "y2", "y3", "cnt", "s1", "s2", "s3"])
        cs1 = g.filter(pc.equal(g["syear"], 1999))
        cs2 = g.filter(pc.equal(g["syear"], 2000)).select(
            ["ss_item_sk", "s_store_name", "s_zip", "syear", "cnt", "s1",
             "s2", "s3"]).rename_columns(
            ["i2", "n2", "z2", "syear2", "cnt2", "s12", "s22", "s32"])
        j = join(cs1, cs2, ["ss_item_sk", "s_store_name", "s_zip"],
                 ["i2", "n2", "z2"])
        j = j.filter(pc.less_equal(j["cnt2"], j["cnt"]))
        out["q64"] = rows_of(j, ["i_product_name", "s_store_name", "s_zip"] +
                             keys[4:12] + ["syear", "cnt", "s1", "s2", "s3",
                                           "s12", "s22", "s32", "syear2",
                                           "cnt2"])
    if "q78" in queries:
        def channel(fact, rets, p, fkeys, rkeys, cust):
            f = read(fact, [f"{p}_sold_date_sk", f"{p}_item_sk", cust,
                            fkeys[0], f"{p}_quantity", f"{p}_wholesale_cost",
                            f"{p}_sales_price"])
            f = join(f, read(rets, rkeys), fkeys, rkeys, "left anti")
            f = join(f, dates(("d_year", eq(2000)),
                              cols=("d_date_sk", "d_year")),
                     f"{p}_sold_date_sk", "d_date_sk")
            g = f.group_by(["d_year", f"{p}_item_sk", cust]).aggregate(
                [(f"{p}_quantity", "sum"), (f"{p}_wholesale_cost", "sum"),
                 (f"{p}_sales_price", "sum")])
            return g.rename_columns(["year", "item", "cust", "qty", "wc",
                                     "sp"]
                                    if p == "ss" else
                                    [f"{p}_{c}" for c in (
                                        "year", "item", "cust", "qty", "wc",
                                        "sp")])
        ss = channel("store_sales", "store_returns", "ss",
                     ["ss_ticket_number", "ss_item_sk"],
                     ["sr_ticket_number", "sr_item_sk"], "ss_customer_sk")
        j = ss
        for p, fact, rets in (("ws", "web_sales", "web_returns"),
                              ("cs", "catalog_sales", "catalog_returns")):
            r = p[0] + "r"
            g = channel(fact, rets, p, [f"{p}_order_number", f"{p}_item_sk"],
                        [f"{r}_order_number", f"{r}_item_sk"],
                        f"{p}_bill_customer_sk")
            j = join(j, g, ["year", "item", "cust"],
                     [f"{p}_year", f"{p}_item", f"{p}_cust"], "left outer")
        wq = pc.fill_null(j["ws_qty"], 0)
        cq = pc.fill_null(j["cs_qty"], 0)
        j = j.filter(pc.or_(pc.greater(wq, 0), pc.greater(cq, 0)))
        wq, cq = pc.fill_null(j["ws_qty"], 0), pc.fill_null(j["cs_qty"], 0)
        ratio = pc.round(pc.divide(pc.cast(j["qty"], pa.float64()),
                                   pc.cast(pc.add(wq, cq), pa.float64())),
                         2, round_mode="half_towards_infinity")
        j = j.append_column("ratio", ratio)
        out["q78"] = rows_of(j, ["item", "ratio", "qty", "wc", "sp"])
    if "q97" in queries:
        def pairs(fact, date_col, cust, item):
            f = read(fact, [date_col, cust, item])
            j = join(f, dates(("d_month_seq", lambda c: between(c, 1200,
                                                                1211)),
                              cols=("d_date_sk", "d_month_seq")),
                     date_col, "d_date_sk")
            return j.group_by([cust, item]).aggregate([])
        s = pairs("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                  "ss_item_sk")
        c = pairs("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk",
                  "cs_item_sk")
        both = join(s, c, ["ss_customer_sk", "ss_item_sk"],
                    ["cs_bill_customer_sk", "cs_item_sk"]).num_rows
        out["q97"] = [(s.num_rows - both, c.num_rows - both, both)]
    return out


def tpcds8_phase(args, kernels_used, data_dir: str, session) -> dict:
    """Phase 8: the verbatim text of the 15 TPC-DS queries with derived
    tables or CTEs (DS8_QUERIES) through the port's ``session.sql`` on
    phase 7's tables, directory and session.  Each must plan DS8_PLANS'
    operators at SF10 (a TpuNestedLoopJoin in q28 and q88 alone, at
    every scale), equal
    ``ds8_references`` (1e-9, ORDER BY kept, ties as a multiset, also at
    the LIMIT's cut), give the same bytes on two warm runs, and return
    rows unless DS8_EMPTY names it.  Below SF10 the broadcast threshold
    shrinks with the scale, as in phase 7.  q78 and q64 run once more
    under the profiler.  Returns the kernels' launches on this path."""
    from tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.kernels import cuda_ops
    from spark_rapids_tpu_torch.plan import overrides
    on_card = args.device == "cuda"

    t0 = time.perf_counter()
    refs = ds8_references(data_dir)
    print(f"tpcds8: pyarrow references in {time.perf_counter() - t0:.1f}s")
    rows = {"store_sales": max(int(DS_ROWS_PER_SF["store_sales"] *
                                   args.ds_sf), 64),
            "inventory": max(int(DS7_ROWS_PER_SF["inventory"] * args.ds_sf),
                             64)}
    cache = DeviceScanCache.get()
    launches = {k: 0 for k in cuda_ops.LAUNCHES}
    threshold = overrides.BROADCAST_ROW_THRESHOLD
    overrides.BROADCAST_ROW_THRESHOLD = max(
        1, int(threshold * min(args.ds_sf, 10.0) / 10.0))
    try:
        for q in DS8_QUERIES:
            check("spark_rapids_tpu" not in sys.modules and
                  "jax" not in sys.modules,
                  "phase 8 imported JAX or the JAX package")
            df = session.sql(QUERIES[q])
            plan = df.explain()
            # below SF10 time_dim (86,400 rows at every scale) outgrows
            # the shrunk broadcast threshold: q88 shuffles it there
            check((plan_signature(plan) == DS8_PLANS[q] or
                   args.ds_sf < 10) and
                  ("TpuNestedLoopJoin" in plan) == (q in DS8_NESTED),
                  f"{q}: not the planned operators:\n{plan}")
            cold, cold_s, read_s, upload_s, warm, warm_s, peak = \
                cold_and_warm(session, df, on_card)
            for name, v in cuda_ops.LAUNCHES.items():
                launches[name] += v
            order, limit = DS8_ORDER[q], DS8_LIMIT.get(q, 100)
            full = check_rows(q, cold, refs[q], order, limit)
            for t in warm:
                check_rows(q, t, refs[q], order, limit)
            check(same_bytes(warm[0], warm[1]),
                  f"{q}: the two warm runs are not byte-identical")
            check(cold.num_rows > 0 or q in DS8_EMPTY or args.ds_sf < 10,
                  f"{q}: no rows (not in DS8_EMPTY)")
            fact = rows[DS8_FACT[q]]
            got = cuda_ops.LAUNCHES
            print(f"{q}: {cold.num_rows} rows of {full}; cold {cold_s:.4f}s "
                  f"(host read {read_s:.4f}s, upload {upload_s:.4f}s); warm "
                  f"{warm_s[0]:.4f}s {warm_s[1]:.4f}s; warm "
                  f"{fact / warm_s[1] / 1e6:.3f} Mrows/s of {DS8_FACT[q]}; "
                  f"peak device memory {peak} B; launches (3 runs) B1 "
                  f"{got['hash_partition_ids']}, B2 {got['table_reduce']}, "
                  f"probe {got['join_probe']}; byte-identical warm runs; "
                  f"matches pyarrow at {EXACT_REL}; first rows "
                  f"{cold.slice(0, 2).to_pylist()}", flush=True)
        for q in ("q78", "q64"):
            print(f"plan {q}:\n" + session.sql(QUERIES[q]).explain())
            if on_card:
                before = dict(cuda_ops.LAUNCHES)
                print(f"profile {q}:")
                profile_query(session.sql(QUERIES[q]))
                print(f"profile {q}: kernel launches " + str(
                    {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items()}))
    finally:
        overrides.BROADCAST_ROW_THRESHOLD = threshold
        cache.clear()
    for name in kernels_used:
        check(launches.get(name, 0) > 0,
              f"{name} never launched on the phase 8 path")
    return launches


DS9_QUERIES = ("q1", "q9", "q10", "q24", "q30", "q32", "q35", "q45", "q58",
               "q69", "q81", "q92")
#: queries allowed an empty answer at SF10, with the reason
DS9_EMPTY: dict = {}
_ASC = [(i, True) for i in range(13)]
#: ORDER BY of each query as (select column position, ascending); None:
#: no ORDER BY (q9's one row, q32's and q92's keyless sum)
DS9_ORDER = {
    "q1": _ASC[:1], "q9": None, "q32": None, "q92": None,
    "q10": [(i, True) for i in (0, 1, 2, 4, 6, 8, 10, 12)],
    "q24": _ASC[:3], "q30": _ASC[:7], "q35": _ASC[:3], "q45": _ASC[:2],
    "q58": _ASC[:2], "q69": _ASC[:3], "q81": _ASC[:5]}
#: LIMIT of each query with an ORDER BY (100 where not listed)
DS9_LIMIT: dict = {}
#: each query's plan at SF10's row estimates, as DS7_PLANS lists them (q9's
#: outer query reads reason alone: its fifteen scalar queries run, and are
#: planned, while its text is lowered; q45's IN (query) sits inside an OR
#: and runs then too, to an IN list)
_SSEMI = "TpuShuffledHashJoin[semi, build=right]"
_SANTI = "TpuShuffledHashJoin[anti, build=right]"
_RETURNS = [_BR, _BR] + _AGG * 2 + [_BR, _BR]        # q30's, q81's CTE twice
_DISCOUNT = ["TpuGlobalLimit"] + _AGG + [_SR, _BR, _BR] + _AGG + [_BR]
DS9_PLANS = {
    "q1": _LS + [_SR, _BR, _BR] + _AGG + [_BR] + _AGG * 2 + [_BR],
    "q9": [],
    "q10": _TOP + [_SSEMI] * 2 + [_BR] * 5,
    "q24": _TOP + _AGG + [_BR] * 4 + [_SR],
    "q30": _LS + [_BR, _BR, _BL] + _AGG + _RETURNS,
    "q32": _DISCOUNT,
    "q35": _TOP + [_SSEMI] * 2 + [_BR] * 4,
    "q45": _TOP + [_BR] * 4,
    "q58": _LS + [_SR] * 2 + (_AGG + [_BR] * 2) * 3,
    "q69": _TOP + [_SANTI, _SSEMI] + [_BR] * 4,
    "q81": _LS + [_SR, _BR, _BR] + _AGG + _RETURNS,
    "q92": _DISCOUNT}
#: the table whose rows a query's Mrows/s counts (its largest scan)
DS9_FACT = {"q1": "store_returns", "q9": "store_sales",
            "q10": "store_sales", "q24": "store_sales",
            "q30": "web_returns", "q32": "catalog_sales",
            "q35": "store_sales", "q45": "web_sales", "q58": "store_sales",
            "q69": "store_sales", "q81": "catalog_returns",
            "q92": "web_sales"}


def ds9_references(data_dir: str, queries=DS9_QUERIES) -> dict:
    """Each phase-9 query's full result (every row before its LIMIT), in
    its select list's order, by pyarrow written apart from the port: an
    ``IN`` or ``EXISTS`` query is a set of keys its outer rows are
    tested against with ``pc.is_in``, an uncorrelated scalar query a
    value computed first, and a correlated scalar query a group-by on
    its correlation keys joined back to the outer rows."""
    import pyarrow as pa
    import pyarrow.compute as pc
    read, join, isin, between = _ds7_tools(data_dir)
    out = {}

    def rows_of(t, cols):
        return list(zip(*[t[c].to_pylist() for c in cols]))

    def dates(*conds):
        d = read("date_dim", ["d_date_sk", "d_year", "d_moy", "d_dom",
                              "d_qoy", "d_week_seq"])
        for col, fn in conds:
            d = d.filter(fn(d[col]))
        return d

    def eq(v):
        return lambda c: pc.equal(c, v)

    def keys_of(fact, cust, date, *conds):
        """The customers of ``fact`` on the dates ``conds`` keep: the
        key set of an EXISTS (or IN) query."""
        f = join(read(fact, [cust, date]), dates(*conds), date, "d_date_sk")
        return pc.unique(pc.drop_null(f[cust]))

    def in_keys(t, col, keys, keep=True):
        hit = pc.is_in(t[col], value_set=keys)
        return t.filter(hit if keep else pc.invert(hit))

    def people(addr_cond=None):
        """customer joined to its address and demographics (q10, q35,
        q69's FROM list)."""
        c = read("customer", ["c_customer_sk", "c_current_addr_sk",
                              "c_current_cdemo_sk"])
        ca = read("customer_address", ["ca_address_sk", "ca_state",
                                       "ca_county"])
        if addr_cond is not None:
            ca = ca.filter(addr_cond(ca))
        cd = read("customer_demographics", [
            "cd_demo_sk", "cd_gender", "cd_marital_status",
            "cd_education_status", "cd_purchase_estimate",
            "cd_credit_rating", "cd_dep_count", "cd_dep_employed_count",
            "cd_dep_college_count"])
        return join(join(c, ca, "c_current_addr_sk", "ca_address_sk"), cd,
                    "c_current_cdemo_sk", "cd_demo_sk")

    def over_avg(t, total, key, factor):
        """The rows of ``t`` whose ``total`` exceeds ``factor`` times its
        mean over the rows of their ``key`` (a correlated scalar
        query)."""
        g = t.group_by(key).aggregate([(total, "mean")])
        g = g.rename_columns(["__key" if c == key else c
                              for c in g.column_names])
        j = join(t, g, key, "__key")
        return j.filter(pc.greater(j[total], pc.multiply(
            j[total + "_mean"], factor)))

    if "q1" in queries:
        sr = join(read("store_returns", ["sr_returned_date_sk",
                                         "sr_customer_sk", "sr_store_sk",
                                         "sr_return_amt"]),
                  dates(("d_year", eq(2000))), "sr_returned_date_sk",
                  "d_date_sk")
        ctr = sr.group_by(["sr_customer_sk", "sr_store_sk"]).aggregate(
            [("sr_return_amt", "sum")])
        ctr = over_avg(ctr, "sr_return_amt_sum", "sr_store_sk", 1.2)
        st = read("store", ["s_store_sk", "s_state"])
        j = join(ctr, st.filter(pc.equal(st["s_state"], "TN")),
                 "sr_store_sk", "s_store_sk")
        j = join(j, read("customer", ["c_customer_sk", "c_customer_id"]),
                 "sr_customer_sk", "c_customer_sk")
        out["q1"] = rows_of(j, ["c_customer_id"])
    if "q9" in queries:
        ss = read("store_sales", ["ss_quantity", "ss_ext_discount_amt",
                                  "ss_net_paid"])
        row = []
        for lo, hi in ((1, 20), (21, 40), (41, 60)):
            f = ss.filter(between(ss["ss_quantity"], lo, hi))
            col = "ss_ext_discount_amt" if f.num_rows > 10000 else \
                "ss_net_paid"
            row.append(pc.mean(f[col]).as_py())
        r = read("reason", ["r_reason_sk"])
        n = r.filter(pc.equal(r["r_reason_sk"], 1)).num_rows
        out["q9"] = [tuple(row)] * n
    if "q10" in queries or "q35" in queries or "q69" in queries:
        def sales_keys(year, cond):
            return {p: keys_of(fact, cust, date, ("d_year", eq(year)), cond)
                    for p, fact, cust, date in (
                        ("ss", "store_sales", "ss_customer_sk",
                         "ss_sold_date_sk"),
                        ("ws", "web_sales", "ws_bill_customer_sk",
                         "ws_sold_date_sk"),
                        ("cs", "catalog_sales", "cs_bill_customer_sk",
                         "cs_sold_date_sk"))}
    if "q10" in queries:
        k = sales_keys(2002, ("d_moy", lambda c: between(c, 1, 4)))
        p = people(lambda ca: isin(ca["ca_county"], [
            "Williamson County", "Ziebach County", "Walker County",
            "Rush County"]))
        p = in_keys(p, "c_customer_sk", k["ss"])
        p = in_keys(p, "c_customer_sk", pa.concat_arrays(
            [k["ws"], k["cs"]]))
        cols = ["cd_gender", "cd_marital_status", "cd_education_status",
                "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
                "cd_dep_employed_count", "cd_dep_college_count"]
        g = p.group_by(cols).aggregate([([], "count_all")])
        n = g["count_all"].to_pylist()
        keys = rows_of(g, cols)
        out["q10"] = [(*r[:3], c, r[3], c, r[4], c, r[5], c, r[6], c, r[7],
                       c) for r, c in zip(keys, n)]
    if "q35" in queries:
        k = sales_keys(2002, ("d_qoy", lambda c: pc.less(c, 4)))
        p = in_keys(in_keys(people(), "c_customer_sk", k["ss"]),
                    "c_customer_sk", k["ws"])
        g = p.group_by(["ca_state", "cd_gender", "cd_marital_status"]) \
            .aggregate([([], "count_all"), ("cd_dep_count", "mean"),
                        ("cd_dep_count", "max"), ("cd_dep_count", "sum")])
        out["q35"] = rows_of(g, ["ca_state", "cd_gender",
                                 "cd_marital_status", "count_all",
                                 "cd_dep_count_mean", "cd_dep_count_max",
                                 "cd_dep_count_sum"])
    if "q69" in queries:
        k = sales_keys(2001, ("d_moy", lambda c: between(c, 4, 6)))
        p = people(lambda ca: isin(ca["ca_state"], ["KY", "GA", "NM"]))
        p = in_keys(in_keys(p, "c_customer_sk", k["ss"]), "c_customer_sk",
                    k["ws"], keep=False)
        g = p.group_by(["cd_gender", "cd_marital_status",
                        "cd_education_status"]).aggregate(
            [([], "count_all")])
        out["q69"] = rows_of(g, ["cd_gender", "cd_marital_status",
                                 "cd_education_status", "count_all"])
    if "q24" in queries:
        ss = read("store_sales", ["ss_ticket_number", "ss_item_sk",
                                  "ss_customer_sk", "ss_store_sk",
                                  "ss_net_paid"])
        sr = read("store_returns", ["sr_ticket_number", "sr_item_sk"])
        st = read("store", ["s_store_sk", "s_store_name", "s_state",
                            "s_zip", "s_market_id"])
        st = st.filter(pc.equal(st["s_market_id"], 8))
        it = read("item", ["i_item_sk", "i_color", "i_current_price",
                           "i_manager_id", "i_units", "i_size"])
        c = read("customer", ["c_customer_sk", "c_last_name",
                              "c_first_name", "c_birth_country"])
        ca = read("customer_address", ["ca_state", "ca_zip", "ca_country"])
        ca = ca.append_column("__country", pc.ascii_upper(ca["ca_country"]))
        j = join(ss, sr, ["ss_ticket_number", "ss_item_sk"],
                 ["sr_ticket_number", "sr_item_sk"])
        j = join(join(join(j, st, "ss_store_sk", "s_store_sk"), it,
                      "ss_item_sk", "i_item_sk"), c, "ss_customer_sk",
                 "c_customer_sk")
        j = join(j, ca, ["s_zip", "c_birth_country"],
                 ["ca_zip", "__country"])
        keys = ["c_last_name", "c_first_name", "s_store_name", "ca_state",
                "s_state", "i_color", "i_current_price", "i_manager_id",
                "i_units", "i_size"]
        ssales = j.group_by(keys).aggregate([("ss_net_paid", "sum")])
        limit = None
        if ssales.num_rows:
            limit = 0.05 * pc.mean(ssales["ss_net_paid_sum"]).as_py()
        red = ssales.filter(pc.equal(ssales["i_color"], "red"))
        g = red.group_by(keys[:3]).aggregate([("ss_net_paid_sum", "sum")])
        out["q24"] = [r for r in rows_of(g, keys[:3] +
                                         ["ss_net_paid_sum_sum"])
                      if limit is not None and r[3] is not None and
                      r[3] > limit]
    for q, fact, cust, addr, amt, year, cols in (
            ("q30", "web_returns", "wr_returning_customer_sk",
             "wr_returning_addr_sk", "wr_return_amt", 2002,
             ["c_customer_id", "c_salutation", "c_first_name",
              "c_last_name", "c_preferred_cust_flag", "c_birth_year"]),
            ("q81", "catalog_returns", "cr_returning_customer_sk",
             "cr_returning_addr_sk", "cr_return_amt_inc_tax", 2000,
             ["c_customer_id", "c_salutation", "c_first_name",
              "c_last_name"])):
        if q not in queries:
            continue
        date = fact[0] + "r_returned_date_sk"
        r = join(read(fact, [date, cust, addr, amt]),
                 dates(("d_year", eq(year))), date, "d_date_sk")
        r = join(r, read("customer_address", ["ca_address_sk", "ca_state"]),
                 addr, "ca_address_sk")
        ctr = r.group_by([cust, "ca_state"]).aggregate([(amt, "sum")])
        ctr = ctr.rename_columns(["ctr_state" if n == "ca_state" else n
                                  for n in ctr.column_names])
        ctr = over_avg(ctr, amt + "_sum", "ctr_state", 1.2)
        c = read("customer", ["c_customer_sk", "c_current_addr_sk"] + cols)
        ca = read("customer_address", ["ca_address_sk", "ca_state"])
        c = join(c, ca.filter(pc.equal(ca["ca_state"], "GA")),
                 "c_current_addr_sk", "ca_address_sk")
        j = join(ctr, c, cust, "c_customer_sk")
        out[q] = rows_of(j, cols + [amt + "_sum"])
    for q, p, fact, manufact in (("q32", "cs", "catalog_sales", 977),
                                 ("q92", "ws", "web_sales", 350)):
        if q not in queries:
            continue
        item, amt = f"{p}_item_sk", f"{p}_ext_discount_amt"
        f = join(read(fact, [f"{p}_sold_date_sk", item, amt]),
                 dates(("d_year", eq(2000)),
                       ("d_moy", lambda c: between(c, 1, 4))),
                 f"{p}_sold_date_sk", "d_date_sk")
        f = over_avg(f, amt, item, 1.3)
        it = read("item", ["i_item_sk", "i_manufact_id"])
        f = join(f, it.filter(pc.equal(it["i_manufact_id"], manufact)),
                 item, "i_item_sk")
        out[q] = [(pc.sum(f[amt]).as_py(),)]
    if "q45" in queries:
        ws = read("web_sales", ["ws_bill_customer_sk", "ws_item_sk",
                                "ws_sold_date_sk", "ws_sales_price"])
        j = join(ws, dates(("d_qoy", eq(2)), ("d_year", eq(2001))),
                 "ws_sold_date_sk", "d_date_sk")
        j = join(j, read("customer", ["c_customer_sk", "c_current_addr_sk"]),
                 "ws_bill_customer_sk", "c_customer_sk")
        j = join(j, read("customer_address", ["ca_address_sk", "ca_zip",
                                              "ca_city"]),
                 "c_current_addr_sk", "ca_address_sk")
        it = read("item", ["i_item_sk", "i_item_id"])
        j = join(j, it, "ws_item_sk", "i_item_sk")
        ids = it.filter(isin(it["i_item_sk"], [2, 3, 5, 7, 11, 13, 17, 19,
                                               23, 29]))["i_item_id"]
        zips = ["85669", "86197", "88274", "83405", "86475", "85392",
                "85460", "80348", "81792"]
        j = j.filter(pc.or_kleene(
            isin(pc.utf8_slice_codeunits(j["ca_zip"], 0, 5), zips),
            pc.is_in(j["i_item_id"], value_set=pc.drop_null(ids))))
        g = j.group_by(["ca_zip", "ca_city"]).aggregate(
            [("ws_sales_price", "sum")])
        out["q45"] = rows_of(g, ["ca_zip", "ca_city", "ws_sales_price_sum"])
    if "q58" in queries:
        d = dates()
        week = d.filter(pc.and_(pc.and_(pc.equal(d["d_year"], 2000),
                                        pc.equal(d["d_moy"], 1)),
                                pc.equal(d["d_dom"], 3)))["d_week_seq"]
        check(len(week) == 1, "q58: not one week")
        days = d.filter(pc.equal(d["d_week_seq"], week[0]))
        it = read("item", ["i_item_sk", "i_item_id"])
        rev = []
        for p, fact in (("ss", "store_sales"), ("cs", "catalog_sales"),
                        ("ws", "web_sales")):
            f = join(read(fact, [f"{p}_sold_date_sk", f"{p}_item_sk",
                                 f"{p}_ext_sales_price"]), days,
                     f"{p}_sold_date_sk", "d_date_sk")
            g = join(f, it, f"{p}_item_sk", "i_item_sk").group_by(
                "i_item_id").aggregate([(f"{p}_ext_sales_price", "sum")])
            rev.append(dict(rows_of(g, ["i_item_id",
                                        f"{p}_ext_sales_price_sum"])))
        rows = []
        for item, s in rev[0].items():
            if item not in rev[1] or item not in rev[2]:
                continue
            c, w = rev[1][item], rev[2][item]
            if None in (s, c, w) or not all(
                    0.9 * b <= a <= 1.1 * b for a, b in (
                        (s, c), (s, w), (c, s), (c, w), (w, s), (w, c))):
                continue
            avg = (s + c + w) / 3
            rows.append((item, s, s / avg * 100, c, c / avg * 100, w,
                         w / avg * 100, avg))
        out["q58"] = rows
    return out

class SqlRun:
    """``session.sql(text).to_arrow()`` as the one unit ``cold_and_warm``
    times in phase 9: the lowering, with every subquery it runs on the
    card, is inside the timed wall.  ``lower_s`` holds each run's
    lowering seconds."""

    def __init__(self, session, text: str, on_card: bool):
        self.session, self.text, self.on_card = session, text, on_card
        self.lower_s = []

    def to_arrow(self):
        import torch
        t0 = time.perf_counter()
        df = self.session.sql(self.text)
        if self.on_card:
            torch.cuda.synchronize()
        self.lower_s.append(time.perf_counter() - t0)
        return df.to_arrow()


def tpcds9_phase(args, kernels_used, data_dir: str, session) -> dict:
    """Phase 9: the verbatim text of the 12 TPC-DS queries with
    expression subqueries (DS9_QUERIES: scalar, IN, EXISTS and their
    correlated forms) through the port's ``session.sql`` on phase 7's
    tables, directory and session.  Each must plan DS9_PLANS' operators
    at SF10, equal ``ds9_references`` (1e-9, ORDER BY kept, ties as a
    multiset, also at the LIMIT's cut), give the same bytes on two warm
    runs, and return rows unless DS9_EMPTY names it.  A run is
    ``session.sql(text).to_arrow()`` (``SqlRun``): the subqueries that
    run while the text is lowered (q9's fifteen scans of store_sales)
    are inside its wall, and the lowering's share is printed apart.
    Below SF10 the broadcast threshold shrinks with the scale, as in
    phases 7 and 8.  q10 and q1 run once more under the profiler.
    Returns the kernels' launches on this path."""
    from tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.kernels import cuda_ops
    from spark_rapids_tpu_torch.plan import overrides
    on_card = args.device == "cuda"

    t0 = time.perf_counter()
    refs = ds9_references(data_dir)
    print(f"tpcds9: pyarrow references in {time.perf_counter() - t0:.1f}s")
    rows = {t: max(int(n * args.ds_sf), 64) for t, n in
            {**DS_ROWS_PER_SF, **DS7_ROWS_PER_SF}.items()}
    cache = DeviceScanCache.get()
    launches = {k: 0 for k in cuda_ops.LAUNCHES}
    threshold = overrides.BROADCAST_ROW_THRESHOLD
    overrides.BROADCAST_ROW_THRESHOLD = max(
        1, int(threshold * min(args.ds_sf, 10.0) / 10.0))
    try:
        for q in DS9_QUERIES:
            check("spark_rapids_tpu" not in sys.modules and
                  "jax" not in sys.modules,
                  "phase 9 imported JAX or the JAX package")
            plan = session.sql(QUERIES[q]).explain()
            check(plan_signature(plan) == DS9_PLANS[q] or args.ds_sf < 10,
                  f"{q}: not the planned operators:\n{plan}")
            run = SqlRun(session, QUERIES[q], on_card)
            cold, cold_s, read_s, upload_s, warm, warm_s, peak = \
                cold_and_warm(session, run, on_card)
            for name, v in cuda_ops.LAUNCHES.items():
                launches[name] += v
            order, limit = DS9_ORDER[q], DS9_LIMIT.get(q, 100)
            full = check_rows(q, cold, refs[q], order, limit)
            for t in warm:
                check_rows(q, t, refs[q], order, limit)
            check(same_bytes(warm[0], warm[1]),
                  f"{q}: the two warm runs are not byte-identical")
            check(cold.num_rows > 0 or q in DS9_EMPTY or args.ds_sf < 10,
                  f"{q}: no rows (not in DS9_EMPTY)")
            fact = rows[DS9_FACT[q]]
            got = cuda_ops.LAUNCHES
            lower = run.lower_s
            print(f"{q}: {cold.num_rows} rows of {full}; cold {cold_s:.4f}s "
                  f"(lowering and its subqueries {lower[0]:.4f}s, "
                  f"{100 * lower[0] / cold_s:.1f}%; host read "
                  f"{read_s:.4f}s, upload {upload_s:.4f}s); warm "
                  f"{warm_s[0]:.4f}s {warm_s[1]:.4f}s (lowering "
                  f"{lower[2]:.4f}s, {100 * lower[2] / warm_s[1]:.1f}%); "
                  f"warm {fact / warm_s[1] / 1e6:.3f} Mrows/s of "
                  f"{DS9_FACT[q]}; peak device memory {peak} B; launches "
                  f"(3 runs) B1 {got['hash_partition_ids']}, B2 "
                  f"{got['table_reduce']}, probe {got['join_probe']}; "
                  f"byte-identical warm runs; matches pyarrow at "
                  f"{EXACT_REL}; first rows {cold.slice(0, 2).to_pylist()}",
                  flush=True)
        for q in ("q10", "q1"):
            print(f"plan {q}:\n" + session.sql(QUERIES[q]).explain())
            if on_card:
                before = dict(cuda_ops.LAUNCHES)
                print(f"profile {q}:")
                profile_query(session.sql(QUERIES[q]))
                print(f"profile {q}: kernel launches " + str(
                    {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items()}))
    finally:
        overrides.BROADCAST_ROW_THRESHOLD = threshold
        cache.clear()
    for name in kernels_used:
        check(launches.get(name, 0) > 0,
              f"{name} never launched on the phase 9 path")
    print(f"tpcds9: launches of the phase (3 runs of each query) {launches}")
    return launches


DS10_QUERIES = ("q2", "q4", "q8", "q11", "q23", "q33", "q38", "q56", "q60",
                "q66", "q71", "q74", "q76", "q83", "q87")
#: queries allowed an empty answer at SF10, with the reason
DS10_EMPTY = {
    "q76": "its three branches read the sales rows whose ss_store_sk, "
           "ws_ship_customer_sk or cs_ship_mode_sk is NULL, and the "
           "generator draws no NULL foreign key"}
#: ORDER BY of each query as (select column position, ascending); None:
#: no ORDER BY (q23's keyless sum, q38's and q87's counts)
DS10_ORDER = {
    "q2": _ASC[:1], "q4": _ASC[:4], "q8": _ASC[:1], "q11": _ASC[:4],
    "q23": None, "q33": [(1, True), (0, True)], "q38": None,
    "q56": [(1, True), (0, True)], "q60": _ASC[:2], "q66": _ASC[:1],
    "q71": [(4, False), (0, True)], "q74": _ASC[:3], "q76": _ASC[:5],
    "q83": _ASC[:2], "q87": None}
#: LIMIT of each query with an ORDER BY (100 where not listed; q2 has
#: none)
DS10_LIMIT = {"q2": 1 << 62}
#: the table whose rows a query's Mrows/s counts (its largest scan)
DS10_FACT = {q: "store_sales" for q in DS10_QUERIES}
DS10_FACT.update({"q2": "catalog_sales", "q66": "catalog_sales",
                  "q83": "store_returns"})
#: the two-digit zip prefixes of q8's address list
Q8_PREFIXES = ("24", "35", "46", "57", "68", "79", "80", "91", "12", "23",
               "34", "45", "56", "67", "78", "89", "90", "10")


def _round_half_up(v: float, digits: int) -> float:
    """Spark's ``round`` of a double (HALF_UP), in the port's formula."""
    s = v * 10.0 ** digits
    return math.copysign(math.floor(abs(s) + 0.5), s) / 10.0 ** digits


def _sum_or_null(values):
    """SQL ``sum``: the sum of the non-null values, NULL if there is
    none."""
    vals = [v for v in values if v is not None]
    return sum(vals) if vals else None


def ds10_references(data_dir: str, queries=DS10_QUERIES) -> dict:
    """Each phase-10 query's full result (every row before its LIMIT), in
    its select list's order, by pyarrow and Python written apart from
    the port: a UNION ALL is the branches' rows one after the other (or
    their sums merged by key), an INTERSECT or EXCEPT of DISTINCT sets a
    ``pc.unique`` of one joined key per row tested with ``pc.is_in``, a
    join whose key repeats (q2's weeks, q8's zip prefixes) a multiplicity
    counted apart, and q4/q11/q74's six- and four-way self-join of
    ``year_total`` a product over each customer's rows."""
    import collections
    import pyarrow as pa
    import pyarrow.compute as pc
    read, join, isin, between = _ds7_tools(data_dir)
    out = {}

    def rows_of(t, cols):
        return list(zip(*[t[c].to_pylist() for c in cols]))

    def dates(cols, *conds):
        d = read("date_dim", ["d_date_sk"] + cols)
        for col, fn in conds:
            d = d.filter(fn(d[col]))
        return d

    def eq(v):
        return lambda c: pc.equal(c, v)

    if "q2" in queries:
        days = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                "Friday", "Saturday")
        d = read("date_dim", ["d_date_sk", "d_week_seq", "d_day_name",
                              "d_year"])
        sales = pa.concat_tables([
            read(f, [f"{p}_sold_date_sk", f"{p}_ext_sales_price"])
            .rename_columns(["sold_date_sk", "sales_price"])
            for p, f in (("ws", "web_sales"), ("cs", "catalog_sales"))])
        j = join(sales, d, "sold_date_sk", "d_date_sk")
        none = pa.scalar(None, pa.float64())
        for day in days:
            j = j.append_column(day, pc.if_else(
                pc.equal(j["d_day_name"], day), j["sales_price"], none))
        g = j.group_by("d_week_seq").aggregate([(x, "sum") for x in days])
        week = {r[0]: r[1:] for r in rows_of(
            g, ["d_week_seq"] + [f"{x}_sum" for x in days])}
        # a week's row repeats once per date_dim row of that week in the
        # year (``from wswscs, date_dim where d_week_seq = ... and d_year
        # = 2000``)
        per_year = {y: collections.Counter(d.filter(pc.equal(
            d["d_year"], y))["d_week_seq"].to_pylist()) for y in (2000,
                                                                 2001)}
        rows = []
        for w1, n1 in per_year[2000].items():
            w2 = w1 + 53
            if w1 not in week or w2 not in week or w2 not in per_year[2001]:
                continue
            vals = tuple(None if a is None or b is None or b == 0 else
                         _round_half_up(a / b, 2)
                         for a, b in zip(week[w1], week[w2]))
            rows += [(w1,) + vals] * (n1 * per_year[2001][w2])
        out["q2"] = rows

    def year_over_year(cust_cols, value, channels, years, beats):
        """q4/q11/q74: each channel's ``year_total`` branch summed by
        customer and year, then the self-join of its first- and
        second-year rows: the customers whose first-year totals are all
        positive and whose growth ratios (second / first year, by
        channel letter) ``beats`` holds, with the second store year's
        customer columns.  The text groups and joins by the customer's
        columns and id; each id names one customer, so the sums group by
        the customer key and the rows join on it."""
        facts = {"s": ("store_sales", "ss", "ss_customer_sk"),
                 "c": ("catalog_sales", "cs", "cs_bill_customer_sk"),
                 "w": ("web_sales", "ws", "ws_bill_customer_sk")}
        cust = read("customer", ["c_customer_sk"] + cust_cols)
        check(pc.count_distinct(cust["c_customer_id"]).as_py() ==
              cust.num_rows, "customer ids repeat")
        d = dates(["d_year"], ("d_year", lambda c: isin(c, list(years))))
        t = None
        for ch in channels:
            fact, p, ck = facts[ch]
            cols = {c.replace("PFX", p) for c in value[1]}
            f = read(fact, [ck, f"{p}_sold_date_sk"] + sorted(cols))
            f = f.append_column("v", value[0](
                lambda name: f[name.replace("PFX", p)]))
            g = join(f, d, f"{p}_sold_date_sk", "d_date_sk").group_by(
                [ck, "d_year"]).aggregate([("v", "sum")])
            for i, y in enumerate(years):
                part = g.filter(pc.equal(g["d_year"], y))
                part = pa.table({"sk": part[ck],
                                 f"{ch}{i}": part["v_sum"]})
                t = part if t is None else join(t, part, "sk", "sk")
        keep = None
        for ch in channels:
            first_ok = pc.greater(t[f"{ch}0"], 0)
            keep = first_ok if keep is None else pc.and_(keep, first_ok)
        ratio = {ch: pc.divide(t[f"{ch}1"], t[f"{ch}0"]) for ch in channels}
        t = t.filter(pc.and_(keep, beats(ratio)))
        t = join(t, cust, "sk", "c_customer_sk")
        return rows_of(t, cust_cols[:4] if len(cust_cols) > 3 else
                       cust_cols)

    wide = ["c_customer_id", "c_first_name", "c_last_name",
            "c_preferred_cust_flag", "c_birth_country", "c_login",
            "c_email_address"]
    if "q4" in queries:
        def v4(col):
            return pc.divide(pc.add(pc.subtract(pc.subtract(
                col("PFX_ext_list_price"), col("PFX_ext_wholesale_cost")),
                col("PFX_ext_discount_amt")), col("PFX_ext_sales_price")),
                2)
        out["q4"] = year_over_year(
            wide, (v4, ["PFX_ext_list_price", "PFX_ext_wholesale_cost",
                        "PFX_ext_discount_amt", "PFX_ext_sales_price"]),
            ("s", "c", "w"), (2001, 2002),
            lambda r: pc.and_(pc.greater(r["c"], r["s"]),
                              pc.greater(r["c"], r["w"])))
    if "q11" in queries:
        # q11's CASE gives 0.0 where q4's and q74's give NULL; every
        # first-year total that reaches it is positive
        out["q11"] = year_over_year(
            wide, (lambda col: pc.subtract(col("PFX_ext_list_price"),
                                           col("PFX_ext_discount_amt")),
                   ["PFX_ext_list_price", "PFX_ext_discount_amt"]),
            ("s", "w"), (2001, 2002),
            lambda r: pc.greater(r["w"], r["s"]))
    if "q74" in queries:
        out["q74"] = year_over_year(
            wide[:3], (lambda col: col("PFX_net_paid"), ["PFX_net_paid"]),
            ("s", "w"), (1999, 2000), lambda r: pc.greater(r["w"], r["s"]))
    if "q8" in queries:
        ca = read("customer_address", ["ca_address_sk", "ca_zip"])
        ca = ca.append_column("z5", pc.utf8_slice_codeunits(
            ca["ca_zip"], 0, 5))
        listed = set(pc.unique(pc.filter(ca["z5"], isin(
            pc.utf8_slice_codeunits(ca["ca_zip"], 0, 2),
            list(Q8_PREFIXES)))).to_pylist())
        c = read("customer", ["c_current_addr_sk", "c_preferred_cust_flag"])
        c = c.filter(pc.equal(c["c_preferred_cust_flag"], "Y"))
        g = join(c, ca, "c_current_addr_sk", "ca_address_sk").group_by(
            "z5").aggregate([("c_preferred_cust_flag", "count")])
        g = g.filter(pc.greater(g["c_preferred_cust_flag_count"], 1))
        zips = listed & set(g["z5"].to_pylist())
        # the join on two-digit prefixes repeats a store's rows once per
        # zip of its prefix
        per_prefix = collections.Counter(z[:2] for z in zips)
        ss = join(read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                       "ss_net_profit"]),
                  dates(["d_qoy", "d_year"], ("d_qoy", eq(2)),
                        ("d_year", eq(1998))), "ss_sold_date_sk",
                  "d_date_sk")
        g = ss.group_by("ss_store_sk").aggregate([("ss_net_profit", "sum")])
        profit = dict(rows_of(g, ["ss_store_sk", "ss_net_profit_sum"]))
        by_name = collections.defaultdict(list)
        for sk, name, zip_ in rows_of(read("store", [
                "s_store_sk", "s_store_name", "s_zip"]),
                ["s_store_sk", "s_store_name", "s_zip"]):
            n = per_prefix.get(zip_[:2], 0) if zip_ is not None else 0
            if sk in profit and n:
                by_name[name].append(None if profit[sk] is None else
                                     profit[sk] * n)
        out["q8"] = [(k, _sum_or_null(v)) for k, v in by_name.items()]
    if "q23" in queries:
        years = ("d_year", lambda c: isin(c, [2000, 2001, 2002, 2003]))
        ss = read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                                  "ss_customer_sk", "ss_quantity",
                                  "ss_sales_price"])
        ss = ss.append_column("csales", pc.multiply(ss["ss_quantity"],
                                                    ss["ss_sales_price"]))
        it = read("item", ["i_item_sk", "i_item_desc"])
        j = join(join(ss, dates(["d_date", "d_year"], years),
                      "ss_sold_date_sk", "d_date_sk"), it, "ss_item_sk",
                 "i_item_sk")
        j = j.append_column("desc30", pc.utf8_slice_codeunits(
            j["i_item_desc"], 0, 30))
        g = j.group_by(["desc30", "ss_item_sk", "d_date"]).aggregate(
            [("ss_sold_date_sk", "count")])
        frequent = pc.unique(g.filter(pc.greater(
            g["ss_sold_date_sk_count"], 4))["ss_item_sk"])
        cust = read("customer", ["c_customer_sk"])
        sc = join(ss, cust, "ss_customer_sk", "c_customer_sk")
        g = join(sc, dates(["d_year"], years), "ss_sold_date_sk",
                 "d_date_sk").group_by("ss_customer_sk").aggregate(
            [("csales", "sum")])
        cmax = pc.max(g["csales_sum"]).as_py()
        g = sc.group_by("ss_customer_sk").aggregate([("csales", "sum")])
        best = pc.unique(g.filter(pc.greater(
            g["csales_sum"], 0.5 * cmax))["ss_customer_sk"]) \
            if cmax is not None else pa.array([], pa.int64())
        parts = []
        for p, fact in (("cs", "catalog_sales"), ("ws", "web_sales")):
            f = join(read(fact, [f"{p}_sold_date_sk", f"{p}_item_sk",
                                 f"{p}_bill_customer_sk", f"{p}_quantity",
                                 f"{p}_list_price"]),
                     dates(["d_year", "d_moy"], ("d_year", eq(2000)),
                           ("d_moy", eq(2))), f"{p}_sold_date_sk",
                     "d_date_sk")
            f = f.filter(pc.and_(
                pc.is_in(f[f"{p}_item_sk"], value_set=frequent),
                pc.is_in(f[f"{p}_bill_customer_sk"], value_set=best)))
            parts += pc.multiply(f[f"{p}_quantity"],
                                 f[f"{p}_list_price"]).to_pylist()
        out["q23"] = [(_sum_or_null(parts),)]

    def three_channels(key, item_ok, year, moy):
        """q33/q56/q60: each channel's sales of (year, moy) to addresses
        at GMT offset -5 of the items ``item_ok`` keeps, summed by
        ``key``; then the three channels' sums summed by ``key``."""
        it = read("item", ["i_item_sk", key, "i_category", "i_color"])
        it = it.filter(item_ok(it))
        ca = read("customer_address", ["ca_address_sk", "ca_gmt_offset"])
        ca = ca.filter(pc.equal(ca["ca_gmt_offset"], -5))
        d = dates(["d_year", "d_moy"], ("d_year", eq(year)),
                  ("d_moy", eq(moy)))
        totals = collections.defaultdict(list)
        for p, fact, addr in (("ss", "store_sales", "ss_addr_sk"),
                              ("cs", "catalog_sales", "cs_bill_addr_sk"),
                              ("ws", "web_sales", "ws_bill_addr_sk")):
            price = f"{p}_ext_sales_price"
            f = read(fact, [f"{p}_sold_date_sk", f"{p}_item_sk", addr,
                            price])
            j = join(join(join(f, d, f"{p}_sold_date_sk", "d_date_sk"), ca,
                          addr, "ca_address_sk"), it, f"{p}_item_sk",
                     "i_item_sk")
            g = j.group_by(key).aggregate([(price, "sum")])
            for k, v in rows_of(g, [key, f"{price}_sum"]):
                totals[k].append(v)
        return [(k, _sum_or_null(v)) for k, v in totals.items()]

    def item_in(key, col, values):
        """``key in (select key from item where col in values)``."""
        def keep(it):
            return pc.is_in(it[key], value_set=pc.unique(pc.drop_null(
                it.filter(isin(it[col], values))[key])))
        return keep
    if "q33" in queries:
        out["q33"] = three_channels(
            "i_manufact_id", item_in("i_manufact_id", "i_category",
                                     ["Books"]), 1998, 1)
    if "q56" in queries:
        out["q56"] = three_channels(
            "i_item_id", item_in("i_item_id", "i_color",
                                 ["red", "blue", "green"]), 2000, 2)
    if "q60" in queries:
        out["q60"] = three_channels(
            "i_item_id", item_in("i_item_id", "i_category", ["Music"]),
            1998, 9)

    def name_date_keys(p, fact, cust):
        """The distinct (last name, first name, sold date) of a channel
        in months 1200-1211, as one string key per row (a NULL part and
        an empty one stay apart)."""
        f = read(fact, [f"{p}_sold_date_sk", cust])
        j = join(join(f, dates(["d_date", "d_month_seq"], (
            "d_month_seq", lambda c: between(c, 1200, 1211))),
            f"{p}_sold_date_sk", "d_date_sk"),
            read("customer", ["c_customer_sk", "c_last_name",
                              "c_first_name"]), cust, "c_customer_sk")
        parts = [pc.fill_null(pc.binary_join_element_wise("v", j[c], ""),
                              "n") for c in ("c_last_name", "c_first_name")]
        parts.append(pc.fill_null(pc.binary_join_element_wise(
            "v", pc.cast(j["d_date"], pa.string()), ""), "n"))
        return pc.unique(pc.binary_join_element_wise(*parts, "\x00"))
    if "q38" in queries or "q87" in queries:
        ks = name_date_keys("ss", "store_sales", "ss_customer_sk")
        kc = name_date_keys("cs", "catalog_sales", "cs_bill_customer_sk")
        kw = name_date_keys("ws", "web_sales", "ws_bill_customer_sk")
        def count(mask):
            return pc.sum(pc.cast(mask, pa.int64())).as_py() or 0
        in_c = pc.is_in(ks, value_set=kc)
        in_w = pc.is_in(ks, value_set=kw)
        if "q38" in queries:
            out["q38"] = [(count(pc.and_(in_c, in_w)),)]
        if "q87" in queries:
            out["q87"] = [(count(pc.invert(pc.or_(in_c, in_w))),)]
    if "q66" in queries:
        wcols = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city",
                 "w_county", "w_state", "w_country"]
        wh = read("warehouse", ["w_warehouse_sk"] + wcols)
        d = dates(["d_year", "d_moy"], ("d_year", eq(2001)))
        tm = read("time_dim", ["t_time_sk", "t_time"])
        tm = tm.filter(between(tm["t_time"], 30838, 30838 + 28800))
        sm = read("ship_mode", ["sm_ship_mode_sk", "sm_carrier"])
        sm = sm.filter(isin(sm["sm_carrier"], ["DHL", "UPS"]))
        months = [f"s{m}" for m in range(1, 13)] + \
            [f"n{m}" for m in range(1, 13)]
        inner = []
        for p, fact, price, net in (
                ("ws", "web_sales", "ws_ext_sales_price", "ws_net_paid"),
                ("cs", "catalog_sales", "cs_sales_price",
                 "cs_net_paid_inc_ship")):
            f = read(fact, [f"{p}_warehouse_sk", f"{p}_sold_date_sk",
                            f"{p}_sold_time_sk", f"{p}_ship_mode_sk",
                            price, net, f"{p}_quantity"])
            j = join(join(join(join(f, wh, f"{p}_warehouse_sk",
                                    "w_warehouse_sk"), d,
                               f"{p}_sold_date_sk", "d_date_sk"), tm,
                          f"{p}_sold_time_sk", "t_time_sk"), sm,
                     f"{p}_ship_mode_sk", "sm_ship_mode_sk")
            for m in range(1, 13):
                hit = pc.equal(j["d_moy"], m)
                for tag, col in (("s", price), ("n", net)):
                    j = j.append_column(f"{tag}{m}", pc.if_else(
                        hit, pc.multiply(j[col], j[f"{p}_quantity"]), 0.0))
            g = j.group_by(wcols + ["d_year"]).aggregate(
                [(c, "sum") for c in months])
            inner += rows_of(g, wcols + ["d_year"] +
                             [f"{c}_sum" for c in months])
        merged = collections.defaultdict(list)
        for r in inner:
            merged[r[:6] + ("DHL,UPS", r[6])].append(r[7:])
        out["q66"] = [k + tuple(_sum_or_null(col) for col in zip(*vs))
                      for k, vs in merged.items()]
    if "q71" in queries:
        d = dates(["d_year", "d_moy"], ("d_moy", eq(11)),
                  ("d_year", eq(1999)))
        parts = []
        for p, fact in (("ws", "web_sales"), ("ss", "store_sales")):
            f = join(read(fact, [f"{p}_ext_sales_price", f"{p}_sold_date_sk",
                                 f"{p}_item_sk", f"{p}_sold_time_sk"]), d,
                     f"{p}_sold_date_sk", "d_date_sk")
            parts.append(f.select([f"{p}_ext_sales_price", f"{p}_item_sk",
                                   f"{p}_sold_time_sk"]).rename_columns(
                ["ext_price", "sold_item_sk", "time_sk"]))
        u = pa.concat_tables(parts)
        it = read("item", ["i_item_sk", "i_brand_id", "i_brand",
                           "i_manager_id"])
        it = it.filter(pc.equal(it["i_manager_id"], 1))
        tm = read("time_dim", ["t_time_sk", "t_hour", "t_minute"])
        tm = tm.filter(isin(tm["t_hour"], [8, 9]))
        j = join(join(u, it, "sold_item_sk", "i_item_sk"), tm, "time_sk",
                 "t_time_sk")
        g = j.group_by(["i_brand_id", "i_brand", "t_hour",
                        "t_minute"]).aggregate([("ext_price", "sum")])
        out["q71"] = rows_of(g, ["i_brand_id", "i_brand", "t_hour",
                                 "t_minute", "ext_price_sum"])
    if "q76" in queries:
        it = read("item", ["i_item_sk", "i_category"])
        d = read("date_dim", ["d_date_sk", "d_year", "d_qoy"])
        parts = []
        for channel, col_name, p, fact in (
                ("store", "ss_store_sk", "ss", "store_sales"),
                ("web", "ws_ship_customer_sk", "ws", "web_sales"),
                ("catalog", "cs_ship_mode_sk", "cs", "catalog_sales")):
            f = read(fact, [col_name, f"{p}_sold_date_sk", f"{p}_item_sk",
                            f"{p}_ext_sales_price"])
            f = f.filter(pc.is_null(f[col_name]))
            j = join(join(f, it, f"{p}_item_sk", "i_item_sk"), d,
                     f"{p}_sold_date_sk", "d_date_sk")
            n = j.num_rows
            parts.append(pa.table({
                "channel": pa.array([channel] * n, pa.string()),
                "col_name": pa.array([col_name] * n, pa.string()),
                "d_year": j["d_year"], "d_qoy": j["d_qoy"],
                "i_category": j["i_category"],
                "price": j[f"{p}_ext_sales_price"]}))
        keys = ["channel", "col_name", "d_year", "d_qoy", "i_category"]
        g = pa.concat_tables(parts).group_by(keys).aggregate(
            [("price", "count", pc.CountOptions(mode="all")),
             ("price", "sum")])
        out["q76"] = rows_of(g, keys + ["price_count", "price_sum"])
    if "q83" in queries:
        d = read("date_dim", ["d_date_sk", "d_date", "d_week_seq", "d_year",
                              "d_moy", "d_dom"])
        day = d.filter(pc.and_(pc.and_(pc.equal(d["d_year"], 2000),
                                       pc.equal(d["d_moy"], 6)),
                               pc.equal(d["d_dom"], 30)))
        week = d.filter(pc.is_in(d["d_week_seq"],
                                 value_set=day["d_week_seq"]))
        days = d.filter(pc.is_in(d["d_date"], value_set=week["d_date"]))
        it = read("item", ["i_item_sk", "i_item_id"])
        qty = []
        for p, fact in (("sr", "store_returns"), ("cr", "catalog_returns"),
                        ("wr", "web_returns")):
            f = read(fact, [f"{p}_item_sk", f"{p}_returned_date_sk",
                            f"{p}_return_quantity"])
            j = join(join(f, it, f"{p}_item_sk", "i_item_sk"), days,
                     f"{p}_returned_date_sk", "d_date_sk")
            g = j.group_by("i_item_id").aggregate(
                [(f"{p}_return_quantity", "sum")])
            qty.append(dict(rows_of(g, ["i_item_id",
                                        f"{p}_return_quantity_sum"])))
        rows = []
        for item, sr in qty[0].items():
            if item is None or item not in qty[1] or item not in qty[2]:
                continue
            cr, wr = qty[1][item], qty[2][item]
            total = None if None in (sr, cr, wr) else sr + cr + wr

            def dev(x):
                return None if x is None or total is None or total == 0 \
                    else x / total / 3.0 * 100
            rows.append((item, sr, dev(sr), cr, dev(cr), wr, dev(wr),
                         None if total is None else total / 3.0))
        out["q83"] = rows
    return out


#: each phase-10 query's plan at SF10's row estimates, as DS7_PLANS lists
#: them.  A Distinct is an aggregate; q4, q11 and q74 read one branch of
#: their ``year_total`` union per self-join (the filter over the union
#: leaves the other branches empty, with no operator); INTERSECT and
#: EXCEPT are semi and anti joins, shuffled where both sides are fact
#: rows (q38, q87) and broadcast where one side is q8's zip list
_BSEMI = "TpuBroadcastHashJoin[semi, build=right]"
_YEAR_TOTAL = _AGG + [_BR, _BL]           # one channel's year of q4/q11/q74
_CHANNEL = _AGG + [_BSEMI, _BR, _BR, _BR]   # one channel of q33, q56, q60
_NAME_DATES = _AGG + [_BR, _BR]             # one DISTINCT set of q38, q87
_HOT_ITEMS = [_SSEMI, _SSEMI, _BR] + _AGG + [_BR, _BR] + _AGG + [_BR]
DS10_PLANS = {
    "q2": ["TpuSort", _SR, _BR] + _AGG + [_BR, _BR] + _AGG + [_BR],
    "q4": _LS + [_SR] * 5 + _YEAR_TOTAL * 6,
    "q8": _LS + _AGG + [_BR] * 3 + _AGG + [_BSEMI] + _AGG + [_BL],
    "q11": _LS + [_SR] * 3 + _YEAR_TOTAL * 4,
    "q23": ["TpuGlobalLimit"] + _AGG + _HOT_ITEMS * 2,
    "q33": _LS + _AGG + _CHANNEL * 3,
    "q38": ["TpuGlobalLimit"] + _AGG * 2 + [_SSEMI] + _AGG + [_SSEMI] +
           _NAME_DATES * 3,
    "q56": _LS + _AGG + _CHANNEL * 3,
    "q60": _LS + _AGG + _CHANNEL * 3,
    "q66": _LS + _AGG + (_AGG + [_BR] * 4) * 2,
    "q71": _LS + _AGG + [_BR, _BL, _BR, _BR],
    "q74": _LS + [_SR] * 3 + _YEAR_TOTAL * 4,
    "q76": _LS + _AGG + [_BR] * 6,
    "q83": _LS + [_BR, _SR] + (_AGG + [_BSEMI, _BR, _BR, _BSEMI]) * 3,
    "q87": _AGG * 2 + [_SANTI] + _AGG + [_SANTI] + _NAME_DATES * 3}


#: the optimizer rules that make each read of q4's CTE one branch's year
PUSHDOWN_RULES = ("_rewrite_filter_union", "_rewrite_filter_aggregate",
                  "_fold_constants")


def q4_without_pushdown(session, text: str, ref: list) -> None:
    """On the CPU rehearsal: q4's wall once more with PUSHDOWN_RULES
    switched off, so that every read of its CTE aggregates every branch
    over every year, beside the same rows."""
    from spark_rapids_tpu_torch.plan import logical_opt
    saved = {n: getattr(logical_opt, n) for n in PUSHDOWN_RULES}
    try:
        for n in PUSHDOWN_RULES:
            setattr(logical_opt, n, lambda f: f)
        t0 = time.perf_counter()
        table = SqlRun(session, text, False).to_arrow()
        wall = time.perf_counter() - t0
    finally:
        for n, rule in saved.items():
            setattr(logical_opt, n, rule)
    check_rows("q4", table, ref, DS10_ORDER["q4"])
    print(f"q4 without the union and group-key push-downs and the constant "
          f"folding (CPU): {wall:.4f}s, the same rows", flush=True)


def tpcds10_phase(args, kernels_used, data_dir: str, session) -> dict:
    """Phase 10: the verbatim text of the 15 TPC-DS queries with set
    operations, SELECT DISTINCT and DATE columns (DS10_QUERIES) through
    the port's ``session.sql`` on phase 7's tables, directory and
    session.  Each must plan DS10_PLANS' operators at SF10, equal
    ``ds10_references`` (1e-9, ORDER BY kept, ties as a multiset, also at
    the LIMIT's cut), give the same bytes on two warm runs, and return
    rows unless DS10_EMPTY names it.  A run is ``session.sql(text)
    .to_arrow()`` (``SqlRun``), as in phase 9.  Below SF10 the broadcast
    threshold shrinks with the scale, as in phases 7-9, and q4 runs once
    more without its push-down rules (``q4_without_pushdown``).  q4 (its
    ``year_total`` CTE, a three-branch union, read six times) and q87
    (two EXCEPTs of DISTINCT sets keyed on a DATE) run once more under
    the profiler.  Returns the kernels' launches on this path."""
    from tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.kernels import cuda_ops
    from spark_rapids_tpu_torch.plan import overrides
    on_card = args.device == "cuda"

    t0 = time.perf_counter()
    refs = ds10_references(data_dir)
    print(f"tpcds10: pyarrow references in {time.perf_counter() - t0:.1f}s")
    rows = {t: max(int(n * args.ds_sf), 64) for t, n in
            {**DS_ROWS_PER_SF, **DS7_ROWS_PER_SF}.items()}
    cache = DeviceScanCache.get()
    launches = {k: 0 for k in cuda_ops.LAUNCHES}
    threshold = overrides.BROADCAST_ROW_THRESHOLD
    overrides.BROADCAST_ROW_THRESHOLD = max(
        1, int(threshold * min(args.ds_sf, 10.0) / 10.0))
    try:
        for q in DS10_QUERIES:
            tq = time.perf_counter()
            check("spark_rapids_tpu" not in sys.modules and
                  "jax" not in sys.modules,
                  "phase 10 imported JAX or the JAX package")
            plan = session.sql(QUERIES[q]).explain()
            check(plan_signature(plan) == DS10_PLANS[q] or args.ds_sf < 10,
                  f"{q}: not the planned operators:\n{plan}")
            run = SqlRun(session, QUERIES[q], on_card)
            cold, cold_s, read_s, upload_s, warm, warm_s, peak = \
                cold_and_warm(session, run, on_card)
            for name, v in cuda_ops.LAUNCHES.items():
                launches[name] += v
            order, limit = DS10_ORDER[q], DS10_LIMIT.get(q, 100)
            full = check_rows(q, cold, refs[q], order, limit)
            for t in warm:
                check_rows(q, t, refs[q], order, limit)
            check(same_bytes(warm[0], warm[1]),
                  f"{q}: the two warm runs are not byte-identical")
            check(cold.num_rows > 0 or q in DS10_EMPTY or args.ds_sf < 10,
                  f"{q}: no rows (not in DS10_EMPTY)")
            fact = rows[DS10_FACT[q]]
            got = cuda_ops.LAUNCHES
            lower = run.lower_s
            print(f"{q}: {cold.num_rows} rows of {full}; cold {cold_s:.4f}s "
                  f"(lowering and its subqueries {lower[0]:.4f}s; host "
                  f"read {read_s:.4f}s, upload {upload_s:.4f}s); warm "
                  f"{warm_s[0]:.4f}s {warm_s[1]:.4f}s (lowering "
                  f"{lower[2]:.4f}s); warm {fact / warm_s[1] / 1e6:.3f} "
                  f"Mrows/s of {DS10_FACT[q]}; peak device memory {peak} B; "
                  f"launches (3 runs) B1 {got['hash_partition_ids']}, B2 "
                  f"{got['table_reduce']}, probe {got['join_probe']}; "
                  f"byte-identical warm runs; matches pyarrow at "
                  f"{EXACT_REL}; first rows {cold.slice(0, 2).to_pylist()}; "
                  f"{time.perf_counter() - tq:.1f}s with the plan and checks",
                  flush=True)
        if not on_card:
            q4_without_pushdown(session, QUERIES["q4"], refs["q4"])
        for q in ("q4", "q87"):
            print(f"plan {q}:\n" + session.sql(QUERIES[q]).explain())
            if on_card:
                tq = time.perf_counter()
                before = dict(cuda_ops.LAUNCHES)
                print(f"profile {q}:")
                profile_query(session.sql(QUERIES[q]))
                print(f"profile {q}: kernel launches " + str(
                    {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items()})
                    + f"; {time.perf_counter() - tq:.1f}s with the trace's "
                    f"processing", flush=True)
    finally:
        overrides.BROADCAST_ROW_THRESHOLD = threshold
        cache.clear()
    for name in kernels_used:
        check(launches.get(name, 0) > 0,
              f"{name} never launched on the phase 10 path")
    print(f"tpcds10: launches of the phase (3 runs of each query) {launches}")
    return launches


DS11_QUERIES = ("q12", "q20", "q44", "q47", "q51", "q53", "q57", "q63",
                "q89", "q98")
#: queries allowed an empty answer at SF10, with the reason
DS11_EMPTY = {
    "q44": "its HAVING compares with a scalar query over the store_sales "
           "rows whose ss_hdemo_sk is NULL, and neither generator draws a "
           "NULL key: the scalar is NULL and no item passes"}


def _less_avg(s: int, a: int):
    """An ORDER BY item that is no select column: ``sum_sales -
    avg_monthly_sales`` of the row (select positions ``s`` and ``a``)."""
    def key(r):
        return None if r[s] is None or r[a] is None else r[s] - r[a]
    return key


#: ORDER BY of each query as (select column position, or a function of
#: the row for an expression that is no select column, ascending)
DS11_ORDER = {
    "q12": [(2, True), (3, True), (0, True), (1, True), (6, True)],
    "q20": [(2, True), (3, True), (0, True), (1, True), (6, True)],
    "q98": [(2, True), (3, True), (0, True), (1, True), (6, True)],
    "q44": _ASC[:1], "q51": _ASC[:2],
    "q47": [(_less_avg(6, 5), True), (0, True), (1, True), (2, True),
            (4, True)],
    "q57": [(_less_avg(6, 5), True), (0, True), (1, True), (2, True),
            (4, True)],
    "q89": [(_less_avg(6, 7), True), (3, True), (0, True), (1, True),
            (2, True), (5, True)],
    "q53": [(2, True), (1, True), (0, True)],
    "q63": [(0, True), (2, True), (1, True)]}
#: the table whose rows a query's Mrows/s counts (its largest scan)
DS11_FACT = {q: "store_sales" for q in DS11_QUERIES}
DS11_FACT.update({"q12": "web_sales", "q20": "catalog_sales",
                  "q57": "catalog_sales"})


def ds11_references(data_dir: str, queries=DS11_QUERIES) -> dict:
    """Each phase-11 query's full result (every row before its LIMIT), in
    its select list's order, by pyarrow group-bys and joins and Python
    or numpy windows written apart from the port: a whole-partition
    window is a dict of the partition's ``math.fsum``, a rank counts the
    rows that sort before, and q51's running sums and maxima run per
    item in numpy (``np.cumsum``, ``np.fmax.accumulate``) after a full
    outer join of the two channels by one combined key."""
    import collections
    import datetime
    import pyarrow as pa
    import pyarrow.compute as pc
    read, join, isin, between = _ds7_tools(data_dir)
    out = {}

    def rows_of(t, cols):
        return list(zip(*[t[c].to_pylist() for c in cols]))

    def dates(cols, *conds):
        d = read("date_dim", ["d_date_sk"] + cols)
        for col, fn in conds:
            d = d.filter(fn(d[col]))
        return d

    def eq(v):
        return lambda c: pc.equal(c, v)

    def part_avg(rows, part, value):
        """avg(value) over (partition by part) per row: the mean of the
        partition's non-NULL values, None if it has none."""
        vals = collections.defaultdict(list)
        for r in rows:
            if r[value] is not None:
                vals[part(r)].append(r[value])
        return [math.fsum(vals[part(r)]) / len(vals[part(r)])
                if vals[part(r)] else None for r in rows]

    def deviates(s, a, positive):
        """``case when avg > 0 (or <> 0) then abs(s - a) / a else null end
        > 0.1``."""
        if s is None or a is None or not (a > 0 if positive else a != 0):
            return False
        return abs(s - a) / a > 0.1

    for q, fact, p in (("q12", "web_sales", "ws"),
                       ("q20", "catalog_sales", "cs"),
                       ("q98", "store_sales", "ss")):
        if q not in queries:
            continue
        keys = ["i_item_id", "i_item_desc", "i_category", "i_class",
                "i_current_price"]
        it = read("item", ["i_item_sk"] + keys)
        it = it.filter(isin(it["i_category"], ["Sports", "Books", "Home"]))
        d = dates(["d_year", "d_moy"], ("d_year", eq(1999)),
                  ("d_moy", lambda c: between(c, 2, 3)))
        f = read(fact, [f"{p}_item_sk", f"{p}_sold_date_sk",
                        f"{p}_ext_sales_price"])
        j = join(join(f, it, f"{p}_item_sk", "i_item_sk"), d,
                 f"{p}_sold_date_sk", "d_date_sk")
        rows = _grouped(j, keys, [(f"{p}_ext_sales_price", "sum")],
                        keys + [f"{p}_ext_sales_price_sum"])
        per_class = collections.defaultdict(list)
        for r in rows:
            if r[5] is not None:
                per_class[r[3]].append(r[5])
        total = {c: math.fsum(v) for c, v in per_class.items()}
        out[q] = [r + (None if r[5] is None or r[3] not in total or
                       total[r[3]] == 0 else r[5] * 100.0 / total[r[3]],)
                  for r in rows]

    for q, key, period in (("q53", "i_manufact_id", "d_qoy"),
                           ("q63", "i_manager_id", "d_moy")):
        if q not in queries:
            continue
        it = read("item", ["i_item_sk", key, "i_category", "i_class"])
        it = it.filter(pc.or_(
            pc.and_(isin(it["i_category"], ["Books", "Home", "Sports"]),
                    isin(it["i_class"], ["classical", "fishing",
                                         "football"])),
            pc.and_(isin(it["i_category"], ["Women", "Music", "Men"]),
                    isin(it["i_class"], ["shirts", "dresses", "pants"]))))
        d = dates(["d_month_seq", period],
                  ("d_month_seq", lambda c: isin(c, list(range(1200,
                                                               1212)))))
        f = read("store_sales", ["ss_item_sk", "ss_sold_date_sk",
                                 "ss_store_sk", "ss_sales_price"])
        j = join(join(join(f, it, "ss_item_sk", "i_item_sk"), d,
                      "ss_sold_date_sk", "d_date_sk"),
                 read("store", ["s_store_sk"]), "ss_store_sk", "s_store_sk")
        rows = _grouped(j, [key, period], [("ss_sales_price", "sum")],
                        [key, period, "ss_sales_price_sum"])
        avgs = part_avg(rows, lambda r: r[0], 2)
        out[q] = [(r[0], r[2], a) for r, a in zip(rows, avgs)
                  if deviates(r[2], a, True)]

    if "q89" in queries:
        it = read("item", ["i_item_sk", "i_category", "i_class", "i_brand"])
        it = it.filter(pc.or_(
            pc.and_(isin(it["i_category"], ["Books", "Music", "Sports"]),
                    isin(it["i_class"], ["classical", "fishing",
                                         "football"])),
            pc.and_(isin(it["i_category"], ["Men", "Women", "Home"]),
                    isin(it["i_class"], ["pants", "shirts", "dresses"]))))
        d = dates(["d_year", "d_moy"], ("d_year", eq(1999)))
        f = read("store_sales", ["ss_item_sk", "ss_sold_date_sk",
                                 "ss_store_sk", "ss_sales_price"])
        j = join(join(join(f, it, "ss_item_sk", "i_item_sk"), d,
                      "ss_sold_date_sk", "d_date_sk"),
                 read("store", ["s_store_sk", "s_store_name",
                                "s_company_id"]),
                 "ss_store_sk", "s_store_sk")
        keys = ["i_category", "i_class", "i_brand", "s_store_name",
                "s_company_id", "d_moy"]
        rows = _grouped(j, keys, [("ss_sales_price", "sum")],
                        keys + ["ss_sales_price_sum"])
        avgs = part_avg(rows, lambda r: (r[0], r[2], r[3], r[4]), 6)
        out["q89"] = [r + (a,) for r, a in zip(rows, avgs)
                      if deviates(r[6], a, False)]

    for q, fact, p, dim in (
            ("q47", "store_sales", "ss",
             ("store", "ss_store_sk", "s_store_sk",
              ["s_store_name", "s_company_id"])),
            ("q57", "catalog_sales", "cs",
             ("call_center", "cs_call_center_sk", "cc_call_center_sk",
              ["cc_name"]))):
        if q not in queries:
            continue
        it = read("item", ["i_item_sk", "i_category", "i_brand"])
        d = dates(["d_year", "d_moy"], ("d_year", eq(1999)))
        f = read(fact, [f"{p}_item_sk", f"{p}_sold_date_sk", dim[1],
                        f"{p}_sales_price"])
        j = join(join(join(f, it, f"{p}_item_sk", "i_item_sk"), d,
                      f"{p}_sold_date_sk", "d_date_sk"),
                 read(dim[0], [dim[2]] + dim[3]), dim[1], dim[2])
        keys = ["i_category", "i_brand"] + dim[3] + ["d_year", "d_moy"]
        rows = _grouped(j, keys, [(f"{p}_sales_price", "sum")],
                        keys + [f"{p}_sales_price_sum"])
        nk = len(keys)
        avgs = part_avg(rows, lambda r: r[:nk - 1], nk)
        # v1's rank() is computed and not selected; the outer query keeps
        # the category, brand, store or call center name, year and month
        out[q] = [(r[0], r[1], r[2], r[nk - 2], r[nk - 1], a, r[nk])
                  for r, a in zip(rows, avgs) if deviates(r[nk], a, True)]

    if "q44" in queries:
        f = read("store_sales", ["ss_item_sk", "ss_store_sk", "ss_hdemo_sk",
                                 "ss_net_profit"])
        f = f.filter(pc.equal(f["ss_store_sk"], 4))
        base = f.filter(pc.is_null(f["ss_hdemo_sk"]))
        bound = None
        if base.num_rows:
            v = [x for x in base["ss_net_profit"].to_pylist()
                 if x is not None]
            bound = math.fsum(v) / len(v) if v else None
        items = _grouped(f, ["ss_item_sk"], [("ss_net_profit", "mean")],
                         ["ss_item_sk", "ss_net_profit_mean"])
        kept = [(i, a) for i, a in items if bound is not None and
                a is not None and a > 0.9 * bound]
        name = dict(rows_of(read("item", ["i_item_sk", "i_product_name"]),
                            ["i_item_sk", "i_product_name"]))

        def ranked(desc):
            vals = [a for _, a in kept]
            return [(i, 1 + sum(1 for b in vals
                                if (b > a if desc else b < a)))
                    for i, a in kept]
        asc = [(i, r) for i, r in ranked(False) if r < 11]
        desc = [(i, r) for i, r in ranked(True) if r < 11]
        out["q44"] = [(ra, name[ia], name[idc]) for ia, ra in asc
                      for idc, rd in desc if ra == rd and ia in name and
                      idc in name]

    if "q51" in queries:
        d = dates(["d_date", "d_month_seq"],
                  ("d_month_seq", lambda c: between(c, 1200, 1211)))
        span = 1 << 20                  # key = item * span + days

        def cumulative(fact, p):
            f = read(fact, [f"{p}_item_sk", f"{p}_sold_date_sk",
                            f"{p}_sales_price"])
            f = f.filter(pc.is_valid(f[f"{p}_item_sk"]))
            g = join(f, d, f"{p}_sold_date_sk", "d_date_sk").group_by(
                [f"{p}_item_sk", "d_date"]).aggregate(
                [(f"{p}_sales_price", "sum")])
            check(g[f"{p}_sales_price_sum"].null_count == 0,
                  "q51: a NULL daily sum")
            item = g[f"{p}_item_sk"].to_numpy()
            days = g["d_date"].cast(pa.int32()).to_numpy().astype(np.int64)
            val = g[f"{p}_sales_price_sum"].to_numpy()
            key = item * span + days
            order = np.argsort(key, kind="stable")
            key, item, val = key[order], item[order], val[order]
            cuts = np.flatnonzero(item[1:] != item[:-1]) + 1
            cum = np.concatenate([np.cumsum(c) for c in np.split(val, cuts)]) \
                if len(val) else val
            return key, cum

        kw, cw = cumulative("web_sales", "ws")
        ks, cs = cumulative("store_sales", "ss")
        keys = np.union1d(kw, ks)
        web = np.full(len(keys), np.nan)
        store = np.full(len(keys), np.nan)
        web[np.searchsorted(keys, kw)] = cw
        store[np.searchsorted(keys, ks)] = cs
        item = keys // span
        cuts = np.flatnonzero(item[1:] != item[:-1]) + 1

        def running_max(v):
            return np.concatenate([np.fmax.accumulate(c)
                                   for c in np.split(v, cuts)]) \
                if len(v) else v
        wmax, smax = running_max(web), running_max(store)
        keep = np.flatnonzero(wmax > smax)
        epoch = datetime.date(1970, 1, 1)

        def val(x):
            return None if np.isnan(x) else float(x)
        out["q51"] = [(int(item[i]),
                       epoch + datetime.timedelta(days=int(keys[i] % span)),
                       val(web[i]), val(store[i]), val(wmax[i]),
                       val(smax[i])) for i in keep]
    return out


#: each query's plan at SF10's row estimates: its limit, sort, aggregate,
#: join and window operators, top down, a window as ``TpuWindow<hash>``
#: (a hash exchange on its PARTITION BY keys below it) or
#: ``TpuWindow<coalesce>`` (no PARTITION BY, or two specs of different
#: keys: one stream)
_WH, _WC = "TpuWindow<hash>", "TpuWindow<coalesce>"
_BRL = [_BR, _BR, _BL]                    # the item, date and store stars
DS11_PLANS = {
    "q12": _LS + [_WH] + _AGG + [_BR, _BR],
    "q20": _LS + [_WH] + _AGG + [_BR, _BR],
    "q98": _LS + [_WH] + _AGG + [_BR, _BR],
    "q44": _LS + [_BR, _BR, _SR] + ([_WC] + _AGG) * 2,
    "q47": _LS + [_WC] + _AGG + _BRL,
    "q57": _LS + [_WC] + _AGG + _BRL,
    "q51": _LS + [_WH, "TpuShuffledHashJoin[full, build=right]"] +
           ([_WH] + _AGG + [_BR]) * 2,
    "q53": _LS + [_WH] + _AGG + _BRL,
    "q63": _LS + [_WH] + _AGG + _BRL,
    "q89": _LS + [_WH] + _AGG + _BRL}


def window_plan_signature(explain: str) -> list:
    """``plan_signature`` with each window, and what is below it."""
    lines = [ln.strip() for ln in explain.splitlines()]
    out = []
    for i, ln in enumerate(lines):
        if ln.startswith("TpuWindow"):
            below = lines[i + 1] if i + 1 < len(lines) else ""
            kind = "hash" if below.startswith(
                "TpuShuffleExchange[HashPartitioner") else \
                "coalesce" if below.startswith("TpuCoalescePartitions") \
                else "none"
            out.append(f"TpuWindow<{kind}>")
        elif (m := _PLAN_OP.match(ln)):
            out.append(m.group(1))
    return out


def tpcds11_phase(args, kernels_used, data_dir: str, session) -> dict:
    """Phase 11: the verbatim text of the 10 TPC-DS queries with window
    functions (DS11_QUERIES: revenue shares of an item class, month and
    quarter outliers against a partition's mean, ranks and running
    totals) through the port's ``session.sql`` on phase 7's tables,
    directory and session.  Each must plan DS11_PLANS' operators at SF10
    (each window over a hash exchange on its PARTITION BY keys, or a
    coalesce), equal ``ds11_references`` (1e-9, ORDER BY kept, ties as a
    multiset, also at the LIMIT's cut), give the same bytes on two warm
    runs, and return rows unless DS11_EMPTY names it.  A run is
    ``session.sql(text).to_arrow()`` (``SqlRun``), as in phases 9 and
    10; below SF10 the broadcast threshold shrinks with the scale.  q51
    (two running sums, a full outer join, two running maxima) runs once
    more under the profiler.  Returns the kernels' launches on this
    path."""
    from tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.io.scan_cache import DeviceScanCache
    from spark_rapids_tpu_torch.kernels import cuda_ops
    from spark_rapids_tpu_torch.plan import overrides
    on_card = args.device == "cuda"

    t0 = time.perf_counter()
    refs = ds11_references(data_dir)
    print(f"tpcds11: pyarrow references in {time.perf_counter() - t0:.1f}s")
    rows = {t: max(int(n * args.ds_sf), 64) for t, n in
            {**DS_ROWS_PER_SF, **DS7_ROWS_PER_SF}.items()}
    cache = DeviceScanCache.get()
    launches = {k: 0 for k in cuda_ops.LAUNCHES}
    threshold = overrides.BROADCAST_ROW_THRESHOLD
    overrides.BROADCAST_ROW_THRESHOLD = max(
        1, int(threshold * min(args.ds_sf, 10.0) / 10.0))
    try:
        for q in DS11_QUERIES:
            tq = time.perf_counter()
            check("spark_rapids_tpu" not in sys.modules and
                  "jax" not in sys.modules,
                  "phase 11 imported JAX or the JAX package")
            plan = session.sql(QUERIES[q]).explain()
            check(window_plan_signature(plan) == DS11_PLANS[q] or
                  args.ds_sf < 10, f"{q}: not the planned operators:\n{plan}")
            run = SqlRun(session, QUERIES[q], on_card)
            cold, cold_s, read_s, upload_s, warm, warm_s, peak = \
                cold_and_warm(session, run, on_card)
            for name, v in cuda_ops.LAUNCHES.items():
                launches[name] += v
            order = DS11_ORDER[q]
            full = check_rows(q, cold, refs[q], order)
            for t in warm:
                check_rows(q, t, refs[q], order)
            check(same_bytes(warm[0], warm[1]),
                  f"{q}: the two warm runs are not byte-identical")
            check(cold.num_rows > 0 or q in DS11_EMPTY or args.ds_sf < 10,
                  f"{q}: no rows (not in DS11_EMPTY)")
            fact = rows[DS11_FACT[q]]
            got = cuda_ops.LAUNCHES
            lower = run.lower_s
            print(f"{q}: {cold.num_rows} rows of {full}; cold {cold_s:.4f}s "
                  f"(lowering and its subqueries {lower[0]:.4f}s; host "
                  f"read {read_s:.4f}s, upload {upload_s:.4f}s); warm "
                  f"{warm_s[0]:.4f}s {warm_s[1]:.4f}s (lowering "
                  f"{lower[2]:.4f}s); warm {fact / warm_s[1] / 1e6:.3f} "
                  f"Mrows/s of {DS11_FACT[q]}; peak device memory {peak} B; "
                  f"launches (3 runs) B1 {got['hash_partition_ids']}, B2 "
                  f"{got['table_reduce']}, probe {got['join_probe']}; "
                  f"byte-identical warm runs; matches pyarrow at "
                  f"{EXACT_REL}; first rows {cold.slice(0, 2).to_pylist()}; "
                  f"{time.perf_counter() - tq:.1f}s with the plan and checks",
                  flush=True)
        print("plan q51:\n" + session.sql(QUERIES["q51"]).explain())
        if on_card:
            tq = time.perf_counter()
            before = dict(cuda_ops.LAUNCHES)
            print("profile q51:")
            profile_query(session.sql(QUERIES["q51"]))
            print("profile q51: kernel launches " + str(
                {k: v - before[k] for k, v in cuda_ops.LAUNCHES.items()}) +
                f"; {time.perf_counter() - tq:.1f}s with the trace's "
                f"processing", flush=True)
    finally:
        overrides.BROADCAST_ROW_THRESHOLD = threshold
        cache.clear()
    for name in kernels_used:
        check(launches.get(name, 0) > 0,
              f"{name} never launched on the phase 11 path")
    print(f"tpcds11: launches of the phase (3 runs of each query) {launches}")
    return launches


def ds_tables_alone(args, data_dir: str):
    """Phases 6 and 7's tables under ``data_dir`` and phase 6's session
    over them, without their queries (``--only 11``)."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmarks"))
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.config import TpuConf
    t0 = time.perf_counter()
    make_tpcds(data_dir, args.ds_sf, args.seed)
    make_tpcds7(data_dir, args.ds_sf, args.seed)
    print(f"tpcds data: sf {args.ds_sf}, written in "
          f"{time.perf_counter() - t0:.1f}s")
    session = TpuSession(TpuConf({"spark.rapids.tpu.sql.batchSizeRows":
                                  DS_BATCH_ROWS}), device=args.device)
    for t in DS_TABLES + DS7_TABLES:
        session.read.parquet(os.path.join(data_dir, f"{t}.parquet")) \
            .create_or_replace_temp_view(t)
    return session


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=64_000_000)
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of phase 5's tables")
    ap.add_argument("--ds-sf", type=float, default=10.0,
                    help="TPC-DS scale factor of phase 6's tables")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: also time its "
                         "kernels at the raw-row and probe shapes with "
                         "this timer")
    ap.add_argument("--only", type=int, choices=(11,), default=None,
                    help="after the build, run this phase alone on "
                         "freshly written tables (no contract line)")
    args = ap.parse_args(argv)
    start = time.perf_counter()

    def phase_done(name):
        print(f"phase {name} done at {time.perf_counter() - start:.1f}s",
              flush=True)

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
                if any(w in line for w in ("registers", "Compiling entry",
                                           "spill")):
                    print(f"  {name}: {line.strip()}")

        if args.only is None:
            # 3. kernels against their plain versions
            kernels = kernel_phase(np.random.default_rng(args.seed),
                                   args.parent)
            phase_done("3")

    if args.only == 11:
        used = ["hash_partition_ids", "join_probe"] \
            if args.device == "cuda" else []
        with tempfile.TemporaryDirectory(prefix="tpcds_") as data_dir:
            session = ds_tables_alone(args, data_dir)
            phase_done("tables")
            tpcds11_phase(args, used, data_dir, session)
            phase_done("11")
            session = None
        print("phase 11 alone: no contract result")
        return 0

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

    phase_done("4")

    # 5. shuffled joins at TPC-H scale
    results["join"] = join_phase(
        args, list(kernels) if args.device == "cuda" else [])

    # 6. the TPC-DS quartet through session.sql over Parquet; 7. the flat
    # TPC-DS queries, 8. those with derived tables and CTEs, 9. those with
    # expression subqueries, 10. those with set operations, DISTINCT and
    # DATE columns, 11. those with window functions, on the same tables,
    # session and directory
    used = ["hash_partition_ids", "join_probe"] \
        if args.device == "cuda" else []
    with tempfile.TemporaryDirectory(prefix="tpcds_") as data_dir:
        phase_done("5")
        results["tpcds"], session = tpcds_phase(args, used, data_dir)
        phase_done("6")
        results["tpcds7"] = tpcds7_phase(args, used, data_dir, session)
        phase_done("7")
        results["tpcds8"] = tpcds8_phase(args, used, data_dir, session)
        phase_done("8")
        results["tpcds9"] = tpcds9_phase(args, used, data_dir, session)
        phase_done("9")
        results["tpcds10"] = tpcds10_phase(args, used, data_dir, session)
        phase_done("10")
        results["tpcds11"] = tpcds11_phase(args, used, data_dir, session)
        phase_done("11")
        session = None

    if args.device != "cuda":
        print("cpu rehearsal: no device result")
        return 0
    for name in kernels:
        by_path = {mode: results[mode][name] for mode in results}
        for mode, got in by_path.items():
            # phases 6-11 need not take B2: their string keys, keyless
            # aggregates and wide key ranges run the sort path
            check(got > 0 or (mode in ("tpcds", "tpcds7", "tpcds8",
                                       "tpcds9", "tpcds10", "tpcds11") and
                              name == "table_reduce"),
                  f"{name} never launched on the {mode} path")
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
