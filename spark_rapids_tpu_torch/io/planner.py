"""The file scan operator and the filters it pushes into the reader.

Counterpart of ``TpuFileScan`` in ``spark_rapids_tpu/io/planner.py`` and
of ``spark_rapids_tpu/io/pushdown.py`` (Parquet only).  A comparison of a
DECIMAL column with a number pushes down as ``Decimal`` bounds of the
column's type (``_decimal_leaves``).  The scan's files
are spread over partitions by size (one file each when there are no
more files than ``shuffle.partitions``); each file's table is cut into
batches of at most ``batchSizeRows`` rows and uploaded once per batch,
as the partition is read.  With ``io.deviceScanCache.enabled`` the
scan's batches go into the device scan cache (``io/scan_cache.py``) once
every partition has been read to its end, unless they exceed
``io.deviceScanCache.bytes``; the cache is looked up when the first
partition is read, so a second scan of the same files in one query finds
the first's batches.  With the cache off a scan streams file by file.
"""
from __future__ import annotations

import decimal
import os
import time
from typing import List, Optional, Tuple

import pyarrow as pa
import torch

from .. import config as C
from ..columnar import dtypes as T
from ..columnar.arrow import from_arrow
from ..exec.tpu_basic import Partitions, TpuExec
from ..expr import core as ec
from ..expr import predicates as ep
from ..kernels import decimal as dk
from ..plan import logical as L
from .readers import (FilePartitionReader, expand_paths,
                      split_files_into_partitions)
from .scan_cache import DeviceScanCache

_OPS = {ep.EqualTo: "==", ep.LessThan: "<", ep.LessThanOrEqual: "<=",
        ep.GreaterThan: ">", ep.GreaterThanOrEqual: ">="}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _decimal_leaves(name: str, dt: T.DecimalType, op: str,
                    value) -> List[Tuple[str, str, object]]:
    """Filters on a DECIMAL column against a number, as pyarrow
    ``Decimal`` scalars of the column's type, which prune row groups by
    their unscaled statistics.  The device compares a float literal as a
    double (``expr/predicates.py``), so a float's bound widens by one
    unit of the last digit: the pushed filter keeps every row the
    device's keeps, and the filter above the scan decides."""
    if isinstance(value, bool) or not isinstance(value, (int, float)) or \
            value != value or value in (float("inf"), float("-inf")):
        return []
    u = T.unscaled_of(value, dt.scale)
    slack = 1 if isinstance(value, float) else 0
    limit = dk.bound(dt.precision)

    def lit(x):
        return pa.scalar(decimal.Decimal(x).scaleb(-dt.scale), dt.arrow_type)
    bounds = {">": [(">=", u - slack)] if slack else [(">", u)],
              ">=": [(">=", u - slack)],
              "<": [("<=", u + slack)] if slack else [("<", u)],
              "<=": [("<=", u + slack)],
              "==": [(">=", u - slack), ("<=", u + slack)]}[op]
    return [(name, o, lit(x)) for o, x in bounds if -limit <= x <= limit]


def _leaf(e: ec.Expression) -> List[Tuple[str, str, object]]:
    op = _OPS.get(type(e))
    if op is None:
        return []
    a, b = e.children
    if isinstance(a, ec.Literal):
        a, b, op = b, a, _FLIP[op]
    if not (isinstance(a, ec.AttributeReference) and
            isinstance(b, ec.Literal)) or b.value is None:
        return []
    if a._dtype is not None and a._dtype.is_decimal:
        return _decimal_leaves(a.col_name, a._dtype, op, b.value)
    # floats stay on the device: Spark orders NaN above everything,
    # pyarrow's comparisons do not
    if isinstance(b.value, float) or (a._dtype is not None and
                                      a._dtype.is_fractional):
        return []
    return [(a.col_name, op, b.value)]


def to_arrow_filters(cond: ec.Expression) -> Optional[List[tuple]]:
    """The conjuncts of ``cond`` that pyarrow can apply, as its filter
    tuples; None if none can."""
    out = []

    def flatten(x):
        if isinstance(x, ep.And):
            flatten(x.children[0])
            flatten(x.children[1])
        else:
            out.extend(_leaf(x))
    flatten(cond)
    return out or None


class TpuFileScan(TpuExec):
    def __init__(self, scan: L.Scan, conf: C.TpuConf, device: torch.device,
                 pushed_filters: Optional[List[tuple]] = None):
        bad = [f"{f.name}:{f.dtype.name}" for f in scan.schema
               if isinstance(f.dtype, T.UnsupportedType)]
        if bad:
            raise NotImplementedError(f"the scan reads columns of types the "
                                      f"port does not carry: {bad}")
        self.scan = scan
        self.device = device
        self.batch_rows = conf.get(C.BATCH_SIZE_ROWS)
        self.files = expand_paths(scan.paths)
        self.partitions = split_files_into_partitions(
            self.files, conf.get(C.SHUFFLE_PARTITIONS))
        self.pushed_filters = pushed_filters
        self.cache_enabled = conf.get(C.SCAN_CACHE)
        self.cache_bytes = conf.get(C.SCAN_CACHE_BYTES)
        self.children = []
        self._readers: List[FilePartitionReader] = []
        #: host seconds of the last uncached execute(): waiting for the
        #: files' tables, and uploading them
        self.timings = {"read_s": 0.0, "upload_s": 0.0}

    @property
    def output_schema(self):
        return self.scan.schema

    def num_partitions(self) -> int:
        return len(self.partitions)

    def _node_string(self):
        pushed = f", pushed={self.pushed_filters}" if self.pushed_filters \
            else ""
        return (f"TpuFileScan[parquet, {len(self.files)} files, "
                f"{len(self.partitions)} partitions{pushed}]")

    def cache_key(self) -> tuple:
        files = tuple(tuple((f, os.stat(f).st_mtime_ns, os.stat(f).st_size)
                            for f in part) for part in self.partitions)
        return (str(self.device), files, tuple(self.scan.schema.names),
                repr(self.pushed_filters), self.batch_rows)

    def execute(self) -> Partitions:
        run = _ScanRun(self)
        return [run.partition(i) for i in range(len(self.partitions))]

    def close(self) -> None:
        while self._readers:
            self._readers.pop().close()

    def stream(self, reader: FilePartitionReader, first: int, files):
        """The batches of ``files`` (the reader's files ``first`` on)."""
        for k in range(len(files)):
            t0 = time.perf_counter()
            table = reader.table(first + k)
            self.timings["read_s"] += time.perf_counter() - t0
            for pos in range(0, table.num_rows, self.batch_rows):
                t1 = time.perf_counter()
                b = from_arrow(table.slice(pos, self.batch_rows), self.device)
                self.timings["upload_s"] += time.perf_counter() - t1
                yield b


class _ScanRun:
    """One ``execute()`` of a file scan: a cache hit's batches, or the
    files streamed (and collected for the cache while it is on and they
    fit), decided when the first partition is read."""

    def __init__(self, scan: TpuFileScan):
        self.scan = scan
        self.resolved = False
        self.cached = None
        self.collected = None
        self.bytes = 0
        self.done = [False] * len(scan.partitions)
        self.reader = None

    def _resolve(self):
        self.resolved = True
        scan = self.scan
        if scan.cache_enabled:
            self.key = scan.cache_key()
            self.cached = DeviceScanCache.get().lookup(self.key)
            if self.cached is not None:
                return
            self.collected = [[] for _ in scan.partitions]
        scan.timings = {"read_s": 0.0, "upload_s": 0.0}
        self.reader = FilePartitionReader(
            [f for part in scan.partitions for f in part],
            scan.scan.schema.names, scan.pushed_filters)
        scan._readers.append(self.reader)

    def partition(self, i: int):
        if not self.resolved:
            self._resolve()
        if self.cached is not None:
            yield from self.cached[i]
            return
        first = sum(len(p) for p in self.scan.partitions[:i])
        for b in self.scan.stream(self.reader, first,
                                  self.scan.partitions[i]):
            if self.collected is not None:
                self.bytes += b.nbytes()
                if self.bytes > self.scan.cache_bytes:
                    self.collected = None     # too large to cache
                else:
                    self.collected[i].append(b)
            yield b
        self.done[i] = True
        if all(self.done) and self.collected is not None:
            DeviceScanCache.get().insert(self.key, self.collected,
                                         self.bytes, self.scan.cache_bytes)
            self.collected = None
