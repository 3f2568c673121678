"""The file scan operator and the filters it pushes into the reader.

Counterpart of ``TpuFileScan`` in ``spark_rapids_tpu/io/planner.py`` and
of ``spark_rapids_tpu/io/pushdown.py`` (Parquet only).  The scan's files
are spread over partitions by size (one file each when there are no
more files than ``shuffle.partitions``); each file's table is cut into
batches of at most ``batchSizeRows`` rows and uploaded once per batch.
Uploaded batches go into the device scan cache (``io/scan_cache.py``).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import torch

from .. import config as C
from ..columnar import dtypes as T
from ..columnar.arrow import from_arrow
from ..exec.tpu_basic import Partitions, TpuExec
from ..expr import core as ec
from ..expr import predicates as ep
from ..plan import logical as L
from .readers import (FilePartitionReader, expand_paths,
                      split_files_into_partitions)
from .scan_cache import DeviceScanCache

_OPS = {ep.EqualTo: "==", ep.LessThan: "<", ep.LessThanOrEqual: "<=",
        ep.GreaterThan: ">", ep.GreaterThanOrEqual: ">="}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _leaf(e: ec.Expression) -> Optional[Tuple[str, str, object]]:
    op = _OPS.get(type(e))
    if op is None:
        return None
    a, b = e.children
    if isinstance(a, ec.Literal):
        a, b, op = b, a, _FLIP[op]
    if not (isinstance(a, ec.AttributeReference) and
            isinstance(b, ec.Literal)) or b.value is None:
        return None
    # floats stay on the device: Spark orders NaN above everything,
    # pyarrow's comparisons do not
    if isinstance(b.value, float) or (a._dtype is not None and
                                      a._dtype.is_fractional):
        return None
    return (a.col_name, op, b.value)


def to_arrow_filters(cond: ec.Expression) -> Optional[List[tuple]]:
    """The conjuncts of ``cond`` that pyarrow can apply, as its filter
    tuples; None if none can."""
    out = []

    def flatten(x):
        if isinstance(x, ep.And):
            flatten(x.children[0])
            flatten(x.children[1])
        else:
            leaf = _leaf(x)
            if leaf is not None:
                out.append(leaf)
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
        self.children = []
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
        key = self.cache_key()
        cache = DeviceScanCache.get()
        parts = cache.lookup(key)
        if parts is not None:
            return parts
        reader = FilePartitionReader(
            [f for part in self.partitions for f in part],
            self.scan.schema.names, self.pushed_filters)
        tables = iter(reader)
        parts = []
        read_s = upload_s = 0.0
        for files in self.partitions:
            batches = []
            for _ in files:
                t0 = time.perf_counter()
                table = next(tables)
                t1 = time.perf_counter()
                for pos in range(0, table.num_rows, self.batch_rows):
                    batches.append(from_arrow(
                        table.slice(pos, self.batch_rows), self.device))
                read_s += t1 - t0
                upload_s += time.perf_counter() - t1
            parts.append(batches)
        self.timings = {"read_s": read_s, "upload_s": upload_s}
        cache.insert(key, parts)
        return parts
