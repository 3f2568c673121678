"""Parquet files on the host: path expansion, partition assignment and
the reader of one scan's files.

Counterpart of ``spark_rapids_tpu/io/readers.py`` (Parquet only, no
Hive-style partition directories).  pyarrow reads each file with the
scan's columns alone and with its pushed filters, which prune row
groups by their statistics and rows on the host; the filter above the
scan still runs on the device.
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import List, Optional

import pyarrow as pa
import pyarrow.parquet as papq

from ..columnar.arrow import schema_from_arrow
from ..columnar.schema import Schema

#: host threads reading one scan's files
READ_THREADS = 8


def expand_paths(paths: List[str]) -> List[str]:
    """Files of each path: a file, or a directory of part files (walked
    in name order; names starting with ``_`` or ``.`` are not data)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(("_", ".")))
                if any("=" in d for d in dirs):
                    raise NotImplementedError(
                        f"{p}: partition directories are not ported")
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if not f.startswith(("_", ".")))
        elif os.path.exists(p):
            out.append(p)
        else:
            raise FileNotFoundError(p)
    return out


def infer_schema(paths: List[str]) -> Schema:
    """The first file's schema; columns of a type the port does not carry
    stay in it (``UnsupportedType``) until a plan reads them."""
    files = expand_paths(paths)
    if not files:
        raise FileNotFoundError(f"no files under {paths}")
    return schema_from_arrow(papq.read_schema(files[0]), lenient=True)


def split_files_into_partitions(files: List[str],
                                num_partitions: int) -> List[List[str]]:
    """Greedy size-balanced assignment of files to at most
    ``num_partitions`` partitions (largest file first)."""
    sizes = sorted(((f, os.path.getsize(f)) for f in files),
                   key=lambda x: -x[1])
    n = max(1, min(num_partitions, len(files) or 1))
    buckets: List[List[str]] = [[] for _ in range(n)]
    loads = [0] * n
    for f, size in sizes:
        i = loads.index(min(loads))
        buckets[i].append(f)
        loads[i] += size
    return buckets


class FilePartitionReader:
    """Host arrow tables of a list of files, read with the scan's columns
    and pushed filters by a thread pool that runs ``READ_THREADS`` files
    ahead of the one asked for."""

    def __init__(self, files: List[str], columns: List[str],
                 pushed_filters: Optional[list] = None):
        self.files = files
        self.columns = columns
        self.pushed_filters = pushed_filters
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._futures = {}
        self._submitted = 0

    def read(self, path: str) -> pa.Table:
        return papq.read_table(path, columns=self.columns,
                               filters=self.pushed_filters or None)

    def table(self, i: int) -> pa.Table:
        """File ``i``'s table (each file is asked for once)."""
        ahead = min(len(self.files), i + 1 + READ_THREADS)
        while self._submitted < ahead:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    READ_THREADS)
            self._futures[self._submitted] = self._pool.submit(
                self.read, self.files[self._submitted])
            self._submitted += 1
        if self._submitted == len(self.files) and self._pool is not None:
            # the submitted reads run on; the threads end after them
            self._pool.shutdown(wait=False)
            self._pool = None
        return self._futures.pop(i).result()

    def close(self) -> None:
        """Cancel the reads not started yet."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        self._futures.clear()
