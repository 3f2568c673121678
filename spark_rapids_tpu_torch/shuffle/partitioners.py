"""Hash and range partitioners: partition ids on the device, then a
contiguous split.

Counterpart of ``spark_rapids_tpu/shuffle/partitioners.py``.  The hash
split hashes the keys' canonical words (a null key hashes a fixed word)
and orders the rows by partition id in one ``hash_split`` call, a
counting sort on the card; the per-partition counts are read to the host
once per batch to cut the slices.

A string key hashes ``strings.partition_words`` (its own words folded
into one, and its length), not its key words: those are as wide as the
batch's longest string, so the reference's id of one string changes with
the batch it arrives in and one key can land in several partitions.

The range partitioner (global sort) picks its bounds from all its input
rows' order words, sorted on the device, and places each row by
comparing it with the bounds on the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.batch import ColumnarBatch
from ..expr import core as ec
from ..columnar.column import StringColumn
from ..kernels import canon, strings
from ..kernels.basic import as_signed64
from ..kernels.cuda_ops import hash_split
from ..kernels.sort import sort_permutation

#: word hashed for a null key
NULL_WORD = as_signed64(0x9E3779B97F4A7C15)


@dataclasses.dataclass
class SplitBatch:
    """A batch sorted by partition id + per-partition row offsets, and,
    where the split was asked for them, the string bytes of each
    partition's rows (summed over the string columns)."""
    batch: ColumnarBatch
    offsets: np.ndarray          # [num_parts + 1] host row offsets
    string_bytes: Optional[np.ndarray] = None    # [num_parts] host bytes

    def partition_slice(self, pid: int) -> Optional[ColumnarBatch]:
        lo, hi = int(self.offsets[pid]), int(self.offsets[pid + 1])
        if hi <= lo:
            return None
        return self.batch.slice(lo, hi - lo)

    def slice_bytes(self, pid: int, piece: ColumnarBatch) -> int:
        """Bytes of the rows of ``piece`` (partition ``pid``'s slice):
        each value and validity byte, and a string's offsets and its own
        bytes (a string slice shares the byte buffer of the whole split
        batch).  Capacity padding does not count: each slice is padded
        to a power of two, which would hide part of a skewed partition's
        excess over the others.  Needs the split's ``string_bytes`` when
        the batch holds a string column."""
        n = piece.num_rows
        own = 0 if self.string_bytes is None else int(self.string_bytes[pid])
        for c in piece.columns:
            own += n + (4 * (n + 1) if isinstance(c, StringColumn)
                        else n * c.data.element_size())
        return own


def _split_by(batch: ColumnarBatch, perm: torch.Tensor, counts,
              n: int, string_bytes: bool = False) -> SplitBatch:
    """The split of ``batch`` by ``perm`` (rows in partition order) and
    the partitions' row counts.  With ``string_bytes``, each string
    column's bytes per partition come to the host in the counts' one
    read."""
    counts = counts[:n].to(torch.int64)
    host = [counts]
    strs = [c for c in batch.columns if isinstance(c, StringColumn)] \
        if string_bytes else []
    if strs:
        ends = torch.cumsum(counts, 0)
        for c in strs:
            lens = (c.offsets[1:] - c.offsets[:-1]).to(torch.int64)[perm]
            acc = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
            host.append(acc[ends] - acc[ends - counts])
    host = torch.stack(host).cpu().numpy()
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(host[0])
    return SplitBatch(batch.gather(perm, int(offsets[-1])), offsets,
                      host[1:].sum(axis=0) if string_bytes else None)


class HashPartitioner:
    """murmur-style hash of the key columns mod n."""

    def __init__(self, key_exprs: List[ec.Expression], num_partitions: int):
        self.key_exprs = key_exprs
        self.num_partitions = num_partitions

    def __repr__(self):
        return f"HashPartitioner({self.num_partitions})"

    def _key_words(self, batch: ColumnarBatch) -> List[torch.Tensor]:
        words = []
        for e in self.key_exprs:
            col = ec.eval_as_column(e.bind(batch.schema), batch)
            vw = strings.partition_words(col) \
                if isinstance(col, StringColumn) else canon.value_words(col)
            for w in vw:
                words.append(torch.where(col.validity, w, NULL_WORD)
                             .contiguous())
        return words

    def split(self, batch: ColumnarBatch,
              string_bytes: bool = False) -> SplitBatch:
        """Rows stably ordered by partition id (dead rows last) and the
        host offsets of each partition's rows; with ``string_bytes``, also
        each partition's string bytes (``SplitBatch.slice_bytes``)."""
        n = self.num_partitions
        perm, counts = hash_split(self._key_words(batch),
                                  batch.live_mask().contiguous(), n)
        return _split_by(batch, perm, counts, n, string_bytes)


class RangePartitioner:
    """Sample-free range partitioning for a global sort: ``fit`` sorts the
    order words of every input row (one stable sort on the device) and
    takes n - 1 bound rows at even quantiles; a row's partition is the
    number of bounds at or below it.  String keys take one width over
    every batch, so bounds and rows compare."""

    def __init__(self, orders, num_partitions: int):
        self.orders = orders
        self.num_partitions = num_partitions
        self.bound_words: Optional[List[torch.Tensor]] = None
        self.str_words: Optional[List[Optional[int]]] = None

    def __repr__(self):
        return f"RangePartitioner({self.num_partitions})"

    def key_columns(self, batch: ColumnarBatch):
        """The batch's sort key columns (what ``fit`` needs of it)."""
        return [ec.eval_as_column(o.expr.bind(batch.schema), batch)
                for o in self.orders]

    def _order_words(self, cols, live: torch.Tensor):
        return canon.batch_key_words(
            cols, live, descending=[not o.ascending for o in self.orders],
            nulls_last=[not o.nulls_first for o in self.orders],
            str_words=self.str_words)

    def fit(self, keys: Sequence[Tuple[list, int]]) -> None:
        """Bounds over every input row; ``keys`` holds each input batch's
        ``key_columns`` and its row count."""
        self.str_words = canon.common_str_words([c for c, _ in keys]) \
            if keys else None
        rows = sum(n for _, n in keys)
        if rows == 0:
            self.bound_words = None
            return
        acc = []
        for cols, n in keys:
            live = torch.arange(cols[0].capacity,
                                device=cols[0].device) < n
            acc.append([w[:n] for w in self._order_words(cols, live)])
        merged = [torch.cat([a[i] for a in acc])
                  for i in range(len(acc[0]))]
        del acc
        qpos = [min(int(rows * (i + 1) / self.num_partitions), rows - 1)
                for i in range(self.num_partitions - 1)]
        pick = sort_permutation(merged)[
            torch.tensor(qpos, dtype=torch.int64, device=merged[0].device)]
        self.bound_words = [m[pick] for m in merged]

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        cap = batch.capacity
        pid = torch.zeros(cap, dtype=torch.int64, device=batch.device)
        if self.bound_words is None:
            return pid
        words = self._order_words(self.key_columns(batch),
                                  batch.live_mask())
        rows = torch.arange(cap, device=batch.device)
        for bi in range(self.num_partitions - 1):
            bidx = torch.full((cap,), bi, dtype=torch.int64,
                              device=batch.device)
            # a row at or past bound bi goes to a later partition
            pid += (~canon.words_less(words, rows, self.bound_words,
                                      bidx)).to(torch.int64)
        return pid.clamp(max=self.num_partitions - 1)

    def split(self, batch: ColumnarBatch) -> SplitBatch:
        n = self.num_partitions
        key = torch.where(batch.live_mask(), self.partition_ids(batch), n)
        _, perm = torch.sort(key, stable=True)
        return _split_by(batch, perm, torch.bincount(key, minlength=n + 1),
                         n)
