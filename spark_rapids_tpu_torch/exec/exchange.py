"""Exchanges: in-process hash and range shuffle, broadcast, coalesce.

Counterpart of ``spark_rapids_tpu/exec/exchange.py`` (in-process only).
"""
from __future__ import annotations

from typing import Optional

from ..columnar.batch import ColumnarBatch, concat_batches
from .tpu_basic import Partitions, TpuExec


class TpuShuffleExchange(TpuExec):
    """Splits every map-side batch by the partitioner; reduce partition i
    receives the i-th slice of each, in map order, concatenated into
    batches of at most ``target_rows`` rows, as a coalesced shuffle read
    does: each map batch would otherwise reach a join as
    ``num_partitions`` small batches, each probed on its own (a join
    over a join's output would probe ``num_partitions^2`` batches per
    map batch)."""

    def __init__(self, partitioner, child: TpuExec, target_rows: int):
        self.partitioner = partitioner
        self.children = [child]
        self.target_rows = target_rows

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def _node_string(self):
        return f"TpuShuffleExchange[{self.partitioner!r}]"

    def num_partitions(self) -> int:
        return self.partitioner.num_partitions

    def execute(self) -> Partitions:
        n = self.partitioner.num_partitions
        out = [[] for _ in range(n)]
        batches = [b for part in self.children[0].execute() for b in part
                   if b.rows_known != 0]
        if hasattr(self.partitioner, "fit"):
            # a range exchange places rows by bounds from all its input
            batches = [b for b in batches if b.num_rows > 0]
            self.partitioner.fit(batches)
        for batch in batches:
            split = self.partitioner.split(batch)
            for pid in range(n):
                s = split.partition_slice(pid)
                if s is not None:
                    out[pid].append(s)
        return [_coalesce(part, self.target_rows) for part in out]


def _coalesce(batches, target_rows: int):
    """Consecutive batches (host row counts known) concatenated while
    they fit ``target_rows``; a larger one stays whole."""
    out, group, rows = [], [], 0
    for b in batches:
        if group and rows + b.num_rows > target_rows:
            out.append(concat_batches(group))
            group, rows = [], 0
        group.append(b)
        rows += b.num_rows
    if group:
        out.append(concat_batches(group))
    return out


class TpuBroadcastExchange(TpuExec):
    """Collects the child into one batch that every consumer shares."""

    def __init__(self, child: TpuExec):
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def broadcast_batch(self) -> Optional[ColumnarBatch]:
        batches = [b for part in self.children[0].execute() for b in part]
        batches = [b for b in batches if b.num_rows > 0]
        if not batches:
            return None
        return concat_batches(batches)

    def execute(self) -> Partitions:
        b = self.broadcast_batch()
        return [[b] if b is not None else []]


class TpuCoalescePartitions(TpuExec):
    """Every partition of the child, in order, as one partition."""

    def __init__(self, child: TpuExec):
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def execute(self) -> Partitions:
        return [[b for part in self.children[0].execute() for b in part]]
