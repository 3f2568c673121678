"""Sort and top-N: each partition's rows in the order of its sort keys.

Counterpart of ``TpuSort`` and ``TpuTopN`` in
``spark_rapids_tpu/exec/tpu_sort.py``.  A partition's batches are
concatenated, their order words built (``canon.batch_key_words``:
inverted for descending keys, with each key's null rank) and sorted by
chained stable ``torch.sort`` passes (``kernels/sort.sort_permutation``);
equal rows keep their input order.  Under a range exchange, partition i
holds rows that sort before those of partition i + 1, so the partitions
in order are the global order.  ``TpuTopN`` (a limit right over a global
sort) needs no exchange: each partition keeps its first ``n`` sorted
rows, and one final sort of those picks the first ``n`` of all.
"""
from __future__ import annotations

from ..columnar.batch import ColumnarBatch, concat_batches
from ..expr import core as ec
from ..kernels import canon
from ..kernels.sort import sort_permutation
from .tpu_basic import Partitions, TpuExec


def sort_batch(batch: ColumnarBatch, exprs, orders) -> ColumnarBatch:
    """The batch's live rows in the order of ``orders`` (``exprs`` are
    their bound keys); reads the row count."""
    cols = [ec.eval_as_column(e, batch) for e in exprs]
    words = canon.batch_key_words(
        cols, batch.live_mask(),
        descending=[not o.ascending for o in orders],
        nulls_last=[not o.nulls_first for o in orders])
    return batch.gather(sort_permutation(words), batch.num_rows)


class TpuSort(TpuExec):
    def __init__(self, orders, child: TpuExec):
        self.orders = orders
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def execute(self) -> Partitions:
        schema = self.children[0].output_schema
        exprs = [o.expr.bind(schema) for o in self.orders]
        out = []
        for part in self.children[0].execute():
            batches = [b for b in part if b.num_rows > 0]
            if not batches:
                out.append([])
                continue
            out.append([sort_batch(concat_batches(batches), exprs,
                                   self.orders)])
        return out


class TpuTopN(TpuExec):
    """The first ``n`` rows of a global sort, in one partition: a sort
    and slice per partition, then one sort of the survivors."""

    def __init__(self, n: int, orders, child: TpuExec):
        self.n = n
        self.orders = orders
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def _node_string(self):
        return f"TpuTopN[{self.n}]"

    def _top(self, batches, exprs) -> ColumnarBatch:
        s = sort_batch(concat_batches(batches), exprs, self.orders)
        return s.slice(0, self.n) if s.num_rows > self.n else s

    def execute(self) -> Partitions:
        schema = self.children[0].output_schema
        exprs = [o.expr.bind(schema) for o in self.orders]
        tops = []
        for part in self.children[0].execute():
            batches = [b for b in part if b.num_rows > 0]
            if batches and self.n > 0:
                tops.append(self._top(batches, exprs))
        return [[self._top(tops, exprs)] if tops else []]
