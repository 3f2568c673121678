"""Sort: each partition's rows in the order of its sort keys.

Counterpart of ``TpuSort`` in ``spark_rapids_tpu/exec/tpu_sort.py``.  A
partition's batches are concatenated, their order words built
(``canon.batch_key_words``: inverted for descending keys, with each
key's null rank) and sorted by chained stable ``torch.sort`` passes
(``kernels/sort.sort_permutation``); equal rows keep their input order.
Under a range exchange, partition i holds rows that sort before those of
partition i + 1, so the partitions in order are the global order.
"""
from __future__ import annotations

from ..columnar.batch import concat_batches
from ..expr import core as ec
from ..kernels import canon
from ..kernels.sort import sort_permutation
from .tpu_basic import Partitions, TpuExec


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
            b = concat_batches(batches)
            cols = [ec.eval_as_column(e, b) for e in exprs]
            words = canon.batch_key_words(
                cols, b.live_mask(),
                descending=[not o.ascending for o in self.orders],
                nulls_last=[not o.nulls_first for o in self.orders])
            out.append([b.gather(sort_permutation(words), b.num_rows)])
        return out
