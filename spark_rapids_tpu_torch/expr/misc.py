"""Hashing and id expressions: ``hash``, ``monotonically_increasing_id``
and ``spark_partition_id``.

Counterpart of ``spark_rapids_tpu/expr/misc.py``.  ``Murmur3Hash`` is
the reference's: ``kernels/basic.hash_words`` with seed 42 over each
argument's words, a null row's words replaced by a tag so that
``hash(NULL)`` differs from ``hash(0)``.  A number, BOOL or DATE hashes
its ``canon.value_words``, bit for bit the reference's; a string hashes
``strings.partition_words``, a fold of its own bytes (the reference's
string words depend on the widest string of the batch, so one string
hashed differently in two batches).

The two id expressions read the task that evaluates them
(``TaskContext``: the partition's index and the rows of the partition
before this batch), which ``exec/tpu_basic``'s project and filter set on
each batch; the planner stages no such expression into an aggregate.
The ids are Spark's: ``partition << 33 | row in the partition`` and the
partition's index (the reference has no task context and answers
partition 0, row 0 at every batch's start).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn
from ..kernels import basic, canon, strings
from .core import Expression, eval_as_column

#: the words of a null row (the reference's tag)
NULL_TAG = basic.as_signed64(0x9E3779B97F4A7C15)


class Murmur3Hash(Expression):
    """``hash(cols...)``: a bigint, never null."""

    def __init__(self, *children: Expression, seed: int = 42):
        self.children = list(children)
        self.seed = seed

    def dtype(self):
        return T.INT64

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        word_lists = []
        for ch in self.children:
            col = eval_as_column(ch, batch)
            words = strings.partition_words(col) \
                if isinstance(col, StringColumn) else canon.value_words(col)
            word_lists += [torch.where(col.validity, w, NULL_TAG)
                           for w in words]
        h = basic.hash_words(word_lists, seed=self.seed)
        return Column(T.INT64, h, torch.ones_like(h, dtype=torch.bool))

    def __repr__(self):
        return f"hash({', '.join(map(repr, self.children))})"


@dataclasses.dataclass
class TaskContext:
    """The task a batch is evaluated in: its partition's index and the
    rows of that partition before the batch (a device scalar or an
    int)."""
    partition_id: int
    row_start: Union[int, torch.Tensor] = 0


def needs_task(e: Expression) -> bool:
    """Whether evaluating ``e`` reads the batch's ``TaskContext``."""
    return bool(e.collect(lambda x: isinstance(x, _TaskExpression)))


class _TaskExpression(Expression):
    children = []

    @property
    def nullable(self):
        return False

    @staticmethod
    def _task(batch) -> TaskContext:
        ctx = getattr(batch, "task_context", None)
        if ctx is None:
            raise NotImplementedError(
                f"this operator does not evaluate partition-aware "
                f"expressions (monotonically_increasing_id, "
                f"spark_partition_id)")
        return ctx


class MonotonicallyIncreasingID(_TaskExpression):
    """``partition << 33 | row in the partition`` (Spark's contract)."""

    def dtype(self):
        return T.INT64

    def columnar_eval(self, batch):
        ctx = self._task(batch)
        rows = torch.arange(batch.capacity, dtype=torch.int64,
                            device=batch.device) + ctx.row_start
        ids = (ctx.partition_id << 33) | rows
        return Column(T.INT64, ids, torch.ones_like(ids, dtype=torch.bool))

    def __repr__(self):
        return "monotonically_increasing_id()"


class SparkPartitionID(_TaskExpression):
    def dtype(self):
        return T.INT32

    def columnar_eval(self, batch):
        pid = self._task(batch).partition_id
        data = torch.full((batch.capacity,), pid, dtype=torch.int32,
                          device=batch.device)
        return Column(T.INT32, data, torch.ones_like(data, dtype=torch.bool))

    def __repr__(self):
        return "spark_partition_id()"
