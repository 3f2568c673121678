"""Scan, project, filter, limit and union operators.

Counterpart of ``spark_rapids_tpu/exec/tpu_basic.py``.  An operator's
``execute()`` returns its partitions, each a lazy iterator of device
batches (the reference's contract, ``exec/base.py``): a batch is made
when its consumer asks for it, so a partition's batches need not all be
on the device at once.  A partition is read once.  ``close()`` lets go
of what partitions that were not read to their end still hold (shuffle
blocks, sorted runs); the collect calls it on the plan's root.
"""
from __future__ import annotations

import functools
from typing import Iterator, List

import torch

from ..columnar.arrow import from_arrow
from ..columnar.batch import ColumnarBatch
from ..columnar.schema import Field, Schema
from ..expr import core as ec
from ..expr.cast import Cast, can_widen
from ..expr.misc import TaskContext, needs_task
from ..kernels.basic import compact_indices

Partitions = List[Iterator[ColumnarBatch]]


class TpuExec:
    children: List["TpuExec"] = []

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError

    def execute(self) -> Partitions:
        raise NotImplementedError

    def close(self) -> None:
        """Release what the last ``execute()``'s partitions still hold
        in the catalog, here and below."""
        for c in self.children:
            c.close()

    def num_partitions(self) -> int:
        """Partitions ``execute()`` returns (the planner's count)."""
        return self.children[0].num_partitions() if self.children else 1

    def _node_string(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self._node_string()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)


class MaskedBatch:
    """Columns over a batch's capacity where a ``live`` mask, not the row
    count, says which rows exist: filters fold into the mask instead of
    compacting (the whole-stage form the aggregate cores consume)."""

    def __init__(self, schema: Schema, columns, capacity: int, device):
        self.schema = schema
        self.columns = columns
        self.capacity = capacity
        self.device = device


def apply_ops_masked(pre_ops, batch: ColumnarBatch, live: torch.Tensor):
    """Run a filter/project chain on ``batch``: projects evaluate, filters
    clear ``live``.  Returns (masked batch, live)."""
    b = MaskedBatch(batch.schema, batch.columns, batch.capacity, batch.device)
    for kind, payload, out_schema in pre_ops or ():
        if kind == "filter":
            pred = ec.eval_as_column(payload, b)
            live = live & pred.data.to(torch.bool) & pred.validity
        else:
            cols = [ec.eval_as_column(e, b) for e in payload]
            b = MaskedBatch(out_schema, cols, b.capacity, b.device)
    return b, live


def task_batches(parts: Partitions, exprs) -> Partitions:
    """``parts`` as they are, or, where an expression of ``exprs`` reads
    its task (``expr/misc``), each batch as a view that carries its
    ``TaskContext``: the partition's index and the rows before it."""
    if not any(needs_task(e) for e in exprs):
        return parts
    return [_task_views(pi, part) for pi, part in enumerate(parts)]


def _task_views(pi: int, part):
    start = 0
    for b in part:
        v = ColumnarBatch(b.schema, b.columns, b.rows, device=b.device)
        v.task_context = TaskContext(pi, start)
        start = start + b.rows
        yield v


class TpuLocalScan(TpuExec):
    """Uploads an arrow table as ``num_partitions`` contiguous partitions
    of batches of at most ``batch_rows`` rows, batch by batch, once per
    relation (a partition read to its end is kept on the relation)."""

    def __init__(self, relation, batch_rows: int, device: torch.device):
        self.relation = relation
        self.batch_rows = batch_rows
        self.device = device
        self.children = []

    @property
    def output_schema(self):
        return self.relation.schema

    def _node_string(self):
        return f"TpuLocalScan[{self.relation.num_partitions} partitions]"

    def num_partitions(self) -> int:
        return self.relation.num_partitions

    def execute(self) -> Partitions:
        key = (str(self.device), self.batch_rows)
        done = self.relation.device_cache.setdefault(
            key, [None] * self.relation.num_partitions)
        return [self._partition(done, i) for i in range(len(done))]

    def _partition(self, done, i: int):
        if done[i] is not None:
            yield from done[i]
            return
        table = self.relation.table
        n = table.num_rows
        per = -(-n // len(done)) if n else 0
        lo = min(i * per, n)
        hi = min(lo + per, n)
        batches = []
        for pos in range(lo, hi, self.batch_rows):
            b = from_arrow(table.slice(pos, min(self.batch_rows, hi - pos)),
                           self.device)
            batches.append(b)
            yield b
        done[i] = batches


class TpuProject(TpuExec):
    def __init__(self, exprs: List[ec.Expression], child: TpuExec):
        self.exprs = exprs
        self.children = [child]

    def _node_string(self):
        names = ", ".join(ec.output_name(e) for e in self.exprs)
        return f"TpuProject[{names}]"

    @property
    def output_schema(self):
        return Schema(Field(ec.output_name(e), e.dtype(), e.nullable)
                      for e in self.exprs)

    def execute(self) -> Partitions:
        in_schema = self.children[0].output_schema
        bound = [e.bind(in_schema) for e in self.exprs]
        out_schema = self.output_schema

        def project(b):
            return ColumnarBatch(out_schema,
                                 [ec.eval_as_column(e, b) for e in bound],
                                 b.rows, device=b.device)
        return [map(project, part) for part in
                task_batches(self.children[0].execute(), bound)]


class TpuFilter(TpuExec):
    """Keeps rows whose condition is true (null counts as false), moving
    them to the front in order."""

    def __init__(self, condition: ec.Expression, child: TpuExec):
        self.condition = condition
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def _node_string(self):
        return f"TpuFilter[{self.condition!r}]"

    def execute(self) -> Partitions:
        bound = self.condition.bind(self.children[0].output_schema)

        def keep_rows(b):
            pred = ec.eval_as_column(bound, b)
            keep = pred.data.to(torch.bool) & pred.validity
            order, count = compact_indices(keep, b.rows_dev)
            return b.gather(order, count)
        return [map(keep_rows, part) for part in
                task_batches(self.children[0].execute(), [bound])]


def _take_rows(batches, n: int):
    """The first ``n`` rows of the batches in order (reads each batch's
    row count, and stops pulling once they are found)."""
    if n <= 0:
        return
    for b in batches:
        k = min(b.num_rows, n)
        yield b if k == b.num_rows else b.slice(0, k)
        n -= k
        if n <= 0:
            return


class TpuLocalLimit(TpuExec):
    """The first ``n`` rows of each partition."""

    def __init__(self, n: int, child: TpuExec):
        self.n = n
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def _node_string(self):
        return f"TpuLocalLimit[{self.n}]"

    def execute(self) -> Partitions:
        return [_take_rows(part, self.n)
                for part in self.children[0].execute()]


class TpuGlobalLimit(TpuExec):
    """The first ``n`` rows of a one-partition child."""

    def __init__(self, n: int, child: TpuExec):
        self.n = n
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def _node_string(self):
        return f"TpuGlobalLimit[{self.n}]"

    def execute(self) -> Partitions:
        parts = self.children[0].execute()
        if len(parts) != 1:
            raise ValueError(f"a global limit needs one partition, got "
                             f"{len(parts)}")
        return [_take_rows(parts[0], self.n)]


class TpuUnion(TpuExec):
    """UNION ALL: every child's partitions in turn, each batch relabelled
    with the union's schema; a column whose type is narrower than the
    union's (``plan/logical.union_types``) is widened (``expr/cast``),
    where the reference's ``_align_schema`` casts to the first child's
    type."""

    def __init__(self, schema: Schema, children: List[TpuExec]):
        for c in children:
            types = [f.dtype for f in c.output_schema]
            if len(types) != len(schema) or not all(
                    can_widen(t, f.dtype) for t, f in zip(types, schema)):
                raise ValueError(f"a union child of column types {types} "
                                 f"under a union of {schema}")
        self.schema = schema
        self.children = list(children)

    @property
    def output_schema(self):
        return self.schema

    def num_partitions(self) -> int:
        return sum(c.num_partitions() for c in self.children)

    def _widen(self, child: TpuExec):
        """Per column, the cast to the union's type (None: same type)."""
        return [None if f.dtype == u.dtype else
                Cast(ec.BoundReference(i, f.dtype, f.nullable), u.dtype)
                for i, (f, u) in enumerate(zip(child.output_schema,
                                               self.schema))]

    def _relabel(self, casts, b: ColumnarBatch) -> ColumnarBatch:
        return ColumnarBatch(self.schema, [
            col if e is None else ec.eval_as_column(e, b)
            for col, e in zip(b.columns, casts)], b.rows, device=b.device)

    def execute(self) -> Partitions:
        out = []
        for c in self.children:
            relabel = functools.partial(self._relabel, self._widen(c))
            out.extend(map(relabel, part) for part in c.execute())
        return out
