"""Expand: each input row once per projection (grouping sets).

Counterpart of ``spark_rapids_tpu/exec/tpu_expand.py``'s ``TpuExpand``
(Spark's ``GpuExpandExec``): the rows of every input batch once per
projection, projection by projection.  A key outside a set is a NULL
literal of the key's type, so its column has the key's type and no
valid row (a STRING key's offsets stay valid).

The reference yields one batch per projection.  Here the projections of
one input batch of ``n`` rows are one batch of ``sets x n`` rows (its
capacity the bucket of ``sets x n``: one host read of ``n`` per batch),
in the same order: row ``r`` is input row ``r % n`` of set ``r // n``,
one gather of the row indices per column, so the aggregate above runs
once per input batch and not once per set (q67 rolls 8 keys up into 9
sets).
That takes every output column to be, across the projections, one input
column or a NULL (a key, an aggregate input) or an integer literal (the
set id), as ``plan/logical.build_grouping_sets`` makes them; any other
projection raises ``NotImplementedError`` when the operator is planned.
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, bucket_capacity
from ..expr import core as ec
from ..plan.logical import Expand
from .tpu_basic import Partitions, TpuExec


def _stacked_plan(bound: List[List[ec.Expression]]) -> list:
    """Per output column, ("ref", input ordinal, present per set) or
    ("lit", value per set)."""
    plan = []
    for sources in zip(*bound):
        srcs = [e.children[0] if isinstance(e, ec.Alias) else e
                for e in sources]
        ords = {e.ordinal for e in srcs if isinstance(e, ec.BoundReference)}
        nulls = all(isinstance(e, ec.Literal) and e.value is None
                    for e in srcs if not isinstance(e, ec.BoundReference))
        if len(ords) == 1 and nulls:
            plan.append(("ref", ords.pop(), [isinstance(e, ec.BoundReference)
                                             for e in srcs]))
        elif all(isinstance(e, ec.Literal) and isinstance(e.value, int) and
                 not isinstance(e.value, bool) for e in srcs):
            plan.append(("lit", [e.value for e in srcs]))
        else:
            raise NotImplementedError(f"an Expand column of {srcs} is not "
                                      f"supported by the port")
    return plan


class TpuExpand(TpuExec):
    def __init__(self, logical: Expand, child: TpuExec):
        self.logical = logical
        self.children = [child]
        self.plan = _stacked_plan([[e.bind(child.output_schema)
                                    for e in proj]
                                   for proj in logical.projections])

    @property
    def output_schema(self):
        return self.logical.schema

    def _node_string(self):
        return f"TpuExpand[{len(self.logical.projections)} projections]"

    def execute(self) -> Partitions:
        luts = {}           # per device: each column's table over the sets
        return [map(lambda b: self._stacked(b, luts), part)
                for part in self.children[0].execute()]

    def _stacked(self, b: ColumnarBatch, luts) -> ColumnarBatch:
        """The projections of ``b`` as one batch, set after set."""
        sets = len(self.logical.projections)
        dev = b.device
        if dev not in luts:
            luts[dev] = [torch.tensor(step[2] if step[0] == "ref" else
                                      step[1], device=dev,
                                      dtype=torch.bool if step[0] == "ref"
                                      else f.dtype.torch_dtype)
                         for f, step in zip(self.output_schema, self.plan)]
        # the live rows, read once: the stack's capacity fits them, where
        # sets x the batch's padded capacity would double its size
        n = b.num_rows
        r = torch.arange(bucket_capacity(sets * n), device=dev)
        p = torch.div(r, max(n, 1), rounding_mode="floor").clamp(
            max=sets - 1)
        i = r - p * max(n, 1)
        live = r < sets * n
        cols = []
        for f, step, lut in zip(self.output_schema, self.plan, luts[dev]):
            if step[0] == "ref":
                cols.append(b.columns[step[1]].gather(i, live & lut[p]))
            else:
                cols.append(Column(f.dtype, lut[p], live))
        return ColumnarBatch(self.output_schema, cols, sets * n, device=dev)
