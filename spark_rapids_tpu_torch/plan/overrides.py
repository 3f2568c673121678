"""Planner: logical plan -> device operators.

Plays the role of ``spark_rapids_tpu/plan/overrides.py`` for the port:
- scans are first narrowed to the columns the plan reads
  (``logical_opt.prune_scan_columns``); a filter right over a file scan
  pushes the conjuncts pyarrow can apply into the scan, and still runs;
- a group-by becomes partial aggregate -> hash exchange on the group keys
  -> final aggregate, with the filter/project chain under it staged into
  the partial aggregate; that exchange has ``shuffle.partitions``
  partitions.  An aggregate without keys becomes partial -> coalesce ->
  final (one output row).  Neither is ever planned as one ``complete``
  aggregate, so no plan merges partitions it did not exchange (the
  reference takes an operator's partition count from its first child,
  so a broadcast join built on the left reports one partition and its
  aggregate runs ``complete`` over many: here each operator reports the
  partitions it really returns, ``TpuExec.num_partitions``);
- an equi-join builds on the right side, except a right join; an inner
  join builds on the side with fewer estimated rows.  A build side of at
  most ``BROADCAST_ROW_THRESHOLD`` estimated rows is broadcast, unless
  the join is full; every other join hash-partitions both sides on
  their keys into ``_pick_partitions`` partitions and joins partition by
  partition (``TpuShuffledHashJoin``); an exchange reads each partition
  back as batches of up to ``batchSizeRows`` rows;
- a cross join, or a join without equi-keys, is a ``TpuNestedLoopJoin``
  over a ``TpuBroadcastExchange`` of its right side (every join type; a
  right or full one collapses the left side into one partition);
- a global sort over more than one partition range-partitions its input
  into as many partitions (``RangePartitioner``) and sorts each; a limit
  takes each partition's first rows, coalesces, and takes the first rows
  again.  A limit right over a global sort is one ``TpuTopN`` over the
  sort's input (the reference's rule; SQL text puts its projection
  between the two, so only the DataFrame API's ``sort().limit()``
  reaches it);
- a union is a ``TpuUnion`` of its children's partitions, one after the
  other.  The semi and anti joins of SQL's ``IN (query)`` and ``EXISTS``
  take the broadcast or shuffle choice of every other join, as do those
  of INTERSECT and EXCEPT on their null-safe keys;
- a distinct is the aggregate of every column with no aggregate
  function (the reference's rule): partial, exchange on all columns,
  final;
- a window over more than one partition (the reference's
  ``_plan_window``): when every function of the node has the same
  PARTITION BY keys, a hash exchange on them into the smaller of
  ``shuffle.partitions`` and the child's partitions; with no PARTITION BY
  or with mixed keys, a coalesce into one partition.  Each partition is
  then one ``TpuWindow`` batch.
"""
from __future__ import annotations

import torch

from .. import config as C
from ..expr import core as ec
from ..exec.exchange import (TpuBroadcastExchange, TpuCoalescePartitions,
                             TpuShuffleExchange)
from ..exec.tpu_aggregate import FINAL, PARTIAL, TpuHashAggregate
from ..exec.tpu_basic import (TpuExec, TpuFilter, TpuGlobalLimit,
                              TpuLocalLimit, TpuLocalScan, TpuProject,
                              TpuUnion)
from ..exec.tpu_join import (TpuBroadcastHashJoin, TpuNestedLoopJoin,
                             TpuShuffledHashJoin)
from ..exec.tpu_sort import TpuSort, TpuTopN
from ..exec.tpu_window import TpuWindow
from ..io.planner import TpuFileScan, to_arrow_filters
from ..shuffle.partitioners import HashPartitioner, RangePartitioner
from . import logical as L
from .logical_opt import prune_scan_columns

#: most estimated build rows a join broadcasts (the reference's stand-in
#: for a byte size)
BROADCAST_ROW_THRESHOLD = 1 << 20


def _stage_ops(node: L.LogicalPlan):
    """Peel the filter/project chain under an aggregate: (source node,
    [(kind, bound payload, output schema)] in execution order)."""
    chain = []
    while isinstance(node, (L.Filter, L.Project)):
        chain.append(node)
        node = node.children[0]
    ops = []
    for op in reversed(chain):
        in_schema = op.children[0].schema
        if isinstance(op, L.Filter):
            ops.append(("filter", op.condition.bind(in_schema), in_schema))
        else:
            ops.append(("project", [e.bind(in_schema) for e in op.exprs],
                        op.schema))
    return node, ops


def plan_physical(node: L.LogicalPlan, conf: C.TpuConf,
                  device: torch.device) -> TpuExec:
    return _plan(prune_scan_columns(node), conf, device)


def _plan(node: L.LogicalPlan, conf: C.TpuConf,
          device: torch.device) -> TpuExec:
    def go(n):
        return _plan(n, conf, device)

    if isinstance(node, L.LocalRelation):
        return TpuLocalScan(node, conf.get(C.BATCH_SIZE_ROWS), device)
    if isinstance(node, L.Scan):
        return TpuFileScan(node, conf, device)
    if isinstance(node, L.Project):
        return TpuProject(node.exprs, go(node.children[0]))
    if isinstance(node, L.Filter):
        child = node.children[0]
        if isinstance(child, L.Scan):
            return TpuFilter(node.condition, TpuFileScan(
                child, conf, device, to_arrow_filters(node.condition)))
        return TpuFilter(node.condition, go(child))
    if isinstance(node, L.Aggregate):
        return _plan_aggregate(node, conf, device, go)
    if isinstance(node, L.Join):
        return _plan_join(node, conf, device, go)
    if isinstance(node, L.Sort):
        child = go(node.children[0])
        nparts = child.num_partitions()
        if nparts > 1:
            child = TpuShuffleExchange(RangePartitioner(node.orders, nparts),
                                       child, conf.get(C.BATCH_SIZE_ROWS))
        return TpuSort(node.orders, child)
    if isinstance(node, L.Limit):
        if isinstance(node.children[0], L.Sort):
            sort = node.children[0]
            return TpuTopN(node.n, sort.orders, go(sort.children[0]))
        local = TpuLocalLimit(node.n, go(node.children[0]))
        return TpuGlobalLimit(node.n, TpuCoalescePartitions(local))
    if isinstance(node, L.Union):
        return TpuUnion(node.schema, [go(c) for c in node.children])
    if isinstance(node, L.Distinct):
        keys = [ec.AttributeReference(f.name, f.dtype, f.nullable)
                for f in node.schema]
        return _plan_aggregate(L.Aggregate(keys, [], node.children[0]),
                               conf, device, go)
    if isinstance(node, L.Window):
        return _plan_window(node, conf, go(node.children[0]))
    raise NotImplementedError(f"no device operator for {type(node).__name__}")


def _plan_window(node: L.Window, conf: C.TpuConf, child: TpuExec) -> TpuExec:
    nparts = child.num_partitions()
    keys = node.window_funcs[0].spec.partition_by
    same_keys = all([repr(e) for e in wf.spec.partition_by] ==
                    [repr(e) for e in keys] for wf in node.window_funcs)
    if nparts > 1:
        if keys and same_keys:
            child = TpuShuffleExchange(
                HashPartitioner(keys, min(conf.get(C.SHUFFLE_PARTITIONS),
                                          nparts)),
                child, conf.get(C.BATCH_SIZE_ROWS))
        else:
            child = TpuCoalescePartitions(child)
    return TpuWindow(node, child)


def _plan_aggregate(node: L.Aggregate, conf: C.TpuConf,
                    device: torch.device, go) -> TpuExec:
    src, ops = _stage_ops(node.children[0])
    table = conf.get(C.AGG_TABLE_SIZE)
    variable = conf.get(C.VARIABLE_FLOAT_AGG)
    partial = TpuHashAggregate(node.group_exprs, node.aggs, go(src),
                               PARTIAL, table, variable, device)
    partial.pre_ops = ops or None
    if node.group_exprs:
        hash_keys = [ec.AttributeReference(ec.output_name(e))
                     for e in node.group_exprs]
        merged = TpuShuffleExchange(
            HashPartitioner(hash_keys, conf.get(C.SHUFFLE_PARTITIONS)),
            partial, conf.get(C.BATCH_SIZE_ROWS))
    else:
        merged = TpuCoalescePartitions(partial)
    return TpuHashAggregate(node.group_exprs, node.aggs, merged, FINAL,
                            table, variable, device)


def _pick_partitions(conf: C.TpuConf, *plans: L.LogicalPlan) -> int:
    """Exchange width from size estimates: at most ``shuffle.partitions``,
    and no more than one batch of the larger side per partition."""
    est = max(p.estimated_rows() for p in plans)
    need = max(1, -(-est // max(conf.get(C.BATCH_SIZE_ROWS), 1)))
    return max(1, min(conf.get(C.SHUFFLE_PARTITIONS), need))


def _plan_join(node: L.Join, conf: C.TpuConf, device: torch.device,
               go) -> TpuExec:
    chunk = conf.get(C.JOIN_GATHER_CHUNK_ROWS)
    if node.how == "cross" or not node.left_keys:
        return TpuNestedLoopJoin(
            node, go(node.children[0]),
            TpuBroadcastExchange(go(node.children[1])), chunk, device)
    left, right = node.children
    lsize, rsize = left.estimated_rows(), right.estimated_rows()
    build_right = node.how != "right"
    if node.how == "inner":
        build_right = rsize <= lsize
    build_size = rsize if build_right else lsize
    lexec, rexec = go(left), go(right)
    if build_size <= BROADCAST_ROW_THRESHOLD and node.how != "full":
        if build_right:
            rexec = TpuBroadcastExchange(rexec)
        else:
            lexec = TpuBroadcastExchange(lexec)
        return TpuBroadcastHashJoin(node, lexec, rexec, build_right, chunk,
                                    device)
    n = _pick_partitions(conf, left, right)
    rows = conf.get(C.BATCH_SIZE_ROWS)
    return TpuShuffledHashJoin(
        node, TpuShuffleExchange(HashPartitioner(node.left_keys, n), lexec,
                                 rows),
        TpuShuffleExchange(HashPartitioner(node.right_keys, n), rexec, rows),
        build_right, chunk, device)
