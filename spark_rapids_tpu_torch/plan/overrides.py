"""Planner: logical plan -> device operators.

Plays the role of ``spark_rapids_tpu/plan/overrides.py`` for the port:
- a group-by becomes partial aggregate -> hash exchange on the group keys
  -> final aggregate, with the filter/project chain under it staged into
  the partial aggregate; that exchange has ``shuffle.partitions``
  partitions;
- an equi-join builds on the right side, except a right join; an inner
  join builds on the side with fewer estimated rows.  A build side of at
  most ``BROADCAST_ROW_THRESHOLD`` estimated rows is broadcast, unless
  the join is full; every other join hash-partitions both sides on
  their keys into ``_pick_partitions`` partitions and joins partition by
  partition (``TpuShuffledHashJoin``);
- cross joins and joins without equi-keys are not ported and raise.
"""
from __future__ import annotations

import torch

from .. import config as C
from ..expr import core as ec
from ..exec.exchange import TpuBroadcastExchange, TpuShuffleExchange
from ..exec.tpu_aggregate import FINAL, PARTIAL, TpuHashAggregate
from ..exec.tpu_basic import TpuExec, TpuFilter, TpuLocalScan, TpuProject
from ..exec.tpu_join import TpuBroadcastHashJoin, TpuShuffledHashJoin
from ..shuffle.partitioners import HashPartitioner
from . import logical as L

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
    def go(n):
        return plan_physical(n, conf, device)

    if isinstance(node, L.LocalRelation):
        return TpuLocalScan(node, conf.get(C.BATCH_SIZE_ROWS), device)
    if isinstance(node, L.Project):
        return TpuProject(node.exprs, go(node.children[0]))
    if isinstance(node, L.Filter):
        return TpuFilter(node.condition, go(node.children[0]))
    if isinstance(node, L.Aggregate):
        if not node.group_exprs:
            raise NotImplementedError("global aggregates are not ported yet")
        src, ops = _stage_ops(node.children[0])
        table = conf.get(C.AGG_TABLE_SIZE)
        variable = conf.get(C.VARIABLE_FLOAT_AGG)
        partial = TpuHashAggregate(node.group_exprs, node.aggs, go(src),
                                   PARTIAL, table, variable)
        partial.pre_ops = ops or None
        hash_keys = [ec.AttributeReference(ec.output_name(e))
                     for e in node.group_exprs]
        exchange = TpuShuffleExchange(
            HashPartitioner(hash_keys, conf.get(C.SHUFFLE_PARTITIONS)),
            partial)
        return TpuHashAggregate(node.group_exprs, node.aggs, exchange, FINAL,
                                table, variable)
    if isinstance(node, L.Join):
        return _plan_join(node, conf, device, go)
    raise NotImplementedError(f"no device operator for {type(node).__name__}")


def _pick_partitions(conf: C.TpuConf, *plans: L.LogicalPlan) -> int:
    """Exchange width from size estimates: at most ``shuffle.partitions``,
    and no more than one batch of the larger side per partition."""
    est = max(p.estimated_rows() for p in plans)
    need = max(1, -(-est // max(conf.get(C.BATCH_SIZE_ROWS), 1)))
    return max(1, min(conf.get(C.SHUFFLE_PARTITIONS), need))


def _plan_join(node: L.Join, conf: C.TpuConf, device: torch.device,
               go) -> TpuExec:
    if node.how == "cross" or not node.left_keys:
        raise NotImplementedError(
            "cross joins and joins without equi-keys (the reference's "
            "TpuNestedLoopJoin) are not ported yet")
    left, right = node.children
    lsize, rsize = left.estimated_rows(), right.estimated_rows()
    build_right = node.how != "right"
    if node.how == "inner":
        build_right = rsize <= lsize
    build_size = rsize if build_right else lsize
    lexec, rexec = go(left), go(right)
    chunk = conf.get(C.JOIN_GATHER_CHUNK_ROWS)
    if build_size <= BROADCAST_ROW_THRESHOLD and node.how != "full":
        if build_right:
            rexec = TpuBroadcastExchange(rexec)
        else:
            lexec = TpuBroadcastExchange(lexec)
        return TpuBroadcastHashJoin(node, lexec, rexec, build_right, chunk,
                                    device)
    n = _pick_partitions(conf, left, right)
    return TpuShuffledHashJoin(
        node, TpuShuffleExchange(HashPartitioner(node.left_keys, n), lexec),
        TpuShuffleExchange(HashPartitioner(node.right_keys, n), rexec),
        build_right, chunk, device)
