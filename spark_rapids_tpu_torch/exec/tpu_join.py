"""Hash joins, shuffled and broadcast, of every join type with equi-keys.

Counterpart of ``TpuHashJoinBase``, ``TpuShuffledHashJoin`` and
``TpuBroadcastHashJoin`` in ``spark_rapids_tpu/exec/tpu_join.py``.  Per
partition the build side is concatenated once and sorted once by its
canonical key words (a stable sort, so duplicate build keys keep their
order from run to run).  Every stream batch of the partition is probed
first; the match totals of all of them come to the host in one read;
then each batch expands and gathers, in chunks of at most
``join.gather.chunkRows`` output rows (the reference's JoinGatherer
role), so even one probe row's matches may split across chunks.

Join types by count surgery:
- outer: an unmatched stream row gets one row with the build side null;
- semi:  keep the stream rows with count > 0 (no expansion);
- anti:  keep the stream rows with count == 0;
- full:  left outer, then the build rows no stream row matched, from
         flags kept on the device (one more host read per partition).

A residual condition is evaluated on each expanded inner pair, over a
schema where every column is nullable; the join type's rows follow from
the pairs that survive.  The output keeps the logical column order, left
then right, whichever side is built.
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar.batch import ColumnarBatch, concat_batches
from ..columnar.column import Column, bucket_capacity
from ..columnar.schema import Field, Schema
from ..expr import core as ec
from ..kernels import canon, join as join_k
from ..kernels.basic import compact_indices
from ..plan.logical import Join, join_schema
from .exchange import TpuBroadcastExchange
from .tpu_basic import Partitions, TpuExec

#: join types whose stream rows all appear in the output
_OUTER = ("left", "right", "full")


def _key_words(keys, batch, live):
    cols = [ec.eval_as_column(k, batch) for k in keys]
    words, rank_pos = [], []
    for c in cols:
        rank_pos.append(len(words))
        words.extend(canon.column_key_words(c, live))
    return words, rank_pos


def _null_columns(schema: Schema, capacity: int, device) -> List[Column]:
    return [Column.from_scalar(None, f.dtype, capacity, device)
            for f in schema]


class TpuHashJoinBase(TpuExec):
    """Build, probe and expand.  ``children`` are [left, right]; the
    build side is the right one except for right joins (inner joins may
    build on either side)."""

    def __init__(self, join: Join, left: TpuExec, right: TpuExec,
                 build_right: bool, chunk_rows: int, device):
        how = join.how
        if (how == "right") == build_right and how != "inner":
            raise ValueError(f"a {how} join cannot build on the "
                             f"{'right' if build_right else 'left'}")
        self.children = [left, right]
        self.join = join
        self.build_right = build_right
        self.chunk_rows = chunk_rows
        self.device = device
        #: expanded stream batches and their chunks in the last execute()
        self.expand_counts = {"batches": 0, "chunks": 0}

    @property
    def output_schema(self) -> Schema:
        return join_schema(self.join.how, self.children[0].output_schema,
                           self.children[1].output_schema)

    def _node_string(self):
        side = "right" if self.build_right else "left"
        return f"{type(self).__name__}[{self.join.how}, build={side}]"

    # -- sides ----------------------------------------------------------------
    def _sides(self):
        """(build exec, stream exec, build keys, stream keys), bound."""
        left, right = self.children
        lkeys = [k.bind(left.output_schema) for k in self.join.left_keys]
        rkeys = [k.bind(right.output_schema) for k in self.join.right_keys]
        if self.build_right:
            return right, left, rkeys, lkeys
        return left, right, lkeys, rkeys

    def _build(self, batches, schema: Schema, keys):
        """The build side as one batch, and its table sorted once."""
        batches = [b for b in batches if b.num_rows > 0]
        build = concat_batches(batches) if batches else \
            ColumnarBatch.empty(schema, self.device)
        words, _ = _key_words(keys, build, build.live_mask())
        return build, join_k.build(words)

    def _order(self, stream_cols, build_cols) -> List[Column]:
        return stream_cols + build_cols if self.build_right \
            else build_cols + stream_cols

    def _assemble(self, stream_cols, build_cols, rows) -> ColumnarBatch:
        return ColumnarBatch(self.output_schema,
                             self._order(stream_cols, build_cols), rows,
                             device=self.device)

    # -- one partition --------------------------------------------------------
    def _run_partition(self, build: ColumnarBatch, bt: join_k.BuildTable,
                       stream_batches, skeys) -> List[ColumnarBatch]:
        how = self.join.how
        residual = self.join.condition is not None
        flags = torch.zeros(build.capacity + 1, dtype=torch.bool,
                            device=self.device) if how == "full" else None
        out, probed = [], []
        # phase A: probe every stream batch
        for sb in stream_batches:
            live = sb.live_mask()
            words, rank_pos = _key_words(skeys, sb, live)
            jc = join_k.probe_counts(bt, words, live, rank_pos)
            if how in ("semi", "anti") and not residual:
                keep = jc.matched if how == "semi" else ~jc.matched & live
                out.append(self._select(sb, keep))
                continue
            counts = jc.counts
            if how in _OUTER and not residual:
                counts = join_k.outer_counts(counts, live)
            probed.append((sb, live, jc, counts))
        if not probed:
            totals = []
        else:
            # the partition's one host read: every batch's output rows
            totals = torch.stack([c[-1].sum() for c in probed]).tolist()
        # phase B: expand and gather
        for (sb, live, jc, counts), total in zip(probed, totals):
            if residual:
                out.extend(self._expand_residual(sb, live, build, bt, jc,
                                                 total, flags))
            else:
                out.extend(self._expand(sb, build, bt, jc, counts, total,
                                        flags))
        if flags is not None:
            tail = self._unmatched_build_rows(build, flags)
            if tail is not None:
                out.append(tail)
        return out

    def _select(self, sb: ColumnarBatch, keep: torch.Tensor):
        """Semi/anti output: the kept stream rows, counted on the device."""
        idx, n = compact_indices(keep, sb.rows_dev)
        return ColumnarBatch(self.output_schema, sb.gather(idx, n).columns,
                             n, device=self.device)

    def _chunks(self, total: int):
        """(first output row, rows) of each expansion chunk."""
        self.expand_counts["batches"] += total > 0
        for start in range(0, total, self.chunk_rows):
            self.expand_counts["chunks"] += 1
            yield start, min(self.chunk_rows, total - start)

    def _expand_chunk(self, sb, bt, lo, counts, start: int, n: int):
        """Output rows ``start .. start + n - 1`` of one stream batch:
        (probe rows, build rows, stream columns, live)."""
        cap = bucket_capacity(n)
        p_idx, b_idx, _, _ = join_k.expand_matches(lo, counts, bt.perm, cap,
                                                   start)
        live = torch.arange(cap, device=self.device) < n
        scols = [c.gather(p_idx, live) for c in sb.columns]
        return p_idx, b_idx, scols, live

    def _expand(self, sb, build, bt, jc, counts, total, flags):
        outer = self.join.how in _OUTER
        for start, n in self._chunks(total):
            p_idx, b_idx, scols, live = self._expand_chunk(
                sb, bt, jc.lo, counts, start, n)
            # an outer row of an unmatched stream row has no build row
            hit = live & jc.matched[p_idx] if outer else live
            bcols = [c.gather(b_idx, hit) for c in build.columns]
            if flags is not None:
                join_k.mark_matched(flags, b_idx, hit)
            yield self._assemble(scols, bcols, n)

    def _pair_schema(self) -> Schema:
        left, right = self.children
        return Schema([Field(f.name, f.dtype, True)
                       for f in list(left.output_schema) +
                       list(right.output_schema)])

    def _expand_residual(self, sb, live_s, build, bt, jc, total, flags):
        how = self.join.how
        pair_schema = self._pair_schema()
        cond = self.join.condition.bind(pair_schema)
        # stream rows with a surviving pair (one spare slot for misses)
        surv = torch.zeros(sb.capacity + 1, dtype=torch.bool,
                           device=self.device)
        for start, n in self._chunks(total):
            p_idx, b_idx, scols, live = self._expand_chunk(
                sb, bt, jc.lo, jc.counts, start, n)
            bcols = [c.gather(b_idx, live) for c in build.columns]
            pairs = ColumnarBatch(pair_schema, self._order(scols, bcols), n,
                                  device=self.device)
            pred = ec.eval_as_column(cond, pairs)
            keep = pred.data.to(torch.bool) & pred.validity & live
            join_k.mark_matched(surv, p_idx, keep)
            if flags is not None:
                join_k.mark_matched(flags, b_idx, keep)
            if how not in ("semi", "anti"):
                idx, kept = compact_indices(keep, n)
                yield ColumnarBatch(self.output_schema,
                                    pairs.gather(idx, kept).columns, kept,
                                    device=self.device)
        surv = surv[:-1]
        if how == "semi":
            yield self._select(sb, surv)
        elif how == "anti":
            yield self._select(sb, ~surv & live_s)
        elif how in _OUTER:
            idx, n = compact_indices(~surv & live_s, sb.rows_dev)
            yield self._assemble(sb.gather(idx, n).columns, _null_columns(
                build.schema, sb.capacity, self.device), n)

    def _unmatched_build_rows(self, build, flags):
        """A full join's build rows that no stream row matched, with the
        stream side null.  Reads their count to the host."""
        keep = ~flags[:-1] & build.live_mask()
        idx, cnt = compact_indices(keep, build.rows_dev)
        n = int(cnt.item())
        if n == 0:
            return None
        cap = bucket_capacity(n)
        live = torch.arange(cap, device=self.device) < n
        bcols = [c.gather(idx[:cap], live) for c in build.columns]
        sschema = self._sides()[1].output_schema
        return self._assemble(_null_columns(sschema, cap, self.device),
                              bcols, n)


class TpuShuffledHashJoin(TpuHashJoinBase):
    """Both sides hash-partitioned on their keys by the planner's
    exchanges; partition i of one side joins partition i of the other."""

    def execute(self) -> Partitions:
        self.expand_counts = {"batches": 0, "chunks": 0}
        bexec, sexec, bkeys, skeys = self._sides()
        bparts, sparts = bexec.execute(), sexec.execute()
        if len(bparts) != len(sparts):
            raise ValueError(f"join sides have {len(bparts)} and "
                             f"{len(sparts)} partitions")
        out = []
        for bpart, spart in zip(bparts, sparts):
            build, bt = self._build(bpart, bexec.output_schema, bkeys)
            out.append(self._run_partition(build, bt, spart, skeys))
        return out


class TpuBroadcastHashJoin(TpuHashJoinBase):
    """The build side is one broadcast batch, sorted once and probed by
    every stream partition.  Never a full join: its unmatched build rows
    would need every partition's flags."""

    def __init__(self, join: Join, left: TpuExec, right: TpuExec,
                 build_right: bool, chunk_rows: int, device):
        super().__init__(join, left, right, build_right, chunk_rows, device)
        if join.how == "full":
            raise ValueError("a full join is never broadcast")
        if not isinstance(self._sides()[0], TpuBroadcastExchange):
            raise TypeError("the build side must be a TpuBroadcastExchange")

    def execute(self) -> Partitions:
        self.expand_counts = {"batches": 0, "chunks": 0}
        bexec, sexec, bkeys, skeys = self._sides()
        b = bexec.broadcast_batch()
        build, bt = self._build([b] if b is not None else [],
                                bexec.output_schema, bkeys)
        return [self._run_partition(build, bt, part, skeys)
                for part in sexec.execute()]
