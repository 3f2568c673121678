"""Hash joins, shuffled and broadcast, of every join type with equi-keys,
and the nested-loop join of cross joins and joins without equi-keys.

Counterpart of ``TpuHashJoinBase``, ``TpuShuffledHashJoin``,
``TpuBroadcastHashJoin`` and ``TpuNestedLoopJoin`` in
``spark_rapids_tpu/exec/tpu_join.py``.  Per
partition the build side is concatenated once and sorted once by its
canonical key words (a stable sort, so duplicate build keys keep their
order from run to run).  Every stream batch of the partition is probed
first; the match totals of all of them come to the host in one read;
then each batch expands and gathers, in chunks of at most
``join.gather.chunkRows`` output rows (the reference's JoinGatherer
role), so even one probe row's matches may split across chunks.

A partition probes by direct address instead of the search when the
reference would (its ``TpuHashJoinBase`` rule): no residual condition,
not a full join, one integer, DATE or DECIMAL key on both sides, and
stream batches of at least ``join.DIRECT_MIN_STREAM`` rows of capacity, which
each partition decides for itself.  Its build then makes
``join.direct_tables`` (one host read, kept with the build, so a
broadcast build makes them once) unless its keys span more than
``join.DIRECT_MAX_RANGE``; each stream batch then takes one
``direct_probe`` launch over its key column for its (lo, counts).
``probes`` counts the batches probed each way.

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

String keys of both sides take one word width, so their words compare:
a shuffled join's over the build and stream batches of the partition
(``canon.common_str_words``), a broadcast join's over the build alone,
its stream batches read one at a time.  A stream string longer than that
width keeps only its leading words, but its length word differs from
every build row's, so it matches nothing, as it should; the build's
order and every match are those of the wider words.  A broadcast join
has as many partitions as its stream side.  A shuffled join reads
partition i of both sides before it touches partition i + 1.

The nested-loop join pairs every left row with every row of the
broadcast right side, in chunks of at most ``join.gather.chunkRows``
pairs (the reference expands all ``n_l x n_r`` pairs of a batch at
once; the rows are the same, in the same order).  Its condition decides
each pair, with the reference's pair-level semantics for every join
type: outer sides null-extend the rows no surviving pair holds, semi and
anti keep the left rows that have a surviving pair or none, and right and
full joins collapse the left side into one partition, so that the right
rows no pair matched are known once every left row was seen.
"""
from __future__ import annotations

import itertools
from typing import List

import torch

from ..columnar import dtypes as T
from ..columnar.batch import ColumnarBatch, concat_batches
from ..columnar.column import Column, bucket_capacity, null_column
from ..columnar.schema import Field, Schema
from ..expr import core as ec
from ..kernels import canon, join as join_k
from ..kernels.basic import compact_indices
from ..plan.logical import Join, join_schema
from .exchange import TpuBroadcastExchange
from .tpu_basic import Partitions, TpuExec

#: join types whose stream rows all appear in the output
_OUTER = ("left", "right", "full")


def _key_words(keys, batch, live, str_words):
    cols = [ec.eval_as_column(k, batch) for k in keys]
    words, rank_pos = [], []
    for c, sw in zip(cols, str_words):
        rank_pos.append(len(words))
        words.extend(canon.column_key_words(c, live, str_words=sw))
    return words, rank_pos


def _str_words(bkeys, build_batches, skeys, stream_batches):
    """One string width per key position over both sides' batches."""
    if not any(k.dtype() == T.STRING for k in bkeys):
        return [None] * len(bkeys)
    sets = [[ec.eval_as_column(k, b) for k in bkeys] for b in build_batches]
    sets += [[ec.eval_as_column(k, b) for k in skeys]
             for b in stream_batches]
    return canon.common_str_words(sets) if sets else [None] * len(bkeys)


def _pair_schema(children) -> Schema:
    """A join's left then right columns, all nullable: the schema its
    condition is evaluated over, pair by pair."""
    left, right = children
    return Schema([Field(f.name, f.dtype, True)
                   for f in list(left.output_schema) +
                   list(right.output_schema)])


def _null_columns(schema: Schema, capacity: int, device) -> List[Column]:
    return [null_column(f.dtype, capacity, device) for f in schema]


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
        #: stream batches probed by direct address and by search in the
        #: last execute()
        self.probes = {"direct": 0, "search": 0}

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

    def _build(self, batches, schema: Schema, keys, str_words):
        """The build side as one batch, and its table sorted once."""
        batches = [b for b in batches if b.num_rows > 0]
        build = concat_batches(batches) if batches else \
            ColumnarBatch.empty(schema, self.device)
        words, _ = _key_words(keys, build, build.live_mask(), str_words)
        return build, join_k.build(words)

    def _order(self, stream_cols, build_cols) -> List[Column]:
        return stream_cols + build_cols if self.build_right \
            else build_cols + stream_cols

    def _assemble(self, stream_cols, build_cols, rows) -> ColumnarBatch:
        return ColumnarBatch(self.output_schema,
                             self._order(stream_cols, build_cols), rows,
                             device=self.device)

    def _reset_counts(self):
        self.expand_counts = {"batches": 0, "chunks": 0}
        self.probes = {"direct": 0, "search": 0}

    def _broadcast(self, make_build, bschema, stream_parts) -> Partitions:
        """Every stream partition joined to one build batch, made (by
        ``make_build``, None for no rows) and sorted when the first
        partition is read; its direct tables are made once too."""
        _, _, bkeys, skeys = self._sides()
        built = []

        def build_once():
            if not built:
                b = make_build()
                bpart = [b] if b is not None else []
                sw = _str_words(bkeys, bpart, skeys, [])
                built.extend(self._build(bpart, bschema, bkeys, sw) +
                             (sw, {}))
            return built

        def partition(part):
            build, bt, sw, memo = build_once()
            yield from self._run_partition(build, bt, part, skeys, sw, memo)
        return [partition(part) for part in stream_parts]

    # -- the direct-address probe ---------------------------------------------
    def _may_probe_directly(self, skeys) -> bool:
        """The reference's static half of its rule: no residual, not a
        full join, one key, an integer, DATE or DECIMAL on both sides."""
        bkeys = self._sides()[2]
        return (self.join.condition is None and self.join.how != "full"
                and len(bkeys) == 1 and
                join_k.direct_keyable(bkeys[0].dtype()) and
                join_k.direct_keyable(skeys[0].dtype()))

    def _direct(self, build: ColumnarBatch, stream_batches, skeys,
                memo: dict):
        """(stream batches, direct tables or None) of one partition, by
        the reference's rule for each partition: one whose stream
        capacity reaches ``DIRECT_MIN_STREAM`` probes directly if the
        build's keys allow it, a smaller one searches.  The build's
        tables (one host read) are made at the first partition that needs
        them and kept in ``memo``, which a broadcast build shares across
        its partitions.  The stream's first batches are read ahead until
        the capacity is reached."""
        if not self._may_probe_directly(skeys):
            return stream_batches, None
        it = iter(stream_batches)
        ahead, cap = [], 0
        for sb in it:
            ahead.append(sb)
            cap += sb.capacity
            if cap >= join_k.DIRECT_MIN_STREAM:
                break
        stream = itertools.chain(ahead, it)
        if cap < join_k.DIRECT_MIN_STREAM:
            return stream, None
        if "direct" not in memo:
            key = ec.eval_as_column(self._sides()[2][0], build)
            memo["direct"] = join_k.direct_tables(key, build.rows)
        return stream, memo["direct"]

    # -- one partition --------------------------------------------------------
    def _run_partition(self, build: ColumnarBatch, bt: join_k.BuildTable,
                       stream_batches, skeys, str_words, memo=None):
        """Join one partition's stream batches to its build.  ``memo``
        holds what the build's other partitions share (a broadcast
        join's direct tables)."""
        how = self.join.how
        residual = self.join.condition is not None
        flags = torch.zeros(build.capacity + 1, dtype=torch.bool,
                            device=self.device) if how == "full" else None
        stream_batches, direct = self._direct(
            build, stream_batches, skeys, {} if memo is None else memo)
        probed = []
        # phase A: probe every stream batch
        for sb in stream_batches:
            live = sb.live_mask()
            if direct is not None:
                jc = join_k.direct_counts(
                    direct, ec.eval_as_column(skeys[0], sb), sb.rows)
                self.probes["direct"] += 1
            else:
                words, rank_pos = _key_words(skeys, sb, live, str_words)
                jc = join_k.probe_counts(bt, words, live, rank_pos)
                self.probes["search"] += 1
            if how in ("semi", "anti") and not residual:
                keep = jc.matched if how == "semi" else ~jc.matched & live
                yield self._select(sb, keep)
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
                yield from self._expand_residual(sb, live, build, bt, jc,
                                                 total, flags)
            else:
                yield from self._expand(sb, build, bt, jc, counts, total,
                                        flags)
        if flags is not None:
            tail = self._unmatched_build_rows(build, flags)
            if tail is not None:
                yield tail

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

    def _expand_residual(self, sb, live_s, build, bt, jc, total, flags):
        how = self.join.how
        pair_schema = _pair_schema(self.children)
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
                # the surviving pairs at their own capacity: a chunk may
                # keep few of its pairs (q72's keeps ~5%), and the chunks
                # of a batch all wait for the next operator
                idx, kept = compact_indices(keep, n)
                kept = int(kept)
                yield ColumnarBatch(self.output_schema, pairs.gather(
                    idx[:bucket_capacity(kept)], kept).columns, kept,
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
        self._reset_counts()
        bexec, sexec, bkeys, skeys = self._sides()
        bparts, sparts = bexec.execute(), sexec.execute()
        if len(bparts) != len(sparts):
            raise ValueError(f"join sides have {len(bparts)} and "
                             f"{len(sparts)} partitions")
        return [self._partition(bpart, spart, bexec.output_schema, bkeys,
                                skeys)
                for bpart, spart in zip(bparts, sparts)]

    def _partition(self, bpart, spart, bschema, bkeys, skeys):
        bpart, spart = list(bpart), list(spart)
        sw = _str_words(bkeys, bpart, skeys, spart)
        build, bt = self._build(bpart, bschema, bkeys, sw)
        del bpart
        yield from self._run_partition(build, bt, spart, skeys, sw)


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

    def num_partitions(self) -> int:
        return self._sides()[1].num_partitions()

    def execute(self) -> Partitions:
        self._reset_counts()
        bexec, sexec, _, _ = self._sides()
        return self._broadcast(bexec.broadcast_batch,
                               bexec.output_schema, sexec.execute())


class TpuNestedLoopJoin(TpuExec):
    """Cross joins and joins without equi-keys: every left batch against
    the broadcast right side (``children[1]``, a TpuBroadcastExchange,
    materialised once per execute)."""

    def __init__(self, join: Join, left: TpuExec, right: TpuExec,
                 chunk_rows: int, device):
        if not isinstance(right, TpuBroadcastExchange):
            raise TypeError("the right side must be a TpuBroadcastExchange")
        self.children = [left, right]
        self.join = join
        self.chunk_rows = chunk_rows
        self.device = device
        #: left batches with pairs, and their chunks, in the last execute()
        self.expand_counts = {"batches": 0, "chunks": 0}

    @property
    def output_schema(self) -> Schema:
        return join_schema(self.join.how, self.children[0].output_schema,
                           self.children[1].output_schema)

    def num_partitions(self) -> int:
        if self.join.how in ("right", "full"):
            return 1
        return self.children[0].num_partitions()

    def _node_string(self):
        return f"TpuNestedLoopJoin[{self.join.how}]"

    def execute(self) -> Partitions:
        self.expand_counts = {"batches": 0, "chunks": 0}
        left, right = self.children
        rb = right.broadcast_batch()
        if rb is None:
            rb = ColumnarBatch.empty(right.output_schema, self.device)
        lparts = left.execute()
        if self.join.how not in ("right", "full"):
            return [self._join_part(part, rb, None) for part in lparts]
        # the right rows no pair matched, known after every left row
        return [self._join_part(itertools.chain.from_iterable(lparts), rb,
                                torch.zeros(rb.capacity + 1,
                                            dtype=torch.bool,
                                            device=self.device))]

    def _join_part(self, part, rb: ColumnarBatch, flags):
        for lb in part:
            yield from self._join_batch(lb, rb, flags)
        if flags is not None:
            keep = ~flags[:-1] & rb.live_mask()
            idx, n = compact_indices(keep, rb.rows_dev)
            yield ColumnarBatch(
                self.output_schema,
                _null_columns(self.children[0].output_schema, rb.capacity,
                              self.device) +
                rb.gather(idx, n).columns, n, device=self.device)

    def _join_batch(self, lb: ColumnarBatch, rb: ColumnarBatch, flags):
        how = self.join.how
        n_l, n_r = lb.num_rows, rb.num_rows
        cond = self.join.condition
        if cond is not None:
            pair_schema = _pair_schema(self.children)
            cond = cond.bind(pair_schema)
        live_l = lb.live_mask()
        # left rows with a surviving pair (one spare slot for misses)
        surv = torch.zeros(lb.capacity + 1, dtype=torch.bool,
                           device=self.device)
        total = n_l * n_r
        if cond is None and how in ("semi", "anti") and n_r:
            surv[:-1] = live_l          # every pair survives: no pairs
            total = 0
        self.expand_counts["batches"] += total > 0
        for start in range(0, total, self.chunk_rows):
            n = min(self.chunk_rows, total - start)
            self.expand_counts["chunks"] += 1
            cap = bucket_capacity(n)
            t = torch.arange(start, start + cap, device=self.device)
            live = t < start + n
            li, ri = t // n_r, t % n_r
            cols = [c.gather(li, live) for c in lb.columns] + \
                [c.gather(ri, live) for c in rb.columns]
            if cond is None:
                keep = live
            else:
                pairs = ColumnarBatch(pair_schema, cols, n,
                                      device=self.device)
                pred = ec.eval_as_column(cond, pairs)
                keep = pred.data.to(torch.bool) & pred.validity & live
            join_k.mark_matched(surv, li, keep)
            if flags is not None:
                join_k.mark_matched(flags, ri, keep)
            if how in ("semi", "anti"):
                continue
            if cond is None:
                yield ColumnarBatch(self.output_schema, cols, n,
                                    device=self.device)
            else:
                idx, kept = compact_indices(keep, n)
                yield ColumnarBatch(self.output_schema,
                                    pairs.gather(idx, kept).columns, kept,
                                    device=self.device)
        surv = surv[:-1]
        if how in ("semi", "anti"):
            keep = surv if how == "semi" else ~surv & live_l
            idx, n = compact_indices(keep, lb.rows_dev)
            yield ColumnarBatch(self.output_schema, lb.gather(idx, n).columns,
                                n, device=self.device)
        elif how in ("left", "full"):
            idx, n = compact_indices(~surv & live_l, lb.rows_dev)
            yield ColumnarBatch(
                self.output_schema, lb.gather(idx, n).columns +
                _null_columns(rb.schema, lb.capacity, self.device), n,
                device=self.device)
