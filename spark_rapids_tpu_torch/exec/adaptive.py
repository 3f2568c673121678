"""Adaptive query execution from the shuffle's statistics.

Counterpart of ``spark_rapids_tpu/exec/adaptive.py`` (the reference's
``GpuCustomShuffleReaderExec`` and the AQE surgery of its transition
overrides).  An adaptive operator runs the map side of its exchanges
when it is executed, reads each reduce partition's (bytes, rows) from
the blocks in the catalog (``MapOutput.partition_stats``) and shapes the
reduce side from them:

- ``TpuAQEShuffleRead``: adjacent reduce partitions are read as one, up
  to ``adaptive.targetPartitionBytes`` together (Spark's partition
  coalescing);
- ``TpuAdaptiveShuffledJoin``: the build side is shuffled first.  When
  its bytes come to at most ``adaptive.autoBroadcastJoinBytes`` (and the
  join is not full), it is concatenated into one batch and every
  partition of the probe side, unshuffled, is joined to it (AQE's
  conversion to a broadcast join).  Otherwise the probe side is shuffled
  too, adjacent partitions are grouped by both sides' bytes together,
  and a probe partition of more than ``adaptive.skewedPartitionFactor``
  times the median bytes and more than
  ``adaptive.skewedPartitionThresholdBytes`` is cut into slices of its
  blocks, each joined to the whole build partition (AQE's skew join; not
  for right and full joins, whose build rows may appear unmatched).

Partition counts: the reference reports the exchange's width for both
operators, though its join returns the probe side's partitions after a
conversion and more than its width after a split, so a sort or window
planned over a width of 1 sorts each of several partitions apart.  Here
an operator reports 1 only when it returns exactly one partition: the
read returns at most its exchange's width, and the join reports 1 only
for a width of 1 over a one-partition probe side (and then chains
whatever it runs into one partition).
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from ..columnar.batch import concat_batches
from ..memory.arena import DeviceManager
from ..plan.logical import Join
from ..shuffle.partitioners import HashPartitioner
from .exchange import MapOutput, TpuShuffleExchange
from .tpu_basic import Partitions, TpuExec
from .tpu_join import TpuHashJoinBase, _str_words


def coalesce_partition_ids(stats: List[Tuple[int, int]],
                           target_bytes: int) -> List[List[int]]:
    """Adjacent reduce ids grouped while their bytes stay within
    ``target_bytes`` (Spark's ShufflePartitionsUtil.coalescePartitions):
    each partition joins the group before it unless that would pass the
    target; a partition larger than the target is a group of its own."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for pid, (nbytes, _rows) in enumerate(stats):
        if cur and cur_bytes + nbytes > target_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(pid)
        cur_bytes += nbytes
    if cur:
        groups.append(cur)
    return groups


def skew_split_sizes(stats: List[Tuple[int, int]], factor: float,
                     min_bytes: int) -> List[bool]:
    """Which partitions are skewed: more bytes than ``min_bytes`` and than
    ``factor`` times the median (the upper median of an even count)."""
    sizes = sorted(s for s, _ in stats)
    if not sizes:
        return []
    median = sizes[len(sizes) // 2]
    return [s > max(min_bytes, factor * max(median, 1)) for s, _ in stats]


class TpuAQEShuffleRead(TpuExec):
    """A hash exchange read in groups of adjacent reduce partitions, each
    group one output partition, its partitions read one after the other
    (each coalesced up to the exchange's batch rows, as always)."""

    def __init__(self, child: TpuShuffleExchange, target_bytes: int):
        self.children = [child]
        self.target_bytes = target_bytes
        #: the reduce ids of each group in the last execute()
        self.groups: Optional[List[List[int]]] = None

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        """At most the exchange's width (1 when that is 1)."""
        return self.children[0].num_partitions()

    def _node_string(self):
        state = f"{len(self.groups)} groups" if self.groups is not None \
            else "pending"
        return f"TpuAQEShuffleRead[{state}]"

    def execute(self) -> Partitions:
        out = self.children[0].map_output(with_stats=True)
        self.groups = coalesce_partition_ids(out.partition_stats(),
                                             self.target_bytes)
        return [_read_group(out, g) for g in self.groups]


def _read_group(out: MapOutput, pids):
    for pid in pids:
        yield from out.stream_reduce(pid)


class TpuAdaptiveShuffledJoin(TpuHashJoinBase):
    """A shuffled equi-join whose strategy is chosen at run time from the
    exchanges' statistics (module docstring).  ``children`` are the
    sides before their exchanges, as the reference's; the exchanges, on
    the join's keys into ``width`` partitions, are made with the
    operator.  Each task joins as ``TpuShuffledHashJoin`` joins a
    partition: both sides' batches listed, the build concatenated and
    sorted once, every stream batch probed, then expanded."""

    #: join types whose build rows never appear unmatched: a build
    #: partition may be joined to each slice of a skewed probe partition
    _SKEW_SAFE = ("inner", "left", "semi", "anti")

    def __init__(self, join: Join, left: TpuExec, right: TpuExec,
                 build_right: bool, width: int, batch_rows: int,
                 chunk_rows: int, device, broadcast_bytes: int,
                 target_bytes: int, skew_factor: float,
                 skew_min_bytes: int):
        super().__init__(join, left, right, build_right, chunk_rows, device)
        self.width = width
        self.exchanges = [
            TpuShuffleExchange(HashPartitioner(join.left_keys, width), left,
                               batch_rows),
            TpuShuffleExchange(HashPartitioner(join.right_keys, width), right,
                               batch_rows)]
        self.broadcast_bytes = broadcast_bytes
        self.target_bytes = target_bytes
        self.skew_factor = skew_factor
        self.skew_min_bytes = skew_min_bytes
        #: the last execute()'s choice: "broadcast" or "shuffled"
        self.strategy: Optional[str] = None
        #: partitions it returned; reduce ids of each shuffled group; the
        #: slices of each skewed partition
        self.tasks = 0
        self.groups: List[List[int]] = []
        self.splits: List[int] = []

    def num_partitions(self) -> int:
        """1 only if ``execute()`` returns one partition: a width of 1
        over a one-partition probe side (a broadcast conversion returns
        the probe side's partitions, a skew split more than the width)."""
        probe = self._sides()[1].num_partitions()
        if self.width == 1 and probe == 1:
            return 1
        return max(self.width, probe)

    def _node_string(self):
        side = "right" if self.build_right else "left"
        head = (f"TpuAdaptiveShuffledJoin[{self.join.how}, "
                f"strategy={self.strategy or 'pending'}, build={side}")
        if self.strategy == "broadcast":
            head += f", {self.tasks} partitions"
        elif self.strategy == "shuffled":
            head += f", {len(self.groups)} groups"
            if self.splits:
                head += (f", {len(self.splits)} skewed into "
                         f"{'+'.join(map(str, self.splits))} slices")
        return head + "]"

    def close(self) -> None:
        for ex in self.exchanges:
            ex.close()

    def execute(self) -> Partitions:
        self._reset_counts()
        self.groups, self.splits = [], []
        bexec, sexec, bkeys, skeys = self._sides()
        bex, sex = self.exchanges if not self.build_right else \
            self.exchanges[::-1]
        bout = bex.map_output(with_stats=True)
        bstats = bout.partition_stats()
        if (sum(b for b, _ in bstats) <= self.broadcast_bytes and
                self.join.how != "full"):
            self.strategy = "broadcast"
            parts = self._broadcast(lambda: _build_batch(bout),
                                    bexec.output_schema, sexec.execute())
        else:
            self.strategy = "shuffled"
            parts = self._shuffled(bout, bstats,
                                   sex.map_output(with_stats=True),
                                   bexec.output_schema, bkeys, skeys)
        if self.num_partitions() == 1 and len(parts) != 1:
            parts = [itertools.chain.from_iterable(parts)]
        self.tasks = len(parts)
        return parts

    def _shuffled(self, bout: MapOutput, bstats, sout: MapOutput, bschema,
                  bkeys, skeys) -> Partitions:
        sstats = sout.partition_stats()
        # both sides grouped alike, by their bytes together
        self.groups = coalesce_partition_ids(
            [(b1 + b2, r1 + r2) for (b1, r1), (b2, r2) in zip(bstats, sstats)],
            self.target_bytes)
        skewed = skew_split_sizes(sstats, self.skew_factor,
                                  self.skew_min_bytes) \
            if self.join.how in self._SKEW_SAFE else [False] * len(sstats)
        tasks = []     # (reduce ids, probe blocks or None for all)
        for g in self.groups:
            if len(g) == 1 and skewed[g[0]]:
                pid = g[0]
                blocks = list(sout.partition(pid))
                n = max(2, min(len(blocks), 4))
                slices = [blocks[i::n] for i in range(n)]
                slices = [s for s in slices if s] or [[]]
                bout.share(pid, len(slices))
                self.splits.append(len(slices))
                tasks.extend(([pid], s) for s in slices)
            else:
                tasks.append((g, None))
        return [self._task(bout, sout, pids, blocks, bschema, bkeys, skeys)
                for pids, blocks in tasks]

    def _task(self, bout: MapOutput, sout: MapOutput, pids, blocks, bschema,
              bkeys, skeys):
        bpart = [b for pid in pids for b in bout.read_reduce(pid)]
        if blocks is None:
            spart = [b for pid in pids for b in sout.read_reduce(pid)]
        else:
            spart = list(sout.stream_reduce(pids[0], blocks))
        sw = _str_words(bkeys, bpart, skeys, spart)
        build, bt = self._build(bpart, bschema, bkeys, sw)
        del bpart
        yield from self._run_partition(build, bt, spart, skeys, sw)


def _build_batch(out: MapOutput):
    """A converted join's build side: every block of the shuffled build,
    in partition order, concatenated once under the device budget."""
    blocks = [b for part in out.materialize().blocks for b in part]
    if not blocks:
        return None
    DeviceManager.get().reserve(sum(b.nbytes for b in blocks))
    batch = concat_batches([b.materialize() for b in blocks])
    out.close()
    return batch
