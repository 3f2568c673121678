"""Exchanges: in-process hash and range shuffle, broadcast, coalesce.

Counterpart of ``spark_rapids_tpu/exec/exchange.py`` (in-process only).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from ..columnar.batch import ColumnarBatch, concat_batches
from ..memory.arena import DeviceManager
from ..memory.catalog import SHUFFLE_OUTPUT_PRIORITY
from ..memory.spillable import SpillableBatch
from .tpu_basic import Partitions, TpuExec


class MapOutput:
    """The map side of one ``execute()``: every reduce partition's
    blocks, each a ``SpillableBatch`` in the catalog, and, for an output
    made ``with_stats`` (an adaptive operator's), each partition's
    (bytes, rows), made when the first reduce partition or the
    statistics are asked for.

    A partition's bytes are its rows' own (``SplitBatch.slice_bytes``:
    no capacity padding, and a string slice's own bytes, not the buffer
    it shares with its split batch), which the hash split then brings
    to the host with its row counts.  The statistics and the reads keep
    the reference's names
    (``partition_stats``, ``stream_reduce``, ``read_reduce``); a block is
    closed once it is read, unless more readers of its partition were
    announced (``share``)."""

    def __init__(self, exchange: "TpuShuffleExchange",
                 with_stats: bool = False):
        self.exchange = exchange
        self.with_stats = with_stats
        self.blocks: Optional[List[List[SpillableBatch]]] = None
        self.stats: Optional[List[List[int]]] = None
        #: further reads announced for a partition (``share``)
        self._readers: Dict[int, int] = {}

    def materialize(self) -> "MapOutput":
        """Run the map side, once."""
        if self.blocks is None:
            n = self.exchange.partitioner.num_partitions
            self.blocks = [[] for _ in range(n)]
            if self.with_stats:
                self.stats = [[0, 0] for _ in range(n)]
            self.exchange.write_blocks(self.blocks, self.stats)
        return self

    def partition(self, pid: int) -> List[SpillableBatch]:
        return self.materialize().blocks[pid]

    def partition_stats(self) -> List[Tuple[int, int]]:
        """(bytes, rows) of each reduce partition, from what the split
        already read to the host: no block is read or unspilled."""
        if not self.with_stats:
            raise ValueError("partition_stats: a map output made without "
                             "statistics")
        return [tuple(s) for s in self.materialize().stats]

    def share(self, pid: int, readers: int) -> None:
        """Partition ``pid`` will be read ``readers`` times: its blocks
        stay registered until the last read ends."""
        self._readers[pid] = readers

    def stream_reduce(self, pid: int, blocks=None):
        """Reduce partition ``pid`` (or ``blocks``, a part of it):
        consecutive blocks concatenated while they fit the exchange's
        ``target_rows`` (a larger one stays whole), materialised one batch
        at a time."""
        whole = blocks is None
        blocks = list(self.partition(pid) if whole else blocks)
        last = self._readers.get(pid, 1) <= 1
        target = self.exchange.target_rows
        i = 0
        while i < len(blocks):
            rows, take = blocks[i].num_rows, 1
            while i + take < len(blocks) and \
                    rows + blocks[i + take].num_rows <= target:
                rows += blocks[i + take].num_rows
                take += 1
            group = blocks[i:i + take]
            batch = concat_batches([b.materialize() for b in group])
            for b in group:
                if last:
                    b.close()
                else:
                    b.release()
            i += take
            yield batch
        if whole and last:
            self.partition(pid).clear()
        elif not last:
            self._readers[pid] -= 1

    def read_reduce(self, pid: int) -> List[ColumnarBatch]:
        return list(self.stream_reduce(pid))

    def close(self) -> None:
        for part in self.blocks or ():
            while part:
                part.pop().close()


class TpuShuffleExchange(TpuExec):
    """Splits every map-side batch by the partitioner; reduce partition i
    receives the i-th slice of each, in map order, concatenated into
    batches of at most ``target_rows`` rows, as a coalesced shuffle read
    does: each map batch would otherwise reach a join as
    ``num_partitions`` small batches, each probed on its own (a join
    over a join's output would probe ``num_partitions^2`` batches per
    map batch).

    The map side pulls its child batch by batch and registers each
    non-empty slice as a ``SpillableBatch`` at the shuffle priority,
    after ``DeviceManager.reserve`` of its bytes: past the budget the
    catalog spills blocks (these first) to the host and to disk.  A
    reduce partition materialises its blocks one at a time and closes
    each once it is in a batch.  A range exchange first stages its whole
    input, whose bounds need every row: each batch's key columns stay on
    the device for the bounds, and the batch itself is registered under
    the budget like a block (the reference keeps the staged input out of
    its budget), then split once the bounds are known.  Each reduce
    partition's own bytes and rows are counted as its blocks are made
    (``MapOutput.partition_stats``); the adaptive operators
    (``exec/adaptive.py``) run the map side through ``map_output`` and
    shape their reads from them."""

    def __init__(self, partitioner, child: TpuExec, target_rows: int):
        self.partitioner = partitioner
        self.children = [child]
        self.target_rows = target_rows
        #: the map outputs of execute() calls, until close()
        self._outputs: List[MapOutput] = []

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def _node_string(self):
        return f"TpuShuffleExchange[{self.partitioner!r}]"

    def num_partitions(self) -> int:
        return self.partitioner.num_partitions

    def execute(self) -> Partitions:
        output = self.map_output()
        return [output.stream_reduce(pid)
                for pid in range(self.partitioner.num_partitions)]

    def map_output(self, with_stats: bool = False) -> MapOutput:
        """A new map output of this exchange, written when first read
        (``MapOutput.materialize``), closed with the exchange;
        ``with_stats`` counts each reduce partition's bytes and rows."""
        output = MapOutput(self, with_stats)
        self._outputs.append(output)
        return output

    def close(self) -> None:
        while self._outputs:
            self._outputs.pop().close()
        super().close()

    def write_blocks(self, blocks: List[List[SpillableBatch]],
                     stats: Optional[List[List[int]]] = None) -> None:
        """The map side: every child batch split, its slices registered
        in ``blocks`` (one list per reduce partition) and, unless
        ``stats`` is None, counted there ([bytes, rows] per reduce
        partition; a hash split only)."""
        batches = (b for part in self.children[0].execute() for b in part
                   if b.rows_known != 0)
        manager = DeviceManager.get()
        if hasattr(self.partitioner, "fit"):
            batches = self._staged(batches, manager)
        for batch in batches:
            split = self.partitioner.split(batch) if stats is None else \
                self.partitioner.split(batch, string_bytes=True)
            del batch
            for pid, part in enumerate(blocks):
                s = split.partition_slice(pid)
                if s is not None:
                    manager.reserve(s.nbytes())
                    if stats is not None:
                        stats[pid][0] += split.slice_bytes(pid, s)
                        stats[pid][1] += s.num_rows
                    part.append(SpillableBatch(s, SHUFFLE_OUTPUT_PRIORITY))

    def _staged(self, batches, manager: DeviceManager):
        """A range exchange's input: every batch staged in the catalog and
        its key columns kept for the bounds; then, once the partitioner
        is fit, each batch in order, unstaged as it is taken."""
        keys, staged = [], []
        try:
            for b in batches:
                if b.num_rows == 0:
                    continue
                keys.append((self.partitioner.key_columns(b), b.num_rows))
                manager.reserve(b.nbytes())
                staged.append(SpillableBatch(b))
            b = None
            self.partitioner.fit(keys)
            keys = None
            for sb in staged:
                batch = sb.materialize()
                sb.close()
                yield batch
        finally:
            for sb in staged:
                sb.close()


class TpuBroadcastExchange(TpuExec):
    """Collects the child into one batch that every consumer shares."""

    def __init__(self, child: TpuExec):
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def broadcast_batch(self) -> Optional[ColumnarBatch]:
        batches = [b for part in self.children[0].execute() for b in part]
        batches = [b for b in batches if b.num_rows > 0]
        if not batches:
            return None
        return concat_batches(batches)

    def execute(self) -> Partitions:
        def one():
            b = self.broadcast_batch()
            if b is not None:
                yield b
        return [one()]


class TpuCoalescePartitions(TpuExec):
    """Every partition of the child, in order, as one partition."""

    def __init__(self, child: TpuExec):
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def execute(self) -> Partitions:
        return [itertools.chain.from_iterable(self.children[0].execute())]
