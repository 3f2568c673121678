"""Exchanges: in-process hash and range shuffle, broadcast, coalesce.

Counterpart of ``spark_rapids_tpu/exec/exchange.py`` (in-process only).
"""
from __future__ import annotations

import itertools
from typing import List, Optional

from ..columnar.batch import ColumnarBatch, concat_batches
from ..memory.arena import DeviceManager
from ..memory.catalog import SHUFFLE_OUTPUT_PRIORITY
from ..memory.spillable import SpillableBatch
from .tpu_basic import Partitions, TpuExec


class _MapOutput:
    """The map side of one ``execute()``: every reduce partition's
    blocks, each a ``SpillableBatch`` in the catalog, made when the
    first reduce partition is read."""

    def __init__(self, exchange: "TpuShuffleExchange"):
        self.exchange = exchange
        self.blocks: Optional[List[List[SpillableBatch]]] = None

    def partition(self, pid: int) -> List[SpillableBatch]:
        if self.blocks is None:
            self.blocks = [[] for _ in
                           range(self.exchange.partitioner.num_partitions)]
            self.exchange.write_blocks(self.blocks)
        return self.blocks[pid]

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
    its budget), then split once the bounds are known."""

    def __init__(self, partitioner, child: TpuExec, target_rows: int):
        self.partitioner = partitioner
        self.children = [child]
        self.target_rows = target_rows
        #: the map outputs of execute() calls, until close()
        self._outputs: List[_MapOutput] = []

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def _node_string(self):
        return f"TpuShuffleExchange[{self.partitioner!r}]"

    def num_partitions(self) -> int:
        return self.partitioner.num_partitions

    def execute(self) -> Partitions:
        output = _MapOutput(self)
        self._outputs.append(output)
        return [self._read(output, pid)
                for pid in range(self.partitioner.num_partitions)]

    def close(self) -> None:
        while self._outputs:
            self._outputs.pop().close()
        super().close()

    def write_blocks(self, blocks: List[List[SpillableBatch]]) -> None:
        """The map side: every child batch split, its slices registered
        in ``blocks`` (one list per reduce partition)."""
        batches = (b for part in self.children[0].execute() for b in part
                   if b.rows_known != 0)
        manager = DeviceManager.get()
        if hasattr(self.partitioner, "fit"):
            batches = self._staged(batches, manager)
        for batch in batches:
            split = self.partitioner.split(batch)
            del batch
            for pid, part in enumerate(blocks):
                s = split.partition_slice(pid)
                if s is not None:
                    manager.reserve(s.nbytes())
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

    def _read(self, output: _MapOutput, pid: int):
        """Reduce partition ``pid``: consecutive blocks concatenated
        while they fit ``target_rows`` (a larger one stays whole), each
        block closed once it is in a batch."""
        blocks = output.partition(pid)
        while blocks:
            rows, take = blocks[0].num_rows, 1
            while take < len(blocks) and \
                    rows + blocks[take].num_rows <= self.target_rows:
                rows += blocks[take].num_rows
                take += 1
            group = blocks[:take]
            batch = concat_batches([b.materialize() for b in group])
            del blocks[:take]
            for b in group:
                b.close()
            yield batch


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
