"""Sort and top-N: each partition's rows in the order of its sort keys.

Counterpart of ``TpuSort`` and ``TpuTopN`` in
``spark_rapids_tpu/exec/tpu_sort.py``.  A batch sorts by its order words
(``canon.batch_key_words``: inverted for descending keys, with each key's
null rank) through chained stable ``torch.sort`` passes
(``kernels/sort.sort_permutation``); equal rows keep their input order.
Under a range exchange, partition i holds rows that sort before those of
partition i + 1, so the partitions in order are the global order.

``TpuSort`` has the reference's three modes.  Each input batch is sorted
into a run, admitted under the device budget (``DeviceManager.reserve``)
and registered as a ``SpillableBatch``, so that the catalog may spill
runs while more input streams in.  One run is the partition's output;
runs of at most ``chunk_rows`` rows in all are concatenated and sorted
once more; more than that merge out of core: ``samples`` key samples of
each run (taken while the run is on the device; a run that had been
spilled goes back down after) choose cuts among all samples, extended
by the run and the position so that duplicate keys still split, and
each output chunk uploads only each run's candidate slice
(``acquire_slice``), keeps the rows of its half-open range and sorts
them.  Every mode gives the bytes one stable sort of the partition
gives.  ``TpuTopN`` (a limit right over a global sort) needs no
exchange: each partition keeps its first ``n`` sorted rows, and one
final sort of those picks the first ``n`` of all.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..columnar.batch import ColumnarBatch, concat_batches
from ..columnar.column import StringColumn
from ..expr import core as ec
from ..kernels import canon
from ..kernels.basic import as_signed64, compact_indices, ult64
from ..kernels.sort import sort_permutation
from ..kernels.strings import needed_key_words
from ..memory.arena import DeviceManager
from ..memory.spillable import SpillableBatch
from .tpu_basic import Partitions, TpuExec


def _key_words(cols, live, orders, str_words=None):
    return canon.batch_key_words(
        cols, live, descending=[not o.ascending for o in orders],
        nulls_last=[not o.nulls_first for o in orders], str_words=str_words)


def sort_batch(batch: ColumnarBatch, exprs, orders) -> ColumnarBatch:
    """The batch's live rows in the order of ``orders`` (``exprs`` are
    their bound keys); reads the row count."""
    cols = [ec.eval_as_column(e, batch) for e in exprs]
    words = _key_words(cols, batch.live_mask(), orders)
    return batch.gather(sort_permutation(words), batch.num_rows)


def _void_keys(words: np.ndarray) -> np.ndarray:
    """[m, w] uint64 words -> m big-endian keys whose byte order is the
    words' lexicographic order."""
    m = np.ascontiguousarray(words.astype(">u8"))
    return m.view(np.dtype((np.void, 8 * m.shape[1]))).reshape(-1)


def _bound_words(key) -> List[int]:
    return [as_signed64(int(v)) for v in np.frombuffer(bytes(key), ">u8")]


def _less(words: List[torch.Tensor], bound: List[int]) -> torch.Tensor:
    """Rows whose word tuple is below ``bound`` (unsigned, lexicographic)."""
    lt = torch.zeros(words[0].shape[0], dtype=torch.bool,
                     device=words[0].device)
    eq = torch.ones_like(lt)
    for w, b in zip(words, bound):
        lt |= eq & ult64(w, b)
        eq &= w == b
    return lt


class TpuSort(TpuExec):
    def __init__(self, orders, child: TpuExec, chunk_rows: int = 1 << 22,
                 samples: int = 256):
        self.orders = orders
        self.children = [child]
        self.chunk_rows = chunk_rows
        self.samples = samples
        #: the runs of partitions being sorted, until they end or close()
        self._open: List[List[SpillableBatch]] = []
        #: partitions merged out of core, and their output chunks, in the
        #: last execute()
        self.ooc_counts = {"partitions": 0, "chunks": 0}

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def execute(self) -> Partitions:
        schema = self.children[0].output_schema
        exprs = [o.expr.bind(schema) for o in self.orders]
        self.ooc_counts = {"partitions": 0, "chunks": 0}
        return [self._sort_partition(part, exprs)
                for part in self.children[0].execute()]

    def close(self) -> None:
        for runs in self._open:
            for r in runs:
                r.close()
        self._open = []
        super().close()

    def _sort_partition(self, part, exprs):
        runs: List[SpillableBatch] = []
        self._open.append(runs)
        try:
            manager = DeviceManager.get()
            total = 0
            for b in part:
                if b.num_rows == 0:
                    continue
                run = sort_batch(b, exprs, self.orders)
                del b
                manager.reserve(run.nbytes())
                runs.append(SpillableBatch(run))
                total += run.num_rows
                del run
            if len(runs) == 1:
                yield runs[0].materialize()
            elif runs and total <= self.chunk_rows:
                merged = concat_batches([r.materialize() for r in runs])
                for r in runs:
                    r.close()
                yield sort_batch(merged, exprs, self.orders)
            elif runs:
                self.ooc_counts["partitions"] += 1
                yield from self._merge_out_of_core(runs, total, exprs)
        finally:
            for r in runs:
                r.close()
            self._open = [x for x in self._open if x is not runs]

    # -- out-of-core merge ----------------------------------------------------
    def _run_samples(self, run: ColumnarBatch, exprs):
        """(sample positions, the key columns at them, string widths) of a
        sorted run on the device."""
        n = run.num_rows
        pos = np.unique(np.linspace(0, n - 1, min(n, self.samples))
                        .astype(np.int64))
        idx = torch.from_numpy(pos).to(run.device)
        cols = [ec.eval_as_column(e, run) for e in exprs]
        strw = [needed_key_words(c) if isinstance(c, StringColumn) else None
                for c in cols]
        return pos, [c.gather(idx) for c in cols], strw

    def _merge_out_of_core(self, runs: List[SpillableBatch], total: int,
                           exprs):
        sampled = []
        for spill in runs:
            was_spilled = spill.is_spilled()
            sampled.append(self._run_samples(spill.materialize(), exprs))
            spill.release()
            if was_spilled:
                # sampling must not leave every spilled run on the device
                spill.demote()
        widths = [None if ws[0] is None else max(ws)
                  for ws in zip(*(s[2] for s in sampled))]
        run_keys = []
        for ri, (pos, cols, _) in enumerate(sampled):
            live = torch.ones(len(pos), dtype=torch.bool,
                              device=cols[0].device)
            words = _key_words(cols, live, self.orders, widths)
            m = torch.stack(words, 1).cpu().numpy().view(np.uint64)
            tie = np.stack([np.full(len(pos), ri, np.uint64),
                            pos.astype(np.uint64)], 1)
            run_keys.append(_void_keys(np.concatenate([m, tie], 1)))
        merged = np.sort(np.concatenate(run_keys))
        n_chunks = max(1, -(-total // self.chunk_rows))
        cuts = np.unique(merged[(np.arange(1, n_chunks) * len(merged)) //
                                n_chunks])
        bounds = [None] + list(cuts) + [None]
        for b_lo, b_hi in zip(bounds[:-1], bounds[1:]):
            pieces = []
            for ri, (spill, (pos, _, _), keys) in enumerate(
                    zip(runs, sampled, run_keys)):
                n = spill.num_rows
                lo = 0 if b_lo is None else int(
                    pos[max(np.searchsorted(keys, b_lo, "left") - 1, 0)])
                j = len(pos) if b_hi is None else \
                    int(np.searchsorted(keys, b_hi, "left"))
                hi = n if j >= len(pos) else int(pos[j])
                if hi <= lo:
                    continue
                piece = self._in_range(spill.materialize_slice(lo, hi),
                                       exprs, widths, ri, lo, b_lo, b_hi)
                if piece.num_rows:
                    pieces.append(piece)
            if pieces:
                self.ooc_counts["chunks"] += 1
                yield sort_batch(concat_batches(pieces), exprs, self.orders)

    def _in_range(self, piece: ColumnarBatch, exprs, widths, run: int,
                  offset: int, b_lo, b_hi) -> ColumnarBatch:
        """The rows of a run's slice (starting at row ``offset``) whose
        (key words, run, position) lie in ``[b_lo, b_hi)``."""
        if b_lo is None and b_hi is None:
            return piece
        cap = piece.capacity
        dev = piece.device
        cols = [ec.eval_as_column(e, piece) for e in exprs]
        words = _key_words(cols, piece.live_mask(), self.orders, widths)
        words += [torch.full((cap,), run, dtype=torch.int64, device=dev),
                  torch.arange(cap, dtype=torch.int64, device=dev) + offset]
        keep = torch.ones(cap, dtype=torch.bool, device=dev)
        if b_lo is not None:
            keep &= ~_less(words, _bound_words(b_lo))
        if b_hi is not None:
            keep &= _less(words, _bound_words(b_hi))
        idx, cnt = compact_indices(keep, piece.num_rows)
        return piece.gather(idx, int(cnt))


class TpuTopN(TpuExec):
    """The first ``n`` rows of a global sort, in one partition: a sort
    and slice per partition, then one sort of the survivors."""

    def __init__(self, n: int, orders, child: TpuExec):
        self.n = n
        self.orders = orders
        self.children = [child]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def _node_string(self):
        return f"TpuTopN[{self.n}]"

    def _top(self, batches, exprs) -> ColumnarBatch:
        s = sort_batch(concat_batches(batches), exprs, self.orders)
        return s.slice(0, self.n) if s.num_rows > self.n else s

    def execute(self) -> Partitions:
        schema = self.children[0].output_schema
        exprs = [o.expr.bind(schema) for o in self.orders]
        parts = self.children[0].execute()

        def run():
            tops = []
            for part in parts:
                batches = [b for b in part if b.num_rows > 0]
                if batches and self.n > 0:
                    tops.append(self._top(batches, exprs))
            if tops:
                yield self._top(tops, exprs)
        return [run()]
