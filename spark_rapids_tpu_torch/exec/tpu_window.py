"""The window operator.

Counterpart of ``spark_rapids_tpu/exec/tpu_window.py`` ``TpuWindow``
(without its ``collect_list`` frames, which need a list column).  Each
input partition is concatenated into one batch.  The functions of one
PARTITION BY / ORDER BY share one stable sort of the rows by
(partition words, order words) (``canon.batch_key_words``: ints, floats,
strings, DATE and BOOL, DESC and NULLS FIRST / LAST); segments are the
runs of equal partition words, peers the runs of equal words of both.
Then, per function, over the sorted rows (``kernels/window.py``):

- ``row_number``, ``rank``, ``dense_rank``, ``ntile``, ``percent_rank``,
  ``cume_dist`` from each row's place in its segment and its peer run;
- ``lead`` / ``lag``: the row ``offset`` places on, NULL outside the
  segment (numbers and strings);
- ``sum``, ``count``, ``avg``, ``min``, ``max`` over the whole partition
  (no ORDER BY, or a frame unbounded on both sides), a ROWS frame
  (offsets in rows), or a RANGE frame: by peers when its bounds are
  CURRENT ROW or unbounded, by the values of one integer, DATE or
  DECIMAL order key otherwise (a DECIMAL's offsets scale by ``10^s``,
  as the reference's ``tpu_window.py:376``).  A DECIMAL ``sum`` adds
  its unscaled int64s exactly (their 32-bit halves apart), NULL where
  the frame's sum does not fit ``decimal(min(p + 10, 18), s)``; a
  DECIMAL ``avg`` is a double of the values.

The results go back to input order through the inverse permutation (one
scatter of ``arange``), so each row keeps its columns and gains one per
function.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..columnar import dtypes as T
from ..columnar.batch import ColumnarBatch, concat_batches
from ..columnar.column import Column
from ..expr import aggregates as eagg
from ..expr import core as ec
from ..expr import window_funcs as wfn
from ..kernels import canon
from ..kernels import decimal as dk
from ..kernels import window as wk
from ..kernels.sort import sorted_words
from ..plan.logical import Window, WindowFunc, WindowSpec
from .tpu_basic import Partitions, TpuExec

#: the aggregates a window reduces
WINDOW_AGGREGATES = (eagg.Sum, eagg.Count, eagg.Average, eagg.Min,
                     eagg.Max)


def check_window_func(wf: WindowFunc) -> None:
    """Raise ``NotImplementedError`` for a window function, input or
    frame the operator does not run, before any device work."""
    f, spec = wf.func, wf.spec
    kind, lo, hi = spec.frame
    if kind not in ("rows", "range"):
        raise NotImplementedError(f"a {kind!r} window frame is not "
                                  f"supported by the port")
    if lo is not None and hi is not None and lo > hi:
        raise NotImplementedError(f"a window frame from {lo} to {hi} is "
                                  f"not supported by the port")
    if isinstance(f, wfn.WindowFunction):
        return
    if not isinstance(f, WINDOW_AGGREGATES):
        raise NotImplementedError(f"{f.name} over a window is not "
                                  f"supported by the port")
    if f.children:
        dt = f.children[0].dtype()
        numeric = dt.is_numeric
        if isinstance(f, (eagg.Min, eagg.Max)):
            numeric = numeric or dt == T.DATE
        if not numeric and not isinstance(f, eagg.Count):
            raise NotImplementedError(
                f"{f.name.lower()}() of a {dt} column over a window is not "
                f"supported by the port")
    if kind == "range" and spec.order_by and not (
            lo in (None, 0) and hi in (None, 0)):
        if len(spec.order_by) != 1:
            raise NotImplementedError("a RANGE frame with offsets over "
                                      "more than one ORDER BY key is not "
                                      "supported by the port")
        odt = spec.order_by[0].expr.dtype()
        if not (odt.is_integral or odt.is_decimal or odt == T.DATE):
            raise NotImplementedError(f"a RANGE frame with offsets over a "
                                      f"{odt} order key is not supported "
                                      f"by the port")


class _Sorted:
    """One spec's sort of a batch: the permutation, its inverse, the
    segments and the peer runs."""

    def __init__(self, batch: ColumnarBatch, spec: WindowSpec):
        cap = batch.capacity
        live_in = batch.live_mask()
        pcols = [ec.eval_as_column(e.bind(batch.schema), batch)
                 for e in spec.partition_by]
        ocols = [ec.eval_as_column(o.expr.bind(batch.schema), batch)
                 for o in spec.order_by]
        pwords = canon.batch_key_words(pcols, live_in) if pcols else \
            [torch.where(live_in, 1, 2)]
        owords = canon.batch_key_words(
            ocols, live_in, descending=[not o.ascending
                                        for o in spec.order_by],
            nulls_last=[not o.nulls_first for o in spec.order_by]) \
            if ocols else []
        ws, self.perm = sorted_words(pwords + owords)
        self.live = ws[0] != 2
        self.inv = torch.empty_like(self.perm)
        self.inv[self.perm] = torch.arange(cap, device=batch.device)
        self.segs = wk.segments(
            canon.words_equal_adjacent(ws[:len(pwords)]) & self.live,
            self.live)
        self.run_id, self.run_start, self.run_end = wk.runs(
            canon.words_equal_adjacent(ws) & self.live, self.live)
        self.ocols = ocols


class TpuWindow(TpuExec):
    def __init__(self, logical: Window, child: TpuExec):
        for wf in logical.window_funcs:
            check_window_func(wf)
        self.window_funcs = logical.window_funcs
        self.schema = logical.schema
        self.children = [child]

    @property
    def output_schema(self):
        return self.schema

    def _node_string(self):
        return f"TpuWindow[{[wf.alias for wf in self.window_funcs]}]"

    def execute(self) -> Partitions:
        return [self._partition(part) for part in self.children[0].execute()]

    def _partition(self, part):
        batches = [b for b in part if b.num_rows > 0]
        if batches:
            yield self._apply(concat_batches(batches))

    def _apply(self, batch: ColumnarBatch) -> ColumnarBatch:
        sorts: Dict[str, _Sorted] = {}
        cols: List[Column] = list(batch.columns)
        for wf in self.window_funcs:
            key = wf.spec.sort_key()
            if key not in sorts:
                sorts[key] = _Sorted(batch, wf.spec)
            cols.append(self._eval(batch, wf, sorts[key]))
        return ColumnarBatch(self.schema, cols, batch.rows,
                             device=batch.device)

    # ------------------------------------------------------------------
    def _eval(self, batch: ColumnarBatch, wf: WindowFunc, s: _Sorted
              ) -> Column:
        f = wf.func
        in_live = batch.live_mask()
        if isinstance(f, (wfn.Lead, wfn.Lag)):
            return self._offset(batch, f, s, in_live)
        if isinstance(f, wfn.WindowFunction):
            vals = self._rank_like(f, s)
            dt = f.dtype()
            return Column(dt, vals[s.inv].to(dt.torch_dtype), in_live)
        vals, ok = self._aggregate(batch, f, wf.spec, s)
        dt = f.dtype()
        return Column(dt, vals[s.inv].to(dt.torch_dtype),
                      ok[s.inv] & in_live)

    @staticmethod
    def _rank_like(f, s: _Sorted) -> torch.Tensor:
        segs = s.segs
        row = segs.row_in_seg
        length = segs.end - segs.start + 1
        if isinstance(f, wfn.RowNumber):
            return row + 1
        rank = s.run_start - segs.start + 1
        if isinstance(f, wfn.Rank):
            return rank
        if isinstance(f, wfn.DenseRank):
            return s.run_id - s.run_id[segs.start] + 1
        if isinstance(f, wfn.NTile):
            base, rem = length // f.n, length % f.n
            cut = rem * (base + 1)
            return torch.where(row < cut, row // (base + 1),
                               rem + (row - cut) // base.clamp(min=1)) + 1
        if isinstance(f, wfn.PercentRank):
            return torch.where(length > 1, (rank - 1).to(torch.float64) /
                               (length - 1).clamp(min=1).to(torch.float64),
                               0.0)
        if isinstance(f, wfn.CumeDist):
            return (s.run_end - segs.start + 1).to(torch.float64) / \
                length.clamp(min=1).to(torch.float64)
        raise NotImplementedError(f"window function {f.name}")

    @staticmethod
    def _offset(batch, f, s: _Sorted, in_live) -> Column:
        """lead / lag: input row r (sorted position p) takes the source of
        the row at sorted position p + offset if that row is live and in
        p's segment, else NULL; one gather of the source."""
        cap = batch.capacity
        off = f.offset if isinstance(f, wfn.Lead) else -f.offset
        src = ec.eval_as_column(f.children[0].bind(batch.schema), batch)
        p = s.inv
        q = p + off
        qc = q.clamp(0, cap - 1)
        same = (q >= 0) & (q < cap) & (s.segs.seg[qc] == s.segs.seg[p]) & \
            s.live[qc] & in_live
        return src.gather(s.perm[qc], same)

    def _aggregate(self, batch, f, spec: WindowSpec, s: _Sorted):
        """(value, valid) per sorted row of an aggregate over its frame."""
        segs = s.segs
        cap = batch.capacity
        if f.children:
            src = ec.eval_as_column(f.children[0].bind(batch.schema), batch)
            # a count reads the validity alone: a string's bytes are no
            # per-row data to gather by the row permutation
            sv = None if isinstance(f, eagg.Count) else src.data[s.perm]
            sok = src.validity[s.perm] & s.live
        else:                                   # count(*)
            sv = torch.ones(cap, dtype=torch.int64, device=batch.device)
            sok = s.live
        kind, lo, hi = spec.frame
        pos = segs.pos
        if not spec.order_by or (lo is None and hi is None):
            first, last = segs.start, segs.end
            whole = True
        else:
            whole = False
            if kind == "rows":
                first = segs.start if lo is None else \
                    torch.maximum(pos + lo, segs.start)
                last = segs.end if hi is None else \
                    torch.minimum(pos + hi, segs.end)
            elif lo in (None, 0) and hi in (None, 0):
                # CURRENT ROW of a RANGE frame is the row's peers
                first = segs.start if lo is None else s.run_start
                last = segs.end if hi is None else s.run_end
            else:
                first, last = self._range(batch, spec, s)
        empty = last < first
        cnt = wk.prefix_diff(torch.cumsum(sok.to(torch.int64), 0),
                             first, last)
        if isinstance(f, eagg.Count):
            return cnt, torch.ones_like(sok)
        has = (cnt > 0) & ~empty
        if isinstance(f, (eagg.Min, eagg.Max)):
            return self._minmax(f, sv, sok, segs, first, last, whole,
                                lo, hi, kind), has
        acc_int = isinstance(f, eagg.Sum) and f.dtype() == T.INT64
        if acc_int:
            x = torch.where(sok, sv.to(torch.int64), 0)
            return wk.prefix_diff(torch.cumsum(x, 0), first, last), has
        src_t = f.children[0].dtype()
        if isinstance(f, eagg.Sum) and src_t.is_decimal:
            hi, lo = dk.split_halves(torch.where(sok, sv, 0))
            total, ok = dk.join_halves(*(
                wk.prefix_diff(torch.cumsum(h, 0), first, last)
                for h in (hi, lo)))
            return total, has & ok & dk.fits(total, f.dtype().precision)
        if src_t.is_decimal:
            sv = dk.to_double(sv, src_t.scale)
        x = torch.where(sok, sv.to(torch.float64), 0.0)
        if whole:
            total = wk.whole_sum(x, segs)
        elif lo is None:
            total = wk.seg_scan(x, segs.row_in_seg, torch.add, 0.0)[
                last.clamp(0, cap - 1)]
        elif hi is None:
            total = wk.seg_scan(x, segs.end - pos, torch.add, 0.0,
                                reverse=True)[first.clamp(0, cap - 1)]
        else:
            total = wk.block_sum(x, first, last,
                                 self._widest(first, last, kind, lo, hi))
        if isinstance(f, eagg.Average):
            total = total / cnt.clamp(min=1).to(torch.float64)
        return total, has

    @staticmethod
    def _widest(first, last, kind, lo, hi) -> int:
        """The widest frame: from the offsets for ROWS, one host read for
        RANGE (as the reference reads it)."""
        if kind == "rows":
            return max(hi - lo + 1, 1)
        return max(int((last - first + 1).max()), 1)

    def _minmax(self, f, sv, sok, segs, first, last, whole, lo, hi, kind):
        is_min = isinstance(f, eagg.Min)
        ident = wk.I64_MAX if is_min else wk.I64_MIN
        op = torch.minimum if is_min else torch.maximum
        x = torch.where(sok, wk.order_ints(sv), ident)
        cap = x.shape[0]
        if whole or lo is None:
            w = wk.seg_scan(x, segs.row_in_seg, op, ident)[
                last.clamp(0, cap - 1)]
        elif hi is None:
            w = wk.seg_scan(x, segs.end - segs.pos, op, ident,
                            reverse=True)[first.clamp(0, cap - 1)]
        else:
            w = wk.sparse_minmax(x, first, last,
                                 self._widest(first, last, kind, lo, hi),
                                 op, ident)
        return wk.from_order_ints(w, f.dtype().torch_dtype)

    @staticmethod
    def _range(batch, spec: WindowSpec, s: _Sorted):
        """A RANGE frame with value offsets over its one integer, DATE or
        DECIMAL order key (``kernels/window.range_positions``)."""
        o = spec.order_by[0]
        col = s.ocols[0]
        v = col.data[s.perm].to(torch.int64)
        u = v if o.ascending else -v
        _, lo, hi = spec.frame
        if col.dtype.is_decimal:
            # the offsets in the key's unscaled units
            lo, hi = (None if x is None else T.unscaled_of(x, col.dtype.scale)
                      for x in (lo, hi))
        return wk.range_positions(u, col.validity[s.perm] & s.live, s.segs,
                                  lo, hi, o.nulls_first)
