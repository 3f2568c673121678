"""Aggregate functions: sum, count, max (also of strings), avg and the
central moments; ``min`` over a window only.

Counterpart of ``spark_rapids_tpu/expr/aggregates.py``.  Each function
declares its partial buffers, how a batch updates them (``update``), how
partials combine (``merge``) and the final value (``finalize``).  These
methods run on the sort path's ``GroupPlan``; the table path
(exec/tpu_aggregate.py) lowers the same functions itself.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn
from ..kernels import aggregate as agg_k
from ..kernels.strings import string_key_words
from .core import Expression


class AggregateFunction(Expression):
    """Base aggregate; children[0] is the input, if any."""

    def __init__(self, child: Optional[Expression] = None):
        self.children = [child] if child is not None else []

    @property
    def num_buffers(self) -> int:
        return 1

    def buffer_dtypes(self) -> List[T.DType]:
        return [self.dtype()]

    def update(self, plan: agg_k.GroupPlan, cols: List[Column]):
        raise NotImplementedError

    def merge(self, plan: agg_k.GroupPlan, buffers: List[Column]):
        raise NotImplementedError

    def finalize(self, buffers: List[Column]) -> Column:
        return buffers[0]

    def columnar_eval(self, batch):
        raise AssertionError(f"{self.name} runs inside an aggregate exec")


class Sum(AggregateFunction):
    def dtype(self):
        return T.INT64 if self.children[0].dtype().is_integral else T.FLOAT64

    def update(self, plan, cols):
        c = cols[0]
        out_t = self.dtype()
        s = agg_k.seg_sum(plan, c.data, c.validity,
                          out_dtype=out_t.torch_dtype)
        cnt = agg_k.seg_count(plan, c.validity)
        return [Column(out_t, s, cnt > 0)]

    def merge(self, plan, buffers):
        return self.update(plan, buffers)


class Count(AggregateFunction):
    """count(expr), or count(*) with no child."""

    @property
    def nullable(self):
        return False

    def dtype(self):
        return T.INT64

    def update(self, plan, cols):
        if not self.children or cols[0] is None:
            cnt = agg_k.seg_count_all(plan)
        else:
            cnt = agg_k.seg_count(plan, cols[0].validity)
        return [Column(T.INT64, cnt, torch.ones_like(cnt, dtype=torch.bool))]

    def merge(self, plan, buffers):
        b = buffers[0]
        s = agg_k.seg_sum(plan, b.data, b.validity)
        return [Column(T.INT64, s, torch.ones_like(s, dtype=torch.bool))]


class Max(AggregateFunction):
    """max; of a string column, the largest string in byte order: each
    group's largest row by its string key words, gathered whole."""

    def dtype(self):
        return self.children[0].dtype()

    def update(self, plan, cols):
        c = cols[0]
        if isinstance(c, StringColumn):
            rows = agg_k.seg_argmax_words(
                plan, string_key_words(c), c.validity)
            return [c.gather(rows.clamp(min=0), rows >= 0)]
        m = agg_k.seg_max(plan, c.data, c.validity)
        cnt = agg_k.seg_count(plan, c.validity)
        return [Column(self.dtype(), m.to(self.dtype().torch_dtype),
                       cnt > 0)]

    def merge(self, plan, buffers):
        return self.update(plan, buffers)


class Min(AggregateFunction):
    """min, as a window function (``exec/tpu_window.py`` reduces it); a
    grouped ``min`` is not ported, and raises before any device work."""

    def dtype(self):
        return self.children[0].dtype()

    def update(self, plan, cols):
        raise NotImplementedError("min() as a grouped aggregate is not "
                                  "ported (only over a window)")

    merge = update


class Average(AggregateFunction):
    """avg: a double; buffers are the f64 sum and the int64 count of the
    valid inputs (both always valid), and a group with no valid input
    gives null."""

    def dtype(self):
        return T.FLOAT64

    @property
    def num_buffers(self):
        return 2

    def buffer_dtypes(self):
        return [T.FLOAT64, T.INT64]

    @staticmethod
    def _buffers(s, cnt):
        always = torch.ones_like(cnt, dtype=torch.bool)
        return [Column(T.FLOAT64, s, always), Column(T.INT64, cnt, always)]

    def update(self, plan, cols):
        c = cols[0]
        s = agg_k.seg_sum(plan, c.data, c.validity, out_dtype=torch.float64)
        return self._buffers(s, agg_k.seg_count(plan, c.validity))

    def merge(self, plan, buffers):
        s = agg_k.seg_sum(plan, buffers[0].data, buffers[0].validity)
        cnt = agg_k.seg_sum(plan, buffers[1].data, buffers[1].validity)
        return self._buffers(s, cnt)

    def finalize(self, buffers):
        s, cnt = buffers[0].data, buffers[1].data
        ok = cnt > 0
        avg = s / torch.where(ok, cnt, 1).to(torch.float64)
        return Column(T.FLOAT64, avg, ok & buffers[0].validity)


class CentralMoment(AggregateFunction):
    """Base of the variance and standard deviation family.  Buffers are
    (count, mean, M2), not sums of squares, whose difference cancels
    catastrophically; the sample forms (``ddof`` 1) of a group of one
    value are null."""

    #: 1 for the sample forms, 0 for the population forms
    ddof = 1
    #: square root at finalize (stddev) or not (variance)
    sqrt = False

    def dtype(self):
        return T.FLOAT64

    @property
    def num_buffers(self):
        return 3

    def buffer_dtypes(self):
        return [T.INT64, T.FLOAT64, T.FLOAT64]

    @staticmethod
    def _buffers(cnt, mean, m2):
        always = torch.ones_like(cnt, dtype=torch.bool)
        return [Column(T.INT64, cnt, always),
                Column(T.FLOAT64, mean, always),
                Column(T.FLOAT64, m2, always)]

    def update(self, plan, cols):
        c = cols[0]
        return self._buffers(*agg_k.seg_moments(plan, c.data, c.validity))

    def merge(self, plan, buffers):
        cnt, mean, m2 = buffers
        return self._buffers(*agg_k.seg_merge_moments(
            plan, cnt.data, mean.data, m2.data, cnt.validity))

    def finalize(self, buffers):
        n = buffers[0].data.to(torch.float64)
        ok = n > self.ddof
        v = buffers[2].data.clamp(min=0.0) / torch.where(
            ok, n - self.ddof, 1.0)
        if self.sqrt:
            v = torch.sqrt(v)
        return Column(T.FLOAT64, v, ok)


class VarianceSamp(CentralMoment):
    ddof, sqrt = 1, False


class VariancePop(CentralMoment):
    ddof, sqrt = 0, False


class StddevSamp(CentralMoment):
    ddof, sqrt = 1, True


class StddevPop(CentralMoment):
    ddof, sqrt = 0, True
