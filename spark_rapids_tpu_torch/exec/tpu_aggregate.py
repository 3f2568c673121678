"""Hash aggregate: partial (update) and final (merge) modes.

Counterpart of ``spark_rapids_tpu/exec/tpu_aggregate.py``.  Each batch
first tries the sort-free table core (``_table_core``): fold the staged
filter/project chain into a live mask, pack the keys into bucket ids
(``table_bucket``), reduce every aggregate's input column in one
``table_stage`` kernel launch, then build the group directory
(``table_compact``) and finish each aggregate from its [table] tables.
The kernel computes, per row, what the reference builds as separate
arrays beside its reduce kernel:

- exact f64 sums: each value splits into its two f32 components, each
  component into signed 8-bit chunks on a 120-bit window anchored at the
  batch's largest exponent; the i32 chunk lanes add with integer
  atomics, which are order-independent, so exact mode is deterministic
  on the card, and recombine per bucket in f64 after the launch;
- exact f64 max: one u64 order word per row (the reference's two-stage
  u32 max in one 64-bit max).  An integer max takes the same word: an
  integer of magnitude at most 2^48 is exact as an f64 and as the word's
  f32 pair; a batch with a larger one runs the sort path.

The batch's largest exponent and the fit conditions stay torch ops
before the launch.  A device fit flag says whether the batch fit the
table; its value is read per batch, and a batch that did not fit runs
the sort path (``groupby_plan`` and the ``seg_*`` reductions).

Variable float mode (``variableFloatAgg.enabled``) sums its values in
the kernel in f64 (the atomics reorder additions from run to run) and
takes its maxes in f32.
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar import dtypes as T
from ..columnar.batch import ColumnarBatch, concat_batches
from ..columnar.column import Column
from ..columnar.schema import Field, Schema
from ..expr import core as ec
from ..expr import aggregates as ea
from ..kernels import aggregate as agg_k
from ..kernels import canon
from ..kernels.aggregate import CH_W0, chunk_recombine, f32_exp, unflip32
from ..kernels.basic import SIGN64
from ..kernels.cuda_ops import StageCol, table_stage
from ..plan.logical import AggExpr
from .tpu_basic import TpuExec, apply_ops_masked

PARTIAL, FINAL = "partial", "final"
#: largest integer magnitude the table path's max word holds exactly
INT_MAX_EXACT = 1 << 48

def buffer_schema(group_exprs, aggs: List[AggExpr]) -> Schema:
    """Schema of partial-aggregation output: keys + flattened buffers."""
    fields = [Field(ec.output_name(e), e.dtype(), True) for e in group_exprs]
    for a in aggs:
        for bi, bt in enumerate(a.func.buffer_dtypes()):
            fields.append(Field(f"__{a.alias}__buf{bi}", bt, True))
    return Schema(fields)


def _key_ok(dt) -> bool:
    return dt.is_integral or dt == T.BOOL


class TpuHashAggregate(TpuExec):
    """Grouped aggregation.  PARTIAL turns input rows into buffer rows
    (one batch per partition); FINAL merges buffer rows and finalizes.
    ``pre_ops`` is a filter/project chain the planner staged in front of
    a PARTIAL aggregate: ``[(kind, payload, out_schema)]``."""

    def __init__(self, group_exprs: List[ec.Expression], aggs: List[AggExpr],
                 child: TpuExec, mode: str, table: int,
                 variable_float: bool):
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.children = [child]
        self.mode = mode
        self.table = table
        self.variable_float = variable_float
        self.pre_ops = None
        #: batches per path in the last execute(), for tests and tools
        self.path_counts = {"table": 0, "sort": 0}

    @property
    def output_schema(self):
        if self.mode == PARTIAL:
            return buffer_schema(self.group_exprs, self.aggs)
        fields = [Field(ec.output_name(e), e.dtype(), True)
                  for e in self.group_exprs]
        fields += [Field(a.alias, a.func.dtype(), a.func.nullable)
                   for a in self.aggs]
        return Schema(fields)

    def _node_string(self):
        ws = f", staged={len(self.pre_ops)} ops" if self.pre_ops else ""
        return f"TpuHashAggregate[{self.mode}{ws}]"

    # -- driver -------------------------------------------------------------
    def execute(self):
        self.path_counts = {"table": 0, "sort": 0}
        out = []
        for part in self.children[0].execute():
            batches = [b for b in part if b.rows_known != 0]
            if self.mode == PARTIAL:
                partials = [self._aggregate(b, update=True) for b in batches]
                if not partials:
                    out.append([])
                    continue
                merged = concat_batches(partials)
                if len(partials) > 1:
                    merged = self._aggregate(merged, update=False)
                out.append([merged])
            else:
                if not batches:
                    out.append([])
                    continue
                merged = self._aggregate(concat_batches(batches),
                                         update=False)
                out.append([self._finalize(merged)])
        return out

    def _aggregate(self, batch: ColumnarBatch, update: bool) -> ColumnarBatch:
        """One batch to buffer rows: the table core when the batch fits,
        else the sort path.  Reads the fit flag and group count."""
        res = self._table_core(batch, update)
        if res is not None:
            out, fit = res
            fit_h, ng = torch.stack([fit.to(torch.int64),
                                     out.rows_dev]).tolist()
            if fit_h:
                self.path_counts["table"] += 1
                out._rows_host = ng
                return out
        self.path_counts["sort"] += 1
        return self._sort_aggregate(batch, update)

    def _finalize(self, buf: ColumnarBatch) -> ColumnarBatch:
        nk = len(self.group_exprs)
        cols = list(buf.columns[:nk])
        pos = nk
        for a in self.aggs:
            nb = a.func.num_buffers
            cols.append(a.func.finalize(buf.columns[pos:pos + nb]))
            pos += nb
        return ColumnarBatch(self.output_schema, cols, buf.rows,
                             device=buf.device)

    def _bound_inputs(self, schema: Schema, update: bool):
        """(key exprs, per-agg input exprs) bound to the batch schema."""
        if update:
            post = self.pre_ops[-1][2] if self.pre_ops else schema
            keys = [e.bind(post) for e in self.group_exprs]
            inputs = [[c.bind(post) for c in a.func.children]
                      for a in self.aggs]
            return keys, inputs
        nk = len(self.group_exprs)
        keys = [ec.BoundReference(i, f.dtype, True, f.name)
                for i, f in enumerate(list(schema)[:nk])]
        inputs, pos = [], nk
        for a in self.aggs:
            nb = a.func.num_buffers
            inputs.append([ec.BoundReference(pos + j, schema[pos + j].dtype)
                           for j in range(nb)])
            pos += nb
        return keys, inputs

    # -- sort path ----------------------------------------------------------
    def _sort_aggregate(self, batch: ColumnarBatch,
                        update: bool) -> ColumnarBatch:
        keys, inputs = self._bound_inputs(batch.schema, update)
        live = batch.live_mask()
        if update:
            b, live = apply_ops_masked(self.pre_ops, batch, live)
        else:
            b = batch
        key_cols = [ec.eval_as_column(e, b) for e in keys]
        words = canon.batch_key_words(key_cols, live)
        plan = agg_k.groupby_plan(words)
        cap = batch.capacity
        ng = plan.num_groups
        gi = torch.arange(cap, device=batch.device)
        glive = gi < ng
        take = torch.where(glive, plan.rep_indices, 0)
        out_cols = [c.gather(take, glive) for c in key_cols]
        for a, bs in zip(self.aggs, inputs):
            # rows a filter dropped count as null inputs
            cols = [ec.eval_as_column(e, b).mask_validity(live) for e in bs]
            bufs = a.func.update(plan, cols or [None]) if update \
                else a.func.merge(plan, cols)
            out_cols.extend(c.mask_validity(glive) for c in bufs)
        return ColumnarBatch(buffer_schema(self.group_exprs, self.aggs),
                             out_cols, ng, device=batch.device)

    # -- table path ---------------------------------------------------------
    def _descs(self, inputs, update: bool):
        """Per-agg lowering for the table core, or None if any agg (or
        key) cannot take it."""
        descs = []
        for a, bs in zip(self.aggs, inputs):
            f = a.func
            cdt = bs[0].dtype() if bs else None
            if isinstance(f, ea.Count):
                descs.append("count" if update else "icount")
            elif isinstance(f, ea.Sum) and cdt is not None and \
                    cdt.is_fractional:
                descs.append("fsumv" if self.variable_float else "fsum64")
            elif isinstance(f, ea.Max) and cdt is not None and \
                    cdt.is_fractional:
                descs.append("fmax" if self.variable_float else "fmax64")
            elif isinstance(f, ea.Max) and cdt is not None and \
                    cdt.is_integral:
                descs.append("fmax64")
            else:
                return None
        return descs

    @staticmethod
    def _stage_col(kind: str, c: Column, live: torch.Tensor):
        """(the stage's input column for one aggregate, its fit flag)."""
        valid = c.validity.contiguous()
        if kind in ("count", "icount"):
            data = c.data.to(torch.int64).contiguous() \
                if kind == "icount" else None
            return StageCol(kind, data, valid), True
        v = c.data.to(torch.float64).contiguous()
        ok = live & valid
        if kind == "fsumv":
            return StageCol(kind, v, valid), True
        if kind == "fsum64":
            okf = ok & torch.isfinite(v)
            hi32 = torch.where(okf, v, 0.0).to(torch.float32)
            # a finite f64 beyond f32 range cannot sit on the lanes
            fit = torch.where(okf, torch.isfinite(hi32), True).all()
            ehi, sighi, _ = f32_exp(hi32)
            contrib = okf & (sighi != 0)
            emax = torch.where(contrib, ehi, 0).max()
            emin = torch.where(contrib, ehi, 255).min()
            # exponent spread beyond the window -> exact sort path
            fit = fit & ((emax - emin) <= CH_W0 - 25)
            return StageCol(kind, v, valid, emax), fit
        # fmax, fmax64: a finite f64 whose f32 overflows would alias inf
        fit = torch.where(ok & torch.isfinite(v),
                          torch.isfinite(v.to(torch.float32)), True).all()
        if c.dtype == T.INT64:
            fit = fit & torch.where(ok, (c.data >= -INT_MAX_EXACT) &
                                    (c.data <= INT_MAX_EXACT), True).all()
        return StageCol(kind, v, valid), fit

    def _table_core(self, batch: ColumnarBatch, update: bool):
        """(buffer batch of capacity ``table``, device fit flag), or None
        when this aggregate cannot use the table path at all."""
        table = self.table
        keys, inputs = self._bound_inputs(batch.schema, update)
        descs = self._descs(inputs, update)
        if descs is None or not keys or \
                not all(_key_ok(e.dtype()) for e in keys):
            return None
        cap = batch.capacity
        # u32 count rows are exact below 2^24 rows; i32 chunk lanes hold
        # |lane sum| <= 510 per row below 2^31, so at most 2^22 rows
        if cap > (1 << 24) or ("fsum64" in descs and cap > (1 << 22)):
            return None
        dev = batch.device
        live = batch.live_mask()
        if update:
            b, live = apply_ops_masked(self.pre_ops, batch, live)
        else:
            b = batch
        kcols = [ec.eval_as_column(e, b) for e in keys]
        kwords = [canon.value_words(c)[0] for c in kcols]
        bucket, fit, mins, cards = agg_k.table_bucket(
            kwords, [c.validity for c in kcols], live, table)
        icols = [[ec.eval_as_column(e, b) for e in bs] for bs in inputs]

        # the stage's inputs: column 0 counts the live rows (dead rows sit
        # in the dropped bucket ``table``); one column per distinct
        # (kind, input) of the aggregates
        cols, col_of, slots = [StageCol("count")], {}, []
        for ai, kind in enumerate(descs):
            c = icols[ai][0] if icols[ai] else None
            if c is None:                       # count(*)
                slots.append(0)
                continue
            dk = (kind, repr(inputs[ai][0]))
            if dk not in col_of:
                sc, col_fit = self._stage_col(kind, c, live)
                fit = fit & col_fit
                col_of[dk] = len(cols)
                cols.append(sc)
            slots.append(col_of[dk])
        tabs = table_stage(bucket, table, cols)

        present, order, ng = agg_k.table_compact(tabs[0][0], table)
        live_g = torch.arange(table, device=dev) < ng

        def compact(tab):
            return tab[order]

        out_cols = []
        # keys: decode the mixed-radix digits arithmetically
        strides, st = [], torch.ones((), dtype=torch.int64, device=dev)
        for card in reversed(cards):
            strides.append(st)
            st = st * card
        strides.reverse()
        for e, wmin, card, stride in zip(keys, mins, cards, strides):
            digit = torch.div(order, stride, rounding_mode="floor") % card
            word = wmin + (digit - 1)
            dt = e.dtype()
            data = (word != 0) if dt == T.BOOL else \
                (word ^ SIGN64).to(dt.torch_dtype)
            out_cols.append(Column(dt, data, (digit > 0) & live_g))

        for ai, kind in enumerate(descs):
            t = tabs[slots[ai]]
            if kind in ("count", "icount"):
                data = torch.where(live_g, compact(t[0]), 0)
                out_cols.append(Column(T.INT64, data.to(torch.int64),
                                       torch.ones_like(live_g)))
                continue
            cntv = compact(t[0])
            valid = (cntv > 0) & live_g
            if kind == "fsumv":
                out_cols.append(Column(T.FLOAT64, compact(t[1]), valid))
            elif kind == "fsum64":
                ssum = chunk_recombine(t[4][:, order], cols[slots[ai]].emax)
                nanv, pinf, ninf = (compact(x) for x in t[1:4])
                ssum = torch.where(pinf > 0, float("inf"), ssum)
                ssum = torch.where(ninf > 0, float("-inf"), ssum)
                ssum = torch.where((nanv > 0) | ((pinf > 0) & (ninf > 0)),
                                   float("nan"), ssum)
                out_cols.append(Column(T.FLOAT64, ssum, valid))
            else:
                nnv = compact(t[1])
                if kind == "fmax":
                    m = compact(t[2]).to(torch.float64)
                else:
                    w = compact(t[2])
                    m = unflip32(w >> 32).to(torch.float64) + \
                        unflip32(w).to(torch.float64)
                # any NaN in the group wins
                m = torch.where(cntv > nnv, float("nan"), m)
                dt = self.aggs[ai].func.buffer_dtypes()[0]
                out_cols.append(Column(dt, m.to(dt.torch_dtype), valid))
        out = ColumnarBatch(buffer_schema(self.group_exprs, self.aggs),
                            out_cols, ng, device=dev)
        return out, fit
