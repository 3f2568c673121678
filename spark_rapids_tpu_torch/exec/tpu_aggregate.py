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
- exact f64 max: one u64 order word per row, the f64's own bits in
  float order (``flip64``).  The reference's two-stage u32 max of the
  f32 pair hi + lo ranks the rows the same way but keeps about 48 bits
  of the winner, so ``x = max(x)`` missed the row it came from; the H100
  has f64.  An integer or DATE max takes the same word for a magnitude
  of at most 2^48 (the pair form's bound); a batch with a larger one
  runs the sort path.  A min maxes the complemented word (``fmin64``;
  the reference's ``fminmax64`` / ``iminmax``), NaN only where every
  value is NaN;
- first / last (the reference's ``firstlast``): the max of each row's
  complemented (first) or plain (last) position over the valid rows, or
  over every live row with ``ignore_nulls`` false; the finish gathers
  the winning row's value.  Merging partials, which are concatenated
  in order, takes the earlier partial's first and the later one's last.
  A STRING first / last or min runs the sort path, as in the reference.
  A DECIMAL key, min or max takes the core as its unscaled int64 does
  (the reference's ``iminmax``); a DECIMAL sum runs the sort path
  (``tpu_aggregate.py:499``, "exact int/decimal sums: sort path").

The batch's largest exponent and the fit conditions stay torch ops
before the launch.  A device fit flag says whether the batch fit the
table; its value is read per batch, and a batch that did not fit runs
the sort path (``groupby_plan`` and the ``seg_*`` reductions).

Variable float mode (``variableFloatAgg.enabled``) sums its values in
the kernel in f64 (the atomics reorder additions from run to run) and
takes its maxes in f32.

An ``avg`` over a fractional column takes the table core too (the
reference's ``favg64`` / ``avg``): its f64 sum row gives the sum and
that row's count the count; merging partials sums buffer 0 and adds the
counts of buffer 1.  Integer sums and averages, and the moments, take
the sort path, as in the reference.

A string group key never enters the table core: its batches take the
sort path, and its output keys are gathered from one row per group.  An
aggregate with no keys (``_global_agg``) runs the sort path over one
constant key and emits exactly one row, also over no input rows (count
0, other results null), as Spark does.
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
from ..kernels.aggregate import CH_W0, chunk_recombine, f32_exp, unflip64
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
    """Keys (and min / max inputs) of the table core: the integer family,
    DECIMALs by their unscaled int64 (``tpu_aggregate.py:453``)."""
    return dt.is_integral or dt.is_decimal or dt in (T.BOOL, T.DATE)


class TpuHashAggregate(TpuExec):
    """Grouped aggregation.  PARTIAL turns input rows into buffer rows
    (one batch per partition); FINAL merges buffer rows and finalizes.
    ``pre_ops`` is a filter/project chain the planner staged in front of
    a PARTIAL aggregate: ``[(kind, payload, out_schema)]``."""

    def __init__(self, group_exprs: List[ec.Expression], aggs: List[AggExpr],
                 child: TpuExec, mode: str, table: int,
                 variable_float: bool, device=None):
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.children = [child]
        self.mode = mode
        self.table = table
        self.variable_float = variable_float
        #: where a keyless final aggregate makes its row over no input
        self.device = device
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
        run = self._partial if self.mode == PARTIAL else self._final
        return [run(part) for part in self.children[0].execute()]

    def _partial(self, part):
        """One buffer batch of a partition: each input batch aggregated
        as it arrives, then the partials merged."""
        partials = [self._aggregate(b, update=True) for b in part
                    if b.rows_known != 0]
        if partials:
            merged = concat_batches(partials)
            if len(partials) > 1:
                merged = self._aggregate(merged, update=False)
            yield merged

    def _final(self, part):
        batches = [b for b in part if b.rows_known != 0]
        if not batches and self.group_exprs:
            return
        if not batches:
            batches = [ColumnarBatch.empty(
                self.children[0].output_schema, self.device)]
        merged = self._aggregate(concat_batches(batches), update=False)
        yield self._finalize(merged)

    def _aggregate(self, batch: ColumnarBatch, update: bool) -> ColumnarBatch:
        """One batch to buffer rows: the table core when the batch fits,
        else the sort path.  Reads the fit flag and group count."""
        if not self.group_exprs:
            return self._global_agg(batch, update)
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

    def _global_agg(self, batch: ColumnarBatch,
                    update: bool) -> ColumnarBatch:
        """No keys: one row of buffers, also over no live rows (counts 0,
        every other buffer null)."""
        out = self._sort_aggregate(batch, update)
        has_rows = out.rows_dev > 0
        row0 = torch.arange(out.capacity, device=out.device) < 1
        cols, pos = [], 0
        for a in self.aggs:
            for c in out.columns[pos:pos + a.func.num_buffers]:
                if isinstance(a.func, ea.Count):
                    cols.append(Column(c.dtype, torch.where(row0, c.data, 0),
                                       row0))
                else:
                    cols.append(c.mask_validity(row0 & has_rows))
            pos += a.func.num_buffers
        return ColumnarBatch(out.schema, cols, 1, device=out.device)

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
        # no keys: one constant key, so every live row is one group
        words = canon.batch_key_words(key_cols, live) or \
            [torch.where(live, 1, 2).to(torch.int64)]
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
        """Per-agg lowering for the table core: (finish kind, [(stage
        kind, input position)]), or None if any agg cannot take it.  An
        avg over a fractional column (the reference's ``favg64`` /
        ``avg``) sums its values on an f64 sum row and counts them on
        that row's count; merging partials sums buffer 0 and adds the
        counts of buffer 1."""
        descs = []
        fsum = "fsumv" if self.variable_float else "fsum64"
        for a, bs in zip(self.aggs, inputs):
            f = a.func
            cdt = bs[0].dtype() if bs else None
            frac = cdt is not None and cdt.is_fractional
            fixed = frac or (cdt is not None and _key_ok(cdt))
            if isinstance(f, ea.Count):
                kind = "count" if update else "icount"
                descs.append((kind, [(kind, 0)]))
            elif isinstance(f, ea.Sum) and frac:
                descs.append((fsum, [(fsum, 0)]))
            elif isinstance(f, ea.Average) and frac:
                descs.append(("avg", [(fsum, 0)] if update else
                              [(fsum, 0), ("icount", 1)]))
            elif isinstance(f, (ea.Max, ea.Min)) and fixed and \
                    cdt != T.BOOL:
                kind = ("fmax" if isinstance(f, ea.Max) else "fmin") + \
                    ("" if frac and self.variable_float else "64")
                descs.append((kind, [(kind, 0)]))
            elif isinstance(f, ea.First) and fixed:
                kind = ("last" if f.last else "first") + \
                    ("" if f.ignore_nulls else "_all")
                descs.append((kind, [(kind, 0)]))
            else:
                return None
        return descs

    @staticmethod
    def _stage_col(kind: str, c: Column, live: torch.Tensor):
        """(the stage's input column for one aggregate, its fit flag)."""
        valid = c.validity.contiguous()
        if kind.startswith(("first", "last")):
            # positions need no column; "_all" counts every live row
            return StageCol(kind.split("_")[0], None, None if
                            kind.endswith("_all") else valid), True
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
        # fmax / fmin: a finite f64 whose f32 overflows would alias inf
        fit = torch.where(ok & torch.isfinite(v), torch.isfinite(
            v.to(torch.float32)), True).all() \
            if kind in ("fmax", "fmin") else True
        if c.dtype == T.INT64 or c.dtype.is_decimal:
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
        kinds = {k for _, stages in descs for k, _ in stages}
        if cap > (1 << 24) or ("fsum64" in kinds and cap > (1 << 22)):
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
        for ai, (_, stages) in enumerate(descs):
            agg_slots = []
            for kind, pos in stages:
                c = icols[ai][pos] if icols[ai] else None
                if c is None:                       # count(*)
                    agg_slots.append(0)
                    continue
                dk = (kind, repr(inputs[ai][pos]))
                if dk not in col_of:
                    sc, col_fit = self._stage_col(kind, c, live)
                    fit = fit & col_fit
                    col_of[dk] = len(cols)
                    cols.append(sc)
                agg_slots.append(col_of[dk])
            slots.append(agg_slots)
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

        def fsum(slot, kind):
            t = tabs[slot]
            if kind == "fsumv":
                return compact(t[1])
            ssum = chunk_recombine(t[4][:, order], cols[slot].emax)
            nanv, pinf, ninf = (compact(x) for x in t[1:4])
            ssum = torch.where(pinf > 0, float("inf"), ssum)
            ssum = torch.where(ninf > 0, float("-inf"), ssum)
            return torch.where((nanv > 0) | ((pinf > 0) & (ninf > 0)),
                               float("nan"), ssum)

        for ai, (kind, stages) in enumerate(descs):
            slot = slots[ai][0]
            t = tabs[slot]
            if kind.startswith(("first", "last")):
                pos = compact(t[0])
                has = (pos >= 0) & live_g
                out_cols.append(icols[ai][0].gather(pos, has))
                continue
            if kind in ("count", "icount"):
                data = torch.where(live_g, compact(t[0]), 0)
                out_cols.append(Column(T.INT64, data.to(torch.int64),
                                       torch.ones_like(live_g)))
                continue
            cntv = compact(t[0])
            valid = (cntv > 0) & live_g
            if kind == "avg":
                # buffers (sum, count), valid in every group
                cnt = cntv if len(stages) == 1 else \
                    compact(tabs[slots[ai][1]][0])
                out_cols.append(Column(T.FLOAT64, torch.where(
                    live_g, fsum(slot, stages[0][0]), 0.0), live_g))
                out_cols.append(Column(T.INT64, torch.where(
                    live_g, cnt, 0).to(torch.int64), live_g))
            elif kind in ("fsumv", "fsum64"):
                out_cols.append(Column(T.FLOAT64, fsum(slot, kind), valid))
            else:
                nnv = compact(t[1])
                w = compact(t[2])
                if kind in ("fmax", "fmin"):
                    m = w.to(torch.float64)
                else:
                    m = unflip64(w if kind == "fmax64" else ~w)
                if kind.startswith("fmax"):
                    # any NaN in the group wins
                    m = torch.where(cntv > nnv, float("nan"), m)
                else:
                    # NaN is the min only of a group of NaNs
                    m = torch.where(nnv > 0, m, float("nan"))
                dt = self.aggs[ai].func.buffer_dtypes()[0]
                out_cols.append(Column(dt, m.to(dt.torch_dtype), valid))
        out = ColumnarBatch(buffer_schema(self.group_exprs, self.aggs),
                            out_cols, ng, device=dev)
        return out, fit
