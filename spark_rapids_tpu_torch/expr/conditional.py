"""Conditional expressions: If, CaseWhen, Coalesce, Nvl and NaNvl.

Counterpart of ``spark_rapids_tpu/expr/conditional.py``.  The result
type is the common type of the value branches, a bare ``NULL`` taking
the others' type (``_result_dtype``); each row takes the value of its
first true condition.  Fixed-width values (DATEs included: q51's ``case
when web.d_date is not null then web.d_date else store.d_date end``)
are chosen with ``torch.where`` (``_select_columns``), DECIMALs at the
result's scale (a value that does not fit its precision is NULL, as a
CAST's); STRING values
(q70's ``case when grouping(s_county) = 0 then s_state end``) by one
gather of each row's source string from the chosen branch
(``_select_strings`` over ``strings.choose_rows``, the reference's
``_select_strings``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column
from ..kernels import strings
from .cast import as_type
from .core import Expression, Literal, eval_as_column


def _result_dtype(exprs: List[Expression]) -> T.DType:
    dt: Optional[T.DType] = None
    for e in exprs:
        et = e.dtype()
        if et == T.NULL:
            continue
        dt = et if dt is None else T.common_type(dt, et)
    return dt if dt is not None else T.NULL


def _is_null(val: Expression) -> bool:
    """A bare ``NULL``, or a NULL literal of a type (``nullif``'s)."""
    return val.dtype() == T.NULL or (isinstance(val, Literal) and
                                     val.value is None)


def _select_columns(branches, batch, out_t: T.DType):
    """(data, valid) of ``[(condition mask, value expression)]``: each
    row takes the value of its first true condition, null where none
    is."""
    cap = batch.capacity
    data = torch.zeros(cap, dtype=out_t.torch_dtype, device=batch.device)
    valid = torch.zeros(cap, dtype=torch.bool, device=batch.device)
    decided = torch.zeros_like(valid)
    for cond, val in branches:
        take = cond & ~decided
        decided = decided | cond
        if _is_null(val):
            valid = valid & ~take
            continue
        if isinstance(val, Literal):
            # a constant arm is a host scalar: no column of it is built
            data = torch.where(take, _scalar_of(val.value, out_t), data)
            valid = valid | take
            continue
        c = as_type(eval_as_column(val, batch), out_t)
        data = torch.where(take, c.data, data)
        valid = torch.where(take, c.validity, valid)
    return data, valid


def _select_strings(branches, batch):
    """``_select_columns`` of STRING values: each row's branch index and
    validity, then one gather of the rows' bytes from the branches'
    columns (``strings.choose_rows``)."""
    dev = batch.device
    which = torch.zeros(batch.capacity, dtype=torch.int64, device=dev)
    valid = torch.zeros(batch.capacity, dtype=torch.bool, device=dev)
    decided = torch.zeros_like(valid)
    cols = []
    for cond, val in branches:
        take = cond & ~decided
        decided = decided | cond
        if _is_null(val):
            valid = valid & ~take
            continue
        c = eval_as_column(val, batch)
        which = torch.where(take, len(cols), which)
        valid = torch.where(take, c.validity, valid)
        cols.append(c)
    if not cols:
        return Literal(None, T.STRING).columnar_eval(batch).to_column(
            batch.capacity, dev)
    return strings.choose_rows(cols, which, valid)


def _scalar_of(value, out_t: T.DType):
    if out_t == T.DATE:
        return T.date_to_days(value)
    if out_t.is_decimal:
        return T.unscaled_of(value, out_t.scale)
    return float(value) if out_t.is_fractional else \
        (bool(value) if out_t == T.BOOL else int(value))


def _truth(cond: Expression, batch) -> torch.Tensor:
    c = eval_as_column(cond, batch)
    return c.data.to(torch.bool) & c.validity


class If(Expression):
    def __init__(self, pred: Expression, if_true: Expression,
                 if_false: Expression):
        self.children = [pred, if_true, if_false]

    def dtype(self):
        return _result_dtype(self.children[1:])

    def columnar_eval(self, batch):
        out_t = self.dtype()
        p = _truth(self.children[0], batch)
        branches = [(p, self.children[1]), (~p, self.children[2])]
        if out_t == T.STRING:
            return _select_strings(branches, batch)
        data, valid = _select_columns(branches, batch, out_t)
        return Column(out_t, data, valid)

    def __repr__(self):
        c = self.children
        return f"if({c[0]!r}, {c[1]!r}, {c[2]!r})"


class CaseWhen(Expression):
    """``CASE WHEN c1 THEN v1 ... [ELSE e] END``; no ELSE gives null."""

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        self.children = [x for c, v in branches for x in (c, v)] + (
            [else_value] if else_value is not None else [])
        self.num_branches = len(branches)

    @property
    def branches(self):
        c = self.children
        return [(c[2 * i], c[2 * i + 1]) for i in range(self.num_branches)]

    @property
    def else_value(self) -> Optional[Expression]:
        c = self.children
        return c[-1] if len(c) > 2 * self.num_branches else None

    def dtype(self):
        vals = [v for _, v in self.branches]
        if self.else_value is not None:
            vals.append(self.else_value)
        return _result_dtype(vals)

    def columnar_eval(self, batch):
        out_t = self.dtype()
        sel = [(_truth(c, batch), v) for c, v in self.branches]
        if self.else_value is not None:
            sel.append((torch.ones(batch.capacity, dtype=torch.bool,
                                   device=batch.device), self.else_value))
        if out_t == T.STRING:
            return _select_strings(sel, batch)
        data, valid = _select_columns(sel, batch, out_t)
        return Column(out_t, data, valid)

    def __repr__(self):
        arms = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self.branches)
        els = f" ELSE {self.else_value!r}" if self.else_value is not None \
            else ""
        return f"CASE {arms}{els} END"


class Coalesce(Expression):
    """The first non-null argument, row by row."""

    def __init__(self, *children: Expression):
        self.children = list(children)

    def dtype(self):
        return _result_dtype(self.children)

    def columnar_eval(self, batch):
        out_t = self.dtype()
        if out_t == T.STRING:
            return self._strings(batch)
        cap = batch.capacity
        data = torch.zeros(cap, dtype=out_t.torch_dtype, device=batch.device)
        valid = torch.zeros(cap, dtype=torch.bool, device=batch.device)
        for ch in self.children:
            if _is_null(ch):
                continue
            c = as_type(eval_as_column(ch, batch), out_t)
            take = c.validity & ~valid
            data = torch.where(take, c.data, data)
            valid = valid | c.validity
        return Column(out_t, data, valid)

    def _strings(self, batch):
        """Each row's bytes from its first valid argument
        (``strings.choose_rows``)."""
        cols = [eval_as_column(ch, batch) for ch in self.children
                if ch.dtype() != T.NULL]
        which = torch.zeros(batch.capacity, dtype=torch.int64,
                            device=batch.device)
        valid = torch.zeros(batch.capacity, dtype=torch.bool,
                            device=batch.device)
        for i, c in enumerate(cols):
            which = torch.where(c.validity & ~valid, i, which)
            valid = valid | c.validity
        return strings.choose_rows(cols, which, valid)

    def __repr__(self):
        return f"coalesce({', '.join(map(repr, self.children))})"


def Nvl(a: Expression, b: Expression) -> Coalesce:
    return Coalesce(a, b)


class NaNvl(Expression):
    """``nanvl(a, b)``: ``a`` unless ``a`` is NaN, then ``b``."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def dtype(self):
        return T.common_type(self.children[0].dtype(),
                             self.children[1].dtype())

    def columnar_eval(self, batch):
        out_t = self.dtype()
        ac, bc = (as_type(eval_as_column(c, batch), out_t)
                  for c in self.children)
        a, b = ac.data, bc.data
        use_b = torch.isnan(a) & ac.validity if a.is_floating_point() \
            else torch.zeros_like(ac.validity)
        return Column(out_t, torch.where(use_b, b, a),
                      torch.where(use_b, bc.validity, ac.validity))

    def __repr__(self):
        return f"nanvl({self.children[0]!r}, {self.children[1]!r})"
