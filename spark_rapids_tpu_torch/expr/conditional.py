"""Conditional expressions: If, CaseWhen, Coalesce and Nvl.

Counterpart of ``spark_rapids_tpu/expr/conditional.py`` for fixed-width
results, DATE ones included (q51's ``case when web.d_date is not null
then web.d_date else store.d_date end``; the port has no string-valued
CASE), and a string ``coalesce`` (the null-safe keys of INTERSECT and
EXCEPT).  The result type is the
common type of the value branches, a bare ``NULL`` taking the others'
type (``_result_dtype``); branches are chosen row by row with
``torch.where``, the first true condition winning (``_select_columns``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column
from ..kernels import strings
from .core import Expression, Literal, eval_as_column


def _result_dtype(exprs: List[Expression]) -> T.DType:
    dt: Optional[T.DType] = None
    for e in exprs:
        et = e.dtype()
        if et == T.NULL:
            continue
        dt = et if dt is None else T.common_type(dt, et)
    return dt if dt is not None else T.NULL


def _check_fixed_width(out_t: T.DType, what: str) -> None:
    if out_t == T.STRING:
        raise NotImplementedError(f"a string-valued {what} is not ported")


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
        if val.dtype() == T.NULL:
            valid = valid & ~take
            continue
        if isinstance(val, Literal):
            # a constant arm is a host scalar: no column of it is built
            data = torch.where(take, _scalar_of(val.value, out_t), data)
            valid = valid | take
            continue
        c = eval_as_column(val, batch)
        data = torch.where(take, c.data.to(out_t.torch_dtype), data)
        valid = torch.where(take, c.validity, valid)
    return data, valid


def _scalar_of(value, out_t: T.DType):
    if out_t == T.DATE:
        return T.date_to_days(value)
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
        _check_fixed_width(out_t, "IF")
        p = _truth(self.children[0], batch)
        data, valid = _select_columns(
            [(p, self.children[1]), (~p, self.children[2])], batch, out_t)
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
        _check_fixed_width(out_t, "CASE")
        sel = [(_truth(c, batch), v) for c, v in self.branches]
        if self.else_value is not None:
            sel.append((torch.ones(batch.capacity, dtype=torch.bool,
                                   device=batch.device), self.else_value))
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
            if ch.dtype() == T.NULL:
                continue
            c = eval_as_column(ch, batch)
            take = c.validity & ~valid
            data = torch.where(take, c.data.to(out_t.torch_dtype), data)
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
