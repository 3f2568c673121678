"""Comparisons and three-valued boolean logic.

Counterpart of ``spark_rapids_tpu/expr/predicates.py``.  Numeric
comparisons run natively with Spark's order pinned: NaN is greatest and
equal to itself, -0.0 == 0.0.  Mixed types promote first.  A DECIMAL
compares exactly with a DECIMAL or an integer (``_decimal_compare``:
the side of the smaller scale rescales to the larger, and a rescale
past 18 digits is larger in magnitude than any value of the other side,
so its sign decides; the reference compares as a double past 18
digits), and as a double with a float (a literal such as ``100.00`` is
a double here, as in the reference; a 2-digit decimal's unscaled int
over 100 is the double nearest its value, so the comparison is exact).  Strings
compare by bytes: equality with a literal matches the literal's bytes
(``strings.equal_literal``); any other string comparison runs on both
sides' key words at one width.
"""
from __future__ import annotations

import decimal

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column
from ..kernels import decimal as dk
from ..kernels import strings
from ..kernels.canon import words_less
from .cast import Cast, as_type
from .core import Expression, Literal, eval_as_column


def _unscaled(c: Column):
    """(int64 unscaled values, scale) of a DECIMAL, integer or BOOL
    column."""
    return c.data.to(torch.int64), (c.dtype.scale if c.dtype.is_decimal
                                    else 0)


def _decimal_compare(lc: Column, rc: Column):
    """(lt, eq) of two DECIMAL / integer columns, exact."""
    (a, sa), (b, sb) = _unscaled(lc), _unscaled(rc)
    s = max(sa, sb)
    a2, oka = dk.scale_up(a, s - sa, T.DecimalType.MAX_PRECISION)
    b2, okb = dk.scale_up(b, s - sb, T.DecimalType.MAX_PRECISION)
    both = oka & okb
    lt = torch.where(both, a2 < b2, (~oka & (a < 0)) | (~okb & (b > 0)))
    return lt, both & (a2 == b2)


def promote_comparison_sides(left: Expression, right: Expression):
    lt, rt = left.dtype(), right.dtype()
    if lt == rt:
        return left, right
    common = T.common_type(lt, rt)
    if lt != common:
        left = Cast(left, common)
    if rt != common:
        right = Cast(right, common)
    return left, right


class BinaryComparison(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]
        self._lits = {}

    def dtype(self):
        return T.BOOL

    def compare(self, lt, eq):
        raise NotImplementedError

    def _string_eval(self, batch):
        """(result, left validity, right validity) of strings."""
        left, right = self.children
        if isinstance(left, Literal):
            left, right = right, left
        if type(self) is EqualTo and isinstance(right, Literal) and \
                right.value is not None and not isinstance(left, Literal):
            c = eval_as_column(left, batch)
            lit = strings.held_literal(self._lits, right.value)
            return strings.equal_literal(c, lit), c.validity, \
                torch.ones_like(c.validity)
        left, right = self.children
        lc = eval_as_column(left, batch)
        rc = eval_as_column(right, batch)
        width = max(strings.needed_key_words(lc),
                    strings.needed_key_words(rc))
        lw = strings.string_key_words(lc, width)
        rw = strings.string_key_words(rc, width)
        rows = torch.arange(lc.capacity, device=lc.device)
        lt = words_less(lw, rows, rw, rows)
        eq = torch.ones_like(lt)
        for a, b in zip(lw, rw):
            eq = eq & (a == b)
        return self.compare(lt, eq), lc.validity, rc.validity

    def columnar_eval(self, batch):
        res, lv, rv = self._eval(batch)
        return Column(T.BOOL, res, lv & rv)

    def _eval(self, batch):
        """(result where both sides are valid, left validity, right
        validity)."""
        if T.NULL in (self.children[0].dtype(), self.children[1].dtype()):
            lc, rc = (eval_as_column(c, batch) for c in self.children)
            return torch.zeros_like(lc.validity), lc.validity, rc.validity
        if T.STRING in (self.children[0].dtype(), self.children[1].dtype()):
            if self.children[0].dtype() != self.children[1].dtype():
                raise NotImplementedError(
                    f"comparison of {self.children[0].dtype()} with "
                    f"{self.children[1].dtype()} is not ported")
            return self._string_eval(batch)
        ltype, rtype = (c.dtype() for c in self.children)
        if ltype.is_decimal or rtype.is_decimal:
            lc, rc = (eval_as_column(c, batch) for c in self.children)
            if ltype.is_fractional or rtype.is_fractional:
                a, b = (as_type(c, T.FLOAT64).data for c in (lc, rc))
                an, bn = torch.isnan(a), torch.isnan(b)
                lt = torch.where(an, False, (a < b) | bn)
                eq = (a == b) | (an & bn)
            else:
                lt, eq = _decimal_compare(lc, rc)
            return self.compare(lt, eq), lc.validity, rc.validity
        left, right = promote_comparison_sides(*self.children)
        lc = eval_as_column(left, batch)
        rc = eval_as_column(right, batch)
        a, b = lc.data, rc.data
        if a.is_floating_point():
            an, bn = torch.isnan(a), torch.isnan(b)
            lt = torch.where(an, False, (a < b) | bn)
            eq = (a == b) | (an & bn)
        else:
            lt = a < b
            eq = a == b
        return self.compare(lt, eq), lc.validity, rc.validity

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class EqualTo(BinaryComparison):
    symbol = "="

    def compare(self, lt, eq):
        return eq


class GreaterThan(BinaryComparison):
    symbol = ">"

    def compare(self, lt, eq):
        return ~lt & ~eq


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def compare(self, lt, eq):
        return ~lt


class LessThan(BinaryComparison):
    symbol = "<"

    def compare(self, lt, eq):
        return lt


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def compare(self, lt, eq):
        return lt | eq


class EqualNullSafe(BinaryComparison):
    """``<=>``: two nulls are equal, a null and a value are not; never
    null."""
    symbol = "<=>"

    def compare(self, lt, eq):
        return eq

    def columnar_eval(self, batch):
        eq, lv, rv = self._eval(batch)
        out = torch.where(~lv & ~rv, True, eq & lv & rv)
        return Column(T.BOOL, out, torch.ones_like(out))


class Not(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return T.BOOL

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        return Column(T.BOOL, ~c.data.to(torch.bool), c.validity)

    def __repr__(self):
        return f"NOT {self.children[0]!r}"


class And(Expression):
    """Three-valued AND: false & null = false."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def dtype(self):
        return T.BOOL

    def columnar_eval(self, batch):
        lc = eval_as_column(self.children[0], batch)
        rc = eval_as_column(self.children[1], batch)
        a, av = lc.data.to(torch.bool), lc.validity
        b, bv = rc.data.to(torch.bool), rc.validity
        valid = (av & bv) | (av & ~a) | (bv & ~b)
        return Column(T.BOOL, a & b, valid)

    def __repr__(self):
        return f"({self.children[0]!r} AND {self.children[1]!r})"


class Or(Expression):
    """Three-valued OR: true | null = true."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def dtype(self):
        return T.BOOL

    def columnar_eval(self, batch):
        lc = eval_as_column(self.children[0], batch)
        rc = eval_as_column(self.children[1], batch)
        a, av = lc.data.to(torch.bool), lc.validity
        b, bv = rc.data.to(torch.bool), rc.validity
        valid = (av & bv) | (av & a) | (bv & b)
        return Column(T.BOOL, a | b, valid)

    def __repr__(self):
        return f"({self.children[0]!r} OR {self.children[1]!r})"


class IsNull(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return T.BOOL

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        return Column(T.BOOL, ~c.validity, torch.ones_like(c.validity))

    def __repr__(self):
        return f"isnull({self.children[0]!r})"


class IsNotNull(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return T.BOOL

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        return Column(T.BOOL, c.validity.clone(), torch.ones_like(c.validity))

    def __repr__(self):
        return f"isnotnull({self.children[0]!r})"


class IsNaN(Expression):
    """True for a NaN double; false for a number, a null or a non-float
    type (never null)."""

    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return T.BOOL

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        nan = torch.isnan(c.data) if c.data.is_floating_point() else \
            torch.zeros_like(c.validity)
        return Column(T.BOOL, nan & c.validity, torch.ones_like(c.validity))

    def __repr__(self):
        return f"isnan({self.children[0]!r})"


class In(Expression):
    """``child IN (v1, v2, ...)`` over a literal list.  Each value is an
    equality of the child with that literal: a string list compares each
    value's bytes (``strings.equal_literal``), a number list the child's
    values, a fractional value against an integer child promoting the
    child.  A match is true; otherwise a null child or a null in the
    list gives null."""

    def __init__(self, child: Expression, values):
        self.children = [child]
        self.values = list(values)
        self._lits = {}

    def dtype(self):
        return T.BOOL

    def _equal(self, c: Column, v) -> torch.Tensor:
        if c.dtype == T.STRING:
            return strings.equal_literal(
                c, strings.held_literal(self._lits, str(v)))
        if c.dtype == T.DATE:
            return c.data == T.date_to_days(v)
        if c.dtype.is_decimal:
            if isinstance(v, float):
                return dk.to_double(c.data, c.dtype.scale) == v
            # an integer or a Decimal (a subquery's IN list), exactly
            u = decimal.Decimal(v).scaleb(c.dtype.scale)
            if u != u.to_integral_value() or \
                    abs(u) > dk.bound(T.DecimalType.MAX_PRECISION):
                return torch.zeros_like(c.validity)
            return c.data == int(u)
        a = c.data
        if a.is_floating_point() and isinstance(v, float) and v != v:
            return torch.isnan(a)          # Spark: NaN equals NaN
        if isinstance(v, float) and not a.is_floating_point():
            a = a.to(torch.float64)
        elif not a.is_floating_point():
            a = a.to(torch.int64)
        return a == v

    def columnar_eval(self, batch):
        c = eval_as_column(self.children[0], batch)
        hit = torch.zeros_like(c.validity)
        for v in self.values:
            if v is not None:
                hit = hit | self._equal(c, v)
        hit = hit & c.validity
        if any(v is None for v in self.values):
            return Column(T.BOOL, hit, hit)
        return Column(T.BOOL, hit, c.validity)

    def __repr__(self):
        return f"({self.children[0]!r} IN {self.values!r})"
