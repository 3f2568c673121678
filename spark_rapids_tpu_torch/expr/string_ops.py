"""String expressions: substring, prefix/suffix/contains tests, LIKE,
concatenation and ASCII case.

Counterpart of ``spark_rapids_tpu/expr/string_ops.py`` (the expressions
this slice runs).  Positions and patterns are literals, read when the
expression is built; each expression holds its literals' bytes
(``strings.LiteralBytes``) and uploads them once per device, not per
batch.  ``Like`` runs the
reference's four device forms (prefix ``'a%'``, suffix ``'%a'``,
contains ``'%a%'``, equality ``'a'``); any other pattern raises
``NotImplementedError`` when the expression is built, since the port
has no host regex path.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn
from ..kernels import strings as skern
from .core import Expression, Literal, Scalar, eval_as_column


def _literal_value(e: Expression, what: str):
    if not isinstance(e, Literal):
        raise NotImplementedError(f"{what} must be a literal")
    return e.value


def _eval_string(expr: Expression, batch) -> StringColumn:
    col = eval_as_column(expr, batch)
    if not isinstance(col, StringColumn):
        raise TypeError(f"expected a string, got {col.dtype}")
    return col


class Substring(Expression):
    """``substring(str, pos, len)`` with literal ``pos`` and ``len``, by
    characters, with the reference's position rules
    (``strings._substring_offsets``)."""

    def __init__(self, child: Expression, pos: Expression,
                 length: Optional[Expression] = None):
        self.children = [child, pos] + ([length] if length is not None
                                        else [])
        self.pos = _literal_value(pos, "substring's position")
        self.length = _literal_value(length, "substring's length") \
            if length is not None else None

    def dtype(self):
        return T.STRING

    def columnar_eval(self, batch):
        return skern.substring(_eval_string(self.children[0], batch),
                               self.pos, self.length)


class Upper(Expression):
    """``upper(str)``: ASCII letters only, as the reference's
    ``strings.upper`` (a non-ASCII character keeps its bytes)."""

    kernel = staticmethod(skern.upper)

    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return T.STRING

    def columnar_eval(self, batch):
        return type(self).kernel(_eval_string(self.children[0], batch))


class Lower(Upper):
    """``lower(str)``: ASCII letters only, as the reference's
    ``strings.lower``."""

    kernel = staticmethod(skern.lower)


class _LiteralPatternPredicate(Expression):
    """Base of StartsWith / EndsWith / Contains with a literal pattern."""

    kernel = None

    def __init__(self, child: Expression, pattern: Expression):
        self.children = [child, pattern]
        self.pattern = _literal_value(pattern, f"{self.name}'s pattern")
        self.lit = skern.LiteralBytes(self.pattern) \
            if self.pattern is not None else None

    def dtype(self):
        return T.BOOL

    def columnar_eval(self, batch):
        col = _eval_string(self.children[0], batch)
        if self.pattern is None:
            return Column(T.BOOL, torch.zeros_like(col.validity),
                          torch.zeros_like(col.validity))
        mask = type(self).kernel(col, self.lit)
        return Column(T.BOOL, mask, col.validity)


class StartsWith(_LiteralPatternPredicate):
    kernel = staticmethod(skern.starts_with)


class EndsWith(_LiteralPatternPredicate):
    kernel = staticmethod(skern.ends_with)


class Contains(_LiteralPatternPredicate):
    kernel = staticmethod(skern.contains)


def like_form(pattern: str, escape: str = "\\"):
    """(form, plain text) of a LIKE pattern the device runs: ``prefix``,
    ``suffix``, ``contains`` or ``equal``; None for any other pattern
    (``_``, an escape, or ``%`` inside the text)."""
    if "_" in pattern or escape in pattern:
        return None
    inner = pattern.strip("%")
    if "%" in inner:
        return None
    lead, trail = pattern.startswith("%"), pattern.endswith("%")
    if lead and trail and len(pattern) >= 2:
        return "contains", inner
    if trail:
        return "prefix", inner
    if lead:
        return "suffix", inner
    return "equal", inner


_LIKE_KERNELS = {"prefix": skern.starts_with, "suffix": skern.ends_with,
                 "contains": skern.contains}


class Like(Expression):
    """SQL ``LIKE`` with a literal pattern, in the reference's four device
    forms."""

    def __init__(self, child: Expression, pattern: Expression,
                 escape: str = "\\"):
        self.children = [child, pattern]
        self.escape = escape
        p = _literal_value(pattern, "a LIKE pattern")
        form = like_form(str(p), escape)
        if form is None:
            raise NotImplementedError(
                f"LIKE {p!r}: the port runs prefix ('a%'), suffix ('%a'), "
                f"contains ('%a%') and equality patterns only")
        self.form, self.text = form
        self.lit = skern.LiteralBytes(self.text)

    def dtype(self):
        return T.BOOL

    def columnar_eval(self, batch):
        col = _eval_string(self.children[0], batch)
        if self.form == "equal":
            mask = skern.equal_literal(col, self.lit)
        else:
            mask = _LIKE_KERNELS[self.form](col, self.lit)
        return Column(T.BOOL, mask, col.validity)


class ConcatStrings(Expression):
    """``concat(s1, s2, ...)`` and ``||``: null if any part is null."""

    def __init__(self, *children: Expression):
        self.children = list(children)
        self._lits = {}

    def dtype(self):
        return T.STRING

    def columnar_eval(self, batch):
        parts = []
        for c in self.children:
            v = c.columnar_eval(batch)
            if isinstance(v, Scalar):
                if v.value is None:
                    return StringColumn.from_scalar(None, T.STRING,
                                                    batch.capacity,
                                                    batch.device)
                parts.append(skern.held_literal(self._lits, v.value))
            else:
                parts.append(v)
        return skern.concat(parts, batch.capacity, batch.device)
