"""String expressions: substring, length, trim, reverse, locate,
padding, repeat, replace, case, prefix/suffix/contains tests, LIKE and
concatenation.

Counterpart of ``spark_rapids_tpu/expr/string_ops.py`` (all but its
regular expressions: ``RLike``, ``RegexpExtract``, ``RegexpReplace``).
Positions, counts, patterns, search and pad strings and separators are
literals, read when the expression is built; each expression holds its
literals' bytes (``strings.LiteralBytes``) and uploads them once per
device, not per batch.  Every function runs on the device
(``kernels/strings.py``), where the reference loops over rows on the
host for ``Replace``, ``StringRepeat``, ``Lpad``, ``Rpad``, ``InitCap``,
``StringLocate`` and ``ConcatWs``.  ``Like`` runs the reference's four
device forms (prefix ``'a%'``, suffix ``'%a'``, contains ``'%a%'``,
equality ``'a'``) in torch and every other pattern (``_``, an escape,
``%`` inside the text) through the ``like_match`` kernel, where the
reference runs a host regex.  Case mapping (``upper``, ``lower``,
``initcap``) is ASCII alone, as the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn
from ..kernels import cuda_ops
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
    """SQL ``LIKE`` with a literal pattern: the reference's four device
    forms in torch, any other pattern by the ``like_match`` kernel
    (``_`` is one UTF-8 character; ``escape`` makes the next character
    literal)."""

    def __init__(self, child: Expression, pattern: Expression,
                 escape: str = "\\"):
        self.children = [child, pattern]
        self.escape = escape
        p = _literal_value(pattern, "a LIKE pattern")
        self.pattern = p
        form = like_form(str(p), escape) if p is not None else None
        if form is None:
            self.form, self.text, self.lit = "match", None, None
            self.tokens = cuda_ops.like_tokens(str(p), escape) \
                if p is not None else None
        else:
            self.form, self.text = form
            self.lit = skern.LiteralBytes(self.text)

    def dtype(self):
        return T.BOOL

    def columnar_eval(self, batch):
        col = _eval_string(self.children[0], batch)
        if self.pattern is None:
            return Column(T.BOOL, torch.zeros_like(col.validity),
                          torch.zeros_like(col.validity))
        if self.form == "match":
            mask = skern.like(col, self.tokens)
        elif self.form == "equal":
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


class _StringFunction(Expression):
    """Base of a function of one string column and literal arguments,
    null where the column is."""

    kind = T.STRING

    def __init__(self, child: Expression, *args: Expression):
        self.children = [child, *args]
        self.args = [_literal_value(a, f"{self.name}'s argument")
                     for a in args]

    def dtype(self):
        return self.kind

    def columnar_eval(self, batch):
        if self.children[0].dtype() == T.NULL or \
                any(a is None for a in self.args):
            from ..columnar.column import null_column
            return null_column(self.kind, batch.capacity, batch.device)
        return self.apply(_eval_string(self.children[0], batch))

    def apply(self, col):
        raise NotImplementedError


class Length(_StringFunction):
    """``length`` / ``char_length``: characters, an int."""

    kind = T.INT32

    def apply(self, col):
        return Column(T.INT32, skern.char_lengths(col), col.validity)


class StringTrim(_StringFunction):
    """``trim``: the spaces at both ends removed."""

    side = "both"

    def apply(self, col):
        return skern.trim(col, type(self).side)


class StringTrimLeft(StringTrim):
    side = "leading"


class StringTrimRight(StringTrim):
    side = "trailing"


class Reverse(_StringFunction):
    """``reverse``, by characters."""

    def apply(self, col):
        return skern.reverse(col)


class InitCap(_StringFunction):
    """``initcap``: ASCII letters lower case, upper case at the start and
    after a space."""

    def apply(self, col):
        return skern.initcap(col)


class StringRepeat(_StringFunction):
    """``repeat(str, n)``."""

    def apply(self, col):
        return skern.repeat(col, int(self.args[0]))


class Lpad(_StringFunction):
    """``lpad(str, len[, pad])``, by characters, the pad a space by
    default; a longer string is cut to ``len`` characters."""

    left = True

    def __init__(self, child, length, pad=None):
        super().__init__(child, length, pad if pad is not None
                         else Literal(" "))

    def apply(self, col):
        return skern.pad(col, int(self.args[0]), str(self.args[1]),
                         type(self).left)


class Rpad(Lpad):
    left = False


class Replace(_StringFunction):
    """``replace(str, search[, replacement])``: each occurrence a
    left-to-right scan finds, replaced (the replacement empty by
    default)."""

    def __init__(self, child, search, rep=None):
        super().__init__(child, search, rep if rep is not None
                         else Literal(""))
        self.lits = [skern.LiteralBytes(a) for a in self.args
                     if a is not None]

    def apply(self, col):
        return skern.replace(col, *self.lits)


class StringLocate(_StringFunction):
    """``locate(substr, str[, pos])`` and ``instr(str, substr)``: the
    1-based character position of the first ``substr`` at or after
    character ``pos``, 0 if none (``children[0]`` is ``str``)."""

    kind = T.INT32

    def __init__(self, substr: Expression, child: Expression,
                 pos: Optional[Expression] = None):
        super().__init__(child, substr, pos if pos is not None
                         else Literal(1))
        if self.args[0] is not None:
            self.lit = skern.LiteralBytes(self.args[0])

    def columnar_eval(self, batch):
        if self.children[0].dtype() == T.NULL or self.args[0] is None:
            from ..columnar.column import null_column
            return null_column(T.INT32, batch.capacity, batch.device)
        col = _eval_string(self.children[0], batch)
        if self.args[1] is None:
            # Spark's answer for a NULL start: 0, not NULL
            return Column(T.INT32, torch.zeros(col.capacity,
                                               dtype=torch.int32,
                                               device=col.device),
                          col.validity)
        return Column(T.INT32, skern.locate(col, self.lit,
                                            int(self.args[1])),
                      col.validity)


class ConcatWs(Expression):
    """``concat_ws(sep, parts...)``: the non-null parts joined by
    ``sep``; null only where ``sep`` is."""

    def __init__(self, sep: Expression, *children: Expression):
        self.sep = _literal_value(sep, "concat_ws's separator")
        self.children = list(children)
        self._lits = {}

    def dtype(self):
        return T.STRING

    @property
    def nullable(self):
        return self.sep is None

    def columnar_eval(self, batch):
        if self.sep is None:
            return StringColumn.from_scalar(None, T.STRING, batch.capacity,
                                            batch.device)
        parts = []
        for c in self.children:
            v = c.columnar_eval(batch)
            if isinstance(v, Scalar):
                if v.value is not None:
                    parts.append(skern.held_literal(self._lits,
                                                    str(v.value)))
            elif not isinstance(v, StringColumn):
                from .cast import cast_column
                parts.append(cast_column(v, T.STRING))
            else:
                parts.append(v)
        return skern.concat_ws(skern.held_literal(self._lits, self.sep),
                               parts, batch.capacity, batch.device)
