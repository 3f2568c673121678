"""Canonical sortable key words.

Counterpart of ``spark_rapids_tpu/kernels/canon.py``.  Every key value
maps to uint64 words (held as int64 bit patterns) whose unsigned
lexicographic order is the SQL order of the values; group-bys, joins and
the hash exchange all key on these words.

- signed ints -> x XOR 0x8000... (order-preserving bias to unsigned);
                 a DATE is its int32 days and a DECIMAL its unscaled
                 int64, as in the reference (``canon.py:148``)
- floats      -> NaNs canonicalized to +NaN and -0.0 to 0.0, then the
                 IEEE trick: sign set -> flip all bits, else set the sign.
                 Hopper has native float64 bitcasts, so a DOUBLE is the
                 single word the reference computes on the CPU, bit for
                 bit (not the TPU's three-word f32 split).
- strings     -> ``strings.string_key_words``: big-endian packed byte
                 words, zero-padded to ``str_words`` words, then the
                 length; columns compared with each other take one width.
- descending  -> every value word inverted (the rank word is not).
- null handling: ``column_key_words`` prepends a rank word per key:
                 nulls first 0 null / 1 valid, nulls last 0 valid /
                 1 null, and 2 for a dead row (sorts past every live row).
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn
from . import strings
from .basic import SIGN64, ult64

_SIGN32 = 0x80000000
_MASK32 = 0xFFFFFFFF


def _ints_to_words(data: torch.Tensor) -> torch.Tensor:
    return data.to(torch.int64) ^ SIGN64


def _f32_order_word(x: torch.Tensor) -> torch.Tensor:
    """f32 -> one word whose unsigned order is the numeric order (NaNs
    greatest, -0.0 == 0.0); the u32 result zero-extended."""
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    bits = x.view(torch.int32).to(torch.int64) & _MASK32
    sign = (bits & _SIGN32) != 0
    return torch.where(sign, (~bits) & _MASK32, bits | _SIGN32)


def _float_to_words(data: torch.Tensor) -> List[torch.Tensor]:
    if data.dtype == torch.float32:
        return [_f32_order_word(data)]
    f64 = data.to(torch.float64)
    f64 = torch.where(torch.isnan(f64), torch.full_like(f64, float("nan")),
                      f64)
    f64 = torch.where(f64 == 0.0, torch.zeros_like(f64), f64)
    bits = f64.view(torch.int64)
    sign = bits < 0
    return [torch.where(sign, ~bits, bits | SIGN64)]


def value_words(col: Column, str_words: int = None) -> List[torch.Tensor]:
    """Word list for the column's values (no null rank); a string takes
    ``str_words`` byte words (default: what its longest string needs)."""
    dt = col.dtype
    if isinstance(col, StringColumn):
        return strings.string_key_words(col, str_words)
    if dt == T.BOOL:
        return [col.data.to(torch.int64)]
    if dt.is_integral or dt.is_decimal or dt == T.DATE:
        return [_ints_to_words(col.data)]
    if dt.is_fractional:
        return _float_to_words(col.data)
    if dt == T.NULL:
        # every row is NULL: its rank word alone orders it
        return [torch.zeros(col.data.shape[0], dtype=torch.int64,
                            device=col.data.device)]
    raise NotImplementedError(f"key encoding for {dt}")


def column_key_words(col: Column, live: torch.Tensor, *,
                     descending: bool = False, nulls_last: bool = False,
                     str_words: int = None) -> List[torch.Tensor]:
    """[rank word] + value words, with the words of null rows zeroed."""
    valid = col.validity & live
    rank = torch.where(valid, 1 - int(nulls_last), int(nulls_last)).to(
        torch.int64)
    rank = torch.where(live, rank, torch.full_like(rank, 2))
    words = value_words(col, str_words)
    if descending:
        words = [~w for w in words]
    words = [torch.where(valid, w, torch.zeros_like(w)) for w in words]
    return [rank] + words


def batch_key_words(cols: List[Column], live: torch.Tensor,
                    descending: List[bool] = None,
                    nulls_last: List[bool] = None,
                    str_words: List[int] = None) -> List[torch.Tensor]:
    n = len(cols)
    descending = descending or [False] * n
    nulls_last = nulls_last or [False] * n
    str_words = str_words or [None] * n
    out: List[torch.Tensor] = []
    for c, d, nl, sw in zip(cols, descending, nulls_last, str_words):
        out.extend(column_key_words(c, live, descending=d, nulls_last=nl,
                                    str_words=sw))
    return out


def common_str_words(col_lists: List[List[Column]]) -> List[int]:
    """Per key position, one string width for every list of key columns
    that will be compared (``None`` for a fixed-width key)."""
    out = []
    for cols in zip(*col_lists):
        if isinstance(cols[0], StringColumn):
            out.append(max(strings.needed_key_words(c) for c in cols))
        else:
            out.append(None)
    return out


def words_equal_adjacent(words: List[torch.Tensor]) -> torch.Tensor:
    """For sorted word arrays: mask[i] = row i differs from row i-1."""
    diff = torch.zeros(words[0].shape[0], dtype=torch.bool,
                       device=words[0].device)
    for w in words:
        diff[1:] |= w[1:] != w[:-1]
    diff[0] = True
    return diff


def words_less(words_a: List[torch.Tensor], idx_a: torch.Tensor,
               words_b: List[torch.Tensor], idx_b: torch.Tensor
               ) -> torch.Tensor:
    """Lexicographic unsigned a[idx_a] < b[idx_b] over word lists."""
    lt = None
    eq = None
    for wa, wb in zip(words_a, words_b):
        a = wa[idx_a]
        b = wb[idx_b]
        w_lt = ult64(a, b)
        w_eq = a == b
        if lt is None:
            lt, eq = w_lt, w_eq
        else:
            lt = lt | (eq & w_lt)
            eq = eq & w_eq
    return lt
