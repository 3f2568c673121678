"""DECIMAL64 arithmetic on unscaled int64 values.

Counterpart of the unscaled-int64 arithmetic spread over the reference's
``expr/arithmetic.py`` (``_decimal_eval``), ``expr/cast.py``
(``_cast_numeric``) and ``kernels/aggregate.py`` (``seg_sum``).  A value
of ``decimal(p, s)`` is the int64 ``v * 10^s`` with ``|v * 10^s| <=
10^p - 1``.

The port adds one thing the reference has not: a result that does not
fit its type's precision is NULL (Spark's answer without ANSI mode).
The reference checks nothing: its int64 products, rescales and sums
wrap, and its ``to_arrow`` raises ``ArrowInvalid`` on a value of more
than 18 digits.  No check here runs an int64 operation that may wrap
before it decides: a product is checked by ``|a| <= bound // |b|``, a
rescale by ``|a| <= bound // 10^k``, and a sum adds the 32-bit halves
of its values apart (``split_halves`` / ``join_halves``), so that the
true sum is known even where its int64 wraps.
"""
from __future__ import annotations

from typing import Tuple

import torch

_MASK32 = 0xFFFFFFFF
#: the int64 that stands for a partial sum past the int64 range
OVERFLOW = -(1 << 63)


def bound(precision: int) -> int:
    """The largest unscaled magnitude of ``precision`` digits."""
    return 10 ** precision - 1


def fits(x: torch.Tensor, precision: int) -> torch.Tensor:
    """Whether each unscaled value has at most ``precision`` digits."""
    b = bound(precision)
    return (x <= b) & (x >= -b)


def scale_up(x: torch.Tensor, k: int, precision: int):
    """``(x * 10^k, whether it fits precision digits)``; a row that does
    not fit holds garbage."""
    if k == 0:
        return x, fits(x, precision)
    m = 10 ** k
    lim = bound(precision) // m
    ok = (x <= lim) & (x >= -lim)
    return torch.where(ok, x, 0) * m, ok


def scale_down(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x / 10^k`` rounded HALF_UP (ties away from zero) on the
    magnitude, the sign put back: torch's ``//`` floors, so a negative
    value divides as its magnitude (the reference's ``cast.py:130``)."""
    if k == 0:
        return x
    m = 10 ** k
    mag = torch.div(x.abs() + m // 2, m, rounding_mode="floor")
    return torch.where(x < 0, -mag, mag)


def truncate(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x / 10^k`` truncated toward zero."""
    if k == 0:
        return x
    return torch.div(x, 10 ** k, rounding_mode="trunc")


def rescale(x: torch.Tensor, from_scale: int, to_scale: int,
            precision: int):
    """``(x at to_scale, whether it fits precision digits)``: exact up,
    HALF_UP down."""
    if to_scale >= from_scale:
        return scale_up(x, to_scale - from_scale, precision)
    y = scale_down(x, from_scale - to_scale)
    return y, fits(y, precision)


def mul_checked(a: torch.Tensor, b: torch.Tensor, precision: int):
    """``(a * b, whether it fits precision digits)`` without an int64
    multiply that wraps first: ``|a * b| <= bound`` exactly when ``|a| <=
    bound // |b|``."""
    bnd = bound(precision)
    mag_b = b.abs()
    lim = torch.div(torch.full_like(b, bnd), mag_b.clamp(min=1),
                    rounding_mode="floor")
    ok = (mag_b == 0) | (a.abs() <= lim)
    return torch.where(ok, a, 0) * b, ok


def to_double(x: torch.Tensor, scale: int) -> torch.Tensor:
    """The double nearest the value: the unscaled int64 (exact below
    2^53) over the exact double ``10^scale``, one correctly rounded
    division."""
    f = x.to(torch.float64)
    return f / float(10 ** scale) if scale else f


def from_double(f: torch.Tensor, scale: int, precision: int):
    """``(the double's value at scale, whether it is a number that fits
    precision digits)``: Spark's ``Decimal(double)``, which rounds the
    digits of ``Double.toString`` HALF_UP, here the shortest digits that
    read back to the double (``cuda_ops.format_double``), so that 0.285
    is 0.29 at scale 2 where ``f * 10^scale`` (0.28499999...) gives
    0.28."""
    from .cuda_ops import format_double
    x = f.to(torch.float64).contiguous()
    digits, exp10 = format_double(x)
    shift = exp10.to(torch.int64) + scale
    # up: digits * 10^shift, shift in [0, 18]; down: HALF_UP of the digits
    # over 10^-shift, shift in [-18, -1] (digits < 10^17: further is 0)
    p10 = torch.tensor([10 ** k for k in range(19)], dtype=torch.int64,
                       device=x.device)
    up = shift >= 0
    k_up = shift.clamp(0, 18)
    lim = torch.div(bound(precision), p10[k_up], rounding_mode="floor")
    fits_up = (shift <= 18) & (digits <= lim)
    k_dn = (-shift).clamp(1, 18)
    down = torch.div(digits + p10[k_dn] // 2, p10[k_dn],
                     rounding_mode="floor")
    down = torch.where(-shift > 18, 0, down)
    mag = torch.where(up, torch.where(fits_up, digits, 0) * p10[k_up], down)
    ok = torch.isfinite(x) & torch.where(up, fits_up,
                                         mag <= bound(precision))
    mag = torch.where(ok, mag, 0)
    return torch.where(torch.signbit(x), -mag, mag), ok


def split_halves(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x = hi * 2^32 + lo`` with ``lo`` in [0, 2^32): sums of up to 2^31
    of either half cannot wrap an int64."""
    return x >> 32, x & _MASK32


def join_halves(hi: torch.Tensor, lo: torch.Tensor):
    """``(hi * 2^32 + lo, whether it lies in the int64 range)`` of exact
    half sums (``lo`` not negative)."""
    h = hi + (lo >> 32)
    ok = (h >= -(1 << 31)) & (h < (1 << 31))
    return (torch.where(ok, h, 0) << 32) + (lo & _MASK32), ok
