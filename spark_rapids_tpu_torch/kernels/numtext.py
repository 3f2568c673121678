"""Numbers, DATEs and BOOLs as text, and text read back as them: the
casts to and from STRING.

Counterpart of the reference's ``_cast_to_string`` and
``_cast_from_string`` (``spark_rapids_tpu/expr/cast.py:189-265``), which
are per-row host loops; here each is torch work over every row at once,
with Spark's non-ANSI answers:

- integers, DECIMALs, DATEs and BOOLs are formatted into a padded byte
  matrix of each row's characters and compacted by one copy
  (``from_matrix``); floats take their shortest digits from the
  ``format_double`` kernel and are laid out as Java's
  ``Double.toString`` / ``Float.toString`` lays them out;
- text is read from a padded byte matrix of each row's first
  ``max_bytes`` bytes (``byte_matrix``), trimmed of the bytes Spark
  trims, and checked and converted position by position; floats come
  from the ``parse_double`` kernel.

Each result column carries a host bound on its longest row, so that no
size is read from the device: 11 bytes for an int, 20 for a bigint, 24
for a double, 15 for a float, 14 for a DATE, 5 for a BOOL, precision + 3
for a DECIMAL.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_ops

_MIN64 = -(1 << 63)
#: bytes Spark's ``trimAll`` removes (whitespace and ISO controls);
#: Java's ``String.trim`` removes those up to 0x20 alone
_SPACE, _DEL = 32, 127


def _pow10(dev, n: int = 19) -> torch.Tensor:
    return torch.tensor([10 ** k for k in range(n)], dtype=torch.int64,
                        device=dev)


def from_matrix(mat: torch.Tensor, lens: torch.Tensor, valid: torch.Tensor,
                 max_bytes: int):
    """A string column of the first ``lens[i]`` bytes of each row of the
    uint8 matrix ``mat``."""
    from ..columnar.column import StringColumn
    from .strings import copy_rows
    n, w = mat.shape
    lens = torch.where(valid, lens, 0).to(torch.int32)
    starts = torch.arange(n, device=mat.device, dtype=torch.int64) * w
    offsets, data = copy_rows(mat.reshape(-1).to(torch.uint8), starts, lens,
                              max_bytes)
    return StringColumn(offsets, data, valid, max_bytes)


def _digit_matrix(v: torch.Tensor, width: int) -> torch.Tensor:
    """int64[n, width]: the decimal digits of |v|, most significant
    first, left-padded with zeros; the int64 minimum included (the digits
    come from the value's negation, which cannot overflow)."""
    neg = torch.where(v > 0, -v, v)
    cols = []
    for _ in range(width):
        q = torch.div(neg, 10, rounding_mode="trunc")
        cols.append(q * 10 - neg)
        neg = q
    return torch.stack(cols[::-1], 1)


def _count_digits(d: torch.Tensor) -> torch.Tensor:
    """int64[n]: significant digits of each row of a digit matrix (1 for
    zero)."""
    width = d.shape[1]
    k = torch.arange(width, device=d.device)
    first = torch.where(d != 0, k, width).min(1).values
    return (width - first).clamp(min=1)


def _place(out, k, begin, length, chars):
    """Writes ``chars(idx)`` (idx the offset in the piece) where ``k`` is
    in ``[begin, begin + length)`` of each row."""
    inside = (k >= begin[:, None]) & (k < (begin + length)[:, None])
    idx = (k - begin[:, None]).clamp(min=0)
    return torch.where(inside, chars(idx), out)


def _gather_digits(d: torch.Tensor, first: torch.Tensor):
    """A ``chars`` for ``_place``: ASCII digits of ``d`` from column
    ``first`` of each row on."""
    width = d.shape[1]

    def chars(idx):
        col = (first[:, None] + idx).clamp(0, width - 1)
        return d.gather(1, col) + 48
    return chars


def format_integer(data: torch.Tensor, valid: torch.Tensor, is64: bool):
    """Integers in decimal digits, a ``-`` before a negative one."""
    v = data.to(torch.int64)
    width = 19 if is64 else 10
    d = _digit_matrix(v, width)
    nd = _count_digits(d)
    neg = (v < 0).to(torch.int64)
    out_w = width + 1
    k = torch.arange(out_w, device=v.device)[None, :].expand(v.shape[0], -1)
    out = torch.full_like(k, 45)
    out = _place(out, k, neg, nd, _gather_digits(d, width - nd))
    return from_matrix(out, neg + nd, valid, out_w)


def format_decimal(unscaled: torch.Tensor, valid: torch.Tensor,
                   precision: int, scale: int):
    """A DECIMAL as plain digits with exactly ``scale`` digits after the
    point, at least one before it."""
    v = unscaled.to(torch.int64)
    d = _digit_matrix(v, 19)
    nd = torch.maximum(_count_digits(d), torch.full_like(v, scale + 1))
    neg = (v < 0).to(torch.int64)
    whole = nd - scale
    out_w = precision + 3
    k = torch.arange(out_w, device=v.device)[None, :].expand(v.shape[0], -1)
    out = torch.full_like(k, 45)
    out = _place(out, k, neg, whole, _gather_digits(d, 19 - nd))
    length = neg + whole
    if scale:
        out = _place(out, k, length, torch.ones_like(v),
                     lambda idx: torch.full_like(idx, 46))
        out = _place(out, k, length + 1, torch.full_like(v, scale),
                     _gather_digits(d, torch.full_like(v, 19 - scale)))
        length = length + 1 + scale
    return from_matrix(out, length, valid, out_w)


def civil_from_days(days: torch.Tensor):
    """(year, month, day) int64 of days since 1970-01-01 in the proleptic
    Gregorian calendar (H. Hinnant's ``civil_from_days``)."""
    z = days.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor") +
                    torch.div(doe, 36524, rounding_mode="floor") -
                    torch.div(doe, 146096, rounding_mode="floor"), 365,
                    rounding_mode="floor")
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor") -
                 torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    day = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    month = torch.where(mp < 10, mp + 3, mp - 9)
    year = yoe + era * 400 + (month <= 2).to(torch.int64)
    return year, month, day


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """Days since 1970-01-01 of a proleptic Gregorian date (H. Hinnant's
    ``days_from_civil``)."""
    y = y - (m <= 2).to(torch.int64)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + d - 1
    doe = yoe * 365 + torch.div(yoe, 4, rounding_mode="floor") - \
        torch.div(yoe, 100, rounding_mode="floor") + doy
    return era * 146097 + doe - 719468


def format_date(days: torch.Tensor, valid: torch.Tensor):
    """A DATE as Java's ``LocalDate.toString``: ``yyyy-MM-dd``, the year
    zero-padded to four digits, ``+`` before a year past 9999 and ``-``
    before a negative one."""
    year, month, day = civil_from_days(days)
    yd = _digit_matrix(year, 7)
    ny = torch.maximum(_count_digits(yd), torch.full_like(year, 4))
    sign = torch.where(year < 0, 45, torch.where(year > 9999, 43, 0))
    ns = (sign != 0).to(torch.int64)
    k = torch.arange(14, device=days.device)[None, :].expand(
        days.shape[0], -1)
    out = sign[:, None].expand(-1, 14).clone()
    out = _place(out, k, ns, ny, _gather_digits(yd, 7 - ny))
    md = torch.stack([torch.full_like(month, 45),
                      torch.div(month, 10, rounding_mode="floor") + 48,
                      month % 10 + 48, torch.full_like(month, 45),
                      torch.div(day, 10, rounding_mode="floor") + 48,
                      day % 10 + 48], 1)
    out = _place(out, k, ns + ny, torch.full_like(year, 6),
                 lambda idx: md.gather(1, idx.clamp(max=5)))
    return from_matrix(out, ns + ny + 6, valid, 14)


def format_bool(data: torch.Tensor, valid: torch.Tensor):
    """``true`` / ``false``."""
    words = torch.tensor([list(b"false"), list(b"true\0")],
                         dtype=torch.int64, device=data.device)
    out = words[data.to(torch.int64)]
    return from_matrix(out, torch.where(data, 4, 5), valid, 5)


#: positions of the per-row source of ``format_float``'s layout
_SIGN, _DIGITS, _DOT, _E, _MINUS, _EXP, _ZEROS = 0, 1, 18, 19, 20, 21, 24
_INF, _NAN = 48, 56
_WORDS = b"Infinity" + b"NaN"


def format_float(x: torch.Tensor, valid: torch.Tensor):
    """A FLOAT or DOUBLE as Java's ``Float.toString`` /
    ``Double.toString`` lays it out, from the shortest digits of
    ``cuda_ops.format_double``: ``ddd.ddd`` for 1e-3 <= |x| < 1e7 (at
    least one digit after the point), ``d.dddE±n`` otherwise (``E-n``,
    ``En``), and ``NaN``, ``Infinity``, ``-Infinity``, ``0.0``,
    ``-0.0``."""
    dev = x.device
    n = x.shape[0]
    digits, exp10 = cuda_ops.format_double(x.contiguous())
    d = _digit_matrix(digits, 17)
    nd = _count_digits(d)
    e10 = exp10.to(torch.int64) + nd - 1
    neg = torch.signbit(x) & ~torch.isnan(x)
    ed = _digit_matrix(e10.abs(), 3)
    ne = _count_digits(ed)
    src = torch.full((n, 64), 48, dtype=torch.int64, device=dev)
    src[:, _SIGN] = 45
    src[:, _DIGITS:_DIGITS + 17] = 48 + d.gather(
        1, ((17 - nd)[:, None] + torch.arange(17, device=dev)).clamp(
            max=16))
    src[:, _DOT], src[:, _E], src[:, _MINUS] = 46, 69, 45
    src[:, _EXP:_EXP + 3] = 48 + ed.gather(
        1, ((3 - ne)[:, None] + torch.arange(3, device=dev)).clamp(max=2))
    src[:, _INF:_INF + 11] = torch.tensor(list(_WORDS), dtype=torch.int64,
                                          device=dev)
    z = torch.zeros_like(nd)
    one = torch.ones_like(nd)
    ns = neg.to(torch.int64)
    plain = (e10 >= -3) & (e10 < 7)
    up = e10 >= 0
    # pieces (start in src, length): sign, then six more by layout
    lead = torch.where(up, torch.minimum(nd, e10 + 1), z)
    fill = torch.where(up, (e10 + 1 - nd).clamp(min=0), one)
    tail = torch.where(up, (nd - e10 - 1).clamp(min=0), z)
    plain_pieces = [
        (torch.full_like(nd, _DIGITS), torch.where(up, lead, z)),
        (torch.full_like(nd, _ZEROS), fill),
        (torch.full_like(nd, _DOT), one),
        (torch.full_like(nd, _ZEROS), torch.where(up, z, -e10 - 1)),
        (torch.where(up, _DIGITS + e10 + 1, _DIGITS),
         torch.where(up, tail, nd)),
        (torch.full_like(nd, _ZEROS),
         torch.where(up, (tail == 0).to(torch.int64), z)),
        (z, z), (z, z)]
    sci_pieces = [
        (torch.full_like(nd, _DIGITS), one), (z, z),
        (torch.full_like(nd, _DOT), one), (z, z),
        (torch.full_like(nd, _DIGITS + 1), nd - 1),
        (torch.full_like(nd, _ZEROS), (nd == 1).to(torch.int64)),
        (torch.full_like(nd, _E), one),
        (torch.full_like(nd, _MINUS), (e10 < 0).to(torch.int64))]
    finite = torch.isfinite(x)
    zero = finite & (x == 0)
    nan = torch.isnan(x)
    special_pieces = [  # 0.0, NaN, Infinity
        (torch.where(zero, _ZEROS, torch.where(nan, _NAN, _INF)),
         torch.where(zero, one, torch.where(nan, 3 * one, 8 * one))),
        (z, z), (torch.full_like(nd, _DOT), zero.to(torch.int64)), (z, z),
        (torch.full_like(nd, _ZEROS), zero.to(torch.int64)), (z, z), (z, z),
        (z, z)]
    sci_pieces.append((torch.full_like(nd, _EXP), ne))
    plain_pieces.append((z, z))
    special_pieces.append((z, z))
    pieces = [(torch.full_like(nd, _SIGN), ns)]
    for pp, sp, xp in zip(plain_pieces, sci_pieces, special_pieces):
        pieces.append(tuple(torch.where(finite & ~zero, torch.where(
            plain, a, b), c) for a, b, c in zip(pp, sp, xp)))
    width = 24 if x.dtype == torch.float64 else 15
    k = torch.arange(width, device=dev)[None, :].expand(n, -1)
    out = torch.zeros((n, width), dtype=torch.int64, device=dev)
    begin = torch.zeros_like(nd)
    for s, ln in pieces:
        out = _place(out, k, begin, ln,
                     lambda idx, s=s: src.gather(1, (s[:, None] + idx)
                                                 .clamp(max=63)))
        begin = begin + ln
    return from_matrix(out, begin, valid, width)


# -- text to values ---------------------------------------------------------------

def byte_matrix(col) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64[cap, max_bytes] of each row's bytes, 0 past its end; int64
    lengths)."""
    w = max(col.max_bytes, 1)
    starts = col.offsets[:-1].to(torch.int64)
    lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    k = torch.arange(w, device=starts.device)
    idx = (starts[:, None] + k).clamp(0, max(col.data.shape[0] - 1, 0))
    mat = torch.where(k < lens[:, None], col.data[idx].to(torch.int64), 0)
    return mat, lens


def _trimmed(mat, lens, java: bool):
    """(lo, hi) int64: the row's bytes with those Spark trims removed
    from both ends (Java's ``String.trim``: up to 0x20; Spark's
    ``trimAll``: those and DEL)."""
    w = mat.shape[1]
    k = torch.arange(w, device=mat.device)
    inside = k < lens[:, None]
    space = mat <= _SPACE if java else (mat <= _SPACE) | (mat == _DEL)
    solid = inside & ~space
    lo = torch.where(solid, k, w).min(1).values
    hi = torch.where(solid, k + 1, 0).max(1).values
    return lo, torch.maximum(hi, lo)


def _at(mat, pos):
    """int64[n]: the byte at ``pos`` of each row (0 out of range)."""
    w = mat.shape[1]
    got = mat.gather(1, pos.clamp(0, w - 1)[:, None])[:, 0]
    return torch.where((pos >= 0) & (pos < w), got, 0)


def _first(mask, k, lo, hi, w):
    """int64[n]: the first position in [lo, hi) where ``mask`` holds,
    else ``hi``."""
    hit = mask & (k >= lo[:, None]) & (k < hi[:, None])
    return torch.minimum(torch.where(hit, k, w).min(1).values, hi)


def parse_integer(col, is64: bool):
    """(int64 values, ok) of Spark's ``UTF8String.toLong`` / ``toInt``:
    trimmed, an optional sign, digits, and an optional fraction of digits
    that is dropped; NULL for anything else or a value past the type."""
    mat, lens = byte_matrix(col)
    n, w = mat.shape
    k = torch.arange(w, device=mat.device)
    lo, hi = _trimmed(mat, lens, java=False)
    b0 = _at(mat, lo)
    signed = (b0 == 45) | (b0 == 43)
    neg = b0 == 45
    ok = col.validity & (hi > lo) & ~(signed & (hi - lo == 1))
    ds = lo + signed.to(torch.int64)
    digit = (mat >= 48) & (mat <= 57)
    pp = _first(mat == 46, k, ds, hi, w)
    in_int = (k >= ds[:, None]) & (k < pp[:, None])
    in_frac = (k > pp[:, None]) & (k < hi[:, None])
    ok = ok & ~((in_int | in_frac) & ~digit).any(1)
    low = _MIN64 if is64 else -(1 << 31)
    stop = -(-low // 10)
    acc = torch.zeros(n, dtype=torch.int64, device=mat.device)
    over = torch.zeros(n, dtype=torch.bool, device=mat.device)
    for j in range(w):
        step = in_int[:, j] & digit[:, j]
        dv = mat[:, j] - 48
        bad = step & ((acc < stop) | ((acc == stop) & (dv > -(low - stop *
                                                              10))))
        over = over | bad
        acc = torch.where(step & ~bad, acc * 10 - dv, acc)
    ok = ok & ~over & (neg | (acc != low))
    value = torch.where(neg, acc, -torch.where(acc == low, 0, acc))
    return value, ok


def _exponent(mat, k, lo, hi, w):
    """(value, ok) of an exponent ``[+-]digits`` in [lo, hi): at least
    one digit; a magnitude past 10^7 saturates there."""
    b0 = _at(mat, lo)
    signed = (b0 == 45) | (b0 == 43)
    ds = lo + signed.to(torch.int64)
    region = (k >= ds[:, None]) & (k < hi[:, None])
    digit = (mat >= 48) & (mat <= 57)
    ok = (hi > ds) & ~(region & ~digit).any(1)
    place = hi[:, None] - 1 - k
    vals = torch.where(region & (place < 8),
                       (mat - 48).clamp(0, 9) * _pow10(mat.device)[
                           place.clamp(0, 7)], 0).sum(1)
    big = (region & (place >= 8) & (mat != 48)).any(1)
    vals = torch.where(big | (vals > 10 ** 7), 10 ** 7, vals)
    return torch.where(b0 == 45, -vals, vals), ok


def parse_decimal(col, precision: int, scale: int):
    """(unscaled int64, ok) of Java's ``new BigDecimal(s.trim())`` cut to
    ``decimal(precision, scale)`` HALF_UP, exactly, from the digits
    themselves; NULL for text that is no number and for a value past the
    precision."""
    mat, lens = byte_matrix(col)
    n, w = mat.shape
    k = torch.arange(w, device=mat.device)
    lo, hi = _trimmed(mat, lens, java=True)
    b0 = _at(mat, lo)
    neg = b0 == 45
    ds = lo + ((b0 == 45) | (b0 == 43)).to(torch.int64)
    me = _first((mat == 101) | (mat == 69), k, ds, hi, w)
    pp = _first(mat == 46, k, ds, me, w)
    digit = (mat >= 48) & (mat <= 57)
    mant = (k >= ds[:, None]) & (k < me[:, None]) & (k != pp[:, None])
    ok = col.validity & ~(mant & ~digit).any(1) & (mant & digit).any(1)
    ex, ex_ok = _exponent(mat, k, me + 1, hi, w)
    ok = ok & (ex_ok | (me == hi))
    ex = torch.where(me == hi, 0, ex)
    place = torch.where(k < pp[:, None], pp[:, None] - 1 - k,
                        pp[:, None] - k)
    wt = place + ex[:, None] + scale
    dv = torch.where(mant, mat - 48, 0)
    body = torch.where((wt >= 0) & (wt <= 17),
                       dv * _pow10(mat.device, 18)[wt.clamp(0, 17)],
                       0).sum(1)
    over = ((wt >= 18) & (dv > 0)).any(1)
    up = ((wt == -1) & (dv >= 5)).any(1).to(torch.int64)
    mag = body + up
    ok = ok & ~over & (mag <= 10 ** precision - 1)
    value = torch.where(neg, -mag, mag)
    return torch.where(ok, value, 0), ok


def _days_in_month(y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    table = torch.tensor([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                         dtype=torch.int64, device=y.device)
    return table[m.clamp(0, 12)] + ((m == 2) & leap).to(torch.int64)


def _segment_value(mat, k, lo, hi):
    """int64: the digits of [lo, hi) as a number (at most 7 of them)."""
    region = (k >= lo[:, None]) & (k < hi[:, None])
    place = hi[:, None] - 1 - k
    return torch.where(region, (mat - 48).clamp(0, 9) *
                       _pow10(mat.device, 8)[place.clamp(0, 7)], 0).sum(1)


def parse_date(col):
    """(days int32, ok) of Spark's ``stringToDate``: trimmed, an optional
    sign, ``y..y`` (4 to 7 digits), ``y..y-[m]m`` or ``y..y-[m]m-[d]d``,
    the last optionally followed by ``T`` or a space and anything; NULL
    for anything else and for a day that is not in the calendar."""
    mat, lens = byte_matrix(col)
    n, w = mat.shape
    k = torch.arange(w, device=mat.device)
    lo, hi = _trimmed(mat, lens, java=False)
    b0 = _at(mat, lo)
    sign = torch.where(b0 == 45, -1, 1)
    ys = lo + ((b0 == 45) | (b0 == 43)).to(torch.int64)
    sp = _first((mat == 32) | (mat == 84), k, ys, hi, w)
    dash = mat == 45
    d1 = _first(dash, k, ys, sp, w)
    d2 = _first(dash, k, (d1 + 1).clamp(max=sp), sp, w)
    third = _first(dash, k, (d2 + 1).clamp(max=sp), sp, w)
    digit = (mat >= 48) & (mat <= 57)
    region = (k >= ys[:, None]) & (k < sp[:, None])
    seps = (k == d1[:, None]) | (k == d2[:, None])
    ok = col.validity & (hi > lo) & ~(region & ~digit & ~seps).any(1) & \
        (third == sp)
    nseg = (d1 < sp).to(torch.int64) + (d2 < sp).to(torch.int64)
    ny = d1 - ys
    nm = d2 - d1 - 1
    nday = sp - d2 - 1
    ok = ok & (ny >= 4) & (ny <= 7)
    ok = ok & ((nseg < 1) | ((nm >= 1) & (nm <= 2)))
    ok = ok & ((nseg < 2) | ((nday >= 1) & (nday <= 2)))
    ok = ok & ((nseg == 2) | (sp == hi))
    year = sign * _segment_value(mat, k, ys, d1)
    month = torch.where(nseg >= 1, _segment_value(mat, k, d1 + 1, d2), 1)
    day = torch.where(nseg == 2, _segment_value(mat, k, d2 + 1, sp), 1)
    ok = ok & (month >= 1) & (month <= 12) & (day >= 1) & \
        (day <= _days_in_month(year, month))
    days = days_from_civil(year, month, day)
    ok = ok & (days >= -(1 << 31)) & (days < (1 << 31))
    return torch.where(ok, days, 0).to(torch.int32), ok


_TRUE = (b"t", b"true", b"y", b"yes", b"1")
_FALSE = (b"f", b"false", b"n", b"no", b"0")


def parse_bool(col):
    """(value, ok) of Spark's string to BOOL: trimmed, in any case, one of
    ``t true y yes 1`` or ``f false n no 0``; NULL otherwise."""
    mat, lens = byte_matrix(col)
    n, w = mat.shape
    lo, hi = _trimmed(mat, lens, java=False)
    low = torch.where((mat >= 65) & (mat <= 90), mat + 32, mat)
    length = hi - lo
    shifted = low.gather(1, (lo[:, None] + torch.arange(
        5, device=mat.device)).clamp(max=w - 1))

    def is_word(word):
        want = torch.tensor(list(word) + [0] * (5 - len(word)),
                            dtype=torch.int64, device=mat.device)
        pos = torch.arange(5, device=mat.device)
        same = (shifted == want) | (pos >= len(word))
        return (length == len(word)) & same.all(1)
    yes = torch.zeros(n, dtype=torch.bool, device=mat.device)
    no = torch.zeros_like(yes)
    for word in _TRUE:
        yes = yes | is_word(word)
    for word in _FALSE:
        no = no | is_word(word)
    return yes, col.validity & (yes | no)


def parse_float(col, f32: bool):
    """(value, ok) of Java's ``Double.parseDouble`` / ``Float.parseFloat``
    and Spark's special literals, by the ``parse_double`` kernel."""
    return cuda_ops.parse_double(col.offsets.contiguous(), col.data,
                                 col.validity.contiguous(), f32)
