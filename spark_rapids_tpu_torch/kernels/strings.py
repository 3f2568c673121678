"""String kernels over the Arrow offsets + bytes device layout.

Counterpart of ``spark_rapids_tpu/kernels/strings.py``.  A string column
is ``offsets`` int32[cap + 1] and ``data`` uint8[bytes]; row i is bytes
``[offsets[i], offsets[i + 1])``.  Every op is integer torch work over
those two buffers: byte gathers, packing into 64-bit words, and one
scatter to compact gathered rows.  Sizing a gather's byte buffer needs no
host read: a column carries a host bound on its longest string
(``max_bytes``), and the buffer holds ``rows x max_bytes``.

The string function library (trim, reverse, locate, pad, repeat,
replace, initcap, concat_ws, greatest / least, LIKE) works on the flat
byte buffer where it can: each byte finds its row by one search of the
offsets (``_byte_rows``), and a function whose output sizes depend on the
data reads the batch's total output bytes from the device once
(``_assemble``), where the reference runs host loops
(``_HostStringOp``).  Characters are UTF-8 characters; case mapping is
ASCII alone, as the reference's.

Key words (sort, group-by, join): ``num_words`` big-endian 64-bit words
of each string's bytes, zero-padded, then its length, so unsigned
lexicographic word order is byte order with shorter prefixes first.
Columns compared against each other must agree on ``num_words``
(``needed_key_words`` over all of them).  Partition ids take
``partition_words`` instead: the string's own words folded into one, so
a string's id does not depend on the batch it arrives in.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .basic import SIGN64, mix64

#: seed of the partition fold of a string's words
FOLD_SEED = 0x5851F42D4C957F2D


def string_lengths(offsets: torch.Tensor) -> torch.Tensor:
    return (offsets[1:] - offsets[:-1]).to(torch.int32)


def pack_words(offsets: torch.Tensor, data: torch.Tensor,
               num_words: int) -> torch.Tensor:
    """[cap, num_words] big-endian words (int64 bit patterns) of each
    string's first ``8 * num_words`` bytes, zero-padded."""
    starts = offsets[:-1].to(torch.int64)
    lens = (offsets[1:] - offsets[:-1]).to(torch.int64)
    k = torch.arange(num_words * 8, device=offsets.device)
    idx = (starts[:, None] + k[None, :]).clamp(0, max(data.shape[0] - 1, 0))
    byts = torch.where(k[None, :] < lens[:, None], data[idx].to(torch.int64),
                       0)
    w = byts.reshape(-1, num_words, 8)
    shifts = 8 * (7 - torch.arange(8, device=offsets.device))
    out = torch.zeros(w.shape[:2], dtype=torch.int64, device=offsets.device)
    for j in range(8):
        out |= w[:, :, j] << int(shifts[j])
    return out


def needed_key_words(col) -> int:
    """Word count (a power of two) that holds the column's longest
    string, from the host bound it carries."""
    num_words = max(1, -(-col.max_bytes // 8))
    return 1 << (num_words - 1).bit_length()


def string_key_words(col, num_words: int = None) -> List[torch.Tensor]:
    """Byte words + the length word (int64 bit patterns), one per row of
    the column's capacity."""
    if num_words is None:
        num_words = needed_key_words(col)
    words = pack_words(col.offsets, col.data, num_words)
    out = [words[:, i] for i in range(num_words)]
    out.append(string_lengths(col.offsets).to(torch.int64))
    return out


def partition_words(col) -> List[torch.Tensor]:
    """[fold, length]: each row's own ``ceil(len / 8)`` packed words
    folded by ``mix64`` (padding words skipped), then its length.  The
    pair is a function of the string alone, whatever width its batch
    needs, so one key lands in one partition."""
    nw = needed_key_words(col)
    lens = string_lengths(col.offsets).to(torch.int64)
    own = (lens + 7) // 8
    words = pack_words(col.offsets, col.data, nw)
    h = torch.full_like(lens, FOLD_SEED)
    for i in range(nw):
        h = torch.where(own > i, mix64(h ^ words[:, i]), h)
    return [h, lens]


def copy_rows(data: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
              max_bytes: int):
    """Rows ``[starts[i], starts[i] + lens[i])`` of ``data`` packed one
    after another: (offsets int32[n + 1], bytes uint8).  The byte buffer
    holds ``n * max_bytes`` (every ``lens[i] <= max_bytes``), so its size
    is known without a host read."""
    n = lens.shape[0]
    dev = lens.device
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens, 0)
    size = n * max_bytes
    if size == 0:
        return offsets, torch.zeros(1, dtype=torch.uint8, device=dev)
    k = torch.arange(max_bytes, device=dev)
    inb = k[None, :] < lens[:, None]
    src = (starts.to(torch.int64)[:, None] + k).clamp(
        0, max(data.shape[0] - 1, 0))
    # bytes past a row's length go to one spare slot, dropped below
    dst = torch.where(inb, offsets[:-1].to(torch.int64)[:, None] + k, size)
    out = torch.zeros(size + 1, dtype=torch.uint8, device=dev)
    out.scatter_(0, dst.reshape(-1), data[src.reshape(-1)])
    return offsets, out[:size]


def gather_strings(col, indices: torch.Tensor, live: torch.Tensor = None):
    """Rows ``indices`` (clipped into range) as a new column; rows where
    ``live`` is False, and null rows, come out null and empty."""
    from ..columnar.column import StringColumn
    src = indices.clamp(0, max(col.capacity - 1, 0))
    starts = col.offsets[:-1][src]
    lens = string_lengths(col.offsets)[src]
    valid = col.validity[src]
    if live is not None:
        valid = valid & live
    lens = torch.where(valid, lens, 0)
    offsets, data = copy_rows(col.data, starts, lens, col.max_bytes)
    return StringColumn(offsets, data, valid, col.max_bytes)


def choose_rows(cols, which: torch.Tensor, valid: torch.Tensor):
    """Row i of ``cols[which[i]]`` (string columns of one capacity) as a
    new column; rows where ``valid`` is False come out null and empty."""
    from ..columnar.column import StringColumn
    starts, lens, base = [], [], 0
    for c in cols:
        starts.append(c.offsets[:-1].to(torch.int64) + base)
        lens.append(string_lengths(c.offsets))
        base += int(c.data.shape[0])
    rows = torch.arange(which.shape[0], device=which.device)
    start = torch.stack(starts)[which, rows]
    n = torch.where(valid, torch.stack(lens)[which, rows], 0)
    mb = max(c.max_bytes for c in cols)
    offsets, data = copy_rows(torch.cat([c.data for c in cols]), start, n,
                              mb)
    return StringColumn(offsets, data, valid, mb)


def _shift_case(col, lo: int, hi: int, delta: int):
    """``col`` with each byte in [lo, hi] moved by ``delta``: the ASCII
    letters alone, as the reference's byte tables do (a byte of a
    multi-byte UTF-8 character is 0x80 or more, and stays)."""
    d = col.data
    data = torch.where((d >= lo) & (d <= hi), d + delta, d).to(torch.uint8)
    return type(col)(col.offsets, data, col.validity, col.max_bytes)


def upper(col):
    """ASCII upper case (``strings.upper`` of the reference)."""
    return _shift_case(col, ord("a"), ord("z"), -32)


def lower(col):
    """ASCII lower case (``strings.lower`` of the reference)."""
    return _shift_case(col, ord("A"), ord("Z"), 32)


class LiteralBytes:
    """A string literal's UTF-8 bytes and their copy on each device.  The
    expression that holds one uploads its literal once per device, never
    per batch."""

    def __init__(self, text):
        self.raw = text if isinstance(text, bytes) else \
            str(text).encode("utf-8")
        self._on: Dict[str, torch.Tensor] = {}

    def __len__(self):
        return len(self.raw)

    def on(self, device) -> torch.Tensor:
        t = self._on.get(str(device))
        if t is None:
            t = torch.tensor(list(self.raw), dtype=torch.uint8,
                             device=device)
            self._on[str(device)] = t
        return t


def held_literal(held: Dict, text) -> LiteralBytes:
    """``text``'s LiteralBytes in an expression's ``held`` dict (shared
    by the expression's bound copies), made on first use."""
    lit = held.get(text)
    if lit is None:
        lit = held[text] = LiteralBytes(text)
    return lit


def _bytes_at(col, pos: torch.Tensor, m: int) -> torch.Tensor:
    """[cap, m] bytes of the data buffer from per-row byte positions."""
    k = torch.arange(m, device=col.offsets.device)
    idx = (pos.to(torch.int64)[:, None] + k).clamp(
        0, max(col.data.shape[0] - 1, 0))
    return col.data[idx]


def _match_at(col, pos: torch.Tensor, lit: LiteralBytes) -> torch.Tensor:
    """bool[cap]: the bytes at ``pos`` are ``lit`` (not bounds-checked)."""
    want = lit.on(col.offsets.device)
    return (_bytes_at(col, pos, len(lit)) == want).all(dim=1)


def equal_literal(col, lit: LiteralBytes) -> torch.Tensor:
    """bool[cap]: the row's bytes equal the literal's."""
    lens = string_lengths(col.offsets)
    eq = lens == len(lit)
    if lit and len(lit) <= col.max_bytes:
        eq = eq & _match_at(col, col.offsets[:-1], lit)
    elif lit:
        eq = torch.zeros_like(eq)
    return eq


def starts_with(col, prefix: LiteralBytes) -> torch.Tensor:
    """bool[cap]: the row begins with ``prefix``."""
    lens = string_lengths(col.offsets)
    if not prefix:
        return torch.ones_like(lens, dtype=torch.bool)
    if len(prefix) > col.max_bytes:
        return torch.zeros_like(lens, dtype=torch.bool)
    return (lens >= len(prefix)) & _match_at(col, col.offsets[:-1], prefix)


def ends_with(col, suffix: LiteralBytes) -> torch.Tensor:
    """bool[cap]: the row ends with ``suffix``."""
    lens = string_lengths(col.offsets)
    if not suffix:
        return torch.ones_like(lens, dtype=torch.bool)
    if len(suffix) > col.max_bytes:
        return torch.zeros_like(lens, dtype=torch.bool)
    return (lens >= len(suffix)) & _match_at(col, col.offsets[1:] -
                                             len(suffix), suffix)


def contains(col, needle: LiteralBytes) -> torch.Tensor:
    """bool[cap]: ``needle`` occurs in the row.  Every byte position of
    the buffer is compared with the needle once; a row holds a match if
    one starts in ``[start, end - len(needle)]``, counted by a prefix sum
    of the match flags."""
    lens = string_lengths(col.offsets)
    if not needle:
        return torch.ones_like(lens, dtype=torch.bool)
    if len(needle) > col.max_bytes:
        return torch.zeros_like(lens, dtype=torch.bool)
    nbytes = col.data.shape[0]
    pos = torch.arange(nbytes, device=col.offsets.device)
    hit = _match_at(col, pos, needle) & (pos + len(needle) <= nbytes)
    cum = torch.zeros(nbytes + 1, dtype=torch.int64,
                      device=col.offsets.device)
    cum[1:] = torch.cumsum(hit.to(torch.int64), 0)
    starts = col.offsets[:-1].to(torch.int64).clamp(0, nbytes)
    ends = torch.maximum(col.offsets[1:].to(torch.int64) - len(needle) + 1,
                         starts).clamp(0, nbytes)
    return (cum[ends] - cum[starts]) > 0


def _char_positions(offsets: torch.Tensor, data: torch.Tensor):
    """(first, nchars, byte_of) of each row's UTF-8 characters: the
    buffer's count of character starts (bytes that are not continuation
    bytes, as the reference's ``char_length`` counts them) before the
    row, the row's character count, and ``byte_of(k)``, the byte position
    of each row's character ``k`` (its end for ``k >= nchars``)."""
    is_start = (data & 0xC0) != 0x80
    cs = torch.zeros(data.shape[0] + 1, dtype=torch.int64,
                     device=data.device)
    cs[1:] = torch.cumsum(is_start.to(torch.int64), 0)
    starts = offsets[:-1].to(torch.int64)
    ends = offsets[1:].to(torch.int64)
    first = cs[starts]
    nchars = cs[ends] - first

    def byte_of(k: torch.Tensor) -> torch.Tensor:
        # the first byte whose inclusive count of starts passes the
        # global ordinal of character k is that character's first byte
        pos = torch.searchsorted(cs[1:], first + k, right=True)
        return torch.where(k >= nchars, ends, pos)
    return nchars, byte_of


def _substring_offsets(offsets: torch.Tensor, data: torch.Tensor,
                       start: int, length: Optional[int]):
    """Spark's substring positions, in characters: a 1-based ``start``, 0
    read as 1, a negative one counted from the end (clamped to the first
    character); at most ``length`` characters.  Returns (source byte
    start, byte count) per row."""
    lens, byte_of = _char_positions(offsets, data)
    if start > 0:
        s = torch.full_like(lens, start - 1)
    elif start < 0:
        s = (lens + start).clamp(min=0)
    else:
        s = torch.zeros_like(lens)
    s = torch.minimum(s, lens)
    room = lens - s
    n = room if length is None else torch.clamp(room, max=max(length, 0))
    src = byte_of(s)
    return src, byte_of(s + n) - src


def substring(col, start: int, length: Optional[int]):
    """``substring(col, start, length)`` by characters (Spark's semantics;
    the reference's device kernel counts bytes and cuts a multi-byte
    character).  A character is at most 4 bytes, so the result's host
    bound is ``min(max_bytes, 4 * length)``: no size is read from the
    device."""
    from ..columnar.column import StringColumn
    src, n = _substring_offsets(col.offsets, col.data, start, length)
    n = torch.where(col.validity, n, 0).to(torch.int32)
    mb = col.max_bytes if length is None else \
        min(col.max_bytes, 4 * max(length, 0))
    offsets, data = copy_rows(col.data, src, n, mb)
    return StringColumn(offsets, data, col.validity, mb)


def concat(parts, capacity: int, device):
    """Byte concatenation of ``parts``, each a string column or a
    LiteralBytes; null if any column part is null.  The output's
    host bound is the sum of the parts' bounds."""
    from ..columnar.column import StringColumn
    valid = torch.ones(capacity, dtype=torch.bool, device=device)
    lens = []
    for p in parts:
        if isinstance(p, LiteralBytes):
            lens.append(None)
        else:
            valid = valid & p.validity
            lens.append(string_lengths(p.offsets).to(torch.int64))
    total = torch.zeros(capacity, dtype=torch.int64, device=device)
    for p, ln in zip(parts, lens):
        total = total + (len(p) if ln is None else ln)
    total = torch.where(valid, total, 0)
    offsets = torch.zeros(capacity + 1, dtype=torch.int32, device=device)
    offsets[1:] = torch.cumsum(total, 0)
    bounds = [len(p) if isinstance(p, LiteralBytes) else p.max_bytes
              for p in parts]
    size = capacity * sum(bounds)
    out = torch.zeros(size + 1, dtype=torch.uint8, device=device)
    base = offsets[:-1].to(torch.int64)
    for p, ln, mb in zip(parts, lens, bounds):
        if mb == 0:
            continue
        k = torch.arange(mb, device=device)
        if ln is None:
            inb = valid[:, None] & (k[None, :] < mb)
            src = p.on(device).expand(capacity, mb)
        else:
            inb = valid[:, None] & (k[None, :] < ln[:, None])
            src = _bytes_at(p, p.offsets[:-1], mb)
        # bytes past a part's length go to one spare slot, dropped below
        dst = torch.where(inb, base[:, None] + k, size)
        out.scatter_(0, dst.reshape(-1), src.reshape(-1))
        base = base + torch.where(valid, mb if ln is None else ln, 0)
    return StringColumn(offsets, out[:max(size, 1)], valid, sum(bounds))


# -- the string function library ----------------------------------------------

def _bounds(col):
    """(starts, ends) int64[cap] of each row's bytes."""
    return col.offsets[:-1].to(torch.int64), col.offsets[1:].to(torch.int64)


def _byte_rows(col) -> torch.Tensor:
    """int64[bytes]: the row each byte of the data buffer lies in (a byte
    before the first row's start counts to row 0, one past the last row's
    end to ``cap``; callers test ``starts[row] <= pos < ends[row]``)."""
    pos = torch.arange(col.data.shape[0], device=col.offsets.device)
    return torch.searchsorted(col.offsets[1:].to(torch.int64), pos,
                              right=True)


def _in_rows(col):
    """(pos, row clipped into range, whether the byte lies in its row) of
    every byte of the buffer."""
    starts, ends = _bounds(col)
    pos = torch.arange(col.data.shape[0], device=col.offsets.device)
    row = _byte_rows(col).clamp(max=max(col.capacity - 1, 0))
    inside = (pos >= starts[row]) & (pos < ends[row])
    return pos, row, inside


def _assemble(lens: torch.Tensor, valid: torch.Tensor, max_bytes: int,
              source):
    """A string column whose row i has ``lens[i]`` bytes (0 where not
    ``valid``): its offsets by one cumsum, its byte count read from the
    device once, and byte k of row r copied from ``source(r, k)`` (int64
    positions of one buffer, returned with it: ``(buffer, positions)``).
    """
    from ..columnar.column import StringColumn
    dev = lens.device
    n = lens.shape[0]
    lens = torch.where(valid, lens.to(torch.int64), 0)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(lens, 0)
    total = int(offsets[-1])                # the one host read
    j = torch.arange(total, device=dev)
    r = torch.searchsorted(offsets[1:], j, right=True)
    k = j - offsets[r]
    buf, src = source(r, k)
    data = buf[src] if total else torch.zeros(1, dtype=torch.uint8,
                                              device=dev)
    return StringColumn(offsets.to(torch.int32), data, valid, max_bytes)


def _pieces(bufs, starts, lens, valid, max_bytes: int):
    """Each row as the concatenation of P pieces: piece p of row r is
    ``lens[r, p]`` bytes from ``starts[r, p]`` of the buffers ``bufs``
    laid end to end (``starts`` count from the first buffer's start)."""
    buf = torch.cat(bufs) if len(bufs) > 1 else bufs[0]
    lens = torch.where(valid[:, None], lens.to(torch.int64), 0)
    ends = torch.cumsum(lens, 1)

    def source(r, k):
        p = (k[:, None] >= ends[r]).sum(1)
        begin = ends[r, p] - lens[r, p]
        return buf, starts[r, p] + (k - begin)
    return _assemble(lens.sum(1), valid, max_bytes, source)


def char_lengths(col) -> torch.Tensor:
    """int32[cap]: each row's count of UTF-8 characters (Spark's
    ``length``)."""
    nchars, _ = _char_positions(col.offsets, col.data)
    return nchars.to(torch.int32)


def _nth_marked(counts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The position of the (k+1)-th marked byte, from ``counts`` (int64
    [bytes + 1], the marked bytes before each position)."""
    return torch.searchsorted(counts[1:], k + 1)


def _marked_counts(mark: torch.Tensor) -> torch.Tensor:
    counts = torch.zeros(mark.shape[0] + 1, dtype=torch.int64,
                         device=mark.device)
    counts[1:] = torch.cumsum(mark.to(torch.int64), 0)
    return counts


def trim(col, side: str = "both"):
    """``trim`` / ``ltrim`` / ``rtrim``: the spaces (0x20) at the
    ``both``, ``leading`` or ``trailing`` end of each row removed.  A
    row's first and last other bytes are found by a search of the
    buffer's running count of such bytes, not by a scatter per row."""
    from ..columnar.column import StringColumn
    starts, ends = _bounds(col)
    nb = col.data.shape[0]
    counts = _marked_counts(col.data != 32)
    before = counts[starts.clamp(max=nb)]
    through = counts[ends.clamp(max=nb)]
    some = through > before
    first = _nth_marked(counts, before)
    last = _nth_marked(counts, through - 1)
    lo = starts if side == "trailing" else torch.where(some, first, ends)
    hi = ends if side == "leading" else torch.where(some, last + 1, lo)
    n = torch.where(col.validity, (hi - lo).clamp(min=0), 0)
    offsets, data = copy_rows(col.data, lo, n.to(torch.int32),
                              col.max_bytes)
    return StringColumn(offsets, data, col.validity, col.max_bytes)


def _char_starts(col, inside: torch.Tensor, pos: torch.Tensor,
                 row: torch.Tensor):
    """bool[bytes]: the byte begins a character of its row: a byte that
    is no continuation byte (0b10xxxxxx), or one with no other byte of the
    row among the three before it that is (a stray continuation byte is
    a character of its own, so that no character is longer than 4)."""
    d = col.data
    lead = (d & 0xC0) != 0x80
    near = torch.zeros_like(lead)
    starts, _ = _bounds(col)
    for k in (1, 2, 3):
        back = pos - k
        near |= (back >= starts[row]) & lead[back.clamp(min=0)]
    return inside & (lead | ~near)


def reverse(col):
    """``reverse``: each row's characters in reverse order.  A byte moves
    to ``start + (end - its character's end) + (its offset in the
    character)``; the row keeps its offsets."""
    from ..columnar.column import StringColumn
    starts, ends = _bounds(col)
    pos, row, inside = _in_rows(col)
    first = _char_starts(col, inside, pos, row)
    nb = col.data.shape[0]
    s, e = starts[row], ends[row]
    cs = pos.clone()
    found = first.clone()
    for k in (1, 2, 3):
        back = (pos - k).clamp(min=0)
        hit = ~found & (pos - k >= s) & first[back]
        cs = torch.where(hit, pos - k, cs)
        found |= hit
    ce = e.clone()
    done = torch.zeros_like(first)
    for k in (1, 2, 3, 4):
        ahead = pos + k
        hit = ~done & ((ahead >= e) | first[ahead.clamp(max=nb - 1)])
        ce = torch.where(hit, torch.minimum(ahead, e), ce)
        done |= hit
    dst = torch.where(inside, s + (e - ce) + (pos - cs), pos)
    out = torch.empty_like(col.data).scatter_(0, dst, col.data)
    return StringColumn(col.offsets, out, col.validity, col.max_bytes)


def locate(col, needle: LiteralBytes, start: int = 1) -> torch.Tensor:
    """int32[cap]: the 1-based character position of the first ``needle``
    that begins at or after character ``start`` of each row, 0 where
    there is none or ``start < 1`` (Spark's ``locate``; ``instr`` is
    ``start`` 1); an empty needle is found at 1."""
    dev = col.offsets.device
    cap = col.capacity
    if start < 1:
        return torch.zeros(cap, dtype=torch.int32, device=dev)
    if not needle:
        return torch.ones(cap, dtype=torch.int32, device=dev)
    if len(needle) > col.max_bytes:
        return torch.zeros(cap, dtype=torch.int32, device=dev)
    starts, ends = _bounds(col)
    nchars, byte_of = _char_positions(col.offsets, col.data)
    lead = (col.data & 0xC0) != 0x80
    cs = torch.zeros(col.data.shape[0] + 1, dtype=torch.int64, device=dev)
    cs[1:] = torch.cumsum(lead.to(torch.int64), 0)
    lo = byte_of(torch.full_like(nchars, start - 1))
    pos, row, inside = _in_rows(col)
    m = len(needle)
    nb = col.data.shape[0]
    hit = inside & (pos + m <= ends[row]) & _match_at(col, pos, needle)
    # the first occurrence at or after lo: a search of the running count
    counts = _marked_counts(hit)
    before = counts[lo.clamp(max=nb)]
    some = counts[ends.clamp(max=nb)] > before
    at = torch.where(some, _nth_marked(counts, before), 0).clamp(max=nb)
    return torch.where(some, cs[at] - cs[starts] + 1, 0).to(torch.int32)


def pad(col, length: int, fill: str, left: bool):
    """``lpad`` / ``rpad``: each row cut to its first ``length``
    characters, or filled to ``length`` characters with ``fill`` repeated
    (on the left or the right); an empty ``fill`` leaves a shorter row as
    it is, and ``length <= 0`` gives the empty string."""
    dev = col.offsets.device
    length = max(int(length), 0)
    nchars, _ = _char_positions(col.offsets, col.data)
    src, nb = _substring_offsets(col.offsets, col.data, 1, length)
    chars = list(fill)
    reps = "".join(chars[k % len(chars)] for k in range(length)) \
        if chars else ""
    fb = [0]
    for ch in reps:
        fb.append(fb[-1] + len(ch.encode("utf-8")))
    fill_bytes = torch.tensor(fb, dtype=torch.int64, device=dev)
    padbuf = LiteralBytes(reps or " ").on(dev)
    f = (length - nchars).clamp(min=0) if chars else \
        torch.zeros_like(nchars)
    flen = fill_bytes[f.clamp(max=len(fb) - 1)]
    base = col.data.shape[0]
    pad_start = torch.full_like(src, base)
    if left:
        starts = torch.stack([pad_start, src], 1)
        lens = torch.stack([flen, nb], 1)
    else:
        starts = torch.stack([src, pad_start], 1)
        lens = torch.stack([nb, flen], 1)
    bound = min(col.max_bytes, 4 * length) + fb[-1]
    return _pieces([col.data, padbuf], starts, lens, col.validity, bound)


def repeat(col, times: int):
    """``repeat``: each row ``times`` times over (empty for ``times <=
    0``)."""
    times = max(int(times), 0)
    starts, ends = _bounds(col)
    lens = ends - starts

    def source(r, k):
        return col.data, starts[r] + k % lens[r].clamp(min=1)
    return _assemble(lens * times, col.validity, col.max_bytes * times,
                     source)


def _overlaps_itself(raw: bytes) -> bool:
    """Whether two occurrences of ``raw`` can overlap: a proper suffix of
    it is also a prefix."""
    return any(raw[k:] == raw[:len(raw) - k] for k in range(1, len(raw)))


def _leftmost_disjoint(hit, row, starts, ends, m: int, max_bytes: int):
    """The occurrences that a left-to-right scan takes (each the first
    that begins past the one before it): from each row's first
    occurrence, every occurrence reachable by ``next(b)``, the first
    occurrence at or after ``b + m`` in the row; reached by doubling."""
    nb = hit.shape[0]
    dev = hit.device
    pos = torch.arange(nb, device=dev)
    sink = torch.full((1,), nb, dtype=torch.int64, device=dev)
    at = torch.where(hit, pos, nb)
    # the first occurrence at or after each position (nb where none)
    after = torch.cat([torch.flip(torch.cummin(torch.flip(at, [0]), 0)
                                  .values, [0]), sink])
    nxt = after[(pos + m).clamp(max=nb)]
    jump = torch.cat([torch.where(hit & (nxt < ends[row]), nxt, nb), sink])
    h64 = hit.to(torch.int64)
    cum = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(h64, 0)
    first = hit & (cum[:nb] == cum[starts[row].clamp(max=nb)])
    mark = torch.cat([first, torch.zeros(1, dtype=torch.bool, device=dev)])
    jumps = [jump]
    while (1 << len(jumps)) <= max_bytes:
        jumps.append(jumps[-1][jumps[-1]])
    for j in reversed(jumps):
        reach = torch.zeros(nb + 1, dtype=torch.int32, device=dev) \
            .scatter_add_(0, j, mark.to(torch.int32))
        mark = mark | (reach > 0)
    return mark[:nb] & hit


def replace(col, search: LiteralBytes, rep: LiteralBytes):
    """``replace``: the occurrences of ``search`` that a left-to-right scan
    finds, each begun past the one before it, replaced by ``rep`` (an
    empty ``search`` leaves the row as it is)."""
    m, r = len(search), len(rep)
    if m == 0 or m > col.max_bytes:
        return col
    dev = col.offsets.device
    cap = col.capacity
    starts, ends = _bounds(col)
    pos, row, inside = _in_rows(col)
    inside = inside & col.validity[row]
    nb = col.data.shape[0]
    hit = inside & (pos + m <= ends[row]) & _match_at(col, pos, search)
    if _overlaps_itself(search.raw):
        hit = _leftmost_disjoint(hit, row, starts, ends, m,
                                 col.max_bytes)
    h64 = hit.to(torch.int64)
    cover = torch.zeros(nb + m + 1, dtype=torch.int64, device=dev)
    cover.index_add_(0, pos, h64)
    cover.index_add_(0, pos + m, -h64)
    covered = torch.cumsum(cover, 0)[:nb] > 0
    cum = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(h64, 0)
    count = cum[ends.clamp(max=nb)] - cum[starts.clamp(max=nb)]
    lens = torch.where(col.validity, ends - starts + count * (r - m), 0)
    bound = col.max_bytes if r <= m else col.max_bytes // m * r + \
        col.max_bytes % m
    out_off = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    out_off[1:] = torch.cumsum(lens, 0)
    total = int(out_off[-1])                 # the one host read
    before = cum[:nb] - cum[starts[row].clamp(max=nb)]
    dst = out_off[row] + (pos - starts[row]) + (r - m) * before
    out = torch.zeros(total + 1, dtype=torch.uint8, device=dev)
    keep = inside & ~covered
    out.scatter_(0, torch.where(keep, dst, total), col.data)
    lit = rep.on(dev)
    for k in range(r):
        out.scatter_(0, torch.where(hit, dst + k, total),
                     lit[k].expand(nb))
    from ..columnar.column import StringColumn
    return StringColumn(out_off.to(torch.int32), out[:max(total, 1)],
                        col.validity, bound)


def initcap(col):
    """``initcap``: ASCII letters lower case, but upper case at a row's
    start and after a space (Spark's ``toLowerCase().toTitleCase()``; a
    non-ASCII character keeps its bytes, as ``upper`` / ``lower``)."""
    d = col.data
    low = torch.where((d >= 65) & (d <= 90), d + 32, d).to(torch.uint8)
    starts, ends = _bounds(col)
    nb = d.shape[0]
    head = torch.zeros(nb + 1, dtype=torch.bool, device=d.device)
    head[torch.where(ends > starts, starts, nb).clamp(max=nb)] = True
    prev = torch.cat([torch.full((1,), 32, dtype=torch.uint8,
                                 device=d.device), d[:-1]])
    up = (head[:nb] | (prev == 32)) & (low >= 97) & (low <= 122)
    data = torch.where(up, low - 32, low).to(torch.uint8)
    return type(col)(col.offsets, data, col.validity, col.max_bytes)


def concat_ws(sep: LiteralBytes, parts, capacity: int, device):
    """``concat_ws(sep, parts...)``: the non-null parts (string columns or
    LiteralBytes) joined by ``sep``; never null."""
    bufs, starts, lens, bounds = [], [], [], []
    seen = torch.zeros(capacity, dtype=torch.bool, device=device)
    base = 0
    sep_buf = sep.on(device) if sep else None
    for i, p in enumerate(parts):
        if isinstance(p, LiteralBytes):
            present = torch.ones(capacity, dtype=torch.bool, device=device)
            own = torch.full((capacity,), len(p), dtype=torch.int64,
                             device=device)
            at = torch.full((capacity,), base, dtype=torch.int64,
                            device=device)
            buf, bound = p.on(device) if p else None, len(p)
        else:
            present = p.validity
            s, e = _bounds(p)
            own, at, buf, bound = e - s, s + base, p.data, p.max_bytes
        if buf is not None:
            bufs.append(buf)
            base += int(buf.shape[0])
        if i and sep:
            starts.append(torch.full((capacity,), -1, dtype=torch.int64,
                                     device=device))
            lens.append(torch.where(present & seen, len(sep), 0))
            bounds.append(len(sep))
        starts.append(at)
        lens.append(torch.where(present, own, 0))
        bounds.append(bound)
        seen = seen | present
    if sep_buf is not None:
        starts = [torch.where(s < 0, base, s) for s in starts]
        bufs.append(sep_buf)
    if not bufs:
        bufs.append(torch.zeros(1, dtype=torch.uint8, device=device))
    valid = torch.ones(capacity, dtype=torch.bool, device=device)
    return _pieces(bufs, torch.stack(starts, 1), torch.stack(lens, 1),
                   valid, sum(bounds))


def _words_less(a: List[torch.Tensor], b: List[torch.Tensor]):
    """bool[n]: word list ``a`` before ``b`` in unsigned lexicographic
    order."""
    less = torch.zeros_like(a[0], dtype=torch.bool)
    equal = torch.ones_like(less)
    for x, y in zip(a, b):
        xs, ys = x ^ SIGN64, y ^ SIGN64
        less = less | (equal & (xs < ys))
        equal = equal & (x == y)
    return less


def extreme(cols, largest: bool):
    """``greatest`` / ``least`` of string columns of one capacity in byte
    order, the NULLs skipped (NULL where every argument is)."""
    nw = max(needed_key_words(c) for c in cols)
    best = torch.zeros(cols[0].capacity, dtype=torch.int64,
                       device=cols[0].offsets.device)
    have = cols[0].validity
    words = string_key_words(cols[0], nw)
    for j, c in enumerate(cols[1:], 1):
        w = string_key_words(c, nw)
        beats = _words_less(words, w) if largest else _words_less(w, words)
        take = c.validity & (~have | beats)
        best = torch.where(take, j, best)
        words = [torch.where(take, y, x) for x, y in zip(words, w)]
        have = have | c.validity
    return choose_rows(cols, best, have)


def like(col, tokens) -> torch.Tensor:
    """bool[cap]: each row matches the LIKE pattern ``tokens``
    (``cuda_ops.like_tokens``), by the ``like_match`` kernel."""
    from . import cuda_ops
    return cuda_ops.like_match(col.offsets.contiguous(), col.data,
                               col.validity.contiguous(), tokens)
