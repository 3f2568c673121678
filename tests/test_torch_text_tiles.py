"""What the host computes for the tiled text kernels, on the CPU.

``like_match``'s kernel (csrc/strings.cu) reads a LIKE pattern as pieces
between its ``%``s (``cuda_ops.like_pieces``, passed in ``_LikePattern``):
the first anchored at the row's start, each later one at its leftmost
place, the last at the row's end.  ``_pieces_match`` below mirrors the
kernel's steps on one row, byte by byte; it is held to the plain version
(the greedy wildcard match, ``like_match_plain``) on random patterns over
valid and invalid UTF-8, and to the reference package's regex
(``spark_rapids_tpu/expr/string_ops._like_to_regex``) and Python's ``re``
on text.  Rows without a lead byte read bitmaps of the staged window
instead: ``_sift`` mirrors how the kernel builds them (a two-byte SWAR
sift, a four-byte compare, the whole piece) and ``_tile_match`` how a
row reads them; both are held to a direct search and to the plain
version.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from spark_rapids_tpu.expr.string_ops import _like_to_regex
from spark_rapids_tpu_torch.kernels import cuda_ops

ONE, ANY = cuda_ops.LIKE_ONE, cuda_ops.LIKE_ANY


def _char_bytes(b: int) -> int:
    return 1 if b < 0xC0 else 2 if b < 0xE0 else 3 if b < 0xF0 else 4


def _try(row: bytes, i: int, tok) -> int:
    """lm_try: where the piece ends, -1 on a mismatch, -2 when the row
    runs out first."""
    e = len(row)
    for t in tok:
        if i >= e:
            return -2
        if t == ONE:
            i = min(i + _char_bytes(row[i]), e)
        elif row[i] == t:
            i += 1
        else:
            return -1
    return i


def _pieces_match(row: bytes, tokens) -> bool:
    """lm_row: the kernel's match of one row, piece by piece."""
    e = len(row)
    pieces = cuda_ops.like_pieces(tokens)
    start, count, _ = pieces[0]
    pos = _try(row, 0, tokens[start:start + count])
    if pos < 0:
        return False
    if len(pieces) == 1:
        return pos == e
    for j, (start, count, fixed) in enumerate(pieces[1:], 1):
        if count == 0:
            return True
        tok = tokens[start:start + count]
        last = j == len(pieces) - 1
        if last and fixed:
            # lm_walk: the places from pos on, up to the row's end less
            # the piece's bytes
            t, x = e - count, pos
            if t < pos:
                return False
            while x < t:
                x += _char_bytes(row[x])
            return x == t and _try(row, t, tok) == e
        x = pos
        while True:
            if tok[0] != ONE:
                # lm_find: the next place whose byte is the first token
                while x < e and row[x] != tok[0]:
                    x += _char_bytes(row[x])
                x = min(x, e)
            if x >= e:
                return False
            end = _try(row, x, tok)
            if end == -2:
                return False
            if end >= 0 and (not last or end == e):
                pos = end
                break
            x = min(x + _char_bytes(row[x]), e)
        if last:
            return True
    return True


def _column(rows):
    offsets = torch.tensor([0] + list(np.cumsum([len(r) for r in rows])),
                           dtype=torch.int32)
    data = torch.tensor(list(b"".join(rows)) or [0], dtype=torch.uint8)
    return offsets, data, torch.ones(len(rows), dtype=torch.bool)


@pytest.mark.parametrize("pattern,pieces", [
    ("", [(0, 0, True)]),
    ("abc", [(0, 3, True)]),
    ("%", [(0, 0, True), (1, 0, True)]),
    ("%%a", [(0, 0, True), (1, 1, True)]),
    ("a%b_c%", [(0, 1, True), (2, 3, False), (6, 0, True)]),
    ("_%%_", [(0, 1, False), (2, 1, False)]),
    ("é%\\%", [(0, 2, True), (3, 1, True)]),
])
def test_like_pieces(pattern, pieces):
    """The pieces cut at each run of ``%`` (start token, count, no
    ``_``), an empty first or last one where the pattern starts or ends
    with ``%``."""
    assert cuda_ops.like_pieces(cuda_ops.like_tokens(pattern)) == pieces


@pytest.mark.parametrize("pattern", ["%" + "a%" * 255 + "b", "_" * 512,
                                     "%ab_" * 128])
def test_like_pattern_at_the_token_limit(pattern):
    """512 tokens fill the kernel's pattern: every piece fits its
    tables, and the struct is laid out as csrc/strings.cu's."""
    tokens = cuda_ops.like_tokens(pattern)
    assert len(tokens) == cuda_ops.LIKE_MAX_TOKENS
    pat = cuda_ops._like_pattern(tokens)
    pieces = cuda_ops.like_pieces(tokens)
    assert pat.pieces == len(pieces) <= cuda_ops.LIKE_MAX_PIECES
    assert list(pat.tok) == tokens
    assert [(pat.start[j], pat.count[j], bool(pat.fixed[j]))
            for j in range(pat.pieces)] == pieces
    lp = cuda_ops._LikePattern
    assert (lp.tok.offset, lp.start.offset, lp.count.offset,
            lp.fixed.offset, ctypes.sizeof(lp)) == (8, 1032, 1546, 2060,
                                                    2320)


TEXT = ["a", "b", "é", "€", "%", "_", "x", "😀"]
PATTERN = ["a", "b", "é", "€", "%", "_", "\\%", "\\_", "x", "😀"]


@pytest.mark.parametrize("seed", range(6))
def test_pieces_match_plain_and_regex_on_text(seed):
    """On valid UTF-8 the piece-by-piece match answers as the plain
    version, as the reference package's regex and as ``re``."""
    rng = np.random.default_rng(seed)
    strings = ["".join(rng.choice(TEXT, rng.integers(0, 12)))
               for _ in range(150)]
    rows = [s.encode() for s in strings]
    cols = _column(rows)
    for _ in range(40):
        pat = "".join(rng.choice(PATTERN, rng.integers(0, 8)))
        tokens = cuda_ops.like_tokens(pat)
        plain = cuda_ops.like_match_plain(*cols, tokens).tolist()
        mirror = [_pieces_match(r, tokens) for r in rows]
        rx = re.compile(_like_to_regex(pat, "\\"), re.DOTALL)
        ref = [rx.fullmatch(s) is not None for s in strings]
        assert mirror == plain == ref, pat


#: bytes that make UTF-8 go wrong: lead bytes of 2, 3 and 4, stray
#: continuation bytes, 0xFF
RAW = [0x61, 0x62, 0xC3, 0xA9, 0xE2, 0x82, 0xF0, 0x80, 0xBF, 0xFF]


@pytest.mark.parametrize("seed", range(6))
def test_pieces_match_plain_on_any_bytes(seed):
    """On bytes that are not UTF-8 (a lead byte without its continuation,
    stray continuation bytes) the pieces try the plain version's places
    and give its answers, ``_`` a lead byte's count cut at the row's
    end."""
    rng = np.random.default_rng(100 + seed)
    rows = [bytes(rng.choice(RAW, rng.integers(0, 14)).tolist())
            for _ in range(150)]
    cols = _column(rows)
    for _ in range(40):
        tokens = []
        for _ in range(rng.integers(0, 8)):
            kind = rng.integers(0, 4)
            tok = ANY if kind == 0 else ONE if kind == 1 else \
                int(rng.choice(RAW))
            if not (tok == ANY and tokens and tokens[-1] == ANY):
                tokens.append(tok)
        plain = cuda_ops.like_match_plain(*cols, tokens).tolist()
        assert [_pieces_match(r, tokens) for r in rows] == plain, tokens


@pytest.mark.parametrize("row,pattern,want", [
    (b"aaabbb", "a%aab%b", True),       # 'aab' passed over at 0
    (b"aaab", "a%aab%b", False),        # no 'b' after the leftmost 'aab'
    (b"aabab", "a%aab%b", False),
    (b"aaabab", "a%aab%b", True),
    (b"special requests", "%special%requests%", True),
    (b"requests special", "%special%requests%", False),
    (b"xab", "%ab", True),              # the last piece at the row's end
    (b"abx", "%ab", False),
    (b"abab", "ab%ab", True),
    (b"aba", "ab%ab", False),           # anchored pieces may not overlap
    ("é€".encode(), "_€", True),        # '_' over a 2-byte character
    ("é€".encode(), "%__", True),
    ("é€".encode(), "%___", False),
])
def test_pieces_match_cases(row, pattern, want):
    tokens = cuda_ops.like_tokens(pattern)
    assert _pieces_match(row, tokens) is want
    assert cuda_ops.like_match_plain(*_column([row]), tokens).tolist() == \
        [want]


M32 = (1 << 32) - 1


def _zero(t: int) -> int:
    """lm_zero: bit 7 of every byte of t that is 0 (and perhaps of a byte
    0x01 above one)."""
    return ((t - 0x01010101) & M32) & ~t & 0x80808080


def _gather4(z: int) -> int:
    """lm_gather4: bit 7 of each byte into bits 0-3."""
    return ((((z >> 7) * 0x204081) & M32) >> 21) & 0xF


def _key(tok):
    """lm_key: the piece's first literal bytes (up to 4), low first."""
    key, n = 0, 0
    while n < 4 and n < len(tok) and tok[n] != ONE:
        key |= tok[n] << (8 * n)
        n += 1
    return key, (M32 if n == 4 else (1 << (8 * n)) - 1), n


def _at(buf: bytes, x: int, tok) -> bool:
    """lm_at: the piece at byte x of the window, each ``_`` one byte."""
    return x + len(tok) <= len(buf) and all(
        t == ONE or buf[x + k] == t for k, t in enumerate(tok))


def _sift(buf: bytes, tok) -> list:
    """lm_group / lm_sift over a window (its length a multiple of 16): the
    bitmap words of the places where the piece matches."""
    n = len(buf)
    key, mask, kn = _key(tok)
    word = lambda at: int.from_bytes(buf[at:at + 4], "little") \
        if at + 4 <= n else 0
    out = []
    for at in range(0, n, 32):
        w = [word(at + 4 * q) if at + 16 * (q >= 4) < n else 0
             for q in range(8)] + [word(at + 32) if at + 32 < n else 0]
        cand = M32 if n - at >= 32 else (1 << (n - at)) - 1
        if kn >= 2:
            c0 = (key & 0xFF) * 0x01010101
            c1 = ((key >> 8) & 0xFF) * 0x01010101
            bits, z1 = 0, _zero(w[0] ^ c1)
            for q in range(8):
                z1n = _zero(w[q + 1] ^ c1)
                both = _zero(w[q] ^ c0) & (((z1n << 32 | z1) >> 8) & M32)
                bits |= _gather4(both) << (4 * q)
                z1 = z1n
            cand &= bits
        elif kn == 1:
            bits = 0
            for q in range(8):
                bits |= _gather4(_zero(w[q] ^ key * 0x01010101)) << (4 * q)
            cand &= bits
        found = 0
        for i in range(32):
            if not cand >> i & 1:
                continue
            x = at + i
            if kn > 2 and x + 8 <= n:
                u = int.from_bytes(buf[x:x + 4], "little")
                if u & mask != key:
                    continue
            if _at(buf, x, tok):
                found |= 1 << i
        out.append(found)
    return out


def _first(bm, lo: int, hi: int) -> int:
    """lm_first: the first set bit in [lo, hi], or -1 (it reads the words
    of the range alone)."""
    if lo > hi:
        return -1
    for wi in range(lo >> 5, (hi >> 5) + 1):
        for x in range(max(lo, 32 * wi), min(hi, 32 * wi + 31) + 1):
            if bm[wi] >> (x & 31) & 1:
                return x
    return -1


def _tile_match(rows, tokens, pad: bytes, tail: bytes):
    """The kernel's answers for the rows of one staged window (``pad``
    before the rows, as the span's start aligned down, ``tail`` after
    them): a row with a lead byte takes the piece search; the others read
    the bitmap of the pattern's second piece, then that of its third,
    whose words are built only where such rows look for it (lm_span; the
    others are None here, so a row that reads one fails), then search the
    pieces from the fourth on."""
    buf = pad + b"".join(rows) + tail
    assert len(buf) % 16 == 0
    pieces = cuda_ops.like_pieces(tokens)
    c1 = pieces[1][1] if len(pieces) > 1 else 0
    c2 = pieces[2][1] if len(pieces) > 2 else 0
    tok = lambda j: tokens[pieces[j][0]:pieces[j][0] + pieces[j][1]]
    f1 = _sift(buf, tok(1)) if c1 else None
    bit = lambda bm, x: bool(bm[x >> 5] >> (x & 31) & 1)
    heads, rel = [], len(pad)
    for row in rows:
        e = len(row)
        if any(b >= 0xC0 for b in row):
            heads.append((rel, e, _pieces_match(row, tokens), 0))
            rel += e
            continue
        # lm_head: the first piece at the start, the second by f1
        start, count, _ = pieces[0]
        p, state, pos = count, None, 0
        if not _at(buf[rel:rel + e], 0, tokens[start:start + count]):
            state = False
        elif len(pieces) == 1:
            state = p == e
        elif c1 == 0:
            state = True
        elif len(pieces) == 2:
            state = e - c1 >= p and bit(f1, rel + e - c1)
        else:
            x = _first(f1, rel + p, rel + e - c1)
            if x < 0:
                state = False
            else:
                pos = x - rel + c1
        heads.append((rel, e, state, pos))
        rel += e
    # the third piece's words that the rows left over read (lm_span)
    f2 = [None] * len(f1 or [])
    if c2:
        full = _sift(buf, tok(2))
        for rel, e, state, pos in heads:
            if state is None and pos <= e - c2:
                for g in range((rel + pos) >> 5, ((rel + e - c2) >> 5) + 1):
                    f2[g] = full[g]
    out = []
    for (rel, e, state, pos), row in zip(heads, rows):
        if state is None:
            # lm_tail
            if c2 == 0:
                state = True
            elif len(pieces) == 3:
                state = e - c2 >= pos and bit(f2, rel + e - c2)
            else:
                x = _first(f2, rel + pos, rel + e - c2)
                state = x >= 0 and _pieces_match(
                    row[x - rel + c2:], [ANY] + tokens[pieces[3][0]:])
        out.append(state)
    return out


#: bytes for the sift: NUL and 0x01 (the zero test's borrow), letters of
#: the pieces, a lead byte and its continuation
SIFT = [0x00, 0x01, 0x61, 0x62, 0x60, 0x63, 0x73, 0x70, 0xC3, 0xA9]


@pytest.mark.parametrize("seed", range(4))
def test_sift_finds_every_place(seed):
    """The bitmaps the window's sift builds (two bytes four places at a
    time, then four bytes in one word, then the whole piece) hold every
    place where the piece matches, each ``_`` one byte, and no other, for
    pieces of 1-9 tokens with ``_`` and NUL bytes among them."""
    rng = np.random.default_rng(300 + seed)
    for _ in range(60):
        buf = bytes(rng.choice(SIFT, 16 * int(rng.integers(1, 9))).tolist())
        tok = [ONE if rng.random() < 0.15 else int(rng.choice(SIFT[:8]))
               for _ in range(int(rng.integers(1, 10)))]
        words = _sift(buf, tok)
        got = [32 * g + i for g, wd in enumerate(words) for i in range(32)
               if wd >> i & 1]
        assert got == [x for x in range(len(buf)) if _at(buf, x, tok)], \
            (buf, tok)


ROW_TEXT = ["special", "requests", "sp", "re", "s", " ", "ab", "aab", "é",
            "x"]
ROW_PATTERN = ["special", "requests", "%", "%", "%", "_", "a", "b", "aab",
               "sp", "s", "é"]


@pytest.mark.parametrize("seed", range(4))
def test_tile_match_plain(seed):
    """The kernel's tile path, rows read through the window's bitmaps (the
    third piece's built only where rows look for it; a row with a lead
    byte through the piece search), answers as the plain version on
    random rows and patterns of up to seven pieces."""
    rng = np.random.default_rng(400 + seed)
    for _ in range(30):
        strings = ["".join(rng.choice(ROW_TEXT, rng.integers(0, 8)))
                   for _ in range(40)]
        rows = [s.encode() for s in strings]
        pad = bytes(rng.choice(SIFT, int(rng.integers(0, 16))).tolist())
        size = len(pad) + sum(map(len, rows))
        tail = bytes(rng.choice(SIFT, (-size) % 16 + 16 *
                                int(rng.integers(0, 2))).tolist())
        cols = _column(rows)
        for _ in range(8):
            pat = "".join(rng.choice(ROW_PATTERN, rng.integers(0, 8)))
            tokens = cuda_ops.like_tokens(pat)
            plain = cuda_ops.like_match_plain(*cols, tokens).tolist()
            assert _tile_match(rows, tokens, pad, tail) == plain, pat


def test_like_tile_constants_match_source():
    """``LIKE_TILE_ROWS`` and ``LIKE_TILE_BYTES``, which the card's tests
    use to build rows at a tile's edges, are the kernel's LM_THREADS and
    LM_BUDGET."""
    src = (cuda_ops.CSRC / "strings.cu").read_text()
    threads = int(re.search(r"#define LM_THREADS (\d+)", src).group(1))
    row = int(re.search(r"#define LM_ROW_BYTES (\d+)", src).group(1))
    assert "#define LM_BUDGET (LM_THREADS * LM_ROW_BYTES)" in src
    assert (cuda_ops.LIKE_TILE_ROWS, cuda_ops.LIKE_TILE_BYTES) == (
        threads, threads * row)
