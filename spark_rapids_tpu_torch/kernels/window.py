"""Window kernels: segments, segmented scans and frame reductions over
rows sorted by (partition words, order words).

Counterpart of the array work inside ``spark_rapids_tpu/exec/
tpu_window.py``, which has no kernel of its own: the reference builds
windows from ``jnp`` sorts, cumsums, ``jax.ops.segment_*`` and
``lax.associative_scan``, and so does this module from torch ops.  Every
function works on the sorted rows of one concatenated partition; a
segment is one window partition, and dead rows (past the live count)
sort after every live row.

Float sums never go through a scatter-add, whose order of additions
differs from run to run on the card: a whole partition adds in the
group-by's fixed pairwise tree (``aggregate.tree_sum_at_heads``), a
frame open on one side is a segmented scan by log-step doubling that
restarts at each segment (so a row's sum depends on its own segment's
rows alone, not on where the segment sits in the batch), and a frame
bounded on both sides adds power-of-two block sums.  Integer sums and
counts are exact int64 prefix sums.  ``min`` / ``max`` run on int64
order words (a float's order word puts NaN above every number, as Spark
orders it), through the same scans or a sparse table.
"""
from __future__ import annotations

import dataclasses

import torch

from .aggregate import flip64, tree_sum_at_heads, unflip64
from .basic import SIGN64

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


@dataclasses.dataclass
class Segments:
    """Per sorted row: its segment id, the positions of its segment's
    first and last live rows, whether the row is live, its position and
    its place in its segment."""
    seg: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    live: torch.Tensor
    pos: torch.Tensor
    row_in_seg: torch.Tensor


def runs(boundary: torch.Tensor, live: torch.Tensor):
    """(id, first position, last position) per row of the runs that
    ``boundary`` starts (a live row that differs from the row before);
    live rows come first.  The runs' first positions go to a table by
    one scatter, each boundary row to its run's slot and every other row
    to a slot of its own (no two writes meet), and each row reads its
    run's and the next run's: a scan with indices (``torch.cummax``)
    took about 2 ms per million rows on an H100."""
    cap = boundary.shape[0]
    pos = torch.arange(cap, device=boundary.device)
    ids = (torch.cumsum(boundary.to(torch.int64), 0) - 1).clamp(min=0)
    heads = torch.zeros(2 * cap + 1, dtype=torch.int64,
                        device=boundary.device)
    heads.scatter_(0, torch.where(boundary, ids, cap + 1 + pos), pos)
    last = torch.where(ids + 1 < boundary.sum(), heads[ids + 1] - 1,
                       live.sum() - 1)
    return ids, heads[ids], last


def segments(boundary: torch.Tensor, live: torch.Tensor) -> Segments:
    """Segments of sorted rows from their boundaries (a live row whose
    partition words differ from the row before)."""
    seg, start, end = runs(boundary, live)
    pos = torch.arange(boundary.shape[0], device=boundary.device)
    return Segments(seg, start, end, live, pos, pos - start)


def seg_scan(x: torch.Tensor, before: torch.Tensor, op, ident,
             reverse: bool = False) -> torch.Tensor:
    """Inclusive segmented scan: out[i] = op over x from its segment's
    first row to i (``reverse``: from i to its segment's last row), by
    log-step doubling; ``before[i]`` counts the rows of i's segment
    before it (``reverse``: after it).  Step s combines the partial of
    rows [i - s + 1, i] with that of [i - 2s + 1, i - s], so the order of
    operations is fixed by the row's place in its segment."""
    cap = x.shape[0]
    s = 1
    while s < cap:
        pad = x.new_full((s,), ident)
        prev = torch.cat([x[s:], pad]) if reverse else \
            torch.cat([pad, x[:-s]])
        x = torch.where(before >= s, op(x, prev), x)
        s *= 2
    return x


def prefix_diff(prefix: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
                ) -> torch.Tensor:
    """Sum of rows [lo, hi] from an inclusive int64 prefix sum (0 for an
    empty frame; wraparound cancels in the subtraction)."""
    cap = prefix.shape[0]
    top = prefix[hi.clamp(0, cap - 1)]
    below = torch.where(lo > 0, prefix[(lo - 1).clamp(0, cap - 1)], 0)
    return torch.where(hi >= lo, top - below, 0)


def whole_sum(x: torch.Tensor, segs: Segments) -> torch.Tensor:
    """Each row's whole-segment float sum, added in the pairwise tree of
    the group-by's sort path."""
    heads = tree_sum_at_heads(segs.seg, segs.row_in_seg, x)
    return heads[segs.start]


def block_sum(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              widest: int) -> torch.Tensor:
    """Float sum of rows [lo, hi] (every frame at most ``widest`` rows):
    power-of-two block sums ``t[k][i]`` = rows [i, i + 2^k), the frame's
    length in binary picking blocks from ``lo`` on, largest first."""
    cap = x.shape[0]
    tables = [x]
    while (1 << len(tables)) <= widest:
        prev, step = tables[-1], 1 << (len(tables) - 1)
        tables.append(prev + torch.cat([prev[step:], prev.new_zeros(step)]))
    length = (hi - lo + 1).clamp(min=0)
    acc = torch.zeros_like(x)
    cur = lo.clamp(0, cap - 1)
    for k in range(len(tables) - 1, -1, -1):
        take = ((length >> k) & 1) != 0
        acc = torch.where(take, acc + tables[k][cur], acc)
        cur = torch.where(take, (cur + (1 << k)).clamp(max=cap - 1), cur)
    return acc


def sparse_minmax(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  widest: int, op, ident) -> torch.Tensor:
    """min or max of rows [lo, hi] from a sparse table: levels of
    power-of-two blocks up to the widest frame, the two blocks of the
    frame's length that overlap to cover it."""
    cap = x.shape[0]
    tables = [x]
    while (1 << len(tables)) <= widest:
        prev, step = tables[-1], 1 << (len(tables) - 1)
        tables.append(op(prev, torch.cat([prev[step:],
                                          prev.new_full((step,), ident)])))
    length = (hi - lo + 1).clamp(min=1)
    k = torch.zeros_like(length)
    for j in range(1, len(tables)):
        k = torch.where(length >= (1 << j), j, k)
    flat = torch.stack(tables).reshape(-1)
    a = lo.clamp(0, cap - 1)
    b = (hi - (1 << k) + 1).clamp(0, cap - 1)
    return op(flat[k * cap + a], flat[k * cap + b])


def order_ints(data: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the values' order; a float's puts NaN
    above every number and -0.0 with 0.0, as Spark's min and max do."""
    if not data.is_floating_point():
        return data.to(torch.int64)
    f = data.to(torch.float64)
    f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
    f = torch.where(f == 0.0, torch.zeros_like(f), f)
    return flip64(f) ^ SIGN64


def from_order_ints(w: torch.Tensor, torch_dtype) -> torch.Tensor:
    if torch_dtype.is_floating_point:
        return unflip64(w ^ SIGN64).to(torch_dtype)
    return w.to(torch_dtype)


def range_positions(u: torch.Tensor, valid: torch.Tensor, segs: Segments,
                    lo, hi, nulls_first: bool):
    """(first, last) sorted position of each row's RANGE frame over an
    integer order key, in ascending form (``u``: the key, negated for a
    descending order, so a frame is the rows of the segment whose ``u``
    lies in [u + lo, u + hi]).  As the reference does it: every key's
    rank among all valid keys of the batch, then a search of (segment,
    rank) composites; a row whose key is NULL has its NULL peers as
    frame, and an unbounded side reaches the segment's edge (taking the
    NULL block in with it)."""
    live = segs.live
    big = 1 << 33                       # ranks < 2^33; segments < 2^29
    keys = torch.sort(torch.where(valid, u, I64_MAX)).values
    rank = torch.searchsorted(keys, u, side="left")
    null_slot = 0 if nulls_first else big - 1
    base = segs.seg * big
    comp = torch.where(valid, base + 1 + rank, base + null_slot)
    comp = torch.where(live, comp, 1 << 62)
    r_lo = torch.searchsorted(keys, u + (0 if lo is None else lo),
                              side="left")
    r_hi = torch.searchsorted(keys, u + (0 if hi is None else hi),
                              side="right")
    t_lo = torch.where(valid, base + 1 + r_lo, base + null_slot)
    t_hi = torch.where(valid, base + 1 + r_hi, base + null_slot + 1)
    first = torch.searchsorted(comp, t_lo, side="left")
    last = torch.searchsorted(comp, t_hi, side="left") - 1
    if lo is None:
        first = segs.start
    if hi is None:
        last = segs.end
    return torch.maximum(first, segs.start), torch.minimum(last, segs.end)
