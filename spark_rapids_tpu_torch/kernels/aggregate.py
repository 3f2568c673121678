"""Group-by kernels: the sort path and the bucket-table helpers.

Counterpart of ``spark_rapids_tpu/kernels/aggregate.py``.

Sort path: sort rows by their canonical key words, cut the sorted order
into segments, reduce per segment.  Float sums add pairwise in a fixed
tree within each segment (``seg_tree_sum``), so the CPU and the card add
in the same order and give the same bits (a scatter-add's order differs
between them); integer sums are prefix sums with boundary gathers.

Table path helpers: ``table_bucket`` packs small-range keys into
mixed-radix bucket ids below ``table`` (no sort), ``table_compact``
turns per-bucket counts into the group directory.  The reduce between
them is the ``table_stage`` kernel (kernels/cuda_ops.py); the f32 bit
helpers and the exact-sum chunk lanes below are its plain arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from . import canon
from . import decimal as dk
from .basic import SIGN64, compact_indices, umin64
from .sort import sort_permutation, sorted_words

_I64_MAX = (1 << 63) - 1


@dataclasses.dataclass
class GroupPlan:
    perm: torch.Tensor          # sort permutation over the input rows
    seg_id: torch.Tensor        # segment id per sorted row
    live_sorted: torch.Tensor   # sorted-row liveness
    rep_indices: torch.Tensor   # original row of each group's first row
    num_groups: torch.Tensor    # device scalar
    head_pos: torch.Tensor      # sorted position of each group's first row
    last_pos: torch.Tensor      # sorted position of each group's last row


def groupby_plan(words: List[torch.Tensor]) -> GroupPlan:
    """Sort+segment plan over ``canon.batch_key_words`` output (the first
    word is a rank word; rank 2 marks dead rows, which sort last)."""
    sorted_ws, perm = sorted_words(words)
    live = sorted_ws[0] != 2
    boundary = canon.words_equal_adjacent(sorted_ws) & live
    seg_id = (torch.cumsum(boundary.to(torch.int64), 0) - 1).clamp(min=0)
    num_groups = boundary.sum()
    n = boundary.shape[0]
    rep_order, _ = compact_indices(boundary, n)
    rep_indices = perm[rep_order]
    head_pos = rep_order
    live_count = live.sum()
    gi = torch.arange(n, device=perm.device)
    nxt = torch.cat([head_pos[1:], head_pos.new_zeros(1)])
    last_pos = torch.where(gi + 1 < num_groups, nxt - 1, live_count - 1)
    return GroupPlan(perm, seg_id, live, rep_indices, num_groups,
                     head_pos, last_pos)


def _sorted_vals(plan: GroupPlan, values, validity):
    v = values[plan.perm]
    ok = validity[plan.perm] & plan.live_sorted
    return v, ok


def seg_prefix_sum(plan: GroupPlan, contrib: torch.Tensor) -> torch.Tensor:
    """Per-group sum of a masked per-sorted-row integer array by prefix
    sum and boundary gathers; wraparound cancels in the subtraction."""
    cap = contrib.shape[0]
    cum = torch.cumsum(contrib, 0)
    ex = cum - contrib
    hp = plan.head_pos.clamp(0, cap - 1)
    lp = plan.last_pos.clamp(0, cap - 1)
    total = cum[lp] - ex[hp]
    gi = torch.arange(cap, device=contrib.device)
    return torch.where(gi < plan.num_groups, total, torch.zeros_like(total))


def seg_tree_sum(plan: GroupPlan, contrib: torch.Tensor) -> torch.Tensor:
    """Per-group float sum of a per-sorted-row array, added pairwise:
    at step s (1, 2, 4, ...) the row at offset ``k * 2s`` of its segment
    takes the partial sum of the row ``s`` past it, if that row is in the
    same segment.  The order of the additions depends on the segment
    lengths alone.  Dead rows carry zeros in the last segment."""
    cap = contrib.shape[0]
    idx = torch.arange(cap, device=contrib.device)
    seg = plan.seg_id
    pos = idx - plan.head_pos.clamp(0, cap - 1)[seg.clamp(0, cap - 1)]
    out = tree_sum_at_heads(seg, pos, contrib)[
        plan.head_pos.clamp(0, cap - 1)]
    return torch.where(idx < plan.num_groups, out, torch.zeros_like(out))


def tree_sum_at_heads(seg: torch.Tensor, pos: torch.Tensor,
                      contrib: torch.Tensor) -> torch.Tensor:
    """``seg_tree_sum``'s pairwise tree over rows sorted by segment
    (``seg`` ids, ``pos`` each row's place in its segment): each
    segment's sum lands on its first row.  The window operator reads it
    there for a whole-partition sum."""
    cap = contrib.shape[0]
    idx = torch.arange(cap, device=contrib.device)
    v = contrib
    s = 1
    while s < cap:
        partner = (idx + s).clamp(max=cap - 1)
        take = ((pos & (2 * s - 1)) == 0) & (idx + s < cap) & \
            (seg[partner] == seg)
        v = torch.where(take, v + v[partner], v)
        s *= 2
    return v


def seg_sum(plan: GroupPlan, values, validity, out_dtype=None):
    v, ok = _sorted_vals(plan, values, validity)
    acc = v.to(out_dtype or v.dtype)
    contrib = torch.where(ok, acc, torch.zeros_like(acc))
    if not contrib.is_floating_point():
        return seg_prefix_sum(plan, contrib.to(torch.int64)).to(acc.dtype)
    return seg_tree_sum(plan, contrib)


def seg_sum_exact(plan: GroupPlan, values, validity):
    """Per-group exact sum of int64 values: ``(sum, fits)``, the sum's
    int64 where it lies in the int64 range (``fits``), from the sums of
    the values' 32-bit halves (``kernels/decimal.split_halves``), which
    cannot wrap."""
    v, ok = _sorted_vals(plan, values, validity)
    v = torch.where(ok, v.to(torch.int64), 0)
    hi, lo = dk.split_halves(v)
    return dk.join_halves(seg_prefix_sum(plan, hi), seg_prefix_sum(plan, lo))


def seg_moments(plan: GroupPlan, values, validity):
    """Per-group (count, mean, M2) of the valid values, two passes over
    the segments: the mean, then the squared deviations from it, both
    added in the fixed tree of ``seg_tree_sum``."""
    x, ok = _sorted_vals(plan, values.to(torch.float64), validity)
    cnt = seg_prefix_sum(plan, ok.to(torch.int64))
    s = seg_tree_sum(plan, torch.where(ok, x, 0.0))
    mean = s / cnt.clamp(min=1).to(torch.float64)
    delta = x - mean[plan.seg_id]
    m2 = seg_tree_sum(plan, torch.where(ok, delta * delta, 0.0))
    return cnt, mean, m2


def seg_merge_moments(plan: GroupPlan, counts, means, m2s, validity):
    """Combine per-group (count, mean, M2) partials: the merged mean is
    the count-weighted mean, and M2 = sum(M2_i + n_i (mean_i - mean)^2)."""
    n_i, ok = _sorted_vals(plan, counts.to(torch.float64), validity)
    mean_i, _ = _sorted_vals(plan, means, validity)
    m2_i, _ = _sorted_vals(plan, m2s, validity)
    n_i = torch.where(ok, n_i, 0.0)
    n = seg_prefix_sum(plan, torch.where(ok, counts[plan.perm], 0).to(
        torch.int64))
    wsum = seg_tree_sum(plan, torch.where(ok, n_i * mean_i, 0.0))
    mean = wsum / n.clamp(min=1).to(torch.float64)
    delta = mean_i - mean[plan.seg_id]
    m2 = seg_tree_sum(plan, torch.where(ok, m2_i + n_i * delta * delta,
                                        0.0))
    return n, mean, m2


def seg_count(plan: GroupPlan, validity) -> torch.Tensor:
    _, ok = _sorted_vals(plan, validity, validity)
    return seg_prefix_sum(plan, ok.to(torch.int64))


def seg_count_all(plan: GroupPlan) -> torch.Tensor:
    return seg_prefix_sum(plan, plan.live_sorted.to(torch.int64))


def seg_max(plan: GroupPlan, values, validity):
    cap = values.shape[0]
    v, ok = _sorted_vals(plan, values, validity)
    if v.is_floating_point():
        # Spark order: NaN greatest (any NaN wins), -0.0 == 0.0
        v = torch.where(v == 0.0, torch.zeros_like(v), v)
        nan = torch.isnan(v)
        contrib = torch.where(ok & ~nan, v, float("-inf"))
        m = torch.full((cap,), float("-inf"), dtype=v.dtype, device=v.device)
        m.scatter_reduce_(0, plan.seg_id, contrib, "amax", include_self=True)
        has_nan = seg_prefix_sum(plan, (ok & nan).to(torch.int64)) > 0
        return torch.where(has_nan, float("nan"), m)
    ident = torch.iinfo(v.dtype).min if v.dtype != torch.bool else False
    contrib = torch.where(ok, v, torch.full_like(v, ident))
    m = torch.full((cap,), ident, dtype=v.dtype, device=v.device)
    return m.scatter_reduce_(0, plan.seg_id, contrib, "amax",
                             include_self=True)


def seg_min(plan: GroupPlan, values, validity):
    """Per-group min of the valid values.  Spark's order: a NaN is the
    largest double, so it is the min only of a group of NaNs; -0.0 ==
    0.0."""
    cap = values.shape[0]
    v, ok = _sorted_vals(plan, values, validity)
    if v.is_floating_point():
        v = torch.where(v == 0.0, torch.zeros_like(v), v)
        num = ok & ~torch.isnan(v)
        contrib = torch.where(num, v, float("inf"))
        m = torch.full((cap,), float("inf"), dtype=v.dtype, device=v.device)
        m.scatter_reduce_(0, plan.seg_id, contrib, "amin", include_self=True)
        has_num = seg_prefix_sum(plan, num.to(torch.int64)) > 0
        return torch.where(has_num, m, float("nan"))
    ident = torch.iinfo(v.dtype).max if v.dtype != torch.bool else True
    contrib = torch.where(ok, v, torch.full_like(v, ident))
    m = torch.full((cap,), ident, dtype=v.dtype, device=v.device)
    return m.scatter_reduce_(0, plan.seg_id, contrib, "amin",
                             include_self=True)


def seg_first_index(plan: GroupPlan, validity: torch.Tensor,
                    ignore_nulls: bool = True, last: bool = False):
    """Per group: the input row of its first (``last``: its last) row,
    valid rows only unless ``ignore_nulls`` is False, and whether the
    group has one.  The sort is stable, so a group's rows keep their
    input order: the first is the smallest sorted position."""
    cap = validity.shape[0]
    ok = plan.live_sorted
    if ignore_nulls:
        ok = ok & validity[plan.perm]
    pos = torch.arange(cap, device=validity.device)
    none = -1 if last else cap
    best = torch.full((cap,), none, dtype=torch.int64,
                      device=validity.device)
    best.scatter_reduce_(0, plan.seg_id, torch.where(ok, pos, none),
                         "amax" if last else "amin", include_self=True)
    has = best != none
    return plan.perm[best.clamp(0, cap - 1)], has


def seg_argmax_words(plan: GroupPlan, words: List[torch.Tensor],
                     validity: torch.Tensor,
                     largest: bool = True) -> torch.Tensor:
    """Per group: the input row whose word tuple is the largest (or, with
    ``largest`` False, the smallest) of its valid rows in unsigned
    lexicographic order (a string's key words give byte order), or -1
    where the group has none.  Each row's rank in one stable sort of the
    words is maxed (minned) per segment, and the best rank maps back to
    its row."""
    cap = validity.shape[0]
    order = sort_permutation(words)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(cap, device=order.device)
    r, ok = _sorted_vals(plan, rank, validity)
    none = -1 if largest else cap
    best = torch.full((cap,), none, dtype=torch.int64, device=order.device)
    best.scatter_reduce_(0, plan.seg_id, torch.where(ok, r, none),
                         "amax" if largest else "amin", include_self=True)
    gi = torch.arange(cap, device=order.device)
    found = (gi < plan.num_groups) & (best != none)
    return torch.where(found, order[best.clamp(0, cap - 1)], -1)


# ---------------------------------------------------------------------------
# Sort-free bucket table.  Each single-word key is rebased by its batch
# minimum and the keys are packed mixed-radix into a bucket id < table;
# a device-side fit flag says whether the batch really fit, and callers
# send a batch that did not to the sort path.
# ---------------------------------------------------------------------------

def table_bucket(key_words: List[torch.Tensor],
                 key_valids: List[torch.Tensor], live: torch.Tensor,
                 table: int):
    """Mixed-radix bucket ids over single-word keys.

    Each key contributes digit 0 for null and 1 + (word - min) otherwise,
    most significant first, so ascending buckets are the nulls-first key
    order of the sort path.  Dead rows get bucket ``table``.
    Returns (bucket int32[cap], fit, mins, cards); fit, mins and cards
    are device scalars."""
    cap = key_words[0].shape[0]
    dev = key_words[0].device
    bucket = torch.zeros(cap, dtype=torch.int64, device=dev)
    total = torch.ones((), dtype=torch.int64, device=dev)
    mins, cards = [], []
    for w, valid in zip(key_words, key_valids):
        lv = live & valid
        any_v = lv.any()
        flipped = w ^ SIGN64                     # unsigned order, signed
        wmin = torch.where(lv, flipped, _I64_MAX).min() ^ SIGN64
        wmax = torch.where(lv, flipped, -_I64_MAX - 1).max() ^ SIGN64
        wmin = torch.where(any_v, wmin, 0)
        wmax = torch.where(any_v, wmax, 0)
        card = umin64(wmax - wmin, table) + 2
        total = torch.clamp(total * card, max=1 << 32)
        digit = torch.where(valid, umin64(w - wmin, table) + 1, 0)
        bucket = torch.clamp(bucket * card + digit, max=table)
        mins.append(wmin)
        cards.append(card)
    fit = total <= table
    bucket = torch.where(live, bucket, table).to(torch.int32)
    return bucket, fit, mins, cards


def table_compact(counts: torch.Tensor, table: int):
    """Group directory from per-bucket live counts: (present, order,
    num_groups), order[g] = bucket of group g, ascending."""
    present = counts > 0
    num_groups = present.sum()
    order = torch.argsort((~present).to(torch.int8), stable=True)
    return present, order, num_groups


# ---------------------------------------------------------------------------
# Exact f64 sums on 32-bit chunk lanes and ordered f32 words.  A finite f64
# splits into two f32 components; each component splits into signed 8-bit
# chunks on a 120-bit window anchored at the batch's largest exponent, and
# the i32 lane sums recombine per bucket in f64.
# ---------------------------------------------------------------------------
CH_B = 8          # bits per chunk lane
CH_LANES = 15     # window = 120 bits
CH_W0 = 88        # max chunk position (top term bit 88+23 < 120)
_MASK32 = 0xFFFFFFFF


def f32_bits(f: torch.Tensor) -> torch.Tensor:
    """u32 bits of an f32 tensor, zero-extended into int64."""
    return f.view(torch.int32).to(torch.int64) & _MASK32


def flip32(f: torch.Tensor) -> torch.Tensor:
    """f32 -> u32 (in int64) whose order is the float order (canonical
    NaN above +inf, -0.0 below 0.0)."""
    u = f32_bits(f)
    neg = (u >> 31) != 0
    return torch.where(neg, (~u) & _MASK32, u | 0x80000000)


def unflip32(w: torch.Tensor) -> torch.Tensor:
    """Inverse of ``flip32``: u32 words (any integer dtype) -> f32."""
    w = w.to(torch.int64) & _MASK32
    neg = (w & 0x80000000) == 0
    u = torch.where(neg, (~w) & _MASK32, w & 0x7FFFFFFF)
    u = torch.where(u >= (1 << 31), u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def flip64(f: torch.Tensor) -> torch.Tensor:
    """f64 -> the int64 bits of a u64 whose unsigned order is the float
    order (canonical NaN above +inf, -0.0 below 0.0): ``flip32`` for the
    f64's own bits."""
    u = f.contiguous().view(torch.int64)
    return torch.where(u < 0, ~u, u | SIGN64)


def unflip64(w: torch.Tensor) -> torch.Tensor:
    """Inverse of ``flip64``: int64 words -> f64."""
    return torch.where(w < 0, w ^ SIGN64, ~w).view(torch.float64)


def _pow2_f64(k: torch.Tensor) -> torch.Tensor:
    """2^k as f64 from an integer tensor, k in the normal range."""
    return ((k + 1023) << 52).view(torch.float64)


def f32_exp(f: torch.Tensor):
    """(biased exponent clamped >= 1, 24-bit significand, negative)."""
    u = f32_bits(f)
    neg = (u >> 31) != 0
    e = (u >> 23) & 0xFF
    m = u & 0x7FFFFF
    sig = torch.where(e > 0, m | (1 << 23), m)
    return e.clamp(min=1), sig, neg


def part_chunk_lanes(f: torch.Tensor, ok: torch.Tensor, emax: torch.Tensor,
                     lanes: torch.Tensor) -> None:
    """Add one f32 component's signed 8-bit chunks into ``lanes``
    (int32[n, CH_LANES]) on the window anchored at ``emax``: value =
    sig * 2^(e-150), window bit 0 weighs 2^(emax-150-CH_W0).  Exact for
    terms inside the window; the fit flag excludes wider spreads."""
    ee, sig, neg = f32_exp(f)
    p = CH_W0 - (emax - ee)
    keep = ok & (p >= 0) & (sig != 0)
    pc = p.clamp(min=0)
    off = pc & 7
    q = pc >> 3
    l32 = sig << off                         # <= 2^31
    sgn = torch.where(neg, -1, 1)
    for k in range(4):
        ck = torch.where(keep, ((l32 >> (CH_B * k)) & 0xFF) * sgn, 0)
        lanes.scatter_add_(1, (q + k).clamp(max=CH_LANES - 1)[:, None],
                           ck.to(torch.int32)[:, None])


def chunk_recombine(lanes: torch.Tensor, emax: torch.Tensor) -> torch.Tensor:
    """[CH_LANES, G] lane sums + batch emax -> per-group f64 totals; the
    scale splits into two in-range powers of two, as in the reference."""
    lanes = lanes.to(torch.float64)
    out = torch.zeros(lanes.shape[1], dtype=torch.float64,
                      device=lanes.device)
    for L in range(CH_LANES):
        k = CH_B * L + emax - (CH_W0 + 150)
        k1 = torch.div(k, 2, rounding_mode="floor")
        out = out + (lanes[L] * _pow2_f64(k1)) * _pow2_f64(k - k1)
    return out
