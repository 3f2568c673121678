"""Logical rewrites: equi-joins out of comma-joins, filter pushdown, and
scan column pruning.

Counterpart of ``spark_rapids_tpu/plan/logical_opt.py`` (the rules the
port needs).  ``optimize`` works bottom-up: a Filter over a keyless
cross/inner join tree first has its conjuncts common to every arm of an
OR factored out of it (``_factor_or``, so join equalities written inside
each arm become conjuncts), then its relations reordered so each one
joins one already joined through an equality (``_reorder_cross_joins``),
then its conjuncts split over the join (``_rewrite_filter_join``):
those of one side sink into that side, equalities across the sides
become join keys, the rest stay above.  A Filter over a Project (a
derived table's or a CTE's select list, or a self-join's renaming) has
the conjuncts over its pass-through columns rewritten to the names below
and sunk under it (``_rewrite_filter_project``), so they go on sinking
into the joins inside; a Filter over a semi or anti join has its
conjuncts over the left side sunk into it (``_rewrite_filter_semi``); a
Filter stays above an Aggregate, a Sort and a Limit.  ``prune_scan_columns`` narrows every scan, and every projection,
to the columns the plan above reads.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Set

from ..expr import core as ec
from ..expr import predicates as ep
from . import logical as L


def _flatten_and(e: ec.Expression) -> List[ec.Expression]:
    if isinstance(e, ep.And):
        return _flatten_and(e.children[0]) + _flatten_and(e.children[1])
    return [e]


def _and_all(conjuncts: List[ec.Expression]) -> ec.Expression:
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = ep.And(out, c)
    return out


def _flatten_or(e: ec.Expression) -> List[ec.Expression]:
    if isinstance(e, ep.Or):
        return _flatten_or(e.children[0]) + _flatten_or(e.children[1])
    return [e]


def _or_all(disjuncts: List[ec.Expression]) -> ec.Expression:
    out = disjuncts[0]
    for d in disjuncts[1:]:
        out = ep.Or(out, d)
    return out


def _factor_or(e: ec.Expression) -> List[ec.Expression]:
    """Conjuncts common to every OR arm, factored out of it:
    ``(A and B) or (A and C) -> [A, B or C]``.  Sound in SQL's
    three-valued logic (AND distributes over OR); TPC-DS q13, q48 and
    q85 write their join equalities inside each arm, which would
    otherwise stay above a cross join."""
    disjuncts = _flatten_or(e)
    if len(disjuncts) < 2:
        return [e]
    conj_lists = [_flatten_and(d) for d in disjuncts]
    first = {repr(c): c for c in conj_lists[0]}
    common = [k for k in first
              if all(any(repr(x) == k for x in cl) for cl in conj_lists[1:])]
    if not common:
        return [e]
    rests = []
    for cl in conj_lists:
        removed, rest = set(), []
        for x in cl:
            rx = repr(x)
            if rx in common and rx not in removed:
                removed.add(rx)
                continue
            rest.append(x)
        if not rest:            # (A) or (A and P) == A
            return [first[k] for k in common]
        rests.append(_and_all(rest))
    return [first[k] for k in common] + [_or_all(rests)]


def _conjuncts(cond: ec.Expression) -> List[ec.Expression]:
    """The conjuncts of a filter, each OR's common conjuncts factored."""
    return [x for c in _flatten_and(cond) for x in _factor_or(c)]


def _refs(e: ec.Expression) -> Optional[Set[str]]:
    """Names of the AttributeReferences in ``e``; None if ``e`` holds a
    BoundReference (an ordinal, which does not survive a move)."""
    if isinstance(e, ec.BoundReference):
        return None
    if isinstance(e, ec.AttributeReference):
        return {e.col_name}
    out: Set[str] = set()
    for c in e.children:
        r = _refs(c)
        if r is None:
            return None
        out |= r
    return out


def _filter_over(conjuncts: List[ec.Expression],
                 plan: L.LogicalPlan) -> L.LogicalPlan:
    return L.Filter(_and_all(conjuncts), plan) if conjuncts else plan


def _rewrite_filter_join(f: L.Filter) -> L.LogicalPlan:
    j = f.children[0]
    if not isinstance(j, L.Join) or j.how not in ("inner", "cross"):
        return f
    left, right = j.children
    lnames, rnames = set(left.schema.names), set(right.schema.names)
    if lnames & rnames:
        return f                  # ambiguous column names: leave alone
    lpush, rpush, rest = [], [], []
    lkeys, rkeys = list(j.left_keys), list(j.right_keys)
    for c in _conjuncts(f.condition):
        refs = _refs(c)
        if not refs:
            rest.append(c)
        elif refs <= lnames:
            lpush.append(c)
        elif refs <= rnames:
            rpush.append(c)
        elif isinstance(c, ep.EqualTo):
            a, b = c.children
            ra, rb = _refs(a), _refs(b)
            if ra and rb and ra <= lnames and rb <= rnames:
                lkeys.append(a)
                rkeys.append(b)
            elif ra and rb and ra <= rnames and rb <= lnames:
                lkeys.append(b)
                rkeys.append(a)
            else:
                rest.append(c)
        else:
            rest.append(c)
    if not lpush and not rpush and len(lkeys) == len(j.left_keys):
        return f
    new_left = optimize(_filter_over(lpush, left))
    new_right = optimize(_filter_over(rpush, right))
    how = "inner" if lkeys else j.how
    joined = L.Join(new_left, new_right, how, lkeys, rkeys, j.condition)
    return _filter_over(rest, joined)


def _rewrite_filter_semi(f: L.Filter) -> L.LogicalPlan:
    """Filter over a semi or anti join: the join's output is its left
    rows, so a conjunct over the left columns commutes with it and sinks
    into the left side, where the comma-join rules then make equi-joins
    of it.  The ``IN (query)`` and ``EXISTS`` lowerings stack their joins
    between WHERE's filter and the FROM list's cross joins: without this
    rule those stay cross joins."""
    j = f.children[0]
    if not isinstance(j, L.Join) or j.how not in ("semi", "anti"):
        return f
    left = j.children[0]
    lnames = set(left.schema.names)
    push, rest = [], []
    for c in _flatten_and(f.condition):
        refs = _refs(c)
        (push if refs and refs <= lnames else rest).append(c)
    if not push:
        return f
    new_left = optimize(_filter_over(push, left))
    joined = L.Join(new_left, j.children[1], j.how, j.left_keys,
                    j.right_keys, j.condition)
    return _filter_over(rest, joined)


def _rewrite_filter_project(f: L.Filter) -> L.LogicalPlan:
    """Filter conjuncts through a Project whose columns they read are
    pure pass-throughs (a column, or a column under an alias): each is
    rewritten to the source names and sinks below the Project; the rest
    stay above."""
    pj = f.children[0]
    if not isinstance(pj, L.Project):
        return f
    mapping = {}                     # output name -> source column
    for e in pj.exprs:
        src = e.children[0] if isinstance(e, ec.Alias) else e
        if isinstance(src, ec.AttributeReference):
            mapping[ec.output_name(e)] = src

    def rewrite(e: ec.Expression):
        if isinstance(e, ec.AttributeReference):
            return mapping.get(e.col_name)
        kids = []
        for c in e.children:
            r = rewrite(c)
            if r is None:
                return None
            kids.append(r)
        return e.with_children(kids) if kids else e

    push, rest = [], []
    for c in _flatten_and(f.condition):
        r = rewrite(c) if _refs(c) is not None else None
        if r is None:
            rest.append(c)
        else:
            push.append(r)
    if not push:
        return f
    below = optimize(_filter_over(push, pj.children[0]))
    return _filter_over(rest, L.Project(pj.exprs, below))


def _collect_cross_tree(p: L.LogicalPlan, rels: List[L.LogicalPlan]) -> bool:
    """Flatten a keyless cross/inner join tree into its relations."""
    if isinstance(p, L.Join) and p.how in ("cross", "inner") and \
            not p.left_keys and p.condition is None:
        return _collect_cross_tree(p.children[0], rels) and \
            _collect_cross_tree(p.children[1], rels)
    rels.append(p)
    return True


def _reorder_cross_joins(f: L.Filter) -> L.Filter:
    """Connectivity-first order of a FROM list: from the first relation,
    attach next the first (in FROM order) relation an equality links to
    the joined set; a relation nothing links comes in FROM order."""
    j = f.children[0]
    rels: List[L.LogicalPlan] = []
    if not (isinstance(j, L.Join) and _collect_cross_tree(j, rels)) or \
            len(rels) < 3:
        return f
    names = [set(r.schema.names) for r in rels]
    if len(set().union(*names)) != sum(len(n) for n in names):
        return f
    edges = []
    for c in _conjuncts(f.condition):
        if isinstance(c, ep.EqualTo):
            ra, rb = _refs(c.children[0]), _refs(c.children[1])
            if not ra or not rb:
                continue
            ia = [i for i, n in enumerate(names) if ra <= n]
            ib = [i for i, n in enumerate(names) if rb <= n]
            if len(ia) == 1 and len(ib) == 1 and ia[0] != ib[0]:
                edges.append((ia[0], ib[0]))
    joined, order = {0}, [0]
    remaining = list(range(1, len(rels)))
    while remaining:
        pick = next((i for i in remaining
                     if any((a in joined) != (b in joined) and i in (a, b)
                            for a, b in edges)), remaining[0])
        joined.add(pick)
        order.append(pick)
        remaining.remove(pick)
    if order == list(range(len(rels))):
        return f
    tree = rels[order[0]]
    for i in order[1:]:
        tree = L.Join(tree, rels[i], "cross", [], [])
    return L.Filter(f.condition, tree)


def optimize(plan: L.LogicalPlan) -> L.LogicalPlan:
    new_children = [optimize(c) for c in plan.children]
    if any(n is not o for n, o in zip(new_children, plan.children)):
        plan = copy.copy(plan)
        plan.children = new_children
    if isinstance(plan, L.Filter):
        child = plan.children[0]
        if isinstance(child, L.Filter):
            return optimize(L.Filter(ep.And(plan.condition, child.condition),
                                     child.children[0]))
        plan = _reorder_cross_joins(plan)
        for rule in (_rewrite_filter_join, _rewrite_filter_semi):
            out = rule(plan)
            if out is not plan:
                return out
        return _rewrite_filter_project(plan)
    return plan


# -- scan column pruning -----------------------------------------------------

def _u(*sets: Optional[Set[str]]) -> Optional[Set[str]]:
    """Union of required-name sets; None (every column) wins."""
    out: Set[str] = set()
    for s in sets:
        if s is None:
            return None
        out |= s
    return out


def _refs_many(exprs) -> Optional[Set[str]]:
    return _u(*[_refs(e) for e in exprs]) if exprs else set()


def prune_scan_columns(plan: L.LogicalPlan,
                       need: Optional[Set[str]] = None) -> L.LogicalPlan:
    """Narrow each scan to the columns the plan above reads (``need``
    None: all of them).  Nodes are copied, never changed: a scan is
    shared by every query over its view."""
    if isinstance(plan, L.Scan):
        if need is None:
            return plan
        kept = [f for f in plan.schema if f.name in need]
        if len(kept) == len(plan.schema):
            return plan
        if not kept:                   # a count(*) still needs rows
            kept = [plan.schema[0]]
        from ..columnar.schema import Schema
        out = copy.copy(plan)
        out._schema = Schema(kept)
        return out
    if not plan.children:
        return plan
    if isinstance(plan, L.Filter):
        needs = [_u(need, _refs(plan.condition))]
    elif isinstance(plan, L.Project):
        if need is not None:
            kept = [e for e in plan.exprs if ec.output_name(e) in need]
            if len(kept) < len(plan.exprs):
                plan = copy.copy(plan)
                plan.exprs = kept or plan.exprs[:1]
        needs = [_refs_many(plan.exprs)]
    elif isinstance(plan, L.Aggregate):
        needs = [_u(_refs_many(plan.group_exprs),
                    _refs_many([a.func for a in plan.aggs]))]
    elif isinstance(plan, L.Join):
        cond = _refs(plan.condition) if plan.condition is not None \
            else set()
        n = _u(need, _refs_many(plan.left_keys),
               _refs_many(plan.right_keys), cond)
        needs = [n, n]
    elif isinstance(plan, L.Sort):
        needs = [_u(need, _refs_many([o.expr for o in plan.orders]))]
    elif isinstance(plan, L.Limit):
        needs = [need]
    else:
        needs = [None] * len(plan.children)
    new_children = [prune_scan_columns(c, n)
                    for c, n in zip(plan.children, needs)]
    if all(n is o for n, o in zip(new_children, plan.children)):
        return plan
    out = copy.copy(plan)
    out.children = new_children
    return out
