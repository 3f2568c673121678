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
Filter over a Union goes into every child (``_rewrite_filter_union``),
and one over an Aggregate sinks the conjuncts over its plain group keys
below it (``_rewrite_filter_aggregate``), two rules of Spark's
``PushPredicateThroughNonJoin``; a Filter stays above a Sort, a Limit,
a Distinct and a Window (q44's ``rnk < 11`` reads the window's column;
no rule moves a filter through a window).  Before any rule, conjuncts
over literals alone are decided (``_fold_constants``): a false one
leaves an ``EmptyRelation``.
``prune_scan_columns`` narrows every scan, and every projection, to the
columns the plan above reads, a union's children by position; below a
Window, those and the columns its functions, keys and orders read.
"""
from __future__ import annotations

import copy
import datetime
from typing import List, Optional, Set

from ..expr import core as ec
from ..expr.cast import Cast
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
    pure pass-throughs (a column, or a column under an alias) or
    constants: each is rewritten to the source names and the constants
    (q4's ``sale_type = 's'`` over a branch that selects ``'c'
    sale_type`` becomes ``'c' = 's'``, which ``_fold_constants`` then
    decides) and sinks below the Project; the rest stay above."""
    pj = f.children[0]
    if not isinstance(pj, L.Project):
        return f
    mapping = {}            # output name -> source column or constant
    for e in pj.exprs:
        src = e.children[0] if isinstance(e, ec.Alias) else e
        if isinstance(src, (ec.AttributeReference, ec.Literal)):
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


def _substitute(e: ec.Expression, mapping) -> ec.Expression:
    """``e`` with each column named in ``mapping`` replaced."""
    if isinstance(e, ec.AttributeReference):
        return mapping.get(e.col_name, e)
    return e.map_children(lambda c: _substitute(c, mapping))


def _rewrite_filter_union(f: L.Filter) -> L.LogicalPlan:
    """A Filter over a Union goes into each child, its columns renamed
    by position to the child's (under a cast where the union widened the
    child's type), as Spark's ``PushPredicateThroughNonJoin`` does.  q4
    reads its three-branch ``year_total`` CTE six times, each read
    filtering one channel and one year: inside each branch the year
    filter reaches ``date_dim`` and the channel filter becomes a
    constant."""
    u = f.children[0]
    if not isinstance(u, L.Union) or _refs(f.condition) is None:
        return f
    out = u.schema
    children = []
    for c in u.children:
        mapping = {}
        for uf, cf in zip(out, c.schema):
            ref = ec.AttributeReference(cf.name, cf.dtype, cf.nullable)
            mapping[uf.name] = ref if cf.dtype == uf.dtype else \
                Cast(ref, uf.dtype)
        children.append(optimize(L.Filter(
            _substitute(f.condition, mapping), c)))
    return L.Union(children)


def _rewrite_filter_aggregate(f: L.Filter) -> L.LogicalPlan:
    """Conjuncts of a Filter over an Aggregate that read only its plain
    group keys (a column grouped under its own name) sink below it: a
    group's key values are its rows' values, so filtering rows or
    groups by them keeps the same groups (Spark's
    ``PushPredicateThroughNonJoin``).  A conjunct that reads no column
    stays: over a keyless aggregate it decides whether its one row
    exists."""
    a = f.children[0]
    if not isinstance(a, L.Aggregate):
        return f
    keys = {e.col_name for e in a.group_exprs
            if isinstance(e, ec.AttributeReference)}
    push, rest = [], []
    for c in _flatten_and(f.condition):
        refs = _refs(c)
        (push if refs and refs <= keys else rest).append(c)
    if not push:
        return f
    below = optimize(_filter_over(push, a.children[0]))
    return _filter_over(rest, L.Aggregate(a.group_exprs, a.aggs, below))


#: the comparisons ``_constant`` decides, by their Python operator
_COMPARE = {ep.EqualTo: lambda a, b: a == b, ep.LessThan: lambda a, b: a < b,
            ep.LessThanOrEqual: lambda a, b: a <= b,
            ep.GreaterThan: lambda a, b: a > b,
            ep.GreaterThanOrEqual: lambda a, b: a >= b}
#: ``_constant``'s answer for an expression it does not decide
_UNKNOWN = object()


def _kind(v):
    """The kind of values a literal compares with in Python as SQL does
    (NaN and booleans are left alone)."""
    if isinstance(v, bool) or (isinstance(v, float) and v != v):
        return None
    if isinstance(v, (int, float)):
        return "number"
    return type(v).__name__ if isinstance(v, (str, datetime.date)) else None


def _constant(e: ec.Expression):
    """The value of a condition over literals alone: True, False, None
    (NULL), or ``_UNKNOWN`` for anything else."""
    if isinstance(e, ec.Literal):
        return e.value if e.value is None or isinstance(e.value, bool) \
            else _UNKNOWN
    if type(e) in _COMPARE:
        a, b = e.children
        if not (isinstance(a, ec.Literal) and isinstance(b, ec.Literal)):
            return _UNKNOWN
        if a.value is None or b.value is None:
            return None
        if _kind(a.value) is None or _kind(a.value) != _kind(b.value):
            return _UNKNOWN
        return _COMPARE[type(e)](a.value, b.value)
    vals = [_constant(c) for c in e.children]
    if any(v is _UNKNOWN for v in vals):
        return _UNKNOWN
    if isinstance(e, ep.Not):
        return None if vals[0] is None else not vals[0]
    if isinstance(e, ep.And):
        if False in vals:
            return False
        return None if None in vals else True
    if isinstance(e, ep.Or):
        if True in vals:
            return True
        return None if None in vals else False
    return _UNKNOWN


def _fold_constants(f: L.Filter) -> L.LogicalPlan:
    """A Filter's conjuncts over literals alone, decided now: a true one
    goes, and a false or NULL one makes the Filter an ``EmptyRelation``
    of its schema, so nothing below it runs (Spark's ``PruneFilters``).
    q4's branches of the wrong channel become empty this way."""
    keep = []
    for c in _flatten_and(f.condition):
        v = _constant(c)
        if v is _UNKNOWN:
            keep.append(c)
        elif v is not True:
            return L.EmptyRelation(f.schema)
    if len(keep) == len(_flatten_and(f.condition)):
        return f
    return _filter_over(keep, f.children[0])


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
        folded = _fold_constants(plan)
        if not isinstance(folded, L.Filter):
            return folded
        plan = _reorder_cross_joins(folded)
        for rule in (_rewrite_filter_join, _rewrite_filter_semi,
                     _rewrite_filter_union, _rewrite_filter_aggregate):
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
    elif isinstance(plan, L.Union):
        return _prune_union(plan, need)
    elif isinstance(plan, L.Window):
        aliases = {wf.alias for wf in plan.window_funcs}
        base = None if need is None else need - aliases
        needs = [_u(base, *[_u(_refs(wf.func),
                               _refs_many(wf.spec.partition_by),
                               _refs_many([o.expr for o in
                                           wf.spec.order_by]))
                            for wf in plan.window_funcs])]
    else:
        # a Distinct's rows are all its columns: it needs every one
        needs = [None] * len(plan.children)
    new_children = [prune_scan_columns(c, n)
                    for c, n in zip(plan.children, needs)]
    if all(n is o for n, o in zip(new_children, plan.children)):
        return plan
    out = copy.copy(plan)
    out.children = new_children
    return out


def _prune_union(plan: L.Union, need: Optional[Set[str]]) -> L.LogicalPlan:
    """A union needs, of each child, the columns at the positions of the
    union's columns the plan above reads (the reference's rule, by
    position); a child that keeps more columns than those is projected
    to them, so every child keeps the same positions."""
    if need is None:
        pos = list(range(len(plan.schema)))
    else:
        pos = [i for i, n in enumerate(plan.schema.names) if n in need] \
            or [0]
    children = []
    for c in plan.children:
        names = [c.schema.names[i] for i in pos]
        pruned = prune_scan_columns(c, set(names))
        if pruned.schema.names != names:
            pruned = L.Project([ec.AttributeReference(n).resolve(
                pruned.schema) for n in names], pruned)
        children.append(pruned)
    if all(n is o for n, o in zip(children, plan.children)):
        return plan
    out = copy.copy(plan)
    out.children = children
    return out
