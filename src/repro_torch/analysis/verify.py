"""Plan verifier of the port: execution-free invariant checking over
compiled batch plans, IVM's delta and tick programs, resident relations and
the router's secondary programs; counterpart of
``repro/analysis/verify.py``.

The checks are copies of the reference's, identical apart from imports:
``verify_plan`` re-derives every ``GroupProgram``, the shared-scan
``Schedule`` and the fused ``StepProgram``s from the schema and the plan
alone, ``verify_delta_program`` a maintenance plan's first-order
soundness, and ``verify_secondary_program`` gates a routed
re-aggregation; each raises a structured :class:`PlanInvariantError`
naming the violated rule.  ``verify_tick_program`` makes the reference's
checks one for one, the mesh checks included (a partitioned step
all-reduces its views before the fold: psum-before-fold).
``verify_resident`` is the port's own: it checks a
:class:`ResidentRelation`, whose live rows ``[0, n_valid)`` are counted on
the host, with the reference's rule id and check count, and a rank's
:class:`ShardedResidentRelation` with the reference's sharded checks as
they apply to one shard.

Enablement: ``verification_enabled(flag)`` — an explicit ``True``/``False``
(from ``ExecutionConfig.verify_plans`` / ``PlanConfig.verify_plans``) wins;
otherwise the ``REPRO_VERIFY`` env var decides; otherwise verification is on
exactly when running under pytest, so the whole test suite doubles as a
zero-false-positive corpus for the verifier.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Mapping, Optional, Tuple


def _batched_fixpoint(views):
    # imported lazily: analysis.verify must stay an import leaf (stdlib
    # only at module scope) — core.plan and core.ivm import it while the
    # repro_torch.core package is still initializing
    from repro_torch.core.ir import compute_batched_vids
    return compute_batched_vids(views)

# -- invariant rule ids (DESIGN.md §12 catalog) ------------------------------

GATHER_PREFIX = "gather-prefix"       # gather/rest split + leading-axes rule
SEGMENT_LAYOUT = "segment-layout"     # segment attrs/dims/count vs domains
ACC_SHAPE = "acc-shape"               # accumulator/output geometry
AXIS_FRAME = "axis-frame"             # product axis frames: pulled ++ extra
DTYPE_FLOW = "dtype-flow"             # attr existence/kind + column bindings
SCHEDULE_TOPO = "schedule-topo"       # shared-scan fusion + dependency order
BATCHED_FLAG = "batched-flag"         # param-batch flags vs the fixpoint
DELTA_FIRST_ORDER = "delta-first-order"  # one affected factor per product
WEIGHT_COMPAT = "weight-compat"       # signed ±1 weights only on delta scans
RESIDENT_CAPACITY = "resident-capacity"  # pow2 capacity, n_valid bounds
PSUM_BEFORE_FOLD = "psum-before-fold"    # tick vs its delta program
ROUTE_SUBSUME = "route-subsume"          # secondary re-aggregation soundness

ALL_INVARIANTS = (
    GATHER_PREFIX, SEGMENT_LAYOUT, ACC_SHAPE, AXIS_FRAME, DTYPE_FLOW,
    SCHEDULE_TOPO, BATCHED_FLAG, DELTA_FIRST_ORDER, WEIGHT_COMPAT,
    RESIDENT_CAPACITY, PSUM_BEFORE_FOLD, ROUTE_SUBSUME,
)


class PlanInvariantError(Exception):
    """A compiled artifact violates a typed engine invariant.

    Attributes: ``invariant`` (rule id from the DESIGN.md §12 catalog),
    ``artifact`` (which plan component), ``detail`` (what broke).
    """

    def __init__(self, invariant: str, artifact: str, detail: str):
        self.invariant = invariant
        self.artifact = artifact
        self.detail = detail
        super().__init__(f"[{invariant}] {artifact}: {detail}")


@dataclasses.dataclass(frozen=True)
class VerificationReport:
    """What one verification pass covered (surfaced by ``explain()``)."""

    artifact: str
    n_checks: int
    invariants: Tuple[str, ...]

    def summary(self) -> str:
        return (f"{self.artifact} ok ({self.n_checks} checks, "
                f"{len(self.invariants)} invariants)")


def verification_enabled(flag: Optional[bool]) -> bool:
    """Resolve a tri-state verify setting: explicit flag > ``REPRO_VERIFY``
    env var > auto-on under pytest."""
    if flag is not None:
        return bool(flag)
    env = os.environ.get("REPRO_VERIFY")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no", "off")
    return "PYTEST_CURRENT_TEST" in os.environ


class _Ctx:
    """Check counter: every invariant evaluation is tallied so reports can
    state coverage, and the first failure raises."""

    def __init__(self):
        self.n_checks = 0
        self.invariants = set()

    def check(self, cond: bool, invariant: str, artifact: str, detail: str):
        self.n_checks += 1
        self.invariants.add(invariant)
        if not cond:
            raise PlanInvariantError(invariant, artifact, detail)

    def report(self, artifact: str) -> VerificationReport:
        return VerificationReport(artifact, self.n_checks,
                                  tuple(sorted(self.invariants)))


# -- scan-program checks (shared by batch plans and delta programs) ----------

def _verify_scan_program(ctx: _Ctx, schema, views: Mapping[int, object],
                         prog, batched: frozenset, where: str) -> None:
    """Invariants of one scan program (``GroupProgram``/``StepProgram``):
    gather specs, per-view geometry, product axis frames, term bindings,
    batched flags — everything the lowering backends index by without
    re-checking."""
    rel = prog.rel
    ctx.check(rel in schema.relations, DTYPE_FLOW, where,
              f"scans unknown relation {rel!r}")
    rel_attrs = schema.relation(rel).attr_set
    gathers: Dict[int, object] = {}
    for gs in prog.gathers:
        art = f"{where}: gather v{gs.vid}"
        ctx.check(gs.vid in views, GATHER_PREFIX, art,
                  "gathers a view the plan never defined")
        child_gb = views[gs.vid].group_by
        exp_gather = tuple(a for a in child_gb if a in rel_attrs)
        exp_rest = tuple(a for a in child_gb if a not in rel_attrs)
        ctx.check(gs.gather == exp_gather, GATHER_PREFIX, art,
                  f"gather attrs {gs.gather} != child group-by ∩ {rel!r} "
                  f"attrs {exp_gather}")
        ctx.check(gs.rest == exp_rest, GATHER_PREFIX, art,
                  f"rest attrs {gs.rest} != child group-by ∖ {rel!r} "
                  f"attrs {exp_rest}")
        ctx.check(child_gb[:len(exp_gather)] == exp_gather, GATHER_PREFIX,
                  art, f"gather attrs {exp_gather} are not the child's "
                  f"leading axes (child group-by {child_gb}) — the backend "
                  "flattens leading axes into one take index")
        ctx.check(gs.batched == (gs.vid in batched), BATCHED_FLAG, art,
                  f"gather marked batched={gs.batched} but the "
                  f"compute_batched_vids fixpoint says {gs.vid in batched}")
        gathers[gs.vid] = gs
    for vp in prog.views:
        _verify_view_program(ctx, schema, views, vp, rel, rel_attrs,
                             batched, gathers, where)


def _verify_view_program(ctx: _Ctx, schema, views, vp, rel, rel_attrs,
                         batched, gathers, where: str) -> None:
    art = f"{where}: view v{vp.vid}"
    ctx.check(vp.vid in views, DTYPE_FLOW, art,
              "computes a view the plan never defined")
    w = views[vp.vid]
    ctx.check(vp.rel == w.rel == rel, SCHEDULE_TOPO, art,
              f"scans {vp.rel!r} inside a {rel!r} step (definition says "
              f"{w.rel!r}) — shared-scan fusion only merges same-relation "
              "views")
    for a in vp.group_by:
        ctx.check(a in schema.attributes, DTYPE_FLOW, art,
                  f"groups by unknown attribute {a!r}")
        ctx.check(schema.attr(a).is_discrete, DTYPE_FLOW, art,
                  f"groups by continuous attribute {a!r} — group-by axes "
                  "need finite domains")
    ctx.check(vp.group_by == w.group_by, ACC_SHAPE, art,
              f"group-by {vp.group_by} != definition {w.group_by}")
    ctx.check(vp.n_aggs == w.n_aggs and len(vp.cols) == vp.n_aggs,
              ACC_SHAPE, art,
              f"column layout {len(vp.cols)}/{vp.n_aggs} != definition "
              f"{w.n_aggs} — parents index child columns by position")
    exp_local = tuple(a for a in vp.group_by if a in rel_attrs)
    exp_pulled = tuple(a for a in vp.group_by if a not in rel_attrs)
    ctx.check(vp.local == exp_local and vp.pulled == exp_pulled,
              SEGMENT_LAYOUT, art,
              f"local/pulled split ({vp.local}, {vp.pulled}) != partition "
              f"of group-by by {rel!r} attrs ({exp_local}, {exp_pulled})")
    if exp_local:
        ctx.check(vp.seg is not None, SEGMENT_LAYOUT, art,
                  "local group-by attrs but no segment spec")
        seg = vp.seg
        ctx.check(seg.attrs == exp_local, SEGMENT_LAYOUT, art,
                  f"segment attrs {seg.attrs} != local group-by {exp_local}")
        dims = tuple(schema.domain(a) for a in seg.attrs)
        ctx.check(seg.dims == dims, SEGMENT_LAYOUT, art,
                  f"segment dims {seg.dims} != attribute domains {dims}")
        n_seg = int(math.prod(dims))
        ctx.check(seg.n_segments == n_seg and seg.n_segments >= 1,
                  SEGMENT_LAYOUT, art,
                  f"segment count {seg.n_segments} != prod{dims} = {n_seg} "
                  "— segment ids could land out of accumulator bounds")
    else:
        ctx.check(vp.seg is None, SEGMENT_LAYOUT, art,
                  "segment spec present without local group-by attrs")
    pulled_dims = tuple(schema.domain(a) for a in exp_pulled)
    ctx.check(vp.pulled_dims == pulled_dims, ACC_SHAPE, art,
              f"pulled dims {vp.pulled_dims} != domains {pulled_dims}")
    exp_acc = (((vp.seg.n_segments,) if vp.seg is not None else ())
               + pulled_dims + (vp.n_aggs,))
    ctx.check(vp.acc_shape == exp_acc, ACC_SHAPE, art,
              f"accumulator shape {vp.acc_shape} != {exp_acc}")
    exp_out = tuple(schema.domain(a) for a in exp_local) + pulled_dims
    ctx.check(vp.out_dims == exp_out, ACC_SHAPE, art,
              f"output dims {vp.out_dims} != {exp_out}")
    computed = list(exp_local) + list(exp_pulled)
    exp_perm = tuple(computed.index(a) for a in vp.group_by) + (len(computed),)
    ctx.check(vp.out_perm == exp_perm, ACC_SHAPE, art,
              f"output permutation {vp.out_perm} != {exp_perm} — parents "
              "would gather transposed axes")
    ctx.check(vp.batched == (vp.vid in batched), BATCHED_FLAG, art,
              f"batched={vp.batched} but the fixpoint says "
              f"{vp.vid in batched}")
    for ci, col in enumerate(vp.cols):
        for pi, prod in enumerate(col.products):
            part = f"{art} col {ci} product {pi}"
            used = set()
            any_batched = False
            for ref in prod.child_refs:
                ctx.check(ref.vid in gathers, GATHER_PREFIX, part,
                          f"references child v{ref.vid} with no gather spec "
                          "in its scan step")
                ctx.check(ref.rest == gathers[ref.vid].rest, AXIS_FRAME,
                          part, f"child rest axes {ref.rest} != gathered "
                          f"rest {gathers[ref.vid].rest}")
                ctx.check(ref.vid in views
                          and 0 <= ref.col < views[ref.vid].n_aggs,
                          DTYPE_FLOW, part,
                          f"child column {ref.col} out of range for "
                          f"v{ref.vid}")
                ctx.check(ref.batched == (ref.vid in batched), BATCHED_FLAG,
                          part, f"child ref batched={ref.batched} but the "
                          f"fixpoint says {ref.vid in batched}")
                any_batched |= ref.batched
                used |= set(ref.rest)
            for ta in prod.local_terms:
                attrs = ta.term.attrs()
                exp_col = tuple(sorted(a for a in attrs if a in rel_attrs))
                exp_dom = tuple(sorted(a for a in attrs
                                       if a not in rel_attrs))
                ctx.check(ta.col_attrs == exp_col, DTYPE_FLOW, part,
                          f"term column bindings {ta.col_attrs} != the "
                          f"term's {rel!r} attrs {exp_col} — the lowering "
                          "would feed the term the wrong scanned columns")
                ctx.check(ta.dom_attrs == exp_dom, DTYPE_FLOW, part,
                          f"term domain attrs {ta.dom_attrs} != non-{rel!r} "
                          f"attrs {exp_dom}")
                for a in exp_dom:
                    ctx.check(a in schema.attributes
                              and schema.attr(a).is_discrete, DTYPE_FLOW,
                              part, f"domain-iota attribute {a!r} is not "
                              "discrete")
                exp_dd = tuple(schema.domain(a) for a in ta.dom_attrs)
                ctx.check(ta.dom_dims == exp_dd, DTYPE_FLOW, part,
                          f"domain dims {ta.dom_dims} != {exp_dd}")
                ctx.check(ta.batched == ta.term.is_batched(), BATCHED_FLAG,
                          part, f"term marked batched={ta.batched} but "
                          f"is_batched()={ta.term.is_batched()}")
                any_batched |= ta.batched
                used |= set(ta.dom_attrs)
            exp_axes = vp.pulled + tuple(sorted(used - set(vp.pulled)))
            ctx.check(prod.axes == exp_axes, AXIS_FRAME, part,
                      f"axis frame {prod.axes} != pulled ++ extra "
                      f"{exp_axes}")
            ctx.check(prod.n_keep == len(vp.pulled), AXIS_FRAME, part,
                      f"keeps {prod.n_keep} leading axes but the pulled "
                      f"frame has {len(vp.pulled)} — sum-out would drop or "
                      "keep the wrong axes")
            for a in prod.axes:
                ctx.check(a in schema.attributes
                          and schema.attr(a).is_discrete, DTYPE_FLOW, part,
                          f"axis attribute {a!r} is not discrete")
            exp_ad = tuple(schema.domain(a) for a in prod.axes)
            ctx.check(prod.axis_dims == exp_ad, AXIS_FRAME, part,
                      f"axis dims {prod.axis_dims} != domains {exp_ad}")
            ctx.check(prod.batched == any_batched, BATCHED_FLAG, part,
                      f"product batched={prod.batched} but its factors say "
                      f"{any_batched}")
    if vp.hist is not None:
        h = vp.hist
        ah = f"{art} hist"
        ctx.check(len(vp.local) == 1 and not vp.pulled and vp.n_aggs == 3,
                  DTYPE_FLOW, ah,
                  "tree-hist pattern requires exactly "
                  "[Σcond, Σcond·y, Σcond·y²] grouped by one local "
                  "attribute")
        ctx.check(h.code_attr == vp.local[0], DTYPE_FLOW, ah,
                  f"bucket attribute {h.code_attr!r} != local group-by "
                  f"{vp.local[0]!r}")
        ctx.check(h.n_buckets == schema.domain(h.code_attr), SEGMENT_LAYOUT,
                  ah, f"bucket count {h.n_buckets} != domain of "
                  f"{h.code_attr!r} ({schema.domain(h.code_attr)})")
        ctx.check(h.y_attr in rel_attrs, DTYPE_FLOW, ah,
                  f"moment attribute {h.y_attr!r} is not scanned by {rel!r}")


# -- public entry points -----------------------------------------------------

def verify_plan(plan) -> VerificationReport:
    """Verify a compiled batch plan end to end: every ``GroupProgram``,
    the shared-scan ``Schedule``, and the fused per-step ``StepProgram``s
    the backends actually execute."""
    ctx = _Ctx()
    schema, views = plan.schema, plan.views
    batched = _batched_fixpoint(views)
    for gid in sorted(plan.programs):
        _verify_scan_program(ctx, schema, views, plan.programs[gid],
                             batched, f"group {gid}")
    _verify_schedule(ctx, plan.schedule, plan.groups)
    sched = plan.schedule
    ctx.check(len(plan.step_programs) == len(sched.steps), SCHEDULE_TOPO,
              "schedule", f"{len(plan.step_programs)} fused step programs "
              f"for {len(sched.steps)} scan steps")
    for step, sp in zip(sched.steps, plan.step_programs):
        art = f"step {step.sid} ({step.rel})"
        ctx.check(sp.rel == step.rel, SCHEDULE_TOPO, art,
                  f"fused program scans {sp.rel!r}")
        ctx.check(tuple(sp.gids) == tuple(step.gids), SCHEDULE_TOPO, art,
                  f"fused program covers groups {sp.gids} != step's "
                  f"{step.gids}")
        ctx.check(tuple(vp.vid for vp in sp.views) == tuple(step.vids),
                  SCHEDULE_TOPO, art,
                  "fused program's view order diverges from the step's vids")
        _verify_scan_program(ctx, schema, views, sp, batched, art)
    return ctx.report("plan")


def _verify_schedule(ctx: _Ctx, sched, groups) -> None:
    by_gid = {g.gid: g for g in groups}
    step_gids = sorted(g for s in sched.steps for g in s.gids)
    ctx.check(step_gids == sorted(by_gid), SCHEDULE_TOPO, "schedule",
              "scan steps do not partition the view groups (a group is "
              "missing or scanned twice)")
    ctx.check([s.sid for s in sched.steps] == list(range(len(sched.steps))),
              SCHEDULE_TOPO, "schedule", "step ids are not dense execution "
              "order")
    sid_of = {g: s.sid for s in sched.steps for g in s.gids}
    for s in sched.steps:
        art = f"step {s.sid} ({s.rel})"
        for g in s.gids:
            ctx.check(by_gid[g].rel == s.rel, SCHEDULE_TOPO, art,
                      f"fuses group {g} which scans {by_gid[g].rel!r} — "
                      "shared scans must share the relation")
        exp_vids = tuple(v for g in s.gids for v in by_gid[g].vids)
        ctx.check(tuple(s.vids) == exp_vids, SCHEDULE_TOPO, art,
                  f"step vids {s.vids} != concatenated group vids "
                  f"{exp_vids}")
        for d in s.deps:
            ctx.check(0 <= d < s.sid, SCHEDULE_TOPO, art,
                      f"depends on step {d}, which does not execute "
                      "earlier")
            ctx.check(sched.steps[d].level < s.level, SCHEDULE_TOPO, art,
                      f"level {s.level} not above dependency step {d}'s "
                      f"level {sched.steps[d].level}")
        for g in s.gids:
            for dep_g in by_gid[g].deps:
                ctx.check(sid_of[dep_g] < s.sid, SCHEDULE_TOPO, art,
                          f"group {g} needs group {dep_g}, scheduled at "
                          f"step {sid_of[dep_g]} — child views would be "
                          "gathered before they exist")
                ctx.check(sid_of[dep_g] in s.deps, SCHEDULE_TOPO, art,
                          f"group dependency {dep_g} (step "
                          f"{sid_of[dep_g]}) missing from step deps "
                          f"{s.deps}")


def verify_delta_program(plan, dp) -> VerificationReport:
    """Verify one relation's maintenance plan: every delta step's scan
    program, first-order soundness (exactly one affected factor per kept
    product, none on tier-1 scans), step ordering over the affected
    sub-DAG, and the weight/state contracts the tick runner relies on."""
    ctx = _Ctx()
    schema, views = plan.schema, plan.views
    batched = _batched_fixpoint(views)
    art = f"Δ{dp.rel}"
    ctx.check(dp.rel in schema.relations, DTYPE_FLOW, art,
              f"maintains unknown relation {dp.rel!r}")
    if not dp.steps:
        ctx.check(not dp.affected, DELTA_FIRST_ORDER, art,
                  f"views {sorted(dp.affected)} are affected but no step "
                  "maintains them")
        return ctx.report(art)
    produced = set()
    out_vids = []
    for i, st in enumerate(dp.steps):
        sart = f"{art} step {i} ({st.rel})"
        ctx.check(st.scans_delta == (st.rel == dp.rel), WEIGHT_COMPAT, sart,
                  f"scans_delta={st.scans_delta} but the step scans "
                  f"{st.rel!r} and the update targets {dp.rel!r} — signed "
                  "±1 multiplicities are only sound on the update's own "
                  "delta tuples")
        _verify_scan_program(ctx, schema, views, st.prog, batched, sart)
        for gs in st.prog.gathers:
            if gs.vid in dp.affected:
                ctx.check(not st.scans_delta, DELTA_FIRST_ORDER, sart,
                          f"tier-1 delta scan gathers affected child "
                          f"v{gs.vid} — a second-order term (join-tree "
                          "subtrees below the update relation are disjoint "
                          "from it)")
                ctx.check(gs.vid in produced, DELTA_FIRST_ORDER, sart,
                          f"gathers affected child v{gs.vid} before its "
                          "delta is computed — it would read stale state")
        for vp in st.prog.views:
            ctx.check(vp.vid in dp.affected, DELTA_FIRST_ORDER, sart,
                      f"computes v{vp.vid}, which the update does not "
                      "affect")
            out_vids.append(vp.vid)
            if not st.scans_delta:
                for ci, col in enumerate(vp.cols):
                    for pi, prod in enumerate(col.products):
                        hits = [r.vid for r in prod.child_refs
                                if r.vid in dp.affected]
                        ctx.check(len(hits) == 1, DELTA_FIRST_ORDER,
                                  f"{sart}: v{vp.vid} col {ci} product "
                                  f"{pi}",
                                  f"{len(hits)} {dp.rel}-dependent child "
                                  "factors (affected children "
                                  f"{hits or '[]'}) — first-order "
                                  "Δ(product) needs exactly one")
        produced.update(vp.vid for vp in st.prog.views)
    ctx.check(sorted(out_vids) == sorted(dp.affected), DELTA_FIRST_ORDER,
              art, f"steps compute {sorted(out_vids)} but the affected set "
              f"is {sorted(dp.affected)} (each exactly once)")
    exp_base = tuple(sorted({s.rel for s in dp.steps if not s.scans_delta}))
    ctx.check(tuple(dp.base_rels) == exp_base, DELTA_FIRST_ORDER, art,
              f"base_rels {dp.base_rels} != rescanned relations {exp_base}")
    gathered = {gs.vid for s in dp.steps for gs in s.prog.gathers}
    ctx.check(set(dp.state_vids) >= (set(dp.affected) | gathered),
              DELTA_FIRST_ORDER, art,
              f"state inputs {sorted(dp.state_vids)} miss affected or "
              "gathered views — the fold would read undefined arrays")
    return ctx.report(art)


def verify_tick_program(tp, dp) -> VerificationReport:
    """Verify a tick program against its delta program: the same steps in
    the same order, weights applied exactly on the delta-tuple scan, a
    fold over exactly the affected views, and — the sharding soundness
    rule — every step that scans partitioned rows all-reduces *all* of its
    view deltas before any later gather or the state fold, while no other
    step all-reduces at all.  The reference's checks, one for one, under
    its rule ids; an unsharded tick passes the mesh checks trivially."""
    ctx = _Ctx()
    where = (f"tick Δ{tp.rel}" if tp.shard_rel is None
             else f"tick Δ{tp.rel} (shard {tp.shard_rel}@{tp.axis})")
    ctx.check(tp.rel == dp.rel, PSUM_BEFORE_FOLD, where,
              f"tick targets {tp.rel!r} but the delta program maintains "
              f"{dp.rel!r}")
    ctx.check((tp.shard_rel is None) == (tp.axis is None), PSUM_BEFORE_FOLD,
              where, "partitioned relation and mesh axis must be set "
              "together")
    ctx.check(len(tp.steps) == len(dp.steps), PSUM_BEFORE_FOLD, where,
              f"{len(tp.steps)} tick steps for {len(dp.steps)} delta steps")
    for i, (ts, st) in enumerate(zip(tp.steps, dp.steps)):
        sart = f"{where} step {i} ({ts.rel})"
        ctx.check(ts.prog is st.prog and ts.rel == st.rel
                  and ts.scans_delta == st.scans_delta, PSUM_BEFORE_FOLD,
                  sart, "tick step diverges from its delta step")
        ctx.check(ts.weighted == ts.scans_delta, WEIGHT_COMPAT, sart,
                  f"weighted={ts.weighted} on a "
                  f"{'delta' if ts.scans_delta else 'base-rescan'} step — "
                  "signed ±1 update weights must be folded into the "
                  "validity mask exactly on the delta-tuple scan")
        partitioned = tp.shard_rel is not None and ts.rel == tp.shard_rel
        ctx.check(ts.partitioned == partitioned, PSUM_BEFORE_FOLD, sart,
                  f"partitioned={ts.partitioned} but the step scans "
                  f"{ts.rel!r} and the sharded relation is "
                  f"{tp.shard_rel!r}")
        step_vids = tuple(vp.vid for vp in ts.prog.views)
        if partitioned:
            ctx.check(tuple(ts.psum_vids) == step_vids, PSUM_BEFORE_FOLD,
                      sart, f"psums {tuple(ts.psum_vids)} != the step's "
                      f"views {step_vids} — a later gather or the state "
                      "fold would read partial per-shard deltas and the "
                      "published epoch would stop being the same on every "
                      "rank")
        else:
            ctx.check(not ts.psum_vids, PSUM_BEFORE_FOLD, sart,
                      "an all-reduce after a replicated-row scan would "
                      "multiply its delta by the rank count")
    ctx.check(tuple(tp.fold_vids) == tuple(sorted(dp.affected)),
              PSUM_BEFORE_FOLD, where,
              f"state fold covers {tuple(tp.fold_vids)} != affected views "
              f"{tuple(sorted(dp.affected))}")
    return ctx.report(where)


def verify_resident(rr) -> VerificationReport:
    """Verify a resident relation's capacity contract: pow2 capacity,
    uniform column buffers, ``0 ≤ n_valid ≤ capacity`` (the live rows
    ``[0, n_valid)`` lie within every buffer), a host row count, one
    device; for a rank's shard of a partitioned relation, the per-shard
    upper bounds within the capacity and above the exact total, and a
    0-d integral device count.  Metadata only — never touches device
    values."""
    ctx = _Ctx()
    sharded = hasattr(rr, "gids")
    art = f"{'sharded ' if sharded else ''}resident {rr.name!r}"
    lens = {a: int(c.shape[0]) for a, c in rr.buffers.items()}
    ctx.check(len(rr.buffers) > 0, RESIDENT_CAPACITY, art,
              "no column buffers")
    ctx.check(len(set(lens.values())) == 1, RESIDENT_CAPACITY, art,
              f"ragged column buffers {lens}")
    cap = rr.capacity
    ctx.check(cap >= 1 and (cap & (cap - 1)) == 0, RESIDENT_CAPACITY, art,
              f"capacity {cap} is not a power of two — growth doubling and "
              "pad-bucket runner caches assume pow2")
    if sharded:
        ndev = rr.n_devices
        ctx.check(set(lens.values()) <= {cap}, RESIDENT_CAPACITY, art,
                  f"column buffers {lens} are not the shard's capacity "
                  f"{cap} (its global-id column's length)")
        ctx.check(0 <= rr.n_valid <= cap * ndev, RESIDENT_CAPACITY, art,
                  f"n_valid {rr.n_valid} outside [0, {cap * ndev}]")
        ub = rr.n_valid_ub
        ctx.check(tuple(ub.shape) == (ndev,), RESIDENT_CAPACITY, art,
                  f"per-shard row bound shape {tuple(ub.shape)} != "
                  f"({ndev},)")
        ctx.check(int(ub.min()) >= 0 and int(ub.max()) <= cap,
                  RESIDENT_CAPACITY, art,
                  f"per-shard row bounds {ub.tolist()} escape [0, {cap}] — "
                  "a scan or an insert would run past a shard's buffer")
        ctx.check(rr.n_valid <= int(ub.sum()), RESIDENT_CAPACITY, art,
                  f"exact count {rr.n_valid} exceeds the per-shard upper "
                  f"bounds Σ{ub.tolist()}")
        ctx.check(tuple(rr.n_valid_dev.shape) == (), RESIDENT_CAPACITY, art,
                  "the shard's device row counter is not a scalar")
        dt = rr.n_valid_dev.dtype
        ctx.check(not dt.is_floating_point and not dt.is_complex
                  and str(dt) != "torch.bool", RESIDENT_CAPACITY, art,
                  f"device row counter dtype {dt} is not integral")
        devices = {c.device for c in rr.buffers.values()} | {rr.gids.device}
        ctx.check(len(devices) == 1, RESIDENT_CAPACITY, art,
                  f"column buffers on {sorted(map(str, devices))}")
        return ctx.report(art)
    ctx.check(0 <= rr.n_valid <= cap, RESIDENT_CAPACITY, art,
              f"n_valid {rr.n_valid} outside [0, {cap}]")
    ctx.check(isinstance(rr.n_valid, int) and not isinstance(rr.n_valid, bool),
              RESIDENT_CAPACITY, art,
              f"row count {rr.n_valid!r} is not a host int — the scans "
              "slice [0, n_valid) on the host")
    devices = {c.device for c in rr.buffers.values()}
    ctx.check(len(devices) == 1, RESIDENT_CAPACITY, art,
              f"column buffers on {sorted(map(str, devices))}")
    return ctx.report(art)


def verify_secondary_program(sp) -> VerificationReport:
    """Verify a serving-router secondary program (``core/subsume.py``):
    the closed-form re-aggregation answering a routed query from a wider
    materialized view.  The admission gate for tier-1/tier-2 routed
    answers — purely structural, like every rule here: group-by
    derivability (partition refinement), agg-column render equality,
    domain agreement on shared dims, and the sum/permute geometry the
    lowered function indexes by."""
    ctx = _Ctx()
    src, tgt = sp.source, sp.target
    art = f"route {src.name!r} -> {tgt.name!r}"
    ctx.check(len(src.dims) == len(src.domains), ROUTE_SUBSUME, art,
              f"source dims {src.dims} vs domains {src.domains} ragged")
    ctx.check(len(tgt.dims) == len(tgt.domains), ROUTE_SUBSUME, art,
              f"target dims {tgt.dims} vs domains {tgt.domains} ragged")
    keep = set(tgt.dims)
    ctx.check(keep <= set(src.dims), ROUTE_SUBSUME, art,
              f"target group-by {sorted(keep - set(src.dims))} not in the "
              "source view — coarser groupings only (partition refinement)")
    src_dom = dict(zip(src.dims, src.domains))
    for d, n in zip(tgt.dims, tgt.domains):
        ctx.check(src_dom.get(d) == n, ROUTE_SUBSUME, art,
                  f"dim {d!r} domain {n} != source's {src_dom.get(d)} — "
                  "the answer tensor would be mis-shaped")
    ctx.check(len(sp.col_idx) == len(tgt.aggs), ROUTE_SUBSUME, art,
              f"{len(sp.col_idx)} column picks for {len(tgt.aggs)} target "
              "aggregates")
    for j, i in enumerate(sp.col_idx):
        ctx.check(0 <= i < len(src.aggs), ROUTE_SUBSUME, art,
                  f"target column {j} gathers source column {i}, outside "
                  f"[0, {len(src.aggs)})")
        ctx.check(src.aggs[i] == tgt.aggs[j], ROUTE_SUBSUME, art,
                  f"target column {j} ({tgt.aggs[j]!r}) gathers source "
                  f"column {i} ({src.aggs[i]!r}) — summing a different "
                  "aggregate would serve wrong answers")
    exp_sum = tuple(i for i, d in enumerate(src.dims) if d not in keep)
    ctx.check(tuple(sp.sum_axes) == exp_sum, ROUTE_SUBSUME, art,
              f"sum axes {tuple(sp.sum_axes)} != the source axes not in "
              f"the target group-by {exp_sum}")
    kept = [d for d in src.dims if d in keep]
    ctx.check(sorted(sp.perm) == list(range(len(kept))), ROUTE_SUBSUME, art,
              f"{sp.perm} is not a permutation of the {len(kept)} kept "
              "axes")
    got = tuple(kept[p] for p in sp.perm) if sorted(sp.perm) == \
        list(range(len(kept))) else ()
    ctx.check(got == tuple(tgt.dims), ROUTE_SUBSUME, art,
              f"permutation yields axis order {got} != target group-by "
              f"{tuple(tgt.dims)}")
    return ctx.report(art)

