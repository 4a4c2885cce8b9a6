"""Graph planner for the declarative builder (port of
``repro.api.planner``; DESIGN.md section 11.2).

Three jobs, all at build time (nothing here runs on the data path):

1. **Spec resolution by tracing.**  Function-style operators declare no
   ``in_value_spec`` / ``out_streams`` — the planner propagates value
   specs from the sources through the graph, building each operator
   once all of its input stream specs are known and inferring its
   output specs by calling it on ``meta`` tensors (shapes and dtypes,
   no data, no device work), where the JAX package uses
   ``jax.eval_shape``.  A function that branches on values
   (``.item()``, ``bool(tensor)``) cannot run on meta tensors and gets
   a :class:`PlanError` asking for an explicit spec.  Operators that
   hold device state (a model's parameters on the card) cannot meet a
   meta input: they write their output spec down in ``bind(in_spec)``,
   which the planner calls instead of tracing.  Cycles are fine as long
   as every cycle contains at least one stream whose spec is known some
   other way (a source, a declared ``app.stream(name, spec)``, or an
   operator buildable from outside the cycle) — otherwise the planner
   names the stuck operators and streams and asks for an explicit spec.

2. **Validation with actionable errors**: unproduced streams,
   unconsumed sources, producer/subscriber spec disagreement, updater
   fan-in spec disagreement — caught here with operator/stream names
   instead of surfacing as shape errors inside a tick.

3. **Mapper fusion.**  A linear mapper chain (M1 -> s -> M2 where s has
   exactly one producer and one subscriber, both mappers) costs one
   queue hop and one pipeline tick per link.  The planner rewrites such
   chains into a single :class:`FusedMapper` stage: same event->event
   function, one queue hop, one tick.

Sequential steps keep the JAX package's contract: the user writes
``step(slate_row, ev)`` for one row, and :class:`FnSequentialUpdater`
runs it over all of a tick's key runs at once through
``torch.func.vmap`` (the port's ``SequentialUpdater.step`` is batched).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import torch_dtype
from repro_torch.core.event import (EventBatch, flatten_sorted, format_spec,
                                    is_spec_leaf, spec_matches, spec_of,
                                    tree_map)
from repro_torch.core.operators import (AssociativeUpdater, Mapper, Operator,
                                        SequentialUpdater)
from repro_torch.core.workflow import Workflow


class PlanError(ValueError):
    """Graph construction / validation error (names names)."""


# ----------------------------------------------------------------------
# declarations (recorded by App, consumed here)
# ----------------------------------------------------------------------

@dataclass
class OpDecl:
    kind: str                       # "mapper" | "assoc" | "seq" | "raw"
    name: str
    subscribes: Tuple[str, ...]
    fn: Any = None                  # mapper fn / assoc lift / seq step
    out: Any = None                 # None | str | seq[str] | {name: spec|None}
    slate: Any = None               # updaters: slate value_spec
    merge: Any = "sum"              # assoc: "sum" | "max" | merge(slate, delta)
    combine: Any = None             # assoc: combine(d1, d2); None = merge
    emit: Any = None                # assoc: emit(keys, old, new, ts)
    op: Optional[Operator] = None   # raw: prebuilt Operator instance
    table_capacity: int = 4096
    ttl: int = 0
    max_run: int = 32
    sum_mergeable: Optional[bool] = None


@dataclass
class Plan:
    workflow: Workflow
    stream_specs: Dict[str, Any]
    fused_chains: List[Tuple[str, ...]]   # operator names per fused chain


def out_names(out) -> Tuple[str, ...]:
    """Stream names named by an ``out=`` declaration (may be empty when
    the names are left to tracing)."""
    if out is None:
        return ()
    if isinstance(out, str):
        return (out,)
    return tuple(out)


def _declared_specs(out) -> Dict[str, Any]:
    if isinstance(out, dict):
        return {s: sp for s, sp in out.items() if sp is not None}
    return {}


def _structure(tree):
    """A pytree's structure, comparable across trees (JAX's order)."""
    return flatten_sorted(tree, is_leaf=is_spec_leaf)[1]


# ----------------------------------------------------------------------
# abstract tracing on meta tensors
# ----------------------------------------------------------------------

_TRACE_B = 8   # any static capacity works; specs carry no batch dim


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def abstract_batch(value_spec, capacity: int = _TRACE_B) -> EventBatch:
    """An EventBatch of meta tensors matching ``value_spec`` — the
    tracer input for spec inference."""
    i32 = lambda: _meta((capacity,), torch.int32)
    value = tree_map(lambda s: _meta((capacity,) + tuple(s[0]), s[1]),
                     value_spec, is_leaf=is_spec_leaf)
    return EventBatch(sid=i32(), ts=i32(), key=i32(), value=value,
                      valid=_meta((capacity,), torch.bool))


def _abstract_rows(spec, capacity: Optional[int] = None):
    """Slate pytree of meta tensors; ``capacity=None`` = one row."""
    lead = () if capacity is None else (capacity,)
    return tree_map(lambda s: _meta(lead + tuple(s[0]), s[1]), spec,
                    is_leaf=is_spec_leaf)


def _trace(what: str, name: str, fn: Callable, *args):
    try:
        with torch.device("meta"):
            return fn(*args)
    except Exception as e:
        raise PlanError(
            f"{what} {name!r}: spec inference by tracing failed "
            f"({type(e).__name__}: {e}). The function must be "
            f"torch-traceable on meta tensors (torch ops, no python "
            f"branches on values: no .item(), no bool(tensor)); "
            f"otherwise declare out={{'stream': spec}} explicitly."
        ) from e


def _emission_specs(what: str, name: str, res,
                    declared: Tuple[str, ...]) -> Dict[str, Any]:
    """Traced {stream: EventBatch} -> {stream: value_spec}."""
    if not isinstance(res, dict):
        raise PlanError(f"{what} {name!r} must return a dict of "
                        f"stream -> EventBatch, got {type(res).__name__}")
    for s, b in res.items():
        if not isinstance(b, EventBatch):
            raise PlanError(f"{what} {name!r}: emission into {s!r} is "
                            f"{type(b).__name__}, expected EventBatch")
    if declared and set(res) != set(declared):
        raise PlanError(
            f"{what} {name!r}: declared out streams {sorted(declared)} "
            f"but the traced function emits into {sorted(res)}")
    return {s: spec_of(b.value) for s, b in res.items()}


# ----------------------------------------------------------------------
# function-style operator wrappers
# ----------------------------------------------------------------------

def _tree_add(a, b):
    return tree_map(torch.add, a, b)


def _tree_max(a, b):
    return tree_map(torch.maximum, a, b)


class FnMapper(Mapper):
    """A traced map function as an operator.  The function may return a
    single EventBatch (wrapped into its one declared out stream) or a
    dict of stream -> EventBatch."""

    def __init__(self, fn, name, subscribes, in_spec, out_streams,
                 single_out: Optional[str] = None):
        self.fn = fn
        self.name = name
        self.subscribes = tuple(subscribes)
        self.in_value_spec = in_spec
        self.out_streams = dict(out_streams)
        self._single = single_out

    def map_batch(self, batch):
        out = self.fn(batch)
        if isinstance(out, EventBatch):
            if self._single is None:
                raise TypeError(
                    f"mapper {self.name!r} returned a bare EventBatch "
                    f"but declares streams {sorted(self.out_streams)}")
            out = {self._single: out}
        return out


class FnAssociativeUpdater(AssociativeUpdater):
    """lift/combine/merge/emit functions as an AssociativeUpdater."""

    def __init__(self, name, subscribes, in_spec, slate, lift_fn,
                 combine_fn, merge_fn, emit_fn, out_streams, *,
                 table_capacity, ttl, sum_mergeable, monoid=""):
        self.name = name
        self.subscribes = tuple(subscribes)
        self.in_value_spec = in_spec
        self.out_streams = dict(out_streams)
        self._slate = slate
        self._lift = lift_fn
        self._combine = combine_fn
        self._merge = merge_fn
        self._emit = emit_fn
        self.table_capacity = table_capacity
        self.ttl = ttl
        self.sum_mergeable = sum_mergeable
        self.monoid = monoid

    def slate_spec(self):
        return self._slate

    def lift(self, batch):
        return self._lift(batch)

    def combine(self, a, b):
        return self._combine(a, b)

    def merge(self, slate, delta):
        return self._merge(slate, delta)

    def emit(self, keys, old_slate, new_slate, ts):
        if self._emit is None:
            return {}
        return self._emit(keys, old_slate, new_slate, ts)


class FnSequentialUpdater(SequentialUpdater):
    """A per-event step function for one slate row as a
    SequentialUpdater: :meth:`step` maps it over the rows of all key
    runs with ``torch.func.vmap``.  An emission's ``emit`` flag may be a
    Python bool; it becomes a bool tensor inside the map."""

    def __init__(self, name, subscribes, in_spec, slate, step_fn,
                 out_streams, *, table_capacity, ttl, max_run):
        self.name = name
        self.subscribes = tuple(subscribes)
        self.in_value_spec = in_spec
        self.out_streams = dict(out_streams)
        self._slate = slate
        self._step = step_fn
        self.table_capacity = table_capacity
        self.ttl = ttl
        self.max_run = max_run

    def slate_spec(self):
        return self._slate

    def _row_step(self, slate_row, ev):
        new, emits = self._step(slate_row, ev)
        dev = ev["key"].device
        return new, {s: {**row, "emit": torch.as_tensor(
                         row["emit"], dtype=torch.bool, device=dev)}
                     for s, row in (emits or {}).items()}

    def step(self, slates, ev):
        return torch.func.vmap(self._row_step)(slates, ev)


class FusedMapper(Mapper):
    """A linear mapper chain fused into one operator.

    Applies ``head`` then feeds its ``via``-stream output straight into
    ``tail`` — the same validity masking the engine applies between
    hops, minus the queue round-trip.  Event->event semantics are
    unchanged; the chain now traverses in one tick instead of one per
    link (so downstream table ``ts`` stamps land earlier — relevant
    only to TTL accounting, see DESIGN.md section 11.2).  It carries
    no ``flop_heavy`` tag: :func:`fuse_mappers` never admits such a stage.
    """

    def __init__(self, head: Mapper, tail: Mapper, via: str):
        self.head, self.tail, self.via = head, tail, via
        self.name = f"{head.name}+{tail.name}"
        self.subscribes = tuple(head.subscribes)
        self.in_value_spec = head.in_value_spec
        self.out_streams = {
            **{s: sp for s, sp in head.out_streams.items() if s != via},
            **tail.out_streams}

    def chain(self) -> Tuple[str, ...]:
        h = (self.head.chain() if isinstance(self.head, FusedMapper)
             else (self.head.name,))
        t = (self.tail.chain() if isinstance(self.tail, FusedMapper)
             else (self.tail.name,))
        return h + t

    def map_batch(self, batch):
        outs1 = self.head.map_batch(batch)
        mid = outs1[self.via]
        mid = mid.mask(batch.valid & mid.valid)   # the inter-hop mask
        outs = {s: b for s, b in outs1.items() if s != self.via}
        for s, b in self.tail.map_batch(mid).items():
            outs[s] = b.mask(mid.valid & b.valid)
        return outs


# ----------------------------------------------------------------------
# operator construction (one decl -> one Operator, specs resolved)
# ----------------------------------------------------------------------

def _in_spec(decl: OpDecl, specs: Dict[str, Any]):
    sp = specs[decl.subscribes[0]]
    for s in decl.subscribes[1:]:
        if not spec_matches(sp, specs[s]):
            raise PlanError(
                f"operator {decl.name!r} subscribes to streams with "
                f"disagreeing value specs (one input queue needs one "
                f"spec): {decl.subscribes[0]!r}={format_spec(sp)} vs "
                f"{s!r}={format_spec(specs[s])}")
    return sp


def _build_mapper(decl: OpDecl, in_spec) -> FnMapper:
    names = out_names(decl.out)
    declared = _declared_specs(decl.out)
    if names and set(declared) == set(names):
        out_specs = declared          # fully declared: no tracing needed
    else:
        res = _trace("mapper", decl.name, decl.fn, abstract_batch(in_spec))
        if isinstance(res, EventBatch):
            if len(names) != 1:
                raise PlanError(
                    f"mapper {decl.name!r} returns a single EventBatch; "
                    f"declare its stream with out='name'")
            out_specs = {names[0]: spec_of(res.value)}
        else:
            out_specs = _emission_specs("mapper", decl.name, res, names)
        for s, sp in declared.items():
            if not spec_matches(sp, out_specs[s]):
                raise PlanError(
                    f"mapper {decl.name!r}: declared spec for {s!r} "
                    f"({format_spec(sp)}) does not match the traced "
                    f"output ({format_spec(out_specs[s])})")
    single = names[0] if len(names) == 1 else None
    if single is None and len(out_specs) == 1:
        single = next(iter(out_specs))
    return FnMapper(decl.fn, decl.name, decl.subscribes, in_spec,
                    out_specs, single_out=single)


def _build_assoc(decl: OpDecl, in_spec) -> FnAssociativeUpdater:
    if decl.slate is None:
        raise PlanError(f"updater {decl.name!r} needs slate= (a "
                        f"value_spec pytree for one slate)")
    monoid = ""
    if decl.merge == "sum":
        merge_fn = _tree_add
        combine_fn = decl.combine or _tree_add
        auto_sm = decl.combine is None and decl.emit is None
    elif decl.merge == "max":
        # elementwise-max monoid (non-negative leaves, DESIGN.md 16.2):
        # rides the same fused slate_update path as "sum" when no
        # custom combine/emit is attached
        merge_fn = _tree_max
        combine_fn = decl.combine or _tree_max
        auto_sm = False
        if decl.combine is None and decl.emit is None:
            monoid = "max"
    else:
        merge_fn = decl.merge
        combine_fn = decl.combine or _tree_add
        auto_sm = False
    sum_mergeable = (decl.sum_mergeable if decl.sum_mergeable is not None
                     else auto_sm)

    lift_res = _trace("updater", decl.name, decl.fn,
                      abstract_batch(in_spec))
    slate_rows = _abstract_rows(decl.slate, _TRACE_B)
    if (decl.merge in ("sum", "max")
            and _structure(lift_res) != _structure(slate_rows)):
        raise PlanError(
            f"updater {decl.name!r}: with merge={decl.merge!r} the "
            f"lift() pytree must match slate={format_spec(decl.slate)} "
            f"structurally")

    out_specs = _declared_specs(decl.out)
    names = out_names(decl.out)
    if decl.emit is not None:
        i32 = _meta((_TRACE_B,), torch.int32)
        res = _trace("updater-emit", decl.name, decl.emit,
                     i32, slate_rows, slate_rows, i32)
        out_specs = _emission_specs("updater-emit", decl.name, res,
                                    names)
    elif names:
        missing = [s for s in names if s not in out_specs]
        if missing:
            raise PlanError(
                f"updater {decl.name!r} declares out streams {missing} "
                f"but has no emit= function to trace their specs from; "
                f"pass out={{'stream': spec}}")
    return FnAssociativeUpdater(
        decl.name, decl.subscribes, in_spec, decl.slate, decl.fn,
        combine_fn, merge_fn, decl.emit, out_specs,
        table_capacity=decl.table_capacity, ttl=decl.ttl,
        sum_mergeable=sum_mergeable, monoid=monoid)


def _build_seq(decl: OpDecl, in_spec) -> FnSequentialUpdater:
    if decl.slate is None:
        raise PlanError(f"updater {decl.name!r} needs slate= (a "
                        f"value_spec pytree for one slate)")
    slate_row = _abstract_rows(decl.slate)
    i0 = lambda: _meta((), torch.int32)
    ev = {"sid": i0(), "ts": i0(), "key": i0(),
          "value": _abstract_rows(in_spec)}
    res = _trace("updater", decl.name, decl.fn, slate_row, ev)
    if not (isinstance(res, tuple) and len(res) == 2):
        raise PlanError(
            f"updater {decl.name!r}: step(slate, ev) must return "
            f"(new_slate, emissions)")
    new_slate, emits = res
    if _structure(new_slate) != _structure(slate_row):
        raise PlanError(
            f"updater {decl.name!r}: step() returns a slate pytree "
            f"whose structure does not match "
            f"slate={format_spec(decl.slate)}")
    names = out_names(decl.out)
    out_specs = {}
    for s, row in (emits or {}).items():
        if not (isinstance(row, dict) and "value" in row):
            raise PlanError(
                f"updater {decl.name!r}: emission into {s!r} must be "
                f"{{'key': ..., 'value': ..., 'emit': ...}}")
        out_specs[s] = tree_map(lambda a: (tuple(a.shape), a.dtype),
                                row["value"])
    if names and set(out_specs) != set(names):
        raise PlanError(
            f"updater {decl.name!r}: declared out streams "
            f"{sorted(names)} but step() emits into {sorted(out_specs)}")
    return FnSequentialUpdater(
        decl.name, decl.subscribes, in_spec, decl.slate, decl.fn,
        out_specs, table_capacity=decl.table_capacity, ttl=decl.ttl,
        max_run=decl.max_run)


def _build_raw(decl: OpDecl, in_spec) -> Operator:
    # shallow-copy so wiring one instance into a graph never rewires
    # the caller's object (an ops.* instance may be reused across apps)
    op = copy.copy(decl.op)
    op.name = decl.name
    # decl.subscribes is authoritative: App.add already chose between
    # the explicit wiring and the instance's own declaration
    op.subscribes = decl.subscribes
    existing = getattr(op, "in_value_spec", None)
    if existing:
        if not spec_matches(existing, in_spec):
            raise PlanError(
                f"operator {decl.name!r} declares "
                f"in_value_spec={format_spec(existing)} but its input "
                f"stream carries {format_spec(in_spec)}")
    else:
        op.in_value_spec = in_spec
    # a subclass-API mapper that holds device state (ml's ModelMapper
    # and LMServeMapper, whose parameters live on the card) leaves
    # out_streams to bind(), which writes its spec down
    if isinstance(op, Mapper) and not getattr(op, "out_streams", None) \
            and callable(getattr(op, "bind", None)):
        op.bind(op.in_value_spec)
    return op


def _build_op(decl: OpDecl, specs: Dict[str, Any]) -> Operator:
    in_spec = _in_spec(decl, specs)
    if decl.kind == "mapper":
        return _build_mapper(decl, in_spec)
    if decl.kind == "assoc":
        return _build_assoc(decl, in_spec)
    if decl.kind == "seq":
        return _build_seq(decl, in_spec)
    if decl.kind == "raw":
        return _build_raw(decl, in_spec)
    raise PlanError(f"unknown operator kind {decl.kind!r}")


# ----------------------------------------------------------------------
# mapper fusion
# ----------------------------------------------------------------------

def fuse_mappers(operators: List[Operator], external: set
                 ) -> Tuple[List[Operator], List[Tuple[str, ...]]]:
    """Collapse linear mapper chains into FusedMapper stages.

    A link M1 -s-> M2 fuses iff: both are Mappers, neither is tagged
    ``flop_heavy`` (model-inference stages keep their own queue hop so
    their backpressure stays visible and their latency stays decoupled
    from cheap field maps), s is M1's to-fuse output and M2's *only*
    subscription, s has exactly one producer and exactly one
    subscriber, s is not external, not a self-loop on either operator,
    not part of a cycle back to M1 (fusing a cycle would halve its loop
    latency — only *linear* chains fuse), and fusing would not collide
    two distinct emissions into the same stream name.  Applied to a
    fixpoint, so a 3-link chain becomes one stage.
    """
    ops_list = list(operators)

    def reaches(frm: Operator, to: Operator) -> bool:
        """Is ``to`` reachable from ``frm``'s emissions through the
        stream graph?  (Used to refuse fusing cycle links.)"""
        seen, work = set(), list(frm.out_streams)
        while work:
            s = work.pop()
            if s in seen:
                continue
            seen.add(s)
            for op in ops_list:
                if s in op.subscribes:
                    if op is to:
                        return True
                    work.extend(op.out_streams)
        return False
    changed = True
    while changed:
        changed = False
        for tail in ops_list:
            if not isinstance(tail, Mapper) or len(tail.subscribes) != 1:
                continue
            s = tail.subscribes[0]
            if s in external or s in tail.out_streams:
                continue
            prods = [o for o in ops_list if s in o.out_streams]
            if len(prods) != 1:
                continue
            head = prods[0]
            if head is tail or not isinstance(head, Mapper):
                continue
            if getattr(head, "flop_heavy", False) or \
                    getattr(tail, "flop_heavy", False):
                continue      # FLOP-heavy stage: the queue hop IS the
                #               backpressure/telemetry boundary
            if s in head.subscribes:
                continue
            subs = [o for o in ops_list if s in o.subscribes]
            if subs != [tail]:
                continue
            head_rest = {k for k in head.out_streams if k != s}
            if head_rest & set(tail.out_streams):
                continue          # emission collision: keep unfused
            if reaches(tail, head):
                continue          # cycle link: keep unfused
            idx = ops_list.index(head)
            ops_list[idx] = FusedMapper(head, tail, s)
            ops_list.remove(tail)
            changed = True
            break
    chains = [op.chain() for op in ops_list
              if isinstance(op, FusedMapper)]
    return ops_list, chains


# ----------------------------------------------------------------------
# the planner entry point
# ----------------------------------------------------------------------

def plan(sources: Dict[str, Any], streams: Dict[str, Any],
         decls: Sequence[OpDecl], *, fuse: bool = True) -> Plan:
    """Resolve specs, build operators, validate, fuse, emit a Workflow.

    ``sources``: external stream name -> value_spec.
    ``streams``: forward-declared stream name -> value_spec or None.
    Operator order in the emitted Workflow is declaration order (with
    fused chains taking the head mapper's slot).
    """
    names = [d.name for d in decls]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise PlanError(f"duplicate operator names: {sorted(dup)}")

    specs: Dict[str, Any] = dict(sources)
    for s, sp in streams.items():
        if sp is not None:
            if s in specs and not spec_matches(specs[s], sp):
                raise PlanError(
                    f"stream {s!r} declared with spec {format_spec(sp)} "
                    f"but already carries {format_spec(specs[s])}")
            specs[s] = sp

    built: Dict[int, Operator] = {}
    pending = list(range(len(decls)))
    while pending:
        progress = False
        for i in list(pending):
            decl = decls[i]
            if not all(s in specs for s in decl.subscribes):
                continue
            op = _build_op(decl, specs)
            for s, sp in op.out_streams.items():
                if s in specs:
                    if not spec_matches(specs[s], sp):
                        raise PlanError(
                            f"stream {s!r}: producer {op.name!r} emits "
                            f"{format_spec(sp)} but the stream already "
                            f"carries {format_spec(specs[s])}")
                else:
                    specs[s] = sp
            built[i] = op
            pending.remove(i)
            progress = True
        if not progress:
            stuck = [decls[i].name for i in pending]
            missing = sorted({s for i in pending
                              for s in decls[i].subscribes
                              if s not in specs})
            raise PlanError(
                f"cannot infer value specs for operator(s) {stuck}: "
                f"stream(s) {missing} have no producer with a known "
                f"spec. Declare one explicitly with "
                f"app.stream(name, spec) (required to break "
                f"spec-inference cycles) or add the missing producer.")

    operators: List[Operator] = [built[i] for i in range(len(decls))]

    produced = set(sources)
    for op in operators:
        produced.update(op.out_streams)
    for s in streams:
        if s not in produced:
            raise PlanError(
                f"stream {s!r} is declared but nothing produces it "
                f"(unreachable); add a producer or remove the "
                f"declaration")
    subscribed = {s for op in operators for s in op.subscribes}
    for s in sources:
        if s not in subscribed:
            raise PlanError(
                f"source {s!r} has no subscribers — its events would "
                f"be dropped on arrival; subscribe an operator or "
                f"remove the source")

    fused_chains: List[Tuple[str, ...]] = []
    if fuse:
        operators, fused_chains = fuse_mappers(operators, set(sources))

    wf = Workflow(operators, external_streams=tuple(sources))
    return Plan(workflow=wf, stream_specs=specs,
                fused_chains=fused_chains)
