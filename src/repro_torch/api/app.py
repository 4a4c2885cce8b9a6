"""Declarative MapUpdate application builder (port of ``repro.api.app``;
DESIGN.md section 11).

The paper's pitch is that MapUpdate lets developers *quickly write*
fast-data apps; this layer is that surface.  An app is declared as a
graph of named streams and function-style operators, compiled by the
planner (spec inference on meta tensors, validation, mapper fusion)
into the exact same :class:`~repro_torch.core.workflow.Workflow` the
subclass API builds, and driven through one front door::

    app = App("quickstart")
    checkins = app.source("checkins", {"retailer": ((), torch.int32)})

    @app.mapper(checkins, out="S2")
    def at_retailer(batch):
        rid = batch.value["retailer"]
        return EventBatch(sid=batch.sid, ts=batch.ts + 1, key=rid,
                          value={"retailer": rid},
                          valid=batch.valid & (rid >= 0))

    at_retailer.update(ops.counter("U1"))
    app.run(source_fn, n_ticks=50,
            runtime=RuntimeConfig(batch_size=512))
    app.read_slate("U1", key)

Cycles are expressed with forward stream references (subscribe to a
stream by name before its producer is declared); the planner resolves
specs at ``build()`` time.  The subclass API keeps working — instances
go in via ``app.add`` / ``stream.update`` and mix freely with
function-style operators.  ``start`` / ``run`` build the engine on
``cuda`` unless the caller passes ``device=``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.api import planner
from repro_torch.api.runtime import RuntimeConfig
from repro_torch.core.engine import Engine, StateHandle
from repro_torch.core.event import format_spec, spec_matches
from repro_torch.core.operators import Operator, Updater
from repro_torch.core.workflow import Workflow


class Stream:
    """Handle to a named stream — the edge currency of the builder."""

    __slots__ = ("app", "name")

    def __init__(self, app: "App", name: str):
        self.app = app
        self.name = name

    def __repr__(self):
        return f"Stream({self.name!r})"

    # fluent sugar: checkins.map(fn).update(ops.counter())
    def map(self, fn: Optional[Callable] = None, *, out=None,
            name: Optional[str] = None):
        if fn is None:
            return lambda f: self.map(f, out=out, name=name)
        return self.app.mapper(self, out=out, name=name)(fn)

    def update(self, updater: Updater, *, name: Optional[str] = None
               ) -> "OpRef":
        """Attach an Updater instance (e.g. ``ops.counter(...)``, or any
        subclass-API updater) to this stream."""
        return self.app.add(updater, subscribes=(self.name,), name=name)

    def updater(self, **kw):
        """Decorator form of :meth:`App.updater` bound to this stream."""
        return self.app.updater(self, **kw)

    def seq_updater(self, **kw):
        """Decorator form of :meth:`App.seq_updater` bound to this
        stream."""
        return self.app.seq_updater(self, **kw)


class OpRef:
    """Handle to a declared operator: its final ``name`` plus access to
    the streams it emits (``.out("S3")``)."""

    __slots__ = ("app", "name")

    def __init__(self, app: "App", name: str):
        self.app = app
        self.name = name

    def __repr__(self):
        return f"OpRef({self.name!r})"

    def out(self, stream_name: str) -> Stream:
        return self.app.stream(stream_name)


class App:
    """A MapUpdate application: declare the graph, then ``run()``."""

    def __init__(self, name: str = "app"):
        self.name = name
        self._sources: Dict[str, Any] = {}
        self._streams: Dict[str, Any] = {}      # forward decls
        self._decls: List[planner.OpDecl] = []
        self._plan: Optional[planner.Plan] = None
        self._plan_fuse: Optional[bool] = None
        self.engine: Optional[Engine] = None
        self.handle: Optional[StateHandle] = None

    # ---- graph declaration ----------------------------------------
    def _mutate(self):
        if self.engine is not None:
            raise RuntimeError(
                f"app {self.name!r} is already running — declare the "
                f"whole graph before start()/run()")
        self._plan = None

    def source(self, name: str, spec) -> Stream:
        """Declare an external stream (fed by ``source_fn``, never
        emitted into by operators)."""
        self._mutate()
        if name in self._sources and not spec_matches(
                self._sources[name], spec):
            raise planner.PlanError(
                f"source {name!r} redeclared with a different spec")
        self._sources[name] = spec
        return Stream(self, name)

    def stream(self, name: str, spec=None) -> Stream:
        """Reference a stream by name — the forward-reference mechanism
        that makes cycles expressible.  ``spec`` is only needed when a
        spec-inference cycle must be broken explicitly."""
        if spec is not None:
            self._mutate()
            known = self._streams.get(name) or self._sources.get(name)
            if known is not None and not spec_matches(known, spec):
                raise planner.PlanError(
                    f"stream {name!r} redeclared with spec "
                    f"{format_spec(spec)}, conflicting with "
                    f"{format_spec(known)}")
            self._streams[name] = spec
        elif name not in self._sources:
            self._streams.setdefault(name, None)
        return Stream(self, name)

    def _subs(self, stream) -> Tuple[str, ...]:
        one = lambda s: s.name if isinstance(s, Stream) else str(s)
        if isinstance(stream, (list, tuple)):
            return tuple(one(s) for s in stream)
        return (one(stream),)

    def _op_name(self, name: Optional[str], fn=None) -> str:
        nm = name or (fn.__name__ if fn is not None else None)
        if not nm:
            raise planner.PlanError("operator needs a name")
        if any(d.name == nm for d in self._decls):
            raise planner.PlanError(
                f"duplicate operator name {nm!r}; pass name= to "
                f"disambiguate")
        return nm

    def _outs_of(self, decl_out, op_name: str):
        names = planner.out_names(decl_out)
        if len(names) == 1:
            return self.stream(names[0])
        if names:
            return tuple(self.stream(n) for n in names)
        return OpRef(self, op_name)

    def mapper(self, stream, *, out=None, name: Optional[str] = None):
        """Decorator: a torch ``fn(EventBatch) -> EventBatch`` (with
        ``out='stream'``) or ``-> {stream: EventBatch}`` that runs on
        meta tensors.  Name, subscription, and output value specs are
        inferred; returns the output Stream(s) for chaining."""
        subs = self._subs(stream)

        def deco(fn):
            self._mutate()
            nm = self._op_name(name, fn)
            self._decls.append(planner.OpDecl(
                kind="mapper", name=nm, subscribes=subs, fn=fn, out=out))
            return self._outs_of(out, nm)
        return deco

    def updater(self, stream, *, slate, merge="sum", combine=None,
                emit=None, out=None, name: Optional[str] = None,
                table_capacity: int = 4096, ttl: int = 0,
                sum_mergeable: Optional[bool] = None):
        """Decorator for an associative updater: the decorated function
        is ``lift(EventBatch) -> delta pytree``; ``merge`` is ``"sum"``
        (elementwise adds — the counter family, auto-``sum_mergeable``),
        ``"max"`` (elementwise max over non-negative leaves) or
        ``merge(slate, delta)``; ``combine(d1, d2)`` defaults to the
        merge's elementwise op; ``emit(keys, old, new, ts)`` makes it a
        producer (output specs traced from it)."""
        subs = self._subs(stream)

        def deco(lift_fn):
            self._mutate()
            nm = self._op_name(name, lift_fn)
            self._decls.append(planner.OpDecl(
                kind="assoc", name=nm, subscribes=subs, fn=lift_fn,
                out=out, slate=slate, merge=merge, combine=combine,
                emit=emit, table_capacity=table_capacity, ttl=ttl,
                sum_mergeable=sum_mergeable))
            return OpRef(self, nm)
        return deco

    def seq_updater(self, stream, *, slate, out=None,
                    name: Optional[str] = None, table_capacity: int = 4096,
                    ttl: int = 0, max_run: int = 32):
        """Decorator for a sequential updater: the decorated function is
        ``step(slate_row, ev) -> (new_slate_row, emissions)`` for one
        slate row, with strict per-key timestamp order (paper's general
        update function); the engine maps it over key runs with
        ``torch.func.vmap``."""
        subs = self._subs(stream)

        def deco(step_fn):
            self._mutate()
            nm = self._op_name(name, step_fn)
            self._decls.append(planner.OpDecl(
                kind="seq", name=nm, subscribes=subs, fn=step_fn,
                out=out, slate=slate, table_capacity=table_capacity,
                ttl=ttl, max_run=max_run))
            return OpRef(self, nm)
        return deco

    def add(self, *operators: Operator, subscribes=None,
            name: Optional[str] = None):
        """Register prebuilt Operator instances (subclass API or
        ``ops.*`` combinators).  ``subscribes`` overrides/wires the
        subscription; ``in_value_spec`` is inferred when the instance
        leaves it empty."""
        if name is not None and len(operators) != 1:
            raise planner.PlanError("name= applies to a single operator")
        refs = []
        for op in operators:
            self._mutate()
            subs = self._subs(subscribes) if subscribes is not None \
                else tuple(getattr(op, "subscribes", ()) or ())
            if not subs:
                raise planner.PlanError(
                    f"operator {getattr(op, 'name', op)!r} has no "
                    f"subscriptions; attach it via stream.update(...) "
                    f"or pass subscribes=")
            nm = self._op_name(name or getattr(op, "name", None))
            self._decls.append(planner.OpDecl(
                kind="raw", name=nm, subscribes=subs, op=op))
            refs.append(OpRef(self, nm))
        return refs[0] if len(refs) == 1 else refs

    # ---- planning ---------------------------------------------------
    def build(self, fuse: bool = True) -> Workflow:
        """Validate the graph and compile it to a Workflow (cached)."""
        if self._plan is None or self._plan_fuse != fuse:
            self._plan = planner.plan(self._sources, self._streams,
                                      self._decls, fuse=fuse)
            self._plan_fuse = fuse
        return self._plan.workflow

    @property
    def plan(self) -> planner.Plan:
        if self._plan is None:
            self.build()
        return self._plan

    # ---- the front door ---------------------------------------------
    def start(self, runtime: Optional[RuntimeConfig] = None, *,
              recover: bool = False, fuse: bool = True,
              device=None) -> StateHandle:
        """Instantiate the engine on ``device`` (default ``cuda``) and
        its initial — or recovered — state.  Idempotent; returns the
        live :class:`StateHandle`.  A distributed runtime (``shards >
        1``, a mesh or a process group) starts ``DistributedEngine``:
        every shard on ``device``, or over a group each rank's block on
        its own ``device``."""
        if self.handle is not None:
            if runtime is not None:
                raise RuntimeError(
                    f"app {self.name!r} already started; runtime config "
                    f"cannot change mid-flight")
            if recover:
                raise RuntimeError(
                    f"app {self.name!r} already started; recovery must "
                    f"be the first start (recover=True on the initial "
                    f"start()/run())")
            return self.handle
        rt = runtime or RuntimeConfig()
        wf = self.build(fuse=fuse)
        if rt.distributed:
            from repro_torch.core.distributed import DistributedEngine
            self.engine = DistributedEngine(wf, rt.make_mesh(),
                                            rt.dist_config(), device=device)
        else:
            self.engine = Engine(wf, rt.engine_config(), device=device)
        state = self.engine.recover() if recover \
            else self.engine.init_state()
        self.handle = StateHandle(self.engine, state)
        return self.handle

    def run(self, source_fn, n_ticks: int, *,
            runtime: Optional[RuntimeConfig] = None, drain=0,
            recover: bool = False, source_offset: int = 0,
            trace_path: Optional[str] = None, device=None, **run_kw):
        """Drive the app for ``n_ticks``:
        ``source_fn(tick, max_events) -> {stream: EventBatch}``, batches
        on the engine's device (``[n_shards, B]``-leading when
        distributed).  ``drain`` runs source-less ticks
        afterwards until the queues are empty (``True`` = up to 64, or
        an int bound).  Returns the list of per-tick output batches; the
        final state lives on ``app.handle`` for
        ``read_slate``/``stats``/``serve``.  ``device`` applies when
        this call starts the engine.

        With ``runtime.autoscale`` set (an
        :class:`~repro_torch.core.distributed.AutoscalePolicy` or a
        ``LoadAutoscaler``, distributed runtimes only), the drive loop
        grows and shrinks the active shard set and rebalances the
        weighted ring mid-run — ``source_fn`` must then size its batches
        by the live ``app.engine.n_shards`` (DESIGN.md section 12).

        ``trace_path`` exports the engine's span trace (Chrome trace
        JSON, Perfetto-loadable) there after the run — needs
        ``TelemetryConfig(trace=True)`` on the runtime (DESIGN.md
        18.3)."""
        h = self.start(runtime, recover=recover, device=device)
        outputs: list = []
        if n_ticks:
            if isinstance(self.engine, Engine):
                h.state, outputs = self.engine.run(
                    h.state, source_fn, n_ticks,
                    source_offset=source_offset, handle=h, **run_kw)
            else:
                if run_kw:
                    raise TypeError(
                        f"run() options {sorted(run_kw)} are not "
                        f"supported on the distributed engine")
                h.state, outputs = self.engine.run(
                    h.state, source_fn, n_ticks,
                    start_tick=source_offset, handle=h)
        if drain:
            max_ticks = 64 if drain is True else int(drain)
            with self.engine.read_lock:
                h.state, _ = self.engine.drain(h.state, max_ticks=max_ticks)
        if trace_path is not None:
            self.export_trace(trace_path)
        return outputs

    # ---- introspection (state threading owned here) -----------------
    def _live(self) -> StateHandle:
        if self.handle is None:
            raise RuntimeError(
                f"app {self.name!r} has no live state yet — call "
                f"start() or run() first")
        return self.handle

    def read_slate(self, updater: str, key: int):
        return self._live().read_slate(updater, key)

    def stats(self) -> Dict[str, Any]:
        return self._live().stats()

    def telemetry(self):
        """The latest windowed :class:`~repro_torch.telemetry.
        TelemetryReport` (chunk-boundary readings: events/tick EMA,
        queue pressure, heavy-hitter keys from the on-device count-min
        sketch).  Needs ``RuntimeConfig(telemetry=TelemetryConfig(...))``
        — or a ``LoadAutoscaler``, which implies it.  If no window has
        been observed yet, one reading is taken now."""
        h = self._live()
        reg = h.engine.telemetry
        if reg is None:
            raise RuntimeError(
                f"app {self.name!r} runs without telemetry — pass "
                f"RuntimeConfig(telemetry=TelemetryConfig()) or an "
                f"autoscale=LoadAutoscaler(...)")
        with self.engine.read_lock:
            return reg.last or reg.observe(h.engine, h.state)

    def export_trace(self, path: str) -> str:
        """Write the engine's span trace to ``path`` as Chrome trace
        JSON (``chrome://tracing`` / Perfetto).  Requires the engine to
        have been started with ``TelemetryConfig(trace=True)``."""
        tracer = self._live().engine.tracer
        if tracer is None:
            raise RuntimeError(
                f"app {self.name!r} runs without tracing — pass "
                f"RuntimeConfig(telemetry=TelemetryConfig(trace=True))")
        return tracer.export(path)

    def serve(self, port: int = 0):
        """Start the HTTP slate server (paper section 4.4) bound to the
        app's live state.  Starts the engine with the default runtime
        (on ``cuda``) if needed; closed by :meth:`close`.  Over the ranks
        of a process group every rank calls it and rank 0 serves
        (``StateHandle.serve``)."""
        if self.handle is None:
            self.start()
        return self.handle.serve(port)

    def close(self):
        """Answer the reads still queued (a last drain on every rank of
        a group), stop the server, close the engine."""
        if self.handle is not None:
            self.handle.close()
        if self.engine is not None:
            self.engine.close()
