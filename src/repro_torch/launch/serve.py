"""Continuous-batching serving driver — a MapUpdate application (port of
``repro.launch.serve``).

The paper's mapping (DESIGN.md section 3): each request's decode state
(KV caches / SSM states, write position, last token) is a *slate* keyed
by request id; token events flow through the engine; a bounded
admission queue applies Muppet's overflow policies (drop / throttle)
under load; finished requests expire their slate (TTL).  This driver is
the per-shard slot manager on one card.

Tick = (admit up to ``admit_per_tick`` prefills) + (one decode step for
every slot, idle ones included, as in the JAX package: an idle slot's
write index runs on past the cache, and its writes are dropped).
Prefill shapes are bucketed.  The slots' states live on the card and
are written in place; a tick reads the host once for the new tokens and
the write indices together, and an admission once for its first token.

Durability (DESIGN.md section 10 applied to serving): with a
``journal`` path, every accepted request is appended to a
``WriteAheadLog`` before it is served and a completion record is
appended when it finishes, with the JAX package's records, so either
package recovers the other's journal.  After a crash,
``recover_requests`` returns the accepted-but-unfinished requests for
re-submission — at-least-once request processing.

whisper copies the reference's limit: its decoder's cross cache holds
``cache_len`` rows, and a prefill's cross k/v the prompt bucket's, so a
request is admitted only when its bucket is ``cache_len`` (otherwise
``ValueError``, where the JAX engine fails to broadcast one into the
other).  Both packages feed zero memories (``_aux_inputs``).

Runs on ``cuda`` unless ``device="cpu"`` is passed; it never falls back
to the CPU.  With a ``mesh`` (``launch.mesh.make_host_mesh``, of
``device``'s type) the weights and the slots' states are DTensors placed
by ``sharding.tree_shardings`` / ``state_shardings`` under
``rules_for(mesh, phase="decode")``; the steps run on them, and an
admission writes its slot on the rank that holds it.  The tokens and
write indices stay whole on every rank.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.event import EventBatch, flatten_sorted
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cells
from repro_torch.launch.mesh import check_mesh
from repro_torch.models import lm
from repro_torch.slates.wal import WriteAheadLog
from repro_torch.telemetry.metrics import MetricsRegistry, TelemetryConfig


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [P] int32
    max_new: int = 16
    arrived_tick: int = 0
    tokens_out: List[int] = field(default_factory=list)
    done_tick: Optional[int] = None


@dataclass
class ServeConfig:
    n_slots: int = 8             # concurrent decode slots (batch)
    cache_len: int = 256
    prompt_bucket: int = 64      # prefill pad bucket
    admit_per_tick: int = 2
    queue_capacity: int = 64     # admission queue bound (overflow -> shed)
    eos_token: int = -1          # -1 = run to max_new


class ServingEngine:
    def __init__(self, cfg_model, serve_cfg: ServeConfig = None, mesh=None,
                 journal: Optional[str] = None, *, device=None):
        check_mesh(mesh)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = shd.rules_for(mesh, phase="decode") if mesh else None
        self.journal = WriteAheadLog(journal) if journal else None
        self.scfg = serve_cfg or ServeConfig()
        self.model = lm.build(cfg_model)
        self.cfg = cfg_model
        sc = self.scfg

        self._decode = cells.make_decode_step(self.model, mesh=mesh,
                                              rules=self.rules)
        self._prefill = cells.make_prefill_step(
            self.model, cache_len=sc.cache_len, full_logits=True,
            mesh=mesh, rules=self.rules)

        # batched decode state over slots = the slate table
        self.states = cells.concrete_states(self.model, sc.n_slots,
                                            sc.cache_len, device=self.device)
        if mesh is not None:
            self.states = shd.distribute_tree(
                self.states, shd.state_shardings(
                    self.model, sc.n_slots, sc.cache_len, mesh, self.rules),
                mesh)
        self.cur_index = torch.zeros((sc.n_slots,), dtype=torch.int32,
                                     device=self.device)
        self.last_token = torch.zeros((sc.n_slots, 1), dtype=torch.int32,
                                      device=self.device)
        self.active = np.zeros(sc.n_slots, bool)
        self.slot_req: List[Optional[Request]] = [None] * sc.n_slots

        self.queue: deque = deque()
        self.journal_max_rid = -1          # set by recover_requests
        self.shed = 0                      # overflow drops (paper 4.3)
        self.tick = 0
        self.finished: List[Request] = []
        # windowed serving telemetry (the stream engine's registry via
        # its engine-agnostic observe_raw: events = tokens decoded,
        # queue = admission backlog, drops = shed requests)
        self.telemetry = MetricsRegistry(
            TelemetryConfig(window=8), batch_size=self.scfg.n_slots)
        self._tokens_cum = 0

    # ---- admission (the "M0 source mapper") ----
    def submit(self, req: Request, *, journal: bool = True) -> bool:
        if len(self.queue) >= self.scfg.queue_capacity:
            self.shed += 1                 # queue overflow: drop + count
            return False
        if self.journal is not None and journal:
            self.journal.append(req.rid, {"req": EventBatch.of(
                key=np.asarray([req.rid], np.int32),
                value={"prompt": np.asarray(req.prompt, np.int32)[None],
                       "max_new": np.asarray([req.max_new], np.int32)},
                device="cpu")})
        req.arrived_tick = self.tick
        self.queue.append(req)
        return True

    def _journal_done(self, req: Request):
        if self.journal is not None:
            self.journal.append(req.rid, {"done": EventBatch.of(
                key=np.asarray([req.rid], np.int32),
                value={"n_out": np.asarray([len(req.tokens_out)],
                                           np.int32)}, device="cpu")})

    def recover_requests(self) -> List[Request]:
        """Replay the journal: accepted requests with no completion
        record — the work a crashed server owes its clients.  Re-submit
        via ``submit(req, journal=False)`` (already logged) and **check
        the return value**: an overfull admission queue still sheds.
        Also sets ``journal_max_rid`` so new requests can pick rids that
        don't collide with journaled ones (a reused rid would match an
        old completion record and be dropped by the next recovery)."""
        assert self.journal is not None, "no journal configured"
        reqs: Dict[int, Request] = {}
        done = set()
        self.journal_max_rid = -1
        for rid, rec in self.journal.replay():
            self.journal_max_rid = max(self.journal_max_rid, rid)
            if "req" in rec:
                v = rec["req"].value
                reqs[rid] = Request(
                    rid=rid, prompt=np.asarray(v["prompt"][0], np.int32),
                    max_new=int(np.asarray(v["max_new"])[0]))
            if "done" in rec:
                done.add(rid)
        return [r for rid, r in sorted(reqs.items()) if rid not in done]

    def _insert(self, new_states, slot: int, cur_value: int, tok: int):
        """Write one prefill's states into slot ``slot`` of the stacked
        states, in place."""
        for d, s in zip(flatten_sorted(self.states)[0],
                        flatten_sorted(new_states)[0]):
            if d is not None:
                _write_slot(d, s, slot)
        self.cur_index[slot] = cur_value
        self.last_token[slot, 0] = tok

    def _admit(self):
        sc = self.scfg
        admitted = 0
        while (self.queue and admitted < sc.admit_per_tick
               and not self.active.all()):
            req = self.queue.popleft()
            slot = int(np.nonzero(~self.active)[0][0])
            P = len(req.prompt)
            bucket = -(-P // sc.prompt_bucket) * sc.prompt_bucket
            bucket = min(bucket, sc.cache_len)
            if self.cfg.encdec and bucket != sc.cache_len:
                raise ValueError(
                    f"{self.cfg.name}: request {req.rid}'s prompt bucket "
                    f"{bucket} is not cache_len {sc.cache_len}; the "
                    f"decoder's cross cache holds cache_len rows and a "
                    f"prefill's cross k/v the bucket's, so the slot cannot "
                    f"take them (the JAX engine fails the same way)")
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :P] = req.prompt[:bucket]
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            batch.update(self._aux_inputs(1, bucket))
            logits, new_states = self._prefill(lm_params(self), batch)
            # last *real* prompt position; pad rows beyond P sit past the
            # decode frontier (lengths = cur_index+1) and are overwritten
            # as generation advances, so they are never attended.
            tok = int(torch.argmax(shd.whole(logits)[0, min(P, bucket) - 1]))
            self._insert(new_states, slot, min(P, bucket), tok)
            req.tokens_out.append(tok)
            self.active[slot] = True
            self.slot_req[slot] = req
            admitted += 1

    def _aux_inputs(self, b, s):
        out = {}
        if self.cfg.encdec:
            out["enc_frames"] = torch.zeros(
                (b, s, self.cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        if self.cfg.cross_attn_every:
            out["image_embeds"] = torch.zeros(
                (b, self.cfg.n_image_tokens, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        return out

    # ---- one engine tick ----
    def step(self):
        self._admit()
        if self.active.any():
            self._tokens_cum += int(self.active.sum())
            tok, self.states, cur = self._decode(
                lm_params(self), self.last_token, self.states,
                self.cur_index)
            tok, self.cur_index = shd.whole(tok), shd.whole(cur)
            self.last_token = tok
            # one host copy a tick: the new tokens and the write indices
            toks, cur = torch.stack([tok[:, 0], self.cur_index]).cpu().numpy()
            for slot in np.nonzero(self.active)[0]:
                req = self.slot_req[slot]
                req.tokens_out.append(int(toks[slot]))
                hit_eos = (self.scfg.eos_token >= 0
                           and int(toks[slot]) == self.scfg.eos_token)
                out_of_budget = len(req.tokens_out) >= req.max_new
                out_of_cache = int(cur[slot]) >= self.scfg.cache_len - 1
                if hit_eos or out_of_budget or out_of_cache:
                    req.done_tick = self.tick
                    self.finished.append(req)
                    self._journal_done(req)
                    self.active[slot] = False   # slate TTL expiry
                    self.slot_req[slot] = None
        self.tick += 1
        if self.tick % self.telemetry.cfg.window == 0:
            self._observe()

    def run(self, n_ticks: int):
        for _ in range(n_ticks):
            self.step()

    def _observe(self):
        """One window reading: decode throughput vs slot capacity,
        admission backlog, shed requests — the stream engine's
        TelemetryReport shape, from serving counters."""
        self.telemetry.observe_raw(
            tick=self.tick,
            events=np.asarray([self._tokens_cum]),
            queue_depth=np.asarray([len(self.queue)]),
            queue_peak=np.asarray([len(self.queue)]),
            dropped=np.asarray([self.shed]),
            occupancy=np.asarray([int(self.active.sum())]),
            active=[0], shed=np.asarray([self.shed]))

    def status_server(self, port: int = 0):
        """Live HTTP introspection while serving: ``GET /status`` ->
        stats; ``GET /slate/requests/<rid>`` -> that request's token
        stream so far; ``GET /metrics`` -> ``metrics_text``.  Request
        state is keyed by rid exactly like a slate table, so the stream
        engine's :class:`SlateServer` front end serves both engines."""
        from repro_torch.slates.http import SlateServer

        def read_fn(updater: str, rid: int):
            if updater != "requests":
                return None
            # snapshot: the decode loop mutates these on the main
            # thread while HTTP handlers run on server threads
            for r in list(self.finished):
                if r is not None and r.rid == rid:
                    return {"tokens_out": list(r.tokens_out),
                            "done": True}
            for r in list(self.slot_req):
                if r is not None and r.rid == rid:
                    return {"tokens_out": list(r.tokens_out),
                            "done": False}
            for r in list(self.queue):
                if r is not None and r.rid == rid:
                    return {"tokens_out": [], "done": False}
            return None

        return SlateServer(read_fn=read_fn, stats_fn=self.stats,
                           metrics_fn=self.metrics_text, port=port)

    def metrics_text(self) -> str:
        """Prometheus exposition for the serving engine: decode-side
        counters plus the windowed TelemetryReport, the stream engine's
        renderer (DESIGN.md 18.4)."""
        from repro_torch.telemetry.prom import render_prometheus
        stats = {
            "tick": self.tick,
            "processed": {"decode": self._tokens_cum},
            "queue_dropped": {"admission": self.shed},
            "table_occupancy": {"slots": int(self.active.sum())
                                / max(1, self.scfg.n_slots)},
            "finished": len(self.finished),
            "queued": len(self.queue),
        }
        return render_prometheus(stats=stats, report=self.telemetry.last)

    def stats(self) -> Dict[str, Any]:
        lat = [r.done_tick - r.arrived_tick for r in self.finished
               if r.done_tick is not None]
        out = {
            "tick": self.tick,
            "finished": len(self.finished),
            "active": int(self.active.sum()),
            "queued": len(self.queue),
            "shed": self.shed,
            "mean_latency_ticks": float(np.mean(lat)) if lat else None,
            "tokens_generated": int(sum(len(r.tokens_out)
                                        for r in self.finished)),
        }
        if self.telemetry.last is not None:
            # windowed TelemetryReport on /status (DESIGN.md 13.2)
            out["telemetry"] = self.telemetry.last.to_dict()
        return out


def _write_slot(d, s, slot: int):
    """Write prefill state ``s`` [G, 1, ...] into slot ``slot`` of the
    stacked state ``d`` [G, n_slots, ...], in place.  On a mesh each rank
    writes its own shard, and only the rank holding the slot does."""
    if not hasattr(d, "device_mesh"):
        d[:, slot] = s[:, 0].to(d.dtype)
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = d.device_mesh
    # the prefill state in the slots' placements, its one row whole
    pl = tuple(Replicate() if p.is_shard() and p.dim == 1 else p
               for p in d.placements)
    if hasattr(s, "device_mesh"):
        s = s.redistribute(mesh, pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        d.shape, mesh, d.placements)
    lo = offset[1]
    if lo <= slot < lo + shape[1]:
        d.to_local()[:, slot - lo] = s[:, 0].to(d.dtype)


def _place(engine: ServingEngine, model: lm.Model, specs) -> lm.Model:
    if engine.mesh is not None:
        shd.distribute_model(model, specs, engine.mesh, engine.rules)
    return model


def lm_params(engine: ServingEngine) -> lm.Model:
    """The weights ``engine`` serves: drawn at first use from seed 0 on its
    device, in bf16 (``lm.init(..., dtype=bf16)``, bitwise
    ``lm.for_compute`` of the f32 draw, which never exists whole), or
    those :func:`set_lm_params` gave it; on a mesh, DTensors in their
    specs' placements."""
    if getattr(engine, "_params", None) is None:
        gen = torch.Generator(device=engine.device).manual_seed(0)
        model, specs = lm.init(lm.build(engine.cfg), gen,
                               dtype=cells.CDTYPE)
        engine._params = _place(engine, model, specs)
    return engine._params


def set_lm_params(engine: ServingEngine, model: lm.Model) -> lm.Model:
    """Serve ``model``'s weights (e.g. a JAX tree through
    ``convert.lm_params_from_numpy``), cast once to bf16 with
    ``lm.for_compute``; returns the cast model."""
    cast = lm.for_compute(model, cells.CDTYPE)
    engine._params = _place(engine, cast, lm.param_specs(cast)[1]
                            if engine.mesh is not None else None)
    return engine._params


def main(argv=None):
    import argparse
    from repro_torch.configs import reduced_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--journal", default=None,
                    help="request WAL path (durable at-least-once "
                         "admission)")
    ap.add_argument("--recover", action="store_true",
                    help="re-submit journaled unfinished requests "
                         "before accepting new ones")
    ap.add_argument("--status-port", type=int, default=None,
                    help="serve live /status + /slate/requests/<rid> "
                         "over HTTP while decoding (0 = any free port)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    args = ap.parse_args(argv)
    cfg = reduced_config(args.arch)
    eng = ServingEngine(cfg, ServeConfig(n_slots=4, cache_len=128,
                                         prompt_bucket=32),
                        journal=args.journal, device=args.device)
    server = None
    if args.status_port is not None:
        server = eng.status_server(args.status_port)
        print(f"status live at http://127.0.0.1:{server.port}/status")
    rid0 = 0
    if args.recover:
        pending = eng.recover_requests()
        rid0 = eng.journal_max_rid + 1   # never reuse journaled rids
        shed = [r.rid for r in pending if not eng.submit(r, journal=False)]
        print(f"recovered {len(pending)} unfinished request(s)"
              + (f"; SHED {shed} (queue full — resubmit later)"
                 if shed else ""))
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(rid=rid0 + i, prompt=rng.integers(
            0, cfg.vocab_size, size=rng.integers(4, 30)).astype(np.int32),
            max_new=8))
    eng.run(args.ticks)
    print(eng.stats())
    if server is not None:
        server.close()


if __name__ == "__main__":
    main()
