"""LM serving as a MapUpdate application (port of ``repro.ml.serve_app``;
DESIGN.md 16.4).

An admission source feeds request events, a FLOP-heavy mapper runs the
whole request in one tick (one ``lm.prefill`` then ``max_new - 1``
greedy ``lm.decode_step`` calls per microbatch, bf16 compute as in the
JAX package), and a per-request associative slate keeps the generated
tokens.

The request slate merges by elementwise max (``monoid="max"``): exactly
one event per request id ever reaches it and token ids are non-negative
and < vocab < 2**24, so the fused ``slate_update`` path applies.

Requests pad their prompt to a static ``prompt_len``.  In attention
layers pad positions sit behind the causal mask at the last real
position and past the decode frontier afterwards, so they never
influence a generated token there.  A Mamba-2 layer's prefill runs every
position, so a short prompt's pad tokens are folded into its conv and
SSD state and do influence its tokens; the JAX package does the same
(its docstring claims otherwise), and both are compared like with like.

The JAX package's ``lax.map`` over microbatches and ``lax.scan`` over
decode steps are Python loops here that never read the device from the
host: argmax stays on the card, so a tick is enqueued ahead of it like
any other.  ``build_serve_app`` wires the three stages into an ``App``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.app import App
from repro_torch.core.event import EventBatch
from repro_torch.core.operators import AssociativeUpdater, Mapper
from repro_torch.models import lm
from repro_torch.models.context import Ctx


class LMServeMapper(Mapper):
    """prefill + greedy decode for a whole request inside one tick.

    Consumes ``{"prompt": [S] i32 (0-padded), "len": [] i32}`` events
    keyed by request id; emits ``{"tokens": [max_new] i32}`` onto
    ``out``, ``bucket`` requests per microbatch.  ``model`` is an
    initialised ``lm.Model`` (its device is where the mapper runs); its
    weights are cast to bf16 once here (norm scales stay f32), which
    gives the values the JAX package casts at every use.
    ``microbatches`` counts the microbatches run."""

    flop_heavy = True

    def __init__(self, cfg, model: lm.Model, *, max_new: int = 16,
                 cache_len: int = 128, bucket: int = 4,
                 out: str = "generated", name: str = "lm_generate"):
        self.cfg = cfg
        self.ctx = Ctx(cdtype=torch.bfloat16)
        self.model = lm.for_compute(model, self.ctx.cdtype)
        self.max_new = int(max_new)
        self.cache_len = int(cache_len)
        self.bucket = int(bucket)
        self.out = out
        self.name = name
        self.subscribes = ()
        self.out_streams = {}
        self.in_value_spec = {}
        self.microbatches = 0

    def generate(self, toks, length):
        """One microbatch: toks [b, S] int32, length [b] int32 ->
        [b, max_new] int32 greedy tokens."""
        b, S = toks.shape
        if S + self.max_new - 1 > self.cache_len:
            raise ValueError(f"prompt_len {S} + max_new {self.max_new} - 1 "
                             f"exceeds cache_len {self.cache_len}")
        logits, states = lm.prefill(self.model, {"tokens": toks}, self.ctx,
                                    self.cache_len, full_logits=True)
        rows = torch.arange(b, device=toks.device)
        last = torch.clamp(length - 1, 0, S - 1).to(torch.int64)
        tok = torch.argmax(logits[rows, last], -1).to(torch.int32)
        cur = torch.clamp(length, 1, S).to(torch.int32)
        out = [tok]
        for _ in range(self.max_new - 1):
            lg, states = lm.decode_step(self.model, tok[:, None], states,
                                        cur, self.ctx)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
            out.append(tok)
            cur = cur + 1
        self.microbatches += 1
        return torch.stack(out, 1)                       # [b, max_new]

    def map_batch(self, batch: EventBatch) -> Dict[str, EventBatch]:
        toks = batch.value["prompt"].to(torch.int32)     # [B, S]
        length = batch.value["len"].to(torch.int32)      # [B]
        B, S = toks.shape
        nb = -(-B // self.bucket)
        pad = nb * self.bucket - B
        toks = torch.nn.functional.pad(toks, (0, 0, 0, pad))
        length = torch.nn.functional.pad(length, (0, pad))
        gen = [self.generate(toks[i * self.bucket:(i + 1) * self.bucket],
                             length[i * self.bucket:(i + 1) * self.bucket])
               for i in range(nb)]
        gen = torch.cat(gen) if gen else toks.new_zeros((0, self.max_new))
        out = EventBatch(sid=batch.sid, ts=batch.ts + 1, key=batch.key,
                         value={"tokens": gen[:B]}, valid=batch.valid)
        return {self.out: out}

    def bind(self, in_value_spec) -> "LMServeMapper":
        """Set the input spec and the output streams.  The output spec
        follows from the mapper's shapes (``map_batch`` always emits
        ``[max_new]`` int32 tokens), so it is written down rather than
        traced, which would run the model."""
        prompt, length = in_value_spec["prompt"], in_value_spec["len"]
        if len(prompt[0]) != 1 or tuple(length[0]) != ():
            raise ValueError(f"LMServeMapper takes prompt [S] and len [], "
                             f"got {in_value_spec}")
        self.in_value_spec = in_value_spec
        self.out_streams = {self.out: {
            "tokens": ((self.max_new,), torch.int32)}}
        return self


class RequestSlate(AssociativeUpdater):
    """One slate per request id: the generated token block.

    Elementwise-max mergeable (one event per rid, non-negative token
    ids < 2**24): rides the fused path."""

    monoid = "max"

    def __init__(self, name: str = "requests", *, max_new: int,
                 table_capacity: int = 4096, ttl: int = 0):
        self.name = name
        self.max_new = int(max_new)
        self.table_capacity = table_capacity
        self.ttl = ttl
        self.subscribes = ()
        self.out_streams = {}
        self.in_value_spec = {"tokens": ((self.max_new,), torch.int32)}

    def slate_spec(self):
        return {"tokens": ((self.max_new,), torch.int32),
                "n": ((), torch.int32)}

    def lift(self, batch):
        toks = batch.value["tokens"].to(torch.int32)
        return {"tokens": toks,
                "n": torch.full(toks.shape[:1], self.max_new,
                                dtype=torch.int32, device=toks.device)}

    def combine(self, a, b):
        return {k: torch.maximum(a[k], b[k]) for k in a}

    merge = combine


def build_serve_app(cfg, model: lm.Model, *, prompt_len: int = 32,
                    max_new: int = 16, cache_len: int = 128,
                    bucket: int = 4, name: str = "serve_lm",
                    table_capacity: int = 4096) -> App:
    """requests source -> LMServeMapper -> per-request slate, as an App.

    ``model`` is an initialised ``lm.Model`` (the JAX package's
    ``params`` may be None; the port's weights come from ``lm.init`` or
    ``convert.lm_params_from_numpy``).  Drive with
    :func:`request_source` and ``App.run`` on the model's device; read
    results via ``app.read_slate("requests", rid)`` (or the HTTP slate
    server)."""
    app = App(name)
    app.source("requests", {"prompt": ((prompt_len,), torch.int32),
                            "len": ((), torch.int32)})
    app.add(LMServeMapper(cfg, model, max_new=max_new,
                          cache_len=cache_len, bucket=bucket),
            subscribes=("requests",))
    app.stream("generated").update(RequestSlate(
        "requests", max_new=max_new, table_capacity=table_capacity))
    return app


def request_source(requests: Sequence, *, prompt_len: int, capacity: int,
                   per_tick: int = 2, device=None):
    """Admission source: feeds up to ``per_tick`` queued requests per tick
    (respecting the engine's ingest limit — unconsumed requests wait).
    ``requests`` is any sequence with ``.rid`` / ``.prompt`` attributes.
    Batches are made on ``device`` (default ``cuda``)."""
    pending: List = list(requests)
    cursor = [0]

    def source_fn(tick, max_events: Optional[int]):
        n = per_tick if not max_events else min(per_tick, int(max_events))
        take = pending[cursor[0]:cursor[0] + n]
        cursor[0] += len(take)
        prompts = np.zeros((capacity, prompt_len), np.int32)
        lens = np.zeros((capacity,), np.int32)
        keys = np.zeros((capacity,), np.int32)
        valid = np.zeros((capacity,), bool)
        for i, r in enumerate(take):
            p = np.asarray(r.prompt, np.int32)[:prompt_len]
            prompts[i, :p.shape[0]] = p
            lens[i] = p.shape[0]
            keys[i] = r.rid
            valid[i] = True
        return {"requests": EventBatch.of(
            key=keys, value={"prompt": prompts, "len": lens},
            ts=np.full(capacity, tick, np.int32), valid=valid,
            device=device)}

    return source_fn
