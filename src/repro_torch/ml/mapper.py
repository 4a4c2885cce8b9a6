"""ModelMapper: microbatched model inference as a MapUpdate stage (port
of ``repro.ml.mapper``; DESIGN.md section 16.1).

The paper's mappers are cheap field transforms; real fast-data apps
(Twitter's related-query pipeline, e-commerce ranking) run a *model*
per event.  ``ModelMapper`` is that stage: token events in, embeddings
or class scores out, with the ``models/lm.py`` stack running inside the
tick, in f32 as the JAX package computes it (on the card its attention
takes ``flash_attention``'s f32 ``simt`` route and its norms the
``rmsnorm`` kernel in f32).

- **Param residency.**  The model's parameters are on the mapper's
  device from construction (drawn there, or carried over once by
  ``convert.lm_params_from_numpy``); ticks move no weights.
- **Fixed microbatches.**  The event batch is padded to a multiple of
  ``bucket`` and inference runs over ``[bucket, S]`` microbatches in a
  loop (the JAX package's ``lax.map``), always at that one shape.
  Every per-event output depends only on its own row (attention mixes
  positions *within* a row, never across rows), and the shape never
  changes with the batch, so pad rows leave every other row's bits
  unchanged, on the card too, where cuBLAS picks its algorithm by
  shape.
- **Fusion cost tag.**  ``flop_heavy = True`` tells the planner's
  fusion pass this is not a cheap field map: the stage keeps its own
  queue hop so its backpressure stays visible to telemetry and overflow
  policies (DESIGN.md section 16.3).

Its parameters cannot meet a meta input, so the planner does not trace
it: :meth:`bind` writes the output spec down.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.core.event import EventBatch
from repro_torch.core.operators import Mapper
from repro_torch.models import lm
from repro_torch.models.context import Ctx


class ModelMapper(Mapper):
    """Run a ``models/lm.py`` model over a token field of each event.

    ``mode="embed"`` emits ``{"emb": [D] f32}`` — the masked mean of
    the final hidden states over non-pad positions (token 0 = padding).
    ``mode="classify"`` adds a linear head and emits
    ``{"cls": [] i32, "score": [] f32}`` (argmax class + its logit).
    Fields named in ``keep`` are passed through from the input event.

    ``params`` is an ``lm.Model`` of ``cfg`` on ``device`` (default
    ``cuda``); ``None`` draws one there from ``seed``.  ``head`` is the
    classify head ``[d_model, n_classes]`` (``convert.
    mapper_head_from_numpy`` carries the JAX package's); ``None`` draws
    one from ``seed + 1``.  ``microbatches`` counts the microbatches
    run.
    """

    flop_heavy = True

    def __init__(self, cfg, params=None, *, field: str = "tokens",
                 out: str = "scored", mode: str = "embed",
                 n_classes: int = 0, bucket: int = 8,
                 keep: Sequence[str] = (), name: str = "model_mapper",
                 seed: int = 0, head=None, device=None):
        if mode not in ("embed", "classify"):
            raise ValueError(f"unknown ModelMapper mode {mode!r}")
        if mode == "classify" and n_classes <= 0:
            raise ValueError("mode='classify' needs n_classes > 0")
        dev = resolve_device(device)
        self.cfg = cfg
        self.field = field
        self.out = out
        self.mode = mode
        self.bucket = int(bucket)
        self.keep = tuple(keep)
        self.name = name
        self.subscribes = ()
        self.out_streams = {}
        self.in_value_spec = {}
        self.microbatches = 0
        if params is None:
            params, _ = lm.init(lm.build(cfg), torch.Generator(
                device=dev).manual_seed(seed))
        self.model = params
        self.ctx = Ctx(phase="train", cdtype=torch.float32)
        self._head = None
        if mode == "classify":
            if head is None:
                g = torch.Generator(device=dev).manual_seed(seed + 1)
                head = torch.randn((cfg.d_model, n_classes), generator=g,
                                   device=dev) / cfg.d_model ** 0.5
            if tuple(head.shape) != (cfg.d_model, n_classes):
                raise ValueError(f"head must be [{cfg.d_model}, "
                                 f"{n_classes}], got {tuple(head.shape)}")
            self._head = head.to(device=dev, dtype=torch.float32)

    # ---- inference over one [bucket, S] microbatch ----
    def infer(self, toks):
        """toks [b, S] int32 -> [b, d_model] f32 masked-mean embeddings.
        f32 compute: the stream engine's slates are f32 and the parity
        contract (fused vs generic, pre vs post recovery) is bitwise."""
        ctx = self.ctx.replace(positions=lm._positions(toks.shape,
                                                       toks.device))
        hidden, _, _ = lm.forward(self.model, toks, ctx, remat=False)
        pad_mask = (toks != 0).to(hidden.dtype)             # 0 = pad
        denom = torch.clamp(pad_mask.sum(-1, keepdim=True), min=1.0)
        self.microbatches += 1
        return (hidden * pad_mask[..., None]).sum(dim=1) / denom

    def map_batch(self, batch: EventBatch) -> Dict[str, EventBatch]:
        toks = batch.value[self.field].to(torch.int32)     # [B, S]
        B, S = toks.shape
        nb = -(-B // self.bucket)
        padded = torch.nn.functional.pad(toks, (0, 0, 0, nb * self.bucket - B))
        emb = [self.infer(padded[i * self.bucket:(i + 1) * self.bucket])
               for i in range(nb)]
        emb = (torch.cat(emb) if emb else toks.new_zeros(
            (0, self.cfg.d_model), dtype=torch.float32))[:B]
        if self.mode == "embed":
            value = {"emb": emb}
        else:
            logits = emb @ self._head                      # [B, n_cls]
            value = {"cls": torch.argmax(logits, -1).to(torch.int32),
                     "score": logits.amax(-1)}
        for f in self.keep:
            value[f] = batch.value[f]
        out = EventBatch(sid=batch.sid, ts=batch.ts + 1, key=batch.key,
                         value=value, valid=batch.valid)
        return {self.out: out}

    def bind(self, in_value_spec) -> "ModelMapper":
        """Set the input spec and the output streams.  The output spec
        follows from the config and the mode, so it is written down
        rather than traced (the parameters live on the card, where a
        meta input cannot meet them)."""
        tok = in_value_spec[self.field]
        if len(tok[0]) != 1:
            raise ValueError(f"ModelMapper field {self.field!r} must be "
                             f"[S] tokens, got {tok}")
        if self.mode == "embed":
            spec = {"emb": ((self.cfg.d_model,), torch.float32)}
        else:
            spec = {"cls": ((), torch.int32), "score": ((), torch.float32)}
        for f in self.keep:
            spec[f] = in_value_spec[f]
        self.in_value_spec = in_value_spec
        self.out_streams = {self.out: spec}
        return self
