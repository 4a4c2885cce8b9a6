"""Model-level API: init / forward / loss / prefill / decode (port of
``repro.models.lm``).

``Model`` is an ``nn.Module`` whose submodules mirror the JAX package's
parameter tree leaf for leaf (``embed``, ``body.segments[i][j].<block
params>`` stacked on a leading group axis, ``final_norm``, ``head`` when
untied, whisper's ``enc_body`` and ``enc_norm``), so
``repro_torch.convert`` carries weights across by name.  The phase
functions are plain functions over it with the JAX signatures minus
``params``.  Parameters are registered without gradients (serving);
a trainer sets ``requires_grad_(True)`` on its own model
(``launch/train.py``).  Training never uses :func:`for_compute`, which
makes new parameters and so cuts the graph: the layers cast each weight
at its use, as the JAX package does, and those casts are differentiable.

The language-model head uses a sequence-chunked cross-entropy
(:func:`lm_loss`: each chunk under ``torch.utils.checkpoint``), so the
``[B, S, V]`` logits never exist whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._local import split_dims
from repro_torch.models import init_utils as iu
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.context import Ctx
from repro_torch.models.layers import norms
from repro_torch.models.layers.spmd import mm, pad_seq
from repro_torch.models.stack import (StackPlan, apply_stack, init_stack,
                                      init_states, specs_of)


# parameters the JAX layers read in f32 whatever the compute dtype: the
# norm scales, Mamba-2's decay rate and time-step bias, the MoE router
# and the mLSTM gate bias
F32_PARAMS = frozenset({"scale", "a_log", "dt_bias", "router", "gate_bias"})


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters (no gradients) and
    submodules; ``tree()`` gives the dict back."""

    def __init__(self, tree: Optional[dict] = None):
        super().__init__()
        for k, v in (tree or {}).items():
            self.set(k, v)

    def set(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            self.register_parameter(
                name, nn.Parameter(value, requires_grad=False))
        elif isinstance(value, dict):
            self.add_module(name, ParamTree(value))
        elif isinstance(value, (list, tuple)):
            self.add_module(name, ParamList(value))
        else:
            raise TypeError(f"parameter {name!r}: {type(value)}")

    def tree(self) -> dict:
        out: Dict[str, Any] = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


class NoParams(nn.Module):
    """The ``None`` a shared block leaves at its pattern position."""

    def tree(self) -> None:
        return None


class ParamList(nn.ModuleList):
    """A list of parameter trees (the stack's segments and patterns);
    ``None`` entries are kept."""

    def __init__(self, items):
        super().__init__([NoParams() if x is None
                          else ParamList(x) if isinstance(x, (list, tuple))
                          else ParamTree(x) for x in items])

    def tree(self) -> list:
        return [m.tree() for m in self]


class Model(ParamTree):
    """The config, its stack plan(s), and the parameters (set by
    :func:`init` or ``convert.lm_params_from_numpy``)."""

    def __init__(self, cfg: ModelConfig, plan: StackPlan,
                 enc_plan: Optional[StackPlan] = None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.enc_plan = enc_plan

    def load_tree(self, params: dict) -> "Model":
        """Set every parameter from a JAX-shaped tree of tensors."""
        for k, v in params.items():
            self.set(k, v)
        return self


def build(cfg: ModelConfig) -> Model:
    return Model(cfg, transformer.build_plan(cfg),
                 transformer.build_encoder_plan(cfg))


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init(model: Model, gen: torch.Generator,
         dtype: Optional[torch.dtype] = None) -> Tuple[Model, dict]:
    """Random parameters drawn from ``gen``, on its device.  Returns
    ``(model, specs)`` with ``specs`` the JAX package's logical partition
    tree.  With ``dtype``, every tensor is drawn in f32 as without it and
    cast to ``dtype`` as soon as its block is drawn (``F32_PARAMS`` stay
    f32): the values equal ``for_compute(init(model, gen), dtype)``, and
    the f32 copy never exists whole (at most one block of it does)."""
    params, specs = _init_tree(model, gen, dtype)
    return model.load_tree(params), specs


def _init_tree(model: Model, gen, dtype: Optional[torch.dtype] = None):
    """:func:`init`'s (params, specs) trees, loaded into nothing."""
    cfg = model.cfg
    cast = lambda t: t if dtype is None else _cast_tree(t, dtype)
    one = lambda t: t if dtype is None else t.to(dtype)
    embed, embed_spec = iu.dense(gen, (cfg.vocab_size, cfg.d_model),
                                 ("tp", "fsdp"), scale=0.02)
    embed = one(embed)
    body, body_specs = init_stack(gen, model.plan, cast=cast)
    fn, fns = norms.init(gen, cfg.d_model,
                         scale_offset=cfg.norm_scale_offset)
    params = {"embed": embed, "body": body, "final_norm": fn}
    specs = {"embed": embed_spec, "body": body_specs, "final_norm": fns}
    if not cfg.tie_embeddings:
        head, specs["head"] = iu.dense(
            gen, (cfg.d_model, cfg.vocab_size), ("fsdp", "tp"), scale=0.02)
        params["head"] = one(head)
    if model.enc_plan is not None:
        params["enc_body"], specs["enc_body"] = init_stack(
            gen, model.enc_plan, cast=cast)
        params["enc_norm"], specs["enc_norm"] = norms.init(gen, cfg.d_model)
    return params, specs


def param_specs(model: Model):
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    allocation) and its specs, without touching ``model``."""
    return specs_of(lambda gen: _init_tree(model, gen))


def _cast_tree(tree, cdtype: torch.dtype):
    """Every tensor of a parameter tree cast to ``cdtype``, those in
    ``F32_PARAMS`` kept f32; ``None`` and lists kept."""
    if tree is None:
        return None
    if isinstance(tree, list):
        return [_cast_tree(x, cdtype) for x in tree]
    return {k: (_cast_tree(v, cdtype) if not isinstance(v, torch.Tensor)
                else v if k in F32_PARAMS else v.to(cdtype))
            for k, v in tree.items()}


def for_compute(model: Model, cdtype: torch.dtype) -> Model:
    """The same model with every weight cast to ``cdtype`` once, those in
    ``F32_PARAMS`` kept f32.  The JAX package casts weights to the
    compute dtype at every use and reads those few in f32; casting once
    gives the same values, and the layers' casts become no-ops."""
    out = Model(model.cfg, model.plan, model.enc_plan)
    return out.load_tree(_cast_tree(model.tree(), cdtype))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _embed(model: Model, tokens, ctx: Ctx):
    cfg = model.cfg
    ids = tokens.to(torch.int64)
    if split_dims(model.embed):
        # a table split across ranks: DTensor's embedding rule (its
        # vocab-parallel lookup); indexing's backward rule fails there
        # in some torch releases (2.11)
        x = torch.nn.functional.embedding(ids, model.embed).to(ctx.cdtype)
    else:
        x = model.embed[ids].to(ctx.cdtype)
    if cfg.embed_scale:
        # the scale rounded to the compute dtype first, as in JAX
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=ctx.cdtype))
    return ctx.constrain(x, ("act_batch", "act_seq", None))


def encode(model: Model, enc_frames, ctx: Ctx):
    """whisper's encoder over precomputed (stub) frame embeddings
    ``[B, S_enc, D]``: bidirectional blocks at phase "train" (no state),
    then the encoder norm."""
    x = enc_frames.to(ctx.cdtype)
    ectx = ctx.replace(phase="train",
                       positions=_positions(enc_frames.shape[:2],
                                            enc_frames.device))
    x, _, _ = apply_stack(model.enc_body.tree(), model.enc_plan, x, None,
                          ectx, remat=(ctx.phase == "train"))
    return norms.apply(model.enc_norm.tree(), x, eps=model.cfg.norm_eps)


def _positions(bs, device):
    b, s = bs
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def forward(model: Model, tokens, ctx: Ctx, states=None, *,
            remat: bool = True):
    """tokens [B,S] -> (hidden [B,S,D], new_states, aux)."""
    x = _embed(model, tokens, ctx)
    x, new_states, aux = apply_stack(model.body.tree(), model.plan, x,
                                     states, ctx, remat=remat)
    x = norms.apply(model.final_norm.tree(), x, eps=model.cfg.norm_eps,
                    scale_offset=model.cfg.norm_scale_offset)
    return x, new_states, aux


def _unembed_matrix(model: Model):
    if model.cfg.tie_embeddings:
        return model.embed.T  # [D, V]
    return model.head


def logits_for(model: Model, hidden, ctx: Ctx):
    w = _unembed_matrix(model).to(ctx.cdtype)
    return ctx.constrain(mm(hidden.to(ctx.cdtype), w),
                         ("act_batch", None, "tp"))


# --------------------------------------------------------------------------
# loss (chunked cross-entropy)
# --------------------------------------------------------------------------

def _chunk_nll(h, y, w, cdtype, constrain):
    """One chunk's summed NLL and its unmasked token count, in f32."""
    lg = constrain(mm(h.to(cdtype), w), ("act_batch", None, "tp"))
    lg = lg.to(torch.float32)
    lz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, y.clamp(min=0)[..., None].to(torch.int64))
    # subtract before dropping the gathered dim: on a vocab-sharded
    # DTensor the gather is a masked partial sum, which DTensor reduces
    # only at the gather's own rank
    nll = (lz[..., None] - gold)[..., 0]
    mask = (y >= 0).to(torch.float32)
    return (nll * mask).sum(), mask.sum()


def lm_loss(model: Model, hidden, labels, ctx: Ctx, *, chunk: int = 512):
    """Mean next-token NLL.  hidden [B,S,D], labels [B,S] (already
    shifted; label -100 = masked).  The sequence is padded to a multiple
    of ``chunk`` (label -100) and each chunk's logits are made, reduced
    and, under autograd, made again in the backward pass
    (``checkpoint``), as the JAX package's ``lax.scan`` of
    ``jax.checkpoint`` does; the sums run over the chunks in order."""
    B, S, D = hidden.shape
    w = _unembed_matrix(model).to(ctx.cdtype)
    pad = (-S) % chunk
    if pad:
        hidden = pad_seq(hidden, 0, pad)
        labels = pad_seq(labels, 0, pad, value=-100)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S + pad, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            nll, n = checkpoint(_chunk_nll, h, y, w, ctx.cdtype,
                                ctx.constrain,
                                use_reentrant=False)
        else:
            nll, n = _chunk_nll(h, y, w, ctx.cdtype, ctx.constrain)
        loss_sum = loss_sum + nll
        n_tok = n_tok + n
    return loss_sum / torch.clamp(n_tok, min=1.0)


# --------------------------------------------------------------------------
# phase entry points
# --------------------------------------------------------------------------

def train_loss(model: Model, batch: Dict[str, Any], ctx: Ctx):
    """batch: tokens/labels [B,S] (+ whisper's ``enc_frames``
    [B,S_enc,D], the vision model's ``image_embeds`` [B,n_img,D]) -> the
    mean NLL plus the blocks' auxiliary losses; the stack (and whisper's
    encoder) under remat."""
    tokens = batch["tokens"]
    ctx = ctx.replace(phase="train",
                      positions=_positions(tokens.shape, tokens.device))
    if model.enc_plan is not None:
        ctx = ctx.replace(enc_memory=encode(model, batch["enc_frames"], ctx))
    if model.cfg.cross_attn_every:
        ctx = ctx.replace(image_embeds=batch["image_embeds"].to(ctx.cdtype))
    hidden, _, aux = forward(model, tokens, ctx, remat=True)
    return lm_loss(model, hidden, batch["labels"], ctx) + aux


def prefill(model: Model, batch: Dict[str, Any], ctx: Ctx, cache_len: int,
            *, full_logits: bool = False):
    """batch["tokens"] [B,S] (+ whisper's ``enc_frames`` [B,S_enc,D], the
    vision model's ``image_embeds`` [B,n_img,D]) -> (logits [B,S or
    1,V], states: self-attention caches padded to ``cache_len``, cross
    caches the memory's length)."""
    tokens = batch["tokens"]
    ctx = ctx.replace(phase="prefill",
                      positions=_positions(tokens.shape, tokens.device),
                      cache_len=cache_len)
    if model.enc_plan is not None:
        ctx = ctx.replace(enc_memory=encode(model, batch["enc_frames"], ctx))
    if model.cfg.cross_attn_every:
        ctx = ctx.replace(image_embeds=batch["image_embeds"].to(ctx.cdtype))
    hidden, states, _ = forward(model, tokens, ctx, remat=False)
    sel = hidden if full_logits else hidden[:, -1:]
    return logits_for(model, sel, ctx), states


def decode_step(model: Model, token, states, cur_index, ctx: Ctx):
    """token [B,1]; cur_index [B] (write position; a write past the cache
    is dropped, as in JAX).  Returns (logits [B,1,V], states) — the
    caches in ``states`` are updated in place and returned; cross caches
    are read, never written."""
    ctx = ctx.replace(phase="decode", positions=cur_index[:, None],
                      cur_index=cur_index,
                      cache_len=_states_cache_len(states))
    hidden, new_states, _ = forward(model, token, ctx, states, remat=False)
    return logits_for(model, hidden, ctx), new_states


def _states_cache_len(states) -> int:
    def leaves(t):
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)

    for lf in leaves(states):
        if lf.ndim >= 3:
            return int(lf.shape[2])
    return 0


def decode_states(model: Model, batch: int, cache_len: int, make_leaf):
    return init_states(model.plan, batch, cache_len, make_leaf)


# --------------------------------------------------------------------------
# abstract inputs per (arch x shape)
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Every model input of the cell as a ``meta`` tensor (its shape and
    dtype, no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    sds = lambda sh, dt: torch.empty(sh, dtype=dt, device="meta")
    if shape.phase in ("train", "prefill"):
        out = {"tokens": sds((B, S), torch.int32)}
        if shape.phase == "train":
            out["labels"] = sds((B, S), torch.int32)
        if cfg.encdec:
            out["enc_frames"] = sds((B, S, cfg.d_model), torch.bfloat16)
        if cfg.cross_attn_every:
            out["image_embeds"] = sds((B, cfg.n_image_tokens, cfg.d_model),
                                      torch.bfloat16)
        return out
    # decode: one new token against a cache of S
    return {"token": sds((B, 1), torch.int32),
            "cur_index": sds((B,), torch.int32)}
