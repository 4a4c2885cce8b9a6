"""Gated feed-forward sublayer, SwiGLU / GeGLU (port of
``repro.models.layers.ffn``)."""
from __future__ import annotations

import torch

from repro_torch.models import init_utils as iu
from repro_torch.models.context import Ctx
from repro_torch.models.layers.spmd import mm


def _act(name: str):
    if name == "silu":      # jax.nn.silu: x * sigmoid(x)
        return lambda x: x * torch.sigmoid(x)
    if name == "gelu":
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def init(gen, d_model: int, d_ff: int):
    return iu.split_tree({
        "w_gate": iu.dense(gen, (d_model, d_ff), ("fsdp", "tp")),
        "w_in": iu.dense(gen, (d_model, d_ff), ("fsdp", "tp")),
        "w_out": iu.dense(gen, (d_ff, d_model), ("tp", "fsdp"),
                          scale=1.0 / d_ff ** 0.5),
    })


def apply(p, x, ctx: Ctx, *, act: str = "silu"):
    cd = ctx.cdtype
    xc = x.to(cd)
    h = _act(act)(mm(xc, p["w_gate"].to(cd))) * mm(xc, p["w_in"].to(cd))
    h = ctx.constrain(h, ("act_batch", None, "ffn"))
    out = mm(h, p["w_out"].to(cd))
    return ctx.constrain(out, ("act_batch", "act_seq", None))
