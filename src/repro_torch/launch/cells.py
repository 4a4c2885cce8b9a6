"""Decode states and the train / prefill / decode step functions (the
one-card half of ``repro.launch.cells``).

The JAX module also builds (architecture x input shape x mesh) cells of
abstract inputs for the dry run and the roofline: ``Cell``,
``build_cell``, ``lower_cell`` and the ``abstract_*`` helpers wait for
the multi-card slice (ROADMAP queue 1 item 16b), with ``launch/mesh.py``
and ``distributed/sharding.py``, and so do the ``mesh`` / ``rules``
parameters of the functions here.

A step's ``params`` is an ``lm.Model`` holding the weights (the port's
model carries its parameters; ``launch.serve.lm_params`` gives the
serving engine's).  Compute is bf16, as in the JAX steps.  The decode
step updates ``states`` in place (``models/stack.py``'s decode
contract) and returns it; the train step updates the parameters and the
optimizer state in place (``distributed/optimizer.py``).
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.distributed import optimizer as adamw
from repro_torch.models import lm
from repro_torch.models.context import Ctx

CDTYPE = torch.bfloat16


def concrete_states(model, batch: int, cache_len: int, *, device=None):
    """Zero-initialized decode caches on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return lm.decode_states(
        model, batch, cache_len,
        lambda shp, dtype, logical: torch.zeros(tuple(shp), dtype=dtype,
                                                device=dev))


def make_train_step(model, opt_cfg: adamw.AdamWConfig = None):
    """(params, opt, batch) -> (params, opt, metrics): the loss and its
    gradients at bf16 compute (the parameters need ``requires_grad``),
    then one AdamW update; ``metrics`` holds ``loss``, ``grad_norm`` and
    ``lr``.  A parameter no path reaches gets a zero gradient, as JAX's
    ``value_and_grad`` gives it."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ctx = Ctx(cdtype=CDTYPE)

    def train_step(params, opt, batch):
        loss = lm.train_loss(params, batch, ctx)
        tree = params.tree()
        leaves = adamw.leaves(tree)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)}
        del grads
        _, opt, metrics = adamw.update(
            tree, adamw.map_tree(lambda p: by_id[id(p)], tree), opt, opt_cfg)
        metrics["loss"] = loss.detach()
        return params, opt, metrics

    return train_step


def make_prefill_step(model, cache_len: int = 0, full_logits: bool = False):
    ctx = Ctx(cdtype=CDTYPE)

    def prefill_step(params, batch):
        return lm.prefill(params, batch, ctx, cache_len,
                          full_logits=full_logits)

    return prefill_step


def make_decode_step(model):
    ctx = Ctx(cdtype=CDTYPE)

    def decode_step(params, token, states, cur_index):
        """-> (argmax token [B,1] int32, states, cur_index + 1)."""
        logits, new_states = lm.decode_step(params, token, states,
                                            cur_index, ctx)
        next_token = torch.argmax(logits[:, -1], -1).to(torch.int32)
        return next_token[:, None], new_states, cur_index + 1

    return decode_step
