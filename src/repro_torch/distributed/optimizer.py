"""Hand-rolled AdamW with global-norm clipping (port of
``repro.distributed.optimizer``).

Trees are the JAX package's: nested dicts and lists of tensors, ``None``
an empty subtree (zamba2's shared block), leaves taken in JAX's order
(dict keys sorted).  The arithmetic is the JAX package's, in f32, in the
same order.  The port updates in place under ``no_grad``: the
parameters, and ``m`` and ``v``, are written where they lie (the JAX
package returns new arrays), so a step holds no second copy of the
state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple

import torch


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in the JAX package's order: dict keys
    sorted, lists and tuples in order, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [x for t in tree for x in leaves(t)]


def map_tree(fn, tree, *rest):
    """``fn`` over the tensors of a tree (and the matching leaves of
    trees of its structure), the structure kept."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return type(tree)(map_tree(fn, t, *(r[i] for r in rest))
                      for i, t in enumerate(tree))


def init(params) -> OptState:
    # zeros_like keeps a DTensor parameter's mesh and placements
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,
                                       memory_format=torch.contiguous_format)
    dev = leaves(params)[0].device
    return OptState(m=map_tree(zeros, params), v=map_tree(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _schedule(cfg: AdamWConfig, count):
    warm = torch.clamp((count + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def update(params, grads, opt: OptState, cfg: AdamWConfig):
    """Returns (params, new_opt, metrics): ``params`` and the state's
    ``m`` and ``v`` updated in place; ``grads`` a tree like ``params``."""
    count = opt.count + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    lr = _schedule(cfg, opt.count)
    b1c = 1.0 - torch.pow(cfg.b1, count.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, count.to(torch.float32))

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt.m),
                          leaves(opt.v)):
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (step + cfg.weight_decay * pf)
        p.copy_(pf.to(p.dtype))
    return params, OptState(m=opt.m, v=opt.v, count=count), {
        "grad_norm": gnorm, "lr": lr}
