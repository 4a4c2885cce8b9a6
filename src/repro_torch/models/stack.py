"""Layer stacks (port of ``repro.models.stack``).

A model body is a list of ``Segment``s; each segment repeats a
``pattern`` of blocks over ``n_groups`` groups, with every parameter
stacked on a leading group axis.  The JAX package scans the groups with
``lax.scan``; the port loops over the group axis in Python (eager
PyTorch has nothing to compile), over views of the stacked parameters
(``torch.unbind``, whose backward stacks the groups' gradients in one
write).

Blocks with ``use_extra=True`` read their parameters from the shared
(unstacked) ``params["extra"][name]`` — zamba2's shared attention
block — and hold ``None`` at their pattern position of the stacked
parameters, as in the JAX package; their *state* (KV caches) stays per
group.

The decode contract.  Decode threads the (large, mostly unchanged)
per-layer states the way the JAX package's scan carry does, but in
place: each group's block gets views of its slice of the stacked state
and must write its new state into those views (``attention._write_caches``
writes the new token's k/v, and MLA's latents; ``mamba2.apply`` and the
xLSTM layers ``copy_`` their recurrent states), so no state is copied or
re-emitted.  ``apply_stack``
returns the caller's stacked states, which then hold the new values; a
block that returned new tensors instead would never advance its state.

Remat.  With ``remat`` (the default, as in the JAX package; prefill and
decode pass False) each group of a segment runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
counterpart of ``jax.checkpoint(nothing_saveable)`` around the scan
body: a backward pass keeps only each group's input and runs the group's
forward again to get the rest.  It applies only where autograd records
(``torch.is_grad_enabled()``); decode never remats.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import init_utils as iu
from repro_torch.models.context import Ctx


@dataclass(frozen=True)
class BlockDef:
    name: str
    init: Callable    # gen -> (params, specs)
    apply: Callable   # (params, x, state, ctx) -> (x, state, aux)
    # (batch, cache_len) -> pytree of (shape, dtype, spec)
    state_spec: Optional[Callable] = None
    use_extra: bool = False   # params live in the shared dict


@dataclass(frozen=True)
class Segment:
    pattern: Sequence[BlockDef]
    n_groups: int


@dataclass(frozen=True)
class StackPlan:
    segments: Sequence[Segment]
    extra_blocks: Sequence[BlockDef] = field(default_factory=tuple)

    @property
    def n_layers(self) -> int:
        return sum(len(s.pattern) * s.n_groups for s in self.segments)


def _map(fn, *trees):
    """Map over the leaves of nested dicts of tensors (one structure;
    ``None`` an empty subtree, as in JAX)."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _is_state_leaf(s) -> bool:
    return isinstance(s, tuple) and len(s) == 3 and isinstance(s[0], tuple)


def _map_spec(fn, spec):
    if _is_state_leaf(spec):
        return fn(spec)
    return {k: _map_spec(fn, v) for k, v in spec.items()}


def specs_of(init_fn: Callable):
    """Run ``init_fn`` on the ``meta`` device (no allocation, no draw);
    return (a tree of meta tensors giving shapes and dtypes, specs)."""
    return init_fn(iu.MetaGen())


def init_stack(gen: torch.Generator, plan: StackPlan,
               cast: Callable = lambda tree: tree):
    """Returns (params, specs).  params['segments'][i][j] has leaves with a
    leading n_groups axis (``None`` at a shared block's position);
    params['extra'][name] is unstacked.  Groups, then the extra blocks,
    draw in order from ``gen``; ``cast`` maps each block's parameters as
    soon as they are drawn, and each group is copied into the stacked
    leaves then, so no more than one block's draw exists besides them."""
    params = {"segments": [], "extra": {}}
    specs = {"segments": [], "extra": {}}
    for seg in plan.segments:
        seg_params, seg_specs = [], []
        for blk in seg.pattern:
            if blk.use_extra:
                seg_params.append(None)
                seg_specs.append(None)
                continue
            stacked = sp = None
            for i in range(seg.n_groups):
                p, sp = blk.init(gen)
                p = cast(p)
                if stacked is None:
                    stacked = _map(lambda a: a.new_empty(
                        (seg.n_groups,) + tuple(a.shape)), p)
                _map(lambda dst, a: dst[i].copy_(a), stacked, p)
                del p
            seg_params.append(stacked)
            seg_specs.append(_map(lambda s: (None,) + tuple(s), sp))
        params["segments"].append(seg_params)
        specs["segments"].append(seg_specs)
    for blk in plan.extra_blocks:
        p, specs["extra"][blk.name] = blk.init(gen)
        params["extra"][blk.name] = cast(p)
    return params, specs


def init_states(plan: StackPlan, batch: int, cache_len: int,
                make_leaf: Callable):
    """Build the decode-state pytree.  ``make_leaf(shape, dtype, spec)``
    returns the leaf (e.g. zeros on a device)."""
    out = []
    for seg in plan.segments:
        seg_states = []
        for blk in seg.pattern:
            if blk.state_spec is None:
                seg_states.append(None)
                continue
            spec = blk.state_spec(batch, cache_len)
            seg_states.append(_map_spec(
                lambda s: make_leaf((seg.n_groups,) + tuple(s[0]), s[1],
                                    (None,) + tuple(s[2])), spec))
        out.append(tuple(seg_states))
    return out


def _group(tree, i: int):
    """Group ``i`` of a stacked tree: views, no copies."""
    return _map(lambda a: a[i], tree)


def _groups(tree, n: int):
    """The ``n`` groups of a stacked tree (``None`` kept): views from one
    ``torch.unbind`` a leaf."""
    if tree is None:
        return [None] * n
    per_leaf = _map(lambda a: torch.unbind(a, 0), tree)
    return [_map(lambda g: g[i], per_leaf) for i in range(n)]


def apply_stack(params, plan: StackPlan, x, states, ctx: Ctx, *,
                remat: bool = True):
    """Returns (x, new_states, aux_sum).

    Prefill returns each block's new states stacked on the group axis;
    decode has the blocks update ``states`` in place (the decode
    contract, in the module docstring) and returns it.  ``aux_sum`` adds
    the blocks' auxiliary losses; blocks without one return a Python
    0.0, which launches nothing.  ``remat``: see the module docstring."""
    decode = states is not None and ctx.is_decode
    remat = remat and not decode and torch.is_grad_enabled()
    extra = params["extra"]
    aux_total = 0.0
    new_states_all = []
    for si, seg in enumerate(plan.segments):
        seg_params = [_groups(p, seg.n_groups) for p in params["segments"][si]]
        seg_states = states[si] if states is not None else \
            tuple(None for _ in seg.pattern)
        per_block = [[] for _ in seg.pattern]

        def body(x, aux, i, _seg=seg, _params=seg_params,
                 _states=seg_states):
            sts = []
            for j, blk in enumerate(_seg.pattern):
                pj = extra[blk.name] if blk.use_extra else _params[j][i]
                sj = _group(_states[j], i) \
                    if _states[j] is not None else None
                x, st, a = blk.apply(pj, x, sj, ctx)
                sts.append(st)
                aux = aux + a
            return x, aux, sts

        for i in range(seg.n_groups):
            if remat:
                x, aux_total, sts = checkpoint(body, x, aux_total, i,
                                               use_reentrant=False)
            else:
                x, aux_total, sts = body(x, aux_total, i)
            for j, st in enumerate(sts):
                per_block[j].append(st)
        if decode:
            new_states_all.append(seg_states)
        else:
            new_states_all.append(tuple(
                None if sts[0] is None
                else _map(lambda *xs: torch.stack(xs), *sts)
                for sts in per_block))
    return x, new_states_all, aux_total
