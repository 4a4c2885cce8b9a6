"""Logical-axis sharding rules -> mesh placements (port of
``repro.distributed.sharding``).

The model stack annotates parameters with logical tuples ("fsdp", "tp",
None) and activations via ``ctx.constrain(x, ("act_batch", None,
"heads"))``.  This module translates those to a ``DeviceMesh`` with the
JAX package's *divisibility-adaptive* fallback: a dim is sharded over
its rule's axes only when the dim size divides the axis product (e.g.
qwen2's 14 heads vs model=16 -> replicated heads, FSDP still applies).

:func:`to_pspec` gives each tensor dim's mesh axes exactly as the JAX
package's ``PartitionSpec`` entries (``None``, an axis name, or a tuple
of names; trailing ``None`` dropped); :func:`to_placements` turns that
into DTensor placements, one per mesh dim.  A tensor dim over two mesh
axes (``("pod", "data")``) is ``Shard(d)`` on both, in mesh order, which
is JAX's major-to-minor split of the dim.  A mesh dim of one rank is
``Replicate()``: its one shard is the whole dim, and DTensor's view
rules refuse to reshape a size-1 dim sharded that way.  Parameters, batches and
decode states are DTensors on the mesh; ``make_constrainer`` is the
``with_sharding_constraint`` of the port (a ``redistribute``), and
DTensor's sharding propagation plays GSPMD's part between constraints.

The rule functions read only ``axis_names`` / ``mesh_dim_names`` and the
axis sizes, so they also take a duck mesh (``axis_names`` and a
``shape`` mapping each name to its size).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

Rules = Dict[str, Tuple[str, ...]]
PSpec = Tuple[Any, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return int(mesh.size(axis_names(mesh).index(name)))
    return int(mesh.shape[name])


def rules_for(mesh, *, phase: str = "train", long_context: bool = False,
              fsdp_params: bool = True) -> Rules:
    """Sharding rules per phase (the JAX package's, rule for rule).

    KV caches shard their *sequence* dim over "model" in serving phases
    (several archs have fewer kv heads than the model axis); long_500k
    (batch 1) also spreads it over the data axes."""
    names = axis_names(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    if long_context:
        kv_seq = fsdp + tp
    elif phase in ("prefill", "decode"):
        kv_seq = tp
    else:
        kv_seq = ()
    return {
        # params
        "fsdp": fsdp if fsdp_params else (),
        "tp": tp,
        # activations
        "act_batch": fsdp,
        # sequence parallelism of the residual stream between blocks
        "act_seq": tp if phase in ("train", "prefill") else (),
        "heads": tp,
        "kv_heads": tp,
        "ffn": tp,
        "vocab": tp,
        "experts": tp,
        "kv_seq": kv_seq,
    }


def axis_prod(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


# when several dims of one tensor map to the same mesh axis (e.g. a KV
# cache with both kv_heads and kv_seq -> "model"), the higher-priority
# logical name keeps it and the other dim replicates
_PRIORITY = ("kv_heads", "heads", "vocab", "ffn", "experts", "tp",
             "fsdp", "act_batch", "act_seq", "kv_seq")


def to_pspec(logical: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: Rules) -> PSpec:
    """Each dim's mesh axes as JAX ``PartitionSpec`` entries."""
    order = sorted(range(len(logical)),
                   key=lambda i: _PRIORITY.index(logical[i])
                   if logical[i] in _PRIORITY else len(_PRIORITY))
    parts: list = [None] * len(logical)
    used: set = set()
    for i in order:
        name, dim = logical[i], shape[i]
        axes = rules.get(name, ()) if name else ()
        axes = tuple(a for a in axes if a not in used)
        if axes and dim % axis_prod(mesh, axes) == 0:
            parts[i] = axes if len(axes) > 1 else axes[0]
            used.update(axes)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def to_placements(pspec: PSpec, mesh) -> tuple:
    """``Shard(d)`` / ``Replicate()`` for each mesh dim: mesh dim ``a``
    shards tensor dim ``d`` when ``a`` is among ``pspec[d]``'s axes and
    has more than one rank."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{pspec}: dim {d}'s axes are not in mesh "
                             f"order {names}")
        for i, a in zip(idx, axes):
            if axis_size(mesh, a) > 1:
                out[i] = Shard(d)
    return tuple(out)


def placements_for(logical, shape, mesh, rules: Rules) -> tuple:
    return to_placements(to_pspec(logical, shape, mesh, rules), mesh)


def is_spec(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in s)


def tree_map_specs(fn, specs_tree, shapes_tree):
    """``fn(spec, leaf)`` over a tree of logical tuples and the matching
    tree of tensors (dicts, lists, ``None`` kept)."""
    if specs_tree is None:
        return None
    if is_spec(specs_tree):
        return fn(specs_tree, shapes_tree)
    if isinstance(specs_tree, dict):
        return {k: tree_map_specs(fn, v, shapes_tree[k])
                for k, v in specs_tree.items()}
    return type(specs_tree)(tree_map_specs(fn, s, t)
                            for s, t in zip(specs_tree, shapes_tree))


def tree_shardings(specs_tree, shapes_tree, mesh, rules: Rules):
    """specs_tree: logical tuples; shapes_tree: matching tensors -> tree
    of placements (one tuple per leaf, one entry per mesh dim)."""
    return tree_map_specs(
        lambda spec, t: placements_for(spec, t.shape, mesh, rules),
        specs_tree, shapes_tree)


def distribute(x, mesh, placements):
    """``x`` (a whole tensor, the same on every rank) as a DTensor on
    ``mesh``: each rank keeps its shard, no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements,
                             src_data_rank=None)


def whole(t):
    """A DTensor's whole value on every rank (``full_tensor``); any other
    value as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def make_constrainer(mesh, rules: Rules):
    """``ctx.constrain`` for model blocks: a DTensor is redistributed to
    the placements of its logical spec; any other tensor is returned as
    it is."""
    from torch.distributed.tensor import DTensor

    def constrain(x, logical):
        if not isinstance(x, DTensor):
            return x
        pl = placements_for(logical, x.shape, mesh, rules)
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(mesh, pl)
    return constrain


def batch_placements(x, mesh, rules: Rules) -> tuple:
    """Every model input is sharded on its leading (batch) dim."""
    if x.ndim == 0:
        return to_placements((), mesh)
    return placements_for(("act_batch",) + (None,) * (x.ndim - 1), x.shape,
                          mesh, rules)


def batch_shardings(batch_tree, mesh, rules: Rules):
    return {k: batch_placements(v, mesh, rules)
            for k, v in batch_tree.items()}


def state_shardings(model, batch: int, cache_len: int, mesh, rules: Rules):
    """Decode-state placements from the logical specs that
    ``lm.decode_states`` hands each leaf's ``make_leaf``."""
    from repro_torch.models import lm
    return lm.decode_states(
        model, batch, cache_len,
        lambda shp, dtype, logical: placements_for(logical, tuple(shp),
                                                   mesh, rules))


def distribute_model(model, specs, mesh, rules: Rules, *,
                     requires_grad: bool = False):
    """Replace every parameter of ``model`` (an ``lm.Model``, whose
    modules mirror ``specs``) by a DTensor in its spec's placements; each
    rank keeps its shard.  Returns ``model``."""
    from torch import nn

    def walk(mod, spec_tree):
        for k, v in list(mod._parameters.items()):
            pl = placements_for(spec_tree[k], v.shape, mesh, rules)
            mod._parameters[k] = nn.Parameter(
                distribute(v.detach(), mesh, pl), requires_grad=requires_grad)
        for k, sub in mod._modules.items():
            st = spec_tree[int(k)] if isinstance(spec_tree, (list, tuple)) \
                else spec_tree[k]
            if st is not None:
                walk(sub, st)
    walk(model, specs)
    return model


def distribute_tree(tree, placements_tree, mesh):
    """Each tensor of ``tree`` as a DTensor in the matching placements
    (dicts, lists, tuples and ``None`` kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute_tree(v, placements_tree[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_placements(placements_tree):
        return type(tree)(distribute_tree(t, p, mesh)
                          for t, p in zip(tree, placements_tree))
    return distribute(tree, mesh, placements_tree)


def is_placements(p) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(p, tuple) and all(isinstance(e, Placement) for e in p)
