"""Per-rank cost of one step, counted while it runs (the counterpart of
``repro.analysis.hlo``).

The JAX package walks the compiled, partitioned HLO of a step.  PyTorch
has no HLO: this module runs the step once, eagerly, on ``meta``
DTensors (no data, no allocation; the production meshes in a ``fake``
world, ``launch/mesh.py``) inside a dispatch mode that sees every op,
and counts for the rank the process plays:

  - ``flops``: matmul-type FLOPs (``torch.utils.flop_counter``'s
    formulas: ``mm``, ``bmm``, ``addmm``, convolutions, fused attention),
    as the walker counts dots and convolutions only.  A DTensor op's
    formula sees the global shapes, so its count is scaled by the local
    share of its output and divided by the sizes of the mesh dims on
    which the output is ``Partial`` (a sharded contraction): exactly the
    local op's count.  Ops on plain tensors (inside ``local_map``-style
    regions, the MoE's expert-parallel path) count as they are.  Loops
    run every iteration, so there are no trip counts to recover.
  - ``hbm_bytes``: the operand and output bytes of every eager op that
    is not a view, on the local shards.  Eager PyTorch launches every op
    on its own, so this is more than XLA's count, which charges only the
    boundaries of fused regions.
  - ``collective_bytes`` by the walker's five kinds: each DTensor
    redistribution (explicit ``redistribute`` / ``constrain``, and those
    DTensor's sharding propagation inserts before an op) is counted by its
    placements' transition on each mesh dim -- shard to shard is an
    all-to-all, shard to replicate an all-gather, partial to replicate an
    all-reduce, partial to shard a reduce-scatter -- never by the
    collective a backend happens to run (the ``fake`` group runs an
    all-to-all as all-gather and chunk).  Explicit functional
    collectives on local tensors (the MoE's ``all_to_all_single`` and
    weight ``all_gather``, and their backwards) count by their op.  A
    collective's bytes are its input's local bytes, as in the walker.
  - ``peak_bytes``: the high-water mark of live local storages: the
    arguments', and every op's and every redistribution's outputs,
    each released when its storage dies (autograd's saved tensors keep
    theirs alive, as they do on the card).
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# explicit functional collectives on local tensors -> walker kind
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL_NS = ("_c10d_functional", "_c10d_functional_autograd")
# ops that allocate nothing new and move no data
_FREE = {"wait_tensor", "_wrap_tensor_autograd", "detach", "alias",
         "lift_fresh", "empty", "empty_like", "new_empty",
         "empty_strided", "new_empty_strided"}


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_bytes_total": self.total_collective_bytes}


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            out += _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            out += _tensors(x)
    return out


def transition_bytes(placements_from, placements_to, mesh,
                     local_bytes: int) -> List[Tuple[str, int]]:
    """The collectives of one redistribution, ``(kind, bytes)`` a mesh
    dim, by each dim's placement transition; mesh dims are taken from the
    last to the first (DTensor's order for gathers), and the local size
    follows each step (a gather multiplies it by the dim's size, a
    scatter or a local split divides it)."""
    out = []
    b = float(local_bytes)
    for i in reversed(range(len(placements_from))):
        src, dst = placements_from[i], placements_to[i]
        if src == dst:
            continue
        n = mesh.size(i)
        if src.is_shard() and dst.is_shard():
            out.append(("all-to-all", b))
        elif src.is_shard() and dst.is_replicate():
            out.append(("all-gather", b))
            b *= n
        elif src.is_partial() and dst.is_replicate():
            out.append(("all-reduce", b))
        elif src.is_partial() and dst.is_shard():
            out.append(("reduce-scatter", b))
            b /= n
        elif src.is_replicate() and dst.is_shard():
            b /= n                       # a local split
        elif src.is_shard() and dst.is_partial():
            out.append(("all-gather", b))
            b *= n
        # replicate -> partial moves nothing
    return out


class CostMode(TorchDispatchMode):
    """Counts :class:`Cost` and the peak of live local bytes for the ops
    run inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, Any] = {}
        self._in_redistribute = 0
        self.collectives: List[Tuple[str, float, str]] = []

    # ---- live storages ----
    def track(self, t) -> None:
        t = _local(t)
        if not isinstance(t, torch.Tensor):
            return
        s = t.untyped_storage()
        key = id(s)
        if key in self._seen and self._seen[key][0]() is s:
            return
        nb = s.nbytes()

        def gone(_ref, key=key, nb=nb, self_ref=weakref.ref(self)):
            me = self_ref()
            if me is not None and key in me._seen:
                del me._seen[key]
                me.live -= nb
        self._seen[key] = (weakref.ref(s, gone), nb)
        self.live += nb
        self.peak = max(self.peak, self.live)

    def add_collective(self, kind: str, nbytes: float, what: str) -> None:
        """One collective: its kind, its input's local bytes and what
        issued it (an op's name, or a redistribution's transition)."""
        self.cost.collective_bytes[kind] += float(nbytes)
        self.collectives.append((kind, float(nbytes), what))

    # ---- ops ----
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            out = func(*args, **kwargs)
        except Exception as e:
            layouts = [f"{tuple(t.shape)} {t.placements}"
                       if isinstance(t, DTensor) else tuple(t.shape)
                       for t in _tensors((args, kwargs))]
            raise RuntimeError(f"{func} on {layouts}: {e}") from e
        ns = func.namespace
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if ns in _FUNCOL_NS:
            kind = _FUNCOL_KIND.get(name)
            if kind is not None and not self._in_redistribute and ins:
                self.add_collective(kind, _nbytes(ins[0]), str(func))
            for t in outs:
                self.track(t)
            return out
        self._count_flops(func, args, kwargs, out, outs)
        if not func.is_view and name not in _FREE:
            self.cost.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        for t in outs:
            self.track(t)
        return out

    def _count_flops(self, func, args, kwargs, out, outs) -> None:
        from torch.utils.flop_counter import flop_registry
        fn = flop_registry.get(func._overloadpacket)
        if fn is None or not outs:
            return
        flops = float(fn(*args, **kwargs, out_val=out))
        o = outs[0]
        if isinstance(o, DTensor):
            loc = o._local_tensor
            if o.numel():
                flops *= loc.numel() / o.numel()
            for i, p in enumerate(o.placements):
                if p.is_partial():
                    flops /= o.device_mesh.size(i)
        self.cost.flops += flops


def _shard_to_partial_in_two(orig, local, current, target, *a, **kw):
    """``orig(local, current, target)``; where this torch cannot take a
    shard straight to a partial sum (2.11: "redistribute from S(1) to
    P(sum) not supported yet", which its own sharding propagation asks
    for in a backward), it goes through ``Replicate`` on those mesh dims:
    an all-gather, then a local split of the value into partials."""
    try:
        return orig(local, current, target, *a, **kw)
    except RuntimeError as e:
        if "not supported" not in str(e):
            raise
    import copy
    from torch.distributed.tensor import Replicate
    mid = copy.copy(target)
    mid.placements = tuple(
        Replicate() if s.is_shard() and t.is_partial() else t
        for s, t in zip(current.placements, target.placements))
    step = orig(local, current, mid, *a, **kw)
    return orig(step, mid, target, *a, **kw)


@contextlib.contextmanager
def _count_redistributions(mode: CostMode):
    """Counts every DTensor redistribution by its placements' transition
    (``redistribute_local_tensor``, which both the explicit
    ``redistribute`` and the sharding propagation call), and tracks the
    storages it makes."""
    import importlib
    mods = []
    for name in ("torch.distributed.tensor._redistribute",
                 "torch.distributed.tensor._dispatch",
                 "torch.distributed.tensor._api"):
        try:
            m = importlib.import_module(name)
        except ImportError:
            continue
        if hasattr(m, "redistribute_local_tensor"):
            mods.append(m)
    if not mods:
        raise RuntimeError("this torch has no redistribute_local_tensor: "
                           "the cost counter cannot see redistributions")
    orig = mods[0].redistribute_local_tensor

    def counted(local_tensor, current_spec, target_spec, *a, **kw):
        for kind, b in transition_bytes(current_spec.placements,
                                        target_spec.placements,
                                        current_spec.mesh,
                                        _nbytes(local_tensor)):
            mode.add_collective(kind, b, f"{current_spec.placements} -> "
                                f"{target_spec.placements}")
        mode._in_redistribute += 1
        try:
            res = _shard_to_partial_in_two(
                orig, local_tensor, current_spec, target_spec, *a, **kw)
        finally:
            mode._in_redistribute -= 1
        mode.track(res)
        return res

    for m in mods:
        m.redistribute_local_tensor = counted
    try:
        yield
    finally:
        for m in mods:
            m.redistribute_local_tensor = orig


@dataclass
class Lowered:
    """What one counted run of a step gives the dry run."""
    cost: Cost
    argument_bytes: int
    peak_bytes: int
    output_bytes: int
    collectives: List[Tuple[str, float, str]] = field(default_factory=list)

    @property
    def temp_bytes(self) -> int:
        return max(self.peak_bytes - self.argument_bytes, 0)


def _arg_tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [t for f in tree._fields for t in _arg_tensors(
            getattr(tree, f))]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _arg_tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _arg_tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def lower(fn, *args, **kwargs) -> Lowered:
    """Run ``fn(*args, **kwargs)`` once under the counter."""
    mode = CostMode()
    arg_ts = _arg_tensors((args, kwargs))
    for t in arg_ts:
        mode.track(t)
    arg_bytes = mode.live
    with _count_redistributions(mode), mode:
        out = fn(*args, **kwargs)
    out_ts = _arg_tensors(out)
    arg_ids = {id(_local(t).untyped_storage()) for t in arg_ts}
    out_bytes = sum(_nbytes(t) for t in out_ts
                    if id(_local(t).untyped_storage()) not in arg_ids)
    return Lowered(cost=mode.cost, argument_bytes=arg_bytes,
                   peak_bytes=mode.peak, output_bytes=out_bytes,
                   collectives=mode.collectives)
