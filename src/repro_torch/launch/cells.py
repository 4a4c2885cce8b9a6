"""(architecture x input-shape x mesh) cells, decode states and the
train / prefill / decode step functions (port of ``repro.launch.cells``).

A cell's abstract inputs are ``meta`` DTensors on the mesh (no
parameter allocation; the production meshes run in a ``fake`` world of
256 or 512 ranks, ``launch/mesh.py``), so the 110B-parameter cells run a
step on one host.  ``lower_cell`` runs the step once on them under the
cost counter (``analysis/cost.py``) and returns what the dry run reads.

A step's ``params`` is an ``lm.Model`` holding the weights (the port's
model carries its parameters; ``launch.serve.lm_params`` gives the
serving engine's).  Compute is bf16, as in the JAX steps.  The decode
step updates ``states`` in place (``models/stack.py``'s decode
contract) and returns it; the train step updates the parameters and the
optimizer state in place (``distributed/optimizer.py``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.distributed import optimizer as adamw
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models.config import (ModelConfig, SHAPE_BY_NAME,
                                       ShapeConfig, cell_is_applicable)
from repro_torch.models.context import Ctx
from repro_torch.models.layers import spmd

CDTYPE = torch.bfloat16


@dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    model: Any
    step_fn: Callable
    abstract_args: Tuple[Any, ...]
    donate: Tuple[int, ...] = ()
    rules: Any = None


def abstract_params(model, mesh, rules, *, requires_grad: bool = False):
    """``model`` (an ``lm.Model``) holding ``meta`` DTensors of the
    parameters' shapes and dtypes in their specs' placements."""
    shapes, specs = lm.param_specs(model)
    model.load_tree(shapes)
    return shd.distribute_model(model, specs, mesh, rules,
                                requires_grad=requires_grad)


def abstract_opt(params):
    """The AdamW state of ``params`` (an ``lm.Model`` of DTensors): f32
    ``m`` / ``v`` in the parameters' placements."""
    return adamw.init(params.tree())


def abstract_batch(cfg, shape, mesh, rules):
    raw = lm.input_specs(cfg, shape)
    return shd.distribute_tree(raw, shd.batch_shardings(raw, mesh, rules),
                               mesh)


def abstract_states(model, shape, mesh, rules):
    """Decode caches as ``meta`` DTensors in their logical placements."""
    def make_leaf(shp, dtype, logical):
        t = torch.empty(tuple(shp), dtype=dtype, device="meta")
        return shd.distribute(t, mesh, shd.placements_for(
            logical, tuple(shp), mesh, rules))
    return lm.decode_states(model, shape.global_batch, shape.seq_len,
                            make_leaf)


def concrete_states(model, batch: int, cache_len: int, *, device=None):
    """Zero-initialized decode caches on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return lm.decode_states(
        model, batch, cache_len,
        lambda shp, dtype, logical: torch.zeros(tuple(shp), dtype=dtype,
                                                device=dev))


def _ctx(mesh, rules) -> Ctx:
    """The steps' context: bf16 compute, and on a mesh its constrainer,
    mesh and rules."""
    if mesh is None:
        return Ctx(cdtype=CDTYPE)
    return Ctx(cdtype=CDTYPE, constrain=shd.make_constrainer(mesh, rules),
               mesh=mesh, rules=rules)


def on_mesh(mesh):
    """The context a step runs in on a mesh: plain tensors made inside
    it (positions, masks, scalars) act as replicated DTensors."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _like_param(g, p):
    """A gradient in its parameter's placements: DTensor's redistribution
    sums a ``Partial`` gradient over the mesh dims it is partial on (the
    data axes' gradient all-reduce or reduce-scatter)."""
    if hasattr(p, "device_mesh") and \
            tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model, opt_cfg: adamw.AdamWConfig = None, *, mesh=None,
                    rules=None):
    """(params, opt, batch) -> (params, opt, metrics): the loss and its
    gradients at bf16 compute (the parameters need ``requires_grad``),
    then one AdamW update; ``metrics`` holds ``loss``, ``grad_norm`` and
    ``lr``.  A parameter no path reaches gets a zero gradient, as JAX's
    ``value_and_grad`` gives it.  On a ``mesh`` the parameters, the
    optimizer state and the batch are DTensors (``build_cell``,
    ``Trainer(mesh=...)``) and each gradient is brought to its
    parameter's placements before the update."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ctx = _ctx(mesh, rules)

    def train_step(params, opt, batch):
        with on_mesh(mesh):
            return _train_step(params, opt, batch)

    def _train_step(params, opt, batch):
        loss = lm.train_loss(params, batch, ctx)
        tree = params.tree()
        leaves = adamw.leaves(tree)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): torch.zeros_like(p) if g is None
                 else _like_param(g, p) for p, g in zip(leaves, grads)}
        del grads
        _, opt, metrics = adamw.update(
            tree, adamw.map_tree(lambda p: by_id[id(p)], tree), opt, opt_cfg)
        metrics["loss"] = loss.detach()
        return params, opt, metrics

    return train_step


def make_prefill_step(model, cache_len: int = 0, full_logits: bool = False,
                      *, mesh=None, rules=None):
    ctx = _ctx(mesh, rules)

    def prefill_step(params, batch):
        with on_mesh(mesh):
            return lm.prefill(params, batch, ctx, cache_len,
                              full_logits=full_logits)

    return prefill_step


def make_decode_step(model, *, mesh=None, rules=None):
    ctx = _ctx(mesh, rules)

    def decode_step(params, token, states, cur_index):
        """-> (argmax token [B,1] int32, states, cur_index + 1)."""
        with on_mesh(mesh):
            logits, new_states = lm.decode_step(params, token, states,
                                                cur_index, ctx)
            next_token = spmd.argmax_last(logits[:, -1]).to(torch.int32)
            return next_token[:, None], new_states, cur_index + 1

    return decode_step


# --------------------------------------------------------------------------
# cell assembly
# --------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh, *, rules=None) -> Cell:
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell skipped: {why}")
    rules = rules or shd.rules_for(
        mesh, phase=shape.phase, long_context=(shape_name == "long_500k"))
    model = lm.build(cfg)
    train = shape.phase == "train"
    params = abstract_params(model, mesh, rules, requires_grad=train)
    batch = abstract_batch(cfg, shape, mesh, rules)
    if train:
        fn = make_train_step(model, mesh=mesh, rules=rules)
        return Cell(cfg=cfg, shape=shape, mesh=mesh, model=model,
                    step_fn=fn, abstract_args=(params, abstract_opt(params),
                                               batch),
                    donate=(0, 1), rules=rules)
    if shape.phase == "prefill":
        fn = make_prefill_step(model, cache_len=shape.seq_len, mesh=mesh,
                               rules=rules)
        return Cell(cfg=cfg, shape=shape, mesh=mesh, model=model,
                    step_fn=fn, abstract_args=(params, batch), rules=rules)
    states = abstract_states(model, shape, mesh, rules)
    fn = make_decode_step(model, mesh=mesh, rules=rules)
    return Cell(cfg=cfg, shape=shape, mesh=mesh, model=model, step_fn=fn,
                abstract_args=(params, batch["token"], states,
                               batch["cur_index"]),
                donate=(2,), rules=rules)


def lower_cell(cell: Cell):
    """Run the cell's step once on its ``meta`` arguments under the cost
    counter: an ``analysis.cost.Lowered`` with the per-rank ``cost``
    (FLOPs, bytes, collective bytes by kind) and memory figures (the
    arguments' bytes, the peak of live bytes)."""
    from repro_torch.analysis import cost
    return cost.lower(cell.step_fn, *cell.abstract_args)
