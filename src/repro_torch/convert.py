"""Carry engine state and model weights between the JAX package and the
port.

For the engine, what must carry across is its state —
queues, slate tables, the tick, the counters and, with telemetry on, the
count-min sketch and the latency histograms.  Both functions speak
the plain nested-dict form that ``dataclasses.asdict`` gives of a JAX
engine state after ``jax.device_get``: every dataclass (``QueueState``,
``EventBatch``, ``SlateTable``) becomes a dict of its fields and every
array a numpy array, at the JAX package's shapes.  :func:`to_plain`
makes that form from either package's state objects.

The port's queue buffers and tables carry one hidden sink row
(``core/queues.py``, ``slates/table.py``); ``state_from_numpy`` appends
it and ``state_to_numpy`` strips it.

For the model stack, ``lm_params_from_numpy`` / ``lm_params_to_numpy``
carry the JAX parameter tree (layer leaves stacked ``[n_groups, ...]``)
into an ``lm.Model`` and back (zamba2's ``extra`` dict and the ``None``
at its shared block's position, whisper's ``enc_body`` and
``enc_norm``, and the cross-attention layers' full-head ``wk`` / ``wv``
included), ``mapper_head_from_numpy`` the ``ModelMapper`` classify head,
and ``lm_states_from_numpy`` / ``lm_states_to_numpy`` the decode states
(bf16 KV caches, cross caches and MLA latent caches, whisper's
``{"self", "cross"}`` pairs, f32 Mamba-2, mLSTM and sLSTM states).  JAX's bf16
reaches numpy as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses: both directions go through a ``uint16`` view, so the trip is
bitwise.

For training, ``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry
the AdamW state (``m`` and ``v`` trees of the parameters' structure, the
int32 ``count``) and ``train_state_from_numpy`` / ``train_state_to_numpy``
the ``{"params", "opt"}`` tree the checkpointer writes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.event import EventBatch
from repro_torch.core.queues import QueueState
from repro_torch.slates.table import EMPTY, SlateTable


def to_plain(tree) -> Any:
    """Dataclasses -> dicts of their fields, arrays and tensors -> numpy,
    recursively (dicts, lists, tuples and ``None`` kept)."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: to_plain(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_plain(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:      # numpy has no bf16 of its own
            import ml_dtypes
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(tree)


def _t(a, device, sink=None) -> torch.Tensor:
    """numpy (bf16 as ``ml_dtypes.bfloat16``) -> tensor on ``device``;
    ``sink`` appends one row of that fill value."""
    arr = np.asarray(a)
    if sink is not None:
        arr = np.concatenate([arr, np.full((1,) + arr.shape[1:], sink,
                                           arr.dtype)])
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)   # owned copy


def _map_leaves(fn, tree):
    """Map over the leaves of nested dicts, lists and tuples; ``None``
    (a shared block's place in the stacked parameters) stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _queue_buf(d, device) -> EventBatch:
    return EventBatch(
        sid=_t(d["sid"], device, 0), ts=_t(d["ts"], device, 0),
        key=_t(d["key"], device, 0),
        value=_map_leaves(lambda a: _t(a, device, 0), d["value"]),
        valid=_t(d["valid"], device, False))


def state_from_numpy(tree, device=None) -> Dict[str, Any]:
    """A JAX engine state (plain form, or the state objects themselves)
    -> a port engine state on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    p = to_plain(tree)
    queues = {}
    for name, q in p["queues"].items():
        queues[name] = QueueState(
            buf=_queue_buf(q["buf"], dev),
            head=_t(q["head"], dev), size=_t(q["size"], dev),
            dropped=_t(q["dropped"], dev), peak=_t(q["peak"], dev))
    tables = {}
    for name, t in p["tables"].items():
        tables[name] = SlateTable(
            keys=_t(t["keys"], dev, EMPTY), ts=_t(t["ts"], dev, 0),
            dirty=_t(t["dirty"], dev, False),
            vals=_map_leaves(lambda a: _t(a, dev, 0), t["vals"]),
            dropped=_t(t["dropped"], dev))
    out = {"queues": queues, "tables": tables}
    for k in ("tick", "throttle_hits", "deferred"):
        out[k] = _t(p[k], dev)
    out["processed"] = {k: _t(v, dev) for k, v in p["processed"].items()}
    # telemetry state (sketch; per-arc latency histograms) has no sink
    # rows: carried leaf for leaf
    for k in ("sketch", "lat_hist"):
        if k in p:
            out[k] = _map_leaves(lambda a: _t(a, dev), p[k])
    return out


def state_to_numpy(state) -> Dict[str, Any]:
    """A port engine state -> the plain form at the JAX package's shapes
    (sink rows stripped).  A ``DistributedEngine`` state (it carries
    ``exchange_dropped``) keeps its leading shard dimension and loses
    the sink row of every shard."""
    p = to_plain(state)
    if "exchange_dropped" in p:
        strip = lambda tree: _map_leaves(lambda a: a[:, :-1], tree)
    else:
        strip = lambda tree: _map_leaves(lambda a: a[:-1], tree)
    for q in p["queues"].values():
        q["buf"] = strip(q["buf"])
    for t in p["tables"].values():
        for k in ("keys", "ts", "dirty", "vals"):
            t[k] = strip(t[k])
    return p


# ---- model weights and decode states ----

def lm_params_from_numpy(tree, cfg, device=None):
    """A JAX ``lm.init`` parameter tree (numpy or jax arrays) -> an
    ``lm.Model`` of ``cfg`` on ``device`` (default ``cuda``) holding the
    same values."""
    from repro_torch.models import lm
    dev = resolve_device(device)
    return lm.build(cfg).load_tree(_map_leaves(lambda a: _t(a, dev), tree))


def mapper_head_from_numpy(w, device=None) -> torch.Tensor:
    """A JAX ``ModelMapper``'s classify head (``[d_model, n_classes]``
    f32, drawn from ``fold_in(key, 1)``) -> the tensor the port's
    ``ModelMapper(head=...)`` takes, on ``device`` (default ``cuda``)."""
    return _t(np.asarray(w, np.float32), resolve_device(device))


def lm_params_to_numpy(model):
    """An ``lm.Model``'s parameters -> the JAX parameter tree in numpy."""
    return to_plain(model.tree())


def lm_states_from_numpy(states, device=None):
    """JAX decode states (``lm.prefill`` / ``lm.decode_states``: a list
    per segment of tuples per block of ``{"k", "v"}`` (self or cross),
    whisper's ``{"self": {"k", "v"}, "cross": {"k", "v"}}`` or MLA
    ``{"c_kv", "k_rope"}`` caches, Mamba-2 ``{"conv", "ssd"}``, mLSTM ``{"conv",
    "mem"}`` or sLSTM ``{"h", "c", "n", "m"}`` states) -> the port's, on
    ``device`` (default ``cuda``), each leaf in its own dtype."""
    dev = resolve_device(device)
    return _map_leaves(lambda a: _t(a, dev), states)


def lm_states_to_numpy(states):
    """The port's decode states -> the JAX package's numpy form."""
    return to_plain(states)


# ---- training state ----

def opt_state_from_numpy(opt, device=None):
    """A JAX ``optimizer.OptState`` (numpy or jax arrays) -> the port's
    ``OptState`` of tensors on ``device`` (default ``cuda``)."""
    from repro_torch.distributed.optimizer import OptState
    dev = resolve_device(device)
    conv = lambda t: _map_leaves(lambda a: _t(a, dev), t)
    return OptState(m=conv(opt.m), v=conv(opt.v), count=_t(opt.count, dev))


def opt_state_to_numpy(opt):
    """The port's ``OptState`` -> ``{"m", "v", "count"}`` in numpy (the
    JAX ``OptState``'s fields)."""
    return {"m": to_plain(opt.m), "v": to_plain(opt.v),
            "count": to_plain(opt.count)}


def train_state_from_numpy(tree, cfg, device=None):
    """A JAX ``{"params", "opt"}`` training state -> ``(lm.Model,
    OptState)`` on ``device`` (default ``cuda``)."""
    return (lm_params_from_numpy(tree["params"], cfg, device),
            opt_state_from_numpy(tree["opt"], device))


def train_state_to_numpy(model, opt):
    """``(lm.Model, OptState)`` -> ``{"params", "opt"}`` in numpy."""
    return {"params": lm_params_to_numpy(model),
            "opt": opt_state_to_numpy(opt)}
