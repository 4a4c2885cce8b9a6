"""Async checkpoint / restore (port of ``repro.distributed.checkpoint``).

Layout, the JAX package's, so a checkpoint written by either package
restores in the other:  <dir>/step_<N>/
            manifest.json        (step, leaf paths, shapes, dtypes)
            <leaf-path>.npy      (one file per tree leaf, "/" -> "__")
            COMMIT               (written last -> atomic visibility)

A leaf's path is the JAX package's ``tree_flatten_with_path`` key: dict
keys, list indices and ``NamedTuple`` field names joined by "/" (dict
keys sorted, ``None`` an empty subtree), e.g.
``params/body/segments/0/0/attn/wq``, ``opt/m/embed``, ``opt/count``.

- ``save`` copies every leaf to host memory, then writes on a
  background thread (training never blocks on disk).
- ``restore`` rebuilds the tree with each leaf on ``device``, or, given
  ``shardings`` (a matching tree of DTensor placements, as
  ``sharding.tree_shardings`` gives them), as a DTensor on the mesh: the
  JAX package's elastic restore onto a new mesh.  Each rank reads the
  whole leaf from the host and keeps its shard.
- ``save`` gathers a DTensor leaf whole first (``full_tensor``), so the
  files are those of an unsharded run.
- ``latest_step`` only trusts committed checkpoints, so a crash mid-write
  rolls back to the previous step (restart-safety).
"""
from __future__ import annotations

import json
import os
import queue as pyqueue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's order and spelling."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k],
                                                          prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _flatten(getattr(tree, f),
                                                          prefix + (f,))]
    if isinstance(tree, (list, tuple)) and not _is_placements(tree):
        return [x for i, t in enumerate(tree) for x in _flatten(
            t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _is_placements(t) -> bool:
    """A tuple of DTensor placements (a ``shardings`` leaf)."""
    return isinstance(t, tuple) and len(t) > 0 and all(
        hasattr(e, "is_shard") for e in t)


def _leaf_paths(tree) -> Dict[str, Any]:
    return dict(_flatten(tree))


def _unflatten(tree, values: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), values,
                                       prefix + (f,)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, values, prefix + (str(i),))
                          for i, t in enumerate(tree))
    return values["/".join(prefix)]


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its memory (the caller may go on
    updating the tensor in place while the writer thread runs)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    if hasattr(t, "full_tensor"):          # a DTensor: the whole leaf
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:       # numpy has no bf16 of its own
        import ml_dtypes
        return np.array(t.view(torch.uint16).cpu().numpy()).view(
            ml_dtypes.bfloat16)
    return t.cpu().numpy() if t.is_cuda else np.array(t.numpy())


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A loaded leaf as a tensor; ``dtype`` is the manifest's (a bf16
    ``.npy`` reads back as 2-byte voids: numpy has no bf16 of its own)."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: pyqueue.Queue = pyqueue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.errors: list = []

    # ---- save ----
    def save(self, step: int, tree, *, blocking: bool = False):
        host = {k: _to_host(v) for k, v in _leaf_paths(tree).items()}
        self._q.put((step, host))
        if blocking:
            self.wait()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host = item
            try:
                self._write(step, host)
            except Exception as e:  # kept for the caller, as in JAX
                self.errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, host: Dict[str, np.ndarray]):
        d = os.path.join(self.dir, f"step_{step:010d}")
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, arr in host.items():
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def wait(self):
        self._q.join()

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)

    # ---- restore ----
    def all_steps(self):
        out = []
        for fn in sorted(os.listdir(self.dir)):
            if fn.startswith("step_") and not fn.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, fn, "COMMIT")):
                out.append(int(fn[5:]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, shardings=None, *,
                mesh=None, device=None):
        """``target_tree``: a tree of tensors (or any leaves) giving the
        structure; returns it with every leaf read from the checkpoint, as
        a tensor on ``device`` (default: the target leaf's device when it
        is a tensor, else ``cuda``).  ``shardings``: an optional matching
        tree of placements; each such leaf comes back as a DTensor on
        ``mesh`` (default: the first DTensor leaf's mesh of
        ``target_tree``), on the mesh's device."""
        shard_leaves = _leaf_paths(shardings) if shardings is not None \
            else {}
        if shardings is not None and mesh is None:
            mesh = next((t.device_mesh for t in _leaf_paths(
                target_tree).values() if hasattr(t, "device_mesh")), None)
            if mesh is None:
                raise ValueError(
                    "restore with shardings needs a mesh: pass mesh= or a "
                    "target tree holding DTensors")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for key, leaf in _leaf_paths(target_tree).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = np.load(os.path.join(d, meta["file"]))
            pl = shard_leaves.get(key)
            if pl is not None:
                from repro_torch.distributed.sharding import distribute
                out[key] = distribute(_from_host(
                    arr, meta["dtype"], resolve_device(mesh.device_type)),
                    mesh, pl)
                continue
            dev = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else None)
            out[key] = _from_host(arr, meta["dtype"], resolve_device(dev))
        return _unflatten(target_tree, out)
