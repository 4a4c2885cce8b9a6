"""Streaming training driver (port of ``repro.launch.train``).

The training loop is itself a MapUpdate-shaped pipeline: a source stream
(tokens) feeds a stateful step whose "slate" is (params, optimizer
state); the slate-flush machinery is the async checkpointer.  Fault
tolerance: checkpoint every k steps (atomic COMMIT), restart resumes from
the latest committed step, straggler steps are counted, and a simulated
failure flag exercises the restart path end-to-end in tests.

On one card (``device``, default ``cuda``), or on a ``DeviceMesh``
(``launch.mesh.make_host_mesh``; its device type must be ``device``'s):
the parameters and the optimizer state are then DTensors placed by
``sharding.tree_shardings`` under ``rules_for(mesh, phase="train")``,
each batch is split on its batch dim, and each rank keeps its shards.
``params`` is the trainer's ``lm.Model`` (its parameters need
gradients, which :meth:`Trainer.init` sets), updated in place by every
step.

CLI (reduced configs run on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ck \\
      --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.synthetic import Prefetcher, TokenStream
from repro_torch.distributed import optimizer as adamw
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.launch import cells
from repro_torch.launch.mesh import check_mesh
from repro_torch.models import lm


class Trainer:
    def __init__(self, cfg, mesh=None, *, opt_cfg=None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 device=None):
        check_mesh(mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = shd.rules_for(mesh, phase="train") if mesh else None
        self.model = lm.build(cfg)
        self.step_fn = cells.make_train_step(
            self.model, opt_cfg or adamw.AdamWConfig(), mesh=mesh,
            rules=self.rules)
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.step = 0
        # straggler monitoring
        self._ema = None
        self.straggler_events = 0

    def init(self, seed: int = 0):
        """Parameters drawn from ``torch.Generator(device).manual_seed(
        seed)``, made trainable, and a zero optimizer state."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params, specs = lm.init(self.model, gen)
        if self.mesh is not None:
            shd.distribute_model(params, specs, self.mesh, self.rules)
            self.shardings = shd.tree_shardings(specs, params.tree(),
                                                self.mesh, self.rules)
        for p in params.parameters():
            p.requires_grad_(True)
        return params, adamw.init(params.tree())

    def maybe_restore(self, params, opt):
        if self.ckpt is None:
            return params, opt
        latest = self.ckpt.latest_step()
        if latest is None:
            return params, opt
        shardings = None
        if self.mesh is not None:
            shardings = {"params": self.shardings,
                         "opt": adamw.OptState(m=self.shardings,
                                               v=self.shardings, count=None)}
        state = self.ckpt.restore(latest, {"params": params.tree(),
                                           "opt": opt}, shardings,
                                  mesh=self.mesh)
        with torch.no_grad():
            for p, v in zip(adamw.leaves(params.tree()),
                            adamw.leaves(state["params"])):
                p.copy_(v)
        self.step = latest
        return params, state["opt"]

    def run(self, params, opt, batches, n_steps: int, *,
            log_every: int = 10, fail_at: Optional[int] = None):
        """``fail_at``: simulate a crash after that step (tests restart)."""
        losses = []
        for batch in batches:
            if self.step >= n_steps:
                break
            t0 = time.time()
            dev_batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in batch.items()}
            if self.mesh is not None:
                dev_batch = shd.distribute_tree(
                    dev_batch, shd.batch_shardings(dev_batch, self.mesh,
                                                   self.rules), self.mesh)
            params, opt, metrics = self.step_fn(params, opt, dev_batch)
            loss = float(shd.whole(metrics["loss"]))
            losses.append(loss)
            self.step += 1
            dt = time.time() - t0
            self._track_stragglers(dt)
            if self.ckpt and self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, {"params": params.tree(),
                                           "opt": opt})
            if self.step % log_every == 0:
                print(f"step {self.step}: loss={loss:.4f} "
                      f"gnorm={float(shd.whole(metrics['grad_norm'])):.3f} "
                      f"({dt*1e3:.0f} ms)")
            if fail_at is not None and self.step >= fail_at:
                raise RuntimeError("simulated node failure")
        return params, opt, losses

    def _track_stragglers(self, dt: float, k: float = 3.0):
        if self._ema is None:
            self._ema = dt
        elif dt > k * self._ema:
            self.straggler_events += 1   # logged; pipeline skip-ahead
        else:
            self._ema = 0.9 * self._ema + 0.1 * dt

    def close(self):
        if self.ckpt:
            self.ckpt.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for the reduced "
                    "configs on a machine without a card)")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    trainer = Trainer(cfg, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, device=args.device)
    params, opt = trainer.init(args.seed)
    params, opt = trainer.maybe_restore(params, opt)
    stream = Prefetcher(iter(TokenStream(cfg.vocab_size, args.batch,
                                         args.seq, seed=args.seed)))
    t0 = time.time()
    params, opt, losses = trainer.run(params, opt, stream, args.steps)
    print(f"done: {trainer.step} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"stragglers={trainer.straggler_events}")
    if trainer.ckpt:
        trainer.ckpt.save(trainer.step, {"params": params.tree(),
                                         "opt": opt}, blocking=True)
    trainer.close()
    stream.close()


if __name__ == "__main__":
    main()
