"""The train step over 4 data ranks: ``Trainer`` on a (4, 1) ("data",
"model") gloo mesh of 4 CPU processes against the one-card ``Trainer`` on
the whole batch, for tiny qwen2.

Each rank holds one row of the batch of 4; DTensor's redistribution sums
the gradients' ``Partial`` parts over "data", as GSPMD does for the JAX
package (``src/repro/launch/cells.py:86-100``); ``compressed_psum_tree``
is in neither package's step (the ranks make it raise).  The first
step's loss, every gradient at
the initial parameters and the parameters after step 2 are compared.
The ranks spawn once, through a ``FileStore`` under ``tmp_path`` (no TCP
port)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed import optimizer as adamw
from repro_torch.launch import cells
from repro_torch.launch.train import Trainer
from repro_torch.models import lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BATCH, SEQ, STEPS = 4, 4, 32, 2
# The tolerances.  The step computes in bf16: each rank's products round
# to bf16 over its own row before DTensor sums the 4 ranks' f32 partial
# gradients, where the one-card step rounds the whole batch's once.  So
# a gradient entry may differ by one bf16 rounding (2**-8 relative) of
# each of the 4 partials: 4 * 2**-8 of its leaf's largest |gradient|
# (measured: 0.0061).  The loss is one f32 mean in another order: 8 f32
# ulps at ~6.3 (measured: 1 ulp).  AdamW's first steps move each
# parameter by about lr * sign(m): a gradient entry near 0 may change
# sign, so a parameter may differ by 2 * lr a step; lr warms up to 3e-6
# and 6e-6 over the 2 steps (measured: 6.0e-6).
GRAD_RTOL = WORLD * 2.0 ** -8
LOSS_TOL = 8 * float(np.spacing(np.float32(6.3)))
PARAM_ATOL = 2 * (3e-6 + 6e-6)

_RANK = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed import optimizer as adamw
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cells
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import Trainer
from repro_torch.models import lm
from repro_torch.distributed import collectives
store, out, rank, world, batch, seq, steps = sys.argv[1:]


def no_compression(*a, **kw):
    raise AssertionError("compressed_psum_tree is not in the train step")


collectives.compressed_psum_tree = no_compression
rank, world, batch, seq, steps = map(int, (rank, world, batch, seq, steps))
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
mesh = tmesh.make_host_mesh(n_data=world, n_model=1, device="cpu")
cfg = reduced_config("qwen2-0.5b")
tr = Trainer(cfg, mesh=mesh, device="cpu")
p, o = tr.init(0)
batches = [b for _, b in zip(range(steps), TokenStream(cfg.vocab_size,
                                                       batch, seq, seed=0))]
dev = {k: torch.as_tensor(v) for k, v in batches[0].items()}
dev = shd.distribute_tree(dev, shd.batch_shardings(dev, mesh, tr.rules),
                          mesh)
local_rows = dev["tokens"].to_local().shape[0]
leaves = adamw.leaves(p.tree())
with cells.on_mesh(mesh):
    loss = lm.train_loss(p, dev, cells._ctx(mesh, tr.rules))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros(q.shape) if g is None
             else cells._like_param(g, q).full_tensor()
             for q, g in zip(leaves, grads)]
    loss0 = float(loss.full_tensor())
p, o, losses = tr.run(p, o, iter(batches), steps)
after = [shd.whole(q.detach()) for q in adamw.leaves(p.tree())]
if rank == 0:
    np.savez(out, loss0=loss0, losses=np.asarray(losses),
             local_rows=local_rows,
             **{f"g{i}": g.detach().numpy() for i, g in enumerate(grads)},
             **{f"p{i}": q.numpy() for i, q in enumerate(after)})
dist.destroy_process_group()
"""


def test_train_step_over_four_data_ranks(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out, store = tmp_path / "ranks.npz", tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(store), str(out),
         str(r), str(WORLD), str(BATCH), str(SEQ), str(STEPS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        # the one-card step on the whole batch, while the ranks run
        cfg = reduced_config("qwen2-0.5b")
        tr = Trainer(cfg, device="cpu")
        p, o = tr.init(0)
        batches = [b for _, b in zip(range(STEPS), TokenStream(
            cfg.vocab_size, BATCH, SEQ, seed=0))]
        dev = {k: torch.as_tensor(v) for k, v in batches[0].items()}
        leaves = adamw.leaves(p.tree())
        loss = lm.train_loss(p, dev, cells._ctx(None, None))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros(q.shape) if g is None else g
                 for q, g in zip(leaves, grads)]
        loss0 = float(loss.detach())
        p, o, losses = tr.run(p, o, iter(batches), STEPS)
        after = [q.detach() for q in adamw.leaves(p.tree())]
        logs = [pr.communicate(timeout=300)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, log[-4000:]
    r = np.load(out)
    assert int(r["local_rows"]) == BATCH // WORLD     # the batch is split
    assert abs(float(r["loss0"]) - loss0) <= LOSS_TOL, (float(r["loss0"]),
                                                        loss0)
    assert abs(float(r["losses"][0]) - losses[0]) <= LOSS_TOL
    for i, g in enumerate(grads):
        g = g.detach().numpy()
        scale = max(float(np.abs(g).max()), 1e-30)
        err = float(np.abs(r[f"g{i}"] - g).max())
        assert err <= GRAD_RTOL * scale, (i, err, scale)
    for i, q in enumerate(after):
        err = float(np.abs(r[f"p{i}"] - q.numpy()).max())
        assert err <= PARAM_ATOL, (i, err)
