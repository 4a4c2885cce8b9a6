"""The port's training driver (``launch/train.py``: ``Trainer``, its CLI,
``launch/cells.make_train_step``) on the CPU: a restart resumes bit for
bit, and a short bf16 run follows the JAX package's ``Trainer``.

bf16 tolerance: the two packages round intermediate results at
different places (``tests/test_torch_models.py``), so each bf16 loss is
held to twice the distance between the JAX package's own bf16 and f32
losses at that step, from the same parameters on the same batches (the
f32 run is the JAX step at f32 compute): both bf16 runs are roundings of
one f32 run, and one that rounds no worse than the JAX package's lies
within that distance of it, so within twice it of the JAX package's."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import reduced_config as j_reduced_config
from repro.data.synthetic import TokenStream as JTokenStream
from repro.distributed import optimizer as j_adamw
from repro.launch.train import Trainer as JTrainer
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed import optimizer as adamw
from repro_torch.launch import train
from repro_torch.launch.train import Trainer


def _state(params, opt):
    """Every tensor of (params, opt) in a fixed order, detached."""
    return [t.detach().clone() for t in adamw.leaves(params.tree())
            + adamw.leaves(opt.m) + adamw.leaves(opt.v) + [opt.count]]


def test_restart_resumes_bitwise(tmp_path):
    """Six steps straight against three steps, a checkpoint, a simulated
    failure, a new ``Trainer`` restored from the checkpoint and three
    more steps on the next batches: parameters and optimizer state equal
    bit for bit (bf16 compute, as the trainer runs)."""
    cfg = reduced_config("qwen2-0.5b")
    straight = Trainer(cfg, device="cpu")
    p, o = straight.init(0)
    stream = TokenStream(cfg.vocab_size, 4, 32, seed=0)
    p, o, losses = straight.run(p, o, iter(stream), 6)
    assert straight.step == 6 and len(losses) == 6
    want = _state(p, o)

    stream = iter(TokenStream(cfg.vocab_size, 4, 32, seed=0))
    tr = Trainer(cfg, ckpt_dir=str(tmp_path), ckpt_every=3, device="cpu")
    p1, o1 = tr.init(0)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr.run(p1, o1, stream, 100, fail_at=3)
    tr.ckpt.wait()
    assert tr.ckpt.latest_step() == 3

    tr2 = Trainer(cfg, ckpt_dir=str(tmp_path), ckpt_every=100, device="cpu")
    p2, o2 = tr2.init(1)                    # other weights: restored over
    p2, o2 = tr2.maybe_restore(p2, o2)
    assert tr2.step == 3 and int(o2.count) == 3
    assert all(p.requires_grad for p in p2.parameters())
    p2, o2, losses2 = tr2.run(p2, o2, stream, 6)
    assert tr2.step == 6 and losses2 == losses[3:]
    got = _state(p2, o2)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for t in (straight, tr, tr2):
        t.close()


def test_loss_trajectory_follows_the_jax_trainer():
    """Three steps of both trainers (bf16 compute, default AdamW) from the
    JAX package's initial parameters on the same TokenStream batches."""
    jcfg, cfg = j_reduced_config("qwen2-0.5b"), reduced_config("qwen2-0.5b")
    jt = JTrainer(jcfg)
    jp, jo = jt.init(0)
    init = jax.tree.map(np.asarray, jp)
    batches = [b for _, b in zip(range(3), JTokenStream(
        jcfg.vocab_size, 4, 64, seed=0))]
    # the port's TokenStream draws the same batches
    for a, b in zip(batches, TokenStream(cfg.vocab_size, 4, 64, seed=0)):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    _, _, jl = jt.run(jp, jo, iter(batches), 3)

    jm = jlm.build(jcfg)
    opt_cfg = j_adamw.AdamWConfig()

    @jax.jit
    def f32_step(p, o, b):
        loss, g = jax.value_and_grad(lambda p: jlm.train_loss(
            jm, p, b, JCtx(cdtype=jnp.float32)))(p)
        p, o, _ = j_adamw.update(p, g, o, opt_cfg)
        return p, o, loss

    p, o, fl = jax.tree.map(jnp.asarray, init), j_adamw.init(init), []
    for b in batches:
        p, o, loss = f32_step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        fl.append(float(loss))

    tt = Trainer(cfg, device="cpu")
    tp, to = tt.init(0)
    src = convert.lm_params_from_numpy(init, cfg, device="cpu")
    with torch.no_grad():
        for dst, v in zip(adamw.leaves(tp.tree()), adamw.leaves(src.tree())):
            dst.copy_(v)
    _, to, tl = tt.run(tp, to, iter(batches), 3)
    assert int(to.count) == 3
    for step, (got, want, f32) in enumerate(zip(tl, jl, fl)):
        assert abs(got - want) <= 2 * abs(want - f32), (step, got, want, f32)


def test_mesh_raises_and_the_cli_trains_and_resumes(tmp_path, capsys):
    """``Trainer(mesh=...)`` takes a ``DeviceMesh`` only; ``python -m
    repro_torch.launch.train`` trains on the CPU, saves at the end, and a
    second run resumes from that step (and has nothing left to run at the
    same ``--steps``, so it trains two more)."""
    cfg = reduced_config("qwen2-0.5b")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, mesh=object(), device="cpu")
    args = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    train.main(args + ["--steps", "2"])
    assert "done: 2 steps" in capsys.readouterr().out
    train.main(args + ["--steps", "4"])
    assert "done: 4 steps" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000004"]
