"""End-to-end driver of the port: train a qwen2-family model for a few
hundred steps on the streaming synthetic corpus, with async
checkpointing and restart (port of ``examples/train_lm.py``).

Scaled to CPU wall-clock by default (--full-100m uses the ~100M config;
the default is a ~2M config that shows the same loss curve in minutes).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 \\
          --device cpu
"""
import argparse
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.data.synthetic import Prefetcher, TokenStream
from repro_torch.distributed.optimizer import AdamWConfig
from repro_torch.launch.train import Trainer


def config_100m():
    """~100M params of the qwen2 family."""
    return get_config("qwen2-0.5b").replace(
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=2, d_ff=2048,
        vocab_size=32768, head_dim=64)


def config_small():
    """~2M params — same family, CPU-friendly (use --full-100m for the
    ~100M run on the card)."""
    return get_config("qwen2-0.5b").replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=4096, head_dim=32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu without a card)")
    args = ap.parse_args()

    cfg = config_100m() if args.full_100m else config_small()
    n_params = cfg.param_count()
    print(f"arch family qwen2; params ~{n_params/1e6:.1f}M; "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="muppet_ck_")
    trainer = Trainer(cfg, ckpt_dir=ckpt_dir, ckpt_every=100,
                      opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=20),
                      device=args.device)
    params, opt = trainer.init(0)
    params, opt = trainer.maybe_restore(params, opt)
    stream = Prefetcher(iter(TokenStream(cfg.vocab_size, args.batch,
                                         args.seq, seed=0)), depth=2)
    t0 = time.time()
    params, opt, losses = trainer.run(params, opt, stream, args.steps,
                                      log_every=25)
    dt = time.time() - t0
    tok_s = trainer.step * args.batch * args.seq / dt
    print(f"\n{trainer.step} steps in {dt:.0f}s = {tok_s:.0f} tok/s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(checkpoints in {ckpt_dir})")
    assert losses[-1] < losses[0] - 0.5, "loss should fall"
    trainer.ckpt.save(trainer.step, {"params": params.tree(), "opt": opt},
                      blocking=True)
    trainer.close()
    stream.close()


if __name__ == "__main__":
    main()
