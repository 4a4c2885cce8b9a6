"""Serve a small LM on the PyTorch/CUDA port two ways and compare them:
the direct continuous-batching ``ServingEngine`` loop
(``repro_torch.launch.serve``), then the same model as a MapUpdate app
(``repro_torch.ml.build_serve_app``, DESIGN.md section 16.4: admission
source -> prefill/decode mapper -> per-request slate) with the same
weights (``lm_params(eng)``), token for token.

The two paths decode different batches (8 slots against microbatches of
4) over caches of one length, so their bf16 roundings may part at a
greedy step whose top two logits lie within four bf16 ulps: the check
allows a request to differ only from such a step on (the app's own
margin, printed), as ``tests/test_torch_serve_app.py`` does.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
(the default device is ``cuda``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import RuntimeConfig, TelemetryConfig
from repro_torch.configs import get_config
from repro_torch.launch.serve import (Request, ServeConfig, ServingEngine,
                                      lm_params)
from repro_torch.ml import build_serve_app, request_source
from repro_torch.models import lm
from repro_torch.models.context import Ctx

PROMPT_LEN = 32   # == ServeConfig.prompt_bucket: identical prefill shapes
MAX_NEW = 8
CACHE_LEN = 64
NEAR_TIE = 2**-5  # a top-2 logit margin below it is a near-tie


def margins(model, req, tokens, device):
    """The top-2 logit margin of each greedy step of ``req`` (bf16 logits
    of one teacher-forced prefill over the prompt and ``tokens``)."""
    seq = np.concatenate([req.prompt, np.asarray(tokens[:-1], np.int32)])
    toks = torch.from_numpy(seq[None]).to(device)
    logits, _ = lm.prefill(model, {"tokens": toks}, Ctx(), len(seq),
                           full_logits=True)
    lg = logits[0, len(req.prompt) - 1:].float()
    top = torch.topk(lg, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args()

    cfg = get_config("qwen2-0.5b").replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=4096, head_dim=32)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i + 1,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(5, 30))
                                        ).astype(np.int32),
                    max_new=MAX_NEW)
            for i in range(args.requests)]

    # ---- reference: the direct continuous-batching loop ----
    eng = ServingEngine(cfg, ServeConfig(
        n_slots=8, cache_len=CACHE_LEN, prompt_bucket=PROMPT_LEN,
        admit_per_tick=2, queue_capacity=64), device=args.device)
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=r.prompt.copy(),
                           max_new=r.max_new))
    t0 = time.time()
    while (eng.queue or eng.active.any()) and eng.tick < 2000:
        eng.step()
    dt_direct = time.time() - t0
    direct = {r.rid: list(r.tokens_out) for r in eng.finished}

    # ---- the engine path: same model, same weights, as an App ----
    model = lm_params(eng)
    app = build_serve_app(cfg, model, prompt_len=PROMPT_LEN,
                          max_new=MAX_NEW, cache_len=CACHE_LEN, bucket=4)
    n_ticks = -(-args.requests // 2) + 2
    t0 = time.time()
    app.run(request_source(reqs, prompt_len=PROMPT_LEN,
                           capacity=args.batch, per_tick=2,
                           device=eng.device),
            n_ticks=n_ticks,
            runtime=RuntimeConfig(batch_size=args.batch,
                                  telemetry=TelemetryConfig()),
            drain=True, device=eng.device)
    dt_app = time.time() - t0

    # ---- parity: token streams agree request for request ----
    matched = flipped = 0
    for r in reqs:
        slate = app.read_slate("requests", r.rid)
        assert slate is not None, f"request {r.rid} has no slate"
        got = [int(t) for t in np.asarray(slate["tokens"])]
        if got == direct[r.rid]:
            matched += 1
            continue
        first = next(i for i, (a, b) in enumerate(zip(got, direct[r.rid]))
                     if a != b)
        m = margins(model, r, got, eng.device)
        assert m[first] < NEAR_TIE, \
            f"request {r.rid}: app {got} != direct {direct[r.rid]} at " \
            f"step {first}, margin {m[first]}"
        flipped += 1
        print(f"request {r.rid}: parts at step {first}, a near-tie "
              f"(top-2 margin {m[first]:.6f})")
    toks = args.requests * MAX_NEW
    print(f"parity OK: {matched}/{args.requests} requests token for token "
          f"vs the direct ServingEngine, {flipped} parting at a near-tie")
    print(f"engine path: {toks} tokens in {dt_app:.1f}s "
          f"({toks / dt_app:.0f} tok/s); direct loop: {dt_direct:.1f}s")
    rep = app.telemetry()   # per-shard vectors; one shard here
    print(f"telemetry: pressure={float(np.max(rep.pressure)):.3f} "
          f"events/tick={float(np.sum(rep.events_per_tick)):.1f}")
    print("stats:", app.stats())
    print("serving engine stats:", eng.stats())
    app.close()


if __name__ == "__main__":
    main()
