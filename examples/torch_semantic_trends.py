"""Semantic trends on the PyTorch/CUDA port: event stream ->
ModelMapper embeddings -> per-topic semantic top-k (DESIGN.md section
16) — the streaming-ML shape of Twitter's real-time related-query
pipeline: heavy per-event featurization feeding an
incrementally-updated per-key ranking.

Events carry a token window and an item id, keyed by topic.  A
FLOP-heavy :class:`ModelMapper` stage embeds each event's tokens with
a small transformer inside the tick; ``semantic_topk`` keeps, per
topic, the best-scoring items on the fused elementwise-max slate path.
The demo checks itself against a host-side replay of the same scores,
bitwise.

Run:  PYTHONPATH=src python examples/torch_semantic_trends.py [--device cpu]
(the default device is ``cuda``).
"""
import argparse

import numpy as np
import torch

from repro_torch import App, EventBatch, RuntimeConfig, ops
from repro_torch.configs import get_config
from repro_torch.ml.rankers import ITEM_BITS, pack_word

N_TOPICS = 4
SEQ = 8
K = 4
B = 32

cfg = get_config("qwen2-0.5b").replace(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=32)


def build(device):
    # --- app -----------------------------------------------------------
    app = App("semantic_trends")
    app.source("events", {"tokens": ((SEQ,), torch.int32),
                          "item": ((), torch.int32)})
    embed = ops.model_mapper(cfg, field="tokens", out="scored", bucket=8,
                             keep=("item",), name="embed", device=device)
    app.add(embed, subscribes=("events",))
    ranker = ops.semantic_topk(k=K, n_slots=32, table_capacity=64)
    app.stream("scored").update(ranker)
    # --- end app -------------------------------------------------------
    return app, embed, ranker


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    app, embed, ranker = build(args.device)
    rng = np.random.default_rng(0)
    fed = []      # per tick: (topic, item, tokens, valid) of what went in

    def source_fn(tick, max_events):
        toks = rng.integers(1, cfg.vocab_size, (B, SEQ)).astype(np.int32)
        item = rng.integers(1, 1 << ITEM_BITS, B).astype(np.int32)
        topic = rng.integers(0, N_TOPICS, B).astype(np.int32)
        valid = np.arange(B) < (max_events or B)
        fed.append((topic, item, toks, valid))
        return {"events": EventBatch.of(
            key=topic, value={"tokens": toks, "item": item},
            ts=np.full(B, tick, np.int32), valid=valid,
            device=args.device)}

    app.run(source_fn, n_ticks=8, runtime=RuntimeConfig(batch_size=B),
            drain=True, device=args.device)

    # host-side replay: embed each tick's token windows through the same
    # mapper (no engine, the same microbatches) and rank per topic with
    # the same packing
    by_topic = {t: {} for t in range(N_TOPICS)}
    n_fed = 0
    for topic, item, toks, valid in fed:
        t = torch.from_numpy(toks).to(args.device)
        embs = torch.cat([embed.infer(t[i:i + embed.bucket])
                          for i in range(0, B, embed.bucket)])
        words = pack_word(ranker.scores({"emb": embs}),
                          torch.from_numpy(item).to(args.device))
        for i in np.nonzero(valid)[0]:
            col = int(item[i]) % ranker.n_slots
            cur = by_topic[int(topic[i])]
            cur[col] = max(cur.get(col, 0.0), float(words[i]))
            n_fed += 1

    print(f"fed {n_fed} events over {N_TOPICS} topics")
    for t in range(N_TOPICS):
        slate = app.read_slate("semantic_topk", t)
        if slate is None:
            raise SystemExit(f"topic {t} has no slate")
        want = np.zeros(ranker.n_slots, np.float32)
        for col, w in by_topic[t].items():
            want[col] = w
        if not np.array_equal(slate["cells"].numpy(), want):
            raise SystemExit(f"topic {t}: slate cells diverge from the "
                             f"host replay")
        got = ranker.top(slate)
        print(f"  topic {t}: top items {[(i, round(s, 4)) for i, s in got]}")
    print("OK: streamed slates match the host-side replay bitwise")
    app.close()


if __name__ == "__main__":
    main()
