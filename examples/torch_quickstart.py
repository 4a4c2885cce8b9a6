"""Quickstart on the PyTorch/CUDA port: the paper's Example 1/4 — count
Foursquare checkins per retailer, live — in ~15 lines of app code.

The declarative builder (DESIGN.md section 11) replaces the subclass
boilerplate: declare a source, decorate a map function (its name,
subscription, and output value spec are inferred by running it on meta
tensors), attach a prebuilt counter, and ``app.run()`` owns engine
selection and state threading — slates stay queryable over HTTP while
the stream flows (paper section 4.4).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the default device is ``cuda``).
"""
import argparse
import json
import urllib.request

import numpy as np
import torch

from repro_torch import App, EventBatch, RuntimeConfig, ops

RETAILERS = ["Walmart", "Sam's Club", "JCPenney", "Best Buy"]

# --- app (paper Example 1) -------------------------------------------
app = App("quickstart")
checkins = app.source("checkins", {"retailer": ((), torch.int32)})


@app.mapper(checkins, out="S2", name="M1")
def at_retailer(batch):
    """M1: checkin -> <retailer, checkin> event (or nothing)."""
    rid = batch.value["retailer"]          # -1 = not at a retailer
    return EventBatch(sid=batch.sid, ts=batch.ts + 1, key=rid,
                      value={"retailer": rid},
                      valid=batch.valid & (rid >= 0))


at_retailer.update(ops.counter("U1", table_capacity=256))
# --- end app ---------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ticks", type=int, default=50)
    args = ap.parse_args(argv)
    app.start(RuntimeConfig(batch_size=512, queue_capacity=2048),
              device=args.device)
    server = app.serve()
    print(f"slate reads live at http://127.0.0.1:{server.port}"
          f"/slate/U1/<retailer-id>")

    rng = np.random.default_rng(0)
    true = np.zeros(len(RETAILERS), np.int64)

    def source_fn(tick, max_events):
        # checkin stream: 20% at a known retailer; respect the engine's
        # ingest limit (source throttling, paper section 5) and count
        # ground truth only over what was actually fed
        rid = np.where(rng.random(512) < 0.2,
                       rng.integers(0, len(RETAILERS), 512),
                       -1).astype(np.int32)
        valid = np.arange(512) < (max_events or 512)
        for r in rid[(rid >= 0) & valid]:
            true[r] += 1
        return {"checkins": EventBatch.of(
            key=rng.integers(0, 1 << 30, 512).astype(np.int32),
            value={"retailer": rid},
            ts=np.full(512, tick, np.int32), valid=valid,
            device=args.device)}

    app.run(source_fn, n_ticks=args.ticks, drain=True)

    print("\nlive counts (HTTP slate fetches):")
    for i, name in enumerate(RETAILERS):
        url = f"http://127.0.0.1:{server.port}/slate/U1/{i}"
        got = json.load(urllib.request.urlopen(url))["count"]
        status = "OK" if got == true[i] else f"MISMATCH (true {true[i]})"
        print(f"  {name:12s} {got:8d}  {status}")
        if got != true[i]:
            raise SystemExit(f"{name}: slate {got} != true count {true[i]}")
    print("\nstats:", json.dumps(app.stats(), indent=1))
    app.close()


if __name__ == "__main__":
    main()
