"""The App front door on the card: apps built with the declarative layer
run on ``cuda`` through the port's kernels and are held against the same
app on ``device="cpu"`` — a counter (``slate_update``'s sum route) and
an ``@app.updater(merge="max")`` (its max route) bitwise; a small
``ModelMapper`` feeding ``SemanticTopK`` with its embeddings within the
f32 bound of ``tests/test_torch_models.py`` (1e-4) and every slate cell
within one quantisation level (the two devices reduce the score's mean
in different orders).  The card cases skip without CUDA; the file
imports no JAX, so it runs wherever the port does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import App, EventBatch, RuntimeConfig, convert, ops
from repro_torch.configs import get_config
from repro_torch.ml.rankers import ITEM_BITS

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab_size=512, head_dim=32)
F32_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def counting_app():
    app = App("count_and_max")
    s1 = app.source("S1", {"v": ((4,), torch.float32)})

    @app.mapper(s1, out="Sm")
    def m1(b):
        return EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid)

    @app.mapper("Sm", out="S2")
    def m2(b):
        return EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid)

    app.stream("S2").update(ops.counter("U1", table_capacity=1 << 12))

    @app.updater("S2", name="U2", merge="max",
                 slate={"x": ((4,), torch.float32)},
                 table_capacity=1 << 12)
    def peak(b):
        return {"x": b.value["v"]}
    return app


def feed(t, device):
    rng = np.random.default_rng(100 + t)
    return {"S1": EventBatch.of(
        key=rng.zipf(1.3, 512).astype(np.int32) % 700,
        value={"v": rng.integers(0, 8, (512, 4)).astype(np.float32)},
        ts=t, device=device)}


def test_counter_and_max_app_on_card_equal_cpu(dev):
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    out = {}
    for d in (dev, "cpu"):
        app = counting_app()
        assert app.plan.fused_chains == [("m1", "m2")]
        uk.slate_update.launches = lk.slate_lookup.launches = 0
        app.run(lambda t, mx, d=d: feed(t, d), 12,
                runtime=RuntimeConfig(batch_size=512, chunk_size=4),
                drain=True, device=d)
        if d is dev:
            assert uk.slate_update.launches > 0
            assert lk.slate_lookup.launches > 0
        out[str(d)] = (convert.state_to_numpy(app.handle.state),
                       app.stats(),
                       app.handle.read_slates("U1", list(range(700))))
        app.close()
    (a, sa, ra), (b, sb, rb) = out[str(dev)], out["cpu"]
    assert sa == sb
    for name in ("U1", "U2"):
        for k in ("keys", "ts", "dirty"):
            assert np.array_equal(a["tables"][name][k], b["tables"][name][k])
        for leaf in a["tables"][name]["vals"]:
            assert np.array_equal(a["tables"][name]["vals"][leaf],
                                  b["tables"][name]["vals"][leaf])
    assert [r is None for r in ra] == [r is None for r in rb]
    for x, y in zip(ra, rb):
        if x is not None:
            assert torch.equal(x["count"], y["count"])


def test_model_mapper_semantic_topk_app_on_card_near_cpu(dev):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.models import lm
    cfg = get_config("qwen2-0.5b").replace(**TINY)
    host, _ = lm.init(lm.build(cfg), torch.Generator().manual_seed(0))
    tree = convert.lm_params_to_numpy(host)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab_size, (4, 32, 8)).astype(np.int32)
    items = rng.integers(1, 1 << ITEM_BITS, (4, 32)).astype(np.int32)
    topics = rng.integers(0, 6, (4, 32)).astype(np.int32)
    cells, embs = {}, {}
    for d in (dev, "cpu"):
        model = convert.lm_params_from_numpy(tree, cfg, device=d)
        mm = ops.model_mapper(cfg, model, field="tokens", out="scored",
                              bucket=8, keep=("item",), device=d)
        app = App("trends")
        app.source("ev", {"tokens": ((8,), torch.int32),
                          "item": ((), torch.int32)})
        app.add(mm, subscribes=("ev",))
        app.stream("scored").update(ops.semantic_topk(
            k=4, n_slots=16, table_capacity=64))
        fk.flash_attention.launches_by_route = dict.fromkeys(fk.ROUTES, 0)
        rk.rmsnorm.launches = 0
        app.run(lambda t, mx, d=d: {"ev": EventBatch.of(
            key=topics[t], value={"tokens": toks[t], "item": items[t]},
            ts=t, device=d)}, 4, runtime=RuntimeConfig(batch_size=32),
            drain=True, device=d)
        if d is dev:      # 4 microbatches a tick, drain ticks too; f32
            mb = 4 * app.stats()["tick"]          # takes the simt route
            assert fk.flash_attention.launches_by_route == {
                **dict.fromkeys(fk.ROUTES, 0), "simt": mb * cfg.n_layers}
            assert rk.rmsnorm.launches == mb * (2 * cfg.n_layers + 1)
        cells[str(d)] = {k: app.read_slate("semantic_topk", k)
                         for k in range(6)}
        embs[str(d)] = mm.infer(torch.from_numpy(toks[0, :8]).to(d)).cpu()
        app.close()
    assert (embs[str(dev)] - embs["cpu"]).abs().max() <= F32_TOL
    level = 1 << ITEM_BITS
    for k, want in cells["cpu"].items():
        got = cells[str(dev)][k]
        assert (got is None) == (want is None)
        if want is None:
            continue
        q, item = np.divmod(got["cells"].numpy().astype(np.int64), level)
        wq, witem = np.divmod(want["cells"].numpy().astype(np.int64), level)
        assert (np.abs(q - wq) <= 1).all(), k
        assert (item[q == wq] == witem[q == wq]).all(), k
