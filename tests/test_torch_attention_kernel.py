"""The attention kernels (``csrc/flash_attention.cu``,
``csrc/decode_attention.cu``) against their plain versions on the card,
at the serving shapes of ``chip_smoke.py`` phase 3 (qwen2-0.5b 14/2 and
zamba2-1.2b 32/32 heads) and at the other cases the kernels take
(window, q_offset, f32, Dh=72/128/256, Dv != Dh, strided views; for
``flash_attention`` which route each takes, tensor cores or CUDA cores;
for ``decode_attention`` a 4096-row cache whose splits are empty,
partial and full, a window edge inside a split, two query rows), both
kernels giving the same bits on a second call, and the port's serving
``Engine`` on the card against the same run on the CPU.  Every case
needs a CUDA card and skips without one; the file imports no JAX, so it
runs wherever the port does.

Tolerances are the JAX package's kernel sweep's (tests/test_kernels.py):
2e-2 for bf16, 5e-5 for f32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.decode_attention import ref as dec_ref

TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
MAX_NEW = 6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,Dv,causal,window,q_offset,dt", [
    (8, 256, 256, 14, 2, 64, 64, True, 0, 0, torch.bfloat16),   # serving
    (8, 256, 256, 32, 32, 64, 64, True, 0, 0, torch.bfloat16),  # zamba2
    (2, 130, 200, 4, 2, 64, 64, True, 100, 70, torch.bfloat16),  # edges
    (1, 100, 100, 2, 1, 256, 256, True, 0, 0, torch.bfloat16),  # Dh 256
    (2, 96, 96, 4, 2, 128, 32, True, 0, 0, torch.bfloat16),     # Dv 32
    (2, 70, 90, 2, 2, 16, 48, False, 0, 0, torch.bfloat16),     # Dv 48
    (2, 200, 200, 4, 2, 64, 64, True, 48, 0, torch.bfloat16),   # window
    (1, 64, 192, 4, 1, 64, 64, True, 0, 128, torch.bfloat16),   # q_offset
    (2, 130, 130, 4, 2, 64, 64, True, 0, 0, torch.float32),     # f32
    (1, 96, 96, 2, 1, 128, 128, False, 0, 0, torch.bfloat16),   # Dh 128
    (2, 80, 80, 4, 2, 64, 32, True, 0, 0, torch.float32),       # Dv != Dh
    (1, 9, 9, 2, 2, 256, 256, True, 0, 0, torch.float32),       # Dh 256
])
def test_flash_attention_matches_plain_on_card(B, Sq, Skv, H, Hkv, Dh, Dv,
                                               causal, window, q_offset, dt):
    dev = _card()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(Sq + Dh)
    q = _randn(gen, (B, Sq, H, Dh), dt, dev)
    k = _randn(gen, (B, Skv, Hkv, Dh), dt, dev)
    v = _randn(gen, (B, Skv, Hkv, Dv), dt, dev)
    n = fk.flash_attention.launches
    got = fk.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    want = attn_ref.mha(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    torch.cuda.synchronize()
    assert fk.flash_attention.launches == n + 1
    assert got.dtype == dt and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) < TOL[dt]
    assert fk.route(q, k, v) == ("wgmma" if dt == torch.bfloat16
                                 else "simt")


@pytest.mark.parametrize("Dh,dt,route", [
    (64, torch.bfloat16, "wgmma"),
    (72, torch.bfloat16, "simt"),      # not a multiple of 16
    (64, torch.float32, "simt"),       # f32 stays off the tensor cores
])
def test_flash_attention_route_counters(Dh, dt, route):
    """Each shape takes the route the wrapper names, and only that
    route's counter moves."""
    dev = _card()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(Dh)
    q = _randn(gen, (2, 150, 4, Dh), dt, dev)
    k = _randn(gen, (2, 150, 2, Dh), dt, dev)
    v = _randn(gen, (2, 150, 2, Dh), dt, dev)
    assert fk.route(q, k, v) == route
    before = dict(fk.flash_attention.launches_by_route)
    got = fk.flash_attention(q, k, v, window=100)
    want = attn_ref.mha(q, k, v, window=100)
    torch.cuda.synchronize()
    after = fk.flash_attention.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    assert float((got.float() - want.float()).abs().max()) < TOL[dt]


def test_flash_attention_reads_strided_views():
    """q, k, v as slices of one packed [B, S, H + 2 Hkv, D] projection:
    read through their strides, no copies, on the tensor-core route."""
    dev = _card()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = _randn(gen, (2, 100, 8, 64), torch.bfloat16, dev)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert fk.route(q, k, v) == "wgmma"
    n = fk.flash_attention.launches_by_route["wgmma"]
    got = fk.flash_attention(q, k, v)
    assert fk.flash_attention.launches_by_route["wgmma"] == n + 1
    want = attn_ref.mha(q, k, v)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < 2e-2
    with pytest.raises(ValueError):
        fk.flash_attention(q, k, v.transpose(2, 3))   # D not contiguous


def test_unaligned_views_take_the_scalar_loads():
    """Tensors whose base is not 16-byte aligned (a view one element into
    a wider buffer) are read element by element; same results."""
    dev = _card()
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(2)
    buf = _randn(gen, (3, 70, 6, 41), torch.bfloat16, dev)
    q, k, v = buf[:, :, :4, 1:], buf[:, :, 4:5, 1:], buf[:, :, 5:, 1:]
    assert not fk.vec_ok(q, k, v) and fk.route(q, k, v) == "simt"
    got = fk.flash_attention(q, k, v, window=30)
    want = attn_ref.mha(q, k, v, window=30)
    lens = torch.tensor([70, 1, 33], dtype=torch.int32, device=dev)
    dgot = dk.decode_attention(q[:, :2], k, v, lens, window=20)
    dwant = dec_ref.decode_attend(q[:, :2], k, v, lens, window=20)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < 2e-2
    assert float((dgot.float() - dwant.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("B,Sq,S,H,Hkv,Dh,Dv,window,qdt,cdt", [
    (8, 1, 512, 14, 2, 64, 64, 0, torch.bfloat16, torch.bfloat16),  # serving
    (8, 1, 512, 32, 32, 64, 64, 0, torch.bfloat16, torch.bfloat16),  # zamba2
    (2, 2, 300, 14, 2, 64, 64, 0, torch.bfloat16, torch.bfloat16),  # Sq 2
    (1, 1, 300, 2, 1, 256, 256, 0, torch.float32, torch.float32),   # Dh 256
    (2, 1, 100, 4, 2, 72, 40, 30, torch.bfloat16, torch.bfloat16),  # Dh 72
    (3, 1, 200, 4, 1, 32, 32, 64, torch.bfloat16, torch.bfloat16),  # window
    (2, 1, 256, 4, 2, 64, 64, 0, torch.float32, torch.bfloat16),    # f32 q
    (2, 1, 256, 4, 2, 64, 64, 0, torch.float32, torch.float32),     # f32
    (1, 1, 512, 8, 8, 128, 128, 0, torch.bfloat16, torch.bfloat16),  # Dh 128
    (2, 2, 128, 16, 1, 64, 32, 0, torch.float32, torch.float32),    # Dv, rows
])
def test_decode_attention_matches_plain_on_card(B, Sq, S, H, Hkv, Dh, Dv,
                                                window, qdt, cdt):
    dev = _card()
    from repro_torch.kernels.decode_attention import kernel as dk
    gen = torch.Generator(device=dev).manual_seed(S + Dh)
    q = _randn(gen, (B, Sq, H, Dh), qdt, dev)
    kc = _randn(gen, (B, S, Hkv, Dh), cdt, dev)
    vc = _randn(gen, (B, S, Hkv, Dv), cdt, dev)
    lens = torch.randint(window + 1, S + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0] = S
    n = dk.decode_attention.launches
    got = dk.decode_attention(q, kc, vc, lens, window=window)
    want = dec_ref.decode_attend(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    assert dk.decode_attention.launches == n + 1
    # the plain version casts p to the cache dtype before the PV product
    # (as the JAX oracle does), the kernel keeps it f32
    tol = TOL[torch.bfloat16 if torch.bfloat16 in (qdt, cdt)
              else torch.float32]
    assert got.dtype == qdt
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.parametrize("lens,window", [
    ([1, 63, 64, 65, 4096, 2000], 0),      # empty, partial, full splits
    ([4096, 3000, 1500, 700, 100, 5], 0),  # ragged
    ([4096, 3000, 1500, 700, 100, 5], 1000),  # edge inside a split
    ([4096, 3000, 1500, 700, 100, 5], 37),
])
def test_decode_attention_long_cache(lens, window):
    """A 4096-row cache (8 splits a request at these shapes): lengths
    leave splits empty, partial and full, and a window's edge falls
    inside a split."""
    dev = _card()
    from repro_torch.kernels.decode_attention import kernel as dk
    B, S, H, Hkv, Dh = len(lens), 4096, 14, 2, 64
    assert dk.plan_splits(B, Hkv, S) == dk.MAX_SPLITS
    gen = torch.Generator(device=dev).manual_seed(len(lens) + window)
    q = _randn(gen, (B, 1, H, Dh), torch.bfloat16, dev)
    kc = _randn(gen, (B, S, Hkv, Dh), torch.bfloat16, dev)
    vc = _randn(gen, (B, S, Hkv, Dh), torch.bfloat16, dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = dk.decode_attention(q, kc, vc, lengths, window=window)
    want = dec_ref.decode_attend(q, kc, vc, lengths, window=window)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < 2e-2


def test_attention_kernels_repeat_bitwise():
    """Two calls on the same inputs give the same bits: every sum runs in
    a fixed order (phases 7 and 8 of chip_smoke.py hold engine against
    direct loop bitwise)."""
    dev = _card()
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    q, k, v = (_randn(gen, (8, 256, h, 64), bf16, dev) for h in (14, 2, 2))
    assert torch.equal(fk.flash_attention(q, k, v),
                       fk.flash_attention(q, k, v))
    qd = _randn(gen, (8, 1, 14, 64), bf16, dev)
    kc, vc = (_randn(gen, (8, 512, 2, 64), bf16, dev) for _ in range(2))
    lens = torch.randint(1, 513, (8,), generator=gen, device=dev,
                         dtype=torch.int32)
    assert torch.equal(dk.decode_attention(qd, kc, vc, lens),
                       dk.decode_attention(qd, kc, vc, lens))


def test_serving_engine_on_card_equals_cpu():
    """LMServeMapper -> RequestSlate on the engine, tiny config, on the
    card and on the CPU: every request's tokens equal but where a bf16
    near-tie flips one, and the card run went through both attention
    kernels."""
    dev = _card()
    from types import SimpleNamespace

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.workflow import Workflow
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.ml import LMServeMapper, RequestSlate, request_source
    from repro_torch.models import lm

    cfg = get_config("qwen2-0.5b").replace(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        vocab_size=512, head_dim=32)
    model, _ = lm.init(lm.build(cfg), torch.Generator().manual_seed(0))
    params = convert.lm_params_to_numpy(model)
    rng = np.random.default_rng(2)
    reqs = [SimpleNamespace(rid=i + 1, prompt=rng.integers(
        1, 512, int(rng.integers(8, 17))).astype(np.int32))
        for i in range(12)]

    def run(device):
        m = convert.lm_params_from_numpy(params, cfg, device=device)
        mapper = LMServeMapper(cfg, m, max_new=MAX_NEW, cache_len=32,
                               bucket=4)
        mapper.subscribes = ("requests",)
        mapper.bind({"prompt": ((16,), torch.int32),
                     "len": ((), torch.int32)})
        slate = RequestSlate(max_new=MAX_NEW, table_capacity=64)
        slate.subscribes = ("generated",)
        eng = Engine(Workflow([mapper, slate],
                              external_streams=("requests",)),
                     EngineConfig(batch_size=8), device=device)
        st, _ = eng.run(eng.init_state(), request_source(
            reqs, prompt_len=16, capacity=8, per_tick=4, device=device), 3)
        st, _ = eng.drain(st)
        rows = eng.read_slates(st, "requests", [r.rid for r in reqs])
        return np.stack([r["tokens"].numpy() for r in rows]), mapper

    def margins(mapper, req):
        """The CPU run's top-2 bf16 logit margin at each greedy step."""
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(req.prompt)] = req.prompt
        ctx = mapper.ctx
        lg, st = lm.prefill(mapper.model, {"tokens": torch.from_numpy(toks)},
                            ctx, 32, full_logits=True)
        lg, cur, out = lg[0, len(req.prompt) - 1], len(req.prompt), []
        for _ in range(MAX_NEW):
            top = torch.topk(lg.float(), 2).values
            out.append(float(top[0] - top[1]))
            tok = torch.argmax(lg).view(1, 1).to(torch.int32)
            lg, st = lm.decode_step(mapper.model, tok, st,
                                    torch.tensor([cur], dtype=torch.int32),
                                    ctx)
            lg, cur = lg[0, 0], cur + 1
        return out

    before = (fk.flash_attention.launches, dk.decode_attention.launches)
    card, _ = run(dev)
    assert fk.flash_attention.launches > before[0]
    assert dk.decode_attention.launches > before[1]
    cpu, cpu_mapper = run("cpu")
    # bf16 on two devices (cuBLAS and the kernels against the CPU's
    # matmuls and plain versions): a request may differ only from a step
    # where the CPU run's top-2 margin is below the bf16 tolerance
    for i in np.nonzero(~(card == cpu).all(axis=1))[0]:
        first = int(np.argmax(card[i] != cpu[i]))
        assert margins(cpu_mapper, reqs[i])[first] < 2**-5, (card[i], cpu[i])
