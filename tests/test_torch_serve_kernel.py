"""The serving slice on the card: the continuous-batching
``ServingEngine`` (``repro_torch.launch.serve``) on ``cuda`` against the
same engine on ``device="cpu"``, with the same weights and requests, an
idle slot decoding past ``cache_len`` (its cache writes dropped, no
device-side assert); the attention kernels at the cross-attention shapes
whisper-tiny and llama-3.2-vision-11b give them (bidirectional
``flash_attention`` with Sq != Skv; ``decode_attention`` with as many kv
heads as query heads and every length the source's); and the two
families' ``lm.prefill`` / ``decode_step`` on the card against the CPU
with random memories.  The card cases skip without CUDA.  The
split-plan cases are plain Python and run anywhere.  The file imports no
JAX, so it runs wherever the port does.

Tolerances: the JAX package's kernel sweep's, 2e-2 for bf16 and 5e-5 for
f32; f32 logits, kernels on the card against the plain versions on the
CPU, within 2**-5 of the largest logit (decode reads bf16 caches)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.launch import serve as ts
from repro_torch.models import lm
from repro_torch.models.context import Ctx

TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _split_rows(length, S, splits, window=0):
    """The cache rows each split of ``csrc/decode_attention.cu`` reads
    for one (request, kv head), as the kernel computes them."""
    n = max(0, min(length, S))
    lo = n - window if window and n > window else 0
    per = -(-(n - lo) // splits)
    return [range(min(lo + i * per, n), min(lo + (i + 1) * per, n))
            for i in range(splits)]


@pytest.mark.parametrize("arch,B", [("llama-3.2-vision-11b", 8),
                                    ("llama-3.2-vision-11b", 1),
                                    ("whisper-tiny", 8)])
def test_cross_decode_split_plan_covers_every_row_once(arch, B):
    """Cross decode reads every source row (``lengths`` = the source's
    length, H = Hkv): the split plan over those rows covers each exactly
    once, and an idle slot's length past the cache is read as S."""
    cfg = get_config(arch)
    S = cfg.n_image_tokens if cfg.cross_attn_every else 256
    splits = dk.plan_splits(B, cfg.n_heads, S)
    assert 1 <= splits <= dk.MAX_SPLITS
    for length in (S, S + 7):
        rows = [r for part in _split_rows(length, S, splits) for r in part]
        assert sorted(rows) == list(range(S))


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,Dh", [
    (1, 64, 1600, 32, 128),    # llama-3.2-vision cross prefill
    (1, 48, 1601, 32, 128),    # a ragged last key tile
    (1, 256, 256, 6, 64),      # whisper cross and encoder
])
def test_bidirectional_flash_attention_on_card(B, Sq, Skv, H, Dh):
    dev = _card()
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(Skv)
    q = _randn(gen, (B, Sq, H, Dh), torch.bfloat16, dev)
    k = _randn(gen, (B, Skv, H, Dh), torch.bfloat16, dev)
    v = _randn(gen, (B, Skv, H, Dh), torch.bfloat16, dev)
    before = fk.flash_attention.launches_by_route["wgmma"]
    got = fk.flash_attention(q, k, v, causal=False)
    assert fk.flash_attention.launches_by_route["wgmma"] == before + 1
    want = attn_ref.mha(q, k, v, causal=False)
    assert float((got.float() - want.float()).abs().max()) < TOL[
        torch.bfloat16]
    assert torch.equal(got, fk.flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("B,S,H,Dh", [(8, 1600, 32, 128), (8, 256, 6, 64)])
def test_cross_decode_attention_on_card(B, S, H, Dh):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(S + H)
    q = _randn(gen, (B, 1, H, Dh), torch.bfloat16, dev)
    k = _randn(gen, (B, S, H, Dh), torch.bfloat16, dev)
    v = _randn(gen, (B, S, H, Dh), torch.bfloat16, dev)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    got = dk.decode_attention(q, k, v, lens)
    want = dec_ref.decode_attend(q, k, v, lens)
    assert float((got.float() - want.float()).abs().max()) < TOL[
        torch.bfloat16]
    assert torch.equal(got, dk.decode_attention(q, k, v, lens))
    lens[0] = S + 40          # an idle slot's length: clamped to S
    assert torch.equal(dk.decode_attention(q, k, v, lens)[0], got[0])


def _engine(dev, model, **kw):
    eng = ts.ServingEngine(reduced_config("qwen2-0.5b"),
                           ts.ServeConfig(**kw), device=dev)
    ts.set_lm_params(eng, convert.lm_params_from_numpy(
        convert.lm_params_to_numpy(model), reduced_config("qwen2-0.5b"),
        device=dev))
    # count the schedule's model calls: one prefill an admission, one
    # decode step a tick with an active slot
    eng.calls = {"prefill": 0, "decode": 0}
    for name, step in (("prefill", eng._prefill), ("decode", eng._decode)):
        def counted(*a, _name=name, _step=step):
            eng.calls[_name] += 1
            return _step(*a)
        setattr(eng, f"_{name}", counted)
    return eng


def test_serving_engine_on_card_matches_cpu():
    """The reduced qwen2 served on the card and on the CPU: the same
    schedule (done ticks, write indices), 4 requests then one long one
    while the other slots idle past ``cache_len`` (writes dropped), and
    every request's first token equal (later tokens may part at a bf16
    near-tie)."""
    dev = _card()
    model, _ = lm.init(lm.build(reduced_config("qwen2-0.5b")),
                       torch.Generator().manual_seed(0))
    kw = dict(n_slots=4, cache_len=48, prompt_bucket=16)
    engines = [_engine(d, model, **kw) for d in (dev, "cpu")]
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(1, 512, int(rng.integers(3, 14))).astype(
        np.int32), 5) for i in range(4)] + [
        (9, np.arange(1, 4, dtype=np.int32), 44)]
    for eng in engines:
        for rid, prompt, max_new in reqs:
            eng.submit(ts.Request(rid=rid, prompt=prompt, max_new=max_new))
        eng.run(60)
    card, cpu = engines
    torch.cuda.synchronize()
    assert int(card.cur_index.max()) > kw["cache_len"]
    assert card.cur_index.cpu().tolist() == cpu.cur_index.tolist()
    a = {r.rid: r for r in card.finished}
    b = {r.rid: r for r in cpu.finished}
    assert sorted(a) == sorted(b) == [0, 1, 2, 3, 9]
    for rid in a:
        assert a[rid].done_tick == b[rid].done_tick
        assert a[rid].tokens_out[0] == b[rid].tokens_out[0]
    assert card.calls["prefill"] == 5 and card.calls == cpu.calls


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_cross_families_on_card_match_cpu(arch):
    """f32 ``lm.prefill`` (full logits) and a decode step with random
    memories, kernels on the card against the plain versions on the
    CPU."""
    dev = _card()
    cfg = reduced_config(arch)
    model, _ = lm.init(lm.build(cfg), torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    B, S = 2, 16
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (B, S),
                                     generator=gen, dtype=torch.int32)}
    if cfg.encdec:
        batch["enc_frames"] = torch.randn(B, S, cfg.d_model, generator=gen)
    else:
        batch["image_embeds"] = torch.randn(B, cfg.n_image_tokens,
                                            cfg.d_model, generator=gen)
    nxt = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                        dtype=torch.int32)
    ctx = Ctx(cdtype=torch.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        m = convert.lm_params_from_numpy(convert.lm_params_to_numpy(model),
                                         cfg, device=d)
        lg, st = lm.prefill(m, {k: v.to(d) for k, v in batch.items()}, ctx,
                            32, full_logits=True)
        dl, _ = lm.decode_step(m, nxt.to(d), st,
                               torch.full((B,), S, dtype=torch.int32,
                                          device=d), ctx)
        out[d.type] = (lg.cpu(), dl.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        tol = 2**-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol
