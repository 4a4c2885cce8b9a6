"""Port parity for the serving slice as a whole: LM serving as a MapUpdate
app (``repro_torch.ml.serve_app``: ``LMServeMapper`` -> ``RequestSlate``
on the port's ``Engine``) against the JAX package's ``build_serve_app``,
on the same requests and the same weights (carried over by
``repro_torch.convert``), in bf16 compute as both packages serve.

Every request's token slate must be equal token for token.  The two
packages round bf16 intermediates at different places, so a greedy step
whose top two logits are closer than the bf16 tolerance could in
flip; the test allows a different token only where JAX's top-2 logit
margin at the first differing step is below the bf16 tolerance (the rest
of that request then follows its own prefix), and counts such steps.  On
the first case's seed one request of six flips at its first step, where
JAX's margin is 2**-9 (one bf16 ulp); every other token is equal.

The same holds for the reduced zamba2 (Mamba-2 blocks and a shared
attention block).  As in the JAX package, a Mamba-2 prefill runs every
position of the padded prompt, so a short prompt's pad tokens enter its
SSD and conv state; both packages do so alike.

The f32 teacher-forced logits are held within tolerance in
``tests/test_torch_models.py`` and ``tests/test_torch_mamba.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import RuntimeConfig
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch.serve import Request
from repro.ml.serve_app import LMServeMapper as JServeMapper
from repro.ml.serve_app import build_serve_app
from repro.ml.serve_app import request_source as j_request_source
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.event import EventBatch, spec_matches
from repro_torch.core.workflow import Workflow
from repro_torch.ml import LMServeMapper, RequestSlate, request_source

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab_size=512, head_dim=32)
PROMPT_LEN, MAX_NEW, CACHE_LEN = 8, 4, 32
# the bf16 tolerance of a logit (four bf16 ulps of magnitude-1 logits,
# as in tests/test_torch_models.py): a top-2 margin below it is a near-tie
NEAR_TIE = 2**-5


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("qwen2-0.5b").replace(**TINY)
    params = jax.jit(lambda k: jlm.init(jlm.build(jcfg), k)[0])(
        jax.random.PRNGKey(3))
    params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(4)
    attn = params["body"]["segments"][0][0]["attn"]
    for b in ("bq", "bk", "bv"):            # JAX initialises them to zero
        attn[b] = rng.normal(0, 0.5, attn[b].shape).astype(np.float32)
    tcfg = get_config("qwen2-0.5b").replace(**TINY)
    return jcfg, tcfg, params, convert.lm_params_from_numpy(params, tcfg,
                                                            device="cpu")


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=i + 1, prompt=rng.integers(
        1, TINY["vocab_size"], int(rng.integers(3, PROMPT_LEN + 1))
    ).astype(np.int32), max_new=MAX_NEW) for i in range(n)]


def _port_workflow(tcfg, model, bucket):
    mapper = LMServeMapper(tcfg, model, max_new=MAX_NEW,
                           cache_len=CACHE_LEN, bucket=bucket)
    mapper.subscribes = ("requests",)
    mapper.bind({"prompt": ((PROMPT_LEN,), torch.int32),
                 "len": ((), torch.int32)})
    slate = RequestSlate(max_new=MAX_NEW, table_capacity=64)
    slate.subscribes = ("generated",)
    return Workflow([mapper, slate], external_streams=("requests",)), mapper


def _j_top2_margins(jcfg, params, req):
    """JAX's greedy run of one request, alone: per step, the top-2 logit
    margin (bf16 logits, as served)."""
    jm = jlm.build(jcfg)
    ctx = JCtx(cdtype=jnp.bfloat16)
    toks = np.zeros((1, PROMPT_LEN), np.int32)
    toks[0, :len(req.prompt)] = req.prompt
    logits, st = jlm.prefill(jm, params, {"tokens": jnp.asarray(toks)}, ctx,
                             CACHE_LEN, full_logits=True)
    lg = np.asarray(logits[0, len(req.prompt) - 1], np.float32)
    margins, cur = [], len(req.prompt)
    for _ in range(MAX_NEW):
        top = np.sort(lg)[-2:]
        margins.append(float(top[1] - top[0]))
        tok = jnp.asarray([[int(np.argmax(lg))]], jnp.int32)
        out, st = jlm.decode_step(jm, params, tok, st,
                                  jnp.asarray([cur], jnp.int32), ctx)
        lg = np.asarray(out[0, 0], np.float32)
        cur += 1
    return margins


@pytest.fixture(scope="module")
def zamba2_weights():
    """The reduced zamba2 (8 layers: Mamba-2 blocks with one weight-shared
    attention block every 3, a tail of 2), with the parameters init sets
    to 0 or 1 given random values."""
    jcfg = j_reduced_config("zamba2-1.2b")
    params = jax.jit(lambda k: jlm.init(jlm.build(jcfg), k)[0])(
        jax.random.PRNGKey(5))
    params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(6)
    for seg in params["body"]["segments"]:
        for blk in seg:
            if blk is not None:
                mix = blk["mix"]
                for k in ("a_log", "dt_bias", "conv_b"):
                    mix[k] = rng.uniform(-1, 1, mix[k].shape).astype(
                        np.float32)
    tcfg = reduced_config("zamba2-1.2b")
    return jcfg, tcfg, params, convert.lm_params_from_numpy(params, tcfg,
                                                            device="cpu")


@pytest.mark.parametrize("n_req,per_tick,batch,bucket", [
    (6, 2, 4, 2),       # the JAX package's serving test shape
    (9, 3, 4, 4),       # odd requests a tick: a padded microbatch
])
def test_serve_app_tokens_equal_jax(weights, n_req, per_tick, batch,
                                    bucket):
    _serve_both(weights, n_req, per_tick, batch, bucket)


def test_serve_app_tokens_equal_jax_zamba2(zamba2_weights):
    """The hybrid family served on the engine: Mamba-2 prefill and decode
    with the shared attention block's caches, 8 requests, 4 a tick."""
    _serve_both(zamba2_weights, 8, 4, 4, 2)


def _serve_both(weights, n_req, per_tick, batch, bucket):
    """Serve ``n_req`` requests through the JAX ``build_serve_app`` and the
    port's engine; every slate equal, but for JAX near-ties."""
    jcfg, tcfg, params, model = weights
    reqs = _requests(n_req, seed=n_req)
    n_ticks = -(-n_req // per_tick)

    app = build_serve_app(jcfg, params, prompt_len=PROMPT_LEN,
                          max_new=MAX_NEW, cache_len=CACHE_LEN,
                          bucket=bucket, table_capacity=64)
    app.run(j_request_source(reqs, prompt_len=PROMPT_LEN, capacity=batch,
                             per_tick=per_tick), n_ticks=n_ticks,
            runtime=RuntimeConfig(batch_size=batch, chunk_size=2),
            drain=True)
    want = {r.rid: np.asarray(app.read_slate("requests", r.rid)["tokens"])
            for r in reqs}
    app.close()

    wf, mapper = _port_workflow(tcfg, model, bucket)
    eng = Engine(wf, EngineConfig(batch_size=batch, chunk_size=2),
                 device="cpu")
    state, _ = eng.run(eng.init_state(), request_source(
        reqs, prompt_len=PROMPT_LEN, capacity=batch, per_tick=per_tick,
        device="cpu"), n_ticks)
    state, drained = eng.drain(state)
    assert drained == 1
    rids = [r.rid for r in reqs]
    got = eng.read_slates(state, "requests", rids)
    assert mapper.microbatches == (n_ticks + drained) * (-(-batch // bucket))

    near_ties = flipped = 0
    for r, slate in zip(reqs, got):
        assert slate is not None, f"request {r.rid} has no slate"
        assert int(slate["n"]) == MAX_NEW
        toks = slate["tokens"].numpy()
        if np.array_equal(toks, want[r.rid]):
            continue
        # a different token is allowed only at a JAX near-tie, and only
        # the first difference of a request is judged
        margins = _j_top2_margins(jcfg, params, r)
        near_ties += sum(m < NEAR_TIE for m in margins)
        first = int(np.argmax(toks != want[r.rid]))
        assert margins[first] < NEAR_TIE, (r.rid, toks, want[r.rid],
                                           margins)
        flipped += 1
    assert flipped <= near_ties


def test_bucket_padding_is_exact(weights):
    """Padding a batch to the microbatch bucket and slicing back changes
    no real row: each row's tokens equal those of one unpadded
    microbatch of the true batch."""
    _, tcfg, _, model = weights
    mapper = LMServeMapper(tcfg, model, max_new=MAX_NEW, cache_len=CACHE_LEN,
                           bucket=4)
    rng = np.random.default_rng(11)
    for B in (1, 3, 5):
        toks = rng.integers(1, TINY["vocab_size"], (B, PROMPT_LEN)
                            ).astype(np.int32)
        lens = rng.integers(2, PROMPT_LEN + 1, B).astype(np.int32)
        batch = EventBatch.of(np.arange(1, B + 1, dtype=np.int32),
                              {"prompt": toks, "len": lens}, device="cpu")
        out = mapper.map_batch(batch)["generated"]
        whole = mapper.generate(torch.from_numpy(toks),
                                torch.from_numpy(lens))
        assert torch.equal(out.value["tokens"], whole)
        assert torch.equal(out.key, batch.key)
        assert torch.equal(out.ts, batch.ts + 1)


def test_empty_tick_passes_through(weights):
    """An all-invalid batch flows through as all-invalid, with token ids
    in range, and no request slate appears."""
    _, tcfg, _, model = weights
    wf, mapper = _port_workflow(tcfg, model, bucket=2)
    B = 4
    batch = EventBatch.of(np.zeros(B, np.int32),
                          {"prompt": np.zeros((B, PROMPT_LEN), np.int32),
                           "len": np.zeros(B, np.int32)},
                          valid=np.zeros(B, bool), device="cpu")
    out = mapper.map_batch(batch)["generated"]
    assert not bool(out.valid.any())
    assert out.value["tokens"].shape == (B, MAX_NEW)
    assert bool(((out.value["tokens"] >= 0)
                 & (out.value["tokens"] < TINY["vocab_size"])).all())
    eng = Engine(wf, EngineConfig(batch_size=B), device="cpu")
    state, _ = eng.step(eng.init_state(), {"requests": batch})
    state, _ = eng.step(state, {})
    assert eng.stats(state)["table_occupancy"]["requests"] == 0


def test_bind_out_streams_equal_jax(weights):
    jcfg, tcfg, params, model = weights
    spec_j = {"prompt": ((PROMPT_LEN,), jnp.int32), "len": ((), jnp.int32)}
    j = JServeMapper(jcfg, params, max_new=MAX_NEW, cache_len=CACHE_LEN,
                     bucket=2).bind(spec_j)
    t = LMServeMapper(tcfg, model, max_new=MAX_NEW, cache_len=CACHE_LEN,
                      bucket=2).bind({"prompt": ((PROMPT_LEN,), torch.int32),
                                      "len": ((), torch.int32)})
    assert set(t.out_streams) == set(j.out_streams) == {"generated"}
    assert spec_matches(t.out_streams["generated"],
                        j.out_streams["generated"])
    assert spec_matches(RequestSlate(max_new=MAX_NEW).slate_spec(),
                        {"tokens": ((MAX_NEW,), np.int32),
                         "n": ((), np.int32)})
    with pytest.raises(ValueError):
        t.bind({"prompt": ((2, 4), torch.int32), "len": ((), torch.int32)})


def test_zamba2_cache_len_checked_up_front(zamba2_weights):
    """The mapper runs a hybrid model unchanged, its up-front check
    included: the shared attention block's caches must hold the prompt
    and every decode step (the Mamba-2 states are O(1) in length)."""
    _, tcfg, _, model = zamba2_weights
    mapper = LMServeMapper(tcfg, model, max_new=MAX_NEW,
                           cache_len=PROMPT_LEN + MAX_NEW - 2, bucket=2)
    toks = torch.ones((2, PROMPT_LEN), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        mapper.generate(toks, torch.full((2,), PROMPT_LEN,
                                         dtype=torch.int32))
    ok = LMServeMapper(tcfg, model, max_new=MAX_NEW,
                       cache_len=PROMPT_LEN + MAX_NEW - 1, bucket=2)
    out = ok.generate(toks, torch.full((2,), PROMPT_LEN, dtype=torch.int32))
    assert out.shape == (2, MAX_NEW) and out.dtype == torch.int32
