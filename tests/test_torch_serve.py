"""Port parity for the continuous-batching serving driver
(``repro_torch.launch.serve.ServingEngine``) against the JAX package's
(``repro.launch.serve``), with the JAX engine's weights carried over by
``repro_torch.convert`` and ``set_lm_params``, the same requests and the
same ticks: all seven reduced model families, the four cases of
``tests/test_serve.py``, the request journal (byte-equal files,
recovered across packages both ways), whisper's prompt-bucket limit, and
the cache write an idle slot makes past ``cache_len`` (dropped, as
JAX's scatter drops it).

Both engines compute in bf16 and round intermediates at different
places, so a greedy step whose top two logits lie within the bf16
tolerance may flip.  The JAX engine's own margins are recorded (its
prefill and decode steps wrapped to keep the top-2 logit margin of each
slot), and a token may differ only where JAX's margin at a request's
first differing step is below ``NEAR_TIE`` (the rule of
``tests/test_torch_serve_app.py``); the rest of that request follows its
own prefix.  Schedules do not depend on token values (no EOS): every
``done_tick``, ``stats()`` (but the telemetry window's wall time),
``shed`` and ``cur_index`` must be equal."""
import json
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import reduced_config as j_reduced_config
from repro.launch import serve as js
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.launch import cells
from repro_torch.launch import serve as ts
from repro_torch.models.layers import attention as t_attn

FAMILIES = ("qwen2-0.5b", "zamba2-1.2b", "xlstm-350m", "gemma3-1b",
            "deepseek-v2-lite-16b", "whisper-tiny", "llama-3.2-vision-11b")
NEAR_TIE = 2**-5     # a JAX top-2 logit margin below it is a near-tie
SERVE = dict(n_slots=4, cache_len=64, prompt_bucket=16, queue_capacity=8,
             admit_per_tick=2)


class Margins:
    """The JAX engine's top-2 logit margin of every token it generates:
    its prefill and decode steps wrapped (jitted, bf16 as it serves),
    margins kept by request id in generation order."""

    def __init__(self, je):
        self.by_rid = {}
        ctx = JCtx(cdtype=jnp.bfloat16)
        model = je.model

        @jax.jit
        def decode(params, token, states, cur_index):
            logits, new = jlm.decode_step(model, params, token, states,
                                          cur_index, ctx)
            lg = logits[:, -1].astype(jnp.float32)
            top = jax.lax.top_k(lg, 2)[0]
            nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            return nxt[:, None], new, cur_index + 1, top[:, 0] - top[:, 1]

        prefill = je._prefill

        def wrapped_prefill(params, batch):
            logits, st = prefill(params, batch)
            req = je.queue_head       # the request being admitted
            lg = np.asarray(logits[0, min(len(req.prompt),
                                          logits.shape[1]) - 1], np.float32)
            top = np.sort(lg)[-2:]
            self.by_rid[req.rid] = [float(top[1] - top[0])]
            return logits, st

        def wrapped_decode(params, token, states, cur_index):
            rids = [None if r is None else r.rid for r in je.slot_req]
            tok, st, cur, m = decode(params, token, states, cur_index)
            m = np.asarray(m)
            for slot, rid in enumerate(rids):
                if rid is not None and je.active[slot]:
                    self.by_rid[rid].append(float(m[slot]))
            return tok, st, cur

        je._prefill = wrapped_prefill
        je._decode = wrapped_decode
        popleft = je.queue.popleft

        def take():
            je.queue_head = popleft()
            return je.queue_head

        je.queue.popleft = take


class _Queue(list):
    """A deque stand-in whose ``popleft`` can be wrapped (a deque's
    attributes are read-only)."""

    def popleft(self):
        return self.pop(0)


def _engines(arch, serve=None, *, journals=(None, None)):
    scfg = dict(SERVE, **(serve or {}))
    je = js.ServingEngine(j_reduced_config(arch), js.ServeConfig(**scfg),
                          journal=journals[0])
    je.queue = _Queue()
    margins = Margins(je)
    te = ts.ServingEngine(reduced_config(arch), ts.ServeConfig(**scfg),
                          journal=journals[1], device="cpu")
    params = jax.device_get(js.lm_params(je))
    ts.set_lm_params(te, convert.lm_params_from_numpy(
        params, reduced_config(arch), device="cpu"))
    return je, te, margins


def _requests(n, seed, vocab=512, lo=3, hi=14, max_new=6, rid0=0):
    rng = np.random.default_rng(seed)
    return [(rid0 + i, rng.integers(0, vocab, size=int(rng.integers(lo, hi))
                                    ).astype(np.int32), max_new)
            for i in range(n)]


def _submit(je, te, reqs):
    ok = []
    for rid, prompt, max_new in reqs:
        a = je.submit(js.Request(rid=rid, prompt=prompt.copy(),
                                 max_new=max_new))
        b = te.submit(ts.Request(rid=rid, prompt=prompt.copy(),
                                 max_new=max_new))
        assert a == b
        ok.append(a)
    return ok


def _stats(eng):
    s = eng.stats()
    if "telemetry" in s:
        s["telemetry"] = dict(s["telemetry"], window_s=None)
    return s


def _same(je, te, margins):
    """Schedules equal; tokens equal but for JAX near-ties.  Returns
    (requests, requests flipped at a near-tie)."""
    assert _stats(te) == _stats(je)
    assert te.shed == je.shed and te.tick == je.tick
    assert np.array_equal(te.cur_index.numpy(), np.asarray(je.cur_index))
    assert np.array_equal(te.active, je.active)
    assert [r.rid for r in te.queue] == [r.rid for r in je.queue]
    jd = {r.rid: r for r in je.finished}
    td = {r.rid: r for r in te.finished}
    assert [r.rid for r in te.finished] == [r.rid for r in je.finished]
    live = [(a, b) for a, b in zip(je.slot_req, te.slot_req)
            if a is not None or b is not None]
    pairs = [(jd[k], td[k]) for k in jd] + live
    flipped = 0
    for a, b in pairs:
        assert a.rid == b.rid and a.done_tick == b.done_tick
        assert a.arrived_tick == b.arrived_tick
        assert len(a.tokens_out) == len(b.tokens_out)
        diff = [i for i, (x, y) in enumerate(zip(a.tokens_out, b.tokens_out))
                if x != y]
        if diff:
            m = margins.by_rid[a.rid]
            assert m[diff[0]] < NEAR_TIE, (a.rid, a.tokens_out,
                                           b.tokens_out, m)
            flipped += 1
    return len(pairs), flipped


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_matches_jax(arch):
    """Each family served by both engines: 7 requests (more than the 4
    slots) over 12 ticks, compared tick by tick, then one long request
    (3 prompt tokens, 60 new) while the other slots idle and decode past
    ``cache_len`` (their writes dropped).  whisper runs at
    ``prompt_bucket == cache_len``, the reference's limit."""
    serve = {"prompt_bucket": 64} if arch == "whisper-tiny" else {}
    je, te, margins = _engines(arch, serve)
    reqs = _requests(7, seed=FAMILIES.index(arch))
    _submit(je, te, reqs)
    for _ in range(12):
        je.step()
        te.step()
        _same(je, te, margins)
    # one long request: the slots finished above idle past cache_len
    _submit(je, te, [(100, np.arange(1, 4, dtype=np.int32), 60)])
    je.run(62)
    te.run(62)
    n, flipped = _same(je, te, margins)
    assert te.stats()["finished"] == n == 8
    assert int(te.cur_index.max()) > te.scfg.cache_len
    # most streams equal in full: the near-tie rule is not all that holds
    assert flipped <= n // 2, flipped


@pytest.fixture(scope="module")
def serve_pair():
    """tests/test_serve.py's engine (reduced qwen2, 4 slots, cache 64,
    bucket 16, queue 8), in both packages; its three module cases run on
    it in order."""
    return _engines("qwen2-0.5b")


def test_all_requests_complete(serve_pair):
    je, te, margins = serve_pair
    _submit(je, te, _requests(6, seed=0))
    je.run(40)
    te.run(40)
    _same(je, te, margins)
    s = te.stats()
    assert s["finished"] >= 6
    assert all(len(r.tokens_out) >= 1 for r in te.finished)


def test_admission_queue_sheds_overload(serve_pair):
    """40 requests into a queue of 8 shed the overflow; 120 ticks drain
    it.  (No slot idles past cache_len here: a tick decodes only while
    some slot is active, and an idle slot is refilled while the queue
    holds requests; ``test_engine_matches_jax`` drives that case.)"""
    je, te, margins = serve_pair
    before = te.stats()["shed"]
    ok = _submit(je, te, _requests(40, seed=1, rid0=100))
    assert sum(ok) <= te.scfg.queue_capacity
    assert te.stats()["shed"] > before
    for _ in range(120):
        je.step()
        te.step()
    _same(je, te, margins)
    assert te.stats()["queued"] == 0


def test_continuous_batching_interleaves(serve_pair):
    je, te, margins = serve_pair
    _submit(je, te, _requests(1, seed=2, rid0=200, max_new=12))
    je.run(3)
    te.run(3)
    _submit(je, te, _requests(1, seed=3, rid0=201, max_new=4))
    je.run(30)
    te.run(30)
    _same(je, te, margins)
    r200 = next(r for r in te.finished if r.rid == 200)
    r201 = next(r for r in te.finished if r.rid == 201)
    assert r201.done_tick < r200.done_tick


def _journals(tmp_path):
    return str(tmp_path / "jax" / "requests.log"), \
        str(tmp_path / "port" / "requests.log")


def test_request_journal_recovery(tmp_path):
    """tests/test_serve.py's crash and recovery on both engines: the
    journals are byte-equal after the run, the port recovers its own
    unfinished requests (prompts bit-exact) and finishes them, and each
    package recovers the other's journal to the same requests."""
    scfg = dict(n_slots=2, cache_len=64, prompt_bucket=16)
    jpath, tpath = _journals(tmp_path)
    je, te, margins = _engines("qwen2-0.5b", scfg, journals=(jpath, tpath))
    reqs = _requests(5, seed=3, max_new=4)
    assert all(_submit(je, te, reqs))
    je.run(6)
    te.run(6)
    _same(je, te, margins)
    finished = {r.rid for r in te.finished}
    assert 0 < len(finished) < 5
    je.journal.close()
    te.journal.close()
    assert open(jpath, "rb").read() == open(tpath, "rb").read()

    # each package recovers the other's journal
    for path in (jpath, tpath):
        jr = js.ServingEngine(j_reduced_config("qwen2-0.5b"),
                              js.ServeConfig(**scfg), journal=path)
        tr = ts.ServingEngine(reduced_config("qwen2-0.5b"),
                              ts.ServeConfig(**scfg), journal=path,
                              device="cpu")
        a, b = jr.recover_requests(), tr.recover_requests()
        assert [r.rid for r in a] == [r.rid for r in b] == \
            sorted(set(range(5)) - finished)
        for x, y in zip(a, b):
            assert np.array_equal(x.prompt, y.prompt)
            assert x.prompt.dtype == y.prompt.dtype == np.int32
            assert x.max_new == y.max_new
        assert jr.journal_max_rid == tr.journal_max_rid == 4
        jr.journal.close()
        tr.journal.close()

    te2 = ts.ServingEngine(reduced_config("qwen2-0.5b"),
                           ts.ServeConfig(**scfg), journal=jpath,
                           device="cpu")
    ts.set_lm_params(te2, convert.lm_params_from_numpy(
        jax.device_get(js.lm_params(je)), reduced_config("qwen2-0.5b"),
        device="cpu"))
    pending = te2.recover_requests()
    assert {r.rid for r in pending} == set(range(5)) - finished
    for r in pending:
        orig = next(o for o in reqs if o[0] == r.rid)
        assert np.array_equal(r.prompt, orig[1]) and r.max_new == orig[2]
        assert te2.submit(r, journal=False)
    te2.run(60)
    assert {r.rid for r in te2.finished} == {r.rid for r in pending}
    assert all(len(r.tokens_out) == 4 for r in te2.finished)
    assert te2.recover_requests() == []
    te2.journal.close()


def test_whisper_bucket_below_cache_len_raises_in_both():
    """The reference's limit, copied: whisper's decoder cross cache holds
    cache_len rows and a prefill's cross k/v the bucket's, so admitting a
    prompt whose bucket is below cache_len fails in both packages."""
    je = js.ServingEngine(j_reduced_config("whisper-tiny"),
                          js.ServeConfig(**SERVE))
    te = ts.ServingEngine(reduced_config("whisper-tiny"),
                          ts.ServeConfig(**SERVE), device="cpu")
    for eng, R in ((je, js.Request), (te, ts.Request)):
        eng.submit(R(rid=0, prompt=np.arange(1, 9, dtype=np.int32)))
        with pytest.raises(ValueError) as e:
            eng.step()
        assert not eng.active.any()
    assert "cross cache" in str(e.value) and "16" in str(e.value)


def test_write_cache_drops_writes_past_the_cache():
    """``attention._write_caches`` against JAX's scatter on the same bits:
    a write at an index past the cache leaves every row as it was; the
    others land (a 4-d k/v cache and a 3-d MLA latent cache, two caches
    in one call), in place, bf16 and f32."""
    rng = np.random.default_rng(23)
    for shape in ((4, 8, 2, 3), (4, 8, 5)):
        for dt in (np.float32, jnp.bfloat16):
            cache = rng.standard_normal(shape).astype(dt)
            new = rng.standard_normal((4, 1) + shape[2:]).astype(np.float32)
            idx = np.array([8, 3, 11, 7], np.int32)   # two past S = 8
            want = np.asarray(jnp.asarray(cache).at[
                jnp.arange(4), jnp.asarray(idx)].set(
                    jnp.asarray(new[:, 0]).astype(cache.dtype)))
            tc = convert.lm_states_from_numpy(cache, device="cpu")
            other = tc.clone()
            out = t_attn._write_caches((tc, other), (torch.from_numpy(
                new), torch.from_numpy(new)), torch.from_numpy(idx))
            assert out[0] is tc and torch.equal(other, tc)
            got = convert.lm_states_to_numpy(tc)
            bits = (lambda a: a.view(np.uint16)) if dt is jnp.bfloat16 \
                else (lambda a: a)
            assert np.array_equal(bits(got), bits(want))
            assert np.array_equal(bits(got[[0, 2]]), bits(cache[[0, 2]]))


def test_decode_attention_plain_version_clamps_lengths():
    """The plain decode attention clamps lengths past the cache to S, as
    the kernel does: without a window it then equals the JAX oracle at
    any length; with one, lengths S + 3 read the last ``window`` rows."""
    from repro.kernels.decode_attention import ref as j_ref
    from repro_torch.kernels.decode_attention import ref as t_ref
    rng = np.random.default_rng(29)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 8, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 8, 2, 16)).astype(np.float32)
    long = np.array([11, 8, 5], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = t_ref.decode_attend(*t, torch.from_numpy(long))
    want = j_ref.decode_attend(*map(jnp.asarray, (q, k, v)),
                               jnp.asarray(long))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-5
    clamped = torch.from_numpy(np.minimum(long, 8))
    for window in (0, 3):
        a = t_ref.decode_attend(*t, torch.from_numpy(long), window=window)
        b = t_ref.decode_attend(*t, clamped, window=window)
        assert torch.equal(a, b)


def test_steps_and_mesh():
    """``cells``' decode step returns the argmax token [B, 1] int32 and
    ``cur_index + 1``; the prefill step's caches hold ``cache_len`` rows;
    a ``mesh`` that is not a ``DeviceMesh`` raises a ``TypeError``."""
    cfg = reduced_config("qwen2-0.5b")
    eng = ts.ServingEngine(cfg, ts.ServeConfig(n_slots=2, cache_len=16),
                           device="cpu")
    params = ts.lm_params(eng)
    assert params.embed.dtype == torch.bfloat16
    assert params.final_norm.scale.dtype == torch.float32
    assert ts.lm_params(eng) is params
    step = cells.make_decode_step(eng.model)
    cur = torch.tensor([3, 20], dtype=torch.int32)   # slot 1 past the cache
    tok, st, nxt = step(params, torch.tensor([[5], [6]], dtype=torch.int32),
                        eng.states, cur)
    assert tok.shape == (2, 1) and tok.dtype == torch.int32
    assert st[0][0]["k"] is eng.states[0][0]["k"]      # updated in place
    assert nxt.tolist() == [4, 21]
    with pytest.raises(TypeError, match="DeviceMesh"):
        ts.ServingEngine(cfg, mesh=object(), device="cpu")
    logits, new = cells.make_prefill_step(eng.model, 16, full_logits=True)(
        params, {"tokens": torch.ones((1, 8), dtype=torch.int32)})
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert new[0][0]["k"].shape[1:3] == (1, 16)      # sized cache_len


def test_status_server_and_cli(capsys, tmp_path):
    """``/status``, ``/slate/requests/<rid>`` and ``/metrics`` while
    serving; then the launcher ``main`` on the CPU with a journal, and
    again with ``--recover``."""
    eng = ts.ServingEngine(reduced_config("qwen2-0.5b"),
                           ts.ServeConfig(n_slots=2, cache_len=32,
                                          prompt_bucket=8), device="cpu")
    for rid, prompt, max_new in _requests(4, seed=31, max_new=3):
        eng.submit(ts.Request(rid=rid, prompt=prompt, max_new=max_new))
    server = eng.status_server(0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        get = lambda p: urllib.request.urlopen(base + p, timeout=10).read()
        assert json.loads(get("/slate/requests/3")) == {
            "tokens_out": [], "done": False}
        eng.run(16)
        status = json.loads(get("/status"))
        assert status["finished"] == 4 and status["tick"] == 16
        assert "telemetry" in status
        r0 = json.loads(get("/slate/requests/0"))
        assert r0["done"] and len(r0["tokens_out"]) == 3
        assert r0["tokens_out"] == eng.finished[0].tokens_out
        metrics = get("/metrics").decode()
        assert "finished 4" in metrics.replace("muppet_", "")
    finally:
        server.close()
    journal = str(tmp_path / "cli.log")
    ts.main(["--device", "cpu", "--requests", "3", "--ticks", "2",
             "--journal", journal])
    first = capsys.readouterr().out
    assert "'tick': 2" in first
    ts.main(["--device", "cpu", "--requests", "1", "--ticks", "40",
             "--journal", journal, "--recover"])
    out = capsys.readouterr().out
    assert "recovered 3 unfinished request(s)" in out
    assert "'finished': 4" in out
