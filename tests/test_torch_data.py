"""Port parity of the synthetic sources (``tests/test_data.py``): the
port's ``ZipfEventSource`` and ``TokenStream`` make the JAX package's
arrays bitwise (the same numpy generator calls), and ``Prefetcher``
keeps order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.data.synthetic import (Prefetcher, TokenStream,
                                        ZipfEventSource)


def test_token_stream_deterministic_and_equal_to_jax():
    a = next(iter(TokenStream(512, 4, 32, seed=7)))
    b = next(iter(TokenStream(512, 4, 32, seed=7)))
    assert np.array_equal(a["tokens"], b["tokens"])
    assert np.array_equal(a["labels"], b["labels"])
    # labels are next tokens
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    ts, js = TokenStream(512, 4, 32, seed=7), jsyn.TokenStream(512, 4, 32,
                                                               seed=7)
    assert np.array_equal(ts.succ, js.succ)
    for _ in range(3):
        t, j = next(ts), next(js)
        for k in ("tokens", "labels"):
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])


def test_token_stream_learnable_structure():
    """Markov structure: successor entropy is far below uniform."""
    s = TokenStream(256, 8, 128, seed=0, branching=4)
    batch = next(iter(s))
    toks, labs = batch["tokens"], batch["labels"]
    hits = sum(labs[b, t] in s.succ[toks[b, t]]
               for b in range(8) for t in range(127))
    assert hits / (8 * 127) > 0.8    # 10% noise + collisions


@pytest.mark.parametrize("max_events", [None, 100])
def test_zipf_source_equals_jax_bitwise(max_events):
    src = ZipfEventSource(n_keys=1000, seed=3, events_per_tick=256,
                          device="cpu")
    jsrc = jsyn.ZipfEventSource(n_keys=1000, seed=3, events_per_tick=256)
    for _ in range(3):
        b = convert.to_plain(src.next_batch(max_events))
        j = convert.to_plain(jsrc.next_batch(max_events))
        for k in ("sid", "ts", "key", "valid"):
            assert b[k].dtype == j[k].dtype and np.array_equal(b[k], j[k])
        assert np.array_equal(b["value"]["x"], j["value"]["x"])


def test_zipf_source_skew():
    src = ZipfEventSource(n_keys=10_000, alpha=1.2, seed=0,
                          events_per_tick=4096, device="cpu")
    b = src.next_batch()
    top = np.bincount(b.key.numpy(), minlength=10_000).max()
    assert top > 4096 * 0.02     # head key way above uniform (0.01%)
    assert int(b.count()) == 4096


def test_zipf_source_throttle_arg():
    src = ZipfEventSource(events_per_tick=256, device="cpu")
    b = src.next_batch(max_events=64)
    assert int(b.count()) == 64


def test_zipf_source_defaults_to_cuda():
    src = ZipfEventSource(events_per_tick=8)
    if torch.cuda.is_available():
        assert src.next_batch().key.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            src.next_batch()


def test_prefetcher_order():
    pf = Prefetcher(iter(range(20)), depth=2)
    got = [next(pf) for _ in range(20)]
    assert got == list(range(20))
    pf.close()
