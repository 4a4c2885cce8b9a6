"""Port parity: events and ring queues, bitwise against the JAX package
on identical numpy inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import queues as jq
from repro.core.event import EventBatch as JBatch
from repro.core.event import compact as jcompact
from repro_torch import convert
from repro_torch.core import queues as tq
from repro_torch.core.event import EventBatch as TBatch
from repro_torch.core.event import compact as tcompact
from repro_torch.core.event import concat as tconcat

I32MAX = np.iinfo(np.int32).max
VSPEC_J = {"x": ((), jnp.int32), "v": ((2,), jnp.float32)}
VSPEC_T = {"x": ((), torch.int32), "v": ((2,), torch.float32)}


def _batch(rng, n, key_hi=12, p_valid=0.7):
    keys = rng.integers(0, key_hi, size=n).astype(np.int32)
    return dict(key=keys,
                value={"x": rng.integers(-50, 50, size=n).astype(np.int32),
                       "v": rng.normal(size=(n, 2)).astype(np.float32)},
                ts=rng.integers(0, 5, size=n).astype(np.int32),
                sid=rng.integers(0, 3, size=n).astype(np.int32),
                valid=rng.random(n) < p_valid)


def _pair(d):
    j = JBatch.of(jnp.asarray(d["key"]),
                  {k: jnp.asarray(v) for k, v in d["value"].items()},
                  ts=jnp.asarray(d["ts"]), sid=jnp.asarray(d["sid"]),
                  valid=jnp.asarray(d["valid"]))
    t = TBatch.of(d["key"], d["value"], ts=d["ts"], sid=d["sid"],
                  valid=d["valid"], device="cpu")
    return j, t


def _eq_batch(j, t):
    pj, pt = convert.to_plain(j), convert.to_plain(t)
    for f in ("sid", "ts", "key", "valid"):
        assert np.array_equal(pj[f], pt[f]), f
    for k in pj["value"]:
        assert np.array_equal(pj["value"][k], pt["value"][k]), k


def test_of_broadcasts_scalars_and_keeps_key_width():
    t = TBatch.of([3, 1, 2], {"x": np.array([1, 2, 3])}, ts=4, valid=True,
                  device="cpu")
    assert t.ts.tolist() == [4, 4, 4] and t.valid.tolist() == [True] * 3
    assert t.key.dtype == torch.int32 and t.value["x"].dtype == torch.int32
    wide = TBatch.of(np.array([2**40], np.int64), {"x": [1]}, device="cpu")
    assert wide.key.dtype == torch.int64
    assert TBatch.of(torch.tensor([1, 2]), {"x": np.ones(2)}).key.device.type \
        == "cpu"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_by_key_ts_with_key_at_sink(seed):
    """A valid event at int32 max shares the sink run: its valid rows
    stay contiguous ahead of the invalid ones, bitwise as in JAX."""
    rng = np.random.default_rng(seed)
    d = _batch(rng, 64)
    d["key"][rng.choice(64, size=6, replace=False)] = I32MAX
    j, t = _pair(d)
    _eq_batch(j.sort_by_key_ts(), t.sort_by_key_ts())


def test_compact_concat_take_pad_to_host():
    rng = np.random.default_rng(5)
    j, t = _pair(_batch(rng, 40))
    _eq_batch(jcompact(j), tcompact(t))
    j2, t2 = _pair(_batch(rng, 24))
    from repro.core.event import concat as jconcat
    _eq_batch(jconcat([j, j2]), tconcat([t, t2]))
    _eq_batch(j.pad_to(64), t.pad_to(64))
    idx = rng.permutation(40)
    _eq_batch(j.take(jnp.asarray(idx)), t.take(torch.from_numpy(idx)))
    hj, ht = j.to_host(), t.to_host()
    for f in ("sid", "ts", "key"):
        assert np.array_equal(hj[f], ht[f])
    assert int(t.count()) == int(j.count())


def _eq_queue(jqs, tqs):
    pj = convert.to_plain(jqs)
    pt = convert.state_to_numpy({"queues": {"q": tqs}, "tables": {}})[
        "queues"]["q"]
    for f in ("head", "size", "dropped", "peak"):
        assert int(pj[f]) == int(pt[f]), f
    for f in ("sid", "ts", "key", "valid"):
        assert np.array_equal(pj["buf"][f], pt["buf"][f]), f
    for k in pj["buf"]["value"]:
        assert np.array_equal(pj["buf"]["value"][k], pt["buf"]["value"][k])


_j_enqueue = jax.jit(jq.enqueue)
_j_dequeue = jax.jit(jq.dequeue, static_argnums=1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_enqueue_dequeue_with_overflow(seed):
    """Fixed shapes (24-row batches with a random valid share, dequeues
    of 5 or 17) keep the JAX side to one compile per function."""
    rng = np.random.default_rng(100 + seed)
    cap = 32
    jqs = jq.make_queue(cap, VSPEC_J)
    tqs = tq.make_queue(cap, VSPEC_T, device="cpu")
    for _ in range(14):
        if rng.random() < 0.6:
            j, t = _pair(_batch(rng, 24, p_valid=rng.random()))
            jqs, jovf = _j_enqueue(jqs, j)
            tqs, tovf = tq.enqueue(tqs, t)
            _eq_batch(jovf, tovf)
            jqs, tqs = jq.count_drop(jqs, jovf), tq.count_drop(tqs, tovf)
        else:
            n = int(rng.choice([5, 17]))
            jqs, jout = _j_dequeue(jqs, n)
            tqs, tout = tq.dequeue(tqs, n)
            _eq_batch(jout, tout)
        _eq_queue(jqs, tqs)
    assert int(tqs.dropped) > 0 or int(tqs.peak) > 0
