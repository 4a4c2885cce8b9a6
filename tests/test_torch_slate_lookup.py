"""Port parity: the batched slate point-lookup, bitwise against the JAX
package's oracle (``repro.kernels.slate_lookup.ref``), including rows
parked behind TTL holes and keys at the int32 extremes.  The CUDA kernel
is held against the plain version where a card is present."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels.slate_lookup import ops as jops
from repro.slates import table as jtbl
from repro_torch.kernels.slate_lookup import ops as tops
from repro_torch.kernels.slate_lookup import ref as tref
from repro_torch.slates import table as ttbl

I32 = np.iinfo(np.int32)


def _populated(C, n, seed, key_dtype=np.int32, expire=True):
    """A port table with ``n`` keys placed by ``insert_or_find``, random
    rows, and (``expire``) some keys killed by ``expire_ttl`` so live
    keys sit behind TTL holes.  Returns (table, live keys, dead keys)."""
    rng = np.random.default_rng(seed)
    if key_dtype == np.int64:
        keys = (rng.choice(2**40, size=n, replace=False) - 2**39) * 3 + 2**33
    else:
        keys = rng.choice(2**31 - 2, size=n, replace=False) - 2**30
        keys[:2] = [I32.max, I32.min]
    keys = keys.astype(key_dtype)
    t = ttbl.make_table(C, {"v": ((8,), torch.float32)},
                        key_dtype=torch.from_numpy(keys).dtype, device="cpu")
    t, _, _, placed = ttbl.insert_or_find(t, torch.from_numpy(keys),
                                          torch.ones(n, dtype=torch.bool))
    t.vals["v"].copy_(torch.from_numpy(
        rng.normal(size=(C + 1, 8)).astype(np.float32)))
    dead = np.zeros(n, bool)
    if expire:
        stamp = torch.from_numpy(rng.integers(0, 10, C + 1).astype(np.int32))
        t.ts.copy_(stamp)
        ttbl.expire_ttl(t, torch.tensor(12, dtype=torch.int32), 5)
        dead = ~np.isin(keys, t.keys[:C].numpy())   # not the sink row
    live = keys[placed.numpy() & ~dead]
    return t, live, keys[dead]


def _queries(live, dead, seed, dtype):
    rng = np.random.default_rng(seed)
    absent = rng.integers(-5, 5, 20).astype(dtype) * 7919 + 3
    q = np.concatenate([live, dead, absent])
    return q[rng.permutation(q.size)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ref_matches_jax_oracle_bitwise(seed):
    C = 509
    t, live, dead = _populated(C, 300, seed)
    assert dead.size > 0
    q = _queries(live, dead, seed, np.int32)
    keys, vals = t.keys[:C].numpy(), t.vals["v"][:C].numpy()
    js, jf, jr = jops.slate_lookup(jnp.asarray(keys), jnp.asarray(q),
                                   jnp.asarray(vals), impl="jnp")
    ts, tf, tr = tops.slate_lookup(t.keys, torch.from_numpy(q), t.vals["v"],
                                   capacity=C)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(jr), tr.numpy())
    # the read path agrees with table.lookup on every found key
    ls, lf = ttbl.lookup(t, torch.from_numpy(q))
    assert np.array_equal(lf.numpy(), tf.numpy())
    assert np.array_equal(ls.numpy()[lf.numpy()], ts.numpy()[tf.numpy()])


def test_lookup_tree_multi_leaf_matches_jax():
    rng = np.random.default_rng(4)
    C = 131
    keys = rng.choice(10**5, size=80, replace=False).astype(np.int32)
    jt = jtbl.make_table(C, {"a": ((), jnp.int32), "b": ((2, 3), jnp.float32)})
    jt, _, _, _ = jtbl.insert_or_find(jt, jnp.asarray(keys),
                                      jnp.ones(80, bool))
    vals = {"a": rng.integers(0, 99, C).astype(np.int32),
            "b": rng.normal(size=(C, 2, 3)).astype(np.float32)}
    q = np.concatenate([keys[:50], keys[:10] + 10**5]).astype(np.int32)
    jf, jr = jax.jit(jops.lookup_tree, static_argnames="impl")(
        jt.keys, {k: jnp.asarray(v) for k, v in vals.items()},
        jnp.asarray(q), impl="jnp")
    tk = torch.from_numpy(np.array(jt.keys))
    tf, tr = tops.lookup_tree(tk, {k: torch.from_numpy(v)
                                   for k, v in vals.items()},
                              torch.from_numpy(q))
    assert np.array_equal(np.asarray(jf), tf.numpy())
    for k in vals:
        assert np.array_equal(np.asarray(jr[k]), tr[k].numpy())


def test_int64_and_int32_tables_read_alike():
    """The same probe chain over int64 keys: a wide table read back gives
    the rows its keys were written with."""
    C = 1021
    t, live, dead = _populated(C, 500, 5, key_dtype=np.int64)
    q = _queries(live, dead, 5, np.int64)
    s, f, r = tops.slate_lookup(t.keys, torch.from_numpy(q), t.vals["v"],
                                capacity=C)
    assert int(f.sum()) == live.size
    ls, lf = ttbl.lookup(t, torch.from_numpy(q))
    assert torch.equal(lf, f)
    assert torch.equal(r[f], t.vals["v"][s[f]])
    assert torch.all(r[~f] == 0) and torch.all(s[~f] == -1)


@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_slots_matches_jax_oracle(seed):
    """The probe walk alone (the read of a slate tree with no [N, D]
    leaf, and ``Engine.read_slate``): slots and found as the JAX
    oracle's, past TTL holes and at the int32 extremes."""
    C = 257
    t, live, dead = _populated(C, 160, seed)
    q = _queries(live, dead, seed, np.int32)
    js, jf = jops.lookup_slots(jnp.asarray(t.keys[:C].numpy()),
                               jnp.asarray(q))
    ts, tf = tops.lookup_slots(t.keys, torch.from_numpy(q), C)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert 0 < int(tf.sum()) < q.size


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_lookup_tree_wide_leaf_beside_others_matches_jax(dtype):
    """A tree with an [N, D] leaf (the kernel's on the card) beside
    leaves of other ranks, int32 and int64 keys (the JAX package under
    x64): found and every leaf's rows as the JAX oracle's."""
    rng = np.random.default_rng(6)
    C = 211
    with jax.enable_x64(dtype == np.int64):
        keys = rng.choice(10**6, size=120, replace=False).astype(dtype)
        if dtype == np.int64:
            keys = (keys - 5 * 10**5) * (2**33 + 1)
        jt = jtbl.make_table(C, {"n": ((), jnp.int32),
                                 "v": ((4,), jnp.float32)},
                             key_dtype=jnp.dtype(dtype))
        jt, _, _, _ = jtbl.insert_or_find(jt, jnp.asarray(keys),
                                          jnp.ones(keys.size, bool))
        vals = {"n": rng.integers(0, 99, C).astype(np.int32),
                "v": rng.normal(size=(C, 4)).astype(np.float32),
                "w": rng.normal(size=(C, 2, 3)).astype(np.float32)}
        q = np.concatenate([keys[:70], keys[:15] + 1]).astype(dtype)
        jf, jr = jops.lookup_tree(jt.keys, {k: jnp.asarray(v)
                                            for k, v in vals.items()},
                                  jnp.asarray(q), impl="jnp")
        tf, tr = tops.lookup_tree(torch.from_numpy(np.array(jt.keys)),
                                  {k: torch.from_numpy(v)
                                   for k, v in vals.items()},
                                  torch.from_numpy(q))
        assert np.array_equal(np.asarray(jf), tf.numpy())
        for k in vals:
            assert np.array_equal(np.asarray(jr[k]), tr[k].numpy()), k
        assert 0 < int(tf.sum()) < q.size
