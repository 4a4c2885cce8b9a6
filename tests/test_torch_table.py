"""Port parity: the open-addressing slate table, bitwise against the JAX
package — slot layout, ``found``, ``placed`` and ``dropped`` under
forced intra-batch collisions, plus ``lookup`` and ``expire_ttl``."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.slates import table as jtbl
from repro_torch import convert
from repro_torch.slates import table as ttbl

SPEC_J = {"c": ((), jnp.int32), "v": ((3,), jnp.float32)}
SPEC_T = {"c": ((), torch.int32), "v": ((3,), torch.float32)}

_j_insert = jax.jit(jtbl.insert_or_find)
_j_lookup = jax.jit(jtbl.lookup)


def _colliding_keys(capacity, n_groups, per_group, seed):
    """Keys whose first probe lands on a shared slot, ``per_group`` keys
    for each of ``n_groups`` slots, in shuffled batch order."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(2**30, size=20000, replace=False).astype(np.int32)
    first = np.asarray(jtbl._probe_seq(jnp.asarray(pool), capacity))[0]
    groups = []
    for s in np.unique(first):
        members = pool[first == s]
        if members.size >= per_group:
            groups.append(members[:per_group])
        if len(groups) == n_groups:
            break
    keys = np.concatenate(groups)
    return keys[rng.permutation(keys.size)]


def _tables(capacity):
    return (jtbl.make_table(capacity, SPEC_J),
            ttbl.make_table(capacity, SPEC_T, device="cpu"))


def _eq_table(jt, tt):
    pj = convert.to_plain(jt)
    pt = convert.state_to_numpy({"queues": {}, "tables": {"t": tt}})[
        "tables"]["t"]
    for f in ("keys", "ts", "dirty", "dropped"):
        assert np.array_equal(pj[f], pt[f]), f
    for k in pj["vals"]:
        assert np.array_equal(pj["vals"][k], pt["vals"][k]), k


def _insert_both(jt, tt, keys, valid):
    jt, js, jf, jp = _j_insert(jt, jnp.asarray(keys), jnp.asarray(valid))
    tt, ts, tf, tp = ttbl.insert_or_find(tt, torch.from_numpy(keys),
                                         torch.from_numpy(valid))
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(jp), tp.numpy())
    _eq_table(jt, tt)
    return jt, tt


@pytest.mark.parametrize("capacity,groups,per,seed", [
    (61, 4, 5, 0),       # five claimants per empty slot
    (97, 8, 3, 1),
    (13, 5, 4, 2),       # more keys than probe room: drops counted
])
def test_insert_or_find_collisions_bitwise(capacity, groups, per, seed):
    keys = _colliding_keys(capacity, groups, per, seed)
    valid = np.ones(keys.size, bool)
    valid[::7] = False
    jt, tt = _tables(capacity)
    jt, tt = _insert_both(jt, tt, keys, valid)
    # a second batch re-finds the placed keys and claims the masked ones
    jt, tt = _insert_both(jt, tt, keys[::-1].copy(), np.ones(keys.size, bool))
    if capacity == 13:
        assert int(tt.dropped) > 0


def test_claim_race_goes_to_highest_row():
    """Pins the JAX package's (CPU) last-writer-wins: of several new keys
    claiming one empty slot, the highest batch row owns it."""
    keys = _colliding_keys(61, 1, 4, 7)
    jt, tt = _tables(61)
    first = int(np.asarray(jtbl._probe_seq(jnp.asarray(keys), 61))[0, 0])
    jt2, tt2 = _insert_both(jt, tt, keys, np.ones(keys.size, bool))
    assert int(np.asarray(jt2.keys)[first]) == int(keys[-1])
    assert int(tt2.keys[first]) == int(keys[-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_and_expire_ttl(seed):
    rng = np.random.default_rng(seed)
    C = 257
    keys = rng.choice(10**6, size=150, replace=False).astype(np.int32)
    jt, tt = _tables(C)
    jt, tt = _insert_both(jt, tt, keys, np.ones(keys.size, bool))
    # stamp a few ts rows so expire_ttl kills some keys
    stamp = rng.integers(0, 10, size=C).astype(np.int32)
    jt = jtbl.SlateTable(keys=jt.keys, ts=jnp.asarray(stamp),
                         dirty=jnp.ones(C, bool), vals=jt.vals,
                         dropped=jt.dropped)
    tt.ts[:C] = torch.from_numpy(stamp)
    tt.dirty[:C] = True
    jt = jtbl.expire_ttl(jt, jnp.int32(12), 5)
    tt = ttbl.expire_ttl(tt, torch.tensor(12, dtype=torch.int32), 5)
    _eq_table(jt, tt)
    query = np.concatenate([keys, keys[:30] + 10**6,
                            rng.integers(-5, 5, 10)]).astype(np.int32)
    js, jf = _j_lookup(jt, jnp.asarray(query))
    ts, tf = ttbl.lookup(tt, torch.from_numpy(query))
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert 0 < int(tf.sum()) < keys.size
    # TTL holes: re-inserting reuses freed slots exactly as JAX does
    jt, tt = _insert_both(jt, tt, query[:60].copy(), np.ones(60, bool))
    assert int(tt.occupancy()) == int(jt.occupancy())


def test_write_and_read_slates_bitwise():
    rng = np.random.default_rng(3)
    C = 64
    keys = rng.choice(1000, size=20, replace=False).astype(np.int32)
    jt, tt = _tables(C)
    jt, tt = _insert_both(jt, tt, keys, np.ones(keys.size, bool))
    js, _ = jtbl.lookup(jt, jnp.asarray(keys))
    ts, _ = ttbl.lookup(tt, torch.from_numpy(keys))
    ok = rng.random(keys.size) < 0.7
    new = {"c": rng.integers(0, 9, 20).astype(np.int32),
           "v": rng.normal(size=(20, 3)).astype(np.float32)}
    jt = jtbl.write_slates(jt, js, jnp.asarray(ok),
                           {k: jnp.asarray(v) for k, v in new.items()},
                           jnp.int32(4))
    tt = ttbl.write_slates(tt, ts, torch.from_numpy(ok),
                           {k: torch.from_numpy(v) for k, v in new.items()},
                           torch.tensor(4, dtype=torch.int32))
    _eq_table(jt, tt)
    found = rng.random(keys.size) < 0.5
    init_j = lambda n: {"c": jnp.zeros(n, jnp.int32),
                        "v": jnp.zeros((n, 3), jnp.float32)}
    rj = jtbl.read_slates(jt, js, jnp.asarray(found), init_j)
    rt = ttbl.read_slates(
        tt, ts, torch.from_numpy(found),
        lambda n, device=None: {"c": torch.zeros(n, dtype=torch.int32),
                                "v": torch.zeros(n, 3)})
    for k in rj:
        assert np.array_equal(np.asarray(rj[k]), rt[k].numpy())


# ------------------------------------------------ the pending-masked walk
def _colliding_keys_wide(capacity, n_groups, per_group, seed, dtype):
    """As :func:`_colliding_keys` for ``dtype`` keys; int64 keys are
    negative or above 2**32 (the xor-fold) and hashed by the JAX package
    under x64."""
    rng = np.random.default_rng(seed)
    if dtype == np.int64:
        pool = rng.choice(2**40, size=20000, replace=False) - 2**39
        pool = (pool * 4099 + 2**33).astype(np.int64)
    else:
        pool = rng.choice(2**31 - 2, size=20000, replace=False) - 2**30
        pool = pool.astype(np.int32)
        pool[:2] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    first = np.asarray(jtbl._probe_seq(jnp.asarray(pool), capacity))[0]
    groups = []
    for s in np.unique(first):
        members = pool[first == s]
        if members.size >= per_group:
            groups.append(members[:per_group])
        if len(groups) == n_groups:
            break
    keys = np.concatenate(groups)
    return keys[rng.permutation(keys.size)]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("capacity,groups,per,seed", [
    (61, 4, 5, 3),       # races of five claimants for one empty slot
    (13, 5, 4, 4),       # more keys than probe room: full chains drop keys
])
def test_insert_or_find_masked_walk_bitwise(dtype, capacity, groups, per,
                                            seed):
    """The walk covers only pending rows; ``table.keys``, slot, found,
    placed and dropped stay the JAX package's over several batches, for
    int32 keys at the extremes and int64 keys past 2**32."""
    with jax.enable_x64(dtype == np.int64):
        keys = _colliding_keys_wide(capacity, groups, per, seed, dtype)
        spec_t = {"c": ((), torch.int32), "v": ((3,), torch.float32)}
        jt = jtbl.make_table(capacity, SPEC_J, key_dtype=jnp.dtype(dtype))
        tt = ttbl.make_table(capacity, spec_t, device="cpu",
                             key_dtype=torch.from_numpy(keys).dtype)
        valid = np.ones(keys.size, bool)
        valid[::3] = False
        jt, tt = _insert_both(jt, tt, keys, valid)
        # re-find the placed keys, claim the masked ones, fill the chains
        jt, tt = _insert_both(jt, tt, keys[::-1].copy(),
                              np.ones(keys.size, bool))
        more = _colliding_keys_wide(capacity, groups, per, seed + 10, dtype)
        more = more[~np.isin(more, keys)]
        jt, tt = _insert_both(jt, tt, more, np.ones(more.size, bool))
        assert tt.keys.dtype == torch.from_numpy(keys).dtype
        if capacity == 13:
            assert int(tt.dropped) > 0


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_masked_walk_gives_lookup_keys_on_pending_rows(dtype):
    """``_lookup_keys`` with ``pending``, and the ``find`` route's plain
    version, equal the JAX package's ``_lookup_keys`` on pending rows
    (hits, the first ``EMPTY``, TTL holes, full chains) and give (-1,
    False) elsewhere."""
    from repro_torch.kernels.slate_lookup import ref as tref
    rng = np.random.default_rng(5)
    C = 41
    with jax.enable_x64(dtype == np.int64):
        keys = _colliding_keys_wide(C, 6, 5, 6, dtype)
        extra = _colliding_keys_wide(C, 8, 3, 8, dtype)   # fill the table
        keys = np.concatenate([keys, extra[~np.isin(extra, keys)]])
        jt = jtbl.make_table(C, SPEC_J, key_dtype=jnp.dtype(dtype))
        tt = ttbl.make_table(C, {"c": ((), torch.int32),
                                 "v": ((3,), torch.float32)}, device="cpu",
                             key_dtype=torch.from_numpy(keys).dtype)
        jt, tt = _insert_both(jt, tt, keys, np.ones(keys.size, bool))
        stamp = np.where(rng.random(C) < 0.15, 0, 9).astype(np.int32)
        tt.ts[:C] = torch.from_numpy(stamp)
        tt = ttbl.expire_ttl(tt, torch.tensor(12, dtype=torch.int32), 5)
        absent = _colliding_keys_wide(C, 6, 5, 7, dtype)
        q = np.concatenate([keys, absent[~np.isin(absent, keys)]])
        pending = rng.random(q.size) < 0.6
        tkeys = tt.keys[:C].numpy()
        js, jf = jtbl._lookup_keys(jnp.asarray(tkeys), jnp.asarray(q), C)
        js, jf = np.asarray(js), np.asarray(jf)
        qt, pt = torch.from_numpy(q), torch.from_numpy(pending)
        for slot, found in (
                ttbl._lookup_keys(tt.keys, qt, ttbl._probe_seq(qt, C), pt),
                tref.find_slots(tt.keys, qt, pt, capacity=C)):
            assert slot.dtype == torch.int64
            assert np.array_equal(slot.numpy()[pending], js[pending])
            assert np.array_equal(found.numpy()[pending], jf[pending])
            assert np.all(slot.numpy()[~pending] == -1)
            assert not found.numpy()[~pending].any()
        # the case mix: hits, EMPTY stops, and chains with no stop at all
        assert jf[pending].any() and (~jf[pending] & (js[pending] >= 0)).any()
        assert (js == -1).any()
