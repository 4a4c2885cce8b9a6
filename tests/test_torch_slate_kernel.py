"""The slate kernels (``csrc/slate_update.cu``, ``csrc/slate_lookup.cu``)
against their plain versions on the card.  Every case needs a CUDA card
and skips without one; the file imports no JAX, so it runs wherever the
port does.

``slate_update`` is held bitwise on integer-valued deltas (the counter
contract: any order of adds is exact) across the shapes its tile-parallel
scan must get right: runs that span many tiles, a one-key batch, batches
of one row and of no multiple of the tile, slots on rows that are not
the run's last (the inclusive-prefix contract), no slot at all, several
column groups, int64 keys; and on float deltas within the rounding of
two sums in different orders, giving the same bits on a second call."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.slate_lookup import ref as lookup_ref
from repro_torch.kernels.slate_update import ref as update_ref
from repro_torch.slates import table as ttbl

TILE = 512           # rows of one tile of the slate_update kernel
I32 = np.iinfo(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------- update
def _run_lengths_keys(lengths, dtype=np.int32):
    """Sorted keys whose runs have the given lengths (keys 0, 1, ...)."""
    return np.repeat(np.arange(len(lengths)), lengths).astype(dtype)


def _zipf_keys(rng, B, n_keys, alpha=1.2):
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -alpha
    return np.sort(rng.choice(n_keys, size=B, p=p / p.sum())).astype(np.int32)


def _slots(rng, keys, C, where="last"):
    """Distinct slots on run-last rows ("last"), on a random third of the
    rows ("any": slots on rows inside runs), or on no row ("none")."""
    B = keys.size
    slots = np.full(B, -1, np.int32)
    if where == "last":
        rows = np.flatnonzero(np.append(keys[1:] != keys[:-1], True))
    elif where == "any":
        rows = np.flatnonzero(rng.random(B) < 0.33)
        rows = np.union1d(rows, [B - 1])
    else:
        return slots
    slots[rows] = rng.choice(C, size=rows.size, replace=False)
    return slots


def _both(keys, deltas, slots, table, op, dev, key_dtype=torch.int32):
    """The kernel's and the plain version's tables on the card."""
    from repro_torch.kernels.slate_update import kernel as k
    kt = torch.from_numpy(keys).to(dev, key_dtype)
    dt = torch.from_numpy(deltas).to(dev)
    st = torch.from_numpy(slots).to(dev)
    before = k.slate_update.launches
    a = k.slate_update(kt, dt, st, torch.from_numpy(table).to(dev), op=op)
    assert k.slate_update.launches == before + 1
    b = update_ref.slate_update(kt, dt, st, torch.from_numpy(table).to(dev),
                                op=op)
    torch.cuda.synchronize()
    return a, b


def _ints(rng, B, D, C):
    deltas = rng.integers(0, 8, size=(B, D)).astype(np.float32)
    table = rng.integers(0, 100, size=(C, D)).astype(np.float32)
    return deltas, table


def _case(seed, B=256, D=8, C=512, integer=True, n_keys=40):
    """The engine's layout: Zipf keys, sink keys with zero deltas at the
    end, slots on run-last rows but the sink run's."""
    rng = np.random.default_rng(seed)
    keys = _zipf_keys(rng, B, n_keys)
    n_inv = int(rng.integers(0, B // 8))
    keys[B - n_inv:] = I32.max
    if integer:
        deltas, table = _ints(rng, B, D, C)
    else:
        deltas = rng.normal(size=(B, D)).astype(np.float32)
        table = np.abs(rng.normal(size=(C, D))).astype(np.float32)
    deltas[B - n_inv:] = 0
    slots = _slots(rng, keys, C)
    slots[B - 1] = -1 if n_inv else slots[B - 1]
    return keys, deltas, slots, table


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_update_kernel_matches_ref_on_card(dev, op, key_dtype):
    keys, deltas, slots, table = _case(8, B=4096, D=16, C=1 << 14,
                                       n_keys=600)
    a, b = _both(keys, deltas, slots, table, op, dev, key_dtype)
    assert torch.equal(a, b)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("name,lengths", [
    # one run over 80 tiles between short ones, and one over 3 tiles
    ("long run", [3, 5 * TILE // 2, 80 * TILE + 17, 1, 2, 3 * TILE, 9]),
    # a run per tile boundary: each ends one row into the next tile
    ("boundaries", [TILE + 1] + [TILE] * 5 + [7]),
    ("one key", [65536]),
    ("one key, 5 windows of look-back", [140 * TILE + 5]),
    ("one row", [1]),
    ("no multiple of the tile", [100] * 30 + [1]),
])
def test_update_kernel_runs_across_tiles(dev, op, name, lengths):
    rng = np.random.default_rng(len(name))
    keys = _run_lengths_keys(lengths)
    C = max(2 * len(lengths), 64)
    deltas, table = _ints(rng, keys.size, 8, C)
    slots = _slots(rng, keys, C)
    a, b = _both(keys, deltas, slots, table, op, dev)
    assert torch.equal(a, b), name


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("B", [1, 1023, 1025, 3 * TILE + 200])
def test_update_kernel_slots_inside_runs_fold_inclusive_prefixes(dev, op, B):
    """Slots on rows that are not their run's last: each folds the prefix
    of its run up to and including itself."""
    rng = np.random.default_rng(B)
    keys = _zipf_keys(rng, B, 7)
    C = 2 * B
    deltas, table = _ints(rng, B, 8, C)
    slots = _slots(rng, keys, C, "any")
    a, b = _both(keys, deltas, slots, table, op, dev)
    assert torch.equal(a, b)
    # the plain version's prefix, against a loop
    pre = update_ref.run_prefixes(torch.from_numpy(keys),
                                  torch.from_numpy(deltas), op=op).numpy()
    acc = np.zeros(8, np.float32)
    for i in range(B):
        d = deltas[i] if op == "sum" else np.maximum(deltas[i], 0)
        new_run = i == 0 or keys[i] != keys[i - 1]
        acc = d if new_run else (acc + d if op == "sum"
                                 else np.maximum(acc, d))
        assert np.array_equal(pre[i], acc)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_update_kernel_without_slots_leaves_table_bitwise(dev, op):
    """No row has a slot: a table of -0.0 keeps every bit."""
    rng = np.random.default_rng(10)
    keys = _zipf_keys(rng, 5000, 50)
    deltas, _ = _ints(rng, 5000, 8, 1)
    table = np.full((512, 8), -0.0, np.float32)
    a, b = _both(keys, deltas, _slots(rng, keys, 512, "none"), table, op,
                 dev)
    assert torch.equal(a, b)
    assert bool(torch.signbit(a).all())


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("D", [8, 16, 40])
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_update_kernel_column_groups_and_key_widths(dev, op, D, key_dtype):
    """D of 8, 16 and 40 (the serving slate: 32 tokens and a count,
    padded to 40) over several tiles; int64 keys beyond 2**32, negative
    ones included, in the same order as the int32 keys."""
    rng = np.random.default_rng(D)
    B = 5 * TILE + 333
    keys = _zipf_keys(rng, B, 300)
    if key_dtype == torch.int64:
        keys = (keys.astype(np.int64) - 150) * (2**33 + 7)
    C = 4096
    deltas, table = _ints(rng, B, D, C)
    a, b = _both(keys, deltas, _slots(rng, keys, C), table, op, dev,
                 key_dtype)
    assert torch.equal(a, b)


def test_update_kernel_float_sums_within_tolerance_and_repeatable(dev):
    """Float deltas: within 2 (n + 1) 2**-24 (|table| + sum |d|) of the
    plain version, n the run's length (each sum of n terms lies within
    (n + 1) 2**-24 of that mass of the exact one); two calls give the
    same bits."""
    from repro_torch.kernels.slate_update import kernel as k
    rng = np.random.default_rng(11)
    keys = _run_lengths_keys([7, 3 * TILE + 5, 1, 200, 9 * TILE, 3])
    B, C = keys.size, 64
    deltas = rng.normal(size=(B, 8)).astype(np.float32)
    table = rng.normal(size=(C, 8)).astype(np.float32)
    slots = _slots(rng, keys, C)
    a, b = _both(keys, deltas, slots, table, "sum", dev)
    again = k.slate_update(torch.from_numpy(keys).to(dev),
                           torch.from_numpy(deltas).to(dev),
                           torch.from_numpy(slots).to(dev),
                           torch.from_numpy(table).to(dev))
    torch.cuda.synchronize()
    assert torch.equal(a, again)
    seg = np.cumsum(np.append(True, keys[1:] != keys[:-1])) - 1
    n = np.bincount(seg).astype(np.float64)
    mass = np.zeros((n.size, 8))
    np.add.at(mass, seg, np.abs(deltas))
    tol = np.zeros_like(table, np.float64)
    w = slots >= 0
    tol[slots[w]] = 2 * (n[seg[w], None] + 1) * 2.0**-24 * (
        mass[seg[w]] + np.abs(table[slots[w]]))
    err = np.abs(a.cpu().numpy().astype(np.float64) - b.cpu().numpy())
    assert np.all(err <= tol)


def test_update_kernel_leaves_its_scratch_zero(dev):
    """Each launch leaves the status words as it found them (zero), so
    the next launch needs no reset from the host."""
    from repro_torch.kernels.slate_update import kernel as k
    rng = np.random.default_rng(12)
    keys = _run_lengths_keys([3 * TILE, 17, 2 * TILE])
    deltas, table = _ints(rng, keys.size, 16, 8)
    for _ in range(2):
        a, _ = _both(keys, deltas, _slots(rng, keys, 8), table, "sum", dev)
        assert not bool(k._scratch[a.device].any())


# ---------------------------------------------------------------- lookup
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
        dead = ~np.isin(keys, t.keys.numpy())
    live = keys[placed.numpy() & ~dead]
    return t, live, keys[dead]


def _queries(live, dead, seed, dtype):
    rng = np.random.default_rng(seed)
    absent = rng.integers(-5, 5, 20).astype(dtype) * 7919 + 3
    q = np.concatenate([live, dead, absent])
    return q[rng.permutation(q.size)]


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_lookup_kernel_matches_ref_on_card(dev, key_dtype):
    from repro_torch.kernels.slate_lookup import kernel as k
    C = 1 << 14
    t, live, dead = _populated(C, 6000, 6, key_dtype=key_dtype)
    q = torch.from_numpy(_queries(live, dead, 6, key_dtype)).to(dev)
    tk, tv = t.keys.to(dev), t.vals["v"].to(dev)
    cand = ttbl._probe_seq(q, C).to(torch.int32)
    a = k.slate_lookup(tk, q, cand, tv)
    b = lookup_ref.slate_lookup(tk, q, cand, tv)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
