"""The slate kernels (``csrc/slate_update.cu``, ``csrc/slate_lookup.cu``)
against their plain versions on the card.  Every kernel case needs a
CUDA card and skips without one; the file imports no JAX, so it runs
wherever the port does.  A few cases run anywhere: the wrappers refuse
CPU tensors (no fallback), and a library's build tag covers the shared
headers.

``slate_lookup``'s three routes (``cand``: given candidates; ``keys``:
the chain hashed in the kernel, first hit; ``find``: hashed, first hit
or ``EMPTY`` on pending rows) are held bitwise against their plain
versions at the key types' extremes, past TTL holes, on full chains, at
capacities that are not powers of two and at one where ``h1 + p * h2``
wraps past 2**32, and at batch sizes off the block; ``insert_or_find``
on the card (its walk on ``find``) equals the CPU's.

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
        dead = ~np.isin(keys, t.keys[:C].numpy())   # not the sink row
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


def _lookup_routes(tk, q, tv, C, pending):
    """The ``keys`` and ``find`` routes against their plain versions,
    bitwise; returns the kernel's ((slot, found, rows), (slot, found))."""
    from repro_torch.kernels.slate_lookup import kernel as k
    a = k.slate_lookup_keys(tk, q, tv, capacity=C)
    b = lookup_ref.slate_lookup_keys(tk, q, tv, C)
    fa = k.find_slots(tk, q, pending, capacity=C)
    fb = lookup_ref.find_slots(tk, q, pending, C)
    torch.cuda.synchronize()
    assert a[0].dtype == torch.int32 and fa[0].dtype == torch.int64
    for x, y in zip(a + fa, b + fb):
        assert (x is None and y is None) or torch.equal(x, y)
    return a, fa


@pytest.mark.parametrize("C", [1 << 14, 12289])
@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_lookup_keys_and_find_routes_match_ref_on_card(dev, C, key_dtype):
    """Live keys, keys killed by TTL (live ones sit past their holes) and
    absent keys, on an engine table (a sink row past the hashed
    capacity), at a power of two and a prime capacity."""
    t, live, dead = _populated(C, 6000, 6, key_dtype=key_dtype)
    q = torch.from_numpy(_queries(live, dead, 6, key_dtype)).to(dev)
    pending = torch.from_numpy(
        np.random.default_rng(7).random(q.numel()) < 0.7).to(dev)
    (_, found, _), _ = _lookup_routes(t.keys.to(dev), q, t.vals["v"].to(dev),
                                      C, pending)
    assert int(found.sum()) == live.size


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_lookup_routes_at_key_extremes(dev, key_dtype):
    """int32 extremes; int64 keys negative and past 2**32, whose halves
    the hash xor-folds; EMPTY itself as a query."""
    if key_dtype == np.int32:
        edge = [I32.max, I32.min, I32.max - 1, 0, 1, -2, 0x7FEB352D]
    else:
        edge = [2**63 - 1, -2**63, 2**32, 2**32 - 1, -2**32, 1 - 2**32,
                2**40 + 7, -(2**40) - 7, (5 << 32) | 5, 5]
    C = 509
    keys = np.array(edge, key_dtype)
    t = ttbl.make_table(C, {"v": ((8,), torch.float32)},
                        key_dtype=torch.from_numpy(keys).dtype, device="cpu")
    ttbl.insert_or_find(t, torch.from_numpy(keys),
                        torch.ones(keys.size, dtype=torch.bool))
    t.vals["v"].copy_(torch.arange((C + 1) * 8, dtype=torch.float32)
                      .reshape(C + 1, 8))
    q = torch.from_numpy(np.concatenate([keys, keys[::-1] ^ 1,
                                         np.array([-1], key_dtype)]))
    q, tk = q.to(dev), t.keys.to(dev)
    pending = torch.ones(q.numel(), dtype=torch.bool, device=dev)
    (_, found, _), _ = _lookup_routes(tk, q, t.vals["v"].to(dev), C, pending)
    assert bool(found[:keys.size].all())


def test_lookup_key_past_ttl_hole(dev):
    """Two keys share probe 0; the first is expired by TTL, leaving a hole
    before the second (at its probe 1).  ``keys`` finds the second key
    there; ``find`` stops at the hole, as an insert must."""
    from repro_torch.kernels.slate_lookup import kernel as k
    C = 61
    pool = torch.arange(1, 5000, dtype=torch.int32) * 7919
    first = ttbl._probe_seq(pool, C)[0]
    s0 = int(first[0])
    k1, k2 = pool[first == s0][:2].tolist()
    t = ttbl.make_table(C, {"v": ((8,), torch.float32)}, device="cpu")
    for key in (k1, k2):
        ttbl.insert_or_find(t, torch.tensor([key], dtype=torch.int32),
                            torch.ones(1, dtype=torch.bool))
    chain = ttbl._probe_seq(torch.tensor([k2], dtype=torch.int32), C)[:, 0]
    assert int(t.keys[s0]) == k1 and int(t.keys[chain[1]]) == k2
    t.ts.fill_(10)
    t.ts[s0] = 0
    ttbl.expire_ttl(t, torch.tensor(12, dtype=torch.int32), 5)
    assert int(t.keys[s0]) == ttbl.EMPTY
    q = torch.tensor([k2, k1], dtype=torch.int32, device=dev)
    pending = torch.ones(2, dtype=torch.bool, device=dev)
    (slot, found, _), (fslot, ffound) = _lookup_routes(
        t.keys.to(dev), q, t.vals["v"].to(dev), C, pending)
    assert slot.tolist() == [int(chain[1]), -1]
    assert found.tolist() == [True, False]
    assert fslot.tolist() == [s0, s0] and ffound.tolist() == [False, False]
    # the cand route on the same chain agrees with keys
    cand = ttbl._probe_seq(q, C).to(torch.int32)
    c = k.slate_lookup(t.keys.to(dev), q, cand, t.vals["v"].to(dev))
    assert torch.equal(c[0], slot) and torch.equal(c[1], found)


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_lookup_full_chains(dev, key_dtype):
    """Every slot taken: an absent key's 8 probes all hold other keys,
    so both routes give slot -1 and found False; present keys are
    found."""
    C = 16
    pool = (np.arange(400) * 1009 + 3).astype(key_dtype)
    if key_dtype == np.int64:
        pool = pool * (2**33 + 1)
    t = ttbl.make_table(C, {"v": ((8,), torch.float32)}, device="cpu",
                        key_dtype=torch.from_numpy(pool).dtype)
    for part in np.split(pool, 8):
        ttbl.insert_or_find(t, torch.from_numpy(part),
                            torch.ones(part.size, dtype=torch.bool))
    held = t.keys[:C].numpy()
    assert (held != ttbl.EMPTY).all()
    t.vals["v"].normal_(generator=torch.Generator().manual_seed(0))
    q = torch.from_numpy(np.concatenate([held[::3],
                                         pool[~np.isin(pool, held)][:7]]))
    q = q.to(dev)
    pending = torch.ones(q.numel(), dtype=torch.bool, device=dev)
    (slot, found, rows), (fslot, ffound) = _lookup_routes(
        t.keys.to(dev), q, t.vals["v"].to(dev), C, pending)
    n = held[::3].size
    assert bool(found[:n].all()) and not bool(found[n:].any())
    assert bool((slot[n:] == -1).all()) and bool((fslot[n:] == -1).all())
    assert bool((rows[n:] == 0).all()) and not bool(ffound[n:].any())


def test_lookup_wraps_past_2_32_before_the_modulus(dev):
    """C = 2**30 + 3 (4 GiB of int32 keys, D = 1): probe p's slot is
    (h1 + p * h2) mod 2**32, then mod C.  Each query's key sits at probe
    5, behind five slots of other keys, so both routes must walk the
    wrapped probes to reach it."""
    from repro_torch.core.hashing import hash_key
    C = 2**30 + 3
    gen = torch.Generator().manual_seed(3)
    q = torch.randint(-2**31, 2**31 - 1, (4096,), generator=gen,
                      dtype=torch.int32).unique()
    q = q[torch.randperm(q.numel(), generator=gen)]
    cand = ttbl._probe_seq(q, C)
    tk = torch.full((C + 1,), ttbl.EMPTY, dtype=torch.int32, device=dev)
    qd = q.to(dev)
    for p in range(5):
        tk[cand[p].to(dev)] = qd ^ 0x55555555
    tk[cand[5].to(dev)] = qd
    tv = torch.arange(C + 1, dtype=torch.float32, device=dev)[:, None]
    h1 = hash_key(q, salt=0xA11CE) % C
    h2 = hash_key(q, salt=0xB0B) % (C - 1) + 1
    pending = torch.ones(q.numel(), dtype=torch.bool, device=dev)
    (slot, found, _), (fslot, ffound) = _lookup_routes(tk, qd, tv, C,
                                                       pending)
    wrapped = (h1 + 5 * h2 >= 2**32).to(dev)
    at5 = slot.long() == cand[5].to(dev)
    assert bool((at5 & wrapped & found).any())
    assert bool((fslot == slot.long())[found].all())
    del tk, tv
    torch.cuda.empty_cache()


@pytest.mark.parametrize("Q", [0, 1, 63, 65, 1000])
def test_lookup_routes_off_the_block_and_nothing_pending(dev, Q):
    """Batch sizes that are not a multiple of the block (and none at
    all: no launch); ``find`` with nothing pending writes (-1, False)
    everywhere."""
    from repro_torch.kernels.slate_lookup import kernel as k
    C = 1 << 12
    t, live, dead = _populated(C, 1500, 9)
    q = torch.from_numpy(_queries(live, dead, 9, np.int32)[:Q]).to(dev)
    tk, tv = t.keys.to(dev), t.vals["v"].to(dev)
    before = k.slate_lookup.launches
    for pending in (torch.zeros(Q, dtype=torch.bool, device=dev),
                    torch.ones(Q, dtype=torch.bool, device=dev)):
        _, (fslot, ffound) = _lookup_routes(tk, q, tv, C, pending)
    assert k.slate_lookup.launches == before + (4 if Q else 0)
    slot, found = k.find_slots(tk, q, torch.zeros(Q, dtype=torch.bool,
                                                  device=dev), capacity=C)
    assert bool((slot == -1).all()) and not bool(found.any())


@pytest.mark.parametrize("D,offset", [(8, 0), (3, 0), (32, 0), (4, 1)])
def test_lookup_row_copy_vector_and_word_paths(dev, D, offset):
    """Rows as 16-byte vectors (D % 4 == 0, aligned), as words (D = 3, or
    a value matrix one element into its buffer), int32 values too."""
    C = 2048
    t, live, dead = _populated(C, 900, 10)
    buf = torch.randint(-2**31, 2**31 - 1, ((C + 1) * D + offset,),
                        dtype=torch.int32, device=dev)
    tv = buf[offset:].view(C + 1, D)
    q = torch.from_numpy(_queries(live, dead, 10, np.int32)).to(dev)
    pending = torch.ones(q.numel(), dtype=torch.bool, device=dev)
    (_, found, rows), _ = _lookup_routes(t.keys.to(dev), q, tv, C, pending)
    assert rows.shape == (q.numel(), D) and int(found.sum()) == live.size


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_insert_or_find_on_card_equals_cpu(dev, key_dtype):
    """Batches of unique keys, some masked, over a table that fills and
    drops: the card (each round's walk one ``find`` launch) gives the
    CPU's slots, found, placed, dropped and key layout."""
    from repro_torch.kernels.slate_lookup import kernel as k
    rng = np.random.default_rng(11)
    C = 509
    pool = rng.choice(2**31 - 2, size=1200, replace=False) - 2**30
    pool = torch.from_numpy(pool).to(key_dtype)
    if key_dtype == torch.int64:
        pool = pool * (2**32 + 3)
    spec = {"v": ((8,), torch.float32)}
    cpu = ttbl.make_table(C, spec, key_dtype=key_dtype, device="cpu")
    card = ttbl.make_table(C, spec, key_dtype=key_dtype, device=dev)
    for b in range(5):
        keys = pool[torch.from_numpy(rng.choice(pool.numel(), size=300,
                                                replace=False))]
        valid = torch.from_numpy(rng.random(300) < 0.9)
        before = dict(k.slate_lookup.launches_by_route)
        want = ttbl.insert_or_find(cpu, keys, valid)[1:]
        got = ttbl.insert_or_find(card, keys.to(dev), valid.to(dev))[1:]
        assert k.slate_lookup.launches_by_route == {
            **before, "find": before["find"] + ttbl.INSERT_ROUNDS}
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y), b
        assert torch.equal(card.keys[:C].cpu(), cpu.keys[:C]), b
        assert int(card.dropped) == int(cpu.dropped)
    assert int(cpu.dropped) > 0


def test_lookup_launches_by_route(dev):
    """Each wrapper counts one launch in ``launches`` and in its own
    route; an empty batch counts none."""
    from repro_torch.kernels.slate_lookup import kernel as k
    C = 1 << 10
    t, live, dead = _populated(C, 300, 12)
    tk, tv = t.keys.to(dev), t.vals["v"].to(dev)
    q = torch.from_numpy(_queries(live, dead, 12, np.int32)).to(dev)
    cand = ttbl._probe_seq(q, C).to(torch.int32)
    pend = torch.ones(q.numel(), dtype=torch.bool, device=dev)
    calls = {"cand": lambda x: k.slate_lookup(tk, x, cand[:, :x.numel()]
                                              .contiguous(), tv),
             "keys": lambda x: k.slate_lookup_keys(tk, x, tv, capacity=C),
             "find": lambda x: k.find_slots(tk, x, pend[:x.numel()],
                                            capacity=C)}
    for route, call in calls.items():
        before = dict(k.slate_lookup.launches_by_route)
        n = k.slate_lookup.launches
        call(q)
        call(q[:0])
        assert k.slate_lookup.launches == n + 1
        assert k.slate_lookup.launches_by_route == {
            **before, route: before[route] + 1}


def test_lookup_wrappers_refuse_cpu_tensors():
    """No quiet fallback: a kernel wrapper given CPU tensors raises, and
    so does the dispatcher asked for the kernel on a CPU table."""
    from repro_torch.kernels.slate_lookup import kernel as k
    from repro_torch.kernels.slate_lookup import ops
    keys = torch.full((9,), ttbl.EMPTY, dtype=torch.int32)
    q = torch.arange(4, dtype=torch.int32)
    vals = torch.zeros(9, 8)
    for call in (lambda: k.slate_lookup_keys(keys, q, vals, capacity=8),
                 lambda: k.find_slots(keys, q, q > 1, capacity=8),
                 lambda: k.slate_lookup(keys, q, ttbl._probe_seq(q, 8)
                                        .to(torch.int32), vals),
                 lambda: ops.slate_lookup(keys, q, vals, impl="cuda",
                                          capacity=8),
                 lambda: ops.lookup_slots(keys, q, 8, impl="cuda")):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


def test_build_tag_covers_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source, every ``csrc/*.cuh`` and the
    flags: editing a shared header (``hash32.cuh``) rebuilds every
    library, so none is reused stale."""
    from repro_torch.kernels import _build
    assert (_build.CSRC / "hash32.cuh").exists()
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("a")
    assert _build._lib_path("a") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._lib_path("a") != first
    assert first.name.startswith("liba-") and first.suffix == ".so"
