"""Port parity: the fused slate update.  The port's plain version
(``kernels/slate_update/ref.py``) is held against the JAX package's
oracle: bitwise for the sum monoid under the counter contract
(integer-valued f32) and for max, within a stated tolerance for float
sums.  The CUDA kernel is held against the plain version on the card in
``tests/test_torch_slate_kernel.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.slate_update import ref as jref
from repro_torch.kernels.slate_update import ops as tops
from repro_torch.kernels.slate_update import ref as tref

# Float sums: the port adds a run in another order than the JAX
# segment_sum.  Each sum of n f32 terms is within n * 2**-24 * sum|terms|
# of the exact sum; 1e-5 relative to the run's absolute mass (plus the
# table row's magnitude) covers runs of up to ~160 terms with margin.
FLOAT_RTOL = 1e-5


def _zipf_sorted(rng, B, n_keys, alpha=1.2, dtype=np.int32):
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -alpha
    keys = rng.choice(n_keys, size=B, p=p / p.sum())
    return np.sort(keys).astype(dtype)


def _case(seed, B=256, D=8, C=512, integer=True, n_keys=40):
    rng = np.random.default_rng(seed)
    keys = _zipf_sorted(rng, B, n_keys)
    # the engine's invalid rows: sink keys at the end with zero deltas
    n_inv = int(rng.integers(0, B // 8))
    keys[B - n_inv:] = np.iinfo(np.int32).max
    if integer:
        deltas = rng.integers(0, 8, size=(B, D)).astype(np.float32)
        table = rng.integers(0, 100, size=(C, D)).astype(np.float32)
    else:
        deltas = rng.normal(size=(B, D)).astype(np.float32)
        table = rng.normal(size=(C, D)).astype(np.float32)
        table = np.abs(table)
    deltas[B - n_inv:] = 0
    last = np.concatenate([keys[1:] != keys[:-1], [True]])
    slots = np.full(B, -1, np.int32)
    slots[last] = rng.choice(C, size=int(last.sum()), replace=False)
    slots[B - 1] = -1 if n_inv else slots[B - 1]   # sink run never writes
    return keys, deltas, slots, table


def _jax(keys, deltas, slots, table, op):
    return np.asarray(jref.slate_update(
        jnp.asarray(keys), jnp.asarray(deltas),
        jnp.asarray(slots), jnp.asarray(table), op=op))


def _port(keys, deltas, slots, table, op, impl="auto"):
    return tops.slate_update(torch.from_numpy(keys), torch.from_numpy(deltas),
                             torch.from_numpy(slots),
                             torch.from_numpy(table.copy()), op=op,
                             impl=impl).numpy()


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ref_bitwise_under_counter_contract(op, seed):
    args = _case(seed)
    assert np.array_equal(_jax(*args, op), _port(*args, op))


def test_ref_all_duplicate_run():
    rng = np.random.default_rng(9)
    B, D, C = 300, 16, 64
    keys = np.full(B, 5, np.int32)
    deltas = rng.integers(0, 8, size=(B, D)).astype(np.float32)
    slots = np.full(B, -1, np.int32)
    slots[-1] = 17
    table = np.zeros((C, D), np.float32)
    for op in ("sum", "max"):
        assert np.array_equal(_jax(keys, deltas, slots, table, op),
                              _port(keys, deltas, slots, table, op))


def test_ref_float_sum_within_tolerance_and_max_bitwise():
    keys, deltas, slots, table = _case(4, integer=False)
    want = _jax(keys, deltas, slots, table, "sum")
    got = _port(keys, deltas, slots, table, "sum")
    seg = np.cumsum(np.concatenate([[True], keys[1:] != keys[:-1]])) - 1
    mass = np.zeros_like(deltas)
    np.add.at(mass, seg, np.abs(deltas))
    bound = np.zeros_like(table)
    ok = slots >= 0
    bound[slots[ok]] = mass[seg[ok]]
    assert np.all(np.abs(got - want) <= FLOAT_RTOL * (bound + np.abs(table)))
    assert np.array_equal(_jax(keys, deltas, slots, table, "max"),
                          _port(keys, deltas, slots, table, "max"))


@pytest.mark.parametrize("op", ["sum", "max"])
def test_run_totals_matches_jax(op):
    keys, deltas, _, _ = _case(5)
    want = np.asarray(jref.run_totals(jnp.asarray(keys), jnp.asarray(deltas),
                                      op=op))
    got = tref.run_totals(torch.from_numpy(keys), torch.from_numpy(deltas),
                          op=op).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_int64_keys_give_int32_segment_id_tables(op):
    """Keys are compared only for equality: int64 keys (>= 2**33,
    negative) give the same table as their int32 run ids."""
    keys, deltas, slots, table = _case(6)
    seg = (np.cumsum(np.concatenate([[0], keys[1:] != keys[:-1]]))
           .astype(np.int32))
    wide = (seg.astype(np.int64) - 40) * (2**33 + 7)
    assert np.all(np.diff(wide) >= 0)
    a = _port(seg, deltas, slots, table, op)
    b = _port(wide, deltas, slots, table, op)
    assert np.array_equal(a, b)


def test_cpu_tensor_never_reaches_the_kernel():
    from repro_torch.kernels.slate_update import kernel as k
    args = _case(7)
    before = k.slate_update.launches
    _port(*args, "sum")          # auto on CPU -> the plain version
    assert k.slate_update.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        _port(*args, "sum", impl="cuda")


@pytest.mark.parametrize("op", ["sum", "max"])
def test_ref_rows_without_slot_leave_table_bitwise(op):
    """Rows with no slot write nothing the JAX oracle would not: a table
    of -0.0 keeps its sign bits where no run lands, also when no row of
    the batch has a slot."""
    keys, deltas, slots, _ = _case(10)
    table = np.full((512, 8), -0.0, np.float32)
    for s in (slots, np.full_like(slots, -1)):
        want = _jax(keys, deltas, s, table, op)
        got = _port(keys, deltas, s, table, op)
        assert np.array_equal(np.signbit(want), np.signbit(got))
        assert np.array_equal(want, got)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("seed", [11, 12])
def test_ref_slots_inside_runs_fold_inclusive_prefixes(op, seed):
    """The kernel's contract: a slot on a row that is not its run's last
    folds the run's prefix up to that row (the TPU kernel's segmented
    scan; the JAX oracle's run totals agree on run-last rows).  Held
    against a loop, and on run-last rows against the JAX oracle."""
    rng = np.random.default_rng(seed)
    B, D, C = 700, 8, 2048
    keys = _zipf_sorted(rng, B, 30)
    deltas = rng.integers(-3, 8, size=(B, D)).astype(np.float32)
    table = rng.integers(0, 100, size=(C, D)).astype(np.float32)
    slots = np.full(B, -1, np.int32)
    rows = np.flatnonzero(rng.random(B) < 0.4)
    slots[rows] = rng.choice(C, size=rows.size, replace=False)
    want = table.copy()
    acc = np.zeros(D, np.float32)
    for i in range(B):
        d = deltas[i] if op == "sum" else np.maximum(deltas[i], 0)
        if i == 0 or keys[i] != keys[i - 1]:
            acc = d
        else:
            acc = acc + d if op == "sum" else np.maximum(acc, d)
        if slots[i] >= 0:
            r = slots[i]
            want[r] = want[r] + acc if op == "sum" \
                else np.maximum(want[r], acc)
    assert np.array_equal(_port(keys, deltas, slots, table, op), want)
    last = np.append(keys[1:] != keys[:-1], True)
    only_last = np.where(last, slots, -1)
    assert np.array_equal(_port(keys, deltas, only_last, table, op),
                          _jax(keys, deltas, only_last, table, op))


@pytest.mark.parametrize("op", ["sum", "max"])
def test_run_prefixes_end_in_run_totals(op):
    keys, deltas, _, _ = _case(13)
    pre = tref.run_prefixes(torch.from_numpy(keys), torch.from_numpy(deltas),
                            op=op)
    tot = tref.run_totals(torch.from_numpy(keys), torch.from_numpy(deltas),
                          op=op)
    last = torch.from_numpy(np.append(keys[1:] != keys[:-1], True))
    assert torch.equal(pre[last], tot[last])
