"""Port parity: hashing and probe sequences, bitwise against the JAX
package.  int32 keys go through ``repro.core.hashing`` /
``repro.slates.table._probe_seq``; int64 keys (which the JAX lane only
hashes under x64) are held against the package's numpy mirrors
``fold_u32_np`` + ``_mix32_np``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import hashing as jh
from repro.slates import table as jtbl
from repro_torch.core import hashing as th
from repro_torch.slates import table as ttbl

I32 = np.iinfo(np.int32)
EDGE32 = np.array([0, 1, -1, -2, 7, I32.max, I32.min, I32.max - 1,
                   I32.min + 1, 0x7FEB352D, -0x846CA68B >> 1], np.int32)


def _keys32(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    rand = rng.integers(I32.min, I32.max, size=n, dtype=np.int64)
    return np.concatenate([EDGE32, rand.astype(np.int32)])


def _keys64(seed=1, n=2000):
    rng = np.random.default_rng(seed)
    big = rng.integers(2**33, 2**62, size=n, dtype=np.int64)
    neg = -rng.integers(1, 2**62, size=n, dtype=np.int64)
    edge = np.array([0, -1, 2**33, 2**33 + 5, -(2**33), 2**63 - 1,
                     -(2**63), 2**32 - 1, 2**32, I32.max, I32.min],
                    np.int64)
    return np.concatenate([edge, big, neg])


def test_mul32_wraps_like_uint32():
    """The 16-bit split gives uint32 products; the int64 wrap the issue
    mentions is pinned too (0xFFFFFFFF * 0x846CA68B)."""
    x = torch.tensor([0xFFFFFFFF, 0, 1, 0x12345678], dtype=torch.int64)
    got = th._mul32(x, 0x846CA68B)
    want = (np.array([0xFFFFFFFF, 0, 1, 0x12345678], np.uint32)
            * np.uint32(0x846CA68B))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert int(got[0]) == 0x7B935975
    wrapped = (x[:1] * 0x846CA68B) & 0xFFFFFFFF
    assert int(wrapped[0]) == 0x7B935975


@pytest.mark.parametrize("salt", [0, 0xA11CE, 0xB0B, 0xFFFFFFFF])
def test_hash_key_int32_bitwise(salt):
    keys = _keys32()
    want = np.asarray(jh.hash_key(jnp.asarray(keys), salt=salt))
    got = th.hash_key(torch.from_numpy(keys), salt=salt)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("salt", [0, 0xA11CE, 0xB0B])
def test_hash_key_int64_matches_numpy_mirror(salt):
    keys = _keys64()
    want = jh._mix32_np(jh.fold_u32_np(keys) ^ np.uint32(salt))
    got = th.hash_key(torch.from_numpy(keys), salt=salt)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # the port's own numpy mirrors agree with the JAX package's
    assert np.array_equal(th.fold_u32_np(keys), jh.fold_u32_np(keys))
    assert np.array_equal(th._mix32_np(keys.astype(np.uint32)),
                          jh._mix32_np(keys.astype(np.uint32)))


def test_fold_is_identity_for_int32_and_xor_for_int64():
    k32 = _keys32()
    assert np.array_equal(th.fold_u32(torch.from_numpy(k32)).numpy(),
                          k32.astype(np.uint32).astype(np.int64))
    k64 = _keys64()
    assert np.array_equal(th.fold_u32(torch.from_numpy(k64)).numpy(),
                          jh.fold_u32_np(k64).astype(np.int64))


@pytest.mark.parametrize("capacity", [97, 1000, 4093, 4096, 2**22 + 3])
def test_probe_seq_int32_bitwise(capacity):
    keys = _keys32(seed=capacity)
    want = np.asarray(jtbl._probe_seq(jnp.asarray(keys), capacity))
    got = ttbl._probe_seq(torch.from_numpy(keys), capacity)
    assert got.shape == (ttbl.PROBES, keys.size) == want.shape
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("capacity", [97, 4093, 2**31 - 1])
def test_probe_seq_int64_matches_numpy_mirror(capacity):
    """The JAX sequence in uint32 numpy: h1 + step*h2 wraps at 2**32
    before the modulus (visible at capacities near 2**31)."""
    keys = _keys64(seed=capacity)
    h = lambda s: jh._mix32_np(jh.fold_u32_np(keys) ^ np.uint32(s))
    h1 = h(0xA11CE) % np.uint32(capacity)
    h2 = h(0xB0B) % np.uint32(capacity - 1) + np.uint32(1)
    steps = np.arange(ttbl.PROBES, dtype=np.uint32)[:, None]
    want = (h1[None] + steps * h2[None]) % np.uint32(capacity)
    got = ttbl._probe_seq(torch.from_numpy(keys), capacity)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
