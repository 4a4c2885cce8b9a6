"""Port parity: the plain attention versions (``kernels/attention/ref.py::
mha``, the flash_attention kernel's oracle, and ``kernels/decode_attention/
ref.py::decode_attend``) against the JAX package's ``ref`` oracles and its
Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances are those of the JAX package's own kernel sweep
(``tests/test_kernels.py``): 5e-5 for f32, 2e-2 for bf16 (one bf16 rounding
of outputs of magnitude ~1 is 2**-8; the two packages sum in different
orders).  The dispatchers take the plain version for CPU tensors."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.attention.ref import mha as j_mha
from repro.kernels.decode_attention.kernel import decode_attention as j_dec_k
from repro.kernels.decode_attention.ref import decode_attend as j_dec
from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro_torch.kernels.attention import ops as t_attn
from repro_torch.kernels.decode_attention import ops as t_dec

TOL = {"float32": 5e-5, "bfloat16": 2e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x, dt):
    """One numpy array in both packages' dtype (bf16 rounds identically)."""
    return jnp.asarray(x, J_DT[dt]), torch.from_numpy(x).to(T_DT[dt])


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,Hkv,Dh,Dv,causal,window,q_offset,chunk",
    [
        (2, 128, 128, 4, 2, 64, 64, True, 0, 0, 512),
        (1, 256, 256, 2, 1, 128, 128, True, 0, 0, 512),
        (1, 192, 192, 4, 4, 32, 32, True, 48, 0, 512),    # window
        (2, 96, 96, 2, 2, 64, 64, False, 0, 0, 512),      # bidirectional
        (1, 130, 130, 2, 1, 64, 64, True, 0, 0, 64),      # pad / chunks
        (1, 64, 192, 2, 1, 64, 64, True, 0, 128, 512),    # q_offset
        (2, 96, 96, 4, 2, 64, 32, True, 0, 0, 512),       # Dv != Dh
    ])
def test_mha_plain_matches_jax(B, Sq, Skv, H, Hkv, Dh, Dv, causal, window,
                               q_offset, chunk, dt):
    rng = np.random.default_rng(Sq * 7 + Dh)
    jq, tq = _pair(rng.standard_normal((B, Sq, H, Dh), np.float32), dt)
    jk, tk = _pair(rng.standard_normal((B, Skv, Hkv, Dh), np.float32), dt)
    jv, tv = _pair(rng.standard_normal((B, Skv, Hkv, Dv), np.float32), dt)
    got = t_attn.mha(tq, tk, tv, causal=causal, window=window,
                     q_offset=q_offset, chunk=chunk)
    assert got.dtype == T_DT[dt] and got.shape == (B, Sq, H, Dv)
    ref = j_mha(jq, jk, jv, causal=causal, window=window, q_offset=q_offset,
                chunk=chunk)
    interp = j_flash(jq, jk, jv, causal=causal, window=window,
                     q_offset=q_offset, block_q=64, block_k=64,
                     interpret=True)
    assert _err(_f32(got), ref) < TOL[dt]
    assert _err(_f32(got), interp) < TOL[dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,S,H,Hkv,Dh,Dv,window", [
    (2, 1, 256, 4, 2, 64, 64, 0),
    (3, 1, 200, 4, 1, 32, 32, 64),          # window, rep 4
    (1, 1, 512, 8, 8, 128, 128, 0),
    (4, 1, 96, 14, 2, 64, 64, 0),           # qwen2's 7 query heads a group
    (2, 2, 128, 4, 2, 64, 32, 0),           # two query rows, Dv != Dh
])
def test_decode_attend_plain_matches_jax(B, Sq, S, H, Hkv, Dh, Dv, window,
                                         dt):
    rng = np.random.default_rng(S + Dh + Sq)
    jq, tq = _pair(rng.standard_normal((B, Sq, H, Dh), np.float32), dt)
    jk, tk = _pair(rng.standard_normal((B, S, Hkv, Dh), np.float32), dt)
    jv, tv = _pair(rng.standard_normal((B, S, Hkv, Dv), np.float32), dt)
    lens = rng.integers(window + 1, S + 1, B).astype(np.int32)
    lens[0] = S                             # one request at the full cache
    got = t_dec.decode_attend(tq, tk, tv, torch.from_numpy(lens),
                              window=window)
    assert got.dtype == T_DT[dt] and got.shape == (B, Sq, H, Dv)
    ref = j_dec(jq, jk, jv, jnp.asarray(lens), window=window)
    interp = j_dec_k(jq, jk, jv, jnp.asarray(lens), window=window,
                     block_k=64, interpret=True)
    assert _err(_f32(got), ref) < TOL[dt]
    assert _err(_f32(got), interp) < TOL[dt]


def test_decode_attend_f32_query_over_bf16_cache():
    """The model's f32-compute case: an f32 query over the bf16 caches;
    the probabilities are cast to bf16 before the PV product, as in the
    JAX oracle."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 32), np.float32)
    jk, tk = _pair(rng.standard_normal((2, 64, 2, 32), np.float32),
                   "bfloat16")
    jv, tv = _pair(rng.standard_normal((2, 64, 2, 32), np.float32),
                   "bfloat16")
    lens = np.array([64, 17], np.int32)
    got = t_dec.decode_attend(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(lens))
    assert got.dtype == torch.float32
    ref = j_dec(jnp.asarray(q), jk, jv, jnp.asarray(lens))
    assert _err(got.numpy(), ref) < TOL["float32"]


def test_dispatchers_keep_cpu_tensors_on_the_plain_version():
    """On the CPU the dispatchers run the plain version; asking for the
    kernel there raises instead of falling back."""
    q = torch.zeros(1, 8, 2, 8)
    lens = torch.ones(1, dtype=torch.int32)
    assert torch.equal(t_attn.mha(q, q, q),
                       t_attn.mha(q, q, q, impl="ref"))
    assert torch.equal(t_dec.decode_attend(q, q, q, lens),
                       t_dec.decode_attend(q, q, q, lens, impl="ref"))
    with pytest.raises(ValueError, match="CUDA"):
        t_attn.mha(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        t_dec.decode_attend(q, q, q, lens, impl="cuda")
