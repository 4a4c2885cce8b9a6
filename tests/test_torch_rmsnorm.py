"""Port parity: the plain RMSNorm (``kernels/rmsnorm/ref.py``, the
``rmsnorm`` kernel's oracle) against the JAX package's ``ref`` oracle and
its Pallas ``rmsnorm`` kernel in interpret mode, on the same numpy inputs;
and the model's norm layer (``models/layers/norms.py::apply``), which
now dispatches to ``kernels/rmsnorm``, equal to the plain version bit for
bit on the CPU.

Tolerances are those of the JAX package's own kernel sweep
(``tests/test_kernels.py::test_rmsnorm_sweep``): 5e-5 for f32, 2e-2 for
bf16 (one bf16 rounding of outputs of magnitude ~1 is 2**-8)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.rmsnorm.kernel import rmsnorm as j_rms_k
from repro.kernels.rmsnorm.ref import rmsnorm as j_rms
from repro_torch.kernels.rmsnorm import ops as t_ops
from repro_torch.kernels.rmsnorm import ref as t_ref
from repro_torch.models.layers import norms

TOL = {"float32": 5e-5, "bfloat16": 2e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _err(a, b):
    a = a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,D,offset", [(64, 64, False), (100, 128, True),
                                           (256, 32, False)])
def test_rmsnorm_plain_matches_jax_ref_and_interpret(rows, D, offset, dt):
    rng = np.random.default_rng(rows + D)
    x = rng.standard_normal((2, rows, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    jx, tx = jnp.asarray(x, J_DT[dt]), torch.from_numpy(x).to(T_DT[dt])
    got = t_ops.rmsnorm(tx, torch.from_numpy(w), scale_offset=offset)
    assert got.dtype == T_DT[dt] and got.shape == tx.shape
    want = j_rms(jx, jnp.asarray(w), scale_offset=offset)
    assert _err(got, want) < TOL[dt]
    want_k = j_rms_k(jx, jnp.asarray(w), scale_offset=offset, block_rows=32,
                     interpret=True)
    assert _err(got, want_k) < TOL[dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [False, True])
def test_norms_apply_is_the_plain_rmsnorm_bitwise(offset, dt):
    """The layer adds nothing of its own: on the CPU it gives exactly the
    plain version's bits (the math of the JAX layer, unchanged)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((3, 5, 96)) * 4).astype(
        np.float32)).to(T_DT[dt])
    w = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    got = norms.apply({"scale": w}, x, eps=1e-5, scale_offset=offset)
    want = t_ops.rmsnorm(x, w, eps=1e-5, scale_offset=offset, impl="ref")
    assert got.dtype == x.dtype and torch.equal(got, want)
    assert torch.equal(want, t_ref.rmsnorm(x, w, eps=1e-5,
                                           scale_offset=offset))


def test_rmsnorm_dispatch_refuses_the_card_path_on_cpu():
    """``impl="cuda"`` never falls back: a CPU tensor raises."""
    x, w = torch.ones(2, 8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.rmsnorm(x, w, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        t_ops.rmsnorm(x, w, impl="pallas")
