"""Port parity of the training loss and its gradients, part 2: the
families beside plain attention (zamba2-1.2b, xlstm-350m,
deepseek-v2-lite-16b) at their reduced configs.  Part 1,
``test_torch_train_dense.py``, holds the attention families and the
loss's pieces; the shared setup is ``tests/_train_ref.py`` (JAX
parameters perturbed in numpy and carried over through ``convert``,
inputs from a numpy seed).  Tolerances, f32 on both sides: the loss
within 1e-5 relative, each gradient leaf within 1e-4 of its largest
magnitude.

zamba2's gradients are NaN in the JAX package itself once a chunk's
summed decay passes ~88 (``kernels/ssd/ref.py``: ``jnp.where(tri,
jnp.exp(dmat), 0.0)`` overflows above the diagonal, and the backward of
the masked ``exp`` is inf * 0), as at 40 tokens here; the port's plain
SSD is the same math and gives NaN at the same places (ROADMAP queue 3).
The 40-token case holds the NaN positions equal and the rest within the
tolerance; a 12-token case, whose decay stays finite, holds every
gradient."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests import _train_ref as R


@pytest.mark.parametrize("arch,S,nans", [
    ("zamba2-1.2b", 40, True),
    ("zamba2-1.2b", 12, False),
    ("xlstm-350m", 40, False),
    ("deepseek-v2-lite-16b", 40, False),
])
def test_train_loss_and_grads_match_jax(arch, S, nans):
    """``lm.train_loss`` and the gradient of every parameter leaf, f32,
    on S tokens with labels masked at -100 (deepseek: the routed experts'
    aux loss included; its f32 routing is the JAX package's bit for
    bit)."""
    jcfg, tcfg, jm, params, tm = R.setup(arch)
    b = R.batch(jcfg, 2, S)
    jl, jg = R.jax_loss_grads(jm, params, b)
    tl, tg = R.port_loss_grads(tm, b)
    assert np.isfinite(jl) and abs(tl - jl) <= R.LOSS_RTOL * abs(jl)
    has_nan = any(np.isnan(np.asarray(v)).any()
                  for v in R.flat(jg).values())
    assert has_nan == nans
    R.check_grads(jg, tg, same_nans=nans)
