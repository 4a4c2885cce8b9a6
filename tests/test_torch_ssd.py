"""Port parity: the plain chunked SSD recurrence (``kernels/ssd/ref.py``:
``ssd``, the ``ssd_scan`` kernel's oracle, and ``ssd_step``, the decode
recurrence) against the JAX package's ``ref`` oracle and its Pallas
``ssd_scan`` kernel in interpret mode, on the same numpy inputs.

Tolerances are those of the JAX package's own kernel sweep
(``tests/test_kernels.py::test_ssd_scan_sweep``): y within ``TOL[dtype]``
(5e-5 f32, 2e-2 bf16) of ``max|y| + 1``, the final f32 state within
5e-4 of ``max|state| + 1`` (the two packages sum in different orders).
The dispatcher takes the plain version for CPU tensors."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.ssd.ref import ssd as j_ssd
from repro.kernels.ssd.ref import ssd_step as j_ssd_step
from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_scan
from repro_torch.kernels.ssd import ops as t_ops
from repro_torch.kernels.ssd import ref as t_ref

TOL = {"float32": 5e-5, "bfloat16": 2e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SWEEP = [(2, 128, 2, 16, 16, 32),
         (1, 200, 3, 32, 16, 64),     # pad path
         (2, 256, 1, 8, 64, 128)]


def _inputs(B, S, H, N, P, seed):
    """q, k, v and log_a (= -softplus(normal) <= 0) as in the JAX sweep."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, N)).astype(np.float32)
    k = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    la = -np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    return q, k, v, la


def _pair(x, dt):
    return jnp.asarray(x, J_DT[dt]), torch.from_numpy(x).to(T_DT[dt])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _check(y, fin, jy, jfin, dt):
    assert y.shape == tuple(jy.shape) and fin.shape == tuple(jfin.shape)
    assert y.dtype == T_DT[dt] and fin.dtype == torch.float32
    ey = np.abs(_f32(y) - _f32(jy)).max()
    assert ey / (np.abs(_f32(jy)).max() + 1.0) < TOL[dt], ey
    ef = np.abs(_f32(fin) - _f32(jfin)).max()
    assert ef / (np.abs(_f32(jfin)).max() + 1.0) < 5e-4, ef


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,N,P,chunk", SWEEP)
def test_ssd_plain_matches_jax_ref_and_interpret(B, S, H, N, P, chunk, dt):
    q, k, v, la = _inputs(B, S, H, N, P, seed=S + N)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dt) for x in (q, k, v))
    y, fin = t_ops.ssd(tq, tk, tv, torch.from_numpy(la), chunk=chunk)
    jy, jfin = j_ssd(jq, jk, jv, jnp.asarray(la), chunk=chunk)
    _check(y, fin, jy, jfin, dt)
    jy2, jfin2 = j_ssd_scan(jq, jk, jv, jnp.asarray(la), chunk=chunk,
                            interpret=True)
    _check(y, fin, jy2, jfin2, dt)


def test_ssd_plain_takes_head_broadcast_views():
    """Mamba-2 passes q and k as [B,S,H,N] views of one [B,S,N] tensor
    (head stride 0): the same result as materialised copies."""
    B, S, H, N, P = 2, 70, 4, 16, 8
    q, k, v, la = _inputs(B, S, 1, N, P, seed=5)
    v = np.random.default_rng(6).standard_normal((B, S, H, P)).astype(
        np.float32)
    la = np.repeat(la, H, axis=2)
    tq = torch.from_numpy(q).expand(B, S, H, N)
    tk = torch.from_numpy(k).expand(B, S, H, N)
    assert tq.stride(2) == 0
    y, fin = t_ref.ssd(tq, tk, torch.from_numpy(v), torch.from_numpy(la),
                       chunk=32)
    jy, jfin = j_ssd(jnp.asarray(np.repeat(q, H, 2)),
                     jnp.asarray(np.repeat(k, H, 2)), jnp.asarray(v),
                     jnp.asarray(la), chunk=32)
    _check(y, fin, jy, jfin, "float32")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_ssd_step_matches_jax(dt):
    B, H, N, P = 3, 4, 16, 8
    rng = np.random.default_rng(7)
    state = rng.standard_normal((B, H, N, P)).astype(np.float32)
    q, k = (rng.standard_normal((B, H, N)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, P)).astype(np.float32)
    la = -np.logaddexp(rng.standard_normal((B, H)), 0).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dt) for x in (q, k, v))
    js, jy = j_ssd_step(jnp.asarray(state), jq, jk, jv, jnp.asarray(la))
    ts, ty = t_ops.ssd_step(torch.from_numpy(state), tq, tk, tv,
                            torch.from_numpy(la))
    assert ts.dtype == torch.float32 and ty.dtype == T_DT[dt]
    assert np.abs(_f32(ts) - _f32(js)).max() < 1e-5
    assert np.abs(_f32(ty) - _f32(jy)).max() / (
        np.abs(_f32(jy)).max() + 1.0) < TOL[dt]


def test_ssd_step_replay_matches_scan_tail():
    """The port's decode recurrence, replayed step by step, agrees with its
    own chunked scan (as the JAX package's test_ssd_step_matches_scan_tail
    does for its oracle)."""
    B, S, H, N, P = 1, 33, 2, 8, 8
    q, k, v, la = (torch.from_numpy(x) for x in _inputs(B, S, H, N, P, 8))
    y_all, state_all = t_ref.ssd(q, k, v, la, chunk=16)
    state = torch.zeros((B, H, N, P))
    for t in range(S):
        state, y_t = t_ref.ssd_step(state, q[:, t], k[:, t], v[:, t],
                                    la[:, t])
        assert torch.allclose(y_t, y_all[:, t], atol=1e-4)
    assert torch.allclose(state, state_all, atol=1e-4)


def test_ssd_initial_state_matches_jax():
    """The plain version carries an ``initial_state``; "auto" takes the
    plain version for it (the JAX package's rule: its kernel starts from
    zero only), and ``impl="cuda"`` hands it to the kernel (which takes
    one: the route over a sequence split across ranks scans from the
    carried state), whose wrapper raises for CPU tensors."""
    B, S, H, N, P = 2, 40, 2, 8, 16
    q, k, v, la = _inputs(B, S, H, N, P, seed=9)
    s0 = np.random.default_rng(10).standard_normal((B, H, N, P)).astype(
        np.float32)
    y, fin = t_ops.ssd(*(torch.from_numpy(x) for x in (q, k, v, la)),
                       chunk=16, initial_state=torch.from_numpy(s0))
    jy, jfin = j_ssd(*(jnp.asarray(x) for x in (q, k, v, la)), chunk=16,
                     initial_state=jnp.asarray(s0))
    _check(y, fin, jy, jfin, "float32")
    # and the state carried over equals one scan over both halves
    t = [torch.from_numpy(x) for x in (q, k, v, la)]
    y1, f1 = t_ref.ssd(*(x[:, :24] for x in t), chunk=16)
    y2, f2 = t_ref.ssd(*(x[:, 24:] for x in t), chunk=16, initial_state=f1)
    yw, fw = t_ref.ssd(*t, chunk=16)
    assert torch.allclose(torch.cat([y1, y2], 1), yw, atol=1e-4)
    assert torch.allclose(f2, fw, atol=1e-4)
    with pytest.raises(ValueError, match="a CUDA device"):
        t_ops.ssd(*t, chunk=16, initial_state=f1, impl="cuda")
