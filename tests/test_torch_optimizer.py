"""Port parity of the training step's optimizer and collectives:
``distributed/optimizer.py`` (AdamW with global-norm clipping) and
``distributed/collectives.py`` (int8 error-feedback compression) against
the JAX package's, on numpy inputs, plus the JAX package's own tests of
both (``tests/test_collectives.py``) run on the port.

AdamW does the JAX package's elementwise f32 arithmetic in its order, but
XLA:CPU contracts multiply-adds into fused ones (``b1 * m + (1 - b1) *
g`` once ``m`` is not 0, ``p - lr * (step + wd * p)``), and PyTorch's CPU
``sqrt`` is not correctly rounded (XLA's and numpy's are).  So: ``count``
and ``lr`` equal the JAX package's; without clipping (the scale exactly
1) ``m`` and ``v`` are bitwise after the first step (``m`` and ``v``
start at 0, so nothing is contracted); afterwards, and with clipping
(the scale comes from the global norm, whose sum runs in another order),
``m`` and ``v`` agree within 1e-6 of each leaf's largest magnitude; the
parameters within four f32 ulps of their own magnitude.

The quantize round trip is bitwise (blocks, scales, pad, x_hat; the
error too, eager); jitted XLA contracts ``x - q * scale`` into one fused
multiply-add, so there the error agrees within one f32 ulp of max |x|."""
import socket

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.distributed import collectives as j_coll
from repro.distributed import optimizer as j_adamw
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import optimizer as adamw

ULP4 = 4 * 2.0**-24   # four f32 ulps, relative


def _tree(rng, scale=1.0):
    """A parameter-shaped numpy tree: dicts, a list, a ``None``."""
    r = lambda *sh: (rng.standard_normal(sh) * scale).astype(np.float32)
    return {"w": r(64, 33), "blk": [r(7), None, {"z": r(3, 4)}],
            "a": r(5, 2)}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("clip", [1e6, 1.0])
def test_adamw_update_matches_jax(clip):
    """Three updates of the same numpy parameters and gradients (new
    gradients each step, warm-up over 3 steps), with and without
    clipping."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg = dict(clip_norm=clip, warmup_steps=3)
    jcfg, tcfg = j_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp, jo = params, j_adamw.init(params)
    tp = _t(params)
    to = adamw.init(tp)
    jupd = jax.jit(lambda p, g, o: j_adamw.update(p, g, o, jcfg))
    for step in range(3):
        grads = _tree(rng, 3.0)
        jp, jo, jm = jupd(jp, grads, jo)
        tp2, to, tm = adamw.update(tp, _t(grads), to, tcfg)
        assert tp2 is tp                       # updated in place
        assert int(to.count) == int(jo.count) == step + 1
        assert to.count.dtype == torch.int32
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        for want, got in zip(_leaves(jp), adamw.leaves(tp)):
            np.testing.assert_allclose(got.numpy(), want, rtol=ULP4,
                                       atol=0)
        for name in ("m", "v"):
            for want, got in zip(_leaves(getattr(jo, name)),
                                 adamw.leaves(getattr(to, name))):
                if clip > 1e3 and step == 0:
                    assert np.array_equal(got.numpy(), want), name
                else:
                    np.testing.assert_allclose(
                        got.numpy(), want, rtol=0,
                        atol=1e-6 * float(np.abs(want).max()))


def test_adamw_minimizes_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    for _ in range(200):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt, m = adamw.update(params, grads, opt, cfg)
    assert torch.allclose(params["w"], target, atol=0.05)
    assert int(opt.count) == 200


def test_grad_clip_caps_update():
    params = {"w": torch.zeros(4)}
    opt = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=1)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw.update(params, grads, opt, cfg)
    assert float(metrics["grad_norm"]) > 1e6   # raw norm reported


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4096])
def test_quantize_roundtrip_is_jax_bitwise(n):
    """``quantize_int8`` (blocks, scales, pad) and ``compress_decompress``
    (x_hat, err) against the JAX package's, eager and jitted."""
    x = (np.random.default_rng(n).standard_normal(n) * 5).astype(np.float32)
    tq, ts, tpad = coll.quantize_int8(torch.from_numpy(x))
    txh, terr = coll.compress_decompress(torch.from_numpy(x))
    jpad = j_coll.quantize_int8(jnp.asarray(x))[2]
    assert tpad == jpad and tq.dtype == torch.int8
    for jitted in (False, True):
        fn = jax.jit if jitted else (lambda f: f)
        jq, js = fn(lambda a: j_coll.quantize_int8(a)[:2])(jnp.asarray(x))
        jxh, jerr = fn(j_coll.compress_decompress)(jnp.asarray(x))
        for got, want in ((tq, jq), (ts, js), (txh, jxh)):
            assert np.array_equal(got.numpy(), np.asarray(want))
        if jitted:
            np.testing.assert_allclose(terr.numpy(), np.asarray(jerr),
                                       rtol=0, atol=2.0**-23 * np.abs(x).max())
        else:
            assert np.array_equal(terr.numpy(), np.asarray(jerr))


def test_quantize_roundtrip_bound():
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(1000)
                          * 5).astype(np.float32))
    xhat, err = coll.compress_decompress(x)
    # per-block max / 127 bounds the elementwise error
    assert float(err.abs().max()) <= float(x.abs().max()) / 127 + 1e-6
    assert torch.allclose(xhat + err, x, atol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 256, 999, 4096])
def test_quantize_any_length(n):
    x = torch.linspace(-3, 7, n)
    xhat, err = coll.compress_decompress(x)
    assert xhat.shape == x.shape
    assert float(err.abs().max()) < 0.1


def test_error_feedback_unbiased_over_steps():
    """With error feedback, the *accumulated* compressed sum tracks the
    accumulated true sum (compression error does not accumulate)."""
    rng = np.random.default_rng(1)
    err = torch.zeros(257)
    acc_hat = torch.zeros(257)
    acc_true = torch.zeros(257)
    for _ in range(50):
        g = torch.from_numpy((rng.standard_normal(257) * 0.1 + 0.05
                              ).astype(np.float32))
        acc_true = acc_true + g
        ghat, err = coll.compress_decompress(g + err)
        acc_hat = acc_hat + ghat
    drift = float((acc_hat - acc_true).abs().max())
    assert drift < 0.02, drift


def test_compressed_psum_tree_one_rank_matches_jax():
    """Without a group the sum is the one rank's, as a one-device
    ``psum`` inside ``shard_map``: the JAX package's sums bit for bit
    (the error buffer within one ulp, jitted XLA's fused multiply-add),
    and ``out + err`` gives the input back."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_host_mesh
    rng = np.random.default_rng(2)
    g = {"w": rng.standard_normal((64, 8)).astype(np.float32),
         "b": [rng.standard_normal(300).astype(np.float32)]}
    e = {"w": (rng.standard_normal((64, 8)) * 0.01).astype(np.float32),
         "b": [np.zeros(300, np.float32)]}
    mesh = make_host_mesh(n_data=1, n_model=1)
    jout, jerr = jax.jit(shard_map(
        lambda gs, es: j_coll.compressed_psum_tree(gs, es, "data"),
        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
        check_rep=False))(g, e)
    tout, terr = coll.compressed_psum_tree(_t(g), _t(e))
    for want, got in zip(_leaves(jout), adamw.leaves(tout)):
        assert np.array_equal(got.numpy(), want)
    for want, got, x, y in zip(_leaves(jerr), adamw.leaves(terr),
                               _leaves(g), _leaves(e)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2.0**-23 * np.abs(x + y).max())
    tg, te = _t(g), _t(e)
    for o, r, x, y in zip(adamw.leaves(tout), adamw.leaves(terr),
                          adamw.leaves(tg), adamw.leaves(te)):
        assert torch.allclose(o + r, x + y, atol=1e-6)
    assert torch.equal(coll.global_batch_psum(torch.ones(3)), torch.ones(3))


def test_compressed_psum_tree_sums_over_a_gloo_group(tmp_path):
    """Two processes in a gloo group: rank 0's result is the sum of both
    ranks' dequantized payloads, and its error buffer its own."""
    import torch.multiprocessing as mp
    from tests import _gloo_sum
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "rank0.pt")
    mp.spawn(_gloo_sum.worker, args=(2, port, out), nprocs=2, join=True)
    res = torch.load(out)
    want, err0 = None, None
    for rank in range(2):
        g = _gloo_sum.grads_of(rank)
        local = adamw.map_tree(lambda x: coll.compress_decompress(x), g)
        xh = adamw.map_tree(lambda x: coll.compress_decompress(x)[0], g)
        want = xh if want is None else adamw.map_tree(torch.add, want, xh)
        if rank == 0:
            err0 = adamw.map_tree(lambda x: coll.compress_decompress(x)[1],
                                  g)
        del local
    for got, w in zip(adamw.leaves(res["summed"]), adamw.leaves(want)):
        assert torch.equal(got, w)
    for got, w in zip(adamw.leaves(res["err"]), adamw.leaves(err0)):
        assert torch.equal(got, w)
    assert float(res["total"]) == 3.0
