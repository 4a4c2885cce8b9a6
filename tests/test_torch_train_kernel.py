"""The training slice's kernels on the card: the backward kernels
(``csrc/flash_attention_bwd.cu``, ``csrc/rmsnorm_bwd.cu``) against their
plain versions (autograd of the plain forwards, ``kernels/attention/
ref.py::mha_bwd``, ``kernels/rmsnorm/ref.py::rmsnorm_bwd``), each case on
the route the wrapper names (``flash_attention_bwd``: ``wgmma`` for bf16
with head dims that are multiples of 16 read 16 bytes at a time,
``simt`` for the rest; ``rmsnorm_bwd``: ``regs`` for rows of at most 4
vectors a lane on aligned tensors, ``loop`` for the rest), repeatable bit
for bit; the ``torch.autograd.Function`` wrappers that bind each to its
forward kernel (``kernels/attention/ops.py``, ``kernels/rmsnorm/
ops.py``), end to end; and the training step on the card (a resumed run
bitwise equal to a straight one; zamba2 raises, its ``ssd_scan`` having
no backward kernel).  Every case needs a CUDA card and skips without
one; the file imports no JAX, so it runs wherever the port does.

Tolerances: bf16 gradients within 2**-5 of the reference gradient's
largest magnitude (the port's bf16 convention, ``tests/test_torch_
models.py``), f32 within 1e-4 of it."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want):
    tol = 2.0**-5 if want.dtype == torch.bfloat16 else 1e-4
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err


def _moved(before, after):
    return {r: n - before[r] for r, n in after.items() if n != before[r]}


def _attn_bwd_case(dev, q, k, v, do, kw, route):
    """The backward of the forward kernel's output on ``route`` (asserted,
    and only its counter moved), two calls bitwise equal, each gradient
    within tolerance of the plain version's; returns the gradients."""
    from repro_torch.kernels.flash_attention import kernel as fk
    o, lse = fk.flash_attention(q, k, v, lse=True, **kw)
    assert torch.equal(o, fk.flash_attention(q, k, v, **kw))
    assert fk.bwd_route(q, k, v, o, do) == route
    n = fk.flash_attention_bwd.launches
    before = dict(fk.flash_attention_bwd.launches_by_route)
    got = fk.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fk.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fk.flash_attention_bwd.launches == n + 2
    assert _moved(before, fk.flash_attention_bwd.launches_by_route) == {
        route: 2}
    want = attn_ref.mha_bwd(q, k, v, do, **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g, w)
    return got


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,Dv,dt,kw,route", [
    (2, 256, 256, 14, 2, 64, 64, torch.bfloat16, {}, "wgmma"),   # qwen2
    (4, 1024, 1024, 14, 2, 64, 64, torch.bfloat16, {}, "wgmma"),  # full S
    (1, 300, 300, 4, 1, 256, 256, torch.bfloat16, {"window": 64},
     "wgmma"),                                                    # gemma3
    (2, 64, 200, 6, 6, 64, 64, torch.bfloat16, {"causal": False},
     "wgmma"),                                                    # cross
    (1, 128, 128, 4, 4, 192, 128, torch.bfloat16, {}, "wgmma"),  # MLA
    (1, 50, 90, 4, 2, 32, 48, torch.bfloat16,
     {"window": 30, "q_offset": 40}, "wgmma"),                    # q_offset
    (2, 100, 160, 8, 1, 128, 128, torch.bfloat16, {"q_offset": 60},
     "wgmma"),                                                    # MQA
    (1, 130, 130, 16, 1, 64, 64, torch.bfloat16, {},
     "wgmma"),                                 # 16 heads: f32 partials
    (1, 70, 70, 2, 1, 16, 32, torch.bfloat16, {"causal": False},
     "wgmma"),                                                    # narrow
    (2, 130, 130, 4, 2, 64, 64, torch.float32, {}, "simt"),
    (1, 50, 90, 4, 2, 24, 40, torch.float32,
     {"window": 30, "q_offset": 40}, "simt"),
    (1, 77, 77, 3, 1, 72, 72, torch.bfloat16, {"window": 20}, "simt"),
])
def test_flash_attention_bwd_matches_plain(B, Sq, Skv, H, Hkv, Dh, Dv, dt,
                                           kw, route):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dt)
    q, k, v = r(B, Sq, H, Dh), r(B, Skv, Hkv, Dh), r(B, Skv, Hkv, Dv)
    _attn_bwd_case(dev, q, k, v, r(B, Sq, H, Dv), kw, route)


def test_flash_attention_bwd_reads_a_transposed_do():
    """dO as autograd may hand it over, a transposed view ([B, H, S, Dv]
    memory read as [B, S, H, Dv]): the wgmma route reads it through its
    strides and gives the contiguous copy's bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = r(2, 200, 14, 64), r(2, 200, 2, 64), r(2, 200, 2, 64)
    do = r(2, 14, 200, 64).transpose(1, 2)
    assert not do.is_contiguous()
    got = _attn_bwd_case(dev, q, k, v, do, {}, "wgmma")
    from repro_torch.kernels.flash_attention import kernel as fk
    o, lse = fk.flash_attention(q, k, v, lse=True)
    for g, c in zip(got, fk.flash_attention_bwd(q, k, v, o, lse,
                                                do.contiguous())):
        assert torch.equal(g, c)


def test_flash_attention_bwd_unaligned_view_takes_simt():
    """bf16 q, k and v one element into their buffers cannot be read 16
    bytes at a time: the backward takes the CUDA-core route."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)

    def view(*sh):
        buf = torch.randn(*sh[:-1], sh[-1] + 1, generator=gen,
                          device=dev).to(torch.bfloat16)
        return buf[..., 1:]

    q, k, v = view(2, 96, 4, 64), view(2, 96, 2, 64), view(2, 96, 2, 64)
    do = torch.randn(2, 96, 4, 64, generator=gen, device=dev).to(
        torch.bfloat16)
    _attn_bwd_case(dev, q, k, v, do, {}, "simt")


@pytest.mark.parametrize("rows,D,dt,off,route", [
    (4096, 896, torch.bfloat16, False, "regs"),    # the training shape
    (4096, 896, torch.bfloat16, True, "regs"),
    (4097, 896, torch.bfloat16, False, "regs"),    # 3 rows a warp, ragged
    (37, 512, torch.float32, True, "regs"),        # f32, 4 vectors a lane
    (3, 256, torch.bfloat16, False, "regs"),       # a vector a lane
    (1000, 2048, torch.float32, False, "loop"),
    (37, 1000, torch.float32, True, "loop"),
    (5, 99, torch.bfloat16, False, "loop"),
])
def test_rmsnorm_bwd_matches_plain(rows, D, dt, off, route):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rows, D, generator=gen, device=dev).to(dt)
    w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
    dy = torch.randn(rows, D, generator=gen, device=dev).to(dt)
    _rms_bwd_case(x, w, dy, off, route)


def _rms_bwd_case(x, w, dy, off, route):
    from repro_torch.kernels.rmsnorm import kernel as rk
    before = dict(rk.rmsnorm_bwd.launches_by_route)
    got = rk.rmsnorm_bwd(x, w, dy, eps=1e-6, scale_offset=off)
    again = rk.rmsnorm_bwd(x, w, dy, eps=1e-6, scale_offset=off)
    assert _moved(before, rk.rmsnorm_bwd.launches_by_route) == {route: 2}
    want = rms_ref.rmsnorm_bwd(x, w, dy, eps=1e-6, scale_offset=off)
    torch.cuda.synchronize()
    for g, a, wt in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g, wt)


def test_rmsnorm_bwd_unaligned_x_takes_the_loop():
    """x one element into its buffer (contiguous, not 16-byte aligned):
    the loop route, at the training shape."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    rows, D = 4096, 896
    buf = torch.randn(rows * D + 1, generator=gen, device=dev).to(
        torch.bfloat16)
    x = buf[1:].view(rows, D)
    w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
    dy = torch.randn(rows, D, generator=gen, device=dev).to(torch.bfloat16)
    _rms_bwd_case(x, w, dy, False, "loop")


def test_autograd_functions_run_both_kernels():
    """Through the dispatchers, tensors that need gradients take the
    kernel forward and the kernel backward (counted), and the gradients
    are the plain versions'; tensors that need none take the forward
    kernel alone, as serving does."""
    dev = _card()
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    gen = torch.Generator(device=dev).manual_seed(2)
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = r(2, 96, 4, 64), r(2, 96, 2, 64), r(2, 96, 2, 64)
    x, w = r(2, 96, 256), 1 + 0.1 * torch.randn(256, generator=gen,
                                                device=dev)
    counts = lambda: (fk.flash_attention.launches,
                      fk.flash_attention_bwd.launches, rk.rmsnorm.launches,
                      rk.rmsnorm_bwd.launches)
    c0 = counts()
    attn_ops.mha(q, k, v)
    rms_ops.rmsnorm(x, w)
    assert [b - a for a, b in zip(c0, counts())] == [1, 0, 1, 0]

    def loss(impl):
        qg, kg, vg, xg, wg = (t.detach().requires_grad_(True)
                              for t in (q, k, v, x, w))
        y = attn_ops.mha(qg, kg, vg, impl=impl)
        z = rms_ops.rmsnorm(xg, wg, impl=impl)
        out = (y.float().square().sum() + (z.float() * x.float()).sum())
        return torch.autograd.grad(out, (qg, kg, vg, xg, wg))

    c0 = counts()
    got = loss("auto")
    assert [b - a for a, b in zip(c0, counts())] == [1, 1, 1, 1]
    want = loss("ref")
    for g, wt in zip(got, want):
        _close(g, wt)


def _tiny(arch):
    from repro_torch.configs import get_config, reduced_config
    if arch == "qwen2-0.5b":
        return get_config(arch).replace(n_layers=2, d_model=64, n_heads=4,
                                        n_kv_heads=2, d_ff=128,
                                        vocab_size=512, head_dim=16)
    return reduced_config(arch)


def test_train_step_on_the_card_resumes_bitwise(tmp_path):
    """The training step on the card, kernels forward and backward: six
    steps straight equal three, a checkpoint, a new ``Trainer`` restored
    from it and three more, bit for bit."""
    dev = _card()
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import optimizer as adamw
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.train import Trainer
    cfg = _tiny("qwen2-0.5b")
    n = fk.flash_attention_bwd.launches
    a = Trainer(cfg, device=dev)
    p, o = a.init(0)
    p, o, la = a.run(p, o, iter(TokenStream(cfg.vocab_size, 2, 64, seed=0)),
                     6)
    assert fk.flash_attention_bwd.launches == n + 6 * cfg.n_layers
    stream = iter(TokenStream(cfg.vocab_size, 2, 64, seed=0))
    b = Trainer(cfg, ckpt_dir=str(tmp_path), ckpt_every=3, device=dev)
    p1, o1 = b.init(0)
    with pytest.raises(RuntimeError, match="simulated"):
        b.run(p1, o1, stream, 6, fail_at=3)
    b.ckpt.wait()
    c = Trainer(cfg, ckpt_dir=str(tmp_path), ckpt_every=100, device=dev)
    p2, o2 = c.maybe_restore(*c.init(0))
    p2, o2, lc = c.run(p2, o2, stream, 6)
    assert lc == la[3:]
    for x, y in zip(adamw.leaves(p.tree()) + adamw.leaves(o.m)
                    + adamw.leaves(o.v), adamw.leaves(p2.tree())
                    + adamw.leaves(o2.m) + adamw.leaves(o2.v)):
        assert torch.equal(x, y)
    for t in (a, b, c):
        t.close()


def test_zamba2_train_step_on_the_card_raises():
    dev = _card()
    from repro_torch.launch.train import Trainer
    cfg = _tiny("zamba2-1.2b")
    tr = Trainer(cfg, device=dev)
    p, o = tr.init(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64)),
             "labels": torch.randint(0, cfg.vocab_size, (2, 64))}
    with pytest.raises(NotImplementedError, match="item 22"):
        tr.run(p, o, iter([batch]), 1)
