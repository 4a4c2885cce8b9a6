"""The SSM-serving kernels (``csrc/ssd_scan.cu``, ``csrc/rmsnorm.cu``)
against their plain versions on the card — at the serving shapes of
``chip_smoke.py`` phase 3, across chunks, on the pad path, with q and k
as head-broadcast views, in f32, on each route (``ssd_scan``: "mma" and
"simt"; ``rmsnorm``: "regs" and "loop"; the route asserted) — and the
port's serving ``Engine`` on the card against the same run on the CPU for the reduced zamba2.  Every
case needs a CUDA card and skips without one; the file imports no JAX,
so it runs wherever the port does.

Tolerances are the JAX package's kernel sweep's (tests/test_kernels.py):
``ssd_scan``'s y within 2e-2 (bf16) / 5e-5 (f32) of ``max|y| + 1`` and
its final state within 5e-4 of ``max|state| + 1``.  ``rmsnorm`` within
5e-5 in f32; in bf16 each value within one bf16 ulp (2**-7 of its
magnitude) of the plain version's: the kernel's and torch's f32 sums and
``rsqrt`` differ in their last bits, which may round a bf16 output to
its neighbour (at the magnitudes of these inputs, up to ~20, one ulp is
more than the sweep's 2e-2).  Both kernels sum in a fixed order, so two
calls on the same inputs give the same bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.ssd import ref as ssd_ref

TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _ssd_inputs(gen, B, S, H, N, P, dt, dev, shared_qk):
    """q, k ([B,S,H,N]; head-broadcast views of [B,S,N] when
    ``shared_qk``, as Mamba-2 passes them), v, and log_a <= 0."""
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    if shared_qk:
        q = r(B, S, 1, N).to(dt).expand(B, S, H, N)
        k = (r(B, S, 1, N) * 0.3).to(dt).expand(B, S, H, N)
    else:
        q, k = r(B, S, H, N).to(dt), (r(B, S, H, N) * 0.3).to(dt)
    v = r(B, S, H, P).to(dt)
    la = -torch.nn.functional.softplus(r(B, S, H))
    return q, k, v, la


@pytest.mark.parametrize("B,S,H,N,P,chunk,dt,shared_qk,route", [
    (8, 256, 64, 64, 64, 256, torch.bfloat16, True, "mma"),  # serving
    (8, 256, 64, 64, 64, 256, torch.bfloat16, False, "mma"), # q, k per head
    (1, 1024, 8, 64, 64, 256, torch.bfloat16, True, "mma"),  # 4 chunks
    (1, 200, 3, 32, 16, 64, torch.bfloat16, False, "mma"),   # pad path
    (2, 256, 4, 64, 32, 256, torch.bfloat16, False, "mma"),  # P != N
    (2, 130, 4, 64, 64, 256, torch.float32, True, "simt"),   # f32, S < chunk
    (2, 256, 2, 8, 128, 128, torch.float32, False, "simt"),  # N 8, P 128
    (1, 96, 2, 128, 32, 32, torch.bfloat16, False, "mma"),   # N 128, chunk 32
    (1, 100, 2, 24, 16, 64, torch.bfloat16, False, "simt"),  # N 24
])
def test_ssd_scan_matches_plain_on_card(B, S, H, N, P, chunk, dt,
                                        shared_qk, route):
    dev = _card()
    from repro_torch.kernels.ssd_scan import kernel as sk
    gen = torch.Generator(device=dev).manual_seed(S + N + P)
    q, k, v, la = _ssd_inputs(gen, B, S, H, N, P, dt, dev, shared_qk)
    assert sk.route(q, k, v, chunk) == route
    n = sk.ssd_scan.launches
    by_route = sk.ssd_scan.launches_by_route[route]
    y, fin = sk.ssd_scan(q, k, v, la, chunk=chunk)
    y2, fin2 = sk.ssd_scan(q, k, v, la, chunk=chunk)
    wy, wfin = ssd_ref.ssd(q, k, v, la, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == n + 2
    assert sk.ssd_scan.launches_by_route[route] == by_route + 2
    assert y.dtype == dt and y.shape == wy.shape
    assert fin.dtype == torch.float32 and fin.shape == wfin.shape
    assert torch.equal(y, y2) and torch.equal(fin, fin2)     # deterministic
    ey = float((y.float() - wy.float()).abs().max())
    assert ey / (float(wy.float().abs().max()) + 1.0) < TOL[dt], ey
    ef = float((fin - wfin).abs().max())
    assert ef / (float(wfin.abs().max()) + 1.0) < 5e-4, ef


@pytest.mark.parametrize("offset", [0, 1])
def test_ssd_scan_routes_on_the_serving_values_on_card(offset):
    """The serving shape's bf16 values, as aligned views (the tensor-core
    route) and as views one element into their buffers (the CUDA-core
    route): each within the tolerances of the plain version, bitwise
    repeatable, and counted under its route alone."""
    dev = _card()
    from repro_torch.kernels.ssd_scan import kernel as sk
    gen = torch.Generator(device=dev).manual_seed(7)
    B, S, H, N, P = 8, 256, 64, 64, 64

    def view(*shape, scale=1.0):    # rows of 16-byte units, then offset
        buf = (torch.randn(*shape[:-1], shape[-1] + 8, generator=gen,
                           device=dev) * scale).to(torch.bfloat16)
        return buf[..., offset:offset + shape[-1]]

    q = view(B, S, 1, N).expand(B, S, H, N)
    k = view(B, S, 1, N, scale=0.3).expand(B, S, H, N)
    v = view(B, S, H, P)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=dev))
    route = ("simt", "mma")[offset == 0]
    assert sk.route(q, k, v) == route
    before = dict(sk.ssd_scan.launches_by_route)
    y, fin = sk.ssd_scan(q, k, v, la)
    y2, fin2 = sk.ssd_scan(q, k, v, la)
    wy, wfin = ssd_ref.ssd(q, k, v, la)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in
            sk.ssd_scan.launches_by_route.items()} == {
        r: 2 * int(r == route) for r in sk.ROUTES}
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    ey = float((y.float() - wy.float()).abs().max())
    assert ey / (float(wy.float().abs().max()) + 1.0) < 2e-2, ey
    ef = float((fin - wfin).abs().max())
    assert ef / (float(wfin.abs().max()) + 1.0) < 5e-4, ef


def test_ssd_dispatch_takes_the_kernel_by_the_shape_rule():
    """``ops.ssd`` runs the kernel on CUDA tensors whose shape
    ``supported()`` takes and the plain version otherwise (N % 8 != 0, or
    an initial state), as the JAX package's dispatcher does."""
    dev = _card()
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd_scan import kernel as sk
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, la = _ssd_inputs(gen, 1, 64, 2, 16, 16, torch.float32, dev,
                              False)
    n = sk.ssd_scan.launches
    ops.ssd(q, k, v, la, chunk=32)
    assert sk.ssd_scan.launches == n + 1
    ops.ssd(q[..., :12], k[..., :12], v, la, chunk=32)     # N = 12
    ops.ssd(q, k, v, la, chunk=32, initial_state=torch.zeros(
        1, 2, 16, 16, device=dev))
    assert sk.ssd_scan.launches == n + 1
    with pytest.raises(ValueError):
        sk.ssd_scan(q.cpu(), k.cpu(), v.cpu(), la.cpu())


@pytest.mark.parametrize("rows,D,offset,dt", [
    (2048, 2048, False, torch.bfloat16),     # block norms at prefill
    (2048, 4096, False, torch.bfloat16),     # mamba's gated norm
    (8, 2048, False, torch.bfloat16),        # a decode step
    (8, 4096, True, torch.bfloat16),         # scale_offset
    (2048, 2048, False, torch.float32),      # f32
    (37, 1000, True, torch.float32),         # D not a multiple of 8
    (5, 99, False, torch.bfloat16),          # odd D: scalar loads
    (8, 896, False, torch.bfloat16),         # qwen2 decode: a warp a row
    (2048, 896, False, torch.bfloat16),      # qwen2 prefill
])
def test_rmsnorm_matches_plain_on_card(rows, D, offset, dt):
    dev = _card()
    from repro_torch.kernels.rmsnorm import kernel as rk
    gen = torch.Generator(device=dev).manual_seed(rows + D)
    x = (torch.randn(rows, D, generator=gen, device=dev) * 3).to(dt)
    w = torch.randn(D, generator=gen, device=dev)
    n = rk.rmsnorm.launches
    route = rk.plan(rows, D, dt).route
    by_route = rk.rmsnorm.launches_by_route[route]
    got = rk.rmsnorm(x, w, eps=1e-5, scale_offset=offset)
    again = rk.rmsnorm(x, w, eps=1e-5, scale_offset=offset)
    want = rms_ref.rmsnorm(x, w, eps=1e-5, scale_offset=offset)
    torch.cuda.synchronize()
    assert rk.rmsnorm.launches == n + 2
    assert rk.rmsnorm.launches_by_route[route] == by_route + 2
    assert route == ("loop" if D % 8 else "regs")
    assert got.dtype == dt and got.shape == x.shape
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs()
    if dt == torch.bfloat16:
        assert bool((err <= 2.0**-7 * want.float().abs()).all()), \
            float(err.max())
    else:
        assert float(err.max()) < TOL[dt]
    with pytest.raises(ValueError):
        rk.rmsnorm(x.t(), w[:rows])             # not contiguous


def test_rmsnorm_unaligned_view_takes_the_loop_on_card():
    """A row view one element into its buffer cannot be read 16 bytes at
    a time: the loop route, the same values as the plain version."""
    dev = _card()
    from repro_torch.kernels.rmsnorm import kernel as rk
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(8 * 2049, generator=gen, device=dev).to(
        torch.bfloat16)[1:1 + 8 * 2048].view(8, 2048)
    w = torch.randn(2048, generator=gen, device=dev)
    before = rk.rmsnorm.launches_by_route["loop"]
    got = rk.rmsnorm(x, w)
    want = rms_ref.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rk.rmsnorm.launches_by_route["loop"] == before + 1
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2.0**-7 * want.float().abs()).all())


def test_zamba2_serving_engine_on_card_equals_cpu():
    """LMServeMapper -> RequestSlate on the engine, reduced zamba2, on the
    card and on the CPU: every request's tokens equal but where a bf16
    near-tie flips one, and the card run went through ``ssd_scan``,
    ``rmsnorm`` and both attention kernels."""
    dev = _card()
    from types import SimpleNamespace

    from repro_torch import convert
    from repro_torch.configs import reduced_config
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.workflow import Workflow
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.ml import LMServeMapper, RequestSlate, request_source
    from repro_torch.models import lm

    max_new = 6
    cfg = reduced_config("zamba2-1.2b")
    model, _ = lm.init(lm.build(cfg), torch.Generator().manual_seed(0))
    params = convert.lm_params_to_numpy(model)
    rng = np.random.default_rng(2)
    reqs = [SimpleNamespace(rid=i + 1, prompt=rng.integers(
        1, 512, int(rng.integers(8, 41))).astype(np.int32))
        for i in range(12)]

    def run(device):
        m = convert.lm_params_from_numpy(params, cfg, device=device)
        mapper = LMServeMapper(cfg, m, max_new=max_new, cache_len=48,
                               bucket=4)
        mapper.subscribes = ("requests",)
        mapper.bind({"prompt": ((40,), torch.int32),
                     "len": ((), torch.int32)})
        slate = RequestSlate(max_new=max_new, table_capacity=64)
        slate.subscribes = ("generated",)
        eng = Engine(Workflow([mapper, slate],
                              external_streams=("requests",)),
                     EngineConfig(batch_size=8), device=device)
        st, _ = eng.run(eng.init_state(), request_source(
            reqs, prompt_len=40, capacity=8, per_tick=4, device=device), 3)
        st, _ = eng.drain(st)
        rows = eng.read_slates(st, "requests", [r.rid for r in reqs])
        return np.stack([r["tokens"].numpy() for r in rows]), mapper

    def margins(mapper, req):
        """The CPU run's top-2 bf16 logit margin at each greedy step."""
        toks = np.zeros((1, 40), np.int32)
        toks[0, :len(req.prompt)] = req.prompt
        ctx = mapper.ctx
        lg, st = lm.prefill(mapper.model, {"tokens": torch.from_numpy(toks)},
                            ctx, 48, full_logits=True)
        lg, cur, out = lg[0, len(req.prompt) - 1], len(req.prompt), []
        for _ in range(max_new):
            top = torch.topk(lg.float(), 2).values
            out.append(float(top[0] - top[1]))
            tok = torch.argmax(lg).view(1, 1).to(torch.int32)
            lg, st = lm.decode_step(mapper.model, tok, st,
                                    torch.tensor([cur], dtype=torch.int32),
                                    ctx)
            lg, cur = lg[0, 0], cur + 1
        return out

    kernels = (sk.ssd_scan, rk.rmsnorm, fk.flash_attention,
               dk.decode_attention)
    before = [k.launches for k in kernels]
    card, _ = run(dev)
    assert all(k.launches > b for k, b in zip(kernels, before))
    cpu, cpu_mapper = run("cpu")
    for i in np.nonzero(~(card == cpu).all(axis=1))[0]:
        first = int(np.argmax(card[i] != cpu[i]))
        assert margins(cpu_mapper, reqs[i])[first] < 2**-5, (card[i], cpu[i])
