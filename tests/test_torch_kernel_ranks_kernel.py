"""The kernels' local halves of the routes across ranks on the card,
against the plain versions' (``tests/test_torch_kernel_ranks.py`` runs the
routes over gloo ranks on the CPU): ``decode_attention(partial=True)`` on
slices of a cache at their offsets (windows, GQA, Dv != Dh, an idle row
of length 0, a length past the cache), merged by ``decode_attention/
ops.merge`` against the whole-tensor kernel; ``ssd_scan`` from an initial
state on both routes, and the carried-state emulation over uneven slices
against the whole scan; ``rmsnorm_sums`` and ``rmsnorm`` / ``rmsnorm_bwd``
given the rows' sums, on both routes.  Every case needs a CUDA card and
skips without one; the file imports no JAX.

Tolerances: attention 2e-2 (bf16) / 5e-5 (f32), the lse within 1e-3 /
1e-5 of 1 + its magnitude; ``ssd_scan`` y within 2e-2 / 5e-5 of max|y| +
1, the state within 5e-4 of max|state| + 1; ``rmsnorm`` f32 within 5e-5,
bf16 within one ulp of each value; gradients within 2**-5 / 1e-4 of the
reference's largest magnitude.  Two calls give the same bits."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.rmsnorm import ref as rref
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd import ref as sref

ATOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _pieces(n, R):
    size = -(-n // R)
    return [(o, min(size, n - o)) for o in range(0, n, size)]


@pytest.mark.parametrize("B,H,Hkv,Dh,Dv,S,window,dt,R", [
    (4, 14, 2, 64, 64, 300, 0, torch.bfloat16, 3),
    (4, 4, 1, 256, 256, 1088, 512, torch.bfloat16, 4),
    (3, 16, 16, 192, 128, 520, 0, torch.bfloat16, 2),
    (4, 8, 2, 64, 64, 257, 37, torch.float32, 5),
])
def test_decode_partials_match_plain_and_merge_to_whole(B, H, Hkv, Dh, Dv,
                                                        S, window, dt, R):
    from repro_torch.kernels.decode_attention import kernel as dk
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(S + R)
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dt)
    q, kc, vc = r(B, 1, H, Dh), r(B, S, Hkv, Dh), r(B, S, Hkv, Dv)
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0], lens[-1] = 0, S + 40       # an idle row; one past the cache
    tol = ATOL[dt]
    os_, ls = [], []
    for o, n in _pieces(S, R):
        args = (q, kc[:, o:o + n], vc[:, o:o + n], lens)
        kw = dict(window=window, seq_offset=o, seq_total=S)
        go, gl = dk.decode_attention(*args, partial=True, **kw)
        wo, wl = dref.decode_attend(*args, partial=True, **kw)
        assert go.dtype == gl.dtype == torch.float32
        assert float((go - wo).abs().max()) < tol
        assert torch.equal(torch.isinf(gl), torch.isinf(wl))
        seen = torch.isfinite(wl)
        if bool(seen.any()):    # a slice may hold no visible key at all
            assert float(((gl - wl).abs() / (1 + wl.abs()))[seen].max()) \
                < (1e-3 if dt == torch.bfloat16 else 1e-5)
        again = dk.decode_attention(*args, partial=True, **kw)
        assert torch.equal(go, again[0]) and torch.equal(gl, again[1])
        os_.append(go)
        ls.append(gl)
    got, lse = dops.merge(torch.stack(os_), torch.stack(ls))
    got = got.to(dt)
    whole = dk.decode_attention(q, kc, vc, lens, window=window)
    assert float((got[1:].float() - whole[1:].float()).abs().max()) < tol
    assert float(got[0].abs().max()) == 0.0      # no key on any slice
    assert bool(torch.isinf(lse[0]).all())


@pytest.mark.parametrize("B,S,H,N,P,chunk,dt,shared,route", [
    (2, 512, 8, 64, 64, 256, torch.bfloat16, True, "mma"),
    (2, 200, 4, 32, 16, 64, torch.bfloat16, False, "mma"),
    (2, 300, 4, 64, 64, 128, torch.float32, True, "simt"),
    (1, 100, 2, 24, 16, 64, torch.bfloat16, False, "simt"),
])
def test_ssd_scan_from_a_state_and_the_carried_route(B, S, H, N, P, chunk,
                                                     dt, shared, route):
    from repro_torch.kernels.ssd_scan import kernel as sk
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(S)
    rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    Hq = 1 if shared else H
    q = rn(B, S, Hq, N).to(dt).expand(B, S, H, N)
    k = (rn(B, S, Hq, N) * 0.3).to(dt).expand(B, S, H, N)
    v = rn(B, S, H, P).to(dt)
    la = -torch.nn.functional.softplus(rn(B, S, H))
    h0 = rn(B, H, N, P)
    assert sk.route(q, k, v, chunk) == route

    def close(got, want):
        (y, f), (wy, wf) = got, want
        assert float((y.float() - wy.float()).abs().max()) / (
            float(wy.float().abs().max()) + 1) < ATOL[dt]
        assert float((f - wf).abs().max()) / (float(wf.abs().max()) + 1) \
            < 5e-4
    n0 = sk.ssd_scan.partial_launches
    got = sk.ssd_scan(q, k, v, la, chunk=chunk, initial_state=h0)
    assert sk.ssd_scan.partial_launches == n0 + 1
    close(got, sref.ssd(q, k, v, la, chunk=chunk, initial_state=h0))
    again = sk.ssd_scan(q, k, v, la, chunk=chunk, initial_state=h0)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    # the carried-state route over 3 uneven slices
    parts = _pieces(S, 3)
    sl = lambda t, o, n: t[:, o:o + n]
    firsts = [sk.ssd_scan(*(sl(t, o, n) for t in (q, k, v, la)),
                          chunk=chunk) for o, n in parts]
    F = torch.stack([f for _, f in firsts])
    A = torch.stack([torch.exp(sl(la, o, n).sum(1)) for o, n in parts])
    ys = [firsts[0][0]]
    for i, (o, n) in enumerate(parts[1:], 1):
        ys.append(sk.ssd_scan(*(sl(t, o, n) for t in (q, k, v, la)),
                              chunk=chunk,
                              initial_state=sops.fold(F, A, i)[0])[0])
    close((torch.cat(ys, 1), sops.fold(F, A, 0)[2]),
          sk.ssd_scan(q, k, v, la, chunk=chunk))


@pytest.mark.parametrize("rows,D,dt,offset,R", [
    (2048, 2048, torch.bfloat16, False, 16),   # regs
    (64, 896, torch.bfloat16, True, 4),        # regs, decode rows
    (300, 1000, torch.float32, False, 3),      # 1000 / 3: odd pieces, loop
    (96, 4096, torch.bfloat16, True, 2),
])
def test_rmsnorm_given_the_rows_sums(rows, D, dt, offset, R):
    from repro_torch.kernels.rmsnorm import kernel as rk
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(D)
    x = (torch.randn(rows, D, generator=gen, device=dev) * 3).to(dt)
    dy = torch.randn(rows, D, generator=gen, device=dev).to(dt)
    w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
    pieces = [(x[:, o:o + n].contiguous(), w[o:o + n].contiguous(),
               dy[:, o:o + n].contiguous()) for o, n in _pieces(D, R)]
    ss, st = 0, 0
    for a, b, g in pieces:
        s1, s2 = rk.rmsnorm_sums(a), rk.rmsnorm_sums(a, b, g,
                                                     scale_offset=offset)
        w1 = rref.rmsnorm_sums(a)
        w2 = rref.rmsnorm_sums(a, b, g, scale_offset=offset)
        assert float(((s1 - w1).abs() / (1 + w1.abs())).max()) < 1e-5
        assert float(((s2 - w2).abs() / (1 + w2.abs().amax(-1, True))
                      ).max()) < 1e-5
        ss, st = ss + s1, st + s2
    ys, dxs, dws = [], [], []
    for a, b, g in pieces:
        y = rk.rmsnorm(a, b, scale_offset=offset, ss=ss, d_norm=D)
        assert torch.equal(y, rk.rmsnorm(a, b, scale_offset=offset, ss=ss,
                                         d_norm=D))
        dx, dw = rk.rmsnorm_bwd(a, b, g, scale_offset=offset, sums=st,
                                d_norm=D)
        ys.append(y)
        dxs.append(dx)
        dws.append(dw)
    y = torch.cat(ys, 1)
    want = rref.rmsnorm(x, w, scale_offset=offset)
    err = (y.float() - want.float()).abs()
    if dt == torch.bfloat16:
        assert bool((err <= 2.0**-7 * want.float().abs()).all())
    else:
        assert float(err.max()) < 5e-5
    wdx, wdw = rref.rmsnorm_bwd(x, w, dy, scale_offset=offset)
    tol = 2.0**-5 if dt == torch.bfloat16 else 1e-4
    for g_, w_ in ((torch.cat(dxs, 1), wdx), (torch.cat(dws), wdw)):
        assert float((g_.float() - w_.float()).abs().max()) <= tol * float(
            w_.float().abs().max())
