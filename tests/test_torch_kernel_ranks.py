"""The kernel routes across ranks on 4 gloo processes: ``decode_attend``
over a cache whose sequence is split (split-K: each rank's ``(o, lse)``,
one all-gather, the log-sum-exp merge in rank order), ``ssd`` over a split
sequence (each rank's final state and decay, one all-gather, the fold in
rank order, a second scan from the carried state) and ``rmsnorm`` over a
split row (each rank's partial sums, one all-gather, their sum in rank
order; the backward likewise), and the paths that reach them.

The 4 ranks spawn once for the file (``tests/_kernel_ranks_worker.py``, a
``FileStore`` under the module's temporary directory: no TCP port) and
play every case of ``_kernel_ranks_worker.CASES`` on (1, 4) and (2, 2)
meshes, uneven splits among them (``impl="ref"``: the card's kernels take
the same route with their own local halves), then the ``ServingEngine``
on a (1, 4) mesh and reduced zamba2's prefill; meanwhile this process
computes the one-process versions and one JAX subprocess
(``tests/_kernel_ranks_ref.py``) the JAX package's.

Tolerances: f32 within 1e-5 of the reference's largest magnitude (the
merge reorders sums); bf16 within 2e-2 of 1 + its largest magnitude (the
kernels' bf16 tolerance); ``rmsnorm``'s gradients within 2**-5 (bf16) or
1e-4 (f32) of the reference gradient's largest magnitude
(``chip_smoke.grad_tol``), as are the f32 decode and ssd cases'
gradients through the routes (a loss on every output) against autograd
of the whole plain version; a second call gives the same bits.  The
prefill: f32 logits within 1e-4 of the one-process and the JAX ones
(``tests/test_torch_mamba.py``'s f32 bound); bf16 logits within twice
the one-process path's own bf16-vs-f32 distance, measured here (zamba2 at
random init amplifies a rounding from block to block, so no bound per
layer holds: ``chip_smoke.py``'s rule for it).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from tests import _kernel_ranks_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_KEYS = ("dx", "dw")


@pytest.fixture(scope="module")
def played(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("kernel_ranks"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT])}
    out = os.path.join(d, "ranks.pkl")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_kernel_ranks_worker.py"),
         os.path.join(d, "store"), str(r), str(W.WORLD), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(W.WORLD)]
    jax_proc = None
    try:
        _, model, _ = W.prefill_params()
        params = os.path.join(d, "params.pkl")
        with open(params, "wb") as f:
            pickle.dump(convert.lm_params_to_numpy(model), f)
        jout = os.path.join(d, "jax.pkl")
        jax_proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_kernel_ranks_ref.py"), params,
             jout], env={**env, "JAX_PLATFORMS": "cpu"}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        one = {"cases": {n: W.whole(n) for n in W.CASES},
               "grads": {n: W.grads(n) for n in W.GRAD_CASES},
               "serve": {a: W.serve(a) for a in W.SERVE_ARCHS},
               "prefill": {dt: W.prefill(None, dt) for dt in ("bf16", "f32")}}
        logs = [p.communicate(timeout=400)[0] for p in procs]
        jlog = jax_proc.communicate(timeout=400)[0]
    finally:
        for p in procs + [jax_proc]:
            if p is not None and p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    assert jax_proc.returncode == 0, jlog[-6000:]
    with open(out, "rb") as f:
        ranks = pickle.load(f)
    with open(jout, "rb") as f:
        jax = pickle.load(f)
    return dict(one=one, ranks=ranks, jax=jax)


def bound(key, want, dtype):
    """The tolerance of an output against its reference ``want``."""
    scale = float(np.abs(want).max())
    if key in GRAD_KEYS:
        return (2.0**-5 if dtype == "bf16" else 1e-4) * scale
    return 2e-2 * (1.0 + scale) if dtype == "bf16" else 1e-5 * scale


@pytest.mark.parametrize("name", list(W.CASES))
def test_route_matches_whole_plain_and_jax(played, name):
    """Each route on the ranks against the port's whole-tensor plain
    version and the JAX package's whole-array function."""
    got = played["ranks"]["cases"][name]["out"]
    dtype = W.CASES[name]["dtype"]
    for ref in ("one", "jax"):
        want = played[ref]["cases"][name]
        assert set(got) == set(want), (ref, sorted(got), sorted(want))
        for key, w in want.items():
            g = got[key]
            assert g.shape == w.shape and np.isfinite(g).all(), (ref, key)
            err = float(np.abs(g - w).max())
            assert err <= bound(key, w, dtype), (ref, key, err,
                                                 bound(key, w, dtype))


@pytest.mark.parametrize("name", list(W.CASES))
def test_route_repeats_bitwise_with_one_gather_a_split_axis(played, name):
    """A second call gives the same bits; a call issues one all-gather a
    mesh axis that splits the reduced dim (rmsnorm: its backward one
    more), never more."""
    r = played["ranks"]["cases"][name]
    c = W.CASES[name]
    spec = c["cache" if c["route"] == "decode" else "x"]
    dim = {"decode": "S1", "ssd": "S1",
           "rmsnorm": f"S{len(c.get('shape', ())) - 1}"}[c["route"]]
    axes = sum(p == dim for p in spec)
    want = axes * (2 if c["route"] == "rmsnorm" else 1)
    assert r["bitwise"]
    assert r["gathers"] == [want, want], (r["gathers"], want)


@pytest.mark.parametrize("name", W.GRAD_CASES)
def test_route_gradients_match_whole_plain(played, name):
    """Autograd through a route on the ranks: the gradients of a loss on
    every output (decode's o, whole on the split ranks; ssd's y, split,
    and its final state, whole on them) with respect to every input
    against autograd of the whole-tensor plain version, within 1e-4 of
    the reference gradient's largest magnitude; a second call gives the
    same bits.  A gradient counted on every rank that holds an output
    whole would come out R times too large."""
    got = played["ranks"]["grads"][name]
    want = played["one"]["grads"][name]
    assert got["bitwise"]
    assert set(got["grads"]) == set(want)
    for key, w in want.items():
        g = got["grads"][key]
        assert g.shape == w.shape and np.isfinite(g).all(), key
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (key, err)


def test_idle_row_is_zero_by_design(played):
    """A row with no visible key on any rank (a length of 0): the route's
    merge gives 0, as the kernel does on one card; the whole-tensor plain
    version gives the mean of v (its masked scores are finite).  Rows
    with keys agree."""
    r = played["ranks"]["idle_row"]
    route, whole = r["route"], r["whole"]
    assert np.array_equal(route[[0, 2]], np.zeros_like(route[[0, 2]]))
    rep = whole.shape[2] // r["v_mean"].shape[1]
    mean = np.repeat(r["v_mean"], rep, axis=1)[:, None]
    assert np.allclose(whole[[0, 2]], mean[[0, 2]], atol=1e-6)
    assert np.abs(route[[1, 3]] - whole[[1, 3]]).max() <= 1e-5 * np.abs(
        whole).max()


@pytest.mark.parametrize("arch", W.SERVE_ARCHS)
def test_serving_engine_on_a_model_axis_equals_one_process(played, arch):
    """``ServingEngine`` on a (1, 4) mesh: the decode rules split the
    caches' sequence over "model" (dim 2 of the stacked caches ``[G,
    slots, S, Hkv, D]``), every decode step's attention takes the
    split-K route, and every request's tokens equal the one-process
    engine's."""
    got, want = played["ranks"]["serve"][arch], played["one"]["serve"][arch]
    assert len(want["tokens"]) == W.SERVE["requests"]
    assert all(len(t) == W.SERVE["max_new"] for t in want["tokens"].values())
    assert got["tokens"] == want["tokens"]
    assert got["cache_placements"] == ["R", "S(2)"]
    assert got["gathers"] > 0 and want["gathers"] == 0


@pytest.mark.parametrize("layout", ["heads", "seq"])
def test_zamba2_prefill_on_a_model_axis(played, layout):
    """Reduced zamba2's prefill on a (1, 4) mesh under the prefill rules.
    With "heads" the Mamba-2 scan takes each rank's heads and the gated
    norm's row (d_inner) is split over "model": ``rmsnorm``'s split
    route; without a "heads" axis the scan sees the sequence split:
    the carried-state route, every Mamba-2 block.  Logits against the
    one-process prefill and JAX's ``lm.prefill`` on the same weights."""
    one, jax = played["one"]["prefill"], played["jax"]["prefill"]
    drift = float(np.abs(one["bf16"]["logits"] - one["f32"]["logits"]).max())
    for dt in ("f32", "bf16"):
        got = played["ranks"]["prefill"][(dt, layout)]
        assert got["gathers"] > 0 and got["scans"] > 0
        assert got["carried"] == (got["scans"] if layout == "seq" else 0)
        for want in (one[dt]["logits"], jax[dt]):
            assert got["logits"].shape == want.shape
            err = float(np.abs(got["logits"] - want).max())
            tol = 1e-4 if dt == "f32" else 2 * drift
            assert err <= tol, (dt, err, tol, drift)
