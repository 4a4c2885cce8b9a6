"""The kernel routes across ranks, and the paths that reach them, on the
ranks of a gloo world.  Imports no JAX.

    python tests/_kernel_ranks_worker.py STORE RANK WORLD OUT

joins a gloo world of WORLD (4) ranks through the ``FileStore`` STORE and
plays, on rank 0 pickling the results to OUT:

* every case of :data:`CASES`: whole inputs made from the case's seed
  with numpy (the same on every rank), distributed onto a (1, 4) or
  (2, 2) mesh in the case's placements, through ``decode_attend``,
  ``ssd`` or ``rmsnorm`` (``impl="ref"``: the CPU's local halves; the
  card's kernels take the same route), twice, each output gathered
  whole, with the all-gathers each call issued; ``rmsnorm``'s gradients
  too, and those of the f32 decode and ssd cases (:func:`grads`);
* ``ServingEngine`` on a (1, 4) mesh (the decode rules split the caches'
  sequence over "model") for reduced qwen2-0.5b and gemma3-1b: each
  request's tokens;
* reduced zamba2-1.2b's prefill (``cells.make_prefill_step`` under the
  prefill rules, which split the sequence over "model") on the (1, 4)
  mesh: its logits.

The test file computes the one-process versions (:func:`whole`,
:func:`serve`, :func:`prefill` without a mesh) and the JAX package's.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as tdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from repro_torch.kernels import _local  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rref  # noqa: E402
from repro_torch.kernels.ssd import ops as sops  # noqa: E402
from repro_torch.kernels.ssd import ref as sref  # noqa: E402

WORLD = 4
R = "R"   # a placement per mesh dim: "R" Replicate, "S<d>" Shard(d)

# name -> the route, the mesh, the inputs' sizes and placements.  Uneven
# splits: decode S = 22 (6, 6, 6, 4) and 26 over both axes, ssd S = 38 and
# 37, rmsnorm D = 30; ssd's chunk of 8 does not divide any slice of 10,
# so the chunk boundaries shift on the ranks.
CASES = {
    "decode-1x4-f32": dict(
        route="decode", mesh=(1, 4), dtype="f32", B=4, Sq=1, H=4, Hkv=2,
        Dh=16, Dv=16, S=24, window=0, lengths=[3, 24, 11, 17],
        q=(R, R), cache=(R, "S1")),
    "decode-1x4-bf16-window": dict(
        route="decode", mesh=(1, 4), dtype="bf16", B=4, Sq=1, H=4, Hkv=2,
        Dh=16, Dv=16, S=24, window=5, lengths=[3, 24, 11, 17],
        q=(R, R), cache=(R, "S1")),
    "decode-1x4-uneven-heads-split": dict(
        route="decode", mesh=(1, 4), dtype="f32", B=4, Sq=1, H=4, Hkv=2,
        Dh=16, Dv=16, S=22, window=0, lengths=[1, 22, 9, 30],
        q=(R, "S2"), cache=(R, "S1")),
    "decode-1x4-dv8-sq2-window": dict(
        route="decode", mesh=(1, 4), dtype="f32", B=3, Sq=2, H=4, Hkv=4,
        Dh=16, Dv=8, S=24, window=7, lengths=[24, 5, 13],
        q=(R, R), cache=(R, "S1")),
    "decode-2x2-bf16-window": dict(
        route="decode", mesh=(2, 2), dtype="bf16", B=4, Sq=1, H=4, Hkv=2,
        Dh=16, Dv=16, S=24, window=7, lengths=[3, 24, 11, 17],
        q=("S0", R), cache=("S0", "S1")),
    "decode-2x2-seq-both-uneven": dict(
        route="decode", mesh=(2, 2), dtype="f32", B=2, Sq=1, H=4, Hkv=1,
        Dh=16, Dv=16, S=26, window=0, lengths=[26, 9],
        q=(R, R), cache=("S1", "S1")),
    "ssd-1x4-f32": dict(
        route="ssd", mesh=(1, 4), dtype="f32", B=2, S=40, H=2, N=8, P=8,
        chunk=8, init=False, x=(R, "S1")),
    "ssd-1x4-uneven-init-f32": dict(
        route="ssd", mesh=(1, 4), dtype="f32", B=2, S=38, H=2, N=8, P=8,
        chunk=8, init=True, x=(R, "S1")),
    "ssd-1x4-bf16": dict(
        route="ssd", mesh=(1, 4), dtype="bf16", B=2, S=40, H=2, N=8, P=8,
        chunk=8, init=False, x=(R, "S1")),
    "ssd-2x2-f32": dict(
        route="ssd", mesh=(2, 2), dtype="f32", B=2, S=40, H=2, N=8, P=8,
        chunk=8, init=True, x=("S0", "S1")),
    "ssd-2x2-seq-both-uneven": dict(
        route="ssd", mesh=(2, 2), dtype="f32", B=2, S=37, H=2, N=8, P=8,
        chunk=8, init=False, x=("S1", "S1")),
    "rmsnorm-1x4-f32": dict(
        route="rmsnorm", mesh=(1, 4), dtype="f32", shape=(3, 5, 32),
        offset=False, x=(R, "S2"), w=(R, R)),
    "rmsnorm-1x4-uneven-offset-bf16": dict(
        route="rmsnorm", mesh=(1, 4), dtype="bf16", shape=(3, 5, 30),
        offset=True, x=(R, "S2"), w=(R, R)),
    "rmsnorm-2x2-f32": dict(
        route="rmsnorm", mesh=(2, 2), dtype="f32", shape=(4, 3, 32),
        offset=False, x=("S0", "S2"), w=(R, R)),
    "rmsnorm-1x4-w-split-offset-f32": dict(
        route="rmsnorm", mesh=(1, 4), dtype="f32", shape=(6, 32),
        offset=True, x=(R, "S1"), w=(R, "S0")),
}
# the path's sizes: each engine serves 6 requests of 6 new tokens on 4
# slots; zamba2's prefill is 2 prompts of 64 tokens (16 a rank)
SERVE = dict(n_slots=4, cache_len=64, prompt_bucket=16, requests=6,
             max_new=6, ticks=12)
SERVE_ARCHS = ("qwen2-0.5b", "gemma3-1b")
PREFILL = dict(arch="zamba2-1.2b", B=2, S=64, cache_len=64)

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def inputs(name):
    """The case's whole inputs as float32 / int32 numpy arrays (bf16 cases
    round them when they become tensors)."""
    c = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if c["route"] == "decode":
        return dict(q=f(c["B"], c["Sq"], c["H"], c["Dh"]),
                    k=f(c["B"], c["S"], c["Hkv"], c["Dh"]),
                    v=f(c["B"], c["S"], c["Hkv"], c["Dv"]),
                    lengths=np.asarray(c["lengths"], np.int32))
    if c["route"] == "ssd":
        B, S, H, N, P = (c[k] for k in "BSHNP")
        out = dict(q=f(B, S, H, N) * 0.5, k=f(B, S, H, N) * 0.5,
                   v=f(B, S, H, P),
                   log_a=-rng.uniform(0.01, 0.5, (B, S, H)).astype(
                       np.float32))
        if c["init"]:
            out["init"] = f(B, H, N, P)
        return out
    D = c["shape"][-1]
    return dict(x=f(*c["shape"]) * 2.0, w=f(D) * 0.5 + 1.0,
                dy=f(*c["shape"]))


def tensors(name):
    """The inputs as torch tensors in the case's dtype (log_a, lengths,
    the initial state and w keep theirs)."""
    dt = TORCH_DT[CASES[name]["dtype"]]
    keep = ("log_a", "lengths", "init", "w")
    return {k: torch.from_numpy(a) if k in keep else
            torch.from_numpy(a).to(dt) for k, a in inputs(name).items()}


def whole(name):
    """The port's whole-tensor plain version on the case's inputs: the
    outputs as float32 numpy (rmsnorm's with its gradients)."""
    c, t = CASES[name], tensors(name)
    if c["route"] == "decode":
        o = dref.decode_attend(t["q"], t["k"], t["v"], t["lengths"],
                               window=c["window"])
        return {"o": o.float().numpy()}
    if c["route"] == "ssd":
        y, fin = sref.ssd(t["q"], t["k"], t["v"], t["log_a"],
                          chunk=c["chunk"], initial_state=t.get("init"))
        return {"y": y.float().numpy(), "final": fin.numpy()}
    y = rref.rmsnorm(t["x"], t["w"], scale_offset=c["offset"])
    dx, dw = rref.rmsnorm_bwd(t["x"], t["w"], t["dy"],
                              scale_offset=c["offset"])
    return {"y": y.float().numpy(), "dx": dx.float().numpy(),
            "dw": dw.numpy()}


def placements(spec):
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if p == R else Shard(int(p[1:])) for p in spec)


_MESHES = {}


def mesh_of(shape):
    from torch.distributed.device_mesh import init_device_mesh
    if shape not in _MESHES:
        _MESHES[shape] = init_device_mesh("cpu", shape,
                                          mesh_dim_names=("data", "model"))
    return _MESHES[shape]


def _dist(t, mesh, spec):
    from repro_torch.distributed import sharding as shd
    return shd.distribute(t, mesh, placements(spec))


def dist_inputs(name, t, mesh):
    """A decode or ssd case's whole inputs ``t`` as DTensors in the case's
    placements (the initial state whole over the split sequence)."""
    c = CASES[name]
    if c["route"] == "decode":
        spec = {"q": c["q"], "k": c["cache"], "v": c["cache"]}
    else:
        spec = dict.fromkeys(("q", "k", "v", "log_a"), c["x"])
        spec["init"] = tuple(R if p == "S1" else p for p in c["x"])
    return {k: _dist(a, mesh, spec[k]) if k in spec else a
            for k, a in t.items()}


def route_outputs(name, t):
    """A decode or ssd case through its dispatcher (``impl="ref"``) on the
    inputs ``t``, whole tensors or DTensors."""
    c = CASES[name]
    if c["route"] == "decode":
        return {"o": dops.decode_attend(t["q"], t["k"], t["v"],
                                        t["lengths"], window=c["window"],
                                        impl="ref")}
    y, fin = sops.ssd(t["q"], t["k"], t["v"], t["log_a"], chunk=c["chunk"],
                      initial_state=t.get("init"), impl="ref")
    return {"y": y, "final": fin}


def on_ranks(name):
    """The case through its route on the mesh, twice: the outputs whole
    (float32 numpy), whether the second call gave the same bits, and the
    all-gathers each call issued."""
    c, t = CASES[name], tensors(name)
    mesh = mesh_of(c["mesh"])

    def call():
        if c["route"] != "rmsnorm":
            out = route_outputs(name, dist_inputs(name, t, mesh))
            return {k: v.full_tensor() for k, v in out.items()}
        x = _dist(t["x"], mesh, c["x"]).detach().requires_grad_(True)
        w = _dist(t["w"], mesh, c["w"]).detach().requires_grad_(True)
        y = rops.rmsnorm(x, w, scale_offset=c["offset"], impl="ref")
        dy = _dist(t["dy"], mesh, c["x"]).redistribute(mesh, y.placements)
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        return {"y": y.full_tensor(), "dx": dx.full_tensor(),
                "dw": dw.full_tensor()}

    runs, gathers = [], []
    for _ in range(2):
        g0 = _local.GATHERS["all_gather"]
        runs.append(call())
        gathers.append(_local.GATHERS["all_gather"] - g0)
    same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    return {"out": {k: v.detach().float().numpy()
                    for k, v in runs[0].items()},
            "bitwise": same, "gathers": gathers}


# the f32 decode and ssd cases whose gradients are held against the whole
# plain version's: a loss on every output, ssd's final state (whole on
# every rank of the split) as well as y
GRAD_CASES = [n for n, c in CASES.items()
              if c["route"] != "rmsnorm" and c["dtype"] == "f32"]


def grads(name, mesh=None):
    """The gradients of ``sum_out sum(out * g)`` (``g`` drawn from the
    case's seed) with respect to every float input, through the route on
    ``mesh`` or through the whole-tensor plain version: float32 numpy
    (on a mesh also whether a second call gave the same bits)."""
    base = tensors(name)
    keys = [k for k in base if k != "lengths"]

    def call():
        t = base if mesh is None else dist_inputs(name, base, mesh)
        t = {k: a.detach().requires_grad_(True) if k in keys else a
             for k, a in t.items()}
        out = route_outputs(name, t)
        rng = np.random.default_rng(sum(map(ord, name)) + 1)
        gs = []
        for o in out.values():
            g = torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
                np.float32))
            gs.append(g if mesh is None else _dist(g, mesh, tuple(
                R if p.is_replicate() else f"S{p.dim}" for p in o.placements)))
        got = torch.autograd.grad(list(out.values()), [t[k] for k in keys],
                                  gs)
        return {k: (g if mesh is None else g.full_tensor()).float()
                for k, g in zip(keys, got)}
    first = call()
    res = {k: v.numpy() for k, v in first.items()}
    if mesh is None:
        return res
    again = call()
    return {"grads": res,
            "bitwise": all(torch.equal(first[k], again[k]) for k in first)}


def idle_row():
    """A decode row with no visible key anywhere (a length of 0): the
    route's merge gives 0, the whole-tensor plain version the mean of v
    (its masked scores are finite) -- a difference by design.  Returns
    both, on a (1, 4) mesh."""
    t = tensors("decode-1x4-f32")
    lengths = torch.tensor([0, 24, 0, 17], dtype=torch.int32)
    mesh = mesh_of((1, 4))
    o = dops.decode_attend(_dist(t["q"], mesh, (R, R)),
                           _dist(t["k"], mesh, (R, "S1")),
                           _dist(t["v"], mesh, (R, "S1")), lengths,
                           impl="ref").full_tensor()
    want = dref.decode_attend(t["q"], t["k"], t["v"], lengths)
    return {"route": o.numpy(), "whole": want.numpy(),
            "v_mean": t["v"].mean(1).numpy()}


def requests(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=rng.integers(4, 20)).astype(np.int32)
            for _ in range(SERVE["requests"])]


def serve(arch, mesh=None):
    """``ServingEngine`` on ``mesh`` (or one process): each request's
    tokens, and on a mesh the caches' placements and the all-gathers the
    run issued."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import Request, ServeConfig, ServingEngine
    cfg = reduced_config(arch)
    eng = ServingEngine(cfg, ServeConfig(
        n_slots=SERVE["n_slots"], cache_len=SERVE["cache_len"],
        prompt_bucket=SERVE["prompt_bucket"]), mesh=mesh, device="cpu")
    for i, p in enumerate(requests(cfg.vocab_size)):
        eng.submit(Request(rid=i, prompt=p, max_new=SERVE["max_new"]))
    g0 = _local.GATHERS["all_gather"]
    eng.run(SERVE["ticks"])
    out = {"tokens": {r.rid: list(r.tokens_out) for r in eng.finished},
           "gathers": _local.GATHERS["all_gather"] - g0}
    if mesh is not None:
        k = eng.states[0][0]["k"]
        out["cache_placements"] = [str(p) for p in k.placements]
    return out


def prefill_params(arch=PREFILL["arch"]):
    """The prefill's f32 weights, drawn from seed 0 (``lm.init``)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    cfg = reduced_config(arch)
    model, specs = lm.init(lm.build(cfg), torch.Generator().manual_seed(0))
    return cfg, model, specs


def prefill_tokens(vocab):
    rng = np.random.default_rng(3)
    return rng.integers(1, vocab, (PREFILL["B"], PREFILL["S"])).astype(
        np.int32)


def prefill(mesh=None, dtype="bf16", layout="heads"):
    """Reduced zamba2's prefill logits on ``mesh`` under the prefill rules,
    or on one process, at ``dtype`` compute (bf16 through
    ``cells.make_prefill_step``, as the serving engine runs it; f32
    through the same ``lm.prefill`` with an f32 context).  ``layout``
    "seq" takes the rules without a "heads" axis, so the Mamba-2 scan
    sees the residual stream's sequence split (the carried-state route)
    where "heads" gives it the heads split.  On a mesh also the
    all-gathers the split routes issued and the scans that took the
    carried-state route."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import cells
    from repro_torch.models import lm
    cfg, model, _ = prefill_params()
    dt = TORCH_DT[dtype]
    cast = lm.for_compute(model, dt)
    rules = None
    batch = {"tokens": torch.from_numpy(prefill_tokens(cfg.vocab_size))}
    if mesh is not None:
        rules = shd.rules_for(mesh, phase="prefill")
        if layout == "seq":
            rules = {**rules, "heads": ()}
        shd.distribute_model(cast, lm.param_specs(cast)[1], mesh, rules)
        batch = shd.distribute_tree(
            batch, shd.batch_shardings(batch, mesh, rules), mesh)
    if dt == cells.CDTYPE:
        step = cells.make_prefill_step(cast, cache_len=PREFILL["cache_len"],
                                       full_logits=True, mesh=mesh,
                                       rules=rules)
    else:
        ctx = cells._ctx(mesh, rules).replace(cdtype=dt)

        def step(params, batch):
            with cells.on_mesh(mesh):
                return lm.prefill(params, batch, ctx, PREFILL["cache_len"],
                                  full_logits=True)
    calls = {"carried": 0, "scans": 0}
    saved = sops._carried, sops._on_shards

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    sops._carried = count("carried", saved[0])
    sops._on_shards = count("scans", saved[1])
    g0 = _local.GATHERS["all_gather"]
    try:
        with torch.no_grad():
            logits, _ = step(cast, batch)
    finally:
        sops._carried, sops._on_shards = saved
    return {"logits": shd.whole(logits).float().numpy(),
            "gathers": _local.GATHERS["all_gather"] - g0, **calls}


PREFILLS = [(dt, lay) for lay in ("heads", "seq") for dt in ("bf16", "f32")]


def main(argv):
    store, rank, world, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world,
                             timeout=datetime.timedelta(seconds=240))
    try:
        from repro_torch.launch.mesh import make_host_mesh
        res = {"cases": {n: on_ranks(n) for n in CASES},
               "grads": {n: grads(n, mesh_of(CASES[n]["mesh"]))
                         for n in GRAD_CASES},
               "idle_row": idle_row()}
        serving = make_host_mesh(n_data=1, n_model=WORLD, device="cpu")
        res["serve"] = {a: serve(a, serving) for a in SERVE_ARCHS}
        res["prefill"] = {(dt, lay): prefill(serving, dt, lay)
                          for dt, lay in PREFILLS}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
