"""The JAX package's numbers for ``tests/test_torch_kernel_ranks.py``, in
one subprocess.

    JAX_PLATFORMS=cpu python tests/_kernel_ranks_ref.py PARAMS OUT

For every case of ``tests/_kernel_ranks_worker.CASES``, on the same numpy
inputs: the whole-array function GSPMD computes for the sharded one
(``repro/kernels/decode_attention/ref.py::decode_attend``,
``repro/kernels/ssd/ref.py::ssd``, ``repro/kernels/rmsnorm/ref.py::
rmsnorm`` and its ``jax.vjp``); and reduced zamba2-1.2b's ``lm.prefill``
logits on the weights in PARAMS (the port's, as a JAX parameter tree in
numpy: ``convert.lm_params_to_numpy``) at f32 and bf16 compute.  Pickles
them to OUT.
"""
from __future__ import annotations

import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.kernels.decode_attention import ref as dref  # noqa: E402
from repro.kernels.rmsnorm import ref as rref  # noqa: E402
from repro.kernels.ssd import ref as sref  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from tests import _kernel_ranks_worker as W  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def case(name):
    c = W.CASES[name]
    a = W.inputs(name)
    dt = JDT[c["dtype"]]
    cast = lambda k: jnp.asarray(a[k]).astype(dt)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    if c["route"] == "decode":
        o = dref.decode_attend(cast("q"), cast("k"), cast("v"),
                               jnp.asarray(a["lengths"]), window=c["window"])
        return {"o": f32(o)}
    if c["route"] == "ssd":
        init = jnp.asarray(a["init"]) if "init" in a else None
        y, fin = sref.ssd(cast("q"), cast("k"), cast("v"),
                          jnp.asarray(a["log_a"]), chunk=c["chunk"],
                          initial_state=init)
        return {"y": f32(y), "final": f32(fin)}
    fn = lambda x, w: rref.rmsnorm(x, w, scale_offset=c["offset"])
    y, vjp = jax.vjp(fn, cast("x"), jnp.asarray(a["w"]))
    dx, dw = vjp(cast("dy"))
    return {"y": f32(y), "dx": f32(dx), "dw": f32(dw)}


def prefill(params):
    cfg = reduced_config(W.PREFILL["arch"])
    model = lm.build(cfg)
    toks = jnp.asarray(W.prefill_tokens(cfg.vocab_size))
    params = jax.tree.map(jnp.asarray, params)
    out = {}
    for name, dt in JDT.items():
        logits, _ = jax.jit(lambda p, t: lm.prefill(
            model, p, {"tokens": t}, Ctx(cdtype=dt), W.PREFILL["cache_len"],
            full_logits=True))(params, toks)
        out[name] = np.asarray(jnp.asarray(logits, jnp.float32))
    return out


def main(argv):
    src, out = argv
    with open(src, "rb") as f:
        params = pickle.load(f)
    res = {"cases": {n: case(n) for n in W.CASES},
           "prefill": prefill(params)}
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
