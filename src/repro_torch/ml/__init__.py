"""Streaming ML on the MapUpdate engine (port of ``repro.ml``; DESIGN.md
section 16): model-backed stages compiled into the unchanged engine.

- :class:`ModelMapper` — microbatched model inference as a mapper stage
  (``models/lm.py`` forward inside the tick, in f32; parameters on the
  card from construction).
- :class:`SemanticTopK` / :class:`Personalization` — online updaters
  over the emitted embeddings.  ``SemanticTopK`` is an elementwise-max
  associative updater, so it rides the fused ``kernels/slate_update``
  path, stays durable, and remains hot-key-splittable.
- :mod:`repro_torch.ml.serve_app` — the LM-serving loop as a MapUpdate
  app (admission source -> prefill/decode mapper -> per-request slate).

Every name is imported on first touch: the model stack stays unloaded
until an app asks for it.
"""
import importlib

_WHERE = {
    "ModelMapper": "mapper",
    "SemanticTopK": "rankers", "semantic_topk": "rankers",
    "Personalization": "rankers", "personalization": "rankers",
    "LMServeMapper": "serve_app", "RequestSlate": "serve_app",
    "build_serve_app": "serve_app", "request_source": "serve_app",
}

__all__ = [
    "ModelMapper",
    "SemanticTopK", "semantic_topk",
    "Personalization", "personalization",
    "LMServeMapper", "RequestSlate", "build_serve_app", "request_source",
]


def __getattr__(name):
    if name in _WHERE:
        mod = importlib.import_module(f"repro_torch.ml.{_WHERE[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module 'repro_torch.ml' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
