"""Streaming ML on the MapUpdate engine (port of ``repro.ml``; DESIGN.md
section 16).  Ported so far: LM serving as a MapUpdate app
(:mod:`repro_torch.ml.serve_app`).  ``ModelMapper``, the rankers and
``build_serve_app`` wait for the front-door slice."""
from repro_torch.ml.serve_app import (LMServeMapper, RequestSlate,
                                      request_source)

__all__ = ["LMServeMapper", "RequestSlate", "request_source"]
