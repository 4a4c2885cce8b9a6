"""Declarative application layer: builder, planner, combinators, one
``App.run()`` front door (port of ``repro.api``; DESIGN.md section
11)."""
from repro_torch.api import ops
from repro_torch.api.app import App, OpRef, Stream
from repro_torch.api.planner import FusedMapper, Plan, PlanError
from repro_torch.api.runtime import RuntimeConfig

__all__ = ["App", "FusedMapper", "OpRef", "Plan", "PlanError",
           "RuntimeConfig", "Stream", "ops"]
