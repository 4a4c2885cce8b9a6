"""One front door for runtime selection (port of ``repro.api.runtime``;
DESIGN.md section 11.3).

``RuntimeConfig`` subsumes ``EngineConfig`` + ``DistConfig`` +
``DurabilityConfig``: the app author states batch/queue sizes, a shard
count, and (optionally) a durability directory, and ``App.run`` picks
the engine and the chunked vs durable drive paths internally.  The
underlying configs stay the source of truth — this is a declarative
veneer that compiles down to them.

``shards > 1`` (or a mesh) selects ``DistributedEngine``.  Without a
process group every shard lives on the engine's one device, so
``shards`` may exceed the device count (the JAX package raises there:
it places a shard a device).  With ``group`` (a ``torch.distributed``
process group) the shards spread over its ranks in contiguous blocks,
and a count the ranks cannot split evenly raises, as the JAX package's
device check does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.engine import EngineConfig
from repro_torch.core.queues import OverflowPolicy

@dataclass
class RuntimeConfig:
    batch_size: int = 256
    queue_capacity: int = 0          # 0 = 4 * batch_size
    chunk_size: int = 8              # ticks per chunk (one host sync)
    fused: str = "auto"              # slate-update backend (EngineConfig)
    # key plane width, end-to-end: "int32" (default) or "int64" (widens
    # event keys, slate tables, WAL frames, the sketch sample and the
    # kernel entry points — DESIGN.md 12.5/17)
    key_dtype: str = "int32"
    overflow: Dict[str, OverflowPolicy] = field(default_factory=dict)
    overflow_stream: Dict[str, str] = field(default_factory=dict)
    default_policy: OverflowPolicy = OverflowPolicy.DROP
    # distribution: shards > 1 (or an explicit mesh,
    # core.distributed.make_mesh) selects the multi-shard engine
    shards: int = 1
    mesh: Optional[object] = None
    # the process group whose ranks hold the shards (None: one device)
    group: Optional[object] = None
    exchange_slack: float = 2.0
    two_choice_threshold: int = 0
    # migration tiering (DESIGN.md section 14): "auto" moves slate rows
    # on the device at shape-preserving reconfigures; "off" forces the
    # host remap.  compact_threshold: dead-slot fraction that triggers
    # physical slot compaction on scale-down (0 disables).
    device_migration: str = "auto"
    compact_threshold: float = 0.75
    # durability (DESIGN.md section 10): a directory turns on the WAL +
    # slate flush + crash recovery runtime
    durable_dir: Optional[str] = None
    flush_every: int = 16
    barrier: bool = True
    truncate_wal: bool = False
    # live elasticity (DESIGN.md section 12): an AutoscalePolicy fires
    # reconfigures at declared ticks; a telemetry.LoadAutoscaler closes
    # the loop from windowed load instead (distributed runtimes only)
    autoscale: Optional[object] = None
    # device-side telemetry (DESIGN.md section 13): a TelemetryConfig
    # adds the count-min key-heat sketch and the latency histograms to
    # the tick and the windowed metrics registry behind App.telemetry().
    # Implied by a LoadAutoscaler.
    telemetry: Optional[object] = None   # telemetry.TelemetryConfig

    @property
    def distributed(self) -> bool:
        return self.shards > 1 or self.mesh is not None \
            or self.group is not None

    def _queue_capacity(self) -> int:
        return self.queue_capacity or 4 * self.batch_size

    def _durability(self):
        if self.durable_dir is None:
            return None
        from repro_torch.core.durability import DurabilityConfig
        from repro_torch.slates.flush import FlushConfig, FlushPolicy
        return DurabilityConfig(
            dir=self.durable_dir,
            flush=FlushConfig(policy=FlushPolicy.EVERY_K,
                              every_k=self.flush_every),
            barrier=self.barrier,
            truncate_wal=self.truncate_wal)

    def _telemetry(self):
        if self.telemetry is None:
            return None
        from repro_torch.telemetry.metrics import TelemetryConfig
        if not isinstance(self.telemetry, TelemetryConfig):
            raise TypeError(
                f"telemetry must be a TelemetryConfig, got "
                f"{type(self.telemetry).__name__}")
        return self.telemetry

    def engine_config(self) -> EngineConfig:
        if self.autoscale is not None:
            raise ValueError(
                "autoscale needs a distributed runtime: set shards > 1 "
                "(or pass mesh=)")
        return EngineConfig(
            batch_size=self.batch_size,
            queue_capacity=self._queue_capacity(),
            overflow=dict(self.overflow),
            overflow_stream=dict(self.overflow_stream),
            default_policy=self.default_policy,
            fused=self.fused,
            key_dtype=self.key_dtype,
            chunk_size=self.chunk_size,
            durability=self._durability(),
            telemetry=self._telemetry())

    def dist_config(self):
        from repro_torch.core.distributed import AutoscalePolicy, DistConfig
        from repro_torch.telemetry.controller import LoadAutoscaler
        if self.autoscale is not None and \
                not isinstance(self.autoscale,
                               (AutoscalePolicy, LoadAutoscaler)):
            raise TypeError(
                f"autoscale must be an AutoscalePolicy or "
                f"LoadAutoscaler, got {type(self.autoscale).__name__}")
        return DistConfig(
            batch_size=self.batch_size,
            queue_capacity=self._queue_capacity(),
            overflow=dict(self.overflow),
            overflow_stream=dict(self.overflow_stream),
            default_policy=self.default_policy,
            fused=self.fused,
            key_dtype=self.key_dtype,
            chunk_size=self.chunk_size,
            durability=self._durability(),
            exchange_slack=self.exchange_slack,
            two_choice_threshold=self.two_choice_threshold,
            device_migration=self.device_migration,
            compact_threshold=self.compact_threshold,
            autoscale=self.autoscale,
            telemetry=self._telemetry())

    def make_mesh(self):
        """The shard grid: ``mesh`` if given, else ``shards`` along one
        ``"data"`` axis over ``group``'s ranks.  Without a group every
        shard lives on the engine's device, so no device count bounds
        ``shards``; with one, ``shards`` must split evenly over its
        ranks."""
        if self.mesh is not None:
            return self.mesh
        from repro_torch.core.distributed import make_mesh
        return make_mesh((self.shards,), ("data",), group=self.group)
