"""MapUpdate on PyTorch/CUDA — the port of ``repro`` (JAX/Pallas), a
reproduction of "Muppet: MapReduce-Style Processing of Fast Data", to
one NVIDIA H100.

Curated public surface: application authors should need nothing beyond
``from repro_torch import App, RuntimeConfig, EventBatch, ops`` — the
declarative builder compiles to the engine layer below, which stays
importable (``repro_torch.core.*``, ``repro_torch.slates.*``) for engine
work.  Every name is imported on first touch, so ``import repro_torch``
itself imports nothing (not even torch).

The port keeps the JAX package's module layout and public names, so each
counterpart sits at the same relative path (``repro_torch.core.engine.
Engine`` <-> ``repro.core.engine.Engine``).  Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a CUDA C++ kernel under
``csrc/``, compiled for ``sm_90a`` at first use (``kernels/_build.py``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far, slice by slice:

1. the single-shard MapUpdate tick (events, queues, operators, the slate
   table, both updater paths and the engine loop) with the
   ``slate_update`` and ``slate_lookup`` kernels;
2. in-tick telemetry (the count-min sketch and latency histograms on the
   ``countmin_update`` / ``histogram_update`` kernel, the windowed
   ``TelemetryReport``, tracing, ``/metrics``, the hot-key cache and the
   HTTP slate server);
3. LM serving on the engine (``ml.serve_app``): the dense decoders of
   ``models/`` with the ``flash_attention`` and ``decode_attention``
   kernels;
4. hybrid SSM serving (zamba2) with the ``ssd_scan`` and ``rmsnorm``
   kernels;
5. one Hopper redesign of every kernel, and the other decoder families
   (xLSTM, gemma3's local/global attention, MoE with latent attention);
6. durability and recovery (write-ahead log, slate flush to a quorum KV
   store, ``Engine.recover``, ``SlateReplica``) with 64-bit keys;
7. the ``App`` front door on one shard: the planner, ``ops``,
   ``RuntimeConfig``, ``ModelMapper`` and the rankers, ``build_serve_app``,
   the synthetic sources and the stream launcher
   (``python -m repro_torch.launch.stream``);
8. the continuous-batching ``ServingEngine`` (``repro_torch.launch.
   serve``, with its request journal) and the last two model families,
   whisper's encoder-decoder and llama-3.2-vision's cross-attention
   layers;
9. the multi-shard engine on one card (``DistributedEngine``,
   ``DistConfig``, ``core.distributed.make_mesh``): the hash ring, the
   event exchange, fail-over, hot-key split and per-shard durability,
   every shard on the engine's one device;
10. live elasticity on that card: ``scale``, ``add_shards``,
   ``remove_shards``, ``rebalance``, ``clear_split`` and ``compact``
   (slates and queued events migrated loss-free, on the device or
   through the host), ``AutoscalePolicy`` in ``run``, and the
   closed-loop ``LoadAutoscaler``;
11. training (``launch.train.Trainer``: the loss, AdamW, checkpoints and
   an exact resume) with backward kernels for ``flash_attention`` and
   ``rmsnorm``;
12. the mesh (``launch.mesh``, ``distributed.sharding``, ``launch.
   cells``): the trainer, the ``ServingEngine`` and expert-parallel MoE
   on a ``DeviceMesh``, and the dry run (``launch.dryrun``) on a fake
   world of 512 ranks;
13. the multi-shard engine over the ranks of a process group (exchanges
   as ``all_to_all_single``, collective reads, elasticity and durability
   across ranks) and HTTP slate reads served from rank 0 through a read
   queue every rank drains;
14. the kernel routes across ranks: ``decode_attention``'s split-K over a
   sequence-split cache, ``ssd_scan``'s carried state and ``rmsnorm``'s
   split row, merged after one all-gather;
15. the paper's hot-topics and reputation applications
   (``examples/torch_hot_topics.py``, ``examples/torch_reputation.py``):
   a sequential updater that emits into a second, associative updater
   with an ``emit`` of its own, on the card.
"""
import importlib

_WHERE = {
    "App": "repro_torch.api", "RuntimeConfig": "repro_torch.api",
    "Stream": "repro_torch.api", "PlanError": "repro_torch.api",
    "EventBatch": "repro_torch.core.event",
    "Operator": "repro_torch.core.operators",
    "Mapper": "repro_torch.core.operators",
    "Updater": "repro_torch.core.operators",
    "AssociativeUpdater": "repro_torch.core.operators",
    "SequentialUpdater": "repro_torch.core.operators",
    "Workflow": "repro_torch.core.workflow",
    "Engine": "repro_torch.core.engine",
    "EngineConfig": "repro_torch.core.engine",
    "StateHandle": "repro_torch.core.engine",
    "OverflowPolicy": "repro_torch.core.queues",
    "SlateServer": "repro_torch.slates.http",
    "TelemetryConfig": "repro_torch.telemetry",
    "TelemetryReport": "repro_torch.telemetry",
    "DistributedEngine": "repro_torch.core.distributed",
    "DistConfig": "repro_torch.core.distributed",
    "AutoscalePolicy": "repro_torch.core.distributed",
    "MigrationReport": "repro_torch.core.distributed",
    "LoadAutoscaler": "repro_torch.telemetry",
}
_MODULES = {"ops": "repro_torch.api.ops", "ml": "repro_torch.ml"}

__all__ = [
    # declarative app layer (the front door)
    "App", "RuntimeConfig", "Stream", "ops", "PlanError",
    # events & operators (shared by both API styles)
    "EventBatch", "Operator", "Mapper", "Updater", "AssociativeUpdater",
    "SequentialUpdater",
    # engine layer (explicit control when the builder is not enough)
    "Workflow", "Engine", "EngineConfig", "StateHandle", "OverflowPolicy",
    "SlateServer",
    # multi-shard engine and live elasticity (DESIGN.md sections 4, 12)
    "AutoscalePolicy", "DistributedEngine", "DistConfig",
    "MigrationReport",
    # telemetry + the closed control loop (DESIGN.md section 13)
    "LoadAutoscaler", "TelemetryConfig", "TelemetryReport",
    # streaming-ML subsystem (DESIGN.md section 16)
    "ml",
]


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(_WHERE[name]), name)
    if name in _MODULES:
        return importlib.import_module(_MODULES[name])
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
