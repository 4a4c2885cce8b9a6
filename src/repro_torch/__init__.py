"""MapUpdate on PyTorch/CUDA — the port of ``repro`` (JAX/Pallas) to one
NVIDIA H100.

The port keeps the JAX package's module layout and public names, so each
counterpart sits at the same relative path (``repro_torch.core.engine.
Engine`` <-> ``repro.core.engine.Engine``).  Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a CUDA C++ kernel under
``csrc/``, compiled for ``sm_90a`` at first use
(``kernels/_build.py``).

Ported so far: the single-shard MapUpdate tick (events, queues,
operators, the slate table, both updater paths and the engine loop,
with the ``slate_update`` and ``slate_lookup`` kernels) and its in-tick
telemetry (the count-min sketch and latency histograms on the
``countmin_update`` / ``histogram_update`` kernel, the windowed
``TelemetryReport``, tracing, ``/metrics``, the hot-key cache and the
HTTP slate server), and LM serving on the engine (``ml.serve_app``: the
dense decoder of ``models/`` — qwen2 / qwen1.5 / gemma-7b — with the
``flash_attention`` and ``decode_attention`` kernels, feeding a
per-request slate).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.

Importing this package imports nothing heavy: modules are imported
where they are used (``from repro_torch.core.engine import Engine``).
"""
