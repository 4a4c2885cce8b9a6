#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--ticks 64] [--seed 0]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's kernels from ``src/repro_torch/csrc`` into
``build/repro_torch/``, then:

1. prints the card (``nvidia-smi`` name and power limit), the torch /
   CUDA versions and the host's CPU limits (torch's threads,
   ``os.cpu_count()``, the affinity mask, the cgroup quota); the CPU
   runs of 15c, 16c and 21 take the least of them as torch's thread
   count (``cpu_threads``, a guard against a cgroup quota) and restore
   it after;
2. builds every kernel (one nvcc per source, all started together) and
   prints the build time;
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes (B=65,536 events, D=8 lanes, C=2**22 slots,
   Q=4,096 reads; a 2 x 2048 count-min sketch over Zipf keys hashed by
   ``telemetry.sketch.columns``; a 128-wide latency histogram row with
   ages over all 32 buckets), for int32 and int64 keys.
   ``slate_update`` runs three key mixes: Zipf(1.2) over 1,048,576 keys
   (the main path's), uniform over them (short runs) and one key for
   the whole batch; each for sum and max, int32 and int64 keys, bitwise
   on integer deltas, within 2*(n+1)*2**-24*(|table|+sum|d|) on float
   deltas and bitwise on a second call; each timed beside its plain
   version, ``index_add_`` (sum) and ``index_reduce_`` (amax) on each
   row's run slot, which must give the plain version's table first.
   ``slate_lookup``'s three routes, int32 and int64 keys, each bitwise
   against its plain version: ``cand`` (given candidates) and ``keys``
   (the chain hashed in the kernel) at the read shape (Q=4,096 over
   2**22 slots holding 1,048,576 keys, a quarter expired by TTL; half
   the queries live, a quarter dead, a quarter absent), ``keys`` also
   timed beside today's read path (the torch hash and a ``cand``
   launch); ``find`` (hashed, first hit or empty slot, pending rows
   only) at the insert shape (B=65,536 rows of a Zipf batch, pending on
   the run-last rows, over a table holding the 1,048,576 even keys
   below 2**21, load 0.25), also with nothing pending.
   The count kernels' fused routes (keys hashed in the kernel; ages
   bucketed in it, the tick read on the card or passed as an int) are
   held bitwise against their plain compositions at Zipf keys, int32
   and int64 extremes, and ages on every bucket edge, int32 max and
   negative, and timed beside the unfused kernel with its helper ops.
   The two
   attention kernels at the serving shapes of phases 7 and 8 (flash:
   8 x 256 tokens, heads of 64, bf16, causal; decode: 8 requests over a
   512-row bf16 cache, ragged lengths; 14 query heads over 2 kv heads
   for qwen2-0.5b, 32 over 32 for zamba2-1.2b) and of phases 10 and 11
   (gemma3-1b: 8 x 1,024 tokens, 4/1 heads of 256, windowed at 512 and
   global, decode over a 1,088-row cache at lengths 641-1,055;
   deepseek-v2-lite-16b's MLA: 8 x 256 tokens, 16/16 heads, Dh 192 over
   Dv 128, decode over a 512-row cache at lengths 33-287), where
   ``flash_attention`` must take its tensor-core route and both give the
   same bits on a second call, and cases for a window, q_offset, f32, Dh=72 (the
   CUDA-core route, asserted), Dh=128, Dv != Dh, a packed QKV view, two
   decode rows and a 4096-row cache whose splits are empty, partial and
   full (tolerance 2e-2 bf16, 5e-5 f32), and the shapes of phase 14:
   ``flash_attention`` bidirectional with Sq != Skv (llama-3.2-vision-
   11b's cross prefill, a 64- and a 256-token bucket over 1,600 image
   rows, 32/32 heads of 128; a ragged last key tile at 1,601 rows),
   whisper-tiny's 6/6 heads of 64 (encoder and cross, bidirectional;
   decoder self, causal), ``decode_attention`` with as many kv heads as
   query heads over every source row (1,600 rows at 32/32 of 128; 256 at
   6/6 of 64), whisper's self decode, and a qwen2-0.5b 320-row cache
   with an idle slot's length past it (clamped); the llama and whisper
   cross cases each timed beside their bound and SDPA (the ``shapes``
   of each row of the kernel line); ``ssd_scan`` at the prefill
   shape of phase 8 (8 x 256 tokens in one chunk, 64 heads, N=P=64,
   bf16, q and k head-broadcast views), which must take its tensor-core
   route ("mma"), the same shape with q and k per head, across 8
   chunks, on a ragged last chunk, with P != N, and on the CUDA-core
   route ("simt") at N = P = 24 and in f32 (every route asserted; y
   within 2e-2 / 5e-5 of max|y| + 1, the state within 5e-4), both routes
   timed on the serving values; ``rmsnorm`` at the six shapes of the
   serving paths (prefill 2048 rows, x from HBM, and decode 8 rows, of
   D = 896, 2048 and 4096, on its register route) each beside
   ``F.rms_norm``, scale_offset, f32
   and an odd D (its loop route; bf16 within one ulp of each value, f32
   within 5e-5); ``ssd_scan`` and ``rmsnorm``
   also give the same bits on a second call — and times kernel and plain
   version on the same inputs by device time from torch.profiler.  No
   single PyTorch call computes ``slate_lookup`` or the chunked SSD
   recurrence (a hashed probe walk fused with a row gather; a scan over
   chunks), so they have no library time; the two count updates are
   timed beside ``torch.bincount``, the attention kernels beside
   ``scaled_dot_product_attention`` at both serving shapes (the
   kernel line holds qwen2-0.5b's; zamba2-1.2b's are logged on their
   own line), ``rmsnorm`` beside
   ``torch.nn.functional.rms_norm`` (the kernel line holds 2048 x 2048;
   the other shapes are logged on their own lines).  The two backward
   kernels of the training step against autograd of their plain
   versions on the card (bf16 within 2**-5 of the reference gradient's
   largest magnitude, f32 within 1e-4 of it; two calls bitwise equal;
   each case's route asserted): ``flash_attention_bwd`` at phase 17's
   shape (4 x 1,024 tokens, 14/2 heads of 64, causal), gemma3-1b's local
   layers (Dh 256, window 512), whisper-tiny's cross attention (256 over
   384 keys, bidirectional), deepseek-v2-lite-16b's MLA (Dh 192 over Dv
   128) and a chunked prefill's q_offset on the ``wgmma`` route, an f32
   shape on ``simt``, the forward's output bitwise the same with its row
   statistics; ``rmsnorm_bwd`` at phase 17's 4,096 rows of 896, bf16
   with and without scale_offset on ``regs``, f32 on ``loop``; each
   timed at phase 17's shape on both routes (the CUDA-core or loop route
   on unaligned copies of the same values) beside its plain backward and
   the library's backward under autograd (SDPA's, ``F.rms_norm``'s) as a
   yardstick;
4. checks that a ``run_chunk`` tick never syncs the host (torch's sync
   debug mode set to "error"), on a small engine, with telemetry off
   and on;
5. drives the main path end to end through the engine's entry points:
   ``S1 -> M1 (pass-through) -> S2 -> {U1 sum, U2 max}`` with
   ``table_capacity=2**22`` per updater, 65,536 events a tick,
   ``Engine.run`` over ``--ticks`` ticks, ``drain``, then
   ``read_slates`` / ``read_slate``.  Keys are Zipf(1.2) over 1,048,576
   keys drawn on the card from a seeded generator; lane 0 of each value
   is 1 (a count) and lanes 1-7 integers in [0, 8), so every lane is
   exact in f32.  Every slate is held against an independent numpy
   reference (bincounts and maxima over every event fed), the launch
   counters must show both kernels ran, and no queue may drop.  Every
   read must take ``slate_lookup``'s ``keys`` route and every
   ``insert_or_find`` walk its ``find`` route (a positive multiple of
   INSERT_ROUNDS launches), no launch ``cand``, and no torch probe hash
   or walk may run (``torch_probe_calls``; the same in phases 6-8).  Its
   profiled ticks give ``slate_update``'s device ms under its own name.
6. drives the telemetry path: the same workflow and feed with
   ``EngineConfig(telemetry=TelemetryConfig())`` (depth 2, width 2048,
   sample 128, window 8, 32 latency buckets), event times lagged by
   0-63 ticks, once alone for its ms/tick and once while a reader
   thread asks the HTTP server of
   ``StateHandle.serve`` (with a ``HotKeyCache``) for ``/slate``,
   ``/slates``, ``/status`` and ``/metrics``.  It checks the slates
   against the same reference (telemetry on vs off parity), the last
   report's top heavy hitter (key 0, the Zipf head, estimated at least
   at its true count in that window), each arc's histogram against a
   numpy bucketing of the ages, the ``/metrics`` page, that all four
   kernels ran and that every count launch took its fused route (keys,
   ages); its profiled ticks give the device operations a tick beside
   phase 5's.
7. drives the serving path: qwen2-0.5b at full width with random weights
   from ``--seed``, a ``Workflow`` of ``LMServeMapper(max_new=32,
   cache_len=512, bucket=8)`` and ``RequestSlate`` on
   ``Engine(EngineConfig(batch_size=16))``, fed by ``request_source`` 16
   requests (prompts of 32-256 tokens padded to 256) in one tick, then
   ``drain`` (the first 16 of the 64 requests it once served, later 32,
   cut for the time limit as phases 8-12 and 15c are).  Every request's slate, read through
   ``read_slates``, must equal bitwise the tokens of a direct greedy loop
   over ``lm.prefill`` / ``lm.decode_step`` on the same microbatches;
   one microbatch's teacher-forced prefill and decode logits with the
   kernels must lie within 0.125 of those with the plain versions (top-1
   equal wherever the margin exceeds that); a microbatch must launch
   ``flash_attention`` 24 times, ``decode_attention`` 24 x 31 and
   ``rmsnorm`` (24 x 2 + 1) x 32 times; a reduced-config serving tick
   runs under torch's sync debug mode.  It prints ms/tick, generated
   tokens/s and, from one profiled tick, device busy time, the idle share,
   the top kernels and the two attention kernels' device ms.
8. drives the same serving path on zamba2-1.2b at full width (38
   Mamba-2 layers of d_model 2048 with 64 SSD heads of N=P=64, one
   weight-shared attention block after every 6, vocab 32,000; random
   weights): the same workflow and checks, the feed's first 8 requests
   (once 32; cut for the time limit), with a teacher-forced
   tolerance of the plain path's own bf16-vs-f32 distance (measured;
   this model amplifies a rounding from block to block) and a
   microbatch launching ``ssd_scan`` 38 times, ``flash_attention`` 6,
   ``decode_attention`` 6 x 31 and ``rmsnorm`` 89 x 32 (38 x 2 + 6 x 2 +
   1 norms a forward), every ``ssd_scan`` launch on "mma" and every
   ``rmsnorm`` launch on "regs" in both serving phases; its profiled tick
   also gives ``ssd_scan``'s and ``rmsnorm``'s device ms by route.
9. drives the same serving path on xlstm-350m at full width (12 mLSTM
   and 12 sLSTM blocks of d_model 1024, 4 heads, mLSTM N = 512, P =
   513; random bf16 weights drawn by ``lm.init(..., dtype=bf16)``, as in
   every serving phase): the first 16 of the 32 requests it once
   served, in one tick (prompts of 32-256 tokens padded to 256),
   the same checks; a microbatch
   launches ``rmsnorm`` (12 x 2 + 12 + 1) x 32 times and ``ssd_scan``
   never (asserted: the mLSTM's P = N + 1 fails the kernel's
   ``supported()``, the JAX package's own rule, so the plain SSD runs);
   the sLSTM runs as a Python loop of 256 steps a block.
10. gemma3-1b at full width (26 layers, d_model 1152, 4/1 heads of 256,
   a 512-token window on 5 of every 6 layers, vocab 262,144): 8
   requests (once 16) with prompts of 640-1,024 tokens padded to
   1,024,
   ``cache_len`` 1,088, so the window binds at prefill and in every
   decode step; a microbatch launches ``flash_attention`` 26 times,
   ``decode_attention`` 26 x 31 and ``rmsnorm`` 53 x 32.
11. deepseek-v2-lite-16b at full width (27 MLA layers, rank 512, Dh 192
   over Dv 128; one dense layer, then 26 MoE layers of 64 routed experts
   top-6 and 2 shared; 15,706,357,760 parameters by the config's count,
   drawn in bf16 block by block): phase 9's feed; a microbatch launches
   ``flash_attention`` 27 times, ``decode_attention`` 27 x 31 and
   ``rmsnorm`` (3 x 27 + 1) x 32.  Its teacher-forced checks replay the
   kernel run's expert routing in the plain runs (``pinned_routing``),
   and its end-to-end tolerance is the plain path's own bf16-vs-f32
   distance plus qwen2's per-layer rule for 27 layers (the f32 run casts
   the bf16 weights where the layers use them: no f32 copy of the
   model).  The teacher-forced check of phases 7, 10 and 11 fails when
   no position's top-2 margin exceeds its tolerance.
12. drives the durable engine through a crash and its recovery: phase
   5's workflow and feed (``--seed``) with keys mapped to 64-bit ids
   (``wide_ids``: rank r -> ((r + 1) << 32) | (r * 2654435761 mod 2**32),
   so both halves of a key vary and every id exceeds 2**32), on
   ``EngineConfig(batch_size=65,536, queue_capacity=262,144,
   chunk_size=8, key_dtype="int64")`` with ``DurabilityConfig(flush=
   FlushConfig(), barrier=True, replicas=3, write_quorum=2,
   read_quorum=2, track_flush_deltas=True)`` in a temporary directory.
   An uninterrupted durable run of 48 ticks (timed, against phase 5's
   ms/tick, WAL bytes and append seconds a tick, each flush's begin and
   commit: rows, seconds, store bytes) is held against the numpy
   reference; a child process (this script with ``--durable-child DIR``)
   runs the same durable run in a second directory and kills itself with
   SIGKILL inside ``source_fn`` at source tick 40, after two frontiers.
   Here, with store replica 0 down, ``Engine.recover()`` (its restore
   and replay walls printed) and ``run`` from the frontier's source tick
   plus the source ticks the log holds after it, to tick 48, then
   ``drain`` and a ``checkpoint``.  Every slate of both updaters must
   equal the reference and the uninterrupted run's, bitwise, key by key,
   with the same engine tick and no queue drop; ``processed`` counts
   restart at the frontier, so they must equal the replayed and resumed
   events; a ``SlateReplica`` refreshed in full at the frontier and then
   from the flush deltas must answer ``read_many`` over phase 5's read
   set as ``read_slates`` does; every ``insert_or_find`` walk (restore,
   replay, resumed run) takes ``slate_lookup``'s int64 ``find`` route,
   every read its ``keys`` route, none ``cand``.  A profiled durable
   chunk gives the device operations and busy ms a tick.
13. drives the ``App`` front door (``repro_torch.api``) in three parts.
   (a) Phase 5's workflow declared as an app — two function-style
   mappers the planner must fuse (``fused_chains``), ``ops.counter``
   and an ``@app.updater(merge="max")``, 2**22 slots each — run by
   ``App.run`` over 64 ticks of phase 5's feed with
   ``RuntimeConfig(batch_size=65,536, queue_capacity=262,144,
   chunk_size=8, telemetry=TelemetryConfig(trace=True))``, then
   drained: every slate equals the numpy reference and a run of phase
   5's subclass ``Workflow`` over the same ticks (keys in the same
   slots), bitwise, through ``read_slates``, ``read_slate`` and the
   tables; no queue drops; ``slate_update`` runs on sum and on max
   (``launches_by_op``), ``slate_lookup`` on ``keys`` and ``find`` only,
   the count kernels on their fused routes; ``app.telemetry()`` names
   key 0 first, ``app.serve()`` answers ``/slate/U1/0`` and
   ``export_trace`` writes the spans; ms/tick and events/s beside
   phase 5's.  (b) ``ops.model_mapper`` of qwen2-0.5b at full width in
   f32 (random weights from ``--seed``, microbatches of 32 events of 32
   tokens) feeding ``ops.semantic_topk(k=8, n_slots=32)`` and
   ``ops.personalization(d=896, k=4)``: 256 events a tick over 8 ticks
   keyed by 1,024 Zipf(1.2) topics, items in [1, 2**10), then drained
   (the head topic's events beyond ``max_run`` are deferred, asserted).
   Tick 0's embeddings lie within 2**-16 of max |emb| of the plain
   versions' (``lm.forward`` with ``impl="ref"`` kernels), and the plain
   path with the attention's or the norm's output rounded to bf16 lies
   outside that bound (the control); every
   ``SemanticTopK`` slate equals, bitwise, the maximum per column of
   the packed words of the mapper's own emitted embeddings; every
   ``Personalization`` slate equals a per-event host replay (f32 numpy,
   the events in the order the engine's queue semantics give:
   ``sequential_order``) — ``n`` and the profile bitwise, items and
   candidates exact and scores within 2**-14 of the largest for every
   topic whose replay met no near-tie; a microbatch launches
   ``flash_attention`` 24 times on ``simt`` and ``rmsnorm`` 49 times on
   its f32 route; ms/tick, events/s and one profiled tick.  (c)
   ``build_serve_app`` serves phase 7's 16 requests on qwen2-0.5b
   through ``App.run``: their slates equal phase 7's bitwise, with
   phase 7's launches a microbatch; then ``python -m
   repro_torch.launch.stream`` runs in subprocesses, uninterrupted and
   crashed at source tick 40 then ``--recover``, at ``--batch 64`` and
   at its default 256.  At 64 the recovered run prints the
   uninterrupted run's stats (``processed`` aside: it restarts at the
   frontier) and slates.  At 256 the table drops at the probe limit and
   recovery may drop other keys (a fault of the reference, ROADMAP
   queue 3): the tick matches, every key that neither run dropped holds
   the same slate bitwise in both stores, and the divergence is printed.
14. drives the continuous-batching ``ServingEngine`` (``repro_torch.
   launch.serve``) at full width with random bf16 weights from
   ``--seed``, 8 slots, 2 admissions a tick, 16 requests (14a; 8 in
   14b and 14c; once 32 each) of 32 new tokens each, until
   drained.  (a) qwen2-0.5b, cache 320, bucket 64:
   phase 7's 16 requests, the last 8 held back and released one at
   a time whenever every slot is idle, until an idle slot decodes at a
   write index past the cache (its state snapshot before that tick must
   be bitwise unchanged after it: the write was dropped); a thread reads
   the engine's status server (``/status``, ``/slate/requests/<rid>``,
   ``/metrics``) meanwhile, and every request's page equals its tokens
   after the run; the tokens equal phase 7's (hence 13c's) but where a
   request parts at a top-2 margin below 0.25 (teacher-forced).  (b)
   whisper-tiny at full width (4 + 4 layers, d_model 384, 6/6 heads,
   vocab 51,865), cache 256 = bucket (the reference's limit), prompts
   32-224.  (c) llama-3.2-vision-11b at full width (40 layers, 8 of
   them cross-attention over 1,600 image rows; ~1.0e10 parameters drawn
   in bf16), cache 512, bucket 64, prompts 32-256.  Each: exact launches
   from the schedule (a prefill an admission, a decode step a tick with
   an active slot; ``engine_launches``), ``flash_attention`` all on
   ``wgmma``; ms/tick and generated tokens/s over the unprofiled ticks
   (the tokens those ticks emitted over their wall time), one profiled
   tick's busy ms, device operations and idle share (of that tick's own
   wall), GiB allocated; then one microbatch teacher-forced (prefill and
   a decode step) and block by block, kernels against plain versions,
   with random ``enc_frames`` / ``image_embeds`` (the engine's zero
   memories null cross-attention), whose control (the plain path with
   every cross-attention output zeroed) must lie outside the tolerance;
   block by block, each cross-attention sublayer's own output is held
   within 2**-5 of its magnitude too, the gate for cross attention (a
   zeroed one reads 1 there).  (d) the request journal: a
   child (this script with ``--serve-child DIR``) serves qwen2-0.5b for
   40 ticks and kills itself with SIGKILL; a fresh process
   (``--serve-recover DIR``) recovers exactly the accepted but
   unfinished requests, resubmits and finishes each.
15. drives the multi-shard engine (``repro_torch.core.distributed``)
   with 8 shards on the card.  (a) Phase 5's workflow and feed (the
   same events each tick, as ``[8, 8,192]`` sources) on
   ``DistConfig(batch_size=32,768, queue_capacity=131,072, chunk_size=8,
   exchange_slack=4.0)`` with 2**19 slots an updater a shard, ``--ticks``
   ticks
   through ``DistributedEngine.run`` (first its sizing on the same feed:
   every (source, destination) bucket within ``cap_per_dest``, every
   shard's receipt within ``batch_size``): the slates, over all shards'
   rows, equal phase 5's numpy reference through ``read_slates``,
   ``read_slate`` and the tables; no exchange, queue or table drop;
   ``processed`` the feed's counts; launches exact (a tick runs each
   updater on each shard: one ``slate_update``, 4 ``find`` walks; each
   read a ``keys`` lookup a shard it walks); ms/tick and events/s beside
   phase 5's, GiB allocated, one profiled chunk's busy ms, device
   operations, idle share and the exchange's share of the device time
   (a ``record_function`` range), and the exchange alone at its widest
   hop.  Before it, a chunk of the sharded engine under the sync debug
   mode "error", telemetry off and on with split keys.  (b) The same
   feed with telemetry on (each shard's sketch and histograms on the
   count kernel's fused routes) and ``hot_key_capacity=8``: after 16
   ticks the sketch's top 2 heavy hitters are split, then 48 more
   ticks; each split key sits on its two ring shards and ``read_slate``
   merges the partials to the reference; every slate, partials merged,
   equals the reference; launches exact.  (c) Fail-over on a reduced run
   (2**14 slots a shard, 4,096 numpy-drawn Zipf events a tick, 16 ticks,
   ``fail_shard(3)`` at tick 8): state and stats bitwise equal to the
   same run on the CPU.  (d) Phase 12 at 8 shards: 64-bit ids, a flush
   every 16 ticks to 3 store replicas in quorums of 2, a child (this
   script with ``--sharded-durable-child DIR``) killed by SIGKILL at
   source tick 40, ``recover`` with replica 0 down and the resumed run:
   every slate bitwise against the uninterrupted run's, key by key.
16. drives live elasticity on the card.  First, after each kind of
   reconfigure (a physical grow, a leave, a rebalance), a chunk of the
   sharded engine under the sync debug mode "error".  (a) 15a's
   workflow and feed from 8 shards at 2**20 slots an updater a shard
   (``ELASTIC_C``) with ``exchange_slack`` 8.0 (sized
   for 16 shards: ``sharded_sizing`` at 16), ``AutoscalePolicy(scale_at=
   {8: 16, 24: 8, 40: 16})`` through ``run`` over 63 ticks (a grow on
   the host tier, a leave and a rejoin on the device tier), then a
   weighted ``rebalance`` (device tier, profiled), a tick of backlog and
   ``remove_shards([15], drain_max=0)`` (device tier through
   ``exchange_queue``), a leave to 4 active of 16 slots that compacts
   (host tier, ``n_shards`` 4; GiB before and after) and ``compact()``
   (a no-op, ``path`` "none"): every merged slate and read equals the
   numpy reference over the 64 ticks, no exchange, queue or table drop,
   each report's tier and shape as listed, rows moved, exact launches
   (each tick runs every physical slot; a device-tier rebuild runs
   ``insert_or_find`` on every slot, a host-tier one inserts chunks of
   256 rows on the card); ms/tick by active count; each reconfigure's
   ``pause_s``, ``drain_ticks``, ``bytes_moved`` and GB/s.  (b) the
   closed loop: 15a's feed with telemetry on, the valid share a square
   wave (whole for 15 ticks, a tenth for 15), 60 ticks from 8 shards,
   ``batch_size`` 16,384, ``LoadAutoscaler(high=0.75, low=0.25,
   window=3, dwell=2, cooldown=1, min_shards=8, max_shards=16)`` with a
   control log: the active count reaches 16 and ends at 8, at most 5
   flips, slates the reference's, no drop, exact launches (the count
   kernel's too); each decision's ``pause_s`` printed.  (c) 16a's
   schedule at 2**14 slots a shard, 2,048 numpy events a tick, 16 ticks,
   then a rebalance and a compacting leave, on the card with
   ``device_migration`` "auto" and "off" and on the CPU with "auto":
   every read equal across the three, the "auto" runs' states, stats
   and reports bitwise card = CPU.  (d)
   15d's durable configuration at 2**15 slots a shard and 8,192 events
   a tick, 44 ticks, ``scale_at={16: 16}``; a child (this script with
   ``--elastic-durable-child DIR``) killed by SIGKILL at source tick 40;
   ``recover`` on 16 shards and the resumed run: every slate bitwise
   against the uninterrupted run's.
17. trains qwen2-0.5b at full width on the card: ``launch.train.
   Trainer``, f32 master weights from the seed, bf16 compute, default
   AdamW, batch 4 x 1,024 tokens from ``TokenStream(seed=0)``.  (b) The
   first step's gradients, the kernels' path against the plain versions
   at f32 compute, leaf by leaf in relative L2, within twice the plain
   versions' own bf16 path's distance.  (c) Six steps straight, the
   first a warm-up: ms/step and tokens/s over the other five,
   ``max_memory_allocated``, and each kernel's launches a step asserted
   (a block's forward kernels twice under remat and its backward kernels
   once; the final norm once each way; all ``flash_attention`` and
   ``flash_attention_bwd`` on ``wgmma``, all ``rmsnorm`` and
   ``rmsnorm_bwd`` on ``regs``, over the five steps and over the whole
   phase).  (a) Three steps, a
   checkpoint to a temporary directory, a simulated failure, a new
   ``Trainer`` restored from it and three more steps: parameters and
   optimizer state bitwise equal to the straight run's; then one
   profiled step (device busy ms, operations, idle share, the top
   kernels and the four training kernels' shares).  (d) A zamba2-1.2b
   train step on the card raises (``ssd_scan`` has no backward kernel
   yet, ROADMAP queue 1 item 22).
18. the mesh slice on a (1, 1) NCCL mesh over the card (``mesh_path``:
   ``Trainer(mesh=...)``, a deepseek MoE layer, the ``ServingEngine`` on
   the mesh, then the dry runs); its NCCL world of one stays up for 19.
19. drives the multi-shard engine over the ranks of that world of one
   (the card machine has one H100, and NCCL refuses two ranks on one
   card), on ``make_mesh(..., group=WORLD)``: 15a's deployment (8
   shards, 2**19 slots an updater a shard, ``[8, 8,192]`` sources of
   phase 5's feed) for 16 ticks, its state bitwise 15a's after 15a's
   first 16 ticks (15a keeps a copy on the card) and its launches
   exactly 15a's over them besides the served reads' lookups.  The run
   is served over HTTP (``StateHandle.serve`` on rank 0): a reader
   thread a path (``/slate/U1/<k>`` of 5 keys, ``/slates/U1`` of the
   4,096-key read set, ``/status``, ``/metrics``) while it goes, each
   answer from the drain of a chunk boundary with its source tick, the
   keys' sums never falling; then a batch queued after the run that
   ``close()``'s last drain answers; every answer at tick 16 byte for
   byte what 15a's engine serves from its kept state; a drain's
   broadcasts (1 empty, 2 otherwise) and one ``all_gather`` a read
   asserted; it prints an empty drain's ms and a read's p50 / p99
   from enqueue to answer.  Then, with the queues' backlog in place,
   ``scale`` 8 -> 4 -> 8 on the device tier (``exchange_rows`` and
   ``exchange_queue`` over the group, events moved), a drain and 15a's
   reads, each bitwise what 15a's engine gives from its kept state;
   one ``all_to_all_single`` a hop (3 a fed tick, 2 a drain tick, one
   for each updater and each queue a reconfigure), every slate equal
   to the numpy reference; before it a rank-path chunk under the sync
   debug mode "error"; ms/tick and busy ms beside 15a's, and the
   collective alone (a local copy at a world of one).
20. the kernel routes across ranks at full width, R ranks emulated on
   the card (it has one; NCCL refuses two ranks on one card): whole
   tensors cut into R slices as ``Shard`` cuts them, the route's own
   local half (the kernel) on each slice at its offset, the partials
   stacked as the all-gather delivers them and the route's own merge
   (``decode_attention/ops.merge``, ``ssd/ops.fold``, the sum of the
   stacked partials), at R = 2 and 16 (the production mesh's "model" axis), each held
   against the whole-tensor kernel and the plain version, two calls
   bitwise equal, the launches asserted.  ``decode_attention``'s split-K
   (the ``partial`` kernel: f32 o and log-sum-exp) for gemma3-1b (4/1
   heads of 256, window 512 and global) and qwen2-0.5b (14/2 of 64), 8
   requests over a 32,768-row bf16 cache, ragged lengths, one of them
   (16,584) straddling the slices at both R with its window too (o
   within 2e-2 and within 2**-6 of each (request, head) row's largest
   magnitude; the merged log-sum-exp within 1e-3 of 1 + |lse| of the
   whole cache's, from the kernel and the plain version); ``ssd_scan``'s carried state (each slice scanned from zero,
   the fold, a second scan from the carried state on every slice but the
   first) at zamba2-1.2b's scan, 8 x 4,096 tokens, 64 heads, N = P = 64,
   chunk 256, bf16, on the "mma" route (y within 2e-2, the state within
   5e-4 of max + 1); ``rmsnorm``'s split row (``rmsnorm_sums`` on each
   rank's columns, the rows' total, ``rmsnorm`` given it) and
   ``rmsnorm_bwd`` given the rows' sums, 8 x 4,096 rows of zamba2's 2,048
   (one bf16 ulp; gradients within 2**-5 of max).  Each timed beside the
   whole-tensor kernel: a rank's own work (its slice and the merge) and
   all R slices on the one card, with the bound of one whole pass's bytes
   at 3.35 TB/s; in the kernel line under each row's ``routes``.
21. the paper's two applications that chain updaters, through
   ``App.run`` and a drain, from ``examples/torch_hot_topics.py`` and
   ``examples/torch_reputation.py`` (their ``build_app`` /
   ``make_feed``), G copies of each example's stream side by side in
   one key space.  (a) Hot topics at G = 128: 65,536 tweets a tick over
   2,048 topics (FEAT 32), 40 ticks, from minute 5 60% of a group's
   tweets on its topic 16g + 3; U1 sequential (``max_run`` 192, its
   emissions the next hop's events), U2 associative with an ``emit``
   (the generic path: segmented scan, ``insert_or_find``, read, merge,
   write); ``RuntimeConfig(batch_size=262,144, queue_capacity=1,048,576,
   chunk_size=1)``, 524,288 slots each.  (b) Reputation at G = 128:
   1,048,576 users (celebrities 0-639, 30% of 65,536 mentions a tick),
   U1 sequential (``max_run`` 32) over 2**22 slots, batch 131,072, 30
   ticks.  Gates: each app at G = 8 on the card and on the CPU, state,
   every tick's outputs and stats bitwise, then a ``run_chunk`` of the
   card app under the sync debug mode "error"; at G = 128 against numpy:
   every U1 count the bincount of the (topic, minute) keys from an f32
   argmax of the same product (near ties within 1e-3 printed and left
   out), every U1 ``emitted``, U2 ``total`` and ``hot`` row's
   ``ratio_x100`` (drain ticks included) from the feed alone (a key
   (topic, m) emits on its first tweet of tick 4m + 3; near-tie topics
   left out), every U2 ``periods`` the sum of U1's ``emitted``, each
   burst topic its group's most frequent hot topic; every reputation slate's
   ``interactions`` exact and ``score`` bitwise an f32 replay in the
   engine's queue order (``sequential_order``, deferral included), the
   celebrities on top; reads through ``read_slates``; no drop; every
   ``insert_or_find`` on ``find`` (INSERT_ROUNDS an updater a tick),
   reads on ``keys``, no ``slate_update`` or count kernel launch, no
   torch probe hash.  Each prints ms/tick, events/s and one profiled
   tick beside phase 5's ms/tick.

Cut for the time limit, earlier paths' depths (to make room for phase
20; phase 21 cut none, its room came from bounding the CPU runs'
threads): ``--ticks`` defaults to 64 (128 before: phases 5, 6 and
15a); phase 7 serves 16 requests in one tick (32 in two), phases 8 and
10 8 (32, 16), 14a 16 (32; 8 of them held back, as before), 14b and 14c
8 (32).  Phases 9 and 11 keep their 16: cutting them to 8 saved 3.6 and
0.0 s (their fixed-cost checks set their walls).  Each phase's wall is printed at the end, beside phase
5's ms/tick as the host's speed marker (hosts differ by up to ~40 %).
Every serving phase also asserts every ``flash_attention`` launch on
its ``wgmma`` route and prints its own wall time.  Each path's launch
counters are set to 0 just before it and read just after.

The line before the last is the kernel table as JSON, a row for each
TPU kernel (``slate_lookup_wide``, the int64 instance of
``slate_lookup``, runs on the paths of phases 12, 15d and 16d); every
row must have run on
some path.  ``launches`` sums the paths, ``launches_by_path`` splits it,
``slate_update``'s ``by_mix`` holds its three mixes, the count
kernels' ``fused`` their fused routes, and the two ``slate_lookup``
rows' ``routes`` its three routes (their ``ms`` and bound are the
``keys`` route's, the read path's) and ``launches_by_route`` their
launches; the two backward kernels' rows hold both routes' times under
``routes`` (``ms`` is the main path's route: ``wgmma``, ``regs``) and
phase 17's launches by route.  The last line is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero and prints no result.  Without a CUDA device, or outside
a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
L2_BYTES = 50 * 2**20            # H100 SXM L2 cache
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 dense, tensor cores
SECTOR = 32                      # bytes per random device-memory access

B, D, C, Q = 65536, 8, 2**22, 4096
N_KEYS = 1 << 20
ZIPF_ALPHA = 1.2


def log(*a):
    print(*a, flush=True)


def sectors(nbytes: int) -> int:
    return -(-nbytes // SECTOR) * SECTOR


def device_ms(fn, reps=20, warmup=3, sessions=3):
    """Mean device time of ``fn()`` in ms: the sum of the kernels and
    copies it runs, from torch.profiler, with no host gaps between them.
    A profiler session that records no device events (it happens, rarely,
    after many sessions) is run again, up to ``sessions`` in all; after
    that the time comes from CUDA events around the ``reps`` calls (the
    device's elapsed time, gaps between launches included), and the log
    says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
        log("torch.profiler recorded no device time; profiling again")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    log(f"torch.profiler recorded no device time in {sessions} sessions; "
        f"CUDA events give {ms:.5f} ms a call (elapsed, not busy)")
    return ms


def zipf_cdf(device):
    import torch
    ranks = torch.arange(1, N_KEYS + 1, dtype=torch.float64, device=device)
    p = ranks.pow(-ZIPF_ALPHA)
    return torch.cumsum(p / p.sum(), 0)


def zipf_keys(cdf, n, gen):
    import torch
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=N_KEYS - 1).to(torch.int32)


def tick_values(n, gen, device):
    """[n, 8] f32: lane 0 = 1 (the count), lanes 1..7 integers in [0, 8)."""
    import torch
    v = torch.randint(0, 8, (n, D), generator=gen, device=device)
    v[:, 0] = 1
    return v.to(torch.float32)


# ---------------------------------------------------------------- phase 3
SLATE_MIXES = ("zipf", "uniform", "one key")


def slate_keys(mix, gen, dev):
    """[B] sorted int32 keys: Zipf(1.2) over N_KEYS (the main path's),
    uniform over N_KEYS (short runs), or one key for the whole batch."""
    import torch
    if mix == "zipf":
        keys = zipf_keys(zipf_cdf(dev), B, gen)
    elif mix == "uniform":
        keys = torch.randint(0, N_KEYS, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    else:
        keys = torch.full((B,), 7, dtype=torch.int32, device=dev)
    return torch.sort(keys).values


def slate_update_mix(mix, dev, gen):
    """One key mix: the kernel against its plain version for sum and max,
    int32 and int64 keys, bitwise on integer deltas and within the
    rounding of two orders on float deltas, bitwise on a second call;
    ``index_add_`` / ``index_reduce_`` against the plain version; then
    device times and the byte bound.  Returns (times, max_abs_err)."""
    import torch
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.kernels.slate_update import ref as ur
    keys32 = slate_keys(mix, gen, dev)
    last = torch.ones(B, dtype=torch.bool, device=dev)
    last[:-1] = keys32[1:] != keys32[:-1]
    n_runs = int(last.sum())
    slots = torch.full((B,), -1, dtype=torch.int32, device=dev)
    slots[last] = torch.randperm(C, generator=gen, device=dev)[:n_runs].to(
        torch.int32)
    seg = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.int64,
                                             device=dev), last[:-1].long()]),
                       0) - 1
    hot = int(torch.bincount(seg).max())
    table = torch.randint(0, 1000, (C + 1, D), generator=gen,
                          device=dev).to(torch.float32)
    ints = tick_values(B, gen, dev)
    floats = torch.randn(B, D, generator=gen, device=dev)
    log(f"slate_update {mix}: B={B} D={D} C={C} runs={n_runs} "
        f"longest_run={hot} ({hot / B:.3f} of the batch)")

    max_err = 0.0
    for kd in (torch.int32, torch.int64):
        # int64 keys beyond 2**33, negative ones too, keep the int32 order
        keys = keys32 if kd == torch.int32 else \
            keys32.to(torch.int64) * (2**33 + 1) - 2**40
        for op in ("sum", "max"):
            a = uk.slate_update(keys, ints, slots, table.clone(), op=op)
            b = ur.slate_update(keys, ints, slots, table.clone(), op=op)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"slate_update {mix} {op} {kd} differs "
                                     f"from its plain version")
        # float deltas: both sides are within (n + 1) * 2**-24 * mass of
        # the exact sum of a run of n terms plus the table value, in any
        # order; their difference is within twice that
        a = uk.slate_update(keys, floats, slots, table.clone(), op="sum")
        again = uk.slate_update(keys, floats, slots, table.clone(), op="sum")
        b = ur.slate_update(keys, floats, slots, table.clone(), op="sum")
        mass = torch.zeros(n_runs, D, device=dev).index_add_(
            0, seg, floats.abs())
        nrun = torch.bincount(seg, minlength=n_runs).float()[:, None]
        w = slots >= 0
        tol = torch.zeros_like(table)
        tol[slots[w]] = 2 * (nrun[seg[w]] + 1) * 2.0**-24 * (
            mass[seg[w]] + table[slots[w]].abs())
        err = (a - b).abs()
        torch.cuda.synchronize()
        if not bool((err <= tol).all()):
            raise AssertionError(f"slate_update {mix} float sum outside "
                                 "tolerance")
        if not torch.equal(a, again):
            raise AssertionError(f"slate_update {mix}: two calls on float "
                                 "deltas differ")
        max_err = max(max_err, float(err.max()))
        log(f"slate_update {mix} keys={str(kd)[6:]}: sum and max bitwise on "
            f"integer deltas; float sum max_abs_err={float(err.max())} "
            f"within 2*(n+1)*2**-24*(|table|+sum|d|), a second call "
            f"bitwise")

    # the library yardstick: each row scattered to its run's slot (the
    # sink row C for rows of unslotted runs), built outside the timing
    seg_slot = torch.full((n_runs,), C, dtype=torch.int64, device=dev)
    seg_slot[seg[last]] = slots[last].long()
    ev_slot = seg_slot[seg]
    lib_sum = lambda t: t.index_add_(0, ev_slot, ints)
    lib_max = lambda t: t.index_reduce_(0, ev_slot, ints, "amax",
                                        include_self=True)
    for op, lib in (("sum", lib_sum), ("max", lib_max)):
        want = ur.slate_update(keys32, ints, slots, table.clone(), op=op)
        if not torch.equal(lib(table.clone())[:C], want[:C]):
            raise AssertionError(f"the library call for {op} differs from "
                                 f"slate_update's plain version ({mix})")
    scratch = table.clone()
    t = {"ms": device_ms(lambda: uk.slate_update(keys32, ints, slots,
                                                 scratch)),
         "max_ms": device_ms(lambda: uk.slate_update(keys32, ints, slots,
                                                     scratch, op="max")),
         "plain_ms": device_ms(lambda: ur.slate_update(keys32, ints, slots,
                                                       scratch)),
         "library_ms": device_ms(lambda: lib_sum(scratch)),
         "library_max_ms": device_ms(lambda: lib_max(scratch))}
    # keys, int32 slots and deltas read once; one row read and written
    # per run
    nbytes = (B * 4 + B * 4 + B * D * 4
              + n_runs * 2 * sectors(D * 4))
    ops = B * D
    t["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    log(f"slate_update {mix} int32: kernel sum {t['ms']:.5f} ms, max "
        f"{t['max_ms']:.5f} ms; plain {t['plain_ms']:.5f} ms; index_add_ "
        f"{t['library_ms']:.5f} ms, index_reduce_ amax "
        f"{t['library_max_ms']:.5f} ms (device time, torch.profiler, mean "
        f"of 20); bound {t['bound_ms']:.6f} ms ({nbytes} bytes at 3.35 "
        f"TB/s)")
    return t, max_err


def check_slate_update(dev, seed):
    """Three key mixes at the main path's shape; the kernel line holds
    the Zipf mix (the main path's), ``by_mix`` all three."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    by_mix, max_err = {}, 0.0
    for mix in SLATE_MIXES:
        by_mix[mix], err = slate_update_mix(mix, dev, gen)
        max_err = max(max_err, err)
    z = by_mix["zipf"]
    return {"name": "slate_update", "route": "cuda",
            "source": "src/repro_torch/csrc/slate_update.cu",
            "replaces": "src/repro/kernels/slate_update/kernel.py:83",
            "max_abs_err": max_err, "ms": z["ms"], "plain_ms": z["plain_ms"],
            "bound_ms": z["bound_ms"], "bound_by": "bytes",
            "library_ms": z["library_ms"], "by_mix": by_mix}


def probes_to_stop(table_keys, query, cand, empty_stops):
    """Probes the walk must read, summed over the queries: up to the
    first hit (or, with ``empty_stops``, the first ``EMPTY``), all P
    where none stops it."""
    import torch
    ck = table_keys[cand]
    stop = ck == query[None]
    if empty_stops:
        stop |= ck == -1
    first = torch.where(stop.any(0), torch.argmax(stop.to(torch.uint8), 0)
                        + 1, cand.shape[0])
    return int(first.sum())


def route_times(name, kernel, plain, nbytes, **more):
    """Device ms of a route and of its plain version, and the byte bound;
    ``more`` names other callables to time beside them."""
    t = {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    t.update({k: device_ms(fn) for k, fn in more.items()})
    extra = "".join(f", {k} {v:.5f} ms" for k, v in t.items()
                    if k in more)
    log(f"{name}: kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms"
        f"{extra} (device time, torch.profiler, mean of 20); bound "
        f"{t['bound_ms']:.6f} ms ({nbytes} bytes at 3.35 TB/s)")
    return t


def same_outputs(name, got, want):
    """Bitwise equality of two output tuples (None beside None); returns
    the largest absolute difference (0)."""
    import torch
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if (a is None) != (b is None) or (
                a is not None and (a.dtype != b.dtype
                                   or not torch.equal(a, b))):
            raise AssertionError(f"{name} differs from its plain version")
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want) if a is not None and a.numel())


def lookup_read_routes(dev, gen, kd):
    """The read shape: Q queries over a table of C slots holding N_KEYS
    keys, a quarter of them expired by TTL; the queries half live, a
    quarter dead, a quarter absent.  ``cand`` and ``keys`` against their
    plain versions, bitwise, and their times; ``keys`` also beside
    today's read path (the torch hash and a ``cand`` launch)."""
    import torch
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_lookup import ref as lr
    from repro_torch.slates import table as tbl
    draw = torch.randint(0, 2**30, (N_KEYS + N_KEYS // 8,), generator=gen,
                         device=dev)
    ids = torch.unique(draw)[:N_KEYS]
    ids = ids[torch.randperm(ids.numel(), generator=gen, device=dev)]
    keys = ids.to(kd) if kd == torch.int32 else \
        ids.to(torch.int64) * (2**33 + 3) - 2**45
    t = tbl.make_table(C, {"v": ((D,), torch.float32)}, key_dtype=kd,
                       device=dev)
    for i in range(0, N_KEYS, B):
        part = keys[i:i + B]
        tbl.insert_or_find(t, part, torch.ones_like(part, dtype=torch.bool))
    t.vals["v"].copy_(torch.randn(C + 1, D, generator=gen, device=dev))
    # TTL: a quarter of the rows are stale at tick 100 with ttl 10
    t.ts.copy_(torch.where(torch.rand(C + 1, generator=gen, device=dev)
                           < 0.25, 0, 95).to(torch.int32))
    tbl.expire_ttl(t, torch.tensor(100, dtype=torch.int32, device=dev), 10)
    present = (t.keys[:C] != tbl.EMPTY)
    live = t.keys[:C][present]
    dead = keys[~torch.isin(keys, live)]
    absent = (keys[:Q // 4] + 1) if kd == torch.int64 else \
        torch.randint(2**30, 2**31 - 1, (Q // 4,), generator=gen,
                      device=dev).to(kd)
    pick = lambda x, n: x[torch.randperm(x.numel(), generator=gen,
                                         device=dev)[:n]]
    query = torch.cat([pick(live, Q // 2), pick(dead, Q // 4), absent])
    query = query[torch.randperm(Q, generator=gen, device=dev)]
    vals, kname = t.vals["v"], str(kd)[6:]
    cand = tbl._probe_seq(query, C).to(torch.int32)
    err = same_outputs(f"slate_lookup cand {kname}",
                       lk.slate_lookup(t.keys, query, cand, vals),
                       lr.slate_lookup(t.keys, query, cand, vals))
    got = lk.slate_lookup_keys(t.keys, query, vals, capacity=C)
    err = max(err, same_outputs(
        f"slate_lookup keys {kname}", got,
        lr.slate_lookup_keys(t.keys, query, vals, C)))
    n_found = int(got[1].sum())
    log(f"slate_lookup {kname} read shape: Q={Q} over C={C} slots holding "
        f"{int(present.sum())} keys after TTL, found={n_found} (live "
        f"{Q // 2}, ttl-expired {Q // 4}, absent {Q // 4}); cand and keys "
        f"routes bitwise against their plain versions")
    if n_found != Q // 2:
        raise AssertionError(f"slate_lookup {kd} misses live keys")
    # one sector a probe the hit rule needs and a row a hit; query read
    # once, int32 slot + found + row written a query
    kb = query.element_size()
    walk = (Q * kb + probes_to_stop(t.keys, query, cand, False) * SECTOR
            + n_found * sectors(D * 4) + Q * (4 + 1 + D * 4))
    routes = {
        "cand": route_times(
            f"slate_lookup cand {kname}",
            lambda: lk.slate_lookup(t.keys, query, cand, vals),
            lambda: lr.slate_lookup(t.keys, query, cand, vals),
            walk + cand.numel() * 4),
        "keys": route_times(
            f"slate_lookup keys {kname}",
            lambda: lk.slate_lookup_keys(t.keys, query, vals, capacity=C),
            lambda: lr.slate_lookup_keys(t.keys, query, vals, C), walk,
            today_ms=lambda: lk.slate_lookup(
                t.keys, query, tbl._probe_seq(query, C).to(torch.int32),
                vals))}
    del t
    torch.cuda.empty_cache()
    return routes, err


def lookup_find_route(dev, gen, kd):
    """The insert shape: B rows of a sorted Zipf(1.2) batch over N_KEYS
    keys, pending on the run-last rows, against a table of C slots
    holding N_KEYS keys (load 0.25): the even keys below 2 * N_KEYS, so
    about half the pending keys are present.  ``find`` against the torch
    walk masked by ``pending``, bitwise, and its times (also with
    nothing pending: an insert's later rounds)."""
    import torch
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_lookup import ref as lr
    from repro_torch.slates import table as tbl
    wide = (lambda k: k.to(torch.int64) * (2**33 + 3) - 2**45) \
        if kd == torch.int64 else (lambda k: k.to(torch.int32))
    held = wide(2 * torch.randperm(N_KEYS, generator=gen, device=dev))
    t = tbl.make_table(C, {"v": ((D,), torch.float32)}, key_dtype=kd,
                       device=dev)
    for i in range(0, N_KEYS, B):
        part = held[i:i + B]
        tbl.insert_or_find(t, part, torch.ones_like(part, dtype=torch.bool))
    keys32 = slate_keys("zipf", gen, dev)
    pending = torch.ones(B, dtype=torch.bool, device=dev)
    pending[:-1] = keys32[1:] != keys32[:-1]
    query = wide(keys32)
    nothing = torch.zeros_like(pending)
    kname = str(kd)[6:]
    got = lk.find_slots(t.keys, query, pending, capacity=C)
    err = same_outputs(f"slate_lookup find {kname}", got,
                       lr.find_slots(t.keys, query, pending, C))
    err = max(err, same_outputs(
        f"slate_lookup find {kname}, nothing pending",
        lk.find_slots(t.keys, query, nothing, capacity=C),
        lr.find_slots(t.keys, query, nothing, C)))
    n_pend, n_found = int(pending.sum()), int(got[1].sum())
    n_held = int((t.keys[:C] != tbl.EMPTY).sum())
    log(f"slate_lookup {kname} insert shape: B={B}, {n_pend} pending "
        f"(run-last rows of a Zipf(1.2) batch), table of C={C} holding "
        f"{n_held} keys ({int(t.dropped)} dropped); {n_found} pending keys "
        f"found, "
        f"{int(((got[0] >= 0) & ~got[1]).sum())} stop at an empty slot; "
        f"find bitwise against the masked torch walk")
    if n_held + int(t.dropped) != N_KEYS or not 0.3 < n_found / n_pend < 0.7:
        raise AssertionError(f"slate_lookup find {kd}: the insert shape "
                             f"is off ({n_held} held, {n_found} of "
                             f"{n_pend} found)")
    # pending read once, the pending keys read, one sector a probe the
    # hit-or-empty rule needs, int64 slot + found written a row
    probes = probes_to_stop(t.keys, query[pending],
                            tbl._probe_seq(query[pending], C), True)
    nbytes = (B + n_pend * query.element_size() + probes * SECTOR
              + B * (8 + 1))
    times = route_times(
        f"slate_lookup find {kname}",
        lambda: lk.find_slots(t.keys, query, pending, capacity=C),
        lambda: lr.find_slots(t.keys, query, pending, C), nbytes,
        nothing_pending_ms=lambda: lk.find_slots(t.keys, query, nothing,
                                                 capacity=C))
    del t
    torch.cuda.empty_cache()
    return times, err


def check_slate_lookup(dev, seed):
    """The three routes for int32 and int64 keys: ``cand`` and ``keys``
    at the read shape, ``find`` at the insert shape.  The kernel line
    holds ``keys`` (the read path's route) and ``routes`` all three."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    entries = []
    for kd in (torch.int32, torch.int64):
        routes, err = lookup_read_routes(dev, gen, kd)
        routes["find"], err2 = lookup_find_route(dev, gen, kd)
        wide = kd == torch.int64
        keys = routes["keys"]
        entries.append({
            "name": "slate_lookup_wide" if wide else "slate_lookup",
            "route": "cuda", "source": "src/repro_torch/csrc/slate_lookup.cu",
            "replaces": "src/repro/kernels/slate_lookup/kernel.py:"
                        + ("160" if wide else "124"),
            "ms": keys["ms"], "plain_ms": keys["plain_ms"],
            "bound_ms": keys["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "max_abs_err": max(err, err2),
            "routes": routes})
    return entries


def check_count_update(name, update, plain, counts, cols, add, extra=()):
    """Hold one count kernel against its plain version bitwise (on these
    inputs and on ``extra`` (cols, add) pairs), then time the kernel, the
    plain version and ``torch.bincount`` of the masked flat columns."""
    import torch
    rows, width = counts.shape
    err = 0.0
    for c, a in tuple(extra) + ((cols, add),):
        got = update(counts.clone(), c, a)
        want = plain(counts.clone(), c, a)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version")
        err = max(err, float((got - want).abs().max()))
    n = rows * width
    flat = torch.where(add[None, :] > 0, cols + (torch.arange(
        rows, device=cols.device, dtype=torch.int32) * width)[:, None],
        n).reshape(-1)
    lib = torch.bincount(flat, minlength=n + 1)[:n].view(rows, width)
    if not torch.equal(counts + lib.to(torch.int32), want):
        raise AssertionError(f"torch.bincount disagrees with {name}")
    scratch = counts.clone()
    ms = device_ms(lambda: update(scratch, cols, add))
    plain_ms = device_ms(lambda: plain(scratch, cols, add))
    library_ms = device_ms(lambda: torch.bincount(flat, minlength=n + 1))
    # cols and add read once, the counters read and written once
    B_ = cols.shape[1]
    nbytes = rows * B_ * 4 + B_ * 4 + 2 * n * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{name} [{rows}, {width}] B={B_}: kernel {ms:.5f} ms, plain "
        f"{plain_ms:.5f} ms, torch.bincount {library_ms:.5f} ms (device "
        f"time, torch.profiler, mean of 20); bound {bound_ms:.6f} ms "
        f"({nbytes} bytes at 3.35 TB/s)")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/countmin.cu",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def check_fused(name, route, fused, unfused, plain, state, cases,
                nbytes):
    """Hold a fused count route against its plain composition bitwise on
    each of ``cases`` (argument tuples after the ``state`` tensors, which
    each call updates in place), then time it beside the unfused kernel
    with its helper ops and the plain composition, on the first case."""
    import torch
    for args in cases:
        got = [t.clone() for t in state]
        want = [t.clone() for t in state]
        fused(*got, *args)
        plain(*want, *args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} {route} route differs from its "
                                 "plain composition")
    t = {"route": route,
         "ms": device_ms(lambda: fused(*state, *cases[0])),
         "unfused_ms": device_ms(lambda: unfused(*state, *cases[0])),
         "plain_ms": device_ms(lambda: plain(*state, *cases[0])),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"{name} {route} route: bitwise against its plain composition on "
        f"{len(cases)} inputs; fused kernel {t['ms']:.5f} ms, unfused "
        f"kernel with its helper ops {t['unfused_ms']:.5f} ms, plain "
        f"composition {t['plain_ms']:.5f} ms (device time, torch.profiler, "
        f"mean of 20); bound {t['bound_ms']:.6f} ms ({nbytes} bytes at "
        f"3.35 TB/s)")
    return t


def check_countmin(dev, seed):
    """The engine's default sketch (2 x 2048) at B=65,536 Zipf keys
    hashed by ``columns``, about a tenth of the events masked, int32 and
    int64 keys; then the fused route (keys hashed in the kernel) at the
    same keys with the key types' extremes."""
    import torch
    from repro_torch.kernels.countmin import kernel as ck
    from repro_torch.kernels.countmin import ref as cr
    from repro_torch.telemetry import sketch as sk_mod
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    keys = zipf_keys(zipf_cdf(dev), B, gen)
    salts_np = sk_mod.make_salts(2)
    salts = sk_mod.salts_tensor(salts_np, dev)
    keys64 = keys.to(torch.int64) * (2**33 + 1) - 2**40
    cols = sk_mod.columns(keys, salts, 2048)
    cols64 = sk_mod.columns(keys64, salts, 2048)
    add = (torch.rand(B, generator=gen, device=dev) >= 0.1).to(torch.int32)
    counts = torch.randint(0, 1000, (2, 2048), generator=gen, device=dev,
                           dtype=torch.int32)
    hot = int(torch.bincount(cols[0]).max())
    log(f"countmin_update inputs: depth 2, width 2048, B={B}, "
        f"{int((add == 0).sum())} events masked, hottest column of row 0 "
        f"holds {hot} events ({hot / B:.3f} of the batch)")
    e = check_count_update("countmin_update", ck.countmin_update,
                           cr.countmin_update, counts, cols, add,
                           extra=((cols64, add),))
    log("countmin_update int32 and int64 keys: bitwise=True")
    e["replaces"] = "src/repro/kernels/countmin/kernel.py:59"
    edge32, edge64 = keys.clone(), keys64.clone()
    edge32[:4] = torch.tensor([0, -1, 2**31 - 1, -2**31], device=dev)
    edge64[:7] = torch.tensor([-2**63, 2**63 - 1, -1, 0, 2**32, 2**32 - 1,
                               -2**32], device=dev)
    cases = [(k, add, salts_np) for k in (keys, edge32, keys64, edge64)]
    e["fused"] = check_fused(
        "countmin_update", "keys", ck.countmin_update_keys,
        lambda c, k, a, s: ck.countmin_update(
            c, sk_mod.columns(k, salts, 2048), a),
        cr.countmin_update_keys, (counts,), cases,
        B * 4 + B * 4 + 2 * counts.numel() * 4)
    return e


def check_histogram(dev, seed):
    """One 128-wide histogram row at B=65,536 with ages spread over all
    32 buckets, bucketed by ``latency.bucketize``; then the fused route
    (ages bucketed in the kernel, the tick read on the card) at the same
    ages and at every bucket edge, int32 max and negative ages."""
    import torch
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.histogram import ref as hr
    from repro_torch.telemetry import latency as lat_mod
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    b = torch.randint(0, 32, (B,), generator=gen, device=dev)
    lo = torch.where(b == 0, 0, torch.bitwise_left_shift(
        torch.ones_like(b), b - 1))
    u = torch.rand(B, generator=gen, device=dev, dtype=torch.float64)
    ages = (lo + (u * lo).floor().to(torch.int64)).clamp(max=2**31 - 1)
    cols = lat_mod.bucketize(ages.to(torch.int32), 32)[None, :].contiguous()
    if not torch.equal(cols[0].long(), b):
        raise AssertionError("bucketize misplaced an age on the card")
    add = (torch.rand(B, generator=gen, device=dev) >= 0.1).to(torch.int32)
    counts = torch.randint(0, 1000, (1, lat_mod.pad_width(32)),
                           generator=gen, device=dev, dtype=torch.int32)
    # the engine's own case: a whole tick's events in one bucket
    one = torch.full_like(cols, 3)
    log(f"histogram_update inputs: one row of {counts.shape[1]}, B={B}, "
        f"ages over all 32 buckets (bucketize checked on the card), "
        f"{int((add == 0).sum())} events masked")
    e = check_count_update("histogram_update", hk.histogram_update,
                           hr.histogram_update, counts, cols, add,
                           extra=((one, add),))
    log("histogram_update spread and single-bucket ages: bitwise=True")
    e["replaces"] = "src/repro/kernels/histogram/kernel.py:56"
    top = 2**31 - 1
    tick = torch.tensor(top, dtype=torch.int32, device=dev)
    edges = [0, 1] + [v for k in range(1, 31)
                      for v in ((1 << k) - 1, 1 << k, (1 << k) + 1)]
    edges = torch.tensor([v for v in edges if v <= top]
                         + [top, -1, -5, -top], device=dev)
    edge_ts = (top - edges.repeat(B // edges.numel() + 1)[:B] + 2**31) \
        % 2**32 - 2**31
    cases = [(tick, (top - ages).to(torch.int32), add),
             (tick, edge_ts.to(torch.int32), add),
             (5, edge_ts.to(torch.int32), add)]
    def unfused(c, s, t, ts, a):       # the telemetry path before
        lat = hr.ages(t, ts)
        hk.histogram_update(c, hr.bucketize(lat, 32)[None, :], a)
        s.add_(torch.where(a > 0, lat, 0).sum(dtype=torch.int32))

    # the arc's int32 latency sum too, its ages summing past 2**32
    lat_sum = torch.zeros((), dtype=torch.int32, device=dev)
    e["fused"] = check_fused(
        "histogram_update", "ages",
        lambda c, s, t, ts, a: hk.histogram_update_ages(
            c, t, ts, a, n_buckets=32, lat_sum=s),
        unfused,
        lambda c, s, t, ts, a: hr.histogram_update_ages(
            c, t, ts, a, n_buckets=32, lat_sum=s),
        (counts, lat_sum), cases, B * 4 + B * 4 + 2 * counts.numel() * 4)
    return e


def attn_tol(dtype):
    """Attention tolerance, as the JAX package's kernel sweep
    (tests/test_kernels.py:8): 2e-2 for bf16, 5e-5 for f32."""
    return 2e-2 if "bfloat16" in str(dtype) else 5e-5


def attention_bound(nbytes, flops):
    """(bound ms, what bounds it): bytes over the HBM rate against FLOPs
    over the bf16 dense tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_attention_case(name, kernel, plain, args, kw, tol):
    """One case: the kernel against its plain version on the card."""
    import torch
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not (err < tol and got.dtype == want.dtype
            and got.shape == want.shape and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{name} {kw} shapes {[tuple(a.shape) for a in args]}"
                             f": max_abs_err {err} against tolerance {tol}")
    return err


def attention_times(name, kernel, plain, library, args, nbytes, flops,
                    what):
    """Device times of the kernel, its plain version and the library call
    on ``args``, and the bound; logged on one line.  Returns (ms,
    plain_ms, library_ms, bound_ms, bound_by)."""
    ms = device_ms(lambda: kernel(*args))
    plain_ms = device_ms(lambda: plain(*args))
    library_ms = device_ms(library)
    bound_ms, bound_by = attention_bound(nbytes, flops)
    log(f"{name} {what}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"library {library_ms:.5f} ms (kernel / library "
        f"{ms / library_ms:.3f}; device time, torch.profiler, mean of 20); "
        f"bound {bound_ms:.6f} ms by {bound_by} ({nbytes} bytes at 3.35 "
        f"TB/s, {flops} FLOPs at 989 TFLOP/s)")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def same_bits(name, fn):
    """Two calls of ``fn`` give the same bits; returns the first output."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls gave different bits")
    return a


def check_flash_attention(dev, seed):
    """The prefill shapes of phases 7 and 8 (B=8 requests of S=256, Dh=64,
    bf16, causal; 14 query heads over 2 kv heads for qwen2-0.5b, 32 over
    32 for zamba2-1.2b) and of phases 10 and 11 (gemma3-1b's local and
    global layers, deepseek-v2-lite-16b's MLA), which must take the
    tensor-core (wgmma) route and give the same bits on a second call,
    and cases for a window, q_offset, f32 and Dh=72 (the CUDA-core
    route), Dh=128, Dv != Dh and a strided packed-QKV view; each timed
    serving shape of phases 7 and 8 beside SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ref as ar
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    bf16, f32 = torch.bfloat16, torch.float32

    def qkv(B, Sq, Skv, H, Hkv, Dh, Dv, dt):
        r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dt)
        return r(B, Sq, H, Dh), r(B, Skv, Hkv, Dh), r(B, Skv, Hkv, Dv)

    def case(args, kw, route):
        before = dict(fk.flash_attention.launches_by_route)
        e = check_attention_case("flash_attention", fk.flash_attention,
                                 ar.mha, args, kw, attn_tol(args[0].dtype))
        moved = {r: n - before[r]
                 for r, n in fk.flash_attention.launches_by_route.items()}
        if moved != {r: int(r == route) for r in moved}:
            raise AssertionError(f"flash_attention {kw} shapes "
                                 f"{[tuple(a.shape) for a in args]}: routes "
                                 f"{moved}, expected {route}")
        return e

    serving = {}
    for arch, (H, Hkv) in (("qwen2-0.5b", (14, 2)), ("zamba2-1.2b", (32, 32))):
        B, S, Dh = 8, 256, 64
        q, k, v = qkv(B, S, S, H, Hkv, Dh, Dh, bf16)
        err = case((q, k, v), {"causal": True}, "wgmma")
        same_bits("flash_attention", lambda: fk.flash_attention(q, k, v))
        serving[arch] = (H, Hkv, (q, k, v), err)
    # the prefill shapes of phases 10 and 11: gemma3-1b's local layers
    # (window 512) and global ones, deepseek-v2-lite-16b's MLA (Dv != Dh)
    families = {}
    for label, shape, kw in (
            ("gemma3-1b local [8, 1024, 4/1, 256] window 512",
             (8, 1024, 1024, 4, 1, 256, 256, bf16), {"window": 512}),
            ("gemma3-1b global [8, 1024, 4/1, 256]",
             (8, 1024, 1024, 4, 1, 256, 256, bf16), {}),
            ("deepseek-v2-lite-16b MLA [8, 256, 16/16, 192/128]",
             (8, 256, 256, 16, 16, 192, 128, bf16), {})):
        args, kw = qkv(*shape), {"causal": True, **kw}
        families[label] = case(args, kw, "wgmma")
        same_bits("flash_attention", lambda: fk.flash_attention(*args, **kw))
    # the shapes phase 14 adds: bidirectional attention with Sq != Skv
    # (llama-3.2-vision-11b's cross prefill of a 64- or 256-token bucket
    # over 1,600 image rows, full-head kv; a ragged last key tile) and
    # whisper-tiny's heads of 64 (6/6): the encoder and the decoder's
    # cross attention (bidirectional), the decoder's self attention
    cross = {}
    for label, shape, kw in (
            ("llama-3.2-vision-11b cross [1, 64 over 1600, 32/32, 128]",
             (1, 64, 1600, 32, 32, 128, 128, bf16), {"causal": False}),
            ("llama-3.2-vision-11b cross [1, 256 over 1600, 32/32, 128]",
             (1, 256, 1600, 32, 32, 128, 128, bf16), {"causal": False}),
            ("ragged key tile [1, 48 over 1601, 32/32, 128]",
             (1, 48, 1601, 32, 32, 128, 128, bf16), {"causal": False}),
            ("whisper-tiny encoder and cross [1, 256, 6/6, 64]",
             (1, 256, 256, 6, 6, 64, 64, bf16), {"causal": False}),
            ("whisper-tiny decoder self [1, 256, 6/6, 64] causal",
             (1, 256, 256, 6, 6, 64, 64, bf16), {"causal": True})):
        args = qkv(*shape)
        cross[label] = (case(args, kw, "wgmma"), args, kw)
        same_bits("flash_attention", lambda: fk.flash_attention(*args, **kw))
    packed = qkv(2, 100, 100, 8, 2, 64, 64, bf16)[0]
    cases = [((8, 256, 256, 14, 2, 64, 64, bf16), {"window": 64}, "wgmma"),
             ((2, 64, 256, 14, 2, 64, 64, bf16), {"q_offset": 192}, "wgmma"),
             ((8, 256, 256, 14, 2, 64, 64, f32), {}, "simt"),
             ((2, 256, 256, 14, 2, 72, 72, bf16), {"window": 100}, "simt"),
             ((2, 256, 256, 8, 2, 128, 128, bf16), {}, "wgmma"),
             ((2, 256, 256, 14, 2, 64, 32, bf16), {}, "wgmma"),
             ((2, 160, 160, 4, 2, 64, 64, bf16), {"causal": False}, "wgmma")]
    errs = {}
    for shape, kw, route in cases:
        e = case(qkv(*shape), kw, route)
        errs[f"{shape[:-1]} {str(shape[-1])[6:]} {kw} {route}"] = e
    e = case((packed[:, :, :4], packed[:, :, 4:6], packed[:, :, 6:]), {},
             "wgmma")
    errs["packed QKV view [2, 100, 4+2+2, 64] bf16 wgmma"] = e
    err = max(*(e for *_, e in serving.values()), *families.values(),
              *(e for e, _, _ in cross.values()),
              *(e for label, e in errs.items() if "bfloat16" in label
                or "bf16" in label))
    log(f"flash_attention vs plain, serving shapes [8, 256, 14/2, 64] and "
        f"[8, 256, 32/32, 64] bf16 causal on the wgmma route: max_abs_err "
        f"{serving['qwen2-0.5b'][3]} / {serving['zamba2-1.2b'][3]} "
        f"(tolerance 2e-2 bf16, 5e-5 f32); phases 10 and 11's shapes, bf16 "
        f"causal on the wgmma route: {families}; phase 14's shapes on the "
        f"wgmma route: { {k: e for k, (e, _, _) in cross.items()} }; two "
        f"calls bitwise equal; other cases (route asserted) {errs}")
    shapes = {}
    for label in ("llama-3.2-vision-11b cross [1, 64 over 1600, 32/32, 128]",
                  "whisper-tiny encoder and cross [1, 256, 6/6, 64]"):
        e, (q, k, v), kw = cross[label]
        cb, sq, ch, cd = q.shape
        skv, dv = k.shape[1], v.shape[3]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        # q, k, v read once, o written once; every query row sees every key
        nbytes = (q.numel() + k.numel() + v.numel() + cb * sq * ch * dv) * 2
        flops = 2 * (cd + dv) * cb * ch * sq * skv
        ms, plain_ms, library_ms, bound_ms, bound_by = attention_times(
            "flash_attention", lambda *a: fk.flash_attention(*a, **kw),
            lambda *a: ar.mha(*a, **kw), sdpa, (q, k, v), nbytes, flops,
            f"{label} bidirectional (library: SDPA)")
        shapes[label] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms}

    out = {}
    for arch, (H, Hkv, (q, k, v), _) in serving.items():
        B, S, Dh = q.shape[0], q.shape[1], q.shape[3]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float()
                         - ar.mha(q, k, v).float()).abs().max())
        # q, k, v read once, o written once; products 2 (Dh + Dv) per
        # (query head, row, visible key): S (S + 1) / 2 causal pairs a head
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2
        flops = 2 * (Dh + Dh) * B * H * S * (S + 1) // 2
        out[arch] = attention_times(
            "flash_attention", fk.flash_attention, ar.mha, sdpa, (q, k, v),
            nbytes, flops, f"{arch} [8, 256, {H}/{Hkv}, 64] bf16 causal "
            f"(library: SDPA causal, vs plain max_abs_err {lib_err})")
    ms, plain_ms, library_ms, bound_ms, bound_by = out["qwen2-0.5b"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:124",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shapes": shapes}


def check_decode_attention(dev, seed):
    """The decode shapes of phases 7 and 8 (B=8 requests, a 512-row bf16
    cache, lengths ragged in [1, 512], Dh=64; 14 query heads over 2 kv
    heads for qwen2-0.5b, 32 over 32 for zamba2-1.2b) and of phases 10 and
    11 (gemma3-1b's local and global layers over a 1,088-row cache,
    deepseek-v2-lite-16b's MLA), which must give the same bits on a
    second call, and cases for a window, an f32 query over
    bf16 caches, f32, Dh=128, Dv != Dh, two query rows, and a 4096-row
    cache whose lengths (1, 63, 64, 65, 4096, ragged) leave splits empty,
    partial and full, with and without a window edge inside a split; each
    timed serving shape beside SDPA with a length mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ref as dr
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(B, S, H, Hkv, Dh, Dv, qdt, cdt, lo=1, Sq=1, hi=None):
        r = lambda dt, *sh: torch.randn(sh, generator=gen,
                                        device=dev).to(dt)
        lens = torch.randint(lo, (hi or S) + 1, (B,), generator=gen,
                             device=dev, dtype=torch.int32)
        return (r(qdt, B, Sq, H, Dh), r(cdt, B, S, Hkv, Dh),
                r(cdt, B, S, Hkv, Dv), lens)

    serving = {}
    for arch, (H, Hkv) in (("qwen2-0.5b", (14, 2)), ("zamba2-1.2b", (32, 32))):
        B, S, Dh = 8, 512, 64
        q, kc, vc, lens = inputs(B, S, H, Hkv, Dh, Dh, bf16, bf16)
        lens[0], lens[1] = 1, S             # both ends of the range
        err = check_attention_case("decode_attention", dk.decode_attention,
                                   dr.decode_attend, (q, kc, vc, lens), {},
                                   attn_tol(bf16))
        same_bits("decode_attention",
                  lambda: dk.decode_attention(q, kc, vc, lens))
        serving[arch] = (H, Hkv, (q, kc, vc, lens), err)
    # the decode shapes of phases 10 and 11: lengths (cur_index + 1) run
    # from the shortest prompt plus one to the longest plus 31 steps,
    # gemma3-1b's local layers windowed at 512
    families = {}
    for label, shape, (lo, hi), kw in (
            ("gemma3-1b local B=8 S=1088 4/1 heads of 256 window 512",
             (8, 1088, 4, 1, 256, 256), (641, 1055), {"window": 512}),
            ("gemma3-1b global B=8 S=1088 4/1 heads of 256",
             (8, 1088, 4, 1, 256, 256), (641, 1055), {}),
            ("deepseek-v2-lite-16b MLA B=8 S=512 16/16 heads 192/128",
             (8, 512, 16, 16, 192, 128), (33, 287), {})):
        q, kc, vc, lens = inputs(*shape, bf16, bf16, lo=lo, hi=hi)
        lens[0], lens[1] = lo, hi           # both ends of the range
        families[label] = check_attention_case(
            "decode_attention", dk.decode_attention, dr.decode_attend,
            (q, kc, vc, lens), kw, attn_tol(bf16))
        same_bits("decode_attention",
                  lambda: dk.decode_attention(q, kc, vc, lens, **kw))
    # the decode shapes phase 14 adds: cross attention over the whole
    # source (lengths = its rows, as many kv heads as query heads) for
    # llama-3.2-vision-11b (1,600 image rows, Dh 128) and whisper-tiny
    # (256 encoder rows, Dh 64), whisper's self attention, and an idle
    # slot whose length has run past the cache (the kernel and the plain
    # version clamp it to S)
    cross = {}
    for label, shape, (lo, hi), kw in (
            ("llama-3.2-vision-11b cross B=8 S=1600 32/32 heads of 128",
             (8, 1600, 32, 32, 128, 128), (1600, 1600), {}),
            ("whisper-tiny cross B=8 S=256 6/6 heads of 64",
             (8, 256, 6, 6, 64, 64), (256, 256), {}),
            ("whisper-tiny self B=8 S=256 6/6 heads of 64",
             (8, 256, 6, 6, 64, 64), (33, 255), {}),
            ("qwen2-0.5b self B=8 S=320 14/2 heads of 64, an idle slot "
             "past the cache", (8, 320, 14, 2, 64, 64), (33, 287), {})):
        q, kc, vc, lens = inputs(*shape, bf16, bf16, lo=lo, hi=hi)
        if "idle" in label:
            lens[2] = shape[1] + 40
        cross[label] = (check_attention_case(
            "decode_attention", dk.decode_attention, dr.decode_attend,
            (q, kc, vc, lens), kw, attn_tol(bf16)), (q, kc, vc, lens))
        same_bits("decode_attention",
                  lambda: dk.decode_attention(q, kc, vc, lens, **kw))
    B, S, H, Hkv, Dh = 8, 512, 14, 2, 64
    cases = [((B, S, H, Hkv, Dh, Dh, bf16, bf16, 65), {"window": 64}),
             ((B, S, H, Hkv, Dh, Dh, f32, bf16), {}),
             ((B, S, H, Hkv, Dh, Dh, f32, f32), {}),
             ((2, S, 8, 2, 128, 128, bf16, bf16), {}),
             ((2, S, H, Hkv, Dh, 32, bf16, bf16), {}),
             ((B, S, H, Hkv, Dh, Dh, bf16, bf16, 1, 2), {})]
    errs = {}

    def run(args, kw, label):
        qdt, cdt = args[0].dtype, args[1].dtype
        tol = attn_tol(f32) if (qdt, cdt) == (f32, f32) else attn_tol(bf16)
        errs[label] = check_attention_case(
            "decode_attention", dk.decode_attention, dr.decode_attend, args,
            kw, tol)

    for shape, kw in cases:
        run(inputs(*shape), kw, f"{shape[:6]} {str(shape[6])[6:]}/"
            f"{str(shape[7])[6:]} Sq={shape[9] if len(shape) > 9 else 1} "
            f"{kw}")
    long_lens = [1, 63, 64, 65, 4096, 2000, 777, 3001]
    q, kc, vc, _ = inputs(len(long_lens), 4096, H, Hkv, Dh, Dh, bf16, bf16)
    lens = torch.tensor(long_lens, dtype=torch.int32, device=dev)
    for window in (0, 1000, 37):
        run((q, kc, vc, lens), {"window": window},
            f"S=4096 lengths {long_lens} window {window} (splits "
            f"{dk.plan_splits(len(long_lens), Hkv, 4096)})")
    err = max(*(e for *_, e in serving.values()), *families.values(),
              *(e for e, _ in cross.values()),
              *(e for label, e in errs.items() if "float32/float32" not in
                label))
    log(f"decode_attention vs plain, serving shapes B=8 S=512 Dh=64 bf16 "
        f"with 14/2 and 32/32 heads (splits "
        f"{dk.plan_splits(8, 2, 512)} and {dk.plan_splits(8, 32, 512)}): "
        f"max_abs_err {serving['qwen2-0.5b'][3]} / "
        f"{serving['zamba2-1.2b'][3]} (tolerance 2e-2 with bf16, 5e-5 f32; "
        f"the plain version casts p to bf16 as the JAX oracle does, the "
        f"kernel keeps it f32); phases 10 and 11's shapes, bf16: "
        f"{families}; phase 14's shapes (splits "
        f"{dk.plan_splits(8, 32, 1600)} over 1,600 rows, "
        f"{dk.plan_splits(8, 6, 256)} over 256): "
        f"{ {k: e for k, (e, _) in cross.items()} }; two calls bitwise "
        f"equal; other cases {errs}")
    shapes = {}
    for label in ("llama-3.2-vision-11b cross B=8 S=1600 32/32 heads of 128",
                  "whisper-tiny cross B=8 S=256 6/6 heads of 64"):
        e, (q, kc, vc, lens) = cross[label]
        cb, cs, ch, cd = kc.shape
        qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        # q read once, every cache row read once, o written once, lengths
        # read; products 2 (Dh + Dv) per (query head, row)
        nbytes = q.numel() * 2 * 2 + kc.numel() * 2 * 2 + cb * 4
        flops = 2 * (cd + cd) * ch * cb * cs
        ms, plain_ms, library_ms, bound_ms, bound_by = attention_times(
            "decode_attention", dk.decode_attention, dr.decode_attend, sdpa,
            (q, kc, vc, lens), nbytes, flops,
            f"{label}, every length {cs} (library: SDPA, no mask)")
        shapes[label] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms}

    out = {}
    for arch, (H, Hkv, (q, kc, vc, lens), _) in serving.items():
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None, None, :], enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float() - dr.decode_attend(
            q, kc, vc, lens).float()).abs().max())
        # q read once, the cache rows below each length read once, o
        # written once, lengths read; products 2 (Dh + Dv) per (query
        # head, visible row)
        rows = int(lens.sum())
        nbytes = (q.numel() * 2 + rows * Hkv * (Dh + Dh) * 2
                  + q.numel() * 2 + B * 4)
        flops = 2 * (Dh + Dh) * H * rows
        out[arch] = attention_times(
            "decode_attention", dk.decode_attention, dr.decode_attend, sdpa,
            (q, kc, vc, lens), nbytes, flops,
            f"{arch} B=8 S=512 {H}/{Hkv} heads bf16 ({rows} cache rows "
            f"visible, lengths {sorted(lens.tolist())}; library: SDPA with "
            f"a length mask, vs plain max_abs_err {lib_err})")
    ms, plain_ms, library_ms, bound_ms, bound_by = out["qwen2-0.5b"]
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:96",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shapes": shapes}


def ssd_flops(S, chunk, N, P):
    """FLOPs the chunked SSD recurrence needs for one (batch, head): the
    causal half of QK^T and of the masked product with V, the carried
    state's product (not needed in the first chunk, whose state is 0) and
    the state update."""
    total, L = 0, min(chunk, S)
    for c, t0 in enumerate(range(0, S, L)):
        n = min(L, S - t0)
        total += 2 * (N + P) * n * (n + 1) // 2 + 2 * n * N * P
        if c:
            total += 2 * n * N * P
    return total


def check_ssd_scan(dev, seed):
    """The prefill shape of phase 8 (B=8 requests of S=256 in one chunk,
    64 heads, N=P=64, bf16, q and k head-broadcast views of [B, S, N] as
    Mamba-2 passes them), which must take the tensor-core ("mma") route
    and give the same bits on a second call; the same shape with q and k
    per head; B=2 x S=2048 (8 chunks, which the serving shape never
    carries across), S=200 with chunk 64 (a ragged last chunk), P=32 !=
    N, and on the CUDA-core ("simt") route N=P=24 in bf16 (a width the
    tensor-core route is not compiled for) and f32.  Tolerances are the
    JAX package's sweep's: y within 2e-2 (bf16) / 5e-5 (f32) of max|y| +
    1, the final state within 5e-4 of max|state| + 1.  Both routes are
    timed at the serving shape (the "simt" route in f32)."""
    import torch
    from repro_torch.kernels.ssd import ref as sr
    from repro_torch.kernels.ssd_scan import kernel as sk
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(B, S, H, N, P, dt, shared):
        r = lambda *sh: torch.randn(sh, generator=gen, device=dev)
        Hq = 1 if shared else H
        q = r(B, S, Hq, N).to(dt).expand(B, S, H, N)
        k = (r(B, S, Hq, N) * 0.3).to(dt).expand(B, S, H, N)
        la = -torch.nn.functional.softplus(r(B, S, H))
        return q, k, r(B, S, H, P).to(dt), la

    def case(B, S, H, N, P, chunk, dt, route, shared=True):
        args = inputs(B, S, H, N, P, dt, shared)
        before = dict(sk.ssd_scan.launches_by_route)
        y, fin = sk.ssd_scan(*args, chunk=chunk)
        wy, wfin = sr.ssd(*args, chunk=chunk)
        torch.cuda.synchronize()
        moved = {r: n - before[r]
                 for r, n in sk.ssd_scan.launches_by_route.items()}
        ey = float((y.float() - wy.float()).abs().max())
        ef = float((fin - wfin).abs().max())
        ok = (y.dtype == dt and y.shape == wy.shape
              and fin.shape == wfin.shape
              and bool(torch.isfinite(y.float()).all())
              and ey / (float(wy.float().abs().max()) + 1) < attn_tol(dt)
              and ef / (float(wfin.abs().max()) + 1) < 5e-4
              and moved == {r: int(r == route) for r in moved})
        if not ok:
            raise AssertionError(f"ssd_scan B={B} S={S} H={H} N={N} P={P} "
                                 f"chunk={chunk} {dt} shared={shared}: "
                                 f"y max_abs_err {ey}, final state {ef}, "
                                 f"routes {moved} (expected {route})")
        same_bits(f"ssd_scan {route}",
                  lambda: torch.cat([t.float().flatten() for t in
                                     sk.ssd_scan(*args, chunk=chunk)]))
        return args, ey, ef

    B, S, H, N, P, L = 8, 256, 64, 64, 64, 256
    args, err, ferr = case(B, S, H, N, P, L, bf16, "mma")
    errs = {}
    for shape, route, shared in (
            ((B, S, H, N, P, L, bf16), "mma", False),
            ((2, 2048, H, N, P, L, bf16), "mma", True),
            ((2, 200, H, N, P, 64, bf16), "mma", True),
            ((2, S, 8, N, 32, L, bf16), "mma", False),
            ((2, S, 8, 24, 24, L, bf16), "simt", True),
            ((2, S, H, N, P, L, f32), "simt", True)):
        _, e, fe = case(*shape, route, shared)
        errs[f"{shape[:6]} {str(shape[6])[6:]} {route} "
             f"{'shared q/k' if shared else 'q/k per head'}"] = (e, fe)
        if shape[6] == bf16:
            err = max(err, e)
    log(f"ssd_scan vs plain, serving shape B=8 S=256 H=64 N=P=64 bf16 "
        f"(q, k head-broadcast) on the mma route: y max_abs_err {err}, "
        f"final state {ferr} (tolerance 2e-2 / 5e-5 of max|y| + 1, 5e-4 of "
        f"max|S| + 1); every case's route asserted and two calls bitwise "
        f"equal; other cases (y, state) {errs}")
    ms = device_ms(lambda: sk.ssd_scan(*args, chunk=L))
    plain_ms = device_ms(lambda: sr.ssd(*args, chunk=L))
    fargs = tuple(t.float() if t.dtype == bf16 else t for t in args)
    f32_ms = device_ms(lambda: sk.ssd_scan(*fargs, chunk=L))

    def unaligned(t, heads):     # the same values one element into a buffer
        src = t[:, :, :heads]
        buf = torch.empty(*src.shape[:-1], src.shape[-1] + 8, dtype=t.dtype,
                          device=dev)
        buf[..., 1:1 + src.shape[-1]] = src
        return buf[..., 1:1 + src.shape[-1]].expand(t.shape)

    uargs = (unaligned(args[0], 1), unaligned(args[1], 1),
             unaligned(args[2], H), args[3])
    if sk.route(*uargs[:3], L) != "simt":
        raise AssertionError("ssd_scan: an unaligned view took the mma route")
    simt_ms = device_ms(lambda: sk.ssd_scan(*uargs, chunk=L))
    # v and log_a read once, q and k once as the [B, S, N] tensors they
    # view, y and the f32 final state written once
    nbytes = (2 * B * S * N * 2 + B * S * H * P * 2 + B * S * H * 4
              + B * S * H * P * 2 + B * H * N * P * 4)
    flops = B * H * ssd_flops(S, L, N, P)
    bound_ms, bound_by = attention_bound(nbytes, flops)
    log(f"ssd_scan B=8 S=256 H=64 N=P=64 bf16: kernel {ms:.5f} ms on the "
        f"mma route, the simt route on the same values (unaligned views) "
        f"{simt_ms:.5f} ms and in f32 {f32_ms:.5f} ms, plain "
        f"{plain_ms:.5f} ms (device time, torch.profiler, mean of 20); no "
        f"single PyTorch call computes the "
        f"chunked recurrence; bound {bound_ms:.6f} ms by {bound_by} "
        f"({nbytes} bytes at 3.35 TB/s, {flops} FLOPs at 989 TFLOP/s)")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:89",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def rms_close(got, want):
    """The kernel against its plain version: f32 within 5e-5; bf16 each
    value within one bf16 ulp (2**-7 of its magnitude), since the two f32
    sums and rsqrt differ in their last bits and may round an output to
    its neighbour.  Returns the max abs difference."""
    import torch
    err = (got.float() - want.float()).abs()
    ok = got.dtype == want.dtype and got.shape == want.shape and bool(
        torch.isfinite(got.float()).all())
    if got.dtype == torch.bfloat16:
        ok = ok and bool((err <= 2.0**-7 * want.float().abs()).all())
    else:
        ok = ok and float(err.max()) < 5e-5
    if not ok:
        raise AssertionError(f"rmsnorm {tuple(got.shape)} {got.dtype}: "
                             f"max_abs_err {float(err.max())}")
    return float(err.max())


# the rows and widths the serving paths normalise: prefill (8 requests x
# 256 tokens) and decode (8 requests) at qwen2-0.5b's d_model 896,
# zamba2-1.2b's 2048 and Mamba-2's gated norm over d_inner 4096
RMS_SHAPES = ((2048, 896), (2048, 2048), (2048, 4096), (8, 896), (8, 2048),
              (8, 4096))


def check_rmsnorm(dev, seed):
    """The norms of phases 7 and 8 at the six ``RMS_SHAPES`` (bf16, the
    register route asserted, two calls bitwise equal), each timed beside
    ``torch.nn.functional.rms_norm`` (bf16 weight) in turns; and
    scale_offset, f32 and an odd D (the loop route).  The prefill shapes
    are timed over copies of x that together hold over four times the
    H100's 50 MB L2, one copy a call in turn, so that x comes from HBM as
    the byte bound assumes; decode's 8 rows are timed on one x, as the
    serving path finds a row the previous operation has just written."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rr
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    bf16, f32 = torch.bfloat16, torch.float32
    eps = 1e-5

    def inputs(rows, D, dt):
        x = torch.randn(rows, D, generator=gen, device=dev).to(dt)
        return x, 1 + 0.1 * torch.randn(D, generator=gen, device=dev)

    def case(x, w, off, route):
        before = dict(rk.rmsnorm.launches_by_route)
        got = same_bits("rmsnorm", lambda: rk.rmsnorm(x, w, eps=eps,
                                                      scale_offset=off))
        moved = {r: n - before[r]
                 for r, n in rk.rmsnorm.launches_by_route.items()}
        if moved != {r: 2 * int(r == route) for r in moved}:
            raise AssertionError(f"rmsnorm {tuple(x.shape)} {x.dtype}: "
                                 f"routes {moved}, expected {route}")
        return got, rms_close(got, rr.rmsnorm(x, w, eps=eps,
                                              scale_offset=off))

    err, times, errs = 0.0, {}, {}
    for rows, D in RMS_SHAPES:
        x, w = inputs(rows, D, bf16)
        got, e = case(x, w, False, "regs")
        err = max(err, e)
        # F.rms_norm's fused kernel needs the weight in x's dtype (with an
        # f32 weight it falls back to a composite of ops): the weight is
        # rounded to bf16 once, outside the timing
        wx = w.to(bf16)
        lib_err = float((F.rms_norm(x, (D,), wx, eps).float()
                         - got.float()).abs().max())
        copies = [x]
        if rows > rk.DECODE_ROWS:
            copies += [x.clone() for _ in range(L2_BYTES * 4
                                                // (x.numel() * 2))]
        turn = itertools.cycle(copies)
        lib = lambda: F.rms_norm(next(turn), (D,), wx, eps)
        kern = lambda: rk.rmsnorm(next(turn), w, eps=eps)
        k1, l1, k2, l2 = (device_ms(f) for f in (kern, lib, kern, lib))
        del copies, turn
        ms, library_ms = (k1 + k2) / 2, (l1 + l2) / 2
        # x read once, w read once, the output written once; ~4 FLOPs an
        # element (square, add, two products)
        nbytes = 2 * x.numel() * 2 + w.numel() * 4
        bound_ms, bound_by = attention_bound(nbytes, 4 * x.numel())
        times[(rows, D)] = (x, w, ms, library_ms, bound_ms, bound_by)
        log(f"rmsnorm {rows} x {D} bf16 ({tuple(rk.plan(rows, D, bf16))}: "
            f"threads a row, rows a block, elements a vector, vectors a "
            f"thread): kernel {ms:.5f} ms ({k1:.5f}, {k2:.5f}), F.rms_norm "
            f"(bf16 weight) {library_ms:.5f} ms ({l1:.5f}, {l2:.5f}), "
            f"kernel / F.rms_norm {ms / library_ms:.3f} (device time, "
            f"torch.profiler, mean of 20, in turns, x "
            f"{'from HBM' if rows > rk.DECODE_ROWS else 'warm in L2'}); "
            f"bound {bound_ms:.6f} ms"
            f" by {bound_by} ({nbytes} bytes at 3.35 TB/s); max_abs_err vs "
            f"plain {e}, F.rms_norm vs kernel {lib_err}")
    for rows, D, dt, off, route in ((8, 4096, bf16, True, "regs"),
                                    (2048, 2048, f32, False, "regs"),
                                    (37, 1000, f32, True, "regs"),
                                    (5, 99, bf16, False, "loop")):
        x, w = inputs(rows, D, dt)
        _, e = case(x, w, off, route)
        errs[f"{rows}x{D} {str(dt)[6:]} offset={off} {route}"] = e
        if dt == bf16:
            err = max(err, e)
    log(f"rmsnorm vs plain, the six serving shapes bf16 on the register "
        f"route: max_abs_err {err} (f32 within 5e-5, bf16 within one ulp of "
        f"each value); routes asserted, two calls bitwise equal; other "
        f"cases {errs}")
    x, w, ms, library_ms, bound_ms, bound_by = times[(2048, 2048)]
    plain_ms = device_ms(lambda: rr.rmsnorm(x, w, eps=eps))
    log(f"rmsnorm 2048 x 2048 bf16 (the kernel line): plain {plain_ms:.5f} "
        f"ms (device time, torch.profiler, mean of 20)")
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:40",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# --------------------------------------------- phase 3: backward kernels
# (name, (B, Sq, Skv, H, Hkv, Dh, Dv, dtype), mask, route): phase 17's
# training shape first (the timed one), then gemma3-1b's local layers,
# whisper-tiny's cross attention, deepseek-v2-lite-16b's MLA, a bf16
# q_offset case and an f32 shape; the route each must take
ATTN_BWD = (
    ("qwen2-0.5b train [4, 1024, 14/2, 64] causal bf16",
     (4, 1024, 1024, 14, 2, 64, 64, "bf16"), {"causal": True}, "wgmma"),
    ("gemma3-1b local [2, 1024, 4/1, 256] window 512 bf16",
     (2, 1024, 1024, 4, 1, 256, 256, "bf16"), {"causal": True,
                                               "window": 512}, "wgmma"),
    ("whisper-tiny cross [2, 256 over 384, 6/6, 64] bf16",
     (2, 256, 384, 6, 6, 64, 64, "bf16"), {"causal": False}, "wgmma"),
    ("deepseek-v2-lite-16b MLA [2, 256, 16/16, 192/128] causal bf16",
     (2, 256, 256, 16, 16, 192, 128, "bf16"), {"causal": True}, "wgmma"),
    ("chunked prefill [2, 200 over 456, 14/2, 64] q_offset 256 bf16",
     (2, 200, 456, 14, 2, 64, 64, "bf16"), {"causal": True,
                                            "q_offset": 256}, "wgmma"),
    ("f32 [2, 256, 14/2, 64] causal (forward on simt)",
     (2, 256, 256, 14, 2, 64, 64, "f32"), {"causal": True}, "simt"),
)


def grad_tol(dtype):
    """Backward tolerance, relative to the reference gradient's largest
    magnitude: 2**-5 for bf16 (the port's bf16 convention,
    tests/test_torch_models.py), 1e-4 for f32."""
    return 2.0**-5 if "bfloat16" in str(dtype) else 1e-4


def check_grads_close(name, got, want):
    """Each gradient within ``grad_tol`` of the largest magnitude of its
    reference; returns the largest absolute error."""
    import torch
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        if not (g.dtype == w.dtype and g.shape == w.shape
                and bool(torch.isfinite(g).all())
                and err <= grad_tol(w.dtype) * scale):
            raise AssertionError(f"{name}: gradient max_abs_err {err} over "
                                 f"max |reference| {scale} (tolerance "
                                 f"{grad_tol(w.dtype)} of it)")
        worst = max(worst, err)
    return worst


def unaligned_copy(t):
    """The same values one element into a buffer: a view no 16-byte
    load can read, which the wrappers send to their CUDA-core or loop
    routes."""
    import torch
    buf = torch.empty(*t.shape[:-1], t.shape[-1] + 8, dtype=t.dtype,
                      device=t.device)
    buf[..., 1:1 + t.shape[-1]] = t
    return buf[..., 1:1 + t.shape[-1]]


def check_flash_attention_bwd(dev, seed):
    """``flash_attention_bwd`` against autograd of the plain attention on
    the card at ``ATTN_BWD``'s shapes: each case on its route (asserted,
    and only that route's counter moved), within ``grad_tol``, two calls
    bitwise equal; the forward kernel's output bitwise the same with and
    without its row statistics; timed at phase 17's shape on both routes
    (``simt`` on unaligned copies of the same values) beside the plain
    backward and the backward of ``F.scaled_dot_product_attention``
    (autograd, its fused kernel)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ref as ar
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    errs, timed = {}, None
    for label, (B, Sq, Skv, H, Hkv, Dh, Dv, dt), kw, route in ATTN_BWD:
        r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(
            dts[dt])
        q, k, v, do = r(B, Sq, H, Dh), r(B, Skv, Hkv, Dh), r(B, Skv, Hkv,
                                                             Dv), r(B, Sq,
                                                                    H, Dv)
        o, lse = fk.flash_attention(q, k, v, lse=True, **kw)
        if not torch.equal(o, fk.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention {label}: the output "
                                 f"with lse differs from without")
        before = dict(fk.flash_attention_bwd.launches_by_route)
        got = fk.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = fk.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        moved = {r_: n - before[r_] for r_, n in
                 fk.flash_attention_bwd.launches_by_route.items()}
        if moved != {r_: 2 * (r_ == route) for r_ in moved}:
            raise AssertionError(f"flash_attention_bwd {label}: routes "
                                 f"{moved}, expected {route!r}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label}: two calls "
                                 f"gave different bits")
        want = ar.mha_bwd(q, k, v, do, **kw)
        errs[f"{label} ({route})"] = check_grads_close(
            f"flash_attention_bwd {label}", got, want)
        if timed is None:
            timed = (label, (q, k, v, o, lse, do), kw)
        del got, again, want
    label, (q, k, v, o, lse, do), kw = timed
    B, S, H, Dh = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    uq, uk, uv = (unaligned_copy(x) for x in (q, k, v))
    if fk.bwd_route(uq, uk, uv, o, do) != "simt":
        raise AssertionError("flash_attention_bwd: unaligned views took "
                             "the wgmma route")
    simt_err = check_grads_close(
        "flash_attention_bwd on simt (unaligned views)",
        fk.flash_attention_bwd(uq, uk, uv, o, lse, do, **kw),
        ar.mha_bwd(q, k, v, do, **kw))
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_err = check_grads_close(
        "SDPA backward (yardstick)", [x.transpose(1, 2) for x in
                                      torch.autograd.grad(out, (qt, kt, vt),
                                                          dot,
                                                          retain_graph=True)],
        ar.mha_bwd(q, k, v, do, **kw))
    ms = device_ms(lambda: fk.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                   reps=10)
    simt_ms = device_ms(lambda: fk.flash_attention_bwd(uq, uk, uv, o, lse,
                                                       do, **kw), reps=3,
                        warmup=1)
    plain_ms = device_ms(lambda: ar.mha_bwd(q, k, v, do, **kw), reps=3,
                         warmup=1)
    library_ms = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), reps=10)
    # q, k, v, o, dO read once and dq, dk, dv written once (bf16), lse read
    # once (f32); five products (S, dP, dV, dK, dQ): 2 (3 Dh + 2 Dv) FLOPs
    # a (query head, row, visible key), S (S + 1) / 2 causal pairs a head
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + 2 * o.numel()) + 4 * lse.numel()
    flops = 2 * (3 * Dh + 2 * Dv) * B * H * S * (S + 1) // 2
    bound_ms, bound_by = attention_bound(nbytes, flops)
    log(f"flash_attention_bwd vs plain (autograd of the plain attention), "
        f"gradients' max_abs_err: {errs}; the simt route at "
        f"{label} {simt_err} (tolerance 2**-5 of max |reference| bf16, "
        f"1e-4 f32); every case's route asserted; two calls bitwise "
        f"equal; the forward's output bitwise the same with its row "
        f"statistics")
    log(f"flash_attention_bwd {label}: kernel {ms:.5f} ms on the wgmma "
        f"route, {simt_ms:.5f} ms on the simt route (the same values in "
        f"unaligned views), plain backward {plain_ms:.5f} ms, library "
        f"(SDPA backward under autograd; max_abs_err against plain "
        f"{lib_err}) {library_ms:.5f} ms (kernel / library "
        f"{ms / library_ms:.3f}, simt / library {simt_ms / library_ms:.3f};"
        f" device time, torch.profiler, mean of 10, 3 simt and plain); "
        f"bound {bound_ms:.6f} ms by {bound_by} ({nbytes} bytes at 3.35 "
        f"TB/s, {flops} FLOPs at 989 TFLOP/s)")
    del uq, uk, uv
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "none: the JAX package's gradient is XLA autodiff "
                        "of src/repro/kernels/attention/ops.py:21 (its "
                        "forward replaces src/repro/kernels/"
                        "flash_attention/kernel.py:124)",
            "max_abs_err": max(e for lb, e in errs.items() if "bf16" in lb),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "routes": {"wgmma": {"ms": ms}, "simt": {"ms": simt_ms}}}


# phase 17's norms: 4 x 1,024 rows of qwen2-0.5b's d_model 896
RMS_BWD_SHAPE = (4096, 896)


def check_rmsnorm_bwd(dev, seed):
    """``rmsnorm_bwd`` against autograd of the plain RMSNorm at phase 17's
    rows (bf16, with and without ``scale_offset``, on the ``regs`` route)
    and an f32 case (896 f32 is 224 vectors: the ``loop`` route), each
    route asserted: within ``grad_tol``, two calls bitwise equal; timed
    on both routes (``loop`` on unaligned copies of the same values)
    beside the plain backward and ``F.rms_norm``'s backward under
    autograd (bf16 weight), over copies of x and dy that together exceed
    the L2 four times, one a call in turn, as training finds them in
    HBM."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rr
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    rows, D = RMS_BWD_SHAPE
    errs = {}
    for dt, off, route in ((torch.bfloat16, False, "regs"),
                           (torch.bfloat16, True, "regs"),
                           (torch.float32, False, "loop")):
        x = torch.randn(rows, D, generator=gen, device=dev).to(dt)
        w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
        dy = torch.randn(rows, D, generator=gen, device=dev).to(dt)
        before = dict(rk.rmsnorm_bwd.launches_by_route)
        got = rk.rmsnorm_bwd(x, w, dy, eps=1e-6, scale_offset=off)
        again = rk.rmsnorm_bwd(x, w, dy, eps=1e-6, scale_offset=off)
        torch.cuda.synchronize()
        moved = {r: n - before[r]
                 for r, n in rk.rmsnorm_bwd.launches_by_route.items()}
        if moved != {r: 2 * (r == route) for r in moved}:
            raise AssertionError(f"rmsnorm_bwd {dt} offset={off}: routes "
                                 f"{moved}, expected {route!r}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("rmsnorm_bwd: two calls gave different bits")
        errs[f"{str(dt)[6:]} offset={off} ({route})"] = check_grads_close(
            f"rmsnorm_bwd {str(dt)[6:]} offset={off}", got,
            rr.rmsnorm_bwd(x, w, dy, eps=1e-6, scale_offset=off))
    w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
    wx = w.to(torch.bfloat16).requires_grad_(True)
    r = lambda: torch.randn(rows, D, generator=gen, device=dev).to(
        torch.bfloat16)
    # (x, dy, F.rms_norm's output on x with the graph kept) a copy
    copies = []
    for _ in range(L2_BYTES * 4 // (2 * rows * D * 2)):
        x = r().requires_grad_(True)
        copies.append((x, r(), F.rms_norm(x, (D,), wx, 1e-6)))
    turn = itertools.cycle(copies)
    # the same values one element into their buffers: the loop route
    x, dy, _ = copies[0]
    ux = unaligned_copy(x.detach().reshape(-1)).view(rows, D)
    loop_err = check_grads_close(
        "rmsnorm_bwd on the loop route (unaligned x)",
        rk.rmsnorm_bwd(ux, w, dy, eps=1e-6),
        rr.rmsnorm_bwd(x.detach(), w, dy, eps=1e-6))
    if rk.bwd_plan(rows, D, torch.bfloat16, False).route != "loop":
        raise AssertionError("rmsnorm_bwd: an unaligned x took regs")
    del ux
    uturn = itertools.cycle([(unaligned_copy(x.detach().reshape(-1)).view(
        rows, D), dy) for x, dy, _ in copies])

    def kern():
        x, dy, _ = next(turn)
        return rk.rmsnorm_bwd(x.detach(), w, dy, eps=1e-6)

    def loop():
        x, dy = next(uturn)
        return rk.rmsnorm_bwd(x, w, dy, eps=1e-6)

    def lib():
        x, dy, y = next(turn)
        return torch.autograd.grad(y, (x, wx), dy, retain_graph=True)

    k1, l1, p1, k2, l2, p2 = (device_ms(f) for f in (kern, lib, loop, kern,
                                                     lib, loop))
    ms, library_ms, loop_ms = (k1 + k2) / 2, (l1 + l2) / 2, (p1 + p2) / 2
    x, dy, _ = copies[0]
    plain_ms = device_ms(lambda: rr.rmsnorm_bwd(x.detach(), w, dy,
                                                eps=1e-6))
    del copies, turn, uturn
    # x and dy read once, dx written once (bf16), w read and dw written
    # once (f32); ~10 f32 operations an element
    nbytes = 3 * rows * D * 2 + 2 * D * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 10 * rows * D / F32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    plan = rk.bwd_plan(rows, D, torch.bfloat16)
    log(f"rmsnorm_bwd vs plain (autograd of the plain RMSNorm) "
        f"[{rows}, {D}], gradients' max_abs_err: {errs}; the loop route "
        f"on unaligned x {loop_err} (tolerance 2**-5 of max |reference| "
        f"bf16, 1e-4 f32); every case's route asserted; two calls bitwise "
        f"equal; plan {plan} (a {plan.blocks * D * 4}-byte dw partial)")
    log(f"rmsnorm_bwd [{rows}, {D}] bf16: kernel {ms:.5f} ms on the regs "
        f"route ({k1:.5f}, {k2:.5f}), {loop_ms:.5f} ms on the loop route "
        f"({p1:.5f}, {p2:.5f}; the same values one element into their "
        f"buffers), plain backward {plain_ms:.5f} ms, library (F.rms_norm "
        f"backward under autograd, bf16 weight) {library_ms:.5f} ms "
        f"({l1:.5f}, {l2:.5f}); kernel / library {ms / library_ms:.3f}, "
        f"loop / library {loop_ms / library_ms:.3f} (device time, "
        f"torch.profiler, mean of 20, in turns, x and dy from HBM); bound "
        f"{bound_ms:.6f} ms by {bound_by} ({nbytes} bytes at 3.35 TB/s)")
    return {"name": "rmsnorm_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm_bwd.cu",
            "replaces": "none: the JAX package's gradient is XLA autodiff "
                        "of src/repro/models/layers/norms.py:17 (its "
                        "forward replaces src/repro/kernels/rmsnorm/"
                        "kernel.py:40)",
            "max_abs_err": max(e for lb, e in errs.items() if "bf" in lb),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "routes": {"regs": {"ms": ms}, "loop": {"ms": loop_ms}}}


# ---------------------------------------------------------------- workflow
def build_workflow(capacity):
    import torch
    from repro_torch.core.event import EventBatch
    from repro_torch.core.operators import AssociativeUpdater, Mapper
    from repro_torch.core.workflow import Workflow
    spec = {"v": ((D,), torch.float32)}

    class PassThrough(Mapper):
        name = "M1"
        subscribes = ("S1",)
        in_value_spec = spec
        out_streams = {"S2": spec}

        def map_batch(self, batch):
            return {"S2": EventBatch(batch.sid, batch.ts + 1, batch.key,
                                     batch.value, batch.valid)}

    class Counter(AssociativeUpdater):
        name = "U1"
        subscribes = ("S2",)
        in_value_spec = spec
        out_streams = {}
        table_capacity = capacity
        sum_mergeable = True

        def slate_spec(self):
            return spec

        def lift(self, batch):
            return {"v": batch.value["v"]}

        def combine(self, a, b):
            return {"v": a["v"] + b["v"]}

        merge = combine

    class Peak(Counter):
        name = "U2"
        sum_mergeable = False
        monoid = "max"

        def combine(self, a, b):
            return {"v": torch.maximum(a["v"], b["v"])}

        merge = combine

    return Workflow([PassThrough(), Counter(), Peak()],
                    external_streams=("S1",))


MAX_LAG = 64


def make_source(cdf, batch, seed, lagged=False):
    """``source_fn(tick, max_events)``: tick t's events come from a
    generator seeded by (seed, t), so the reference regenerates them.
    ``lagged`` stamps each event ``max(t - lag, 0)`` with a lag in
    [0, MAX_LAG) drawn after the keys and values (which stay the
    same)."""
    import torch
    from repro_torch.core.event import EventBatch

    def gen_tick(t):
        g = torch.Generator(device=cdf.device).manual_seed(
            seed * 1_000_003 + t)
        keys, vals = zipf_keys(cdf, batch, g), tick_values(batch, g,
                                                           cdf.device)
        if not lagged:
            return keys, vals, torch.full((batch,), t, dtype=torch.int32,
                                          device=cdf.device)
        lag = torch.randint(0, MAX_LAG, (batch,), generator=g,
                            device=cdf.device)
        return keys, vals, torch.clamp(t - lag, min=0).to(torch.int32)

    def source_fn(t, max_events):
        keys, vals, ts = gen_tick(t)
        dev = keys.device
        valid = torch.ones(batch, dtype=torch.bool, device=dev)
        if max_events is not None:
            valid = torch.arange(batch, device=dev) < max_events
        return {"S1": EventBatch(
            sid=torch.zeros(batch, dtype=torch.int32, device=dev),
            ts=ts, key=keys, value={"v": vals}, valid=valid)}

    return source_fn, gen_tick


def check_no_host_sync(dev, seed):
    """One chunk of ticks with torch's sync debug mode on "error", with
    telemetry off and on: any host sync inside the tick raises."""
    import torch
    from repro_torch.core.engine import Engine, EngineConfig, stack_sources
    from repro_torch.telemetry import TelemetryConfig
    for tel in (None, TelemetryConfig()):
        eng = Engine(build_workflow(1 << 16),
                     EngineConfig(batch_size=4096, queue_capacity=16384,
                                  telemetry=tel), device=dev)
        state = eng.init_state()
        source_fn, _ = make_source(zipf_cdf(dev), 4096, seed + 7,
                                   lagged=True)
        stacked = stack_sources([source_fn(t, None) for t in range(3)])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _, info = eng.run_chunk(state, stacked)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        hits = info["throttle_hits"].tolist()
        extra = "" if tel is None else (
            f", sketch total {int(state['sketch']['total'])}")
        log(f"run_chunk of 3 ticks, telemetry {'off' if tel is None else 'on'},"
            f" under sync debug mode 'error': no host sync (throttle trace "
            f"{hits}{extra})")


# ---------------------------------------------------------------- phase 5
@contextmanager
def torch_probe_calls():
    """Count the torch probe hashes (``slates.table._probe_seq``) and
    torch insert walks (``_lookup_keys``) made while the block runs; on
    the card a path makes neither, its reads and walks running on the
    lookup kernel's ``keys`` and ``find`` routes."""
    from repro_torch.slates import table as tbl
    counts = {"_probe_seq": 0, "_lookup_keys": 0}
    saved = {name: getattr(tbl, name) for name in counts}

    def counting(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name, fn in saved.items():
        setattr(tbl, name, counting(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(tbl, name, fn)


def reset_lookup_routes():
    from repro_torch.kernels.slate_lookup import kernel as lk
    lk.slate_lookup.launches_by_route = dict.fromkeys(lk.ROUTES, 0)


def check_lookup_routes(path, torch_calls):
    """Every read of the path took the lookup kernel's ``keys`` route and
    every ``insert_or_find`` walk its ``find`` route (INSERT_ROUNDS
    launches an insert), no launch took ``cand``, and no torch probe
    hash or walk ran.  Returns the launches by route."""
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.slates.table import INSERT_ROUNDS
    routes = dict(lk.slate_lookup.launches_by_route)
    log(f"slate_lookup launches on the {path} path by route {routes}; "
        f"torch probe hashes and walks {torch_calls}")
    if (routes["cand"] or routes["keys"] <= 0 or routes["find"] <= 0
            or routes["find"] % INSERT_ROUNDS or any(torch_calls.values())):
        raise AssertionError(f"{path}: a read missed the keys route or an "
                             f"insert walk the find route: {routes}, "
                             f"torch calls {torch_calls}")
    return routes


def reference(gen_tick, ticks, n_valid=None):
    """The independent reference: every event fed, in numpy.  Returns
    per-key counts, f64 lane sums and f32 lane maxima over ``N_KEYS +
    Q // 16`` keys (the last ``Q // 16`` are never fed).  ``n_valid(t)``,
    if given, is how many of tick t's events are valid (the first)."""
    import numpy as np
    n = N_KEYS + Q // 16
    counts = np.zeros(n, np.int64)
    sums = np.zeros((n, D), np.float64)
    maxes = np.zeros((n, D), np.float32)
    # 16 ticks a pass (the sums are of small integers in f64: exact in
    # any order), each key's maximum by one segmented reduce
    for t0 in range(0, ticks, 16):
        ks, vs = [], []
        for t in range(t0, min(t0 + 16, ticks)):
            k, v, _ = gen_tick(t)
            k, v = k.cpu().numpy(), v.cpu().numpy()
            if n_valid is not None:
                k, v = k[:n_valid(t)], v[:n_valid(t)]
            ks.append(k.astype(np.int64))
            vs.append(v)
        k, v = np.concatenate(ks), np.concatenate(vs)
        counts += np.bincount(k, minlength=n)
        sums += np.bincount((k[:, None] * D + np.arange(D)).ravel(),
                            weights=v.ravel(), minlength=n * D).reshape(n, D)
        order = np.argsort(k, kind="stable")
        sk = k[order]
        starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
        uk = sk[starts]
        maxes[uk] = np.maximum(maxes[uk], np.maximum.reduceat(
            v[order], starts, axis=0))
    if sums.max() >= 2**24:
        raise AssertionError("a lane sum reached 2**24: f32 not exact")
    return counts, sums, maxes


def read_set(seed):
    """Q keys to read: the hot head, random cold keys, keys never fed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_never = Q // 16
    cold = rng.integers(Q // 2, N_KEYS, Q // 2 - n_never)
    never = np.arange(N_KEYS, N_KEYS + n_never)
    return np.concatenate([np.arange(Q // 2), cold, never])


def check_slates(state, stats, ref, read_keys, reads, ticks, what,
                 fed=None, rank_of=None):
    """Hold a run's stats, batched reads and whole tables against the
    reference.  ``fed``: the events each operator processed (default
    ``ticks * B``); ``rank_of`` maps table keys to the reference's ranks
    (default: the keys are the ranks)."""
    import numpy as np
    counts, sums, maxes = ref
    fed = ticks * B if fed is None else fed
    if any(v != 0 for v in stats["queue_dropped"].values()):
        raise AssertionError(f"{what}: queues dropped events: {stats}")
    if stats["processed"] != {"M1": fed, "U1": fed, "U2": fed}:
        raise AssertionError(f"{what}: processed counts wrong: "
                             f"{stats['processed']}")
    n_seen = int((counts > 0).sum())
    for name, want in (("U1", sums), ("U2", maxes)):
        missing = 0
        for k, row in zip(read_keys, reads[name]):
            if counts[k] == 0:
                if row is not None:
                    raise AssertionError(f"{what} {name}: key {k} never fed")
                continue
            if row is None:
                missing += 1
                continue
            if not np.array_equal(row["v"].numpy(),
                                  want[k].astype(np.float32)):
                raise AssertionError(f"{what} {name}: key {k} reads "
                                     f"{row['v'].tolist()}, reference "
                                     f"{want[k].tolist()}")
        if missing and stats["table_dropped"][name] == 0:
            raise AssertionError(f"{what} {name}: {missing} keys missing "
                                 "and no table drop counted")
        # every slate in the table, not just the read set
        t = state["tables"][name]
        occ = t.keys[:C] != -1
        ks = t.keys[:C][occ].long().cpu().numpy()
        if rank_of is not None:
            ks = rank_of(ks)
        vals = t.vals["v"][:C][occ].cpu().numpy()
        if not np.array_equal(vals, want[ks].astype(np.float32)):
            raise AssertionError(f"{what} {name}: table rows differ from the "
                                 "reference")
        lost = n_seen - ks.size
        if lost and stats["table_dropped"][name] == 0:
            raise AssertionError(f"{what} {name}: {lost} keys lost, none "
                                 "counted")
        log(f"{what} {name}: {ks.size} slates equal to the reference, {lost}"
            f" of {n_seen} fed keys dropped by the table (counted "
            f"{stats['table_dropped'][name]}); read set {read_keys.size} "
            f"keys, {missing} missing")


def end_to_end(dev, ticks, seed, card):
    import torch
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk

    cfg = EngineConfig(batch_size=B, queue_capacity=262144, chunk_size=8)
    eng = Engine(build_workflow(C), cfg, device=dev)
    cdf = zipf_cdf(dev)
    source_fn, gen_tick = make_source(cdf, B, seed)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    state = eng.init_state()

    uk.slate_update.launches = 0
    lk.slate_lookup.launches = 0
    reset_lookup_routes()
    with torch_probe_calls() as torch_calls:
        t0 = time.perf_counter()
        state, _ = eng.run(state, source_fn, ticks)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, drained = eng.drain(state)
        torch.cuda.synchronize()
        t_drain = time.perf_counter() - t0

        read_keys = read_set(seed)
        t0 = time.perf_counter()
        reads = {u: eng.read_slates(state, u, read_keys)
                 for u in ("U1", "U2")}
        t_reads = time.perf_counter() - t0
        singles = [int(k) for k in read_keys[[0, 1, 7, Q // 2, -1]]]
        single = {k: (eng.read_slate(state, "U1", k),
                      eng.read_slate(state, "U2", k)) for k in singles}
    launches = {"slate_update": uk.slate_update.launches,
                "slate_lookup": lk.slate_lookup.launches}
    launches["slate_lookup routes"] = check_lookup_routes("main",
                                                          torch_calls)
    stats = eng.stats(state)
    log(f"end to end, telemetry off: {ticks} ticks x {B} events in "
        f"{t_run:.3f} s = {t_run / ticks * 1e3:.3f} ms/tick, "
        f"{ticks * B / t_run:.4e} events/s (source generation on the card "
        f"included), drain {drained} ticks in {t_drain:.3f} s, "
        f"{2 * read_keys.size} read_slates keys in {t_reads:.4f} s; {card}")
    log(f"engine state on the card: "
        f"{(torch.cuda.memory_allocated() - mem0) / 2**20:.1f} MiB after "
        f"the run; launches on the main path {launches}")
    log(f"stats: processed={stats['processed']} "
        f"queue_dropped={stats['queue_dropped']} "
        f"queue_peak={stats['queue_peak']} "
        f"table_occupancy={stats['table_occupancy']} "
        f"table_dropped={stats['table_dropped']}")
    if min(launches["slate_update"], launches["slate_lookup"]) <= 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")

    ref = reference(gen_tick, ticks)
    check_slates(state, stats, ref, read_keys, reads, ticks, "telemetry off")
    import numpy as np
    counts, sums, maxes = ref
    for k, (a, b) in single.items():
        for name, row, want in (("U1", a, sums), ("U2", b, maxes)):
            if counts[k] and row is not None and not np.array_equal(
                    row["v"].numpy(), want[k].astype(np.float32)):
                raise AssertionError(f"read_slate {name} {k} differs")
            if not counts[k] and row is not None:
                raise AssertionError(f"read_slate {name} {k}: never fed")
    prof = profile_ticks(eng, state, source_fn, ticks, t_run / ticks)
    return launches, ref, t_run / ticks, prof


# ---------------------------------------------------------------- phase 6
def bit_length_table(n):
    """Bucket of each latency in [0, n): Python's exact int.bit_length,
    independent of the port's searchsorted."""
    import numpy as np
    return np.asarray([int(a).bit_length() for a in range(n)], np.int64)


class Reader:
    """A thread asking the HTTP server for every route while ``run``
    goes: the slate of the hot key 0 (404 until its first events land),
    a batched read, ``/status`` and ``/metrics``, then a short pause."""

    def __init__(self, port, pause_s=0.2):
        import threading
        self.url = f"http://127.0.0.1:{port}"
        self.pause_s = pause_s
        self.rounds, self.errors, self.hot_counts = 0, [], []
        self.metrics = ""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def get(self, path):
        import urllib.request
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            if r.status != 200:
                raise AssertionError(f"{path}: HTTP {r.status}")
            return r.read().decode()

    def _hot(self):
        import urllib.error
        try:
            return json.loads(self.get("/slate/U1/0"))["v"][0]
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
            return None

    def _loop(self):
        while not self._stop.is_set():
            try:
                hot = self._hot()
                if hot is not None:
                    self.hot_counts.append(hot)
                keys = ",".join(str(k) for k in range(0, 4096, 64))
                got = json.loads(self.get(f"/slates/U2?keys={keys}"))
                if len(got["slates"]) != 64:
                    raise AssertionError("/slates answered "
                                         f"{len(got['slates'])} keys")
                json.loads(self.get("/status"))
                self.metrics = self.get("/metrics")
                self.rounds += 1
            except Exception as e:         # recorded, raised by stop()
                self.errors.append(repr(e))
                return
            self._stop.wait(self.pause_s)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=60)

    def check(self):
        if self._thread.is_alive() or self.errors:
            raise AssertionError(f"HTTP reader failed: {self.errors}")


def check_metrics_page(text):
    """The page parses as Prometheus text 0.0.4 and carries each arc's
    cumulative latency buckets, ``_sum`` and ``_count``."""
    import re
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'(\+Inf|-?[0-9.e+-]+)$')
    for line in text.strip().splitlines():
        if not line.startswith("#") and not sample.match(line):
            raise AssertionError(f"/metrics: unparseable line {line!r}")
    for arc in ("U1", "U2"):
        b = re.findall(r'muppet_event_latency_ticks_hist_bucket\{arc="'
                       + arc + r'",le="([^"]+)"\} ([0-9.e+]+)', text)
        cum = [float(v) for _, v in b]
        n = re.search(r'muppet_event_latency_ticks_hist_count\{arc="' + arc
                      + r'"\} ([0-9.e+]+)', text)
        sm = re.search(r'muppet_event_latency_ticks_hist_sum\{arc="' + arc
                       + r'"\} ([0-9.e+]+)', text)
        if not (b and b[-1][0] == "+Inf" and cum == sorted(cum) and n and sm
                and float(n.group(1)) == cum[-1] > 0):
            raise AssertionError(f"/metrics: no cumulative _bucket/_sum/"
                                 f"_count series for arc {arc}")


def telemetry_path(dev, ticks, seed, card, ref, off_ms, off_prof):
    import numpy as np
    import torch
    from repro_torch.core.engine import Engine, EngineConfig, StateHandle
    from repro_torch.kernels.countmin import kernel as ck
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.slates.replica import HotKeyCache
    from repro_torch.telemetry import TelemetryConfig

    tc = TelemetryConfig()
    cfg = EngineConfig(batch_size=B, queue_capacity=262144, chunk_size=8,
                       telemetry=tc)
    cdf = zipf_cdf(dev)
    source_fn, gen_tick = make_source(cdf, B, seed, lagged=True)
    # telemetry's own cost: the same run on an engine of its own, with no
    # HTTP reader competing for the host
    eng = Engine(build_workflow(C), cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(eng.init_state(), source_fn, ticks)
    torch.cuda.synchronize()
    quiet_s = (time.perf_counter() - t0) / ticks
    log(f"end to end, telemetry on, no reader: {quiet_s * 1e3:.3f} ms/tick "
        f"against {off_ms * 1e3:.3f} ms/tick with telemetry off "
        f"({quiet_s / off_ms:.4f}x), {B / quiet_s:.4e} events/s; {card}")
    del eng
    torch.cuda.empty_cache()

    eng = Engine(build_workflow(C), cfg, device=dev)
    cache = HotKeyCache(capacity=64)
    handle = StateHandle(eng, eng.init_state(), cache=cache)
    server = handle.serve()
    reader = Reader(server.port)
    kernels = (uk.slate_update, lk.slate_lookup, ck.countmin_update,
               hk.histogram_update)
    try:
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        for k in kernels[2:]:
            k.launches_by_route = dict.fromkeys(k.launches_by_route, 0)
        reset_lookup_routes()
        with torch_probe_calls() as torch_calls:
            reader.start()
            t0 = time.perf_counter()
            state, _ = eng.run(handle.state, source_fn, ticks, handle=handle)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            state, drained = eng.drain(state)
            handle.state = state
            read_keys = read_set(seed)
            reads = {u: handle.read_slates(u, read_keys)
                     for u in ("U1", "U2")}
            reader.stop()
            reader.check()
            # the page after the last window (the live ones may predate it)
            metrics = reader.get("/metrics")
        launches = {k.__name__: k.launches for k in kernels}
        routes = {k.__name__: dict(k.launches_by_route)
                  for k in kernels[2:]}
    finally:
        reader.stop()
        server.close()
    stats = eng.stats(state)
    report = eng.telemetry.last
    log(f"end to end, telemetry on, HTTP reader: {ticks} ticks x {B} events in "
        f"{t_run:.3f} s = {t_run / ticks * 1e3:.3f} ms/tick against "
        f"{off_ms * 1e3:.3f} ms/tick with telemetry off "
        f"({t_run / ticks / off_ms:.4f}x), {ticks * B / t_run:.4e} events/s, "
        f"while the HTTP reader made {reader.rounds} rounds of 4 requests "
        f"(key 0's count as read live: {reader.hot_counts}); "
        f"drain {drained} ticks; {card}")
    log(f"launches on the telemetry path {launches}, by route {routes}; "
        f"hot-key cache {cache.stats()}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the telemetry path: "
                             f"{launches}")
    launches["slate_lookup routes"] = check_lookup_routes("telemetry",
                                                          torch_calls)
    fused = {"countmin_update": "keys", "histogram_update": "ages"}
    for name, route in fused.items():
        if routes[name][route] != launches[name] or routes[name]["cols"]:
            raise AssertionError(f"{name}: a telemetry launch missed the "
                                 f"fused {route} route: {routes[name]}")
    c = reader.hot_counts
    if reader.rounds == 0 or not c or c != sorted(c):
        raise AssertionError(f"the HTTP reader made {reader.rounds} rounds "
                             f"during the run; key 0's live counts {c} "
                             "should be there and never fall")
    check_slates(state, stats, ref, read_keys, reads, ticks, "telemetry on")

    # the last window's heavy hitters: the window covers the ticks from
    # one boundary to the next, whose updaters dequeue the sources of one
    # tick earlier; each of the two updaters counts each event
    last = ticks // tc.window * tc.window
    true0 = 0
    ages = []
    for t in range(ticks):
        k, _, ts = gen_tick(t)
        if last - tc.window - 1 <= t < last - 1:
            true0 += 2 * int((k == 0).sum())
        # an updater dequeues source t's events at tick t + 1, stamped
        # ts + 1 by the mapper
        ages.append(t - ts.cpu().numpy().astype(np.int64))
    top = report.heavy_hitters[0] if report.heavy_hitters else None
    log(f"last report: tick {report.tick}, events {report.events.tolist()}, "
        f"heavy hitters {report.heavy_hitters[:4]}, key 0 true count "
        f"{true0} (both updaters), event latency p50/p90/p99 "
        f"{report.event_latency_p50}/{report.event_latency_p90}/"
        f"{report.event_latency_p99}, queue delay p99 "
        f"{report.queue_delay_p99}")
    if top is None or top[0] != 0 or top[1] < true0:
        raise AssertionError(f"top heavy hitter {top}, expected key 0 with "
                             f"an estimate >= {true0}")
    ages = np.concatenate(ages)
    want = np.bincount(bit_length_table(MAX_LAG)[ages], minlength=32)
    sk = state["sketch"]
    if int(sk["total"]) != 2 * ticks * B:
        raise AssertionError(f"sketch total {int(sk['total'])}")
    for arc in ("U1", "U2"):
        h = state["lat_hist"][arc]
        got = h["counts"].cpu().numpy()[0]
        if got.sum() != stats["processed"][arc] or got[32:].any() \
                or not np.array_equal(got[:32], want) \
                or int(h["sum"]) != int(ages.sum()):
            raise AssertionError(f"{arc} latency histogram {got[:8]} sum "
                                 f"{int(h['sum'])}, reference {want[:8]} "
                                 f"sum {int(ages.sum())}")
    log(f"latency histograms: both arcs equal a numpy bucketing of "
        f"{ages.size} ages (buckets 0-6: {want[:7].tolist()}), sum "
        f"{int(ages.sum())}; sketch total {int(sk['total'])}")
    check_metrics_page(metrics)
    log(f"/metrics after the run: {len(metrics.splitlines())} lines parse, "
        f"with _bucket/_sum/_count for both arcs; the last live page had "
        f"{len(reader.metrics.splitlines())} lines")
    prof = profile_ticks(eng, state, source_fn, ticks, t_run / ticks)
    if prof and off_prof:
        log(f"telemetry on against off in the profiled ticks: "
            f"{prof[1]:.1f} against {off_prof[1]:.1f} device operations a "
            f"tick (+{prof[1] - off_prof[1]:.1f}), busy {prof[0]:.4f} "
            f"against {off_prof[0]:.4f} ms (+{prof[0] - off_prof[0]:.4f})")
    return launches


# ------------------------------------------------------- phases 7 to 11
# ``draw`` requests are drawn from the seed and the first ``requests``
# served (64 in 4 ticks once, then 32 in 2; cut for the time limit):
# the
# requests, and the microbatch the checks read, are the ones 64 served
SERVE = {"requests": 16, "draw": 64, "per_tick": 16, "bucket": 8,
         "prompt_len": 256, "min_prompt": 32, "max_new": 32,
         "cache_len": 512, "ticks": 1}
# each serving phase's slates, rid -> tokens (phase 13c holds
# build_serve_app's against phase 7's)
SERVED = {}


class Arch(NamedTuple):
    """A serving phase: ``SERVE`` with its overrides, the blocks a forward
    runs by kind, and the tolerance of teacher-forced bf16 logits,
    kernels against plain versions: a fixed ``tol``, or with ``tol``
    None the plain path's own bf16-vs-f32 distance, measured in the run,
    plus ``margin``.  With ``top1`` the tolerance must leave positions
    whose top-2 margin exceeds it, where the top-1 tokens are compared."""
    serve: dict
    blocks: dict
    tol: Optional[float]
    margin: float = 0.0
    top1: bool = True


# qwen2-0.5b: each of 24 layers' attention output may round one bf16 ulp
# (2**-8 relative) apart between the kernel (f32 p) and the plain version,
# and the residual stream carries it on: 0.125.  zamba2 at random init
# amplifies a difference from block to block instead of carrying it
# (``per_block`` prints the growth of the kernel path's distance from the
# plain path), so no bound derived per layer holds: its tolerance is the
# distance between the plain path's own bf16 and f32 logits, measured in
# the run, and the block-by-block check of ``per_block`` is the sharp
# one; the same holds for xlstm-350m (the sLSTM recurrence runs 256 steps
# a block; its only kernel is ``rmsnorm``).  That distance exceeds every
# top-2 margin of their logits at random init, so neither has positions
# left for the top-1 check (``top1`` False).  gemma3-1b is qwen2's block
# structure (attention + gated FFN) with 26 layers: qwen2's rule, 0.125 *
# 26 / 24 = 0.135.  deepseek-v2-lite-16b runs with the kernel run's
# expert routing replayed in the plain runs (``pinned_routing``: a
# routing decision is discontinuous in the roundings, the rest is not);
# at random init its MoE outputs grow the residual stream from block to
# block, as zamba2's blocks do (to 256 by block 27), so a rounding
# anywhere is amplified as the plain path's own bf16 roundings are: its
# tolerance is that measured distance plus qwen2's rule for the kernels'
# own roundings, 0.125 per 24 layers, 0.140625 for 27.  Its kernels and
# the phase-3 cases at its exact shapes, and ``per_block``, are the sharp
# checks.
LONG = dict(prompt_len=1024, min_prompt=640, cache_len=1088)
SERVE_ARCHS = {
    "qwen2-0.5b": Arch({}, {"attn": 24}, 0.125),
    "zamba2-1.2b": Arch(dict(requests=8), {"mamba2": 38, "attn": 6}, None,
                        top1=False),
    "xlstm-350m": Arch(dict(requests=16, draw=32, ticks=1),
                       {"mlstm": 12, "slstm": 12}, None, top1=False),
    "gemma3-1b": Arch(dict(requests=8, draw=32, ticks=1, **LONG),
                      {"attn": 26},
                      0.135),
    "deepseek-v2-lite-16b": Arch(dict(requests=16, draw=32, ticks=1),
                                 {"mla": 27, "moe": 26}, None,
                                 0.125 * 27 / 24),
}
# norms a block runs: attention and Mamba-2 blocks two (the pre-norms, or
# the pre-norm and the gated norm), MLA blocks three (with the latent's),
# an mLSTM block two (with its inner norm), an sLSTM block one
NORMS = {"attn": 2, "mla": 3, "mamba2": 2, "mlstm": 2, "slstm": 1}


def serve_of(arch):
    return {**SERVE, **SERVE_ARCHS[arch].serve}


def serving_blocks(cfg, plan):
    """The blocks a forward of ``plan`` runs, by kind: ``attn``, ``mla``,
    ``mamba2``, ``mlstm``, ``slstm``, and ``moe`` (MoE FFNs, beside their
    attention kind)."""
    kinds = {}
    for seg in plan.segments:
        for blk in seg.pattern:
            kind = ("mamba2" if "mamba" in blk.name
                    else blk.name if blk.name in ("mlstm", "slstm")
                    else "mla" if cfg.mla is not None else "attn")
            for k in (kind, "moe") if blk.name == "moe" else (kind,):
                kinds[k] = kinds.get(k, 0) + seg.n_groups
    return kinds


def serving_launches(arch):
    """Launches of each model kernel a microbatch: one prefill and
    max_new - 1 decode forwards; every forward runs each norm once
    (``NORMS`` a block and the final norm), each attention or MLA block
    one attention kernel and each Mamba-2 block one ``ssd_scan`` at
    prefill.  The mLSTM's state (N = 512, P = 513) takes the plain SSD
    version by the JAX package's rule: 0 ``ssd_scan``."""
    blocks, sv = SERVE_ARCHS[arch].blocks, serve_of(arch)
    steps = sv["max_new"] - 1
    attn = blocks.get("attn", 0) + blocks.get("mla", 0)
    norms = sum(NORMS[k] * n for k, n in blocks.items() if k in NORMS)
    out = {"rmsnorm": (norms + 1) * (steps + 1)}
    if attn:
        out.update(flash_attention=attn, decode_attention=attn * steps)
    if blocks.get("mamba2"):
        out["ssd_scan"] = blocks["mamba2"]
    return out


@contextmanager
def plain_versions():
    """Route the model's kernels to their plain versions (the CUDA
    tensors' dispatch otherwise takes the kernels), for the teacher-forced
    checks: every module that holds a kernel dispatcher is patched."""
    import functools
    from types import SimpleNamespace
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.layers import attention, mamba2, mla, norms, xlstm
    mha = SimpleNamespace(mha=functools.partial(attn_ops.mha, impl="ref"))
    dec = SimpleNamespace(
        decode_attend=functools.partial(dec_ops.decode_attend, impl="ref"))
    ssd = SimpleNamespace(ssd=functools.partial(ssd_ops.ssd, impl="ref"),
                          ssd_step=ssd_ops.ssd_step)
    patch = ((attention, "attn_ops", mha), (attention, "dec_ops", dec),
             (mla, "attn_ops", mha), (mla, "dec_ops", dec),
             (norms, "rms_ops", SimpleNamespace(rmsnorm=functools.partial(
                 rms_ops.rmsnorm, impl="ref"))),
             (mamba2, "ssd_ops", ssd), (xlstm, "ssd_ops", ssd))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patch]
    for mod, name, new in patch:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


class pinned_routing:
    """Expert routing recorded in one run and replayed in the next, for
    comparing a MoE model's kernels with its plain versions: which experts
    a token takes is a discontinuous function of the roundings (a near-tie
    of router logits flips with one bf16 ulp of the router's input), the
    rest is continuous.  ``record()`` keeps every ``moe.route`` result;
    ``replay()`` hands them back in order and counts the decisions that
    the run's own routing would have made otherwise (``flips`` of
    ``decisions``); ``off()`` lets routing run as it is."""

    def __enter__(self):
        from repro_torch.models.layers import moe
        self.moe, self.route = moe, moe.route
        self.calls, self.mode, self.i = [], "off", 0
        self.flips = self.decisions = 0
        moe.route = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def record(self):
        self.calls, self.mode = [], "record"

    def replay(self):
        self.mode, self.i = "replay", 0

    def off(self):
        self.mode = "off"

    def _route(self, router, xt, m):
        out = self.route(router, xt, m)
        if self.mode == "record":
            self.calls.append(out)
        elif self.mode == "replay":
            pinned = self.calls[self.i]
            self.i += 1
            same = (out[1].sort(-1).values == pinned[1].sort(-1).values)
            self.flips += int((~same.all(-1)).sum())
            self.decisions += int(same.shape[0])
            out = pinned
        return out


def serving_requests(sv, seed, n, vocab, rid0=1):
    """``n`` requests with prompt lengths uniform in [min_prompt,
    prompt_len] and token ids uniform in [1, vocab), from ``seed``.  The
    lengths are drawn for all ``n`` first, so a phase draws
    ``sv["draw"]`` and serves a prefix."""
    import numpy as np
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    lens = rng.integers(sv["min_prompt"], sv["prompt_len"] + 1, n)
    return [SimpleNamespace(rid=rid0 + i, prompt=rng.integers(
        1, vocab, int(m)).astype(np.int32)) for i, m in enumerate(lens)]


def serving_engine(cfg, model, dev, *, batch, cache_len, max_new, bucket,
                   prompt_len):
    import torch
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.workflow import Workflow
    from repro_torch.ml import LMServeMapper, RequestSlate
    mapper = LMServeMapper(cfg, model, max_new=max_new, cache_len=cache_len,
                           bucket=bucket)
    mapper.subscribes = ("requests",)
    mapper.bind({"prompt": ((prompt_len,), torch.int32),
                 "len": ((), torch.int32)})
    slate = RequestSlate(max_new=max_new, table_capacity=4096)
    slate.subscribes = ("generated",)
    eng = Engine(Workflow([mapper, slate], external_streams=("requests",)),
                 EngineConfig(batch_size=batch), device=dev)
    return eng, mapper


def direct_greedy(sv, mapper, reqs, dev):
    """The tokens of each request from a greedy loop over ``lm.prefill`` /
    ``lm.decode_step`` on the microbatches the engine forms (bucket
    requests in admission order), in the mapper's compute model."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    S, bucket = sv["prompt_len"], sv["bucket"]
    out = {}
    for i in range(0, len(reqs), bucket):
        part = reqs[i:i + bucket]
        toks = np.zeros((bucket, S), np.int32)
        lens = np.zeros(bucket, np.int32)
        for j, r in enumerate(part):
            toks[j, :len(r.prompt)] = r.prompt
            lens[j] = len(r.prompt)
        toks = torch.from_numpy(toks).to(dev)
        lens = torch.from_numpy(lens).to(dev)
        logits, st = lm.prefill(mapper.model, {"tokens": toks}, mapper.ctx,
                                sv["cache_len"], full_logits=True)
        rows = torch.arange(bucket, device=dev)
        tok = torch.argmax(logits[rows, (lens - 1).long()], -1).to(
            torch.int32)
        del logits
        cur, gen = lens.clone(), [tok]
        for _ in range(sv["max_new"] - 1):
            lg, st = lm.decode_step(mapper.model, tok[:, None], st, cur,
                                    mapper.ctx)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
            gen.append(tok)
            cur = cur + 1
        gen = torch.stack(gen, 1).cpu().numpy()
        out.update((r.rid, gen[j]) for j, r in enumerate(part))
    return out


def microbatch(sv, reqs, dev):
    """The first microbatch of ``reqs`` as the engine forms it: tokens
    [bucket, S] (0-padded), lengths, the real positions, and each
    request's first prompt token as a next token."""
    import numpy as np
    import torch
    S, bucket = sv["prompt_len"], sv["bucket"]
    toks = np.zeros((bucket, S), np.int32)
    lens = np.array([len(r.prompt) for r in reqs[:bucket]], np.int32)
    for j, r in enumerate(reqs[:bucket]):
        toks[j, :lens[j]] = r.prompt
    lens_t = torch.from_numpy(lens).to(dev)
    real = (torch.arange(S, device=dev)[None, :] < lens_t[:, None])
    nxt = torch.from_numpy(np.array([[r.prompt[0]] for r in
                                     reqs[:bucket]], np.int32)).to(dev)
    return torch.from_numpy(toks).to(dev), lens_t, real, nxt


@contextmanager
def cross_tap(zero=False):
    """Every cross-attention sublayer's output appended to the yielded
    list, and with ``zero`` zeroed (its state kept): the control of the
    checks with memories."""
    from repro_torch.models.layers import attention
    real = attention.apply
    outs = []

    def apply(p, x, state, ctx, **kw):
        out, st = real(p, x, state, ctx, **kw)
        if kw.get("is_cross"):
            outs.append(out)
            if zero:
                out = out * 0
        return out, st

    attention.apply = apply
    try:
        yield outs
    finally:
        attention.apply = real


def teacher_forced(sv, mapper, reqs, dev, spec, aux=None):
    """One microbatch's full-width prefill logits and one decode step's
    logits, kernels against plain versions (a MoE model's routing of the
    kernel run replayed in the plain runs).  ``aux`` holds the
    microbatch's memories (whisper's ``enc_frames``, the vision model's
    ``image_embeds``); with them, a control run (the plain versions with
    every cross-attention output zeroed) must lie outside the tolerance.
    Returns the max abs
    difference over real positions and the top-1 agreement, and checks
    the top-1 token wherever the plain run's top-2 margin exceeds the
    tolerance (with ``spec.top1``, at one position at least).  The
    tolerance is ``spec.tol``, or with that None the model's own bf16
    sensitivity plus ``spec.margin``: the largest distance between the
    plain versions' bf16 logits and the same plain path's at f32 compute
    (the same bf16 weights, cast to f32 where the layers use them, as the
    JAX package casts at every use: no f32 copy of the model), which this
    run measures and returns."""
    import torch
    from repro_torch.models import lm
    toks, lens_t, real, nxt = microbatch(sv, reqs, dev)
    tol = spec.tol
    aux = aux or {}

    def run(ctx):
        lg, st = lm.prefill(mapper.model, {"tokens": toks, **aux}, ctx,
                            sv["cache_len"], full_logits=True)
        lg = lg[real].float()
        dl, _ = lm.decode_step(mapper.model, nxt, st, lens_t, ctx)
        return lg, dl[:, 0].float()

    with pinned_routing() as pin:
        pin.record()
        got = run(mapper.ctx)
        pin.replay()
        with plain_versions():
            want = run(mapper.ctx)
            floor = None
            if tol is None:
                pin.replay()
                f32 = run(mapper.ctx.replace(cdtype=torch.float32))
                floor = max(float((a - b).abs().max())
                            for a, b in zip(want, f32))
                tol = floor + spec.margin
                del f32
            control = None
            if aux:
                with cross_tap(zero=True):
                    pin.replay()
                    off = run(mapper.ctx)
                control = max(float((a - b).abs().max())
                              for a, b in zip(off, want))
                del off
    torch.cuda.synchronize()
    res = {"tolerance": tol, "bf16_vs_f32_plain": floor}
    if control is not None:
        res["control: plain, cross-attention output zeroed"] = control
        if not control > tol:
            raise AssertionError(f"teacher-forced control: the plain path "
                                 f"with cross-attention zeroed lies "
                                 f"{control} from the plain path, inside "
                                 f"the tolerance {tol}")
    if pin.decisions:
        res["routing flips replayed"] = f"{pin.flips} of {pin.decisions}"
    for name, a, b in (("prefill", got[0], want[0]),
                       ("decode", got[1], want[1])):
        err = float((a - b).abs().max())
        top2 = torch.topk(b, 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = torch.argmax(a, -1) == torch.argmax(b, -1)
        clear = margin > tol
        if err > tol or not bool(same[clear].all()):
            raise AssertionError(
                f"teacher-forced {name} logits: max_abs_err {err}, top-1 "
                f"disagrees at {int((~same & clear).sum())} positions whose "
                f"top-2 margin exceeds {tol}")
        res[name] = {"max_abs_err": err, "top1_agree": float(
            same.float().mean()), "clear_positions": int(clear.sum()),
            "positions": int(b.shape[0]),
            "logit_absmax": float(b.abs().max())}
    if spec.top1 and not any(res[n]["clear_positions"]
                             for n in ("prefill", "decode")):
        raise AssertionError(f"teacher-forced logits: no position's top-2 "
                             f"margin exceeds the tolerance {tol}, so no "
                             f"top-1 token was checked ({res})")
    return res


# a block's output, kernels against plain versions on the same input and
# state: within four bf16 ulps of the output's largest magnitude (2**-5 of
# it), the bf16 tolerance of tests/test_torch_models.py
BLOCK_TOL = 2.0**-5


def per_block(sv, mapper, reqs, dev, aux=None):
    """Teacher forcing block by block, for one microbatch: every block of
    the stack (whisper's encoder blocks and encoder norm first, on the
    microbatch's ``aux`` frames; the vision model's cross blocks over its
    ``aux`` image embeddings), and the final norm and unembedding, gets
    the plain path's input (and, in one decode step, the plain prefill's
    state), once with the kernels and once with the plain versions (a
    MoE block's routing of the kernel run replayed); outputs and new
    states must agree within ``BLOCK_TOL`` of their largest magnitude.
    Errors do not compound across blocks here, as they do end to end.
    With ``aux`` this is the gate for cross attention: each cross-attention
    sublayer's output, kernels against plain versions on the same input,
    must agree within ``BLOCK_TOL`` of its own largest magnitude (a
    cross-attention that the kernels lost reads 1 there, the control: the
    plain path with that output zeroed); and each block that holds one
    runs plain with it zeroed once more, for how far the block's output
    moves (reported).  Returns the largest error relative to that
    magnitude, at prefill and decode, the cross sublayers' own and the
    controls."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.layers import norms
    model, ctx0, cfg = mapper.model, mapper.ctx, mapper.cfg
    toks, lens_t, _, nxt = microbatch(sv, reqs, dev)
    body = model.body.tree()

    def group(t, i):
        return {k: group(v, i) for k, v in t.items()} if isinstance(
            t, dict) else t[i]

    def flat(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in flat(t[k])]
        if isinstance(t, tuple):
            return [x for v in t for x in flat(v)]
        return [] if t is None else [t]

    worst = {"prefill": 0.0, "decode": 0.0}

    def check(where, phase, got, want):
        for a, b in zip(flat(got), flat(want)):
            a, b = a.float(), b.float()
            rel = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            if not rel <= BLOCK_TOL:
                raise AssertionError(f"per-block teacher forcing, {phase}, "
                                     f"{where}: kernels against plain "
                                     f"versions {rel} of the largest value")
            worst[phase] = max(worst[phase], rel)

    blocks = [(f"segment {si} group {i} {blk.name}", blk,
               body["extra"][blk.name] if blk.use_extra
               else group(body["segments"][si][j], i))
              for si, seg in enumerate(model.plan.segments)
              for i in range(seg.n_groups)
              for j, blk in enumerate(seg.pattern)]

    def head(x, ctx):
        x = norms.apply(model.final_norm.tree(), x, eps=cfg.norm_eps,
                        scale_offset=cfg.norm_scale_offset)
        return lm.logits_for(model, x, ctx)

    controls = {"prefill": [], "decode": []}
    cross = {"prefill": 0.0, "decode": 0.0}
    gate = {"prefill": [], "decode": []}

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def both(blk, p, x, st_got, st_want, ctx, phase=None):
        """The block with the kernels and with the plain versions; with
        ``phase`` its cross-attention sublayers checked, and the controls
        run on a copy of its state (the plain versions decode in place)."""
        st_off = copy(st_want) if phase and aux and st_want is not None \
            else None
        pin.record()
        with cross_tap() as xg:
            got = blk.apply(p, x, st_got, ctx)
        pin.replay()
        with plain_versions(), cross_tap() as xw:
            want = blk.apply(p, x, st_want, ctx)
        if phase and xw:
            for a, b in zip(xg, xw, strict=True):
                err = rel(a, b)
                if not err <= BLOCK_TOL:
                    raise AssertionError(
                        f"per-block teacher forcing, {phase}, {blk.name}'s "
                        f"cross-attention: kernels against plain versions "
                        f"{err} of its largest value")
                cross[phase] = max(cross[phase], err)
            pin.replay()
            with plain_versions(), cross_tap(zero=True) as xo:
                off = blk.apply(p, x, st_off, ctx)[0]
            gate[phase] += [rel(torch.zeros_like(b), b) for b in xo]
            controls[phase].append(rel(off, want[0]))
            del off
        pin.off()
        return got, want

    def copy(t):
        return {k: copy(v) for k, v in t.items()} if isinstance(
            t, dict) else t.clone()

    ctx = ctx0.replace(phase="prefill", cache_len=sv["cache_len"],
                       positions=lm._positions(toks.shape, dev))
    x = xk = lm._embed(model, toks, ctx)
    states, growth = [], []
    aux = aux or {}
    with pinned_routing() as pin:
        if "enc_frames" in aux:
            frames = aux["enc_frames"]
            ectx = ctx.replace(phase="train", positions=lm._positions(
                frames.shape[:2], dev))
            xe = frames.to(ctx.cdtype)
            enc = model.enc_body.tree()
            for i in range(model.enc_plan.segments[0].n_groups):
                blk = model.enc_plan.segments[0].pattern[0]
                p = group(enc["segments"][0][0], i)
                (got, _, _), (want, _, _) = both(blk, p, xe, None, None,
                                                 ectx)
                check(f"encoder group {i} {blk.name}", "prefill", got, want)
                xe = want

            def enc_norm(v):
                return norms.apply(model.enc_norm.tree(), v,
                                   eps=cfg.norm_eps)
            with plain_versions():
                memory = enc_norm(xe)
            check("encoder norm", "prefill", enc_norm(xe), memory)
            ctx = ctx.replace(enc_memory=memory)
        if "image_embeds" in aux:
            ctx = ctx.replace(image_embeds=aux["image_embeds"].to(
                ctx.cdtype))
        for n, (name, blk, p) in enumerate(blocks):
            (got, gst, _), (want, wst, _) = both(blk, p, x, None, None, ctx,
                                                 "prefill")
            check(name, "prefill", (got, gst), (want, wst))
            states.append(wst)
            x = want
            # the kernel path on its own inputs (and its own routing): its
            # distance from the plain path as the differences compound
            xk = blk.apply(p, xk, None, ctx)[0]
            if n in (0, 1, 2, 5) or (n + 1) % 7 == 0 or n == len(blocks) - 1:
                growth.append((n + 1, float((xk.float() - x.float()).abs()
                                            .max()),
                               float(x.float().abs().max())))
        with plain_versions():
            want = head(x, ctx)
        check("final norm and logits", "prefill", head(x, ctx), want)

        ctx = ctx0.replace(phase="decode", positions=lens_t[:, None],
                           cur_index=lens_t)
        x = lm._embed(model, nxt, ctx)
        for (name, blk, p), st in zip(blocks, states):
            gst, wst = copy(st), copy(st)
            (got, _, _), (want, _, _) = both(blk, p, x, gst, wst, ctx,
                                             "decode")
            check(name, "decode", (got, gst), (want, wst))
            x = want
        with plain_versions():
            want = head(x, ctx)
        check("final norm and logits", "decode", head(x, ctx), want)
    torch.cuda.synchronize()
    n_enc = model.enc_plan.n_layers + 1 if "enc_frames" in aux else 0
    out = {"blocks": len(blocks) + n_enc, "max_rel_err": worst,
           "tolerance": BLOCK_TOL,
           "compounded (blocks, max abs diff, max abs)": growth}
    if aux:
        out["cross-attention sublayers"] = {
            "max_rel_err": cross, "tolerance": BLOCK_TOL,
            "control: output zeroed (least)": {
                ph: min(g) for ph, g in gate.items()},
            f"control, seen by the block check (least of "
            f"{len(controls['prefill'])} blocks)": {
                ph: min(c) for ph, c in controls.items()}}
        if not min(min(g) for g in gate.values()) > BLOCK_TOL:
            raise AssertionError(f"per-block control: {out}")
    if pin.decisions:
        out["routing flips replayed"] = f"{pin.flips} of {pin.decisions}"
    return out


def describe(cfg, kinds):
    """The configuration's shape, for the log."""
    shape = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
             f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
             f"{cfg.vocab_size}")
    if cfg.ssm is not None:
        s = cfg.ssm
        shape += (f"; Mamba-2 d_inner {s.expand * cfg.d_model}, "
                  f"{s.expand * cfg.d_model // s.head_dim} SSD heads, N "
                  f"{s.state_dim}, P {s.head_dim}, d_conv {s.d_conv}, chunk "
                  f"{s.chunk}; one shared attention block every "
                  f"{cfg.shared_attn_every} Mamba-2 layers")
    if cfg.xlstm is not None:
        x = cfg.xlstm
        d_in = x.mlstm_expand * cfg.d_model
        shape += (f"; mLSTM d_inner {d_in}, N {d_in // cfg.n_heads}, P "
                  f"{d_in // cfg.n_heads + 1}, chunk {x.chunk}; sLSTM FFN "
                  f"{int(cfg.d_model * x.slstm_proj)}")
    if cfg.global_every:
        shape += (f"; window {cfg.sliding_window} on {cfg.global_every - 1} "
                  f"of every {cfg.global_every} layers (rope theta "
                  f"{cfg.rope_theta_local:g}), global theta "
                  f"{cfg.rope_theta:g}")
    if cfg.moe is not None:
        m = cfg.moe
        shape += (f"; {m.n_dense_layers} dense layer, then MoE: "
                  f"{m.n_routed_experts} routed experts top-{m.top_k} + "
                  f"{m.n_shared_experts} shared, d_expert {m.d_expert}, "
                  f"capacity factor {m.capacity_factor}")
    if cfg.mla is not None:
        a = cfg.mla
        shape += (f"; MLA rank {a.kv_lora_rank}, Dh {a.nope_head_dim} + "
                  f"{a.rope_head_dim}, Dv {a.v_head_dim}")
    return shape + f"; blocks a forward by kind {kinds}"


def serving_path(dev, seed, card, arch):
    """LM serving on the MapUpdate engine at full width (``arch``, random
    bf16 weights from ``seed``): ``serve_of(arch)``'s requests, 16 a tick,
    microbatches of 8, a prefill then 31 greedy decode steps each, slates
    read back.  Returns the launches of the path's kernels in its run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.engine import stack_sources
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.ml import request_source
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg, sv, phase = get_config(arch), serve_of(arch), SERVE_ARCHS[arch]
    t0 = time.perf_counter()
    model, _ = lm.init(lm.build(cfg), torch.Generator(device=dev).manual_seed(
        seed), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = serving_blocks(cfg, model.plan)
    if kinds != SERVE_ARCHS[arch].blocks:
        raise AssertionError(f"{arch}: a forward runs blocks {kinds}, not "
                             f"{SERVE_ARCHS[arch].blocks}")
    log(f"serving: {cfg.name} at full width ({describe(cfg, kinds)}); "
        f"{n_params} parameters (config count {cfg.param_count()}) drawn "
        f"on the card in bf16 in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    kw = dict(batch=sv["per_tick"], cache_len=sv["cache_len"],
              max_new=sv["max_new"], bucket=sv["bucket"],
              prompt_len=sv["prompt_len"])
    eng, mapper = serving_engine(cfg, model, dev, **kw)
    del model                    # the mapper holds the same bf16 weights
    reqs = serving_requests(sv, seed, sv["draw"],
                            cfg.vocab_size)[:sv["requests"]]
    source = request_source(reqs, prompt_len=sv["prompt_len"],
                            capacity=sv["per_tick"],
                            per_tick=sv["per_tick"], device=dev)
    state = eng.init_state()
    kernels = (fk.flash_attention, dk.decode_attention, rk.rmsnorm,
               sk.ssd_scan, uk.slate_update, lk.slate_lookup)
    routed = (fk.flash_attention, rk.rmsnorm, sk.ssd_scan)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for k in routed:
        k.launches_by_route = dict.fromkeys(k.launches_by_route, 0)
    reset_lookup_routes()
    mapper.microbatches = 0
    with torch_probe_calls() as torch_calls:
        t0 = time.perf_counter()
        state, _ = eng.run(state, source, sv["ticks"])
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, drained = eng.drain(state)
        torch.cuda.synchronize()
        t_drain = time.perf_counter() - t0
        rids = [r.rid for r in reqs]
        rows = eng.read_slates(state, "requests", rids)
    SERVED[arch] = {rid: row["tokens"].numpy() for rid, row in zip(rids, rows)
                    if row is not None}
    launches = {k.__name__: k.launches for k in kernels if k.launches}
    routes = {k.__name__: dict(k.launches_by_route) for k in routed}
    mb = mapper.microbatches
    ticks = sv["ticks"] + drained
    tick_s = (t_run + t_drain) / ticks
    n_tok = sv["requests"] * sv["max_new"]
    log(f"serving {arch} end to end: {sv['requests']} requests (prompts "
        f"{sv['min_prompt']}-{sv['prompt_len']} padded to "
        f"{sv['prompt_len']}, cache {sv['cache_len']}) x {sv['max_new']} "
        f"tokens in {ticks} ticks ({sv['ticks']} fed + {drained} drain), "
        f"{mb} microbatches of {sv['bucket']}: {t_run + t_drain:.3f} s = "
        f"{tick_s * 1e3:.3f} ms/tick, {n_tok / (t_run + t_drain):.2f} "
        f"generated tokens/s; {card}")
    per_mb = serving_launches(arch)
    log(f"launches on the {arch} serving path {launches} over {mb} "
        f"microbatches (expected a microbatch: {per_mb}), by route "
        f"{routes}; engine stats {eng.stats(state)['processed']}")
    want = {k: n * mb for k, n in per_mb.items()}
    # every serving shape takes the tensor cores / the register route
    for name, route in (("flash_attention", "wgmma"), ("rmsnorm", "regs"),
                        ("ssd_scan", "mma")):
        n = want.get(name, 0)
        if routes[name] != {r: n * (r == route) for r in routes[name]}:
            raise AssertionError(f"{name} routes {routes[name]} on the "
                                 f"{arch} serving path, expected all {n} "
                                 f"on {route!r}")
    if ({k: launches.get(k, 0) for k in want} != want
            or launches.get("slate_update", 0) <= 0
            or launches.get("slate_lookup", 0) <= 0
            or set(launches) - set(want) - {"slate_update", "slate_lookup"}
            or mb != ticks * (sv["per_tick"] // sv["bucket"])):
        raise AssertionError(f"serving launches {launches} for {mb} "
                             f"microbatches, expected {want}")
    if kinds.get("mlstm"):
        log(f"ssd_scan on the {arch} path: {launches.get('ssd_scan', 0)} "
            f"launches (asserted 0): the mLSTM's N = "
            f"{2 * cfg.d_model // cfg.n_heads}, P = N + 1 fail the "
            f"kernel's supported() (P % 8, the JAX package's rule), so "
            f"kernels/ssd/ops.ssd takes the plain version, as the JAX "
            f"package's takes its ref")
    launches["slate_lookup routes"] = check_lookup_routes(
        f"serving {arch}", torch_calls)
    if any(r is None for r in rows):
        raise AssertionError("a request has no slate")

    direct = direct_greedy(sv, mapper, reqs, dev)
    diff = [r.rid for r, row in zip(reqs, rows)
            if not np.array_equal(row["tokens"].numpy(), direct[r.rid])
            or int(row["n"]) != sv["max_new"]]
    if diff:
        raise AssertionError(f"requests {diff} differ from the direct greedy "
                             "loop")
    toks = np.stack([direct[r] for r in rids])
    log(f"all {len(rids)} request slates (read_slates) equal the direct "
        f"greedy loop's tokens bitwise; {len(np.unique(toks))} distinct "
        f"token ids generated")
    tf = teacher_forced(sv, mapper, reqs, dev, phase)
    log(f"teacher-forced, one microbatch, kernels vs plain versions: {tf}")
    torch.cuda.empty_cache()
    pb = per_block(sv, mapper, reqs, dev)
    log(f"teacher-forced block by block, one microbatch, kernels vs plain "
        f"versions on the same input and state: {pb}")
    profile_serving_tick(sv, eng, state, cfg, dev, seed, tick_s)
    del eng, mapper, state
    torch.cuda.empty_cache()

    # a serving tick at the reduced config under sync debug mode
    rcfg = reduced_config(arch)
    rmodel, _ = lm.init(lm.build(rcfg), torch.Generator(
        device=dev).manual_seed(seed))
    reng, _ = serving_engine(rcfg, rmodel, dev, batch=4, cache_len=32,
                             max_new=4, bucket=2, prompt_len=16)
    rreqs = [r for r in serving_requests(SERVE, seed, 8, rcfg.vocab_size)]
    for r in rreqs:
        r.prompt = r.prompt[:16]
    rsrc = request_source(rreqs, prompt_len=16, capacity=4, per_tick=4,
                          device=dev)
    rstate = reng.init_state()
    rstate, _ = reng.step(rstate, rsrc(0, None))      # warm: caches, rope
    stacked = stack_sources([rsrc(1, None)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rstate, _, _ = reng.run_chunk(rstate, stacked)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"a serving tick at {rcfg.name}'s reduced config under sync debug "
        f"mode 'error': no host sync ({reng.stats(rstate)['processed']})")
    log(f"serving {arch}: the phase took {time.perf_counter() - t_phase:.1f}"
        f" s wall")
    return launches


def profile_serving_tick(sv, eng, state, cfg, dev, seed, tick_s):
    """One more serving tick (16 new requests) under torch.profiler: device
    busy time, device operations, the kernels that take most of it, and
    the idle share against the unprofiled ms/tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.ml import request_source
    reqs = serving_requests(sv, seed + 1, sv["per_tick"], cfg.vocab_size,
                            rid0=10_000)
    src = request_source(reqs, prompt_len=sv["prompt_len"],
                         capacity=sv["per_tick"],
                         per_tick=sv["per_tick"], device=dev)
    batch = src(0, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = eng.step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        log("profile of a serving tick: the profiler recorded no device "
            "events (device busy time not measured)")
        return
    busy_us = sum(e.device_time_total for e in dev_events)
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile of one serving tick: device busy {busy_us / 1e3:.4f} "
        f"ms/tick, {len(dev_events)} device operations/tick, profiled wall "
        f"{wall * 1e3:.3f} ms; idle share against the unprofiled "
        f"{tick_s * 1e3:.3f} ms/tick: {1 - busy_us / 1e6 / tick_s:.4f}")
    for name, us in top:
        log(f"  {us / 1e3:.4f} ms/tick  {name[:100]}")
    # the model kernels' share; on an H100 80GB HBM3 at 700 W the earlier
    # decode_attention design (one block a (request, kv head), f32 tiles)
    # took 33.0 ms of a qwen2-0.5b tick over 1,488 launches, and the
    # earlier ssd_scan (f32 CUDA cores only) and rmsnorm (a 256-thread
    # block a row) 31.8 ms over 76 and 16.1 ms over 5,696 of a zamba2-1.2b
    # tick
    was = {("decode_attention", "qwen2-0.5b"): 33.0,
           ("ssd_scan", "zamba2-1.2b"): 31.8,
           ("rmsnorm", "zamba2-1.2b"): 16.1}
    names = {"flash_attention": ("flash_attention",),
             "decode_attention": ("decode_attention",),
             "ssd_scan": ("ssd_scan_kernel", "ssd_mma_kernel"),
             "ssd_scan mma": ("ssd_mma_kernel",),
             "ssd_scan simt": ("ssd_scan_kernel",),
             "rmsnorm": ("rmsnorm_regs", "rmsnorm_loop"),
             "rmsnorm regs": ("rmsnorm_regs",),
             "rmsnorm loop": ("rmsnorm_loop",)}
    for kname, parts in names.items():
        hits = [e.device_time_total for e in dev_events
                if any(p in e.name for p in parts)]
        if not hits:
            continue
        old = was.get((kname, cfg.name))
        log(f"  {kname}: {sum(hits) / 1e3:.4f} ms/tick over {len(hits)} "
            f"launches" + (f" (the earlier design: {old} ms)" if old else ""))


# ---------------------------------------------------------------- phase 12
DURABLE_TICKS = 48                # 64 once: cut for the time limit
CRASH_AT = 40                    # a source tick after two frontiers
WIDE_MUL = 2654435761


def wide_ids(ranks):
    """Phase 12's 64-bit entity ids: Zipf rank r -> ((r + 1) << 32) |
    (r * 2654435761 mod 2**32), a bijection onto ids above 2**32 whose
    low halves differ too (a tensor on the card, or numpy)."""
    import numpy as np
    r = ranks.long() if hasattr(ranks, "long") else \
        np.asarray(ranks, np.int64)
    return ((r + 1) << 32) | ((r * WIDE_MUL) & 0xFFFFFFFF)


def rank_of(ids):
    """The inverse of :func:`wide_ids` (numpy)."""
    return (ids >> 32) - 1


def durable_config(d):
    """Phase 5's engine with int64 keys and durability on: flush every 16
    ticks behind a drain barrier, three store replicas with write and
    read quorums of two, flush deltas kept for a replica."""
    from repro_torch.core.durability import DurabilityConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.slates.flush import FlushConfig
    return EngineConfig(
        batch_size=B, queue_capacity=262144, chunk_size=8, key_dtype="int64",
        durability=DurabilityConfig(
            dir=d, flush=FlushConfig(), barrier=True, replicas=3,
            write_quorum=2, read_quorum=2, track_flush_deltas=True))


def wide_source(dev, seed, crash_at=None, events=None):
    """Phase 5's feed (``events`` a tick, default B) with keys mapped to
    :func:`wide_ids`; the process kills itself (SIGKILL) when asked for
    source tick ``crash_at``."""
    import os
    import signal
    from repro_torch.core.event import EventBatch
    source_fn, gen_tick = make_source(zipf_cdf(dev), events or B, seed)

    def wide_fn(t, max_events):
        if t == crash_at:
            os.kill(os.getpid(), signal.SIGKILL)
        b = source_fn(t, max_events)["S1"]
        return {"S1": EventBatch(b.sid, b.ts, wide_ids(b.key), b.value,
                                 b.valid)}

    return wide_fn, gen_tick


def durable_child(d, seed, dev=None):
    """The crash run of phase 12 (``--durable-child DIR``, a process of
    its own): the durable run of ``durable_path`` in ``DIR``, killed by
    SIGKILL from inside ``source_fn`` at source tick ``CRASH_AT``."""
    import torch
    from repro_torch.core.engine import Engine
    dev = dev or torch.device("cuda", 0)
    eng = Engine(build_workflow(C), durable_config(d), device=dev)
    src, _ = wide_source(dev, seed, crash_at=CRASH_AT)
    eng.run(eng.init_state(), src, DURABLE_TICKS)
    raise AssertionError("the crash run outlived its crash")


def host_tables(state):
    """{updater: (ids ascending, ts, vals)} of every occupied row below
    the sink row, on the host."""
    import numpy as np
    out = {}
    for name, t in state["tables"].items():
        keys = t.keys[:C].cpu().numpy()
        occ = np.flatnonzero(keys != -1)
        order = occ[np.argsort(keys[occ])]
        out[name] = (keys[order], t.ts[:C].cpu().numpy()[order],
                     t.vals["v"][:C].cpu().numpy()[order])
    return out


def timed_appends(eng):
    """Time each WAL append (on the writer thread): returns the list the
    seconds go to."""
    wal, spent = eng.dur.wals[0], []
    append = wal.append

    def timed(tick, sources):
        t0 = time.perf_counter()
        out = append(tick, sources)
        spent.append(time.perf_counter() - t0)
        return out

    wal.append = timed
    return spent


def log_spans(tracer, what, card):
    for sp in tracer.events():
        if sp["name"] in ("flush_begin", "flush_commit", "wal_fence",
                          "recover_restore", "recover_replay"):
            log(f"{what} {sp['name']}: {sp['dur'] / 1e6:.4f} s, "
                f"{json.dumps(sp['args'])}; {card}")


def durable_path(dev, seed, card, phase5_tick_s):
    """Phase 12: phase 5's workflow and feed on 64-bit ids with durability
    on.  An uninterrupted durable run; the same run in a child process
    killed at source tick ``CRASH_AT``; its recovery here with store
    replica 0 down, the resumed run to ``DURABLE_TICKS``; then the checks
    (module docstring).  Returns the launches of the path's kernels."""
    import signal
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.slates.replica import SlateReplica
    from repro_torch.telemetry.trace import Tracer

    t_phase = time.perf_counter()
    src, gen_tick = wide_source(dev, seed)
    ref = reference(gen_tick, DURABLE_TICKS)
    read_ranks = read_set(seed)
    read_ids = wide_ids(read_ranks)
    with tempfile.TemporaryDirectory(prefix="muppet-durable-") as root:
        da, db = f"{root}/uninterrupted", f"{root}/crashed"
        uk.slate_update.launches = 0
        lk.slate_lookup.launches = 0
        reset_lookup_routes()
        with torch_probe_calls() as torch_calls:
            # 1. the uninterrupted durable run
            eng = Engine(build_workflow(C), durable_config(da), device=dev)
            eng.tracer = Tracer()
            appends = timed_appends(eng)
            state = eng.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = eng.run(state, src, DURABLE_TICKS)
            torch.cuda.synchronize()
            tick_s = (time.perf_counter() - t0) / DURABLE_TICKS
            state, drained = eng.drain(state)
            stats_a = eng.stats(state)
            wal_bytes = eng.dur.wal.offset
            log(f"durable run: {DURABLE_TICKS} ticks x {B} events, int64 "
                f"keys, {tick_s * 1e3:.3f} ms/tick against phase 5's "
                f"{phase5_tick_s * 1e3:.3f} ms/tick "
                f"({tick_s / phase5_tick_s:.4f}x), {B / tick_s:.4e} "
                f"events/s; drain {drained} ticks; engine tick "
                f"{stats_a['tick']}; {card}")
            log(f"durable run WAL: {wal_bytes} bytes, "
                f"{wal_bytes / DURABLE_TICKS:.0f} bytes a tick; appends "
                f"{len(appends)}, {sum(appends) / len(appends):.5f} s each "
                f"on the writer thread (max {max(appends):.5f}); {card}")
            log_spans(eng.tracer, "durable run", card)
            reads = {u: eng.read_slates(state, u, read_ids)
                     for u in ("U1", "U2")}
            check_slates(state, stats_a, ref, read_ranks, reads,
                         DURABLE_TICKS, "durable run", rank_of=rank_of)
            base = host_tables(state)
            eng.close()
            del eng, state, reads
            torch.cuda.empty_cache()

            # 2. the crash, in a process of its own
            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--durable-child", db, "--seed", str(seed)],
                capture_output=True, text=True, timeout=600)
            if child.returncode != -signal.SIGKILL:
                raise AssertionError(
                    f"the crash run ended with {child.returncode}, not "
                    f"SIGKILL: {child.stdout[-2000:]} {child.stderr[-4000:]}")
            log(f"crash run: killed by SIGKILL at source tick {CRASH_AT} "
                f"after {time.perf_counter() - t0:.1f} s wall; {card}")

            # 3. recovery with store replica 0 down, the resumed run
            eng = Engine(build_workflow(C), durable_config(db), device=dev)
            eng.tracer = Tracer()
            eng.dur.store.set_replica_down(0)
            frontier = eng.dur.frontier
            f_src = frontier.meta["source_tick"]
            logged = sum(1 for _ in eng.dur.wal.replay(
                from_offset=frontier.wal_offset))
            if f_src != 2 * eng.cfg.durability.flush.every_k:
                raise AssertionError(f"frontier {frontier}: the crash came "
                                     "after two frontiers")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = eng.recover()
            torch.cuda.synchronize()
            t_recover = time.perf_counter() - t0
            rec_tick = int(state["tick"].item())
            log(f"recovery from frontier {frontier.tick} (source tick "
                f"{f_src}, WAL offset {frontier.wal_offset}), {logged} "
                f"source ticks logged after it, store replica 0 down: "
                f"{t_recover:.3f} s wall to engine tick {rec_tick}; {card}")
            log_spans(eng.tracer, "recovery", card)
            rep = SlateReplica(eng.dur.store, eng.wf,
                               max_staleness_ticks=DURABLE_TICKS,
                               flusher=eng.dur.flusher)
            t0 = time.perf_counter()
            rows = rep.refresh(frontier)
            log(f"replica: full refresh at the frontier, {rows} rows in "
                f"{time.perf_counter() - t0:.3f} s; {card}")
            # the log holds the ticks up to the crash that reached disk:
            # the stream resumes after them
            resume = f_src + logged
            eng.tracer = Tracer()
            t0 = time.perf_counter()
            state, _ = eng.run(state, src, DURABLE_TICKS - resume,
                               source_offset=resume)
            torch.cuda.synchronize()
            log(f"resumed run: source ticks {resume}-{DURABLE_TICKS - 1} in "
                f"{time.perf_counter() - t0:.3f} s; {card}")
            log_spans(eng.tracer, "resumed run", card)
            state, drained = eng.drain(state)
            state = eng.checkpoint(state)
            stats = eng.stats(state)
            t0 = time.perf_counter()
            rows = rep.refresh(eng.dur.frontier)
            log(f"replica: incremental refresh at frontier "
                f"{eng.dur.frontier.tick}, {rows} rows in "
                f"{time.perf_counter() - t0:.3f} s; {card}")
            now = int(state["tick"].item())
            reads = {u: eng.read_slates(state, u, read_ids)
                     for u in ("U1", "U2")}
            replica = {u: rep.read_many(u, read_ids.tolist(), now=now)
                       for u in ("U1", "U2")}
        launches = {"slate_update": uk.slate_update.launches,
                    "slate_lookup_wide": lk.slate_lookup.launches}
        launches["slate_lookup_wide routes"] = check_lookup_routes(
            "durable", torch_calls)
        if launches["slate_update"] <= 0:
            raise AssertionError(f"slate_update never ran on the durable "
                                 f"path: {launches}")

        if stats["tick"] != stats_a["tick"]:
            raise AssertionError(f"engine tick {stats['tick']} after "
                                 f"recovery, {stats_a['tick']} without")
        fed = (DURABLE_TICKS - f_src) * B     # counters restart at frontier
        check_slates(state, stats, ref, read_ranks, reads, DURABLE_TICKS,
                     "recovered run", fed=fed, rank_of=rank_of)
        got = host_tables(state)
        for name, (ks, ts, vals) in base.items():
            gk, gts, gv = got[name]
            if not (np.array_equal(ks, gk) and np.array_equal(ts, gts)
                    and vals.tobytes() == gv.tobytes()):
                raise AssertionError(f"recovered {name} differs from the "
                                     "uninterrupted run")
        for u in ("U1", "U2"):
            for k, a, b in zip(read_ids.tolist(), reads[u], replica[u]):
                if (a is None) != (b is None) or (a is not None and (
                        a["v"].numpy().tobytes() != b["v"].tobytes())):
                    raise AssertionError(f"replica {u} key {k}: {b} against "
                                         f"the engine's {a}")
        sizes = ", ".join(f"{n} {len(t[0])} slates" for n, t in base.items())
        log(f"recovered tables equal the uninterrupted run's bitwise, key by "
            f"key ({sizes}), engine tick {stats['tick']} both; processed "
            f"{stats['processed']} = replayed + resumed events; "
            f"SlateReplica.read_many of {read_ids.size} keys equals "
            f"read_slates; launches on the durable path {launches}")
        prof = profile_ticks(eng, state, src, DURABLE_TICKS, tick_s)
        if prof:
            log(f"durable tick, profiled: {prof[1]:.1f} device operations "
                f"and {prof[0]:.4f} ms busy a tick; {card}")
        eng.close()
    log(f"durable path: the phase took {time.perf_counter() - t_phase:.1f} s "
        f"wall; {card}")
    return launches


# ---------------------------------------------------------------- phase 13
APP_TICKS = 64


def front_door_app(capacity):
    """Phase 5's workflow declared through the front door: a source of
    phase 5's spec, two function-style mappers the planner fuses, a
    counter (``slate_update``'s sum route) and a max updater (its max
    route)."""
    import torch
    from repro_torch import App, EventBatch, ops
    app = App("front_door")
    s1 = app.source("S1", {"v": ((D,), torch.float32)})

    @app.mapper(s1, out="Sm")
    def hop(b):                        # one workflow hop: ts + 1
        return EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid)

    @app.mapper("Sm", out="S2")
    def route(b):                      # fused into hop's stage
        return EventBatch(b.sid, b.ts, b.key, b.value, b.valid)

    app.stream("S2").update(ops.counter("U1", table_capacity=capacity))

    @app.updater("S2", name="U2", merge="max",
                 slate={"v": ((D,), torch.float32)},
                 table_capacity=capacity)
    def peak(b):
        return {"v": b.value["v"]}
    return app


def table_rows(state, name):
    """An updater's occupied rows below the sink: (int64 keys, {leaf:
    values}), numpy."""
    t = state["tables"][name]
    cap = t.keys.shape[0] - 1
    occ = t.keys[:cap] != -1
    return (t.keys[:cap][occ].long().cpu().numpy(),
            {k: v[:cap][occ].cpu().numpy() for k, v in t.vals.items()})


def app_counting_path(dev, seed, card, phase5_tick_s):
    """Phase 13a: phase 5's feed through ``App.run`` at the main path's
    scale, telemetry and tracing on; every slate against the numpy
    reference and a subclass-``Workflow`` run of the same ticks."""
    import json
    import tempfile
    import urllib.request
    import numpy as np
    import torch
    from repro_torch import RuntimeConfig
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.kernels.countmin import kernel as ck
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.telemetry import TelemetryConfig

    t_phase = time.perf_counter()
    app = front_door_app(C)
    if app.plan.fused_chains != [("hop", "route")]:
        raise AssertionError(f"fused chains {app.plan.fused_chains}")
    tc = TelemetryConfig(trace=True)
    rt = RuntimeConfig(batch_size=B, queue_capacity=262144, chunk_size=8,
                       telemetry=tc)
    cdf = zipf_cdf(dev)
    source_fn, gen_tick = make_source(cdf, B, seed)
    kernels = (uk.slate_update, lk.slate_lookup, ck.countmin_update,
               hk.histogram_update)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for k in kernels[2:]:
        k.launches_by_route = dict.fromkeys(k.launches_by_route, 0)
    uk.slate_update.launches_by_op = dict.fromkeys(
        uk.slate_update.launches_by_op, 0)
    reset_lookup_routes()
    with torch_probe_calls() as torch_calls:
        h = app.start(rt, device=dev)
        t0 = time.perf_counter()
        app.run(source_fn, APP_TICKS)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        app.run(source_fn, 0, drain=True)
        read_keys = read_set(seed)
        reads = h.read_slates("U1", read_keys), h.read_slates("U2", read_keys)
        singles = [int(k) for k in read_keys[[0, 1, 7, Q // 2, -1]]]
        single = {k: (app.read_slate("U1", k), app.read_slate("U2", k))
                  for k in singles}
        server = app.serve()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/slate/U1/0",
                    timeout=30) as r:
                http0 = json.load(r)
        finally:
            server.close()
    launches = {k.__name__: k.launches for k in kernels}
    routes = {k.__name__: dict(k.launches_by_route) for k in kernels[2:]}
    by_op = dict(uk.slate_update.launches_by_op)
    stats = app.stats()
    tick_s = t_run / APP_TICKS
    log(f"front door (App.run), counting and max: {APP_TICKS} ticks x {B} "
        f"events in {t_run:.3f} s = {tick_s * 1e3:.3f} ms/tick, "
        f"{APP_TICKS * B / t_run:.4e} events/s (telemetry and tracing on) "
        f"against phase 5's {phase5_tick_s * 1e3:.3f} ms/tick (telemetry "
        f"off, subclass Workflow); {card}")
    log(f"launches on the front-door counting path {launches}, "
        f"slate_update by monoid {by_op}, count kernels by route {routes}")
    if min(launches.values()) <= 0 or min(by_op.values()) <= 0 \
            or sum(by_op.values()) != launches["slate_update"]:
        raise AssertionError(f"a kernel or monoid never ran on the front "
                             f"door: {launches}, {by_op}")
    for name, rte in {"countmin_update": "keys",
                      "histogram_update": "ages"}.items():
        if routes[name][rte] != launches[name] or routes[name]["cols"]:
            raise AssertionError(f"{name}: a launch missed the fused {rte} "
                                 f"route: {routes[name]}")
    launches["slate_lookup routes"] = check_lookup_routes("front door",
                                                          torch_calls)
    if any(stats["queue_dropped"].values()) or \
            any(stats["queue_size"].values()):
        raise AssertionError(f"front door: queues dropped or kept events: "
                             f"{stats}")
    fed = APP_TICKS * B
    if stats["processed"] != {"hop+route": fed, "U1": fed, "U2": fed}:
        raise AssertionError(f"processed {stats['processed']}")

    counts, _, maxes = reference(gen_tick, APP_TICKS)
    # the same ticks through phase 5's subclass Workflow
    eng5 = Engine(build_workflow(C), EngineConfig(
        batch_size=B, queue_capacity=262144, chunk_size=8), device=dev)
    st5, _ = eng5.run(eng5.init_state(), source_fn, APP_TICKS)
    st5, _ = eng5.drain(st5)
    state = h.state
    for name, leaf, want, lanes in (("U1", "count", counts, slice(0, 1)),
                                    ("U2", "v", maxes, slice(None))):
        keys, vals = table_rows(state, name)
        keys5, vals5 = table_rows(st5, name)
        vals, vals5 = vals[leaf], vals5["v"]
        vals5 = vals5[:, lanes].reshape(vals.shape)
        if name == "U1":
            vals5 = vals5.astype(np.int64)
        if not (np.array_equal(keys, keys5) and np.array_equal(vals, vals5)):
            raise AssertionError(f"front door {name}: tables differ from "
                                 f"phase 5's workflow")
        ref = want[keys] if name == "U1" else want[keys].astype(np.float32)
        if not np.array_equal(vals, ref) or \
                keys.size != int((counts > 0).sum()) or \
                stats["table_dropped"][name]:
            raise AssertionError(f"front door {name}: slates differ from "
                                 f"the numpy reference")
        log(f"front door {name}: {keys.size} slates equal the numpy "
            f"reference and phase 5's workflow over the same ticks "
            f"(keys in the same slots)")
    for name, rows, want in (("U1", reads[0], counts), ("U2", reads[1],
                                                         maxes)):
        for k, row in zip(read_keys, rows):
            got = None if row is None else (
                int(row["count"]) if name == "U1" else row["v"].numpy())
            ok = (got is None) if not counts[k] else (
                got == want[k] if name == "U1" else
                np.array_equal(got, want[k].astype(np.float32)))
            if not ok:
                raise AssertionError(f"read_slates {name} {k}: {got}")
    for k, (a, b) in single.items():
        if (a is None) != (not counts[k]) or (a is not None and (
                int(a["count"]) != counts[k] or not np.array_equal(
                    b["v"].numpy(), maxes[k].astype(np.float32)))):
            raise AssertionError(f"read_slate {k}: {a}, {b}")
    if http0.get("count") != int(counts[0]):
        raise AssertionError(f"/slate/U1/0 answered {http0}, reference "
                             f"{int(counts[0])}")
    rep = app.telemetry()
    if not rep.heavy_hitters or rep.heavy_hitters[0][0] != 0:
        raise AssertionError(f"heavy hitters {rep.heavy_hitters[:4]}")
    with tempfile.TemporaryDirectory() as d:
        path = app.export_trace(str(Path(d) / "trace.json"))
        with open(path) as f:
            spans = json.load(f)["traceEvents"]
    names = sorted({e["name"] for e in spans})
    if not spans or "chunk_dispatch" not in names:
        raise AssertionError(f"trace spans {names}")
    log(f"front door: read_slates and read_slate of {read_keys.size} keys "
        f"equal the reference; /slate/U1/0 answered {http0}; telemetry's "
        f"top heavy hitters {rep.heavy_hitters[:3]}; export_trace wrote "
        f"{len(spans)} spans ({names})")
    profile_ticks(app.engine, h.state, source_fn, APP_TICKS, tick_s)
    app.close()
    del app, h, state, eng5, st5
    torch.cuda.empty_cache()
    log(f"front door counting: the phase took "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return launches


TRENDS = {"events": 256, "seq": 32, "min_len": 8, "ticks": 8,
          "topics": 1024, "items": 1 << 10, "bucket": 32, "k": 8,
          "n_slots": 32, "pk": 4, "capacity": 1 << 16}
# f32 embeddings, kernels against plain versions, 24 layers: each
# layer's kernels reorder f32 reductions and the residual stream carries
# it on.  On the H100 the largest difference read 5.3e-06 with the
# largest |emb| near 4; 2**-16 of the largest |emb| (~6e-05) is about
# ten times that.  A control holds that the bound catches a bf16 route:
# the plain path with one kernel's output rounded to bf16 must exceed it.
EMB_TOL = 2.0**-16
# a Personalization score is an f32 dot product of width 896 (batched
# on the card, one row at a time on the host): 896 x 2**-24 < 2**-14 of
# the slate's largest |score|
DOT_TOL = 2.0**-14


def trends_feed(seed, vocab):
    """``source_fn`` of phase 13b and its numpy ticks: token windows of
    8-32 tokens (0-padded to 32), items in [1, 2**10), topics Zipf(1.2)
    over 1,024."""
    import numpy as np
    tv = TRENDS
    p = np.arange(1, tv["topics"] + 1, dtype=np.float64) ** -ZIPF_ALPHA
    p /= p.sum()
    rng = np.random.default_rng(seed + 13)
    ticks = []
    for _ in range(tv["ticks"]):
        n = tv["events"]
        toks = rng.integers(1, vocab, (n, tv["seq"])).astype(np.int32)
        lens = rng.integers(tv["min_len"], tv["seq"] + 1, n)
        toks[np.arange(tv["seq"])[None, :] >= lens[:, None]] = 0
        ticks.append({"key": rng.choice(tv["topics"], n, p=p).astype(
            np.int32), "tokens": toks, "item": rng.integers(
                1, tv["items"], n).astype(np.int32)})
    return ticks


def sequential_order(keys, ts, valid, batch, max_run, take=None):
    """The order in which a sequential updater fed ``batch`` events a
    tick by one upstream stage steps through them, from the engine's
    documented semantics (not its code): emission ``i`` of ``keys`` /
    ``ts`` / ``valid`` (the stage's outputs, ``batch`` a tick, tick by
    tick) joins the updater's FIFO queue at the end of its tick; each
    tick the updater takes the first ``take`` (default ``batch``) queued
    events, orders them by (key, ts) stably, steps through the first
    ``max_run`` of each key and re-queues the rest, in that order, ahead
    of the tick's new emissions.  Returns the emission indices in
    stepping order."""
    import numpy as np
    ticks = len(keys) // batch
    take_n = batch if take is None else take
    keys, ts = np.asarray(keys).tolist(), np.asarray(ts).tolist()
    queue, order, t = [], [], 0
    while t < ticks or queue:
        take, queue = queue[:take_n], queue[take_n:]
        take.sort(key=lambda i: (keys[i], ts[i]))
        seen, deferred = {}, []
        for i in take:
            n = seen[keys[i]] = seen.get(keys[i], 0) + 1
            (order if n <= max_run else deferred).append(i)
        queue += deferred
        if t < ticks:
            lo = t * batch
            queue += (lo + np.nonzero(valid[lo:lo + batch])[0]).tolist()
        t += 1
    return order


def replay_personalization(events, d, k, alpha):
    """The sequential slate of each topic, one event at a time on the
    host (f32 numpy, the reference's step for one row), and the smallest
    gap between adjacent ranked scores each topic's replay met."""
    import numpy as np
    out = {}
    for key, evs in events.items():
        user = np.zeros(d, np.float32)
        items = np.zeros(k, np.int32)
        cand = np.zeros((k, d), np.float32)
        scores = np.zeros(k, np.float32)
        n, gap = 0, np.inf
        for emb, item in evs:
            user = emb.copy() if n == 0 else (
                np.float32(1.0 - alpha) * user + np.float32(alpha) * emb)
            c = np.concatenate([cand, emb[None]])
            it = np.concatenate([items, [item]]).astype(np.int32)
            live = (it > 0) & ~((it == item) & (np.arange(k + 1) < k))
            s = np.where(live, c @ user, -np.inf).astype(np.float32)
            order = np.argsort(-s, kind="stable")
            fin = s[order][np.isfinite(s[order])]
            if fin.size > 1:
                gap = min(gap, float(np.min(fin[:-1] - fin[1:])))
            order = order[:k]
            sel = np.isfinite(s[order])
            items = np.where(sel, it[order], 0).astype(np.int32)
            cand = np.where(sel[:, None], c[order], 0).astype(np.float32)
            scores = np.where(sel, s[order], 0).astype(np.float32)
            n += 1
        out[key] = ({"user": user, "items": items, "cand": cand,
                     "scores": scores, "n": n}, gap)
    return out


def app_trends_path(dev, seed, card):
    """Phase 13b: ModelMapper (qwen2-0.5b at full width, f32) ->
    SemanticTopK and Personalization through ``App.run``."""
    import numpy as np
    import torch
    from repro_torch import App, EventBatch, RuntimeConfig, ops
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.ml.rankers import pack_word
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    tv = TRENDS
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    model, _ = lm.init(lm.build(cfg), torch.Generator(device=dev).manual_seed(
        seed))
    torch.cuda.synchronize()
    log(f"front door trends: {cfg.name} at full width ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), f32 weights drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    app = App("semantic_trends")
    app.source("events", {"tokens": ((tv["seq"],), torch.int32),
                          "item": ((), torch.int32)})
    mm = ops.model_mapper(cfg, model, field="tokens", out="scored",
                          bucket=tv["bucket"], keep=("item",), name="embed",
                          device=dev)
    app.add(mm, subscribes=("events",))
    ranker = ops.semantic_topk(k=tv["k"], n_slots=tv["n_slots"],
                               table_capacity=tv["capacity"])
    pers = ops.personalization(d=cfg.d_model, k=tv["pk"],
                               table_capacity=tv["capacity"])
    app.stream("scored").update(ranker)
    app.stream("scored").update(pers)
    wf = app.build()
    if app.plan.fused_chains or [op.name for op in wf.operators] != [
            "embed", "semantic_topk", "personalization"]:
        raise AssertionError(f"trends plan {app.plan.fused_chains}, "
                             f"{[op.name for op in wf.operators]}")
    stage = wf.by_name["embed"]            # the planner's copy
    emitted = []
    map_batch = stage.map_batch

    def spy(batch):
        out = map_batch(batch)
        o = out["scored"]
        emitted.append((o.key.clone(), o.value["item"].clone(),
                        o.value["emb"].clone(), (o.valid & batch.valid)
                        .clone(), o.ts.clone()))
        return out
    stage.map_batch = spy

    ticks = trends_feed(seed, cfg.vocab_size)

    def source_fn(t, max_events):
        d = ticks[t]
        valid = np.arange(tv["events"]) < (max_events or tv["events"])
        return {"events": EventBatch.of(
            key=d["key"], value={"tokens": d["tokens"], "item": d["item"]},
            ts=t, valid=valid, device=dev)}

    rows = tv["bucket"] * tv["seq"]
    rms_route = rk.plan(rows, cfg.d_model, torch.float32).route
    kernels = (fk.flash_attention, rk.rmsnorm, uk.slate_update,
               lk.slate_lookup)
    routed = (fk.flash_attention, rk.rmsnorm)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for k in routed:
        k.launches_by_route = dict.fromkeys(k.launches_by_route, 0)
    uk.slate_update.launches_by_op = dict.fromkeys(
        uk.slate_update.launches_by_op, 0)
    reset_lookup_routes()
    stage.microbatches = 0
    with torch_probe_calls() as torch_calls:
        rt = RuntimeConfig(batch_size=tv["events"],
                           queue_capacity=4 * tv["events"], chunk_size=8)
        h = app.start(rt, device=dev)
        t0 = time.perf_counter()
        app.run(source_fn, tv["ticks"])
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        deferred = app.stats()["deferred"]
        t0 = time.perf_counter()
        app.run(source_fn, 0, drain=True)
        torch.cuda.synchronize()
        t_drain = time.perf_counter() - t0
        topics = np.arange(tv["topics"])
        rk_rows = h.read_slates("semantic_topk", topics)
        ps_rows = h.read_slates("personalization", topics)
    launches = {k.__name__: k.launches for k in kernels}
    routes = {k.__name__: dict(k.launches_by_route) for k in routed}
    by_op = dict(uk.slate_update.launches_by_op)
    stats = app.stats()
    mb = stage.microbatches
    n_ev = tv["ticks"] * tv["events"]
    drained = stats["tick"] - tv["ticks"]
    tick_s = t_run / tv["ticks"]
    log(f"front door trends: {tv['ticks']} ticks x {tv['events']} events "
        f"of {tv['seq']} tokens in {t_run:.3f} s = {tick_s * 1e3:.3f} "
        f"ms/tick, {n_ev / t_run:.2f} events/s, {mb} microbatches of "
        f"{tv['bucket']}; drain {drained} ticks in {t_drain:.3f} s "
        f"(deferred head-topic events {deferred} by the end of the fed "
        f"ticks); {card}")
    log(f"launches on the front-door trends path {launches}, by route "
        f"{routes}, slate_update by monoid {by_op}; processed "
        f"{stats['processed']}")
    want = {"flash_attention": cfg.n_layers * mb,
            "rmsnorm": (2 * cfg.n_layers + 1) * mb}
    for name, rte in (("flash_attention", "simt"), ("rmsnorm", rms_route)):
        n = want[name]
        if launches[name] != n or routes[name] != {
                r: n * (r == rte) for r in routes[name]}:
            raise AssertionError(f"{name}: {launches[name]} launches by "
                                 f"route {routes[name]}, expected {n} on "
                                 f"{rte!r}")
    if mb != stats["tick"] * tv["events"] // tv["bucket"] or \
            by_op["max"] <= 0 or by_op["sum"]:
        raise AssertionError(f"microbatches {mb} over {stats['tick']} "
                             f"ticks; slate_update by monoid {by_op}")
    launches["slate_lookup routes"] = check_lookup_routes("front door trends",
                                                          torch_calls)
    if deferred <= 0 or any(stats["queue_dropped"].values()) or \
            any(stats["queue_size"].values()) or \
            stats["processed"]["personalization"] != n_ev or \
            stats["processed"]["semantic_topk"] != n_ev:
        raise AssertionError(f"trends: deferral, drops or drain wrong: "
                             f"deferred {deferred}, {stats}")
    log(f"flash_attention took the {routes['flash_attention']} routes "
        f"({cfg.n_layers} a microbatch, f32: 'simt'); rmsnorm "
        f"{routes['rmsnorm']} ({2 * cfg.n_layers + 1} a microbatch, f32 "
        f"rows of {cfg.d_model}: {rms_route!r})")

    # the events the mapper emitted, in emission order
    keys, items, embs, valid, ts = (torch.cat(x) for x in zip(*emitted))
    valid = valid.cpu().numpy()
    if int(valid.sum()) != n_ev:
        raise AssertionError(f"the mapper emitted {int(valid.sum())} valid "
                             f"events, fed {n_ev}")
    # embeddings with the kernels against lm.forward on the plain versions
    first = tv["events"] // tv["bucket"]
    toks = torch.from_numpy(ticks[0]["tokens"]).to(dev)
    with plain_versions():
        plain = torch.cat([mm.infer(toks[i * tv["bucket"]:(i + 1)
                                         * tv["bucket"]])
                           for i in range(first)])
    got = embs[:tv["events"]]
    err = float((got - plain).abs().max())
    bound = EMB_TOL * float(plain.abs().max())
    log(f"embeddings of tick 0 ({first} microbatches), kernels against "
        f"the plain versions: max |diff| {err:.3e}, bound {bound:.3e} "
        f"(2**-16 of max |emb| {float(plain.abs().max()):.4f})")
    if not err <= bound:
        raise AssertionError("embeddings differ from the plain versions")
    # the control: the plain path of the first microbatch with the
    # attention's or the norm's output rounded to bf16 (a route that
    # computes or stores in bf16) must fall outside the bound
    from types import SimpleNamespace
    from repro_torch.models.layers import attention, norms
    for mod, name, attr in ((attention, "attn_ops", "mha"),
                            (norms, "rms_ops", "rmsnorm")):
        with plain_versions():       # restores the patch below on exit
            fn = getattr(getattr(mod, name), attr)
            setattr(mod, name, SimpleNamespace(**{
                attr: lambda *a, fn=fn, **k: fn(*a, **k).to(
                    torch.bfloat16).float()}))
            ctrl = mm.infer(toks[:tv["bucket"]])
        c_err = float((ctrl - plain[:tv["bucket"]]).abs().max())
        log(f"control: the plain path with {attr}'s output rounded to "
            f"bf16, max |diff| {c_err:.3e} against the bound {bound:.3e}")
        if not c_err > bound:
            raise AssertionError(f"the embedding bound does not catch a "
                                 f"bf16 {attr}")

    # SemanticTopK: every slate against the packed words of the mapper's
    # own emitted embeddings, scored by the ranker's own function
    words = []
    for _, it, e, _, _ in emitted:
        words.append(pack_word(ranker.scores({"emb": e}), it).cpu().numpy())
    words = np.concatenate(words)
    keys_np, items_np = keys.cpu().numpy(), items.cpu().numpy()
    want_cells = {}
    for i in np.nonzero(valid)[0]:
        row = want_cells.setdefault(int(keys_np[i]),
                                    np.zeros(tv["n_slots"], np.float32))
        col = int(items_np[i]) % tv["n_slots"]
        row[col] = max(row[col], words[i])
    for t, row in zip(topics, rk_rows):
        want_row = want_cells.get(int(t))
        if (row is None) != (want_row is None) or (
                row is not None and not np.array_equal(
                    row["cells"].numpy(), want_row)):
            raise AssertionError(f"semantic_topk topic {t} differs from "
                                 f"the replay of the packed words")
    log(f"semantic_topk: {len(want_cells)} topic slates equal, bitwise, "
        f"the max of the packed words of the mapper's emitted scores; "
        f"topic 0's top items {ranker.top(rk_rows[0])[:4]}")

    # Personalization: every slate against a per-event host replay, in
    # the order the engine's semantics give each key's events
    emb_np = embs.cpu().numpy()
    events = {}
    for i in sequential_order(keys_np, ts.cpu().numpy(), valid,
                              tv["events"], pers.max_run):
        events.setdefault(int(keys_np[i]), []).append(
            (emb_np[i], int(items_np[i])))
    replay = replay_personalization(events, cfg.d_model, tv["pk"],
                                    pers.alpha)
    near, worst = [], 0.0
    for t, row in zip(topics, ps_rows):
        if int(t) not in replay:
            if row is not None:
                raise AssertionError(f"personalization topic {t}: a slate "
                                     "for a topic never fed")
            continue
        want, gap = replay[int(t)]
        got = {k: v.numpy() for k, v in row.items()}
        scale = max(1.0, float(np.abs(want["scores"]).max()))
        tol = DOT_TOL * scale
        if int(got["n"]) != want["n"] or not np.array_equal(
                got["user"], want["user"]):
            raise AssertionError(f"personalization topic {t}: n or the "
                                 f"EMA profile differs from the replay")
        if gap <= 2 * tol:
            near.append(int(t))   # a near-tie the two orders may split
            continue
        diff = float(np.abs(got["scores"] - want["scores"]).max())
        worst = max(worst, diff / scale)
        if not (np.array_equal(got["items"], want["items"])
                and np.array_equal(got["cand"], want["cand"])
                and diff <= tol):
            raise AssertionError(f"personalization topic {t}: items "
                                 f"{got['items']} vs {want['items']}, "
                                 f"score diff {diff:.3e} > {tol:.3e}")
    log(f"personalization: {len(replay)} topic slates against a per-event "
        f"host replay: n and the EMA profile bitwise for all; items and "
        f"candidates exact, scores within 2**-14 of the largest (worst "
        f"{worst:.3e} relative) for the {len(replay) - len(near)} topics "
        f"whose replay met no near-tie (gap <= 2 x tolerance: {near[:8]})")
    if len(near) * 2 > len(replay):
        raise AssertionError(f"{len(near)} of {len(replay)} topics met a "
                             "near-tie: too few checked")
    stage.map_batch = map_batch
    profile_ticks(app.engine, h.state, source_fn, 0, tick_s, n=1)
    app.close()
    del app, h, mm, model, stage, emitted, embs
    torch.cuda.empty_cache()
    log(f"front door trends: the phase took "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return launches


# The launcher runs 64 ticks at two batches.  At 64 events a tick its
# 2**14-slot table stays below a quarter full and nothing is dropped at
# the probe limit: the recovered run must print the uninterrupted run's
# stats and slates.  At its default 256 the table holds ~8,100 keys and
# drops at the probe limit; recovery re-inserts the flushed keys in key
# order, so another key can meet the limit after recovery and the
# recovered state loses events the uninterrupted run kept (ROADMAP queue
# 3, a fault of the reference that the port copies).  There the check
# holds what does hold and prints the divergence.
LAUNCHER_TICKS, LAUNCHER_BATCHES = 64, (64, 256)


def launcher(d, batch, *more):
    """Start ``python -m repro_torch.launch.stream`` in a subprocess on
    this card.  Returns a function that waits for it (killing it past
    300 s) and returns (stats without ``processed``, processed, the slate
    lines, the lines before the stats) of its closing print, or its
    lines after a crash run."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-m",
                             "repro_torch.launch.stream", "--dir", str(d),
                             "--ticks", str(LAUNCHER_TICKS), "--batch",
                             str(batch), *more], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        if proc.returncode:
            raise AssertionError(f"launcher {more} exited {proc.returncode}"
                                 f": {err[-2000:]}")
        lines = out.splitlines()
        if "--crash-at" in more:
            return lines
        i = lines.index("{")
        j = max(k for k, line in enumerate(lines) if line == "}")
        stats = json.loads("\n".join(lines[i:j + 1]))
        processed = stats.pop("processed")
        return stats, processed, lines[j + 1:], lines[:i]
    return result


def launcher_rows(d):
    """Every flushed ``U1`` slate of a closed launcher run, by key."""
    from repro_torch.core.durability import DurabilityConfig
    keys, _, s = DurabilityConfig(dir=str(d)).make_store().scan_rows("U1")
    return {int(k): (int(c), float(x))
            for k, c, x in zip(keys, s["count"], s["sum"])}


def launcher_recovery():
    """Phase 13c's second half: the stream launcher uninterrupted and
    crashed at source tick 40 then recovered, at both batches."""
    import tempfile
    import numpy as np
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        # the uninterrupted and the crash runs side by side, at both
        # batches, then both recoveries
        runs = {(b, run): launcher(Path(d) / f"{run}_{b}", b, *more)
                for b in LAUNCHER_BATCHES
                for run, more in (("full", ()), ("crash", ("--crash-at",
                                                           "40")))}
        runs = {k: wait() for k, wait in runs.items()}
        t_two = time.perf_counter() - t0
        t0 = time.perf_counter()
        recs = {b: launcher(Path(d) / f"crash_{b}", b, "--recover")
                for b in LAUNCHER_BATCHES}
        recs = {b: wait() for b, wait in recs.items()}
        t_rec = time.perf_counter() - t0
        full_rows, rec_rows = (launcher_rows(Path(d) / f"{run}_256")
                               for run in ("full", "crash"))
    log(f"stream launcher (--ticks {LAUNCHER_TICKS}, --batch "
        f"{LAUNCHER_BATCHES}): the uninterrupted and the crash runs side "
        f"by side {t_two:.1f} s wall, the recoveries {t_rec:.1f} s "
        f"(process start included); {runs[64, 'crash'][-1]}; "
        f"{recs[64][3][-1]}")
    full, rec = runs[64, "full"], recs[64]
    if full[0] != rec[0] or full[2] != rec[2] or \
            any(full[0]["table_dropped"].values()):
        raise AssertionError(f"launcher: recovered stats / slates {rec[:3]} "
                             f"differ from the uninterrupted run's "
                             f"{full[:3]}")
    log(f"stream launcher --batch 64: the recovered run printed the "
        f"uninterrupted run's stats (engine tick {full[0]['tick']}, table "
        f"occupancy {full[0]['table_occupancy']}) and slates {full[2]}; "
        f"processed {rec[1]} after recovery (restarted at the frontier) "
        f"against {full[1]}")
    # the default batch: the tick matches, and every key that neither
    # run dropped holds the same slate bitwise in both runs' stores
    full, rec = runs[256, "full"], recs[256]
    from repro_torch.launch.stream import source_fn
    fed = np.zeros(10_000, np.int64)
    for t in range(LAUNCHER_TICKS):
        np.add.at(fed, source_fn(t, None, 256, "cpu")["S1"].key.numpy(), 1)
    short = sorted(k for k in np.flatnonzero(fed).tolist()
                   if full_rows.get(k, (0,))[0] != fed[k]
                   or rec_rows.get(k, (0,))[0] != fed[k])
    differ = sorted(k for k in set(full_rows) | set(rec_rows)
                    if full_rows.get(k) != rec_rows.get(k))
    drops = (full[0]["table_dropped"]["U1"], rec[0]["table_dropped"]["U1"])
    log(f"stream launcher --batch 256 (the default): engine tick "
        f"{full[0]['tick']} uninterrupted, {rec[0]['tick']} recovered; "
        f"table_dropped {drops[0]} uninterrupted, {drops[1]} recovered; "
        f"occupancy {full[0]['table_occupancy']['U1']} against "
        f"{rec[0]['table_occupancy']['U1']}; keys short of the feed's "
        f"count in either run {short}; keys whose slates differ between "
        f"the two runs {differ} (the recovery divergence of ROADMAP queue "
        f"3); the other {len(set(full_rows) - set(differ))} keys' slates "
        f"equal bitwise")
    if full[0]["tick"] != rec[0]["tick"] or not set(differ) <= set(short) \
            or len(short) > sum(drops):
        raise AssertionError("launcher --batch 256: the recovered run "
                             "differs beyond the dropped keys")


def app_serving_path(dev, seed, card):
    """Phase 13c: ``build_serve_app`` serves phase 7's 16 requests
    on qwen2-0.5b through ``App.run``; then the stream launcher crashes
    at source tick 40 and recovers, in subprocesses."""
    import numpy as np
    import torch
    from repro_torch import RuntimeConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.ml import build_serve_app, request_source
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    arch = "qwen2-0.5b"
    cfg, sv = get_config(arch), serve_of(arch)
    n_req = 16
    model, _ = lm.init(lm.build(cfg), torch.Generator(device=dev).manual_seed(
        seed), dtype=torch.bfloat16)
    app = build_serve_app(cfg, model, prompt_len=sv["prompt_len"],
                          max_new=sv["max_new"], cache_len=sv["cache_len"],
                          bucket=sv["bucket"])
    del model
    reqs = serving_requests(sv, seed, sv["draw"], cfg.vocab_size)[:n_req]
    source = request_source(reqs, prompt_len=sv["prompt_len"],
                            capacity=sv["per_tick"], per_tick=sv["per_tick"],
                            device=dev)
    stage = app.build().by_name["lm_generate"]     # the planner's copy
    kernels = (fk.flash_attention, dk.decode_attention, rk.rmsnorm,
               uk.slate_update, lk.slate_lookup)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    fk.flash_attention.launches_by_route = dict.fromkeys(fk.ROUTES, 0)
    stage.microbatches = 0
    reset_lookup_routes()
    with torch_probe_calls() as torch_calls:
        t0 = time.perf_counter()
        app.run(source, n_req // sv["per_tick"], drain=True, device=dev,
                runtime=RuntimeConfig(batch_size=sv["per_tick"]))
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        rows = app.handle.read_slates("requests", [r.rid for r in reqs])
    launches = {k.__name__: k.launches for k in kernels}
    mb, ticks = stage.microbatches, app.stats()["tick"]
    want = {k: n * mb for k, n in serving_launches(arch).items()}
    log(f"front door serving (build_serve_app, App.run): {n_req} requests "
        f"x {sv['max_new']} tokens in {t_run:.3f} s over {ticks} ticks "
        f"({n_req * sv['max_new'] / t_run:.2f} tokens/s), {mb} "
        f"microbatches of {sv['bucket']}; launches "
        f"{launches}, expected {want} and flash_attention all on wgmma "
        f"({fk.flash_attention.launches_by_route}); {card}")
    if {k: launches[k] for k in want} != want or \
            fk.flash_attention.launches_by_route["wgmma"] != \
            want["flash_attention"] or min(launches.values()) <= 0 \
            or mb != ticks * (sv["per_tick"] // sv["bucket"]):
        raise AssertionError(f"front door serving launches {launches}")
    launches["slate_lookup routes"] = check_lookup_routes(
        "front door serving", torch_calls)
    phase7 = SERVED[arch]
    diff = [r.rid for r, row in zip(reqs, rows) if row is None
            or not np.array_equal(row["tokens"].numpy(), phase7[r.rid])]
    if diff:
        raise AssertionError(f"requests {diff}: build_serve_app's slates "
                             f"differ from phase 7's")
    log(f"front door serving: all {n_req} request slates equal phase 7's "
        f"bitwise")
    app.close()
    del app
    torch.cuda.empty_cache()

    launcher_recovery()
    log(f"front door serving and launcher: the phase took "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return launches


def profile_ticks(eng, state, source_fn, start, tick_s, n=8,
                  start_kw="source_offset", ranges=None):
    """Where a tick's time goes: one chunk of ``n`` more ticks under
    torch.profiler — device busy time per tick (sum of kernel and copy
    time), device operations per tick, the kernels that take most of the
    device time, and the port's own kernels of this path by name.  The
    idle share compares the busy time with the unprofiled tick time of
    the main run.  ``start_kw`` names ``eng.run``'s start argument;
    ``ranges``, if given, is a dict that gets the device ms a tick of the
    kernels launched inside each ``record_function`` range the run
    opens.  Returns (busy ms, operations) a tick, or None when the
    profiler recorded no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(state, source_fn, n, **{start_kw: start})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a record_function range also shows on the device as one span over
    # its kernels: count the kernels, not the span
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name not in (ranges or ())]
    if not dev_events:
        log(f"profile of {n} ticks: the profiler recorded no device "
            f"events (device busy time not measured)")
        return None
    busy_us = sum(e.device_time_total for e in dev_events) / n
    ops = len(dev_events) / n
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile of {n} ticks: device busy {busy_us / 1e3:.4f} ms/tick, "
        f"{ops:.1f} device operations/tick, profiled wall "
        f"{wall / n * 1e3:.3f} ms/tick; idle share against the unprofiled "
        f"{tick_s * 1e3:.3f} ms/tick: {1 - busy_us / 1e6 / tick_s:.4f}")
    for name, us in top:
        log(f"  {us / 1e3:.4f} ms/tick  {name[:100]}")
    for kname in ("slate_update_kernel", "slate_lookup", "countmin_kernel"):
        hits = [e.device_time_total for e in dev_events if kname in e.name]
        if hits:
            log(f"  {kname}: {sum(hits) / n / 1e3:.4f} ms/tick over "
                f"{len(hits) / n:.1f} launches a tick, "
                f"{sum(hits) / len(hits) / 1e3:.5f} ms a launch")
    if ranges is not None:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CPU and \
                    e.name in ranges:
                ranges[e.name] += e.device_time_total / n / 1e3
    return busy_us / 1e3, ops


# ---------------------------------------------------------------- phase 14
# The continuous-batching ServingEngine (``repro_torch.launch.serve``) at
# full width with random bf16 weights from --seed: its configuration, the
# requests (prompt lengths uniform in [min_prompt, prompt_len]) and the
# new tokens each.  14a serves phase 7's 16 requests; whisper-tiny
# runs at prompt_bucket == cache_len, the reference's limit.
ENGINE = {
    "qwen2-0.5b": dict(
        serve=dict(n_slots=8, cache_len=320, prompt_bucket=64,
                   admit_per_tick=2, queue_capacity=64),
        requests=16, min_prompt=32, prompt_len=256, max_new=32),
    "whisper-tiny": dict(
        serve=dict(n_slots=8, cache_len=256, prompt_bucket=256,
                   admit_per_tick=2, queue_capacity=64),
        requests=8, min_prompt=32, prompt_len=224, max_new=32),
    "llama-3.2-vision-11b": dict(
        serve=dict(n_slots=8, cache_len=512, prompt_bucket=64,
                   admit_per_tick=2, queue_capacity=64),
        requests=8, min_prompt=32, prompt_len=256, max_new=32),
}
# teacher-forced tolerances: qwen2-0.5b phase 7's; whisper-tiny and
# llama-3.2-vision-11b the plain path's own bf16-vs-f32 distance,
# measured, plus qwen2's rule for the kernels' roundings, 0.125 per 24
# attention sublayers (whisper 12: 4 encoder, 4 decoder self, 4 cross;
# llama 40).  Random weights leave few top-2 margins above that, so
# neither requires a position for the top-1 check (it runs where any is).
# At llama's width the zeroed-cross control clears this tolerance by
# little: the gate for cross attention is per_block's check of each
# cross sublayer's own output.
ENGINE_TF = {
    "qwen2-0.5b": SERVE_ARCHS["qwen2-0.5b"],
    "whisper-tiny": Arch({}, {}, None, 0.125 * 12 / 24, top1=False),
    "llama-3.2-vision-11b": Arch({}, {}, None, 0.125 * 40 / 24,
                                 top1=False),
}
# 14a holds its last requests back and releases them one at a time
# whenever every slot is idle, until an idle slot has decoded at a write
# index past cache_len (a tick decodes idle slots only while some slot is
# active, and an idle slot is refilled while the queue holds requests)
HELD_BACK = 8
# each request's tokens from 14a's engine, read by phase 18c
ENGINE_TOKENS = {}
# 14a against phase 7's tokens: a request may part from them only at a
# step whose top-2 logit margin (the engine's tokens teacher-forced, bf16
# kernels) is below twice phase 7's teacher-forced tolerance: each run
# lies within 0.125 of the plain path
ENGINE_NEAR_TIE = 2 * 0.125
JOURNAL, JOURNAL_REQUESTS, JOURNAL_TICKS = "requests.log", 24, 40


def engine_requests(arch, seed, vocab):
    """The sub-phase's requests (``launch.serve.Request``)."""
    from repro_torch.launch.serve import Request
    ev = ENGINE[arch]
    if arch == "qwen2-0.5b":        # phase 7's requests, same rids
        base = serving_requests(serve_of(arch), seed, SERVE["draw"],
                                vocab)[:ev["requests"]]
    else:
        base = serving_requests(ev, seed + 14, ev["requests"], vocab)
    return [Request(rid=r.rid, prompt=r.prompt, max_new=ev["max_new"])
            for r in base]


def engine_launches(cfg):
    """Launches of each model kernel a prefill and a decode step: one
    attention kernel an attention sublayer (self or cross; whisper's
    encoder runs at prefill only), one ``rmsnorm`` a norm (two a block,
    three a whisper decoder block, the final norm, whisper's encoder
    norm)."""
    if cfg.encdec:
        return ({"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
                 "rmsnorm": 2 * cfg.n_enc_layers + 1 + 3 * cfg.n_layers + 1},
                {"decode_attention": 2 * cfg.n_layers,
                 "rmsnorm": 3 * cfg.n_layers + 1})
    return ({"flash_attention": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1},
            {"decode_attention": cfg.n_layers,
             "rmsnorm": 2 * cfg.n_layers + 1})


def count_calls(eng):
    """Count the engine's model calls (one prefill an admission, one
    decode step a tick with an active slot) and the tokens they emit (one
    a prefill, one an active slot a decode step), by wrapping its steps;
    returns the counts, which grow as it serves."""
    calls = {"prefill": 0, "decode": 0, "tokens": 0}
    prefill, decode = eng._prefill, eng._decode

    def counted_prefill(*a):
        calls["prefill"] += 1
        calls["tokens"] += 1
        return prefill(*a)

    def counted_decode(*a):
        calls["decode"] += 1
        calls["tokens"] += int(eng.active.sum())
        return decode(*a)

    eng._prefill, eng._decode = counted_prefill, counted_decode
    return calls


def profiled_step(eng):
    """One engine tick under torch.profiler: (wall s, device busy ms,
    device operations, the top kernels), or busy None when the profiler
    recorded no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return wall, None, 0, []
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (wall, sum(e.device_time_total for e in ev) / 1e3, len(ev),
            [(n[:80], round(us / 1e3, 4)) for n, us in top])


def drive_engine(eng, calls, reqs, held=(), profile_at=8):
    """Submit ``reqs`` and tick ``eng`` until every request (and each
    ``held`` one, released as ``HELD_BACK`` says) has finished.  The tick
    ``profile_at`` runs under the profiler and is left out of the wall
    time and of the tokens (``calls``, from ``count_calls``) counted over
    the other ticks.  While an idle slot decodes at a write index past
    cache_len (no admission that tick), its state is snapshot before the
    tick and must be bitwise the same after it: the write was dropped."""
    import torch
    from repro_torch.core.event import flatten_sorted
    cache, n = eng.scfg.cache_len, eng.scfg.n_slots

    def leaves():
        return [x for x in flatten_sorted(eng.states)[0] if x is not None]
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.rid} shed")
    held, wall, ticks, tokens = list(held), 0.0, 0, 0
    prof, dropped = None, None
    while eng.queue or eng.active.any() or held:
        if not eng.queue and not eng.active.any():
            for r in (held[:1] if dropped is None else held):
                eng.submit(r)
            held = held[1:] if dropped is None else []
        snap = None
        if held and dropped is None and not eng.queue and eng.active.any():
            cur = eng.cur_index.cpu()
            past = [s for s in range(n)
                    if not eng.active[s] and int(cur[s]) >= cache]
            if past:
                w = past[0]
                snap = (w, int(cur[w]), [x[:, w].clone() for x in
                                         leaves()])
        n0 = calls["tokens"]
        if eng.tick == profile_at:
            prof = (*profiled_step(eng), calls["tokens"] - n0)
        else:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            ticks += 1
            tokens += calls["tokens"] - n0
        if snap is not None:
            w, idx, before = snap
            after = [x[:, w] for x in leaves()]
            if not all(torch.equal(a, b) for a, b in zip(before, after)):
                raise AssertionError(f"idle slot {w}'s write at index {idx} "
                                     f"(cache_len {cache}) changed its state")
            dropped = (eng.tick - 1, w, idx)
    return {"ticks": ticks, "wall": wall, "tokens": tokens, "profile": prof,
            "dropped": dropped}


class EngineReader(Reader):
    """A thread asking the serving engine's status server for
    ``/status``, one request's ``/slate/requests/<rid>`` (in turn) and
    ``/metrics`` while it serves, then a short pause."""

    def __init__(self, port, rids, pause_s=0.2):
        super().__init__(port, pause_s)
        self.rids, self.seen, self.ticks = list(rids), {}, []

    def _loop(self):
        import urllib.error
        i = 0
        while not self._stop.is_set():
            try:
                self.ticks.append(json.loads(self.get("/status"))["tick"])
                rid = self.rids[i % len(self.rids)]
                i += 1
                try:
                    self.seen[rid] = json.loads(
                        self.get(f"/slate/requests/{rid}"))
                except urllib.error.HTTPError as e:
                    if e.code != 404:     # a held-back request: not yet
                        raise
                self.metrics = self.get("/metrics")
                self.rounds += 1
            except Exception as e:         # recorded, raised by check()
                self.errors.append(repr(e))
                return
            self._stop.wait(self.pause_s)


def engine_margins(model, reqs, tokens, dev, chunk=8):
    """Each request's top-2 logit margin at each of its generated tokens:
    a teacher-forced bf16 prefill (kernels) over the prompt and the
    tokens."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.models.context import Ctx
    out = {}
    for i in range(0, len(reqs), chunk):
        part = reqs[i:i + chunk]
        seqs = [np.concatenate([r.prompt, np.asarray(tokens[r.rid][:-1],
                                                      np.int32)])
                for r in part]
        L = max(len(x) for x in seqs)
        toks = np.zeros((len(part), L), np.int32)
        for j, x in enumerate(seqs):
            toks[j, :len(x)] = x
        logits, _ = lm.prefill(model, {"tokens": torch.from_numpy(toks).to(
            dev)}, Ctx(cdtype=torch.bfloat16), L, full_logits=True)
        for j, r in enumerate(part):
            P = len(r.prompt)
            rows = logits[j, P - 1:P - 1 + len(tokens[r.rid])].float()
            top = torch.topk(rows, 2, dim=-1).values
            out[r.rid] = (top[:, 0] - top[:, 1]).cpu().numpy()
        del logits
    return out


def engine_path(dev, seed, card, arch):
    """Phase 14a-c: ``arch`` served by the ``ServingEngine`` on the card;
    returns the launches of the path's kernels in its run."""
    import numpy as np
    import torch
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch.serve import (ServeConfig, ServingEngine,
                                          set_lm_params)
    from repro_torch.models import lm
    from repro_torch.models.context import Ctx

    t_phase = time.perf_counter()
    cfg, ev = get_config(arch), ENGINE[arch]
    t0 = time.perf_counter()
    model, _ = lm.init(lm.build(cfg), torch.Generator(device=dev).manual_seed(
        seed), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"engine {arch} at full width ({describe(cfg, {})}); {n_params} "
        f"parameters (config count {cfg.param_count()}) drawn on the card "
        f"in bf16 in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng = ServingEngine(cfg, ServeConfig(**ev["serve"]), device=dev)
    params = set_lm_params(eng, model)
    del model
    reqs = engine_requests(arch, seed, cfg.vocab_size)
    held = reqs[-HELD_BACK:] if arch == "qwen2-0.5b" else []
    kernels = (fk.flash_attention, dk.decode_attention, rk.rmsnorm,
               sk.ssd_scan, uk.slate_update, lk.slate_lookup)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for k in (fk.flash_attention, rk.rmsnorm):
        k.launches_by_route = dict.fromkeys(k.launches_by_route, 0)
    server = reader = None
    if arch == "qwen2-0.5b":
        server = eng.status_server(0)
        reader = EngineReader(server.port, [r.rid for r in reqs])
        reader.start()
    calls = count_calls(eng)
    try:
        run = drive_engine(eng, calls, reqs[:len(reqs) - len(held)], held)
    finally:
        if reader is not None:
            reader.stop()
    launches = {k.__name__: k.launches for k in kernels if k.launches}
    routes = {k.__name__: dict(k.launches_by_route)
              for k in (fk.flash_attention, rk.rmsnorm)}
    gib = torch.cuda.memory_allocated() / 2**30
    per_prefill, per_decode = engine_launches(cfg)
    stats = eng.stats()
    n_tok = stats["tokens_generated"]
    want = {}
    for per, n in ((per_prefill, calls["prefill"]),
                   (per_decode, calls["decode"])):
        for k, m in per.items():
            want[k] = want.get(k, 0) + m * n
    log(f"engine {arch}: {calls['prefill']} prefills and {calls['decode']} "
        f"decode steps in {eng.tick} ticks; launches {launches}, expected "
        f"{want} (a prefill {per_prefill}, a decode step {per_decode}); "
        f"routes {routes}")
    if launches != want or routes["flash_attention"]["wgmma"] != \
            want["flash_attention"] or calls["prefill"] != len(reqs) or \
            calls["tokens"] != n_tok:
        raise AssertionError(f"engine {arch}: launches {launches}, "
                             f"expected {want}, routes {routes}, calls "
                             f"{calls}, tokens {n_tok}")
    done = {r.rid: r for r in eng.finished}
    ENGINE_TOKENS[arch] = {rid: list(r.tokens_out) for rid, r in done.items()}
    if sorted(done) != sorted(r.rid for r in reqs) or any(
            len(r.tokens_out) != ev["max_new"] for r in eng.finished) \
            or stats["shed"] or stats["queued"] or stats["active"]:
        raise AssertionError(f"engine {arch}: stats {stats}")
    tick_s = run["wall"] / run["ticks"]
    wall, busy, ops, top, prof_tok = run["profile"]
    idle = None if busy is None else 1 - busy / 1e3 / wall
    log(f"engine {arch} end to end: {len(reqs)} requests (prompts "
        f"{ev['min_prompt']}-{ev['prompt_len']}, bucket "
        f"{ev['serve']['prompt_bucket']}, cache {ev['serve']['cache_len']}, "
        f"{ev['serve']['n_slots']} slots) x {ev['max_new']} tokens in "
        f"{eng.tick} ticks: {tick_s * 1e3:.3f} ms/tick and "
        f"{run['tokens'] / run['wall']:.2f} generated tokens/s over the "
        f"{run['ticks']} unprofiled ticks ({run['tokens']} of the "
        f"{n_tok} tokens); the profiled tick (the 9th, {prof_tok} tokens): "
        f"wall {wall * 1e3:.3f} ms under the profiler, device busy {busy} "
        f"ms, {ops} device operations, idle share of that tick {idle}; "
        f"top {top}; {gib:.2f} GiB allocated; mean latency "
        f"{stats['mean_latency_ticks']} ticks; {card}")
    if reader is not None:
        reader.check()
        final = {r.rid: json.loads(reader.get(f"/slate/requests/{r.rid}"))
                 for r in reqs}
        status = json.loads(reader.get("/status"))
        server.close()
        bad = [rid for rid, got in final.items()
               if got != {"tokens_out": done[rid].tokens_out, "done": True}]
        seen_live = sum(not v["done"] for v in reader.seen.values())
        if bad or status["finished"] != len(reqs) or not reader.rounds \
                or "finished" not in reader.metrics:
            raise AssertionError(f"status server: requests {bad}, status "
                                 f"{status}, {reader.rounds} rounds")
        log(f"status server while serving: {reader.rounds} rounds of "
            f"/status, /slate/requests/<rid> and /metrics at ticks "
            f"{reader.ticks[:3]}...{reader.ticks[-3:]}, {seen_live} reads "
            f"of a request in flight; after the run every "
            f"/slate/requests/<rid> equals its tokens; /status {status}")
    if arch == "qwen2-0.5b":
        if run["dropped"] is None:
            raise AssertionError("no idle slot decoded past cache_len")
        t, w, idx = run["dropped"]
        log(f"engine {arch}: at tick {t} idle slot {w} decoded at write "
            f"index {idx} (cache_len {ev['serve']['cache_len']}): no fault, "
            f"its state bitwise unchanged (the write dropped); "
            f"cur_index at the end {eng.cur_index.tolist()}")
        tokens = {rid: r.tokens_out for rid, r in done.items()}
        phase7 = SERVED[arch]
        parts = [r for r in reqs
                 if not np.array_equal(tokens[r.rid], phase7[r.rid])]
        margins = engine_margins(params, parts, tokens, dev)
        at = {}                 # rid -> (first differing step, its margin)
        for r in parts:
            first = int(np.argmax(np.asarray(tokens[r.rid])
                                  != phase7[r.rid]))
            at[r.rid] = (first, float(margins[r.rid][first]))
            if not at[r.rid][1] < ENGINE_NEAR_TIE:
                raise AssertionError(
                    f"request {r.rid}: the engine's tokens part from phase "
                    f"7's at step {first}, top-2 margin {at[r.rid][1]} "
                    f"(near-tie below {ENGINE_NEAR_TIE})")
        log(f"engine {arch} against phase 7 (and phase 13c, bitwise equal "
            f"to it): {len(reqs) - len(parts)} of {len(reqs)} requests "
            f"token for token; {len(parts)} part at a near-tie (rid: "
            f"(step, top-2 margin) {at}, below {ENGINE_NEAR_TIE})")
    # teacher forcing with random memories: the engine feeds zeros, which
    # null cross-attention
    sv = dict(prompt_len=256, bucket=8, cache_len=ev["serve"]["cache_len"])
    mapper = SimpleNamespace(model=params, ctx=Ctx(cdtype=torch.bfloat16),
                             cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    aux = {}
    if cfg.encdec:
        aux["enc_frames"] = torch.randn(
            (sv["bucket"], sv["prompt_len"], cfg.d_model), generator=gen,
            device=dev)
    if cfg.cross_attn_every:
        aux["image_embeds"] = torch.randn(
            (sv["bucket"], cfg.n_image_tokens, cfg.d_model), generator=gen,
            device=dev)
    del eng
    torch.cuda.empty_cache()
    tf = teacher_forced(sv, mapper, reqs, dev, ENGINE_TF[arch], aux)
    log(f"engine {arch} teacher-forced, one microbatch of 8"
        f"{' with random memories' if aux else ''}, kernels vs plain "
        f"versions: {tf}")
    torch.cuda.empty_cache()
    pb = per_block(sv, mapper, reqs, dev, aux)
    log(f"engine {arch} teacher-forced block by block: {pb}")
    del mapper, params, aux
    torch.cuda.empty_cache()
    log(f"engine {arch}: the phase took {time.perf_counter() - t_phase:.1f}"
        f" s wall")
    return launches


def serve_child(d, seed, dev=None):
    """Phase 14d's crash run (``--serve-child DIR``, a process of its
    own): qwen2-0.5b served with a journal in ``DIR``; after
    ``JOURNAL_TICKS`` ticks it writes the accepted and finished rids to
    ``DIR/child.json`` and kills itself with SIGKILL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (ServeConfig, ServingEngine,
                                          set_lm_params)
    from repro_torch.models import lm
    dev = dev or torch.device("cuda", 0)
    cfg = get_config("qwen2-0.5b")
    model, _ = lm.init(lm.build(cfg), torch.Generator(device=dev).manual_seed(
        seed), dtype=torch.bfloat16)
    eng = ServingEngine(cfg, ServeConfig(**ENGINE["qwen2-0.5b"]["serve"]),
                        journal=str(Path(d) / JOURNAL), device=dev)
    set_lm_params(eng, model)
    reqs = engine_requests("qwen2-0.5b", seed,
                           cfg.vocab_size)[:JOURNAL_REQUESTS]
    accepted = [r.rid for r in reqs if eng.submit(r)]
    eng.run(JOURNAL_TICKS)
    with open(Path(d) / "child.json", "w") as f:
        json.dump({"accepted": accepted,
                   "finished": [r.rid for r in eng.finished]}, f)
    import os
    import signal
    os.kill(os.getpid(), signal.SIGKILL)


def serve_recover(d, seed, dev=None):
    """Phase 14d's recovery (``--serve-recover DIR``, a fresh process): a
    new engine on the crashed run's journal recovers the accepted but
    unfinished requests, resubmits them, serves them to the end and
    writes what it saw to ``DIR/recovered.json``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (ServeConfig, ServingEngine,
                                          set_lm_params)
    from repro_torch.models import lm
    dev = dev or torch.device("cuda", 0)
    cfg = get_config("qwen2-0.5b")
    model, _ = lm.init(lm.build(cfg), torch.Generator(device=dev).manual_seed(
        seed), dtype=torch.bfloat16)
    eng = ServingEngine(cfg, ServeConfig(**ENGINE["qwen2-0.5b"]["serve"]),
                        journal=str(Path(d) / JOURNAL), device=dev)
    set_lm_params(eng, model)
    t0 = time.perf_counter()
    pending = eng.recover_requests()
    t_replay = time.perf_counter() - t0
    shed = [r.rid for r in pending if not eng.submit(r, journal=False)]
    while eng.queue or eng.active.any():
        eng.step()
    out = {"pending": [r.rid for r in pending], "shed": shed,
           "journal_max_rid": eng.journal_max_rid, "replay_s": t_replay,
           "finished": {str(r.rid): len(r.tokens_out) for r in eng.finished},
           "again": [r.rid for r in eng.recover_requests()]}
    eng.journal.close()
    with open(Path(d) / "recovered.json", "w") as f:
        json.dump(out, f)


def engine_journal(seed, card):
    """Phase 14d: the request journal through a crash.  A child serving
    qwen2-0.5b is killed by SIGKILL mid-run; a fresh process recovers
    exactly the accepted-but-unfinished requests and finishes each."""
    import signal
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        child = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-child",
             d, "--seed", str(seed)], capture_output=True, text=True,
            timeout=600)
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(
                f"the serving child ended with {child.returncode}, not "
                f"SIGKILL: {child.stdout[-2000:]} {child.stderr[-4000:]}")
        t_crash = time.perf_counter() - t0
        seen = json.loads((Path(d) / "child.json").read_text())
        nbytes = (Path(d) / JOURNAL).stat().st_size
        t0 = time.perf_counter()
        rec = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-recover",
             d, "--seed", str(seed)], capture_output=True, text=True,
            timeout=600)
        if rec.returncode != 0:
            raise AssertionError(f"the recovery ended with {rec.returncode}:"
                                 f" {rec.stdout[-2000:]} {rec.stderr[-4000:]}")
        t_rec = time.perf_counter() - t0
        got = json.loads((Path(d) / "recovered.json").read_text())
    owed = sorted(set(seen["accepted"]) - set(seen["finished"]))
    ok = (got["pending"] == owed and not got["shed"] and got["again"] == []
          and sorted(int(k) for k in got["finished"]) == owed
          and all(n == ENGINE["qwen2-0.5b"]["max_new"]
                  for n in got["finished"].values())
          and got["journal_max_rid"] == max(seen["accepted"])
          and 0 < len(seen["finished"]) < len(seen["accepted"]))
    log(f"engine journal: a child served qwen2-0.5b for {JOURNAL_TICKS} "
        f"ticks ({len(seen['accepted'])} accepted, "
        f"{len(seen['finished'])} finished, journal {nbytes} bytes) and was "
        f"killed by SIGKILL ({t_crash:.1f} s wall with process start); a "
        f"fresh process recovered {len(got['pending'])} requests "
        f"{got['pending']} (replay {got['replay_s']:.4f} s; owed {owed}), "
        f"resubmitted and finished each with "
        f"{sorted(set(got['finished'].values()))} tokens; a second "
        f"recovery found {got['again']} ({t_rec:.1f} s wall); {card}")
    if not ok:
        raise AssertionError(f"engine journal: child {seen}, recovery {got}")


# ---------------------------------------------------------------- phase 15
# The multi-shard engine (``repro_torch.core.distributed``), 8 shards on
# the one card.  Sizing (PERF.md section 4, checked on the CPU with the
# port's ring): Zipf(1.2)'s top key is ~19 % of the feed, so the shard
# that owns it at M1 receives up to ~16,300 of a tick's 65,536 events,
# an updater shard up to ~20,100, and one (source, destination) bucket up
# to ~13,100 (the top key's events from M1's hot shard): batch_size
# 32,768 a shard and exchange_slack 4.0 (cap_per_dest 16,384).
SHARDS = 8
SHARD_C = C // SHARDS            # 2**19 slots an updater a shard
SHARD_B = 32768
SHARD_SLACK = 4.0
HOT_TICKS, HOT_SPLIT_AT = 64, 16
# 15a's ms/tick and profile (busy ms, operations), and its engine, its
# state (a copy on the card) and its launches after its first RANK_TICKS
# ticks: phase 19's reference
SHARDED_AT = {}
RANK_TICKS = 16
FAILOVER = {"capacity": 1 << 14, "events": 4096, "ticks": 16,
            "fail_at": 8, "batch": 2048, "slack": 8.0}


def shard_rows(batch, n=SHARDS):
    """A ``[B]`` batch as ``[n, B / n]``: shard s takes events s*B/n to
    (s+1)*B/n - 1 of the tick."""
    from repro_torch.core.event import tree_map
    return tree_map(lambda a: a.reshape((n, -1) + tuple(a.shape[1:])),
                    batch)


def sharded_source(source_fn):
    """A single-shard ``source_fn`` as the ``[8, B / 8]`` feed of the
    multi-shard engine: the same events each tick."""
    return lambda t, mx: {s: shard_rows(b)
                          for s, b in source_fn(t, None).items()}


def sharded_engine(dev, capacity=None, batch=None, slack=None, shards=None,
                   group=None, **cfg):
    """Phase 5's workflow on 8 shards (default: 15a's sizes); over the
    ranks of ``group`` when one is given (phase 19)."""
    from repro_torch.core.distributed import (DistConfig, DistributedEngine,
                                              make_mesh)
    capacity, batch = capacity or SHARD_C, batch or SHARD_B
    slack = slack or SHARD_SLACK
    return DistributedEngine(
        build_workflow(capacity), make_mesh((shards or SHARDS,), ("data",),
                                            group=group),
        DistConfig(**{**dict(batch_size=batch, queue_capacity=4 * batch,
                             chunk_size=8, exchange_slack=slack), **cfg}),
        device=dev)


def flat_tables(state):
    """The stacked tables as one table over all shards' rows (sink rows
    dropped), for ``check_slates``."""
    from types import SimpleNamespace
    return {"tables": {
        name: SimpleNamespace(
            keys=t.keys[:, :-1].reshape(-1),
            vals={"v": t.vals["v"][:, :-1].reshape(-1, D)})
        for name, t in state["tables"].items()}}


def sharded_stats(eng, state):
    """The engine's stats and the table drops ``check_slates`` reads."""
    stats = eng.stats(state)
    stats["table_dropped"] = {k: int(t.dropped.sum())
                              for k, t in state["tables"].items()}
    return stats


def merged_rows(state, name, combine):
    """{key: slate row} over every shard, a key's partials (a split key's
    two rows) merged with ``combine`` (numpy)."""
    keys = state["tables"][name].keys[:, :-1].reshape(-1).cpu().numpy()
    vals = state["tables"][name].vals["v"][:, :-1].reshape(-1, D) \
        .cpu().numpy()
    rows = {}
    for i in (keys != -1).nonzero()[0]:
        k = int(keys[i])
        rows[k] = vals[i] if k not in rows else combine(rows[k], vals[i])
    return rows


def sharded_launch_counts():
    from repro_torch.kernels.countmin import kernel as ck
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    return uk, lk, ck, hk


def reset_launches():
    uk, lk, ck, hk = sharded_launch_counts()
    for k in (uk.slate_update, lk.slate_lookup, ck.countmin_update,
              hk.histogram_update):
        k.launches = 0
    for k in (ck.countmin_update, hk.histogram_update):
        k.launches_by_route = dict.fromkeys(k.launches_by_route, 0)
    reset_lookup_routes()


def check_sharded_no_host_sync(dev, seed, group=None):
    """A chunk of 3 ticks of the sharded engine under the sync debug mode
    "error": telemetry off, and on with a split key in the hot set; over
    ``group``'s ranks when given (phase 19: the collectives inside)."""
    import torch
    from repro_torch.telemetry import TelemetryConfig
    for tel in (None, TelemetryConfig()):
        kw = {} if tel is None else dict(telemetry=tel, hot_key_capacity=8)
        eng = sharded_engine(dev, capacity=1 << 16, batch=4096, group=group,
                             **kw)
        state = eng.init_state()
        if tel is not None:
            state, _ = eng.split_keys(state, [0, 1])
        source_fn, _ = make_source(zipf_cdf(dev), 4096, seed + 9)
        src = sharded_source(source_fn)
        from repro_torch.core.engine import stack_sources
        stacked = stack_sources([src(t, None) for t in range(3)])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _, info = eng.run_chunk(state, stacked)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log(f"sharded run_chunk of 3 ticks x {SHARDS} shards"
            f"{'' if group is None else ' over a process group'}, telemetry "
            f"{'off' if tel is None else 'on, keys 0 and 1 split'}, under "
            f"sync debug mode 'error': no host sync (throttle trace "
            f"{info['throttle_hits'].sum(dim=1).tolist()})")


def sharded_sizing(dev, seed, ticks, cap, batch, n_shards=SHARDS):
    """15a's sizing on its own feed (the engine not involved): per tick,
    route the events to M1's shards through the ring of ``n_shards``,
    then each M1 shard's events to U1's and U2's shards (M1 passes them
    on whole).  Returns the largest (source, destination) bucket and the
    most events a shard receives, over both hops and all ticks; raises
    unless the buckets fit ``cap`` and the receipts ``batch``."""
    import torch
    from repro_torch.core.distributed import _salt
    from repro_torch.core.hashing import HashRing, route
    source_fn, _ = make_source(zipf_cdf(dev), B, seed)
    n = n_shards
    rh, rs = HashRing(n).table(dev)
    src = torch.arange(n, device=dev)[:, None]
    worst = {"bucket": 0, "receipt": 0}
    for t in range(ticks):
        keys = shard_rows(source_fn(t, None)["S1"], n).key
        d1 = route(keys, _salt("M1"), rh, rs).long()
        pairs = [src * n + d1]
        for u in ("U1", "U2"):
            pairs.append(d1 * n + route(keys, _salt(u), rh, rs))
        for p in pairs:
            c = torch.bincount(p.reshape(-1), minlength=n * n)
            worst["bucket"] = max(worst["bucket"], int(c.max()))
            worst["receipt"] = max(worst["receipt"], int(
                c.reshape(n, n).sum(0).max()))
    if worst["bucket"] > cap or worst["receipt"] > batch:
        raise AssertionError(f"sharded sizing: {worst} against cap {cap}, "
                             f"batch {batch}")
    log(f"sharded sizing on {n} shards over {ticks} ticks of the feed: "
        f"largest (source, destination) bucket {worst['bucket']} of "
        f"cap_per_dest {cap}, most events a shard receives "
        f"{worst['receipt']} of batch_size {batch}")
    return worst


def check_sharded_launches(what, launches, ticks, reads, telemetry=False):
    """Exact launches: a tick runs each of the 2 updaters on each shard —
    one ``slate_update``, ``INSERT_ROUNDS`` ``find`` walks (and with
    telemetry one count and one histogram launch, on their fused routes);
    ``reads`` lookups on ``keys``, none on ``cand``."""
    from repro_torch.slates.table import INSERT_ROUNDS
    per = 2 * SHARDS
    want = {"slate_update": per * ticks,
            "find": per * INSERT_ROUNDS * ticks, "keys": reads, "cand": 0}
    got = {"slate_update": launches["slate_update"],
           **launches["slate_lookup routes"]}
    if telemetry:
        want.update(countmin_update=per * ticks,
                    histogram_update=per * ticks)
        got.update(countmin_update=launches["countmin_update"],
                   histogram_update=launches["histogram_update"])
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want} "
                             f"({ticks} ticks x {SHARDS} shards)")
    log(f"{what}: launches exact, {got} over {ticks} ticks x {SHARDS} "
        f"shards ({per} updater runs a tick)")


def sharded_path(dev, ticks, seed, card, ref, phase5):
    """Phase 15a: phase 5's workflow and feed on 8 shards (2**19 slots an
    updater a shard, sources [8, 8,192]) through ``DistributedEngine.run``
    in chunks of 8; the checks and prints of the module docstring.
    ``phase5``: (ms/tick, (busy ms, operations)) of phase 5 in this run.
    Returns the launches of the path's kernels."""
    import numpy as np
    import torch
    from repro_torch.core import distributed as dist

    t_phase = time.perf_counter()
    uk, lk, _, _ = sharded_launch_counts()
    eng = sharded_engine(dev)
    sharded_sizing(dev, seed, ticks, eng.cap_per_dest, SHARD_B)
    source_fn, _ = make_source(zipf_cdf(dev), B, seed)
    src = sharded_source(source_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    state = eng.init_state()
    reset_launches()
    with torch_probe_calls() as torch_calls:
        # two spans, RANK_TICKS and the rest: between them (off the
        # clock) phase 19's reference is kept
        split = min(RANK_TICKS, ticks)
        t0 = time.perf_counter()
        state, _ = eng.run(state, src, split)
        torch.cuda.synchronize()
        t_split = time.perf_counter() - t0
        from repro_torch.core.event import tree_map
        SHARDED_AT.update(eng=eng, at=split, state=tree_map(torch.clone,
                                                            state),
                          tick_s_at=t_split / split, launches_at={
                              "slate_update": uk.slate_update.launches,
                              **lk.slate_lookup.launches_by_route})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = eng.run(state, src, ticks - split, start_tick=split)
        torch.cuda.synchronize()
        t_run = t_split + time.perf_counter() - t0
        state, drained = eng.drain(state)
        read_keys = read_set(seed)
        reads = {u: eng.read_slates(state, u, read_keys)
                 for u in ("U1", "U2")}
        singles = [int(k) for k in read_keys[[0, 1, 7, Q // 2, -1]]]
        single = {k: (eng.read_slate(state, "U1", k),
                      eng.read_slate(state, "U2", k)) for k in singles}
    torch.cuda.synchronize()
    kept = tree_bytes(SHARDED_AT["state"])     # phase 19's copy
    gib = (torch.cuda.memory_allocated() - mem0 - kept) / 2**30
    peak = (torch.cuda.max_memory_allocated() - mem0 - kept) / 2**30
    launches = {"slate_update": uk.slate_update.launches,
                "slate_lookup": lk.slate_lookup.launches}
    launches["slate_lookup routes"] = check_lookup_routes("sharded",
                                                          torch_calls)
    check_sharded_launches("sharded path", launches, ticks + drained,
                           2 * SHARDS + 2 * len(singles))
    stats = sharded_stats(eng, state)
    tick_s = t_run / ticks
    log(f"sharded, {SHARDS} shards on one card: {ticks} ticks x {B} events "
        f"in {t_run:.3f} s = {tick_s * 1e3:.3f} ms/tick, "
        f"{ticks * B / t_run:.4e} events/s, against phase 5's "
        f"{phase5[0] * 1e3:.3f} ms/tick ({tick_s / phase5[0]:.4f}x); drain "
        f"{drained} ticks; state and buffers {gib:.3f} GiB allocated, "
        f"peak {peak:.3f} GiB; {card}")
    log(f"sharded stats: processed={stats['processed']} exchange_dropped="
        f"{stats['exchange_dropped']} queue_dropped={stats['queue_dropped']}"
        f" table_occupancy={stats['table_occupancy']} table_dropped="
        f"{stats['table_dropped']}; per-shard occupancy U1 "
        f"{state['tables']['U1'].occupancy().tolist()}")
    if stats["exchange_dropped"]:
        raise AssertionError(f"sharded: the exchange dropped "
                             f"{stats['exchange_dropped']} events")
    check_slates(flat_tables(state), stats, ref, read_keys, reads, ticks,
                 "sharded")
    counts, sums, maxes = ref
    for k, (a, b) in single.items():
        for name, row, want in (("U1", a, sums), ("U2", b, maxes)):
            if (row is None) != (counts[k] == 0) or (row is not None and
                    not np.array_equal(row["v"].numpy(),
                                       want[k].astype(np.float32))):
                raise AssertionError(f"sharded read_slate {name} {k}")

    # where the time goes: one profiled chunk, the exchange as a range
    ranges = {"exchange": 0.0}
    real = dist.exchange

    def annotated(*a, **kw):
        with torch.profiler.record_function("exchange"):
            return real(*a, **kw)

    dist.exchange = annotated
    try:
        prof = profile_ticks(eng, state, src, ticks, tick_s,
                             start_kw="start_tick", ranges=ranges)
    finally:
        dist.exchange = real
    SHARDED_AT.update(tick_s=tick_s, prof=prof)
    if prof and phase5[1]:
        log(f"sharded tick, profiled: {prof[1]:.1f} device operations and "
            f"{prof[0]:.4f} ms busy a tick against phase 5's "
            f"{phase5[1][1]:.1f} and {phase5[1][0]:.4f} "
            f"({prof[1] / phase5[1][1]:.3f}x operations); the exchange "
            f"{ranges['exchange']:.4f} ms a tick, "
            f"{ranges['exchange'] / prof[0]:.4f} of the busy time; {card}")
    # the exchange alone at the tick's widest hop (M1's [8, 32,768]
    # emitted batches to U1)
    from repro_torch.core.event import tree_map
    emitted = shard_rows(source_fn(0, None)["S1"])
    wide = tree_map(lambda a: torch.cat([a, a.new_zeros(
        (SHARDS, SHARD_B - a.shape[1]) + tuple(a.shape[2:]))], 1), emitted)
    rh, rs = eng.ring.table(dev)
    dest = dist.route(wide.key, dist._salt("U1"), rh, rs)
    ex_ms = device_ms(lambda: dist.exchange(wide, dest, SHARDS,
                                            eng.cap_per_dest))
    log(f"exchange alone, [{SHARDS}, {SHARD_B}] -> [{SHARDS}, "
        f"{SHARDS * eng.cap_per_dest}]: {ex_ms:.5f} ms device time; "
        f"{card}")
    log(f"sharded path: the phase took {time.perf_counter() - t_phase:.1f} "
        f"s wall; {card}")
    del eng, state
    return launches


def sharded_hot_path(dev, seed, card):
    """Phase 15b: the feed of 15a with telemetry on (each shard's sketch
    and histograms on the count kernel) and ``hot_key_capacity=8``; after
    16 ticks the sketch's top 2 keys are split, then 48 more ticks."""
    import numpy as np
    import torch
    from repro_torch.telemetry import TelemetryConfig

    t_phase = time.perf_counter()
    uk, lk, ck, hk = sharded_launch_counts()
    eng = sharded_engine(dev, telemetry=TelemetryConfig(),
                         hot_key_capacity=8)
    source_fn, gen_tick = make_source(zipf_cdf(dev), B, seed)
    src = sharded_source(source_fn)
    ref = reference(gen_tick, HOT_TICKS)
    state = eng.init_state()
    reset_launches()
    with torch_probe_calls() as torch_calls:
        t0 = time.perf_counter()
        state, _ = eng.run(state, src, HOT_SPLIT_AT)
        top = [k for k, _, _ in eng.telemetry.last.heavy_hitters[:2]]
        state, _ = eng.split_keys(state, top)
        state, _ = eng.run(state, src, HOT_TICKS - HOT_SPLIT_AT,
                           start_tick=HOT_SPLIT_AT)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        state, drained = eng.drain(state)
        reads = {k: (eng.read_slate(state, "U1", k),
                     eng.read_slate(state, "U2", k)) for k in top}
    launches = {"slate_update": uk.slate_update.launches,
                "slate_lookup": lk.slate_lookup.launches,
                "countmin_update": ck.countmin_update.launches,
                "histogram_update": hk.histogram_update.launches}
    launches["slate_lookup routes"] = check_lookup_routes("sharded hot",
                                                          torch_calls)
    # a split key's read walks its primary and secondary shard
    check_sharded_launches("sharded hot path", launches,
                           HOT_TICKS + drained, 2 * 2 * len(top),
                           telemetry=True)
    for k, route in (("countmin_update", "keys"),
                     ("histogram_update", "ages")):
        kern = ck.countmin_update if k == "countmin_update" \
            else hk.histogram_update
        if kern.launches_by_route[route] != launches[k]:
            raise AssertionError(f"{k} missed its fused route: "
                                 f"{kern.launches_by_route}")
    hh = eng.telemetry.last.heavy_hitters
    if eng.split_key_set() != top or len(top) != 2:
        raise AssertionError(f"split set {eng.split_key_set()}, top "
                             f"heavy hitters {top}")
    stats = sharded_stats(eng, state)
    if stats["exchange_dropped"] or any(stats["queue_dropped"].values()) \
            or any(stats["table_dropped"].values()):
        raise AssertionError(f"sharded hot: drops {stats}")
    if stats["processed"] != {"M1": HOT_TICKS * B, "U1": HOT_TICKS * B,
                              "U2": HOT_TICKS * B}:
        raise AssertionError(f"sharded hot: processed {stats['processed']}")
    counts, sums, maxes = ref
    from repro_torch.core.distributed import _salt
    from repro_torch.core.hashing import route, route_secondary
    rh, rs = eng.ring.table()
    for k in top:
        kk = torch.tensor([k], dtype=torch.int32)
        homes = {int(route(kk, _salt("U1"), rh, rs)[0]),
                 int(route_secondary(kk, _salt("U1"), rh, rs)[0])}
        held = [s for s in range(SHARDS) if bool(
            (state["tables"]["U1"].keys[s, :-1] == k).any())]
        a, b = reads[k]
        if sorted(held) != sorted(homes) or len(held) != 2 or \
                not np.array_equal(a["v"].numpy(),
                                   sums[k].astype(np.float32)) or \
                not np.array_equal(b["v"].numpy(),
                                   maxes[k].astype(np.float32)):
            raise AssertionError(f"split key {k}: held on shards {held} "
                                 f"(ring homes {homes}); read {a}, {b}")
    for name, want, comb in (("U1", sums, np.add), ("U2", maxes,
                                                    np.maximum)):
        rows = merged_rows(state, name, comb)
        ks = np.fromiter(rows, np.int64, len(rows))
        vals = np.stack([rows[int(k)] for k in ks])
        fed = np.flatnonzero(counts)
        if not (np.array_equal(np.sort(ks), fed) and
                np.array_equal(vals, want[ks].astype(np.float32))):
            raise AssertionError(f"sharded hot {name}: merged slates differ "
                                 "from the reference")
    log(f"sharded heavy hitters at tick {HOT_SPLIT_AT} (key, estimate, "
        f"share): {hh[:4]}; key 0, the feed's top key, "
        f"{'is' if 0 in [k for k, _, _ in hh] else 'is not'} among the "
        f"sketch's candidates (each shard samples the first rows of its "
        f"dequeued batch)")
    log(f"sharded hot keys: telemetry on, top keys {top} split after "
        f"{HOT_SPLIT_AT} ticks, each held on its 2 ring shards, read_slate "
        f"merges the partials to the reference; all {len(rows)} merged "
        f"slates of each updater equal the reference; {HOT_TICKS} ticks in "
        f"{t_run:.3f} s = {t_run / HOT_TICKS * 1e3:.3f} ms/tick; the phase "
        f"took {time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


def failover_source(device, n=None, seed0=7_000, eng=None):
    """15c's feed, from numpy so the card and the CPU see the same
    events: ``n`` (default 4,096) Zipf(1.2) ranks below 2**20 a tick,
    as ``[8, n / 8]`` (or ``eng``'s live shard count)."""
    import numpy as np
    import torch
    from repro_torch.core.event import EventBatch
    n = n or FAILOVER["events"]

    def fn(t, _mx):
        rng = np.random.default_rng(seed0 + t)
        key = np.minimum(rng.zipf(ZIPF_ALPHA, n) - 1, N_KEYS - 1)
        v = rng.integers(0, 8, (n, D)).astype(np.float32)
        v[:, 0] = 1
        t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return {"S1": shard_rows(EventBatch(
            sid=t_(np.zeros(n, np.int32)), ts=t_(np.full(n, t, np.int32)),
            key=t_(key.astype(np.int32)), value={"v": t_(v)},
            valid=t_(np.ones(n, bool))), eng.n_shards if eng else SHARDS)}
    return fn


def failover_run(device):
    f = FAILOVER
    eng = sharded_engine(device, capacity=f["capacity"], batch=f["batch"],
                         slack=f["slack"])
    src = failover_source(device)
    state, _ = eng.run(eng.init_state(), src, f["fail_at"])
    state = eng.fail_shard(state, 3)
    state, _ = eng.run(state, src, f["ticks"] - f["fail_at"],
                       start_tick=f["fail_at"])
    state, _ = eng.drain(state)
    return eng, state


def same_arrays(a, b, what):
    """Two numpy trees (``convert.state_to_numpy``) bitwise equal."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{what}: keys {set(a) ^ set(b)}")
        for k in a:
            same_arrays(a[k], b[k], f"{what}.{k}")
    elif not (a.dtype == b.dtype and a.shape == b.shape
              and a.tobytes() == b.tobytes()):
        raise AssertionError(f"{what} differs")


def sharded_failover(dev, seed, card):
    """Phase 15c: shard 3 fails at tick 8 of a reduced run (2**14 slots
    a shard, 4,096 events a tick, 16 ticks); the card's state and stats
    must equal the same run of the port on the CPU, bitwise."""
    import torch
    from repro_torch import convert
    t0 = time.perf_counter()
    eng, state = failover_run(dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    with cpu_threads() as n_cpu:
        t0 = time.perf_counter()
        eng_cpu, state_cpu = failover_run(torch.device("cpu"))
        t_cpu = time.perf_counter() - t0
    same_arrays(convert.state_to_numpy(state),
                convert.state_to_numpy(state_cpu), "fail-over card vs CPU: "
                "state")
    if eng.stats(state) != eng_cpu.stats(state_cpu):
        raise AssertionError("fail-over: stats differ card vs CPU")
    occ = state["tables"]["U1"].occupancy().tolist()
    if occ[3] != 0 or eng.active_shards != [0, 1, 2, 4, 5, 6, 7]:
        raise AssertionError(f"fail-over: shard 3 still holds slates {occ}")
    log(f"sharded fail-over: shard 3 failed at tick {FAILOVER['fail_at']} "
        f"of {FAILOVER['ticks']}; state and stats bitwise equal to the CPU "
        f"run ({eng.stats(state)['processed']}, occupancy U1 {occ}); card "
        f"{t_card:.2f} s, CPU {t_cpu:.2f} s on {n_cpu} torch threads; "
        f"{card}")


def sharded_durable_config(d):
    """15d: phase 12's durable engine as 8 shards (a WAL a shard)."""
    from repro_torch.core.durability import DurabilityConfig
    from repro_torch.slates.flush import FlushConfig
    return dict(key_dtype="int64", durability=DurabilityConfig(
        dir=d, flush=FlushConfig(), barrier=True, replicas=3,
        write_quorum=2, read_quorum=2))


def sharded_durable_child(d, seed, dev=None):
    """15d's crash run (``--sharded-durable-child DIR``, a process of its
    own), killed by SIGKILL from inside ``source_fn`` at ``CRASH_AT``."""
    import torch
    dev = dev or torch.device("cuda", 0)
    eng = sharded_engine(dev, **sharded_durable_config(d))
    src, _ = wide_source(dev, seed, crash_at=CRASH_AT)
    eng.run(eng.init_state(), sharded_source(src), DURABLE_TICKS)
    raise AssertionError("the crash run outlived its crash")


def sharded_host_tables(state):
    """{updater: (ids ascending, ts, vals)} over every shard's rows."""
    import numpy as np
    out = {}
    for name, t in state["tables"].items():
        keys = t.keys[:, :-1].reshape(-1).cpu().numpy()
        occ = np.flatnonzero(keys != -1)
        order = occ[np.argsort(keys[occ])]
        out[name] = (keys[order],
                     t.ts[:, :-1].reshape(-1).cpu().numpy()[order],
                     t.vals["v"][:, :-1].reshape(-1, D).cpu().numpy()[order])
    return out


def sharded_durable_path(dev, seed, card):
    """Phase 15d: phase 12 at 8 shards — an uninterrupted durable run of
    phase 5's feed on 64-bit ids, the same run in a child killed at
    source tick ``CRASH_AT``, its recovery with store replica 0 down and
    the resumed run; every slate bitwise against the uninterrupted
    run's."""
    import signal
    import tempfile

    import numpy as np
    import torch
    from repro_torch.telemetry.trace import Tracer

    t_phase = time.perf_counter()
    uk, lk, _, _ = sharded_launch_counts()
    wide_fn, gen_tick = wide_source(dev, seed)
    src = sharded_source(wide_fn)
    ref = reference(gen_tick, DURABLE_TICKS)
    with tempfile.TemporaryDirectory(prefix="muppet-sharded-") as root:
        da, db = f"{root}/uninterrupted", f"{root}/crashed"
        reset_launches()
        with torch_probe_calls() as torch_calls:
            eng = sharded_engine(dev, **sharded_durable_config(da))
            eng.tracer = Tracer()
            state = eng.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = eng.run(state, src, DURABLE_TICKS)
            torch.cuda.synchronize()
            tick_s = (time.perf_counter() - t0) / DURABLE_TICKS
            state, _ = eng.drain(state)
            stats_a = sharded_stats(eng, state)
            wal = sum(w.offset for w in eng.dur.wals)
            flushes = [sp for sp in eng.tracer.events()
                       if sp["name"] == "flush_boundary"]
            log(f"sharded durable run: {DURABLE_TICKS} ticks x {B} events "
                f"on {SHARDS} shards, int64 keys, {tick_s * 1e3:.3f} ms/tick"
                f", {B / tick_s:.4e} events/s; {len(flushes)} flush "
                f"boundaries, {sum(sp['dur'] for sp in flushes) / 1e6:.3f}"
                f" s in all; WAL {wal} bytes over {SHARDS} logs; engine "
                f"tick {stats_a['tick']}; {card}")
            read_keys = read_set(seed)
            reads = {u: eng.read_slates(state, u, wide_ids(read_keys))
                     for u in ("U1", "U2")}
            check_slates(flat_tables(state), stats_a, ref, read_keys, reads,
                         DURABLE_TICKS, "sharded durable run",
                         rank_of=rank_of)
            base = sharded_host_tables(state)
            eng.close()
            del eng, state
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--sharded-durable-child", db, "--seed", str(seed)],
                capture_output=True, text=True, timeout=600)
            if child.returncode != -signal.SIGKILL:
                raise AssertionError(
                    f"the sharded crash run ended with {child.returncode}, "
                    f"not SIGKILL: {child.stdout[-2000:]} "
                    f"{child.stderr[-4000:]}")
            log(f"sharded crash run: killed by SIGKILL at source tick "
                f"{CRASH_AT} after {time.perf_counter() - t0:.1f} s wall")

            eng = sharded_engine(dev, **sharded_durable_config(db))
            eng.tracer = Tracer()
            eng.dur.store.set_replica_down(0)
            frontier = eng.dur.frontier
            f_src = frontier.meta["source_tick"]
            logged = sum(1 for _ in eng.dur.wals[0].replay(
                from_offset=frontier.wal_offset[0]))
            if f_src <= eng.cfg.durability.flush.every_k:
                raise AssertionError(f"frontier {frontier}: the crash came "
                                     "before the second frontier")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = eng.recover()
            torch.cuda.synchronize()
            t_recover = time.perf_counter() - t0
            log(f"sharded recovery from frontier {frontier.tick} (source "
                f"tick {f_src}), {logged} source ticks logged after it on "
                f"each shard, store replica 0 down: {t_recover:.3f} s wall "
                f"to engine tick {int(state['tick'].max())}; {card}")
            log_spans(eng.tracer, "sharded recovery", card)
            resume = f_src + logged
            state, _ = eng.run(state, src, DURABLE_TICKS - resume,
                               start_tick=resume)
            state, _ = eng.drain(state)
            stats = sharded_stats(eng, state)
            reads = {u: eng.read_slates(state, u, wide_ids(read_keys))
                     for u in ("U1", "U2")}
            eng.close()
        launches = {"slate_update": uk.slate_update.launches,
                    "slate_lookup_wide": lk.slate_lookup.launches}
        launches["slate_lookup_wide routes"] = check_lookup_routes(
            "sharded durable", torch_calls)
    if stats["tick"] != stats_a["tick"]:
        raise AssertionError(f"sharded: engine tick {stats['tick']} after "
                             f"recovery, {stats_a['tick']} without")
    check_slates(flat_tables(state), stats, ref, read_keys, reads,
                 DURABLE_TICKS, "sharded recovered run",
                 fed=(DURABLE_TICKS - f_src) * B, rank_of=rank_of)
    got = sharded_host_tables(state)
    for name, (ks, ts, vals) in base.items():
        gk, gts, gv = got[name]
        if not (np.array_equal(ks, gk) and np.array_equal(ts, gts)
                and vals.tobytes() == gv.tobytes()):
            raise AssertionError(f"sharded recovered {name} differs from "
                                 "the uninterrupted run")
    log(f"sharded recovered tables equal the uninterrupted run's bitwise, "
        f"key by key ({', '.join(f'{n} {len(t[0])}' for n, t in base.items())}"
        f" slates), engine tick {stats['tick']}; launches {launches}; the "
        f"phase took {time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


# ---------------------------------------------------------------- phase 16
# Live elasticity (``scale``, ``remove_shards``, ``rebalance``,
# ``compact``, ``AutoscalePolicy`` and the closed-loop ``LoadAutoscaler``)
# on the card.  Sizing (PERF.md section 4, checked with
# ``sharded_sizing`` on the CPU): at 16 shards cap_per_dest = batch_size
# * exchange_slack / 16, and 15a's hottest (source, destination) bucket
# holds ~13,100 events, so 16a takes exchange_slack 8.0 (cap 16,384 at 16
# slots); 15a's 4.0 would drop events there.
ELASTIC_SLACK = 8.0
# 16a ends compacted to 4 slots: at 15a's 2**19 slots a shard that holds
# the feed's ~325,000 keys an updater at load 0.155, where a key finds no
# free slot in its 8 probes with p ~ 0.155**8 (a chip run showed one
# table drop); 2**20 slots a shard give phase 5's table (2**22) there
ELASTIC_C = 1 << 20
ELASTIC_TICKS = 64
ELASTIC_SCHEDULE = {8: 16, 24: 8, 40: 16}
ELASTIC_SPLIT = 4            # 16a ends on 4 active of 16 slots: compacts
# 16b's batch_size is twice one shard's mean load at 8 shards (B / 4):
# Zipf(1.2)'s head sends the hottest shard ~2.5x the mean, and at B / 8
# its backlog outlasts the low half of the wave (a CPU rehearsal at a
# reduced size: the loop never sees the low watermark, PERF.md section 4)
LOOP = {"ticks": 60, "half": 15, "low": 8, "high": 16, "slack": 16.0,
        "window": 3, "batch_div": 4}
ELASTIC_SMALL = {"capacity": 1 << 14, "events": 2048, "ticks": 16,
                 "batch": 1024, "slack": 16.0,
                 "schedule": {4: 16, 8: 8, 12: 16}}
# the crash falls on a chunk boundary (chunks of 8 ticks: a chunk's
# sources are fetched, then logged), so the log holds ticks after the
# frontier for recovery to replay
ELASTIC_DURABLE = {"capacity": 1 << 15, "events": 8192, "ticks": 44,
                   "batch": 4096, "slack": 16.0, "scale_at": {16: 16},
                   "crash_at": 40}


def live_source(source_fn, eng):
    """A single-shard ``source_fn`` as the feed of an engine whose shard
    count changes: the same events each tick, as ``[n, B / n]`` rows for
    the engine's current ``n``."""
    return lambda t, mx: {s: shard_rows(b, eng.n_shards)
                          for s, b in source_fn(t, mx).items()}


class ElasticLaunches:
    """The launches a run must make, from what the engine did: each tick
    (a source tick or a drain tick) runs each of the 2 updaters on each
    physical slot, dead or alive (one ``slate_update``, ``INSERT_ROUNDS``
    ``find`` walks, and with telemetry one count and one histogram
    launch); a device-tier migration that moves rows rebuilds every
    updater's table on every slot with one ``insert_or_find``; a
    host-tier one inserts each slot's rows in chunks of 256.  Wraps the
    engine's ``_tick`` and ``_reconfigure`` to see it."""

    def __init__(self, eng):
        from repro_torch.slates.table import INSERT_ROUNDS
        self.ticks, self.rebuild_find, self.reports = {}, 0, []
        tick, reconf = eng._tick, eng._reconfigure

        def counted_tick(state, sources):
            n = eng.n_shards
            self.ticks[n] = self.ticks.get(n, 0) + 1
            return tick(state, sources)

        def counted_reconfigure(state, **kw):
            state, rep = reconf(state, **kw)
            if rep.path == "device" and sum(rep.moved_rows.values()):
                self.rebuild_find += INSERT_ROUNDS * 2 * rep.n_shards
            elif rep.path == "host":
                for t in state["tables"].values():
                    occ = t.occupancy().cpu().numpy()
                    self.rebuild_find += INSERT_ROUNDS * int(
                        sum(-(-int(o) // 256) for o in occ))
            self.reports.append(rep)
            return state, rep

        eng._tick, eng._reconfigure = counted_tick, counted_reconfigure

    def check(self, what, launches, reads, telemetry=False):
        from repro_torch.slates.table import INSERT_ROUNDS
        slots = sum(2 * n * k for n, k in self.ticks.items())
        want = {"slate_update": slots,
                "find": INSERT_ROUNDS * slots + self.rebuild_find,
                "keys": reads, "cand": 0}
        got = {"slate_update": launches["slate_update"],
               **launches["slate_lookup routes"]}
        if telemetry:
            want.update(countmin_update=slots, histogram_update=slots)
            got.update(countmin_update=launches["countmin_update"],
                       histogram_update=launches["histogram_update"])
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want} "
                                 f"(ticks by slot count {self.ticks}, "
                                 f"rebuild find {self.rebuild_find})")
        log(f"{what}: launches exact, {got}: ticks by physical slot count "
            f"{self.ticks}, {self.rebuild_find} find launches in table "
            f"rebuilds")


def path_launches(what, torch_calls, telemetry=False):
    uk, lk, ck, hk = sharded_launch_counts()
    out = {"slate_update": uk.slate_update.launches,
           "slate_lookup": lk.slate_lookup.launches}
    if telemetry:
        out["countmin_update"] = ck.countmin_update.launches
        out["histogram_update"] = hk.histogram_update.launches
    out["slate_lookup routes"] = check_lookup_routes(what, torch_calls)
    return out


def check_elastic_slates(eng, state, ref, read_keys, reads, what, fed):
    """Every slate over every shard's rows (a key's partials merged) and
    every read equals the reference; nothing dropped anywhere; every
    operator processed ``fed`` events."""
    import numpy as np
    stats = sharded_stats(eng, state)
    drops = (stats["exchange_dropped"], sum(stats["queue_dropped"].values()),
             sum(stats["table_dropped"].values()))
    if any(drops):
        raise AssertionError(f"{what}: drops (exchange, queue, table) "
                             f"{drops}")
    if stats["processed"] != {"M1": fed, "U1": fed, "U2": fed}:
        raise AssertionError(f"{what}: processed {stats['processed']}, fed "
                             f"{fed}")
    counts, sums, maxes = ref
    fed_keys = np.flatnonzero(counts)
    for name, want, comb in (("U1", sums, np.add),
                             ("U2", maxes, np.maximum)):
        rows = merged_rows(state, name, comb)
        ks = np.fromiter(rows, np.int64, len(rows))
        vals = np.stack([rows[int(k)] for k in ks])
        if not (np.array_equal(np.sort(ks), fed_keys) and
                np.array_equal(vals, want[ks].astype(np.float32))):
            raise AssertionError(f"{what} {name}: slates differ from the "
                                 f"reference")
        for k, row in zip(read_keys, reads[name]):
            if (row is None) != (counts[k] == 0) or (row is not None and (
                    not np.array_equal(row["v"].numpy(),
                                       want[k].astype(np.float32)))):
                raise AssertionError(f"{what} {name}: read of key {k}")
    log(f"{what}: all {len(fed_keys)} fed keys' slates of each updater "
        f"equal the reference over {eng.n_shards} slots, every read of "
        f"{read_keys.size} keys too; no exchange, queue or table drop")


def profile_call(fn):
    """One call under torch.profiler: (result, wall s, device busy ms,
    device operations), busy and operations None when the profiler
    records no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return out, wall, None, None
    return out, wall, sum(e.device_time_total for e in dev) / 1e3, len(dev)


def log_report(what, rep, card, busy=None):
    gbs = rep.bytes_moved / rep.pause_s / 1e9 if rep.pause_s else 0.0
    extra = "" if busy is None else (
        f"; profiled: {busy[0]:.4f} ms device busy over {busy[1]} device "
        f"operations" if busy[0] is not None else
        "; profiled: no device event recorded (not measured)")
    log(f"{what}: path {rep.path}, recompiled {rep.recompiled}, slots "
        f"{rep.n_shards}, active {len(rep.active)}, drain_ticks "
        f"{rep.drain_ticks}, moved rows {rep.moved_rows}, moved events "
        f"{rep.moved_events}, bytes_moved {rep.bytes_moved}, pause_s "
        f"{rep.pause_s:.6f} ({gbs:.4f} GB/s){extra}; {card}")


def check_elastic_no_host_sync(dev, seed):
    """After each kind of reconfigure (a physical grow on the host tier,
    a leave and a rebalance on the device tier) a chunk of 3 ticks of
    the sharded engine runs under the sync debug mode "error": the new
    ring and split set are on the card before the tick needs them."""
    import numpy as np
    import torch
    from repro_torch.core.engine import stack_sources
    eng = sharded_engine(dev, capacity=1 << 16, batch=4096, slack=16.0)
    source_fn, _ = make_source(zipf_cdf(dev), 4096, seed + 13)
    src = live_source(source_fn, eng)
    state = eng.init_state()
    t = 0
    steps = (("scale to 16 (host tier)", lambda s: eng.scale(s, 16)),
             ("leave of 8 (device tier)",
              lambda s: eng.remove_shards(s, list(range(8, 16)))),
             ("rebalance (device tier)", lambda s: eng.rebalance(
                 s, weights=np.linspace(0.5, 2.0, 16))))
    for what, fn in steps:
        state, rep = fn(state)
        stacked = stack_sources([src(t + i, None) for i in range(3)])
        t += 3
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _, _ = eng.run_chunk(state, stacked)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log(f"sharded run_chunk of 3 ticks right after a {what}, path "
            f"{rep.path}, under sync debug mode 'error': no host sync")


def elastic_path(dev, seed, card, ticks=ELASTIC_TICKS):
    """Phase 16a: 15a's workflow and feed from 8 shards through
    ``AutoscalePolicy(scale_at={8: 16, 24: 8, 40: 16})`` over ``ticks``
    - 1 ticks of ``run``, then a weighted ``rebalance``, a tick of
    backlog and a leave of shard 15 with ``drain_max=0``, a leave to 4
    active of 16 slots (which compacts), and ``compact()`` (a no-op)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.distributed import AutoscalePolicy

    t_phase = time.perf_counter()
    reports = []
    eng = sharded_engine(dev, capacity=ELASTIC_C, slack=ELASTIC_SLACK,
                         autoscale=AutoscalePolicy(
                             scale_at=dict(ELASTIC_SCHEDULE),
                             on_change=reports.append))
    sharded_sizing(dev, seed, 16, int(SHARD_B * ELASTIC_SLACK / 16),
                   SHARD_B, n_shards=16)
    source_fn, gen_tick = make_source(zipf_cdf(dev), B, seed)
    ref = reference(gen_tick, ticks)
    src = live_source(source_fn, eng)
    ledger = ElasticLaunches(eng)
    spans = []
    run_span = eng._run_span

    def timed_span(state, source_fn, n_ticks, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_span(state, source_fn, n_ticks, **kw)
        torch.cuda.synchronize()
        spans.append((len(eng.active_shards), eng.n_shards, n_ticks,
                      time.perf_counter() - t0))
        return out

    eng._run_span = timed_span
    torch.cuda.synchronize()
    reset_launches()
    with torch_probe_calls() as torch_calls:
        state = eng.init_state()
        state, _ = eng.run(state, src, ticks - 1)
        state, _ = eng.drain(state)
        # reweight the ring by hand: the device tier, shapes kept
        w = np.where(np.arange(16) % 3 == 0, 0.5, 1.5)
        (state, rep_w), wall, busy, ops = profile_call(
            lambda: eng.rebalance(state, weights=w))
        log_report("16a rebalance(weights), profiled", rep_w, card,
                   (busy, ops))
        # a tick of backlog, then a planned leave that does not drain it
        state, _ = eng.run(state, src, 1, start_tick=ticks - 1)
        backlog = int(sum(q.size.sum() for q in state["queues"].values()))
        state, rep_l = eng.remove_shards(state, [15], drain_max=0)
        if not backlog or not sum(rep_l.moved_events.values()):
            raise AssertionError(f"16a: leave with backlog {backlog} moved "
                                 f"{rep_l.moved_events} events")
        gc.collect()
        torch.cuda.synchronize()
        gib0 = torch.cuda.memory_allocated() / 2**30
        state, rep_c = eng.remove_shards(
            state, list(range(ELASTIC_SPLIT, 15)))
        gc.collect()
        torch.cuda.empty_cache()
        gib1 = torch.cuda.memory_allocated() / 2**30
        state, rep_n = eng.compact(state)
        state, drained = eng.drain(state, 256)
        read_keys = read_set(seed)
        reads = {u: eng.read_slates(state, u, read_keys)
                 for u in ("U1", "U2")}
        singles = [int(k) for k in read_keys[[0, 1, 7, Q // 2, -1]]]
        single = {k: (eng.read_slate(state, "U1", k),
                      eng.read_slate(state, "U2", k)) for k in singles}
    launches = path_launches("elastic", torch_calls)
    n_final = eng.n_shards
    ledger.check("elastic path", launches,
                 2 * n_final + 2 * len(singles))
    every = ledger.reports + [rep_n]
    want = [("host", True, 16), ("device", False, 16),
            ("device", False, 16), ("device", False, 16),
            ("device", False, 16), ("host", True, ELASTIC_SPLIT),
            ("none", False, ELASTIC_SPLIT)]
    got = [(r.path, r.recompiled, r.n_shards) for r in every]
    if got != want or reports != ledger.reports[:3]:
        raise AssertionError(f"16a reports {got}, expected {want}")
    for r in every[:-1]:
        if sum(r.moved_rows.values()) <= 0 or r.pause_s <= 0:
            raise AssertionError(f"16a: a reconfigure moved no row: {r}")
    if rep_n.bytes_moved or sum(rep_n.moved_rows.values()):
        raise AssertionError(f"16a: compact() after compaction moved {rep_n}")
    names = ["scale 8 -> 16 (grow)", "scale 16 -> 8 (leave)",
             "scale 8 -> 16 (rejoin)", "rebalance(weights)",
             "leave of shard 15, drain_max=0",
             f"leave to {ELASTIC_SPLIT} of 16 (compaction)", "compact()"]
    for name, r in zip(names, every):
        log_report(f"16a {name}", r, card)
    check_elastic_slates(eng, state, ref, read_keys, reads, "elastic path",
                         ticks * B)
    counts, sums, maxes = ref
    for k, (a, b) in single.items():
        for name, row, want_ in (("U1", a, sums), ("U2", b, maxes)):
            if (row is None) != (counts[k] == 0) or (row is not None and
                    not np.array_equal(row["v"].numpy(),
                                       want_[k].astype(np.float32))):
                raise AssertionError(f"elastic read_slate {name} {k}")
    by_active = {}
    for n_act, slots, n, s in spans:
        a = by_active.setdefault((n_act, slots), [0, 0.0])
        a[0] += n
        a[1] += s
    log("16a ms/tick by (active, physical) shards: " + ", ".join(
        f"{n_act} of {slots}: {s / n * 1e3:.3f} ms/tick over {n} ticks "
        f"({n * B / s:.4e} events/s)"
        for (n_act, slots), (n, s) in sorted(by_active.items())) +
        f"; spans {[(a, p, n, round(s, 3)) for a, p, n, s in spans]}; "
        f"{card}")
    log(f"16a compaction to {ELASTIC_SPLIT} of 16 slots: {gib0:.3f} GiB "
        f"allocated before, {gib1:.3f} GiB after ({1 - gib1 / gib0:.4f} "
        f"freed); drain {drained} ticks; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del eng, state
    return launches


def loop_n_valid(t):
    """16b's square wave: the whole batch valid for 15 ticks, a tenth for
    the next 15."""
    return B if (t // LOOP["half"]) % 2 == 0 else B // 10


def closed_loop_path(dev, seed, card):
    """Phase 16b: 15a's feed with telemetry on, as a square wave of the
    valid share, 60 ticks from 8 shards, ``batch_size`` B / 4 (twice a
    shard's mean load at 8 shards: see ``LOOP``), under
    ``LoadAutoscaler(high=0.75,
    low=0.25, window=3, dwell=2, cooldown=1, min_shards=8,
    max_shards=16)`` with a control log."""
    import json
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.event import EventBatch
    from repro_torch.telemetry import LoadAutoscaler, TelemetryConfig

    t_phase = time.perf_counter()
    L = LOOP
    source_fn, gen_tick = make_source(zipf_cdf(dev), B, seed)
    ref = reference(gen_tick, L["ticks"], n_valid=loop_n_valid)

    def wave(t, mx):
        b = source_fn(t, None)["S1"]
        valid = torch.arange(B, device=dev) < loop_n_valid(t)
        return {"S1": EventBatch(b.sid, b.ts, b.key, b.value, valid)}

    with tempfile.TemporaryDirectory(prefix="muppet-loop-") as d:
        log_path = f"{d}/control.jsonl"
        reports = []
        ctl = LoadAutoscaler(high=0.75, low=0.25, window=L["window"],
                             dwell=2, cooldown=1, min_shards=L["low"],
                             max_shards=L["high"], on_change=reports.append)
        eng = sharded_engine(
            dev, batch=B // L["batch_div"], slack=L["slack"],
            queue_capacity=4 * B,
            telemetry=TelemetryConfig(alpha=1.0, control_log=log_path),
            autoscale=ctl)
        src = live_source(wave, eng)
        ledger = ElasticLaunches(eng)
        trace = []

        def traced(t, mx):
            trace.append(len(eng.active_shards))
            return src(t, mx)

        reset_launches()
        with torch_probe_calls() as torch_calls:
            state = eng.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = eng.run(state, traced, L["ticks"])
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            state, drained = eng.drain(state, 256)
            read_keys = read_set(seed)
            reads = {u: eng.read_slates(state, u, read_keys)
                     for u in ("U1", "U2")}
        eng.close()
        with open(log_path) as f:
            records = [json.loads(l) for l in f]
    launches = path_launches("closed loop", torch_calls, telemetry=True)
    ledger.check("closed loop", launches, 2 * eng.n_shards, telemetry=True)
    flips = sum(1 for a, b in zip(trace, trace[1:]) if a != b)
    if max(trace) != L["high"] or trace[-1] != L["low"] or flips > 5 or \
            len(eng.active_shards) != L["low"]:
        raise AssertionError(f"16b trace {trace}: flips {flips}")
    fed = int(sum(loop_n_valid(t) for t in range(L["ticks"])))
    check_elastic_slates(eng, state, ref, read_keys, reads, "closed loop",
                         fed)
    for rec in records:
        if rec["action"] is not None:
            a = rec["applied"]
            log(f"16b tick {rec['tick']}: {rec['action']['kind']} -> "
                f"{rec['action']['target']} ({rec['action']['reason']}); "
                + ("not applied (the run ended)" if a is None else
                   f"path {a['path']}, pause_s {a['pause_s']:.6f}, "
                   f"bytes_moved {a['bytes_moved']}") + f"; {card}")
    log(f"16b closed loop: active shards by tick {trace}; {flips} flips; "
        f"{len(reports)} reconfigures; {L['ticks']} ticks in {t_run:.3f} s "
        f"= {t_run / L['ticks'] * 1e3:.3f} ms/tick (decisions and "
        f"migrations included), drain {drained} ticks; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del eng, state
    return launches


def elastic_small_run(device, mode):
    import numpy as np
    from repro_torch.core.distributed import AutoscalePolicy
    e = ELASTIC_SMALL
    reports = []
    eng = sharded_engine(device, capacity=e["capacity"], batch=e["batch"],
                         slack=e["slack"], device_migration=mode,
                         autoscale=AutoscalePolicy(
                             scale_at=dict(e["schedule"]),
                             on_change=reports.append))
    state, _ = eng.run(eng.init_state(), failover_source(
        device, e["events"], 9_000, eng), e["ticks"])
    state, rep = eng.rebalance(state, weights=np.where(
        np.arange(16) % 3 == 0, 0.5, 1.5))
    reports.append(rep)
    state, rep = eng.remove_shards(state, list(range(ELASTIC_SPLIT, 16)))
    reports.append(rep)
    state, _ = eng.drain(state, 256)
    reads = eng.read_slates(state, "U1", np.arange(4096)) + \
        eng.read_slates(state, "U2", np.arange(4096))
    return eng, state, reports, reads


def elastic_tiers(dev, seed, card):
    """Phase 16c: 16a's schedule at a reduced size (2**14 slots a shard,
    2,048 events a tick, 16 ticks; then a weighted rebalance and a leave
    to 4 that compacts) on the card with ``device_migration="auto"`` and
    ``"off"`` and on the CPU with ``"auto"``: every read slate bitwise
    equal across the three, the card's ``"auto"`` run's state, stats and
    reports equal to the CPU's."""
    import torch
    from repro_torch import convert
    runs, walls = {}, {}
    for where, d, mode in (("card", dev, "auto"), ("card", dev, "off"),
                           ("cpu", torch.device("cpu"), "auto")):
        with (cpu_threads() if where == "cpu" else nullcontext()):
            t0 = time.perf_counter()
            eng, st, reps, reads = elastic_small_run(d, mode)
            torch.cuda.synchronize()
            walls[(where, mode)] = time.perf_counter() - t0
        runs[(where, mode)] = (convert.state_to_numpy(st), eng.stats(st),
                               reps, reads)

    fields = lambda r: {k: v for k, v in vars(r).items() if k != "pause_s"}
    a, b = runs[("card", "auto")], runs[("cpu", "auto")]
    same_arrays(a[0], b[0], "16c: state")
    if a[1] != b[1] or [fields(r) for r in a[2]] != \
            [fields(r) for r in b[2]]:
        raise AssertionError("16c: stats or reports differ card vs CPU")
    base = runs[("cpu", "auto")][3]
    for key, run in runs.items():
        for i, (x, y) in enumerate(zip(base, run[3])):
            if (x is None) != (y is None) or (x is not None and not
                                              torch.equal(x["v"], y["v"])):
                raise AssertionError(f"16c: read {i} of {key} differs")
    paths = {m: [r.path for r in runs[("card", m)][2]]
             for m in ("auto", "off")}
    log(f"16c tiers: paths auto {paths['auto']}, off {paths['off']}; every "
        f"read of 8,192 equal across the card's auto and off runs and the "
        f"CPU's auto run, state, stats and reports bitwise card = CPU; walls "
        f"{ {k: round(v, 2) for k, v in walls.items()} } s; {card}")


def elastic_durable_engine(dev, d, shards=SHARDS):
    from repro_torch.core.distributed import AutoscalePolicy
    e = ELASTIC_DURABLE
    return sharded_engine(dev, capacity=e["capacity"], batch=e["batch"],
                          slack=e["slack"], shards=shards,
                          autoscale=AutoscalePolicy(
                              scale_at=dict(e["scale_at"])),
                          **sharded_durable_config(d))


def elastic_durable_child(d, seed, dev=None):
    """16d's crash run (``--elastic-durable-child DIR``, a process of its
    own), killed by SIGKILL from inside ``source_fn`` at its crash tick,
    after the scale to 16."""
    import torch
    dev = dev or torch.device("cuda", 0)
    eng = elastic_durable_engine(dev, d)
    src, _ = wide_source(dev, seed, ELASTIC_DURABLE["crash_at"],
                         ELASTIC_DURABLE["events"])
    eng.run(eng.init_state(), live_source(src, eng),
            ELASTIC_DURABLE["ticks"])
    raise AssertionError("the crash run outlived its crash")


def elastic_durable_path(dev, seed, card):
    """Phase 16d: 15d's durable configuration (64-bit ids, a flush every
    16 ticks to 3 store replicas in quorums of 2) at a reduced size
    (2**15 slots a shard, 8,192 events a tick, 44 ticks) from 8 shards
    with ``scale_at={16: 16}``: an uninterrupted run, the same run in a
    child killed by SIGKILL at source tick 40, ``recover`` on 16 shards
    and the resumed run; every slate bitwise against the uninterrupted
    run's, key by key (the reference's ``test_autoscale_policy_through_
    run_and_durability`` and ``test_compaction_durable_recovery`` on the
    card)."""
    import signal
    import tempfile

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    e = ELASTIC_DURABLE
    wide_fn, gen_tick = wide_source(dev, seed,
                                    events=ELASTIC_DURABLE["events"])
    with tempfile.TemporaryDirectory(prefix="muppet-elastic-") as root:
        da, db = f"{root}/uninterrupted", f"{root}/crashed"
        reset_launches()
        with torch_probe_calls() as torch_calls:
            eng = elastic_durable_engine(dev, da)
            state = eng.init_state()
            t0 = time.perf_counter()
            state, _ = eng.run(state, live_source(wide_fn, eng), e["ticks"])
            torch.cuda.synchronize()
            tick_s = (time.perf_counter() - t0) / e["ticks"]
            state, _ = eng.drain(state, 256)
            stats_a = sharded_stats(eng, state)
            base = sharded_host_tables(state)
            n_wals = len(eng.dur.wals)
            eng.close()
            del eng, state
            if n_wals != 16:
                raise AssertionError(f"16d: {n_wals} WALs after the scale")
            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--elastic-durable-child", db, "--seed", str(seed)],
                capture_output=True, text=True, timeout=600)
            if child.returncode != -signal.SIGKILL:
                raise AssertionError(
                    f"the elastic crash run ended with {child.returncode}, "
                    f"not SIGKILL: {child.stdout[-2000:]} "
                    f"{child.stderr[-4000:]}")
            t_child = time.perf_counter() - t0
            eng = elastic_durable_engine(dev, db, shards=16)
            frontier = eng.dur.frontier
            f_src = frontier.meta["source_tick"]
            logged = sum(1 for _ in eng.dur.wals[0].replay(
                from_offset=frontier.wal_offset[0]))
            if len(frontier.wal_offset) != 16 or f_src <= 16 or not logged:
                raise AssertionError(f"16d frontier {frontier}, {logged} "
                                     "ticks logged after it: the crash came "
                                     "before the scale's frontier or left "
                                     "nothing to replay")
            t0 = time.perf_counter()
            state = eng.recover()
            torch.cuda.synchronize()
            t_recover = time.perf_counter() - t0
            resume = f_src + logged
            state, _ = eng.run(state, live_source(wide_fn, eng),
                               e["ticks"] - resume, start_tick=resume)
            state, _ = eng.drain(state, 256)
            stats = sharded_stats(eng, state)
            read_keys = read_set(seed)[:256]
            reads = {u: eng.read_slates(state, u, wide_ids(read_keys))
                     for u in ("U1", "U2")}
            eng.close()
        uk, lk, _, _ = sharded_launch_counts()
        launches = {"slate_update": uk.slate_update.launches,
                    "slate_lookup_wide": lk.slate_lookup.launches}
        launches["slate_lookup_wide routes"] = check_lookup_routes(
            "elastic durable", torch_calls)
    ref = reference(gen_tick, e["ticks"])
    counts, sums, maxes = ref
    fed_keys = np.flatnonzero(counts)
    for name, want in (("U1", sums), ("U2", maxes)):
        ks, _, vals = base[name]
        if not (np.array_equal(rank_of(ks), fed_keys) and np.array_equal(
                vals, want[rank_of(ks)].astype(np.float32))):
            raise AssertionError(f"16d uninterrupted {name} differs from the "
                                 "reference")
    if stats["tick"] != stats_a["tick"] or any(
            stats_a["queue_dropped"].values()) or stats_a["exchange_dropped"]:
        raise AssertionError(f"16d: ticks {stats['tick']} / "
                             f"{stats_a['tick']}, stats {stats_a}")
    got = sharded_host_tables(state)
    for name, (ks, ts, vals) in base.items():
        gk, gts, gv = got[name]
        if not (np.array_equal(ks, gk) and np.array_equal(ts, gts)
                and vals.tobytes() == gv.tobytes()):
            raise AssertionError(f"16d recovered {name} differs from the "
                                 "uninterrupted run")
    for name, want in (("U1", sums), ("U2", maxes)):
        for k, row in zip(read_keys, reads[name]):
            if (row is None) != (counts[k] == 0) or (row is not None and (
                    not np.array_equal(row["v"].numpy(),
                                       want[k].astype(np.float32)))):
                raise AssertionError(f"16d recovered read {name} {k}")
    log(f"16d elastic durable: {e['ticks']} ticks x {e['events']} events, "
        f"8 -> 16 shards at tick 16, {tick_s * 1e3:.3f} ms/tick; crash run "
        f"killed at source tick {e['crash_at']} after {t_child:.1f} s; "
        f"frontier at source tick {f_src} on {len(frontier.wal_offset)} "
        f"WALs, {logged} ticks logged after it; recover on 16 shards "
        f"{t_recover:.3f} s; recovered tables equal the uninterrupted "
        f"run's bitwise, key by key ({', '.join(f'{n} {len(t[0])}' for n, t in base.items())}"
        f" slates); the phase took {time.perf_counter() - t_phase:.1f} s; "
        f"{card}")
    return launches


# ---------------------------------------------------------------- phase 17
# training qwen2-0.5b at full width on the card: batch x seq tokens a step
# from TokenStream(seed=0); 17a runs ``steps`` straight and resumes at
# ``resume_at`` from a checkpoint
TRAIN = {"arch": "qwen2-0.5b", "batch": 4, "seq": 1024, "steps": 6,
         "resume_at": 3}
# the route each kernel of the training step takes on every launch
TRAIN_ROUTES = {"flash_attention": "wgmma", "flash_attention_bwd": "wgmma",
                "rmsnorm": "regs", "rmsnorm_bwd": "regs"}
# 17a's state after ``resume_at`` straight steps: (tensors, losses, the
# kernels' launches a step, 17c's s/step), read by phase 18a
TRAIN_AT = {}


def train_launches(cfg, plan):
    """Launches of each kernel a training step: each block's forward
    kernels twice (the forward, and its recompute under remat) and its
    backward kernels once; the final norm, outside remat, once each way.
    A block runs ``NORMS`` norms and one attention."""
    kinds = serving_blocks(cfg, plan)
    if set(kinds) != {"attn"}:
        raise AssertionError(f"phase 17 trains attention blocks only, not "
                             f"{kinds}")
    blocks, norms = kinds["attn"], NORMS["attn"] * kinds["attn"]
    return {"flash_attention": 2 * blocks, "flash_attention_bwd": blocks,
            "rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1}


def rel_l2(a, b):
    """||a - b|| / ||b|| in f64."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def grad_bound(params, batch):
    """17b: the first step's gradients, the kernels' bf16 path against the
    plain versions at f32 compute, leaf by leaf in relative L2, held to
    twice the plain versions' own bf16 path's distance from the same f32
    gradients.  Both bf16 paths are roundings of one f32 function (the
    same weights, the same batch; the kernels accumulate in f32 where the
    plain versions do), so a path that rounds no worse than the plain
    one lies within that distance of it.  Returns the leaves' worst ratio
    and the distances of the worst leaf."""
    import torch
    from repro_torch.distributed import optimizer as adamw
    from repro_torch.distributed.checkpoint import _leaf_paths
    from repro_torch.models import lm
    from repro_torch.models.context import Ctx
    tree = params.tree()
    leaves = adamw.leaves(tree)
    names = list(_leaf_paths(tree))     # the paths, in the leaves' order

    def grads(cdtype):
        loss = lm.train_loss(params, batch, Ctx(cdtype=cdtype))
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    lk, gk = grads(torch.bfloat16)
    with plain_versions():
        lp, gp = grads(torch.bfloat16)
        lf, gf = grads(torch.float32)
    worst, at = 0.0, None
    for name, a, b, f in zip(names, gk, gp, gf):
        dk, dp = rel_l2(a, f), rel_l2(b, f)
        if not (dk <= 2 * dp):
            raise AssertionError(f"17b: {name}'s kernel-path gradient lies "
                                 f"{dk} (relative L2) from the plain f32 "
                                 f"one, past twice the plain bf16 path's "
                                 f"{dp}")
        if dk / dp > worst:
            worst, at = dk / dp, (name, dk, dp)
    return {"losses kernels / plain bf16 / plain f32": (lk, lp, lf),
            "leaves": len(leaves), "worst ratio": worst,
            "at (leaf, kernels, plain bf16)": at}


def profile_train_step(trainer, params, opt, batch, step_s):
    """One more training step under torch.profiler: device busy ms, device
    operations, the idle share against the unprofiled ms/step, the top
    kernels and the four training kernels' sums, each split by device
    kernel (a backward call's several launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = trainer.run(params, opt, iter([batch]),
                                     trainer.step + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        log("profile of a training step: the profiler recorded no device "
            "events (device busy time not measured)")
        return params, opt
    busy_us = sum(e.device_time_total for e in ev)
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    log(f"profile of one training step: device busy {busy_us / 1e3:.4f} "
        f"ms, {len(ev)} device operations, profiled wall {wall * 1e3:.3f} "
        f"ms; idle share against the unprofiled {step_s * 1e3:.3f} ms/step: "
        f"{1 - busy_us / 1e6 / step_s:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3:.4f} ms/step  {name[:100]}")
    for kname, parts in (("flash_attention", ("flash_attention_wgmma",
                                              "flash_attention_simt")),
                         ("flash_attention_bwd", ("attn_bwd_",)),
                         ("rmsnorm", ("rmsnorm_regs", "rmsnorm_loop")),
                         ("rmsnorm_bwd", ("rmsnorm_bwd_",))):
        hits = [e for e in ev if any(p in e.name for p in parts)]
        total = sum(e.device_time_total for e in hits)
        by_kernel = {}
        for e in hits:    # a call's launches (dQ, dK/dV, the sum, ...)
            key = e.name.replace("(anonymous namespace)::", "").split(
                "(")[0].split("<")[0].split("::")[-1].split()[-1]
            by_kernel[key] = by_kernel.get(key, 0.0) + e.device_time_total
        log(f"  {kname}: {total / 1e3:.4f} ms/step over {len(hits)} device "
            f"launches ({total / busy_us:.4f} of busy); by device kernel, "
            f"ms/step: { {k: round(v / 1e3, 4) for k, v in by_kernel.items()} }")
    return params, opt


def train_path(dev, seed, card):
    """Phase 17: ``Trainer`` on qwen2-0.5b at full width (``TRAIN``), f32
    master weights drawn from ``seed``, bf16 compute, default AdamW.
    17b the first step's gradients against the plain versions; 17a six
    steps straight against three, a checkpoint, a new ``Trainer``
    restored from it and three more, bitwise; 17c the kernels' launches a
    step; 17d a zamba2-1.2b train step raises.  Returns the launches of
    the path's kernels in its run."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import optimizer as adamw
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.launch.train import Trainer

    t_phase = time.perf_counter()
    tr = TRAIN
    cfg = get_config(tr["arch"])
    B, S, n, k = tr["batch"], tr["seq"], tr["steps"], tr["resume_at"]
    stream = TokenStream(cfg.vocab_size, B, S, seed=0)
    batches = [next(stream) for _ in range(n + 1)]
    kernels = (fk.flash_attention, fk.flash_attention_bwd, rk.rmsnorm,
               rk.rmsnorm_bwd)
    routed = kernels
    counts = lambda: {f.__name__: f.launches for f in kernels}
    torch.cuda.synchronize()
    for f in kernels:
        f.launches = 0
    for f in routed:
        f.launches_by_route = dict.fromkeys(f.launches_by_route, 0)

    t0 = time.perf_counter()
    straight = Trainer(cfg, device=dev)
    params, opt = straight.init(seed)
    torch.cuda.synchronize()
    per_step = train_launches(cfg, params.plan)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"training: {cfg.name} at full width ({describe(cfg, {'attn': cfg.n_layers})}); "
        f"{n_params} f32 parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; batch {B} x {S} tokens from "
        f"TokenStream(seed=0), bf16 compute, AdamW {adamw.AdamWConfig()}")

    # 17b: the first step's gradients, kernels against plain versions
    dev_batch = {key: torch.as_tensor(v).to(dev)
                 for key, v in batches[0].items()}
    c0 = counts()
    gb = grad_bound(params, dev_batch)
    moved = {key: v - c0[key] for key, v in counts().items()}
    if moved != per_step:
        raise AssertionError(f"17b: the kernels' gradient launched {moved}, "
                             f"expected a step's {per_step}")
    torch.cuda.empty_cache()
    log(f"17b, the first step's gradients, relative L2 a leaf, kernels "
        f"(bf16) against the plain versions at f32, each within twice the "
        f"plain bf16 path's distance: {gb}")

    # 17a and 17c: six steps straight, the first a warm-up, the rest timed
    torch.cuda.reset_peak_memory_stats()
    c0 = counts()
    # (a run pulls one batch past its last step: one list each)
    params, opt, losses = straight.run(params, opt, iter(batches[:1]), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, more = straight.run(params, opt, iter(batches[1:n]), n)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (n - 1)
    losses += more
    moved = {key: v - c0[key] for key, v in counts().items()}
    want_n = {key: v * n for key, v in per_step.items()}
    routes = {f.__name__: dict(f.launches_by_route) for f in routed}
    if moved != want_n:
        raise AssertionError(f"17c: {n} steps launched {moved}, expected "
                             f"{want_n} ({per_step} a step)")
    for name, route in TRAIN_ROUTES.items():
        if set(r for r, c in routes[name].items() if c) != {route}:
            raise AssertionError(f"17c: {name} routes {routes[name]}, "
                                 f"expected all on {route!r}")
    peak = torch.cuda.max_memory_allocated()
    log(f"17c, launches a step (asserted): {per_step} (each block's "
        f"forward kernels twice under remat, its backward once; the final "
        f"norm once each way); routes {routes}")
    log(f"training {cfg.name} end to end: {n} steps, losses {losses}; "
        f"steps 2-{n}: {step_s * 1e3:.3f} ms/step, {B * S / step_s:.1f} "
        f"tokens/s; max_memory_allocated {peak / 2**30:.3f} GiB; {card}")
    want = [t.detach().clone() for t in adamw.leaves(params.tree())
            + adamw.leaves(opt.m) + adamw.leaves(opt.v) + [opt.count]]
    del straight, params, opt
    torch.cuda.empty_cache()

    # 17a: three steps, a checkpoint, a failure, a new trainer, three more
    with tempfile.TemporaryDirectory(prefix="phase17_") as d:
        first = Trainer(cfg, ckpt_dir=d, ckpt_every=k, device=dev)
        p1, o1 = first.init(seed)
        it = iter(batches[:n])
        t0 = time.perf_counter()
        try:
            first.run(p1, o1, it, n, fail_at=k)
            raise AssertionError("17a: the simulated failure did not come")
        except RuntimeError as e:
            if "simulated node failure" not in str(e):
                raise
        first.ckpt.wait()
        t_save = time.perf_counter() - t0
        # the state after k straight steps, which phase 18a reproduces
        # (run updates parameters, m and v in place; its count is new)
        TRAIN_AT[k] = ([t.detach().clone() for t in adamw.leaves(p1.tree())
                        + adamw.leaves(o1.m) + adamw.leaves(o1.v)],
                       losses[:k], per_step, step_s)
        if first.ckpt.errors or first.ckpt.latest_step() != k:
            raise AssertionError(f"17a: checkpoint {first.ckpt.errors}, "
                                 f"latest {first.ckpt.latest_step()}")
        first.close()
        del first, p1, o1
        torch.cuda.empty_cache()
        second = Trainer(cfg, ckpt_dir=d, ckpt_every=10 * n, device=dev)
        p2, o2 = second.init(seed + 1)        # restored over
        t0 = time.perf_counter()
        p2, o2 = second.maybe_restore(p2, o2)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        p2, o2, resumed = second.run(p2, o2, it, n)
        got = [t.detach() for t in adamw.leaves(p2.tree())
               + adamw.leaves(o2.m) + adamw.leaves(o2.v) + [o2.count]]
        same = len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        if not same or resumed != losses[k:]:
            diff = sum(not torch.equal(a, b) for a, b in zip(got, want))
            raise AssertionError(f"17a: the resumed run differs from the "
                                 f"straight one ({diff} of {len(want)} "
                                 f"tensors; losses {resumed} against "
                                 f"{losses[k:]})")
        log(f"17a: {k} steps, a checkpoint ({sum(t.numel() for t in want)}"
            f" values; step, save and write {t_save:.2f} s), a simulated "
            f"failure, a new Trainer restored in {t_restore:.2f} s and "
            f"{n - k} more steps: parameters, m, v and count bitwise equal "
            f"to the straight run's; losses {resumed}")
        del want, got
        p2, o2 = profile_train_step(second, p2, o2, batches[n], step_s)
        second.close()
        del second, p2, o2
    launches = counts()
    # every launch of the phase on its route, the backward kernels' too
    for f in routed:
        name = f.__name__
        if f.launches_by_route != {r: launches[name] * (r == TRAIN_ROUTES[
                name]) for r in f.launches_by_route}:
            raise AssertionError(f"17: {name} routes {f.launches_by_route} "
                                 f"over {launches[name]} launches, expected "
                                 f"all on {TRAIN_ROUTES[name]!r}")
        if name.endswith("_bwd"):      # their launches are phase 17's
            launches[f"{name} routes"] = dict(f.launches_by_route)
    log(f"17: every launch of the phase on its route (asserted): "
        f"{ {f.__name__: f.launches_by_route for f in routed} }")
    torch.cuda.empty_cache()

    # 17d: zamba2-1.2b's ssd_scan has no backward kernel: its train step
    # raises, naming the ROADMAP item
    zcfg = get_config("zamba2-1.2b")
    z = Trainer(zcfg, device=dev)
    pz, oz = z.init(seed)
    try:
        z.run(pz, oz, iter([next(TokenStream(zcfg.vocab_size, B, S,
                                             seed=0))]), 1)
        raise AssertionError("17d: a zamba2-1.2b train step ran on the card")
    except NotImplementedError as e:
        if "item 22" not in str(e):
            raise
        log(f"17d: a zamba2-1.2b train step on the card raises: {e}")
    del z, pz, oz
    torch.cuda.empty_cache()
    log(f"training: the phase took {time.perf_counter() - t_phase:.1f} s "
        f"wall")
    return launches


# ---------------------------------------------------------------- phase 18
# the mesh slice: Trainer, the expert-parallel MoE and ServingEngine on a
# one-rank NCCL mesh over the card (parameters, optimizer state, batches
# and decode states are DTensors; each kernel runs on the rank's local
# shards), then the dry run of two production cells on the card's host
MESH_TRAIN_STEPS = 3              # 17a's straight steps before its save
MESH_MOE = {"arch": "deepseek-v2-lite-16b", "batch": 8, "seq": 256}
MESH_SERVE_TICKS = 8
MESH_DRYRUN = (("qwen2-0.5b", "train_4k", False),
               ("deepseek-v2-lite-16b", "train_4k", True))


def mesh_train(dev, seed, card, mesh):
    """18a: ``Trainer(mesh=...)`` on qwen2-0.5b at full width, phase 17's
    batches and seed, ``MESH_TRAIN_STEPS`` steps: parameters, m, v and
    losses bitwise equal to 17a's straight steps, the same launches and
    routes a step, the parameters DTensors.  Returns (ms/step, profile
    logged)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import optimizer as adamw
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.launch.train import Trainer

    k = MESH_TRAIN_STEPS
    want, want_losses, per_step, step17 = TRAIN_AT.pop(k)
    cfg = get_config(TRAIN["arch"])
    stream = TokenStream(cfg.vocab_size, TRAIN["batch"], TRAIN["seq"],
                         seed=0)
    batches = [next(stream) for _ in range(k + 1)]
    kernels = (fk.flash_attention, fk.flash_attention_bwd, rk.rmsnorm,
               rk.rmsnorm_bwd)
    counts = lambda: {f.__name__: f.launches for f in kernels}
    routes = lambda: {f.__name__: dict(f.launches_by_route)
                      for f in kernels}
    tr = Trainer(cfg, mesh=mesh, device=dev)
    params, opt = tr.init(seed)
    if not all(isinstance(p, DTensor) for p in params.parameters()):
        raise AssertionError("18a: the mesh trainer's parameters are not "
                             "all DTensors")
    c0, r0 = counts(), routes()
    params, opt, losses = tr.run(params, opt, iter(batches[:1]), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, more = tr.run(params, opt, iter(batches[1:k]), k)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (k - 1)
    losses += more
    moved = {n: v - c0[n] for n, v in counts().items()}
    r1 = routes()
    by_route = {n: {r: c - r0[n].get(r, 0) for r, c in r1[n].items()
                    if c - r0[n].get(r, 0)} for n in r1}
    want_n = {n: v * k for n, v in per_step.items()}
    if moved != want_n:
        raise AssertionError(f"18a: {k} mesh steps launched {moved}, "
                             f"expected 17c's {want_n}")
    for name, route in TRAIN_ROUTES.items():
        if set(by_route[name]) != {route}:
            raise AssertionError(f"18a: {name} routes {by_route[name]}, "
                                 f"expected all on {route!r}")
    got = [t.detach().full_tensor() for t in adamw.leaves(params.tree())
           + adamw.leaves(opt.m) + adamw.leaves(opt.v)]
    diff = sum(not torch.equal(a, b) for a, b in zip(got, want))
    if len(got) != len(want) or diff or losses != want_losses or \
            int(opt.count) != k:
        raise AssertionError(f"18a: the mesh run differs from 17a's "
                             f"straight steps ({diff} of {len(want)} "
                             f"tensors; losses {losses} against "
                             f"{want_losses}; count {int(opt.count)})")
    log(f"18a: Trainer(mesh={tuple(mesh.shape)} {mesh.mesh_dim_names}, "
        f"{torch.distributed.get_backend()}) on {cfg.name}, {k} steps: "
        f"parameters, m and v "
        f"({len(want)} tensors, all DTensors) and losses {losses} bitwise "
        f"equal to 17a's first {k} straight steps; launches {moved} "
        f"(17c's a step, asserted), routes {by_route}; steps 2-{k}: "
        f"{step_s * 1e3:.3f} ms/step on the mesh against phase 17's "
        f"{step17 * 1e3:.3f} ms/step; {card}")
    del got, want
    params, opt = profile_train_step(tr, params, opt, batches[k], step_s)
    del tr, params, opt
    torch.cuda.empty_cache()
    return step_s


def mesh_moe(dev, seed, card, mesh):
    """18b: one MoE sublayer of deepseek-v2-lite-16b at full width (its
    pre-norm, then the MoE: 64 experts, top-6, 2 shared; bf16 weights
    drawn from ``seed``), prefill phase on ``batch`` x ``seq`` tokens:
    ``apply_sharded`` over the one-rank "model" group against the
    one-card ``moe.apply``, ``y`` within 2**-5 of the one-card output's
    largest magnitude and ``aux`` within 1e-6; a backward through the
    mesh path gives finite gradients, non-zero in every leaf."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.cells import on_mesh
    from repro_torch.models import lm
    from repro_torch.models.context import Ctx
    from repro_torch.models.layers import moe, norms

    cfg = get_config(MESH_MOE["arch"])
    m = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    p, specs = moe.init(gen, cfg)
    p = lm._cast_tree(p, torch.bfloat16)
    norm, nspecs = norms.init(gen, cfg.d_model)
    x = torch.randn((MESH_MOE["batch"], MESH_MOE["seq"], cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    one = Ctx(cdtype=torch.bfloat16, phase="prefill")
    walls = []
    for _ in range(2):            # the first call, then a warm one
        t0 = time.perf_counter()
        ref, ref_aux = moe.apply(p, norms.apply(norm, x, eps=cfg.norm_eps),
                                 one, cfg=cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rules = shd.rules_for(mesh, phase="prefill")
    ctx = Ctx(cdtype=torch.bfloat16, phase="prefill", mesh=mesh,
              rules=rules, constrain=shd.make_constrainer(mesh, rules))
    if not moe._sharded_ok(cfg, ctx):
        raise AssertionError("18b: the mesh does not take the "
                             "expert-parallel path")
    pd = shd.distribute_tree(p, shd.tree_shardings(specs, p, mesh, rules),
                             mesh)
    nd = shd.distribute_tree(norm, shd.tree_shardings(nspecs, norm, mesh,
                                                      rules), mesh)
    leaves = [pd[k] for k in sorted(pd) if k != "shared"] + \
        [pd["shared"][k] for k in sorted(pd["shared"])] + [nd["scale"]]
    for t in leaves:
        t.requires_grad_(True)
    xd = shd.distribute(x, mesh, shd.placements_for(
        ("act_batch", "act_seq", None), x.shape, mesh, rules))
    calls = []
    orig = moe.apply_sharded
    moe.apply_sharded = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        with on_mesh(mesh):
            with torch.no_grad():
                t0 = time.perf_counter()
                moe.apply(pd, norms.apply(nd, xd, eps=cfg.norm_eps), ctx,
                          cfg=cfg)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            y, aux = moe.apply(pd, norms.apply(nd, xd, eps=cfg.norm_eps),
                               ctx, cfg=cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            grads = torch.autograd.grad(y.float().sum() + aux, leaves)
            y, aux = y.full_tensor(), aux.full_tensor()
            grads = [g.full_tensor() for g in grads]
    finally:
        moe.apply_sharded = orig
    err = float((y.float() - ref.float()).abs().max())
    big = float(ref.float().abs().max())
    daux = abs(float(aux) - float(ref_aux))
    bad = [i for i, g in enumerate(grads)
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    if calls != [1, 1] or not err <= 2.0**-5 * big or not daux < 1e-6 or \
            bad:
        raise AssertionError(f"18b: apply_sharded calls {calls}, max |y - "
                             f"one-card| {err} against 2**-5 x {big}, aux "
                             f"{float(aux)} vs {float(ref_aux)}, leaves with "
                             f"bad gradients {bad}")
    log(f"18b: one MoE sublayer of {cfg.name} at full width ({m.n_routed_experts}"
        f" experts, top-{m.top_k}, {m.n_shared_experts} shared, d_expert "
        f"{m.d_expert}; bf16) on {MESH_MOE['batch']} x {MESH_MOE['seq']} "
        f"prefill tokens: apply_sharded on the one-rank model group against "
        f"the one-card moe.apply, max |dy| {err} (bound 2**-5 x {big}), "
        f"|d aux| {daux}; gradients finite and non-zero in all "
        f"{len(grads)} leaves; forward wall, first call and warm: "
        f"{walls[2] * 1e3:.2f} and {walls[3] * 1e3:.2f} ms on the mesh "
        f"(the warm one recording for the backward), {walls[0] * 1e3:.2f} "
        f"and {walls[1] * 1e3:.2f} ms on one card; {card}")
    del pd, nd, grads, y, ref
    torch.cuda.empty_cache()


def mesh_serve(dev, seed, card, mesh):
    """18c: ``ServingEngine(mesh=...)`` on qwen2-0.5b at 14a's
    configuration and weights, ``MESH_SERVE_TICKS`` ticks: every
    request's tokens a prefix of 14a's (bitwise), and the launches a
    prefill and a decode step 14a's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import (ServeConfig, ServingEngine,
                                          set_lm_params)
    from repro_torch.models import lm

    arch = "qwen2-0.5b"
    cfg, ev = get_config(arch), ENGINE[arch]
    model, _ = lm.init(lm.build(cfg), torch.Generator(device=dev).manual_seed(
        seed), dtype=torch.bfloat16)
    eng = ServingEngine(cfg, ServeConfig(**ev["serve"]), mesh=mesh,
                        device=dev)
    set_lm_params(eng, model)
    del model
    reqs = engine_requests(arch, seed, cfg.vocab_size)[:-HELD_BACK]
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"18c: request {r.rid} shed")
    calls = count_calls(eng)
    c0 = {f.__name__: f.launches for f in (fk.flash_attention,
                                          dk.decode_attention)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(MESH_SERVE_TICKS)
    torch.cuda.synchronize()
    tick_s = (time.perf_counter() - t0) / MESH_SERVE_TICKS
    moved = {f.__name__: f.launches - c0[f.__name__]
             for f in (fk.flash_attention, dk.decode_attention)}
    per_prefill, per_decode = engine_launches(cfg)
    want = {"flash_attention": per_prefill["flash_attention"]
            * calls["prefill"],
            "decode_attention": per_decode["decode_attention"]
            * calls["decode"]}
    if moved != want:
        raise AssertionError(f"18c: launches {moved}, expected {want} "
                             f"(calls {calls})")
    base = ENGINE_TOKENS[arch]
    got = {r.rid: list(r.tokens_out) for r in reqs}
    bad = [rid for rid, t in got.items() if t != base[rid][:len(t)]]
    n_tok = sum(len(t) for t in got.values())
    if bad or not n_tok:
        raise AssertionError(f"18c: requests {bad} part from 14a's tokens")
    log(f"18c: ServingEngine(mesh) on {cfg.name} at 14a's configuration, "
        f"{MESH_SERVE_TICKS} ticks ({calls['prefill']} prefills, "
        f"{calls['decode']} decode steps): all {n_tok} tokens bitwise 14a's; "
        f"launches {moved} (14a's a prefill and a decode step, asserted); "
        f"{tick_s * 1e3:.3f} ms/tick (prefills included); {card}")
    del eng
    torch.cuda.empty_cache()


def mesh_dryrun(card):
    """18d: ``python -m repro_torch.launch.dryrun`` for ``MESH_DRYRUN``'s
    cells, each in its own process on the card's host (the fake world of
    512 ranks; nothing runs on the card), both at once; each record must
    be ``ok`` with positive FLOPs, bytes, collective bytes and peak."""
    import os
    from repro_torch.launch import dryrun
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    t0 = time.perf_counter()
    procs = []
    for arch, shape, mp in MESH_DRYRUN:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + (["--multi-pod"] if mp else [])
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    wall = time.perf_counter() - t0
    for (arch, shape, mp), p, out in zip(MESH_DRYRUN, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"18d: the dry run of {arch} {shape} "
                                 f"failed:\n{out[-3000:]}")
        path = Path(dryrun.RESULT_DIR) / (dryrun.cell_id(arch, shape, mp)
                                          + ".json")
        rec = json.loads(path.read_text())
        c, mem = rec.get("hlo_walker_per_device", {}), rec.get(
            "memory_analysis", {})
        peak = mem.get("peak_estimate_bytes_per_device", 0)
        counts = [c.get("flops", 0), c.get("hbm_bytes", 0),
                  c.get("collective_bytes_total", 0), peak]
        if rec.get("status") != "ok" or not all(v > 0 for v in counts):
            raise AssertionError(f"18d: {arch} {shape}: record {rec}")
        log(f"18d: dry run {arch} {shape} on {rec['mesh']} "
            f"({rec['n_chips']} ranks, lowered in {rec['lower_s']} s): per "
            f"rank {c['flops']:.6g} FLOPs, {c['hbm_bytes']:.6g} bytes, "
            f"collective bytes {c['collective_bytes']} "
            f"(total {c['collective_bytes_total']:.6g}); peak "
            f"{peak / 2**30:.3f} GiB (fits in {rec['hbm_limit_bytes'] / 2**30:.0f}"
            f" GiB: {rec['fits']}); dominant {rec['dominant_term']} "
            f"{rec['roofline_terms_s']}; useful_flops_fraction "
            f"{rec['useful_flops_fraction']}; roofline from the "
            f"{rec['roofline_source']}")
    log(f"18d: both dry runs in {wall:.1f} s wall, side by side")


def mesh_path(dev, seed, card):
    """Phase 18: 18a-c on a one-rank NCCL mesh over the card, then 18d.
    Returns the launches of the path's kernels in its run (18a-c).  The
    world stays up for phase 19."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.launch import mesh as tmesh

    t_phase = time.perf_counter()
    kernels = (fk.flash_attention, fk.flash_attention_bwd,
               dk.decode_attention, rk.rmsnorm, rk.rmsnorm_bwd)
    routed = (fk.flash_attention_bwd, rk.rmsnorm_bwd)
    torch.cuda.synchronize()
    for f in kernels:
        f.launches = 0
    for f in routed:
        f.launches_by_route = dict.fromkeys(f.launches_by_route, 0)
    mesh = tmesh.make_host_mesh(device=dev)
    try:
        mesh_train(dev, seed, card, mesh)
        mesh_moe(dev, seed, card, mesh)
        mesh_serve(dev, seed, card, mesh)
    except BaseException:
        tmesh.close_world()
        raise
    # the NCCL world of one stays up for phase 19 (a second
    # init_process_group in this process fails); main closes it
    launches = {f.__name__: f.launches for f in kernels}
    for f in routed:
        launches[f"{f.__name__} routes"] = dict(f.launches_by_route)
    log(f"18: launches on the mesh path (18a-c): {launches}")
    mesh_dryrun(card)
    log(f"mesh: the phase took {time.perf_counter() - t_phase:.1f} s wall")
    return launches


# ---------------------------------------------------------------- phase 19
# The multi-shard engine over the ranks of a process group: 15a's
# deployment on the NCCL world of one that phase 18 started (the card
# machine has one H100; NCCL refuses two ranks on one card), so every
# hop goes through ``all_to_all_single`` and every read through
# ``all_gather``, held against 15a's run with no group.
RANK_SCALE = (4, 8)            # a leave to 4 active, then a rejoin


def tree_bytes(tree):
    import torch.utils._pytree as pytree
    return sum(x.numel() * x.element_size()
               for x in pytree.tree_leaves(tree) if hasattr(x, "numel"))


def same_tree(a, b, what, sink=False):
    """Two engine states (trees of tensors on the card) bitwise equal,
    leaf by leaf, without the sink row that every table and queue buffer
    carries (``convert.state_to_numpy``'s cut: masked scatters land
    there, in no defined order)."""
    import dataclasses
    import torch
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{what}: keys {set(a) ^ set(b)}")
        for k in a:
            same_tree(a[k], b[k], f"{what}.{k}", sink)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same_tree(getattr(a, f.name), getattr(b, f.name),
                      f"{what}.{f.name}", sink or f.name in (
                          "keys", "ts", "dirty", "vals", "buf"))
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            same_tree(x, y, f"{what}[{i}]", sink)
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a[:, :-1], b[:, :-1]) if sink else \
                not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
    elif a != b:
        raise AssertionError(f"{what} differs")


def reconfigure(eng, state):
    """``scale`` 8 -> 4 -> 8 on the device tier with the queues' backlog
    left in them (``drain_max=0``), so ``exchange_rows`` and
    ``exchange_queue`` both run.  Returns (state, reports)."""
    reps = []
    for n in RANK_SCALE:
        state, rep = eng.scale(state, n, drain_max=0)
        reps.append(rep)
    return state, reps


def read_all(eng, state, read_keys, singles):
    reads = {u: eng.read_slates(state, u, read_keys) for u in ("U1", "U2")}
    single = {k: (eng.read_slate(state, "U1", k),
                  eng.read_slate(state, "U2", k)) for k in singles}
    return reads, single


def same_reads(a, b, what):
    import torch
    for x, y in zip(a, b):
        if (x is None) != (y is None) or (x is not None and not
                                          torch.equal(x["v"], y["v"])):
            raise AssertionError(f"{what} differs")


def served_paths(read_keys, singles):
    """Phase 19's HTTP reads: ``/slate/U1/<k>`` of each single key,
    ``/slates/U1`` of the read set, ``/status`` and ``/metrics``."""
    return [f"/slate/U1/{k}" for k in singles] + [
        "/slates/U1?keys=" + ",".join(str(int(k)) for k in read_keys),
        "/status", "/metrics"]


def http_get(port, path, timeout=300):
    """``(status, X-Source-Tick or None, body bytes)`` of ``GET path`` on
    127.0.0.1:``port``, error statuses included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.headers.get("X-Source-Tick"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("X-Source-Tick"), e.read()


def timed_get(port, path, waits):
    """``http_get``, its round trip in s appended to ``waits``."""
    t0 = time.perf_counter()
    got = http_get(port, path)
    waits.append(time.perf_counter() - t0)
    return got


def wait_queued(h, n, what, limit=120.0):
    """Wait until ``n`` requests are on ``h``'s read queue; raise after
    ``limit`` s (a reader that never reached the server)."""
    t0 = time.perf_counter()
    while len(h._queue) < n:
        if time.perf_counter() - t0 > limit:
            raise AssertionError(f"19: {len(h._queue)} of {n} {what} "
                                 f"queued after {limit} s")
        time.sleep(0.001)


def counted_drains(h):
    """Wrap ``h.drain``: a record a call of its reads, wall ms,
    collectives and kernel launches."""
    from repro_torch.core import distributed as dist
    uk, lk, _, _ = sharded_launch_counts()
    drains, real = [], h.drain

    def drain(tick=None):
        c0 = dict(dist.COLLECTIVES)
        l0 = dict(lk.slate_lookup.launches_by_route)
        u0 = uk.slate_update.launches
        t0 = time.perf_counter()
        n = real(tick)
        drains.append({
            "reads": n, "ms": (time.perf_counter() - t0) * 1e3,
            **{k: dist.COLLECTIVES[k] - c0[k] for k in c0},
            "lookups": {r: lk.slate_lookup.launches_by_route[r] - l0[r]
                        for r in l0},
            "slate_update": uk.slate_update.launches - u0})
        return n

    h.drain = drain
    return drains


def lane_sums(body):
    """{key: the sum of its U1 row's lanes} of a ``/slate`` (key None) or
    ``/slates`` body; U1 sums lanes >= 0, so a key's sum never falls."""
    doc = json.loads(body)
    if "slates" in doc:
        return {k: sum(v["v"]) for k, v in doc["slates"].items()
                if v is not None}
    return {None: sum(doc["v"])} if "v" in doc else {}


def check_served(live, final, want, paths, ticks, chunk):
    """Phase 19's served answers: every path answered at the first
    chunk boundary and at source ticks that never go back; each key's
    lane sums and the processed totals never fall; the batch queued
    after the run (``final``) answered at the last tick, and every
    answer at that tick, equal to ``want`` (15a's engine at that tick,
    read through a server of its own) byte for byte."""
    by_path = {}
    for path, status, tick, body in live:
        if status != 200 and not (status == 404 and path.startswith(
                "/slate/")):
            raise AssertionError(f"19 served {path}: {status} {body[:200]}")
        by_path.setdefault(path, []).append((int(tick), status, body))
    for path in paths:
        got = by_path.get(path, [])
        if not got or got[0][0] != chunk:
            raise AssertionError(f"19 served {path}: first answers at "
                                 f"{[t for t, _, _ in got[:3]]}, not {chunk}")
        seen = [t for t, _, _ in got]
        if seen != sorted(seen) or not set(seen) <= set(range(
                chunk, ticks + 1, chunk)):
            raise AssertionError(f"19 served {path} at ticks {seen}")
        if path.startswith("/slate"):
            last = {}
            for t, _, body in got:
                for k, v in lane_sums(body).items():
                    if v < last.get(k, 0):
                        raise AssertionError(f"19 served {path}: key {k}'s "
                                             f"sum fell to {v} at {t}")
                    last[k] = v
        if path == "/status":
            done = [sum(json.loads(b)["processed"].values())
                    for _, _, b in got]
            if done != sorted(done):
                raise AssertionError(f"19 /status processed {done}")
        for t, status, body in got:
            if t == ticks and (status, body) != (want[path][0],
                                                  want[path][2]):
                raise AssertionError(f"19 served {path} at {t} differs "
                                     f"from 15a's read")
    for path in paths:
        status, tick, body = final[path]
        if tick is None or int(tick) != ticks or (status, body) != (
                want[path][0], want[path][2]):
            raise AssertionError(f"19 the final {path} ({status}, tick "
                                 f"{tick}) differs from 15a's read")


def check_drains(drains):
    """A drain broadcasts once when empty, twice otherwise (the counts,
    the packed requests), gathers once a read and writes nothing."""
    for d in drains:
        want = (1 if d["reads"] == 0 else 2, d["reads"], 0, 0)
        got = (d["broadcast"], d["all_gather"], d["all_to_all_single"],
               d["slate_update"])
        if got != want:
            raise AssertionError(f"19 a drain of {d['reads']} reads made "
                                 f"(broadcast, all_gather, "
                                 f"all_to_all_single, slate_update) {got}, "
                                 f"expected {want}")


def percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else \
        float("nan")


def ranks_path(dev, seed, card):
    """Phase 19: 15a's deployment (8 shards, 2**19 slots an updater a
    shard, sources [8, 8,192] of phase 5's Zipf feed) through the rank
    path on the NCCL world of one phase 18 started, held against 15a's
    run with no group: the state after 15a's first ``RANK_TICKS`` ticks
    bitwise 15a's, its kernels' launches exactly 15a's over them (the
    served reads' lookups apart); the run served over HTTP from rank 0
    through the read queue (``check_served``, ``check_drains``); then,
    with the queues' backlog in place, ``scale`` 8 -> 4 -> 8 on the
    device tier (``exchange_rows`` / ``exchange_queue`` over the group,
    events moved), a drain and 15a's reads, each bitwise what 15a's
    engine gives from its own state at that tick; one
    ``all_to_all_single`` a hop; every slate equal to the numpy
    reference; a chunk of the rank path under the sync debug mode
    "error".  Prints ms/tick and busy ms beside 15a's and the
    collective's device ms.  Returns the launches of the rank path."""
    import threading

    import torch
    import torch.distributed as tdist
    from repro_torch.core import distributed as dist
    from repro_torch.core.engine import StateHandle
    from repro_torch.core.event import tree_map

    t_phase = time.perf_counter()
    if not tdist.is_initialized() or tdist.get_world_size() != 1:
        raise AssertionError("phase 19 needs phase 18's world of one")
    if "state" not in SHARDED_AT:
        raise AssertionError("phase 19 needs phase 15a's state")
    group = tdist.group.WORLD
    ticks = SHARDED_AT["at"]
    marks = [("start", time.perf_counter())]
    check_sharded_no_host_sync(dev, seed, group=group)
    marks.append(("sync check", time.perf_counter()))

    uk, lk, _, _ = sharded_launch_counts()
    eng = sharded_engine(dev, group=group)
    if eng.world != 1 or eng.group is None:
        raise AssertionError("phase 19: the engine is not on the group")
    n_ops = len(list(eng.wf.updaters())) + len(eng.wf.operators)
    source_fn, _ = make_source(zipf_cdf(dev), B, seed)
    src = sharded_source(source_fn)
    read_keys = read_set(seed)
    singles = [int(k) for k in read_keys[[0, 1, 7, Q // 2, -1]]]
    # rank 0 serves the run over HTTP: a reader a path while it goes,
    # then a batch queued after it that close()'s last drain answers
    paths = served_paths(read_keys, singles)
    h = StateHandle(eng, eng.init_state(), timeout=300)
    drains = counted_drains(h)
    srv = h.serve()
    live, final, stop = [], {}, threading.Event()
    waits, final_waits = [], []

    def reader(path):
        while not stop.is_set():
            live.append((path,) + timed_get(srv.port, path, waits))

    def paced(t, mx):
        # every reader's first request waits for the first boundary
        if t == 0:
            wait_queued(h, len(paths), "readers' first requests")
        return src(t, mx)

    readers = [threading.Thread(target=reader, args=(p,)) for p in paths]
    torch.cuda.synchronize()
    reset_launches()
    c0 = dict(dist.COLLECTIVES)
    calls = lambda: {k: dist.COLLECTIVES[k] - c0[k] for k in c0}
    with torch_probe_calls() as torch_calls:
        for r in readers:
            r.start()
        t0 = time.perf_counter()
        state, _ = eng.run(h.state, paced, ticks, handle=h)
        torch.cuda.synchronize()
        tick_s = (time.perf_counter() - t0) / ticks
        in_run = len(drains)
        served_lookups = {r: sum(d["lookups"][r] for d in drains)
                          for r in lk.ROUTES}
        at_run = {"slate_update": uk.slate_update.launches,
                  **{r: n - served_lookups[r] for r, n in
                     lk.slate_lookup.launches_by_route.items()}}
        c_run = calls()
        marks.append(("rank run, served", time.perf_counter()))
        # the readers' last requests, answered at the run's last boundary
        stop.set()
        while any(r.is_alive() for r in readers):
            h.drain()
            time.sleep(0.001)
        empty_ms = []
        for _ in range(20):
            t1 = time.perf_counter()
            if h.drain():
                raise AssertionError("19: an empty drain read something")
            empty_ms.append((time.perf_counter() - t1) * 1e3)
        askers = [threading.Thread(target=lambda p=p: final.update(
            {p: timed_get(srv.port, p, final_waits)})) for p in paths]
        for a in askers:
            a.start()
        wait_queued(h, len(paths), "requests after the run")
        h.close()
        for a in askers:
            a.join()
        check_drains(drains)
        marks.append(("served reads", time.perf_counter()))
        same_tree(SHARDED_AT["state"], state,
                  f"19 state after {ticks} ticks against 15a's")
        backlog = sum(int(q.size.sum()) for q in state["queues"].values())
        state, reps = reconfigure(eng, state)
        c_scale = calls()
        scaled = tree_map(torch.clone, state)
        state, drained = eng.drain(state)
        c_drain = calls()
        reads, single = read_all(eng, state, read_keys, singles)
    launches = {"slate_update": uk.slate_update.launches,
                "slate_lookup": lk.slate_lookup.launches}
    launches["slate_lookup routes"] = check_lookup_routes("ranks",
                                                          torch_calls)
    marks.append(("scale, drain, reads", time.perf_counter()))

    # the reference: 15a's engine (no group) from its state at this tick
    ref_eng = SHARDED_AT.pop("eng")
    ref_state = SHARDED_AT.pop("state")
    ref_h = StateHandle(ref_eng, ref_state)
    ref_srv = ref_h.serve()
    want = {p: http_get(ref_srv.port, p) for p in paths}
    ref_h.close()
    check_served(live, final, want, paths, ticks, eng.cfg.chunk_size)
    marks.append(("15a's reads served", time.perf_counter()))
    ref_state, ref_reps = reconfigure(ref_eng, ref_state)
    same_tree(ref_state, scaled, "19 state after scale 8 -> 4 -> 8")
    del scaled
    ref_state, ref_drained = ref_eng.drain(ref_state)
    same_tree(ref_state, state, "19 state after the drain")
    ref_reads, ref_single = read_all(ref_eng, ref_state, read_keys, singles)
    for u in ("U1", "U2"):
        same_reads(ref_reads[u], reads[u], f"19 read_slates {u}")
    for k in singles:
        same_reads(ref_single[k], single[k], f"19 read_slate {k}")
    ref_stats = sharded_stats(ref_eng, ref_state)
    stats = sharded_stats(eng, state)
    moved = [(r.moved_rows, r.moved_events) for r in reps]
    if stats != ref_stats or drained != ref_drained or \
            moved != [(r.moved_rows, r.moved_events) for r in ref_reps] or \
            list(eng.ring.weights) != list(ref_eng.ring.weights):
        raise AssertionError(f"phase 19: stats, drain, moves or ring "
                             f"differ: {stats} {ref_stats} {moved}")
    del ref_eng, ref_state, ref_reads, ref_single
    torch.cuda.empty_cache()
    if at_run != SHARDED_AT["launches_at"]:
        raise AssertionError(f"phase 19: launches over {ticks} ticks "
                             f"{at_run}, 15a's {SHARDED_AT['launches_at']}")
    check_sharded_launches(f"ranks path, {ticks} ticks", {
        "slate_update": at_run["slate_update"], "slate_lookup routes": {
            r: at_run[r] for r in ("cand", "keys", "find")}}, ticks, 0)
    # a fed tick's hops: S1 -> M1, S2 -> U1, S2 -> U2; a drain tick has
    # no source, so the last two; a device-tier reconfigure one for each
    # updater's rows and each operator's queue
    hops = (c_run["all_to_all_single"],
            c_scale["all_to_all_single"] - c_run["all_to_all_single"],
            c_drain["all_to_all_single"] - c_scale["all_to_all_single"])
    want = (3 * ticks, len(RANK_SCALE) * n_ops, 2 * drained)
    if hops != want:
        raise AssertionError(f"phase 19: all_to_all_single calls (run, "
                             f"reconfigures, drain) {hops}, expected {want}")
    if calls()["all_gather"] - c_drain["all_gather"] < 2 + 2 * len(singles):
        raise AssertionError(f"phase 19: reads gathered {calls()}")
    for rep in reps:
        if rep.path != "device" or rep.recompiled:
            raise AssertionError(f"phase 19: scale took {rep.path}")
    ev = [sum(r.moved_events.values()) for r in reps]
    rows = [sum(r.moved_rows.values()) for r in reps]
    if not (backlog and rows[0] and ev[0] and drained):
        raise AssertionError(f"phase 19: the leave moved rows {rows} and "
                             f"events {ev} of a backlog of {backlog}, "
                             f"drain {drained} ticks")
    if stats["exchange_dropped"]:
        raise AssertionError(f"phase 19: the exchange dropped "
                             f"{stats['exchange_dropped']} events")
    _, gen_tick = make_source(zipf_cdf(dev), B, seed)
    check_elastic_slates(eng, state, reference(gen_tick, ticks), read_keys,
                         reads, "ranks", ticks * B)
    marks.append(("reference and comparisons", time.perf_counter()))
    log(f"19 ranks: {ticks} ticks bitwise equal to 15a's state after its "
        f"first {ticks}, launches exactly 15a's {at_run}; all_to_all_single "
        f"calls (run, reconfigures, drain) {hops} (one a hop), the path's "
        f"collectives {calls()}; with a backlog of {backlog} queued events, "
        f"scale 8 -> 4 -> 8 on the device tier, then a drain of {drained} "
        f"ticks and the reads, each bitwise what 15a's engine gives from "
        f"its own state (moved rows {rows}, events {ev}, pauses "
        f"{[round(r.pause_s, 4) for r in reps]} s); the path's launches "
        f"{launches}")
    log(f"19 served: {len(live)} HTTP answers during the run (a reader a "
        f"path of {len(paths)}: /slate x {len(singles)}, /slates of "
        f"{len(read_keys)} keys, /status, /metrics) from {in_run} drains "
        f"at the chunk boundaries, at source ticks "
        f"{sorted({int(t) for _, _, t, _ in live})}, the keys' sums never "
        f"falling; {len(paths)} queued after the run, answered by "
        f"close()'s drain at tick {ticks}; every answer at tick {ticks} "
        f"byte for byte 15a's engine's from its kept state; drains "
        f"{len(drains)}, broadcasts {sum(d['broadcast'] for d in drains)} "
        f"(1 an empty drain, 2 otherwise), all_gathers "
        f"{sum(d['all_gather'] for d in drains)} (one a read), lookups "
        f"{ {r: n for r, n in served_lookups.items() if n} } during the "
        f"run; {card}")
    log(f"19 served: an empty drain {percentile(empty_ms, 50):.4f} ms "
        f"(min {min(empty_ms):.4f}, max {max(empty_ms):.4f}) over "
        f"{len(empty_ms)}; a read's HTTP round trip (enqueue to answer "
        f"and the request's own time) p50 "
        f"{percentile(waits, 50) * 1e3:.3f} ms, p99 "
        f"{percentile(waits, 99) * 1e3:.3f} ms over {len(waits)} "
        f"reads during the run (the batch after it: p50 "
        f"{percentile(final_waits, 50) * 1e3:.3f} ms, p99 "
        f"{percentile(final_waits, 99) * 1e3:.3f} ms over "
        f"{len(final_waits)}); a non-empty drain "
        f"{percentile([d['ms'] for d in drains if d['reads']], 50):.3f} ms "
        f"p50 over {sum(1 for d in drains if d['reads'])}; {card}")
    log(f"19 ranks: {tick_s * 1e3:.3f} ms/tick on the group of one over "
        f"{ticks} ticks, served over HTTP meanwhile, 15a's {SHARDED_AT['tick_s_at'] * 1e3:.3f} over the "
        f"same {ticks} (and {SHARDED_AT['tick_s'] * 1e3:.3f} over all its "
        f"ticks); {card}")

    # where the time goes: one profiled chunk of the rank path, the
    # exchange (the collective inside it) as a range
    ranges = {"exchange": 0.0}
    real = dist.exchange

    def annotated(*a, **kw):
        with torch.profiler.record_function("exchange"):
            return real(*a, **kw)

    dist.exchange = annotated
    try:
        prof = profile_ticks(eng, state, src, ticks, tick_s, n=2,
                             start_kw="start_tick", ranges=ranges)
    finally:
        dist.exchange = real
    marks.append(("profile", time.perf_counter()))
    p15 = SHARDED_AT.get("prof")
    if prof:
        log(f"19 ranks, profiled: {prof[1]:.1f} device operations and "
            f"{prof[0]:.4f} busy ms a tick, the exchange "
            f"{ranges['exchange']:.4f} ms; 15a's "
            + (f"{p15[1]:.1f} and {p15[0]:.4f}" if p15 else "not measured")
            + f"; {card}")
    # the collective alone at the widest hop's size (M1's emitted
    # [8, 32,768] batches to U1: [8, 8 * cap] cells of 45 bytes, each
    # row padded to 48)
    cells = SHARDS * eng.cap_per_dest
    row = cells * (4 + 4 + 4 + 4 * D + 1)
    buf = torch.zeros((SHARDS, row + -row % 4), dtype=torch.uint8,
                      device=dev)
    out = torch.empty_like(buf)
    a2a_ms = device_ms(lambda: tdist.all_to_all_single(out, buf,
                                                       group=group))
    log(f"19 all_to_all_single alone, {buf.numel() / 2**20:.1f} MiB at the "
        f"widest hop: {a2a_ms:.5f} ms device time (a world of one: a "
        f"local copy on the card, nothing of a network); {card}")
    marks.append(("collective alone", time.perf_counter()))
    log(f"ranks: the phase took {time.perf_counter() - t_phase:.1f} s "
        f"wall (" + ", ".join(f"{name} {t - t0:.1f} s" for (_, t0), (name, t)
                              in zip(marks, marks[1:])) + f"); {card}")
    del eng, state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 20
# The kernel routes across ranks at full width, R ranks emulated on the
# one card (NCCL refuses two ranks on one card): whole tensors cut into R
# slices, the route's own local half (the kernel) on each slice at its
# offset, the partials stacked as the all-gather gives them, and the
# route's own merge (``decode_attention/ops.merge``, ``ssd/ops.fold``,
# the sum of the stacked partials), held against the whole-tensor kernel and the plain
# version.  R = 2, and 16 (the production mesh's "model" axis).
RANKS_R = (2, 16)
# decode: 8 requests over a 32,768-row bf16 cache, ragged lengths;
# (label, H, Hkv, head dim, window)
RANKS_DECODE = (("gemma3-1b local 4/1 heads of 256, window 512", 4, 1, 256,
                 512),
                ("gemma3-1b global 4/1 heads of 256", 4, 1, 256, 0),
                ("qwen2-0.5b 14/2 heads of 64", 14, 2, 64, 0))
RANKS_CACHE = 32768
# zamba2-1.2b's Mamba-2 scan (64 heads, N = P = 64, chunk 256) and its
# norms (d_model 2048) over 8 x 4,096 tokens
RANKS_SSD = dict(B=8, S=4096, H=64, N=64, P=64, chunk=256)
RANKS_RMS = (8 * 4096, 2048)
RANKS_REPS = 10


def slices(n, R):
    """(offset, length) of each rank's piece of a dim of ``n``, as
    ``Shard`` cuts it (``torch.chunk``: the last pieces shorter)."""
    size = -(-n // R)
    return [(o, min(size, n - o)) for o in range(0, n, size)]


# split-K's limits, tighter than the kernels' absolute 2e-2 (which the
# long rows' outputs, ~sqrt(e / n) ~ 0.01, do not exceed): o within 2**-6
# of each (request, head) row's largest magnitude (a bf16 ulp is at most
# 2**-7 of a value; the plain version's bf16 probabilities add well under
# 2**-8 of the row), and the merged log-sum-exp within 1e-3 of 1 + its
# magnitude (the card tests' bf16 limit).  A merge that drops one rank's
# partial at R = 16 moves a long row's o by ~1/16 of its scale and its
# lse by log(16/15) ~ 0.065: both far outside.
SPLIT_K_ROW_TOL = 2.0**-6
SPLIT_K_LSE_TOL = 1e-3


def split_k_errors(got, lse, want, want_lse):
    """(max abs error, worst error over its row's limit, worst lse error
    over its limit) of split-K's ``(o, lse)`` against ``(want,
    want_lse)``: o ``[B, 1, H, Dv]``, lse ``[B, 1, H]``."""
    import torch
    err = (got.float() - want.float()).abs()
    row = want.float().abs().amax(-1, keepdim=True)
    seen = torch.isfinite(want_lse)
    if not torch.equal(seen, torch.isfinite(lse)):
        raise AssertionError("split-K: rows with and without a key differ")
    lerr = ((lse - want_lse).abs() / (1 + want_lse.abs()))[seen]
    return (float(err.max()),
            float((err / (SPLIT_K_ROW_TOL * row).clamp_min(1e-30)).max()),
            float(lerr.max()) / SPLIT_K_LSE_TOL)


def ranks_decode(dev, gen, label, H, Hkv, Dh, window):
    """One decode shape through the split-K route at each R."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dr
    B, S, bf16 = 8, RANKS_CACHE, torch.bfloat16
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(bf16)
    q, kc, vc = r(B, 1, H, Dh), r(B, S, Hkv, Dh), r(B, S, Hkv, Dh)
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    # both ends, one inside rank 0's slice at both R, and one whose
    # window and whole span straddle the half (R = 2) and slice 8 of 16
    lens[0], lens[1], lens[2], lens[3] = 1, S, 700, S // 2 + 200
    whole = dk.decode_attention(q, kc, vc, lens, window=window)
    plain = dr.decode_attend(q, kc, vc, lens, window=window)
    # the whole cache's log-sum-exp, from the kernel and the plain version
    whole_lse = dk.decode_attention(q, kc, vc, lens, window=window,
                                    partial=True)[1]
    plain_lse = dr.decode_attend(q, kc, vc, lens, window=window,
                                 partial=True)[1]
    tol = attn_tol(bf16)
    rows = int((lens.clamp(max=window) if window else lens).sum())
    # q read once, each visible cache row once, o written once, lengths
    nbytes = 2 * q.numel() * 2 + rows * Hkv * 2 * Dh * 2 + B * 4
    whole_ms = device_ms(lambda: dk.decode_attention(q, kc, vc, lens,
                                                     window=window),
                         reps=RANKS_REPS)
    out = {}
    for R in RANKS_R:
        parts = slices(S, R)

        def local(o, n):
            return dk.decode_attention(q, kc[:, o:o + n], vc[:, o:o + n],
                                       lens, window=window, partial=True,
                                       seq_offset=o, seq_total=S)

        def route():
            ps = [local(o, n) for o, n in parts]
            o, lse = dops.merge(torch.stack([p[0] for p in ps]),
                                torch.stack([p[1] for p in ps]))
            return o.to(q.dtype), lse
        torch.cuda.synchronize()
        n0 = dk.decode_attention.partial_launches
        got, lse = route()
        torch.cuda.synchronize()
        launches = dk.decode_attention.partial_launches - n0
        if launches != len(parts):
            raise AssertionError(f"decode_attention split-K R={R}: "
                                 f"{launches} partial launches, expected "
                                 f"{len(parts)}")
        err_k, row_k, lse_k = split_k_errors(got, lse, whole, whole_lse)
        err_p, row_p, lse_p = split_k_errors(got, lse, plain, plain_lse)
        worst = max(row_k, row_p, lse_k, lse_p)
        if not (err_k < tol and err_p < tol and worst <= 1
                and got.dtype == q.dtype
                and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(
                f"decode_attention split-K {label} R={R}: max_abs_err "
                f"{err_k} / {err_p} against the whole kernel / the plain "
                f"version (tolerance {tol}); of the limits "
                f"({SPLIT_K_ROW_TOL} of a row's max, lse "
                f"{SPLIT_K_LSE_TOL} of 1 + |lse|): o {row_k} / {row_p}, "
                f"lse {lse_k} / {lse_p}")
        same_bits(f"decode_attention split-K R={R}",
                  lambda: torch.cat([t.float().flatten() for t in route()]))
        stacked = [local(o, n) for o, n in parts]
        gathered = (torch.stack([p[0] for p in stacked]),
                    torch.stack([p[1] for p in stacked]))
        # a rank's own work: its slice's partial, then the merge of the
        # gathered partials; the slowest rank's (the ranks' visible rows
        # differ with the lengths and the window)
        local_ms = [device_ms(lambda p=p: local(*p), reps=RANKS_REPS)
                    for p in parts]
        merge_ms = device_ms(lambda: dops.merge(*gathered), reps=RANKS_REPS)
        route_ms = device_ms(route, reps=RANKS_REPS)
        out[R] = {"max_abs_err": max(err_k, err_p),
                  "of_limits": {"o": max(row_k, row_p),
                                "lse": max(lse_k, lse_p)},
                  "launches": launches,
                  "ms": max(local_ms) + merge_ms, "merge_ms": merge_ms,
                  "slowest_rank": local_ms.index(max(local_ms)),
                  "all_ranks_ms": route_ms}
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"20 decode_attention split-K, {label}: B=8 over a {S}-row bf16 "
        f"cache, lengths {sorted(lens.tolist())}: "
        + "; ".join(f"R={R} max_abs_err {v['max_abs_err']} (whole kernel "
                    f"and plain, tolerance {tol}; of the limits "
                    f"{SPLIT_K_ROW_TOL} of a row's max and lse "
                    f"{SPLIT_K_LSE_TOL} of 1 + |lse|: o "
                    f"{v['of_limits']['o']}, lse {v['of_limits']['lse']}), "
                    f"{v['launches']} partial "
                    f"launches, the slowest rank ({v['slowest_rank']}) "
                    f"{v['ms']:.5f} ms (its slice, and the merge "
                    f"{v['merge_ms']:.5f}), all R slices and the merge on "
                    f"one card "
                    f"{v['all_ranks_ms']:.5f} ms" for R, v in out.items())
        + f"; the whole-tensor kernel {whole_ms:.5f} ms; bound "
        f"{bound_ms:.6f} ms ({nbytes} bytes at 3.35 TB/s; device time, "
        f"torch.profiler, mean of {RANKS_REPS}); two calls bitwise equal")
    return out, whole_ms, bound_ms


def ranks_ssd(dev, gen):
    """zamba2's scan through the carried-state route at each R."""
    import torch
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd import ref as sr
    from repro_torch.kernels.ssd_scan import kernel as sk
    c = RANKS_SSD
    B, S, H, N, P, L = (c[k] for k in ("B", "S", "H", "N", "P", "chunk"))
    bf16 = torch.bfloat16
    rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    q = rn(B, S, 1, N).to(bf16).expand(B, S, H, N)
    k = (rn(B, S, 1, N) * 0.3).to(bf16).expand(B, S, H, N)
    v = rn(B, S, H, P).to(bf16)
    # Mamba-2's decay: softplus(dt) * -exp(a_log), here ~0.01-0.05 a step
    la = -0.03 * torch.nn.functional.softplus(rn(B, S, H))
    wy, wfin = sk.ssd_scan(q, k, v, la, chunk=L)
    py, pfin = sr.ssd(q, k, v, la, chunk=L)
    whole_ms = device_ms(lambda: sk.ssd_scan(q, k, v, la, chunk=L),
                         reps=RANKS_REPS)
    nbytes = (2 * B * S * N * 2 + B * S * H * P * 2 + B * S * H * 4
              + B * S * H * P * 2 + B * H * N * P * 4)
    out = {}
    for R in RANKS_R:
        parts = slices(S, R)
        sl = lambda t, o, n: t[:, o:o + n]

        def first(o, n):
            y, fin = sk.ssd_scan(sl(q, o, n), sl(k, o, n), sl(v, o, n),
                                 sl(la, o, n), chunk=L)
            return y, fin, torch.exp(sl(la, o, n).sum(1))

        def route():
            ps = [first(o, n) for o, n in parts]
            F = torch.stack([p[1] for p in ps])
            A = torch.stack([p[2] for p in ps])
            ys = [ps[0][0]]
            for r, (o, n) in enumerate(parts[1:], 1):
                h0 = sops.fold(F, A, r)[0]
                ys.append(sk.ssd_scan(sl(q, o, n), sl(k, o, n), sl(v, o, n),
                                      sl(la, o, n), chunk=L,
                                      initial_state=h0)[0])
            return torch.cat(ys, 1), sops.fold(F, A, 0)[2]
        torch.cuda.synchronize()
        n0 = (sk.ssd_scan.launches, sk.ssd_scan.partial_launches,
              sk.ssd_scan.launches_by_route["mma"])
        y, fin = route()
        torch.cuda.synchronize()
        launches = sk.ssd_scan.launches - n0[0]
        moved = (sk.ssd_scan.partial_launches - n0[1],
                 sk.ssd_scan.launches_by_route["mma"] - n0[2])
        if (launches, moved) != (2 * len(parts) - 1,
                                 (len(parts) - 1, 2 * len(parts) - 1)):
            raise AssertionError(f"ssd_scan carried state R={R}: {launches}"
                                 f" launches ({moved[0]} from a state, "
                                 f"{moved[1]} on mma), expected "
                                 f"{2 * len(parts) - 1}, all mma")
        errs = {}
        for what, (wy_, wf_) in (("whole kernel", (wy, wfin)),
                                 ("plain", (py, pfin))):
            ey = float((y.float() - wy_.float()).abs().max()) / (
                float(wy_.float().abs().max()) + 1)
            ef = float((fin - wf_).abs().max()) / (float(wf_.abs().max())
                                                    + 1)
            if not (ey < attn_tol(bf16) and ef < 5e-4 and y.dtype == bf16
                    and bool(torch.isfinite(y.float()).all())):
                raise AssertionError(f"ssd_scan carried state R={R}: y "
                                     f"{ey}, final state {ef} of max + 1 "
                                     f"against the {what}")
            errs[what] = (ey, ef)
        same_bits(f"ssd_scan carried state R={R}",
                  lambda: torch.cat([t.float().flatten() for t in route()]))
        last = parts[-1]
        ps = [first(o, n) for o, n in parts]
        F = torch.stack([p[1] for p in ps])
        A = torch.stack([p[2] for p in ps])

        def rank_last():           # the last rank: two scans and the fold
            first(*last)
            h0 = sops.fold(F, A, len(parts) - 1)[0]
            return sk.ssd_scan(sl(q, *last), sl(k, *last), sl(v, *last),
                               sl(la, *last), chunk=L, initial_state=h0)
        rank_ms = device_ms(rank_last, reps=RANKS_REPS)
        route_ms = device_ms(route, reps=RANKS_REPS)
        out[R] = {"max_abs_err": max(e[0] for e in errs.values()),
                  "state_err": max(e[1] for e in errs.values()),
                  "launches": launches, "ms": rank_ms,
                  "all_ranks_ms": route_ms}
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"20 ssd_scan carried state, zamba2's scan B={B} S={S} H={H} "
        f"N=P={N} chunk {L} bf16 (q, k head-broadcast): "
        + "; ".join(f"R={R} y {v['max_abs_err']}, state {v['state_err']} "
                    f"of max + 1 (whole kernel and plain; tolerance 2e-2, "
                    f"5e-4), {v['launches']} launches on mma, the last rank "
                    f"{v['ms']:.5f} ms (two scans of its slice and the "
                    f"fold), all R slices on one card "
                    f"{v['all_ranks_ms']:.5f} ms" for R, v in out.items())
        + f"; the whole-tensor kernel {whole_ms:.5f} ms; bound "
        f"{bound_ms:.6f} ms ({nbytes} bytes at 3.35 TB/s; device time, "
        f"torch.profiler, mean of {RANKS_REPS}); two calls bitwise equal")
    return out, whole_ms, bound_ms


def ranks_rmsnorm(dev, gen):
    """zamba2's norms over a row split R ways, forward and backward."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rr
    rows, D = RANKS_RMS
    bf16 = torch.bfloat16
    x = torch.randn(rows, D, generator=gen, device=dev).to(bf16)
    dy = torch.randn(rows, D, generator=gen, device=dev).to(bf16)
    w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
    wy = rk.rmsnorm(x, w)
    wg = rk.rmsnorm_bwd(x, w, dy)
    py = rr.rmsnorm(x, w)
    pg = rr.rmsnorm_bwd(x, w, dy)
    whole_ms = device_ms(lambda: rk.rmsnorm(x, w), reps=RANKS_REPS)
    whole_bwd_ms = device_ms(lambda: rk.rmsnorm_bwd(x, w, dy),
                             reps=RANKS_REPS)
    out = {}
    for R in RANKS_R:
        parts = slices(D, R)
        # each rank's columns, contiguous as its shard is
        xs = [x[:, o:o + n].contiguous() for o, n in parts]
        dys = [dy[:, o:o + n].contiguous() for o, n in parts]
        ws = [w[o:o + n].contiguous() for o, n in parts]

        def fwd():
            ss = torch.stack([rk.rmsnorm_sums(a) for a in xs]).sum(0)
            return torch.cat([rk.rmsnorm(a, b, ss=ss, d_norm=D)
                              for a, b in zip(xs, ws)], 1)

        def bwd():
            st = torch.stack([rk.rmsnorm_sums(a, b, g)
                              for a, b, g in zip(xs, ws, dys)]).sum(0)
            gs = [rk.rmsnorm_bwd(a, b, g, sums=st, d_norm=D)
                  for a, b, g in zip(xs, ws, dys)]
            return (torch.cat([g[0] for g in gs], 1),
                    torch.cat([g[1] for g in gs]))
        torch.cuda.synchronize()
        n0 = (rk.rmsnorm_sums.launches, rk.rmsnorm.partial_launches,
              rk.rmsnorm_bwd.partial_launches)
        y = fwd()
        g = bwd()
        torch.cuda.synchronize()
        launches = (rk.rmsnorm_sums.launches - n0[0],
                    rk.rmsnorm.partial_launches - n0[1],
                    rk.rmsnorm_bwd.partial_launches - n0[2])
        if launches != (2 * len(parts), len(parts), len(parts)):
            raise AssertionError(f"rmsnorm split row R={R}: launches "
                                 f"(sums, forward, backward) {launches}")
        err = max(rms_close(y, wy), rms_close(y, py))
        gerr = max(check_grads_close(f"rmsnorm_bwd split row R={R}", g, wg),
                   check_grads_close(f"rmsnorm_bwd split row R={R}", g, pg))
        same_bits(f"rmsnorm split row R={R}", fwd)
        same_bits(f"rmsnorm_bwd split row R={R}",
                  lambda: torch.cat([t.float().flatten() for t in bwd()]))
        ss = torch.stack([rk.rmsnorm_sums(a) for a in xs]).sum(0)
        st = torch.stack([rk.rmsnorm_sums(a, b, g)
                          for a, b, g in zip(xs, ws, dys)]).sum(0)
        parts_ss = torch.stack([ss] * len(parts))
        parts_st = torch.stack([st] * len(parts))
        # a rank's own work: its columns' sums, the sum of the gathered
        # partials and its normalise (or backward) pass
        rank_ms = device_ms(lambda: (rk.rmsnorm_sums(xs[0]),
                                     rk.rmsnorm(xs[0], ws[0],
                                                ss=parts_ss.sum(0),
                                                d_norm=D)), reps=RANKS_REPS)
        rank_bwd_ms = device_ms(lambda: (
            rk.rmsnorm_sums(xs[0], ws[0], dys[0]),
            rk.rmsnorm_bwd(xs[0], ws[0], dys[0], sums=parts_st.sum(0),
                           d_norm=D)), reps=RANKS_REPS)
        out[R] = {"max_abs_err": err, "grad_err": gerr,
                  "launches": launches, "ms": rank_ms,
                  "all_ranks_ms": device_ms(fwd, reps=RANKS_REPS),
                  "bwd_ms": rank_bwd_ms,
                  "bwd_all_ranks_ms": device_ms(bwd, reps=RANKS_REPS)}
        del xs, dys, ws, parts_ss, parts_st
    bound_ms = (2 * rows * D * 2 + D * 4) / HBM_BYTES_PER_S * 1e3
    bwd_bound_ms = (3 * rows * D * 2 + 2 * D * 4) / HBM_BYTES_PER_S * 1e3
    log(f"20 rmsnorm split row, zamba2's [{rows}, {D}] bf16: "
        + "; ".join(f"R={R} max_abs_err {v['max_abs_err']} (one bf16 ulp "
                    f"of each value, whole kernel and plain), gradients "
                    f"{v['grad_err']} (2**-5 of max), launches (sums, "
                    f"forward, backward) {v['launches']}, a rank forward "
                    f"{v['ms']:.5f} ms / backward {v['bwd_ms']:.5f} ms, all "
                    f"R on one card {v['all_ranks_ms']:.5f} / "
                    f"{v['bwd_all_ranks_ms']:.5f} ms" for R, v in out.items())
        + f"; the whole-tensor kernels {whole_ms:.5f} / {whole_bwd_ms:.5f} "
        f"ms; bounds {bound_ms:.6f} / {bwd_bound_ms:.6f} ms (bytes at 3.35 "
        f"TB/s; device time, torch.profiler, mean of {RANKS_REPS}); two "
        f"calls bitwise equal")
    return (out, whole_ms, bound_ms, whole_bwd_ms, bwd_bound_ms)


def kernel_ranks_path(dev, seed, card):
    """Phase 20.  Returns (the launches of its checked route runs by
    kernel, each kernel row's ``routes`` entries)."""
    import torch
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    routes = {"decode_attention": {}, "ssd_scan": {}, "rmsnorm": {},
              "rmsnorm_bwd": {}}
    launches = dict.fromkeys(routes, 0)
    for label, H, Hkv, Dh, window in RANKS_DECODE:
        out, whole_ms, bound_ms = ranks_decode(dev, gen, label, H, Hkv, Dh,
                                               window)
        for R, v in out.items():
            launches["decode_attention"] += v["launches"]
            routes["decode_attention"][f"split-K R={R}, {label}"] = dict(
                v, whole_ms=whole_ms, bound_ms=bound_ms, bound_by="bytes",
                card=card)
        torch.cuda.empty_cache()
    out, whole_ms, bound_ms = ranks_ssd(dev, gen)
    for R, v in out.items():
        launches["ssd_scan"] += v["launches"]
        routes["ssd_scan"][f"carried state R={R}"] = dict(
            v, whole_ms=whole_ms, bound_ms=bound_ms, bound_by="bytes",
            card=card)
    torch.cuda.empty_cache()
    out, whole_ms, bound_ms, whole_bwd_ms, bwd_bound_ms = ranks_rmsnorm(
        dev, gen)
    for R, v in out.items():
        sums, fwd, bwd = v["launches"]
        launches["rmsnorm"] += fwd
        launches["rmsnorm_bwd"] += bwd
        routes["rmsnorm"][f"split row R={R}"] = {
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "all_ranks_ms": v["all_ranks_ms"], "whole_ms": whole_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "launches": fwd, "rmsnorm_sums_launches": sums // 2,
            "card": card}
        routes["rmsnorm_bwd"][f"split row R={R}"] = {
            "max_abs_err": v["grad_err"], "ms": v["bwd_ms"],
            "all_ranks_ms": v["bwd_all_ranks_ms"], "whole_ms": whole_bwd_ms,
            "bound_ms": bwd_bound_ms, "bound_by": "bytes", "launches": bwd,
            "rmsnorm_sums_launches": sums // 2, "card": card}
    torch.cuda.empty_cache()
    log(f"20: the routes' launches {launches}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return launches, routes


# ---------------------------------------------------------------- phase 21
# The paper's two chained-updater applications (examples/torch_hot_topics.py
# and examples/torch_reputation.py), each G copies of the example's stream
# side by side in one key space, so each key sees the example's own rates:
# 21a at G = 128 (65,536 tweets a tick over 2,048 topics), 21b at G = 128
# with 1,048,576 users (640 celebrities) and 2**22 slots; gate (a) runs
# each at G = 8 on the card and on the CPU.
APPS = {"groups": 128, "small": 8, "users": 1 << 20, "capacity": 1 << 22}
# 21a leaves out the U1 keys a tweet whose top two topic scores lie within
# this of each other could have gone to (a rounding of the product may
# flip its argmax)
NEAR_TIE = 1e-3


def example(name):
    """The module ``examples/<name>.py`` of this checkout."""
    import importlib.util
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cpu_limits():
    """The CPUs this process may use, as each layer states them: torch's
    intra-op threads, ``os.cpu_count()``, the affinity mask and the
    cgroup's CPU quota (``/sys/fs/cgroup/cpu.max``; None without one)."""
    import os
    import torch
    quota = None
    path = Path("/sys/fs/cgroup/cpu.max")
    if path.exists():
        q, period = path.read_text().split()[:2]
        if q != "max":
            quota = int(q) / int(period)
    return {"torch threads": torch.get_num_threads(),
            "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "cgroup quota": quota}


@contextmanager
def cpu_threads():
    """torch's CPU thread count set to the least of ``cpu_limits()`` (a
    quota rounded down, at least 1) while the block runs, then restored.
    A guard, not a measured cure: a thread count above a cgroup quota
    makes torch's CPU runs spin against each other, but no host seen so
    far had a quota, and there the count is the one torch already had."""
    import math
    import torch
    n = max(1, min(math.floor(v) for v in cpu_limits().values()
                   if v is not None))
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield n
    finally:
        torch.set_num_threads(saved)


def settle(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_clean(stats, fed, ops, what):
    """No queue or table dropped anything, every queue is empty and each
    of ``ops`` processed ``fed`` events."""
    if any(stats["queue_dropped"].values()) or \
            any(stats["queue_size"].values()) or \
            any(stats["table_dropped"].values()):
        raise AssertionError(f"{what}: a queue or table dropped or kept "
                             f"events: {stats}")
    if any(stats["processed"][op] != fed for op in ops):
        raise AssertionError(f"{what}: processed {stats['processed']}, fed "
                             f"{fed}")


def hot_topics_reference(mod, topic_dirs, ticks):
    """21a's numpy reference: each tweet's U1 key from an f32 argmax of
    ``feat @ dirs.T`` (in row blocks), and the keys that a tweet whose
    top two scores lie within ``NEAR_TIE`` could have gone to."""
    import numpy as np
    w = np.ascontiguousarray(topic_dirs.T)
    keys, near = [], set()
    for t, d in enumerate(ticks):
        minute = t // mod.TICKS_PER_MINUTE
        for lo in range(0, d["feat"].shape[0], 8192):
            s = d["feat"][lo:lo + 8192] @ w
            top = s.argmax(1)
            best = s[np.arange(s.shape[0]), top]
            tie = np.count_nonzero(s >= (best - np.float32(NEAR_TIE))[:, None],
                                   axis=1) > 1
            keys.append(top * 100_000 + minute)
            for r in np.nonzero(tie)[0]:
                close = np.nonzero(s[r] >= best[r] - np.float32(NEAR_TIE))[0]
                log(f"21a near tie: tick {t}, row {lo + r}, topics "
                    f"{close.tolist()}, scores {s[r, close].tolist()}")
                near |= {int(c) * 100_000 + minute for c in close}
    return np.concatenate(keys), near


def hot_topics_emissions(mod, keys, per_tick):
    """U1's emissions from the feed alone.  A U1 key (topic, m) steps
    its tweets in strict ts order and emits on its first tweet of the
    minute's last tick 4m + 3 (the first whose minute has passed), the
    count then being its tweets of ticks 4m .. 4m + 2 plus one.
    ``keys``: each tweet's U1 key, ``per_tick`` tweets a tick.  Returns
    the sorted U1 keys, whether each emitted and the count it emitted
    (0 where none)."""
    import numpy as np
    n = mod.TICKS_PER_MINUTE
    last = np.arange(keys.size) // per_tick % n == n - 1
    uk, inv = np.unique(keys, return_inverse=True)
    before = np.bincount(inv[~last], minlength=uk.size)
    has = np.bincount(inv[last], minlength=uk.size) > 0
    return uk, has, np.where(has, before + 1, 0)


def hot_ratios(mod, uk, count):
    """U2's ``hot`` rows from U1's emissions (``hot_topics_emissions``):
    a topic's emissions in minute order, each in a U2 batch of its own
    (a topic's minutes close 4 ticks apart), each row's ratio by the
    example's ``hot_emit`` in f32 (the counts and their sums are exact
    integers there).  Returns {topic: [ratio_x100 of each hot row]}."""
    import numpy as np
    sel = count > 0
    topic, c = uk[sel] // 100_000, count[sel].astype(np.float32)
    out = {}
    for t in np.unique(topic):
        cur = c[topic == t]
        total = np.cumsum(cur, dtype=np.float32) - cur     # old["total"]
        periods = np.arange(cur.size, dtype=np.float32)   # old["periods"]
        avg = np.where(periods > 0, total / np.maximum(periods, 1), cur)
        ratio = cur / np.maximum(avg, np.float32(1e-6))
        hot = ratio > mod.HOT_THRESHOLD
        out[int(t)] = (ratio[hot] * np.float32(100)).astype(np.int32).tolist()
    return out


def check_hot_topics(mod, app, outs, topic_dirs, ticks, groups, what):
    """21a's gate (b), on the drained app, against numpy
    (``hot_topics_reference``, ``hot_topics_emissions``, ``hot_ratios``;
    the keys a near tie could move, and their topics, left out): every
    U1 ``count`` and ``emitted``, every U2 ``total`` (bitwise in f32) and
    every ``hot`` row's ``ratio_x100``, drain ticks included; every U2
    topic's ``periods`` the sum of ``emitted`` over its U1 keys, through
    the tables and through ``read_slates``; every group's burst topic
    surfaces as hot and is its group's most frequent hot topic; nothing
    dropped.  Returns the hot pairs."""
    import numpy as np
    fed = sum(d["key"].size for d in ticks)
    stats = app.stats()
    check_clean(stats, fed, ("M1", "U1"), what)
    keys, near = hot_topics_reference(mod, topic_dirs, ticks)
    want_k, want_n = np.unique(keys, return_counts=True)
    _, want_e, want_c = hot_topics_emissions(mod, keys, ticks[0]["key"].size)
    state = app.handle.state
    k1, v1 = table_rows(state, "U1")
    o1 = np.argsort(k1)
    k1, count, emitted = k1[o1], v1["count"][o1], v1["emitted"][o1]
    kept = ~np.isin(k1, list(near))
    kept_w = ~np.isin(want_k, list(near))
    if not (np.array_equal(k1[kept], want_k[kept_w])
            and np.array_equal(count[kept], want_n[kept_w])
            and np.array_equal(emitted[kept], want_e[kept_w])):
        raise AssertionError(f"{what}: U1 counts or emissions differ from "
                             f"numpy")
    topics = np.arange(mod.N_TOPICS * groups)
    periods = np.bincount(k1 // 100_000, weights=emitted,
                          minlength=topics.size).astype(np.int64)
    k2, v2 = table_rows(state, "U2")
    if not np.array_equal(np.sort(k2), np.nonzero(periods)[0]) or \
            not np.array_equal(v2["periods"], periods[k2]) or \
            stats["processed"]["U2"] != periods.sum():
        raise AssertionError(f"{what}: U2 periods differ from U1's "
                             f"emissions")
    near_t = {k // 100_000 for k in near}
    ok = ~np.isin(k2, list(near_t))
    total = np.bincount(want_k // 100_000, weights=want_c,
                        minlength=topics.size).astype(np.float32)
    if not np.array_equal(v2["total"][ok], total[k2[ok]]):
        raise AssertionError(f"{what}: U2 totals differ from numpy")
    found = mod.hot_pairs(outs)
    got = {int(t): [] for t in topics}
    for k, _, r in found:
        got[k].append(r)
    want = hot_ratios(mod, want_k, want_c)
    for t in topics:
        if t not in near_t and got[t] != want.get(int(t), []):
            raise AssertionError(f"{what}: topic {t}'s hot rows "
                                 f"{got[t]}, numpy {want.get(int(t))}")
    reads = app.handle.read_slates("U2", topics)
    burst = topics[mod.BURST_TOPIC::mod.N_TOPICS] * 100_000 + \
        mod.BURST_MINUTE
    reads1 = app.handle.read_slates("U1", burst)
    for t, row in zip(topics, reads):
        if (row is None) != (periods[t] == 0) or (
                row is not None and int(row["periods"]) != periods[t]):
            raise AssertionError(f"{what}: read_slates U2 {t}: {row}")
    at = dict(zip(k1.tolist(), count.tolist()))
    for k, row in zip(burst, reads1):
        if row is None or int(row["count"]) != at[int(k)]:
            raise AssertionError(f"{what}: read_slates U1 {k}: {row}")
    bad = mod.check_hot(found, groups)
    if bad:
        raise AssertionError(f"{what}: {bad[:4]}")
    log(f"{what}: {k1.size} U1 slates' counts and emissions equal numpy's "
        f"of {fed} tweets ({len(near)} keys left out for near ties), "
        f"{k2.size} U2 slates' periods equal U1's emissions "
        f"({int(periods.sum())}), through the tables and read_slates, and "
        f"{int(ok.sum())} U2 totals and those topics' hot rows numpy's "
        f"({len(near_t)} topics left out); {len(found)} hot pairs "
        f"({len(outs)} ticks, drain included), each of the {groups} burst "
        f"topics its group's most frequent; processed {stats['processed']}")
    return found


def replay_reputation(target, actor, order, n_users):
    """Each user's ``score`` and ``interactions`` from an f32 numpy
    replay of the events in stepping order, one round per event rank:
    round r steps every user's r-th event at once."""
    import numpy as np
    t, a = target[order], actor[order]
    by_user = np.argsort(t, kind="stable")
    tu = t[by_user]
    start = np.r_[True, tu[1:] != tu[:-1]]
    first = np.flatnonzero(start)
    rank = np.empty(t.size, np.int64)
    rank[by_user] = np.arange(t.size) - first[np.cumsum(start) - 1]
    by_rank = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[by_rank], np.arange(rank.max() + 2))
    score = np.zeros(n_users, np.float32)
    for r in range(rank.max() + 1):
        ev = by_rank[bounds[r]:bounds[r + 1]]
        u = t[ev]
        score[u] = (np.float32(0.95) * score[u] + np.float32(0.05) * a[ev]
                    + np.float32(0.01))
    return score, np.bincount(target, minlength=n_users)


def check_reputation(mod, app, ticks, groups, n_users, what):
    """21b's gate (b), on the drained app: every user's ``interactions``
    exact and ``score`` bitwise equal to an f32 numpy replay in the
    engine's queue order (``sequential_order``: a tick's 512 G mentions
    join U1's queue after M1's tick, U1 takes ``batch_size`` a tick and
    steps ``max_run`` a user, deferring the rest), through the table and
    ``read_slates``; the top 5 G scores are the celebrities'; nothing
    dropped."""
    import numpy as np
    target = np.concatenate([d["target"] for d in ticks])
    actor = np.concatenate([d["actor_score"] for d in ticks])
    per_tick = ticks[0]["target"].size
    fed = target.size
    stats = app.stats()
    check_clean(stats, fed, ("M1", "U1"), what)
    u1 = app.engine.wf.op_index("U1")
    up = app.engine.wf.operators[u1]
    order = sequential_order(
        target, np.repeat(np.arange(len(ticks)) + 1, per_tick),
        np.ones(fed, bool), per_tick, up.max_run,
        take=app.engine.cfg.batch_size)
    score, n = replay_reputation(target, actor, np.asarray(order), n_users)
    keys, vals = table_rows(app.handle.state, "U1")
    if not (np.array_equal(np.sort(keys), np.nonzero(n)[0])
            and np.array_equal(vals["interactions"], n[keys])):
        raise AssertionError(f"{what}: interactions differ from the feed")
    diff = np.abs(vals["score"] - score[keys])
    if not np.array_equal(vals["score"], score[keys]):
        raise AssertionError(f"{what}: {int((diff > 0).sum())} scores "
                             f"differ from the f32 replay, by up to "
                             f"{diff.max()}")
    celebs = mod.CELEBRITIES * groups
    top = keys[np.argsort(-vals["score"], kind="stable")[:celebs]]
    if set(top.tolist()) != set(range(celebs)):
        raise AssertionError(f"{what}: the top {celebs} scores are not the "
                             f"celebrities'")
    probe = np.r_[np.arange(celebs), keys[:64], n_users - 1]
    at = dict(zip(keys.tolist(), vals["score"].tolist()))
    for k, row in zip(probe, app.handle.read_slates("U1", probe)):
        if (row is None) != (int(k) not in at) or (
                row is not None and float(row["score"]) != at[int(k)]):
            raise AssertionError(f"{what}: read_slates U1 {k}: {row}")
    log(f"{what}: {keys.size} U1 slates' interactions exact and scores "
        f"bitwise the f32 replay of {fed} mentions in queue order "
        f"(deferred past max_run {up.max_run}: "
        f"{int(app.handle.state['deferred'])}); the top {celebs} are the "
        f"celebrities; processed {stats['processed']}")


def run_app(app, src, n_ticks, rt, dev):
    """``App.run`` over ``n_ticks``, then source-less ticks until every
    queue is empty (``drain=True``'s ticks, with their outputs kept);
    returns (every tick's outputs, run s, drain s)."""
    app.start(rt, device=dev)
    t0 = time.perf_counter()
    outs = app.run(src, n_ticks)
    settle(dev)
    t_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(64):
        if not any(app.stats()["queue_size"].values()):
            break
        outs += app.run(lambda tick, max_events: {}, 1)
    settle(dev)
    return outs, t_run, time.perf_counter() - t0


def check_card_equals_cpu(make, n_ticks, rt, dev, what):
    """Gate (a): the app of ``make(device) -> (app, source_fn)`` on the
    card and on the CPU (torch's threads bounded by ``cpu_threads``):
    the state, every tick's outputs and the stats bitwise equal.  Then a
    ``run_chunk`` of the card app's engine under the sync debug mode
    "error" (gate (d)).  Returns the walls."""
    import torch
    from repro_torch import convert
    from repro_torch.core.engine import stack_sources
    runs, walls = {}, {}
    for where, d in (("card", dev), ("CPU", torch.device("cpu"))):
        with (cpu_threads() if d.type == "cpu" else nullcontext()):
            t0 = time.perf_counter()
            app, src = make(d)
            outs, _, _ = run_app(app, src, n_ticks, rt, d)
            walls[where] = time.perf_counter() - t0
        runs[where] = app, src, outs
    (a, src, oa), (b, _, ob) = runs["card"], runs["CPU"]
    same_arrays(convert.state_to_numpy(a.handle.state),
                convert.state_to_numpy(b.handle.state), f"{what} state")
    for t, (x, y) in enumerate(zip(oa, ob, strict=True)):
        same_arrays(convert.to_plain(x), convert.to_plain(y),
                    f"{what} tick {t}'s outputs")
    if a.stats() != b.stats():
        raise AssertionError(f"{what}: stats differ card vs CPU")
    eng, state = a.engine, a.handle.state
    stacked = stack_sources([src(t, None) for t in range(2)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run_chunk(state, stacked)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{what}: state, {len(oa)} ticks' outputs and stats bitwise card = "
        f"CPU ({a.stats()['processed']}); a run_chunk of 2 ticks under "
        f"sync debug mode 'error': no host sync; walls card "
        f"{walls['card']:.2f} s, CPU {walls['CPU']:.2f} s "
        f"({cpu_limits()['torch threads']} torch threads outside it)")
    a.close()
    b.close()
    return walls


def reset_app_launches():
    from repro_torch.kernels.countmin import kernel as ck
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    for k in (uk.slate_update, lk.slate_lookup, ck.countmin_update,
              hk.histogram_update):
        k.launches = 0
    reset_lookup_routes()


def check_app_launches(what, app, torch_calls):
    """Gate (c): every ``insert_or_find`` walked ``find`` (INSERT_ROUNDS
    launches an updater a tick, drain ticks included), reads took
    ``keys``, nothing launched ``cand``, ``slate_update`` or the count
    kernels and no torch probe hash ran."""
    from repro_torch.kernels.countmin import kernel as ck
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.slates.table import INSERT_ROUNDS
    routes = check_lookup_routes(what, torch_calls)
    ticks = int(app.handle.state["tick"])
    n_up = len(app.engine.wf.updaters())
    others = {k.__name__: k.launches for k in (
        uk.slate_update, ck.countmin_update, hk.histogram_update)}
    if routes["find"] != ticks * n_up * INSERT_ROUNDS or any(
            others.values()):
        raise AssertionError(f"{what}: find launches {routes['find']} over "
                             f"{ticks} ticks of {n_up} updaters; other "
                             f"kernels {others}")
    log(f"{what}: slate_lookup find {routes['find']} = {ticks} ticks x "
        f"{n_up} updaters x {INSERT_ROUNDS}, keys {routes['keys']}; "
        f"{others} (none)")
    return {"slate_lookup": lk.slate_lookup.launches,
            "slate_lookup routes": routes}


def log_app_speed(what, fed, n_ticks, t_run, t_drain, phase5_tick_s, card):
    tick_s = t_run / n_ticks
    log(f"{what}: {n_ticks} ticks x {fed // n_ticks} events in "
        f"{t_run:.3f} s = {tick_s * 1e3:.3f} ms/tick, "
        f"{fed / t_run:.4e} events/s (numpy feed copied to the card "
        f"each tick), drain {t_drain:.3f} s; phase 5 "
        f"{phase5_tick_s * 1e3:.3f} ms/tick; {card}")
    return tick_s


def app_hot_topics_path(dev, seed, card, phase5_tick_s):
    """Phase 21a: hot topics at G = 128 through ``App.run`` and a drain;
    gates (a)-(d)."""
    import torch
    mod = example("torch_hot_topics")
    t_phase = time.perf_counter()
    n_ticks, small = mod.TICKS, APPS["small"]
    dirs, ticks = mod.make_feed(seed, n_ticks, small)

    def make(d):
        return (mod.build_app(dirs, groups=small, device=d),
                mod.source(ticks, d))
    check_card_equals_cpu(make, n_ticks, mod.runtime(small), dev,
                          f"21a at G = {small}")

    G = APPS["groups"]
    dirs, ticks = mod.make_feed(seed, n_ticks + 1, G)   # + the profile's
    app = mod.build_app(dirs, groups=G, device=dev)
    src = mod.source(ticks, dev)
    reset_app_launches()
    with torch_probe_calls() as torch_calls:
        outs, t_run, t_drain = run_app(app, src, n_ticks, mod.runtime(G),
                                       dev)
        check_hot_topics(mod, app, outs, dirs, ticks[:n_ticks], G,
                         f"21a at G = {G}")
    launches = check_app_launches("21a hot topics", app, torch_calls)
    tick_s = log_app_speed("21a hot topics", n_ticks * mod.N * G, n_ticks,
                           t_run, t_drain, phase5_tick_s, card)
    profile_ticks(app.engine, app.handle.state, src, n_ticks, tick_s, n=1)
    app.close()
    del app, outs
    torch.cuda.empty_cache()
    log(f"21a: the phase took {time.perf_counter() - t_phase:.1f} s wall")
    return launches


def app_reputation_path(dev, seed, card, phase5_tick_s):
    """Phase 21b: reputation over 1,048,576 users at G = 128 through
    ``App.run`` and a drain; gates (a)-(d)."""
    import torch
    mod = example("torch_reputation")
    t_phase = time.perf_counter()
    n_ticks, small = mod.TICKS, APPS["small"]
    ticks = mod.make_feed(seed, n_ticks, small)

    def make(d):
        return (mod.build_app(table_capacity=mod.TABLE_CAPACITY * small),
                mod.source(ticks, d))
    check_card_equals_cpu(make, n_ticks, mod.runtime(small), dev,
                          f"21b at G = {small}")

    G, users = APPS["groups"], APPS["users"]
    ticks = mod.make_feed(seed, n_ticks + 1, G, n_users=users)
    app = mod.build_app(table_capacity=APPS["capacity"])
    src = mod.source(ticks, dev)
    reset_app_launches()
    with torch_probe_calls() as torch_calls:
        _, t_run, t_drain = run_app(app, src, n_ticks, mod.runtime(G), dev)
        check_reputation(mod, app, ticks[:n_ticks], G, users,
                         f"21b at G = {G}")
    launches = check_app_launches("21b reputation", app, torch_calls)
    tick_s = log_app_speed("21b reputation", n_ticks * mod.N * G, n_ticks,
                           t_run, t_drain, phase5_tick_s, card)
    profile_ticks(app.engine, app.handle.state, src, n_ticks, tick_s, n=1)
    app.close()
    del app
    torch.cuda.empty_cache()
    log(f"21b: the phase took {time.perf_counter() - t_phase:.1f} s wall")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--durable-child", metavar="DIR",
                    help="run phase 12's crash run in DIR (phase 12 starts "
                    "this process itself)")
    ap.add_argument("--sharded-durable-child", metavar="DIR",
                    help="run phase 15d's crash run in DIR (phase 15d "
                    "starts this process itself)")
    ap.add_argument("--elastic-durable-child", metavar="DIR",
                    help="run phase 16d's crash run in DIR (phase 16d "
                    "starts this process itself)")
    ap.add_argument("--serve-child", metavar="DIR",
                    help="run phase 14d's crash run in DIR (phase 14d "
                    "starts this process itself)")
    ap.add_argument("--serve-recover", metavar="DIR",
                    help="run phase 14d's recovery in DIR (phase 14d "
                    "starts this process itself)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch next to this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.durable_child:
        durable_child(args.durable_child, args.seed)
    if args.sharded_durable_child:
        sharded_durable_child(args.sharded_durable_child, args.seed)
    if args.elastic_durable_child:
        elastic_durable_child(args.elastic_durable_child, args.seed)
    if args.serve_child:
        serve_child(args.serve_child, args.seed)
    if args.serve_recover:
        serve_recover(args.serve_recover, args.seed)
        return 0
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    log(f"host CPUs: {cpu_limits()}; the CPU runs of 15c, 16c and 21 take "
        f"the least of them as torch's threads")

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    libs = _build.build(["slate_update", "slate_lookup", "countmin",
                         "flash_attention", "flash_attention_bwd",
                         "decode_attention", "ssd_scan", "rmsnorm",
                         "rmsnorm_bwd"])
    log(f"built {sorted(libs)} with {_build.nvcc_path()} in "
        f"{time.perf_counter() - t0:.2f} s")

    walls = {}                     # each phase's wall, s

    def timed(phase, fn, *a):
        t = time.perf_counter()
        try:
            return fn(*a)
        finally:
            walls[phase] = walls.get(phase, 0.0) + time.perf_counter() - t

    t_run = time.perf_counter()
    entries = timed("3", lambda: [
        check_slate_update(dev, args.seed), *check_slate_lookup(dev, args.seed),
        check_countmin(dev, args.seed), check_histogram(dev, args.seed),
        check_flash_attention(dev, args.seed),
        check_decode_attention(dev, args.seed),
        check_ssd_scan(dev, args.seed), check_rmsnorm(dev, args.seed),
        check_flash_attention_bwd(dev, args.seed),
        check_rmsnorm_bwd(dev, args.seed)])
    torch.cuda.empty_cache()
    timed("4", check_no_host_sync, dev, args.seed)
    torch.cuda.empty_cache()
    # each path's launches, counted from 0 just before it runs
    by_path = {}
    by_path["main"], ref, off_s, off_prof = timed(
        "5", end_to_end, dev, args.ticks, args.seed, card)
    torch.cuda.empty_cache()
    by_path["telemetry"] = timed("6", telemetry_path, dev, args.ticks,
                                 args.seed, card, ref, off_s, off_prof)
    torch.cuda.empty_cache()
    for phase, arch in zip(("7", "8", "9", "10", "11"), SERVE_ARCHS):
        by_path[f"serving {arch}"] = timed(phase, serving_path, dev,
                                           args.seed, card, arch)
        torch.cuda.empty_cache()
    by_path["durable"] = timed("12", durable_path, dev, args.seed, card,
                               off_s)
    torch.cuda.empty_cache()
    by_path["app counting"] = timed("13", app_counting_path, dev, args.seed,
                                    card, off_s)
    by_path["app trends"] = timed("13", app_trends_path, dev, args.seed,
                                  card)
    by_path["app serving"] = timed("13", app_serving_path, dev, args.seed,
                                   card)
    torch.cuda.empty_cache()
    for arch in ENGINE:
        by_path[f"engine {arch}"] = timed("14", engine_path, dev, args.seed,
                                          card, arch)
        torch.cuda.empty_cache()
    timed("14", engine_journal, args.seed, card)
    torch.cuda.empty_cache()
    timed("15", check_sharded_no_host_sync, dev, args.seed)
    by_path["sharded"] = timed("15", sharded_path, dev, args.ticks,
                               args.seed, card, ref, (off_s, off_prof))
    torch.cuda.empty_cache()
    by_path["sharded hot"] = timed("15", sharded_hot_path, dev, args.seed,
                                   card)
    torch.cuda.empty_cache()
    timed("15", sharded_failover, dev, args.seed, card)
    torch.cuda.empty_cache()
    by_path["sharded durable"] = timed("15", sharded_durable_path, dev,
                                       args.seed, card)
    torch.cuda.empty_cache()
    timed("16", check_elastic_no_host_sync, dev, args.seed)
    by_path["elastic"] = timed("16", elastic_path, dev, args.seed, card)
    torch.cuda.empty_cache()
    by_path["closed loop"] = timed("16", closed_loop_path, dev, args.seed,
                                   card)
    torch.cuda.empty_cache()
    timed("16", elastic_tiers, dev, args.seed, card)
    torch.cuda.empty_cache()
    by_path["elastic durable"] = timed("16", elastic_durable_path, dev,
                                       args.seed, card)
    torch.cuda.empty_cache()
    by_path["train"] = timed("17", train_path, dev, args.seed, card)
    torch.cuda.empty_cache()
    by_path["mesh"] = timed("18", mesh_path, dev, args.seed, card)
    from repro_torch.launch import mesh as tmesh
    try:
        by_path["ranks"] = timed("19", ranks_path, dev, args.seed, card)
    finally:
        tmesh.close_world()
    torch.cuda.empty_cache()
    by_path["kernel ranks"], split_routes = timed(
        "20", kernel_ranks_path, dev, args.seed, card)
    for e in entries:
        if split_routes.get(e["name"]):
            e.setdefault("routes", {}).update(split_routes[e["name"]])
    torch.cuda.empty_cache()
    by_path["app hot topics"] = timed("21", app_hot_topics_path, dev,
                                      args.seed, card, off_s)
    torch.cuda.empty_cache()
    by_path["app reputation"] = timed("21", app_reputation_path, dev,
                                      args.seed, card, off_s)
    total = time.perf_counter() - t_run
    log(f"phase walls (s): {json.dumps({k: round(v, 1) for k, v in walls.items()})}"
        f"; phases 3-21 {total:.1f} s, the script {time.perf_counter() - t0:.1f}"
        f" s with the build; the host's speed marker: phase 5 "
        f"{off_s * 1e3:.3f} ms/tick; {card}")
    for e in entries:
        e["launches_by_path"] = {path: n[e["name"]] for path, n in
                                 by_path.items() if n.get(e["name"])}
        e["launches"] = sum(e["launches_by_path"].values())
        rk = f"{e['name']} routes"
        if any(rk in n for n in by_path.values()):
            # each instance's launches by route (slate_lookup: int32 keys
            # on phases 5-11, 15a-b, 16a-b and 21, int64 on phases 12,
            # 15d and 16d; the backward kernels on phase 17)
            e["launches_by_route"] = {r: sum(
                n[rk].get(r, 0) for n in by_path.values() if rk in n)
                for r in sorted({r for n in by_path.values() if rk in n
                                 for r in n[rk]})}
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']} never ran on a path")
    keys = ["name", "route", "source", "replaces", "launches",
            "launches_by_path", "launches_by_route", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "by_mix",
            "fused", "routes", "shapes"]
    log(json.dumps({"kernels": [{k: e[k] for k in keys if k in e}
                                for e in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
