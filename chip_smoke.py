#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself and imports only ``repro_torch``
(never ``jax`` or ``repro``). Phases, in order; any failure is an
exception and a nonzero exit:

1. Card: ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile ``src/repro_torch/csrc/*.cu`` for ``sm_90a`` with nvcc.
2a. Device times, first, in a process that has traced nothing yet: each
   kernel at every shape phases 8, 14 and 19 time (K3 also forward and
   backward at the training shapes), and the library call beside K4 and
   K5, from a ``torch.profiler`` trace of ``DEVICE_CALLS`` calls. Only
   the kernel's own device events count (``KERNEL_EVENTS``: its launch,
   and K5's combine pass), over its launches. Every trace has idle host
   time at both ends (``TRACE_PAD_S``): the profiler drops a device
   event stamped outside its window, and now and then stamps the card's
   events milliseconds early. Every profiled window opens with a lead-in
   of spin kernels that no count or busy time reads (``_trace_lead_in``):
   a trace can lose its first device records. A trace that still lacks
   some of its calls' events is taken again, up to ``DEVICE_TRIES``
   times, and then fails the run.
3. K1 (V-trace recurrence) against its plain PyTorch version, on the card,
   at the replay learner's batches of 2 and 4 trajectories too.
4. K2 (fused loss + V-trace) against its plain version, forward and the
   ``autograd.Function``'s d_logits of the assembled IMPALA total, at
   every batch bucket of the async learner too.
5. The main path: ``repro_torch.launch.train`` at its defaults (sync,
   catch, impala-shallow at full width, 32 envs, unroll 20) for
   ``MAIN_STEPS`` steps on the card, with K2 launched once per learner
   step; then ``impala_loss(impl='pallas')`` on the last actor batch puts
   K1 on the path. Launch counts are zeroed just before and read just
   after.
6. Learning bar: the JAX package's bandit bar (tests/test_system.py,
   mean return over the last 200 episodes > 0.6 after 150 steps), through
   the same CLI on the card.
6a. The async path: ``repro_torch.launch.train --runtime async`` (catch,
   impala-shallow at full width, 32 envs, unroll 20, 2 actor threads,
   queue 8/block, batches of up to 4 trajectories) for ``ASYNC_STEPS``
   learner updates, K2 launched once an update at (20, 32k, 3) and K1
   never; counts zeroed just before and read just after. Prints learner
   and actor frames/s (read before the window below), the batch-size
   histogram, the measured lag and the queue's occupancy, stalls and
   drops. In the same run, where an async update's time goes:
   ``ASYNC_WINDOW`` steady updates timed unprofiled, then
   ``ASYNC_PROFILED`` under ``torch.profiler``, after a pad whose events
   (the actors') are left out: the card's busy time per update against
   the unprofiled update, and the device kernels that take most of it. No
   actor thread may outlive the run.
6b. Async learning bar: the JAX package's acceptance configuration for
   thread actors (tests/test_process_actors.py: smoke impala-shallow, 32
   envs, unroll 20, ``BAR_STEPS`` = 400 updates, 2 actor threads, queue
   8/block, batches of up to 4); the last 100 returns above the first
   500 by more than 0.15, and above -0.3.
6c. The async path with replay: ``repro_torch.launch.train --runtime async
   --replay-fraction 0.5 --replay-reuse 2``, else as 6a, for
   ``ASYNC_STEPS`` updates. Every update trains on the replay loss, so K1
   launches exactly once an update, at (20, 32k), and K2 never; counts
   zeroed just before and read just after. Prints the replay telemetry
   (sampled, reuse ratio, target syncs, fresh cap), the batch sizes,
   learner, trained and actor frames/s, and, as 6a, the card's busy share
   of a window of updates. No actor thread may outlive the run.
6d. Replay learning bar: the JAX package's replay acceptance
   configuration (tests/test_replay.py: catch, smoke impala-shallow, 16
   envs, unroll 8, 240 updates, lr 1e-3, fraction 0.5, reuse 2, capacity
   512, 2 actor threads, queue 8/block, batches of up to 4): the last 20
   returns above the first 20 by more than 0.15, reuse ratio above 1.5.
6e. The sync CLI with ``--replay-fraction 0.5``: K2 launches once a step.
6f. Checkpoints at full width: a sync CLI run with ``--ckpt-dir`` resumed
   by a second run; an async runtime run writing fleet-v1 checkpoints
   (params, optimizer state, version), resumed with its versions
   continuing. Restored trees equal the saved ones bit for bit, on the
   card and loaded on the CPU.
6g. Envs on the card: rooms, tmaze and chase, 32 envs each,
   ``ENV_STEPS`` steps from the same actions and draws on the card and
   on the CPU; every state, token, image, reward and done equal.
6h. Chase at full width through the sync CLI (impala-shallow, 32 envs,
   unroll 20) for ``CHASE_SYNC_STEPS`` steps: K2 once a step at (20, 32,
   5) and K1 never; frames/s beside catch's from phase 5.
6i. Chase through the async CLI with replay (fraction 0.5, reuse 2), as
   6c, for ``CHASE_ASYNC_STEPS`` updates: K1 once an update at (20, 32k)
   and K2 never; frames/s and the card's busy share of a window.
6j. Inference mode at full width: ``--runtime async --actor-mode
   inference`` on catch (2 logical actors, 32 envs, unroll 20, queue
   8/block, batches of up to 4) for ``ASYNC_STEPS`` updates, K2 once an
   update; learner frames/s beside phase 6a's unroll mode with the same
   settings in the same run, the service's telemetry (flushes, batch
   sizes, requests, queue wait), lag, and the card's busy share of a
   window of updates.
6k. Inference learning bar: the JAX package's thread-backend inference
   acceptance configuration
   (tests/test_inference_service.py::
   test_inference_mode_learns_on_catch_both_backends: smoke
   impala-shallow, catch, 32 envs, unroll 20, ``BAR_STEPS`` updates, lr
   6e-4): last 100 above the first 500 by more than 0.15, and above
   -0.3, with flushes and measured lag.
6l. Multi-task: ``train_multitask`` on catch+bandit+tmaze at full width,
   8 envs a task, ``MULTITASK_STEPS`` steps (K2 at (16, 24, 4)), and each
   task's expert; every score and the mean capped normalised scores.
6m. PBT: ``run_pbt`` (pop 4, 2 rounds of ``PBT_STEPS`` steps,
   catch+bandit, full width): a member that copied in round 0 trains on its copy in round 1
   while the member it copied from stays bit for bit as it was; and a
   forced exploit's copy, trained one step, leaves its source untouched.
6n. Process actors at full width: 6a's settings with ``--actor-backend
   process --transport shm`` (2 spawned children acting on the CPU,
   serialized trajectories and params) for ``ASYNC_STEPS`` updates, K2
   once an update and K1 never; learner and actor frames/s beside 6a's
   thread actors in the same run, the wire's counters, and the card's
   busy share of a window. While the children run, ``nvidia-smi
   --query-compute-apps=pid`` lists at most one process, and none of
   the children: no child holds a CUDA context. No child outlives the
   run.
6o. Process inference mode: 6n with ``--actor-mode inference``
   (``ASYNC_STEPS`` updates): the children submit over the service's
   process frontend and its flusher thread flushes; the flush reasons
   (deadline flushes included), batch sizes and queue-wait p95.
6p. The JAX process-backend learning bar (tests/test_process_actors.py,
   its process half: smoke impala-shallow, ``BAR_STEPS`` updates): last
   100 above the first 500 by more than 0.15 and above -0.3, trajectories
   over the wire.
6q. Remote actors over loopback TCP: unroll mode with ``--wire-codec
   bf16`` and inference mode, each at full width for ``REMOTE_STEPS``
   updates with K2 once an update; no decode error and no torn tail, and
   the bf16 wire carries under 1/1.5 of the raw bytes.
6r. A learner group at full width: ``--runtime async --learners 2`` on
   catch with impala-shallow (32 envs, unroll 20, 2 actor threads, one a
   learner, batches of up to 4) for ``GROUP_STEPS`` rounds: identical
   replicas (the workers' digests), versions ``[GROUP_STEPS] * 2``, no
   stale drop, both shards consumed, slot bases 0 and 1, the exchange and
   K2 once a round in each learner (counted in the worker processes and
   shipped back), K1 never; each learner's frames/s, their sum and the
   reduce wait beside 6a's single learner, and ``nvidia-smi``'s compute
   pids while the group runs (at most this process and the two workers).
6s-6t. One run: 6r with ``--replay-fraction 0.5 --replay-reuse 2`` and
   ``--actor-backend process --transport shm`` for ``GROUP_PROC_STEPS``
   rounds: K1 once a round in each learner, K2 never, identical
   replicas, replay sampled; none of the workers' children (the actors)
   holds a CUDA context. With ``--metrics-port``: a thread polls the
   group's one port while it runs and must see ``repro_learner_updates``
   for ``learner="0"`` and ``learner="1"`` and a /healthz of 200.
6u. The JAX group learning bar (tests/test_group.py::
   test_two_learner_group_learns_catch: smoke impala-shallow, 2 learners,
   4 actor threads, ``GROUP_BAR_STEPS`` rounds): last 100 above the first
   500 by more than 0.15, and above -0.3, with identical replicas; with a
   ``ckpt_dir``, its publisher saves fleet-v1 after the last round, with
   the replicas' digest.
6v. Group resume, in 6u's configuration: a group resumed from 6u's
   checkpoint with no round left publishes the saved params (the same
   digest) in both workers, and one resumed for ``GROUP_RESUMED`` more
   rounds continues the version stream with identical replicas.
6w. The flight recorder on the async path: 6a's settings for
   ``OBS_STEPS`` updates with ``--metrics-port`` (a free port),
   ``--trace`` (one trajectory in ``OBS_TRACE_EVERY`` an actor),
   ``--telemetry-sink``, ``--profile-steps 30:34``, ``--profile-dir``
   and ``--telemetry-json``. After update 20 /metrics must return
   Prometheus samples only, the update count, frames/s and the queue's
   among them, /healthz 200 and ``ok``, /telemetry at least 20 updates.
   Then: ``phases`` over every update with its five keys (their mean ms
   printed, and over the updates after the scrape and before the profile
   window from the hook's snapshots); K2 once an update; every traced trajectory with all seven
   spans and its stamps in order (u0 <= u1 <= r <= dequeue <= collect <=
   step0 <= step1 <= publish), none dropped; the profile window's Chrome
   trace holding exactly its 5 K2 launches (a run whose trace lost some
   is taken again, up to ``DEVICE_TRIES`` runs, each run's K2 launches
   counted), and its busy share beside 6a's; the sink's last line at the last update; the telemetry file
   equal to the final telemetry. Learner frames/s beside 6a's.
6x. Traces across the process boundary: 6n's process actors for
   ``OBS_PROC_STEPS`` updates with every trajectory traced: e0 <= e1 <= r
   and encoding time above 0 for each, rows ``actor-0`` and ``actor-1``,
   one trace per trajectory consumed, K2 once an update, and no child
   with the card's device node open.
6y. Supervision of actors, each at full width with ``--supervise`` and
   checked afterwards for leftovers (no child left, no process of the
   run with the card's device node open, one compute context, no new
   listening socket or /dev/shm entry): (a) 6a's thread actors for
   ``SUP_STEPS`` updates, actor 0's thread shot at update
   ``SUP_KILL_AT`` (it raises from its emit, so the trajectory it held
   never reaches the queue): restarts 1, epoch 1, updates keep coming,
   the reborn thread's trajectories arrive; learner frames/s up to the
   death beside 6a's; (b) 6n's process actors and (c) remote loopback
   actors (heartbeat deadline ``SUP_HEARTBEAT_S``), ``SUP_PROC_STEPS``
   and ``SUP_REMOTE_STEPS`` updates, a child SIGKILLed at
   ``SUP_KILL_AT`` and respawned; process: a trajectory of its slot
   produced after the death arrives (updates are paced by
   ``SUP_PACE_S`` until it does); remote: the dead child's lease is
   reaped; no child holds the card. K2 once an update.
6z. Supervised learner groups of two at full width (6r's configuration)
   for ``SUP_GROUP_STEPS`` rounds: (d) full checkpoints every
   ``SUP_GROUP_CKPT`` rounds and the spoke SIGKILLed once it has
   ``SUP_GROUP_KILL_AT`` updates: respawned from the latest checkpoint,
   it catches up on the hub's replayed means: restarts 1, epoch 1,
   replicas bit identical, versions ``[steps, steps]``, K2 launched in the
   reborn worker; (e) the hub SIGKILLed instead: learner 1 promoted,
   failovers 1, abandoned learners [0], publisher 1, version ``steps``, K2
   once a round in the promoted worker. Each prints how long the respawn
   or failover took from the death to the first update; the workers' K2
   counts and shapes join the kernels line and phase 7a.
7. Split: where a main-path step's time goes, actor unroll against
   learner step, each timed on the host clock up to a synchronise; then
   the card's busy time over a few steps from a ``torch.profiler`` trace,
   and the device kernels that take most of it.
7a. Path shapes: every (T, B) and (T, B, A) at which phases 5-7 launched
   K1 or K2 (each wrapper's ``shapes``; a group's workers ship theirs
   back) and that phases 3-4 left out,
   held against the plain version at ``ATOL`` as they are; its errors
   join K1's and K2's ``max_abs_err``.
8. Times: K1 and K2 at the main path's shape, the paper's DMLab learner
   shape (100, 32, 9), (100, 256, 18) and the batches of 2 and 4
   trajectories, (20, 64, 3) and (20, 128, 3); each call timed with CUDA
   events and each kernel's device time from phase 2a, beside the plain
   version and the least time the card could take
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s fp32; the larger of
   the two).
9. K4 (flash attention) against its plain version on the card, in bf16
   (the tensor-core kernel) and f32 (the SIMT kernel): the serving path's
   prefill shape, a ragged T, S != T (T = 200 against S = 330 across the
   128-row tiles), non-causal (S = 1 too), sliding windows of 64 at T =
   512 and 2048, T = S = 2048, one and four query heads per kv head, D =
   32, 64, 128 and 256; the prefill shapes of phases 20-23 (D = 256 with
   G = 1 and G = 10, the hybrid's window of 2048 at T = 2048, and a
   window of 128 at D = 256, G = 10); unmasked with S > T (100 queries
   over 1,600 keys), ragged on both sides (37 over 1,500, D = 64) and
   whisper's encoder at batch 2 (T = S = 1,500), for phases 23c-23d.
10. K5 (decode attention) against its plain version: the serving path's
    decode shape, S = 32768, S = 1, 17, 64, 65, 1000 and 4097, G = 1, 4
    and 16, and biases with masked prefixes and suffixes built by the
    decode path's own ``decode_bias``; the decode shapes of phases
    20-23, the hybrid's ring (G = 10, D = 256, S = 2048) past its wrap and
    before it; every one of 1,600 (G = 4, D = 128) or 1,500 (G = 1, D =
    64) keys valid, as in cross-attention decode (phases 23c-23d).
11. The serving path: ``repro_torch.launch.serve`` at its defaults but
    one batch (mistral-nemo-12b at full width and depth, 16 requests,
    batch 16, ctx 128, 32 decode steps) on the card. K4 must launch once
    a layer at each prefill, K5 once a layer at each decode step and K3 never; counts are
    zeroed just before and read just after. Prints actions/s, step
    latency, prefill and decode-step ms and the card's peak allocated
    memory, with the card's name and power limit.
12. Served logits against the plain route: the first batch's tokens and
    sampled actions replayed through ``ops``'s ``impl='ref'`` route on the
    same params; prefill logits and every decode step's logits compared.
13. Where a decode step's time goes: a ``torch.profiler`` trace of a few
    decode steps, the card's busy time against the unprofiled step. Every
    busy-share trace of a serving or sync path (7, 13, 18, 23, 23b, 25,
    25d) traces the card's activity alone and must hold every launch of
    the port's kernel that ran, by the wrapper's own count (``_traced``).
14. Times with CUDA events: K4 and K5 at the serving path's shapes, at
    gemma-7b's and recurrentgemma-2b's (phases 20 and 23), at
    llama-3.2-vision-11b's cross-attention and whisper-small's encoder and
    cross-attention (phases 23c-23d), K5 at the token actor's shape
    (phase 25: stablelm-1.6b, 32 envs, a cache of 21 slots), and at one
    long shape each, beside the plain version, the bound (bytes over
    3.35 TB/s, operations over 989 TFLOP/s bf16) and one library call,
    ``F.scaled_dot_product_attention``, that the port never calls; with
    the achieved TFLOP/s (K4) or TB/s (K5) and the share of the bound;
    and the kernel's and the library call's device times from phase 2a.
15. K3 (the linear scan) against its plain version on the card, with h0
    and without: small and ragged shapes, the mamba2 serving path's
    cross-chunk pass (8, 8388608) and the RG-LRU prefill's (2048, 40960).
    Its gradient (``LinearScanFn``: K3, then K3 on reversed time) against
    autograd through the plain loop at the training shapes
    (``K3_BWD_SHAPES``: recurrentgemma-2b's (21, 81920), mamba2-1.3b's
    (1, 16777216), and (8, 1048576) with h0), one launch each way.
16. The SSM serving path: ``repro_torch.launch.serve --arch mamba2-1.3b
    --ctx 2048 --requests 16`` (full width and all 48 layers, one batch,
    otherwise the CLI's defaults) on the card. K3 must launch once a
    layer at each prefill and K4/K5 never; counts are zeroed just before and read just after.
    Prints actions/s, step latency, prefill and decode-step ms and the
    card's peak allocated memory.
17. Its served logits against the plain route (as phase 12).
18. Where a mamba2 prefill's and decode step's time goes: ``torch.profiler``
    traces, the card's busy time against the unprofiled times.
19. Times with CUDA events: K3 at the serving shape and at (2048, 40960),
    beside the plain version and the bound (bytes over 3.35 TB/s,
    operations over 67 TFLOP/s fp32), and its device time from phase 2a;
    no single PyTorch call computes the recurrence, so there is no
    library time. Then its forward and its backward at the training
    shapes, each beside its bound.
20-23. The dense configs and the RG-LRU hybrid at their published widths
    and all their layers (``NEW_SERVES``): ``repro_torch.launch.serve
    --arch gemma-7b``, ``qwen1.5-4b``, ``stablelm-1.6b`` (ctx 128) and
    ``recurrentgemma-2b`` (ctx 2048, its window, so the first decode step
    wraps the ring), each one batch of 16 streams and ``NEW_SERVE_STEPS``
    decode steps. K4 once an attention layer at the prefill, K5 once an
    attention layer a decode step, K3 once a recurrent layer at the
    prefill and never in a decode step: the counts are zeroed just before
    and read just after. Each prints as phase 11, and its served logits
    are held to the plain route as in phase 12; recurrentgemma-2b's
    decode steps are traced as in phase 13 and its prefill as in phase
    18; each run's weights are freed before the next.
23a-23b. The MoE configs at their published widths and all their layers
    (``MOE_SERVES``): ``repro_torch.launch.serve --arch
    granite-moe-1b-a400m`` and ``olmoe-1b-7b``, as phases 20-22 (ctx 128,
    one batch of 16, ``NEW_SERVE_STEPS`` decode steps): K4 once a layer at
    the prefill and K5 once a layer a decode step, K3 never. Their served
    logits are held to the plain route as in phase 12, and each MoE layer
    of the prefill is held to the plain route on the kernel route's own
    input, with the tokens that the two routes' routers sent to other
    experts counted. olmoe's decode step is traced as in phase 13, and its
    MoE layer split into router, weight casts, expert products and the
    dispatch and combine around them.
23c-23d. llama-3.2-vision-11b and whisper-small at their published
    widths and all their layers through ``repro_torch.models.backbone``
    (the server sends tokens only): 16 streams of 128 tokens with the stub
    frontend's embeddings (image (16, 1600, 4096), frames (16, 1500, 768),
    bf16 from a seeded generator on the card), ``apply_prefill`` and
    ``NEW_SERVE_STEPS`` sampled ``apply_decode(batch=)`` steps. llama: K4
    32 self + 8 cross (unmasked over 1,600 keys) at the prefill, K5 40 a
    step; whisper: K4 12 encoder (unmasked over 1,500 frames) + 12 self +
    12 cross, K5 24 a step; the counts are zeroed just before and read
    just after. Prints as phase 11, and the logits are held to the plain
    route as in phase 12.
24. Path shapes: every shape at which a serving path (11, 16, 20-23d)
    launched K3, K4 or K5 (each wrapper's ``shapes``) and that phases 9,
    10 and 15 left out, held against the plain version as those phases
    hold theirs; its errors join the kernels' ``max_abs_err``.
25. Token training, the main path of slice 15: ``repro_torch.launch.train
    --arch stablelm-1.6b`` at full width and all 24 layers (catch, the
    CLI's 32 envs x unroll 20, ``TRAIN_STEPS`` steps), every kernel count
    zeroed just before and read just after: K5 once a layer a decode step
    (4 x 20 x 24 = 1,920), K2 once a step, K1, K3 and K4 never. Every
    parameter leaf moved, the loss finite. Prints frames/s, the peak
    allocated memory, one actor unroll's and one learner step's ms, and a
    profiled learner step's busy share.
25a. Kernel route against plain route: one learner step of 25's model on
    its last batch and params, K2 and ``impl='auto'`` against
    ``vtrace_impl='scan'`` and ``impl='ref'``: the loss, the global
    gradient norm and each leaf's gradient (cosine, relative norm) held
    to the ``ROUTE_*`` bars; a NaN fails it.
25b. The other families at full width (``TRAIN_FAMILIES``): one actor
    unroll and one learner step each through ``build_actor`` and
    ``build_train_step``: granite-moe-1b-a400m (its aux loss in the
    loss), mamba2-1.3b (K3 48 + 48), recurrentgemma-2b (K3 18 + 18, K5 8
    a step) and whisper-small (one learner step on a batch of 8 with stub
    frame embeddings); counts zeroed just before and read just after,
    every leaf moved, the loss finite, K3's shapes among phase 15's.
25c. K5 at every shape a token actor launched it at (phases 25 and 25b),
    against its plain version at each cache index of an unroll.
25d. The mixed-precision learner step (``build_train_step(...,
    mixed_precision=True)``: bf16 live params, the f32 master in the
    optimizer state), at full width and depth, each run's counts zeroed
    just before and read just after: (i) stablelm-1.6b on phase 25's last
    batch and final params, the f32 step and the mixed one, a warm-up and
    a timed step each (CUDA events), their peaks, the loss gap within
    ``_loss_gap``'s bar, K2 once a step, every live leaf bf16(master),
    then one mixed step traced for its busy share beside phase 25's; (ii)
    qwen1.5-4b (3.56 B parameters, params and master drawn on the card),
    its mixed step's ms and peak; (iii) mamba2-1.3b, one mixed step: K3
    48 forward and 48 backward, every master leaf moved or under f32
    rounding; (iv) impala-shallow on an actor batch of 32 x 20, the conv
    on bf16 params, the loss gap within the bar.
26. The ported step builders (``repro_torch.launch.steps.build_steps``)
    under ``Rules`` on a one-device mesh, at full width and depth from
    seed 0, at the assigned shapes (``STEP_RUNS``), cut only where
    printed: recurrentgemma-2b's serve step at ``decode_32k`` (B = 128,
    its 2,048-slot ring, K5 8 a call) and ``long_500k`` (B = 1, cache
    index 524,287); mamba2-1.3b's serve step at ``decode_32k`` (B = 128,
    13.05 GB of state, no kernel) and its prefill at ``prefill_32k`` cut
    to B = 1 (K3 48); stablelm-1.6b's prefill at ``prefill_32k`` cut to
    B = 1 (K4 24 at T = S = 32,768), its serve step at ``decode_32k`` cut
    to B = 8 (51.5 GB of cache, K5 24 at S = 32,768) and its train step
    at ``train_4k`` cut to 2 x 2,048 (K2 once). Each step: a warm-up
    call and one timed with CUDA events (one call's stream time, host
    launch gaps included), its own peak; against ``launch.mesh.HW`` (the
    H100 data sheet) the port's own count of the step (``eager_cost`` on
    meta at the same shape, traced by a child on the CPU meanwhile),
    whose bound the measured time is set over, and the JAX package's TPU
    model (``roofline.flops_model.step_cost``, an estimate: it counts
    f32 scores and remat the port does not have); the memory model's
    total, the card's name and power limit; launches counted over both
    calls; the serve steps' value and policy logits and the prefill
    logits held to the plain route at ``LOGITS_RTOL`` (stablelm's prefill
    at ``PREFILL_PLAIN_S``). Every kernel shape the steps launched at is
    held to its plain version (K2 at (2047, 2, 18) as phase 4 holds it;
    K4 at 32,768 on its last ``K4_ROW_CUT`` query rows over all keys),
    K3-K5 also timed; the errors join the kernels line. Meanwhile a
    child process runs ``python -m repro_torch.launch.dryrun`` on
    ``DRYRUN_PAIR``: its record must say ``ok`` and hold
    ``DRYRUN_WANT``, the JAX package's analytic figures for that pair.
27. The SPMD learner and expert parallelism (slice 18). One pair of
    ranks is spawned, sharing the card over a gloo group, for 27a and
    27c; meanwhile this process runs 27b and 27a's one-rank routes.
    27a: ``build_spmd_train_step`` at full width (impala-shallow on
    catch, ``MAIN_B`` envs x ``MAIN_T`` a shard, ``SPMD_ROUNDS`` rounds
    from the seed-0 params): on distinct shards held to the one-rank split
    route (``grad_step`` on each shard, their mean, ``apply_step``), on
    duplicated shards to the fused step on one shard, each at ``SPMD_BAR``
    of the params' largest magnitude; K2 once a round in each rank. 27b:
    ``repro_torch.launch.train --runtime async --learner-mode spmd`` at
    the JAX CLI's defaults for ``ASYNC_STEPS`` updates, one NCCL rank:
    its telemetry's ``group`` section (``exchange_backend`` collective,
    ``spmd_devices`` 1, ``rounds`` ``ASYNC_STEPS``), K2 once an update.
    27c: olmoe-1b-7b at its published widths and all 16 layers, its 64
    experts split 32 and 32 over the pair (``shard_map_a2a`` under
    ``Rules`` on a (1, 2) mesh), each rank drawing its weights leaf by
    leaf on the card and keeping its experts' slice; phase 23b's first
    batch (16 x 128, its ``NEW_SERVE_STEPS`` sampled actions): logits
    held to 23b's one-device route at ``LOGITS_RTOL``, each MoE layer's
    update as in 23b, K4 16 at the prefill and K5 16 a decode step in
    each rank, counted over exactly the served steps.

TF32 is off for cuDNN convolutions and cuBLAS matmuls in every phase, so
the card computes in full float32 like the reference. It exits nonzero
and prints no result where ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import types
from pathlib import Path
from typing import Tuple

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.mesh import HW  # noqa: E402  (after the path)

# per element |got - want| <= ATOL, for K1, K2 and K2's d_logits. The
# kernels are built with -fmad=false and the plain versions sum over the
# actions in the kernel's order, so the two round alike
ATOL = 1e-5
# K4/K5 in float32: kernel and plain version both compute in f32 from the
# same inputs but sum the D-term dot products and the softmax in other
# orders (and the kernel fuses its multiply-adds), a few f32 ulps of
# outputs of size ~1: |err| <= ATTN_F32_ATOL + ATTN_F32_RTOL * |want|
ATTN_F32_ATOL = 1e-5
ATTN_F32_RTOL = 1e-5
# K4/K5 in bfloat16: each output is one rounding of an f32 result, and the
# two f32 results differ as above, so they may round to neighbouring bf16
# values: one bf16 ulp, at most 2^-7 * |want|, plus the f32 slack near 0
ATTN_BF16_RTOL = 2.0 ** -7
ATTN_BF16_ATOL = 1e-5
# served logits, kernel route against plain route: the same bf16 model on
# the same params and tokens, differing only where an attention output
# rounds to the other neighbouring bf16 value (one ulp, 2^-8 relative) in
# some of the 40 layers; the residual stream, norms and matmuls carry that
# at roughly sqrt(40) * 2^-8 = 2.5% of the activations' scale, so the
# logits are held to 5% of their own largest magnitude. The same bar holds
# mamba2-1.3b: K3 is held to 1e-5 of its f32 states (bit for bit
# expected), and where a state differs by an ulp the SSD output may round
# to the other bf16 neighbour at its cast before the gate, in some of the
# 48 layers: sqrt(48) * 2^-8 = 2.7% at most
LOGITS_RTOL = 0.05
MAIN_STEPS = 100
BANDIT_STEPS = 150
BANDIT_BAR = 0.6
# the full-width async runs (phases 6a, 6c, 6i, 6j, 6n, 6o: unroll mode,
# replay, chase replay, inference mode, process actors, with the same
# settings) take 35 updates, the remote loopback runs (6q, three of them)
# 35 too: at 400 the whole script ran 818 s on one H100, at 200 661-736 s
# before the learner groups (6r-6v) came, 801-851 s at 80 with
# supervision (6y-6z), and with the serving phases 20-24 it ran 892-1040
# s at 50, too close to the 1200 s budget on a slow host (PERF.md,
# section 4). An
# async run's timed window starts at update steps - 2 * ASYNC_WINDOW -
# ASYNC_PROFILED. The JAX acceptance bars (phases 6b, 6k, 6p) keep their
# 400
ASYNC_STEPS, BAR_STEPS = 35, 400
REMOTE_STEPS = 35


def _async_argv(env: str, steps: int, *extra: str):
    """The async CLI at full width: 2 actor threads, batches of up to 4
    trajectories, the CLI's queue of 8 with ``block``."""
    return ["--device", "cuda", "--runtime", "async", "--env", env,
            "--arch", "impala-shallow", "--actor-threads", "2",
            "--max-batch-trajs", "4", "--steps", str(steps),
            "--log-every", "100", *extra]


ASYNC_ARGV = _async_argv("catch", ASYNC_STEPS)
# the steady updates timed, then those profiled, near the end of an async
# run (phases 6a, 6c, 6i, 6j, 6n, 6o, 6q)
ASYNC_WINDOW, ASYNC_PROFILED = 10, 5
# the async path with replay at the paper's half (phase 6c)
REPLAY_ARGV = ASYNC_ARGV + ["--replay-fraction", "0.5", "--replay-reuse",
                            "2"]
# tests/test_replay.py's bar: 240 updates, last 20 > first 20 + 0.15
REPLAY_BAR_STEPS, REPLAY_CLIMB = 240, 0.15
SYNC_REPLAY_STEPS = 50
CKPT_EVERY = 10
# tests/test_process_actors.py's bar: late - early > 0.15, late > -0.3
CATCH_CLIMB, CATCH_LATE = 0.15, -0.3
# slice 8: the new envs, chase at full width, inference mode, multi-task
ENV_B, ENV_STEPS = 32, 100
CHASE_SYNC_STEPS, CHASE_ASYNC_STEPS = 40, ASYNC_STEPS
CHASE_REPLAY_ARGV = _async_argv("chase", CHASE_ASYNC_STEPS,
                                "--replay-fraction", "0.5",
                                "--replay-reuse", "2")
INFER_ARGV = ASYNC_ARGV + ["--actor-mode", "inference"]
# slice 9: process and remote actors, 6a's settings otherwise
PROC_ARGV = ASYNC_ARGV + ["--actor-backend", "process", "--transport", "shm"]
PROC_INFER_ARGV = PROC_ARGV + ["--actor-mode", "inference"]
REMOTE_ARGV = _async_argv("catch", REMOTE_STEPS, "--actor-backend",
                          "remote", "--transport", "socket")
# two runs, mostly the children's start-up: the unroll mode on the bf16
# wire, the inference mode on the plain one (6y's supervised remote run
# drives the unroll mode on the plain wire)
REMOTE_RUNS = [("remote unroll bf16", REMOTE_ARGV + ["--wire-codec",
                                                     "bf16"]),
               ("remote inference", REMOTE_ARGV + ["--actor-mode",
                                                   "inference"])]
# the bf16 wire's raw bytes over its wire bytes must pass this
WIRE_DIET = 1.5
# slice 10: learner groups at full width, one actor thread a learner
GROUP_LEARNERS, GROUP_STEPS, GROUP_PROC_STEPS = 2, 40, 30
GROUP_ARGV = _async_argv("catch", GROUP_STEPS, "--learners", "2")
# 6s-6t: one run, mostly its workers' start-up: process actors, replay at
# the paper's half and the group's metrics port
GROUP_PROC_ARGV = _async_argv("catch", GROUP_PROC_STEPS, "--learners", "2",
                              "--actor-backend", "process", "--transport",
                              "shm", "--replay-fraction", "0.5",
                              "--replay-reuse", "2")
# tests/test_group.py::test_two_learner_group_learns_catch: 240 rounds
GROUP_BAR_STEPS = 240
# the rounds a group resumed from the bar run's checkpoint takes (6v)
GROUP_RESUMED = 5
# slice 11: the flight recorder. 6w: 6a's settings for OBS_STEPS updates,
# one trajectory in OBS_TRACE_EVERY an actor traced, /metrics read after
# update OBS_SCRAPE_AT, torch.profiler over updates OBS_PROFILE (both
# ends), the learner's rate and the phases of the updates after
# OBS_SCRAPE_AT + 1 read after OBS_RATE_AT (before the profile)
OBS_STEPS, OBS_TRACE_EVERY, OBS_SCRAPE_AT, OBS_RATE_AT = 40, 4, 20, 29
OBS_PROFILE = (30, 34)
# 6x: process actors, every trajectory traced
OBS_PROC_STEPS = 20
# the trace recorder's default bound: below it nothing is dropped
TRACE_BOUND = 2048
OBS_DIR = ROOT / "build" / "chip_smoke_obs"
# slice 12: supervision. 6y: 6a's settings with --supervise, actor 0's
# thread shot at update SUP_THREAD_KILL_AT of SUP_STEPS; process and
# remote children SIGKILLed at SUP_KILL_AT of SUP_PROC_STEPS and
# SUP_REMOTE_STEPS, the process run's updates paced by SUP_PACE_S from
# the respawn until the reborn child delivers (the remote run does not
# wait for it): the 23 paced updates after the respawn give a child 23 s
# to start and deliver (7.71-9.62 s seen, PRs 24-25; at 0.5 s a pace the
# 11.5 s window was outrun on a host 1.33x slower than PR 24's); the
# remote slots' heartbeat deadline SUP_HEARTBEAT_S. 6z: supervised groups of
# two, full checkpoints every SUP_GROUP_CKPT rounds, a worker SIGKILLed
# once learner 1 has SUP_GROUP_KILL_AT updates, SUP_GROUP_STEPS rounds
SUP_STEPS, SUP_THREAD_KILL_AT = 24, 14
SUP_PROC_STEPS, SUP_REMOTE_STEPS, SUP_KILL_AT, SUP_PACE_S = 30, 14, 6, 1.0
SUP_HEARTBEAT_S = 1.0
SUP_GROUP_STEPS, SUP_GROUP_CKPT, SUP_GROUP_KILL_AT = 12, 3, 5
SUP_PROC_ARGV = _async_argv("catch", SUP_PROC_STEPS, "--actor-backend",
                            "process", "--transport", "shm")
SUP_REMOTE_ARGV = _async_argv("catch", SUP_REMOTE_STEPS, "--actor-backend",
                              "remote", "--transport", "socket",
                              "--heartbeat-timeout-s", str(SUP_HEARTBEAT_S))
MULTITASK_TASKS, MULTITASK_STEPS, MULTITASK_ENVS = (
    ("catch", "bandit", "tmaze"), 10, 8)
PBT_POP, PBT_ROUNDS, PBT_STEPS = 4, 2, 5
# the time a plain version's timing loop aims at (``_time_plain``)
PLAIN_BUDGET_MS = 100.0
# H100 SXM, NVIDIA data sheet: the port's HW table (launch/mesh.py), which
# the dry run's roofline reads too
HBM_BYTES_PER_S = HW["hbm_bw"]             # 3.35 TB/s
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = HW["peak_flops_bf16"]     # bf16 tensor cores, dense
CLIPS = [(1.0, 1.0, 1.0), (None, None, 1.0), (2.0, 1.0, 1.0),
         (1.0, 1.0, 0.9)]
# (20, 64) and (20, 128): the replay learner's batches of 2 and 4
# trajectories of 32 envs
K1_SHAPES = [(1, 1), (20, 32), (37, 130), (100, 32), (100, 256), (20, 64),
             (20, 128)]
# (20, 64, 3) and (20, 128, 3): the async learner's batches of 2 and 4
# trajectories of 32 envs
K2_SHAPES = [(20, 32, 3), (37, 130, 5), (100, 32, 9), (100, 256, 18),
             (16, 8, 130), (20, 64, 3), (20, 128, 3),
             # chase's and rooms' 5 actions, one trajectory and four;
             # the catch+bandit+tmaze multi-task step (a partial tile);
             # the experts' and PBT's steps of one task, 3 and 4 actions
             (20, 32, 5), (20, 128, 5), (16, 24, 4), (16, 8, 3),
             (16, 8, 4)]
MAIN_T, MAIN_B, MAIN_A = 20, 32, 3     # the main path's K1/K2 shapes
# K1/K2 timed at the main path's shape, the paper's DMLab learner shape
# (unroll 100, batch 32, 9 actions), a large one and the batches of 2 and 4
# trajectories that the replay (K1) and async (K2) learners train on
VTRACE_TIMED = [(MAIN_T, MAIN_B, MAIN_A), (100, 32, 9), (100, 256, 18),
                (MAIN_T, 2 * MAIN_B, MAIN_A), (MAIN_T, 4 * MAIN_B, MAIN_A)]
# K4 checks: (B, T, S, H, K, D, causal, window)
K4_CASES = [
    (16, 128, 128, 32, 8, 128, True, 0),    # the serving path's prefill
    (2, 100, 100, 32, 8, 128, True, 0),     # ragged T
    (2, 100, 160, 32, 8, 128, True, 0),     # S > T
    (2, 160, 100, 32, 8, 128, True, 0),     # S < T
    (2, 128, 128, 32, 8, 128, False, 0),    # non-causal
    (1, 512, 512, 32, 8, 128, True, 64),    # window 64 (swa_variant's)
    (2, 128, 128, 8, 8, 128, True, 0),      # G = 1
    (2, 96, 96, 16, 4, 64, True, 0),        # G = 4 at D = 64
    (2, 70, 70, 4, 2, 32, True, 24),        # the smoke config's D = 32
    (2, 256, 256, 16, 4, 256, True, 0),     # D = 256: 64-key tiles, G = 4
    (1, 2048, 2048, 32, 8, 128, True, 0),   # 16 query tiles, 1-16 kv tiles
    (1, 2048, 2048, 32, 8, 128, True, 64),  # window 64 at T = S = 2048
    (2, 200, 330, 32, 8, 128, True, 0),     # ragged across 128-row tiles
    (2, 1, 1, 32, 8, 128, False, 0),        # non-causal, S = 1
    # the prefill shapes of the dense configs and the hybrid (phases 20-23)
    (16, 128, 128, 16, 16, 256, True, 0),   # gemma-7b: D = 256, G = 1
    (16, 128, 128, 20, 20, 128, True, 0),   # qwen1.5-4b: G = 1
    (16, 128, 128, 32, 32, 64, True, 0),    # stablelm-1.6b: D = 64, G = 1
    (16, 2048, 2048, 10, 1, 256, True, 2048),  # recurrentgemma-2b: G = 10
    (2, 512, 512, 10, 1, 256, True, 128),   # D = 256, G = 10 under a window
    # cross-attention and the whisper encoder (phases 23c-23d), unmasked:
    # S > T as the image layers' 1,600 keys, ragged on both sides as
    # whisper's 1,500 frames, and the encoder itself at batch 2
    (2, 100, 1600, 32, 8, 128, False, 0),
    (2, 37, 1500, 12, 12, 64, False, 0),
    (2, 1500, 1500, 12, 12, 64, False, 0),
]
# K5 checks: (B, H, K, S, D, cache_index, window) with the decode path's
# bias: decode_bias(cache_index, S, window)
K5_CASES = [
    (16, 32, 8, 128, 128, 160, 0),          # the serving path's decode
    (8, 32, 8, 32768, 128, 40000, 0),       # decode_32k, all valid
    (4, 32, 8, 1000, 128, 999, 0),          # ragged S
    (4, 32, 8, 1000, 128, 300, 0),          # masked suffix: cache with room
    (4, 32, 8, 1024, 128, 2000, 256),       # ring buffer: masked prefix
    (4, 32, 8, 512, 128, 200, 128),         # ring not yet full: both ends
    (3, 8, 8, 130, 64, 100, 0),             # G = 1 at D = 64
    (4, 32, 8, 1, 128, 0, 0),               # S = 1: one warp, one key
    (4, 32, 8, 17, 128, 16, 0),             # S = 17: two ragged tiles
    (4, 32, 8, 64, 128, 40, 0),             # S = 64, a masked suffix
    (4, 32, 8, 65, 128, 64, 0),             # S = 65: one key past 64
    (4, 32, 8, 4097, 128, 4096, 0),         # S = 4097: splits, ragged
    (4, 32, 2, 1000, 128, 999, 0),          # G = 16 at D = 128
    # the decode shapes of the dense configs and the hybrid (phases 20-23)
    (16, 16, 16, 128, 256, 135, 0),         # gemma-7b: D = 256, G = 1
    (16, 20, 20, 128, 128, 135, 0),         # qwen1.5-4b: G = 1
    (16, 32, 32, 128, 64, 135, 0),          # stablelm-1.6b: D = 64, G = 1
    (16, 10, 1, 2048, 256, 2055, 2048),     # recurrentgemma-2b: the ring
    # past its wrap (G = 10, D = 256), then before it (masked suffix)
    (16, 10, 1, 2048, 256, 1500, 2048),
    # cross-attention decode (phases 23c-23d): the index past the last
    # slot, so every one of the 1,600 or 1,500 keys is valid
    (4, 32, 8, 1600, 128, 1600, 0),
    (4, 12, 12, 1500, 64, 1500, 0),
]
# each kernel's device events in a profiler trace: its launch, then any
# pass it launches with it (K5's combine of the S splits)
KERNEL_EVENTS = {"vtrace": ("vtrace_tile_kernel<false>",),
                 "loss_vtrace": ("vtrace_tile_kernel<true>",),
                 "flash_attention": ("flash_attention_kernel",),
                 "decode_attention": ("decode_attention_kernel",
                                      "combine_kernel"),
                 "linear_scan": ("linear_scan_kernel",)}
# calls a device-time trace holds
DEVICE_CALLS = 50
# traces of one call that phase 2a takes before it fails where one holds
# only some of its device events
DEVICE_TRIES = 3
# traces of a serving or sync busy share (``_traced``) taken before the run
# fails where each lost some of its kernel's launches, and the idle host
# seconds between two of them: a long trace (the hybrid's 0.77 s prefill)
# has been seen to lose one of its 18 K3 launches in three takes in a row
# that followed one another at once, where five whole runs before had
# lost none
TRACE_TRIES, TRACE_RETRY_PAUSE_S = 6, 2.0
# idle host seconds a trace keeps before its first launch and after its
# last synchronise. The trace drops a device event whose time, converted
# to the host's clock, falls outside its window, and now and then the
# conversion puts a kernel up to 3.9 ms before its own launch
# (``tools/trace_clock.py``)
TRACE_PAD_S = 0.05
# the lead-in of each profiled window (``_trace_lead_in``): short spin
# kernels (``torch.cuda._sleep``, ~1 us of cycles each) and one of ~20 ms.
# After some serving phases, a process's traces lose their first device
# record in take after take, wide pads or not: a busy-share trace then
# lacked one launch of the port's kernel, a device-time trace one call's
# first kernels; with the lead-in they lose spin kernels instead, up to
# 55 of 257 seen on an H100 (PERF.md, section 7)
LEAD_IN_SPINS, LEAD_IN_CYCLES, LEAD_IN_LONG_CYCLES = 1024, 1000, 40_000_000
LEAD_IN_EVENT = "spin_kernel"
# the device-time traces that lost events and were taken again
TRACES_RETAKEN = []
# the async windows' pad less the largest shift allowed for: the busy
# time leaves out what the actors launched in it
ASYNC_SKIP_US = (TRACE_PAD_S - 0.01) * 1e6
# K4 timed: (label, (B, T, S, H, K, D), causal, window, calls); K5:
# (label, (B, H, K, S, D), cache_index, window, calls). "gemma" and
# "recurrentgemma" are those serving paths' prefill and decode shapes
# (phases 20 and 23; the hybrid's window of 2048 covers its whole prefill,
# and its decode reads the ring past its wrap); "llama cross" the VLM's
# image layers (phase 23c: 128 queries over 1,600 patch keys, unmasked;
# its decode step's query over all of them), "whisper encoder" and
# "whisper cross" the audio backbone's (phase 23d)
K4_TIMED = [("main", (16, 128, 128, 32, 8, 128), True, 0, 200),
            ("long", (1, 4096, 4096, 32, 8, 128), True, 0, 10),
            ("gemma", (16, 128, 128, 16, 16, 256), True, 0, 200),
            ("recurrentgemma", (16, 2048, 2048, 10, 1, 256), True, 2048, 10),
            ("llama cross", (16, 128, 1600, 32, 8, 128), False, 0, 200),
            ("whisper encoder", (16, 1500, 1500, 12, 12, 64), False, 0, 20)]
K5_TIMED = [("main", (16, 32, 8, 128, 128), 160, 0, 200),
            ("long", (8, 32, 8, 32768, 128), 40000, 0, 20),
            ("gemma", (16, 16, 16, 128, 256), 135, 0, 200),
            ("recurrentgemma", (16, 10, 1, 2048, 256), 2055, 2048, 200),
            ("llama cross", (16, 32, 8, 1600, 128), 1600, 0, 200),
            ("whisper cross", (16, 12, 12, 1500, 64), 1500, 0, 200),
            ("stablelm actor", (32, 32, 32, 21, 64), 19, 0, 200)]
# the server's defaults but one batch of 16 requests
SERVE_ARGV = ["--device", "cuda", "--requests", "16"]
SERVE_LAYERS, SERVE_BATCHES, SERVE_STEPS = 40, 1, 32
SERVE_PARAMS = 11_576_791_059
# K3 checks: (T, N). (8, 8388608) is the mamba2 serving path's cross-chunk
# pass (8 chunks of 256 at ctx 2048; batch 16 x 64 heads x P 64 x N 128);
# (2048, 40960) the RG-LRU prefill's at batch 16, width 2560, ctx 2048
K3_SHAPES = [(1, 1), (33, 7), (257, 129), (512, 1024), (8, 8388608),
             (2048, 40960)]
K3_MAIN, K3_LONG = (8, 8388608), (2048, 40960)
SSM_ARGV = ["--device", "cuda", "--arch", "mamba2-1.3b", "--ctx", "2048",
            "--requests", "16"]
SSM_LAYERS, SSM_PARAMS = 48, 1_343_779_859
# phases 20-23: the dense configs and the RG-LRU hybrid at full width, one
# batch of 16 and 8 decode steps each; the dense three at the server's ctx
# 128, the hybrid at ctx 2048, its window, so its first decode step wraps
# the ring. (arch, ctx, layers, params, launches of K3, K4, K5): K4 once an
# attention layer at the prefill, K5 once an attention layer a decode
# step, K3 once a recurrent layer at the prefill
NEW_SERVE_STEPS = 8
NEW_SERVES = [
    ("gemma-7b", 128, 28, 8_537_739_283, (0, 28, 224)),
    ("qwen1.5-4b", 128, 40, 3_561_461_779, (0, 40, 320)),
    ("stablelm-1.6b", 128, 24, 1_439_033_363, (0, 24, 192)),
    ("recurrentgemma-2b", 2048, 26, 2_894_622_739, (18, 8, 64)),
]
# phases 23a-23b: the MoE configs through the server at full width, as
# phases 20-22 (ctx 128, one batch of 16, NEW_SERVE_STEPS decode steps):
# (arch, ctx, layers, params, launches of K3, K4, K5). olmoe's decode
# step is traced, and its MoE layer split into its parts (MOE_SPLIT)
MOE_SERVES = [
    ("granite-moe-1b-a400m", 128, 24, 1_334_647_827, (0, 24, 192)),
    ("olmoe-1b-7b", 128, 16, 6_816_112_659, (0, 16, 128)),
]
MOE_SPLIT = "olmoe-1b-7b"
# phases 23c-23d: the VLM and the enc-dec backbone at full width through
# the backbone API (the server sends tokens only): batch 16, ctx 128,
# NEW_SERVE_STEPS decode steps, the stub frontend's embeddings (B,
# encoder_seq_len, d_model) in bf16 from a seeded generator on the card.
# (arch, layers, params, launches of K3, K4, K5): llama K4 32 self + 8
# cross a prefill and K5 40 a step; whisper K4 12 encoder + 12 self + 12
# cross, K5 12 self + 12 cross a step
CROSS_BATCH, CROSS_CTX = 16, 128
CROSS_RUNS = [
    ("llama-3.2-vision-11b", 40, 9_249_898_515, (0, 40, 320)),
    ("whisper-small", 12, 238_204_435, (0, 36, 192)),
]
# the shapes the serving paths launched K3, K4 and K5 at (each wrapper's
# ``shapes``, read after each serving run), held in phase 24
PATH_SHAPES = {"linear_scan": set(), "flash_attention": set(),
               "decode_attention": set()}
# K3's gradient checks (phase 15): (T, N, with h0) at the training paths'
# shapes at 32 envs x unroll 20 (T + 1 = 21 tokens): recurrentgemma-2b's
# RG-LRU over (21, 32 x 2560) and mamba2-1.3b's cross-chunk pass over one
# chunk of 21, (1, 32 x 64 x 64 x 128); and a multi-step scan with h0
K3_TRAIN_SHAPES = [(21, 81920, False), (1, 16777216, False)]
K3_BWD_SHAPES = K3_TRAIN_SHAPES + [(8, 1048576, True)]
# phase 25: token training through the CLI at full width and depth, the
# CLI's 32 envs x unroll 20 on catch; K5 once an attention layer a decode
# step, K2 once a learner step
TRAIN_ARCH, TRAIN_STEPS, TRAIN_LAYERS = "stablelm-1.6b", 4, 24
TRAIN_ARGV = ["--device", "cuda", "--arch", TRAIN_ARCH, "--env", "catch",
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]
# phase 25a: one learner step's kernel route (K2, impl='auto') against its
# plain route (vtrace_impl='scan', impl='ref'), on one batch and one
# parameter set. The forward is the same on both routes (training reaches
# no attention kernel and stablelm has no scan), so the two differ by K2's
# f32 loss and d_logits against the reverse loop's, a few f32 ulps; in the
# bf16 backward such a difference flips an element's rounding now and then
# (one bf16 ulp, 2^-8 relative), so each leaf's gradient is held to a
# cosine of at least ROUTE_COS and a norm within ROUTE_LEAF_RTOL, the
# global norm within ROUTE_NORM_RTOL, the loss within ROUTE_LOSS_RTOL
ROUTE_LOSS_RTOL, ROUTE_NORM_RTOL = 1e-5, 1e-3
ROUTE_COS, ROUTE_LEAF_RTOL = 0.999, 1e-2
# phase 25b: the other families at full width, one actor unroll (32 envs x
# unroll 20, catch) and one learner step each: (arch, layers, learner
# batch, launches of K3 (forward + backward) and K5). whisper-small's
# learner batch carries stub frame embeddings and is cut to 8 trajectories:
# its encoder's dense train-mode scores are (B, 12, 1500, 1500) f32 a layer
# (3.5 GB at 32), kept for the backward in each of its 12 layers
TRAIN_FAMILIES = [
    ("granite-moe-1b-a400m", 24, 32, (0, 24 * 20)),
    ("mamba2-1.3b", 48, 32, (2 * 48, 0)),
    ("recurrentgemma-2b", 26, 32, (2 * 18, 8 * 20)),
    ("whisper-small", 12, 8, (0, 0)),
]
# the (B, H, K, S, D, dtype) the token actors launched K5 at (phases 25
# and 25b), held at every cache index of an unroll in phase 25c
ACTOR_K5_SHAPES = set()
# phase 25d: the mixed-precision learner step. The gap between its loss
# and the f32 step's on the same params: JAX's bar of 0.05
# (tests/test_core.py, on a smoke loss of ~17.6: 0.28% of it), held for
# impala-shallow; for stablelm-1.6b at full width, one bf16 ulp of the
# loss (2^-7 of it) where that is larger: the summed loss of a
# full-width batch of 32 x 20 is hundreds, and rounding the weights to
# bf16 (2^-9 relative) moves it by ~0.25% (1.56 on 648 on an H100, and
# 0.080 on -106.3 in later runs: PERF.md, section 6); qwen1.5-4b at
# full width and depth (params with catch's 3 actions), its f32 step out
# of reach on one card (about six f32 copies of 14.2 GB); mamba2-1.3b's K3
# a pass (48 layers, forward, and as many backward)
MIXED_LOSS_GAP, MIXED_LOSS_RGAP = 0.05, 2.0 ** -7
MIXED_WIDE = ("qwen1.5-4b", 40, 3_561_423_364)
MIXED_SCAN = ("mamba2-1.3b", 48)
# phase 26: the ported step builders (launch/steps.py) at full width and
# depth, (step, arch, assigned shape, B, S, launches a call). B and S are
# the shape's own but where cut: mamba2's and stablelm's prefill_32k to
# one sequence of 32,768; stablelm's decode_32k to 8 sequences (a 51.5 GB
# cache); its train_4k to the most tokens whose learner step fits the
# card: 2 x 2048 (the dense train-mode attention keeps ~3.2 GB a layer a
# sequence of 4,096 for the backward, 77 GB over 24 layers at B = 1)
STEP_RUNS = [
    ("serve", "recurrentgemma-2b", "decode_32k", 128, 32768,
     {"decode_attention": 8}),
    ("serve", "recurrentgemma-2b", "long_500k", 1, 524288,
     {"decode_attention": 8}),
    ("serve", "mamba2-1.3b", "decode_32k", 128, 32768, {}),
    ("prefill", "mamba2-1.3b", "prefill_32k", 1, 32768, {"linear_scan": 48}),
    ("prefill", "stablelm-1.6b", "prefill_32k", 1, 32768,
     {"flash_attention": 24}),
    ("serve", "stablelm-1.6b", "decode_32k", 8, 32768,
     {"decode_attention": 24}),
    ("train", "stablelm-1.6b", "train_4k", 2, 2048, {"loss_vtrace": 1}),
]
# the prefill length the plain route is held at where its dense f32
# attention scores would not fit at the step's own (137 GB a layer at
# 32,768); K4 at T = S = 32,768 itself is held on its last K4_ROW_CUT
# query rows over all keys
PREFILL_PLAIN_S = {"stablelm-1.6b": 4096}
K4_ROW_CUT = 512
# the dry run's child, on the CPU while the card works, and the figures
# its record must hold: the JAX package's flops_model.step_cost at 256
# devices and its memory model's total on the 16x16 mesh under the
# baseline rules, for DRYRUN_PAIR (tests/test_torch_launch_roofline.py
# holds these numbers to that package)
DRYRUN_PAIR, DRYRUN_TIMEOUT_S = ("gemma-7b", "train_4k"), 300
DRYRUN_WANT = {"flops_per_device": 284955242397696.0,
               "bytes_per_device": 602396557312.0,
               "memory_total": 22243623140.0}
# the port's own count of each STEP_RUNS step (eager_cost on meta at the
# step's cut shape), in a child on the CPU while the card works
PORT_COSTS_TIMEOUT_S = 300
# phase 27 (slice 18): one pair of gloo ranks sharing the card for the
# SPMD step at full width (27a: impala-shallow on catch, MAIN_B envs x
# MAIN_T a shard, SPMD_ROUNDS rounds, held to the one-rank routes at
# SPMD_BAR of the params' largest magnitude) and olmoe-1b-7b's experts
# split over the two (27c); 27b runs the CLI's SPMD learner, one NCCL
# rank, meanwhile in this process
SPMD_ROUNDS = 3
SPMD_BAR = 1e-6
SPMD_ARGV = ASYNC_ARGV + ["--learner-mode", "spmd"]
PAIR_TIMEOUT_S = 300
# phase 23b's first batch (tokens, sampled actions, logits) on the host:
# 27c's one-device route
SAVED_SERVE = {}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def _inputs(t, b, a, seed, device):
    """Time-major K2 inputs made on the CPU from a seed, moved to the card.
    The actions are drawn from a behaviour policy near the target one, as
    an actor a few updates behind draws them in training."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(t, b, a, generator=g) * 2.0
    b_logp = torch.log_softmax(
        logits + torch.randn(t, b, a, generator=g) * 0.3, -1)
    actions = torch.multinomial(b_logp.exp().reshape(-1, a), 1,
                                generator=g).reshape(t, b)
    onehot = torch.nn.functional.one_hot(actions, a).to(torch.float32)
    blp = torch.sum(b_logp * onehot, -1)
    disc = torch.where(torch.rand(t, b, generator=g) < 0.1, 0.0, 0.97)
    rew = torch.randn(t, b, generator=g)
    v = torch.randn(t, b, generator=g)
    vtp1 = torch.cat([v[1:], torch.randn(1, b, generator=g)], 0)
    return tuple(x.to(device) for x in
                 (logits, onehot, blp, disc, rew, v, vtp1))


def _log_rhos(inp):
    """log pi(a|x) - log mu(a|x) of K2's inputs: what K1 is given."""
    logits, onehot, blp = inp[:3]
    return torch.sum(torch.log_softmax(logits, -1) * onehot, -1) - blp


def _weights(log_rhos, rho_bar, c_bar, lambda_):
    rhos = torch.exp(log_rhos)
    rho = rhos if rho_bar is None else torch.clamp(rhos, max=rho_bar)
    c = lambda_ * (rhos if c_bar is None else torch.clamp(rhos, max=c_bar))
    return rho, c


def _check(name: str, got, want) -> float:
    """Hold each output element to ATOL; return the max abs error."""
    worst = 0.0
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        if not err <= ATOL:
            raise AssertionError(
                f"{name}: max abs error {err:.3e} exceeds {ATOL:.0e} "
                f"(max |want| {float(w.abs().max()):.3e})")
        worst = max(worst, err)
    return worst


def _total(outs, v):
    """The IMPALA total assembled from K2's outputs (vs/pg_adv targets)."""
    tlp, ne, vs, pg = outs
    return (-torch.sum(pg.detach() * tlp)
            + 0.5 * torch.sum(torch.square(vs.detach() - v))
            + 0.01 * torch.sum(ne))


def phase_k1(vk, dev, shapes=K1_SHAPES) -> float:
    worst = 0.0
    for t, b in shapes:
        inp = _inputs(t, b, 3, t * 7 + b, dev)
        for clip in CLIPS:
            rho, c = _weights(_log_rhos(inp), *clip)
            args = (rho, c) + inp[3:]
            err = _check(f"K1 {(t, b)} clip={clip}", vk.vtrace(*args),
                         vk.vtrace_plain(*args))
            worst = max(worst, err)
        print(f"K1 (T,B)={(t, b)}: max abs err over {len(CLIPS)} clip "
              f"settings {worst:.3e}")
    return worst


def phase_k2(vk, dev, shapes=K2_SHAPES) -> float:
    worst = 0.0
    for t, b, a in shapes:
        inp = _inputs(t, b, a, t * 131 + b * 7 + a, dev)
        fwd = grad = 0.0
        for clip in CLIPS:
            kw = dict(zip(("rho_bar", "c_bar", "lambda_"), clip))
            fwd = max(fwd, _check(f"K2 forward {(t, b, a)} clip={clip}",
                                  vk.loss_vtrace(*inp, **kw),
                                  vk.loss_vtrace_plain(*inp, **kw)))
            lg_k = inp[0].clone().requires_grad_()
            lg_p = inp[0].clone().requires_grad_()
            g_k, = torch.autograd.grad(
                _total(vk.fused_loss_vtrace(lg_k, *inp[1:], **kw), inp[5]),
                lg_k)
            g_p, = torch.autograd.grad(
                _total(vk.loss_vtrace_plain(lg_p, *inp[1:], **kw), inp[5]),
                lg_p)
            grad = max(grad, _check(f"K2 d_logits {(t, b, a)} clip={clip}",
                                    [g_k], [g_p]))
        worst = max(worst, fwd)
        print(f"K2 (T,B,A)={(t, b, a)}: max abs err over {len(CLIPS)} clip "
              f"settings, forward {fwd:.3e}, d_logits {grad:.3e}")
    return worst


def phase_main(vk, dev):
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.losses import impala_loss
    from repro_torch.launch import train as train_lib

    argv = ["--device", "cuda", "--env", "catch", "--arch", "impala-shallow",
            "--steps", str(MAIN_STEPS), "--log-every", "25"]
    vk.reset_launch_counts()
    run = train_lib.train(argv)
    k2_train = vk.loss_vtrace.launches
    if k2_train != MAIN_STEPS or vk.vtrace.launches != 0:
        raise AssertionError(f"K2 launched {k2_train} times in "
                             f"{MAIN_STEPS} learner steps (K1: "
                             f"{vk.vtrace.launches}); expected one K2 "
                             f"launch per step and no K1")
    # K1 on the path: the plain V-trace kernel's loss on the last batch
    batch = run.last_batch
    with torch.no_grad():
        logits, values, _ = learner_lib.forward_trajectory(
            run.params, batch, run.arch, run.env.num_actions)
    loss_batch = {k: batch[k] for k in ("actions", "rewards", "discounts",
                                        "behaviour_logprob")}
    loss_batch["bootstrap_value"] = values[:, -1]
    lg, vv = logits[:, :-1], values[:, :-1]
    total_k1, m_k1 = impala_loss(run.icfg, lg, vv, loss_batch, impl="pallas")
    torch.cuda.synchronize()
    launches = {"vtrace": vk.vtrace.launches,
                "loss_vtrace": vk.loss_vtrace.launches}
    if launches["vtrace"] < 1:
        raise AssertionError("K1 was not launched on the main path")

    # what came out: finite, of the expected shape, params moved, and the
    # kernel routes agree with the reverse loop on the last actor batch
    t, b, a = MAIN_T, MAIN_B, run.env.num_actions
    if tuple(logits.shape) != (b, t + 1, a) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite "
                             f"(B,T+1,A)=({b},{t + 1},{a})")
    loss = float(run.metrics["loss/total"])
    if not math.isfinite(loss):
        raise AssertionError(f"final loss {loss} is not finite")
    moved = _params_moved(run, dev)
    total_scan, m_scan = impala_loss(run.icfg, lg, vv, loss_batch,
                                     impl="scan")
    total_fused, _ = impala_loss(run.icfg, lg, vv, loss_batch, impl="fused")
    for name, got in (("pallas", total_k1), ("fused", total_fused)):
        want = float(total_scan)
        if not abs(float(got) - want) <= 1e-4 + 1e-5 * abs(want):
            raise AssertionError(f"impala_loss impl={name} {float(got)} vs "
                                 f"scan {want}")
    _check("impl=pallas mean vs against scan", [m_k1["vtrace/mean_vs"]],
           [m_scan["vtrace/mean_vs"]])
    first, last = run.log[0], run.log[-1]
    print(f"main path: {MAIN_STEPS} learner steps, K2 launches "
          f"{k2_train}, final loss {loss:.4f}, params moved (max |dp| "
          f"{moved:.3e})")
    print(f"main path: return(100) {first['return100']:.3f} at step "
          f"{first['step']} -> {last['return100']:.3f} at step "
          f"{last['step']}; frames/s {run.fps:.0f} (steady window after "
          f"the first update)")
    print(f"main path: impala_loss total pallas {float(total_k1):.6f} "
          f"fused {float(total_fused):.6f} scan {float(total_scan):.6f}")
    return launches, run


def _params_moved(run, dev) -> float:
    """Max |trained - initial| over the params of a run seeded 0; raises
    where training left them as they were."""
    from repro_torch import params as params_lib
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    specs = bb.backbone_specs(run.arch, run.env.num_actions)
    init = params_lib.from_jax(common.init_params(specs, 0), dev,
                               requires_grad=False)
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(
        params_lib.tree_leaves(run.params), params_lib.tree_leaves(init)))
    if not moved > 0:
        raise AssertionError("params did not change in training")
    return moved


def phase_bandit() -> float:
    """The JAX package's learning bar (tests/test_system.py,
    test_full_pipeline_learns_bandit), through the CLI on the card."""
    from repro_torch.launch import train as train_lib

    run = train_lib.train([
        "--device", "cuda", "--env", "bandit", "--smoke", "--unroll", "16",
        "--lr", "1e-3", "--entropy-cost", "0.005", "--rmsprop-eps", "0.01",
        "--policy-lag", "1", "--num-envs", "32",
        "--steps", str(BANDIT_STEPS), "--log-every", "50"])
    final = run.tracker.mean_return(200)
    if not final > BANDIT_BAR:
        raise AssertionError(f"bandit mean return(200) {final:.3f} after "
                             f"{BANDIT_STEPS} steps; the bar is "
                             f"{BANDIT_BAR}")
    print(f"learning bar: bandit mean return(200) {final:.3f} > "
          f"{BANDIT_BAR} after {BANDIT_STEPS} steps")
    return final


_WORKER_THREADS = ("actor-", "inference-driver", "inference-service",
                   "inference-frontend", "param-server", "shm-drain",
                   "socket-", "metrics-http", "telemetry-sink")


def _no_actor_threads(what: str) -> None:
    """An actor thread (or a transport's or service's thread) still alive
    after its run returned would go on issuing work on the card, into
    later phases and the interpreter's exit; so would a child process."""
    import multiprocessing as mp

    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(_WORKER_THREADS)]
    if alive:
        raise AssertionError(f"{what}: actor threads {alive} outlive the run")
    children = mp.active_children()
    if children:
        raise AssertionError(f"{what}: child processes {children} outlive "
                             f"the run")


def _async_run(vk, argv, steps: int = ASYNC_STEPS, during=None):
    """``repro_torch.launch.train`` with ``argv`` for ``steps`` updates
    (its ``--steps``), the launch counts zeroed just before and read just
    after.
    Near its end ``ASYNC_WINDOW`` updates are timed on the host clock
    between two synchronises, then ``ASYNC_PROFILED`` run under
    ``torch.profiler`` (device activity only: reading a trace's events
    back costs host seconds per ten thousand), and ``ASYNC_WINDOW`` more
    before the run ends. ``during()``, if given, runs once at the
    window's first update, while the actors run. Returns (run, launches,
    telemetry read before the window, unprofiled and profiled ms an
    update, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as train_lib

    w, p = ASYNC_WINDOW, ASYNC_PROFILED
    first = steps - 2 * w - p
    marks, before = {}, {}
    prof = profile(activities=[ProfilerActivity.CUDA])

    def window(step, params, metrics, snapshot_fn):
        if step == first:
            # the rates before the window's synchronises and profiling
            before.update(snapshot_fn())
            if during is not None:
                during()
        if step in (first, first + w, first + w + p):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()
        if step == first + w:
            prof.start()
            # the learner's first launches clear the window's start; the
            # actors' launches in the pad are left out (``ASYNC_SKIP_US``)
            _trace_pad()
            marks[step] = time.perf_counter()
        elif step == first + w + p:
            prof.stop()

    vk.reset_launch_counts()
    run = train_lib.train(argv, on_update=window)
    torch.cuda.synchronize()
    launches = {"vtrace": vk.vtrace.launches,
                "loss_vtrace": vk.loss_vtrace.launches}
    _no_actor_threads(" ".join(argv))
    update_ms = (marks[first + w] - marks[first]) / w * 1e3
    profiled_ms = (marks[first + w + p] - marks[first + w]) / p * 1e3
    print(f"async split: {update_ms:.3f} ms an update unprofiled, "
          f"{profiled_ms:.3f} ms profiled (updates {first}-{first + w} and "
          f"{first + w}-{first + w + p})")
    return run, launches, before, update_ms, prof


def phase_async(vk, dev):
    """The async path at full width, K1/K2 counted over exactly it; near
    its end the card's busy time per update against the unprofiled
    update (``_async_run``)."""
    run, launches, before, update_ms, prof = _async_run(vk, ASYNC_ARGV)
    tel = run.telemetry
    frames_per_traj = MAIN_B * MAIN_T
    got = (tel["learner_updates"], tel["param_version"],
           launches["loss_vtrace"], launches["vtrace"])
    if got != (ASYNC_STEPS, ASYNC_STEPS, ASYNC_STEPS, 0):
        raise AssertionError(f"async path: (updates, version, K2 launches, "
                             f"K1 launches) {got}; expected "
                             f"{(ASYNC_STEPS,) * 3 + (0,)}")
    loss = float(run.metrics["loss/total"])
    if not math.isfinite(loss):
        raise AssertionError(f"async final loss {loss} is not finite")
    moved = _params_moved(run, dev)
    lag, q = tel["lag"], tel["queue"]
    if not lag["max"] > 0 or \
            lag["measured"] * frames_per_traj != tel["frames_consumed"]:
        raise AssertionError(f"async lag {lag} against frames_consumed "
                             f"{tel['frames_consumed']} / {frames_per_traj}")
    returns = run.tracker.completed
    print(f"async path: {ASYNC_STEPS} updates, K2 launches "
          f"{launches['loss_vtrace']} K1 {launches['vtrace']}, final loss "
          f"{loss:.4f}, params moved (max |dp| {moved:.3e})")
    print(f"async path: learner frames/s {before['frames_per_sec']:.0f}, "
          f"actor frames/s {before['actors']['actor_fps']:.0f}, updates/s "
          f"{before['updates_per_sec']:.2f} (steady window before the "
          f"timed updates); batch sizes "
          f"{dict(sorted(tel['batch_size_hist'].items()))}; lag mean "
          f"{lag['mean']:.3f} max {lag['max']} over {lag['measured']} "
          f"trajectories; queue occupancy {q['mean_occupancy']:.3f} of "
          f"{q['capacity']}, put stalls {q['put_stalls']}, get stalls "
          f"{q['get_stalls']}, drops {q['dropped']}")
    early = float(sum(returns[:500])) / max(1, len(returns[:500]))
    late = run.tracker.mean_return(100)
    cleared = late > early + CATCH_CLIMB and late > CATCH_LATE
    print(f"async path: {len(returns)} episodes, first 500 mean "
          f"{early:.3f}, last 100 mean {late:.3f}: "
          + ("clears" if cleared else "misses")
          + " phase 6b's bar (this full-width run is not held to it)")
    busy = _print_busy("async update", prof, ASYNC_PROFILED, update_ms,
                       "loss_vtrace", skip_us=ASYNC_SKIP_US)
    return launches, before, busy


def phase_async_replay(vk, dev, argv=REPLAY_ARGV, steps: int = ASYNC_STEPS,
                       what: str = "async replay"):
    """The async path with replay at full width (fraction 0.5, reuse 2):
    every update trains on the replay loss, so K1 launches exactly once an
    update and K2 never. Returns the launches and the learner frames/s."""
    run, launches, before, update_ms, prof = _async_run(vk, argv, steps)
    tel = run.telemetry
    rp = tel["replay"]
    got = (tel["learner_updates"], tel["param_version"],
           launches["vtrace"], launches["loss_vtrace"])
    if got != (steps, steps, steps, 0):
        raise AssertionError(f"{what}: (updates, version, K1 launches, K2 "
                             f"launches) {got}; expected "
                             f"{(steps,) * 3 + (0,)}")
    loss = float(run.metrics["loss/total"])
    if not math.isfinite(loss) or "vtrace/traj_adv_mag" in run.metrics:
        raise AssertionError(f"{what} final metrics {run.metrics}")
    moved = _params_moved(run, dev)
    frames_per_traj = MAIN_B * MAIN_T
    trained = sum(int(k) * n for k, n in tel["batch_size_hist"].items())
    if not (rp["sampled"] > 0 and rp["fresh_max"] == 2
            and rp["frames_trained"] == trained * frames_per_traj
            and rp["staleness"]["measured"] == rp["sampled"]
            and rp["target_syncs"] == steps // 16):
        raise AssertionError(f"{what} telemetry {rp}")
    print(f"{what}: {run.env.name}, {steps} updates, K1 launches "
          f"{launches['vtrace']} K2 {launches['loss_vtrace']}, final loss "
          f"{loss:.4f}, params moved (max |dp| {moved:.3e})")
    print(f"{what}: sampled {rp['sampled']}, reuse_ratio "
          f"{rp['reuse_ratio']:.4f}, target_syncs {rp['target_syncs']} "
          f"(period {rp['target_period']}), fresh_max {rp['fresh_max']}, "
          f"occupancy {rp['occupancy']}, evicted exhausted "
          f"{rp['evicted_exhausted']}, staleness mean "
          f"{rp['staleness']['mean']:.3f} max {rp['staleness']['max']}; "
          f"batch sizes {dict(sorted(tel['batch_size_hist'].items()))}")
    print(f"{what}: learner frames/s {before['frames_per_sec']:.0f} "
          f"(env frames consumed), trained frames/s "
          f"{before['replay']['trained_frames_per_sec']:.0f}, actor "
          f"frames/s {before['actors']['actor_fps']:.0f}, updates/s "
          f"{before['updates_per_sec']:.2f}; lag mean "
          f"{tel['lag']['mean']:.3f}; "
          f"{len(run.tracker.completed)} episodes, last 100 mean "
          f"{run.tracker.mean_return(100):.3f}")
    _print_busy(f"{what} update", prof, ASYNC_PROFILED, update_ms, "vtrace",
                skip_us=ASYNC_SKIP_US)
    return launches, before["frames_per_sec"]


def phase_replay_bar(dev) -> float:
    """tests/test_replay.py's acceptance run (catch with replay at half
    the env frames), on the card, held to that test's bar."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.distributed import run_async_training

    cfg = ImpalaConfig(num_actions=3, unroll_length=8, learning_rate=1e-3,
                       entropy_cost=0.003, rmsprop_eps=0.01,
                       replay_fraction=0.5, replay_reuse=2,
                       replay_capacity=512)
    tracker, metrics, tel = run_async_training(
        "catch", cfg, 16, REPLAY_BAR_STEPS, num_actors=2,
        actor_backend="thread", queue_capacity=8, queue_policy="block",
        max_batch_trajs=4, seed=0, device=dev)
    _no_actor_threads("replay learning run")
    returns = tracker.completed
    early = float(sum(returns[:20])) / max(1, len(returns[:20]))
    late = float(sum(returns[-20:])) / max(1, len(returns[-20:]))
    rp = tel["replay"]
    if not (len(returns) > 40 and late > early + REPLAY_CLIMB
            and rp["reuse_ratio"] > 1.5 and rp["sampled"] > 0
            and math.isfinite(float(metrics["loss/total"]))):
        raise AssertionError(f"replay catch: {len(returns)} episodes, last "
                             f"20 mean {late:.3f}, first 20 mean "
                             f"{early:.3f}, reuse_ratio "
                             f"{rp['reuse_ratio']:.3f}; the bar is a climb "
                             f"of more than {REPLAY_CLIMB} and a reuse "
                             f"ratio above 1.5")
    print(f"replay learning bar: catch (smoke impala-shallow, 16 envs, "
          f"unroll 8) last 20 mean {late:.3f} > first 20 mean {early:.3f} "
          f"+ {REPLAY_CLIMB}; reuse_ratio {rp['reuse_ratio']:.4f} > 1.5; "
          f"{len(returns)} episodes, sampled {rp['sampled']}, batch sizes "
          f"{dict(sorted(tel['batch_size_hist'].items()))}")
    return late


def phase_sync_replay(vk):
    """The sync CLI with replay: the batch is half replayed rows and the
    standard loss, so K2 launches once a step and K1 never."""
    from repro_torch.launch import train as train_lib

    vk.reset_launch_counts()
    run = train_lib.train(["--device", "cuda", "--replay-fraction", "0.5",
                           "--steps", str(SYNC_REPLAY_STEPS),
                           "--log-every", str(SYNC_REPLAY_STEPS // 2)])
    torch.cuda.synchronize()
    got = (vk.loss_vtrace.launches, vk.vtrace.launches)
    if got != (SYNC_REPLAY_STEPS, 0) or \
            not math.isfinite(float(run.metrics["loss/total"])):
        raise AssertionError(f"sync replay: (K2, K1) launches {got} in "
                             f"{SYNC_REPLAY_STEPS} steps, final loss "
                             f"{float(run.metrics['loss/total'])}")
    print(f"sync replay: {SYNC_REPLAY_STEPS} steps, K2 launches {got[0]} "
          f"K1 {got[1]}, frames/s {run.fps:.0f}, final loss "
          f"{float(run.metrics['loss/total']):.4f}")
    return got[0]


def _host_equal(what: str, got, want) -> None:
    """Two trees of host numpy leaves, equal bit for bit."""
    from repro_torch import params as params_lib

    got, want = params_lib.flatten(got), params_lib.flatten(want)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys differ")
    for k, v in want.items():
        if got[k].dtype != v.dtype or got[k].shape != v.shape or \
                got[k].tobytes() != v.tobytes():
            raise AssertionError(f"{what}: {k} differs")


def phase_checkpoints(dev) -> None:
    """Checkpoints on the card, at full width: a sync CLI run resumed by a
    second; an async runtime run writing fleet-v1 every
    ``CKPT_EVERY`` updates, resumed with its version stream continuing.
    Restored trees equal the saved ones bit for bit, and a checkpoint
    written on the card loads into the port on the CPU."""
    import shutil

    import numpy as np

    from repro_torch import params as params_lib
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.envs import make_catch
    from repro_torch.distributed import run_async_training, runtime
    from repro_torch.launch import train as train_lib

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        d = str(root / "sync")
        argv = ["--device", "cuda", "--ckpt-dir", d, "--ckpt-every",
                str(CKPT_EVERY), "--log-every", str(CKPT_EVERY)]
        first = train_lib.train(argv + ["--steps", str(2 * CKPT_EVERY)])
        saved = params_lib.to_jax(first.params)
        restored, step = ckpt.restore(d, first.params)
        _host_equal("sync checkpoint", params_lib.to_jax(restored), saved)
        second = train_lib.train(argv + ["--steps", str(3 * CKPT_EVERY)])
        if step != 2 * CKPT_EVERY or \
                [e["step"] for e in second.log] != [3 * CKPT_EVERY] or \
                ckpt.latest_step(d) != 3 * CKPT_EVERY:
            raise AssertionError(f"sync resume: restored step {step}, "
                                 f"second run logged {second.log}")
        cpu, _ = ckpt.restore(d, params_lib.from_jax(saved, "cpu"),
                              step=2 * CKPT_EVERY)
        _host_equal("card checkpoint on the CPU", params_lib.to_jax(cpu),
                    saved)
        print(f"checkpoints: sync CLI saved at steps {CKPT_EVERY} and "
              f"{2 * CKPT_EVERY}, a second run restored step {step} and "
              f"went on to {3 * CKPT_EVERY}; restored params bit for bit, "
              f"also on the CPU")

        d = str(root / "async")
        env = make_catch()
        arch = get_config("impala-shallow").replace(image_hw=env.image_hw)
        cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                           learning_rate=6e-4, entropy_cost=0.003,
                           rmsprop_eps=0.01)
        kw = dict(num_actors=2, max_batch_trajs=4, seed=0, arch=arch,
                  device=dev)
        # the runtime's own set-up and checkpoint writer, driven here so
        # the learner's state can be read when each checkpoint is written
        learner = runtime._setup(env, cfg, MAIN_B, **kw)
        live = {}

        def keep(step, params, metrics, snapshot_fn):
            if step % CKPT_EVERY == 0:
                live[step] = (params_lib.to_jax(params),
                              learner.opt_state_host())

        learner.run(2 * CKPT_EVERY, on_update=keep,
                    on_checkpoint=runtime.fleet_checkpointer(d),
                    ckpt_every=CKPT_EVERY)
        _no_actor_threads("async checkpoint run")
        tree, step, extra = ckpt.load_with_extra(d)
        if (step, extra) != (2 * CKPT_EVERY, {"version": 2 * CKPT_EVERY,
                                              "format": "fleet-v1"}):
            raise AssertionError(f"async checkpoint: step {step} {extra}")
        _host_equal("async fleet params", tree["params"],
                    live[2 * CKPT_EVERY][0])
        _host_equal("async fleet optimizer state", tree["opt"],
                    live[2 * CKPT_EVERY][1])
        earlier, _, _ = ckpt.load_with_extra(d, step=CKPT_EVERY)
        _host_equal("async fleet optimizer state, first save",
                    earlier["opt"], live[CKPT_EVERY][1])
        if all(np.array_equal(a, b) for a, b in zip(
                params_lib.flatten(earlier["opt"]).values(),
                params_lib.flatten(tree["opt"]).values())):
            raise AssertionError("async checkpoint: the optimizer moments "
                                 "did not move between the two saves")
        params = params_lib.from_jax(tree["params"], dev)
        opt = params_lib.from_jax(tree["opt"], dev, requires_grad=False)
        _host_equal("fleet params on the card", params_lib.to_jax(params),
                    tree["params"])
        _host_equal("fleet optimizer state on the card",
                    params_lib.to_jax(opt), tree["opt"])
        seen = []
        _, metrics, tel = run_async_training(
            env, cfg, MAIN_B, 3 * CKPT_EVERY, initial_params=params,
            initial_opt_state=opt, start_step=step,
            on_update=lambda u, p, m, f: seen.append(u), **kw)
        _no_actor_threads("async resumed run")
        if seen != list(range(step + 1, 3 * CKPT_EVERY + 1)) or \
                tel["param_version"] != 3 * CKPT_EVERY or \
                not math.isfinite(float(metrics["loss/total"])):
            raise AssertionError(f"async resume: updates {seen}, version "
                                 f"{tel['param_version']}")
        print(f"checkpoints: async runtime wrote fleet-v1 at versions "
              f"{CKPT_EVERY} and {2 * CKPT_EVERY}; resumed, its updates "
              f"ran {seen[0]}-{seen[-1]} to version {tel['param_version']};"
              f" params and optimizer state saved as the learner held "
              f"them and restored bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_async_bar(dev) -> float:
    """tests/test_process_actors.py's acceptance run (thread backend), on
    the card, held to that test's bar."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.envs import make_catch
    from repro_torch.distributed import run_async_training

    env = make_catch()
    arch = get_smoke_config("impala-shallow").replace(image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                       learning_rate=6e-4, entropy_cost=0.003,
                       rmsprop_eps=0.01)
    tracker, metrics, tel = run_async_training(
        "catch", cfg, num_envs=32, steps=BAR_STEPS, num_actors=2,
        queue_capacity=8, queue_policy="block", max_batch_trajs=4, seed=0,
        arch=arch, device=dev)
    _no_actor_threads("async learning run")
    returns = tracker.completed
    early = float(sum(returns[:500])) / len(returns[:500])
    late = tracker.mean_return(100)
    if not (tel["learner_updates"] == tel["param_version"] == BAR_STEPS
            and math.isfinite(float(metrics["loss/total"]))
            and tel["lag"]["max"] > 0):
        raise AssertionError(f"async learning run: {tel['learner_updates']} "
                             f"updates, version {tel['param_version']}, "
                             f"lag {tel['lag']}")
    if not (late > early + CATCH_CLIMB and late > CATCH_LATE):
        raise AssertionError(f"async catch: last 100 mean {late:.3f}, first "
                             f"500 mean {early:.3f}; the bar is a climb of "
                             f"more than {CATCH_CLIMB} to above {CATCH_LATE}")
    print(f"async learning bar: catch (smoke impala-shallow) last 100 mean "
          f"{late:.3f} > first 500 mean {early:.3f} + {CATCH_CLIMB}, and > "
          f"{CATCH_LATE}; {len(returns)} episodes, batch sizes "
          f"{dict(sorted(tel['batch_size_hist'].items()))}, learner "
          f"frames/s {tel['frames_per_sec']:.0f}")
    return late


# ---------------------------------------------------------------------------
# slice 8: rooms, tmaze and chase; inference mode; multi-task and PBT


def _to(tree, dev):
    """A NamedTuple tree of tensors, moved to ``dev``."""
    if isinstance(tree, tuple):
        return type(tree)(*(_to(x, dev) for x in tree))
    return tree.to(dev)


def _equal_on_host(what: str, got, want) -> None:
    """Two NamedTuple trees of tensors (one on the card), equal exactly."""
    for name, g, w in zip(want._fields, got, want):
        if isinstance(w, tuple):
            _equal_on_host(f"{what}.{name}", g, w)
        elif g.dtype != w.dtype or not torch.equal(g.cpu(), w):
            raise AssertionError(f"{what}: {name} differs between the card "
                                 f"and the CPU")


def phase_envs(dev) -> None:
    """rooms, tmaze and chase on the card against the CPU: the same
    actions and draws (made on the CPU, copied to the card), every
    state and TimeStep field equal at every step."""
    from repro_torch.data.envs import make_env

    for n, name in enumerate(("rooms", "tmaze", "chase")):
        env = make_env(name)
        gen = torch.Generator().manual_seed(100 + n)
        s_cpu = env.reset(ENV_B, gen, "cpu")
        s_dev = _to(s_cpu, dev)
        _equal_on_host(f"{name} observe", env.observe(s_dev),
                       env.observe(s_cpu))
        dones, reward = 0, 0.0
        for i in range(ENV_STEPS):
            action = torch.randint(0, env.num_actions, (ENV_B,),
                                   generator=gen)
            draws = env.draw(ENV_B, gen, "cpu")
            s_cpu, ts_cpu = env.step(s_cpu, action, draws)
            s_dev, ts_dev = env.step(s_dev, action.to(dev), _to(draws, dev))
            _equal_on_host(f"{name} step {i} state", s_dev, s_cpu)
            _equal_on_host(f"{name} step {i} TimeStep", ts_dev, ts_cpu)
            dones += int(ts_cpu.done.sum())
            reward += float(ts_cpu.reward.sum())
        print(f"envs: {name} x {ENV_B} on the card, {ENV_STEPS} steps equal "
              f"to the CPU in every field (state, token, image, reward, "
              f"done); {dones} episode ends, total reward {reward:.2f}")


def phase_chase_sync(vk, catch_fps: float) -> int:
    """Chase through the sync CLI at full width: K2 once a step at
    (20, 32, 5), K1 never."""
    from repro_torch.launch import train as train_lib

    vk.reset_launch_counts()
    run = train_lib.train(["--device", "cuda", "--env", "chase", "--steps",
                           str(CHASE_SYNC_STEPS), "--log-every",
                           str(CHASE_SYNC_STEPS // 2)])
    torch.cuda.synchronize()
    got = (vk.loss_vtrace.launches, vk.vtrace.launches)
    if got != (CHASE_SYNC_STEPS, 0) or run.env.num_actions != 5 or \
            not math.isfinite(float(run.metrics["loss/total"])):
        raise AssertionError(f"chase sync: (K2, K1) launches {got} in "
                             f"{CHASE_SYNC_STEPS} steps, final loss "
                             f"{float(run.metrics['loss/total'])}")
    print(f"chase sync: {CHASE_SYNC_STEPS} steps, K2 launches {got[0]} K1 "
          f"{got[1]}, frames/s {run.fps:.0f} against catch's {catch_fps:.0f}"
          f" (phase 5), final loss {float(run.metrics['loss/total']):.4f}, "
          f"return(100) {run.tracker.mean_return():.3f} over "
          f"{len(run.tracker.completed)} episodes")
    return got[0]


def phase_inference(vk, dev, unroll_before):
    """Inference mode at full width on catch, K2 once an update; its
    learner frames/s beside phase 6a's unroll mode, the service's
    telemetry, lag, and the card's busy share of a window. Returns K2's
    launches and the learner frames/s."""
    run, launches, before, update_ms, prof = _async_run(vk, INFER_ARGV)
    tel = run.telemetry
    inf = tel["inference"]
    lag = tel["lag"]
    got = (tel["learner_updates"], tel["param_version"],
           launches["loss_vtrace"], launches["vtrace"])
    if got != (ASYNC_STEPS, ASYNC_STEPS, ASYNC_STEPS, 0):
        raise AssertionError(f"inference mode: (updates, version, K2 "
                             f"launches, K1 launches) {got}; expected "
                             f"{(ASYNC_STEPS,) * 3 + (0,)}")
    loss = float(run.metrics["loss/total"])
    if not (math.isfinite(loss) and tel["actor_mode"] == "inference"
            and inf["flushes"] > 0 and lag["max"] > 0
            and lag["measured"] * MAIN_B * MAIN_T == tel["frames_consumed"]
            and sum(inf["batch_size_hist"].values()) == inf["flushes"]):
        raise AssertionError(f"inference mode: loss {loss}, lag {lag}, "
                             f"inference {inf}")
    moved = _params_moved(run, dev)
    print(f"inference mode: {ASYNC_STEPS} updates, K2 launches "
          f"{launches['loss_vtrace']} K1 {launches['vtrace']}, final loss "
          f"{loss:.4f}, params moved (max |dp| {moved:.3e})")
    print(f"inference mode: learner frames/s {before['frames_per_sec']:.0f},"
          f" actor frames/s {before['actors']['actor_fps']:.0f}, updates/s "
          f"{before['updates_per_sec']:.2f}; unroll mode (phase 6a, same "
          f"process) learner frames/s {unroll_before['frames_per_sec']:.0f},"
          f" actor frames/s {unroll_before['actors']['actor_fps']:.0f}")
    print(f"inference service: flushes {inf['flushes']} (full "
          f"{inf['flush_full']}, ready {inf['flush_ready']}, timeout "
          f"{inf['flush_timeout']}), batch sizes {inf['batch_size_hist']}, "
          f"mean batch {inf['mean_batch']:.3f} requests, requests "
          f"{inf['requests']}, padded {inf['padded_requests']}, frames "
          f"{inf['frames']}, queue wait p50 {inf['queue_wait_ms_p50']:.3f} "
          f"ms p95 {inf['queue_wait_ms_p95']:.3f} ms (bucket upper bounds);"
          f" lag mean {lag['mean']:.3f} max {lag['max']} over "
          f"{lag['measured']} trajectories; batch sizes "
          f"{dict(sorted(tel['batch_size_hist'].items()))}")
    _print_busy("inference-mode update", prof, ASYNC_PROFILED, update_ms,
                "loss_vtrace", skip_us=ASYNC_SKIP_US)
    return launches["loss_vtrace"], before["frames_per_sec"]


def phase_inference_bar(dev) -> float:
    """tests/test_inference_service.py's acceptance run, thread backend,
    on the card, held to that test's bar."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.envs import make_catch
    from repro_torch.distributed import run_async_training

    env = make_catch()
    arch = get_smoke_config("impala-shallow").replace(image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                       learning_rate=6e-4, entropy_cost=0.003,
                       rmsprop_eps=0.01)
    tracker, metrics, tel = run_async_training(
        "catch", cfg, num_envs=32, steps=BAR_STEPS, num_actors=2,
        actor_backend="thread", actor_mode="inference", transport="inproc",
        queue_capacity=8, queue_policy="block", max_batch_trajs=4, seed=0,
        arch=arch, device=dev)
    _no_actor_threads("inference learning run")
    returns = tracker.completed
    early = float(sum(returns[:500])) / len(returns[:500])
    late = tracker.mean_return(100)
    if not (tel["learner_updates"] == BAR_STEPS
            and math.isfinite(float(metrics["loss/total"]))
            and tel["lag"]["measured"] > 0 and tel["lag"]["max"] > 0
            and tel["inference"]["flushes"] > 0):
        raise AssertionError(f"inference learning run: "
                             f"{tel['learner_updates']} updates, lag "
                             f"{tel['lag']}, inference {tel['inference']}")
    if not (late > early + CATCH_CLIMB and late > CATCH_LATE):
        raise AssertionError(f"inference catch: last 100 mean {late:.3f}, "
                             f"first 500 mean {early:.3f}; the bar is a "
                             f"climb of more than {CATCH_CLIMB} to above "
                             f"{CATCH_LATE}")
    print(f"inference learning bar: catch (smoke impala-shallow, thread "
          f"backend) last 100 mean {late:.3f} > first 500 mean {early:.3f} "
          f"+ {CATCH_CLIMB}, and > {CATCH_LATE}; {len(returns)} episodes, "
          f"flushes {tel['inference']['flushes']}, lag mean "
          f"{tel['lag']['mean']:.3f} max {tel['lag']['max']}, learner "
          f"frames/s {tel['frames_per_sec']:.0f}")
    return late


# ---------------------------------------------------------------------------
# slice 9: process and remote actors


def _compute_pids():
    """The pids ``nvidia-smi`` lists with a compute context on the card.
    In a container they are the host's or a stand-in (1 for every
    context), so they only count contexts; ``_holds_card`` says which
    process holds one."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _holds_card(pid: int) -> bool:
    """Whether process ``pid`` has a card's device node (``/dev/nvidia0``,
    ...) open, as every process with a CUDA context on it has; read from
    its ``/proc/<pid>/fd``. False for a process that is gone."""
    import os
    import re

    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            return True
    return False


def _check_wire_run(what, run, launches, steps: int = ASYNC_STEPS):
    """What every process or remote run must show: the update count and
    version, K2 once an update and K1 never, a finite loss, measured lag
    covering every trajectory consumed, and a clean wire."""
    tel = run.telemetry
    q, lag = tel["queue"], tel["lag"]
    got = (tel["learner_updates"], tel["param_version"],
           launches["loss_vtrace"], launches["vtrace"])
    if got != (steps, steps, steps, 0):
        raise AssertionError(f"{what}: (updates, version, K2 launches, K1 "
                             f"launches) {got}; expected "
                             f"{(steps,) * 3 + (0,)}")
    loss = float(run.metrics["loss/total"])
    errors = (q.get("drain_errors", 0) + q.get("decode_errors", 0)
              + q.get("torn_tails", 0) + q.get("remote_errors", 0))
    if not (math.isfinite(loss) and errors == 0 and lag["max"] > 0
            and lag["measured"] * MAIN_B * MAIN_T == tel["frames_consumed"]):
        raise AssertionError(f"{what}: loss {loss}, lag {lag}, queue {q}")
    return tel, q, lag, loss


def phase_process(vk, dev, thread_before):
    """Process actors at full width (6n): K2 once an update, no child with
    a CUDA context, frames/s beside 6a's thread actors."""
    seen = {}

    def during():
        import multiprocessing as mp
        import os

        seen["parent"] = os.getpid()
        seen["children"] = [p.pid for p in mp.active_children()]
        seen["pids"] = _compute_pids()
        seen["on_card"] = [p for p in [seen["parent"]] + seen["children"]
                           if _holds_card(p)]

    run, launches, before, update_ms, prof = _async_run(vk, PROC_ARGV,
                                                        during=during)
    tel, q, lag, loss = _check_wire_run("process actors", run, launches)
    if tel["actors"]["backend"] != "process" or not q["wire_received"]:
        raise AssertionError(f"process actors: actors {tel['actors']}, "
                             f"queue {q}")
    kids, pids = seen["children"], seen["pids"]
    if len(kids) != 2 or len(pids) > 1 or \
            seen["on_card"] != [seen["parent"]]:
        raise AssertionError(f"process actors: nvidia-smi lists compute "
                             f"pids {pids} while the children {kids} run "
                             f"(parent {seen['parent']}); of these, "
                             f"{seen['on_card']} have the card's device "
                             f"node open, where only the parent may")
    moved = _params_moved(run, dev)
    print(f"process actors: {ASYNC_STEPS} updates, K2 launches "
          f"{launches['loss_vtrace']} K1 {launches['vtrace']}, final loss "
          f"{loss:.4f}, params moved (max |dp| {moved:.3e})")
    print(f"process actors: nvidia-smi compute pids {pids} while children "
          f"{kids} ran; of the parent {seen['parent']} and the children "
          f"only {seen['on_card']} had the card's device node open; no "
          f"child outlived the run")
    print(f"process actors: learner frames/s {before['frames_per_sec']:.0f}"
          f", actor frames/s {before['actors']['actor_fps']:.0f}, updates/s"
          f" {before['updates_per_sec']:.2f}; thread actors (phase 6a, same "
          f"process) learner frames/s {thread_before['frames_per_sec']:.0f}"
          f", actor frames/s {thread_before['actors']['actor_fps']:.0f}: "
          f"{before['frames_per_sec'] / thread_before['frames_per_sec']:.2f}"
          f"x")
    print(f"process actors: wire {q['wire_received']} buffers, "
          f"{q['bytes_per_frame']:.0f} bytes each, put stalls "
          f"{q['wire_put_stalls']}; batch sizes "
          f"{dict(sorted(tel['batch_size_hist'].items()))}; lag mean "
          f"{lag['mean']:.3f} max {lag['max']}; queue occupancy "
          f"{q['mean_occupancy']:.3f}, get stalls {q['get_stalls']}; "
          f"{len(run.tracker.completed)} episodes, last 100 mean "
          f"{run.tracker.mean_return(100):.3f}")
    _print_busy("process-actor update", prof, ASYNC_PROFILED, update_ms,
                "loss_vtrace", skip_us=ASYNC_SKIP_US)
    return launches["loss_vtrace"]


def phase_process_inference(vk, dev, thread_infer_fps):
    """Process inference mode (6o): the children submit over the process
    frontend; the service's flusher thread flushes on full, ready or the
    deadline."""
    run, launches, before, update_ms, prof = _async_run(vk, PROC_INFER_ARGV)
    tel, q, lag, loss = _check_wire_run("process inference", run, launches)
    inf = tel["inference"]
    if not (tel["actor_mode"] == "inference" and inf["flushes"] > 0
            and tel["actors"]["backend"] == "process"
            and sum(inf["batch_size_hist"].values()) == inf["flushes"]
            and inf["flushes"] == inf["flush_full"] + inf["flush_ready"]
            + inf["flush_timeout"]):
        raise AssertionError(f"process inference: {inf}")
    print(f"process inference: {ASYNC_STEPS} updates, K2 launches "
          f"{launches['loss_vtrace']} K1 {launches['vtrace']}, final loss "
          f"{loss:.4f}; learner frames/s {before['frames_per_sec']:.0f}, "
          f"actor frames/s {before['actors']['actor_fps']:.0f} (thread "
          f"inference mode, phase 6j: learner frames/s "
          f"{thread_infer_fps:.0f})")
    print(f"process inference service: flushes {inf['flushes']} (full "
          f"{inf['flush_full']}, ready {inf['flush_ready']}, deadline "
          f"{inf['flush_timeout']}), batch sizes {inf['batch_size_hist']}, "
          f"mean batch {inf['mean_batch']:.3f}, padded "
          f"{inf['padded_requests']}, queue wait p50 "
          f"{inf['queue_wait_ms_p50']:.3f} ms p95 "
          f"{inf['queue_wait_ms_p95']:.3f} ms (bucket upper bounds), "
          f"deadline {1e3 * inf['flush_timeout_s']:.0f} ms; lag mean "
          f"{lag['mean']:.3f} max {lag['max']}")
    _print_busy("process-inference update", prof, ASYNC_PROFILED, update_ms,
                "loss_vtrace", skip_us=ASYNC_SKIP_US)
    return launches["loss_vtrace"]


def phase_process_bar(dev) -> float:
    """tests/test_process_actors.py's acceptance run, process half, on the
    card, held to that test's bar."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.envs import make_catch
    from repro_torch.distributed import run_async_training

    env = make_catch()
    arch = get_smoke_config("impala-shallow").replace(image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                       learning_rate=6e-4, entropy_cost=0.003,
                       rmsprop_eps=0.01)
    tracker, metrics, tel = run_async_training(
        "catch", cfg, num_envs=32, steps=BAR_STEPS, num_actors=2,
        actor_backend="process", transport="shm", queue_capacity=8,
        queue_policy="block", max_batch_trajs=4, seed=0, arch=arch,
        device=dev)
    _no_actor_threads("process learning run")
    returns = tracker.completed
    early = float(sum(returns[:500])) / len(returns[:500])
    late = tracker.mean_return(100)
    if not (tel["learner_updates"] == tel["param_version"] == BAR_STEPS
            and math.isfinite(float(metrics["loss/total"]))
            and tel["lag"]["max"] > 0
            and tel["queue"]["wire_received"] > 0):
        raise AssertionError(f"process learning run: "
                             f"{tel['learner_updates']} updates, version "
                             f"{tel['param_version']}, lag {tel['lag']}, "
                             f"queue {tel['queue']}")
    if not (late > early + CATCH_CLIMB and late > CATCH_LATE):
        raise AssertionError(f"process catch: last 100 mean {late:.3f}, "
                             f"first 500 mean {early:.3f}; the bar is a "
                             f"climb of more than {CATCH_CLIMB} to above "
                             f"{CATCH_LATE}")
    print(f"process learning bar: catch (smoke impala-shallow, process "
          f"backend) last 100 mean {late:.3f} > first 500 mean "
          f"{early:.3f} + {CATCH_CLIMB}, and > {CATCH_LATE}; "
          f"{len(returns)} episodes, wire {tel['queue']['wire_received']} "
          f"buffers, lag mean {tel['lag']['mean']:.3f} max "
          f"{tel['lag']['max']}, learner frames/s "
          f"{tel['frames_per_sec']:.0f}")
    return late


def phase_remote(vk, dev) -> int:
    """Remote actors over loopback TCP (6q), three runs; returns K2's
    launches over them."""
    k2 = 0
    for what, argv in REMOTE_RUNS:
        run, launches, before, update_ms, prof = _async_run(
            vk, argv, REMOTE_STEPS)
        tel, q, lag, loss = _check_wire_run(what, run, launches,
                                            REMOTE_STEPS)
        if tel["actors"]["backend"] != "remote" or q["frames_in"] < 1:
            raise AssertionError(f"{what}: {tel['actors']}, {q}")
        codec = q["wire_codec"]
        diet = q["traj_raw_bytes"] / max(1, q["traj_wire_bytes"])
        if codec == "bf16" and not diet > WIRE_DIET:
            raise AssertionError(f"{what}: raw/wire bytes {diet:.3f}, "
                                 f"not above {WIRE_DIET}")
        k2 += launches["loss_vtrace"]
        extra = ""
        if "inference" in tel:
            inf = tel["inference"]
            extra = (f"; flushes {inf['flushes']} (full {inf['flush_full']}"
                     f", ready {inf['flush_ready']}, deadline "
                     f"{inf['flush_timeout']}), queue wait p95 "
                     f"{inf['queue_wait_ms_p95']:.3f} ms")
        print(f"{what}: {REMOTE_STEPS} updates, K2 launches "
              f"{launches['loss_vtrace']} K1 {launches['vtrace']}, final "
              f"loss {loss:.4f}; frames in {q['frames_in']}, decode errors "
              f"{q['decode_errors']}, torn tails {q['torn_tails']}, "
              f"reconnects {q['reconnects']}; wire codec {codec}: "
              f"{q['traj_wire_bytes']} wire bytes for "
              f"{q['traj_raw_bytes']} raw ({diet:.3f}x); learner frames/s "
              f"{before['frames_per_sec']:.0f}, actor frames/s "
              f"{before['actors']['actor_fps']:.0f}; lag mean "
              f"{lag['mean']:.3f} max {lag['max']}" + extra)
        _print_busy(f"{what} update", prof, ASYNC_PROFILED, update_ms,
                    "loss_vtrace", skip_us=ASYNC_SKIP_US)
    return k2


def phase_multitask(vk, dev) -> int:
    """``train_multitask`` on catch+bandit+tmaze at full width (K2 at
    (16, 24, 4)) and each task's expert; the scores and the mean capped
    normalised scores. No bar, as in the reference benchmark."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.driver import TASK_REFS, train_multitask
    from repro_torch.core.metrics import capped_normalised_score

    arch = get_config("impala-shallow")
    tasks = list(MULTITASK_TASKS)
    vk.reset_launch_counts()
    t0 = time.perf_counter()
    multi = train_multitask(tasks, MULTITASK_STEPS, MULTITASK_ENVS, seed=0,
                            arch=arch, device=dev)
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    multi_k2 = vk.loss_vtrace.launches
    experts = {t: train_multitask([t], MULTITASK_STEPS, MULTITASK_ENVS,
                                  seed=0, arch=arch, device=dev)[t]
               for t in tasks}
    torch.cuda.synchronize()
    k2 = vk.loss_vtrace.launches
    want = (MULTITASK_STEPS, (1 + len(tasks)) * MULTITASK_STEPS)
    scores = list(multi.values()) + list(experts.values())
    if (multi_k2, k2) != want or vk.vtrace.launches or \
            not all(math.isfinite(x) for x in scores):
        raise AssertionError(f"multi-task: K2 launches {multi_k2}, {k2} "
                             f"(expected {want}), K1 {vk.vtrace.launches}, "
                             f"scores {multi} {experts}")
    rnd = [TASK_REFS[t][0] for t in tasks]
    top = [TASK_REFS[t][1] for t in tasks]
    m_score = capped_normalised_score([multi[t] for t in tasks], top, rnd)
    e_score = capped_normalised_score([experts[t] for t in tasks], top, rnd)
    for t in tasks:
        print(f"multi-task {t}: multi {multi[t]:.3f} expert "
              f"{experts[t]:.3f}")
    print(f"multi-task: mean capped normalised score multi {m_score:.3f} "
          f"experts {e_score:.3f}; {MULTITASK_STEPS} steps, "
          f"{MULTITASK_ENVS} envs a task, impala-shallow at full width; the "
          f"multi-task run {multi_s:.2f} s ({MULTITASK_STEPS} K2 launches "
          f"at (16, {MULTITASK_ENVS * len(tasks)}, 4)), {k2} K2 launches "
          f"in all")
    return k2


def phase_pbt(vk, dev) -> int:
    """``run_pbt`` at full width; an exploit copies, never aliases."""
    import numpy as np

    from repro_torch import params as params_lib
    from repro_torch.configs.registry import get_config
    from repro_torch.core import actor as actor_lib
    from repro_torch.core import driver
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.pbt import PBTController

    seen = {}

    def before_turn(rnd, i, weights):
        seen[(rnd, i)] = [params_lib.flatten(params_lib.to_jax(w))
                          for w in weights]

    vk.reset_launch_counts()
    pbt, weights, history = driver.run_pbt(
        pop=PBT_POP, rounds=PBT_ROUNDS, steps_per_round=PBT_STEPS,
        arch=get_config("impala-shallow"), device=dev,
        before_turn=before_turn)
    torch.cuda.synchronize()
    k2 = vk.loss_vtrace.launches
    want = PBT_POP * PBT_ROUNDS * 2 * PBT_STEPS
    if k2 != want or not all(math.isfinite(m.fitness) for m in pbt.members):
        raise AssertionError(f"PBT: K2 launches {k2} (expected {want}), "
                             f"fitness {[m.fitness for m in pbt.members]}")
    copies = [(h["round"], h["member"], h["copied_from"]) for h in history
              if h["round"] < PBT_ROUNDS - 1 and h["copied_from"] is not None]
    for rnd, i, src in copies:
        # the copy's next turn is in the next round
        start, end = seen[(rnd + 1, i)], seen[(rnd + 1, i + 1)]
        if all(np.array_equal(end[i][k], v) for k, v in start[i].items()):
            raise AssertionError(f"PBT: member {i} did not train in round "
                                 f"{rnd + 1}")
        for k, v in start[src].items():
            if not np.array_equal(end[src][k], v):
                raise AssertionError(f"PBT: member {src}'s {k} changed "
                                     f"while member {i} trained its copy "
                                     f"in round {rnd + 1}")
    # a forced exploit: member 1 is better by far, so member 0 copies it
    # at once; the copy then trains one step and its source stays put
    forced = PBTController(pop_size=2, seed=0)
    forced.report_fitness(0, -1.0)
    forced.report_fitness(1, 1.0)
    pair = [weights[0], weights[1]]
    if not forced.exploit_explore(0, 0, pair)[1]:
        raise AssertionError("PBT: the forced exploit did not copy")
    source = params_lib.flatten(params_lib.to_jax(pair[1]))
    copy = params_lib.flatten(params_lib.to_jax(pair[0]))
    if any(not np.array_equal(copy[k], v) for k, v in source.items()):
        raise AssertionError("PBT: the copy differs from its source")
    envs, arch, num_actions = driver.padded_suite(("catch", "bandit"),
                                            get_config("impala-shallow"))
    cfg = driver.multitask_config(num_actions)
    init_fn, unroll = actor_lib.build_actor(envs[0], arch, cfg, 8, dev)
    _, traj = unroll(pair[0], init_fn(0))
    step_fn, opt = learner_lib.build_train_step(arch, cfg, num_actions)
    trained, _, _ = step_fn(pair[0], opt.init(pair[0]), 0, traj)
    after = params_lib.flatten(params_lib.to_jax(pair[1]))
    moved = params_lib.flatten(params_lib.to_jax(trained))
    if any(not np.array_equal(after[k], v) for k, v in source.items()) or \
            all(np.array_equal(moved[k], v) for k, v in copy.items()):
        raise AssertionError("PBT: training the forced copy changed its "
                             "source, or left the copy as it was")
    best = pbt.best()
    print(f"PBT: pop {PBT_POP}, {PBT_ROUNDS} rounds of {PBT_STEPS} steps a "
          f"task (catch+bandit, impala-shallow at full width), K2 launches "
          f"{k2}; copies (round, member, source) before the last round "
          f"{copies}, each source bit for bit unchanged while its copy "
          f"trained; a forced copy trained one step, its source unchanged; "
          f"best member {best} fitness {pbt.members[best].fitness:.3f}")
    return k2


# ---------------------------------------------------------------------------
# slice 10: learner groups


class _ComputePids:
    """Samples, about once a second while a group runs, the pids
    ``nvidia-smi`` lists with a compute context, the learner workers and
    the workers' own children (their actors), read from /proc, and which
    of the workers and children have the card's device node open."""

    def __init__(self):
        self.pids, self.most, self.children = set(), 0, set()
        self.workers, self.on_card = set(), set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="compute-pids", daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        import multiprocessing as mp
        import os

        while not self._stop.wait(1.0):
            pids = _compute_pids()
            self.pids.update(pids)
            self.most = max(self.most, len(pids))
            workers = {p.pid for p in mp.active_children()}
            self.workers.update(workers)
            self.on_card.update(p for p in workers if _holds_card(p))
            for entry in os.listdir("/proc"):
                if not entry.isdigit():
                    continue
                try:
                    with open(f"/proc/{entry}/stat") as f:
                        ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                except (OSError, ValueError, IndexError):
                    continue
                if ppid in workers:
                    self.children.add(int(entry))
                    if _holds_card(int(entry)):
                        self.on_card.add(int(entry))


def _group_counts(vk, run) -> Tuple[list, list]:
    """Each learner's K1 and K2 launches in a group run, from its worker
    process; the shapes it launched them at join the wrappers' ``shapes``,
    so phase 7a holds the kernels at them too."""
    k1, k2 = [], []
    for _k, counts in sorted(run.kernel_counts.items()):
        k1.append(counts["launches"]["vtrace"])
        k2.append(counts["launches"]["loss_vtrace"])
        vk.vtrace.shapes.update(map(tuple, counts["shapes"]["vtrace"]))
        vk.loss_vtrace.shapes.update(
            map(tuple, counts["shapes"]["loss_vtrace"]))
    return k1, k2


def _check_group(what: str, vk, run, steps: int, replay: bool = False):
    """What every group run must show: identical replicas, one version
    stream ``[steps, steps]``, no stale drop, both shards consumed, slot
    bases 0 and 1, the exchange once a round in each learner, and K2 (K1
    with replay) once a round in each learner's gradient step."""
    tel = run.telemetry
    g = tel["group"]
    subs = [tel["learners"][f"learner_{k}"] for k in range(GROUP_LEARNERS)]
    k1, k2 = _group_counts(vk, run)
    per = tel["actors"]["per_learner_trajectories"]
    want_k1, want_k2 = ([steps] * GROUP_LEARNERS, [0] * GROUP_LEARNERS) \
        if replay else ([0] * GROUP_LEARNERS, [steps] * GROUP_LEARNERS)
    got = {"replicas_identical": g["replicas_identical"],
           "param_versions": g["param_versions"],
           "stale_dropped": g["stale_dropped"],
           "slot_base": [s["slot_base"] for s in subs],
           "rounds": [s["exchange"]["rounds"] for s in subs],
           "K1": k1, "K2": k2}
    want = {"replicas_identical": True,
            "param_versions": [steps] * GROUP_LEARNERS,
            "stale_dropped": 0, "slot_base": list(range(GROUP_LEARNERS)),
            "rounds": [steps] * GROUP_LEARNERS, "K1": want_k1,
            "K2": want_k2}
    loss = float(run.metrics["loss/total"])
    if got != want or not all(n > 0 for n in per.values()) or \
            not math.isfinite(loss):
        raise AssertionError(f"{what}: {got}, expected {want}; "
                             f"per-learner trajectories {per}, loss {loss}")
    print(f"{what}: {steps} rounds, replicas identical (digests "
          f"{g['param_digests']}), versions {g['param_versions']}, stale "
          f"dropped {g['stale_dropped']}, slot bases {got['slot_base']}, "
          f"exchange rounds {got['rounds']}, K1 launches {k1}, K2 {k2}, "
          f"per-learner trajectories {per}, final loss {loss:.4f}")
    return tel, subs, k1, k2


def _group_rates(what: str, tel, subs) -> None:
    fps = [s["frames_per_sec"] for s in subs]
    print(f"{what}: learner frames/s {[round(f) for f in fps]}, sum "
          f"{sum(fps):.0f}; reduce wait ms mean "
          f"{[round(s['exchange']['reduce_wait_ms_mean'], 3) for s in subs]}"
          f"; exchange bytes out {[s['exchange']['bytes_out'] for s in subs]}"
          f"; batch sizes "
          f"{[dict(sorted(s['batch_size_hist'].items())) for s in subs]}; "
          f"lag mean {tel['lag']['mean']:.3f} max {tel['lag']['max']}; "
          f"{tel['actors']['trajectories']} trajectories")


def phase_group(vk, dev, single_before) -> int:
    """6r: ``--runtime async --learners 2`` at full width, one actor
    thread a learner, ``GROUP_STEPS`` rounds; frames/s beside 6a's single
    learner and the compute pids while it runs. Returns K2's launches."""
    from repro_torch.launch import train as train_lib

    with _ComputePids() as seen:
        run = train_lib.train(GROUP_ARGV)
    _no_actor_threads("learner group")
    tel, subs, _k1, k2 = _check_group("learner group", vk, run,
                                      GROUP_STEPS)
    if seen.most > 1 + GROUP_LEARNERS or seen.on_card != seen.workers or \
            len(seen.workers) != GROUP_LEARNERS:
        raise AssertionError(f"learner group: nvidia-smi listed "
                             f"{seen.most} compute pids at once; at most "
                             f"this process and {GROUP_LEARNERS} workers "
                             f"may hold a CUDA context; workers "
                             f"{sorted(seen.workers)}, those with the "
                             f"card's device node open "
                             f"{sorted(seen.on_card)}")
    _group_rates("learner group", tel, subs)
    print(f"learner group: single learner (phase 6a, same process) learner "
          f"frames/s {single_before['frames_per_sec']:.0f}; nvidia-smi "
          f"compute pids {sorted(seen.pids)} (at most {seen.most} at once) "
          f"while the group ran, both workers "
          f"{sorted(seen.workers)} with the card's device node open; "
          f"{len(run.tracker.completed)} episodes, "
          f"last 100 mean {run.tracker.mean_return(100):.3f}")
    return sum(k2)


def phase_group_process(vk, dev) -> int:
    """6s-6t: 6r with ``--actor-backend process --transport shm`` and
    ``--replay-fraction 0.5 --replay-reuse 2`` for ``GROUP_PROC_STEPS``
    rounds: K1 once a round in each learner, K2 never; replay sampled,
    the fresh cap 2; no actor child holds a CUDA context. Its
    ``--metrics-port``, polled while it runs, shows both learners'
    ``repro_learner_updates`` and a /healthz of 200. Returns K1's
    launches."""
    from repro_torch.launch import train as train_lib

    port = _free_port()
    with _ComputePids() as seen, _GroupScrape(port) as scrape:
        run = train_lib.train(GROUP_PROC_ARGV + ["--metrics-port",
                                                 str(port)])
    _no_actor_threads("learner group, process actors")
    tel, subs, k1, _k2 = _check_group("learner group process", vk, run,
                                      GROUP_PROC_STEPS, replay=True)
    rp = tel["replay"]
    if not (rp["sampled"] > 0 and rp["fresh_max"] == 2):
        raise AssertionError(f"learner group process, replay: {rp}")
    print(f"learner group process: replay sampled {rp['sampled']}, "
          f"reuse_ratio {rp['reuse_ratio']:.4f}, target_syncs "
          f"{rp['target_syncs']}, trained frames/s "
          f"{rp['trained_frames_per_sec']:.0f}")
    if scrape.labels != {"0", "1"} or 200 not in scrape.health:
        raise AssertionError(f"learner group process: the group's /metrics "
                             f"showed repro_learner_updates for learners "
                             f"{sorted(scrape.labels)} over "
                             f"{scrape.scrapes} scrapes, /healthz "
                             f"{sorted(scrape.health)}")
    print(f"learner group process: the group's /metrics showed "
          f"repro_learner_updates for learners {sorted(scrape.labels)} "
          f"while it ran ({scrape.scrapes} scrapes), /healthz "
          f"{sorted(scrape.health)}")
    if tel["actors"]["backend"] != "process" or \
            not all(s["queue"]["wire_received"] for s in subs):
        raise AssertionError(f"learner group process: {tel['actors']}")
    if not seen.children or seen.on_card != seen.workers or \
            len(seen.workers) != GROUP_LEARNERS or \
            seen.most > 1 + GROUP_LEARNERS:
        raise AssertionError(f"learner group process: nvidia-smi compute "
                             f"pids {sorted(seen.pids)} (at most "
                             f"{seen.most} at once); of the workers "
                             f"{sorted(seen.workers)} and their children "
                             f"{sorted(seen.children)}, "
                             f"{sorted(seen.on_card)} had the card's "
                             f"device node open, where only the workers "
                             f"may")
    _group_rates("learner group process", tel, subs)
    print(f"learner group process: nvidia-smi compute pids "
          f"{sorted(seen.pids)} (at most {seen.most} at once) while the "
          f"workers' children {sorted(seen.children)} ran; of them and "
          f"the workers {sorted(seen.workers)}, only "
          f"{sorted(seen.on_card)} had the card's device node open: no "
          f"actor child holds a CUDA context")
    return sum(k1)


def _group_bar_args(dev):
    """tests/test_group.py::test_two_learner_group_learns_catch's
    configuration: ``(config, keyword arguments)`` of
    ``run_group_training`` on catch (32 envs)."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.envs import make_catch

    env = make_catch()
    arch = get_smoke_config("impala-shallow").replace(image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                       learning_rate=6e-4, entropy_cost=0.003,
                       rmsprop_eps=0.01)
    return cfg, dict(num_learners=2, num_actors=4, actor_backend="thread",
                     queue_capacity=8, queue_policy="block",
                     max_batch_trajs=4, seed=0, arch=arch, device=dev)


def phase_group_bar(vk, dev, ckpt_dir: str) -> Tuple[int, int]:
    """6u: tests/test_group.py::test_two_learner_group_learns_catch on the
    card, held to its bar; its publisher saves fleet-v1 into ``ckpt_dir``
    after the last round, for 6v. Returns K2's launches and the saved
    replicas' digest."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed import group, run_group_training

    cfg, kw = _group_bar_args(dev)
    counts = {}
    tracker, metrics, tel = run_group_training(
        "catch", cfg, 32, GROUP_BAR_STEPS, kernel_counts=counts,
        ckpt_every=GROUP_BAR_STEPS, ckpt_dir=ckpt_dir, **kw)
    _no_actor_threads("group learning run")
    returns = tracker.completed
    early = float(sum(returns[:500])) / len(returns[:500])
    late = tracker.mean_return(100)
    per = tel["actors"]["per_learner_trajectories"]
    k2 = [c["launches"]["loss_vtrace"] for _k, c in sorted(counts.items())]
    if not (tel["learner_updates"] == tel["param_version"] == GROUP_BAR_STEPS
            and tel["group"]["param_versions"] == [GROUP_BAR_STEPS] * 2
            and tel["group"]["replicas_identical"]
            and all(n > 0 for n in per.values())
            and math.isfinite(float(metrics["loss/total"]))
            and tel["lag"]["max"] > 0 and k2 == [GROUP_BAR_STEPS] * 2):
        raise AssertionError(f"group learning run: {tel['group']}, "
                             f"{tel['learner_updates']} updates, lag "
                             f"{tel['lag']}, trajectories {per}, K2 {k2}")
    if not (late > early + CATCH_CLIMB and late > CATCH_LATE):
        raise AssertionError(f"group catch: last 100 mean {late:.3f}, first "
                             f"500 mean {early:.3f}; the bar is a climb of "
                             f"more than {CATCH_CLIMB} to above {CATCH_LATE}")
    tree, step, extra = ckpt.load_with_extra(ckpt_dir)
    saved = group.params_digest(tree["params"])
    if (step, extra) != (GROUP_BAR_STEPS, {"version": GROUP_BAR_STEPS,
                                           "format": "fleet-v1"}) or \
            set(tel["group"]["param_digests"].values()) != {saved}:
        raise AssertionError(f"group checkpoint: step {step} {extra}, "
                             f"digest {saved}, the group's "
                             f"{tel['group']['param_digests']}")
    print(f"group learning bar: catch (smoke impala-shallow, 2 learners, 4 "
          f"actor threads, {GROUP_BAR_STEPS} rounds) last 100 mean "
          f"{late:.3f} > first 500 mean {early:.3f} + {CATCH_CLIMB}, and > "
          f"{CATCH_LATE}; {len(returns)} episodes, replicas identical, "
          f"per-learner trajectories {per}, lag mean "
          f"{tel['lag']['mean']:.3f} max {tel['lag']['max']}, K2 {k2}; "
          f"fleet-v1 saved at round {step} (digest {saved}, both replicas)")
    return sum(k2), saved


def phase_group_resume(vk, dev, ckpt_dir: str, saved: int) -> int:
    """6v: groups resumed from 6u's fleet-v1 checkpoint (``saved``, its
    digest, at version ``GROUP_BAR_STEPS``) in 6u's configuration: one
    with no round left publishes exactly the saved params (its digest is
    theirs), and one resumed for ``GROUP_RESUMED`` more rounds continues
    the version stream. Returns K2's launches."""
    from repro_torch.distributed import run_group_training

    cfg, kw = _group_bar_args(dev)
    v0, more = GROUP_BAR_STEPS, GROUP_BAR_STEPS + GROUP_RESUMED
    _, _, tel = run_group_training("catch", cfg, 32, v0,
                                   resume_from=ckpt_dir, **kw)
    first = tel["group"]["param_digests"]
    if set(first.values()) != {saved} or \
            tel["group"]["param_versions"] != [v0] * 2:
        raise AssertionError(f"group resume: digests {first}, versions "
                             f"{tel['group']['param_versions']}; saved "
                             f"{saved} at {v0}")
    counts = {}
    _, metrics, tel = run_group_training(
        "catch", cfg, 32, more, resume_from=ckpt_dir, kernel_counts=counts,
        **kw)
    _no_actor_threads("resumed learner group")
    g = tel["group"]
    k2 = [c["launches"]["loss_vtrace"] for _k, c in sorted(counts.items())]
    rounds = [tel["learners"][f"learner_{k}"]["exchange"]["rounds"]
              for k in range(2)]
    if not (g["param_versions"] == [more] * 2 and g["replicas_identical"]
            and rounds == [GROUP_RESUMED] * 2 and k2 == [GROUP_RESUMED] * 2
            and math.isfinite(float(metrics["loss/total"]))):
        raise AssertionError(f"resumed group: {g}, exchange rounds "
                             f"{rounds}, K2 {k2}")
    print(f"group resume: a group resumed from 6u's fleet-v1 with no round "
          f"left published its digest {saved} at version {v0} in both "
          f"workers; one resumed for {GROUP_RESUMED} rounds reached "
          f"versions {g['param_versions']}, replicas identical, exchange "
          f"rounds {rounds}, K2 {k2}")
    return sum(k2)


# ---------------------------------------------------------------------------
# slice 12: supervision


def _listening() -> set:
    """The TCP sockets in LISTEN state on this machine (every process of
    the container), as (local address, inode) from /proc/net/tcp{,6}."""
    out = set()
    for name in ("tcp", "tcp6"):
        try:
            with open(f"/proc/net/{name}") as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            if len(cols) > 9 and cols[3] == "0A":
                out.add((cols[1], cols[9]))
    return out


def _shm() -> set:
    import os

    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


class _Leftovers:
    """What a supervised phase must leave behind: nothing. Entered before
    the run; on exit (``check``) every child has exited, no process the
    run started (the ``_ComputePids`` sample, the dead ones included)
    has the card's device node open, ``nvidia-smi`` counts only this
    process's context, and no listening socket or /dev/shm entry is new."""

    def __init__(self, what: str):
        self.what = what
        self.sockets, self.shm = _listening(), _shm()

    def check(self, seen) -> None:
        _no_actor_threads(self.what)
        deadline = time.monotonic() + 20.0
        while True:
            pids = seen.workers | seen.children
            held = sorted(p for p in pids if _holds_card(p))
            contexts = _compute_pids()
            new_sockets = _listening() - self.sockets
            new_shm = _shm() - self.shm
            if not (held or len(contexts) > 1 or new_sockets or new_shm):
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{self.what}: after the run, processes {held} still "
                    f"have the card's device node open, nvidia-smi lists "
                    f"compute pids {contexts}, new listening sockets "
                    f"{sorted(new_sockets)}, new /dev/shm entries "
                    f"{sorted(new_shm)}")
            time.sleep(0.5)
        print(f"{self.what}: after the run no process of it holds the card "
              f"(of {len(pids)} seen), nvidia-smi lists {len(contexts)} "
              f"compute context(s) (this process), no new listening "
              f"socket or /dev/shm entry")


def _supervisor_line(what: str, sup) -> None:
    print(f"{what}: supervisor restarts {sup['restarts']}, failovers "
          f"{sup['failovers']}, lease reaps {sup['lease_reaps']}, epochs "
          f"{sup['epochs']}, exhausted {sup['restarts_exhausted']}")


def phase_supervised_thread(vk, single_before) -> int:
    """6y (a): 6a's settings with ``--supervise`` for ``SUP_STEPS``
    updates; actor 0's thread raises from its emit at update
    ``SUP_THREAD_KILL_AT`` and dies (the trajectory it held never reaches the
    queue). It is respawned: restarts 1, epoch 1, updates keep coming,
    the reborn thread's trajectories arrive. Learner frames/s up to the
    death (a supervised run with no death) beside 6a's. Returns K2's
    launches."""
    from repro_torch.distributed import actor_pool
    from repro_torch.launch import train as train_lib

    state = {"armed": False, "death": None, "reborn": None, "first": None,
             "after": 0}
    real = actor_pool.run_actor_loop

    def loop(**kw):
        emit, epoch0 = kw["emit"], state["death"] is None

        def chaos_emit(item):
            if kw["actor_id"] == 0:
                if epoch0 and state["armed"] and state["death"] is None:
                    state["death"] = time.monotonic()
                    raise RuntimeError("chip_smoke: actor thread shot")
                if not epoch0 and state["reborn"] is None:
                    state["reborn"] = time.monotonic()
            return emit(item)

        kw["emit"] = chaos_emit
        return real(**kw)

    def hook(step, params, metrics, snapshot_fn):
        if step == SUP_THREAD_KILL_AT:
            state["before"] = snapshot_fn()
            state["armed"] = True
        elif state["death"] is not None:
            state["after"] += 1
            if state["reborn"] is not None and state["first"] is None:
                state["first"] = time.monotonic()

    vk.reset_launch_counts()
    leftovers = _Leftovers("supervised thread actors")
    actor_pool.run_actor_loop = loop
    try:
        with _ComputePids() as seen:
            run = train_lib.train(_async_argv("catch", SUP_STEPS,
                                              "--supervise"),
                                  on_update=hook)
    finally:
        actor_pool.run_actor_loop = real
    torch.cuda.synchronize()
    k2 = vk.loss_vtrace.launches
    leftovers.check(seen)
    tel, sup = run.telemetry, run.telemetry["supervisor"]
    got = (tel["learner_updates"], sup["restarts"], sup["epochs"],
           sup["restarts_exhausted"], k2)
    want = (SUP_STEPS, 1, {"actor-0": 1}, [], SUP_STEPS)
    if got != want or state["reborn"] is None or state["first"] is None \
            or not math.isfinite(float(run.metrics["loss/total"])):
        raise AssertionError(f"supervised thread actors: (updates, "
                             f"restarts, epochs, exhausted, K2) {got}, "
                             f"expected {want}; death {state['death']}, "
                             f"reborn {state['reborn']}, first update "
                             f"after {state['first']}")
    before = state["before"]
    _supervisor_line("supervised thread actors", sup)
    print(f"supervised thread actors: {SUP_STEPS} updates, K2 {k2}; actor 0 "
          f"died at update {SUP_THREAD_KILL_AT}, {state['after']} updates "
          f"after "
          f"it; the reborn thread's first trajectory "
          f"{(state['reborn'] - state['death']) * 1e3:.1f} ms after the "
          f"death, the first update after it "
          f"{(state['first'] - state['death']) * 1e3:.1f} ms after; "
          f"learner frames/s up to the death {before['frames_per_sec']:.0f}"
          f" (supervised, no death), 6a's (unsupervised, same process) "
          f"{single_before['frames_per_sec']:.0f}: "
          f"{before['frames_per_sec'] / single_before['frames_per_sec']:.3f}"
          f"x")
    return k2


def phase_supervised_child(vk, what: str, argv, victim: str,
                           wait: bool) -> int:
    """6y (b) and (c): ``argv`` (6n's process actors, or remote loopback
    actors) with ``--supervise`` for its ``--steps`` updates; the
    child named ``victim`` is SIGKILLed at update ``SUP_KILL_AT`` and
    respawned. A trajectory of its slot produced after the death (its
    ``produced_at``, the host's monotonic clock in every process) is the
    reborn child's; with ``wait``, from the respawn until one has arrived
    from each slot, each update is paced by ``SUP_PACE_S`` so the run
    outlives the child's start-up. No child holds the card. Remote: the
    dead child's lease is reaped under the heartbeat deadline (the updates
    paced by a quarter of it until it is). Returns K2's launches."""
    import multiprocessing as mp
    import os
    import signal

    from repro_torch.distributed import procpool
    from repro_torch.launch import train as train_lib

    steps = int(argv[argv.index("--steps") + 1])
    state = {"death": None, "reap": None, "arrived": {}, "first": {},
             "spawned": None}
    real = procpool._SpawnedPool._note_arrival

    def arrival(pool, item):
        death = state["death"]
        if death is not None and item.produced_at > death:
            state["arrived"].setdefault(item.actor_id, time.monotonic())
        return real(pool, item)

    def hook(step, params, metrics, snapshot_fn):
        now = time.monotonic()
        if step == SUP_KILL_AT:
            kids = [p for p in mp.active_children() if p.name == victim]
            if not kids:
                raise AssertionError(f"{what}: no child {victim} to kill "
                                     f"among {mp.active_children()}")
            os.kill(kids[0].pid, signal.SIGKILL)
            state["death"], state["pid"] = time.monotonic(), kids[0].pid
            return
        if state["death"] is None:
            return
        if state["spawned"] is None and any(
                p.name == victim and p.pid != state["pid"]
                for p in mp.active_children()):
            state["spawned"] = now
        for slot in list(state["arrived"]):
            state["first"].setdefault(slot, now)
        if state["reap"] is None and \
                snapshot_fn()["supervisor"]["lease_reaps"]:
            state["reap"] = now
        # the live child's slot arrives at once; once the reborn child
        # runs (the pool respawns it between updates), pace the updates
        # until its slot has arrived too. Remote: until the dead lease is
        # reaped, pace them lightly so the run outlives the deadline
        if wait and state["spawned"] is not None and \
                len(state["first"]) < 2:
            time.sleep(SUP_PACE_S)
        elif "heartbeat" in " ".join(argv) and state["reap"] is None:
            time.sleep(SUP_HEARTBEAT_S / 4)

    vk.reset_launch_counts()
    leftovers = _Leftovers(what)
    procpool._SpawnedPool._note_arrival = arrival
    try:
        with _ComputePids() as seen:
            run = train_lib.train(argv + ["--supervise"], on_update=hook)
    finally:
        procpool._SpawnedPool._note_arrival = real
    torch.cuda.synchronize()
    k2 = vk.loss_vtrace.launches
    leftovers.check(seen)
    tel, sup = run.telemetry, run.telemetry["supervisor"]
    remote = "per_actor" in tel["queue"]
    if remote:
        # the reborn child reclaimed the dead slot
        slots = [int(k) for k, v in tel["queue"]["per_actor"].items()
                 if v["reconnects"]]
    else:
        slots = [int(victim.rsplit("-", 1)[1])]
    slot = slots[0] if len(slots) == 1 else None
    got = (tel["learner_updates"], sup["restarts"] >= 1,
           sup["restarts_exhausted"], k2, sorted(seen.on_card),
           state["spawned"] is not None,
           tel["queue"].get("decode_errors", 0),
           not wait or slot in state["first"],
           not remote or sup["lease_reaps"] >= 1)
    want = (steps, True, [], steps, [], True, 0, True,
            True)
    if got != want or not math.isfinite(float(run.metrics["loss/total"])):
        raise AssertionError(f"{what}: (updates, restarted, exhausted, K2, "
                             f"children with the card's device node open, "
                             f"the reborn child seen, decode errors, its "
                             f"child's trajectory arrived, a lease reap if "
                             f"remote) {got}, expected {want}; children "
                             f"seen {sorted(seen.workers)}; victim's slots "
                             f"{slots}, arrivals after the death "
                             f"{state['arrived']}, the reborn child seen "
                             f"{state['spawned']} (death {state['death']}); "
                             f"frames per actor "
                             f"{tel['actors']['frames_per_actor']}, "
                             f"supervisor {sup}")
    death = state["death"]
    _supervisor_line(what, sup)
    reborn = (f", its first trajectory arrived "
              f"{state['arrived'][slot] - death:.2f} s after the death, the "
              f"first update after it {state['first'][slot] - death:.2f} s"
              if slot in state["first"] else "")
    reap = ("" if state["reap"] is None else
            f"; the lease seen reaped by the update "
            f"{state['reap'] - death:.2f} s after the death")
    print(f"{what}: {steps} updates, K2 {k2}; {victim} (slot "
          f"{slot}) SIGKILLed at update {SUP_KILL_AT}; the reborn child "
          f"seen by the update {state['spawned'] - death:.2f} s after the "
          f"death{reborn}{reap}; of the children {sorted(seen.workers)} "
          f"none had the card's device node open; learner frames/s "
          f"{tel['frames_per_sec']:.0f}")
    return k2


def _full_width_group(dev):
    """``run_group_training``'s arguments for 6r's configuration (catch,
    impala-shallow at full width, 32 envs, unroll 20, one actor thread a
    learner, batches of up to 4) at the CLI's defaults: (config, keyword
    arguments)."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.envs import make_catch
    from repro_torch.launch import train as train_lib

    a = train_lib._parser().parse_args([])
    env = make_catch()
    arch = get_config("impala-shallow").replace(image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions,
                       unroll_length=a.unroll, learning_rate=a.lr,
                       entropy_cost=a.entropy_cost,
                       rmsprop_eps=a.rmsprop_eps)
    return cfg, dict(num_learners=GROUP_LEARNERS,
                     num_actors=GROUP_LEARNERS, actor_backend="thread",
                     queue_capacity=a.queue_capacity,
                     queue_policy=a.queue_policy, max_batch_trajs=4,
                     seed=0, arch=arch, device=dev, supervise=True,
                     telemetry_every=1)


def _kill_learner(name: str) -> None:
    import multiprocessing as mp
    import os
    import signal

    for p in mp.active_children():
        if p.name == name and p.pid:
            os.kill(p.pid, signal.SIGKILL)
            return
    raise AssertionError(f"no learner worker {name} to kill among "
                         f"{mp.active_children()}")


def phase_supervised_spoke(vk, dev) -> int:
    """6z (d): a supervised group of two at full width for
    ``SUP_GROUP_STEPS`` rounds, full checkpoints every ``SUP_GROUP_CKPT``;
    the spoke (learner 1) is SIGKILLed once it has ``SUP_GROUP_KILL_AT``
    updates and respawned from the latest checkpoint, catching up on the
    hub's replayed means: restarts 1, epoch 1, replicas bit identical,
    versions ``[steps, steps]``, K2 in the reborn worker. Returns K2's
    launches."""
    from repro_torch.distributed import RestartPolicy, run_group_training

    cfg, kw = _full_width_group(dev)
    steps = SUP_GROUP_STEPS
    state = {"death": None, "first": None, "last": 0}

    def on_progress(k, snap):
        if k != 1:
            return
        n = snap["learner_updates"]
        if state["death"] is None and n >= SUP_GROUP_KILL_AT:
            _kill_learner("learner-1")
            state["death"], state["last"] = time.monotonic(), n
        elif state["death"] is not None and state["first"] is None and \
                n < state["last"]:
            # resumed from an older checkpoint: the reborn worker
            state["first"] = time.monotonic()
            state["resumed_at"] = n

    counts = {}
    leftovers = _Leftovers("supervised group, spoke killed")
    with _ComputePids() as seen:
        _, metrics, tel = run_group_training(
            "catch", cfg, 32, steps, kernel_counts=counts,
            on_progress=on_progress, ckpt_every=SUP_GROUP_CKPT,
            restart_policy=RestartPolicy(backoff_base_s=0.0, jitter=0.0),
            **kw)
    leftovers.check(seen)
    sup, g = tel["supervisor"], tel["group"]
    k1, k2 = _group_counts(vk, types.SimpleNamespace(kernel_counts=counts))
    got = (sup["restarts"], sup["epochs"], sup["failovers"],
           g["replicas_identical"], g["param_versions"],
           tel["param_version"], "abandoned_learners" in g, k2[0],
           k2[1] > 0, k1, seen.on_card <= seen.workers,
           len(seen.workers))
    want = (1, {"learner-1": 1}, 0, True, [steps, steps], steps, False,
            steps, True, [0, 0], True, GROUP_LEARNERS + 1)
    if got != want or state["first"] is None or \
            not math.isfinite(float(metrics["loss/total"])):
        raise AssertionError(f"supervised group, spoke killed: (restarts, "
                             f"epochs, failovers, replicas identical, "
                             f"versions, version, abandoned, hub K2, "
                             f"reborn K2 > 0, K1, only workers on the card, "
                             f"workers) {got}, expected {want}; digests "
                             f"{g['param_digests']}; death "
                             f"{state['death']}, reborn's first update "
                             f"{state['first']}")
    _supervisor_line("supervised group, spoke killed", sup)
    print(f"supervised group, spoke killed: {steps} rounds; learner 1 "
          f"SIGKILLed at its update {state['last']}, respawned from the "
          f"fleet-v1 checkpoint at version {state['resumed_at'] - 1} "
          f"(one every {SUP_GROUP_CKPT}); its first update "
          f"{state['first'] - state['death']:.2f} s after the death; "
          f"replicas identical (digests {g['param_digests']}), versions "
          f"{g['param_versions']}; K2 {k2} (the hub, the reborn worker), "
          f"K1 {k1}; workers {sorted(seen.workers)}, those with the card's "
          f"device node open {sorted(seen.on_card)}")
    return sum(k2)


def phase_supervised_hub(vk, dev) -> int:
    """6z (e): 6z (d)'s group with its hub (learner 0) SIGKILLed once
    learner 1 has ``SUP_GROUP_KILL_AT`` updates: learner 1 is promoted,
    publishes alone on the card and finishes the run: failovers 1,
    abandoned learners [0], publisher 1, version ``steps``, K2 in the
    promoted worker once a round. Returns K2's launches."""
    from repro_torch.distributed import run_group_training

    cfg, kw = _full_width_group(dev)
    steps = SUP_GROUP_STEPS
    state = {"death": None, "first": None}

    def on_progress(k, snap):
        if k != 1:
            return
        if state["death"] is None and \
                snap["learner_updates"] >= SUP_GROUP_KILL_AT:
            _kill_learner("learner-0")
            state["death"] = time.monotonic()
            state["at"] = snap["learner_updates"]
        elif state["death"] is not None and state["first"] is None and \
                snap["exchange"].get("failovers", 0) >= 1:
            state["first"] = time.monotonic()

    counts = {}
    leftovers = _Leftovers("supervised group, hub killed")
    with _ComputePids() as seen:
        _, metrics, tel, params = run_group_training(
            "catch", cfg, 32, steps, kernel_counts=counts,
            on_progress=on_progress, return_final_params=True, **kw)
    leftovers.check(seen)
    sup, g = tel["supervisor"], tel["group"]
    ex = tel["learners"]["learner_1"]["exchange"]
    k1, k2 = _group_counts(vk, types.SimpleNamespace(kernel_counts=counts))
    got = (sup["failovers"], sup["failover_in_flight"], sup["restarts"],
           g.get("abandoned_learners"), g["publisher"],
           tel["param_version"], ex["resilient"], ex["failovers"],
           ex["hub_id"], ex["degraded_solo"], sorted(counts), k2, k1,
           bool(params))
    want = (1, 0, 0, [0], 1, steps, True, 1, 1, False, [1], [steps], [0],
            True)
    if got != want or state["first"] is None or \
            not math.isfinite(float(metrics["loss/total"])):
        raise AssertionError(f"supervised group, hub killed: (failovers, "
                             f"in flight, restarts, abandoned, publisher, "
                             f"version, resilient, exchange failovers, hub "
                             f"id, solo, results from, K2, K1, final params) "
                             f"{got}, expected {want}")
    _supervisor_line("supervised group, hub killed", sup)
    print(f"supervised group, hub killed: {steps} rounds; learner 0 (the "
          f"hub) SIGKILLed when learner 1 had {state['at']} updates; "
          f"learner 1 promoted (hub id {ex['hub_id']}, publisher "
          f"{g['publisher']}), its first update as the hub "
          f"{state['first'] - state['death']:.2f} s after the death; "
          f"version {tel['param_version']}, abandoned "
          f"{g['abandoned_learners']}; K2 {k2} in the promoted worker, K1 "
          f"{k1}; workers {sorted(seen.workers)}")
    return sum(k2)


# ---------------------------------------------------------------------------
# slice 11: the flight recorder


def _free_port() -> int:
    """A TCP port on the loopback that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(port: int, route: str):
    """(status, body) of ``GET http://127.0.0.1:<port><route>``; an HTTP
    error's status and body too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


# a Prometheus text-format sample line
_PROM_LINE = (r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
              r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*='
              r'"[^"]*")*\})? -?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?$')


def _check_routes(what: str, port: int, updates: int) -> None:
    """The three routes of a single learner's metrics server: every
    /metrics line a Prometheus sample, with the update count, frames/s
    and the queue's; /healthz 200 and ``ok``; /telemetry's updates."""
    import re

    code, text = _get(port, "/metrics")
    lines = [ln for ln in text.splitlines() if ln]
    bad = [ln for ln in lines if not re.match(_PROM_LINE, ln)]
    names = {ln.split("{")[0].split(" ")[0] for ln in lines}
    need = {"repro_learner_updates", "repro_frames_per_sec"}
    queue = sorted(n for n in names if n.startswith("repro_queue_"))
    if code != 200 or bad or not need <= names or not queue:
        raise AssertionError(f"{what}: /metrics {code}, lines not samples "
                             f"{bad[:3]}, missing {need - names}, queue "
                             f"samples {queue}")
    code, text = _get(port, "/healthz")
    body = json.loads(text)
    if code != 200 or body["status"] != "ok":
        raise AssertionError(f"{what}: /healthz {code} {body}")
    code, text = _get(port, "/telemetry")
    got = json.loads(text)["learner_updates"]
    if code != 200 or got < updates:
        raise AssertionError(f"{what}: /telemetry {code}, learner_updates "
                             f"{got} < {updates}")
    print(f"{what}: after update {updates} /metrics 200 with {len(lines)} "
          f"samples ({len(queue)} repro_queue_*), /healthz 200 "
          f"{body['status']}, /telemetry learner_updates {got}")


def _spans(path: Path):
    """Each traced trajectory's seven spans, {name: event}, in the order
    the recorder wrote them, and the row names by pid."""
    events = json.loads(path.read_text())["traceEvents"]
    rows = {e["pid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    xs = [e for e in events if e["ph"] == "X"]
    from repro_torch.obs.trace import SPAN_NAMES

    if len(xs) % len(SPAN_NAMES):
        raise AssertionError(f"{path}: {len(xs)} spans, not whole "
                             f"trajectories of {len(SPAN_NAMES)}")
    out = []
    for i in range(0, len(xs), len(SPAN_NAMES)):
        chunk = xs[i:i + len(SPAN_NAMES)]
        if tuple(e["name"] for e in chunk) != SPAN_NAMES:
            raise AssertionError(f"{path}: spans "
                                 f"{[e['name'] for e in chunk]}")
        out.append({e["name"]: e for e in chunk})
    return out, rows


def _chrome_device(path: Path, skip_us: float):
    """(busy us, device events, K2 launches) of a Chrome trace that
    ``torch.profiler`` wrote: busy is the union of the kernel, memcpy and
    memset events that start ``skip_us`` or more after its first event;
    K2's launches are counted over the whole trace."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
    t0 = min(float(e["ts"]) for e in events)
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    k2 = sum(1 for e in dev if e["cat"] == "kernel" and
             KERNEL_EVENTS["loss_vtrace"][0] in e["name"])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in dev if float(e["ts"]) - t0 >= skip_us]
    return _union_us(spans), len(spans), k2


def phase_flight_recorder(vk, single_before, single_busy) -> int:
    """6w: the async path at 6a's settings for ``OBS_STEPS`` updates with
    every observability flag: the live routes read mid-run, the
    ``phases`` section, the lifecycle trace in order, the
    ``--profile-steps`` window's Chrome trace with exactly its K2
    launches, the sink and the telemetry file. Learner frames/s and the
    window's busy share beside 6a's. Returns K2's launches."""
    from repro_torch.launch import train as train_lib
    from repro_torch.obs.trace import SPAN_NAMES

    # the profiler now and then drops a kernel's device events (phase
    # 2a's note): a window that lost K2 launches is taken again with the
    # whole run, as phase 2a's traces are, up to DEVICE_TRIES runs; every
    # run's K2 launches count
    lo, hi = OBS_PROFILE
    window = hi - lo + 1
    launched = 0
    for attempt in range(1, DEVICE_TRIES + 1):
        shutil.rmtree(OBS_DIR, ignore_errors=True)
        OBS_DIR.mkdir(parents=True)
        port = _free_port()
        files = {k: OBS_DIR / k for k in ("trace.json", "sink.jsonl",
                                          "telemetry.json")}
        argv = _async_argv(
            "catch", OBS_STEPS, "--metrics-port", str(port), "--trace",
            str(files["trace.json"]), "--trace-every", str(OBS_TRACE_EVERY),
            "--telemetry-sink", str(files["sink.jsonl"]), "--sink-interval-s",
            "0.5", "--profile-steps", f"{lo}:{hi}", "--profile-dir",
            str(OBS_DIR / "profile"), "--telemetry-json",
            str(files["telemetry.json"]))
        marks, snaps = {}, {}

        def hook(step, params, metrics, snapshot_fn):
            if step == OBS_SCRAPE_AT:
                _check_routes("flight recorder", port, OBS_SCRAPE_AT)
            if step in (OBS_SCRAPE_AT + 1, OBS_RATE_AT):
                # the unprofiled updates between, each ended on the card
                torch.cuda.synchronize()
                marks[step] = time.perf_counter()
                snaps[step] = snapshot_fn()

        vk.reset_launch_counts()
        run = train_lib.train(argv, on_update=hook)
        torch.cuda.synchronize()
        k2, k1 = vk.loss_vtrace.launches, vk.vtrace.launches
        _no_actor_threads("flight recorder")
        tel = run.telemetry
        if (tel["learner_updates"], k2, k1) != (OBS_STEPS, OBS_STEPS, 0):
            raise AssertionError(
                f"flight recorder: (updates, K2, K1) "
                f"{(tel['learner_updates'], k2, k1)}, expected "
                f"{(OBS_STEPS, OBS_STEPS, 0)}")
        ph = tel["phases"]
        keys = {"collect", "host_stage", "device_put", "step", "publish"}
        if ph["updates_timed"] != OBS_STEPS or set(ph["total_s"]) != keys or \
                min(ph["total_s"].values()) < 0:
            raise AssertionError(f"flight recorder: phases {ph}")
        # the updates between the two marks: after the scrape, before the
        # profile window, nothing of the hook in them but its snapshot
        a, b = (snaps[s]["phases"] for s in (OBS_SCRAPE_AT + 1, OBS_RATE_AT))
        clean = {k: (b["total_s"][k] - a["total_s"][k]) * 1e3
                 / (b["updates_timed"] - a["updates_timed"]) for k in keys}
        print(f"flight recorder: {OBS_STEPS} updates, K2 launches {k2} K1 "
              f"{k1}; phases, mean ms an update (host clock; step is the "
              f"update's dispatch), over updates {a['updates_timed'] + 1}-"
              f"{b['updates_timed']} (no scrape, no profiler): "
              + ", ".join(f"{k} {clean[k]:.4f}" for k in ph["mean_ms"])
              + f"; over all {ph['updates_timed']} (the scrape, the hook's "
              f"synchronises, the profile window and its pad included): "
              + ", ".join(f"{k} {v:.4f}" for k, v in ph["mean_ms"].items()))

        # the lifecycle trace: seven spans a trajectory, stamps in order
        trajs, rows = _spans(files["trace.json"])
        measured = tel["lag"]["measured"]
        n = len(trajs)
        if not (measured // OBS_TRACE_EVERY - 2 <= n <=
                measured // OBS_TRACE_EVERY) or n >= TRACE_BOUND:
            raise AssertionError(
                f"flight recorder: {n} traced trajectories of {measured} "
                f"consumed at one in {OBS_TRACE_EVERY} an actor")
        eps = 0.01                      # microseconds of float rounding
        for t in trajs:
            # u0, u1 (= e0 = e1 in process), r, dequeue, step0, step1;
            # collect is batch_collect's end
            chain = [t[name]["ts"] for name in SPAN_NAMES]
            collect = t["batch_collect"]["ts"] + t["batch_collect"]["dur"]
            if any(b < a - eps for a, b in zip(chain, chain[1:])) or \
                    not (chain[4] - eps <= collect <= chain[5] + eps) or \
                    t["env_unroll"]["ts"] + t["env_unroll"]["dur"] > \
                    chain[1] + eps:
                stamps = {k: (e["ts"], e["dur"]) for k, e in t.items()}
                raise AssertionError(f"flight recorder: stamps out of order "
                                     f"{stamps}")
        means = {name: sum(t[name]["dur"] for t in trajs) / n / 1e3
                 for name in SPAN_NAMES}
        print(f"flight recorder: trace of {n} trajectories ({measured} "
              f"consumed, one in {OBS_TRACE_EVERY} an actor traced; none "
              f"dropped: {n} < the bound {TRACE_BOUND}), rows "
              f"{sorted(rows.values())}, all seven spans, every trajectory's "
              f"stamps in order; mean span ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in means.items()))

        # the profile window: one Chrome trace, exactly its K2 launches
        prof = OBS_DIR / "profile" / f"updates_{lo}_{hi}.pt.trace.json"
        if not prof.is_file():
            raise AssertionError(f"flight recorder: no profile at {prof}")
        busy_us, count, k2_traced = _chrome_device(prof, ASYNC_SKIP_US)
        launched += k2
        if k2_traced == window and count:
            break
        what = (f"flight recorder: {prof.name} holds {k2_traced} K2 "
                f"launches (and {count} device events after its pad); "
                f"updates {lo}-{hi} launched {window}")
        if attempt == DEVICE_TRIES:
            raise AssertionError(what)
        print(f"{what}: run {attempt} of {DEVICE_TRIES}, taken again")
        TRACES_RETAKEN.append({"flight recorder": k2_traced})
    update_ms = ((marks[OBS_RATE_AT] - marks[OBS_SCRAPE_AT + 1]) * 1e3
                 / (OBS_RATE_AT - OBS_SCRAPE_AT - 1))
    busy = busy_us / window / 1e3 / update_ms
    print(f"flight recorder: {prof.name} ({prof.stat().st_size} bytes) "
          f"holds all {k2_traced} K2 launches of updates {lo}-{hi}; busy "
          f"{busy_us / window / 1e3:.3f} ms an update in {count} device "
          f"events, {100 * busy:.1f}% of the unprofiled {update_ms:.3f} ms "
          f"(updates {OBS_SCRAPE_AT + 2}-{OBS_RATE_AT}): the card idles "
          f"{100 - 100 * busy:.1f}%; 6a (same run) idles "
          f"{100 - 100 * single_busy:.1f}% (its trace has device activity "
          f"only, this window host and device: not directly comparable)")

    # the sink and the telemetry file
    sink = [json.loads(ln) for ln in
            files["sink.jsonl"].read_text().splitlines()]
    dumped = json.loads(files["telemetry.json"].read_text())
    if len(sink) < 2 or \
            sink[-1]["telemetry"]["learner_updates"] != OBS_STEPS or \
            dumped != json.loads(json.dumps(tel, default=float)):
        raise AssertionError(f"flight recorder: sink {len(sink)} lines, "
                             f"last {sink[-1] if sink else None}; the "
                             f"telemetry file {dumped}")
    rate = snaps[OBS_RATE_AT]
    print(f"flight recorder: sink {len(sink)} lines, the last at "
          f"{OBS_STEPS} updates; the telemetry file holds the final "
          f"telemetry; learner frames/s {rate['frames_per_sec']:.0f} (after "
          f"update {OBS_RATE_AT}), 6a (same run, no recorder) "
          f"{single_before['frames_per_sec']:.0f}: "
          f"{rate['frames_per_sec'] / single_before['frames_per_sec']:.2f}x")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    return launched


def phase_traced_process(vk) -> int:
    """6x: process actors (6n's settings) for ``OBS_PROC_STEPS`` updates,
    every trajectory traced: the children's encode stamps cross the
    process boundary (e0 <= e1 <= r, encode time above 0) on a row per
    actor; K2 once an update; no child with the card's device node open.
    Returns K2's launches."""
    import multiprocessing as mp
    import os

    from repro_torch.launch import train as train_lib

    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    path = OBS_DIR / "process_trace.json"
    argv = _async_argv("catch", OBS_PROC_STEPS, "--actor-backend",
                       "process", "--transport", "shm", "--trace",
                       str(path), "--trace-every", "1")
    seen = {}

    def hook(step, params, metrics, snapshot_fn):
        if step == OBS_PROC_STEPS // 2:
            seen["children"] = [p.pid for p in mp.active_children()]
            seen["on_card"] = [p for p in [os.getpid()] + seen["children"]
                               if _holds_card(p)]

    vk.reset_launch_counts()
    run = train_lib.train(argv, on_update=hook)
    torch.cuda.synchronize()
    k2 = vk.loss_vtrace.launches
    _no_actor_threads("traced process actors")
    if "REPRO_TRACE_EVERY" in os.environ:
        raise AssertionError("traced process actors: REPRO_TRACE_EVERY "
                             "outlives the run")
    trajs, rows = _spans(path)
    if run.telemetry["learner_updates"] != OBS_PROC_STEPS or \
            k2 != OBS_PROC_STEPS or vk.vtrace.launches:
        raise AssertionError(f"traced process actors: updates "
                             f"{run.telemetry['learner_updates']}, K2 {k2}, "
                             f"K1 {vk.vtrace.launches}")
    eps = 0.01
    for t in trajs:
        e0, e1 = t["serde_encode"]["ts"], t["transport"]["ts"]
        r = t["queue_wait"]["ts"]
        if not (e0 - eps <= e1 <= r + eps) or \
                not t["serde_encode"]["dur"] > 0 or \
                t["serde_encode"]["pid"] < 1000:
            raise AssertionError(f"traced process actors: e0 {e0} e1 {e1} "
                                 f"r {r}, encode "
                                 f"{t['serde_encode']['dur']} us")
    names = set(rows.values())
    if not {"actor-0", "actor-1", "learner"} <= names or \
            len(trajs) != run.telemetry["lag"]["measured"] or \
            len(seen.get("children", ())) != 2 or \
            seen["on_card"] != [os.getpid()]:
        raise AssertionError(f"traced process actors: rows {names}, "
                             f"{len(trajs)} traced of "
                             f"{run.telemetry['lag']['measured']}, children "
                             f"{seen.get('children')}, with the card's "
                             f"device node open {seen.get('on_card')}")
    ms = {name: sum(t[name]["dur"] for t in trajs) / len(trajs) / 1e3
          for name in ("env_unroll", "serde_encode", "transport",
                       "queue_wait")}
    print(f"traced process actors: {OBS_PROC_STEPS} updates, K2 launches "
          f"{k2}; {len(trajs)} trajectories traced, every one with e0 <= e1 "
          f"<= r and encoding above 0, rows {sorted(names)}; children "
          f"{seen['children']} without the card's device node; mean span "
          f"ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    return k2


class _GroupScrape:
    """Polls a learner group's metrics port while it runs: the learner
    labels seen on ``repro_learner_updates`` and the /healthz statuses."""

    def __init__(self, port: int):
        self.port = port
        self.labels, self.health, self.scrapes = set(), set(), 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="group-scrape", daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        import re

        while not self._stop.wait(0.2):
            try:
                code, text = _get(self.port, "/metrics")
                health, _ = _get(self.port, "/healthz")
            except OSError:
                continue                # not listening yet, or stopped
            self.scrapes += 1
            if code == 200:
                self.labels.update(re.findall(
                    r'^repro_learner_updates\{learner="(\d+)"\}', text,
                    re.M))
            self.health.add(health)


def phase_path_shapes(vk, dev):
    """Every shape at which phases 5-7 launched K1 or K2 and that
    ``K1_SHAPES``/``K2_SHAPES`` left out, held against the plain version
    as phases 3-4 hold theirs. Returns the worst errors (K1, K2)."""
    k1 = sorted(vk.vtrace.shapes - set(K1_SHAPES))
    k2 = sorted(vk.loss_vtrace.shapes - set(K2_SHAPES))
    print(f"path shapes: K1 launched at {sorted(vk.vtrace.shapes)}, K2 at "
          f"{sorted(vk.loss_vtrace.shapes)}; not in phases 3-4, checked "
          f"now: K1 {k1}, K2 {k2}")
    return phase_k1(vk, dev, k1), phase_k2(vk, dev, k2)


def _trace_pad() -> None:
    """Idle host time at either end of a profiled window."""
    time.sleep(TRACE_PAD_S)


def _trace_lead_in() -> None:
    """The start of a profiled window: idle host time, ``LEAD_IN_SPINS``
    short spin kernels and one of ``LEAD_IN_LONG_CYCLES`` on the current
    stream, a synchronise, and idle host time again. A trace can lose its
    first device records, in take after take, in a process that has
    traced and served much before (PERF.md, section 7): these are its
    first, and ``_device_busy`` leaves them out (``LEAD_IN_EVENT``)."""
    _trace_pad()
    for _ in range(LEAD_IN_SPINS):
        torch.cuda._sleep(LEAD_IN_CYCLES)
    torch.cuda._sleep(LEAD_IN_LONG_CYCLES)
    torch.cuda.synchronize()
    _trace_pad()


def _lead_in_held(prof, what: str) -> None:
    """Prints how many of a trace's lead-in spin kernels it holds, where
    it lost some: the device records a trace loses are its first."""
    from torch.autograd import DeviceType

    held = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and LEAD_IN_EVENT in e.name)
    if held != LEAD_IN_SPINS + 1:
        print(f"{what}: the trace holds {held} of its {LEAD_IN_SPINS + 1} "
              f"lead-in spin kernels, the first records it launched")


def _device_busy(events, skip_us: float = 0.0):
    """(busy us, device events, {name: (us, count)}) of the device-side
    events of a profiler trace that start ``skip_us`` or more after it
    does, the lead-in's spin kernels left out (``_trace_lead_in``); busy
    is the union of their intervals."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.time_range.start < skip_us \
                or LEAD_IN_EVENT in e.name:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + end - start, n + 1)
    return _union_us(spans), len(spans), by_name


def _union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


def phase_split(run, dev, steps: int = 20, profiled: int = 5) -> None:
    """Host-clock split of a main-path step: one actor unroll, then one
    learner step, each ended by a synchronise, after one warm-up step.
    Then ``profiled`` more steps under ``torch.profiler``: the card's busy
    time per step against the unprofiled step time, and the device kernels
    that take most of it."""
    from torch.profiler import profile

    from repro_torch.core import actor as actor_lib
    from repro_torch.core import learner as learner_lib

    init_fn, unroll = actor_lib.build_actor(run.env, run.arch, run.icfg,
                                            MAIN_B, dev)
    train_step, o = learner_lib.build_train_step(run.arch, run.icfg,
                                                 run.env.num_actions)
    params, opt_state, carry = run.params, o.init(run.params), init_fn(1)
    act = learn = 0.0
    for step in range(steps + 1):
        t0 = time.perf_counter()
        carry, batch = unroll(params, carry)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt_state, _ = train_step(params, opt_state, step, batch)
        torch.cuda.synchronize()
        if step:                      # step 0 warms up
            act += t1 - t0
            learn += time.perf_counter() - t1
    act, learn = act / steps * 1e3, learn / steps * 1e3
    print(f"split: actor unroll {act:.3f} ms, learner step {learn:.3f} ms "
          f"per step ({100 * act / (act + learn):.1f}% acting; host clock "
          f"to a synchronise, mean of {steps} steps, {MAIN_B} envs x "
          f"unroll {MAIN_T})")

    def take(activities):
        nonlocal carry, params, opt_state
        with profile(activities=activities) as prof:
            _trace_lead_in()
            for step in range(profiled):
                carry, batch = unroll(params, carry)
                params, opt_state, _ = train_step(params, opt_state, step,
                                                  batch)
            torch.cuda.synchronize()
            _trace_pad()
        return prof

    prof = _traced("sync step", take, "loss_vtrace", profiled)
    _print_busy("sync step", prof, profiled, act + learn, "loss_vtrace")


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """ms a call of ``fn``: CUDA events around ``iters`` calls after
    ``warmup`` more."""
    warmup = min(warmup, iters)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_plain(fn, iters: int) -> float:
    """A plain version's ms a call: ``_time_ms`` over at most ``iters``
    calls, fewer where one call is slow (a plain loop of 5-120 ms), so
    that its loop takes about ``PLAIN_BUDGET_MS``; one call warms up."""
    once = _time_ms(fn, 1, 0)
    return _time_ms(fn, max(3, min(iters, int(PLAIN_BUDGET_MS / once))), 1)


def _bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _k1_cost(t, b):
    # 6 inputs read and 2 outputs written once; 13 flops per (s, b)
    return 8 * t * b * 4, 13 * t * b


def _k2_cost(t, b, a):
    # logits and onehot (T,B,A), 5 (T,B) inputs, 4 (T,B) outputs; per row
    # 11 ops for each action (max, exp-sum, log-prob, tlp, entropy) and 20
    # for the weights and the recurrence
    return (2 * t * b * a + 9 * t * b) * 4, (11 * a + 20) * t * b


def phase_times(vk, dev):
    """K1 and K2 at VTRACE_TIMED: the call timed with CUDA events and the
    kernel's device time from a profiler trace, beside the plain version
    and the bound."""
    rows = {}
    for t, b, a in VTRACE_TIMED:
        inp = _inputs(t, b, a, 5, dev)
        rho, c = _weights(_log_rhos(inp), 1.0, 1.0, 1.0)
        k1_args = (rho, c) + inp[3:]
        for name, kern, plain, args, cost in (
                ("vtrace", vk.vtrace, vk.vtrace_plain, k1_args,
                 _k1_cost(t, b)),
                ("loss_vtrace", vk.loss_vtrace, vk.loss_vtrace_plain, inp,
                 _k2_cost(t, b, a))):
            ms = _time_ms(lambda: kern(*args))
            plain_ms = _time_plain(lambda: plain(*args), 50)
            shape = (t, b) if name == "vtrace" else (t, b, a)
            dev_ms, calls = DEVICE[(name, shape)]
            bound_ms, bound_by = _bound(*cost)
            print(f"time {name} {shape}: call {ms:.5f} ms "
                  f"({100 * bound_ms / ms:.3f}% of the bound), device "
                  f"{dev_ms:.5f} ms ({100 * bound_ms / dev_ms:.3f}%; phase "
                  f"2a, {calls} launches traced), plain "
                  f"{plain_ms:.5f} ms, bound {bound_ms:.7f} ms ({bound_by}: "
                  f"{cost[0]} B, {cost[1]} ops), library: none (no single "
                  f"PyTorch call computes V-trace)")
            if (t, b) == (MAIN_T, MAIN_B):
                rows[name] = dict(ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
    return rows


# ---------------------------------------------------------------------------
# slice 2: the serving path, K4 and K5


def _rand(shape, seed: int, dtype, dev):
    """Standard normals drawn on the CPU from a seed, moved to the card."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


def _attn_check(name: str, got, want) -> float:
    """Hold K4/K5 outputs to the tolerance of their dtype (ATTN_*);
    return the max abs error. A NaN, in either, is over it."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        allow = ATTN_F32_ATOL + ATTN_F32_RTOL * w.abs()
    else:
        allow = ATTN_BF16_ATOL + ATTN_BF16_RTOL * w.abs()
    over = ~(err <= allow)
    if bool(over.any()):
        i = int(torch.argmax(torch.where(over, err - allow, -1.0)
                             .nan_to_num(nan=float("inf")).flatten()))
        raise AssertionError(
            f"{name}: {int(over.sum())} elements over the {want.dtype} "
            f"tolerance; worst |got - want| {float(err.flatten()[i]):.3e} "
            f"at |want| {float(w.abs().flatten()[i]):.3e}")
    return float(err.max())


def phase_k4(fk, dev) -> float:
    worst = 0.0
    for n, (b, t, s, h, kh, d, causal, window) in enumerate(K4_CASES):
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            q = _rand((b, t, h, d), 3 * n, dtype, dev)
            k = _rand((b, s, kh, d), 3 * n + 1, dtype, dev)
            v = _rand((b, s, kh, d), 3 * n + 2, dtype, dev)
            name = (f"K4 (B,T,S,H,K,D)={(b, t, s, h, kh, d)} causal={causal}"
                    f" window={window} {dtype}")
            errs.append(_attn_check(
                name, fk.flash_attention(q, k, v, causal, window),
                fk.flash_attention_plain(q, k, v, causal, window)))
        torch.cuda.synchronize()
        print(f"K4 (B,T,S,H,K,D)={(b, t, s, h, kh, d)} causal={causal} "
              f"window={window}: max abs err bf16 {errs[0]:.3e}, f32 "
              f"{errs[1]:.3e}")
        worst = max(worst, *errs)
    return worst


def phase_k5(dk, dev) -> float:
    from repro_torch.models.attention import decode_bias

    worst = 0.0
    for n, (b, h, kh, s, d, index, window) in enumerate(K5_CASES):
        bias = decode_bias(index, s, window, b, dev)
        valid = int((bias[0] == 0).sum())
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            q = _rand((b, h, d), 100 + 3 * n, dtype, dev)
            k = _rand((b, s, kh, d), 101 + 3 * n, dtype, dev)
            v = _rand((b, s, kh, d), 102 + 3 * n, dtype, dev)
            name = (f"K5 (B,H,K,S,D)={(b, h, kh, s, d)} index={index} "
                    f"window={window} {dtype}")
            errs.append(_attn_check(name, dk.decode_attention(q, k, v, bias),
                                    dk.decode_attention_plain(q, k, v,
                                                              bias)))
        torch.cuda.synchronize()
        print(f"K5 (B,H,K,S,D)={(b, h, kh, s, d)} index={index} window="
              f"{window} ({valid} of {s} slots valid): max abs err bf16 "
              f"{errs[0]:.3e}, f32 {errs[1]:.3e}")
        worst = max(worst, *errs)
    return worst


def _serve_counted(lk, fk, dk, argv, want, launches_want):
    """``serve(argv)`` on the card, K3/K4/K5 counted over exactly it (the
    counts zeroed just before, read just after): (layers, params,
    batches, decode steps) must equal ``want`` and the launches
    ``launches_want``, every served logit finite and of its shape. The
    shapes each kernel launched at join ``PATH_SHAPES`` (phase 24)."""
    from repro_torch.launch import serve as serve_lib

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels = {"linear_scan": lk.linear_scan,
               "flash_attention": fk.flash_attention,
               "decode_attention": dk.decode_attention}
    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()
    run = serve_lib.serve(argv)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    for name, fn in kernels.items():
        PATH_SHAPES[name] |= fn.shapes
    peak = torch.cuda.max_memory_allocated()
    got = (run.arch.num_layers, run.param_count, run.batches,
           run.decode_steps)
    if got != want or launches != launches_want:
        raise AssertionError(f"serving {' '.join(argv)}: (layers, params, "
                             f"batches, steps) {got}, launches {launches}; "
                             f"expected {want}, launches {launches_want}")
    fb = run.first_batch
    for i, lg in enumerate(fb["logits"]):
        if tuple(lg.shape) != (16, 1, run.num_actions) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"served logits {i}: {tuple(lg.shape)}, "
                                 f"finite {bool(torch.isfinite(lg).all())}")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    print(f"serving: {run.arch.name} {run.param_count:,} params, "
          f"{run.arch.num_layers} layers, d_model {run.arch.d_model}, ctx "
          f"{fb['tokens'].shape[1]}; launches K3 {launches['linear_scan']} "
          f"K4 {launches['flash_attention']} K5 "
          f"{launches['decode_attention']}")
    print(f"serving: {run.arch.name} {run.actions_per_s:.1f} actions/s, p50 "
          f"step latency {med(run.step_latency_ms):.3f} ms (batch time / "
          f"decode steps), prefill {med(run.prefill_ms):.3f} ms (median of "
          f"{len(run.prefill_ms)}), decode step {med(run.decode_ms):.3f} ms "
          f"(median of {len(run.decode_ms)}), peak allocated "
          f"{peak / 1e9:.2f} GB ({held / 1e9:.2f} GB of it held before "
          f"the run); {_card_line()}")
    return launches, run


def phase_serve(lk, fk, dk):
    """The serving path at its defaults (mistral-nemo-12b), K4/K5 once a
    layer at each prefill and decode step, K3 never."""
    return _serve_counted(
        lk, fk, dk, SERVE_ARGV,
        (SERVE_LAYERS, SERVE_PARAMS, SERVE_BATCHES, SERVE_STEPS),
        {"linear_scan": 0,
         "flash_attention": SERVE_LAYERS * SERVE_BATCHES,
         "decode_attention": SERVE_LAYERS * SERVE_STEPS * SERVE_BATCHES})


def phase_serve_logits(run) -> float:
    """Replay the first batch through the plain attention route: its
    tokens, and the stub frontend's embeddings where it had them
    (``first_batch["ctx"]``, phases 23c-23d), then its sampled actions."""
    from repro_torch.models import backbone as bb

    fb = run.first_batch
    toks = fb["tokens"]
    ctx = toks.shape[1]
    batch = {"tokens": toks, **fb.get("ctx", {})}
    worst = 0.0
    with torch.no_grad():
        out = bb.apply_prefill(run.params, batch, run.arch,
                               run.num_actions, impl="ref")
        outs = [out.policy_logits]
        cache, tok = out.cache, toks[:, -1:]
        for i, action in enumerate(fb["actions"]):
            out = bb.apply_decode(run.params, tok, cache, ctx + i, run.arch,
                                  run.num_actions, batch=batch, impl="ref")
            cache = out.cache
            outs.append(out.policy_logits)
            tok = action % run.arch.vocab_size
    for i, (got, want) in enumerate(zip(fb["logits"], outs)):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= LOGITS_RTOL * scale:
            raise AssertionError(f"served logits step {i}: max abs err "
                                 f"{err:.3e} > {LOGITS_RTOL} x max |logit| "
                                 f"{scale:.3e}")
        worst = max(worst, err / scale)
    print(f"served logits vs the plain route: prefill and {len(outs) - 1} "
          f"decode steps, worst max abs err {100 * worst:.3f}% of the "
          f"step's max |logit| (bar {100 * LOGITS_RTOL:.0f}%)")
    return worst


def phase_serve_split(run, kernel=None, per_step: int = 0,
                      profiled: int = 4) -> None:
    """Device busy time of a few decode steps against the unprofiled
    decode step, and the device kernels that take most of it; the trace
    must hold ``per_step`` launches of ``kernel`` a step (``_print_busy``).
    A trace that lost some of them is taken again from a new prefill
    (``_traced``)."""
    from torch.profiler import profile

    from repro_torch.models import backbone as bb

    fb = run.first_batch
    toks = fb["tokens"]
    ctx = toks.shape[1]

    def take(activities):
        with torch.no_grad():
            out = bb.apply_prefill(run.params, {"tokens": toks}, run.arch,
                                   run.num_actions)
            cache, tok = out.cache, toks[:, -1:]
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                _trace_lead_in()
                for i in range(profiled):
                    out = bb.apply_decode(run.params, tok, cache, ctx + i,
                                          run.arch, run.num_actions)
                    cache = out.cache
                    tok = fb["actions"][i] % run.arch.vocab_size
                torch.cuda.synchronize()
                _trace_pad()
        return prof

    prof = _traced(f"{run.arch.name} decode step", take, kernel,
                   profiled * per_step)
    step = sorted(run.decode_ms)[len(run.decode_ms) // 2]
    _print_busy(f"{run.arch.name} decode step", prof, profiled, step,
                kernel, per_step)


def _wrapper(kernel: str):
    """The wrapper of ``kernel``, a ``KERNEL_EVENTS`` key."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import linear_scan as lk
    from repro_torch.kernels import vtrace as vk

    return _kernel_fns(vk, lk, fk, dk)[kernel]


def _traced(what: str, take, kernel=None, launches: int = 0):
    """``take(activities)``'s profiler trace of the card's activity,
    taken again (up to ``TRACE_TRIES`` traces, ``TRACE_RETRY_PAUSE_S``
    apart) while it holds another number than ``launches`` of
    ``kernel``'s launches: such a trace lost device events. The wrapper's
    own count over each take tells a lost event from a call that launched
    another number (which fails at once); each retake prints where the
    kernel's launches sit and how many of them the profiler's raw events
    held (``_lost``). ``_print_busy`` then holds the last one to the same
    count."""
    from torch.profiler import ProfilerActivity

    for attempt in range(1, TRACE_TRIES + 1):
        fn = _wrapper(kernel) if kernel is not None else None
        before = fn.launches if fn is not None else 0
        prof = take([ProfilerActivity.CUDA])
        _lead_in_held(prof, what)
        if kernel is None:
            return prof
        ran = fn.launches - before
        if ran != launches:
            raise AssertionError(f"{what}: the traced call launched "
                                 f"{kernel} {ran} times (its wrapper's "
                                 f"count), not {launches}")
        name = KERNEL_EVENTS[kernel][0]
        _, _, whole = _device_busy(prof.events())
        got = sum(c for event, (_, c) in whole.items() if name in event)
        if got == launches or attempt == TRACE_TRIES:
            return prof
        print(f"{what}: trace {attempt} of {TRACE_TRIES} holds {got} "
              f"{name} launches where its wrapper counted {ran} "
              f"({_lost(prof, name)}); traced again after "
              f"{TRACE_RETRY_PAUSE_S} s")
        TRACES_RETAKEN.append({name: got})
        time.sleep(TRACE_RETRY_PAUSE_S)


def _lost(prof, name: str) -> str:
    """Where a trace lost ``name``'s launches: how many the profiler's raw
    (kineto) events hold, of the device kind or any, against the
    ``FunctionEvent`` list it builds from them, with their distinct
    correlation ids; and where the device events and the kept launches sit,
    in us from the trace's start."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    start = prof.profiler.kineto_results.trace_start_ns()
    mine_raw = [e for e in raw if name in e.name()]
    dev_raw = [e for e in mine_raw if e.device_type() == DeviceType.CUDA]
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    mine = sorted(e.time_range.start for e in dev if name in e.name)
    where = "no device events of it" if not dev or not mine else (
        f"device events {min(e.time_range.start for e in dev):.0f}-"
        f"{max(e.time_range.end for e in dev):.0f} us, the launches kept "
        f"{mine[0]:.0f}-{mine[-1]:.0f} us")
    early = sum(1 for e in dev_raw if e.start_ns() < start)
    all_raw = sum(1 for e in raw if e.device_type() == DeviceType.CUDA)
    return (f"raw events naming it {len(mine_raw)}, {len(dev_raw)} on the "
            f"device with {len({e.correlation_id() for e in dev_raw})} "
            f"correlation ids, {early} before the trace's start; device "
            f"events raw {all_raw}, kept {len(dev)}; {where}")


def _print_busy(what: str, prof, n: int, unprofiled_ms: float,
                kernel=None, per_call: int = 1,
                skip_us: float = 0.0) -> float:
    """The card's busy time per call over ``n`` profiled calls against the
    unprofiled time of one, and the device kernels that take most of it.
    ``kernel``, a ``KERNEL_EVENTS`` key, launches ``per_call`` times a
    call: a trace that holds another number of its launches has lost
    device events, and its busy share would undercount, so that raises,
    as a trace with no device events does. ``kernel=None`` where no
    kernel of the port runs in a call: the trace is then not checked.
    The busy time leaves out the events of the first ``skip_us``, a pad
    in which only other threads launched. Returns the busy share."""
    events = prof.events()
    _, _, whole = _device_busy(events)
    busy_us, count, by_name = _device_busy(events, skip_us)
    if not count:
        raise AssertionError(f"{what}: the profiler trace of {n} calls "
                             f"holds no device events")
    note = "no kernel of the port in it to check the trace by"
    if kernel is not None:
        name = KERNEL_EVENTS[kernel][0]
        got = sum(c for event, (_, c) in whole.items() if name in event)
        if got != n * per_call:
            raise AssertionError(
                f"{what}: the profiler trace of {n} calls holds {got} "
                f"{name} launches where {n * per_call} ran: it lost device "
                f"events, so its busy share would undercount")
        note = f"all {got} {kernel} launches in the trace"
    busy_ms = busy_us / n / 1e3
    print(f"{what} device: busy {busy_ms:.3f} ms per call over {n} profiled, "
          f"{count / n:.0f} device events per call ({note}); "
          f"{100 * busy_ms / unprofiled_ms:.1f}% of the unprofiled "
          f"{unprofiled_ms:.3f} ms, so the card idles "
          f"{100 - 100 * busy_ms / unprofiled_ms:.1f}% of it")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, calls) in top:
        print(f"  device {us / n / 1e3:8.3f} ms/call {calls / n:6.0f} "
              f"launches/call  {name[:90]}")
    return busy_ms / unprofiled_ms


def _device_ms(fn, events, n: int = 20) -> Tuple[float, int]:
    """(device ms per call of ``fn``, calls seen) from a ``torch.profiler``
    trace of ``n`` calls: the summed duration of the device events whose
    names hold one of ``events`` (the kernel's own: the first names its
    launch, the rest a pass it launches with it), over its ``n`` launches.
    No host time and no other kernel's events. ``events=None`` (a library
    call) takes the busy time of every device event of the trace, over
    ``n``. A trace must hold the whole run: each of ``events`` a multiple
    of ``n`` times and the launch exactly ``n``, or (a library call) each
    event name a multiple of ``n`` times and none of the port's kernels.
    One that does not has lost events; it is taken again, up to
    ``DEVICE_TRIES`` traces, and then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    ours = [name for names in KERNEL_EVENTS.values() for name in names]
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, DEVICE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _trace_lead_in()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            _trace_pad()
        _lead_in_held(prof, "device time of " + (events[0] if events
                                                  else "a library call"))
        busy_us, _, by_name = _device_busy(prof.events())
        if events is None:
            calls, us = n, busy_us
            mine = by_name
            whole = bool(by_name) and not any(
                e in name for name in by_name for e in ours)
        else:
            calls = sum(c for name, (_, c) in by_name.items()
                        if events[0] in name)
            mine = {name: uc for name, uc in by_name.items()
                    if any(e in name for e in events)}
            us = sum(u for u, _ in mine.values())
            whole = calls == n
        whole = whole and all(c % n == 0 for _, c in mine.values())
        if whole:
            return us / calls / 1e3, calls
        held = {name[:60]: c for name, (_, c) in sorted(by_name.items())[:4]}
        print(f"device time: trace {attempt} of {DEVICE_TRIES} of {n} calls "
              f"lost events (it holds {held}; {_odd_events(prof, n)}); "
              f"traced again")
        TRACES_RETAKEN.append(held)
    raise AssertionError(
        f"device time: {DEVICE_TRIES} profiler traces of {n} calls each "
        f"lost events: none holds {events[0] if events else 'a library'} "
        f"call's events {n} times over")


def _odd_events(prof, n: int) -> str:
    """The device events of a trace of ``n`` calls whose count is not a
    multiple of ``n``: each one's count and the times of its first and
    last occurrence, in us from the trace's first device event, beside a
    call's length (the device span over ``n``)."""
    from torch.autograd import DeviceType

    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and LEAD_IN_EVENT not in e.name)
    if not dev:
        return "no device events"
    t0 = dev[0][0]
    counts, first, last = {}, {}, {}
    for start, _, name in dev:
        counts[name] = counts.get(name, 0) + 1
        first.setdefault(name, start - t0)
        last[name] = start - t0
    odd = [f"{name[:60]} x{c} at {first[name]:.0f}-{last[name]:.0f}"
           for name, c in counts.items() if c % n]
    span = max(end for _, end, _ in dev) - t0
    return (f"a call's length {span / n:.0f} us of {span:.0f}; the events "
            f"not a multiple of the calls: " + "; ".join(odd))


def _attn_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves: the work these inputs need."""
    total = 0
    for qp in range(t):
        hi = min(s, qp + 1) if causal else s
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _k4_inputs(b, t, s, h, kh, d, dev):
    """K4's bf16 (q, k, v) and SDPA's (B, heads, T or S, D) views of them."""
    bf = torch.bfloat16
    q = _rand((b, t, h, d), 7, bf, dev)
    k = _rand((b, s, kh, d), 8, bf, dev)
    v = _rand((b, s, kh, d), 9, bf, dev)
    return (q, k, v) + tuple(x.transpose(1, 2) for x in (q, k, v))


def _k5_inputs(b, h, kh, s, d, index, window, dev):
    """K5's bf16 (q, k, v, bias) and SDPA's (q4, k, v, mask) for them."""
    from repro_torch.models.attention import decode_bias

    bf = torch.bfloat16
    q = _rand((b, h, d), 17, bf, dev)
    k = _rand((b, s, kh, d), 18, bf, dev)
    v = _rand((b, s, kh, d), 19, bf, dev)
    bias = decode_bias(index, s, window, b, dev)
    return (q, k, v, bias, q[:, :, None], k.transpose(1, 2),
            v.transpose(1, 2), bias.to(bf)[:, None, None, :])


def _k4_library(qt, kt, vt, causal: bool, window: int):
    """The library call beside K4: ``F.scaled_dot_product_attention`` on
    SDPA's (B, heads, T or S, D) views, causal or unmasked as K4's call.
    Only where ``window`` masks nothing past the causal mask (0, or at
    least T) is that the same function."""
    import torch.nn.functional as F

    if window and window < qt.shape[2]:
        raise ValueError(f"window {window} < T {qt.shape[2]}: the causal "
                         f"library call would compute another function")
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def phase_attn_times(fk, dk, dev):
    """K4 and K5 at the serving paths' shapes and one long shape each, in
    bf16, beside the plain version, the bound and one library call. K4's
    windows cover the whole context (``_k4_library``), so the library
    call's causal (or absent) mask is the same function."""
    import torch.nn.functional as F

    rows = {}
    for label, (b, t, s, h, kh, d), causal, window, iters in K4_TIMED:
        q, k, v, qt, kt, vt = _k4_inputs(b, t, s, h, kh, d, dev)
        lib = _k4_library(qt, kt, vt, causal, window)
        ms = _time_ms(lambda: fk.flash_attention(q, k, v, causal, window),
                      iters)
        plain_ms = _time_plain(lambda: fk.flash_attention_plain(
            q, k, v, causal, window), iters)
        lib_ms = _time_ms(lib, iters)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        ops = 4 * b * h * d * _attn_pairs(t, s, causal, window)
        bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
        (dev_ms, calls), (lib_dev_ms, _) = (
            DEVICE[("flash_attention", label)],
            DEVICE[("flash_attention library", label)])
        print(f"time flash_attention {label} (B,T,S,H,K,D)="
              f"{(b, t, s, h, kh, d)} "
              f"{'causal' if causal else 'non-causal'} window={window} "
              f"bf16: kernel "
              f"{ms:.5f} ms "
              f"({ops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s,"
              f" {100 * bound_ms / ms:.1f}% of the bound), plain "
              f"{plain_ms:.5f} ms, library (F.scaled_dot_product_attention)"
              f" {lib_ms:.5f} ms ({ops / lib_ms / 1e9:.1f} TFLOP/s), bound "
              f"{bound_ms:.7f} ms ({bound_by}: {nbytes} B, {ops} ops); "
              f"device time a call (profiler, phase 2a, {calls} launches "
              f"traced): kernel {dev_ms:.5f} ms "
              f"({100 * bound_ms / dev_ms:.1f}% of the bound), library "
              f"{lib_dev_ms:.5f} ms")
        if label == "main":
            rows["flash_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_ms,
                                           bound_by=bound_by,
                                           library_ms=lib_ms)
    for label, (b, h, kh, s, d), index, window, iters in K5_TIMED:
        q, k, v, bias, q4, kt, vt, mask = _k5_inputs(b, h, kh, s, d, index,
                                                     window, dev)
        ms = _time_ms(lambda: dk.decode_attention(q, k, v, bias), iters)
        plain_ms = _time_plain(lambda: dk.decode_attention_plain(q, k, v,
                                                                 bias), iters)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), iters)
        valid = int((bias == 0).sum())          # unmasked (row, slot) pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * s
        ops = 4 * h * d * valid
        bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
        (dev_ms, calls), (lib_dev_ms, _) = (
            DEVICE[("decode_attention", label)],
            DEVICE[("decode_attention library", label)])
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nsplit, split_len = dk.plan_splits(b, kh, s, sms)
        print(f"time decode_attention {label} (B,H,K,S,D)="
              f"{(b, h, kh, s, d)} index={index} window={window} ({valid // b}"
              f" of {s} slots valid) bf16: kernel {ms:.5f} ms "
              f"({nbytes / ms / 1e9:.3f} TB/s, {100 * bound_ms / ms:.1f}% of "
              f"the bound), plain {plain_ms:.5f} ms, library "
              f"(F.scaled_dot_product_attention) {lib_ms:.5f} ms "
              f"({nbytes / lib_ms / 1e9:.3f} TB/s), bound {bound_ms:.7f} ms "
              f"({bound_by}: {nbytes} B, {ops} ops); S in {nsplit} "
              f"split(s) of {split_len} keys: {b * kh * nsplit} blocks on "
              f"{sms} SMs"
              + (", plus the combine pass" if nsplit > 1 else "")
              + f"; device time a call (profiler, phase 2a, {calls} "
              f"launches traced): kernel {dev_ms:.5f} ms "
              f"({nbytes / dev_ms / 1e9:.3f} TB/s, "
              f"{100 * bound_ms / dev_ms:.1f}% of the bound), library "
              f"{lib_dev_ms:.5f} ms")
        if label == "main":
            rows["decode_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                            bound_ms=bound_ms,
                                            bound_by=bound_by,
                                            library_ms=lib_ms)
    return rows


# ---------------------------------------------------------------------------
# slice 3: the SSM serving path, K3


def _scan_inputs(t: int, n: int, seed: int, dev):
    """a uniform in [0, 1] (decays), b and h0 standard normal, drawn on the
    card from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((t, n), generator=g, device=dev)
    b = torch.randn((t, n), generator=g, device=dev)
    h0 = torch.randn((n,), generator=g, device=dev)
    return a, b, h0


def phase_k3(lk, dev) -> float:
    worst = 0.0
    for t, n in K3_SHAPES:
        a, b, h0 = _scan_inputs(t, n, t + n, dev)
        errs = [_check(f"K3 (T,N)={(t, n)} h0={init is not None}",
                       [lk.linear_scan(a, b, init)],
                       [lk.linear_scan_plain(a, b, init)])
                for init in (h0, None)]
        torch.cuda.synchronize()
        print(f"K3 (T,N)={(t, n)}: max abs err with h0 {errs[0]:.3e}, "
              f"without {errs[1]:.3e}")
        worst = max(worst, *errs)
        del a, b, h0
    for t, n, init in K3_BWD_SHAPES:
        worst = max(worst, _k3_backward_check(lk, t, n, init, dev))
    return worst


def _k3_backward_check(lk, t: int, n: int, init: bool, dev) -> float:
    """K3's gradient (``LinearScanFn``: K3 forward, K3 on reversed time
    backward) against autograd through the plain loop, under one random
    cotangent: da, db and dh0 each held to ATOL (1e-5; the same
    multiplies and adds in the same order, bit for bit expected), and one
    kernel launch each way."""
    a, b, h0 = _scan_inputs(t, n, 7 * t + n, dev)
    ins = [a, b] + ([h0] if init else [])
    for x in ins:
        x.requires_grad_(True)
    ct = _scan_inputs(t, n, 11 * t + n, dev)[1]
    before = lk.linear_scan.launches
    got = torch.autograd.grad(
        (lk.linear_scan(a, b, h0 if init else None) * ct).sum(), ins)
    launched = lk.linear_scan.launches - before
    want = torch.autograd.grad(
        (lk.linear_scan_plain(a, b, h0 if init else None) * ct).sum(), ins)
    torch.cuda.synchronize()
    if launched != 2:
        raise AssertionError(f"K3 gradient (T,N)={(t, n)}: {launched} "
                             f"launches, expected one forward and one "
                             f"backward")
    err = _check(f"K3 gradient (T,N)={(t, n)} h0={init}", got, want)
    print(f"K3 gradient (T,N)={(t, n)} h0={init}: da, db"
          + (", dh0" if init else "") + f" max abs err {err:.3e} against "
          f"autograd through the plain loop")
    return err


def phase_serve_ssm(lk, fk, dk):
    """The mamba2 serving path, K3 once a layer at each prefill, K4/K5
    never."""
    return _serve_counted(
        lk, fk, dk, SSM_ARGV,
        (SSM_LAYERS, SSM_PARAMS, SERVE_BATCHES, SERVE_STEPS),
        {"linear_scan": SSM_LAYERS * SERVE_BATCHES, "flash_attention": 0,
         "decode_attention": 0})


def phase_prefill_split(run, scans: int = SSM_LAYERS) -> None:
    """Device busy time of one profiled prefill against the unprofiled
    median, and the device kernels that take most of it; the trace must
    hold the prefill's ``scans`` K3 launches, and one that lost some is
    taken again (``_traced``)."""
    from torch.profiler import profile

    from repro_torch.models import backbone as bb

    toks = run.first_batch["tokens"]

    def take(activities):
        with torch.no_grad():
            with profile(activities=activities) as prof:
                _trace_lead_in()
                bb.apply_prefill(run.params, {"tokens": toks}, run.arch,
                                 run.num_actions)
                torch.cuda.synchronize()
                _trace_pad()
        return prof

    prof = _traced(f"{run.arch.name} prefill", take, "linear_scan", scans)
    _print_busy(f"{run.arch.name} prefill", prof, 1,
                sorted(run.prefill_ms)[len(run.prefill_ms) // 2],
                "linear_scan", scans)


# (kernel, shape or label) -> (device ms a call, calls traced), phase 2a
DEVICE = {}


def _keep_device_ms(key, fn, events) -> None:
    """``DEVICE[key]``: ``fn``'s device ms over ``DEVICE_CALLS`` calls."""
    DEVICE[key] = _device_ms(fn, events, DEVICE_CALLS)
    ms, calls = DEVICE[key]
    print(f"device time {key[0]} {key[1]}: {ms:.5f} ms a call, "
          f"{calls} of {DEVICE_CALLS} calls traced")


def phase_device_times(vk, fk, dk, lk, dev) -> None:
    """2a: each kernel's device time at the shapes phases 8, 14 and 19
    time, and the library call's beside K4 and K5, each from a
    ``torch.profiler`` trace of ``DEVICE_CALLS`` calls (``_device_ms``),
    taken first, in a process that has traced nothing yet, and kept in
    ``DEVICE`` for those phases; and K3's at its training shapes, forward
    and backward."""
    import torch.nn.functional as F

    for t, b, a in VTRACE_TIMED:
        inp = _inputs(t, b, a, 5, dev)
        rho, c = _weights(_log_rhos(inp), 1.0, 1.0, 1.0)
        k1_args = (rho, c) + inp[3:]
        _keep_device_ms(("vtrace", (t, b)), lambda: vk.vtrace(*k1_args),
                        KERNEL_EVENTS["vtrace"])
        _keep_device_ms(("loss_vtrace", (t, b, a)),
                        lambda: vk.loss_vtrace(*inp),
                        KERNEL_EVENTS["loss_vtrace"])
    for label, (b, t, s, h, kh, d), causal, window, _ in K4_TIMED:
        q, k, v, qt, kt, vt = _k4_inputs(b, t, s, h, kh, d, dev)
        _keep_device_ms(("flash_attention", label),
                        lambda: fk.flash_attention(q, k, v, causal, window),
                        KERNEL_EVENTS["flash_attention"])
        _keep_device_ms(("flash_attention library", label),
                        _k4_library(qt, kt, vt, causal, window), None)
    for label, (b, h, kh, s, d), index, window, _ in K5_TIMED:
        q, k, v, bias, q4, kt, vt, mask = _k5_inputs(b, h, kh, s, d, index,
                                                     window, dev)
        _keep_device_ms(("decode_attention", label),
                        lambda: dk.decode_attention(q, k, v, bias),
                        KERNEL_EVENTS["decode_attention"])
        _keep_device_ms(("decode_attention library", label),
                        lambda: F.scaled_dot_product_attention(
                            q4, kt, vt, attn_mask=mask, enable_gqa=True),
                        None)
    for label, (t, n) in (("main", K3_MAIN), ("long", K3_LONG)):
        a, b, _ = _scan_inputs(t, n, 3, dev)
        _keep_device_ms(("linear_scan", label), lambda: lk.linear_scan(a, b),
                        KERNEL_EVENTS["linear_scan"])
        del a, b
    for t, n, _ in K3_TRAIN_SHAPES:
        # the training forward, and the backward's K3 on reversed time
        a, b, _ = _scan_inputs(t, n, 5, dev)
        g = _scan_inputs(t, n, 6, dev)[1]
        ctx = types.SimpleNamespace(saved_tensors=(a, lk.linear_scan(a, b),
                                                   None))
        _keep_device_ms(("linear_scan", ("train", t, n)),
                        lambda: lk.linear_scan(a, b),
                        KERNEL_EVENTS["linear_scan"])
        _keep_device_ms(("linear_scan", ("train bwd", t, n)),
                        lambda: lk.LinearScanFn.backward(ctx, g),
                        KERNEL_EVENTS["linear_scan"])
        del a, b, g, ctx
    torch.cuda.empty_cache()


def phase_scan_times(lk, dev):
    """K3 at the serving path's shape and at the RG-LRU prefill's, without
    h0 as the prefill calls it, beside the plain version and the bound."""
    rows = {}
    for label, (t, n), iters in (("main", K3_MAIN, 100),
                                 ("long", K3_LONG, 20)):
        a, b, _ = _scan_inputs(t, n, 3, dev)
        ms = _time_ms(lambda: lk.linear_scan(a, b), iters)
        plain_ms = _time_plain(lambda: lk.linear_scan_plain(a, b), iters)
        # a and b read once, h written once; a multiply and an add each
        nbytes, ops = 3 * t * n * 4, 2 * t * n
        bound_ms, bound_by = _bound(nbytes, ops)
        dev_ms, calls = DEVICE[("linear_scan", label)]
        print(f"time linear_scan {label} (T,N)={(t, n)} f32: kernel "
              f"{ms:.5f} ms, device {dev_ms:.5f} ms (phase 2a, {calls} "
              f"launches traced), plain {plain_ms:.5f} ms, bound "
              f"{bound_ms:.7f} ms "
              f"({bound_by}: {nbytes} B, {ops} ops), library: none (no "
              f"single PyTorch call computes the recurrence)")
        if label == "main":
            rows["linear_scan"] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
        del a, b
    for t, n, _ in K3_TRAIN_SHAPES:
        a, b, _ = _scan_inputs(t, n, 5, dev)
        g = _scan_inputs(t, n, 6, dev)[1]           # dL/dh, (T, N)
        h = lk.linear_scan(a, b)
        ctx = types.SimpleNamespace(saved_tensors=(a, h, None))
        ms = _time_ms(lambda: lk.linear_scan(a, b), 50)
        bwd_ms = _time_ms(lambda: lk.LinearScanFn.backward(ctx, g), 50)
        ag, bg = (x.detach().requires_grad_(True) for x in (a, b))
        plain_bwd_ms = _time_ms(lambda: torch.autograd.grad(
            lk.linear_scan_plain(ag, bg), (ag, bg), g), 5, 1)
        # forward: a, b read, h written; backward: a, h and g read, da and
        # db written, the reversed scan's multiply and add and da's product
        bound_ms, bound_by = _bound(3 * t * n * 4, 2 * t * n)
        bwd_bound, bwd_by = _bound(5 * t * n * 4, 3 * t * n)
        (dev_ms, calls), (dev_bwd, _) = (
            DEVICE[("linear_scan", ("train", t, n))],
            DEVICE[("linear_scan", ("train bwd", t, n))])
        print(f"time linear_scan train (T,N)={(t, n)} f32: forward "
              f"{ms:.5f} ms (bound {bound_ms:.7f} ms, {bound_by}; "
              f"{100 * bound_ms / ms:.1f}%), backward (LinearScanFn: "
              f"reversed inputs, K3, da) {bwd_ms:.5f} ms (bound "
              f"{bwd_bound:.7f} ms, {bwd_by}; {100 * bwd_bound / bwd_ms:.1f}"
              f"%), plain forward and backward {plain_bwd_ms:.5f} ms; "
              f"library: none; device time a launch (phase 2a, {calls} "
              f"traced): forward {dev_ms:.5f} ms "
              f"({100 * bound_ms / dev_ms:.1f}% of its bound), the "
              f"backward's K3 on reversed time {dev_bwd:.5f} ms")
        del a, b, g, h, ctx, ag, bg
    return rows


# ---------------------------------------------------------------------------
# slice 13: the dense configs and the RG-LRU hybrid, K3/K4/K5


def phase_serve_config(lk, fk, dk, arch: str, ctx: int, layers: int,
                       params: int, want: Tuple[int, int, int]):
    """Phases 20-23: ``serve --arch <arch>`` at full width and all its
    layers, one batch of 16 and ``NEW_SERVE_STEPS`` decode steps, the
    launches of (K3, K4, K5) equal to ``want``; then its served logits
    against the plain route (as phase 12); for the hybrid, where a decode
    step's time goes (as phase 13) and its prefill's (as phase 18).
    Returns the launches."""
    argv = ["--device", "cuda", "--arch", arch, "--ctx", str(ctx),
            "--requests", "16", "--decode-steps", str(NEW_SERVE_STEPS)]
    launches, run = _serve_counted(
        lk, fk, dk, argv, (layers, params, 1, NEW_SERVE_STEPS),
        dict(zip(("linear_scan", "flash_attention", "decode_attention"),
                 want)))
    phase_serve_logits(run)
    k3, _, k5 = want
    if k3:
        phase_serve_split(run, "decode_attention", k5 // NEW_SERVE_STEPS)
        phase_prefill_split(run, k3)
    if run.arch.family == "moe":
        phase_moe_layers(run)
    if arch == MOE_SPLIT:
        phase_serve_split(run, "decode_attention", k5 // NEW_SERVE_STEPS)
        phase_moe_split(run)
        fb = run.first_batch
        SAVED_SERVE.update(
            tokens=fb["tokens"].cpu(),
            actions=[a.cpu() for a in fb["actions"]],
            logits=[lg.float().cpu() for lg in fb["logits"]],
            num_actions=run.num_actions, layers=layers)
    del run
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# slice 14: MoE, cross-attention and enc-dec


def phase_moe_layers(run) -> Tuple[float, int]:
    """Each MoE layer of the first batch's prefill against the plain route
    on the same input: the kernel route's own hidden state, layer by
    layer. A block's update (its output less its input) on the kernel
    route and on the plain route is held to ``LOGITS_RTOL`` of the plain
    one's largest magnitude, and the tokens whose top-k expert sets the
    two routes' routers chose differently are counted. Returns (the worst
    error over its bar's scale, tokens routed differently in all)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import embed, torch_dtype
    from repro_torch.params import tree_map

    cfg, params = run.arch, run.params
    toks = run.first_batch["tokens"]
    b, t = toks.shape
    positions = torch.arange(t, device=toks.device).expand(b, t)
    routes = []
    real_route = moe_lib.route

    def recorded(p, xr, c):
        out = real_route(p, xr, c)
        routes.append(out[1])
        return out

    worst, moved, lines = 0.0, 0, []
    moe_lib.route = recorded
    try:
        with torch.no_grad():
            x = embed(params["embed"], toks, torch_dtype(cfg.dtype))
            for gi in range(tfm.num_groups(cfg)):
                p = tree_map(lambda a: a[gi], params["stack"]["scan"])["l0"]
                routes.clear()
                ys = [tfm.apply_block(p, x, positions, cfg, "moe",
                                      mode="prefill", cache=None,
                                      impl=impl)[0]
                      for impl in ("auto", "ref")]
                got, want = (y.float() - x.float() for y in ys)
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                picked = [torch.sort(r, dim=-1).values for r in routes]
                differ = int((picked[0] != picked[1]).any(-1).sum())
                if not err <= LOGITS_RTOL * scale:
                    raise AssertionError(
                        f"{cfg.name} MoE layer {gi}: max abs err {err:.3e} "
                        f"> {LOGITS_RTOL} x max |update| {scale:.3e}; "
                        f"{differ} of {b * t} tokens routed differently")
                worst, moved = max(worst, err / scale), moved + differ
                lines.append(f"{gi}: {100 * err / scale:.3f}%/{differ}")
                x = ys[0]
    finally:
        moe_lib.route = real_route
    print(f"{cfg.name} MoE layers vs the plain route on the kernel route's "
          f"own input (prefill, {b * t} tokens, top-"
          f"{cfg.moe.num_experts_per_tok} of {cfg.moe.num_experts}): worst "
          f"{100 * worst:.3f}% of the update's max (bar "
          f"{100 * LOGITS_RTOL:.0f}%), {moved} token-layers routed "
          f"differently; layer: err/tokens {' '.join(lines)}")
    return worst, moved


def phase_moe_split(run) -> None:
    """Where an MoE layer's time goes in a decode step, at the served
    shape: layer 0's FFN on a (B, 1, d) bf16 input, whole and by parts,
    each timed with CUDA events (the call) and from a profiler trace (the
    card's busy time, ``_device_ms``): the router (``route``), the f32 ->
    bf16 casts of the expert kernels (each layer casts them at every
    step), the three expert products on cast kernels, and the rest (the
    dispatch's bookkeeping and index writes, the combine), the whole less
    those."""
    from repro_torch.models import common
    from repro_torch.models import moe as moe_lib
    from repro_torch.params import tree_map

    cfg = run.arch
    m = cfg.moe
    bf = torch.bfloat16
    dev = torch.device("cuda", 0)
    p = tree_map(lambda a: a[0], run.params["stack"]["scan"])["l0"]["ffn"]
    b = run.first_batch["tokens"].shape[0]
    x = _rand((b, 1, cfg.d_model), 31, bf, dev)
    cap = 2 * moe_lib._capacity(b, cfg)
    names = ("up", "gate", "down")
    w = {n: p[n]["kernel"].to(bf) for n in names}
    disp = _rand((1, m.num_experts, cap, cfg.d_model), 32, bf, dev)
    act = common.activation("gelu" if cfg.activation == "geglu" else "silu")

    def products():
        up = torch.einsum("recd,edf->recf", disp, w["up"])
        h = act(torch.einsum("recd,edf->recf", disp, w["gate"])) * up
        return torch.einsum("recf,efd->recd", h, w["down"])

    parts = [("whole", lambda: moe_lib.apply_moe(p, x, cfg)),
             ("router", lambda: moe_lib.route(p, x.reshape(1, b, -1), cfg)),
             ("casts", lambda: [p[n]["kernel"].to(bf) for n in names]),
             ("products", products)]
    got = {}
    with torch.no_grad():
        for name, fn in parts:
            got[name] = (_time_ms(fn, 50), _device_ms(fn, None, 20)[0])
    rest = tuple(got["whole"][i] - sum(got[n][i] for n in
                                       ("router", "casts", "products"))
                 for i in (0, 1))
    cast_bytes = 6 * sum(p[n]["kernel"].numel() for n in names)
    print(f"{cfg.name} MoE layer in a decode step (B={b}, {m.num_experts} "
          f"experts, top-{m.num_experts_per_tok}, capacity {cap}), call / "
          f"device ms: " + ", ".join(
              f"{n} {c:.5f} / {d:.5f}" for n, (c, d) in got.items())
          + f", rest (dispatch and combine) {rest[0]:.5f} / {rest[1]:.5f};"
          f" the casts move {cast_bytes / 1e9:.3f} GB "
          f"({cast_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); {_card_line()}")


def phase_cross_config(lk, fk, dk, arch: str, layers: int, params: int,
                       want: Tuple[int, int, int]):
    """Phases 23c-23d: llama-3.2-vision-11b or whisper-small at full width
    and all its layers through the backbone API (the server sends tokens
    only): the server's weights (random, seed 0, its vocab of at least
    4096 and 18 actions), ``CROSS_BATCH`` streams of ``CROSS_CTX`` tokens
    and the stub frontend's embeddings (bf16, from a seeded generator on
    the card), ``apply_prefill`` and ``NEW_SERVE_STEPS`` sampled
    ``apply_decode(batch=)`` steps. The launches of (K3, K4, K5) over
    exactly that must equal ``want`` (the cached encoder keys win, so no
    decode step reruns the encoder or K4); every logit finite and of its
    shape; then the logits against the plain route (phase 12). Returns
    the launches."""
    import numpy as np

    from repro_torch import params as params_lib
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import NUM_ACTIONS
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = get_config(arch)
    cfg = cfg.replace(vocab_size=max(cfg.vocab_size, 4096))
    a = NUM_ACTIONS
    specs = bb.backbone_specs(cfg, a)
    count = common.param_count(specs)
    weights = params_lib.from_jax(common.init_params(specs, 0, dev), dev,
                                  requires_grad=False)
    key = "image_embed" if cfg.family == "vlm" else "enc_embed"
    gen = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn((CROSS_BATCH, cfg.encoder_seq_len, cfg.d_model),
                      generator=gen, device=dev).to(torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (CROSS_BATCH, CROSS_CTX))).to(dev)
    batch = {"tokens": toks, key: emb}
    kernels = {"linear_scan": lk.linear_scan,
               "flash_attention": fk.flash_attention,
               "decode_attention": dk.decode_attention}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()

    actions = []
    with torch.no_grad():
        marks = [_mark()]
        out = bb.apply_prefill(weights, batch, cfg, a)
        marks.append(_mark())
        logits, cache, tok = [out.policy_logits], out.cache, toks[:, -1:]
        for i in range(NEW_SERVE_STEPS):
            out = bb.apply_decode(weights, tok, cache, CROSS_CTX + i, cfg, a,
                                  batch=batch)
            cache = out.cache
            action = torch.multinomial(
                torch.softmax(out.policy_logits[:, 0], dim=-1), 1,
                generator=gen)
            tok = action % cfg.vocab_size
            marks.append(_mark())
            logits.append(out.policy_logits)
            actions.append(action)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    for name, fn in kernels.items():
        PATH_SHAPES[name] |= fn.shapes
    peak = torch.cuda.max_memory_allocated()
    want = dict(zip(kernels, want))
    if (cfg.num_layers, count) != (layers, params) or launches != want:
        raise AssertionError(f"{arch} through the backbone API: (layers, "
                             f"params) {(cfg.num_layers, count)}, launches "
                             f"{launches}; expected {(layers, params)}, "
                             f"launches {want}")
    for i, lg in enumerate(logits):
        if tuple(lg.shape) != (CROSS_BATCH, 1, a) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{arch} logits {i}: {tuple(lg.shape)}, "
                                 f"finite {bool(torch.isfinite(lg).all())}")
    decode_ms = sorted(m0.elapsed_time(m1)
                       for m0, m1 in zip(marks[1:], marks[2:]))
    print(f"backbone API: {arch} {count:,} params, {cfg.num_layers} layers"
          f" (+{cfg.encoder_layers} encoder), d_model {cfg.d_model}, "
          f"{key} {tuple(emb.shape)} bf16, batch {CROSS_BATCH}, ctx "
          f"{CROSS_CTX}; launches K3 {launches['linear_scan']} K4 "
          f"{launches['flash_attention']} K5 {launches['decode_attention']}")
    print(f"backbone API: {arch} prefill {marks[0].elapsed_time(marks[1]):.3f}"
          f" ms, decode step {decode_ms[len(decode_ms) // 2]:.3f} ms (median "
          f"of {len(decode_ms)}), peak allocated {peak / 1e9:.2f} GB "
          f"({held / 1e9:.2f} GB of it held before the run); "
          f"{_card_line()}")
    run = types.SimpleNamespace(
        params=weights, arch=cfg, num_actions=a,
        first_batch={"tokens": toks, "actions": actions, "logits": logits,
                     "ctx": {key: emb}})
    phase_serve_logits(run)
    del run, weights, cache, out, emb, batch
    torch.cuda.empty_cache()
    return launches


def phase_serve_path_shapes(lk, fk, dk, dev):
    """Phase 24: every shape at which a serving path launched K3, K4 or
    K5 (``PATH_SHAPES``) and that phases 9, 10 and 15 left out, held
    against the plain version as those phases hold theirs (K5 with the
    serving paths' bias: every slot valid). Returns the worst errors
    (K3, K4, K5)."""
    k3_done = {(t, n, init) for t, n in K3_SHAPES for init in (True, False)}
    dtypes = (torch.bfloat16, torch.float32)
    k4_done = {(b, t, s, h, kh, d, causal, window, dt)
               for b, t, s, h, kh, d, causal, window in K4_CASES
               for dt in dtypes}
    k5_done = {(b, h, kh, s, d, dt) for b, h, kh, s, d, _, _ in K5_CASES
               for dt in dtypes}
    todo = {name: sorted(PATH_SHAPES[name] - done, key=str)
            for name, done in (("linear_scan", k3_done),
                               ("flash_attention", k4_done),
                               ("decode_attention", k5_done))}
    print(f"path shapes: K3 launched at "
          f"{sorted(PATH_SHAPES['linear_scan'])}, K4 at "
          f"{sorted(PATH_SHAPES['flash_attention'], key=str)}, K5 at "
          f"{sorted(PATH_SHAPES['decode_attention'], key=str)}; not in "
          f"phases 9, 10 and 15, checked now: {todo}")
    from repro_torch.models.attention import decode_bias

    errs = {"linear_scan": 0.0, "flash_attention": 0.0,
            "decode_attention": 0.0}
    for t, n, init in todo["linear_scan"]:
        a, b, h0 = _scan_inputs(t, n, t + n, dev)
        h0 = h0 if init else None
        errs["linear_scan"] = max(errs["linear_scan"], _check(
            f"K3 path (T,N)={(t, n)} h0={init}", [lk.linear_scan(a, b, h0)],
            [lk.linear_scan_plain(a, b, h0)]))
    for n, (b, t, s, h, kh, d, causal, window, dt) in \
            enumerate(todo["flash_attention"]):
        q = _rand((b, t, h, d), 500 + 3 * n, dt, dev)
        k = _rand((b, s, kh, d), 501 + 3 * n, dt, dev)
        v = _rand((b, s, kh, d), 502 + 3 * n, dt, dev)
        errs["flash_attention"] = max(errs["flash_attention"], _attn_check(
            f"K4 path {(b, t, s, h, kh, d, causal, window, dt)}",
            fk.flash_attention(q, k, v, causal, window),
            fk.flash_attention_plain(q, k, v, causal, window)))
    for n, (b, h, kh, s, d, dt) in enumerate(todo["decode_attention"]):
        q = _rand((b, h, d), 600 + 3 * n, dt, dev)
        k = _rand((b, s, kh, d), 601 + 3 * n, dt, dev)
        v = _rand((b, s, kh, d), 602 + 3 * n, dt, dev)
        bias = decode_bias(s, s, 0, b, dev)
        errs["decode_attention"] = max(errs["decode_attention"], _attn_check(
            f"K5 path {(b, h, kh, s, d, dt)}",
            dk.decode_attention(q, k, v, bias),
            dk.decode_attention_plain(q, k, v, bias)))
    torch.cuda.synchronize()
    return (errs["linear_scan"], errs["flash_attention"],
            errs["decode_attention"])


# ---------------------------------------------------------------------------
# slice 15: token training


def _kernel_fns(vk, lk, fk, dk):
    return {"vtrace": vk.vtrace, "loss_vtrace": vk.loss_vtrace,
            "linear_scan": lk.linear_scan,
            "flash_attention": fk.flash_attention,
            "decode_attention": dk.decode_attention}


def _zero_counts(kernels) -> None:
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0


def _unmoved(params, init, skip=()) -> list:
    """The leaves of ``params`` equal to their initial values, but those
    whose names end with one of ``skip``."""
    from repro_torch import params as params_lib

    now, then = params_lib.flatten(params), params_lib.flatten(init)
    return [k for k in now if not k.endswith(tuple(skip)) and
            torch.equal(now[k].detach(), then[k])]


def _below_rounding(leaf, gmax: float, clip: float, icfg) -> bool:
    """Whether one RMSProp step from a zero ``ms`` (``lr * g /
    sqrt((1 - decay) g^2 + eps)``, largest at the leaf's largest clipped
    |g|, ``gmax * clip``) is under half the float32 spacing of the
    leaf's smallest |value|: then no element can move in that step."""
    g = gmax * clip
    step = icfg.learning_rate * g / math.sqrt(
        (1 - icfg.rmsprop_decay) * g * g + icfg.rmsprop_eps)
    low = float(leaf.detach().abs().min())
    spacing = (2.0 ** math.floor(math.log2(low)) *
               torch.finfo(torch.float32).eps) if low > 0 else 0.0
    return step < spacing / 2


def _ms_since(event) -> float:
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    return event.elapsed_time(end)


def _mark():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def phase_token_train(vk, lk, fk, dk, dev):
    """Phase 25: ``train --arch stablelm-1.6b`` on the card at full width
    and all 24 layers, the CLI's 32 envs x unroll 20 on catch, for
    ``TRAIN_STEPS`` steps, every count zeroed just before and read just
    after: K5 once a layer a decode step, K2 once a step, K1, K3 and K4
    never. Every leaf moved from its initial value, the loss finite. Then
    one actor unroll and one learner step timed, and one more learner step
    profiled for the card's busy share. Returns (launches, the run, the
    learner step's busy share)."""
    from torch.profiler import profile

    from repro_torch import params as params_lib
    from repro_torch.core import actor as actor_lib
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.driver import init_params
    from repro_torch.launch import train as train_lib
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    kernels = _kernel_fns(vk, lk, fk, dk)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dk.decode_attention.shapes.clear()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    run = train_lib.train(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    ACTOR_K5_SHAPES.update(dk.decode_attention.shapes)
    unroll_len, envs = run.icfg.unroll_length, run.last_batch[
        "actions"].shape[0]
    want = {"vtrace": 0, "loss_vtrace": TRAIN_STEPS, "linear_scan": 0,
            "flash_attention": 0,
            "decode_attention": TRAIN_STEPS * unroll_len * TRAIN_LAYERS}
    count = common.param_count(bb.backbone_specs(run.arch,
                                                 run.env.num_actions))
    if run.arch.num_layers != TRAIN_LAYERS or launches != want or \
            (envs, unroll_len) != (MAIN_B, MAIN_T):
        raise AssertionError(
            f"token training {' '.join(TRAIN_ARGV)}: {run.arch.num_layers} "
            f"layers, {envs} envs x unroll {unroll_len}, launches "
            f"{launches}; expected {TRAIN_LAYERS}, {MAIN_B} x {MAIN_T}, "
            f"launches {want}")
    loss = float(run.metrics["loss/total"])
    if not math.isfinite(loss):
        raise AssertionError(f"token training: final loss {loss}")
    with torch.no_grad():
        init = init_params(run.arch, run.env.num_actions, 0, dev)
        stuck = _unmoved(run.params, init)
    del init
    tree_names = params_lib.flatten(run.params)
    if stuck:
        raise AssertionError(f"token training: {len(stuck)} leaves did not "
                             f"move: {stuck[:8]}")
    toks = run.last_batch["obs_token"]
    print(f"token training: {TRAIN_ARCH} {count:,} params, "
          f"{run.arch.num_layers} layers, d_model {run.arch.d_model}, "
          f"vocab {run.arch.vocab_size}, {envs} envs x unroll {unroll_len} "
          f"(obs_token {tuple(toks.shape)}), {TRAIN_STEPS} steps in "
          f"{wall:.1f} s; launches K2 {launches['loss_vtrace']} K5 "
          f"{launches['decode_attention']} (K1, K3, K4 0); final loss "
          f"{loss:.4f}; every one of {len(tree_names)} leaves moved")
    print(f"token training: frames/s {run.fps:.1f} (steps 2-{TRAIN_STEPS}),"
          f" peak allocated {peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held "
          f"before the run); {_card_line()}")

    # where a step's time goes: one unroll and one learner step, each to a
    # synchronise, then one learner step profiled
    init_fn, unroll = actor_lib.build_actor(run.env, run.arch, run.icfg,
                                            envs, dev)
    train_step, opt = learner_lib.build_train_step(run.arch, run.icfg,
                                                   run.env.num_actions)
    params, opt_state = run.params, opt.init(run.params)
    start = _mark()
    _, batch = unroll(params, init_fn(1))
    actor_ms = _ms_since(start)
    start = _mark()
    params, opt_state, _ = train_step(params, opt_state, TRAIN_STEPS, batch)
    learner_ms = _ms_since(start)
    print(f"token training split: actor unroll {actor_ms:.3f} ms "
          f"({unroll_len} decode steps, {unroll_len * TRAIN_LAYERS} K5 "
          f"launches), learner step {learner_ms:.3f} ms (CUDA events to a "
          f"synchronise); {100 * actor_ms / (actor_ms + learner_ms):.1f}% "
          f"acting")

    def take(activities):
        nonlocal params, opt_state
        with profile(activities=activities) as prof:
            _trace_lead_in()
            params, opt_state, _ = train_step(params, opt_state,
                                              TRAIN_STEPS + 1, batch)
            torch.cuda.synchronize()
            _trace_pad()
        return prof

    prof = _traced("token learner step", take, "loss_vtrace", 1)
    busy = _print_busy("token learner step", prof, 1, learner_ms,
                       "loss_vtrace")
    del opt_state, batch, prof
    torch.cuda.empty_cache()
    return launches, run, busy


def phase_train_routes(run) -> None:
    """Phase 25a: one learner step of phase 25's model, on its last batch
    and its final params, through the kernel route (K2, ``impl='auto'``)
    and the plain route (``vtrace_impl='scan'``, ``impl='ref'``): the
    losses, the global gradient norms and each leaf's gradient (cosine,
    relative norm) held to the ROUTE_* bars; a NaN anywhere fails it.
    These launches compare routes and are not counted."""
    from repro_torch import params as params_lib
    from repro_torch.core import learner as learner_lib

    batch, n_act = run.last_batch, run.env.num_actions
    outs = {}
    for route, kw in (("kernel", {}),
                      ("plain", dict(vtrace_impl="scan", impl="ref"))):
        loss_fn = learner_lib.build_loss_fn(run.arch, run.icfg, n_act, **kw)
        grads, metrics = learner_lib._grad_fn(loss_fn)(run.params, batch)
        outs[route] = (grads, float(metrics["loss/total"]))
    (gk, lk_), (gp, lp) = outs["kernel"], outs["plain"]
    names = list(params_lib.flatten(run.params))
    bad = [n for grads in (gk, gp) for n, g in zip(names, grads)
           if not bool(torch.isfinite(g).all())]
    if bad or not (math.isfinite(lk_) and math.isfinite(lp)):
        raise AssertionError(f"routes: non-finite loss ({lk_}, {lp}) or "
                             f"gradients {bad[:8]}")
    norm_k = math.sqrt(sum(float(g.double().square().sum()) for g in gk))
    norm_p = math.sqrt(sum(float(g.double().square().sum()) for g in gp))
    worst_cos, worst_rel, where = 1.0, 0.0, None
    for name, a, b in zip(names, gk, gp):
        a, b = a.double().flatten(), b.double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        if na == nb == 0.0:
            continue
        cos = float(a @ b) / max(na * nb, 1e-300)
        rel = abs(na / max(nb, 1e-300) - 1.0)
        if cos < worst_cos:
            worst_cos, where = cos, name
        worst_rel = max(worst_rel, rel)
    loss_err = abs(lk_ - lp) / max(abs(lp), 1e-12)
    norm_err = abs(norm_k / norm_p - 1.0)
    print(f"routes: {run.arch.name} learner step, kernel (K2) against plain "
          f"(scan, impl='ref'): loss {lk_:.6f} vs {lp:.6f} (rel "
          f"{loss_err:.3e}, bar {ROUTE_LOSS_RTOL:.0e}), global grad norm "
          f"{norm_k:.6e} vs {norm_p:.6e} (rel {norm_err:.3e}, bar "
          f"{ROUTE_NORM_RTOL:.0e}); over {len(names)} leaves the worst "
          f"cosine {worst_cos:.7f} (bar {ROUTE_COS}) and norm ratio off by "
          f"{worst_rel:.3e} (bar {ROUTE_LEAF_RTOL:.0e}); the lowest cosine "
          f"at {where}")
    if not (loss_err <= ROUTE_LOSS_RTOL and norm_err <= ROUTE_NORM_RTOL
            and worst_cos >= ROUTE_COS and worst_rel <= ROUTE_LEAF_RTOL):
        raise AssertionError("routes: the kernel route's learner step "
                             "is off the plain route's")
    del outs, gk, gp
    torch.cuda.empty_cache()


def _stub_batch(cfg, b: int, t: int, n_act: int, dev):
    """A learner batch of ``b`` trajectories of ``t`` steps drawn on the
    card, for a backbone the envs cannot feed or a step timed without an
    actor: tokens, actions, rewards, discounts and behaviour log-probs
    from a seeded generator, and for the vlm and audio backbones the stub
    frontend's embeddings (B, encoder_seq_len, d_model) in bf16."""
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {
        "obs_token": torch.randint(0, cfg.vocab_size, (b, t + 1),
                                   generator=gen, device=dev),
        "actions": torch.randint(0, n_act, (b, t), generator=gen,
                                 device=dev),
        "rewards": torch.randn((b, t), generator=gen, device=dev),
        "discounts": torch.full((b, t), 0.99, device=dev),
        "behaviour_logprob": -torch.rand((b, t), generator=gen,
                                         device=dev) - 0.5,
    }
    if cfg.family in ("vlm", "audio"):
        key = "image_embed" if cfg.family == "vlm" else "enc_embed"
        batch[key] = torch.randn((b, cfg.encoder_seq_len, cfg.d_model),
                                 generator=gen, device=dev).to(torch.bfloat16)
    return batch


def phase_train_family(vk, lk, fk, dk, dev, arch: str, layers: int,
                       batch_b: int, want: Tuple[int, int]):
    """Phase 25b: ``arch`` at full width and all its layers through
    ``build_actor`` (one unroll of 32 envs x 20 on catch; none for the
    audio backbone, which the envs cannot feed) and ``build_train_step``
    (one learner step, its two halves ``build_grad_apply_steps``, of
    which ``build_train_step``'s step is the composition, so the
    gradients can be read; the audio backbone's on ``_stub_batch``),
    every count zeroed just before and read just after: (K3 forward +
    backward, K5) equal to ``want``, K4 and K1 never, K2 once. Every
    leaf's gradient is finite and nonzero (but a cross-attention key
    bias: the softmax over keys ignores a shift of every score alike, so
    its gradient is 0 in exact arithmetic), and every leaf moved but
    those whose one step is under float32 rounding (``_below_rounding``:
    a ones-initialised scale or ``a_log`` whose gradient, clipped to the
    global norm of 40, is small); the loss finite, and an MoE backbone's
    aux term in it. Returns the launches."""
    from repro_torch import params as params_lib
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import actor as actor_lib
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.driver import init_params
    from repro_torch.data.envs import make_env
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    kernels = _kernel_fns(vk, lk, fk, dk)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    env = make_env("catch")
    cfg = get_config(arch)
    cfg = cfg.replace(vocab_size=max(cfg.vocab_size, env.vocab_size))
    n_act = env.num_actions
    icfg = ImpalaConfig(num_actions=n_act, unroll_length=MAIN_T)
    count = common.param_count(bb.backbone_specs(cfg, n_act))
    params = init_params(cfg, n_act, 0, dev)
    grad_step, apply_step, opt = learner_lib.build_grad_apply_steps(
        cfg, icfg, n_act)
    opt_state = opt.init(params)
    lk.linear_scan.shapes.clear()
    dk.decode_attention.shapes.clear()
    _zero_counts(kernels)
    start = _mark()
    actor_ms = 0.0
    if cfg.family in ("vlm", "audio"):
        batch = _stub_batch(cfg, batch_b, MAIN_T, n_act, dev)
    else:
        init_fn, unroll = actor_lib.build_actor(env, cfg, icfg, batch_b,
                                                dev)
        _, batch = unroll(params, init_fn(1))
        actor_ms = _ms_since(start)
        start = _mark()
    grads, metrics = grad_step(params, batch)
    gmax = [float(g.abs().max()) for g in grads]
    params, opt_state, step_metrics = apply_step(params, opt_state, 0, grads)
    learner_ms = _ms_since(start)
    del grads
    metrics.update(step_metrics)
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    ACTOR_K5_SHAPES.update(dk.decode_attention.shapes)
    k3_shapes = set(lk.linear_scan.shapes)
    expect = {"vtrace": 0, "loss_vtrace": 1, "linear_scan": want[0],
              "flash_attention": 0, "decode_attention": want[1]}
    if cfg.num_layers != layers or launches != expect:
        raise AssertionError(f"training {arch}: {cfg.num_layers} layers, "
                             f"launches {launches}; expected {layers}, "
                             f"{expect}")
    checked = {(t, n, h0) for t, n, h0 in K3_TRAIN_SHAPES}
    checked |= {c + ("bwd",) for c in checked}
    if not k3_shapes <= checked:
        raise AssertionError(f"training {arch}: K3 launched at "
                             f"{sorted(k3_shapes, key=str)}, not all held "
                             f"to their plain versions in phase 15 "
                             f"({sorted(checked, key=str)})")
    loss = float(metrics["loss/total"])
    aux = metrics.get("loss/moe_aux")
    if not math.isfinite(loss) or (cfg.moe is not None) != (aux is not None) \
            or (aux is not None and not math.isfinite(float(aux))):
        raise AssertionError(f"training {arch}: loss {loss}, moe aux {aux}")
    del opt_state, batch
    names = list(params_lib.flatten(params))
    skip = ("xattn/k/bias",)
    blind = [n for n, g in zip(names, gmax)
             if not (math.isfinite(g) and (g > 0 or n.endswith(skip)))]
    if blind:
        raise AssertionError(f"training {arch}: gradients zero or not "
                             f"finite at {blind[:8]}")
    clip = min(1.0, icfg.grad_clip_norm /
               max(float(metrics["opt/grad_norm"]), 1e-30))
    with torch.no_grad():
        init = init_params(cfg, n_act, 0, dev)
        stuck = _unmoved(params, init, skip)
    del init
    leaves = params_lib.flatten(params)
    rounded = {n: gmax[names.index(n)] for n in stuck
               if _below_rounding(leaves[n], gmax[names.index(n)], clip,
                                  icfg)}
    if set(stuck) - set(rounded):
        raise AssertionError(f"training {arch}: leaves did not move: "
                             f"{sorted(set(stuck) - set(rounded))[:8]}")
    print(f"training {arch}: {count:,} params, {cfg.num_layers} layers"
          + (f" (+{cfg.encoder_layers} encoder)" if cfg.encoder_layers
             else "")
          + f", learner batch {batch_b} x {MAIN_T}; launches K3 "
          f"{launches['linear_scan']} at {sorted(k3_shapes, key=str)}, K5 "
          f"{launches['decode_attention']}, K2 1, K1 and K4 0; loss "
          f"{loss:.4f}" + (f", moe aux {float(aux):.4f} (aux_coef 0.01 x "
                          f"B*T in the loss)" if aux is not None else "")
          + f"; every one of {len(names)} leaves has a finite nonzero "
          f"gradient" + (" (cross-attention key biases aside)"
                         if cfg.encoder_layers or cfg.family == "vlm"
                         else "")
          + " and moved"
          + (f", but {len(rounded)} whose one step is under float32 "
             f"rounding (max |grad|, then scaled by {clip:.3e} in the clip "
             f"to the global norm of {icfg.grad_clip_norm:g}: "
             + ", ".join(f"{n} {g:.3e}" for n, g in sorted(rounded.items()))
             + ")" if rounded else ""))
    acted = (f"actor unroll {actor_ms:.3f} ms" if actor_ms else
             "no actor (a stub batch)")
    print(f"training {arch}: {acted}, learner step "
          f"{learner_ms:.3f} ms (the first of the process at these shapes),"
          f" peak allocated {peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held "
          f"before); {_card_line()}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_actor_k5(dk, dev) -> float:
    """Phase 25c: every (B, H, K, S, D, dtype) a token actor launched K5 at
    (``ACTOR_K5_SHAPES``), against its plain version at each cache index
    0..S-2 of an unroll, with the decode path's bias (slots 0..index
    valid; under recurrentgemma's window of 2048 the ring of S = 21 slots
    never wraps in an unroll, so its bias is the same). Returns the worst
    error."""
    from repro_torch.models.attention import decode_bias

    worst = 0.0
    for n, (b, h, kh, s, d, dt) in enumerate(sorted(ACTOR_K5_SHAPES,
                                                   key=str)):
        q = _rand((b, h, d), 700 + 3 * n, dt, dev)
        k = _rand((b, s, kh, d), 701 + 3 * n, dt, dev)
        v = _rand((b, s, kh, d), 702 + 3 * n, dt, dev)
        errs = [_attn_check(f"K5 actor {(b, h, kh, s, d, dt)} index {i}",
                            dk.decode_attention(q, k, v, bias),
                            dk.decode_attention_plain(q, k, v, bias))
                for i in range(s - 1)
                for bias in (decode_bias(i, s, 0, b, dev),)]
        torch.cuda.synchronize()
        print(f"K5 actor shape (B,H,K,S,D)={(b, h, kh, s, d)} {dt}: cache "
              f"indices 0..{s - 2}, max abs err {max(errs):.3e}")
        worst = max(worst, *errs)
    if not ACTOR_K5_SHAPES:
        raise AssertionError("phase 25c: no token actor launched K5")
    return worst


def _loss_gap(f32_loss: float, mixed_loss: float) -> Tuple[float, float]:
    """(|mixed - f32|, its bar) at full width: ``MIXED_LOSS_GAP``, or
    ``MIXED_LOSS_RGAP`` of the f32 loss where that is larger."""
    return (abs(mixed_loss - f32_loss),
            max(MIXED_LOSS_GAP, MIXED_LOSS_RGAP * abs(f32_loss)))


def _mixed_state(master, opt):
    """The mixed step's bf16 live tree and ``opt_state`` over the f32
    ``master`` (whose leaves require grad, so the live ones do)."""
    from repro_torch.models import common

    return (common.cast(master, torch.bfloat16),
            {"opt": opt.init(master), "master": master})


def _check_mixed(what: str, live, master) -> None:
    """Every master leaf f32 and finite, every live leaf bf16 and equal to
    bf16(master), bit for bit."""
    from repro_torch import params as params_lib

    masters = params_lib.flatten(master)
    bad = [n for n, m in masters.items() if m.dtype != torch.float32
           or not bool(torch.isfinite(m).all())]
    off = [n for n, p in params_lib.flatten(live).items()
           if p.dtype != torch.bfloat16
           or not torch.equal(p, masters[n].to(torch.bfloat16))]
    if bad or off:
        raise AssertionError(f"{what}: master leaves not f32 and finite "
                             f"{bad[:8]}; live leaves not bf16(master) "
                             f"{off[:8]}")


def _steps_timed(what: str, kernels, step_fn, params, opt_state, batch,
                 want: dict, first_step: int = 0):
    """A warm-up step and a timed one of ``step_fn`` (CUDA events to a
    synchronise), each from a clean peak-memory reset, the kernel counts
    zeroed just before the two and read just after: they must equal
    ``want``. Returns (params, opt_state, [(loss, ms, peak bytes
    allocated)] a step)."""
    _zero_counts(kernels)
    out = []
    for k in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = _mark()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             first_step + k, batch)
        ms = _ms_since(start)
        out.append((float(metrics["loss/total"]), ms,
                    torch.cuda.max_memory_allocated()))
    launches = {name: fn.launches for name, fn in kernels.items()}
    if launches != want or not all(math.isfinite(x[0]) for x in out):
        raise AssertionError(f"{what}: launches {launches}, losses "
                             f"{[x[0] for x in out]}; expected {want}")
    return params, opt_state, out


def phase_mixed_stablelm(vk, lk, fk, dk, run, f32_busy: float):
    """25d (i): phase 25's model at full width and depth on its last batch
    (32 x 21 tokens, catch): the f32 learner step and the mixed-precision
    one (bf16 live params, the f32 master in the optimizer state), each a
    warm-up and a timed step from phase 25's final params (the mixed one
    from their bf16 cast with a copy as master). Their first losses, on
    the same params, within ``_loss_gap``'s bar; K2 once a step, no other
    kernel; then one mixed step traced for its busy share, printed beside
    phase 25's f32 step's ``f32_busy``. Returns the launches."""
    from torch.profiler import profile

    from repro_torch import params as params_lib
    from repro_torch.core import learner as learner_lib

    kernels = _kernel_fns(vk, lk, fk, dk)
    want = {"vtrace": 0, "loss_vtrace": 2, "linear_scan": 0,
            "flash_attention": 0, "decode_attention": 0}
    n_act, rows, launches = run.env.num_actions, {}, dict.fromkeys(want, 0)
    for mixed in (False, True):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        step_fn, opt = learner_lib.build_train_step(
            run.arch, run.icfg, n_act, mixed_precision=mixed)
        params = params_lib.copy(run.params)
        if mixed:
            params, opt_state = _mixed_state(params, opt)
        else:
            opt_state = opt.init(params)
        params, opt_state, out = _steps_timed(
            f"mixed precision {run.arch.name}", kernels, step_fn, params,
            opt_state, run.last_batch, want, TRAIN_STEPS)
        for name in launches:
            launches[name] += kernels[name].launches
        rows[mixed] = out
        (loss, _, peak0), (_, ms, peak) = out
        print(f"mixed precision {run.arch.name}: "
              f"{'mixed (bf16 live, f32 master)' if mixed else 'f32'} step "
              f"{ms:.3f} ms (CUDA events to a synchronise, after a warm-up "
              f"step), first loss {loss:.6f}; the step's own peak "
              f"{(peak - base) / 1e9:.2f} GB (its params, state and "
              f"transients; warm-up step {(peak0 - base) / 1e9:.2f} GB), "
              f"peak allocated {peak / 1e9:.2f} GB with the "
              f"{base / 1e9:.2f} GB held before")
        if mixed:
            _check_mixed(f"mixed precision {run.arch.name}", params,
                         opt_state["master"])
        else:
            del params, opt_state
    gap, bar = _loss_gap(rows[False][0][0], rows[True][0][0])
    if not gap <= bar:
        raise AssertionError(f"mixed precision {run.arch.name}: loss gap "
                             f"{gap:.6f} > {bar:.6f}")
    print(f"mixed precision {run.arch.name}: loss gap {gap:.6f} (bar "
          f"{bar:.6f}, {100 * gap / abs(rows[False][0][0]):.3f}% of the f32 "
          f"loss), every live leaf bf16(master), every master leaf finite; "
          f"launches {launches}; {_card_line()}")

    def take(activities):
        nonlocal params, opt_state
        with profile(activities=activities) as prof:
            _trace_lead_in()
            params, opt_state, _ = step_fn(params, opt_state,
                                           TRAIN_STEPS + 2, run.last_batch)
            torch.cuda.synchronize()
            _trace_pad()
        return prof

    prof = _traced("mixed learner step", take, "loss_vtrace", 1)
    share = _print_busy("mixed learner step", prof, 1, rows[True][1][1],
                        "loss_vtrace")
    print(f"mixed learner step busy {100 * share:.1f}% against phase 25's "
          f"f32 learner step {100 * f32_busy:.1f}%")
    del params, opt_state, prof
    torch.cuda.empty_cache()
    return launches


def phase_mixed_config(vk, lk, fk, dk, dev, arch: str, layers: int,
                       count: int, k3: int):
    """25d (ii): ``arch`` at full width and all its layers, params
    and master drawn on the card from seed 0, the mixed step on a
    ``_stub_batch`` of 32 x 20 on catch's actions: a warm-up step and a
    timed one (``_steps_timed``: K2 once and K3 ``k3`` times a step),
    the master finite and every live leaf bf16(master); where K3 runs,
    its shapes among phase 15's. Returns the launches."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.driver import init_params
    from repro_torch.data.envs import make_env
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    kernels = _kernel_fns(vk, lk, fk, dk)
    env = make_env("catch")
    cfg = get_config(arch)
    cfg = cfg.replace(vocab_size=max(cfg.vocab_size, env.vocab_size))
    n_act = env.num_actions
    got_count = common.param_count(bb.backbone_specs(cfg, n_act))
    if (cfg.num_layers, got_count) != (layers, count):
        raise AssertionError(f"mixed precision {arch}: {cfg.num_layers} "
                             f"layers, {got_count:,} params; expected "
                             f"{layers}, {count:,}")
    icfg = ImpalaConfig(num_actions=n_act, unroll_length=MAIN_T)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    step_fn, opt = learner_lib.build_train_step(cfg, icfg, n_act,
                                                mixed_precision=True)
    live, opt_state = _mixed_state(init_params(cfg, n_act, 0, dev), opt)
    batch = _stub_batch(cfg, MAIN_B, MAIN_T, n_act, dev)
    lk.linear_scan.shapes.clear()
    want = {"vtrace": 0, "loss_vtrace": 2, "linear_scan": 2 * k3,
            "flash_attention": 0, "decode_attention": 0}
    live, opt_state, out = _steps_timed(f"mixed precision {arch}", kernels,
                                        step_fn, live, opt_state, batch,
                                        want)
    launches = {name: fn.launches for name, fn in kernels.items()}
    _check_mixed(f"mixed precision {arch}", live, opt_state["master"])
    checked = {(t, n, h0) for t, n, h0 in K3_TRAIN_SHAPES}
    checked |= {c + ("bwd",) for c in checked}
    if not set(lk.linear_scan.shapes) <= checked:
        raise AssertionError(f"mixed precision {arch}: K3 launched at "
                             f"{sorted(lk.linear_scan.shapes, key=str)}, "
                             f"not all held in phase 15")
    (_, _, peak0), (loss, ms, peak) = out
    print(f"mixed precision {arch}: {count:,} params, {layers} layers, "
          f"learner batch {MAIN_B} x {MAIN_T} (a stub batch); the mixed "
          f"step {ms:.3f} ms after a warm-up step, loss {loss:.4f}; the "
          f"step's own peak {(peak - base) / 1e9:.2f} GB (warm-up step "
          f"{(peak0 - base) / 1e9:.2f} GB), peak allocated "
          f"{peak / 1e9:.2f} GB with the {base / 1e9:.2f} GB held before; "
          f"launches K2 "
          f"{launches['loss_vtrace']} K3 {launches['linear_scan']}, K1 K4 "
          f"K5 0; every live leaf bf16(master); {_card_line()}")
    del live, opt_state, batch
    torch.cuda.empty_cache()
    return launches


def phase_mixed_moves(vk, lk, fk, dk, dev, arch: str, k3: int):
    """25d (iii): one mixed step of ``arch`` at full width and depth on a
    ``_stub_batch``, through its two halves (``_grad_fn``, then the leaf
    by leaf ``_apply_fn``, which ``build_train_step`` composes): K3
    ``k3`` times forward and as many backward, K2 once; the loss finite;
    every master leaf moved from its initial value but those whose one
    step is under float32 rounding (``_below_rounding``), every live
    leaf bf16(master). Returns the launches."""
    from repro_torch import params as params_lib
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.driver import init_params
    from repro_torch.data.envs import make_env

    kernels = _kernel_fns(vk, lk, fk, dk)
    env = make_env("catch")
    cfg = get_config(arch)
    cfg = cfg.replace(vocab_size=max(cfg.vocab_size, env.vocab_size))
    n_act = env.num_actions
    icfg = ImpalaConfig(num_actions=n_act, unroll_length=MAIN_T)
    opt = learner_lib._optimizer(icfg, None)
    grad_step = learner_lib._grad_fn(learner_lib.build_loss_fn(cfg, icfg,
                                                               n_act))
    apply_step = learner_lib._apply_fn(icfg, opt, mixed=True)
    master = init_params(cfg, n_act, 0, dev)
    init = params_lib.snapshot(master)
    live, opt_state = _mixed_state(master, opt)
    batch = _stub_batch(cfg, MAIN_B, MAIN_T, n_act, dev)
    _zero_counts(kernels)
    grads, metrics = grad_step(live, batch)
    gmax = [float(g.abs().max()) for g in grads]
    live, opt_state, step_metrics = apply_step(live, opt_state, 0, grads)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    want = {"vtrace": 0, "loss_vtrace": 1, "linear_scan": 2 * k3,
            "flash_attention": 0, "decode_attention": 0}
    loss = float(metrics["loss/total"])
    if launches != want or not math.isfinite(loss):
        raise AssertionError(f"mixed precision {arch}: launches "
                             f"{launches}, loss {loss}; expected {want}")
    _check_mixed(f"mixed precision {arch}", live, opt_state["master"])
    clip = min(1.0, icfg.grad_clip_norm /
               max(float(step_metrics["opt/grad_norm"]), 1e-30))
    names = list(params_lib.flatten(master))
    stuck = _unmoved(master, init)
    leaves = params_lib.flatten(master)
    rounded = [n for n in stuck if _below_rounding(
        leaves[n], gmax[names.index(n)], clip, icfg)]
    left = sorted(set(stuck) - set(rounded))
    if left:
        raise AssertionError(f"mixed precision {arch}: master leaves did "
                             f"not move: {left[:8]}")
    print(f"mixed precision {arch}: one mixed step, launches K3 "
          f"{launches['linear_scan']} ({k3} forward + {k3} backward) K2 1, "
          f"loss {loss:.4f}; every one of {len(names)} master leaves moved"
          + (f", but {len(rounded)} whose one step is under float32 "
             f"rounding ({', '.join(sorted(rounded))})" if rounded else "")
          + "; every live leaf bf16(master)")
    del live, opt_state, master, init, batch
    torch.cuda.empty_cache()
    return launches


def phase_mixed_conv(vk, lk, fk, dk, dev):
    """25d (iv): impala-shallow at full width on catch, one actor unroll
    of phase 5's 32 envs x 20, then the f32 learner step and the mixed one
    on that batch from the same params: the bf16 params through the conv
    (its kernel and bias cast to the frames' dtype), K2 once a step and no
    other kernel, the losses within JAX's ``MIXED_LOSS_GAP``. Returns the
    launches."""
    from repro_torch import params as params_lib
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import actor as actor_lib
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.driver import init_params
    from repro_torch.data.envs import make_env

    kernels = _kernel_fns(vk, lk, fk, dk)
    env = make_env("catch")
    cfg = get_config("impala-shallow").replace(image_hw=env.image_hw)
    n_act = env.num_actions
    icfg = ImpalaConfig(num_actions=n_act, unroll_length=MAIN_T)
    params = init_params(cfg, n_act, 0, dev)
    init_fn, unroll = actor_lib.build_actor(env, cfg, icfg, MAIN_B, dev)
    _, batch = unroll(params, init_fn(1))
    _zero_counts(kernels)
    losses = {}
    for mixed in (False, True):
        step_fn, opt = learner_lib.build_train_step(cfg, icfg, n_act,
                                                    mixed_precision=mixed)
        p = params_lib.copy(params)
        p, state = _mixed_state(p, opt) if mixed else (p, opt.init(p))
        p, state, metrics = step_fn(p, state, 0, batch)
        losses[mixed] = float(metrics["loss/total"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    want = {"vtrace": 0, "loss_vtrace": 2, "linear_scan": 0,
            "flash_attention": 0, "decode_attention": 0}
    _check_mixed("mixed precision impala-shallow", p, state["master"])
    gap, bar = abs(losses[True] - losses[False]), MIXED_LOSS_GAP
    if launches != want or not gap <= bar:
        raise AssertionError(f"mixed precision impala-shallow: launches "
                             f"{launches}, losses {losses}; expected "
                             f"{want}, a gap within {bar}")
    print(f"mixed precision impala-shallow: {MAIN_B} envs x unroll "
          f"{MAIN_T} on catch, losses f32 {losses[False]:.6f} mixed "
          f"{losses[True]:.6f} (gap {gap:.6f}, bar {bar:.6f}), K2 once a "
          f"step; the conv ran on bf16 params")
    return launches


# ---------------------------------------------------------------------------
# slice 17: the step builders on the card


def _normal_tree(tree, gen):
    """Each leaf of ``tree`` filled in place with normals of std 0.5 (a
    function, so that no loop variable keeps a leaf alive after it: one
    stacked leaf of stablelm's 32,768-slot cache is 25.8 GB)."""
    from repro_torch.params import tree_leaves

    for leaf in tree_leaves(tree):
        leaf.normal_(generator=gen).mul_(0.5)
    return tree


def _cut_text(shape, batch: int, seq: int) -> str:
    cuts = []
    if batch != shape.global_batch:
        cuts.append(f"B {shape.global_batch} -> {batch}")
    if seq != shape.seq_len:
        cuts.append(f"S {shape.seq_len} -> {seq}")
    return ", ".join(cuts) or "none"


def _rel_check(name: str, got, want, scale=None) -> float:
    """``got`` finite and within ``LOGITS_RTOL`` of ``scale`` (``want``'s
    largest magnitude unless given: phases 20-23's bar); returns the
    error over that scale."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: not finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max()) if scale is None else scale
    if not err <= LOGITS_RTOL * scale:
        raise AssertionError(f"{name}: max abs err {err:.3e} > "
                             f"{LOGITS_RTOL} x {scale:.3e}")
    return err / max(scale, 1e-30)


def _timed_step(kernels, call, between=None):
    """``call()`` once to warm up, ``between()`` (if given), then once
    timed with CUDA events, the kernels counted over both calls (zeroed
    just before, read just after). Returns (the timed call's result, its
    ms, the timed call's own peak bytes, the launches)."""
    _zero_counts(kernels)
    call()
    snap = between() if between else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    start = _mark()
    out = call()
    ms = _ms_since(start)
    peak = torch.cuda.max_memory_allocated() - held
    launches = {name: fn.launches for name, fn in kernels.items()}
    return out, ms, peak, launches, snap


def _step_roofline(what: str, cfg, shape, rules, ms: float, peak: int,
                   port: dict, card: str) -> None:
    """Print the measured step beside two estimates at one device against
    the H100's data sheet (``HW``): the JAX package's TPU model
    (``flops_model.step_cost`` at n_devices = 1, model_axis = 1), which
    counts stored f32 attention scores and, in train, a remat recompute
    the port does not run, so it is no lower bound on the port; and the
    port's own count of this step (``port``: ``eager_cost`` of
    ``steps.trace_pair`` on meta at this shape), the larger of its FLOPs
    over the bf16 peak and its bytes over the HBM rate. ``ms`` is one
    call's stream time between two CUDA events, host launch gaps
    included, not the device's busy time. The memory model's total is
    printed beside the step's own peak."""
    from repro_torch.launch.mesh import HW
    from repro_torch.roofline import flops_model, memory_model

    flops, nbytes = flops_model.step_cost(cfg, shape, 1, 1)
    compute = flops / HW["peak_flops_bf16"] * 1e3
    memory = nbytes / HW["hbm_bw"] * 1e3
    est = max(compute, memory)
    p_compute = port["flops"] / HW["peak_flops_bf16"] * 1e3
    p_memory = port["bytes"] / HW["hbm_bw"] * 1e3
    bound = max(p_compute, p_memory)
    model = memory_model.estimate(cfg, shape, rules)["total"]
    print(f"{what}: {ms:.3f} stream ms (one call between CUDA events "
          f"after a warm-up, host launch gaps included); the step's own "
          f"peak {peak / 1e9:.2f} GB; the port's own count at one device "
          f"(eager_cost on meta at this shape): {port['flops']:.4e} FLOPs, "
          f"{port['bytes']:.4e} bytes, compute {p_compute:.3f} ms, memory "
          f"{p_memory:.3f} ms, bound {bound:.3f} ms "
          f"({'compute' if p_compute >= p_memory else 'memory'}), measured "
          f"/ bound {ms / bound:.2f}; the JAX package's TPU model at one "
          f"device (an estimate, not a bound on the port): compute "
          f"{compute:.3f} ms, memory {memory:.3f} ms, max {est:.3f} ms, "
          f"measured / it {ms / est:.2f}, port FLOPs / its FLOPs "
          f"{port['flops'] / flops:.3f}; memory model {model / 1e9:.2f} GB; "
          f"{card}")


def _k4_rows_plain(q, k, v, q0: int):
    """``flash_attention_plain``'s arithmetic (f32 scores, the causal mask,
    softmax in f32) for query rows at positions ``q0``.. of a causal call
    over all of ``k``/``v``: the plain version on a cut of the queries,
    since its scores over all of T = S = 32,768 would be 137 GB."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, kh, h // kh, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d ** -0.5
    qpos = torch.arange(q0, q0 + t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    scores = torch.where(kpos <= qpos, scores, -1e30)
    out = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(scores, dim=-1),
                       v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _phase26_shapes(lk, fk, dk, dev, shapes, card):
    """Every kernel shape phase 26's steps launched at, held against its
    plain version (K4 at T = S = 32,768 on its last ``K4_ROW_CUT`` query
    rows, all keys), each timed with CUDA events beside its bound. The
    launches here are checks and are not counted. Returns the worst
    errors (K3, K4, K5)."""
    from repro_torch.models.attention import decode_bias

    errs = {"linear_scan": 0.0, "flash_attention": 0.0,
            "decode_attention": 0.0}
    for t, n, init in sorted(shapes["linear_scan"], key=str):
        a, b, h0 = _scan_inputs(t, n, t + n, dev)
        h0 = h0 if init else None
        errs["linear_scan"] = max(errs["linear_scan"], _check(
            f"K3 phase 26 (T,N)={(t, n)} h0={init}",
            [lk.linear_scan(a, b, h0)], [lk.linear_scan_plain(a, b, h0)]))
        ms = _time_ms(lambda: lk.linear_scan(a, b, h0), 10, 2)
        bound, by = _bound(4 * t * n * 3 + (4 * n if init else 0), 2 * t * n)
        print(f"K3 (T,N)={(t, n)}: max abs err {errs['linear_scan']:.3e}; "
              f"{ms:.5f} call ms, bound {bound:.5f} ms ({by}); {card}")
    for n, (b, t, s, h, kh, d, causal, window, dt) in enumerate(
            sorted(shapes["flash_attention"], key=str)):
        gen = torch.Generator(device=dev).manual_seed(800 + n)
        q = torch.randn((b, t, h, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dt)
        out = fk.flash_attention(q, k, v, causal, window)
        if t * s > 4096 * 4096:
            cut = min(K4_ROW_CUT, t)
            if not causal or window or t != s:
                raise AssertionError(f"K4 {(b, t, s)}: no row cut for it")
            what = f"its last {cut} query rows over all {s} keys"
            got, want = out[:, -cut:], _k4_rows_plain(q[:, -cut:], k, v,
                                                      t - cut)
        else:
            what = "whole"
            got = out
            want = fk.flash_attention_plain(q, k, v, causal, window)
        err = _attn_check(f"K4 phase 26 {(b, t, s, h, kh, d, dt)} {what}",
                          got, want)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        del got, want, out
        ms = _time_ms(lambda: fk.flash_attention(q, k, v, causal, window),
                      5, 1)
        pairs = _attn_pairs(t, s, causal, window)
        bound, by = _bound(2 * (2 * b * t * h * d + 2 * b * s * kh * d),
                           4 * b * h * pairs * d, BF16_OPS_PER_S)
        print(f"K4 (B,T,S,H,K,D)={(b, t, s, h, kh, d)} causal={causal} "
              f"{dt}: max abs err {err:.3e} ({what}); {ms:.5f} call ms, "
              f"bound {bound:.5f} ms ({by}); {card}")
        del q, k, v
    for n, (b, h, kh, s, d, dt) in enumerate(sorted(
            shapes["decode_attention"], key=str)):
        gen = torch.Generator(device=dev).manual_seed(900 + n)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dt)
        bias = decode_bias(s, s, 0, b, dev)
        err = _attn_check(f"K5 phase 26 {(b, h, kh, s, d, dt)}",
                          dk.decode_attention(q, k, v, bias),
                          dk.decode_attention_plain(q, k, v, bias))
        errs["decode_attention"] = max(errs["decode_attention"], err)
        ms = _time_ms(lambda: dk.decode_attention(q, k, v, bias), 10, 2)
        bound, by = _bound(2 * (2 * b * h * d + 2 * b * s * kh * d) +
                           4 * b * s, 4 * b * h * s * d, BF16_OPS_PER_S)
        print(f"K5 (B,H,K,S,D)={(b, h, kh, s, d)} {dt}: max abs err "
              f"{err:.3e}; {ms:.5f} call ms, bound {bound:.5f} ms ({by}); "
              f"{card}")
        del q, k, v
    torch.cuda.synchronize()
    return (errs["linear_scan"], errs["flash_attention"],
            errs["decode_attention"])


def _dryrun_start(out_dir: Path):
    """The dry run of ``DRYRUN_PAIR`` in a child process on the host's CPU
    (it never initialises CUDA), started at once so that it runs while
    the card works."""
    shutil.rmtree(out_dir, ignore_errors=True)
    arch, shape = DRYRUN_PAIR
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out_dir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _dryrun_finish(proc, out_dir: Path) -> None:
    """Wait for the dry run; its record must say ``ok``, keep the
    reference's keys, and hold ``DRYRUN_WANT``, the JAX package's
    analytic figures for its pair."""
    from repro_torch.launch.mesh import HW

    out = _child_output(proc, DRYRUN_TIMEOUT_S, "dry run")
    arch, shape = DRYRUN_PAIR
    with open(out_dir / f"{arch}_{shape}_pod1_baseline.json") as f:
        rec = json.load(f)
    flops, nbytes = (DRYRUN_WANT["flops_per_device"],
                     DRYRUN_WANT["bytes_per_device"])
    want = {"flops_per_device": flops, "bytes_per_device": nbytes,
            "compute_s": flops / HW["peak_flops_bf16"],
            "memory_s": nbytes / HW["hbm_bw"]}
    if rec["status"] != "ok" or rec["analytic"] != want or \
            rec["memory_model"]["total"] != DRYRUN_WANT["memory_total"] or \
            rec["collectives"] != {} or rec["memory"]["temp_bytes"] is not \
            None or not rec["cost"]["flops_per_device"] > 0:
        raise AssertionError(f"dry run record {rec.get('status')}: "
                             f"analytic {rec.get('analytic')} against "
                             f"{want}, memory model "
                             f"{rec.get('memory_model')}")
    shutil.rmtree(out_dir, ignore_errors=True)
    cost = rec["cost"]
    print(f"dry run (a child on the CPU, CUDA never initialised): "
          f"{out.strip()}; its analytic and memory-model figures equal the "
          f"JAX package's models; eager count "
          f"{cost['flops_per_device']:.4e} FLOPs, "
          f"{cost['bytes_per_device']:.4e} bytes a device "
          f"({rec['cost_view']})")


def _child_output(proc, timeout: int, what: str) -> str:
    """Wait for a child of this phase; it must exit 0. Returns its
    output."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} over {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"{what} exit {proc.returncode}: {out[-2000:]}")
    return out


def _port_costs_start():
    """``_port_costs_child`` in a child process on the host's CPU,
    started at once so that it runs while the card works."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke._port_costs_child()"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _port_costs_child() -> None:
    """Print, as one JSON list, the port's own count of each
    ``STEP_RUNS`` step at its cut shape: ``steps.trace_pair`` (the step
    on meta tensors under ``eager_cost``) on a one-device mesh. CUDA is
    never initialised."""
    from repro_torch.configs.base import INPUT_SHAPES, InputShape, MeshConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_mesh, make_rules

    mesh = make_mesh(MeshConfig(data_axis=1, model_axis=1))
    rules = make_rules(mesh)
    costs = []
    for _, arch, shape_name, batch, seq, _ in STEP_RUNS:
        shape = InputShape(shape_name, seq, batch,
                           INPUT_SHAPES[shape_name].kind)
        cost, _ = steps_lib.trace_pair(get_config(arch), shape, mesh, rules)
        costs.append({"flops": cost["flops"],
                      "bytes": cost["bytes accessed"]})
    if torch.cuda.is_initialized():
        raise AssertionError("the meta traces initialised CUDA")
    print(json.dumps(costs))


def phase_steps(vk, lk, fk, dk, dev):
    """Phase 26: ``launch.steps.build_steps`` under ``Rules`` on a
    one-device mesh, at full width and depth from seed 0 (each arch drawn
    once and shared by its steps), for the (step, arch, shape) pairs of
    ``STEP_RUNS`` at their assigned shapes, cut only where stated. Each
    step: a warm-up call and a timed one (stream ms between CUDA events),
    its own peak, the port's own count and the JAX package's TPU model at
    one device and the memory model beside it (``_step_roofline``); the
    kernels counted over both calls (zeroed just before, read just after)
    against the run's ``want``; outputs finite; the serve steps' value and
    policy logits and the prefill logits held to the plain route
    (``impl='ref'``) at ``LOGITS_RTOL``, on the same inputs (stablelm's
    prefill at ``PREFILL_PLAIN_S``, where the plain route's dense scores
    fit). Then every kernel shape the steps launched at, held to its plain
    version (K2 as phase 4 holds it; K3-K5 timed too,
    ``_phase26_shapes``). Two children run on the CPU meanwhile: the
    port's meta traces of the steps (``_port_costs_child``) and the dry
    run (``DRYRUN_PAIR``, its record held to ``DRYRUN_WANT``); both are
    stopped if the phase fails. Returns (launches, the worst errors of
    K2, K3, K4 and K5)."""
    dry_dir = ROOT / "build" / "chip_smoke_dryrun"
    dry = _dryrun_start(dry_dir)
    counted = _port_costs_start()
    try:
        return _steps_on_card(vk, lk, fk, dk, dev, dry, dry_dir, counted)
    finally:
        for proc in (dry, counted):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _steps_on_card(vk, lk, fk, dk, dev, dry, dry_dir, counted):
    """``phase_steps``' work, while its two children run."""
    from repro_torch import params as params_lib
    from repro_torch.configs.base import INPUT_SHAPES, InputShape, MeshConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import actor as actor_lib
    from repro_torch.core.driver import init_params
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.models import backbone as bb

    rows = []
    card = _card_line()
    kernels = _kernel_fns(vk, lk, fk, dk)
    rules = make_rules(make_mesh(MeshConfig(data_axis=1, model_axis=1)))
    na = steps_lib.NUM_ACTIONS
    total = {name: 0 for name in kernels}
    shapes = {"linear_scan": set(), "flash_attention": set(),
              "decode_attention": set()}
    for name in shapes:
        kernels[name].shapes.clear()
    k2_before = set(vk.loss_vtrace.shapes)
    params = built = None
    for kind, arch, shape_name, batch, seq, want1 in STEP_RUNS:
        cfg = get_config(arch)
        if built != arch:
            params = steps = None
            torch.cuda.empty_cache()
            params = init_params(cfg, na, 0, dev)
            steps = steps_lib.build_steps(cfg, rules)
            built = arch
        full = INPUT_SHAPES[shape_name]
        shape = InputShape(shape_name, seq, batch, full.kind)
        what = (f"phase 26 {kind} {arch} {shape_name} (B, S) = "
                f"({batch}, {seq}), cut: {_cut_text(full, batch, seq)}")
        gen = torch.Generator(device=dev).manual_seed(26)
        want = {name: 2 * want1.get(name, 0) for name in kernels}
        if kind == "serve":
            length = steps_lib.decode_cache_len(cfg, seq)
            cache = _normal_tree(bb.cache_init(batch, length, cfg, dev),
                                 gen)
            token = torch.randint(0, cfg.vocab_size, (batch, 1),
                                  generator=gen, device=dev)
            index = seq - 1
            draw = torch.Generator(device=dev).manual_seed(27)
            # a step updates the recurrent and SSM states in place: the
            # plain route needs the timed call's own input state
            keep = cfg.family in ("ssm", "hybrid")
            out, ms, peak, got, before = _timed_step(
                kernels, lambda: steps["serve"](params, token, cache,
                                                index, draw),
                (lambda: params_lib.copy(cache)) if keep else None)
            with torch.no_grad():
                ref = bb.apply_decode(params, token,
                                      before if keep else cache, index, cfg,
                                      na, impl="ref")
            logits = ref.policy_logits[:, 0]
            # the value and the logits are linear reads (0.01-scaled) of
            # one final hidden state; a lone value can cancel to near 0,
            # so it is held against the two heads' largest output
            heads = max(float(logits.abs().max()),
                        float(ref.values.abs().max()))
            rv = _rel_check(f"{what} value", out["value"], ref.values[:, 0],
                            heads)
            # the logits themselves, at their own largest magnitude (the
            # log-probs of ~1e-2 logits all sit near -log 18, where a 5%
            # bar could not see a wrong hidden state)
            rl = _rel_check(f"{what} policy logits", out["policy_logits"],
                            logits)
            l2 = float((out["policy_logits"].float() - logits.float()).norm()
                       / logits.float().norm())
            blp = actor_lib.action_logprob(out["policy_logits"],
                                           out["action"])
            if not float((out["behaviour_logprob"] - blp).abs().max()) \
                    <= 1e-6:
                raise AssertionError(f"{what}: behaviour log-prob is not "
                                     f"the drawn action's under its logits")
            check = (f"value within {100 * rv:.3f}% of the heads' largest "
                     f"output, policy logits within {100 * rl:.3f}% of "
                     f"their largest (relative L2 {100 * l2:.3f}%), "
                     f"against the plain route; behaviour log-prob the "
                     f"drawn action's")
            del cache, before, ref, out
        elif kind == "prefill":
            toks = torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=gen, device=dev)
            out, ms, peak, got, _ = _timed_step(
                kernels, lambda: steps["prefill"](params, {"tokens": toks}))
            logits = out["policy_logits"]
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{what}: logits not finite")
            del out
            plain_s = PREFILL_PLAIN_S.get(arch, seq)
            cut = toks[:, :plain_s]
            if plain_s < seq:
                # the kernel route again at the plain route's length
                _zero_counts(kernels)
                logits = steps["prefill"](params, {"tokens": cut})[
                    "policy_logits"]
                for name, fn in kernels.items():
                    total[name] += fn.launches
            with torch.no_grad():
                ref = bb.apply_prefill(params, {"tokens": cut}, cfg, na,
                                       impl="ref")
            rl = _rel_check(f"{what} logits", logits, ref.policy_logits)
            check = (f"logits within {100 * rl:.3f}% of the plain route"
                     + (f" at S = {plain_s} (its dense f32 scores at "
                        f"{seq} would be {32 * seq * seq * 4 / 1e9:.0f} GB "
                        f"a layer)" if plain_s < seq else ""))
            del logits, ref
        else:
            data = _stub_batch(cfg, batch, seq - 1, na, dev)
            opt_state = steps["optimizer"].init(params)
            out, ms, peak, got, _ = _timed_step(
                kernels, lambda: steps["train"](params, opt_state, 0, data))
            loss = float(out[2]["loss/total"])
            if not math.isfinite(loss):
                raise AssertionError(f"{what}: loss {loss}")
            check = f"loss {loss:.4f} finite"
            del out, opt_state, data
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want} "
                                 f"(a warm-up call and a timed one)")
        for name in total:
            total[name] += got[name]
        print(f"{what}: launches over the two calls "
              f"{ {k: v for k, v in got.items() if v} or 'none'}; {check}")
        rows.append((what, cfg, shape, ms, peak))
    for name in shapes:
        shapes[name] |= kernels[name].shapes
        PATH_SHAPES[name] |= kernels[name].shapes
    del params, steps
    torch.cuda.empty_cache()
    k2_new = sorted(vk.loss_vtrace.shapes - k2_before - set(K2_SHAPES))
    print(f"phase 26 K2 shapes not held before, checked now: {k2_new}")
    err_k2 = phase_k2(vk, dev, k2_new)
    errs = _phase26_shapes(lk, fk, dk, dev, shapes, card)
    costs = json.loads(_child_output(counted, PORT_COSTS_TIMEOUT_S,
                                     "the port's meta traces")
                       .strip().splitlines()[-1])
    for (what, cfg, shape, ms, peak), port in zip(rows, costs, strict=True):
        _step_roofline(what, cfg, shape, rules, ms, peak, port, card)
    _dryrun_finish(dry, dry_dir)
    return total, (err_k2,) + errs


# ---------------------------------------------------------------------------
# slice 18: the SPMD learner and expert parallelism


def _spmd_setup():
    """Phase 27a's model and data: impala-shallow on catch at full width,
    the CLI's learner settings, and ``SPMD_ROUNDS`` rounds of two shards
    of ``MAIN_B`` envs x ``MAIN_T`` steps, drawn on the CPU from seed 27
    (the same numbers in every process)."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.envs import make_env

    env = make_env("catch")
    arch = get_config("impala-shallow").replace(image_hw=env.image_hw)
    na = env.num_actions
    icfg = ImpalaConfig(num_actions=na, unroll_length=MAIN_T,
                        learning_rate=6e-4, entropy_cost=0.003,
                        rmsprop_eps=0.01)
    gen = torch.Generator().manual_seed(27)
    b, t = MAIN_B, MAIN_T

    def shard():
        actions = torch.randint(0, na, (b, t), generator=gen)
        done = torch.rand((b, t), generator=gen) < 0.1
        rew = torch.randint(-1, 2, (b, t + 1), generator=gen).float()
        return {
            "obs_image": (torch.rand((b, t + 1) + env.image_hw,
                                     generator=gen) < 0.1).to(torch.uint8)
            * 255,
            "last_action": torch.cat([torch.zeros(b, 1, dtype=torch.int64),
                                      actions], 1),
            "last_reward": rew,
            "done_in": torch.cat([torch.zeros(b, 1, dtype=torch.bool),
                                  done], 1),
            "actions": actions,
            "rewards": rew[:, 1:].contiguous(),
            "discounts": 0.99 * (~done).float(),
            "behaviour_logprob": torch.log(
                torch.rand((b, t), generator=gen) * 0.4 + 0.2),
            "done": done,
            "lstm_state": tuple(
                torch.randn((b, arch.lstm_width), generator=gen) * 0.3
                for _ in range(2)),
        }
    rounds = [[shard(), shard()] for _ in range(SPMD_ROUNDS)]
    return arch, icfg, na, rounds


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_on(v, dev) for v in tree)
    return tree.to(dev)


def _spmd_oracle(dev):
    """Phase 27a's one-rank routes, in this process: the split route
    (``grad_step`` on each shard, their mean, ``apply_step``) on distinct
    shards, and the fused step on the first shard (what duplicated shards
    must give). Returns both final trees in the JAX layout."""
    from repro_torch import params as params_lib
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.driver import init_params

    arch, icfg, na, rounds = _spmd_setup()
    grad_step, apply_step, opt = learner_lib.build_grad_apply_steps(
        arch, icfg, na)
    p = init_params(arch, na, 0, dev)
    o = opt.init(p)
    for i, shards in enumerate(rounds):
        g0, g1 = (grad_step(p, _on(x, dev))[0] for x in shards)
        apply_step(p, o, i, [(a + b) / 2 for a, b in zip(g0, g1)])
    fused, fopt = learner_lib.build_train_step(arch, icfg, na)
    q = init_params(arch, na, 0, dev)
    qo = fopt.init(q)
    for i, shards in enumerate(rounds):
        fused(q, qo, i, _on(shards[0], dev))
    torch.cuda.synchronize()
    return params_lib.to_jax(p), params_lib.to_jax(q)


def _pair_spmd(rank: int, vk, dev):
    """Phase 27a on one rank of the pair: ``build_spmd_train_step`` over
    the pair's ``('data',)`` mesh (both ranks on the one card, over gloo),
    ``SPMD_ROUNDS`` rounds from the seed-0 params, this rank's shard
    (distinct), then the first shard on both (duplicated). K2 counted over
    exactly the rounds."""
    from repro_torch import params as params_lib
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.driver import init_params
    from repro_torch.launch.mesh import Mesh

    arch, icfg, na, rounds = _spmd_setup()
    mesh = Mesh(("data",), (2,))
    mesh.device_mesh("cuda")
    out = {}
    for name in ("distinct", "duplicated"):
        step, opt = learner_lib.build_spmd_train_step(arch, icfg, na, mesh)
        p = init_params(arch, na, 0, dev)
        o = opt.init(p)
        batches = [_on(x[rank if name == "distinct" else 0], dev)
                   for x in rounds]
        torch.cuda.synchronize()
        vk.reset_launch_counts()
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            p, o, m = step(p, o, i, batch)
        torch.cuda.synchronize()
        out[name] = {"params": params_lib.to_jax(p),
                     "k2": vk.loss_vtrace.launches,
                     "ms": (time.perf_counter() - t0) * 1e3 / len(batches),
                     "loss": float(m["loss/total"])}
    return out


def _pair_experts(rank: int, fk, dk, dev, job):
    """Phase 27c on one rank of the pair: olmoe-1b-7b at its published
    widths and all its layers, ``dispatch_impl='shard_map_a2a'`` under
    ``Rules`` on the pair's ``(1, 2)`` ``("data", "model")`` mesh. The
    weights are drawn leaf by leaf on the card from the server's seed,
    each expert leaf cut to this rank's 32 experts as it is drawn
    (``moe.rank_expert_keep``); then phase 23b's first batch: its prefill
    and ``NEW_SERVE_STEPS`` decode steps fed its sampled actions, K4 and
    K5 counted over exactly them, the logits held to 23b's one-device
    route at ``LOGITS_RTOL``; then each MoE layer's update as
    ``phase_moe_layers`` holds it."""
    import contextlib
    import dataclasses
    import io

    from repro_torch import params as params_lib
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import backbone as bb
    from repro_torch.models import common
    from repro_torch.models import moe as moe_lib
    from repro_torch.sharding.rules import Rules, use_rules

    cfg = get_config(MOE_SPLIT)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              dispatch_impl="shard_map_a2a"))
    mesh = Mesh(("data", "model"), (1, 2))
    coord = mesh.device_mesh("cuda").get_local_rank("model")
    rules = Rules(mesh)
    na = job["num_actions"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = params_lib.from_jax(common.init_params(
        bb.backbone_specs(cfg, na), 0, dev,
        keep=moe_lib.rank_expert_keep(rules, coord)), dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    draw_peak = torch.cuda.max_memory_allocated()
    n_held = sum(x.numel() for x in params_lib.tree_leaves(params))
    toks = torch.from_numpy(job["tokens"]).to(dev)
    actions = [torch.from_numpy(a).to(dev) for a in job["actions"]]
    ctx = toks.shape[1]
    fk.flash_attention.launches = 0
    dk.decode_attention.launches = 0
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(actions) + 2)]
    with use_rules(rules), torch.no_grad():
        marks[0].record()
        out = bb.apply_prefill(params, {"tokens": toks}, cfg, na)
        marks[1].record()
        logits, cache, tok = [out.policy_logits], out.cache, toks[:, -1:]
        for i, action in enumerate(actions):
            out = bb.apply_decode(params, tok, cache, ctx + i, cfg, na)
            marks[i + 2].record()
            cache = out.cache
            logits.append(out.policy_logits)
            tok = action % cfg.vocab_size
    torch.cuda.synchronize()
    launches = (fk.flash_attention.launches, dk.decode_attention.launches)
    errs = []
    for i, (got, want) in enumerate(zip(logits, job["logits"],
                                        strict=True)):
        want = torch.from_numpy(want).to(dev)
        if tuple(got.shape) != tuple(want.shape) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"27c rank {rank} step {i}: logits "
                                 f"{tuple(got.shape)}, finite "
                                 f"{bool(torch.isfinite(got).all())}")
        errs.append(float((got.float() - want).abs().max())
                    / float(want.abs().max()))
    if not max(errs) <= LOGITS_RTOL:
        raise AssertionError(f"27c rank {rank}: logits against phase 23b's "
                             f"one-device route, max abs err over max "
                             f"|logit| {errs} > {LOGITS_RTOL}")
    run = types.SimpleNamespace(arch=cfg, params=params,
                                first_batch={"tokens": toks})
    sink = io.StringIO()
    with use_rules(rules), contextlib.redirect_stdout(
            sys.stdout if rank == 0 else sink):
        layers = phase_moe_layers(run)
    return {"coord": coord, "launches": launches, "errs": errs,
            "layers": layers, "draw_s": draw_s, "held": held,
            "draw_peak": draw_peak, "n_held": n_held,
            "peak": torch.cuda.max_memory_allocated(),
            "prefill_ms": marks[0].elapsed_time(marks[1]),
            "decode_ms": [a.elapsed_time(b)
                          for a, b in zip(marks[1:], marks[2:])],
            "logits0": logits[0].float().cpu().numpy()}


def _pair_rank(rank: int, addr: str, job, conn) -> None:
    """One rank of phase 27's pair (spawned): the gloo group of two on the
    one card, 27a, then 27c; the results, or the traceback, up its pipe."""
    import datetime
    import traceback

    status = 1
    try:
        import torch.distributed as dist

        from repro_torch.kernels import build
        from repro_torch.kernels import decode_attention as dk
        from repro_torch.kernels import flash_attention as fk
        from repro_torch.kernels import vtrace as vk

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        build.load()                    # built by the parent
        t0 = time.perf_counter()
        dist.init_process_group("gloo", init_method=addr, world_size=2,
                                rank=rank, timeout=datetime.timedelta(
                                    seconds=PAIR_TIMEOUT_S))
        out = {"up_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        out["a"] = _pair_spmd(rank, vk, dev)
        out["a_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["c"] = _pair_experts(rank, fk, dk, dev, job)
        out["c_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
        conn.send(("ok", out))
        status = 0
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
    finally:
        conn.close()
        sys.stdout.flush()
        sys.stderr.flush()
    os._exit(status)


def _rel_tree(got, want) -> float:
    """max |got - want| over max |want|, over every leaf of two JAX-layout
    trees."""
    from repro_torch import params as params_lib

    g, w = params_lib.flatten(got), params_lib.flatten(want)
    if sorted(g) != sorted(w):
        raise AssertionError(f"trees differ: {sorted(set(g) ^ set(w))}")
    err = max(float(abs(g[k] - w[k]).max()) for k in w)
    scale = max(float(abs(w[k]).max()) for k in w)
    return err / scale


def phase_spmd(vk, fk, dk, dev):
    """Phase 27: the SPMD learner and expert parallelism. One pair of
    ranks is spawned for 27a and 27c (``_pair_rank``); while they start,
    this process runs 27b, the CLI's SPMD learner (one NCCL rank, the
    JAX CLI's defaults, ``ASYNC_STEPS`` updates, K2 counted over exactly
    the run), and 27a's one-rank routes (``_spmd_oracle``). Returns the
    launches of K2, K4 and K5 on these paths."""
    import multiprocessing as mp

    from repro_torch.distributed.spmd import free_port
    from repro_torch.launch import train as train_lib

    if not SAVED_SERVE:
        raise AssertionError("phase 27c needs phase 23b's first batch")
    t_all = time.perf_counter()
    ctx = mp.get_context("spawn")
    addr = f"tcp://127.0.0.1:{free_port()}"
    # numpy both ways: a tensor crosses a pipe as a shared-memory handle
    # that its sender must outlive
    job = {"tokens": SAVED_SERVE["tokens"].numpy(),
           "actions": [a.numpy() for a in SAVED_SERVE["actions"]],
           "logits": [lg.numpy() for lg in SAVED_SERVE["logits"]],
           "num_actions": SAVED_SERVE["num_actions"]}
    conns, procs = [], []
    for r in range(2):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_pair_rank, args=(r, addr, job, child),
                           name=f"pair-rank-{r}", daemon=True)
        proc.start()
        child.close()
        conns.append(parent)
        procs.append(proc)
    try:
        # 27b, while the pair starts
        t0 = time.perf_counter()
        vk.reset_launch_counts()
        run = train_lib.train(SPMD_ARGV)
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        k2_cli = vk.loss_vtrace.launches
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(_WORKER_THREADS)]
        tel = run.telemetry
        want = {"num_learners": 1, "publisher": 0,
                "exchange_backend": "collective", "spmd_devices": 1,
                "rounds": ASYNC_STEPS}
        if tel.get("group") != want or alive or \
                tel["learner_updates"] != ASYNC_STEPS or \
                k2_cli != ASYNC_STEPS or vk.vtrace.launches:
            raise AssertionError(
                f"27b {' '.join(SPMD_ARGV)}: group {tel.get('group')} "
                f"(expected {want}), updates {tel['learner_updates']}, K2 "
                f"{k2_cli}, K1 {vk.vtrace.launches}, threads alive {alive}")
        ex = tel["exchange"]
        print(f"27b SPMD learner through the CLI (one NCCL rank): "
              f"{ASYNC_STEPS} updates, K2 {k2_cli}, group {tel['group']}, "
              f"round ms mean {ex['round_ms_mean']:.3f}, learner frames/s "
              f"{tel['frames_per_sec']:.0f}, {b_s:.1f} s")
        del run
        # 27a's one-rank routes
        t0 = time.perf_counter()
        split, fused = _spmd_oracle(dev)
        o_s = time.perf_counter() - t0
        results = {}
        for r, conn in enumerate(conns):
            if not conn.poll(PAIR_TIMEOUT_S):
                raise AssertionError(f"phase 27 rank {r}: no result in "
                                     f"{PAIR_TIMEOUT_S} s")
            status, got = conn.recv()
            if status != "ok":
                raise AssertionError(f"phase 27 rank {r} failed:\n{got}")
            results[r] = got
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.exitcode is None:
                proc.kill()
                proc.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase 27 ranks exit codes "
                             f"{[p.exitcode for p in procs]}")
    _no_actor_threads("phase 27")
    card = _card_line()
    k2 = 0
    for r, got in sorted(results.items()):
        for name, want in (("distinct", split), ("duplicated", fused)):
            a = got["a"][name]
            rel = _rel_tree(a["params"], want)
            if not rel <= SPMD_BAR or a["k2"] != SPMD_ROUNDS:
                raise AssertionError(
                    f"27a rank {r} {name}: params {rel:.3e} of their "
                    f"largest magnitude off the one-rank route (bar "
                    f"{SPMD_BAR}), K2 {a['k2']} (expected {SPMD_ROUNDS})")
            k2 += a["k2"]
            print(f"27a SPMD step, impala-shallow at full width, rank {r} "
                  f"of 2 (gloo, one card), {name} shards of {MAIN_B} x "
                  f"{MAIN_T}: after {SPMD_ROUNDS} rounds max |dp| "
                  f"{rel:.3e} of max |p| against "
                  + ("the split route's mean" if name == "distinct"
                     else "the fused step on one shard")
                  + f" (bar {SPMD_BAR}); K2 {a['k2']}; "
                  f"{a['ms']:.3f} ms a round; loss {a['loss']:.4f}")
    layers = SAVED_SERVE["layers"]
    k4 = k5 = 0
    logits = [got["c"]["logits0"] for got in results.values()]
    if not (logits[0] == logits[1]).all():
        raise AssertionError("27c: the two ranks' prefill logits differ")
    for r, got in sorted(results.items()):
        c = got["c"]
        want = (layers, layers * NEW_SERVE_STEPS)
        if c["launches"] != want:
            raise AssertionError(f"27c rank {r}: (K4, K5) launches "
                                 f"{c['launches']}, expected {want}")
        k4, k5 = k4 + c["launches"][0], k5 + c["launches"][1]
        med = sorted(c["decode_ms"])[len(c["decode_ms"]) // 2]
        print(f"27c {MOE_SPLIT} expert-parallel, rank {r} (experts "
              f"{32 * c['coord']}-{32 * c['coord'] + 31} of 64), "
              f"{c['n_held']:,} parameters held ({c['held'] / 1e9:.2f} GB "
              f"f32; drawn leaf by leaf in {c['draw_s']:.2f} s, peak "
              f"{c['draw_peak'] / 1e9:.2f} GB while drawing, "
              f"{c['peak'] / 1e9:.2f} GB in all); K4 {c['launches'][0]} K5 "
              f"{c['launches'][1]}; logits against phase 23b's one-device "
              f"route: worst {100 * max(c['errs']):.3f}% of the step's max "
              f"|logit| (bar {100 * LOGITS_RTOL:.0f}%); MoE layers worst "
              f"{100 * c['layers'][0]:.3f}%, {c['layers'][1]} token-layers "
              f"routed differently; prefill {c['prefill_ms']:.3f} ms, "
              f"decode step {med:.3f} ms (median of "
              f"{len(c['decode_ms'])})")
    laps = {r: (g["up_s"], g["a_s"], g["c_s"]) for r, g in results.items()}
    print(f"phase 27 laps: 27b {b_s:.1f} s and the one-rank routes "
          f"{o_s:.1f} s in this process; ranks (group up, 27a, 27c) s "
          + ", ".join(f"{r}: " + "/".join(f"{x:.1f}" for x in v)
                      for r, v in laps.items())
          + f"; {time.perf_counter() - t_all:.1f} s in all; {card}")
    return {"loss_vtrace": k2_cli + k2, "flash_attention": k4,
            "decode_attention": k5}


class _Laps:
    """Prints each group of phases' wall time and the run's so far."""

    def __init__(self):
        self.t0 = self.last = time.time()

    def __call__(self, phases: str) -> None:
        now = time.time()
        print(f"[phases {phases}: {now - self.last:.1f} s; "
              f"{now - self.t0:.1f} s since phase 2a]")
        self.last = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import linear_scan as lk
    from repro_torch.kernels import vtrace as vk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; TF32 off for cuDNN convs and "
          f"cuBLAS matmuls in every phase")

    t0 = time.time()
    path, log = build.build()
    build.load()
    print(f"build: {time.time() - t0:.2f} s -> {path.relative_to(ROOT)}")
    for line in log.splitlines():
        # the registers of every kernel, and any wgmma that ptxas
        # had to serialise (its C75xx "Performance Loss" notes)
        if "ptxas info" in line and ("Used" in line or "Compiling" in line
                                     or "Performance Loss" in line):
            print(f"  {line.strip()}")

    lap = _Laps()
    phase_device_times(vk, fk, dk, lk, dev)
    lap("2a")
    err_k1 = phase_k1(vk, dev)
    err_k2 = phase_k2(vk, dev)
    vk.vtrace.shapes.clear()
    vk.loss_vtrace.shapes.clear()
    lap("3-4")
    launches, run = phase_main(vk, dev)
    phase_bandit()
    lap("5-6")
    async_launches, async_before, async_busy = phase_async(vk, dev)
    lap("6a")
    launches["loss_vtrace"] += phase_flight_recorder(vk, async_before,
                                                     async_busy)
    launches["loss_vtrace"] += phase_traced_process(vk)
    lap("6w-6x")
    replay_launches, _ = phase_async_replay(vk, dev)
    lap("6c")
    # each kernel's launches over every path that runs it
    launches["loss_vtrace"] += async_launches["loss_vtrace"]
    launches["vtrace"] += replay_launches["vtrace"]
    phase_async_bar(dev)
    lap("6b")
    phase_replay_bar(dev)
    lap("6d")
    launches["loss_vtrace"] += phase_sync_replay(vk)
    phase_checkpoints(dev)
    phase_envs(dev)
    lap("6e-6g")
    launches["loss_vtrace"] += phase_chase_sync(vk, run.fps)
    chase_launches, _ = phase_async_replay(
        vk, dev, CHASE_REPLAY_ARGV, CHASE_ASYNC_STEPS, "chase async replay")
    launches["vtrace"] += chase_launches["vtrace"]
    lap("6h-6i")
    infer_launches, infer_fps = phase_inference(vk, dev, async_before)
    launches["loss_vtrace"] += infer_launches
    lap("6j")
    phase_inference_bar(dev)
    lap("6k")
    launches["loss_vtrace"] += phase_process(vk, dev, async_before)
    launches["loss_vtrace"] += phase_process_inference(vk, dev,
                                                       infer_fps)
    lap("6n-6o")
    phase_process_bar(dev)
    lap("6p")
    launches["loss_vtrace"] += phase_remote(vk, dev)
    lap("6q")
    launches["loss_vtrace"] += phase_multitask(vk, dev)
    launches["loss_vtrace"] += phase_pbt(vk, dev)
    lap("6l-6m")
    launches["loss_vtrace"] += phase_group(vk, dev, async_before)
    lap("6r")
    launches["vtrace"] += phase_group_process(vk, dev)
    lap("6s-6t")
    group_ckpt = ROOT / "build" / "chip_smoke_group_ckpt"
    shutil.rmtree(group_ckpt, ignore_errors=True)
    try:
        bar_launches, saved = phase_group_bar(vk, dev, str(group_ckpt))
        launches["loss_vtrace"] += bar_launches
        lap("6u")
        launches["loss_vtrace"] += phase_group_resume(vk, dev,
                                                      str(group_ckpt), saved)
    finally:
        shutil.rmtree(group_ckpt, ignore_errors=True)
    lap("6v")
    launches["loss_vtrace"] += phase_supervised_thread(vk, async_before)
    lap("6y (a)")
    launches["loss_vtrace"] += phase_supervised_child(
        vk, "supervised process actors", SUP_PROC_ARGV, "actor-proc-0",
        wait=True)
    lap("6y (b)")
    launches["loss_vtrace"] += phase_supervised_child(
        vk, "supervised remote actors", SUP_REMOTE_ARGV, "actor-remote-0",
        wait=False)
    lap("6y (c)")
    launches["loss_vtrace"] += phase_supervised_spoke(vk, dev)
    lap("6z (d)")
    launches["loss_vtrace"] += phase_supervised_hub(vk, dev)
    lap("6z (e)")
    phase_split(run, dev)
    k1_err, k2_err = phase_path_shapes(vk, dev)
    err_k1, err_k2 = max(err_k1, k1_err), max(err_k2, k2_err)
    rows = phase_times(vk, dev)
    del run
    lap("7-8")

    err_k4 = phase_k4(fk, dev)
    err_k5 = phase_k5(dk, dev)
    lap("9-10")
    serve_launches, serve_run = phase_serve(lk, fk, dk)
    launches.update(serve_launches)
    phase_serve_logits(serve_run)
    phase_serve_split(serve_run, "decode_attention", SERVE_LAYERS)
    del serve_run                     # the 46 GB of weights
    torch.cuda.empty_cache()
    lap("11-13")
    rows.update(phase_attn_times(fk, dk, dev))
    lap("14")

    err_k3 = phase_k3(lk, dev)
    lap("15")
    ssm_launches, ssm_run = phase_serve_ssm(lk, fk, dk)
    launches["linear_scan"] += ssm_launches["linear_scan"]
    phase_serve_logits(ssm_run)
    phase_prefill_split(ssm_run)
    phase_serve_split(ssm_run)
    del ssm_run
    torch.cuda.empty_cache()
    lap("16-18")
    rows.update(phase_scan_times(lk, dev))
    lap("19")

    for n, (arch, ctx, layers, params, want) in enumerate(NEW_SERVES):
        got = phase_serve_config(lk, fk, dk, arch, ctx, layers, params,
                                 want)
        for name, count in got.items():
            launches[name] += count
        lap(f"{20 + n} ({arch})")
    for letter, (arch, ctx, layers, params, want) in zip("ab", MOE_SERVES):
        got = phase_serve_config(lk, fk, dk, arch, ctx, layers, params,
                                 want)
        for name, count in got.items():
            launches[name] += count
        lap(f"23{letter} ({arch})")
    for letter, (arch, layers, params, want) in zip("cd", CROSS_RUNS):
        got = phase_cross_config(lk, fk, dk, arch, layers, params, want)
        for name, count in got.items():
            launches[name] += count
        lap(f"23{letter} ({arch})")
    e3, e4, e5 = phase_serve_path_shapes(lk, fk, dk, dev)
    err_k3, err_k4, err_k5 = (max(err_k3, e3), max(err_k4, e4),
                              max(err_k5, e5))
    lap("24")

    train_launches, train_run, train_busy = phase_token_train(vk, lk, fk,
                                                              dk, dev)
    for name, count in train_launches.items():
        launches[name] += count
    lap("25")
    phase_train_routes(train_run)
    lap("25a")
    mixed = [phase_mixed_stablelm(vk, lk, fk, dk, train_run, train_busy)]
    del train_run
    torch.cuda.empty_cache()
    arch, layers, count = MIXED_WIDE
    mixed.append(phase_mixed_config(vk, lk, fk, dk, dev, arch, layers, count,
                                    0))
    mixed.append(phase_mixed_moves(vk, lk, fk, dk, dev, *MIXED_SCAN))
    mixed.append(phase_mixed_conv(vk, lk, fk, dk, dev))
    for got in mixed:
        for name, count in got.items():
            launches[name] += count
    lap("25d")
    for arch, layers, batch_b, want in TRAIN_FAMILIES:
        got = phase_train_family(vk, lk, fk, dk, dev, arch, layers, batch_b,
                                 want)
        for name, count in got.items():
            launches[name] += count
        lap(f"25b ({arch})")
    err_k5 = max(err_k5, phase_actor_k5(dk, dev))
    lap("25c")
    step_launches, (e2, e3, e4, e5) = phase_steps(vk, lk, fk, dk, dev)
    for name, count in step_launches.items():
        launches[name] += count
    err_k2, err_k3, err_k4, err_k5 = (max(err_k2, e2), max(err_k3, e3),
                                      max(err_k4, e4), max(err_k5, e5))
    lap("26")
    for name, count in phase_spmd(vk, fk, dk, dev).items():
        launches[name] += count
    lap("27")
    print(f"times above: {card}")

    meta = {
        "vtrace": ("src/repro_torch/csrc/vtrace.cu",
                   "src/repro/kernels/vtrace.py:74", err_k1),
        "loss_vtrace": ("src/repro_torch/csrc/vtrace.cu",
                        "src/repro/kernels/vtrace.py:165", err_k2),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:80",
                            err_k4),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:55",
                             err_k5),
        "linear_scan": ("src/repro_torch/csrc/linear_scan.cu",
                        "src/repro/kernels/linear_scan.py:38", err_k3),
    }
    kernels = []
    for name, (source, replaces, err) in meta.items():
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
