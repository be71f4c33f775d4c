"""The asynchronous actor-learner runtime (``repro.distributed.runtime``;
paper §3).

``run_async_training`` stands up N actor threads feeding a bounded
backpressured in-process ``Transport`` that one learner loop drains with
*dynamic batching*: up to ``max_batch_trajs`` queued trajectories are
stacked into one learner batch (§3.1's dynamic batching, applied
learner-side), so one update's fixed cost covers more frames. Batch sizes
are bucketed to powers of two; on the card each bucket gives K2 its own
shape, (T, B, A) = (unroll, k x num_envs, actions).

The learner loop is the ``Learner`` object (``distributed/learner.py``);
this module is the composition root for the single-learner shape: build
the env, the learner (params, train step, store), the transport and the
actor pool, attach them, run.

Parameters flow learner -> ``ParameterStore`` -> actors; each trajectory
comes back stamped with the parameter version it was acted with, so the
policy lag the learner observes is **measured** (``lag = version_now -
version_acted``), not scripted.

With ``actor_mode='inference'`` the actors hold no params at all: one
driver thread steps every actor's envs on the host and submits each
step's observations to one ``InferenceService`` next to the learner,
which runs the batched policy forward on the learner's device (paper
§3.1's dynamic batching, actor-side) and adds an ``inference`` section
to the telemetry.

``actor_backend`` picks where actors live: ``thread`` (this
interpreter, on the learner's device), ``process`` (spawned children on
the CPU, over the ``shm`` transport) or ``remote`` (children or other
machines dialing a TCP listen address, over the ``socket`` transport).
The learner and the inference service stay on the card whichever
backend acts.

``_setup`` is also what each worker of a learner group
(``distributed/group.py``) calls, with its shard of the actor slots
(``slot_base``), its id and its gradient exchange.

``obs`` (an ``ObsConfig``) runs the flight recorder around the loop: phase
timing, sampled trajectory traces, the ``torch.profiler`` window, the
``/metrics`` endpoint and the JSONL sink (``repro_torch.obs``).

Ported: the three actor backends in unroll and inference mode, the
three transports with their wire codecs, one learner or a group's
worker, replay, periodic fleet-v1 checkpoints, the flight recorder and
supervision (``supervise``: respawned actors, the socket transport's
heartbeat lease reaper and elastic membership, the supervisor's section
in the telemetry), and the SPMD learner (``spmd_devices``: one learner
process whose step runs on that many ranks of a ``torch.distributed``
group, ``distributed/spmd.py``).
"""
from __future__ import annotations

import os

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ImpalaConfig
from repro_torch.data.envs import make_env
from repro_torch.distributed.actor_pool import ActorPool
from repro_torch.distributed.inference import (InferenceService,
                                               _pow2_floor, require_cnn)
from repro_torch.distributed.learner import Learner, MultiTracker
from repro_torch.distributed.transport import make_transport

PyTree = Any

ACTOR_MODES = ("unroll", "inference")


def _validate(icfg, max_batch_trajs, actor_backend, actor_mode,
              transport, env_name, spmd_devices: int = 0,
              exchange=None) -> None:
    if not (0.0 <= icfg.replay_fraction < 1.0):
        raise ValueError(f"replay_fraction must be in [0, 1), got "
                         f"{icfg.replay_fraction}")
    if icfg.replay_fraction > 0:
        from repro_torch.core.replay import PRIORITY_MODES

        if icfg.replay_capacity < 1:
            raise ValueError(f"replay_capacity must be >= 1, got "
                             f"{icfg.replay_capacity}")
        if icfg.replay_reuse < 0:
            raise ValueError(f"replay_reuse must be >= 0 (0 = unlimited),"
                             f" got {icfg.replay_reuse}")
        if icfg.replay_priority not in PRIORITY_MODES:
            raise ValueError(f"replay_priority must be one of "
                             f"{PRIORITY_MODES}, got "
                             f"{icfg.replay_priority!r}")
        if icfg.replay_target_period < 1:
            raise ValueError(f"replay_target_period must be >= 1, got "
                             f"{icfg.replay_target_period}")
    if max_batch_trajs < 1:
        raise ValueError(f"max_batch_trajs must be >= 1, got "
                         f"{max_batch_trajs}")
    if actor_backend not in ("thread", "process", "remote"):
        raise ValueError(f"actor_backend must be 'thread', 'process' or "
                         f"'remote', got {actor_backend!r}")
    if actor_mode not in ACTOR_MODES:
        raise ValueError(f"actor_mode must be one of {ACTOR_MODES}, got "
                         f"{actor_mode!r}")
    if actor_backend == "process" and transport != "shm":
        raise ValueError("process actors cannot share live trees; use "
                         "transport='shm'")
    if actor_backend == "remote" and transport != "socket":
        raise ValueError("remote actors ship trajectories over TCP; use "
                         "transport='socket'")
    if transport == "socket" and actor_backend != "remote":
        raise ValueError("transport='socket' requires "
                         "actor_backend='remote'")
    if transport not in ("inproc", "shm", "socket"):
        raise ValueError(f"transport must be one of inproc/shm/socket, "
                         f"got {transport!r}")
    if spmd_devices:
        if spmd_devices < 1:
            raise ValueError(f"spmd_devices must be >= 1, got "
                             f"{spmd_devices}")
        if exchange is not None:
            raise ValueError("spmd_devices builds its own in-XLA "
                             "CollectiveExchange; it cannot combine "
                             "with a hub/spoke exchange (use a learner "
                             "group OR spmd, not both)")


def _setup(
    env_name,
    icfg: ImpalaConfig,
    num_envs: int,
    *,
    num_actors: int = 2,
    actor_backend: str = "thread",
    actor_mode: str = "unroll",
    transport: str = "inproc",
    queue_capacity: int = 8,
    queue_policy: str = "block",
    max_batch_trajs: int = 4,
    batch_linger_s: float = 0.0,
    seed: int = 0,
    arch: Optional[ArchConfig] = None,
    initial_params: Optional[PyTree] = None,
    initial_opt_state: Optional[PyTree] = None,
    start_step: int = 0,
    donate: bool = True,
    wire_codec: str = "none",
    vtrace_impl: str = "auto",
    spmd_devices: int = 0,
    infer_flush_timeout_s: float = 0.02,
    infer_max_batch_requests: Optional[int] = None,
    infer_streams: int = 1,
    listen_addr: Optional[Tuple[str, int]] = None,
    spawn_remote: bool = True,
    slot_base: int = 0,
    learner_id: int = 0,
    num_learners: int = 1,
    exchange=None,
    peer_addrs=None,
    obs=None,
    supervise: bool = False,
    supervisor=None,
    heartbeat_timeout_s: float = 10.0,
    elastic: bool = False,
    device="cuda",
) -> Learner:
    """Build one learner worker's dependency graph (env, params, train
    step, store, inference service, transport, actor pool) and return the
    assembled ``Learner``.

    ``run_async_training`` calls this with the defaults; a learner
    group's worker with its shard (``slot_base``/``num_actors``), its id,
    the group's size, its ``GradientExchange`` and, for remote actors,
    ``peer_addrs``: every learner's listen address, the shard map a full
    learner's refusal carries. Actor slot ids are global (``slot_base +
    i``), so an actor's RNG stream does not depend on how slots are
    sharded.

    ``obs`` (an ``ObsConfig``) turns on the learner's side of the flight
    recorder: phase timing, the trace recorder (with ``trace_path``) and
    the ``torch.profiler`` window (with ``profile_steps``).

    ``supervise`` (or a ``supervisor`` of the caller's, as a group worker
    passes) turns on supervision: the pools respawn dead actors, the
    socket transport reaps leases silent for ``heartbeat_timeout_s`` and,
    with ``elastic``, grows slots past ``num_actors``, and the
    supervisor's ledger joins the telemetry. Without it every fault
    propagates as before."""
    _validate(icfg, max_batch_trajs, actor_backend, actor_mode,
              transport, env_name, spmd_devices=spmd_devices,
              exchange=exchange)
    env = make_env(env_name) if isinstance(env_name, str) else env_name
    if arch is None:
        from repro_torch.core.driver import small_arch
        arch = small_arch(env)
    if actor_mode == "inference":
        require_cnn(arch)
    trace = profile = None
    phase_timing = False
    if obs is not None:
        phase_timing = True
        if obs.trace_path:
            from repro_torch.obs.trace import TraceRecorder
            trace = TraceRecorder()
        if obs.profile_steps:
            from repro_torch.obs.sink import ProfileHook
            profile = ProfileHook(obs.profile_steps, obs.profile_dir)
    if spmd_devices:
        # SPMD learner: the Learner sees a collective exchange and runs
        # its step on this many ranks (the mesh, its device check and the
        # group live in distributed/spmd.py and launch/mesh.py). The
        # exchange moves no byte: it numbers rounds and books latency.
        from repro_torch.distributed.group import CollectiveExchange
        exchange = CollectiveExchange(spmd_devices, trace=trace)
    learner = Learner(
        arch=arch, icfg=icfg, num_actions=env.num_actions,
        num_envs=num_envs, num_actors=num_actors, transport=None,
        seed=seed, learner_id=learner_id, num_learners=num_learners,
        slot_base=slot_base, actor_mode=actor_mode,
        max_batch_trajs=max_batch_trajs, batch_linger_s=batch_linger_s,
        donate=donate, start_step=start_step,
        initial_params=initial_params,
        initial_opt_state=initial_opt_state, exchange=exchange,
        wire_codec=wire_codec, vtrace_impl=vtrace_impl, trace=trace,
        phase_timing=phase_timing, profile=profile, device=device)
    if supervisor is None and supervise:
        from repro_torch.distributed.supervise import Supervisor
        supervisor = Supervisor()
    learner.supervisor = supervisor
    if supervisor is not None:
        learner.obs_registry.register_producer("supervisor",
                                               supervisor.snapshot)
    service = None
    if actor_mode == "inference":
        from repro_torch.core.replay import fold_replay_seed

        if actor_backend == "thread" or infer_streams < 1 or \
                num_envs % infer_streams:
            # one driver thread multiplexes thread actors; pipelining
            # needs an even env split
            infer_streams = 1
        # bucket = one request per *actor*: with pipelined streams the
        # other stream group stays pending, so its flush overlaps the
        # actors' env stepping
        service = InferenceService(
            env, arch, icfg, learner.store,
            num_clients=num_actors * infer_streams,
            flush_timeout_s=infer_flush_timeout_s,
            max_batch_requests=(infer_max_batch_requests or
                                _pow2_floor(num_actors)),
            seed=seed,
            # grouped: each learner's service samples from its own stream,
            # seeded by (seed, learner_id); alone: the plain seed
            rng_key=(fold_replay_seed(seed, learner_id)
                     if num_learners > 1 else None),
            registry=learner.obs_registry)
    # the transport's counters land in the registry the snapshot reads
    transport_kw: Dict[str, Any] = {"registry": learner.obs_registry}
    if transport in ("shm", "socket"):
        # inproc hands live trees between threads: nothing to encode
        transport_kw["wire_codec"] = wire_codec
    if transport == "socket":
        transport_kw.update({"listen": listen_addr or ("127.0.0.1", 0),
                             "max_actors": num_actors,
                             "slot_base": slot_base})
        if supervisor is not None:
            # heartbeat liveness, lease reaping and elastic membership
            # belong to the networked transport only
            transport_kw["heartbeat_timeout_s"] = heartbeat_timeout_s
            transport_kw["elastic"] = elastic
    queue = make_transport(transport, queue_capacity, queue_policy,
                           **transport_kw)
    if supervisor is not None and hasattr(queue, "supervisor"):
        queue.supervisor = supervisor
    learner.queue = queue
    env_name = env_name if isinstance(env_name, str) else env.name
    if actor_backend == "remote":
        from repro_torch.distributed.procpool import SocketActorPool
        if peer_addrs is not None:
            queue.peer_addrs = [tuple(a) for a in peer_addrs]
        pool = SocketActorPool(
            env_name, arch, icfg, num_envs, num_actors, learner.store,
            queue, seed=seed, service=service, infer_streams=infer_streams,
            spawn_local=spawn_remote, slot_base=slot_base)
        if not spawn_remote:
            host, port = queue.address
            print(f"learner listening on {host}:{port} — waiting for "
                  f"{num_actors} remote actor(s): "
                  f"PYTHONPATH=src python -m repro_torch.launch.train "
                  f"--connect {host}:{port}", flush=True)
    elif actor_backend == "process":
        from repro_torch.distributed.procpool import ProcessActorPool
        pool = ProcessActorPool(
            env_name, arch, icfg, num_envs, num_actors, learner.store,
            queue, seed=seed, service=service, infer_streams=infer_streams,
            slot_base=slot_base)
    else:
        pool = ActorPool(env, arch, icfg, num_envs, num_actors,
                         learner.store, queue, seed=seed, service=service,
                         slot_base=slot_base, device=learner.device)
    if supervisor is not None:
        pool.attach_supervisor(supervisor)
    learner.attach(pool, service)
    return learner


def fleet_checkpointer(ckpt_dir: str, supervisor=None) -> Callable:
    """``Learner.run``'s ``on_checkpoint`` for ``ckpt_dir``: it saves the
    combined tree ``{"params", "opt"}`` with ``extra={"version",
    "format": "fleet-v1"}``, so a resumed run restores the optimizer
    moments and continues the version stream. Supervised, ``extra`` also
    holds the supervisor's ``restart_epochs``."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    def on_ckpt(step, params, opt_state, version):
        extra = {"version": int(version), "format": "fleet-v1"}
        if supervisor is not None:
            extra["restart_epochs"] = supervisor.restart_epochs()
        ckpt_lib.save(ckpt_dir, step, {"params": params, "opt": opt_state},
                      extra=extra)
    return on_ckpt


def run_async_training(
    env_name,
    icfg: ImpalaConfig,
    num_envs: int,
    steps: int,
    *,
    num_actors: int = 2,
    actor_backend: str = "thread",
    actor_mode: str = "unroll",
    transport: str = "inproc",
    listen_addr: Optional[Tuple[str, int]] = None,
    spawn_remote: bool = True,
    queue_capacity: int = 8,
    queue_policy: str = "block",
    max_batch_trajs: int = 4,
    batch_linger_s: float = 0.0,
    seed: int = 0,
    arch: Optional[ArchConfig] = None,
    warm_buckets: bool = False,
    initial_params: Optional[PyTree] = None,
    initial_opt_state: Optional[PyTree] = None,
    start_step: int = 0,
    donate: bool = True,
    infer_flush_timeout_s: float = 0.02,
    infer_max_batch_requests: Optional[int] = None,
    infer_streams: int = 1,
    wire_codec: str = "none",
    vtrace_impl: str = "auto",
    spmd_devices: int = 0,
    on_update: Optional[Callable[[int, PyTree, Dict, Callable], None]] = None,
    obs=None,
    supervise: bool = False,
    heartbeat_timeout_s: float = 10.0,
    elastic: bool = False,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    device="cuda",
) -> Tuple[MultiTracker, Dict, Dict]:
    """Train until ``steps`` total learner updates with real async acting,
    on ``device`` (the card unless the caller asks for the CPU).

    The signature and defaults are the JAX runtime's, plus ``device``.
    ``supervise=True`` absorbs actor deaths: thread, process and remote
    actors are respawned under a ``Supervisor``'s restart budget, with
    the restart epoch folded into their seed; over the socket transport
    a lease silent for ``heartbeat_timeout_s`` is reaped and, with
    ``elastic``, actors past ``num_actors`` get new slots. The telemetry
    gains a ``supervisor`` section. Unsupervised, ``heartbeat_timeout_s``
    and ``elastic`` are unused, as in the reference.

    ``actor_backend`` picks where actors live and ``transport`` how
    trajectories travel: ``thread`` actors over ``inproc`` (live trees)
    or ``shm`` (every byte of the serialization boundary without process
    start-up); ``process`` actors over ``shm``; ``remote`` actors over
    ``socket``, where ``listen_addr`` is the (host, port) the learner
    binds (default loopback, ephemeral port) and ``spawn_remote`` picks
    the single-box shape (True: spawn ``num_actors`` loopback children
    that dial in like any remote machine) or the deployment shape
    (False: wait for ``num_actors`` external ``--connect`` actors).
    ``wire_codec`` (none | bf16 | int8) encodes the published params and
    the trajectories on the shm and socket wires, in JAX's bytes.

    ``actor_mode='inference'`` replaces the actors' unrolls with an
    ``InferenceService`` on the learner's device: the policy forward
    runs in pow2 buckets of up to ``infer_max_batch_requests`` requests
    (default: the actor count, rounded down to a power of two), and the
    telemetry grows an ``inference`` section. Thread actors are driven by
    one thread that submits every actor's request and flushes them at
    once each step; process and remote actors submit over their wires,
    and the service's flusher thread flushes a partial bucket at the
    latest ``infer_flush_timeout_s`` after its oldest request.
    ``infer_streams`` splits each process or remote actor's env batch
    into that many software-pipelined request streams (1 when
    ``num_envs`` does not divide evenly; thread actors ignore it).

    The learner updates its parameters in place and publishes a copy
    each update, whatever ``donate`` says; ``donate`` is only reported in
    the telemetry (see ``Learner``). ``initial_params`` and
    ``initial_opt_state`` (the port's tensors on ``device``, e.g.
    ``params.from_jax`` of a checkpoint's trees) become the learner's
    working state; with ``start_step`` a resumed run continues the
    version stream and the learning-rate schedule.

    ``ckpt_dir`` with ``ckpt_every > 0`` saves the combined tree
    ``{"params", "opt"}`` (JAX layout) every ``ckpt_every`` updates, with
    ``extra={"version", "format": "fleet-v1"}``, and supervised also
    ``restart_epochs``.

    ``warm_buckets=True`` runs one throwaway update per batch bucket
    before the timed region. ``batch_linger_s`` is the learner's flush
    deadline for a partial bucket (default 0: take what is queued).

    ``obs`` (an ``ObsConfig``) runs the whole flight recorder around the
    loop: a ``/metrics`` + ``/healthz`` + ``/telemetry`` HTTP endpoint
    (``metrics_port``; the bound address, useful with port 0, lands in
    ``obs.bound_address``), a periodic JSONL telemetry sink
    (``sink_path``), sampled per-trajectory lifecycle traces exported as
    Chrome trace-event JSON (``trace_path``/``trace_every``; the sampling
    rate reaches spawned actor children through the ``REPRO_TRACE_EVERY``
    environment variable, restored afterwards), phase timing (the
    telemetry's ``phases``) and a ``torch.profiler`` window over chosen
    updates (``profile_steps``, written into ``profile_dir``).

    Returns (tracker, last-update metrics, telemetry). ``on_update`` (if
    given) runs after every learner update with ``(update_index, params,
    metrics, snapshot_fn)``, where ``params`` is the published tree and
    ``snapshot_fn`` a zero-argument callable producing the telemetry.
    """
    learner = _setup(
        env_name, icfg, num_envs,
        num_actors=num_actors, actor_backend=actor_backend,
        actor_mode=actor_mode, transport=transport,
        queue_capacity=queue_capacity, queue_policy=queue_policy,
        max_batch_trajs=max_batch_trajs, batch_linger_s=batch_linger_s,
        seed=seed, arch=arch, initial_params=initial_params,
        initial_opt_state=initial_opt_state, start_step=start_step,
        donate=donate, wire_codec=wire_codec, vtrace_impl=vtrace_impl,
        spmd_devices=spmd_devices,
        infer_flush_timeout_s=infer_flush_timeout_s,
        infer_max_batch_requests=infer_max_batch_requests,
        infer_streams=infer_streams, listen_addr=listen_addr,
        spawn_remote=spawn_remote, obs=obs, supervise=supervise,
        heartbeat_timeout_s=heartbeat_timeout_s, elastic=elastic,
        device=device)
    server = sink = None
    prev_trace_env = None
    trace_env_set = False
    if obs is not None:
        if obs.metrics_port is not None:
            from repro_torch.obs.http import MetricsServer
            server = MetricsServer(learner.telemetry_snapshot,
                                   host=obs.metrics_host,
                                   port=obs.metrics_port).start()
            obs.bound_address = server.address
            print(f"[obs] metrics at http://{server.address[0]}:"
                  f"{server.address[1]}/metrics", flush=True)
        if obs.sink_path:
            from repro_torch.obs.sink import JsonlSink
            sink = JsonlSink(obs.sink_path, learner.telemetry_snapshot,
                             obs.sink_interval_s).start()
        if obs.trace_path:
            # actor threads and spawned children (which inherit the
            # environment) read the sampling rate from here
            prev_trace_env = os.environ.get("REPRO_TRACE_EVERY")
            os.environ["REPRO_TRACE_EVERY"] = str(max(1, obs.trace_every))
            trace_env_set = True
    on_ckpt = (fleet_checkpointer(ckpt_dir, learner.supervisor)
               if ckpt_dir and ckpt_every > 0 else None)
    try:
        metrics, final_telemetry = learner.run(
            steps, warm_buckets=warm_buckets, on_update=on_update,
            on_checkpoint=on_ckpt, ckpt_every=ckpt_every)
    finally:
        if trace_env_set:
            if prev_trace_env is None:
                os.environ.pop("REPRO_TRACE_EVERY", None)
            else:
                os.environ["REPRO_TRACE_EVERY"] = prev_trace_env
        if obs is not None and obs.trace_path and \
                learner.trace is not None:
            n = learner.trace.export(obs.trace_path)
            print(f"[obs] wrote {n} sampled trajectories -> "
                  f"{obs.trace_path}", flush=True)
        if sink is not None:
            sink.stop()
        if server is not None:
            server.stop()
    return learner.tracker, metrics, final_telemetry
