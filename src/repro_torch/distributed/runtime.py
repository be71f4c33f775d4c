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

Ported: thread actors in unroll mode over the in-process transport, one
learner, no replay, no checkpoints, no flight recorder. Every other value
of the JAX runtime's options raises, naming its ROADMAP.md Queue 1 item.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ImpalaConfig
from repro_torch.data.envs import make_env
from repro_torch.distributed.actor_pool import ActorPool
from repro_torch.distributed.learner import Learner, MultiTracker
from repro_torch.distributed.transport import make_transport

PyTree = Any

ACTOR_MODES = ("unroll", "inference")


def _unported(what: str, item: int, name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"Queue 1 item {item}: {name})")


def _validate(icfg, max_batch_trajs, actor_backend, actor_mode,
              transport, env_name, spmd_devices: int = 0,
              exchange=None) -> None:
    if not (0.0 <= icfg.replay_fraction < 1.0):
        raise ValueError(f"replay_fraction must be in [0, 1), got "
                         f"{icfg.replay_fraction}")
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
    if icfg.replay_fraction > 0:
        raise _unported("replay_fraction > 0", 11, "replay learner path")
    if actor_backend != "thread":
        raise _unported(f"actor_backend={actor_backend!r}", 10,
                        "process and socket actor pools")
    if transport != "inproc":
        raise _unported(f"transport={transport!r}", 10,
                        "process and socket actor pools")
    if actor_mode != "unroll":
        raise _unported(f"actor_mode={actor_mode!r}", 9,
                        "inference service")
    if spmd_devices or exchange is not None:
        raise _unported("an SPMD learner or a gradient exchange", 12,
                        "learner groups")


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
    exchange=None,
    device="cuda",
) -> Learner:
    """Build one learner worker's dependency graph (env, params, train
    step, store, transport, actor pool) and return the assembled
    ``Learner``. Actor slot ids are global (``slot_base + i``), so an
    actor's RNG stream does not depend on how slots are sharded."""
    _validate(icfg, max_batch_trajs, actor_backend, actor_mode,
              transport, env_name, spmd_devices=spmd_devices,
              exchange=exchange)
    env = make_env(env_name) if isinstance(env_name, str) else env_name
    if arch is None:
        from repro_torch.core.driver import small_arch
        arch = small_arch(env)
    learner = Learner(
        arch=arch, icfg=icfg, num_actions=env.num_actions,
        num_envs=num_envs, num_actors=num_actors, transport=None,
        seed=seed, actor_mode=actor_mode, max_batch_trajs=max_batch_trajs,
        batch_linger_s=batch_linger_s, donate=donate,
        start_step=start_step, initial_params=initial_params,
        initial_opt_state=initial_opt_state, wire_codec=wire_codec,
        vtrace_impl=vtrace_impl, device=device)
    # the transport's counters land in the registry the snapshot reads
    queue = make_transport(transport, queue_capacity, queue_policy,
                           registry=learner.obs_registry)
    learner.queue = queue
    pool = ActorPool(env, arch, icfg, num_envs, num_actors, learner.store,
                     queue, seed=seed, device=learner.device)
    learner.attach(pool)
    return learner


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
    ``listen_addr``, ``spawn_remote``, ``heartbeat_timeout_s``,
    ``elastic`` and the ``infer_*`` options only reach paths that are not
    ported (the socket transport, the inference service, supervision), so
    they are accepted and unused; ``wire_codec`` is checked and reported,
    and no wire uses it, as on the JAX in-process path. ``obs``,
    ``supervise`` and ``ckpt_dir`` raise, naming their ROADMAP.md item.

    The learner updates its parameters in place and publishes a copy
    each update, whatever ``donate`` says; ``donate`` is only reported in
    the telemetry (see ``Learner``). ``initial_params`` become the
    learner's working parameters.

    ``warm_buckets=True`` runs one throwaway update per batch bucket
    before the timed region. ``batch_linger_s`` is the learner's flush
    deadline for a partial bucket (default 0: take what is queued).

    Returns (tracker, last-update metrics, telemetry). ``on_update`` (if
    given) runs after every learner update with ``(update_index, params,
    metrics, snapshot_fn)``, where ``params`` is the published tree and
    ``snapshot_fn`` a zero-argument callable producing the telemetry.
    """
    del listen_addr, spawn_remote, infer_flush_timeout_s
    del infer_max_batch_requests, infer_streams, heartbeat_timeout_s
    del elastic
    if obs is not None:
        raise _unported("obs", 13, "observability")
    if supervise:
        raise _unported("supervise", 13, "observability and supervision")
    if ckpt_dir:
        raise _unported("ckpt_dir", 7, "checkpoint save/resume")
    del ckpt_every
    learner = _setup(
        env_name, icfg, num_envs,
        num_actors=num_actors, actor_backend=actor_backend,
        actor_mode=actor_mode, transport=transport,
        queue_capacity=queue_capacity, queue_policy=queue_policy,
        max_batch_trajs=max_batch_trajs, batch_linger_s=batch_linger_s,
        seed=seed, arch=arch, initial_params=initial_params,
        initial_opt_state=initial_opt_state, start_step=start_step,
        donate=donate, wire_codec=wire_codec, vtrace_impl=vtrace_impl,
        spmd_devices=spmd_devices, device=device)
    metrics, final_telemetry = learner.run(
        steps, warm_buckets=warm_buckets, on_update=on_update)
    return learner.tracker, metrics, final_telemetry
