"""The learner worker (``repro.distributed.learner``) for the
single-learner runtime: it drains one ``Transport`` with dynamic
batching, trains, publishes versioned params and reports telemetry.

  batch collection   power-of-two buckets, oldest-first requeue of
                     overflow, optional linger deadline; items from
                     thread actors are tensors on the device and stack
                     with ``torch.cat``, host (numpy) items go through
                     ``_HostStager``'s pinned staging buffers;
  train step         the fused ``train_step`` (forward, K2 on the card,
                     backward, clip, RMSProp); with replay the replay
                     train step (the target network's values as the
                     V-trace baseline of replayed rows, K1 on the card);
                     in a learner group the split: ``grad_step``, the
                     leaves to the host, the exchange's mean, the mean
                     back to the card, ``apply_step``;
  replay             fresh collection capped at ``_fresh_max``, the batch
                     topped up with replayed trajectories laid first,
                     priorities re-scored after the update, the fresh
                     trajectories stored, the target synced every
                     ``replay_target_period`` updates;
  publish            every update lands in the learner's own
                     ``ParameterStore``, with the CUDA event that marks
                     the published tree as written; in a group at the
                     version the exchange delegates (``publish_at``);
  telemetry          the JAX package's snapshot keys (updates, fps,
                     batch/lag histograms, queue, actors, ``inference``
                     with an inference service, ``replay`` with replay
                     on, and ``learner_id``/``slot_base``/``exchange``
                     in a group).

The optimizer updates the working parameters in place, so every update
publishes a copy of them (``params.snapshot``): no actor ever reads a
tensor that a later update writes. ``donate`` is reported in the
telemetry and changes nothing else: in JAX it decides whether the
learner's buffers are donated to the update and a jitted copy is
published, or the immutable working tree is; PyTorch has no buffer
donation, and publishing the working tensors would let an actor read a
half-updated policy.

On the card the learner issues its work on a CUDA stream of its own, so
its kernels and the actors' (each on their own stream) overlap. It marks
every trajectory tensor it reads as used on that stream
(``record_stream``): they were allocated on an actor's stream and are
freed on the learner's thread, and without the mark the caching
allocator could hand their memory back to the actor's stream while the
learner's ``torch.cat`` or forward still reads it.

With replay, the update's fresh trajectories are copied to the host
after it, on the learner's stream, with the per-trajectory advantage
magnitudes that re-score the replayed ones: one wait per update, as the
reference's read-back of those magnitudes is. ``on_checkpoint`` receives
host numpy trees in the JAX layout (the checkpoint format's).

In a group each round copies the gradient leaves to the host once (one
device buffer, one copy into pinned memory, one wait) and uploads the
mean once; every replica then runs the same ``apply_step`` launches on
the same values, so the replicas stay bit identical. The SPMD learner (an
in-XLA exchange) is not ported yet (ROADMAP.md, Queue 1 item 15C).

The flight recorder's hooks (``trace``, ``phase_timing``, ``profile``)
are all optional; without them the loop takes no stamps, and with them
it issues exactly the launches it issues without. With them every update's host
time is split into collect, host stage, device put, step and publish
(the ``phases`` telemetry section), sampled trajectories are folded into
the trace recorder, and the profile hook is called before each update.
The stamps are host time: on the fused path ``step`` brackets the
*dispatch* of the update, since waiting for the card would stall the
pipeline the recorder observes; the split path's copy of the gradient to
the host makes its stamps the real time.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import params as params_lib
from repro_torch.core import replay as replay_lib
from repro_torch.core.metrics import EpisodeTracker
from repro_torch.distributed.paramstore import ParameterStore
from repro_torch.distributed.serde import TrajectoryItem
from repro_torch.obs.metrics import Registry

PyTree = Any


class MultiTracker:
    """Episode-return accounting across actor-local env batches.

    ``slot_base`` maps *global* actor slot ids onto this learner's local
    tracker list. Completion times are recorded (CLOCK_MONOTONIC,
    comparable across the processes of one machine), so a learner group
    can merge its learners' streams into one chronological history."""

    def __init__(self, num_actors: int, num_envs: int,
                 slot_base: int = 0):
        self.trackers = [EpisodeTracker(num_envs) for _ in range(num_actors)]
        self.slot_base = slot_base
        self._merged: List[float] = []
        self._merged_at: List[float] = []

    def update(self, actor_id: int, rewards, dones) -> None:
        t = self.trackers[actor_id - self.slot_base]
        before = len(t.completed)
        t.update(np.asarray(rewards), np.asarray(dones))
        # merge in consumption order so mean_return's last-n window is
        # chronological, not actor-grouped
        fresh = t.completed[before:]
        if fresh:
            now = time.monotonic()
            self._merged.extend(fresh)
            self._merged_at.extend([now] * len(fresh))

    @property
    def completed(self) -> List[float]:
        return list(self._merged)

    @property
    def completed_timed(self) -> List[Tuple[float, float]]:
        """(monotonic completion time, return) pairs, in consumption
        order: what a group's merge sorts on."""
        return list(zip(self._merged_at, self._merged))

    def mean_return(self, last_n: int = 100) -> float:
        if not self._merged:
            return float("nan")
        return float(np.mean(self._merged[-last_n:]))


def _buckets(max_batch_trajs: int) -> List[int]:
    """Power-of-two stack sizes <= max, descending."""
    out, b = [], 1
    while b <= max_batch_trajs:
        out.append(b)
        b *= 2
    return out[::-1]


def _collect_batch(queue, buckets: List[int], first: TrajectoryItem,
                   linger_s: float = 0.0,
                   max_items: Optional[int] = None) -> List[TrajectoryItem]:
    """Starting from ``first`` (already popped), drain the queue up to
    the largest bucket, then trim to the largest power of two that
    fits, requeueing the overflow *at the front, newest first*, so the
    queue keeps oldest-first order and the next batch starts with the
    trajectories this one could not stack.

    ``linger_s`` is the learner-side flush deadline: wait up to this
    long for the bucket to fill rather than train on whatever is queued;
    a full bucket never waits.

    ``max_items`` (replay path) caps fresh collection below the top
    bucket: the learner tops the batch up with replayed trajectories."""
    items = [first]
    cap = buckets[0] if max_items is None else min(max_items, buckets[0])
    deadline = (time.monotonic() + linger_s) if linger_s > 0 else None
    while len(items) < cap:
        nxt = queue.get_nowait()
        if nxt is None:
            if deadline is None:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            nxt = queue.get(timeout=remaining)
            if nxt is None:
                break
        items.append(nxt)
    k = next(b for b in buckets if b <= len(items))
    for extra in reversed(items[k:]):
        queue.requeue_front(extra)
    return items[:k]


# ---------------------------------------------------------------------------
# trajectory trees: nested dicts (keys sorted, as JAX flattens them),
# tuples and lists over tensor or numpy leaves


def _flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure); equal structures mean equal nesting and
    keys."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for p in parts for x in p[0]],
                (dict, keys, tuple(p[1] for p in parts)))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree), len(tree), tuple(p[1] for p in parts)))
    return [tree], None


def _unflatten(structure, leaves) -> PyTree:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        if kind is dict:
            return {k: build(sub) for k, sub in zip(keys, subs)}
        return kind(build(sub) for sub in subs)
    return build(structure)


def _record_stream(tree, stream) -> None:
    """Mark every CUDA tensor of ``tree`` as used on ``stream``."""
    for x in _flatten(tree)[0]:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            x.record_stream(stream)


def _torch_dtype(dtype: np.dtype) -> Optional[torch.dtype]:
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:           # a dtype torch has no counterpart of
        return None


class _HostStager:
    """Per-(bucket, structure) host staging buffers for items whose leaves
    are numpy arrays (what the cross-process transports deliver).

    Stacking ``k`` trajectories writes each leaf in place into a staging
    buffer and moves the whole tree to the device at once. Buffer
    lifetime depends on the target device:

      cuda   two pinned buffer sets per bucket, **ping-ponged**; the
             host-to-device copies are ``non_blocking``, so before a set
             is written again the event recorded after its copies two
             stacks ago is waited for. The ping-pong alone only
             pipelines the copies; it is no completion guarantee.
      cpu    the "transfer" is free, but the batch IS the staging memory
             (``torch.from_numpy`` aliases it, and so does a CPU
             tensor's ``.to``), so buffers are allocated anew for every
             stack and never reused.
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._slots: Dict[Any, list] = {}
        self._reuse = self.device.type == "cuda"
        self.last_device_put_s = 0.0    # phase-timing probe, per stack

    def stack(self, items: List[TrajectoryItem]) -> Optional[PyTree]:
        """Staged stack of same-shaped numpy trajectories; None if the
        items are not uniform host trees (the caller falls back)."""
        datas = [it.data for it in items]
        leaves0, structure = _flatten(datas[0])
        if not all(isinstance(x, np.ndarray) for x in leaves0):
            return None
        dtypes = [_torch_dtype(x.dtype) for x in leaves0]
        if any(d is None for d in dtypes):
            return None
        shapes = tuple((x.shape, x.dtype.str) for x in leaves0)
        flat = [leaves0]
        for d in datas[1:]:
            ls, s = _flatten(d)
            if s != structure or \
                    tuple((x.shape, x.dtype.str) for x in ls) != shapes:
                return None                 # ragged: not the hot path
            flat.append(ls)
        k = len(items)

        def alloc():
            return [torch.empty((x.shape[0] * k,) + x.shape[1:], dtype=dt,
                                pin_memory=self._reuse)
                    for x, dt in zip(leaves0, dtypes)]

        if self._reuse:
            key = (k, structure, shapes)
            slot = self._slots.get(key)
            if slot is None:
                # [two buffer sets, next index, copy event per set]
                slot = self._slots[key] = [(alloc(), alloc()), 0,
                                           [None, None]]
            idx = slot[1]
            bufs = slot[0][idx]
            slot[1] ^= 1
            if slot[2][idx] is not None:
                slot[2][idx].synchronize()
        else:
            bufs = alloc()
        for i, ls in enumerate(flat):
            for buf, leaf in zip(bufs, ls):
                b = leaf.shape[0]
                np.copyto(buf.numpy()[i * b:(i + 1) * b], leaf)
        t0 = time.monotonic()
        if self._reuse:
            out = [buf.to(self.device, non_blocking=True) for buf in bufs]
            copied = torch.cuda.Event()
            copied.record()
            slot[2][idx] = copied
        else:
            out = bufs
        self.last_device_put_s = time.monotonic() - t0
        return _unflatten(structure, out)


def _split(flat: np.ndarray, like) -> List[np.ndarray]:
    """Views of ``flat`` shaped as the tensors ``like``, in order."""
    out, at = [], 0
    for x in like:
        n = x.numel()
        out.append(flat[at:at + n].reshape(tuple(x.shape)))
        at += n
    return out


def _is_host(tree) -> bool:
    return isinstance(_flatten(tree)[0][0], np.ndarray)


def _stack(items: List[TrajectoryItem],
           stager: Optional[_HostStager] = None) -> PyTree:
    """One batch of the items' trajectories, stacked on the batch axis.
    A single item of tensors passes through; numpy items go through the
    stager (or, ragged, one concatenate) and land on its device. Host
    items (replayed) may lead tensor items (fresh): each group is stacked
    so, and the two are concatenated, host rows first."""
    datas = [it.data for it in items]
    host = [_is_host(d) for d in datas]
    if any(host) and not all(host):
        n = host.index(False)
        if any(host[n:]):
            raise ValueError("host items must come before tensor items")
        (lead, _), (rest, structure) = (_flatten(_stack(items[:n], stager)),
                                        _flatten(_stack(items[n:], stager)))
        return _unflatten(structure, [torch.cat(xs, dim=0)
                                      for xs in zip(lead, rest)])
    if len(items) == 1 and not host[0]:
        return datas[0]
    if stager is not None:
        staged = stager.stack(items)
        if staged is not None:
            return staged
    device = stager.device if stager is not None else torch.device("cpu")
    flat = [_flatten(d) for d in datas]
    structure = flat[0][1]

    def cat(xs):
        if isinstance(xs[0], np.ndarray):
            return torch.from_numpy(np.concatenate(xs, axis=0)).to(device)
        return torch.cat(xs, dim=0)

    return _unflatten(structure, [cat(xs)
                                  for xs in zip(*(f[0] for f in flat))])


def _host_leaf(item: TrajectoryItem, key: str) -> np.ndarray:
    """``key`` of the item's trajectory as a numpy array: the copy the
    actor made (no device access), else the data itself."""
    x = (item.host if item.host is not None else item.data)[key]
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_host(trees: List[PyTree]) -> List[PyTree]:
    """Numpy copies of tensor trees. Tensors on the card are copied into
    pinned buffers on the current stream and waited for once, all
    together."""
    flat = [_flatten(t) for t in trees]
    wait = False
    copies = []
    for leaves, _ in flat:
        out = []
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                x, wait = h, True
            out.append(x)
        copies.append(out)
    if wait:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return [_unflatten(structure, [x.detach().numpy()
                                   if isinstance(x, torch.Tensor) else x
                                   for x in leaves])
            for (_, structure), leaves in zip(flat, copies)]


class Learner:
    """One learner worker: drains a ``Transport`` with dynamic batching,
    trains, publishes versioned params, reports telemetry.

    Construction builds the params/optimizer/train-step state and the
    learner's own ``ParameterStore`` (``self.store``, for wiring the actor
    pool); ``attach`` binds the pool once it exists; ``run`` executes the
    training loop end to end, owning the start/stop/join/close lifecycle.
    ``initial_params`` (the port's tensors on ``device``) are the working
    parameters, updated in place; ``initial_opt_state`` (likewise) resumes
    the optimizer from a checkpoint."""

    def __init__(self, *, arch, icfg, num_actions: int, num_envs: int,
                 num_actors: int, transport, seed: int = 0,
                 learner_id: int = 0, num_learners: int = 1,
                 slot_base: int = 0, actor_mode: str = "unroll",
                 max_batch_trajs: int = 4, batch_linger_s: float = 0.0,
                 donate: bool = True, start_step: int = 0,
                 initial_params: Optional[PyTree] = None,
                 initial_opt_state: Optional[PyTree] = None,
                 exchange=None, registry: Optional[Registry] = None,
                 wire_codec: str = "none", vtrace_impl: str = "auto",
                 trace=None, phase_timing: bool = False, profile=None,
                 device="cuda"):
        from repro_torch.core import learner as learner_lib
        from repro_torch.models import backbone as bb
        from repro_torch.models import common

        if max_batch_trajs < 1:
            raise ValueError(f"max_batch_trajs must be >= 1, got "
                             f"{max_batch_trajs}")
        self.arch = arch
        self.icfg = icfg
        self.learner_id = learner_id
        self.num_learners = num_learners
        self.slot_base = slot_base
        self.actor_mode = actor_mode
        self.donate = donate
        self.batch_linger_s = batch_linger_s
        self.queue = transport
        self.wire_codec = wire_codec
        self.vtrace_impl = vtrace_impl
        self._exchange = exchange
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

        if initial_params is not None:
            params = initial_params
        else:
            specs = bb.backbone_specs(arch, num_actions)
            params = params_lib.from_jax(common.init_params(specs, seed),
                                         self.device)
        replay_on = icfg.replay_fraction > 0.0
        self._grad_step = self._apply_step = None
        if exchange is not None:
            # grouped: the update is split at the gradient, with the
            # exchange's mean between the halves
            build = (learner_lib.build_replay_grad_apply_steps if replay_on
                     else learner_lib.build_grad_apply_steps)
            self._grad_step, self._apply_step, opt = build(
                arch, icfg, num_actions, vtrace_impl=vtrace_impl)
            self._train_step = None
        elif replay_on:
            # train_step(params, target_params, opt_state, step, batch):
            # the target is read, never written
            replay_step, opt = learner_lib.build_replay_train_step(
                arch, icfg, num_actions, vtrace_impl=vtrace_impl)

            def train_step(params, opt_state, step, batch):
                return replay_step(params, self._target_params, opt_state,
                                   step, batch)
            self._train_step = train_step
        else:
            self._train_step, opt = learner_lib.build_train_step(
                arch, icfg, num_actions, vtrace_impl=vtrace_impl)
        # the group's pinned host buffers: gradient leaves down, mean up
        self._grad_host = self._mean_host = None
        self._params = params
        self._opt_state = (initial_opt_state if initial_opt_state is not None
                           else opt.init(params))
        self.store = ParameterStore(
            params_lib.snapshot(params), version=start_step,
            wire_codec=wire_codec, ready=self._mark())
        self.start_step = start_step
        self.tracker = MultiTracker(num_actors, num_envs,
                                    slot_base=slot_base)
        self._buckets = _buckets(max_batch_trajs)
        self._stager = _HostStager(self.device)
        self._frames_per_traj = num_envs * icfg.unroll_length
        self._num_envs = num_envs
        if replay_on:
            # the sample stream's identity is (seed, learner_id), as in
            # the reference
            self._replay = replay_lib.ReplayBuffer(
                icfg.replay_capacity, seed=seed, learner_id=learner_id,
                reuse_limit=icfg.replay_reuse,
                priority=icfg.replay_priority)
            self._fresh_max = max(1, int(round(
                self._buckets[0] * (1.0 - icfg.replay_fraction))))
            # IMPACT target: a snapshot of the learner params supplies the
            # V-trace baseline of replayed rows; replaced by the published
            # snapshot every replay_target_period updates. Never the
            # working tree, which every update writes in place
            self._target_params = params_lib.snapshot(params)
        else:
            self._replay = None
            self._fresh_max = None
            self._target_params = None
        self._target_syncs = 0
        self.frames_trained = 0
        self.pool = None
        self.service = None

        # telemetry: the lag/batch histograms are registry instruments
        # (the hot-path `hist[k] += 1` writes the registry) and everything
        # else is a pull-time producer, so the snapshot reads one storage
        self.obs_registry = registry if registry is not None else Registry()
        self.lag_hist = self.obs_registry.int_histogram(
            "learner.lag_hist").counts
        self.batch_hist = self.obs_registry.int_histogram(
            "learner.batch_hist").counts
        self.updates = start_step
        self.frames_consumed = 0
        self._steady_t0: Optional[float] = None
        self._steady_updates0 = 0
        self._steady_frames0 = 0
        self._first_t0: Optional[float] = None
        self._first_updates0 = 0
        self._first_frames0 = 0
        self._steady_trained0 = 0
        self._first_trained0 = 0
        self.metrics: Dict = {}
        # flight recorder hooks (all optional, see repro_torch.obs)
        self.trace = trace                  # TraceRecorder or None
        self._phase_timing = bool(phase_timing)
        self._profile = profile             # ProfileHook or None
        self._phase_acc = {"collect": 0.0, "host_stage": 0.0,
                           "device_put": 0.0, "step": 0.0, "publish": 0.0}
        self._phase_n = 0
        reg = self.obs_registry
        reg.register_producer("learner", self._core_telemetry)
        reg.register_producer(
            "queue", lambda: (self.queue.snapshot()
                              if self.queue is not None else None))
        reg.register_producer(
            "actors", lambda: (self.pool.stats()
                               if self.pool is not None else {}))
        reg.register_producer(
            "inference", lambda: (self.service.snapshot()
                                  if self.service is not None else None))
        reg.register_producer("replay", self._replay_telemetry)
        reg.register_producer(
            "exchange", lambda: (self._exchange.snapshot()
                                 if self._exchange is not None else None))

    # ------------------------------------------------------------------

    def attach(self, pool, service=None) -> None:
        """Bind the actor pool (and optional inference service) this
        learner drives; both were built against ``self.store`` and
        ``self.queue``."""
        self.pool = pool
        self.service = service

    def _raise_worker_errors(self) -> None:
        self.pool.raise_errors()
        if self.service is not None:
            self.service.raise_errors()

    def _mark(self):
        """An event after the work queued so far on the current stream
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _sync(self) -> None:
        """Wait for the learner's own stream (not the whole device: the
        actors' streams keep running)."""
        if self._stream is not None:
            self._stream.synchronize()

    # ------------------------------------------------------------------

    def _core_telemetry(self) -> Dict:
        """The ``learner`` registry producer: counts, rates, version."""
        now = time.monotonic()
        if self._steady_t0 is not None:
            dt, u0, f0 = (now - self._steady_t0, self._steady_updates0,
                          self._steady_frames0)
        elif self._first_t0 is not None:
            dt, u0, f0 = (now - self._first_t0, self._first_updates0,
                          self._first_frames0)
        else:
            dt, u0, f0 = 0.0, 0, 0
        return {
            "updates": self.updates,
            "frames_consumed": self.frames_consumed,
            "updates_per_sec": ((self.updates - u0) / dt
                                if dt > 0 else 0.0),
            "frames_per_sec": ((self.frames_consumed - f0) / dt
                               if dt > 0 else 0.0),
            "param_version": self.store.version,
            "wire_codec": self.wire_codec,
            "param_wire_bytes": self.store.serialized_wire_bytes,
            "param_raw_bytes": self.store.serialized_raw_bytes,
        }

    def _replay_telemetry(self) -> Optional[Dict]:
        """The ``replay`` registry producer: None (so omitted from the
        snapshot) when replay is off, which keeps the pinned key set."""
        if self._replay is None:
            return None
        now = time.monotonic()
        if self._steady_t0 is not None:
            dt, t0 = now - self._steady_t0, self._steady_trained0
        elif self._first_t0 is not None:
            dt, t0 = now - self._first_t0, self._first_trained0
        else:
            dt, t0 = 0.0, 0
        snap = self._replay.snapshot()
        snap["fraction"] = self.icfg.replay_fraction
        snap["fresh_max"] = self._fresh_max
        snap["frames_trained"] = self.frames_trained
        # frames the optimizer saw per env frame consumed (1.0 = one-pass
        # IMPALA; ~1/(1-fraction) in steady state)
        snap["reuse_ratio"] = (self.frames_trained / self.frames_consumed
                               if self.frames_consumed else 0.0)
        snap["trained_frames_per_sec"] = ((self.frames_trained - t0) / dt
                                          if dt > 0 else 0.0)
        snap["target_syncs"] = self._target_syncs
        snap["target_period"] = self.icfg.replay_target_period
        return snap

    def telemetry_snapshot(self) -> Dict:
        """The pinned snapshot key set, assembled from one registry
        pull; ``inference`` only with an inference service, ``replay``
        only with replay on."""
        col = self.obs_registry.collect()
        core = col.get("learner", {})
        lag_hist = col.get("learner.lag_hist", {})
        n_lags = sum(lag_hist.values())
        snap = {
            "learner_updates": core.get("updates", self.updates),
            "frames_consumed": core.get("frames_consumed",
                                        self.frames_consumed),
            "updates_per_sec": core.get("updates_per_sec", 0.0),
            "frames_per_sec": core.get("frames_per_sec", 0.0),
            "batch_size_hist": dict(col.get("learner.batch_hist", {})),
            "lag": {
                "hist": dict(sorted(lag_hist.items())),
                "mean": (sum(k * v for k, v in lag_hist.items())
                         / n_lags if n_lags else 0.0),
                "max": max(lag_hist) if lag_hist else 0,
                "measured": n_lags,
            },
            "queue": col.get("queue", {}),
            "actors": col.get("actors", {}),
            "param_version": core.get("param_version",
                                      self.store.version),
            "actor_mode": self.actor_mode,
            "donate": self.donate,
        }
        if "inference" in col:
            snap["inference"] = col["inference"]
        if "replay" in col:
            snap["replay"] = col["replay"]
        if self._exchange is not None:
            # grouped only: alone, the key set stays the single learner's
            snap["learner_id"] = self.learner_id
            snap["slot_base"] = self.slot_base
            snap["exchange"] = col.get("exchange", self._exchange.snapshot())
        if "supervisor" in col:
            # supervised only: the restart/failover/lease-reap counts ride
            # the snapshot (and the group parent's merge); unsupervised
            # runs keep the pinned key set
            snap["supervisor"] = col["supervisor"]
        if self._phase_timing:
            # only with the flight recorder on: without it the key set
            # stays the JAX package's pinned one
            n = self._phase_n
            snap["phases"] = {
                "updates_timed": n,
                "total_s": dict(self._phase_acc),
                "mean_ms": {k: (1e3 * v / n if n else 0.0)
                            for k, v in self._phase_acc.items()},
            }
        return snap

    # ------------------------------------------------------------------

    def _warm(self) -> None:
        """One throwaway update per batch bucket on copies of the params
        and optimizer state, so the first launches of each bucket's
        shapes (K2's, cuDNN's plans) stay out of the timed window."""
        first = None
        while first is None:
            self._raise_worker_errors()
            first = self.queue.get(timeout=0.5)
        if self._stream is not None:
            _record_stream(first.data, self._stream)
        for b in self._buckets:
            warm = _stack([first] * b, self._stager)
            if self._replay is not None:
                # the mask is data: all zero warms each bucket's shapes
                warm = dict(warm)
                warm["replay_mask"] = torch.zeros(b * self._num_envs,
                                                  device=self.device)
            if self._exchange is None:
                self._train_step(params_lib.copy(self._params),
                                 params_lib.copy(self._opt_state), 0, warm)
            else:
                grads, _ = self._grad(warm)
                self._apply_step(params_lib.copy(self._params),
                                 params_lib.copy(self._opt_state), 0, grads)
        self._sync()
        self.queue.requeue_front(first)

    def _grad(self, batch):
        if self._replay is not None:
            return self._grad_step(self._params, self._target_params, batch)
        return self._grad_step(self._params, batch)

    def _update_once(self, batch, timings: Optional[Dict[str, float]] = None
                     ) -> Optional[Tuple[PyTree, Dict]]:
        """One training update on ``batch``: fused when alone; grouped,
        the gradient, the exchange's mean and the apply. Returns
        (published params, metrics), or None when the exchange shut
        down.

        ``timings`` (flight-recorder runs only) receives the host stamps
        step0/step1/published. On the fused path they bracket the
        update's dispatch; the split path waits for the gradient's copy
        to the host, so its stamps are real."""
        if timings is not None:
            timings["step0"] = time.monotonic()
        if self._exchange is None:
            self._params, self._opt_state, metrics = self._train_step(
                self._params, self._opt_state, self.updates, batch)
            published = params_lib.snapshot(self._params)
            if timings is not None:
                timings["step1"] = time.monotonic()
            self.store.publish(published, self._mark())
            if timings is not None:
                timings["published"] = time.monotonic()
            return published, metrics
        grads, metrics = self._grad(batch)
        reduced = self._exchange.allreduce(self._leaves_to_host(grads),
                                           round_idx=self.updates)
        if reduced is None:
            return None                     # the group is shutting down
        mean_leaves, version = reduced
        self._params, self._opt_state, ametrics = self._apply_step(
            self._params, self._opt_state, self.updates,
            self._leaves_to_device(mean_leaves, grads))
        metrics = dict(metrics)
        metrics.update(ametrics)
        published = params_lib.snapshot(self._params)
        if timings is not None:
            timings["step1"] = time.monotonic()
        # the hub numbers the rounds: every learner of the group publishes
        # at its version, so all actors see one version stream
        self.store.publish_at(published, version, self._mark())
        if timings is not None:
            timings["published"] = time.monotonic()
        return published, metrics

    def _leaves_to_host(self, leaves) -> List[np.ndarray]:
        """The gradient leaves as numpy arrays. On the card: packed into
        one device buffer, copied once into a pinned buffer (reused every
        round: the exchange is done with it when ``allreduce`` returns)
        and waited for once."""
        if self.device.type != "cuda":
            return [x.detach().numpy() for x in leaves]
        flat = torch.cat([x.detach().reshape(-1) for x in leaves])
        if self._grad_host is None:
            self._grad_host = torch.empty(flat.shape, dtype=flat.dtype,
                                          pin_memory=True)
        self._grad_host.copy_(flat, non_blocking=True)
        self._mark().synchronize()
        return _split(self._grad_host.numpy(), leaves)

    def _leaves_to_device(self, mean_leaves, like) -> List[torch.Tensor]:
        """The exchanged mean as tensors shaped as ``like`` on the
        learner's device: on the card one pinned buffer, one copy up."""
        if self.device.type != "cuda":
            return [torch.from_numpy(np.ascontiguousarray(m, np.float32))
                    for m in mean_leaves]
        if self._mean_host is None:
            self._mean_host = torch.empty(self._grad_host.shape,
                                          dtype=torch.float32,
                                          pin_memory=True)
        for dst, m in zip(_split(self._mean_host.numpy(), like),
                          mean_leaves):
            np.copyto(dst, m)
        flat = self._mean_host.to(self.device, non_blocking=True)
        return [x.view_as(g) for x, g in zip(
            flat.split([g.numel() for g in like]), like)]

    def run(self, steps: int, *, warm_buckets: bool = False,
            on_update: Optional[Callable] = None,
            should_stop: Optional[Callable[[], bool]] = None,
            on_checkpoint: Optional[Callable] = None,
            ckpt_every: int = 0) -> Tuple[Dict, Dict]:
        """Train until ``steps`` total updates (or ``should_stop``).
        Starts the pool, runs the loop, then stops/joins the workers and
        closes the transport. Returns (last metrics, final telemetry).
        ``on_update(update_index, published params, metrics,
        snapshot_fn)`` runs after every update, on the learner's
        stream. ``on_checkpoint(update_index, params, opt_state,
        version)`` runs every ``ckpt_every`` updates, with host numpy
        trees in the JAX layout."""
        if self.pool is None:
            raise RuntimeError("attach(pool) before run()")
        if self._stream is not None:
            # the initial params were written on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.service is not None:
            self.service.start()
        self.pool.start()
        try:
            with torch.cuda.stream(self._stream):
                final_telemetry = self._loop(steps, warm_buckets, on_update,
                                             should_stop, on_checkpoint,
                                             ckpt_every)
        finally:
            if self._profile is not None:
                # a window still open (the run ended inside it) closes on
                # the learner's stream
                with torch.cuda.stream(self._stream):
                    self._profile.stop()
            # stop the workers (the service wakes every client blocked on
            # it with a None reply), join them, and only then close the
            # transport
            self.pool.stop()
            if self.service is not None:
                self.service.stop()
            if self._exchange is not None:
                self._exchange.close()
            self.pool.join()
            self.queue.close()
        if self._stream is not None:
            # the caller reads the params on its own stream
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        self._raise_worker_errors()
        return self.metrics, final_telemetry

    def _record_obs(self, items, version_now: int, t_deq: float,
                    t_col: float, t_stk: float,
                    timings: Dict[str, float]) -> None:
        """Fold one update's stamps into the phase accumulators and the
        trace recorder (sampled items only)."""
        step0 = timings.get("step0", t_stk)
        step1 = timings.get("step1", step0)
        pub = timings.get("published", step1)
        if self._phase_timing:
            acc = self._phase_acc
            acc["collect"] += t_col - t_deq
            acc["host_stage"] += t_stk - t_col
            acc["device_put"] += self._stager.last_device_put_s
            acc["step"] += step1 - step0
            acc["publish"] += pub - step1
            self._phase_n += 1
        if self.trace is not None:
            for it in items:
                if it.trace is not None:
                    self.trace.record_item(
                        it, dequeued=t_deq, collected=t_col,
                        step0=step0, step1=step1, published=pub,
                        lag=version_now - it.param_version)

    def _loop(self, steps, warm_buckets, on_update, should_stop,
              on_checkpoint, ckpt_every) -> Dict:
        if warm_buckets:
            self._warm()
        # flight-recorder stamps only when something reads them: the
        # plain loop reads no clock per update
        want_t = self._phase_timing or self.trace is not None
        while self.updates < steps:
            if should_stop is not None and should_stop():
                break
            self._raise_worker_errors()
            item = self.queue.get(timeout=0.5)
            if item is None:
                continue
            t_deq = time.monotonic() if want_t else 0.0
            # replay caps fresh collection below the top bucket and tops
            # the batch back up with replayed rows: that is where the
            # env-frame saving comes from
            items = _collect_batch(self.queue, self._buckets, item,
                                   self.batch_linger_s,
                                   max_items=self._fresh_max)
            k = len(items)
            t_col = time.monotonic() if want_t else 0.0
            version_now = self.store.version
            for it in items:
                self.lag_hist[version_now - it.param_version] += 1
                self.tracker.update(it.actor_id, _host_leaf(it, "rewards"),
                                    _host_leaf(it, "done"))
                if self._stream is not None:
                    _record_stream(it.data, self._stream)
            samples = self._sample_replay(k, version_now)
            train_items = ([s.item for s in samples] + items
                           if samples else items)
            if want_t:
                self._stager.last_device_put_s = 0.0
            batch = _stack(train_items, self._stager)
            if self._replay is not None:
                # replayed rows sit first in the stacked batch
                n_rep = len(samples) if samples else 0
                mask = torch.zeros(len(train_items) * self._num_envs,
                                   device=self.device)
                mask[:n_rep * self._num_envs] = 1.0
                batch = dict(batch)
                batch["replay_mask"] = mask
            t_stk = time.monotonic() if want_t else 0.0
            if self._profile is not None:
                self._profile.on_step(self.updates)
            timings = {} if want_t else None
            stepped = self._update_once(batch, timings)
            if stepped is None:
                break                   # the exchange shut down under us
            published, metrics = stepped
            if self._replay is not None:
                metrics = self._replay_bookkeeping(metrics, samples, items)
            self.metrics = metrics
            self.updates += 1
            if self._replay is not None and \
                    self.updates % self.icfg.replay_target_period == 0:
                # IMPACT target sync: the published snapshot, which no
                # later update writes
                self._target_params = published
                self._target_syncs += 1
            self.frames_consumed += k * self._frames_per_traj
            self.frames_trained += len(train_items) * self._frames_per_traj
            self.batch_hist[len(train_items)] += 1
            if want_t:
                self._record_obs(items, version_now, t_deq, t_col, t_stk,
                                 timings)
            if self._steady_t0 is None:
                self._sync()
                if self._first_t0 is None:
                    # the first update includes the lazy set-up (kernel
                    # build, cuDNN plans)
                    self._first_t0 = time.monotonic()
                    self._first_updates0 = self.updates
                    self._first_frames0 = self.frames_consumed
                    self._first_trained0 = self.frames_trained
                if all(f > 0 for f in self.pool.frames):
                    # every worker is past its set-up and producing
                    self._steady_t0 = time.monotonic()
                    self._steady_updates0 = self.updates
                    self._steady_frames0 = self.frames_consumed
                    self._steady_trained0 = self.frames_trained
            if on_update is not None:
                on_update(self.updates, published, self.metrics,
                          self.telemetry_snapshot)
            if on_checkpoint is not None and ckpt_every > 0 and \
                    self.updates % ckpt_every == 0:
                on_checkpoint(self.updates, self._host_jax(published),
                              self.opt_state_host(), self.store.version)
        # snapshot before teardown: pool.join waits out in-flight unrolls
        # and put timeouts, which would pad the steady-state dt
        self._sync()
        return self.telemetry_snapshot()

    def _sample_replay(self, num_fresh: int, version_now: int):
        """Plan and draw the replayed top-up for a batch of ``num_fresh``
        online trajectories; None = train pure online this round
        (replay off, buffer still filling, or starved)."""
        if self._replay is None:
            return None
        n_rep = replay_lib.plan_mix(
            num_fresh, self._buckets[0], self.icfg.replay_fraction,
            self._replay.num_sampleable())
        if n_rep < 1:
            return None
        return self._replay.sample_items(n_rep, version_now=version_now)

    def _replay_bookkeeping(self, metrics, samples, fresh_items) -> Dict:
        """After the update: pop the per-trajectory advantage magnitudes
        ((B,)-shaped, kept from scalar metric consumers), re-score the
        replayed slots with them, and store the fresh trajectories with
        their measured priority and their online pass pre-counted
        (``uses=1``), so ``replay_reuse`` caps *total* consumptions. The
        magnitudes and the fresh trajectories come to the host together,
        with one wait."""
        metrics = dict(metrics)
        mags = metrics.pop("vtrace/traj_adv_mag")
        n_rep = len(samples) if samples else 0
        host = _to_host([mags] + [it.data for it in fresh_items])
        # row r of the stacked batch belongs to trajectory r // num_envs
        per = np.asarray(host[0], np.float64).reshape(
            n_rep + len(fresh_items), self._num_envs).mean(axis=1)
        if n_rep:
            self._replay.update_priorities([s.uid for s in samples],
                                           per[:n_rep])
        for j, (it, data) in enumerate(zip(fresh_items, host[1:])):
            self._replay.add_item(
                TrajectoryItem(data, it.param_version, it.actor_id,
                               it.produced_at),
                priority=float(per[n_rep + j]), uses=1)
        return metrics

    def _host_jax(self, tree) -> PyTree:
        """``tree`` as host numpy leaves in the JAX layout, once the
        learner's stream has written it."""
        self._sync()
        return params_lib.to_jax(tree)

    # ------------------------------------------------------------------

    def published_host(self) -> PyTree:
        """The latest published params as host numpy leaves in the JAX
        layout (the checkpoint format's)."""
        params, _version, ready = self.store.pull_ready()
        if ready is not None:
            ready.synchronize()
        return params_lib.to_jax(params)

    def opt_state_host(self) -> PyTree:
        """The optimizer state as host numpy leaves in the JAX layout
        (copies: a checkpoint writer never races a later update)."""
        return self._host_jax(self._opt_state)
