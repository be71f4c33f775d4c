"""The learner worker (``repro.distributed.learner``) for the
single-learner runtime: it drains one ``Transport`` with dynamic
batching, trains, publishes versioned params and reports telemetry.

  batch collection   power-of-two buckets, oldest-first requeue of
                     overflow, optional linger deadline; items from
                     thread actors are tensors on the device and stack
                     with ``torch.cat``, host (numpy) items go through
                     ``_HostStager``'s pinned staging buffers;
  train step         the fused ``train_step`` (forward, K2 on the card,
                     backward, clip, RMSProp);
  publish            every update lands in the learner's own
                     ``ParameterStore``, with the CUDA event that marks
                     the published tree as written;
  telemetry          the JAX package's snapshot keys (updates, fps,
                     batch/lag histograms, queue, actors).

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

Learner groups (an exchange, SPMD), replay and the flight recorder are
not ported yet (ROADMAP.md, Queue 1 items 12, 11 and 13).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import params as params_lib
from repro_torch.core.metrics import EpisodeTracker
from repro_torch.distributed.paramstore import ParameterStore
from repro_torch.distributed.serde import TrajectoryItem
from repro_torch.obs.metrics import Registry

PyTree = Any


class MultiTracker:
    """Episode-return accounting across actor-local env batches.

    ``slot_base`` maps *global* actor slot ids onto this learner's local
    tracker list."""

    def __init__(self, num_actors: int, num_envs: int,
                 slot_base: int = 0):
        self.trackers = [EpisodeTracker(num_envs) for _ in range(num_actors)]
        self.slot_base = slot_base
        self._merged: List[float] = []

    def update(self, actor_id: int, rewards, dones) -> None:
        t = self.trackers[actor_id - self.slot_base]
        before = len(t.completed)
        t.update(np.asarray(rewards), np.asarray(dones))
        # merge in consumption order so mean_return's last-n window is
        # chronological, not actor-grouped
        self._merged.extend(t.completed[before:])

    @property
    def completed(self) -> List[float]:
        return list(self._merged)

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
                   linger_s: float = 0.0) -> List[TrajectoryItem]:
    """Starting from ``first`` (already popped), drain the queue up to
    the largest bucket, then trim to the largest power of two that
    fits, requeueing the overflow *at the front, newest first*, so the
    queue keeps oldest-first order and the next batch starts with the
    trajectories this one could not stack.

    ``linger_s`` is the learner-side flush deadline: wait up to this
    long for the bucket to fill rather than train on whatever is queued;
    a full bucket never waits."""
    items = [first]
    cap = buckets[0]
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
        if self._reuse:
            out = [buf.to(self.device, non_blocking=True) for buf in bufs]
            copied = torch.cuda.Event()
            copied.record()
            slot[2][idx] = copied
        else:
            out = bufs
        return _unflatten(structure, out)


def _stack(items: List[TrajectoryItem],
           stager: Optional[_HostStager] = None) -> PyTree:
    """One batch of the items' trajectories, stacked on the batch axis.
    A single item of tensors passes through; numpy items go through the
    stager (or, ragged, one concatenate) and land on its device."""
    datas = [it.data for it in items]
    host = isinstance(_flatten(datas[0])[0][0], np.ndarray)
    if len(items) == 1 and not host:
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


def _copy_tree(tree: PyTree) -> PyTree:
    """Detached copies that keep each leaf's ``requires_grad``."""
    return params_lib.tree_map(
        lambda x: x.detach().clone().requires_grad_(x.requires_grad), tree)


class Learner:
    """One learner worker: drains a ``Transport`` with dynamic batching,
    trains, publishes versioned params, reports telemetry.

    Construction builds the params/optimizer/train-step state and the
    learner's own ``ParameterStore`` (``self.store``, for wiring the actor
    pool); ``attach`` binds the pool once it exists; ``run`` executes the
    training loop end to end, owning the start/stop/join/close lifecycle.
    ``initial_params`` (the port's tensors on ``device``) are the working
    parameters, updated in place."""

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
        if exchange is not None:
            raise NotImplementedError(
                "a gradient exchange is not ported yet (ROADMAP.md, Queue 1 "
                "item 12: learner groups)")
        if icfg.replay_fraction > 0:
            raise NotImplementedError(
                "replay_fraction > 0 is not ported yet (ROADMAP.md, Queue 1 "
                "item 11: replay learner path)")
        if trace is not None or phase_timing or profile is not None:
            raise NotImplementedError(
                "the flight recorder is not ported yet (ROADMAP.md, Queue 1 "
                "item 13: observability)")
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
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

        if initial_params is not None:
            params = initial_params
        else:
            specs = bb.backbone_specs(arch, num_actions)
            params = params_lib.from_jax(common.init_params(specs, seed),
                                         self.device)
        self._train_step, opt = learner_lib.build_train_step(
            arch, icfg, num_actions, vtrace_impl=vtrace_impl)
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
        self.pool = None

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
        self.metrics: Dict = {}
        reg = self.obs_registry
        reg.register_producer("learner", self._core_telemetry)
        reg.register_producer(
            "queue", lambda: (self.queue.snapshot()
                              if self.queue is not None else None))
        reg.register_producer(
            "actors", lambda: (self.pool.stats()
                               if self.pool is not None else {}))

    # ------------------------------------------------------------------

    def attach(self, pool) -> None:
        """Bind the actor pool this learner drives; it was built against
        ``self.store`` and ``self.queue``."""
        self.pool = pool

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

    def telemetry_snapshot(self) -> Dict:
        """The pinned snapshot key set, assembled from one registry
        pull."""
        col = self.obs_registry.collect()
        core = col.get("learner", {})
        lag_hist = col.get("learner.lag_hist", {})
        n_lags = sum(lag_hist.values())
        return {
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

    # ------------------------------------------------------------------

    def _warm(self) -> None:
        """One throwaway update per batch bucket on copies of the params
        and optimizer state, so the first launches of each bucket's
        shapes (K2's, cuDNN's plans) stay out of the timed window."""
        first = None
        while first is None:
            self.pool.raise_errors()
            first = self.queue.get(timeout=0.5)
        if self._stream is not None:
            _record_stream(first.data, self._stream)
        for b in self._buckets:
            warm = _stack([first] * b, self._stager)
            self._train_step(_copy_tree(self._params),
                             _copy_tree(self._opt_state), 0, warm)
        self._sync()
        self.queue.requeue_front(first)

    def _update_once(self, batch) -> Tuple[PyTree, Dict]:
        """One training update on ``batch``; returns (published params,
        metrics)."""
        self._params, self._opt_state, metrics = self._train_step(
            self._params, self._opt_state, self.updates, batch)
        published = params_lib.snapshot(self._params)
        self.store.publish(published, self._mark())
        return published, metrics

    def run(self, steps: int, *, warm_buckets: bool = False,
            on_update: Optional[Callable] = None,
            should_stop: Optional[Callable[[], bool]] = None
            ) -> Tuple[Dict, Dict]:
        """Train until ``steps`` total updates (or ``should_stop``).
        Starts the pool, runs the loop, then stops/joins the workers and
        closes the transport. Returns (last metrics, final telemetry).
        ``on_update(update_index, published params, metrics,
        snapshot_fn)`` runs after every update, on the learner's
        stream."""
        if self.pool is None:
            raise RuntimeError("attach(pool) before run()")
        if self._stream is not None:
            # the initial params were written on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self.pool.start()
        try:
            with torch.cuda.stream(self._stream):
                final_telemetry = self._loop(steps, warm_buckets, on_update,
                                             should_stop)
        finally:
            self.pool.stop()
            self.pool.join()
            self.queue.close()
        if self._stream is not None:
            # the caller reads the params on its own stream
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        self.pool.raise_errors()
        return self.metrics, final_telemetry

    def _loop(self, steps, warm_buckets, on_update, should_stop) -> Dict:
        if warm_buckets:
            self._warm()
        while self.updates < steps:
            if should_stop is not None and should_stop():
                break
            self.pool.raise_errors()
            item = self.queue.get(timeout=0.5)
            if item is None:
                continue
            items = _collect_batch(self.queue, self._buckets, item,
                                   self.batch_linger_s)
            k = len(items)
            version_now = self.store.version
            for it in items:
                self.lag_hist[version_now - it.param_version] += 1
                self.tracker.update(it.actor_id, _host_leaf(it, "rewards"),
                                    _host_leaf(it, "done"))
                if self._stream is not None:
                    _record_stream(it.data, self._stream)
            batch = _stack(items, self._stager)
            published, self.metrics = self._update_once(batch)
            self.updates += 1
            self.frames_consumed += k * self._frames_per_traj
            self.batch_hist[k] += 1
            if self._steady_t0 is None:
                self._sync()
                if self._first_t0 is None:
                    # the first update includes the lazy set-up (kernel
                    # build, cuDNN plans)
                    self._first_t0 = time.monotonic()
                    self._first_updates0 = self.updates
                    self._first_frames0 = self.frames_consumed
                if all(f > 0 for f in self.pool.frames):
                    # every worker is past its set-up and producing
                    self._steady_t0 = time.monotonic()
                    self._steady_updates0 = self.updates
                    self._steady_frames0 = self.frames_consumed
            if on_update is not None:
                on_update(self.updates, published, self.metrics,
                          self.telemetry_snapshot)
        # snapshot before teardown: pool.join waits out in-flight unrolls
        # and put timeouts, which would pad the steady-state dt
        self._sync()
        return self.telemetry_snapshot()

    # ------------------------------------------------------------------

    def published_host(self) -> PyTree:
        """The latest published params as host numpy leaves in the JAX
        layout (the checkpoint format's)."""
        params, _version, ready = self.store.pull_ready()
        if ready is not None:
            ready.synchronize()
        return params_lib.to_jax(params)
