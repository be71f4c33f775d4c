"""The actor loop bodies (``repro.distributed.runner``), two modes:

``run_actor_loop`` is the paper's self-contained actor (§3). Pull the
current params, run one n-step unroll against a private env batch, stamp
the trajectory with the parameter version it was acted with, hand it to
the transport.

``run_inference_driver_loop`` is the dynamic-batching variant (§3.1) for
thread actors: one thread drives every logical actor, which holds no
parameters. It steps each actor's env batch on the host, as CPU tensors,
submits every actor's per-step observation batch to the shared
``InferenceService`` (the policy forward runs there, on the learner's
device), and assembles the replies into the unroll's trajectory layout,
as numpy (``assemble_inference_traj``), which the learner stages through
its pinned ``_HostStager``.

On the card each actor thread issues its work on a CUDA stream of its
own, so waiting for its trajectory never waits for the learner's kernels
(or another actor's), and three hand-overs between streams are made
explicit:

* params: the store hands out, beside each published tree, the event
  the learner recorded after writing it; the actor's stream waits for it
  before the unroll reads the tree;
* the trajectory: the actor copies ``rewards`` and ``done`` to pinned
  host memory, records an event after the unroll and waits for it on
  the host (the JAX actor's ``block_until_ready``). So what is emitted is
  finished work, and the learner reads the episode returns without
  touching the device. ``torch.cuda.synchronize()`` is never called
  here: it would wait for the whole device;
* memory: the trajectory's tensors were allocated on the actor's
  stream; the learner marks them used on its own stream
  (``record_stream``) before it reads them (``Learner``).

Randomness: each actor's ``torch.Generator`` is seeded from (run seed
with the restart epoch folded in, global actor id), in place of the JAX
actor's ``fold_in(key(seed), actor_id)``. The id is the *global* slot id,
so an actor's stream does not depend on how slots are sharded.

In inference mode each logical actor's env draws come from a CPU
``torch.Generator`` seeded the same way.

The serialized entries (``run_serialized_unroll_actor``,
``run_serialized_inference_actor`` and the spawn targets
``process_actor_main`` / ``inference_actor_main``) run an actor on the
far side of a byte boundary: a spawned child process (shm transport) or
a remote machine (socket transport). The child acts on the CPU: it sets
``CUDA_VISIBLE_DEVICES`` empty before anything could touch the card, so
it never creates a CUDA context nor loads the kernels, and it pins torch
to one thread, so N children do not each start one OpenMP thread per
core and take the host from the learner, whose launches set the pace.
Its seeds follow the thread actors' ``actor_seed`` scheme, so a thread
run and a process run with the same seed act out the same per-actor
randomness.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import serde
from repro_torch.distributed.serde import TrajectoryItem

PyTree = Any

# the trajectory leaves the learner reads on the host (episode returns)
HOST_KEYS = ("rewards", "done")


def actor_seed(seed: int, actor_id: int) -> int:
    """The generator seed of actor ``actor_id`` in a run seeded ``seed``:
    distinct for each (seed, id), the same in every run."""
    return int(np.random.SeedSequence((seed, actor_id, 1)).generate_state(
        1)[0])


def run_actor_loop(
    *,
    actor_id: int,
    builder: Tuple[Callable, Callable],
    seed: int,
    pull_params: Callable[[], Optional[Tuple[PyTree, int, Any]]],
    emit: Callable[[Any], bool],
    should_stop: Callable[[], bool],
    on_unroll: Optional[Callable[[], None]] = None,
    device="cpu",
) -> None:
    """Drive one actor until ``should_stop`` or a channel closes.

    ``pull_params`` returns (params, version, ready event or None), or
    None on shutdown. ``emit`` owns backpressure/retry/accounting and
    returns False only when the worker should exit. ``on_unroll`` fires
    after each finished unroll: the hook for frame counters.

    ``REPRO_TRACE_EVERY`` > 0 samples every Nth unroll for the flight
    recorder: the item carries a stamp dict (``u0``/``u1`` here; the serde
    and transport layers add theirs downstream). The rate travels in the
    environment so that spawned actor children inherit it; 0 disables."""
    trace_every = _trace_every()
    device = torch.device(device)
    init_fn, unroll = builder
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    # no torch.cuda call at all on the CPU: an actor child must not
    # create a CUDA context
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        carry = init_fn(actor_seed(seed, actor_id))
        idx = 0
        while not should_stop():
            pulled = pull_params()
            if pulled is None:
                break
            params, version, ready = pulled
            idx += 1
            sampled = bool(trace_every) and idx % trace_every == 0
            u0 = time.monotonic() if sampled else 0.0
            if ready is not None:
                stream.wait_event(ready)
            carry, traj = unroll(params, carry)
            host = _finish(traj, stream)
            if on_unroll is not None:
                on_unroll()
            now = time.monotonic()
            tr = {"u0": u0, "u1": now} if sampled else None
            item = TrajectoryItem(traj, version, actor_id, now, tr,
                                  host=host)
            if not emit(item):
                break


def _trace_every() -> int:
    """The flight recorder's sampling rate, from the ``REPRO_TRACE_EVERY``
    environment variable (0 when unset or not an integer)."""
    try:
        return int(os.environ.get("REPRO_TRACE_EVERY", "0"))
    except ValueError:
        return 0


def _finish(traj: Dict, stream) -> Dict[str, np.ndarray]:
    """Materialise the trajectory before it is emitted (backpressure must
    reflect finished work) and return its host leaves."""
    if stream is None:
        return {k: traj[k].numpy() for k in HOST_KEYS}
    pinned = {}
    for k in HOST_KEYS:
        x = traj[k]
        pinned[k] = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        pinned[k].copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    done.synchronize()
    return {k: v.numpy() for k, v in pinned.items()}


# ---------------------------------------------------------------------------
# inference mode: host-side env stepping against the shared service


def assemble_inference_traj(steps: List[dict], boot: dict,
                            init_lstm: Tuple[Any, Any], icfg) -> dict:
    """Package one unroll's per-step records into the learner's
    trajectory layout — the shape ``core.actor``'s ``_finalize``
    produces (batch-major arrays, the bootstrap step appended to the
    observation-side keys, the unroll's *initial* LSTM state attached).
    Every leaf is numpy.

    ``steps[t]`` keys: obs_image/last_action/last_reward/done_in (the
    step's *inputs*), action/reward/done/behaviour_logprob (its
    outputs). ``boot``: the post-final-step obs_image/last_action/
    last_reward/done."""
    def col(k):
        return np.stack([np.asarray(s[k]) for s in steps], axis=1)

    def col_boot(k, final):
        return np.concatenate([col(k), np.asarray(final)[:, None]],
                              axis=1)

    step_dones = col("done")
    return {
        "actions": col("action"),
        "rewards": col("reward"),
        "discounts": (icfg.discount *
                      (1.0 - step_dones.astype(np.float32))
                      ).astype(np.float32),
        "behaviour_logprob": col("behaviour_logprob"),
        "done": step_dones,
        "obs_image": col_boot("obs_image", boot["obs_image"]),
        "last_action": col_boot("last_action", boot["last_action"]),
        "last_reward": col_boot("last_reward", boot["last_reward"]),
        "done_in": col_boot("done_in", boot["done"]),
        "lstm_state": (np.asarray(init_lstm[0]),
                       np.asarray(init_lstm[1])),
    }


class _ActingState:
    """Per logical-actor carry for the inference acting loop: everything
    the threaded layout would keep on an actor thread's stack."""

    __slots__ = ("uid", "client", "gen", "state", "obs_image", "last_action",
                 "last_reward", "done", "h", "c", "steps", "version",
                 "handle")


def _make_inference_env_fns(env, n: int):
    """The two env drivers of the inference acting loop: batches of n
    envs stepped on the host as CPU tensors, observations out as numpy
    (views of the tensors)."""

    def reset_batch(gen: torch.Generator):
        state = env.reset(n, gen, "cpu")
        return state, env.observe(state)

    def step_batch(state, action: np.ndarray, gen: torch.Generator):
        state, ts = env.step(state, torch.from_numpy(action),
                             env.draw(n, gen, "cpu"))
        return state, (ts.obs_image.numpy(), ts.reward.numpy(),
                       ts.done.numpy())

    return reset_batch, step_batch


def _init_acting_state(uid: int, gen_seed: int, reset_batch, arch_cfg,
                       n: int, client=None) -> _ActingState:
    st = _ActingState()
    st.uid = uid
    st.client = client
    st.gen = torch.Generator().manual_seed(gen_seed)
    st.state, ts = reset_batch(st.gen)
    st.obs_image = ts.obs_image.numpy()
    st.last_action = np.zeros((n,), np.int32)
    st.last_reward = np.zeros((n,), np.float32)
    st.done = np.zeros((n,), bool)
    st.h = np.zeros((n, arch_cfg.lstm_width), np.float32)
    st.c = np.zeros((n, arch_cfg.lstm_width), np.float32)
    return st


def _acting_request(st: _ActingState) -> dict:
    return {"obs_image": st.obs_image, "last_action": st.last_action,
            "last_reward": st.last_reward, "done": st.done,
            "lstm_h": st.h, "lstm_c": st.c}


def _acting_boot(st: _ActingState) -> dict:
    return {"obs_image": st.obs_image, "last_action": st.last_action,
            "last_reward": st.last_reward, "done": st.done}


def _record_reply_and_step(st: _ActingState, reply, step_batch) -> None:
    """The per-step bookkeeping: stamp the first-step version, advance
    the recurrent state from the reply, step the envs, record the step,
    carry forward."""
    if st.version is None:
        st.version = reply.param_version
    action = reply.action
    st.h, st.c = reply.lstm_state
    st.state, (obs_image, reward, step_done) = step_batch(st.state, action,
                                                          st.gen)
    st.steps.append({
        "obs_image": st.obs_image, "last_action": st.last_action,
        "last_reward": st.last_reward, "done_in": st.done,
        "action": action, "reward": reward, "done": step_done,
        "behaviour_logprob": reply.logprob})
    st.obs_image = obs_image
    st.last_action = action
    st.last_reward = reward
    st.done = step_done


def run_inference_driver_loop(
    *,
    actor_ids: List[int],
    env,
    arch_cfg,
    icfg,
    num_envs: int,
    seed: int,
    service,
    emit: Callable[[int, Any], bool],
    should_stop: Callable[[], bool],
    on_unroll: Optional[Callable[[int], None]] = None,
) -> None:
    """Drive ALL thread-mode inference actors from one thread
    (``repro.distributed.runner.run_inference_driver_loop``).

    Under the GIL, per-actor threads buy an inference-mode actor
    nothing: the service does the policy compute, and what remains is
    glue that N threads would only serialize, paying a wake-up per actor
    per step. This driver multiplexes the logical actors instead: submit
    every actor's per-step request, run the flush inline
    (``service.drive_flushes``: one copy to the card, one forward, one
    copy back), step every actor's envs on the host, repeat.

    Each logical actor keeps the identity it has under the per-thread
    layout: its own env batch, its own generator (seeded from (seed,
    actor id)), its own trajectory stream stamped with its id and with
    the param version of its unroll's first step. Emits block on
    transport backpressure, which stalls all acting.

    ``REPRO_TRACE_EVERY`` samples every Nth unroll (per logical actor) for
    the flight recorder, as in ``run_actor_loop``."""
    trace_every = _trace_every()
    t_len = icfg.unroll_length
    reset_batch, step_batch = _make_inference_env_fns(env, num_envs)
    actors = [_init_acting_state(aid, actor_seed(seed, aid), reset_batch,
                                 arch_cfg, num_envs) for aid in actor_ids]
    unroll_idx = 0
    while not should_stop():
        unroll_idx += 1
        sampled = bool(trace_every) and unroll_idx % trace_every == 0
        u0 = time.monotonic() if sampled else 0.0
        init_lstm = {a.uid: (a.h, a.c) for a in actors}
        for a in actors:
            a.steps = []
            a.version = None
        for _ in range(t_len):
            for a in actors:
                a.handle = service.submit_async(_acting_request(a))
                if a.handle is None:
                    return                  # service shut down
            service.drive_flushes()
            for a in actors:
                reply = service.wait(a.handle)
                if reply is None:
                    return
                _record_reply_and_step(a, reply, step_batch)

        for a in actors:
            traj = assemble_inference_traj(a.steps, _acting_boot(a),
                                           init_lstm[a.uid], icfg)
            if on_unroll is not None:
                on_unroll(a.uid)
            now = time.monotonic()
            tr = {"u0": u0, "u1": now} if sampled else None
            if not emit(a.uid, TrajectoryItem(traj, a.version, a.uid,
                                              now, tr)):
                return


def _stream_seed(seed: int, actor_id: int, stream: int,
                 n_streams: int) -> int:
    """Generator seed of one pipeline stream of an inference actor: the
    thread driver's ``actor_seed`` for a single stream, so both backends
    act out the same randomness; one stream of its own per stream
    otherwise."""
    if n_streams == 1:
        return actor_seed(seed, actor_id)
    return int(np.random.SeedSequence(
        (seed, actor_id, 2, stream)).generate_state(1)[0])


def _concat_trajs(trajs: List[Any]) -> Any:
    """Recombine per-stream trajectories along the batch axis."""
    t0 = trajs[0]
    if isinstance(t0, dict):
        return {k: _concat_trajs([t[k] for t in trajs]) for k in t0}
    if isinstance(t0, tuple):
        return tuple(_concat_trajs([t[i] for t in trajs])
                     for i in range(len(t0)))
    return np.concatenate(trajs, axis=0)


def run_inference_actor_loop(
    *,
    actor_id: int,
    env,
    arch_cfg,
    icfg,
    num_envs: int,
    seed: int,
    clients: List[Any],
    emit: Callable[[Any], bool],
    should_stop: Callable[[], bool],
    on_unroll: Optional[Callable[[], None]] = None,
) -> None:
    """Drive one *inference-mode* actor of a process or remote pool:
    host-side env stepping against the shared batched-inference service.

    ``clients`` is one service client per **pipeline stream**: the env
    batch is split evenly across them, and the streams are
    software-pipelined: while one stream's request is in flight (in a
    flush on the learner's card), the actor steps the other stream's
    envs. With a single client the loop is the plain submit/step
    alternation. Each client exposes ``submit_async(request) -> handle |
    None``, ``wait(handle) -> InferenceReply | None`` (None: the service
    shut down), ``infer`` and ``pause``/``resume``.

    The emitted trajectory recombines the streams along the batch axis in
    the unroll actor's layout (``assemble_inference_traj``), numpy
    throughout, and is stamped with the oldest first-step param version
    across streams, so measured lag stays conservative.

    ``REPRO_TRACE_EVERY`` samples every Nth unroll for the flight
    recorder, as in ``run_actor_loop``: ``u0``/``u1`` bracket the whole
    acting round (env steps and inference round trips)."""
    trace_every = _trace_every()
    t_len = icfg.unroll_length
    n_streams = len(clients)
    if num_envs % n_streams:
        raise ValueError(f"num_envs={num_envs} must divide evenly over "
                         f"{n_streams} pipeline streams")
    n_sub = num_envs // n_streams
    reset_batch, step_batch = _make_inference_env_fns(env, n_sub)
    streams = [
        _init_acting_state(s, _stream_seed(seed, actor_id, s, n_streams),
                           reset_batch, arch_cfg, n_sub, client=client)
        for s, client in enumerate(clients)]

    unroll_idx = 0
    while not should_stop():
        unroll_idx += 1
        sampled = bool(trace_every) and unroll_idx % trace_every == 0
        u0 = time.monotonic() if sampled else 0.0
        init_lstm = [(st.h, st.c) for st in streams]
        for st in streams:
            st.steps = []
            st.version = None
            if n_streams > 1:
                st.handle = st.client.submit_async(_acting_request(st))
        for t in range(t_len):
            for st in streams:
                if n_streams > 1:
                    # while this wait blocks, the other streams' requests
                    # are pending service-side and our env step below
                    # overlaps their flush
                    reply = st.client.wait(st.handle)
                else:
                    reply = st.client.infer(_acting_request(st))
                if reply is None:
                    return              # service shut down mid-unroll
                _record_reply_and_step(st, reply, step_batch)
                if n_streams > 1 and t + 1 < t_len:
                    st.handle = st.client.submit_async(_acting_request(st))
        trajs = [assemble_inference_traj(st.steps, _acting_boot(st),
                                         init_lstm[s], icfg)
                 for s, st in enumerate(streams)]
        traj = trajs[0] if n_streams == 1 else _concat_trajs(trajs)
        version = min(st.version for st in streams)
        if on_unroll is not None:
            on_unroll()
        now = time.monotonic()
        tr = {"u0": u0, "u1": now} if sampled else None
        if not emit(TrajectoryItem(traj, version, actor_id, now, tr)):
            break


# ---------------------------------------------------------------------------
# serialized-actor scaffolding, shared by the pipe (process) and socket
# (remote) backends: the loop bodies above never see the wire; what
# varies is how params arrive (``pull_msg``) and where encoded trajectory
# buffers go (``send_buf``)


class _ParamSlots:
    """The child's two parameter trees, filled in place by the subscriber
    thread and handed to the unroll by ``pull``. A tree handed out stays
    unwritten until the next ``pull`` (the unroll reads it throughout),
    so each new version is decoded into the *other* tree, under the lock
    ``pull`` takes: an unroll never sees a torn tree."""

    def __init__(self):
        self._lock = threading.Lock()
        self._trees: List[Any] = []
        self._current = -1      # index of the newest tree
        self._in_use = -1       # index handed to the unroll
        self.version = -1

    def install(self, buf: bytes, version: int) -> None:
        with self._lock:
            # the tree not handed out (before any pull: not the newest)
            held = self._in_use if self._in_use >= 0 else self._current
            target = 1 - held if held >= 0 else 0
            try:
                if not self._trees:
                    raise serde.SerdeError("no tree yet")
                serde.decode_tree_into(buf, self._trees[target])
            except serde.SerdeError:
                # first version, or a structure change: allocate anew
                tree, _ = serde.decode_tree(buf, copy=True)
                self._trees = [_tensor_tree(tree), _tensor_tree(tree)]
                self._in_use = -1
                target = 0
            self._current = target
            self.version = version

    def pull(self) -> Optional[Tuple[Any, int]]:
        with self._lock:
            if self._current < 0:
                return None
            self._in_use = self._current
            return self._trees[self._current], self.version


def _tensor_tree(tree):
    """A decoded numpy tree as CPU tensors that own their memory."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensor_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return torch.from_numpy(np.array(tree))


def _encode_stamped(item: TrajectoryItem, wire_codec: str) -> bytes:
    """``serde.encode_item``, with a sampled item's encode start stamped
    (``e0``) on a copy of its trace; serde stamps ``e1`` itself once the
    payload bytes are built."""
    if item.trace is not None:
        item = dataclasses.replace(item, trace=dict(item.trace,
                                                    e0=time.monotonic()))
    return serde.encode_item(item, codec=wire_codec)


def _run_sender(stop, encode: Callable[[Any], bytes],
                send_buf: Callable[[bytes], bool]):
    """A *sender* thread owning encode + send behind a depth-1 outbox:
    deep enough to overlap the send with the next unroll, shallow enough
    that wire backpressure stalls the actor within two trajectories.
    Returns (emit, close)."""
    import queue as stdlib_queue

    outbox: stdlib_queue.Queue = stdlib_queue.Queue(maxsize=1)

    def send_loop():
        while True:
            try:
                item = outbox.get(timeout=0.1)
            except stdlib_queue.Empty:
                if stop.is_set():
                    return
                continue
            if item is None or not send_buf(encode(item)):
                return              # done, or the channel says so

    snd = threading.Thread(target=send_loop, daemon=True,
                           name="traj-sender")
    snd.start()

    def offer(item, on_block=None) -> bool:
        blocked = False
        try:
            while not stop.is_set():
                try:
                    outbox.put(item, timeout=0.1)
                    return True
                except stdlib_queue.Full:
                    if not blocked and on_block is not None:
                        blocked = True
                        on_block(True)
                    continue        # wire backpressure reached us
        finally:
            if blocked:
                on_block(False)
        return False

    def close():
        try:
            outbox.put_nowait(None)
        except stdlib_queue.Full:
            pass
        snd.join(timeout=5.0)

    return offer, close


def run_serialized_unroll_actor(*, actor_id: int, env_name: str,
                                arch_cfg, icfg, num_envs: int, seed: int,
                                send_buf: Callable[[bytes], bool],
                                pull_msg: Callable[[int], Optional[Tuple]],
                                stop, wire_codec: str = "none") -> None:
    """One unroll-mode actor on the far side of a serialized boundary,
    acting on the CPU.

    ``pull_msg(have_version)`` returns ``("params", version, buf)``,
    ``("keep",)``, ``("stop",)`` or None (a pipe wrapper or a socket
    pull); a channel error also means stop. ``send_buf(buf)`` blocks
    until the encoded trajectory is accepted by the wire and returns
    False only when shutting down. ``stop`` is any Event-alike with
    ``is_set``/``wait``.

    The unroll stays on the critical path alone: a *subscriber* thread
    refreshes the params in the background (at most every 0.1 s; the
    loop never waits on the channel once the first version landed), and
    a sender thread owns encode + send (``_run_sender``)."""
    import threading

    from repro_torch.core import actor as actor_lib
    from repro_torch.data.envs import make_env

    env = make_env(env_name)
    builder = actor_lib.build_actor(env, arch_cfg, icfg, num_envs, "cpu")
    slots = _ParamSlots()
    fresh = threading.Event()

    def subscribe():
        # version-gated pub/sub: ask for anything newer than we hold (a
        # "keep" reply costs one tiny message), at a bounded rate; params
        # are at most ``interval`` stale, the off-policy gap V-trace
        # corrects
        interval = 0.1
        while not stop.is_set():
            try:
                msg = pull_msg(slots.version)
            except (EOFError, OSError, BrokenPipeError, ValueError):
                break               # the channel closed under us
            if msg is None or msg[0] == "stop":
                break
            if msg[0] == "params":
                _, version, buf = msg
                # a retried pull can deliver a stale queued reply: never
                # step the behaviour policy backwards
                if version > slots.version:
                    slots.install(buf, version)
                    fresh.set()
            if stop.wait(interval):
                break
        fresh.set()                 # wake a pull that waits for params

    def pull_params():
        while not fresh.wait(timeout=0.2):
            if stop.is_set():
                return None
        got = slots.pull()
        if got is None:
            return None             # the subscriber died before params
        return got[0], got[1], None

    def encode(item):
        return _encode_stamped(item, wire_codec)

    emit, close = _run_sender(stop, encode, send_buf)
    sub = threading.Thread(target=subscribe, daemon=True,
                           name="param-subscriber")
    sub.start()
    try:
        run_actor_loop(actor_id=actor_id, builder=builder, seed=seed,
                       pull_params=pull_params, emit=emit,
                       should_stop=stop.is_set, device="cpu")
    finally:
        close()


def run_serialized_inference_actor(*, actor_id: int, env_name: str,
                                   arch_cfg, icfg, num_envs: int,
                                   seed: int,
                                   send_buf: Callable[[bytes], bool],
                                   infer_clients: List[Any], stop,
                                   wire_codec: str = "none") -> None:
    """One inference-mode actor on the far side of a serialized boundary:
    no parameters, no policy network, env stepping plus frames both ways
    (observation requests up, action replies down, finished trajectories
    out through ``send_buf``). ``infer_clients`` is one service client
    per pipeline stream (pipe- or socket-backed; same surface). While
    wire backpressure blocks the sender, the clients are paused, so the
    service does not hold the others' batches for this actor."""
    from repro_torch.data.envs import make_env

    for cl in infer_clients:
        cl.bind_stop(stop)
    env = make_env(env_name)

    def encode(item):
        return _encode_stamped(item, wire_codec)

    def on_block(blocked: bool) -> None:
        for cl in infer_clients:
            cl.pause() if blocked else cl.resume()

    offer, close = _run_sender(stop, encode, send_buf)
    try:
        run_inference_actor_loop(
            actor_id=actor_id, env=env, arch_cfg=arch_cfg, icfg=icfg,
            num_envs=num_envs, seed=seed, clients=infer_clients,
            emit=lambda item: offer(item, on_block),
            should_stop=stop.is_set)
    finally:
        close()
        for cl in infer_clients:
            cl.close()


# ---------------------------------------------------------------------------
# process worker entry points (spawn targets: module-level)


def _tune_child_scheduling(actor_id: int) -> None:
    """Keep an actor child on the CPU and out of the learner's way. It
    hides the card (``CUDA_VISIBLE_DEVICES`` empty) before anything could
    initialise CUDA, runs torch on one thread, yields to the learner
    (``nice`` +3; ``REPRO_ACTOR_NICE`` overrides) and sticks to one core
    chosen by its *global* slot id (``REPRO_ACTOR_PIN=0`` turns that
    off)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    nice_step = int(os.environ.get("REPRO_ACTOR_NICE", "3"))
    if nice_step:
        try:
            os.nice(nice_step)
        except OSError:  # pragma: no cover
            pass
    if os.environ.get("REPRO_ACTOR_PIN", "1") == "1":
        try:
            ncpu = os.cpu_count() or 1
            os.sched_setaffinity(0, {actor_id % ncpu})
        except (AttributeError, OSError):  # pragma: no cover
            pass


def _wire_send_buf(producer, stop_event) -> Callable[[bytes], bool]:
    """Adapt a ``ShmProducer``-style offer-with-timeout handle to the
    blocking ``send_buf`` contract of the serialized actor bodies."""
    def send_buf(buf: bytes) -> bool:
        while not stop_event.is_set():
            if producer.send(buf, timeout=0.1):
                return True
        return False
    return send_buf


def process_actor_main(actor_id: int, env_name: str, arch_cfg, icfg,
                       num_envs: int, seed: int, producer, param_conn,
                       stop_event, wire_codec: str = "none") -> None:
    """Entry point of one actor *process*: subscribes to params by version
    from the parent's param server over the pipe, and ships serde-encoded
    trajectories through the wire (``run_serialized_unroll_actor``,
    shared with the socket backend). A failure is reported up the pipe
    as a traceback."""
    try:
        _tune_child_scheduling(actor_id)

        def pull_msg(have_version):
            param_conn.send(("pull", actor_id, have_version))
            return param_conn.recv()

        run_serialized_unroll_actor(
            actor_id=actor_id, env_name=env_name, arch_cfg=arch_cfg,
            icfg=icfg, num_envs=num_envs, seed=seed,
            send_buf=_wire_send_buf(producer, stop_event),
            pull_msg=pull_msg, stop=stop_event, wire_codec=wire_codec)
    except BaseException:
        try:
            param_conn.send(("error", actor_id, traceback.format_exc()))
        except (EOFError, OSError, BrokenPipeError):
            pass
    finally:
        try:
            param_conn.close()
        except OSError:
            pass


def inference_actor_main(actor_id: int, env_name: str, arch_cfg, icfg,
                         num_envs: int, seed: int, producer, infer_clients,
                         ctrl_conn, stop_event,
                         wire_codec: str = "none") -> None:
    """Entry point of one *inference-mode* actor process: env stepping
    plus serde frames both ways (observation requests up the service's
    shared wire, action replies down per-stream pipes, trajectories
    through the transport wire). ``ctrl_conn`` carries error reports
    only: the service owns the params."""
    try:
        _tune_child_scheduling(actor_id)
        run_serialized_inference_actor(
            actor_id=actor_id, env_name=env_name, arch_cfg=arch_cfg,
            icfg=icfg, num_envs=num_envs, seed=seed,
            send_buf=_wire_send_buf(producer, stop_event),
            infer_clients=infer_clients, stop=stop_event,
            wire_codec=wire_codec)
    except BaseException:
        try:
            ctrl_conn.send(("error", actor_id, traceback.format_exc()))
        except (EOFError, OSError, BrokenPipeError):
            pass
    finally:
        try:
            ctrl_conn.close()
        except OSError:
            pass
