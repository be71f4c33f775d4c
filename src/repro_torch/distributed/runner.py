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
``torch.Generator`` seeded the same way. The serialized loops and the
pipelined inference actor of the process pools come with them (ROADMAP.md,
Queue 1 item 10).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

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
    after each finished unroll: the hook for frame counters."""
    device = torch.device(device)
    init_fn, unroll = builder
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    with torch.cuda.stream(stream):
        carry = init_fn(actor_seed(seed, actor_id))
        while not should_stop():
            pulled = pull_params()
            if pulled is None:
                break
            params, version, ready = pulled
            if ready is not None:
                stream.wait_event(ready)
            carry, traj = unroll(params, carry)
            host = _finish(traj, stream)
            if on_unroll is not None:
                on_unroll()
            item = TrajectoryItem(traj, version, actor_id, time.monotonic(),
                                  host=host)
            if not emit(item):
                break


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

    __slots__ = ("uid", "gen", "state", "obs_image", "last_action",
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


def _init_acting_state(uid: int, seed: int, reset_batch, arch_cfg,
                       n: int) -> _ActingState:
    st = _ActingState()
    st.uid = uid
    st.gen = torch.Generator().manual_seed(actor_seed(seed, uid))
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
    transport backpressure, which stalls all acting."""
    t_len = icfg.unroll_length
    reset_batch, step_batch = _make_inference_env_fns(env, num_envs)
    actors = [_init_acting_state(aid, seed, reset_batch, arch_cfg,
                                 num_envs) for aid in actor_ids]
    while not should_stop():
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
            if not emit(a.uid, TrajectoryItem(traj, a.version, a.uid,
                                              time.monotonic())):
                return
