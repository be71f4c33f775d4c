"""The actor loop body (``repro.distributed.runner.run_actor_loop``): the
paper's self-contained actor (§3). Pull the current params, run one
n-step unroll against a private env batch, stamp the trajectory with the
parameter version it was acted with, hand it to the transport.

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

The inference-mode and serialized loops come with the inference service
and the process pools (ROADMAP.md, Queue 1 items 9 and 10).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

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
