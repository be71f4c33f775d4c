"""The asynchronous actor-learner runtime (``repro.distributed``), as far
as the port goes: thread actors in unroll or inference mode, the
in-process transport and one learner (paper §3).

  serde       ``TrajectoryItem``: a trajectory tree plus its provenance
  tqueue      the bounded queue with three backpressure policies
  transport   put/get/backpressure/counters behind one interface
  runner      the actor loop bodies: unroll, and the inference driver
  actor_pool  ``ActorPool``: thread actors, each on its own CUDA stream,
              or one inference driver thread
  inference   ``InferenceService``: the dynamic-batching policy forward
  paramstore  versioned publish/pull, with the event a reader waits for
  learner     the ``Learner``: dynamic batch collection, train step,
              versioned publish, telemetry
  runtime     composition root: build env/store/service/transport/pool and run
              one ``Learner`` over them
"""
from repro_torch.distributed.actor_pool import ActorPool
from repro_torch.distributed.learner import Learner, MultiTracker
from repro_torch.distributed.paramstore import ParameterStore
from repro_torch.distributed.runner import run_actor_loop
from repro_torch.distributed.runtime import ACTOR_MODES, run_async_training
from repro_torch.distributed.serde import TrajectoryItem
from repro_torch.distributed.supervise import fold_restart_seed
from repro_torch.distributed.tqueue import POLICIES, TrajectoryQueue
from repro_torch.distributed.transport import (TRANSPORTS, InprocTransport,
                                               Transport, make_transport)

__all__ = ["ACTOR_MODES", "ActorPool", "InprocTransport", "Learner",
           "MultiTracker", "POLICIES", "ParameterStore", "TRANSPORTS",
           "TrajectoryItem", "TrajectoryQueue", "Transport",
           "fold_restart_seed", "make_transport", "run_actor_loop",
           "run_async_training"]
