"""The asynchronous actor-learner runtime (``repro.distributed``), as far
as the port goes: thread, process and remote actors in unroll or
inference mode, the in-process, shm and socket transports, one learner,
and learner groups over the hub/spoke gradient exchange (paper §3).

  serde            ``TrajectoryItem`` and the wire format: codecs, frames
  tqueue           the bounded queue with three backpressure policies
  transport        put/get/backpressure/counters behind one interface;
                   the in-process deque and the shm wire
  socket_transport the same buffers as CRC-framed TCP messages
  runner           the actor loop bodies: unroll, the inference driver,
                   and the serialized (process / remote) entries
  actor_pool       ``ActorPool``: thread actors, each on its own CUDA
                   stream, or one inference driver thread
  procpool         ``ProcessActorPool`` / ``SocketActorPool``: spawned
                   CPU children over shm, or actors dialing over TCP
  netserve         what a remote machine needs: the CONFIG handshake's
                   JSON, the service over sockets, the actor entries
  inference        ``InferenceService``: the dynamic-batching policy
                   forward, with thread and process frontends
  paramstore       versioned publish/pull (live, or serialized once a
                   version), with the event a reader waits for
  supervise        the ``Supervisor`` restart ledger, ``RestartPolicy``,
                   restart seeds and the kill-safe stop flag
  learner          the ``Learner``: dynamic batch collection, train step,
                   versioned publish, telemetry
  group            learner groups: N learner processes over disjoint
                   actor-slot shards, gradients mean-reduced over the
                   framed channel (``GradHub`` + ``SpokeExchange``, the
                   stale-grad drop rule), one publisher numbering the
                   versions; supervised, ``ResilientExchange`` fails a
                   dead hub over to a survivor
  runtime          composition root: build env/store/service/transport/
                   pool and run one ``Learner`` over them
"""
from repro_torch.distributed.actor_pool import ActorPool
from repro_torch.distributed.group import (GradHub, GradientExchange,
                                           GroupTracker, NullExchange,
                                           ResilientExchange, SpokeExchange,
                                           merge_telemetry,
                                           run_group_training, shard_slots)
from repro_torch.distributed.learner import Learner, MultiTracker
from repro_torch.distributed.paramstore import ParameterStore
from repro_torch.distributed.procpool import (ProcessActorPool,
                                              SocketActorPool)
from repro_torch.distributed.runner import (run_actor_loop,
                                            run_inference_actor_loop)
from repro_torch.distributed.runtime import ACTOR_MODES, run_async_training
from repro_torch.distributed.serde import TrajectoryItem
from repro_torch.distributed.supervise import (KillSafeEvent, RestartPolicy,
                                               Supervisor,
                                               fold_restart_seed)
from repro_torch.distributed.tqueue import POLICIES, TrajectoryQueue
from repro_torch.distributed.transport import (TRANSPORTS, InprocTransport,
                                               ShmTransport, Transport,
                                               make_transport)

__all__ = ["ACTOR_MODES", "ActorPool", "GradHub", "GradientExchange",
           "GroupTracker", "InprocTransport", "KillSafeEvent", "Learner",
           "MultiTracker", "NullExchange", "POLICIES", "ParameterStore",
           "ProcessActorPool", "ResilientExchange", "RestartPolicy",
           "ShmTransport", "SocketActorPool", "SpokeExchange", "Supervisor",
           "TRANSPORTS", "TrajectoryItem", "TrajectoryQueue", "Transport", "fold_restart_seed",
           "make_transport", "merge_telemetry", "run_actor_loop",
           "run_async_training", "run_group_training",
           "run_inference_actor_loop", "shard_slots"]
