"""The trajectory transport interface (``repro.distributed.transport``):
one put/get/backpressure/counters API that the learner and the actor
pools are written against.

  InprocTransport   the in-process deque. Items are live trajectory
                    trees (tensors on the device) handed between threads:
                    zero-copy, no serde.

The cross-process transports (``shm``, and ``socket`` for actors on other
machines) are not ported yet (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Optional

from repro_torch.distributed.tqueue import TrajectoryQueue

TRANSPORTS = ("inproc", "shm", "socket")


class Transport(abc.ABC):
    """Bounded MPMC trajectory channel with a backpressure policy.

    ``rejects_at_put`` tells producers whether a ``put`` returning False
    under drop_newest means *this item was rejected* (in-process queue)
    or merely *the wire is momentarily full, retry* (cross-process
    transport, where policy decisions happen at the drain side and are
    reported through the attribution hooks).
    """

    capacity: int
    policy: str
    rejects_at_put = True

    @abc.abstractmethod
    def put(self, item: Any, timeout: Optional[float] = None,
            count_stall: bool = True) -> bool: ...

    @abc.abstractmethod
    def get(self, timeout: Optional[float] = None) -> Optional[Any]: ...

    @abc.abstractmethod
    def get_nowait(self) -> Optional[Any]: ...

    @abc.abstractmethod
    def requeue_front(self, item: Any) -> None: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    @property
    @abc.abstractmethod
    def closed(self) -> bool: ...

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def snapshot(self) -> Dict[str, Any]: ...


class InprocTransport(TrajectoryQueue, Transport):
    """The in-process transport: the bounded deque, unchanged. Items stay
    live trees: no serialization, no copies."""


# TrajectoryQueue satisfies the interface structurally; let
# isinstance(queue, Transport) hold for plain instances too.
Transport.register(TrajectoryQueue)


def make_transport(kind: str, capacity: int, policy: str,
                   **kw: Any) -> Transport:
    """``kw`` passes transport-specific options through (the registry)."""
    if kind == "inproc":
        return InprocTransport(capacity, policy, **kw)
    if kind in ("shm", "socket"):
        raise NotImplementedError(
            f"transport {kind!r} is not ported yet (ROADMAP.md, Queue 1 "
            f"item 10: process and socket actor pools)")
    raise ValueError(f"transport must be one of {TRANSPORTS}, got {kind!r}")
