"""The trajectory transport interface (``repro.distributed.transport``):
one put/get/backpressure/counters API that the learner and the actor
pools are written against.

  InprocTransport   the in-process deque. Items are live trajectory
                    trees (tensors on the device) handed between threads:
                    zero-copy, no serde.
  ShmTransport      a cross-process transport. Producers (actor
                    processes, or threads exercising the byte boundary)
                    move only serde-encoded contiguous buffers through a
                    bounded ``multiprocessing`` wire queue; a parent-side
                    drain thread decodes them (numpy leaves, which the
                    learner stages through its pinned buffers) and
                    applies the backpressure policy in a local
                    ``TrajectoryQueue``.
  SocketTransport   (``socket_transport.py``) the same buffers as
                    CRC-checked frames over TCP.

Backpressure composes across the wire: with the ``block`` policy a slow
learner stalls the drain thread, the wire queue fills, and producer
``put``s time out in *their* process. With the drop policies the drain
thread never blocks for long, and loss accounting happens where the
policy lives.

Attribution hooks (all optional, parent-side):
  on_item(item)     decoded item accepted into the local queue
  on_reject(item)   decoded item rejected by drop_newest
  on_drop(item)     queued item evicted by drop_oldest
"""
from __future__ import annotations

import abc
import multiprocessing as mp
import queue as stdlib_queue
import threading
from typing import Any, Callable, Dict, Optional

from repro_torch.distributed import serde
from repro_torch.distributed.serde import TrajectoryItem
from repro_torch.distributed.supervise import KillSafeEvent
from repro_torch.distributed.tqueue import POLICIES, TrajectoryQueue

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


class ShmProducer:
    """Picklable producer handle for a ``ShmTransport``: what an actor
    process receives. Moves opaque byte buffers."""

    def __init__(self, wire: Any, stop_event: Any):
        self._wire = wire
        self._stop = stop_event

    def send(self, buf: bytes, timeout: float = 0.1) -> bool:
        """Offer one encoded buffer; False = wire full (retry) or
        shutting down (check ``stopped``)."""
        if self._stop.is_set():
            return False
        try:
            self._wire.put(buf, timeout=timeout)
            return True
        except stdlib_queue.Full:
            return False
        except (ValueError, OSError):        # wire closed under us
            return False

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()


class ShmTransport(Transport):
    """Cross-process transport: serialized buffers over a bounded
    ``multiprocessing`` queue, decoded and policy-filtered parent-side.

    The parent (learner) side is a full ``Transport``; producers use
    either ``put`` (same-process threads: encode + wire) or the picklable
    ``producer()`` handle (actor processes: wire only, the caller
    encodes). The context is ``spawn``: children never inherit the
    parent's CUDA state."""

    rejects_at_put = False

    def __init__(self, capacity: int = 8, policy: str = "block",
                 wire_capacity: Optional[int] = None, registry=None,
                 wire_codec: str = serde.DEFAULT_CODEC):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got "
                             f"{policy!r}")
        self.capacity = capacity
        self.policy = policy
        # producers encode with this codec: same-process ``put`` applies
        # it here; actor processes receive it in their spawn arguments
        self.wire_codec = serde.check_codec(wire_codec)
        self._ctx = mp.get_context("spawn")
        # kill-safe: a SIGKILLed child holding mp.Event's lock would
        # deadlock close()
        self._stop = KillSafeEvent(self._ctx)
        self._wire = self._ctx.Queue(
            maxsize=wire_capacity or max(2, capacity // 4))
        self._inner = TrajectoryQueue(capacity, policy, registry=registry)
        self.registry = self._inner.registry
        self.on_item: Optional[Callable[[TrajectoryItem], None]] = None
        self.on_reject: Optional[Callable[[TrajectoryItem], None]] = None
        self._closed = False
        self._discard = False
        self._close_lock = threading.Lock()
        self.wire_received = 0          # buffers decoded parent-side
        self.wire_bytes = 0             # payload volume moved
        self.wire_raw_bytes = 0         # raw leaf bytes those carried
        self.wire_put_stalls = 0        # parent-side put timeouts
        self.drain_errors: list = []    # decode failures
        self._drain = threading.Thread(target=self._drain_loop,
                                       name="shm-drain", daemon=True)
        self._drain.start()

    # eviction attribution passes straight through to the local queue

    @property
    def on_drop(self):
        return self._inner.on_drop

    @on_drop.setter
    def on_drop(self, fn):
        self._inner.on_drop = fn

    # ------------------------------------------------------------------
    # producer side

    def producer(self) -> ShmProducer:
        return ShmProducer(self._wire, self._stop)

    def put(self, item: TrajectoryItem, timeout: Optional[float] = None,
            count_stall: bool = True) -> bool:
        """Same-process producer path: encode and offer to the wire.
        False means the wire is full (retry) or the transport is closed;
        drop_newest rejections surface via ``on_reject``, not here."""
        if self._stop.is_set():
            return False
        buf = serde.encode_item(item, codec=self.wire_codec)
        try:
            self._wire.put(buf, timeout=timeout)
            return True
        except stdlib_queue.Full:
            if count_stall:
                self.wire_put_stalls += 1
            return False
        except (ValueError, OSError):
            return False

    # ------------------------------------------------------------------
    # drain: wire bytes -> decoded items -> policy queue

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            try:
                buf = self._wire.get(timeout=0.1)
            except stdlib_queue.Empty:
                continue
            except (EOFError, OSError):
                break
            self.wire_received += 1
            self.wire_bytes += len(buf)
            if self._discard:
                continue    # shutdown: keep the wire flowing, drop data
            try:
                item = serde.decode_item(buf)
            except Exception as e:      # a torn or corrupt buffer
                self.drain_errors.append(repr(e))
                continue
            self.wire_raw_bytes += serde.tree_nbytes(item.data)
            while not self._stop.is_set() and not self._discard:
                if self._inner.put(item, timeout=0.1):
                    if self.on_item is not None:
                        self.on_item(item)
                    break
                # the closed check comes first: a put that failed because
                # close()/begin_shutdown() raced us is shutdown discard,
                # not a drop_newest rejection to charge to the actor
                if self._inner.closed or self._discard:
                    break
                if self._inner.policy == "drop_newest":
                    if self.on_reject is not None:
                        self.on_reject(item)
                    break                   # genuine policy rejection
                # block policy: local queue full, learner slow — stall
                # here so the wire fills and producers feel it

    # ------------------------------------------------------------------
    # consumer side: delegate to the local policy queue

    def get(self, timeout: Optional[float] = None):
        return self._inner.get(timeout)

    def get_nowait(self):
        return self._inner.get_nowait()

    def requeue_front(self, item: TrajectoryItem) -> None:
        self._inner.requeue_front(item)

    # ------------------------------------------------------------------

    def begin_shutdown(self) -> None:
        """Enter discard mode: the drain thread keeps *consuming* the
        wire but drops everything, so producer processes winding down can
        always flush their queue feeders (a feeder killed mid-write into a
        full pipe would tear a frame). The local queue closes so the
        learner drains what is left and stops. Call this before joining
        producer processes; call ``close`` after."""
        self._discard = True
        self._inner.close()

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self.begin_shutdown()
        self._stop.set()
        self._drain.join(timeout=5.0)
        # sweep whatever raced past the drain thread, then release the
        # queue's feeder resources without waiting on it at exit
        try:
            while True:
                self._wire.get_nowait()
        except (stdlib_queue.Empty, EOFError, OSError):
            pass
        self._wire.close()
        self._wire.cancel_join_thread()

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def __len__(self) -> int:
        return len(self._inner)

    def snapshot(self) -> Dict[str, Any]:
        snap = self._inner.snapshot()
        snap.update({
            "transport": "shm",
            "wire_codec": self.wire_codec,
            "wire_received": self.wire_received,
            "wire_bytes": self.wire_bytes,
            "traj_wire_bytes": self.wire_bytes,
            "traj_raw_bytes": self.wire_raw_bytes,
            "bytes_per_frame": (self.wire_bytes / self.wire_received
                                if self.wire_received else 0.0),
            "wire_compression": (self.wire_raw_bytes / self.wire_bytes
                                 if self.wire_bytes else 1.0),
            "wire_put_stalls": self.wire_put_stalls,
            "drain_errors": len(self.drain_errors),
        })
        return snap


def make_transport(kind: str, capacity: int, policy: str,
                   **kw: Any) -> Transport:
    """``kw`` passes transport-specific options through (the registry,
    the wire codec, the socket transport's listen address)."""
    if kind == "inproc":
        return InprocTransport(capacity, policy, **kw)
    if kind == "shm":
        return ShmTransport(capacity, policy, **kw)
    if kind == "socket":
        # its own module, so this one stays light for producer children
        from repro_torch.distributed.socket_transport import SocketTransport
        return SocketTransport(capacity, policy, **kw)
    raise ValueError(f"transport must be one of {TRANSPORTS}, got {kind!r}")
