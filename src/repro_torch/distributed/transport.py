"""The trajectory transport interface (``repro.distributed.transport``):
one put/get/backpressure/counters API that the learner and the actor
pools are written against.

  InprocTransport   the in-process deque. Items are live trajectory
                    trees (tensors on the device) handed between threads:
                    zero-copy, no serde.
  ShmTransport      a cross-process transport. Producers (actor
                    processes, or threads exercising the byte boundary)
                    move only serde-encoded contiguous buffers, each over
                    a one-way pipe of its own with a bound on the buffers
                    in flight; a parent-side drain thread decodes them
                    (numpy leaves, which the learner stages through its
                    pinned buffers) and applies the backpressure policy
                    in a local ``TrajectoryQueue``.
  SocketTransport   (``socket_transport.py``) the same buffers as
                    CRC-checked frames over TCP.

Backpressure composes across the wire: with the ``block`` policy a slow
learner stalls the drain thread, a producer's buffers in flight reach
their bound, and its ``send``s time out in *its* process. With the drop
policies the drain thread never blocks for long, and loss accounting
happens where the policy lives.

The wire is kill-safe (``repro.distributed.transport`` shares one
``multiprocessing.Queue`` among its producers; this port does not): a
producer SIGKILLed in the middle of a write would leave a torn message in
a shared pipe and die holding the queue's write lock, and every other
producer would then block for ever. Here a dead producer's pipe reaches
end-of-file, its torn tail is dropped with it, and no lock is shared.

Attribution hooks (all optional, parent-side):
  on_item(item)     decoded item accepted into the local queue
  on_reject(item)   decoded item rejected by drop_newest
  on_drop(item)     queued item evicted by drop_oldest
"""
from __future__ import annotations

import abc
import multiprocessing as mp
import threading
from multiprocessing import connection as mp_connection
from typing import Any, Callable, Dict, List, Optional

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


# Linux's F_SETPIPE_SZ: a producer's pipe holds a whole trajectory, so a
# send with a credit in hand does not block in the middle of its write
_F_SETPIPE_SZ, _PIPE_BYTES = 1031, 1 << 20


class ShmProducer:
    """Picklable producer handle for a ``ShmTransport``: what an actor
    process receives. Moves opaque byte buffers over its own one-way pipe;
    ``credits`` (a semaphore the drain releases once a buffer is read)
    bounds its buffers in flight."""

    def __init__(self, conn: Any, credits: Any, stop_event: Any):
        self._conn = conn
        self._credits = credits
        self._stop = stop_event

    def send(self, buf: bytes, timeout: float = 0.1) -> bool:
        """Offer one encoded buffer; False = wire full (retry) or
        shutting down (check ``stopped``)."""
        if self._stop.is_set():
            return False
        if not self._credits.acquire(timeout=timeout):
            return False
        try:
            self._conn.send_bytes(buf)
            return True
        except (ValueError, OSError):        # wire closed under us
            return False

    def close(self) -> None:
        """Drop this process's end of the pipe. The parent does so once a
        child holds its copy: the child's exit then reads as end-of-file."""
        self._conn.close()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()


class ShmTransport(Transport):
    """Cross-process transport: serialized buffers over one bounded pipe a
    producer, decoded and policy-filtered parent-side.

    The parent (learner) side is a full ``Transport``; producers use
    either ``put`` (same-process threads: encode + wire) or a picklable
    ``producer()`` handle (an actor process: wire only, the caller
    encodes; one handle a process, its parent end closed once the child
    started). ``wire_capacity`` is a producer's buffers in flight. The
    context is ``spawn``: children never inherit the parent's CUDA
    state."""

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
        self._credit = wire_capacity or max(1, capacity // 8)
        # reader end -> the credits its producer spends
        self._chans: Dict[Any, Any] = {}
        self._chan_lock = threading.Lock()
        self._local: Optional[ShmProducer] = None   # ``put``'s channel
        self._put_lock = threading.Lock()
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
        """A new channel: its own pipe and credits, read by the drain."""
        reader, writer = self._ctx.Pipe(duplex=False)
        try:
            import fcntl
            fcntl.fcntl(writer.fileno(), _F_SETPIPE_SZ, _PIPE_BYTES)
        except (ImportError, OSError):
            pass                # the default pipe size: writes may block
        credits = self._ctx.BoundedSemaphore(self._credit)
        with self._chan_lock:
            self._chans[reader] = credits
        return ShmProducer(writer, credits, self._stop)

    def put(self, item: TrajectoryItem, timeout: Optional[float] = None,
            count_stall: bool = True) -> bool:
        """Same-process producer path: encode and offer to the wire.
        False means the wire is full (retry) or the transport is closed;
        drop_newest rejections surface via ``on_reject``, not here."""
        if self._stop.is_set():
            return False
        buf = serde.encode_item(item, codec=self.wire_codec)
        with self._put_lock:
            if self._local is None:
                self._local = self.producer()
            if self._local.send(buf, timeout=0.1 if timeout is None
                                else timeout):
                return True
        if count_stall and not self._stop.is_set():
            self.wire_put_stalls += 1
        return False

    # ------------------------------------------------------------------
    # drain: wire bytes -> decoded items -> policy queue

    def _recv(self) -> List[bytes]:
        """One buffer from each producer that has one ready (every ready
        producer gets its turn, so a busy one cannot starve the others),
        after at most 0.1 s of waiting. A producer whose pipe ended (its
        process exited or was killed, a torn last buffer included) is
        dropped."""
        with self._chan_lock:
            readers = list(self._chans)
        if not readers:
            self._stop.wait(0.1)
            return []
        bufs = []
        for reader in mp_connection.wait(readers, timeout=0.1):
            try:
                buf = reader.recv_bytes()
            except (EOFError, OSError):
                with self._chan_lock:
                    self._chans.pop(reader, None)
                reader.close()
                continue
            with self._chan_lock:
                credits = self._chans.get(reader)
            if credits is not None:
                credits.release()
            bufs.append(buf)
        return bufs

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            for buf in self._recv():
                self._take(buf)

    def _take(self, buf: bytes) -> None:
        """Decode one buffer and offer it to the local policy queue."""
        self.wire_received += 1
        self.wire_bytes += len(buf)
        if self._discard:
            return      # shutdown: keep the wire flowing, drop data
        try:
            item = serde.decode_item(buf)
        except Exception as e:      # a torn or corrupt buffer
            self.drain_errors.append(repr(e))
            return
        self.wire_raw_bytes += serde.tree_nbytes(item.data)
        while not self._stop.is_set() and not self._discard:
            if self._inner.put(item, timeout=0.1):
                if self.on_item is not None:
                    self.on_item(item)
                return
            # the closed check comes first: a put that failed because
            # close()/begin_shutdown() raced us is shutdown discard, not a
            # drop_newest rejection to charge to the actor
            if self._inner.closed or self._discard:
                return
            if self._inner.policy == "drop_newest":
                if self.on_reject is not None:
                    self.on_reject(item)
                return                      # genuine policy rejection
            # block policy: local queue full, learner slow: stall here so
            # the wire fills and producers feel it

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
        always finish their writes. The local queue closes so the learner
        drains what is left and stops. Call this before joining producer
        processes; call ``close`` after."""
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
        # a producer still writing sees a broken pipe, not a hang
        with self._chan_lock:
            readers, self._chans = list(self._chans), {}
        for reader in readers:
            reader.close()
        if self._local is not None:
            self._local.close()

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
