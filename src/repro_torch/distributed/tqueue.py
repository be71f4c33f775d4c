"""Thread-safe bounded trajectory queue with selectable backpressure (the
port's own copy of ``repro.distributed.tqueue``).

The paper's actors feed a learner-side queue (Fig. 1); what happens when
the learner falls behind is a real systems decision:

  block        producers wait for space — lossless, throttles actors to
               learner speed (TorchBeast's choice; right for equivalence
               runs and benchmarks that must count every frame).
  drop_oldest  evict the stalest queued trajectory — bounds both memory
               AND policy lag; the learner always trains on the freshest
               data (Ape-X-style priority for recency).
  drop_newest  reject the incoming trajectory — keeps FIFO order of what
               was already queued, wastes the newest actor work.

Every outcome is counted (pushed / popped / dropped / stalls) through
the metrics registry, and occupancy is integrated over time (depth ×
seconds at that depth) so a telemetry snapshot reports the true mean
fill level — including the time spent sitting at the current depth —
without a sampler thread.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Dict, Optional

from repro_torch.obs.metrics import Registry

POLICIES = ("block", "drop_oldest", "drop_newest")


class TrajectoryQueue:
    """Bounded MPSC/MPMC queue for trajectory items (any Python object).

    ``on_drop`` (constructor arg or assignable attribute) is called with
    each item *evicted* by drop_oldest, so the producer that made it can
    be charged for the loss — drop_newest rejections are already visible
    to the caller via ``put`` returning False. The callback runs under
    the queue lock: it must be fast and must not re-enter the queue.

    Counters live in a ``repro_torch.obs.metrics.Registry`` (one is created
    when none is passed), written under the queue lock — the same
    serialization the raw ints had — and exposed as read-only properties
    so existing readers (``q.pushed`` etc.) are unchanged.
    """

    def __init__(self, capacity: int = 8, policy: str = "block",
                 on_drop: Optional[Callable[[Any], None]] = None,
                 registry: Optional[Registry] = None,
                 metrics_prefix: str = "queue"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got "
                             f"{policy!r}")
        self.capacity = capacity
        self.policy = policy
        self.on_drop = on_drop
        # Transport contract (this class is registered as one): a put
        # returning False under drop_newest IS the rejection of that item
        self.rejects_at_put = True
        self._q: Deque[Any] = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        # counters (written under the lock; read any time — scalar reads
        # are atomic under the GIL)
        self.registry = registry if registry is not None else Registry()
        p = metrics_prefix
        self._c_pushed = self.registry.counter(f"{p}.pushed")
        self._c_popped = self.registry.counter(f"{p}.popped")
        self._c_dropped = self.registry.counter(f"{p}.dropped")
        self._c_put_stalls = self.registry.counter(f"{p}.put_stalls")
        self._c_get_stalls = self.registry.counter(f"{p}.get_stalls")
        self._g_size = self.registry.gauge(f"{p}.size")
        # time-weighted occupancy: the integral of depth over time.
        # _occ_area accumulates depth * seconds-at-that-depth, ticked
        # before every depth change; snapshot() folds in the open
        # interval at the current depth so the mean never goes stale
        # while the queue just sits there.
        self._occ_area = 0.0
        self._occ_last = time.monotonic()
        self._occ_t0 = self._occ_last

    # ------------------------------------------------------------------
    # counter views (the instruments are the storage)

    @property
    def pushed(self) -> int:
        return self._c_pushed.value

    @property
    def popped(self) -> int:
        return self._c_popped.value

    @property
    def dropped(self) -> int:
        return self._c_dropped.value

    @property
    def put_stalls(self) -> int:
        return self._c_put_stalls.value

    @property
    def get_stalls(self) -> int:
        return self._c_get_stalls.value

    def _occ_tick(self) -> None:
        """Integrate the time spent at the current depth. Call under the
        lock, immediately before any depth change."""
        now = time.monotonic()
        self._occ_area += len(self._q) * (now - self._occ_last)
        self._occ_last = now

    # ------------------------------------------------------------------
    # producer side

    def put(self, item: Any, timeout: Optional[float] = None,
            count_stall: bool = True) -> bool:
        """Enqueue ``item`` under the configured backpressure policy.

        Returns True iff *this item* is now in the queue: False means the
        queue was closed, a blocking put timed out, or drop_newest
        rejected it. drop_oldest always accepts (evicting the stalest
        entry when full). Drops are counted *before* anything is removed,
        so the counter never lags the loss it reports. A producer
        retrying the same item after a timeout should pass
        ``count_stall=False`` so one stalled enqueue counts once, however
        many retries it takes.
        """
        with self._lock:
            if self._closed:
                return False
            if self.policy == "block":
                if len(self._q) >= self.capacity:
                    if count_stall:
                        self._c_put_stalls.inc()
                    if not self._not_full.wait_for(
                            lambda: len(self._q) < self.capacity or
                            self._closed, timeout):
                        return False            # timed out, item not queued
                    if self._closed:
                        return False
                self._accept(item)
                return True
            if len(self._q) >= self.capacity:
                self._c_dropped.inc()
                if self.policy == "drop_newest":
                    return False                # reject the incoming item
                self._occ_tick()
                evicted = self._q.popleft()     # drop_oldest: evict stalest
                if self.on_drop is not None:
                    self.on_drop(evicted)
            self._accept(item)
            return True

    def _accept(self, item: Any) -> None:
        # flight-recorder receive stamp: one place covers every
        # transport, because inproc puts, the shm drain thread, and the
        # socket reader all land accepted items here. setdefault keeps
        # the earliest receipt if a retry loop re-puts the same item.
        tr = getattr(item, "trace", None)
        if tr is not None:
            tr.setdefault("r", time.monotonic())
        self._occ_tick()
        self._q.append(item)
        self._c_pushed.inc()
        self._g_size.set(len(self._q))
        self._not_empty.notify()

    # ------------------------------------------------------------------
    # consumer side

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Dequeue the oldest item; None on timeout or closed-and-empty."""
        with self._lock:
            if not self._q:
                self._c_get_stalls.inc()
                if not self._not_empty.wait_for(
                        lambda: self._q or self._closed, timeout):
                    return None
                if not self._q:
                    return None                 # closed and drained
            self._occ_tick()
            item = self._q.popleft()
            self._c_popped.inc()
            self._g_size.set(len(self._q))
            self._not_full.notify()
            return item

    def get_nowait(self) -> Optional[Any]:
        with self._lock:
            if not self._q:
                return None
            self._occ_tick()
            item = self._q.popleft()
            self._c_popped.inc()
            self._g_size.set(len(self._q))
            self._not_full.notify()
            return item

    def requeue_front(self, item: Any) -> None:
        """Put an already-popped item back at the head (learner-internal:
        dynamic batching took more than it could stack). Not counted as a
        new push; ignores capacity so nothing is lost."""
        with self._lock:
            self._occ_tick()
            self._q.appendleft(item)
            self._c_popped.inc(-1)
            self._g_size.set(len(self._q))
            self._not_empty.notify()

    # ------------------------------------------------------------------

    def close(self) -> None:
        """Wake all blocked producers/consumers; subsequent puts fail and
        gets drain whatever is left."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            # fold in the open interval at the current depth so the mean
            # reflects "now", not just the last depth change (a queue
            # that filled to 2 and then idled must converge to 2, not
            # stay frozen at the put-time running mean)
            now = time.monotonic()
            area = self._occ_area + len(self._q) * (now - self._occ_last)
            elapsed = now - self._occ_t0
            occ = area / elapsed if elapsed > 0 else 0.0
            return {
                "capacity": self.capacity,
                "policy": self.policy,
                "size": len(self._q),
                "pushed": self.pushed,
                "popped": self.popped,
                "dropped": self.dropped,
                "put_stalls": self.put_stalls,
                "get_stalls": self.get_stalls,
                "mean_occupancy": occ,
            }
