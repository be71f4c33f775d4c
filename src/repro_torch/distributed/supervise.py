"""Supervision for the self-healing fleet (``repro.distributed.supervise``):
restart policies and the ledger every pool and group layer shares.

A child death is an event to absorb, not an error to propagate: the pools
ask a ``Supervisor`` whether a dead child may be respawned, the socket
transport reports reaped slot leases to it, and the group runner reports
hub failovers. One object owns the counts, so the telemetry and
``/healthz`` show how many restarts, failovers and lease reaps a run
survived.

Plain stdlib (it runs in the group parent and in pool threads before any
worker touches a device), so the numbers equal the JAX package's copy:
``RestartPolicy.delay_s`` seeds ``random.Random(f"{key}:{epoch}")`` in both.

* **Budget**: at most ``max_restarts`` deaths per child within a sliding
  ``window_s`` window; a child over budget is *exhausted*
  (``record_death`` returns None, the pool raises, ``/healthz`` goes
  unhealthy).
* **Backoff**: restart ``epoch`` N waits ``base * 2**(N-1)`` seconds,
  capped at ``cap``, with deterministic per-(child, epoch) jitter.
* **Seed folding**: a respawned child does not replay its dead
  predecessor's RNG stream; ``fold_restart_seed`` gives the seed of each
  restart epoch.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

_SEED_FOLD_PRIME = 1_000_003


class KillSafeEvent:
    """Minimal ``multiprocessing.Event`` stand-in that survives a
    SIGKILLed sharer.

    ``mp.Event`` guards its flag with a semaphore lock and every
    ``is_set()`` acquires it, so a child killed mid-check dies holding the
    lock, and the parent's own teardown ``set()`` then blocks forever.
    This flag is one shared byte, read and written without locking (a
    single aligned byte store is atomic). ``wait`` polls: fine for a
    once-per-run latch, wrong for anything high-frequency.

    Implements the surface the runtime uses of the real thing: ``is_set``
    / ``set`` / ``clear`` / ``wait(timeout)``. Picklable to ``spawn``
    children as a ``Process`` argument like any sharedctypes object."""

    _POLL_S = 0.05

    def __init__(self, ctx: Optional[Any] = None):
        if ctx is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
        self._flag = ctx.RawValue("b", 0)

    def is_set(self) -> bool:
        return self._flag.value != 0

    def set(self) -> None:
        self._flag.value = 1

    def clear(self) -> None:
        self._flag.value = 0

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not self.is_set():
            if deadline is None:
                time.sleep(self._POLL_S)
                continue
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            time.sleep(min(self._POLL_S, left))
        return True


def fold_restart_seed(seed: int, epoch: int) -> int:
    """Deterministic seed for restart epoch ``epoch`` of a child that
    was originally seeded with ``seed``. Epoch 0 is the first spawn and
    returns ``seed`` unchanged (bit-compatible with unsupervised runs)."""
    if epoch == 0:
        return int(seed)
    return int(seed + epoch * _SEED_FOLD_PRIME) % (2 ** 31 - 1)


@dataclass(frozen=True)
class RestartPolicy:
    """Max restarts per sliding window + exponential backoff with
    jitter. ``jitter`` is the max relative widening of a delay (0.5 =
    up to +50%)."""
    max_restarts: int = 5
    window_s: float = 60.0
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter: float = 0.5

    def delay_s(self, key: str, epoch: int) -> float:
        base = min(self.backoff_base_s * (2 ** max(epoch - 1, 0)),
                   self.backoff_cap_s)
        # deterministic per-(child, epoch) jitter: reproducible runs,
        # but no two children share a phase
        u = random.Random(f"{key}:{epoch}").random()
        return base * (1.0 + self.jitter * u)


@dataclass(frozen=True)
class RestartDecision:
    """What the supervisor grants for one death: the new restart epoch
    and the earliest monotonic time the respawn may happen."""
    key: str
    epoch: int
    delay_s: float
    not_before: float


class _Child:
    __slots__ = ("epoch", "deaths", "pending")

    def __init__(self) -> None:
        self.epoch = 0                      # restart epoch of the LIVE child
        self.deaths: deque = deque()        # monotonic death times (window)
        self.pending: Optional[RestartDecision] = None


class Supervisor:
    """Thread-safe restart ledger shared by every supervised layer.

    The supervisor does not spawn anything itself — pools own their
    spawn mechanics. The contract is:

      decision = sup.record_death("actor-3")    # None => exhausted
      ... wait until decision.not_before, respawn with
      fold_restart_seed(seed, decision.epoch) ...
      sup.note_restarted("actor-3")

    ``record_lease_reap`` / ``record_failover`` + ``note_failover_done``
    are the transport's and group runner's hooks into the same ledger.
    """

    def __init__(self, policy: Optional[RestartPolicy] = None,
                 name: str = "supervisor"):
        self.policy = policy or RestartPolicy()
        self.name = name
        self._lock = threading.Lock()
        self._children: Dict[str, _Child] = {}
        self.restarts = 0
        self.failovers = 0
        self.lease_reaps = 0
        self._restart_in_flight = 0
        self._failover_in_flight = 0
        self._exhausted: List[str] = []

    # -- restart ----------------------------------------------------------

    def record_death(self, key: str) -> Optional[RestartDecision]:
        """A child died. Returns the restart grant, or None when the
        child's restart budget is exhausted (caller should raise)."""
        now = time.monotonic()
        with self._lock:
            child = self._children.setdefault(key, _Child())
            if child.pending is not None:
                return child.pending        # death already being handled
            child.deaths.append(now)
            while child.deaths and \
                    now - child.deaths[0] > self.policy.window_s:
                child.deaths.popleft()
            if len(child.deaths) > self.policy.max_restarts:
                if key not in self._exhausted:
                    self._exhausted.append(key)
                return None
            epoch = child.epoch + 1
            delay = self.policy.delay_s(key, epoch)
            decision = RestartDecision(key=key, epoch=epoch,
                                       delay_s=delay,
                                       not_before=now + delay)
            child.pending = decision
            self._restart_in_flight += 1
            return decision

    def note_restarted(self, key: str) -> None:
        """The respawn happened: the grant is consumed and counted."""
        with self._lock:
            child = self._children.get(key)
            if child is None or child.pending is None:
                return
            child.epoch = child.pending.epoch
            child.pending = None
            self.restarts += 1
            self._restart_in_flight = max(self._restart_in_flight - 1, 0)

    def child_epoch(self, key: str) -> int:
        with self._lock:
            child = self._children.get(key)
            return child.epoch if child is not None else 0

    def restart_epochs(self) -> Dict[str, int]:
        """Live restart epoch per child that ever died (for checkpoint
        extra: a resumed run must not replay a dead child's seeds)."""
        with self._lock:
            return {k: c.epoch for k, c in self._children.items()
                    if c.epoch > 0 or c.pending is not None}

    # -- failover / lease reaps -------------------------------------------

    def record_failover(self) -> None:
        with self._lock:
            self._failover_in_flight += 1

    def note_failover_done(self) -> None:
        with self._lock:
            if self._failover_in_flight > 0:
                self._failover_in_flight -= 1
                self.failovers += 1

    def record_lease_reap(self, key: str) -> None:
        with self._lock:
            self.lease_reaps += 1

    # -- introspection ----------------------------------------------------

    @property
    def exhausted(self) -> List[str]:
        with self._lock:
            return list(self._exhausted)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "restarts": self.restarts,
                "failovers": self.failovers,
                "lease_reaps": self.lease_reaps,
                "restart_in_flight": self._restart_in_flight,
                "failover_in_flight": self._failover_in_flight,
                "restarts_exhausted": list(self._exhausted),
                "epochs": {k: c.epoch
                           for k, c in self._children.items()
                           if c.epoch > 0},
            }
