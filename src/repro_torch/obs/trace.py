"""Sampled per-trajectory lifecycle tracing across process boundaries (the
port's own copy of ``repro.obs.trace``).

A sampled trajectory carries a ``trace`` dict of CLOCK_MONOTONIC stamps
in its ``TrajectoryItem`` (and through the serde meta when it crosses a
wire):

    u0 / u1   env unroll start / end (actor side, actor's clock)
    e0 / e1   serde encode start / end (actor side; ``serde.encode_item``
              stamps e1 itself, *after* the payload bytes are built, so
              the stamp can still ride in the header it closes)
    r         receipt into the learner-side policy queue (stamped by
              ``TrajectoryQueue._accept`` — uniform across the inproc,
              shm, and socket transports)

The learner adds its own loop stamps (dequeue, batch collect, train
step, publish) and the recorder folds each sampled item into the seven
lifecycle spans::

    env_unroll -> serde_encode -> transport -> queue_wait
               -> batch_collect -> train_step -> publish

Clock normalization reuses the socket transport's learner-clock
precedent: CLOCK_MONOTONIC is comparable across processes on one box,
so same-box stamps need no shift. When actor and learner clocks
visibly disagree (different machines — the send/receive gap exceeds
``CLOCK_SKEW_S``), the actor-side stamps are shifted so the send
coincides with the learner's receive stamp: every span lands on the
learner's clock, at the cost of folding the (unknowable one-way) wire
latency into the transport span's start.

Export is Chrome trace-event JSON (``{"traceEvents": [...]}``, complete
"X" events, microsecond timestamps) — loadable in Perfetto or
chrome://tracing. Each actor renders as its own process row; the
learner's spans render under the learner row.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

SPAN_NAMES = ("env_unroll", "serde_encode", "transport", "queue_wait",
              "batch_collect", "train_step", "publish")

# gradient-exchange rounds render on their own process row (pid 2):
# hub_wait (round open -> last contribution in), reduce (mean + encode),
# broadcast (fan the mean back out to every live spoke)
EXCHANGE_SPAN_NAMES = ("hub_wait", "reduce", "broadcast")

# same-box monotonic clocks agree to microseconds; a send->receive gap
# beyond this means a different clock domain (another machine)
CLOCK_SKEW_S = 5.0


class TraceRecorder:
    """Collects sampled trajectories' spans; bounded, thread-safe."""

    def __init__(self, max_trajectories: int = 2048):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._pids_named: set = set()
        self._max = max_trajectories
        self.recorded = 0
        self.dropped = 0

    # ------------------------------------------------------------------

    def _name_pid(self, pid: int, name: str) -> None:
        if pid in self._pids_named:
            return
        self._pids_named.add(pid)
        self._events.append({"name": "process_name", "ph": "M",
                             "pid": pid, "tid": 0,
                             "args": {"name": name}})

    def record_item(self, item, *, dequeued: float, collected: float,
                    step0: float, step1: float, published: float,
                    lag: Optional[int] = None) -> None:
        """Fold one sampled item (its actor-side ``trace`` stamps plus
        the learner's loop stamps, all seconds CLOCK_MONOTONIC) into
        trace events. Safe to call with partial stamps — missing actor
        stamps degrade to zero-length spans, never to an exception."""
        tr = getattr(item, "trace", None)
        if tr is None:
            return
        with self._lock:
            if self.recorded >= self._max:
                self.dropped += 1
                return
            self.recorded += 1

            r = tr.get("r", dequeued)
            u1 = tr.get("u1", r)
            u0 = tr.get("u0", u1)
            e0 = tr.get("e0", u1)
            e1 = tr.get("e1", e0)
            # learner-clock normalization: shift actor stamps only when
            # the clocks visibly disagree (cross-machine)
            off = (r - e1) if abs(r - e1) > CLOCK_SKEW_S else 0.0
            u0, u1, e0, e1 = (t + off for t in (u0, u1, e0, e1))

            actor_pid = 1000 + int(item.actor_id)
            self._name_pid(actor_pid, f"actor-{item.actor_id}")
            self._name_pid(1, "learner")

            spans = (
                ("env_unroll", actor_pid, u0, u1),
                ("serde_encode", actor_pid, e0, e1),
                ("transport", actor_pid, e1, r),
                ("queue_wait", 1, r, dequeued),
                ("batch_collect", 1, dequeued, collected),
                ("train_step", 1, collected if step0 is None else step0,
                 step1),
                ("publish", 1, step1, published),
            )
            args = {"actor_id": int(item.actor_id),
                    "param_version": int(item.param_version)}
            if lag is not None:
                args["lag"] = int(lag)
            for name, pid, t0, t1 in spans:
                self._events.append({
                    "name": name, "ph": "X", "pid": pid, "tid": 0,
                    "ts": t0 * 1e6,
                    "dur": max(0.0, (t1 - t0) * 1e6),
                    "args": args,
                })

    def record_exchange_round(self, round_idx: int, *, enter: float,
                              gathered: float, reduced: float,
                              done: float) -> None:
        """Fold one gradient-exchange round (hub-side CLOCK_MONOTONIC
        stamps) into hub_wait -> reduce -> broadcast spans on the
        ``exchange`` row. A failover round shows up as an oversized
        hub_wait span followed by a gap in the round numbering."""
        with self._lock:
            if self.recorded >= self._max:
                self.dropped += 1
                return
            self.recorded += 1
            self._name_pid(2, "exchange")
            args = {"round": int(round_idx)}
            for name, t0, t1 in (("hub_wait", enter, gathered),
                                 ("reduce", gathered, reduced),
                                 ("broadcast", reduced, done)):
                self._events.append({
                    "name": name, "ph": "X", "pid": 2, "tid": 0,
                    "ts": t0 * 1e6,
                    "dur": max(0.0, (t1 - t0) * 1e6),
                    "args": args,
                })

    # ------------------------------------------------------------------

    def chrome_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def export(self, path: str) -> int:
        """Write ``{"traceEvents": [...]}``; returns the number of
        sampled trajectories recorded."""
        with self._lock:
            doc = {"traceEvents": list(self._events),
                   "displayTimeUnit": "ms"}
            n = self.recorded
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return n
