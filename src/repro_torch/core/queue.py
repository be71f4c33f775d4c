"""Host-side trajectory ring buffer and deterministic lag stand-in
(``repro.core.queue``).

``TrajectoryQueue`` is a *single-threaded* ring buffer and
``LagController`` replays a parameter history to impose an exact,
reproducible policy lag: the tools for an experiment that needs the
off-policy gap as a controlled variable. The concurrent pipeline (actor
threads, backpressure policies, measured lag) lives in
``repro_torch.distributed``.

The JAX controller keeps references to past (immutable) param trees. The
port's optimizer updates parameters in place, so a reference would
silently follow the learner and the lag would drop to 0: each
``on_update`` keeps a detached snapshot instead. The queue keeps
references: an unroll returns a fresh set of tensors each time, which
nothing updates in place afterwards.
"""
from __future__ import annotations

import collections
from typing import Any, Deque, Optional

from repro_torch.params import snapshot

Tree = Any


class TrajectoryQueue:
    """A ring of at most ``capacity`` trajectory trees, held by
    reference (not snapshots: see the module's docstring)."""

    def __init__(self, capacity: int = 16):
        self._q: Deque[Tree] = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.pushed = 0

    def put(self, traj: Tree) -> bool:
        """Append; returns True iff ``traj`` is now in the queue (always,
        for this ring: the contract of ``repro_torch.distributed``'s
        queue). A full ring evicts its oldest entry, counted in
        ``dropped`` *before* the deque discards it."""
        if len(self._q) == self._q.maxlen:
            self.dropped += 1
        self._q.append(traj)
        self.pushed += 1
        return True

    def get(self) -> Optional[Tree]:
        return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)


class LagController:
    """Serves actor parameters k learner-updates behind (policy lag)."""

    def __init__(self, lag: int, params: Tree):
        self.lag = max(0, lag)
        self._hist: Deque[Tree] = collections.deque(maxlen=self.lag + 1)
        self._hist.append(snapshot(params))

    def on_update(self, params: Tree) -> None:
        self._hist.append(snapshot(params))

    def actor_params(self) -> Tree:
        return self._hist[0]
