"""Deterministic policy-lag stand-in (``repro.core.queue.LagController``).

The JAX controller keeps references to past (immutable) param trees. The
port's optimizer updates parameters in place, so a reference would
silently follow the learner and the lag would drop to 0: each
``on_update`` keeps a detached snapshot instead.
"""
from __future__ import annotations

import collections
from typing import Any, Deque

from repro_torch.params import snapshot

Tree = Any


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
