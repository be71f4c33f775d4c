"""Episode-return accounting from trajectory streams (the port's own copy
of ``repro.core.metrics.EpisodeTracker``)."""
from __future__ import annotations

from typing import List

import numpy as np


class EpisodeTracker:
    """Accumulates per-env episode returns from (reward, done) streams."""

    def __init__(self, num_envs: int):
        self.running = np.zeros(num_envs)
        self.completed: List[float] = []

    def update(self, rewards: np.ndarray, dones: np.ndarray) -> None:
        """rewards/dones: (B, T)."""
        rewards = np.asarray(rewards)
        dones = np.asarray(dones)
        for t in range(rewards.shape[1]):
            self.running += rewards[:, t]
            ended = dones[:, t]
            if ended.any():
                self.completed.extend(self.running[ended].tolist())
                self.running[ended] = 0.0

    def mean_return(self, last_n: int = 100) -> float:
        if not self.completed:
            return float("nan")
        return float(np.mean(self.completed[-last_n:]))
