"""Evaluation metrics (the port's own copy of ``repro.core.metrics``):
the mean capped and the median human-normalised scores (paper §5.3 /
Appendix B, Table 4) and episode-return accounting from trajectory
streams."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def capped_normalised_score(scores: Sequence[float],
                            human: Sequence[float],
                            random: Sequence[float]) -> float:
    """(1/N) sum_t min(1, (s_t - r_t) / (h_t - r_t)) — Table B.1 footer."""
    vals = []
    for s, h, r in zip(scores, human, random):
        denom = max(h - r, 1e-9)
        vals.append(min(1.0, (s - r) / denom))
    return float(np.mean(vals))


def median_normalised_score(scores: Sequence[float],
                            human: Sequence[float],
                            random: Sequence[float]) -> float:
    """Median human-normalised score (Atari-57 protocol, Table 4)."""
    vals = [(s - r) / max(h - r, 1e-9)
            for s, h, r in zip(scores, human, random)]
    return float(np.median(vals))


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
