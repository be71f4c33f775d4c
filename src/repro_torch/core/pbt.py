"""Population Based Training (paper Appendix F; the port's own copy of
``repro.core.pbt``, numpy only).

Rules implemented exactly as described:
  * burn-in period with no evolution;
  * exploit: pick a random other member; if its fitness is more than an
    absolute 5% higher, copy its weights and hyperparameters;
  * explore: each hyperparameter (entropy cost, learning rate, RMSProp
    eps) is permuted with probability 1/3 by multiplying with 1.2 or
    1/1.2 (unbiased, unlike Jaderberg et al.'s 1.2/0.8) — applied whether
    or not a copy happened.

The controller draws from ``np.random.default_rng(seed)`` in the JAX
controller's order, so the same seed and fitness reports give the same
hyperparameter trajectory, draw for draw. One difference by design: JAX
arrays are immutable, so the reference's exploit may put the source's
tree itself into the copying member's slot; the port's optimizer updates
parameters in place, so the slot gets a copy (``params.copy``), which the
copying member then trains without touching the source's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import params as params_lib

Tree = Any

PERTURBABLE = ("entropy_cost", "learning_rate", "rmsprop_eps")


@dataclasses.dataclass
class PBTMember:
    hypers: Dict[str, float]
    fitness: float = -np.inf
    copied_from: Optional[int] = None


class PBTController:
    def __init__(self, pop_size: int, seed: int = 0,
                 burn_in_steps: int = 0, threshold: float = 0.05,
                 perturb_prob: float = 1.0 / 3.0, factor: float = 1.2,
                 ranges: Optional[Dict[str, Tuple[float, float]]] = None):
        self.rng = np.random.default_rng(seed)
        self.burn_in_steps = burn_in_steps
        self.threshold = threshold
        self.perturb_prob = perturb_prob
        self.factor = factor
        ranges = ranges or {
            # paper Table D.1 (log-uniform; eps categorical approximated)
            "entropy_cost": (5e-5, 1e-2),
            "learning_rate": (5e-6, 5e-3),
            "rmsprop_eps": (1e-7, 1e-1),
        }
        self.members: List[PBTMember] = []
        for _ in range(pop_size):
            h = {k: float(np.exp(self.rng.uniform(np.log(lo), np.log(hi))))
                 for k, (lo, hi) in ranges.items()}
            self.members.append(PBTMember(hypers=h))

    def report_fitness(self, idx: int, fitness: float) -> None:
        self.members[idx].fitness = float(fitness)

    def exploit_explore(self, idx: int, step: int,
                        weights: Optional[List[Tree]]
                        ) -> Tuple[Dict[str, float], bool]:
        """Returns (new hypers for member idx, copied?). ``weights`` is the
        mutable list of per-member parameter trees (tensor leaves); on
        exploit a copy of the source member's tree goes into slot
        ``idx``."""
        m = self.members[idx]
        copied = False
        if step >= self.burn_in_steps and len(self.members) > 1:
            other_idx = int(self.rng.integers(0, len(self.members)))
            while other_idx == idx:
                other_idx = int(self.rng.integers(0, len(self.members)))
            other = self.members[other_idx]
            if other.fitness > m.fitness + self.threshold:
                m.hypers = dict(other.hypers)
                m.copied_from = other_idx
                if weights is not None:
                    weights[idx] = params_lib.copy(weights[other_idx])
                copied = True
        # explore happens whether or not a copy happened (Appendix F)
        for k in PERTURBABLE:
            if k in m.hypers and self.rng.random() < self.perturb_prob:
                mult = (self.factor if self.rng.random() < 0.5
                        else 1.0 / self.factor)
                m.hypers[k] = float(m.hypers[k] * mult)
        return dict(m.hypers), copied

    def best(self) -> int:
        return int(np.argmax([m.fitness for m in self.members]))
