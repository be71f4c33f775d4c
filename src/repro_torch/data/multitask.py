"""Multi-task suite utilities (``repro.data.multitask``, paper §5.3): wrap
heterogeneous envs to a shared observation frame and action space, so
one agent (one set of weights) trains across tasks with per-task actor
allocation."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.data.envs import Env, TimeStep


def common_frame(envs: Sequence[Env]) -> Tuple[Tuple[int, int, int], int]:
    """(the largest image (H, W, 3), the largest action count)."""
    hw = (max(e.image_hw[0] for e in envs),
          max(e.image_hw[1] for e in envs), 3)
    num_actions = max(e.num_actions for e in envs)
    return hw, num_actions


def padded_env(env: Env, max_hw, num_actions: int) -> Env:
    """Pad images to a common frame (the env's image at the top left);
    clamp out-of-range actions to the env's last action."""
    h, w, _ = env.image_hw

    def fix_ts(ts: TimeStep) -> TimeStep:
        img = torch.zeros((ts.obs_image.shape[0],) + tuple(max_hw),
                          dtype=torch.uint8, device=ts.obs_image.device)
        img[:, :h, :w] = ts.obs_image
        return TimeStep(ts.obs_token, img, ts.reward, ts.done)

    def step(s, a, draws):
        a = torch.clamp(a, max=env.num_actions - 1)
        s, ts = env.step(s, a, draws)
        return s, fix_ts(ts)

    return dataclasses.replace(
        env, num_actions=num_actions, image_hw=tuple(max_hw), step=step,
        observe=lambda s: fix_ts(env.observe(s)))
