"""Batched environments on the device (``repro.data.envs``: catch, bandit).

The JAX envs are per-env functions that ``vmap`` batches; these step all
B envs at once with tensor ops, on whatever device the state lives.

API: ``reset(n, gen, device) -> state`` draws n fresh states from an
explicit ``torch.Generator``; ``step(state, action, fresh) -> (state,
TimeStep)`` takes the fresh states to auto-reset into, drawn by the
caller (the JAX envs draw them from a per-step key inside ``step``), and
selects them where ``done`` is set; ``observe(state)`` renders a state.
Observations come as a token id and a rendered uint8 image (B, H, W, 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

State = Any

NOT_PORTED_ENV = ("only catch and bandit are ported (ROADMAP.md, Queue 1: "
                  "the other three envs)")


class TimeStep(NamedTuple):
    obs_token: torch.Tensor    # (B,) int32
    obs_image: torch.Tensor    # (B, H, W, 3) uint8
    reward: torch.Tensor       # (B,) f32
    done: torch.Tensor         # (B,) bool  (episode ended at this transition)


@dataclasses.dataclass(frozen=True)
class Env:
    name: str
    num_actions: int
    image_hw: Tuple[int, int, int]
    reset: Callable[[int, torch.Generator, Any], State]
    step: Callable[[State, torch.Tensor, State], Tuple[State, TimeStep]]
    observe: Callable[[State], TimeStep]


def _select(done, fresh, nxt):
    return type(nxt)(*(torch.where(done, f, x) for f, x in zip(fresh, nxt)))


def _randint(high: int, n: int, gen: torch.Generator, device):
    return torch.randint(0, high, (n,), generator=gen, device=device,
                         dtype=torch.int32)


def _paint(img, r, c, channel: int, value: int = 255):
    img[torch.arange(img.shape[0], device=img.device), r.long(), c.long(),
        channel] = value
    return img


# ---------------------------------------------------------------------------
# catch


class CatchState(NamedTuple):
    ball_r: torch.Tensor
    ball_c: torch.Tensor
    paddle: torch.Tensor
    t: torch.Tensor


def make_catch(rows: int = 10, cols: int = 5) -> Env:
    hw = (rows, cols, 3)

    def _obs(s: CatchState, reward=None, done=None) -> TimeStep:
        n = s.ball_r.shape[0]
        dev = s.ball_r.device
        token = (s.ball_r * cols + s.ball_c) * cols + s.paddle
        img = torch.zeros((n,) + hw, dtype=torch.uint8, device=dev)
        _paint(img, s.ball_r, s.ball_c, 0)
        _paint(img, torch.full_like(s.paddle, rows - 1), s.paddle, 1)
        if reward is None:
            reward = torch.zeros(n, dtype=torch.float32, device=dev)
            done = torch.zeros(n, dtype=torch.bool, device=dev)
        return TimeStep(token.to(torch.int32), img, reward, done)

    def reset(n, gen, device="cpu"):
        zeros = torch.zeros(n, dtype=torch.int32, device=device)
        return CatchState(zeros, _randint(cols, n, gen, device),
                          zeros + cols // 2, zeros)

    def step(s: CatchState, action, fresh: CatchState):
        paddle = torch.clamp(s.paddle + action.to(torch.int32) - 1,
                             0, cols - 1)
        ball_r = s.ball_r + 1
        done = ball_r >= rows - 1
        reward = torch.where(done, torch.where(paddle == s.ball_c, 1.0, -1.0),
                             0.0).to(torch.float32)
        nxt = _select(done, fresh, CatchState(ball_r, s.ball_c, paddle,
                                              s.t + 1))
        return nxt, _obs(nxt, reward, done)

    return Env("catch", 3, hw, reset, step, _obs)


# ---------------------------------------------------------------------------
# bandit (contextual)


class BanditState(NamedTuple):
    ctx: torch.Tensor


def make_bandit(num_contexts: int = 16, num_actions: int = 4) -> Env:
    hw = (4, 4, 3)

    def _obs(s: BanditState, reward=None, done=None) -> TimeStep:
        n = s.ctx.shape[0]
        dev = s.ctx.device
        img = torch.zeros((n,) + hw, dtype=torch.uint8, device=dev)
        _paint(img, s.ctx // 4, s.ctx % 4, 2)
        if reward is None:
            reward = torch.zeros(n, dtype=torch.float32, device=dev)
            done = torch.zeros(n, dtype=torch.bool, device=dev)
        return TimeStep(s.ctx.to(torch.int32), img, reward, done)

    def reset(n, gen, device="cpu"):
        return BanditState(_randint(num_contexts, n, gen, device))

    def step(s: BanditState, action, fresh: BanditState):
        reward = (action.to(torch.int32) ==
                  s.ctx % num_actions).to(torch.float32)
        done = torch.ones_like(reward, dtype=torch.bool)
        return fresh, _obs(fresh, reward, done)

    return Env("bandit", num_actions, hw, reset, step, _obs)


# ---------------------------------------------------------------------------
# registry


ENV_MAKERS = {
    "catch": make_catch,
    "bandit": make_bandit,
}


def make_env(name: str, **kw) -> Env:
    if name not in ENV_MAKERS:
        raise SystemExit(f"--env {name}: {NOT_PORTED_ENV}")
    return ENV_MAKERS[name](**kw)
