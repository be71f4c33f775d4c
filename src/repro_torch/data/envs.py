"""Batched environments on the device (``repro.data.envs``): catch, rooms,
tmaze, chase and bandit.

The JAX envs are per-env functions that ``vmap`` batches; these step all
B envs at once with tensor ops, on whatever device the state lives.

API: ``reset(n, gen, device) -> state`` draws n fresh states from an
explicit ``torch.Generator``; ``draw(n, gen, device)`` makes a step's
random draws, which the JAX envs make from a per-step key inside
``step``: the fresh states to auto-reset into and, for chase, the bot's
sideways move; ``step(state, action, draws) -> (state, TimeStep)`` takes
them, steps, and selects the fresh states where ``done`` is set;
``observe(state)`` renders a state. For every env but chase the draws
are the fresh states themselves (``draw`` is ``reset``). Observations
come as a token id in ``[0, vocab_size)`` and a rendered uint8 image
(B, H, W, 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch

State = Any


class TimeStep(NamedTuple):
    obs_token: torch.Tensor    # (B,) int32
    obs_image: torch.Tensor    # (B, H, W, 3) uint8
    reward: torch.Tensor       # (B,) f32
    done: torch.Tensor         # (B,) bool  (episode ended at this transition)


@dataclasses.dataclass(frozen=True)
class Env:
    name: str
    num_actions: int
    vocab_size: int
    image_hw: Tuple[int, int, int]
    reset: Callable[[int, torch.Generator, Any], State]
    draw: Callable[[int, torch.Generator, Any], Any]
    step: Callable[[State, torch.Tensor, Any], Tuple[State, TimeStep]]
    observe: Callable[[State], TimeStep]


def _select(done, fresh, nxt):
    """Per env, the fresh state where ``done`` is set, else ``nxt``."""
    def pick(f, x):
        return torch.where(done.view((-1,) + (1,) * (x.dim() - 1)), f, x)
    return type(nxt)(*(pick(f, x) for f, x in zip(fresh, nxt)))


def _randint(high: int, shape, gen: torch.Generator, device, low: int = 0):
    if isinstance(shape, int):
        shape = (shape,)
    return torch.randint(low, high, shape, generator=gen, device=device,
                         dtype=torch.int32)


def _paint(img, r, c, channel: int, value: int = 255):
    img[torch.arange(img.shape[0], device=img.device), r.long(), c.long(),
        channel] = value
    return img


def _timestep(token, img, reward, done) -> TimeStep:
    """A TimeStep; ``reward`` None renders an observation (zero reward,
    no done)."""
    if reward is None:
        reward = torch.zeros(token.shape[0], dtype=torch.float32,
                             device=token.device)
        done = torch.zeros(token.shape[0], dtype=torch.bool,
                           device=token.device)
    return TimeStep(token.to(torch.int32), img, reward, done)


# the grid moves of rooms and chase: up, down, left, right, stay
_MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1), (0, 0))


def _move(pos, action, n: int):
    moves = torch.tensor(_MOVES, dtype=torch.int32, device=pos.device)
    return torch.clamp(pos + moves[action.long()], 0, n - 1)


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
        token = (s.ball_r * cols + s.ball_c) * cols + s.paddle
        img = torch.zeros((s.ball_r.shape[0],) + hw, dtype=torch.uint8,
                          device=s.ball_r.device)
        _paint(img, s.ball_r, s.ball_c, 0)
        _paint(img, torch.full_like(s.paddle, rows - 1), s.paddle, 1)
        return _timestep(token, img, reward, done)

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

    return Env("catch", 3, rows * cols * cols, hw, reset, reset, step, _obs)


# ---------------------------------------------------------------------------
# rooms (gridworld collection)


class RoomsState(NamedTuple):
    pos: torch.Tensor        # (B, 2) int32
    objects: torch.Tensor    # (B, num_objects, 2) int32
    alive: torch.Tensor      # (B, num_objects) bool
    t: torch.Tensor          # (B,) int32


def make_rooms(n: int = 7, num_objects: int = 4, horizon: int = 80) -> Env:
    hw = (n, n, 3)

    def _obs(s: RoomsState, reward=None, done=None) -> TimeStep:
        b, dev = s.t.shape[0], s.t.device
        ncol = torch.sum(~s.alive, dim=1, dtype=torch.int32)
        token = (s.pos[:, 0] * n + s.pos[:, 1]) + n * n * ncol
        img = torch.zeros((b,) + hw, dtype=torch.uint8, device=dev)
        _paint(img, s.pos[:, 0], s.pos[:, 1], 1)
        # the JAX env scatters 255 or 0 at every object's cell, duplicate
        # cells included; co-located objects are hit together, so their
        # alive flags agree and a cell is 255 iff an alive object lies on
        # it. Painted as that any(), never as a scatter with duplicate
        # indices, whose order a CUDA index_put_ does not fix
        cell = torch.arange(n, device=dev, dtype=torch.int32)
        at_r = s.objects[:, :, 0, None] == cell            # (B, K, n)
        at_c = s.objects[:, :, 1, None] == cell
        on = (at_r[:, :, :, None] & at_c[:, :, None, :]
              & s.alive[:, :, None, None]).any(dim=1)       # (B, n, n)
        img[:, :, :, 0] = on.to(torch.uint8) * 255
        return _timestep(token, img, reward, done)

    def reset(b, gen, device="cpu"):
        pos = _randint(n, (b, 2), gen, device)
        objects = _randint(n, (b, num_objects, 2), gen, device)
        return RoomsState(pos, objects,
                          torch.ones((b, num_objects), dtype=torch.bool,
                                     device=device),
                          torch.zeros(b, dtype=torch.int32, device=device))

    def step(s: RoomsState, action, fresh: RoomsState):
        pos = _move(s.pos, action, n)
        hit = s.alive & torch.all(s.objects == pos[:, None], dim=2)
        reward = torch.sum(hit, dim=1).to(torch.float32)
        alive = s.alive & ~hit
        t = s.t + 1
        done = (t >= horizon) | ~torch.any(alive, dim=1)
        nxt = _select(done, fresh, RoomsState(pos, s.objects, alive, t))
        return nxt, _obs(nxt, reward, done)

    return Env("rooms", 5, n * n * (num_objects + 1), hw, reset, reset,
               step, _obs)


# ---------------------------------------------------------------------------
# tmaze (memory)


class TmazeState(NamedTuple):
    pos: torch.Tensor
    cue: torch.Tensor    # 0/1
    t: torch.Tensor


def make_tmaze(length: int = 10) -> Env:
    hw = (3, length + 1, 3)

    def _obs(s: TmazeState, reward=None, done=None) -> TimeStep:
        show_cue = s.pos == 0
        token = s.pos * 3 + torch.where(show_cue, s.cue + 1, 0)
        img = torch.zeros((s.pos.shape[0],) + hw, dtype=torch.uint8,
                          device=s.pos.device)
        _paint(img, torch.ones_like(s.pos), s.pos, 1)
        img[:, 0, 0, 2] = torch.where(show_cue, (s.cue + 1) * 100,
                                      0).to(torch.uint8)
        return _timestep(token, img, reward, done)

    def reset(b, gen, device="cpu"):
        zeros = torch.zeros(b, dtype=torch.int32, device=device)
        return TmazeState(zeros, _randint(2, b, gen, device), zeros)

    def step(s: TmazeState, action, fresh: TmazeState):
        action = action.to(torch.int32)
        at_end = s.pos >= length - 1
        # actions: 0 forward, 1 up (choose), 2 down (choose)
        choosing = at_end & (action > 0)
        correct = (action - 1) == s.cue
        reward = torch.where(choosing, torch.where(correct, 1.0, -1.0),
                             0.0).to(torch.float32)
        pos = torch.clamp(s.pos + (action == 0).to(torch.int32), 0,
                          length - 1)
        t = s.t + 1
        done = choosing | (t >= 3 * length)
        nxt = _select(done, fresh, TmazeState(pos, s.cue, t))
        return nxt, _obs(nxt, reward, done)

    return Env("tmaze", 3, (length + 1) * 3, hw, reset, reset, step, _obs)


# ---------------------------------------------------------------------------
# chase (variable-length pursuit; scripted bot)


class ChaseState(NamedTuple):
    agent: torch.Tensor    # (B, 2) int32
    bot: torch.Tensor      # (B, 2) int32
    t: torch.Tensor
    caught: torch.Tensor


class ChaseDraws(NamedTuple):
    """A chase step's draws: the JAX step draws the bot's sideways move
    with its key (``randint(key, (2,), -1, 2)``) and the fresh state
    with ``fold_in(key, 1)``."""
    fresh: ChaseState
    sideways: torch.Tensor    # (B, 2) int32 in {-1, 0, 1}


def make_chase(n: int = 9, horizon: int = 120) -> Env:
    hw = (n, n, 3)

    def _obs(s: ChaseState, reward=None, done=None) -> TimeStep:
        token = ((s.agent[:, 0] * n + s.agent[:, 1]) * n * n
                 + (s.bot[:, 0] * n + s.bot[:, 1]))
        img = torch.zeros((s.t.shape[0],) + hw, dtype=torch.uint8,
                          device=s.t.device)
        _paint(img, s.agent[:, 0], s.agent[:, 1], 1)
        _paint(img, s.bot[:, 0], s.bot[:, 1], 0)
        return _timestep(token, img, reward, done)

    def reset(b, gen, device="cpu"):
        zeros = torch.zeros(b, dtype=torch.int32, device=device)
        return ChaseState(_randint(n, (b, 2), gen, device),
                          _randint(n, (b, 2), gen, device), zeros, zeros)

    def draw(b, gen, device="cpu"):
        return ChaseDraws(reset(b, gen, device),
                          _randint(2, (b, 2), gen, device, low=-1))

    def step(s: ChaseState, action, draws: ChaseDraws):
        agent = _move(s.agent, action, n)
        # the bot runs away along each axis; where it is level with the
        # agent, it moves sideways at random
        delta = torch.sign(s.bot - agent)
        delta = torch.where(delta == 0, draws.sideways, delta)
        bot = torch.clamp(s.bot + delta, 0, n - 1)
        tagged = torch.all(agent == bot, dim=1)
        reward = torch.where(tagged, 1.0, -0.01).to(torch.float32)
        caught = s.caught + tagged.to(torch.int32)
        t = s.t + 1
        # variable-length episodes: ends on 3 tags or the horizon
        done = (caught >= 3) | (t >= horizon)
        nxt = _select(done, draws.fresh, ChaseState(agent, bot, t, caught))
        return nxt, _obs(nxt, reward, done)

    return Env("chase", 5, n * n * n * n, hw, reset, draw, step, _obs)


# ---------------------------------------------------------------------------
# bandit (contextual)


class BanditState(NamedTuple):
    ctx: torch.Tensor


def make_bandit(num_contexts: int = 16, num_actions: int = 4) -> Env:
    hw = (4, 4, 3)

    def _obs(s: BanditState, reward=None, done=None) -> TimeStep:
        img = torch.zeros((s.ctx.shape[0],) + hw, dtype=torch.uint8,
                          device=s.ctx.device)
        _paint(img, s.ctx // 4, s.ctx % 4, 2)
        return _timestep(s.ctx, img, reward, done)

    def reset(n, gen, device="cpu"):
        return BanditState(_randint(num_contexts, n, gen, device))

    def step(s: BanditState, action, fresh: BanditState):
        reward = (action.to(torch.int32) ==
                  s.ctx % num_actions).to(torch.float32)
        done = torch.ones_like(reward, dtype=torch.bool)
        return fresh, _obs(fresh, reward, done)

    return Env("bandit", num_actions, num_contexts, hw, reset, reset, step,
               _obs)


# ---------------------------------------------------------------------------
# registry


ENV_MAKERS = {
    "catch": make_catch,
    "rooms": make_rooms,
    "tmaze": make_tmaze,
    "chase": make_chase,
    "bandit": make_bandit,
}


def make_env(name: str, **kw) -> Env:
    return ENV_MAKERS[name](**kw)


def make_suite(names: Sequence[str] = ("catch", "rooms", "tmaze", "chase",
                                       "bandit")) -> List[Env]:
    """A multi-task suite: one env per name (``data.multitask`` pads them
    to a shared frame and action space)."""
    return [make_env(n) for n in names]
