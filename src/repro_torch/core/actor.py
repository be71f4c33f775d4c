"""The IMPALA actor (``repro.core.actor``): forward-only policy inference
against batched environments on the device, emitting trajectories of
(x_t, a_t, r_t, mu(a_t|x_t)) (paper §3).

Two agent kinds, as in the JAX package:
  * impala_cnn: conv torso + LSTM; the recurrent state is carried across
    unrolls and shipped with the trajectory (exactly the paper);
  * token backbones: one ``apply_decode`` a step against a decode cache
    of ``unroll + 1`` slots, made anew each unroll (the context is the
    unroll); the trajectory carries the tokens ``obs_token`` (B, T+1).
    On the card each step runs K5 once an attention layer.

The actor's params are *stale* (k learner updates behind); the training
loop controls the lag, which V-trace corrects on the learner. One ``unroll``
call is one n-step trajectory batch. Randomness (action sampling, each
env step's draws) comes from the ``torch.Generator`` in the carry.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ImpalaConfig
from repro_torch.data.envs import Env
from repro_torch.models import backbone as bb
from repro_torch.models import lstm as lstm_lib


class ActorCarry(NamedTuple):
    env_state: Any
    gen: torch.Generator
    obs_token: torch.Tensor    # (B,)
    obs_image: torch.Tensor    # (B, H, W, C)
    last_action: torch.Tensor  # (B,)
    last_reward: torch.Tensor  # (B,)
    done: torch.Tensor         # (B,)
    lstm_state: Any            # ((B,W),(B,W))


def sample(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Categorical draw by the Gumbel-max trick, as jax.random.categorical."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


def action_logprob(logits: torch.Tensor, action: torch.Tensor
                   ) -> torch.Tensor:
    """log pi(action | x) of each row of (N, A) logits."""
    return torch.gather(F.log_softmax(logits, dim=-1), -1,
                        action.long()[:, None])[:, 0]


def build_actor(env: Env, arch_cfg: ArchConfig, cfg: ImpalaConfig,
                num_envs: int, device="cpu"):
    """Returns (init_fn, unroll_fn).

    init_fn(seed) -> ActorCarry
    unroll_fn(params, carry) -> (carry, trajectory dict)
    """
    num_actions = env.num_actions
    t_len = cfg.unroll_length
    device = torch.device(device)
    is_cnn = arch_cfg.family == "impala_cnn"

    def init_fn(seed: int) -> ActorCarry:
        gen = torch.Generator(device=device).manual_seed(seed)
        env_state = env.reset(num_envs, gen, device)
        ts = env.observe(env_state)
        return ActorCarry(
            env_state, gen, ts.obs_token, ts.obs_image,
            torch.zeros(num_envs, dtype=torch.int32, device=device),
            torch.zeros(num_envs, dtype=torch.float32, device=device),
            torch.zeros(num_envs, dtype=torch.bool, device=device),
            lstm_lib.lstm_zero_state(num_envs, arch_cfg.lstm_width, device))

    def policy_step(params, c: ActorCarry):
        batch = {
            "image": c.obs_image[:, None],
            "last_action": c.last_action[:, None],
            "last_reward": c.last_reward[:, None],
            "done": c.done[:, None],
            "lstm_state": c.lstm_state,
        }
        out = bb.apply_train(params, batch, arch_cfg, num_actions)
        return out.policy_logits[:, 0], out.cache  # cache = new lstm state

    def policy_step_token(params, c: ActorCarry, cache, index: int):
        out = bb.apply_decode(params, c.obs_token[:, None], cache, index,
                              arch_cfg, num_actions)
        return out.policy_logits[:, 0], c.lstm_state

    @torch.no_grad()
    def unroll(params, carry: ActorCarry):
        initial_lstm = carry.lstm_state
        if is_cnn:
            def policy(c, _):
                return policy_step(params, c)
        else:
            cache = bb.cache_init(num_envs, t_len + 1, arch_cfg, device)

            def policy(c, i):
                return policy_step_token(params, c, cache, i)
        c = carry
        steps = []
        for i in range(t_len):
            logits, lstm_state = policy(c, i)
            action = sample(c.gen, logits)
            logp = action_logprob(logits, action)
            env_state, ts = env.step(c.env_state, action,
                                     env.draw(num_envs, c.gen, device))
            step = {"action": action, "reward": ts.reward, "done": ts.done,
                    "behaviour_logprob": logp}
            if is_cnn:
                step.update(obs_image=c.obs_image,
                            last_action=c.last_action,
                            last_reward=c.last_reward, done_in=c.done)
            else:
                step["obs_token"] = c.obs_token
            steps.append(step)
            c = ActorCarry(env_state, c.gen, ts.obs_token, ts.obs_image,
                           action, ts.reward, ts.done, lstm_state)
        traj = {k: torch.stack([s[k] for s in steps], dim=1)
                for k in steps[0]}
        return c, _finalize(traj, c, initial_lstm)

    def _finalize(traj: Dict, c: ActorCarry, initial_lstm) -> Dict:
        """Append the bootstrap observation x_{n+1} and package."""
        def with_last(name, last):
            return torch.cat([traj[name], last[:, None]], dim=1)

        out = {
            "actions": traj["action"],
            "rewards": traj["reward"],
            "discounts": cfg.discount * (1.0 -
                                         traj["done"].to(torch.float32)),
            "behaviour_logprob": traj["behaviour_logprob"],
            "done": traj["done"],
        }
        if not is_cnn:
            out["obs_token"] = with_last("obs_token", c.obs_token)
            return out
        out.update(obs_image=with_last("obs_image", c.obs_image),
                   last_action=with_last("last_action", c.last_action),
                   last_reward=with_last("last_reward", c.last_reward),
                   done_in=with_last("done_in", c.done),
                   lstm_state=initial_lstm)
        return out

    return init_fn, unroll
