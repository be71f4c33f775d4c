"""Reusable training loop (``repro.core.driver``): the sync IMPALA
pipeline (actor -> simulated policy lag -> V-trace learner) over a named
env, on ``device`` (the card unless the caller asks for the CPU). Replay
is not ported yet (ROADMAP.md, Queue 1 item 11)."""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch import params as params_lib
from repro_torch.configs.base import ArchConfig, ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import actor as actor_lib
from repro_torch.core import learner as learner_lib
from repro_torch.core.metrics import EpisodeTracker
from repro_torch.core.queue import LagController
from repro_torch.data.envs import make_env
from repro_torch.models import backbone as bb
from repro_torch.models import common


def small_arch(env) -> ArchConfig:
    return get_smoke_config("impala_shallow").replace(image_hw=env.image_hw)


def sync_loop(env, arch: ArchConfig, icfg: ImpalaConfig, num_envs: int,
              steps: int, tracker: EpisodeTracker, seed: int = 0,
              device="cuda") -> Iterator[Tuple[int, Dict, Dict, Dict]]:
    """The sync loop, one step at a time: an actor unroll with the
    lagged params, ``tracker`` fed its rewards and dones, one learner
    update. Yields (step, params, metrics, actor batch) after each
    update."""
    device = torch.device(device)
    specs = bb.backbone_specs(arch, env.num_actions)
    params = params_lib.from_jax(common.init_params(specs, seed), device)
    init_fn, unroll = actor_lib.build_actor(env, arch, icfg, num_envs,
                                            device)
    train_step, opt = learner_lib.build_train_step(arch, icfg,
                                                   env.num_actions)
    opt_state = opt.init(params)
    carry = init_fn(seed + 1)
    lag = LagController(icfg.policy_lag, params)
    for step in range(steps):
        carry, batch = unroll(lag.actor_params(), carry)
        tracker.update(batch["rewards"].cpu().numpy(),
                       batch["done"].cpu().numpy())
        params, opt_state, metrics = train_step(params, opt_state, step,
                                                batch)
        lag.on_update(params)
        yield step, params, metrics, batch


def run_training(env_name: str, icfg: ImpalaConfig, num_envs: int,
                 steps: int, seed: int = 0,
                 arch: Optional[ArchConfig] = None, device="cuda"
                 ) -> Tuple[EpisodeTracker, Dict]:
    if icfg.replay_fraction > 0:
        raise NotImplementedError(
            "replay_fraction > 0 is not ported yet (ROADMAP.md, Queue 1 "
            "item 11: replay learner path)")
    env = make_env(env_name)
    tracker = EpisodeTracker(num_envs)
    metrics: Dict = {}
    for _, _, metrics, _ in sync_loop(env, arch or small_arch(env), icfg,
                                      num_envs, steps, tracker, seed,
                                      device):
        pass
    return tracker, metrics
