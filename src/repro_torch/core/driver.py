"""Reusable training loop (``repro.core.driver``): the sync IMPALA
pipeline (actor -> simulated policy lag -> V-trace learner, optional
replay) over a named env, on ``device`` (the card unless the caller asks
for the CPU)."""
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
from repro_torch.core.replay import ReplayBuffer, mix_batches
from repro_torch.data.envs import make_env
from repro_torch.models import backbone as bb
from repro_torch.models import common


def small_arch(env) -> ArchConfig:
    return get_smoke_config("impala_shallow").replace(image_hw=env.image_hw)


def init_params(arch: ArchConfig, num_actions: int, seed: int = 0,
                device="cuda") -> Dict:
    """The agent's initial params from ``seed``: the JAX package's draw,
    as the port's tensors on ``device``."""
    specs = bb.backbone_specs(arch, num_actions)
    return params_lib.from_jax(common.init_params(specs, seed),
                               torch.device(device))


def sync_loop(env, arch: ArchConfig, icfg: ImpalaConfig, num_envs: int,
              steps: int, tracker: EpisodeTracker, seed: int = 0,
              device="cuda", initial_params=None, start_step: int = 0
              ) -> Iterator[Tuple[int, Dict, Dict, Dict]]:
    """The sync loop, one step at a time: an actor unroll with the
    lagged params, ``tracker`` fed its rewards and dones, with replay the
    unroll stored and the first ``replay_fraction`` of the batch replaced
    by replayed trajectories, one learner update. Yields (step, params,
    metrics, actor batch) after each update, for steps ``start_step`` to
    ``steps - 1``: a resumed run (``initial_params``, the port's tensors
    on ``device``) continues the learning-rate schedule. The optimizer
    state starts afresh, as the JAX sync loop's does: its checkpoints
    hold the params only."""
    device = torch.device(device)
    params = (initial_params if initial_params is not None
              else init_params(arch, env.num_actions, seed, device))
    init_fn, unroll = actor_lib.build_actor(env, arch, icfg, num_envs,
                                            device)
    train_step, opt = learner_lib.build_train_step(arch, icfg,
                                                   env.num_actions)
    opt_state = opt.init(params)
    carry = init_fn(seed + 1)
    lag = LagController(icfg.policy_lag, params)
    buf = ReplayBuffer(icfg.replay_capacity, seed=seed,
                       reuse_limit=icfg.replay_reuse,
                       priority=icfg.replay_priority)
    for step in range(start_step, steps):
        carry, traj = unroll(lag.actor_params(), carry)
        tracker.update(traj["rewards"].cpu().numpy(),
                       traj["done"].cpu().numpy())
        batch = traj
        if icfg.replay_fraction > 0:
            buf.add_batch(traj)
            rep = buf.sample(num_envs)
            batch = mix_batches(traj, rep, icfg.replay_fraction,
                                buffer=buf)
        params, opt_state, metrics = train_step(params, opt_state, step,
                                                batch)
        lag.on_update(params)
        yield step, params, metrics, traj


def run_training(env_name: str, icfg: ImpalaConfig, num_envs: int,
                 steps: int, seed: int = 0,
                 arch: Optional[ArchConfig] = None, device="cuda"
                 ) -> Tuple[EpisodeTracker, Dict]:
    env = make_env(env_name)
    tracker = EpisodeTracker(num_envs)
    metrics: Dict = {}
    for _, _, metrics, _ in sync_loop(env, arch or small_arch(env), icfg,
                                      num_envs, steps, tracker, seed,
                                      device):
        pass
    return tracker, metrics
