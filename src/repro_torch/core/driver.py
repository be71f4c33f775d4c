"""Reusable training loops (``repro.core.driver``), on ``device`` (the
card unless the caller asks for the CPU):

  sync_loop / run_training   the sync IMPALA pipeline (actor -> simulated
                             policy lag -> V-trace learner, optional
                             replay) over a named env;
  multitask_loop /           one set of weights trained across a task
  train_multitask            suite, one actor per task (paper §5.3;
                             ``benchmarks/multitask.py``'s ``_train_multi``);
  run_pbt                    a population of such agents under Population
                             Based Training (paper Appendix F;
                             ``examples/multitask_pbt.py``'s loop).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch import params as params_lib
from repro_torch.configs.base import ArchConfig, ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import actor as actor_lib
from repro_torch.core import learner as learner_lib
from repro_torch.core.metrics import EpisodeTracker, capped_normalised_score
from repro_torch.core.pbt import PBTController
from repro_torch.core.queue import LagController
from repro_torch.core.replay import ReplayBuffer, mix_batches
from repro_torch.data.envs import make_env
from repro_torch.data.multitask import common_frame, padded_env
from repro_torch.models import backbone as bb
from repro_torch.models import common

# (random policy, near-optimal) reference returns per task: the
# normalisers of the capped score (``benchmarks/multitask.py``)
TASK_REFS = {"catch": (-0.6, 1.0), "bandit": (0.25, 1.0),
             "tmaze": (-0.35, 1.0)}


def small_arch(env) -> ArchConfig:
    return get_smoke_config("impala_shallow").replace(image_hw=env.image_hw)


def init_params(arch: ArchConfig, num_actions: int, seed: int = 0,
                device="cuda") -> Dict:
    """The agent's initial params from ``seed``, as the port's tensors on
    ``device``: the conv-LSTM agents drawn on the CPU (the same numbers on
    either device), the token backbones on ``device`` itself, as the
    server draws them (a full-width tree stays off the host)."""
    specs = bb.backbone_specs(arch, num_actions)
    device = torch.device(device)
    draw_on = "cpu" if arch.family == "impala_cnn" else device
    return params_lib.from_jax(common.init_params(specs, seed, draw_on),
                               device)


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


# ---------------------------------------------------------------------------
# multi-task training and PBT


def multitask_config(num_actions: int, learning_rate: float = 1e-3,
                     entropy_cost: float = 0.005,
                     rmsprop_eps: float = 0.01) -> ImpalaConfig:
    """The multi-task runs' learner settings (unroll 16, policy lag 1)."""
    return ImpalaConfig(num_actions=num_actions, unroll_length=16,
                        learning_rate=learning_rate,
                        entropy_cost=entropy_cost, rmsprop_eps=rmsprop_eps,
                        policy_lag=1)


def padded_suite(tasks: Sequence[str], arch: Optional[ArchConfig]):
    """The tasks' envs padded to their common frame and action space, and
    ``arch`` (default: the smoke impala-shallow) on that frame."""
    envs = [make_env(t) for t in tasks]
    hw, num_actions = common_frame(envs)
    arch = arch if arch is not None else get_smoke_config("impala_shallow")
    return ([padded_env(e, hw, num_actions) for e in envs],
            arch.replace(image_hw=hw), num_actions)


def _concat(batches: List[Dict]) -> Dict:
    """Trajectory batches stacked on B, in the order given."""
    def cat(xs):
        if isinstance(xs[0], tuple):
            return tuple(torch.cat(p, dim=0) for p in zip(*xs))
        return torch.cat(xs, dim=0)
    return {k: cat([b[k] for b in batches]) for k in batches[0]}


def multitask_loop(tasks: Sequence[str], steps: int,
                   trackers: List[EpisodeTracker],
                   num_envs_per_task: int = 8, seed: int = 0,
                   arch: Optional[ArchConfig] = None, device="cuda"
                   ) -> Iterator[Tuple[int, Dict, Dict, Dict]]:
    """One set of weights, one actor per task (paper §5.3): each step
    every task's actor unrolls with the lagged params, the per-task
    batches are concatenated on B in task order, and one learner step
    runs on (T, B, A) = (16, num_envs_per_task x tasks, max actions).
    ``trackers[i]`` is fed task i's rewards and dones. Yields (step,
    params, metrics, concatenated batch) after each update.
    ``benchmarks/multitask.py:32-75`` (``_train_multi``)."""
    device = torch.device(device)
    envs, arch, num_actions = padded_suite(tasks, arch)
    icfg = multitask_config(num_actions)
    params = init_params(arch, num_actions, seed, device)
    train_step, opt = learner_lib.build_train_step(arch, icfg, num_actions)
    opt_state = opt.init(params)
    lag = LagController(icfg.policy_lag, params)
    actors = [actor_lib.build_actor(env, arch, icfg, num_envs_per_task,
                                    device) for env in envs]
    carries = [init_fn(seed + 10 + i)
               for i, (init_fn, _) in enumerate(actors)]
    for step in range(steps):
        batches = []
        for i, (_, unroll) in enumerate(actors):
            carries[i], traj = unroll(lag.actor_params(), carries[i])
            trackers[i].update(traj["rewards"].cpu().numpy(),
                               traj["done"].cpu().numpy())
            batches.append(traj)
        batch = _concat(batches)
        params, opt_state, metrics = train_step(params, opt_state, step,
                                                batch)
        lag.on_update(params)
        yield step, params, metrics, batch


def train_multitask(tasks: Sequence[str], steps: int,
                    num_envs_per_task: int = 8, seed: int = 0,
                    arch: Optional[ArchConfig] = None, device="cuda"
                    ) -> Dict[str, float]:
    """``multitask_loop`` for ``steps`` updates; returns each task's mean
    return over its last 100 episodes. With one task it trains that
    task's expert."""
    trackers = [EpisodeTracker(num_envs_per_task) for _ in tasks]
    for _ in multitask_loop(tasks, steps, trackers, num_envs_per_task,
                            seed, arch, device):
        pass
    return {t: trackers[i].mean_return(100) for i, t in enumerate(tasks)}


def run_pbt(pop: int = 4, rounds: int = 6, steps_per_round: int = 40,
            tasks: Sequence[str] = ("catch", "bandit"), num_envs: int = 8,
            seed: int = 0, arch: Optional[ArchConfig] = None,
            device="cuda",
            before_turn: Optional[Callable[[int, int, List[Dict]], None]]
            = None) -> Tuple[PBTController, List[Dict], List[Dict]]:
    """Multi-task IMPALA under PBT (``examples/multitask_pbt.py:55-95``):
    each round every member trains ``steps_per_round`` steps on each task
    in turn with its own hyperparameters and optimizer state, its
    fitness is the mean capped normalised score of its returns
    (``TASK_REFS``), and then every member exploits and explores. An
    exploit copies the source's weights (``PBTController``); the copying
    member keeps its own optimizer state, as in the example.
    ``before_turn(round, member, weights)`` runs before each member's
    training, and with ``member == pop`` after the round's last member
    trained, before the exploits. Returns (the controller, the members' weights, one record
    per member and round: fitness, new hypers, and the member copied
    from, or None)."""
    device = torch.device(device)
    envs, arch, num_actions = padded_suite(tasks, arch)
    refs = [TASK_REFS[t] for t in tasks]
    pbt = PBTController(pop_size=pop, seed=seed)
    weights = [init_params(arch, num_actions, i, device) for i in range(pop)]
    opt_states: List[Optional[Dict]] = [None] * pop
    history: List[Dict] = []
    for rnd in range(rounds):
        for i in range(pop):
            if before_turn is not None:
                before_turn(rnd, i, weights)
            h = pbt.members[i].hypers
            cfg = multitask_config(num_actions, h["learning_rate"],
                                   h["entropy_cost"], h["rmsprop_eps"])
            train_step, opt = learner_lib.build_train_step(arch, cfg,
                                                           num_actions)
            if opt_states[i] is None:
                opt_states[i] = opt.init(weights[i])
            params = weights[i]
            scores = []
            for env in envs:
                init_fn, unroll = actor_lib.build_actor(env, arch, cfg,
                                                        num_envs, device)
                carry = init_fn(100 * rnd + i)
                lag = LagController(cfg.policy_lag, params)
                tracker = EpisodeTracker(num_envs)
                for step in range(steps_per_round):
                    carry, traj = unroll(lag.actor_params(), carry)
                    tracker.update(traj["rewards"].cpu().numpy(),
                                   traj["done"].cpu().numpy())
                    params, opt_states[i], _ = train_step(
                        params, opt_states[i], step, traj)
                    lag.on_update(params)
                scores.append(tracker.mean_return(100))
            weights[i] = params
            pbt.report_fitness(i, capped_normalised_score(
                scores, [r[1] for r in refs], [r[0] for r in refs]))
        if before_turn is not None:
            before_turn(rnd, pop, weights)
        for i in range(pop):
            new_h, copied = pbt.exploit_explore(i, rnd, weights)
            m = pbt.members[i]
            history.append({"round": rnd, "member": i, "fitness": m.fitness,
                            "hypers": new_h,
                            "copied_from": m.copied_from if copied else None})
            print(f"round {rnd} member {i}: fitness={m.fitness:.3f} "
                  f"lr={new_h['learning_rate']:.2e} "
                  f"ent={new_h['entropy_cost']:.2e}"
                  + (f" (copied from {m.copied_from})" if copied else ""))
    return pbt, weights, history
