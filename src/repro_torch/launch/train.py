"""The training loop, sync runtime (``repro.launch.train`` ``--runtime sync``).

One loop, acting and learning interleaved, with the policy lag simulated
deterministically (``LagController``). It runs on the card unless the
caller asks for the CPU; asked for ``cuda`` where no card is found, it
raises and does not fall back.

  PYTHONPATH=src python -m repro_torch.launch.train --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --smoke --steps 30 --log-every 10

Flags of the JAX CLI that the sync path does not read, and paths not
ported yet (async runtime, replay, checkpoints, token training, envs
other than catch and bandit), end the run with a ``SystemExit`` that
names the roadmap item.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig, ImpalaConfig
from repro_torch.core.metrics import EpisodeTracker
from repro_torch.data.envs import Env


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.launch.train")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (the default; raises "
                        "when no card is found) or cpu")
    p.add_argument("--arch", default="impala-shallow")
    p.add_argument("--env", default="catch")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--unroll", type=int, default=20)
    p.add_argument("--lr", type=float, default=6e-4)
    p.add_argument("--entropy-cost", type=float, default=0.003)
    p.add_argument("--rmsprop-eps", type=float, default=0.01)
    p.add_argument("--policy-lag", type=int, default=1,
                   help="simulated lag (sync runtime)")
    p.add_argument("--correction", default="vtrace",
                   choices=["vtrace", "onestep_is", "eps", "none"])
    p.add_argument("--replay-fraction", type=float, default=0.0,
                   help="not ported yet: must stay 0")
    p.add_argument("--reward-clip", default="abs_one")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke config of --arch")
    p.add_argument("--runtime", default="sync", choices=["sync", "async"],
                   help="only sync is ported")
    p.add_argument("--ckpt-dir", default="",
                   help="not ported yet: must stay empty")
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is "
                         f"False. Pass --device cpu to run on the CPU.")
    return device


def _refuse_unported(args) -> None:
    if args.runtime == "async":
        raise SystemExit("--runtime async is not ported yet (ROADMAP.md, "
                         "Queue 1: async single-learner runtime)")
    if args.replay_fraction > 0:
        raise SystemExit("--replay-fraction > 0 is not ported yet "
                         "(ROADMAP.md, Queue 1: replay learner path)")
    if args.ckpt_dir:
        raise SystemExit("--ckpt-dir is not ported yet (ROADMAP.md, "
                         "Queue 1: checkpoint save/resume)")


@dataclasses.dataclass
class SyncRun:
    """What a sync run leaves behind for its caller."""
    params: Dict
    metrics: Dict[str, Any]
    last_batch: Dict
    arch: ArchConfig
    icfg: ImpalaConfig
    env: Env
    fps: float
    log: List[Dict[str, float]]
    tracker: EpisodeTracker


def train(argv: Optional[List[str]] = None) -> SyncRun:
    """Parse the CLI flags and run the sync trainer."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.envs import make_env

    env = make_env(args.env)
    arch = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if arch.family != "impala_cnn":
        raise SystemExit(f"--arch {args.arch}: training a token backbone is "
                         f"not ported yet (ROADMAP.md, Queue 1 item 14: "
                         f"token training); it serves through "
                         f"repro_torch.launch.serve")
    arch = arch.replace(image_hw=env.image_hw)
    icfg = ImpalaConfig(
        num_actions=env.num_actions, unroll_length=args.unroll,
        learning_rate=args.lr, entropy_cost=args.entropy_cost,
        rmsprop_eps=args.rmsprop_eps, policy_lag=args.policy_lag,
        correction=args.correction, reward_clip=args.reward_clip)
    return _run_sync(args, env, arch, icfg, device)


def _run_sync(args, env, arch, icfg, device) -> SyncRun:
    from repro_torch import params as params_lib
    from repro_torch.core import actor as actor_lib
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.queue import LagController
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    specs = bb.backbone_specs(arch, env.num_actions)
    params = params_lib.from_jax(common.init_params(specs, args.seed), device)
    print(f"arch={arch.name} params={common.param_count(specs):,} "
          f"env={env.name} actions={env.num_actions} runtime=sync")
    print(f"device={device}" + (f" ({torch.cuda.get_device_name(device)})"
                                if device.type == "cuda" else ""))

    init_fn, unroll = actor_lib.build_actor(env, arch, icfg, args.num_envs,
                                            device)
    train_step, opt = learner_lib.build_train_step(arch, icfg,
                                                   env.num_actions)
    opt_state = opt.init(params)

    carry = init_fn(args.seed + 1)
    lag = LagController(icfg.policy_lag, params)
    tracker = EpisodeTracker(args.num_envs)
    frames = 0
    # the steady-state fps window opens after the first update lands, so
    # the first step's lazy set-up (kernel build, cuDNN plans) stays out
    t0 = None
    frames0 = 0
    fps = 0.0
    metrics: Dict[str, Any] = {}
    batch: Dict = {}
    log: List[Dict[str, float]] = []
    for step in range(args.steps):
        carry, batch = unroll(lag.actor_params(), carry)
        tracker.update(batch["rewards"].cpu().numpy(),
                       batch["done"].cpu().numpy())
        params, opt_state, metrics = train_step(params, opt_state, step,
                                                batch)
        lag.on_update(params)
        frames += args.num_envs * args.unroll
        if t0 is None:
            _sync(device)
            t0 = time.time()
            frames0 = frames
        if (step + 1) % args.log_every == 0:
            _sync(device)
            dt = time.time() - t0
            fps = (frames - frames0) / dt if dt > 0 else 0.0
            entry = {"step": step + 1, "return100": tracker.mean_return(),
                     "loss": float(metrics["loss/total"]),
                     "entropy": -float(metrics["loss/entropy"]), "fps": fps}
            log.append(entry)
            print(f"step {step+1:6d} return(100)={entry['return100']:7.3f} "
                  f"loss={entry['loss']:10.2f} "
                  f"entropy={entry['entropy']:8.1f} "
                  f"fps={fps:7.0f} episodes={len(tracker.completed)}")
    print(f"final return(100) = {tracker.mean_return():.3f}")
    return SyncRun(params, metrics, batch, arch, icfg, env, fps, log,
                   tracker)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
