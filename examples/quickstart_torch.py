"""Quickstart, on PyTorch: train the paper's shallow conv-LSTM agent on
`catch` with the full IMPALA pipeline (decoupled actors + V-trace
learner), as ``examples/quickstart.py`` does with the JAX package.

On the card (the default) the learner's loss is the fused V-trace kernel;
``--device cpu`` runs it on the CPU. ``--steps`` cuts the run (the JAX
example's 500 by default): the "should beat random" check holds after
the full 500 steps only.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import actor as actor_lib
from repro_torch.core import learner as learner_lib
from repro_torch.core.driver import init_params
from repro_torch.core.metrics import EpisodeTracker
from repro_torch.core.queue import LagController
from repro_torch.data.envs import make_catch
from repro_torch.launch.train import resolve_device
from repro_torch.models import backbone as bb
from repro_torch.models import common

STEPS = 500
NUM_ENVS = 32
LOG_EVERY = 100


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = make_catch()
    arch = get_smoke_config("impala-shallow").replace(image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                       learning_rate=6e-4, entropy_cost=0.003,
                       rmsprop_eps=0.01, policy_lag=1)

    specs = bb.backbone_specs(arch, env.num_actions)
    params = init_params(arch, env.num_actions, 0, device)
    print(f"params: {common.param_count(specs):,}")

    init_fn, unroll = actor_lib.build_actor(env, arch, cfg, NUM_ENVS, device)
    train_step, opt = learner_lib.build_train_step(arch, cfg,
                                                   env.num_actions)
    opt_state = opt.init(params)
    carry = init_fn(1)
    lag = LagController(cfg.policy_lag, params)  # actors run stale params
    tracker = EpisodeTracker(NUM_ENVS)

    for step in range(args.steps):
        carry, traj = unroll(lag.actor_params(), carry)   # actors
        tracker.update(traj["rewards"].cpu().numpy(),
                       traj["done"].cpu().numpy())
        params, opt_state, m = train_step(params, opt_state, step,
                                          traj)           # learner
        lag.on_update(params)
        if (step + 1) % LOG_EVERY == 0:
            print(f"step {step+1}: return(100) = "
                  f"{tracker.mean_return():.3f}  "
                  f"(optimal 1.0, random ~ -0.6)")
    if args.steps >= STEPS:
        assert tracker.mean_return() > 0.0, "should beat random"
    print("done.")


if __name__ == "__main__":
    main()
