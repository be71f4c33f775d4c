"""End-to-end driver on PyTorch: train a ~100M-parameter transformer
policy with the full IMPALA stack, as ``examples/train_100m.py`` does
with the JAX package.

The backbone is a scaled-down qwen1.5-family decoder (~100M params with
the env-sized vocab); actors run the decode/KV-cache path (on the card,
the decode attention kernel once a layer and step), the learner the
full-trajectory V-trace path (the fused loss kernel). Trajectories pass
through the single-threaded ``TrajectoryQueue``.

  PYTHONPATH=src python examples/train_100m_torch.py [--steps 200] \\
      [--device cpu]
"""
import argparse
import time

from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import actor as actor_lib
from repro_torch.core import learner as learner_lib
from repro_torch.core.driver import init_params
from repro_torch.core.metrics import EpisodeTracker
from repro_torch.core.queue import LagController, TrajectoryQueue
from repro_torch.data.envs import make_env
from repro_torch.launch.train import resolve_device
from repro_torch.models import backbone as bb
from repro_torch.models import common

LAYERS = 10
MIN_PARAMS = 80e6


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--unroll", type=int, default=16)
    p.add_argument("--env", default="bandit")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = make_env(args.env)
    # ~100M-parameter decoder in the qwen1.5 family (the port has no
    # remat, which the JAX example turns off)
    arch = get_config("qwen1.5-4b").replace(
        num_layers=LAYERS, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=3072, vocab_size=max(4096, env.vocab_size))
    cfg = ImpalaConfig(num_actions=env.num_actions,
                       unroll_length=args.unroll, learning_rate=3e-4,
                       entropy_cost=0.005, rmsprop_eps=0.01, policy_lag=1)

    specs = bb.backbone_specs(arch, env.num_actions)
    params = init_params(arch, env.num_actions, 0, device)
    n = common.param_count(specs)
    print(f"backbone: {arch.name}-100m  params={n/1e6:.1f}M")
    assert n > MIN_PARAMS, n

    init_fn, unroll = actor_lib.build_actor(env, arch, cfg, args.num_envs,
                                            device)
    train_step, opt = learner_lib.build_train_step(arch, cfg,
                                                   env.num_actions)
    opt_state = opt.init(params)
    carry = init_fn(1)
    lag = LagController(cfg.policy_lag, params)
    queue = TrajectoryQueue(8)
    tracker = EpisodeTracker(args.num_envs)

    t0 = time.time()
    for step in range(args.steps):
        carry, traj = unroll(lag.actor_params(), carry)
        queue.put(traj)
        tracker.update(traj["rewards"].cpu().numpy(),
                       traj["done"].cpu().numpy())
        params, opt_state, m = train_step(params, opt_state, step,
                                          queue.get())
        lag.on_update(params)
        if (step + 1) % 20 == 0:
            fps = (step + 1) * args.num_envs * args.unroll / (time.time() - t0)
            print(f"step {step+1:4d} return(100)={tracker.mean_return():7.3f}"
                  f" loss={float(m['loss/total']):9.2f} fps={fps:6.0f}")
    print(f"final return(100) = {tracker.mean_return():.3f}")


if __name__ == "__main__":
    main()
