"""The paper's Table 2 effect at small scale, on PyTorch: the four
off-policy correction variants under policy lag, with and without
replay, as ``examples/vtrace_ablation.py`` does with the JAX package.

On the card (the default) both V-trace runs, with and without replay,
take the fused loss kernel; the other corrections reach no V-trace
kernel. ``--device cpu`` runs everything on the CPU.

  PYTHONPATH=src python examples/vtrace_ablation_torch.py [--steps 400] \\
      [--lag 6] [--device cpu]
"""
import argparse

from repro_torch.configs.base import ImpalaConfig
from repro_torch.core.driver import run_training
from repro_torch.launch.train import resolve_device

NUM_ENVS = 32


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--lag", type=int, default=6)
    p.add_argument("--env", default="catch")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    print(f"env={args.env} policy_lag={args.lag} steps={args.steps}")
    print(f"{'variant':<14s} {'no-replay':>10s} {'replay':>10s}")
    for mode in ("vtrace", "onestep_is", "eps", "none"):
        row = []
        for replay in (False, True):
            cfg = ImpalaConfig(
                num_actions=3, unroll_length=20, learning_rate=6e-4,
                entropy_cost=0.003, rmsprop_eps=0.01, policy_lag=args.lag,
                correction=mode, replay_fraction=0.5 if replay else 0.0,
                replay_capacity=256)
            tracker, _ = run_training(args.env, cfg, num_envs=NUM_ENVS,
                                      steps=args.steps, seed=7,
                                      device=device)
            row.append(tracker.mean_return(200))
        print(f"{mode:<14s} {row[0]:>10.3f} {row[1]:>10.3f}")
    print("\nExpected qualitative ordering (paper Table 2): "
          "vtrace >= onestep_is > eps/none, gap widening with replay.")


if __name__ == "__main__":
    main()
