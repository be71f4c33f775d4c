"""Multi-task IMPALA with Population Based Training on PyTorch (paper
§5.3 + App. F), as ``examples/multitask_pbt.py`` does with the JAX
package: a population of agents, each one set of weights across a task
suite, with PBT exploit/explore on (entropy cost, learning rate, RMSProp
eps) and the mean capped human-normalised score as fitness. On the card
(the default) each learner step is the fused V-trace loss kernel.

  PYTHONPATH=src python examples/multitask_pbt_torch.py [--pop 4] \\
      [--rounds 6] [--device cpu]
"""
import argparse

from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import actor as actor_lib
from repro_torch.core import learner as learner_lib
from repro_torch.core.driver import init_params
from repro_torch.core.metrics import EpisodeTracker, capped_normalised_score
from repro_torch.core.pbt import PBTController
from repro_torch.core.queue import LagController
from repro_torch.data.envs import make_env
from repro_torch.data.multitask import padded_env
from repro_torch.launch.train import resolve_device

TASKS = ["catch", "bandit"]
REFS = {"catch": (-0.6, 1.0), "bandit": (0.25, 1.0)}


def build_member(arch, num_actions, hypers):
    cfg = ImpalaConfig(num_actions=num_actions, unroll_length=16,
                       learning_rate=hypers["learning_rate"],
                       entropy_cost=hypers["entropy_cost"],
                       rmsprop_eps=hypers["rmsprop_eps"], policy_lag=1)
    train_step, opt = learner_lib.build_train_step(arch, cfg, num_actions)
    return cfg, train_step, opt


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pop", type=int, default=4)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--steps-per-round", type=int, default=40)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    envs = {t: make_env(t) for t in TASKS}
    num_actions = max(e.num_actions for e in envs.values())
    hw = (max(e.image_hw[0] for e in envs.values()),
          max(e.image_hw[1] for e in envs.values()), 3)
    # shared-frame wrapper
    envs = {t: padded_env(e, hw, num_actions) for t, e in envs.items()}
    arch = get_smoke_config("impala-shallow").replace(image_hw=hw)

    pbt = PBTController(pop_size=args.pop, seed=0)
    weights = [init_params(arch, num_actions, i, device)
               for i in range(args.pop)]
    opt_states = [None] * args.pop

    for rnd in range(args.rounds):
        for i in range(args.pop):
            cfg, train_step, opt = build_member(arch, num_actions,
                                                pbt.members[i].hypers)
            if opt_states[i] is None:
                opt_states[i] = opt.init(weights[i])
            params = weights[i]
            scores = []
            for t, env in envs.items():
                init_fn, unroll = actor_lib.build_actor(env, arch, cfg, 8,
                                                        device)
                carry = init_fn(100 * rnd + i)
                lag = LagController(cfg.policy_lag, params)
                tracker = EpisodeTracker(8)
                for step in range(args.steps_per_round):
                    carry, traj = unroll(lag.actor_params(), carry)
                    tracker.update(traj["rewards"].cpu().numpy(),
                                   traj["done"].cpu().numpy())
                    params, opt_states[i], _ = train_step(
                        params, opt_states[i], step, traj)
                    lag.on_update(params)
                scores.append(tracker.mean_return(100))
            weights[i] = params
            fitness = capped_normalised_score(
                scores, [REFS[t][1] for t in TASKS],
                [REFS[t][0] for t in TASKS])
            pbt.report_fitness(i, fitness)
        # PBT evolution step
        for i in range(args.pop):
            new_h, copied = pbt.exploit_explore(i, rnd, weights)
            tag = " (copied)" if copied else ""
            print(f"round {rnd} member {i}: fitness="
                  f"{pbt.members[i].fitness:.3f} "
                  f"lr={new_h['learning_rate']:.2e} "
                  f"ent={new_h['entropy_cost']:.2e}{tag}")
    best = pbt.best()
    print(f"\nbest member {best}: fitness {pbt.members[best].fitness:.3f}")


if __name__ == "__main__":
    main()
