#!/usr/bin/env python3
"""The SPMD learner over NCCL, one rank a card, on a machine with several
cards: what ``chip_smoke.py`` cannot run on its one card.

    python3 tools/spmd_cards.py        # on a host with 2 or more cards

It builds the ``Learner`` through ``distributed.runtime._setup`` at full
width (impala-shallow on catch, 2 actor threads, batches of up to 4
trajectories, 20-step unrolls) and runs 35 updates with the warm-up for
each of: every card (32 envs), 2 ranks with replay (32 envs), every
card with replay at 6 envs a trajectory (the bucket-1 warm-up's 6 rows
do not divide over 4 ranks, so it runs the replicated variant; replay
fills every later batch to 4 trajectories, which divide), and every card
at 6 envs without replay (each batch of one trajectory, 6 rows, runs the
replicated variant, whose step ranks skip the backward pass and only
receive rank 0's gradient). Each run
must end with every step rank's params' CRC-32 equal to rank 0's and the
``group`` section's ``spmd_devices`` its rank count; it prints the
section, the round latency, frames/s, the batch sizes and rank 0's K1/K2
launches. Then the CLI with ``--learner-mode spmd`` and no
``--spmd-devices`` must take every card. The card's name and power limit
come first, as ``nvidia-smi`` gives them.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import ImpalaConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.envs import make_env  # noqa: E402
from repro_torch.distributed import runtime  # noqa: E402
from repro_torch.distributed.spmd import params_crc  # noqa: E402
from repro_torch.kernels import vtrace as vk  # noqa: E402

UPDATES = 35


def main() -> int:
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"spmd_cards: {cards} card(s); it needs 2 or more",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, {cards} cards")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    env = make_env("catch")
    arch = get_config("impala-shallow").replace(image_hw=env.image_hw)
    for n, replay, envs in ((cards, False, 32), (2, True, 32),
                            (cards, True, 6), (cards, False, 6)):
        icfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                            learning_rate=6e-4, entropy_cost=0.003,
                            rmsprop_eps=0.01,
                            replay_fraction=0.5 if replay else 0.0)
        t0 = time.time()
        vk.reset_launch_counts()
        learner = runtime._setup(env, icfg, envs, num_actors=2,
                                 max_batch_trajs=4, seed=0,
                                 spmd_devices=n, arch=arch, device="cuda")
        _, tel = learner.run(UPDATES, warm_buckets=True)
        mine = params_crc(learner._params)
        crcs = learner._spmd.replica_crcs
        print(f"{n} ranks, replay {replay}, {envs} envs: group "
              f"{tel['group']}, round_ms_mean "
              f"{tel['exchange']['round_ms_mean']:.3f}, learner frames/s "
              f"{tel['frames_per_sec']:.0f}, batch sizes "
              f"{tel['batch_size_hist']}, rank 0 K1/K2 "
              f"{vk.vtrace.launches}/{vk.loss_vtrace.launches}, step "
              f"ranks' CRCs {crcs}, rank 0's {mine}; {time.time() - t0:.1f}"
              f" s", flush=True)
        if len(crcs) != n - 1 or any(v != mine for v in crcs.values()) \
                or tel["group"]["spmd_devices"] != n \
                or tel["group"]["rounds"] != UPDATES:
            raise AssertionError(f"{n} ranks: replicas or group wrong")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--device", "cuda", "--runtime", "async",
                        "--learner-mode", "spmd", "--steps", "20",
                        "--log-every", "10"], capture_output=True,
                       text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    print(r.stdout[-2000:], r.stderr[-2000:])
    if r.returncode != 0 or f"spmd_devices={cards}" not in r.stdout:
        raise AssertionError(f"the CLI: exit {r.returncode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
