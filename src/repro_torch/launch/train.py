"""The training driver (``repro.launch.train``): the IMPALA loop (actors
-> queue -> V-trace learner), two runtimes:

  --runtime sync    one loop, acting and learning interleaved; policy lag
                    is *simulated* deterministically (LagController).
  --runtime async   real concurrency (``repro_torch.distributed``): actor
                    threads, each on its own CUDA stream, feed a
                    backpressured in-process queue; the learner drains it
                    with dynamic batching, and per-trajectory policy lag
                    is *measured* from parameter-store versions.

It runs on the card unless the caller asks for the CPU; asked for
``cuda`` where no card is found, it raises and does not fall back. On the
card TF32 is off for cuDNN and cuBLAS, so the convolutions and matmuls
compute in full float32, as every check of the port does.

  PYTHONPATH=src python -m repro_torch.launch.train --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \
      --runtime async
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --smoke --steps 30 --log-every 10
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --runtime async --smoke --env catch --steps 30

Values of the JAX CLI's flags whose paths are not ported yet (process
and remote actors, the shm and socket transports, inference-mode actors,
learner groups and SPMD, replay, checkpoints, token training, envs other
than catch and bandit) end the run with a ``SystemExit`` that names the
ROADMAP.md Queue 1 item.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Union

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
    p.add_argument("--runtime", default="sync", choices=["sync", "async"])
    p.add_argument("--actor-threads", type=int, default=2,
                   help="actor worker count (async runtime)")
    p.add_argument("--learners", type=int, default=1,
                   help="learner worker count (async runtime); only 1 is "
                        "ported")
    p.add_argument("--learner-mode", default="process",
                   choices=["process", "spmd"],
                   help="only process (with --learners 1) is ported")
    p.add_argument("--actor-backend", default="thread",
                   choices=["thread", "process", "remote"],
                   help="where actors live; only thread is ported")
    p.add_argument("--actor-mode", default="unroll",
                   choices=["unroll", "inference"],
                   help="unroll: every actor runs its own n-step unroll "
                        "with the published params; only unroll is "
                        "ported")
    p.add_argument("--no-donate", action="store_true",
                   help="reported as donate=False in the async "
                        "telemetry; the port's learner always updates in "
                        "place and publishes a copy (PyTorch donates no "
                        "buffers)")
    p.add_argument("--transport", default="",
                   choices=["", "inproc", "shm", "socket"],
                   help="trajectory transport; default inproc for thread "
                        "actors; only inproc is ported")
    p.add_argument("--vtrace-impl", default="auto",
                   choices=["auto", "fused", "pallas", "scan", "reference"],
                   help="V-trace implementation for the async learner's "
                        "loss: auto = the fused kernel (K2) on the card, "
                        "the reverse loop on the CPU")
    p.add_argument("--queue-capacity", type=int, default=8)
    p.add_argument("--queue-policy", default="block",
                   choices=["block", "drop_oldest", "drop_newest"])
    p.add_argument("--max-batch-trajs", type=int, default=4,
                   help="learner dynamic batching: max trajectories "
                        "stacked per update, rounded down to a power of "
                        "two (async runtime)")
    p.add_argument("--ckpt-dir", default="",
                   help="not ported yet: must stay empty")
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    return p


def resolve_device(name: str) -> torch.device:
    """The torch device for ``--device``. A CUDA device turns TF32 off for
    cuDNN and cuBLAS: the card then computes the convolutions and matmuls
    in full float32, which is what the parity tests and ``chip_smoke.py``
    verified."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: torch.cuda.is_available() "
                             f"is False. Pass --device cpu to run on the "
                             f"CPU.")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _unported(flag: str, item: int, name: str) -> SystemExit:
    return SystemExit(f"{flag} is not ported yet (ROADMAP.md, Queue 1 item "
                      f"{item}: {name})")


def _refuse_unported(args) -> None:
    if args.learner_mode == "spmd" and args.runtime != "async":
        raise SystemExit("--learner-mode spmd requires --runtime async")
    if args.replay_fraction > 0:
        raise _unported("--replay-fraction > 0", 11, "replay learner path")
    if args.ckpt_dir:
        raise _unported("--ckpt-dir", 7, "checkpoint save/resume")
    if args.runtime != "async":
        return
    if args.actor_backend != "thread":
        raise _unported(f"--actor-backend {args.actor_backend}", 10,
                        "process and socket actor pools")
    if args.transport not in ("", "inproc"):
        raise _unported(f"--transport {args.transport}", 10,
                        "process and socket actor pools")
    if args.actor_mode != "unroll":
        raise _unported(f"--actor-mode {args.actor_mode}", 9,
                        "inference service")
    if args.learners > 1:
        raise _unported("--learners > 1", 12, "learner groups")
    if args.learner_mode == "spmd":
        raise _unported("--learner-mode spmd", 12, "learner groups")


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


@dataclasses.dataclass
class AsyncRun:
    """What an async run leaves behind for its caller."""
    params: Dict                 # the last published params
    metrics: Dict[str, Any]
    telemetry: Dict[str, Any]
    arch: ArchConfig
    icfg: ImpalaConfig
    env: Env
    tracker: Any                 # distributed.MultiTracker


def train(argv: Optional[List[str]] = None,
          on_update: Optional[Callable] = None) -> Union[SyncRun, AsyncRun]:
    """Parse the CLI flags and run the trainer. ``on_update(update_index,
    published params, metrics, snapshot_fn)``, for ``--runtime async``
    only, runs after each update's log line, on the learner's thread."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if on_update is not None and args.runtime != "async":
        raise ValueError("on_update is a hook of --runtime async")
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
    if args.runtime == "async":
        return _run_async(args, env, arch, icfg, device, on_update)
    return _run_sync(args, env, arch, icfg, device)


def _run_sync(args, env, arch, icfg, device) -> SyncRun:
    from repro_torch.core.driver import sync_loop
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    specs = bb.backbone_specs(arch, env.num_actions)
    print(f"arch={arch.name} params={common.param_count(specs):,} "
          f"env={env.name} actions={env.num_actions} runtime=sync")
    print(f"device={device}" + (f" ({torch.cuda.get_device_name(device)})"
                                if device.type == "cuda" else ""))

    tracker = EpisodeTracker(args.num_envs)
    frames = 0
    # the steady-state fps window opens after the first update lands, so
    # the first step's lazy set-up (kernel build, cuDNN plans) stays out
    t0 = None
    frames0 = 0
    fps = 0.0
    params: Dict = {}
    metrics: Dict[str, Any] = {}
    batch: Dict = {}
    log: List[Dict[str, float]] = []
    for step, params, metrics, batch in sync_loop(
            env, arch, icfg, args.num_envs, args.steps, tracker, args.seed,
            device):
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


# the keys of the final ``telemetry:`` line, the JAX CLI's
TELEMETRY_KEYS = ("learner_updates", "frames_consumed", "updates_per_sec",
                  "frames_per_sec", "batch_size_hist", "lag", "queue",
                  "actors", "param_version")


def _run_async(args, env, arch, icfg, device, hook) -> AsyncRun:
    from repro_torch.distributed import run_async_training
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    transport = args.transport or "inproc"
    specs = bb.backbone_specs(arch, env.num_actions)
    print(f"arch={arch.name} params={common.param_count(specs):,} "
          f"env={env.name} actions={env.num_actions} runtime=async "
          f"actors={args.actor_threads}({args.actor_backend}/"
          f"{args.actor_mode}) transport={transport} "
          f"queue={args.queue_capacity}/{args.queue_policy} "
          f"max_batch_trajs={args.max_batch_trajs} "
          f"donate={not args.no_donate}")
    print(f"device={device}" + (f" ({torch.cuda.get_device_name(device)})"
                                if device.type == "cuda" else ""))
    last_params: List[Dict] = [{}]

    def on_update(step, params, metrics, snapshot_fn):
        last_params[0] = params
        if step % args.log_every == 0:
            tel = snapshot_fn()
            lag, q = tel["lag"], tel["queue"]
            print(f"update {step:6d} "
                  f"loss={float(metrics['loss/total']):10.2f} "
                  f"lag(mean/max)={lag['mean']:.2f}/{lag['max']} "
                  f"queue(occ/drop/stall)={q['mean_occupancy']:.1f}/"
                  f"{q['dropped']}/{q['put_stalls']} "
                  f"learner_fps={tel['frames_per_sec']:7.0f} "
                  f"actor_fps={tel['actors']['actor_fps']:7.0f}")
        if hook is not None:
            hook(step, params, metrics, snapshot_fn)

    tracker, metrics, tel = run_async_training(
        env, icfg, args.num_envs, args.steps,
        num_actors=args.actor_threads, actor_backend=args.actor_backend,
        actor_mode=args.actor_mode, transport=transport,
        queue_capacity=args.queue_capacity, queue_policy=args.queue_policy,
        max_batch_trajs=args.max_batch_trajs, donate=not args.no_donate,
        vtrace_impl=args.vtrace_impl, seed=args.seed, arch=arch,
        on_update=on_update, device=device)
    print(f"final return(100) = {tracker.mean_return():.3f}")
    print("telemetry:", json.dumps({k: tel[k] for k in TELEMETRY_KEYS},
                                   default=float))
    return AsyncRun(last_params[0], metrics, tel, arch, icfg, env, tracker)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
