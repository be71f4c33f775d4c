"""The training driver (``repro.launch.train``): the IMPALA loop (actors
-> queue -> V-trace learner), two runtimes:

  --runtime sync    one loop, acting and learning interleaved; policy lag
                    is *simulated* deterministically (LagController).
  --runtime async   real concurrency (``repro_torch.distributed``): actor
                    threads, each on its own CUDA stream, feed a
                    backpressured in-process queue; the learner drains it
                    with dynamic batching, and per-trajectory policy lag
                    is *measured* from parameter-store versions. With
                    ``--actor-mode inference`` one driver thread steps
                    every actor's envs on the host and a dynamic-batching
                    inference service runs the policy on the card.
                    ``--actor-backend process`` (``--transport shm``)
                    spawns the actors as CPU children that ship
                    serialized trajectories; ``--actor-backend remote``
                    (``--transport socket``) has them dial a TCP address,
                    and ``--connect HOST:PORT`` runs this machine's
                    actors against a learner listening there. The learner
                    and the inference service stay on the card.
                    ``--learners N`` spawns N learner processes, each
                    owning a shard of the actor slots, that mean-reduce
                    their gradients over a CRC-framed TCP channel every
                    round (on the card every learner opens its own
                    context on the one device).

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
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --runtime async --smoke --replay-fraction 0.5 --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --smoke --steps 30 --ckpt-dir build/ckpt --ckpt-every 10
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --smoke --env chase --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --runtime async --actor-mode inference --smoke --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --runtime async --actor-backend process --transport shm \
      --smoke --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \
      --runtime async --actor-backend remote --listen 0.0.0.0:7000
  PYTHONPATH=src python -m repro_torch.launch.train --connect HOST:7000
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --runtime async --learners 2 --smoke --steps 30

Replay (``--replay-fraction`` > 0) and checkpoints (``--ckpt-dir``) run in
both runtimes, in the JAX package's format: a checkpoint either package
wrote restores in the other. The sync runtime saves and restores params
only (its optimizer state starts afresh on resume, as the JAX CLI's
does); the async runtime saves params only (fleet-v1 with
``--supervise``) and restores those or a fleet-v1 checkpoint with its
optimizer state and version. A learner group saves params only too
(fleet-v1 with ``--supervise``), refuses to run over an existing
checkpoint without ``--resume``, and with it resumes from a fleet-v1
checkpoint only, as the JAX CLI does.

The observability flags (``--metrics-port``, ``--trace``,
``--profile-steps``, ``--telemetry-sink``, ``--telemetry-json`` and
their companions) run the flight recorder (``repro_torch.obs``) in the
async runtime, one learner or a group:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --runtime async --smoke --metrics-port 0 --trace /tmp/t.json \
      --trace-every 1

``--supervise`` (async runtime, one learner or a group) absorbs deaths:
actor threads, process and remote children and spoke learners are
respawned, a dead hub fails over, remote leases silent past
``--heartbeat-timeout-s`` are reaped, ``--elastic`` grows the remote slot
range, and ``--ckpt-dir`` receives the runtime's fleet-v1 checkpoints (a
group resumes from them with ``--resume``). On the sync runtime it changes
nothing, as in the JAX CLI:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --runtime async --learners 2 --supervise --smoke --steps 30

``--arch`` takes the token backbones too (token training): the actor
decodes one token a step against a decode cache of ``unroll + 1`` slots
(K5 on the card), the learner runs the backbone's train mode over the
T+1 tokens, and an MoE backbone adds its routers' aux loss. The vlm and
audio backbones need the stub frontend's embeddings, which the envs do
not give: the CLI stops before a weight is drawn and names the backbone
API that trains them (``apply_train`` with the embeddings in the batch):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --smoke --arch stablelm-1.6b --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \
      --arch stablelm-1.6b --steps 4

Values of the JAX CLI's flags whose paths are not ported yet (the SPMD
learner) end the run with a ``SystemExit`` that names the ROADMAP.md
Queue 1 item.
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
                   help="share of each trained batch drawn from the "
                        "trajectory replay buffer (0 disables replay; "
                        "the paper's replay experiments use 0.5). The "
                        "async learner caps fresh collection at "
                        "(1-fraction) of the batch and tops it up with "
                        "replayed rows, so env-frame consumption per "
                        "update drops by the same share")
    p.add_argument("--replay-capacity", type=int, default=10_000,
                   help="replay buffer size in trajectories (FIFO ring)")
    p.add_argument("--replay-reuse", type=int, default=2,
                   help="K: max TOTAL consumptions per trajectory "
                        "(online pass included); 0 = unlimited. The "
                        "IMPACT-style reuse cap")
    p.add_argument("--replay-priority", default="pertd",
                   choices=["pertd", "uniform"],
                   help="replay sampling: 'pertd' draws proportional to "
                        "the last-seen V-trace advantage magnitude "
                        "(Ape-X prioritization), 'uniform' is the "
                        "paper's uniform mix")
    p.add_argument("--replay-target-period", type=int, default=16,
                   help="updates between target-network syncs: replayed "
                        "rows take the target's values as the V-trace "
                        "baseline (IMPACT), so K reuses chase a fixed "
                        "target")
    p.add_argument("--reward-clip", default="abs_one")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke config of --arch")
    p.add_argument("--runtime", default="sync", choices=["sync", "async"])
    p.add_argument("--actor-threads", type=int, default=2,
                   help="actor worker count (async runtime)")
    p.add_argument("--learners", type=int, default=1,
                   help="learner worker count (async runtime). 1 (the "
                        "default) runs the single-learner loop in this "
                        "process. N>1 spawns N learner processes, each "
                        "owning a disjoint shard of the actor slots "
                        "(--actor-threads is then the TOTAL slot count) "
                        "and its own transport; gradients are "
                        "mean-reduced over a CRC-framed TCP channel every "
                        "round and learner 0 (the designated publisher) "
                        "numbers the param versions. With --listen "
                        "HOST:PORT, learner k binds PORT+k and external "
                        "actors may dial any of them (a full learner "
                        "refuses with the shard map; the actor spills)")
    p.add_argument("--learner-mode", default="process",
                   choices=["process", "spmd"],
                   help="how data-parallel learning scales: 'process' is "
                        "the hub/spoke learner group of --learners N; "
                        "'spmd' (one learner process, the train step "
                        "over a mesh of local devices) is not ported yet")
    p.add_argument("--grad-stale-s", type=float, default=180.0,
                   help="learner-group stale-grad deadline: the hub "
                        "reduces a round without a learner that missed "
                        "this window (the dropped gradient is counted; "
                        "the laggard still applies the broadcast mean, "
                        "so replicas stay identical)")
    p.add_argument("--actor-backend", default="thread",
                   choices=["thread", "process", "remote"],
                   help="where actors live: threads of this interpreter "
                        "on the learner's device, spawned CPU processes "
                        "(serialized trajectories, no GIL shared with "
                        "the learner), or remote machines dialing a TCP "
                        "listen address (--transport socket; without "
                        "--listen the learner spawns loopback children "
                        "itself)")
    p.add_argument("--actor-mode", default="unroll",
                   choices=["unroll", "inference"],
                   help="unroll: every actor runs its own n-step unroll "
                        "with the published params. inference: actors "
                        "are host-side env steppers submitting to one "
                        "dynamic-batching InferenceService on the "
                        "learner's device (paper §3.1; conv-LSTM archs)")
    p.add_argument("--infer-flush-ms", type=float, default=20.0,
                   help="inference service flush deadline: a request "
                        "of a process or remote actor is never held "
                        "past this waiting for a fuller batch. The "
                        "thread backend's driver flushes every step, so "
                        "there it delays nothing (actor_mode=inference)")
    p.add_argument("--no-donate", action="store_true",
                   help="reported as donate=False in the async "
                        "telemetry; the port's learner always updates in "
                        "place and publishes a copy (PyTorch donates no "
                        "buffers)")
    p.add_argument("--transport", default="",
                   choices=["", "inproc", "shm", "socket"],
                   help="trajectory transport; default inproc for thread "
                        "actors, shm (serialized buffers over a "
                        "cross-process wire) for process actors, socket "
                        "(CRC-framed TCP) for remote actors")
    p.add_argument("--listen", default="",
                   help="HOST:PORT the learner binds for remote actors "
                        "(--actor-backend remote). Given: wait for "
                        "--actor-threads external actors to dial in. "
                        "Empty: loopback ephemeral port, and the learner "
                        "spawns its own loopback actor children")
    p.add_argument("--connect", default="",
                   help="run as REMOTE ACTOR(S) instead of a learner: "
                        "dial HOST:PORT, receive the whole run config "
                        "in the handshake, act on the CPU until the "
                        "learner says stop. --actor-threads sets how "
                        "many actor processes this machine contributes")
    p.add_argument("--wire-codec", default="none",
                   choices=["none", "bf16", "int8"],
                   help="quantize serialized wire payloads (published "
                        "params and trajectory observations on the shm "
                        "and socket transports), in the JAX package's "
                        "bytes: bf16 rounds float leaves to bfloat16, "
                        "int8 stores per-leaf absmax scales (max error "
                        "absmax/127); both deflate the other leaves. "
                        "Remote actors take the codec from the handshake")
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
                   help="checkpoint directory: a run restores its latest "
                        "checkpoint and saves every --ckpt-every steps "
                        "(updates) and at the end")
    p.add_argument("--ckpt-every", type=int, default=200)
    p.add_argument("--resume", action="store_true",
                   help="let a --learners N group resume from the latest "
                        "fleet-v1 checkpoint in --ckpt-dir (params + "
                        "optimizer state + version, continuing the "
                        "monotonic version stream); without it a group "
                        "refuses to run over an existing checkpoint. "
                        "Single-learner runs resume from --ckpt-dir "
                        "automatically")
    p.add_argument("--supervise", action="store_true",
                   help="self-healing fleet mode (async runtime): "
                        "heartbeat liveness + lease reaping for remote "
                        "actors, supervised respawn of dead actor "
                        "children / threads / spoke learners (restart "
                        "budget + backoff), hub failover (the lowest "
                        "live learner id is promoted; survivors degrade "
                        "to solo past the deadline), and periodic full "
                        "checkpoints (params + opt state) to --ckpt-dir")
    p.add_argument("--heartbeat-timeout-s", type=float, default=10.0,
                   help="remote-actor liveness deadline (--supervise): "
                        "a slot silent this long has its lease reaped; "
                        "clients heartbeat at a third of it")
    p.add_argument("--elastic", action="store_true",
                   help="with --supervise: let late-dialing remote "
                        "actors grow the slot range past "
                        "--actor-threads instead of being refused")
    p.add_argument("--failover-deadline-s", type=float, default=20.0,
                   help="learner-group hub failover budget: a survivor "
                        "that cannot rejoin a new hub within this many "
                        "seconds degrades to solo training (loud "
                        "degraded_solo telemetry flag)")
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    obs = p.add_argument_group("observability (async runtime)")
    obs.add_argument("--metrics-port", type=int, default=None,
                     help="serve /metrics (Prometheus), /healthz and "
                          "/telemetry (JSON) from a background HTTP "
                          "server on the learner (0 = ephemeral port; "
                          "with --learners N the parent aggregates the "
                          "whole group behind this one port)")
    obs.add_argument("--metrics-host", default="127.0.0.1",
                     help="bind address for --metrics-port")
    obs.add_argument("--telemetry-json", default="",
                     help="write the complete final telemetry snapshot "
                          "(merged across learners for --learners N) to "
                          "this path as JSON")
    obs.add_argument("--trace", default="", dest="trace_path",
                     help="record sampled per-trajectory lifecycle spans "
                          "(env unroll -> encode -> transport -> queue "
                          "wait -> collect -> step -> publish) and write "
                          "Chrome trace-event JSON here (load in "
                          "Perfetto). Single-learner async runs")
    obs.add_argument("--trace-every", type=int, default=64,
                     help="sample every Nth trajectory per actor for "
                          "--trace")
    obs.add_argument("--profile-steps", default="",
                     help="A:B: run torch.profiler (host and device "
                          "activity) over learner updates A to B, both "
                          "included, and write its Chrome trace into "
                          "--profile-dir")
    obs.add_argument("--profile-dir", default="/tmp/repro-profile",
                     help="output directory for --profile-steps traces")
    obs.add_argument("--telemetry-sink", default="",
                     help="append periodic JSONL telemetry snapshots to "
                          "this path while training")
    obs.add_argument("--sink-interval-s", type=float, default=5.0,
                     help="seconds between --telemetry-sink lines")
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


def _unported(flag: str, item: str, name: str) -> SystemExit:
    return SystemExit(f"{flag} is not ported yet (ROADMAP.md, Queue 1 item "
                      f"{item}: {name})")


def _refuse_unported(args) -> None:
    if args.learner_mode == "spmd":
        if args.runtime != "async":
            raise SystemExit("--learner-mode spmd requires "
                             "--runtime async")
        if args.learners > 1:
            raise SystemExit("--learner-mode spmd keeps ONE learner "
                             "process; drop --learners (device "
                             "parallelism comes from --spmd-devices)")
    if args.learner_mode == "spmd":
        raise _unported("--learner-mode spmd", "15C", "the SPMD learner")


def _build_obs(args):
    """ObsConfig from the CLI flags, or None when no obs flag is set
    (the runtime then skips all instrumentation glue)."""
    wants = (args.metrics_port is not None or args.trace_path
             or args.profile_steps or args.telemetry_sink)
    if not wants:
        return None
    from repro_torch.obs import ObsConfig
    return ObsConfig(
        metrics_port=args.metrics_port,
        metrics_host=args.metrics_host,
        trace_path=args.trace_path or None,
        trace_every=max(1, args.trace_every),
        profile_steps=args.profile_steps or None,
        profile_dir=args.profile_dir,
        sink_path=args.telemetry_sink or None,
        sink_interval_s=args.sink_interval_s)


def _dump_telemetry(path: str, tel) -> None:
    with open(path, "w") as f:
        json.dump(tel, f, default=float, indent=2)
        f.write("\n")
    print(f"telemetry snapshot written to {path}")


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


@dataclasses.dataclass
class GroupRun:
    """What a learner group's run leaves behind for its caller."""
    params: Dict                 # the publisher's final params, host numpy
    #                              trees in the JAX layout
    metrics: Dict[str, float]
    telemetry: Dict[str, Any]    # merged: per-learner under "learners"
    arch: ArchConfig
    icfg: ImpalaConfig
    env: Env
    tracker: Any                 # distributed.group.GroupTracker
    kernel_counts: Dict[int, Dict]   # K1/K2 launches and shapes a learner


def train(argv: Optional[List[str]] = None,
          on_update: Optional[Callable] = None
          ) -> Union[SyncRun, AsyncRun, GroupRun, int]:
    """Parse the CLI flags and run the trainer. ``on_update(update_index,
    published params, metrics, snapshot_fn)``, for ``--runtime async``
    with one learner only, runs after each update's log line, on the
    learner's thread. With ``--connect`` this process runs remote actors
    instead and the result is their exit code."""
    args = _parser().parse_args(argv)
    if args.connect:
        # remote actor mode: every run parameter arrives in the
        # connection handshake, so none of the learner flags apply here
        return _run_remote_actors(args)
    _refuse_unported(args)
    if on_update is not None and (args.runtime != "async" or
                                  args.learners > 1):
        raise ValueError("on_update is a hook of --runtime async with one "
                         "learner (a group's updates run in its workers)")
    device = resolve_device(args.device)

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.envs import make_env

    env = make_env(args.env)
    arch = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if arch.family in ("vlm", "audio"):
        key = "image_embed" if arch.family == "vlm" else "enc_embed"
        raise SystemExit(
            f"--arch {args.arch}: this {arch.family} backbone needs the stub "
            f"frontend's embeddings, which the envs do not give; train it "
            f"through repro_torch.models.backbone (apply_train with "
            f"batch['{key}']) and repro_torch.core.learner "
            f"(build_train_step, with '{key}' in the batch)")
    if arch.family == "impala_cnn":
        arch = arch.replace(image_hw=env.image_hw)
    elif arch.vocab_size < env.vocab_size:
        arch = arch.replace(vocab_size=env.vocab_size)
    icfg = ImpalaConfig(
        num_actions=env.num_actions, unroll_length=args.unroll,
        learning_rate=args.lr, entropy_cost=args.entropy_cost,
        rmsprop_eps=args.rmsprop_eps, policy_lag=args.policy_lag,
        correction=args.correction, replay_fraction=args.replay_fraction,
        replay_capacity=args.replay_capacity,
        replay_reuse=args.replay_reuse,
        replay_priority=args.replay_priority,
        replay_target_period=args.replay_target_period,
        reward_clip=args.reward_clip)
    if args.runtime == "async":
        return _run_async(args, env, arch, icfg, device, on_update)
    return _run_sync(args, env, arch, icfg, device)


def _run_sync(args, env, arch, icfg, device) -> SyncRun:
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.driver import init_params, sync_loop
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    specs = bb.backbone_specs(arch, env.num_actions)
    print(f"arch={arch.name} params={common.param_count(specs):,} "
          f"env={env.name} actions={env.num_actions} runtime=sync")
    print(f"device={device}" + (f" ({torch.cuda.get_device_name(device)})"
                                if device.type == "cuda" else ""))
    params = init_params(arch, env.num_actions, args.seed, device)
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        params, start_step = ckpt.restore(args.ckpt_dir, params)
        print(f"restored checkpoint at step {start_step}")

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
    for step, params, metrics, batch in sync_loop(
            env, arch, icfg, args.num_envs, args.steps, tracker, args.seed,
            device, initial_params=params, start_step=start_step):
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
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, params)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, params)
    print(f"final return(100) = {tracker.mean_return():.3f}")
    return SyncRun(params, metrics, batch, arch, icfg, env, fps, log,
                   tracker)


# the keys of the final ``telemetry:`` line, the JAX CLI's
TELEMETRY_KEYS = ("learner_updates", "frames_consumed", "updates_per_sec",
                  "frames_per_sec", "batch_size_hist", "lag", "queue",
                  "actors", "param_version")


def _run_async(args, env, arch, icfg, device, hook) -> AsyncRun:
    from repro_torch import params as params_lib
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.driver import init_params
    from repro_torch.distributed import run_async_training
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    transport = args.transport or {
        "process": "shm", "remote": "socket"}.get(args.actor_backend,
                                                  "inproc")
    if args.actor_backend == "process" and transport != "shm":
        raise SystemExit("--actor-backend process requires --transport shm")
    if args.actor_backend == "remote" and transport != "socket":
        raise SystemExit("--actor-backend remote requires "
                         "--transport socket")
    if transport == "socket" and args.actor_backend != "remote":
        raise SystemExit("--transport socket requires --actor-backend "
                         "remote")
    if args.learners > 1:
        return _run_group(args, env, arch, icfg, transport, device)
    listen_addr = (_parse_hostport(args.listen, default_host="0.0.0.0")
                   if args.listen else None)
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
    initial_params, initial_opt, start_step = None, None, 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        tree, ck_step, extra = ckpt.load_with_extra(args.ckpt_dir)
        if (extra or {}).get("format") == "fleet-v1":
            # full resume: params + optimizer state + version, so the run
            # continues the monotonic version stream
            initial_params = params_lib.from_jax(tree["params"], device)
            initial_opt = params_lib.from_jax(tree["opt"], device,
                                              requires_grad=False)
            start_step = int(extra.get("version", ck_step))
            print(f"restored fleet checkpoint at version {start_step} "
                  f"(params + optimizer state)")
        else:
            initial_params, start_step = ckpt.restore(
                args.ckpt_dir,
                init_params(arch, env.num_actions, args.seed, device))
            print(f"restored checkpoint at step {start_step}")
    last_params: List[Dict] = [{}]

    def on_update(step, params, metrics, snapshot_fn):
        last_params[0] = params
        if step % args.log_every == 0:
            tel = snapshot_fn()
            lag, q = tel["lag"], tel["queue"]
            extra = ""
            if "inference" in tel:
                inf = tel["inference"]
                extra = (f" infer(batch/wait_p95)={inf['mean_batch']:.1f}/"
                         f"{inf['queue_wait_ms_p95']:.1f}ms")
            print(f"update {step:6d} "
                  f"loss={float(metrics['loss/total']):10.2f} "
                  f"lag(mean/max)={lag['mean']:.2f}/{lag['max']} "
                  f"queue(occ/drop/stall)={q['mean_occupancy']:.1f}/"
                  f"{q['dropped']}/{q['put_stalls']} "
                  f"learner_fps={tel['frames_per_sec']:7.0f} "
                  f"actor_fps={tel['actors']['actor_fps']:7.0f}" + extra)
        if args.ckpt_dir and step % args.ckpt_every == 0 and \
                not args.supervise:
            # params-only saves; --supervise switches to the runtime's
            # fleet-v1 checkpoints instead
            ckpt.save(args.ckpt_dir, step, params)
        if hook is not None:
            hook(step, params, metrics, snapshot_fn)

    tracker, metrics, tel = run_async_training(
        env if args.actor_backend == "thread" else args.env, icfg,
        args.num_envs, args.steps,
        num_actors=args.actor_threads, actor_backend=args.actor_backend,
        actor_mode=args.actor_mode, transport=transport,
        listen_addr=listen_addr, spawn_remote=not args.listen,
        wire_codec=args.wire_codec,
        queue_capacity=args.queue_capacity, queue_policy=args.queue_policy,
        max_batch_trajs=args.max_batch_trajs, donate=not args.no_donate,
        infer_flush_timeout_s=args.infer_flush_ms / 1e3,
        vtrace_impl=args.vtrace_impl, seed=args.seed, arch=arch,
        initial_params=initial_params, initial_opt_state=initial_opt,
        start_step=start_step, on_update=on_update, obs=_build_obs(args),
        supervise=args.supervise,
        heartbeat_timeout_s=args.heartbeat_timeout_s, elastic=args.elastic,
        ckpt_dir=(args.ckpt_dir if args.supervise else None),
        ckpt_every=args.ckpt_every, device=device)
    if args.ckpt_dir and last_params[0] and not args.supervise:
        ckpt.save(args.ckpt_dir, args.steps, last_params[0])
    print(f"final return(100) = {tracker.mean_return():.3f}")
    keys = TELEMETRY_KEYS + tuple(k for k in ("inference", "replay")
                                  if k in tel)
    print("telemetry:", json.dumps({k: tel[k] for k in keys},
                                   default=float))
    if args.telemetry_json:
        _dump_telemetry(args.telemetry_json, tel)
    return AsyncRun(last_params[0], metrics, tel, arch, icfg, env, tracker)


def _run_group(args, env, arch, icfg, transport, device) -> GroupRun:
    """N>1 learner processes: sharded actors, the gradient exchange over
    the framed channel, one designated publisher. Over an existing
    checkpoint it refuses unless ``--resume`` is given, and resumes only
    from a fleet-v1 one (params + optimizer state + version), continuing
    the version stream. ``transport`` arrives resolved and checked."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed import run_group_training
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    resume_from = None
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        step0 = ckpt.latest_step(args.ckpt_dir)
        man = ckpt.read_manifest(args.ckpt_dir)
        fleet = man.get("extra", {}).get("format") == "fleet-v1"
        if not args.resume:
            # refusing beats restarting from scratch AND overwriting the
            # existing checkpoint at the end
            hint = ("pass --resume to continue it"
                    if fleet else "move it aside or pick a fresh "
                                  "--ckpt-dir")
            raise SystemExit(
                f"{args.ckpt_dir!r} already holds a checkpoint "
                f"(step {step0}); {hint}.")
        if not fleet:
            # a params-only checkpoint has no optimizer state to hand the
            # workers
            raise SystemExit(
                f"{args.ckpt_dir!r} holds a params-only checkpoint "
                f"(step {step0}); a learner group resumes only from "
                f"fleet-v1 checkpoints (params + optimizer state — "
                f"written by --supervise runs). Move it aside or pick "
                f"a fresh --ckpt-dir.")
        resume_from = args.ckpt_dir
        print(f"resuming learner group from fleet checkpoint "
              f"(step {step0})")
    listen_addr = (_parse_hostport(args.listen, default_host="0.0.0.0")
                   if args.listen else None)
    specs = bb.backbone_specs(arch, env.num_actions)
    print(f"arch={arch.name} params={common.param_count(specs):,} "
          f"env={env.name} actions={env.num_actions} runtime=async "
          f"learners={args.learners} "
          f"actors={args.actor_threads}({args.actor_backend}/"
          f"{args.actor_mode}) transport={transport} "
          f"queue={args.queue_capacity}/{args.queue_policy} "
          f"max_batch_trajs={args.max_batch_trajs} "
          f"donate={not args.no_donate}")
    print(f"device={device}" + (f" ({torch.cuda.get_device_name(device)})"
                                if device.type == "cuda" else ""))

    def on_progress(learner_id, snap):
        lag, q = snap["lag"], snap["queue"]
        ex = snap.get("exchange", {})
        print(f"learner {learner_id} update {snap['learner_updates']:6d} "
              f"lag(mean/max)={lag['mean']:.2f}/{lag['max']} "
              f"queue(occ/stall)={q.get('mean_occupancy', 0.0):.1f}/"
              f"{q.get('put_stalls', 0)} "
              f"fps={snap['frames_per_sec']:7.0f} "
              f"reduce_ms={ex.get('reduce_wait_ms_mean', 0.0):.1f} "
              f"stale={ex.get('stale_dropped', 0)}", flush=True)

    kernel_counts: Dict[int, Dict] = {}
    tracker, metrics, tel, params = run_group_training(
        args.env, icfg, args.num_envs, args.steps,
        num_learners=args.learners, num_actors=args.actor_threads,
        actor_backend=args.actor_backend, actor_mode=args.actor_mode,
        transport=transport, listen_addr=listen_addr,
        spawn_remote=not args.listen,
        queue_capacity=args.queue_capacity, queue_policy=args.queue_policy,
        max_batch_trajs=args.max_batch_trajs, donate=not args.no_donate,
        stale_after_s=args.grad_stale_s,
        infer_flush_timeout_s=args.infer_flush_ms / 1e3,
        wire_codec=args.wire_codec, vtrace_impl=args.vtrace_impl,
        seed=args.seed, arch=arch,
        telemetry_every=args.log_every, on_progress=on_progress,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        # params-only saves without --supervise; a supervised group saves
        # fleet-v1 (params + optimizer state) through ckpt_dir instead
        on_checkpoint=((lambda step, p: ckpt.save(args.ckpt_dir, step, p))
                       if args.ckpt_dir and not args.supervise else None),
        supervise=args.supervise,
        failover_deadline_s=args.failover_deadline_s,
        ckpt_dir=args.ckpt_dir if args.supervise else None,
        resume_from=resume_from, return_final_params=True,
        kernel_counts=kernel_counts, obs=_build_obs(args), device=device)
    if args.ckpt_dir and not args.supervise:
        ckpt.save(args.ckpt_dir, args.steps, params)
    print(f"final return(100) = {tracker.mean_return():.3f}")
    keys = ["group", "learner_updates", "frames_consumed",
            "updates_per_sec", "frames_per_sec", "lag", "actors",
            "param_version"] + [k for k in ("replay",) if k in tel]
    print("telemetry:", json.dumps({k: tel[k] for k in keys},
                                   default=float))
    per = tel["actors"]["per_learner_trajectories"]
    print("per-learner trajectories:", json.dumps(per))
    if args.telemetry_json:
        _dump_telemetry(args.telemetry_json, tel)
    return GroupRun(params, metrics, tel, arch, icfg, env, tracker,
                    kernel_counts)


def _parse_hostport(spec: str, default_host: str = "127.0.0.1"):
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"expected HOST:PORT, got {spec!r}")
    return (host or default_host, int(port))


def _run_remote_actors(args) -> int:
    """``--connect HOST:PORT``: contribute ``--actor-threads`` actor
    processes (on this machine's CPU) to the learner listening there.
    Returns the exit code: nonzero if any actor failed."""
    import multiprocessing as mp

    from repro_torch.distributed.netserve import (remote_actor_child,
                                                  remote_actor_main)
    from repro_torch.distributed.supervise import KillSafeEvent

    addr = _parse_hostport(args.connect)
    n = max(1, args.actor_threads)
    print(f"remote actor mode: {n} actor process(es) -> "
          f"{addr[0]}:{addr[1]}", flush=True)
    if n == 1:
        err = remote_actor_main(addr)
        if err:
            print(err)
            return 1
        print("learner said stop; exiting cleanly")
        return 0
    ctx = mp.get_context("spawn")
    stop = KillSafeEvent(ctx)
    procs = [ctx.Process(target=remote_actor_child, args=(addr, stop),
                         name=f"remote-actor-{i}") for i in range(n)]
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join()
    except KeyboardInterrupt:
        stop.set()
        for proc in procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
        return 0
    # a failed actor (dial timeout, refusal, crash) exits nonzero
    return 1 if any(p.exitcode not in (0, None) for p in procs) else 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> int:
    out = train(argv)
    return out if isinstance(out, int) else 0


if __name__ == "__main__":
    raise SystemExit(main())
