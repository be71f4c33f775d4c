"""Async quickstart on PyTorch: the paper's actual architecture, actors
decoupled from the learner, running as real threads in one process, as
``examples/train_async.py`` does with the JAX package.

Two actor threads each drive their own batch of `catch` envs (each on its
own CUDA stream on the card); trajectories flow through a bounded
backpressured queue; the learner stacks up to 4 of them an update
(dynamic batching, the fused V-trace loss kernel on the card) and
publishes params through a versioned store. Policy lag is *measured* per
trajectory: the lag histogram in the final telemetry is the off-policy
gap that V-trace corrects.

A second, shorter run switches the same actors to **inference mode**
(paper §3.1's dynamic batching): every actor steps envs on the host and
submits its observation batch to one InferenceService that batches
across actors into power-of-two buckets on the learner's device.

  PYTHONPATH=src python examples/train_async_torch.py [--device cpu]
"""
import argparse
import json

from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.envs import make_catch
from repro_torch.distributed import run_async_training
from repro_torch.launch.train import resolve_device

STEPS, INFERENCE_STEPS, NUM_ENVS, LOG_EVERY = 400, 200, 32, 100


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = make_catch()
    arch = get_smoke_config("impala-shallow").replace(image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                       learning_rate=6e-4, entropy_cost=0.003,
                       rmsprop_eps=0.01)

    def log(step, params, metrics, snapshot_fn):
        if step % LOG_EVERY == 0:
            tel = snapshot_fn()
            print(f"update {step}: loss={float(metrics['loss/total']):.2f} "
                  f"lag(mean)={tel['lag']['mean']:.2f} "
                  f"queue_occ={tel['queue']['mean_occupancy']:.1f} "
                  f"fps={tel['frames_per_sec']:.0f}")

    tracker, metrics, tel = run_async_training(
        env, cfg, num_envs=NUM_ENVS, steps=STEPS, num_actors=2,
        queue_capacity=8, queue_policy="block", max_batch_trajs=4,
        seed=0, arch=arch, on_update=log, device=device)

    print(f"return(100) = {tracker.mean_return():.3f} "
          f"(optimal 1.0, random ~ -0.6)")
    print("measured lag histogram:", json.dumps(tel["lag"]["hist"]))
    print("queue:", json.dumps(tel["queue"]))
    assert tel["lag"]["max"] > 0, "async run must show real policy lag"

    print("\n-- same actors, inference mode: one dynamic-batching "
          "service forward instead of per-actor unrolls --")
    tracker2, _, tel2 = run_async_training(
        env, cfg, num_envs=NUM_ENVS, steps=INFERENCE_STEPS,
        num_actors=2, actor_mode="inference", queue_capacity=8,
        queue_policy="block", max_batch_trajs=4, seed=0, arch=arch,
        device=device)
    inf = tel2["inference"]
    print(f"return(100) = {tracker2.mean_return():.3f} after "
          f"{tel2['learner_updates']} updates")
    print(f"service: {inf['flushes']} flushes "
          f"(full={inf['flush_full']} ready={inf['flush_ready']} "
          f"timeout={inf['flush_timeout']}), "
          f"mean batch {inf['mean_batch']:.2f}")
    print("batch-size histogram:", json.dumps(inf["batch_size_hist"]))
    print(f"queue wait p50/p95 = {inf['queue_wait_ms_p50']:.2f}/"
          f"{inf['queue_wait_ms_p95']:.2f} ms")
    assert tel2["lag"]["measured"] > 0, "inference mode must measure lag"
    print("done.")


if __name__ == "__main__":
    main()
