"""Multi-process actors on PyTorch: the paper's deployment shape on one
machine, as ``examples/train_multiproc.py`` does with the JAX package.

Two actor *processes* (own interpreter, own env batch, on the CPU: no GIL
shared with the learner) act `catch` and ship serde-encoded trajectory
buffers over the shm transport; the learner (on the card by default, the
fused V-trace loss kernel) drains them with dynamic batching and
publishes parameters back through the store's serialized subscribe path
(encoded once a version, pulled by version over a pipe). Same loop body,
same telemetry as the thread backend: only the transport changed.

  PYTHONPATH=src python examples/train_multiproc_torch.py [--device cpu]
"""
import argparse
import json

from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.envs import make_catch
from repro_torch.distributed import run_async_training
from repro_torch.launch.train import resolve_device

STEPS, NUM_ENVS, LOG_EVERY = 400, 32, 100


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
            q = tel["queue"]
            print(f"update {step}: loss={float(metrics['loss/total']):.2f} "
                  f"lag(mean)={tel['lag']['mean']:.2f} "
                  f"wire_mb={q['wire_bytes'] / 1e6:.1f} "
                  f"fps={tel['frames_per_sec']:.0f}")

    tracker, metrics, tel = run_async_training(
        "catch", cfg, num_envs=NUM_ENVS, steps=STEPS,
        num_actors=2, actor_backend="process", transport="shm",
        queue_capacity=8, queue_policy="block", max_batch_trajs=4,
        seed=0, arch=arch, on_update=log, device=device)

    print(f"return(100) = {tracker.mean_return():.3f} "
          f"(optimal 1.0, random ~ -0.6)")
    print("measured lag histogram:", json.dumps(tel["lag"]["hist"]))
    print("transport:", json.dumps(tel["queue"]))
    assert tel["queue"]["wire_received"] > 0, \
        "trajectories must cross the wire"
    assert tel["lag"]["max"] > 0, "async run must show real policy lag"
    print("done.")


if __name__ == "__main__":
    main()
