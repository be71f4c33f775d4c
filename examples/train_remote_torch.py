"""Remote actors over TCP on PyTorch: the paper's cross-machine
deployment shape, as ``examples/train_remote.py`` does with the JAX
package.

The launcher pair. Terminal 1, the learner (on the card by default)
listens and waits:

  PYTHONPATH=src python examples/train_remote_torch.py learner --port 41017

Terminal 2 (any machine that can reach it): actors dial in, receive the
ENTIRE run configuration (env, architecture, seed, actor id, mode) in
the connection handshake, and start acting on their CPU; they need no
flags beyond the address:

  PYTHONPATH=src python examples/train_remote_torch.py actor \\
      --connect 127.0.0.1:41017 --num 2

A single-terminal demo (the learner spawns its own loopback "remote"
actors: the same code path, one box):

  PYTHONPATH=src python examples/train_remote_torch.py demo

Trajectories travel as length-prefixed CRC-checked frames; parameters
flow back version-gated over each actor's control connection; a severed
link reconnects with backoff and loses at most the in-flight trajectory.
Run ``demo --mode inference`` to serve actions from the learner-side
InferenceService instead: then the remote machines hold no parameters
at all. ``--port 0`` listens on a free port, which the learner prints.
"""
import argparse
import json

STEPS = 400
NUM_ENVS, LOG_EVERY = 32, 100


def _parse(spec, default_host="127.0.0.1"):
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"expected HOST:PORT, got {spec!r}")
    return (host or default_host, int(port))


def _train(listen_addr, spawn_remote, num_actors, mode, args):
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.envs import make_catch
    from repro_torch.distributed import run_async_training
    from repro_torch.launch.train import resolve_device

    device = resolve_device(args.device)
    env = make_catch()
    arch = get_smoke_config("impala-shallow").replace(
        image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                       learning_rate=6e-4, entropy_cost=0.003,
                       rmsprop_eps=0.01)

    def log(step, params, metrics, snapshot_fn):
        if step % LOG_EVERY == 0:
            tel = snapshot_fn()
            q = tel["queue"]
            print(f"update {step}: loss={float(metrics['loss/total']):.2f} "
                  f"lag(mean)={tel['lag']['mean']:.2f} "
                  f"net={q['bytes_per_sec'] / 1e6:.2f}MB/s "
                  f"reconnects={q['reconnects']} "
                  f"fps={tel['frames_per_sec']:.0f}")

    tracker, metrics, tel = run_async_training(
        "catch", cfg, num_envs=NUM_ENVS, steps=STEPS,
        num_actors=num_actors, actor_backend="remote", actor_mode=mode,
        transport="socket", listen_addr=listen_addr,
        spawn_remote=spawn_remote, queue_capacity=8, queue_policy="block",
        max_batch_trajs=4, seed=0, arch=arch, on_update=log, device=device)

    q = tel["queue"]
    print(f"return(100) = {tracker.mean_return():.3f} "
          f"(optimal 1.0, random ~ -0.6)")
    print(f"socket: {q['frames_in']} frames, {q['bytes_in'] / 1e6:.1f}MB, "
          f"{q['reconnects']} reconnects, {q['torn_tails']} torn tails, "
          f"{q['decode_errors']} decode errors")
    print("per-actor:", json.dumps(q["per_actor"], default=float))
    assert q["frames_in"] > 0, "trajectories must cross the socket"
    assert q["decode_errors"] == 0, "no torn frame may reach the learner"
    print("done.")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pl = sub.add_parser("learner", help="listen and wait for actors")
    pl.add_argument("--port", type=int, default=41017)
    pl.add_argument("--host", default="0.0.0.0")
    pl.add_argument("--actors", type=int, default=2,
                    help="how many remote actors to expect")
    pl.add_argument("--mode", default="unroll",
                    choices=["unroll", "inference"])
    pl.add_argument("--device", default="cuda")
    pa = sub.add_parser("actor", help="dial a learner and act")
    pa.add_argument("--connect", required=True, metavar="HOST:PORT")
    pa.add_argument("--num", type=int, default=1,
                    help="actor processes this machine contributes")
    pd = sub.add_parser("demo", help="single-terminal loopback demo")
    pd.add_argument("--actors", type=int, default=2)
    pd.add_argument("--mode", default="unroll",
                    choices=["unroll", "inference"])
    pd.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.cmd == "learner":
        _train((args.host, args.port), spawn_remote=False,
               num_actors=args.actors, mode=args.mode, args=args)
    elif args.cmd == "actor":
        import multiprocessing as mp
        addr = _parse(args.connect)
        if args.num == 1:
            import os
            from repro_torch.distributed.netserve import remote_actor_main
            err = remote_actor_main(addr)
            if err:
                raise SystemExit(err)
            print("learner said stop; exiting cleanly")
            os._exit(0)     # skip the interpreter's teardown, as a child
        else:
            from repro_torch.distributed.netserve import remote_actor_child
            ctx = mp.get_context("spawn")
            stop = ctx.Event()
            procs = [ctx.Process(target=remote_actor_child,
                                 args=(addr, stop))
                     for _ in range(args.num)]
            for proc in procs:
                proc.start()
            for proc in procs:
                proc.join()
    else:
        _train(None, spawn_remote=True, num_actors=args.actors,
               mode=args.mode, args=args)


if __name__ == "__main__":
    main()
