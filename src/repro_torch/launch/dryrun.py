"""Dry run: trace every (architecture x input shape) on ``meta`` tensors
and record its roofline against one H100 (``repro.launch.dryrun``).

The reference lowers and compiles each step for a 256- or 512-device TPU
mesh and reads XLA's memory and cost analyses. The port has no compiler
to lower to: it resolves the same sharding rules on the same meshes
(``repro_torch.sharding``, no device needed), runs the step eagerly on
``meta`` tensors (shapes and dtypes, no storage) at one device's share
of the batch, and counts it (``roofline.analysis.eager_cost``). It never
initialises CUDA: the dry run needs no card, and ``HW`` is the H100 data
sheet, not a measurement.

Each record keeps the reference's keys. ``memory`` holds the per-device
argument bytes from the rules and the output bytes of the traced step
(``temp_bytes``, ``alias_bytes`` and ``peak_estimate_bytes`` are null:
there is no buffer assignment); ``collectives`` is ``{}`` and
``collective_s`` null (no HLO, no collective term); ``analytic``,
``memory_model`` and ``roofline`` come from the ported models at the
reference's 256/512 devices; ``cost`` is the eager count, whose view
``cost_view`` states. ``lower_s`` is the trace's seconds.

``--moe-impl`` picks the MoE layers' dispatch, as the reference's:
``dense_einsum`` is the one-device dispatch (every config's own), and
``shard_map_a2a`` the expert-parallel route, which on meta counts one
expert rank's work, its E/n experts with n the mesh's ``experts`` axis
(meta has no process group, so the combine's sum is not counted); on a
``train_*`` shape, that rank's forward and backward. Each record's
``moe_impl`` names the dispatch that ran. The port
has no remat: ``--remat-off`` ends the run with a ``SystemExit`` that
says so.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k \\
      [--multi-pod] [--out results/dryrun_torch] [--rules baseline]
  python -m repro_torch.launch.dryrun --list
"""
import argparse
import json
import os
import sys
import time
import traceback

import torch


def run_pair(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: str, rules_name: str = "baseline",
             vtrace_impl: str = "auto",
             mixed_precision: bool = False,
             moe_impl: str = None) -> dict:
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import (HW, make_mesh_2d_tp,
                                         make_production_mesh)
    from repro_torch.models.moe import expert_shards
    from repro_torch.roofline import analysis, flops_model, memory_model
    from repro_torch.sharding import profiles
    from repro_torch.sharding.rules import Rules

    shape = INPUT_SHAPES[shape_name]
    arch = get_config(arch_name)
    used_name = arch_name
    if shape_name == "long_500k" and arch_name == "mistral-nemo-12b":
        from repro_torch.configs.mistral_nemo_12b import swa_variant
        arch = swa_variant()
        used_name = arch.name
    if arch.moe is not None and moe_impl:
        import dataclasses
        arch = arch.replace(moe=dataclasses.replace(
            arch.moe, dispatch_impl=moe_impl))
    tag = rules_name
    if arch.moe is not None and moe_impl == "dense_einsum":
        tag = rules_name + "+densemoe"
    if mixed_precision:
        tag = tag + "+mp"
    expert_parallel = (arch.moe is not None and
                       arch.moe.dispatch_impl == "shard_map_a2a")
    rec = {
        "arch": arch_name, "arch_used": used_name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        # what ran: the MoE layers' dispatch
        "rules": tag,
        "moe_impl": arch.moe.dispatch_impl if arch.moe else None,
        "status": "pending",
    }
    ok, why = steps_lib.pair_supported(arch, shape)
    if not ok:
        rec["status"] = "skip"
        rec["reason"] = why
        return _finish(rec, out_dir)

    t0 = time.time()
    try:
        if rules_name == "tp2d":
            mesh = make_mesh_2d_tp(multi_pod=multi_pod)
        else:
            mesh = make_production_mesh(multi_pod=multi_pod)
        rules = Rules(mesh, profiles.get_profile(rules_name, arch, shape))
        cost, meta = steps_lib.trace_pair(
            arch, shape, mesh, rules, vtrace_impl=vtrace_impl,
            mixed_precision=mixed_precision)
        rec["lower_s"] = round(time.time() - t0, 1)
        moe_view = "MoE layers on their one-device dispatch"
        if expert_parallel:
            moe_view = (f"MoE layers on one expert rank's "
                        f"{arch.moe.num_experts // expert_shards(rules)} of "
                        f"{arch.moe.num_experts} experts"
                        + (", forward and backward" if shape.kind == "train"
                           else "")
                        + ", the combine's sum not counted")
        rec["compile_s"] = None
        mem_model = memory_model.estimate(arch, shape, rules)
        n_dev = 512 if multi_pod else 256
        a_flops, a_bytes = flops_model.step_cost(arch, shape,
                                                 n_devices=n_dev)
        mf = analysis.model_flops(arch, meta["params"], shape,
                                  per_device=True, n_devices=n_dev)
        roof = analysis.analyse(cost, {}, HW, model_flops=mf)
        compute_s = a_flops / HW["peak_flops_bf16"]
        memory_s = a_bytes / HW["hbm_bw"]
        rec.update({
            "status": "ok",
            "n_params": meta["params"],
            "memory": {
                "argument_bytes": meta["argument_bytes"],
                "output_bytes": meta["output_bytes"],
                "temp_bytes": None,
                "alias_bytes": None,
                "peak_estimate_bytes": None,
            },
            # analytic per-device memory model (the reference's), fit
            # against one H100's 80 GB
            "memory_model": mem_model,
            "cost": {
                "flops_per_device": roof.flops_per_device,
                "bytes_per_device": roof.bytes_per_device,
                "kernel_launches": cost["kernel_launches"],
            },
            "cost_view": (
                f"eager_cost of the step run on meta tensors at one "
                f"device's batch shard (batch {meta['local_batch']} of "
                f"{shape.global_batch}), the model axis unsharded; "
                f"operators by torch's flop counter, kernels K1-K5 by "
                f"their meta route; " + moe_view),
            "collectives": roof.collectives,
            # hlo_* terms are the eager count (the reference's came from
            # XLA's cost analysis); analytic_* from roofline/flops_model.py
            "analytic": {
                "flops_per_device": a_flops,
                "bytes_per_device": a_bytes,
                "compute_s": compute_s,
                "memory_s": memory_s,
            },
            "roofline": {
                "hlo_compute_s": roof.compute_s,
                "hlo_memory_s": roof.memory_s,
                "compute_s": compute_s,
                "memory_s": memory_s,
                "collective_s": roof.collective_s,
                "bottleneck": ("compute" if compute_s >= memory_s
                               else "memory"),
                "model_flops_per_device": mf,
                "useful_flops_ratio": mf / max(a_flops, 1.0),
            },
            "hlo_bytes": None,
        })
    except Exception as e:  # noqa: BLE001 (recorded, so a sweep goes on)
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _finish(rec, out_dir)


def _finish(rec: dict, out_dir: str) -> dict:
    if torch.cuda.is_initialized():
        rec["status"] = "error"
        rec["error"] = "the dry run initialised CUDA; it must run on meta"
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        pod = "pod2" if rec["mesh"].startswith("2x") else "pod1"
        name = f"{rec['arch']}_{rec['shape']}_{pod}_{rec['rules']}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    line = (f"[{rec['status']:5s}] {rec['arch']:24s} {rec['shape']:12s} "
            f"{rec['mesh']:8s} rules={rec['rules']}")
    if rec["status"] == "ok":
        r = rec["roofline"]
        line += (f" trace={rec['lower_s']:.0f}s "
                 f"compute={r['compute_s']*1e3:.2f}ms "
                 f"memory={r['memory_s']*1e3:.2f}ms "
                 f"coll=none -> {r['bottleneck']}")
    elif rec["status"] == "error":
        line += " " + rec["error"][:160]
    print(line, flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=False)
    p.add_argument("--shape", required=False)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--rules", default="baseline")
    # 'auto' is what the card runs (K2 via its meta route); the
    # reference's default 'scan' is its XLA scan
    p.add_argument("--vtrace-impl", default="auto")
    p.add_argument("--moe-impl", choices=["shard_map_a2a", "dense_einsum"],
                   help="the MoE layers' dispatch (default: the config's "
                        "own, dense_einsum)")
    p.add_argument("--mixed-precision", action="store_true")
    p.add_argument("--remat-off", action="store_true")
    p.add_argument("--out", default="results/dryrun_torch")
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)
    if args.remat_off:
        raise SystemExit("--remat-off: the port has no remat (ROADMAP.md, "
                         "Queue 3), so every record is already without it")
    if args.list:
        from repro_torch.configs.base import INPUT_SHAPES
        from repro_torch.configs.registry import ASSIGNED
        for a in ASSIGNED:
            for s in INPUT_SHAPES:
                print(a.replace("_", "-"), s)
        return 0
    rec = run_pair(args.arch, args.shape, args.multi_pod, args.out,
                   args.rules, args.vtrace_impl, args.mixed_precision,
                   args.moe_impl)
    return 0 if rec["status"] in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
