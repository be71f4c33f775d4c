"""Dry-run sweep orchestrator (``repro.launch.sweep``): every (arch x
shape) on 1-pod and 2-pod meshes, each in its own subprocess of
``python -m repro_torch.launch.dryrun`` (on meta tensors, no device),
bounded parallelism. Results land in results/dryrun_torch/*.json;
aggregate with ``python -m repro_torch.roofline.table``.

Usage: python -m repro_torch.launch.sweep [--jobs 3]
       [--multi-pod-only|--single-pod-only] [--arch A ...] [--shape S ...]
       [--skip-done]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = [
    "recurrentgemma-2b", "granite-moe-1b-a400m", "whisper-small",
    "mamba2-1.3b", "stablelm-1.6b", "gemma-7b", "qwen1.5-4b",
    "llama-3.2-vision-11b", "mistral-nemo-12b", "olmoe-1b-7b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def run_one(arch: str, shape: str, multi_pod: bool, out: str,
            rules: str = "baseline", timeout: int = 3600) -> int:
    pod = "pod2" if multi_pod else "pod1"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out,
           "--rules", rules]
    if multi_pod:
        cmd.append("--multi-pod")
    t0 = time.time()
    try:
        r = subprocess.run(cmd, timeout=timeout, capture_output=True,
                           text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(f"!! {arch} {shape} {pod} rc={r.returncode}\n"
                             + r.stderr[-1500:] + "\n")
        sys.stdout.flush()
        return r.returncode
    except subprocess.TimeoutExpired:
        print(f"!! {arch} {shape} {pod} TIMEOUT after {time.time()-t0:.0f}s",
              flush=True)
        return 124


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--out", default="results/dryrun_torch")
    p.add_argument("--rules", default="baseline")
    p.add_argument("--arch", nargs="*", default=ARCHS)
    p.add_argument("--shape", nargs="*", default=SHAPES)
    p.add_argument("--single-pod-only", action="store_true")
    p.add_argument("--multi-pod-only", action="store_true")
    p.add_argument("--skip-done", action="store_true")
    p.add_argument("--timeout", type=int, default=3600)
    args = p.parse_args()

    pods = [False, True]
    if args.single_pod_only:
        pods = [False]
    if args.multi_pod_only:
        pods = [True]

    jobs = []
    for arch, shape, mp in itertools.product(args.arch, args.shape, pods):
        if args.skip_done:
            pod = "pod2" if mp else "pod1"
            f = os.path.join(args.out,
                             f"{arch}_{shape}_{pod}_{args.rules}.json")
            if os.path.exists(f):
                try:
                    with open(f) as fh:
                        if json.load(fh).get("status") in ("ok", "skip"):
                            continue
                except (OSError, ValueError):
                    pass                # a torn record: run it again
        jobs.append((arch, shape, mp))

    print(f"sweep: {len(jobs)} jobs, {args.jobs} workers", flush=True)
    rc = 0
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = [ex.submit(run_one, a, s, mp, args.out, args.rules,
                          args.timeout) for a, s, mp in jobs]
        for f in futs:
            rc |= f.result()
    return rc


if __name__ == "__main__":
    sys.exit(main())
