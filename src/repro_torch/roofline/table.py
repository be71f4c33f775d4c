"""Aggregate the port's dry-run records into the roofline markdown table
(``repro.roofline.table``: the same columns, the fit against one H100's
80 GB, and no collective term where a record has none).

  PYTHONPATH=src python -m repro_torch.roofline.table \\
      [--dir results/dryrun_torch] [--mesh 16x16] [--rules baseline]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

ARCH_ORDER = [
    "recurrentgemma-2b", "granite-moe-1b-a400m", "whisper-small",
    "mamba2-1.3b", "stablelm-1.6b", "gemma-7b", "qwen1.5-4b",
    "llama-3.2-vision-11b", "mistral-nemo-12b", "olmoe-1b-7b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: str, mesh: str, rules: str = "baseline") -> List[Dict]:
    pod = "pod2" if mesh.startswith("2x") else "pod1"
    out = []
    for f in glob.glob(os.path.join(dir_, f"*_{pod}_{rules}.json")):
        with open(f) as fh:
            d = json.load(fh)
        if d.get("rules") == rules:
            out.append(d)
    key = {(a, s): (i, j) for i, a in enumerate(ARCH_ORDER)
           for j, s in enumerate(SHAPE_ORDER)}
    out.sort(key=lambda d: key.get((d["arch"], d["shape"]), (99, 99)))
    return out


def fmt_ms(s: Optional[float]) -> str:
    if s is None:
        return "none"
    if s >= 1.0:
        return f"{s:.2f}s"
    return f"{s*1e3:.1f}ms"


def render(records: List[Dict], markdown: bool = True) -> str:
    lines = []
    hdr = ("| arch | shape | status | compute | memory | collective | "
           "bottleneck | useful/counted | mem-model/dev | fits 80 GB |")
    sep = "|" + "---|" * 10
    lines.append(hdr)
    lines.append(sep)
    for d in records:
        if d["status"] == "skip":
            lines.append(f"| {d['arch']} | {d['shape']} | SKIP "
                         f"({d['reason'][:40]}…) | | | | | | | |")
            continue
        if d["status"] != "ok":
            lines.append(f"| {d['arch']} | {d['shape']} | ERROR "
                         f"| | | | | | | |")
            continue
        r = d["roofline"]
        mm = d.get("memory_model", {})
        lines.append(
            f"| {d['arch']} | {d['shape']} | ok | {fmt_ms(r['compute_s'])} "
            f"| {fmt_ms(r['memory_s'])} | {fmt_ms(r['collective_s'])} "
            f"| **{r['bottleneck']}** "
            f"| {r.get('useful_flops_ratio', 0) or 0:.2f} "
            f"| {mm.get('total', 0)/1e9:.1f}GB "
            f"| {'Y' if mm.get('fits_80g') else 'N'} |")
    return "\n".join(lines)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="results/dryrun_torch")
    p.add_argument("--mesh", default="16x16")
    p.add_argument("--rules", default="baseline")
    args = p.parse_args()
    records = load(args.dir, args.mesh, args.rules)
    print(f"### Roofline — mesh {args.mesh}, rules {args.rules} "
          f"({len(records)} pairs)\n")
    print(render(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
