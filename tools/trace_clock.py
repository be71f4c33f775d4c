#!/usr/bin/env python3
"""How often a ``torch.profiler`` trace on the card loses device events,
and why: the card's timestamps, converted to the host's clock, now and
then land before the trace's window opens, and the profiler drops them.

    python3 tools/trace_clock.py [--seconds 150] [--out trace_clock.jsonl]
    python3 tools/trace_clock.py --summary trace_clock.jsonl   # no card

For ``--seconds`` it traces, over and over, 50 calls each of K2, K4, K5
and the ``scaled_dot_product_attention`` calls ``chip_smoke.py`` sets
beside them, at the serving shapes, with no idle time around the calls
(as ``chip_smoke.py`` did before it padded its traces), with a second of
matmuls between rounds. Each trace is exported and a line written to
``--out``: the device events it holds, the shift of each kernel's
timestamp from its launch's (``off_min``, ``off_max``, us), and the room
between the window's ends and the first and last kernel (us). Then it
runs ``chip_smoke.py``'s phase 2a, padded and checked, twice. The
summary counts the traces that lost events and the shifts they show.
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CALLS = 50


def _whole(r) -> bool:
    """Whether a trace's line holds every launch of its 50 calls."""
    if r["case"].endswith("lib"):
        return bool(r["names"]) and all(c % CALLS == 0
                                        for c in r["names"].values())
    return r["held"] == CALLS


def summary(path) -> None:
    rs = [json.loads(line) for line in open(path)]
    bad = [r for r in rs if not _whole(r)]
    print(f"{len(rs)} unpadded traces over {max(r['t'] for r in rs):.1f} "
          f"s, {len(bad)} lost events ({100 * len(bad) / len(rs):.2f}%): "
          f"{sum(not r['kernels'] for r in bad)} held none")
    shifted = [r for r in bad if "off_max" in r]
    if shifted:
        print(f"  the {len(shifted)} that held some: every kernel stamped "
              f"{min(-r['off_max'] for r in shifted) / 1e3:.3f}-"
              f"{max(-r['off_min'] for r in shifted) / 1e3:.3f} ms before "
              f"its launch; the first kept kernel "
              f"{min(r['margin_start'] for r in shifted) / 1e3:.3f}-"
              f"{max(r['margin_start'] for r in shifted) / 1e3:.3f} ms "
              f"after the window opens")
    good = [r for r in rs if _whole(r) and "off_min" in r]
    print(f"  whole traces: kernel minus launch stamp "
          f"{min(r['off_min'] for r in good) / 1e3:.3f} to "
          f"{max(r['off_max'] for r in good) / 1e3:.3f} ms, median of the "
          f"least {statistics.median(r['off_min'] for r in good) / 1e3:.3f}"
          f" ms")
    print(f"  seconds at which traces lost events: "
          f"{sorted({round(r['t']) for r in bad})}")


def _analyse(path):
    ev = json.load(open(path))["traceEvents"]
    rt = {e["args"]["correlation"]: e for e in ev
          if e.get("cat") == "cuda_runtime"
          and "correlation" in e.get("args", {})}
    kern = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset")]
    win = [e for e in ev if e.get("cat") == "Trace"]
    offs = [k["ts"] - rt[k["args"]["correlation"]]["ts"] for k in kern
            if k.get("args", {}).get("correlation") in rt]
    r = {"kernels": len(kern), "runtime": len(rt)}
    if offs:
        r["off_min"], r["off_max"] = min(offs), max(offs)
    if win and kern:
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        r["margin_start"] = min(k["ts"] for k in kern) - w0
        r["margin_end"] = w1 - max(k["ts"] + k["dur"] for k in kern)
    return r


def measure(seconds: float, out_path: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import linear_scan as lk
    from repro_torch.kernels import vtrace as vk

    dev = torch.device("cuda", 0)
    build.build()
    build.load()
    print(f"card: {cs._card_line()}")
    inp = cs._inputs(20, 32, 3, 5, dev)
    q, k, v, qt, kt, vt = cs._k4_inputs(16, 128, 32, 8, 128, dev)
    q5, k5, v5, bias, q4, kt5, vt5, mask = cs._k5_inputs(
        16, 32, 8, 128, 128, 0, dev)
    cases = [
        ("loss_vtrace", lambda: vk.loss_vtrace(*inp), "vtrace_tile_kernel"),
        ("flash", lambda: fk.flash_attention(q, k, v, True, 0),
         "flash_attention_kernel"),
        ("flash lib", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), None),
        ("decode", lambda: dk.decode_attention(q5, k5, v5, bias),
         "decode_attention_kernel"),
        ("decode lib", lambda: F.scaled_dot_product_attention(
            q4, kt5, vt5, attn_mask=mask, enable_gqa=True), None),
    ]
    x = torch.randn(4096, 4096, device=dev)
    tmp = tempfile.mkdtemp()
    t0 = time.time()
    with open(out_path, "w") as out:
        while time.time() - t0 < seconds:
            for name, fn, event in cases:
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(CALLS):
                        fn()
                    torch.cuda.synchronize()
                _, count, by_name = cs._device_busy(prof.events())
                held = (sum(c for n, (_, c) in by_name.items() if event in n)
                        if event else count)
                trace = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(trace)
                r = _analyse(trace)
                r.update(t=round(time.time() - t0, 1), case=name, held=held,
                         names={n[:40]: c for n, (_, c) in by_name.items()})
                out.write(json.dumps(r) + "\n")
            for _ in range(20):            # a second of work between rounds
                x = (x @ x).clamp_(-1, 1)
            torch.cuda.synchronize()
    summary(out_path)
    for i in range(2):
        t = time.time()
        cs.phase_device_times(vk, fk, dk, lk, dev)
        print(f"phase 2a, padded, run {i}: {time.time() - t:.1f} s, traces "
              f"taken again: {cs.TRACES_RETAKEN}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--out", default="trace_clock.jsonl")
    ap.add_argument("--summary", help="summarise a written file; no card")
    args = ap.parse_args()
    if args.summary:
        summary(args.summary)
    else:
        measure(args.seconds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
