"""The server (``repro.launch.serve``): a batched actor-inference
service over a token backbone (the dynamic-batching role of paper §3.1,
Fig. 2, as a standalone process).

Requests (observation streams of ``--ctx`` tokens) wait in a host-side
queue; the server takes up to ``--batch`` of them, pads a short batch to
``--batch`` (shapes stay static), prefills each stream's context once,
then steps all streams in lockstep through ``--decode-steps`` decode
steps against the decode cache, one sampled action per stream per step.
The kernels on the card, per family:

* ``dense`` (mistral-nemo-12b, the default ``--arch``; gemma-7b,
  qwen1.5-4b, stablelm-1.6b): prefill attention runs K4 (flash
  attention) once a layer and each decode step runs K5 (decode
  attention) once a layer, against the KV cache.
* ``ssm`` (``--arch mamba2-1.3b``): each prefill runs K3 (the linear
  scan) once a layer, for the cross-chunk state pass; a decode step
  updates each layer's SSM and conv states and launches no kernel of the
  port.
* ``hybrid`` (``--arch recurrentgemma-2b``): each prefill runs K3 once a
  recurrent (RG-LRU) layer, for its diagonal recurrence, and K4 once a
  local-attention layer; each decode step runs K5 once a local-attention
  layer, against its ring buffer of ``min(ctx, window)`` slots, and
  launches no K3 (the recurrent layers update their states in place).
* ``moe`` (``--arch granite-moe-1b-a400m``, ``olmoe-1b-7b``): as dense,
  K4 once a layer each prefill and K5 once a layer each decode step; the
  top-k router, the capacity dispatch, the expert products and the
  combine between them are PyTorch calls, as the reference computes them
  outside any kernel.

The ``vlm`` and ``audio`` backbones (llama-3.2-vision-11b, whisper-small)
are not served: the server sends tokens only, and they need the stub
frontend's image or frame embeddings. They run through
``repro_torch.models.backbone`` (``apply_prefill`` with
``batch["image_embed"]`` or ``batch["enc_embed"]``, then
``apply_decode``). Asked for one, the server stops before it draws a
weight; the JAX server fails at its first prefill (``KeyError``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch mamba2-1.3b --ctx 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch gemma-7b          # or qwen1.5-4b, stablelm-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch recurrentgemma-2b --ctx 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch olmoe-1b-7b       # or granite-moe-1b-a400m
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --requests 4 --batch 2 --ctx 16 --decode-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --arch mamba2-1.3b --requests 4 --batch 2 --ctx 40 --decode-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --arch recurrentgemma-2b --requests 4 --batch 2 --ctx 40 \
      --decode-steps 4

``--device`` defaults to cuda and raises where no card is found; it does
not fall back to the CPU. ``--smoke`` is off by default, so the default
run is mistral-nemo-12b at its published widths and all 40 layers. (The
JAX CLI declares ``--smoke`` with ``default=True``, so its full config is
unreachable there.) Weights are random, drawn on the target device from
``--seed``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import resolve_device

NUM_ACTIONS = 18        # the Atari action set, as the JAX server uses
# the batch key of the stub frontends' embeddings, by family
_CTX_KEY = {"vlm": "image_embed", "audio": "enc_embed"}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (the default; raises "
                        "when no card is found) or cpu")
    p.add_argument("--arch", default="mistral-nemo-12b",
                   help="token backbone: mistral-nemo-12b, gemma-7b, "
                        "qwen1.5-4b, stablelm-1.6b (dense: K4 each prefill "
                        "layer, K5 each decode layer), mamba2-1.3b (ssm: "
                        "K3 each prefill layer) or recurrentgemma-2b "
                        "(hybrid: K3 each recurrent prefill layer, K4/K5 "
                        "each local-attention layer), granite-moe-1b-a400m "
                        "or olmoe-1b-7b (moe: K4 each prefill layer, K5 "
                        "each decode layer)")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke config of --arch")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--ctx", type=int, default=128)
    p.add_argument("--decode-steps", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    return p


@dataclasses.dataclass
class ServeRun:
    """What a serving run leaves behind for its caller."""
    params: Dict
    arch: ArchConfig
    num_actions: int
    param_count: int
    served: int                  # streams (requests) served
    batches: int
    decode_steps: int            # per batch
    actions_per_s: float         # over the whole queue's wall clock
    step_latency_ms: List[float]  # per batch: its time / decode steps
    prefill_ms: List[float]      # per batch, between CUDA events
    decode_ms: List[float]       # per decode step, between CUDA events
    # the first batch: its tokens (B, ctx), the sampled actions of each
    # step (B, 1), the logits of prefill and of each step (B, 1, A)
    first_batch: Dict[str, object]


def serve(argv: Optional[List[str]] = None) -> ServeRun:
    """Parse the CLI flags and serve the synthetic request queue."""
    parser = _parser()
    args = parser.parse_args(argv)
    for flag in ("batch", "requests", "ctx", "decode_steps"):
        if getattr(args, flag) < 1:
            parser.error(f"--{flag.replace('_', '-')} must be at least 1")
    device = resolve_device(args.device)

    from repro_torch import params as params_lib
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    arch = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if arch.family == "impala_cnn":
        raise SystemExit(f"--arch {args.arch}: the server runs token "
                         f"backbones; the conv-LSTM agents act inside "
                         f"repro_torch.launch.train")
    if arch.family in ("vlm", "audio"):
        raise SystemExit(
            f"--arch {args.arch}: the server sends tokens only, and this "
            f"{arch.family} backbone needs the stub frontend's "
            f"{'image' if arch.family == 'vlm' else 'frame'} embeddings; "
            f"run it through repro_torch.models.backbone (apply_prefill "
            f"with batch['{_CTX_KEY[arch.family]}'], then apply_decode)")
    arch = arch.replace(vocab_size=max(arch.vocab_size, 4096))
    a = NUM_ACTIONS
    specs = bb.backbone_specs(arch, a)
    t0 = time.perf_counter()
    params = params_lib.from_jax(common.init_params(specs, args.seed, device),
                                 device, requires_grad=False)
    _sync(device)
    count = common.param_count(specs)
    print(f"serving {arch.name} ({count:,} params), batch={args.batch}, "
          f"device={device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f"; weights drawn in {time.perf_counter() - t0:.1f}s")

    # synthetic request queue: each request = a ctx-length observation stream
    rng = np.random.default_rng(args.seed)
    pending = collections.deque(
        rng.integers(0, arch.vocab_size, size=(args.requests, args.ctx)))
    gen = torch.Generator(device=device).manual_seed(args.seed)

    served = batches = 0
    lat: List[float] = []
    prefill_ms: List[float] = []
    decode_ms: List[float] = []
    first: Dict[str, object] = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        while pending:
            # dynamic batching: take up to --batch requests, pad the rest
            batch = [pending.popleft()
                     for _ in range(min(args.batch, len(pending)))]
            n = len(batch)
            batch += [batch[-1]] * (args.batch - n)
            toks = torch.from_numpy(np.stack(batch)).to(device)
            t1 = time.perf_counter()
            marks = [_mark(device)]
            out = bb.apply_prefill(params, {"tokens": toks}, arch, a)
            marks.append(_mark(device))
            logits, actions = [out.policy_logits], []
            cache = out.cache
            tok = toks[:, -1:]
            for i in range(args.decode_steps):
                out = bb.apply_decode(params, tok, cache, args.ctx + i, arch,
                                      a)
                cache = out.cache
                probs = torch.softmax(out.policy_logits[:, 0], dim=-1)
                action = torch.multinomial(probs, 1, generator=gen)
                tok = action % arch.vocab_size
                marks.append(_mark(device))
                logits.append(out.policy_logits)
                actions.append(action)
            # the batch's one synchronise, where the reference blocks on
            # its last token: the host queues each step while the card
            # runs the one before
            _sync(device)
            lat.append((time.perf_counter() - t1) / args.decode_steps * 1e3)
            prefill_ms.append(_elapsed_ms(marks[0], marks[1]))
            decode_ms += [_elapsed_ms(m0, m1)
                          for m0, m1 in zip(marks[1:], marks[2:])]
            if not first:
                first = {"tokens": toks, "actions": actions,
                         "logits": logits}
            served += n
            batches += 1
    dt = time.perf_counter() - t0
    rate = served * args.decode_steps / dt
    print(f"served {served} streams x {args.decode_steps} actions in "
          f"{dt:.2f}s  ({rate:.0f} actions/s, p50 step latency "
          f"{np.percentile(lat, 50):.1f}ms)")
    return ServeRun(params, arch, a, count, served, batches,
                    args.decode_steps, rate, lat, prefill_ms, decode_ms,
                    first)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device: torch.device):
    """A point in the served loop: a CUDA event recorded on the current
    stream (read only after the batch's synchronise), or the host clock
    on the CPU, where every op has finished when it returns."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _elapsed_ms(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e3
    return start.elapsed_time(end)


def main(argv: Optional[List[str]] = None) -> int:
    serve(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
