"""Serving-side demo on PyTorch: batched actor inference with the
decode/KV-cache path (the IMPALA actor hot loop), plus a prefill ->
decode handoff, as ``examples/serve_actors.py`` does with the JAX
package. On the card (the default) the prefill runs the flash attention
kernel and each decode step the decode attention kernel, once a layer.

  PYTHONPATH=src python examples/serve_actors_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.actor import sample
from repro_torch.core.driver import init_params
from repro_torch.launch.train import resolve_device
from repro_torch.models import backbone as bb
from repro_torch.models import common

A = 18
B = 16          # concurrent actor requests (dynamic-batching analogue)
CTX = 64        # context each request carries
DECODE_STEPS = 32


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config("mistral-nemo-12b").replace(vocab_size=4096)
    specs = bb.backbone_specs(cfg, A)
    params = init_params(cfg, A, 0, device)
    print(f"backbone {cfg.name} params={common.param_count(specs):,}")

    with torch.no_grad():
        # 1) prefill: every actor ingests its 64-token context in one pass
        gen = torch.Generator(device=device).manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (B, CTX), generator=gen,
                             device=device)
        out = bb.apply_prefill(params, {"tokens": toks}, cfg, A)
        cache = out.cache
        print(f"prefill: logits {tuple(out.policy_logits.shape)}, "
              f"cache ready")

        # 2) decode loop: one action per step per actor, batched
        tok = toks[:, -1:]
        gen = torch.Generator(device=device).manual_seed(2)
        t0 = time.time()
        n_steps = DECODE_STEPS
        for i in range(n_steps):
            out = bb.apply_decode(params, tok, cache, CTX + i, cfg, A)
            cache = out.cache
            action = sample(gen, out.policy_logits[:, 0])
            # environment would consume `action` and return the next obs;
            # here we feed a synthetic next token
            tok = (action[:, None] % cfg.vocab_size).to(torch.int32)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
    print(f"decode: {n_steps} steps x {B} actors = {n_steps*B} actions "
          f"in {dt:.2f}s ({n_steps*B/dt:.0f} actions/s)")
    print(f"values sample: {out.values[:4, 0].cpu().numpy()}")


if __name__ == "__main__":
    main()
