#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself and imports only ``repro_torch``
(never ``jax`` or ``repro``). Phases, in order; any failure is an
exception and a nonzero exit:

1. Card: ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile ``src/repro_torch/csrc/*.cu`` for ``sm_90a`` with nvcc.
3. K1 (V-trace recurrence) against its plain PyTorch version, on the card.
4. K2 (fused loss + V-trace) against its plain version, forward and the
   ``autograd.Function``'s d_logits of the assembled IMPALA total, at
   every batch bucket of the async learner too.
5. The main path: ``repro_torch.launch.train`` at its defaults (sync,
   catch, impala-shallow at full width, 32 envs, unroll 20) for
   ``MAIN_STEPS`` steps on the card, with K2 launched once per learner
   step; then ``impala_loss(impl='pallas')`` on the last actor batch puts
   K1 on the path. Launch counts are zeroed just before and read just
   after.
6. Learning bar: the JAX package's bandit bar (tests/test_system.py,
   mean return over the last 200 episodes > 0.6 after 150 steps), through
   the same CLI on the card.
6a. The async path: ``repro_torch.launch.train --runtime async`` (catch,
   impala-shallow at full width, 32 envs, unroll 20, 2 actor threads,
   queue 8/block, batches of up to 4 trajectories) for ``ASYNC_STEPS``
   learner updates, K2 launched once an update at (20, 32k, 3) and K1
   never; counts zeroed just before and read just after. Prints learner
   and actor frames/s (read before the window below), the batch-size
   histogram, the measured lag and the queue's occupancy, stalls and
   drops. In the same run, where an async update's time goes:
   ``ASYNC_WINDOW`` steady updates timed unprofiled, then as many under
   ``torch.profiler``: the card's busy time per update against the
   unprofiled update, and the device kernels that take most of it. No
   actor thread may outlive the run.
6b. Async learning bar: the JAX package's acceptance configuration for
   thread actors (tests/test_process_actors.py: smoke impala-shallow, 32
   envs, unroll 20, 400 updates, 2 actor threads, queue 8/block, batches
   of up to 4); the last 100 returns above the first 500 by more than
   0.15, and above -0.3.
7. Split: where a main-path step's time goes, actor unroll against
   learner step, each timed on the host clock up to a synchronise; then
   the card's busy time over a few steps from a ``torch.profiler`` trace,
   and the device kernels that take most of it.
8. Times: K1 and K2 at the main path's shape, the paper's DMLab learner
   shape (100, 32, 9) and (100, 256, 18); each call timed with CUDA
   events and each kernel's device time from a ``torch.profiler`` trace,
   beside the plain version and the least time the card could take
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s fp32; the larger of
   the two).
9. K4 (flash attention) against its plain version on the card, in bf16
   (the tensor-core kernel) and f32 (the SIMT kernel): the serving path's
   prefill shape, a ragged T, S != T (T = 200 against S = 330 across the
   128-row tiles), non-causal (S = 1 too), sliding windows of 64 at T =
   512 and 2048, T = S = 2048, one and four query heads per kv head, D =
   32, 64, 128 and 256.
10. K5 (decode attention) against its plain version: the serving path's
    decode shape, S = 32768, S = 1, 17, 64, 65, 1000 and 4097, G = 1, 4
    and 16, and biases with masked prefixes and suffixes built by the
    decode path's own ``decode_bias``.
11. The serving path: ``repro_torch.launch.serve`` at its defaults
    (mistral-nemo-12b at full width and depth, 64 requests, batch 16, ctx
    128, 32 decode steps) on the card. K4 must launch once a layer at each
    prefill and K5 once a layer at each decode step; counts are zeroed just
    before and read just after. Prints actions/s, step latency, prefill and
    decode-step ms and the card's peak allocated memory.
12. Served logits against the plain route: the first batch's tokens and
    sampled actions replayed through ``ops``'s ``impl='ref'`` route on the
    same params; prefill logits and every decode step's logits compared.
13. Where a decode step's time goes: a ``torch.profiler`` trace of a few
    decode steps, the card's busy time against the unprofiled step.
14. Times with CUDA events: K4 and K5 at the serving path's shapes and at
    one long shape each, beside the plain version, the bound (bytes over
    3.35 TB/s, operations over 989 TFLOP/s bf16) and one library call,
    ``F.scaled_dot_product_attention``, that the port never calls; with
    the achieved TFLOP/s (K4) or TB/s (K5) and the share of the bound.
15. K3 (the linear scan) against its plain version on the card, with h0
    and without: small and ragged shapes, the mamba2 serving path's
    cross-chunk pass (8, 8388608) and the RG-LRU prefill's (2048, 40960).
16. The SSM serving path: ``repro_torch.launch.serve --arch mamba2-1.3b
    --ctx 2048`` (full width and all 48 layers, otherwise the CLI's
    defaults) on the card. K3 must launch once a layer at each prefill and
    K4/K5 never; counts are zeroed just before and read just after.
    Prints actions/s, step latency, prefill and decode-step ms and the
    card's peak allocated memory.
17. Its served logits against the plain route (as phase 12).
18. Where a mamba2 prefill's and decode step's time goes: ``torch.profiler``
    traces, the card's busy time against the unprofiled times.
19. Times with CUDA events: K3 at the serving shape and at (2048, 40960),
    beside the plain version and the bound (bytes over 3.35 TB/s,
    operations over 67 TFLOP/s fp32); no single PyTorch call computes the
    recurrence, so there is no library time.

TF32 is off for cuDNN convolutions and cuBLAS matmuls in every phase, so
the card computes in full float32 like the reference. It exits nonzero
and prints no result where ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# per element |got - want| <= ATOL, for K1, K2 and K2's d_logits. The
# kernels are built with -fmad=false and the plain versions sum over the
# actions in the kernel's order, so the two round alike
ATOL = 1e-5
# K4/K5 in float32: kernel and plain version both compute in f32 from the
# same inputs but sum the D-term dot products and the softmax in other
# orders (and the kernel fuses its multiply-adds), a few f32 ulps of
# outputs of size ~1: |err| <= ATTN_F32_ATOL + ATTN_F32_RTOL * |want|
ATTN_F32_ATOL = 1e-5
ATTN_F32_RTOL = 1e-5
# K4/K5 in bfloat16: each output is one rounding of an f32 result, and the
# two f32 results differ as above, so they may round to neighbouring bf16
# values: one bf16 ulp, at most 2^-7 * |want|, plus the f32 slack near 0
ATTN_BF16_RTOL = 2.0 ** -7
ATTN_BF16_ATOL = 1e-5
# served logits, kernel route against plain route: the same bf16 model on
# the same params and tokens, differing only where an attention output
# rounds to the other neighbouring bf16 value (one ulp, 2^-8 relative) in
# some of the 40 layers; the residual stream, norms and matmuls carry that
# at roughly sqrt(40) * 2^-8 = 2.5% of the activations' scale, so the
# logits are held to 5% of their own largest magnitude. The same bar holds
# mamba2-1.3b: K3 is held to 1e-5 of its f32 states (bit for bit
# expected), and where a state differs by an ulp the SSD output may round
# to the other bf16 neighbour at its cast before the gate, in some of the
# 48 layers: sqrt(48) * 2^-8 = 2.7% at most
LOGITS_RTOL = 0.05
MAIN_STEPS = 200
BANDIT_STEPS = 150
BANDIT_BAR = 0.6
ASYNC_STEPS = 400
ASYNC_ARGV = ["--device", "cuda", "--runtime", "async", "--env", "catch",
              "--arch", "impala-shallow", "--actor-threads", "2",
              "--max-batch-trajs", "4", "--steps", str(ASYNC_STEPS),
              "--log-every", "100"]
# the steady updates timed, then profiled, near the end of phase 6a's run
ASYNC_WINDOW = 20
# tests/test_process_actors.py's bar: late - early > 0.15, late > -0.3
CATCH_CLIMB, CATCH_LATE = 0.15, -0.3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
CLIPS = [(1.0, 1.0, 1.0), (None, None, 1.0), (2.0, 1.0, 1.0),
         (1.0, 1.0, 0.9)]
K1_SHAPES = [(1, 1), (20, 32), (37, 130), (100, 32), (100, 256)]
# (20, 64, 3) and (20, 128, 3): the async learner's batches of 2 and 4
# trajectories of 32 envs
K2_SHAPES = [(20, 32, 3), (37, 130, 5), (100, 32, 9), (100, 256, 18),
             (16, 8, 130), (20, 64, 3), (20, 128, 3)]
MAIN_T, MAIN_B, MAIN_A = 20, 32, 3     # the main path's K1/K2 shapes
# K1/K2 timed at the main path's shape, the paper's DMLab learner shape
# (unroll 100, batch 32, 9 actions) and a large one
VTRACE_TIMED = [(MAIN_T, MAIN_B, MAIN_A), (100, 32, 9), (100, 256, 18)]
# K4 checks: (B, T, S, H, K, D, causal, window)
K4_CASES = [
    (16, 128, 128, 32, 8, 128, True, 0),    # the serving path's prefill
    (2, 100, 100, 32, 8, 128, True, 0),     # ragged T
    (2, 100, 160, 32, 8, 128, True, 0),     # S > T
    (2, 160, 100, 32, 8, 128, True, 0),     # S < T
    (2, 128, 128, 32, 8, 128, False, 0),    # non-causal
    (1, 512, 512, 32, 8, 128, True, 64),    # window 64 (swa_variant's)
    (2, 128, 128, 8, 8, 128, True, 0),      # G = 1
    (2, 96, 96, 16, 4, 64, True, 0),        # G = 4 at D = 64
    (2, 70, 70, 4, 2, 32, True, 24),        # the smoke config's D = 32
    (2, 256, 256, 16, 4, 256, True, 0),     # D = 256: 64-key tiles, G = 4
    (1, 2048, 2048, 32, 8, 128, True, 0),   # 16 query tiles, 1-16 kv tiles
    (1, 2048, 2048, 32, 8, 128, True, 64),  # window 64 at T = S = 2048
    (2, 200, 330, 32, 8, 128, True, 0),     # ragged across 128-row tiles
    (2, 1, 1, 32, 8, 128, False, 0),        # non-causal, S = 1
]
# K5 checks: (B, H, K, S, D, cache_index, window) with the decode path's
# bias: decode_bias(cache_index, S, window)
K5_CASES = [
    (16, 32, 8, 128, 128, 160, 0),          # the serving path's decode
    (8, 32, 8, 32768, 128, 40000, 0),       # decode_32k, all valid
    (4, 32, 8, 1000, 128, 999, 0),          # ragged S
    (4, 32, 8, 1000, 128, 300, 0),          # masked suffix: cache with room
    (4, 32, 8, 1024, 128, 2000, 256),       # ring buffer: masked prefix
    (4, 32, 8, 512, 128, 200, 128),         # ring not yet full: both ends
    (3, 8, 8, 130, 64, 100, 0),             # G = 1 at D = 64
    (4, 32, 8, 1, 128, 0, 0),               # S = 1: one warp, one key
    (4, 32, 8, 17, 128, 16, 0),             # S = 17: two ragged tiles
    (4, 32, 8, 64, 128, 40, 0),             # S = 64, a masked suffix
    (4, 32, 8, 65, 128, 64, 0),             # S = 65: one key past 64
    (4, 32, 8, 4097, 128, 4096, 0),         # S = 4097: splits, ragged
    (4, 32, 2, 1000, 128, 999, 0),          # G = 16 at D = 128
]
SERVE_ARGV = ["--device", "cuda"]              # the server's defaults
SERVE_LAYERS, SERVE_BATCHES, SERVE_STEPS = 40, 4, 32
# K3 checks: (T, N). (8, 8388608) is the mamba2 serving path's cross-chunk
# pass (8 chunks of 256 at ctx 2048; batch 16 x 64 heads x P 64 x N 128);
# (2048, 40960) the RG-LRU prefill's at batch 16, width 2560, ctx 2048
K3_SHAPES = [(1, 1), (33, 7), (257, 129), (512, 1024), (8, 8388608),
             (2048, 40960)]
K3_MAIN, K3_LONG = (8, 8388608), (2048, 40960)
SSM_ARGV = ["--device", "cuda", "--arch", "mamba2-1.3b", "--ctx", "2048"]
SSM_LAYERS, SSM_PARAMS = 48, 1_343_779_859


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def _inputs(t, b, a, seed, device):
    """Time-major K2 inputs made on the CPU from a seed, moved to the card.
    The actions are drawn from a behaviour policy near the target one, as
    an actor a few updates behind draws them in training."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(t, b, a, generator=g) * 2.0
    b_logp = torch.log_softmax(
        logits + torch.randn(t, b, a, generator=g) * 0.3, -1)
    actions = torch.multinomial(b_logp.exp().reshape(-1, a), 1,
                                generator=g).reshape(t, b)
    onehot = torch.nn.functional.one_hot(actions, a).to(torch.float32)
    blp = torch.sum(b_logp * onehot, -1)
    disc = torch.where(torch.rand(t, b, generator=g) < 0.1, 0.0, 0.97)
    rew = torch.randn(t, b, generator=g)
    v = torch.randn(t, b, generator=g)
    vtp1 = torch.cat([v[1:], torch.randn(1, b, generator=g)], 0)
    return tuple(x.to(device) for x in
                 (logits, onehot, blp, disc, rew, v, vtp1))


def _log_rhos(inp):
    """log pi(a|x) - log mu(a|x) of K2's inputs: what K1 is given."""
    logits, onehot, blp = inp[:3]
    return torch.sum(torch.log_softmax(logits, -1) * onehot, -1) - blp


def _weights(log_rhos, rho_bar, c_bar, lambda_):
    rhos = torch.exp(log_rhos)
    rho = rhos if rho_bar is None else torch.clamp(rhos, max=rho_bar)
    c = lambda_ * (rhos if c_bar is None else torch.clamp(rhos, max=c_bar))
    return rho, c


def _check(name: str, got, want) -> float:
    """Hold each output element to ATOL; return the max abs error."""
    worst = 0.0
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        if not err <= ATOL:
            raise AssertionError(
                f"{name}: max abs error {err:.3e} exceeds {ATOL:.0e} "
                f"(max |want| {float(w.abs().max()):.3e})")
        worst = max(worst, err)
    return worst


def _total(outs, v):
    """The IMPALA total assembled from K2's outputs (vs/pg_adv targets)."""
    tlp, ne, vs, pg = outs
    return (-torch.sum(pg.detach() * tlp)
            + 0.5 * torch.sum(torch.square(vs.detach() - v))
            + 0.01 * torch.sum(ne))


def phase_k1(vk, dev) -> float:
    worst = 0.0
    for t, b in K1_SHAPES:
        inp = _inputs(t, b, 3, t * 7 + b, dev)
        for clip in CLIPS:
            rho, c = _weights(_log_rhos(inp), *clip)
            args = (rho, c) + inp[3:]
            err = _check(f"K1 {(t, b)} clip={clip}", vk.vtrace(*args),
                         vk.vtrace_plain(*args))
            worst = max(worst, err)
        print(f"K1 (T,B)={(t, b)}: max abs err over {len(CLIPS)} clip "
              f"settings {worst:.3e}")
    return worst


def phase_k2(vk, dev) -> float:
    worst = 0.0
    for t, b, a in K2_SHAPES:
        inp = _inputs(t, b, a, t * 131 + b * 7 + a, dev)
        fwd = grad = 0.0
        for clip in CLIPS:
            kw = dict(zip(("rho_bar", "c_bar", "lambda_"), clip))
            fwd = max(fwd, _check(f"K2 forward {(t, b, a)} clip={clip}",
                                  vk.loss_vtrace(*inp, **kw),
                                  vk.loss_vtrace_plain(*inp, **kw)))
            lg_k = inp[0].clone().requires_grad_()
            lg_p = inp[0].clone().requires_grad_()
            g_k, = torch.autograd.grad(
                _total(vk.fused_loss_vtrace(lg_k, *inp[1:], **kw), inp[5]),
                lg_k)
            g_p, = torch.autograd.grad(
                _total(vk.loss_vtrace_plain(lg_p, *inp[1:], **kw), inp[5]),
                lg_p)
            grad = max(grad, _check(f"K2 d_logits {(t, b, a)} clip={clip}",
                                    [g_k], [g_p]))
        worst = max(worst, fwd)
        print(f"K2 (T,B,A)={(t, b, a)}: max abs err over {len(CLIPS)} clip "
              f"settings, forward {fwd:.3e}, d_logits {grad:.3e}")
    return worst


def phase_main(vk, dev):
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.losses import impala_loss
    from repro_torch.launch import train as train_lib

    argv = ["--device", "cuda", "--env", "catch", "--arch", "impala-shallow",
            "--steps", str(MAIN_STEPS), "--log-every", "25"]
    vk.reset_launch_counts()
    run = train_lib.train(argv)
    k2_train = vk.loss_vtrace.launches
    if k2_train != MAIN_STEPS or vk.vtrace.launches != 0:
        raise AssertionError(f"K2 launched {k2_train} times in "
                             f"{MAIN_STEPS} learner steps (K1: "
                             f"{vk.vtrace.launches}); expected one K2 "
                             f"launch per step and no K1")
    # K1 on the path: the plain V-trace kernel's loss on the last batch
    batch = run.last_batch
    with torch.no_grad():
        logits, values = learner_lib.forward_trajectory(
            run.params, batch, run.arch, run.env.num_actions)
    loss_batch = {k: batch[k] for k in ("actions", "rewards", "discounts",
                                        "behaviour_logprob")}
    loss_batch["bootstrap_value"] = values[:, -1]
    lg, vv = logits[:, :-1], values[:, :-1]
    total_k1, m_k1 = impala_loss(run.icfg, lg, vv, loss_batch, impl="pallas")
    torch.cuda.synchronize()
    launches = {"vtrace": vk.vtrace.launches,
                "loss_vtrace": vk.loss_vtrace.launches}
    if launches["vtrace"] < 1:
        raise AssertionError("K1 was not launched on the main path")

    # what came out: finite, of the expected shape, params moved, and the
    # kernel routes agree with the reverse loop on the last actor batch
    t, b, a = MAIN_T, MAIN_B, run.env.num_actions
    if tuple(logits.shape) != (b, t + 1, a) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite "
                             f"(B,T+1,A)=({b},{t + 1},{a})")
    loss = float(run.metrics["loss/total"])
    if not math.isfinite(loss):
        raise AssertionError(f"final loss {loss} is not finite")
    moved = _params_moved(run, dev)
    total_scan, m_scan = impala_loss(run.icfg, lg, vv, loss_batch,
                                     impl="scan")
    total_fused, _ = impala_loss(run.icfg, lg, vv, loss_batch, impl="fused")
    for name, got in (("pallas", total_k1), ("fused", total_fused)):
        want = float(total_scan)
        if not abs(float(got) - want) <= 1e-4 + 1e-5 * abs(want):
            raise AssertionError(f"impala_loss impl={name} {float(got)} vs "
                                 f"scan {want}")
    _check("impl=pallas mean vs against scan", [m_k1["vtrace/mean_vs"]],
           [m_scan["vtrace/mean_vs"]])
    first, last = run.log[0], run.log[-1]
    print(f"main path: {MAIN_STEPS} learner steps, K2 launches "
          f"{k2_train}, final loss {loss:.4f}, params moved (max |dp| "
          f"{moved:.3e})")
    print(f"main path: return(100) {first['return100']:.3f} at step "
          f"{first['step']} -> {last['return100']:.3f} at step "
          f"{last['step']}; frames/s {run.fps:.0f} (steady window after "
          f"the first update)")
    print(f"main path: impala_loss total pallas {float(total_k1):.6f} "
          f"fused {float(total_fused):.6f} scan {float(total_scan):.6f}")
    return launches, run


def _params_moved(run, dev) -> float:
    """Max |trained - initial| over the params of a run seeded 0; raises
    where training left them as they were."""
    from repro_torch import params as params_lib
    from repro_torch.models import backbone as bb
    from repro_torch.models import common

    specs = bb.backbone_specs(run.arch, run.env.num_actions)
    init = params_lib.from_jax(common.init_params(specs, 0), dev,
                               requires_grad=False)
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(
        params_lib.tree_leaves(run.params), params_lib.tree_leaves(init)))
    if not moved > 0:
        raise AssertionError("params did not change in training")
    return moved


def phase_bandit() -> float:
    """The JAX package's learning bar (tests/test_system.py,
    test_full_pipeline_learns_bandit), through the CLI on the card."""
    from repro_torch.launch import train as train_lib

    run = train_lib.train([
        "--device", "cuda", "--env", "bandit", "--smoke", "--unroll", "16",
        "--lr", "1e-3", "--entropy-cost", "0.005", "--rmsprop-eps", "0.01",
        "--policy-lag", "1", "--num-envs", "32",
        "--steps", str(BANDIT_STEPS), "--log-every", "50"])
    final = run.tracker.mean_return(200)
    if not final > BANDIT_BAR:
        raise AssertionError(f"bandit mean return(200) {final:.3f} after "
                             f"{BANDIT_STEPS} steps; the bar is "
                             f"{BANDIT_BAR}")
    print(f"learning bar: bandit mean return(200) {final:.3f} > "
          f"{BANDIT_BAR} after {BANDIT_STEPS} steps")
    return final


def _no_actor_threads(what: str) -> None:
    """An actor thread still alive after its run returned would go on
    issuing work on the card, into later phases and the interpreter's
    exit."""
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("actor-")]
    if alive:
        raise AssertionError(f"{what}: actor threads {alive} outlive the run")


def phase_async(vk, dev):
    """The async path at full width, K1/K2 counted over exactly it; near
    its end ``ASYNC_WINDOW`` updates timed on the host clock between two
    synchronises, then as many under ``torch.profiler``: the card's busy
    time per update against the unprofiled update."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as train_lib

    w = ASYNC_WINDOW
    first = ASYNC_STEPS - 3 * w
    marks, before = {}, {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def window(step, params, metrics, snapshot_fn):
        if step == first:
            # the rates before the window's synchronises and profiling
            before.update(snapshot_fn())
        if step in (first, first + w, first + 2 * w):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()
        if step == first + w:
            prof.start()
        elif step == first + 2 * w:
            prof.stop()

    vk.reset_launch_counts()
    run = train_lib.train(ASYNC_ARGV, on_update=window)
    torch.cuda.synchronize()
    launches = {"vtrace": vk.vtrace.launches,
                "loss_vtrace": vk.loss_vtrace.launches}
    _no_actor_threads("async path")
    tel = run.telemetry
    frames_per_traj = MAIN_B * MAIN_T
    got = (tel["learner_updates"], tel["param_version"],
           launches["loss_vtrace"], launches["vtrace"])
    if got != (ASYNC_STEPS, ASYNC_STEPS, ASYNC_STEPS, 0):
        raise AssertionError(f"async path: (updates, version, K2 launches, "
                             f"K1 launches) {got}; expected "
                             f"{(ASYNC_STEPS,) * 3 + (0,)}")
    loss = float(run.metrics["loss/total"])
    if not math.isfinite(loss):
        raise AssertionError(f"async final loss {loss} is not finite")
    moved = _params_moved(run, dev)
    lag, q = tel["lag"], tel["queue"]
    if not lag["max"] > 0 or \
            lag["measured"] * frames_per_traj != tel["frames_consumed"]:
        raise AssertionError(f"async lag {lag} against frames_consumed "
                             f"{tel['frames_consumed']} / {frames_per_traj}")
    returns = run.tracker.completed
    print(f"async path: {ASYNC_STEPS} updates, K2 launches "
          f"{launches['loss_vtrace']} K1 {launches['vtrace']}, final loss "
          f"{loss:.4f}, params moved (max |dp| {moved:.3e})")
    print(f"async path: learner frames/s {before['frames_per_sec']:.0f}, "
          f"actor frames/s {before['actors']['actor_fps']:.0f}, updates/s "
          f"{before['updates_per_sec']:.2f} (steady window up to update "
          f"{first}); batch sizes "
          f"{dict(sorted(tel['batch_size_hist'].items()))}; lag mean "
          f"{lag['mean']:.3f} max {lag['max']} over {lag['measured']} "
          f"trajectories; queue occupancy {q['mean_occupancy']:.3f} of "
          f"{q['capacity']}, put stalls {q['put_stalls']}, get stalls "
          f"{q['get_stalls']}, drops {q['dropped']}")
    early = float(sum(returns[:500])) / max(1, len(returns[:500]))
    late = run.tracker.mean_return(100)
    cleared = late > early + CATCH_CLIMB and late > CATCH_LATE
    print(f"async path: {len(returns)} episodes, first 500 mean "
          f"{early:.3f}, last 100 mean {late:.3f}: "
          + ("clears" if cleared else "misses")
          + " phase 6b's bar (this full-width run is not held to it)")
    update_ms = (marks[first + w] - marks[first]) / w * 1e3
    profiled_ms = (marks[first + 2 * w] - marks[first + w]) / w * 1e3
    print(f"async split: {update_ms:.3f} ms an update unprofiled, "
          f"{profiled_ms:.3f} ms profiled (updates {first}-{first + w} and "
          f"{first + w}-{first + 2 * w})")
    _print_busy("async update", prof, w, update_ms)
    return launches


def phase_async_bar(dev) -> float:
    """tests/test_process_actors.py's acceptance run (thread backend), on
    the card, held to that test's bar."""
    from repro_torch.configs.base import ImpalaConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.envs import make_catch
    from repro_torch.distributed import run_async_training

    env = make_catch()
    arch = get_smoke_config("impala-shallow").replace(image_hw=env.image_hw)
    cfg = ImpalaConfig(num_actions=env.num_actions, unroll_length=20,
                       learning_rate=6e-4, entropy_cost=0.003,
                       rmsprop_eps=0.01)
    tracker, metrics, tel = run_async_training(
        "catch", cfg, num_envs=32, steps=ASYNC_STEPS, num_actors=2,
        queue_capacity=8, queue_policy="block", max_batch_trajs=4, seed=0,
        arch=arch, device=dev)
    _no_actor_threads("async learning run")
    returns = tracker.completed
    early = float(sum(returns[:500])) / len(returns[:500])
    late = tracker.mean_return(100)
    if not (tel["learner_updates"] == tel["param_version"] == ASYNC_STEPS
            and math.isfinite(float(metrics["loss/total"]))
            and tel["lag"]["max"] > 0):
        raise AssertionError(f"async learning run: {tel['learner_updates']} "
                             f"updates, version {tel['param_version']}, "
                             f"lag {tel['lag']}")
    if not (late > early + CATCH_CLIMB and late > CATCH_LATE):
        raise AssertionError(f"async catch: last 100 mean {late:.3f}, first "
                             f"500 mean {early:.3f}; the bar is a climb of "
                             f"more than {CATCH_CLIMB} to above {CATCH_LATE}")
    print(f"async learning bar: catch (smoke impala-shallow) last 100 mean "
          f"{late:.3f} > first 500 mean {early:.3f} + {CATCH_CLIMB}, and > "
          f"{CATCH_LATE}; {len(returns)} episodes, batch sizes "
          f"{dict(sorted(tel['batch_size_hist'].items()))}, learner "
          f"frames/s {tel['frames_per_sec']:.0f}")
    return late


def _device_busy(events):
    """(busy us, device events, {name: (us, count)}) of the device-side
    events of a profiler trace; busy is the union of their intervals."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + end - start, n + 1)
    busy, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy, len(spans), by_name


def phase_split(run, dev, steps: int = 20, profiled: int = 5) -> None:
    """Host-clock split of a main-path step: one actor unroll, then one
    learner step, each ended by a synchronise, after one warm-up step.
    Then ``profiled`` more steps under ``torch.profiler``: the card's busy
    time per step against the unprofiled step time, and the device kernels
    that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import actor as actor_lib
    from repro_torch.core import learner as learner_lib

    init_fn, unroll = actor_lib.build_actor(run.env, run.arch, run.icfg,
                                            MAIN_B, dev)
    train_step, o = learner_lib.build_train_step(run.arch, run.icfg,
                                                 run.env.num_actions)
    params, opt_state, carry = run.params, o.init(run.params), init_fn(1)
    act = learn = 0.0
    for step in range(steps + 1):
        t0 = time.perf_counter()
        carry, batch = unroll(params, carry)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt_state, _ = train_step(params, opt_state, step, batch)
        torch.cuda.synchronize()
        if step:                      # step 0 warms up
            act += t1 - t0
            learn += time.perf_counter() - t1
    act, learn = act / steps * 1e3, learn / steps * 1e3
    print(f"split: actor unroll {act:.3f} ms, learner step {learn:.3f} ms "
          f"per step ({100 * act / (act + learn):.1f}% acting; host clock "
          f"to a synchronise, mean of {steps} steps, {MAIN_B} envs x "
          f"unroll {MAIN_T})")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for step in range(profiled):
            carry, batch = unroll(params, carry)
            params, opt_state, _ = train_step(params, opt_state, step, batch)
        torch.cuda.synchronize()
    busy_us, count, by_name = _device_busy(prof.events())
    if not count:
        print("device busy share: not measured (the profiler trace holds "
              "no device events)")
        return
    busy_ms = busy_us / profiled / 1e3
    print(f"device: busy {busy_ms:.3f} ms per step over {profiled} "
          f"profiled steps, {count / profiled:.0f} device events per step; "
          f"{100 * busy_ms / (act + learn):.1f}% of the unprofiled "
          f"{act + learn:.3f} ms step, so the card idles "
          f"{100 - 100 * busy_ms / (act + learn):.1f}% of it")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"  device {us / profiled / 1e3:8.3f} ms/step "
              f"{n / profiled:6.0f} calls/step  {name[:90]}")


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    warmup = min(warmup, iters)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _k1_cost(t, b):
    # 6 inputs read and 2 outputs written once; 13 flops per (s, b)
    return 8 * t * b * 4, 13 * t * b


def _k2_cost(t, b, a):
    # logits and onehot (T,B,A), 5 (T,B) inputs, 4 (T,B) outputs; per row
    # 11 ops for each action (max, exp-sum, log-prob, tlp, entropy) and 20
    # for the weights and the recurrence
    return (2 * t * b * a + 9 * t * b) * 4, (11 * a + 20) * t * b


def phase_times(vk, dev):
    """K1 and K2 at VTRACE_TIMED: the call timed with CUDA events and the
    kernel's device time from a profiler trace, beside the plain version
    and the bound."""
    rows = {}
    for t, b, a in VTRACE_TIMED:
        inp = _inputs(t, b, a, 5, dev)
        rho, c = _weights(_log_rhos(inp), 1.0, 1.0, 1.0)
        k1_args = (rho, c) + inp[3:]
        for name, kern, plain, args, cost in (
                ("vtrace", vk.vtrace, vk.vtrace_plain, k1_args,
                 _k1_cost(t, b)),
                ("loss_vtrace", vk.loss_vtrace, vk.loss_vtrace_plain, inp,
                 _k2_cost(t, b, a))):
            ms = _time_ms(lambda: kern(*args))
            plain_ms = _time_ms(lambda: plain(*args), 50)
            dev_ms = _device_ms(lambda: kern(*args), 50)
            bound_ms, bound_by = _bound(*cost)
            shape = (t, b) if name == "vtrace" else (t, b, a)
            print(f"time {name} {shape}: call {ms:.5f} ms "
                  f"({100 * bound_ms / ms:.3f}% of the bound), device "
                  f"{dev_ms:.5f} ms ({100 * bound_ms / dev_ms:.3f}%), plain "
                  f"{plain_ms:.5f} ms, bound {bound_ms:.7f} ms ({bound_by}: "
                  f"{cost[0]} B, {cost[1]} ops), library: none (no single "
                  f"PyTorch call computes V-trace)")
            if (t, b) == (MAIN_T, MAIN_B):
                rows[name] = dict(ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
    return rows


# ---------------------------------------------------------------------------
# slice 2: the serving path, K4 and K5


def _rand(shape, seed: int, dtype, dev):
    """Standard normals drawn on the CPU from a seed, moved to the card."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


def _attn_check(name: str, got, want) -> float:
    """Hold K4/K5 outputs to the tolerance of their dtype (ATTN_*);
    return the max abs error."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        allow = ATTN_F32_ATOL + ATTN_F32_RTOL * w.abs()
    else:
        allow = ATTN_BF16_ATOL + ATTN_BF16_RTOL * w.abs()
    over = err > allow
    if bool(over.any()):
        i = int(torch.argmax((err - allow).flatten()))
        raise AssertionError(
            f"{name}: {int(over.sum())} elements over the {want.dtype} "
            f"tolerance; worst |got - want| {float(err.flatten()[i]):.3e} "
            f"at |want| {float(w.abs().flatten()[i]):.3e}")
    return float(err.max())


def phase_k4(fk, dev) -> float:
    worst = 0.0
    for n, (b, t, s, h, kh, d, causal, window) in enumerate(K4_CASES):
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            q = _rand((b, t, h, d), 3 * n, dtype, dev)
            k = _rand((b, s, kh, d), 3 * n + 1, dtype, dev)
            v = _rand((b, s, kh, d), 3 * n + 2, dtype, dev)
            name = (f"K4 (B,T,S,H,K,D)={(b, t, s, h, kh, d)} causal={causal}"
                    f" window={window} {dtype}")
            errs.append(_attn_check(
                name, fk.flash_attention(q, k, v, causal, window),
                fk.flash_attention_plain(q, k, v, causal, window)))
        torch.cuda.synchronize()
        print(f"K4 (B,T,S,H,K,D)={(b, t, s, h, kh, d)} causal={causal} "
              f"window={window}: max abs err bf16 {errs[0]:.3e}, f32 "
              f"{errs[1]:.3e}")
        worst = max(worst, *errs)
    return worst


def phase_k5(dk, dev) -> float:
    from repro_torch.models.attention import decode_bias

    worst = 0.0
    for n, (b, h, kh, s, d, index, window) in enumerate(K5_CASES):
        bias = decode_bias(index, s, window, b, dev)
        valid = int((bias[0] == 0).sum())
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            q = _rand((b, h, d), 100 + 3 * n, dtype, dev)
            k = _rand((b, s, kh, d), 101 + 3 * n, dtype, dev)
            v = _rand((b, s, kh, d), 102 + 3 * n, dtype, dev)
            name = (f"K5 (B,H,K,S,D)={(b, h, kh, s, d)} index={index} "
                    f"window={window} {dtype}")
            errs.append(_attn_check(name, dk.decode_attention(q, k, v, bias),
                                    dk.decode_attention_plain(q, k, v,
                                                              bias)))
        torch.cuda.synchronize()
        print(f"K5 (B,H,K,S,D)={(b, h, kh, s, d)} index={index} window="
              f"{window} ({valid} of {s} slots valid): max abs err bf16 "
              f"{errs[0]:.3e}, f32 {errs[1]:.3e}")
        worst = max(worst, *errs)
    return worst


def phase_serve(fk, dk):
    """The serving path at its defaults, K4/K5 counted over exactly it."""
    from repro_torch.launch import serve as serve_lib

    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    dk.reset_launch_counts()
    run = serve_lib.serve(SERVE_ARGV)
    torch.cuda.synchronize()
    launches = {"flash_attention": fk.flash_attention.launches,
                "decode_attention": dk.decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": SERVE_LAYERS * SERVE_BATCHES,
            "decode_attention": SERVE_LAYERS * SERVE_STEPS * SERVE_BATCHES}
    if (run.arch.num_layers, run.batches, run.decode_steps) != \
            (SERVE_LAYERS, SERVE_BATCHES, SERVE_STEPS) or launches != want:
        raise AssertionError(f"serving path: {run.arch.num_layers} layers, "
                             f"{run.batches} batches, {run.decode_steps} "
                             f"steps, launches {launches}; expected {want}")
    fb = run.first_batch
    for i, lg in enumerate(fb["logits"]):
        if tuple(lg.shape) != (16, 1, run.num_actions) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"served logits {i}: {tuple(lg.shape)}, "
                                 f"finite {bool(torch.isfinite(lg).all())}")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    print(f"serving: {run.arch.name} {run.param_count:,} params, "
          f"{run.arch.num_layers} layers, d_model {run.arch.d_model}; "
          f"launches K4 {launches['flash_attention']} K5 "
          f"{launches['decode_attention']}")
    print(f"serving: {run.actions_per_s:.1f} actions/s, p50 step latency "
          f"{med(run.step_latency_ms):.3f} ms (batch time / decode steps), "
          f"prefill {med(run.prefill_ms):.3f} ms (median of "
          f"{len(run.prefill_ms)}), decode step {med(run.decode_ms):.3f} ms "
          f"(median of {len(run.decode_ms)}), peak allocated "
          f"{peak / 1e9:.2f} GB")
    return launches, run


def phase_serve_logits(run) -> float:
    """Replay the first batch through the plain attention route."""
    from repro_torch.models import backbone as bb

    fb = run.first_batch
    toks = fb["tokens"]
    ctx = toks.shape[1]
    worst = 0.0
    with torch.no_grad():
        out = bb.apply_prefill(run.params, {"tokens": toks}, run.arch,
                               run.num_actions, impl="ref")
        outs = [out.policy_logits]
        cache, tok = out.cache, toks[:, -1:]
        for i, action in enumerate(fb["actions"]):
            out = bb.apply_decode(run.params, tok, cache, ctx + i, run.arch,
                                  run.num_actions, impl="ref")
            cache = out.cache
            outs.append(out.policy_logits)
            tok = action % run.arch.vocab_size
    for i, (got, want) in enumerate(zip(fb["logits"], outs)):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= LOGITS_RTOL * scale:
            raise AssertionError(f"served logits step {i}: max abs err "
                                 f"{err:.3e} > {LOGITS_RTOL} x max |logit| "
                                 f"{scale:.3e}")
        worst = max(worst, err / scale)
    print(f"served logits vs the plain route: prefill and {len(outs) - 1} "
          f"decode steps, worst max abs err {100 * worst:.3f}% of the "
          f"step's max |logit| (bar {100 * LOGITS_RTOL:.0f}%)")
    return worst


def phase_serve_split(run, profiled: int = 4) -> None:
    """Device busy time of a few decode steps against the unprofiled
    decode step, and the device kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import backbone as bb

    fb = run.first_batch
    toks = fb["tokens"]
    ctx = toks.shape[1]
    with torch.no_grad():
        out = bb.apply_prefill(run.params, {"tokens": toks}, run.arch,
                               run.num_actions)
        cache, tok = out.cache, toks[:, -1:]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(profiled):
                out = bb.apply_decode(run.params, tok, cache, ctx + i,
                                      run.arch, run.num_actions)
                cache = out.cache
                tok = fb["actions"][i] % run.arch.vocab_size
            torch.cuda.synchronize()
    step = sorted(run.decode_ms)[len(run.decode_ms) // 2]
    _print_busy(f"{run.arch.name} decode step", prof, profiled, step)


def _print_busy(what: str, prof, n: int, unprofiled_ms: float) -> None:
    """The card's busy time per call over ``n`` profiled calls against the
    unprofiled time of one, and the device kernels that take most of it."""
    busy_us, count, by_name = _device_busy(prof.events())
    if not count:
        print(f"{what} device busy share: not measured (the profiler trace "
              f"holds no device events)")
        return
    busy_ms = busy_us / n / 1e3
    print(f"{what} device: busy {busy_ms:.3f} ms per call over {n} profiled, "
          f"{count / n:.0f} device events per call; "
          f"{100 * busy_ms / unprofiled_ms:.1f}% of the unprofiled "
          f"{unprofiled_ms:.3f} ms, so the card idles "
          f"{100 - 100 * busy_ms / unprofiled_ms:.1f}% of it")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, calls) in top:
        print(f"  device {us / n / 1e3:8.3f} ms/call {calls / n:6.0f} "
              f"launches/call  {name[:90]}")


def _device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn``: the busy time of its device events
    in a ``torch.profiler`` trace of ``n`` calls, over ``n`` (no host
    time; NaN where the trace holds no device events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_us, count, _ = _device_busy(prof.events())
    return busy_us / n / 1e3 if count else math.nan


def _attn_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves: the work these inputs need."""
    total = 0
    for qp in range(t):
        hi = min(s, qp + 1) if causal else s
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def phase_attn_times(fk, dk, dev):
    """K4 and K5 at the serving path's shapes and one long shape each, in
    bf16, beside the plain version, the bound and one library call."""
    import torch.nn.functional as F

    from repro_torch.models.attention import decode_bias

    rows = {}
    bf = torch.bfloat16
    for label, (b, t, h, kh, d), iters in (
            ("main", (16, 128, 32, 8, 128), 200),
            ("long", (1, 4096, 32, 8, 128), 10)):
        q = _rand((b, t, h, d), 7, bf, dev)
        k = _rand((b, t, kh, d), 8, bf, dev)
        v = _rand((b, t, kh, d), 9, bf, dev)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = _time_ms(lambda: fk.flash_attention(q, k, v, True, 0), iters)
        plain_ms = _time_ms(lambda: fk.flash_attention_plain(q, k, v, True,
                                                             0), iters)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        ops = 4 * b * h * d * _attn_pairs(t, t, True, 0)
        bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
        dev_ms = _device_ms(lambda: fk.flash_attention(q, k, v, True, 0))
        lib_dev_ms = _device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        print(f"time flash_attention {label} (B,T,H,K,D)="
              f"{(b, t, h, kh, d)} causal bf16: kernel {ms:.5f} ms "
              f"({ops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s,"
              f" {100 * bound_ms / ms:.1f}% of the bound), plain "
              f"{plain_ms:.5f} ms, library (F.scaled_dot_product_attention)"
              f" {lib_ms:.5f} ms ({ops / lib_ms / 1e9:.1f} TFLOP/s), bound "
              f"{bound_ms:.7f} ms ({bound_by}: {nbytes} B, {ops} ops); "
              f"device time a call (profiler): kernel {dev_ms:.5f} ms "
              f"({100 * bound_ms / dev_ms:.1f}% of the bound), library "
              f"{lib_dev_ms:.5f} ms")
        if label == "main":
            rows["flash_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_ms,
                                           bound_by=bound_by,
                                           library_ms=lib_ms)
    for label, (b, h, kh, s, d), index, iters in (
            ("main", (16, 32, 8, 128, 128), 160, 200),
            ("long", (8, 32, 8, 32768, 128), 40000, 20)):
        q = _rand((b, h, d), 17, bf, dev)
        k = _rand((b, s, kh, d), 18, bf, dev)
        v = _rand((b, s, kh, d), 19, bf, dev)
        bias = decode_bias(index, s, 0, b, dev)
        q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask = bias.to(bf)[:, None, None, :]
        ms = _time_ms(lambda: dk.decode_attention(q, k, v, bias), iters)
        plain_ms = _time_ms(lambda: dk.decode_attention_plain(q, k, v, bias),
                            iters)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), iters)
        valid = int((bias == 0).sum())          # unmasked (row, slot) pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * s
        ops = 4 * h * d * valid
        bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
        dev_ms = _device_ms(lambda: dk.decode_attention(q, k, v, bias))
        lib_dev_ms = _device_ms(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nsplit, split_len = dk.plan_splits(b, kh, s, sms)
        print(f"time decode_attention {label} (B,H,K,S,D)="
              f"{(b, h, kh, s, d)} bf16: kernel {ms:.5f} ms "
              f"({nbytes / ms / 1e9:.3f} TB/s, {100 * bound_ms / ms:.1f}% of "
              f"the bound), plain {plain_ms:.5f} ms, library "
              f"(F.scaled_dot_product_attention) {lib_ms:.5f} ms "
              f"({nbytes / lib_ms / 1e9:.3f} TB/s), bound {bound_ms:.7f} ms "
              f"({bound_by}: {nbytes} B, {ops} ops); S in {nsplit} "
              f"split(s) of {split_len} keys: {b * kh * nsplit} blocks on "
              f"{sms} SMs"
              + (", plus the combine pass" if nsplit > 1 else "")
              + f"; device time a call (profiler): kernel {dev_ms:.5f} ms "
              f"({nbytes / dev_ms / 1e9:.3f} TB/s, "
              f"{100 * bound_ms / dev_ms:.1f}% of the bound), library "
              f"{lib_dev_ms:.5f} ms")
        if label == "main":
            rows["decode_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                            bound_ms=bound_ms,
                                            bound_by=bound_by,
                                            library_ms=lib_ms)
    return rows


# ---------------------------------------------------------------------------
# slice 3: the SSM serving path, K3


def _scan_inputs(t: int, n: int, seed: int, dev):
    """a uniform in [0, 1] (decays), b and h0 standard normal, drawn on the
    card from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((t, n), generator=g, device=dev)
    b = torch.randn((t, n), generator=g, device=dev)
    h0 = torch.randn((n,), generator=g, device=dev)
    return a, b, h0


def phase_k3(lk, dev) -> float:
    worst = 0.0
    for t, n in K3_SHAPES:
        a, b, h0 = _scan_inputs(t, n, t + n, dev)
        errs = [_check(f"K3 (T,N)={(t, n)} h0={init is not None}",
                       [lk.linear_scan(a, b, init)],
                       [lk.linear_scan_plain(a, b, init)])
                for init in (h0, None)]
        torch.cuda.synchronize()
        print(f"K3 (T,N)={(t, n)}: max abs err with h0 {errs[0]:.3e}, "
              f"without {errs[1]:.3e}")
        worst = max(worst, *errs)
        del a, b, h0
    return worst


def phase_serve_ssm(lk, fk, dk):
    """The mamba2 serving path, K3/K4/K5 counted over exactly it."""
    from repro_torch.launch import serve as serve_lib

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lk.reset_launch_counts()
    fk.reset_launch_counts()
    dk.reset_launch_counts()
    run = serve_lib.serve(SSM_ARGV)
    torch.cuda.synchronize()
    launches = {"linear_scan": lk.linear_scan.launches,
                "flash_attention": fk.flash_attention.launches,
                "decode_attention": dk.decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"linear_scan": SSM_LAYERS * SERVE_BATCHES,
            "flash_attention": 0, "decode_attention": 0}
    got = (run.arch.num_layers, run.param_count, run.batches,
           run.decode_steps)
    if got != (SSM_LAYERS, SSM_PARAMS, SERVE_BATCHES, SERVE_STEPS) or \
            launches != want:
        raise AssertionError(f"SSM serving path: (layers, params, batches, "
                             f"steps) {got}, launches {launches}; expected "
                             f"{(SSM_LAYERS, SSM_PARAMS, SERVE_BATCHES)}, "
                             f"{SERVE_STEPS} steps, launches {want}")
    fb = run.first_batch
    for i, lg in enumerate(fb["logits"]):
        if tuple(lg.shape) != (16, 1, run.num_actions) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"served logits {i}: {tuple(lg.shape)}, "
                                 f"finite {bool(torch.isfinite(lg).all())}")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    print(f"serving: {run.arch.name} {run.param_count:,} params, "
          f"{run.arch.num_layers} layers, d_model {run.arch.d_model}, ctx "
          f"{fb['tokens'].shape[1]}; launches K3 {launches['linear_scan']} "
          f"K4 {launches['flash_attention']} K5 "
          f"{launches['decode_attention']}")
    print(f"serving: {run.actions_per_s:.1f} actions/s, p50 step latency "
          f"{med(run.step_latency_ms):.3f} ms (batch time / decode steps), "
          f"prefill {med(run.prefill_ms):.3f} ms (median of "
          f"{len(run.prefill_ms)}), decode step {med(run.decode_ms):.3f} ms "
          f"(median of {len(run.decode_ms)}), peak allocated "
          f"{peak / 1e9:.2f} GB")
    return launches, run


def phase_prefill_split(run) -> None:
    """Device busy time of one profiled prefill against the unprofiled
    median, and the device kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import backbone as bb

    toks = run.first_batch["tokens"]
    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bb.apply_prefill(run.params, {"tokens": toks}, run.arch,
                             run.num_actions)
            torch.cuda.synchronize()
    _print_busy(f"{run.arch.name} prefill", prof, 1,
                sorted(run.prefill_ms)[len(run.prefill_ms) // 2])


def phase_scan_times(lk, dev):
    """K3 at the serving path's shape and at the RG-LRU prefill's, without
    h0 as the prefill calls it, beside the plain version and the bound."""
    rows = {}
    for label, (t, n), iters in (("main", K3_MAIN, 100),
                                 ("long", K3_LONG, 20)):
        a, b, _ = _scan_inputs(t, n, 3, dev)
        ms = _time_ms(lambda: lk.linear_scan(a, b), iters)
        plain_ms = _time_ms(lambda: lk.linear_scan_plain(a, b), iters)
        # a and b read once, h written once; a multiply and an add each
        nbytes, ops = 3 * t * n * 4, 2 * t * n
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"time linear_scan {label} (T,N)={(t, n)} f32: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.7f} ms "
              f"({bound_by}: {nbytes} B, {ops} ops), library: none (no "
              f"single PyTorch call computes the recurrence)")
        if label == "main":
            rows["linear_scan"] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
        del a, b
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import linear_scan as lk
    from repro_torch.kernels import vtrace as vk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; TF32 off for cuDNN convs and "
          f"cuBLAS matmuls in every phase")

    t0 = time.time()
    path, log = build.build()
    build.load()
    print(f"build: {time.time() - t0:.2f} s -> {path.relative_to(ROOT)}")
    for line in log.splitlines():
        # the registers of every kernel, and any wgmma that ptxas
        # had to serialise (its C75xx "Performance Loss" notes)
        if "ptxas info" in line and ("Used" in line or "Compiling" in line
                                     or "Performance Loss" in line):
            print(f"  {line.strip()}")

    err_k1 = phase_k1(vk, dev)
    err_k2 = phase_k2(vk, dev)
    launches, run = phase_main(vk, dev)
    phase_bandit()
    async_launches = phase_async(vk, dev)
    # loss_vtrace's launches over every path that runs it
    launches["loss_vtrace"] += async_launches["loss_vtrace"]
    phase_async_bar(dev)
    phase_split(run, dev)
    rows = phase_times(vk, dev)
    del run

    err_k4 = phase_k4(fk, dev)
    err_k5 = phase_k5(dk, dev)
    serve_launches, serve_run = phase_serve(fk, dk)
    launches.update(serve_launches)
    phase_serve_logits(serve_run)
    phase_serve_split(serve_run)
    del serve_run                     # the 46 GB of weights
    torch.cuda.empty_cache()
    rows.update(phase_attn_times(fk, dk, dev))

    err_k3 = phase_k3(lk, dev)
    ssm_launches, ssm_run = phase_serve_ssm(lk, fk, dk)
    launches["linear_scan"] = ssm_launches["linear_scan"]
    phase_serve_logits(ssm_run)
    phase_prefill_split(ssm_run)
    phase_serve_split(ssm_run)
    del ssm_run
    torch.cuda.empty_cache()
    rows.update(phase_scan_times(lk, dev))
    print(f"times above: {card}")

    meta = {
        "vtrace": ("src/repro_torch/csrc/vtrace.cu",
                   "src/repro/kernels/vtrace.py:74", err_k1),
        "loss_vtrace": ("src/repro_torch/csrc/vtrace.cu",
                        "src/repro/kernels/vtrace.py:165", err_k2),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:80",
                            err_k4),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:55",
                             err_k5),
        "linear_scan": ("src/repro_torch/csrc/linear_scan.cu",
                        "src/repro/kernels/linear_scan.py:38", err_k3),
    }
    kernels = []
    for name, (source, replaces, err) in meta.items():
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
