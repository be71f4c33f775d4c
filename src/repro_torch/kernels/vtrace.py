"""The two V-trace kernels (``repro.kernels.vtrace``), ported to CUDA.

* ``vtrace`` (K1) replaces ``vtrace_pallas``: the V-trace reverse
  recurrence on time-major (T, B) float32 inputs, returning (vs, pg_adv).
* ``loss_vtrace`` (K2) replaces ``loss_vtrace_pallas``: log-softmax,
  target log-prob, per-step negative entropy and the clipped importance
  weights from (T, B, A) logits, then the same recurrence, returning
  (tlp, neg_entropy, vs, pg_adv).
* ``fused_loss_vtrace`` replaces the ``custom_vjp`` around K2 with a
  ``torch.autograd.Function`` whose backward is the closed form.

The kernels are CUDA C++ in ``repro_torch/csrc/vtrace.cu`` (built by
``repro_torch.kernels.build``), one launch a call each; ``plan_vtrace``
cuts a problem into tiles of batch columns, T segments over a cluster of
blocks and chunks of a segment, for the launch and the CPU tests alike.
Each wrapper takes its plain PyTorch version (``vtrace_plain``,
``loss_vtrace_plain``) only because the tensors it was given lie on the
CPU; on CUDA tensors it launches the kernel or raises. ``launches`` on
each wrapper counts its kernel's launches, and nothing else; ``shapes``
on each is the set of problem shapes it launched at, which
``reset_launch_counts`` leaves as it is, so that a caller can collect the
shapes of several runs and hold each against the plain version.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import vtrace_ref

# K1's plain version is the oracle itself: the same reverse loop
vtrace_plain = vtrace_ref

WIDTH = 32              # batch columns a tile: one lane each in the chain
PREFETCH = 8            # chain steps read ahead (padding rows of the work)
MAX_CLUSTER = 8         # blocks a cluster (the portable limit)
MAX_THREADS = 512
SMEM_LIMIT = 232_448    # shared memory a block may use (227 KB)
CARD_SMS = 132          # SMs of an H100 SXM
# device-memory bytes (inputs read, outputs written) a block takes on
# before T is split over one more block of the tile's cluster
BLOCK_BYTES = 24 * 1024


def reset_launch_counts() -> None:
    vtrace.launches = 0
    loss_vtrace.launches = 0


# ---------------------------------------------------------------------------
# The plan: how the kernels cut a problem


def smem_bytes(chunk: int, width: int, a: int, stage_logits: bool) -> int:
    """Shared memory of a block (``smem_layout`` in csrc/vtrace.cu): 16
    bytes for the carry mbarrier; two stages of the chunk's (T, B) rows
    (5 for K2, 6 for K1) and, staged, its logits and one-hot; the work
    rows (a (delta/acc, coef) pair a column, after PREFETCH rows of
    padding); 32 carries. Arrays are rounded up to 4 floats. ``a`` = 0
    is K1."""
    r4 = lambda n: (n + 3) & ~3  # noqa: E731
    rows4 = r4(chunk * width)
    logit4 = r4(chunk * width * a) if a and stage_logits else 0
    stage = (5 if a else 6) * rows4 + 2 * logit4
    work = r4(2 * (chunk + PREFETCH) * width)
    return 16 + 4 * (2 * stage + work + WIDTH)


class VtracePlan(NamedTuple):
    """A launch of K1 (``a`` = 0) or K2: ``tiles`` clusters of ``cluster``
    blocks; a cluster owns ``width`` batch columns, its rank-k block the
    time steps [k seg, min(T, (k + 1) seg)), taken in chunks of ``chunk``
    steps by ``threads`` threads in ``smem`` bytes of shared memory.
    ``stage_logits``: K2's logits and one-hot go through shared memory
    (else a row that would not fit is read from device memory)."""
    t: int
    b: int
    a: int
    width: int
    tiles: int
    cluster: int
    seg: int
    chunk: int
    threads: int
    stage_logits: bool
    smem: int

    def columns(self) -> List[Tuple[int, int]]:
        """[b0, b1) of each tile."""
        return [(b0, min(self.b, b0 + self.width))
                for b0 in range(0, self.b, self.width)]

    def chain_order(self) -> List[Tuple[int, int]]:
        """[s0, s1) of a tile's chunks in the order its chain walks them:
        the segments from the last to the first, each segment's chunks
        from the last to the first."""
        order = []
        for k in reversed(range(self.cluster)):
            lo, hi = k * self.seg, min(self.t, (k + 1) * self.seg)
            order += [(s0, min(hi, s0 + self.chunk))
                      for s0 in reversed(range(lo, hi, self.chunk))]
        return order


@functools.cache
def plan_vtrace(t: int, b: int, a: int = 0) -> VtracePlan:
    """The cut of a (T, B) K1 (``a`` = 0) or (T, B, A) K2 problem.

    A tile is 32 batch columns (B, if smaller). T is split over a cluster
    of up to 8 blocks when the tile's bytes exceed BLOCK_BYTES a block,
    as long as the tiles' clusters fit the card's SMs: clusters of 2 at
    (20, 32, 3), of 8 at (100, 32, 9) and (100, 256, 18). A block's
    chunk is its whole segment where that fits in shared memory, else
    the most steps that do (two stages of them)."""
    if t < 1 or b < 1 or a < 0:
        raise ValueError(f"plan_vtrace: no work in {(t, b, a)}")
    width = min(WIDTH, b)
    tiles = -(-b // width)
    row_bytes = 4 * (2 * a + 9) if a else 4 * 8
    want = -(-t * width * row_bytes // BLOCK_BYTES)
    cluster = max(1, min(MAX_CLUSTER, t, CARD_SMS // tiles, want))
    seg = -(-t // cluster)
    cluster = -(-t // seg)                  # no empty segment
    stage = a > 0 and smem_bytes(1, width, a, True) <= SMEM_LIMIT
    step = smem_bytes(1, width, a, stage) - smem_bytes(0, width, a, stage)
    chunk = max(1, min(seg, (SMEM_LIMIT - smem_bytes(0, width, a, stage))
                       // step))
    while chunk > 1 and smem_bytes(chunk, width, a, stage) > SMEM_LIMIT:
        chunk -= 1
    threads = min(MAX_THREADS, 32 * -(-chunk * width // 32))
    return VtracePlan(t, b, a, width, tiles, cluster, seg, chunk, threads,
                      stage, smem_bytes(chunk, width, a, stage))


# ---------------------------------------------------------------------------
# K1: the V-trace recurrence

_K1_NAMES = ("rho", "c", "discounts", "rewards", "values", "values_tp1")


def vtrace(rho, c, discounts, rewards, values, values_tp1
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All inputs (T, B) float32, contiguous, on one device.
    Returns (vs, pg_adv), each (T, B)."""
    t, b = rho.shape
    if t < 1 or b < 1:
        raise ValueError(f"vtrace: empty input {tuple(rho.shape)}")
    args = (rho, c, discounts, rewards, values, values_tp1)
    dev = rho.device
    build.check_f32s(_K1_NAMES, args, (t, b), dev)
    if not build.on_cuda(dev, "V-trace"):
        return vtrace_plain(*args)
    p = plan_vtrace(t, b)
    out = torch.empty((2, t, b), dtype=torch.float32, device=dev)
    code = build.call_on(
        dev, build.load().repro_vtrace, *(x.data_ptr() for x in args),
        out.data_ptr(), t, b, p.cluster, p.seg, p.chunk, p.threads, p.smem,
        build.stream(dev))
    build.raise_on(code, "repro_vtrace")
    vtrace.launches += 1
    vtrace.shapes.add((t, b))
    return out.unbind(0)


vtrace.launches = 0
vtrace.shapes = set()


# ---------------------------------------------------------------------------
# K2: fused loss + V-trace

_K2_NAMES = ("behaviour_logprob", "discounts", "rewards", "values",
             "values_tp1")


def _sum_actions(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (action) axis from left to right, the order of
    the kernel's loop, so both round alike."""
    total = x[..., 0]
    for a in range(1, x.shape[-1]):
        total = total + x[..., a]
    return total


def loss_rows_plain(logits, onehot, behaviour_logprob,
                    rho_bar: Optional[float] = 1.0,
                    c_bar: Optional[float] = 1.0, lambda_: float = 1.0):
    """K2's per-row terms in PyTorch ops, in the kernel's order: (tlp,
    neg_entropy, rho, c), each (T, B). Differentiable in ``logits``
    through tlp and neg_entropy; rho and c read a detached tlp."""
    m = torch.amax(logits, dim=-1, keepdim=True)
    logp = logits - m - torch.log(
        _sum_actions(torch.exp(logits - m)))[..., None]
    tlp = _sum_actions(logp * onehot)
    p = torch.exp(logp)
    ne = _sum_actions(p * logp)
    rho_raw = torch.exp(tlp.detach() - behaviour_logprob)
    rho = rho_raw if rho_bar is None else torch.clamp(rho_raw, max=rho_bar)
    c = lambda_ * (rho_raw if c_bar is None
                   else torch.clamp(rho_raw, max=c_bar))
    return tlp, ne, rho, c


def loss_vtrace_plain(logits, onehot, behaviour_logprob, discounts, rewards,
                      values, values_tp1, rho_bar: Optional[float] = 1.0,
                      c_bar: Optional[float] = 1.0, lambda_: float = 1.0):
    """K2's arithmetic in PyTorch ops, in the kernel's order.
    Differentiable in ``logits`` through tlp and neg_entropy; the clipped
    weights read a detached tlp, so vs/pg_adv are targets."""
    tlp, ne, rho, c = loss_rows_plain(logits, onehot, behaviour_logprob,
                                      rho_bar, c_bar, lambda_)
    vs, pg = vtrace_ref(rho, c, discounts, rewards, values, values_tp1)
    return tlp, ne, vs, pg


def loss_vtrace(logits, onehot, behaviour_logprob, discounts, rewards,
                values, values_tp1, rho_bar: Optional[float] = 1.0,
                c_bar: Optional[float] = 1.0, lambda_: float = 1.0):
    """Forward-only fused pass, with ``loss_vtrace_pallas``'s signature.
    ``logits``/``onehot`` are (T, B, A) float32, everything else (T, B)
    float32. Returns (target_logprob, neg_entropy, vs, pg_adv), each
    (T, B). ``None`` for ``rho_bar``/``c_bar`` means no clip."""
    t, b, a = logits.shape
    if t < 1 or b < 1 or a < 1:
        raise ValueError(f"loss_vtrace: empty input {tuple(logits.shape)}")
    dev = logits.device
    flat = (behaviour_logprob, discounts, rewards, values, values_tp1)
    build.check_f32s(("logits", "onehot"), (logits, onehot), (t, b, a), dev)
    build.check_f32s(_K2_NAMES, flat, (t, b), dev)
    if not build.on_cuda(dev, "V-trace"):
        return loss_vtrace_plain(logits, onehot, *flat, rho_bar=rho_bar,
                                 c_bar=c_bar, lambda_=lambda_)
    p = plan_vtrace(t, b, a)
    out = torch.empty((4, t, b), dtype=torch.float32, device=dev)
    code = build.call_on(
        dev, build.load().repro_loss_vtrace, logits.data_ptr(),
        onehot.data_ptr(), *(x.data_ptr() for x in flat), out.data_ptr(),
        t, b, a, p.cluster, p.seg, p.chunk, p.threads, p.stage_logits,
        p.smem, 0.0 if rho_bar is None else float(rho_bar),
        rho_bar is not None, 0.0 if c_bar is None else float(c_bar),
        c_bar is not None, float(lambda_), build.stream(dev))
    build.raise_on(code, "repro_loss_vtrace")
    loss_vtrace.launches += 1
    loss_vtrace.shapes.add((t, b, a))
    return out.unbind(0)


loss_vtrace.launches = 0
loss_vtrace.shapes = set()


class _FusedLossVtrace(torch.autograd.Function):
    """Gradients flow ONLY into ``logits``, through tlp and neg_entropy,
    in closed form (no scan in the backward): d tlp / d logits =
    onehot - p and d ne / d logits = p (logp - ne). vs/pg_adv are V-trace
    targets and carry no gradient."""

    @staticmethod
    def forward(ctx, logits, onehot, behaviour_logprob, discounts, rewards,
                values, values_tp1, rho_bar, c_bar, lambda_):
        tlp, ne, vs, pg = loss_vtrace(logits, onehot, behaviour_logprob,
                                      discounts, rewards, values,
                                      values_tp1, rho_bar, c_bar, lambda_)
        ctx.save_for_backward(logits, onehot, ne)
        ctx.mark_non_differentiable(vs, pg)
        return tlp, ne, vs, pg

    @staticmethod
    def backward(ctx, g_tlp, g_ne, _g_vs, _g_pg):
        logits, onehot, ne = ctx.saved_tensors
        logp = torch.log_softmax(logits, dim=-1)
        p = torch.exp(logp)
        d_logits = (g_tlp[..., None] * (onehot - p) +
                    g_ne[..., None] * p * (logp - ne[..., None]))
        return (d_logits,) + (None,) * 9


def fused_loss_vtrace(logits, onehot, behaviour_logprob, discounts, rewards,
                      values, values_tp1, rho_bar: Optional[float] = 1.0,
                      c_bar: Optional[float] = 1.0, lambda_: float = 1.0):
    """Differentiable wrapper over ``loss_vtrace`` (one K2 launch)."""
    return _FusedLossVtrace.apply(logits, onehot, behaviour_logprob,
                                  discounts, rewards, values, values_tp1,
                                  rho_bar, c_bar, lambda_)
