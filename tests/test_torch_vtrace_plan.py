"""The redesigned V-trace kernels' order of work, emulated on the CPU.

K1 and K2 (csrc/vtrace.cu) compute every row's terms at once (phase a),
walk the recurrence acc = delta + coef * acc over each tile's chunks in
the order ``plan_vtrace`` gives (segments last to first, each handing its
carry to the one before), then compute vs and pg at once (phase c). The
emulation below does the same in PyTorch, chunk by chunk as the same
plan cuts the work, with each chunk's carry handed on explicitly, and
must equal the plain versions bit for bit: the kernels reorder no
rounding, so any difference here is a fault of the order. Inputs are made
with numpy from a seed; the plan's invariants are checked on their own.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import vtrace as vk

torch.set_num_threads(1)

CLIPS = [(1.0, 1.0, 1.0), (None, None, 1.0), (2.0, 1.0, 1.0),
         (1.0, 1.0, 0.9)]
SHAPES = [(1, 1, 1), (20, 32, 3), (37, 130, 5), (100, 32, 9), (16, 8, 130),
          (33, 45, 4)]


def _inputs(t, b, a, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, b, a)) * 2.0
    onehot = np.eye(a)[rng.integers(0, a, (t, b))]
    pert = logits + rng.standard_normal((t, b, a)) * 0.3
    pert = pert - pert.max(-1, keepdims=True)
    blp = ((pert - np.log(np.exp(pert).sum(-1, keepdims=True))) *
           onehot).sum(-1)
    disc = np.where(rng.uniform(size=(t, b)) < 0.1, 0.0, 0.97)
    rew = rng.standard_normal((t, b))
    v = rng.standard_normal((t, b))
    vtp1 = np.concatenate([v[1:], rng.standard_normal((1, b))], 0)
    return tuple(torch.from_numpy(x.astype(np.float32))
                 for x in (logits, onehot, blp, disc, rew, v, vtp1))


def emulate(plan, rho, c, disc, rew, v, vtp1):
    """(vs, pg) in the kernels' order of work under ``plan``: each tile
    takes its chunks in ``chain_order``; a chunk's rows get (a) delta and
    coef, (b) the walk from the carry handed on by the chunk after it (the
    next block's final acc at a segment's edge), (c) vs and pg, its last
    row's pg reading that carry. Rows no chunk covers stay NaN."""
    vs = torch.full_like(rho, float("nan"))
    pg = torch.full_like(rho, float("nan"))
    for b0, b1 in plan.columns():
        carry = torch.zeros(b1 - b0)                # acc past the last step
        for s0, s1 in plan.chain_order():
            at = (slice(s0, s1), slice(b0, b1))
            delta = rho[at] * (rew[at] + disc[at] * vtp1[at] - v[at])  # (a)
            coef = disc[at] * c[at]
            acc = torch.empty(s1 - s0 + 1, b1 - b0)
            acc[-1] = carry
            for i in reversed(range(s1 - s0)):      # (b), the chain
                acc[i] = delta[i] + coef[i] * acc[i + 1]
            vs[at] = v[at] + acc[:-1]               # (c)
            pg[at] = rho[at] * (rew[at] + disc[at] * (vtp1[at] + acc[1:])
                                - v[at])
            carry = acc[0]
    return vs, pg


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("t,b,a", SHAPES)
def test_k2_order_equals_plain(t, b, a, clip):
    inp = _inputs(t, b, a, seed=t * 131 + b * 7 + a)
    tlp, ne, rho, c = vk.loss_rows_plain(*inp[:3], *clip)
    vs, pg = emulate(vk.plan_vtrace(t, b, a), rho, c, *inp[3:])
    want = vk.loss_vtrace_plain(*inp, *clip)
    for got, w in zip((tlp, ne, vs, pg), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("t,b,a", SHAPES)
def test_k1_order_equals_plain(t, b, a, clip):
    inp = _inputs(t, b, a, seed=t * 17 + b)
    _, _, rho, c = vk.loss_rows_plain(*inp[:3], *clip)
    got = emulate(vk.plan_vtrace(t, b), rho, c, *inp[3:])
    want = vk.vtrace_plain(rho, c, *inp[3:])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("t,b,a", SHAPES + [
    (1000, 1, 3), (1000, 256, 18), (100, 256, 18), (4, 64, 1000),
    (1, 300, 2), (100, 256, 0), (20, 32, 0), (1, 1, 0), (2000, 3, 0)])
def test_plan_covers_every_row_once_within_limits(t, b, a):
    p = vk.plan_vtrace(t, b, a)
    assert 1 <= p.cluster <= vk.MAX_CLUSTER
    assert p.tiles * p.cluster <= max(vk.CARD_SMS, p.tiles)
    assert p.smem <= vk.SMEM_LIMIT == 232_448
    assert p.smem == vk.smem_bytes(p.chunk, p.width, a, p.stage_logits)
    assert 32 <= p.threads <= vk.MAX_THREADS and p.threads % 32 == 0
    assert 1 <= p.chunk <= p.seg and (p.cluster - 1) * p.seg < t
    # the columns tile [0, B); the chain walks [0, T) from the end,
    # chunk after adjacent chunk, every segment non-empty
    cols = p.columns()
    assert len(cols) == p.tiles and cols[0][0] == 0 and cols[-1][1] == b
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(cols, cols[1:]))
    order = p.chain_order()
    assert order[0][1] == t and order[-1][0] == 0
    assert all(lo == hi2 for (lo, _), (_, hi2) in zip(order, order[1:]))
    assert all(hi > lo and hi - lo <= p.chunk for lo, hi in order)
    seen = torch.zeros(t, b, dtype=torch.int32)
    for b0, b1 in cols:
        for s0, s1 in order:
            seen[s0:s1, b0:b1] += 1
    assert bool((seen == 1).all())


def test_plan_splits_time_where_a_tile_would_idle_the_card():
    # the main path's shape takes two blocks; the paper's DMLab learner
    # shape and (100, 256, 18) spread over clusters of 8
    assert vk.plan_vtrace(20, 32, 3).cluster == 2
    assert vk.plan_vtrace(100, 32, 9).cluster == 8
    big = vk.plan_vtrace(100, 256, 18)
    assert (big.tiles, big.cluster) == (8, 8)
    # a row too long to stage is read from device memory instead
    assert vk.plan_vtrace(4, 64, 1000).stage_logits is False
    assert vk.plan_vtrace(20, 32, 3).stage_logits is True
    # T >> B: long segments cut into chunks that fit shared memory
    long = vk.plan_vtrace(1000, 256, 18)
    assert long.chunk < long.seg and long.stage_logits


def test_plan_refuses_empty_problems():
    for shape in ((0, 4, 3), (4, 0, 3), (4, 4, -1)):
        with pytest.raises(ValueError, match="no work"):
            vk.plan_vtrace(*shape)
