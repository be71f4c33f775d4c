"""Token training in the port against the JAX package: the train modes of
attention (causal, windowed, bidirectional, cross with ``kv_x``, and the
chunked online softmax above 4096 keys), of the SSD block (one short
chunk where T < chunk_size, and several), of the RG-LRU block and of the
MoE layer with its aux loss; ``apply_train`` and the learner's loss and
gradients (``build_loss_fn``) for every token smoke config, the vlm and
audio ones with stub embeddings; K3's autograd Function against autograd
through its plain loop; and a train step on the kernel route
(``impl='pallas'``) on the CPU, which reaches neither K4 nor K5.

Weights are drawn with numpy at the JAX spec tree's shapes
(``spec_params``) and carried over by ``from_jax``; inputs come from
numpy seeds. JAX's train branch reaches no Pallas kernel (dense or
chunked attention, a ``lax.scan`` over chunks, a chunked associative
scan), so its functions are called directly. Tolerances: float32
forwards at 1e-5, gradients at 1e-4 of each leaf's largest magnitude
plus 1e-4 relative (float32 sums over the batch, time and width of terms
of that scale, in other orders); the bf16 case at ``tests/test_models.py``'s
5e-3.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import learner as j_learner
from repro.models import attention as j_attn
from repro.models import backbone as j_bb
from repro.models import moe as j_moe
from repro.models import rglru as j_rglru
from repro.models import ssm as j_ssm

from repro_torch import params as P
from repro_torch.configs.base import ImpalaConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import learner
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import linear_scan as lk
from repro_torch.kernels import ref
from repro_torch.models import attention, backbone as bb, moe, rglru, ssm

from test_torch_attention import spec_params

torch.set_num_threads(1)

A = 3
FWD = dict(atol=1e-5, rtol=1e-5)
TOKEN_ARCHS = ["mistral-nemo-12b", "mamba2-1.3b", "gemma-7b", "qwen1.5-4b",
               "stablelm-1.6b", "recurrentgemma-2b", "granite-moe-1b-a400m",
               "olmoe-1b-7b", "llama-3.2-vision-11b", "whisper-small"]


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().to(torch.float32).numpy(),
                               **(tol or FWD))


def _close_grad(want, got, name=""):
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(want, got.detach().to(torch.float32).numpy(),
                               atol=1e-4 * max(scale, 1e-3), rtol=1e-4,
                               err_msg=name)


def _close_grads(want_tree, got_tree):
    w, g = P.flatten(want_tree), P.flatten(got_tree)
    assert sorted(w) == sorted(g)
    for key in w:
        _close_grad(w[key], g[key], key)


@functools.lru_cache(maxsize=None)
def _params(arch, part, seed=0):
    """The numpy weights of one module of ``arch``'s smoke config, drawn
    once a module (the JAX trees are shared by every test here)."""
    cfg = j_smoke(arch)
    specs = {"attn": lambda: j_attn.attention_specs(cfg),
             "ssm": lambda: j_ssm.ssm_specs(cfg),
             "rglru": lambda: j_rglru.rglru_specs(cfg),
             "moe": lambda: j_moe.moe_specs(cfg),
             "model": lambda: j_bb.backbone_specs(cfg, A)}[part]()
    return spec_params(specs, seed)


def _grad_pair(j_fn, t_fn, p, x):
    """(value, dparams, dx) of the scalar ``fn(params, x)`` in JAX and in
    the port, on the same numpy params and input."""
    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1)))(
        p, jnp.asarray(x))
    # bridged under a prefix: a block's own ``conv/kernel`` at the root of
    # its tree would be taken for a torso conv's
    tp = P.from_jax({"m": p})["m"]
    tx = torch.from_numpy(x).requires_grad_(True)
    tv = t_fn(tp, tx)
    leaves = P.tree_leaves(tp)
    grads = torch.autograd.grad(tv, leaves + [tx])
    return ((jv, jgp, jgx),
            (tv, P.tree_unflatten_like(tp, list(grads[:-1])), grads[-1]))


def _check_pair(j_out, t_out):
    (jv, jgp, jgx), (tv, tgp, tgx) = j_out, t_out
    _close(jv, tv)
    _close_grad(jgx, tgx, "x")
    _close_grads(jgp, tgp)


# ---------------------------------------------------------------------------
# K3's autograd Function


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("t,n", [(1, 37), (21, 64), (40, 33)])
def test_k3_function_gradients_match_autograd_through_the_loop(t, n,
                                                               with_h0):
    """The wrapper's Function (plain loop both ways on the CPU) gives the
    gradients autograd takes through the oracle's loop: da, db and dh0
    under one random cotangent; its output has a grad_fn and it counts no
    launch here."""
    rng = np.random.default_rng(t * 100 + n)
    a = rng.uniform(0.0, 1.0, (t, n)).astype(np.float32)
    b = rng.standard_normal((t, n)).astype(np.float32)
    h0 = rng.standard_normal(n).astype(np.float32) if with_h0 else None
    ct = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32))

    def run(fn):
        ta = torch.from_numpy(a).requires_grad_(True)
        tb = torch.from_numpy(b).requires_grad_(True)
        th0 = None if h0 is None else \
            torch.from_numpy(h0).requires_grad_(True)
        h = fn(ta, tb, th0)
        ins = [x for x in (ta, tb, th0) if x is not None]
        return h, torch.autograd.grad((h * ct).sum(), ins)

    lk.reset_launch_counts()
    h_fn, g_fn = run(lk.linear_scan)
    h_ref, g_ref = run(ref.linear_scan_ref)
    assert h_fn.grad_fn is not None
    assert type(h_fn.grad_fn).__name__.startswith("LinearScanFn")
    assert lk.linear_scan.launches == 0
    torch.testing.assert_close(h_fn, h_ref, rtol=0, atol=0)
    for got, want in zip(g_fn, g_ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the mixers' train modes


@pytest.mark.parametrize("kind", ["causal", "window", "bidirectional",
                                  "cross"])
def test_attention_train_mode_matches_jax(kind):
    j_cfg = j_smoke("mistral-nemo-12b").replace(dtype="float32")
    t_cfg = get_smoke_config("mistral-nemo-12b").replace(dtype="float32")
    p = _params("mistral-nemo-12b", "attn")
    b, t, s = 2, 12, 7
    x = _normal((b, t, j_cfg.d_model), 1)
    kv = _normal((b, s, j_cfg.d_model), 2)
    pos = np.broadcast_to(np.arange(t)[None], (b, t))
    kw = {"causal": dict(causal=True), "window": dict(window=5),
          "bidirectional": dict(causal=False), "cross": {}}[kind]
    ct = _normal((b, t, j_cfg.d_model), 3)

    def j_fn(p_, x_):
        y, cache = j_attn.apply_attention(
            p_, x_, jnp.asarray(pos), j_cfg, mode="train",
            kv_x=jnp.asarray(kv) if kind == "cross" else None, **kw)
        assert cache is None
        return jnp.sum(y * ct)

    def t_fn(p_, x_):
        y, cache = attention.apply_attention(
            p_, x_, torch.from_numpy(pos.copy()), t_cfg, mode="train",
            kv_x=torch.from_numpy(kv) if kind == "cross" else None, **kw)
        assert cache is None
        return (y * torch.from_numpy(ct)).sum()

    _check_pair(*_grad_pair(j_fn, t_fn, p, x))


def test_attention_train_mode_above_the_dense_threshold_matches_jax():
    """T = 4,100 > 4,096: JAX's chunked online softmax (q chunks of 512,
    kv chunks of 1,024, both padded), windowed, at a tiny width."""
    j_cfg = j_smoke("mistral-nemo-12b").replace(
        dtype="float32", d_model=16, num_heads=2, num_kv_heads=1,
        head_dim=8)
    t_cfg = get_smoke_config("mistral-nemo-12b").replace(
        dtype="float32", d_model=16, num_heads=2, num_kv_heads=1,
        head_dim=8)
    p = spec_params(j_attn.attention_specs(j_cfg), 4)
    t = attention.DENSE_SEQ_THRESHOLD + 4
    x = _normal((1, t, 16), 5)
    pos = np.arange(t)[None]
    ct = _normal((1, t, 16), 6)

    def j_fn(p_, x_):
        y, _ = j_attn.apply_attention(p_, x_, jnp.asarray(pos), j_cfg,
                                      window=1500, mode="train")
        return jnp.sum(y * ct)

    def t_fn(p_, x_):
        y, _ = attention.apply_attention(p_, x_, torch.from_numpy(pos),
                                         t_cfg, window=1500, mode="train")
        return (y * torch.from_numpy(ct)).sum()

    _check_pair(*_grad_pair(j_fn, t_fn, p, x))


@pytest.mark.parametrize("t", [9, 40])
def test_ssm_train_mode_matches_jax(t):
    """T = 9 < chunk_size 16: the port runs one chunk of 9 where JAX pads
    to one chunk of 16 (the short-chunk equality); T = 40: three chunks,
    the last padded, the cross-chunk pass through K3's Function."""
    j_cfg = j_smoke("mamba2-1.3b").replace(dtype="float32")
    t_cfg = get_smoke_config("mamba2-1.3b").replace(dtype="float32")
    p = _params("mamba2-1.3b", "ssm")
    x = _normal((2, t, j_cfg.d_model), 7 + t)
    ct = _normal((2, t, j_cfg.d_model), 8 + t)

    def j_fn(p_, x_):
        y, st = j_ssm.apply_ssm(p_, x_, j_cfg, mode="train")
        assert st is None
        return jnp.sum(y * ct)

    def t_fn(p_, x_):
        y, st = ssm.apply_ssm(p_, x_, t_cfg, mode="train", impl="pallas")
        assert st is None
        return (y * torch.from_numpy(ct)).sum()

    _check_pair(*_grad_pair(j_fn, t_fn, p, x))


def test_rglru_train_mode_matches_jax():
    j_cfg = j_smoke("recurrentgemma-2b").replace(dtype="float32")
    t_cfg = get_smoke_config("recurrentgemma-2b").replace(dtype="float32")
    p = _params("recurrentgemma-2b", "rglru")
    x = _normal((2, 21, j_cfg.d_model), 9)
    ct = _normal((2, 21, j_cfg.d_model), 10)

    def j_fn(p_, x_):
        y, st = j_rglru.apply_rglru(p_, x_, j_cfg, mode="train")
        assert st is None
        return jnp.sum(y * ct)

    def t_fn(p_, x_):
        y, st = rglru.apply_rglru(p_, x_, t_cfg, mode="train",
                                  impl="pallas")
        assert st is None
        return (y * torch.from_numpy(ct)).sum()

    _check_pair(*_grad_pair(j_fn, t_fn, p, x))


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_under_autograd_matches_jax(capacity_factor):
    """The output and the aux loss carry the gradients ``jax.grad``
    gives, the router's gates included; at capacity factor 0.5 tokens are
    dropped, and theirs is zero in both."""
    import dataclasses
    j_cfg = j_smoke("granite-moe-1b-a400m").replace(dtype="float32")
    t_cfg = get_smoke_config("granite-moe-1b-a400m").replace(dtype="float32")
    if capacity_factor is not None:
        j_cfg = j_cfg.replace(moe=dataclasses.replace(
            j_cfg.moe, capacity_factor=capacity_factor))
        t_cfg = t_cfg.replace(moe=dataclasses.replace(
            t_cfg.moe, capacity_factor=capacity_factor))
    p = _params("granite-moe-1b-a400m", "moe")
    x = _normal((2, 12, j_cfg.d_model), 11)
    ct = _normal((2, 12, j_cfg.d_model), 12)

    def j_fn(p_, x_):
        y, aux = j_moe.apply_moe(p_, x_, j_cfg)
        return jnp.sum(y * ct) + 3.0 * aux

    def t_fn(p_, x_):
        y, aux = moe.apply_moe(p_, x_, t_cfg)
        return (y * torch.from_numpy(ct)).sum() + 3.0 * aux

    j_out, t_out = _grad_pair(j_fn, t_fn, p, x)
    _check_pair(j_out, t_out)
    if capacity_factor is not None:
        dropped = np.all(np.asarray(j_out[2]) == 0.0, axis=-1)
        # a token all of whose pairs were dropped reaches the loss only
        # through the router: its gradient is the router's part alone
        assert np.array_equal(
            dropped, np.all(t_out[2].numpy() == 0.0, axis=-1))


# ---------------------------------------------------------------------------
# apply_train and the learner's loss, every token config


def _batch(j_cfg, seed, b=2, t=9):
    rng = np.random.default_rng(seed)
    batch = {
        "obs_token": rng.integers(0, j_cfg.vocab_size,
                                  (b, t + 1)).astype(np.int32),
        "actions": rng.integers(0, A, (b, t)).astype(np.int32),
        "rewards": rng.standard_normal((b, t)).astype(np.float32),
        "discounts": (0.99 * (rng.uniform(size=(b, t)) > 0.1)
                      ).astype(np.float32),
        "behaviour_logprob": -rng.uniform(0.5, 1.5, (b, t)
                                          ).astype(np.float32),
    }
    key = {"vlm": "image_embed", "audio": "enc_embed"}.get(j_cfg.family)
    if key:
        batch[key] = rng.standard_normal(
            (b, j_cfg.encoder_seq_len, j_cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_apply_train_loss_and_gradients_match_jax(arch):
    """``apply_train`` (logits, values, aux) and ``build_loss_fn``'s loss,
    metrics and gradients in float32, the MoE aux term included
    (granite-moe at aux_coef 0.05, olmoe at the default 0.01), on the
    kernel route (K3 through its Function's plain loops here)."""
    j_cfg = j_smoke(arch).replace(dtype="float32")
    t_cfg = get_smoke_config(arch).replace(dtype="float32")
    p = _params(arch, "model")
    batch = _batch(j_cfg, 13)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model_keys = [k for k in batch if k.endswith("_embed")]
    j_out = jax.jit(lambda p_, b_: j_bb.apply_train(p_, b_, j_cfg, A))(
        p, {"tokens": j_batch["obs_token"],
            **{k: j_batch[k] for k in model_keys}})
    tp = P.from_jax(p)
    t_out = bb.apply_train(tp, {"tokens": t_batch["obs_token"],
                                **{k: t_batch[k] for k in model_keys}},
                           t_cfg, A, impl="pallas")
    assert t_out.cache is None
    _close(j_out.policy_logits, t_out.policy_logits)
    _close(j_out.values, t_out.values)
    _close(j_out.aux_loss, t_out.aux_loss)

    aux_coef = 0.05 if arch == "granite-moe-1b-a400m" else 0.01
    j_ic = JaxImpalaConfig(num_actions=A, unroll_length=9)
    t_ic = ImpalaConfig(num_actions=A, unroll_length=9)
    j_loss = j_learner.build_loss_fn(j_cfg, j_ic, A, vtrace_impl="scan",
                                     aux_coef=aux_coef)
    (jv, jm), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        p, j_batch)
    t_loss = learner.build_loss_fn(t_cfg, t_ic, A, vtrace_impl="scan",
                                   aux_coef=aux_coef, impl="pallas")
    grad_step = learner._grad_fn(t_loss)
    grads, tm = grad_step(tp, t_batch)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(jm[k], tm[k], atol=1e-5, rtol=1e-5)
    assert ("loss/moe_aux" in tm) == (t_cfg.moe is not None)
    _close_grads(jg, P.tree_unflatten_like(tp, grads))


def test_replay_loss_with_the_moe_aux_matches_jax():
    """``build_replay_loss_fn`` (target values as the replayed rows'
    baseline) with granite-moe's aux term: loss, metrics and gradients."""
    arch = "granite-moe-1b-a400m"
    j_cfg = j_smoke(arch).replace(dtype="float32")
    t_cfg = get_smoke_config(arch).replace(dtype="float32")
    p = _params(arch, "model")
    target = _params(arch, "model", seed=1)
    batch = _batch(j_cfg, 16)
    batch["replay_mask"] = np.array([1.0, 0.0], np.float32)
    j_ic = JaxImpalaConfig(num_actions=A, unroll_length=9)
    t_ic = ImpalaConfig(num_actions=A, unroll_length=9)
    j_loss = j_learner.build_replay_loss_fn(j_cfg, j_ic, A,
                                            vtrace_impl="scan")
    (jv, jm), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        p, target, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss = learner.build_replay_loss_fn(t_cfg, t_ic, A,
                                          vtrace_impl="scan")
    tp = P.from_jax(p)
    grads, tm = learner._grad_fn(t_loss)(
        tp, P.from_jax(target, requires_grad=False),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert "loss/moe_aux" in tm and sorted(tm) == sorted(jm)
    for k in jm:
        _close(jm[k], tm[k])
    _close_grads(jg, P.tree_unflatten_like(tp, grads))


def test_apply_train_bf16_matches_jax():
    """The smoke config in its own dtype (bf16 activations, f32 weights)."""
    j_cfg, t_cfg = j_smoke("stablelm-1.6b"), get_smoke_config("stablelm-1.6b")
    p = _params("stablelm-1.6b", "model")
    tokens = _batch(j_cfg, 14)["obs_token"]
    j_out = jax.jit(lambda p_, t_: j_bb.apply_train(
        p_, {"tokens": t_}, j_cfg, A))(p, jnp.asarray(tokens))
    t_out = bb.apply_train(P.from_jax(p), {"tokens": torch.from_numpy(
        tokens)}, t_cfg, A)
    _close(j_out.policy_logits, t_out.policy_logits, atol=5e-3, rtol=5e-3)
    _close(j_out.values, t_out.values, atol=5e-3, rtol=5e-3)


# ---------------------------------------------------------------------------
# the kernel route on the CPU


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-2b"])
def test_kernel_route_train_step_moves_every_leaf_and_skips_k4_k5(
        monkeypatch, arch):
    """A train step with ``impl='pallas'`` (and K2 named) gives every
    leaf a nonzero gradient and moves it, and calls neither K4 nor K5
    (they have no backward and refuse grad-requiring inputs)."""
    t_cfg = get_smoke_config(arch)

    def refused(*args, **kw):
        raise AssertionError("the train step reached K4 or K5")

    monkeypatch.setattr(fk, "flash_attention", refused)
    monkeypatch.setattr(dk, "decode_attention", refused)
    p = _params(arch, "model")
    tp = P.from_jax(p)
    before = P.flatten(P.snapshot(tp))
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(j_smoke(arch), 15).items()}
    t_ic = ImpalaConfig(num_actions=A, unroll_length=9)
    step, opt = learner.build_train_step(t_cfg, t_ic, A,
                                         vtrace_impl="pallas",
                                         impl="pallas")
    grads, _ = learner._grad_fn(learner.build_loss_fn(
        t_cfg, t_ic, A, vtrace_impl="pallas", impl="pallas"))(tp, batch)
    names = list(P.flatten(tp))
    for name, g in zip(names, grads):
        assert g.abs().sum() > 0, name
    tp, _, metrics = step(tp, opt.init(tp), 0, batch)
    assert np.isfinite(float(metrics["loss/total"]))
    after = P.flatten(tp)
    for name in names:
        assert not torch.equal(before[name], after[name]), name
