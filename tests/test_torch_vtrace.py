"""The port's V-trace, corrections and losses against the JAX package.

Inputs come from numpy seeds and reach both packages as arrays. The JAX
Pallas kernels run in interpret mode on the CPU, as tests/test_kernels.py
runs them; the port's kernel wrappers take their plain versions on CPU
tensors. Tolerances: 1e-5 absolute (and relative) on per-element
outputs, as tests/test_kernels.py uses; sums over a batch (loss totals)
get 1e-4 absolute for the other summation order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ImpalaConfig as JaxImpalaConfig
from repro.core import corrections as j_corr
from repro.core import losses as j_losses
from repro.core import vtrace as j_vt
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import vtrace as j_kern

from repro_torch.configs.base import ImpalaConfig
from repro_torch.core import corrections, losses
from repro_torch.core import vtrace as vt
from repro_torch.kernels import ops
from repro_torch.kernels import vtrace as vk

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(),
                               **(tol or TOL))


def _k1_inputs(t, b, seed):
    rng = np.random.default_rng(seed)
    rho = np.minimum(np.exp(rng.standard_normal((t, b)) * 0.4), 2.0)
    c = np.minimum(rho, 1.0)
    disc = np.where(rng.uniform(size=(t, b)) < 0.2, 0.0, 0.9)
    rew = rng.standard_normal((t, b))
    v = rng.standard_normal((t, b))
    vtp1 = np.concatenate([v[1:], rng.standard_normal((1, b))], 0)
    return tuple(x.astype(np.float32) for x in (rho, c, disc, rew, v, vtp1))


def _k2_inputs(t, b, a, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, b, a)) * 2.0
    actions = rng.integers(0, a, (t, b))
    onehot = np.eye(a)[actions]
    pert = logits + rng.standard_normal((t, b, a)) * 0.3
    pert = pert - pert.max(-1, keepdims=True)
    logp = pert - np.log(np.exp(pert).sum(-1, keepdims=True))
    blogp = (logp * onehot).sum(-1)
    disc = np.where(rng.uniform(size=(t, b)) < 0.1, 0.0, 0.97)
    rew = rng.standard_normal((t, b))
    v = rng.standard_normal((t, b))
    vtp1 = np.concatenate([v[1:], np.zeros((1, b))], 0)
    return tuple(x.astype(np.float32)
                 for x in (logits, onehot, blogp, disc, rew, v, vtp1))


def _batch_inputs(b, t, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    log_rhos = rng.standard_normal((b, t)) * scale
    disc = np.where(rng.uniform(size=(b, t)) < 0.1, 0.0, 0.9)
    rew = rng.standard_normal((b, t))
    v = rng.standard_normal((b, t))
    boot = rng.standard_normal((b,))
    return tuple(x.astype(np.float32) for x in (log_rhos, disc, rew, v, boot))


# ---------------------------------------------------------------------------
# K1: the V-trace recurrence


@pytest.mark.parametrize("t,b", [(1, 1), (7, 3), (37, 130), (100, 8)])
def test_k1_plain_matches_pallas_interpret_and_ref(t, b):
    inp = _k1_inputs(t, b, seed=t * 1000 + b)
    want_p = j_kern.vtrace_pallas(*map(jnp.asarray, inp), t_chunk=16,
                                  interpret=True)
    want_r = j_ref.vtrace_ref(*map(jnp.asarray, inp))
    got = vk.vtrace_plain(*map(_t, inp))
    wrapped = vk.vtrace(*map(_t, inp))
    for wp, wr, g, w in zip(want_p, want_r, got, wrapped):
        _close(wp, g)
        _close(wr, g)
        torch.testing.assert_close(w, g, rtol=0, atol=0)


@pytest.mark.parametrize("rho_bar,c_bar,lambda_", [
    (1.0, 1.0, 1.0), (None, None, 1.0), (2.0, 1.0, 1.0), (1.0, 1.0, 0.9)])
def test_ops_vtrace_matches_jax(rho_bar, c_bar, lambda_):
    inp = _batch_inputs(4, 37, seed=5)
    kw = dict(rho_bar=rho_bar, c_bar=c_bar, lambda_=lambda_)
    with jax.disable_jit():     # small: eager beats compiling each case
        want = j_ops.vtrace(*map(jnp.asarray, inp), impl="ref", **kw)
    for impl in ("auto", "ref", "pallas"):
        got = ops.vtrace(*map(_t, inp), impl=impl, **kw)
        for w, g in zip(want, got):
            _close(w, g)


# ---------------------------------------------------------------------------
# K2: fused loss + V-trace


@pytest.mark.parametrize("t,b,a,chunk", [
    (1, 1, 2, 256), (8, 4, 6, 256), (64, 16, 128, 16),
    (300, 3, 9, 64), (37, 130, 5, 256),
    (20, 32, 3, 256), (10, 4, 18, 256), (16, 8, 130, 256),
])
def test_k2_plain_matches_pallas_interpret(t, b, a, chunk):
    inp = _k2_inputs(t, b, a, seed=t * 131 + b * 7 + a)
    want = j_kern.loss_vtrace_pallas(*map(jnp.asarray, inp), rho_bar=1.0,
                                     c_bar=1.0, lambda_=1.0, t_chunk=chunk,
                                     interpret=True)
    got = vk.loss_vtrace_plain(*map(_t, inp))
    wrapped = vk.loss_vtrace(*map(_t, inp))
    for name, w, g, k in zip(("tlp", "ne", "vs", "pg_adv"), want, got,
                             wrapped):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), err_msg=name,
                                   **TOL)
        torch.testing.assert_close(k, g, rtol=0, atol=0)


@pytest.mark.parametrize("rho_bar,c_bar,lambda_", [
    (None, None, 1.0), (2.0, 1.0, 1.0), (1.0, 1.0, 0.9),
])
def test_k2_plain_clip_variants(rho_bar, c_bar, lambda_):
    inp = _k2_inputs(40, 6, 7, seed=99)
    kw = dict(rho_bar=rho_bar, c_bar=c_bar, lambda_=lambda_)
    want = j_kern.loss_vtrace_pallas(*map(jnp.asarray, inp), t_chunk=16,
                                     interpret=True, **kw)
    got = vk.loss_vtrace_plain(*map(_t, inp), **kw)
    for name, w, g in zip(("tlp", "ne", "vs", "pg_adv"), want, got):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("rho_bar,c_bar,lambda_", [
    (1.0, 1.0, 1.0), (None, None, 1.0)])
def test_fused_autograd_function_gradient_matches_jax(rho_bar, c_bar,
                                                      lambda_):
    """d(total)/d(logits) of the assembled IMPALA total: the port's
    autograd.Function against JAX ``fused_loss_vtrace``'s custom_vjp."""
    inp = _k2_inputs(50, 8, 11, seed=7)
    clip = (rho_bar, c_bar, lambda_)

    def j_total(lg):
        tlp, ne, vs, pg = j_kern.fused_loss_vtrace(
            lg, *map(jnp.asarray, inp[1:]), *clip)
        return (-jnp.sum(jax.lax.stop_gradient(pg) * tlp)
                + 0.5 * jnp.sum(jnp.square(jax.lax.stop_gradient(vs)
                                           - inp[5]))
                + 0.01 * jnp.sum(ne))

    lj, gj = jax.value_and_grad(j_total)(jnp.asarray(inp[0]))
    lg = _t(inp[0]).requires_grad_()
    tlp, ne, vs, pg = vk.fused_loss_vtrace(lg, *map(_t, inp[1:]), *clip)
    assert not vs.requires_grad and not pg.requires_grad
    total = (-torch.sum(pg * tlp)
             + 0.5 * torch.sum(torch.square(vs - _t(inp[5])))
             + 0.01 * torch.sum(ne))
    total.backward()
    np.testing.assert_allclose(np.asarray(lj), total.item(), atol=1e-4,
                               rtol=1e-5)
    _close(gj, lg.grad)


# ---------------------------------------------------------------------------
# core.vtrace and corrections


@pytest.mark.parametrize("b,t", [(1, 1), (2, 7), (4, 30)])
def test_vtrace_scan_and_reference_match_jax(b, t):
    inp = _batch_inputs(b, t, seed=b * 100 + t)
    for fn_j, fn_t in ((j_vt.vtrace_scan, vt.vtrace_scan),
                       (j_vt.vtrace_reference, vt.vtrace_reference)):
        want = fn_j(*map(jnp.asarray, inp))
        got = fn_t(*map(_t, inp))
        _close(want.vs, got.vs)
        _close(want.pg_advantages, got.pg_advantages)
    for impl in ("scan", "reference", "pallas"):
        got = vt.vtrace(*map(_t, inp), impl=impl)
        _close(want.vs, got.vs)


def _loss_batch(b, t, a, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, a)).astype(np.float32)
    values = rng.standard_normal((b, t)).astype(np.float32)
    actions = rng.integers(0, a, (b, t)).astype(np.int32)
    pert = logits + rng.standard_normal((b, t, a)) * 0.2
    pert = pert - pert.max(-1, keepdims=True)
    logp = pert - np.log(np.exp(pert).sum(-1, keepdims=True))
    batch = {
        "actions": actions,
        "rewards": (rng.standard_normal((b, t)) * 2).astype(np.float32),
        "discounts": np.where(rng.uniform(size=(b, t)) < 0.1, 0.0,
                              0.99).astype(np.float32),
        "behaviour_logprob": np.take_along_axis(
            logp, actions[..., None], -1)[..., 0].astype(np.float32),
        "bootstrap_value": rng.standard_normal((b,)).astype(np.float32),
    }
    return logits, values, batch


@pytest.mark.parametrize("mode,q", [
    ("vtrace", "vtrace"), ("vtrace", "baseline_v"), ("onestep_is", "vtrace"),
    ("eps", "vtrace"), ("none", "vtrace")])
def test_correction_modes_match_jax(mode, q):
    logits, values, batch = _loss_batch(3, 12, 4, seed=11)
    kw = dict(correction=mode, pg_q_estimate=q)
    args = ("behaviour_logprob", "actions", "discounts", "rewards")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    want = j_corr.compute_correction(
        JaxImpalaConfig(**kw), jb[args[0]], jnp.asarray(logits),
        jb["actions"], jb["discounts"], jb["rewards"], jnp.asarray(values),
        jb["bootstrap_value"])
    got = corrections.compute_correction(
        ImpalaConfig(**kw), tb[args[0]], _t(logits), tb["actions"],
        tb["discounts"], tb["rewards"], _t(values), tb["bootstrap_value"])
    for w, g in zip(want, got):
        _close(w, g)


def test_nstep_returns_and_replay_baseline_mix_match_jax():
    _, disc, rew, v, boot = _batch_inputs(3, 9, seed=4)
    _close(j_corr.nstep_returns(*map(jnp.asarray, (disc, rew, v, boot))),
           corrections.nstep_returns(*map(_t, (disc, rew, v, boot))))
    target = v[::-1].copy()
    mask = np.array([True, False, True])
    _close(j_corr.replay_baseline_mix(jnp.asarray(v), jnp.asarray(target),
                                      jnp.asarray(mask)),
           corrections.replay_baseline_mix(_t(v), _t(target), _t(mask)))


@pytest.mark.parametrize("mode", ["abs_one", "soft_asymmetric", "none"])
def test_reward_clip_matches_jax(mode):
    r = np.linspace(-3, 3, 25).astype(np.float32)
    _close(j_losses.reward_clip(jnp.asarray(r), mode),
           losses.reward_clip(_t(r), mode))


# ---------------------------------------------------------------------------
# impala_loss, every impl, against JAX impl='scan'


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(correction):
    """JAX impl='scan' value, metrics and grads, once per correction."""
    b, t, a = 6, 20, 5
    logits, values, batch = _loss_batch(b, t, a, seed=3)
    cfg = JaxImpalaConfig(num_actions=a, unroll_length=t,
                          correction=correction)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(lg, vv):
        return j_losses.impala_loss(cfg, lg, vv, jb, impl="scan")

    (total, metrics), grads = jax.value_and_grad(f, argnums=(0, 1),
                                                 has_aux=True)(
        jnp.asarray(logits), jnp.asarray(values))
    return total, metrics, grads


@pytest.mark.parametrize("impl", ["auto", "fused", "pallas", "scan",
                                  "reference"])
@pytest.mark.parametrize("correction", ["vtrace", "onestep_is"])
def test_impala_loss_every_impl_matches_jax_scan(impl, correction):
    b, t, a = 6, 20, 5
    logits, values, batch = _loss_batch(b, t, a, seed=3)
    kw = dict(num_actions=a, unroll_length=t, correction=correction)
    total_j, metrics_j, (gl_j, gv_j) = _jax_loss_and_grads(correction)
    lg = _t(logits).requires_grad_()
    vv = _t(values).requires_grad_()
    total, metrics = losses.impala_loss(
        ImpalaConfig(**kw), lg, vv, {k: _t(v) for k, v in batch.items()},
        impl=impl)
    total.backward()
    np.testing.assert_allclose(np.asarray(total_j), total.item(),
                               atol=1e-4, rtol=1e-5)
    for k in metrics_j:
        np.testing.assert_allclose(np.asarray(metrics_j[k]),
                                   metrics[k].item(), atol=1e-4, rtol=1e-5,
                                   err_msg=k)
    _close(gl_j, lg.grad)
    _close(gv_j, vv.grad, atol=1e-4, rtol=1e-5)


def test_impl_auto_resolves_from_the_device():
    cpu = torch.device("cpu")
    assert losses.resolve_vtrace_impl("auto", cpu) == "scan"
    assert losses.resolve_vtrace_impl("auto", torch.device("cuda")) == \
        "fused"
    for explicit in ("fused", "pallas", "scan", "reference"):
        assert losses.resolve_vtrace_impl(explicit, cpu) == explicit
