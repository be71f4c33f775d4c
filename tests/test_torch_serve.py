"""The port's token serving path against the JAX package: the weights
bridge on stacked token trees, ``apply_stack``, ``apply_prefill`` and
``apply_decode`` (logits, values and caches), decode through a cache with
room against prefill, and the ``serve`` CLI end to end on the CPU.

Weights are drawn with numpy at the JAX spec tree's shapes and carried to
the port by ``from_jax``; tokens come from numpy seeds. The smoke config
of mistral-nemo-12b (2 layers, d_model 128, 4 heads over 2 kv heads)
runs with ``dtype="float32"`` at 1e-5 for the algorithm; the bf16 case
states its own tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import backbone as j_bb
from repro.models import common as j_common
from repro.models import transformer as j_tfm

from repro_torch import params as P
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.launch import serve as serve_lib
from repro_torch.models import backbone as bb
from repro_torch.models import common, transformer

from test_torch_attention import spec_params

torch.set_num_threads(1)

A = 18
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().to(torch.float32).numpy(),
                               **(tol or TOL))


def _close_tree(want, got, **tol):
    w, g = P.flatten(want), P.flatten(got)
    assert sorted(w) == sorted(g)
    for key in w:
        _close(w[key], g[key], **tol)


def _cfgs(dtype="float32", **kw):
    return (j_smoke("mistral-nemo-12b").replace(dtype=dtype, **kw),
            get_smoke_config("mistral-nemo-12b").replace(dtype=dtype, **kw))


def _setup(seed=0, dtype="float32", **kw):
    j_cfg, t_cfg = _cfgs(dtype, **kw)
    p = spec_params(j_bb.backbone_specs(j_cfg, A), seed)
    return j_cfg, t_cfg, p, P.from_jax(p, requires_grad=False)


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


# ---------------------------------------------------------------------------
# the weights bridge on a stacked token tree


def test_from_jax_keeps_stacked_4d_dense_kernels():
    """``stack/scan/l0/attn/q/kernel`` is (layers, d, H, Dh): 4-D like a
    conv kernel, but dense. It crosses both ways with every shape and
    value kept."""
    j_cfg, _ = _cfgs()
    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_cfg, A), jax.random.key(0)))
    flat = P.flatten(tree)
    assert flat["stack/scan/l0/attn/q/kernel"].shape == (2, 128, 4, 32)
    assert flat["stack/scan/l0/attn/o/kernel"].shape == (2, 4, 32, 128)
    port = P.from_jax(tree, requires_grad=False)
    for key, t in P.flatten(port).items():
        assert tuple(t.shape) == flat[key].shape, key
        np.testing.assert_array_equal(t.numpy(), flat[key])
    back = P.flatten(P.to_jax(port))
    for key, x in flat.items():
        np.testing.assert_array_equal(back[key], x)


def test_token_specs_match_jax():
    j_cfg, t_cfg = _cfgs()
    j_specs = j_bb.backbone_specs(j_cfg, A)
    t_specs = bb.backbone_specs(t_cfg, A)
    assert {k: s.shape for k, s in P.flatten(t_specs).items()} == \
        {k: s.shape for k, s in P.flatten(j_specs).items()}
    assert {k: (s.init, s.scale) for k, s in P.flatten(t_specs).items()} \
        == {k: (s.init, s.scale) for k, s in P.flatten(j_specs).items()}
    assert common.param_count(t_specs) == j_common.param_count(j_specs)
    assert transformer.layer_plan(t_cfg) == j_tfm.layer_plan(j_cfg)


# ---------------------------------------------------------------------------
# the stack, prefill and decode against JAX


@pytest.mark.parametrize("window", [0, 4])
def test_apply_stack_prefill_matches_jax(window):
    j_cfg, t_cfg, jp, tp = _setup(1, sliding_window=window)
    b, t = 2, 10
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, t, j_cfg.d_model)).astype(np.float32)
    pos = np.arange(t)[None].repeat(b, 0)
    want, want_c, want_aux = j_tfm.apply_stack(jp["stack"], jnp.asarray(x),
                                               jnp.asarray(pos), j_cfg,
                                               mode="prefill")
    got, got_c, got_aux = transformer.apply_stack(
        tp["stack"], torch.from_numpy(x), torch.from_numpy(pos), t_cfg,
        mode="prefill")
    assert float(got_aux) == float(want_aux) == 0.0     # no MoE layer
    _close(want, got)
    _close_tree(want_c, got_c)


@pytest.mark.parametrize("window", [0, 4])
def test_apply_prefill_then_decode_match_jax(window):
    """Prefill a context, then decode two steps through the prefill's own
    cache (exactly T slots: the second step overwrites the last slot, the
    reference's ``min(index, S-1)`` rule), as the server does."""
    j_cfg, t_cfg, jp, tp = _setup(3, sliding_window=window)
    b, t = 2, 8
    toks = _tokens(b, t, j_cfg.vocab_size, 4)
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    _close(want.policy_logits, got.policy_logits)
    _close(want.values, got.values)
    _close_tree(want.cache, got.cache)
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(b, 2, j_cfg.vocab_size, 5)
    for i in range(2):
        tok = step_toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(t + i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, t + i,
                              t_cfg, A)
        j_cache, t_cache = want.cache, got.cache
        _close(want.policy_logits, got.policy_logits)
        _close(want.values, got.values)
        _close_tree(j_cache, t_cache)


def test_decode_from_cache_init_matches_jax():
    j_cfg, t_cfg, jp, tp = _setup(6)
    b, steps, room = 2, 4, 6
    j_cache = j_bb.cache_init(b, room, j_cfg)
    t_cache = bb.cache_init(b, room, t_cfg)
    _close_tree(j_cache, t_cache)
    toks = _tokens(b, steps, j_cfg.vocab_size, 7)
    for i in range(steps):
        tok = toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, i, t_cfg,
                              A)
        j_cache = want.cache
        assert got.cache is t_cache      # written in place
        _close(want.policy_logits, got.policy_logits)
    _close_tree(j_cache, t_cache)


def test_prefill_and_decode_bf16_match_jax():
    """bf16, the working dtype: JAX's dense attention rounds scores and
    probabilities to bf16, the port's keeps them in f32 and rounds once,
    and two layers of bf16 matmuls carry the difference. The logits
    (~0.03) are held to 1e-3 absolute, 3% of their scale."""
    j_cfg, t_cfg, jp, tp = _setup(8, "bfloat16")
    toks = _tokens(2, 8, j_cfg.vocab_size, 9)
    want = j_bb.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, j_cfg, A)
    got = bb.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, t_cfg, A)
    assert got.policy_logits.dtype == torch.float32
    _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)
    tok = toks[:, -1:]
    want = j_bb.apply_decode(jp, jnp.asarray(tok), want.cache, jnp.int32(8),
                             j_cfg, A)
    got = bb.apply_decode(tp, torch.from_numpy(tok), got.cache, 8, t_cfg, A)
    _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)


@pytest.mark.parametrize("window", [0, 3])
def test_decode_through_a_cache_with_room_matches_prefill(window):
    """Decoding from index 0 through ``cache_init`` with room gives, at
    every step, the last-position logits of ``apply_prefill`` on that
    prefix (under a window, the cache is a ring buffer of ``window``
    slots)."""
    _, t_cfg, _, tp = _setup(10, sliding_window=window)
    b, t = 2, 7
    toks = torch.from_numpy(_tokens(b, t, t_cfg.vocab_size, 11))
    cache = bb.cache_init(b, t + 2, t_cfg)
    slots = cache["scan"]["l0"]["kv"]["k"].shape[2]
    assert slots == (min(window, t + 2) if window else t + 2)
    for i in range(t):
        step = bb.apply_decode(tp, toks[:, i:i + 1], cache, i, t_cfg, A)
        full = bb.apply_prefill(tp, {"tokens": toks[:, :i + 1]}, t_cfg, A)
        torch.testing.assert_close(step.policy_logits, full.policy_logits,
                                   **TOL)
        torch.testing.assert_close(step.values, full.values, **TOL)


def test_cache_abstract_is_meta_and_matches_jax_shapes():
    j_cfg, t_cfg = _cfgs("bfloat16", sliding_window=5)
    want = j_bb.cache_abstract(3, 9, j_cfg)
    got = bb.cache_abstract(3, 9, t_cfg)
    w, g = P.flatten(want), P.flatten(got)
    assert sorted(w) == sorted(g)
    for key in w:
        assert g[key].device.type == "meta"
        assert tuple(g[key].shape) == w[key].shape
        assert g[key].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the serve CLI


def test_serve_smoke_on_cpu_runs_end_to_end():
    fk.reset_launch_counts()
    dk.reset_launch_counts()
    run = serve_lib.serve(["--device", "cpu", "--smoke", "--requests", "5",
                           "--batch", "2", "--ctx", "8", "--decode-steps",
                           "3"])
    assert (run.served, run.batches, run.decode_steps) == (5, 3, 3)
    assert len(run.prefill_ms) == 3 and len(run.decode_ms) == 9
    assert run.actions_per_s > 0
    fb = run.first_batch
    assert tuple(fb["tokens"].shape) == (2, 8)
    assert len(fb["actions"]) == 3 and len(fb["logits"]) == 4
    for lg in fb["logits"]:
        assert lg.shape == (2, 1, A) and bool(torch.isfinite(lg).all())
    for a in fb["actions"]:
        assert a.shape == (2, 1) and 0 <= int(a.min()) <= int(a.max()) < A
    # the CPU took the plain versions: no kernel launched
    assert fk.flash_attention.launches == 0
    assert dk.decode_attention.launches == 0
