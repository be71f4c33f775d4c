"""The port's attention kernels' plain versions and attention layers
against the JAX package.

* K4's plain version (``flash_attention_plain``) against
  ``flash_attention_pallas`` in interpret mode and ``ref``'s oracle, over
  GQA groups, causal or not, windows, a ragged T and S != T.
* K5's plain version against ``decode_attention_pallas`` in interpret mode
  (a small ``s_chunk``, so S is ragged against it) with the decode path's
  masked biases.
* ``rmsnorm``, ``layernorm``, ``rope``, ``apply_mlp`` and
  ``apply_attention`` (prefill and decode, with and without a window).

Inputs and weights are drawn with numpy from seeds and handed to both
packages. Tolerances: float32 at 1e-5 (sums of a few dozen terms in
another order); bf16 at the bf16 tolerance stated beside each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.kernels import ref as j_ref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import mlp as j_mlp

from repro_torch import params as P
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.models import attention, common, mlp

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().to(torch.float32).numpy(),
                               **(tol or TOL))


def spec_params(specs, seed):
    """numpy leaves at each JAX Spec's shape: kernels at the JAX init's
    std, norm scales near 1, biases and tables small and nonzero (so a
    wrong layout of any leaf shows)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        z = rng.standard_normal(spec.shape)
        if spec.init == "normal":
            fan_in = int(np.prod(spec.shape[:-1])) \
                if len(spec.shape) > 1 else spec.shape[0]
            z = z * spec.scale / np.sqrt(fan_in)
        elif spec.init == "ones":
            z = 1.0 + 0.1 * z
        elif spec.init == "embed":
            z = z * spec.scale
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree.map(draw, specs,
                        is_leaf=lambda x: isinstance(x, j_common.Spec))


def _cfgs(dtype="float32", **kw):
    return (j_smoke("mistral-nemo-12b").replace(dtype=dtype, **kw),
            get_smoke_config("mistral-nemo-12b").replace(dtype=dtype, **kw))


# ---------------------------------------------------------------------------
# K4: flash attention


@pytest.mark.parametrize("b,t,s,h,kh,d,causal,window", [
    (1, 40, 40, 4, 2, 16, True, 0),       # G = 2, two kv blocks
    (2, 37, 37, 4, 1, 16, True, 0),       # G = 4, ragged T
    (1, 30, 45, 2, 2, 16, True, 0),       # G = 1, S > T
    (1, 45, 30, 4, 2, 16, True, 0),       # S < T
    (1, 33, 33, 4, 4, 16, False, 0),      # non-causal
    (1, 50, 50, 4, 2, 16, True, 12),      # window
    (1, 40, 40, 4, 2, 8, False, 10),      # window, non-causal
])
def test_k4_plain_matches_pallas_interpret_and_ref(b, t, s, h, kh, d, causal,
                                                   window):
    seed = b * 1000 + t * 10 + s
    q = _normal((b, t, h, d), seed)
    k = _normal((b, s, kh, d), seed + 1)
    v = _normal((b, s, kh, d), seed + 2)
    want_p = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, q_block=16, kv_block=16,
                                    interpret=True)
    want_r = j_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, window)
    got = fk.flash_attention_plain(_t(q), _t(k), _t(v), causal, window)
    _close(want_p, got)
    _close(want_r, got)
    for impl in ("auto", "ref", "pallas"):
        torch.testing.assert_close(
            ops.flash_attention(_t(q), _t(k), _t(v), causal, window,
                                impl=impl), got, rtol=0, atol=0)


def test_k4_plain_bf16_matches_ref():
    """bf16 inputs, f32 softmax, one rounding to bf16 at the end in both:
    at most one bf16 ulp apart (2^-7 relative, plus the f32 slack near
    zero)."""
    q, k, v = (_normal(sh, 7 + i) for i, sh in enumerate(
        [(2, 24, 4, 32), (2, 24, 2, 32), (2, 24, 2, 32)]))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = j_ref.flash_attention_ref(*jb, True, 0)
    tb = [_t(x).to(torch.bfloat16) for x in (q, k, v)]
    got = fk.flash_attention_plain(*tb, True, 0)
    assert got.dtype == torch.bfloat16
    _close(np.asarray(want, np.float32), got, atol=1e-5, rtol=2 ** -7)


# ---------------------------------------------------------------------------
# K5: decode attention


@pytest.mark.parametrize("b,h,kh,s,d,index,window", [
    (2, 8, 2, 100, 16, 99, 0),           # all valid, ragged S vs s_chunk
    (2, 8, 2, 100, 16, 40, 0),           # masked suffix: cache with room
    (1, 4, 4, 64, 32, 150, 32),          # ring buffer: masked prefix
    (3, 6, 3, 70, 16, 50, 24),           # ring not full: both ends masked
    (2, 8, 1, 33, 16, 500, 0),           # G = 8
])
def test_k5_plain_matches_pallas_interpret_and_ref(b, h, kh, s, d, index,
                                                   window):
    seed = b * 100 + s
    q = _normal((b, h, d), seed)
    k = _normal((b, s, kh, d), seed + 1)
    v = _normal((b, s, kh, d), seed + 2)
    bias = attention.decode_bias(index, s, window, b, "cpu")
    assert 0 < int((bias[0] == 0).sum()) <= s
    jargs = [jnp.asarray(x) for x in (q, k, v, bias.numpy())]
    want_p = decode_attention_pallas(*jargs, s_chunk=32, interpret=True)
    want_r = j_ref.decode_attention_ref(*jargs)
    got = dk.decode_attention_plain(_t(q), _t(k), _t(v), bias)
    _close(want_p, got, atol=2e-5, rtol=2e-5)
    _close(want_r, got)
    for impl in ("auto", "ref", "pallas"):
        torch.testing.assert_close(
            ops.decode_attention(_t(q), _t(k), _t(v), bias, impl=impl), got,
            rtol=0, atol=0)


@pytest.mark.parametrize("index,window,s", [(5, 0, 12), (30, 0, 12),
                                            (30, 8, 8), (30, 6, 10),
                                            (3, 6, 10)])
def test_decode_bias_is_the_jax_valid_mask(index, window, s):
    """The bias marks exactly the slots ``apply_attention``'s decode mask
    keeps (``attention.py``'s ``valid``)."""
    slots = np.arange(s)
    if window:
        kv_pos = index - ((index - slots) % s)
        valid = kv_pos >= max(index - s + 1, 0)
        valid &= kv_pos > index - window
    else:
        valid = slots <= index
    bias = attention.decode_bias(index, s, window, 3, "cpu")
    assert bias.shape == (3, s) and bias.dtype == torch.float32
    np.testing.assert_array_equal(bias.numpy(),
                                  np.where(valid, 0.0, -1e30)[None]
                                  .repeat(3, 0).astype(np.float32))


# ---------------------------------------------------------------------------
# norms, RoPE, MLP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    x = _normal((2, 5, 64), 1, 3.0)
    p = {"scale": _normal((64,), 2) + 1.0, "bias": _normal((64,), 3)}
    jx = jnp.asarray(x, dtype)
    tx = _t(x).to(common.torch_dtype(dtype))
    tp = {k: _t(v) for k, v in p.items()}
    tol = TOL if dtype == "float32" else dict(atol=1e-5, rtol=2 ** -7)
    _close(j_common.rmsnorm(p, jx), common.rmsnorm(tp, tx), **tol)
    _close(j_common.layernorm(p, jx), common.layernorm(tp, tx), **tol)
    assert common.rmsnorm(tp, tx).dtype == tx.dtype


def test_rope_matches_jax():
    x = _normal((2, 7, 3, 32), 4)
    pos = np.arange(7)[None].repeat(2, 0) + np.array([[0], [5]])
    for theta in (1e4, 1e6):
        _close(j_common.rope(jnp.asarray(x), jnp.asarray(pos), theta),
               common.rope(_t(x), torch.from_numpy(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "silu"])
def test_apply_mlp_matches_jax(act):
    j_cfg, t_cfg = _cfgs(activation=act)
    p = spec_params(j_mlp.mlp_specs(j_cfg), 5)
    x = _normal((2, 6, j_cfg.d_model), 6)
    want = j_mlp.apply_mlp(p, jnp.asarray(x), j_cfg)
    got = mlp.apply_mlp(P.from_jax(p, requires_grad=False), _t(x), t_cfg)
    _close(want, got)


# ---------------------------------------------------------------------------
# apply_attention


@pytest.mark.parametrize("window", [0, 5])
def test_apply_attention_prefill_matches_jax(window):
    j_cfg, t_cfg = _cfgs()
    p = spec_params(j_attn.attention_specs(j_cfg), 7)
    b, t = 2, 11
    x = _normal((b, t, j_cfg.d_model), 8)
    pos = np.arange(t)[None].repeat(b, 0)
    want, want_c = j_attn.apply_attention(
        p, jnp.asarray(x), jnp.asarray(pos), j_cfg, window=window,
        mode="prefill")
    got, got_c = attention.apply_attention(
        P.from_jax(p, requires_grad=False), _t(x), torch.from_numpy(pos),
        t_cfg, window=window, mode="prefill")
    _close(want, got)
    for name in ("k", "v"):
        _close(want_c[name], got_c[name])


@pytest.mark.parametrize("window,s_cache,index", [
    (0, 16, 9),          # a cache with room: the slots past 9 are masked
    (0, 8, 13),          # past the end: min(index, S-1), all valid
    (8, 8, 13),          # ring buffer, full
    (6, 10, 4),          # ring buffer not yet full
])
def test_apply_attention_decode_matches_jax(window, s_cache, index):
    j_cfg, t_cfg = _cfgs()
    p = spec_params(j_attn.attention_specs(j_cfg), 9)
    b, kh, dh = 2, j_cfg.num_kv_heads, j_cfg.resolved_head_dim
    x = _normal((b, 1, j_cfg.d_model), 10)
    cache = {"k": _normal((b, s_cache, kh, dh), 11),
             "v": _normal((b, s_cache, kh, dh), 12)}
    pos = np.full((b, 1), index)
    want, want_c = j_attn.apply_attention(
        p, jnp.asarray(x), jnp.asarray(pos), j_cfg, window=window,
        mode="decode", cache={k: jnp.asarray(v) for k, v in cache.items()},
        cache_index=jnp.int32(index))
    t_cache = {k: _t(v) for k, v in cache.items()}
    got, got_c = attention.apply_attention(
        P.from_jax(p, requires_grad=False), _t(x), torch.from_numpy(pos),
        t_cfg, window=window, mode="decode", cache=t_cache,
        cache_index=index)
    _close(want, got)
    assert got_c is t_cache          # written in place
    for name in ("k", "v"):
        _close(want_c[name], got_c[name])


def test_apply_attention_prefill_bf16_matches_jax():
    """The working dtype. JAX's dense path rounds the scores and the
    probabilities to bf16 before the value product (``attention.py``'s
    ``_dense_attention``); K4's plain version keeps them in f32 and rounds
    once at the end. Outputs of the o projection (~0.3) then differ by a
    few bf16 ulps: held to 2e-2 absolute."""
    j_cfg, t_cfg = _cfgs("bfloat16")
    p = spec_params(j_attn.attention_specs(j_cfg), 13)
    b, t = 2, 9
    x = _normal((b, t, j_cfg.d_model), 14)
    pos = np.arange(t)[None].repeat(b, 0)
    want, _ = j_attn.apply_attention(
        p, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), j_cfg,
        mode="prefill")
    got, _ = attention.apply_attention(
        P.from_jax(p, requires_grad=False), _t(x).to(torch.bfloat16),
        torch.from_numpy(pos), t_cfg, mode="prefill")
    assert got.dtype == torch.bfloat16
    _close(np.asarray(want, np.float32), got, atol=2e-2, rtol=0)
