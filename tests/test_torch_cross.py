"""The port's cross-attention and enc-dec backbones, llama-3.2-vision-11b
(a cross-attention layer every 5th) and whisper-small (a bidirectional
encoder, then self- and cross-attention in each decoder layer), against
the JAX package: their config modules and specs (the published widths'
parameter counts included), ``apply_attention(kv_x=)``,
``precompute_cross_cache`` and ``apply_cross_attention_cached``, the
``enc`` block and ``apply_encoder``, the smoke slices' ``apply_prefill``
then four ``apply_decode`` steps with stub embeddings, ``apply_decode
(batch=)`` with and without the cached encoder keys, the decode caches
of every new block kind, and the weights bridge on the encoder's tree.

Weights are drawn with numpy at the JAX spec tree's shapes and carried to
the port by ``from_jax``; tokens and the stub frontends' embeddings come
from numpy seeds. The JAX model functions reach no Pallas kernel (their
attention is the dense path), so they are called directly. Tolerances:
float32 at 1e-5; bf16 at the tolerance ``test_torch_serve.py`` states
for it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import attention as j_attn
from repro.models import backbone as j_bb
from repro.models import common as j_common
from repro.models import transformer as j_tfm

from repro_torch import params as P
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import backbone as bb
from repro_torch.models import common, transformer

from test_torch_attention import spec_params

torch.set_num_threads(1)

A = 18
TOL = dict(atol=1e-5, rtol=1e-5)
VLM, AUDIO = "llama-3.2-vision-11b", "whisper-small"
ARCHS = [VLM, AUDIO]
CTX_KEY = {VLM: "image_embed", AUDIO: "enc_embed"}
PLANS = {VLM: (["attn"] * 4 + ["cross"], []), AUDIO: (["enc_dec"], [])}
# the published widths' parameter counts with 18 actions (f32)
FULL_PARAMS = {VLM: 9_249_898_515, AUDIO: 238_204_435}


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().to(torch.float32).numpy(),
                               **(tol or TOL))


def _close_tree(want, got, **tol):
    w, g = P.flatten(want), P.flatten(got)
    assert sorted(w) == sorted(g)
    for key in w:
        _close(w[key], g[key], **tol)


def _cfgs(arch, dtype="float32"):
    return (j_smoke(arch).replace(dtype=dtype),
            get_smoke_config(arch).replace(dtype=dtype))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _spec_table(specs):
    return {k: (tuple(s.shape), s.init, s.scale)
            for k, s in P.flatten(specs).items()}


def _setup(arch, seed, dtype="float32"):
    j_cfg, t_cfg = _cfgs(arch, dtype)
    p = spec_params(j_bb.backbone_specs(j_cfg, A), seed)
    return j_cfg, t_cfg, p, P.from_jax(p, requires_grad=False)


def _batches(arch, j_cfg, b, t, seed):
    """The JAX and the port's prefill batch: tokens and the stub
    frontend's embeddings (B, encoder_seq_len, d)."""
    toks = _tokens(b, t, j_cfg.vocab_size, seed)
    emb = _normal((b, j_cfg.encoder_seq_len, j_cfg.d_model), seed + 1)
    key = CTX_KEY[arch]
    return ({"tokens": jnp.asarray(toks), key: jnp.asarray(emb)},
            {"tokens": torch.from_numpy(toks), key: torch.from_numpy(emb)})


# ---------------------------------------------------------------------------
# configs, specs and the weights bridge


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_jax_modules(arch):
    for j_cfg, t_cfg in ((j_get_config(arch), get_config(arch)),
                         (j_smoke(arch), get_smoke_config(arch))):
        for field in t_cfg.__dataclass_fields__:
            assert getattr(t_cfg, field) == getattr(j_cfg, field), field
    assert get_config(arch).source == j_get_config(arch).source != ""


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_at_smoke_and_published_widths(arch):
    for j_cfg, t_cfg in ((j_smoke(arch), get_smoke_config(arch)),
                         (j_get_config(arch), get_config(arch))):
        j_specs = j_bb.backbone_specs(j_cfg, A)
        t_specs = bb.backbone_specs(t_cfg, A)
        assert _spec_table(t_specs) == _spec_table(j_specs)
        assert common.param_count(t_specs) == j_common.param_count(j_specs)
        assert transformer.layer_plan(t_cfg) == j_tfm.layer_plan(j_cfg) == \
            PLANS[arch]
    assert common.param_count(bb.backbone_specs(get_config(arch), A)) == \
        FULL_PARAMS[arch]


def test_bridge_round_trips_the_encoder_tree():
    """whisper's ``encoder/scan/...`` leaves (stacked 4-D q/k/v/o kernels,
    LayerNorm scales and biases, qkv biases) cross to the port and back
    with every shape and value kept."""
    j_cfg = j_smoke(AUDIO)
    tree = jax.device_get(j_common.init_params(
        j_bb.backbone_specs(j_cfg, A), jax.random.key(2)))
    flat = P.flatten(tree)
    enc = [k for k in flat if k.startswith("encoder/scan/")]
    h, dh = j_cfg.num_heads, j_cfg.resolved_head_dim
    assert flat["encoder/scan/attn/q/kernel"].shape == \
        (j_cfg.encoder_layers, j_cfg.d_model, h, dh)
    assert "encoder/scan/norm1/bias" in enc and \
        "encoder/scan/attn/k/bias" in enc
    port = P.from_jax(tree, requires_grad=False)
    for key, t in P.flatten(port).items():
        assert tuple(t.shape) == flat[key].shape, key
        np.testing.assert_array_equal(t.numpy(), flat[key])
    back = P.flatten(P.to_jax(port))
    assert sorted(back) == sorted(flat)
    for key, x in flat.items():
        np.testing.assert_array_equal(back[key], x)


# ---------------------------------------------------------------------------
# cross-attention and the encoder


def _attn_params(j_cfg, seed):
    p = spec_params(j_attn.attention_specs(j_cfg, cross=True), seed)
    return p, P.from_jax(p, requires_grad=False)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_jax(arch, mode):
    """q from x, keys and values from kv_x (S = 13 against T = 5, or one
    decode step), no RoPE on q, no mask; the port's cache is
    ``precompute_cross_cache``'s keys and values."""
    j_cfg, t_cfg = _cfgs(arch)
    jp, tp = _attn_params(j_cfg, 0)
    b, t, s = 2, (5 if mode == "prefill" else 1), 13
    x = _normal((b, t, j_cfg.d_model), 1)
    kv_x = _normal((b, s, j_cfg.d_model), 2)
    pos = np.arange(t)[None].repeat(b, 0) + (7 if mode == "decode" else 0)
    want, _ = j_attn.apply_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                     j_cfg, kv_x=jnp.asarray(kv_x),
                                     mode=mode)
    got, cache = attn.apply_attention(tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), t_cfg,
                                      kv_x=torch.from_numpy(kv_x), mode=mode)
    _close(want, got)
    j_cache = j_attn.precompute_cross_cache(jp, jnp.asarray(kv_x), j_cfg)
    _close_tree(j_cache, cache)
    _close_tree(j_cache, attn.precompute_cross_cache(
        tp, torch.from_numpy(kv_x), t_cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_cross_attention_matches_jax(arch):
    j_cfg, t_cfg = _cfgs(arch)
    jp, tp = _attn_params(j_cfg, 3)
    b, s = 3, 17
    x = _normal((b, 1, j_cfg.d_model), 4)
    enc = _normal((b, s, j_cfg.d_model), 5)
    j_cache = j_attn.precompute_cross_cache(jp, jnp.asarray(enc), j_cfg)
    t_cache = attn.precompute_cross_cache(tp, torch.from_numpy(enc), t_cfg)
    want = j_attn.apply_cross_attention_cached(jp, jnp.asarray(x), j_cache,
                                               j_cfg)
    got = attn.apply_cross_attention_cached(tp, torch.from_numpy(x),
                                            t_cache, t_cfg)
    assert got.shape == (b, 1, j_cfg.d_model)
    _close(want, got)
    with pytest.raises(ValueError, match="one step"):
        attn.apply_cross_attention_cached(
            tp, torch.from_numpy(_normal((b, 2, j_cfg.d_model), 6)),
            t_cache, t_cfg)


def test_attention_specs_take_and_ignore_cross():
    cfg = get_smoke_config(VLM)
    assert _spec_table(attn.attention_specs(cfg, cross=True)) == \
        _spec_table(attn.attention_specs(cfg))


def _enc_params(j_cfg, seed):
    p = spec_params(j_tfm.encoder_specs(j_cfg), seed)
    return p, P.from_jax(p, requires_grad=False)


def test_enc_block_matches_jax():
    """The bidirectional ``enc`` block over a whole sequence (RoPE, LayerNorm,
    GELU, qkv bias): JAX runs it in its train mode, the port in prefill."""
    j_cfg, t_cfg = _cfgs(AUDIO)
    jp, tp = _enc_params(j_cfg, 7)
    jp0 = jax.tree.map(lambda a: a[0], jp["scan"])
    tp0 = P.tree_map(lambda a: a[0], tp["scan"])
    b, t = 2, 9
    x = _normal((b, t, j_cfg.d_model), 8)
    pos = np.arange(t)[None].repeat(b, 0)
    want, _, want_aux = j_tfm.apply_block(jp0, jnp.asarray(x),
                                          jnp.asarray(pos), j_cfg, "enc",
                                          mode="train", cache=None,
                                          cross_ctx=None)
    got, _, aux = transformer.apply_block(tp0, torch.from_numpy(x),
                                          torch.from_numpy(pos), t_cfg,
                                          "enc", mode="prefill", cache=None)
    _close(want, got)
    assert aux is None and float(want_aux) == 0.0


def test_apply_encoder_matches_jax():
    j_cfg, t_cfg = _cfgs(AUDIO)
    jp, tp = _enc_params(j_cfg, 9)
    emb = _normal((2, j_cfg.encoder_seq_len, j_cfg.d_model), 10)
    want = j_tfm.apply_encoder(jp, jnp.asarray(emb), j_cfg)
    got = transformer.apply_encoder(tp, torch.from_numpy(emb), t_cfg)
    _close(want, got)


# ---------------------------------------------------------------------------
# prefill and decode against JAX


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax_f32(arch):
    """Prefill a context of 8 with the stub embeddings, then decode 4
    steps through the prefill's own cache (its ``cross_kv`` included); the
    aux loss is 0, as JAX's."""
    j_cfg, t_cfg, jp, tp = _setup(arch, 11)
    b, t = 2, 8
    j_batch, t_batch = _batches(arch, j_cfg, b, t, 12)
    want = j_bb.apply_prefill(jp, j_batch, j_cfg, A)
    got = bb.apply_prefill(tp, t_batch, t_cfg, A)
    _close(want.policy_logits, got.policy_logits)
    _close(want.values, got.values)
    assert float(got.aux_loss) == float(want.aux_loss) == 0.0
    _close_tree(want.cache, got.cache)
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(b, 4, j_cfg.vocab_size, 13)
    for i in range(4):
        tok = step_toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(t + i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, t + i,
                              t_cfg, A)
        j_cache = want.cache
        assert got.cache is t_cache          # written in place
        _close(want.policy_logits, got.policy_logits)
        _close(want.values, got.values)
        _close_tree(j_cache, t_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax_bf16(arch):
    """bf16, the working dtype, at ``test_torch_serve.py``'s tolerance:
    the logits (~0.03) held to 1e-3 absolute."""
    j_cfg, t_cfg, jp, tp = _setup(arch, 14, "bfloat16")
    j_batch, t_batch = _batches(arch, j_cfg, 2, 8, 15)
    want = j_bb.apply_prefill(jp, j_batch, j_cfg, A)
    got = bb.apply_prefill(tp, t_batch, t_cfg, A)
    assert got.policy_logits.dtype == torch.float32
    _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)
    j_cache, t_cache = want.cache, got.cache
    step_toks = _tokens(2, 4, j_cfg.vocab_size, 16)
    for i in range(4):
        tok = step_toks[:, i:i + 1]
        want = j_bb.apply_decode(jp, jnp.asarray(tok), j_cache,
                                 jnp.int32(8 + i), j_cfg, A)
        got = bb.apply_decode(tp, torch.from_numpy(tok), t_cache, 8 + i,
                              t_cfg, A)
        j_cache, t_cache = want.cache, got.cache
        _close(want.policy_logits, got.policy_logits, atol=1e-3, rtol=0)


def _drop_cross_kv(cache):
    """The cache with every ``cross_kv`` taken out (a decode cache of the
    self-attention only)."""
    if isinstance(cache, dict):
        return {k: _drop_cross_kv(v) for k, v in cache.items()
                if k != "cross_kv"}
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_with_batch_follows_the_jax_rule(arch):
    """``apply_decode(batch=)``: where the cache lacks ``cross_kv`` the step
    attends to the context computed afresh from the batch (the encoder
    run again for audio), as JAX's; where the cache holds it, the cache
    wins and the batch is not read (other embeddings change nothing)."""
    j_cfg, t_cfg, jp, tp = _setup(arch, 17)
    b, t = 2, 6
    j_batch, t_batch = _batches(arch, j_cfg, b, t, 18)
    j_pre = j_bb.apply_prefill(jp, j_batch, j_cfg, A)
    t_pre = bb.apply_prefill(tp, t_batch, t_cfg, A)
    tok = _tokens(b, 1, j_cfg.vocab_size, 19)
    want = j_bb.apply_decode(jp, jnp.asarray(tok),
                             _drop_cross_kv(j_pre.cache), jnp.int32(t),
                             j_cfg, A, batch=j_batch)
    got = bb.apply_decode(tp, torch.from_numpy(tok),
                          _drop_cross_kv(t_pre.cache), t, t_cfg, A,
                          batch=t_batch)
    _close(want.policy_logits, got.policy_logits)
    _close(want.values, got.values)
    # the cached cross_kv wins: other embeddings give the same step
    key = CTX_KEY[arch]
    other = dict(t_batch, **{key: t_batch[key] + 1.0})
    cache = P.tree_map(torch.clone, t_pre.cache)
    plain = bb.apply_decode(tp, torch.from_numpy(tok), t_pre.cache, t,
                            t_cfg, A)
    with_batch = bb.apply_decode(tp, torch.from_numpy(tok), cache, t,
                                 t_cfg, A, batch=other)
    torch.testing.assert_close(with_batch.policy_logits,
                               plain.policy_logits, rtol=0, atol=0)
    want = j_bb.apply_decode(jp, jnp.asarray(tok), j_pre.cache,
                             jnp.int32(t), j_cfg, A)
    _close(want.policy_logits, plain.policy_logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_abstract_is_meta_and_matches_jax_shapes(arch):
    """Every new kind's decode cache: ``cross`` holds ``cross_kv`` of
    (B, encoder_seq_len, K, Dh), ``enc_dec`` a KV cache and ``cross_kv``."""
    j_cfg, t_cfg = _cfgs(arch, "bfloat16")
    w = P.flatten(j_bb.cache_abstract(3, 9, j_cfg))
    g = P.flatten(bb.cache_abstract(3, 9, t_cfg))
    assert sorted(w) == sorted(g)
    assert any("cross_kv" in k for k in g)
    for key in w:
        assert g[key].device.type == "meta"
        assert tuple(g[key].shape) == w[key].shape
        assert g[key].dtype == torch.bfloat16


def test_block_kinds_without_a_decode_cache_raise():
    with pytest.raises(ValueError, match="enc"):
        bb._block_cache_abstract("enc", 2, 8, get_smoke_config(AUDIO),
                                 torch.bfloat16)
