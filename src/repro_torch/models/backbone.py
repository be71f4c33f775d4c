"""Backbone assembly (``repro.models.backbone``): specs, heads, and the
apply paths of the ported families.

* ``impala_cnn``, the paper's conv(+LSTM) agent: ``apply_train`` folds
  the conv torso over time (B*T images), runs the LSTM over time with the
  actor-provided initial state, and the heads give
  ``AgentOutput(policy_logits, values, aux_loss)``.
* token backbones: ``dense`` decoders (mistral-nemo-12b, gemma-7b,
  qwen1.5-4b, stablelm-1.6b), ``moe`` decoders (granite-moe-1b-a400m,
  olmoe-1b-7b), ``ssm`` stacks (mamba2-1.3b), the ``hybrid`` RG-LRU stack
  (recurrentgemma-2b), the ``vlm`` llama-3.2-vision-11b (a cross-attention
  layer every ``cross_attn_every``) and the ``audio`` enc-dec
  whisper-small: embedding -> layer stack -> final norm -> heads, served
  by ``apply_prefill`` (the whole context, returns the logits at the last
  step and the decode cache: KV caches, ring buffers of the local window,
  RG-LRU or SSM and conv states, the cross-attention layers' projected
  encoder keys and values) and ``apply_decode`` (one step against the
  cache). The vlm and audio backbones read the stub frontends'
  embeddings from the batch: ``batch["image_embed"]`` (B, 1600, d), or
  ``batch["enc_embed"]`` (B, 1500, d), which the bidirectional encoder
  runs over first. ``apply_train`` runs them over a whole (B, T)
  trajectory for the learner, with a gradient (the mixers' train modes).
  ``aux_loss`` is the MoE routers' load-balancing loss summed over the
  layers, and 0 for every other family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import convnets, lstm as lstm_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (dense, dense_specs, embed,
                                       embedding_specs, make_norm,
                                       torch_dtype)
from repro_torch.params import tree_map


@dataclasses.dataclass
class AgentOutput:
    policy_logits: torch.Tensor  # (B, T, A) float32
    values: torch.Tensor         # (B, T)   float32
    aux_loss: torch.Tensor       # scalar float32
    cache: Optional[Any] = None  # final LSTM state, or the KV caches


def head_specs(cfg: ArchConfig, num_actions: int) -> Dict:
    d = cfg.d_model if cfg.family != "impala_cnn" else 256
    specs = {
        "policy": dense_specs((d,), (num_actions,), bias=True, scale=0.01),
        "value": dense_specs((d,), (1,), bias=True, scale=0.01),
    }
    if cfg.family != "impala_cnn":
        specs["final_norm"] = make_norm(cfg.norm, cfg.d_model)[0]
    return specs


def backbone_specs(cfg: ArchConfig, num_actions: int) -> Dict:
    if cfg.family != "impala_cnn":
        specs = {"embed": embedding_specs(cfg.vocab_size, cfg.d_model),
                 "stack": tfm.group_specs(cfg)}
        if cfg.encoder_layers:
            specs["encoder"] = tfm.encoder_specs(cfg)
        return {**specs, **head_specs(cfg, num_actions)}
    torso = (convnets.shallow_specs(cfg.image_hw)
             if cfg.impala_net == "shallow"
             else convnets.deep_specs(cfg.image_hw))
    return {
        "torso": torso,
        "lstm": lstm_lib.lstm_specs(256 + num_actions + 1, cfg.lstm_width),
        "post_lstm": dense_specs((cfg.lstm_width,), (256,), bias=True),
        **head_specs(cfg, num_actions),
    }


def _apply_heads(params, x, cfg: ArchConfig):
    """Final norm (token backbones), then float32 logits and values; a
    bf16 x meets the float32 head kernels as JAX promotes it, in f32."""
    if "final_norm" in params:
        _, norm = make_norm(cfg.norm, cfg.d_model)
        x = norm(params["final_norm"], x)
    logits = dense(params["policy"], x).to(torch.float32)
    values = dense(params["value"], x).to(torch.float32)[..., 0]
    return logits, values


def apply_train(params, batch: Dict, cfg: ArchConfig, num_actions: int,
                impl: str = "auto") -> AgentOutput:
    """The conv-LSTM agents: batch image (B,T,H,W,C) uint8, last_action
    (B,T) int, last_reward (B,T) f32, done (B,T) bool, lstm_state
    ((B,W),(B,W)) or None; the output's cache is the final LSTM state.

    The token backbones: batch["tokens"] (B, T) int, and for vlm and audio
    the stub frontend's embeddings (``_cross_ctx``); logits and values at
    every step, the aux loss, no cache. ``impl`` picks the route of the
    kernels on that path (K3's, ``ops``)."""
    if cfg.family != "impala_cnn":
        return _apply_train_tokens(params, batch, cfg, impl)
    img = batch["image"]
    b, t = img.shape[:2]
    flat = img.reshape((b * t,) + tuple(img.shape[2:]))
    feats = (convnets.shallow_apply(params["torso"], flat)
             if cfg.impala_net == "shallow"
             else convnets.deep_apply(params["torso"], flat))
    feats = feats.reshape(b, t, -1)
    last_a = F.one_hot(batch["last_action"].long(),
                       num_actions).to(feats.dtype)
    last_r = batch["last_reward"][..., None].to(feats.dtype)
    core_in = torch.cat([feats, last_a, last_r], dim=-1)
    lstm_state = batch.get("lstm_state")
    if lstm_state is None:
        lstm_state = lstm_lib.lstm_zero_state(b, cfg.lstm_width,
                                              feats.device)
    ys, state = lstm_lib.lstm_apply(params["lstm"], core_in, lstm_state,
                                    done=batch.get("done"))
    feats = F.relu(dense(params["post_lstm"], ys))
    logits, values = _apply_heads(params, feats, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=feats.device)
    return AgentOutput(logits, values, aux, cache=state)


# ---------------------------------------------------------------------------
# Cross-modal context (stub frontends)


def _cross_ctx(params, batch: Dict, cfg: ArchConfig, impl: str,
               mode: str = "prefill"):
    """What the cross-attention layers attend to: the encoder's output
    over ``batch["enc_embed"]`` (audio; the encoder run in ``mode``) or
    ``batch["image_embed"]`` itself (vlm), in ``cfg.dtype``; None for the
    other families."""
    dtype = torch_dtype(cfg.dtype)
    if cfg.family == "audio":
        return tfm.apply_encoder(params["encoder"],
                                 batch["enc_embed"].to(dtype), cfg, impl,
                                 mode)
    if cfg.family == "vlm":
        return batch["image_embed"].to(dtype)
    return None


def _lacks_cross_kv(cache, cfg: ArchConfig) -> bool:
    """Whether a cross-attention layer's decode cache lacks ``cross_kv``."""
    group, leftover = tfm.layer_plan(cfg)
    blocks = [cache["scan"][f"l{i}"] for i, k in enumerate(group)
              if k in tfm.CROSS_KINDS]
    blocks += [cache[f"tail{i}"] for i, k in enumerate(leftover)
               if k in tfm.CROSS_KINDS]
    return any("cross_kv" not in c for c in blocks)


# ---------------------------------------------------------------------------
# Token backbones


def _apply_train_tokens(params, batch: Dict, cfg: ArchConfig,
                        impl: str) -> AgentOutput:
    """JAX's token ``apply_train``: embed, the stack in train mode over
    positions 0..T-1 (the encoder too), the heads at every step."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    cross = _cross_ctx(params, batch, cfg, impl, mode="train")
    x, _, aux = tfm.apply_stack(params["stack"], x, positions, cfg,
                                mode="train", cross_ctx=cross, impl=impl)
    logits, values = _apply_heads(params, x, cfg)
    return AgentOutput(logits, values, aux)


def apply_prefill(params, batch: Dict, cfg: ArchConfig, num_actions: int,
                  impl: str = "auto") -> AgentOutput:
    """batch["tokens"]: (B, T) int, and for vlm and audio the stub
    frontend's embeddings (``_cross_ctx``). Returns the logits and values
    at the last step, (B, 1, A) and (B, 1), the aux loss, and the decode
    caches of every layer. ``impl`` picks the kernels' route (``ops``)."""
    del num_actions                     # the heads' shapes carry it
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    cross = _cross_ctx(params, batch, cfg, impl)
    x, caches, aux = tfm.apply_stack(params["stack"], x, positions, cfg,
                                     mode="prefill", cross_ctx=cross,
                                     impl=impl)
    logits, values = _apply_heads(params, x[:, -1:], cfg)
    return AgentOutput(logits, values, aux, cache=caches)


def apply_decode(params, token: torch.Tensor, cache, cache_index: int,
                 cfg: ArchConfig, num_actions: int,
                 batch: Optional[Dict] = None,
                 impl: str = "auto") -> AgentOutput:
    """token: (B, 1) int; cache_index: the absolute position (host int).
    Writes the step's keys and values (or RG-LRU, SSM and conv states)
    into ``cache`` in place and returns it as the output's cache.

    The cross-attention layers attend to the projected encoder keys and
    values that prefill left in the cache (``cross_kv``), which win
    whenever the cache holds them. ``batch`` (the stub frontend's
    embeddings) is read only where a cross layer's cache lacks them; then
    its context is computed afresh, as in JAX (whose jit drops the
    unused encoder run otherwise)."""
    del num_actions
    b = token.shape[0]
    x = embed(params["embed"], token, torch_dtype(cfg.dtype))
    positions = torch.full((b, 1), int(cache_index), dtype=torch.long,
                           device=token.device)
    cross = None
    if batch is not None and cfg.family in ("audio", "vlm") and \
            _lacks_cross_kv(cache, cfg):
        cross = _cross_ctx(params, batch, cfg, impl)
    x, caches, aux = tfm.apply_stack(params["stack"], x, positions, cfg,
                                     mode="decode", caches=cache,
                                     cache_index=int(cache_index),
                                     cross_ctx=cross, impl=impl)
    logits, values = _apply_heads(params, x, cfg)
    return AgentOutput(logits, values, aux, cache=caches)


def _block_cache_abstract(kind: str, batch: int, length: int,
                          cfg: ArchConfig, dtype) -> Dict:
    dh = cfg.resolved_head_dim
    if kind == "ssm":
        return {"ssm": ssm_lib.ssm_state_abstract(batch, cfg, dtype)}
    if kind == "recurrent":
        return {"rglru": rglru_lib.rglru_state_abstract(batch, cfg, dtype)}
    cross_spec = attn_lib.CacheSpec(cfg.encoder_seq_len, cfg.num_kv_heads, dh)
    if kind == "cross":
        return {"cross_kv": attn_lib.init_cache_arrays(batch, cross_spec,
                                                       dtype, "meta")}
    if kind not in ("attn", "moe", "local", "enc_dec"):
        raise ValueError(f"block kind {kind!r} has no decode cache")
    if kind == "local":
        window = (cfg.rglru.attention_window if cfg.rglru is not None
                  else cfg.sliding_window)
        length = min(window, length)
    spec = attn_lib.CacheSpec(length, cfg.num_kv_heads, dh)
    out = {"kv": attn_lib.init_cache_arrays(batch, spec, dtype, "meta")}
    if kind == "enc_dec":
        out["cross_kv"] = attn_lib.init_cache_arrays(batch, cross_spec,
                                                     dtype, "meta")
    return out


def cache_abstract(batch: int, length: int, cfg: ArchConfig) -> Dict:
    """The decode cache of the whole stack as ``meta`` tensors (shapes and
    dtypes, no storage), the counterpart of JAX's ShapeDtypeStructs."""
    dtype = torch_dtype(cfg.dtype)
    group, leftover = tfm.layer_plan(cfg)
    n = tfm.num_groups(cfg)
    one = {f"l{i}": _block_cache_abstract(k, batch, length, cfg, dtype)
           for i, k in enumerate(group)}
    out = {"scan": tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)),
                            one)}
    for i, k in enumerate(leftover):
        out[f"tail{i}"] = _block_cache_abstract(k, batch, length, cfg, dtype)
    return out


def cache_init(batch: int, length: int, cfg: ArchConfig,
               device="cpu") -> Dict:
    """A zeroed decode cache with ``length`` slots per layer."""
    return tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                          device=device),
                    cache_abstract(batch, length, cfg))
