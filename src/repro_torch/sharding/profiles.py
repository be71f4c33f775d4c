"""Named sharding-rule profiles (``repro.sharding.profiles``), per (arch,
shape) overridable: the reference's eleven, entry for entry.

Two families live here, deliberately separated:

IMPALA profiles (used by this repo's training paths)
    'baseline' — the only profile the IMPALA conv-LSTM net trains
    with. It resolves to ``DEFAULT_RULES``: the batch axis maps to
    ``("pod", "data")`` and every param dim falls through the
    divisibility rule. The SPMD learner (``--learner-mode spmd``)
    builds its 1-D ``('data',)`` mesh and uses exactly these rules —
    batch sharded on the leading trajectory axis when the row count
    divides the mesh (``Rules.spec``'s fallback replicates otherwise),
    params replicated because a ~129k-param conv-LSTM has nothing
    worth sharding. ``launch/dryrun.py`` resolves the same profile on
    the big production meshes.

Legacy LLM dryrun profiles (kept compiling, not used by IMPALA)
    Everything below 'baseline' targets the transformer/MoE/SSM dryrun
    shapes from the production-mesh exercise (``launch/dryrun.py``'s
    assigned-architecture sweep); none of their logical axes (heads,
    kv_seq, experts, vocab, ...) appear in the IMPALA param tree, so
    selecting them for IMPALA is a no-op beyond the batch rule. They
    are retained because the sharding tests pin their specs
    (``tests/test_torch_sharding.py`` holds every profile's to the
    reference's) and the dryrun tooling still selects them by name; each
    one's comment records the hypothesis it was hillclimbing.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, InputShape


def get_profile(name: str, arch: ArchConfig,
                shape: InputShape) -> Optional[Dict]:
    # ---- IMPALA profile ------------------------------------------------
    if name == "baseline":
        return None  # DEFAULT_RULES — the profile IMPALA trains with

    # ---- legacy LLM dryrun profiles (see module docstring) -------------
    if name == "seq_data":
        # shard sequence (not batch) over data — context parallelism for
        # small-batch long-context shapes (long_500k B=1)
        return {"batch": None, "seq": ("pod", "data"),
                "kv_seq": ("pod", "data")}
    if name == "kv_data":
        # decode: shard the KV cache sequence dim over the data axis
        # (flash-decode style distributed attention)
        return {"kv_seq": "data"}
    if name == "expert_data":
        # MoE: put experts on (data, model) jointly — more expert shards,
        # less tensor parallelism
        return {"experts": ("data", "model"), "ff": None}
    if name == "fsdp":
        # ZeRO-ish: shard params over data too (embed dim over data)
        return {"embed": "data"}
    if name == "tp2d":
        # §Perf: for the (data, model_a=4, model_b=4) mesh — heads shard
        # 4-way on model_a (20 % 4 == 0), ffn/vocab/experts use the full
        # 16-way (model_a, model_b) product.
        return {"batch": ("pod", "data"),
                "heads": "model_a", "kv_heads": "model_a",
                "head_dim": None,
                "ff": ("model_a", "model_b"),
                "vocab": ("model_a", "model_b"),
                "experts": ("model_a", "model_b"),
                "lru": ("model_a", "model_b"),
                "ssm_heads": ("model_a", "model_b")}
    if name == "fsdp_moe":
        # §Perf: FSDP x expert-parallel hybrid for MoE. fsdp_pure leaves
        # experts unsharded on the expert dim, so every device gathers the
        # full expert bank (olmoe: ~27 GB/step). Keep experts on the model
        # axis (shard_map EP) and shard the remaining param dims over
        # data (ZeRO); batch stays (pod, data).
        return {"batch": ("pod", "data"),
                "experts": "model",
                "embed": "data",
                "heads": None, "kv_heads": None, "head_dim": None,
                "ff": None, "vocab": None}
    if name == "fsdp_cp":
        # §Perf: multi-pod FSDP. batch 256 does not divide 512 devices, so
        # fsdp_pure's divisibility fallback silently REPLICATES the whole
        # batch across the mesh (measured: 295 s collective). Instead:
        # batch 256-way over (data, model), sequence 2-way over pod
        # (context parallelism), params sharded on embed.
        return {"batch": ("data", "model"),
                "seq": "pod", "kv_seq": "pod",
                "embed": ("data", "model"),
                "heads": None, "kv_heads": None, "head_dim": None,
                "ff": None, "vocab": None, "experts": None,
                "lru": None, "ssm_heads": None}
    if name == "kv_head_dim":
        # §Perf: GQA archs with kv_heads < model axis (mistral/granite/vlm
        # kv=8 on 16-way TP) replicate k/v projections and the KV cache.
        # head_dim stays mapped AFTER heads/kv_heads in each tensor, so
        # adding head_dim->model only bites where the head count failed
        # divisibility: q stays head-sharded, k/v shard head_dim.
        return {"head_dim": "model"}
    if name == "head_dim_tp":
        # §Perf: archs whose head COUNT is not divisible by the model axis
        # (qwen 20H, whisper 12H, recurrentgemma 10H) replicate all
        # attention under baseline rules. head_dim (128/256) IS divisible:
        # shard it instead; score einsums contract over head_dim -> psum.
        return {"heads": None, "kv_heads": None, "head_dim": "model"}
    if name == "fsdp_pure":
        # §Perf: swap tensor parallelism for fully-sharded data parallel.
        # batch over all axes (256/512-way); every weight sharded on its
        # embed dim; GSPMD all-gathers weights per layer (bf16) instead of
        # all-reducing activations per layer. Hypothesis: for train_4k on
        # >=10B dense, collective bytes drop ~3x and params/opt/grads
        # shard 256-way.
        return {"batch": ("pod", "data", "model"),
                "embed": ("data", "model"),
                "heads": None, "kv_heads": None, "head_dim": None,
                "ff": None, "vocab": None, "experts": None,
                "lru": None, "ssm_heads": None}
    raise KeyError(name)
