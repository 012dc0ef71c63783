"""Architecture registry: exact assigned configs + reduced smoke variants.

Mirror of ``repro/configs/registry.py`` (pure data).

Every entry is the config from the assignment block (public literature),
buildable with ``get_config(name)`` and selectable via ``--arch`` in the
launch scripts.  ``reduced_config(name)`` shrinks the same *family
structure* (same block pattern, same mixer kinds, tiny dims) for CPU smoke
tests.  ``chip_smoke.py`` serves full-width ``stablelm-1.6b`` on the card.
"""

from __future__ import annotations

from repro_torch.models.config import BlockSpec, ModelConfig, uniform_segments


def _dense(name, n_layers, d_model, heads, kv, d_ff, vocab, head_dim=None,
           qkv_bias=False, act="swiglu", norm="rms", family="dense",
           frontend=None, window=None, tie=False):
    return ModelConfig(
        name=name, family=family, d_model=d_model, vocab=vocab,
        segments=uniform_segments(n_layers),
        n_heads=heads, n_kv_heads=kv, head_dim=head_dim or d_model // heads,
        d_ff=d_ff, qkv_bias=qkv_bias, act=act, norm=norm, frontend=frontend,
        window=window, tie_embeddings=tie,
    )


# --------------------------------------------------------------------------
# The 10 assigned architectures
# --------------------------------------------------------------------------


def musicgen_medium():
    """[audio] decoder-only over EnCodec tokens [arXiv:2306.05284]."""
    return _dense("musicgen-medium", 48, 1536, 24, 24, 6144, 2048,
                  act="gelu", norm="ln", family="audio", frontend="audio",
                  tie=True)


def stablelm_12b():
    return _dense("stablelm-12b", 40, 5120, 32, 8, 13824, 100352,
                  qkv_bias=True, norm="ln")


def stablelm_1_6b():
    return _dense("stablelm-1.6b", 24, 2048, 32, 32, 5632, 100352,
                  qkv_bias=True, norm="ln")


def qwen2_5_14b():
    return _dense("qwen2.5-14b", 48, 5120, 40, 8, 13824, 152064,
                  qkv_bias=True)


def granite_20b():
    """MQA (kv=1): the largest relative K-traffic win for BitStopper."""
    return _dense("granite-20b", 52, 6144, 48, 1, 24576, 49152)


def recurrentgemma_2b():
    """Hybrid: (rglru, rglru, local_attn) pattern, window 2048 [arXiv:2402.19427]."""
    unit = (BlockSpec("rglru"), BlockSpec("rglru"), BlockSpec("local_attn"))
    tail = (BlockSpec("rglru"), BlockSpec("rglru"))
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", d_model=2560, vocab=256000,
        segments=((unit, 8), (tail, 1)),          # 26 layers
        n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680,
        act="geglu", lru_width=2560, window=2048,
        tie_embeddings=True, sub_quadratic=True,
    )


def mamba2_130m():
    """Attention-free SSD; BitStopper inapplicable (DESIGN.md section 4)."""
    return ModelConfig(
        name="mamba2-130m", family="ssm", d_model=768, vocab=50280,
        segments=uniform_segments(24, "ssm", "none"),
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        tie_embeddings=True, sub_quadratic=True,
    )


def qwen2_moe_a2_7b():
    """4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", d_model=2048, vocab=151936,
        segments=uniform_segments(24, "attn", "moe"),
        n_heads=16, n_kv_heads=16, head_dim=128, qkv_bias=True,
        n_routed=60, top_k=4, d_expert=1408, n_shared=4, d_shared=5632,
    )


def deepseek_v3_671b():
    """MLA + 1 shared + 256 routed top-8 + MTP [arXiv:2412.19437].
    First 3 layers dense FFN, remaining 58 MoE."""
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", d_model=7168, vocab=129280,
        segments=(
            ((BlockSpec("mla", "dense"),), 3),
            ((BlockSpec("mla", "moe"),), 58),
        ),
        n_heads=128, d_ff=18432,
        q_rank=1536, kv_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        n_routed=256, top_k=8, d_expert=2048, n_shared=1, d_shared=2048,
        mtp=True,
        dtype="bfloat16", param_dtype="bfloat16", remat="dots",
    )


def llava_next_34b():
    """[vlm] backbone only; anyres patch embeddings stubbed."""
    return _dense("llava-next-34b", 60, 7168, 56, 8, 20480, 64000,
                  family="vlm", frontend="vision")


def paper_opt1_3b():
    """OPT-1.3B — the paper's own algorithm-eval model (RoPE instead of
    learned positions; noted in DESIGN.md)."""
    return _dense("paper-opt1.3b", 24, 2048, 32, 32, 8192, 50272,
                  qkv_bias=True, act="gelu", norm="ln", tie=True)


ARCHS = {
    "musicgen-medium": musicgen_medium,
    "stablelm-12b": stablelm_12b,
    "stablelm-1.6b": stablelm_1_6b,
    "qwen2.5-14b": qwen2_5_14b,
    "granite-20b": granite_20b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "mamba2-130m": mamba2_130m,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "llava-next-34b": llava_next_34b,
    "paper-opt1.3b": paper_opt1_3b,
}


def list_archs() -> list[str]:
    return list(ARCHS)


# Families the launch scripts know how to shape-check (dry-run input
# specs and frontend stubs key off these).
FAMILIES = frozenset({"dense", "moe", "ssm", "hybrid", "audio", "vlm"})


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = ARCHS[name]()
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{cfg.name}: unknown family {cfg.family!r} "
            f"(expected one of {sorted(FAMILIES)})")
    return cfg


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: same block pattern,
    few layers, narrow dims, small vocab/experts."""
    cfg = get_config(name)
    # Shrink segments: keep the pattern units, cut repeats to <= 2.
    segments = tuple((unit, min(reps, 2)) for unit, reps in cfg.segments)
    heads = min(cfg.n_heads, 4) or 4
    kv = max(1, min(cfg.n_kv_heads, heads))
    if cfg.n_kv_heads == cfg.n_heads:
        kv = heads
    kw = dict(
        segments=segments,
        d_model=64, vocab=256, d_ff=128 if cfg.d_ff else 0,
        n_heads=heads, n_kv_heads=kv, head_dim=16,
        window=8 if cfg.window else None,
        lru_width=64 if cfg.lru_width else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        dtype="float32", param_dtype="float32", remat="none",
    )
    if cfg.n_routed:
        # capacity_factor high enough that tiny test batches never drop —
        # dropping is a large-scale statistical effect, not a unit-test one.
        kw.update(n_routed=8, top_k=min(cfg.top_k, 2), d_expert=32,
                  n_shared=min(cfg.n_shared, 1),
                  d_shared=64 if cfg.n_shared else 0,
                  moe_capacity_factor=8.0)
    if cfg.kv_rank:
        kw.update(q_rank=32, kv_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16, head_dim=0)
    return cfg.replace(**kw)
