"""ModelConfig: the declarative model description.

Mirror of ``repro/models/config.py`` (which imports jnp and the JAX core,
so the port keeps its own copy).  A model is a stack of segments; each
segment repeats a pattern unit of blocks.  This slice builds the
``attn``/``local_attn`` mixers with a dense FFN; the other fields are kept
so the architecture entries stay pure data.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.besf import BitStopperConfig


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str                    # attn | local_attn | mla | ssm | rglru
    ffn: str = "dense"            # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab: int
    segments: tuple[tuple[tuple[BlockSpec, ...], int], ...]
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int | None = None
    act: str = "swiglu"
    norm: str = "rms"             # rms | ln
    tie_embeddings: bool = True
    # MLA (deepseek)
    q_rank: int = 0
    kv_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_routed: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    d_shared: int = 0
    moe_capacity_factor: float = 1.25
    moe_resident: bool = False
    attn_chunk: int = 512
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # RG-LRU
    lru_width: int = 0
    # extras
    mtp: bool = False
    frontend: str | None = None
    # runtime
    attn_impl: str = "xla"
    bitstopper: BitStopperConfig = BitStopperConfig()
    fused_decode: bool = False    # paged serving: the CUDA paged-decode kernel
    spec_verify: bool = False
    dtype: str = "float32"        # activation dtype
    param_dtype: str = "float32"
    remat: str = "none"
    scan_layers: bool = True      # reference layout: stacked segment params
    sub_quadratic: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_layers(self) -> int:
        return sum(len(unit) * reps for unit, reps in self.segments)

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def parameter_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)

    def attn_config(self, local: bool = False):
        from repro_torch.models.attention import AttnConfig
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            window=self.window if local else None,
            impl=self.attn_impl, bitstopper=self.bitstopper,
            chunk_q=self.attn_chunk, chunk_k=self.attn_chunk,
            fused_decode=self.fused_decode, spec_verify=self.spec_verify,
        )


def uniform_segments(n_layers: int, mixer: str = "attn",
                     ffn: str = "dense") -> tuple:
    return (((BlockSpec(mixer, ffn),), n_layers),)
