"""ModelConfig: the declarative model description.

Mirror of ``repro/models/config.py`` (which imports jnp and the JAX core,
so the port keeps its own copy).  A model is a stack of segments; each
segment repeats a pattern unit of blocks.  Every mixer of the
registry is built (``attn``, ``local_attn``, ``mla``, ``ssm``, ``rglru``)
with a dense, MoE or no FFN; each derived config lives beside its module.
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

    def mla_config(self):
        from repro_torch.models.mla import MLAConfig
        return MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            q_rank=self.q_rank, kv_rank=self.kv_rank,
            qk_nope_dim=self.qk_nope_dim, qk_rope_dim=self.qk_rope_dim,
            v_head_dim=self.v_head_dim, rope_theta=self.rope_theta,
            impl=self.attn_impl, bitstopper=self.bitstopper,
        )

    def moe_config(self):
        from repro_torch.models.moe import MoEConfig
        return MoEConfig(
            d_model=self.d_model, n_routed=self.n_routed, top_k=self.top_k,
            d_expert=self.d_expert, n_shared=self.n_shared,
            d_shared=self.d_shared, act=self.act,
            capacity_factor=self.moe_capacity_factor,
            resident=self.moe_resident,
        )

    def ssm_config(self):
        from repro_torch.models.ssm import SSMConfig
        return SSMConfig(
            d_model=self.d_model, d_state=self.ssm_state,
            d_conv=self.ssm_conv, expand=self.ssm_expand,
            head_dim=self.ssm_head_dim,
        )

    def rglru_config(self):
        from repro_torch.models.rglru import RGLRUConfig
        return RGLRUConfig(
            d_model=self.d_model, width=self.lru_width or self.d_model,
            n_heads=self.n_heads,
        )


def uniform_segments(n_layers: int, mixer: str = "attn",
                     ffn: str = "dense") -> tuple:
    return (((BlockSpec(mixer, ffn),), n_layers),)
