"""Uncached attention dispatch: the one entry point models use.

Counterpart of ``repro/kernels/ops.py``.  ``attention(..., impl=...)``:

* ``"xla"``            dense softmax attention (``ref.flash_attention``);
* ``"flash"``          the dense flash kernel (``kernels/flash_attention``);
* ``"bitstopper"``     the fused BESF + LATS kernel
                       (``kernels/bitstopper_qk``);
* ``"bitstopper_xla"`` the block-granular oracle in plain torch, same
                       outputs as the kernel.

The kernel impls launch their CUDA kernel for CUDA tensors and run their
plain version for CPU tensors; blocks are clamped as in the reference.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core.besf import BitStopperConfig
from repro_torch.kernels import ref
from repro_torch.kernels.bitstopper_qk import bitstopper_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention

AttnImpl = Literal["xla", "flash", "bitstopper", "bitstopper_xla"]


def attention(
    q: torch.Tensor,                  # [..., Sq, d]
    k: torch.Tensor,                  # [..., Sk, d]
    v: torch.Tensor,                  # [..., Sk, dv]
    impl: AttnImpl = "xla",
    causal: bool = False,
    cfg: BitStopperConfig | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Attention output only (the stats-carrying variants live in core/)."""
    if impl == "xla":
        return ref.flash_attention(q, k, v, causal=causal)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)
    cfg = cfg or BitStopperConfig()
    if impl == "bitstopper":
        return bitstopper_attention_kernel(
            q, k, v, cfg=cfg, block_q=block_q, block_k=block_k,
            causal=causal).out
    if impl == "bitstopper_xla":
        return ref.bitstopper_attention(
            q, k, v, cfg=cfg, block_q=min(block_q, q.shape[-2]),
            block_k=min(block_k, k.shape[-2]), causal=causal).out
    raise ValueError(f"unknown attention impl: {impl}")
