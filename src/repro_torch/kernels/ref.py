"""Plain oracles for the port's attention kernels.

Counterpart of ``repro/kernels/ref.py``: definitional implementations with
no tiling and no early exit.  Each kernel's plain version computes the
function of the same name here (the flash kernel's is :func:`flash_attention`
itself; the BitStopper kernel's runs the block oracle on its prepared
operands).
"""

from __future__ import annotations

import torch

from repro_torch.core.besf import BitStopperConfig, besf_attention
from repro_torch.core.block_adaptation import block_bitstopper_attention
from repro_torch.core.lats import NEG_INF


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: float | None = None):
    """Dense softmax attention over [..., S, d] in f32, cast back to
    ``q.dtype``; causal rows see keys up to their position + Sk - Sq."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    logits = torch.einsum("...qd,...kd->...qk", q, k).float() * sm_scale
    if causal:
        Sq, Sk = q.shape[-2], k.shape[-2]
        mask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool,
                                     device=q.device), diagonal=Sk - Sq)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return (p @ v.float()).to(q.dtype)


def bitstopper_attention(q, k, v, cfg: BitStopperConfig = BitStopperConfig(),
                         block_q: int = 128, block_k: int = 128,
                         causal: bool = False):
    """Block-granular streaming BitStopper: the oracle of the
    ``bitstopper_qk`` kernel (prefix-max LATS, block liveness)."""
    return block_bitstopper_attention(q, k, v, cfg=cfg, block_q=block_q,
                                      block_k=block_k, causal=causal)


def bitstopper_reference(q, k, v, cfg: BitStopperConfig = BitStopperConfig(),
                         causal: bool = False):
    """Paper-faithful per-token BESF (global-max LATS): the ground truth
    whose survivors the block variant's must contain."""
    return besf_attention(q, k, v, cfg=cfg, causal=causal)


def decode_attention(q, k, v, causal: bool = False):
    """Single-query decode attention (the reference ignores ``causal``)."""
    return flash_attention(q, k, v, causal=False)
