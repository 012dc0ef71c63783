"""Bit Margin Generator (paper Fig. 9(c)); counterpart of
``repro/core/margins.py``.

After planes 0..r of a key are processed, the unknown planes r+1.. add at
most ``W_r * sum_d max(q_d, 0)`` and at least ``W_r * sum_d min(q_d, 0)``
to the exact score, with ``W_r = 2^(bits-1-r) - 1``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import DEFAULT_BITS


def remaining_weight(bits: int = DEFAULT_BITS, device=None) -> torch.Tensor:
    """W_r for r = 0..bits-1 (after processing plane r), int32 [bits]."""
    r = torch.arange(bits, dtype=torch.int64, device=device)
    return (2 ** (bits - 1 - r) - 1).to(torch.int32)


def bit_margins(q_int: torch.Tensor, bits: int = DEFAULT_BITS):
    """``q_int`` int32 [..., d] -> (m_min, m_max), each f32 [bits, ...]."""
    pos = torch.clamp(q_int, min=0).sum(-1, dtype=torch.int32).float()
    neg = torch.clamp(q_int, max=0).sum(-1, dtype=torch.int32).float()
    w = remaining_weight(bits, q_int.device).float()
    w = w.reshape((bits,) + (1,) * pos.ndim)
    return w * neg[None], w * pos[None]
