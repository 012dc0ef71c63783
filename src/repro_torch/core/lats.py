"""Lightweight Adaptive Token Selection (paper Section III-B, Eq. 3);
counterpart of ``repro/core/lats.py``.

Per query and bit round the threshold is the max lower bound of the
candidates still in play minus ``alpha * radius``; a candidate survives iff
its upper bound reaches the threshold (``>=``, so the argmax always
survives, also at alpha = 0).
"""

from __future__ import annotations

import torch

# A finite "minus infinity": the online softmax tests ``m == NEG_INF`` to
# recognise a row that has seen no survivor yet.
NEG_INF = -1e30


def lats_threshold(lower: torch.Tensor, valid: torch.Tensor, alpha: float,
                   radius_in_domain) -> torch.Tensor:
    """eta per query row: max over valid lower bounds minus alpha*radius."""
    masked = torch.where(valid, lower, torch.full_like(lower, NEG_INF))
    return masked.amax(-1) - alpha * radius_in_domain


def lats_keep(upper: torch.Tensor, eta: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Survival mask for this round (a subset of ``valid``)."""
    return valid & (upper >= eta[..., None])
