"""Complexity accounting of the paper's comparison (Figs. 10-12).

Counterpart of ``repro/core/stats.py``: the same arithmetic in numpy, over
the port's tensors (any device) or numpy arrays, giving the reference's
floats.  Two accounting modes, both reported for every method:

* ``per_pair``: every (query, key) interaction fetches its own K data (no
  cross-query reuse), the paper's PE-lane view where each lane walks one
  query row.
* ``shared``: a K bit plane or vector is fetched once if any query needs
  it (perfect on-chip reuse within the attention pass).

Units: bytes for memory traffic, bit-MACs for compute (one b1 x b2
multiply-accumulate counts b1*b2 bit-MACs, so an INT12 x INT12 MAC is 144
and an INT12 x 1-bit MAC is 12).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _np(x, dtype=None):
    """A tensor (any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)

@dataclasses.dataclass(frozen=True)
class Complexity:
    k_bytes: float          # key traffic
    v_bytes: float          # value traffic
    compute_bitmacs: float  # QK^T + SV work in bit-MACs

    @property
    def total_bytes(self) -> float:
        return self.k_bytes + self.v_bytes

    def normalized_to(self, other: "Complexity") -> dict:
        return {
            "mem": self.total_bytes / max(other.total_bytes, 1e-9),
            "compute": self.compute_bitmacs / max(other.compute_bitmacs, 1e-9),
        }


def dense_complexity(Sq: int, Sk: int, d: int, dv: int,
                     bits: int = 12) -> Complexity:
    """Dense INT12 attention: full K and V fetched, full QK^T and SV."""
    k_bytes = Sk * d * bits / 8
    v_bytes = Sk * dv * bits / 8
    qk = Sq * Sk * d * bits * bits
    sv = Sq * Sk * dv * bits * bits
    return Complexity(k_bytes, v_bytes, qk + sv)


def besf_complexity(
    planes_fetched: np.ndarray,   # [.., Sq, Sk] int
    survivors: np.ndarray,        # [.., Sq, Sk] bool
    d: int,
    dv: int,
    bits: int = 12,
    mode: str = "per_pair",
) -> Complexity:
    """Traffic/compute of the faithful BESF run from its stats."""
    pf = _np(planes_fetched, np.float64)
    sv_mask = _np(survivors)
    if mode == "per_pair":
        plane_fetches = pf.sum()                       # (pair, plane) count
        v_rows = sv_mask.sum()
    elif mode == "shared":
        # Plane (j, r) fetched iff any query reached round r for key j.
        max_r = pf.max(axis=-2)                        # [.., Sk]
        plane_fetches = max_r.sum()
        v_rows = sv_mask.any(axis=-2).sum()
    else:
        raise ValueError(mode)
    k_bytes = plane_fetches * d / 8                    # 1 bit x d per plane
    v_bytes = v_rows * dv * bits / 8
    qk = pf.sum() * d * bits * 1                       # INT12 x 1-bit MACs
    sv = sv_mask.sum() * dv * bits * bits
    return Complexity(float(k_bytes), float(v_bytes), float(qk + sv))


def block_besf_complexity(
    rounds_per_block: np.ndarray,  # [.., n_qt, n_kb]
    block_alive: np.ndarray,       # [.., n_qt, n_kb] bool
    survivors: np.ndarray,         # [.., Sq, Sk] bool
    block_q: int,
    block_k: int,
    d: int,
    dv: int,
    bits: int = 12,
) -> Complexity:
    """Traffic of the TPU block-granular variant (DMA = block x plane)."""
    r = _np(rounds_per_block, np.float64)
    k_bytes = r.sum() * block_k * d / 8
    v_bytes = _np(block_alive).sum() * block_k * dv * bits / 8
    qk = r.sum() * block_q * block_k * d * bits
    sv = _np(survivors).sum() * dv * bits * bits
    return Complexity(float(k_bytes), float(v_bytes), float(qk + sv))


def predictor_complexity(
    Sq: int,
    Sk: int,
    d: int,
    dv: int,
    kept: np.ndarray,             # [.., Sq, Sk] bool: pairs the predictor kept
    pred_bits: int,
    exec_bits: int = 12,
    mode: str = "per_pair",
    batch: int = 1,
) -> Complexity:
    """Two-stage DS accelerators (Sanger/SOFA-style): predictor fetches the
    *full* K at pred_bits, executor re-fetches surviving K at exec_bits."""
    kept = _np(kept)
    k_pred = batch * Sk * d * pred_bits / 8
    if mode == "per_pair":
        exec_rows = kept.sum()
    else:
        exec_rows = kept.any(axis=-2).sum()
    k_exec = exec_rows * d * exec_bits / 8
    v_bytes = exec_rows if mode == "per_pair" else kept.any(axis=-2).sum()
    v_bytes = v_bytes * dv * exec_bits / 8
    qk = (batch * Sq * Sk * d * pred_bits * pred_bits
          + kept.sum() * d * exec_bits ** 2)
    sv = kept.sum() * dv * exec_bits ** 2
    return Complexity(float(k_pred + k_exec), float(v_bytes), float(qk + sv))


def chunk_progressive_complexity(
    chunks_fetched: np.ndarray,   # [.., Sq, Sk] int — 4-bit chunks consumed
    survivors: np.ndarray,
    d: int,
    dv: int,
    chunk_bits: int = 4,
    exec_bits: int = 12,
    mode: str = "per_pair",
) -> Complexity:
    """TokenPicker-style progressive chunking (reuses partials, no
    re-fetch)."""
    cf = _np(chunks_fetched, np.float64)
    sv_mask = _np(survivors)
    if mode == "per_pair":
        fetches = cf.sum()
        v_rows = sv_mask.sum()
    else:
        fetches = cf.max(axis=-2).sum()
        v_rows = sv_mask.any(axis=-2).sum()
    k_bytes = fetches * d * chunk_bits / 8
    v_bytes = v_rows * dv * exec_bits / 8
    qk = cf.sum() * d * exec_bits * chunk_bits
    sv = sv_mask.sum() * dv * exec_bits ** 2
    return Complexity(float(k_bytes), float(v_bytes), float(qk + sv))
