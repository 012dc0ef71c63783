"""Prior-art dynamic-sparsity baselines the paper compares against.

Counterpart of ``repro/core/baselines.py``.  These re-implement the
mechanisms (not the full systems) of:

* **Dense**: INT12 attention without sparsity (the paper's "Baseline").
* **Sanger-style** [MICRO'21]: a 4-bit predictor computes an approximate
  QK^T; pairs whose approximate post-softmax probability exceeds a static
  threshold survive; the executor recomputes survivors at 12 bits.
* **SOFA-style** [MICRO'24]: a low-bit log-domain predictor, then per-query
  top-k; the executor recomputes at 12 bits.
* **TokenPicker-style** [DAC'24]: predictor-free progressive 4-bit chunks
  with partial-sum reuse and a post-exp probability stopping rule.

Every function returns ``(out, info)``; ``info`` carries the reference's
keys, the masks and fetch counters that ``core/stats.py`` turns into
traffic.  The reference's functions are jitted, and XLA folds each
division by a constant into a product with its f32 reciprocal; the port
computes those products (``qlib.quantize_folded``, ``qlib.reciprocal``),
so scales and logits are the reference's bit for bit.

The decisions (masks, counters) are computed so that they do not
depend on the device: integer dots run in float64 (exact for these small
integers; CUDA has no integer matmul), and the few transcendental values a
decision compares (the predictor's softmax, ``log2``, the stopping rule's
``exp``) are taken in float64 and rounded once to f32, the value an exact
f32 operation gives.  The reference computes them in f32, so the two
agree except where a value lies within an ulp or two of its threshold.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantization as qlib
from repro_torch.core.lats import NEG_INF


def _maybe_causal_mask(Sq, Sk, causal, mask, device):
    if causal:
        cmask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool,
                                      device=device), diagonal=Sk - Sq)
        mask = cmask if mask is None else (mask & cmask)
    return mask


def _masked_softmax(logits, mask, dtype=torch.float32):
    """Softmax over the last axis with masked entries at 0, computed in
    ``dtype`` and returned in f32."""
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits.to(dtype), dim=-1).float()
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    return p


def _inv_sqrt(d: int, device):
    """``/ d ** 0.5`` as the jitted reference computes it."""
    return qlib.reciprocal(d ** 0.5).to(device)


def _int_scores(a, b):
    """``einsum("...qd,...kd->...qk")`` of integer-valued tensors in
    float64: exact, whatever the device and the sum order."""
    return torch.einsum("...qd,...kd->...qk", a.double(), b.double())


def dense_attention(q, k, v, bits: int = 12, causal: bool = False,
                    mask=None):
    """INT12-quantized dense attention (the paper's accuracy baseline)."""
    d = q.shape[-1]
    mask = _maybe_causal_mask(q.shape[-2], k.shape[-2], causal, mask,
                              q.device)
    q_int, qp = qlib.quantize_folded(q, bits)
    k_int, kp = qlib.quantize_folded(k, bits)
    v_int, vp = qlib.quantize_folded(v, bits)
    scores = _int_scores(q_int, k_int).float()
    logits = scores * (qp.scale * kp.scale * _inv_sqrt(d, q.device))
    p = _masked_softmax(logits, mask)
    out = p @ qlib.dequantize(v_int, vp)
    return out, {"probs": p, "logits": logits, "mask": mask}


def sanger_attention(q, k, v, threshold: float = 2e-3, pred_bits: int = 4,
                     exec_bits: int = 12, causal: bool = False, mask=None):
    """Sanger-style: a 4-bit predictor and a static post-softmax
    threshold."""
    d = q.shape[-1]
    mask = _maybe_causal_mask(q.shape[-2], k.shape[-2], causal, mask,
                              q.device)
    # Prediction stage (low precision, full K fetch).
    q4, qp4 = qlib.quantize_folded(q, pred_bits)
    k4, kp4 = qlib.quantize_folded(k, pred_bits)
    approx = _int_scores(q4, k4).float()
    approx_logits = approx * (qp4.scale * kp4.scale * _inv_sqrt(d, q.device))
    approx_p = _masked_softmax(approx_logits, mask, torch.float64)
    kept = approx_p > torch.tensor(threshold, dtype=torch.float32)
    if mask is not None:
        kept = kept & mask
    # Formal stage (high precision on the survivors).
    out, info = dense_attention(q, k, v, exec_bits, causal=False, mask=kept)
    return out, dict(info, kept=kept, valid=mask)


def _log_quant(x, bits):
    """Power-of-two magnitudes (cheap shifts in hardware)."""
    mag = x.abs()
    amax = torch.clamp(mag.amax(), min=1e-12)
    ratio = mag / amax + 1e-20
    e = torch.clamp(torch.round(torch.log2(ratio.double())),
                    -(2 ** bits - 1), 0).float()
    return torch.sign(x) * amax * torch.pow(2.0, e)


def sofa_attention(q, k, v, k_ratio: float = 0.25, pred_bits: int = 4,
                   exec_bits: int = 12, causal: bool = False, mask=None):
    """SOFA-style: a log-domain low-bit predictor and per-query top-k."""
    d = q.shape[-1]
    Sq, Sk = q.shape[-2], k.shape[-2]
    mask = _maybe_causal_mask(Sq, Sk, causal, mask, q.device)
    approx = torch.einsum("...qd,...kd->...qk",
                          _log_quant(q, pred_bits).double(),
                          _log_quant(k, pred_bits).double()).float()
    approx = approx * _inv_sqrt(d, q.device)
    if mask is not None:
        approx = torch.where(mask, approx, torch.full_like(approx, NEG_INF))
    topk = max(int(k_ratio * Sk), 1)
    thresh = torch.sort(approx, dim=-1).values[..., Sk - topk]
    kept = approx >= thresh[..., None]
    if mask is not None:
        kept = kept & mask
    out, info = dense_attention(q, k, v, exec_bits, causal=False, mask=kept)
    return out, dict(info, kept=kept, valid=mask)


def tokenpicker_attention(q, k, v, prob_threshold: float = 1e-3,
                          chunk_bits: int = 4, bits: int = 12,
                          causal: bool = False, mask=None):
    """TokenPicker-style: progressive 4-bit chunks, a post-exp probability
    rule.

    A 12-bit key is consumed as three 4-bit chunks (MSB chunk first).  After
    chunk c the score interval is [partial + m_min_c, partial + m_max_c]; a
    token is dropped when the upper bound of its softmax probability
    (relative to the running max lower bound) falls below
    ``prob_threshold``.  Chunk partial sums are reused (no re-fetch)."""
    d = q.shape[-1]
    Sq, Sk = q.shape[-2], k.shape[-2]
    dev = q.device
    mask = _maybe_causal_mask(Sq, Sk, causal, mask, dev)
    n_chunks = bits // chunk_bits

    q_int, qp = qlib.quantize_folded(q, bits)
    k_int, kp = qlib.quantize_folded(k, bits)
    scale_total = qp.scale * kp.scale * _inv_sqrt(d, dev)

    planes = qlib.to_bitplanes(k_int, bits)          # [bits, ..., Sk, d]
    w = qlib.plane_weights_int(bits, dev)

    def chunk_score(c):
        acc = torch.zeros(q_int.shape[:-1] + (Sk,), dtype=torch.int32,
                          device=dev)
        for r_off in range(chunk_bits):
            r = c * chunk_bits + r_off
            acc = acc + w[r] * _int_scores(q_int, planes[r]).to(torch.int32)
        return acc

    pos = q_int.clamp(min=0).sum(-1).float()
    neg = q_int.clamp(max=0).sum(-1).float()
    shape = q_int.shape[:-2] + (Sq, Sk)
    valid = (torch.ones(shape, dtype=torch.bool, device=dev) if mask is None
             else torch.broadcast_to(mask, shape))

    partial = torch.zeros(shape, dtype=torch.int32, device=dev)
    alive = valid
    fetched = torch.zeros_like(partial)
    threshold = torch.tensor(prob_threshold, dtype=torch.float32)
    for c in range(n_chunks):
        fetched = fetched + alive.to(torch.int32)
        partial = partial + torch.where(alive, chunk_score(c),
                                        torch.zeros_like(partial))
        rem = float(2 ** (bits - (c + 1) * chunk_bits) - 1)
        lower = partial.float() + rem * neg[..., None]
        upper = partial.float() + rem * pos[..., None]
        m_low = torch.where(alive, lower,
                            torch.full_like(lower, NEG_INF)).amax(-1)
        # Post-exp probability upper bound against the running max.
        prob_ub = torch.exp(((upper - m_low[..., None])
                             * scale_total).double()).float()
        alive = alive & (prob_ub > threshold)

    logits = torch.where(alive, partial.float() * scale_total,
                         torch.full(shape, NEG_INF, device=dev))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(alive, p, torch.zeros_like(p))
    v_int, vp = qlib.quantize_folded(v, bits)
    out = p @ qlib.dequantize(v_int, vp)
    return out, {"probs": p, "kept": alive, "chunks_fetched": fetched,
                 "valid": valid}
