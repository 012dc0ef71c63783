"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Counterpart of ``repro/models/rglru.py``.  Block = gate branch
(linear -> GeLU) * recurrent branch (linear -> conv1d -> RG-LRU), then the
output linear.  The recurrence

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)   (block-diagonal heads)
    a_t = exp(-c * softplus(L) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

is a diagonal linear recurrence: a log-depth scan over the sequence for
the cache-free forward (the reference's ``associative_scan``, within f32
rounding) and one step per token for decode.  A call of S > 1 tokens on a
cache raises ``ValueError`` (ROADMAP C8).

Under training's rules the "model" split of ``rg``/``ig`` (``(None,
"ffn", None)``: each head's input dim, a contraction) and of the other
leaves is storage only, as for the SSM block: ``transformer.
gather_weights`` reads every leaf whole and the block runs whole on every
rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.ssm import causal_conv, one_token_cache
from repro_torch.sharding.api import leave_model, training_rules

_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    width: int                    # recurrent width (lru_width)
    n_heads: int
    d_conv: int = 4


def init_rglru(generator, cfg: RGLRUConfig, device=None,
               dtype=torch.float32):
    W, H = cfg.width, cfg.n_heads
    hd = W // H
    a = -torch.log(torch.linspace(0.9, 0.999, W, dtype=torch.float32))
    return {
        "in_x": L.init_linear(generator, cfg.d_model, W, False, device,
                              dtype),
        "in_gate": L.init_linear(generator, cfg.d_model, W, False, device,
                                 dtype),
        "conv_w": L.truncated_normal_init(generator, (cfg.d_conv, W), 1.0,
                                          device, dtype),
        "conv_b": torch.zeros((W,), dtype=dtype, device=device),
        "rg": {"w": L.truncated_normal_init(generator, (H, hd, hd), 1.0,
                                            device, dtype)},
        "ig": {"w": L.truncated_normal_init(generator, (H, hd, hd), 1.0,
                                            device, dtype)},
        # L such that a^(1/c) ~ U[0.9, 0.999]
        "a_param": torch.log(torch.expm1(a)).to(device=device, dtype=dtype),
        "out": L.init_linear(generator, W, cfg.d_model, False, device, dtype),
    }


def _headwise(w, x, n_heads: int):
    """Block-diagonal product, x [..., W] -> [..., W], w [H, hd, hd]."""
    shape = x.shape
    xh = x.reshape(shape[:-1] + (n_heads, shape[-1] // n_heads))
    y = torch.einsum("...hi,hij->...hj", xh.float(), w.float())
    return y.reshape(shape)


def _gates(p, xr, cfg: RGLRUConfig):
    r = torch.sigmoid(_headwise(p["rg"]["w"], xr, cfg.n_heads))
    i = torch.sigmoid(_headwise(p["ig"]["w"], xr, cfg.n_heads))
    log_a = -_C * F.softplus(p["a_param"].float()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * xr.float())
    return a, gated_in


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, by log-depth
    doubling (the reference's ``associative_scan`` combine)."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], 1)
        d *= 2
    return b


def rglru_forward(p, x, cfg: RGLRUConfig,
                  cache: dict[str, Any] | None = None):
    """x [B, S, D] -> (out, new_cache)."""
    S = x.shape[1]
    one_token_cache(cache, S, "rglru")
    gate = L.gelu(L.linear(p["in_gate"], x).float())
    xr = L.linear(p["in_x"], x)

    if cache is None:
        xr = causal_conv(xr, p["conv_w"], p["conv_b"])
        a, gin = _gates(p, xr, cfg)
        h = linear_scan(a, gin)
        new_cache = None
    else:
        conv_state = torch.cat(
            [cache["conv"][:, S:], xr.to(cache["conv"].dtype)], 1)
        window = conv_state[:, -cfg.d_conv:]
        xr = (torch.einsum("bkc,kc->bc", window, p["conv_w"])
              + p["conv_b"])[:, None]
        a, gin = _gates(p, xr, cfg)
        h = a * cache["h"][:, None] + gin
        new_cache = {"conv": conv_state, "h": h[:, 0]}

    y = (h * gate).to(x.dtype)
    out = L.linear(p["out"], y)
    if cache is None:
        out = leave_model(out, training_rules(), partial=False)
    return out, new_cache


def init_rglru_cache(cfg: RGLRUConfig, batch: int, dtype=torch.float32,
                     device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv, cfg.width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, cfg.width), dtype=torch.float32,
                         device=device),
    }
