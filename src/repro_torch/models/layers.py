"""Shared building blocks: norms, RoPE, MLPs, embeddings, linear layers.

Counterpart of ``repro/models/layers.py``.  Parameters are plain nested
dicts of tensors in the reference's layout (a linear ``w`` is
``[d_in, *d_out]``), so parameters carry across from the JAX package as
they are.  Norms compute in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def truncated_normal_init(generator: torch.Generator, shape, scale: float,
                          device=None, dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], then scaled by
    ``scale / sqrt(shape[0])`` (the reference's order).  Sampled on the
    generator's device, returned on ``device``."""
    stddev = scale / max(1.0, math.sqrt(shape[0] if shape else 1))
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * stddev).to(device=device, dtype=dtype)


def init_linear(generator, d_in: int, d_out, bias: bool = False,
                device=None, dtype=torch.float32):
    """``d_out`` may be an int or a tuple (fused multi-output heads)."""
    out_shape = (d_out,) if isinstance(d_out, int) else tuple(d_out)
    p = {"w": truncated_normal_init(generator, (d_in, *out_shape), 1.0,
                                    device, dtype)}
    if bias:
        p["b"] = torch.zeros(out_shape, dtype=dtype, device=device)
    return p


def by_column(fn, x: torch.Tensor, split: bool) -> torch.Tensor:
    """``fn(x)`` for x [B, S, ...]; with ``split``, one call per position
    ``x[:, s:s+1]``, each as an S=1 forward makes it.

    A speculative verify must give every draft query the bits the Sq=1
    decode at its position would give it.  On the card the kernels that
    cuBLAS and torch's reductions pick depend on the row count, and rows of
    a [B*S, d] product differ in the last bits from the same rows of a
    [B, d] product; calls of the decode's shape give identical rows."""
    if not split or x.shape[1] == 1:
        return fn(x)
    return torch.cat([fn(x[:, s:s + 1].contiguous())
                      for s in range(x.shape[1])], 1)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd will record an op on ``tensors``: the training
    paths (manual backwards, recomputation) switch on this, so a forward of
    parameters that do not require gradients (serving) runs as it is."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    y = (x.reshape(-1, x.shape[-1]) @ w.reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + w.shape[1:])
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


def init_embedding(generator, vocab: int, d: int, device=None,
                   dtype=torch.float32):
    return {"table": truncated_normal_init(generator, (vocab, d),
                                           math.sqrt(vocab), device, dtype)}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup.  ``F.embedding`` rather than an index: its backward on
    the card sums each row's gradients in a fixed order (an index's
    backward is an accumulating scatter whose order varies run to run)."""
    return F.embedding(ids, p["table"])


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: logits = x @ table^T (f32)."""
    return x.float() @ p["table"].float().T


def init_rmsnorm(d: int, device=None, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def init_layernorm(d: int, device=None, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def norm(p, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(p, x) if "bias" in p else rms_norm(p, x)


def init_norm(d: int, kind: str = "rms", device=None, dtype=torch.float32):
    return (init_layernorm(d, device, dtype) if kind == "ln"
            else init_rmsnorm(d, device, dtype))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on split halves.  x [..., S, H, Dh] (Dh even),
    positions [..., S]."""
    dh = x.shape[-1]
    exps = -torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions[..., None].float() * freqs              # [..., S, Dh/2]
    angles = angles[..., None, :]                              # [..., S, 1, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(generator, d: int, d_ff: int, kind: str = "swiglu",
             bias: bool = False, device=None, dtype=torch.float32):
    if kind in ("swiglu", "geglu"):
        return {
            "wi_gate": init_linear(generator, d, d_ff, bias, device, dtype),
            "wi_up": init_linear(generator, d, d_ff, bias, device, dtype),
            "wo": init_linear(generator, d_ff, d, bias, device, dtype),
        }
    return {"wi": init_linear(generator, d, d_ff, bias, device, dtype),
            "wo": init_linear(generator, d_ff, d, bias, device, dtype)}


def gelu(x):
    # The reference's gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def mlp(p, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        h = act(linear(p["wi_gate"], x)) * linear(p["wi_up"], x)
        return linear(p["wo"], h)
    return linear(p["wo"], gelu(linear(p["wi"], x)))
