"""INT12 post-training quantization and bit-plane decomposition.

Counterpart of ``repro/core/quantization.py``.  Keys are quantized to
``bits``-wide two's-complement integers (per-tensor, symmetric) and split
into bit planes, most significant (sign) plane first: plane 0 weighs
``-2^(bits-1)``, plane r >= 1 weighs ``2^(bits-1-r)``.

Every function here is exact integer work or a single IEEE operation per
element (``x / scale``, ``round`` half to even), so its results equal the
JAX package's bit for bit.  :func:`quantize` computes in its input's dtype,
as the reference's does: a bf16 tensor (a bf16 KV cache's view) gets a bf16
scale and bf16 quotients, each a correctly rounded bf16 operation.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_BITS = 12


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Symmetric per-tensor quantization parameters."""

    scale: torch.Tensor  # scalar f32: x_float ~= x_int * scale
    bits: int = DEFAULT_BITS

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))


def plane_weights(bits: int = DEFAULT_BITS, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Weight of each bit plane, MSB (sign) first: [-2^(b-1), 2^(b-2), ...,
    1]."""
    return plane_weights_int(bits, device).to(dtype)


def plane_weights_int(bits: int = DEFAULT_BITS,
                      device=None) -> torch.Tensor:
    """Signed integer weight of each plane, MSB first: [-2^(b-1), 2^(b-2),
    ..., 1] as int32."""
    w = 2 ** torch.arange(bits - 1, -1, -1, dtype=torch.int64, device=device)
    w[0] = -w[0]
    return w.to(torch.int32)


def quantize(x: torch.Tensor, bits: int = DEFAULT_BITS, dims=None):
    """Symmetric PTQ over the whole tensor, or per slice over ``dims``
    (the scale keeps those dims, size 1), in ``x``'s dtype: ``max(max|x|,
    1e-12) / qmax`` and ``clip(round(x / scale))``.  Returns (int32 values,
    f32 scale)."""
    qmax = 2 ** (bits - 1) - 1
    amax = x.abs().amax() if dims is None else x.abs().amax(dims, True)
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -(qmax + 1), qmax)
    return q.to(torch.int32), scale.float()


def reciprocal(c: float) -> torch.Tensor:
    """``1 / f32(c)`` in f32: inside ``jax.jit`` XLA turns a division by a
    constant into a product with this reciprocal, so the reference's jitted
    callers get ``x * reciprocal(c)`` where their source says ``x / c``."""
    return torch.tensor(1.0) / torch.tensor(c, dtype=torch.float32)


def quantize_folded(x: torch.Tensor, bits: int = DEFAULT_BITS):
    """The reference's ``quantize`` as its jitted callers (the baselines,
    ``quantize_and_pack``) compute it: the scale is ``max(max|x|, 1e-12) *
    reciprocal(qmax)``, which can differ from :func:`quantize`'s quotient
    in the last bit.  Returns (int32 values, :class:`QuantParams`)."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().amax(), min=1e-12) * reciprocal(qmax).to(
        x.device)
    q = torch.clamp(torch.round(x / scale), -(qmax + 1), qmax)
    return q.to(torch.int32), QuantParams(scale=scale.float(), bits=bits)


def dequantize(q: torch.Tensor, params: QuantParams) -> torch.Tensor:
    return q.float() * params.scale


def scale_from_amax(amax: torch.Tensor, bits: int = DEFAULT_BITS):
    """Symmetric quant scale for a max-abs value, with the 1e-12 floor."""
    qmax = 2 ** (bits - 1) - 1
    return torch.clamp(amax.float(), min=1e-12) / qmax


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor,
                        bits: int = DEFAULT_BITS) -> torch.Tensor:
    """Quantize under an externally maintained scale (broadcast against
    ``x``): ``clip(round(x / scale))``, rounding half to even."""
    qmax = 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(x / scale), -(qmax + 1), qmax).to(
        torch.int32)


def to_bitplanes(q: torch.Tensor, bits: int = DEFAULT_BITS) -> torch.Tensor:
    """int32 two's-complement values -> uint8 planes ``[bits, *q.shape]``,
    plane 0 = MSB (sign)."""
    u = torch.where(q < 0, q + (1 << bits), q).to(torch.int32)
    shifts = torch.arange(bits - 1, -1, -1, dtype=torch.int32,
                          device=q.device).reshape((bits,) + (1,) * q.ndim)
    return ((u[None] >> shifts) & 1).to(torch.uint8)


def from_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bitplanes` -> int32 values."""
    bits = planes.shape[0]
    w = plane_weights_int(bits, planes.device).to(torch.int64)
    w = w.reshape((bits,) + (1,) * (planes.ndim - 1))
    return (w * planes.to(torch.int64)).sum(0).to(torch.int32)


def partial_value(planes: torch.Tensor, r: int) -> torch.Tensor:
    """Value reconstructed from planes 0..r inclusive (later bits 0)."""
    bits = planes.shape[0]
    w = plane_weights_int(bits, planes.device).to(torch.int64)
    w = w * (torch.arange(bits, device=planes.device) <= r)
    w = w.reshape((bits,) + (1,) * (planes.ndim - 1))
    return (w * planes.to(torch.int64)).sum(0).to(torch.int32)


def pack_planes_seq(planes: torch.Tensor) -> torch.Tensor:
    """Pack ``uint8[..., S, d]`` planes -> ``uint8[..., S//8, d]``: token
    s owns bit ``s % 8`` of byte ``s // 8`` (LSB first)."""
    *lead, S, d = planes.shape
    if S % 8:
        raise ValueError(f"sequence length {S} not a multiple of 8")
    p = planes.reshape(*lead, S // 8, 8, d).to(torch.int32)
    w = (1 << torch.arange(8, dtype=torch.int32, device=planes.device))
    return (p * w.reshape(8, 1)).sum(-2).to(torch.uint8)


def unpack_planes_seq(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_planes_seq` -> ``uint8[..., S, d]``."""
    *lead, S8, d = packed.shape
    shifts = torch.arange(8, dtype=torch.int32,
                          device=packed.device).reshape(8, 1)
    u = (packed.to(torch.int32)[..., None, :] >> shifts) & 1
    return u.reshape(*lead, S8 * 8, d).to(torch.uint8)


def pack_pool_planes(pool: torch.Tensor, amax: torch.Tensor,
                     bits: int = DEFAULT_BITS) -> torch.Tensor:
    """Quantize and bit-plane-pack a whole paged K pool.

    ``pool`` f32 ``[P, page_size, H, D]`` (page_size % 8 == 0) and ``amax``
    ``[H]`` (the pool-wide running max-abs) -> ``uint8[P, bits,
    page_size//8, H, D]``, token t of a page owning bit ``t % 8`` of byte
    ``t // 8``.  The write path's requant-on-growth rebuilds the plane pool
    with exactly this function."""
    P, bs, H, D = pool.shape
    if bs % 8:
        raise ValueError(f"page size {bs} not a multiple of 8")
    scale = scale_from_amax(amax, bits)
    q = quantize_with_scale(pool.float(), scale[None, None, :, None], bits)
    planes = to_bitplanes(q, bits)                  # [bits, P, bs, H, D]
    pk = planes.reshape(bits, P, bs // 8, 8, H, D).to(torch.int32)
    w = (1 << torch.arange(8, dtype=torch.int32, device=pool.device))
    packed = (pk * w.reshape(1, 1, 1, 8, 1, 1)).sum(3)
    return packed.to(torch.uint8).permute(1, 0, 2, 3, 4).contiguous()


def quantize_and_pack(k: torch.Tensor, bits: int = DEFAULT_BITS):
    """Float K [S, d] -> (packed planes uint8[bits, S//8, d], scale), as
    the reference's jitted function computes them (:func:`quantize_folded`)."""
    q, params = quantize_folded(k, bits)
    return pack_planes_seq(to_bitplanes(q, bits)), params.scale
