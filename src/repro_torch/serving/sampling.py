"""Seeded, schedule-invariant token sampling.

Counterpart of ``repro/serving/engine.py:_sample_tokens``: row i draws its
token under the key ``fold_in(fold_in(base_key, rid_i), n_i)``, a pure
function of (seed, request, token index), so a sampled trace does not
depend on slot assignment, prefill chunking, preemption or speculative
acceptance.

The key stream is a copy, bit for bit, of the threefry2x32 PRNG of the
reference's framework (version 0.9.0, partitionable threefry on, 64-bit
types off); the port does not import that framework:

* ``prng_key(seed)`` is ``[0, seed mod 2**32]``;
* ``fold_in(key, d)`` hashes the count pair ``(0, d mod 2**32)`` under the
  key;
* ``random_bits(key, V)`` hashes the counts ``(0, j)``, ``j < V``, and
  xors the two output words;
* ``uniform`` puts the top 23 bits into the mantissa of a float in [1, 2)
  and subtracts 1;
* ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` (the "low" mode), and
  ``categorical`` the argmax of gumbel noise plus the logits.

Unsigned 32-bit words are carried in ``int64`` tensors and masked after
every add and rotate: torch's ``uint32`` lacks shifts and adds on CUDA in
some builds.  Keys, random bits and uniforms are bit-equal to the
reference's on any device; the two ``log`` calls may differ from XLA's by
an ulp, and the f64 sum that stands for the reference's fused
multiply-add in :func:`sample_tokens` rounds differently when it lands on
an f32 midpoint (about one element in 2**29).

Vectorised over rows (keys ``[R, 2]``, noise ``[R, V]``), with no host
sync: :func:`sample_tokens` derives the keys where the base key lives
(torch tensor or numpy array) and draws the noise on the logits' device.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _words(x, device) -> torch.Tensor:
    """Integers (a Python int, a sequence, an array or a tensor) as uint32
    words in an int64 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.int64))
    return x.to(device=device, dtype=torch.int64) & _MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x0, x1)``
    under the key ``(k1, k2)``; all uint32 words in broadcastable int64
    torch tensors or numpy arrays.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """The reference's ``PRNGKey(seed)``: the key words ``[0, seed mod
    2**32]`` (int64 tensor of shape [2])."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """The reference's ``fold_in``: keys ``[..., 2]`` with integer data
    broadcast against their leading shape; returns keys ``[..., 2]`` of
    the key's kind.  A key in a numpy array is folded on the host with
    numpy, whose operators cost a third of torch's on a few rows."""
    if isinstance(key, np.ndarray):
        d = np.asarray(data, np.int64) & _MASK
        o0, o1 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(d), d)
        return np.stack(np.broadcast_arrays(o0, o1), axis=-1)
    d = _words(data, key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element, ``[..., n]`` for keys ``[..., 2]``
    (the reference's partitionable ``random_bits`` for a 1-D shape)."""
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(j), j)
    return o0 ^ o1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval), ``[..., n]`` for keys
    ``[..., 2]``."""
    mant = (random_bits(key, n) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * scale + lo, lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise, f32 ``[..., n]`` for keys ``[..., 2]``."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``softmax(logits)`` by the Gumbel-max trick;
    ties go to the first maximal index, as in the reference."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def categorical_block(key, logits: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """The reference's ``categorical(key, logits / temperature, axis=-1)``
    for a whole ``[B, V]`` block under one key, as its static engine calls
    it outside any compiled function: the noise of the block (random bits
    counted over the flattened [B, V] index), a true f32 division by the
    temperature (a 0-dim tensor on the logits' device: a Python scalar
    becomes a reciprocal multiply on CUDA) and a separate add.  Returns
    int64 ``[B]``."""
    B, V = logits.shape
    keyt = torch.as_tensor(np.asarray(key)).to(logits.device)
    noise = gumbel(keyt, B * V).reshape(B, V)
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    return torch.argmax(noise + logits / t, dim=-1)


def sample_tokens(base_key, logits: torch.Tensor, rids, counts,
                  temperature: float) -> torch.Tensor:
    """Row i's token: argmax at temperature 0, else a draw from
    ``softmax(logits[i] / temperature)`` under
    ``fold_in(fold_in(base_key, rids[i]), counts[i])``.  Returns int64
    ``[R]`` on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    # The keys are derived where the base key lives (the engine keeps it in
    # a numpy array, beside the rids and counts) and cross in one copy.
    keys = torch.as_tensor(fold_in(fold_in(base_key, rids), counts))
    keys = keys.to(logits.device)
    noise = gumbel(keys, logits.shape[-1])
    # The reference's ``gumbel + row / temperature`` compiles to one fused
    # multiply-add with the f32 reciprocal of the temperature (XLA folds
    # the division by a constant into a product and contracts it with the
    # add).  The product of two f32 values is exact in f64, so the f64 sum
    # rounded to f32 is that fused result, on any device.
    inv = float(np.float32(1.0) / np.float32(temperature))
    scores = (noise.double() + logits.double() * inv).float()
    return torch.argmax(scores, dim=-1)
