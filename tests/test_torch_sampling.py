"""The port's seeded sampler held against jax 0.9.0 on the CPU: key words
after ``PRNGKey`` and ``fold_in`` chains, random bits and uniforms are
bit-equal; gumbel noise is within 1e-6 relative plus 1e-6 absolute (the two
frameworks' f32 ``log`` differ by an ulp); tokens equal the reference's
``_sample_tokens`` at every tested temperature.  Seeds, rids and counts
include 0, large int32 values and non-powers of two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import _sample_tokens
from repro_torch.serving import sampling as S

SEEDS = [0, 1, 7, 12345, 2**31 - 1]
DATA = [0, 3, 1000003, 2**31 - 1]
GUMBEL_RTOL = GUMBEL_ATOL = 1e-6


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 5])
def test_prng_key_and_fold_in_chain_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), S.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for d in DATA:
        a = jax.random.fold_in(jax.random.fold_in(jk, d), 2 * d + 1)
        b = S.fold_in(S.fold_in(tk, d), 2 * d + 1)
        np.testing.assert_array_equal(b.numpy(), _words(a))


def test_fold_in_vectorised_over_rows():
    """Keys [R, 2] from one base key and per-row data, as the sampler
    builds them."""
    rids = np.array([0, 5, 2**31 - 1, 77, 5], np.int32)
    counts = np.array([0, 1, 13, 2**31 - 1, 4096], np.int32)
    base = jax.random.PRNGKey(7)
    want = np.stack([_words(jax.random.fold_in(jax.random.fold_in(base, r),
                                               n))
                     for r, n in zip(rids, counts)])
    got = S.fold_in(S.fold_in(S.prng_key(7), rids), counts)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("V", [257, 100352])
def test_random_bits_and_uniform_bit_equal(V):
    for seed, d in ((0, 0), (7, 1000003), (2**31 - 1, 3)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        tk = S.fold_in(S.prng_key(seed), d)
        bits = np.asarray(jax.random.bits(jk, (V,), jnp.uint32))
        np.testing.assert_array_equal(S.random_bits(tk, V).numpy(),
                                      bits.astype(np.int64))
        for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
            want = np.asarray(jax.random.uniform(jk, (V,), minval=lo,
                                                 maxval=hi))
            got = S.uniform(tk, V, lo, hi).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("V", [257, 100352])
def test_gumbel_within_tolerance(V):
    for seed, d in ((0, 0), (7, 1000003), (2**31 - 1, 3)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        tk = S.fold_in(S.prng_key(seed), d)
        np.testing.assert_allclose(S.gumbel(tk, V).numpy(),
                                   np.asarray(jax.random.gumbel(jk, (V,))),
                                   rtol=GUMBEL_RTOL, atol=GUMBEL_ATOL)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0, 1.3])
@pytest.mark.parametrize("V", [257, 100352])
def test_sample_tokens_equal_reference(temperature, V):
    rng = np.random.default_rng(int(temperature * 10) + V)
    R = 24 if V == 257 else 6
    logits = (rng.normal(size=(R, V)) * 2.0).astype(np.float32)
    rids = rng.integers(0, 2**31 - 1, R).astype(np.int32)
    rids[:2] = (0, 2**31 - 1)
    counts = rng.integers(0, 5000, R).astype(np.int32)
    counts[:2] = (0, 1023)
    for seed in (0, 7):
        want = np.asarray(_sample_tokens(
            jax.random.PRNGKey(seed), jnp.asarray(logits), jnp.asarray(rids),
            jnp.asarray(counts), temperature))
        got = S.sample_tokens(S.prng_key(seed), torch.as_tensor(logits),
                              rids, counts, temperature)
        assert got.dtype == torch.int64 and got.shape == (R,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sample_tokens_fused_rounding_of_the_reference(temperature):
    """Two candidates whose noisy scores tie to within the last bit: the
    reference forms ``gumbel + row / temperature`` as one fused
    multiply-add with the f32 reciprocal, and the separately rounded
    product and sum would pick the other token in every case built here."""
    V, i, j = 257, 3, 10
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 0), 0)
    g = np.asarray(jax.random.gumbel(key, (V,))).astype(np.float64)
    inv = np.float32(1) / np.float32(temperature)
    rng = np.random.default_rng(1)
    built = 0
    while built < 8:
        x = np.full(V, -100.0, np.float32)
        x[i] = np.float32(rng.normal())
        x[j] = np.float32((g[i] + np.float64(x[i]) * inv - g[j]) / inv
                          + rng.normal() * 1e-7)
        g32 = g.astype(np.float32)
        split = np.argmax(g32 + x * inv)
        fused = np.argmax((g + x.astype(np.float64) * inv).astype(np.float32))
        if split == fused:
            continue
        built += 1
        want = int(_sample_tokens(jax.random.PRNGKey(7), jnp.asarray(x[None]),
                                  jnp.zeros(1, jnp.int32),
                                  jnp.zeros(1, jnp.int32), temperature)[0])
        got = int(S.sample_tokens(S.prng_key(7), torch.as_tensor(x[None]),
                                  [0], [0], temperature)[0])
        assert got == want == fused


def test_ties_go_to_the_first_index():
    logits = torch.zeros(3, 50)
    np.testing.assert_array_equal(
        S.sample_tokens(S.prng_key(0), logits, [0, 1, 2], [0, 0, 0],
                        0.0).numpy(), [0, 0, 0])
    assert int(S.categorical(S.prng_key(0)[None],
                             torch.full((1, 4), -np.inf))[0]) == 0


def test_host_keys_in_numpy_equal_torch_keys():
    """The engine folds its keys on the host in numpy: the same words as
    the torch fold, and the same tokens."""
    rids, counts = [0, 9, 2**31 - 1], [4, 0, 77]
    a = S.fold_in(S.fold_in(S.prng_key(3).numpy(), rids), counts)
    b = S.fold_in(S.fold_in(S.prng_key(3), rids), counts)
    assert isinstance(a, np.ndarray)
    np.testing.assert_array_equal(a, b.numpy())
    logits = torch.randn(3, 300, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        S.sample_tokens(S.prng_key(3).numpy(), logits, rids, counts,
                        0.7).numpy(),
        S.sample_tokens(S.prng_key(3), logits, rids, counts, 0.7).numpy())
