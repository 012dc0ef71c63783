"""The port's algorithm core held against the JAX package on the CPU:
quantization, bit planes and their packing, LATS margins and helpers, the
paged-decode operand prep and block-granular BitStopper.  Inputs are made
with numpy from a seed and cross between the frameworks as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lats as jlats
from repro.core import margins as jmargins
from repro.core import quantization as jq
from repro.core.besf import BitStopperConfig as JConfig
from repro.core.besf import paged_decode_prep as jprep
from repro.core.block_adaptation import block_bitstopper_attention as jblock
from repro_torch.core import lats as tlats
from repro_torch.core import margins as tmargins
from repro_torch.core import quantization as tq
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.core.besf import paged_decode_prep as tprep
from repro_torch.core.block_adaptation import \
    block_bitstopper_attention as tblock
from _torch_threads import one_thread  # noqa: F401


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(x):
    return x.detach().cpu().numpy()


# Ties at .5 (round half to even) with a max of 2047, which fixes the
# scale at exactly 1.0.
_TIES = np.array([2047.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -2047.0,
                  1023.5, -1024.5], np.float32)


@pytest.mark.parametrize("case", ["ties", "normal", "zeros", "tiny"])
def test_quantize_matches_reference(case):
    rng = np.random.default_rng(0)
    x = {"ties": _TIES,
         "normal": rng.normal(size=(5, 7, 16)).astype(np.float32) * 3,
         "zeros": np.zeros((4, 8), np.float32),          # 1e-12 amax floor
         "tiny": np.full((3, 8), 1e-14, np.float32)}[case]
    jqv, jp = jq.quantize(jnp.asarray(x))
    tqv, ts = tq.quantize(_t(x))
    np.testing.assert_array_equal(_n(tqv), np.asarray(jqv))
    assert _n(ts) == np.asarray(jp.scale)
    if case == "ties":
        assert _n(tqv).tolist()[1:] == [0, 2, 2, 0, -2, -2, 4, -2047, 1024,
                                        -1024]
    # an external scale clips to [-2048, 2047]
    one = np.float32(1.0)
    clip = np.array([-3000.0, 3000.0, -2048.4], np.float32)
    np.testing.assert_array_equal(
        _n(tq.quantize_with_scale(_t(clip), _t(one))),
        np.asarray(jq.quantize_with_scale(jnp.asarray(clip), one)))
    amax = np.abs(x).max(axis=-1)
    np.testing.assert_array_equal(_n(tq.scale_from_amax(_t(amax))),
                                  np.asarray(jq.scale_from_amax(amax)))


def test_bitplanes_and_packing_match_reference():
    rng = np.random.default_rng(1)
    q = rng.integers(-2048, 2048, size=(32, 16)).astype(np.int32)
    q[0, :4] = [-2048, -1, 0, 2047]                       # sign plane edges
    jp = np.asarray(jq.to_bitplanes(jnp.asarray(q)))
    tp = _n(tq.to_bitplanes(_t(q)))
    np.testing.assert_array_equal(tp, jp)
    assert tp[:, 0, 0].tolist() == [1] + [0] * 11         # -2048: sign only
    np.testing.assert_array_equal(_n(tq.from_bitplanes(_t(tp))), q)
    jpk = np.asarray(jq.pack_planes_seq(jnp.asarray(jp)))
    tpk = _n(tq.pack_planes_seq(_t(tp)))
    np.testing.assert_array_equal(tpk, jpk)
    np.testing.assert_array_equal(_n(tq.unpack_planes_seq(_t(tpk))), jp)
    pool = (rng.normal(size=(5, 16, 2, 8)) * 2).astype(np.float32)
    amax = np.abs(pool).max(axis=(0, 1, 3)) * 1.25
    np.testing.assert_array_equal(
        _n(tq.pack_pool_planes(_t(pool), _t(amax))),
        np.asarray(jq.pack_pool_planes(jnp.asarray(pool),
                                       jnp.asarray(amax))))
    with pytest.raises(ValueError):
        tq.pack_pool_planes(_t(pool[:, :12]), _t(amax))


def test_margins_and_lats_helpers_match_reference():
    rng = np.random.default_rng(2)
    q = rng.integers(-2048, 2048, size=(3, 5, 64)).astype(np.int32)
    for a, b in zip(tmargins.bit_margins(_t(q)),
                    jmargins.bit_margins(jnp.asarray(q))):
        np.testing.assert_array_equal(_n(a), np.asarray(b))
    lower = rng.normal(size=(4, 9)).astype(np.float32) * 100
    upper = lower + np.abs(rng.normal(size=(4, 9))).astype(np.float32) * 50
    valid = rng.random((4, 9)) < 0.7
    eta_t = tlats.lats_threshold(_t(lower), _t(valid), 0.6, 20.0)
    eta_j = jlats.lats_threshold(jnp.asarray(lower), jnp.asarray(valid),
                                 0.6, 20.0)
    np.testing.assert_array_equal(_n(eta_t), np.asarray(eta_j))
    np.testing.assert_array_equal(
        _n(tlats.lats_keep(_t(upper), eta_t, _t(valid))),
        np.asarray(jlats.lats_keep(jnp.asarray(upper), eta_j,
                                   jnp.asarray(valid))))


@pytest.mark.parametrize("G,alpha", [(1, 0.6), (4, 0.8)])
def test_paged_decode_prep_matches_reference(G, alpha):
    """Every operand the kernel receives, bit for bit."""
    rng = np.random.default_rng(3)
    Hkv, d = 2, 16
    q = (rng.normal(size=(3, Hkv * G, d)) * 2).astype(np.float32)
    q[2] = 0.0                                            # amax floor row
    k_amax = np.abs(rng.normal(size=Hkv)).astype(np.float32) * 3
    v_amax = np.abs(rng.normal(size=Hkv)).astype(np.float32)
    got = tprep(_t(q), _t(k_amax), _t(v_amax), Hkv, TConfig(alpha=alpha))
    want = jprep(jnp.asarray(q), jnp.asarray(k_amax), jnp.asarray(v_amax),
                 Hkv, JConfig(alpha=alpha))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), np.asarray(w))


@pytest.mark.parametrize("alpha,min_rounds,quantize_v,causal,masked", [
    (0.6, 1, True, True, False),
    (0.2, 3, True, False, True),
    (0.8, 1, False, True, True),
])
def test_block_bitstopper_matches_reference(alpha, min_rounds, quantize_v,
                                            causal, masked):
    """Prefill score path: rounds per block, V-fetch decisions, survivors
    and scores exact; the output within 1e-5 (f32 exp and the order of the
    softmax and S x V sums differ between the frameworks)."""
    rng = np.random.default_rng(4)
    Sq, Sk, d = 32, 48, 16
    q = rng.normal(size=(2, 3, Sq, d)).astype(np.float32)
    k = rng.normal(size=(2, 3, Sk, d)).astype(np.float32)
    k[:, :, 5] += 4.0 * q[:, :, 0]                        # something to find
    v = rng.normal(size=(2, 3, Sk, d)).astype(np.float32)
    mask = None
    if masked:                                            # a window mask
        qp, kp = np.arange(Sq)[:, None] + Sk - Sq, np.arange(Sk)[None]
        mask = (kp <= qp) & (kp > qp - 20)
    jc = JConfig(alpha=alpha, min_rounds=min_rounds, quantize_v=quantize_v)
    tc = TConfig(alpha=alpha, min_rounds=min_rounds, quantize_v=quantize_v)
    want = jblock(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=jc,
                  block_q=16, block_k=16, causal=causal,
                  mask=None if mask is None else jnp.asarray(mask))
    got = tblock(_t(q), _t(k), _t(v), cfg=tc, block_q=16, block_k=16,
                 causal=causal, mask=None if mask is None else _t(mask))
    for g, w in zip(got.stats, want.stats):
        np.testing.assert_array_equal(_n(g), np.asarray(w))
    np.testing.assert_array_equal(_n(got.scores), np.asarray(want.scores))
    np.testing.assert_allclose(_n(got.out), np.asarray(want.out),
                               atol=1e-5, rtol=1e-5)
    assert _n(got.stats.rounds_per_block).min() < jc.bits  # LATS pruned


def test_jax_runs_on_cpu():
    assert jax.default_backend() == "cpu"
