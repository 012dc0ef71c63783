"""The port's fused BitStopper attention held against the JAX package on
the CPU: the wrapper's prepared operands equal the reference's exactly, the
plain version equals the reference's Pallas kernel (interpret mode) on
rounds and survivors exactly and on the output within 2e-5, and the port's
per-token BESF equals the reference's on its integer statistics.  The
gpu-marked test holds the CUDA kernel against the plain version on the
card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import margins as jmargins
from repro.core import quantization as jqlib
from repro.core.besf import BitStopperConfig as JConfig
from repro.core.besf import besf_attention as jbesf
from repro.kernels.bitstopper_qk import bitstopper_attention_kernel as jkernel
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.core.besf import besf_attention as tbesf
from repro_torch.kernels import bitstopper_qk as BQ
from repro_torch.kernels import ref as tref

# Integers exact; the output's softmax differs by exp and summation order.
TOL = 2e-5


def _inputs(seed, Sq, Sk, d, dv, lead=(), scale=2.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=lead + (Sq, d)) * scale).astype(np.float32),
            (rng.normal(size=lead + (Sk, d)) * scale).astype(np.float32),
            rng.normal(size=lead + (Sk, dv)).astype(np.float32))


def _hot_inputs(seed=11, d=64):
    """``test_bitstopper_kernel_skips_planes``: every query shares a
    dominant direction and only the first kv block holds keys along it, so
    later blocks terminate early."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    q = 8.0 * u[None] + 0.05 * rng.normal(size=(64, d))
    k = np.concatenate([8.0 * u[None] + 0.05 * rng.normal(size=(32, d)),
                        0.05 * rng.normal(size=(224, d))])
    v = rng.normal(size=(256, d))
    return tuple(x.astype(np.float32) for x in (q, k, v))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _reference_prep(q, k, v, cfg):
    """The reference wrapper's operand preparation
    (``bitstopper_qk.py:319-338``), per slice, vmapped as it is there."""
    def one(q2, k2, v2):
        bits = cfg.bits
        q_int, qp = jqlib.quantize(q2, bits)
        k_int, kp = jqlib.quantize(k2, bits)
        k_packed = jqlib.pack_planes_seq(jqlib.to_bitplanes(k_int, bits))
        m_min, m_max = jmargins.bit_margins(q_int, bits)
        scale_total = qp.scale * kp.scale * (1.0 / (q2.shape[-1] ** 0.5))
        radius_int = cfg.radius / scale_total
        scalars = jnp.stack([scale_total, cfg.alpha * radius_int]).astype(
            jnp.float32)
        v_int, vp = jqlib.quantize(v2, bits)
        return (q_int, k_packed, jqlib.dequantize(v_int, vp), m_min, m_max,
                scalars)
    return jax.vmap(one)(q, k, v)


@pytest.mark.parametrize("alpha", [0.2, 0.6])
def test_prep_operands_equal_reference(alpha):
    """q_int, packed K planes, V, both margins and both LATS scalars equal
    the reference's bit for bit, per (batch, head) slice."""
    q, k, v = _inputs(0, 64, 128, 64, 32, (3,))
    want = _reference_prep(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           JConfig(alpha=alpha))
    got = BQ.prep(*map(torch.as_tensor, (q, k, v)), TConfig(alpha=alpha))
    names = ("q_int", "k_packed", "v_eff", "m_min", "m_max", "scalars")
    for name, w in zip(names, want):
        g = getattr(got, name).numpy()
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _assert_matches(got, want):
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    np.testing.assert_array_equal(got.survivors.numpy(),
                                  np.asarray(want.survivors))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Sq,Sk,d,dv,bq,bk", [
    (64, 64, 32, 32, 32, 32),
    (64, 128, 64, 64, 32, 64),
    (128, 128, 64, 64, 64, 64),
    (32, 256, 64, 32, 32, 64),
])
@pytest.mark.parametrize("alpha", [0.2, 0.6])
def test_kernel_matches_reference(Sq, Sk, d, dv, bq, bk, alpha):
    """The shapes and alphas of ``test_bitstopper_kernel_matches_oracle``:
    rounds and survivors exact, out within 2e-5, and the survivors equal
    the port's block oracle."""
    q, k, v = _inputs(42 + Sq + Sk, Sq, Sk, d, dv)
    want = jkernel(*map(jnp.asarray, (q, k, v)), cfg=JConfig(alpha=alpha),
                   block_q=bq, block_k=bk)
    got = BQ.bitstopper_attention_kernel(*map(torch.as_tensor, (q, k, v)),
                                         cfg=TConfig(alpha=alpha),
                                         block_q=bq, block_k=bk)
    _assert_matches(got, want)
    oracle = tref.bitstopper_attention(*map(torch.as_tensor, (q, k, v)),
                                       cfg=TConfig(alpha=alpha), block_q=bq,
                                       block_k=bk)
    assert torch.equal(got.survivors.bool(), oracle.stats.survivors)


@pytest.mark.parametrize("case", ["causal", "full", "batched", "hot"])
def test_kernel_cases_match_reference(case):
    """Causal and not (``test_bitstopper_kernel_causal``), leading [B, H]
    dims (``test_bitstopper_kernel_batched``), and the plane-skipping input
    (``test_bitstopper_kernel_skips_planes``), where whole blocks stop
    before the dense 12 planes."""
    kw = dict(block_q=64, block_k=64)
    cfg = dict(alpha=0.6)
    if case in ("causal", "full"):
        q, k, v = _inputs(7, 128, 128, 64, 64, scale=1.0)
        kw["causal"] = case == "causal"
    elif case == "batched":
        q, k, v = _inputs(3, 64, 64, 32, 32, (2, 3), scale=1.0)
        kw = dict(block_q=32, block_k=32)
        cfg = {}
    else:
        q, k, v = _hot_inputs()
        kw = dict(block_q=32, block_k=32)
        cfg = dict(alpha=0.4)
    want = jkernel(*map(jnp.asarray, (q, k, v)), cfg=JConfig(**cfg), **kw)
    got = BQ.bitstopper_attention_kernel(*map(torch.as_tensor, (q, k, v)),
                                         cfg=TConfig(**cfg), **kw)
    assert got.out.shape == want.out.shape
    assert got.survivors.dtype == torch.int8
    _assert_matches(got, want)
    if case == "hot":
        assert int(got.rounds.sum()) < got.rounds.numel() * 12
    if case == "causal":
        # the block above the diagonal is skipped: no plane, no survivor
        assert int(got.rounds[0, 1]) == 0


def test_untiled_lengths_raise():
    """The reference asserts its tiling; the port raises ``ValueError``."""
    q, k, v = _inputs(1, 200, 200, 32, 32)
    with pytest.raises(AssertionError):
        jkernel(*map(jnp.asarray, (q, k, v)))
    with pytest.raises(ValueError, match="tiled"):
        BQ.bitstopper_attention_kernel(*map(torch.as_tensor, (q, k, v)))
    q, k, v = _inputs(1, 20, 20, 32, 32)       # 20 <= 128 but not 8 | 20
    with pytest.raises(ValueError, match="multiple of 8"):
        BQ.bitstopper_attention_kernel(*map(torch.as_tensor, (q, k, v)))


@pytest.mark.parametrize("mask_kind", ["causal", "per_example"])
def test_besf_attention_matches_reference(mask_kind):
    """The per-token BESF: planes fetched, survivors and validity exact;
    probabilities and output within 2e-5.  The block oracle keeps a
    superset of its survivors (``test_block_keeps_superset``)."""
    q, k, v = _inputs(5, 64, 64, 32, 32, (2, 2), scale=1.0)
    cfg = dict(alpha=0.5, min_rounds=2)
    if mask_kind == "causal":
        kw = dict(causal=True)
        tkw = kw
    else:
        m = np.random.default_rng(6).random((2, 1, 64, 64)) < 0.7
        kw = dict(mask=jnp.asarray(m))
        tkw = dict(mask=torch.as_tensor(m))
    want = jbesf(*map(jnp.asarray, (q, k, v)), cfg=JConfig(**cfg), **kw)
    got = tbesf(*map(torch.as_tensor, (q, k, v)), cfg=TConfig(**cfg), **tkw)
    for name in ("planes_fetched", "survivors", "valid"):
        np.testing.assert_array_equal(getattr(got.stats, name).numpy(),
                                      np.asarray(getattr(want.stats, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.scores.numpy() <= -1e29,
                                  np.asarray(want.scores) <= -1e29)
    for name in ("out", "probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=TOL, rtol=TOL, err_msg=name)
    if mask_kind == "causal":
        ref = tref.bitstopper_reference(*map(torch.as_tensor, (q, k, v)),
                                        cfg=TConfig(**cfg), causal=True)
        block = tref.bitstopper_attention(*map(torch.as_tensor, (q, k, v)),
                                          cfg=TConfig(**cfg), block_q=32,
                                          block_k=32, causal=True)
        assert torch.equal(ref.stats.survivors, got.stats.survivors)
        assert bool((block.stats.survivors | ~ref.stats.survivors).all())


@pytest.mark.gpu
def test_bitstopper_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the same operands,
    causal and not, at the forward's tile (128) and at small tiles, and at
    head width 160 (stablelm-12b: planes and V in two chunks): rounds and
    survivors exact, out within 2e-5, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [((2, 4), 256, 256, 64, 64, 128, 0.6), ((3,), 64, 128, 64, 64,
             64, 0.2), ((2,), 32, 256, 64, 32, 32, 0.6),
             ((2, 2), 64, 64, 16, 16, 128, 0.8),
             ((2,), 256, 256, 160, 160, 128, 0.6)]
    for i, (lead, Sq, Sk, d, dv, blk, alpha) in enumerate(cases):
        q, k, v = (torch.as_tensor(x, device="cuda")
                   for x in _inputs(30 + i, Sq, Sk, d, dv, lead))
        cfg = TConfig(alpha=alpha)
        for causal in (False, True):
            flat = lambda x: x.reshape((-1,) + x.shape[-2:])
            ops = BQ.prep(flat(q), flat(k), flat(v), cfg)
            bq, bk = BQ._blocks(Sq, Sk, blk, blk)
            before = BQ.LAUNCHES
            got = BQ.bitstopper_attention_kernel(q, k, v, cfg, blk, blk,
                                                 causal)
            assert BQ.LAUNCHES == before + 1
            want = BQ.bitstopper_qk_plain(ops, cfg, bq, bk, causal)
            torch.cuda.synchronize()
            assert torch.equal(got.rounds.reshape(want.rounds.shape),
                               want.rounds)
            assert torch.equal(got.survivors.reshape(want.survivors.shape),
                               want.survivors)
            torch.testing.assert_close(got.out.reshape(want.out.shape),
                                       want.out, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d,dv", [(256, 256), (64, 48), (192, 64)])
def test_kernel_refuses_widths_it_does_not_take(d, dv):
    """Value widths outside KERNEL_DV, and heads wider than 160 (whose
    128-row tiles exceed the card's shared memory, as recurrentgemma-2b's
    256 does), raise before any launch."""
    q, k, v = map(torch.as_tensor, _inputs(41, 128, 128, d, dv, (1,)))
    cfg = TConfig(alpha=0.6)
    ops = BQ.prep(q, k, v, cfg)
    before = BQ.LAUNCHES
    with pytest.raises(ValueError, match="value widths"):
        BQ.launch_kernel(ops, cfg, 128, 128, True)
    assert BQ.LAUNCHES == before
